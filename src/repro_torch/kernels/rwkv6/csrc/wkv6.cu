// Chunked WKV6 (RWKV6 "Finch" time-mix core) for Hopper (sm_90a).
//
// Replaces the TPU kernel `wkv_bhtc` / `_wkv_kernel`
// (src/repro/kernels/rwkv6/kernel.py:60, body :22).  It computes what that
// kernel computes, not how: the TPU runs the chunks as the sequential third
// grid axis (B, H, n_chunks) with the [hd, hd] state in VMEM scratch.
// Beyond the TPU kernel it starts from an optional state s0 and writes the
// final state, which is what the model's `wkv_chunked` returns and the
// prefill stores.
//
// Per chunk of L tokens:
//   cum[t]  = sum_{s <= t} lw[s]            (per channel, decreasing)
//   A[t][j] = sum_a r[t,a] k[j,a] exp(cum[t-1,a] - cum[j,a])   for j < t
//   A[t][t] = sum_a r[t,a] u[a] k[t,a]                         (the bonus)
//   y[t]    = sum_{j <= t} A[t][j] v[j] + (r[t] * exp(cum[t-1])) . S
//   S'      = exp(cum[L-1]) * S + sum_j (k[j] * exp(cum[L-1] - cum[j])) v[j]^T
// Every exp argument is a difference of a decreasing cumulative log-decay,
// so it is <= 0, as in the reference: nothing overflows at any decay.
//
// Bound: per token and head the work is ~7 L hd (pairwise term with its
// exp, the y sums) + 4 hd^2 (state term and update) operations against
// 4 hd inputs and hd outputs, so at hd 64, L 32 with bf16 r/k/v it does ~40
// operations a byte: on an H100 (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
// float32, 3.35 TB/s) it is bytes-bound at the tensor-core rate and
// operation-bound on the CUDA cores.  So bf16 runs on the tensor cores.
//
// bf16 body (`wkv6_mma_kernel`, templated on hd in {16, 32, 64}):
// * The whole card.  y[t, c] and the state column S[:, c] depend on v only
//   through column c, so a block owns a (sequence b, head h, slice of
//   kCols = 16 value columns) and carries an [hd, 16] slice of the state;
//   the grid is (H hd / 16, B): rwkv6-1.6b's prefill, B 1 x H 32 x 4
//   slices, runs 128 blocks of 16 warps on the 132 SMs.  Every slice
//   builds the chunk's A [L, L] itself (a cluster of a head's slices that
//   shares the building through distributed shared memory measured slower:
//   its barrier costs more than the work it saves, and clusters of 4 do
//   not all fit in one wave).
// * A without a positive exponent and with exps once a (row, channel).  A
//   chunk is zero-filled to Lp rows (L rounded up to 16; lw = 0 there, so
//   the decay holds), cut into tiles of 16 rows, each of two blocks of 8:
//     - a tile T against an earlier tile J, and a tile's second block
//       against its first, go through one product each with the earlier
//       rows' last row e as the reference,
//         A[t, j] = sum_a (r[t,a] e^{cum[t-1,a] - cum[e,a]})
//                         (k[j,a] e^{cum[e,a] - cum[j,a]}),
//       both exponents <= 0 since j <= e <= t - 1; a 16 x 8 unit a warp;
//     - pairs within a block of 8 are summed in float32 on the CUDA cores,
//       a pair's decay the product of e^lw over j < s < t (e^lw is taken
//       once a (token, channel) in the scan), so no exp at all: a warp
//       takes rows w and 15 - w of a tile (7 pairs and two bonuses, nine
//       independent sums), a lane hd / 32 channels, then a reduce-scatter
//       over the lanes.
// * Tensor cores.  The units, A v, (r e^{cum[t-1]}) S and the update
//   (k e^{cum[L-1]-cum})^T v run as `mma.sync` m16n8k16 with float32
//   accumulators (the tiles are 16 rows and the operands are formed in
//   registers, which fits mma.sync; `wgmma` would want 64-row tiles from
//   shared memory).  r, k and v enter as the bf16 values they are; the
//   float32 operands made from them (the two exp-scaled factors, A,
//   r e^{cum[t-1]}, k e^{cum[L-1]-cum} and the carried state) each enter
//   as a hi + lo pair of bf16 (a product of two pairs drops lo x lo), which
//   keeps y within bf16's rounding of the float32 plain version and the
//   state within 1e-4; made a single bf16, each of the six misses one of
//   those limits (tests/test_torch_wkv_layout.py emulates this rounding).
// * Overlap.  Phase p of the chunk loop: the state warps (4-7) request
//   chunk p + 2 with 16-byte `cp.async` copies (rows past L zero-filled)
//   and scan chunk p + 1, whose copies landed during phase p - 1 (lw to
//   log2(e) cum in place and e^lw beside it: a lane's rows in registers,
//   a shuffle scan over the 2-8 lanes of a channel); 12 builder warps
//   build A for chunk p into one of two buffers; the y warps (0-1) compute
//   y for chunk p - 1 and the state warps its state update: warp s owns
//   rows 16 s.. of the slice in its MMA accumulators, in float32 across
//   the chunks, and writes them to shared memory as a hi + lo pair for the
//   next chunk's state term.  A 4-stage ring of chunks; one block barrier
//   a phase.
// Limits it still has: the building of A (pairs and units) is most of each
// phase's instructions and every slice repeats it; a phase is bound by
// latency and issue, not by bytes or the tensor cores; the chunks run in
// order; one block an SM (16 warps, 128 registers each).
//
// float32 body (`wkv6_kernel`): one block a (sequence, head) on the CUDA
// cores, every operand of a chunk in float32 shared memory, rows padded by
// one float; it serves the tests against the CPU and float32 models, which
// must agree with the plain version to ~1e-5 (TF32 tensor cores would not).
//
// Supported: r/k/v/y float32 or bfloat16, lw/u/s0/s_out float32, all
// contiguous; T a multiple of L (the wrapper pads).  float32: the shared
// memory (hd^2 + 4 L (hd + 1) + L^2 floats) within 227 KB.  bfloat16: hd
// 16, 32 or 64, L <= 32, r, k, v and lw 16-byte aligned.  The C entry point
// returns cudaErrorInvalidValue for any other shape (the Python wrapper
// raises ValueError for it), else cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

size_t smem_bytes(int hd, int L) {
  return sizeof(float) *
         ((size_t)hd * hd + 4 * (size_t)L * (hd + 1) + (size_t)L * L);
}

__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u,   // [H, hd]
            const float* __restrict__ s0,  // [B, H, hd, hd] or null
            float* __restrict__ y, float* __restrict__ s_out, int T_, int H,
            int hd, int L) {
  extern __shared__ float smem[];
  const int ld = hd + 1;        // padded row of a chunk operand
  float* S = smem;              // [hd, hd] state
  float* rs = S + hd * hd;      // [L, ld] r, then r * exp(cum[t-1])
  float* ks = rs + L * ld;      // [L, ld] k, then k * exp(cum[L-1] - cum)
  float* vs = ks + L * ld;      // [L, ld] v
  float* cs = vs + L * ld;      // [L, ld] lw, then its cumulative sum
  float* A = cs + L * ld;       // [L, L] pairwise term, bonus on the diagonal

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t row = (size_t)H * hd;  // elements between tokens
  const size_t base = (size_t)b * T_ * row + (size_t)h * hd;
  const size_t sbase = ((size_t)b * H + h) * hd * hd;
  const float* uh = u + (size_t)h * hd;

  for (int i = tid; i < hd * hd; i += kThreads)
    S[i] = s0 != nullptr ? s0[sbase + i] : 0.f;

  for (int c0 = 0; c0 < T_; c0 += L) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < L * hd; i += kThreads) {
      const int t = i / hd;
      const int a = i - t * hd;
      const size_t off = base + (size_t)(c0 + t) * row + a;
      rs[t * ld + a] = r[off];
      ks[t * ld + a] = k[off];
      vs[t * ld + a] = v[off];
      cs[t * ld + a] = lw[off];
    }
    __syncthreads();
    for (int a = tid; a < hd; a += kThreads) {  // cumulative log-decay
      float c = 0.f;
      for (int t = 0; t < L; ++t) {
        c += cs[t * ld + a];
        cs[t * ld + a] = c;
      }
    }
    __syncthreads();
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L;
      const int j = i - t * L;
      float s = 0.f;
      if (j < t) {
        const float* rt = rs + t * ld;
        const float* kj = ks + j * ld;
        const float* cp = cs + (t - 1) * ld;
        const float* cj = cs + j * ld;
        for (int a = 0; a < hd; ++a) s += rt[a] * kj[a] * expf(cp[a] - cj[a]);
      } else if (j == t) {
        const float* rt = rs + t * ld;
        const float* kt = ks + t * ld;
        for (int a = 0; a < hd; ++a) s += rt[a] * uh[a] * kt[a];
      }
      A[i] = s;
    }
    __syncthreads();
    const float* cend = cs + (L - 1) * ld;
    for (int i = tid; i < L * hd; i += kThreads) {
      const int t = i / hd;
      const int a = i - t * hd;
      const float cp = t > 0 ? cs[(t - 1) * ld + a] : 0.f;
      rs[t * ld + a] *= expf(cp);
      ks[t * ld + a] *= expf(cend[a] - cs[t * ld + a]);
    }
    __syncthreads();
    for (int i = tid; i < L * hd; i += kThreads) {
      const int t = i / hd;
      const int c = i - t * hd;
      float acc = 0.f;
      for (int j = 0; j <= t; ++j) acc += A[t * L + j] * vs[j * ld + c];
      const float* rt = rs + t * ld;
      for (int a = 0; a < hd; ++a) acc += rt[a] * S[a * hd + c];
      y[base + (size_t)(c0 + t) * row + c] = acc;
    }
    __syncthreads();  // every reader of S is done before it is updated
    for (int i = tid; i < hd * hd; i += kThreads) {
      const int a = i / hd;
      const int c = i - a * hd;
      float acc = expf(cend[a]) * S[i];
      for (int j = 0; j < L; ++j) acc += ks[j * ld + a] * vs[j * ld + c];
      S[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < hd * hd; i += kThreads) s_out[sbase + i] = S[i];
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kYWarps = 4;      // warps that compute y, one a row tile
constexpr int kStateWarps = 4;  // warps that carry the state, stage, scan
constexpr int kWarps = 16;      // with 8 more that help build A
constexpr int kBuilders = kWarps - kStateWarps;  // warps that build A
constexpr int kStateThreads = 32 * kStateWarps;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kCols = 16;       // value columns a block carries
constexpr int kMaxChunk = 32;   // two row tiles
constexpr int kPadH = 8;   // bf16 after each staged row: 16 bytes, so the 8
                           // rows of an ldmatrix land on distinct banks
constexpr int kPadF = 4;   // floats after each row of lw / cum
constexpr int kPadA = 8;   // floats after each row of A
constexpr int kStages = 4;  // chunks p - 1 .. p + 2 of phase p (see below)
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int padded_chunk(int L) {
  return (L + 15) & ~15;
}

// One stage of the ring: r and k [Lp][hd + kPadH], the slice of v
// [Lp][kCols + kPadH] (bf16), lw and then its scaled cumulative sum, and the
// decay e^lw of each token [Lp][hd + kPadF] (float32); Lp is L rounded up
// to 16.
__host__ __device__ __forceinline__ int mma_stage_bytes(int hd, int Lp) {
  return 4 * Lp * (hd + kPadH) + 2 * Lp * (kCols + kPadH) +
         8 * Lp * (hd + kPadF);
}

// kStages stages, the state slice's hi and lo halves for two chunks
// [2][hd][kCols + kPadH] (bf16) and A for two chunks [2][Lp][Lp + kPadA]
// (float32): at most 135 KB (hd 64, L 32), so every shape the body takes
// fits.
size_t mma_smem_bytes(int hd, int L) {
  const int Lp = padded_chunk(L);
  return kStages * (size_t)mma_stage_bytes(hd, Lp) +
         8 * (size_t)hd * (kCols + kPadH) + 8 * (size_t)Lp * (Lp + kPadA);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// every cp.async group of this thread but the newest has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}
// the state warps alone (barrier 1; __syncthreads is barrier 0)
__device__ __forceinline__ void state_warps_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kStateThreads) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A B, m16n8k16, bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B for two pairs: hi hi + hi lo + lo hi
__device__ __forceinline__ void mma_pair3(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  mma_bf16(d, ah, bh0, bh1);
  mma_bf16(d, ah, bl0, bl1);
  mma_bf16(d, al, bh0, bh1);
}

// (a, b) -> hi = bf16(a, b), lo = bf16 of what hi leaves out; the low half
// of each word holds a.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x for x <= 0 as one ex2.approx.ftz (a result below 2^-126 flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ float2 ld_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// n consecutive channels (1 or 2) from shared memory, as float32
template <int n>
__device__ __forceinline__ void ld_bf16_ch(const bf16* p, float (&x)[n]) {
  if constexpr (n == 2) {
    const float2 v = ld_bf16x2(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}
template <int n>
__device__ __forceinline__ void ld_f32_ch(const float* p, float (&x)[n]) {
  if constexpr (n == 2) {
    const float2 v = ld_f2(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

// HD: the head dim (16, 32 or 64).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 1)
wkv6_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u,   // [H, HD]
                const float* __restrict__ s0,  // [B, H, HD, HD] or null
                bf16* __restrict__ y, float* __restrict__ s_out, int T_,
                int H, int L) {
  constexpr int kSlices = HD / kCols;
  constexpr int kKS = HD / 16;                 // 16-channel steps
  constexpr int kCPL = HD >= 32 ? HD / 32 : 1;  // channels a lane, pairwise
  constexpr int kLdh = HD + kPadH, kLdv = kCols + kPadH, kLdc = HD + kPadF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = padded_chunk(L);
  const int n_rt = Lp / 16;  // 16-row tiles of the chunk
  const int stage_bytes = mma_stage_bytes(HD, Lp);
  bf16* s_hi = reinterpret_cast<bf16*>(smem_raw + kStages * stage_bytes);
  bf16* s_lo = s_hi + 2 * HD * kLdv;  // state for chunk c: + (c & 1) HD kLdv
  float* Abuf = reinterpret_cast<float*>(s_lo + 2 * HD * kLdv);
  const int ldA = Lp + kPadA;  // A for chunk c: Abuf + (c & 1) Lp ldA

  const int h = blockIdx.x / kSlices, q = blockIdx.x - h * kSlices;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int sw = warp - kYWarps;  // state warp index (0-3); < 0 for y
  const int g = lane >> 2, c = lane & 3;  // mma fragment row, column pair
  const int mi = lane >> 3, mj = lane & 7;  // ldmatrix: matrix, row
  const size_t row = (size_t)H * HD;      // elements between tokens
  const size_t base = (size_t)b * T_ * row + (size_t)h * HD;
  const size_t sbase = ((size_t)b * H + h) * HD * HD;
  const int col0 = q * kCols;             // the slice's first value column

  struct Stage {
    bf16 *r, *k, *v;
    float *c, *w;  // cum (times log2 e), e^lw
  };
  auto stage = [&](int s) {
    Stage st;
    st.r = reinterpret_cast<bf16*>(smem_raw + s * stage_bytes);
    st.k = st.r + Lp * kLdh;
    st.v = st.k + Lp * kLdh;
    st.c = reinterpret_cast<float*>(st.v + Lp * kLdv);
    st.w = st.c + Lp * kLdc;
    return st;
  };
  // The state warps stage every chunk (the y warps never wait on a copy).
  const bool state_warp = sw >= 0 && sw < kStateWarps;
  auto load_chunk = [&](int c0, int s) {
    const Stage st = stage(s);
    const int i0 = tid - 32 * kYWarps;
    constexpr int kPH = HD / 8;  // 16-byte pieces of a bf16 row
    for (int i = i0; i < Lp * kPH; i += kStateThreads) {
      const int t = i / kPH, p = i - t * kPH;
      const bool in = t < L;
      const size_t off = base + (size_t)(c0 + t) * row + 8 * p;
      cp_async16(st.r + t * kLdh + 8 * p, in ? r + off : r, in);
      cp_async16(st.k + t * kLdh + 8 * p, in ? k + off : k, in);
    }
    for (int i = i0; i < Lp * (kCols / 8); i += kStateThreads) {
      const int t = i / (kCols / 8), p = i - t * (kCols / 8);
      const bool in = t < L;
      const size_t off = base + (size_t)(c0 + t) * row + col0 + 8 * p;
      cp_async16(st.v + t * kLdv + 8 * p, in ? v + off : v, in);
    }
    constexpr int kPF = HD / 4;  // 16-byte pieces of a float row
    for (int i = i0; i < Lp * kPF; i += kStateThreads) {
      const int t = i / kPF, p = i - t * kPF;
      const bool in = t < L;
      const size_t off = base + (size_t)(c0 + t) * row + 4 * p;
      cp_async16(st.c + t * kLdc + 4 * p, in ? lw + off : lw, in);
    }
    cp_async_commit();
  };
  // lw -> log2(e) cum in place, and e^lw beside it, by the state warps
  // once the copies landed: kP consecutive lanes a channel, each holding
  // Lp / kP rows in registers, and a shuffle scan across the kP lanes
  auto scan = [&](int s) {
    constexpr int kP = kStateThreads / HD;  // 2, 4 or 8
    constexpr int kR = kMaxChunk / kP;      // rows a lane at most
    const Stage st = stage(s);
    const int i0 = tid - 32 * kYWarps;
    const int a = i0 / kP, seg = i0 - a * kP;
    const int R = Lp / kP;
    float* col = st.c + seg * R * kLdc + a;
    float* wcol = st.w + seg * R * kLdc + a;
    float x[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) x[i] = i < R ? col[i * kLdc] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kR; ++i) sum += x[i];
    float incl = sum;
#pragma unroll
    for (int off = 1; off < kP; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off, kP);
      if (seg >= off) incl += o;
    }
    float run = __shfl_up_sync(0xffffffffu, incl, 1, kP);
    if (seg == 0) run = 0.f;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (i >= R) break;
      run += x[i];
      col[i * kLdc] = run * kLog2e;
      wcol[i * kLdc] = ex2(x[i] * kLog2e);
    }
  };

  const int n_chunks = T_ / L;
  if (state_warp) {  // chunks 0 and 1, one cp.async group each
    load_chunk(0, 0);
    if (n_chunks > 1)
      load_chunk(L, 1);
    else
      cp_async_commit();
  }

  // the state slice: state warp sw owns rows 16 sw.. (all kCols columns)
  const bool owns_state = sw >= 0 && sw < kKS;
  const int a_g = 16 * (owns_state ? sw : 0) + g;  // rows a_g and a_g + 8
  float sacc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = a_g + 8 * (e >> 1);
      const int cc = col0 + 8 * nt + 2 * c + (e & 1);
      sacc[nt][e] = owns_state && s0 != nullptr ? s0[sbase + a * HD + cc]
                                                : 0.f;
    }
  auto store_state = [&](int buf) {
    bf16* hi = s_hi + buf * HD * kLdv;
    bf16* lo = s_lo + buf * HD * kLdv;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = (a_g + 8 * half) * kLdv + 8 * nt + 2 * c;
        uint32_t vh, vl;
        split_bf16(sacc[nt][2 * half], sacc[nt][2 * half + 1], vh, vl);
        *reinterpret_cast<uint32_t*>(hi + off) = vh;
        *reinterpret_cast<uint32_t*>(lo + off) = vl;
      }
  };
  if (owns_state) store_state(0);
  if (state_warp) {
    cp_async_wait_prior();
    state_warps_sync();
    scan(0);
  }
  __syncthreads();  // chunk 0's copies, its cum and the state are visible

  // the lane's channels for the pairwise sums, and the bonus u there
  const bool lane_on = HD >= 32 || lane < HD;
  const int la = lane_on ? kCPL * lane : 0;
  float ul[kCPL];
#pragma unroll
  for (int i = 0; i < kCPL; ++i)
    ul[i] = lane_on ? u[(size_t)h * HD + la + i] : 0.f;

  // the builders' order: warps 8-15, then 2-3, then the y warps 0-1
  const int bidx = warp >= 8 ? warp - 8 : warp >= 2 ? warp + 6 : warp + 10;
  // Phase p: the state warps request chunk p + 2 and scan chunk p + 1 (its
  // copies landed during phase p - 1); the builders build A for chunk p;
  // the y warps and state warps finish chunk p - 1.  Chunk c lives in stage
  // c % 4 and writes A buffer c & 1; one barrier a phase.
  for (int p = 0; p <= n_chunks; ++p) {
    if (state_warp) {
      if (p + 2 < n_chunks)
        load_chunk((p + 2) * L, (p + 2) % kStages);
      else
        cp_async_commit();  // an empty group keeps the count
      if (p + 1 < n_chunks) {
        cp_async_wait_prior();  // every group but the newest: chunk p + 1
        state_warps_sync();
        scan((p + 1) % kStages);
      }
    }
    if (p < n_chunks && !state_warp) {
      const Stage st = stage(p % kStages);
      const float* cs = st.c;
      float* A = Abuf + (p & 1) * Lp * ldA;
      // --- A within 8-row blocks, pair by pair ---
      // item (T, w) takes rows w and 15 - w of tile T: 7 pairs (j < t in
      // the row's block of 8) and the two bonuses, nine independent sums a
      // lane over its channels, then reduced over the lanes.  A pair's
      // decay e^{cum[t-1] - cum[j]} is the product of e^lw over j < s < t,
      // so each row runs down its columns multiplying, with no exp.
#pragma unroll 1
      for (int item = bidx; item < 8 * n_rt; item += kBuilders) {
        const int T = item >> 3, w = item & 7;
        const int ta = 16 * T + w, tb = 16 * T + 15 - w;
        float ra[kCPL], rb[kCPL], ka[kCPL], kb[kCPL], da[kCPL], db[kCPL];
        ld_bf16_ch<kCPL>(st.r + ta * kLdh + la, ra);
        ld_bf16_ch<kCPL>(st.r + tb * kLdh + la, rb);
        ld_bf16_ch<kCPL>(st.k + ta * kLdh + la, ka);
        ld_bf16_ch<kCPL>(st.k + tb * kLdh + la, kb);
#pragma unroll
        for (int i = 0; i < kCPL; ++i) {
          if (!lane_on) ra[i] = rb[i] = 0.f;  // lanes past hd 16 add nothing
          da[i] = db[i] = 1.f;
        }
        float out[9];
        // slots 0 .. w - 1: row ta's columns; w .. 6: row tb's; each row's
        // columns from the last one down, so its decay grows by one factor
#pragma unroll
        for (int slot = 6; slot >= 0; --slot) {
          const bool in_a = slot < w;
          const int j = 16 * T + (in_a ? slot : 8 + slot - w);
          float kj[kCPL], wj[kCPL];
          ld_bf16_ch<kCPL>(st.k + j * kLdh + la, kj);
          ld_f32_ch<kCPL>(st.w + j * kLdc + la, wj);
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < kCPL; ++i) {
            acc += (in_a ? ra[i] : rb[i]) * kj[i] * (in_a ? da[i] : db[i]);
            if (in_a)
              da[i] *= wj[i];
            else
              db[i] *= wj[i];
          }
          out[slot] = acc;
        }
        out[7] = out[8] = 0.f;
#pragma unroll
        for (int i = 0; i < kCPL; ++i) {
          out[7] += ra[i] * ul[i] * ka[i];
          out[8] += rb[i] * ul[i] * kb[i];
        }
        // reduce-scatter of sums 0-7 over the 32 lanes (lane l ends with
        // sum l >> 2), and sum 8 over all of them
        const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4;
        float p4[4], p2[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p4[i] = (u16 ? out[i + 4] : out[i]) +
                  __shfl_xor_sync(0xffffffffu, u16 ? out[i] : out[i + 4], 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          p2[i] = (u8 ? p4[i + 2] : p4[i]) +
                  __shfl_xor_sync(0xffffffffu, u8 ? p4[i] : p4[i + 2], 8);
        float p1 = (u4 ? p2[1] : p2[0]) +
                   __shfl_xor_sync(0xffffffffu, u4 ? p2[0] : p2[1], 4);
        float b8 = out[8];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          b8 += __shfl_xor_sync(0xffffffffu, b8, off);
        p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
        p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
        if ((lane & 3) == 0) {
          const int q = lane >> 2;
          const int t = q == 7 || q < w ? ta : tb;
          const int j = q == 7 ? ta : 16 * T + (q < w ? q : 8 + q - w);
          A[t * ldA + j] = p1;
        }
        if (lane == 0) A[tb * ldA + tb] = b8;
      }

      // --- A below the pairs, one product a 16 x 8 unit: tile T's rows
      // against columns 8 nt.. of an earlier tile J (through J's last row),
      // and tile T's second block of 8 rows against its first (through the
      // first block's last row); tile T has units T^2 .. (T + 1)^2 - 1 ---
#pragma unroll 1
      for (int unit = ((bidx - 8 * n_rt) % kBuilders + kBuilders) % kBuilders;
           unit < n_rt * n_rt; unit += kBuilders) {
        int T = 0;
        while ((T + 1) * (T + 1) <= unit) ++T;
        const int idx = unit - T * T;  // 0: the tile's own blocks
        const bool own = idx == 0;
        const int J = own ? T : (idx - 1) >> 1, nt = own ? 0 : (idx - 1) & 1;
        const int e = own ? 16 * T + 7 : 16 * J + 15;  // the reference row
        const int t0 = 16 * T + g, t1 = t0 + 8;
        const int j = 16 * J + 8 * nt + g;  // the lane's column
        float acc[2][4] = {};  // [k step parity]
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
          for (int hc = 0; hc < 2; ++hc) {  // channels a, a + 1 at + 8 hc
            const int a = 16 * ks + 2 * c + 8 * hc;
            const float2 ce = ld_f2(cs + e * kLdc + a);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {  // rows t0, t1
              const int t = rr ? t1 : t0;
              if (own && rr == 0) {  // the first block: no product
                ah[2 * hc] = al[2 * hc] = 0u;
                continue;
              }
              const float2 rv = ld_bf16x2(st.r + t * kLdh + a);
              const float2 cp = ld_f2(cs + (t - 1) * kLdc + a);
              split_bf16(rv.x * ex2(cp.x - ce.x), rv.y * ex2(cp.y - ce.y),
                         ah[2 * hc + rr], al[2 * hc + rr]);
            }
            const float2 kv = ld_bf16x2(st.k + j * kLdh + a);
            const float2 cj = ld_f2(cs + j * kLdc + a);
            split_bf16(kv.x * ex2(ce.x - cj.x), kv.y * ex2(ce.y - cj.y),
                       bh[hc], bl[hc]);
          }
          mma_pair3(acc[ks & 1], ah, al, bh[0], bh[1], bl[0], bl[1]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (own && !half) continue;
          const int t = half ? t1 : t0;
          *reinterpret_cast<float2*>(A + t * ldA + 16 * J + 8 * nt + 2 * c) =
              make_float2(acc[0][2 * half] + acc[1][2 * half],
                          acc[0][2 * half + 1] + acc[1][2 * half + 1]);
        }
      }
    }
    if (p > 0) {  // chunk cc = p - 1: y and the state update
      const int cc = p - 1, s = cc & 1;
      const Stage st = stage(cc % kStages);
      const float* cs = st.c;
      const float* A = Abuf + s * Lp * ldA;
      const size_t tok = base + (size_t)cc * L * row;  // the chunk's row 0
      const int T = warp;  // a y warp's row tile
      const bool y_on = sw < 0 && T < n_rt;
      const int t0 = 16 * T + g, t1 = t0 + 8;  // the lane's rows
      if (y_on) {
        // --- y = A v + (r e^{cum[t-1]}) S, in three sets of accumulators
        // (A v; the state term's even and odd k steps) for shorter chains ---
        float yacc[3][2][4] = {};
        const uint32_t v_a = smem_addr(st.v);
#pragma unroll
        for (int J = 0; J < 4; ++J) {
          if (J > T) continue;
          float f[2][4];  // A's rows t0, t1 at columns 16 J + 8 nt + 2 c ..
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int t = half ? t1 : t0, j = 16 * J + 8 * nt + 2 * c;
              const float2 x = ld_f2(A + t * ldA + j);
              // the tile's own columns past t were not written: select 0
              f[nt][2 * half] = j <= t ? x.x : 0.f;
              f[nt][2 * half + 1] = j + 1 <= t ? x.y : 0.f;
            }
          uint32_t ah[4], al[4];
          split_bf16(f[0][0], f[0][1], ah[0], al[0]);
          split_bf16(f[0][2], f[0][3], ah[1], al[1]);
          split_bf16(f[1][0], f[1][1], ah[2], al[2]);
          split_bf16(f[1][2], f[1][3], ah[3], al[3]);
          uint32_t bx[4];
          ldmatrix_x4_trans(bx, v_a + 2 * ((16 * J + (mi & 1) * 8 + mj) * kLdv +
                                           (mi >> 1) * 8));
          mma_bf16(yacc[0][0], ah, bx[0], bx[1]);
          mma_bf16(yacc[0][1], ah, bx[2], bx[3]);
          mma_bf16(yacc[0][0], al, bx[0], bx[1]);
          mma_bf16(yacc[0][1], al, bx[2], bx[3]);
        }
        const uint32_t sh_a = smem_addr(s_hi + s * HD * kLdv);
        const uint32_t sl_a = smem_addr(s_lo + s * HD * kLdv);
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          uint32_t rh[4], rl[4];
#pragma unroll
          for (int hc = 0; hc < 2; ++hc) {
            const int a = 16 * ks + 2 * c + 8 * hc;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int t = rr ? t1 : t0;
              const float2 rv = ld_bf16x2(st.r + t * kLdh + a);
              const float2 cp =
                  t > 0 ? ld_f2(cs + (t - 1) * kLdc + a) : make_float2(0, 0);
              split_bf16(rv.x * ex2(cp.x), rv.y * ex2(cp.y), rh[2 * hc + rr],
                         rl[2 * hc + rr]);
            }
          }
          const int off = 2 * ((16 * ks + (mi & 1) * 8 + mj) * kLdv +
                               (mi >> 1) * 8);
          uint32_t bh[4], bl[4];
          ldmatrix_x4_trans(bh, sh_a + off);
          ldmatrix_x4_trans(bl, sl_a + off);
          mma_pair3(yacc[1 + (ks & 1)][0], rh, rl, bh[0], bh[1], bl[0], bl[1]);
          mma_pair3(yacc[1 + (ks & 1)][1], rh, rl, bh[2], bh[3], bl[2], bl[3]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = half ? t1 : t0;
          if (t >= L) continue;
          bf16* yrow = y + tok + (size_t)t * row + col0 + 2 * c;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * nt) =
                __floats2bfloat162_rn(
                    yacc[0][nt][2 * half] + yacc[1][nt][2 * half] +
                        yacc[2][nt][2 * half],
                    yacc[0][nt][2 * half + 1] + yacc[1][nt][2 * half + 1] +
                        yacc[2][nt][2 * half + 1]);
        }
      }

      if (owns_state) {
        // --- state warps: S = e^{cum[L-1]} S + (k e^{cum[L-1] - cum})^T v ---
        const float* cend = cs + (Lp - 1) * kLdc;
        const float ce0 = cend[a_g], ce1 = cend[a_g + 8];
        const float d0 = ex2(ce0), d1 = ex2(ce1);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          sacc[nt][0] *= d0;
          sacc[nt][1] *= d0;
          sacc[nt][2] *= d1;
          sacc[nt][3] *= d1;
        }
        const uint32_t k_a = smem_addr(st.k), v_a = smem_addr(st.v);
#pragma unroll 1
        for (int kt = 0; kt < n_rt; ++kt) {
          uint32_t ak[4], kh[4], kl[4], bx[4];
          ldmatrix_x4_trans(ak, k_a + 2 * ((16 * kt + (mi >> 1) * 8 + mj) *
                                               kLdh + 16 * sw + (mi & 1) * 8));
          ldmatrix_x4_trans(bx, v_a + 2 * ((16 * kt + (mi & 1) * 8 + mj) *
                                               kLdv + (mi >> 1) * 8));
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {  // rows a_g + 8 (qq & 1), t pairs
            const int a = a_g + 8 * (qq & 1);
            const int t = 16 * kt + 2 * c + 8 * (qq >> 1);
            const float ce = qq & 1 ? ce1 : ce0;
            const float2 f = unpack_bf16(ak[qq]);
            split_bf16(f.x * ex2(ce - cs[t * kLdc + a]),
                       f.y * ex2(ce - cs[(t + 1) * kLdc + a]), kh[qq], kl[qq]);
          }
          mma_bf16(sacc[0], kh, bx[0], bx[1]);
          mma_bf16(sacc[1], kh, bx[2], bx[3]);
          mma_bf16(sacc[0], kl, bx[0], bx[1]);
          mma_bf16(sacc[1], kl, bx[2], bx[3]);
        }
        if (cc + 1 < n_chunks) store_state(s ^ 1);
      }
    }
    __syncthreads();  // this phase's reads are done; chunk p + 1's cum,
                      // chunk p's A and the state for chunk p are visible
  }

  if (owns_state) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int a = a_g + 8 * half;
        *reinterpret_cast<float2*>(s_out + sbase + a * HD + col0 + 8 * nt +
                                   2 * c) =
            make_float2(sacc[nt][2 * half], sacc[nt][2 * half + 1]);
      }
  }
}

int launch_f32(const void* r, const void* k, const void* v, const void* lw,
               const void* u, const void* s0, void* y, void* s_out, int B,
               int T_, int H, int hd, int L, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, L);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), T_, H, hd, L);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const void* r, const void* k, const void* v, const void* lw,
               const void* u, const void* s0, void* y, void* s_out, int B,
               int T_, int H, int L, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(HD, L);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_mma_kernel<HD>
      <<<dim3(H * (HD / kCols), B), kMmaThreads, smem, stream>>>(
          static_cast<const bf16*>(r), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const float*>(lw),
          static_cast<const float*>(u), static_cast<const float*>(s0),
          static_cast<bf16*>(y), static_cast<float*>(s_out), T_, H, L);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype of r/k/v/y: 0 = float32, 1 = bfloat16.  s0 may be null (zeros).
extern "C" int wkv6_forward(int dtype, const void* r, const void* k,
                            const void* v, const void* lw, const void* u,
                            const void* s0, void* y, void* s_out, int B,
                            int T_, int H, int hd, int L, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || hd <= 0 || L <= 0 || T_ <= 0 ||
      T_ % L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(r, k, v, lw, u, s0, y, s_out, B, T_, H, hd, L, s);
  if (dtype != 1 || L > kMaxChunk || !aligned16(r) || !aligned16(k) ||
      !aligned16(v) || !aligned16(lw))
    return (int)cudaErrorInvalidValue;
  if (hd == 16)
    return launch_mma<16>(r, k, v, lw, u, s0, y, s_out, B, T_, H, L, s);
  if (hd == 32)
    return launch_mma<32>(r, k, v, lw, u, s0, y, s_out, B, T_, H, L, s);
  if (hd == 64)
    return launch_mma<64>(r, k, v, lw, u, s0, y, s_out, B, T_, H, L, s);
  return (int)cudaErrorInvalidValue;
}
