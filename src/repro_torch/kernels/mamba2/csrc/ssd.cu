// Chunked Mamba2 SSD (state-space duality scan) for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_bthp` / `_ssd_kernel`
// (src/repro/kernels/mamba2/kernel.py:61, body :22).  It computes what that
// kernel computes, not how: the TPU runs the chunks as the sequential second
// grid axis (B, n_chunks) and holds the whole [H, N, P] state in VMEM
// scratch (zamba2-2.7b: 80 x 64 x 64 float32 = 1.3 MB, far over the 227 KB
// of shared memory a Hopper block may use).  The decay is a scalar per head,
// so the heads are independent.  Here a block owns a (sequence b, head h)
// pair, loops over the chunks in order and carries that head's state; every
// block recomputes the chunk's C.B^T, which all heads share.  Beyond the TPU
// kernel it starts from an optional state h0 and writes the final state,
// which is what the model's `ssd_chunked` returns and the prefill stores.
//
// Per chunk of L tokens:
//   cum[t]    = sum_{s <= t} dt[s] * A[h]            (decreasing)
//   sc[t][j]  = (C_t . B_j) * exp(cum[t] - cum[j]) * dt[j]     for j <= t
//   y[t]      = sum_{j <= t} sc[t][j] x[j] + exp(cum[t]) * C_t . h
//   h'        = exp(cum[L-1]) h + sum_j exp(cum[L-1] - cum[j]) dt[j] B_j x_j^T
// Every exp argument is <= 0, as in the reference.
//
// Bound: per token and head the work is ~2 (L N + L P + 2 N P) operations
// against P inputs and P outputs of x/y (B, C and dt are shared by the
// heads), so at L 128, N = P = 64 with bf16 x it does ~160 operations a
// byte: on an H100 (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s float32,
// 3.35 TB/s) it is bytes-bound at the tensor-core rate and operation-bound
// on the CUDA cores.  So bf16 runs on the tensor cores.  (The hi + lo pairs
// below double three of the four products; the bound counts the function's
// work, not the kernel's.)
//
// bf16 body (`ssd_mma_kernel`, templated on P in {16, 32, 64}): the grid
// is (H, B) blocks of 8 warps, one a (sequence, head) as in the float32
// body (zamba2-2.7b's prefill, B 1 x H 80, fills 80 of the 132 SMs).
// Splitting a head's P columns across blocks (they are independent once
// C.B^T and the decays are fixed) was measured slower at every split on
// this shape, so no split is made (PERF.md).  All four products run as
// `mma.sync` m16n8k16 with float32 accumulators (a warp-level product: a
// chunk's row tiles are 16 tall and the scores live in registers, which
// fits mma.sync; `wgmma` would want 64-row tiles from shared memory):
//   * C.B^T (M = L, N = L, K = N), lower tiles only, 16 columns at a time,
//     B's next fragments requested before this step's products; C's
//     fragments stay in registers for the row tile;
//   * the scores are formed in those accumulators (x exp(cum_t - cum_j)
//     dt_j, masked to j <= t, exp as one `ex2.approx.ftz`) and go straight
//     into the A operand of scores.x (M = L, N = P, K = L);
//   * the inter-chunk term C.h (K = N), its rows scaled by exp(cum_t);
//   * the state update h' = exp(cum_L) h + (B w)^T x with w_j =
//     exp(cum_L - cum_j) dt_j (M = N, N = P, K = L): B comes through
//     `ldmatrix.trans` and is scaled by w in registers.
// x, B and C enter exactly as bf16.  The scores, B w and the carried state
// are float32 values; each enters as a hi + lo pair of bf16 (two MMAs into
// one float32 accumulator, ~2^-17 relative), which keeps y within bf16's
// rounding of the float32 plain version and the state within 1e-4 (a
// single bf16 for any of the three misses one of those limits).
// Warps 0-3 compute y: warp w the row tiles w and, at L > 64, the one that
// evens the C.B^T work (7 - w at L 128).  Warps 4-7 carry the state,
// meanwhile: state warp s owns rows 16 s.. of N (and 16 (s + 4).. at N >
// 64) in its MMA accumulators, in float32 across the chunks, and writes
// them to shared memory as a hi + lo pair after each chunk for the next
// chunk's C.h.  The state warps also stage the chunks: x, B and C in
// shared memory as bf16 in a 2-stage ring of 16-byte `cp.async` copies,
// the next chunk requested as the current one starts; rows past a ragged L
// are zero-filled by the copies (stale bits times a zero weight can be
// NaN).  State warp 0 then scans the next chunk's cumulative sum (4 tokens
// a lane and a shuffle scan) into the other of two cum/w buffers, so the y
// warps never wait on a copy or a scan.  Two block barriers a chunk.
// What bounds it: one warp alone keeps its SM partition's tensor core only
// partly busy, so the y warps' dependent chains of C.B^T, scores and
// products set the time, not bytes (PERF.md).
//
// float32 body (`ssd_kernel`): x/B/C/y in float32 on the CUDA cores, one
// block a (sequence, head) with every operand of a chunk in shared memory
// (180 KB at zamba2's shapes), B rows padded by one float; it serves the
// tests against the CPU and float32 models, which must agree with the
// plain version to ~1e-5 (TF32 tensor cores would not).
//
// Supported: float32 or bfloat16 x/B/C/y, dt/A/h0/h_out float32, all
// contiguous; T a multiple of L; L <= 128.  float32: the shared memory
// (N P + L P + 2 L (N + 1) + L^2 + 2 L floats) within 227 KB.  bfloat16: N a
// multiple of 16 up to 128, P 16, 32 or 64, x, B and C 16-byte aligned.
// The C entry point returns cudaErrorInvalidValue for any other shape (the
// Python wrapper raises ValueError for it), else cudaGetLastError() after
// the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

size_t smem_bytes(int N, int P, int L) {
  return sizeof(float) * ((size_t)N * P + (size_t)L * P +
                          2 * (size_t)L * (N + 1) + (size_t)L * L +
                          2 * (size_t)L);
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x,   // [B, T, H, P]
           const float* __restrict__ dt,  // [B, T, H]
           const float* __restrict__ A,   // [H]
           const float* __restrict__ Bm,  // [B, T, N]
           const float* __restrict__ Cm,  // [B, T, N]
           const float* __restrict__ h0,  // [B, H, N, P] or null
           float* __restrict__ y,         // [B, T, H, P]
           float* __restrict__ h_out,     // [B, H, N, P]
           int T_, int H, int P, int N, int L) {
  extern __shared__ float smem[];
  const int ldn = N + 1;     // padded row of B and C
  float* hs = smem;          // [N, P] state
  float* xs = hs + N * P;    // [L, P]
  float* bs = xs + L * P;    // [L, ldn] B, then B * exp(cum[L-1]-cum) * dt
  float* cs = bs + L * ldn;  // [L, ldn] C
  float* sc = cs + L * ldn;  // [L, L] scores
  float* cum = sc + L * L;   // [L]
  float* dts = cum + L;      // [L]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a_h = A[h];
  const size_t hbase = ((size_t)b * H + h) * N * P;

  for (int i = tid; i < N * P; i += kThreads)
    hs[i] = h0 != nullptr ? h0[hbase + i] : 0.f;

  for (int c0 = 0; c0 < T_; c0 += L) {
    __syncthreads();  // the previous chunk's readers are done
    const size_t tok = (size_t)b * T_ + c0;  // first token of the chunk
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = i / P;
      const int p = i - t * P;
      xs[i] = x[((tok + t) * H + h) * P + p];
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      bs[t * ldn + n] = Bm[(tok + t) * N + n];
      cs[t * ldn + n] = Cm[(tok + t) * N + n];
    }
    for (int t = tid; t < L; t += kThreads) dts[t] = dt[(tok + t) * H + h];
    __syncthreads();
    if (tid == 0) {  // cumulative log-decay of the head
      float c = 0.f;
      for (int t = 0; t < L; ++t) {
        c += dts[t] * a_h;
        cum[t] = c;
      }
    }
    __syncthreads();
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L;
      const int j = i - t * L;
      float s = 0.f;
      if (j <= t) {
        const float* ct = cs + t * ldn;
        const float* bj = bs + j * ldn;
        for (int n = 0; n < N; ++n) s += ct[n] * bj[n];
        s *= expf(cum[t] - cum[j]) * dts[j];
      }
      sc[i] = s;
    }
    __syncthreads();
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = i / P;
      const int p = i - t * P;
      float acc = 0.f;
      for (int j = 0; j <= t; ++j) acc += sc[t * L + j] * xs[j * P + p];
      const float* ct = cs + t * ldn;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter += ct[n] * hs[n * P + p];
      acc += expf(cum[t]) * inter;
      y[((tok + t) * H + h) * P + p] = acc;
    }
    __syncthreads();  // every reader of h and B is done
    const float cend = cum[L - 1];
    for (int i = tid; i < L * N; i += kThreads) {
      const int j = i / N;
      const int n = i - j * N;
      bs[j * ldn + n] *= expf(cend - cum[j]) * dts[j];
    }
    __syncthreads();
    const float decay = expf(cend);
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P;
      const int p = i - n * P;
      float acc = decay * hs[i];
      for (int j = 0; j < L; ++j) acc += bs[j * ldn + n] * xs[j * P + p];
      hs[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads) h_out[hbase + i] = hs[i];
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kYWarps = 4;      // warps that compute y, row tiles in pairs
constexpr int kStateWarps = 4;  // warps that carry and update the state
constexpr int kMmaThreads = 32 * (kYWarps + kStateWarps);
constexpr int kPad = 8;  // bf16 after each staged row: 16 bytes, so the 8
                         // rows of an ldmatrix land on distinct banks

__host__ __device__ __forceinline__ int padded_chunk(int L) {
  return (L + 15) & ~15;
}

// One stage of the ring: x [Lp][P + kPad], B and C [Lp][N + kPad] (bf16),
// dt [Lp] (float32); Lp is L rounded up to 16.
__host__ __device__ __forceinline__ int mma_stage_bytes(int N, int P,
                                                        int Lp) {
  return 2 * Lp * (P + kPad) + 4 * Lp * (N + kPad) + 4 * Lp;
}

// Two stages, the state's hi and lo halves [N][P + kPad] (bf16), cum and
// the state-update weights w [2][Lp] (float32, one for each stage): at most
// 211 KB (N 128, P 64, L 128), so every shape the body takes fits.
size_t mma_smem_bytes(int N, int P, int L) {
  const int Lp = padded_chunk(L);
  return 2 * (size_t)mma_stage_bytes(N, P, Lp) + 4 * (size_t)N * (P + kPad) +
         16 * (size_t)Lp;
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A B, m16n8k16, bf16 in, float32 accumulators.  Not volatile, so the
// compiler may move it among the (volatile, ordered) shared-memory loads.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// exp(x) for x <= 0 as one ex2.approx.ftz: a result below 2^-126 flushes
// to 0 (`__expf` without ftz takes a slower path for such results)
__device__ __forceinline__ float exp_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// P: the head's columns (16, 32 or 64).  kMaxNK: the most 16-row
// steps of N (4: N <= 64, 8: N <= 128); N / 16 of them run.
template <int P, int kMaxNK>
__global__ void __launch_bounds__(kMmaThreads)
ssd_mma_kernel(const __nv_bfloat16* __restrict__ x,   // [B, T, H, P]
               const float* __restrict__ dt,          // [B, T, H]
               const float* __restrict__ A,           // [H]
               const __nv_bfloat16* __restrict__ Bm,  // [B, T, N]
               const __nv_bfloat16* __restrict__ Cm,  // [B, T, N]
               const float* __restrict__ h0,          // [B, H, N, P] or null
               __nv_bfloat16* __restrict__ y,         // [B, T, H, P]
               float* __restrict__ h_out,             // [B, H, N, P]
               int T_, int H, int N, int L) {
  constexpr int kNT = P / 8;                // 8-column tiles of P
  constexpr int kMR = (kMaxNK + kStateWarps - 1) / kStateWarps;  // m-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;  // (the float32 body names its own smem)
  const int NK = N / 16;
  const int Lp = padded_chunk(L);
  const int ldx = P + kPad, ldn = N + kPad;
  const int stage_bytes = mma_stage_bytes(N, P, Lp);
  __nv_bfloat16* h_hi =
      reinterpret_cast<__nv_bfloat16*>(smem + 2 * stage_bytes);  // [N][ldx]
  __nv_bfloat16* h_lo = h_hi + N * ldx;
  // cum and w, double-buffered: chunk ci's in cum + (ci & 1) Lp
  float* cum = reinterpret_cast<float*>(h_lo + N * ldx);  // [2][Lp]
  float* wgt = cum + 2 * Lp;  // [2][Lp] exp(cum[L-1] - cum[j]) dt[j], 0 past L

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int sw = warp - kYWarps;             // state warp index, < 0 for y
  const int g = lane >> 2, c = lane & 3;     // mma fragment row, column pair
  const int mi = lane >> 3, mj = lane & 7;   // ldmatrix: matrix, row
  const float a_h = A[h];
  const size_t hbase = ((size_t)b * H + h) * N * P;

  auto stage_x = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * stage_bytes);
  };
  // The state warps stage every chunk (the y warps never wait on a copy);
  // state warp 0 stages dt, which it scans.
  auto load_chunk = [&](int c0, int s) {
    __nv_bfloat16* xs = stage_x(s);
    __nv_bfloat16* bs = xs + Lp * ldx;
    __nv_bfloat16* cs = bs + Lp * ldn;
    float* ds = reinterpret_cast<float*>(cs + Lp * ldn);
    const size_t tok = (size_t)b * T_ + c0;
    const __nv_bfloat16* xg = x + (tok * H + h) * P;  // row t: + t H P
    const __nv_bfloat16* bg = Bm + tok * N;
    const __nv_bfloat16* cg = Cm + tok * N;
    const int st = tid - 32 * kYWarps;
    for (int i = st; i < Lp * (P / 8); i += 32 * kStateWarps) {
      const int t = i / (P / 8), k = i - t * (P / 8);
      const bool in = t < L;
      cp_async16(xs + t * ldx + 8 * k, in ? xg + t * H * P + 8 * k : x, in);
    }
    const int nc = N / 8;
    for (int i = st; i < Lp * nc; i += 32 * kStateWarps) {
      const int t = i / nc, k = i - t * nc;
      const bool in = t < L;
      cp_async16(bs + t * ldn + 8 * k, in ? bg + t * N + 8 * k : Bm, in);
      cp_async16(cs + t * ldn + 8 * k, in ? cg + t * N + 8 * k : Cm, in);
    }
    if (sw == 0) {
      const float* dg = dt + tok * H + h;
      for (int t = lane; t < Lp; t += 32)
        cp_async4(ds + t, t < L ? dg + t * H : dt, t < L);
    }
    cp_async_commit();
  };
  // cum and w of the chunk in stage s, by state warp 0 once its copies
  // landed: 4 tokens a lane, then a shuffle scan
  auto scan = [&](int s) {
    __syncwarp();  // every lane's dt copies are visible to the warp
    const float* ds = reinterpret_cast<const float*>(
        stage_x(s) + Lp * ldx + 2 * Lp * ldn);
    float v[4], run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = 4 * lane + k;
      run += (t < Lp ? ds[t] : 0.f) * a_h;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float total = __shfl_sync(0xffffffffu, incl, 31);  // cum[L-1]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = 4 * lane + k;
      if (t < Lp) {
        const float ct = excl + v[k];
        cum[s * Lp + t] = ct;
        wgt[s * Lp + t] = expf(total - ct) * ds[t];
      }
    }
  };

  const int n_chunks = T_ / L;
  const int n_rt = Lp / 16;  // 16-row tiles of the chunk
  if (sw >= 0) load_chunk(0, 0);

  // the state: state warp sw owns rows 16 (sw + 4 r) .. + 15 of N, all P
  // columns, in its accumulators
  float hacc[kMR][kNT][4];
#pragma unroll
  for (int r = 0; r < kMR; ++r)
#pragma unroll
    for (int pn = 0; pn < kNT; ++pn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * (sw + kStateWarps * r) + g + 8 * (e >> 1);
        const int p = 8 * pn + 2 * c + (e & 1);
        hacc[r][pn][e] = h0 != nullptr && sw >= 0 && n < N
                             ? h0[hbase + n * P + p] : 0.f;
      }
  auto store_state = [&]() {
#pragma unroll
    for (int r = 0; r < kMR; ++r) {
      const int mt = sw + kStateWarps * r;
      if (sw < 0 || mt >= NK) continue;
#pragma unroll
      for (int pn = 0; pn < kNT; ++pn)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = (16 * mt + g + 8 * half) * ldx + 8 * pn + 2 * c;
          uint32_t hi, lo;
          split_bf16(hacc[r][pn][2 * half], hacc[r][pn][2 * half + 1], hi,
                     lo);
          *reinterpret_cast<uint32_t*>(h_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(h_lo + off) = lo;
        }
    }
  };
  store_state();
  if (sw >= 0) {
    cp_async_wait<0>();
    if (sw == 0) scan(0);
  }
  __syncthreads();  // chunk 0's copies, its cum and w, and h are visible

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s = ci & 1;
    const bool next = ci + 1 < n_chunks;
    if (sw >= 0 && next) load_chunk((ci + 1) * L, s ^ 1);  // flies meanwhile
    const __nv_bfloat16* xs = stage_x(s);
    const __nv_bfloat16* bs = xs + Lp * ldx;
    const __nv_bfloat16* cs = bs + Lp * ldn;
    const float* ds = reinterpret_cast<const float*>(cs + Lp * ldn);
    const float* cum_s = cum + s * Lp;
    const float* wgt_s = wgt + s * Lp;
    const uint32_t xs_a = smem_addr(xs), bs_a = smem_addr(bs);
    const uint32_t cs_a = smem_addr(cs);
    // x rows 16 jk.., columns 16 dp..: the B operand (K = j, N = p) of
    // scores.x and of the state update
    auto x_frag = [&](int jk, int dp) {
      return xs_a + 2 * ((16 * jk + (mi & 1) * 8 + mj) * ldx + 16 * dp +
                         (mi >> 1) * 8);
    };
    const size_t tok = (size_t)b * T_ + (size_t)ci * L;
    // y warps: row tile `warp`, and at n_rt > 4 the tile that evens the work
#pragma unroll 1
    for (int pass = 0; pass < 2 && sw < 0; ++pass) {
      const int i = pass == 0 ? warp : n_rt - 1 - warp;
      if (pass == 0 ? i >= n_rt : i < kYWarps) continue;
      uint32_t cf[kMaxNK][4];  // C rows of the tile: A operand, K = N
#pragma unroll
      for (int kn = 0; kn < kMaxNK; ++kn)
        if (kn < NK)
          ldmatrix_x4(cf[kn], cs_a + 2 * ((16 * i + (mi & 1) * 8 + mj) * ldn +
                                          16 * kn + (mi >> 1) * 8));
      float yacc[kNT][4] = {};
      // inter-chunk term C . h, h as its hi and lo halves
#pragma unroll
      for (int kn = 0; kn < kMaxNK; ++kn) {
        if (kn >= NK) continue;
        uint32_t bh[P / 16][4], bl[P / 16][4];
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          const int off = (16 * kn + (mi & 1) * 8 + mj) * ldx + 16 * dp +
                          (mi >> 1) * 8;
          ldmatrix_x4_trans(bh[dp], smem_addr(h_hi + off));
          ldmatrix_x4_trans(bl[dp], smem_addr(h_lo + off));
        }
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          mma_bf16(yacc[2 * dp], cf[kn], bh[dp][0], bh[dp][1]);
          mma_bf16(yacc[2 * dp + 1], cf[kn], bh[dp][2], bh[dp][3]);
          mma_bf16(yacc[2 * dp], cf[kn], bl[dp][0], bl[dp][1]);
          mma_bf16(yacc[2 * dp + 1], cf[kn], bl[dp][2], bl[dp][3]);
        }
      }
      const int t0 = 16 * i + g;  // this lane's rows: t0 and t0 + 8
      const float cum0 = cum_s[t0], cum1 = cum_s[t0 + 8];
      const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
      for (int pn = 0; pn < kNT; ++pn) {
        yacc[pn][0] *= e0;
        yacc[pn][1] *= e0;
        yacc[pn][2] *= e1;
        yacc[pn][3] *= e1;
      }
      // intra-chunk term, 16 columns j of C.B^T at a time up to the
      // diagonal; B's fragments for the next 16 are requested before this
      // step's products
      uint32_t bb[kMaxNK][4];
      auto load_b = [&](int jk) {
#pragma unroll
        for (int kn = 0; kn < kMaxNK; ++kn)
          if (kn < NK)
            ldmatrix_x4(bb[kn], bs_a + 2 * ((16 * jk + (mi >> 1) * 8 + mj) *
                                                ldn + 16 * kn + (mi & 1) * 8));
      };
      load_b(0);
#pragma unroll 1
      for (int jk = 0; jk <= i; ++jk) {
        uint32_t bx[P / 16][4];
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp)
          ldmatrix_x4_trans(bx[dp], x_frag(jk, dp));
        float sc[2][4] = {}, sd[2][4] = {};  // even and odd k steps
#pragma unroll
        for (int kn = 0; kn < kMaxNK; ++kn) {
          if (kn >= NK) continue;
          float(&acc)[2][4] = kn & 1 ? sd : sc;
          mma_bf16(acc[0], cf[kn], bb[kn][0], bb[kn][1]);
          mma_bf16(acc[1], cf[kn], bb[kn][2], bb[kn][3]);
        }
        if (jk < i) load_b(jk + 1);
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * jk + 8 * half + 2 * c;
          const float2 cj = *reinterpret_cast<const float2*>(cum_s + j);
          const float2 dj = *reinterpret_cast<const float2*>(ds + j);
          float sv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = t0 + 8 * (e >> 1), jj = j + (e & 1);
            const float ct = e >> 1 ? cum1 : cum0;
            const float cjj = e & 1 ? cj.y : cj.x;
            const float djj = e & 1 ? dj.y : dj.x;
            const float cb = sc[half][e] + sd[half][e];
            sv[e] = jj <= t ? cb * exp_ftz(ct - cjj) * djj : 0.f;
          }
          split_bf16(sv[0], sv[1], ahi[2 * half], alo[2 * half]);
          split_bf16(sv[2], sv[3], ahi[2 * half + 1], alo[2 * half + 1]);
        }
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          mma_bf16(yacc[2 * dp], ahi, bx[dp][0], bx[dp][1]);
          mma_bf16(yacc[2 * dp + 1], ahi, bx[dp][2], bx[dp][3]);
          mma_bf16(yacc[2 * dp], alo, bx[dp][0], bx[dp][1]);
          mma_bf16(yacc[2 * dp + 1], alo, bx[dp][2], bx[dp][3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + 8 * half;
        if (t >= L) continue;
        __nv_bfloat16* yrow = y + ((tok + t) * H + h) * P + 2 * c;
#pragma unroll
        for (int pn = 0; pn < kNT; ++pn)
          *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * pn) =
              __floats2bfloat162_rn(yacc[pn][2 * half],
                                    yacc[pn][2 * half + 1]);
      }
    }

    // state warps, meanwhile: h = exp(cum_L) h + (B w)^T x in the
    // accumulators
    const float decay = expf(cum_s[Lp - 1]);
#pragma unroll
    for (int r = 0; r < kMR; ++r) {
      const int mt = sw + kStateWarps * r;
      if (sw < 0 || mt >= NK) continue;
#pragma unroll
      for (int pn = 0; pn < kNT; ++pn)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[r][pn][e] *= decay;
#pragma unroll 1
      for (int jk = 0; jk < n_rt; ++jk) {
        uint32_t ab[4], ahi[4], alo[4], bx[P / 16][4];
        ldmatrix_x4_trans(ab, bs_a + 2 * ((16 * jk + (mi >> 1) * 8 + mj) *
                                              ldn + 16 * mt + (mi & 1) * 8));
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp)
          ldmatrix_x4_trans(bx[dp], x_frag(jk, dp));
        const float2 w0 =
            *reinterpret_cast<const float2*>(wgt_s + 16 * jk + 2 * c);
        const float2 w1 =
            *reinterpret_cast<const float2*>(wgt_s + 16 * jk + 8 + 2 * c);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = unpack_bf16(ab[q]);
          const float2 w = q < 2 ? w0 : w1;
          split_bf16(f.x * w.x, f.y * w.y, ahi[q], alo[q]);
        }
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          mma_bf16(hacc[r][2 * dp], ahi, bx[dp][0], bx[dp][1]);
          mma_bf16(hacc[r][2 * dp + 1], ahi, bx[dp][2], bx[dp][3]);
          mma_bf16(hacc[r][2 * dp], alo, bx[dp][0], bx[dp][1]);
          mma_bf16(hacc[r][2 * dp + 1], alo, bx[dp][2], bx[dp][3]);
        }
      }
    }
    if (sw >= 0 && next) {  // chunk ci + 1's copies landed: scan them
      cp_async_wait<0>();
      if (sw == 0) scan(s ^ 1);
    }
    if (!next) break;
    __syncthreads();  // reads of stage s and of h are done; chunk ci + 1's
                      // copies, cum and w are visible
    store_state();
    __syncthreads();  // h is visible
  }

#pragma unroll
  for (int r = 0; r < kMR; ++r) {
    const int mt = sw + kStateWarps * r;
    if (sw < 0 || mt >= NK) continue;
#pragma unroll
    for (int pn = 0; pn < kNT; ++pn)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 16 * mt + g + 8 * half;
        *reinterpret_cast<float2*>(h_out + hbase + n * P + 8 * pn +
                                   2 * c) =
            make_float2(hacc[r][pn][2 * half], hacc[r][pn][2 * half + 1]);
      }
  }
}

int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* h0, void* y, void* h_out, int B,
               int T_, int H, int P, int N, int L, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, P, L);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), T_, H, P, N, L);
  return (int)cudaGetLastError();
}

template <int P, int kMaxNK>
int launch_mma(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* h0, void* y, void* h_out, int B,
               int T_, int H, int N, int L, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(N, P, L);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_mma_kernel<P, kMaxNK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_mma_kernel<P, kMaxNK><<<dim3(H, B), kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(h0),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(h_out), T_, H, N,
      L);
  return (int)cudaGetLastError();
}

template <int kMaxNK>
int launch_mma_p(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* h0, void* y, void* h_out, int B,
                 int T_, int H, int P, int N, int L, cudaStream_t s) {
  if (P == 16)
    return launch_mma<16, kMaxNK>(x, dt, A, Bm, Cm, h0, y, h_out, B, T_, H,
                                  N, L, s);
  if (P == 32)
    return launch_mma<32, kMaxNK>(x, dt, A, Bm, Cm, h0, y, h_out, B, T_, H,
                                  N, L, s);
  if (P == 64)
    return launch_mma<64, kMaxNK>(x, dt, A, Bm, Cm, h0, y, h_out, B, T_, H,
                                  N, L, s);
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype of x/B/C/y: 0 = float32, 1 = bfloat16.  h0 may be null (zeros).
extern "C" int ssd_forward(int dtype, const void* x, const void* dt,
                           const void* A, const void* Bm, const void* Cm,
                           const void* h0, void* y, void* h_out, int B,
                           int T_, int H, int P, int N, int L, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || P <= 0 || N <= 0 || L <= 0 ||
      L > kMaxChunk || T_ <= 0 || T_ % L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(x, dt, A, Bm, Cm, h0, y, h_out, B, T_, H, P, N, L, s);
  if (dtype != 1 || N % 16 || N > 128 || !aligned16(x) || !aligned16(Bm) ||
      !aligned16(Cm))
    return (int)cudaErrorInvalidValue;
  if (N <= 64)
    return launch_mma_p<4>(x, dt, A, Bm, Cm, h0, y, h_out, B, T_, H, P, N, L,
                           s);
  return launch_mma_p<8>(x, dt, A, Bm, Cm, h0, y, h_out, B, T_, H, P, N, L,
                         s);
}
