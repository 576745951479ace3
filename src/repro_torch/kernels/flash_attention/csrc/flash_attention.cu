// Causal flash attention for Hopper (sm_90a): the forward of GQA
// self-attention over a full sequence, with the row logsumexp.
//
// Replaces the TPU kernel `flash_attention_bhsd` / `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:70, body :25) and its wrapper
// (ops.py:12-28), which repeats K/V to the query heads and folds heads into
// the batch.  It computes what that kernel computes, not how: the TPU walks
// the KV blocks as the sequential third grid axis with the online-softmax
// state in VMEM scratch; here one CUDA block owns a query tile of one query
// head of one sequence and loops over K/V tiles from the diagonal down to
// the first, with the state (running max, sum and the [rows, D]
// accumulator) in float32 registers.
//
// Layout: q [B,S,Hq,D], k/v [B,S,Hkv,D] and out [B,S,Hq,D] are read and
// written in place through their (batch, seq, head) strides, D contiguous;
// query head h reads kv head h / G.  Nothing is repeated or transposed.
// lse [B,Hq,S] float32 is written beside the output for the backward.
//
// Semantics (held against ref.attention_fwd_ref): scores in float32 with
// scale 1/sqrt(D); keys after the query, and keys past S, get zero weight,
// exactly what the reference's -1e30 mask gives them (every row of the
// first tile a block processes, the diagonal one, holds a valid key, so the
// running max is finite from then on); out = acc / max(l, 1e-30);
// lse = m + log(l).  S need not be a multiple of any tile.
//
// Bound: at the llama3.2-3b training shape (B 2, S 2048, Hq 24, Hkv 8,
// D 128, bf16) the causal work is 4 * B * Hq * D * S(S+1)/2 = 51.6 GFLOP,
// 0.052 ms at 989 TFLOP/s dense bf16; the bytes (q, k, v, out, lse) are
// about 67 MB, 0.020 ms at 3.35 TB/s.  It is bound by operations, so the
// bfloat16 body is built to keep the tensor cores fed:
//
// * One block (384 threads) owns 128 query rows: two consumer warpgroups of
//   64 rows each and one producer warpgroup.  `setmaxnreg` moves registers
//   from the producer (24 a thread) to the consumers (240), which hold the
//   64 x 128 score tile and the 64 x D output tile as wgmma accumulators.
// * The producer's one thread copies tiles with TMA (4-D tensor maps over
//   the model layout, 128-byte swizzle): Q once, then K and V tiles of 128
//   keys into a 2-stage ring (64 keys, 3 stages at D 192).  Each stage has
//   a "full" mbarrier armed with the transaction bytes and an "empty" one
//   that the consumers release, K and V separately, so the next tiles load
//   while this one is multiplied.
// * S = Q K^T and O += P V are `wgmma` m64nNk16 (bf16 in, float32
//   accumulators).  Q and K are read K-major from shared memory through
//   descriptors; P stays in registers, the score accumulators converted to
//   bf16 in place; V is read MN-major through the descriptor's transpose
//   bit, so nothing is transposed in memory.
// * The online softmax runs on the accumulator fragments: row max and sum
//   over the four lanes of a quad, ex2.approx with scale * log2(e) folded
//   in.  Only the first tile (the diagonal, which also holds any keys past
//   S) is masked; tiles above the diagonal are never loaded.
// * The softmax is kept off the tensor cores' critical path twice over: a
//   warpgroup starts S_i = Q K_i^T together with O += P_{i-1} V_{i-1} and
//   runs the softmax of S_i while the second product runs; and the two
//   warpgroups take turns to start them (two named barriers), so one's products
//   run during the other's softmax (FlashAttention-3's schedule).
// * The output is scaled, rounded to bf16, written swizzled into the Q
//   tile's shared memory and stored with one TMA store per 64 columns,
//   which drops the rows past S and the columns past D.
// * Blocks are launched heaviest first (the last query tiles walk the most
//   keys), query heads of one kv head side by side so K/V stay in L2.
//
// head_dim: D in {8, 16, 32, 64, 80, 128, 192}.  A 128-byte swizzle caps a
// TMA box at 64 bf16 columns, so tiles are 64-column slabs: D 8 to 64 load
// one, D 80 and 128 two, D 192 (nemotron-4-340b) three.  D 8, 16, 32 and
// 80 are padded to the slab by TMA's zero fill past the tensor map's D
// extent, so one body serves all seven: Q K^T takes only ceil(D/16)
// k-steps (one for D 8, whose second half of the k-step is that zero
// fill), P V runs at the padded width (64, 128 or 192) and the padded
// columns are never stored.  D 8 is TMA's edge case: its head stride, 8
// bf16, is exactly the 16 bytes every stride but D's must be a multiple
// of.  At D 192 a 2-stage ring of 128-key tiles would need 240 KiB of
// shared memory, and the 64 x 128 score tile beside the 64 x 192 output
// would crowd the consumers' 240 registers: its K/V tiles hold 64 keys in
// a 3-stage ring (`Bf16Layout`), so a 128-row query tile's diagonal spans
// two key tiles, and warpgroup 0, whose rows all precede the second,
// skips it (a turn that starts no product).
//
// What this design still leaves: no persistent blocks (each block does one
// tile, so a block's prologue and epilogue are not hidden behind another
// tile's products and the last wave runs part-empty), the wasted upper
// half of each diagonal tile, and no fp8.
//
// float32 inputs stay true float32 on the CUDA cores (256 threads, 64-row
// query tiles, 8 rows a warp, one lane per key for the scores and
// ceil(D/32) output columns a lane for P V): wgmma in float32 would be
// TF32, and the kernel must agree with the plain version to ~1e-6.
//
// The wrapper checks what TMA needs (base 16-byte aligned, every stride but
// D's a multiple of 16 bytes, D contiguous).  The C entry point returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for an
// unsupported shape or a tensor map the CUDA driver refuses); the Python
// wrapper raises on any non-zero value.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at
                   // run time, so the library needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  long long q_sb, q_ss, q_sh;  // element strides: batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, Hq, Hkv;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;  // query rows (and keys a tile) per block
constexpr int kF32Threads = 256;
constexpr int kF32WarpRows = kF32Rows / (kF32Threads / 32);  // 8 a warp

template <int D>
constexpr int f32_smem_bytes() {
  // q [64][D], k [64][D+1] (padded: lane j reads row j), v [64][D], p [64][64]
  return (kF32Rows * D + kF32Rows * (D + 1) + kF32Rows * D +
          kF32Rows * kF32Rows) *
         (int)sizeof(float);
}

// Rows [row0, row0 + 64) of a [S, D] slice at `base` with sequence stride
// `ss` into `dst` with row stride `dst_stride`; rows at or past S are
// zero-filled.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, int dst_stride,
                                          const float* base, long long ss,
                                          int row0, int S) {
  for (int c = threadIdx.x; c < kF32Rows * D; c += blockDim.x) {
    const int r = c / D;
    const int e = c - r * D;
    const int row = row0 + r;
    dst[r * dst_stride + e] = row < S ? base[(long long)row * ss + e] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const Params p) {
  // lane owns output columns lane + 32 e (those below D)
  constexpr int kPer = (D + 31) / 32;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kF32Rows * D;
  float* v_s = k_s + kF32Rows * (D + 1);
  float* p_s = v_s + kF32Rows * D;

  // heaviest (last) query tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * kF32Rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int S = p.S;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  stage_f32<D>(q_s, D, qb, p.q_ss, q0, S);

  float m[kF32WarpRows], l[kF32WarpRows], acc[kF32WarpRows][kPer];
#pragma unroll
  for (int i = 0; i < kF32WarpRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[i][e] = 0.f;
  }
  const int r0 = warp * kF32WarpRows;  // this warp's first row in the tile
  float* pw = p_s + r0 * kF32Rows;

  for (int t = 0; t <= qt; ++t) {
    const int t0 = t * kF32Rows;
    __syncthreads();  // previous tile fully read (and q_s staged)
    stage_f32<D>(k_s, D + 1, kb, p.k_ss, t0, S);
    stage_f32<D>(v_s, D, vb, p.v_ss, t0, S);
    __syncthreads();

    // scores: lane owns keys t0 + lane and t0 + lane + 32
    float s[kF32WarpRows][2];
#pragma unroll
    for (int i = 0; i < kF32WarpRows; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k0 = k_s + lane * (D + 1);
    const float* k1 = k_s + (lane + 32) * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float a = k0[d], c = k1[d];
#pragma unroll
      for (int i = 0; i < kF32WarpRows; ++i) {
        const float qv = q_s[(r0 + i) * D + d];
        s[i][0] = fmaf(qv, a, s[i][0]);
        s[i][1] = fmaf(qv, c, s[i][1]);
      }
    }

    // mask, online-softmax update, P into this warp's rows of p_s
    float alpha[kF32WarpRows];
#pragma unroll
    for (int i = 0; i < kF32WarpRows; ++i) {
      const int qpos = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = t0 + lane + 32 * j;
        s[i][j] = (kpos <= qpos && kpos < S) ? s[i][j] * p.scale : kNegInf;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float e0 = expf(s[i][0] - m_new);
      const float e1 = expf(s[i][1] - m_new);
      pw[i * kF32Rows + lane] = e0;
      pw[i * kF32Rows + lane + 32] = e1;
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + warp_sum(e0 + e1);
      m[i] = m_new;
    }
    __syncwarp();

    // acc[i][e] = acc * alpha + sum_j P[i][j] V[j][lane + 32 e]
#pragma unroll
    for (int i = 0; i < kF32WarpRows; ++i)
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[i][e] *= alpha[i];
    const int n_keys = min(kF32Rows, min(S, q0 + kF32Rows) - t0);
    for (int j = 0; j < n_keys; ++j) {
      float vv[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        vv[e] = lane + 32 * e < D ? v_s[j * D + lane + 32 * e] : 0.f;
#pragma unroll
      for (int i = 0; i < kF32WarpRows; ++i) {
        const float pij = pw[i * kF32Rows + j];
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[i][e] = fmaf(pij, vv[e], acc[i][e]);
      }
    }
  }

  float* ob = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < kF32WarpRows; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (lane + 32 * e < D)
        ob[(long long)qpos * p.o_ss + lane + 32 * e] = acc[i][e] * inv;
    if (lane == 0)
      p.lse[((long long)b * p.Hq + h) * S + qpos] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: TMA ring, wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kBM = 128;         // query rows per block (two warpgroups)
constexpr int kThreads = 384;    // two consumer warpgroups + one producer
constexpr int kQSlabBytes = kBM * 128;  // 128 rows x 64 bf16 columns
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 = 64 K registers

// The bf16 body's tiles for head_dim D: the width padded to whole 64-column
// slabs, the keys of a K/V tile and the ring's depth.  D up to 128 keeps
// tiles of 128 keys in a 2-stage ring (its layout before D 192 was added).
// D 192 (three slabs) would need 240 KiB of shared memory so, over the
// 227 KiB a block may use; it takes tiles of 64 keys in a 3-stage ring
// (Q 48 KiB, K and V 72 KiB each), and its 64 x 64 score tile leaves the
// consumers' 240 registers room for the 64 x 192 output accumulator.
// Shared memory: Q [slabs][128][64], then the K ring and the V ring, each
// [stages][slabs][kBN][64], every slab 128-byte swizzled by TMA and
// 1024-byte aligned; then the mbarriers.
template <int D>
struct Bf16Layout {
  static constexpr int kDp = D <= 64 ? 64 : D <= 128 ? 128 : 192;
  static constexpr int kSlabs = kDp / 64;
  static constexpr int kBN = D <= 128 ? 128 : 64;  // keys a K/V tile
  static constexpr int kStages = D <= 128 ? 2 : 3;  // K/V ring depth
  static_assert(kBM % kBN == 0, "a query tile's diagonal is whole key tiles");
  static constexpr int kKVSlabBytes = kBN * 128;
  static constexpr int kQBytes = kSlabs * kQSlabBytes;    // the Q tile
  static constexpr int kKVBytes = kSlabs * kKVSlabBytes;  // a K or V tile
  static constexpr int q = 0;
  static constexpr int k = kQBytes;
  static constexpr int v = k + kStages * kKVBytes;
  static constexpr int bars = v + kStages * kKVBytes;
  // q_full, k_full[stages], v_full[stages], k_empty[stages], v_empty[stages]
  static constexpr int bytes = bars + 8 * (1 + 4 * kStages) + 1024;  // + align
  static_assert(bytes <= 232448, "a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (dims D, H, S, B) into shared memory;
// completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int h, int s0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h),
      "r"(s0), "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int d0, int h, int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(d0), "r"(h), "r"(s0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (all >> 4), layout 1 (B128).
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Keep the compiler from moving accumulator accesses across a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x on the special-function unit; exps below 2^-126 flush to zero,
// which exp2f would instead take through a denormal rescale
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (+)= A B^T for a 64 x 128 tile: A [64][16] and B [128][16] both
// K-major in shared memory (descriptors); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same for a 64 x 64 tile (B [64][16]): the 64-key tiles of D 192.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B for a 64 x N tile (N = 64, 128 or 192): A [64][16] in registers
// (four bf16 pairs a thread, the accumulator layout), B [16][N] MN-major
// in shared memory (the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for this warpgroup's 64 rows and a tile of kBN keys:
// ceil(D/16) k-steps, each 32 bytes further into a 64-column slab (of 128
// Q rows, of kBN K rows).
template <int kKSteps, int kBN>
__device__ __forceinline__ void start_qk(float (&sc)[kBN / 2], uint32_t q_wg,
                                         uint32_t k_t) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = desc_b128(q_wg + (kk / 4) * kQSlabBytes + col, 16,
                                  1024);
    const uint64_t db = desc_b128(k_t + (kk / 4) * kBN * 128 + col, 16,
                                  1024);
    if constexpr (kBN == 128)
      wgmma_ss_n128(sc, da, db, kk > 0);
    else
      wgmma_ss_n64(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V: P from registers; V [kBN keys][64 N slab] read MN-major (the
// transposed descriptor), the next 64 columns one slab further (the
// leading byte offset).
template <int N, int kBN>
__device__ __forceinline__ void start_pv(float (&o)[N],
                                         const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t v_t) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBN / 16; ++j)
    wgmma_rs(o, pa[j], desc_b128(v_t + j * 16 * 128, kBN * 128, 1024));
  wgmma_commit();
}

// Named barriers over the two consumer warpgroups (256 threads): one
// warpgroup waits for its turn to start products, the other signals it.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Online softmax on the score fragments of rows g (c < 2) and g + 8: the
// row max over the quad, exp2 with scale * log2(e) folded in (in place),
// the thread's share of the row sums, and the rescale a of older tiles.
template <int kBN>
__device__ __forceinline__ void softmax_step(float (&sc)[kBN / 2], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& a0, float& a1,
                                             float sl2) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
  a0 = ex2(m0 - mn0);
  a1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], sl2, -mn0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], sl2, -mn0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], sl2, -mn1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], sl2, -mn1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// P in bf16 as the A fragments of P V: k-step j takes the accumulators of
// columns 16 j .. 16 j + 15, which the wgmma layouts line up in place.
template <int kBN>
__device__ __forceinline__ void pack_p(const float (&sc)[kBN / 2],
                                       uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    pa[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float a0, float a1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using L = Bf16Layout<D>;
  constexpr int kDp = L::kDp;
  constexpr int kSlabs = L::kSlabs;
  constexpr int kBN = L::kBN;
  constexpr int kStages = L::kStages;
  constexpr int kKSteps = (D + 15) / 16;  // k-steps of Q K^T
  // key tiles of the diagonal: with kBN 64 the first (keys q0 + 64 ..)
  // lies wholly above warpgroup 0's rows
  constexpr int kRatio = kBM / kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base + L::q, k_s = base + L::k, v_s = base + L::v;
  const uint32_t q_full = base + L::bars;
  const uint32_t k_full = q_full + 8;  // + 8 * stage, and so on
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  // heaviest (last) query tiles first; query heads of a kv head adjacent
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * kBM;
  const int n_tiles = (qt + 1) * kRatio;  // key tiles, the last walked first
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 256);
      mbar_init(v_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the K/V ring full (tile i of the walk is
    // key tile n_tiles - 1 - i, so the diagonal comes first)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      const int hk = h / (p.Hq / p.Hkv);
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < kSlabs; ++c)
        tma_load(q_s + c * kQSlabBytes, &tm_q, q_full, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;  // first pass free
        const int k0 = (n_tiles - 1 - i) * kBN;
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, L::kKVBytes);
        for (int c = 0; c < kSlabs; ++c)
          tma_load(k_s + s * L::kKVBytes + c * L::kKVSlabBytes, &tm_k,
                   k_full + 8 * s, 64 * c, hk, k0, b);
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, L::kKVBytes);
        for (int c = 0; c < kSlabs; ++c)
          tma_load(v_s + s * L::kKVBytes + c * L::kKVSlabBytes, &tm_v,
                   v_full + 8 * s, 64 * c, hk, k0, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int g = lane / 4;  // accumulator row group
    const int c4 = lane % 4;  // thread in the quad that shares a row
    const int row0 = wg * 64 + (tid / 32) * 16 + g;  // and row0 + 8
    const float sl2 = p.scale * 1.4426950408889634f;  // scale * log2(e)
    const uint32_t q_wg = q_s + wg * 64 * 128;

    float o[kDp / 2];
#pragma unroll
    for (int j = 0; j < kDp / 2; ++j) o[j] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;  // running max, in log2 units
    float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums
    float a0, a1;  // the rescale of O for the newest tile
    float sc[kBN / 2];  // scores, then exp2 in place
    uint32_t pa[kBN / 16][4];  // P of the previous tile, bf16 A fragments

    // The warpgroups take turns to start their products (named barriers 3
    // and 4; warpgroup 0 first), so one's wgmmas run while the other does
    // its softmax.  Each takes n_tiles + 1 turns.
    const int my_turn = 3 + wg, other_turn = 4 - wg;
    if (wg == 1) turn_pass(3);

    // this warpgroup's first tile is its diagonal: with kRatio 2,
    // warpgroup 0 skips key tile 2 qt + 1 (every key after its rows) in a
    // turn that starts nothing, and frees the tile's stage for the ring
    const int first = kRatio == 2 && wg == 0 ? 1 : 0;
    if (first) {
      turn_wait(my_turn);
      mbar_arrive(k_empty);
      mbar_arrive(v_empty);
      turn_pass(other_turn);
    }
    // the diagonal: keys after the row, and past S, masked
    mbar_wait(q_full, 0);
    mbar_wait(k_full + 8 * first, 0);
    turn_wait(my_turn);
    start_qk<kKSteps, kBN>(sc, q_wg, k_s + first * L::kKVBytes);
    turn_pass(other_turn);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty + 8 * first);
    const int kc0 = (n_tiles - 1 - first) * kBN - q0;  // its first key - q0
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = kc0 + 8 * j + 2 * c4 + (c & 1);
        const int row = row0 + (c & 2) * 4;
        if (col > row || q0 + col >= p.S) sc[4 * j + c] = kNegInf;
      }
    softmax_step<kBN>(sc, m0, m1, l0, l1, a0, a1, sl2);
    pack_p<kBN>(sc, pa);

    // tile i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} are started together;
    // the softmax of S_i runs while the tensor cores do P_{i-1} V_{i-1}
    for (int i = first + 1; i < n_tiles; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      mbar_wait(k_full + 8 * s, (i / kStages) & 1);
      mbar_wait(v_full + 8 * sp, ((i - 1) / kStages) & 1);
      turn_wait(my_turn);
      start_qk<kKSteps, kBN>(sc, q_wg, k_s + s * L::kKVBytes);
      start_pv<kDp / 2, kBN>(o, pa, v_s + sp * L::kKVBytes);
      turn_pass(other_turn);
      wgmma_wait<1>();  // S_i is in
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * s);
      softmax_step<kBN>(sc, m0, m1, l0, l1, a0, a1, sl2);
      wgmma_wait<0>();  // P_{i-1} V_{i-1} is in
      fence_regs(o);
      mbar_arrive(v_empty + 8 * sp);
      rescale(o, a0, a1);
      pack_p<kBN>(sc, pa);
    }
    const int last = n_tiles - 1;
    const int sl = last % kStages;
    mbar_wait(v_full + 8 * sl, (last / kStages) & 1);
    turn_wait(my_turn);
    start_pv<kDp / 2, kBN>(o, pa, v_s + sl * L::kKVBytes);
    if (wg == 0) turn_pass(other_turn);  // no turn follows warpgroup 1's
    wgmma_wait<0>();
    fence_regs(o);

    // epilogue: O / l in bf16 into this warpgroup's rows of the Q tile
    // (its last Q K^T has completed), swizzled as the TMA store reads it
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < kDp / 8; ++j) {
      // column 8 j + 2 c4 is 16-byte chunk j % 8 of slab j / 8; the
      // swizzle XORs the chunk with the row mod 8, which is g for both rows
      const uint32_t at = q_s + (j / 8) * kQSlabBytes + ((j % 8) ^ g) * 16 +
                          4 * c4;
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(at + row0 * 128),
                   "r"(pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0))
                   : "memory");
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(at + (row0 + 8) * 128),
                   "r"(pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1))
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    const int r0 = q0 + wg * 64;
    if (tid == 0 && r0 < p.S) {
      // rows past S and columns past D fall outside the map: not written
      for (int c = 0; c < kSlabs; ++c)
        tma_store(&tm_o, q_wg + c * kQSlabBytes, 64 * c, h, r0, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    if (c4 == 0) {
      float* lb = p.lse + ((long long)b * p.Hq + h) * p.S;
      const int qa = q0 + row0;
      if (qa < p.S) lb[qa] = m0 * 0.6931471805599453f + logf(l0);
      if (qa + 8 < p.S) lb[qa + 8] = m1 * 0.6931471805599453f + logf(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, fetched once through the
// runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A bf16 [B, S, H, D] tensor with element strides st = (batch, seq, head),
// D contiguous, as a 4-D tensor map over (D, H, S, B) whose box is 64
// columns of `rows` rows of one head, 128-byte swizzled; reads past an
// edge (D 32 and 80 padded to the slab, rows past S) come back zero.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
              const long long* st, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = f32_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.S + kF32Rows - 1) / kF32Rows, p.Hq, B);
  flash_fwd_f32<D><<<grid, kF32Threads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Params& p, int B, const long long* st,
                cudaStream_t stream) {
  constexpr int bytes = Bf16Layout<D>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, p.q, B, p.S, p.Hq, D, st, kBM) ||
      !make_map(&tk, p.k, B, p.S, p.Hkv, D, st + 3, Bf16Layout<D>::kBN) ||
      !make_map(&tv, p.v, B, p.S, p.Hkv, D, st + 6, Bf16Layout<D>::kBN) ||
      !make_map(&to, p.out, B, p.S, p.Hq, D, st + 9, 64))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.Hq, B, (p.S + kBM - 1) / kBM);
  flash_fwd_bf16<D><<<grid, kThreads, bytes, stream>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, seq,
// head) for q, k, v and out in turn; D is contiguous.  lse is [B, Hq, S]
// float32, contiguous.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B,
                                   int S, int Hq, int Hkv, int D,
                                   const long long* strides, float scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || B > 65535 ||
      Hq > 65535 || (S + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 8: return launch_f32<8>(p, B, s);
      case 16: return launch_f32<16>(p, B, s);
      case 32: return launch_f32<32>(p, B, s);
      case 64: return launch_f32<64>(p, B, s);
      case 80: return launch_f32<80>(p, B, s);
      case 128: return launch_f32<128>(p, B, s);
      case 192: return launch_f32<192>(p, B, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 8: return launch_bf16<8>(p, B, strides, s);
      case 16: return launch_bf16<16>(p, B, strides, s);
      case 32: return launch_bf16<32>(p, B, strides, s);
      case 64: return launch_bf16<64>(p, B, strides, s);
      case 80: return launch_bf16<80>(p, B, strides, s);
      case 128: return launch_bf16<128>(p, B, strides, s);
      case 192: return launch_bf16<192>(p, B, strides, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
