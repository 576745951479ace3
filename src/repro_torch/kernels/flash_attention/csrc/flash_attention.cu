// Causal flash attention for Hopper (sm_90a): the forward of GQA
// self-attention over a full sequence, with the row logsumexp.
//
// Replaces the TPU kernel `flash_attention_bhsd` / `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:70, body :25) and its wrapper
// (ops.py:12-28), which repeats K/V to the query heads and folds heads into
// the batch.  It computes what that kernel computes, not how: the TPU walks
// the KV blocks as the sequential third grid axis with the online-softmax
// state in VMEM scratch; here one CUDA block owns a 64-row query tile of one
// query head of one sequence and loops over 64-row K/V tiles, staged in
// shared memory, from the first up to the diagonal.  The state (running max,
// sum and the [rows, D] accumulator) stays in float32 registers.
//
// Layout: q [B,S,Hq,D], k/v [B,S,Hkv,D] and out [B,S,Hq,D] are read and
// written in place through their (batch, seq, head) strides, D contiguous;
// query head h reads kv head h / G.  Nothing is repeated or transposed.
// lse [B,Hq,S] float32 is written beside the output for the backward.
//
// Semantics (held against ref.attention_fwd_ref): scores in float32 with
// scale 1/sqrt(D); keys after the query, and rows past S in the ragged last
// tile, are skipped or masked, which adds exactly the zeros that the
// reference's -1e30 mask adds (every processed tile holds at least one valid
// key for every row, so the running max is finite after the first tile);
// out = acc / max(l, 1e-30); lse = m + log(l).  S need not be a multiple of
// any tile.
//
// Two bodies:
// * float32 inputs stay true float32 on the CUDA cores (256 threads, 8
//   query rows a warp, one lane per key for the scores and per output
//   column for P.V), so the kernel agrees with the plain version to ~1e-6.
// * bfloat16 inputs use the tensor cores through mma.sync m16n8k16 with
//   float32 accumulators (128 threads, 16 query rows a warp): Q stays in
//   registers as A fragments, S = Q K^T and O += P V run as warp-level
//   products, and P is re-packed from the score accumulators into A
//   fragments without touching shared memory (the FlashAttention-2 scheme).
//   Shared-memory rows are padded by 8 elements so the fragment loads are
//   free of bank conflicts.
//
// Bound: at the llama3.2-3b training shape (B 2, S 2048, Hq 24, Hkv 8,
// D 128, bf16) the kernel must do 4 * B * Hq * D * S(S+1)/2 = 51.6 GFLOP
// (0.052 ms at 989 TFLOP/s dense bf16) and move ~67 MB (0.020 ms at
// 3.35 TB/s): it is bound by operations.  What this first version leaves
// for later work: K/V loads are not overlapped with the math (no cp.async
// or TMA ring), the products are mma.sync and not wgmma, and the V operand
// is gathered with 16-bit loads instead of ldmatrix.trans.
//
// Supported: float32 and bfloat16, D in {32, 64, 128}, Hq % Hkv == 0,
// rows 16-byte aligned (the wrapper checks).  The C entry point returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for an
// unsupported shape); the Python wrapper raises on any non-zero value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per CUDA block
constexpr int kBlockN = 64;  // keys per staged K/V tile
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

constexpr int kF32Threads = 256;
constexpr int kF32Rows = kBlockM / (kF32Threads / 32);  // 8 query rows a warp

template <int D>
constexpr int f32_smem_bytes() {
  // q [64][D], k [64][D+1] (padded: lane j reads row j), v [64][D], p [64][64]
  return (kBlockM * D + kBlockN * (D + 1) + kBlockN * D + kBlockM * kBlockN) *
         (int)sizeof(float);
}

// Rows [row0, row0 + 64) of a [S, D] slice at `base` with sequence stride
// `ss`, converted to float32, into `dst` with row stride `dst_stride`;
// rows at or past S are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage_f32(float* dst, int dst_stride,
                                          const T* base, long long ss,
                                          int row0, int S) {
  for (int c = threadIdx.x; c < kBlockN * D; c += blockDim.x) {
    const int r = c / D;
    const int e = c - r * D;
    const int row = row0 + r;
    dst[r * dst_stride + e] =
        row < S ? to_float(base[(long long)row * ss + e]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const Params p) {
  constexpr int kPer = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlockM * D;
  float* v_s = k_s + kBlockN * (D + 1);
  float* p_s = v_s + kBlockN * D;

  // heaviest (last) query tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * kBlockM;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int S = p.S;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  stage_f32<T, D>(q_s, D, qb, p.q_ss, q0, S);

  float m[kF32Rows], l[kF32Rows], acc[kF32Rows][kPer];
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[i][e] = 0.f;
  }
  const int r0 = warp * kF32Rows;  // this warp's first row in the tile
  float* pw = p_s + r0 * kBlockN;

  for (int t = 0; t <= qt; ++t) {
    const int t0 = t * kBlockN;
    __syncthreads();  // previous tile fully read (and q_s staged)
    stage_f32<T, D>(k_s, D + 1, kb, p.k_ss, t0, S);
    stage_f32<T, D>(v_s, D, vb, p.v_ss, t0, S);
    __syncthreads();

    // scores: lane owns keys t0 + lane and t0 + lane + 32
    float s[kF32Rows][2];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k0 = k_s + lane * (D + 1);
    const float* k1 = k_s + (lane + 32) * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float a = k0[d], c = k1[d];
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        const float qv = q_s[(r0 + i) * D + d];
        s[i][0] = fmaf(qv, a, s[i][0]);
        s[i][1] = fmaf(qv, c, s[i][1]);
      }
    }

    // mask, online-softmax update, P into this warp's rows of p_s
    float alpha[kF32Rows];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const int qpos = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = t0 + lane + 32 * j;
        s[i][j] = (kpos <= qpos && kpos < S) ? s[i][j] * p.scale : kNegInf;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float e0 = expf(s[i][0] - m_new);
      const float e1 = expf(s[i][1] - m_new);
      pw[i * kBlockN + lane] = e0;
      pw[i * kBlockN + lane + 32] = e1;
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + warp_sum(e0 + e1);
      m[i] = m_new;
    }
    __syncwarp();

    // acc[i][d] = acc * alpha + sum_j P[i][j] V[j][d]; lane owns columns
    // lane + 32 e
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[i][e] *= alpha[i];
    const int n_keys = min(kBlockN, min(S, q0 + kBlockM) - t0);
    for (int j = 0; j < n_keys; ++j) {
      float vv[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) vv[e] = v_s[j * D + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        const float pij = pw[i * kBlockN + j];
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[i][e] = fmaf(pij, vv[e], acc[i][e]);
      }
    }
  }

  T* ob = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      ob[(long long)qpos * p.o_ss + lane + 32 * e] = (T)(acc[i][e] * inv);
    if (lane == 0)
      p.lse[((long long)b * p.Hq + h) * S + qpos] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulators)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a [S, D] bf16 slice into `dst` (row stride
// D + 8) with 16-byte loads; rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* base,
                                           long long ss, int row0, int S) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBlockN * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int e = (c - r * kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      val = *reinterpret_cast<const uint4*>(base + (long long)row * ss + e);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + e) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16(const Params p) {
  constexpr int kStride = D + 8;   // padded shared row (elements)
  constexpr int kK = D / 16;       // k-steps of Q K^T
  constexpr int kNT = kBlockN / 8; // score n-tiles per tile
  constexpr int kDT = D / 8;       // output n-tiles
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * kBlockM;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row group
  const int tq = lane & 3;  // thread in group
  const int S = p.S;

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Q tile through k_s into A fragments held for the whole loop
  stage_bf16<D>(k_s, qb, p.q_ss, q0, S);
  __syncthreads();
  uint32_t qa[kK][4];
  {
    const int ra = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const int col = kk * 16 + tq * 2;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(&k_s[ra * kStride + col]);
      qa[kk][1] =
          *reinterpret_cast<const uint32_t*>(&k_s[(ra + 8) * kStride + col]);
      qa[kk][2] =
          *reinterpret_cast<const uint32_t*>(&k_s[ra * kStride + col + 8]);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(
          &k_s[(ra + 8) * kStride + col + 8]);
    }
  }

  float oacc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // rows g and g + 8 of this warp
  float l0 = 0.f, l1 = 0.f;          // this thread's partial row sums
  const int qpos0 = q0 + warp * 16 + g;
  const int qpos1 = qpos0 + 8;
  const uint16_t* v16 = reinterpret_cast<const uint16_t*>(v_s);

  for (int t = 0; t <= qt; ++t) {
    const int t0 = t * kBlockN;
    __syncthreads();  // q fragments / previous tile fully read
    stage_bf16<D>(k_s, kb, p.k_ss, t0, S);
    stage_bf16<D>(v_s, vb, p.v_ss, t0, S);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sacc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (nt * 8 + g) * kStride + tq * 2;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(sacc[nt], qa[kk], b0, b1);
      }
    }

    // scale, mask, running max over the quad that shares a row
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = t0 + nt * 8 + tq * 2 + (c & 1);
        const int qpos = c < 2 ? qpos0 : qpos1;
        const float s = (kpos <= qpos && kpos < S) ? sacc[nt][c] * p.scale
                                                    : kNegInf;
        sacc[nt][c] = s;
      }
      mx0 = fmaxf(mx0, fmaxf(sacc[nt][0], sacc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[nt][2], sacc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      sacc[nt][0] = __expf(sacc[nt][0] - mn0);
      sacc[nt][1] = __expf(sacc[nt][1] - mn0);
      sacc[nt][2] = __expf(sacc[nt][2] - mn1);
      sacc[nt][3] = __expf(sacc[nt][3] - mn1);
      sum0 += sacc[nt][0] + sacc[nt][1];
      sum1 += sacc[nt][2] + sacc[nt][3];
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      oacc[dt][0] *= alpha0;
      oacc[dt][1] *= alpha0;
      oacc[dt][2] *= alpha1;
      oacc[dt][3] *= alpha1;
    }

    // O += P V: the score accumulators of n-tiles 2j, 2j+1 are the A
    // fragment of keys 16j..16j+15
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sacc[2 * j][0], sacc[2 * j][1]);
      pa[1] = pack_bf16(sacc[2 * j][2], sacc[2 * j][3]);
      pa[2] = pack_bf16(sacc[2 * j + 1][0], sacc[2 * j + 1][1]);
      pa[3] = pack_bf16(sacc[2 * j + 1][2], sacc[2 * j + 1][3]);
      const int key = j * 16 + tq * 2;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const int col = dt * 8 + g;
        const uint32_t b0 = (uint32_t)v16[key * kStride + col] |
                            ((uint32_t)v16[(key + 1) * kStride + col] << 16);
        const uint32_t b1 = (uint32_t)v16[(key + 8) * kStride + col] |
                            ((uint32_t)v16[(key + 9) * kStride + col] << 16);
        mma_bf16(oacc[dt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (qpos0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qpos0 * p.o_ss + col) =
          __floats2bfloat162_rn(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
    if (qpos1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qpos1 * p.o_ss + col) =
          __floats2bfloat162_rn(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
  }
  if (tq == 0) {
    float* lb = p.lse + ((long long)b * p.Hq + h) * S;
    if (qpos0 < S) lb[qpos0] = m0 + logf(l0);
    if (qpos1 < S) lb[qpos1] = m1 + logf(l1);
  }
}

template <int D>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = f32_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.S + kBlockM - 1) / kBlockM, p.Hq, B);
  flash_fwd_f32<float, D><<<grid, kF32Threads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid((p.S + kBlockM - 1) / kBlockM, p.Hq, B);
  flash_fwd_bf16<D><<<grid, kMmaThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; D is
// contiguous.  lse is [B, Hq, S] float32, contiguous.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B,
                                   int S, int Hq, int Hkv, int D,
                                   const long long* strides, float scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || B > 65535 ||
      Hq > 65535)
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
      case 32: return launch_f32<32>(p, B, s);
      case 64: return launch_f32<64>(p, B, s);
      case 128: return launch_f32<128>(p, B, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32>(p, B, s);
      case 64: return launch_bf16<64>(p, B, s);
      case 128: return launch_bf16<128>(p, B, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
