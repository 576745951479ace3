// Flash-decode for Hopper (sm_90a): one decode token of GQA attention per
// sequence, over a block-paged K/V store or over contiguous slot caches.
//
// Replaces the TPU kernels `paged_decode_attention_grouped` /
// `_paged_decode_kernel` (src/repro/kernels/decode_attention/kernel.py:147,
// body :108) and `decode_attention_grouped` / `_decode_kernel` (same file,
// :74, body :37).  It computes what those kernels compute, not how: the TPU
// walks the cache blocks as the sequential third grid axis with the
// online-softmax state in VMEM scratch; here one CUDA block owns a whole
// (sequence b, kv head h) pair and walks the sequence in tiles of kTile
// positions, keeping the running max, sum and the [G, D] accumulator of all
// G query heads of the group in float32 shared memory and registers.  The
// two variants share that tile loop and differ only in where row `pos` of
// sequence b lives (the `Rows` template argument):
//   * PagedRows: the block reads table[b, pos / block_size] itself (the TPU
//     scalar-prefetches it) to find the physical block; a row is D
//     contiguous elements, rows are Hkv * D apart;
//   * ContiguousRows: caches [B, S, Hkv, D]; row (b, pos) is plain
//     arithmetic.  No block table is built for this case.
//
// Per tile, all 128 threads first stage the tile's K and V rows of head h
// into shared memory with 16-byte loads, every load of the tile in flight at
// once; then the scores, the online-softmax update and the P.V accumulation
// read shared memory only.  Staging whole tiles instead of reading K/V row
// by row from global memory is what keeps the kernel from being bound by one
// load latency per row.
//
// Semantics (held against ref.decode_ref / ref.paged_decode_ref): scores in
// float32 with scale 1/sqrt(D); positions >= len are never read (the
// reference masks them with -1e30, whose exp underflows to exactly 0, so
// skipping them adds the same zeros); positions past the cache (S, or
// max_blocks * block_size) do not exist, so a length beyond the cache
// attends every position -- what the reference does when a full slot's
// length keeps growing; the output is acc / max(l, 1e-30).  len >= 1 is
// required (the engine always attends at least the token it just wrote).
// The arithmetic depends only on the logical sequence, so relocating
// physical blocks changes no bit.
//
// Bound: the kernel is bytes-bound.  Per layer call it must read
// sum_b min(len_b, S) * Hkv * D * 2 (K and V) * itemsize bytes, at 3.35 TB/s
// on an H100 SXM, and does about 4 * G flops per K/V element (G = 3 for
// llama3.2-3b, 1 for zamba2-2.7b), far below the card's compute rate.
//
// Known limits, left for later work: the grid (Hkv, B) has B * Hkv blocks,
// which under-fills the 132 SMs at small batch (8 x 8 = 64 blocks for
// llama3.2-3b at batch 8) -- a split-K pass over the sequence is the fix;
// a tile's loads are not overlapped with the previous tile's math (no
// cp.async/TMA double buffering).
//
// Supported: float32 and bfloat16 inputs, D in {32, 64, 80, 128}, G <= 8,
// block_size <= 64, K/V 16-byte aligned.  The C entry points return
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for an
// unsupported shape); the Python wrapper raises on any non-zero value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxBlockSize = 64;
constexpr int kTile = 32;  // sequence positions staged per iteration
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// Row addressing of a block-paged store [N, bs, Hkv, D] through tables
// [B, mb].
struct PagedRows {
  const int* tables;
  int bs, mb, Hkv;
  __device__ int n_pos(int len) const { return min(len, mb * bs); }
  __device__ size_t offset(int b, int pos, int h, int D) const {
    const int lb = pos / bs;
    const int phys = tables[(size_t)b * mb + lb];
    return (((size_t)phys * bs + (pos - lb * bs)) * Hkv + h) * D;
  }
};

// Row addressing of contiguous caches [B, S, Hkv, D].
struct ContiguousRows {
  int S, Hkv;
  __device__ int n_pos(int len) const { return min(len, S); }
  __device__ size_t offset(int b, int pos, int h, int D) const {
    return (((size_t)b * S + pos) * Hkv + h) * D;
  }
};

template <typename T, int D, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q,      // [B, Hkv, G, D]
              const T* __restrict__ k,      // rows addressed by Rows
              const T* __restrict__ v,
              const int* __restrict__ lens, // [B]
              T* __restrict__ out,          // [B, Hkv, G, D]
              Rows rows, int Hkv, int G, float scale) {
  constexpr int kPer = (D + 31) / 32;        // row elements each lane holds
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int kChunks = D / kVec;          // 16-byte loads per row
  constexpr int kAccPer = (kMaxG * D + kThreads - 1) / kThreads;
  static_assert(D % kVec == 0, "rows must split into 16-byte loads");
  __shared__ __align__(16) T k_s[kTile * D];
  __shared__ __align__(16) T v_s[kTile * D];
  __shared__ float q_s[kMaxG * D];
  __shared__ float p_s[kMaxG * kTile];  // scores, then probabilities
  __shared__ float m_s[kMaxG];
  __shared__ float l_s[kMaxG];
  __shared__ float alpha_s[kMaxG];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int GD = G * D;

  const T* qb = q + ((size_t)b * Hkv + h) * GD;
  for (int i = tid; i < GD; i += kThreads) q_s[i] = to_float(qb[i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAccPer];
#pragma unroll
  for (int i = 0; i < kAccPer; ++i) acc[i] = 0.f;
  __syncthreads();

  const int n_pos = rows.n_pos(lens[b]);

  for (int t0 = 0; t0 < n_pos; t0 += kTile) {
    const int n = min(kTile, n_pos - t0);  // valid rows of this tile

    // 1. stage the tile's K/V rows of head h: all loads in flight at once
    for (int c = tid; c < n * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int e = (c - r * kChunks) * kVec;
      const size_t off = rows.offset(b, t0 + r, h, D) + e;
      *reinterpret_cast<uint4*>(k_s + r * D + e) =
          *reinterpret_cast<const uint4*>(k + off);
      *reinterpret_cast<uint4*>(v_s + r * D + e) =
          *reinterpret_cast<const uint4*>(v + off);
    }
    __syncthreads();

    // 2. scores: one warp per K row, lanes split the row, all G heads
    for (int j = warp; j < n; j += kWarps) {
      float kf[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int d = e * 32 + lane;
        kf[e] = d < D ? to_float(k_s[j * D + d]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int d = e * 32 + lane;
          if (d < D) s += q_s[g * D + d] * kf[e];
        }
        s = warp_sum(s);
        if (lane == 0) p_s[g * kTile + j] = s * scale;
      }
    }
    __syncthreads();

    // 3. online-softmax update: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * kTile;
      const float s = lane < n ? pg[lane] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      if (lane < n) pg[lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc[g, d] = acc * alpha[g] + sum_j p[g, j] * V[j, d]
#pragma unroll
    for (int i = 0; i < kAccPer; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < GD) {
        const int g = idx / D;
        const int d = idx - g * D;
        const float* pg = p_s + g * kTile;
        float a = acc[i] * alpha_s[g];
        for (int j = 0; j < n; ++j) a += pg[j] * to_float(v_s[j * D + d]);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * Hkv + h) * GD;
#pragma unroll
  for (int i = 0; i < kAccPer; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < GD) {
      const int g = idx / D;
      ob[idx] = from_float<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, typename Rows>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* out, Rows rows, int B, int Hkv, int G, int D, float scale,
           cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  const dim3 block(kThreads);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lt = static_cast<const int*>(lens);
  T* ot = static_cast<T*>(out);
  switch (D) {
    case 32:
      decode_kernel<T, 32, Rows><<<grid, block, 0, stream>>>(
          qt, kt, vt, lt, ot, rows, Hkv, G, scale);
      break;
    case 64:
      decode_kernel<T, 64, Rows><<<grid, block, 0, stream>>>(
          qt, kt, vt, lt, ot, rows, Hkv, G, scale);
      break;
    case 80:
      decode_kernel<T, 80, Rows><<<grid, block, 0, stream>>>(
          qt, kt, vt, lt, ot, rows, Hkv, G, scale);
      break;
    case 128:
      decode_kernel<T, 128, Rows><<<grid, block, 0, stream>>>(
          qt, kt, vt, lt, ot, rows, Hkv, G, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Rows>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* lens, void* out, Rows rows, int B, int Hkv, int G,
             int D, float scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || G <= 0 || G > kMaxG)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lens, out, rows, B, Hkv, G, D, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lens, out, rows, B, Hkv, G, D,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Tables and lengths are int32.
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* tables,
                                      const void* lens, void* out, int B,
                                      int Hkv, int G, int D, int bs, int mb,
                                      float scale, void* stream) {
  if (bs <= 0 || bs > kMaxBlockSize || mb <= 0)
    return (int)cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(tables), bs, mb, Hkv};
  return dispatch(dtype, q, k, v, lens, out, rows, B, Hkv, G, D, scale,
                  stream);
}

// Contiguous caches [B, S, Hkv, D]; lengths int32 (clamped to S).
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* lens, void* out,
                                int B, int Hkv, int G, int D, int S,
                                float scale, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const ContiguousRows rows{S, Hkv};
  return dispatch(dtype, q, k, v, lens, out, rows, B, Hkv, G, D, scale,
                  stream);
}
