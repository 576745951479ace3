// Chunked WKV6 (RWKV6 "Finch" time-mix core) for Hopper (sm_90a).
//
// Replaces the TPU kernel `wkv_bhtc` / `_wkv_kernel`
// (src/repro/kernels/rwkv6/kernel.py:60, body :22).  It computes what that
// kernel computes, not how: the TPU runs the chunks as the sequential third
// grid axis (B, H, n_chunks) with the [hd, hd] state in VMEM scratch; here
// one CUDA block owns a (sequence b, head h) pair and loops over the chunks
// in order, carrying the state in float32 shared memory.  Beyond the TPU
// kernel it starts from an optional state s0 and writes the final state,
// which is what the model's `wkv_chunked` returns and the prefill stores.
//
// Per chunk of L tokens (r, k, v, lw staged in shared memory as float32):
//   cum[t]  = sum_{s <= t} lw[s]            (per channel, decreasing)
//   A[t][j] = sum_a r[t,a] k[j,a] exp(cum[t-1,a] - cum[j,a])   for j < t
//   A[t][t] = sum_a r[t,a] u[a] k[t,a]                         (the bonus)
//   y[t]    = sum_{j <= t} A[t][j] v[j] + (r[t] * exp(cum[t-1])) . S
//   S'      = exp(cum[L-1]) * S + sum_j (k[j] * exp(cum[L-1] - cum[j])) v[j]^T
// Every exp argument is a difference of a decreasing cumulative log-decay,
// so it is <= 0, as in the reference; all arithmetic is float32.
//
// Bound: per token and head the work is ~7 L hd (pairwise term with its
// exp, the y sums) + 4 hd^2 (state term and update) operations against
// 4 hd inputs and hd outputs, so at hd 64, L 32 with bf16 r/k/v it does ~40
// operations a byte: on an H100 (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
// float32, 3.35 TB/s) it is bytes-bound at the tensor-core rate and
// operation-bound at the float32 rate.  This first version stays on CUDA cores in float32
// (the reference's tolerance is 1e-4 relative) and keeps every operand of a
// chunk in shared memory, rows padded by one float so that the column walks
// of the pairwise term hit distinct banks.  Known limits, left for later
// work: the grid (H, B) has only B * H blocks (32 at B 1 for rwkv6-1.6b),
// under a third of the 132 SMs; the pairwise exps are recomputed per (t, j)
// pair; no tensor cores.
//
// Supported: r/k/v/y float32 or bfloat16, lw/u/s0/s_out float32, all
// contiguous; T a multiple of L (the wrapper pads); the shared memory
// (hd^2 + 4 L (hd + 1) + L^2 floats) within 227 KB.  The C entry point
// returns cudaGetLastError() after the launch (or cudaErrorInvalidValue);
// the Python wrapper raises on any non-zero value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

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

size_t smem_bytes(int hd, int L) {
  return sizeof(float) *
         ((size_t)hd * hd + 4 * (size_t)L * (hd + 1) + (size_t)L * L);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u,   // [H, hd]
            const float* __restrict__ s0,  // [B, H, hd, hd] or null
            T* __restrict__ y, float* __restrict__ s_out, int T_, int H,
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
      rs[t * ld + a] = to_float(r[off]);
      ks[t * ld + a] = to_float(k[off]);
      vs[t * ld + a] = to_float(v[off]);
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
      y[base + (size_t)(c0 + t) * row + c] = from_float<T>(acc);
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

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* y, void* s_out, int B, int T_,
           int H, int hd, int L, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, L);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), T_, H, hd, L);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of r/k/v/y: 0 = float32, 1 = bfloat16.  s0 may be null (zeros).
extern "C" int wkv6_forward(int dtype, const void* r, const void* k,
                            const void* v, const void* lw, const void* u,
                            const void* s0, void* y, void* s_out, int B,
                            int T_, int H, int hd, int L, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || hd <= 0 || L <= 0 || T_ <= 0 ||
      T_ % L || smem_bytes(hd, L) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, lw, u, s0, y, s_out, B, T_, H, hd, L, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, s_out, B, T_, H, hd,
                                 L, s);
  return (int)cudaErrorInvalidValue;
}
