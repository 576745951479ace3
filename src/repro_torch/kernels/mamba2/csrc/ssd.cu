// Chunked Mamba2 SSD (state-space duality scan) for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_bthp` / `_ssd_kernel`
// (src/repro/kernels/mamba2/kernel.py:61, body :22).  It computes what that
// kernel computes, not how: the TPU runs the chunks as the sequential second
// grid axis (B, n_chunks) and holds the whole [H, N, P] state in VMEM
// scratch (zamba2-2.7b: 80 x 64 x 64 float32 = 1.3 MB, far over the 227 KB
// of shared memory a Hopper block may use).  The decay is a scalar per head,
// so the heads are independent: here one CUDA block owns a (sequence b,
// head h) pair, loops over the chunks in order and carries that head's
// [N, P] float32 state (16 KB at N = P = 64) in shared memory; every block
// recomputes the chunk's C.B^T, which all heads share.  Beyond the TPU
// kernel it starts from an optional state h0 and writes the final state,
// which is what the model's `ssd_chunked` returns and the prefill stores.
//
// Per chunk of L tokens (x, B, C staged in shared memory as float32):
//   cum[t]    = sum_{s <= t} dt[s] * A[h]            (decreasing)
//   sc[t][j]  = (C_t . B_j) * exp(cum[t] - cum[j]) * dt[j]     for j <= t
//   y[t]      = sum_{j <= t} sc[t][j] x[j] + exp(cum[t]) * C_t . h
//   h'        = exp(cum[L-1]) h + sum_j exp(cum[L-1] - cum[j]) dt[j] B_j x_j^T
// Every exp argument is <= 0, as in the reference; all arithmetic is
// float32 (the reference's `ssd_chunked` takes its einsums and carries the
// state in x's type, so at bf16 this kernel is the more exact of the two).
//
// Bound: per token and head the work is ~2 (L N + L P + 2 N P) operations
// against P inputs and P outputs of x/y (B, C and dt are shared by the
// heads), so at L 128, N = P = 64 with bf16 x it does ~190 operations a
// byte: on an H100 (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s float32,
// 3.35 TB/s) it is bytes-bound at the tensor-core rate and operation-bound
// at the float32 rate.  This first version stays on CUDA cores in float32
// and keeps every operand of a chunk in shared memory (180 KB at zamba2's
// shapes, so one block a SM), B rows padded by one float so that the column
// walks of the scores hit distinct banks.  Known limits, left for later
// work: the B * H blocks (80 at B 1) fill 80 of the 132 SMs, one block
// each; no tensor cores; the cumulative sum is one thread's loop.
//
// Supported: x/B/C/y float32 or bfloat16, dt/A/h0/h_out float32, all
// contiguous; T a multiple of L; L <= 128; the shared memory
// (N P + L P + 2 L (N + 1) + L^2 + 2 L floats) within 227 KB.  The C entry
// point returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue); the Python wrapper raises on any non-zero value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
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

size_t smem_bytes(int N, int P, int L) {
  return sizeof(float) * ((size_t)N * P + (size_t)L * P +
                          2 * (size_t)L * (N + 1) + (size_t)L * L +
                          2 * (size_t)L);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x,       // [B, T, H, P]
           const float* __restrict__ dt,  // [B, T, H]
           const float* __restrict__ A,   // [H]
           const T* __restrict__ Bm,      // [B, T, N]
           const T* __restrict__ Cm,      // [B, T, N]
           const float* __restrict__ h0,  // [B, H, N, P] or null
           T* __restrict__ y,             // [B, T, H, P]
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
      xs[i] = to_float(x[((tok + t) * H + h) * P + p]);
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      bs[t * ldn + n] = to_float(Bm[(tok + t) * N + n]);
      cs[t * ldn + n] = to_float(Cm[(tok + t) * N + n]);
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
      y[((tok + t) * H + h) * P + p] = from_float<T>(acc);
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

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* h0, void* y, void* h_out, int B,
           int T_, int H, int P, int N, int L, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, P, L);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_out), T_, H, P, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of x/B/C/y: 0 = float32, 1 = bfloat16.  h0 may be null (zeros).
extern "C" int ssd_forward(int dtype, const void* x, const void* dt,
                           const void* A, const void* Bm, const void* Cm,
                           const void* h0, void* y, void* h_out, int B,
                           int T_, int H, int P, int N, int L,
                           void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || P <= 0 || N <= 0 || L <= 0 ||
      L > kMaxChunk || T_ <= 0 || T_ % L ||
      smem_bytes(N, P, L) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, h0, y, h_out, B, T_, H, P, N, L,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, h_out, B, T_, H, P,
                                 N, L, s);
  return (int)cudaErrorInvalidValue;
}
