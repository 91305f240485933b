// RMSNorm forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the TPU kernel dlrover_tpu/ops/fused.py:_rms_fwd_kernel
// (launched by _rms_fwd_pallas): rstd = 1/sqrt(mean(x^2) + eps) in fp32,
// y = (x * rstd * w_f32) cast once to x's type, and rstd written beside y.
// The weight has its own type (fp32 or bf16): training keeps fp32 master
// weights beside bf16 activations, and the weight is read in its own
// precision, never rounded to x's type.
//
// What bounds it on the card: bytes.  Each row of D values is read once
// for the sum of squares and once more for the scale (the second read
// hits L1/L2: a row is at most a few KB), w is shared by every row.  At
// about one multiply-add per byte it sits far below the H100's ridge of
// ~295 operations per byte, so the only thing that matters is moving
// x, w and y once.
//
// Design: one thread block per row, so any N >= 1 works (decode runs
// N = max_slots rows) and any D (the loop strides over it).  Each thread
// sums squares over a strided slice in fp32, a warp-shuffle reduction
// folds the 32 lanes and one warp folds the per-warp sums.  The weight
// multiply happens in fp32 with a single final cast, the rounding of
// the plain version (rms_norm_plain in ops/fused.py).
//
// C interface (ctypes): returns cudaGetLastError() after the launch.
// The caller allocates y and rstd; the kernel launches on `stream` and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rms_norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        T* __restrict__ y, float* __restrict__ rstd, int d,
                        float eps) {
  __shared__ float warp_sums[kWarps];
  __shared__ float row_rstd;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? warp_sums[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) {
      const float r = 1.0f / sqrtf(v / static_cast<float>(d) + eps);
      row_rstd = r;
      rstd[row] = r;
    }
  }
  __syncthreads();
  const float r = row_rstd;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    yr[i] = from_f<T>(to_f(xr[i]) * r * to_f(w[i]));
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* y, void* rstd, int n, int d,
           float eps, cudaStream_t stream) {
  rms_norm_fwd_kernel<T, W><<<n, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      static_cast<float*>(rstd), d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_w(const void* x, const void* w, void* y, void* rstd, int n, int d,
             float eps, int w_dtype, cudaStream_t stream) {
  if (w_dtype == 0) return launch<T, float>(x, w, y, rstd, n, d, eps, stream);
  if (w_dtype == 1) {
    return launch<T, __nv_bfloat16>(x, w, y, rstd, n, d, eps, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype (x and y) and w_dtype (the weight): 0 = float32, 1 = bfloat16;
// rstd is fp32.
int dl_rms_norm_fwd(const void* x, const void* w, void* y, void* rstd, int n,
                    int d, float eps, int dtype, int w_dtype, void* stream) {
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_w<float>(x, w, y, rstd, n, d, eps, w_dtype, s);
  if (dtype == 1) {
    return launch_w<__nv_bfloat16>(x, w, y, rstd, n, d, eps, w_dtype, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
