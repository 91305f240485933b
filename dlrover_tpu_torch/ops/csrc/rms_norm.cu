// RMSNorm for Hopper (sm_90a), fp32 and bf16: the forward, the forward
// with the residual add before it, and the backward.
//
// Replaces the TPU kernel dlrover_tpu/ops/fused.py:_rms_fwd_kernel
// (launched by _rms_fwd_pallas): rstd = 1/sqrt(mean(x^2) + eps) in fp32,
// y = (x * rstd * w_f32) cast once to x's type, rstd [N, 1] fp32 beside y.
// The weight has its own type (fp32 or bf16: training keeps fp32 master
// weights beside bf16 activations) and is read in its own precision.
//
// With `delta` (same shape and type as x) the forward first forms
// h = x + delta rounded to x's type, exactly as the unfused add in bf16
// does, writes h and normalises h.  Every norm of the Llama block follows
// a residual add, which so costs no launch of its own.
//
// The backward is that of dlrover_tpu/ops/fused.py:_rms_bwd (jnp in the
// reference, which XLA fuses; the port's counterpart of that fusion): per
// row xhat = x * rstd, dxhat = g * w, dot = sum(dxhat * xhat) / D,
// dx = rstd * (dxhat - xhat * dot) cast to x's type, and where the add was
// fused, g_res (the gradient that reaches h directly) added to it as the
// unfused graph adds two gradients of x's type.  dw = sum over rows of
// g * xhat: each CTA keeps fp32 sums for its own rows, a second small
// kernel adds the CTAs' sums in a fixed order and casts to w's type.  No
// atomics: the result is the same bit for bit on every run.
//
// What bounds it on the card: bytes (a few operations per byte, far
// below the H100's ridge of ~295).  So each tensor moves once, with
// 16-byte loads, and a row stays in registers from its sum of squares to
// its scaling:
// - the forward: one CTA per row, each thread holding its one or two
//   vectors of the row: 512 threads for a row of 4096 bf16 while the rows
//   are few (decode 16, verify 52, prefill 256: the time there is the
//   launch's, not that of the 16 KB that move), 256 when there are enough
//   rows to fill the card several times over (training, 8192 x 4096).
//   The weight comes from L1/L2 for each row: staging it once per CTA in
//   shared memory for a persistent grid of row groups ran slower, and so
//   did a cluster of CTAs per row adding their sums through distributed
//   shared memory (PERF.md);
// - the backward: a persistent grid, one CTA per row at a time, each
//   thread holding its columns' weight and dw sums in registers across its
//   rows.
// A row too long for registers takes a strided loop that reads it twice
// (the second read mostly hits L1/L2).  D not a multiple of the vector
// width, or a pointer not 16-byte aligned, takes the same kernels with
// scalar loads.
//
// C interface (ctypes): each entry returns cudaGetLastError() after its
// launches.  The caller allocates every output and the backward's fp32
// workspace; the kernels launch on `stream` and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

// The constants were chosen with scripts/torch_rms_norm_variants.py,
// which builds and times other values of them on the card.
// the forward: a CTA per row, each thread holding up to kRowVecs vectors
// of the row: kFewVecs while the rows are fewer than kManyRowsPerSm per
// SM, kManyVecs from there on (so 512 or 256 threads for a row of 4096
// bf16)
constexpr int kFewVecs = 1;
constexpr int kManyVecs = 2;
constexpr int kManyRowsPerSm = 8;
constexpr int kRowVecs = kFewVecs > kManyVecs ? kFewVecs : kManyVecs;
constexpr int kMaxThreads = 1024;
// the backward: kBwdThreads threads per CTA, each holding up to kBwdVecs
// vectors of a row, registers capped so that kBwdMinCtas CTAs (the
// wrapper's fused.BWD_CTAS_PER_SM) fit on an SM; the dw sum takes kDwCols
// columns per CTA in kDwGroups groups of consecutive CTA sums
constexpr int kBwdThreads = 256;
constexpr int kBwdVecs = 2;
constexpr int kBwdMinCtas = 2;
constexpr int kDwCols = 32;
constexpr int kDwGroups = 8;

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

template <typename S, int N>
struct alignas(sizeof(S) * N) Pack {
  S v[N];
};

// vector i (N values) of p
template <typename S, int N>
__device__ __forceinline__ Pack<S, N> ld(const S* p, int64_t i) {
  return reinterpret_cast<const Pack<S, N>*>(p)[i];
}
template <typename S, int N>
__device__ __forceinline__ void st(S* p, int64_t i, const Pack<S, N>& v) {
  reinterpret_cast<Pack<S, N>*>(p)[i] = v;
}

// vector i (N values) of p as fp32, in loads of at most 16 bytes
template <int N, typename S>
__device__ __forceinline__ void ld_f(const S* p, int64_t i, float (&out)[N]) {
  constexpr int kPer = N * sizeof(S) > 16 ? 16 / sizeof(S) : N;
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    const Pack<S, kPer> pk = ld<S, kPer>(p + i * N, c);
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[c * kPer + j] = to_f(pk.v[j]);
  }
}

// N fp32 values to vector i of p, in stores of at most 16 bytes
template <int N>
__device__ __forceinline__ void st_f(float* p, int64_t i,
                                     const float (&v)[N]) {
  constexpr int kPer = N > 4 ? 4 : N;
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    Pack<float, kPer> pk;
#pragma unroll
    for (int j = 0; j < kPer; ++j) pk.v[j] = v[c * kPer + j];
    st<float, kPer>(p + i * N, c, pk);
  }
}

// a + b rounded to T, as PyTorch's add of two T tensors rounds it
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> add_round(const Pack<T, N>& a,
                                                const Pack<T, N>& b) {
  Pack<T, N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    r.v[j] = from_f<T>(__fadd_rn(to_f(a.v[j]), to_f(b.v[j])));
  }
  return r;
}

template <typename T, int N>
__device__ __forceinline__ float squares(const Pack<T, N>& a) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float f = to_f(a.v[j]);
    s += f * f;
  }
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The sum of v over the block (blockDim.x a multiple of 32), in the same
// order on every run, returned to every thread.  `red` (32 floats) must
// not be written again before every thread has passed the next barrier.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  const int warps = blockDim.x >> 5;
  for (int i = 0; i < warps; ++i) s += red[i];
  return s;
}

__device__ __forceinline__ float rstd_of(float ss, int d, float eps) {
  return 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
}

// ------------------------------------------------------------ forward

// CTA b takes row b.
template <typename T, typename W, int VEC, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
    rms_row_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                   const W* __restrict__ w, T* __restrict__ h,
                   T* __restrict__ y, float* __restrict__ rstd, int d,
                   float eps) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const int64_t base = row * d;
  const int nvec = d / VEC;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool resident = nvec <= nt * kRowVecs;
  Pack<T, VEC> v[kRowVecs];
  float ss = 0.f;
  if (resident) {
#pragma unroll
    for (int k = 0; k < kRowVecs; ++k) {
      const int i = tid + k * nt;
      if (i < nvec) v[k] = ld<T, VEC>(x + base, i);
    }
#pragma unroll
    for (int k = 0; k < kRowVecs; ++k) {
      const int i = tid + k * nt;
      if (i < nvec) {
        if constexpr (ADD) {
          v[k] = add_round(v[k], ld<T, VEC>(delta + base, i));
          st<T, VEC>(h + base, i, v[k]);
        }
        ss += squares(v[k]);
      }
    }
  } else {
    for (int i = tid; i < nvec; i += nt) {
      Pack<T, VEC> t = ld<T, VEC>(x + base, i);
      if constexpr (ADD) {
        t = add_round(t, ld<T, VEC>(delta + base, i));
        st<T, VEC>(h + base, i, t);
      }
      ss += squares(t);
    }
  }
  const float r = rstd_of(block_sum(ss, red), d, eps);
  if (tid == 0) rstd[row] = r;
  auto scale = [&](int i, const Pack<T, VEC>& a) {
    float wf[VEC];
    ld_f<VEC>(w, i, wf);
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = from_f<T>(to_f(a.v[j]) * r * wf[j]);
    st<T, VEC>(y + base, i, o);
  };
  if (resident) {
#pragma unroll
    for (int k = 0; k < kRowVecs; ++k) {
      const int i = tid + k * nt;
      if (i < nvec) scale(i, v[k]);
    }
  } else {
    // the second read: h where this thread wrote it, else x
    for (int i = tid; i < nvec; i += nt) {
      scale(i, ADD ? ld<T, VEC>(h + base, i) : ld<T, VEC>(x + base, i));
    }
  }
}

int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <typename T, typename W, int VEC, bool ADD>
int launch_fwd(const void* x, const void* delta, const void* w, void* h,
               void* y, void* rstd, int n, int d, float eps,
               cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(delta);
  const W* wp = static_cast<const W*>(w);
  T* hp = static_cast<T*>(h);
  T* yp = static_cast<T*>(y);
  float* rp = static_cast<float*>(rstd);
  const int nvec = d / VEC;
  const int vecs = n >= kManyRowsPerSm * num_sms() ? kManyVecs : kFewVecs;
  int threads = ((nvec + vecs - 1) / vecs + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  rms_row_kernel<T, W, VEC, ADD><<<n, threads, 0, stream>>>(
      xp, dp, wp, hp, yp, rp, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- backward

// CTA b takes rows b, b + gridDim.x, ... and writes its fp32 sums of
// g * xhat over them to row b of `part` [gridDim.x, d].
template <typename T, typename W, int VEC, bool RES>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinCtas)
    rms_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   const float* __restrict__ rstd, const T* __restrict__ g,
                   const T* __restrict__ gres, T* __restrict__ dx,
                   float* __restrict__ part, int n, int d) {
  __shared__ float red[2][32];
  const int nvec = d / VEC;
  const int tid = threadIdx.x;
  float* pr = part + static_cast<int64_t>(blockIdx.x) * d;
  const float fd = static_cast<float>(d);
  int buf = 0;
  // one element's dx from xhat, dxhat, dot and the row's rstd, rounded
  // as _rms_bwd rounds it, then the gradient that reached h directly
  // added as autograd adds two gradients of x's type
  auto dx_of = [](float xh, float dxh, float dot, float r, T res) {
    T t = from_f<T>(__fmul_rn(r, __fsub_rn(dxh, __fmul_rn(xh, dot))));
    if constexpr (RES) t = from_f<T>(__fadd_rn(to_f(t), to_f(res)));
    return t;
  };
  if (nvec <= kBwdThreads * kBwdVecs) {
    float wf[kBwdVecs][VEC];
    float acc[kBwdVecs][VEC];
#pragma unroll
    for (int k = 0; k < kBwdVecs; ++k) {
      const int i = tid + k * kBwdThreads;
      if (i < nvec) ld_f<VEC>(w, i, wf[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[k][j] = 0.f;
    }
    for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
      const int64_t base = row * d;
      Pack<T, VEC> xv[kBwdVecs], gv[kBwdVecs], rv[kBwdVecs];
#pragma unroll
      for (int k = 0; k < kBwdVecs; ++k) {
        const int i = tid + k * kBwdThreads;
        if (i < nvec) {
          xv[k] = ld<T, VEC>(x + base, i);
          gv[k] = ld<T, VEC>(g + base, i);
          if constexpr (RES) rv[k] = ld<T, VEC>(gres + base, i);
        }
      }
      const float r = rstd[row];
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kBwdVecs; ++k) {
        if (tid + k * kBwdThreads < nvec) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            s += __fmul_rn(to_f(gv[k].v[j]), wf[k][j]) *
                 __fmul_rn(to_f(xv[k].v[j]), r);
          }
        }
      }
      const float dot = block_sum(s, red[buf]) / fd;
      buf ^= 1;
#pragma unroll
      for (int k = 0; k < kBwdVecs; ++k) {
        const int i = tid + k * kBwdThreads;
        if (i < nvec) {
          Pack<T, VEC> o;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float gf = to_f(gv[k].v[j]);
            const float xh = __fmul_rn(to_f(xv[k].v[j]), r);
            o.v[j] = dx_of(xh, __fmul_rn(gf, wf[k][j]), dot, r,
                           RES ? rv[k].v[j] : T());
            acc[k][j] = __fadd_rn(acc[k][j], __fmul_rn(gf, xh));
          }
          st<T, VEC>(dx + base, i, o);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kBwdVecs; ++k) {
      const int i = tid + k * kBwdThreads;
      if (i < nvec) st_f<VEC>(pr, i, acc[k]);
    }
    return;
  }
  // a row too long for registers: two strided reads of x and g per row,
  // the sums kept in this CTA's row of `part` (each column is one
  // thread's)
  for (int i = tid; i < nvec; i += kBwdThreads) {
    float z[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) z[j] = 0.f;
    st_f<VEC>(pr, i, z);
  }
  for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
    const int64_t base = row * d;
    const float r = rstd[row];
    float s = 0.f;
    for (int i = tid; i < nvec; i += kBwdThreads) {
      const Pack<T, VEC> xa = ld<T, VEC>(x + base, i);
      const Pack<T, VEC> ga = ld<T, VEC>(g + base, i);
      float wf[VEC];
      ld_f<VEC>(w, i, wf);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s += __fmul_rn(to_f(ga.v[j]), wf[j]) * __fmul_rn(to_f(xa.v[j]), r);
      }
    }
    const float dot = block_sum(s, red[buf]) / fd;
    buf ^= 1;
    for (int i = tid; i < nvec; i += kBwdThreads) {
      const Pack<T, VEC> xa = ld<T, VEC>(x + base, i);
      const Pack<T, VEC> ga = ld<T, VEC>(g + base, i);
      Pack<T, VEC> ra;
      if constexpr (RES) ra = ld<T, VEC>(gres + base, i);
      float wf[VEC], a[VEC];
      ld_f<VEC>(w, i, wf);
      ld_f<VEC>(static_cast<const float*>(pr), i, a);
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float gf = to_f(ga.v[j]);
        const float xh = __fmul_rn(to_f(xa.v[j]), r);
        o.v[j] = dx_of(xh, __fmul_rn(gf, wf[j]), dot, r,
                       RES ? ra.v[j] : T());
        a[j] = __fadd_rn(a[j], __fmul_rn(gf, xh));
      }
      st<T, VEC>(dx + base, i, o);
      st_f<VEC>(pr, i, a);
    }
  }
}

// dw[c] = sum over p of part[p][c], p in order: kDwGroups groups of
// consecutive p summed by their own threads, then the groups in order.
template <typename W>
__global__ void __launch_bounds__(kDwCols * kDwGroups)
    rms_dw_kernel(const float* __restrict__ part, W* __restrict__ dw,
                  int parts, int d) {
  __shared__ float sums[kDwGroups][kDwCols];
  const int lane = threadIdx.x % kDwCols;
  const int grp = threadIdx.x / kDwCols;
  const int col = blockIdx.x * kDwCols + lane;
  const int chunk = (parts + kDwGroups - 1) / kDwGroups;
  const int p0 = grp * chunk;
  const int p1 = min(p0 + chunk, parts);
  float s = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int p = p0; p < p1; ++p) s += part[static_cast<int64_t>(p) * d + col];
  }
  sums[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kDwGroups; ++q) t += sums[q][lane];
    dw[col] = from_f<W>(t);
  }
}

template <typename T, typename W, int VEC, bool RES>
int launch_bwd(const void* x, const void* w, const void* rstd, const void* g,
               const void* g_res, void* dx, void* part, void* dw, int n,
               int d, int parts, cudaStream_t stream) {
  rms_bwd_kernel<T, W, VEC, RES><<<parts, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(rstd), static_cast<const T*>(g),
      static_cast<const T*>(g_res), static_cast<T*>(dx),
      static_cast<float*>(part), n, d);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  rms_dw_kernel<W><<<(d + kDwCols - 1) / kDwCols, kDwCols * kDwGroups, 0,
                     stream>>>(static_cast<const float*>(part),
                               static_cast<W*>(dw), parts, d);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- dispatch

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// f(T*, W*, integral_constant<VEC>) for x's type T (0 = float32,
// 1 = bfloat16), the weight's W, and 16-byte vectors or scalars
template <typename T, typename W, typename F>
int by_vec(bool vec, F& f) {
  if (vec) {
    return f(static_cast<T*>(nullptr), static_cast<W*>(nullptr),
             std::integral_constant<int, 16 / sizeof(T)>());
  }
  return f(static_cast<T*>(nullptr), static_cast<W*>(nullptr),
           std::integral_constant<int, 1>());
}

template <typename T, typename F>
int by_w(int w_dtype, bool vec, F& f) {
  if (w_dtype == 0) return by_vec<T, float>(vec, f);
  if (w_dtype == 1) return by_vec<T, __nv_bfloat16>(vec, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int by_types(int dtype, int w_dtype, bool vec, F f) {
  if (dtype == 0) return by_w<float>(w_dtype, vec, f);
  if (dtype == 1) return by_w<__nv_bfloat16>(w_dtype, vec, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

// whether every row of d values of x's type starts 16-byte aligned
bool vector_rows(int d, int dtype, std::initializer_list<const void*> ptrs) {
  const int vec = dtype == 1 ? 8 : 4;
  if (d % vec != 0) return false;
  for (const void* p : ptrs) {
    if (!aligned16(p)) return false;
  }
  return true;
}

int fwd(const void* x, const void* delta, const void* w, void* h, void* y,
        void* rstd, int n, int d, float eps, int dtype, int w_dtype,
        void* stream) {
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vector_rows(d, dtype, {x, delta, w, h, y});
  return by_types(dtype, w_dtype, vec, [&](auto tp, auto wp, auto vc) {
    using T = std::remove_pointer_t<decltype(tp)>;
    using W = std::remove_pointer_t<decltype(wp)>;
    constexpr int kVec = decltype(vc)::value;
    if (delta != nullptr) {
      return launch_fwd<T, W, kVec, true>(x, delta, w, h, y, rstd, n, d, eps,
                                          s);
    }
    return launch_fwd<T, W, kVec, false>(x, delta, w, h, y, rstd, n, d, eps,
                                         s);
  });
}

}  // namespace

extern "C" {

// dtype (x and y) and w_dtype (the weight): 0 = float32, 1 = bfloat16;
// rstd is fp32.
int dl_rms_norm_fwd(const void* x, const void* w, void* y, void* rstd, int n,
                    int d, float eps, int dtype, int w_dtype, void* stream) {
  return fwd(x, nullptr, w, nullptr, y, rstd, n, d, eps, dtype, w_dtype,
             stream);
}

// h = x + delta (x's type), then the norm of h; both rows written.
int dl_add_rms_norm_fwd(const void* x, const void* delta, const void* w,
                        void* h, void* y, void* rstd, int n, int d, float eps,
                        int dtype, int w_dtype, void* stream) {
  if (delta == nullptr || h == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fwd(x, delta, w, h, y, rstd, n, d, eps, dtype, w_dtype, stream);
}

// dx (x's type) and dw (w's type) from x, w, rstd [n] fp32, g and, when
// not null, g_res (both x's type); `part` is fp32 [parts, d] workspace,
// 1 <= parts <= n CTAs.
int dl_rms_norm_bwd(const void* x, const void* w, const void* rstd,
                    const void* g, const void* g_res, void* dx, void* part,
                    void* dw, int n, int d, int parts, int dtype, int w_dtype,
                    void* stream) {
  if (n < 1 || d < 1 || parts < 1 || parts > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vector_rows(d, dtype, {x, w, g, g_res, dx, part});
  return by_types(dtype, w_dtype, vec, [&](auto tp, auto wp, auto vc) {
    using T = std::remove_pointer_t<decltype(tp)>;
    using W = std::remove_pointer_t<decltype(wp)>;
    constexpr int kVec = decltype(vc)::value;
    if (g_res != nullptr) {
      return launch_bwd<T, W, kVec, true>(x, w, rstd, g, g_res, dx, part, dw,
                                          n, d, parts, s);
    }
    return launch_bwd<T, W, kVec, false>(x, w, rstd, g, g_res, dx, part, dw,
                                         n, d, parts, s);
  });
}

const char* dl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
