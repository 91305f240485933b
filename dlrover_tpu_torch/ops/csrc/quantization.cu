// Blockwise int8 quantization for Hopper (sm_90a): quantize, dequantize
// and the fused int8 Adam update.
//
// Replaces the TPU kernels of dlrover_tpu/ops/quantization.py:
//   _quant_kernel (launched by _quantize_2d): per 1024-element block,
//     scale = max(absmax / 127, 1e-12), q = clip(round(x / scale), -127, 127);
//   _dequant_kernel (_dequantize_2d): x = q * scale;
//   _fused_adam_kernel (_fused_adam_2d): dequantize mu and sqrt(nu), the
//     Adam moment update, the update value, requantize mu and sqrt(nu)
//     with fresh scales, in one pass.
//
// Layout: the reference's.  The payload is int8 in whole blocks of 1024
// (the wrapper's [n_blocks * 8, 128] tensor), one fp32 scale per block.
// The fp32 side (x, the grad, the update) holds only the n valid
// elements: elements >= n read as 0 and are never written, so the caller
// copies nothing into a padded buffer and the moments' pad region stays
// exactly 0, as on the JAX path.
//
// What bounds it on the card: bytes.  Quantize reads 4 B and writes 1 B
// per element, dequantize the reverse, the Adam update reads 4 + 2 B and
// writes 4 + 2 B; each does a few tens of fp32 operations per element,
// far below the H100's ~20 operations per byte of fp32 ridge.
//
// Design: one thread block of 256 threads per quantization block.  Each
// thread holds 4 consecutive elements in registers (one float4 of fp32,
// one 32-bit word of int8s), so a block's loads are fully coalesced.  The
// block's absmax is a warp-shuffle max and one shared-memory step across
// the 8 warps that every thread reads, so one barrier suffices.  The Adam
// kernel keeps mu and sqrt(nu) in registers between its two reductions
// (done together) and the requantization: the fp32 moments never touch
// memory.  Element offsets are 64-bit (a stacked Llama-2-7B w_gate is
// 1.44e9 elements).
//
// Rounding is the reference's: x / scale, mu / bc1 and nu / bc2 are true
// IEEE divisions (__fdiv_rn, never a reciprocal multiply), absmax / 127 is
// absmax * fp32(1/127) as XLA compiles the reference, rounding is half to
// even (rintf), and the Adam arithmetic is written with __fmul_rn /
// __fadd_rn / __fsqrt_rn in the association of the JAX expression, so nvcc
// cannot contract a product and a sum into one FMA.  The plain PyTorch
// versions (ops/quantization.py) round at the same points, so kernel and
// plain version agree bit for bit.
//
// Aliasing: the Adam kernel may write the update over the grad and the new
// moments and scales over the old ones.  Each thread reads its own
// elements (and the block's scales) before the block's barrier and writes
// them after it, and blocks touch disjoint ranges, so no pointer is
// declared __restrict__.
//
// C interface (ctypes): each entry returns cudaGetLastError() after its
// launch.  The caller allocates every output; the kernels launch on
// `stream` and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;  // elements per quantization block
constexpr int kThreads = 256;
constexpr int kPer = kBlock / kThreads;  // 4 elements per thread
constexpr int kWarps = kThreads / 32;

static_assert(kPer == 4, "a thread holds one float4 / one int8x4 word");

// Elements base .. base+3 of p; those >= n read as 0.
__device__ __forceinline__ void load_f32(const float* p, int64_t base,
                                         int64_t n, float (&v)[kPer]) {
  if (base + kPer <= n && (reinterpret_cast<uintptr_t>(p + base) & 15) == 0) {
    const float4 t = *reinterpret_cast<const float4*>(p + base);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = base + i < n ? p[base + i] : 0.f;
  }
}

// Elements base .. base+3 of p that are < n.
__device__ __forceinline__ void store_f32(float* p, int64_t base, int64_t n,
                                          const float (&v)[kPer]) {
  if (base + kPer <= n && (reinterpret_cast<uintptr_t>(p + base) & 15) == 0) {
    *reinterpret_cast<float4*>(p + base) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (base + i < n) p[base + i] = v[i];
    }
  }
}

__device__ __forceinline__ void load_q(const int8_t* q, int64_t base,
                                       float (&v)[kPer]) {
  const char4 c = *reinterpret_cast<const char4*>(q + base);
  v[0] = static_cast<float>(c.x);
  v[1] = static_cast<float>(c.y);
  v[2] = static_cast<float>(c.z);
  v[3] = static_cast<float>(c.w);
}

// clip(round_half_even(x / scale), -127, 127)
__device__ __forceinline__ signed char quant1(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return static_cast<signed char>(static_cast<int>(r));
}

__device__ __forceinline__ void store_q(int8_t* q, int64_t base,
                                        const float (&v)[kPer], float scale) {
  char4 c;
  c.x = quant1(v[0], scale);
  c.y = quant1(v[1], scale);
  c.z = quant1(v[2], scale);
  c.w = quant1(v[3], scale);
  *reinterpret_cast<char4*>(q + base) = c;
}

__device__ __forceinline__ float abs_max4(const float (&v)[kPer]) {
  return fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
}

// max(absmax / 127, 1e-12) as the reference computes it: XLA turns the
// division by the constant into a multiply by fp32(1/127).
__device__ __forceinline__ float scale_of(float absmax) {
  return fmaxf(__fmul_rn(absmax, 1.0f / 127.0f), 1e-12f);
}

// The block-wide max of K values at once; every thread gets the results.
template <int K>
__device__ __forceinline__ void block_max(float (&m)[K],
                                          float (&smem)[K][kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m[k] = fmaxf(m[k], __shfl_xor_sync(0xffffffffu, m[k], off));
    }
    if (lane == 0) smem[k][warp] = m[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float r = smem[k][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) r = fmaxf(r, smem[k][w]);
    m[k] = r;
  }
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scales, int64_t n) {
  __shared__ float red[1][kWarps];
  const int64_t blk = blockIdx.x;
  const int64_t base = blk * kBlock + threadIdx.x * kPer;
  float v[kPer];
  load_f32(x, base, n, v);
  float m[1] = {abs_max4(v)};
  block_max<1>(m, red);
  const float scale = scale_of(m[0]);
  store_q(q, base, v, scale);
  if (threadIdx.x == 0) scales[blk] = scale;
}

__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales, float* __restrict__ x,
                      int64_t n) {
  const int64_t blk = blockIdx.x;
  const int64_t base = blk * kBlock + threadIdx.x * kPer;
  if (base >= n) return;
  const float s = scales[blk];
  float v[kPer];
  load_q(q, base, v);
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = __fmul_rn(v[i], s);
  store_f32(x, base, n, v);
}

struct AdamArgs {
  float bc1, bc2, neg_lr, b1, omb1, b2, omb2, eps;
};

__global__ void __launch_bounds__(kThreads)
    int8_adam_kernel(const float* g, float* upd, const int8_t* mu_q,
                     const float* mu_s, const int8_t* nu_q, const float* nu_s,
                     int8_t* mu_q_out, float* mu_s_out, int8_t* nu_q_out,
                     float* nu_s_out, int64_t n, AdamArgs a) {
  __shared__ float red[2][kWarps];
  const int64_t blk = blockIdx.x;
  const int64_t base = blk * kBlock + threadIdx.x * kPer;
  float gv[kPer], mu[kPer], root[kPer], u[kPer];
  load_f32(g, base, n, gv);
  load_q(mu_q, base, mu);
  load_q(nu_q, base, root);
  const float ms = mu_s[blk];
  const float ns = nu_s[blk];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float m_old = __fmul_rn(mu[i], ms);
    const float r_old = __fmul_rn(root[i], ns);
    // mu = b1 * mu + (1 - b1) * g
    const float m = __fadd_rn(__fmul_rn(a.b1, m_old), __fmul_rn(a.omb1, gv[i]));
    // nu = b2 * r * r + (1 - b2) * g * g
    const float nu = __fadd_rn(__fmul_rn(__fmul_rn(a.b2, r_old), r_old),
                               __fmul_rn(__fmul_rn(a.omb2, gv[i]), gv[i]));
    // upd = -lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
    u[i] = __fdiv_rn(__fmul_rn(a.neg_lr, __fdiv_rn(m, a.bc1)),
                     __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, a.bc2)), a.eps));
    mu[i] = m;
    root[i] = __fsqrt_rn(nu);
  }
  float mx[2] = {abs_max4(mu), abs_max4(root)};
  block_max<2>(mx, red);
  const float s_mu = scale_of(mx[0]);
  const float s_nu = scale_of(mx[1]);
  store_f32(upd, base, n, u);
  store_q(mu_q_out, base, mu, s_mu);
  store_q(nu_q_out, base, root, s_nu);
  if (threadIdx.x == 0) {
    mu_s_out[blk] = s_mu;
    nu_s_out[blk] = s_nu;
  }
}

bool bad_grid(int64_t n, int64_t n_blocks) {
  return n < 1 || n_blocks < 1 || n > n_blocks * kBlock ||
         n_blocks > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// x: n fp32; q: n_blocks * 1024 int8; scales: n_blocks fp32.
int dl_quantize(const void* x, void* q, void* scales, int64_t n,
                int64_t n_blocks, void* stream) {
  if (bad_grid(n, n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  quantize_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), n);
  return static_cast<int>(cudaGetLastError());
}

// q: whole blocks of int8 covering n; scales: one per block; x: n fp32.
int dl_dequantize(const void* q, const void* scales, void* x, int64_t n,
                  void* stream) {
  const int64_t n_blocks = (n + kBlock - 1) / kBlock;
  if (bad_grid(n, n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  dequantize_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

// g, upd: n fp32 (upd may be g); mu_q, nu_q: n_blocks * 1024 int8 and
// mu_s, nu_s: n_blocks fp32, read; the *_out buffers of the same sizes,
// written (each may be its input).  neg_lr = -lr, omb1 = 1 - b1 and
// omb2 = 1 - b2 are the fp32 values of the reference's constants.
int dl_int8_adam(const void* g, void* upd, const void* mu_q, const void* mu_s,
                 const void* nu_q, const void* nu_s, void* mu_q_out,
                 void* mu_s_out, void* nu_q_out, void* nu_s_out, int64_t n,
                 int64_t n_blocks, float bc1, float bc2, float neg_lr, float b1,
                 float omb1, float b2, float omb2, float eps, void* stream) {
  if (bad_grid(n, n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const AdamArgs a{bc1, bc2, neg_lr, b1, omb1, b2, omb2, eps};
  int8_adam_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(upd),
      static_cast<const int8_t*>(mu_q), static_cast<const float*>(mu_s),
      static_cast<const int8_t*>(nu_q), static_cast<const float*>(nu_s),
      static_cast<int8_t*>(mu_q_out), static_cast<float*>(mu_s_out),
      static_cast<int8_t*>(nu_q_out), static_cast<float*>(nu_s_out), n, a);
  return static_cast<int>(cudaGetLastError());
}

const char* dl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
