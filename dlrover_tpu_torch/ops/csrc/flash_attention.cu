// Flash attention (FA2) forward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel
//   dlrover_tpu/ops/flash_attention.py:_flash_fwd_kernel      (B2, _flash_fwd)
// The backward (B3, B4) is flash_attention_bwd.cu.
//
// Layout: q, o [B, S, H, D]; k, v [B, S, KV, D] (H % KV == 0, query head
// h reads KV head h / (H / KV)), all contiguous, so the public
// [B, S, H, D] tensors are read in place (no transpose copy).  lse is
// fp32 [B, H, S].
//
//   s = q k^T * scale (fp32), -1e30 where masked (col >= S, or col > row
//   under causal), online softmax (m, l, acc in fp32), p cast to v's type
//   before p v, o = acc / max(l, 1e-30) in q's type,
//   lse = m + log(max(l, 1e-30)).
// Rows past S are zero-filled in shared memory and never read from device
// memory, so garbage (NaN) past the end of a tensor cannot reach a
// product.
//
// What bounds it on the card: operations.  At Llama-2-7B training shapes
// ([4, 32, 2048, 128] causal) the forward does 2 causal S x S x D
// products against ~0.2 GB of inputs, far above the H100's ridge of ~295
// operations per byte.  So the bf16 path runs on the tensor cores
// (mma.sync m16n8k16, fp32 accumulators in registers) and causal tiles
// above the diagonal are skipped.
//
// Design (a first, simple design: no TMA, no wgmma, no pipelining):
//   bf16: one block of 4 warps per (q tile of 64, head, batch).  Tiles
//     are staged through shared memory (rows padded by 8 elements, so the
//     8 rows an ldmatrix reads fall in distinct banks); each warp owns 16
//     rows of the block's tile, loads its fragments with ldmatrix (.trans
//     for v in p v) and keeps its accumulators in registers.  The fp32
//     score fragment is re-packed in registers as the bf16 A operand of
//     p v.
//   fp32: the same grid with 32-row tiles and plain FMA (no TF32): the
//     score tile goes through shared memory, each thread owns a quarter
//     of one output row in registers.
// D must be 64 or 128 (the wrapper checks).
//
// C interface (ctypes): the entry returns cudaGetLastError() after its
// launch.  The caller allocates every output; the kernel launches on
// `stream` and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

// ------------------------------------------------------------ helpers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// the value a T would round x to, back in fp32 (p cast before p v)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b, m16n8k16, bf16 in, fp32 accumulate.
// a: rows g / g+8, k cols 2t..2t+1 / +8; b: k rows 2t..2t+1 / +8, col g;
// c: rows g (c0, c1) and g+8 (c2, c3), cols 2t, 2t+1
// (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copy `rows` rows of D elements starting at row r0 (row stride `stride`
// elements in device memory) into shared memory with row stride LD;
// rows at or past S are zero-filled.  16-byte vectors (LD * sizeof(T)
// is a multiple of 16).
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0,
                                          int rows, int S, int64_t stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct Shape {
  int S, H, KV;
  float scale;
  int causal;
};

// =================================================== bf16, tensor cores

constexpr int kTile = 64;  // q and k tiles

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  mma_bf16(c, a[0], a[1], a[2], a[3], b0, b1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 give the rows of matrix i); `.trans` hands each
// thread the transposed elements.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// A fragment of the 16 x 16 tile at (row r0, col c0) of a row-major tile
// with row stride LD.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int r0, int c0, int lane) {
  ldsm_x4(a, s + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles (n0, n0 + 8) at k-step c0, from a tile
// whose rows are n and whose columns are k (k^T for q k^T): b[0], b[1]
// for n-tile n0, b[2], b[3] for n0 + 8.
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* s,
                                          int n0, int c0, int lane) {
  ldsm_x4(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles (n0, n0 + 8) at k rows k0..k0+15, from a
// tile whose rows are k and whose columns are n (v for p v): the
// transposed load.
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* s,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                   (lane >> 4) * 8);
}

// The fp32 accumulators of n-tiles 2j, 2j+1 re-packed as the bf16 A
// fragment of k-step j of the next product.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ------------------------------------------------------------ forward

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o,
            float* __restrict__ lse, Shape sh) {
  constexpr int LD = D + 8;
  constexpr int NT = kTile / 8;  // score n-tiles per k tile
  constexpr int KD = D / 16;     // k-steps over D
  constexpr int ND = D / 8;      // output n-tiles over D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kTile * LD;
  bf16* sV = sK + kTile * LD;

  const int S = sh.S, H = sh.H, KV = sh.KV;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qs = static_cast<int64_t>(H) * D;   // q row stride
  const int64_t ks = static_cast<int64_t>(KV) * D;  // k/v row stride
  const bf16* qb = q + (static_cast<int64_t>(b) * S * H + h) * D;
  const bf16* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * D;
  const bf16* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * D;

  load_rows<bf16, D, LD>(sQ, qb, q0, kTile, S, qs);
  __syncthreads();
  const int wr = warp * 16;  // warp's first row in the tile
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) frag_a<LD>(qa[kk], sQ, wr, kk * 16, lane);
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int nk = (S + kTile - 1) / kTile;
  const int kt_end = sh.causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<bf16, D, LD>(sK, kb, k0, kTile, S, ks);
    load_rows<bf16, D, LD>(sV, vb, k0, kTile, S, ks);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        frag_b_nk<LD>(bk, sK, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e >> 1];
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * sh.scale;
        if (col >= S || (sh.causal && col > r)) x = kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = p;
      }
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // acc += p v: the score fragments as A, v through the transposed load
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bv[4];
        frag_b_kn<LD>(bv, sV, j * 16, dp * 16, lane);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

  bf16* ob = o + (static_cast<int64_t>(b) * S * H + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float denom = fmaxf(quad_sum(l[i]), 1e-30f);
    const float inv = 1.f / denom;
    if (row[i] < S) {
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        *reinterpret_cast<uint32_t*>(ob + row[i] * qs + dn * 8 + 2 * t) =
            pack_bf16(acc[dn][2 * i] * inv, acc[dn][2 * i + 1] * inv);
      }
      if (t == 0) {
        lse[(static_cast<int64_t>(b) * H + h) * S + row[i]] =
            m[i] + logf(denom);
      }
    }
  }
}

// =========================================================== fp32, FMA

constexpr int kT = 32;  // q and k tiles of the FMA kernels
constexpr int kSL = kT + 1;  // score tile row stride

// rows of D elements into fp32 shared memory (row stride LD), zero past S
template <typename T, int D, int LD>
__device__ __forceinline__ void load_f(float* dst, const T* src, int r0,
                                       int rows, int S, int64_t stride) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r0 + r < S ? to_f(src[(r0 + r) * stride + c]) : 0.f;
  }
}

template <int D, int LD>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float x = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) x += a[d] * b[d];
  return x;
}

// Each thread owns a quarter of one output row: row tid / 4, dims
// tid % 4 + 4 j.  Score-tile entries are spread over the threads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_fma(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o,
            float* __restrict__ lse, Shape sh) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kT * LD;
  float* sV = sK + kT * LD;
  float* sS = sV + kT * LD;
  float* sAlpha = sS + kT * kSL;
  float* sDen = sAlpha + kT;

  const int S = sh.S, H = sh.H, KV = sh.KV;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kT;
  const int tid = threadIdx.x;
  const int orow = tid >> 2, oc = tid & 3;
  const int64_t qs = static_cast<int64_t>(H) * D;
  const int64_t ks = static_cast<int64_t>(KV) * D;
  const int64_t qoff = (static_cast<int64_t>(b) * S * H + h) * D;
  const T* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * D;
  const T* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * D;

  load_f<T, D, LD>(sQ, q + qoff, q0, kT, S, qs);
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;  // row `tid` (threads below kT)

  const int nk = (S + kT - 1) / kT;
  const int kt_end = sh.causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();
    load_f<T, D, LD>(sK, kb, k0, kT, S, ks);
    load_f<T, D, LD>(sV, vb, k0, kT, S, ks);
    __syncthreads();
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e % kT;
      float x = dot_rows<D, LD>(sQ + r * LD, sK + c * LD) * sh.scale;
      if (k0 + c >= S || (sh.causal && k0 + c > q0 + r)) x = kNegInf;
      sS[r * kSL + c] = x;
    }
    __syncthreads();
    if (tid < kT) {
      float* sr = sS + tid * kSL;
      float mx = kNegInf;
      for (int c = 0; c < kT; ++c) mx = fmaxf(mx, sr[c]);
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      m = m_new;
      float sum = 0.f;
      for (int c = 0; c < kT; ++c) {
        const float p = expf(sr[c] - m);
        sum += p;
        sr[c] = round_to<T>(p);
      }
      l = l * alpha + sum;
      sAlpha[tid] = alpha;
    }
    __syncthreads();
    const float al = sAlpha[orow];
    const float* sr = sS + orow * kSL;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= al;
    for (int c = 0; c < kT; ++c) {
      const float p = sr[c];
      const float* vr = sV + c * LD + oc;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += p * vr[4 * j];
    }
  }
  if (tid < kT) {
    const float den = fmaxf(l, 1e-30f);
    sDen[tid] = den;
    if (q0 + tid < S) {
      lse[(static_cast<int64_t>(b) * H + h) * S + q0 + tid] = m + logf(den);
    }
  }
  __syncthreads();
  if (q0 + orow < S) {
    const float den = sDen[orow];
    T* orow_p = o + qoff + (q0 + orow) * qs + oc;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow_p[4 * j] = from_f<T>(acc[j] / den);
  }
}

// ----------------------------------------------------------- dispatch

// Opt a kernel into more than 48 KB of dynamic shared memory, once per
// instantiation (before any CUDA-graph capture: the first call is eager).
template <typename K>
cudaError_t allow_smem(K* kern, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  done = e == cudaSuccess;
  return e;
}

inline int tiles(int S, int t) { return (S + t - 1) / t; }

template <int D>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, Shape sh, int dtype,
                       cudaStream_t st) {
  float* l = static_cast<float*>(lse);
  if (dtype == 1) {
    static bool done = false;
    const size_t smem = 3 * kTile * (D + 8) * sizeof(bf16);
    cudaError_t e = allow_smem(fwd_mma<D>, smem, done);
    if (e != cudaSuccess) return e;
    fwd_mma<D><<<dim3(tiles(sh.S, kTile), sh.H, B), kThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), l, sh);
  } else if (dtype == 0) {
    static bool done = false;
    const size_t smem = (3 * kT * (D + 1) + kT * kSL + 2 * kT) * sizeof(float);
    cudaError_t e = allow_smem(fwd_fma<float, D>, smem, done);
    if (e != cudaSuccess) return e;
    fwd_fma<float, D><<<dim3(tiles(sh.S, kT), sh.H, B), kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), l, sh);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int KV) {
  return B < 1 || B > 65535 || S < 1 || KV < 1 || H < KV || H % KV != 0 ||
         H > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o share it); lse fp32.
// D: 64 or 128.  causal: 0 or 1.
int dl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int S, int H, int KV, int D, float scale,
                 int causal, int dtype, void* stream) {
  if (bad_shape(B, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{S, H, KV, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return fwd_launch<64>(q, k, v, o, lse, B, sh, dtype, st);
  if (D == 128) return fwd_launch<128>(q, k, v, o, lse, B, sh, dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
