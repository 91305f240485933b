// Flash attention (FA2) forward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel
//   dlrover_tpu/ops/flash_attention.py:_flash_fwd_kernel      (B2, _flash_fwd)
// The backward (B3, B4) is flash_attention_bwd.cu; both include
// hopper.cuh (mbarriers, TMA, wgmma, the tensor-map encoder).
//
// Layout: q, o [B, S, H, D]; k, v [B, S, KV, D] (H % KV == 0, query head
// h reads KV head h / (H / KV)), all contiguous, so the public
// [B, S, H, D] tensors are read in place (no transpose copy).  lse is
// fp32 [B, H, S].
//
//   s = q k^T * scale (fp32), masked where col >= S or (causal) col >
//   row, online softmax (m, l, acc in fp32), p cast to v's type before
//   p v, o = acc / max(l, 1e-30) in q's type, lse = m + log(max(l,
//   1e-30)) (natural log: the backward reads it so).
// Rows past S are zero-filled in shared memory and never read from device
// memory, so garbage (NaN) past the end of a tensor cannot reach a
// product.
//
// What bounds it on the card: operations.  At Llama-2-7B training shapes
// ([4, 32, 2048, 128] causal) the forward does 2 causal S x S x D
// products against ~0.2 GB of inputs, far above the H100's ridge of ~295
// operations per byte: the products have to reach the tensor cores at
// their full rate, which on Hopper only wgmma does, and the tile loads
// have to overlap them.  The first design (mma.sync from ldmatrix,
// 64-row blocks of 4 warps, synchronous loads between two __syncthreads)
// reached 15 % of that bound.
//
// bf16 design: one block per (q tile of 128, head, batch) of two consumer
// warpgroups (64 rows each) and one producer warp.  One producer thread
// loads Q once and streams K and V tiles of 128 keys by TMA, up to the
// diagonal, through a ring of kFwdStages stages: 4-D tensor maps (D,
// heads, S, B) over the tensors in place, boxes of 64 columns with the
// 128-byte swizzle, rows past S arriving as zeros.  K and V of a stage
// each have their own "full" mbarrier, so Q K^T starts before V lands;
// an "empty" one collects every consumer warp.  Per tile a warpgroup
//   s = Q K^T     SS wgmma (both operands K-major in shared memory),
//   online softmax in registers, in log2 units (scale * log2 e folded
//     into one FMA before ex2.approx); only the tiles that touch the
//     diagonal or the sequence end are masked,
//   o += p V      RS wgmma: p rounded to bf16 and packed in registers as
//     the A operand, V read MN-major through the transpose bit.
// A warpgroup holds one 64 x D fp32 sum and one 64 x 128 score tile.  The
// epilogue writes o through the warpgroup's own (now free) rows of the Q
// tile in shared memory, so the stores to device memory are 16-byte and
// row-contiguous.  The tile is the fastest launch index, heaviest causal
// tiles first, so the blocks of one head run together and share their
// K/V tiles in L2.  No atomics: o and lse are deterministic.
// fp32 at every D, and bf16 at D = 16 and 32 (too narrow for the wgmma
// tiles and the 128-byte swizzle): plain FMA (no TF32), 32-row tiles, one
// block of 4 warps per (q tile, head, batch): the score tile goes through
// shared memory, each thread owns a quarter of one output row in
// registers; in bf16 p is rounded to bf16 before p v, as in the wgmma
// kernel.  This path is right, not fast: no tensor cores.
// D must be 16, 32, 64 or 128 (the wrapper checks).
//
// C interface (ctypes): the entry returns cudaGetLastError() after its
// launch.  The caller allocates every output; the kernel launches on
// `stream` and allocates nothing.  The tensor maps are encoded on the
// host at each call, through the driver's entry point (no -lcuda).

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // the fp32 kernel

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

// ====================================================== bf16, Hopper

constexpr int kFwdStages = 2;     // depth of the ring of K/V tiles
constexpr int kRows = 64;         // q rows of a consumer warpgroup
constexpr int kBlockRows = 128;   // q rows of a block (two consumers)
constexpr int kKeys = 128;        // keys of a streamed K/V tile
constexpr float kLn2 = 0.6931471805599453f;

// The block's shared memory from a 1024-byte aligned base (the swizzle
// atoms); byte offsets.
template <int D>
struct FwdSmem {
  static constexpr int kTile = kKeys * D * 2;          // one K or V tile
  static constexpr int kQ = 0;                         // 128 rows, then o
  static constexpr int kK = kQ + kBlockRows * D * 2;   // ring
  static constexpr int kV = kK + kFwdStages * kTile;   // ring
  static constexpr int kBar = kV + kFwdStages * kTile;  // full K, full V,
                                                        // empty, once
  static constexpr int kBytes = kBar + (3 * kFwdStages + 1) * 8 + 1024;
};

// A consumer warp is done with a stage of the ring (every warp of both
// consumers arrives).
__device__ __forceinline__ void release(uint32_t empty, int st, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + 8 * st);
}

// the 128 threads of one consumer warpgroup (named barrier `id`)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWg) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
              float* __restrict__ lse, Shape sh) {
  using L = FwdSmem<D>;
  constexpr int KD = D / 16;      // k-slices of s = Q K^T
  constexpr int KN = kKeys / 16;  // k-slices of o += p V
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const uint32_t base = (smem_u32(fwd_smem) + 1023) & ~1023u;
  unsigned char* gbase = fwd_smem + (base - smem_u32(fwd_smem));
  const uint32_t full_k = base + L::kBar;
  const uint32_t full_v = full_k + 8 * kFwdStages;
  const uint32_t empty = full_v + 8 * kFwdStages;
  const uint32_t once = empty + 8 * kFwdStages;

  const int S = sh.S, H = sh.H;
  // the q tiles of one head are neighbours in the launch order, so the
  // K/V tiles they all read stay in L2; heaviest causal tiles (the last)
  // first
  const int h = blockIdx.y, b = blockIdx.z;
  const int qt = sh.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBlockRows;
  const int kvh = h / (H / sh.KV);
  const int nk = (S + kKeys - 1) / kKeys;
  const int n_k =
      sh.causal ? min(nk, (q0 + kBlockRows + kKeys - 1) / kKeys) : nk;
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 4);  // one arrival per consumer warp
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (threadIdx.x == 2 * kWg) {
      mbar_arrive_tx(once, kBlockRows * D * 2);
      tma_tile<D>(base + L::kQ, &tm_q, once, h, q0, b, kBlockRows);
      for (int it = 0; it < n_k; ++it) {
        const int st = it % kFwdStages;
        mbar_wait(empty + 8 * st, ((it / kFwdStages) & 1) ^ 1);
        mbar_arrive_tx(full_k + 8 * st, kKeys * D * 2);
        tma_tile<D>(base + L::kK + st * L::kTile, &tm_k, full_k + 8 * st,
                    kvh, it * kKeys, b, kKeys);
        mbar_arrive_tx(full_v + 8 * st, kKeys * D * 2);
        tma_tile<D>(base + L::kV + st * L::kTile, &tm_v, full_v + 8 * st,
                    kvh, it * kKeys, b, kKeys);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows r_wg..r_wg + 63 of the q tile
  const int tid = threadIdx.x % kWg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_wg = q0 + wg * kRows;
  const int row[2] = {r_wg + warp * 16 + g, r_wg + warp * 16 + g + 8};
  const float sl2 = sh.scale * kLog2e;
  // the last key a row may see
  int last[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    last[i] = sh.causal ? min(row[i], S - 1) : S - 1;
  }
  float m[2] = {kNegInf, kNegInf};  // running max of s * scale * log2 e
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float acc[D / 2];
  zero(acc);
  mbar_wait(once, 0);

  for (int it = 0; it < n_k; ++it) {
    const int st = it % kFwdStages;
    const uint32_t par = (it / kFwdStages) & 1;
    const int k0 = it * kKeys;
    const uint32_t sK = base + L::kK + st * L::kTile;
    const uint32_t sV = base + L::kV + st * L::kTile;
    float s[kKeys / 2];
    zero(s);
    mbar_wait(full_k + 8 * st, par);
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      wgmma_ss(s, desc_k<kBlockRows>(base + L::kQ, wg * kRows, kk),
               desc_k<kKeys>(sK, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    // a tile inside the causal triangle and the sequence needs no mask
    if ((sh.causal && k0 + kKeys - 1 > r_wg) || k0 + kKeys > S) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col > last[e >> 1]) s[4 * j + e] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int x = 0; x < kKeys / 2; ++x) {
      mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]) * sl2);
      alpha[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int x = 0; x < kKeys / 2; ++x) {
      const int i = (x >> 1) & 1;
      const float p = ex2(fmaf(s[x], sl2, -m[i]));
      l[i] += p;
      s[x] = p;
    }
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] *= alpha[(x >> 1) & 1];
    // o += p V, p as the bf16 A operand in registers
    uint32_t a[KN][4];
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) acc_to_a(a[kk], s, kk);
    mbar_wait(full_v + 8 * st, par);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      wgmma_rs(acc, a[kk], desc_mn<kKeys>(sV, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    release(empty, st, lane);
  }

  // o = acc / max(l, 1e-30) into the warpgroup's rows of the Q tile (its
  // last product has read them), swizzled as TMA wrote Q: the 16-byte
  // chunk c of row r at chunk c ^ (r % 8), so a warp's stores hit 32
  // distinct banks
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float den = fmaxf(quad_sum(l[i]), 1e-30f);
    inv[i] = 1.f / den;
    if (t == 0 && row[i] < S) {
      lse[(static_cast<int64_t>(b) * H + h) * S + row[i]] =
          m[i] * kLn2 + logf(den);
    }
  }
  unsigned char* s_o = gbase + L::kQ;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg * kRows + warp * 16 + g + 8 * i;  // row of the tile
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int off = (j >> 3) * kBlockRows * 128 + r * 128 +
                      (((j & 7) ^ (r & 7)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(s_o + off) =
          pack_bf16(acc[4 * j + 2 * i] * inv[i],
                    acc[4 * j + 2 * i + 1] * inv[i]);
    }
  }
  warpgroup_sync(1 + wg);
  // 16-byte chunks, consecutive threads along a row
  constexpr int kChunks = D / 8;
  const int64_t qs = static_cast<int64_t>(H) * D;
  bf16* ob = o + (static_cast<int64_t>(b) * S * H + h) * D;
  for (int c = tid; c < kRows * kChunks; c += kWg) {
    const int r = wg * kRows + c / kChunks, j = c % kChunks;
    if (q0 + r < S) {
      const int off =
          (j >> 3) * kBlockRows * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(ob + (q0 + r) * qs + j * 8) =
          *reinterpret_cast<const uint4*>(s_o + off);
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

// The FMA kernel's dynamic shared memory: Q, K, V tiles, the score
// tile, the rescale factors and the denominators, all fp32.
constexpr int fwd_fma_smem(int D) {
  return (3 * kT * (D + 1) + kT * kSL + 2 * kT) * 4;
}

template <typename T, int D>
cudaError_t fwd_fma_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, Shape sh,
                           cudaStream_t st) {
  static bool done = false;
  const size_t smem = fwd_fma_smem(D);
  cudaError_t e = allow_smem(fwd_fma<T, D>, smem, done);
  if (e != cudaSuccess) return e;
  fwd_fma<T, D><<<dim3(tiles(sh.S, kT), sh.H, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sh);
  return cudaGetLastError();
}

// bf16 at D = 64 and 128: the wgmma kernel; bf16 at D = 16 and 32 (below
// a 64-byte row, under the 128-byte swizzle's box) and fp32 at every D:
// the FMA kernel.
template <int D>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, Shape sh, int dtype,
                       cudaStream_t st) {
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return fwd_fma_launch<float, D>(q, k, v, o, l, B, sh, st);
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (D < 64) {
    return fwd_fma_launch<bf16, D>(q, k, v, o, l, B, sh, st);
  } else {
    CUtensorMap m[3];
    if (!tensor_map(&m[0], q, B, sh.S, sh.H, D, kBlockRows) ||
        !tensor_map(&m[1], k, B, sh.S, sh.KV, D, kKeys) ||
        !tensor_map(&m[2], v, B, sh.S, sh.KV, D, kKeys)) {
      return cudaErrorInvalidValue;
    }
    static bool done = false;
    const size_t smem = FwdSmem<D>::kBytes;
    cudaError_t e = allow_smem(fwd_wgmma<D>, smem, done);
    if (e != cudaSuccess) return e;
    fwd_wgmma<D><<<dim3(tiles(sh.S, kBlockRows), sh.H, B), kHopperThreads,
                   smem, st>>>(m[0], m[1], m[2], static_cast<bf16*>(o), l,
                               sh);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o share it); lse fp32.
// D: 16, 32, 64 or 128.  causal: 0 or 1.
int dl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int S, int H, int KV, int D, float scale,
                 int causal, int dtype, void* stream) {
  if (bad_shape(B, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{S, H, KV, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return fwd_launch<16>(q, k, v, o, lse, B, sh, dtype, st);
    case 32: return fwd_launch<32>(q, k, v, o, lse, B, sh, dtype, st);
    case 64: return fwd_launch<64>(q, k, v, o, lse, B, sh, dtype, st);
    case 128: return fwd_launch<128>(q, k, v, o, lse, B, sh, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory of one bf16 block (the wgmma kernel at D = 64
// and 128, the FMA kernel at 16 and 32), for the build report; -1 for a D
// the kernels do not take.
int dl_flash_fwd_smem(int D) {
  switch (D) {
    case 16: return fwd_fma_smem(16);
    case 32: return fwd_fma_smem(32);
    case 64: return FwdSmem<64>::kBytes;
    case 128: return FwdSmem<128>::kBytes;
    default: return -1;
  }
}

const char* dl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
