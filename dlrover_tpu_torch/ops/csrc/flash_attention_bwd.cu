// Flash attention backward (dK/dV and dQ) for Hopper (sm_90a), bf16 and
// fp32.
//
// Replaces the TPU kernels
//   dlrover_tpu/ops/flash_attention.py:_flash_bwd_dkv_kernel  (B3, _flash_bwd)
//   dlrover_tpu/ops/flash_attention.py:_flash_bwd_dq_kernel   (B4, _flash_bwd)
// The forward (B2) is flash_attention.cu.
//
// Layout: q, do [B, S, H, D]; k, v, dk, dv [B, S, KV, D] (H % KV == 0,
// query head h reads KV head h / (H / KV)), all contiguous and read in
// place.  lse, delta (= rowsum(dO * O)) and glse (the lse cotangent, may
// be null) are fp32 [B, H, S].
//
//   p = exp(s - lse) with s = q k^T * scale, dp = dO v^T,
//   ds = p (dp - delta + glse) scale;
//   dK/dV: dv += p^T dO, dk += ds^T q, both accumulated in fp32 over the
//          q tiles AND the G query heads of the KV head, written once;
//   dQ:    dq += ds k in fp32.
// p and ds are rounded to the input type before they enter a product.
// Masked entries (key >= S, query >= S, key > query under causal) get
// p = ds = 0; rows past S are zero-filled in shared memory and never read
// from device memory, so garbage (NaN) past the end of a tensor cannot
// reach a product.
//
// What bounds it on the card: operations.  At Llama-2-7B training shapes
// ([4, 32, 2048, 128] causal) dK/dV does 4 and dQ 3 causal S x S x D
// products against ~0.3 GB of inputs, far above the H100's ridge of ~295
// operations per byte: the products have to reach the tensor cores at
// their full rate, which on Hopper only wgmma does, and the tile loads
// have to overlap them.
//
// bf16 design: blocks of two consumer warpgroups and one producer warp.
// One producer thread loads every tile by TMA from a 4-D tensor map (D,
// heads, S, B) over the tensor in place, in boxes of 64 columns (128
// bytes) with the 128-byte swizzle, so rows past S arrive as zeros.  The
// streamed tiles go through a ring of 3 stages, each with a "full"
// mbarrier (bytes landed) and an "empty" one (every consumer warp done).
// The consumers run wgmma on shared-memory descriptors of the same
// swizzle, keep their sums in registers and recompute p and ds between
// two products.
//   dQ: one block per (q tile of 128, head, batch), a warpgroup per 64
//     rows.  Q and dO are loaded once; K/V tiles of 64 stream up to the
//     diagonal.  Per k tile: s = Q K^T and dp = dO V^T (A and B K-major in
//     shared memory) in two commit groups, p = exp(s - lse) while dp still
//     runs, ds, then dQ += ds K with ds as the bf16 A operand in registers
//     and K read MN-major (the transpose bit).
//   dK/dV: one block per (k tile of 64, KV head, batch).  K and V of the
//     tile are loaded once; the producer streams (query head of the
//     group, q tile of 64) pairs of Q and dO from the diagonal on, with lse
//     and glse - delta read one tile ahead.  The two warpgroups split the
//     outputs: one computes s^T = K Q^T and p^T, hands p^T (fp32) to the
//     other through shared memory and sums dV += p^T dO; the other computes
//     dp^T = V dO^T, ds^T from p^T, and sums dK += ds^T Q.  A warpgroup
//     holds one 64 x D sum and one 64 x 64 score tile (~160 registers):
//     both sums and both score tiles in one warpgroup did not fit, and
//     ptxas spilled and serialised every wgmma.
//   The tile is the fastest launch index, heaviest causal tiles first, so
//   the blocks of one head run together and share their streamed tiles in
//   L2.  No atomics: every output element is summed in one thread's
//   registers and written once, so dk, dv and dq are deterministic.
// fp32 at every D, and bf16 at D = 16 and 32 (too narrow for the wgmma
// tiles and the 128-byte swizzle): plain FMA (no TF32), 32-row tiles, one
// block of 4 warps per (q tile, head, batch) for dQ and per (k tile, KV
// head, batch) for dK/dV; p and ds are rounded to the input type before
// they enter a product, as in the wgmma kernels.  This path is right, not
// fast: no tensor cores.
// D must be 16, 32, 64 or 128 (the wrapper checks).
//
// C interface (ctypes): each entry returns cudaGetLastError() after its
// launch.  The caller allocates every output; the kernels launch on
// `stream` and allocate nothing.  The tensor maps are encoded on the host
// at each call, through the driver's entry point (no -lcuda).

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // the fp32 kernels

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

// the value a T would round x to, back in fp32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Shape {
  int S, H, KV;
  float scale;
  int causal;
};

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
    dq_fma(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ glse, T* __restrict__ dq, Shape sh) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sO = sQ + kT * LD;
  float* sK = sO + kT * LD;
  float* sV = sK + kT * LD;
  float* sS = sV + kT * LD;
  float* sLse = sS + kT * kSL;
  float* sCorr = sLse + kT;

  const int S = sh.S, H = sh.H, KV = sh.KV;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kT;
  const int tid = threadIdx.x;
  const int orow = tid >> 2, oc = tid & 3;
  const int64_t qs = static_cast<int64_t>(H) * D;
  const int64_t ks = static_cast<int64_t>(KV) * D;
  const int64_t qoff = (static_cast<int64_t>(b) * S * H + h) * D;
  const int64_t voff = (static_cast<int64_t>(b) * H + h) * S;
  const T* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * D;
  const T* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * D;

  load_f<T, D, LD>(sQ, q + qoff, q0, kT, S, qs);
  load_f<T, D, LD>(sO, dout + qoff, q0, kT, S, qs);
  for (int i = tid; i < kT; i += kThreads) {
    const bool in = q0 + i < S;
    sLse[i] = in ? lse[voff + q0 + i] : 0.f;
    sCorr[i] = in ? (glse != nullptr ? glse[voff + q0 + i] : 0.f) -
                        delta[voff + q0 + i]
                  : 0.f;
  }
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

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
      const bool keep = k0 + c < S && q0 + r < S &&
                        !(sh.causal && k0 + c > q0 + r);
      float ds = 0.f;
      if (keep) {
        const float s = dot_rows<D, LD>(sQ + r * LD, sK + c * LD);
        const float dp = dot_rows<D, LD>(sO + r * LD, sV + c * LD);
        const float p = expf(s * sh.scale - sLse[r]);
        ds = p * (dp + sCorr[r]) * sh.scale;
      }
      sS[r * kSL + c] = round_to<T>(ds);
    }
    __syncthreads();
    const float* sr = sS + orow * kSL;
    for (int c = 0; c < kT; ++c) {
      const float x = sr[c];
      const float* kr = sK + c * LD + oc;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += x * kr[4 * j];
    }
  }
  if (q0 + orow < S) {
    T* dst = dq + qoff + (q0 + orow) * qs + oc;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[4 * j] = from_f<T>(acc[j]);
  }
}

// Each thread owns a quarter of one key row of dk and dv.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dkv_fma(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const float* __restrict__ glse, T* __restrict__ dk,
            T* __restrict__ dv, Shape sh) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kT * LD;
  float* sQ = sV + kT * LD;
  float* sO = sQ + kT * LD;
  float* sP = sO + kT * LD;  // [q row][key]
  float* sDS = sP + kT * kSL;
  float* sLse = sDS + kT * kSL;
  float* sCorr = sLse + kT;

  const int S = sh.S, H = sh.H, KV = sh.KV;
  const int G = H / KV;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kT;
  const int tid = threadIdx.x;
  const int krow = tid >> 2, oc = tid & 3;
  const int64_t qs = static_cast<int64_t>(H) * D;
  const int64_t ks = static_cast<int64_t>(KV) * D;
  const int64_t koff = (static_cast<int64_t>(b) * S * KV + kvh) * D;

  load_f<T, D, LD>(sK, k + koff, k0, kT, S, ks);
  load_f<T, D, LD>(sV, v + koff, k0, kT, S, ks);
  float dka[NJ], dva[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dka[j] = dva[j] = 0.f;

  const int nq = (S + kT - 1) / kT;
  const int qt_begin = sh.causal ? kt : 0;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const int64_t qoff = (static_cast<int64_t>(b) * S * H + h) * D;
    const int64_t voff = (static_cast<int64_t>(b) * H + h) * S;
    for (int qt = qt_begin; qt < nq; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();
      load_f<T, D, LD>(sQ, q + qoff, q0, kT, S, qs);
      load_f<T, D, LD>(sO, dout + qoff, q0, kT, S, qs);
      for (int i = tid; i < kT; i += kThreads) {
        const bool in = q0 + i < S;
        sLse[i] = in ? lse[voff + q0 + i] : 0.f;
        sCorr[i] = in ? (glse != nullptr ? glse[voff + q0 + i] : 0.f) -
                            delta[voff + q0 + i]
                      : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int r = e / kT, c = e % kT;  // q row, key
        const bool keep = k0 + c < S && q0 + r < S &&
                          !(sh.causal && q0 + r < k0 + c);
        float p = 0.f, ds = 0.f;
        if (keep) {
          const float s = dot_rows<D, LD>(sQ + r * LD, sK + c * LD);
          const float dp = dot_rows<D, LD>(sO + r * LD, sV + c * LD);
          p = expf(s * sh.scale - sLse[r]);
          ds = p * (dp + sCorr[r]) * sh.scale;
        }
        sP[r * kSL + c] = round_to<T>(p);
        sDS[r * kSL + c] = round_to<T>(ds);
      }
      __syncthreads();
      for (int r = 0; r < kT; ++r) {
        const float p = sP[r * kSL + krow];
        const float ds = sDS[r * kSL + krow];
        const float* orow_p = sO + r * LD + oc;
        const float* qrow_p = sQ + r * LD + oc;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dva[j] += p * orow_p[4 * j];
          dka[j] += ds * qrow_p[4 * j];
        }
      }
    }
  }
  if (k0 + krow < S) {
    const int64_t off = koff + (k0 + krow) * ks + oc;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + 4 * j] = from_f<T>(dka[j]);
      dv[off + 4 * j] = from_f<T>(dva[j]);
    }
  }
}

// ====================================================== bf16, Hopper

constexpr int kDqStages = 3;   // depth of the ring of K/V tiles (dQ)
constexpr int kDkvStages = 3;  // depth of the ring of Q/dO tiles (dK/dV)
constexpr int kRows = 64;        // rows of a consumer, and of a streamed tile
constexpr int kBlockRows = 128;  // q rows of a dQ block (two consumers)

// The block's shared memory is laid out from a 1024-byte aligned base
// (the swizzle atoms); byte offsets.
template <int D>
struct DqSmem {
  static constexpr int kTile = kRows * D * 2;  // one 64-row tile
  static constexpr int kQ = 0;                 // 128 rows
  static constexpr int kO = kQ + 2 * kTile;    // dO, 128 rows
  static constexpr int kK = kO + 2 * kTile;    // ring
  static constexpr int kV = kK + kDqStages * kTile;    // ring
  static constexpr int kBar = kV + kDqStages * kTile;  // full, empty, once
  static constexpr int kBytes = kBar + (2 * kDqStages + 1) * 8 + 1024;
};

template <int D>
struct DkvSmem {
  static constexpr int kTile = kRows * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;                  // ring
  static constexpr int kO = kQ + kDkvStages * kTile;     // ring
  static constexpr int kP = kO + kDkvStages * kTile;     // ring, p^T fp32
  static constexpr int kLse = kP + kDkvStages * kRows * kRows * 4;  // ring
  static constexpr int kCorr = kLse + kDkvStages * kRows * 4;  // ring
  static constexpr int kBar = kCorr + kDkvStages * kRows * 4;
  static constexpr int kBytes = kBar + (2 * kDkvStages + 1) * 8 + 1024;
};

// A consumer warp is done with a stage of the ring (every warp of both
// consumers arrives).
__device__ __forceinline__ void release(uint32_t empty, int st, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + 8 * st);
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * kWg) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * kWg) : "memory");
}

// ----------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_o,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ glse, bf16* __restrict__ dq,
             Shape sh) {
  using L = DqSmem<D>;
  constexpr int KD = D / 16;  // k-slices over D
  extern __shared__ __align__(16) unsigned char dq_smem[];
  const uint32_t base = (smem_u32(dq_smem) + 1023) & ~1023u;
  const uint32_t full = base + L::kBar;
  const uint32_t empty = full + 8 * kDqStages;
  const uint32_t once = empty + 8 * kDqStages;

  const int S = sh.S, H = sh.H;
  // the q tiles of one head are neighbours in the launch order, so the
  // K/V tiles they all read stay in L2; heaviest causal tiles (the last)
  // first
  const int h = blockIdx.y, b = blockIdx.z;
  const int qt = sh.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBlockRows;
  const int kvh = h / (H / sh.KV);
  const int nk = (S + kRows - 1) / kRows;
  const int n_k = sh.causal ? min(nk, (q0 + kBlockRows) / kRows) : nk;
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 4);  // one arrival per consumer warp
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (threadIdx.x == 2 * kWg) {
      mbar_arrive_tx(once, 2 * kBlockRows * D * 2);
      tma_tile<D>(base + L::kQ, &tm_q, once, h, q0, b, kBlockRows);
      tma_tile<D>(base + L::kO, &tm_o, once, h, q0, b, kBlockRows);
      for (int it = 0; it < n_k; ++it) {
        const int st = it % kDqStages;
        mbar_wait(empty + 8 * st, ((it / kDqStages) & 1) ^ 1);
        mbar_arrive_tx(full + 8 * st, 2 * kRows * D * 2);
        tma_tile<D>(base + L::kK + st * kRows * D * 2, &tm_k, full + 8 * st,
                    kvh, it * kRows, b, kRows);
        tma_tile<D>(base + L::kV + st * kRows * D * 2, &tm_v, full + 8 * st,
                    kvh, it * kRows, b, kRows);
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
  const int64_t voff = (static_cast<int64_t>(b) * H + h) * S;
  const float sl2 = sh.scale * kLog2e;
  float r_lse[2], r_corr[2];  // lse (log2 units) and glse - delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < S;
    r_lse[i] = in ? lse[voff + row[i]] * kLog2e : 0.f;
    r_corr[i] = in ? (glse != nullptr ? glse[voff + row[i]] : 0.f) -
                         delta[voff + row[i]]
                   : 0.f;
  }
  // the last key a row may see (-1: none)
  int last[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    last[i] = row[i] < S ? (sh.causal ? min(row[i], S - 1) : S - 1) : -1;
  }
  float acc[D / 2];
  zero(acc);
  mbar_wait(once, 0);

  for (int it = 0; it < n_k; ++it) {
    const int st = it % kDqStages;
    const int k0 = it * kRows;
    mbar_wait(full + 8 * st, (it / kDqStages) & 1);
    if (sh.causal && k0 > r_wg + kRows - 1) {
      // the mask hides the whole tile (warpgroup 0's last one)
      release(empty, st, lane);
      continue;
    }
    const uint32_t sK = base + L::kK + st * kRows * D * 2;
    const uint32_t sV = base + L::kV + st * kRows * D * 2;
    float s[32], dp[32];
    zero(s);
    zero(dp);
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      wgmma_ss_n64(s, desc_k<kBlockRows>(base + L::kQ, wg * kRows, kk),
                   desc_k<kRows>(sK, 0, kk), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      wgmma_ss_n64(dp, desc_k<kBlockRows>(base + L::kO, wg * kRows, kk),
                   desc_k<kRows>(sV, 0, kk), kk > 0);
    }
    wgmma_commit();
    // p = exp(s - lse) while the dp product runs; a tile inside the
    // causal triangle and the sequence needs no mask
    wgmma_wait<1>();
    reg_fence(s);
    if ((sh.causal && k0 + kRows - 1 > r_wg) || k0 + kRows > S ||
        r_wg + kRows > S) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, x = 4 * j + e;
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const float p = ex2(s[x] * sl2 - r_lse[i]);
          s[x] = col <= last[i] ? p : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        s[x] = ex2(s[x] * sl2 - r_lse[(x >> 1) & 1]);
      }
    }
    // ds = p (dp - delta + glse) scale (p is 0 where masked)
    wgmma_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      s[x] = s[x] * (dp[x] + r_corr[(x >> 1) & 1]) * sh.scale;
    }
    // dq += ds K, ds as the bf16 A operand in registers
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(acc, a[kk], desc_mn<kRows>(sK, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    release(empty, st, lane);
  }

  const int64_t qs = static_cast<int64_t>(H) * D;
  bf16* dqb = dq + static_cast<int64_t>(b) * S * qs + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] < S) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dqb + row[i] * qs + j * 8 + 2 * t) =
            pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// -------------------------------------------------------------- dK/dV

// p^T of one q tile goes from the dV warpgroup to the dK one through
// shared memory in the accumulator layout: thread i of the warpgroup
// keeps its elements 4 j..4 j + 3 at float4 [j][i], so a warp reads and
// writes 512 contiguous bytes.  A named barrier per stage orders the two.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_o,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ glse, bf16* __restrict__ dk,
              bf16* __restrict__ dv, Shape sh) {
  using L = DkvSmem<D>;
  constexpr int KD = D / 16;
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  const uint32_t base = (smem_u32(dkv_smem) + 1023) & ~1023u;
  unsigned char* gbase = dkv_smem + (base - smem_u32(dkv_smem));
  float* s_lse = reinterpret_cast<float*>(gbase + L::kLse);
  float* s_corr = reinterpret_cast<float*>(gbase + L::kCorr);
  float* s_p = reinterpret_cast<float*>(gbase + L::kP);
  const uint32_t full = base + L::kBar;
  const uint32_t empty = full + 8 * kDkvStages;
  const uint32_t once = empty + 8 * kDkvStages;

  const int S = sh.S, H = sh.H, KV = sh.KV;
  const int G = H / KV;
  // the k tiles of one KV head are neighbours in the launch order, so the
  // Q/dO tiles they all read stay in L2; heaviest causal tiles (the
  // first) first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kRows;
  const int nq = (S + kRows - 1) / kRows;
  const int qt0 = sh.causal ? k0 / kRows : 0;  // the diagonal tile on
  const int per_head = nq - qt0;
  const int n_it = G * per_head;
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full + 8 * s, 32);      // the producer warp's lanes
      mbar_init(empty + 8 * s, 2 * 4);  // one arrival per consumer warp
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    const int lane = threadIdx.x - 2 * kWg;
    if (lane == 0) {
      mbar_arrive_tx(once, 2 * kRows * D * 2);
      tma_tile<D>(base + L::kK, &tm_k, once, kvh, k0, b, kRows);
      tma_tile<D>(base + L::kV, &tm_v, once, kvh, k0, b, kRows);
    }
    // lse and glse - delta of rows lane, lane + 32 of a q tile, read one
    // tile ahead so that their latency hides behind the wait
    float nl[2], nc[2];
    auto fetch = [&](int it) {
      const int h = kvh * G + it / per_head;
      const int q0 = (qt0 + it % per_head) * kRows;
      const int64_t voff = (static_cast<int64_t>(b) * H + h) * S;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q0 + lane + 32 * i;
        const bool in = r < S;
        nl[i] = in ? lse[voff + r] * kLog2e : 0.f;
        nc[i] = in ? (glse != nullptr ? glse[voff + r] : 0.f) -
                         delta[voff + r]
                   : 0.f;
      }
    };
    fetch(0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kDkvStages;
      const int h = kvh * G + it / per_head;
      const int q0 = (qt0 + it % per_head) * kRows;
      mbar_wait(empty + 8 * st, ((it / kDkvStages) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s_lse[st * kRows + lane + 32 * i] = nl[i];
        s_corr[st * kRows + lane + 32 * i] = nc[i];
      }
      if (it + 1 < n_it) fetch(it + 1);
      if (lane == 0) {
        mbar_arrive_tx(full + 8 * st, 2 * kRows * D * 2);
        tma_tile<D>(base + L::kQ + st * kRows * D * 2, &tm_q,
                    full + 8 * st, h, q0, b, kRows);
        tma_tile<D>(base + L::kO + st * kRows * D * 2, &tm_o,
                    full + 8 * st, h, q0, b, kRows);
      } else {
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  // consumers: both own the k tile's 64 keys; warpgroup 0 sums dV,
  // warpgroup 1 dK
  const int tid = threadIdx.x % kWg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float sl2 = sh.scale * kLog2e;
  // the first q row a key may see (S: none)
  int first[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    first[i] = key[i] < S ? (sh.causal ? key[i] : 0) : S;
  }
  float acc[D / 2];  // dv or dk rows key[0], key[1]
  zero(acc);
  mbar_wait(once, 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kDkvStages;
    const int q0 = (qt0 + it % per_head) * kRows;
    mbar_wait(full + 8 * st, (it / kDkvStages) & 1);
    const uint32_t sQ = base + L::kQ + st * kRows * D * 2;
    const uint32_t sO = base + L::kO + st * kRows * D * 2;
    float4* p_t = reinterpret_cast<float4*>(s_p) + st * 8 * kWg + tid;
    // x^T = K Q^T (dV side) or V dO^T (dK side): rows are the keys
    float x[32];
    zero(x);
    reg_fence(x);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      wgmma_ss_n64(x, desc_k<kRows>(base + (wg == 0 ? L::kK : L::kV), 0, kk),
                   desc_k<kRows>(wg == 0 ? sQ : sO, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(x);
    if (wg == 0) {
      // p^T, handed to the dK side through shared memory
      const float* lse_t = s_lse + st * kRows;
      const bool edge = (sh.causal && q0 < k0 + kRows - 1) ||
                        q0 + kRows > S || k0 + kRows > S;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_t + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, y = 4 * j + e;
          const int qrow = q0 + j * 8 + 2 * t + (e & 1);
          const float p = ex2(x[y] * sl2 - ((e & 1) ? l2.y : l2.x));
          x[y] = !edge || (qrow >= first[i] && qrow < S) ? p : 0.f;
        }
        p_t[j * kWg] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2],
                                   x[4 * j + 3]);
      }
      named_arrive(1 + st);
    } else {
      // ds^T = p^T (dp^T - delta + glse) scale (p is 0 where masked)
      const float* corr_t = s_corr + st * kRows;
      named_sync(1 + st);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 c2 =
            *reinterpret_cast<const float2*>(corr_t + j * 8 + 2 * t);
        const float4 p4 = p_t[j * kWg];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = 4 * j + e;
          x[y] = p[e] * (x[y] + ((e & 1) ? c2.y : c2.x)) * sh.scale;
        }
      }
    }
    // dv += p^T dO or dk += ds^T Q, p^T / ds^T as the bf16 A operand
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], x, kk);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(acc, a[kk], desc_mn<kRows>(wg == 0 ? sO : sQ, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    release(empty, st, lane);
  }

  bf16* out = wg == 0 ? dv : dk;
  const int64_t ks = static_cast<int64_t>(KV) * D;
  const int64_t koff = static_cast<int64_t>(b) * S * ks + kvh * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] < S) {
      const int64_t off = koff + key[i] * ks;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + off + j * 8 + 2 * t) =
            pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ----------------------------------------------------------- dispatch

// The four tensor maps of a backward kernel: q and dO with `q_rows`-row
// boxes, k and v with `k_rows`-row boxes.
bool bwd_maps(CUtensorMap (&m)[4], const void* q, const void* dout,
              const void* k, const void* v, int B, const Shape& sh, int D,
              int q_rows, int k_rows) {
  return tensor_map(&m[0], q, B, sh.S, sh.H, D, q_rows) &&
         tensor_map(&m[1], dout, B, sh.S, sh.H, D, q_rows) &&
         tensor_map(&m[2], k, B, sh.S, sh.KV, D, k_rows) &&
         tensor_map(&m[3], v, B, sh.S, sh.KV, D, k_rows);
}

// The FMA kernels' dynamic shared memory (fp32): dQ holds Q, dO, K, V
// tiles and one score tile; dK/dV the same tiles and two (p and ds); both
// the rows' lse and correction.
constexpr int dq_fma_smem(int D) {
  return (4 * kT * (D + 1) + kT * kSL + 2 * kT) * 4;
}
constexpr int dkv_fma_smem(int D) {
  return (4 * kT * (D + 1) + 2 * kT * kSL + 2 * kT) * 4;
}

template <typename T, int D>
cudaError_t dq_fma_launch(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const float* glse, void* dq,
                          int B, Shape sh, cudaStream_t st) {
  static bool done = false;
  const size_t smem = dq_fma_smem(D);
  cudaError_t e = allow_smem(dq_fma<T, D>, smem, done);
  if (e != cudaSuccess) return e;
  dq_fma<T, D><<<dim3(tiles(sh.S, kT), sh.H, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      glse, static_cast<T*>(dq), sh);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkv_fma_launch(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const float* glse, void* dk,
                           void* dv, int B, Shape sh, cudaStream_t st) {
  static bool done = false;
  const size_t smem = dkv_fma_smem(D);
  cudaError_t e = allow_smem(dkv_fma<T, D>, smem, done);
  if (e != cudaSuccess) return e;
  dkv_fma<T, D><<<dim3(tiles(sh.S, kT), sh.KV, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      glse, static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return cudaGetLastError();
}

// bf16 at D = 64 and 128: the wgmma kernels; bf16 at D = 16 and 32 and
// fp32 at every D: the FMA kernels.
template <int D>
cudaError_t dq_launch(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* glse, void* dq, int B, Shape sh,
                      int dtype, cudaStream_t st) {
  if (dtype == 0) {
    return dq_fma_launch<float, D>(q, k, v, dout, lse, delta, glse, dq, B,
                                   sh, st);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (D < 64) {
    return dq_fma_launch<bf16, D>(q, k, v, dout, lse, delta, glse, dq, B,
                                  sh, st);
  } else {
    CUtensorMap m[4];
    if (!bwd_maps(m, q, dout, k, v, B, sh, D, kBlockRows, kRows)) {
      return cudaErrorInvalidValue;
    }
    static bool done = false;
    const size_t smem = DqSmem<D>::kBytes;
    cudaError_t e = allow_smem(dq_wgmma<D>, smem, done);
    if (e != cudaSuccess) return e;
    dq_wgmma<D><<<dim3(tiles(sh.S, kBlockRows), sh.H, B), kHopperThreads,
                  smem, st>>>(m[0], m[1], m[2], m[3], lse, delta, glse,
                              static_cast<bf16*>(dq), sh);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t dkv_launch(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, const float* glse, void* dk,
                       void* dv, int B, Shape sh, int dtype,
                       cudaStream_t st) {
  if (dtype == 0) {
    return dkv_fma_launch<float, D>(q, k, v, dout, lse, delta, glse, dk, dv,
                                    B, sh, st);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (D < 64) {
    return dkv_fma_launch<bf16, D>(q, k, v, dout, lse, delta, glse, dk, dv,
                                   B, sh, st);
  } else {
    CUtensorMap m[4];
    if (!bwd_maps(m, q, dout, k, v, B, sh, D, kRows, kRows)) {
      return cudaErrorInvalidValue;
    }
    static bool done = false;
    const size_t smem = DkvSmem<D>::kBytes;
    cudaError_t e = allow_smem(dkv_wgmma<D>, smem, done);
    if (e != cudaSuccess) return e;
    dkv_wgmma<D><<<dim3(tiles(sh.S, kRows), sh.KV, B), kHopperThreads,
                   smem, st>>>(m[0], m[1], m[2], m[3], lse, delta, glse,
                               static_cast<bf16*>(dk),
                               static_cast<bf16*>(dv), sh);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dk, dv, dq share it);
// lse, delta, glse fp32 [B, H, S], glse may be null (no lse cotangent),
// delta = rowsum(dO * O).  D: 16, 32, 64 or 128.  causal: 0 or 1.
int dl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* glse, void* dk, void* dv, int B, int S,
                     int H, int KV, int D, float scale, int causal,
                     int dtype, void* stream) {
  if (bad_shape(B, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{S, H, KV, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* gl = static_cast<const float*>(glse);
  switch (D) {
    case 16:
      return dkv_launch<16>(q, k, v, dout, l, dl, gl, dk, dv, B, sh, dtype,
                            st);
    case 32:
      return dkv_launch<32>(q, k, v, dout, l, dl, gl, dk, dv, B, sh, dtype,
                            st);
    case 64:
      return dkv_launch<64>(q, k, v, dout, l, dl, gl, dk, dv, B, sh, dtype,
                            st);
    case 128:
      return dkv_launch<128>(q, k, v, dout, l, dl, gl, dk, dv, B, sh, dtype,
                             st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dl_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* glse, void* dq, int B, int S, int H, int KV,
                    int D, float scale, int causal, int dtype,
                    void* stream) {
  if (bad_shape(B, S, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{S, H, KV, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* gl = static_cast<const float*>(glse);
  switch (D) {
    case 16:
      return dq_launch<16>(q, k, v, dout, l, dl, gl, dq, B, sh, dtype, st);
    case 32:
      return dq_launch<32>(q, k, v, dout, l, dl, gl, dq, B, sh, dtype, st);
    case 64:
      return dq_launch<64>(q, k, v, dout, l, dl, gl, dq, B, sh, dtype, st);
    case 128:
      return dq_launch<128>(q, k, v, dout, l, dl, gl, dq, B, sh, dtype, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory of one bf16 block (dkv: 1 for dK/dV, 0 for
// dQ; the wgmma kernels at D = 64 and 128, the FMA kernels at 16 and 32),
// for the build report; -1 for a D the kernels do not take.
int dl_flash_bwd_smem(int dkv, int D) {
  switch (D) {
    case 16:
    case 32: return dkv ? dkv_fma_smem(D) : dq_fma_smem(D);
    case 64: return dkv ? DkvSmem<64>::kBytes : DqSmem<64>::kBytes;
    case 128: return dkv ? DkvSmem<128>::kBytes : DqSmem<128>::kBytes;
    default: return -1;
  }
}

const char* dl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
