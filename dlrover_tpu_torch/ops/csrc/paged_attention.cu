// Paged GQA attention for Hopper (sm_90a), fp32 and bf16: one-token
// decode (B5) and the K-step speculative verify window (B6).
//
// Replaces the TPU kernels
//   dlrover_tpu/ops/paged_kernels.py:_decode_kernel  (paged_decode_kernel)
//   dlrover_tpu/ops/paged_kernels.py:_verify_kernel  (paged_verify_kernel)
// Both compute softmax(q k^T * D^-1/2) v over a lane's paged prefix with
// fp32 logits, an online softmax (running m, l, acc in fp32) and one cast
// at the end.  Pools are one layer's [num_blocks, block_size, KV, D];
// block tables [B, MB] int32.
//
//   decode: q [B, H, D], seq_lens [B]: key t is visible iff t < seq_len;
//           seq_len == 0 gives exact zeros.
//   verify: q [B, C, H, D], positions [B]: query row c of lane b sits at
//           positions[b] + c and sees keys t <= positions[b] + c.  The
//           window's own K/V is already in the pool; the pool is only
//           read.
// A lane's G = H / KV query heads share its pages (C * G rows for verify;
// row r is window offset r / G, head h * G + r % G); query head h reads KV
// head h / G.
//
// What bounds it on the card: bytes.  Each visible K and V row is read
// once (2 * seq_len * KV * D elements per lane) for about 2 * group
// multiply-adds per element read, orders of magnitude below the ridge.
// So the design is about keeping many independent row loads in flight
// and spending few instructions between them.
//
// Both kernels cut each lane's visible pages into splits of `pages` pages
// (about 128 keys; the host sizes them from bs and the grid from the
// table width MB, so it never reads the lengths or positions), run one
// block of 128 threads per (KV head, split, lane), heads the fastest
// launch index, and return at once from a block whose split starts past
// the lane's end.  Each split writes its fp32 partial (m, l, acc) to a
// workspace that the caller allocates; merge_splits combines the splits
// of each (lane, head, row) in split order.  No atomics: the kernels are
// deterministic.
//
// Decode (dl_paged_decode, split-KV).  The first design ran one block per
// (lane, KV head) over all of the lane's pages: 16 x 32 = 512 blocks at
// the serving shape, each as long as its lane's chain of pages, with
// plain loads (25 % of the byte bound).  Here the block carries the G
// query rows of its KV head (G = 1 at Llama-2-7B, MHA), and its four warps
// take the split's keys in chunks of 4 (2 at 1 KB rows), in turn.  Each
// warp streams its chunks by cp.async (16 bytes) through its own ring of 2
// stages in shared memory, so it needs only __syncwarp, never a block
// barrier, in its loop.  Small chunks and short rings keep a block at
// 16 KB of shared memory and 48 registers a thread, so ~10 blocks share an
// SM: at the serving shape that beat 8-key chunks in 3-stage rings (4
// blocks an SM) by ~10 % (scripts/torch_paged_decode_variants.py).  The
// kLpk lanes on a key (32 from D = 64 on, D / 2 below, so a warp takes 2
// or 4 keys at once at D = 32 or 16) each hold D / kLpk of its dims; a
// score is their shuffle sum, the online softmax (log2 units, q
// pre-scaled by D^-1/2 log2 e) keeps one max per warp, and p v lands in
// the lane's dims of each row's sum.  The warps' states meet
// in shared memory at the split's end and are merged in warp order.
//
// Verify (dl_paged_verify, split-KV).  The first design ran it through
// the first decode body: one block per (lane, KV head), so the call
// lasted as long as the longest lane's serial chain of pages, and it
// re-read every page once per 4 query rows.  Here each lane's visible
// pages, (pos + C - 1) / bs + 1 of them, are cut into splits, and a block
// carries every one of the lane's C * G rows (up to 8, or 32 per block
// when there are more, further rows taking further blocks) in one pass
// over its pages.  K and V rows stream by cp.async (16 bytes) into a
// ring of 2 steps of 32 keys (16 at 1 KB rows) in shared memory, rows
// padded by 16 bytes so that neighbouring rows start in other banks.
// Per step:
//   scores: a thread takes 2 rows x 4 keys over a part of D, so each q
//     and K chunk it reads serves several products (shared-memory
//     traffic, not the loads, bounded the first version); the parts are
//     summed by shuffles;
//   the online softmax in log2 units (q pre-scaled by D^-1/2 log2 e),
//     one group of 32 (16) lanes per row;
//   acc += p v: a thread takes 4 dims of 2 rows over every ks-th key,
//     the key groups' sums added in group order at the end.
// A page past the lane's end, the null block behind an inactive lane's
// padding and the rows of the last page past the horizon are never
// loaded, and a masked key never enters the softmax (it is skipped, not
// weighted by 0), so garbage or NaN there cannot reach the output.  The
// output is acc / max(l, 1e-30): exact zeros for a lane with no key.
//
// Offsets into the pool are 64-bit: at Llama-2-7B with 2049 blocks one
// layer holds 134M elements and the stacked pool 4.3G.  The TPU kernel's
// tuning knobs (kv_span, q_rows) have no counterpart here.  D must be 16,
// 32, 64, 128 or 256 and every row 16-byte aligned (the wrappers check;
// at D = 16 a bf16 row is 32 bytes, two copies).
//
// C interface (ctypes): each entry returns cudaGetLastError() after its
// launches.  The caller allocates the output and the workspace; the
// kernels launch on `stream` and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// N consecutive elements at p as floats, in vector loads of at most 16
// bytes (p aligned to min(N * sizeof(T), 16)).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kPer =
      N * sizeof(T) > 16 ? 16 / static_cast<int>(sizeof(T)) : N;
#pragma unroll
  for (int j = 0; j < N; j += kPer) {
    const Vec<T, kPer> x = *reinterpret_cast<const Vec<T, kPer>*>(p + j);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[j + i] = to_f(x.v[i]);
  }
}

// ============================================ verify, split-KV (B6)

constexpr int kVerifyThreads = 128;
constexpr int kVerifyStages = 2;  // steps in the ring (1 loading, 1 in use)

// The shape of one call (decode: C = 1).
struct Paged {
  int C, H, KV, bs, MB, pages;
  float scale;
};

// A verify block's constants and shared memory: the ring of K/V steps,
// then q (fp32, pre-scaled), the step's scores (then p), the rows'
// running max, sum and rescale factor, the split's table entries.
// MR: the most query rows one block carries (8, or 32 with further row
// groups as further blocks).
template <typename T, int D, int MR>
struct VerifyCfg {
  static constexpr int kKeys = D * sizeof(T) >= 1024 ? 16 : 32;  // a step
  static constexpr int kSlots = kVerifyThreads / kKeys;  // rows at once
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunks = D / kVec;  // 16-byte chunks of a row
  static constexpr int kRow = D * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kStage = 2 * kKeys * kRow;  // K rows, then V rows
  static constexpr int kQ = kVerifyStages * kStage;
  static constexpr int kScores = MR * kKeys;
  static int bytes(int rows, int pages) {
    return kQ + (rows * D + kScores + 3 * MR) * 4 + pages * 4;
  }
};

// 16 bytes of T at p (shared memory) as floats
__device__ __forceinline__ void load16(const unsigned char* p,
                                       float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load16(const unsigned char* p,
                                       float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 4 elements at p (shared memory) as floats
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 c =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = c.x;
  x[3] = c.y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async the K and V rows of keys [key0, key0 + nk) of a split (key
// offsets within the split; pages from the split's table entries in
// s_tab) into a stage: kKeys K rows, then kKeys V rows, `pitch` bytes
// apart, 16 bytes a copy.  The `n` threads from `t` share the copies;
// keys past nk are never loaded.
template <typename T, int D, int kKeys>
__device__ __forceinline__ void stage_rows(
    uint32_t stage, int pitch, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* s_tab, int key0, int nk,
    int bs, int64_t tok_stride, int h, int t, int n) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = D / kVec;  // 16-byte chunks of a row
  for (int i = t; i < 2 * kKeys * kChunks; i += n) {
    const int kv = i / (kKeys * kChunks);
    const int u = (i / kChunks) % kKeys;
    const int c = i % kChunks;
    if (u < nk) {
      const int key = key0 + u;
      const int page = key / bs;
      const int64_t row =
          static_cast<int64_t>(s_tab[page]) * bs + (key - page * bs);
      const T* src = (kv ? v_pool : k_pool) + row * tok_stride +
                     static_cast<int64_t>(h) * D + c * kVec;
      cp_async16(stage + (kv * kKeys + u) * pitch + c * 16, src);
    }
  }
}

// max and sum over the W lanes of an aligned group (W = 16 or 32)
template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, W));
  }
  return v;
}

template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o, W);
  }
  return v;
}

// Grid (KV head + KV * row group, split, lane): the heads are the fastest
// launch index, so the blocks that read one page's rows (KV * D elements
// each, one head's D after another) run together and their reads of a
// row meet in the same DRAM pages.  The partials of row r of (lane b, KV
// head h, split s) are at ((b * KV + h) * splits + s) * R + r.
template <typename T, int D, int MR>
__global__ void __launch_bounds__(kVerifyThreads)
    verify_split(const T* __restrict__ q, const T* __restrict__ k_pool,
                 const T* __restrict__ v_pool, const int* __restrict__ tables,
                 const int* __restrict__ positions, float* __restrict__ ws_m,
                 float* __restrict__ ws_l, float* __restrict__ ws_acc,
                 Paged vs) {
  using L = VerifyCfg<T, D, MR>;
  constexpr int kKeys = L::kKeys, kSlots = L::kSlots;
  constexpr int kVec = L::kVec, kChunks = L::kChunks;
  constexpr int kNdt = D / 4;                 // threads on one row in p v
  constexpr int kTr = kVerifyThreads / kNdt;  // such rows of threads
  constexpr int kPairs = (MR / 2 + kTr - 1) / kTr;  // row pairs a thread
  extern __shared__ __align__(16) unsigned char vsmem[];

  const int C = vs.C, H = vs.H, KV = vs.KV, bs = vs.bs;
  const int G = H / KV;
  const int R = C * G;
  const int h = blockIdx.x % KV, split = blockIdx.y, b = blockIdx.z;
  const int r0 = (blockIdx.x / KV) * MR;
  const int nr = min(MR, R - r0);
  const int pos = positions[b];
  const int horizon = pos + C - 1;  // last key any row may see
  const int n_pages = horizon < 0 ? 0 : min(horizon / bs + 1, vs.MB);
  const int p0 = split * vs.pages;
  if (p0 >= n_pages) return;  // past the lane's horizon
  const int n_tab = min(p0 + vs.pages, n_pages) - p0;
  const int k_begin = p0 * bs;
  const int k_end = min((p0 + n_tab) * bs, horizon + 1);
  const int n_steps = (k_end - k_begin + kKeys - 1) / kKeys;
  const int tid = threadIdx.x;
  const int64_t tok_stride = static_cast<int64_t>(KV) * D;
  const uint32_t ring = smem_u32(vsmem);
  float* s_q = reinterpret_cast<float*>(vsmem + L::kQ);
  float* s_sc = s_q + nr * D;
  float* s_m = s_sc + L::kScores;
  float* s_l = s_m + MR;
  float* s_alpha = s_l + MR;
  int* s_tab = reinterpret_cast<int*>(s_alpha + MR);

  // the split's table entries, the rows' state and q (pre-scaled so the
  // scores are in log2 units): every global read of the block up front
  const int* table = tables + static_cast<int64_t>(b) * vs.MB + p0;
  for (int j = tid; j < n_tab; j += kVerifyThreads) s_tab[j] = table[j];
  if (tid < nr) {
    s_m[tid] = -1e30f;
    s_l[tid] = 0.f;
  }
  const float sl2 = vs.scale * 1.4426950408889634f;
  for (int i = tid; i < nr * D; i += kVerifyThreads) {
    const int r = r0 + i / D;
    const int c = r / G;
    const int64_t qi =
        ((static_cast<int64_t>(b) * C + c) * H + h * G + (r - c * G)) * D +
        i % D;
    s_q[i] = to_f(q[qi]) * sl2;
  }
  __syncthreads();

  // K and V rows of step `it` into its stage; keys past k_end are never
  // loaded
  auto issue = [&](int it) {
    const int key0 = it * kKeys;  // within the split
    stage_rows<T, D, kKeys>(ring + (it % kVerifyStages) * L::kStage, L::kRow,
                            k_pool, v_pool, s_tab, key0,
                            min(kKeys, k_end - k_begin - key0), bs,
                            tok_stride, h, tid, kVerifyThreads);
  };

#pragma unroll
  for (int it = 0; it < kVerifyStages - 1; ++it) {
    if (it < n_steps) issue(it);
    cp_async_commit();
  }

  // score phase: a thread takes 2 rows x 4 keys over the chunks part,
  // part + np, ... of D, so each q and K chunk it loads serves 4 or 2
  // products; the np parts of an item are adjacent lanes, summed by
  // shuffles.  Every thread runs the loop (a spare one on a clamped
  // item), so the shuffles see whole warps.
  constexpr int kQuads = kKeys / 4;
  const int items = (nr + 1) / 2 * kQuads;
  int np = 1;
  while (np * 2 * items <= kVerifyThreads && np * 2 <= kChunks) np *= 2;
  const bool scorer = tid < items * np;
  const int item = (tid / np) % items, part = tid % np;
  const int ra = item / kQuads * 2, kq = item % kQuads;
  const int rb = min(ra + 1, nr - 1);
  const int u_t = tid % kKeys;
  const int slot = tid / kKeys;
  // p v phase: a thread takes 4 dims of 2 rows (each V element it loads
  // serves both) over every ks-th key of a step; the ks key groups'
  // partial sums are added in group order at the end
  const int pairs = (nr + 1) / 2;
  int ks = 1;
  while (ks * 2 * pairs <= kTr && ks * 2 <= kKeys) ks *= 2;
  const int d0 = (tid % kNdt) * 4;
  const int kg = tid / kNdt % ks;
  const int rp0 = tid / kNdt / ks, rp_step = kTr / ks;
  float acc[kPairs][2][4];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][0][e] = acc[k][1][e] = 0.f;
  }

  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait<kVerifyStages - 2>();
    __syncthreads();  // step it has landed; step it - 1's stage is free
    if (it + kVerifyStages - 1 < n_steps) issue(it + kVerifyStages - 1);
    cp_async_commit();
    const int key0 = k_begin + it * kKeys;
    const int nk = min(kKeys, k_end - key0);
    const unsigned char* stage = vsmem + (it % kVerifyStages) * L::kStage;

    // scores (a key past a row's horizon is computed on stale shared
    // memory and masked below, never used)
    {
      const unsigned char* kr = stage + kq * 4 * L::kRow;
      const float* qa = s_q + ra * D;
      const float* qb = s_q + rb * D;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int c = part; c < kChunks; c += np) {
        float kx[4][kVec];
#pragma unroll
        for (int j = 0; j < 4; ++j) load16(kr + j * L::kRow + c * 16, kx[j]);
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          float xa[4], xb[4];
          load4(qa + c * kVec + e, xa);
          load4(qb + c * kVec + e, xb);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              sc[0][j] += xa[i] * kx[j][e + i];
              sc[1][j] += xb[i] * kx[j][e + i];
            }
          }
        }
      }
      for (int o = 1; o < np; o <<= 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[0][j] += __shfl_xor_sync(0xffffffffu, sc[0][j], o);
          sc[1][j] += __shfl_xor_sync(0xffffffffu, sc[1][j], o);
        }
      }
      if (scorer && part == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s_sc[ra * kKeys + kq * 4 + j] = sc[0][j];
          if (ra + 1 < nr) s_sc[(ra + 1) * kKeys + kq * 4 + j] = sc[1][j];
        }
      }
    }
    __syncthreads();

    // online softmax, kKeys lanes per row (the row loop is uniform per
    // warp, so the shuffles see every lane): a masked key is skipped
    // (p = 0, never exp'd); a NaN score still reaches l and acc
    for (int r_base = 0; r_base < nr; r_base += kSlots) {
      const int r = r_base + slot;
      const bool live = r < nr;
      const int nv =
          live ? max(0, min(nk, pos + (r0 + r) / G - key0 + 1)) : 0;
      const float x = u_t < nv ? s_sc[r * kKeys + u_t] : -INFINITY;
      const float mx = group_max<kKeys>(x);
      const float m_old = live ? s_m[r] : 0.f;
      const float m_new = fmaxf(m_old, mx);
      const float p = u_t < nv ? exp2f(x - m_new) : 0.f;
      const float psum = group_sum<kKeys>(p);
      if (live) {
        s_sc[r * kKeys + u_t] = p;
        if (u_t == 0) {
          const float alpha = exp2f(m_old - m_new);
          s_alpha[r] = alpha;
          s_l[r] = s_l[r] * alpha + psum;
          s_m[r] = m_new;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v over the rows' visible keys of the step
    const unsigned char* vrows = stage + kKeys * L::kRow;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int ra = (rp0 + k * rp_step) * 2;
      if (ra >= nr) continue;
      const int rb = min(ra + 1, nr - 1);
      const float al[2] = {s_alpha[ra], s_alpha[rb]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[k][0][e] *= al[0];
        acc[k][1][e] *= al[1];
      }
      // row ra + 1 sees at least the keys row ra sees; a key row ra may
      // not see is skipped for it, not weighted by 0
      const int nva = max(0, min(nk, pos + (r0 + ra) / G - key0 + 1));
      const int nvb = max(0, min(nk, pos + (r0 + rb) / G - key0 + 1));
      const float* pa = s_sc + ra * kKeys;
      const float* pb = s_sc + rb * kKeys;
      for (int u = kg; u < nvb; u += ks) {
        float vx[4];
        load4(reinterpret_cast<const T*>(vrows + u * L::kRow) + d0, vx);
        const float p1 = pb[u];
        if (u < nva) {
          const float p0 = pa[u];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[k][0][e] += p0 * vx[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][1][e] += p1 * vx[e];
      }
    }
  }
  cp_async_wait<0>();

  // this split's partial state; the key groups' sums meet in the (now
  // idle) ring, added in group order
  const int64_t row0 =
      ((static_cast<int64_t>(b) * KV + h) * gridDim.y + split) * R + r0;
  if (tid < nr) {
    ws_m[row0 + tid] = s_m[tid];
    ws_l[row0 + tid] = s_l[tid];
  }
  float* s_part = reinterpret_cast<float*>(vsmem);  // [ks][nr][D]
  __syncthreads();  // every thread is done with the ring
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int ra = (rp0 + k * rp_step) * 2;
    if (ra >= nr || kg == 0) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (ra + i < nr) {
        *reinterpret_cast<float4*>(s_part + (kg * nr + ra + i) * D + d0) =
            make_float4(acc[k][i][0], acc[k][i][1], acc[k][i][2],
                        acc[k][i][3]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int ra = (rp0 + k * rp_step) * 2;
    if (ra >= nr || kg != 0) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (ra + i >= nr) continue;
      float o[4] = {acc[k][i][0], acc[k][i][1], acc[k][i][2], acc[k][i][3]};
      for (int g = 1; g < ks; ++g) {
        float x[4];
        load4(s_part + (g * nr + ra + i) * D + d0, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] += x[e];
      }
      *reinterpret_cast<float4*>(ws_acc + (row0 + ra + i) * D + d0) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// ============================================ decode, split-KV (B5)

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kDecodeStages = 2;  // chunks in a warp's ring

// A decode block's constants.  A step of kKeys keys is cut into one chunk
// of kKpw keys per warp; a warp streams its chunks through its own ring of
// kDecodeStages stages (K rows, then V rows, unpadded: a warp reads whole
// rows).  kLpk lanes share one key, each holding kDpl of its dims (all 32
// lanes from D = 64 on; at D = 16 and 32, 8 and 16 lanes, so a warp takes
// kKpi keys at once).
template <typename T, int D>
struct DecodeCfg {
  static constexpr int kKeys = D * sizeof(T) >= 1024 ? 8 : 16;  // a step
  static constexpr int kKpw = kKeys / kDecodeWarps;
  static constexpr int kLpk = D >= 64 ? 32 : D / 2;
  static constexpr int kDpl = D / kLpk;
  static constexpr int kKpi = 32 / kLpk;
  static constexpr int kIters = kKpw / kKpi;  // key slots of a lane a chunk
  static constexpr int kRow = D * static_cast<int>(sizeof(T));
  static constexpr int kChunk = 2 * kKpw * kRow;
  static constexpr int kWarpRing = kDecodeStages * kChunk;
  static int bytes(int pages) { return kDecodeWarps * kWarpRing + pages * 4; }
};

// Grid (KV head + KV * row group, split, lane), as verify_split.  The block
// carries the MR (or fewer) query rows of its KV head; its four warps
// take the split's keys chunk by chunk in turn (warp w: keys [(j * 4 + w)
// * kKpw, + kKpw) of its j-th chunk), each with its own online softmax.
// Per chunk a lane forms its dot products with its dims of q (registers)
// and of the chunk's K rows (shared memory), the kLpk lanes of a key sum
// them by shuffles, and p v goes into the lane's kDpl dims of each row's
// sum.  At the split's end the warps' states meet in shared memory and
// are merged in warp order into the split's partial.
template <typename T, int D, int MR>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_split(const T* __restrict__ q, const T* __restrict__ k_pool,
                 const T* __restrict__ v_pool, const int* __restrict__ tables,
                 const int* __restrict__ seq_lens, float* __restrict__ ws_m,
                 float* __restrict__ ws_l, float* __restrict__ ws_acc,
                 Paged ps) {
  using L = DecodeCfg<T, D>;
  constexpr int kKpw = L::kKpw, kLpk = L::kLpk, kDpl = L::kDpl;
  constexpr int kKpi = L::kKpi, kIters = L::kIters;
  static_assert(kIters >= 1 && kKpw % kKpi == 0,
                "a warp's chunk is whole sets of the keys it takes at once");
  static_assert(MR * D * 4 <= L::kWarpRing,
                "a warp's partial sums fit its ring");
  extern __shared__ __align__(16) unsigned char dsmem[];
  __shared__ float s_m[kDecodeWarps][MR];
  __shared__ float s_l[kDecodeWarps][MR];

  const int H = ps.H, KV = ps.KV, bs = ps.bs;
  const int G = H / KV;
  const int h = blockIdx.x % KV, split = blockIdx.y, b = blockIdx.z;
  const int r0 = (blockIdx.x / KV) * MR;
  const int nr = min(MR, G - r0);
  const int seq_len = seq_lens[b];
  const int n_pages = seq_len < 1 ? 0 : min((seq_len - 1) / bs + 1, ps.MB);
  const int p0 = split * ps.pages;
  if (p0 >= n_pages) return;  // past the lane's end
  const int n_tab = min(p0 + ps.pages, n_pages) - p0;
  const int n_keys = min(n_tab * bs, seq_len - p0 * bs);  // all visible
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / kLpk;  // the lane's key of each kKpi
  const int dim0 = (lane % kLpk) * kDpl;
  const int64_t tok_stride = static_cast<int64_t>(KV) * D;
  unsigned char* ring = dsmem + warp * L::kWarpRing;
  int* s_tab = reinterpret_cast<int*>(dsmem + kDecodeWarps * L::kWarpRing);

  const int* table = tables + static_cast<int64_t>(b) * ps.MB + p0;
  for (int j = tid; j < n_tab; j += kDecodeThreads) s_tab[j] = table[j];
  // the lane's dims of q, pre-scaled so the scores are in log2 units
  const float sl2 = ps.scale * 1.4426950408889634f;
  float qf[MR][kDpl];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
#pragma unroll
    for (int i = 0; i < kDpl; ++i) qf[r][i] = 0.f;
    if (r < nr) {
      load_row<T, kDpl>(
          q + (static_cast<int64_t>(b) * H + h * G + r0 + r) * D + dim0,
          qf[r]);
#pragma unroll
      for (int i = 0; i < kDpl; ++i) qf[r][i] *= sl2;
    }
  }
  __syncthreads();  // s_tab

  // chunk j of this warp: keys [(j * warps + warp) * kKpw, + kKpw)
  const int first = warp * kKpw;
  const int n_chunks = n_keys <= first ? 0
      : (n_keys - first + kDecodeWarps * kKpw - 1) / (kDecodeWarps * kKpw);
  auto issue = [&](int j) {
    const int key0 = (j * kDecodeWarps + warp) * kKpw;
    stage_rows<T, D, kKpw>(smem_u32(ring + (j % kDecodeStages) * L::kChunk),
                           L::kRow, k_pool, v_pool, s_tab, key0,
                           min(kKpw, n_keys - key0), bs, tok_stride, h, lane,
                           32);
  };
#pragma unroll
  for (int j = 0; j < kDecodeStages - 1; ++j) {
    if (j < n_chunks) issue(j);
    cp_async_commit();
  }

  float m[MR], l[MR], acc[MR][kDpl];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    m[r] = -1e30f;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[r][i] = 0.f;
  }

  for (int j = 0; j < n_chunks; ++j) {
    cp_async_wait<kDecodeStages - 2>();
    __syncwarp();  // chunk j landed for every lane; chunk j - 1's stage free
    if (j + kDecodeStages - 1 < n_chunks) issue(j + kDecodeStages - 1);
    cp_async_commit();
    const int nk = min(kKpw, n_keys - (j * kDecodeWarps + warp) * kKpw);
    const T* rows =
        reinterpret_cast<const T*>(ring + (j % kDecodeStages) * L::kChunk);

    // scores: the lane's part of each of its keys' dots, summed over the
    // key's kLpk lanes (a key past nk: stale shared memory, never used)
    float sc[kIters][MR];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      float kx[kDpl];
      load_row<T, kDpl>(rows + (it * kKpi + grp) * D + dim0, kx);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < kDpl; ++i) x += qf[r][i] * kx[i];
        sc[it][r] = x;
      }
    }
#pragma unroll
    for (int o = kLpk / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          sc[it][r] += __shfl_xor_sync(0xffffffffu, sc[it][r], o);
        }
      }
    }

    // online softmax over the chunk's keys, the max shared by the warp:
    // a key past nk is skipped (never exp'd, never weighted by 0)
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        if (it * kKpi + grp < nk) mx = fmaxf(mx, sc[it][r]);
      }
#pragma unroll
      for (int o = kLpk; o < 32; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < kDpl; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        if (it * kKpi + grp < nk) {
          sc[it][r] = exp2f(sc[it][r] - m_new);
          l[r] += sc[it][r];
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int u = it * kKpi + grp;
      if (u >= nk) continue;
      float vx[kDpl];
      load_row<T, kDpl>(rows + (kKpw + u) * D + dim0, vx);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
#pragma unroll
        for (int i = 0; i < kDpl; ++i) acc[r][i] += sc[it][r] * vx[i];
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();  // the warp is done with its ring

  // the lanes of the kKpi keys summed different keys: add their l and acc
#pragma unroll
  for (int o = kLpk; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int i = 0; i < kDpl; ++i) {
        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], o);
      }
    }
  }
  // the warp's state: (m, l) beside, acc [MR][D] in its own ring
  float* w_acc = reinterpret_cast<float*>(ring);
  if (lane < kLpk) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r < nr) {
#pragma unroll
        for (int i = 0; i < kDpl; ++i) w_acc[r * D + dim0 + i] = acc[r][i];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
  }
  __syncthreads();

  // the split's partial: the warps' states merged in warp order
  const int64_t row0 =
      ((static_cast<int64_t>(b) * KV + h) * gridDim.y + split) * G + r0;
  for (int i = tid; i < nr * D; i += kDecodeThreads) {
    const int r = i / D, d = i - r * D;
    float mx = s_m[0][r];
#pragma unroll
    for (int w = 1; w < kDecodeWarps; ++w) mx = fmaxf(mx, s_m[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float e = exp2f(s_m[w][r] - mx);
      den += s_l[w][r] * e;
      num += reinterpret_cast<const float*>(dsmem + w * L::kWarpRing)[i] * e;
    }
    ws_acc[(row0 + r) * D + d] = num;
    if (d == 0) {
      ws_m[row0 + r] = mx;
      ws_l[row0 + r] = den;
    }
  }
}

// One block per (KV head, lane), for both kernels: every row of the
// lane's window (decode: its G rows) merged over its splits in split
// order, o = acc / max(l, 1e-30); a lane with no key has no active split
// and comes out as exact zeros.  A thread owns 4 dims of a row (16-byte
// loads of the partial sums); the split loops are unrolled so their loads
// are in flight together.  lens_or_pos: seq_lens (decode, C = 1: the last
// key is seq_len - 1) or the windows' first positions (verify).
template <typename T, int D>
__global__ void __launch_bounds__(kVerifyThreads)
    merge_splits(const float* __restrict__ ws_m,
                 const float* __restrict__ ws_l,
                 const float* __restrict__ ws_acc,
                 const int* __restrict__ lens_or_pos, T* __restrict__ out,
                 Paged vs, int splits, int decode) {
  const int C = vs.C, H = vs.H, KV = vs.KV;
  const int G = H / KV;
  const int R = C * G;
  const int h = blockIdx.x, b = blockIdx.y;
  const int horizon = lens_or_pos[b] + (decode ? -1 : C - 1);
  const int n_pages = horizon < 0 ? 0 : min(horizon / vs.bs + 1, vs.MB);
  const int n_act = (n_pages + vs.pages - 1) / vs.pages;
  const int64_t row0 = (static_cast<int64_t>(b) * KV + h) * splits * R;
  for (int i = threadIdx.x; i < R * (D / 4); i += kVerifyThreads) {
    const int r = i / (D / 4), d = (i % (D / 4)) * 4;
    float mx = -INFINITY;
#pragma unroll 4
    for (int s = 0; s < n_act; ++s) mx = fmaxf(mx, ws_m[row0 + s * R + r]);
    float den = 0.f, num[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < n_act; ++s) {
      const int64_t x = row0 + s * R + r;
      const float w = exp2f(ws_m[x] - mx);
      const float4 a = *reinterpret_cast<const float4*>(ws_acc + x * D + d);
      den += ws_l[x] * w;
      num[0] += a.x * w;
      num[1] += a.y * w;
      num[2] += a.z * w;
      num[3] += a.w * w;
    }
    den = fmaxf(den, 1e-30f);
    const int c = r / G;
    T* o = out +
           ((static_cast<int64_t>(b) * C + c) * H + h * G + (r - c * G)) * D +
           d;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = from_f<T>(num[e] / den);
  }
}

template <typename T, int D, int MR>
int verify_split_launch(const void* q, const void* k_pool,
                        const void* v_pool, const void* tables,
                        const void* positions, void* ws_m, void* ws_l,
                        void* ws_acc, int B, Paged vs, int splits,
                        cudaStream_t stream) {
  using L = VerifyCfg<T, D, MR>;
  const int R = vs.C * (vs.H / vs.KV);
  const int groups = (R + MR - 1) / MR;
  if (splits > 65535 || vs.pages > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool done = false;
  if (!done) {  // once per instantiation, before any graph capture
    const cudaError_t e = cudaFuncSetAttribute(
        verify_split<T, D, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::bytes(MR, 128));
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  verify_split<T, D, MR><<<dim3(vs.KV * groups, splits, B), kVerifyThreads,
                           L::bytes(R < MR ? R : MR, vs.pages), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<float*>(ws_m),
      static_cast<float*>(ws_l), static_cast<float*>(ws_acc), vs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int verify_launch(const void* q, const void* k_pool, const void* v_pool,
                  void* out, const void* tables, const void* positions,
                  void* ws_m, void* ws_l, void* ws_acc, int B, Paged vs,
                  cudaStream_t stream) {
  const int R = vs.C * (vs.H / vs.KV);
  const int splits = (vs.MB + vs.pages - 1) / vs.pages;
  const int e =
      R <= 8 ? verify_split_launch<T, D, 8>(q, k_pool, v_pool, tables,
                                            positions, ws_m, ws_l, ws_acc, B,
                                            vs, splits, stream)
             : verify_split_launch<T, D, 32>(q, k_pool, v_pool, tables,
                                             positions, ws_m, ws_l, ws_acc,
                                             B, vs, splits, stream);
  if (e != 0) return e;
  merge_splits<T, D><<<dim3(vs.KV, B), kVerifyThreads, 0, stream>>>(
      static_cast<const float*>(ws_m), static_cast<const float*>(ws_l),
      static_cast<const float*>(ws_acc), static_cast<const int*>(positions),
      static_cast<T*>(out), vs, splits, 0);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, D>) at the head dims the kernels take,
// `bad` at any other
template <typename F>
int by_head_dim(int D, int bad, F f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return bad;
  }
}

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

template <typename T>
int verify_dispatch(const void* q, const void* k_pool, const void* v_pool,
                    void* out, const void* tables, const void* positions,
                    void* ws_m, void* ws_l, void* ws_acc, int B, int D,
                    Paged vs, cudaStream_t s) {
  return by_head_dim(D, kBad, [&](auto d) {
    return verify_launch<T, decltype(d)::value>(
        q, k_pool, v_pool, out, tables, positions, ws_m, ws_l, ws_acc, B, vs,
        s);
  });
}

template <typename T, int D, int MR>
int decode_split_launch(const void* q, const void* k_pool,
                        const void* v_pool, const void* tables,
                        const void* seq_lens, void* ws_m, void* ws_l,
                        void* ws_acc, int B, Paged ps, int splits,
                        cudaStream_t stream) {
  using L = DecodeCfg<T, D>;
  const int groups = (ps.H / ps.KV + MR - 1) / MR;
  if (splits > 65535 || ps.pages > 128) return kBad;
  static bool done = false;
  if (!done) {  // once per instantiation, before any graph capture
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split<T, D, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::bytes(128));
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  decode_split<T, D, MR><<<dim3(ps.KV * groups, splits, B), kDecodeThreads,
                           L::bytes(ps.pages), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(seq_lens), static_cast<float*>(ws_m),
      static_cast<float*>(ws_l), static_cast<float*>(ws_acc), ps);
  return static_cast<int>(cudaGetLastError());
}

// The rows a decode block carries: 1 at MHA, 4 up to group 4, else 8 (and
// further row groups as further blocks).
template <typename T, int D>
int decode_launch(const void* q, const void* k_pool, const void* v_pool,
                  void* out, const void* tables, const void* seq_lens,
                  void* ws_m, void* ws_l, void* ws_acc, int B, Paged ps,
                  cudaStream_t stream) {
  const int G = ps.H / ps.KV;
  const int splits = (ps.MB + ps.pages - 1) / ps.pages;
  const int e =
      G == 1   ? decode_split_launch<T, D, 1>(q, k_pool, v_pool, tables,
                                              seq_lens, ws_m, ws_l, ws_acc,
                                              B, ps, splits, stream)
      : G <= 4 ? decode_split_launch<T, D, 4>(q, k_pool, v_pool, tables,
                                              seq_lens, ws_m, ws_l, ws_acc,
                                              B, ps, splits, stream)
               : decode_split_launch<T, D, 8>(q, k_pool, v_pool, tables,
                                              seq_lens, ws_m, ws_l, ws_acc,
                                              B, ps, splits, stream);
  if (e != 0) return e;
  merge_splits<T, D><<<dim3(ps.KV, B), kVerifyThreads, 0, stream>>>(
      static_cast<const float*>(ws_m), static_cast<const float*>(ws_l),
      static_cast<const float*>(ws_acc), static_cast<const int*>(seq_lens),
      static_cast<T*>(out), ps, splits, 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int decode_dispatch(const void* q, const void* k_pool, const void* v_pool,
                    void* out, const void* tables, const void* seq_lens,
                    void* ws_m, void* ws_l, void* ws_acc, int B, int D,
                    Paged ps, cudaStream_t s) {
  return by_head_dim(D, kBad, [&](auto d) {
    return decode_launch<T, decltype(d)::value>(
        q, k_pool, v_pool, out, tables, seq_lens, ws_m, ws_l, ws_acc, B, ps,
        s);
  });
}

bool bad_call(int B, int C, int H, int KV, int bs, int MB, int pages) {
  return B < 1 || B > 65535 || C < 1 || KV < 1 || H % KV != 0 || bs < 1 ||
         MB < 1 || pages < 1;
}

}  // namespace

extern "C" {

// Split-KV decode (B5).  dtype: 0 = float32, 1 = bfloat16 (q, pools and
// out share it).  pages: pages per split; the workspace holds fp32 ws_m,
// ws_l [B, KV, ceil(MB / pages), H / KV] and ws_acc [..., D].
int dl_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                    void* out, const void* tables, const void* seq_lens,
                    void* ws_m, void* ws_l, void* ws_acc, int B, int H,
                    int KV, int D, int bs, int MB, int pages, float scale,
                    int dtype, void* stream) {
  if (bad_call(B, 1, H, KV, bs, MB, pages)) return kBad;
  const Paged ps{1, H, KV, bs, MB, pages, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return decode_dispatch<float>(q, k_pool, v_pool, out, tables, seq_lens,
                                  ws_m, ws_l, ws_acc, B, D, ps, s);
  }
  if (dtype == 1) {
    return decode_dispatch<__nv_bfloat16>(q, k_pool, v_pool, out, tables,
                                          seq_lens, ws_m, ws_l, ws_acc, B, D,
                                          ps, s);
  }
  return kBad;
}

// Split-KV verify (B6).  dtype: 0 = float32, 1 = bfloat16 (q, pools and
// out share it).  pages: pages per split; the workspace holds fp32
// ws_m, ws_l [B, KV, ceil(MB / pages), C * H / KV] and ws_acc [..., D].
int dl_paged_verify(const void* q, const void* k_pool, const void* v_pool,
                    void* out, const void* tables, const void* positions,
                    void* ws_m, void* ws_l, void* ws_acc, int B, int C,
                    int H, int KV, int D, int bs, int MB, int pages,
                    float scale, int dtype, void* stream) {
  if (bad_call(B, C, H, KV, bs, MB, pages)) return kBad;
  const Paged vs{C, H, KV, bs, MB, pages, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return verify_dispatch<float>(q, k_pool, v_pool, out, tables, positions,
                                  ws_m, ws_l, ws_acc, B, D, vs, s);
  }
  if (dtype == 1) {
    return verify_dispatch<__nv_bfloat16>(q, k_pool, v_pool, out, tables,
                                          positions, ws_m, ws_l, ws_acc, B,
                                          D, vs, s);
  }
  return kBad;
}

// The dynamic shared memory of one decode block at `pages` pages per
// split, for the build report; -1 for a dtype or D the kernel does not
// take.
int dl_paged_decode_smem(int dtype, int D, int pages) {
  if (dtype != 0 && dtype != 1) return -1;
  return by_head_dim(D, -1, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return dtype == 0 ? DecodeCfg<float, kD>::bytes(pages)
                      : DecodeCfg<__nv_bfloat16, kD>::bytes(pages);
  });
}

// The dynamic shared memory of one verify block at `rows` query rows and
// `pages` pages per split, for the build report; -1 for a dtype or D the
// kernel does not take.
int dl_paged_verify_smem(int dtype, int D, int rows, int pages) {
  if (dtype != 0 && dtype != 1) return -1;
  return by_head_dim(D, -1, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (rows > 8) {
      return dtype == 0 ? VerifyCfg<float, kD, 32>::bytes(32, pages)
                        : VerifyCfg<__nv_bfloat16, kD, 32>::bytes(32, pages);
    }
    return dtype == 0 ? VerifyCfg<float, kD, 8>::bytes(rows, pages)
                      : VerifyCfg<__nv_bfloat16, kD, 8>::bytes(rows, pages);
  });
}

const char* dl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
