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
// Decode (dl_paged_attention, the first design): one thread block (4
// warps) per (lane, KV head).  The block reads its lane's seq_len and its
// table row itself (no scalar prefetch) and covers exactly the
// ceil(seq_len / bs) pages that hold visible keys, never max_blocks.  The
// warps take the pages round-robin, each with its own online softmax, so
// four pages stream at once with no barrier in the loop; a warp loads the
// K and V rows of 8 keys (4 at D=256) before using them, reduces their 8
// dot products side by side and rescales its running state once per 8
// keys.  Lane i holds dims [i*D/32, (i+1)*D/32) of every row (one vector
// load per row), a dot product is a warp-shuffle sum, and the running
// (m, l, acc) of up to 4 query rows stay in registers.  The warps' states
// are merged through shared memory at the end.  (The entry still takes
// decode = 0, the verify window through this body, as the first design
// launched it.)
//
// Verify (dl_paged_verify, split-KV).  The first design ran it through
// the decode body: one block per (lane, KV head), so the call lasted as
// long as the longest lane's serial chain of pages (13 x 32 blocks on
// 132 SMs at the serving shape, ~12 of 64 warp slots per SM busy), and
// it re-read every page once per 4 query rows.  Here each lane's visible
// pages, (pos + C - 1) / bs + 1 of them, are cut into splits of `pages`
// pages (about 128 keys; the host sizes them from bs and the grid from
// the table width MB, so it never reads the positions).  A block of 128
// threads per (KV head, split, lane), heads the fastest launch index,
// carries every one of the lane's C * G rows (up to 8, or 32 per block
// when there are more, further rows taking further blocks) in one pass
// over its pages; a block whose split starts past the lane's horizon
// returns at once.  K and V rows stream by cp.async (16 bytes) into a
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
// Each split writes its fp32 partial (m, l, acc) to a workspace that the
// caller allocates; a second kernel merges the splits of each (lane,
// head, row) in split order.  No atomics: both kernels are deterministic.
//
// A page past the lane's end, the null block behind an inactive lane's
// padding and the rows of the last page past the horizon are never
// loaded, and a masked key never enters the softmax (it is skipped, not
// weighted by 0), so garbage or NaN there cannot reach the output.  The
// output is acc / max(l, 1e-30): exact zeros for a lane with no key.
//
// Offsets into the pool are 64-bit: at Llama-2-7B with 2049 blocks one
// layer holds 134M elements and the stacked pool 4.3G.  The TPU kernel's
// tuning knobs (kv_span, q_rows) have no counterpart here.  D must be 32,
// 64, 128 or 256 and every row 16-byte aligned (the wrappers check).
//
// C interface (ctypes): each entry returns cudaGetLastError() after its
// launches.  The caller allocates the output and the workspace; the
// kernels launch on `stream` and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;  // query rows a warp carries at once

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

// N consecutive elements at p (aligned to N * sizeof(T)) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(x.v[i]);
}

// decode != 0: lens_or_pos holds seq_lens and C == 1 (the query sits at
// seq_len - 1); decode == 0: it holds each lane's first window position.
// DPL = D / 32 dims per lane.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool, T* __restrict__ out,
                           const int* __restrict__ tables,
                           const int* __restrict__ lens_or_pos, int decode,
                           int C, int H, int KV, int bs, int MB,
                           float scale) {
  constexpr int D = 32 * DPL;
  constexpr int kAhead = DPL >= 8 ? 4 : 8;  // K/V rows loaded per step
  __shared__ float m_sh[kWarps][kRows];
  __shared__ float l_sh[kWarps][kRows];
  __shared__ float acc_sh[kWarps][kRows][D];

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int G = H / KV;
  const int R = C * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int pos = decode ? lens_or_pos[b] - 1 : lens_or_pos[b];
  const int horizon = pos + C - 1;  // last key any row may see
  const int n_pages = horizon < 0 ? 0 : min(horizon / bs + 1, MB);
  const int64_t tok_stride = static_cast<int64_t>(KV) * D;
  const int64_t page_stride = static_cast<int64_t>(bs) * tok_stride;
  const int* table = tables + static_cast<int64_t>(b) * MB;

  for (int r0 = 0; r0 < R; r0 += kRows) {
    const int nr = min(kRows, R - r0);
    float qf[kRows][DPL];
    int last[kRows];  // last key position each row may see
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr) {
        const int c = (r0 + r) / G;
        const int g = (r0 + r) - c * G;
        const int64_t qi =
            ((static_cast<int64_t>(b) * C + c) * H + h * G + g) * D;
        load_row<T, DPL>(q + qi + lane * DPL, qf[r]);
        last[r] = pos + c;
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) qf[r][i] = 0.f;
        last[r] = -1;  // sees nothing
      }
    }
    float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = -1e30f;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
    }

    for (int j = warp; j < n_pages; j += kWarps) {
      const int start = j * bs;
      const int n_valid = min(bs, horizon - start + 1);
      const int64_t base = static_cast<int64_t>(table[j]) * page_stride +
                           static_cast<int64_t>(h) * D + lane * DPL;
      for (int t0 = 0; t0 < n_valid; t0 += kAhead) {
        const int nv = min(kAhead, n_valid - t0);
        float kf[kAhead][DPL], vf[kAhead][DPL];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (u < nv) {
            const int64_t off = base + (t0 + u) * tok_stride;
            load_row<T, DPL>(k_pool + off, kf[u]);
            load_row<T, DPL>(v_pool + off, vf[u]);
          } else {  // past the horizon: never loaded, never weighted
#pragma unroll
            for (int i = 0; i < DPL; ++i) kf[u][i] = vf[u][i] = 0.f;
          }
        }
        const int col0 = start + t0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r >= nr || col0 > last[r]) continue;  // warp-uniform
          // the group's scores: lane partial dots, then all the warp
          // reductions side by side; a masked key is -inf
          float s[kAhead];
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            s[u] = 0.f;
#pragma unroll
            for (int i = 0; i < DPL; ++i) s[u] += qf[r][i] * kf[u][i];
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int u = 0; u < kAhead; ++u) {
              s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
            }
          }
          float mx = -INFINITY;
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            s[u] = (u < nv && col0 + u <= last[r]) ? s[u] * scale
                                                     : -INFINITY;
            mx = fmaxf(mx, s[u]);
          }
          // one rescale per group; a masked key is skipped, never
          // weighted by 0, and a NaN score still reaches l and acc
          const float m_new = fmaxf(m[r], mx);
          const float alpha = expf(m[r] - m_new);
          float psum = 0.f;
          float pv[DPL];
#pragma unroll
          for (int i = 0; i < DPL; ++i) pv[i] = 0.f;
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            if (s[u] == -INFINITY) continue;
            const float p = expf(s[u] - m_new);
            psum += p;
#pragma unroll
            for (int i = 0; i < DPL; ++i) pv[i] += p * vf[u][i];
          }
          l[r] = l[r] * alpha + psum;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * alpha + pv[i];
          m[r] = m_new;
        }
      }
    }

    // merge the warps' (m, l, acc) and write the rows
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (lane == 0) {
        m_sh[warp][r] = m[r];
        l_sh[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc_sh[warp][r][lane * DPL + i] = acc[r][i];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx - r * D;
      float mx = m_sh[0][r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_sh[w][r]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(m_sh[w][r] - mx);
        den += l_sh[w][r] * e;
        num += acc_sh[w][r][d] * e;
      }
      const int c = (r0 + r) / G;
      const int g = (r0 + r) - c * G;
      const int64_t oi =
          ((static_cast<int64_t>(b) * C + c) * H + h * G + g) * D + d;
      out[oi] = from_f<T>(num / fmaxf(den, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k_pool, const void* v_pool, void* out,
           const void* tables, const void* lens_or_pos, int decode, int B,
           int C, int H, int KV, int bs, int MB, float scale,
           cudaStream_t stream) {
  paged_attention_kernel<T, DPL><<<B * KV, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<T*>(out),
      static_cast<const int*>(tables), static_cast<const int*>(lens_or_pos),
      decode, C, H, KV, bs, MB, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             void* out, const void* tables, const void* lens_or_pos,
             int decode, int B, int C, int H, int KV, int D, int bs, int MB,
             float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 1>(q, k_pool, v_pool, out, tables, lens_or_pos,
                          decode, B, C, H, KV, bs, MB, scale, s);
    case 64:
      return launch<T, 2>(q, k_pool, v_pool, out, tables, lens_or_pos,
                          decode, B, C, H, KV, bs, MB, scale, s);
    case 128:
      return launch<T, 4>(q, k_pool, v_pool, out, tables, lens_or_pos,
                          decode, B, C, H, KV, bs, MB, scale, s);
    case 256:
      return launch<T, 8>(q, k_pool, v_pool, out, tables, lens_or_pos,
                          decode, B, C, H, KV, bs, MB, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ============================================ verify, split-KV (B6)

constexpr int kVerifyThreads = 128;
constexpr int kVerifyStages = 2;  // steps in the ring (1 loading, 1 in use)

// The shape of one verify call.
struct Verify {
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
                 Verify vs) {
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
    const int key0 = k_begin + it * kKeys;
    const int nk = min(kKeys, k_end - key0);
    const uint32_t stage = ring + (it % kVerifyStages) * L::kStage;
    for (int i = tid; i < 2 * kKeys * kChunks; i += kVerifyThreads) {
      const int kv = i / (kKeys * kChunks);
      const int u = (i / kChunks) % kKeys;
      const int c = i % kChunks;
      if (u < nk) {
        const int key = key0 + u - k_begin;  // within the split
        const int page = key / bs;
        const int64_t row =
            static_cast<int64_t>(s_tab[page]) * bs + (key - page * bs);
        const T* src = (kv ? v_pool : k_pool) + row * tok_stride +
                       static_cast<int64_t>(h) * D + c * kVec;
        cp_async16(stage + (kv * kKeys + u) * L::kRow + c * 16, src);
      }
    }
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

// One block per (KV head, lane): every row of the lane's window merged
// over its splits in split order, o = acc / max(l, 1e-30).  A thread
// owns 4 dims of a row (16-byte loads of the partial sums); the split
// loops are unrolled so their loads are in flight together.
template <typename T, int D>
__global__ void __launch_bounds__(kVerifyThreads)
    verify_merge(const float* __restrict__ ws_m,
                 const float* __restrict__ ws_l,
                 const float* __restrict__ ws_acc,
                 const int* __restrict__ positions, T* __restrict__ out,
                 Verify vs, int splits) {
  const int C = vs.C, H = vs.H, KV = vs.KV;
  const int G = H / KV;
  const int R = C * G;
  const int h = blockIdx.x, b = blockIdx.y;
  const int horizon = positions[b] + C - 1;
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
                        void* ws_acc, int B, Verify vs, int splits,
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
                  void* ws_m, void* ws_l, void* ws_acc, int B, Verify vs,
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
  verify_merge<T, D><<<dim3(vs.KV, B), kVerifyThreads, 0, stream>>>(
      static_cast<const float*>(ws_m), static_cast<const float*>(ws_l),
      static_cast<const float*>(ws_acc), static_cast<const int*>(positions),
      static_cast<T*>(out), vs, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MR>
int verify_smem(int D, int rows, int pages) {
  if (D == 32) return VerifyCfg<T, 32, MR>::bytes(rows, pages);
  if (D == 64) return VerifyCfg<T, 64, MR>::bytes(rows, pages);
  if (D == 128) return VerifyCfg<T, 128, MR>::bytes(rows, pages);
  if (D == 256) return VerifyCfg<T, 256, MR>::bytes(rows, pages);
  return -1;
}

template <typename T>
int verify_dispatch(const void* q, const void* k_pool, const void* v_pool,
                    void* out, const void* tables, const void* positions,
                    void* ws_m, void* ws_l, void* ws_acc, int B, int D,
                    Verify vs, cudaStream_t s) {
  switch (D) {
    case 32:
      return verify_launch<T, 32>(q, k_pool, v_pool, out, tables, positions,
                                  ws_m, ws_l, ws_acc, B, vs, s);
    case 64:
      return verify_launch<T, 64>(q, k_pool, v_pool, out, tables, positions,
                                  ws_m, ws_l, ws_acc, B, vs, s);
    case 128:
      return verify_launch<T, 128>(q, k_pool, v_pool, out, tables, positions,
                                   ws_m, ws_l, ws_acc, B, vs, s);
    case 256:
      return verify_launch<T, 256>(q, k_pool, v_pool, out, tables, positions,
                                   ws_m, ws_l, ws_acc, B, vs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// decode: 1 -> lens_or_pos = seq_lens and C must be 1; 0 -> verify.
int dl_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                       void* out, const void* tables, const void* lens_or_pos,
                       int decode, int B, int C, int H, int KV, int D, int bs,
                       int MB, float scale, int dtype, void* stream) {
  if (B < 1 || C < 1 || KV < 1 || H % KV != 0 || bs < 1 || MB < 1 ||
      (decode && C != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k_pool, v_pool, out, tables, lens_or_pos,
                           decode, B, C, H, KV, D, bs, MB, scale, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k_pool, v_pool, out, tables,
                                   lens_or_pos, decode, B, C, H, KV, D, bs,
                                   MB, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Split-KV verify (B6).  dtype: 0 = float32, 1 = bfloat16 (q, pools and
// out share it).  pages: pages per split; the workspace holds fp32
// ws_m, ws_l [B, KV, ceil(MB / pages), C * H / KV] and ws_acc [..., D].
int dl_paged_verify(const void* q, const void* k_pool, const void* v_pool,
                    void* out, const void* tables, const void* positions,
                    void* ws_m, void* ws_l, void* ws_acc, int B, int C,
                    int H, int KV, int D, int bs, int MB, int pages,
                    float scale, int dtype, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || KV < 1 || H % KV != 0 || bs < 1 ||
      MB < 1 || pages < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Verify vs{C, H, KV, bs, MB, pages, scale};
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
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory of one verify block at `rows` query rows and
// `pages` pages per split, for the build report; -1 for a dtype or D the
// kernel does not take.
int dl_paged_verify_smem(int dtype, int D, int rows, int pages) {
  if (rows > 8) return dtype == 0 ? verify_smem<float, 32>(D, 32, pages)
                                  : verify_smem<__nv_bfloat16, 32>(D, 32, pages);
  return dtype == 0 ? verify_smem<float, 8>(D, rows, pages)
                    : verify_smem<__nv_bfloat16, 8>(D, rows, pages);
}

const char* dl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
