// Paged GQA attention for Hopper (sm_90a), fp32 and bf16: one-token
// decode and the K-step speculative verify window.
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
//
// What bounds it on the card: bytes.  Each visible K and V row is read
// once (2 * seq_len * KV * D elements per lane) for about 2 * group
// multiply-adds per element read, orders of magnitude below the ridge.
// So the design is about keeping many independent row loads in flight
// and spending few instructions between them.
//
// Design: one thread block (4 warps) per (lane, KV head).  The block
// reads its lane's seq_len / position and its table row itself (no
// scalar prefetch) and covers exactly the pages that hold visible keys:
// ceil(seq_len / bs) for decode, (pos + C - 1) / bs + 1 for verify, never
// max_blocks.  The warps take the pages round-robin, each with its own
// online softmax, so four pages stream at once with no barrier in the
// loop; a warp loads the K and V rows of 8 keys (4 at D=256) before
// using them, reduces their 8 dot products side by side and rescales
// its running state once per 8 keys.
// Lane i holds dims [i*D/32, (i+1)*D/32) of every row (one vector load
// per row), a dot product is a warp-shuffle sum, and the running
// (m, l, acc) of up to 4 query rows stay in registers.  The warps' states
// are merged through shared memory at the end.  A lane's G = H / KV query
// rows (C * G for verify; row r is window offset r / G, head h * G + r % G)
// share every page; more than 4 rows are taken 4 at a time.  Query head h
// reads KV head h / G.
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
// 64, 128 or 256 and every row 16-byte aligned (the wrapper checks).
//
// C interface (ctypes): returns cudaGetLastError() after the launch.
// The caller allocates the output; the kernel launches on `stream` and
// allocates nothing.

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

const char* dl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
