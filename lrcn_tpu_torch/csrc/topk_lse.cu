// Fused per-row top-k + log-sum-exp for Hopper (sm_90a).
//
// Replaces the TPU kernel lrcn_tpu/ops/pallas/topk_lse.py:topk_logsumexp.
// For each row of (R, V) f32 logits it returns the k largest values in
// descending order, their column indices (lowest index first among equal
// values, lax.top_k's rule) and lse = m + log(sum(exp(x - m))).  The beam
// step turns these into log-probabilities as vals - lse, which ranks
// exactly like a top-k of log_softmax.  -inf entries rank last (lowest
// index first); an all--inf row has lse = -inf, as torch.logsumexp gives.
//
// What bounds it on this card: device memory, if the per-element work keeps
// up.  The decode step's (768, 8800) f32 logits are 27 MB, read once,
// against ~4 f32 operations and one exp per element: 0.0081 ms at
// 3.35 TB/s.  So the design must keep enough bytes in flight and spend few
// instructions per element; v1 (kWarp) did neither at 768 rows: ~6 warps an
// SM, each lane a serial chain of online rescales and list inserts.
//
// What the design does about it: three routes (enum Route), chosen in
// Python (ops/kernels/topk_lse.py:topk_lse_route) and passed here as an int.
//  kBlock, the default for k <= 16: a block of 32-256 threads per row, about
//    3072 warps in all (threads_for).  Each thread issues all U 16-byte loads
//    of a tile before it uses any, takes the tile's max, sums
//    2^((x - m) log2 e) as independent terms (one rescale per tile, no
//    per-element branch), and offers the values to a sorted register list of
//    its k best (value, index) pairs: one compare a value once the list is
//    full.  Warps reduce their lists by k argmax rounds over the list heads
//    (the owner pops), then one warp does the same over the warps' lists.
//  kWarp (v1), k <= 8: one warp per row, four rows a block; kept for
//    comparison and taken only when asked for by name.
//  kRounds, any k <= V: k rounds over the row, each a block-wide argmax of
//    the columns strictly after the previous pick in the order (value desc,
//    index asc): no mask and no sentinel value.  Round 0 also gives the lse.
//    Re-reads the row k times (from L2); for the beam widths above 16.
// Measured device time on an NVIDIA H100 80GB HBM3 (700 W limit), kBlock
// against kWarp in the same run: 0.0146 vs 0.0356 ms at (768, 8800) k=3
// (bound 0.0081, the logits warm in L2 as after the output GEMM), 0.1442 vs
// 0.1738 ms at (12288, 8800) k=3 (bound 0.1292), 0.0049 vs 0.0252 ms at
// (256, 8800) k=1 (PERF.md section 6 has the current numbers).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

// the route ints of ops/kernels/topk_lse.py:ROUTES
enum Route { kWarp = 0, kBlock = 1, kRounds = 2 };

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// a comes before b in the order (value desc, index asc)
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

template <int K>
struct TopK {
  float v[K];
  int i[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = -INFINITY;
      i[j] = INT_MAX;
    }
  }

  // Keep the list sorted by (value desc, index asc); static indexing only,
  // so the list lives in registers.
  __device__ __forceinline__ void insert(float x, int ix) {
    if (!better(x, ix, v[K - 1], i[K - 1])) return;
    v[K - 1] = x;
    i[K - 1] = ix;
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (better(v[j], i[j], v[j - 1], i[j - 1])) {
        const float tv = v[j];
        v[j] = v[j - 1];
        v[j - 1] = tv;
        const int ti = i[j];
        i[j] = i[j - 1];
        i[j - 1] = ti;
      }
    }
  }

  // Drop the head; an empty slot enters at the tail.
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) {
      v[j] = v[j + 1];
      i[j] = i[j + 1];
    }
    v[K - 1] = -INFINITY;
    i[K - 1] = INT_MAX;
  }
};

// The best K of the lanes' sorted lists, in order, into `out` of every
// lane: K rounds of a butterfly argmax over the lists' heads, after each of
// which the lane holding the winner pops it (a column index is in one list
// only; empty slots tie, and popping one changes nothing).  K rounds of 5
// shuffle pairs, where merging whole lists would insert 5 x K values.
template <int K>
__device__ __forceinline__ void warp_best(TopK<K>& top, TopK<K>& out) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float bv = top.v[0];
    int bi = top.i[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float pv = __shfl_xor_sync(FULL, bv, off);
      const int pi = __shfl_xor_sync(FULL, bi, off);
      if (better(pv, pi, bv, bi)) {
        bv = pv;
        bi = pi;
      }
    }
    out.v[j] = bv;
    out.i[j] = bi;
    if (j + 1 < K && top.i[0] == bi) top.pop();
  }
}

// 2^x by the special-function unit (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online log-sum-exp: s is sum(exp(x - m)) over the values seen so far.
__device__ __forceinline__ void lse_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else if (x != -INFINITY) {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float pm,
                                          float ps) {
  const float mn = fmaxf(m, pm);
  if (mn == -INFINITY) return;
  s = s * expf(m - mn) + ps * expf(pm - mn);
  m = mn;
}

// Butterfly over the lanes at xor offsets FIRST, FIRST/2, ..., 1: after it
// every lane holds the (max, sum) of its 2*FIRST lanes.
template <int FIRST>
__device__ __forceinline__ void warp_lse(float& m, float& s) {
#pragma unroll
  for (int off = FIRST; off > 0; off >>= 1)
    lse_merge(m, s, __shfl_xor_sync(FULL, m, off),
              __shfl_xor_sync(FULL, s, off));
}

// Columns [0, head) of a row are before its first 16-byte boundary; the
// body [head, head + 4 * n4) is read as float4.
__device__ __forceinline__ int head_of(const float* p, int V) {
  const int head = (int)(((16u - ((uintptr_t)p & 15u)) & 15u) / 4u);
  return head < V ? head : V;
}

// ---- kWarp (v1): one warp per row ----

namespace warp {

constexpr int WARPS = 4;  // rows per block

// v1's merge: a butterfly over whole lists and (max, sum) pairs.
template <int K>
__device__ __forceinline__ void warp_merge(TopK<K>& top, float& m, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float pv[K];
    int pi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      pv[j] = __shfl_xor_sync(FULL, top.v[j], off);
      pi[j] = __shfl_xor_sync(FULL, top.i[j], off);
    }
    const float pm = __shfl_xor_sync(FULL, m, off);
    const float ps = __shfl_xor_sync(FULL, s, off);
#pragma unroll
    for (int j = 0; j < K; ++j) top.insert(pv[j], pi[j]);
    lse_merge(m, s, pm, ps);
  }
}

template <int K>
__device__ __forceinline__ void take(TopK<K>& top, float& m, float& s,
                                     float x, int ix) {
  top.insert(x, ix);
  lse_add(m, s, x);
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
    topk_lse_warp_kernel(const float* __restrict__ logits,
                         float* __restrict__ vals, int* __restrict__ idx,
                         float* __restrict__ lse, int R, int V) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warp leaves together
  const float* p = logits + (size_t)row * V;

  TopK<K> top;
  top.init();
  float m = -INFINITY, s = 0.f;

  const int head = head_of(p, V);
  const int n4 = (V - head) / 4;
  if (lane < head) take(top, m, s, p[lane], lane);

  const float4* body = reinterpret_cast<const float4*>(p + head);
  constexpr int UNROLL = 4;
  int q = lane;
  for (; q + 32 * (UNROLL - 1) < n4; q += 32 * UNROLL) {
    float4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) r[u] = __ldg(body + q + 32 * u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = head + 4 * (q + 32 * u);
      take(top, m, s, r[u].x, c);
      take(top, m, s, r[u].y, c + 1);
      take(top, m, s, r[u].z, c + 2);
      take(top, m, s, r[u].w, c + 3);
    }
  }
  for (; q < n4; q += 32) {
    const float4 r = __ldg(body + q);
    const int c = head + 4 * q;
    take(top, m, s, r.x, c);
    take(top, m, s, r.y, c + 1);
    take(top, m, s, r.z, c + 2);
    take(top, m, s, r.w, c + 3);
  }
  const int tail = head + 4 * n4 + lane;
  if (tail < V) take(top, m, s, p[tail], tail);

  warp_merge<K>(top, m, s);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      vals[(size_t)row * K + j] = top.v[j];
      idx[(size_t)row * K + j] = top.i[j];
    }
    lse[row] = m + logf(s);
  }
}

template <int K>
void launch(const float* logits, float* vals, int* idx, float* lse, int R,
            int V, cudaStream_t stream) {
  const int blocks = (R + WARPS - 1) / WARPS;
  topk_lse_warp_kernel<K><<<blocks, WARPS * 32, 0, stream>>>(logits, vals,
                                                             idx, lse, R, V);
}

}  // namespace warp

// ---- kBlock: one block per row ----

namespace blk {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int U = 6;  // float4 loads a thread per tile

// Threads a row by the number of rows: about 3072 warps in all (23 an SM),
// one to eight a row.  Few rows need many warps each to keep loads in
// flight; with many rows, fewer lists a row to merge win.
inline int threads_for(int R) {
  int warps = 1;
  while (warps < 8 && (long long)warps * R < 3072) warps *= 2;
  return 32 * warps;
}

// Offer the U float4 of a tile to the list.  FULL: the list holds K finite
// values, and every column in it came before these (a thread's columns
// rise), so a column enters only by a strictly larger value: one compare.
template <int K, int U, bool FULL>
__device__ __forceinline__ void offer_tile(TopK<K>& top, const float4 (&r)[U],
                                           int base, int threads, int n4,
                                           int head) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = base + u * threads + threadIdx.x;
    if (q >= n4) continue;
    const int c = head + 4 * q;
    const float x[4] = {r[u].x, r[u].y, r[u].z, r[u].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!FULL || x[e] > top.v[K - 1]) top.insert(x[e], c + e);
  }
}

template <int K>
__global__ void __launch_bounds__(MAX_THREADS)
    topk_lse_block_kernel(const float* __restrict__ logits,
                          float* __restrict__ vals, int* __restrict__ idx,
                          float* __restrict__ lse, int V) {
  __shared__ float sh_v[MAX_WARPS][K], sh_m[MAX_WARPS], sh_s[MAX_WARPS];
  __shared__ int sh_i[MAX_WARPS][K];
  const int threads = blockDim.x, warps = threads >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp_id = tid >> 5;
  const size_t row = blockIdx.x;
  const float* p = logits + row * V;

  TopK<K> top;
  top.init();
  float m = -INFINITY, s = 0.f;

  // the unaligned head (and, after the body, the tail): three columns or
  // fewer each
  const int head = head_of(p, V);
  const int n4 = (V - head) / 4;
  const int tail = head + 4 * n4;
  if (tid < head) {
    top.insert(p[tid], tid);
    lse_merge(m, s, p[tid], 1.f);
  }

  // Tiles of U float4 a thread; a thread's columns rise through a tile and
  // from tile to tile (head first, tail last), so each list sees its
  // columns in index order.
  const float4* body = reinterpret_cast<const float4*>(p + head);
  for (int base = 0; base < n4; base += threads * U) {
    // every load of the tile in flight before the first use
    float4 r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = base + u * threads + tid;
      r[u] = q < n4 ? __ldg(body + q)
                    : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
    float mt = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u)
      mt = fmaxf(mt, fmaxf(fmaxf(r[u].x, r[u].y), fmaxf(r[u].z, r[u].w)));
    if (mt > m) {
      s *= ex2((m - mt) * LOG2E);  // m = -inf: s is 0 and stays 0
      m = mt;
    }
    // while every value so far is -inf, shift by 0: 2^-inf = 0.  x - shift
    // is exact near the max, so +-1e30 rows are exact too.
    const float shift = m == -INFINITY ? 0.f : m;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[0] += ex2((r[u].x - shift) * LOG2E);
      acc[1] += ex2((r[u].y - shift) * LOG2E);
      acc[2] += ex2((r[u].z - shift) * LOG2E);
      acc[3] += ex2((r[u].w - shift) * LOG2E);
    }
    s += (acc[0] + acc[1]) + (acc[2] + acc[3]);
    if (top.v[K - 1] != -INFINITY)
      offer_tile<K, U, true>(top, r, base, threads, n4, head);
    else
      offer_tile<K, U, false>(top, r, base, threads, n4, head);
  }
  if (tail + tid < V) {
    top.insert(p[tail + tid], tail + tid);
    lse_merge(m, s, p[tail + tid], 1.f);
  }

  // the warp's best K and (max, sum), then warp 0 merges the warps'
  TopK<K> best;
  warp_best(top, best);
  warp_lse<16>(m, s);
  if (warps > 1) {
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        sh_v[warp_id][j] = best.v[j];
        sh_i[warp_id][j] = best.i[j];
      }
      sh_m[warp_id] = m;
      sh_s[warp_id] = s;
    }
    __syncthreads();
    if (warp_id != 0) return;
    top.init();
    m = -INFINITY;
    s = 0.f;
    if (lane < warps) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        top.v[j] = sh_v[lane][j];
        top.i[j] = sh_i[lane][j];
      }
      m = sh_m[lane];
      s = sh_s[lane];
    }
    warp_best(top, best);
    warp_lse<MAX_WARPS / 2>(m, s);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      vals[row * K + j] = best.v[j];
      idx[row * K + j] = best.i[j];
    }
    lse[row] = m + logf(s);  // m = -inf: s = 0 and lse = -inf
  }
}

template <int K>
void launch(const float* logits, float* vals, int* idx, float* lse, int R,
            int V, cudaStream_t stream) {
  topk_lse_block_kernel<K><<<R, threads_for(R), 0, stream>>>(logits, vals,
                                                             idx, lse, V);
}

}  // namespace blk

// ---- kRounds: k block-wide argmax rounds per row ----

namespace rounds {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// The best (value, index) of the block; every thread gets it.  `sv`, `si`
// hold one pair a warp; the second barrier makes them reusable at once.
__device__ __forceinline__ void block_best(float& v, int& i, float* sv,
                                           int* si) {
  const int lane = threadIdx.x & 31, warp_id = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float pv = __shfl_xor_sync(FULL, v, off);
    const int pi = __shfl_xor_sync(FULL, i, off);
    if (better(pv, pi, v, i)) {
      v = pv;
      i = pi;
    }
  }
  if (lane == 0) {
    sv[warp_id] = v;
    si[warp_id] = i;
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    if (better(sv[w], si[w], v, i)) {
      v = sv[w];
      i = si[w];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
    topk_lse_rounds_kernel(const float* __restrict__ logits,
                           float* __restrict__ vals, int* __restrict__ idx,
                           float* __restrict__ lse, int V, int k) {
  __shared__ float sv[WARPS], sm[WARPS], ss[WARPS];
  __shared__ int si[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp_id = tid >> 5;
  const size_t row = blockIdx.x;
  const float* p = logits + row * V;

  // round 0: the log-sum-exp and the best column
  float m = -INFINITY, s = 0.f;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int c = tid; c < V; c += THREADS) {
    const float x = __ldg(p + c);
    lse_add(m, s, x);
    if (better(x, c, bv, bi)) {
      bv = x;
      bi = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lse_merge(m, s, __shfl_xor_sync(FULL, m, off),
              __shfl_xor_sync(FULL, s, off));
  if (lane == 0) {
    sm[warp_id] = m;
    ss[warp_id] = s;
  }
  block_best(bv, bi, sv, si);  // its first barrier publishes sm, ss
  if (tid == 0) {
    for (int w = 1; w < WARPS; ++w) lse_merge(m, s, sm[w], ss[w]);
    lse[row] = m + logf(s);
    vals[row * k] = bv;
    idx[row * k] = bi;
  }

  // round j: the best column strictly after pick j - 1
  for (int j = 1; j < k; ++j) {
    const float pv = bv;
    const int pi = bi;
    bv = -INFINITY;
    bi = INT_MAX;
    for (int c = tid; c < V; c += THREADS) {
      const float x = __ldg(p + c);
      if (better(pv, pi, x, c) && better(x, c, bv, bi)) {
        bv = x;
        bi = c;
      }
    }
    block_best(bv, bi, sv, si);
    if (tid == 0) {
      vals[row * k + j] = bv;
      idx[row * k + j] = bi;
    }
  }
}

}  // namespace rounds

}  // namespace

#define LRCN_TOPK_CASE(NS, K)           \
  case K:                               \
    NS::launch<K>(x, v, i, l, R, V, s); \
    break;

// logits (R, V) f32 contiguous -> vals (R, k) f32, idx (R, k) int32,
// lse (R,) f32, on route `route` (enum Route): kWarp takes 1 <= k <= 8,
// kBlock 1 <= k <= 16, kRounds 1 <= k <= V.  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a k or route the kernels
// do not take.
extern "C" int lrcn_topk_lse(const void* logits, void* vals, void* idx,
                             void* lse, int R, int V, int k, int route,
                             void* stream) {
  const float* x = static_cast<const float*>(logits);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case kWarp:
      switch (k) {
        LRCN_TOPK_CASE(warp, 1)
        LRCN_TOPK_CASE(warp, 2)
        LRCN_TOPK_CASE(warp, 3)
        LRCN_TOPK_CASE(warp, 4)
        LRCN_TOPK_CASE(warp, 5)
        LRCN_TOPK_CASE(warp, 6)
        LRCN_TOPK_CASE(warp, 7)
        LRCN_TOPK_CASE(warp, 8)
        default: return invalid;
      }
      break;
    case kBlock:
      switch (k) {
        LRCN_TOPK_CASE(blk, 1)
        LRCN_TOPK_CASE(blk, 2)
        LRCN_TOPK_CASE(blk, 3)
        LRCN_TOPK_CASE(blk, 4)
        LRCN_TOPK_CASE(blk, 5)
        LRCN_TOPK_CASE(blk, 6)
        LRCN_TOPK_CASE(blk, 7)
        LRCN_TOPK_CASE(blk, 8)
        LRCN_TOPK_CASE(blk, 9)
        LRCN_TOPK_CASE(blk, 10)
        LRCN_TOPK_CASE(blk, 11)
        LRCN_TOPK_CASE(blk, 12)
        LRCN_TOPK_CASE(blk, 13)
        LRCN_TOPK_CASE(blk, 14)
        LRCN_TOPK_CASE(blk, 15)
        LRCN_TOPK_CASE(blk, 16)
        default: return invalid;
      }
      break;
    case kRounds:
      if (k < 1 || k > V) return invalid;
      rounds::topk_lse_rounds_kernel<<<R, rounds::THREADS, 0, s>>>(x, v, i, l,
                                                                   V, k);
      break;
    default:
      return invalid;
  }
  return static_cast<int>(cudaGetLastError());
}
