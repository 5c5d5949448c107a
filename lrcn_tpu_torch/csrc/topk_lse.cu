// Fused per-row top-k + log-sum-exp for Hopper (sm_90a).
//
// Replaces the TPU kernel lrcn_tpu/ops/pallas/topk_lse.py:topk_logsumexp.
// For each row of (R, V) f32 logits it returns the k largest values in
// descending order, their column indices (lowest index first among equal
// values, lax.top_k's rule) and lse = m + log(sum(exp(x - m))).  The beam
// step turns these into log-probabilities as vals - lse, which ranks
// exactly like a top-k of log_softmax.
//
// What bounds it on this card: device memory.  The decode step's (768, 8800)
// f32 logits are 27 MB, read once, against ~2 FLOP and one exp per element.
// Measured at that shape: 0.040 ms on an NVIDIA H100 80GB HBM3 with a 700 W
// power limit (PERF.md), about a fifth of the card's memory bandwidth.
//
// What the design does about it: one warp per row and one pass over it.
// Each lane streams its strided columns with 16-byte loads (four in flight
// per lane), keeping an online (max, rescaled sum-exp) pair and a sorted
// register list of its k best (value, index) pairs.  Five warp-shuffle
// butterfly rounds merge the lists and the (max, sum) pairs; nothing but the
// logits and the (R, k) + (R,) results touches device memory.  k is a
// template parameter (1..8) so the lists stay in registers.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int WARPS = 4;  // rows per block
constexpr unsigned FULL = 0xffffffffu;

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
};

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

template <int K>
__device__ __forceinline__ void take(TopK<K>& top, float& m, float& s,
                                     float x, int ix) {
  top.insert(x, ix);
  lse_add(m, s, x);
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
    topk_lse_kernel(const float* __restrict__ logits, float* __restrict__ vals,
                    int* __restrict__ idx, float* __restrict__ lse, int R,
                    int V) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warp leaves together
  const float* p = logits + (size_t)row * V;

  TopK<K> top;
  top.init();
  float m = -INFINITY, s = 0.f;

  // Each lane visits its columns in increasing index order: an unaligned
  // head, a 16-byte-aligned body, a tail.
  int head = (int)(((16u - ((uintptr_t)p & 15u)) & 15u) / 4u);
  head = head < V ? head : V;
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

  // butterfly: after five rounds every lane holds the row's result
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
  topk_lse_kernel<K><<<blocks, WARPS * 32, 0, stream>>>(logits, vals, idx,
                                                        lse, R, V);
}

}  // namespace

// logits (R, V) f32 contiguous -> vals (R, k) f32, idx (R, k) int32,
// lse (R,) f32.  1 <= k <= 8 and k <= V.  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported k.
extern "C" int lrcn_topk_lse(const void* logits, void* vals, void* idx,
                             void* lse, int R, int V, int k, void* stream) {
  const float* x = static_cast<const float*>(logits);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(x, v, i, l, R, V, s); break;
    case 2: launch<2>(x, v, i, l, R, V, s); break;
    case 3: launch<3>(x, v, i, l, R, V, s); break;
    case 4: launch<4>(x, v, i, l, R, V, s); break;
    case 5: launch<5>(x, v, i, l, R, V, s); break;
    case 6: launch<6>(x, v, i, l, R, V, s); break;
    case 7: launch<7>(x, v, i, l, R, V, s); break;
    case 8: launch<8>(x, v, i, l, R, V, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
