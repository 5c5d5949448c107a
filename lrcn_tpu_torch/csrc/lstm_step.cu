// Fused LSTM step for Hopper (sm_90a).
//
// Replaces the TPU kernel lrcn_tpu/ops/pallas/lstm_step.py:fused_lstm_step_fn.
// Per row of the batch it computes
//
//     gates = [x, h] @ W + b            gate order [forget, ingate, outgate, change]
//     c'    = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h'    = sigmoid(o) * tanh(c')
//
// with operands rounded to the compute type (bf16 or f32), products summed
// in f32, and h', c' written in f32.  W is the packed (X+H, 4H) matrix of
// the JAX package, read in place as W[k, g*H + j]: no repacking and no
// concatenation of x and h.
//
// What bounds it on this card: at the decode step's shape (768 rows,
// X = H = 1000) one call is 2*768*2000*4000 = 12.3 GFLOP against 16 MB of
// bf16 weights, about 770 FLOP per weight byte.  That is above the H100's
// ~295 FLOP/byte ridge, so with tensor cores the kernel is compute-bound;
// every row tile re-reads the weights, which fit the 50 MB L2.  Measured at
// that shape in bf16: 0.149 ms on an NVIDIA H100 80GB HBM3 with a 700 W
// power limit (PERF.md), about 83 TFLOP/s: issue-bound, far from the
// tensor cores' peak.
//
// What the design does about it: each block owns a (128 rows x 32 hidden
// columns) tile and computes all four gate tiles of those columns, so the
// (B, 4H) gate pre-activations stay on chip and only x, h, c, W and the
// (B, H) outputs touch device memory.  The bf16 instantiation feeds the
// tensor cores through nvcuda::wmma 16x16x16 fragments (mma.sync); the f32
// instantiation is a plain FMA tile for parity runs.  The reduction walks
// X (reading x) and then H (reading h) as one sequence of 32-deep stages
// over the same weight columns, zero-padding each ragged tail.  Stages are
// double-buffered in shared memory: the next stage's global loads (16
// bytes a thread where the shapes allow) are in flight in registers while
// the tensor cores work on the current one, with one barrier per stage.
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 128;       // batch rows per block
constexpr int BN = 32;        // hidden columns per block, per gate
constexpr int BK = 32;        // reduction depth per stage
constexpr int NG = 4 * BN;    // gate columns per block
constexpr int THREADS = 256;  // 8 warps
constexpr int A_LD = BK + 8;  // padded leading dims (wmma needs multiples of 8)
constexpr int B_LD = NG + 8;
constexpr int C_LD = NG + 4;
constexpr int HALF = BM / 2;  // rows per epilogue pass
constexpr int A_VECS = BM * BK / 4 / THREADS;  // float4 loads a thread

template <typename T>
struct Stage {
  T a[BM][A_LD];  // activations in the compute type, row-major over k
  T b[BK][B_LD];  // weights: k rows x (4 gates * BN) columns
};

template <typename T>
struct Tile {
  static constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int VPT = 16 / sizeof(T);               // per 16 bytes
  static constexpr int B_VECS = BK * NG / VPT / THREADS;   // per thread
  static constexpr int SMEM = 2 * sizeof(Stage<T>);        // two stages
  static constexpr int MIN_BLOCKS = kTensorCores ? 2 : 1;  // per SM
};

// the epilogue's half tile of gates reuses the two stages' memory
static_assert(sizeof(float) * HALF * C_LD <= Tile<__nv_bfloat16>::SMEM, "");
static_assert(sizeof(float) * HALF * C_LD <= Tile<float>::SMEM, "");

// One stage's global data, held in registers between load and stash.
template <typename T>
struct Prefetch {
  float4 a[A_VECS];
  uint4 b[Tile<T>::B_VECS];
};

template <typename T>
__device__ __forceinline__ T to_compute(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
  }
}

// Rows [row0, row0+BM) x k [k0, k0+BK) of the f32 activations `src`
// (rows x kdim, row-major).  A warp reads four rows of 32 consecutive k.
template <bool VEC>
__device__ __forceinline__ void load_a(float4 (&ra)[A_VECS],
                                       const float* __restrict__ src,
                                       int rows, int kdim, int row0, int k0) {
#pragma unroll
  for (int e = 0; e < A_VECS; ++e) {
    const int v = threadIdx.x + e * THREADS;
    const int gr = row0 + v / (BK / 4), gk = k0 + (v % (BK / 4)) * 4;
    const float* p = src + (size_t)gr * kdim + gk;
    if constexpr (VEC) {  // kdim % 4 == 0: the vector is all in or all out
      ra[e] = (gr < rows && gk < kdim)
                  ? __ldg(reinterpret_cast<const float4*>(p))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const bool in = gr < rows;
      ra[e].x = (in && gk < kdim) ? p[0] : 0.f;
      ra[e].y = (in && gk + 1 < kdim) ? p[1] : 0.f;
      ra[e].z = (in && gk + 2 < kdim) ? p[2] : 0.f;
      ra[e].w = (in && gk + 3 < kdim) ? p[3] : 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_a(T (*as)[A_LD],
                                        const float4 (&ra)[A_VECS]) {
#pragma unroll
  for (int e = 0; e < A_VECS; ++e) {
    const int v = threadIdx.x + e * THREADS;
    T* dst = &as[v / (BK / 4)][(v % (BK / 4)) * 4];
    if constexpr (Tile<T>::kTensorCores) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(ra[e].x, ra[e].y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(ra[e].z, ra[e].w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst) = packed;
    } else {
      *reinterpret_cast<float4*>(dst) = ra[e];
    }
  }
}

// Weight rows [krow0+k0, krow0+k0+BK) (masked at kdim) and, for each gate
// g, columns g*H + [j0, j0+BN) (masked at H), as 16-byte vectors that never
// straddle two gates (BN is a multiple of VPT).
template <typename T, bool VEC>
__device__ __forceinline__ void load_b(uint4 (&rb)[Tile<T>::B_VECS],
                                       const T* __restrict__ w, int H,
                                       int krow0, int kdim, int k0, int j0) {
  constexpr int VPT = Tile<T>::VPT, PER_ROW = NG / VPT;
#pragma unroll
  for (int e = 0; e < Tile<T>::B_VECS; ++e) {
    const int v = threadIdx.x + e * THREADS;
    const int gk = k0 + v / PER_ROW, n = (v % PER_ROW) * VPT;
    const int j = j0 + n % BN;
    const T* p = w + (size_t)(krow0 + gk) * 4 * H + (size_t)(n / BN) * H + j;
    if constexpr (VEC) {  // H % VPT == 0: the vector is all in or all out
      rb[e] = (gk < kdim && j < H) ? __ldg(reinterpret_cast<const uint4*>(p))
                                   : make_uint4(0u, 0u, 0u, 0u);
    } else {
      T* dst = reinterpret_cast<T*>(&rb[e]);
#pragma unroll
      for (int i = 0; i < VPT; ++i)
        dst[i] = (gk < kdim && j + i < H) ? p[i] : to_compute<T>(0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_b(T (*bs)[B_LD],
                                        const uint4 (&rb)[Tile<T>::B_VECS]) {
  constexpr int PER_ROW = NG / Tile<T>::VPT;
#pragma unroll
  for (int e = 0; e < Tile<T>::B_VECS; ++e) {
    const int v = threadIdx.x + e * THREADS;
    *reinterpret_cast<uint4*>(&bs[v / PER_ROW][(v % PER_ROW) * Tile<T>::VPT]) =
        rb[e];
  }
}

// Stage s of the reduction: s < nx walks x against W[0:X], then h against
// W[X:X+H].
template <typename T, bool VEC>
__device__ __forceinline__ void fetch(Prefetch<T>& pf, int s, int nx,
                                      const float* x, const float* h,
                                      const T* w, int B, int X, int H,
                                      int row0, int j0) {
  if (s < nx) {
    load_a<VEC>(pf.a, x, B, X, row0, s * BK);
    load_b<T, VEC>(pf.b, w, H, 0, X, s * BK, j0);
  } else {
    const int k0 = (s - nx) * BK;
    load_a<VEC>(pf.a, h, B, H, row0, k0);
    load_b<T, VEC>(pf.b, w, H, X, H, k0, j0);
  }
}

template <typename T>
__device__ __forceinline__ void stash(Stage<T>& st, const Prefetch<T>& pf) {
  store_a<T>(st.a, pf.a);
  store_b<T>(st.b, pf.b);
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

using Frag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                    float>;
using Frags = Frag[2][4];
using Acc = float[BM / 16][NG / 16];

// One stage on the tensor cores: warp (wm, wn) owns rows wm*32.. and gate
// columns wn*64.. as 2x4 16x16 f32 fragments.
__device__ __forceinline__ void compute_stage(const Stage<__nv_bfloat16>& st,
                                              Frags& frag, Acc&) {
  namespace wmma = nvcuda::wmma;
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        fa[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], &st.a[wm * 32 + i * 16][kk], A_LD);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb;
      wmma::load_matrix_sync(fb, &st.b[kk][wn * 64 + f * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::mma_sync(frag[i][f], fa[i], fb,
                                                 frag[i][f]);
    }
  }
}

// One stage in f32 FMA: thread (ty, tx) owns rows ty+16r and columns tx+16q.
__device__ __forceinline__ void compute_stage(const Stage<float>& st, Frags&,
                                              Acc& acc) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 2
  for (int k = 0; k < BK; ++k) {
    float av[BM / 16], bv[NG / 16];
#pragma unroll
    for (int r = 0; r < BM / 16; ++r) av[r] = st.a[ty + 16 * r][k];
#pragma unroll
    for (int q = 0; q < NG / 16; ++q) bv[q] = st.b[k][tx + 16 * q];
#pragma unroll
    for (int r = 0; r < BM / 16; ++r)
#pragma unroll
      for (int q = 0; q < NG / 16; ++q)
        acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

// Rows [pass*HALF, (pass+1)*HALF) of the block's gate tile -> cs.
__device__ __forceinline__ void store_gates(float (*cs)[C_LD],
                                            const Frags& frag, const Acc&,
                                            int pass, __nv_bfloat16) {
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  if ((wm >> 1) != pass) return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      nvcuda::wmma::store_matrix_sync(
          &cs[(wm & 1) * 32 + i * 16][wn * 64 + f * 16], frag[i][f], C_LD,
          nvcuda::wmma::mem_row_major);
}

__device__ __forceinline__ void store_gates(float (*cs)[C_LD], const Frags&,
                                            const Acc& acc, int pass, float) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  constexpr int R = HALF / 16;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < NG / 16; ++q)
      cs[ty + 16 * r][tx + 16 * q] = pass ? acc[R + r][q] : acc[r][q];
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, Tile<T>::MIN_BLOCKS)
    lstm_step_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ c, const T* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ h_out,
                     float* __restrict__ c_out, int B, int X, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  Stage<T>* st = reinterpret_cast<Stage<T>*>(smem);
  float(*cs)[C_LD] = reinterpret_cast<float(*)[C_LD]>(smem);

  const int row0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;

  Frags frag;
  Acc acc;
  if constexpr (Tile<T>::kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < 4; ++f) nvcuda::wmma::fill_fragment(frag[i][f], 0.f);
  } else {
#pragma unroll
    for (int r = 0; r < BM / 16; ++r)
#pragma unroll
      for (int q = 0; q < NG / 16; ++q) acc[r][q] = 0.f;
  }

  // software pipeline: stage s+1's loads are in flight while s computes
  const int nx = (X + BK - 1) / BK;
  const int n = nx + (H + BK - 1) / BK;
  Prefetch<T> pf;
  fetch<T, VEC>(pf, 0, nx, x, h, w, B, X, H, row0, j0);
  stash<T>(st[0], pf);
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) fetch<T, VEC>(pf, s + 1, nx, x, h, w, B, X, H, row0, j0);
    compute_stage(st[s & 1], frag, acc);
    if (s + 1 < n) stash<T>(st[(s + 1) & 1], pf);
    __syncthreads();
  }

  // the fused epilogue, in two passes of HALF rows through shared memory:
  // bias + nonlinearities + cell update, h' and c' written in f32
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    if (pass) __syncthreads();  // pass 0's reads are done
    store_gates(cs, frag, acc, pass, T());
    __syncthreads();
#pragma unroll
    for (int e = 0; e < HALF * BN / THREADS; ++e) {
      const int idx = threadIdx.x + e * THREADS;
      const int r = idx / BN, jj = idx % BN;
      const int gr = row0 + pass * HALF + r, j = j0 + jj;
      if (gr < B && j < H) {
        const float gf = cs[r][jj] + b[j];
        const float gi = cs[r][BN + jj] + b[H + j];
        const float go = cs[r][2 * BN + jj] + b[2 * H + j];
        const float gg = cs[r][3 * BN + jj] + b[3 * H + j];
        const size_t o = (size_t)gr * H + j;
        const float cn = c[o] * sigmoidf(gf) + sigmoidf(gi) * tanhf(gg);
        c_out[o] = cn;
        h_out[o] = sigmoidf(go) * tanhf(cn);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const float* x, const float* h, const float* c, const T* w,
           const float* b, float* h_out, float* c_out, int B, int X, int H,
           cudaStream_t stream) {
  const bool vec = X % 4 == 0 && H % Tile<T>::VPT == 0 && aligned16(x) &&
                   aligned16(h) && aligned16(w);
  auto kernel = vec ? lstm_step_kernel<T, true> : lstm_step_kernel<T, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<T>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + BM - 1) / BM, (H + BN - 1) / BN);
  kernel<<<grid, THREADS, Tile<T>::SMEM, stream>>>(x, h, c, w, b, h_out,
                                                     c_out, B, X, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, X), h and c (B, H): f32.  w (X+H, 4H) in bf16 when `bf16` is set,
// else f32.  b (4H): f32.  Outputs h_out, c_out (B, H): f32.  All
// contiguous.  Launches on `stream`; returns cudaGetLastError() (or the
// error of setting the kernel's shared-memory size).
extern "C" int lrcn_lstm_step(const void* x, const void* h, const void* c,
                              const void* w, const void* b, void* h_out,
                              void* c_out, int B, int X, int H, int bf16,
                              void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* hf = static_cast<const float*>(h);
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(b);
  float* ho = static_cast<float*>(h_out);
  float* co = static_cast<float*>(c_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(xf, hf, cf, static_cast<const __nv_bfloat16*>(w), bf, ho,
                  co, B, X, H, s);
  return launch(xf, hf, cf, static_cast<const float*>(w), bf, ho, co, B, X,
                H, s);
}
