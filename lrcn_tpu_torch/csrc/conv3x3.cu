// Fused 3x3 convolution + bias + ReLU for Hopper (sm_90a), NHWC / HWIO.
//
// Replaces the TPU kernel lrcn_tpu/ops/pallas/conv3x3.py:fused_conv3x3_relu_fn.
// It computes
//
//     y = relu(conv3x3(x, w) + b)      cross-correlation, pad 1, stride 1
//
// with x and w in the compute type (bf16 or f32), products summed in f32,
// the f32 bias added to the f32 sum, ReLU optional, and y stored NHWC in
// the compute type.
//
// Formulation: an implicit GEMM.  With M = B*H*W output pixels, N = F
// filters and K = 9*C ordered (dy, dx, c), the HWIO weights already are a
// row-major (K, N) matrix, and row m of the (M, K) operand A is the 3x3xC
// neighbourhood of pixel m.  A is never materialised: each block gathers
// its A tile straight from the NHWC input and writes zeros where the
// pad-1 halo falls outside the image, so no padded copy of x exists.
//
// What bounds it on this card: the VGG-16 convs are compute-bound.  E.g.
// conv3_2 at B=8 (56x56, 256 -> 256) is M = 25,088, N = 256, K = 2,304:
// 29.6 GFLOP against ~13 MB of bf16 input, weights and output, about
// 2,300 FLOP per byte, far above the H100's ~295 FLOP/byte ridge.  Only
// conv1_1 (C = 3, K = 27) is bound by its 51 MB output write.
//
// What the design does about it: each block owns a tile of 128 pixels x 64
// filters, accumulated in f32 over stages of 32 reduction steps.  The bf16
// instantiation feeds the tensor cores through nvcuda::wmma 16x16x16
// fragments (mma.sync; 8 warps of 32x32); the f32 instantiation is a plain
// FMA tile for parity runs.  Where C and F are multiples of the 16-byte
// vector width, every A and B load is one 16-byte cp.async into a
// three-stage ring in shared memory, its source size set to 0 (zero fill)
// for the halo and the ragged tails; with C % 8 == 0 a vector never
// straddles two taps.  A ragged C or F (conv1_1 has C = 3) takes a scalar
// gather with the same masks.  The epilogue stages the f32 tile through
// the ring's shared memory and adds the bias, applies ReLU and casts.
// Offsets into x and y are 64-bit: conv1_2 at B = 256 is 12.8 M pixels.
// wgmma, TMA and larger tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // filters per block
constexpr int BK = 32;        // reduction depth per stage
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 256;  // 8 warps
constexpr int A_LD = BK + 8;  // padded leading dims (wmma: multiples of 8)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

template <typename T>
struct Stage {
  T a[BM][A_LD];  // gathered input rows: pixels x (dy, dx, c)
  T b[BK][B_LD];  // weights: k rows x filters
};

template <typename T>
struct Tile {
  static constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int VPT = 16 / sizeof(T);                // per 16 bytes
  static constexpr int A_VECS = BM * BK / VPT / THREADS;    // per thread
  static constexpr int B_VECS = BK * BN / VPT / THREADS;    // per thread
  static constexpr int SMEM = STAGES * sizeof(Stage<T>);
};

// the epilogue's f32 tile reuses the ring's memory
static_assert(sizeof(float) * BM * C_LD <= Tile<__nv_bfloat16>::SMEM, "");
static_assert(sizeof(float) * BM * C_LD <= Tile<float>::SMEM, "");

struct Shape {
  long long M;  // B * H * W output pixels
  int H, W, C, F, K;
};

template <typename T>
__device__ __forceinline__ T to_compute(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
  }
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (source size 0)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Output pixel m -> (image offset in pixels, row, column).
struct Pixel {
  long long base;  // b * H * W
  int oh, ow;
  bool ok;         // m < M
};

__device__ __forceinline__ Pixel pixel_of(long long m, const Shape& s) {
  Pixel p;
  p.ok = m < s.M;
  const long long hw = (long long)s.H * s.W;
  const long long img = p.ok ? m / hw : 0;
  const int r = p.ok ? static_cast<int>(m - img * hw) : 0;
  p.base = img * hw;
  p.oh = r / s.W;
  p.ow = r - p.oh * s.W;
  return p;
}

// Element offset of input channel c at tap (dy, dx) of pixel p, or -1 in
// the halo (and for rows past M).
__device__ __forceinline__ long long tap_offset(const Pixel& p, int k,
                                                const Shape& s) {
  const int tap = k / s.C;
  const int c = k - tap * s.C;
  const int dy = tap / 3;
  const int ih = p.oh + dy - 1;
  const int iw = p.ow + (tap - 3 * dy) - 1;
  if (!p.ok || k >= s.K || ih < 0 || ih >= s.H || iw < 0 || iw >= s.W)
    return -1;
  return (p.base + (long long)ih * s.W + iw) * s.C + c;
}

// One stage's loads: A rows [m0, m0+BM) x k [k0, k0+BK), B k [k0, k0+BK)
// x filters [n0, n0+BN).  VEC: 16-byte cp.async (C and F multiples of
// VPT); otherwise a scalar gather written straight to shared memory.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(Stage<T>& st,
                                           const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           const Pixel (&pix)[Tile<T>::A_VECS],
                                           long long m0, int n0, int k0,
                                           const Shape& s) {
  constexpr int VPT = Tile<T>::VPT;
  if constexpr (VEC) {
#pragma unroll
    for (int e = 0; e < Tile<T>::A_VECS; ++e) {
      const int v = threadIdx.x + e * THREADS;
      const int row = v / (BK / VPT), kk = (v % (BK / VPT)) * VPT;
      const long long off = tap_offset(pix[e], k0 + kk, s);
      cp_async16(&st.a[row][kk], off >= 0 ? x + off : x, off >= 0);
    }
#pragma unroll
    for (int e = 0; e < Tile<T>::B_VECS; ++e) {
      const int v = threadIdx.x + e * THREADS;
      const int kr = v / (BN / VPT), nn = (v % (BN / VPT)) * VPT;
      const int gk = k0 + kr, n = n0 + nn;
      const bool ok = gk < s.K && n < s.F;
      cp_async16(&st.b[kr][nn], ok ? w + (size_t)gk * s.F + n : w, ok);
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < BM * BK / THREADS; ++e) {
      const int v = threadIdx.x + e * THREADS;
      const int row = v / BK, kk = v % BK;
      const long long off = tap_offset(pixel_of(m0 + row, s), k0 + kk, s);
      st.a[row][kk] = off >= 0 ? x[off] : to_compute<T>(0.f);
    }
#pragma unroll 4
    for (int e = 0; e < BK * BN / THREADS; ++e) {
      const int v = threadIdx.x + e * THREADS;
      const int kr = v / BN, nn = v % BN;
      const int gk = k0 + kr, n = n0 + nn;
      st.b[kr][nn] = (gk < s.K && n < s.F) ? w[(size_t)gk * s.F + n]
                                           : to_compute<T>(0.f);
    }
  }
}

using Frag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                    float>;
using Frags = Frag[2][2];
using Acc = float[BM / 16][BN / 16];

// One stage on the tensor cores: warp (wm, wn) owns pixels wm*32.. and
// filters wn*32.. as 2x2 16x16 f32 fragments.
__device__ __forceinline__ void compute_stage(const Stage<__nv_bfloat16>& st,
                                              Frags& frag, Acc&) {
  namespace wmma = nvcuda::wmma;
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], &st.a[wm * 32 + i * 16][kk], A_LD);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(fb[j], &st.b[kk][wn * 32 + j * 16], B_LD);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(frag[i][j], fa[i], fb[j], frag[i][j]);
  }
}

// One stage in f32 FMA: thread (ty, tx) owns pixels ty+16r, filters tx+16q.
__device__ __forceinline__ void compute_stage(const Stage<float>& st, Frags&,
                                              Acc& acc) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float av[BM / 16], bv[BN / 16];
#pragma unroll
    for (int r = 0; r < BM / 16; ++r) av[r] = st.a[ty + 16 * r][k];
#pragma unroll
    for (int q = 0; q < BN / 16; ++q) bv[q] = st.b[k][tx + 16 * q];
#pragma unroll
    for (int r = 0; r < BM / 16; ++r)
#pragma unroll
      for (int q = 0; q < BN / 16; ++q)
        acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

__device__ __forceinline__ void store_tile(float (*cs)[C_LD],
                                           const Frags& frag, const Acc&,
                                           __nv_bfloat16) {
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(&cs[wm * 32 + i * 16][wn * 32 + j * 16],
                                      frag[i][j], C_LD,
                                      nvcuda::wmma::mem_row_major);
}

__device__ __forceinline__ void store_tile(float (*cs)[C_LD], const Frags&,
                                           const Acc& acc, float) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < BM / 16; ++r)
#pragma unroll
    for (int q = 0; q < BN / 16; ++q) cs[ty + 16 * r][tx + 16 * q] = acc[r][q];
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ y,
                   Shape s, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  Stage<T>* st = reinterpret_cast<Stage<T>*>(smem);
  float(*cs)[C_LD] = reinterpret_cast<float(*)[C_LD]>(smem);

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the pixels of this thread's A vectors are the same in every stage
  Pixel pix[Tile<T>::A_VECS];
  if constexpr (VEC) {
#pragma unroll
    for (int e = 0; e < Tile<T>::A_VECS; ++e)
      pix[e] = pixel_of(
          m0 + (threadIdx.x + e * THREADS) / (BK / Tile<T>::VPT), s);
  }

  Frags frag;
  Acc acc;
  if constexpr (Tile<T>::kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(frag[i][j], 0.f);
  } else {
#pragma unroll
    for (int r = 0; r < BM / 16; ++r)
#pragma unroll
      for (int q = 0; q < BN / 16; ++q) acc[r][q] = 0.f;
  }

  // a ring of STAGES stages: tile kt+STAGES-1 loads while tile kt computes
  const int nk = (s.K + BK - 1) / BK;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk) load_stage<T, VEC>(st[t], x, w, pix, m0, n0, t * BK, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();              // ... everyone's; stage kt-1 is free
    const int next = kt + STAGES - 1;
    if (next < nk)
      load_stage<T, VEC>(st[next % STAGES], x, w, pix, m0, n0, next * BK, s);
    cp_async_commit();
    compute_stage(st[kt % STAGES], frag, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's memory becomes the f32 tile

  store_tile(cs, frag, acc, T());
  __syncthreads();
  // bias + ReLU + cast; consecutive threads store consecutive filters
#pragma unroll 4
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, nn = idx % BN;
    const long long m = m0 + r;
    const int n = n0 + nn;
    if (m < s.M && n < s.F) {
      float v = cs[r][nn] + bias[n];
      if (relu) v = fmaxf(v, 0.f);
      y[m * s.F + n] = to_compute<T>(v);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const T* x, const T* w, const float* b, T* y, int B, int H, int W,
           int C, int F, int relu, cudaStream_t stream) {
  constexpr int VPT = Tile<T>::VPT;
  const bool vec = C % VPT == 0 && F % VPT == 0 && aligned16(x) &&
                   aligned16(w);
  auto kernel = vec ? conv3x3_kernel<T, true> : conv3x3_kernel<T, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<T>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape s;
  s.M = (long long)B * H * W;
  s.H = H;
  s.W = W;
  s.C = C;
  s.F = F;
  s.K = 9 * C;
  const long long m_tiles = (s.M + BM - 1) / BM;
  if (m_tiles > INT_MAX || (F + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(m_tiles), (F + BN - 1) / BN);
  kernel<<<grid, THREADS, Tile<T>::SMEM, stream>>>(x, w, b, y, s, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, W, C) NHWC and w (3, 3, C, F) HWIO in bf16 when `bf16` is set,
// else f32; b (F) f32; y (B, H, W, F) in the type of x.  All contiguous,
// B*H*W > 0.  Launches on `stream`; returns cudaGetLastError() (or the
// error of setting the kernel's shared-memory size).
extern "C" int lrcn_conv3x3(const void* x, const void* w, const void* b,
                            void* y, int B, int H, int W, int C, int F,
                            int relu, int bf16, void* stream) {
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(w), bf,
                  static_cast<__nv_bfloat16*>(y), B, H, W, C, F, relu, s);
  return launch(static_cast<const float*>(x), static_cast<const float*>(w),
                bf, static_cast<float*>(y), B, H, W, C, F, relu, s);
}
