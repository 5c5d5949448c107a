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
// Three routes, chosen by the wrapper (ops/kernels/conv3x3.py:conv3x3_route)
// and passed in as an int:
//
// wgmma (bf16, C % 64 == 0, F % 64 == 0, 16-byte aligned; 12 of the 13 VGG
// convs).  A warp-specialized Hopper GEMM.  Each block owns 128 output
// pixels, a Wb x Hb box of one image (Wb in {8, 16, 32}, chosen per shape
// to waste the fewest pixels past the image's edge), times BN = 64 or 128
// filters.  One producer warp keeps a ring of shared-memory stages full
// with TMA loads; one consumer warpgroup runs wgmma.m64nBNk16 from shared
// memory, two per 16-deep step (pixels 0-63 and 64-127), with the f32 sums
// in registers.  With C % 64 == 0 a 64-deep K chunk lies inside one tap
// (dy, dx), so the A tile is a plain 4-D box of the NHWC input at
// (c0, ow0 + dx - 1, oh0 + dy - 1, n): TMA's zero fill of out-of-bounds
// elements IS the pad-1 halo, and the consumers compute no addresses.
// Chosen over Hopper's im2col TMA mode because the tiled mode needs no
// pixel-to-row arithmetic at all and the same 128-byte swizzle as the
// weights; over a cp.async gather because that is what made v1
// issue-bound.  The B tile is 64 K rows x BN filters of the (9C, F) weight
// matrix, loaded as 64-filter boxes and read MN-major (the transpose bit).
// Two blocks fit on an SM (160 threads, up to 99 KB of shared memory), so
// one block's epilogue overlaps the other's main loop; where
// the grid leaves a block an SM to itself, its ring is deeper (7-9
// stages).  BN is 64 where 128 would leave SMs without a block (the 14x14
// layers at B = 8).  Epilogue in registers: f32 bias, ReLU, bf16,
// 4-byte NHWC stores, rows past the image masked.
//
// scalar (bf16, any other C or F: conv1_1 has C = 3) and fma (f32, parity
// runs): v1.  Each block owns a tile of 128 pixels x 64 filters over
// stages of 32 reduction steps, gathered straight from the NHWC input
// (zeros written for the halo and the ragged tails).  bf16 feeds the
// tensor cores through nvcuda::wmma 16x16x16 fragments (8 warps of
// 32x32); f32 is a plain FMA tile, whose A and B loads are 16-byte
// cp.async into a three-stage ring where C and F are multiples of 4.  The
// epilogue stages the f32 tile through shared memory.
//
// Offsets into x and y are 64-bit: conv1_2 at B = 256 is 12.8 M pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

// Route numbers shared with the wrapper (conv3x3.py:ROUTES).
enum Route { kFma = 0, kScalar = 1, kWgmma = 2 };

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

// ---- the wgmma route ----

namespace wg {

constexpr int BM = 128;        // output pixels per block (a Wb x Hb box)
constexpr int BK = 64;         // reduction depth per stage: 128 bytes
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int A_BYTES = BM * BK * 2;
constexpr int BOX_BYTES = BK * 64 * 2;   // one 64-filter box of weights

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + BN / 64 * BOX_BYTES;
}

// Shared memory for a ring of `stages`, aligned to the 1024-byte swizzle
// atom, and its barriers.
constexpr int smem_bytes(int stage, int stages) {
  return stages * stage + 1024 + 2 * stages * 8;
}

struct Geom {
  int H, W, C, F;
  int wb_log2;                  // the box is 2^wb_log2 wide, BM / that tall
  int tiles_w, tiles_h, n_tiles;
  int stages;                   // ring depth
  int relu;
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y, Geom g) {
  constexpr int STAGE = stage_bytes<BN>();
  extern __shared__ unsigned char raw[];
  unsigned char* ring = hopper::align1024(raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + g.stages * STAGE);
  uint64_t* empty = full + g.stages;

  // filter tile fastest: the blocks in flight share their input tiles
  const int nt = blockIdx.x % g.n_tiles;
  int mt = blockIdx.x / g.n_tiles;
  const int tw = mt % g.tiles_w;
  mt /= g.tiles_w;
  const int th = mt % g.tiles_h;
  const int img = mt / g.tiles_h;
  const int ow0 = tw << g.wb_log2, oh0 = th * (BM >> g.wb_log2);
  const int n0 = nt * BN;
  const int c_steps = g.C / BK, nk = 9 * c_steps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread issues
    if (threadIdx.x == CONSUMERS) {
      int slot = 0, phase = 0;
      for (int s = 0; s < nk; ++s) {
        hopper::mbar_wait(&empty[slot], phase ^ 1);
        const int tap = s / c_steps, c0 = (s - tap * c_steps) * BK;
        const int dy = tap / 3, dx = tap - 3 * dy;
        unsigned char* st = ring + slot * STAGE;
        hopper::mbar_expect_tx(&full[slot], STAGE);
        hopper::tma_load_4d(st, &xmap, &full[slot], c0, ow0 + dx - 1,
                            oh0 + dy - 1, img);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          hopper::tma_load_2d(st + A_BYTES + q * BOX_BYTES, &wmap,
                              &full[slot], n0 + q * 64, tap * g.C + c0);
        if (++slot == g.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroup: pixels 0-63 and 64-127 of the box
  float acc[2][BN / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;

  int slot = 0, phase = 0, prev = g.stages - 1;
  for (int s = 0; s < nk; ++s) {
    hopper::mbar_wait(&full[slot], phase);
    const unsigned char* a = ring + slot * STAGE;
    const unsigned char* b = a + A_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B: 16 K rows of 128 bytes per 64-filter box, boxes 8 KB apart
      const uint64_t db = hopper::make_desc(b + kk * 16 * 128, BOX_BYTES,
                                            1024, hopper::kSwizzle128B);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // A: 64 pixel rows of 128 bytes, K advanced by 16 bf16 = 32 bytes
        const uint64_t da = hopper::make_desc(a + h * 64 * 128 + kk * 32, 16,
                                              1024, hopper::kSwizzle128B);
        if constexpr (BN == 128)
          hopper::wgmma_m64n128_ss(acc[h], da, db);
        else
          hopper::wgmma_m64n64_ss(acc[h], da, db);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // stage s-1's products are done: free it
    if (s > 0) hopper::mbar_arrive(&empty[prev]);
    prev = slot;
    if (++slot == g.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  hopper::wgmma_wait<0>();

  // epilogue: bias, ReLU, bf16, straight from the accumulator layout
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int wmask = (1 << g.wb_log2) - 1;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = h * 64 + warp * 16 + gr + hi * 8;
      const int oh = oh0 + (r >> g.wb_log2), ow = ow0 + (r & wmask);
      if (oh >= g.H || ow >= g.W) continue;
      __nv_bfloat16* row =
          y + (((long long)img * g.H + oh) * g.W + ow) * g.F + n0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * t;
        float v0 = acc[h][4 * j + 2 * hi] + __ldg(bias + n0 + col);
        float v1 = acc[h][4 * j + 2 * hi + 1] + __ldg(bias + n0 + col + 1);
        if (g.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// Shared memory an SM has for blocks, and what each block reserves.
constexpr int SM_SMEM = 233472, BLOCK_RESERVED = 1024;

template <int BN>
int launch_bn(const CUtensorMap& xmap, const CUtensorMap& wmap,
              const float* b, __nv_bfloat16* y, Geom g, long long grid,
              cudaStream_t stream) {
  // the deepest ring that still fits the blocks an SM will hold: two where
  // the grid has more blocks than SMs, else one
  constexpr int STAGE = stage_bytes<BN>();
  const int per_sm = grid > sm_count() ? 2 : 1;
  const int budget = SM_SMEM / per_sm - BLOCK_RESERVED;
  g.stages = 2;
  while (smem_bytes(STAGE, g.stages + 1) <= budget) ++g.stages;
  const int smem = smem_bytes(STAGE, g.stages);
  auto kernel = conv3x3_wgmma_kernel<BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), THREADS, smem, stream>>>(xmap, wmap,
                                                                 b, y, g);
  return static_cast<int>(cudaGetLastError());
}

int launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* b,
           __nv_bfloat16* y, int B, int H, int W, int C, int F, int relu,
           cudaStream_t stream) {
  if (C % BK != 0 || F % 64 != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) &
       15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.F = F;
  g.relu = relu;
  // the box shape that covers the image with the fewest tiles
  long long best = LLONG_MAX;
  for (int lg = 3; lg <= 5; ++lg) {
    const int tw = (W + (1 << lg) - 1) >> lg;
    const int th = (H + (BM >> lg) - 1) / (BM >> lg);
    if ((long long)tw * th < best) {
      best = (long long)tw * th;
      g.wb_log2 = lg;
      g.tiles_w = tw;
      g.tiles_h = th;
    }
  }
  const long long m_tiles = best * B;
  // 128 filters a block unless that leaves SMs without a block
  const bool wide = F % 128 == 0 && m_tiles * (F / 128) >= sm_count();
  g.n_tiles = wide ? F / 128 : F / 64;
  const long long grid = m_tiles * g.n_tiles;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);

  const uint64_t xdims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H,
                             (uint64_t)B};
  const uint64_t xstrides[3] = {(uint64_t)C * 2, (uint64_t)W * C * 2,
                                (uint64_t)H * W * C * 2};
  const uint32_t xbox[4] = {BK, 1u << g.wb_log2, (uint32_t)BM >> g.wb_log2,
                            1};
  const uint64_t wdims[2] = {(uint64_t)F, (uint64_t)9 * C};
  const uint64_t wstrides[1] = {(uint64_t)F * 2};
  const uint32_t wbox[2] = {64, BK};
  CUtensorMap xmap, wmap;
  if (!hopper::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, xdims,
                        xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, wdims,
                        wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  return wide ? launch_bn<128>(xmap, wmap, b, y, g, grid, stream)
              : launch_bn<64>(xmap, wmap, b, y, g, grid, stream);
}

}  // namespace wg

// ---- the scalar and fma routes (v1) ----

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const T* x, const T* w, const float* b, T* y, int B, int H, int W,
           int C, int F, int relu, cudaStream_t stream) {
  constexpr int VPT = Tile<T>::VPT;
  // bf16 here always takes the scalar gather (aligned shapes take wgmma)
  auto kernel = conv3x3_kernel<T, false>;
  if constexpr (!Tile<T>::kTensorCores) {
    if (C % VPT == 0 && F % VPT == 0 && aligned16(x) && aligned16(w))
      kernel = conv3x3_kernel<T, true>;
  }
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

// x (B, H, W, C) NHWC and w (3, 3, C, F) HWIO in bf16 for the wgmma and
// scalar routes, f32 for the fma route; b (F) f32; y (B, H, W, F) in the
// type of x.  All contiguous, B*H*W > 0.  `route` is a Route.  Launches on
// `stream`; returns cudaGetLastError() (or the error of setting the
// kernel's shared-memory size, or cudaErrorInvalidValue for a shape or
// alignment the route does not take).
extern "C" int lrcn_conv3x3(const void* x, const void* w, const void* b,
                            void* y, int B, int H, int W, int C, int F,
                            int relu, int route, void* stream) {
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xh = static_cast<const __nv_bfloat16*>(x);
  const auto* wh = static_cast<const __nv_bfloat16*>(w);
  auto* yh = static_cast<__nv_bfloat16*>(y);
  switch (route) {
    case kWgmma:
      return wg::launch(xh, wh, bf, yh, B, H, W, C, F, relu, s);
    case kScalar:
      return launch(xh, wh, bf, yh, B, H, W, C, F, relu, s);
    case kFma:
      return launch(static_cast<const float*>(x),
                    static_cast<const float*>(w), bf, static_cast<float*>(y),
                    B, H, W, C, F, relu, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
