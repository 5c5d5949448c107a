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
// What bounds it on this card: one call is 2 * B * (X + H) * 4H
// operations against 16 MB of bf16 weights (X = H = 1000); from a few
// hundred rows on that is above the H100's ~295 FLOP/byte ridge, so the
// tensor cores set the floor (0.199 ms at 12,288 rows).  What kept the
// kernel off that floor was feeding them: x and h arrive in f32 and every
// 64-column tile reads them again, every 128-row tile reads W again, both
// from L2 (3.1 GB a call at 12,288 rows when nothing is shared), and
// these L2 reads, not the rounding to bf16, paced the mainloop (PERF.md).
// At 768 rows (96 tiles, under one wave) each block has one tile: the
// loads' latency and the epilogue are all there is to hide behind.
//
// Three routes, chosen by the wrapper (ops/kernels/lstm_step.py:
// lstm_step_route) and passed in as an int:
//
// wgmma (bf16 weights, X and H multiples of 4, 16-byte aligned: the decode
// step's shapes).  A persistent, warp-specialized Hopper GEMM with the
// cell update in its epilogue.  A tile is 128 rows x 64 hidden columns
// of all four gates: its N = 256 columns are [f | i | o | g], four
// 64-column strips W[k, q*H + j0 : q*H + j0 + 64] (a strip past H reads
// the next gate's columns, whose outputs are discarded; past 4H TMA
// fills zeros).  Two W maps, rows [0, X) and [X, X+H), so the K tail of
// x meets zero-filled weight rows, not h's.  The grid is at most one
// block an SM, in clusters of two that take the two row tiles of one
// column tile together and walk the tiles column tile fastest
// (wgmma_grid in the wrapper): the clusters in flight share their x and h
// rows in L2, and each block loads two of the four W strips and
// multicasts them to both, which halves W's L2 reads (2.3 GB a call).
// Warp 0 keeps a ring of 7 stages (32 K steps each: the f32 x or h tile,
// 16 KB, and the W strips, 16 KB) full with TMA loads, running into the
// next tile while the consumers finish this one.  Two consumer
// warpgroups own 64 rows each and feed A from registers: each thread
// reads its fragments of the next stage from the f32 tile and rounds
// them to bf16 while the current stage's wgmma.m64n256k16 run, so no
// copy of x or h is written anywhere and nothing but waits, a few loads
// and the wgmmas sits on their path.  The accumulator layout puts column
// j of all four gates in one thread, so the epilogue (bias, sigmoid/tanh,
// c' and h' in f32) reads its gates from registers and writes straight to
// global memory.  What is left of the gap to the floor: the epilogue,
// during which the tensor cores wait (about a fifth of the time at 12,288
// rows), and the f32 x and h that every column tile still reads from L2.
// Staging the epilogue's stores through shared memory for TMA cost the
// ring two stages and made the consumers spill; it was slower.
//
// wmma (bf16, ragged or unaligned shapes) and fma (f32, parity runs): v1.
// Each block owns the same (128 rows x 32 hidden columns) tile, fed through
// nvcuda::wmma 16x16x16 fragments (bf16) or a plain FMA tile (f32); the
// reduction walks X then H as one sequence of 32-deep stages,
// zero-padding each ragged tail, double-buffered through registers (16
// bytes a thread where the shapes allow), and the epilogue stages the
// gates through shared memory in two 64-row passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

// Route numbers shared with the wrapper (lstm_step.py:ROUTES).
enum Route { kFma = 0, kWmma = 1, kWgmma = 2 };

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

// ---- the wgmma route ----

namespace wg {

constexpr int BM = 128;          // rows per tile: 64 per consumer warpgroup
constexpr int BNH = 64;          // hidden columns per tile, per gate
constexpr int BK = 32;           // reduction depth per stage: 128 f32 bytes
constexpr int THREADS = 384;     // three warpgroups
constexpr int CONSUMERS = 256;   // warpgroups 1 and 2
constexpr int A_BYTES = BM * BK * 4;         // the f32 x or h tile
constexpr int STRIP_BYTES = BK * BNH * 2;    // one gate's bf16 W strip
constexpr int W_BYTES = 4 * STRIP_BYTES;
constexpr int STAGE = A_BYTES + W_BYTES;     // 1024-byte aligned parts
constexpr int STAGES = 7;
constexpr int CL = 2;            // blocks a cluster: row tiles sharing W
// the ring, aligned to the 1024-byte swizzle atom, and its barriers
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;

struct Maps {
  // f32 x (B, X), h (B, H); W rows [0,X), [X,X+H)
  CUtensorMap x, h, wx, wh;
};

// sigmoid and tanh from one __expf each, saturating without NaN at
// +-inf.  Over every finite f32 against double, their largest absolute
// errors are 1.2e-7 and 2.4e-7 (expf's sigmoid and tanhf: 0.9e-7 and
// 1.1e-7); tanh's relative error near 0 is large, but the cell update
// adds its absolute error.  They take 13% off the kernel at 12,288 rows
// against expf and tanhf (PERF.md).
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

__device__ __forceinline__ float tanh_(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The blocks of a cluster and the tiles they take.  A cluster of CL
// blocks takes CL row tiles of one column tile (a group), block `rank`
// the rank-th, and shares the column tile's W strips by multicast; a row
// tile past B (the last group's, or a single tile's partner) loads zeros
// and writes nothing.  Groups are numbered column tile fastest, so that
// the clusters in flight share their rows of x and h and between them
// read all of W; cluster k of K takes groups k, k + K, k + 2K, ..., and
// each block runs n stages in each: nx of x, then n - nx of h.
struct Tiles {
  int col_tiles, count, nx, n, rank;
  __device__ Tiles(int B, int X, int H)
      : col_tiles((H + BNH - 1) / BNH),
        count(((B + BM - 1) / BM + CL - 1) / CL * col_tiles),
        nx((X + BK - 1) / BK),
        n(nx + (H + BK - 1) / BK),
        rank(hopper::cluster_ctarank()) {}
  __device__ int first() const { return blockIdx.x / CL; }
  __device__ int step() const { return gridDim.x / CL; }
  __device__ int j0(int u) const { return u % col_tiles * BNH; }
  __device__ int row0(int u) const {
    return (u / col_tiles * CL + rank) * BM;
  }
};

// Warp 0: TMA loads, one thread, into a ring of stages: per stage an f32
// x or h tile and the four gates' W strips, of which each block of a
// cluster loads 4 / CL and multicasts them to both.  A strip past H reads
// the next gate's columns, whose outputs are discarded; past 4H, and for
// rows past B, TMA fills zeros.
__device__ __forceinline__ void load(const Maps& maps, const Tiles& tl,
                                     unsigned char* stages, uint64_t* full,
                                     uint64_t* empty, int H) {
  uint32_t g = 0;  // stages loaded by this block so far
  for (int u = tl.first(); u < tl.count; u += tl.step()) {
    const int j0 = tl.j0(u), row0 = tl.row0(u);
    for (int s = 0; s < tl.n; ++s, ++g) {
      const bool on_x = s < tl.nx;
      const int k0 = (on_x ? s : s - tl.nx) * BK;
      const uint32_t slot = g % STAGES;
      unsigned char* st = stages + slot * STAGE;
      // every block of the cluster has read this slot
      hopper::mbar_wait(&empty[slot], ((g / STAGES) & 1) ^ 1);
      hopper::mbar_expect_tx(&full[slot], STAGE);
      hopper::tma_load_2d(st, on_x ? &maps.x : &maps.h, &full[slot], k0,
                          row0);
      const CUtensorMap* wmap = on_x ? &maps.wx : &maps.wh;
#pragma unroll
      for (int i = 0; i < 4 / CL; ++i) {
        const int q = tl.rank * (4 / CL) + i;  // the strip of gate q
        unsigned char* dst = st + A_BYTES + q * STRIP_BYTES;
        hopper::tma_load_2d_multicast(dst, wmap, &full[slot], q * H + j0, k0,
                                      (1u << CL) - 1);
      }
    }
  }
}

// Warpgroups 1 and 2: rows 64 wg .. 64 wg + 63 of each tile, all 4 x 64
// columns, with A in registers.  Each stage s: issue two
// wgmma.m64n256k16 on stage s; wait for stage s-1's products and free its
// slot in every block of the cluster (its tiles came from them); while
// stage s's products run, read this thread's A fragments of stage s+1
// from its f32 tile and round them to bf16 in registers.  Then the
// epilogue: column j of the four gates sits in this thread's registers.
__device__ __forceinline__ void consume(const Tiles& tl,
                                        const unsigned char* stages,
                                        uint64_t* full, uint64_t* empty,
                                        const float* __restrict__ c,
                                        const float* __restrict__ b,
                                        float* __restrict__ h_out,
                                        float* __restrict__ c_out, int B,
                                        int H) {
  const int wg = (threadIdx.x >> 7) - 1, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gr = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + warp * 16 + gr;  // this thread's first A row
  const auto release = [&](uint32_t g) {
    if (lane != 0) return;
#pragma unroll
    for (uint32_t cta = 0; cta < CL; ++cta)
      hopper::mbar_arrive_cluster(&empty[g % STAGES], cta);
  };
  // stage g's A fragments: for each 16-deep half kk, rows r0 and r0 + 8
  // (hi) by k = 16 kk + 2 t4 (+1) and + 8 (kh), from the f32 tile's
  // 128-byte rows (16-byte chunk q of row r at chunk q ^ (r % 8)).
  const auto fragments = [&](uint32_t g, uint32_t (&f)[8]) {
    hopper::mbar_wait(&full[g % STAGES], (g / STAGES) & 1);
    const unsigned char* a = stages + (g % STAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = r0 + 8 * hi, q = 4 * kk + 2 * kh + (t4 >> 1);
          const float2 v = *reinterpret_cast<const float2*>(
              a + r * 128 + ((q ^ (r & 7)) << 4) + ((t4 & 1) << 3));
          f[4 * kk + 2 * kh + hi] = pack_bf16(v.x, v.y);
        }
  };
  uint32_t g = 0;  // stages consumed by this block so far
  for (int u = tl.first(); u < tl.count; u += tl.step()) {
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t fa[8], fb[8];
    const auto step = [&](const uint32_t (&cur)[8], uint32_t (&next)[8],
                          int s) {
      const unsigned char* w = stages + (g % STAGES) * STAGE + A_BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // B: 16 K rows of 128 bytes per gate strip, strips 4 KB apart
        const uint64_t db = hopper::make_desc(
            w + kk * 16 * 128, STRIP_BYTES, 1024, hopper::kSwizzle128B);
        hopper::wgmma_m64n256_rs(acc, cur + 4 * kk, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // stage s-1's products are done: free it
      if (s > 0) release(g - 1);
      if (s + 1 < tl.n) fragments(g + 1, next);
      ++g;
    };
    fragments(g, fa);
    for (int s = 0; s < tl.n; s += 2) {
      step(fa, fb, s);
      if (s + 1 < tl.n) step(fb, fa, s + 1);
    }
    hopper::wgmma_wait<0>();
    release(g - 1);

    // the epilogue: c's loads first, all at once
    const int j0 = tl.j0(u), row0 = tl.row0(u);
    float2 cv[2][BNH / 8];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int jq = 0; jq < BNH / 8; ++jq) {
        const int row = row0 + r0 + hi * 8, j = j0 + 8 * jq + 2 * t4;
        cv[hi][jq] = row < B && j < H
                         ? __ldg(reinterpret_cast<const float2*>(
                               c + (size_t)row * H + j))
                         : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int jq = 0; jq < BNH / 8; ++jq) {
      const int j = j0 + 8 * jq + 2 * t4;  // even; H is even
      if (j >= H) continue;
      float bias[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) bias[q][e] = __ldg(b + q * H + j + e);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = row0 + r0 + hi * 8;
        if (row >= B) continue;
        float cn[2], hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jq + 2 * hi + e;  // gate q at acc[32 q + i]
          const float cp = e ? cv[hi][jq].y : cv[hi][jq].x;
          cn[e] = cp * sigmoid(acc[i] + bias[0][e]) +
                  sigmoid(acc[32 + i] + bias[1][e]) *
                      tanh_(acc[96 + i] + bias[3][e]);
          hn[e] = sigmoid(acc[64 + i] + bias[2][e]) * tanh_(cn[e]);
        }
        const size_t o = (size_t)row * H + j;
        *reinterpret_cast<float2*>(c_out + o) = make_float2(cn[0], cn[1]);
        *reinterpret_cast<float2*>(h_out + o) = make_float2(hn[0], hn[1]);
      }
    }
  }
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 1)
    lstm_step_wgmma_kernel(const __grid_constant__ Maps maps,
                           const float* __restrict__ c,
                           const float* __restrict__ b,
                           float* __restrict__ h_out,
                           float* __restrict__ c_out, int B, int X, int H) {
  extern __shared__ unsigned char raw[];
  unsigned char* stages = hopper::align1024(raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const Tiles tl(B, X, H);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);  // the stage's bytes
      // freed by each consumer warp of the cluster
      hopper::mbar_init(&empty[s], CL * CONSUMERS / 32);
    }
    hopper::mbar_fence_init();
  }
  hopper::cluster_sync();

  if (threadIdx.x < 128) {  // warpgroup 0: warp 0 loads, the rest idle
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) load(maps, tl, stages, full, empty, H);
  } else {
    hopper::setmaxnreg_inc<232>();
    consume(tl, stages, full, empty, c, b, h_out, c_out, B, H);
  }
  // the other block's multicasts into this one and its arrivals on this
  // one's barriers are over
  hopper::cluster_sync();
}

int launch(const float* x, const float* h, const float* c,
           const __nv_bfloat16* w, const float* b, float* h_out,
           float* c_out, int B, int X, int H, int grid, cudaStream_t stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(h) |
                        reinterpret_cast<uintptr_t>(c) |
                        reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(h_out) |
                        reinterpret_cast<uintptr_t>(c_out);
  if (X % 4 != 0 || H % 4 != 0 || (any & 15u) != 0 || grid < 1 ||
      grid % CL != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  const uint64_t xdims[2] = {(uint64_t)X, (uint64_t)B};
  const uint64_t hdims[2] = {(uint64_t)H, (uint64_t)B};
  const uint64_t xstride[1] = {(uint64_t)X * 4};
  const uint64_t hstride[1] = {(uint64_t)H * 4};
  const uint32_t abox[2] = {BK, BM};
  const uint64_t wxdims[2] = {(uint64_t)4 * H, (uint64_t)X};
  const uint64_t whdims[2] = {(uint64_t)4 * H, (uint64_t)H};
  const uint64_t wstride[1] = {(uint64_t)8 * H};
  const uint32_t wbox[2] = {BNH, BK};  // 128-byte rows
  if (!hopper::make_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x, xdims,
                        xstride, abox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&maps.h, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, h, hdims,
                        hstride, abox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&maps.wx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w,
                        wxdims, wstride, wbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&maps.wh, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        w + (size_t)X * 4 * H, whdims, wstride, wbox,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_step_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_step_wgmma_kernel<<<grid, THREADS, SMEM, stream>>>(maps, c, b, h_out,
                                                          c_out, B, X, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---- the wmma and fma routes (v1) ----

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const float* x, const float* h, const float* c, const T* w,
           const float* b, float* h_out, float* c_out, int B, int X, int H,
           cudaStream_t stream) {
  // bf16 here is a ragged or unaligned shape (aligned ones take wgmma)
  auto kernel = lstm_step_kernel<T, false>;
  if constexpr (!Tile<T>::kTensorCores) {
    if (X % 4 == 0 && H % Tile<T>::VPT == 0 && aligned16(x) && aligned16(h) &&
        aligned16(w))
      kernel = lstm_step_kernel<T, true>;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<T>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + BM - 1) / BM, (H + BN - 1) / BN);
  kernel<<<grid, THREADS, Tile<T>::SMEM, stream>>>(x, h, c, w, b, h_out,
                                                     c_out, B, X, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, X), h and c (B, H): f32.  w (X+H, 4H) in bf16 for the wgmma and
// wmma routes, f32 for the fma route.  b (4H): f32.  Outputs h_out, c_out
// (B, H): f32.  All contiguous.  `route` is a Route.  Launches on
// `stream`; returns cudaGetLastError() (or the error of setting the
// kernel's shared-memory size, or cudaErrorInvalidValue for a shape or
// alignment the route does not take).
extern "C" int lrcn_lstm_step(const void* x, const void* h, const void* c,
                              const void* w, const void* b, void* h_out,
                              void* c_out, int B, int X, int H, int grid,
                              int route, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* hf = static_cast<const float*>(h);
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(b);
  float* ho = static_cast<float*>(h_out);
  float* co = static_cast<float*>(c_out);
  const auto* wh = static_cast<const __nv_bfloat16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case kWgmma:
      return wg::launch(xf, hf, cf, wh, bf, ho, co, B, X, H, grid, s);
    case kWmma:
      return launch(xf, hf, cf, wh, bf, ho, co, B, X, H, s);
    case kFma:
      return launch(xf, hf, cf, static_cast<const float*>(w), bf, ho, co, B,
                    X, H, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
