// Hopper (sm_90a) building blocks shared by the wgmma kernels of this
// package (conv3x3.cu, lstm_step.cu): mbarriers, thread block clusters,
// TMA tiled loads (multicast too), the wgmma shared-memory descriptor and
// the wgmma instructions they use.
//
// The pipeline they make: one producer warp keeps a ring of shared-memory
// stages full with TMA loads, each stage guarded by a "full" mbarrier (the
// TMA's byte count completes it) and an "empty" mbarrier (the consumers
// arrive once they have read the stage: in a cluster whose blocks
// multicast into each other's stages, on every block's barrier); one or
// two consumer warpgroups run wgmma on the stages as they land, with f32
// accumulators in registers.
//
// TMA descriptors are encoded on the host with libcuda's
// cuTensorMapEncodeTiled, looked up at run time so that the library needs
// no -lcuda link, and passed to the kernels by value as
// __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

// ---- mbarriers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first address at or after p that is 1024-byte aligned in the shared
// window: the alignment of a 128-byte swizzle atom.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also tells the barrier to expect `bytes` of TMA data.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A pipeline fault
// that would wait forever traps instead (a launch error, not a hung card)
// after 2^30 polls, each of which may itself suspend the thread briefly.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- thread block clusters ----

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: the barriers initialised
// before it are seen by all of them, and no block leaves while another may
// still write its shared memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One arrival on the mbarrier at `bar`'s offset in block `cta` of the
// cluster (this block's own too).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(cta)
      : "memory");
}

// Hand registers back to the SM (dec) or take them (inc): every warp of a
// warpgroup runs it, and the block's total must stay within its launch
// allocation.  A warp-specialized kernel gives its loading warpgroup few
// registers and its wgmma warpgroups many.
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- TMA tiled loads (global -> shared), completion on an mbarrier ----

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same tile into the same offset of the shared memory of every block
// of the cluster named in `mask`, each completing its own barrier at
// `bar`'s offset.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----

// Shared-memory matrix descriptor.  Swizzle modes as the descriptor's
// layout field: 1 = 128-byte, 2 = 64-byte.  `lbo` and `sbo` in bytes:
//  K-major (rows of K, swizzled): sbo = stride between 8-row groups; lbo
//    is not used;
//  MN-major: lbo = stride between swizzle atoms along MN (64 elements for
//    128-byte, 32 for 64-byte swizzle), sbo = stride between 8-row groups
//    along K.
// The tile's base must be aligned to the swizzle atom (8 rows).
enum Swizzle : uint64_t { kSwizzle128B = 1, kSwizzle64B = 2 };

__device__ __forceinline__ uint64_t make_desc(const void* tile, uint32_t lbo,
                                              uint32_t sbo, Swizzle swz) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(swz) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulator of one m64nNk16: thread (warp w, lane l) holds, for
// j < N/8, d[4j + 0..3] = rows 16w + l/4 (+8 for 2, 3), columns
// 8j + 2(l%4) (+1 for 1, 3).
#define HOPPER_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_D32(i) \
  HOPPER_D8(i), HOPPER_D8(i + 8), HOPPER_D8(i + 16), HOPPER_D8(i + 24)

// d (64 x 64, f32) += A (64 x 16, bf16, K-major, shared) x B (16 x 64,
// bf16, MN-major, shared).
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : HOPPER_D32(0)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16, K-major, shared) x B (16 x 128,
// bf16, MN-major, shared).
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, "
      "0, 1;\n"
      "}\n"
      : HOPPER_D32(0), HOPPER_D32(32)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16, bf16, registers) x B (16 x 256, bf16,
// MN-major, shared).  Thread (warp w, lane l) of the warpgroup holds A's
// rows 16w + l/4 (a[0], a[2]) and 16w + l/4 + 8 (a[1], a[3]), columns
// 2(l%4), +1 (a[0], a[1]) and 2(l%4) + 8, +9 (a[2], a[3]), two bf16 a
// register, the lower column in the lower half.  The registers must not
// change until the product has been waited for.
__device__ __forceinline__ void wgmma_m64n256_rs(float (&d)[128],
                                                 const uint32_t* a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D32(0), HOPPER_D32(32), HOPPER_D32(64), HOPPER_D32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef HOPPER_D32
#undef HOPPER_D8

// ---- host: TMA descriptors ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tiled TMA map over a row-major tensor of `rank` dims given innermost
// first (`dims`, in elements; `strides` in bytes for dims 1..rank-1),
// loading boxes of `box` elements.  Out-of-bounds elements load as zero.
// Returns false if the encoding is refused (alignment, sizes).
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                     const void* base, const uint64_t* dims,
                     const uint64_t* strides, const uint32_t* box,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i + 1 < rank) gstride[i] = strides[i];
  }
  return encode(map, type, static_cast<cuuint32_t>(rank),
                const_cast<void*>(base), gdim, gstride, bdim, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
