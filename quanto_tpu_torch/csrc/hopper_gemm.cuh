// Building blocks of the pipelined Hopper GEMMs (sm_90a): the prefill GEMMs of qbits_mm_tiled.cu
// (TPU #2), the requant GEMM of qbits_mm_requant.cu (TPU #3) and the MoE prefill GEMM of
// moe_gemm.cu (TPU #14), and the wgmma operand layout and cp.async copies that the small-M kernels
// (small_m_tc.cuh, qbytes_mm.cu) share with them.
//
// The pipeline they build: a ring of STAGES shared-memory stages; TMA copies (cp.async.bulk.tensor,
// one thread issues a whole tile) complete on a "full" mbarrier per stage with the tile's byte
// count; consumer warpgroups wait on it, run asynchronous wgmma on the stage and arrive on the
// stage's "empty" mbarrier once their products no longer read it, which lets the producer copy the
// next tile into it. Tiles are K-major with 128-byte rows in wgmma's 128-byte swizzle, which is
// also the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B: chunk q (16 bytes) of row r at chunk
// q ^ (r & 7), each tile 1024-byte aligned. Rows past a tensor's end are zero-filled by TMA.
//
// Tensor maps are encoded on the host in the C entry points, through the driver's
// cuTensorMapEncodeTiled found with cudaGetDriverEntryPoint, so the library links no -lcuda, and
// are passed to the kernels as __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------------------------
// wgmma: the operand layout, its descriptor, and the fences around the asynchronous products.
// ---------------------------------------------------------------------------------------------

// A tile of OPR-byte rows (128 or 64) in wgmma's swizzled K-major layout: the 16-byte chunk q of
// row r at chunk q ^ (r & 7) of the row (128-byte swizzle) or q ^ ((r >> 1) & 3) (64-byte
// swizzle), rows contiguous, the tile aligned to 1024 bytes. Byte b of row r:
template <int OPR>
__device__ __forceinline__ int sw(int r, int b) {
  if constexpr (OPR == 128)
    return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
  else
    return r * 64 + ((((b >> 4) ^ (r >> 1)) & 3) << 4) + (b & 15);
}

// The wgmma descriptor of a swizzled tile (sw<OPR>) at p: 8-row groups 8 * OPR bytes apart, the
// layout 128-byte (1) or 64-byte (2) swizzle. A K step of 32 bytes adds 2 to it.
template <int OPR>
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  constexpr uint64_t layout = OPR == 128 ? 1 : 2;
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * OPR) >> 4) << 32) | (layout << 62);
}

// Generic-proxy stores to shared memory made visible to the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) asm volatile("" : "+f"(d[j])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) asm volatile("" : "+r"(d[j])::"memory");
}

// ---------------------------------------------------------------------------------------------
// Codes to bf16 for a wgmma operand tile.
// ---------------------------------------------------------------------------------------------

// Word q of a run of 32 codes (code t at bit BITS * t) as bf16, exact: each code is OR-ed into the
// mantissa of bf16 128 (0x4300, step 1 there) and 128 is subtracted. int4: codes 8q .. 8q + 7 as 4
// bf16 pairs in K order (o[j] = codes 2j, 2j + 1), the mask 0x000F000F on the word shifted by 4i
// taking codes i and i + 4; int2: codes 16q .. 16q + 15 as 8 pairs, 0x00030003 on the word
// shifted by 2i (or 8 + 2i) taking codes i and i + 8 (or 4 + i and 12 + i); a __byte_perm pairs
// neighbours.
template <int BITS>
__device__ __forceinline__ void word_bf16(uint32_t w, uint32_t (&o)[BITS == 4 ? 4 : 8]) {
  constexpr uint32_t kMagic = 0x43004300u;
  const __nv_bfloat162 k128 = __floats2bfloat162_rn(128.f, 128.f);
  uint32_t p[BITS == 4 ? 4 : 8];
  if constexpr (BITS == 4) {
    uint32_t t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = ((w >> (4 * i)) & 0x000F000Fu) | kMagic;  // codes i, i + 4
    p[0] = __byte_perm(t[0], t[1], 0x5410);  // codes 0, 1
    p[1] = __byte_perm(t[2], t[3], 0x5410);  // 2, 3
    p[2] = __byte_perm(t[0], t[1], 0x7632);  // 4, 5
    p[3] = __byte_perm(t[2], t[3], 0x7632);  // 6, 7
  } else {
    uint32_t t[4], u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t[i] = ((w >> (2 * i)) & 0x00030003u) | kMagic;      // codes i, 8 + i
      u[i] = ((w >> (8 + 2 * i)) & 0x00030003u) | kMagic;  // codes 4 + i, 12 + i
    }
    p[0] = __byte_perm(t[0], t[1], 0x5410);  // codes 0, 1
    p[1] = __byte_perm(t[2], t[3], 0x5410);  // 2, 3
    p[2] = __byte_perm(u[0], u[1], 0x5410);  // 4, 5
    p[3] = __byte_perm(u[2], u[3], 0x5410);  // 6, 7
    p[4] = __byte_perm(t[0], t[1], 0x7632);  // 8, 9
    p[5] = __byte_perm(t[2], t[3], 0x7632);  // 10, 11
    p[6] = __byte_perm(u[0], u[1], 0x7632);  // 12, 13
    p[7] = __byte_perm(u[2], u[3], 0x7632);  // 14, 15
  }
#pragma unroll
  for (int j = 0; j < (BITS == 4 ? 4 : 8); ++j) {
    const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p[j]), k128);
    o[j] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

// A run's 32 codes (BITS words) as 16 bf16 pairs in K order: o[j] = codes 2j, 2j + 1.
template <int BITS>
__device__ __forceinline__ void codes_bf16(const uint32_t (&w)[BITS], uint32_t (&o)[16]) {
#pragma unroll
  for (int q = 0; q < BITS; ++q) {
    uint32_t v[BITS == 4 ? 4 : 8];
    word_bf16<BITS>(w[q], v);
#pragma unroll
    for (int j = 0; j < (BITS == 4 ? 4 : 8); ++j) o[(BITS == 4 ? 4 : 8) * q + j] = v[j];
  }
}

// A run of 32 codes (4 * BITS bytes) from shared memory, as qbits_mm.cuh:load_run reads it from
// global memory.
template <int BITS>
__device__ __forceinline__ void load_run_shared(const unsigned char* p, uint32_t (&w)[BITS]) {
  if constexpr (BITS == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  }
}

// ---------------------------------------------------------------------------------------------
// cp.async: 16-byte copies global -> shared issued by every thread (the small-M kernels' rings).
// ---------------------------------------------------------------------------------------------

// 16 bytes global -> shared, the bytes past `src_bytes` (0 or 16) zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
// The same for a stream read once along rows: the L2 fetches the whole 256-byte aligned span around
// the chunk, so a block walking K in 64-byte steps draws each span from device memory in one access
// and finds the next steps' bytes in L2.
__device__ __forceinline__ void cp_async16_pf256(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------------------------
// mbarriers and TMA.
// ---------------------------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialized barriers visible to the other threads and to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also tells the barrier how many bytes the stage's copies will bring.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Waits until the barrier's current phase differs from `parity` (the phase it completes flips it).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of a 2-D / 3-D tensor map into shared memory at dst, completing on bar; coordinates
// innermost first, in elements.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to shared memory,
// completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// A ring position: stage s's slot in a ring of D and the parity of its use of that slot.
template <int D>
struct Ring {
  int slot = 0;
  uint32_t par = 0;
  __device__ __forceinline__ void next() {
    if (++slot == D) {
      slot = 0;
      par ^= 1;
    }
  }
};

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---------------------------------------------------------------------------------------------
// The order of a grid's output tiles: groups of GROUP_M M tiles, M fastest inside a group, so that
// the blocks resident at one time share a few weight tiles and a few x tiles (both stay in L2).
// ---------------------------------------------------------------------------------------------
constexpr int GROUP_M = 8;

__device__ __forceinline__ void tile_of(int b, int m_tiles, int n_tiles, int& tm, int& tn) {
  const int per_group = GROUP_M * n_tiles;
  const int first = (b / per_group) * GROUP_M;
  const int rows = min(m_tiles - first, GROUP_M);
  const int r = b % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

// ---------------------------------------------------------------------------------------------
// Host: tensor maps.
// ---------------------------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of RANK (2 or 3) dimensions, innermost first: dims and box in elements, strides
// of dimensions 1 .. RANK - 1 in bytes. Returns cudaErrorInvalidValue where the driver refuses it.
template <int RANK>
cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, const uint64_t (&dims)[RANK],
                       const uint64_t (&strides)[RANK - 1], const uint32_t (&box)[RANK],
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorInvalidValue;
  cuuint64_t d[RANK], s[RANK > 1 ? RANK - 1 : 1];
  cuuint32_t b[RANK], es[RANK];
  for (int i = 0; i < RANK; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    es[i] = 1;
  }
  for (int i = 0; i + 1 < RANK; ++i) s[i] = strides[i];
  const CUresult r = fn(map, type, RANK, const_cast<void*>(base), d, s, b, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hg
