// qbits_moe_tiled at M > 16 for Hopper (sm_90a): the batched-expert GEMM of MoE prefill.
//
//   out[u, m, :] = x[u, m, :] @ deq(W[e_u])^T   in float32,   e_u = eids[u] (or u without a table),
//   deq(W)[n, k] = s[g, n] * c[n, k] - z[g, n],   g = k / gs,
//
// computed group-factored as the TPU kernel computes it: for each group, the float32 sum
// acc = x_g . c_g, then y += acc * s_g - (sum_k x_gk) * z_g in float32, in that order (JAX's
// `acc += pd * s - xsum * z`). int4 or int2 codes over a stacked weight in the Hopper layout of
// qbits_mm.cuh (packed uint8 [E, N, K * BITS / 8], scale_t and shift_t float32 [E, G, N]); x bf16 or
// float32 [U, M, K] with contiguous rows and any slot stride (0: every slot reads the same rows);
// slots at or past the device count `nslots` write zeros and read no weight.
//
// Replaces quanto_tpu/ops/pallas/moe_mm.py:_moe_prefill_kernel (TPU kernel #14: slot u -> expert u)
// and the M > 16 shapes of _moe_prefill_uniq_kernel (#15: slot u -> expert eids[u]); slabs of at
// most 16 rows (#15's decode shape) keep moe_mm.cu's 16-row tile.
//
// Bound on this card by operations: 2 U M N K bf16 operations at 989 TFLOP/s, 1945 us for 8 slabs
// of 2048 rows at 14336 x 4096 (a weight code is used 2048 times per slab).
//
// Design: out = x . deq(W)^T with x on wgmma's 64-row side. A block owns a 128 x 128 output tile of
// one slot (tiles ordered in groups of 8 M tiles, hopper_gemm.cuh:tile_of) and walks K in stages of
// 64 codes. Two producer threads, one in each of two warps, keep a ring of RAW raw stages full
// with TMA copies: the x tile (128-byte swizzle, rows past M zero-filled) and, on a group's last
// stage, the group's 128 scales and shifts (1-D bulk copies); and the packed weight tile (32 bytes
// a row for int4, 16 for int2). Two consumer warpgroups, 64 x rows each, run wgmma m64n136k16
// bf16 -> f32 on each stage against its unpacked weight tile and 8 rows of bf16 ones written below
// it at the start, so that the last 8 columns of the product are the sums of x over the stage:
// each group's sum x_g comes out of the tensor cores beside x_g . c_g, with no pass over x. While
// the tensor cores run stage s, each of the 256 consumer threads unpacks one run of 32 codes of
// stage s + 1 into one of WB bf16 weight tiles (exact: hopper_gemm.cuh:word_bf16, a word at a
// time, into wgmma's swizzled K-major layout), so each weight code is unpacked once per 128 rows
// of x. At a group's last stage the warpgroup waits for its products and folds them into y with
// the group's scales and shifts from shared memory. A weight tile is rewritten three stages after
// the products that read it were issued, by which time both warpgroups have waited for them
// (WB >= 4). float32 x: a first pass of the same call splits x into bf16 high and low planes (a
// workspace of x's own bytes the wrapper allocates), and each stage multiplies both into one
// accumulator (x to about 16 bits), as the 16-row tile does.
//
// What holds it (NVIDIA H100 80GB HBM3, 700 W; the development calls' readings at 8 x 2048,
// 14336 x 4096, where torch.bmm on the bf16 weights takes 2.5 ms): the two 64 x 136 products of a
// stage read 51 KB of shared memory and the TMA writes 21 KB, so the stage runs near the shared-
// memory port's 128 bytes a cycle: with no unpack and no fold the pipeline alone took 3.74 ms, 52 %
// of the bf16 peak. Each group's fold waits for the group's products (the tensor cores idle
// meanwhile): a second accumulator set to fold under the next group's products needs 200
// registers beside the unpack's, more than a 320-thread block has; it gained 3-6 % in the design
// below where it fit. This design: 5.6 ms. Tried and left behind, in order: a transform warpgroup
// unpacking into the stage, its first thread also the producer, every thread arriving on the
// barriers (9.9 ms; one arrival a warp: 9.1 ms); a clock64 probe showed the producer blocked on the
// ring's release for ~1170 cycles a stage and the consumers waiting ~1530 for the unpack, each
// stage's unpack waiting on the products two stages back; a deeper ring with separate weight
// tiles, the producer still in the transform warps (10.3 ms: its TMA issues stall ~350 cycles a
// stage and the unpack behind them); a dedicated producer warp with three unpacking warps
// (5.8 ms, the unpack ~850 cycles a stage); four unpacking warps in a 416-thread block (10.1 ms:
// ptxas gives such a block 128 registers a thread and the consumers spill; with setmaxnreg asking
// 200 back the block deadlocked, the pool being smaller than that).
//
// Entry point with a plain C interface, called by moe_mm.cu:qbits_moe_tiled. It launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include "hopper_gemm.cuh"
#include "qbits_mm.cuh"
#include "wgmma.cuh"

namespace {

using namespace hg;
using namespace qbits;

constexpr int MG_BM = 128;   // x rows of a block: two consumer warpgroups of 64
constexpr int MG_BN = 128;   // weight rows of a block
constexpr int MG_ONES = 8;   // rows of bf16 ones below the weight rows: the product's x sums
constexpr int MG_NW = MG_BN + MG_ONES;
constexpr int MG_BK = 64;    // codes of a stage: one 128-byte row of bf16
constexpr int MG_CONSUMERS = 256;  // warpgroups 0 and 1

// Dynamic shared memory, each region 1024-byte aligned (the swizzle's period): RAW raw stages
// (a stage's x tile, P planes; its packed weight tile; on a group's last stage the group's scales
// and shifts), WB unpacked bf16 weight tiles (with the ones rows), and the barriers; 1024 bytes
// more to align the base.
template <int P, int BITS, int RAW, int WB>
struct MgPlan {
  static constexpr int x_tile = MG_BM * 128;
  static constexpr int p_tile = MG_BN * MG_BK * BITS / 8;
  static constexpr int f_tile = 2 * MG_BN * 4;  // scales, then shifts
  static constexpr int p_off = P * x_tile;      // in a raw stage
  static constexpr int f_off = p_off + p_tile;
  static constexpr int raw = f_off + f_tile;
  static constexpr int w_tile = MG_NW * 128;
  static constexpr int w_off = RAW * raw;
  static constexpr int bar_off = w_off + WB * w_tile;
  static constexpr int bytes = bar_off + (2 * RAW + WB) * 8 + 1024;
};

// Slot u's expert, or -1 when the slot is past the device count `nslots`.
__device__ __forceinline__ int slot_expert(const int* eids, const int* nslots, int u) {
  if (nslots != nullptr && u >= __ldg(nslots)) return -1;
  return eids != nullptr ? __ldg(eids + u) : u;
}

constexpr int MG_THREADS = MG_CONSUMERS + 64;  // + two producer warps: x tiles, packed tiles

template <int P, int BITS, int RAW, int WB>
__global__ void __launch_bounds__(MG_THREADS, 1) moe_gemm_kernel(
    __grid_constant__ const CUtensorMap xmap_hi, __grid_constant__ const CUtensorMap xmap_lo,
    __grid_constant__ const CUtensorMap wmap, int x_shared, const int* __restrict__ eids,
    const int* __restrict__ nslots, const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    float* __restrict__ out, int M, int N, int K, int gs) {
  using Plan = MgPlan<P, BITS, RAW, WB>;
  static_assert(WB >= 4, "a weight tile is rewritten three stages after its products were issued");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int u = blockIdx.y;
  int tm, tn;
  tile_of(blockIdx.x, (M + MG_BM - 1) / MG_BM, N / MG_BN, tm, tn);
  const int m0 = tm * MG_BM, n0 = tn * MG_BN;
  out += (size_t)u * M * N;
  const int e = slot_expert(eids, nslots, u);
  if (e < 0) {
    for (int i = threadIdx.x; i < MG_BM * MG_BN / 4; i += MG_THREADS) {
      const int r = m0 + i / (MG_BN / 4);
      if (r < M) reinterpret_cast<float4*>(out + (size_t)r * N + n0)[i % (MG_BN / 4)] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Plan::bar_off);  // a raw stage's copies arrived
  uint64_t* empty = full + RAW;   // its products and fold are done: the producers may refill it
  uint64_t* ready = empty + RAW;  // a weight tile is unpacked by all eight consumer warps
  if (threadIdx.x == 0) {
    for (int i = 0; i < RAW; ++i) {
      mbar_init(&full[i], 2);                   // the two producers' arrivals with their bytes
      mbar_init(&empty[i], MG_CONSUMERS / 32);  // one arrival a consumer warp
    }
    for (int i = 0; i < WB; ++i) mbar_init(&ready[i], MG_CONSUMERS / 32);
    mbar_init_fence();
  }
  for (int i = threadIdx.x; i < WB * MG_ONES * 8; i += MG_THREADS)  // bf16 1.0 = 0x3F80
    reinterpret_cast<uint4*>(smem + Plan::w_off + (i / (MG_ONES * 8)) * Plan::w_tile + MG_BN * 128)[i % (MG_ONES * 8)] =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
  fence_proxy_async();
  __syncthreads();

  const int nst = K / MG_BK;
  const int spg = gs / MG_BK;  // stages a group
  if (threadIdx.x >= MG_CONSUMERS) {
    // The producers, one thread of each of the two warps: stage q into raw slot q % RAW once the
    // consumers have released stage q - RAW; the first brings the x tile (and on a group's last
    // stage its scales and shifts), the second the packed weight tile.
    if ((threadIdx.x & 31) != 0) return;
    const bool x_side = threadIdx.x == MG_CONSUMERS;
    const int xu = x_shared ? 0 : u;
    const size_t G = (size_t)(K / gs);
    const float* s_src = scale_t + (size_t)e * G * N + n0;
    const float* z_src = shift_t + (size_t)e * G * N + n0;
    if (x_side) {
      tma_prefetch_map(&xmap_hi);
      if constexpr (P == 2) tma_prefetch_map(&xmap_lo);
    } else {
      tma_prefetch_map(&wmap);
    }
    for (int q = 0; q < nst; ++q) {
      if (q >= RAW) mbar_wait(&empty[q % RAW], ((q / RAW) & 1) ^ 1);
      unsigned char* st = smem + (q % RAW) * Plan::raw;
      uint64_t* bar = &full[q % RAW];
      if (x_side) {
        const bool last = (q + 1) % spg == 0;
        mbar_expect_tx(bar, P * Plan::x_tile + (last ? Plan::f_tile : 0));
        tma_load_3d(st, &xmap_hi, bar, q * MG_BK, m0, xu);
        if constexpr (P == 2) tma_load_3d(st + Plan::x_tile, &xmap_lo, bar, q * MG_BK, m0, xu);
        if (last) {
          const size_t g = (size_t)(q / spg);
          bulk_load(st + Plan::f_off, s_src + g * N, MG_BN * 4, bar);
          bulk_load(st + Plan::f_off + MG_BN * 4, z_src + g * N, MG_BN * 4, bar);
        }
      } else {
        mbar_expect_tx(bar, Plan::p_tile);
        tma_load_3d(st + Plan::p_off, &wmap, bar, q * MG_BK * BITS / 8, n0, e);
      }
    }
    return;
  }

  // The consumers: warpgroup wg takes x rows 64 wg .. 64 wg + 63 of the tile. Accumulator 4 j + i
  // of a thread is row 16 w + gid + 8 (i >> 1) of the warpgroup's 64, column 8 j + 2 tig + (i & 1)
  // (j < 16: weight rows; j = 16: the ones, so acc[64] and acc[66] are the x sums of its rows).
  // Each thread also unpacks run threadIdx.x of every stage: codes 32 (run & 1) .. + 31 of
  // weight row run >> 1.
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int run = threadIdx.x;
  float y[MG_BN / 2];
#pragma unroll
  for (int j = 0; j < MG_BN / 2; ++j) y[j] = 0.f;
  // Stage q's codes of this thread's run into weight tile wslot; then this warp's arrival.
  auto unpack = [&](int rslot, uint32_t rpar, int wslot) {
    mbar_wait(&full[rslot], rpar);
    const unsigned char* pb = smem + rslot * Plan::raw + Plan::p_off + run * 4 * BITS;
    unsigned char* wb = smem + Plan::w_off + wslot * Plan::w_tile;
    uint32_t cw[BITS];
    load_run_shared<BITS>(pb, cw);
#pragma unroll
    for (int q = 0; q < BITS; ++q) {
      uint32_t o[BITS == 4 ? 4 : 8];
      word_bf16<BITS>(cw[q], o);
#pragma unroll
      for (int c = 0; c < (BITS == 4 ? 1 : 2); ++c)
        *reinterpret_cast<uint4*>(wb + sw<128>(run >> 1, (run & 1) * 64 + (BITS == 4 ? 16 : 32) * q + 16 * c)) =
            make_uint4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&ready[wslot]);
  };
  auto fold = [&](float (&acc)[MG_NW / 2], int fslot) {
    fence_regs(acc);
    const float* fs = reinterpret_cast<const float*>(smem + fslot * Plan::raw + Plan::f_off) + 2 * tig;
    const float* fz = fs + MG_BN;
    const float x0 = acc[64], x1 = acc[66];
#pragma unroll
    for (int j = 0; j < MG_BN / 8; ++j) {
      const float2 s2 = *reinterpret_cast<const float2*>(fs + 8 * j);
      const float2 z2 = *reinterpret_cast<const float2*>(fz + 8 * j);
      y[4 * j + 0] += acc[4 * j + 0] * s2.x - x0 * z2.x;
      y[4 * j + 1] += acc[4 * j + 1] * s2.y - x0 * z2.y;
      y[4 * j + 2] += acc[4 * j + 2] * s2.x - x1 * z2.x;
      y[4 * j + 3] += acc[4 * j + 3] * s2.y - x1 * z2.y;
    }
  };
  Ring<RAW> r;
  Ring<WB> w;
  unpack(0, 0, 0);
  float acc[MG_NW / 2];
  int prev_r = -1;
  for (int s = 0, ph = 0; s < nst; ++s) {
    mbar_wait(&ready[w.slot], w.par);  // stage s's weight tile, from all eight warps
    const unsigned char* xb = smem + r.slot * Plan::raw + wg * 64 * 128;
    const uint64_t db = make_desc<128>(smem + Plan::w_off + w.slot * Plan::w_tile);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint64_t da = make_desc<128>(xb + p * Plan::x_tile);
#pragma unroll
      for (int ks = 0; ks < MG_BK / 16; ++ks)
        wg_bf16::wgmma<MG_NW>(acc, da + 2 * ks, db + 2 * ks, (ph == 0 && p == 0 && ks == 0) ? 0 : 1);
    }
    wgmma_commit();
    // Stage s + 1's codes while the tensor cores run stage s.
    Ring<RAW> r1 = r;
    Ring<WB> w1 = w;
    r1.next();
    w1.next();
    if (s + 1 < nst) unpack(r1.slot, r1.par, w1.slot);
    const bool last = ph == spg - 1;
    if (last)
      wgmma_wait<0>();
    else
      wgmma_wait<1>();
    if (prev_r >= 0 && lane == 0) mbar_arrive(&empty[prev_r]);  // stage s - 1's x tile, codes, factors
    if (last) fold(acc, r.slot);
    prev_r = r.slot;
    ph = last ? 0 : ph + 1;
    r = r1;
    w = w1;
  }
  const int row = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + gid;
#pragma unroll
  for (int j = 0; j < MG_BN / 8; ++j) {
    float* o = out + (size_t)row * N + n0 + 8 * j + 2 * tig;
    if (row < M) *reinterpret_cast<float2*>(o) = make_float2(y[4 * j], y[4 * j + 1]);
    if (row + 8 < M) *reinterpret_cast<float2*>(o + (size_t)8 * N) = make_float2(y[4 * j + 2], y[4 * j + 3]);
  }
}

// float32 x [U, M, K] (slot stride in elements) -> bf16 planes hi, lo [U, M, K] contiguous:
// hi = bf16(x), lo = bf16(x - hi). Four values a thread.
__global__ void __launch_bounds__(256) split_planes_kernel(const float* __restrict__ x, long long slot_stride,
                                                           int U, int M, int K, __nv_bfloat16* __restrict__ hi,
                                                           __nv_bfloat16* __restrict__ lo) {
  const long long per_slot = (long long)M * K / 4;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= per_slot * U) return;
  const long long u = i / per_slot, r = i % per_slot;
  const float4 v = reinterpret_cast<const float4*>(x + u * slot_stride)[r];
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y), h1 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
  __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(hi) + 2 * i;
  __nv_bfloat162* pl = reinterpret_cast<__nv_bfloat162*>(lo) + 2 * i;
  ph[0] = h0;
  ph[1] = h1;
  pl[0] = __floats2bfloat162_rn(v.x - f0.x, v.y - f0.y);
  pl[1] = __floats2bfloat162_rn(v.z - f1.x, v.w - f1.y);
}

// The x map of one bf16 plane [U, M, K] (slot stride in elements; U = 1 for shared rows): boxes of
// 64 values x 128 rows of one slot, 128-byte swizzle.
cudaError_t x_map(CUtensorMap* map, const void* x, long long slot_stride, int U, int M, int K) {
  const uint64_t row = (uint64_t)K * 2;
  return encode_map<3>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, {(uint64_t)K, (uint64_t)M, (uint64_t)U},
                       {row, U > 1 ? (uint64_t)slot_stride * 2 : row * M}, {MG_BK, MG_BM, 1},
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int P, int BITS, int RAW, int WB>
cudaError_t launch(const void* x, long long x_slot_stride, const int* eids, const int* nslots, const void* packed,
                   const float* scale_t, const float* shift_t, float* out, void* ws, int E, int U, int M, int N, int K,
                   int gs, cudaStream_t stream) {
  using Plan = MgPlan<P, BITS, RAW, WB>;
  const bool shared = x_slot_stride == 0 && U > 1;
  const int Ux = shared ? 1 : U;
  CUtensorMap hi, lo, wmap;
  cudaError_t e;
  if constexpr (P == 2) {
    __nv_bfloat16* h = static_cast<__nv_bfloat16*>(ws);
    __nv_bfloat16* l = h + (size_t)Ux * M * K;
    const long long quads = (long long)Ux * M * K / 4;
    split_planes_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(static_cast<const float*>(x),
                                                                             x_slot_stride, Ux, M, K, h, l);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = x_map(&hi, h, (long long)M * K, Ux, M, K);
    if (e == cudaSuccess) e = x_map(&lo, l, (long long)M * K, Ux, M, K);
  } else {
    e = x_map(&hi, x, x_slot_stride, Ux, M, K);
    lo = hi;
  }
  if (e != cudaSuccess) return e;
  const uint64_t kb = (uint64_t)K * BITS / 8;
  e = encode_map<3>(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, {kb, (uint64_t)N, (uint64_t)E}, {kb, kb * N},
                    {MG_BK * BITS / 8, MG_BN, 1}, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  auto kernel = moe_gemm_kernel<P, BITS, RAW, WB>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + MG_BM - 1) / MG_BM * (N / MG_BN), U);
  kernel<<<grid, MG_THREADS, Plan::bytes, stream>>>(hi, lo, wmap, shared ? 1 : 0, eids, nslots, scale_t, shift_t,
                                                     out, M, N, K, gs);
  return cudaGetLastError();
}

}  // namespace

// x [U, M, K] (bfloat16 when x_bf16, else float32) at slot stride `x_slot_stride` (elements); eids
// int32 [U] or NULL; nslots int32 scalar or NULL; packed [E, N, K * bits / 8], scale_t / shift_t
// [E, G, N]; out float32 [U, M, N]; ws: for float32 x, bf16 [2, U', M, K] (U' = 1 when the slot
// stride is 0 and U > 1, else U), else unused. gs % 64 == 0, N % 128 == 0.
extern "C" int qbits_moe_gemm(int device, const void* x, long long x_slot_stride, const void* eids,
                              const void* nslots, const void* packed, const void* scale_t, const void* shift_t,
                              void* out, void* ws, int E, int U, int M, int N, int K, int gs, int bits, int x_bf16,
                              void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (gs % MG_BK != 0 || N % MG_BN != 0 || (!x_bf16 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ei = static_cast<const int*>(eids);
  const int* ns = static_cast<const int*>(nslots);
  const float* sc = static_cast<const float*>(scale_t);
  const float* sh = static_cast<const float*>(shift_t);
  float* o = static_cast<float*>(out);
  if (bits == 4)
    return (int)(x_bf16 ? launch<1, 4, 6, 5>(x, x_slot_stride, ei, ns, packed, sc, sh, o, ws, E, U, M, N, K, gs, s)
                        : launch<2, 4, 4, 4>(x, x_slot_stride, ei, ns, packed, sc, sh, o, ws, E, U, M, N, K, gs, s));
  if (bits == 2)
    return (int)(x_bf16 ? launch<1, 2, 6, 5>(x, x_slot_stride, ei, ns, packed, sc, sh, o, ws, E, U, M, N, K, gs, s)
                        : launch<2, 2, 4, 4>(x, x_slot_stride, ei, ns, packed, sc, sh, o, ws, E, U, M, N, K, gs, s));
  return (int)cudaErrorInvalidValue;
}
