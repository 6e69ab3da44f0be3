// The prefill group-wise dequant matmuls (M > 512) for Hopper (sm_90a), as pipelined wgmma GEMMs:
//
//   qbits_mm_tiled       y[M, N] = x[M, K] @ deq(W)^T, x bfloat16 or float32, y in x's dtype;
//   qbits_mm_tiled_int8  y[M, N] = sx * (xq[M, K] @ deq(W)^T), xq int8 (W4A8, W2A8), y bfloat16 or
//                        float32,
//
// deq(W)[n, k] = s[g, n] * c[n, k] - z[g, n] (g = k / gs), computed group-factored as the TPU
// kernel computes it: for each group the sum acc = x_g . c_g (float32 for float x, exact int32 for
// int8 x), then y += acc * s_g - (sum_k x_gk) * z_g in float32, in that order (JAX's
// `acc += pd * s - xsum * z`, quanto_tpu/ops/pallas/qbits_mm.py:279), the int8 arm's y times sx at
// the end. int4 or int2 codes in the Hopper layout of qbits_mm.cuh; any M >= 1, N % 128 == 0, any
// gs % 64 == 0 dividing K (gs = K included).
//
// Replaces quanto_tpu/ops/pallas/qbits_mm.py:_prefill_kernel (TPU kernel #2), both arms: float x
// and int8 x (:248-251).
//
// Bound on this card by operations at prompt lengths: 2 M N K at 989 TFLOP/s (bf16) or 1979 TOP/s
// (int8): 486 us / 243 us at M = 4096, N = 14336, K = 4096.
//
// Design: three passes in one call, on a workspace the wrapper allocates (tiled_workspace_bytes
// in ops/cuda/qbits_mm.py plans it as ws_layout below; freed when the call returns).
// 1. unpack_codes_kernel writes the weight's codes once per call, exact, as bf16 (float x: 2 N K
//    bytes, 117 MB at 14336 x 4096) or as int8 (int8 x: N K bytes), one thread per packed word:
//    the weight stays in its int4 / int2 form between calls, as in JAX.
// 2. x_pass_kernel sums x over each group of each row once (xsum_t float32 [G, M rounded up to
//    TG_BM], exact in int32 for int8 x); for float32 x it also writes x's bf16 high and low planes,
//    hi = bf16(x), lo = bf16(x - hi), which the tensor cores multiply both (x to about 16 bits).
// 3. tiled_gemm_kernel, persistent: min(tiles, SMs) blocks walk the 192 x 128 output tiles in
//    groups of 8 M tiles (hopper_gemm.cuh:tile_of). One producer thread, in a warpgroup of its
//    own, keeps a ring of as many shared-memory stages as fit (5 for bf16 or int8 x, 3 for float32
//    x) full with TMA copies: each stage the x tile (one 128-byte row of 64 bf16 or 128 int8
//    values per x row, 128-byte swizzle, rows past M zero-filled) or its two planes, the code tile
//    (128 weight rows alike), and on a stage where groups end, each such group's 128 scales, 128
//    shifts and the tile rows' 192 x sums (1-D bulk copies). Three consumer warpgroups, 64 x rows
//    each, run wgmma m64n128k16 bf16 -> f32 or m64n128k32 s8 -> s32 on the stages as they arrive,
//    64 values (a unit) at a time, and release a stage once its products are done. At a group's
//    end a warpgroup waits for its products and folds the accumulators into y in registers (64 +
//    64 a thread): y += acc * s - (sum x) * z, the int32 sums converted by I2FP. The fold stops
//    that warpgroup's products; the other two keep the tensor cores busy meanwhile, each starting
//    a unit behind the one before so that the folds fall apart in time.
//
// What holds it (NVIDIA H100 80GB HBM3, 700 W; throwaway builds of this file, M = 4096, 14336 x
// 4096): the tiles come from L2 at 40 KB a 192 x 128 x 64 stage, and with the products removed the
// copies alone take about as long as the whole kernel, near L2's rate; the int8 arm is held by the
// folds (a fold a 128 codes costs it as much as its products). Tried and left behind: two consumer
// warpgroups on 128 x 128 tiles (about 10 % slower: more L2 bytes a product, and two warpgroups
// cannot keep the tensor cores busy through a fold); a second accumulator set to fold one group
// under the next group's products (ptxas serializes wgmma when other instructions read any
// accumulator while products are in flight, C7514: slower than one set); the warpgroups taking
// strict turns at each stage through named barriers (slower); a fold placed in a branch of the
// unit loop (ptxas serializes wgmma around waits in paths it cannot prove uniform, C7518: the
// loop is now groups of units, releases predicated); the int32 sums turned to float32 through the
// bits of 1.5 * 2^23 (an add and a subtract; I2FP is one instruction and was a little faster).
//
// Entry points have a plain C interface (bound with ctypes in ops/cuda/qbits_mm.py). They launch
// on the stream they are given, allocate nothing, and return cudaGetLastError().

#include <type_traits>

#include "hopper_gemm.cuh"
#include "qbits_mm.cuh"
#include "wgmma.cuh"

namespace {

using namespace hg;
using namespace qbits;

constexpr int TG_WGS = 3;           // consumer warpgroups, 64 x rows each
constexpr int TG_BM = 64 * TG_WGS;  // x rows of a tile
constexpr int TG_BN = 128;          // weight rows (output columns) of a tile
constexpr int TG_ROW = 128;         // bytes of a tile row in a stage: 64 bf16 or 128 int8 values
constexpr int TG_UNIT = 64;         // values between two places a group may end (gs % 64 == 0)
constexpr int TG_CONSUMERS = 128 * TG_WGS;
constexpr int TG_THREADS = TG_CONSUMERS + 128;  // + the producer's warpgroup (one thread works)
// Registers a thread: ptxas gives the 512-thread block 128; the producer's warpgroup hands most
// of its own to the consumers (setmaxnreg): 128 x 24 + 384 x 160 <= 512 x 128.
constexpr int TG_PRODUCER_REGS = 24, TG_CONSUMER_REGS = 160;
static_assert(TG_PRODUCER_REGS * 128 + TG_CONSUMER_REGS * TG_CONSUMERS <= 65536,
              "setmaxnreg asks more registers than the block holds");
constexpr int TG_FACTORS = (2 * TG_BN + TG_BM) * 4;  // a group's scales, shifts and x sums (bytes)
constexpr int TG_LAG = 1;  // units each warpgroup starts behind the one before

// The workspace: the codes [N, K] (2 or 1 bytes each), then xsum_t float32 [G, mpad], then for
// float32 x its bf16 planes hi, lo [M, K]. ops/cuda/qbits_mm.py:tiled_workspace_bytes mirrors it.
struct WsLayout {
  size_t codes, xsum, planes;
  int mpad;
};

WsLayout ws_layout(int M, int N, int K, int gs, int code_bytes) {
  WsLayout l;
  l.mpad = (M + TG_BM - 1) / TG_BM * TG_BM;
  l.codes = 0;
  l.xsum = (size_t)N * K * code_bytes;
  l.planes = l.xsum + (size_t)(K / gs) * l.mpad * 4;
  return l;
}

// Named barrier `id` between two warpgroups: one waits (bar_sync), the other arrives.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// One arrival on bar by the threads where p holds, predicated rather than branched on.
__device__ __forceinline__ void arrive_if(uint64_t* bar, bool p) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
                   smem_addr(bar)),
               "r"((int)p)
               : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------------------------
// Pass 1: the codes, one thread per packed 32-bit word (8 int4 or 16 int2 codes, in K order along
// the rows, which lie end to end), so that neighbouring threads read and write neighbouring bytes.
// ---------------------------------------------------------------------------------------------
template <int BITS, bool INT8>
__global__ void __launch_bounds__(256) unpack_codes_kernel(const uint32_t* __restrict__ packed,
                                                           unsigned char* __restrict__ codes, long long words) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= words) return;
  const uint32_t w = __ldg(packed + i);
  if constexpr (INT8 && BITS == 4) {  // byte j of w: codes 2j (low nibble), 2j + 1
    const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
    reinterpret_cast<uint2*>(codes)[i] = make_uint2(__byte_perm(lo, hi, 0x5140), __byte_perm(lo, hi, 0x7362));
  } else if constexpr (INT8) {  // crumb plane c: byte b holds code 4b + c
    uint32_t o[4];
    transpose4(w & 0x03030303u, (w >> 2) & 0x03030303u, (w >> 4) & 0x03030303u, (w >> 6) & 0x03030303u, o[0],
               o[1], o[2], o[3]);
    reinterpret_cast<uint4*>(codes)[i] = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    uint32_t o[BITS == 4 ? 4 : 8];
    word_bf16<BITS>(w, o);
    uint4* dst = reinterpret_cast<uint4*>(codes) + i * (BITS == 4 ? 1 : 2);
    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
    if constexpr (BITS == 2) dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// ---------------------------------------------------------------------------------------------
// Pass 2: x's group sums (and float32 x's bf16 planes): each lane sums its chunks in order, then
// a fixed shuffle tree sums the lanes of a group.
// ---------------------------------------------------------------------------------------------
// The sum of 16 bytes of x (8 bf16, 4 float32 or 16 int8 values), in order; for float32 x also
// their bf16 high and low planes.
__device__ __forceinline__ float chunk_sum(const __nv_bfloat16* p, __nv_bfloat16*, __nv_bfloat16*) {
  float f[8];
  load8(p, f);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += f[i];
  return s;
}

__device__ __forceinline__ float chunk_sum(const float* p, __nv_bfloat16* hi, __nv_bfloat16* lo) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(f.x, f.y), h1 = __floats2bfloat162_rn(f.z, f.w);
  const float2 g0 = __bfloat1622float2(h0), g1 = __bfloat1622float2(h1);
  const __nv_bfloat162 l0 = __floats2bfloat162_rn(f.x - g0.x, f.y - g0.y);
  const __nv_bfloat162 l1 = __floats2bfloat162_rn(f.z - g1.x, f.w - g1.y);
  *reinterpret_cast<uint2*>(hi) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&h0), *reinterpret_cast<const uint32_t*>(&h1));
  *reinterpret_cast<uint2*>(lo) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&l0), *reinterpret_cast<const uint32_t*>(&l1));
  return ((f.x + f.y) + f.z) + f.w;
}

__device__ __forceinline__ int chunk_sum(const int8_t* p, __nv_bfloat16*, __nv_bfloat16*) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  int s = __dp4a(v.x, 0x01010101, 0);
  s = __dp4a(v.y, 0x01010101, s);
  s = __dp4a(v.z, 0x01010101, s);
  return __dp4a(v.w, 0x01010101, s);
}

template <typename TX>
__global__ void __launch_bounds__(256) x_pass_kernel(const TX* __restrict__ x, float* __restrict__ xsum_t,
                                                     __nv_bfloat16* __restrict__ hi, __nv_bfloat16* __restrict__ lo,
                                                     int M, int K, int gs, int mpad) {
  using Sum = typename std::conditional<std::is_same<TX, int8_t>::value, int, float>::type;
  constexpr int V = 16 / sizeof(TX);
  const int G = K / gs;
  const int L = gs / V;
  const long long w = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (L <= 32 && (L & (L - 1)) == 0) {
    const long long v = (w * 32 + lane) * V;
    const bool in = v < (long long)M * K;
    Sum s = in ? chunk_sum(x + v, hi + v, lo + v) : 0;
    for (int d = L / 2; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (in && lane % L == 0) {
      const long long fg = v / gs;  // the flat group: row fg / G, group fg % G
      xsum_t[(size_t)(fg % G) * mpad + fg / G] = (float)s;
    }
    return;
  }
  if (w >= (long long)M * G) return;
  const int m = (int)(w / G), g = (int)(w % G);
  const size_t base = (size_t)m * K + (size_t)g * gs;
  Sum s = 0;
  for (int c = lane; c < L; c += 32) {
    const size_t off = base + (size_t)c * V;
    s += chunk_sum(x + off, hi + off, lo + off);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (lane == 0) xsum_t[(size_t)g * mpad + m] = (float)s;
}

// ---------------------------------------------------------------------------------------------
// Pass 3: the GEMM.
// ---------------------------------------------------------------------------------------------

// Dynamic shared memory: STAGES stages, each P x tiles, the code tile and UNITS factor slots (slot
// u: the group ending with the stage's unit u, 64 values each), padded to the swizzle's 1024-byte
// period; then the barriers; 1024 bytes more to align the base.
constexpr int tg_stage_bytes(int P, bool INT8) {
  return ((P * TG_BM + TG_BN) * TG_ROW + (INT8 ? 2 : 1) * TG_FACTORS + 1023) / 1024 * 1024;
}

// As many stages as fit in a block's 227 KB of shared memory (with the barriers and the 1024
// bytes that align the base), at most 8.
constexpr int tg_stages(int P, bool INT8) {
  return (232448 - 1024 - 128) / tg_stage_bytes(P, INT8) < 8 ? (232448 - 1024 - 128) / tg_stage_bytes(P, INT8) : 8;
}

template <int P, bool INT8, int STAGES>
struct TgPlan {
  static constexpr int units = INT8 ? 2 : 1;  // 64-value units a stage
  static constexpr int vals = INT8 ? 128 : 64;  // values a stage
  static constexpr int x_tile = TG_BM * TG_ROW;
  static constexpr int w_off = P * x_tile;
  static constexpr int f_off = w_off + TG_BN * TG_ROW;
  static constexpr int stage = tg_stage_bytes(P, INT8);
  static constexpr int bar_off = STAGES * stage;
  static constexpr int bytes = bar_off + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ void mma128(float (&d)[64], uint64_t da, uint64_t db, int sd) {
  wg_bf16::wgmma<128>(d, da, db, sd);
}
__device__ __forceinline__ void mma128(int (&d)[64], uint64_t da, uint64_t db, int sd) {
  wg_s8::wgmma<128>(d, da, db, sd);
}

// An accumulator as float32: as it is, or an int32 sum rounded to nearest (I2FP, full rate).
__device__ __forceinline__ float acc_float(float a) { return a; }
__device__ __forceinline__ float acc_float(int a) { return __int2float_rn(a); }

template <typename TO, int P, bool INT8, int STAGES>
__global__ void __launch_bounds__(TG_THREADS, 1) tiled_gemm_kernel(
    __grid_constant__ const CUtensorMap xmap_hi, __grid_constant__ const CUtensorMap xmap_lo,
    __grid_constant__ const CUtensorMap wmap, const float* __restrict__ scale_t,
    const float* __restrict__ shift_t, const float* __restrict__ xsum_t, const float* __restrict__ sx,
    TO* __restrict__ out, int M, int N, int K, int gs, int mpad) {
  using Plan = TgPlan<P, INT8, STAGES>;
  using Acc = typename std::conditional<INT8, int, float>::type;
  constexpr int SPU = TG_UNIT * (INT8 ? 1 : 2) / 32;  // wgmma K steps (32 bytes each) a unit
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Plan::bar_off);  // a stage's copies arrived
  uint64_t* empty = full + STAGES;  // every consumer warp is done with it (products, folds)
  const int m_tiles = (M + TG_BM - 1) / TG_BM, n_tiles = N / TG_BN;
  const int tiles = m_tiles * n_tiles;
  const int nst = (K + Plan::vals - 1) / Plan::vals;  // stages a tile
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TG_CONSUMERS / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= TG_CONSUMERS) {
    // The producer: stage q of this block into slot q % STAGES once the consumers released
    // stage q - STAGES.
    reg_dealloc<TG_PRODUCER_REGS>();
    if (threadIdx.x != TG_CONSUMERS) return;
    tma_prefetch_map(&xmap_hi);
    if constexpr (P == 2) tma_prefetch_map(&xmap_lo);
    tma_prefetch_map(&wmap);
    Ring<STAGES> r;
    long long q = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      tile_of(t, m_tiles, n_tiles, tm, tn);
      const int m0 = tm * TG_BM, n0 = tn * TG_BN;
      for (int s = 0; s < nst; ++s, ++q, r.next()) {
        if (q >= STAGES) mbar_wait(&empty[r.slot], r.par ^ 1);
        unsigned char* st = smem + r.slot * Plan::stage;
        uint64_t* bar = &full[r.slot];
        const int kb = s * Plan::vals;
        uint32_t ends = 0;  // bit u: a group ends with unit u
#pragma unroll
        for (int u = 0; u < Plan::units; ++u) {
          const int kend = kb + (u + 1) * TG_UNIT;
          if (kend <= K && kend % gs == 0) ends |= 1u << u;
        }
        mbar_expect_tx(bar, P * Plan::x_tile + TG_BN * TG_ROW + __popc(ends) * TG_FACTORS);
        tma_load_2d(st, &xmap_hi, bar, kb, m0);
        if constexpr (P == 2) tma_load_2d(st + Plan::x_tile, &xmap_lo, bar, kb, m0);
        tma_load_2d(st + Plan::w_off, &wmap, bar, kb, n0);
#pragma unroll
        for (int u = 0; u < Plan::units; ++u) {
          if (!(ends >> u & 1)) continue;
          const size_t g = (size_t)((kb + (u + 1) * TG_UNIT) / gs - 1);
          unsigned char* f = st + Plan::f_off + u * TG_FACTORS;
          bulk_load(f, scale_t + g * N + n0, TG_BN * 4, bar);
          bulk_load(f + TG_BN * 4, shift_t + g * N + n0, TG_BN * 4, bar);
          bulk_load(f + 2 * TG_BN * 4, xsum_t + g * mpad + m0, TG_BM * 4, bar);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg takes x rows 64 wg .. 64 wg + 63 of each tile. Accumulator 4 j + i
  // of a thread is row 16 w + gid + 8 (i >> 1) of the warpgroup's 64 (w its warp in the
  // warpgroup), column 8 j + 2 tig + (i & 1). The loop has no branch around the asynchronous
  // products (ptxas serializes wgmma on a wait in a path it cannot prove uniform): groups, their
  // units, then the group's wait and fold; releases are predicated arrivals.
  reg_alloc<TG_CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rloc = wg * 64 + warp * 16 + gid;  // this thread's first row in the tile
  const int nu = K / TG_UNIT;                  // units a tile
  const int upg = gs / TG_UNIT;                // units a group
  Acc acc[64];
  float y[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    acc[j] = 0;
    y[j] = 0.f;
  }
  Ring<STAGES> r;
  int pend = -1;  // a stage whose last unit's products may still run: released once they are done
  // Warpgroup wg > 0 starts once warpgroup wg - 1 has issued TG_LAG units (named barrier wg), so
  // that their folds, during which a warpgroup's products stop, fall apart in time.
  const int lead_u = min(TG_LAG, ((tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * nu - 1);
  if (wg > 0) bar_sync(wg);
  int u = 0;  // the block's unit
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int tm, tn;
    tile_of(t, m_tiles, n_tiles, tm, tn);
    const int m0 = tm * TG_BM, n0 = tn * TG_BN;
    for (int i = 0; i < nu;) {
      const unsigned char* st = nullptr;
      int su = 0, slot = 0;
      bool stage_last = false;
      for (int j = 0; j < upg; ++j, ++i, ++u) {
        su = i % Plan::units;  // the unit's place in its stage
        stage_last = su == Plan::units - 1 || i + 1 == nu;
        slot = r.slot;
        if (su == 0) mbar_wait(&full[slot], r.par);
        st = smem + slot * Plan::stage;
        const uint64_t db = make_desc<128>(st + Plan::w_off);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < SPU; ++ks) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const uint64_t da = make_desc<128>(st + p * Plan::x_tile + wg * 64 * TG_ROW);
            const int off = 2 * (su * SPU + ks);
            mma128(acc, da + off, db + off, (j == 0 && ks == 0 && p == 0) ? 0 : 1);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the unit before is done: so is the stage it ended
        arrive_if(&empty[pend < 0 ? 0 : pend], pend >= 0 && lane == 0);
        // This unit's stage, when it is the stage's last: released at the next unit, or after the
        // fold when the unit ends the group (the fold reads the group's factors from it).
        pend = stage_last && j + 1 < upg ? slot : -1;
        if (stage_last) r.next();
        if (wg + 1 < TG_WGS && u == lead_u) bar_arrive(wg + 1);
      }
      // The group's products, then its fold: y += acc * s - (sum x) * z with the group's factors.
      wgmma_wait<0>();
      fence_regs(acc);
      const float* fs = reinterpret_cast<const float*>(st + Plan::f_off + su * TG_FACTORS) + 2 * tig;
      const float* fz = fs + TG_BN;
      const float* fx = reinterpret_cast<const float*>(st + Plan::f_off + su * TG_FACTORS) + 2 * TG_BN;
      const float x0 = fx[rloc], x1 = fx[rloc + 8];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(fs + 8 * j);
        const float2 z2 = *reinterpret_cast<const float2*>(fz + 8 * j);
        y[4 * j + 0] += acc_float(acc[4 * j + 0]) * s2.x - x0 * z2.x;
        y[4 * j + 1] += acc_float(acc[4 * j + 1]) * s2.y - x0 * z2.y;
        y[4 * j + 2] += acc_float(acc[4 * j + 2]) * s2.x - x1 * z2.x;
        y[4 * j + 3] += acc_float(acc[4 * j + 3]) * s2.y - x1 * z2.y;
      }
      __syncwarp();
      arrive_if(&empty[slot], stage_last && lane == 0);
    }
    // y is whole: gs divides K, so the tile's last unit ended a group.
    const int row = m0 + rloc;
    float sxv = 1.f;
    if constexpr (INT8) sxv = __ldg(sx);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      TO* o = out + (size_t)row * N + n0 + 8 * j + 2 * tig;
      if (row < M) store2(o, y[4 * j] * sxv, y[4 * j + 1] * sxv);
      if (row + 8 < M) store2(o + (size_t)8 * N, y[4 * j + 2] * sxv, y[4 * j + 3] * sxv);
#pragma unroll
      for (int c = 0; c < 4; ++c) y[4 * j + c] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------------------------
// Host.
// ---------------------------------------------------------------------------------------------
template <int BITS, bool INT8>
cudaError_t launch_codes(const void* packed, unsigned char* codes, int N, int K, cudaStream_t stream) {
  const long long words = (long long)N * K * BITS / 32;
  unpack_codes_kernel<BITS, INT8><<<(unsigned)((words + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint32_t*>(packed), codes, words);
  return cudaGetLastError();
}

template <bool INT8>
cudaError_t launch_codes(int bits, const void* packed, unsigned char* codes, int N, int K, cudaStream_t stream) {
  if (bits == 4) return launch_codes<4, INT8>(packed, codes, N, K, stream);
  return launch_codes<2, INT8>(packed, codes, N, K, stream);
}

template <typename TX>
cudaError_t launch_x_pass(const void* x, unsigned char* ws, const WsLayout& l, int M, int K, int gs,
                          cudaStream_t stream) {
  __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(ws + l.planes);
  constexpr int V = 16 / sizeof(TX);
  const int L = gs / V;
  const long long warps = L <= 32 && (L & (L - 1)) == 0 ? ((long long)M * K / V + 31) / 32 : (long long)M * (K / gs);
  x_pass_kernel<TX><<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(
      static_cast<const TX*>(x), reinterpret_cast<float*>(ws + l.xsum), hi, hi + (size_t)M * K, M, K, gs, l.mpad);
  return cudaGetLastError();
}

// The map of an operand [rows, K] of 128-byte tile rows: boxes of 128 bytes x box_rows rows.
cudaError_t row_map(CUtensorMap* map, const void* base, bool bf16, int rows, int K, int box_rows) {
  const int esize = bf16 ? 2 : 1;
  return encode_map<2>(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, base,
                       {(uint64_t)K, (uint64_t)rows}, {(uint64_t)K * esize},
                       {(uint32_t)(TG_ROW / esize), (uint32_t)box_rows}, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The GEMM over x's plane(s) xp (bf16 or int8 [M, K]) and the workspace's codes and x sums.
template <typename TO, int P, bool INT8, int STAGES>
cudaError_t launch_gemm(int device, const void* xh, const void* xl, const unsigned char* ws, const WsLayout& l,
                        const void* scale_t, const void* shift_t, const void* sx, void* out, int M, int N, int K,
                        int gs, cudaStream_t stream) {
  using Plan = TgPlan<P, INT8, STAGES>;
  CUtensorMap hi, lo, wmap;
  cudaError_t e = row_map(&hi, xh, !INT8, M, K, TG_BM);
  lo = hi;
  if (e == cudaSuccess && P == 2) e = row_map(&lo, xl, true, M, K, TG_BM);
  if (e == cudaSuccess) e = row_map(&wmap, ws + l.codes, !INT8, N, K, TG_BN);
  if (e != cudaSuccess) return e;
  auto kernel = tiled_gemm_kernel<TO, P, INT8, STAGES>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::bytes);
  if (e != cudaSuccess) return e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int tiles = (M + TG_BM - 1) / TG_BM * (N / TG_BN);
  kernel<<<min(tiles, sms), TG_THREADS, Plan::bytes, stream>>>(
      hi, lo, wmap, static_cast<const float*>(scale_t), static_cast<const float*>(shift_t),
      reinterpret_cast<const float*>(ws + l.xsum), static_cast<const float*>(sx), static_cast<TO*>(out), M, N, K,
      gs, l.mpad);
  return cudaGetLastError();
}

bool refused(void* ws, int M, int N, int K, int gs, int bits) {
  return ws == nullptr || M < 1 || N % TG_BN != 0 || gs % TG_UNIT != 0 || gs <= 0 || K % gs != 0 ||
         (bits != 4 && bits != 2);
}

}  // namespace

// The float-x entry point: x [M, K] bfloat16 (x_bf16 = 1) or float32 (0), out in x's dtype; ws
// the workspace of ws_layout (codes as bf16; planes for float32 x); bits 4 or 2. Shapes off the
// envelope (N % 128, gs % 64, gs not dividing K) are refused with cudaErrorInvalidValue.
extern "C" int qbits_mm_tiled(int device, const void* x, const void* packed, const void* scale_t,
                              const void* shift_t, void* out, void* ws, int M, int N, int K, int gs, int bits,
                              int x_bf16, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (refused(ws, M, N, K, gs, bits)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(ws);
  const WsLayout l = ws_layout(M, N, K, gs, 2);
  e = launch_codes<false>(bits, packed, w + l.codes, N, K, s);
  if (e != cudaSuccess) return (int)e;
  if (x_bf16) {
    e = launch_x_pass<__nv_bfloat16>(x, w, l, M, K, gs, s);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_gemm<__nv_bfloat16, 1, false, tg_stages(1, false)>(device, x, x, w, l, scale_t, shift_t,
                                                                           nullptr, out, M, N, K, gs, s);
  }
  e = launch_x_pass<float>(x, w, l, M, K, gs, s);
  if (e != cudaSuccess) return (int)e;
  const __nv_bfloat16* hi = reinterpret_cast<const __nv_bfloat16*>(w + l.planes);
  return (int)launch_gemm<float, 2, false, tg_stages(2, false)>(device, hi, hi + (size_t)M * K, w, l, scale_t,
                                                                 shift_t, nullptr, out, M, N, K, gs, s);
}

// The int8-x entry point (W4A8, W2A8): x int8 [M, K], sx float32 scalar on the device; out
// bfloat16 (out_bf16 = 1) or float32 (0); ws the workspace of ws_layout (codes as int8); bits 4
// or 2. Refusals as above.
extern "C" int qbits_mm_tiled_int8(int device, const void* x, const void* packed, const void* scale_t,
                                   const void* shift_t, const void* sx, void* out, void* ws, int M, int N, int K,
                                   int gs, int bits, int out_bf16, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (refused(ws, M, N, K, gs, bits)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(ws);
  const WsLayout l = ws_layout(M, N, K, gs, 1);
  e = launch_codes<true>(bits, packed, w + l.codes, N, K, s);
  if (e == cudaSuccess) e = launch_x_pass<int8_t>(x, w, l, M, K, gs, s);
  if (e != cudaSuccess) return (int)e;
  return out_bf16 ? (int)launch_gemm<__nv_bfloat16, 1, true, tg_stages(1, true)>(device, x, x, w, l, scale_t,
                                                                               shift_t, sx, out, M, N, K, gs, s)
                  : (int)launch_gemm<float, 1, true, tg_stages(1, true)>(device, x, x, w, l, scale_t, shift_t, sx,
                                                                       out, M, N, K, gs, s);
}
