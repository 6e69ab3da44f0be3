// The device code of flash_decode (TPU #8-#10) that its two arms share: the tensor-core arm of
// flash_decode.cu (bfloat16 q over bfloat16, int8, int4 and float8 caches) and the CUDA-core arm of
// flash_decode_cc.cu (float32 q, or a float32 cache). flash_decode.cu's source note gives the
// function and the design.
//
// What is shared: the work plan every block reads from the positions, the ring of cp.async stages
// a block walks its tiles through, and the end of a segment: the block's per-warp partials merged
// into one, written out when the block saw the whole (b, h, query group), else written as a
// partial that the last block to finish on it merges. A tile holds WARPS * TS slots of one head;
// warp w owns TS of them: it copies their rows and factors into the stage and waits for its own
// copies only, so the warps of a block meet at the end of a segment and nowhere else. An arm
// supplies the arithmetic of one warp:
//   Arm::TS (slots of a warp's part of a tile), GR (query rows of a group), D, STAGES, KROW, VROW,
//   SCALES, LUT_BYTES, SL (the stage layout) and a register State;
//   Arm::load_luts(Args, lut)                the float8 tables into shared memory;
//   Arm::begin(State&, Args, b, h, grp)      a segment's query rows, the softmax state reset;
//   Arm::tile(State&, Args, K, V, sc, n, lut) its TS slots: rows of K and V from K, V, slot r's
//                                            factors at sc[r] (k_scale; v_scale, k_shift, v_shift
//                                            SL::rows floats apart), the first n slots visible;
//   Arm::export_(State&, part)               its (max[GR], sum[GR], out[GR][D]), GR * (D + 2)
//                                            floats, into shared memory.
//
// Everything lies in namespace fd; the kernels are templates that each source instantiates for its
// own arms, so the two sources build in parallel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_gemm.cuh"

namespace fd {

enum PayloadType { F32 = 0, BF16 = 1, I8 = 2, I4 = 3, FP8 = 4 };
// Scale and shift modes: a float cache has neither, a symmetric spec scales, "...a" specs shift.
enum Mode { NONE = 0, SCALED = 1, SHIFTED = 2 };

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 2;   // the launch bounds: at most 255 registers a thread
constexpr int WARP_TILE_BYTES = 4096;  // most K and V bytes of a warp's part of a tile
constexpr int PLAN_ROWS = 32;   // batch rows whose plan the occupancy (so the grid) allows for
constexpr int MAX_DEVICES = 64;

struct Args {
  const void* q;          // [B, Hkv, G, D] bfloat16 or float32
  const uint8_t* k;       // [B, S, Hkv, KROW bytes]
  const uint8_t* v;
  const float* k_scale;   // [B, S, Hkv] or null
  const float* v_scale;
  const float* k_shift;
  const float* v_shift;
  const int* pos;         // [B]
  const float* k_lut;     // the 256 values of a float8 payload's format, or null
  const float* v_lut;
  float* ws;              // [gridDim.x, 2] partials of GR * (D + 2) floats
  int* counters;          // [B, Hkv, ng] arrivals, zero between calls
  void* out;              // [B, Hkv, G, D] in q's dtype
  // The paged arm: int32 page table [B, P], or null for a dense cache. The payload, scales and
  // shifts are then pools [n_pages, ps, Hkv, ...], and S = P * ps.
  const int* table;
  int P, ps;
  int B, Hkv, G, S, ng, mode, q_bf16;
  float scale;            // log2(e) / sqrt(D): logits in base 2
};

// The rows of slots of one batch row b, head h: (b, s, h) of a dense [B, S, Hkv] cache, or, through
// the table, (table[b, s / ps], s % ps, h) of a paged [n_pages, ps, Hkv] pool. A lane asks for its
// slots in rising order, so the page of its last slot is kept: a run of slots in one page costs one
// table load and one division. The page id is widened before the product: a pool passes 2^31
// bytes. Only rows b < B and slots s < S are asked for, so the table is read inside its [B, P].
struct CacheRows {
  const Args& a;
  size_t head0;    // row (b, 0, h) of a dense cache; b * P, the table row's first entry, of a paged one
  int h;
  int lo = 0, hi = 0;  // the kept page holds slots lo .. hi - 1
  size_t page0 = 0;    // its first slot's row index / Hkv

  __device__ __forceinline__ CacheRows(const Args& args, int b, int head)
      : a(args), head0(args.table == nullptr ? (size_t)b * args.S * args.Hkv + head : (size_t)b * args.P), h(head) {}

  __device__ __forceinline__ size_t row(int s) {
    if (a.table == nullptr) return head0 + (size_t)s * a.Hkv;
    if (s < lo || s >= hi) {
      const int p = s / a.ps;
      lo = p * a.ps;
      hi = lo + a.ps;
      page0 = (size_t)__ldg(a.table + head0 + p) * a.ps;
    }
    return (page0 + (s - lo)) * a.Hkv + h;
  }
};

// Bytes of a slot row of D elements.
template <int T, int D>
__host__ __device__ constexpr int row_bytes() {
  return T == I4 ? D / 2 : D * (T == F32 ? 4 : T == BF16 ? 2 : 1);
}

// Slots of a warp's part of a tile, for slots of `slot_bytes` of K and V rows: at most 4 KB a warp
// (a stage of 16 KB), a power of 2 from one 16-slot m tile to 128.
__host__ __device__ constexpr int tile_slots(int slot_bytes) {
  int t = 128;
  while (t > 16 && t * slot_bytes > WARP_TILE_BYTES) t /= 2;
  return t;
}

// Byte b of row r of a staged tile of RB-byte rows. The XOR moves 16-byte chunks (rows of 128
// bytes or more: chunk bits 1-2 by r's bits 0-1) or 8-byte units (64-byte rows: unit bit 2 by r's
// bit 1) so that both arms' fragment reads meet no bank conflict: the tensor-core arm reads K rows
// r, r + 1 at the columns of 4 lanes and V rows r .. r + 3 at the columns of 2 lanes in one phase.
// It depends on r mod 4 only, so a warp's part (TS rows, a multiple of 16) is laid out alike.
template <int RB>
__device__ __forceinline__ int swz(int r, int b) {
  if constexpr (RB >= 128)
    return r * RB + (b ^ ((((r & 1) << 2) | (r & 2)) << 4));
  else if constexpr (RB == 64)
    return r * RB + (b ^ (((r >> 1) & 1) << 5));
  else
    return r * RB + b;
}

// A stage of the ring: the tile's WARPS * TS rows of K, of V, then (a quantized cache) k_scale,
// v_scale, k_shift, v_shift [WARPS * TS].
template <int TS, int KROW, int VROW, bool SCALES>
struct StageLayout {
  static constexpr int rows = WARPS * TS;
  static constexpr int k = 0, v = rows * KROW, sc = rows * (KROW + VROW);
  static constexpr int bytes = sc + (SCALES ? 4 * rows * 4 : 0);
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hg::smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

// ---------------------------------------------------------------------------------------------
// The plan. An item is one tile (TL = WARPS * TS slots) of one (b, h, query group) "pair"; the items
// run over b, then h, then the query group, then the tiles of row b's visible slots, so a pair's
// tiles are consecutive. Block i takes the items lo(i) .. lo(i + 1) - 1: T / grid each, one more
// for the first T % grid.
// ---------------------------------------------------------------------------------------------

__device__ __forceinline__ int visible(const Args& a, int b) {
  return min(max(__ldg(a.pos + b) + 1, 0), a.S);
}
// Tiles of a row: at least one, so that every pair gets written (0 / 0 where nothing is visible,
// as the plain version's softmax over no slot).
__device__ __forceinline__ int tiles_of(int nvis, int tl) { return max(1, (nvis + tl - 1) / tl); }

// s_pre[b] = the items of the rows before b, b = 0 .. B; warp 0 scans 32 rows at a time.
__device__ __forceinline__ void plan_rows(const Args& a, int tl, int* s_pre) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per_tile = a.Hkv * a.ng;
  int carry = 0;
  if (lane == 0) s_pre[0] = 0;
  for (int b0 = 0; b0 < a.B; b0 += 32) {
    const int b = b0 + lane;
    int v = b < a.B ? per_tile * tiles_of(visible(a, b), tl) : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (b < a.B) s_pre[b + 1] = carry + v;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

struct Item {
  int b, h, grp;  // the pair
  int c, nt;      // the tile and the pair's tiles
  int nvis;       // row b's visible slots
  int first;      // the pair's first item
};

__device__ __forceinline__ Item item_at(const Args& a, const int* s_pre, int tl, int x) {
  int lo = 0, hi = a.B;  // s_pre[lo] <= x < s_pre[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (s_pre[mid] <= x) lo = mid; else hi = mid;
  }
  Item it;
  it.b = lo;
  it.nvis = visible(a, lo);
  it.nt = tiles_of(it.nvis, tl);
  const int r = x - s_pre[lo];
  const int pair = r / it.nt;
  it.c = r - pair * it.nt;
  it.h = pair / a.ng;
  it.grp = pair - it.h * a.ng;
  it.first = x - it.c;
  return it;
}

struct Split {
  int q, r;  // items per block, and the blocks with one more
  __device__ __forceinline__ int lo(int i) const { return i * q + min(i, r); }
  // The block whose items hold x (x < T).
  __device__ __forceinline__ int block_of(int x) const {
    const int big = r * (q + 1);
    return x < big ? x / (q + 1) : r + (x - big) / q;
  }
};

// ---------------------------------------------------------------------------------------------
// The ring: each warp copies its part of a tile, 16 bytes a copy (factors 4), and waits for its
// own copies only. Slots past the visible ones are zero-filled.
// ---------------------------------------------------------------------------------------------

// Rows r0 .. r0 + TS - 1 of the tile (slots s0 + r of the cache rows `rows`, of RB bytes; n of the
// tile's slots visible). Rows shorter than 128 bytes draw the 256-byte span around them into L2:
// the neighbouring heads' rows, which other blocks read at about the same time.
template <int TS, int RB>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const uint8_t* src, CacheRows& rows, int s0, int r0,
                                          int n) {
  constexpr int C = RB / 16;
  for (int i = threadIdx.x & 31; i < TS * C; i += 32) {
    const int r = r0 + i / C, q = i % C;
    const bool ok = r < n;
    unsigned char* to = dst + swz<RB>(r, q * 16);
    const uint8_t* from = ok ? src + rows.row(s0 + r) * RB + q * 16 : src;
    if constexpr (RB < 128)
      asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(hg::smem_addr(to)), "l"(from),
                   "r"(ok ? 16 : 0));
    else
      hg::cp_async16(to, from, ok ? 16 : 0);
  }
}

// This warp's part of item `it`'s tile into stage st, one commit group.
template <class Arm>
__device__ __forceinline__ void issue_part(const Args& a, unsigned char* st, const Item& it, int tl) {
  using SL = typename Arm::SL;
  const int s0 = it.c * tl, r0 = (threadIdx.x >> 5) * Arm::TS;
  const int n = it.nvis - s0;  // visible slots of the tile
  CacheRows rows(a, it.b, it.h);
  copy_rows<Arm::TS, Arm::KROW>(st + SL::k, a.k, rows, s0, r0, n);
  copy_rows<Arm::TS, Arm::VROW>(st + SL::v, a.v, rows, s0, r0, n);
  if constexpr (Arm::SCALES) {
    float* sc = reinterpret_cast<float*>(st + SL::sc);
    for (int i = threadIdx.x & 31; i < (a.mode == SHIFTED ? 4 : 2) * Arm::TS; i += 32) {
      const int t = i / Arm::TS, r = r0 + i % Arm::TS;
      const float* src = t == 0 ? a.k_scale : t == 1 ? a.v_scale : t == 2 ? a.k_shift : a.v_shift;
      const bool ok = r < n;
      cp_async4(sc + t * SL::rows + r, ok ? src + rows.row(s0 + r) : src, ok ? 4 : 0);
    }
  }
  hg::cp_async_commit();
}

// ---------------------------------------------------------------------------------------------
// The end of a segment.
// ---------------------------------------------------------------------------------------------

// EPT (4 or 8) output values: row `row` of out [B * Hkv * G, D], columns d .. d + EPT - 1, in q's
// dtype.
template <int D, int EPT>
__device__ __forceinline__ void store_out(const Args& a, size_t row, int d, const float (&v)[EPT], float l) {
  const float inv = 1.0f / l;
  if (a.q_bf16) {
    uint32_t p[EPT / 2];
#pragma unroll
    for (int i = 0; i < EPT / 2; ++i) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * i] * inv, v[2 * i + 1] * inv);
      p[i] = *reinterpret_cast<const uint32_t*>(&t);
    }
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + row * D + d;
    if constexpr (EPT == 8)
      *reinterpret_cast<uint4*>(o) = make_uint4(p[0], p[1], p[2], p[3]);
    else
      *reinterpret_cast<uint2*>(o) = make_uint2(p[0], p[1]);
  } else {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(a.out) + row * D + d);
#pragma unroll
    for (int i = 0; i < EPT / 4; ++i)
      o[i] = make_float4(v[4 * i] * inv, v[4 * i + 1] * inv, v[4 * i + 2] * inv, v[4 * i + 3] * inv);
  }
}

// Merge n partials (max, sum, out) of one row g into (mx, l, v[EPT] at columns d .. d + EPT - 1),
// in order, online: partial j at p(j), its max at [g], sum at [GR + g], out at [2 GR + g * D + d].
// The loads of MB partials are issued together, so a merge of up to MB parts waits on one round
// trip. CG: read past L1 (partials of other blocks).
template <int GR, int D, int EPT, int MB, bool CG, class P>
__device__ __forceinline__ void merge_rows(int n, P p, int g, int d, float& mx, float& l, float (&v)[EPT]) {
  mx = -CUDART_INF_F;
  l = 0.0f;
#pragma unroll
  for (int i = 0; i < EPT; ++i) v[i] = 0.0f;
  for (int j0 = 0; j0 < n; j0 += MB) {
    float mj[MB], lj[MB];
    float4 x[MB][EPT / 4];
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      mj[k] = -CUDART_INF_F;
      if (j0 + k >= n) continue;
      const float* q = p(j0 + k);
      mj[k] = CG ? __ldcg(q + g) : q[g];
      lj[k] = CG ? __ldcg(q + GR + g) : q[GR + g];
      const float4* y = reinterpret_cast<const float4*>(q + 2 * GR + g * D + d);
#pragma unroll
      for (int i = 0; i < EPT / 4; ++i) x[k][i] = CG ? __ldcg(y + i) : y[i];
    }
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      if (mj[k] == -CUDART_INF_F) continue;  // past n, or a part that saw no visible slot
      const float mn = fmaxf(mx, mj[k]);
      const float a = fast_exp2(mx - mn), w = fast_exp2(mj[k] - mn);
      mx = mn;
      l = fmaf(l, a, lj[k] * w);
#pragma unroll
      for (int i = 0; i < EPT / 4; ++i) {
        v[4 * i] = fmaf(v[4 * i], a, x[k][i].x * w);
        v[4 * i + 1] = fmaf(v[4 * i + 1], a, x[k][i].y * w);
        v[4 * i + 2] = fmaf(v[4 * i + 2], a, x[k][i].z * w);
        v[4 * i + 3] = fmaf(v[4 * i + 3], a, x[k][i].w * w);
      }
    }
  }
}

// The segment that began at item `seg` of this block ends with item `it`. `part`: shared memory
// of the warps' partials, [WARPS] of GR * (D + 2) floats in the global partials' layout.
template <class Arm>
__device__ __forceinline__ void finish_segment(const Args& a, const Split& sp, const Item& it, int seg,
                                               typename Arm::State& st, float* part, int* s_flag) {
  constexpr int GR = Arm::GR, D = Arm::D, PS = GR * (D + 2), EPT = 4;  // EPT: values a thread merges
  Arm::export_(st, part + (threadIdx.x >> 5) * PS);
  __syncthreads();
  const int i0 = sp.block_of(it.first), i1 = sp.block_of(it.first + it.nt - 1);
  const int g0 = it.grp * GR;
  const int rows = min(GR, a.G - g0);  // the group's query rows (past G: padding)
  const size_t row0 = ((size_t)it.b * a.Hkv + it.h) * a.G + g0;
  float* mine = a.ws + ((size_t)blockIdx.x * 2 + (seg == sp.lo(blockIdx.x) ? 0 : 1)) * PS;
  for (int e = threadIdx.x * EPT; e < rows * D; e += THREADS * EPT) {
    const int g = e / D, d = e - g * D;
    float mx, l, v[EPT];
    merge_rows<GR, D, EPT, WARPS, false>(WARPS, [&](int k) { return part + k * PS; }, g, d, mx, l, v);
    if (i0 == i1) {  // the block saw the whole pair
      store_out<D, EPT>(a, row0 + g, d, v, l);
    } else {
      if (d == 0) {
        mine[g] = mx;
        mine[GR + g] = l;
      }
      *reinterpret_cast<float4*>(mine + 2 * GR + g * D + d) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if (i0 == i1) return;
  // Arrive; the last of the pair's i1 - i0 + 1 blocks merges their partials in block order.
  __syncthreads();
  int* counter = a.counters + ((size_t)it.b * a.Hkv + it.h) * a.ng + it.grp;
  if (threadIdx.x == 0) {
    __threadfence();  // the block's partials (ordered before this by the barrier) before the arrival
    *s_flag = atomicAdd(counter, 1) == i1 - i0;
  }
  __syncthreads();
  if (!*s_flag) return;
  __threadfence();
  const int first = it.first;
  const auto partial = [&](int k) {
    const int i = i0 + k;
    return a.ws + ((size_t)i * 2 + (sp.lo(i) >= first ? 0 : 1)) * PS;
  };
  for (int e = threadIdx.x * EPT; e < rows * D; e += THREADS * EPT) {
    const int g = e / D, d = e - g * D;
    float mx, l, v[EPT];
    merge_rows<GR, D, EPT, 16, true>(i1 - i0 + 1, partial, g, d, mx, l, v);
    store_out<D, EPT>(a, row0 + g, d, v, l);
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next call
}

// Dynamic shared memory: the ring, the warps' partials, the float8 tables, a flag, the plan.
template <class Arm>
struct Layout {
  using SL = typename Arm::SL;
  static constexpr int part = Arm::STAGES * SL::bytes;
  static constexpr int lut = part + 4 * WARPS * Arm::GR * (Arm::D + 2);
  static constexpr int flag = lut + Arm::LUT_BYTES;
  static constexpr int plan = flag + 16;
  static constexpr size_t bytes(int B) { return (size_t)plan + 4 * (size_t)(B + 1); }
};

template <class Arm>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) flash_decode_kernel(const Args a) {
  using L = Layout<Arm>;
  using SL = typename L::SL;
  constexpr int TL = WARPS * Arm::TS;  // slots of a tile
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_pre = reinterpret_cast<int*>(smem + L::plan);
  plan_rows(a, TL, s_pre);
  Arm::load_luts(a, smem + L::lut);
  __syncthreads();
  const int T = s_pre[a.B];
  const Split sp{T / (int)gridDim.x, T % (int)gridDim.x};
  const int lo = sp.lo(blockIdx.x);
  const int n = sp.lo(blockIdx.x + 1) - lo;
  if (n <= 0) return;
  const auto stage = [&](int i) { return smem + (i % Arm::STAGES) * SL::bytes; };
  const int r0 = (threadIdx.x >> 5) * Arm::TS;  // this warp's first row of a tile
#pragma unroll 1
  for (int i = 0; i < Arm::STAGES - 1; ++i) {
    if (i < n) issue_part<Arm>(a, stage(i), item_at(a, s_pre, TL, lo + i), TL);
    else hg::cp_async_commit();
  }
  typename Arm::State st;
  Item it = item_at(a, s_pre, TL, lo);
  Arm::begin(st, a, it.b, it.h, it.grp);  // q's loads ride with the first tiles'
  int seg = lo;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    hg::cp_async_wait<Arm::STAGES - 2>();
    __syncwarp();  // this warp's part of tile i is in; its lanes are done with tile i - 1
    const int j = i + Arm::STAGES - 1;
    if (j < n) issue_part<Arm>(a, stage(j), item_at(a, s_pre, TL, lo + j), TL);
    else hg::cp_async_commit();
    if (i > 0) {
      it = item_at(a, s_pre, TL, lo + i);
      if (it.c == 0) {
        Arm::begin(st, a, it.b, it.h, it.grp);
        seg = lo + i;
      }
    }
    const unsigned char* sg = stage(i);
    Arm::tile(st, a, sg + SL::k + (size_t)r0 * Arm::KROW, sg + SL::v + (size_t)r0 * Arm::VROW,
              reinterpret_cast<const float*>(sg + SL::sc) + r0, min(TL, it.nvis - it.c * TL) - r0, smem + L::lut);
    if (i == n - 1 || it.c == it.nt - 1)
      finish_segment<Arm>(a, sp, it, seg, st, reinterpret_cast<float*>(smem + L::part),
                          reinterpret_cast<int*>(smem + L::flag));
  }
  hg::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------------------------
// Host side: the grid (one wave: the SMs times the blocks of an arm that fit on one), cached per
// device, and the launch.
// ---------------------------------------------------------------------------------------------

inline cudaError_t sm_count(int device, int* sms) {
  static int cache[MAX_DEVICES] = {0};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(&cache[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  *sms = cache[device];
  return cudaSuccess;
}

// Blocks of the grid, and the float32 elements of the partials' workspace, for this arm on `device`
// (the current device).
template <class Arm>
cudaError_t arm_grid(int device, int* grid, long long* ws_floats) {
  static int cache[MAX_DEVICES] = {0};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    int optin = 0, occ = 0, sms = 0;
    cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_decode_kernel<Arm>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, flash_decode_kernel<Arm>, THREADS,
                                                        Layout<Arm>::bytes(PLAN_ROWS));
    if (e == cudaSuccess) e = sm_count(device, &sms);
    if (e != cudaSuccess) return e;
    cache[device] = (occ > 0 ? occ : 1) * sms;
  }
  *grid = cache[device];
  *ws_floats = (long long)cache[device] * 2 * Arm::GR * (Arm::D + 2);
  return cudaSuccess;
}

template <class Arm>
int arm_launch(int device, Args a, cudaStream_t stream) {
  int grid = 0;
  long long ws = 0;
  cudaError_t e = arm_grid<Arm>(device, &grid, &ws);
  if (e != cudaSuccess) return (int)e;
  a.ng = (a.G + Arm::GR - 1) / Arm::GR;
  flash_decode_kernel<Arm><<<grid, THREADS, Layout<Arm>::bytes(a.B), stream>>>(a);
  return (int)cudaGetLastError();
}

template <class Arm>
int arm_workspace(int device, int G, long long* ws_floats, int* groups) {
  int grid = 0;
  const cudaError_t e = arm_grid<Arm>(device, &grid, ws_floats);
  *groups = (G + Arm::GR - 1) / Arm::GR;
  return (int)e;
}

// An arm's kernel for the payload pair and head dim, or cudaErrorInvalidValue: f(Arm{}) with Arm
// = A<KT, VT, D> over the pairs the arm takes (`floats`: the float payloads it takes, each with
// itself; any two code types pair).
template <template <int, int, int> class A, int FT0, int FT1, class F>
int visit(int kt, int vt, int D, F&& f) {
  const auto by_d = [&](auto k_tag, auto v_tag) -> int {
    constexpr int KT = decltype(k_tag)::value, VT = decltype(v_tag)::value;
    if (D == 64) return f(A<KT, VT, 64>{});
    if (D == 128) return f(A<KT, VT, 128>{});
    return (int)cudaErrorInvalidValue;
  };
  using I8t = std::integral_constant<int, I8>;
  using I4t = std::integral_constant<int, I4>;
  using FP8t = std::integral_constant<int, FP8>;
  const auto by_v = [&](auto k_tag) -> int {
    switch (vt) {
      case I8: return by_d(k_tag, I8t{});
      case I4: return by_d(k_tag, I4t{});
      case FP8: return by_d(k_tag, FP8t{});
    }
    return (int)cudaErrorInvalidValue;
  };
  if (kt == vt && kt == FT0) return by_d(std::integral_constant<int, FT0>{}, std::integral_constant<int, FT0>{});
  if (kt == vt && kt == FT1) return by_d(std::integral_constant<int, FT1>{}, std::integral_constant<int, FT1>{});
  switch (kt) {
    case I8: return by_v(I8t{});
    case I4: return by_v(I4t{});
    case FP8: return by_v(FP8t{});
  }
  return (int)cudaErrorInvalidValue;
}

// The tensor-core arm (flash_decode.cu) and the CUDA-core arm (flash_decode_cc.cu).
int tc_launch(int device, const Args& a, int kt, int vt, int D, cudaStream_t stream);
int tc_workspace(int device, int G, int kt, int vt, int D, long long* ws_floats, int* groups);
int cc_launch(int device, const Args& a, int kt, int vt, int D, cudaStream_t stream);
int cc_workspace(int device, int G, int kt, int vt, int D, long long* ws_floats, int* groups);

}  // namespace fd
