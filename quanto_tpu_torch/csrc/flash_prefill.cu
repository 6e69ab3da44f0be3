// Causal flash-attention forward for Hopper (sm_90a): a prompt's attention to its own keys from
// position 0, over the raw (pre-quantization) K/V, in one launch.
//
// Replaces the TPU kernel that quanto_tpu/ops/attention.py:206 try_flash_prefill reaches: JAX's
// splash-attention MQA kernel (make_splash_mqa_single_device with a causal mask, vmapped per batch
// row and kv head, :237-265). For batch row b, query head hq = h G + g (kv head h) and position t:
//   s[u]   = qs[b, t, hq] . k[b, u, h]            for u <= t, qs = rnd(q * scale) in q's dtype
//   s[u]   = c * tanh(s[u] / c)                    with a softcap c
//   out    = sum_u exp(s[u] - max) v[b, u, h] / sum_u exp(s[u] - max)
// The scale is folded into q as JAX folds it (:257): in float32, then rounded to q's dtype, so a
// bf16 q at D = 128 (1/sqrt(128)) carries that rounding and one at D = 256 (1/16) none. Logits,
// softmax and sums are float32; the output is cast to q's dtype. q [B, T, H, D], k/v [B, T, Hkv,
// D], out [B, T, H, D] (the caller's [B, T, H * D]); bf16 or float32, D 128 or 256, T a multiple
// of 128. Rows are "packed": row p of a (b, h) is position p / G and query head g = p % G, so the
// G query heads of a kv head share every K/V tile (G = 4 for Llama-3.1-8B, 1 for Gemma-7B, 8 for
// Gemma-2B).
//
// What bounds it on this card, at B = 4 x 1024: operations at Llama-3.1-8B's heads (8 x 4 of 128:
// 2 B H T^2 D = 34.4 GFLOP over the causal half, 34.7 us at 989 TFLOP/s, against 84 MB moved) and
// Gemma-2B's (1 x 8 of 256: 17.4 us), bytes at Gemma-7B's (16 x 1 of 256: with G = 1 every query
// head brings its own K/V, 134 MB, 40.1 us at 3.35 TB/s). Measured on the card (NVIDIA H100 80GB
// HBM3; PERF.md section 6), two more limits sit above those: the rate at which K/V tiles stream
// from L2 into the SMs (the same with TMA multicast to a cluster of two and with every head
// reading one head's K/V), so a tile should serve as many query rows as registers allow; and the
// softmax between the products.
//
// The bfloat16 arm, FlashAttention-3's shape:
// - A persistent block (one per SM) of one producer warpgroup and WGS consumer warpgroups of 64
//   packed rows each: three at D = 128 (192 rows an item; setmaxnreg 24 / 160), two at D = 256
//   (128 rows; 24 / 240: O alone takes 128 registers a thread there). Its producer thread claims
//   work items, (b, h) and BM rows, from a counter (the first by the block's index; the launch's
//   last claim resets the counter to 0), hands each to the consumers through a two-slot ring in
//   shared memory, and copies the item's K and V tiles of 64 keys by TMA (a 2-D map of [B T,
//   Hkv D], a kv head's rows Hkv D apart; a row of 256 or 512 bytes stored as D / 64 blocks of 64
//   columns in 128-byte swizzle, one box each) into a ring of STAGES stages with full and empty
//   mbarriers for K and for V apart (hopper_gemm.cuh). The ring runs on across items, so the next
//   item's tiles arrive while this one ends.
// - Items are counted back from the last row, so where BM does not divide T G the rows before 0
//   of the first item (the shortest walk) are the ones left over (they repeat row 0 and are not
//   stored). They are handed out longest walk first, within groups of kv heads whose K/V fit in L2
//   together (Gemma-7B's 64 K/V streams of 1 MB would not).
// - q is scaled in float32 and rounded to bf16 by the consumers on its way to shared memory, once
//   an item: the rounding follows the scale, so no copy engine can carry it.
// - S = Q K^T is an SS wgmma (m64n64, 16 deep, D / 16 steps) into registers; the online softmax
//   runs on the accumulator fragment (rows 16 w + gid and + 8 of warp w) in base 2; the causal
//   mask only in tiles that cross a row's position, and a warpgroup computes only up to the tile of
//   its own last position (it releases the item's later tiles unread); the softcap (c - 2 c / (1 +
//   2^(2 x log2 e / c)), one ex2 and a fast reciprocal) is a template flag.
// - O += P V is an RS wgmma: P goes in as two bf16 parts hi + lo (lo = bf16(P - hi), about 16
//   bits), converted in registers into the A-fragment layout that the S accumulator already has,
//   so the output stays within a bf16 step of the plain version's float32 P V (JAX's splash kernel
//   keeps P in float32). V [keys, D] (D contiguous) is an MN-major B operand, read with the
//   transpose-B immediate through hopper_gemm.cuh:make_desc_mn. P as one bf16 part (the choice of
//   FlashAttention-3 and of SDPA) takes a third fewer products and held the kernel's own limits,
//   but its outputs moved a model check of chip_smoke.py (phase 9, Mixtral) across a logit
//   near-tie, so P keeps both parts.
// - In a warpgroup, tile j's S = Q K^T is issued with tile j - 1's O += P V behind it, so tile j's
//   softmax runs while tile j - 1's products do (wgmma.wait_group 1); K is released once its
//   products are done, V once P V's are.
// Tried on the card and left behind (PERF.md section 6): key tiles of 128 at D = 128 (no faster,
// and they spill at 160 registers), two consumer warpgroups at D = 128 (each K/V byte serves fewer
// rows), TMA multicast of K/V to a cluster of two blocks (no faster: the stream into each SM stays
// the same), L2 eviction hints, cp.async copies from the producer warpgroup, a block per item, items
// dealt to the blocks in a fixed order (the walks differ eightfold), the next item's q prefetched
// into L2 or copied into a second Q tile by cp.async, the loop without that overlap.
//
// The float32 arm (W8A8 models are float32 after their first linear) is flash-attention 2 on
// mma.sync (bf16 -> f32, m16n8k16), q scaled in float32 and not rounded:
// - A block is 4 warps over 64 packed rows of one (b, h). A warp owns 16 rows and runs its own
//   online softmax over them; the logits, P and the output stay in registers (16 x D float32 a
//   warp: 128 registers a thread at D = 256, so the key tile is 32 wide there and 64 at D = 128).
// - Each float32 operand is split into bf16 parts hi + lo (lo = bf16(x - hi)) on its way to shared
//   memory, and each product is hi.hi + hi.lo + lo.hi, about 16 bits of each operand: a relative
//   error of order 2^-16 where a float32 product has 2^-24. P goes to the PV product as hi + lo.
// - K/V tiles go through shared memory, double buffered, rows of 16-byte chunks stored at chunk
//   c ^ (row & 7) so that ldmatrix (Q and K non-transposed, V transposed into the PV product's B
//   fragments) meets no bank conflict.
// - Causality: a block walks the key tiles up to its last row's position only and masks inside the
//   tiles that cross the diagonal; blocks are issued last rows first (the longest walks lead).
//
// The entry point has a plain C interface (bound with ctypes in ops/cuda/flash_prefill.py): it
// launches on the stream it is given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "softcap.cuh"
#include "wgmma.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int T, H, Hkv, G;
  float scale, softcap;  // softcap 0: none
  int BH, MT, GB;        // B Hkv; BM-row items of a (b, h); kv heads of an item group
  int* next;             // the items handed out (0 between launches: the last claim resets it)
};

constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A pair of floats as bf16 parts: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// Keeps P's registers, which the RS products read asynchronously, until the products are waited for.
template <int N>
__device__ __forceinline__ void keep(uint32_t (&p)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(p[i][j])::"memory");
}

// Named barrier `id` over one warpgroup's 128 threads.
__device__ __forceinline__ void wg_bar(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------------------------
// The bfloat16 arm: TMA copies, warp-specialised wgmma.
// ---------------------------------------------------------------------------------------------

constexpr int GROUP_BYTES = 16 << 20;  // K/V bytes of an item group's kv heads

template <int D>
struct Plan {
  // Consumer warpgroups, 64 packed rows each: three at D = 128, two at D = 256 (O alone takes 128
  // registers a thread there), so that a K/V tile serves as many rows as the registers allow.
  static constexpr int WGS = D == 128 ? 3 : 2;
  static constexpr int BM = 64 * WGS;  // packed query rows of an item
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 128;  // + the producer's warpgroup (one thread works)
  // Registers a thread: ptxas gives the block 65536 / THREADS (128 or 168); the producer's
  // warpgroup hands most of its own to the consumers (setmaxnreg).
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = WGS == 3 ? 160 : 240;
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS <= 65536,
                "setmaxnreg asks more registers than the block holds");
  static constexpr int BN = 64;                    // keys of a tile
  static constexpr int STAGES = D == 128 ? 4 : 2;  // as many as fit
  static constexpr int BLOCKS = D / 64;            // 128-byte column blocks of a row
  static constexpr int Q_BLOCK = BM * 128;         // bytes of a column block of the Q tile
  static constexpr int KV_BLOCK = BN * 128;
  static constexpr int Q_BYTES = BLOCKS * Q_BLOCK;
  static constexpr int KV_BYTES = BLOCKS * KV_BLOCK;  // one K or V tile
  __host__ __device__ static constexpr int k_at(int s) { return Q_BYTES + 2 * s * KV_BYTES; }
  __host__ __device__ static constexpr int v_at(int s) { return Q_BYTES + (2 * s + 1) * KV_BYTES; }
  static constexpr int BAR = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int ITEMS = BAR + 4 * STAGES * 8 + 2 * 2 * 8;  // the item ring: 2 slots
  static constexpr int BYTES = ITEMS + 2 * 4 + 1024;  // + 1024 to align the base
  static_assert(BYTES <= 232448, "shared memory past a block's 227 KB");
};

// Warpgroup wg's 64 rows of q, scaled in float32 and rounded to bf16, into the Q tile at qs: chunk
// c (16 bytes) of packed row r in column block c / 8, at chunk (c % 8) ^ (r % 8) of its 128 bytes.
// Rows before the first (an item's m0 < 0) repeat row 0.
template <int D>
__device__ __forceinline__ void load_q(unsigned char* qs, const Args& a, int b, int h, int m0, int wg, int tid) {
  constexpr int CH = D / 8;  // chunks of a row
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  uint4 w[64 * CH / 128];
#pragma unroll
  for (int n = 0; n < 64 * CH / 128; ++n) {
    const int i = tid + 128 * n, row = 64 * wg + i / CH, c = i % CH;
    const int p = max(m0 + row, 0), t = p / a.G, g = p - t * a.G;
    w[n] = __ldg(reinterpret_cast<const uint4*>(q + (((size_t)a.T * b + t) * a.H + h * a.G + g) * D + c * 8));
  }
#pragma unroll
  for (int n = 0; n < 64 * CH / 128; ++n) {
    const int i = tid + 128 * n, row = 64 * wg + i / CH, c = i % CH;
    uint32_t* u = reinterpret_cast<uint32_t*>(&w[n]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
      u[e] = pack_bf16(f.x * a.scale, f.y * a.scale);
    }
    *reinterpret_cast<uint4*>(qs + (c >> 3) * Plan<D>::Q_BLOCK + row * 128 + (((c & 7) ^ (row & 7)) << 4)) = w[n];
  }
}

// Work item i of the B Hkv MT items of BM packed rows: its (b, h) and first row m0. Items are
// counted back from the last row, so that where BM does not divide T G the rows before 0 of the
// first item (the shortest walk) are the ones left over. Items come in groups of GB kv heads; in a
// group the longest walks (the last rows) first, the kv heads fastest.
template <int BM>
__device__ __forceinline__ void item_of(const Args& a, int i, int& b, int& h, int& m0) {
  const int per_group = a.GB * a.MT;
  const int grp = i / per_group, first = grp * a.GB;
  const int size = min(a.GB, a.BH - first), r = i - grp * per_group;
  const int bh = first + r % size;
  b = bh / a.Hkv;
  h = bh - b * a.Hkv;
  m0 = a.T * a.G - (r / size + 1) * BM;
}

template <int D, bool CAP>
__global__ void __launch_bounds__(Plan<D>::THREADS, 1)
    bf16_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap, const Args a) {
  using P = Plan<D>;
  constexpr int BN = P::BN, STAGES = P::STAGES, BM = P::BM, CONSUMERS = P::CONSUMERS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hg::smem_addr(smem_raw) & 1023)) & 1023);
  // Per stage: its K arrived, its V arrived; every consumer warp is done with its K, with its V.
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;
  // The item ring: the producer claims the block's items and hands each to the consumers in a slot
  // (item_full), which they give back once read (item_empty).
  uint64_t* item_full = empty_v + STAGES;
  uint64_t* item_empty = item_full + 2;
  int* item_slot = reinterpret_cast<int*>(smem + P::ITEMS);
  const int G = a.G, items = a.BH * a.MT;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hg::mbar_init(&full_k[i], 1);
      hg::mbar_init(&full_v[i], 1);
      hg::mbar_init(&empty_k[i], CONSUMERS / 32);  // one arrival a consumer warp
      hg::mbar_init(&empty_v[i], CONSUMERS / 32);
    }
    for (int i = 0; i < 2; ++i) {
      hg::mbar_init(&item_full[i], 1);
      hg::mbar_init(&item_empty[i], CONSUMERS / 32);
    }
    hg::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // The producer: claims the block's items (its first by its index, then the next unclaimed one,
    // so that blocks that finish early take more: the walks differ by item) and copies their K and V
    // tiles in turn, up to the tile of each item's last position: tile u of the block into slot
    // u % STAGES once every consumer warp released that of tile u - STAGES (K early: after the
    // tile's S; V after its P V). The ring runs on across items, so the next item's tiles arrive
    // while this one ends.
    reg_dealloc<P::PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      hg::tma_prefetch_map(&kmap);
      hg::tma_prefetch_map(&vmap);
      hg::Ring<STAGES> ring;
      hg::Ring<2> iring;
      int u = 0;
#pragma unroll 1
      for (int k = 0;; ++k, iring.next()) {
        int it = blockIdx.x;
        if (k > 0) {
          const int c = atomicAdd(a.next, 1);
          if (c == items - 1) *a.next = 0;  // the launch's last claim: ready for the next launch
          it = gridDim.x + c;
        }
        if (k >= 2) hg::mbar_wait(&item_empty[iring.slot], iring.par ^ 1);
        item_slot[iring.slot] = it;
        hg::mbar_arrive(&item_full[iring.slot]);
        if (it >= items) break;
        int b, h, m0;
        item_of<BM>(a, it, b, h, m0);
        const int n = (m0 + BM - 1) / G / BN + 1;
#pragma unroll 1
        for (int j = 0; j < n; ++j, ++u, ring.next()) {
          const int row = b * a.T + j * BN;
          if (u >= STAGES) hg::mbar_wait(&empty_k[ring.slot], ring.par ^ 1);
          hg::mbar_expect_tx(&full_k[ring.slot], P::KV_BYTES);
#pragma unroll
          for (int cb = 0; cb < P::BLOCKS; ++cb)
            hg::tma_load_2d(smem + P::k_at(ring.slot) + cb * P::KV_BLOCK, &kmap, &full_k[ring.slot],
                            h * D + 64 * cb, row);
          if (u >= STAGES) hg::mbar_wait(&empty_v[ring.slot], ring.par ^ 1);
          hg::mbar_expect_tx(&full_v[ring.slot], P::KV_BYTES);
#pragma unroll
          for (int cb = 0; cb < P::BLOCKS; ++cb)
            hg::tma_load_2d(smem + P::v_at(ring.slot) + cb * P::KV_BLOCK, &vmap, &full_v[ring.slot],
                            h * D + 64 * cb, row);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns packed rows 64 wg .. 64 wg + 63 of each item. Accumulator
  // 4 j + i of a thread (S and O alike) is row 16 w + gid + 8 (i >> 1) of the warpgroup's 64 (w its
  // warp), column 8 j + 2 tig + (i & 1).
  reg_alloc<P::CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const uint64_t dq = hg::make_desc<128>(smem + wg * 64 * 128);
  const float cap_k = CAP ? 2.0f * LOG2E / a.softcap : 0.0f;
  float o[D / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.0f;
  uint32_t ph[BN / 16][4], pl[BN / 16][4];  // P's A fragments as bf16 hi and lo parts, 16 keys a step
  hg::Ring<STAGES> ring;
  hg::Ring<2> iring;

#pragma unroll 1
  for (;; iring.next()) {
    hg::mbar_wait(&item_full[iring.slot], iring.par);
    const int it = item_slot[iring.slot];
    __syncwarp();
    if (lane == 0) hg::mbar_arrive(&item_empty[iring.slot]);
    if (it >= items) break;
    int b, h, m0;
    item_of<BM>(a, it, b, h, m0);
    wg_bar(1 + wg);  // the warpgroup's products of the last item no longer read its Q rows
    load_q<D>(smem, a, b, h, m0, wg, tid);
    hg::fence_proxy_async();  // the Q tile's stores, visible to wgmma
    wg_bar(1 + wg);

    int pos[2];  // positions of this thread's rows
#pragma unroll
    for (int e = 0; e < 2; ++e) pos[e] = max(m0 + 64 * wg + 16 * warp + gid + 8 * e, 0) / G;
    const int t_first = max(m0 + 64 * wg, 0) / G;                // the warpgroup's first position
    const int n_tiles = max(m0 + 64 * wg + 63, 0) / G / BN + 1;  // up to its last position's tile
    const int n = (m0 + BM - 1) / G / BN + 1;                    // the item's tiles
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f}, alpha[2];

    // S = Q K^T of the tile in `slot`, in 16-deep steps over D (4 a 128-byte column block).
    const auto qk = [&](int slot) {
      const uint64_t dk = hg::make_desc<128>(smem + P::k_at(slot));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * (P::Q_BLOCK >> 4) + 2 * (kk & 3);
        const int koff = (kk >> 2) * (P::KV_BLOCK >> 4) + 2 * (kk & 3);
        wg_bf16::wgmma<BN>(s, dq + off, dk + koff, kk > 0 ? 1 : 0);
      }
    };
    // O += P V of the tile in `slot`, V MN-major.
    const auto pv = [&](int slot) {
      const uint64_t dv = hg::make_desc_mn(smem + P::v_at(slot), P::KV_BLOCK);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wg_bf16_rs_tb::wgmma<D>(o, ph[kk], dv + 128 * kk, 1);
        wg_bf16_rs_tb::wgmma<D>(o, pl[kk], dv + 128 * kk, 1);
      }
    };
    // The tile of keys n0 .. n0 + BN - 1 in s: softcap, causal mask (in tiles that cross the
    // diagonal), online softmax in base 2. Leaves P (float) in s and O's factor in alpha.
    const auto softmax = [&](int n0) {
      if constexpr (CAP) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] = softcap(s[i], cap_k, a.softcap);
      }
      if (n0 + BN - 1 > t_first) {
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (n0 + 8 * jj + 2 * tig + (i & 1) > pos[i >> 1]) s[4 * jj + i] = -CUDART_INF_F;
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, mb[2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        const float mn = fmaxf(m[e], mx[e]);  // finite: key 0 is visible to every row
        alpha[e] = ex2((m[e] - mn) * LOG2E);
        m[e] = mn;
        mb[e] = mn * LOG2E;
        l[e] *= alpha[e];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = ex2(fmaf(s[i], LOG2E, -mb[(i >> 1) & 1]));
        s[i] = p;
        l[(i >> 1) & 1] += p;
      }
    };
    const auto to_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) split_pair(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1], ph[kk][f], pl[kk][f]);
    };
    const auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) hg::mbar_arrive(bar);
    };

    // Tile 0, then each tile j's S = Q K^T issued with tile j - 1's O += P V behind it: tile j's
    // softmax runs while tile j - 1's products do (wgmma.wait_group 1), then O takes tile j's
    // factor.
    hg::mbar_wait(&full_k[ring.slot], ring.par);
    hg::fence_regs(s);
    hg::wgmma_fence();
    qk(ring.slot);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(s);
    release(&empty_k[ring.slot]);
    softmax(0);
    to_p();
    int prev = ring.slot;
    uint32_t prev_par = ring.par;
    ring.next();
#pragma unroll 1
    for (int j = 1; j < n_tiles; ++j, ring.next()) {
      const int slot = ring.slot;
      hg::mbar_wait(&full_k[slot], ring.par);
      hg::mbar_wait(&full_v[prev], prev_par);
      hg::fence_regs(s);
      hg::fence_regs(o);
      hg::wgmma_fence();
      qk(slot);
      hg::wgmma_commit();
      pv(prev);
      hg::wgmma_commit();
      hg::wgmma_wait<1>();
      hg::fence_regs(s);
      release(&empty_k[slot]);
      softmax(j * BN);
      hg::wgmma_wait<0>();
      hg::fence_regs(o);
      keep(ph);
      keep(pl);
      release(&empty_v[prev]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      to_p();
      prev = slot;
      prev_par = ring.par;
    }
    hg::mbar_wait(&full_v[prev], prev_par);
    hg::fence_regs(o);
    hg::wgmma_fence();
    pv(prev);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(o);
    keep(ph);
    keep(pl);
    release(&empty_v[prev]);
    // The item's tiles past this warpgroup's last position (the other warpgroups'): released
    // once they arrived, so that the ring stays in step.
#pragma unroll 1
    for (int j = n_tiles; j < n; ++j, ring.next()) {
      hg::mbar_wait(&full_k[ring.slot], ring.par);
      hg::mbar_wait(&full_v[ring.slot], ring.par);
      release(&empty_k[ring.slot]);
      release(&empty_v[ring.slot]);
    }

    // Normalise and store rows gid, gid + 8 of the warp (those from row 0 on): out [B, T, H, D].
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
      const float inv = 1.0f / l[e];
      const int p = m0 + 64 * wg + 16 * warp + gid + 8 * e, t = max(p, 0) / G, g = max(p, 0) - t * G;
      __nv_bfloat16* dst =
          static_cast<__nv_bfloat16*>(a.out) + (((size_t)a.T * b + t) * a.H + h * G + g) * D + 2 * tig;
#pragma unroll
      for (int jj = 0; jj < D / 8 && p >= 0; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
            pack_bf16(o[4 * jj + 2 * e] * inv, o[4 * jj + 2 * e + 1] * inv);
    }
  }
}

// K or V [B, T, Hkv, D] bf16 as a 2-D map of [B T rows, Hkv D columns]: boxes of 64 columns (128
// bytes) by BN rows, in 128-byte swizzle.
inline cudaError_t kv_map(CUtensorMap* map, const void* base, int B, int T, int Hkv, int D, int BN) {
  return hg::encode_map<2>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, {(uint64_t)Hkv * D, (uint64_t)B * T},
                           {(uint64_t)Hkv * D * 2}, {64u, (uint32_t)BN}, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
int launch_bf16(int device, Args a, int B, cudaStream_t stream) {
  using P = Plan<D>;
  static bool ready[2][MAX_DEVICES] = {};  // the shared-memory opt-in, once per device and kernel
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const bool cap = a.softcap > 0.0f;
  const auto kernel = cap ? bf16_kernel<D, true> : bf16_kernel<D, false>;
  if (!ready[cap][device]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready[cap][device] = true;
  }
  CUtensorMap kmap, vmap;
  cudaError_t e = kv_map(&kmap, a.k, B, a.T, a.Hkv, D, P::BN);
  if (e == cudaSuccess) e = kv_map(&vmap, a.v, B, a.T, a.Hkv, D, P::BN);
  if (e != cudaSuccess) return (int)e;
  static int sms[MAX_DEVICES] = {};
  if (sms[device] == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
  }
  a.BH = B * a.Hkv;
  a.MT = (a.T * a.G + P::BM - 1) / P::BM;
  const long long kv_bytes = 4LL * a.T * D;  // one kv head's K and V
  a.GB = (int)(GROUP_BYTES / kv_bytes < 1 ? 1 : GROUP_BYTES / kv_bytes < a.BH ? GROUP_BYTES / kv_bytes : a.BH);
  kernel<<<min(a.BH * a.MT, sms[device]), P::THREADS, P::BYTES, stream>>>(kmap, vmap, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------------------------
// The float32 arm: mma.sync over bf16 hi + lo parts.
// ---------------------------------------------------------------------------------------------

constexpr int F32_THREADS = 128;
constexpr int F32_BM = 64;  // packed query rows of a block: 4 warps of 16

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hg::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hg::smem_addr(p)));
}

template <int D>
struct Cfg {
  static constexpr int BN = D == 256 ? 32 : 64;  // keys of a tile
  static constexpr int ROW = 2 * D;             // bytes of a bf16 row in shared memory
  static constexpr int CHUNKS = D / 8;          // 16-byte chunks of a row
  static constexpr int Q_BYTES = F32_BM * ROW;
  static constexpr int KV_BYTES = BN * ROW;
  // Shared memory: q [hi, lo], then per buffer K [hi, lo], V [hi, lo].
  __host__ __device__ static constexpr int q_at(int part) { return part * Q_BYTES; }
  __host__ __device__ static constexpr int k_at(int buf, int part) { return 2 * Q_BYTES + (buf * 4 + part) * KV_BYTES; }
  __host__ __device__ static constexpr int v_at(int buf, int part) {
    return 2 * Q_BYTES + (buf * 4 + 2 + part) * KV_BYTES;
  }
  static constexpr int BYTES = 2 * Q_BYTES + 8 * KV_BYTES;
};

// Byte offset of chunk c of row r in a tile.
template <int ROW>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * ROW + ((c ^ (r & 7)) << 4);
}

// Eight consecutive floats of a row.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p)), b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Eight floats into chunk (r, c) of the bf16 hi tile at dst and the lo tile at dst + stride.
template <int ROW>
__device__ __forceinline__ void store8(unsigned char* dst, int stride, int r, int c, const float (&f)[8]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_pair(f[2 * i], f[2 * i + 1], hi[i], lo[i]);
  *reinterpret_cast<uint4*>(dst + chunk_at<ROW>(r, c)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + stride + chunk_at<ROW>(r, c)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1) f32_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int BN = C::BN, ROW = C::ROW, CH = C::CHUNKS;
  constexpr int NT = BN / 8;  // 8-key n tiles of the logits
  constexpr int DT = D / 8;   // 8-wide n tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];

  const int T = a.T, G = a.G, H = a.H, Hkv = a.Hkv;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * F32_BM;  // the longest walks first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  // q: rows m0 .. m0 + 63, scaled in float32, then split.
  for (int i = threadIdx.x; i < F32_BM * CH; i += F32_THREADS) {
    const int r = i / CH, c = i % CH;
    const int p = m0 + r, t = p / G, g = p - t * G;
    float f[8];
    load8(q + (((size_t)b * T + t) * H + h * G + g) * D + c * 8, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] *= a.scale;
    store8<ROW>(smem + C::q_at(0), C::Q_BYTES, r, c, f);
  }

  const int t_last = (m0 + F32_BM - 1) / G;  // the block's last position
  const int t_first = m0 / G;
  const int n_tiles = t_last / BN + 1;

  // K and V rows n0 .. n0 + BN - 1 into buffer buf.
  const auto load_kv = [&](int n0, int buf) {
    for (int i = threadIdx.x; i < BN * CH; i += F32_THREADS) {
      const int r = i / CH, c = i % CH;
      const size_t off = (((size_t)b * T + n0 + r) * Hkv + h) * D + c * 8;
      float f[8];
      load8(k + off, f);
      store8<ROW>(smem + C::k_at(buf, 0), C::KV_BYTES, r, c, f);
      load8(v + off, f);
      store8<ROW>(smem + C::v_at(buf, 0), C::KV_BYTES, r, c, f);
    }
  };

  // This thread's rows: gid and gid + 8 of the warp's 16, at positions pos[0], pos[1].
  const int row0 = warp * 16;
  int pos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) pos[e] = (m0 + row0 + gid + 8 * e) / G;

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  const float cap = a.softcap;

  load_kv(0, 0);
#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN, buf = j & 1;
    if (j + 1 < n_tiles) load_kv(n0 + BN, buf ^ 1);
    __syncthreads();

    // Logits [16 rows, BN keys] of this warp.
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int mi = lane >> 3, mj = lane & 7;
      uint32_t qa[2][4];
#pragma unroll
      for (int part = 0; part < 2; ++part)
        ldsm_x4(qa[part], smem + C::q_at(part) + chunk_at<ROW>(row0 + (mi & 1) * 8 + mj, 2 * kk + (mi >> 1)));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = chunk_at<ROW>(16 * np + (mi >> 1) * 8 + mj, 2 * kk + (mi & 1));
        uint32_t kb[4];
        ldsm_x4(kb, smem + C::k_at(buf, 0) + off);
        mma_bf16(s[2 * np], qa[0], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[0], kb[2], kb[3]);
        mma_bf16(s[2 * np], qa[1], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[1], kb[2], kb[3]);
        ldsm_x4(kb, smem + C::k_at(buf, 1) + off);
        mma_bf16(s[2 * np], qa[0], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[0], kb[2], kb[3]);
      }
    }

    // Softcap, causal mask (tiles that cross the diagonal), online softmax in base 2.
    const bool diag = n0 + BN - 1 > t_first;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[i][c];
        if (cap > 0.0f) x = cap * tanhf(x / cap);
        x *= LOG2E;
        if (diag && n0 + 8 * i + 2 * tig + (c & 1) > pos[c >> 1]) x = -CUDART_INF_F;
        s[i][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float mn = fmaxf(m[e], mx[e]);  // finite: key 0 is visible to every row
      alpha[e] = exp2f(m[e] - mn);
      m[e] = mn;
      l[e] *= alpha[e];
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[i][c] - m[c >> 1]);
        s[i][c] = p;
        l[c >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // out += P V: P's A fragments from the logits' accumulators (hi and lo bf16 parts).
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const int mi = lane >> 3, mj = lane & 7;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int off = chunk_at<ROW>(16 * kk + (mi & 1) * 8 + mj, 2 * dp + (mi >> 1));
        uint32_t vb[4];
        ldsm_x4_t(vb, smem + C::v_at(buf, 0) + off);
        mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
        ldsm_x4_t(vb, smem + C::v_at(buf, 1) + off);
        mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before it is loaded again
  }

  // Normalise and store rows gid, gid + 8 of the warp: out [B, T, H, D] in float32.
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const float inv = 1.0f / l[e];
    const int p = m0 + row0 + gid + 8 * e, t = p / G, g = p - t * G;
    const size_t base = (((size_t)b * T + t) * H + h * G + g) * D + 2 * tig;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base + 8 * i) =
          make_float2(o[i][2 * e] * inv, o[i][2 * e + 1] * inv);
  }
}

template <int D>
int launch_f32(int device, const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool ready[MAX_DEVICES] = {};  // the shared-memory opt-in, once per device
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t e = cudaFuncSetAttribute(f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready[device] = true;
  }
  const dim3 grid(a.T * a.G / F32_BM, B * a.Hkv);
  f32_kernel<D><<<grid, F32_THREADS, C::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, H, D], k/v [B, T, Hkv, D], out [B, T, H, D], all float32 (f32 = 1) or all bfloat16;
// D 128 or 256, T a multiple of 128, H a multiple of Hkv. softcap <= 0: none. next: one int32 on
// the device, 0, kept for the stream's launches (the bfloat16 arm hands out its work items through
// it and leaves it 0).
extern "C" int flash_prefill(int device, const void* q, const void* k, const void* v, void* out, void* next, int B,
                             int T, int H, int Hkv, int D, int f32, float scale, float softcap, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || T < 128 || T % 128 != 0 || Hkv < 1 || H % Hkv != 0 || (D != 128 && D != 256) || !next)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.T = T;
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.scale = scale;
  a.softcap = softcap > 0.0f ? softcap : 0.0f;
  a.next = static_cast<int*>(next);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) return D == 128 ? launch_f32<128>(device, a, B, s) : launch_f32<256>(device, a, B, s);
  return D == 128 ? launch_bf16<128>(device, a, B, s) : launch_bf16<256>(device, a, B, s);
}
