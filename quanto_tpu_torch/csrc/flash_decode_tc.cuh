// The tensor-core arm of flash_decode (TPU #8-#10): bfloat16 q over a bfloat16 cache or over any two
// of int8, int4 and float8 codes. flash_decode.cu's source note gives the function and the design.
// Each of flash_decode_tc64.cu, flash_decode_tc128.cu and flash_decode_tc256.cu includes this header
// and defines the arm's entries at its head dim (FD_TC_ENTRIES), so that the three build in parallel:
// one source holding all three took 145 s to build, the build's slowest.

#pragma once

#include "flash_decode.cuh"

namespace fd {
namespace {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 v) { return *reinterpret_cast<const uint32_t*>(&v); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) { return bf16_bits(__floats2bfloat162_rn(lo, hi)); }
__device__ __forceinline__ float2 bf16_pair(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Two int4 codes (stored + 8) at bits 0-3 and 16-19 of t as a bf16 pair, exact: OR-ed into the
// mantissa of bf16 128 (step 1 there), then 136 subtracted.
__device__ __forceinline__ uint32_t nib_pair(uint32_t t) {
  const uint32_t u = (t & 0x000F000Fu) | 0x43004300u;
  return bf16_bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u), __floats2bfloat162_rn(136.f, 136.f)));
}

// Byte k of a word of int8 codes as a float, exact; wx is the word ^ 0x80808080 (code + 128):
// 0x4B000000 | byte is 2^23 + code + 128.
__device__ __forceinline__ float s8_at(uint32_t wx, int k) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7440 | k)) - 8388736.0f;
}

// Code byte ka of word x and code byte kb of word y as a bf16 pair (x's low), exact.
template <int T>
__device__ __forceinline__ uint32_t byte_pair(uint32_t x, int ka, uint32_t y, int kb, const uint16_t* lut) {
  if constexpr (T == I8) {
    return pack_bf16(s8_at(x ^ 0x80808080u, ka), s8_at(y ^ 0x80808080u, kb));
  } else {
    return (uint32_t)lut[(x >> (8 * ka)) & 0xFFu] | ((uint32_t)lut[(y >> (8 * kb)) & 0xFFu] << 16);
  }
}

template <int NB>
__device__ __forceinline__ void lds(const unsigned char* p, uint32_t (&w)[NB / 4]) {
  if constexpr (NB == 32) {  // a 32-byte run (D = 256: int4 K, int8 and float8 V), contiguous under swz
    const uint4 v = *reinterpret_cast<const uint4*>(p), u = *reinterpret_cast<const uint4*>(p + 16);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    w[4] = u.x; w[5] = u.y; w[6] = u.z; w[7] = u.w;
  } else if constexpr (NB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (NB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// The tensor-core arm: bf16 q over a bf16 cache, or over any two of int8, int4 and float8 codes.
template <int KT, int VT, int D_, int NT>
struct TcArm {
  static constexpr int D = D_;
  static constexpr int GR = 8 * NT;  // query rows of a group: NT n-tiles of 8
  static constexpr int KROW = row_bytes<KT, D>(), VROW = row_bytes<VT, D>();
  static constexpr int TS = tile_slots(KROW + VROW);
  static constexpr bool SCALES = KT > BF16;  // a quantized cache has per-slot factors
  using SL = StageLayout<TS, KROW, VROW, SCALES>;
  static constexpr int STAGES = ring_stages(SL::bytes, D);
  static constexpr int LUT_BYTES = (KT == FP8 || VT == FP8) ? 2 * 256 * 2 : 16;
  static constexpr int KS = D / 16;  // k steps of the logits product, m tiles of the output product

  struct State {
    uint32_t qb[NT][KS][2];  // q^T B fragments, in the K fragments' head-dim order
    float qsum[NT][2];       // sum_d q of this thread's two query columns
    float m[NT][2], l[NT][2], accm[NT][2];
    float o[NT][KS][4];      // out^T: m tile i, rows (head dims) dv(i, 0/1), columns 2 tig + 0/1
  };

  // The head dim of position r (0-3: a0 low, high, a2 low, high) of k step j of thread tig's K
  // fragments: whole 16-byte runs of a slot row (bf16: 8 values, 2 steps; int8/float8: 16 values,
  // 4 steps; int4: 32 or 16 codes, the registers pairing codes i and i + 4 of a word).
  static __device__ __forceinline__ int kmap(int j, int r, int tig) {
    if constexpr (KT == BF16) return 8 * (tig + 4 * (j >> 1)) + 4 * (j & 1) + r;
    else if constexpr (KT == I4) return (D / 4) * tig + 8 * (j >> 1) + 2 * (j & 1) + ((r & 1) << 2) + (r >> 1);
    else return 16 * (tig + 4 * (j >> 2)) + 4 * (j & 3) + r;
  }
  // The head dim of output row gid (r = 0) or gid + 8 (r = 1) of m tile i: the V run of lane
  // group gid (bf16: chunks gid and gid + 8; else D / 8 values from (D / 8) gid), two a tile.
  static __device__ __forceinline__ int dmap(int i, int r, int gid) {
    if constexpr (VT == BF16) return 8 * (gid + 8 * (i >> 2)) + 2 * (i & 3) + r;
    else return (D / 8) * gid + 2 * i + r;
  }

  static __device__ __forceinline__ void load_luts(const Args& a, unsigned char* lut) {
    if constexpr (KT == FP8 || VT == FP8) {
      uint16_t* t = reinterpret_cast<uint16_t*>(lut);
      for (int i = threadIdx.x; i < 512; i += THREADS) {
        const float* src = i < 256 ? a.k_lut : a.v_lut;
        if (src != nullptr) t[i] = __bfloat16_as_ushort(__float2bfloat16(src[i & 255]));
      }
    }
  }

  static __device__ __forceinline__ void begin(State& s, const Args& a, int b, int h, int grp) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int g = grp * GR + 8 * nt + gid;
      const bool ok = g < a.G && h < a.Hkv;
      const __nv_bfloat16* row = q + (((size_t)b * a.Hkv + (ok ? h : 0)) * a.G + (ok ? g : 0)) * D;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        uint32_t h[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const __nv_bfloat16 x = ok ? row[kmap(j, r, tig)] : __float2bfloat16(0.0f);
          sum += __bfloat162float(x);
          h[r] = __bfloat16_as_ushort(x);
        }
        s.qb[nt][j][0] = h[0] | (h[1] << 16);
        s.qb[nt][j][1] = h[2] | (h[3] << 16);
      }
      // sum_d q of row gid, then each thread takes those of its columns 2 tig, 2 tig + 1.
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s.qsum[nt][e] = __shfl_sync(0xffffffffu, sum, (2 * tig + e) * 4);
        s.m[nt][e] = -CUDART_INF_F;
        s.l[nt][e] = 0.0f;
        s.accm[nt][e] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < KS; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s.o[nt][i][c] = 0.0f;
    }
  }

  // A fragments of the logits product: K rows r0 and r0 + 8 (slots), this thread's run of each.
  static __device__ __forceinline__ void k_frags(const unsigned char* K, int r0, int tig, const uint16_t* lut,
                                                 uint32_t (&f)[KS][4]) {
    const int r1 = r0 + 8;
    if constexpr (KT == BF16) {
#pragma unroll
      for (int k = 0; k < D / 32; ++k) {
        uint32_t x[4], y[4];
        lds<16>(K + swz<KROW>(r0, (tig + 4 * k) * 16), x);
        lds<16>(K + swz<KROW>(r1, (tig + 4 * k) * 16), y);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          f[2 * k + h][0] = x[2 * h];
          f[2 * k + h][1] = y[2 * h];
          f[2 * k + h][2] = x[2 * h + 1];
          f[2 * k + h][3] = y[2 * h + 1];
        }
      }
    } else if constexpr (KT == I4) {
      constexpr int NW = D / 32;  // words of 8 codes in the run
      uint32_t x[NW], y[NW];
      lds<NW * 4>(K + swz<KROW>(r0, tig * NW * 4), x);
      lds<NW * 4>(K + swz<KROW>(r1, tig * NW * 4), y);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          f[2 * w + h][0] = nib_pair(x[w] >> (8 * h));
          f[2 * w + h][1] = nib_pair(y[w] >> (8 * h));
          f[2 * w + h][2] = nib_pair(x[w] >> (8 * h + 4));
          f[2 * w + h][3] = nib_pair(y[w] >> (8 * h + 4));
        }
    } else {
#pragma unroll
      for (int k = 0; k < D / 64; ++k) {
        uint32_t x[4], y[4];
        lds<16>(K + swz<KROW>(r0, (tig + 4 * k) * 16), x);
        lds<16>(K + swz<KROW>(r1, (tig + 4 * k) * 16), y);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          f[4 * k + h][0] = byte_pair<KT>(x[h], 0, x[h], 1, lut);
          f[4 * k + h][1] = byte_pair<KT>(y[h], 0, y[h], 1, lut);
          f[4 * k + h][2] = byte_pair<KT>(x[h], 2, x[h], 3, lut);
          f[4 * k + h][3] = byte_pair<KT>(y[h], 2, y[h], 3, lut);
        }
      }
    }
  }

  // A fragments of the output product: V rows (slots) rA, rA + 8 (k 2 tig, 2 tig + 1) and rA + 4,
  // rA + 12 (k 2 tig + 8, 2 tig + 9) at the head dims of lane group gid; a register pairs two
  // slots at one head dim.
  static __device__ __forceinline__ void v_frags(const unsigned char* V, int rA, int gid, const uint16_t* lut,
                                                 uint32_t (&f)[KS][4]) {
    const int rows[4] = {rA, rA + 8, rA + 4, rA + 12};
    if constexpr (VT == BF16) {
      uint32_t w[4][KS];  // per row: the words of chunks gid (and gid + 8)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < D / 64; ++k) {
          uint32_t x[4];
          lds<16>(V + swz<VROW>(rows[q], (gid + 8 * k) * 16), x);
#pragma unroll
          for (int t = 0; t < 4; ++t) w[q][4 * k + t] = x[t];
        }
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        f[i][0] = __byte_perm(w[0][i], w[1][i], 0x5410);
        f[i][1] = __byte_perm(w[0][i], w[1][i], 0x7632);
        f[i][2] = __byte_perm(w[2][i], w[3][i], 0x5410);
        f[i][3] = __byte_perm(w[2][i], w[3][i], 0x7632);
      }
    } else if constexpr (VT == I4) {
      constexpr int NW = D / 64;  // words of 8 codes: D / 8 codes of each row
      uint32_t w[4][NW];
#pragma unroll
      for (int q = 0; q < 4; ++q) lds<NW * 4>(V + swz<VROW>(rows[q], gid * NW * 4), w[q]);
#pragma unroll
      for (int wi = 0; wi < NW; ++wi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t sel = half ? 0x7632 : 0x5410;  // codes 0-3 or 4-7 of both words
          const uint32_t ab = __byte_perm(w[0][wi], w[1][wi], sel), cd = __byte_perm(w[2][wi], w[3][wi], sel);
#pragma unroll
          for (int t = 0; t < 2; ++t) {  // m tile 4 wi + 2 half + t: codes 2 t, 2 t + 1 of the half
            const int i = 4 * wi + 2 * half + t;
            f[i][0] = nib_pair(ab >> (8 * t));
            f[i][1] = nib_pair(ab >> (8 * t + 4));
            f[i][2] = nib_pair(cd >> (8 * t));
            f[i][3] = nib_pair(cd >> (8 * t + 4));
          }
        }
    } else {
      constexpr int NW = D / 32;  // words of 4 codes: D / 8 codes of each row
      uint32_t w[4][NW];
#pragma unroll
      for (int q = 0; q < 4; ++q) lds<NW * 4>(V + swz<VROW>(rows[q], gid * NW * 4), w[q]);
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int wi = i >> 1, k = 2 * (i & 1);  // codes 2 i, 2 i + 1: bytes k, k + 1 of word wi
        f[i][0] = byte_pair<VT>(w[0][wi], k, w[1][wi], k, lut);
        f[i][1] = byte_pair<VT>(w[0][wi], k + 1, w[1][wi], k + 1, lut);
        f[i][2] = byte_pair<VT>(w[2][wi], k, w[3][wi], k, lut);
        f[i][3] = byte_pair<VT>(w[2][wi], k + 1, w[3][wi], k + 1, lut);
      }
    }
  }

  // This warp's TS slots of one head: K and V rows from K, V (row r: slot r), the factors of slot r
  // at sc[r] (k_scale; v_scale, k_shift, v_shift SL::rows floats apart), the first n visible.
  // MJ m tiles of 16 slots at a time: their products are independent, and one online-softmax step
  // (one max, one rescale of out) covers them all.
  static constexpr int MJ = TS >= 32 ? 2 : 1;
  static constexpr int PARTS = 3;  // bf16 parts of p s_v in the output product
  static __device__ __forceinline__ void tile(State& s, const Args& a, const unsigned char* K, const unsigned char* V,
                                              const float* sc, int n, const unsigned char* lut) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    const uint16_t* lut_k = reinterpret_cast<const uint16_t*>(lut);
    const uint16_t* lut_v = lut_k + 256;
#pragma unroll 1
    for (int r0 = 0; r0 < TS && r0 < n; r0 += 16 * MJ) step(s, a, K, V, sc, r0, n, lut_k, lut_v, gid, tig);
  }

  // Slots r0 .. r0 + 16 MJ - 1.
  static __device__ __forceinline__ void step(State& s, const Args& a, const unsigned char* K, const unsigned char* V,
                                              const float* sc, int r0, int n, const uint16_t* lut_k,
                                              const uint16_t* lut_v, int gid, int tig) {
    // logits^T [16 slots, 8 queries] of each m tile and n tile, the k steps in two chains.
    float c[MJ][NT][4];
#pragma unroll
    for (int mj = 0; mj < MJ; ++mj) {
      uint32_t f[KS][4];
      k_frags(K, r0 + 16 * mj + gid, tig, lut_k, f);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float c2[2][4] = {};
#pragma unroll
        for (int j = 0; j < KS; ++j) mma_bf16(c2[j & 1], f[j], s.qb[nt][j][0], s.qb[nt][j][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) c[mj][nt][i] = c2[0][i] + c2[1][i];
      }
    }

    // This thread's slots: rows gid and gid + 8 of each m tile (h = 0, 1).
    bool ok[MJ][2];
    float sk[MJ][2], sv[MJ][2], mk[MJ][2], mv[MJ][2];
#pragma unroll
    for (int mj = 0; mj < MJ; ++mj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * mj + gid + 8 * h;
        ok[mj][h] = r < n;
        sk[mj][h] = sv[mj][h] = 1.0f;
        mk[mj][h] = mv[mj][h] = 0.0f;
        if constexpr (SCALES) {
          sk[mj][h] = sc[r];
          sv[mj][h] = sc[SL::rows + r];
          if (a.mode == SHIFTED) {
            mk[mj][h] = sc[2 * SL::rows + r];
            mv[mj][h] = sc[3 * SL::rows + r];
          }
        }
      }

    // Online softmax per query column; p s_v goes to the B fragments of the output product as
    // PARTS bf16 parts, each the bf16 rounding of what the ones before left (pb[..][part]): three
    // products carry its 24 bits, where one would round it to 8 and move the output by up to a
    // bf16 step.
    uint32_t pb[MJ][NT][PARTS][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float w[MJ][2][2];  // [m tile][row h][column e]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float t[MJ][2];
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int mj = 0; mj < MJ; ++mj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = fmaf(c[mj][nt][2 * h + e], sk[mj][h], s.qsum[nt][e] * mk[mj][h]);
            t[mj][h] = ok[mj][h] ? logit2(a, x) : -CUDART_INF_F;
            mx = fmaxf(mx, t[mj][h]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mn = fmaxf(s.m[nt][e], mx);
        // mn = -inf only while none of the warp's slots so far was visible.
        const bool none = mn == -CUDART_INF_F;
        const float alpha = none ? 1.0f : fast_exp2(s.m[nt][e] - mn);
        float lsum = 0.0f, msum = 0.0f;
#pragma unroll
        for (int mj = 0; mj < MJ; ++mj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p = none ? 0.0f : fast_exp2(t[mj][h] - mn);
            lsum += p;
            msum = fmaf(p, mv[mj][h], msum);
            w[mj][h][e] = p * sv[mj][h];
          }
        s.m[nt][e] = mn;
        s.l[nt][e] = fmaf(s.l[nt][e], alpha, lsum);
        s.accm[nt][e] = fmaf(s.accm[nt][e], alpha, msum);
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          s.o[nt][i][e] *= alpha;
          s.o[nt][i][2 + e] *= alpha;
        }
      }
      // Lane (gid, tig) needs query gid's weights of slots tig, tig + 8 (b0) and tig + 4, tig + 12
      // (b1); lane (s, g / 2) holds slots s and s + 8 of queries 2 (g / 2) and 2 (g / 2) + 1.
      const int src = 4 * tig + (gid >> 1);
#pragma unroll
      for (int mj = 0; mj < MJ; ++mj)
#pragma unroll
        for (int part = 0; part < PARTS; ++part) {
          const uint32_t even = pack_bf16(w[mj][0][0], w[mj][1][0]), odd = pack_bf16(w[mj][0][1], w[mj][1][1]);
          const uint32_t e0 = __shfl_sync(0xffffffffu, even, src), o0 = __shfl_sync(0xffffffffu, odd, src);
          const uint32_t e1 = __shfl_sync(0xffffffffu, even, src + 16), o1 = __shfl_sync(0xffffffffu, odd, src + 16);
          pb[mj][nt][part][0] = (gid & 1) ? o0 : e0;
          pb[mj][nt][part][1] = (gid & 1) ? o1 : e1;
          if (part + 1 < PARTS) {  // what this part left: w - bf16(w), exact in float32
            const float2 he = bf16_pair(even), ho = bf16_pair(odd);
            w[mj][0][0] -= he.x; w[mj][1][0] -= he.y;
            w[mj][0][1] -= ho.x; w[mj][1][1] -= ho.y;
          }
        }
    }

    // out^T [D, 8 queries] += C_v^T [D, 16 slots] . (p s_v)^T, each m tile.
#pragma unroll
    for (int mj = 0; mj < MJ; ++mj) {
      uint32_t f[KS][4];
      v_frags(V, r0 + 16 * mj + tig, gid, lut_v, f);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int part = 0; part < PARTS; ++part)
#pragma unroll
          for (int i = 0; i < KS; ++i) mma_bf16(s.o[nt][i], f[i], pb[mj][nt][part][0], pb[mj][nt][part][1]);
    }
  }

  static __device__ __forceinline__ void export_(State& s, float* mine) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float l = s.l[nt][e], am = s.accm[nt][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          l += __shfl_xor_sync(0xffffffffu, l, o);
          am += __shfl_xor_sync(0xffffffffu, am, o);
        }
        const int g = 8 * nt + 2 * tig + e;
        if (gid == 0) {
          mine[g] = s.m[nt][e];
          mine[GR + g] = l;
        }
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          mine[2 * GR + g * D + dmap(i, 0, gid)] = s.o[nt][i][e] + am;
          mine[2 * GR + g * D + dmap(i, 1, gid)] = s.o[nt][i][2 + e] + am;
        }
      }
  }
};

template <int KT, int VT, int D>
using TcArm1 = TcArm<KT, VT, D, 1>;
template <int KT, int VT, int D>
using TcArm2 = TcArm<KT, VT, D, 2>;

template <int D, class F>
int tc_visit(int G, int kt, int vt, F&& f) {
  return G > 8 ? visit<TcArm2, BF16, BF16, D>(kt, vt, f) : visit<TcArm1, BF16, BF16, D>(kt, vt, f);
}

}  // namespace

// The entries of the arm at head dim D_ (declared in flash_decode.cuh), defined in its own source.
#define FD_TC_ENTRIES(D_)                                                                             \
  int tc_launch##D_(int device, const Args& a, int kt, int vt, cudaStream_t stream) {                 \
    return tc_visit<D_>(a.G, kt, vt, [&](auto arm) { return arm_launch<decltype(arm)>(device, a, stream); }); \
  }                                                                                                    \
  int tc_workspace##D_(int device, int G, int kt, int vt, long long* ws_floats, int* groups) {        \
    return tc_visit<D_>(G, kt, vt,                                                                     \
                        [&](auto arm) { return arm_workspace<decltype(arm)>(device, G, ws_floats, groups); }); \
  }

}  // namespace fd
