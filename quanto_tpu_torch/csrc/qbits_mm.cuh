// Device code shared by the int4/int2 group-wise dequant matmuls of qbits_mm_tiled.cu,
// qbits_mm_small_m.cu and qbits_mm_requant.cu (one weight) and moe_mm.cu and moe_gemm.cu (a weight
// per slot of a stacked expert array); the small-M tensor-core body is small_m_tc.cuh.
//
//   y[M, N] = x[M, K] @ deq(W)^T,   deq(W)[n, k] = s[g, n] * c[n, k] - z[g, n],   g = k / gs,
//
// computed group-factored as  y = sum_g s_g * (x_g . c_g) - (sum_k x_gk) * z_g  with float32
// sums. x is bfloat16 or float32; the output type TO is x's or float32.
//
// Weight layout (quanto_tpu_torch/tensor/weights.py:WeightQBitsHopperArray), BITS = 4 or 2:
//   packed  uint8 [N, K * BITS / 8], K-contiguous: code k of a row at bits BITS * (k % (8 / BITS))
//           of byte k / (8 / BITS). int4: packed[n, j] = c[n, 2j] | c[n, 2j + 1] << 4; int2:
//           packed[n, j] = c[n, 4j] | c[n, 4j + 1] << 2 | c[n, 4j + 2] << 4 | c[n, 4j + 3] << 6.
//           So code t of a run of 32 codes starting at a multiple of 32 lies at bit BITS * t of
//           the run's BITS 32-bit words (little endian); bytes are unsigned, so no sign extension;
//   scale_t, shift_t  float32 [G, N] (G = K / gs), float-shift semantics.
//
// The kernels' bodies are device functions over one block's output tile, templated on BITS, so
// that a kernel computes the offsets of its operands (an expert's weight, a slot's x) and calls
// them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qbits {

// A code c in [0, 15] as a float: 0x4B000000 | c is the float 2^23 + c exactly.
__device__ __forceinline__ float code_to_float(uint32_t c) {
  return __uint_as_float(0x4B000000u | c) - 8388608.0f;
}

// Bytes of a packed weight row of K codes.
template <int BITS>
__device__ __forceinline__ size_t row_bytes(int K) {
  return (size_t)K * BITS / 8;
}

// The 32 codes of a run (BITS * 4 bytes, aligned to that size) as BITS 32-bit words: one 16-byte
// load for int4, one 8-byte load for int2.
template <int BITS>
__device__ __forceinline__ void load_run(const uint8_t* p, uint32_t (&w)[BITS]);

template <>
__device__ __forceinline__ void load_run<4>(const uint8_t* p, uint32_t (&w)[4]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

template <>
__device__ __forceinline__ void load_run<2>(const uint8_t* p, uint32_t (&w)[2]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  w[0] = v.x;
  w[1] = v.y;
}

// Code t (0 <= t < 32, known at compile time once unrolled) of a run loaded by load_run.
template <int BITS>
__device__ __forceinline__ uint32_t run_code(const uint32_t (&w)[BITS], int t) {
  return (w[(BITS * t) / 32] >> ((BITS * t) % 32)) & ((1u << BITS) - 1u);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---------------------------------------------------------------------------------------------
// Tiled body (prompt-sized M).
//
// Bound on this card by operations: at M = 4096 each weight code is used 4096 times. Design:
// a block owns a BM x TL_BN output tile and loops over K in TL_BK steps inside the block (the
// TPU's "arbitrary" K grid axis has no counterpart across blocks). Each step stages the x tile
// and the weight tile in shared memory as bfloat16: codes are unpacked to bfloat16, which is
// exact for int4 and int2, and float32 x is split into a bfloat16 high part and a bfloat16 low part (two
// products), so the tensor cores see float32 x to about 16 bits. mma.sync m16n8k16 sums x . c in
// float32 per group; at each group's end the per-group epilogue y += s_g * acc - (sum x_g) * z_g
// runs in registers, with sum x_g taken from the staged values' float32 sums. No wgmma, TMA or
// pipelining yet: right and simple first.
//
// int2: a K step keeps its TL_BK = 64 codes and halves its bytes (each thread stages 8 packed
// bytes instead of 16), rather than keeping its bytes and taking 128 codes. The staged tile is
// bf16 codes either way, so the shared-memory layout, the mma loop and the per-group epilogue
// (gs % 64 == 0) stay the int4 arm's; a 128-code step would double the x tile in shared memory
// for a kernel that is held by its tensor-core work, not by the weight bytes.
//
// The 8 warps form a WM x (8 / WM) grid, each warp an (MT * 16) x (NT * 8) tile. moe_mm.cu runs
// it with WM = 1, MT = 1: a 16 x 128 tile for M <= 16, where a 128-row tile would spend 8x the
// tensor-core work on padding rows. (The one-weight kernels at M > 512 are the pipelined wgmma
// GEMMs of qbits_mm_tiled.cu.)
// ---------------------------------------------------------------------------------------------
constexpr int TL_BN = 128;
constexpr int TL_BK = 64;
constexpr int TL_THREADS = 256;
constexpr int TL_LD = TL_BK + 8;  // padded shared-memory row (bf16 elements): no bank conflicts

template <typename T>
struct XPlanes;
template <>
struct XPlanes<__nv_bfloat16> {
  static constexpr int n = 1;
};
template <>
struct XPlanes<float> {
  static constexpr int n = 2;
};

template <typename T, int BM>
constexpr size_t tiled_smem_bytes() {
  return (size_t)(XPlanes<T>::n * BM + TL_BN) * TL_LD * sizeof(__nv_bfloat16) + BM * sizeof(float);
}

// Stage 32 consecutive x values of one row into the bf16 plane(s); return their float32 sum.
__device__ __forceinline__ float stage_x32(const __nv_bfloat16* src, bool valid,
                                           __nv_bfloat16* hi, __nv_bfloat16* /*lo*/) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 v = valid ? reinterpret_cast<const uint4*>(src)[i] : make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(h[j]);
      s += t.x + t.y;
    }
    reinterpret_cast<uint4*>(hi)[i] = v;
  }
  return s;
}

__device__ __forceinline__ float stage_x32(const float* src, bool valid, __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 a = valid ? reinterpret_cast<const float4*>(src)[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    s += (a.x + a.y) + (a.z + a.w);
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(a.x, a.y);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(a.z, a.w);
    const float2 f0 = __bfloat1622float2(h0);
    const float2 f1 = __bfloat1622float2(h1);
    reinterpret_cast<__nv_bfloat162*>(hi)[2 * i] = h0;
    reinterpret_cast<__nv_bfloat162*>(hi)[2 * i + 1] = h1;
    reinterpret_cast<__nv_bfloat162*>(lo)[2 * i] = __floats2bfloat162_rn(a.x - f0.x, a.y - f0.y);
    reinterpret_cast<__nv_bfloat162*>(lo)[2 * i + 1] = __floats2bfloat162_rn(a.z - f1.x, a.w - f1.y);
  }
  return s;
}

// Stage 32 consecutive codes (4 * BITS packed bytes) of one weight row as bf16.
template <int BITS>
__device__ __forceinline__ void stage_w32(const uint8_t* src, __nv_bfloat16* dst) {
  uint32_t w[BITS];
  load_run<BITS>(src, w);
#pragma unroll
  for (int p = 0; p < 16; ++p)  // codes 2p and 2p + 1
    reinterpret_cast<__nv_bfloat162*>(dst)[p] = __floats2bfloat162_rn(
        code_to_float(run_code<BITS>(w, 2 * p)), code_to_float(run_code<BITS>(w, 2 * p + 1)));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------------------------
// Codes of a run of 32 (load_run) as int8, one code a byte (s8 tensor-core operands).
// ---------------------------------------------------------------------------------------------

// The 4 x 4 byte transpose: byte b of o_i is byte i of a_b.
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                           uint32_t& o0, uint32_t& o1, uint32_t& o2,
                                           uint32_t& o3) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140);  // a0.b0 a1.b0 a0.b1 a1.b1
  const uint32_t t1 = __byte_perm(a0, a1, 0x7362);  // a0.b2 a1.b2 a0.b3 a1.b3
  const uint32_t t2 = __byte_perm(a2, a3, 0x5140);  // a2.b0 a3.b0 a2.b1 a3.b1
  const uint32_t t3 = __byte_perm(a2, a3, 0x7362);  // a2.b2 a3.b2 a2.b3 a3.b3
  o0 = __byte_perm(t0, t2, 0x5410);
  o1 = __byte_perm(t0, t2, 0x7632);
  o2 = __byte_perm(t1, t3, 0x5410);
  o3 = __byte_perm(t1, t3, 0x7632);
}

// Operand j (0..7) of a run's codes: code i of each byte of packed word j / (8 / BITS), i =
// j % (8 / BITS), one code (0..15 or 0..3, exact as s8) per byte. int4: byte b of word q holds
// codes 8q + 2b and 8q + 2b + 1; int2: crumb i of byte b of word q holds code 16q + 4b + i.
template <int BITS>
__device__ __forceinline__ uint32_t code_operand(const uint32_t (&w)[BITS], int j) {
  constexpr int per = 8 / BITS;
  constexpr uint32_t mask = ((1u << BITS) - 1u) * 0x01010101u;
  return (w[j / per] >> (BITS * (j % per))) & mask;
}

// The run's 32 codes as int8, in K order: cw[j] holds codes 4j .. 4j + 3.
template <int BITS>
__device__ __forceinline__ void codes_s8(const uint32_t (&pw)[BITS], uint32_t (&cw)[8]) {
  if constexpr (BITS == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo = code_operand<4>(pw, 2 * q);      // codes 8q + 0, 2, 4, 6
      const uint32_t hi = code_operand<4>(pw, 2 * q + 1);  // codes 8q + 1, 3, 5, 7
      cw[2 * q] = __byte_perm(lo, hi, 0x5140);
      cw[2 * q + 1] = __byte_perm(lo, hi, 0x7362);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q)  // crumb planes i = 0..3 of word q, transposed: byte b's codes
      transpose4(code_operand<2>(pw, 4 * q), code_operand<2>(pw, 4 * q + 1),
                 code_operand<2>(pw, 4 * q + 2), code_operand<2>(pw, 4 * q + 3), cw[4 * q],
                 cw[4 * q + 1], cw[4 * q + 2], cw[4 * q + 3]);
  }
}

// A fragments of a warp's MT m16 tiles of one x plane at column ks.
template <int MT>
__device__ __forceinline__ void load_a(const __nv_bfloat16* plane, int row0, int ks, int gid,
                                       int tig, uint32_t (&a)[MT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const __nv_bfloat16* p = plane + (row0 + mt * 16 + gid) * TL_LD + ks + tig * 2;
    a[mt][0] = ld32(p);
    a[mt][1] = ld32(p + 8 * TL_LD);
    a[mt][2] = ld32(p + 8);
    a[mt][3] = ld32(p + 8 * TL_LD + 8);
  }
}

// Output tile rows m0 .. m0 + WM * MT * 16 - 1 (those below M), columns n0 .. n0 + TL_BN - 1.
// Needs tiled_smem_bytes<T, WM * MT * 16>() bytes of dynamic shared memory and TL_THREADS threads.
template <typename T, typename TO, int WM, int MT, int BITS>
__device__ __forceinline__ void tiled_block(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    TO* __restrict__ out, int M, int N, int K, int gs, int m0, int n0) {
  constexpr int P = XPlanes<T>::n;
  constexpr int WN = 8 / WM;               // warps along N
  constexpr int NT = TL_BN / (WN * 8);     // n8 tiles per warp
  constexpr int BM = WM * MT * 16;         // rows of the block's tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* x_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* x_lo = x_hi + BM * TL_LD;  // used only when P == 2
  __nv_bfloat16* w_s = x_hi + P * BM * TL_LD;
  float* xsum = reinterpret_cast<float*>(w_s + TL_BN * TL_LD);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int warp_m = warp / WN;
  const int warp_n = warp % WN;

  // Staging: each thread stages one 32-element half row of the weight tile and, when its row
  // is below BM, of the x tile. For the 128-row tile every thread's row is, and that is known
  // at compile time: a runtime branch there splits the staging and cost 15 % at M = 4096.
  const int srow = tid >> 1;
  const int shalf = tid & 1;
  const bool x_stager = 2 * BM >= TL_THREADS || srow < BM;
  const bool x_valid = x_stager && m0 + srow < M;
  const T* x_src = x + (size_t)(x_valid ? m0 + srow : 0) * K + shalf * 32;
  const uint8_t* w_src = packed + (size_t)(n0 + srow) * row_bytes<BITS>(K) + shalf * 4 * BITS;
  const int xrow = x_stager ? srow : 0;
  __nv_bfloat16* x_hi_dst = x_hi + xrow * TL_LD + shalf * 32;
  __nv_bfloat16* x_lo_dst = x_lo + xrow * TL_LD + shalf * 32;
  __nv_bfloat16* w_dst = w_s + srow * TL_LD + shalf * 32;

  float acc[MT][NT][4];
  float y[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] = 0.f;
        y[mt][nt][i] = 0.f;
      }
  float gsum = 0.f;  // this thread's row: sum of x over the current group so far

  const int ktiles = K / TL_BK;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int kbase = kt * TL_BK;
    const bool group_end = (kbase + TL_BK) % gs == 0;
    float part = 0.f;
    if (x_stager) part = stage_x32(x_src + kbase, x_valid, x_hi_dst, x_lo_dst);
    stage_w32<BITS>(w_src + (size_t)kbase * BITS / 8, w_dst);
    part += __shfl_xor_sync(0xffffffffu, part, 1);  // the other half of the row
    gsum += part;
    if (group_end) {
      if (x_stager && shalf == 0) xsum[srow] = gsum;
      gsum = 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < TL_BK; ks += 16) {
      uint32_t a[MT][4];
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* p = w_s + (warp_n * NT * 8 + nt * 8 + gid) * TL_LD + ks + tig * 2;
        b[nt][0] = ld32(p);
        b[nt][1] = ld32(p + 8);
      }
      load_a<MT>(x_hi, warp_m * MT * 16, ks, gid, tig, a);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      if constexpr (P == 2) {
        load_a<MT>(x_lo, warp_m * MT * 16, ks, gid, tig, a);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
    }

    if (group_end) {
      const size_t g = (size_t)(kbase / gs);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + warp_n * NT * 8 + nt * 8 + tig * 2;
        const float s0 = __ldg(scale_t + g * N + col);
        const float s1 = __ldg(scale_t + g * N + col + 1);
        const float z0 = __ldg(shift_t + g * N + col);
        const float z1 = __ldg(shift_t + g * N + col + 1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = warp_m * MT * 16 + mt * 16 + gid;
          const float x0 = xsum[r];
          const float x1 = xsum[r + 8];
          float* c = acc[mt][nt];
          y[mt][nt][0] += c[0] * s0 - x0 * z0;
          y[mt][nt][1] += c[1] * s1 - x0 * z1;
          y[mt][nt][2] += c[2] * s0 - x1 * z0;
          y[mt][nt][3] += c[3] * s1 - x1 * z1;
          c[0] = c[1] = c[2] = c[3] = 0.f;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = m0 + warp_m * MT * 16 + mt * 16 + gid;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + warp_n * NT * 8 + nt * 8 + tig * 2;
      if (r < M) store2(out + (size_t)r * N + col, y[mt][nt][0], y[mt][nt][1]);
      if (r + 8 < M) store2(out + (size_t)(r + 8) * N + col, y[mt][nt][2], y[mt][nt][3]);
    }
  }
}

}  // namespace qbits
