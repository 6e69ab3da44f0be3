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
// What is here: the code helpers (a code as a float, a run of 32 codes loaded and unpacked, as int8
// operands) and the small loads and stores the kernels share, templated on BITS where the width
// matters.

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

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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

}  // namespace qbits
