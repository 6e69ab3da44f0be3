// Fused int4/int2 group-wise dequant matmuls for Hopper (sm_90a).
//
//   y[M, N] = x[M, K] @ deq(W)^T,   deq(W)[n, k] = s[g, n] * c[n, k] - z[g, n],   g = k / gs,
//
// computed group-factored as  y = sum_g s_g * (x_g . c_g) - (sum_k x_gk) * z_g  with float32
// sums, then cast to x's dtype (bfloat16 or float32). Every kernel takes int4 or int2 codes (an
// instantiation each, chosen by the entry point's `bits`).
//
// W4A8 and W2A8 (int8 x, per-tensor scale sx): the same factoring with integer sums inside each
// group,
//
//   y = sx * sum_g [ s_g * (xq_g . c_g) - z_g * (sum_k xq_gk) ],
//
// exact in int32 within a group (|xq| <= 128, c <= 15 or 3), the epilogue in float32, then cast
// to the weight's float dtype (bfloat16 or float32); sx is read from device memory.
//
// Requant route (approximate; weights requantized to per-channel int8 codes c8 with step s8):
//
//   y = sx * s8 * (xq . c8)   with one int32 sum over the whole K.
//
// This file holds the kernels for M > 512 and the requant route; the two small-M kernels (M <= 512)
// are in qbits_mm_small_m.cu. The weight layout and the tiled body are in qbits_mm.cuh.
//
// Entry points have a plain C interface (bound with ctypes in ops/cuda/qbits_mm.py). They launch
// on the stream they are given, allocate nothing, and return cudaGetLastError().

#include "qbits_mm.cuh"

namespace {

using namespace qbits;

// ---------------------------------------------------------------------------------------------
// qbits_mm_tiled (M > 512).
//
// Replaces quanto_tpu/ops/pallas/qbits_mm.py:_prefill_kernel, the TPU prefill kernel. The body,
// tiled_block in qbits_mm.cuh, says what bounds it and how it is built; here its 128 x 128 tile.
// ---------------------------------------------------------------------------------------------
template <typename T, int BITS>
__global__ void __launch_bounds__(TL_THREADS, 1) qbits_mm_tiled_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    T* __restrict__ out, int M, int N, int K, int gs) {
  tiled_block<T, T, 2, TL_MT, BITS>(x, packed, scale_t, shift_t, out, M, N, K, gs,
                                    blockIdx.y * TL_BM, blockIdx.x * TL_BN);
}

// ---------------------------------------------------------------------------------------------
// qbits_mm_tiled_int8 (W4A8 and W2A8, M > 512).
//
// Replaces the integer arm of quanto_tpu/ops/pallas/qbits_mm.py:_prefill_kernel (int8 x
// against int4 or int2 codes on the TPU's integer matrix unit). Bound on this card by operations
// at prompt lengths. Design: qbits_mm_tiled's, with mma.sync m16n8k32 s8 x s8 -> s32. Each K step
// stages the int8 x tile as it is and the weight tile as one int8 code per byte (exact, codes_s8:
// for int2 each packed byte's four crumbs become one word of four codes), so no bf16 split is
// needed; the int32 accumulator is exact within a group, and at each group's end the epilogue
// y += s_g * acc - z_g * sum(xq_g) runs in float32 registers, with sum(xq_g) summed as int32 by
// the staging threads (__dp4a against 0x01010101). The result is multiplied by sx. An int2 K
// step keeps its 64 codes and stages 8 packed bytes a thread instead of 16, so the tiles, the
// mma loop and the epilogue are the int4 arm's. No wgmma, TMA or pipelining yet: right and
// simple first.
// ---------------------------------------------------------------------------------------------
constexpr int TI_LD = TL_BK + 16;  // padded shared-memory row, in bytes: no bank conflicts

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One staged K step (TL_BK int8 columns of the x tile x_s [TL_BM][TI_LD] and the weight tile
// w_s [TL_BN][TI_LD]) of a warp's 64 x 32 output tile: mma.sync m16n8k32 into int32 acc.
__device__ __forceinline__ void mma_k_step_s8(const int8_t* x_s, const int8_t* w_s, int warp_m,
                                              int warp_n, int gid, int tig,
                                              int (&acc)[TL_MT][TL_NT][4]) {
#pragma unroll
  for (int ks = 0; ks < TL_BK; ks += 32) {
    uint32_t a[TL_MT][4];
    uint32_t b[TL_NT][2];
#pragma unroll
    for (int nt = 0; nt < TL_NT; ++nt) {
      const int8_t* p = w_s + (warp_n * 32 + nt * 8 + gid) * TI_LD + ks + tig * 4;
      b[nt][0] = ld32(p);
      b[nt][1] = ld32(p + 16);
    }
#pragma unroll
    for (int mt = 0; mt < TL_MT; ++mt) {
      const int8_t* p = x_s + (warp_m * 64 + mt * 16 + gid) * TI_LD + ks + tig * 4;
      a[mt][0] = ld32(p);
      a[mt][1] = ld32(p + 8 * TI_LD);
      a[mt][2] = ld32(p + 16);
      a[mt][3] = ld32(p + 8 * TI_LD + 16);
    }
#pragma unroll
    for (int mt = 0; mt < TL_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < TL_NT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
  }
}

template <typename TO, int BITS>
__global__ void __launch_bounds__(TL_THREADS, 1) qbits_mm_tiled_int8_kernel(
    const int8_t* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    const float* __restrict__ sx, TO* __restrict__ out, int M, int N, int K, int gs) {
  __shared__ __align__(16) int8_t x_s[TL_BM * TI_LD];
  __shared__ __align__(16) int8_t w_s[TL_BN * TI_LD];
  __shared__ int xsum[TL_BM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int warp_m = warp >> 2;  // 2 x 4 warps, each a 64 x 32 tile
  const int warp_n = warp & 3;
  const int m0 = blockIdx.y * TL_BM;
  const int n0 = blockIdx.x * TL_BN;

  // Staging: each thread stages one 32-element half row of the x tile and of the weight tile.
  const int srow = tid >> 1;
  const int shalf = tid & 1;
  const bool x_valid = m0 + srow < M;
  const int8_t* x_src = x + (size_t)(x_valid ? m0 + srow : 0) * K + shalf * 32;
  const uint8_t* w_src = packed + (size_t)(n0 + srow) * row_bytes<BITS>(K) + shalf * 4 * BITS;
  int8_t* x_dst = x_s + srow * TI_LD + shalf * 32;
  int8_t* w_dst = w_s + srow * TI_LD + shalf * 32;

  int acc[TL_MT][TL_NT][4];
  float y[TL_MT][TL_NT][4];
#pragma unroll
  for (int mt = 0; mt < TL_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL_NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] = 0;
        y[mt][nt][i] = 0.f;
      }
  int gsum = 0;  // this thread's row: sum of xq over the current group so far

  const int ktiles = K / TL_BK;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int kbase = kt * TL_BK;
    const bool group_end = (kbase + TL_BK) % gs == 0;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4 xa = x_valid ? __ldg(reinterpret_cast<const uint4*>(x_src + kbase)) : zero;
    const uint4 xb = x_valid ? __ldg(reinterpret_cast<const uint4*>(x_src + kbase) + 1) : zero;
    reinterpret_cast<uint4*>(x_dst)[0] = xa;
    reinterpret_cast<uint4*>(x_dst)[1] = xb;
    const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    int part = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) part = __dp4a((int)xw[i], 0x01010101, part);
    // 4 * BITS packed bytes -> 32 codes, one per byte, in K order.
    uint32_t pw[BITS];
    load_run<BITS>(w_src + (size_t)kbase * BITS / 8, pw);
    uint32_t cw[8];
    codes_s8<BITS>(pw, cw);
    reinterpret_cast<uint4*>(w_dst)[0] = make_uint4(cw[0], cw[1], cw[2], cw[3]);
    reinterpret_cast<uint4*>(w_dst)[1] = make_uint4(cw[4], cw[5], cw[6], cw[7]);
    part += __shfl_xor_sync(0xffffffffu, part, 1);  // the other half of the row
    gsum += part;
    if (group_end) {
      if (shalf == 0) xsum[srow] = gsum;
      gsum = 0;
    }
    __syncthreads();

    mma_k_step_s8(x_s, w_s, warp_m, warp_n, gid, tig, acc);

    if (group_end) {
      const size_t g = (size_t)(kbase / gs);
#pragma unroll
      for (int nt = 0; nt < TL_NT; ++nt) {
        const int col = n0 + warp_n * 32 + nt * 8 + tig * 2;
        const float s0 = __ldg(scale_t + g * N + col);
        const float s1 = __ldg(scale_t + g * N + col + 1);
        const float z0 = __ldg(shift_t + g * N + col);
        const float z1 = __ldg(shift_t + g * N + col + 1);
#pragma unroll
        for (int mt = 0; mt < TL_MT; ++mt) {
          const int r = warp_m * 64 + mt * 16 + gid;
          const float x0 = (float)xsum[r];
          const float x1 = (float)xsum[r + 8];
          int* c = acc[mt][nt];
          y[mt][nt][0] += (float)c[0] * s0 - x0 * z0;
          y[mt][nt][1] += (float)c[1] * s1 - x0 * z1;
          y[mt][nt][2] += (float)c[2] * s0 - x1 * z0;
          y[mt][nt][3] += (float)c[3] * s1 - x1 * z1;
          c[0] = c[1] = c[2] = c[3] = 0;
        }
      }
    }
    __syncthreads();
  }

  const float sxv = __ldg(sx);
#pragma unroll
  for (int mt = 0; mt < TL_MT; ++mt) {
    const int r = m0 + warp_m * 64 + mt * 16 + gid;
#pragma unroll
    for (int nt = 0; nt < TL_NT; ++nt) {
      const int col = n0 + warp_n * 32 + nt * 8 + tig * 2;
      if (r < M) store2(out + (size_t)r * N + col, y[mt][nt][0] * sxv, y[mt][nt][1] * sxv);
      if (r + 8 < M)
        store2(out + (size_t)(r + 8) * N + col, y[mt][nt][2] * sxv, y[mt][nt][3] * sxv);
    }
  }
}

// ---------------------------------------------------------------------------------------------
// qbits_mm_requant_int8 (W4A8 requant route: M >= 2048, weights in the requant form).
//
// Replaces quanto_tpu/ops/pallas/qbits_mm.py:_int8pc_kernel, the TPU's W4A8 prefill with
// per-channel int8 requantization inside the kernel. It computes
//
//   y[m, n] = sx * s8[n] * sum_k xq[m, k] * c8[n, k],
//   c8[n, k] = clip(rint(c[n, k] * rs - rz), -127, 127),   rs = s[g, n] / s8[n],  rz = z[g, n] / s8[n],
//
// with one int32 sum over the whole K (|sum| <= 128 * 127 * K < 2^31 for K < 132000) and no
// per-group epilogue: on the TPU that is the route's point, since the exact kernel's per-group
// float rescale keeps its int8 dots one group long. Bound on this card by operations: 2 M N K
// int8 operations at 1979 TOP/s, 243 us at M = 4096, N = 14336, K = 4096.
//
// Design: qbits_mm_tiled_int8's 128 x 128 tile, 8 warps of 64 x 32 and mma.sync m16n8k32 s8.
// Each K step stages the x tile as it is and requantizes the weight tile to int8 codes as it
// stages it (each thread: 32 codes of one row, all in one group since 128 | gs). rs and rz are
// computed in the kernel by IEEE division (__fdiv_rn) once per group from the float32 [G, N]
// scale and shift and s8 [N], so no [G, N] copy of them is stored (about 9 % of the 8B model's
// weight bytes). The requant uses __fmul_rn and __fsub_rn, which nvcc does not contract into an
// fma (one rounding in place of two would move a code at a rounding tie), and rintf (half to
// even, as jnp.round). Codes and the int32 sum are exact and the epilogue is the plain version's
// two float32 multiplies in its order, so the output equals the plain version bit for bit.
// int2 (W2A8): the same with s8 from qmax = 3; an int2 K step stages 8 packed bytes a thread,
// and each byte's four crumbs are requantized into one word of four int8 codes.
// Each block requantizes its weight tiles again, as each TPU grid row does; requantizing once
// per N tile, wgmma and TMA are later work.
// ---------------------------------------------------------------------------------------------
__device__ __forceinline__ uint32_t requant8(uint32_t c, float rs, float rz) {
  const float v = rintf(__fsub_rn(__fmul_rn(code_to_float(c), rs), rz));
  return (uint32_t)__float2int_rn(fminf(fmaxf(v, -127.f), 127.f)) & 0xFFu;
}

template <typename TO, int BITS>
__global__ void __launch_bounds__(TL_THREADS, 1) qbits_mm_requant_int8_kernel(
    const int8_t* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    const float* __restrict__ s8, const float* __restrict__ sx, TO* __restrict__ out, int M,
    int N, int K, int gs) {
  __shared__ __align__(16) int8_t x_s[TL_BM * TI_LD];
  __shared__ __align__(16) int8_t w_s[TL_BN * TI_LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int warp_m = warp >> 2;  // 2 x 4 warps, each a 64 x 32 tile
  const int warp_n = warp & 3;
  const int m0 = blockIdx.y * TL_BM;
  const int n0 = blockIdx.x * TL_BN;

  // Staging: each thread stages one 32-element half row of the x tile and of the weight tile.
  const int srow = tid >> 1;
  const int shalf = tid & 1;
  const bool x_valid = m0 + srow < M;
  const int8_t* x_src = x + (size_t)(x_valid ? m0 + srow : 0) * K + shalf * 32;
  const uint8_t* w_src = packed + (size_t)(n0 + srow) * row_bytes<BITS>(K) + shalf * 4 * BITS;
  int8_t* x_dst = x_s + srow * TI_LD + shalf * 32;
  int8_t* w_dst = w_s + srow * TI_LD + shalf * 32;
  const float s8_row = __ldg(s8 + n0 + srow);
  float rs = 0.f, rz = 0.f;

  int acc[TL_MT][TL_NT][4];
#pragma unroll
  for (int mt = 0; mt < TL_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL_NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const int ktiles = K / TL_BK;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int kbase = kt * TL_BK;
    if (kbase % gs == 0) {  // a new group: its factors for this thread's weight row
      const size_t g = (size_t)(kbase / gs);
      rs = __fdiv_rn(__ldg(scale_t + g * N + n0 + srow), s8_row);
      rz = __fdiv_rn(__ldg(shift_t + g * N + n0 + srow), s8_row);
    }
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4* xp = reinterpret_cast<const uint4*>(x_src + kbase);
    reinterpret_cast<uint4*>(x_dst)[0] = x_valid ? __ldg(xp) : zero;
    reinterpret_cast<uint4*>(x_dst)[1] = x_valid ? __ldg(xp + 1) : zero;
    // 4 * BITS packed bytes -> 32 int8 codes, one per byte, in K order: code t of the run lies
    // at bit BITS * t (run_code).
    uint32_t pw[BITS];
    load_run<BITS>(w_src + (size_t)kbase * BITS / 8, pw);
    uint32_t cw[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)  // codes 4j .. 4j + 3
      cw[j] = requant8(run_code<BITS>(pw, 4 * j), rs, rz) |
              requant8(run_code<BITS>(pw, 4 * j + 1), rs, rz) << 8 |
              requant8(run_code<BITS>(pw, 4 * j + 2), rs, rz) << 16 |
              requant8(run_code<BITS>(pw, 4 * j + 3), rs, rz) << 24;
    reinterpret_cast<uint4*>(w_dst)[0] = make_uint4(cw[0], cw[1], cw[2], cw[3]);
    reinterpret_cast<uint4*>(w_dst)[1] = make_uint4(cw[4], cw[5], cw[6], cw[7]);
    __syncthreads();

    mma_k_step_s8(x_s, w_s, warp_m, warp_n, gid, tig, acc);
    __syncthreads();
  }

  // Epilogue: acc as float32 (round to nearest even), times s8[n], times sx.
  const float sxv = __ldg(sx);
#pragma unroll
  for (int nt = 0; nt < TL_NT; ++nt) {
    const int col = n0 + warp_n * 32 + nt * 8 + tig * 2;
    const float a0 = __ldg(s8 + col);
    const float a1 = __ldg(s8 + col + 1);
#pragma unroll
    for (int mt = 0; mt < TL_MT; ++mt) {
      const int r = m0 + warp_m * 64 + mt * 16 + gid;
      const int* c = acc[mt][nt];
      if (r < M)
        store2(out + (size_t)r * N + col, __fmul_rn(__fmul_rn(__int2float_rn(c[0]), a0), sxv),
               __fmul_rn(__fmul_rn(__int2float_rn(c[1]), a1), sxv));
      if (r + 8 < M)
        store2(out + (size_t)(r + 8) * N + col, __fmul_rn(__fmul_rn(__int2float_rn(c[2]), a0), sxv),
               __fmul_rn(__fmul_rn(__int2float_rn(c[3]), a1), sxv));
    }
  }
}

template <typename T, int BITS>
int launch_tiled(const void* x, const void* packed, const void* scale_t, const void* shift_t,
                 void* out, int M, int N, int K, int gs, cudaStream_t stream) {
  constexpr size_t smem = tiled_smem_bytes<T>();
  const cudaError_t e = cudaFuncSetAttribute(
      qbits_mm_tiled_kernel<T, BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / TL_BN, (M + TL_BM - 1) / TL_BM);
  qbits_mm_tiled_kernel<T, BITS><<<grid, TL_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale_t), static_cast<const float*>(shift_t),
      static_cast<T*>(out), M, N, K, gs);
  return (int)cudaGetLastError();
}

template <typename TO, int BITS>
int launch_tiled_int8(const void* x, const void* packed, const void* scale_t, const void* shift_t,
                      const void* sx, void* out, int M, int N, int K, int gs, cudaStream_t stream) {
  const dim3 grid(N / TL_BN, (M + TL_BM - 1) / TL_BM);
  qbits_mm_tiled_int8_kernel<TO, BITS><<<grid, TL_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale_t), static_cast<const float*>(shift_t),
      static_cast<const float*>(sx), static_cast<TO*>(out), M, N, K, gs);
  return (int)cudaGetLastError();
}

template <typename TO, int BITS>
int launch_requant(const void* x, const void* packed, const void* scale_t, const void* shift_t,
                   const void* s8, const void* sx, void* out, int M, int N, int K, int gs,
                   cudaStream_t stream) {
  const dim3 grid(N / TL_BN, (M + TL_BM - 1) / TL_BM);
  qbits_mm_requant_int8_kernel<TO, BITS><<<grid, TL_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale_t), static_cast<const float*>(shift_t),
      static_cast<const float*>(s8), static_cast<const float*>(sx), static_cast<TO*>(out), M, N,
      K, gs);
  return (int)cudaGetLastError();
}

}  // namespace

// The int8-x entry point (W4A8, W2A8): x int8 [M, K], sx float32 scalar on the device; bits 4 or 2
// (any other is refused with cudaErrorInvalidValue); out_bf16: 1 when out is bfloat16, 0 when it
// is float32.
extern "C" int qbits_mm_tiled_int8(int device, const void* x, const void* packed,
                                   const void* scale_t, const void* shift_t, const void* sx,
                                   void* out, int M, int N, int K, int gs, int bits, int out_bf16,
                                   void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return out_bf16
               ? launch_tiled_int8<__nv_bfloat16, 4>(x, packed, scale_t, shift_t, sx, out, M, N, K, gs, s)
               : launch_tiled_int8<float, 4>(x, packed, scale_t, shift_t, sx, out, M, N, K, gs, s);
  if (bits == 2)
    return out_bf16
               ? launch_tiled_int8<__nv_bfloat16, 2>(x, packed, scale_t, shift_t, sx, out, M, N, K, gs, s)
               : launch_tiled_int8<float, 2>(x, packed, scale_t, shift_t, sx, out, M, N, K, gs, s);
  return (int)cudaErrorInvalidValue;
}

// The requant route: x int8 [M, K], s8 float32 [N], sx float32 scalar, all on the device.
extern "C" int qbits_mm_requant_int8(int device, const void* x, const void* packed,
                                     const void* scale_t, const void* shift_t, const void* s8,
                                     const void* sx, void* out, int M, int N, int K, int gs,
                                     int bits, int out_bf16, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return out_bf16
               ? launch_requant<__nv_bfloat16, 4>(x, packed, scale_t, shift_t, s8, sx, out, M, N, K, gs, s)
               : launch_requant<float, 4>(x, packed, scale_t, shift_t, s8, sx, out, M, N, K, gs, s);
  if (bits == 2)
    return out_bf16
               ? launch_requant<__nv_bfloat16, 2>(x, packed, scale_t, shift_t, s8, sx, out, M, N, K, gs, s)
               : launch_requant<float, 2>(x, packed, scale_t, shift_t, s8, sx, out, M, N, K, gs, s);
  return (int)cudaErrorInvalidValue;
}

// The float-x entry point: bits 4 or 2 (the code width; any other is refused with
// cudaErrorInvalidValue); x_bf16: 1 when x and out are bfloat16, 0 when they are float32.
extern "C" int qbits_mm_tiled(int device, const void* x, const void* packed, const void* scale_t,
                              const void* shift_t, void* out, int M, int N, int K, int gs, int bits,
                              int x_bf16, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return x_bf16 ? launch_tiled<__nv_bfloat16, 4>(x, packed, scale_t, shift_t, out, M, N, K, gs, s)
                  : launch_tiled<float, 4>(x, packed, scale_t, shift_t, out, M, N, K, gs, s);
  if (bits == 2)
    return x_bf16 ? launch_tiled<__nv_bfloat16, 2>(x, packed, scale_t, shift_t, out, M, N, K, gs, s)
                  : launch_tiled<float, 2>(x, packed, scale_t, shift_t, out, M, N, K, gs, s);
  return (int)cudaErrorInvalidValue;
}
