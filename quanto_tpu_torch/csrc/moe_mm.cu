// Stacked-expert int4/int2 matmuls for Hopper (sm_90a): the MoE kernels.
//
//   out[u, m, :] = x[u, m, :] @ deq(W[e_u])^T   in float32,   e_u = eids[u] (or u without a table),
//
// over a stacked weight: packed uint8 [E, N, K * bits / 8], scale_t and shift_t float32
// [E, G, N], each expert in the layout of qbits_mm.cuh, int4 or int2 codes (an instantiation
// each, chosen by the entry point's `bits`). x is bfloat16 or float32 [U, M, K] with contiguous rows
// and any slot stride: 0 when every slot sees the same rows (the all and uniq forms), K for one
// row per slot (the selective form), M * K for a slab per slot (the batched-expert GEMM). When
// `nslots` (a device int) is given, slots at or past it write zeros and read no weight, so a
// table of the routed experts needs no host step to say how many there are.
//
// The expert id is read by each block from device memory: the TPU kernels' scalar-prefetched
// index maps have no counterpart, and none is needed.
//
// Entry points have a plain C interface (bound with ctypes in ops/cuda/moe_mm.py). They launch
// on the stream they are given, allocate nothing, and return cudaGetLastError().

#include "qbits_mm.cuh"

namespace {

using namespace qbits;

// Slot u's expert, or -1 when the slot is past the device count `nslots`.
__device__ __forceinline__ int slot_expert(const int* eids, const int* nslots, int u) {
  if (nslots != nullptr && u >= __ldg(nslots)) return -1;
  return eids != nullptr ? __ldg(eids + u) : u;
}

// ---------------------------------------------------------------------------------------------
// qbits_moe_small_m: decode-sized M (<= 512), grid (N / SM_ROWS, ceil(M / SM_BM), U).
//
// Replaces quanto_tpu/ops/pallas/moe_mm.py:_moe_sel_kernel (one row per slot), _moe_all_kernel
// (every expert over the same S rows) and _moe_uniq_kernel (the same over a table of experts).
// Bound on this card by bytes, as qbits_mm_small_m: each routed expert's payload is read once per
// SM_BM rows. Each block takes its slot from blockIdx.z, its expert from the table, and runs the
// body of qbits_mm_small_m on that expert's weight. The selective form gives each slot its own
// row, so no slot computes rows it then throws away (the TPU kernel's padded diagonal, needed by
// Mosaic's sublane tiling, has no reason to exist here).
// ---------------------------------------------------------------------------------------------
template <typename T, int BITS>
__global__ void __launch_bounds__(SM_THREADS) qbits_moe_small_m_kernel(
    const T* __restrict__ x, long long x_slot_stride, const int* __restrict__ eids,
    const int* __restrict__ nslots, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    float* __restrict__ out, int M, int N, int K, int gs) {
  const int u = blockIdx.z;
  const int n0 = blockIdx.x * SM_ROWS;
  const int m0 = blockIdx.y * SM_BM;
  out += (size_t)u * M * N;
  const int e = slot_expert(eids, nslots, u);
  if (e < 0) {
    if (threadIdx.x < SM_ROWS * SM_BM) {
      const int r = threadIdx.x / SM_BM;
      const int m = threadIdx.x % SM_BM;
      if (m0 + m < M) out[(size_t)(m0 + m) * N + n0 + r] = 0.f;
    }
    return;
  }
  const size_t G = (size_t)(K / gs);
  small_m_block<T, float, BITS>(x + (size_t)u * x_slot_stride,
                                packed + (size_t)e * N * row_bytes<BITS>(K),
                                scale_t + (size_t)e * G * N, shift_t + (size_t)e * G * N, out, M,
                                N, K, gs, n0, m0);
}

// ---------------------------------------------------------------------------------------------
// qbits_moe_tiled at M <= 16, grid (N / TL_BN, ceil(M / 16), U); larger M runs the pipelined
// wgmma GEMM of moe_gemm.cu.
//
// Replaces quanto_tpu/ops/pallas/moe_mm.py:_moe_prefill_uniq_kernel (slot u -> expert eids[u]) at
// the down projection of a decode step, slabs of at most 16 rows. Bound on this card by bytes
// there (each routed expert's payload read once for a few rows). Each block takes its slot from
// blockIdx.z, its expert from the table, and runs the body of qbits_mm_tiled (qbits_mm.cuh:
// tiled_block) on that expert's weight and the slot's rows with a 16 x 128 tile.
// ---------------------------------------------------------------------------------------------
template <typename T, int WM, int MT, int BITS>
__global__ void __launch_bounds__(TL_THREADS, 1) qbits_moe_tiled_kernel(
    const T* __restrict__ x, long long x_slot_stride, const int* __restrict__ eids,
    const int* __restrict__ nslots, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    float* __restrict__ out, int M, int N, int K, int gs) {
  constexpr int BM = WM * MT * 16;
  const int u = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * TL_BN;
  out += (size_t)u * M * N;
  const int e = slot_expert(eids, nslots, u);
  if (e < 0) {
    for (int i = threadIdx.x; i < BM * TL_BN; i += TL_THREADS) {
      const int r = m0 + i / TL_BN;
      if (r < M) out[(size_t)r * N + n0 + i % TL_BN] = 0.f;
    }
    return;
  }
  const size_t G = (size_t)(K / gs);
  tiled_block<T, float, WM, MT, BITS>(x + (size_t)u * x_slot_stride,
                                      packed + (size_t)e * N * row_bytes<BITS>(K),
                                      scale_t + (size_t)e * G * N, shift_t + (size_t)e * G * N,
                                      out, M, N, K, gs, m0, n0);
}

struct Args {
  const void* x;
  long long x_slot_stride;
  const int* eids;
  const int* nslots;
  const uint8_t* packed;
  const float* scale_t;
  const float* shift_t;
  float* out;
  int U, M, N, K, gs;
};

template <typename T, int BITS>
int launch_small_m(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.N / SM_ROWS, (a.M + SM_BM - 1) / SM_BM, a.U);
  qbits_moe_small_m_kernel<T, BITS><<<grid, SM_THREADS, 0, stream>>>(
      static_cast<const T*>(a.x), a.x_slot_stride, a.eids, a.nslots, a.packed, a.scale_t,
      a.shift_t, a.out, a.M, a.N, a.K, a.gs);
  return (int)cudaGetLastError();
}

template <typename T, int WM, int MT, int BITS>
int launch_tiled(const Args& a, cudaStream_t stream) {
  constexpr int BM = WM * MT * 16;
  constexpr size_t smem = tiled_smem_bytes<T, BM>();
  const cudaError_t e = cudaFuncSetAttribute(qbits_moe_tiled_kernel<T, WM, MT, BITS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.N / TL_BN, (a.M + BM - 1) / BM, a.U);
  qbits_moe_tiled_kernel<T, WM, MT, BITS><<<grid, TL_THREADS, smem, stream>>>(
      static_cast<const T*>(a.x), a.x_slot_stride, a.eids, a.nslots, a.packed, a.scale_t,
      a.shift_t, a.out, a.M, a.N, a.K, a.gs);
  return (int)cudaGetLastError();
}


Args make_args(const void* x, long long x_slot_stride, const void* eids, const void* nslots,
               const void* packed, const void* scale_t, const void* shift_t, void* out, int U,
               int M, int N, int K, int gs) {
  return Args{x, x_slot_stride, static_cast<const int*>(eids), static_cast<const int*>(nslots),
              static_cast<const uint8_t*>(packed), static_cast<const float*>(scale_t),
              static_cast<const float*>(shift_t), static_cast<float*>(out), U, M, N, K, gs};
}

}  // namespace

// x [U, M, K] at slot stride `x_slot_stride` (elements); eids int32 [U] or NULL (slot u ->
// expert u); nslots int32 scalar or NULL (every slot); out float32 [U, M, N]; bits: 4 or 2, the
// code width (any other is refused with cudaErrorInvalidValue); x_bf16: 1 when x is bfloat16, 0
// when it is float32.
extern "C" int qbits_moe_small_m(int device, const void* x, long long x_slot_stride,
                                 const void* eids, const void* nslots, const void* packed,
                                 const void* scale_t, const void* shift_t, void* out, int U, int M,
                                 int N, int K, int gs, int bits, int x_bf16, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Args a = make_args(x, x_slot_stride, eids, nslots, packed, scale_t, shift_t, out, U, M, N,
                           K, gs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4) return x_bf16 ? launch_small_m<__nv_bfloat16, 4>(a, s) : launch_small_m<float, 4>(a, s);
  if (bits == 2) return x_bf16 ? launch_small_m<__nv_bfloat16, 2>(a, s) : launch_small_m<float, 2>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The batched-expert GEMM at M > 16 (moe_gemm.cu); ws as there.
extern "C" int qbits_moe_gemm(int device, const void* x, long long x_slot_stride, const void* eids,
                              const void* nslots, const void* packed, const void* scale_t,
                              const void* shift_t, void* out, void* ws, int E, int U, int M, int N,
                              int K, int gs, int bits, int x_bf16, void* stream);

// As qbits_moe_small_m, with E the experts of the stacked weight and ws the workspace of
// qbits_moe_gemm (float32 x at M > 16: bf16 [2, U', M, K], U' = 1 for shared rows; else NULL).
extern "C" int qbits_moe_tiled(int device, const void* x, long long x_slot_stride,
                               const void* eids, const void* nslots, const void* packed,
                               const void* scale_t, const void* shift_t, void* out, void* ws, int E,
                               int U, int M, int N, int K, int gs, int bits, int x_bf16,
                               void* stream) {
  if (M > 16)
    return qbits_moe_gemm(device, x, x_slot_stride, eids, nslots, packed, scale_t, shift_t, out, ws,
                          E, U, M, N, K, gs, bits, x_bf16, stream);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Args a = make_args(x, x_slot_stride, eids, nslots, packed, scale_t, shift_t, out, U, M, N,
                           K, gs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return x_bf16 ? launch_tiled<__nv_bfloat16, 1, 1, 4>(a, s) : launch_tiled<float, 1, 1, 4>(a, s);
  if (bits == 2)
    return x_bf16 ? launch_tiled<__nv_bfloat16, 1, 1, 2>(a, s) : launch_tiled<float, 1, 1, 2>(a, s);
  return (int)cudaErrorInvalidValue;
}
