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
#include "small_m_tc.cuh"

namespace {

using namespace qbits;

// Slot u's expert, or -1 when the slot is past the device count `nslots`.
__device__ __forceinline__ int slot_expert(const int* eids, const int* nslots, int u) {
  if (nslots != nullptr && u >= __ldg(nslots)) return -1;
  return eids != nullptr ? __ldg(eids + u) : u;
}

// ---------------------------------------------------------------------------------------------
// qbits_moe_small_m: decode-sized M (<= 512), grid (N / TC_BN, ceil(M / BM), U * splits).
//
// Replaces quanto_tpu/ops/pallas/moe_mm.py:_moe_sel_kernel (one row per slot), _moe_all_kernel
// (every expert over the same S rows) and _moe_uniq_kernel (the same over a table of experts), and,
// through qbits_moe_tiled at M <= 16, _moe_prefill_uniq_kernel at a decode step's down projection
// (each slot its own rows).
// Bound on this card by bytes at the decode shapes (each routed expert's payload read once for a
// few rows; the all form at S = 16 reads 8 experts' 235 MB of int4 codes for 16 rows, 81 us at
// 3.35 TB/s). Each block takes its slot and its split of K from blockIdx.z, its expert from the
// table, and runs the tensor-core body of qbits_mm_small_m (small_m_tc.cuh: out^T = deq(W) . x^T on
// wgmma, a cp.async ring, the codes unpacked once per block under the products) on that expert's
// weight and the slot's rows, so each code is read and unpacked once per M tile of up to 128 rows.
// Where the slots' blocks leave the card short, K is split and a second kernel sums the splits in
// a fixed order, as for one weight. The selective form gives each slot its own
// row (an 8-row M tile), so no slot computes rows it then throws away (the TPU kernel's padded
// diagonal, needed by Mosaic's sublane tiling, has no reason to exist here).
// ---------------------------------------------------------------------------------------------
template <typename T, int BITS, int BM, int STAGES, int SUB>
__global__ void __launch_bounds__(TC_THREADS, blocks_per_sm(BM)) qbits_moe_small_m_kernel(
    const T* __restrict__ x, long long x_slot_stride, const int* __restrict__ eids,
    const int* __restrict__ nslots, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t, float* __restrict__ out,
    float* __restrict__ ws, const void* __restrict__ xs_pre, int U, int M, int N, int K, int gs,
    int kt_per, int splits) {
  const int u = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int n0 = blockIdx.x * TC_BN;
  const int m0 = blockIdx.y * BM;
  out += (size_t)u * M * N;
  float* part = splits > 1 ? ws + ((size_t)split * U + u) * M * N : nullptr;
  const int e = slot_expert(eids, nslots, u);
  if (e < 0) {
    small_m_tc_zeros<float, BM>(out, part, M, N, n0, m0);
    return;
  }
  const size_t G = (size_t)(K / gs);
  // The first pass's stage sums: one set for rows the slots share, else the slot's own.
  const float* pre = static_cast<const float*>(xs_pre) + (x_slot_stride != 0 ? (size_t)u * M * (K / TC_BK) : 0);
  small_m_tc_block<T, float, BITS, BM, STAGES, SUB>(
      x + (size_t)u * x_slot_stride, packed + (size_t)e * N * row_bytes<BITS>(K), scale_t + (size_t)e * G * N,
      shift_t + (size_t)e * G * N, nullptr, out, part, pre, M, N, K, gs, kt_per, split, n0, m0);
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

// Rows of x each slot has of its own: 1 set when the slots share their rows (slot stride 0).
inline int x_slots(const Args& a) { return a.x_slot_stride != 0 ? a.U : 1; }

template <typename T, int BITS, int BM, int STAGES, int SUB = 1>
int launch_small_m_cfg(const Args& a, void* ws, int splits, int kt_per, cudaStream_t stream) {
  constexpr size_t smem = SmemPlan<T, BITS, BM, STAGES, SUB>::bytes;
  auto kernel = qbits_moe_small_m_kernel<T, BITS, BM, STAGES, SUB>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // The workspace: the first pass's stage sums [x_slots, M, K / 64], then the split partials
  // [splits, U, M, N].
  float* partials = static_cast<float*>(ws);
  float* sums = nullptr;
  if constexpr (x_sums<T>(BM)) {
    const int n = x_slots(a) * a.M * (a.K / TC_BK);
    sums = partials;
    partials += n;
    stage_sums_kernel<T, float><<<(n + 255) / 256, 256, 0, stream>>>(
        static_cast<const T*>(a.x), sums, x_slots(a), a.x_slot_stride, a.M, a.K);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.N / TC_BN, (a.M + BM - 1) / BM, a.U * splits);
  kernel<<<grid, TC_THREADS, smem, stream>>>(static_cast<const T*>(a.x), a.x_slot_stride, a.eids, a.nslots,
                                             a.packed, a.scale_t, a.shift_t, a.out, partials, sums, a.U, a.M,
                                             a.N, a.K, a.gs, kt_per, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long MN = (long long)a.U * a.M * a.N;
  splitk_sum_kernel<float><<<(unsigned)((MN / 4 + 255) / 256), 256, 0, stream>>>(partials, nullptr, a.out, MN,
                                                                                 splits);
  return (int)cudaGetLastError();
}

template <typename T, int BITS>
int launch_small_m(int device, const Args& a, void* ws, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  int splits = 1, kt_per = 1;
  const cudaError_t e = plan_splits(device, a.U, a.M, a.N, a.K, a.gs, f32, &splits, &kt_per);
  if (e != cudaSuccess) return (int)e;
  if ((splits > 1 || x_sums<T>(tile_m(a.M, f32))) && ws == nullptr) return (int)cudaErrorInvalidValue;
  switch (tile_m(a.M, f32)) {
    case 8: return launch_small_m_cfg<T, BITS, 8, 6>(a, ws, splits, kt_per, stream);
    case 16: return launch_small_m_cfg<T, BITS, 16, 6>(a, ws, splits, kt_per, stream);
    case 32: return launch_small_m_cfg<T, BITS, 32, 5>(a, ws, splits, kt_per, stream);
    case 64: return launch_small_m_cfg<T, BITS, 64, 4>(a, ws, splits, kt_per, stream);
    default:
      if constexpr (f32) return (int)cudaErrorInvalidValue;  // tile_m keeps float32 x at 64
      else if (sub_stages(a.M, a.gs, f32) == 2) return launch_small_m_cfg<T, BITS, 128, 3, 2>(a, ws, splits, kt_per, stream);
      else return launch_small_m_cfg<T, BITS, 128, 4>(a, ws, splits, kt_per, stream);
  }
}

Args make_args(const void* x, long long x_slot_stride, const void* eids, const void* nslots,
               const void* packed, const void* scale_t, const void* shift_t, void* out, int U,
               int M, int N, int K, int gs) {
  return Args{x, x_slot_stride, static_cast<const int*>(eids), static_cast<const int*>(nslots),
              static_cast<const uint8_t*>(packed), static_cast<const float*>(scale_t),
              static_cast<const float*>(shift_t), static_cast<float*>(out), U, M, N, K, gs};
}

}  // namespace

// 4-byte elements of the workspace qbits_moe_small_m takes for these shapes on `device` (0: none):
// the first pass's stage sums of x (bf16 x at M > 32; one set when the slots share their rows,
// shared_rows = 1, else one a slot), then the split partials [splits, U, M, N] where K is split;
// x_f32: 1 for float32 x, 0 for bfloat16.
extern "C" int qbits_moe_small_m_workspace(int device, int U, int M, int N, int K, int gs, int x_f32,
                                           int shared_rows, long long* floats) {
  const int xs = shared_rows ? 1 : U;
  return (int)(x_f32 ? small_m_tc_workspace<float>(device, U, xs, M, N, K, gs, floats)
                     : small_m_tc_workspace<__nv_bfloat16>(device, U, xs, M, N, K, gs, floats));
}

// x [U, M, K] at slot stride `x_slot_stride` (elements); eids int32 [U] or NULL (slot u ->
// expert u); nslots int32 scalar or NULL (every slot); out float32 [U, M, N]; ws float32, of
// qbits_moe_small_m_workspace's size (NULL when 0); bits: 4 or 2, the code width (any other is
// refused with cudaErrorInvalidValue); x_bf16: 1 when x is bfloat16, 0 when it is float32.
extern "C" int qbits_moe_small_m(int device, const void* x, long long x_slot_stride,
                                 const void* eids, const void* nslots, const void* packed,
                                 const void* scale_t, const void* shift_t, void* out, void* ws, int U,
                                 int M, int N, int K, int gs, int bits, int x_bf16, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Args a = make_args(x, x_slot_stride, eids, nslots, packed, scale_t, shift_t, out, U, M, N,
                           K, gs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return x_bf16 ? launch_small_m<__nv_bfloat16, 4>(device, a, ws, s) : launch_small_m<float, 4>(device, a, ws, s);
  if (bits == 2)
    return x_bf16 ? launch_small_m<__nv_bfloat16, 2>(device, a, ws, s) : launch_small_m<float, 2>(device, a, ws, s);
  return (int)cudaErrorInvalidValue;
}

// The batched-expert GEMM at M > 16 (moe_gemm.cu); ws as there.
extern "C" int qbits_moe_gemm(int device, const void* x, long long x_slot_stride, const void* eids,
                              const void* nslots, const void* packed, const void* scale_t,
                              const void* shift_t, void* out, void* ws, int E, int U, int M, int N,
                              int K, int gs, int bits, int x_bf16, void* stream);

// qbits_moe_tiled: slot u . deq(W[e_u])^T over slabs of M rows, as qbits_moe_small_m, with E the
// experts of the stacked weight. At M > 16 the batched-expert GEMM of moe_gemm.cu (TPU #14), ws its
// workspace (float32 x: bf16 [2, U', M, K], U' = 1 for shared rows; else NULL). At M <= 16, where
// the main path runs it for a decode step's down projection (TPU #15, _moe_prefill_uniq_kernel:
// each slot its own rows of h, a routed-first table, a device count), qbits_moe_small_m's
// tensor-core body per slot, ws of qbits_moe_small_m_workspace's size (shared_rows as the slot
// stride says).
extern "C" int qbits_moe_tiled(int device, const void* x, long long x_slot_stride,
                               const void* eids, const void* nslots, const void* packed,
                               const void* scale_t, const void* shift_t, void* out, void* ws, int E,
                               int U, int M, int N, int K, int gs, int bits, int x_bf16,
                               void* stream) {
  if (M > 16)
    return qbits_moe_gemm(device, x, x_slot_stride, eids, nslots, packed, scale_t, shift_t, out, ws,
                          E, U, M, N, K, gs, bits, x_bf16, stream);
  return qbits_moe_small_m(device, x, x_slot_stride, eids, nslots, packed, scale_t, shift_t, out, ws, U, M,
                           N, K, gs, bits, x_bf16, stream);
}
