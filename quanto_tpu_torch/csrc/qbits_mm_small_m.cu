// The two small-M group-wise dequant matmuls (M <= 512) for Hopper (sm_90a), on the tensor cores:
//
//   qbits_mm_small_m       y[M, N] = x[M, K] @ deq(W)^T, x bfloat16 or float32, y in x's dtype;
//   qbits_mm_int8_small_m  y[M, N] = sx * (xq[M, K] @ deq(W)^T), xq int8, y bfloat16 or float32,
//
// deq(W)[n, k] = s[g, n] * c[n, k] - z[g, n] (g = k / gs), computed group-factored as the TPU
// kernels compute it, y = sum_g s_g * (x_g . c_g) - z_g * sum_k x_gk, with each group's x_g . c_g
// summed by the tensor cores in float32 (bf16 x, and a float32 x split into a bf16 high and low
// plane) or in int32 (int8 x, exact), and the epilogue in float32. int4 or int2 codes, in the
// Hopper layout of qbits_mm.cuh.
//
// Replaces quanto_tpu/ops/pallas/qbits_mm.py:_kernel (TPU kernel #1) and :_int8_kernel (#4).
// Those keep all M rows of x in VMEM and stream each weight strip through the matrix unit once.
//
// Bound on this card: by bytes at decode (M = 4: 29 MB of int4 weight at 14336 x 4096, 8.8 us at
// 3.35 TB/s), by operations from M of a few hundred (M = 512: 60 GFLOP, 61 us at the bf16 rate,
// 30 us at the int8 rate). The parent design did float32 FMAs (or __dp4a) on the CUDA cores for
// 4 or 8 rows of x at a time, so it read and unpacked every weight byte M / 4 or M / 8 times.
//
// Design (the body is small_m_tc.cuh:small_m_tc_block, which moe_mm.cu's qbits_moe_small_m runs
// per slot of a stacked expert weight): each block computes the output tile transposed, out^T[BN, BM] = deq(W)[BN, K] . x^T,
// so the weight rows fill the 64-row side of wgmma (m64nBMk16 bf16 -> f32, or m64nBMk32 s8 -> s32;
// two warpgroups, 64 weight rows each) and the M rows of x its narrow N side. The entry point
// picks BM from M (8, 16, 32, 64 or 128; at most 64 for float32 x, whose two planes need the
// room); BN = 128 weight rows. A block walks its K range in stages of 64 codes (128 at BM = 128
// where a group holds whole stages: half the barriers, copy issues and folds per code) through a
// ring of STAGES stages in shared memory fed by cp.async, 16 bytes a thread, neighbours along a
// row: the packed weight bytes of the stage and the x tile (rows past M zero-filled), x already in
// wgmma's swizzled K-major layout (128-byte for bf16, 64-byte for s8: coalesced copies, stores on
// distinct banks). One __syncthreads a stage. Each iteration starts the asynchronous products of
// stage i and, while the tensor cores run them, transforms stage i + 1: every thread unpacks one
// run of 32 codes per 64 into the stage's swizzled operand tile (int4 and int2 codes to exact bf16
// by lop3/prmt into the mantissa of 128, then minus 128; or to s8, one code a byte),
// double-buffered, so each weight byte is read once per block and unpacked once per M tile. The
// zero-point term needs the sums of x over each group: up to BM = 32 the transform sums the staged
// x (float32, or int32 by __dp4a); from BM = 64, where every N tile would sum the same M tile
// again, a first pass sums each 64 values of x once per call and the transform loads one sum a
// row. For float32 x the transform also writes x's bf16 high and low planes. At a group's last
// stage each thread folds its accumulators into y in registers, y += s_g[n] * acc -
// z_g[n] * sum(x_g)[m], with s_g and z_g loaded a group ahead; the group sums of x were written a
// stage ahead, so the fold waits on no barrier, and the next group's first product overwrites the
// accumulators. Per 64 codes a thread spends about 70 instructions unpacking and 30 copying, with
// 8 to 24 warps an SM, so on the H100 the unpacking and the barrier a stage, not the tensor cores
// or the bytes, hold the kernel at every M, at 4 to 5 times its bound (PERF.md, phase 3's sweep).
//
// Where N / BN * ceil(M / BM) blocks would leave the 132 SMs short, the K range is split over
// gridDim.z: each split writes its float32 partial tile to a workspace the wrapper allocates
// (qbits_mm_small_m_workspace gives its size) and a second kernel sums the splits in a fixed
// order, so the output is the same from run to run (no atomics).
//
// Entry points have a plain C interface (bound with ctypes in ops/cuda/qbits_mm.py). They launch
// on the stream they are given, allocate nothing, and return cudaGetLastError().

#include "small_m_tc.cuh"

namespace {

// One block of the one-weight kernels: blockIdx.x the 128 weight rows, blockIdx.y the M tile,
// blockIdx.z the split of K; ws: the split partials [gridDim.z, M, N] when gridDim.z > 1.
template <typename T, typename TO, int BITS, int BM, int STAGES, int SUB>
__global__ void __launch_bounds__(TC_THREADS, blocks_per_sm(BM)) small_m_tc_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    const float* __restrict__ sx, TO* __restrict__ out, float* __restrict__ ws,
    const void* __restrict__ xs_pre, int M, int N, int K, int gs, int kt_per) {
  float* part = gridDim.z > 1 ? ws + (size_t)blockIdx.z * M * N : nullptr;
  small_m_tc_block<T, TO, BITS, BM, STAGES, SUB>(x, packed, scale_t, shift_t, sx, out, part, xs_pre, M, N, K,
                                                 gs, kt_per, blockIdx.z, blockIdx.x * TC_BN, blockIdx.y * BM);
}

template <typename T, typename TO, int BITS, int BM, int STAGES, int SUB = 1>
cudaError_t launch_cfg(const void* x, const void* packed, const void* scale_t, const void* shift_t,
                       const void* sx, void* out, void* ws, int M, int N, int K, int gs, int splits,
                       int kt_per, cudaStream_t stream) {
  using Acc = typename XTraits<T>::Acc;
  constexpr size_t smem = SmemPlan<T, BITS, BM, STAGES, SUB>::bytes;
  auto kernel = small_m_tc_kernel<T, TO, BITS, BM, STAGES, SUB>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  // The workspace: the first pass's stage sums [M, K / 64], then the split partials [splits, M, N].
  float* partials = static_cast<float*>(ws);
  Acc* sums = nullptr;
  if constexpr (x_sums<T>(BM)) {
    const int n = M * (K / TC_BK);
    sums = static_cast<Acc*>(ws);
    partials += n;
    stage_sums_kernel<T, Acc><<<(n + 255) / 256, 256, 0, stream>>>(static_cast<const T*>(x), sums, 1, 0, M, K);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(N / TC_BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed), static_cast<const float*>(scale_t),
      static_cast<const float*>(shift_t), static_cast<const float*>(sx), static_cast<TO*>(out), partials,
      sums, M, N, K, gs, kt_per);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long MN = (long long)M * N;
  splitk_sum_kernel<TO><<<(unsigned)((MN / 4 + 255) / 256), 256, 0, stream>>>(
      partials, static_cast<const float*>(sx), static_cast<TO*>(out), MN, splits);
  return cudaGetLastError();
}

template <typename T, typename TO, int BITS>
int launch(int device, const void* x, const void* packed, const void* scale_t, const void* shift_t,
           const void* sx, void* out, void* ws, int M, int N, int K, int gs, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  int splits = 1, kt_per = 1;
  cudaError_t e = plan_splits(device, 1, M, N, K, gs, f32, &splits, &kt_per);
  if (e != cudaSuccess) return (int)e;
  if ((splits > 1 || x_sums<T>(tile_m(M, f32))) && ws == nullptr) return (int)cudaErrorInvalidValue;
  const auto run = [&](auto cfg) { return (int)cfg(x, packed, scale_t, shift_t, sx, out, ws, M, N, K, gs, splits, kt_per, stream); };
  switch (tile_m(M, f32)) {
    case 8: return run(launch_cfg<T, TO, BITS, 8, 6>);
    case 16: return run(launch_cfg<T, TO, BITS, 16, 6>);
    case 32: return run(launch_cfg<T, TO, BITS, 32, 5>);
    case 64: return run(launch_cfg<T, TO, BITS, 64, 4>);
    default:
      if constexpr (f32) return (int)cudaErrorInvalidValue;  // tile_m keeps float32 x at 64
      else if (sub_stages(M, gs, f32) == 2) return run(launch_cfg<T, TO, BITS, 128, 3, 2>);
      else return run(launch_cfg<T, TO, BITS, 128, 4>);
  }
}

}  // namespace

// 4-byte elements of the workspace the small-M entry points take for these shapes on `device`: the
// stage sums of x [M, K / 64] where the M tile takes them from a first pass (bf16 and int8 x at
// M > 32), then the split partials [splits, M, N] where K is split (0 when neither); x_f32: 1 for
// float32 x, 0 for bfloat16 or int8 x.
extern "C" int qbits_mm_small_m_workspace(int device, int M, int N, int K, int gs, int x_f32,
                                          long long* floats) {
  return (int)(x_f32 ? small_m_tc_workspace<float>(device, 1, 1, M, N, K, gs, floats)
                     : small_m_tc_workspace<__nv_bfloat16>(device, 1, 1, M, N, K, gs, floats));
}

// Float x: x and out bfloat16 (x_bf16 = 1) or float32 (0); bits 4 or 2 (any other is refused with
// cudaErrorInvalidValue); ws: float32, of qbits_mm_small_m_workspace's size (null when 0).
extern "C" int qbits_mm_small_m(int device, const void* x, const void* packed, const void* scale_t,
                                const void* shift_t, void* out, void* ws, int M, int N, int K,
                                int gs, int bits, int x_bf16, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return x_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, 4>(device, x, packed, scale_t, shift_t, nullptr, out, ws, M, N, K, gs, s)
                  : launch<float, float, 4>(device, x, packed, scale_t, shift_t, nullptr, out, ws, M, N, K, gs, s);
  if (bits == 2)
    return x_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, 2>(device, x, packed, scale_t, shift_t, nullptr, out, ws, M, N, K, gs, s)
                  : launch<float, float, 2>(device, x, packed, scale_t, shift_t, nullptr, out, ws, M, N, K, gs, s);
  return (int)cudaErrorInvalidValue;
}

// Int8 x (W4A8, W2A8): x int8 [M, K], sx float32 scalar on the device; out bfloat16 (out_bf16 = 1)
// or float32 (0); bits and ws as above.
extern "C" int qbits_mm_int8_small_m(int device, const void* x, const void* packed,
                                     const void* scale_t, const void* shift_t, const void* sx,
                                     void* out, void* ws, int M, int N, int K, int gs, int bits,
                                     int out_bf16, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return out_bf16 ? launch<int8_t, __nv_bfloat16, 4>(device, x, packed, scale_t, shift_t, sx, out, ws, M, N, K, gs, s)
                    : launch<int8_t, float, 4>(device, x, packed, scale_t, shift_t, sx, out, ws, M, N, K, gs, s);
  if (bits == 2)
    return out_bf16 ? launch<int8_t, __nv_bfloat16, 2>(device, x, packed, scale_t, shift_t, sx, out, ws, M, N, K, gs, s)
                    : launch<int8_t, float, 2>(device, x, packed, scale_t, shift_t, sx, out, ws, M, N, K, gs, s);
  return (int)cudaErrorInvalidValue;
}
