// qbits_mm_requant_int8 for Hopper (sm_90a): the W4A8 / W2A8 requant route (M >= 2048, weights in
// the requant form).
//
// Replaces quanto_tpu/ops/pallas/qbits_mm.py:_int8pc_kernel (TPU kernel #3), the TPU's W4A8
// prefill with per-channel int8 requantization inside the kernel. It computes
//
//   y[m, n] = sx * s8[n] * sum_k xq[m, k] * c8[n, k],
//   c8[n, k] = clip(rint(c[n, k] * rs - rz), -127, 127),   rs = s[g, n] / s8[n],  rz = z[g, n] / s8[n],
//
// with one int32 sum over the whole K (|sum| <= 128 * 127 * K < 2^31 for K < 132000) and no
// per-group epilogue: on the TPU that is the route's point, since the exact kernel's per-group
// float rescale keeps its int8 dots one group long. int4 or int2 codes (c in [0, 15] or [0, 3]) in
// the Hopper layout of qbits_mm.cuh; bf16 or float32 output.
//
// Bound on this card by operations: 2 M N K int8 operations at 1979 TOP/s, 243 us at M = 4096,
// N = 14336, K = 4096 (the bytes, 17 MB of x, 29 MB of int4 weight and 117 MB of bf16 output, take
// 49 us).
//
// Design: two passes in one call, requantizing each weight code once per call.
// 1. requant_codes_kernel writes c8 int8 [N, K] into a workspace the wrapper allocates (N K bytes:
//    58.7 MB at 14336 x 4096, freed when the call returns; nothing is kept across calls, the
//    weight stays in its int4 / int2 form as in JAX). Each thread requantizes one run of 32 codes
//    of one row, all in one group (128 | gs): rs and rz by IEEE division (__fdiv_rn) from the
//    float32 [G, N] scale and shift and s8 [N], the codes by __fmul_rn and __fsub_rn, which nvcc
//    does not contract into an fma (one rounding in place of two would move a code at a rounding
//    tie), and rintf (half to even, as jnp.round). Bound by its bytes: 29 + 59 MB, ~26 us.
// 2. requant_gemm_kernel: y = (x . c8^T) * s8 * sx on the tensor cores, both operands K-major
//    int8, as wgmma's s8 form takes them. A block owns a 128 x BN output tile (BN = 256, or 128
//    where 256-wide tiles would leave SMs idle: phase 10's k/v projections, N = 1024 at M = 2048,
//    give 64 blocks of 128 x 256 for 132 SMs and 128 of 128 x 128) and walks all of K in stages of
//    128 codes through a ring of STAGES shared-memory stages (4 of 48 KB at BN = 256, 6 of 32 KB at
//    128). One producer thread keeps the ring full with TMA copies of the x and c8 tiles in the
//    128-byte swizzle (rows past M zero-filled by TMA); two consumer warpgroups, 64 rows of x each,
//    run wgmma m64nBNk32 s8 -> s32 on each stage as it arrives and release it one stage later,
//    when its products have read it. Tiles are ordered in groups of 8 M tiles (hopper_gemm.cuh:
//    tile_of) so that the blocks resident at once share their c8 and x tiles in L2. Codes and the
//    int32 sum are exact and the epilogue is the plain version's two float32 multiplies in its
//    order, (acc * s8) * sx, so the output equals the plain version bit for bit.
//
// Rejected: (b) one kernel that requantizes each weight tile in a cluster of CTAs along M and shares
// it through distributed shared memory; it bounds the requant count by M / (128 x cluster size)
// instead of 1 and puts the CUDA-core requant work beside the tensor-core work of every block, for a
// saving of the workspace's 88 MB of traffic (~26 us) out of a call of several hundred us.
//
// Entry points have a plain C interface (bound with ctypes in ops/cuda/qbits_mm.py). They launch
// on the stream they are given, allocate nothing, and return cudaGetLastError().

#include "hopper_gemm.cuh"
#include "qbits_mm.cuh"
#include "wgmma.cuh"

namespace {

using namespace hg;
using namespace qbits;

// ---------------------------------------------------------------------------------------------
// Pass 1: the requant codes.
// ---------------------------------------------------------------------------------------------
__device__ __forceinline__ uint32_t requant8(uint32_t c, float rs, float rz) {
  const float v = rintf(__fsub_rn(__fmul_rn(code_to_float(c), rs), rz));
  return (uint32_t)__float2int_rn(fminf(fmaxf(v, -127.f), 127.f)) & 0xFFu;
}

// One thread per run of 32 codes: c8[n, 32 c .. 32 c + 31], run index i = n * (K / 32) + c.
template <int BITS>
__global__ void __launch_bounds__(256) requant_codes_kernel(
    const uint8_t* __restrict__ packed, const float* __restrict__ scale_t,
    const float* __restrict__ shift_t, const float* __restrict__ s8, int8_t* __restrict__ c8, int N, int K,
    int gs) {
  const int runs = K / 32;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)N * runs) return;
  const int n = (int)(i / runs);
  const int k0 = (int)(i % runs) * 32;
  const size_t g = (size_t)(k0 / gs);
  const float s8n = __ldg(s8 + n);
  const float rs = __fdiv_rn(__ldg(scale_t + g * N + n), s8n);
  const float rz = __fdiv_rn(__ldg(shift_t + g * N + n), s8n);
  uint32_t pw[BITS];
  load_run<BITS>(packed + (size_t)n * row_bytes<BITS>(K) + (size_t)k0 * BITS / 8, pw);
  uint32_t cw[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)  // codes 4j .. 4j + 3
    cw[j] = requant8(run_code<BITS>(pw, 4 * j), rs, rz) | requant8(run_code<BITS>(pw, 4 * j + 1), rs, rz) << 8 |
            requant8(run_code<BITS>(pw, 4 * j + 2), rs, rz) << 16 |
            requant8(run_code<BITS>(pw, 4 * j + 3), rs, rz) << 24;
  uint4* dst = reinterpret_cast<uint4*>(c8 + (size_t)n * K + k0);
  dst[0] = make_uint4(cw[0], cw[1], cw[2], cw[3]);
  dst[1] = make_uint4(cw[4], cw[5], cw[6], cw[7]);
}

// ---------------------------------------------------------------------------------------------
// Pass 2: the s8 GEMM.
// ---------------------------------------------------------------------------------------------
constexpr int RQ_BM = 128;  // x rows of a block: two consumer warpgroups of 64
constexpr int RQ_BK = 128;  // codes (bytes) of a stage: one 128-byte swizzled row
constexpr int RQ_CONSUMERS = 256;
constexpr int RQ_THREADS = RQ_CONSUMERS + 128;  // + the producer's warpgroup (one thread works)

template <int BN, int STAGES>
struct RqPlan {
  static constexpr int a_bytes = RQ_BM * RQ_BK;
  static constexpr int stage = a_bytes + BN * RQ_BK;  // multiples of 1024: the swizzle's period
  static constexpr int bars = STAGES * stage;
  static constexpr int bytes = bars + 2 * STAGES * 8 + 1024;  // + the barriers, + 1024 to align the base
};

template <typename TO, int BN, int STAGES>
__global__ void __launch_bounds__(RQ_THREADS, 1) requant_gemm_kernel(
    __grid_constant__ const CUtensorMap xmap, __grid_constant__ const CUtensorMap cmap,
    const float* __restrict__ s8, const float* __restrict__ sx, TO* __restrict__ out, int M, int N, int K) {
  using Plan = RqPlan<BN, STAGES>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Plan::bars);  // the stage's copies arrived
  uint64_t* empty = full + STAGES;                                   // its products have read it
  int tm, tn;
  tile_of(blockIdx.x, (M + RQ_BM - 1) / RQ_BM, N / BN, tm, tn);
  const int m0 = tm * RQ_BM, n0 = tn * BN;
  const int nst = K / RQ_BK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], RQ_CONSUMERS / 32);  // one arrival a warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= RQ_CONSUMERS) {
    // The producer: stage s into slot s % STAGES once the products of stage s - STAGES are done.
    if (threadIdx.x == RQ_CONSUMERS) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&cmap);
      int slot = 0;
      for (int s = 0; s < nst; ++s) {
        if (s >= STAGES) mbar_wait(&empty[slot], ((s / STAGES) & 1) ^ 1);
        unsigned char* st = smem + slot * Plan::stage;
        mbar_expect_tx(&full[slot], Plan::stage);
        tma_load_2d(st, &xmap, &full[slot], s * RQ_BK, m0);
        tma_load_2d(st + Plan::a_bytes, &cmap, &full[slot], s * RQ_BK, n0);
        slot = slot + 1 == STAGES ? 0 : slot + 1;
      }
    }
    return;
  }

  // The consumers: warpgroup wg takes x rows 64 wg .. 64 wg + 63 of the tile against all BN rows of c8.
  const int wg = threadIdx.x >> 7;
  int acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0;
  int slot = 0;
  for (int s = 0; s < nst; ++s) {
    mbar_wait(&full[slot], (s / STAGES) & 1);
    const unsigned char* st = smem + slot * Plan::stage;
    const uint64_t da = make_desc<128>(st + wg * 64 * RQ_BK), db = make_desc<128>(st + Plan::a_bytes);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < RQ_BK / 32; ++ks)
      wg_s8::wgmma<BN>(acc, da + 2 * ks, db + 2 * ks, (s > 0 || ks > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<1>();  // the products of stage s - 1 are done: its slot is free
    if (s > 0 && (threadIdx.x & 31) == 0) mbar_arrive(&empty[slot == 0 ? STAGES - 1 : slot - 1]);
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue: accumulator 4 j + i of a thread is row 16 w + gid + 8 (i >> 1) of the warpgroup's 64,
  // column 8 j + 2 tig + (i & 1): acc as float32 (round to nearest even), times s8[n], times sx.
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + gid;
  const float sxv = __ldg(sx);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * tig;
    const float2 a = __ldg(reinterpret_cast<const float2*>(s8 + col));
    if (r < M)
      store2(out + (size_t)r * N + col, __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j]), a.x), sxv),
             __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 1]), a.y), sxv));
    if (r + 8 < M)
      store2(out + (size_t)(r + 8) * N + col, __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2]), a.x), sxv),
             __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 3]), a.y), sxv));
  }
}

template <int BITS>
cudaError_t launch_codes(const void* packed, const void* scale_t, const void* shift_t, const void* s8, void* c8,
                         int N, int K, int gs, cudaStream_t stream) {
  const long long runs = (long long)N * (K / 32);
  requant_codes_kernel<BITS><<<(unsigned)((runs + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scale_t), static_cast<const float*>(shift_t),
      static_cast<const float*>(s8), static_cast<int8_t*>(c8), N, K, gs);
  return cudaGetLastError();
}

cudaError_t launch_codes(int bits, const void* packed, const void* scale_t, const void* shift_t, const void* s8,
                         void* c8, int N, int K, int gs, cudaStream_t stream) {
  if (bits == 4) return launch_codes<4>(packed, scale_t, shift_t, s8, c8, N, K, gs, stream);
  if (bits == 2) return launch_codes<2>(packed, scale_t, shift_t, s8, c8, N, K, gs, stream);
  return cudaErrorInvalidValue;
}

template <typename TO, int BN, int STAGES>
cudaError_t launch_gemm(const void* x, const void* c8, const void* s8, const void* sx, void* out, int M, int N, int K,
                        cudaStream_t stream) {
  CUtensorMap xmap, cmap;
  cudaError_t e = encode_map<2>(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, {(uint64_t)K, (uint64_t)M}, {(uint64_t)K},
                                {RQ_BK, RQ_BM}, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  e = encode_map<2>(&cmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, c8, {(uint64_t)K, (uint64_t)N}, {(uint64_t)K},
                    {RQ_BK, BN}, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  constexpr int smem = RqPlan<BN, STAGES>::bytes;
  auto kernel = requant_gemm_kernel<TO, BN, STAGES>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (M + RQ_BM - 1) / RQ_BM * (N / BN);
  kernel<<<blocks, RQ_THREADS, smem, stream>>>(xmap, cmap, static_cast<const float*>(s8),
                                               static_cast<const float*>(sx), static_cast<TO*>(out), M, N, K);
  return cudaGetLastError();
}

// The tile width: 256 where the 128 x 256 tiles give every SM a block, else 128.
template <typename TO>
cudaError_t launch_gemm_for(int device, const void* x, const void* c8, const void* s8, const void* sx, void* out, int M,
                        int N, int K, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long wide = (long long)(M + RQ_BM - 1) / RQ_BM * (N / 256);
  if (N % 256 == 0 && wide >= sms) return launch_gemm<TO, 256, 4>(x, c8, s8, sx, out, M, N, K, stream);
  return launch_gemm<TO, 128, 6>(x, c8, s8, sx, out, M, N, K, stream);
}

}  // namespace

// The requant route: x int8 [M, K], s8 float32 [N], sx float32 scalar, all on the device; ws int8
// [N, K] (the requant codes, written by the first pass); bits 4 or 2 (any other is refused with
// cudaErrorInvalidValue); out_bf16: 1 when out is bfloat16, 0 when it is float32. K % 128 == 0,
// gs % 128 == 0, N % 128 == 0.
extern "C" int qbits_mm_requant_int8(int device, const void* x, const void* packed, const void* scale_t,
                                     const void* shift_t, const void* s8, const void* sx, void* out, void* ws,
                                     int M, int N, int K, int gs, int bits, int out_bf16, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (ws == nullptr || K % RQ_BK != 0 || gs % 128 != 0 || N % 128 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = launch_codes(bits, packed, scale_t, shift_t, s8, ws, N, K, gs, s);
  if (e != cudaSuccess) return (int)e;
  e = out_bf16 ? launch_gemm_for<__nv_bfloat16>(device, x, ws, s8, sx, out, M, N, K, s)
               : launch_gemm_for<float>(device, x, ws, s8, sx, out, M, N, K, s);
  return (int)e;
}

// The first pass alone: the requant codes c8 int8 [N, K] of a weight (for tests and timing).
extern "C" int qbits_requant_codes(int device, const void* packed, const void* scale_t, const void* shift_t,
                                   const void* s8, void* c8, int N, int K, int gs, int bits, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (K % 32 != 0 || gs % 32 != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_codes(bits, packed, scale_t, shift_t, s8, c8, N, K, gs, static_cast<cudaStream_t>(stream));
}
