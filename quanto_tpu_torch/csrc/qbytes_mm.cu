// Fused 8-bit weight-only matmul for Hopper (sm_90a), on the tensor cores:
//
//   y[m, n] = scale[n] * sum_k x[m, k] * w[n, k]      (M <= 256)
//
// Replaces quanto_tpu/ops/pallas/qbytes_mm.py:_kernel (TPU #6, int8 payload) and :_fp8_kernel
// (TPU #7, float8 e4m3fn payload): float32 sums, the per-output-channel scale applied to the
// output in float32, output in x's dtype (bfloat16 or float32). The scale is read in its stored
// dtype (bfloat16 or float32).
//
// Layout: x [M, K] row-major; w [N, K] row-major (torch linear convention, K-contiguous); scale [N]
// (the [N, 1] keepdim scale).
//
// Bound on this card: by bytes up to M of about 148 (each weight byte read once and used for M
// rows: 14336 x 4096 moves 58.7 MB, 17.5 us at 3.35 TB/s), by operations above (M = 256: 30
// GFLOP, 30.4 us at the bf16 rate; x is bf16, so the products are bf16 products whatever the
// payload).
//
// Design. Each block computes its output tile transposed, out^T[128, BM] = w[128, K] . x^T[K, BM],
// so 128 weight rows fill wgmma's 64-row side (two warpgroups, 64 rows each) and the M rows of x
// its narrow side (m64nBMk16, BM = 8, 16, 32, 64, 128 or 256 by M; at most 64 for float32 x). One
// block holds all M rows of x, so x is read from L2 once per 128 weight rows (at M = 256 on
// 14336 x 4096: 235 MB) and every weight byte once from device memory. A block walks its K range in stages of 64 through a ring of STAGES stages in shared memory fed
// by cp.async (16 bytes a thread): the weight's bytes raw (128 rows x 64 bytes, 64-byte swizzle;
// each copy asks L2 for the whole 256-byte span around it, so device memory sees 256-byte reads
// of a row rather than 64-byte ones) and the x tile in wgmma's 128-byte swizzled K-major layout
// (rows past M zero-filled). The products take A from registers (the "RS" form): each thread
// loads its warp's A fragments from the raw bytes (two bytes a k-pair, conflict-free under the
// swizzle) and converts them in registers to exact bf16, so no converted tile is written back to
// shared memory. Unlike the group-wise kernels there is no fold per group: one accumulator set
// runs over the whole of K and the scale is applied once, in the epilogue. So for bf16 x the
// products of a stage stay in flight while the next stage's fragments are loaded and converted
// (wgmma.wait_group 1, two register sets taken in turn). float32 x enters as a bf16 high and low
// plane (two products), written by a transform of the next stage while this stage's products run.
//
// Where N / 128 * ceil(M / BM) blocks would leave the 132 SMs short (decode, the narrow k/v
// projections), the K range is split over gridDim.z: each split writes its float32 partial tile to
// a workspace the wrapper allocates (qbytes_mm_workspace gives its size) and a second kernel sums
// the splits in a fixed order and applies the scale, so the output is the same from run to run
// (no atomics).
//
// On the H100 (PERF.md, the kernel table) it takes about twice its byte bound at M <= 16 on the
// large shapes and 1.05-1.1 times torch.matmul at M = 256 on 14336 x 4096 (twice its operation
// bound). There the x tile's L2 reads (235 MB a call; not measured apart) are the likely limit,
// and sharing x over a cluster (TMA multicast) the lever left.
//
// int8 codes convert by 0x4B000000 | (c + 128), the float 2^23 + 128 + c exactly, minus that
// bias. e4m3fn codes convert through the hardware (cuda_fp8.h) to f16, exactly; the NaN codes
// 0x7F and 0xFF give NaN here, as the JAX package's own route (quanto_tpu/ops/qbytes_mm.py, a
// convert) gives; only the dormant Pallas kernel's integer decode gives +-480. The quantizer never
// produces them: it clips to +-448 before the cast.
//
// Entry points have a plain C interface (bound with ctypes in ops/cuda/qbytes_mm.py). They launch
// on the stream they are given, allocate nothing, and return cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "small_m_tc.cuh"

namespace {

constexpr int QB_BN = 128;      // weight rows of a block: two warpgroups
constexpr int QB_BK = 64;       // K values (weight bytes of a row) per stage
constexpr int QB_THREADS = 256;
constexpr int QB_MAX_SPLITS = 16;
constexpr int QB_XPAD = 16;     // bytes of padding per float32 x row of the ring

// The M tile by M: 8 .. 256 for bf16 x (one tile holds all M rows), at most 64 for float32 x (its
// planes need the room).
__host__ __device__ constexpr int qb_tile_m(int M, bool x_f32) {
  return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : (M <= 64 || x_f32) ? 64 : M <= 128 ? 128 : 256;
}

// Blocks of a tile resident on one SM, as its registers and shared memory allow.
__host__ __device__ constexpr int qb_blocks_per_sm(int BM, bool x_f32) {
  return x_f32 ? (BM <= 16 ? 2 : 1) : BM <= 16 ? 3 : BM <= 128 ? 2 : 1;
}

__host__ __device__ constexpr int qb_stages(int BM) { return BM <= 16 ? 6 : BM <= 32 ? 5 : BM <= 128 ? 4 : 5; }

// Dynamic shared memory: the ring (the weight's raw bytes, then x, of STAGES stages), for float32 x
// the double-buffered bf16 planes; 1024 bytes more to align the base.
template <typename TX, int BM, int STAGES>
struct QbPlan {
  static constexpr bool f32 = std::is_same<TX, float>::value;
  static constexpr int XRB = f32 ? QB_BK * 4 + QB_XPAD : QB_BK * 2;  // bytes of an x row in the ring
  static constexpr int W_STAGE = QB_BN * QB_BK;
  static constexpr int X_STAGE = align1k(BM * XRB);
  static constexpr int ring_x = STAGES * W_STAGE;
  static constexpr int planes = ring_x + STAGES * X_STAGE;
  static constexpr int bytes = planes + (f32 ? 2 * 2 * BM * 128 : 0) + 1024;
};

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two weight bytes (the low 16 bits of v, k order) as a bf16 pair, exactly.
template <bool E4M3>
__device__ __forceinline__ uint32_t pair_bf16(uint32_t v) {
  if constexpr (E4M3) {
    const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(v), __NV_E4M3);
    const float2 f = __half22float2(__half2(r));
    return bf16_pair(f.x, f.y);
  } else {
    const uint32_t u = v ^ 0x8080u;  // c -> c + 128 in [0, 255]
    return bf16_pair(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f);
  }
}

__device__ __forceinline__ float scale_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float scale_f(float v) { return v; }

// One block: weight rows n0 = 128 blockIdx.x .., x rows m0 = BM blockIdx.y .., the stages
// kt_per * blockIdx.z .. of K. ws: the split partials [gridDim.z, M, N] when gridDim.z > 1.
template <typename TX, typename TS, bool E4M3, int BM, int STAGES>
__global__ void __launch_bounds__(QB_THREADS, qb_blocks_per_sm(BM, std::is_same<TX, float>::value))
    qbytes_mm_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ w, const TS* __restrict__ scale,
                     TX* __restrict__ out, float* __restrict__ ws, int M, int N, int K, int kt_per) {
  using P = QbPlan<TX, BM, STAGES>;
  constexpr bool kF32 = P::f32;
  constexpr int XRB = P::XRB;
  constexpr int NACC = BM / 2;         // accumulators per thread of m64nBM
  constexpr int WCH = QB_BN * QB_BK / 16 / QB_THREADS;  // weight chunks a thread copies: 2
  constexpr int XCH = QB_BK * (int)sizeof(TX) / 16;      // 16-byte chunks of an x row's stage
  constexpr int NXC = (BM * XCH + QB_THREADS - 1) / QB_THREADS;
  constexpr int TPR = (QB_THREADS / BM < 16) ? QB_THREADS / BM : 16;  // float32 x: threads per row
  constexpr int VPT = QB_BK / TPR;                                    // and values per thread

  extern __shared__ __align__(128) unsigned char smem_qb[];
  unsigned char* smem = smem_qb + ((1024 - (smem_addr(smem_qb) & 1023)) & 1023);
  unsigned char* ring_w = smem;              // [STAGES][128 rows x 64 bytes], 64-byte swizzle
  unsigned char* ring_x = smem + P::ring_x;  // [STAGES][X_STAGE]: swizzled (float32 x: padded rows)
  unsigned char* planes = smem + P::planes;  // float32 x: [2][hi, lo][BM x 128 bytes], swizzled

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int wq = (tid >> 5) & 3;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n0 = blockIdx.x * QB_BN;
  const int m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * kt_per;
  const int nst = min(kt_per, K / QB_BK - kt0);  // >= 1 by the plan

  // The copies of stage i into ring slot `slot`, one commit group a call; each thread's chunks are
  // fixed and a stage moves the sources along K.
  const uint8_t* w_src[WCH];
  int w_dst[WCH];
#pragma unroll
  for (int j = 0; j < WCH; ++j) {
    const int c = tid + j * QB_THREADS, r = c >> 2, q = c & 3;
    w_src[j] = w + (size_t)(n0 + r) * K + (size_t)kt0 * QB_BK + 16 * q;
    w_dst[j] = sw<64>(r, 16 * q);
  }
  const TX* x_src[NXC];
  int x_dst[NXC], x_bytes[NXC];
#pragma unroll
  for (int j = 0; j < NXC; ++j) {  // neighbours along a row: coalesced reads, swizzled writes
    const int c = tid + j * QB_THREADS;
    const int r = c / XCH, q = c % XCH;
    const bool ok = c < BM * XCH && m0 + r < M;
    x_src[j] = x + (size_t)(ok ? m0 + r : 0) * K + (size_t)kt0 * QB_BK + q * (16 / (int)sizeof(TX));
    x_dst[j] = kF32 ? r * XRB + q * 16 : sw<128>(r, q * 16);
    x_bytes[j] = c < BM * XCH ? (ok ? 16 : 0) : -1;  // -1: no chunk
  }
  auto issue = [&](int i, int slot) {
    if (i < nst) {
#pragma unroll
      for (int j = 0; j < WCH; ++j) {
        cp_async16_pf256(ring_w + slot * P::W_STAGE + w_dst[j], w_src[j]);
        w_src[j] += QB_BK;
      }
#pragma unroll
      for (int j = 0; j < NXC; ++j) {
        if (x_bytes[j] >= 0) cp_async16(ring_x + slot * P::X_STAGE + x_dst[j], x_src[j], x_bytes[j]);
        x_src[j] += QB_BK;
      }
    }
    cp_async_commit();
  };

  // float32 x: stage i's rows into bf16 high and low planes, buffer i & 1.
  const bool x_thread = tid < BM * TPR;
  const int x_row = tid / TPR, x_seg = tid % TPR;
  auto transform = [&](int i, int slot) {
    if constexpr (kF32) {
      if (x_thread) {
        uint32_t xw[VPT];
        load_words<VPT * 4>(ring_x + slot * P::X_STAGE + x_row * XRB + x_seg * VPT * 4, xw);
        uint32_t hi[VPT / 2], lo[VPT / 2];
#pragma unroll
        for (int j = 0; j < VPT / 2; ++j) {
          const float a = __uint_as_float(xw[2 * j]), c = __uint_as_float(xw[2 * j + 1]);
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, c);
          const float2 hf = __bfloat1622float2(h2);
          hi[j] = *reinterpret_cast<const uint32_t*>(&h2);
          lo[j] = bf16_pair(a - hf.x, c - hf.y);
        }
        unsigned char* pd = planes + (i & 1) * 2 * BM * 128;
        store_sw<VPT * 2, 128>(pd, x_row, x_seg * VPT * 2, hi);
        store_sw<VPT * 2, 128>(pd + BM * 128, x_row, x_seg * VPT * 2, lo);
      }
    }
  };

  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  // This thread's A rows of its warpgroup's 64: 16 wq + gid and + 8 (block rows r0, r1).
  const int r0 = 64 * wg + 16 * wq + gid, r1 = r0 + 8;


  // This thread's A fragments of stage `slot`: k pairs 2 tig and 2 tig + 8 of each k16 step.
  const auto load_a = [&](int slot, uint32_t (&a)[4][4]) {
    const unsigned char* wt = ring_w + slot * P::W_STAGE;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j][0] = pair_bf16<E4M3>(*reinterpret_cast<const uint16_t*>(wt + sw<64>(r0, 16 * j + 2 * tig)));
      a[j][1] = pair_bf16<E4M3>(*reinterpret_cast<const uint16_t*>(wt + sw<64>(r1, 16 * j + 2 * tig)));
      a[j][2] = pair_bf16<E4M3>(*reinterpret_cast<const uint16_t*>(wt + sw<64>(r0, 16 * j + 8 + 2 * tig)));
      a[j][3] = pair_bf16<E4M3>(*reinterpret_cast<const uint16_t*>(wt + sw<64>(r1, 16 * j + 8 + 2 * tig)));
    }
  };
  const auto products = [&](const uint32_t (&a)[4][4], const unsigned char* b_base) {
    const uint64_t db = make_desc<128>(b_base);
#pragma unroll
    for (int j = 0; j < 4; ++j) wg_bf16_rs::wgmma<BM>(acc, a[j], db + 2 * j, 1);
  };

  if constexpr (!kF32) {
    // bf16 x: the products of stage i - 1 run while stage i's A fragments are loaded and its
    // products queued behind them (wgmma.wait_group 1). Stages 0 .. STAGES - 3 in flight; step i
    // waits for stage i, issues the copies of stage i + STAGES - 2 into stage i - 2's slot (its
    // products waited for by every thread before this step's barrier), loads stage i's A fragments
    // into the register set of its parity, starts its products and waits for stage i - 1's. A split
    // has an even number of stages (K / 64 is even and so is kt_per), so the loop takes two steps
    // at a time, each with its own register set, and never waits in a branch.
#pragma unroll 1
    for (int i = 0; i < STAGES - 2; ++i) issue(i, i);
    uint32_t a0[4][4], a1[4][4];
    fence_regs(acc);
    const auto step = [&](int i, uint32_t (&a)[4][4]) {
      const int slot = i % STAGES;
      cp_async_wait<STAGES - 3>();
      fence_proxy_async();
      __syncthreads();
      issue(i + STAGES - 2, (i + STAGES - 2) % STAGES);
      load_a(slot, a);
      wgmma_fence();
      products(a, ring_x + slot * P::X_STAGE);
      wgmma_commit();
      wgmma_wait<1>();
    };
#pragma unroll 1
    for (int i = 0; i < nst; i += 2) {
      step(i, a0);
      step(i + 1, a1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
  } else {
    // float32 x: each iteration waits for stage i + 1, starts stage i's products, issues the copies
    // of stage i + STAGES - 1 into stage i - 1's slot, writes stage i + 1's planes while the
    // products run, and waits for them. The one barrier a stage orders the copies and the planes of
    // a stage before its products, and the products of stage i - 1 before its slot and plane buffer
    // are written again.
#pragma unroll 1
    for (int i = 0; i < STAGES - 1; ++i) issue(i, i);
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    transform(0, 0);
    int slot = 0;
#pragma unroll 1
    for (int i = 0; i < nst; ++i) {
      const int next = slot + 1 == STAGES ? 0 : slot + 1;
      cp_async_wait<STAGES - 3>();
      fence_proxy_async();
      __syncthreads();
      uint32_t a[4][4];
      load_a(slot, a);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 2; ++p) products(a, planes + ((i & 1) * 2 + p) * BM * 128);
      wgmma_commit();
      issue(i + STAGES - 1, slot == 0 ? STAGES - 1 : slot - 1);  // stage i - 1's slot, free now
      if (i + 1 < nst) transform(i + 1, next);
      wgmma_wait<0>();
      fence_regs(acc);
      slot = next;
    }
  }
  cp_async_wait<0>();

  // Accumulator j: weight row n_lo + 8 ((j >> 1) & 1), x row m0 + 8 (j >> 2) + 2 tig + (j & 1).
  const int n_lo = n0 + r0;
  const float s0 = scale_f(scale[n_lo]), s1 = scale_f(scale[n_lo + 8]);
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int m = m0 + acc_m(j, tig);
    const int n = n_lo + acc_n(j);
    if (m < M) {
      if (gridDim.z == 1)
        out[(size_t)m * N + n] = to_out<TX>(acc[j] * ((j >> 1) & 1 ? s1 : s0));
      else
        ws[((size_t)blockIdx.z * M + m) * N + n] = acc[j];
    }
  }
}

// The second pass of a split K: out = (sum of the splits' partials in split order) * scale[n].
template <typename TX, typename TS>
__global__ void __launch_bounds__(256) qbytes_splitk_kernel(const float* __restrict__ ws,
                                                            const TS* __restrict__ scale,
                                                            TX* __restrict__ out, int N, long long MN,
                                                            int splits) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;  // N % 4 == 0: one row
  if (i >= MN) return;
  float4 v = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < splits; ++s) {
    const float4 u = *reinterpret_cast<const float4*>(ws + (size_t)s * MN + i);
    v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
  }
  const int n = (int)(i % N);
  store2(out + i, v.x * scale_f(scale[n]), v.y * scale_f(scale[n + 1]));
  store2(out + i + 2, v.z * scale_f(scale[n + 2]), v.w * scale_f(scale[n + 3]));
}

// Splits of K: while N / 128 * ceil(M / BM) blocks fill less than one wave of the card, K is split
// so that one wave holds them all, at most 16 ways and at least 4 stages a split, an even number
// (K / 64 is even, so every split's count is).
cudaError_t qb_plan(int device, int M, int N, int K, bool x_f32, int* splits, int* kt_per) {
  int sms = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int BM = qb_tile_m(M, x_f32);
  const long base = (long)(N / QB_BN) * ((M + BM - 1) / BM);
  const long wave = (long)qb_blocks_per_sm(BM, x_f32) * sms;
  const int ktiles = K / QB_BK;
  const int s = (int)max(1L, min(wave / base, (long)min(QB_MAX_SPLITS, ktiles / 4)));
  *kt_per = ((ktiles + s - 1) / s + 1) & ~1;  // even: the bf16 pipeline takes stages two at a time
  *splits = (ktiles + *kt_per - 1) / *kt_per;
  return cudaSuccess;
}

template <typename TX, typename TS, bool E4M3, int BM>
int launch_cfg(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N, int K,
               int splits, int kt_per, cudaStream_t stream) {
  constexpr int STAGES = qb_stages(BM);
  constexpr size_t smem = QbPlan<TX, BM, STAGES>::bytes;
  auto kernel = qbytes_mm_kernel<TX, TS, E4M3, BM, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / QB_BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, QB_THREADS, smem, stream>>>(static_cast<const TX*>(x), static_cast<const uint8_t*>(w),
                                             static_cast<const TS*>(scale), static_cast<TX*>(out),
                                             static_cast<float*>(ws), M, N, K, kt_per);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long MN = (long long)M * N;
  qbytes_splitk_kernel<TX, TS><<<(unsigned)((MN / 4 + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const TS*>(scale), static_cast<TX*>(out), N, MN, splits);
  return (int)cudaGetLastError();
}

template <typename TX, typename TS, bool E4M3>
int launch(int device, const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N,
           int K, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<TX, float>::value;
  int splits = 1, kt_per = 1;
  const cudaError_t e = qb_plan(device, M, N, K, f32, &splits, &kt_per);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const auto run = [&](auto cfg) { return cfg(x, w, scale, out, ws, M, N, K, splits, kt_per, stream); };
  switch (qb_tile_m(M, f32)) {
    case 8: return run(launch_cfg<TX, TS, E4M3, 8>);
    case 16: return run(launch_cfg<TX, TS, E4M3, 16>);
    case 32: return run(launch_cfg<TX, TS, E4M3, 32>);
    case 64: return run(launch_cfg<TX, TS, E4M3, 64>);
    default:
      if constexpr (f32) return (int)cudaErrorInvalidValue;  // qb_tile_m keeps float32 x at 64
      else if (M <= 128) return run(launch_cfg<TX, TS, E4M3, 128>);
      else return run(launch_cfg<TX, TS, E4M3, 256>);
  }
}

template <typename TX, typename TS>
int launch_payload(int device, int e4m3, const void* x, const void* w, const void* scale, void* out, void* ws,
                   int M, int N, int K, cudaStream_t s) {
  return e4m3 ? launch<TX, TS, true>(device, x, w, scale, out, ws, M, N, K, s)
              : launch<TX, TS, false>(device, x, w, scale, out, ws, M, N, K, s);
}

}  // namespace

// 4-byte elements of the workspace qbytes_mm takes for these shapes on `device`: the split
// partials [splits, M, N] where K is split, else 0; x_f32: 1 for float32 x, 0 for bfloat16.
extern "C" int qbytes_mm_workspace(int device, int M, int N, int K, int x_f32, long long* floats) {
  int splits = 1, kt_per = 1;
  const cudaError_t e = qb_plan(device, M, N, K, x_f32 != 0, &splits, &kt_per);
  if (e != cudaSuccess) return (int)e;
  *floats = splits > 1 ? (long long)splits * M * N : 0;
  return 0;
}

// x_bf16: 1 when x and out are bfloat16, 0 when float32; scale_bf16 likewise for the scale;
// w_e4m3: 1 for a float8 e4m3fn payload, 0 for int8; ws: float32, of qbytes_mm_workspace's size
// (null when 0). M <= 256, N and K multiples of 128.
extern "C" int qbytes_mm(int device, const void* x, const void* w, const void* scale, void* out, void* ws,
                         int M, int N, int K, int x_bf16, int scale_bf16, int w_e4m3, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (M < 1 || M > 256 || N % QB_BN || K % 128) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return scale_bf16 ? launch_payload<__nv_bfloat16, __nv_bfloat16>(device, w_e4m3, x, w, scale, out, ws, M, N, K, s)
                      : launch_payload<__nv_bfloat16, float>(device, w_e4m3, x, w, scale, out, ws, M, N, K, s);
  return scale_bf16 ? launch_payload<float, __nv_bfloat16>(device, w_e4m3, x, w, scale, out, ws, M, N, K, s)
                    : launch_payload<float, float>(device, w_e4m3, x, w, scale, out, ws, M, N, K, s);
}
