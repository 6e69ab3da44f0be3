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
// Design: each block computes the output tile transposed, out^T[BN, BM] = deq(W)[BN, K] . x^T,
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

#include <type_traits>

#include "hopper_gemm.cuh"
#include "qbits_mm.cuh"
#include "wgmma.cuh"

namespace {

using namespace hg;
using namespace qbits;

constexpr int TC_BK = 64;       // codes of K per sub-stage (a stage holds SUB of them)
constexpr int TC_PAD = 16;      // bytes of padding per float32 x row of the ring
constexpr int TC_BN = 128;      // weight rows of a block: two warpgroups
constexpr int TC_THREADS = 256;
constexpr int TC_MAX_SPLITS = 16;

// 16 bytes global -> shared, the bytes past `src_bytes` (0 or 16) zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// NB (4, 8 or multiple of 16) bytes of shared memory as 32-bit words, in the widest loads.
template <int NB>
__device__ __forceinline__ void load_words(const unsigned char* p, uint32_t (&w)[NB / 4]) {
  if constexpr (NB % 16 == 0) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
  } else if constexpr (NB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int NB>
__device__ __forceinline__ void store_words(unsigned char* p, const uint32_t (&w)[NB / 4]) {
  if constexpr (NB % 16 == 0) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// What differs between the x types: the sum type of a group (float32 for float x, int32 for
// int8 x), the operand element bytes, and the number of bf16 planes x is split into.
template <typename T>
struct XTraits;
template <>
struct XTraits<__nv_bfloat16> {
  using Acc = float;
  static constexpr int op_bytes = 2, planes = 1;
};
template <>
struct XTraits<float> {
  using Acc = float;
  static constexpr int op_bytes = 2, planes = 2;
};
template <>
struct XTraits<int8_t> {
  using Acc = int;
  static constexpr int op_bytes = 1, planes = 1;
};

// Bytes of a stage's operand row (64 codes or x values as bf16 or s8) and of its row in the x
// ring: the operand row for bf16 and int8 x (the ring is the wgmma operand), a padded float32 row
// for float32 x (read only by the transform, which writes the planes).
template <typename T>
__host__ __device__ constexpr int op_row_bytes() { return TC_BK * XTraits<T>::op_bytes; }
template <typename T>
__host__ __device__ constexpr int x_row_bytes() {
  return XTraits<T>::planes == 2 ? TC_BK * (int)sizeof(T) + TC_PAD : op_row_bytes<T>();
}

// NB bytes of row r of a swizzled tile from byte b0 (NB 4 or 8 inside one chunk, or whole chunks).
template <int NB, int OPR>
__device__ __forceinline__ void load_sw(const unsigned char* base, int r, int b0, uint32_t (&w)[NB / 4]) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int j = 0; j < NB / 16; ++j) {
      const uint4 v = *reinterpret_cast<const uint4*>(base + sw<OPR>(r, b0 + 16 * j));
      w[4 * j] = v.x; w[4 * j + 1] = v.y; w[4 * j + 2] = v.z; w[4 * j + 3] = v.w;
    }
  } else {
    load_words<NB>(base + sw<OPR>(r, b0), w);
  }
}

template <int NB, int OPR>
__device__ __forceinline__ void store_sw(unsigned char* base, int r, int b0, const uint32_t (&w)[NB / 4]) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int j = 0; j < NB / 16; ++j)
      *reinterpret_cast<uint4*>(base + sw<OPR>(r, b0 + 16 * j)) =
          make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  } else {
    store_words<NB>(base + sw<OPR>(r, b0), w);
  }
}

// The M tile (BM x rows) by M: 8, 16, 32, 64 or 128 (float32 x at most 64: its planes need the
// room). A block is 128 weight rows, two warpgroups.
__host__ __device__ constexpr int tile_m(int M, bool x_f32) {
  return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : (M <= 64 || x_f32) ? 64 : 128;
}

// Blocks of a tile resident on one SM, as its registers and shared memory allow; the launch bounds
// hold the kernel to it.
__host__ __device__ constexpr int blocks_per_sm(int BM, bool x_f32 = false) {
  return BM <= 16 ? 3 : BM <= 64 && !x_f32 ? 2 : 1;
}

// Whether a tile takes its x sums from the first pass (stage_sums_kernel): bf16 and int8 x at
// BM >= 64, where summing BM x 64 values in every block of an M tile costs more than one pass.
template <typename T>
__host__ __device__ constexpr bool x_sums(int BM) {
  return XTraits<T>::planes == 1 && BM >= 64;
}

// Dynamic shared memory of one block, each region aligned to 1024 bytes (the swizzle's period):
// the ring (packed weight, then x, of STAGES stages), the double-buffered operand tile of the
// weight, for float32 x the double-buffered bf16 planes, and the double-buffered group sums of x;
// 1024 bytes more to align the base.
__host__ __device__ constexpr int align1k(int n) { return (n + 1023) & ~1023; }

template <typename T, int BITS, int BM, int STAGES, int SUB>
struct SmemPlan {
  static constexpr int OPR = op_row_bytes<T>();
  static constexpr int ring_x = align1k(STAGES * SUB * TC_BN * (TC_BK * BITS / 8));
  static constexpr int wtile = ring_x + align1k(STAGES * SUB * BM * x_row_bytes<T>());
  static constexpr int planes = wtile + 2 * SUB * TC_BN * OPR;
  static constexpr int xsum = planes + (XTraits<T>::planes == 2 ? 2 * SUB * 2 * BM * OPR : 0);
  static constexpr int bytes = xsum + 2 * BM * 4 + 1024;
};

template <typename TO>
__device__ __forceinline__ TO to_out(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }

// One block: weight rows n0 .. n0 + 127 (blockIdx.x), x rows m0 .. m0 + BM - 1 (blockIdx.y), the
// stages kt_per * blockIdx.z .. of K (blockIdx.z), each stage SUB sub-stages of 64 codes laid out
// as one of 64 codes is (SUB = 2 halves the barriers, copy issues and folds per code where a group
// holds whole stages). Two warpgroups, each the 64 x BM tile of out^T of its 64 weight rows
// (wgmma m64nBM). sx: the int8 path's scale (nullptr for float x). ws: the
// split partials [gridDim.z, M, N] when gridDim.z > 1.
template <typename T, typename TO, int BITS, int BM, int STAGES, int SUB>
__global__ void __launch_bounds__(TC_THREADS, blocks_per_sm(BM)) small_m_tc_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    const float* __restrict__ sx, TO* __restrict__ out, float* __restrict__ ws,
    const void* __restrict__ xs_pre, int M, int N, int K, int gs, int kt_per) {
  using X = XTraits<T>;
  using Acc = typename X::Acc;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr bool kF32 = X::planes == 2;
  constexpr int BN = TC_BN, THREADS = TC_THREADS;
  static_assert(2 * BN == THREADS, "one run of 32 codes per thread and stage");
  static_assert(STAGES >= 3, "the ring keeps two stages in flight beside the one being read");
  constexpr int WB = TC_BK * BITS / 8;  // packed bytes of a weight row per stage
  constexpr int OPR = op_row_bytes<T>();
  constexpr int XRB = x_row_bytes<T>();
  constexpr int KSTEPS = OPR / 32;      // wgmma K steps of a stage: 32 bytes each (k16 bf16, k32 s8)
  constexpr int NACC = BM / 2;          // accumulators per thread of m64nBM
  constexpr bool kPre = x_sums<T>(BM);   // stage sums of x from the first pass
  constexpr int TPR = kPre ? 1 : (THREADS / BM < 16) ? THREADS / BM : 16;  // threads per x row
  constexpr int VPT = TC_BK / TPR;      // x values per such thread and stage

  using SP = SmemPlan<T, BITS, BM, STAGES, SUB>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring_w = smem;              // [STAGES][BN][WB], row-major
  unsigned char* ring_x = smem + SP::ring_x;  // [STAGES][BM * XRB]: swizzled (float32 x: padded rows)
  unsigned char* wtile = smem + SP::wtile;    // [2][BN * OPR], swizzled
  unsigned char* planes = smem + SP::planes;  // float32 x: [2][hi, lo][BM * OPR], swizzled
  Acc* xsum = reinterpret_cast<Acc*>(smem + SP::xsum);  // [2][BM]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;          // warpgroup: weight rows 64 wg .. 64 wg + 63 of the block
  const int wq = (tid >> 5) & 3;    // warp of the warpgroup: its rows 16 wq .. 16 wq + 15
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  constexpr int SK = SUB * TC_BK;  // codes of a stage
  const int ktiles = K / TC_BK;     // sub-stages of K (the first pass's sums)
  const int kt0 = blockIdx.z * kt_per;
  const int nst = min(kt_per, K / SK - kt0);  // >= 1 by the plan
  const size_t kp = row_bytes<BITS>(K);

  // Segments: a stage ends one at its group's end and at the split's end; there the accumulators
  // are folded into y with that group's factors. spg stages a group; ph0 the first stage's place
  // in its group (after these, the loop counts instead of dividing by gs).
  const int spg = gs / SK;
  const int ph0 = kt0 % spg;

  // The copies of stage i (relative to kt0) into ring slot i % STAGES, one commit group a call.
  // Each thread's chunks and their addresses are fixed; a stage moves the sources along K.
  constexpr int WCH = BN * WB / 16;                  // 16-byte weight chunks of a stage
  constexpr int XCH = TC_BK * (int)sizeof(T) / 16;   // 16-byte chunks of an x row's stage
  constexpr int NXC = (BM * XCH + THREADS - 1) / THREADS;  // x chunks a thread copies
  const bool w_copier = WCH == THREADS || tid < WCH;
  const uint8_t* w_src =
      packed + (size_t)(n0 + tid / (WB / 16)) * kp + (size_t)kt0 * SUB * WB + (tid % (WB / 16)) * 16;
  const int w_dst = tid * 16;  // chunk q of row r at r * WB + q * 16
  const T* x_src[NXC];
  int x_dst[NXC], x_bytes[NXC];
#pragma unroll
  for (int j = 0; j < NXC; ++j) {  // neighbours along a row: coalesced reads, swizzled writes
    const int c = tid + j * THREADS;
    const int r = c / XCH, q = c % XCH;
    const bool ok = c < BM * XCH && m0 + r < M;
    x_src[j] = x + (size_t)(ok ? m0 + r : 0) * K + (size_t)kt0 * SK + q * (16 / (int)sizeof(T));
    x_dst[j] = kF32 ? r * XRB + q * 16 : sw<OPR>(r, q * 16);
    x_bytes[j] = c < BM * XCH ? (ok ? 16 : 0) : -1;  // -1: no chunk
  }
  // Stages are issued in order: the sources move along K by a stage each time.
  auto issue = [&](int i, int slot) {
    if (i < nst) {
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        unsigned char* dw = ring_w + (slot * SUB + u) * BN * WB;
        if (w_copier) cp_async16(dw + w_dst, w_src + u * WB, 16);
        unsigned char* dx = ring_x + (slot * SUB + u) * BM * XRB;
#pragma unroll
        for (int j = 0; j < NXC; ++j)
          if (x_bytes[j] >= 0) cp_async16(dx + x_dst[j], x_src[j] + u * TC_BK, x_bytes[j]);
      }
      w_src += SUB * WB;
#pragma unroll
      for (int j = 0; j < NXC; ++j) x_src[j] += SK;
    }
    cp_async_commit();
  };

  // The transform of stage i: its weight runs into operand buffer i & 1; the x sums (and planes).
  const bool x_thread = tid < BM * TPR;
  const int x_row = tid / TPR;
  const int x_seg = tid % TPR;
  const bool x_in = x_thread && m0 + x_row < M;
  const Acc* pre_row = static_cast<const Acc*>(xs_pre) + (size_t)(x_in ? m0 + x_row : 0) * ktiles;
  Acc pre_next[SUB];  // the first pass's sums of the next stage to transform
#pragma unroll
  for (int u = 0; u < SUB; ++u) pre_next[u] = kPre && x_in ? pre_row[kt0 * SUB + u] : Acc(0);
  Acc gsum = 0;     // this thread's part of the current segment's x sum for row x_row
  int seg_w = 0;    // segments whose x sums are written
  int t_ph = ph0;   // the transformed stage's place in its group
  auto transform = [&](int i, int slot) {
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      const int su = slot * SUB + u;           // ring sub-slot
      const int bu = (i & 1) * SUB + u;       // operand sub-buffer
      const int r = tid >> 1, h = tid & 1;  // codes 32 h .. 32 h + 31 of row r
      uint32_t pw[BITS];
      load_run_shared<BITS>(ring_w + su * BN * WB + tid * 4 * BITS, pw);
      unsigned char* dst = wtile + bu * BN * OPR;
      if constexpr (kInt8) {
        uint32_t cw[8];
        codes_s8<BITS>(pw, cw);
        store_sw<32, OPR>(dst, r, 32 * h, cw);
      } else {
        uint32_t cw[16];
        codes_bf16<BITS>(pw, cw);
        store_sw<64, OPR>(dst, r, 64 * h, cw);
      }
      if (x_thread) {
        const unsigned char* src = ring_x + su * BM * XRB;
        if constexpr (kPre) {  // the first pass's sum, loaded a stage ahead
          gsum += pre_next[u];
          if (i + 1 < nst && x_in) pre_next[u] = pre_row[(kt0 + i + 1) * SUB + u];
        } else if constexpr (kF32) {
          uint32_t xw[VPT];
          load_words<VPT * 4>(src + x_row * XRB + x_seg * VPT * 4, xw);
          uint32_t hi[VPT / 2], lo[VPT / 2];
          float part[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < VPT / 2; ++j) {
            const float a = __uint_as_float(xw[2 * j]), c = __uint_as_float(xw[2 * j + 1]);
            part[j & 1] += a + c;
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, c);
            const float2 hf = __bfloat1622float2(h2);
            const __nv_bfloat162 l2 = __floats2bfloat162_rn(a - hf.x, c - hf.y);
            hi[j] = *reinterpret_cast<const uint32_t*>(&h2);
            lo[j] = *reinterpret_cast<const uint32_t*>(&l2);
          }
          gsum += part[0] + part[1];
          unsigned char* pd = planes + bu * 2 * BM * OPR;
          store_sw<VPT * 2, OPR>(pd, x_row, x_seg * VPT * 2, hi);
          store_sw<VPT * 2, OPR>(pd + BM * OPR, x_row, x_seg * VPT * 2, lo);
        } else {
          constexpr int NB = VPT * (int)sizeof(T);
          uint32_t xw[NB / 4];
          load_sw<NB, OPR>(src, x_row, x_seg * NB, xw);
          if constexpr (kInt8) {
#pragma unroll
            for (int j = 0; j < NB / 4; ++j) gsum = __dp4a((int)xw[j], 0x01010101, gsum);
          } else {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int j = 0; j < NB / 4; ++j)
              part[j & 3] += __uint_as_float(xw[j] << 16) + __uint_as_float(xw[j] & 0xFFFF0000u);
            gsum += (part[0] + part[1]) + (part[2] + part[3]);
          }
        }
      }
    }
    const bool end = t_ph == spg - 1 || i + 1 == nst;
    t_ph = t_ph == spg - 1 ? 0 : t_ph + 1;
    if (end) {  // uniform over the block: the TPR threads of a row reduce their parts
      Acc v = x_thread ? gsum : Acc(0);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (x_thread && x_seg == 0) xsum[(seg_w & 1) * BM + x_row] = v;
      gsum = 0;
      ++seg_w;
    }
  };

  Acc acc[NACC];
  float y[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    acc[j] = 0;
    y[j] = 0.f;
  }

  // The products of stage i on the tensor cores, asynchronous: each warpgroup's 64 weight rows
  // against the BM x rows (both planes of float32 x); a new segment's first product overwrites
  // the accumulators.
  auto mma_issue = [&](int i, int slot, bool fresh) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < SUB; ++u)
#pragma unroll
    for (int p = 0; p < X::planes; ++p) {
      const int bu = (i & 1) * SUB + u;
      const unsigned char* a_base = wtile + bu * BN * OPR + wg * 64 * OPR;
      const unsigned char* b_base =
          kF32 ? planes + (bu * 2 + p) * BM * OPR : ring_x + (slot * SUB + u) * BM * XRB;
      const uint64_t da = make_desc<OPR>(a_base), db = make_desc<OPR>(b_base);
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {  // 32 bytes of K: 2 address units
        const int scale_d = (fresh && u == 0 && p == 0 && ks == 0) ? 0 : 1;
        if constexpr (kInt8)
          wg_s8::wgmma<BM>(acc, da + 2 * ks, db + 2 * ks, scale_d);
        else
          wg_bf16::wgmma<BM>(acc, da + 2 * ks, db + 2 * ks, scale_d);
      }
    }
    wgmma_commit();
  };

  // Accumulator j of a thread: weight row 16 wq + gid + 8 ((j >> 1) & 1) of the warpgroup's 64,
  // x row 8 (j >> 2) + 2 tig + (j & 1) of the block's BM.
  const int n_lo = n0 + 64 * wg + 16 * wq + gid;
  int seg_r = 0;  // segments folded
  // The factors of the segment being accumulated, loaded a segment ahead of its fold.
  float s0, s1, z0, z1;
  auto load_factors = [&](int g) {
    s0 = __ldg(scale_t + (size_t)g * N + n_lo);
    s1 = __ldg(scale_t + (size_t)g * N + n_lo + 8);
    z0 = __ldg(shift_t + (size_t)g * N + n_lo);
    z1 = __ldg(shift_t + (size_t)g * N + n_lo + 8);
  };
  // The fold of a group into y, in the reference's order (quanto_tpu/ops/pallas/qbits_mm.py:_kernel,
  // _int8_kernel): y += acc * s - sum(x) * z.
  auto fold = [&]() {
    const Acc* xs = xsum + (seg_r & 1) * BM;
#pragma unroll
    for (int q = 0; q < BM / 8; ++q) {
      const Acc* xp = xs + 8 * q + 2 * tig;  // the pair of x rows of this quad, one 8-byte load
      float x0, x1;
      if constexpr (kInt8) {
        const int2 v = *reinterpret_cast<const int2*>(xp);
        x0 = (float)v.x;
        x1 = (float)v.y;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(xp);
        x0 = v.x;
        x1 = v.y;
      }
      y[4 * q + 0] += (float)acc[4 * q + 0] * s0 - x0 * z0;
      y[4 * q + 1] += (float)acc[4 * q + 1] * s0 - x1 * z0;
      y[4 * q + 2] += (float)acc[4 * q + 2] * s1 - x0 * z1;
      y[4 * q + 3] += (float)acc[4 * q + 3] * s1 - x1 * z1;
    }
    ++seg_r;
  };

  // The pipeline: stages 0 .. STAGES - 2 in flight, stage 0 transformed; then each iteration
  // waits for stage i + 1, starts the products of stage i, issues the copies of stage
  // i + STAGES - 1, transforms stage i + 1 while the products run, and waits for them before
  // folding. The one barrier a stage orders: the copies of stage i + 1 before its transform; the
  // transform of stage i (made visible to the tensor cores by the proxy fence) before its
  // products; the products of stage i - 1 (its ring slot and operand buffer) before their reuse.
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) issue(i, i);
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  transform(0, 0);
  int g = kt0 * SK / gs;     // the group being accumulated
  load_factors(g);
  int ph = ph0;              // stage i's place in its group
  bool fresh = true;         // stage i starts a segment
  int slot = 0;              // stage i's ring slot, i % STAGES
#pragma unroll 1
  for (int i = 0; i < nst; ++i) {
    const int next = slot + 1 == STAGES ? 0 : slot + 1;  // stage i + 1's
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    mma_issue(i, slot, fresh);
    issue(i + STAGES - 1, slot == 0 ? STAGES - 1 : slot - 1);  // stage i - 1's slot, free now
    if (i + 1 < nst) transform(i + 1, next);
    wgmma_wait<0>();
    fence_regs(acc);
    fresh = ph == spg - 1 || i + 1 == nst;  // stage i ends a segment: the next one starts afresh
    ph = ph == spg - 1 ? 0 : ph + 1;
    if (fresh) {
      fold();
      if (i + 1 < nst) load_factors(++g);
    }
    slot = next;
  }
  cp_async_wait<0>();

  const float sxv = kInt8 ? __ldg(sx) : 1.f;
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int m = m0 + 8 * (j >> 2) + 2 * tig + (j & 1);
    const int n = n_lo + 8 * ((j >> 1) & 1);
    if (m < M) {
      if (gridDim.z == 1)
        out[(size_t)m * N + n] = to_out<TO>(kInt8 ? y[j] * sxv : y[j]);
      else
        ws[((size_t)blockIdx.z * M + m) * N + n] = y[j];
    }
  }
}

// The sums of x over each stage of 64 values, once per call for the tiles that would otherwise
// sum them in every block (x_sums): xs[m, kt] = sum_{k < 64} x[m, 64 kt + k], float32 for bf16 x
// (in K order), int32 for int8 x (exact).
template <typename T, typename Acc>
__global__ void __launch_bounds__(256) stage_sums_kernel(const T* __restrict__ x, Acc* __restrict__ xs,
                                                         int M, int K) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int ktiles = K / TC_BK;
  if (i >= M * ktiles) return;
  const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)(i / ktiles) * K + (size_t)(i % ktiles) * TC_BK);
  Acc v = 0;
#pragma unroll
  for (int j = 0; j < TC_BK * (int)sizeof(T) / 16; ++j) {
    const uint4 w = __ldg(p + j);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (std::is_same<T, int8_t>::value)
        v = __dp4a((int)ws[q], 0x01010101, v);
      else
        v += __uint_as_float(ws[q] << 16) + __uint_as_float(ws[q] & 0xFFFF0000u);
    }
  }
  xs[i] = v;
}

// The second pass of a split K: out = (sum of the splits' partials in split order) [* sx].
template <typename TO>
__global__ void __launch_bounds__(256) splitk_sum_kernel(const float* __restrict__ ws,
                                                         const float* __restrict__ sx,
                                                         TO* __restrict__ out, int MN, int splits) {
  const int i = (blockIdx.x * 256 + threadIdx.x) * 4;  // MN % 4 == 0 (N % 128 == 0)
  if (i >= MN) return;
  float4 v = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < splits; ++s) {
    const float4 w = *reinterpret_cast<const float4*>(ws + (size_t)s * MN + i);
    v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
  }
  if (sx != nullptr) {
    const float f = __ldg(sx);
    v.x *= f; v.y *= f; v.z *= f; v.w *= f;
  }
  store2(out + i, v.x, v.y);
  store2(out + i + 2, v.z, v.w);
}

// Sub-stages of 64 codes a stage: 2 for the 128-row M tile where a group holds whole stages of
// 128 codes, else 1.
int sub_stages(int M, int gs, bool x_f32) { return tile_m(M, x_f32) == 128 && gs % 128 == 0 ? 2 : 1; }

// Splits of K: while N / BN * ceil(M / BM) blocks fill less than one wave of the card, K is split
// so that one wave holds them all, at most 16 ways and at least 4 stages a split. kt_per: stages
// per split.
cudaError_t plan_splits(int device, int M, int N, int K, int gs, bool x_f32, int* splits, int* kt_per) {
  int sms = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int BM = tile_m(M, x_f32);
  const long base = (long)(N / TC_BN) * ((M + BM - 1) / BM);
  const long wave = (long)blocks_per_sm(BM, x_f32) * sms;
  const int ktiles = K / (TC_BK * sub_stages(M, gs, x_f32));
  const int s = (int)max(1L, min(wave / base, (long)min(TC_MAX_SPLITS, ktiles / 4)));
  *kt_per = (ktiles + s - 1) / s;
  *splits = (ktiles + *kt_per - 1) / *kt_per;
  return cudaSuccess;
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
    stage_sums_kernel<T, Acc><<<(n + 255) / 256, 256, 0, stream>>>(static_cast<const T*>(x), sums, M, K);
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
  const int MN = M * N;
  splitk_sum_kernel<TO><<<(MN / 4 + 255) / 256, 256, 0, stream>>>(
      partials, static_cast<const float*>(sx), static_cast<TO*>(out), MN, splits);
  return cudaGetLastError();
}

template <typename T, typename TO, int BITS>
int launch(int device, const void* x, const void* packed, const void* scale_t, const void* shift_t,
           const void* sx, void* out, void* ws, int M, int N, int K, int gs, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  int splits = 1, kt_per = 1;
  cudaError_t e = plan_splits(device, M, N, K, gs, f32, &splits, &kt_per);
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
  int splits = 1, kt_per = 1;
  const cudaError_t e = plan_splits(device, M, N, K, gs, x_f32 != 0, &splits, &kt_per);
  if (e != cudaSuccess) return (int)e;
  const bool sums = x_f32 ? x_sums<float>(tile_m(M, true)) : x_sums<__nv_bfloat16>(tile_m(M, false));
  *floats = (sums ? (long long)M * (K / TC_BK) : 0) + (splits > 1 ? (long long)splits * M * N : 0);
  return 0;
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
