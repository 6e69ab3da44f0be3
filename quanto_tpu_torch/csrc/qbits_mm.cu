// Fused int4 group-wise dequant matmuls for Hopper (sm_90a).
//
//   y[M, N] = x[M, K] @ deq(W)^T,   deq(W)[n, k] = s[g, n] * c[n, k] - z[g, n],   g = k / gs,
//
// computed group-factored as  y = sum_g s_g * (x_g . c_g) - (sum_k x_gk) * z_g  with float32
// sums, then cast to x's dtype (bfloat16 or float32).
//
// W4A8 (int8 x, per-tensor scale sx): the same factoring with integer sums inside each group,
//
//   y = sx * sum_g [ s_g * (xq_g . c_g) - z_g * (sum_k xq_gk) ],
//
// exact in int32 within a group (|xq| <= 128, c <= 15), the epilogue in float32, then cast to
// the weight's float dtype (bfloat16 or float32); sx is read from device memory.
//
// Weight layout (quanto_tpu_torch/tensor/weights.py:WeightQBitsHopperArray):
//   packed  uint8 [N, K/2], packed[n, j] = c[n, 2j] | c[n, 2j + 1] << 4, so one 16-byte load
//           holds 32 consecutive K codes of one row; bytes are unsigned, so no sign extension;
//   scale_t, shift_t  float32 [G, N] (G = K / gs), float-shift semantics.
//
// Entry points have a plain C interface (bound with ctypes in ops/cuda/qbits_mm.py). They launch
// on the stream they are given, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A code c in [0, 15] as a float: 0x4B000000 | c is the float 2^23 + c exactly.
__device__ __forceinline__ float code_to_float(uint32_t c) {
  return __uint_as_float(0x4B000000u | c) - 8388608.0f;
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
// qbits_mm_small_m (M <= 512).
//
// Replaces quanto_tpu/ops/pallas/qbits_mm.py:_kernel, the TPU decode kernel.
// Bound on this card by bytes: at M = 4 every packed weight byte is read once and used for 4
// rows of x, far below the ~295 operations per byte at which the tensor cores would become the
// limit. Design: a block owns SM_ROWS weight rows (output columns) and SM_BM rows of x and walks
// all of K inside the block, which takes the place of the TPU's sequential grid. Each thread
// loads 16 bytes (32 codes) of each of its rows per step, coalesced along K, and unpacks them in
// registers. The 32 codes lie in one group (gs % 32 == 0), so the thread accumulates x . c and
// sum(x) over them in float32 and applies s_g and z_g in registers. x is tiny next to the
// weights and stays in L1/L2. A block-wide reduction sums the threads' partial outputs.
// ---------------------------------------------------------------------------------------------
constexpr int SM_THREADS = 128;
constexpr int SM_ROWS = 4;
constexpr int SM_BM = 4;

template <typename T>
__global__ void __launch_bounds__(SM_THREADS) qbits_mm_small_m_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    T* __restrict__ out, int M, int N, int K, int gs) {
  const int n0 = blockIdx.x * SM_ROWS;
  const int m0 = blockIdx.y * SM_BM;
  const int rows_m = min(SM_BM, M - m0);
  const size_t kp = (size_t)K / 2;
  const int nchunks = K / 32;

  float y[SM_ROWS][SM_BM];
#pragma unroll
  for (int r = 0; r < SM_ROWS; ++r)
#pragma unroll
    for (int m = 0; m < SM_BM; ++m) y[r][m] = 0.f;

  for (int c = threadIdx.x; c < nchunks; c += SM_THREADS) {
    const int k0 = c * 32;
    uint32_t w[SM_ROWS][4];
#pragma unroll
    for (int r = 0; r < SM_ROWS; ++r) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(packed + (size_t)(n0 + r) * kp) + c);
      w[r][0] = v.x;
      w[r][1] = v.y;
      w[r][2] = v.z;
      w[r][3] = v.w;
    }
    float dot[SM_ROWS][SM_BM];
    float xs[SM_BM];
#pragma unroll
    for (int m = 0; m < SM_BM; ++m) {
      xs[m] = 0.f;
#pragma unroll
      for (int r = 0; r < SM_ROWS; ++r) dot[r][m] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // 8 codes per 32-bit word
      float cf[SM_ROWS][8];
#pragma unroll
      for (int r = 0; r < SM_ROWS; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) cf[r][i] = code_to_float((w[r][q] >> (4 * i)) & 0xFu);
#pragma unroll
      for (int m = 0; m < SM_BM; ++m) {
        if (m < rows_m) {
          float xf[8];
          load8(x + (size_t)(m0 + m) * K + k0 + 8 * q, xf);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            xs[m] += xf[i];
#pragma unroll
            for (int r = 0; r < SM_ROWS; ++r) dot[r][m] = fmaf(xf[i], cf[r][i], dot[r][m]);
          }
        }
      }
    }
    const size_t g = (size_t)(k0 / gs);
#pragma unroll
    for (int r = 0; r < SM_ROWS; ++r) {
      const float s = __ldg(scale_t + g * N + n0 + r);
      const float z = __ldg(shift_t + g * N + n0 + r);
#pragma unroll
      for (int m = 0; m < SM_BM; ++m) y[r][m] += s * dot[r][m] - z * xs[m];
    }
  }

  __shared__ float red[SM_THREADS / 32][SM_ROWS * SM_BM];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < SM_ROWS; ++r) {
#pragma unroll
    for (int m = 0; m < SM_BM; ++m) {
      float v = y[r][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][r * SM_BM + m] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < SM_ROWS * SM_BM) {
    const int r = threadIdx.x / SM_BM;
    const int m = threadIdx.x % SM_BM;
    if (m < rows_m) {
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < SM_THREADS / 32; ++wi) v += red[wi][threadIdx.x];
      store1(out + (size_t)(m0 + m) * N + n0 + r, v);
    }
  }
}

// ---------------------------------------------------------------------------------------------
// qbits_mm_tiled (M > 512).
//
// Replaces quanto_tpu/ops/pallas/qbits_mm.py:_prefill_kernel, the TPU prefill kernel.
// Bound on this card by operations: at M = 4096 each weight code is used 4096 times. Design:
// a block owns a TL_BM x TL_BN output tile and loops over K in TL_BK steps inside the block
// (the TPU's "arbitrary" K grid axis has no counterpart across blocks). Each step stages the x
// tile and the weight tile in shared memory as bfloat16: codes are unpacked to bfloat16, which
// is exact for int4, and float32 x is split into a bfloat16 high part and a bfloat16 low part
// (two products), so the tensor cores see float32 x to about 16 bits. mma.sync m16n8k16 sums
// x . c in float32 per group; at each group's end the per-group epilogue
// y += s_g * acc - (sum x_g) * z_g runs in registers, with sum x_g taken from the staged
// values' float32 sums. No wgmma, TMA or pipelining yet: right and simple first.
// ---------------------------------------------------------------------------------------------
constexpr int TL_BM = 128;
constexpr int TL_BN = 128;
constexpr int TL_BK = 64;
constexpr int TL_THREADS = 256;
constexpr int TL_LD = TL_BK + 8;  // padded shared-memory row (bf16 elements): no bank conflicts
constexpr int TL_MT = 4;          // m16 tiles per warp (warp tile 64 x 32)
constexpr int TL_NT = 4;          // n8 tiles per warp

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

template <typename T>
constexpr size_t tiled_smem_bytes() {
  return (size_t)(XPlanes<T>::n * TL_BM + TL_BN) * TL_LD * sizeof(__nv_bfloat16) +
         TL_BM * sizeof(float);
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

// Stage 32 consecutive codes (16 packed bytes) of one weight row as bf16.
__device__ __forceinline__ void stage_w32(const uint8_t* src, __nv_bfloat16* dst) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // byte j of word q holds codes 8q + 2j (low) and 8q + 2j + 1
      const uint32_t lo = (words[q] >> (8 * j)) & 0xFu;
      const uint32_t hi = (words[q] >> (8 * j + 4)) & 0xFu;
      reinterpret_cast<__nv_bfloat162*>(dst)[4 * q + j] =
          __floats2bfloat162_rn(code_to_float(lo), code_to_float(hi));
    }
  }
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

// A fragments of the m16 tiles of one x plane at column ks.
__device__ __forceinline__ void load_a(const __nv_bfloat16* plane, int row0, int ks, int gid,
                                       int tig, uint32_t (&a)[TL_MT][4]) {
#pragma unroll
  for (int mt = 0; mt < TL_MT; ++mt) {
    const __nv_bfloat16* p = plane + (row0 + mt * 16 + gid) * TL_LD + ks + tig * 2;
    a[mt][0] = ld32(p);
    a[mt][1] = ld32(p + 8 * TL_LD);
    a[mt][2] = ld32(p + 8);
    a[mt][3] = ld32(p + 8 * TL_LD + 8);
  }
}

template <typename T>
__global__ void __launch_bounds__(TL_THREADS, 1) qbits_mm_tiled_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    T* __restrict__ out, int M, int N, int K, int gs) {
  constexpr int P = XPlanes<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* x_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* x_lo = x_hi + TL_BM * TL_LD;  // used only when P == 2
  __nv_bfloat16* w_s = x_hi + P * TL_BM * TL_LD;
  float* xsum = reinterpret_cast<float*>(w_s + TL_BN * TL_LD);

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
  const T* x_src = x + (size_t)(x_valid ? m0 + srow : 0) * K + shalf * 32;
  const uint8_t* w_src = packed + (size_t)(n0 + srow) * (K / 2) + shalf * 16;
  __nv_bfloat16* x_hi_dst = x_hi + srow * TL_LD + shalf * 32;
  __nv_bfloat16* x_lo_dst = x_lo + srow * TL_LD + shalf * 32;
  __nv_bfloat16* w_dst = w_s + srow * TL_LD + shalf * 32;

  float acc[TL_MT][TL_NT][4];
  float y[TL_MT][TL_NT][4];
#pragma unroll
  for (int mt = 0; mt < TL_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL_NT; ++nt)
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
    float part = stage_x32(x_src + kbase, x_valid, x_hi_dst, x_lo_dst);
    stage_w32(w_src + kbase / 2, w_dst);
    part += __shfl_xor_sync(0xffffffffu, part, 1);  // the other half of the row
    gsum += part;
    if (group_end) {
      if (shalf == 0) xsum[srow] = gsum;
      gsum = 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < TL_BK; ks += 16) {
      uint32_t a[TL_MT][4];
      uint32_t b[TL_NT][2];
#pragma unroll
      for (int nt = 0; nt < TL_NT; ++nt) {
        const __nv_bfloat16* p = w_s + (warp_n * 32 + nt * 8 + gid) * TL_LD + ks + tig * 2;
        b[nt][0] = ld32(p);
        b[nt][1] = ld32(p + 8);
      }
      load_a(x_hi, warp_m * 64, ks, gid, tig, a);
#pragma unroll
      for (int mt = 0; mt < TL_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < TL_NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      if constexpr (P == 2) {
        load_a(x_lo, warp_m * 64, ks, gid, tig, a);
#pragma unroll
        for (int mt = 0; mt < TL_MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < TL_NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
    }

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
  for (int mt = 0; mt < TL_MT; ++mt) {
    const int r = m0 + warp_m * 64 + mt * 16 + gid;
#pragma unroll
    for (int nt = 0; nt < TL_NT; ++nt) {
      const int col = n0 + warp_n * 32 + nt * 8 + tig * 2;
      if (r < M) store2(out + (size_t)r * N + col, y[mt][nt][0], y[mt][nt][1]);
      if (r + 8 < M) store2(out + (size_t)(r + 8) * N + col, y[mt][nt][2], y[mt][nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------------------------
// qbits_mm_int8_small_m (W4A8, M <= 512).
//
// Replaces quanto_tpu/ops/pallas/qbits_mm.py:_int8_kernel, the TPU W4A8 decode kernel.
// Bound on this card by bytes at decode, as qbits_mm_small_m: each packed weight byte is read
// once and used for M rows of x. Design: qbits_mm_small_m's, with the products on the integer
// dot unit. A block owns I8_ROWS weight rows and I8_BM rows of x and walks all of K; each thread
// loads 16 packed bytes (32 codes) of each of its rows per step. Byte j holds codes 2j (low
// nibble) and 2j + 1 (high nibble), so the low nibbles of a word's four bytes pair with x's even
// positions and the high nibbles with its odd ones: __byte_perm gathers x's even and odd bytes,
// and __dp4a adds four int8 x times four codes (0..15, exact as s8) into an int32 sum of the
// chunk. sum(xq) over the chunk comes from __dp4a against 0x01010101. The 32 codes lie in one
// group, so the thread adds s_g * acc - z_g * sum(xq) in float32 per chunk. A block-wide
// reduction sums the threads' partial outputs; the result is multiplied by sx and stored.
// ---------------------------------------------------------------------------------------------
constexpr int I8_THREADS = 128;
constexpr int I8_ROWS = 4;
constexpr int I8_BM = 8;

template <typename TO>
__global__ void __launch_bounds__(I8_THREADS) qbits_mm_int8_small_m_kernel(
    const int8_t* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale_t, const float* __restrict__ shift_t,
    const float* __restrict__ sx, TO* __restrict__ out, int M, int N, int K, int gs) {
  const int n0 = blockIdx.x * I8_ROWS;
  const int m0 = blockIdx.y * I8_BM;
  const int rows_m = min(I8_BM, M - m0);
  const size_t kp = (size_t)K / 2;
  const int nchunks = K / 32;

  float y[I8_ROWS][I8_BM];
#pragma unroll
  for (int r = 0; r < I8_ROWS; ++r)
#pragma unroll
    for (int m = 0; m < I8_BM; ++m) y[r][m] = 0.f;

  for (int c = threadIdx.x; c < nchunks; c += I8_THREADS) {
    const int k0 = c * 32;
    uint32_t w[I8_ROWS][4];
#pragma unroll
    for (int r = 0; r < I8_ROWS; ++r) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(packed + (size_t)(n0 + r) * kp) + c);
      w[r][0] = v.x;
      w[r][1] = v.y;
      w[r][2] = v.z;
      w[r][3] = v.w;
    }
    int acc[I8_ROWS][I8_BM];
    int xs[I8_BM];
#pragma unroll
    for (int m = 0; m < I8_BM; ++m) {
      xs[m] = 0;
#pragma unroll
      for (int r = 0; r < I8_ROWS; ++r) acc[r][m] = 0;
      if (m < rows_m) {
        const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)(m0 + m) * K + k0);
        const uint4 a = __ldg(xp);
        const uint4 b = __ldg(xp + 1);
        const uint32_t xw[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // packed word q holds codes 8q .. 8q + 7
          const int xe = (int)__byte_perm(xw[2 * q], xw[2 * q + 1], 0x6420);  // x 8q + 0, 2, 4, 6
          const int xo = (int)__byte_perm(xw[2 * q], xw[2 * q + 1], 0x7531);  // x 8q + 1, 3, 5, 7
          xs[m] = __dp4a((int)xw[2 * q], 0x01010101, xs[m]);
          xs[m] = __dp4a((int)xw[2 * q + 1], 0x01010101, xs[m]);
#pragma unroll
          for (int r = 0; r < I8_ROWS; ++r) {
            acc[r][m] = __dp4a((int)(w[r][q] & 0x0F0F0F0Fu), xe, acc[r][m]);
            acc[r][m] = __dp4a((int)((w[r][q] >> 4) & 0x0F0F0F0Fu), xo, acc[r][m]);
          }
        }
      }
    }
    const size_t g = (size_t)(k0 / gs);
#pragma unroll
    for (int r = 0; r < I8_ROWS; ++r) {
      const float s = __ldg(scale_t + g * N + n0 + r);
      const float z = __ldg(shift_t + g * N + n0 + r);
#pragma unroll
      for (int m = 0; m < I8_BM; ++m) y[r][m] += s * (float)acc[r][m] - z * (float)xs[m];
    }
  }

  __shared__ float red[I8_THREADS / 32][I8_ROWS * I8_BM];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < I8_ROWS; ++r) {
#pragma unroll
    for (int m = 0; m < I8_BM; ++m) {
      float v = y[r][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][r * I8_BM + m] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < I8_ROWS * I8_BM) {
    const int r = threadIdx.x / I8_BM;
    const int m = threadIdx.x % I8_BM;
    if (m < rows_m) {
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < I8_THREADS / 32; ++wi) v += red[wi][threadIdx.x];
      store1(out + (size_t)(m0 + m) * N + n0 + r, v * __ldg(sx));
    }
  }
}

// ---------------------------------------------------------------------------------------------
// qbits_mm_tiled_int8 (W4A8, M > 512).
//
// Replaces the integer arm of quanto_tpu/ops/pallas/qbits_mm.py:_prefill_kernel (int8 x
// against int4 codes on the TPU's integer matrix unit). Bound on this card by operations at
// prompt lengths. Design: qbits_mm_tiled's, with mma.sync m16n8k32 s8 x s8 -> s32. Each K step
// stages the int8 x tile as it is and the weight tile as one int8 code per byte (exact), so no
// bf16 split is needed; the int32 accumulator is exact within a group, and at each group's end
// the epilogue y += s_g * acc - z_g * sum(xq_g) runs in float32 registers, with sum(xq_g) summed
// as int32 by the staging threads (__dp4a against 0x01010101). The result is multiplied by sx.
// No wgmma, TMA or pipelining yet: right and simple first.
// ---------------------------------------------------------------------------------------------
constexpr int TI_LD = TL_BK + 16;  // padded shared-memory row, in bytes: no bank conflicts

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename TO>
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
  const uint8_t* w_src = packed + (size_t)(n0 + srow) * (K / 2) + shalf * 16;
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
    // 16 packed bytes -> 32 codes, one per byte, in K order.
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(w_src + kbase / 2));
    const uint32_t pw[4] = {v.x, v.y, v.z, v.w};
    uint32_t cw[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo = pw[q] & 0x0F0F0F0Fu;         // codes 8q + 0, 2, 4, 6
      const uint32_t hi = (pw[q] >> 4) & 0x0F0F0F0Fu;  // codes 8q + 1, 3, 5, 7
      cw[2 * q] = __byte_perm(lo, hi, 0x5140);
      cw[2 * q + 1] = __byte_perm(lo, hi, 0x7362);
    }
    reinterpret_cast<uint4*>(w_dst)[0] = make_uint4(cw[0], cw[1], cw[2], cw[3]);
    reinterpret_cast<uint4*>(w_dst)[1] = make_uint4(cw[4], cw[5], cw[6], cw[7]);
    part += __shfl_xor_sync(0xffffffffu, part, 1);  // the other half of the row
    gsum += part;
    if (group_end) {
      if (shalf == 0) xsum[srow] = gsum;
      gsum = 0;
    }
    __syncthreads();

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

template <typename T>
int launch_small_m(const void* x, const void* packed, const void* scale_t, const void* shift_t,
                   void* out, int M, int N, int K, int gs, cudaStream_t stream) {
  const dim3 grid(N / SM_ROWS, (M + SM_BM - 1) / SM_BM);
  qbits_mm_small_m_kernel<T><<<grid, SM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale_t), static_cast<const float*>(shift_t),
      static_cast<T*>(out), M, N, K, gs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tiled(const void* x, const void* packed, const void* scale_t, const void* shift_t,
                 void* out, int M, int N, int K, int gs, cudaStream_t stream) {
  constexpr size_t smem = tiled_smem_bytes<T>();
  const cudaError_t e = cudaFuncSetAttribute(
      qbits_mm_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / TL_BN, (M + TL_BM - 1) / TL_BM);
  qbits_mm_tiled_kernel<T><<<grid, TL_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale_t), static_cast<const float*>(shift_t),
      static_cast<T*>(out), M, N, K, gs);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_int8(bool tiled, const void* x, const void* packed, const void* scale_t,
                const void* shift_t, const void* sx, void* out, int M, int N, int K, int gs,
                cudaStream_t stream) {
  const int8_t* xi = static_cast<const int8_t*>(x);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scale_t);
  const float* z = static_cast<const float*>(shift_t);
  const float* sxp = static_cast<const float*>(sx);
  TO* o = static_cast<TO*>(out);
  if (tiled) {
    const dim3 grid(N / TL_BN, (M + TL_BM - 1) / TL_BM);
    qbits_mm_tiled_int8_kernel<TO><<<grid, TL_THREADS, 0, stream>>>(xi, p, s, z, sxp, o, M, N, K, gs);
  } else {
    const dim3 grid(N / I8_ROWS, (M + I8_BM - 1) / I8_BM);
    qbits_mm_int8_small_m_kernel<TO><<<grid, I8_THREADS, 0, stream>>>(xi, p, s, z, sxp, o, M, N, K, gs);
  }
  return (int)cudaGetLastError();
}

int int8_entry(bool tiled, int device, const void* x, const void* packed, const void* scale_t,
               const void* shift_t, const void* sx, void* out, int M, int N, int K, int gs,
               int out_bf16, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16
             ? launch_int8<__nv_bfloat16>(tiled, x, packed, scale_t, shift_t, sx, out, M, N, K, gs, s)
             : launch_int8<float>(tiled, x, packed, scale_t, shift_t, sx, out, M, N, K, gs, s);
}

}  // namespace

// W4A8 entry points: x int8 [M, K], sx float32 scalar on the device; out_bf16: 1 when out is
// bfloat16, 0 when it is float32.
extern "C" int qbits_mm_int8_small_m(int device, const void* x, const void* packed,
                                     const void* scale_t, const void* shift_t, const void* sx,
                                     void* out, int M, int N, int K, int gs, int out_bf16,
                                     void* stream) {
  return int8_entry(false, device, x, packed, scale_t, shift_t, sx, out, M, N, K, gs, out_bf16,
                    stream);
}

extern "C" int qbits_mm_tiled_int8(int device, const void* x, const void* packed,
                                   const void* scale_t, const void* shift_t, const void* sx,
                                   void* out, int M, int N, int K, int gs, int out_bf16,
                                   void* stream) {
  return int8_entry(true, device, x, packed, scale_t, shift_t, sx, out, M, N, K, gs, out_bf16,
                    stream);
}

// x_bf16: 1 when x and out are bfloat16, 0 when they are float32.
extern "C" int qbits_mm_small_m(int device, const void* x, const void* packed, const void* scale_t,
                                const void* shift_t, void* out, int M, int N, int K, int gs,
                                int x_bf16, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_small_m<__nv_bfloat16>(x, packed, scale_t, shift_t, out, M, N, K, gs, s)
                : launch_small_m<float>(x, packed, scale_t, shift_t, out, M, N, K, gs, s);
}

extern "C" int qbits_mm_tiled(int device, const void* x, const void* packed, const void* scale_t,
                              const void* shift_t, void* out, int M, int N, int K, int gs,
                              int x_bf16, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_tiled<__nv_bfloat16>(x, packed, scale_t, shift_t, out, M, N, K, gs, s)
                : launch_tiled<float>(x, packed, scale_t, shift_t, out, M, N, K, gs, s);
}
