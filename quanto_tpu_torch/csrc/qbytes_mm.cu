// Fused 8-bit weight-only matmul for Hopper (sm_90a).
//
//   y[m, n] = scale[n] * sum_k x[m, k] * w[n, k]      (M <= 256)
//
// Replaces quanto_tpu/ops/pallas/qbytes_mm.py:_kernel (int8 payload) and :_fp8_kernel (float8
// e4m3fn payload): float32 sums, the per-output-channel scale applied to the output in float32,
// output in x's dtype (bfloat16 or float32). The scale is read in its stored dtype (bfloat16 or
// float32).
//
// Layout: x [M, K] row-major; w [N, K] row-major (torch linear convention, K-contiguous: one
// 16-byte load is 16 consecutive K values of one row); scale [N] (the [N, 1] keepdim scale).
//
// Bound on this card. At decode (M = 4) by bytes: every weight byte is read once and used for
// M rows, far below the ~295 operations per byte where the tensor cores would become the limit.
// At M = 256 the operations approach that line.
//
// Design. The TPU kernel keeps all of x in VMEM and one [BN, K] weight tile; on Hopper x can be
// megabytes (M = 256, K = 14336: 7.3 MB) against 227 KB of shared memory, so nothing is staged:
// each warp reads its x rows straight through L1/L2 and its weight bytes straight from device
// memory, and the products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums) for
// every M, with the weight converted to bf16 in registers (exact for int8 and e4m3fn). Lane
// (gid, tig) of a warp loads 16 consecutive bytes, k = kb + 16 tig .. kb + 16 tig + 15, of
// weight row gid: four lanes cover 64 contiguous bytes of a row per step. The four mma k16
// steps of that 64-wide chunk take the lane's own 16 values in order; the fragment's logical
// k positions (2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9) map to physical k = kb + 16 tig + 4 j +
// (0, 1, 2, 3) in mma step j, for x and w alike, so the sum over the chunk is unchanged. The
// warps of a block split K (chunk c goes to warp c mod KSPLIT) and add their partial tiles
// through shared memory at the end; the block's output tile is then scaled and stored. Two
// tilings: M <= 16 takes one m16 x n8 tile per warp and 8 warps per block (decode: enough
// blocks and bytes in flight to stream the weights); larger M takes 64 x 32 per warp and 4
// warps, so each weight byte is converted once per 64 rows of x. float32 x enters as a bf16
// high and low part (two products), as the tiled body of csrc/qbits_mm.cuh does.
//
// int8 codes convert by 0x4B000000 | (c + 128), the float 2^23 + 128 + c exactly, minus that
// bias. e4m3fn codes convert through the hardware (cuda_fp8.h) to f16, exactly; the NaN codes
// 0x7F and 0xFF give NaN here where the TPU kernel's integer decode gives +-480. The quantizer
// never produces them: it clips to +-448 before the cast.
//
// The entry point has a plain C interface (bound with ctypes in ops/cuda/qbytes_mm.py). It
// launches on the stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;  // K values of one warp step: 16 bytes per lane, 4 lanes per row

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Eight weight bytes (two words, memory order) -> four bf16x2 registers: d[i] = (w[2i], w[2i+1]).
template <bool E4M3>
__device__ __forceinline__ void decode8(uint32_t w0, uint32_t w1, uint32_t (&d)[4]);

template <>
__device__ __forceinline__ void decode8<false>(uint32_t w0, uint32_t w1, uint32_t (&d)[4]) {
  const uint32_t words[2] = {w0 ^ 0x80808080u, w1 ^ 0x80808080u};  // c -> c + 128 in [0, 255]
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(words[q], 0x4B000000u, 0x7440 + i)) - 8388736.0f;
    d[2 * q] = pack_bf16(f[0], f[1]);
    d[2 * q + 1] = pack_bf16(f[2], f[3]);
  }
}

template <>
__device__ __forceinline__ void decode8<true>(uint32_t w0, uint32_t w1, uint32_t (&d)[4]) {
  const uint32_t words[2] = {w0, w1};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(words[q] >> (16 * i)), __NV_E4M3);
      const float2 f = __half22float2(__half2(r));
      d[2 * q + i] = pack_bf16(f.x, f.y);
    }
  }
}

// Eight consecutive x values of one row as bf16x2 pairs: hi[i] = (x[2i], x[2i+1]); lo the
// float32 residues (float32 x only).
__device__ __forceinline__ void load_x8(const __nv_bfloat16* p, bool valid, uint32_t (&hi)[4],
                                        uint32_t (&)[4]) {
  const uint4 v = valid ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
  hi[0] = v.x;
  hi[1] = v.y;
  hi[2] = v.z;
  hi[3] = v.w;
}

__device__ __forceinline__ void load_x8(const float* p, bool valid, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (valid) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(f[2 * i] - hf.x, f[2 * i + 1] - hf.y);
  }
}

template <typename T>
struct XPlanes {
  static constexpr int n = 1;
};
template <>
struct XPlanes<float> {
  static constexpr int n = 2;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// MT m16 tiles x NT n8 tiles per warp, KSPLIT warps per block splitting K.
template <typename TX, typename TS, bool E4M3, int MT, int NT, int KSPLIT>
__global__ void __launch_bounds__(KSPLIT * 32) qbytes_mm_kernel(
    const TX* __restrict__ x, const uint8_t* __restrict__ w, const TS* __restrict__ scale,
    TX* __restrict__ out, int M, int N, int K) {
  constexpr int P = XPlanes<TX>::n;
  constexpr int NACC = MT * NT * 4;
  __shared__ float red[KSPLIT][NACC][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n0 = blockIdx.x * (NT * 8);
  const int m0 = blockIdx.y * (MT * 16);
  const int nchunks = K / CHUNK;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int c = warp; c < nchunks; c += KSPLIT) {
    const size_t kl = (size_t)c * CHUNK + tig * 16;  // this lane's 16 K positions
    uint4 wv[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      wv[nt] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(n0 + nt * 8 + gid) * K + kl));
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // lane offsets 8h .. 8h + 7: mma steps j = 2h, 2h + 1
      uint32_t b[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        decode8<E4M3>(h ? wv[nt].z : wv[nt].x, h ? wv[nt].w : wv[nt].y, b[nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = m0 + mt * 16 + gid;
        uint32_t hi0[4], lo0[4], hi1[4], lo1[4];
        load_x8(x + (size_t)(r0 < M ? r0 : 0) * K + kl + 8 * h, r0 < M, hi0, lo0);
        load_x8(x + (size_t)(r0 + 8 < M ? r0 + 8 : 0) * K + kl + 8 * h, r0 + 8 < M, hi1, lo1);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const uint32_t a[4] = {hi0[2 * jj], hi1[2 * jj], hi0[2 * jj + 1], hi1[2 * jj + 1]};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, &b[nt][2 * jj]);
          if constexpr (P == 2) {
            const uint32_t al[4] = {lo0[2 * jj], lo1[2 * jj], lo0[2 * jj + 1], lo1[2 * jj + 1]};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], al, &b[nt][2 * jj]);
          }
        }
      }
    }
  }

  // Add the KSPLIT partial tiles, scale by column and store.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[warp][(mt * NT + nt) * 4 + i][lane] = acc[mt][nt][i];
  __syncthreads();
  for (int e = threadIdx.x; e < NACC * 32; e += KSPLIT * 32) {
    const int idx = e >> 5;
    const int l = e & 31;
    const int i = idx & 3;
    const int nt = (idx >> 2) % NT;
    const int mt = (idx >> 2) / NT;
    const int row = m0 + mt * 16 + (l >> 2) + 8 * (i >> 1);
    const int col = n0 + nt * 8 + (l & 3) * 2 + (i & 1);
    if (row < M) {
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < KSPLIT; ++wi) v += red[wi][idx][l];
      store1(out + (size_t)row * N + col, v * to_float(scale[col]));
    }
  }
}

template <typename TX, typename TS, bool E4M3, int MT, int NT, int KSPLIT>
int launch_cfg(const void* x, const void* w, const void* scale, void* out, int M, int N, int K,
               cudaStream_t stream) {
  const dim3 grid(N / (NT * 8), (M + MT * 16 - 1) / (MT * 16));
  qbytes_mm_kernel<TX, TS, E4M3, MT, NT, KSPLIT><<<grid, KSPLIT * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(w), static_cast<const TS*>(scale),
      static_cast<TX*>(out), M, N, K);
  return (int)cudaGetLastError();
}

template <typename TX, typename TS, bool E4M3>
int launch(const void* x, const void* w, const void* scale, void* out, int M, int N, int K,
           cudaStream_t stream) {
  if (M <= 16) return launch_cfg<TX, TS, E4M3, 1, 1, 8>(x, w, scale, out, M, N, K, stream);
  return launch_cfg<TX, TS, E4M3, 4, 4, 4>(x, w, scale, out, M, N, K, stream);
}

template <typename TX, typename TS>
int launch_payload(int e4m3, const void* x, const void* w, const void* scale, void* out, int M,
                   int N, int K, cudaStream_t s) {
  return e4m3 ? launch<TX, TS, true>(x, w, scale, out, M, N, K, s)
              : launch<TX, TS, false>(x, w, scale, out, M, N, K, s);
}

}  // namespace

// x_bf16: 1 when x and out are bfloat16, 0 when float32; scale_bf16 likewise for the scale;
// w_e4m3: 1 for a float8 e4m3fn payload, 0 for int8.
extern "C" int qbytes_mm(int device, const void* x, const void* w, const void* scale, void* out,
                         int M, int N, int K, int x_bf16, int scale_bf16, int w_e4m3,
                         void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return scale_bf16
               ? launch_payload<__nv_bfloat16, __nv_bfloat16>(w_e4m3, x, w, scale, out, M, N, K, s)
               : launch_payload<__nv_bfloat16, float>(w_e4m3, x, w, scale, out, M, N, K, s);
  return scale_bf16 ? launch_payload<float, __nv_bfloat16>(w_e4m3, x, w, scale, out, M, N, K, s)
                    : launch_payload<float, float>(w_e4m3, x, w, scale, out, M, N, K, s);
}
