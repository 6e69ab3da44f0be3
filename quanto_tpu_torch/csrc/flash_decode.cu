// Split-S flash decoding for Hopper (sm_90a): single-token grouped-query attention over a float
// or quantized KV cache.
//
// Replaces the three TPU decode-attention kernels of the JAX package, which compute one function
// and differ only in how they block for VMEM and the (8, 128) tiling:
//   quanto_tpu/ops/pallas/flash_decode.py:53   _kernel (v1, head-group blocks)
//   quanto_tpu/ops/pallas/flash_decode2.py:44  _kernel (v2, full-row [S, Hkv*D] blocks)
//   quanto_tpu/ops/pallas/flash_decode3.py:36  _kernel (v3, online softmax over S chunks)
//
// For batch row b, KV head h and query g, over the slots s <= pos[b]:
//   logit[s] = ((q . c_k[s]) * s_k[s] + (sum_d q) * m_k[s]) / sqrt(D)
//   out      = sum_s p[s] * (s_v[s] * c_v[s] + m_v[s]) / sum_s p[s],   p[s] = exp(logit[s] - max)
// with c the stored codes (or the float values of a float cache), s the per-slot scales and m
// the per-slot shifts of the asymmetric specs. The scales and shifts are factored out of the
// dots as in quanto_tpu/ops/attention.py:gqa_attention, so the payload is decoded, never
// dequantized into memory. Softmax and sums are float32 (exponentials by __expf, a few ulp);
// the softmax is normalised once, at the end, as in v3; the output is cast to q's dtype.
//
// Cache layout (quanto_tpu_torch/tensor/kv_cache.py): payload [B, S, Hkv, D] as float32,
// bfloat16, int8 or float8 (decoded through a 256-entry table of the format's values), or int4
// as uint8 [B, S, Hkv, D/2] with code 2j + 8 in the low nibble of byte j and code 2j + 1 + 8 in
// its high nibble; scales and shifts float32 [B, S, Hkv, 1] (one float per slot and head, so the
// kernel gathers them with a stride of Hkv floats; they are 1/32 of an int4 row's bytes).
//
// Bound on this card by bytes: at B = 4, S = 8192, Hkv = 8, D = 128 a layer's call does about
// 0.54 GFLOP against 35.7 MB of an int4 cache, 15 operations per byte, far below the ~295 at which
// the tensor cores would be the limit. So the dots run on CUDA cores and the design is about
// reading every byte once with wide coalesced loads and enough of them in flight:
// - Split S. On the TPU, v3 walks the S chunks of one (b, h) in order on one core, carrying
//   (m, l, acc) in VMEM. Here B * Hkv = 32 blocks would leave 100 of the 132 SMs idle, so pass 1
//   runs a grid (B * Hkv * ceil(G / 4), n_split): each block owns up to 4 query rows of one KV
//   head and one contiguous range of slots. plan_splits picks n_split so that the grid fills
//   one wave of MIN_BLOCKS blocks per SM, the most the registers allow (a partial second wave
//   costs more than longer ranges do). A block whose range lies past pos[b] writes an empty
//   partial (m = -inf, l = 0) and reads nothing.
// - Inside a block, a slot row is read by D / 8 neighbouring lanes, each taking 8 elements
//   of the head dim in one load (32 B of float32, 16 B of bf16, 8 B of int8/fp8, 4 B of int4),
//   so 2 (D = 128) or 4 (D = 64) slots go through each warp per step and every lane owns the
//   same 8 output columns throughout. Each group of D / 8 lanes runs its own online softmax over
//   its slots (slot s0 + i * groups + grp), U slots per step, all loads of a step issued before
//   their first use. The groups are merged through shared memory at the end of the block.
// - Pass 2 (a second kernel, launched by the same C call) merges the n_split partials of each
//   query row, divides by the softmax sum and writes the output.
//
// The entry points have a plain C interface (bound with ctypes in ops/cuda/flash_decode.py).
// flash_decode_workspace gives the size of the float32 workspace the wrapper allocates;
// flash_decode launches both kernels on the stream it is given, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

enum PayloadType { F32 = 0, BF16 = 1, I8 = 2, I4 = 3, FP8 = 4 };
// Scale and shift modes: a float cache has neither, a symmetric spec scales, "...a" specs shift.
enum Mode { NONE = 0, SCALED = 1, SHIFTED = 2 };

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 3;  // blocks per SM the register budget allows
constexpr int WARPS = THREADS / 32;
constexpr int GB = 4;   // query rows per block
constexpr int EPL = 8;  // head-dim elements per lane
constexpr int MIN_SPLIT_LEN = 64;  // fewest slots per split

// One lane's 8 elements of a slot row: the raw load and its decode to float.
template <int T>
struct Raw;

template <>
struct Raw<F32> {
  static constexpr int kBytes = 32;
  float4 a, b;
  __device__ __forceinline__ void load(const uint8_t* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void decode(float* f, const float*) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

template <>
struct Raw<BF16> {
  static constexpr int kBytes = 16;
  uint4 w;
  __device__ __forceinline__ void load(const uint8_t* p) { w = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void decode(float* f, const float*) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

// An unsigned integer u < 2^23 as a float: 0x4B000000 | u is the float 2^23 + u exactly, so a code
// decodes with one logic op and one add instead of a (quarter-rate) integer-to-float conversion.
__device__ __forceinline__ float biased_to_float(uint32_t u, float bias) {
  return __uint_as_float(0x4B000000u | u) - (8388608.0f + bias);
}

template <>
struct Raw<I8> {
  static constexpr int kBytes = 8;
  uint2 w;
  __device__ __forceinline__ void load(const uint8_t* p) { w = *reinterpret_cast<const uint2*>(p); }
  // Byte b holds a two's-complement code; b ^ 0x80 is the code + 128.
  __device__ __forceinline__ void decode(float* f, const float*) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = biased_to_float(((w.x >> (8 * i)) & 0xFFu) ^ 0x80u, 128.0f);
      f[4 + i] = biased_to_float(((w.y >> (8 * i)) & 0xFFu) ^ 0x80u, 128.0f);
    }
  }
};

template <>
struct Raw<I4> {
  static constexpr int kBytes = 4;
  uint32_t w;
  __device__ __forceinline__ void load(const uint8_t* p) { w = *reinterpret_cast<const uint32_t*>(p); }
  // Element i is nibble i of the little-endian word (low nibble first), stored as code + 8.
  __device__ __forceinline__ void decode(float* f, const float*) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = biased_to_float((w >> (4 * i)) & 0xFu, 8.0f);
  }
};

template <>
struct Raw<FP8> {
  static constexpr int kBytes = 8;
  uint2 w;
  __device__ __forceinline__ void load(const uint8_t* p) { w = *reinterpret_cast<const uint2*>(p); }
  // `lut` holds the 256 values of the float8 format in shared memory.
  __device__ __forceinline__ void decode(float* f, const float* lut) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = lut[(w.x >> (8 * i)) & 0xFFu];
      f[4 + i] = lut[(w.y >> (8 * i)) & 0xFFu];
    }
  }
};

// Bytes of a slot row of D elements.
template <int T, int D>
__host__ __device__ constexpr int row_bytes() {
  return T == I4 ? D / 2 : D * (T == F32 ? 4 : T == BF16 ? 2 : 1);
}

// Slots per lane group and step: up to 64 payload bytes in flight per lane, 2 to 4 slots. Four
// slots keep a step's registers under the 168 a thread may hold at 3 blocks per SM.
template <int KT, int VT>
__host__ __device__ constexpr int unroll() {
  constexpr int u = 64 / (Raw<KT>::kBytes + Raw<VT>::kBytes);
  return u < 2 ? 2 : (u > 4 ? 4 : u);
}

struct Args {
  const void* q;
  const uint8_t* k;
  const uint8_t* v;
  const float* k_scale;
  const float* v_scale;
  const float* k_shift;
  const float* v_shift;
  const int* pos;
  const float* k_lut;
  const float* v_lut;
  float* ws_ml;   // [B * Hkv * G, n_split] (m, l) pairs
  float* ws_acc;  // [B * Hkv * G, n_split, D]
  void* out;
  int B, Hkv, G, S, D, n_split, split_len, k_type, v_type, mode, q_bf16;
  float scale;
};

// (n_split, split_len): as many slot ranges as fill one wave of MIN_BLOCKS blocks per SM with the
// grid of pass 1, each range at least MIN_SPLIT_LEN slots.
cudaError_t plan_splits(int device, int B, int Hkv, int G, int S, int* n_split, int* split_len) {
  int sms = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int blocks_per_split = B * Hkv * ((G + GB - 1) / GB);
  const int n = std::max(1, std::min(MIN_BLOCKS * sms / blocks_per_split,
                                     (S + MIN_SPLIT_LEN - 1) / MIN_SPLIT_LEN));
  *split_len = (S + n - 1) / n;
  *n_split = (S + *split_len - 1) / *split_len;
  return cudaSuccess;
}

// Pass 1: one block per (b, h, 4 query rows) and range of split_len slots.
template <int KT, int VT, int MODE, int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) flash_decode_split_kernel(const Args a) {
  constexpr int L = D / EPL;          // lanes per slot row
  constexpr int SPW = 32 / L;         // slot rows per warp and step
  constexpr int NGRP = WARPS * SPW;   // lane groups per block
  constexpr int U = unroll<KT, VT>();

  __shared__ float lut_k[KT == FP8 ? 256 : 1];
  __shared__ float lut_v[VT == FP8 ? 256 : 1];
  __shared__ float s_m[NGRP][GB];
  __shared__ float s_l[NGRP][GB];
  __shared__ __align__(16) float s_acc[NGRP][GB][D];

  const int ngb = (a.G + GB - 1) / GB;
  const int bh = blockIdx.x / ngb;
  const int g0 = (blockIdx.x % ngb) * GB;
  const int b = bh / a.Hkv;
  const int h = bh % a.Hkv;
  const int split = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int c = lane % L;
  const int grp = (threadIdx.x / 32) * SPW + lane / L;

  const int s_begin = split * a.split_len;
  const int s_end = min(min(s_begin + a.split_len, a.S), a.pos[b] + 1);

  if (s_begin >= s_end) {  // nothing visible in this range: an empty partial
    for (int idx = threadIdx.x; idx < GB * D; idx += THREADS) {
      const int g = g0 + idx / D;
      if (g >= a.G) continue;
      const size_t part = (size_t)(bh * a.G + g) * a.n_split + split;
      a.ws_acc[part * D + idx % D] = 0.0f;
      if (idx % D == 0) {
        a.ws_ml[2 * part] = -CUDART_INF_F;
        a.ws_ml[2 * part + 1] = 0.0f;
      }
    }
    return;
  }

  if (KT == FP8)
    for (int i = threadIdx.x; i < 256; i += THREADS) lut_k[i] = a.k_lut[i];
  if (VT == FP8)
    for (int i = threadIdx.x; i < 256; i += THREADS) lut_v[i] = a.v_lut[i];

  // This lane's 8 columns of the block's query rows, in float32 (zero past G).
  float qr[GB][EPL];
  float qsum[GB];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    const int g = g0 + gi;
    const size_t off = (size_t)(bh * a.G + g) * D + c * EPL;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      float x = 0.0f;
      if (g < a.G)
        x = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[off + i])
                     : static_cast<const float*>(a.q)[off + i];
      qr[gi][i] = x;
    }
    qsum[gi] = 0.0f;
    if (MODE == SHIFTED) {
      float t = 0.0f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) t += qr[gi][i];
#pragma unroll
      for (int o = L / 2; o > 0; o /= 2) t += __shfl_xor_sync(0xffffffffu, t, o);
      qsum[gi] = t;
    }
  }
  if (KT == FP8 || VT == FP8) __syncthreads();

  float m[GB], l[GB], acc[GB][EPL], accm[GB];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    m[gi] = -CUDART_INF_F;
    l[gi] = 0.0f;
    accm[gi] = 0.0f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[gi][i] = 0.0f;
  }

  constexpr int KROW = row_bytes<KT, D>();
  constexpr int VROW = row_bytes<VT, D>();
  const size_t slot0 = (size_t)b * a.S;  // slot index of (b, 0)

  // The loop bounds are the block's, so every lane runs every step and the shuffles below see
  // the full warp: a lane whose slots lie past s_end takes part with masked slots.
  for (int base = s_begin; base < s_end; base += NGRP * U) {
    Raw<KT> rk[U];
    Raw<VT> rv[U];
    float sk[U], sv[U], mk[U], mv[U];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = base + u * NGRP + grp;
      valid[u] = s < s_end;
      sk[u] = sv[u] = 1.0f;
      mk[u] = mv[u] = 0.0f;
      if (valid[u]) {
        const size_t row = (slot0 + s) * a.Hkv + h;
        rk[u].load(a.k + row * KROW + c * Raw<KT>::kBytes);
        rv[u].load(a.v + row * VROW + c * Raw<VT>::kBytes);
        if (MODE != NONE) {
          sk[u] = a.k_scale[row];
          sv[u] = a.v_scale[row];
        }
        if (MODE == SHIFTED) {
          mk[u] = a.k_shift[row];
          mv[u] = a.v_shift[row];
        }
      }
    }

    // Logits: partial dots over this lane's 8 columns, summed over the group's L lanes.
    float lg[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      if (valid[u]) {
        rk[u].decode(kf, lut_k);
      } else {
#pragma unroll
        for (int i = 0; i < EPL; ++i) kf[i] = 0.0f;
      }
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        float t = 0.0f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) t = fmaf(qr[gi][i], kf[i], t);
        lg[u][gi] = t;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int gi = 0; gi < GB; ++gi)
#pragma unroll
        for (int o = L / 2; o > 0; o /= 2) lg[u][gi] += __shfl_xor_sync(0xffffffffu, lg[u][gi], o);

    // Online softmax: rescale the running state once per step, then add the step's slots.
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float t = lg[u][gi];
        if (MODE != NONE) t *= sk[u];
        if (MODE == SHIFTED) t += qsum[gi] * mk[u];
        t *= a.scale;
        t = valid[u] ? t : -CUDART_INF_F;
        lg[u][gi] = t;
        mx = fmaxf(mx, t);
      }
      const float m_new = fmaxf(m[gi], mx);
      // m_new = -inf only for a group with no valid slot in this step and none before.
      const float alpha = m_new == -CUDART_INF_F ? 1.0f : __expf(m[gi] - m_new);
      l[gi] *= alpha;
      accm[gi] *= alpha;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[gi][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = valid[u] ? __expf(lg[u][gi] - m_new) : 0.0f;
        l[gi] += p;
        if (MODE == SHIFTED) accm[gi] = fmaf(p, mv[u], accm[gi]);
        lg[u][gi] = MODE != NONE ? p * sv[u] : p;  // the weight of the slot's codes
      }
      m[gi] = m_new;
    }

    // acc += p * s_v * c_v over the step's slots.
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!valid[u]) continue;
      float vf[EPL];
      rv[u].decode(vf, lut_v);
#pragma unroll
      for (int gi = 0; gi < GB; ++gi)
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[gi][i] = fmaf(lg[u][gi], vf[i], acc[gi][i]);
    }
  }

  // Merge the lane groups of the block.
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    if (c == 0) {
      s_m[grp][gi] = m[gi];
      s_l[grp][gi] = l[gi];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) s_acc[grp][gi][c * EPL + i] = acc[gi][i] + accm[gi];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GB * D; idx += THREADS) {
    const int gi = idx / D, d = idx % D;
    const int g = g0 + gi;
    if (g >= a.G) continue;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NGRP; ++j) mx = fmaxf(mx, s_m[j][gi]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll
    for (int j = 0; j < NGRP; ++j) {
      if (s_m[j][gi] == -CUDART_INF_F) continue;
      const float w = __expf(s_m[j][gi] - mx);
      lsum = fmaf(s_l[j][gi], w, lsum);
      asum = fmaf(s_acc[j][gi][d], w, asum);
    }
    const size_t part = (size_t)(bh * a.G + g) * a.n_split + split;
    a.ws_acc[part * D + d] = asum;
    if (d == 0) {
      a.ws_ml[2 * part] = mx;
      a.ws_ml[2 * part + 1] = lsum;
    }
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Pass 2: one block of D threads per query row merges the row's n_split partials.
template <typename TO>
__global__ void flash_decode_combine_kernel(const Args a) {
  const int row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = a.ws_ml + (size_t)row * a.n_split * 2;
  float mx = -CUDART_INF_F;
#pragma unroll 8
  for (int j = 0; j < a.n_split; ++j) mx = fmaxf(mx, ml[2 * j]);
  float lsum = 0.0f, asum = 0.0f;
#pragma unroll 8
  for (int j = 0; j < a.n_split; ++j) {
    if (ml[2 * j] == -CUDART_INF_F) continue;
    const float w = __expf(ml[2 * j] - mx);
    lsum = fmaf(ml[2 * j + 1], w, lsum);
    asum = fmaf(a.ws_acc[((size_t)row * a.n_split + j) * a.D + d], w, asum);
  }
  store_out(static_cast<TO*>(a.out) + (size_t)row * a.D + d, asum / lsum);
}

template <int KT, int VT, int MODE, int D>
int launch_split(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.Hkv * ((a.G + GB - 1) / GB), a.n_split);
  flash_decode_split_kernel<KT, VT, MODE, D><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KT, int VT, int MODE>
int launch_d(const Args& a, cudaStream_t stream) {
  return a.D == 64 ? launch_split<KT, VT, MODE, 64>(a, stream)
                   : launch_split<KT, VT, MODE, 128>(a, stream);
}

// A float cache is one float type for K and V and has no scales; a quantized cache pairs any
// two code types and has scales, with or without shifts.
template <int KT, int VT>
int launch_mode(const Args& a, cudaStream_t stream) {
  if constexpr (KT == F32 || KT == BF16 || VT == F32 || VT == BF16) {
    if constexpr (KT == VT) {
      if (a.mode == NONE) return launch_d<KT, VT, NONE>(a, stream);
    }
  } else {
    if (a.mode == SCALED) return launch_d<KT, VT, SCALED>(a, stream);
    if (a.mode == SHIFTED) return launch_d<KT, VT, SHIFTED>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int KT>
int launch_v(const Args& a, cudaStream_t stream) {
  switch (a.v_type) {
    case F32: return launch_mode<KT, F32>(a, stream);
    case BF16: return launch_mode<KT, BF16>(a, stream);
    case I8: return launch_mode<KT, I8>(a, stream);
    case I4: return launch_mode<KT, I4>(a, stream);
    case FP8: return launch_mode<KT, FP8>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_k(const Args& a, cudaStream_t stream) {
  switch (a.k_type) {
    case F32: return launch_v<F32>(a, stream);
    case BF16: return launch_v<BF16>(a, stream);
    case I8: return launch_v<I8>(a, stream);
    case I4: return launch_v<I4>(a, stream);
    case FP8: return launch_v<FP8>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// *floats: the float32 elements of flash_decode's workspace for these shapes on `device`,
// B * Hkv * G * n_split * (D + 2).
extern "C" int flash_decode_workspace(int device, int B, int Hkv, int G, int S, int D,
                                      long long* floats) {
  if (B < 1 || Hkv < 1 || G < 1 || S < 1) return (int)cudaErrorInvalidValue;
  int n_split = 0, split_len = 0;
  const cudaError_t e = plan_splits(device, B, Hkv, G, S, &n_split, &split_len);
  if (e != cudaSuccess) return (int)e;
  *floats = (long long)B * Hkv * G * n_split * (D + 2);
  return 0;
}

// k_type / v_type: 0 float32, 1 bfloat16, 2 int8, 3 int4 nibbles, 4 float8 (through k_lut /
// v_lut, 256 float32 values). mode: 0 no scales, 1 scales, 2 scales and shifts. q_bf16: 1 when q
// and out are bfloat16, 0 when they are float32. ws: float32, of flash_decode_workspace's size.
extern "C" int flash_decode(int device, const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale, const void* k_shift,
                            const void* v_shift, const void* positions, const void* k_lut,
                            const void* v_lut, void* ws, void* out, int B, int Hkv, int G, int S,
                            int D, int k_type, int v_type, int mode, int q_bf16, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if ((D != 64 && D != 128) || B < 1 || Hkv < 1 || G < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  int n_split = 0, split_len = 0;
  e = plan_splits(device, B, Hkv, G, S, &n_split, &split_len);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.q = q;
  a.k = static_cast<const uint8_t*>(k);
  a.v = static_cast<const uint8_t*>(v);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.k_shift = static_cast<const float*>(k_shift);
  a.v_shift = static_cast<const float*>(v_shift);
  a.pos = static_cast<const int*>(positions);
  a.k_lut = static_cast<const float*>(k_lut);
  a.v_lut = static_cast<const float*>(v_lut);
  const size_t rows = (size_t)B * Hkv * G;
  a.ws_ml = static_cast<float*>(ws);
  a.ws_acc = a.ws_ml + rows * n_split * 2;
  a.out = out;
  a.B = B; a.Hkv = Hkv; a.G = G; a.S = S; a.D = D;
  a.n_split = n_split; a.split_len = split_len;
  a.k_type = k_type; a.v_type = v_type; a.mode = mode; a.q_bf16 = q_bf16;
  a.scale = (float)(1.0 / std::sqrt((double)D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch_k(a, s);
  if (rc != 0) return rc;
  if (q_bf16)
    flash_decode_combine_kernel<__nv_bfloat16><<<(unsigned)rows, D, 0, s>>>(a);
  else
    flash_decode_combine_kernel<float><<<(unsigned)rows, D, 0, s>>>(a);
  return (int)cudaGetLastError();
}
