// Causal flash-attention forward for Hopper (sm_90a): a prompt's attention to its own keys, from
// position 0, over the raw (pre-quantization) K/V, in one launch.
//
// Replaces the TPU kernel that quanto_tpu/ops/attention.py:206 try_flash_prefill reaches: JAX's
// splash-attention MQA kernel (make_splash_mqa_single_device with a causal mask, vmapped per batch
// row and kv head, :237-265). For batch row b, query head hq = h G + g (kv head h) and position t:
//   s[u]   = qs[b, t, hq] . k[b, u, h]            for u <= t, qs = rnd(q * scale) in q's dtype
//   s[u]   = c * tanh(s[u] / c)                    with a softcap c
//   out    = sum_u exp(s[u] - max) v[b, u, h] / sum_u exp(s[u] - max)
// The scale is folded into q as JAX folds it (:257): in float32, then rounded to q's dtype, so a
// bf16 q at D = 128 (1/sqrt(128)) carries that rounding and one at D = 256 (1/16) none. Logits,
// softmax and sums are float32; the output is cast to q's dtype. q [B, T, H, D], k/v [B, T, Hkv,
// D], out [B, T, H, D] (the caller's [B, T, H * D]); bf16 or float32, D 128 or 256, T a multiple
// of 64.
//
// Bound on this card by operations: a causal prefill does about 2 B H T^2 D multiply-adds (4 B H
// T^2 D / 2 operations) against (2 + 2 / G) B T H D elements moved, hundreds of operations a byte
// at T = 1024. The design, flash-attention 2 on mma.sync (bf16 -> f32, m16n8k16):
// - A block is 4 warps over 64 "packed" query rows of one (b, h): row p is position p / G, query
//   head g = p % G, so the G query heads of a kv head share the block's K/V tiles and each K/V
//   byte is read once per group (G = 4 for Llama-3.1-8B, 1 for Gemma-7B, 8 for Gemma-2B). A warp
//   owns 16 rows and runs its own online softmax over them; the logits, P and the output stay in
//   registers (16 x D float32 a warp: 128 registers a thread at D = 256, so the key tile is 32 wide
//   there and 64 at D = 128).
// - K/V tiles go through shared memory, double buffered by cp.async, rows of 16-byte chunks stored
//   at chunk c ^ (row & 7) so that ldmatrix (Q and K non-transposed, V transposed into the PV
//   product's B fragments) meets no bank conflict. q is read once, scaled and rounded on its way to
//   shared memory.
// - Causality: a block walks the key tiles up to its last row's position only and masks inside the
//   tiles that cross the diagonal; blocks are issued last rows first (the longest walks lead).
// - Float32 inputs (W8A8 models are float32 after their first linear) are not rounded to bf16:
//   each operand is split into bf16 parts hi + lo (lo = bf16(x - hi)) on its way to shared memory,
//   and each product is hi.hi + hi.lo + lo.hi, about 16 bits of each operand: a relative error of
//   order 2^-16 where a float32 product has 2^-24. P goes to the PV product as hi + lo for bf16
//   inputs too (16 bits), so the bf16 arm is held to the plain version's float32 PV product.
//
// The entry point has a plain C interface (bound with ctypes in ops/cuda/flash_prefill.py): it
// launches on the stream it is given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BM = 64;  // packed query rows of a block: 4 warps of 16
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hg::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hg::smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A pair of floats as bf16 parts: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

template <int D, bool F32>
struct Cfg {
  static constexpr int BN = D == 256 ? 32 : 64;  // keys of a tile
  static constexpr int ROW = 2 * D;             // bytes of a bf16 row in shared memory
  static constexpr int CHUNKS = D / 8;          // 16-byte chunks of a row
  static constexpr int PARTS = F32 ? 2 : 1;     // bf16 parts of q, k and v in shared memory
  static constexpr int Q_BYTES = BM * ROW;
  static constexpr int KV_BYTES = BN * ROW;
  // Shared memory: q [PARTS], then per buffer K [PARTS], V [PARTS].
  __host__ __device__ static constexpr int q_at(int part) { return part * Q_BYTES; }
  __host__ __device__ static constexpr int k_at(int buf, int part) {
    return PARTS * Q_BYTES + (buf * 2 * PARTS + part) * KV_BYTES;
  }
  __host__ __device__ static constexpr int v_at(int buf, int part) {
    return PARTS * Q_BYTES + (buf * 2 * PARTS + PARTS + part) * KV_BYTES;
  }
  static constexpr int BYTES = PARTS * Q_BYTES + 4 * PARTS * KV_BYTES;
};

// Byte offset of chunk c of row r in a tile.
template <int ROW>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * ROW + ((c ^ (r & 7)) << 4);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int T, H, Hkv, G;
  float scale, softcap;  // softcap 0: none
};

// Eight consecutive elements of a float32 or bf16 row as floats.
template <bool F32>
__device__ __forceinline__ void load8(const void* base, size_t off, float (&f)[8]) {
  if constexpr (F32) {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + off));
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// Eight floats into chunk (r, c) of the PARTS bf16 tiles at dst[part * stride].
template <int ROW, int PARTS>
__device__ __forceinline__ void store8(unsigned char* dst, int stride, int r, int c, const float (&f)[8]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_pair(f[2 * i], f[2 * i + 1], hi[i], lo[i]);
  *reinterpret_cast<uint4*>(dst + chunk_at<ROW>(r, c)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  if constexpr (PARTS == 2)
    *reinterpret_cast<uint4*>(dst + stride + chunk_at<ROW>(r, c)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

template <int D, bool F32>
__global__ void __launch_bounds__(THREADS, 1) flash_prefill_kernel(const Args a) {
  using C = Cfg<D, F32>;
  constexpr int BN = C::BN, ROW = C::ROW, CH = C::CHUNKS;
  constexpr int NT = BN / 8;  // 8-key n tiles of the logits
  constexpr int DT = D / 8;   // 8-wide n tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];

  const int T = a.T, G = a.G, H = a.H, Hkv = a.Hkv;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the longest walks first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;

  // q: rows m0 .. m0 + 63, scaled in float32 and rounded to q's dtype, then (float32) split.
  for (int i = threadIdx.x; i < BM * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const int p = m0 + r, t = p / G, g = p - t * G;
    float f[8];
    load8<F32>(a.q, (((size_t)b * T + t) * H + h * G + g) * D + c * 8, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = f[e] * a.scale;
      f[e] = F32 ? x : __bfloat162float(__float2bfloat16(x));
    }
    store8<ROW, C::PARTS>(smem + C::q_at(0), C::Q_BYTES, r, c, f);
  }

  const int t_last = (m0 + BM - 1) / G;  // the block's last position
  const int t_first = m0 / G;
  const int n_tiles = t_last / BN + 1;

  // K and V rows n0 .. n0 + BN - 1 into buffer buf.
  const auto load_kv = [&](int n0, int buf) {
    for (int i = threadIdx.x; i < BN * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const size_t off = (((size_t)b * T + n0 + r) * Hkv + h) * D + c * 8;
      if constexpr (F32) {
        float f[8];
        load8<true>(a.k, off, f);
        store8<ROW, 2>(smem + C::k_at(buf, 0), C::KV_BYTES, r, c, f);
        load8<true>(a.v, off, f);
        store8<ROW, 2>(smem + C::v_at(buf, 0), C::KV_BYTES, r, c, f);
      } else {
        hg::cp_async16(smem + C::k_at(buf, 0) + chunk_at<ROW>(r, c),
                       static_cast<const __nv_bfloat16*>(a.k) + off, 16);
        hg::cp_async16(smem + C::v_at(buf, 0) + chunk_at<ROW>(r, c),
                       static_cast<const __nv_bfloat16*>(a.v) + off, 16);
      }
    }
    hg::cp_async_commit();
  };

  // This thread's rows: gid and gid + 8 of the warp's 16, at positions pos[0], pos[1].
  const int row0 = warp * 16;
  int pos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) pos[e] = (m0 + row0 + gid + 8 * e) / G;

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  const float cap = a.softcap;

  load_kv(0, 0);
#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN, buf = j & 1;
    if (j + 1 < n_tiles) {
      load_kv(n0 + BN, buf ^ 1);
      hg::cp_async_wait<1>();
    } else {
      hg::cp_async_wait<0>();
    }
    __syncthreads();

    // Logits [16 rows, BN keys] of this warp.
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int mi = lane >> 3, mj = lane & 7;
      uint32_t qa[C::PARTS][4];
#pragma unroll
      for (int part = 0; part < C::PARTS; ++part)
        ldsm_x4(qa[part], smem + C::q_at(part) + chunk_at<ROW>(row0 + (mi & 1) * 8 + mj, 2 * kk + (mi >> 1)));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = chunk_at<ROW>(16 * np + (mi >> 1) * 8 + mj, 2 * kk + (mi & 1));
        uint32_t kb[4];
        ldsm_x4(kb, smem + C::k_at(buf, 0) + off);
        mma_bf16(s[2 * np], qa[0], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[0], kb[2], kb[3]);
        if constexpr (F32) {
          mma_bf16(s[2 * np], qa[1], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa[1], kb[2], kb[3]);
          ldsm_x4(kb, smem + C::k_at(buf, 1) + off);
          mma_bf16(s[2 * np], qa[0], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa[0], kb[2], kb[3]);
        }
      }
    }

    // Softcap, causal mask (tiles that cross the diagonal), online softmax in base 2.
    const bool diag = n0 + BN - 1 > t_first;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[i][c];
        if (cap > 0.0f) x = cap * tanhf(x / cap);
        x *= LOG2E;
        if (diag && n0 + 8 * i + 2 * tig + (c & 1) > pos[c >> 1]) x = -CUDART_INF_F;
        s[i][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float mn = fmaxf(m[e], mx[e]);  // finite: key 0 is visible to every row
      alpha[e] = exp2f(m[e] - mn);
      m[e] = mn;
      l[e] *= alpha[e];
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[i][c] - m[c >> 1]);
        s[i][c] = p;
        l[c >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // out += P V: P's A fragments from the logits' accumulators (hi and lo bf16 parts).
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const int mi = lane >> 3, mj = lane & 7;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int off = chunk_at<ROW>(16 * kk + (mi & 1) * 8 + mj, 2 * dp + (mi >> 1));
        uint32_t vb[4];
        ldsm_x4_t(vb, smem + C::v_at(buf, 0) + off);
        mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
        if constexpr (F32) {
          ldsm_x4_t(vb, smem + C::v_at(buf, 1) + off);
          mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer buf before it is loaded again
  }

  // Normalise and store rows gid, gid + 8 of the warp: out [B, T, H, D] in q's dtype.
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const float inv = 1.0f / l[e];
    const int p = m0 + row0 + gid + 8 * e, t = p / G, g = p - t * G;
    const size_t base = (((size_t)b * T + t) * H + h * G + g) * D + 2 * tig;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const float x = o[i][2 * e] * inv, y = o[i][2 * e + 1] * inv;
      if constexpr (F32)
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base + 8 * i) = make_float2(x, y);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) + base + 8 * i) = pack_bf16(x, y);
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <int D, bool F32>
int launch(int device, const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<D, F32>;
  static bool ready[MAX_DEVICES] = {};  // the shared-memory opt-in, once per device
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t e =
        cudaFuncSetAttribute(flash_prefill_kernel<D, F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready[device] = true;
  }
  const dim3 grid(a.T * a.G / BM, B * a.Hkv);
  flash_prefill_kernel<D, F32><<<grid, THREADS, C::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, H, D], k/v [B, T, Hkv, D], out [B, T, H, D], all float32 (f32 = 1) or all bfloat16;
// D 128 or 256, T a multiple of 64, H a multiple of Hkv. softcap <= 0: none.
extern "C" int flash_prefill(int device, const void* q, const void* k, const void* v, void* out, int B, int T,
                             int H, int Hkv, int D, int f32, float scale, float softcap, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || T < BM || T % BM != 0 || Hkv < 1 || H % Hkv != 0 || (D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.T = T;
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.scale = scale;
  a.softcap = softcap > 0.0f ? softcap : 0.0f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return f32 ? launch<128, true>(device, a, B, s) : launch<128, false>(device, a, B, s);
  return f32 ? launch<256, true>(device, a, B, s) : launch<256, false>(device, a, B, s);
}
