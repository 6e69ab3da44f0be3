// The CUDA-core arm of flash_decode (TPU #8-#10): float32 q over any cache, and bfloat16 q over a
// float32 cache. flash_decode.cu's source note gives the function and the schedule (the device
// plan, the cp.async ring, one launch) that this arm shares with the tensor-core arm; only the
// arithmetic of a warp's slots differs. The dots stay float32 on CUDA cores, as the float32-q limit
// of 1e-5 * max|ref| asks: a slot row of the stage is read by D / 8 neighbouring lanes, each taking
// 8 elements of the head dim (so 2 slots a warp at D = 128, 4 at D = 64), and each such lane group
// runs its own online softmax over its share of the warp's slots, for 4 query rows at a time, U
// slots a step with all their reads issued before their first use. At the end of a segment the
// warp's lane groups merge by shuffles into the warp's partial.

#include "flash_decode.cuh"

namespace fd {
namespace {

constexpr int EPL = 8;  // head-dim elements per lane

// One lane's 8 elements of a staged slot row: the raw load and its decode to float.
template <int T>
struct Raw;

template <>
struct Raw<F32> {
  static constexpr int kBytes = 32;
  float4 a, b;
  __device__ __forceinline__ void load(const unsigned char* p) {
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
  __device__ __forceinline__ void load(const unsigned char* p) { w = *reinterpret_cast<const uint4*>(p); }
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
  __device__ __forceinline__ void load(const unsigned char* p) { w = *reinterpret_cast<const uint2*>(p); }
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
  __device__ __forceinline__ void load(const unsigned char* p) { w = *reinterpret_cast<const uint32_t*>(p); }
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
  __device__ __forceinline__ void load(const unsigned char* p) { w = *reinterpret_cast<const uint2*>(p); }
  // `lut` holds the 256 values of the float8 format in shared memory.
  __device__ __forceinline__ void decode(float* f, const float* lut) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = lut[(w.x >> (8 * i)) & 0xFFu];
      f[4 + i] = lut[(w.y >> (8 * i)) & 0xFFu];
    }
  }
};

// Slots per lane group and step: up to 64 payload bytes in flight per lane, 2 to 4 slots.
template <int KT, int VT>
constexpr int unroll() {
  constexpr int u = 64 / (Raw<KT>::kBytes + Raw<VT>::kBytes);
  return u < 2 ? 2 : (u > 4 ? 4 : u);
}

template <int KT, int VT, int D_>
struct CcArm {
  static constexpr int D = D_;
  static constexpr int GR = 4;                // query rows of a group
  static constexpr int L = D / EPL;           // lanes per slot row
  static constexpr int SPW = 32 / L;          // slot rows per warp and step
  static constexpr int KROW = row_bytes<KT, D>(), VROW = row_bytes<VT, D>();
  // At D = 256 a warp's part is 8 slots (a float32 row pair is 2 KB), so that two stages fit.
  static constexpr int TS = tile_slots(KROW + VROW, D > 128 ? 8 : 16);
  static constexpr int PER = TS / SPW;        // a lane group's slots of a tile
  static constexpr int U = unroll<KT, VT>() < PER ? unroll<KT, VT>() : PER;
  static constexpr bool SCALES = KT > BF16;  // a quantized cache has per-slot factors
  using SL = StageLayout<TS, KROW, VROW, SCALES>;
  static constexpr int STAGES = ring_stages(SL::bytes, D);
  static constexpr int LUT_BYTES = (KT == FP8 || VT == FP8) ? 2 * 256 * 4 : 16;
  static_assert(PER % U == 0, "a group's slots come in whole steps");

  struct State {
    float q[GR][EPL], qsum[GR];  // this lane's 8 columns of the group's query rows (zero past G)
    float m[GR], l[GR], acc[GR][EPL], accm[GR];
  };

  static __device__ __forceinline__ void load_luts(const Args& a, unsigned char* lut) {
    if constexpr (KT == FP8 || VT == FP8) {
      float* t = reinterpret_cast<float*>(lut);
      for (int i = threadIdx.x; i < 512; i += THREADS) {
        const float* src = i < 256 ? a.k_lut : a.v_lut;
        if (src != nullptr) t[i] = src[i & 255];
      }
    }
  }

  static __device__ __forceinline__ void begin(State& s, const Args& a, int b, int h, int grp) {
    const int c = (threadIdx.x & 31) % L;
#pragma unroll
    for (int gi = 0; gi < GR; ++gi) {
      const int g = grp * GR + gi;
      const size_t off = (((size_t)b * a.Hkv + h) * a.G + g) * D + c * EPL;
      float t = 0.0f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        float x = 0.0f;
        if (g < a.G && h < a.Hkv)
          x = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[off + i])
                       : static_cast<const float*>(a.q)[off + i];
        s.q[gi][i] = x;
        t += x;
        s.acc[gi][i] = 0.0f;
      }
#pragma unroll
      for (int o = L / 2; o > 0; o /= 2) t += __shfl_xor_sync(0xffffffffu, t, o);
      s.qsum[gi] = t;
      s.m[gi] = -CUDART_INF_F;
      s.l[gi] = 0.0f;
      s.accm[gi] = 0.0f;
    }
  }

  // This warp's TS slots of one head: K and V rows from K, V (row r: slot r), the factors of slot r
  // at sc[r] (k_scale; v_scale, k_shift, v_shift SL::rows floats apart), the first n visible.
  static __device__ __forceinline__ void tile(State& s, const Args& a, const unsigned char* K, const unsigned char* V,
                                              const float* sc, int n, const unsigned char* lut) {
    const int lane = threadIdx.x & 31;
    const int c = lane % L, grp = lane / L;
    const float* lut_k = reinterpret_cast<const float*>(lut);
    const float* lut_v = lut_k + 256;
    // Every lane runs every step, so the shuffles see the full warp; slots past n are masked
    // (their rows are zero-filled).
#pragma unroll 1
    for (int base = 0; base < PER && SPW * base < n; base += U) {
      Raw<KT> rk[U];
      Raw<VT> rv[U];
      float sk[U], sv[U], mk[U], mv[U];
      bool valid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = grp + SPW * (base + u);
        valid[u] = r < n;
        rk[u].load(K + swz<KROW>(r, c * Raw<KT>::kBytes));
        rv[u].load(V + swz<VROW>(r, c * Raw<VT>::kBytes));
        sk[u] = sv[u] = 1.0f;
        mk[u] = mv[u] = 0.0f;
        if constexpr (SCALES) {
          sk[u] = sc[r];
          sv[u] = sc[SL::rows + r];
          if (a.mode == SHIFTED) {
            mk[u] = sc[2 * SL::rows + r];
            mv[u] = sc[3 * SL::rows + r];
          }
        }
      }

      // Logits: partial dots over this lane's 8 columns, summed over the group's L lanes.
      float lg[U][GR];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[EPL];
        rk[u].decode(kf, lut_k);
#pragma unroll
        for (int gi = 0; gi < GR; ++gi) {
          float t = 0.0f;
#pragma unroll
          for (int i = 0; i < EPL; ++i) t = fmaf(s.q[gi][i], kf[i], t);
          lg[u][gi] = t;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int gi = 0; gi < GR; ++gi)
#pragma unroll
          for (int o = L / 2; o > 0; o /= 2) lg[u][gi] += __shfl_xor_sync(0xffffffffu, lg[u][gi], o);

      // Online softmax: rescale the running state once per step, then add the step's slots.
#pragma unroll
      for (int gi = 0; gi < GR; ++gi) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float t = valid[u] ? logit2(a, fmaf(lg[u][gi], sk[u], s.qsum[gi] * mk[u])) : -CUDART_INF_F;
          lg[u][gi] = t;
          mx = fmaxf(mx, t);
        }
        const float m_new = fmaxf(s.m[gi], mx);
        // m_new = -inf only for a group with no visible slot in this step and none before.
        const float alpha = m_new == -CUDART_INF_F ? 1.0f : fast_exp2(s.m[gi] - m_new);
        s.l[gi] *= alpha;
        s.accm[gi] *= alpha;
#pragma unroll
        for (int i = 0; i < EPL; ++i) s.acc[gi][i] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = valid[u] ? fast_exp2(lg[u][gi] - m_new) : 0.0f;
          s.l[gi] += p;
          s.accm[gi] = fmaf(p, mv[u], s.accm[gi]);
          lg[u][gi] = p * sv[u];  // the weight of the slot's codes
        }
        s.m[gi] = m_new;
      }

      // acc += p * s_v * c_v over the step's slots.
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[EPL];
        rv[u].decode(vf, lut_v);
#pragma unroll
        for (int gi = 0; gi < GR; ++gi)
#pragma unroll
          for (int i = 0; i < EPL; ++i) s.acc[gi][i] = fmaf(lg[u][gi], vf[i], s.acc[gi][i]);
      }
    }
  }

  // The warp's partial: its lane groups merged by shuffles (the same columns lie L lanes apart),
  // then written by the first group.
  static __device__ __forceinline__ void export_(State& s, float* mine) {
    const int lane = threadIdx.x & 31;
    const int c = lane % L;
#pragma unroll
    for (int gi = 0; gi < GR; ++gi) {
      float m = s.m[gi], l = s.l[gi], acc[EPL];
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] = s.acc[gi][i] + s.accm[gi];
#pragma unroll
      for (int o = L; o < 32; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m, o), lo = __shfl_xor_sync(0xffffffffu, l, o);
        const float mn = fmaxf(m, mo);
        const float wa = m == -CUDART_INF_F ? 0.0f : fast_exp2(m - mn);
        const float wb = mo == -CUDART_INF_F ? 0.0f : fast_exp2(mo - mn);
        l = l * wa + lo * wb;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[i] = acc[i] * wa + __shfl_xor_sync(0xffffffffu, acc[i], o) * wb;
        m = mn;
      }
      if (lane < L) {
        if (c == 0) {
          mine[gi] = m;
          mine[GR + gi] = l;
        }
#pragma unroll
        for (int i = 0; i < EPL; ++i) mine[2 * GR + gi * D + c * EPL + i] = acc[i];
      }
    }
  }
};

}  // namespace

int cc_launch(int device, const Args& a, int kt, int vt, int D, cudaStream_t stream) {
  return visit<CcArm, F32, BF16>(kt, vt, D, [&](auto arm) { return arm_launch<decltype(arm)>(device, a, stream); });
}

int cc_workspace(int device, int G, int kt, int vt, int D, long long* ws_floats, int* groups) {
  return visit<CcArm, F32, BF16>(
      kt, vt, D, [&](auto arm) { return arm_workspace<decltype(arm)>(device, G, ws_floats, groups); });
}

}  // namespace fd
