// Flash decoding for Hopper (sm_90a): single-token grouped-query attention over a float or
// quantized KV cache, planned on the device and run in one launch.
//
// Replaces the three TPU decode-attention kernels of the JAX package, which compute one function
// and differ only in how they block for VMEM and the (8, 128) tiling:
//   quanto_tpu/ops/pallas/flash_decode.py:53   _kernel (v1, head-group blocks)
//   quanto_tpu/ops/pallas/flash_decode2.py:44  _kernel (v2, full-row [S, Hkv*D] blocks)
//   quanto_tpu/ops/pallas/flash_decode3.py:36  _kernel (v3, online softmax over S chunks)
//
// For batch row b, KV head h and query g, over the slots s <= pos[b] (and s > pos[b] - window
// under a sliding window):
//   x[s]     = ((q . c_k[s]) * s_k[s] + (sum_d q) * m_k[s]) * scale     (scale: D^-0.5 by default)
//   logit[s] = softcap * tanh(x[s] / softcap)                          (x[s] without a softcap)
//   out      = sum_s p[s] * (s_v[s] * c_v[s] + m_v[s]) / sum_s p[s],   p[s] = exp(logit[s] - max)
// with c the stored codes (or the float values of a float cache), s the per-slot scales and m
// the per-slot shifts of the asymmetric specs. The scales and shifts are factored out of the
// dots as in quanto_tpu/ops/attention.py:gqa_attention, so the payload is decoded, never
// dequantized into memory. Softmax and sums are float32 (exponentials by ex2.approx, a few ulp);
// the softmax is normalised once, at the end, as in v3; the output is cast to q's dtype.
//
// Cache layout (quanto_tpu_torch/tensor/kv_cache.py): payload [B, S, Hkv, D] as float32,
// bfloat16, int8 or float8 (decoded through a 256-entry table of the format's values), or int4
// as uint8 [B, S, Hkv, D/2] with code 2j + 8 in the low nibble of byte j and code 2j + 1 + 8 in
// its high nibble; scales and shifts float32 [B, S, Hkv, 1]. D is 64, 128 or 256 (Gemma); at 256 a
// bf16 slot's K and V rows are 1 KB, so a stage (16 slots a warp) is 64 KB and the ring takes two
// (flash_decode.cuh:ring_stages), one block an SM; the CUDA-core arm takes 8 slots a warp there.
//
// The paged arm (a page table given; quanto_tpu_torch/tensor/paged_kv.py): the payload, scales and
// shifts are pools [n_pages, ps, Hkv, ...] and slot s of row b lies at offset s % ps of page
// table[b, s / ps] (int32 [B, P], S = P * ps). JAX gathers a dense [B, S, Hkv, D] view of the
// pages and runs its kernels on that (quanto_tpu/ops/attention.py:310-319): a write and a read
// of every slot's K and V, in every layer and step. Here the kernel reads the pages where they
// lie: the row address is computed in one place (flash_decode.cuh:CacheRows), per copied row,
// since a page (4-64 slots in the port's engines and tests) may be shorter than a tile (64-512);
// each lane keeps the page of its last row, so a run of rows in one page costs one table load.
// The plan, the tiles and the order of every sum are the dense arm's over S = P * ps, so the
// output equals the dense arm's on the gathered view bit for bit.
//
// Bound on this card by bytes at every shape the port runs: a visible slot of a head costs
// 4 G D = 2048 operations (G = 4, D = 128) against 512 bytes of a bf16 cache, 264 of qint8, 200 of
// k8v4, 136 of qint4 and 144 of qint4a, at most 15 operations a byte where the tensor cores need
// 295. Llama-3.1-8B's phase-3 calls (B = 4, Hkv = 8): bf16 40.08 us at 4 x 8192 and 5.34 at
// 4 x 1088, qint4 10.66 and 1.43; the engine's B = 8 over 4352 slots 36.20 (every row at
// 3200-4224) and 23.90 (four rows at ~1060). The design is about reading each visible byte once,
// with enough bytes in flight, and keeping the arithmetic of a tile short enough to hide under its
// copies:
// - The two dots run on the tensor cores (mma.sync m16n8k16, bf16 -> f32), slots on the 16-row
//   side and a KV head's query rows on the 8-wide side, G > 8 in a second n-tile:
//   logits^T = C_k . q^T, then out^T += C_v^T . (p s_v)^T. mma.sync rather than wgmma: a warp owns
//   its slots and runs its own online softmax, so no warpgroup waits on another, the products need
//   no shared-memory operand, and at 4-8 operations a byte the tensor cores are far from the limit
//   either way. Int4, int8 and float8 codes are exact in bf16 and q is bf16 already, so the only
//   operand to round is p s_v: it goes in as three bf16 parts, each the rounding of what the ones
//   before left, three products, its 24 bits (one part, 8 bits, moved the output by up to a bf16
//   step and two, 16 bits, still moved it enough that a W4A8 model's activation quantizer carried
//   it into the next layer's int8 codes, chip_smoke.py phase 5); s_k, (sum q) m_k, s_v and sum
//   p m_v stay float32 outside the products. The head dim inside a product may be visited in any order as long as both
//   operands agree, so each thread's K fragments are whole 16-byte (or 8-byte) runs of one slot
//   row, decoded in registers (int4: two codes a register by a mask and the exact 2^7 bias;
//   int8: the exact 2^23 bias; float8 through the table), and q's fragments follow the same
//   order. The first product's accumulator holds a query column per thread pair, the second's
//   B fragment a query row per lane group, so p moves between them by four shuffles an m tile.
//   Two m tiles (32 slots) share one online-softmax step: one max, one rescale of out.
// - Float32 q or a float32 cache stays on CUDA-core arithmetic (flash_decode_cc.cu) inside the
//   same schedule: the float32-q limit of 1e-5 * max|ref| is beyond a bf16 product, and the models
//   run bf16 q over bf16 or quantized caches, so that arm is off the main path.
// - The cache goes through shared memory (flash_decode.cuh): a tile is 4 TS slots of one head
//   (TS = 16-128 a warp, about 4 KB of its K and V rows: 32 slots of qint4, 16 of bf16), and each
//   warp copies its TS slots' rows and factors by cp.async (16 bytes a copy, factors 4),
//   zero-filled past the visible slots, into a ring of 4 stages (3 where a stage passes 20 KB), and
//   waits for its own copies only: the warps of a block meet at the end of a segment and nowhere
//   else, so one warp's arithmetic hides under the others' copies. 2 blocks an SM, 96-144 KB in
//   flight. A head's rows lie Hkv rows apart in the cache (64 bytes of qint4 every 512); reading
//   4 heads' rows side by side (the whole 256 bytes) was slower, its pairs fewer and their merges
//   longer. The rows are swizzled (flash_decode.cuh:swz) so that the fragment reads meet no bank
//   conflict.
// - The work is planned on the device from the positions. A fixed grid of one wave (the SMs times
//   the blocks of an arm that fit on one) reads positions[B]; every block computes the same plan:
//   the items are the tiles of each (b, h, query group) over row b's visible slots only, and
//   block i takes the i-th of gridDim.x equal runs of them. A run of one pair's tiles is one
//   segment, one online softmax a warp; so no tile past pos[b] is ever read, and a row at 1060 of
//   4352 costs its own tiles, not a share of the cache. The host knows nothing it did not (B, Hkv,
//   G, S, D), so a call makes no host sync and can be captured in a CUDA graph.
// - One launch per call. A block that saw a pair whole writes its output. Otherwise it writes a
//   partial (max, sum, out) into its slot of the workspace, and the last of the pair's blocks to
//   arrive (an atomic counter per pair, the only atomic) merges the partials in block order, 16 in
//   flight, and writes the output, so two calls give the same bits; it then sets the counter back
//   to 0, so the counters (kept by the wrapper, zeroed once) need no memset between calls.
//
// Gemma-2 (scale query_pre_attn_scalar^-0.5, softcap 50, a window of 4096 on every other layer):
// scale, softcap and window are runtime arguments, not template parameters, so they add no
// instantiation to the build. The softcap is one ex2 and a fast reciprocal (softcap.cuh), its
// log2(e) applied after the cap (flash_decode.cuh:logit2). Under a window the plan starts a row's
// tiles at its first visible slot, max(0, pos - window + 1), so a row reads its window and no more.
// The tensor-core arm is built by one source per head dim (flash_decode_tc{64,128,256}.cu).
//
// gpt-oss (attention sinks: a learned logit per query head that joins every softmax's denominator
// as a valueless slot, after the scale, the softcap and the mask): the sinks are a runtime pointer,
// null for none, so they too add no instantiation. Only the last store of a row reads its sink
// (flash_decode.cuh:store_out), on both arms: the plan, the tiles, the partials and the merge order
// are those of the call without sinks.
//
// The entry points have a plain C interface (bound with ctypes in ops/cuda/flash_decode.py).
// flash_decode_workspace gives the float32 elements of the partials' workspace and the query
// groups a head is cut into (the wrapper caches both per device and shapes); flash_decode launches
// the kernel on the stream it is given, allocates nothing and returns cudaGetLastError().

#include "flash_decode.cuh"

namespace {

// The tensor-core arm at head dim D (its source of that D).
int tc_workspace(int device, int G, int kt, int vt, int D, long long* floats, int* groups) {
  if (D == 64) return fd::tc_workspace64(device, G, kt, vt, floats, groups);
  if (D == 128) return fd::tc_workspace128(device, G, kt, vt, floats, groups);
  return fd::tc_workspace256(device, G, kt, vt, floats, groups);
}
int tc_launch(int device, const fd::Args& a, int kt, int vt, int D, cudaStream_t stream) {
  if (D == 64) return fd::tc_launch64(device, a, kt, vt, stream);
  if (D == 128) return fd::tc_launch128(device, a, kt, vt, stream);
  return fd::tc_launch256(device, a, kt, vt, stream);
}

// Whether the call takes the tensor-core arm: bf16 q over a cache without float32 payloads.
bool tensor_cores(int k_type, int v_type, int q_bf16) { return q_bf16 && k_type != fd::F32 && v_type != fd::F32; }

// A float cache is one float type for K and V and has no scales; a quantized cache pairs any two
// code types and has scales, with or without shifts.
bool valid_types(int k_type, int v_type, int mode) {
  const bool kf = k_type == fd::F32 || k_type == fd::BF16, vf = v_type == fd::F32 || v_type == fd::BF16;
  if (kf || vf) return k_type == v_type && mode == fd::NONE;
  return k_type >= fd::I8 && k_type <= fd::FP8 && v_type >= fd::I8 && v_type <= fd::FP8 &&
         (mode == fd::SCALED || mode == fd::SHIFTED);
}

}  // namespace

// *floats: the float32 elements of flash_decode's workspace (the partials of its grid), *groups:
// the query groups a KV head is cut into (the arrival counters are [B, Hkv, groups]); both depend
// on the device, G, D, the payload types and q's dtype only.
extern "C" int flash_decode_workspace(int device, int G, int D, int k_type, int v_type, int q_bf16,
                                      long long* floats, int* groups) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (G < 1 || (D != 64 && D != 128 && D != 256)) return (int)cudaErrorInvalidValue;
  return tensor_cores(k_type, v_type, q_bf16) ? tc_workspace(device, G, k_type, v_type, D, floats, groups)
                                              : fd::cc_workspace(device, G, k_type, v_type, D, floats, groups);
}

// k_type / v_type: 0 float32, 1 bfloat16, 2 int8, 3 int4 nibbles, 4 float8 (through k_lut /
// v_lut, 256 float32 values). mode: 0 no scales, 1 scales, 2 scales and shifts. q_bf16: 1 when q
// and out are bfloat16, 0 when they are float32. ws: float32, of flash_decode_workspace's size;
// counters: int32 [B, Hkv, groups], zero (the kernel leaves them zero). table: null for a dense
// cache, else the int32 [B, pages_per_slot] page table of a paged one, S = pages_per_slot *
// page_size. scale: the query scale (> 0); softcap: c of c tanh(x / c), <= 0 none; window: slot s of
// row b visible iff pos[b] - window < s <= pos[b], <= 0 none. sinks: null, or float32 [Hkv * G] sink
// logits (flash_decode.cuh:store_out).
extern "C" int flash_decode(int device, const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale, const void* k_shift,
                            const void* v_shift, const void* positions, const void* k_lut,
                            const void* v_lut, void* ws, void* counters, void* out, int B, int Hkv,
                            int G, int S, int D, int k_type, int v_type, int mode, int q_bf16,
                            const void* table, int pages_per_slot, int page_size, float scale,
                            float softcap, int window, const void* sinks, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if ((D != 64 && D != 128 && D != 256) || B < 1 || Hkv < 1 || G < 1 || S < 1 || !valid_types(k_type, v_type, mode) ||
      !(scale > 0.0f))
    return (int)cudaErrorInvalidValue;
  if (table != nullptr && (pages_per_slot < 1 || page_size < 1 || (long long)pages_per_slot * page_size != S))
    return (int)cudaErrorInvalidValue;
  fd::Args a;
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
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.out = out;
  a.table = static_cast<const int*>(table);
  a.P = pages_per_slot;
  a.ps = page_size;
  a.B = B; a.Hkv = Hkv; a.G = G; a.S = S; a.ng = 1;
  a.mode = mode; a.q_bf16 = q_bf16;
  a.cap = softcap > 0.0f ? softcap : 0.0f;
  a.cap_k = softcap > 0.0f ? 2.0f * fd::LOG2E / softcap : 0.0f;
  a.scale = softcap > 0.0f ? scale : fd::LOG2E * scale;  // base 2 after the cap (fd::logit2)
  a.window = window > 0 ? window : 0;
  a.sinks = static_cast<const float*>(sinks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tensor_cores(k_type, v_type, q_bf16) ? tc_launch(device, a, k_type, v_type, D, s)
                                              : fd::cc_launch(device, a, k_type, v_type, D, s);
}
