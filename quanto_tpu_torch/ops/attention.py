"""Grouped-query attention, the causal-prefill route and the decode-attention
dispatch.

PyTorch counterpart of `quanto_tpu/ops/attention.py`:
- `gqa_attention` (`attention.py:36-204`): the float32 softmax chain and the
  bf16 chain (a keyword here, JAX's `set_backend(bf16_softmax=True)`), the
  per-slot scales and shifts of quantized KV caches factored out of the
  contractions (the shift terms as JAX's default fused arm,
  `ops/config.py:use_asym_fused`), softcap, alibi, head_bias and sinks in
  JAX's order. Plain tensor code, as the JAX package left it to XLA; it serves
  every step with T > 1 that the fused prefill does not take (prefill over
  the cache readback at a tensor position, or outside the envelope).
- `try_flash_prefill` (`:206-268`): a step that is causal from position 0
  (`static_zero_pos`), inside JAX's envelope, attends to its raw K/V through
  `flash_prefill`, the counterpart of JAX's splash kernel; None elsewhere.
- `decode_attention`, the counterpart of `try_flash_decode` (`:278-343`) and
  of `decode_attention` (`:176-201`, scale, softcap, a sliding window and
  gpt-oss's sinks, which JAX's einsum chain takes at every T): a
  T == 1 step over any cache of `tensor/kv_cache.py`, a ring included, goes to `flash_decode`,
  whose kernel takes every cache the port has (float, int8, int4, fp8, mixed
  K/V types, shifts, any S), so there is no envelope to fall back from. A
  paged cache (`tensor/paged_kv.py`) goes to `flash_decode_paged`, which reads
  the pages through the table rows 0..B-1. JAX sends int4 and asymmetric
  pages to its einsum path (`:312-316`) and the rest to its kernels over a
  gathered dense view; the port serves them all with the kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..tensor.kv_cache import QKVCacheLayer
from ..tensor.paged_kv import PagedKVLayer
from .cuda.flash_decode import flash_decode, flash_decode_paged
from .cuda.flash_prefill import flash_prefill, in_envelope


__all__ = ["gqa_attention", "decode_attention", "static_zero_pos", "try_flash_prefill"]


def _slot_scale_t(s: torch.Tensor) -> torch.Tensor:
    """Per-slot cache factor [B, S, Hkv, 1] -> [B, Hkv, 1, 1, S], broadcast
    over the grouped [B, Hkv, G, T, S] logits and probabilities."""
    return s[..., 0].permute(0, 2, 1)[:, :, None, None, :]


def gqa_attention(
    q5: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    k_shift: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
    softcap: Optional[float] = None,
    alibi: Optional[torch.Tensor] = None,
    head_bias: Optional[torch.Tensor] = None,
    sinks: Optional[torch.Tensor] = None,
    bf16_chain: bool = False,
    f32_pv: bool = False,
) -> torch.Tensor:
    """Grouped-query attention without repeating KV heads.

    q5 [B, T, Hkv, G, D]; k/v [B, S, Hkv, D] (float values, or the codes of a
    quantized cache as `kv_read_raw` returns them); mask [B or 1, 1, T, S]
    additive float32 or None. The logits take JAX's transforms in its order:
    (+alibi) -> *scale -> softcap (tanh(x / c) * c) -> (+head_bias) -> +mask.
    `alibi` is a pre-scale key-positional bias ([B, Hkv*G, S]-reshapeable),
    `head_bias` a post-scale per-head bias [B or 1, Hkv*G, T or 1, S], and
    `sinks` [Hkv*G] learned per-head sink logits: an extra valueless softmax
    slot, a denominator term `exp(sink - max(max_logit, sink))`.

    Per-slot cache factors [B, S, Hkv, 1]: `k_scale` multiplies the logits,
    `v_scale` the probabilities; the shifts stay rank-1,
    `q . (c*s + m) = (q . c)*s + m * sum_d q` on the logits and
    `sum_s p[s]*m_v[s]` added over D on the output.

    Two chains, as JAX's `gqa_attention`:
    - float32 (default): logits, softmax and normaliser in float32; the
      probabilities cast to q5's dtype before the PV product, or kept in
      float32 with `f32_pv` (the flash kernels' numerics).
    - `bf16_chain` (JAX's `set_backend(bf16_softmax=True)`, taken for a
      bfloat16 q5 only): the logits round to bf16 after the QK product and
      the elementwise chain runs in bf16; the max is exact in bf16, the
      normaliser sums in float32, the PV product accumulates in float32 and
      the normalisation is deferred past it (the [.., D] output is divided).
    Returns [B, T, Hkv*G*D] in q5's dtype.
    """
    B, T, Hkv, G, D = q5.shape
    out_dtype = q5.dtype
    bf16 = bf16_chain and out_dtype == torch.bfloat16
    qf = q5.float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if bf16:
        logits = logits.to(torch.bfloat16)
    cdt = logits.dtype
    if k_scale is not None:
        logits.mul_(_slot_scale_t(k_scale).to(cdt))
    if k_shift is not None:
        qsum = qf.sum(-1).permute(0, 2, 3, 1)[..., None]  # [B, Hkv, G, T, 1]
        logits.add_(qsum.to(cdt) * _slot_scale_t(k_shift).to(cdt))
    if alibi is not None:
        logits.add_(alibi.reshape(B, Hkv, G, 1, -1).to(cdt))
    logits.mul_(torch.tensor(scale, dtype=cdt))
    if softcap is not None:
        logits = torch.tanh(logits / softcap).mul_(softcap)
    if head_bias is not None:
        logits.add_(head_bias.reshape(head_bias.shape[0], Hkv, G, *head_bias.shape[-2:]).to(cdt))
    if mask is not None:
        logits.add_(mask[:, :, None].to(cdt))
    snk = sinks.reshape(1, Hkv, G, 1, 1) if sinks is not None else None
    if bf16:
        m = logits.amax(-1, keepdim=True)
        if snk is not None:
            m = torch.maximum(m, snk.to(m.dtype))
        e = torch.exp(logits - m)
        del logits
        den = e.sum(-1, keepdim=True, dtype=torch.float32)
        if snk is not None:
            den = den + torch.exp(snk.float() - m.float())
        w = e * _slot_scale_t(v_scale).to(e.dtype) if v_scale is not None else e
        out = torch.einsum("bhgqk,bkhd->bqhgd", w.float(), v.float())
        if v_shift is not None:
            corr = torch.einsum("bhgqk,bkh->bqhg", e.float(), v_shift[..., 0].to(e.dtype).float())
            out = out + corr[..., None]
        out = (out / den.permute(0, 3, 1, 2, 4)).to(out_dtype)
        return out.reshape(B, T, Hkv * G * D)
    if snk is not None:
        m = torch.maximum(logits.amax(-1, keepdim=True), snk.float())
        probs = torch.exp(logits - m)
        probs.div_(probs.sum(-1, keepdim=True) + torch.exp(snk.float() - m))
    else:
        probs = torch.softmax(logits, dim=-1)
    del logits
    corr = None
    if v_shift is not None:
        corr = torch.einsum("bhgqk,bkh->bqhg", probs, v_shift[..., 0].float())
    if v_scale is not None:
        probs.mul_(_slot_scale_t(v_scale))
    pv_dtype = torch.float32 if f32_pv else out_dtype
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(pv_dtype), v.to(pv_dtype))
    if corr is not None:
        out = out + corr[..., None].to(pv_dtype)
    return out.to(out_dtype).reshape(B, T, Hkv * G * D)


def static_zero_pos(pos) -> bool:
    """True when `pos` is known to be 0 without reading a device value: None
    (no cache offset) or a Python / numpy integer 0, as JAX's
    `static_zero_pos` (`quanto_tpu/ops/attention.py:24-34`). A tensor, even
    one holding 0, is not: engine chunks, speculative verifies and paged
    prefills carry tensor positions and stay on `gqa_attention`."""
    if pos is None:
        return True
    return isinstance(pos, (int, np.integer)) and not isinstance(pos, bool) and int(pos) == 0


def try_flash_prefill(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> Optional[torch.Tensor]:
    """Causal attention of a prompt from position 0 over its raw K/V through
    `flash_prefill` (q [B, T, H, D], k/v [B, T, Hkv, D]), [B, T, H*D] in q's
    dtype; None outside JAX's envelope (the caller then runs `gqa_attention`
    over the cache or with its causal mask). Callers take it only for a step
    that is causal from zero (`static_zero_pos`)."""
    if not in_envelope(q.shape[1], q.shape[3], q.dtype) or k.dtype != q.dtype:
        return None
    return flash_prefill(q, k, v, softcap=softcap, scale=scale)


def decode_attention(
    q: torch.Tensor, layer_cache, positions: torch.Tensor, *, scale: Optional[float] = None,
    softcap: Optional[float] = None, window: Optional[int] = None, ring: bool = False,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step's attention over the just-updated cache (JAX
    `attention.py:176-201` and Gemma-2's T == 1 step): logits times `scale`
    (default D**-0.5), then `softcap` (None: none), then the mask, then
    gpt-oss's `sinks` (float32 [H] per-head sink logits, None: none).

    q [B, 1, H, D] post-rope queries; `layer_cache` a float (k, v) tuple, a
    `QKVCacheLayer` or a `PagedKVLayer`; positions int32 [B]: slot s is
    visible iff s <= positions[b], and s > positions[b] - window under a
    sliding `window`. `ring`: the cache is a sliding layer's W-slot ring
    (`models/sliding.py`) that the step's key was just written into, at slot
    positions[b] % W. JAX attends to the pre-write ring and the new key, its
    mask dropping the overwritten position positions[b] - W; the post-write
    ring holds exactly the keys it keeps, so the kernel reads the ring with
    positions clamped to W - 1 (a device op, no host read): every slot once
    the ring has wrapped, slots 0..positions[b] before. Returns [B, 1, H*D]
    in q's dtype."""
    B, _, H, D = q.shape
    tf = dict(scale=scale, softcap=softcap, window=window, sinks=sinks)
    if isinstance(layer_cache, PagedKVLayer):
        c = layer_cache
        Hkv = c._k_pages.shape[2]
        out = flash_decode_paged(
            q.reshape(B, Hkv, H // Hkv, D), c._k_pages, c._v_pages, c._k_scale, c._v_scale,
            c._table[:B], positions, k_shift=c._k_shift, v_shift=c._v_shift, **tf,
        )
        return out.reshape(B, 1, H * D)
    if isinstance(layer_cache, QKVCacheLayer):
        c = layer_cache
        kd, vd, ks, vs = c._k_data, c._v_data, c._k_scale, c._v_scale
        km, vm = c._k_shift, c._v_shift
    else:
        (kd, vd), ks, vs, km, vm = layer_cache, None, None, None, None
    Hkv = kd.shape[2]
    if ring:
        positions = positions.clamp(max=kd.shape[1] - 1)
    qg = q.reshape(B, Hkv, H // Hkv, D)
    out = flash_decode(qg, kd, vd, ks, vs, positions, k_shift=km, v_shift=vm, **tf)
    return out.reshape(B, 1, H * D)
