"""Grouped-query attention and the decode-attention dispatch.

PyTorch counterpart of `quanto_tpu/ops/attention.py`:
- `gqa_attention` (`attention.py:36-204`) with its float32 softmax chain and
  the per-slot scales and shifts of quantized KV caches factored out of the
  contractions (the shift terms as JAX's default fused arm,
  `ops/config.py:use_asym_fused`). Plain tensor code, as the JAX package left
  it to XLA; it serves every step with T > 1 (prefill over the cache
  readback, or no cache). Softcap, alibi, head_bias, sinks and the bf16 chain
  wait for later slices.
- `decode_attention`, the counterpart of `try_flash_decode` (`:278-343`): a
  T == 1 step over any cache of `tensor/kv_cache.py` goes to `flash_decode`,
  whose kernel takes every cache the port has (float, int8, int4, fp8, mixed
  K/V types, shifts, any S), so there is no envelope to fall back from. A
  paged cache (`tensor/paged_kv.py`) goes to `flash_decode_paged`, which reads
  the pages through the table rows 0..B-1. JAX sends int4 and asymmetric
  pages to its einsum path (`:312-316`) and the rest to its kernels over a
  gathered dense view; the port serves them all with the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..tensor.kv_cache import QKVCacheLayer
from ..tensor.paged_kv import PagedKVLayer
from .cuda.flash_decode import flash_decode, flash_decode_paged


__all__ = ["gqa_attention", "decode_attention"]


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
    f32_pv: bool = False,
) -> torch.Tensor:
    """Grouped-query attention without repeating KV heads.

    q5 [B, T, Hkv, G, D]; k/v [B, S, Hkv, D] (float values, or the codes of a
    quantized cache as `kv_read_raw` returns them); mask [B or 1, 1, T, S]
    additive float32 or None. Logits are float32 (the bf16 operands upcast
    exactly, as `preferred_element_type=float32`), softmax runs in float32,
    and the probabilities are cast to q5's dtype before the PV product, or
    kept in float32 with `f32_pv` (the flash-decode kernel's numerics).

    Per-slot cache factors [B, S, Hkv, 1]: `k_scale` multiplies the logits,
    `v_scale` the probabilities; the shifts stay rank-1,
    `q . (c*s + m) = (q . c)*s + m * sum_d q` on the logits and
    `sum_s p[s]*m_v[s]` added over D on the output.
    Returns [B, T, Hkv*G*D] in q5's dtype.
    """
    B, T, Hkv, G, D = q5.shape
    out_dtype = q5.dtype
    qf = q5.float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if k_scale is not None:
        logits.mul_(_slot_scale_t(k_scale))
    if k_shift is not None:
        qsum = qf.sum(-1).permute(0, 2, 3, 1)[..., None]  # [B, Hkv, G, T, 1]
        logits.add_(qsum * _slot_scale_t(k_shift))
    logits.mul_(scale)
    if mask is not None:
        logits.add_(mask[:, :, None].float())
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


def decode_attention(q: torch.Tensor, layer_cache, positions: torch.Tensor) -> torch.Tensor:
    """One decode step's attention over the just-updated cache, logits
    scaled by D**-0.5.

    q [B, 1, H, D] post-rope queries; `layer_cache` a float (k, v) tuple, a
    `QKVCacheLayer` or a `PagedKVLayer`; positions int32 [B] (slot s is
    visible iff s <= positions[b]). Returns [B, 1, H*D] in q's dtype."""
    B, _, H, D = q.shape
    if isinstance(layer_cache, PagedKVLayer):
        c = layer_cache
        Hkv = c._k_pages.shape[2]
        out = flash_decode_paged(
            q.reshape(B, Hkv, H // Hkv, D), c._k_pages, c._v_pages, c._k_scale, c._v_scale,
            c._table[:B], positions, k_shift=c._k_shift, v_shift=c._v_shift,
        )
        return out.reshape(B, 1, H * D)
    if isinstance(layer_cache, QKVCacheLayer):
        c = layer_cache
        kd, vd, ks, vs = c._k_data, c._v_data, c._k_scale, c._v_scale
        km, vm = c._k_shift, c._v_shift
    else:
        (kd, vd), ks, vs, km, vm = layer_cache, None, None, None, None
    Hkv = kd.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    out = flash_decode(qg, kd, vd, ks, vs, positions, k_shift=km, v_shift=vm)
    return out.reshape(B, 1, H * D)
