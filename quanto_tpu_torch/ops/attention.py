"""Grouped-query attention.

PyTorch counterpart of `quanto_tpu/ops/attention.py:gqa_attention` with its
float32 softmax chain (`attention.py:103-106`, `:138-139`, `:184-190`,
`:204`). Plain tensor code, as the JAX package left this to XLA; quantized-KV
scales and shifts, softcap, alibi, sinks and the bf16 chain wait for later
slices.
"""

from __future__ import annotations

from typing import Optional

import torch


__all__ = ["gqa_attention"]


def gqa_attention(
    q5: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """Grouped-query attention without repeating KV heads.

    q5 [B, T, Hkv, G, D]; k/v [B, S, Hkv, D]; mask [B or 1, 1, T, S]
    additive float32. Logits are float32 (the bf16 operands upcast exactly,
    as `preferred_element_type=float32`), softmax runs in float32, and the
    probabilities are cast to q5's dtype before the PV product.
    Returns [B, T, Hkv*G*D] in q5's dtype.
    """
    B, T, Hkv, G, D = q5.shape
    out_dtype = q5.dtype
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float())
    logits = logits * scale
    if mask is not None:
        logits = logits + mask[:, :, None].float()
    probs = torch.softmax(logits, dim=-1).to(out_dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(out_dtype))
    return out.reshape(B, T, Hkv * G * D)
