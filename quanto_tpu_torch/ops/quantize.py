"""Affine quantization ops.

PyTorch counterpart of `quanto_tpu/ops/quantize.py:61-105`. Rounding is
round-half-to-even (`torch.round`, as `jnp.round`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..tensor.grouped import group


__all__ = ["quantize_affine", "dequantize_affine"]


def quantize_affine(
    base: torch.Tensor,
    bits: int,
    axis: int,
    group_size: Optional[int],
    scale: torch.Tensor,
    shift: torch.Tensor,
) -> torch.Tensor:
    """Affine quantization to unsigned codes in [0, 2**bits - 1].

    A floating-point `shift` is a pre-scale offset (`round((base + shift) / scale)`);
    an integer `shift` is a zero-point added post-scale (`round(base / scale) + shift`).
    """
    if axis not in (0, -1):
        raise ValueError("axis parameter must be 0 (first axis) or -1 (last axis)")
    if group_size is not None:
        base = group(base, axis=axis, group_size=group_size)
    base = base.float()
    if shift.is_floating_point():
        data = torch.round((base + shift.float()) / scale.float())
    else:
        data = torch.round(base / scale.float()) + shift
    return torch.clamp(data, 0, 2**bits - 1).to(torch.uint8)


def dequantize_affine(
    data: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, dtype=torch.float32
) -> torch.Tensor:
    """Inverse of `quantize_affine` on grouped codes (caller un-groups)."""
    data = data.float()
    scale = scale.float()
    if shift.is_floating_point():
        out = scale * data - shift.float()
    else:
        # Integer zero-point.
        out = scale * (data - shift.float())
    return out.to(dtype)
