"""Symmetric and affine quantization ops.

PyTorch counterpart of `quanto_tpu/ops/quantize.py`. Rounding is
round-half-to-even (`torch.round`, as `jnp.round`); base and scale are
divided in float32 (never multiplied by a reciprocal), so the codes match the
JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..tensor.grouped import group


__all__ = ["quantize_symmetric", "dequantize_symmetric", "quantize_affine", "dequantize_affine"]


def _check_per_axis_scale(base: torch.Tensor, axis: Optional[int], scale: torch.Tensor) -> None:
    """The scale checks of `quanto_tpu/ops/quantize.py:_check_per_axis_scale`."""
    if axis is None:
        if scale.dim() > 0 and scale.numel() != 1:
            raise ValueError("Scale must be a scalar when quantizing per-tensor")
        return
    if base.dim() == 1:
        raise ValueError("1D Tensors cannot be quantized per-axis")
    if axis not in (0, -1, base.dim() - 1):
        raise ValueError("Quantization is only supported along the first or last axis.")
    if base.shape[axis] == 1:
        raise ValueError(f"Cannot quantize Tensor of shape {tuple(base.shape)} along axis {axis} of size 1")
    if sum(1 for d in scale.shape if d > 1) > 1:
        raise ValueError("Quantizing along multiple axis is not supported")
    if scale.dim() != base.dim():
        raise ValueError(
            "When quantizing per-axis, the scale must be broadcastable to the base "
            "(Tip: try to add missing dims of length one)."
        )


def quantize_symmetric(base: torch.Tensor, qt, axis: Optional[int], scale: torch.Tensor) -> torch.Tensor:
    """clamp(round(base / scale), qmin, qmax) cast to the qtype's storage
    dtype; float8 qtypes skip the rounding (the cast rounds)."""
    _check_per_axis_scale(base, axis, scale)
    data = base.float() / scale.float()
    if not qt.is_floating_point:
        data = torch.round(data)
    return torch.clamp(data, qt.qmin, qt.qmax).to(qt.dtype)


def dequantize_symmetric(data: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of `quantize_symmetric`: scale * data in float32, cast to `dtype`."""
    return (data.float() * scale.float()).to(dtype)


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
