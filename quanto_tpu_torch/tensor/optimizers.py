"""Scale/shift optimizers for weight quantization.

PyTorch counterpart of `quanto_tpu/tensor/optimizers.py:37-121`: a symmetric
optimizer returns a scale (8-bit weights, activations), an affine optimizer a
(scale, shift) pair, optionally group-wise, optionally with an integer
zero-point. Scales come back in the base dtype, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .grouped import group
from .qtype import qtype


__all__ = ["Optimizer", "SymmetricOptimizer", "AbsmaxOptimizer", "AffineOptimizer", "MaxOptimizer"]


def _reduce_dims(ndim: int, axis: int):
    """Dims to reduce when keeping one value per `axis` entry."""
    return tuple(range(1, ndim)) if axis == 0 else tuple(range(0, ndim - 1))


class Optimizer:
    def __call__(self, base: torch.Tensor, qt: qtype, axis: int, **kwargs):
        raise NotImplementedError


class SymmetricOptimizer(Optimizer):
    """Returns a scale only; used for 8-bit symmetric quantization."""

    def __call__(self, base: torch.Tensor, qt: qtype, axis: Optional[int] = None) -> torch.Tensor:
        if axis not in (None, 0, -1):
            raise ValueError("axis parameter must be None, 0 (first axis) or -1 (last axis)")
        if axis is not None and base.shape[axis] == 1:
            axis = None
        return self.optimize(base, qt, axis).to(base.dtype)

    def optimize(self, base: torch.Tensor, qt: qtype, axis: Optional[int]) -> torch.Tensor:
        raise NotImplementedError


class AbsmaxOptimizer(SymmetricOptimizer):
    """scale = max|t| / qmax, per tensor (0-d) or per axis (keepdim)."""

    def optimize(self, base: torch.Tensor, qt: qtype, axis: Optional[int]) -> torch.Tensor:
        base = base.abs().float()
        if axis is None:
            rmax = torch.amax(base)
        else:
            rmax = torch.amax(base, dim=_reduce_dims(base.ndim, axis), keepdim=True)
        return rmax / qt.qmax


class AffineOptimizer(Optimizer):
    """Returns (scale, shift); used for sub-byte affine quantization."""

    def __call__(
        self,
        base: torch.Tensor,
        qt: qtype,
        axis: int,
        group_size: Optional[int] = None,
        zeropoint: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if axis not in (0, -1):
            raise ValueError("axis parameter must be 0 (first axis) or -1 (last axis)")
        if group_size is not None:
            base = group(base, axis, group_size)
        if base.shape[axis] == 1:
            axis = None
        scale, shift = self.optimize(base, qt, axis)
        scale = scale.to(base.dtype)
        shift = shift.to(base.dtype)
        if zeropoint:
            # Round the shift so that zero has an exact quantized representation.
            shift = torch.clamp(torch.round(shift / scale), 0, 2**qt.bits - 1).to(torch.uint8)
        return scale, shift

    def optimize(
        self, base: torch.Tensor, qt: qtype, axis: Optional[int]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


class MaxOptimizer(AffineOptimizer):
    """scale = (rmax - rmin) / (qmax - qmin), shift = -rmin."""

    def optimize(
        self, base: torch.Tensor, qt: qtype, axis: Optional[int]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        basef = base.float()
        if axis is None:
            rmin = torch.amin(basef)
            rmax = torch.amax(basef)
        else:
            dims = _reduce_dims(basef.ndim, axis)
            rmin = torch.amin(basef, dim=dims, keepdim=True)
            rmax = torch.amax(basef, dim=dims, keepdim=True)
        qmin = -(2 ** (qt.bits - 1))
        qmax = 2 ** (qt.bits - 1) - 1
        scale = (rmax - rmin) / (qmax - qmin)
        shift = -rmin
        return scale, shift
