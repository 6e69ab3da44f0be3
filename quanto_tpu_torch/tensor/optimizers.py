"""Scale/shift optimizers for weight quantization.

PyTorch counterpart of `quanto_tpu/tensor/optimizers.py`: a symmetric
optimizer returns a scale (8-bit weights, activations), an affine optimizer a
(scale, shift) pair, optionally group-wise, optionally with an integer
zero-point. Scales come back in the base dtype, as in JAX. `HqqOptimizer`
refines `MaxOptimizer`'s shift by half-quadratic lp-shrink steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .grouped import group
from .qtype import qtype


__all__ = [
    "Optimizer",
    "SymmetricOptimizer",
    "AbsmaxOptimizer",
    "AffineOptimizer",
    "MaxOptimizer",
    "HqqOptimizer",
]


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


def _shrink_lp(x: torch.Tensor, beta, lp_norm: float) -> torch.Tensor:
    """The lp shrinkage operator of HQQ (`quanto_tpu/tensor/optimizers.py:_shrink_lp`)."""
    if lp_norm == 1:
        return torch.sign(x) * torch.clamp_min(x.abs() - 1.0 / beta, 0.0)
    return torch.sign(x) * torch.clamp_min(x.abs() - (1.0 / beta) * torch.pow(x.abs(), lp_norm - 1), 0.0)


class HqqOptimizer(MaxOptimizer):
    """Half-Quadratic Quantization: `MaxOptimizer`'s scale, and its shift
    refined by up to `iters` lp-shrink steps that stop at the first step
    that does not lower the mean |W - deq(W)| (`quanto_tpu/tensor/
    optimizers.py:132-244`). The state is float32 and the returned shift is
    the best one seen, in the base dtype.

    Two loops with the same steps, as in JAX: by default all `iters` steps
    run with a `done` mask that freezes the state after the first step that
    does not improve, and nothing waits for the card (JAX's
    `lax.while_loop`); `verbose=True` runs them one at a time, reads each
    error on the host, prints it and stops at that step (JAX's eager loop).
    Both give the same shift."""

    def __init__(
        self,
        lp_norm: float = 0.7,
        beta: float = 1e1,
        kappa: float = 1.01,
        iters: int = 20,
        verbose: bool = False,
    ) -> None:
        self.lp_norm = lp_norm
        self.beta = beta
        self.kappa = kappa
        self.iters = iters
        self.verbose = verbose

    def optimize(
        self, base: torch.Tensor, qt: qtype, axis: Optional[int]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        scale, shift = super().optimize(base, qt, axis)
        scale, shift = scale.to(base.dtype), shift.to(base.dtype)
        basef, scalef = base.float(), scale.float()
        qmax = float(2**qt.bits - 1)
        mean_dim = 0 if axis == -1 else -1

        def qdq(sh):
            # quantize_affine's float-shift codes, then dequantize_affine, in float32.
            return torch.clamp(torch.round((basef + sh) / scalef), 0.0, qmax) * scalef - sh

        def step(beta, sh, deq):
            e = _shrink_lp(basef - deq, beta, self.lp_norm)
            new_sh = torch.mean(deq + sh - (basef - e), dim=mean_dim, keepdim=True)
            new_deq = qdq(new_sh)
            return new_sh, new_deq, torch.mean((basef - new_deq).abs())

        sh = shift.float()
        deq = qdq(sh)
        best_err, best_sh = torch.mean((basef - deq).abs()), sh
        beta = torch.tensor(self.beta, dtype=torch.float32, device=base.device)
        kappa = torch.tensor(self.kappa, dtype=torch.float32, device=base.device)
        if self.verbose:
            print(f"Start error: {float(best_err):.6f}")
            for i in range(self.iters):
                sh, deq, err = step(beta, sh, deq)
                print(f"HQQ error at it #{i}: {float(err):.6f}")
                if not bool(err < best_err):
                    break
                best_err, best_sh, beta = err, sh, beta * kappa
            return scale, best_sh.to(base.dtype)
        done = torch.zeros((), dtype=torch.bool, device=base.device)
        for _ in range(self.iters):
            new_sh, new_deq, err = step(beta, sh, deq)
            improved = (err < best_err) & ~done
            sh, deq = torch.where(done, sh, new_sh), torch.where(done, deq, new_deq)
            best_err = torch.where(improved, err, best_err)
            best_sh = torch.where(improved, new_sh, best_sh)
            beta = torch.where(improved, beta * kappa, beta)
            done = done | ~improved
        return scale, best_sh.to(base.dtype)
