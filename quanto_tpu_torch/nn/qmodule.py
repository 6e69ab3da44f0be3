"""Quantized module layer.

PyTorch counterpart of `quanto_tpu/nn/qmodule.py` (weight quantization only;
activation quantization waits for a later slice). Workflow states:
- **dynamic**: `weight` is the float `nn.Parameter`; `qweight` re-quantizes
  on every access;
- **frozen**: `weight` is a `QArray`, repacked into the Hopper kernel layout
  when it lies on a CUDA device.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..tensor.optimizers import MaxOptimizer
from ..tensor.qarray import QArray
from ..tensor.qtype import qtype, qtypes
from ..tensor.weights import WeightQBitsHopperArray, quantize_weight


__all__ = ["QModuleMixin", "register_qmodule", "quantize_module"]


# Registry: float module class -> quantized module class.
_QMODULE_TABLE: dict = {}


def register_qmodule(module_cls):
    """Register a QModule class as the quantized form of `module_cls`."""

    def wrapper(cls):
        _QMODULE_TABLE[module_cls] = cls
        return cls

    return wrapper


def quantize_module(module, **kwargs):
    """Return the quantized counterpart of a module, or None."""
    for cls, qcls in _QMODULE_TABLE.items():
        if isinstance(module, cls):
            return qcls.from_module(module, **kwargs)
    return None


def _resolve_qtype(qt: Optional[Union[str, qtype]]) -> Optional[qtype]:
    if isinstance(qt, str):
        if qt not in qtypes:
            raise ValueError(f"Unknown qtype {qt!r}; valid names: {sorted(qtypes)}")
        return qtypes[qt]
    return qt


def _auto_group_size(in_features: int) -> Optional[int]:
    """Largest group size in {128, 96, 64, 32} dividing in_features, applied
    only when in_features exceeds 128 (`quanto_tpu/nn/qmodule.py:84-96`)."""
    group_size = 128
    if in_features > group_size:
        while in_features % group_size != 0 and group_size > 32:
            group_size -= 32
        if in_features % group_size == 0:
            return group_size
    return None


class QModuleMixin:
    """Shared weight-quantization behaviour of quantized modules."""

    def _init_quantization(self, weights: Optional[Union[str, qtype]], in_features: int) -> None:
        weights = _resolve_qtype(weights)
        if weights is not None and weights.bits == 8:
            raise NotImplementedError("8-bit weights are not ported yet")
        self.weight_qtype = weights
        self.weight_group_size = _auto_group_size(in_features) if weights is not None else None
        self.optimizer = MaxOptimizer()

    @property
    def frozen(self) -> bool:
        return isinstance(getattr(self, "weight", None), QArray)

    @property
    def qweight(self):
        """Quantized weight: dynamic re-quantization until frozen."""
        if self.weight_qtype is None:
            return None
        w = self.weight
        if isinstance(w, QArray):
            return w
        scale, shift = self.optimizer(
            w.detach(), self.weight_qtype, axis=0, group_size=self.weight_group_size
        )
        return quantize_weight(
            w.detach(), self.weight_qtype, 0, scale, shift=shift, group_size=self.weight_group_size
        )

    @torch.no_grad()
    def freeze(self) -> None:
        """Replace the float weight with its quantized form, repacked into the
        Hopper layout when it lies on a CUDA device and fits the envelope."""
        if self.weight_qtype is None or self.frozen:
            return
        qw = self.qweight
        if qw.device.type == "cuda":
            qw = WeightQBitsHopperArray.from_generic(qw) or qw
        del self.weight  # drop the float Parameter
        self.weight = qw
