"""Quantized module layer.

PyTorch counterpart of `quanto_tpu/nn/qmodule.py`. Workflow states:
- **dynamic**: `weight` is the float `nn.Parameter`; `qweight` re-quantizes
  on every access;
- **calibrated**: the `input_scale` / `output_scale` buffers (0-d float32,
  1 until calibrated) updated by `Calibration` (`quanto_tpu_torch/calibrate.py`);
- **frozen**: `weight` is a `QArray`, repacked into the Hopper kernel layout
  when it is int4 or int2 and lies on a CUDA device, zero-padded onto the
  kernels' envelope where its shape is off it (an int4 one into its
  W4A8 requant form, `WeightQBitsRequantArray`, when frozen with
  `w4a8_requant_dot=True`).

Quantization-aware training (`quanto_tpu/nn/qmodule.py:135-195`): with
`qat` set, a module that is not frozen computes in float with
`fake_qweight()` (the weight quantized and dequantized, straight-through
gradients) and fake-quantized activations; its float `weight` Parameter is
trained as any other (the caller turns on its `requires_grad`), and
`freeze` then quantizes it as it would without QAT.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..tensor.activations import fake_quantize_activation, mark_quantized_use, quantize_activation
from ..tensor.optimizers import AbsmaxOptimizer, MaxOptimizer, Optimizer
from ..tensor.qarray import QArray
from ..tensor.qtype import qtype, qtypes
from ..tensor.weights import (
    WeightQBitsArray,
    WeightQBitsHopperArray,
    WeightQBitsRequantArray,
    fake_quantize_weight,
    quantize_weight,
)


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
    """Shared quantization behaviour of quantized modules (an `nn.Module`
    subclass calls `_init_quantization` from its constructor)."""

    def _init_quantization(
        self,
        weights: Optional[Union[str, qtype]],
        activations: Optional[Union[str, qtype]],
        optimizer: Optional[Optimizer],
        in_features: int,
        device=None,
    ) -> None:
        weights = _resolve_qtype(weights)
        activations = _resolve_qtype(activations)
        self.weight_qtype = weights
        self.weight_group_size = (
            _auto_group_size(in_features) if weights is not None and weights.bits < 8 else None
        )
        self.activation_qtype = activations
        if optimizer is None and weights is not None:
            optimizer = AbsmaxOptimizer() if weights.bits == 8 else MaxOptimizer()
        self.optimizer = optimizer
        self._init_scales(device)
        # Output quantization is on with activations; Calibration's streamline
        # pass may turn it off.
        self.quantize_outputs = activations is not None
        self.calibrating = False
        self._calibration = None
        # QAT: float compute with fake quantization and straight-through gradients.
        self.qat = False

    def _init_scales(self, device) -> None:
        """Activation scales: 0-d float32 buffers, 1 until calibrated."""
        for name in ("input_scale", "output_scale"):
            self.register_buffer(name, torch.ones((), dtype=torch.float32, device=device))

    # --- weight quantization -------------------------------------------------

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
        w = w.detach()
        if self.weight_qtype.bits == 8:
            scale = self.optimizer(w, self.weight_qtype, axis=0)
            return quantize_weight(w, self.weight_qtype, 0, scale, activation_qtype=self.activation_qtype)
        scale, shift = self.optimizer(w, self.weight_qtype, axis=0, group_size=self.weight_group_size)
        return quantize_weight(
            w, self.weight_qtype, 0, scale, shift=shift, group_size=self.weight_group_size
        )

    def fake_qweight(self) -> torch.Tensor:
        """The weight quantized and dequantized, differentiable with respect to
        the float weight (straight-through), the QAT path: the scale and shift
        come from the optimizer on the detached weight, as their gradient is
        zero in JAX's `fake_quantize_weight`."""
        w = self.weight
        if isinstance(w, QArray):
            return w.dequantize()
        if self.weight_qtype is None:
            return w
        wd = w.detach()
        if self.weight_qtype.bits == 8:
            scale = self.optimizer(wd, self.weight_qtype, axis=0)
            return fake_quantize_weight(w, self.weight_qtype, 0, scale, None, None)
        scale, shift = self.optimizer(wd, self.weight_qtype, axis=0, group_size=self.weight_group_size)
        return fake_quantize_weight(w, self.weight_qtype, 0, scale, shift, self.weight_group_size)

    @torch.no_grad()
    def freeze(self, w4a8_requant_dot: bool = False) -> None:
        """Replace the float weight with its quantized form. An int4 or int2
        weight on a CUDA device is repacked into the Hopper layout, zero-padded
        onto the envelope where its shape is off it; it stays generic only
        where JAX's `from_generic` returns None (a group size that does not
        divide K). An 8-bit weight keeps its [N, K] layout, which the kernel
        reads as it is.

        `w4a8_requant_dot`: a Hopper-layout weight, int4 or int2, takes its
        requant form (`WeightQBitsRequantArray`), which sends W4A8 and W2A8
        matmuls at M >= 2048 through the approximate requant kernel
        (per-channel int8 codes about 8x finer than the coarsest group's int4
        step, 42x finer than its int2 step), the counterpart of the JAX
        package's opt-in `set_backend(w4a8_requant_dot=True)`. On an already
        frozen module it converts a Hopper-layout weight in place of freezing
        again. Without it, numerics stay exact."""
        if self.weight_qtype is None:
            return
        if self.frozen:
            qw = self.weight
        else:
            qw = self.qweight
            if isinstance(qw, WeightQBitsArray) and qw.device.type == "cuda":
                qw = WeightQBitsHopperArray.from_generic(qw) or qw
            del self.weight  # drop the float Parameter
        if w4a8_requant_dot and type(qw) is WeightQBitsHopperArray:
            qw = WeightQBitsRequantArray.from_hopper(qw)
        self.weight = qw

    # --- activation quantization ---------------------------------------------

    def maybe_quantize_input(self, x):
        """Quantize the input activation (`quanto_tpu/nn/qmodule.py:212-231`)."""
        if self.activation_qtype is None:
            return x
        if isinstance(x, QArray):
            # Consuming an already-quantized input keeps the producer's output
            # quantization alive through streamline.
            mark_quantized_use(x)
            if self.calibrating and self._calibration is not None:
                self._calibration.calibrate_input(self, x)
            return x
        if self.calibrating and self._calibration is not None:
            self._calibration.calibrate_input(self, x)
        if self.qat:
            return fake_quantize_activation(x, self.activation_qtype, self.input_scale)
        return quantize_activation(x, self.activation_qtype, self.input_scale)

    def maybe_quantize_output(self, out):
        """Quantize the output activation (`quanto_tpu/nn/qmodule.py:233-253`)."""
        if self.activation_qtype is None:
            return out
        if self.calibrating and self._calibration is not None:
            self._calibration.calibrate_output(self, out)
            # While calibrating, outputs are quantized with the live scale and
            # tagged, so that streamline sees how they are consumed.
            qout = quantize_activation(out, self.activation_qtype, self.output_scale)
            self._calibration.tag_output(self, qout)
            return qout
        if not self.quantize_outputs:
            return out
        if self.qat:
            return fake_quantize_activation(out, self.activation_qtype, self.output_scale)
        return quantize_activation(out, self.activation_qtype, self.output_scale)
