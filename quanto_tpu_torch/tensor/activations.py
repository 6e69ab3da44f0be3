"""Quantized activations.

PyTorch counterpart of `quanto_tpu/tensor/activations.py:36-107`:
activations are quantized per tensor to an 8-bit qtype with a scalar scale.
The scale stays a 0-d device tensor from the module's buffer to the kernel:
nothing here reads it on the host, so quantizing an activation never waits
for the card.

Consumption cells serve `Calibration`'s streamline pass
(`quanto_tpu_torch/calibrate.py`): a consumer that uses a quantized output as
quantized data marks `quantized_use`, `dequantize()` marks `dequantized`.
`fake_quantize_activation` is the quantize-dequantize round trip of
quantization-aware training, with a straight-through gradient
(`activations.py:111-129`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops.quantize import dequantize_symmetric, quantize_symmetric
from .qarray import QArray
from .qtype import qtype


__all__ = [
    "ActivationQBytesArray",
    "quantize_activation",
    "fake_quantize_activation",
    "attach_consumption_cell",
    "mark_dequantized",
    "mark_quantized_use",
]


def attach_consumption_cell(x: "ActivationQBytesArray", cell: dict) -> None:
    """Attach a mutable consumption-tracking cell (calibration streamline)."""
    object.__setattr__(x, "_track", cell)


def mark_dequantized(x) -> None:
    cell = getattr(x, "_track", None)
    if cell is not None:
        cell["dequantized"] = True


def mark_quantized_use(x) -> None:
    cell = getattr(x, "_track", None)
    if cell is not None:
        cell["quantized_use"] = True


@dataclass(frozen=True, eq=False)
class ActivationQBytesArray(QArray):
    """8-bit per-tensor symmetric quantized activation: `_data * _scale`."""

    _data: torch.Tensor
    _scale: torch.Tensor  # 0-d float32
    qtype: qtype
    float_dtype: torch.dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.float_dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    def dequantize(self) -> torch.Tensor:
        mark_dequantized(self)
        return dequantize_symmetric(self._data, self._scale, self.float_dtype)


def quantize_activation(t: torch.Tensor, qt: qtype, scale: torch.Tensor) -> ActivationQBytesArray:
    """Quantize an activation to an 8-bit qtype with a scalar scale."""
    if qt.bits != 8:
        raise ValueError("Activations can only be quantized to 8-bit qtypes")
    if scale.numel() != 1:
        raise ValueError("Activation quantization requires a scalar scale")
    scale = scale.reshape(())
    return ActivationQBytesArray(
        _data=quantize_symmetric(t, qt, None, scale), _scale=scale, qtype=qt, float_dtype=t.dtype
    )


class _FakeQuantizeActivation(torch.autograd.Function):
    """`fake_quantize_activation`'s straight-through round trip: the gradient
    passes to the tensor unchanged, the scale gets zeros (JAX's `_fake_qa_bwd`)."""

    @staticmethod
    def forward(ctx, t, qt, scale):
        ctx.save_for_backward(scale)
        return quantize_activation(t, qt, scale).dequantize()

    @staticmethod
    def backward(ctx, g):
        (scale,) = ctx.saved_tensors
        return g, None, torch.zeros_like(scale)


def fake_quantize_activation(t: torch.Tensor, qt: qtype, scale: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize round trip with a straight-through estimator
    (`quanto_tpu/tensor/activations.py:111-121`): gradients flow unchanged to
    `t`, the scale receives zeros."""
    return _FakeQuantizeActivation.apply(t, qt, scale)
