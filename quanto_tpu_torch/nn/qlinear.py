"""Quantized linear module.

PyTorch counterpart of `quanto_tpu/nn/qlinear.py`: weights always quantized,
bias never, inputs (and outputs, unless calibration streamlined them away)
quantized when an activation qtype is set; with `qat` set and not frozen, a
float product with the fake-quantized weight (`QModuleMixin.fake_qweight`). The weight keeps the torch linear
convention `[out_features, in_features]`, so per-output-channel (axis 0)
scales and the generic layout match quanto checkpoints bit for bit.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..ops.qlinear import qlinear
from ..tensor.optimizers import Optimizer
from ..tensor.qtype import qtype
from .qmodule import QModuleMixin, register_qmodule


__all__ = ["QLinear"]


@register_qmodule(nn.Linear)
class QLinear(QModuleMixin, nn.Module):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        *,
        weights: Optional[Union[str, qtype]] = None,
        activations: Optional[Union[str, qtype]] = None,
        optimizer: Optional[Optimizer] = None,
        device="cuda",
        dtype=None,
    ):
        nn.Module.__init__(self)
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty((out_features, in_features), **kw), requires_grad=False)
        self.bias = (
            nn.Parameter(torch.zeros((out_features,), **kw), requires_grad=False) if bias else None
        )
        self._init_quantization(weights, activations, optimizer, in_features, device=device)

    @classmethod
    def from_module(
        cls,
        module: nn.Linear,
        weights: Optional[Union[str, qtype]] = None,
        activations: Optional[Union[str, qtype]] = None,
        optimizer: Optional[Optimizer] = None,
    ) -> Optional["QLinear"]:
        """Build from an `nn.Linear`, sharing its parameters (no copy)."""
        if weights is None:
            return None
        qmodule = cls(
            module.in_features,
            module.out_features,
            bias=module.bias is not None,
            weights=weights,
            activations=activations,
            optimizer=optimizer,
            device="meta",
            dtype=module.weight.dtype,
        )
        qmodule.weight = module.weight
        if module.bias is not None:
            qmodule.bias = module.bias
        qmodule._init_scales(module.weight.device)
        return qmodule

    def forward(self, x):
        x = self.maybe_quantize_input(x)
        if self.qat and not self.frozen:
            # QAT (`quanto_tpu/nn/qlinear.py:87-90`): a float product with the fake-quantized weight.
            out = torch.matmul(x, self.fake_qweight().t().to(x.dtype))
            if self.bias is not None:
                out = out + self.bias
        else:
            out = qlinear(x, self.qweight, self.bias)
        return self.maybe_quantize_output(out)
