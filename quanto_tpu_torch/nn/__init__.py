"""Quantized modules of quanto_tpu_torch; importing this package registers
`QLinear` as the quantized form of `nn.Linear`."""

from .qlinear import QLinear
from .qmodule import QModuleMixin


__all__ = ["QLinear", "QModuleMixin"]
