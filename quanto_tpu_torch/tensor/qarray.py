"""QArray: base of the quantized tensor containers.

PyTorch counterpart of `quanto_tpu/tensor/qarray.py`. A QArray is a plain
Python object holding integer payloads plus scales as `torch.Tensor` fields
(named with a leading underscore) and its quantization metadata. Quantized ops
are explicit functions (`quanto_tpu_torch.ops`); an op without a quantized
path calls `.dequantize()` first.
"""

from __future__ import annotations

from typing import Tuple

import torch


__all__ = ["QArray"]


class QArray:
    """Abstract base for quantized tensors; subclasses store payloads and
    scales and expose `dequantize()` back to the activation dtype."""

    @property
    def shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        """The floating dtype `dequantize()` returns."""
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def dequantize(self) -> torch.Tensor:
        raise NotImplementedError
