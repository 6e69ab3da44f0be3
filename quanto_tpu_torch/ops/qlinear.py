"""Quantized linear (the hot op).

PyTorch counterpart of the float-x arms of `quanto_tpu/ops/qlinear.py:42-75`:
- `WeightQBitsHopperArray` w: the fused dequant-matmul of
  `ops/cuda/qbits_mm.py` (a kernel on a CUDA tensor, its plain version on a
  CPU tensor);
- `WeightQBitsArray` w (generic layout): dequantize + `torch.matmul`, the JAX
  package's own XLA path (`qlinear.py:74-75`);
- a plain tensor w: `torch.matmul`.

Weights follow the torch linear convention: shape [out_features, in_features].
"""

from __future__ import annotations

from typing import Optional

import torch

from ..tensor.qarray import QArray
from ..tensor.weights import WeightQBitsArray, WeightQBitsHopperArray
from .cuda.qbits_mm import qbits_mm


__all__ = ["qlinear"]


def qlinear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w.T + bias with a quantized or plain weight."""
    if isinstance(w, WeightQBitsHopperArray):
        out = qbits_mm(x, w._packed, w._scale_t, w._shift_t, w.kernel_group_size)
    elif isinstance(w, WeightQBitsArray):
        out = torch.matmul(x, w.dequantize().to(x.dtype).t())
    elif isinstance(w, QArray):
        raise NotImplementedError(f"qlinear: {type(w).__name__} weights are not ported yet")
    else:
        out = torch.matmul(x, w.t())
    if bias is not None:
        out = out + bias
    return out
