"""Quantized linear (the hot op).

PyTorch counterpart of `quanto_tpu/ops/qlinear.py:78-146`:
- `WeightQBytesArray` w (8-bit weight-only), float x: inside the kernel's
  envelope (`ops/cuda/qbytes_mm.py:eligible`: int8 or e4m3fn payload, N and
  K multiples of 128, bf16/f32 x, M <= 256) the fused kernel of
  `ops/cuda/qbytes_mm.py`, else JAX's XLA formula (`ops/qbytes_mm.py`);
  with a quantized x (W8A8) it raises: `ROADMAP.md` Queue 1, item 2;
- `WeightQBitsHopperArray` w: with a qint8 `ActivationQBytesArray` x the
  W4A8 kernels (`qbits_int8_mm`); with float x the fused dequant-matmul
  (`qbits_mm`); any other quantized x is dequantized first;
- `WeightQBitsArray` w (generic layout): dequantize + `torch.matmul`, the JAX
  package's own XLA path (`qlinear.py:74-75`), x dequantized first;
- a plain tensor w: `torch.matmul`, x dequantized first.

Each kernel wrapper computes its plain version on a CPU tensor and launches
its kernel on a CUDA tensor. Weights follow the torch linear convention:
shape [out_features, in_features].
"""

from __future__ import annotations

from typing import Optional

import torch

from ..tensor.activations import ActivationQBytesArray, mark_quantized_use
from ..tensor.qarray import QArray
from ..tensor.qtype import qint8
from ..tensor.weights import WeightQBitsArray, WeightQBitsHopperArray, WeightQBytesArray
from . import qbytes_mm as xla_qbytes
from .cuda import qbytes_mm as cuda_qbytes
from .cuda.qbits_mm import qbits_int8_mm, qbits_mm


__all__ = ["qlinear"]


def qlinear(x, w, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w.T + bias with quantized or plain operands."""
    if isinstance(w, WeightQBytesArray):
        if isinstance(x, ActivationQBytesArray):
            raise NotImplementedError(
                "qlinear: int8 x int8 (W8A8, qbytes_int_mm) is not ported yet: ROADMAP.md Queue 1, item 2"
            )
        if cuda_qbytes.eligible(x, w._data, w._scale):
            out = cuda_qbytes.qbytes_mm(x, w._data, w._scale)
        else:
            out = xla_qbytes.qbytes_mm(x, w._data, w._scale)
    elif isinstance(w, WeightQBitsHopperArray):
        if isinstance(x, ActivationQBytesArray) and x.qtype == qint8:
            out = qbits_int8_mm(
                x._data, x._scale, w._packed, w._scale_t, w._shift_t, w.kernel_group_size, w.float_dtype
            )
            mark_quantized_use(x)
        else:
            if isinstance(x, QArray):
                x = x.dequantize()
            out = qbits_mm(x, w._packed, w._scale_t, w._shift_t, w.kernel_group_size)
    else:
        if isinstance(x, QArray):
            x = x.dequantize()
        if isinstance(w, WeightQBitsArray):
            out = torch.matmul(x, w.dequantize().to(x.dtype).t())
        elif isinstance(w, QArray):
            raise NotImplementedError(f"qlinear: {type(w).__name__} weights are not ported yet")
        else:
            out = torch.matmul(x, w.t())
    if bias is not None:
        out = out + bias
    return out
