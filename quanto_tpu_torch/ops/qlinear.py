"""Quantized linear (the hot op).

PyTorch counterpart of `quanto_tpu/ops/qlinear.py:78-146`:
- `WeightQBytesArray` w (8-bit weight-only), float x: inside the kernel's
  envelope (`ops/cuda/qbytes_mm.py:eligible`: int8 or e4m3fn payload, N and
  K multiples of 128, bf16/f32 x, M <= 256) the fused kernel of
  `ops/cuda/qbytes_mm.py`, else JAX's XLA formula (`ops/qbytes_mm.py`);
  with a quantized x (W8A8) it raises: `ROADMAP.md` Queue 1, item 2;
- `WeightQBitsHopperArray` w (int4 or int2): with a qint8
  `ActivationQBytesArray` x the W4A8/W2A8 kernels (`qbits_int8_mm`, routed
  by M: `qbits_mm_int8_small_m` at M <= 512, `qbits_mm_tiled_int8` above);
  with float x the fused dequant-matmul (`qbits_mm`); any other quantized x
  is dequantized first. An int2 weight at M > 1024 (`INT2_MAX_M`) takes no
  kernel, float or int8 x, unless it takes the requant route below: JAX's
  `_prefill_route` refuses it (`quanto_tpu/ops/pallas/qbits_mm.py:339-344`)
  and its `qlinear` falls back to dequantize + matmul
  (`quanto_tpu/ops/qlinear.py:74-75`), x dequantized first;
- `WeightQBitsRequantArray` w (its subclass, frozen with
  `w4a8_requant_dot=True`, int4 or int2): as its parent, except that with a
  qint8 x at M >= 2048 (`INT8_DOT_MIN_M`, `requant_route`) `qbits_int8_mm`
  takes the approximate requant kernel `qbits_mm_requant_int8`, at either
  width: JAX tries `_int8pc_route` before `_prefill_route`'s int2 gate;
- `WeightQBitsArray` w (generic layout): dequantize + `torch.matmul`, the JAX
  package's own XLA path (`qlinear.py:74-75`), x dequantized first;
- a plain tensor w: `torch.matmul`, x dequantized first.

Each kernel wrapper computes its plain version on a CPU tensor and launches
its kernel on a CUDA tensor. Weights follow the torch linear convention:
shape [out_features, in_features].
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..tensor.activations import ActivationQBytesArray, mark_quantized_use
from ..tensor.qarray import QArray
from ..tensor.qtype import qint8
from ..tensor.weights import (
    WeightQBitsArray,
    WeightQBitsHopperArray,
    WeightQBitsRequantArray,
    WeightQBytesArray,
)
from . import qbytes_mm as xla_qbytes
from .cuda import qbytes_mm as cuda_qbytes
from .cuda.qbits_mm import INT2_MAX_M, qbits_int8_mm, qbits_mm, requant_route


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
        M = math.prod(x.shape[:-1])
        int8_x = isinstance(x, ActivationQBytesArray) and x.qtype == qint8
        s8 = w._s8 if isinstance(w, WeightQBitsRequantArray) else None
        requant = int8_x and requant_route(M, w.shape[1], w.kernel_group_size, s8)
        if w.bits == 2 and M > INT2_MAX_M and not requant:
            if isinstance(x, QArray):
                x = x.dequantize()
            out = torch.matmul(x, w.dequantize().to(x.dtype).t())
        elif int8_x:
            out = qbits_int8_mm(
                x._data, x._scale, w._packed, w._scale_t, w._shift_t, w.kernel_group_size, w.float_dtype,
                s8=s8, bits=w.bits,
            )
            mark_quantized_use(x)
        else:
            if isinstance(x, QArray):
                x = x.dequantize()
            out = qbits_mm(x, w._packed, w._scale_t, w._shift_t, w.kernel_group_size, w.bits)
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
