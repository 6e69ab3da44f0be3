"""quanto_tpu_torch: the PyTorch + CUDA (Hopper) port of `quanto_tpu`.

Module paths mirror the JAX package (`tensor/`, `ops/`, `nn/`, `models/`,
`quantize.py`). The port imports `torch` and never JAX or `quanto_tpu`.
Entry points run on CUDA unless the caller passes `device="cpu"`; on a CPU
tensor each kernel wrapper computes its plain PyTorch version instead.
"""

from .quantize import freeze, quantize
from .tensor.optimizers import MaxOptimizer
from .tensor.qtype import qint2, qint4, qint8, qtype, qtypes
from .tensor.weights import WeightQBitsArray, WeightQBitsHopperArray, quantize_weight


__all__ = [
    "freeze",
    "quantize",
    "MaxOptimizer",
    "qtype",
    "qtypes",
    "qint2",
    "qint4",
    "qint8",
    "WeightQBitsArray",
    "WeightQBitsHopperArray",
    "quantize_weight",
]
