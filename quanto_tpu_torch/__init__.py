"""quanto_tpu_torch: the PyTorch + CUDA (Hopper) port of `quanto_tpu`.

Module paths mirror the JAX package (`tensor/`, `ops/`, `nn/`, `models/`,
`quantize.py`). The port imports `torch` and never JAX or `quanto_tpu`.
Entry points run on CUDA unless the caller passes `device="cpu"`; on a CPU
tensor each kernel wrapper computes its plain PyTorch version instead.
"""

from .calibrate import Calibration, absmax_scale
from .quantize import freeze, named_qmodules, quantize
from .tensor.activations import ActivationQBytesArray, quantize_activation
from .tensor.optimizers import AbsmaxOptimizer, MaxOptimizer
from .tensor.qtype import qfloat8, qint2, qint4, qint8, qtype, qtypes
from .tensor.weights import WeightQBitsArray, WeightQBitsHopperArray, WeightQBytesArray, quantize_weight


__all__ = [
    "Calibration",
    "absmax_scale",
    "freeze",
    "named_qmodules",
    "quantize",
    "ActivationQBytesArray",
    "quantize_activation",
    "AbsmaxOptimizer",
    "MaxOptimizer",
    "qtype",
    "qtypes",
    "qfloat8",
    "qint2",
    "qint4",
    "qint8",
    "WeightQBitsArray",
    "WeightQBitsHopperArray",
    "WeightQBytesArray",
    "quantize_weight",
]
