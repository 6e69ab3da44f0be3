"""quanto_tpu_torch: the PyTorch + CUDA (Hopper) port of `quanto_tpu`.

Module paths mirror the JAX package (`tensor/`, `ops/`, `nn/`, `models/`,
`parallel/`, `quantize.py`). The port imports `torch` and never JAX or `quanto_tpu`.
Entry points run on CUDA unless the caller passes `device="cpu"`; on a CPU
tensor each kernel wrapper computes its plain PyTorch version instead.
"""

from .calibrate import Calibration, absmax_scale
from .models import BatchedEngine, PagedEngine
from .parallel import StackedSparseMoeBlock, convert_moe_to_stacked
from .quantize import freeze, named_qmodules, quantization_map, quantize, requantize
from .tensor.activations import ActivationQBytesArray, quantize_activation
from .tensor.paged_kv import PagedKVLayer, init_paged_kv_cache
from .tensor.optimizers import AbsmaxOptimizer, HqqOptimizer, MaxOptimizer
from .tensor.qtype import qfloat8, qint2, qint4, qint8, qtype, qtypes
from .tensor.weights import (
    WeightQBitsArray,
    WeightQBitsHopperArray,
    WeightQBitsRequantArray,
    WeightQBytesArray,
    quantize_weight,
)


__all__ = [
    "Calibration",
    "absmax_scale",
    "BatchedEngine",
    "PagedEngine",
    "StackedSparseMoeBlock",
    "convert_moe_to_stacked",
    "freeze",
    "named_qmodules",
    "quantization_map",
    "quantize",
    "requantize",
    "ActivationQBytesArray",
    "quantize_activation",
    "PagedKVLayer",
    "init_paged_kv_cache",
    "AbsmaxOptimizer",
    "HqqOptimizer",
    "MaxOptimizer",
    "qtype",
    "qtypes",
    "qfloat8",
    "qint2",
    "qint4",
    "qint8",
    "WeightQBitsArray",
    "WeightQBitsHopperArray",
    "WeightQBitsRequantArray",
    "WeightQBytesArray",
    "quantize_weight",
]
