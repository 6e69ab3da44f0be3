"""Carry float weights across from numpy state dicts.

Counterpart of the loading half of `quanto_tpu/models/loading.py` for float
weights: `load_hf_numpy_state_dict` fills a port model from a torch-convention
dict of numpy arrays (`weight` in [out, in]), such as the one
`quanto_tpu.models.loading.hf_state_dict` produces after `np.asarray`.
Quantized checkpoints wait for the serialization slice.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


__all__ = ["numpy_to_torch", "load_hf_numpy_state_dict"]


def numpy_to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy array -> CPU tensor; bfloat16 arrays (numpy has no such dtype of
    its own) come across by bit pattern: view(uint16) -> view(bfloat16)."""
    a = np.require(a, requirements=["C", "W"])  # copies only read-only or strided arrays
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def load_hf_numpy_state_dict(model: nn.Module, tensors: Mapping[str, np.ndarray]) -> Dict[str, list]:
    """Copy each named float tensor into the model parameter of that name
    (cast to its dtype and device). Returns {"missing", "unexpected"} names."""
    params = dict(model.named_parameters())
    unexpected = []
    for name, arr in tensors.items():
        p = params.get(name)
        if p is None:
            unexpected.append(name)
            continue
        t = numpy_to_torch(np.asarray(arr))
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != parameter {tuple(p.shape)}")
        p.copy_(t)
    missing = [name for name in params if name not in tensors]
    return {"missing": missing, "unexpected": unexpected}
