"""Carry float weights and KV caches across from numpy arrays.

Counterpart of the loading half of `quanto_tpu/models/loading.py` for float
weights: `load_hf_numpy_state_dict` fills a port model from a torch-convention
dict of numpy arrays (`weight` in [out, in]; the activation scales of a
calibrated model), such as the one `quanto_tpu.models.loading.hf_state_dict`
produces after `np.asarray`.
`qkv_layer_from_numpy` turns the fields of a JAX `QKVCacheLayer`, as numpy
arrays, into the port's cache layer. Quantized checkpoints wait for the
serialization slice.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..tensor.kv_cache import QKVCacheLayer, pack_int4_codes


__all__ = ["numpy_to_torch", "load_hf_numpy_state_dict", "qkv_layer_from_numpy"]

_FP8 = ("float8_e4m3fn", "float8_e4m3fnuz", "float8_e5m2")


def numpy_to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy array -> CPU tensor. bfloat16 and float8 arrays (numpy has no
    such dtypes of its own) come across by bit pattern: view(uint16) ->
    view(bfloat16), view(uint8) -> view(float8_*)."""
    a = np.require(a, requirements=["C", "W"])  # copies only read-only or strided arrays
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype.name in _FP8:
        return torch.from_numpy(a.view(np.uint8)).view(getattr(torch, a.dtype.name))
    return torch.from_numpy(a)


def qkv_layer_from_numpy(fields: Mapping[str, np.ndarray], qtype_name: str) -> QKVCacheLayer:
    """A JAX `QKVCacheLayer`'s arrays (`_k_data`, `_k_scale`, `_v_data`,
    `_v_scale` and, for the "...a" specs, `_k_shift`/`_v_shift`) -> the
    port's layer on the CPU. int4 payloads come across as int8 codes and are
    nibble-packed (`tensor/kv_cache.py`); the others bit for bit."""

    def payload(a):
        if np.asarray(a).dtype.name == "int4":
            return pack_int4_codes(torch.from_numpy(np.asarray(a).astype(np.int8)))
        return numpy_to_torch(np.asarray(a))

    def opt(name):
        a = fields.get(name)
        return None if a is None else numpy_to_torch(np.asarray(a))

    return QKVCacheLayer(
        _k_data=payload(fields["_k_data"]),
        _k_scale=numpy_to_torch(np.asarray(fields["_k_scale"])),
        _v_data=payload(fields["_v_data"]),
        _v_scale=numpy_to_torch(np.asarray(fields["_v_scale"])),
        qtype_name=qtype_name,
        _k_shift=opt("_k_shift"),
        _v_shift=opt("_v_shift"),
    )


_SCALE_BUFFERS = ("input_scale", "output_scale")


@torch.no_grad()
def load_hf_numpy_state_dict(model: nn.Module, tensors: Mapping[str, np.ndarray]) -> Dict[str, list]:
    """Copy each named float tensor into the model parameter of that name, or
    into a quantized module's `input_scale` / `output_scale` buffer (the keys
    `quanto_tpu.models.loading.hf_state_dict` emits for a calibrated model),
    cast to its dtype and device. Returns {"missing", "unexpected"} names."""
    params = dict(model.named_parameters())
    params.update(
        (name, b) for name, b in model.named_buffers() if name.rpartition(".")[2] in _SCALE_BUFFERS
    )
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
