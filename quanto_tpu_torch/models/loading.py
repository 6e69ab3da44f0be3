"""Hugging Face checkpoint interop: torch-convention state dicts.

Counterpart of `quanto_tpu/models/loading.py`. The port's modules already
hold torch's conventions (`weight` in [out, in], quantized weights in quanto's
flattened form, `serialization.py`), so `hf_state_dict` is the model's flat
state and `load_hf_state_dict` fills a model from one: float weights, the
activation scales of a calibrated model, and quantized weights (rebuilt
frozen, and repacked into the Hopper layout on a CUDA device), from torch
tensors, numpy arrays (`quanto_tpu.models.loading.hf_state_dict` after
`np.asarray`) or a lazily read checkpoint. A model built on "meta" is
allocated a tensor at a time on `device`, so a checkpoint larger than the
device in float loads within its own bytes. `qkv_layer_from_numpy` turns the
fields of a JAX `QKVCacheLayer`, as numpy arrays, into the port's cache
layer.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..parallel.moe import StackedSparseMoeBlock
from ..serialization import load_tensors_into, numpy_to_torch, state_dict
from ..tensor.kv_cache import QKVCacheLayer, pack_int4_codes


__all__ = ["hf_state_dict", "load_hf_state_dict", "qkv_layer_from_numpy"]


def _refuse_stacked(model: nn.Module) -> None:
    """quanto's names hold per-expert linears (`block_sparse_moe.experts.{e}.w1`);
    JAX's `hf_state_dict` has none for a stacked block."""
    if any(isinstance(m, StackedSparseMoeBlock) for m in model.modules()):
        raise ValueError(
            "a StackedSparseMoeBlock has no Hugging Face names: save and load the model with per-expert "
            "modules, and call convert_moe_to_stacked after loading"
        )


def hf_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model as a torch-convention state dict with quanto keys for its
    quantized modules (`serialization.state_dict`), in the JAX package's
    order; equal, tensor by tensor, to `quanto_tpu.models.loading.hf_state_dict`
    of the same model."""
    _refuse_stacked(model)
    return state_dict(model)


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


@torch.no_grad()
def load_hf_state_dict(model: nn.Module, tensors: Mapping, device=None) -> Dict[str, list]:
    """Fill the model from a torch-convention state dict (float or
    quanto-quantized: `serialization.load_tensors_into`): each parameter and
    activation scale cast to its dtype, each quantized module's weight rebuilt
    frozen. `device` places the tensors (by default where the model's are; a
    model on "meta" needs it). Returns {"missing", "unexpected"} names."""
    _refuse_stacked(model)
    return load_tensors_into(model, tensors, device)
