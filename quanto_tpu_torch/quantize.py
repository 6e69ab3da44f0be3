"""Model-level quantization workflow.

PyTorch counterpart of `quanto_tpu/quantize.py`: walk the module tree, swap
quantizable modules for their quantized counterparts (fnmatch
include/exclude filters on module names), freeze, produce the serializable
quantization map, and requantize a skeleton from a (state dict, map) pair.
"""

from __future__ import annotations

import fnmatch
from typing import List, Optional, Union

from torch import nn

from .nn.qmodule import QModuleMixin, quantize_module
from .serialization import load_state_dict, sorted_modules
from .tensor.optimizers import Optimizer
from .tensor.qtype import qtype


__all__ = ["quantize", "freeze", "quantization_map", "requantize", "named_qmodules", "set_module_by_name"]


def set_module_by_name(model: nn.Module, name: str, new_module: nn.Module) -> None:
    parent_name, _, last = name.rpartition(".")
    parent = model.get_submodule(parent_name) if parent_name else model
    setattr(parent, last, new_module)


def named_qmodules(model: nn.Module):
    """(name, qmodule) pairs for every quantized module in the tree (the root
    itself included, under the empty name)."""
    for name, m in model.named_modules():
        if isinstance(m, QModuleMixin):
            yield name, m


def quantize(
    model: nn.Module,
    weights: Optional[Union[str, qtype]] = None,
    activations: Optional[Union[str, qtype]] = None,
    optimizer: Optional[Optimizer] = None,
    include: Optional[Union[str, List[str]]] = None,
    exclude: Optional[Union[str, List[str]]] = None,
) -> None:
    """Swap quantizable submodules for quantized versions, in place."""
    if isinstance(include, str):
        include = [include]
    if isinstance(exclude, str):
        exclude = [exclude]
    # Materialize the walk first: the tree is mutated while iterating.
    candidates = [
        (name, m) for name, m in model.named_modules() if name and not isinstance(m, QModuleMixin)
    ]
    for name, m in candidates:
        if include is not None and not any(fnmatch.fnmatch(name, p) for p in include):
            continue
        if exclude is not None and any(fnmatch.fnmatch(name, p) for p in exclude):
            continue
        qmodule = quantize_module(m, weights=weights, activations=activations, optimizer=optimizer)
        if qmodule is not None:
            set_module_by_name(model, name, qmodule)


def freeze(model: nn.Module, w4a8_requant_dot: bool = False) -> None:
    """Freeze every quantized module (`QModuleMixin.freeze`).

    `w4a8_requant_dot=True` freezes each int4 or int2 weight that takes the
    Hopper layout into its requant form, and converts the Hopper weights of
    an already frozen model. The requant route is approximate (a per-channel
    int8 step about 8x finer than the coarsest group's int4 step and 42x
    finer than its int2 step, `quanto_tpu/ops/config.py:164-185`), so it is
    never taken by default."""
    for _, m in named_qmodules(model):
        m.freeze(w4a8_requant_dot=w4a8_requant_dot)


def quantization_map(model: nn.Module) -> dict:
    """Serializable {module name: {"weights": ..., "activations": ...}} map
    (`quanto_tpu/quantize.py:123-132`), in the JAX package's module order."""
    return {
        name: {
            "weights": "none" if m.weight_qtype is None else m.weight_qtype.name,
            "activations": "none" if m.activation_qtype is None else m.activation_qtype.name,
        }
        for name, m in sorted_modules(model)
        if isinstance(m, QModuleMixin)
    }


def requantize(model: nn.Module, state_dict, quantization_map: dict, device=None) -> dict:
    """Swap in the quantized modules of `quantization_map` and load
    `state_dict` (quanto's flat tensors), rebuilding the frozen weights
    (`quanto_tpu/quantize.py:135-163`); missing and unexpected tensors are
    not an error (`strict=False`): the {"missing", "unexpected"} report is
    returned. `device` places every loaded tensor (by default where the
    model's tensors are); a model built on "meta" needs it, and is then
    allocated a tensor at a time without its float weights."""
    for name, cfg in quantization_map.items():
        weights = None if cfg["weights"] == "none" else cfg["weights"]
        activations = None if cfg["activations"] == "none" else cfg["activations"]
        try:
            m = model.get_submodule(name)
        except AttributeError:
            continue
        qmodule = quantize_module(m, weights=weights, activations=activations)
        if qmodule is not None:
            set_module_by_name(model, name, qmodule)
    return load_state_dict(model, state_dict, strict=False, device=device)
