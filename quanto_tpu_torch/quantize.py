"""Model-level quantization workflow.

PyTorch counterpart of `quanto_tpu/quantize.py:67-121`: walk the module tree,
swap quantizable modules for their quantized counterparts (fnmatch
include/exclude filters on module names), and freeze.
"""

from __future__ import annotations

import fnmatch
from typing import List, Optional, Union

from torch import nn

from .nn.qmodule import QModuleMixin, quantize_module
from .tensor.optimizers import Optimizer
from .tensor.qtype import qtype


__all__ = ["quantize", "freeze", "named_qmodules", "set_module_by_name"]


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


def freeze(model: nn.Module) -> None:
    """Freeze every quantized module."""
    for _, m in named_qmodules(model):
        m.freeze()
