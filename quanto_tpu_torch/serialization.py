"""State-dict serialization of quantized models.

PyTorch counterpart of `quanto_tpu/serialization.py`. `state_dict` gives a
flat `{name: tensor}` dict whose keys follow quanto's flattened names, so
that checkpoints interoperate with the JAX package's and optimum-quanto's
safetensors files:

- 8-bit weights: `{module}.weight._data` (int8 or float8 codes, viewed, not
  converted) and `{module}.weight._scale` (0-d, or per axis [N, 1]);
- int4 and int2 weights: `{module}.weight._data._data` (quanto's packed
  uint8), `{module}.weight._scale` and `{module}.weight._shift`. A Hopper or
  requant-form weight is saved through `to_generic`; the requant form's `_s8`
  is derived again by `freeze(model, w4a8_requant_dot=True)`, not stored;
- activation scales: `{module}.input_scale` and `{module}.output_scale`;
- every other parameter and persistent buffer under its dotted name.

A frozen weight is a plain attribute of its module, not a `Parameter`, so
`nn.Module.state_dict()` does not see it: these functions walk the modules.
Modules come in the JAX package's order (its graph walk sorts each level's
names, list indices as numbers), so that the same model gives the same file,
byte for byte.

`load_state_dict` rebuilds each frozen weight from the flat tensors with its
module's quantization config (`_rebuild_qweight`): an int4 or int2 weight on
a CUDA device is repacked into the Hopper layout, as `QModuleMixin.freeze`
does there. A module still on "meta" (a model built without memory) is
allocated on `device` tensor by tensor, and its float weight never is.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .nn.qmodule import QModuleMixin
from .tensor.packed import PackedArray
from .tensor.qarray import QArray
from .tensor.weights import WeightQBitsArray, WeightQBitsHopperArray, WeightQBytesArray
from .utils import safetensors_io
from .utils.safetensors_io import LazySafetensors


__all__ = ["numpy_to_torch", "sorted_modules", "state_dict", "load_state_dict", "save_file", "load_file"]

_FP8 = ("float8_e4m3fn", "float8_e4m3fnuz", "float8_e5m2")
# The flat keys of a quantized weight, after `{module}.weight`.
_QWEIGHT_SUFFIXES = ("._data", "._scale", "._shift", "._data._data")


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


def _order_key(name: str):
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split(".")) if name else ()


def sorted_modules(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    """(name, module) pairs in the JAX package's graph order: names sorted
    level by level, list indices as numbers (`layers.2` before `layers.10`)."""
    return sorted(model.named_modules(), key=lambda nm: _order_key(nm[0]))


def _flatten_weight(prefix: str, value, out: Dict[str, torch.Tensor]) -> None:
    """quanto's flattened tensors of a weight under `prefix` (`serialization.py:43`)."""
    if isinstance(value, WeightQBitsHopperArray):
        value = value.to_generic()  # the requant form's `_s8` is not stored
    if isinstance(value, WeightQBytesArray):
        out[f"{prefix}._data"] = value._data
        out[f"{prefix}._scale"] = value._scale
    elif isinstance(value, WeightQBitsArray):
        out[f"{prefix}._data._data"] = value._data.packed_data
        out[f"{prefix}._scale"] = value._scale
        out[f"{prefix}._shift"] = value._shift
    elif isinstance(value, QArray):
        raise NotImplementedError(f"Cannot serialize QArray type {type(value).__name__}")
    else:
        out[prefix] = value


def _persistent_buffers(m: nn.Module):
    return [(n, b) for n, b in m.named_buffers(recurse=False) if n not in m._non_persistent_buffers_set]


def state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The flat state of a model, quanto keys for frozen weights; the tensors
    stay on their devices."""
    out: Dict[str, torch.Tensor] = {}
    for name, m in sorted_modules(model):
        prefix = name + "." if name else ""
        if isinstance(m, QModuleMixin) and m.frozen:
            _flatten_weight(f"{prefix}weight", m.weight, out)
        for pname, p in m.named_parameters(recurse=False):
            out[prefix + pname] = p.detach()
        for bname, b in _persistent_buffers(m):
            out[prefix + bname] = b
    return out


def _fetch(tensors: Mapping, name: str, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A copy of `tensors[name]` (a tensor, a numpy array, or a lazily read
    safetensors entry) on `device`, cast to `dtype` when given."""
    if isinstance(tensors, LazySafetensors):
        return tensors.get(name, device, dtype)
    v = tensors[name]
    if not isinstance(v, torch.Tensor):
        v = numpy_to_torch(np.asarray(v))
    return v.to(device=device, dtype=dtype, copy=True)


def _rebuild_qweight(module: QModuleMixin, prefix: str, tensors: Mapping, device) -> Optional[QArray]:
    """The frozen weight of `module` from the flat tensors under `prefix`
    (`serialization.py:73`), on `device`; None when they are absent. An int4
    or int2 weight on a CUDA device takes the Hopper layout where it fits its
    envelope."""
    qt = module.weight_qtype
    if qt is None:
        return None
    shape = (module.out_features, module.in_features)
    if qt.bits == 8:
        if f"{prefix}._data" not in tensors:
            return None
        data = _fetch(tensors, f"{prefix}._data", device)
        scale = _fetch(tensors, f"{prefix}._scale", device)
        if data.dtype != qt.dtype:
            # float8 codes are viewed, never converted (`serialization.py:86-87`).
            data = data.view(qt.dtype) if data.element_size() == 1 else data.to(qt.dtype)
        if tuple(data.shape) != shape:
            raise ValueError(f"{prefix}._data: shape {tuple(data.shape)}, the module's weight is {shape}")
        return WeightQBytesArray(
            _data=data,
            _scale=scale,
            qtype=qt,
            axis=None if scale.numel() == 1 else 0,
            float_dtype=scale.dtype,
            activation_qtype=module.activation_qtype,
        )
    if f"{prefix}._data._data" not in tensors:
        return None
    gs = module.weight_group_size
    N, K = shape
    gshape = (N * K // gs, gs) if gs is not None else shape
    packed = _fetch(tensors, f"{prefix}._data._data", device)
    per = 8 // qt.bits
    want = (-(-gshape[0] // per), gshape[1])
    if packed.dtype != torch.uint8 or tuple(packed.shape) != want:
        raise ValueError(f"{prefix}._data._data: {packed.dtype} {tuple(packed.shape)}, want uint8 {want}")
    scale = _fetch(tensors, f"{prefix}._scale", device)
    qw = WeightQBitsArray(
        _data=PackedArray(_data=packed, bits=qt.bits, orig_shape=gshape),
        _scale=scale,
        _shift=_fetch(tensors, f"{prefix}._shift", device),
        qtype=qt,
        axis=0,
        group_size=gs,
        orig_shape=shape,
        float_dtype=scale.dtype,
    )
    if qw.device.type == "cuda":
        qw = WeightQBitsHopperArray.from_generic(qw) or qw
    return qw


def _module_device(m: nn.Module, device):
    """Where `m`'s tensors load: `device` when given, else where they are; a
    module on "meta" needs `device`."""
    if device is not None:
        return torch.device(device)
    for t in (*m.parameters(recurse=False), *m.buffers(recurse=False)):
        if t.is_meta:
            raise ValueError("loading into a model on 'meta' needs a device")
        return t.device
    return None


@torch.no_grad()
def load_tensors_into(model: nn.Module, tensors: Mapping, device=None) -> Dict[str, list]:
    """Fill `model` from the flat `tensors` (the core of `load_state_dict` and
    `models/loading.py:load_hf_state_dict`): each quantized module's frozen
    weight rebuilt (`_rebuild_qweight`), every other parameter and persistent
    buffer copied, cast to its dtype, and placed on `device` (by default
    where it is). A tensor on "meta" is replaced, not copied into, so that
    the device holds each tensor once. The activation scales are reshaped to
    0-d, as JAX reshapes them. Returns {"missing", "unexpected"} names."""
    used, missing = set(), []
    for name, m in model.named_modules():
        prefix = name + "." if name else ""
        dev = _module_device(m, device)
        if isinstance(m, QModuleMixin) and m.weight_qtype is not None:
            wkey = f"{prefix}weight"
            qw = _rebuild_qweight(m, wkey, tensors, dev)
            if qw is not None:
                if "weight" in m._parameters:
                    del m.weight  # the float Parameter, never allocated on "meta"
                m.weight = qw
                used.update(k for k in (wkey + s for s in _QWEIGHT_SUFFIXES) if k in tensors)
            elif m.frozen:
                missing.append(wkey)
        for pname, p in list(m.named_parameters(recurse=False)):
            key = prefix + pname
            if key not in tensors:
                missing.append(key)
                continue
            t = _fetch(tensors, key, dev, p.dtype if p.is_floating_point() else None)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} != parameter {tuple(p.shape)}")
            if p.is_meta or p.device != t.device:
                setattr(m, pname, nn.Parameter(t, requires_grad=p.requires_grad))
            else:
                p.copy_(t)
            used.add(key)
        for bname, b in _persistent_buffers(m):
            key = prefix + bname
            if key not in tensors:
                missing.append(key)
                continue
            t = _fetch(tensors, key, dev, b.dtype)
            if t.numel() != b.numel():
                raise ValueError(f"{key}: shape {tuple(t.shape)} != buffer {tuple(b.shape)}")
            t = t.reshape(b.shape)
            if b.is_meta or b.device != t.device:
                m._buffers[bname] = t
            else:
                b.copy_(t)
            used.add(key)
    unexpected = [k for k in tensors.keys() if k not in used]
    return {"missing": missing, "unexpected": unexpected}


def load_state_dict(model: nn.Module, sd: Mapping, strict: bool = True, device=None) -> Dict[str, list]:
    """Load a flat state dict, rebuilding frozen weights (`load_tensors_into`).
    Returns {"missing": [...], "unexpected": [...]}; with `strict`, raises
    `KeyError` when either is not empty (`serialization.py:174-175`)."""
    report = load_tensors_into(model, sd, device)
    if strict and (report["missing"] or report["unexpected"]):
        raise KeyError(
            f"state dict mismatch: missing={report['missing'][:5]} unexpected={report['unexpected'][:5]}"
        )
    return report


def save_file(model: nn.Module, path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    safetensors_io.save_file(state_dict(model), path, metadata=metadata)


def load_file(model: nn.Module, path: str, strict: bool = True) -> Dict[str, list]:
    with LazySafetensors.from_files([path]) as tensors:
        return load_state_dict(model, tensors, strict=strict)
