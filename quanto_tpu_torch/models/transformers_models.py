"""Quantized model wrappers and checkpoint I/O.

PyTorch counterpart of `quanto_tpu/models/transformers_models.py`:
`QuantizedModelForCausalLM` quantizes and freezes a causal LM, saves
`config.json`, `quanto_qmap.json` and `model.safetensors` (or its shards and
index), and restores a quantized model from such a directory, whichever
package wrote it: the tensor names, their order, the packing and the file
bytes are the JAX package's.

The model families are the port's own (`models/llama.py`,
`models/mixtral.py`), chosen by `model_type` in `config.json`, which is read
and written as plain JSON (no `transformers` on the card's machine); the
port writes one that `transformers.AutoConfig` reads. `llama`, `mistral`,
`qwen2` (`models/llama.py` with q/k/v biases) and `mixtral` are ported.

Where it differs from JAX: JAX builds the float model and then swaps in the
quantized modules (`transformers_models.py:403-417`); Mixtral-8x7B is 93 GB
in bf16, more than the card holds. The port builds the model on "meta",
swaps in the quantized modules there, and allocates each tensor on the
device as it is read from its shard (`serialization.load_tensors_into`): the
device never holds a float copy of a quantized weight. A Mixtral loads with
per-expert modules (`block_sparse_moe.experts.{e}.w1/w2/w3`); the caller
converts it with `convert_moe_to_stacked`, as in JAX, and a stacked model
cannot be saved (quanto's names hold per-expert weights).

Calibration's streamline flags (`quantize_outputs`) are not part of quanto's
format, as in JAX and optimum-quanto: a loaded model with quantized
activations quantizes every module's output again.
"""

from __future__ import annotations

import json
import os
from typing import Union

import torch

from ..quantize import freeze as freeze_model
from ..quantize import quantization_map, quantize, requantize
from ..utils.safetensors_io import LazySafetensors, save_sharded
from .hub import resolve_model_path
from .llama import LlamaConfig, LlamaForCausalLM
from .loading import hf_state_dict, load_hf_state_dict
from .mixtral import MixtralConfig, MixtralForCausalLM


__all__ = ["QMAP_NAME", "QuantizedModelForCausalLM", "build_model", "from_pretrained_float"]

QMAP_NAME = "quanto_qmap.json"  # the reference's file name (`transformers_models.py:48`)
CONFIG_NAME = "config.json"

_FAMILIES = {
    "llama": (LlamaConfig, LlamaForCausalLM),
    "mistral": (LlamaConfig, LlamaForCausalLM),
    "qwen2": (LlamaConfig, LlamaForCausalLM),
    "mixtral": (MixtralConfig, MixtralForCausalLM),
}


def build_model(hf_config: dict, dtype=torch.bfloat16):
    """The port's model for a `config.json` dict, on "meta" (no memory)."""
    model_type = hf_config.get("model_type")
    if model_type not in _FAMILIES:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (ROADMAP.md Queue 1, item 8); "
            f"ported: {', '.join(_FAMILIES)}"
        )
    config_cls, model_cls = _FAMILIES[model_type]
    return model_cls(config_cls.from_hf(hf_config, dtype=dtype), device="meta")


def _load_config(directory: str) -> dict:
    with open(os.path.join(directory, CONFIG_NAME)) as f:
        return json.load(f)


def _load_tensors(directory: str) -> LazySafetensors:
    """A single-file or sharded (index + shards) checkpoint, read lazily
    (`transformers_models.py:313`)."""
    index_path = os.path.join(directory, "model.safetensors.index.json")
    single_path = os.path.join(directory, "model.safetensors")
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        return LazySafetensors.from_files(sorted({os.path.join(directory, v) for v in index["weight_map"].values()}))
    if os.path.exists(single_path):
        return LazySafetensors.from_files([single_path])
    raise FileNotFoundError(f"No model.safetensors(.index.json) found in {directory}")


def _finish(model, report: dict, directory: str, device, hf_config: dict):
    """The rotary table (no checkpoint holds it), then a check that every
    other tensor came from the checkpoint."""
    model.init_rope_(device)
    left = [n for n, t in [*model.named_parameters(), *model.named_buffers()] if t.is_meta]
    if report["missing"] or left:
        raise KeyError(f"{directory}: the checkpoint lacks {(report['missing'] or left)[:5]}")
    model.hf_config = hf_config
    return model


def from_pretrained_float(
    name_or_path: str, dtype=torch.bfloat16, device="cuda", revision=None, cache_dir=None
):
    """A float Hugging Face checkpoint (llama, mistral, qwen2, mixtral) in the
    port's model, allocated on `device` a tensor at a time; a tied one needs
    no `lm_head.weight`."""
    directory = resolve_model_path(name_or_path, revision=revision, cache_dir=cache_dir)
    hf_config = _load_config(directory)
    model = build_model(hf_config, dtype=dtype)
    with _load_tensors(directory) as tensors:
        report = load_hf_state_dict(model, tensors, device=device)
    return _finish(model, report, directory, device, hf_config)


class QuantizedModelForCausalLM:
    """A quantized causal LM and its checkpoint I/O
    (`transformers_models.py:347-469`); other attributes and calls go to the
    wrapped model."""

    def __init__(self, model):
        self._wrapped = model

    def __getattr__(self, name):
        return getattr(self._wrapped, name)

    def __call__(self, *args, **kwargs):
        return self._wrapped(*args, **kwargs)

    @classmethod
    def quantize(
        cls, model, weights=None, activations=None, optimizer=None, include=None, exclude=None
    ) -> "QuantizedModelForCausalLM":
        """Quantize and freeze the model (`quantize`, `freeze`)."""
        quantize(model, weights=weights, activations=activations, optimizer=optimizer, include=include, exclude=exclude)
        freeze_model(model)
        return cls(model)

    @classmethod
    def from_pretrained(
        cls, name_or_path: str, dtype=torch.bfloat16, device="cuda", revision=None, cache_dir=None
    ) -> "QuantizedModelForCausalLM":
        """Load a quantized model saved by `save_pretrained` (the port's or the
        JAX package's): built on "meta", its modules
        swapped per `quanto_qmap.json`, then each tensor read from its shard
        onto `device` (CUDA unless the caller passes "cpu"). On a CUDA device
        an int4 or int2 weight takes the Hopper layout, as `freeze` gives it;
        on the CPU it stays generic."""
        directory = resolve_model_path(name_or_path, revision=revision, cache_dir=cache_dir)
        qmap_path = os.path.join(directory, QMAP_NAME)
        if not os.path.exists(qmap_path):
            raise ValueError(f"No {QMAP_NAME} found in {directory}: this is not a quantized model directory.")
        with open(qmap_path) as f:
            qmap = json.load(f)
        hf_config = _load_config(directory)
        model = build_model(hf_config, dtype=dtype)
        with _load_tensors(directory) as tensors:
            report = requantize(model, tensors, qmap, device=device)
        return cls(_finish(model, report, directory, device, hf_config))

    def save_pretrained(self, directory: str, max_shard_size: Union[int, str] = "5GB") -> None:
        """Write `config.json`, `quanto_qmap.json` and `model.safetensors`
        (`transformers_models.py:420-445`), or, above `max_shard_size`,
        `model-XXXXX-of-XXXXX.safetensors` shards and their index."""
        os.makedirs(directory, exist_ok=True)
        model = self._wrapped
        hf_config = getattr(model, "hf_config", None) or model.config.to_hf()
        with open(os.path.join(directory, CONFIG_NAME), "w") as f:
            json.dump(hf_config, f, indent=2, sort_keys=True)
            f.write("\n")
        with open(os.path.join(directory, QMAP_NAME), "w") as f:
            json.dump(quantization_map(model), f, indent=2)
        save_sharded(hf_state_dict(model), directory, max_shard_size)
