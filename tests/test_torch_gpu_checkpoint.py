"""Checkpoints saved and loaded on a CUDA card (marked `gpu`; skips without one).

This file imports only torch, numpy and the port, so it runs on the card's
machine:

    python -m pytest -m gpu tests/test_torch_gpu_checkpoint.py

A tiny model (bf16, seeded) built, quantized and frozen on the card is saved
with `QuantizedModelForCausalLM.save_pretrained` and loaded back on the card
with `from_pretrained`: every tensor the kernels read (the Hopper layout's
`_packed`, `_scale_t`, `_shift_t`; an 8-bit weight's `_data`, `_scale`; the
activation scales; the float parameters) is EQUAL to the original's, and so
are the logits and the kernel launches of one forward. Cases: Llama in qint4
(lm_head included), qint2 (at the int2 envelope's widths), qint8 and
calibrated W4A8, whose streamline flags are set on the loaded model from the
original's (quanto's format does not hold them); Mixtral with qint4 experts,
converted with `convert_moe_to_stacked` after the load.
"""

import dataclasses

import numpy as np
import pytest
import torch

import quanto_tpu_torch as qtt
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from quanto_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
from quanto_tpu_torch.models.transformers_models import QuantizedModelForCausalLM
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.ops.cuda import flash_decode as fd_mod
from quanto_tpu_torch.ops.cuda import moe_mm, qbits_mm, qbytes_mm
from quanto_tpu_torch.tensor.packed import PackedArray
from quanto_tpu_torch.tensor.qarray import QArray
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray, WeightQBytesArray

LLAMA = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rope_theta=500000.0)
LLAMA_INT2 = dict(LLAMA, hidden_size=512, intermediate_size=1024)
MIXTRAL = dict(LLAMA, intermediate_size=256, num_hidden_layers=1, num_local_experts=8, num_experts_per_tok=2)
CASES = {
    "qint4": (LLAMA, dict(weights="qint4")),
    "qint2": (LLAMA_INT2, dict(weights="qint2")),
    "qint8": (LLAMA, dict(weights="qint8", exclude="lm_head")),
    "w4a8": (LLAMA, dict(weights="qint4", activations="qint8", exclude="lm_head")),
    "mixtral_qint4": (MIXTRAL, dict(weights="qint4")),
}
WRAPPERS = [
    qbits_mm.qbits_mm_small_m, qbits_mm.qbits_mm_tiled, qbits_mm.qbits_mm_int8_small_m, qbits_mm.qbits_mm_tiled_int8,
    qbytes_mm.qbytes_mm_int8, fd_mod.flash_decode, moe_mm.qbits_moe_small_m, moe_mm.qbits_moe_tiled,
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def device_tensors(model) -> dict:
    """Every tensor a forward reads: parameters, buffers and the fields of
    each frozen weight, by name."""
    out = {}
    for name, m in model.named_modules():
        for n, t in [*m.named_parameters(recurse=False), *m.named_buffers(recurse=False)]:
            out[f"{name}.{n}"] = t
        w = getattr(m, "weight", None)
        if isinstance(w, QArray):
            for f in dataclasses.fields(w):
                v = getattr(w, f.name)
                v = v.packed_data if isinstance(v, PackedArray) else v
                if isinstance(v, torch.Tensor):
                    out[f"{name}.weight.{f.name}"] = v
    return out


def forward(model, ids) -> tuple:
    before = [w.launches for w in WRAPPERS]
    with torch.no_grad():
        logits = model(ids)[0]
    torch.cuda.synchronize()
    return logits, [w.launches - b for w, b in zip(WRAPPERS, before)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_save_and_load_on_the_card(cuda_device, tmp_path, case):
    config, quant = CASES[case]
    mixtral = case.startswith("mixtral")
    cls, config_cls = (MixtralForCausalLM, MixtralConfig) if mixtral else (LlamaForCausalLM, LlamaConfig)
    model = cls(config_cls(**config, dtype=torch.bfloat16), device="cuda",
                generator=torch.Generator("cuda").manual_seed(0))
    qtt.quantize(model, **quant)
    rng = np.random.default_rng(0)
    if "activations" in quant:
        with torch.no_grad(), qtt.Calibration(model):
            for _ in range(2):
                model(torch.from_numpy(rng.integers(0, 512, (2, 64))).to(cuda_device))
    qtt.freeze(model)
    QuantizedModelForCausalLM(model).save_pretrained(str(tmp_path), max_shard_size="1MB")
    flags = {n: m.quantize_outputs for n, m in qtt.named_qmodules(model)}
    loaded = QuantizedModelForCausalLM.from_pretrained(str(tmp_path))._wrapped
    for n, m in qtt.named_qmodules(loaded):
        m.quantize_outputs = flags[n]
    if mixtral:
        assert qtt.convert_moe_to_stacked(model) == 1 and qtt.convert_moe_to_stacked(loaded) == 1

    want, got = device_tensors(model), device_tensors(loaded)
    assert list(got) == list(want)
    for name, t in want.items():
        assert got[name].device.type == "cuda" and got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name
    hopper = [m.weight for m in loaded.modules() if isinstance(m, QLinear)]
    layout = WeightQBytesArray if quant["weights"] == "qint8" else WeightQBitsHopperArray
    assert hopper and any(isinstance(w, layout) for w in hopper)

    ids = torch.from_numpy(rng.integers(0, 512, (2, 40))).to(cuda_device)
    ref, ref_launches = forward(model, ids)
    out, launches = forward(loaded, ids)
    assert torch.isfinite(ref).all() and sum(ref_launches) > 0
    assert torch.equal(out, ref) and launches == ref_launches
