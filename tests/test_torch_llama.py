"""The port's main path on a tiny float32 Llama against quanto_tpu.

The JAX model's weights come across through `hf_state_dict` -> numpy ->
`load_hf_numpy_state_dict`; then float logits, qint4 weights (bit for bit),
qint4 logits, cached prefill with `logits_indices`, a per-row decode step and
greedy `generate` tokens are compared. The qint4 port runs in both weight
layouts: the generic one (dequantize + matmul, as frozen on a CPU) and the
Hopper kernel layout (the kernels' plain versions on a CPU tensor). Logits
agree within 1e-4 * max|ref|: float32 sums in another order.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quanto_tpu.models.llama import LlamaForCausalLM as JaxLlama
from quanto_tpu.models.llama import init_kv_cache as jax_init_kv_cache
from quanto_tpu.models.llama import rope_params as jax_rope_params
from quanto_tpu.models.loading import hf_state_dict
from quanto_tpu.models.serve import generate as jax_generate
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_kv_cache, rope_params
from quanto_tpu_torch.models.loading import load_hf_numpy_state_dict
from quanto_tpu_torch.models.serve import generate
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

from .test_torch_quantize import bits_of

ROPE = {
    "rope_type": "llama3",
    "factor": 8.0,
    "low_freq_factor": 1.0,
    "high_freq_factor": 4.0,
    "original_max_position_embeddings": 64,
}
TINY = dict(
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    rope_theta=500000.0,
    rope_scaling=tuple(sorted(ROPE.items())),
)
B, T, NEW, S = 2, 16, 8, 24
LAST = np.array([15, 9])  # per-row logits_indices
DECODE_POS = np.array([16, 11])  # per-row cache_pos of one decode step


def close(out: torch.Tensor, ref) -> None:
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= 1e-4 * np.max(np.abs(ref))


def jax_outputs(model) -> dict:
    """Every output the tests compare, from one JAX model."""
    ids = jnp.asarray(np.random.default_rng(0).integers(0, TINY["vocab_size"], (B, T)), jnp.int32)
    cfg = model.config
    out = {"ids": np.array(ids), "logits": model(ids)[0]}
    cache = jax_init_kv_cache(cfg, B, S)
    out["prefill"], cache = model(ids, cache, 0, logits_indices=jnp.asarray(LAST))
    tok = ids[:, :1]
    out["step"], _ = model(tok, cache, jnp.asarray(DECODE_POS))
    out["tokens"] = np.asarray(jax_generate(model, ids, NEW))
    return out


@pytest.fixture(scope="module")
def jax_side():
    model = JaxLlama(JaxLlamaConfig(**TINY), rngs=nnx.Rngs(0))
    state = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    float_out = jax_outputs(model)
    qt.quantize(model, weights="qint4")
    qt.freeze(model)
    qstate = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    return state, float_out, qstate, jax_outputs(model)


def port_model(state, layout=None):
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    report = load_hf_numpy_state_dict(model, state)
    assert report == {"missing": [], "unexpected": []}
    if layout is not None:
        qtt.quantize(model, weights="qint4")
        qtt.freeze(model)
        if layout == "hopper":
            for m in model.modules():
                if isinstance(m, QLinear):
                    m.weight = WeightQBitsHopperArray.from_generic(m.weight)
                    assert m.weight is not None
    return model


def check_outputs(model, ref) -> None:
    ids = torch.from_numpy(ref["ids"])
    with torch.no_grad():
        close(model(ids)[0], ref["logits"])
        cache = init_kv_cache(model.config, B, S, device="cpu")
        prefill, cache = model(ids, cache, 0, logits_indices=torch.from_numpy(LAST))
        close(prefill, ref["prefill"])
        step, _ = model(ids[:, :1], cache, torch.from_numpy(DECODE_POS))
        close(step, ref["step"])
    np.testing.assert_array_equal(generate(model, ids, NEW).numpy(), ref["tokens"])


def test_float_model_matches(jax_side):
    state, float_out, _, _ = jax_side
    check_outputs(port_model(state), float_out)


@pytest.mark.parametrize("layout", ["generic", "hopper"])
def test_qint4_model_matches(jax_side, layout):
    state, _, qstate, q_out = jax_side
    model = port_model(state, layout)
    n_quantized = 0
    for name, m in model.named_modules():
        if isinstance(m, QLinear):
            w = m.weight.to_generic() if layout == "hopper" else m.weight
            for key, t in (
                ("weight._data._data", w._data.packed_data),
                ("weight._scale", w._scale),
                ("weight._shift", w._shift),
            ):
                np.testing.assert_array_equal(bits_of(t), bits_of(qstate[f"{name}.{key}"]))
            n_quantized += 1
    assert n_quantized == 7 * TINY["num_hidden_layers"] + 1  # lm_head included
    check_outputs(model, q_out)


@pytest.mark.parametrize("scaling", [None, {"rope_type": "linear", "factor": 4.0}, ROPE])
def test_rope_params_match(scaling):
    """The ported rope variants (default, linear, llama3), bit for bit."""
    ref, _ = jax_rope_params(64, 500000.0, tuple(sorted(scaling.items())) if scaling else None)
    np.testing.assert_array_equal(rope_params(64, 500000.0, scaling).numpy(), np.asarray(ref))


def test_port_imports_no_jax():
    """No module of the port (nor chip_smoke.py) pulls in JAX or quanto_tpu."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import quanto_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'quanto_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'quanto_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('quanto_tpu_torch')]))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
