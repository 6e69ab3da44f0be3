"""The port's main path on a tiny float32 Llama against quanto_tpu.

The JAX model's weights come across through `hf_state_dict` -> numpy ->
`load_hf_state_dict`; then float logits, qint4 weights (bit for bit),
qint4 logits, cached prefill with `logits_indices`, a per-row decode step and
greedy `generate` tokens are compared. The qint4 port runs in both weight
layouts: the generic one (dequantize + matmul, as frozen on a CPU) and the
Hopper kernel layout (the kernels' plain versions on a CPU tensor). Logits
agree within 1e-4 * max|ref|: float32 sums in another order.

Under 8-bit weights (qint8 and qfloat8, lm_head excluded) the codes and
scales are bit for bit JAX's, and cached-prefill logits, a per-row decode step
and 8 greedy tokens agree as above (`test_torch_w4a8.py` holds the W4A8 arm).

The qint4 model also runs over each quantized KV cache spec
(`init_kv_cache(kv_quant=spec)`): cached prefill logits, one per-row decode
step (the port's goes through `flash_decode`, whose plain version runs on a
CPU tensor; JAX's through its einsum path) and 8 greedy tokens. Symmetric
specs: logits within 1e-4 * max|ref| and identical tokens. Asymmetric ("...a")
specs: the per-slot mean may differ in its last bit between torch and jnp,
which can move a code by one step (`tests/test_torch_kv_cache.py`), so logits
are held within 2e-3 * max|ref| (on these seeds they agree within 1e-4) and
the greedy tokens must still be identical. qint8 is also held against JAX with its Pallas flash-decode kernel
forced on (interpret mode, a 128-slot cache).
"""

import ast
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
from quanto_tpu.ops import config as jax_ops_config
from quanto_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quanto_tpu.models.llama import LlamaForCausalLM as JaxLlama
from quanto_tpu.models.llama import init_kv_cache as jax_init_kv_cache
from quanto_tpu.models.llama import rope_params as jax_rope_params
from quanto_tpu.models.loading import hf_state_dict
from quanto_tpu.models.serve import generate as jax_generate
from quanto_tpu.tensor.weights import WeightQBytesArray as JaxWeightQBytesArray
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_kv_cache, rope_params
from quanto_tpu_torch.models.loading import load_hf_state_dict
from quanto_tpu_torch.models.serve import decode, generate, prefill
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

from .test_torch_qbytes import codes_of
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
KV_SPECS = ["qint8", "qint4", "k8v4", "k4v8", "qfloat8_e4m3fn", "qfloat8_e5m2", "qint4a", "k8v4a"]


def close(out: torch.Tensor, ref, tol: float = 1e-4) -> None:
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * np.max(np.abs(ref))


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


@nnx.jit
def _jax_steps(model, ids, cache, last, pos):
    prefill, cache = model(ids, cache, 0, logits_indices=last)
    step, _ = model(ids[:, :1], cache, pos)
    return prefill, step


def jax_steps(model, ids: np.ndarray) -> dict:
    """Cached prefill logits at the per-row `LAST` positions and one decode step
    at the per-row `DECODE_POS`, over a float cache of S slots (jitted: eager
    JAX costs seconds here)."""
    prefill, step = _jax_steps(
        model, jnp.asarray(ids, jnp.int32), jax_init_kv_cache(model.config, B, S),
        jnp.asarray(LAST), jnp.asarray(DECODE_POS),
    )
    return {"prefill": np.asarray(prefill), "step": np.asarray(step)}


def port_steps(model, ids: np.ndarray) -> dict:
    """The port's counterpart of `jax_steps`."""
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        cache = init_kv_cache(model.config, B, S, device="cpu")
        prefill, cache = model(ids, cache, 0, logits_indices=torch.from_numpy(LAST))
        step, _ = model(ids[:, :1], cache, torch.from_numpy(DECODE_POS))
    return {"prefill": prefill, "step": step}


@pytest.fixture(scope="module")
def jax_side():
    model = JaxLlama(JaxLlamaConfig(**TINY), rngs=nnx.Rngs(0))
    state = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    float_out = jax_outputs(model)
    qt.quantize(model, weights="qint4")
    qt.freeze(model)
    qstate = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    return state, float_out, qstate, jax_outputs(model)


def jax_kv_outputs(model, ids, spec) -> dict:
    """Cached prefill, a per-row decode step and greedy tokens over a
    `spec` cache, eagerly, from one JAX model."""
    cfg = model.config
    out = {}
    cache = jax_init_kv_cache(cfg, B, S, kv_quant=spec)
    out["prefill"], cache = model(ids, cache, 0, logits_indices=jnp.asarray(LAST))
    out["step"], _ = model(ids[:, :1], cache, jnp.asarray(DECODE_POS))
    cache = jax_init_kv_cache(cfg, B, T + NEW, kv_quant=spec)
    logits, cache = model(ids, cache, 0, logits_indices=T - 1)
    toks = [jnp.argmax(logits[:, -1], axis=-1).astype(ids.dtype)[:, None]]
    for i in range(NEW - 1):
        logits, cache = model(toks[-1], cache, T + i)
        toks.append(jnp.argmax(logits[:, -1], axis=-1).astype(ids.dtype)[:, None])
    out["tokens"] = np.concatenate([np.asarray(t) for t in toks], axis=1)
    return out


@pytest.fixture(scope="module")
def jax_kv_side():
    """The qint4 JAX model (the weights of `jax_side`) over every KV spec,
    and its qint8 decode step through the Pallas flash-decode kernel."""
    model = JaxLlama(JaxLlamaConfig(**TINY), rngs=nnx.Rngs(0))
    qt.quantize(model, weights="qint4")
    qt.freeze(model)
    ids = jnp.asarray(np.random.default_rng(0).integers(0, TINY["vocab_size"], (B, T)), jnp.int32)
    out = {spec: jax_kv_outputs(model, ids, spec) for spec in KV_SPECS}
    cache = jax_init_kv_cache(model.config, B, 128, kv_quant="qint8")
    _, cache = model(ids, cache, 0)
    jax_ops_config.set_backend(flash_decode=True)
    try:
        out["flash_qint8_step"], _ = model(ids[:, :1], cache, jnp.asarray(DECODE_POS))
    finally:
        jax_ops_config.set_backend()
    return np.array(ids), out


def port_model(state, layout=None):
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    report = load_hf_state_dict(model, state)
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


@pytest.fixture(scope="module")
def jax_qbytes_side():
    """The JAX model under 8-bit weights (lm_head excluded, as `bench.py`'s
    int8 arm): its quantized state and outputs, per weight qtype."""
    ids = np.random.default_rng(0).integers(0, TINY["vocab_size"], (B, T))
    out = {}
    for weights in ("qint8", "qfloat8"):
        model = JaxLlama(JaxLlamaConfig(**TINY), rngs=nnx.Rngs(0))
        qt.quantize(model, weights=weights, exclude="lm_head")
        qt.freeze(model)
        ref = jax_steps(model, ids)
        ref["tokens"] = np.asarray(jax_generate(model, jnp.asarray(ids, jnp.int32), NEW))
        ref["state"] = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
        assert isinstance(model.model.layers[0].mlp.up_proj.weight.get_value(), JaxWeightQBytesArray)
        out[weights] = ref
    return ids, out


@pytest.mark.parametrize("weights", ["qint8", "qfloat8"])
def test_qbytes_model_matches(jax_side, jax_qbytes_side, weights):
    """8-bit weight-only: codes and scales bit for bit, then cached-prefill
    logits and a per-row decode step (through the 8-bit kernel's plain
    version: every M here is inside its envelope) within 1e-4 * max|ref|,
    and 8 greedy tokens identical."""
    ids, outs = jax_qbytes_side
    ref = outs[weights]
    model = port_model(jax_side[0])
    qtt.quantize(model, weights=weights, exclude="lm_head")
    qtt.freeze(model)
    qlinears = [(n, m) for n, m in model.named_modules() if isinstance(m, QLinear)]
    assert len(qlinears) == 7 * TINY["num_hidden_layers"]
    for name, m in qlinears:
        assert isinstance(m.weight, qtt.WeightQBytesArray) and m.weight._scale.shape == (m.out_features, 1)
        np.testing.assert_array_equal(codes_of(m.weight._data), codes_of(ref["state"][f"{name}.weight._data"]))
        np.testing.assert_array_equal(bits_of(m.weight._scale), bits_of(ref["state"][f"{name}.weight._scale"]))
    got = port_steps(model, ids)
    close(got["prefill"], ref["prefill"])
    close(got["step"], ref["step"])
    np.testing.assert_array_equal(generate(model, torch.from_numpy(ids), NEW).numpy(), ref["tokens"])


@pytest.mark.parametrize("spec", KV_SPECS)
@pytest.mark.parametrize("layout", ["generic", "hopper"])
def test_quantized_kv_cache_model_matches(jax_side, jax_kv_side, layout, spec):
    state = jax_side[0]
    ids_np, outs = jax_kv_side
    ref = outs[spec]
    tol = 2e-3 if spec.endswith("a") else 1e-4
    model = port_model(state, layout)
    ids = torch.from_numpy(ids_np)
    with torch.no_grad():
        cache = init_kv_cache(model.config, B, S, kv_quant=spec, device="cpu")
        out, cache = model(ids, cache, 0, logits_indices=torch.from_numpy(LAST))
        close(out, ref["prefill"], tol)
        step, _ = model(ids[:, :1], cache, torch.from_numpy(DECODE_POS))
        close(step, ref["step"])
        cache = init_kv_cache(model.config, B, T + NEW, kv_quant=spec, device="cpu")
        logits, cache = prefill(model, ids, cache, last_only=True)
        first = logits[:, -1].argmax(-1).to(ids.dtype)[:, None]
        rest, _ = decode(model, first, cache, T, NEW - 1)
    np.testing.assert_array_equal(torch.cat([first, rest], 1).numpy(), ref["tokens"])


def test_qint8_decode_matches_jax_flash_kernel(jax_side, jax_kv_side):
    """A decode step over a 128-slot qint8 cache against JAX's step with its
    Pallas flash-decode kernel forced on (interpret mode)."""
    ids_np, outs = jax_kv_side
    model = port_model(jax_side[0], "hopper")
    ids = torch.from_numpy(ids_np)
    with torch.no_grad():
        cache = init_kv_cache(model.config, B, 128, kv_quant="qint8", device="cpu")
        _, cache = model(ids, cache, 0)
        step, _ = model(ids[:, :1], cache, torch.from_numpy(DECODE_POS))
    close(step, outs["flash_qint8_step"])


@pytest.mark.parametrize("scaling", [None, {"rope_type": "linear", "factor": 4.0}, ROPE])
def test_rope_params_match(scaling):
    """The ported rope variants (default, linear, llama3), bit for bit."""
    ref, _ = jax_rope_params(64, 500000.0, tuple(sorted(scaling.items())) if scaling else None)
    np.testing.assert_array_equal(rope_params(64, 500000.0, scaling)[0].numpy(), np.asarray(ref))


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, pulls in JAX or quanto_tpu,
    whether imported or read: the script's own import statements are parsed
    too, since its phases import the port inside functions. The modules of
    tensor parallelism (which the ranks that `torch.multiprocessing` spawns
    import) are among those checked."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import quanto_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'quanto_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'quanto_tpu')]\n"
        "assert not bad, bad\n"
        "tp = {'quanto_tpu_torch.parallel.distributed', 'quanto_tpu_torch.parallel.sharding',\n"
        "      'quanto_tpu_torch.ops.cuda.qbits_mm_sharded', 'quanto_tpu_torch.ops.collectives'}\n"
        "assert tp <= set(sys.modules), tp - set(sys.modules)\n"
        "print('ok', len([m for m in sys.modules if m.startswith('quanto_tpu_torch')]))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    banned = {"jax", "jaxlib", "flax", "quanto_tpu"}
    for path in [root / "chip_smoke.py", *sorted((root / "quanto_tpu_torch").rglob("*.py"))]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & banned, (path, names)
