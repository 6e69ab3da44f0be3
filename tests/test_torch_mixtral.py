"""The port's Mixtral and its stacked-expert dispatch against quanto_tpu.

Model (1 layer, hidden and intermediate 256, 8 experts, top-2, float32): the JAX model's
weights come across through `hf_state_dict` -> numpy ->
`load_hf_numpy_state_dict`. Against JAX's dense-mask model, float and qint4
(lm_head excluded), the port's dense-mask model and its stacked model
(`convert_moe_to_stacked(capacity_factor=None)`, experts repacked to the
Hopper layout; the kernels' plain versions on a CPU tensor) give the same
cached-prefill logits at per-row positions (the all-experts route) and one
per-row decode step (the selective route), and under qint4 the same 8 greedy
tokens. Before the outputs are compared, every MoE block's top-2 experts are
asserted equal to JAX's, and JAX's 2nd and 3rd routing probabilities are
asserted apart by at least 1e-5 on these seeds (100 times float32's rounding
of them), so no routing tie can flip between the packages. Logits agree
within 1e-4 * max|ref| (float32 sums in another order).

Block (qint4, the same codes on both sides): `StackedSparseMoeBlock` against
JAX's, whose MoE kernels run in interpret mode, on the selective, all-experts
and capacity routes at `capacity_factor` 2.0 and None, and on both branches
of JAX's unique-expert boundary (at most 6 and all 8 experts routed), within
2e-5 * max|ref| (the TPU kernels sum group-factored, the plain versions
dequantize first, then the down projection and the combine).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.models.loading import hf_state_dict
from quanto_tpu.models.llama import init_kv_cache as jax_init_kv_cache
from quanto_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from quanto_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from quanto_tpu.models.mixtral import MixtralSparseMoeBlock as JaxMoeBlock
from quanto_tpu.models.serve import generate as jax_generate
from quanto_tpu.ops import config as jax_ops_config
from quanto_tpu.parallel import StackedSparseMoeBlock as JaxStackedBlock
from quanto_tpu_torch.models.llama import init_kv_cache
from quanto_tpu_torch.models.loading import load_hf_numpy_state_dict
from quanto_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM, MixtralSparseMoeBlock, route
from quanto_tpu_torch.models.serve import generate
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.ops.cuda import moe_mm
from quanto_tpu_torch.parallel import StackedSparseMoeBlock, convert_moe_to_stacked
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

from .test_torch_quantize import bits_of

TINY = dict(
    vocab_size=512,
    hidden_size=256,
    intermediate_size=256,
    num_hidden_layers=1,
    num_attention_heads=4,
    num_key_value_heads=2,
    rope_theta=1e6,
    rms_norm_eps=1e-5,
    num_local_experts=8,
    num_experts_per_tok=2,
)
B, T, NEW, S = 2, 16, 8, 24
LAST = np.array([15, 9])  # per-row logits_indices
DECODE_POS = np.array([16, 11])  # per-row cache_pos of one decode step


def close(out: torch.Tensor, ref, tol: float = 1e-4) -> None:
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * np.max(np.abs(ref))


def token_ids(shape, seed):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], shape).astype(np.int32)


def jax_probs(gate, x):
    """The JAX router's float32 softmax over the gate's logits."""
    logits = gate(x)
    logits = logits.dequantize() if hasattr(logits, "dequantize") else logits
    return jax.nn.softmax(logits.astype(jnp.float32), axis=-1)


_ROUTING = []  # (top-k experts, least gap between the k-th and (k+1)-th probability) per block call
_JAX_BLOCK_CALL = JaxMoeBlock.__call__


def _recording_call(block, x):
    p, i = jax.lax.top_k(jax_probs(block.gate, x), block.top_k + 1)
    _ROUTING.append((i[..., : block.top_k], jnp.min(p[..., block.top_k - 1] - p[..., block.top_k])))
    return _JAX_BLOCK_CALL(block, x)


@nnx.jit
def _jax_steps(model, ids, cache, last, pos):
    _ROUTING.clear()
    out = {}
    out["prefill"], cache = model(ids, cache, 0, logits_indices=last)
    out["step"] = model(ids[:, :1], cache, pos)[0]
    return out, list(_ROUTING)


def jax_outputs(model, tokens: bool) -> dict:
    """The model outputs the tests compare (greedy tokens when `tokens`), and
    the routing of every MoE block call but generate's (recorded as the
    jitted steps are traced)."""
    ids = jnp.asarray(token_ids((B, T), 0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxMoeBlock, "__call__", _recording_call)
        out, routing = _jax_steps(
            model, ids, jax_init_kv_cache(model.config, B, S), jnp.asarray(LAST), jnp.asarray(DECODE_POS),
        )
    out = {k: np.asarray(v) for k, v in out.items()}
    margin = min(float(gap) for _, gap in routing)
    assert margin >= 1e-5, f"a near tie in the routing: {margin}"
    out["top_i"] = [np.asarray(i) for i, _ in routing]
    out["ids"] = np.array(ids)
    if tokens:
        out["tokens"] = np.asarray(jax_generate(model, ids, NEW))
    return out


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model, and a float copy of its MoE block for the block tests."""
    model = JaxMixtral(JaxMixtralConfig(**TINY), rngs=nnx.Rngs(0))
    return model, nnx.clone(model.model.layers[0].block_sparse_moe)


@pytest.fixture(scope="module")
def jax_side(jax_model):
    model = jax_model[0]
    state = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    float_out = jax_outputs(model, tokens=False)
    qt.quantize(model, weights="qint4", exclude="lm_head")
    qt.freeze(model)
    qstate = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    return state, float_out, qstate, jax_outputs(model, tokens=True)


def to_hopper(model) -> None:
    """Repack every int4 weight the Hopper layout takes (the router's N = 8
    stays generic), as `freeze` does on a CUDA device."""
    for m in model.modules():
        if isinstance(m, QLinear):
            m.weight = WeightQBitsHopperArray.from_generic(m.weight) or m.weight


def port_model(state, layout):
    model = MixtralForCausalLM(MixtralConfig(**TINY), device="cpu")
    assert load_hf_numpy_state_dict(model, state) == {"missing": [], "unexpected": []}
    if layout != "float":
        qtt.quantize(model, weights="qint4", exclude="lm_head")
        qtt.freeze(model)
    if layout == "stacked":
        to_hopper(model)
        assert convert_moe_to_stacked(model, capacity_factor=None) == TINY["num_hidden_layers"]
    return model


def port_outputs(model, ref) -> dict:
    """The port's counterparts of `jax_outputs`, with the routing of each call."""
    top_i = []

    def record(block, args):
        top_i.append(route(block.gate, args[0], block.top_k)[0].numpy())

    blocks = [m for m in model.modules() if isinstance(m, (MixtralSparseMoeBlock, StackedSparseMoeBlock))]
    hooks = [b.register_forward_pre_hook(record) for b in blocks]
    ids = torch.from_numpy(ref["ids"])
    out = {}
    with torch.no_grad():
        cache = init_kv_cache(model.config, B, S, device="cpu")
        out["prefill"], cache = model(ids, cache, 0, logits_indices=torch.from_numpy(LAST))
        out["step"] = model(ids[:, :1], cache, torch.from_numpy(DECODE_POS))[0]
    for h in hooks:
        h.remove()
    out["top_i"] = top_i
    if "tokens" in ref:
        out["tokens"] = generate(model, ids, NEW).numpy()
    return out


@pytest.mark.parametrize("layout", ["float", "dense", "stacked"])
def test_model_matches(jax_side, layout):
    state, float_out, qstate, q_out = jax_side
    ref = float_out if layout == "float" else q_out
    model = port_model(state, layout)
    if layout == "dense":
        qlinears = [(n, m) for n, m in model.named_modules() if isinstance(m, QLinear)]
        assert len(qlinears) == TINY["num_hidden_layers"] * (4 + 1 + 3 * TINY["num_local_experts"])
        for name, m in qlinears:
            np.testing.assert_array_equal(
                bits_of(m.weight._data.packed_data), bits_of(qstate[f"{name}.weight._data._data"])
            )
            np.testing.assert_array_equal(bits_of(m.weight._scale), bits_of(qstate[f"{name}.weight._scale"]))
    got = port_outputs(model, ref)
    assert len(got["top_i"]) == len(ref["top_i"])
    for a, b in zip(got["top_i"], ref["top_i"]):
        np.testing.assert_array_equal(a, b)
    for key in ("prefill", "step"):
        close(got[key], ref[key])
    if "tokens" in ref:
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])


def test_streaming_build_matches():
    """`materialize_` from "meta" with a per-layer quantize + freeze + convert
    gives the model that the whole-model calls give, draw for draw."""
    config = MixtralConfig(**TINY)
    whole = MixtralForCausalLM(config, device="cpu", generator=torch.Generator().manual_seed(5))
    qtt.quantize(whole, weights="qint4", exclude="lm_head")
    qtt.freeze(whole)
    to_hopper(whole)
    assert convert_moe_to_stacked(whole) == TINY["num_hidden_layers"]

    def per_layer(layer):
        qtt.quantize(layer, weights="qint4")
        qtt.freeze(layer)
        to_hopper(layer)
        assert convert_moe_to_stacked(layer) == 1

    streamed = MixtralForCausalLM(config, device="meta")
    streamed.materialize_("cpu", torch.Generator().manual_seed(5), layer_fn=per_layer)
    a, b = whole.state_dict(), streamed.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    ids = torch.from_numpy(token_ids((B, T), 0))
    with torch.no_grad():
        torch.testing.assert_close(streamed(ids)[0], whole(ids)[0], rtol=0, atol=0)


def test_converter_refuses_generic_experts():
    model = MixtralForCausalLM(MixtralConfig(**TINY), device="cpu")
    qtt.quantize(model, weights="qint4")
    qtt.freeze(model)  # on a CPU tensor the weights stay in the generic layout
    with pytest.raises(ValueError, match="WeightQBitsHopperArray"):
        convert_moe_to_stacked(model)


# --- the block against JAX's stacked block ---------------------------------------------


@pytest.fixture(scope="module")
def blocks(jax_model):
    """(JAX dense block frozen into the TPU layout, the port's dense block
    frozen and repacked to the Hopper layout), from the same float weights."""
    jblock = jax_model[1]
    state = {k: np.asarray(v) for k, v in hf_state_dict(jblock).items()}
    qt.quantize(jblock, weights="qint4")
    jax_ops_config.set_backend(pallas_qbits=True)
    try:
        qt.freeze(jblock)
    finally:
        jax_ops_config.set_backend()
    pblock = MixtralSparseMoeBlock(MixtralConfig(**TINY), device="cpu", dtype=torch.float32)
    assert load_hf_numpy_state_dict(pblock, state) == {"missing": [], "unexpected": []}
    qtt.quantize(pblock, weights="qint4")
    qtt.freeze(pblock)
    to_hopper(pblock)
    return jblock, pblock


def block_input(shape, seed):
    return (np.random.default_rng(seed).standard_normal((*shape, TINY["hidden_size"])) * 0.3).astype(np.float32)


def count_launches(monkeypatch):
    """Count the calls of each MoE kernel wrapper (on a CPU tensor each takes
    its plain version, so `launches` stays 0): the route each shape takes."""
    calls = {"qbits_moe_small_m": 0, "qbits_moe_tiled": 0}
    for name in calls:
        fn = getattr(moe_mm, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        counted.launches = 0  # the wrapper adds to the `launches` of its module's name
        monkeypatch.setattr(moe_mm, name, counted)
    return calls


# (B, T), capacity_factor, the wrappers' calls: small_m, tiled.
ROUTES = {
    "selective": ((2, 1), 2.0, (3, 0)),
    "all": ((2, 8), 2.0, (2, 1)),
    "capacity": ((2, 32), 2.0, (0, 3)),
    "capacity-exact": ((2, 260), None, (0, 3)),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_stacked_block_matches_jax(blocks, monkeypatch, case):
    (b, t), cf, want = ROUTES[case]
    jblock, pblock = blocks
    x = block_input((b, t), seed=b * 1000 + t)
    ref = np.asarray(JaxStackedBlock(jblock, capacity_factor=cf)(jnp.asarray(x)))
    block = StackedSparseMoeBlock(pblock, capacity_factor=cf)
    xt = torch.from_numpy(x)
    top_j = np.asarray(jax.lax.top_k(jax_probs(jblock.gate, jnp.asarray(x)), 2)[1])
    np.testing.assert_array_equal(route(block.gate, xt, 2)[0].numpy(), top_j)
    calls = count_launches(monkeypatch)
    with torch.no_grad():
        out = block(xt)
    assert (calls["qbits_moe_small_m"], calls["qbits_moe_tiled"]) == want
    close(out, ref, 2e-5)


@pytest.mark.parametrize("branch", ["uniq", "all"])
def test_uniq_boundary_both_branches(blocks, monkeypatch, branch):
    """S*K = 2E: JAX streams U = 6 slots when at most 6 experts are routed,
    else every expert; the port's routed-first table gives both results,
    through the same calls."""
    jblock, pblock = blocks
    x = block_input((8, 1), seed=7)
    rng = np.random.default_rng(7)
    if branch == "uniq":
        first = rng.integers(0, 4, 8)
        top_i = np.stack([first, (first + 1) % 4], axis=1)  # 4 experts, distinct per row
    else:
        top_i = np.stack([np.arange(8), (np.arange(8) + 1) % 8], axis=1)
    top_i = top_i.astype(np.int32)
    top_p = (rng.random((8, 2)) * 0.5 + 0.25).astype(np.float32)
    jsb = JaxStackedBlock(jblock, capacity_factor=2.0)
    ref = np.asarray(jsb._dispatch(jnp.asarray(x), jnp.asarray(top_i), jnp.asarray(top_p)))
    calls = count_launches(monkeypatch)
    block = StackedSparseMoeBlock(pblock, capacity_factor=2.0)
    with torch.no_grad():
        out = block._dispatch(torch.from_numpy(x), torch.from_numpy(top_i), torch.from_numpy(top_p))
    assert (calls["qbits_moe_small_m"], calls["qbits_moe_tiled"]) == (2, 1)
    close(out, ref, 2e-5)
