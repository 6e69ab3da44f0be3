"""Tiny Qwen3 and Qwen3-MoE models of quanto_tpu_torch against quanto_tpu's.

The dense model: two layers, 4 query heads over 2 kv heads of 64 (the port's
`flash_decode` takes D of 64, 128 and 256), hidden 256, untied, random q/k
norms; float32, JAX's weights carried over by the state-dict functions.
Logits are held to 1e-4 * max|ref| (`test_torch_llama.close`), greedy tokens
equal.

- The configs of Qwen/Qwen3-8B and Qwen/Qwen3-30B-A3B read by both packages
  (JAX from transformers' config objects, which derive `sliding_window` and
  `layer_types`; the port from the plain dicts).
- Prefill of 2 x 13 tokens from position 0, then 5 greedy steps, over a
  float and a qint4 cache; a sliding tail (`use_sliding_window`,
  `max_window_layers` 1: layer 1 attends to the last 8 positions, by mask
  and through `flash_decode`'s window); a yarn `rope_scaling`.
- Qwen3-MoE (16 experts, top-4, `decoder_sparse_step` 2: layer 0 dense,
  layer 1 sparse): the dense-mask model in float32, and qint4 with the
  stacked block (`convert_moe_to_stacked`, the kernels' plain versions on the
  CPU) against JAX's qint4 model. The stacked
  block against JAX's stacked block (its MoE kernels in interpret mode) on
  the selective, unique-expert and capacity routes, with `norm_topk_prob`
  true and false, within 2e-5 * max|ref| (as `test_torch_mixtral.py`).
- qwen3 and qwen3_moe checkpoints (qint4) saved by either package load in the
  other; the engines build a Qwen3-MoE's cache through its own
  `init_kv_cache` with `kv_quant` kept, and serve JAX's engine's tokens.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from flax import nnx

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.models.loading import hf_state_dict as jax_hf_state_dict
from quanto_tpu.models.loading import load_hf_state_dict as jax_load_hf_state_dict
from quanto_tpu.models.qwen3 import Qwen3Config as JaxQwen3Config
from quanto_tpu.models.qwen3 import Qwen3ForCausalLM as JaxQwen3
from quanto_tpu.models.qwen3 import Qwen3MoeConfig as JaxQwen3MoeConfig
from quanto_tpu.models.qwen3 import Qwen3MoeForCausalLM as JaxQwen3Moe
from quanto_tpu.models.serving import BatchedEngine as JaxBatchedEngine
from quanto_tpu.models.transformers_models import QuantizedModelForCausalLM as JaxQModel
from quanto_tpu.ops import config as jax_ops_config
from quanto_tpu.parallel import StackedSparseMoeBlock as JaxStackedBlock
from quanto_tpu_torch.models import BatchedEngine, Qwen3Config, Qwen3ForCausalLM, Qwen3MoeConfig, Qwen3MoeForCausalLM
from quanto_tpu_torch.models.loading import hf_state_dict, load_hf_state_dict
from quanto_tpu_torch.models.mixtral import route
from quanto_tpu_torch.models.qwen3 import Qwen3MoeSparseBlock
from quanto_tpu_torch.models.serve import make_cache
from quanto_tpu_torch.models.transformers_models import QuantizedModelForCausalLM, build_model
from quanto_tpu_torch.ops import attention as attention_mod
from quanto_tpu_torch.parallel import StackedSparseMoeBlock, convert_moe_to_stacked
from quanto_tpu_torch.tensor.kv_cache import QKVCacheLayer

from .test_torch_checkpoint import assert_same_state, numpy_state
from .test_torch_gemma import gemma_state
from .test_torch_llama import close
from .test_torch_mixtral import count_launches, jax_probs, to_hopper

QWEN3 = dict(
    vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, rope_theta=1e6, max_position_embeddings=512,
)
MOE = dict(QWEN3, num_experts=16, num_experts_per_tok=4, moe_intermediate_size=256, decoder_sparse_step=2,
           norm_topk_prob=True)
W = 8
# Qwen/Qwen3-8B and Qwen/Qwen3-30B-A3B config.json (the keys the models read).
QWEN3_8B = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3", "attention_bias": False, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 12288, "max_position_embeddings": 40960,
    "max_window_layers": 36, "num_attention_heads": 32, "num_hidden_layers": 36, "num_key_value_heads": 8,
    "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 1000000, "sliding_window": None,
    "tie_word_embeddings": False, "use_sliding_window": False, "vocab_size": 151936,
}
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe", "attention_bias": False,
    "decoder_sparse_step": 1, "head_dim": 128, "hidden_act": "silu", "hidden_size": 2048,
    "intermediate_size": 6144, "max_position_embeddings": 40960, "max_window_layers": 48, "mlp_only_layers": [],
    "moe_intermediate_size": 768, "norm_topk_prob": True, "num_attention_heads": 32, "num_experts": 128,
    "num_experts_per_tok": 8, "num_hidden_layers": 48, "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
    "rope_scaling": None, "rope_theta": 1000000.0, "sliding_window": None, "tie_word_embeddings": False,
    "use_sliding_window": False, "vocab_size": 151936,
}
YARN = {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64}
B, T, STEPS, MAX_LEN = 2, 13, 5, 24
IDS = np.random.default_rng(25).integers(0, QWEN3["vocab_size"], (B, T + STEPS))

# JAX's forwards under one compile each: eagerly every op compiles on its own, several times slower.
jax_prefill = nnx.jit(lambda m, ids, cache: m(ids, cache, 0))
jax_step = nnx.jit(lambda m, ids, cache, pos: m(ids, cache, pos))


def qwen_state(model) -> dict:
    """JAX's float state with the norms (also q_norm, k_norm) drawn about 1."""
    return {k: (v + 1.0).astype(v.dtype) if "norm" in k else v for k, v in gemma_state(model).items()}


def jax_model(moe: bool = False, **over):
    cfg_cls, cls = (JaxQwen3MoeConfig, JaxQwen3Moe) if moe else (JaxQwen3Config, JaxQwen3)
    model = cls(cfg_cls(**{**(MOE if moe else QWEN3), **over}, dtype=jnp.float32), rngs=nnx.Rngs(0))
    state = qwen_state(model)
    assert jax_load_hf_state_dict(model, state)["missing"] == []
    return model, state


def port_config(moe: bool = False, **over):
    if "rope_scaling" in over:
        over["rope_scaling"] = tuple(sorted(over["rope_scaling"].items()))
    return (Qwen3MoeConfig if moe else Qwen3Config)(**{**(MOE if moe else QWEN3), **over})


def port_model(state, moe: bool = False, **over):
    model = (Qwen3MoeForCausalLM if moe else Qwen3ForCausalLM)(port_config(moe, **over), device="cpu")
    assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
    return model


def jax_run(model, cache, ids=IDS):
    logits, cache = jax_prefill(model, jnp.asarray(ids[:, :T], jnp.int32), cache)
    out = {"prefill": np.asarray(logits), "steps": [], "tokens": []}
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    for i in range(STEPS):
        out["tokens"].append(np.asarray(tok))
        step, cache = jax_step(model, tok, cache, jnp.int32(T + i))
        out["steps"].append(np.asarray(step))
        tok = jnp.argmax(step[:, -1], -1)[:, None]
    return out


def port_run(model, cache, ids=IDS):
    with torch.no_grad():
        logits, cache = model(torch.from_numpy(ids[:, :T]), cache, 0)
        out = {"prefill": logits, "steps": [], "tokens": []}
        tok = logits[:, -1].argmax(-1)[:, None]
        for i in range(STEPS):
            out["tokens"].append(tok.numpy())
            step, cache = model(tok, cache, T + i)
            out["steps"].append(step)
            tok = step[:, -1].argmax(-1)[:, None]
    return out


def check_run(got, ref) -> None:
    close(got["prefill"], ref["prefill"])
    for i in range(STEPS):
        np.testing.assert_array_equal(got["tokens"][i], ref["tokens"][i])
        close(got["steps"][i], ref["steps"][i])


@pytest.mark.parametrize("hf", [QWEN3_8B, QWEN3_30B_A3B, {**QWEN3_8B, "use_sliding_window": True,
                                                           "sliding_window": 4096, "max_window_layers": 28}],
                         ids=["qwen3-8b", "qwen3-30b-a3b", "sliding"])
def test_config_from_hf_matches_jax(hf):
    moe = hf["model_type"] == "qwen3_moe"
    hf_cls = transformers.Qwen3MoeConfig if moe else transformers.Qwen3Config
    port = (Qwen3MoeConfig if moe else Qwen3Config).from_hf(hf)
    jax = (JaxQwen3MoeConfig if moe else JaxQwen3Config).from_hf(hf_cls(**hf), dtype=jnp.bfloat16)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(jax, f.name), f.name
    assert type(port).from_hf(port.to_hf()) == port
    model = build_model(hf)
    assert model.config == port and model.model.layers[0].self_attn.q_norm.weight.is_meta
    if moe:
        assert model.model.layers[0].mlp.experts[127].down_proj.weight.shape == (2048, 768)
    if hf.get("use_sliding_window"):
        assert port.sliding_window == 4096 and port.layer_types.count("sliding_attention") == 8


@pytest.fixture(scope="module")
def dense():
    jmodel, state = jax_model()
    return jmodel, port_model(state)


@pytest.mark.parametrize("kv", [None, "qint4"], ids=["float", "qint4"])
def test_tiny_qwen3_matches_jax(dense, kv):
    jmodel, model = dense
    ref = jax_run(jmodel, jmodel.init_kv_cache(B, MAX_LEN, kv_quant=kv))
    check_run(port_run(model, make_cache(model, B, MAX_LEN, kv_quant=kv)), ref)


@pytest.mark.parametrize("over", [
    dict(sliding_window=W, layer_types=("full_attention", "sliding_attention")), dict(rope_scaling=YARN)],
    ids=["sliding-tail", "yarn"])
def test_qwen3_options_match_jax(monkeypatch, over):
    """A sliding tail over flat caches (the window by mask, and through
    flash_decode's `window`), and yarn rope."""
    jover = {k: tuple(sorted(v.items())) if k == "rope_scaling" else v for k, v in over.items()}
    jmodel, state = jax_model(**jover)
    model = port_model(state, **over)
    windows = []

    def spy(*args, **kw):
        windows.append(kw["window"])
        return flash_decode(*args, **kw)

    flash_decode = attention_mod.flash_decode
    monkeypatch.setattr(attention_mod, "flash_decode", spy)
    check_run(port_run(model, make_cache(model, B, MAX_LEN)), jax_run(jmodel, jmodel.init_kv_cache(B, MAX_LEN)))
    assert windows == [None, over.get("sliding_window")] * STEPS


@pytest.fixture(scope="module")
def moe():
    """The JAX Qwen3-MoE model in float32 and in qint4, the float state, and
    float copies of its sparse block for the block tests."""
    jmodel, state = jax_model(moe=True)
    float_ref = jax_run(jmodel, jmodel.init_kv_cache(B, MAX_LEN))
    jblock = nnx.clone(jmodel.model.layers[1].mlp)
    qt.quantize(jmodel, weights="qint4", exclude="lm_head")
    qt.freeze(jmodel)
    return jmodel, state, float_ref, jax_run(jmodel, jmodel.init_kv_cache(B, MAX_LEN)), jblock


@pytest.mark.parametrize("layout", ["float", "stacked"])
def test_tiny_qwen3_moe_matches_jax(moe, layout):
    jmodel, state, float_ref, q_ref, _ = moe
    model = port_model(state, moe=True)
    assert isinstance(model.model.layers[0].mlp, qtt.models.llama.LlamaMLP)
    if layout == "stacked":
        qtt.quantize(model, weights="qint4", exclude="lm_head")
        qtt.freeze(model)
        to_hopper(model)
        assert convert_moe_to_stacked(model) == 1
        assert model.model.layers[1].mlp.norm_topk_prob
    check_run(port_run(model, make_cache(model, B, MAX_LEN)), float_ref if layout == "float" else q_ref)


@pytest.fixture(scope="module")
def blocks(moe):
    """(JAX's dense block frozen into the TPU layout, the port's frozen and
    repacked to the Hopper layout), from the same float weights."""
    jblock = moe[4]
    state = {k: np.asarray(v) for k, v in jax_hf_state_dict(jblock).items()}
    qt.quantize(jblock, weights="qint4")
    jax_ops_config.set_backend(pallas_qbits=True)
    try:
        qt.freeze(jblock)
    finally:
        jax_ops_config.set_backend()
    pblock = Qwen3MoeSparseBlock(port_config(moe=True), device="cpu", dtype=torch.float32)
    assert load_hf_state_dict(pblock, state) == {"missing": [], "unexpected": []}
    qtt.quantize(pblock, weights="qint4")
    qtt.freeze(pblock)
    to_hopper(pblock)
    return jblock, pblock


# (B, T), the wrappers' calls (small_m, tiled) at E = 16, top-4: S·K = 8 < E (selective);
# S·K = 16 = E (the unique-expert route over a routed-first table); S = 64 past the all route.
ROUTES = {"selective": ((2, 1), (3, 0)), "uniq": ((4, 1), (2, 1)), "capacity": ((2, 32), (0, 3))}


@pytest.mark.parametrize("norm", [True, False], ids=["norm_topk_prob", "no-norm"])
@pytest.mark.parametrize("case", list(ROUTES))
def test_stacked_block_matches_jax(blocks, monkeypatch, case, norm):
    (b, t), want = ROUTES[case]
    jblock, pblock = blocks
    monkeypatch.setattr(jblock, "norm_topk_prob", norm)
    monkeypatch.setattr(pblock, "norm_topk_prob", norm)
    x = (np.random.default_rng(b * 1000 + t).standard_normal((b, t, 256)) * 0.3).astype(np.float32)
    ref = np.asarray(JaxStackedBlock(jblock, capacity_factor=2.0)(jnp.asarray(x)))
    block = StackedSparseMoeBlock(pblock, capacity_factor=2.0)
    assert block.norm_topk_prob is norm
    xt = torch.from_numpy(x)
    top_j = np.asarray(jax.lax.top_k(jax_probs(jblock.gate, jnp.asarray(x)), 4)[1])
    np.testing.assert_array_equal(route(block.gate, xt, 4)[0].numpy(), top_j)
    calls = count_launches(monkeypatch)
    with torch.no_grad():
        out = block(xt)
    assert (calls["qbits_moe_small_m"], calls["qbits_moe_tiled"]) == want
    close(out, ref, 2e-5)


@pytest.fixture(autouse=True)
def jax_plain_reader(monkeypatch):
    """JAX reads safetensors through its plain reader (`test_torch_checkpoint.py`)."""
    from quanto_tpu.utils import safetensors_io as jax_io

    monkeypatch.setattr(jax_io, "_try_mmap", lambda path: None)


@pytest.mark.parametrize("moe_model", [False, True], ids=["qwen3", "qwen3_moe"])
def test_checkpoint_loads_both_ways(tmp_path, moe_model):
    jmodel, state = jax_model(moe=moe_model)
    config = port_config(moe_model)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(config.to_hf(), f)
    hf = transformers.AutoConfig.from_pretrained(str(tmp_path))
    assert type(hf).__name__ == ("Qwen3MoeConfig" if moe_model else "Qwen3Config")
    jcfg = type(jmodel.config).from_hf(hf, dtype=jnp.float32)
    assert jcfg == jmodel.config
    jmodel._hf_config = hf  # as JAX's from_pretrained keeps it: its save writes this config.json
    qt.quantize(jmodel, weights="qint4")
    qt.freeze(jmodel)
    jax_state = numpy_state(jax_hf_state_dict(jmodel))
    JaxQModel(jmodel).save_pretrained(str(tmp_path / "jax"))

    model = port_model(state, moe=moe_model)
    QuantizedModelForCausalLM.quantize(model, weights="qint4")
    assert_same_state(hf_state_dict(model), jax_state)
    QuantizedModelForCausalLM(model).save_pretrained(str(tmp_path / "port"))

    ids = IDS[:, :T]
    want = np.asarray(jmodel(jnp.asarray(ids, jnp.int32))[0])
    loaded = QuantizedModelForCausalLM.from_pretrained(str(tmp_path / "jax"), dtype=torch.float32, device="cpu")
    assert dataclasses.replace(loaded.config, dtype=torch.float32) == model.config
    assert_same_state(hf_state_dict(loaded._wrapped), jax_state)
    with torch.no_grad():
        close(loaded(torch.from_numpy(ids))[0], want)
    jloaded = JaxQModel.from_pretrained(str(tmp_path / "port"), dtype=jnp.float32)._wrapped
    assert jloaded.config == jcfg
    assert_same_state(numpy_state(jax_hf_state_dict(jloaded)), jax_state)


def test_moe_engine_keeps_kv_quant(moe):
    """The engine's cache comes from the model's `init_kv_cache` with
    kv_quant; its tokens are JAX's engine's (qint4 stacked model)."""
    jmodel, state = moe[0], moe[1]
    model = port_model(state, moe=True)
    qtt.quantize(model, weights="qint4", exclude="lm_head")
    qtt.freeze(model)
    to_hopper(model)
    convert_moe_to_stacked(model)
    kw = dict(max_batch=2, max_len=40, prefill_chunk=8, kv_quant="qint8")
    engine = BatchedEngine(model, **kw)
    assert all(isinstance(c, QKVCacheLayer) for c in engine._cache)
    prompts = [IDS[0, :13].tolist(), IDS[1, :9].tolist()]
    rids = engine.add_batch(prompts, 6)
    engine.run_to_completion()
    got = [engine.result(r) for r in rids]
    jengine = JaxBatchedEngine(jmodel, **kw)
    rids = jengine.add_batch(prompts, 6)
    jengine.run_to_completion()
    assert got == [jengine.result(r) for r in rids]
