"""A tiny Gemma (the Llama family with Gemma's options) of quanto_tpu_torch against quanto_tpu.

The model: two layers, 2 query heads over 1 kv head of head_dim 256 (as
Gemma-7B's heads; hidden 256), tied embeddings scaled by sqrt(hidden), the
unit-offset RMSNorm (weights drawn at random here: both packages start them
at 0), the tanh GELU; float32, JAX's weights carried over by the state-dict
functions.

- A prompt of B x T = 2 x 256 is prefilled from position 0, so both packages
  take the fused causal prefill over the raw K/V (JAX's splash kernel in
  interpret mode under `set_backend(flash_prefill=True)`, the port's
  `flash_prefill_plain`), then 3 greedy decode steps (JAX's einsum path, the
  port's `flash_decode` plain version at D = 256), over a float cache and a
  qint4 cache. Prefill logits (every position) and each step's logits within
  1e-4 * max|ref| (`test_torch_llama.close`: float32 on both sides, sums in
  another order), tokens equal.
- `QuantizedModelForCausalLM` (qint4) saves a Gemma that JAX loads, and loads
  JAX's: the same tensors bit for bit, config.json read as a Gemma by
  `transformers.AutoConfig` and by both packages, logits within 1e-4.
- The embedding factor is rounded to the model dtype first (JAX :489), the
  norms start at 0, and `serve.make_cache` takes a model's own
  `init_kv_cache` (JAX's `serve.py:22-34`).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from flax import nnx

import quanto_tpu as qt
from quanto_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quanto_tpu.models.llama import LlamaForCausalLM as JaxLlama
from quanto_tpu.models.llama import init_kv_cache as jax_init_kv_cache
from quanto_tpu.models.loading import hf_state_dict as jax_hf_state_dict
from quanto_tpu.models.loading import load_hf_state_dict as jax_load_hf_state_dict
from quanto_tpu.models.transformers_models import QuantizedModelForCausalLM as JaxQModel
from quanto_tpu.ops import config as jax_ops_config
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, RMSNorm, init_kv_cache
from quanto_tpu_torch.models.loading import hf_state_dict, load_hf_state_dict
from quanto_tpu_torch.models.serve import make_cache
from quanto_tpu_torch.models.transformers_models import QuantizedModelForCausalLM
from quanto_tpu_torch.ops import attention as attention_mod

from .test_torch_checkpoint import assert_same_state, jax_logits, numpy_state, port_logits
from .test_torch_llama import close

GEMMA = dict(
    vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
    num_key_value_heads=1, head_dim=256, rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
    hidden_act="gelu", rms_norm_unit_offset=True, scale_embeddings=True,
)
B, T, STEPS = 2, 256, 3
IDS = np.random.default_rng(7).integers(0, GEMMA["vocab_size"], (B, T))


def gemma_state(model) -> dict:
    """JAX's float state with the norms drawn at random (they start at 0):
    every key naming a norm, so also Gemma-2's `pre_feedforward_layernorm`
    and `post_feedforward_layernorm` (`tests/test_torch_gemma2.py`)."""
    rng = np.random.default_rng(4)
    state = numpy_state(jax_hf_state_dict(model))
    for k in state:
        if "norm" in k:
            state[k] = (rng.standard_normal(state[k].shape) * 0.2).astype(state[k].dtype)
    return state


def jax_run(model, cache):
    """Prefill logits [B, T, V] from position 0 and STEPS greedy steps' logits."""
    jax_ops_config.set_backend(flash_prefill=True)
    try:
        logits, cache = model(jnp.asarray(IDS, jnp.int32), cache, 0)
    finally:
        jax_ops_config.set_backend()
    out = {"prefill": np.asarray(logits), "steps": [], "tokens": []}
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    for i in range(STEPS):
        out["tokens"].append(np.asarray(tok))
        step, cache = model(tok, cache, T + i)
        out["steps"].append(np.asarray(step))
        tok = jnp.argmax(step[:, -1], -1)[:, None]
    return out


def port_run(model, cache, calls):
    with torch.no_grad():
        logits, cache = model(torch.from_numpy(IDS), cache, 0)
        out = {"prefill": logits, "steps": [], "tokens": []}
        tok = logits[:, -1].argmax(-1)[:, None]
        for i in range(STEPS):
            out["tokens"].append(tok.numpy())
            step, cache = model(tok, cache, T + i)
            out["steps"].append(step)
            tok = step[:, -1].argmax(-1)[:, None]
    assert calls == [(B, T, 2, 256)] * GEMMA["num_hidden_layers"]
    return out


@pytest.fixture(scope="module")
def jax_gemma():
    model = JaxLlama(JaxLlamaConfig(**GEMMA), rngs=nnx.Rngs(0))
    assert all(np.all(np.asarray(v) == 0) for k, v in jax_hf_state_dict(model).items() if "norm" in k)
    state = gemma_state(model)
    assert jax_load_hf_state_dict(model, state)["missing"] == []
    return model, state


@pytest.mark.parametrize("kv", [None, "qint4"], ids=["float-cache", "qint4-cache"])
def test_tiny_gemma_matches_jax(monkeypatch, jax_gemma, kv):
    jmodel, state = jax_gemma
    ref = jax_run(jmodel, jax_init_kv_cache(jmodel.config, B, T + STEPS, kv_quant=kv))

    calls = []

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return flash_prefill(q, k, v, **kw)

    flash_prefill = attention_mod.flash_prefill
    monkeypatch.setattr(attention_mod, "flash_prefill", spy)
    model = LlamaForCausalLM(LlamaConfig(**GEMMA), device="cpu")
    assert all(torch.all(m.weight == 0) for m in model.modules() if isinstance(m, RMSNorm))
    assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
    assert model.lm_head is None
    got = port_run(model, init_kv_cache(model.config, B, T + STEPS, kv_quant=kv, device="cpu"), calls)
    close(got["prefill"], ref["prefill"])
    for i in range(STEPS):
        np.testing.assert_array_equal(got["tokens"][i], ref["tokens"][i])
        close(got["steps"][i], ref["steps"][i])


@pytest.fixture(autouse=True)
def jax_plain_reader(monkeypatch):
    """JAX reads safetensors through its plain reader (`test_torch_checkpoint.py`)."""
    from quanto_tpu.utils import safetensors_io as jax_io

    monkeypatch.setattr(jax_io, "_try_mmap", lambda path: None)


def test_gemma_checkpoint_loads_both_ways(tmp_path, jax_gemma):
    _, state = jax_gemma
    port_config = LlamaConfig(**GEMMA)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(port_config.to_hf(), f)
    hf = transformers.AutoConfig.from_pretrained(str(tmp_path))
    assert type(hf).__name__ == "GemmaConfig"
    jcfg = JaxLlamaConfig.from_hf(hf, dtype=jnp.float32)
    assert jcfg == JaxLlamaConfig(**GEMMA)
    jmodel = JaxLlama(jcfg, rngs=nnx.Rngs(0))
    jmodel._hf_config = hf  # as JAX's from_pretrained keeps it: its save writes this config.json
    jax_load_hf_state_dict(jmodel, state)
    qt.quantize(jmodel, weights="qint4")
    qt.freeze(jmodel)
    jax_state = numpy_state(jax_hf_state_dict(jmodel))
    JaxQModel(jmodel).save_pretrained(str(tmp_path / "jax"))

    model = LlamaForCausalLM(port_config, device="cpu")
    assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
    QuantizedModelForCausalLM.quantize(model, weights="qint4")
    assert_same_state(hf_state_dict(model), jax_state)
    QuantizedModelForCausalLM(model).save_pretrained(str(tmp_path / "port"))
    with open(tmp_path / "port" / "config.json") as f:
        saved = json.load(f)
    assert saved["model_type"] == "gemma" and saved["architectures"] == ["GemmaForCausalLM"]

    loaded = QuantizedModelForCausalLM.from_pretrained(str(tmp_path / "jax"), dtype=torch.float32, device="cpu")
    assert dataclasses.replace(loaded.config, dtype=torch.float32) == model.config
    assert_same_state(hf_state_dict(loaded._wrapped), jax_state)
    close(port_logits(loaded), jax_logits(jmodel))
    jloaded = JaxQModel.from_pretrained(str(tmp_path / "port"), dtype=jnp.float32)._wrapped
    assert jloaded.config == jcfg and jloaded.lm_head is None
    assert_same_state(numpy_state(jax_hf_state_dict(jloaded)), jax_state)
    close(port_logits(model), jax_logits(jloaded))


def test_embedding_factor_rounds_to_the_model_dtype():
    """hidden 384: sqrt(384) = 19.596 is 19.625 in bf16, as JAX multiplies."""
    cfg = LlamaConfig(vocab_size=16, hidden_size=384, intermediate_size=64, num_hidden_layers=1,
                      num_attention_heads=1, num_key_value_heads=1, head_dim=256, hidden_act="gelu_pytorch_tanh",
                      rms_norm_unit_offset=True, scale_embeddings=True, tie_word_embeddings=True,
                      dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cpu")
    seen = []
    model.model.layers[0].register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    ids = torch.arange(8)[None]
    with torch.no_grad():
        model(ids)
    want = model.model.embed_tokens.weight[ids] * torch.tensor(19.625, dtype=torch.bfloat16)
    assert torch.tensor(384**0.5, dtype=torch.bfloat16).item() == 19.625
    assert torch.equal(seen[0], want)
    jx = jnp.asarray(model.model.embed_tokens.weight[ids].float().numpy(), jnp.bfloat16)
    np.testing.assert_array_equal(
        np.asarray((jx * jnp.asarray(384**0.5, jnp.bfloat16)).astype(jnp.float32)), want.float().numpy()
    )


def test_make_cache_takes_the_models_own():
    class Own(LlamaForCausalLM):
        def init_kv_cache(self, batch, max_len, dtype=None, kv_quant=None):
            return ("own", batch, max_len, dtype, kv_quant)

    model = Own(LlamaConfig(**GEMMA), device="meta")
    assert make_cache(model, 3, 40, kv_quant="qint8") == ("own", 3, 40, None, "qint8")
    plain = LlamaForCausalLM(LlamaConfig(**dict(GEMMA, num_hidden_layers=1)), device="cpu")
    cache = make_cache(plain, 2, 8)
    assert len(cache) == 1 and cache[0][0].shape == (2, 8, 1, 256)
