"""The Llama-family options of quanto_tpu_torch's `LlamaConfig` against quanto_tpu's.

Tiny configurations (two layers of hidden 256), each with one option of
`quanto_tpu/models/llama.py`: tied embeddings, attention biases (q/k/v/o),
Qwen2's q/k/v-only biases, MLP biases, an explicit head_dim (128 beside
hidden / heads = 64), yarn rope, and dynamic rope (within the window, and
evaluated at a fixed `seq_len` beyond it). For each:

- `rope_params` (inverse frequencies and the attention scale factor) equal
  to JAX's bit for bit (also yarn's mscale / attention_factor / truncate
  variants);
- the float model, JAX's weights carried over with random (non-zero)
  biases: the cached prefill logits and a per-row decode step against
  JAX's within 1e-4 * max|ref| (float32 sums in another order);
- `to_hf` / `from_hf` round-trip the configuration, and JAX's `from_hf` reads
  the same options from it (a qkv-only biased one as model_type qwen2).

A qwen2 checkpoint (qint4, q/k/v biases, tied) saved by either package
loads in the other: the same tensors bit for bit and logits within
1e-4 * max|ref|. Gemma's options are held in `test_torch_gemma.py`.
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
from quanto_tpu.models.llama import rope_params as jax_rope_params
from quanto_tpu.models.loading import hf_state_dict as jax_hf_state_dict
from quanto_tpu.models.loading import load_hf_state_dict as jax_load_hf_state_dict
from quanto_tpu.models.transformers_models import QuantizedModelForCausalLM as JaxQModel
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, rope_params
from quanto_tpu_torch.models.loading import hf_state_dict, load_hf_state_dict
from quanto_tpu_torch.models.transformers_models import QuantizedModelForCausalLM

from .test_torch_checkpoint import assert_same_state, jax_logits, numpy_state, port_logits
from .test_torch_llama import TINY, close, jax_steps, port_steps

YARN = {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64}
BASE = {k: v for k, v in TINY.items() if k != "rope_scaling"}
OPTIONS = {
    "tied": dict(tie_word_embeddings=True),
    "attention_bias": dict(attention_bias=True),
    "qkv_bias": dict(qkv_bias=True),
    "mlp_bias": dict(mlp_bias=True),
    "head_dim": dict(head_dim=128),
    "yarn": dict(rope_scaling=tuple(sorted(YARN.items())), max_position_embeddings=256),
    "dynamic": dict(rope_scaling=(("factor", 2.0), ("rope_type", "dynamic")), max_position_embeddings=64),
    "dynamic_seq_len": dict(
        rope_scaling=(("factor", 2.0), ("rope_type", "dynamic"), ("seq_len", 256)), max_position_embeddings=64
    ),
}
IDS = np.random.default_rng(5).integers(0, TINY["vocab_size"], (2, 16))


@pytest.mark.parametrize(
    "scaling",
    [
        None,
        YARN,
        dict(YARN, mscale=1.0, mscale_all_dim=0.5),
        dict(YARN, attention_factor=1.25, beta_fast=16, beta_slow=2),
        dict(YARN, truncate=False),
        {"rope_type": "dynamic", "factor": 2.0},
        {"rope_type": "dynamic", "factor": 2.0, "seq_len": 8192},
    ],
    ids=["default", "yarn", "yarn-mscale", "yarn-attention_factor", "yarn-no-truncate", "dynamic", "dynamic-seq_len"],
)
@pytest.mark.parametrize("head_dim", [64, 128])
def test_rope_params_match_jax(scaling, head_dim):
    frozen = tuple(sorted(scaling.items())) if scaling else None
    inv, attn = rope_params(head_dim, 1e6, frozen, 4096)
    ref_inv, ref_attn = jax_rope_params(head_dim, 1e6, frozen, 4096)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ref_inv))
    assert attn == ref_attn
    assert (attn != 1.0) == (scaling is not None and scaling["rope_type"] == "yarn")


def biased_state(model) -> dict:
    """JAX's float state, its biases drawn at random (JAX initializes them to zero)."""
    rng = np.random.default_rng(3)
    state = numpy_state(jax_hf_state_dict(model))
    for k in state:
        if k.endswith(".bias"):
            state[k] = (rng.standard_normal(state[k].shape) * 0.1).astype(state[k].dtype)
    return state


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_matches_jax(option):
    cfg = dict(BASE, **OPTIONS[option])
    jmodel = JaxLlama(JaxLlamaConfig(**cfg), rngs=nnx.Rngs(0))
    state = biased_state(jmodel)
    assert jax_load_hf_state_dict(jmodel, state)["missing"] == []
    model = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
    assert (model.lm_head is None) == (option == "tied")
    assert sorted(hf_state_dict(model)) == sorted(state)
    assert model.attn_scale == jax_rope_params(
        model.config.head_dim, model.config.rope_theta, model.config.rope_scaling, model.config.max_position_embeddings
    )[1]
    got, ref = port_steps(model, IDS), jax_steps(jmodel, IDS)
    close(got["prefill"], ref["prefill"])
    close(got["step"], ref["step"])

    config = model.config
    hf = config.to_hf()
    # `from_hf` reads attention_bias as biases on q/k/v too (qkv_bias), as JAX's does.
    want = dataclasses.replace(config, qkv_bias=config.qkv_bias or config.attention_bias)
    assert LlamaConfig.from_hf(hf, dtype=torch.float32) == want
    assert hf["model_type"] == ("qwen2" if option == "qkv_bias" else "llama")


def test_to_hf_reads_in_transformers_and_jax(tmp_path):
    for option in ("tied", "attention_bias", "qkv_bias", "mlp_bias", "head_dim", "yarn"):
        config = LlamaConfig(**dict(BASE, **OPTIONS[option]))
        with open(tmp_path / "config.json", "w") as f:
            json.dump(config.to_hf(), f)
        jax = JaxLlamaConfig.from_hf(transformers.AutoConfig.from_pretrained(str(tmp_path)), dtype=jnp.float32)
        for name in ("tie_word_embeddings", "attention_bias", "mlp_bias", "head_dim", "rope_scaling"):
            assert getattr(jax, name) == getattr(config, name), (option, name)
        assert jax.qkv_bias == (config.qkv_bias or config.attention_bias)


QWEN2 = dict(BASE, qkv_bias=True, tie_word_embeddings=True, rope_theta=1e6, rms_norm_eps=1e-6)


@pytest.fixture(autouse=True)
def jax_plain_reader(monkeypatch):
    """JAX reads safetensors through its plain reader (`test_torch_checkpoint.py`)."""
    from quanto_tpu.utils import safetensors_io as jax_io

    monkeypatch.setattr(jax_io, "_try_mmap", lambda path: None)


def test_qwen2_checkpoint_loads_both_ways(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(LlamaConfig(**QWEN2).to_hf(), f)
    hf = transformers.AutoConfig.from_pretrained(str(tmp_path))
    assert type(hf).__name__ == "Qwen2Config"
    jmodel = JaxLlama(JaxLlamaConfig.from_hf(hf, dtype=jnp.float32), rngs=nnx.Rngs(0))
    jmodel._hf_config = hf  # as JAX's from_pretrained keeps it: its save writes this config.json
    state = biased_state(jmodel)
    jax_load_hf_state_dict(jmodel, state)
    qt.quantize(jmodel, weights="qint4")
    qt.freeze(jmodel)
    jax_state = numpy_state(jax_hf_state_dict(jmodel))
    JaxQModel(jmodel).save_pretrained(str(tmp_path / "jax"))

    model = LlamaForCausalLM(LlamaConfig(**QWEN2), device="cpu")
    assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
    QuantizedModelForCausalLM.quantize(model, weights="qint4")
    assert_same_state(hf_state_dict(model), jax_state)
    QuantizedModelForCausalLM(model).save_pretrained(str(tmp_path / "port"))
    with open(tmp_path / "port" / "config.json") as f:
        assert json.load(f)["model_type"] == "qwen2"

    loaded = QuantizedModelForCausalLM.from_pretrained(str(tmp_path / "jax"), dtype=torch.float32, device="cpu")
    assert dataclasses.replace(loaded.config, dtype=torch.float32) == model.config
    assert_same_state(hf_state_dict(loaded._wrapped), jax_state)
    ref = jax_logits(jmodel)
    close(port_logits(loaded), ref)
    jloaded = JaxQModel.from_pretrained(str(tmp_path / "port"), dtype=jnp.float32)._wrapped
    assert jloaded.config.qkv_bias and not jloaded.config.attention_bias and jloaded.lm_head is None
    assert_same_state(numpy_state(jax_hf_state_dict(jloaded)), jax_state)
    close(port_logits(model), jax_logits(jloaded))
