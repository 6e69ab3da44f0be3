"""A tiny Gemma-3 of quanto_tpu_torch against quanto_tpu's.

The model: three layers in the 5:1 rule at a pattern of 3 (layers 0 and 1
slide, window W = 8; layer 2 is full), 4 query heads over 2 kv heads of 64,
hidden 256, query_pre_attn_scalar 144 (a query scale that is not D**-0.5),
the dual rope (local base 1e4; global 1e6 with a linear factor of 8), random
unit-offset norms, also on the query and key heads; float32, JAX's weights
carried over by the state-dict functions (`test_torch_gemma.gemma_state`).
Logits are held to 1e-4 * max|ref| (`test_torch_llama.close`), greedy tokens
equal.

- The config of google/gemma-3-12b read by both packages, and `build_model`
  on the nested multimodal `gemma3` config.
- Prefill of 2 x 13 tokens from position 0 (T > W), then 5 greedy steps that
  wrap the rings, over flat, ring and qint4 ring caches.
- The linear rope factor at positions >= 8192: the port's tables against
  JAX's, and a chunk written at 8192 over flat caches.
- Engine chunks with `write_len` over rings, and a chunk longer than W with
  pads held to JAX's flat cache (JAX's ring keeps pad columns there).
- At D = 128, T = 256 from position 0 the full layer takes `flash_prefill`'s
  plain version with the scale and no softcap, the ring layers the
  concatenation chain: JAX with its splash route stood in.
- A qint4 gemma3_text checkpoint saved by either package loads in the other.
- `BatchedEngine` (mixed chunk and decode steps) and `PagedEngine` (the
  paged+ring hybrid over qint8) against JAX's.
- Greedy speculation (flat caches, a layer-skip draft) equals `generate`.
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
from quanto_tpu.models.gemma3 import Gemma3ForCausalLM as JaxGemma3
from quanto_tpu.models.gemma3 import Gemma3TextConfig as JaxGemma3Config
from quanto_tpu.models.llama import _rope as jax_rope
from quanto_tpu.models.loading import hf_state_dict as jax_hf_state_dict
from quanto_tpu.models.loading import load_hf_state_dict as jax_load_hf_state_dict
from quanto_tpu.models.serving import BatchedEngine as JaxBatchedEngine
from quanto_tpu.models.serving import PagedEngine as JaxPagedEngine
from quanto_tpu.models.transformers_models import QuantizedModelForCausalLM as JaxQModel
from quanto_tpu.ops import attention as jax_attention
from quanto_tpu_torch.models import BatchedEngine, Gemma3ForCausalLM, Gemma3TextConfig, PagedEngine
from quanto_tpu_torch.models.loading import hf_state_dict, load_hf_state_dict
from quanto_tpu_torch.models.serve import generate, make_cache
from quanto_tpu_torch.models.speculative import layerskip_draft, speculative_generate
from quanto_tpu_torch.models.transformers_models import QuantizedModelForCausalLM, build_model
from quanto_tpu_torch.ops import attention as attention_mod
from quanto_tpu_torch.tensor.kv_cache import QKVCacheLayer, cache_max_len
from quanto_tpu_torch.tensor.paged_kv import PagedKVLayer

from .test_torch_checkpoint import assert_same_state, numpy_state
from .test_torch_flash_prefill import jax_flash_prefill_standin
from .test_torch_gemma import gemma_state
from .test_torch_gemma2 import drive
from .test_torch_llama import close

W = 8
GEMMA3 = dict(
    vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, sliding_window=W, sliding_window_pattern=3, query_pre_attn_scalar=144.0,
    rope_scaling_factor=8.0, max_position_embeddings=16384,
)
SCALE = 144**-0.5
# google/gemma-3-12b-pt config.json: the language model nests under `text_config`, whose missing
# keys take Hugging Face's Gemma3TextConfig defaults (vocab 262208, head_dim 256, rope_theta 1e6,
# rope_local_base_freq 1e4, query_pre_attn_scalar 256, the pattern 6, tied embeddings).
GEMMA3_12B = {
    "architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3",
    "text_config": {
        "hidden_size": 3840, "intermediate_size": 15360, "model_type": "gemma3_text", "num_attention_heads": 16,
        "num_hidden_layers": 48, "num_key_value_heads": 8, "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
        "sliding_window": 1024,
    },
    "vision_config": {"model_type": "siglip_vision_model"},
}
B, T, STEPS, MAX_LEN = 2, 13, 5, 24
IDS = np.random.default_rng(24).integers(0, GEMMA3["vocab_size"], (B, T + STEPS))

# JAX's forwards under one compile each: eagerly every op compiles on its own, several times slower.
jax_prefill = nnx.jit(lambda m, ids, cache: m(ids, cache, 0))
jax_forward = nnx.jit(lambda m, ids, cache, pos, wl=None: m(ids, cache, pos, write_len=wl))


def jax_model(**over):
    model = JaxGemma3(JaxGemma3Config(**{**GEMMA3, **over}, dtype=jnp.float32), rngs=nnx.Rngs(0))
    state = gemma_state(model)
    assert jax_load_hf_state_dict(model, state)["missing"] == []
    return model, state


def port_model(state, **over):
    model = Gemma3ForCausalLM(Gemma3TextConfig(**{**GEMMA3, **over}), device="cpu")
    assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
    return model


@pytest.fixture(scope="module")
def models():
    jmodel, state = jax_model()
    return jmodel, port_model(state)


def jax_run(model, cache, ids=IDS):
    """Prefill logits of ids[:, :T] from position 0, then STEPS greedy steps'
    logits and tokens."""
    logits, cache = jax_prefill(model, jnp.asarray(ids[:, :T], jnp.int32), cache)
    out = {"prefill": np.asarray(logits), "steps": [], "tokens": []}
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    for i in range(STEPS):
        out["tokens"].append(np.asarray(tok))
        step, cache = jax_forward(model, tok, cache, jnp.int32(T + i))
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


def test_config_from_hf_matches_jax():
    text = GEMMA3_12B["text_config"]
    port = Gemma3TextConfig.from_hf(text)
    jax = JaxGemma3Config.from_hf(transformers.Gemma3TextConfig(**text), dtype=jnp.bfloat16)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(jax, f.name), f.name
    assert port.dtype == torch.bfloat16 and port.rope_scaling_factor == 8.0 and port.vocab_size == 262208
    full = [i for i, t in enumerate(port.layer_types) if t == "full_attention"]
    assert full == [5, 11, 17, 23, 29, 35, 41, 47]
    assert Gemma3TextConfig.from_hf(port.to_hf()) == port
    model = build_model(GEMMA3_12B)
    assert type(model) is Gemma3ForCausalLM and model.config == port and model.lm_head is None
    assert model.model.embed_tokens.weight.is_meta and model.model.layers[0].self_attn.q_norm.unit_offset
    with pytest.raises(NotImplementedError, match="linear"):
        Gemma3TextConfig.from_hf({**text, "rope_scaling": {"rope_type": "yarn", "factor": 8.0}})


@pytest.mark.parametrize("kv,ring", [(None, False), (None, True), ("qint4", True)], ids=["flat", "ring", "qint4-ring"])
def test_tiny_gemma3_matches_jax(monkeypatch, models, kv, ring):
    jmodel, model = models
    ref = jax_run(jmodel, jmodel.init_kv_cache(B, MAX_LEN, kv_quant=kv, sliding_ring=ring))
    cache = make_cache(model, B, MAX_LEN, kv_quant=kv, sliding_ring=ring)
    assert [cache_max_len(c) for c in cache] == [W if ring else MAX_LEN] * 2 + [MAX_LEN]
    calls = []

    def spy(q, k, v, *args, **kw):
        calls.append((k.shape[1], kw["window"], kw["softcap"], kw["scale"]))
        return flash_decode(q, k, v, *args, **kw)

    flash_decode = attention_mod.flash_decode
    monkeypatch.setattr(attention_mod, "flash_decode", spy)
    got = port_run(model, cache)
    close(got["prefill"], ref["prefill"])
    for i in range(STEPS):
        np.testing.assert_array_equal(got["tokens"][i], ref["tokens"][i])
        close(got["steps"][i], ref["steps"][i])
    # Each step: the two sliding layers over their rings or flat with the window, then the full one.
    first = (W, None) if ring else (MAX_LEN, W)
    assert calls == ([(*first, None, SCALE)] * 2 + [(MAX_LEN, None, None, SCALE)]) * STEPS


def test_rope_factor_at_long_positions(models):
    """Positions past 8192: the full layers' tables at positions / 8 (in
    float32, as JAX divides), the sliding layers' unscaled, against JAX's;
    then a chunk of 4 written at position 8192 over flat caches."""
    jmodel, model = models
    pos = np.array([[8192, 8193, 12345, 16383]], np.int32)
    glob, loc = model._ropes(torch.from_numpy(pos), torch.float32)
    want_g = jax_rope(jnp.asarray(pos) / 8.0, 64, 1e6, jnp.float32)
    want_l = jax_rope(jnp.asarray(pos), 64, 1e4, jnp.float32)
    for got, want in zip((*glob, *loc), (*want_g, *want_l)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    n, p0 = 8200, np.array([8192], np.int32)
    ids = IDS[:1, :4].astype(np.int32)
    want, _ = jax_forward(jmodel, jnp.asarray(ids), jmodel.init_kv_cache(1, n, sliding_ring=False), jnp.asarray(p0))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(ids), make_cache(model, 1, n, sliding_ring=False), torch.from_numpy(p0))
    close(got, np.asarray(want))


def test_chunks_with_write_len_match_jax(models):
    """Rows of 15 and 10 tokens in chunks of 6 at per-row tensor positions
    over rings; the second row's last chunk writes nothing (write_len 0)."""
    jmodel, model = models
    lens, C = [15, 10], 6
    jcache = jmodel.init_kv_cache(B, MAX_LEN)
    cache = make_cache(model, B, MAX_LEN)
    assert cache_max_len(cache[0]) == W
    for j in range(3):
        pos = np.array([min(j * C, n) for n in lens], np.int32)
        wl = np.array([max(0, min(C, n - j * C)) for n in lens], np.int32)
        chunk = np.zeros((B, C), np.int32)
        for b, n in enumerate(lens):
            chunk[b, : wl[b]] = IDS[b, j * C : j * C + wl[b]]
        want, jcache = jax_forward(jmodel, jnp.asarray(chunk), jcache, jnp.asarray(pos), jnp.asarray(wl))
        with torch.no_grad():
            got, cache = model(torch.from_numpy(chunk), cache, torch.from_numpy(pos), write_len=torch.from_numpy(wl))
        for b in range(B):
            if wl[b]:
                close(got[b, : wl[b]], np.asarray(want)[b, : wl[b]])
    tok = np.array([[7], [9]], np.int32)
    for i in range(3):
        pos = np.array(lens, np.int32) + i
        want, jcache = jax_forward(jmodel, jnp.asarray(tok), jcache, jnp.asarray(pos))
        with torch.no_grad():
            got, cache = model(torch.from_numpy(tok), cache, torch.from_numpy(pos))
        close(got, np.asarray(want))
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)


def test_long_chunk_with_pads_matches_jax_flat_cache(models):
    """One chunk of 2 W + 4 columns at tensor position 0, rows with 17 and 20
    real tokens, then 4 steps: the port's rings against JAX's flat cache."""
    jmodel, model = models
    Tc, lens = 2 * W + 4, np.array([17, 20], np.int32)
    ids = np.random.default_rng(25).integers(0, GEMMA3["vocab_size"], (B, Tc)).astype(np.int32)
    ids[0, lens[0]:] = 0
    pos0 = np.zeros((B,), np.int32)
    jcache = jmodel.init_kv_cache(B, MAX_LEN, sliding_ring=False)
    want, jcache = jax_forward(jmodel, jnp.asarray(ids), jcache, jnp.asarray(pos0), jnp.asarray(lens))
    cache = make_cache(model, B, MAX_LEN)
    with torch.no_grad():
        got, cache = model(torch.from_numpy(ids), cache, torch.from_numpy(pos0), write_len=torch.from_numpy(lens))
    for b in range(B):
        close(got[b, : lens[b]], np.asarray(want)[b, : lens[b]])
    tok = np.array([[3], [5]], np.int32)
    for i in range(4):
        pos = lens + i
        want, jcache = jax_forward(jmodel, jnp.asarray(tok), jcache, jnp.asarray(pos))
        with torch.no_grad():
            got, cache = model(torch.from_numpy(tok), cache, torch.from_numpy(pos))
        close(got, np.asarray(want))
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)


def test_flash_prefill_route_matches_jax(monkeypatch):
    """D = 128, T = 256 from position 0 over rings: the full layer takes
    flash_prefill (the scale 144**-0.5, no softcap), the ring layers the
    concatenation chain (W = 8 < T)."""
    over = dict(num_attention_heads=2, num_key_value_heads=1, head_dim=128)
    jmodel, state = jax_model(**over)
    model = port_model(state, **over)
    ids = np.random.default_rng(26).integers(0, GEMMA3["vocab_size"], (1, 256)).astype(np.int32)
    monkeypatch.setattr(jax_attention, "try_flash_prefill", jax_flash_prefill_standin)
    want, _ = jax_prefill(jmodel, jnp.asarray(ids), jmodel.init_kv_cache(1, 260))
    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.shape, kw))
        return flash_prefill(q, k, v, **kw)

    flash_prefill = attention_mod.flash_prefill
    monkeypatch.setattr(attention_mod, "flash_prefill", spy)
    cache = make_cache(model, 1, 260)
    with torch.no_grad():
        close(model(torch.from_numpy(ids), cache, 0)[0], np.asarray(want))
    assert calls == [((1, 256, 2, 128), dict(softcap=None, scale=SCALE))]


@pytest.fixture(autouse=True)
def jax_plain_reader(monkeypatch):
    """JAX reads safetensors through its plain reader (`test_torch_checkpoint.py`)."""
    from quanto_tpu.utils import safetensors_io as jax_io

    monkeypatch.setattr(jax_io, "_try_mmap", lambda path: None)


def test_gemma3_checkpoint_loads_both_ways(tmp_path, models):
    jmodel0, _ = models
    state = gemma_state(jmodel0)
    port_config = Gemma3TextConfig(**GEMMA3)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(port_config.to_hf(), f)
    hf = transformers.AutoConfig.from_pretrained(str(tmp_path))
    assert type(hf).__name__ == "Gemma3TextConfig"
    jcfg = JaxGemma3Config.from_hf(hf, dtype=jnp.float32)
    assert jcfg == JaxGemma3Config(**GEMMA3, dtype=jnp.float32)
    jmodel = JaxGemma3(jcfg, rngs=nnx.Rngs(0))
    jmodel._hf_config = hf  # as JAX's from_pretrained keeps it: its save writes this config.json
    jax_load_hf_state_dict(jmodel, state)
    qt.quantize(jmodel, weights="qint4")
    qt.freeze(jmodel)
    jax_state = numpy_state(jax_hf_state_dict(jmodel))
    JaxQModel(jmodel).save_pretrained(str(tmp_path / "jax"))

    model = port_model(state)
    QuantizedModelForCausalLM.quantize(model, weights="qint4")
    assert_same_state(hf_state_dict(model), jax_state)
    QuantizedModelForCausalLM(model).save_pretrained(str(tmp_path / "port"))
    with open(tmp_path / "port" / "config.json") as f:
        saved = json.load(f)
    assert saved["model_type"] == "gemma3_text" and saved["architectures"] == ["Gemma3ForCausalLM"]

    ids = IDS[:, :T]
    want = np.asarray(jmodel(jnp.asarray(ids, jnp.int32))[0])
    loaded = QuantizedModelForCausalLM.from_pretrained(str(tmp_path / "jax"), dtype=torch.float32, device="cpu")
    assert dataclasses.replace(loaded.config, dtype=torch.float32) == model.config
    assert_same_state(hf_state_dict(loaded._wrapped), jax_state)
    with torch.no_grad():
        close(loaded(torch.from_numpy(ids))[0], want)
    jloaded = JaxQModel.from_pretrained(str(tmp_path / "port"), dtype=jnp.float32)._wrapped
    assert jloaded.config == jcfg and jloaded.lm_head is None
    assert_same_state(numpy_state(jax_hf_state_dict(jloaded)), jax_state)
    with torch.no_grad():
        close(model(torch.from_numpy(ids))[0], np.asarray(jloaded(jnp.asarray(ids, jnp.int32))[0]))


def test_engines_match_jax(models):
    """max_len 40 > W: the dense engines' caches ring the sliding layers;
    chunks of 8 leave each prompt's last chunk partial."""
    jmodel, model = models
    kw = dict(max_batch=3, max_len=40, prefill_chunk=8)
    assert drive(BatchedEngine(model, **kw), "mixed") == drive(JaxBatchedEngine(jmodel, **kw), "mixed")
    paged_kw = dict(max_batch=3, max_len=40, n_pages=31, page_size=4, prefill_chunk=8)
    engine = PagedEngine(model, kv_quant="qint8", **paged_kw)
    assert isinstance(engine._cache[0], QKVCacheLayer) and engine._cache[0]._k_data.shape[1] == W
    assert isinstance(engine._cache[2], PagedKVLayer) and not engine.prefix_sharing
    assert drive(engine, "serial") == drive(JaxPagedEngine(jmodel, kv_quant="qint8", **paged_kw), "serial")


def test_speculative_greedy_matches_generate(models, monkeypatch):
    """Flat caches past W (the window through flash_decode's `window` and the
    verify's mask), against `generate` over ring caches."""
    _, model = models
    ids = torch.from_numpy(IDS[:, :T])
    want = generate(model, ids, 10)
    windows = []

    def spy(*args, **kw):
        windows.append(kw["window"])
        return flash_decode(*args, **kw)

    flash_decode = attention_mod.flash_decode
    monkeypatch.setattr(attention_mod, "flash_decode", spy)
    got, _ = speculative_generate(model, layerskip_draft(model, 2), ids, 10, k=3)
    assert torch.equal(got, want)
    assert W in windows
