"""A tiny Gemma-2 of quanto_tpu_torch against quanto_tpu's.

The model: two layers (layer 0 sliding, window W = 8; layer 1 full), 4
query heads over 2 kv heads of 64 (the port's `flash_decode` takes D of 64,
128 and 256), hidden 256, the softcaps 50 and 30, query_pre_attn_scalar 144
(a query scale that is not D**-0.5), random unit-offset norms; float32, JAX's
weights carried over by the state-dict functions (`gemma_state`). Logits are
held to 1e-4 * max|ref| (`test_torch_llama.close`, as `test_torch_gemma.py`:
float32 on both sides, sums in another order), greedy tokens equal.

- Prefill of 2 x 13 tokens from position 0 (T > W), then 5 greedy steps that
  wrap the ring, over flat caches, ring caches and qint4 ring caches. JAX runs every step through `gqa_attention`; the port sends each
  T == 1 step to `flash_decode`'s plain version with the softcap, the scale
  and (flat sliding layers) the window, or over the post-write ring.
- Engine-style chunks at tensor positions with `write_len` (pad columns, a
  row with nothing to write) over a ring cache, as JAX's chunk programs run.
- A chunk longer than W with pad columns over a ring, held to JAX's
  FLAT-cache logits: JAX's ring keeps the chunk's last W columns, pads
  included, and is wrong there.
- At D = 128 and T = 256 from position 0 the full layer takes `flash_prefill`
  (its plain version) with the softcap and the scale, the ring layer the
  concatenation chain: JAX with its splash route stood in
  (`test_torch_flash_prefill.jax_flash_prefill_standin`).
- A qint4 gemma2 checkpoint saved by either package loads in the other.
- `BatchedEngine` (batched chunks and mixed steps) and `PagedEngine` (the
  paged+ring hybrid) give JAX's engines' tokens on prompts that cross W.
- Greedy speculation over the Gemma-2 target (flat caches, a layer-skip
  draft) equals `generate` over ring caches.
"""

import dataclasses
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from flax import nnx

import quanto_tpu as qt
from quanto_tpu.models.gemma2 import Gemma2Config as JaxGemma2Config
from quanto_tpu.models.gemma2 import Gemma2ForCausalLM as JaxGemma2
from quanto_tpu.models.loading import hf_state_dict as jax_hf_state_dict
from quanto_tpu.models.loading import load_hf_state_dict as jax_load_hf_state_dict
from quanto_tpu.models.serving import BatchedEngine as JaxBatchedEngine
from quanto_tpu.models.serving import PagedEngine as JaxPagedEngine
from quanto_tpu.models.transformers_models import QuantizedModelForCausalLM as JaxQModel
from quanto_tpu.ops import attention as jax_attention
from quanto_tpu_torch.models import BatchedEngine, Gemma2Config, Gemma2ForCausalLM, PagedEngine
from quanto_tpu_torch.models.llama import LlamaConfig
from quanto_tpu_torch.models.loading import hf_state_dict, load_hf_state_dict
from quanto_tpu_torch.models.serve import generate, make_cache
from quanto_tpu_torch.models.speculative import layerskip_draft, speculative_generate
from quanto_tpu_torch.models.transformers_models import QuantizedModelForCausalLM
from quanto_tpu_torch.ops import attention as attention_mod
from quanto_tpu_torch.ops.cuda import flash_decode as fd_mod
from quanto_tpu_torch.tensor.kv_cache import QKVCacheLayer, cache_max_len
from quanto_tpu_torch.tensor.paged_kv import PagedKVLayer

from .test_torch_checkpoint import assert_same_state, numpy_state
from .test_torch_flash_prefill import jax_flash_prefill_standin
from .test_torch_gemma import gemma_state
from .test_torch_llama import close

W = 8
GEMMA2 = dict(
    vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, sliding_window=W, query_pre_attn_scalar=144.0,
    max_position_embeddings=512,
)
# google/gemma-2-9b config.json.
GEMMA2_9B = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2", "attention_bias": False,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0, "head_dim": 256,
    "hidden_act": "gelu_pytorch_tanh", "hidden_activation": "gelu_pytorch_tanh", "hidden_size": 3584,
    "intermediate_size": 14336, "max_position_embeddings": 8192, "num_attention_heads": 16,
    "num_hidden_layers": 42, "num_key_value_heads": 8, "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0, "sliding_window": 4096, "vocab_size": 256000, "torch_dtype": "float32",
}
B, T, STEPS, MAX_LEN = 2, 13, 5, 24
IDS = np.random.default_rng(20).integers(0, GEMMA2["vocab_size"], (B, T + STEPS))


def jax_model(**over):
    model = JaxGemma2(JaxGemma2Config(**{**GEMMA2, **over}, dtype=jnp.float32), rngs=nnx.Rngs(0))
    state = gemma_state(model)
    assert jax_load_hf_state_dict(model, state)["missing"] == []
    return model, state


def port_model(state, **over):
    model = Gemma2ForCausalLM(Gemma2Config(**{**GEMMA2, **over}), device="cpu")
    assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
    return model


@pytest.fixture(scope="module")
def models():
    jmodel, state = jax_model()
    return jmodel, port_model(state)


def jax_run(model, cache, ids=IDS):
    """Prefill logits of ids[:, :T] from position 0, then STEPS greedy steps'
    logits and tokens."""
    logits, cache = model(jnp.asarray(ids[:, :T], jnp.int32), cache, 0)
    out = {"prefill": np.asarray(logits), "steps": [], "tokens": []}
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    for i in range(STEPS):
        out["tokens"].append(np.asarray(tok))
        step, cache = model(tok, cache, T + i)
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


def test_config_from_hf_matches_jax():
    port = Gemma2Config.from_hf(GEMMA2_9B)
    jax = JaxGemma2Config.from_hf(types.SimpleNamespace(**GEMMA2_9B), dtype=jnp.bfloat16)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(jax, f.name), f.name
    assert port.dtype == torch.bfloat16 and port.layer_types[:2] == ("sliding_attention", "full_attention")
    assert Gemma2Config.from_hf(port.to_hf()) == port
    with pytest.raises(NotImplementedError, match="Gemma2Config"):
        LlamaConfig.from_hf(GEMMA2_9B)


@pytest.mark.parametrize("kv,ring", [(None, False), (None, True), ("qint4", True)], ids=["flat", "ring", "qint4-ring"])
def test_tiny_gemma2_matches_jax(monkeypatch, models, kv, ring):
    jmodel, model = models
    ref = jax_run(jmodel, jmodel.init_kv_cache(B, MAX_LEN, kv_quant=kv, sliding_ring=ring))
    cache = make_cache(model, B, MAX_LEN, kv_quant=kv, sliding_ring=ring)
    assert cache_max_len(cache[0]) == (W if ring else MAX_LEN) and cache_max_len(cache[1]) == MAX_LEN
    calls = []

    def spy(q, k, v, *args, **kw):
        calls.append((k.shape[1], kw["window"], kw["softcap"], kw["scale"]))
        return flash_decode(q, k, v, *args, **kw)

    flash_decode = attention_mod.flash_decode
    monkeypatch.setattr(attention_mod, "flash_decode", spy)
    check_run(port_run(model, cache), ref)
    # Each step: the sliding layer over the ring or the flat cache with its window, then the full layer.
    first = (W, None) if ring else (MAX_LEN, W)
    assert calls == [(*first, 50.0, 144**-0.5), (MAX_LEN, None, 50.0, 144**-0.5)] * STEPS


def test_chunks_with_write_len_match_jax(models):
    """Rows of 15 and 10 tokens in chunks of 6 at per-row tensor positions
    over a ring; the second row's last chunk writes nothing (write_len 0)."""
    jmodel, model = models
    lens, C = [15, 10], 6
    ids = IDS[:, :15]
    jcache = jmodel.init_kv_cache(B, MAX_LEN)
    cache = make_cache(model, B, MAX_LEN)
    assert cache_max_len(cache[0]) == W
    for j in range(3):
        pos = np.array([min(j * C, n) for n in lens], np.int32)
        wl = np.array([max(0, min(C, n - j * C)) for n in lens], np.int32)
        chunk = np.zeros((B, C), np.int32)
        for b, n in enumerate(lens):
            chunk[b, : wl[b]] = ids[b, j * C : j * C + wl[b]]
        want, jcache = jmodel(jnp.asarray(chunk), jcache, jnp.asarray(pos), write_len=jnp.asarray(wl))
        with torch.no_grad():
            got, cache = model(torch.from_numpy(chunk), cache, torch.from_numpy(pos), write_len=torch.from_numpy(wl))
        for b in range(B):
            if wl[b]:
                close(got[b, : wl[b]], np.asarray(want)[b, : wl[b]])
    tok = np.array([[7], [9]], np.int32)
    for i in range(3):
        pos = np.array(lens, np.int32) + i
        want, jcache = jmodel(jnp.asarray(tok), jcache, jnp.asarray(pos))
        with torch.no_grad():
            got, cache = model(torch.from_numpy(tok), cache, torch.from_numpy(pos))
        close(got, np.asarray(want))
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)


def test_long_chunk_with_pads_matches_jax_flat_cache(models):
    """One chunk of 2 W + 4 columns at tensor position 0, rows with 17 and 20
    real tokens, then 4 steps: the port's ring against JAX's flat cache."""
    jmodel, model = models
    Tc, lens = 2 * W + 4, np.array([17, 20], np.int32)
    ids = np.random.default_rng(21).integers(0, GEMMA2["vocab_size"], (B, Tc)).astype(np.int32)
    ids[0, lens[0]:] = 0
    pos0 = np.zeros((B,), np.int32)
    jcache = jmodel.init_kv_cache(B, MAX_LEN, sliding_ring=False)
    want, jcache = jmodel(jnp.asarray(ids), jcache, jnp.asarray(pos0), write_len=jnp.asarray(lens))
    cache = make_cache(model, B, MAX_LEN)
    assert cache_max_len(cache[0]) == W
    with torch.no_grad():
        got, cache = model(torch.from_numpy(ids), cache, torch.from_numpy(pos0), write_len=torch.from_numpy(lens))
    for b in range(B):
        close(got[b, : lens[b]], np.asarray(want)[b, : lens[b]])
    tok = np.array([[3], [5]], np.int32)
    for i in range(4):
        pos = lens + i
        want, jcache = jmodel(jnp.asarray(tok), jcache, jnp.asarray(pos))
        with torch.no_grad():
            got, cache = model(torch.from_numpy(tok), cache, torch.from_numpy(pos))
        close(got, np.asarray(want))
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)


def test_flash_prefill_route_matches_jax(monkeypatch):
    """D = 128, T = 256 from position 0 over ring caches: the full layer
    takes flash_prefill (softcap 50, scale 144**-0.5), the ring layer the
    concatenation chain (W = 8 < T)."""
    ring = True
    over = dict(num_attention_heads=2, num_key_value_heads=1, head_dim=128)
    jmodel, state = jax_model(**over)
    model = port_model(state, **over)
    ids = np.random.default_rng(22).integers(0, GEMMA2["vocab_size"], (1, 258)).astype(np.int32)
    monkeypatch.setattr(jax_attention, "try_flash_prefill", jax_flash_prefill_standin)
    jcache = jmodel.init_kv_cache(1, 260, sliding_ring=ring)
    want, jcache = jmodel(jnp.asarray(ids[:, :256]), jcache, 0)
    steps = []
    for t in (256, 257):
        step, jcache = jmodel(jnp.asarray(ids[:, t : t + 1]), jcache, t)
        steps.append(np.asarray(step))
    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.shape, kw))
        return flash_prefill(q, k, v, **kw)

    flash_prefill = attention_mod.flash_prefill
    monkeypatch.setattr(attention_mod, "flash_prefill", spy)
    cache = make_cache(model, 1, 260, sliding_ring=ring)
    with torch.no_grad():
        got, cache = model(torch.from_numpy(ids[:, :256]), cache, 0)
        close(got, np.asarray(want))
        for t, ref in zip((256, 257), steps):
            step, cache = model(torch.from_numpy(ids[:, t : t + 1]), cache, t)
            close(step, ref)
    assert calls == [((1, 256, 2, 128), dict(softcap=50.0, scale=144**-0.5))]


@pytest.fixture(autouse=True)
def jax_plain_reader(monkeypatch):
    """JAX reads safetensors through its plain reader (`test_torch_checkpoint.py`)."""
    from quanto_tpu.utils import safetensors_io as jax_io

    monkeypatch.setattr(jax_io, "_try_mmap", lambda path: None)


def test_gemma2_checkpoint_loads_both_ways(tmp_path, models):
    jmodel0, _ = models
    state = gemma_state(jmodel0)
    port_config = Gemma2Config(**GEMMA2)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(port_config.to_hf(), f)
    hf = transformers.AutoConfig.from_pretrained(str(tmp_path))
    assert type(hf).__name__ == "Gemma2Config"
    jcfg = JaxGemma2Config.from_hf(hf, dtype=jnp.float32)
    assert jcfg == JaxGemma2Config(**GEMMA2, dtype=jnp.float32)
    jmodel = JaxGemma2(jcfg, rngs=nnx.Rngs(0))
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
    assert saved["model_type"] == "gemma2" and saved["architectures"] == ["Gemma2ForCausalLM"]

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


PROMPT_LENS, NEW = (19, 11, 27), 6


def engine_prompts():
    rng = np.random.default_rng(23)
    return [rng.integers(0, GEMMA2["vocab_size"], n).tolist() for n in PROMPT_LENS]


def drive(engine, mode: str):
    prompts = engine_prompts()
    if mode == "batch":
        rids = engine.add_batch(prompts, NEW)
    elif mode == "mixed":
        first = engine.add(prompts[0], NEW)
        engine.step()
        rids = [first] + [engine.enqueue(p, NEW) for p in prompts[1:]]
    else:
        rids = [engine.add(p, NEW) for p in prompts]
    engine.run_to_completion()
    return [engine.result(r) for r in rids]


def test_engines_match_jax(models):
    """max_len 40 > W: the dense engines' caches ring the sliding layer;
    chunks of 8 leave each prompt's last chunk partial."""
    jmodel, model = models
    kw = dict(max_batch=3, max_len=40, prefill_chunk=8)
    for mode in ("batch", "mixed"):
        got = drive(BatchedEngine(model, **kw), mode)
        assert got == drive(JaxBatchedEngine(jmodel, **kw), mode), mode
    paged_kw = dict(max_batch=3, max_len=40, n_pages=31, page_size=4, prefill_chunk=8)
    engine = PagedEngine(model, **paged_kw)
    assert isinstance(engine._cache[0], tuple) and engine._cache[0][0].shape[1] == W
    assert isinstance(engine._cache[1], PagedKVLayer) and not engine.prefix_sharing
    got = drive(engine, "serial")
    assert got == drive(JaxPagedEngine(jmodel, **paged_kw), "serial")
    qengine = PagedEngine(model, kv_quant="qint8", **paged_kw)
    assert isinstance(qengine._cache[0], QKVCacheLayer) and qengine._cache[0]._k_data.shape[1] == W
    assert drive(qengine, "serial") == drive(JaxPagedEngine(jmodel, kv_quant="qint8", **paged_kw), "serial")


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
    got, _ = speculative_generate(model, layerskip_draft(model, 1), ids, 10, k=3)
    assert torch.equal(got, want)
    assert W in windows  # the flat sliding layer's decode took the window
    assert fd_mod.flash_decode.launches == 0
