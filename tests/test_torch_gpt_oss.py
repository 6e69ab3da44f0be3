"""A tiny GPT-OSS of quanto_tpu_torch against quanto_tpu's.

The model: two layers (layer 0 sliding, window W = 8; layer 1 full), 4 query
heads over 2 kv heads of 64 (the port's `flash_decode` takes D of 64, 128 and
256), hidden 64, 4 experts of 96, top-2, biased q/k/v/o, yarn rope; float32,
JAX's weights carried over by the state-dict functions with the sinks, the
router bias and every other bias drawn at random (zero at init would test
nothing; as `tests/models/test_gpt_oss.py` does). Logits are held to 2e-4 *
max|ref| (`test_torch_llama.close`; float32 on both sides, sums in another
order), greedy tokens equal.

- The config of openai/gpt-oss-20b read by both packages (JAX from
  transformers' `GptOssConfig`, the port from the plain dict); `build_model`
  refuses gpt_oss, as JAX's, and names the route that builds one.
- Prefill without a cache against JAX, and the port's cached decode (prefill,
  then teacher-forced steps) against its own full forward.
- Prefill of 2 x 13 tokens from position 0 (T > W), then 5 greedy steps that
  wrap the ring, over ring caches in float32 and qint8: JAX runs every step
  through `gqa_attention` with the sinks; the port sends each T == 1 step to
  `flash_decode`'s plain version with the sinks (over the post-write ring).
- A chunk longer than W with pad columns over the port's ring, held to JAX's
  FLAT-cache logits (JAX's ring keeps the chunk's last W columns, pads
  included, and is wrong there).
- `BatchedEngine` (batched chunks and mixed steps) and `PagedEngine` (the
  paged+ring hybrid) give `generate`'s tokens on prompts that cross W, and
  keep `kv_quant` in their caches; greedy speculation over flat caches equals
  `generate`.
- `StackedGptOssMoE` (hidden 512, intermediate 192: gate and up padded to
  [256, 1024], down to [512, 1024]; 8 experts, top-2, since the unique-expert
  route needs E >= 8): its stacked codes, scales and shifts equal JAX's bit
  for bit, and its selective, unique-expert, all-experts and capacity routes
  give JAX's stacked block's output (its MoE kernels in interpret mode) within
  2e-5 * max|ref| (as `test_torch_mixtral.py`), with each route's calls.
- The padded, biased qint4 linears of gpt-oss-20b's attention (K = 2880 at the
  auto group size 96, and o_proj's N = 2880) against JAX's.
- An engine chunk's pad columns take no capacity slot from a real token
  (`valid`), where JAX's block lets them (ROADMAP.md Queue 3).
- The hooks left Mixtral's and Qwen3-MoE's stacked block as it was: each route's
  calls, and the output of the dense-mask block over the same codes.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from flax import nnx

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.models.gpt_oss import GptOssConfig as JaxGptOssConfig
from quanto_tpu.models.gpt_oss import GptOssForCausalLM as JaxGptOss
from quanto_tpu.models.loading import load_hf_state_dict as jax_load_hf_state_dict
from quanto_tpu.ops.pallas.qbits_mm import unpack_split_half
from quanto_tpu.parallel.moe import StackedGptOssMoE as JaxStackedGptOssMoE
from quanto_tpu_torch.models import BatchedEngine, GptOssConfig, GptOssForCausalLM, PagedEngine
from quanto_tpu_torch.models.gpt_oss import GptOssMLP
from quanto_tpu_torch.models.loading import load_hf_state_dict
from quanto_tpu_torch.models.qwen3 import Qwen3MoeConfig, Qwen3MoeSparseBlock
from quanto_tpu_torch.models.serve import generate, make_cache
from quanto_tpu_torch.models.speculative import layerskip_draft, speculative_generate
from quanto_tpu_torch.models.transformers_models import build_model
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.ops import attention as attention_mod
from quanto_tpu_torch.ops.cuda.qbits_mm import unpack_k_codes
from quanto_tpu_torch.parallel import StackedGptOssMoE, StackedSparseMoeBlock, convert_gpt_oss_moe_to_stacked
from quanto_tpu_torch.tensor.kv_cache import QKVCacheLayer, cache_max_len
from quanto_tpu_torch.tensor.paged_kv import PagedKVLayer
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

from .test_torch_checkpoint import numpy_state
from .test_torch_llama import close
from .test_torch_mixtral import count_launches, to_hopper

W = 8
GPT_OSS = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, num_local_experts=4, num_experts_per_tok=2, sliding_window=W,
    max_position_embeddings=512,
)
YARN = {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 16, "beta_fast": 32.0,
        "beta_slow": 1.0, "truncate": False}
# openai/gpt-oss-20b config.json (the keys the models read; its mxfp4 quantization_config left out).
GPT_OSS_20B = {
    "architectures": ["GptOssForCausalLM"], "model_type": "gpt_oss", "attention_bias": True, "head_dim": 64,
    "hidden_act": "silu", "hidden_size": 2880, "intermediate_size": 2880,
    "layer_types": ["sliding_attention", "full_attention"] * 12, "max_position_embeddings": 131072,
    "num_attention_heads": 64, "num_experts_per_tok": 4, "experts_per_token": 4, "num_hidden_layers": 24,
    "num_key_value_heads": 8, "num_local_experts": 32, "rms_norm_eps": 1e-05,
    "rope_scaling": {"beta_fast": 32.0, "beta_slow": 1.0, "factor": 32.0, "original_max_position_embeddings": 4096,
                     "rope_type": "yarn", "truncate": False},
    "rope_theta": 150000, "sliding_window": 128, "swiglu_limit": 7.0, "tie_word_embeddings": False,
    "vocab_size": 201088,
}
B, T, STEPS, MAX_LEN = 2, 13, 5, 24
IDS = np.random.default_rng(22).integers(0, GPT_OSS["vocab_size"], (B, T + STEPS))
TOL = 2e-4

# JAX's forwards under one compile each: eagerly every op compiles on its own, several times slower.
jax_prefill = nnx.jit(lambda m, ids, cache: m(ids, cache, 0))
jax_step = nnx.jit(lambda m, ids, cache, pos: m(ids, cache, pos))
jax_forward = nnx.jit(lambda m, ids: m(ids)[0])
jax_chunk = nnx.jit(lambda m, ids, cache, pos, write_len: m(ids, cache, pos, write_len=write_len))


def gpt_oss_state(model, seed: int = 4) -> dict:
    """JAX's float state with the norms drawn about 1 and every bias and sink
    drawn at random: the sinks about 0 at the logits' scale, the biases small."""
    rng = np.random.default_rng(seed)
    state = numpy_state(qt.models.loading.hf_state_dict(model))
    for k, v in state.items():
        if "norm" in k:
            state[k] = (1.0 + rng.standard_normal(v.shape) * 0.2).astype(v.dtype)
        elif k.endswith("sinks"):
            state[k] = rng.uniform(-1.0, 1.0, v.shape).astype(v.dtype)
        elif k.endswith("router.bias"):
            state[k] = rng.uniform(-0.5, 0.5, v.shape).astype(v.dtype)
        elif "bias" in k:
            state[k] = (rng.standard_normal(v.shape) * 0.05).astype(v.dtype)
    return state


def jax_model(**over):
    model = JaxGptOss(JaxGptOssConfig(**{**GPT_OSS, **over}, dtype=jnp.float32), rngs=nnx.Rngs(0))
    state = gpt_oss_state(model)
    assert jax_load_hf_state_dict(model, state)["missing"] == []
    return model, state


def port_model(state, **over):
    if "rope_scaling" in over:
        over["rope_scaling"] = tuple(sorted(over["rope_scaling"].items()))
    model = GptOssForCausalLM(GptOssConfig(**{**GPT_OSS, **over}), device="cpu")
    assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
    return model


@pytest.fixture(scope="module")
def models():
    jmodel, state = jax_model(rope_scaling=tuple(sorted(YARN.items())))
    return jmodel, port_model(state, rope_scaling=YARN)


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


def test_config_from_hf_matches_jax():
    port = GptOssConfig.from_hf(GPT_OSS_20B)
    jax = JaxGptOssConfig.from_hf(transformers.GptOssConfig(**GPT_OSS_20B), dtype=jnp.bfloat16)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(jax, f.name), f.name
    assert port == GptOssConfig(dtype=torch.bfloat16)  # the released defaults
    assert port.layer_types[:2] == ("sliding_attention", "full_attention") and port.query_pre_attn_scalar == 64
    bare = {k: v for k, v in GPT_OSS_20B.items() if k not in ("rope_scaling", "layer_types")}
    assert GptOssConfig.from_hf(bare) == port  # HF's defaults where the file names none
    with pytest.raises(NotImplementedError, match="GptOssConfig"):
        build_model(GPT_OSS_20B)


def test_tiny_gpt_oss_matches_jax_and_cached_decode(models):
    """Prefill without a cache against JAX; then the port's prefill over a
    ring cache and teacher-forced steps against its own full forward."""
    jmodel, model = models
    ids = IDS.astype(np.int32)
    want = np.asarray(jax_forward(jmodel, jnp.asarray(ids)))
    with torch.no_grad():
        full, _ = model(torch.from_numpy(ids))
        close(full, want, TOL)
        cache = make_cache(model, B, MAX_LEN)
        assert cache_max_len(cache[0]) == W and cache_max_len(cache[1]) == MAX_LEN
        logits, cache = model(torch.from_numpy(ids[:, :T]), cache, 0)
        got = [logits]
        for t in range(T, T + STEPS):
            step, cache = model(torch.from_numpy(ids[:, t : t + 1]), cache, t)
            got.append(step)
    close(torch.cat(got, dim=1), full.numpy(), TOL)


@pytest.mark.parametrize("kv", [None, "qint8"], ids=["float-ring", "qint8-ring"])
def test_rings_match_jax(monkeypatch, models, kv):
    jmodel, model = models
    ref = jax_run(jmodel, jmodel.init_kv_cache(B, MAX_LEN, kv_quant=kv))
    cache = make_cache(model, B, MAX_LEN, kv_quant=kv)
    assert cache_max_len(cache[0]) == W and (kv is None) != isinstance(cache[0], QKVCacheLayer)
    calls = []

    def spy(q, k, v, *args, **kw):
        calls.append((k.shape[1], kw["window"], kw["sinks"].shape))
        return flash_decode(q, k, v, *args, **kw)

    flash_decode = attention_mod.flash_decode
    monkeypatch.setattr(attention_mod, "flash_decode", spy)
    got = port_run(model, cache)
    close(got["prefill"], ref["prefill"], TOL)
    for i in range(STEPS):
        np.testing.assert_array_equal(got["tokens"][i], ref["tokens"][i])
        close(got["steps"][i], ref["steps"][i], TOL)
    # Each step: the sliding layer over the ring, then the full layer; both with the 4 heads' sinks.
    assert calls == [(W, None, (4,)), (MAX_LEN, None, (4,))] * STEPS


def test_long_chunk_with_pads_matches_jax_flat_cache(models):
    """One chunk of 2 W + 4 columns at tensor position 0, rows with 17 and 20
    real tokens, then 3 steps: the port's ring against JAX's flat cache."""
    jmodel, model = models
    Tc, lens = 2 * W + 4, np.array([17, 20], np.int32)
    ids = np.random.default_rng(21).integers(0, GPT_OSS["vocab_size"], (B, Tc)).astype(np.int32)
    ids[0, lens[0]:] = 0
    pos0 = np.zeros((B,), np.int32)
    jcache = jmodel.init_kv_cache(B, MAX_LEN, sliding_ring=False)
    want, jcache = jax_chunk(jmodel, jnp.asarray(ids), jcache, jnp.asarray(pos0), jnp.asarray(lens))
    cache = make_cache(model, B, MAX_LEN)
    assert cache_max_len(cache[0]) == W
    with torch.no_grad():
        got, cache = model(torch.from_numpy(ids), cache, torch.from_numpy(pos0), write_len=torch.from_numpy(lens))
    for b in range(B):
        close(got[b, : lens[b]], np.asarray(want)[b, : lens[b]], TOL)
    tok = np.array([[3], [5]], np.int32)
    for i in range(3):
        pos = lens + i
        want, jcache = jax_step(jmodel, jnp.asarray(tok), jcache, jnp.asarray(pos))
        with torch.no_grad():
            got, cache = model(torch.from_numpy(tok), cache, torch.from_numpy(pos))
        close(got, np.asarray(want), TOL)
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)


PROMPT_LENS, NEW = (19, 11, 27), 6


def engine_prompts():
    rng = np.random.default_rng(23)
    return [rng.integers(0, GPT_OSS["vocab_size"], n).tolist() for n in PROMPT_LENS]


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


def test_engines_match_generate(models):
    """max_len 40 > W: the dense engine's caches ring the sliding layer, the
    paged engine keeps it a dense ring beside the full layer's pages; chunks
    of 8 leave each prompt's last chunk partial. Each request's tokens are
    `generate`'s on its own prompt; with kv_quant the caches stay quantized."""
    _, model = models
    want = [generate(model, torch.tensor([p]), NEW)[0, len(p):].tolist() for p in engine_prompts()]
    kw = dict(max_batch=3, max_len=40, prefill_chunk=8)
    engine = BatchedEngine(model, **kw)
    assert cache_max_len(engine._cache[0]) == W and cache_max_len(engine._cache[1]) == 40
    assert drive(engine, "batch") == want
    assert drive(BatchedEngine(model, **kw), "mixed") == want
    paged_kw = dict(max_batch=3, max_len=40, n_pages=31, page_size=4, prefill_chunk=8)
    engine = PagedEngine(model, **paged_kw)
    assert isinstance(engine._cache[0], tuple) and engine._cache[0][0].shape[1] == W
    assert isinstance(engine._cache[1], PagedKVLayer) and not engine.prefix_sharing
    assert drive(engine, "serial") == want
    q_engine = BatchedEngine(model, kv_quant="qint8", **kw)
    assert all(isinstance(c, QKVCacheLayer) for c in q_engine._cache) and cache_max_len(q_engine._cache[0]) == W
    q_paged = PagedEngine(model, kv_quant="qint8", **paged_kw)
    assert isinstance(q_paged._cache[0], QKVCacheLayer) and q_paged._cache[1]._k_scale is not None
    assert drive(q_engine, "batch") == drive(q_paged, "serial")


def test_speculative_greedy_matches_generate(models, monkeypatch):
    """Flat caches past W (the window through flash_decode's `window` and the
    verify's sliding mask, the sinks on every call), against `generate` over
    ring caches."""
    _, model = models
    ids = torch.from_numpy(IDS[:, :T])
    want = generate(model, ids, 10)
    calls = []

    def spy(*args, **kw):
        calls.append((kw["window"], kw["sinks"] is not None))
        return flash_decode(*args, **kw)

    flash_decode = attention_mod.flash_decode
    monkeypatch.setattr(attention_mod, "flash_decode", spy)
    got, _ = speculative_generate(model, layerskip_draft(model, 1), ids, 10, k=3)
    assert torch.equal(got, want)
    assert (W, True) in calls and all(s for _, s in calls)


# --- the stacked block ----------------------------------------------------------------------

BLOCK = dict(GPT_OSS, hidden_size=512, intermediate_size=192, num_local_experts=8, num_experts_per_tok=2)


@pytest.fixture(scope="module")
def blocks():
    """(JAX's StackedGptOssMoE, the port's), quantized by each from the same
    float GptOssMLP (random biases)."""
    jlayer = JaxGptOss(JaxGptOssConfig(**{**BLOCK, "num_hidden_layers": 1}, dtype=jnp.float32),
                       rngs=nnx.Rngs(1)).model.layers[0]
    state = {k[len("mlp."):]: v for k, v in gpt_oss_state(jlayer, seed=5).items() if k.startswith("mlp.")}
    jblock = jlayer.mlp
    assert jax_load_hf_state_dict(jblock, state)["missing"] == []
    pblock = GptOssMLP(GptOssConfig(**BLOCK), device="cpu", dtype=torch.float32)
    assert load_hf_state_dict(pblock, state) == {"missing": [], "unexpected": []}
    return JaxStackedGptOssMoE(jblock, weights="qint4", group_size=128), StackedGptOssMoE(pblock)


def test_stacked_codes_match_jax(blocks):
    """Padded before quantization: [256, 1024] gate and up, [512, 1024] down,
    codes, scales and shifts equal JAX's bit for bit."""
    jblock, block = blocks
    for which, shape in (("gate", (256, 1024)), ("up", (256, 1024)), ("down", (512, 1024))):
        jp, pp = getattr(jblock, f"proj_{which}"), getattr(block, f"proj_{which}")
        data, scale, shift = (np.asarray(a) for a in jp.leaves())
        assert (pp.packed.shape[1], pp.packed.shape[2] * 2) == shape and pp.group_size == 128
        for e in range(BLOCK["num_local_experts"]):
            np.testing.assert_array_equal(unpack_k_codes(pp.packed[e], 4).numpy(),
                                          np.asarray(unpack_split_half(jnp.asarray(data[e]), 4, shape[1], 1)))
        np.testing.assert_array_equal(pp.scale_t.numpy(), scale)
        np.testing.assert_array_equal(pp.shift_t.numpy(), shift)


# (B, T), the wrappers' calls (small_m, tiled) at E = 8, top-2: S·K = 6 < E (selective); S·K = 8
# = E (the unique-expert route over a routed-first table); S·K = 32 > 2E at S = 16 (all experts);
# S = 64 past the all route (capacity gather).
ROUTES = {"selective": ((1, 3), (3, 0)), "uniq": ((2, 2), (2, 1)), "all": ((2, 8), (2, 1)),
          "capacity": ((2, 32), (0, 3))}


@pytest.mark.parametrize("case", list(ROUTES))
def test_stacked_block_matches_jax(blocks, monkeypatch, case):
    (b, t), want = ROUTES[case]
    jblock, block = blocks
    x = (np.random.default_rng(b * 1000 + t).standard_normal((b, t, BLOCK["hidden_size"])) * 0.5).astype(np.float32)
    ref = np.asarray(jblock(jnp.asarray(x)))
    calls = count_launches(monkeypatch)
    with torch.no_grad():
        out = block(torch.from_numpy(x))
    assert (calls["qbits_moe_small_m"], calls["qbits_moe_tiled"]) == want
    close(out, ref, 2e-5)


def test_pad_columns_take_no_capacity(blocks):
    """An engine chunk's pad columns repeat one token, so they all pick the
    same experts. With the chunk's real columns marked (`valid`, from
    `write_len`) they take no slot of the capacity route (S = 80, 40 slots an
    expert) from a real token: the real tokens' outputs are those of the block
    with no capacity (`capacity_factor=None`). Unmarked, the 32 pads push real
    tokens out of their experts' slabs (JAX's block, which has no `valid`)."""
    _, block = blocks
    rng = np.random.default_rng(40)
    x = (rng.standard_normal((2, 40, BLOCK["hidden_size"])) * 0.5).astype(np.float32)
    x[1, 8:] = x[1, 7]
    xt = torch.from_numpy(x)
    valid = torch.arange(40)[None, :] < torch.tensor([[40], [8]])
    exact = copy.copy(block)
    exact.capacity_factor = None
    with torch.no_grad():
        want = exact(xt)
        got, unmasked = block(xt, valid), block(xt)
    close(got[valid], want[valid].numpy(), 1e-5)
    moved = (unmasked[valid] - want[valid]).abs().amax(dim=-1) > 1e-3 * want.abs().max()
    assert int(moved.sum()) > 0


def test_converter_quantizes_the_experts(models):
    """convert_gpt_oss_moe_to_stacked swaps every GptOssMLP and leaves the
    router in float; the stacked model's logits stay near the float model's."""
    _, model = models
    stacked = port_model(load_state(model), rope_scaling=YARN)
    assert convert_gpt_oss_moe_to_stacked(stacked) == GPT_OSS["num_hidden_layers"]
    mlp = stacked.model.layers[1].mlp
    assert isinstance(mlp, StackedGptOssMoE) and mlp.gate.weight.dtype == torch.float32
    assert mlp.proj_down.packed.shape == (4, 128, 512)  # N 64 -> 128, K 96 -> 1024
    ids = torch.from_numpy(IDS[:, :T])
    with torch.no_grad():
        cos = torch.nn.functional.cosine_similarity(stacked(ids)[0], model(ids)[0], dim=-1)
    assert bool((cos > 0.99).all())


def load_state(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("shape", [(512, 2880), (2880, 4096)], ids=["q_proj", "o_proj"])
def test_padded_biased_attention_linear_matches_jax(shape):
    """gpt-oss-20b's attention widths: q/k/v at K = 2880 (the auto group size
    96, padded to groups of 128 over K 3840), o_proj at N = 2880 (padded to
    2944); the bias added after the output is sliced back."""
    N, K = shape
    rng = np.random.default_rng(N)
    w = (rng.standard_normal((N, K)) * 0.02).astype(np.float32)
    bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
    x = (rng.standard_normal((3, K))).astype(np.float32)
    jlin = nnx.Linear(K, N, rngs=nnx.Rngs(0))
    jlin.kernel.set_value(jnp.asarray(w.T))
    jlin.bias.set_value(jnp.asarray(bias))
    jwrap = nnx.Sequential(jlin)
    qt.quantize(jwrap, weights="qint4")
    qt.freeze(jwrap)
    ref = jwrap(jnp.asarray(x))
    ref = np.asarray(ref.dequantize() if hasattr(ref, "dequantize") else ref)
    lin = torch.nn.Sequential(torch.nn.Linear(K, N))
    with torch.no_grad():
        lin[0].weight.copy_(torch.from_numpy(w))
        lin[0].bias.copy_(torch.from_numpy(bias))
    qtt.quantize(lin, weights="qint4")
    qtt.freeze(lin)
    to_hopper(lin)
    hop = lin[0].weight
    assert isinstance(lin[0], QLinear) and isinstance(hop, WeightQBitsHopperArray) and hop.pad is not None
    assert hop.kernel_shape == ((2944, K) if N == 2880 else (N, 3840))
    with torch.no_grad():
        close(lin(torch.from_numpy(x)), ref, 1e-5)


def test_mixtral_qwen3_routes_unchanged(monkeypatch):
    """The base block's hooks are the SwiGLU and the identity: a Qwen3-MoE
    block (16 experts, top-4) stacked in qint4 gives, on each route, the calls
    of `test_torch_qwen3.py` and the output of its dense-mask block over the
    same codes."""
    c = Qwen3MoeConfig(hidden_size=256, num_experts=16, num_experts_per_tok=4, moe_intermediate_size=256)
    dense = Qwen3MoeSparseBlock(c, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in dense.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    qtt.quantize(dense, weights="qint4")
    qtt.freeze(dense)
    to_hopper(dense)
    block = StackedSparseMoeBlock(dense)
    y = torch.ones(2)
    assert block._post_mm("down", y) is y
    for (b, t), want in (((2, 1), (3, 0)), ((4, 1), (2, 1)), ((2, 32), (0, 3))):
        x = torch.randn((b, t, 256), generator=g) * 0.3
        if b * t == 64:  # no expert past the capacity route's slabs, where the block drops tokens
            assert int(torch.bincount(block._route(x)[0].reshape(-1), minlength=16).max()) <= block._capacity(64)
        calls = count_launches(monkeypatch)
        with torch.no_grad():
            out, ref = block(x), dense(x)
        assert (calls["qbits_moe_small_m"], calls["qbits_moe_tiled"]) == want
        close(out, ref.numpy(), 2e-5)
