"""The port's speculative decoding and sampled decode against quanto_tpu.

Every case of `tests/models/test_speculative.py`, on tiny float32 Llamas
whose weights come across from the JAX model through `hf_state_dict` ->
numpy -> `load_hf_state_dict` (head_dim 64: the port's decode attention,
`flash_decode`, takes head dims 64 and 128 only; its plain version runs on
these CPU tensors). Greedy speculation gives tokens EQUAL to the port's own
`generate`, to JAX's `speculative_generate` and to JAX's acceptance, for an
unrelated draft, a self-draft (acceptance exactly 1), three diverging rows,
a qint8 target with a qint8 draft, and a layer-skip draft of a qint8 target
that shares the target's storage. Rejection sampling is held to JAX's target
distribution: the port's first emission over 4096 identical rows is within
L1 0.15 of JAX's exact p and closer to p than to the draft's q by 0.1. The
port draws from a `torch.Generator`, JAX from PRNG keys, so sampled outputs
are compared in distribution only. A cache-bound case drives one row that
accepts every draft beside rows that accept none. `serve.decode` with a
sampler: greedy equals JAX's `make_decode_fn`, a seeded sampler repeats,
and a different `pos0` moves the default generator's draws.
"""

import dataclasses

import jax
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
from quanto_tpu.models.loading import hf_state_dict
from quanto_tpu.models.sampling import make_logits_warp as jax_make_logits_warp
from quanto_tpu.models.serve import make_decode_fn as jax_make_decode_fn
from quanto_tpu.models.serve import make_prefill_fn as jax_make_prefill_fn
from quanto_tpu.models.speculative import SpeculativeGenerator as JaxSpeculativeGenerator
from quanto_tpu.models.speculative import layerskip_draft as jax_layerskip_draft
from quanto_tpu_torch import models as port_models
from quanto_tpu_torch.models import speculative
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_kv_cache
from quanto_tpu_torch.models.loading import load_hf_state_dict
from quanto_tpu_torch.models.sampling import greedy, make_logits_warp, make_sampler
from quanto_tpu_torch.models.serve import decode, generate, make_cache, prefill
from quanto_tpu_torch.models.speculative import (
    SpeculativeGenerator,
    layerskip_draft,
    make_speculative_sample_decode_fn,
    speculative_generate,
)

V = 128
TARGET = dict(
    vocab_size=V, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
    num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=512,
)
DRAFT = dict(TARGET, hidden_size=64, intermediate_size=128, num_hidden_layers=1, num_attention_heads=1)


def pair(config: dict, seed: int, weights=None):
    """(JAX model, port model) holding the same float32 weights, both
    quantized with `weights` (lm_head excluded) when it is given: the codes
    and scales are then bit for bit alike (`test_torch_llama.py`)."""
    jm = JaxLlama(JaxLlamaConfig(**config), rngs=nnx.Rngs(seed))
    state = {k: np.asarray(v) for k, v in hf_state_dict(jm).items()}
    pm = LlamaForCausalLM(LlamaConfig(**config), device="cpu")
    assert load_hf_state_dict(pm, state) == {"missing": [], "unexpected": []}
    if weights is not None:
        qt.quantize(jm, weights=weights, exclude="lm_head")
        qt.freeze(jm)
        qtt.quantize(pm, weights=weights, exclude="lm_head")
        qtt.freeze(pm)
    return jm, pm


def prompt(batch: int = 1, T: int = 8, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, V, (batch, T)).astype(np.int32)


def check_greedy(target, draft, ids: np.ndarray, new: int, k: int) -> float:
    """The port's greedy speculation (target and draft each a (JAX model,
    port model) pair) against its own `generate`, then its tokens and
    acceptance against JAX's `SpeculativeGenerator` (one per configuration:
    JAX compiles it on its first call). Returns the acceptance."""
    (jt, pt), (jd, pd) = target, draft
    out, acceptance = speculative_generate(pt, pd, torch.from_numpy(ids), new, k=k)
    np.testing.assert_array_equal(out.numpy(), generate(pt, torch.from_numpy(ids), new).numpy())
    jax_out, jax_acceptance = JaxSpeculativeGenerator(jt, jd, k).generate(jnp.asarray(ids), new)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_out))
    assert acceptance == jax_acceptance
    assert 0.0 <= acceptance <= 1.0
    return acceptance


@pytest.fixture(scope="module")
def target():
    return pair(TARGET, 0)


@pytest.fixture(scope="module")
def qint8_target():
    """A 4-layer qint8 target pair, shared by the qint8-pair and layer-skip cases."""
    return pair(dict(TARGET, num_hidden_layers=4), 0, weights="qint8")


@pytest.fixture(scope="module")
def vocab64_target():
    """A 3-layer float target pair at V = 64, shared by the distribution and
    layer-skip logit cases."""
    return pair(dict(TARGET, num_hidden_layers=3, vocab_size=64), 0)


def test_greedy_unrelated_draft(target):
    draft = pair(DRAFT, 7)
    check_greedy(target, draft, prompt(), 24, k=3)


def test_greedy_self_draft_accepts_all(target):
    assert check_greedy(target, target, prompt(seed=1), 16, k=4) == 1.0


def test_greedy_batch_rows_diverge(target):
    draft = pair(DRAFT, 3)
    check_greedy(target, draft, prompt(batch=3, seed=2), 12, k=2)


def test_greedy_qint8_pair(qint8_target):
    draft = pair(DRAFT, 5, weights="qint8")
    assert isinstance(qint8_target[1].model.layers[0].mlp.up_proj.weight, qtt.WeightQBytesArray)
    check_greedy(qint8_target, draft, prompt(seed=4), 16, k=3)


def test_layerskip_draft_qint8_shares_storage_and_greedy_exact(qint8_target):
    """A 2-layer draft of a 4-layer qint8 target: the target's own modules
    (same storage, by data_ptr), 2-layer caches, and greedy tokens EQUAL to
    the target's and to JAX's layer-skip speculation."""
    jt, pt = qint8_target
    pd, jd = layerskip_draft(pt, 2), jax_layerskip_draft(jt, 2)
    assert pd.config.num_hidden_layers == 2 and len(pd.model.layers) == 2
    assert pt.config.num_hidden_layers == 4 and len(pt.model.layers) == 4
    tq, dq = pt.model.layers[0].self_attn.q_proj.weight, pd.model.layers[1].self_attn.q_proj.weight
    assert dq._data.data_ptr() == pt.model.layers[1].self_attn.q_proj.weight._data.data_ptr() != tq._data.data_ptr()
    assert pd.lm_head.weight.data_ptr() == pt.lm_head.weight.data_ptr()
    assert pd.model.embed_tokens.weight.data_ptr() == pt.model.embed_tokens.weight.data_ptr()
    assert pd.inv_freq.data_ptr() == pt.inv_freq.data_ptr()
    assert len(make_cache(pd, 2, 8)) == 2
    check_greedy((jt, pt), (jd, pd), prompt(batch=2, T=6), 12, k=3)


def test_layerskip_draft_float_target_logits_match_jax(vocab64_target):
    """A 1-layer draft of a 3-layer float target: its logits are JAX's
    layer-skip draft's, and it is the target's first layer (not a copy)."""
    jt, pt = vocab64_target
    pd = layerskip_draft(pt, 1)
    assert pd.model.layers[0] is pt.model.layers[0] and pd.model.norm is pt.model.norm
    ids = np.array([[3, 9, 1]], dtype=np.int32)
    with torch.no_grad():
        out, _ = pd(torch.from_numpy(ids))
    ref, _ = nnx.jit(lambda m, x: m(x))(jax_layerskip_draft(jt, 1), jnp.asarray(ids))
    assert out.shape == (1, 3, 64)
    ref = np.asarray(ref)
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-4 * np.max(np.abs(ref))


def test_layerskip_draft_refuses_unaligned_modules():
    """A target whose modules do not line up with its shallow model's (here
    the final norm moved to another path) is refused, as JAX refuses one."""
    pm = LlamaForCausalLM(LlamaConfig(**TARGET), device="cpu")
    pm.model.final_norm = pm.model.norm
    del pm.model.norm
    with pytest.raises(ValueError, match="path-compatible"):
        layerskip_draft(pm, 1)


def test_generator_refuses_device_or_vocab_mismatch(target):
    other_vocab = LlamaForCausalLM(LlamaConfig(**dict(DRAFT, vocab_size=V * 2)), device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeGenerator(target[1], other_vocab)
    on_meta = LlamaForCausalLM(LlamaConfig(**DRAFT), device="meta")
    with pytest.raises(ValueError, match="one device"):
        SpeculativeGenerator(target[1], on_meta)


def bigram(step_high: int) -> LlamaForCausalLM:
    """A model whose next token depends on the current one alone: the
    embedding is the identity, every layer adds nothing (o_proj and
    down_proj zero), and the lm_head maps token a to a + 1 within 0-63 and
    to 64 + (a - 64 + step_high) % 64 within 64-127."""
    m = LlamaForCausalLM(LlamaConfig(**TARGET), device="cpu")
    nxt = [(a + 1) % 64 if a < 64 else 64 + (a - 64 + step_high) % 64 for a in range(V)]
    with torch.no_grad():
        m.model.embed_tokens.weight.copy_(torch.eye(V))
        for layer in m.model.layers:
            layer.self_attn.o_proj.weight.zero_()
            layer.mlp.down_proj.weight.zero_()
        m.lm_head.weight.zero_()
        m.lm_head.weight[torch.tensor(nxt), torch.arange(V)] = 1.0
    return m


def test_cache_bound_with_rows_accepting_all_and_none():
    """Row 0 runs where target and draft agree (tokens 0-63: every draft
    accepted, k+1 tokens a round), rows 1 and 2 where they never do (64-127:
    no draft accepted, one token a round), so the host loop runs until the
    slow rows are done while row 0 writes k+1 slots a round ahead. With
    max_new_tokens not a multiple of k+1, JAX's worst-case cache bound holds
    every write (the port's `kv_update` raises past the cache) and the
    tokens are the target's."""
    target, draft = bigram(1), bigram(2)
    ids = torch.tensor([[60, 61, 62, 3, 4], [70, 71, 72, 73, 74], [100, 90, 80, 66, 99]])
    k, new = 4, 11
    out, acceptance = speculative_generate(target, draft, ids, new, k=k)
    np.testing.assert_array_equal(out.numpy(), generate(target, ids, new).numpy())
    np.testing.assert_array_equal(out[0, 5:].numpy(), np.arange(5, 16))
    # Row 0 accepts k of k every round, rows 1 and 2 none: a third overall.
    assert acceptance == pytest.approx(1 / 3)


@nnx.jit
def jax_next_distribution(model, ids):
    """(the greedy token after `ids` [1, T], softmax(warp(logits)) one step
    past it), through a cache; jitted (eager JAX compiles every op)."""
    T = ids.shape[1]
    cache = jax_init_kv_cache(model.config, 1, T + 1)
    logits, cache = model(ids, cache, 0)
    first = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    step, _ = model(first, cache, T)
    return first[0, 0], jax.nn.softmax(jax_make_logits_warp(temperature=1.0)(step[0, -1]))


def test_sampling_matches_target_distribution(vocab64_target):
    """One rejection-sampling round over 4096 identical rows: the first
    emitted token's empirical distribution against JAX's exact target p and
    draft q at that position (JAX's model and warp on the same weights)."""
    n, T, k = 4096, 4, 2
    jt, pt = vocab64_target
    jd, pd = pair(dict(TARGET, num_hidden_layers=1, vocab_size=64), 9)
    ids = np.broadcast_to(np.random.RandomState(0).randint(0, 64, (1, T)).astype(np.int32), (n, T))

    # JAX's exact p and q one step past the deterministic continuation `first`.
    (jax_first, p), (_, q) = (jax_next_distribution(jm, jnp.asarray(ids[:1])) for jm in (jt, jd))

    cache_len = T + 2 * (k + 1)
    t_cache, d_cache = make_cache(pt, n, cache_len), make_cache(pd, n, cache_len)
    port_ids = torch.from_numpy(np.ascontiguousarray(ids)).long()
    logits, t_cache = prefill(pt, port_ids, t_cache)
    _, d_cache = prefill(pd, port_ids, d_cache)
    first = greedy(logits[:, -1])[:, None]
    assert int(first[0, 0]) == int(jax_first)
    spec = make_speculative_sample_decode_fn(pt, pd, 1, k, make_logits_warp(temperature=1.0))
    blocks, counts, _, _, pos = spec(first, t_cache, d_cache, T, torch.Generator().manual_seed(3))
    assert blocks.shape == (n, 1, k + 1) and counts.shape == (n, 1)
    np.testing.assert_array_equal(pos.numpy(), T + counts[:, 0].numpy())
    emp = np.bincount(blocks[:, 0, 0].numpy(), minlength=64) / n

    l1_p, l1_q = np.abs(emp - p).sum(), np.abs(emp - q).sum()
    assert 0.5 * np.abs(p - q).sum() > 0.2, "the test needs target and draft to disagree"
    assert l1_p < 0.15, f"empirical distribution far from the target's p (L1 {l1_p:.3f})"
    assert l1_p < l1_q - 0.1, f"fits the draft's q as well as the target's p ({l1_p:.3f} vs {l1_q:.3f})"


def test_sampling_self_draft_near_full_acceptance(target):
    pt = target[1]
    ids = torch.from_numpy(prompt(seed=6))
    out, acceptance = speculative_generate(
        pt, pt, ids, 16, k=4, temperature=1.0, generator=torch.Generator().manual_seed(1)
    )
    assert out.shape == (1, ids.shape[1] + 16)
    assert acceptance > 0.9
    assert bool(((out >= 0) & (out < V)).all())


def test_sampling_quantized_pair_reproducible(target):
    """A qint4 draft (lm_head excluded) at temperature 0.8, top-k 20, top-p
    0.95: ids in the vocabulary, acceptance in [0, 1], the prompt kept, and
    equal tokens from equal seeds."""
    _, draft = pair(DRAFT, 5)
    qtt.quantize(draft, weights="qint4", exclude="lm_head")
    qtt.freeze(draft)
    ids = torch.from_numpy(prompt(batch=2, seed=8))
    gen = SpeculativeGenerator(target[1], draft, 3, temperature=0.8, top_k=20, top_p=0.95)
    runs = [gen.generate(ids, 12, generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    (out, acceptance), (again, _) = runs
    assert out.shape == (2, ids.shape[1] + 12)
    assert 0.0 <= acceptance <= 1.0
    assert bool(((out >= 0) & (out < V)).all())
    np.testing.assert_array_equal(out[:, : ids.shape[1]].numpy(), ids.numpy())
    np.testing.assert_array_equal(out.numpy(), again.numpy())
    # No generator: seeded with 0, as JAX starts from PRNGKey(0).
    default, _ = gen.generate(ids, 12)
    np.testing.assert_array_equal(default.numpy(), out.numpy())


def prefilled(model, ids: np.ndarray, new: int):
    cache = init_kv_cache(model.config, ids.shape[0], ids.shape[1] + new, device="cpu")
    logits, cache = prefill(model, torch.from_numpy(ids).long(), cache, last_only=True)
    return greedy(logits[:, -1])[:, None], cache


def test_decode_greedy_sample_fn_matches_jax_decode_fn(target):
    jm, pm = target
    ids, new = prompt(batch=2, seed=5), 8
    first, cache = prefilled(pm, ids, new)
    got, _ = decode(pm, first, cache, ids.shape[1], new, sample_fn=greedy)
    graphdef, state = nnx.split(jm)
    jcache = jax_init_kv_cache(jm.config, 2, ids.shape[1] + new)
    jlogits, jcache = jax_make_prefill_fn(graphdef, last_only=True)(state, jnp.asarray(ids), jcache, 0)
    jfirst = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    want, _ = jax_make_decode_fn(graphdef, new)(state, jfirst, jcache, ids.shape[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_sampler_seeded_and_pos0_moves_draws(target):
    pm = target[1]
    ids, new = prompt(batch=2, seed=5), 6
    T = ids.shape[1]
    sampler = make_sampler(0.8, 50, 0.95)

    def run(pos0, sample_fn=sampler, generator=None):
        first, cache = prefilled(pm, ids, new + 1)
        return decode(pm, first, cache, pos0, new, sample_fn=sample_fn, generator=generator)[0]

    a = run(T, generator=torch.Generator().manual_seed(4))
    b = run(T, generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert bool(((a >= 0) & (a < V)).all())
    # Without a generator the draws depend on the sum of pos0 only: a sampler
    # that returns the generator's draws shows it, whatever the logits.
    draws = lambda logits, g: torch.randint(0, V, logits.shape[:-1], generator=g)  # noqa: E731
    at_t = run(T, draws)
    np.testing.assert_array_equal(at_t.numpy(), run(T, draws).numpy())
    np.testing.assert_array_equal(at_t.numpy(), run(torch.tensor([T - 1, 1]), draws).numpy())
    assert not np.array_equal(at_t.numpy(), run(T + 1, draws).numpy())
    # Greedy needs no generator and gives the target's tokens.
    np.testing.assert_array_equal(run(T, greedy).numpy(), generate(pm, torch.from_numpy(ids).long(), new + 1)[:, T + 1 :].numpy())


def test_exports_match_jax():
    import quanto_tpu.models as jax_models
    from quanto_tpu.models import speculative as jax_speculative

    names = {*jax_speculative.__all__, "layerskip_draft"}
    assert set(speculative.__all__) == names
    for name in names:
        assert getattr(port_models, name) is getattr(speculative, name)
    for name in jax_speculative.__all__:
        assert hasattr(jax_models, name)
    assert dataclasses.is_dataclass(LlamaConfig)
