"""The port's continuous-batching engine and samplers against quanto_tpu.

`quanto_tpu_torch.models.serving.BatchedEngine` against
`quanto_tpu.models.serving.BatchedEngine` on a tiny qint8 Llama (lm_head
float), its float weights carried across by `load_hf_numpy_state_dict`
before both packages quantize and freeze it. The config is the one of
`tests/models/test_serving.py` (vocab 128, 2 layers, 4 heads over 2 KV
heads, intermediate 112) with hidden 256 in place of 64: the port's decode
attention (`flash_decode`) takes head dims 64 and 128, not 16.

Each scenario of JAX's own engine tests for the dense engine is one function
that drives an engine through the public API; it runs once with each
package's engine, and the greedy tokens of every request must be identical.
Scenarios that JAX's tests check against a second run (chunked against
unchunked prefill, burst against stepwise decode, `add_batch` against
serial adds) assert that inside each package too.

The stochastic sampler is held against the port itself (burst against
stepwise, with the engine's seeded generator): `torch.Generator` and
`jax.random` keys give different random numbers, so sampled tokens cannot
match JAX's. `make_logits_warp`, which decides the distribution, is held
against JAX's: values within float32 rounding, -inf masks identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quanto_tpu.models.llama import LlamaForCausalLM as JaxLlama
from quanto_tpu.models.loading import hf_state_dict
from quanto_tpu.models.sampling import make_logits_warp as jax_make_logits_warp
from quanto_tpu.models.serving import BatchedEngine as JaxEngine
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from quanto_tpu_torch.models.loading import load_hf_numpy_state_dict
from quanto_tpu_torch.models.sampling import greedy, make_logits_warp, make_sampler
from quanto_tpu_torch.models.serving import BatchedEngine

CFG = dict(
    vocab_size=128, hidden_size=256, intermediate_size=112,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
)
V = CFG["vocab_size"]


class JaxEngines:
    """JAX engines by constructor arguments, an engine reused once it is
    drained. jax.jit compiles each engine's programs anew (seconds each
    here), and a drained engine is a fresh one but for the order of its free
    slots and its cache's stale entries past each slot's position, which the
    attention mask hides."""

    def __init__(self, model):
        self.model = model
        self.engines = {}

    def __call__(self, **kw):
        pool = self.engines.setdefault(tuple(sorted(kw.items())), [])
        for e in pool:
            if not e._has_work() and len(e._free) == e.max_batch:
                return e
        pool.append(JaxEngine(self.model, **kw))
        return pool[-1]


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model): the same float weights, qint8, lm_head float."""
    jax_model = JaxLlama(JaxLlamaConfig(**CFG, max_position_embeddings=64, dtype=jnp.float32), rngs=nnx.Rngs(0))
    state = {k: np.asarray(v) for k, v in hf_state_dict(jax_model).items()}
    qt.quantize(jax_model, weights="qint8", exclude="lm_head")
    qt.freeze(jax_model)
    port_model = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    assert load_hf_numpy_state_dict(port_model, state) == {"missing": [], "unexpected": []}
    qtt.quantize(port_model, weights="qint8", exclude="lm_head")
    qtt.freeze(port_model)
    return JaxEngines(jax_model), port_model


def prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=L).tolist() for L in lengths]


# --- scenarios: E(**kw) builds an engine of one package over its model ------------


def single_sequence(E):
    ps = prompts(0, (5, 9, 3))
    e = E(max_batch=4, max_len=32)
    rids = [e.add(p, max_new_tokens=6) for p in ps]
    e.run_to_completion()
    assert all(e.is_done(r) for r in rids)
    return [e.result(r) for r in rids]


def slot_recycling(E):
    rng = np.random.RandomState(1)
    e = E(max_batch=2, max_len=32)
    r1 = e.add(rng.randint(0, V, 4).tolist(), max_new_tokens=3)
    r2 = e.add(rng.randint(0, V, 6).tolist(), max_new_tokens=3)
    assert not e.can_add()
    e.run_to_completion()
    assert e.can_add()
    r3 = e.add(rng.randint(0, V, 5).tolist(), max_new_tokens=4)
    e.run_to_completion()
    return [e.result(r) for r in (r1, r2, r3)]


def ragged_midstream_add(E):
    p1, p2 = prompts(2, (7, 4))
    e = E(max_batch=4, max_len=32)
    r1 = e.add(p1, max_new_tokens=5)
    e.step()
    e.step()
    r2 = e.add(p2, max_new_tokens=5)  # joins mid-stream
    e.run_to_completion()
    return [e.result(r1), e.result(r2)]


def quantized_kv(spec):
    def run(E):
        e = E(max_batch=2, max_len=32, kv_quant=spec, prefill_chunk=4)
        rids = [e.add(p, max_new_tokens=6) for p in prompts(3, (6, 9))]
        e.run_to_completion(burst=4)
        return [e.result(r) for r in rids]

    return run


def chunked_matches_unchunked(E):
    ps = prompts(1, (5, 8, 3, 11))
    out = []
    for chunk in (None, 4):
        e = E(max_batch=4, max_len=32, prefill_chunk=chunk)
        rids = [e.add(p, max_new_tokens=6) for p in ps]
        e.run_to_completion()
        out.append([e.result(r) for r in rids])
    assert out[0] == out[1]
    return out


def chunked_near_capacity(E):
    """len 13, chunk 8, max_len 14: the second chunk would pad past the cache,
    so it runs at its own length."""
    (p,) = prompts(2, (13,))
    out = []
    for chunk in (None, 8):
        e = E(max_batch=1, max_len=14, prefill_chunk=chunk)
        rid = e.add(p, max_new_tokens=1)
        e.run_to_completion()
        out.append(e.result(rid))
    assert out[0] == out[1]
    return out


def burst_matches_stepwise(E):
    ps = prompts(4, (5, 9, 3))
    out = []
    for burst in (None, 4):
        e = E(max_batch=4, max_len=32)
        rids = [e.add(p, max_new_tokens=7) for p in ps]  # 7: not a multiple of the burst
        e.run_to_completion(burst=burst)
        out.append([e.result(r) for r in rids])
    assert out[0] == out[1]
    return out


def eos_mid_burst(E):
    ps = prompts(7, (5, 7))  # JAX's seed 6 gives one repeated token on this model
    probe = E(max_batch=2, max_len=32)
    rids = [probe.add(p, max_new_tokens=8) for p in ps]
    probe.run_to_completion()
    seq = probe.result(rids[0])
    # The eos: request 0's first token from its third on that it has not
    # emitted before, so that it finishes inside the burst.
    i = next(i for i in range(2, len(seq)) if seq[i] not in seq[:i])
    out = []
    for burst in (None, 8):
        e = E(max_batch=2, max_len=32, eos_token_id=seq[i])
        rs = [e.add(p, max_new_tokens=8) for p in ps]
        e.run_to_completion(burst=burst)
        assert len(e._free) == 2  # both slots released
        out.append([e.result(r) for r in rs])
    assert out[0] == out[1] and out[0][0] == seq[: i + 1]
    return out


def add_batch_matches_serial(E):
    ps = prompts(8, (5, 11, 3, 8))
    ref = E(max_batch=4, max_len=32, prefill_chunk=4)
    rids = [ref.add(p, max_new_tokens=5) for p in ps]
    ref.run_to_completion()
    e = E(max_batch=4, max_len=32, prefill_chunk=4)
    brids = e.add_batch(ps, max_new_tokens=5)
    assert len(brids) == len(ps)
    e.run_to_completion(burst=4)
    out = [[ref.result(r) for r in rids], [e.result(r) for r in brids]]
    assert out[0] == out[1]
    return out


def add_batch_with_active_decodes(E):
    """Garbage chunk rows of add_batch land at >= the active slot's next
    decode position and do not corrupt its cache."""
    rng = np.random.RandomState(9)
    p_active = rng.randint(0, V, size=6).tolist()
    p_new = [rng.randint(0, V, size=L).tolist() for L in (4, 7)]
    out = []
    for batched in (False, True):
        e = E(max_batch=4, max_len=32, prefill_chunk=4)
        ra = e.add(p_active, max_new_tokens=6)
        e.step()
        e.step()
        rn = e.add_batch(p_new, max_new_tokens=6) if batched else [e.add(p, max_new_tokens=6) for p in p_new]
        e.run_to_completion()
        out.append([e.result(r) for r in (ra, *rn)])
    assert out[0] == out[1]
    return out


def add_batch_overflow(E):
    """More prompts than free slots: the overflow errors as serial add does."""
    e = E(max_batch=4, max_len=32, prefill_chunk=4)
    with pytest.raises(RuntimeError, match="no free slots"):
        e.add_batch(prompts(10, (4,) * 5), max_new_tokens=4)
    return None


def enqueue_matches_reference(E):
    ps = prompts(10, (5, 9, 3, 12))
    e = E(max_batch=4, max_len=32, prefill_chunk=4)
    rids = [e.enqueue(p, max_new_tokens=6) for p in ps]
    e.run_to_completion()
    assert all(e.is_done(r) for r in rids)
    return [e.result(r) for r in rids]


def enqueue_does_not_stall_decode(E):
    """The decoding rows emit a token on every mixed chunk step."""
    rng = np.random.RandomState(11)
    p1, p2 = rng.randint(0, V, 6).tolist(), rng.randint(0, V, 4).tolist()
    p3 = rng.randint(0, V, 12).tolist()  # 3 chunks of 4
    e = E(max_batch=4, max_len=32, prefill_chunk=4)
    r1 = e.add(p1, max_new_tokens=8)
    r2 = e.add(p2, max_new_tokens=8)
    e.step()
    r3 = e.enqueue(p3, max_new_tokens=8)
    before = len(e.result(r1))
    for _ in range(3):
        out = e.serve_step()
        assert r1 in out and r2 in out  # decode rode the chunk forward
    assert len(e.result(r1)) == before + 3
    assert r3 in out  # the last chunk emitted p3's first token
    e.run_to_completion(burst=4)
    return [e.result(r) for r in (r1, r2, r3)]


def enqueue_overflow_waits(E):
    e = E(max_batch=2, max_len=32, prefill_chunk=4)
    rids = [e.enqueue(p, max_new_tokens=4) for p in prompts(12, (5, 7, 4))]
    assert not e.is_done(rids[2])
    e.run_to_completion(burst=4)
    return [e.result(r) for r in rids]


def enqueue_near_capacity_decode_row(E):
    """A decoding row within C of max_len blocks mixed steps: plain decode
    steps until it finishes, then the pending prefill proceeds."""
    rng = np.random.RandomState(13)
    p1, p2 = rng.randint(0, V, 10).tolist(), rng.randint(0, V, 6).tolist()
    e = E(max_batch=2, max_len=16, prefill_chunk=8)
    r1 = e.add(p1, max_new_tokens=5)
    r2 = e.enqueue(p2, max_new_tokens=3)
    assert not e._mixed_ok()
    e.run_to_completion()
    return [e.result(r1), e.result(r2)]


def enqueue_spilling_prompt(E):
    """ceil(13 / 8) * 8 > 14: enqueue prefills at once through add()."""
    (p,) = prompts(14, (13,))
    e = E(max_batch=1, max_len=14, prefill_chunk=8)
    rid = e.enqueue(p, max_new_tokens=1)
    assert len(e.result(rid)) >= 1
    e.run_to_completion()
    return [e.result(rid)]


SCENARIOS = {
    "single_sequence": single_sequence,
    "slot_recycling": slot_recycling,
    "ragged_midstream_add": ragged_midstream_add,
    "quantized_kv_qint8": quantized_kv("qint8"),
    "quantized_kv_qint4": quantized_kv("qint4"),
    "chunked_matches_unchunked": chunked_matches_unchunked,
    "chunked_near_capacity": chunked_near_capacity,
    "burst_matches_stepwise": burst_matches_stepwise,
    "eos_mid_burst": eos_mid_burst,
    "add_batch_matches_serial": add_batch_matches_serial,
    "add_batch_with_active_decodes": add_batch_with_active_decodes,
    "add_batch_overflow": add_batch_overflow,
    "enqueue_matches_reference": enqueue_matches_reference,
    "enqueue_does_not_stall_decode": enqueue_does_not_stall_decode,
    "enqueue_overflow_waits": enqueue_overflow_waits,
    "enqueue_near_capacity_decode_row": enqueue_near_capacity_decode_row,
    "enqueue_spilling_prompt": enqueue_spilling_prompt,
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_matches_jax(models, scenario):
    jax_engines, port_model = models
    run = SCENARIOS[scenario]
    want = run(jax_engines)
    got = run(lambda **kw: BatchedEngine(port_model, **kw))
    assert got == want


def test_burst_matches_stepwise_with_sampler(models):
    """make_sampler(temperature=0.8, top_k=8): a burst draws from the
    engine's generator in step()'s order, so it gives step()'s tokens."""
    _, port_model = models
    (p,) = prompts(5, (6,))
    out = []
    for burst in (None, 4):
        e = BatchedEngine(port_model, max_batch=2, max_len=32, sample_fn=make_sampler(temperature=0.8, top_k=8))
        rid = e.add(p, max_new_tokens=6)
        e.run_to_completion(burst=burst)
        out.append(e.result(rid))
    assert out[0] == out[1] and len(out[0]) == 6


WARPS = [(1.0, None, None), (0.7, 8, None), (1.0, 1, None), (1.0, None, 0.9), (0.8, 5, 0.8), (1.3, None, 0.5)]


@pytest.mark.parametrize("temperature,top_k,top_p", WARPS)
def test_logits_warp_matches_jax(temperature, top_k, top_p):
    logits = (np.random.default_rng(3).standard_normal((4, 3, 64)) * 3).astype(np.float32)
    want = np.asarray(jax_make_logits_warp(temperature, top_k, top_p)(jnp.asarray(logits)))
    got = make_logits_warp(temperature, top_k, top_p)(torch.from_numpy(logits)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=0)
    if top_k is not None:
        assert (keep.sum(-1) >= min(top_k, 1)).all() and (keep.sum(-1) <= top_k).all()


def test_sampler_draws_the_warped_distribution():
    """The draws follow softmax(warp(logits)): frequencies over 20000
    draws within 0.02 of the probabilities, nothing drawn from a masked
    token, and the same generator seed gives the same draws."""
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -1.5]]).expand(20000, 8)
    sample = make_sampler(temperature=0.8, top_k=5)
    draws = sample(logits, torch.Generator().manual_seed(0))
    probs = torch.softmax(make_logits_warp(0.8, 5)(logits[:1]), dim=-1)[0]
    freq = torch.bincount(draws, minlength=8).float() / draws.numel()
    assert (freq[5:] == 0).all()
    assert (freq - probs).abs().max() < 0.02
    assert torch.equal(draws, sample(logits, torch.Generator().manual_seed(0)))
    assert make_sampler(temperature=0.0) is greedy
    assert torch.equal(greedy(logits[:2], torch.Generator()), torch.zeros(2, dtype=torch.long))
