"""The port's paged KV cache and `PagedEngine` against quanto_tpu.

- Cache: the same K/V (numpy, from a seed) written by JAX's `paged_update`
  and the port's through a shuffled page table, a 5-token prefill at
  position 0 and then one token at per-row positions; `paged_read_raw`'s
  gathered codes (int4 unpacked; fp8 by their bytes) and scales are bit for
  bit JAX's. Asymmetric specs: the per-slot mean is float32 summed in
  another order by torch and jnp (up to a few ulp), so shifts are held within
  1e-6 * max|shift| + 1e-7 and the dequantized values within one step, as
  `tests/test_torch_kv_cache.py` holds the dense cache.
- Plain kernel: `flash_decode_paged` on a CPU tensor (its plain version)
  equals `flash_decode` on the pages gathered through the table, bit for bit.
- Model: a tiny Llama's cached prefill logits and one decode step over a
  paged cache (a shuffled table) against the same over a dense cache, for
  every spec, within 1e-4 * max|ref|; and against JAX's model over its paged
  cache (jitted) for the float cache within 1e-4 (float32 sums in another
  order) and the asymmetric qint4a one within 2e-3: under jit XLA's CPU code
  contracts the quantizer's arithmetic into fmas, and the per-slot mean
  differs in its last bit, so a K/V code can move by one step
  (`tests/test_torch_llama.py` holds its asymmetric specs so).
- Engine: each scenario of JAX's own `PagedEngine` tests
  (`tests/models/test_paged_kv.py:55-140`, `tests/models/test_serving.py:119-318`)
  is one function over the public API; it runs once with each package's
  engine, and the greedy tokens of every request and the counters
  (`prefix_hits`, `prefix_tokens_saved`, `preemptions`) must be equal. The
  pools are sized so that scenarios share engine shapes (jax.jit compiles
  each JAX engine's programs anew): page size 4 but where JAX's tests take 8
  for the small pool of page reuse and exhaustion, 5 pages where a request
  must exhaust the pool, 9 where two sequences of 21 tokens must preempt.
  The model and the pool of JAX engines are `tests/test_torch_serving.py`'s
  (a qint8 model: the port's decode attention takes head dims 64 and 128).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from quanto_tpu.models.serving import BatchedEngine as JaxBatchedEngine
from quanto_tpu.models.serving import PagedEngine as JaxPagedEngine
from quanto_tpu.tensor import paged_kv as jpk
from quanto_tpu_torch.models.llama import init_kv_cache
from quanto_tpu_torch.models.serving import BatchedEngine, PagedEngine
from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_paged
from quanto_tpu_torch.tensor import kv_cache as tkv
from quanto_tpu_torch.tensor import paged_kv as tpk

from .test_torch_kv_cache import codes_np, jax_codes_np
from .test_torch_serving import serving_models

SPECS = [None, "qint8", "qint4", "k8v4", "qint4a"]
SPEC_IDS = ["float", "qint8", "qint4", "k8v4", "qint4a"]
H, D = 2, 64
PS, P, SLOTS = 4, 4, 3  # pages of 4 slots, 4 a row (16 slots), 3 table rows
N_PAGES = 1 + SLOTS * P


def shuffled_table(seed: int) -> np.ndarray:
    """Table rows of distinct pages 1..N_PAGES-1 in a random order."""
    return np.random.default_rng(seed).permutation(np.arange(1, N_PAGES)).reshape(SLOTS, P).astype(np.int32)


def with_table(layer, table: np.ndarray, port: bool):
    if port:
        layer._table.copy_(torch.from_numpy(table))
        return layer
    return dataclasses.replace(layer, _table=jnp.asarray(table))


def write_both(spec):
    """(jax layer, port layer) after the same two writes through a shuffled table."""
    rng = np.random.default_rng(sum(map(ord, spec or "float")))
    table = shuffled_table(1)
    jl = with_table(jpk.init_paged_kv_cache(1, N_PAGES, PS, SLOTS, P, H, D, spec, jnp.float32)[0], table, False)
    tl = with_table(tpk.init_paged_kv_cache(1, N_PAGES, PS, SLOTS, P, H, D, spec, torch.float32, "cpu")[0],
                    table, True)
    for T, pos in ((5, 0), (1, np.array([5, 9, 14], np.int32))):
        k = rng.standard_normal((SLOTS, T, H, D)).astype(np.float32) * 2.0 + 0.5
        v = rng.standard_normal((SLOTS, T, H, D)).astype(np.float32)
        jl = jpk.paged_update(jl, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        out = tpk.paged_update(tl, torch.from_numpy(k), torch.from_numpy(v), torch.as_tensor(pos))
        assert out is tl  # in place
    return jl, tl


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_paged_cache_matches_jax(spec):
    jl, tl = write_both(spec)
    assert tpk.paged_max_len(tl) == jpk.paged_max_len(jl) == P * PS
    assert tkv.cache_max_len(tl) == P * PS
    jr = jpk.paged_read_raw(jl, SLOTS, jnp.float32)
    tr = tkv.kv_read_raw(tl, torch.float32, SLOTS)
    graw = tpk.paged_gather(tl, SLOTS)
    assert graw[0].dtype == tl._k_pages.dtype and graw[0].shape[:2] == (SLOTS, P * PS)
    if spec is None:
        for i in range(2):
            np.testing.assert_array_equal(tr[i].numpy(), np.asarray(jr[i]))
        assert tr[2:] == (None,) * 4
        return
    if not spec.endswith("a"):
        # The pages (int4 unpacked), the gathered codes and the scales bit for bit.
        for name in ("_k_pages", "_v_pages"):
            np.testing.assert_array_equal(codes_np(getattr(tl, name)), jax_codes_np(getattr(jl, name)))
        for i in range(4):
            np.testing.assert_array_equal(tr[i].numpy().view(np.uint32), np.asarray(jr[i]).view(np.uint32))
        assert tr[4] is None and tr[5] is None
        return
    for i in (4, 5):
        js, ts = np.asarray(jr[i]), tr[i].numpy()
        assert np.max(np.abs(ts - js)) <= 1e-6 * np.max(np.abs(js)) + 1e-7
        deq_t = tr[i - 4].numpy() * tr[i - 2].numpy() + ts
        deq_j = np.asarray(jr[i - 4]) * np.asarray(jr[i - 2]) + js
        assert np.all(np.abs(deq_t - deq_j) <= tr[i - 2].numpy() + 1e-6)


def test_slot_view_writes_through_the_table():
    """A write through `slot_view` lands in the pages of that table row and
    nowhere else; the view's table is a view of the shared row."""
    layer = tpk.init_paged_kv_cache(2, N_PAGES, PS, SLOTS, P, H, D, "qint8", device="cpu")
    table = shuffled_table(2)
    layer[0]._table.copy_(torch.from_numpy(table))
    assert layer[1]._table is layer[0]._table
    before = layer[0]._k_pages.clone()
    view = tkv.slot_view(layer[0], 1)
    assert view._table.data_ptr() == layer[0]._table[1].data_ptr()
    k = torch.randn(1, 6, H, D)
    tkv.kv_update(view, k, k, 2)
    changed = (layer[0]._k_pages != before).any(-1).any(-1)  # [n_pages, ps]
    want = torch.zeros_like(changed)
    for s in range(2, 8):
        want[table[1, s // PS], s % PS] = True
    assert torch.equal(changed, want)


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32], ids=["bf16_q", "f32_q"])
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_paged_plain_equals_gather_then_dense(spec, q_dtype):
    g = torch.Generator().manual_seed(5)
    layer = tpk.init_paged_kv_cache(1, N_PAGES, PS, SLOTS, P, H, 128, spec, torch.bfloat16, "cpu")[0]
    layer._table.copy_(torch.from_numpy(shuffled_table(3)))
    k = torch.randn((SLOTS, P * PS, H, 128), generator=g) * 2 + 0.5
    tpk.paged_update(layer, k, torch.randn(k.shape, generator=g), 0)
    q = torch.randn((SLOTS, H, 3, 128), generator=g).to(q_dtype)
    pos = torch.tensor([15, 0, 9], dtype=torch.int32)
    c = layer
    out = flash_decode_paged(q, c._k_pages, c._v_pages, c._k_scale, c._v_scale, c._table, pos,
                             k_shift=c._k_shift, v_shift=c._v_shift)
    kg, vg, ks, vs, km, vm = tpk.paged_gather(layer, SLOTS)
    ref = flash_decode(q, kg, vg, ks, vs, pos, k_shift=km, v_shift=vm)
    assert out.dtype == q_dtype and torch.equal(out, ref)
    with pytest.raises(ValueError, match="table"):
        flash_decode_paged(q, c._k_pages, c._v_pages, c._k_scale, c._v_scale, c._table[:2], pos,
                           k_shift=c._k_shift, v_shift=c._v_shift)


# --- the model and the engines --------------------------------------------------------------

CFG = dict(
    vocab_size=128, hidden_size=256, intermediate_size=112,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
)
V = CFG["vocab_size"]


@pytest.fixture(scope="module")
def models():
    """(a pool of JAX engines over the JAX model, port model):
    `tests/test_torch_serving.py`'s, built once a process."""
    return serving_models()


@nnx.jit
def _jax_prefill_and_step(model, ids, cache):
    """Prefill of ids[:, :4] at position 0, then a decode step of ids[:, 4:5]
    at 4 (jitted: eager JAX costs seconds here)."""
    logits, cache = model(ids[:, :4], cache, 0)
    step, _ = model(ids[:, 4:5], cache, 4)
    return logits, step


def close(out: torch.Tensor, ref, tol: float) -> None:
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * np.max(np.abs(ref))


def model_steps(model, cache, ids):
    """The port's prefill of ids[:, :4] at 0 and decode step of ids[:, 4:5] at 4."""
    tids = torch.from_numpy(ids)
    with torch.no_grad():
        logits, cache = model(tids[:, :4], cache, 0)
        step, _ = model(tids[:, 4:5], cache, 4)
    return logits, step


def paged_model_cache(spec, port: bool):
    """A 2-layer paged cache of the model's heads behind shuffled table rows."""
    hd = CFG["hidden_size"] // CFG["num_attention_heads"]
    table = shuffled_table(4)
    if not port:
        return tuple(with_table(layer, table, False)
                     for layer in jpk.init_paged_kv_cache(2, N_PAGES, PS, SLOTS, P, 2, hd, spec, jnp.float32))
    cache = tpk.init_paged_kv_cache(2, N_PAGES, PS, SLOTS, P, 2, hd, spec, torch.float32, "cpu")
    cache[0]._table.copy_(torch.from_numpy(table))
    return cache


MODEL_IDS = np.random.RandomState(0).randint(0, CFG["vocab_size"], (2, 6)).astype(np.int32)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_model_over_paged_cache_matches_dense(models, spec):
    """Prefill of 2 x 4 tokens and a decode step at position 4 over a paged
    cache (rows 0 and 1 of a shuffled table) against the same over a dense
    cache, as `tests/models/test_paged_kv.py` holds JAX's."""
    model = models[1]
    logits, step = model_steps(model, paged_model_cache(spec, True), MODEL_IDS)
    d_logits, d_step = model_steps(model, init_kv_cache(model.config, 2, 16, kv_quant=spec, device="cpu"), MODEL_IDS)
    close(logits, d_logits.numpy(), 1e-4)
    close(step, d_step.numpy(), 1e-4)


@pytest.mark.parametrize("spec", [None, "qint4a"], ids=["float", "qint4a"])
def test_model_over_paged_cache_matches_jax(models, spec):
    """The same prefill and step against JAX's model over its paged cache."""
    tol = 1e-4 if spec is None else 2e-3
    j_logits, j_step = _jax_prefill_and_step(models[0].model, jnp.asarray(MODEL_IDS), paged_model_cache(spec, False))
    logits, step = model_steps(models[1], paged_model_cache(spec, True), MODEL_IDS)
    close(logits, j_logits, tol)
    close(step, j_step, tol)


def prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=L).tolist() for L in lengths]


def counters(e) -> tuple:
    return (e.prefix_hits, e.prefix_tokens_saved, e.preemptions)


# --- scenarios: E(**kw) builds a paged engine of one package, R(**kw) its BatchedEngine -------


def matches_batched(E, R):
    ps = [[1, 5, 17], [9, 2, 44, 7], [3, 3]]
    out = []
    for make in (lambda: R(max_batch=4, max_len=32), lambda: E(max_batch=4, max_len=32, n_pages=24, page_size=4)):
        eng = make()
        rids = [eng.add(p, max_new_tokens=6) for p in ps]
        eng.run_to_completion()
        out.append([eng.result(r) for r in rids])
    assert out[0] == out[1]
    return out[1], counters(eng)


def page_reuse(E, R):
    """Dense would need 4 x 32 slots; 2 pages of 8 serve 4 sequential requests."""
    e = E(max_batch=4, max_len=32, n_pages=3, page_size=8)
    out = []
    for i in range(4):
        rid = e.add([1 + i, 5, 9], max_new_tokens=4)
        e.run_to_completion()
        assert e.is_done(rid) and len(e.result(rid)) == 4
        out.append(e.result(rid))
    assert len(e._free_pages) == 2
    return out, counters(e)


def pool_exhaustion(E, R):
    """reserve="full" refuses an over-committed admission; "prompt" admits it."""
    e = E(max_batch=4, max_len=32, n_pages=3, page_size=8, reserve="full")
    r = e.add([1, 2, 3], max_new_tokens=10)  # 2 pages
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        e.add([4, 5, 6], max_new_tokens=10)
    e.run_to_completion()
    out = [e.result(r)]
    e = E(max_batch=4, max_len=32, n_pages=3, page_size=8)
    rids = [e.add([1, 2, 3], max_new_tokens=10), e.add([4, 5, 6], max_new_tokens=10)]
    return out + [e.result(x) for x in rids], counters(e)


def prefix_sharing_exact(E, R):
    base = [7, 1, 9, 2, 8, 3, 6, 4]  # two full pages of 4
    ps = [base + [11], base + [12, 13], base[:4] + [20, 21]]
    out, stats = [], []
    for sharing in (False, True):
        eng = E(max_batch=4, max_len=32, n_pages=24, page_size=4, prefix_sharing=sharing)
        rids = [eng.add(p, max_new_tokens=5) for p in ps]
        eng.run_to_completion()
        out.append([eng.result(r) for r in rids])
        stats.append(counters(eng))
    assert out[0] == out[1]
    assert stats[0][0] == 0
    assert stats[1][:2] == (3, 12)  # request 2 reuses both base pages, request 3 the first
    return out[1], stats[1]


def prefix_resident_and_evictable(E, R):
    base = [5, 6, 7, 8]
    e = E(max_batch=2, max_len=32, n_pages=5, page_size=4)
    r1 = e.add(base + [1], max_new_tokens=2)
    e.run_to_completion()
    assert len(e._prefix_pages) == 1  # registered, out of the free pool
    r2 = e.add(base + [2], max_new_tokens=2)
    e.run_to_completion()
    assert e.prefix_hits == 1
    r3 = e.add([9] * 9, max_new_tokens=7)  # needs every usable page: evicts the base page
    e.run_to_completion()
    assert e.is_done(r3) and np.asarray(base, np.int32).tobytes() not in e._prefix_pages
    return [e.result(r) for r in (r1, r2, r3)], counters(e)


def growth_matches_full_reserve(E, R):
    ps = prompts(11, (5, 9))
    out = []
    for reserve in ("full", "prompt"):
        e = E(max_batch=2, max_len=32, n_pages=17, page_size=4, reserve=reserve)
        rids = [e.add(p, max_new_tokens=7) for p in ps]
        e.run_to_completion(burst=4)
        assert e.preemptions == 0
        out.append([e.result(r) for r in rids])
        stats = counters(e)
    assert out[0] == out[1]
    return out[1], stats


def preemption_recompute(burst):
    def run(E, R):
        """8 usable pages of 4 (32 tokens) for two sequences of 21: the
        youngest is preempted and recomputed, its tokens unchanged."""
        ps = prompts(12 + (burst is not None), (9, 9))
        out = []
        for n_pages in (17, 9):
            e = E(max_batch=2, max_len=32, n_pages=n_pages, page_size=4, prefix_sharing=False)
            rids = [e.add(p, max_new_tokens=12) for p in ps]
            e.run_to_completion(burst=burst)
            assert all(e.is_done(r) for r in rids)
            out.append([e.result(r) for r in rids])
            stats = counters(e)
        assert stats[2] > 0 and out[0] == out[1]
        return out[1], stats

    return run


def single_request_exhaustion(E, R):
    e = E(max_batch=2, max_len=32, n_pages=5, page_size=4, prefix_sharing=False)
    rid = e.add(prompts(14, (9,))[0], max_new_tokens=12)  # needs 6 pages of the 4 usable
    with pytest.raises(RuntimeError, match="page pool exhausted by a single"):
        e.run_to_completion()
    return [e.result(rid)], counters(e)


def chunked_prefill_with_prefix_sharing(E, R):
    rng = np.random.RandomState(3)
    base = rng.randint(0, V, size=9).tolist()
    p1 = base + rng.randint(0, V, size=3).tolist()
    p2 = base + rng.randint(0, V, size=2).tolist()
    e = E(max_batch=2, max_len=32, n_pages=17, page_size=4, prefix_sharing=True, prefill_chunk=4)
    out = []
    for p in (p1, p2):
        rid = e.add(p, max_new_tokens=5)
        e.run_to_completion()
        out.append(e.result(rid))
    assert e.prefix_hits > 0  # the suffix prefill ran its chunks at an offset
    return out, counters(e)


SCENARIOS = {
    "matches_batched": matches_batched,
    "page_reuse": page_reuse,
    "pool_exhaustion": pool_exhaustion,
    "prefix_sharing_exact": prefix_sharing_exact,
    "prefix_resident_and_evictable": prefix_resident_and_evictable,
    "growth_matches_full_reserve": growth_matches_full_reserve,
    "preemption_recompute_stepwise": preemption_recompute(None),
    "preemption_recompute_burst": preemption_recompute(4),
    "single_request_exhaustion": single_request_exhaustion,
    "chunked_prefill_with_prefix_sharing": chunked_prefill_with_prefix_sharing,
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_paged_engine_matches_jax(models, scenario):
    jax_engines, port_model = models
    run = SCENARIOS[scenario]
    want = run(lambda **kw: jax_engines(JaxPagedEngine, **kw), lambda **kw: jax_engines(JaxBatchedEngine, **kw))
    got = run(lambda **kw: PagedEngine(port_model, **kw), lambda **kw: BatchedEngine(port_model, **kw))
    assert got == want


def test_paged_engine_refuses_sliding_windows(models):
    _, port_model = models
    cfg = port_model.config
    port_model.config = dataclasses.replace(cfg)
    object.__setattr__(port_model.config, "sliding_window", 8)
    object.__setattr__(port_model.config, "layer_types", ("sliding_attention", "full_attention"))
    try:
        with pytest.raises(NotImplementedError, match="item 8"):
            PagedEngine(port_model, max_batch=2, max_len=32, n_pages=9, page_size=4)
    finally:
        port_model.config = cfg
