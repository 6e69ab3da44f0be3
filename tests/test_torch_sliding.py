"""The port's sliding-window ring caches (`tensor/kv_cache.py` ring functions,
`models/sliding.py`) against quanto_tpu's.

- `kv_ring_update` writes what JAX's `kv_ring_update` writes, in place, over
  float, qint8 and qint4 rings, at a shared and at per-row positions, with and
  without a `valid` mask of pad columns, chunks up to W: codes, scales and
  float payloads bit for bit (int4 codes through `qkv_layer_from_numpy`).
- A chunk longer than W with pad columns: the port keeps each row's last W
  valid positions, which is what a flat cache holds of the window; JAX's ring
  keeps the chunk's last W columns, pads included (the fault its ROADMAP
  records), so the port is held to the flat-cache construction here, and to
  JAX's flat-cache logits in `tests/test_torch_gemma2.py`.
- `ring_key_positions`, `ring_mask`, `write_valid_mask`, `layer_cache_len`
  and `use_ring` equal JAX's; `ring_attention_inputs` returns JAX's
  concatenation (the pre-write ring, not the ring after the in-place write),
  qint4a's per-slot means within 1e-6 (float32 sums in another order), and
  leaves a float ring as JAX's post-write cache.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanto_tpu.models import sliding as jsl
from quanto_tpu.models.gemma2 import Gemma2Config as JaxGemma2Config
from quanto_tpu.tensor import kv_cache as jkv
from quanto_tpu_torch.models import sliding as tsl
from quanto_tpu_torch.models.gemma2 import Gemma2Config
from quanto_tpu_torch.models.loading import qkv_layer_from_numpy
from quanto_tpu_torch.tensor import kv_cache as tkv
from quanto_tpu_torch.tensor.paged_kv import init_paged_kv_cache

B, W, HKV, D = 2, 8, 2, 16


def jax_ring(spec, seed):
    """A JAX ring [B, W] with every slot written once (random content)."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((B, W, HKV, D)).astype(np.float32) for _ in range(2))
    if spec is None:
        return jnp.asarray(k), jnp.asarray(v)
    layer = jkv.init_quantized_kv_cache(1, B, W, HKV, D, spec)[0]
    return jkv.kv_update(layer, jnp.asarray(k), jnp.asarray(v), 0)


def to_port(layer, spec):
    if spec is None:
        return tuple(torch.from_numpy(np.array(t)) for t in layer)
    fields = {f.name: getattr(layer, f.name) for f in dataclasses.fields(layer) if f.name != "qtype_name"}
    return qkv_layer_from_numpy({k: None if a is None else np.asarray(a) for k, a in fields.items()}, spec)


def same_cache(port, ref, spec) -> None:
    want = to_port(ref, spec)
    if spec is None:
        for p, r in zip(port, want):
            assert torch.equal(p, r)
        return
    for f in dataclasses.fields(want):
        p, r = getattr(port, f.name), getattr(want, f.name)
        if torch.is_tensor(r):
            assert torch.equal(p, r), f.name


def chunk(T, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, T, HKV, D)).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("spec", [None, "qint8", "qint4"], ids=["float", "qint8", "qint4"])
@pytest.mark.parametrize("T,pos,wl", [
    (1, 11, None), (5, 6, None), (8, 3, None), (5, [2, 13], None), (6, [4, 9], [6, 2]), (8, 0, [0, 5]),
], ids=["decode", "wraps", "whole-ring", "per-row", "write_len", "idle-row"])
def test_ring_update_matches_jax(spec, T, pos, wl):
    jring = jax_ring(spec, 1)
    ring = to_port(jring, spec)
    k, v = chunk(T, 2)
    jvalid = None if wl is None else jsl.write_valid_mask(jnp.asarray(wl), T)
    jpos = jnp.asarray(pos, jnp.int32)
    ref = jkv.kv_ring_update(jring, jnp.asarray(k), jnp.asarray(v), jpos, valid=jvalid)
    valid = tsl.write_valid_mask(None if wl is None else torch.tensor(wl), T)
    out = tkv.kv_ring_update(ring, torch.from_numpy(k), torch.from_numpy(v), torch.tensor(pos), valid=valid)
    assert out is ring  # in place
    same_cache(ring, ref, spec)


@pytest.mark.parametrize("spec", [None, "qint4"], ids=["float", "qint4"])
def test_long_chunk_keeps_each_rows_last_valid_positions(spec):
    """T = 2 W + 3 columns at pos0 = 5, rows with 19 and 12 real tokens: each
    row's ring holds the quantized K/V of its last W real positions at slots
    p % W, the slots of no such position untouched."""
    T, pos0, wl = 2 * W + 3, 5, [19, 12]
    jring = jax_ring(spec, 3)
    ring = to_port(jring, spec)
    before = to_port(jring, spec)
    k, v = chunk(T, 4)
    tkv.kv_ring_update(ring, torch.from_numpy(k), torch.from_numpy(v), pos0,
                       valid=tsl.write_valid_mask(torch.tensor(wl), T))
    # What a flat cache of pos0 + T slots holds after the same write.
    flat = to_port(jkv.init_quantized_kv_cache(1, B, pos0 + T, HKV, D, spec)[0], spec) if spec else (
        torch.zeros(B, pos0 + T, HKV, D), torch.zeros(B, pos0 + T, HKV, D))
    tkv.kv_update(flat, torch.from_numpy(k), torch.from_numpy(v), pos0)

    def field_pairs(c):
        return [c] if spec is None else [(c._k_data, c._v_data), (c._k_scale, c._v_scale)]

    for (rk, rv), (fk, fv), (bk, bv) in zip(field_pairs(ring), field_pairs(flat), field_pairs(before)):
        for b in range(B):
            last = pos0 + wl[b] - 1
            for j in range(W):
                p = last - ((last - j) % W)  # the latest position <= last at slot j
                if p >= pos0:
                    assert torch.equal(rk[b, j], fk[b, p]) and torch.equal(rv[b, j], fv[b, p]), (b, j)
                else:
                    assert torch.equal(rk[b, j], bk[b, j]) and torch.equal(rv[b, j], bv[b, j]), (b, j)


def test_ring_positions_masks_and_lengths_match_jax():
    for pos0 in (0, 3, 8, 21, [2, 30]):
        want = np.asarray(jkv.ring_key_positions(jnp.asarray(pos0), W, B))
        got = tkv.ring_key_positions(torch.tensor(pos0), W, B)
        np.testing.assert_array_equal(got.numpy(), want)
        T = 5
        pos = np.broadcast_to(np.asarray(pos0).reshape(-1, 1), (B, 1)) + np.arange(T)[None]
        neg = float(np.finfo(np.float32).min)
        jm = jsl.ring_mask(jnp.asarray(pos), jnp.asarray(pos)[:, None, :, None], jnp.asarray(pos0), W, B, neg)
        tm = tsl.ring_mask(torch.from_numpy(pos), torch.from_numpy(pos)[:, None, :, None], torch.tensor(pos0), W, B,
                           neg)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tsl.write_valid_mask(torch.tensor([3, 0]), 5).numpy(),
                                  np.asarray(jsl.write_valid_mask(jnp.asarray([3, 0]), 5)))
    assert tsl.write_valid_mask(None, 5) is None
    kw = dict(num_hidden_layers=3, num_attention_heads=2, num_key_value_heads=1, head_dim=D, sliding_window=W)
    jc, tc = JaxGemma2Config(**kw), Gemma2Config(**kw)
    assert tc.layer_types == jc.layer_types
    for max_len in (W - 1, W, W + 1, 40):
        for ring in (True, False):
            for i in range(3):
                assert tsl.layer_cache_len(tc, i, max_len, ring) == jsl.layer_cache_len(jc, i, max_len, ring)
    ring_cache = ((torch.zeros(1, W, 1, D),) * 2, (torch.zeros(1, 40, 1, D),) * 2, (torch.zeros(1, W, 1, D),) * 2)
    flat_cache = tuple((torch.zeros(1, 40, 1, D),) * 2 for _ in range(3))
    assert tsl.use_ring(tc, ring_cache) and not tsl.use_ring(tc, flat_cache) and not tsl.use_ring(tc, None)
    paged = init_paged_kv_cache(3, 4, 4, 1, 2, 1, D, device="cpu")
    assert not tsl.use_ring(tc, paged)


@pytest.mark.parametrize("spec", [None, "qint4a"], ids=["float", "qint4a"])
def test_ring_attention_inputs_match_jax(spec):
    jring = jax_ring(spec, 5)
    ring = to_port(jring, spec)
    T, pos, wl = 6, [5, 12], [6, 3]
    k, v = chunk(T, 6)
    want = jsl.ring_attention_inputs(jring, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                     jsl.write_valid_mask(jnp.asarray(wl), T), jnp.float32, B)
    got = tsl.ring_attention_inputs(ring, torch.from_numpy(k), torch.from_numpy(v), torch.tensor(pos),
                                    tsl.write_valid_mask(torch.tensor(wl), T), torch.float32, B)
    for g, w in zip(got, want[:6]):
        assert (g is None) == (w is None)
        if g is not None:  # qint4a's means: float32 sums in another order (codes equal)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    if spec is None:
        same_cache(ring, want[6], spec)
