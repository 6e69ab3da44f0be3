"""The plain version of the port's flash-decode kernel against quanto_tpu.

- (b) `flash_decode_plain` against the three TPU kernels run in interpret
  mode, as `tests/ops/test_flash_decode.py` runs them: `flash_decode_call`,
  `flash_decode2_call` and `flash_decode3_call` (the last with sb = 128 at
  S = 512, so its online softmax walks 4 chunks), over float and int8 caches,
  D = 64, 128 and 256 (Gemma's heads: G = 1 as Gemma-7B, 8 as Gemma-2B),
  G = 3 and 4, ragged positions. Tolerance 2e-5 (rtol and
  atol), JAX's own for these kernels: both sides are float32, and the port
  normalises the softmax at the end where v1/v2 normalise before the PV dot.
- (c) `flash_decode_plain` (through `decode_attention`, as the model calls it)
  and the extended `gqa_attention` against JAX's `gqa_attention` over the
  caches the JAX dispatch sends there: int4, k8v4, k4v8, qint4a, k8v4a and
  fp8, written by JAX's `kv_update` and bridged with `qkv_layer_from_numpy`.
  Tolerance 2e-5 * max|ref| + 1e-6: float32 on both sides, sums in another
  order.
- Slots past a row's position never change the output (bit for bit), and a
  row at position 0 returns slot 0's value row (within 1e-6, float32).
- Gemma-2's extras: `flash_decode_plain` with a softcap, a query scale and a
  sliding window against JAX's `gqa_attention` with the window's mask
  (1e-5 * max|ref|, float32), slots outside the window ignored bit for bit;
  the ring arm of `decode_attention` (the post-write ring, positions
  clamped to W - 1) against JAX's read-concat over the pre-write ring
  (2e-5 * max|ref| + 1e-6); the paged arm with the three equal to the dense
  call on the gathered view.
- gpt-oss's sinks: `decode_attention(..., sinks=)` at G = 8, D = 64 against
  JAX's `gqa_attention(..., sinks=)` over float, int8, int4 and asymmetric
  int4 caches, with and without a window, and over a ring (2e-5 * max|ref| +
  1e-6); the paged arm with sinks equal to the dense call on the gathered
  view.

The CUDA kernel itself is held against `flash_decode_plain` on the card by
`tests/test_torch_gpu_kernels.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanto_tpu.ops.attention import gqa_attention as jax_gqa_attention
from quanto_tpu.ops.pallas.flash_decode import flash_decode_call
from quanto_tpu.ops.pallas.flash_decode2 import flash_decode2_call
from quanto_tpu.ops.pallas.flash_decode3 import flash_decode3_call
from quanto_tpu.tensor import kv_cache as jkv
from quanto_tpu_torch.models.loading import qkv_layer_from_numpy
from quanto_tpu_torch.ops.attention import decode_attention, gqa_attention
from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain
from quanto_tpu_torch.tensor import kv_cache as tkv

JAX_KERNELS = {
    "v1": lambda *a: flash_decode_call(*a, interpret=True),
    "v2": lambda *a: flash_decode2_call(*a, interpret=True),
    "v3": lambda *a: flash_decode3_call(*a, sb=128, interpret=True),
}


def inputs(B, Hkv, G, S, D, quantized, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Hkv, G, D).astype(np.float32)
    if quantized:
        k = rng.randint(-127, 128, (B, S, Hkv, D)).astype(np.int8)
        v = rng.randint(-127, 128, (B, S, Hkv, D)).astype(np.int8)
        ks = (rng.rand(B, S, Hkv, 1) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.rand(B, S, Hkv, 1) * 0.02 + 0.001).astype(np.float32)
    else:
        k = rng.randn(B, S, Hkv, D).astype(np.float32)
        v = rng.randn(B, S, Hkv, D).astype(np.float32)
        ks = vs = None
    return q, k, v, ks, vs


def port(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("D,G", [(64, 3), (128, 4), (128, 3), (256, 1), (256, 8)],
                         ids=["d64g3", "d128g4", "d128g3", "d256g1", "d256g8"])
@pytest.mark.parametrize("quantized", [True, False], ids=["int8cache", "floatcache"])
@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_plain_matches_tpu_kernels(variant, quantized, D, G):
    S = 512 if variant == "v3" else 256
    Hkv = 2
    q, k, v, ks, vs = inputs(2, Hkv, G, S, D, quantized, seed=D + G)
    pos = np.array([S - 1, 93], np.int32)  # a full and a ragged row
    args = (None if a is None else jnp.asarray(a) for a in (q, k, v, ks, vs, pos))
    ref = JAX_KERNELS[variant](*args)
    assert ref is not None
    out = flash_decode_plain(*port(q, k, v, ks, vs, pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("quantized", [True, False], ids=["int8cache", "floatcache"])
def test_slots_past_pos_are_ignored(quantized):
    q, k, v, ks, vs = inputs(2, 2, 4, 128, 64, quantized, seed=3)
    pos = torch.tensor([40, 0], dtype=torch.int32)
    out1 = flash_decode(*port(q, k, v, ks, vs), pos)
    k2, v2 = k.copy(), v.copy()
    k2[0, 41:], v2[0, 41:] = 100, -100
    k2[1, 1:], v2[1, 1:] = 100, -100
    out2 = flash_decode(*port(q, k2, v2, ks, vs), pos)
    assert torch.equal(out1, out2)
    # pos = 0 sees slot 0 alone: the output is slot 0's value row.
    v0 = torch.from_numpy(v[1, 0]).float() * (torch.from_numpy(vs[1, 0]) if quantized else 1.0)
    torch.testing.assert_close(out1[1], v0[:, None, :].expand(2, 4, 64), rtol=1e-6, atol=1e-6)


def jax_cache(spec, B, S, Hkv, D, seed):
    """A JAX quantized layer filled by kv_update with skewed K and centred V."""
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((B, S, Hkv, D)) * 1.5 + 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    layer = jkv.init_quantized_kv_cache(1, B, S, Hkv, D, spec)[0]
    return jkv.kv_update(layer, jnp.asarray(k), jnp.asarray(v), 0)


def bridge(layer, spec):
    names = ("_k_data", "_k_scale", "_v_data", "_v_scale", "_k_shift", "_v_shift")
    fields = {n: np.asarray(getattr(layer, n)) for n in names if getattr(layer, n) is not None}
    return qkv_layer_from_numpy(fields, spec)


def near(out: torch.Tensor, ref) -> None:
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= 2e-5 * np.max(np.abs(ref)) + 1e-6


SPECS = ["qint4", "k8v4", "k4v8", "qint4a", "k8v4a", "qfloat8_e4m3fn", "qfloat8_e5m2"]


@pytest.mark.parametrize("spec", SPECS)
def test_decode_matches_jax_gqa_attention(spec):
    """T == 1: JAX's einsum path (where its dispatch sends these caches) vs
    the port's decode dispatch (flash_decode_plain on the CPU) and its
    gqa_attention."""
    B, S, Hkv, G, D = 2, 40, 2, 4, 64
    layer = jax_cache(spec, B, S, Hkv, D, seed=len(spec))
    pos = np.array([39, 17], np.int32)
    q = np.random.default_rng(1).standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    mask = np.where(np.arange(S)[None, :] <= pos[:, None], 0.0, np.finfo(np.float32).min)
    mask = mask[:, None, None, :].astype(np.float32)  # [B, 1, T, S]
    k, v, ks, vs, km, vm = jkv.kv_read_raw(layer, jnp.float32)
    ref = jax_gqa_attention(
        jnp.asarray(q).reshape(B, 1, Hkv, G, D), k, v, jnp.asarray(mask), D**-0.5,
        k_scale=ks, v_scale=vs, k_shift=km, v_shift=vm,
    )
    tc = bridge(layer, spec)
    out = decode_attention(torch.from_numpy(q), tc, torch.from_numpy(pos))
    near(out, ref)
    tk, tv, tks, tvs, tkm, tvm = tkv.kv_read_raw(tc, torch.float32)
    out = gqa_attention(
        torch.from_numpy(q).view(B, 1, Hkv, G, D), tk, tv, torch.from_numpy(mask), D**-0.5,
        k_scale=tks, v_scale=tvs, k_shift=tkm, v_shift=tvm,
    )
    near(out, ref)


@pytest.mark.parametrize("spec", ["qint4a", "k8v4", "qfloat8_e4m3fn"])
def test_prefill_gqa_attention_matches_jax(spec):
    """T > 1 over the cache readback (the prefill path), causal per row."""
    B, S, Hkv, G, D, T = 2, 24, 2, 2, 64, 6
    layer = jax_cache(spec, B, S, Hkv, D, seed=7)
    qpos = np.arange(T)[None, :] + np.array([[3], [18]])
    q = np.random.default_rng(2).standard_normal((B, T, Hkv, G, D)).astype(np.float32)
    mask = np.where(np.arange(S)[None, None, :] <= qpos[:, :, None], 0.0, np.finfo(np.float32).min)
    mask = mask[:, None].astype(np.float32)  # [B, 1, T, S]
    k, v, ks, vs, km, vm = jkv.kv_read_raw(layer, jnp.float32)
    ref = jax_gqa_attention(
        jnp.asarray(q), k, v, jnp.asarray(mask), D**-0.5,
        k_scale=ks, v_scale=vs, k_shift=km, v_shift=vm,
    )
    tk, tv, tks, tvs, tkm, tvm = tkv.kv_read_raw(bridge(layer, spec), torch.float32)
    out = gqa_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(mask), D**-0.5,
        k_scale=tks, v_scale=tvs, k_shift=tkm, v_shift=tvm,
    )
    near(out, ref)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, ks, vs = port(*inputs(1, 2, 4, 16, 64, True, seed=0))
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        flash_decode(q, k, v, None, None, pos)  # codes without scales
    with pytest.raises(ValueError):
        flash_decode(q[..., :32].contiguous(), k[..., :32], v[..., :32], ks, vs, pos)  # D = 32
    with pytest.raises(TypeError):
        flash_decode(q, k.float(), v, ks, vs, pos)  # float K with int8 V


# Gemma-2's extras: the query scale, the softcap and the sliding window.
TRANSFORMS = [
    dict(softcap=50.0),
    dict(scale=144**-0.5, softcap=50.0, window=16),
    dict(scale=0.3, window=1),
    dict(window=64),
]


@pytest.mark.parametrize("tf", TRANSFORMS, ids=["softcap", "gemma2-sliding", "scale-w1", "wide-window"])
@pytest.mark.parametrize("D,G", [(64, 3), (128, 2), (256, 2)], ids=["d64g3", "d128g2", "d256g2"])
def test_plain_transforms_match_jax_gqa_attention(tf, D, G):
    """`flash_decode_plain` with softcap, scale and window against JAX's
    `gqa_attention` with the mask a window gives (q - w < s <= q), float32,
    within 1e-5 * max|ref|; the logits are scaled up (x 8) so that the cap bites."""
    B, Hkv, S = 3, 2, 48
    q, k, v, _, _ = inputs(B, Hkv, G, S, D, False, seed=D + G)
    q = q * 8
    pos = np.array([47, 20, 3], np.int32)
    s = np.arange(S)[None, :]
    ok = s <= pos[:, None]
    if tf.get("window"):
        ok &= s > pos[:, None] - tf["window"]
    mask = np.where(ok, 0.0, np.finfo(np.float32).min)[:, None, None, :].astype(np.float32)
    scale = tf.get("scale", D**-0.5)
    ref = np.asarray(jax_gqa_attention(
        jnp.asarray(q).reshape(B, 1, Hkv, G, D), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), scale,
        softcap=tf.get("softcap"),
    )).reshape(B, Hkv, G, D)
    out = flash_decode(*port(q, k, v), None, None, torch.from_numpy(pos), **tf)
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))
    # Slots outside a row's window never change its output.
    if tf.get("window"):
        k2, v2 = k.copy(), v.copy()
        k2[~ok], v2[~ok] = 100, -100
        assert torch.equal(flash_decode(*port(q, k2, v2), None, None, torch.from_numpy(pos), **tf), out)


@pytest.mark.parametrize("spec", [None, "qint4"], ids=["float", "qint4"])
def test_ring_decode_matches_jax_read_concat(spec):
    """A decode step over a W = 16 ring, one row before it wraps (position 9)
    and one after (position 40): `decode_attention(ring=True)` over the
    post-write ring against JAX's pre-write ring joined with the new key
    under `ring_mask`, softcap 50 and scale 144**-0.5."""
    from quanto_tpu.models import sliding as jsl

    B, Wr, Hkv, G, D = 2, 16, 2, 2, 128
    rng = np.random.default_rng(11)
    k0, v0 = (rng.standard_normal((B, Wr, Hkv, D)).astype(np.float32) for _ in range(2))
    knew, vnew = (rng.standard_normal((B, 1, Hkv, D)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32) * 8
    pos = np.array([9, 40], np.int32)
    jring = (jnp.asarray(k0), jnp.asarray(v0)) if spec is None else jkv.kv_update(
        jkv.init_quantized_kv_cache(1, B, Wr, Hkv, D, spec)[0], jnp.asarray(k0), jnp.asarray(v0), 0)
    kc, vc, ks, vs, km, vm, _ = jsl.ring_attention_inputs(jring, jnp.asarray(knew), jnp.asarray(vnew),
                                                          jnp.asarray(pos), None, jnp.float32, B)
    neg = float(np.finfo(np.float32).min)
    mask = jsl.ring_mask(jnp.asarray(pos)[:, None], jnp.asarray(pos)[:, None, None, None], jnp.asarray(pos), Wr, B,
                         neg)
    ref = jax_gqa_attention(jnp.asarray(q).reshape(B, 1, Hkv, G, D), kc, vc, mask, 144**-0.5, k_scale=ks,
                            v_scale=vs, softcap=50.0)
    ring = port(k0, v0) if spec is None else bridge(jring, spec)
    tkv.kv_ring_update(ring, torch.from_numpy(knew), torch.from_numpy(vnew), torch.from_numpy(pos))
    out = decode_attention(torch.from_numpy(q), ring, torch.from_numpy(pos), scale=144**-0.5, softcap=50.0,
                           ring=True)
    near(out, ref)


def test_paged_window_equals_dense_window():
    """The paged arm's plain version with softcap, scale and window equals the
    dense call on the gathered view."""
    from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode_paged
    from quanto_tpu_torch.tensor.paged_kv import gather_pages

    rng = np.random.default_rng(12)
    B, Hkv, G, D, ps, P = 2, 2, 2, 64, 4, 6
    pages = [torch.from_numpy(rng.standard_normal((13, ps, Hkv, D)).astype(np.float32)) for _ in range(2)]
    table = torch.from_numpy(rng.permutation(np.arange(1, 13))[: B * P].reshape(B, P).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((B, Hkv, G, D)).astype(np.float32))
    pos = torch.tensor([22, 9], dtype=torch.int32)
    tf = dict(scale=0.2, softcap=50.0, window=8)
    out = flash_decode_paged(q, *pages, None, None, table, pos, **tf)
    want = flash_decode(q, gather_pages(pages[0], table), gather_pages(pages[1], table), None, None, pos, **tf)
    assert torch.equal(out, want)


def test_wrapper_rejects_bad_transforms():
    q, k, v, _, _ = port(*inputs(1, 2, 4, 16, 64, False, seed=0))
    pos = torch.zeros(1, dtype=torch.int32)
    for bad in (dict(scale=0.0), dict(softcap=-1.0), dict(window=0), dict(window=2.5)):
        with pytest.raises(ValueError):
            flash_decode(q, k, v, None, None, pos, **bad)


# gpt-oss's attention sinks: one logit per query head joins every softmax without a value.
SINK_CACHES = [None, "qint8", "qint4", "qint4a"]


@pytest.mark.parametrize("window", [None, 16], ids=["full", "window16"])
@pytest.mark.parametrize("spec", SINK_CACHES, ids=["float", "qint8", "qint4", "qint4a"])
def test_sinks_match_jax_gqa_attention(spec, window):
    """`decode_attention(..., sinks=)` (flash_decode_plain on the CPU) at
    gpt-oss's G = 8, D = 64 against JAX's `gqa_attention(..., sinks=)` with
    the mask of the row's visible slots (a window's too), within 2e-5 *
    max|ref| + 1e-6 (`near`); rows at positions 39, 17 and 0, sinks from -4
    to 4 about the logits' scale, so that some rows are mostly sink."""
    B, S, Hkv, G, D = 3, 40, 2, 8, 64
    rng = np.random.default_rng(31)
    pos = np.array([39, 17, 0], np.int32)
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32) * 2
    sinks = rng.uniform(-4.0, 4.0, Hkv * G).astype(np.float32)
    if spec is None:
        k = (rng.standard_normal((B, S, Hkv, D)) * 1.5 + 0.3).astype(np.float32)
        v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
        jk, jv, ks, vs, km, vm = jnp.asarray(k), jnp.asarray(v), None, None, None, None
        cache = port(k, v)
    else:
        layer = jax_cache(spec, B, S, Hkv, D, seed=len(spec) + 30)
        jk, jv, ks, vs, km, vm = jkv.kv_read_raw(layer, jnp.float32)
        cache = bridge(layer, spec)
    s = np.arange(S)[None, :]
    ok = s <= pos[:, None]
    if window:
        ok &= s > pos[:, None] - window
    mask = np.where(ok, 0.0, np.finfo(np.float32).min)[:, None, None, :].astype(np.float32)
    ref = jax_gqa_attention(
        jnp.asarray(q).reshape(B, 1, Hkv, G, D), jk, jv, jnp.asarray(mask), D**-0.5,
        k_scale=ks, v_scale=vs, k_shift=km, v_shift=vm, sinks=jnp.asarray(sinks),
    )
    out = decode_attention(torch.from_numpy(q), cache, torch.from_numpy(pos), window=window,
                           sinks=torch.from_numpy(sinks))
    near(out, ref)
    # The sinks move every row: without them the same call is another function.
    assert not torch.allclose(out, decode_attention(torch.from_numpy(q), cache, torch.from_numpy(pos), window=window))


@pytest.mark.parametrize("spec", [None, "qint8"], ids=["float", "qint8"])
def test_ring_decode_with_sinks_matches_jax_read_concat(spec):
    """A decode step over a W = 16 ring with sinks at G = 8, D = 64, one row
    before it wraps (position 9) and one after (position 40): the post-write
    ring against JAX's pre-write ring joined with the new key under
    `ring_mask` (2e-5 * max|ref| + 1e-6)."""
    from quanto_tpu.models import sliding as jsl

    B, Wr, Hkv, G, D = 2, 16, 2, 8, 64
    rng = np.random.default_rng(13)
    k0, v0 = (rng.standard_normal((B, Wr, Hkv, D)).astype(np.float32) for _ in range(2))
    knew, vnew = (rng.standard_normal((B, 1, Hkv, D)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32) * 2
    sinks = rng.uniform(-2.0, 2.0, Hkv * G).astype(np.float32)
    pos = np.array([9, 40], np.int32)
    jring = (jnp.asarray(k0), jnp.asarray(v0)) if spec is None else jkv.kv_update(
        jkv.init_quantized_kv_cache(1, B, Wr, Hkv, D, spec)[0], jnp.asarray(k0), jnp.asarray(v0), 0)
    kc, vc, ks, vs, km, vm, _ = jsl.ring_attention_inputs(jring, jnp.asarray(knew), jnp.asarray(vnew),
                                                          jnp.asarray(pos), None, jnp.float32, B)
    neg = float(np.finfo(np.float32).min)
    mask = jsl.ring_mask(jnp.asarray(pos)[:, None], jnp.asarray(pos)[:, None, None, None], jnp.asarray(pos), Wr, B,
                         neg)
    ref = jax_gqa_attention(jnp.asarray(q).reshape(B, 1, Hkv, G, D), kc, vc, mask, D**-0.5, k_scale=ks,
                            v_scale=vs, sinks=jnp.asarray(sinks))
    ring = port(k0, v0) if spec is None else bridge(jring, spec)
    tkv.kv_ring_update(ring, torch.from_numpy(knew), torch.from_numpy(vnew), torch.from_numpy(pos))
    out = decode_attention(torch.from_numpy(q), ring, torch.from_numpy(pos), ring=True,
                           sinks=torch.from_numpy(sinks))
    near(out, ref)


def test_paged_sinks_equal_dense_sinks():
    """The paged arm's plain version with sinks and a window equals the
    dense call on the gathered view, bit for bit."""
    from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode_paged
    from quanto_tpu_torch.tensor.paged_kv import gather_pages

    rng = np.random.default_rng(14)
    B, Hkv, G, D, ps, P = 2, 2, 8, 64, 4, 6
    pages = [torch.from_numpy(rng.standard_normal((13, ps, Hkv, D)).astype(np.float32)) for _ in range(2)]
    table = torch.from_numpy(rng.permutation(np.arange(1, 13))[: B * P].reshape(B, P).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((B, Hkv, G, D)).astype(np.float32))
    pos = torch.tensor([22, 9], dtype=torch.int32)
    tf = dict(window=8, sinks=torch.from_numpy(rng.uniform(-2.0, 2.0, Hkv * G).astype(np.float32)))
    out = flash_decode_paged(q, *pages, None, None, table, pos, **tf)
    want = flash_decode(q, gather_pages(pages[0], table), gather_pages(pages[1], table), None, None, pos, **tf)
    assert torch.equal(out, want)


def test_wrapper_rejects_bad_sinks():
    q, k, v, _, _ = port(*inputs(1, 2, 4, 16, 64, False, seed=0))
    pos = torch.zeros(1, dtype=torch.int32)
    for bad in (torch.zeros(8, dtype=torch.float64), torch.zeros(4), torch.zeros(2, 4)):
        with pytest.raises(ValueError):
            flash_decode(q, k, v, None, None, pos, sinks=bad)
