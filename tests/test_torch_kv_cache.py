"""The port's KV caches against quanto_tpu's (`tensor/kv_cache.py`).

The same K/V, made with numpy from a seed, are written by JAX's `kv_update`
and by the port's, first a 5-token prefill at position 0, then one token at a
scalar or a per-row position. Tolerances:
- symmetric specs: codes (int4 after unpacking; fp8 by their bytes) and
  scales are bit-exact;
- asymmetric ("...a") specs: shifts within 1e-6 * max|shift| + 1e-7 (torch
  and jnp take the float32 mean over D in another order, up to a few ulp),
  dequantized values within one quantization step (scale) plus 1e-6, since a
  shift that differs in its last bit can move a code by one.
Also: the int4 nibble layout round-trips, a JAX cache bridged through
`qkv_layer_from_numpy` equals the port's, `kv_read` dequantizes alike, and the
entry points allocate on CUDA unless asked for the CPU, and a write through
`slot_view` lands in its row of the pool and nowhere else.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanto_tpu.tensor import kv_cache as jkv
from quanto_tpu_torch.models.llama import LlamaConfig, init_kv_cache
from quanto_tpu_torch.models.loading import qkv_layer_from_numpy
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.tensor import kv_cache as tkv

B, S, H, D = 2, 16, 2, 64
SYMMETRIC = ["qint8", "qint4", "k8v4", "k4v8", "qfloat8_e4m3fn", "qfloat8_e5m2"]
ASYMMETRIC = ["qint4a", "k8v4a", "qint8a"]


def kv(rng, T):
    """K with a per-head offset (RoPE'd K heads are skewed), V centred."""
    k = rng.standard_normal((B, T, H, D)).astype(np.float32) * 2.0 + 0.5
    v = rng.standard_normal((B, T, H, D)).astype(np.float32)
    return k, v


def write_both(spec, per_row):
    """(jax layer, port layer) after the same two writes."""
    rng = np.random.default_rng(sum(map(ord, spec)) + per_row)
    jc = jkv.init_quantized_kv_cache(1, B, S, H, D, spec)[0]
    tc = tkv.init_quantized_kv_cache(1, B, S, H, D, spec, device="cpu")[0]
    k, v = kv(rng, 5)
    jc = jkv.kv_update(jc, jnp.asarray(k), jnp.asarray(v), 0)
    tc = tkv.kv_update(tc, torch.from_numpy(k), torch.from_numpy(v), 0)
    k, v = kv(rng, 1)
    pos = np.array([5, 9], np.int32) if per_row else 7
    jc = jkv.kv_update(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    tpos = torch.from_numpy(pos) if per_row else pos
    tc = tkv.kv_update(tc, torch.from_numpy(k), torch.from_numpy(v), tpos)
    return jc, tc


def codes_np(t: torch.Tensor) -> np.ndarray:
    """Port payload -> comparable numpy: int4 unpacked, fp8 as bytes."""
    if t.dtype == torch.uint8:
        return tkv.unpack_int4_codes(t).numpy()
    if t.is_floating_point():
        return t.view(torch.uint8).numpy()
    return t.numpy()


def jax_codes_np(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name.startswith("float8"):
        return a.view(np.uint8)
    return a.astype(np.int8)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_pos", "per_row_pos"])
@pytest.mark.parametrize("spec", SYMMETRIC)
def test_symmetric_writes_bit_exact(spec, per_row):
    jc, tc = write_both(spec, per_row)
    assert tc._k_shift is None and tc._v_shift is None
    for side in ("k", "v"):
        np.testing.assert_array_equal(
            codes_np(getattr(tc, f"_{side}_data")), jax_codes_np(getattr(jc, f"_{side}_data"))
        )
        np.testing.assert_array_equal(
            getattr(tc, f"_{side}_scale").numpy().view(np.uint32),
            np.asarray(getattr(jc, f"_{side}_scale")).view(np.uint32),
        )


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_pos", "per_row_pos"])
@pytest.mark.parametrize("spec", ASYMMETRIC)
def test_asymmetric_writes_within_one_step(spec, per_row):
    jc, tc = write_both(spec, per_row)
    for side in ("k", "v"):
        js = np.asarray(getattr(jc, f"_{side}_shift"))
        ts = getattr(tc, f"_{side}_shift").numpy()
        assert np.max(np.abs(ts - js)) <= 1e-6 * np.max(np.abs(js)) + 1e-7
    jk, jv = jkv.kv_read(jc, jnp.float32)
    tk, tv = tkv.kv_read(tc, torch.float32)
    for t, j, sc in ((tk, jk, tc._k_scale), (tv, jv, tc._v_scale)):
        assert np.all(np.abs(t.numpy() - np.asarray(j)) <= sc.numpy() + 1e-6)


@pytest.mark.parametrize("spec", SYMMETRIC + ASYMMETRIC)
def test_bridge_and_read_match(spec):
    """A JAX layer bridged into the port equals the port's own writes
    (symmetric specs), and `kv_read` / `kv_read_raw` agree with JAX's."""
    jc, tc = write_both(spec, True)
    fields = {
        name: np.asarray(getattr(jc, name))
        for name in ("_k_data", "_k_scale", "_v_data", "_v_scale", "_k_shift", "_v_shift")
        if getattr(jc, name) is not None
    }
    bridged = qkv_layer_from_numpy(fields, spec)
    for name in fields:
        assert getattr(bridged, name).dtype == getattr(tc, name).dtype
        assert getattr(bridged, name).shape == getattr(tc, name).shape
    if spec in SYMMETRIC:
        for name in fields:  # byte for byte
            a, b = getattr(bridged, name), getattr(tc, name)
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    jk, jv = jkv.kv_read(jc, jnp.float32)
    bk, bv = tkv.kv_read(bridged, torch.float32)
    np.testing.assert_array_equal(bk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(bv.numpy(), np.asarray(jv))
    raw_j = jkv.kv_read_raw(jc, jnp.float32)
    raw_t = tkv.kv_read_raw(bridged, torch.float32)
    assert len(raw_t) == 6
    for t, j in zip(raw_t, raw_j):
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_int4_nibble_layout_round_trips():
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(-7, 8, (3, 5, 2, 64)).astype(np.int8))
    packed = tkv.pack_int4_codes(codes)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 5, 2, 32)
    # Byte j: code 2j + 8 in the low nibble, code 2j + 1 + 8 in the high one.
    lo, hi = int(codes[0, 0, 0, 0]) + 8, int(codes[0, 0, 0, 1]) + 8
    assert int(packed[0, 0, 0, 0]) == lo | (hi << 4)
    assert torch.equal(tkv.unpack_int4_codes(packed), codes)
    zero = tkv.init_quantized_kv_cache(1, 1, 2, 1, 64, "qint4", device="cpu")[0]
    assert torch.all(zero._k_data == 0x88) and torch.all(tkv.unpack_int4_codes(zero._k_data) == 0)


@pytest.mark.parametrize("spec", ["qint8", "qint4", "qfloat8_e4m3fn", "k4v8a"])
def test_init_matches_jax(spec):
    jc = jkv.init_quantized_kv_cache(2, B, S, H, D, spec)
    tc = tkv.init_quantized_kv_cache(2, B, S, H, D, spec, device="cpu")
    assert len(tc) == 2 and tkv.cache_max_len(tc[0]) == jkv.cache_max_len(jc[0]) == S
    for j, t in zip(jc, tc):
        for name in ("_k_scale", "_v_scale", "_k_shift", "_v_shift"):
            a, b = getattr(j, name), getattr(t, name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        jk, _ = jkv.kv_read(j, jnp.float32)
        tk, _ = tkv.kv_read(t, torch.float32)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_parse_kv_spec_matches_jax():
    for spec in SYMMETRIC + ASYMMETRIC + ["qfloat8", "qfloat8_e4m3fnuz", "k4v8"]:
        jk, jv, ja = jkv.parse_kv_spec(spec)
        tk, tv, ta = tkv.parse_kv_spec(spec)
        assert (tk.name, tv.name, ta) == (jk.name, jv.name, ja)
        assert (tk.qmin, tk.qmax) == (jk.qmin, jk.qmax)
    with pytest.raises(ValueError):
        tkv.parse_kv_spec("qint5")


def test_entry_points_default_to_cuda():
    """Without `device`, caches and QLinear allocate on CUDA: on a host
    without CUDA they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    config = LlamaConfig(vocab_size=64, hidden_size=128, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=64)
    for make in (
        lambda: init_kv_cache(config, 1, 8),
        lambda: init_kv_cache(config, 1, 8, kv_quant="qint4"),
        lambda: tkv.init_quantized_kv_cache(1, 1, 8, 2, 64, "qint8"),
        lambda: QLinear(128, 64, weights="qint4"),
    ):
        with pytest.raises((AssertionError, RuntimeError)):
            make()
    assert init_kv_cache(config, 1, 8, device="cpu")[0][0].device.type == "cpu"
    assert QLinear(128, 64, weights="qint4", device="cpu").weight.device.type == "cpu"


@pytest.mark.parametrize("spec", [None, "qint4", "qint8a"], ids=["float", "qint4", "qint8a"])
def test_slot_view_writes_into_the_pool(spec):
    k, v = (torch.from_numpy(a[:1]) for a in kv(np.random.default_rng(7), 3))

    def fresh(b):
        if spec is None:
            return (torch.zeros(b, S, H, D), torch.zeros(b, S, H, D))
        return tkv.init_quantized_kv_cache(1, b, S, H, D, spec, device="cpu")[0]

    def tensors(c):
        if spec is None:
            return list(c)
        return [getattr(c, f.name) for f in dataclasses.fields(c) if torch.is_tensor(getattr(c, f.name))]

    pool, one, empty = fresh(B), fresh(1), fresh(1)
    tkv.kv_update(tkv.slot_view(pool, 1), k, v, 4)
    tkv.kv_update(one, k, v, 4)
    for p, o, e in zip(tensors(pool), tensors(one), tensors(empty), strict=True):
        assert torch.equal(p[1:2], o)
        assert torch.equal(p[0:1], e)
