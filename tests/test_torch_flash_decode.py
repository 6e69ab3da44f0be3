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
