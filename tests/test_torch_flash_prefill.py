"""The port's causal prefill attention and `gqa_attention`'s extras against quanto_tpu.

- `flash_prefill` (its plain version on the CPU) against JAX's
  `try_flash_prefill`, which runs the splash-attention MQA kernel in
  interpret mode under `set_backend(flash_prefill=True)`, at T = 256: head
  dims 128 and 256, G = 1, 4 and 8, a softcap, bfloat16 and float32. Both fold
  the scale into q and round it to q's dtype, then run a float32 chain; a
  bfloat16 output is held within 2^-8 * max|ref| (at most half a bf16 step at
  the reference's largest value: the two round float32 sums taken in another
  order to neighbouring values), a float32 one within 1e-5 * max|ref|.
- `jax_flash_prefill_standin`, the test-local stand-in for JAX's
  `try_flash_prefill` built on JAX's own `gqa_attention` (q pre-scaled as at
  `attention.py:257`, a causal mask, float32 operands), held once against the
  splash kernel the same way; the model tests at prompt lengths where
  interpret mode would take minutes (`test_torch_w2a8.py`) use it.
- `gqa_attention`'s extras (softcap, alibi, head_bias, sinks, over float and
  quantized caches) against JAX's `gqa_attention` with the same arguments, on
  both chains: float32 within 2e-5 * max|ref| + 1e-6 (float32 on both sides,
  sums in another order; 1.2e-6 read); the bf16 chain (JAX's `bf16_softmax`)
  within 2^-8 * max|ref| (at most half a bf16 step at the largest value; it
  rounds in the same places as XLA, and every case read equal on this CPU).
- The envelope (`in_envelope`, JAX's exactly), `static_zero_pos`, and the
  model's route: a prefill written at the Python int 0 or a cache-less
  forward inside the envelope goes through `flash_prefill`, a tensor position
  or a short prompt does not.

The CUDA kernel itself is held against `flash_prefill_plain` on the card by
`tests/test_torch_gpu_kernels.py` and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanto_tpu.ops import config as jax_ops_config
from quanto_tpu.ops.attention import gqa_attention as jax_gqa_attention
from quanto_tpu.ops.attention import try_flash_prefill as jax_try_flash_prefill
from quanto_tpu.tensor import kv_cache as jkv
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_kv_cache
from quanto_tpu_torch.ops import attention as attention_mod
from quanto_tpu_torch.ops.attention import gqa_attention, static_zero_pos, try_flash_prefill
from quanto_tpu_torch.ops.cuda.flash_prefill import flash_prefill, flash_prefill_plain, in_envelope
from quanto_tpu_torch.tensor import kv_cache as tkv

from .test_torch_flash_decode import bridge, jax_cache


def jax_flash_prefill_standin(q, k, v, num_kv_heads, head_dim, *, softcap=None, scale=None):
    """JAX's `try_flash_prefill` (splash) computed by JAX's `gqa_attention`:
    the same envelope, q scaled in float32 and rounded to its dtype, then a
    causal float32 chain (float32 PV product, as splash keeps it) over the raw
    K/V; [B, T, H * D] in q's dtype, or None outside the envelope."""
    B, T, H, D = q.shape
    if T < 256 or T % 128 != 0 or D % 128 != 0 or q.dtype not in (jnp.bfloat16, jnp.float32):
        return None
    if scale is None:
        scale = head_dim**-0.5
    # The barrier keeps XLA from folding the scale into the logits under jit: splash takes q
    # already scaled, and so does the port.
    qs = jax.lax.optimization_barrier((q.astype(jnp.float32) * scale).astype(q.dtype)).astype(jnp.float32)
    mask = jnp.where(jnp.tril(jnp.ones((T, T), bool)), 0.0, jnp.finfo(jnp.float32).min)[None, None]
    out = jax_gqa_attention(
        qs.reshape(B, T, num_kv_heads, H // num_kv_heads, D), k.astype(jnp.float32), v.astype(jnp.float32),
        mask, 1.0, softcap=softcap,
    )
    return out.astype(q.dtype)


def qkv(B, T, Hkv, G, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return q, k, v


def splash(q, k, v, Hkv, D, dtype, softcap=None):
    """JAX's `try_flash_prefill` through the splash kernel (interpret mode)."""
    jax_ops_config.set_backend(flash_prefill=True)
    try:
        ref = jax_try_flash_prefill(
            *(jnp.asarray(a, dtype) for a in (q, k, v)), Hkv, D, softcap=softcap
        )
    finally:
        jax_ops_config.set_backend()
    assert ref is not None
    return np.asarray(ref.astype(jnp.float32))


def within(out, ref, dtype):
    """2^-8 * max|ref| for a bfloat16 output, 1e-5 * max|ref| for float32."""
    limit = (2.0**-8 if dtype == "bfloat16" else 1e-5) * np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= limit, (err, limit)


CASES = {
    "d128-g4-bf16": (2, 4, 128, None, "bfloat16"),
    "d128-g1-f32": (2, 1, 128, None, "float32"),
    "d128-g8-softcap-bf16": (1, 8, 128, 50.0, "bfloat16"),
    "d256-g1-bf16": (2, 1, 256, None, "bfloat16"),
    "d256-g8-bf16": (1, 8, 256, None, "bfloat16"),
    "d256-g8-softcap-f32": (1, 8, 256, 50.0, "float32"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_splash(case):
    Hkv, G, D, softcap, dtype = CASES[case]
    q, k, v = qkv(1, 256, Hkv, G, D, seed=D + G)
    ref = splash(q, k, v, Hkv, D, getattr(jnp, dtype), softcap)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    out = flash_prefill(tq, tk, tv, softcap=softcap)
    assert out.shape == (1, 256, Hkv * G * D) and out.dtype == tq.dtype
    within(out.float().numpy(), ref, dtype)
    # The route's helper gives the same on the CPU.
    assert torch.equal(try_flash_prefill(tq, tk, tv, softcap=softcap), out)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_standin_matches_splash(dtype):
    Hkv, G, D = 2, 2, 128
    q, k, v = qkv(1, 256, Hkv, G, D, seed=11)
    jd = getattr(jnp, dtype)
    ref = splash(q, k, v, Hkv, D, jd)
    got = jax_flash_prefill_standin(*(jnp.asarray(a, jd) for a in (q, k, v)), Hkv, D)
    within(np.asarray(got.astype(jnp.float32)), ref, dtype)
    assert jax_flash_prefill_standin(*(jnp.asarray(a[:, :200], jd) for a in (q, k, v)), Hkv, D) is None


def test_plain_scales_q_as_jax():
    """The scale rounds into a bf16 q (1/sqrt(128) is not a power of 2): the
    plain version equals the chain on q pre-rounded by hand, bit for bit."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in qkv(1, 256, 1, 2, 128, seed=5))
    qs = (q.float() * 128**-0.5).bfloat16()
    causal = torch.ones((256, 256), dtype=torch.bool).tril()
    mask = torch.where(causal, 0.0, torch.finfo(torch.float32).min)[None, None]
    want = gqa_attention(qs.view(1, 256, 1, 2, 128), k, v, mask, 1.0, f32_pv=True)
    assert torch.equal(flash_prefill_plain(q, k, v), want)
    # At D = 256 the scale (1/16) is exact: scaling q or the logits agree.
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 256, 1, 1, 256, seed=6))
    alt = gqa_attention(q.view(1, 256, 1, 1, 256), k, v, mask, 256**-0.5, f32_pv=True)
    torch.testing.assert_close(flash_prefill_plain(q, k, v), alt, rtol=1e-6, atol=1e-6)


def test_envelope_is_jax():
    for T, D, dtype, want in [
        (256, 128, torch.bfloat16, True), (1024, 256, torch.float32, True), (384, 384, torch.bfloat16, True),
        (128, 128, torch.bfloat16, False), (320, 128, torch.bfloat16, False), (256, 64, torch.bfloat16, False),
        (256, 128, torch.float16, False),
    ]:
        assert in_envelope(T, D, dtype) == want, (T, D, dtype)
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 192, 1, 2, 128, seed=0))
    assert try_flash_prefill(q, k, v) is None
    with pytest.raises(ValueError):
        flash_prefill(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 256, 1, 2, 128, seed=0))
    with pytest.raises(TypeError):
        flash_prefill(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError):
        flash_prefill(q, k[:, :, :, :64], v[:, :, :, :64])


def test_static_zero_pos():
    for pos in (None, 0, np.int32(0), np.int64(0)):
        assert static_zero_pos(pos), pos
    for pos in (1, torch.tensor(0), torch.zeros(2, dtype=torch.int32), np.array([0, 0]), False, 0.0):
        assert not static_zero_pos(pos), pos


# --- gqa_attention's extras ------------------------------------------------------------------------

B, T, S, HKV, G, D = 2, 5, 24, 2, 2, 64


def extras(which, seed=3):
    """Numpy arguments of the named extras (a subset of softcap, alibi,
    head_bias, sinks)."""
    rng = np.random.default_rng(seed)
    out = {}
    if "softcap" in which:
        out["softcap"] = 4.0  # below the logits' spread, so the cap bends them
    if "alibi" in which:
        out["alibi"] = (rng.standard_normal((B, HKV * G, S)) * 2).astype(np.float32)
    if "head_bias" in which:
        out["head_bias"] = rng.standard_normal((1, HKV * G, T, S)).astype(np.float32)
    if "sinks" in which:
        out["sinks"] = (rng.standard_normal(HKV * G) * 2).astype(np.float32)
    return out


EXTRAS = ["softcap", "alibi", "head_bias", "sinks", "softcap+alibi+head_bias+sinks"]
CACHES = ["float", "qint8", "qint4a"]


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("which", EXTRAS)
@pytest.mark.parametrize("chain", ["f32", "bf16"])
def test_gqa_extras_match_jax(chain, which, cache):
    rng = np.random.default_rng(len(which) + len(cache))
    qpos = np.arange(T)[None, :] + np.array([[3], [18]])
    mask = np.where(np.arange(S)[None, None, :] <= qpos[:, :, None], 0.0, np.finfo(np.float32).min)
    mask = mask[:, None].astype(np.float32)  # [B, 1, T, S]
    q = (rng.standard_normal((B, T, HKV, G, D)) * 2).astype(np.float32)
    ex = extras(which)
    dtype = jnp.bfloat16 if chain == "bf16" else jnp.float32
    if cache == "float":
        k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
        v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
        jargs = dict(k=jnp.asarray(k, dtype), v=jnp.asarray(v, dtype))
        targs = dict(k=torch.from_numpy(k).to(getattr(torch, str(dtype.dtype))),
                     v=torch.from_numpy(v).to(getattr(torch, str(dtype.dtype))))
    else:
        layer = jax_cache(cache, B, S, HKV, D, seed=9)
        names = ("k", "v", "k_scale", "v_scale", "k_shift", "v_shift")
        jargs = dict(zip(names, jkv.kv_read_raw(layer, dtype)))
        targs = dict(zip(names, tkv.kv_read_raw(bridge(layer, cache), getattr(torch, str(dtype.dtype)))))
    jax_ops_config.set_backend(bf16_softmax=chain == "bf16")
    try:
        ref = jax_gqa_attention(
            jnp.asarray(q, dtype), jargs.pop("k"), jargs.pop("v"), jnp.asarray(mask), D**-0.5, **jargs,
            **{n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a) for n, a in ex.items()},
        )
    finally:
        jax_ops_config.set_backend()
    ref = np.asarray(ref.astype(jnp.float32))
    out = gqa_attention(
        torch.from_numpy(q).to(getattr(torch, str(dtype.dtype))), targs.pop("k"), targs.pop("v"),
        torch.from_numpy(mask), D**-0.5, **targs, bf16_chain=chain == "bf16",
        **{n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a) for n, a in ex.items()},
    ).float().numpy()
    assert out.shape == ref.shape
    limit = 2.0**-8 * np.abs(ref).max() if chain == "bf16" else 2e-5 * np.abs(ref).max() + 1e-6
    assert np.abs(out - ref).max() <= limit


def test_bf16_chain_is_a_keyword():
    """The bf16 chain is taken only when asked, and only for a bfloat16 q."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 3, 1, 2, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 8, 1, 64)).astype(np.float32)) for _ in range(2))
    f32 = gqa_attention(q, k, v, None, 0.125)
    assert torch.equal(gqa_attention(q, k, v, None, 0.125, bf16_chain=True), f32)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    assert not torch.equal(gqa_attention(qb, kb, vb, None, 0.125, bf16_chain=True),
                           gqa_attention(qb, kb, vb, None, 0.125))


# --- the model's route -----------------------------------------------------------------------------

ROUTE = dict(vocab_size=128, hidden_size=256, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=1, dtype=torch.float32)


def test_model_routes_causal_from_zero(monkeypatch):
    calls = []

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return flash_prefill(q, k, v, **kw)

    monkeypatch.setattr(attention_mod, "flash_prefill", spy)
    model = LlamaForCausalLM(LlamaConfig(**ROUTE), device="cpu", generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 256)))
    L = ROUTE["num_hidden_layers"]
    with torch.no_grad():
        plain, _ = model(ids)  # cache-less: the fused route
        assert calls == [(2, 256, 2, 128)] * L
        cache = init_kv_cache(model.config, 2, 272, device="cpu")
        calls.clear()
        fused, cache = model(ids, cache, 0)  # a cache written at the int 0: the fused route
        assert len(calls) == L
        torch.testing.assert_close(fused, plain, rtol=0, atol=0)
        calls.clear()
        chain, _ = model(ids, init_kv_cache(model.config, 2, 272, device="cpu"), torch.tensor(0))
        model(ids[:, :128], init_kv_cache(model.config, 2, 272, device="cpu"), 0)  # T = 128: outside
        assert calls == []
    # The chain over the cache readback agrees with the fused route within float32 sums.
    torch.testing.assert_close(chain, fused, rtol=1e-4, atol=1e-4)
