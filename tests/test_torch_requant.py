"""The W4A8 requant route of quanto_tpu_torch against quanto_tpu.

The route (`qbits_mm_requant_int8`, the counterpart of JAX's
`_int8pc_kernel`) requantizes int4 group-wise weights to per-channel int8
codes and takes one int32 sum over K. JAX opts in with
`set_backend(w4a8_requant_dot=True)`; the port with the weight's form
(`WeightQBitsRequantArray`, `freeze(model, w4a8_requant_dot=True)`).

- (a) The per-channel step s8, the factors rs = s / s8 and rz = z / s8 and
  the int8 codes against JAX's formulas (`qbits_mm.py:484-490`, `:443-458`)
  evaluated by jnp op by op: bit for bit. Under `jax.jit` XLA's CPU code
  contracts `s * 15 - z` into one fma (one rounding in place of two), which
  moves amax by one float32 ulp in about a fifth of the channels, and s8
  there by at most two; the test shows that case: the jitted s8 equals the
  fma form exactly and the port's in every other channel.
  Each code times s8 lies within half a step s8 of its int4 weight.
- (b) The plain version against `qbits_int8_matmul_kernel_call(...,
  interpret=True)` (JAX's `_int8pc_kernel` in interpret mode, whose s8 is
  computed under jit): given JAX's s8 the output is equal bit for bit;
  with its own s8 (an ulp or two away in some channels) within
  1e-6 * max|ref|.
- (c) The routing of W4A8 matmuls through `qlinear`, by the wrapper each
  branch calls on a CPU tensor (its plain version): M = 2047 and 2048, a
  weight with one group (gs == K), the exact and the requant form.
- (d) The calibrated tiny Llama of `tests/test_torch_w4a8.py`, frozen into
  the requant form and given the s8 of JAX's jitted code, prefilled at
  B x T = 2 x 1024 rows (every linear at M = 2048 takes the route), then 4
  greedy decode steps (M = 2: the exact small-M route), against JAX's model
  with `set_backend(pallas_qbits=True, w4a8_requant_dot=True)` (its kernels
  in interpret mode). An activation within one float32 ulp of a rounding
  half can take another int8 code in either package (`tests/test_torch_
  w4a8.py`); at 2048 rows each of the first 60 prompt seeds moves at least
  one, and a moved code moves its row's logits by up to 4e-2 * max|ref|.
  The prompts use the seed on which the fewest rows move (one, by
  4.1e-3 * max|ref|): every other row's logits agree within 1e-5 *
  max|ref|, at most MOVED_ROWS rows may take ONE_CODE, and the greedy
  tokens are identical.
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
from quanto_tpu.ops import config as jax_ops_config
from quanto_tpu.ops.pallas.qbits_mm import qbits_int8_matmul_kernel_call
from quanto_tpu.tensor.weights import WeightQBitsTpuArray
from quanto_tpu_torch.models.llama import init_kv_cache
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.ops import qlinear as QL
from quanto_tpu_torch.ops.cuda import qbits_mm as K
from quanto_tpu_torch.tensor.activations import quantize_activation
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray, WeightQBitsRequantArray

from .test_torch_llama import TINY, close
from .test_torch_w4a8 import CAL_BATCHES, W4A8, port_calibrated


def hopper_weight(w: np.ndarray, gs, qtype=qtt.qint4):
    wt = torch.from_numpy(w)
    scale, shift = qtt.MaxOptimizer()(wt, qtype, axis=0, group_size=gs)
    return WeightQBitsHopperArray.from_generic(qtt.quantize_weight(wt, qtype, 0, scale, shift=shift, group_size=gs))


def jax_s8_formula(s, z, qmax: float = 15.0):
    """`_int8pc_call`'s per-channel step (`qbits_mm.py:484-488`); qmax 15 for
    int4 codes, 3 for int2."""
    amax = jnp.max(jnp.maximum(jnp.abs(z), jnp.abs(s * qmax - z)), axis=0)
    return jnp.maximum(amax, 1e-30) * (1.0 / 127.0)


def spy(calls: list, fn):
    """`fn` recording each call's M in `calls`; it keeps a `launches` count,
    as the wrappers count themselves by their module's names."""

    def run(*args):
        calls.append((fn.__name__, args[0].shape[0]))
        return fn(*args)

    run.launches = 0
    return run


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# --- (a) s8, rs, rz and the codes ---------------------------------------------


@pytest.mark.parametrize("gs", [128, 256])
def test_requant_step_and_codes_match_jax(gs):
    N, K_ = 512, 4096
    hop = hopper_weight(np.random.default_rng(gs).standard_normal((N, K_)).astype(np.float32), gs)
    s8 = K.requant_step(hop._scale_t, hop._shift_t)
    s, z = jnp.asarray(hop._scale_t.numpy()), jnp.asarray(hop._shift_t.numpy())

    # Op by op, as the formulas are written: bit for bit.
    js8 = jax_s8_formula(s, z)
    np.testing.assert_array_equal(bits(s8), bits(js8))
    rs, rz = s / js8[None, :], z / js8[None, :]
    np.testing.assert_array_equal(bits(hop._scale_t / s8), bits(rs))
    np.testing.assert_array_equal(bits(hop._shift_t / s8), bits(rz))
    raw = jnp.asarray(K.unpack_k_codes(hop._packed, 4).numpy().astype(np.float32)).reshape(N, -1, gs)
    jc8 = jnp.clip(jnp.round(raw * rs.T[:, :, None] - rz.T[:, :, None]), -127, 127).astype(jnp.int8)
    c8 = K.requant_codes(hop._packed, hop._scale_t, hop._shift_t, s8, gs)
    assert c8.dtype == torch.int8 and c8.shape == (N, K_)
    np.testing.assert_array_equal(c8.numpy(), np.asarray(jc8).reshape(N, K_))

    # Under jit, XLA contracts s * 15 - z into an fma: one rounding.
    s_np, z_np = hop._scale_t.numpy(), hop._shift_t.numpy()
    fma = np.abs((s_np.astype(np.float64) * 15 - z_np).astype(np.float32))
    amax_fma = np.maximum(np.abs(z_np), fma).max(axis=0)
    jit_s8 = jax.jit(jax_s8_formula)(s, z)
    np.testing.assert_array_equal(bits(jit_s8), bits(np.maximum(amax_fma, np.float32(1e-30)) * np.float32(1 / 127)))
    amax_two = np.maximum(np.abs(z_np), np.abs(s_np * np.float32(15) - z_np)).max(axis=0)
    moved = bits(amax_fma) != bits(amax_two)
    assert np.abs(bits(amax_fma) - bits(amax_two)).max() == 1 and 0 < moved.sum() < N
    ulps = np.abs(bits(jit_s8) - bits(s8))
    assert ulps.max() <= 2 and not ulps[~moved].any()


@pytest.mark.parametrize("gs", [128, 256])
def test_requant_codes_within_half_a_step(gs):
    """What the route approximates: each requant code times s8 lies within
    half a step s8 of its int4 weight (float32 rounding aside), and every
    channel's largest |weight| takes code +/-127, so s8 is that channel's
    finest int8 step."""
    hop = hopper_weight(np.random.default_rng(gs).standard_normal((512, 2048)).astype(np.float32), gs)
    s8 = K.requant_step(hop._scale_t, hop._shift_t)
    c8 = K.requant_codes(hop._packed, hop._scale_t, hop._shift_t, s8, gs)
    err = (c8.float() * s8[:, None] - hop.dequantize()).abs().amax(dim=1)
    assert (err <= s8 * (0.5 + 1e-4)).all()
    assert (c8.abs().amax(dim=1) == 127).all()


def test_requant_array_round_trip():
    """int4 and int2 (W2A8, K / 4 a multiple of 128): the requant form shares
    its parent's payload, and from_hopper -> to_generic -> back is bit for bit."""
    for qtype, K_ in ((qtt.qint4, 512), (qtt.qint2, 1024)):
        hop = hopper_weight(np.random.default_rng(0).standard_normal((256, K_)).astype(np.float32), 128, qtype)
        req = WeightQBitsRequantArray.from_hopper(hop)
        assert isinstance(req, WeightQBitsHopperArray) and req._packed is hop._packed
        assert req.bits == qtype.bits and req._s8.dtype == torch.float32 and req._s8.shape == (256,)
        assert torch.equal(req._s8, K.requant_step(hop._scale_t, hop._shift_t, qtype.bits))
        assert torch.equal(req.dequantize(), hop.dequantize())
        generic = req.to_generic()
        back = WeightQBitsRequantArray.from_hopper(WeightQBitsHopperArray.from_generic(generic))
        assert type(back) is WeightQBitsRequantArray
        for f in ("_packed", "_scale_t", "_shift_t", "_s8"):
            assert torch.equal(getattr(back, f), getattr(req, f))
        assert torch.equal(generic.dequantize(), hop.to_generic().dequantize())


# --- (b) the plain version against the TPU kernel in interpret mode --------------------


@pytest.mark.parametrize("gs", [128, 256])
def test_plain_matches_pallas_interpret(gs):
    check_plain_against_pallas(gs, 2048)


def test_plain_matches_pallas_interpret_ragged_m():
    """M = 2100: not a multiple of the Hopper GEMM's 128-row M tile
    (`_int8pc_route` pads M to its own 256-row tile)."""
    check_plain_against_pallas(128, 2100)


def check_plain_against_pallas(gs, M):
    # K = 1024: JAX's default (w16) layout packs 4 codes a word, and its kernel
    # envelope needs whole groups per 256 words.
    N, K_ = 256, 1024
    rng = np.random.default_rng(gs)
    w = rng.standard_normal((N, K_)).astype(np.float32)
    xq = rng.integers(-128, 128, (M, K_), dtype=np.int8)
    sx = np.float32(0.0173)
    wj = jnp.asarray(w)
    sj, zj = qt.MaxOptimizer()(wj, qt.qint4, axis=0, group_size=gs)
    tpu = WeightQBitsTpuArray.from_generic(qt.quantize_weight(wj, qt.qint4, 0, sj, shift=zj, group_size=gs))
    jax_ops_config.set_backend(pallas_qbits=True, w4a8_requant_dot=True)
    try:
        ref = qbits_int8_matmul_kernel_call(
            jnp.asarray(xq), jnp.asarray(sx), tpu._packed, tpu._scale_t, tpu._shift_t, 4, gs,
            jnp.float32, interpret=True,
        )
    finally:
        jax_ops_config.set_backend()
    assert ref is not None
    ref = np.asarray(ref)

    req = WeightQBitsRequantArray.from_hopper(hopper_weight(w, gs))
    np.testing.assert_array_equal(bits(req._scale_t), bits(np.asarray(tpu._scale_t, np.float32)))
    np.testing.assert_array_equal(bits(req._shift_t), bits(np.asarray(tpu._shift_t, np.float32)))
    args = (torch.from_numpy(xq), torch.tensor(sx), req._packed, req._scale_t, req._shift_t)
    before = K.qbits_mm_requant_int8.launches
    out = K.qbits_mm_requant_int8(*args, req._s8, gs, torch.float32)
    assert K.qbits_mm_requant_int8.launches == before  # a CPU tensor takes the plain version
    assert out.dtype == torch.float32 and out.shape == (M, N)
    # With the s8 that JAX's jitted code computes: equal bit for bit.
    jax_s8 = torch.from_numpy(np.array(jax.jit(jax_s8_formula)(tpu._scale_t, tpu._shift_t)))
    np.testing.assert_array_equal(K.qbits_mm_requant_int8(*args, jax_s8, gs, torch.float32).numpy(), ref)
    # With the port's own s8 (op by op: an ulp or two away in some channels).
    close(out, ref, 1e-6)
    # The route is approximate: the exact W4A8 product differs by far more.
    exact = K.qbits_int8_mm_plain(*args, gs, torch.float32).numpy()
    assert np.abs(exact - ref).max() > 1e-3 * np.abs(ref).max()


def test_requant_wrapper_refusals():
    hop = hopper_weight(np.random.default_rng(0).standard_normal((128, 512)).astype(np.float32), 128)
    xq, sx = torch.zeros((4, 512), dtype=torch.int8), torch.tensor(1.0)
    w = (hop._packed, hop._scale_t, hop._shift_t)
    s8 = K.requant_step(hop._scale_t, hop._shift_t)
    with pytest.raises(TypeError, match="int8"):
        K.qbits_mm_requant_int8(xq.float(), sx, *w, s8, 128, torch.float32)
    with pytest.raises(ValueError, match="s8"):
        K.qbits_mm_requant_int8(xq, sx, *w, s8[:64], 128, torch.float32)
    with pytest.raises(ValueError, match="s8"):
        K.qbits_mm_requant_int8(xq, sx, *w, s8.double(), 128, torch.float32)
    one_group = hopper_weight(np.ones((128, 512), np.float32), None)
    with pytest.raises(ValueError, match="group size"):
        K.qbits_mm_requant_int8(
            xq, sx, one_group._packed, one_group._scale_t, one_group._shift_t, s8, 512, torch.float32
        )
    with pytest.raises(TypeError, match="output dtype"):
        K.qbits_mm_requant_int8(xq, sx, *w, s8, 128, torch.float16)


# --- (c) routing ---------------------------------------------------------------------


@pytest.mark.parametrize("case,m,form,gs,want", [
    ("requant", 2048, "requant", 128, "qbits_mm_requant_int8"),
    ("requant-ragged", 2049, "requant", 128, "qbits_mm_requant_int8"),
    ("below-min-m", 2047, "requant", 128, "qbits_mm_tiled_int8"),
    ("small-m", 512, "requant", 128, "qbits_mm_int8_small_m"),
    ("exact-form", 2048, "exact", 128, "qbits_mm_tiled_int8"),
    ("one-group", 2048, "requant", None, "qbits_mm_tiled_int8"),
])
def test_qlinear_routes_w4a8(monkeypatch, case, m, form, gs, want):
    """Each W4A8 branch, spied at the wrapper `qbits_int8_mm` calls; the
    output is the plain version of the kernel that branch names."""
    rng = np.random.default_rng(m)
    hop = hopper_weight(rng.standard_normal((128, 512)).astype(np.float32), gs)
    w = WeightQBitsRequantArray.from_hopper(hop) if form == "requant" else hop
    x = torch.from_numpy(rng.standard_normal((m, 512)).astype(np.float32))
    xa = quantize_activation(x, qtt.qint8, torch.tensor(0.05))
    calls = []
    for name in ("qbits_mm_int8_small_m", "qbits_mm_tiled_int8", "qbits_mm_requant_int8"):
        monkeypatch.setattr(K, name, spy(calls, getattr(K, name)))
    out = QL.qlinear(xa, w)
    assert calls == [(want, m)]
    args = (xa._data, xa._scale, hop._packed, hop._scale_t, hop._shift_t, hop.kernel_group_size)
    if want == "qbits_mm_requant_int8":
        ref = K.qbits_requant_int8_mm_plain(*args[:5], w._s8, args[5], torch.float32)
    else:
        ref = K.qbits_int8_mm_plain(*args, torch.float32)
    assert torch.equal(out, ref)
    # Float x: the requant form behaves as its parent, the float kernels.
    assert torch.equal(QL.qlinear(x[:8], w), QL.qlinear(x[:8], hop))


def test_freeze_takes_the_requant_form():
    """A second `freeze(model, w4a8_requant_dot=True)` converts the Hopper
    weights of a frozen model, int4 (W4A8) and int2 (W2A8, on the int2
    envelope's widths) alike; generic weights (a CPU freeze) stay as they
    are, and without the keyword nothing changes."""
    from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    from .test_torch_int2 import LLAMA

    for config, kw in ((TINY, W4A8), (LLAMA, dict(W4A8, weights="qint2"))):
        model = LlamaForCausalLM(LlamaConfig(**config), device="cpu")
        qtt.quantize(model, **kw)
        qtt.freeze(model, w4a8_requant_dot=True)
        qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
        assert all(type(m.weight).__name__ == "WeightQBitsArray" for m in qlinears)
        for m in qlinears:
            m.weight = WeightQBitsHopperArray.from_generic(m.weight)
        qtt.freeze(model)
        assert all(type(m.weight) is WeightQBitsHopperArray for m in qlinears)
        payloads = [m.weight._packed for m in qlinears]
        qtt.freeze(model, w4a8_requant_dot=True)
        assert all(type(m.weight) is WeightQBitsRequantArray for m in qlinears)
        assert all(m.weight._packed is p for m, p in zip(qlinears, payloads))
        assert all(m.weight.bits == qtt.qtypes[kw["weights"]].bits for m in qlinears)


# --- (d) the tiny calibrated W4A8 Llama ----------------------------------------------

# Prompts of B x T = 2048 rows (module docstring on the seed).
IDS = np.random.default_rng(49).integers(0, TINY["vocab_size"], (2, 1024))
# Rows that an activation code moved may take ONE_CODE (test_torch_w4a8.py saw up to
# 3e-2 from one code a step away); the others agree within CLEAN.
CLEAN, ONE_CODE, MOVED_ROWS = 1e-5, 5e-2, 2
STEPS = 4


@nnx.jit
def _jax_prefill_and_steps(model, ids, cache):
    logits, cache = model(ids, cache, 0)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    toks = [tok]
    for i in range(STEPS):
        step, cache = model(tok, cache, ids.shape[1] + i)
        tok = jnp.argmax(step[:, -1], axis=-1)[:, None]
        toks.append(tok)
    return logits, jnp.concatenate(toks, axis=1)


@pytest.fixture(scope="module")
def jax_requant_model():
    """JAX's calibrated W4A8 model frozen with the requant route on: its
    calibrated state, output flags, prefill logits and greedy tokens."""
    model = JaxLlama(JaxLlamaConfig(**TINY), rngs=nnx.Rngs(0))
    qt.quantize(model, **W4A8)
    qt.calibrate_jit(model, [jnp.asarray(b, jnp.int32) for b in CAL_BATCHES])
    flags = {n: m.quantize_outputs for n, m in qt.named_qmodules(model)}
    cal_state = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    B, T = IDS.shape
    jax_ops_config.set_backend(pallas_qbits=True, w4a8_requant_dot=True)
    try:
        qt.freeze(model)
        logits, toks = _jax_prefill_and_steps(
            model, jnp.asarray(IDS, jnp.int32), jax_init_kv_cache(model.config, B, T + STEPS)
        )
    finally:
        jax_ops_config.set_backend()
    return cal_state, flags, np.asarray(logits), np.asarray(toks)


def test_requant_model_matches_jax(monkeypatch, jax_requant_model):
    cal_state, flags, ref_logits, ref_toks = jax_requant_model
    model = port_calibrated(cal_state, flags, "hopper")
    qtt.freeze(model, w4a8_requant_dot=True)
    # The s8 of JAX's jitted code (one or two ulps from the port's in some
    # channels, test (a)), so that both packages requantize to the same codes.
    s8_jit = jax.jit(jax_s8_formula)
    for m in model.modules():
        if isinstance(m, QLinear):
            assert type(m.weight) is WeightQBitsRequantArray
            s, z = (jnp.asarray(t.numpy()) for t in (m.weight._scale_t, m.weight._shift_t))
            m.weight = dataclasses.replace(m.weight, _s8=torch.from_numpy(np.array(s8_jit(s, z))))
    B, T = IDS.shape
    calls = []
    monkeypatch.setattr(K, "qbits_mm_requant_int8", spy(calls, K.qbits_mm_requant_int8))
    with torch.no_grad():
        ids = torch.from_numpy(IDS)
        cache = init_kv_cache(model.config, B, T + STEPS, device="cpu")
        logits, cache = model(ids, cache, 0)
        toks = [logits[:, -1].argmax(-1)[:, None]]
        for i in range(STEPS):
            step, cache = model(toks[-1], cache, T + i)
            toks.append(step[:, -1].argmax(-1)[:, None])
    # The prefill's linears, none of the steps'.
    assert calls == [("qbits_mm_requant_int8", B * T)] * 7 * TINY["num_hidden_layers"]
    err = np.abs(logits.numpy() - ref_logits).max(-1) / np.abs(ref_logits).max()  # [B, T]
    assert (err > CLEAN).sum() <= MOVED_ROWS and err.max() <= ONE_CODE
    np.testing.assert_array_equal(torch.cat(toks, dim=1).numpy(), ref_toks)
