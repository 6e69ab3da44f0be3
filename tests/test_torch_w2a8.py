"""W2A8 (int2 weights, int8 activations) of quanto_tpu_torch against quanto_tpu.

JAX runs int8 x against int2 codes through the int8 arms of its Pallas
kernels: `_int8_kernel` at M <= 512, the integer arm of `_prefill_kernel` at
512 < M <= 1024 (`_prefill_route` refuses int2 above), and, under
`set_backend(w4a8_requant_dot=True)`, `_int8pc_kernel` at M >= 2048, tried
before that refusal. The port takes the same routes, the last one for a
weight in the requant form (`freeze(model, w4a8_requant_dot=True)`).

- The plain versions behind the int2 arms (a CPU tensor takes them) against
  JAX's kernels in interpret mode: `qbits_mm_tiled_int8` at M in {513, 1024}
  within 1e-5 * max|ref| (exact integer sums per group, float32 sums over
  groups in another order); `qbits_mm_requant_int8` at M = 2048, given the
  s8 of JAX's jitted code, equal bit for bit.
- `requant_step` and `requant_codes` at int2 against `_int8pc_call`'s s8, rs
  and rz (`qbits_mm.py:484-490`) written op by op: bit for bit.
- The routing of an int2 weight through `qlinear` with int8 x, by the
  wrapper each branch calls, against JAX's `qlinear` under the same
  `set_backend`: M = 512 small-M, 513 and 1024 tiled, 1025 and 2047 no
  kernel, 2048 and 2049 the requant kernel (requant form; equal to JAX given
  its s8), 2048 no kernel for the exact form and for one group (gs = K).
- A tiny calibrated W2A8 Llama (hidden 512, intermediate 1024: the least
  widths on the int2 envelope), then 4 greedy decode steps (M = B: the
  small-M route): the exact form prefilled at B x T = 1 x 1024 rows (M =
  1024, the tiled route's largest M; at 2 x 1024 the exact form takes no
  kernel in either package) against JAX with `set_backend(pallas_qbits=True)`,
  and the requant form (given JAX's s8) at 2 x 1024 rows against JAX with
  `w4a8_requant_dot=True` as well. Both prompts are causal from position 0
  inside the fused prefill's envelope (head_dim 128), so both packages attend
  to the raw K/V there: the port through `flash_prefill`'s plain version,
  JAX through `jax_flash_prefill_standin` (`test_torch_flash_prefill.py`,
  held there against the splash kernel). An activation within one float32 ulp of a
  rounding half can take another int8 code in either package
  (`tests/test_torch_w4a8.py`). At this width (about 9000 quantized
  activations a position) a prompt of 1024 tokens moves some code, and a
  code moved in a key or value moves every later position. The prompts use
  a seed (38) on which no row moves before position 64 (the fused prefill's
  float32 sums round differently from the readback chain's, so seed 33,
  chosen for that chain, now moves a code at position 31): positions below
  PREFIX agree within CLEAN, all within MOVED (about two codes' worth, a
  code moving a row by up to 4e-2 * max|ref|, `tests/test_torch_requant.py`),
  and the greedy tokens are equal.
"""

import dataclasses
import functools

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
from quanto_tpu.ops import attention as jax_attention
from quanto_tpu.ops import config as jax_ops_config
from quanto_tpu.ops.pallas.qbits_mm import qbits_int8_matmul_kernel_call
from quanto_tpu.ops.qlinear import qlinear as jax_qlinear
from quanto_tpu.tensor.activations import ActivationQBytesArray as JaxActivation
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_kv_cache
from quanto_tpu_torch.models.loading import load_hf_state_dict
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.ops import qlinear as QL
from quanto_tpu_torch.ops.cuda import qbits_mm as K
from quanto_tpu_torch.tensor.activations import ActivationQBytesArray
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray, WeightQBitsRequantArray

from .test_torch_flash_prefill import jax_flash_prefill_standin
from .test_torch_int2 import LLAMA, weight_pair
from .test_torch_requant import bits, spy
from .test_torch_requant import jax_s8_formula as jax_s8_formula_qmax
from .test_torch_w4a8 import close

GS = 128
SX = np.float32(0.0173)


jax_s8_formula = functools.partial(jax_s8_formula_qmax, qmax=3.0)  # int2
jax_s8 = jax.jit(jax_s8_formula)


def with_jax_s8(w: WeightQBitsRequantArray) -> WeightQBitsRequantArray:
    """`w` with the s8 of JAX's jitted code: under jit XLA's CPU code contracts
    `s * 3 - z` into an fma (`tests/test_torch_requant.py`), so that s8 can be
    an ulp away from the port's, and both packages then take the same codes."""
    s, z = (jnp.asarray(t.numpy()) for t in (w._scale_t, w._shift_t))
    return dataclasses.replace(w, _s8=torch.from_numpy(np.array(jax_s8(s, z))))


def int8_pair(xq: np.ndarray):
    """The same int8 codes and scale as a JAX and a port activation."""
    jx = JaxActivation(_data=jnp.asarray(xq), _scale=jnp.asarray(SX), qtype=qt.qint8,
                       float_dtype=jnp.dtype(jnp.float32))
    tx = ActivationQBytesArray(_data=torch.from_numpy(xq), _scale=torch.tensor(SX), qtype=qtt.qint8,
                               float_dtype=torch.float32)
    return jx, tx


@pytest.fixture(scope="module")
def int2_weight():
    """One int2 weight, N x K = 128 x 512 at group size 128 (JAX's TPU layout
    and the port's Hopper layout of the same codes), and int8 x of 2049 rows."""
    rng = np.random.default_rng(7)
    tpu, hop = weight_pair(rng.standard_normal((128, 512)).astype(np.float32), 2)
    xq = rng.integers(-128, 128, (2049, 512), dtype=np.int8)
    return tpu, hop, xq


# --- the plain versions against the TPU kernels in interpret mode ------------------------------


@pytest.mark.parametrize("m", [513, 1024, pytest.param((513, 256), id="513-gs256"),
                               pytest.param((1024, 256), id="1024-gs256")])
def test_tiled_int8_plain_matches_prefill_kernel(int2_weight, m):
    """The W2A8 arm's plain version against JAX's integer `_prefill_kernel` in
    interpret mode; group size 256 on a 128 x 1024 weight (at K = 512 an int2
    group is at most 128 codes in JAX's TPU layout)."""
    m, gs = m if isinstance(m, tuple) else (m, GS)
    tpu, hop, xq = int2_weight
    if gs != GS:
        rng = np.random.default_rng(8)
        tpu, hop = weight_pair(rng.standard_normal((128, 1024)).astype(np.float32), 2, group_size=gs)
        xq = rng.integers(-128, 128, (m, 1024), dtype=np.int8)
    ref = qbits_int8_matmul_kernel_call(
        jnp.asarray(xq[:m]), jnp.asarray(SX), tpu._packed, tpu._scale_t, tpu._shift_t, 2, gs, jnp.float32,
        interpret=True,
    )
    assert ref is not None
    before = (K.qbits_mm_tiled_int8.launches, K.qbits_mm_tiled_int8.launches_int2)
    out = K.qbits_mm_tiled_int8(
        torch.from_numpy(xq[:m]), torch.tensor(SX), hop._packed, hop._scale_t, hop._shift_t, gs, torch.float32, 2
    )
    assert (K.qbits_mm_tiled_int8.launches, K.qbits_mm_tiled_int8.launches_int2) == before
    assert out.dtype == torch.float32 and out.shape == (m, 128)
    close(out, ref, 1e-5)


def test_requant_plain_equals_int8pc_kernel(int2_weight):
    tpu, hop, xq = int2_weight
    jax_ops_config.set_backend(pallas_qbits=True, w4a8_requant_dot=True)
    try:
        ref = qbits_int8_matmul_kernel_call(
            jnp.asarray(xq[:2048]), jnp.asarray(SX), tpu._packed, tpu._scale_t, tpu._shift_t, 2, GS,
            jnp.float32, interpret=True,
        )
    finally:
        jax_ops_config.set_backend()
    req = with_jax_s8(WeightQBitsRequantArray.from_hopper(hop))
    args = (torch.from_numpy(xq[:2048]), torch.tensor(SX), req._packed, req._scale_t, req._shift_t)
    out = K.qbits_mm_requant_int8(*args, req._s8, GS, torch.float32, 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # The route is approximate: the exact W2A8 product differs by far more.
    exact = K.qbits_int8_mm_plain(*args, GS, torch.float32, 2).numpy()
    assert np.abs(exact - np.asarray(ref)).max() > 1e-3 * np.abs(exact).max()


@pytest.mark.parametrize("gs", [128, 256])
def test_requant_step_and_codes_match_jax(gs):
    N, Kd = 256, 1024
    _, hop = weight_pair(np.random.default_rng(gs).standard_normal((N, Kd)).astype(np.float32), 2, group_size=gs)
    s8 = K.requant_step(hop._scale_t, hop._shift_t, 2)
    s, z = jnp.asarray(hop._scale_t.numpy()), jnp.asarray(hop._shift_t.numpy())
    js8 = jax_s8_formula(s, z)  # op by op, as `_int8pc_call` writes it
    np.testing.assert_array_equal(bits(s8), bits(js8))
    rs, rz = s / js8[None, :], z / js8[None, :]
    np.testing.assert_array_equal(bits(hop._scale_t / s8), bits(rs))
    np.testing.assert_array_equal(bits(hop._shift_t / s8), bits(rz))
    raw = jnp.asarray(K.unpack_k_codes(hop._packed, 2).numpy().astype(np.float32)).reshape(N, -1, gs)
    jc8 = jnp.clip(jnp.round(raw * rs.T[:, :, None] - rz.T[:, :, None]), -127, 127).astype(jnp.int8)
    c8 = K.requant_codes(hop._packed, hop._scale_t, hop._shift_t, s8, gs, 2)
    np.testing.assert_array_equal(c8.numpy(), np.asarray(jc8).reshape(N, Kd))
    # The step is per channel: 127 steps over the row's largest |weight|, which takes +/-127.
    assert (c8.abs().amax(dim=1) == 127).all()
    err = (c8.float() * s8[:, None] - hop.dequantize()).abs().amax(dim=1)
    assert (err <= s8 * (0.5 + 1e-4)).all()


# --- routing --------------------------------------------------------------------------------------


@pytest.mark.parametrize("m,form,want", [
    (512, "requant", "qbits_mm_int8_small_m"),
    (513, "requant", "qbits_mm_tiled_int8"),
    (1024, "requant", "qbits_mm_tiled_int8"),
    (1025, "requant", None),
    (2047, "requant", None),
    (2048, "requant", "qbits_mm_requant_int8"),
    (2049, "requant", "qbits_mm_requant_int8"),
    (2048, "exact", None),
    (2048, "requant-one-group", None),
])
def test_qlinear_routes_w2a8(monkeypatch, int2_weight, m, form, want):
    """Each branch, spied at the wrapper it calls (None: no kernel wrapper),
    against JAX's `qlinear` with `set_backend(pallas_qbits=True,
    w4a8_requant_dot=True)` for the requant form, without the switch for the
    exact form; the requant rows are equal to JAX's given its s8."""
    tpu, hop, xq = int2_weight
    if form == "requant-one-group":
        rng = np.random.default_rng(8)
        tpu, hop = weight_pair(rng.standard_normal((128, 512)).astype(np.float32), 2, group_size=None)
    w = hop if form == "exact" else with_jax_s8(WeightQBitsRequantArray.from_hopper(hop))
    jx, tx = int8_pair(xq[:m])
    jax_ops_config.set_backend(pallas_qbits=True, w4a8_requant_dot=form != "exact")
    try:
        ref = np.asarray(jax_qlinear(jx, tpu))
    finally:
        jax_ops_config.set_backend()
    calls = []
    for name in ("qbits_mm_int8_small_m", "qbits_mm_tiled_int8", "qbits_mm_requant_int8"):
        monkeypatch.setattr(K, name, spy(calls, getattr(K, name)))
    out = QL.qlinear(tx, w)
    assert calls == ([(want, m)] if want else [])
    if want == "qbits_mm_requant_int8":
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        close(out, ref, 1e-5)


# --- the tiny calibrated W2A8 Llama ---------------------------------------------------------------

W2A8 = dict(weights="qint2", activations="qint8", exclude="lm_head")
CAL_BATCHES = [np.random.default_rng(30 + i).integers(0, LLAMA["vocab_size"], (2, 16)) for i in range(2)]
IDS = np.random.default_rng(38).integers(0, LLAMA["vocab_size"], (2, 1024))
FORMS = {"exact": (IDS[:1], False), "requant": (IDS, True)}  # prompts and JAX's requant switch
STEPS = 4
# Positions before any moved activation code agree within CLEAN; the rest within MOVED (module
# docstring).
PREFIX, CLEAN, MOVED = 64, 1e-5, 1e-1


def _prefill_and_steps(model, ids, cache):
    logits, cache = model(ids, cache, 0)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    toks = [tok]
    for i in range(STEPS):
        step, cache = model(tok, cache, ids.shape[1] + i)
        tok = jnp.argmax(step[:, -1], axis=-1)[:, None]
        toks.append(tok)
    return logits, jnp.concatenate(toks, axis=1)


@pytest.fixture(scope="module")
def jax_w2a8():
    """JAX's calibrated W2A8 model: its state and output flags, and the
    prefill logits and greedy tokens of the exact route and the requant
    route, each frozen and run (its own jitted function) under its backend."""
    model = JaxLlama(JaxLlamaConfig(**LLAMA), rngs=nnx.Rngs(0))
    qt.quantize(model, **W2A8)
    qt.calibrate_jit(model, [jnp.asarray(b, jnp.int32) for b in CAL_BATCHES])
    flags = {n: m.quantize_outputs for n, m in qt.named_qmodules(model)}
    cal_state = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    outs = {}
    jax_ops_config.set_backend(pallas_qbits=True)
    try:
        qt.freeze(model)  # into the TPU layout that the Pallas kernels take
    finally:
        jax_ops_config.set_backend()
    for form, (ids, requant) in FORMS.items():
        B, T = ids.shape
        jax_ops_config.set_backend(pallas_qbits=True, w4a8_requant_dot=requant)
        try:
            # The prefill from position 0 attends to its raw K/V, as on the TPU and in the port
            # (the splash kernel's stand-in: interpret mode at T = 1024 would take minutes).
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_attention, "try_flash_prefill", jax_flash_prefill_standin)
                logits, toks = nnx.jit(lambda m, i, c: _prefill_and_steps(m, i, c))(
                    model, jnp.asarray(ids, jnp.int32), jax_init_kv_cache(model.config, B, T + STEPS)
                )
        finally:
            jax_ops_config.set_backend()
        outs[form] = (np.asarray(logits), np.asarray(toks))
    return cal_state, flags, outs


def port_w2a8(cal_state, flags):
    """The port's W2A8 model from JAX's calibrated state, frozen and repacked
    into the Hopper layout (a CPU freeze keeps the generic one)."""
    model = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu")
    qtt.quantize(model, **W2A8)
    assert load_hf_state_dict(model, cal_state) == {"missing": [], "unexpected": []}
    for name, m in qtt.named_qmodules(model):
        m.quantize_outputs = flags[name]
    qtt.freeze(model)
    for m in model.modules():
        if isinstance(m, QLinear):
            m.weight = WeightQBitsHopperArray.from_generic(m.weight)
            assert m.weight is not None and m.weight.bits == 2
    return model


@pytest.mark.parametrize("form", ["exact", "requant"])
def test_w2a8_model_matches_jax(monkeypatch, jax_w2a8, form):
    cal_state, flags, outs = jax_w2a8
    ref_logits, ref_toks = outs[form]
    model = port_w2a8(cal_state, flags)
    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    if form == "requant":
        qtt.freeze(model, w4a8_requant_dot=True)
        for m in qlinears:
            assert type(m.weight) is WeightQBitsRequantArray
            m.weight = with_jax_s8(m.weight)
    ids = FORMS[form][0]
    B, T = ids.shape
    calls = []
    for name in ("qbits_mm_int8_small_m", "qbits_mm_tiled_int8", "qbits_mm_requant_int8"):
        monkeypatch.setattr(K, name, spy(calls, getattr(K, name)))
    with torch.no_grad():
        cache = init_kv_cache(model.config, B, T + STEPS, device="cpu")
        logits, cache = model(torch.from_numpy(ids), cache, 0)
        toks = [logits[:, -1].argmax(-1)[:, None]]
        for i in range(STEPS):
            step, cache = model(toks[-1], cache, T + i)
            toks.append(step[:, -1].argmax(-1)[:, None])
    # The prefill: the tiled kernel (M = 1024) in the exact form, the requant kernel (M = 2048) in
    # the requant form; each decode step (M = B): the small-M kernel.
    prefill = "qbits_mm_requant_int8" if form == "requant" else "qbits_mm_tiled_int8"
    assert calls == [(prefill, B * T)] * len(qlinears) + [("qbits_mm_int8_small_m", B)] * len(qlinears) * STEPS
    err = np.abs(logits.numpy() - ref_logits).max(-1) / np.abs(ref_logits).max()  # [B, T]
    assert err[:, :PREFIX].max() <= CLEAN and err.max() <= MOVED
    np.testing.assert_array_equal(torch.cat(toks, dim=1).numpy(), ref_toks)
