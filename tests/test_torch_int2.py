"""2-bit weights in the port's Hopper layout and kernels, against quanto_tpu.

- `WeightQBitsHopperArray.eligible` equals `WeightQBitsTpuArray.eligible`
  over a grid of shapes, widths and group sizes, so a weight takes a kernel
  in the port exactly where it takes one in JAX.
- The int2 Hopper layout round-trips to the generic layout bit for bit, its
  crumbs sit where the kernels read them (codes of 3 in every position of a
  byte, bytes >= 0xC0), and its codes and scales are JAX's.
- The plain version behind each int2 kernel arm (a CPU tensor takes it)
  against JAX's Pallas kernels in interpret mode: `qbits_mm_small_m` at M = 8
  (`_kernel`), `qbits_mm_tiled` at M = 600 (`_prefill_kernel`), and at M =
  513 and 1024 (a Hopper GEMM tile edge and the int2 route's largest M) with
  group size 256, the MoE
  entry points (`_moe_sel_kernel`, `_moe_uniq_kernel`,
  `_moe_prefill_uniq_kernel`), and the W2A8 plain version at M = 8
  (`_int8_kernel`). Float32 outputs within 1e-4 * max|ref|, bf16 outputs at
  cosine > 1 - 1e-4.
- Routing: above M = 1024 an int2 weight takes no kernel wrapper, float or
  int8 x (JAX's `_prefill_route` refuses it), and matches JAX's `qlinear`.
- A tiny Llama (hidden 512, intermediate 1024: the least widths at which
  every int2 projection is on the envelope, K / 4 a multiple of 128) in qint2
  with the lm_head excluded, and a tiny Mixtral with qint2 experts and qint4
  attention, stacked: codes bit for bit, cached-prefill logits and a decode
  step within 1e-4 * max|ref|, and 4 greedy tokens equal. Every MoE block's
  top-2 experts are asserted equal to JAX's, with a 2nd-3rd routing gap of
  at least 1e-5 (the rule of `test_torch_mixtral.py`).
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
from quanto_tpu.models.llama import init_kv_cache as jax_init_kv_cache
from quanto_tpu.models.loading import hf_state_dict
from quanto_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from quanto_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from quanto_tpu.models.mixtral import MixtralSparseMoeBlock as JaxMoeBlock
from quanto_tpu.models.serve import generate as jax_generate
from quanto_tpu.ops.pallas import moe_mm as jax_moe
from quanto_tpu.ops.pallas.qbits_mm import qbits_int8_matmul_kernel_call, qbits_matmul_kernel_call
from quanto_tpu.ops.qlinear import qlinear as jax_qlinear
from quanto_tpu.tensor.weights import WeightQBitsTpuArray
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_kv_cache
from quanto_tpu_torch.models.loading import load_hf_state_dict
from quanto_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM, route
from quanto_tpu_torch.models.serve import generate
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.ops import qlinear as QL
from quanto_tpu_torch.ops.cuda import moe_mm
from quanto_tpu_torch.ops.cuda import qbits_mm as K
from quanto_tpu_torch.parallel import StackedSparseMoeBlock, convert_moe_to_stacked
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

from .test_torch_mixtral import _jax_steps as jax_steps
from .test_torch_mixtral import _recording_call as recording_call
from .test_torch_mixtral import to_hopper
from .test_torch_quantize import bits_of

GS = 128


def close(out: torch.Tensor, ref, tol: float = 1e-4) -> None:
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * np.max(np.abs(ref))


def cosine(out: torch.Tensor, ref) -> float:
    a, b = out.detach().float().numpy().ravel(), np.asarray(ref, np.float32).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def weight_pair(w: np.ndarray, bits: int, jdt=jnp.float32, tdt=torch.float32, group_size=GS):
    """(JAX TPU-layout weight, port Hopper-layout weight) of one float32 array,
    after checking the generic codes, scales and shifts are equal bit for bit."""
    wj = jnp.asarray(w).astype(jdt)
    sj, zj = qt.MaxOptimizer()(wj, qt.qtypes[f"qint{bits}"], axis=0, group_size=group_size)
    gj = qt.quantize_weight(wj, qt.qtypes[f"qint{bits}"], 0, sj, shift=zj, group_size=group_size)
    wt = torch.from_numpy(w).to(tdt)
    st, zt = qtt.MaxOptimizer()(wt, qtt.qtypes[f"qint{bits}"], axis=0, group_size=group_size)
    gt = qtt.quantize_weight(wt, qtt.qtypes[f"qint{bits}"], 0, st, shift=zt, group_size=group_size)
    for a, b in ((gt._data.packed_data, gj._data._data), (gt._scale, gj._scale), (gt._shift, gj._shift)):
        np.testing.assert_array_equal(bits_of(a), bits_of(b))
    hop = WeightQBitsHopperArray.from_generic(gt)
    assert hop is not None and hop.bits == bits
    return WeightQBitsTpuArray.from_generic(gj), hop


# --- the layout --------------------------------------------------------------------------------

GRID_N = [96, 128, 256, 384]
GRID_K = [128, 256, 384, 512, 768, 1024, 1536, 2048, 14336]


@pytest.mark.parametrize("group_size", [None, 64, 128, 256])
@pytest.mark.parametrize("bits", [2, 4])
def test_eligible_matches_tpu_layout(bits, group_size):
    for n in GRID_N:
        for k in GRID_K:
            want = WeightQBitsTpuArray.eligible((n, k), bits, group_size)
            assert WeightQBitsHopperArray.eligible((n, k), bits, group_size) == want, (n, k)
    assert not WeightQBitsHopperArray.eligible((256, 512), 8, group_size)


@pytest.mark.parametrize(
    "shape,dtype,group_size,zeropoint",
    [
        ((256, 1024), torch.float32, 128, False),
        ((128, 512), torch.bfloat16, 128, False),
        ((256, 512), torch.float32, None, False),
        ((256, 1024), torch.float32, 128, True),
    ],
)
def test_int2_hopper_layout_roundtrip(shape, dtype, group_size, zeropoint):
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32)).to(dtype)
    scale, shift = qtt.MaxOptimizer()(w, qtt.qint2, axis=0, group_size=group_size, zeropoint=zeropoint)
    generic = qtt.quantize_weight(w, qtt.qint2, 0, scale, shift=shift, group_size=group_size)
    hop = WeightQBitsHopperArray.from_generic(generic)
    assert hop is not None and hop.bits == 2 and hop._packed.shape == (shape[0], shape[1] // 4)
    torch.testing.assert_close(hop.dequantize(), generic.dequantize(), rtol=1e-6, atol=1e-6)
    back = hop.to_generic()
    np.testing.assert_array_equal(bits_of(back._data.packed_data), bits_of(generic._data.packed_data))
    np.testing.assert_array_equal(bits_of(back._scale), bits_of(generic._scale))
    if zeropoint:
        expected = (generic._scale.float() * generic._shift.float()).to(dtype)
        np.testing.assert_array_equal(bits_of(back._shift), bits_of(expected))
    else:
        np.testing.assert_array_equal(bits_of(back._shift), bits_of(generic._shift))


@pytest.mark.parametrize("position", [0, 1, 2, 3, "all"])
def test_int2_crumbs_of_three(position):
    """Code 3 in one crumb position of every byte (or in all four: bytes
    0xFF): the packed byte, the unpack, and the plain matmul's dequantized
    weight, through the generic layout and back."""
    N, Kd = 128, 512
    codes = torch.zeros((N, Kd), dtype=torch.uint8)
    if position == "all":
        codes[:] = 3
        byte = 0xFF
    else:
        codes[:, position::4] = 3
        byte = 3 << (2 * position)
    packed = K.pack_k_codes(codes, 2)
    assert packed.shape == (N, Kd // 4) and bool((packed == byte).all())
    assert torch.equal(K.unpack_k_codes(packed, 2), codes)
    scale_t = torch.full((Kd // GS, N), 0.5)
    shift_t = torch.full((Kd // GS, N), 0.75)
    hop = WeightQBitsHopperArray(packed, scale_t, shift_t, qtt.qint2, GS, (N, Kd), torch.float32)
    generic = hop.to_generic()
    np.testing.assert_array_equal(bits_of(WeightQBitsHopperArray.from_generic(generic)._packed), bits_of(packed))
    want = codes.float() * 0.5 - 0.75
    torch.testing.assert_close(hop.dequantize(), want, rtol=0, atol=0)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, Kd)).astype(np.float32))
    close(K.qbits_mm_small_m(x, packed, scale_t, shift_t, GS, 2), (x @ want.t()).numpy(), 1e-6)


# --- the float-x kernels: #1 and #2 ---------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "m", [8, 64, 512, 600, pytest.param((513, 256), id="513-gs256"), pytest.param((1024, 256), id="1024-gs256")]
)
def test_int2_plain_matches_pallas_interpret(m, dtype_name):
    m, gs = m if isinstance(m, tuple) else (m, GS)
    N, Kd = 256, 1024
    rng = np.random.default_rng(m + 2)
    w = rng.standard_normal((N, Kd)).astype(np.float32)
    x = rng.standard_normal((m, Kd)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype_name == "float32" else (jnp.bfloat16, torch.bfloat16)
    tpu, hop = weight_pair(w, 2, jdt, tdt, group_size=gs)
    ref = qbits_matmul_kernel_call(
        jnp.asarray(x).astype(jdt), tpu._packed, tpu._scale_t, tpu._shift_t, 2, gs, interpret=True
    )
    ref = np.asarray(ref.astype(jnp.float32))
    wrapper = K.qbits_mm_small_m if m <= K.MAX_M else K.qbits_mm_tiled
    before = (wrapper.launches, wrapper.launches_int2)
    out = wrapper(torch.from_numpy(x).to(tdt), hop._packed, hop._scale_t, hop._shift_t, gs, 2)
    assert (wrapper.launches, wrapper.launches_int2) == before  # a CPU tensor takes the plain version
    assert out.dtype == tdt and out.shape == (m, N)
    if dtype_name == "float32":
        close(out, ref)
    else:
        assert cosine(out, ref) > 1 - 1e-4


def forbid(monkeypatch, *names):
    """Replace the qlinear routes `names` with functions that fail when called."""
    for name in names:
        def refuse(*args, _name=name, **kw):
            raise AssertionError(f"{_name} was called")
        monkeypatch.setattr(QL, name, refuse)


@pytest.mark.parametrize("x_kind", ["float", "int8"])
def test_int2_above_1024_takes_no_kernel(monkeypatch, x_kind):
    """M = 1100: no kernel wrapper runs (JAX's `_prefill_route` returns None
    for int2 above M = 1024), and the result is JAX `qlinear`'s; M = 1024
    still reaches the kernels' router."""
    N, Kd = 256, 1024
    rng = np.random.default_rng(11)
    tpu, hop = weight_pair(rng.standard_normal((N, Kd)).astype(np.float32), 2)
    x = rng.standard_normal((1100, Kd)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if x_kind == "int8":
        sx = float(np.abs(x).max() / 127)
        xt = qtt.quantize_activation(xt, qtt.qint8, torch.tensor(sx))
        xj = qt.quantize_activation(xj, qt.qint8, jnp.asarray(sx, jnp.float32))
    ref = jax_qlinear(xj, tpu)
    forbid(monkeypatch, "qbits_mm", "qbits_int8_mm")
    close(QL.qlinear(xt, hop), ref)
    with pytest.raises(AssertionError, match="was called"):
        QL.qlinear(xt[:1024] if x_kind == "float" else qtt.quantize_activation(
            torch.from_numpy(x[:1024]), qtt.qint8, torch.tensor(sx)), hop)


def test_w2a8_plain_matches_pallas_interpret():
    """int8 x with int2 weights at M = 8: `_int8_kernel` in interpret mode
    against the port's router on a CPU tensor (its plain version)."""
    N, Kd, m = 256, 1024, 8
    rng = np.random.default_rng(3)
    tpu, hop = weight_pair(rng.standard_normal((N, Kd)).astype(np.float32), 2)
    xq = rng.integers(-128, 128, (m, Kd)).astype(np.int8)
    sx = np.float32(0.0173)
    ref = qbits_int8_matmul_kernel_call(
        jnp.asarray(xq), jnp.asarray(sx), tpu._packed, tpu._scale_t, tpu._shift_t, 2, GS, jnp.float32,
        interpret=True,
    )
    assert ref is not None
    out = K.qbits_int8_mm(
        torch.from_numpy(xq), torch.tensor(sx), hop._packed, hop._scale_t, hop._shift_t, GS, torch.float32,
        bits=2,
    )
    close(out, ref, 1e-5)


@pytest.mark.parametrize("m", [64, 512])
def test_w2a8_plain_matches_pallas_interpret_at_chunk_m(m):
    """int8 x with int2 weights at the serving engine's chunk M (a [1, 64]
    and an [8, 64] chunk): `_int8_kernel` in interpret mode against the
    port's router on a CPU tensor (its plain version), within the 1e-5 of
    the M = 8 case."""
    N, Kd = 256, 1024
    rng = np.random.default_rng(3 + m)
    tpu, hop = weight_pair(rng.standard_normal((N, Kd)).astype(np.float32), 2)
    xq = rng.integers(-128, 128, (m, Kd)).astype(np.int8)
    sx = np.float32(0.0173)
    ref = qbits_int8_matmul_kernel_call(
        jnp.asarray(xq), jnp.asarray(sx), tpu._packed, tpu._scale_t, tpu._shift_t, 2, GS, jnp.float32,
        interpret=True,
    )
    assert ref is not None
    before = (K.qbits_mm_int8_small_m.launches, K.qbits_mm_int8_small_m.launches_int2)
    out = K.qbits_int8_mm(
        torch.from_numpy(xq), torch.tensor(sx), hop._packed, hop._scale_t, hop._shift_t, GS, torch.float32,
        bits=2,
    )
    assert (K.qbits_mm_int8_small_m.launches, K.qbits_mm_int8_small_m.launches_int2) == before
    close(out, ref, 1e-5)


# --- the MoE kernels: #11-#15 ----------------------------------------------------------------------

E = 8
UNIQ = np.array([6, 1, 3, 0, 7, 4], np.int32)


@pytest.fixture(scope="module")
def experts():
    """8 int2 experts of one projection (N x K = 512 x 512), stacked on both sides."""
    rng = np.random.default_rng(4)
    pairs = [weight_pair(rng.standard_normal((512, 512)).astype(np.float32), 2) for _ in range(E)]
    j = tuple(jnp.stack([getattr(p[0], f) for p in pairs]) for f in ("_packed", "_scale_t", "_shift_t"))
    t = tuple(torch.stack([getattr(p[1], f) for p in pairs]) for f in ("_packed", "_scale_t", "_shift_t"))
    return j, t


@pytest.mark.parametrize("form", ["sel", "uniq", "prefill", "prefill-136", "all-16"])
def test_int2_moe_plain_matches_pallas(experts, form):
    """prefill-136: slabs of 136 rows, not a multiple of the Hopper GEMM's
    128-row M tile; all-16: every expert over 16 rows, TPU #12's form at a
    Mixtral decode step of 16 sequences."""
    jw, pw = experts
    rng = np.random.default_rng(5)
    eids = UNIQ
    if form == "sel":
        x = rng.standard_normal((2, 512)).astype(np.float32)
        eids = np.array([3, 5], np.int32)
        ref = jax_moe.qbits_moe_sel_call(jnp.asarray(x), jnp.asarray(eids), *jw, 2, GS, interpret=True)
        out = moe_mm.qbits_moe_sel(torch.from_numpy(x), torch.from_numpy(eids), *pw, GS, 2)
    elif form == "uniq":
        x = rng.standard_normal((8, 512)).astype(np.float32)
        ref = jax_moe.qbits_moe_all_call(jnp.asarray(x), *jw, 2, GS, eids=jnp.asarray(eids), interpret=True)
        out = moe_mm.qbits_moe_all(torch.from_numpy(x), *pw, GS, 2, eids=torch.from_numpy(eids))
    elif form == "all-16":
        x = rng.standard_normal((16, 512)).astype(np.float32)
        ref = jax_moe.qbits_moe_all_call(jnp.asarray(x), *jw, 2, GS, interpret=True)
        out = moe_mm.qbits_moe_all(torch.from_numpy(x), *pw, GS, 2)
    else:
        cap = 136 if form == "prefill-136" else 8
        x = rng.standard_normal((len(eids), cap, 512)).astype(np.float32)
        ref = jax_moe.qbits_moe_prefill_call(jnp.asarray(x), *jw, 2, GS, eids=jnp.asarray(eids), interpret=True)
        out = moe_mm.qbits_moe_prefill(torch.from_numpy(x), *pw, GS, 2, eids=torch.from_numpy(eids))
    assert ref is not None and out.dtype == torch.float32
    close(out, ref, 1e-5)


def test_stacked_experts_share_their_width():
    """A stacked projection takes one code width; mixed widths raise."""
    rng = np.random.default_rng(6)
    ws = [weight_pair(rng.standard_normal((512, 512)).astype(np.float32), b)[1] for b in (2, 4)]
    from quanto_tpu_torch.parallel.moe import _StackedProj

    assert _StackedProj([ws[0], ws[0]]).operands()[-1] == 2
    with pytest.raises(ValueError, match="bits"):
        _StackedProj(ws)


# --- the models ------------------------------------------------------------------------------------

B, T, NEW, S = 2, 16, 4, 24
LAST = np.array([15, 9])
DECODE_POS = np.array([16, 11])
LLAMA = dict(
    vocab_size=512, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, rope_theta=500000.0,
)
MIXTRAL = dict(
    vocab_size=512, hidden_size=512, intermediate_size=512, num_hidden_layers=1,
    num_attention_heads=4, num_key_value_heads=2, rope_theta=1e6, rms_norm_eps=1e-5,
    num_local_experts=8, num_experts_per_tok=2,
)

def jax_reference(model, ids: np.ndarray) -> dict:
    """Cached-prefill logits at `LAST`, one decode step at `DECODE_POS`, the
    routing of every MoE block call of those two forwards, 4 greedy tokens."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxMoeBlock, "__call__", recording_call)
        out, routing = jax_steps(
            model, jnp.asarray(ids), jax_init_kv_cache(model.config, B, S), jnp.asarray(LAST),
            jnp.asarray(DECODE_POS),
        )
    out = {k: np.asarray(v) for k, v in out.items()}
    if routing:
        margin = min(float(gap) for _, gap in routing)
        assert margin >= 1e-5, f"a near tie in the routing: {margin}"
    out["top_i"] = [np.asarray(i) for i, _ in routing]
    out["tokens"] = np.asarray(jax_generate(model, jnp.asarray(ids), NEW))
    out["state"] = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    return out


def port_check(model, ids: np.ndarray, ref: dict) -> None:
    """The port's outputs against `jax_reference`'s, routing first."""
    top_i = []
    blocks = [m for m in model.modules() if isinstance(m, StackedSparseMoeBlock)]
    hooks = [b.register_forward_pre_hook(lambda b, a: top_i.append(route(b.gate, a[0], b.top_k)[0].numpy()))
             for b in blocks]
    idt = torch.from_numpy(ids)
    with torch.no_grad():
        cache = init_kv_cache(model.config, B, S, device="cpu")
        prefill, cache = model(idt, cache, 0, logits_indices=torch.from_numpy(LAST))
        step, _ = model(idt[:, :1], cache, torch.from_numpy(DECODE_POS))
    for h in hooks:
        h.remove()
    assert len(top_i) == len(ref["top_i"])
    for a, b in zip(top_i, ref["top_i"]):
        np.testing.assert_array_equal(a, b)
    close(prefill, ref["prefill"])
    close(step, ref["step"])
    np.testing.assert_array_equal(generate(model, idt, NEW).numpy(), ref["tokens"])


def check_codes(model, state: dict, want_bits: dict) -> None:
    """Every quantized linear (stacked experts through their source weights'
    names are not kept, so those are checked by `want_bits` only): its width,
    its layout, and its codes, scales and shifts bit for bit against JAX's."""
    for name, m in model.named_modules():
        if not isinstance(m, QLinear):
            continue
        w = m.weight
        bits = next(b for pat, b in want_bits.items() if pat in name)
        assert w.qtype.bits == bits, name
        if "gate" in name and "proj" not in name:
            continue  # the router (N = 8) stays generic
        assert isinstance(w, WeightQBitsHopperArray), name
        g = w.to_generic()
        for key, t in (("weight._data._data", g._data.packed_data), ("weight._scale", g._scale),
                       ("weight._shift", g._shift)):
            np.testing.assert_array_equal(bits_of(t), bits_of(state[f"{name}.{key}"]), err_msg=name)


def test_tiny_llama_qint2_matches():
    ids = np.random.default_rng(0).integers(0, LLAMA["vocab_size"], (B, T)).astype(np.int32)
    jmodel = JaxLlama(JaxLlamaConfig(**LLAMA), rngs=nnx.Rngs(0))
    state = {k: np.asarray(v) for k, v in hf_state_dict(jmodel).items()}
    qt.quantize(jmodel, weights="qint2", exclude="lm_head")
    qt.freeze(jmodel)
    ref = jax_reference(jmodel, ids)

    model = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu")
    assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
    qtt.quantize(model, weights="qint2", exclude="lm_head")
    qtt.freeze(model)
    to_hopper(model)
    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    assert len(qlinears) == 7 * LLAMA["num_hidden_layers"] and not isinstance(model.lm_head, QLinear)
    check_codes(model, ref["state"], {"": 2})
    port_check(model, ids, ref)


def test_tiny_mixtral_qint2_experts_matches():
    """qint2 experts, qint4 attention and router, lm_head float; stacked."""
    ids = np.random.default_rng(0).integers(0, MIXTRAL["vocab_size"], (B, T)).astype(np.int32)
    jmodel = JaxMixtral(JaxMixtralConfig(**MIXTRAL), rngs=nnx.Rngs(1))
    state = {k: np.asarray(v) for k, v in hf_state_dict(jmodel).items()}
    qt.quantize(jmodel, weights="qint2", include="*experts*")
    qt.quantize(jmodel, weights="qint4", exclude="lm_head")
    qt.freeze(jmodel)
    ref = jax_reference(jmodel, ids)

    model = MixtralForCausalLM(MixtralConfig(**MIXTRAL), device="cpu")
    assert load_hf_state_dict(model, state) == {"missing": [], "unexpected": []}
    qtt.quantize(model, weights="qint2", include="*experts*")
    qtt.quantize(model, weights="qint4", exclude="lm_head")
    qtt.freeze(model)
    to_hopper(model)
    check_codes(model, ref["state"], {"experts": 2, "": 4})
    assert convert_moe_to_stacked(model, capacity_factor=None) == MIXTRAL["num_hidden_layers"]
    block = model.model.layers[0].block_sparse_moe
    assert [p.bits for p in (block.proj_gate, block.proj_up, block.proj_down)] == [2, 2, 2]
    port_check(model, ids, ref)
