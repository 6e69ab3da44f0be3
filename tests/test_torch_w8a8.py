"""W8A8 (8-bit weights, 8-bit activations) of quanto_tpu_torch against quanto_tpu.

- `qbytes_int_mm` (int8 x int8) bit for bit against JAX's on seeded codes,
  per-channel and per-tensor scales, at M in {1, 4, 17, 64} and a K that is
  no multiple of 8 (the card's `torch._int_mm` would refuse it: the plain
  version, which a CPU tensor always takes, is the same formula).
- The fp8 formula (`qbytes_mm` of two e4m3fn payloads) against JAX's
  `qbytes_mm`, which takes its convert formula on the CPU: exact products,
  float32 sums in another order, so within 1e-5 * max|ref|.
- `qlinear`'s W8A8 routes against JAX's `qlinear`: int8 weights with int8
  activations bit for bit, e4m3fn with e4m3fn and the mixed pairs (int8
  activations with e4m3fn weights, e4m3fn activations with int8 weights)
  within 1e-5 * max|ref|; every output float32, as JAX's (the combined scale
  x.scale * w.scale is float32).
- A tiny Llama, qint8 weights and qint8 activations, calibrated by JAX and
  carried over (float weights and activation scales bit for bit), frozen:
  cached prefill logits and a per-row decode step against JAX within
  1e-3 * max|ref|, and 8 greedy tokens identical. The hidden state is
  float32 after the first W8A8 linear in both packages; the lm_head (bf16
  excluded from quantization) meets it in float32.
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
from quanto_tpu.models.serve import generate as jax_generate
from quanto_tpu.ops.qbytes_mm import qbytes_int_mm as jax_qbytes_int_mm
from quanto_tpu.ops.qbytes_mm import qbytes_mm as jax_qbytes_mm
from quanto_tpu.ops.qlinear import qlinear as jax_qlinear
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from quanto_tpu_torch.models.loading import load_hf_state_dict
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.ops import qbytes_mm as QB
from quanto_tpu_torch.ops.qlinear import qlinear
from quanto_tpu_torch.tensor.weights import WeightQBytesArray

from .test_torch_llama import B, NEW, TINY, close, generate, jax_steps, port_steps
from .test_torch_quantize import bits_of

W8A8 = dict(weights="qint8", activations="qint8", exclude="lm_head")
CAL_BATCHES = [np.random.default_rng(20 + i).integers(0, TINY["vocab_size"], (B, 16)) for i in range(2)]
IDS = np.random.default_rng(1).integers(0, TINY["vocab_size"], (B, 16))


def to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("m", [1, 4, 17, 64])
@pytest.mark.parametrize("per_tensor", [False, True], ids=["per_channel", "per_tensor"])
def test_qbytes_int_mm_bit_for_bit(m, per_tensor):
    g = torch.Generator().manual_seed(m)
    for K, N in ((256, 384), (260, 96)):
        x = torch.randint(-128, 128, (m, K), dtype=torch.int8, generator=g)
        w = torch.randint(-127, 128, (N, K), dtype=torch.int8, generator=g)
        ws = (torch.rand((N, 1), generator=g) * 0.01 + 1e-3).to(torch.bfloat16)
        s = torch.tensor(0.0173) * (ws.float()[0, 0] if per_tensor else ws.float())
        out = QB.qbytes_int_mm(x, w, s)
        ref = np.asarray(jax_qbytes_int_mm(to_jax(x), to_jax(w), to_jax(s)))
        assert out.dtype == torch.float32 and out.shape == (m, N)
        np.testing.assert_array_equal(bits_of(out), bits_of(torch.from_numpy(np.array(ref))))
        assert QB.int_mm_eligible(K, N) == (K % 8 == 0)


@pytest.mark.parametrize("m", [1, 4, 33])
def test_fp8_formula_matches_jax(m):
    g = torch.Generator().manual_seed(100 + m)
    K, N = 256, 384
    x = (torch.randn((m, K), generator=g) * 40).to(torch.float8_e4m3fn)
    w = (torch.randn((N, K), generator=g) * 40).to(torch.float8_e4m3fn)
    s = torch.tensor(0.0173) * (torch.rand((N, 1), generator=g) * 0.01 + 1e-3).to(torch.bfloat16).float()
    out = QB.qbytes_mm(x, w, s)
    ref = np.asarray(jax_qbytes_mm(to_jax(x), to_jax(w), to_jax(s)))
    assert out.dtype == torch.float32
    close(out, ref, 1e-5)
    np.testing.assert_array_equal(bits_of(QB.qbytes_fp8_mm(x, w, s)), bits_of(out))


def test_fp8_card_route_is_the_convert_formula(monkeypatch):
    """On a CUDA tensor e4m3fn x e4m3fn takes `_fp8_dot`, JAX's convert
    formula with the operands in bf16 (float32 sums), counted, and never
    `torch._scaled_mm`: bf16 holds every e4m3fn value (NaN codes stay NaN),
    `_fp8_dot` equals the plain float32 formula bit for bit on the CPU, and a
    tensor that reports itself on the card is routed there."""
    codes = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn)
    f32, b16 = codes.float(), codes.to(torch.bfloat16).float()
    assert torch.equal(f32.isnan(), b16.isnan()) and int(f32.isnan().sum()) == 2
    assert torch.equal(f32[~f32.isnan()], b16[~b16.isnan()])
    g = torch.Generator().manual_seed(9)
    x = (torch.randn((17, 256), generator=g) * 40).to(torch.float8_e4m3fn)
    w = (torch.randn((384, 256), generator=g) * 40).to(torch.float8_e4m3fn)
    s = torch.rand((384, 1), generator=g) * 1e-3
    plain = QB.qbytes_fp8_mm_plain(x, w)
    np.testing.assert_array_equal(bits_of(QB._fp8_dot(x, w)), bits_of(plain))

    class OnCard(torch.Tensor):
        is_cuda = True

    def scaled_mm(*args, **kw):
        raise AssertionError("the e4m3fn route called torch._scaled_mm")

    seen = []
    monkeypatch.setattr(QB, "_fp8_dot", lambda a, b: seen.append(type(a)) or QB.qbytes_fp8_mm_plain(a, b))
    monkeypatch.setattr(torch, "_scaled_mm", scaled_mm)
    before = QB.qbytes_fp8_mm.launches
    out = QB.qbytes_mm(x.as_subclass(OnCard), w.as_subclass(OnCard), s)
    assert seen == [OnCard] and QB.qbytes_fp8_mm.launches == before + 1
    np.testing.assert_array_equal(bits_of(out.as_subclass(torch.Tensor)), bits_of(plain * s.t()))


def quantized_pairs(wq: str, xq: str, m: int):
    """(port x, port w, JAX x, JAX w): a seeded float weight [384, 256] and
    activation [m, 256] quantized alike in both packages."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((384, 256)).astype(np.float32)
    x = rng.standard_normal((2, m, 256)).astype(np.float32)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    st = qtt.AbsmaxOptimizer()(wt, qtt.qtypes[wq], 0)
    sj = qt.AbsmaxOptimizer()(wj, qt.qtypes[wq], 0)
    np.testing.assert_array_equal(bits_of(st), bits_of(sj))
    qw_t = qtt.quantize_weight(wt, qtt.qtypes[wq], 0, st)
    qw_j = qt.quantize_weight(wj, qt.qtypes[wq], 0, sj)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xs = np.float32(np.abs(x).max() / 200)
    qx_t = qtt.quantize_activation(xt, qtt.qtypes[xq], torch.tensor(xs))
    qx_j = qt.quantize_activation(jnp.asarray(x).astype(jnp.bfloat16), qt.qtypes[xq], jnp.float32(xs))
    return qx_t, qw_t, qx_j, qw_j


@pytest.mark.parametrize("m", [1, 20])
@pytest.mark.parametrize(
    "wq,xq", [("qint8", "qint8"), ("qfloat8_e4m3fn", "qfloat8_e4m3fn"), ("qfloat8_e4m3fn", "qint8"),
              ("qint8", "qfloat8_e4m3fn")],
)
def test_qlinear_w8a8_routes_match_jax(wq, xq, m):
    qx_t, qw_t, qx_j, qw_j = quantized_pairs(wq, xq, m)
    assert isinstance(qw_t, WeightQBytesArray)
    bias = torch.linspace(-1, 1, 384).to(torch.bfloat16)
    out = qlinear(qx_t, qw_t, bias)
    ref = np.asarray(jax_qlinear(qx_j, qw_j, to_jax(bias)))
    assert out.dtype == torch.float32 and str(ref.dtype) == "float32" and out.shape == (2, m, 384)
    if wq == xq == "qint8":
        np.testing.assert_array_equal(bits_of(out), bits_of(torch.from_numpy(np.array(ref))))
    else:
        close(out, ref, 1e-5)


@pytest.fixture(scope="module")
def jax_w8a8():
    """JAX's calibrated W8A8 tiny Llama: its float state, activation scales,
    streamline flags, and its outputs once frozen."""
    model = JaxLlama(JaxLlamaConfig(**TINY), rngs=nnx.Rngs(0))
    float_state = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    qt.quantize(model, **W8A8)
    qt.calibrate_jit(model, [jnp.asarray(b, jnp.int32) for b in CAL_BATCHES])
    flags = {n: m.quantize_outputs for n, m in qt.named_qmodules(model)}
    scales = {k: np.asarray(v) for k, v in hf_state_dict(model).items() if k.endswith("_scale")}
    qt.freeze(model)
    out = jax_steps(model, IDS)
    out["tokens"] = np.asarray(jax_generate(model, jnp.asarray(IDS, jnp.int32), NEW))
    return float_state, scales, flags, out


def test_w8a8_llama_matches_jax(jax_w8a8):
    float_state, scales, flags, out = jax_w8a8
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    assert load_hf_state_dict(model, float_state) == {"missing": [], "unexpected": []}
    qtt.quantize(model, **W8A8)
    assert load_hf_state_dict(model, scales)["unexpected"] == []
    for name, m in qtt.named_qmodules(model):
        m.quantize_outputs = flags[name]
    qtt.freeze(model)
    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    assert len(qlinears) == 7 * TINY["num_hidden_layers"]
    assert all(isinstance(m.weight, WeightQBytesArray) and m.weight.qtype == qtt.qint8 for m in qlinears)
    got = port_steps(model, IDS)
    assert got["prefill"].dtype == torch.float32
    close(got["prefill"], out["prefill"], 1e-3)
    close(got["step"], out["step"], 1e-3)
    np.testing.assert_array_equal(generate(model, torch.from_numpy(IDS), NEW).numpy(), out["tokens"])
