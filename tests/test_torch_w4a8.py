"""W4A8 (int4 weights, int8 activations) of quanto_tpu_torch against quanto_tpu.

- The plain version behind the two W4A8 kernels (a CPU tensor takes it)
  against `qbits_int8_matmul_kernel_call(..., interpret=True)` from the same
  codes: M in {1, 4, 33} runs JAX's `_int8_kernel`, M = 520 the integer arm
  of `_prefill_kernel`, and so do M = 513 and 1030 at group size 256 (both
  sides of the Hopper GEMM's 128-row tiles). Tolerance 1e-5 * max|ref|: the integer part of each
  group is exact in float32 (127 * 15 * 128 < 2**24), only the order of the
  float32 sums over groups differs.
- `Calibration` on the tiny Llama: input and output scales within float32
  rounding of JAX's on the same batches (the activations they are taken
  from are float32 sums in another order), and the same streamline flags.
- The calibrated tiny Llama, its float weights and activation scales carried
  over by `load_hf_state_dict` (the scales bit for bit), then frozen:
  logits, cached prefill, a per-row decode step and 8 greedy tokens against
  `quanto_tpu`, in the generic layout (x dequantized, as JAX on the CPU
  does) and the Hopper layout (the W4A8 kernels' plain versions), and the
  Hopper layout against JAX with `set_backend(pallas_qbits=True)` (its int8
  kernels in interpret mode). Logits within 1e-3 * max|ref|, tokens
  identical. An activation within one float32 ulp of a rounding half can
  take another int8 code in either package, and one code a step away in a
  key moves these tiny model's logits by up to 3e-2 * max|ref|: JAX's own
  default and Pallas paths differ so on most prompt seeds. The prompts use
  a seed on which no code moves; there the packages agree within 1e-6.
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
from quanto_tpu.models.loading import load_hf_state_dict as jax_load_hf_state_dict
from quanto_tpu.models.serve import generate as jax_generate
from quanto_tpu.ops import config as jax_ops_config
from quanto_tpu.ops.pallas.qbits_mm import qbits_int8_matmul_kernel_call
from quanto_tpu.tensor.weights import WeightQBitsTpuArray
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from quanto_tpu_torch.models.loading import load_hf_state_dict
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.ops.cuda.qbits_mm import (
    MAX_M,
    qbits_mm_int8_small_m,
    qbits_mm_tiled_int8,
)
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

from .test_torch_llama import B, NEW, T, TINY, close, generate, jax_steps, port_steps
from .test_torch_quantize import bits_of

W4A8 = dict(weights="qint4", activations="qint8", exclude="lm_head")
CAL_BATCHES = [np.random.default_rng(20 + i).integers(0, TINY["vocab_size"], (B, 16)) for i in range(2)]
TOL = 1e-3


@pytest.mark.parametrize(
    "m", [1, 4, 33, 64, 512, 520, pytest.param((513, 256), id="513-gs256"), pytest.param((1030, 256), id="1030-gs256")]
)
def test_plain_matches_pallas_interpret(m):
    m, gs = m if isinstance(m, tuple) else (m, 128)
    N, K = 256, 1024
    rng = np.random.default_rng(m)
    w = rng.standard_normal((N, K)).astype(np.float32)
    xq = rng.integers(-128, 128, (m, K), dtype=np.int8)
    sx = np.float32(0.0173)

    wj = jnp.asarray(w)
    sj, zj = qt.MaxOptimizer()(wj, qt.qint4, axis=0, group_size=gs)
    tpu = WeightQBitsTpuArray.from_generic(qt.quantize_weight(wj, qt.qint4, 0, sj, shift=zj, group_size=gs))
    ref = qbits_int8_matmul_kernel_call(
        jnp.asarray(xq), jnp.asarray(sx), tpu._packed, tpu._scale_t, tpu._shift_t, 4, gs,
        jnp.float32, interpret=True,
    )
    assert ref is not None

    wt = torch.from_numpy(w)
    st, zt = qtt.MaxOptimizer()(wt, qtt.qint4, axis=0, group_size=gs)
    hop = WeightQBitsHopperArray.from_generic(qtt.quantize_weight(wt, qtt.qint4, 0, st, shift=zt, group_size=gs))
    wrapper = qbits_mm_int8_small_m if m <= MAX_M else qbits_mm_tiled_int8
    before = wrapper.launches
    out = wrapper(
        torch.from_numpy(xq), torch.tensor(sx), hop._packed, hop._scale_t, hop._shift_t, gs, torch.float32
    )
    assert wrapper.launches == before  # a CPU tensor takes the plain version: no launch
    assert out.dtype == torch.float32 and out.shape == (m, N)
    close(out, ref, 1e-5)


def test_wrapper_refusals():
    hop_shape = dict(packed=torch.zeros((128, 256), dtype=torch.uint8),
                     scale_t=torch.ones((4, 128)), shift_t=torch.zeros((4, 128)))
    args = (hop_shape["packed"], hop_shape["scale_t"], hop_shape["shift_t"], 128, torch.float32)
    with pytest.raises(TypeError, match="int8"):
        qbits_mm_int8_small_m(torch.zeros((4, 512)), torch.tensor(1.0), *args)
    with pytest.raises(ValueError, match="sx"):
        qbits_mm_int8_small_m(torch.zeros((4, 512), dtype=torch.int8), torch.ones(2), *args)
    with pytest.raises(ValueError, match="M <="):
        qbits_mm_int8_small_m(torch.zeros((MAX_M + 1, 512), dtype=torch.int8), torch.tensor(1.0), *args)


# The prompts: a seed on which no activation code moves between the packages
# (module docstring).
IDS = np.random.default_rng(1).integers(0, TINY["vocab_size"], (B, T))


@pytest.fixture(scope="module")
def jax_w4a8():
    """The calibrated JAX model's scales, flags and state, and its outputs once
    frozen: with the default backend (x dequantized on the CPU) and with the
    Pallas int8 kernels forced on (interpret mode)."""
    model = JaxLlama(JaxLlamaConfig(**TINY), rngs=nnx.Rngs(0))
    float_state = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    qt.quantize(model, **W4A8)
    # JAX's Calibration with each batch's forward jitted (eager JAX is slow here).
    qt.calibrate_jit(model, [jnp.asarray(b, jnp.int32) for b in CAL_BATCHES])
    qmods = dict(qt.named_qmodules(model))
    scales = {n: (np.asarray(m.input_scale.get_value()), np.asarray(m.output_scale.get_value()))
              for n, m in qmods.items()}
    flags = {n: m.quantize_outputs for n, m in qmods.items()}
    cal_state = {k: np.asarray(v) for k, v in hf_state_dict(model).items()}
    qt.freeze(model)
    out = jax_steps(model, IDS)
    out["tokens"] = np.asarray(jax_generate(model, jnp.asarray(IDS, jnp.int32), NEW))

    kernel_model = JaxLlama(JaxLlamaConfig(**TINY), rngs=nnx.Rngs(1))
    qt.quantize(kernel_model, **W4A8)
    assert jax_load_hf_state_dict(kernel_model, cal_state)["missing"] == []
    for n, m in qt.named_qmodules(kernel_model):
        m.quantize_outputs = flags[n]
    jax_ops_config.set_backend(pallas_qbits=True)
    try:
        qt.freeze(kernel_model)
        kernel_out = jax_steps(kernel_model, IDS)
    finally:
        jax_ops_config.set_backend()
    return float_state, scales, flags, cal_state, out, kernel_out


def port_calibrated(cal_state, flags, layout):
    """The port's W4A8 model from JAX's calibrated state, frozen in `layout`."""
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    qtt.quantize(model, **W4A8)
    report = load_hf_state_dict(model, cal_state)
    assert report == {"missing": [], "unexpected": []}
    for name, m in qtt.named_qmodules(model):
        for key in ("input_scale", "output_scale"):
            np.testing.assert_array_equal(bits_of(getattr(m, key)), bits_of(cal_state[f"{name}.{key}"]))
        m.quantize_outputs = flags[name]
    qtt.freeze(model)
    if layout == "hopper":
        for m in model.modules():
            if isinstance(m, QLinear):
                m.weight = WeightQBitsHopperArray.from_generic(m.weight)
                assert m.weight is not None
    return model


def test_calibration_matches(jax_w4a8):
    float_state, scales, flags, _, _, _ = jax_w4a8
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    load_hf_state_dict(model, float_state)
    qtt.quantize(model, **W4A8)
    with qtt.Calibration(model):
        for batch in CAL_BATCHES:
            model(torch.from_numpy(batch))
    qmods = dict(qtt.named_qmodules(model))
    assert sorted(qmods) == sorted(scales) and len(qmods) == 7 * TINY["num_hidden_layers"]
    for name, m in qmods.items():
        assert m.quantize_outputs == flags[name] is False  # every output is dequantized: streamlined away
        assert not m.calibrating and m._calibration is None
        for got, want in zip((m.input_scale, m.output_scale), scales[name]):
            assert got.dtype == torch.float32 and got.dim() == 0
            # While calibrating, outputs go through int8 codes; one code that
            # moves a step (module docstring) moves a later absmax by up to a
            # few 1e-4 of it. Layer 0, upstream of any such step, agrees to 1e-6.
            rtol = 1e-6 if name.startswith("model.layers.0.") else 1e-3
            np.testing.assert_allclose(got.numpy(), want, rtol=rtol)


@pytest.mark.parametrize("layout", ["generic", "hopper"])
def test_w4a8_model_matches(jax_w4a8, layout):
    _, _, flags, cal_state, out, kernel_out = jax_w4a8
    model = port_calibrated(cal_state, flags, layout)
    got = port_steps(model, IDS)
    refs = [out] if layout == "generic" else [out, kernel_out]  # the latter: JAX's W4A8 kernels
    for ref in refs:
        close(got["prefill"], ref["prefill"], TOL)
        close(got["step"], ref["step"], TOL)
    np.testing.assert_array_equal(generate(model, torch.from_numpy(IDS), NEW).numpy(), out["tokens"])
