"""8-bit weights and activations of quanto_tpu_torch against quanto_tpu.

- Symmetric codes, `AbsmaxOptimizer` scales and `WeightQBytesArray` fields,
  bit for bit: qint8, qfloat8_e4m3fn and qfloat8_e5m2; per axis and per
  tensor; float32 and bfloat16 bases.
- `quantize_activation` codes, bit for bit.
- The plain version behind the 8-bit weight-only kernel (a CPU tensor takes
  it) against `qbytes_matmul_kernel_call` and `qbytes_fp8_matmul_kernel_call`
  run in interpret mode (M from 1 to 256, the engine's chunk M = 64 and 128
  among them), and the port's `qlinear` beyond the kernel's envelope against
  JAX's `qbytes_mm`. Tolerance 1e-5 * max|ref| in float32: only the order of
  the float32 sums differs.
- e4m3fn NaN codes (0x7F, 0xFF): NaN through the port's `qlinear` and JAX's,
  inside the kernel's envelope and outside it; only the dormant Pallas kernel
  gives a finite value there.

The CUDA kernel itself is held against its plain version on the card by
`tests/test_torch_gpu_kernels.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.ops.pallas.qbytes_mm import qbytes_fp8_matmul_kernel_call, qbytes_matmul_kernel_call
from quanto_tpu.ops.qbytes_mm import qbytes_mm as jax_qbytes_mm
from quanto_tpu.ops.qlinear import qlinear as jax_qlinear
from quanto_tpu.ops.quantize import quantize_symmetric as jax_quantize_symmetric
from quanto_tpu.tensor.activations import quantize_activation as jax_quantize_activation
from quanto_tpu_torch.ops.cuda import qbytes_mm as K
from quanto_tpu_torch.ops.qlinear import qlinear
from quanto_tpu_torch.ops.quantize import quantize_symmetric

from .test_torch_quantize import bits_of, inputs

QTYPES = ["qint8", "qfloat8_e4m3fn", "qfloat8_e5m2"]


def codes_of(a) -> np.ndarray:
    """Bit pattern of int8 or float8 codes, as numpy uint8."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("axis", [0, -1, None])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("qtype_name", QTYPES)
def test_symmetric_codes_and_scales_match(qtype_name, dtype_name, axis):
    xj, xt = inputs((128, 256), dtype_name, 3)
    qj, qtq = qt.qtypes[qtype_name], qtt.qtypes[qtype_name]
    sj = qt.AbsmaxOptimizer()(xj, qj, axis)
    st = qtt.AbsmaxOptimizer()(xt, qtq, axis)
    assert st.dtype == xt.dtype and tuple(st.shape) == tuple(sj.shape)
    np.testing.assert_array_equal(bits_of(st), bits_of(sj))
    np.testing.assert_array_equal(
        codes_of(quantize_symmetric(xt, qtq, axis, st)), codes_of(jax_quantize_symmetric(xj, qj, axis, sj))
    )
    if axis is not None:
        wj = qt.quantize_weight(xj, qj, axis, sj)
        wt = qtt.quantize_weight(xt, qtq, axis, st)
        assert isinstance(wt, qtt.WeightQBytesArray) and wt.axis == wj.axis
        np.testing.assert_array_equal(codes_of(wt._data), codes_of(wj._data))
        np.testing.assert_array_equal(bits_of(wt._scale), bits_of(wj._scale))
        np.testing.assert_array_equal(
            bits_of(wt.dequantize()), bits_of(wj.dequantize())
        )


def test_quantize_weight_8bit_rules():
    """A size-1 axis collapses to per-tensor; shift and group size are refused."""
    w = torch.randn((1, 64), generator=torch.Generator().manual_seed(0))
    scale = qtt.AbsmaxOptimizer()(w, qtt.qint8, 0)
    assert scale.dim() == 0
    assert qtt.quantize_weight(w, qtt.qint8, 0, scale).axis is None
    with pytest.raises(ValueError, match="shift"):
        qtt.quantize_weight(w, qtt.qint8, 0, scale, shift=scale)
    with pytest.raises(ValueError, match="group_size"):
        qtt.quantize_weight(w, qtt.qint8, 0, scale, group_size=32)
    with pytest.raises(ValueError, match="scalar"):
        quantize_symmetric(w, qtt.qint8, None, torch.ones(64))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("qtype_name", ["qint8", "qfloat8_e4m3fn"])
def test_quantize_activation_codes_match(qtype_name, dtype_name):
    xj, xt = inputs((4, 16, 256), dtype_name, 4)
    qj, qtq = qt.qtypes[qtype_name], qtt.qtypes[qtype_name]
    sj = qt.absmax_scale(xj, qj)
    st = qtt.absmax_scale(xt, qtq)
    np.testing.assert_array_equal(bits_of(st), bits_of(sj))
    aj = jax_quantize_activation(xj, qj, jnp.asarray(sj, jnp.float32))
    at = qtt.quantize_activation(xt, qtq, st.float())
    assert at._scale.dim() == 0 and at.float_dtype == xt.dtype
    np.testing.assert_array_equal(codes_of(at._data), codes_of(aj._data))
    np.testing.assert_array_equal(bits_of(at.dequantize()), bits_of(aj.dequantize()))


def close(out: torch.Tensor, ref, tol: float = 1e-5) -> None:
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * np.max(np.abs(ref))


def quantized_pair(qtype_name, shape=(256, 512), seed=5):
    """(jax WeightQBytesArray, port WeightQBytesArray) of one seeded float32 weight."""
    wj, wt = inputs(shape, "float32", seed)
    qj, qtq = qt.qtypes[qtype_name], qtt.qtypes[qtype_name]
    return (
        qt.quantize_weight(wj, qj, 0, qt.AbsmaxOptimizer()(wj, qj, 0)),
        qtt.quantize_weight(wt, qtq, 0, qtt.AbsmaxOptimizer()(wt, qtq, 0)),
    )


@pytest.mark.parametrize("m", [1, 4, 9, 64, 128, 256])
@pytest.mark.parametrize("qtype_name", ["qint8", "qfloat8_e4m3fn"])
def test_plain_matches_pallas_interpret(qtype_name, m):
    wj, wt = quantized_pair(qtype_name)
    xj, xt = inputs((m, 512), "float32", m)
    call = qbytes_matmul_kernel_call if qtype_name == "qint8" else qbytes_fp8_matmul_kernel_call
    ref = call(xj, wj._data, wj._scale, interpret=True)
    assert ref is not None
    wrapper = K.qbytes_mm_int8 if qtype_name == "qint8" else K.qbytes_mm_e4m3fn
    before = wrapper.launches
    assert K.eligible(xt, wt._data, wt._scale)
    out = wrapper(xt, wt._data, wt._scale)
    assert wrapper.launches == before  # a CPU tensor takes the plain version: no launch
    assert out.dtype == xt.dtype
    close(out, ref)
    close(qlinear(xt, wt), ref)  # the module path routes to the same wrapper


@pytest.mark.parametrize(
    "qtype_name,m,dtype_name",
    [
        pytest.param("qint8", 300, "float32", id="qint8-300"),
        pytest.param("qfloat8_e4m3fn", 300, "float32", id="qfloat8_e4m3fn-300"),
        pytest.param("qfloat8_e5m2", 4, "float32", id="qfloat8_e5m2-4"),
        pytest.param("qint8", 300, "bfloat16", id="qint8-300-bf16"),
    ],
)
def test_outside_envelope_matches_jax_qbytes_mm(qtype_name, m, dtype_name):
    """Prefill M > 256 and the e5m2 payload take JAX's XLA formula. In a bf16
    model (x [300, 1024] and the weight's scale bf16) the product stays in
    float32 until after the scale, as JAX's `preferred_element_type` keeps
    it: the outputs are JAX's bit for bit but for at most 0.01 %, each within
    one bf16 ulp (float32 sums in another order can round the other way)."""
    k = 512 if dtype_name == "float32" else 1024
    wj, wt = quantized_pair(qtype_name, shape=(256, k))
    if dtype_name == "bfloat16":
        wj, wt = (qt.quantize_weight(wj.dequantize(), qt.qint8, 0, wj._scale.astype(jnp.bfloat16)),
                  qtt.quantize_weight(wt.dequantize(), qtt.qint8, 0, wt._scale.to(torch.bfloat16)))
        np.testing.assert_array_equal(codes_of(wt._data), codes_of(wj._data))
    xj, xt = inputs((m, k), dtype_name, m)
    assert not K.eligible(xt, wt._data, wt._scale)
    counts = (K.qbytes_mm_int8.launches, K.qbytes_mm_e4m3fn.launches)
    out, ref = qlinear(xt, wt), jax_qbytes_mm(xj, wj._data, wj._scale)
    assert (K.qbytes_mm_int8.launches, K.qbytes_mm_e4m3fn.launches) == counts
    if dtype_name == "float32":
        close(out, ref)
        return
    assert out.dtype == torch.bfloat16
    o, r = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    differ = o != r
    assert differ.mean() <= 1e-4, differ.mean()
    ulp = np.exp2(np.floor(np.log2(np.abs(r[differ]))) - 7)
    assert np.all(np.abs(o[differ] - r[differ]) <= ulp)


@pytest.mark.parametrize("m", [4, 300], ids=["kernel-envelope", "xla-formula"])
def test_e4m3fn_nan_codes_match_jax_qlinear(m):
    """A qfloat8 weight whose codes include the e4m3fn NaN codes 0x7F and
    0xFF (the quantizer never writes them: it clips to +-448; a loaded
    checkpoint could carry them). JAX's `qlinear` converts the codes
    (`FP8_DECODE = "convert"`) and gives NaN in those codes' output columns;
    so does the port's, at M = 4 through the kernel wrapper (its plain
    version on a CPU tensor; the CUDA kernel converts through the hardware,
    also NaN) and at M = 300 through JAX's XLA formula. Only the dormant
    Pallas kernel, whose integer decode reads them as +-480, stays finite."""
    wj, wt = quantized_pair("qfloat8_e4m3fn")  # [256, 512]
    codes = codes_of(wt._data).copy()
    np.testing.assert_array_equal(codes, codes_of(wj._data))
    codes[5, 7], codes[200, 300] = 0x7F, 0xFF
    wt = dataclasses.replace(wt, _data=torch.from_numpy(codes).view(torch.float8_e4m3fn))
    wj = dataclasses.replace(wj, _data=jax.lax.bitcast_convert_type(jnp.asarray(codes), jnp.float8_e4m3fn))
    xj, xt = inputs((m, 512), "float32", m)
    assert K.eligible(xt, wt._data, wt._scale) == (m <= K.MAX_M)
    out, ref = qlinear(xt, wt), np.asarray(jax_qlinear(xj, wj))
    nan_cols = np.zeros(256, bool)
    nan_cols[[5, 200]] = True
    np.testing.assert_array_equal(np.isnan(ref), np.broadcast_to(nan_cols, ref.shape))
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(ref))
    close(out[:, ~nan_cols], ref[:, ~nan_cols])
    if m <= K.MAX_M:
        pallas = qbytes_fp8_matmul_kernel_call(xj, wj._data, wj._scale, interpret=True)
        assert np.isfinite(np.asarray(pallas)).all()


def test_wrapper_refusals():
    _, wt = quantized_pair("qint8")
    x = torch.zeros((4, 512))
    with pytest.raises(TypeError, match="must be torch.float8_e4m3fn"):
        K.qbytes_mm_e4m3fn(x, wt._data, wt._scale)
    with pytest.raises(ValueError, match="envelope"):
        K.qbytes_mm_int8(torch.zeros((257, 512)), wt._data, wt._scale)
    # W8A8 no longer raises: the int8 x int8 route, in float32 as JAX's.
    assert qlinear(qtt.quantize_activation(x, qtt.qint8, torch.tensor(0.1)), wt).dtype == torch.float32
