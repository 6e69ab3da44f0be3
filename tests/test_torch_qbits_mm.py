"""The Hopper weight layout and the plain versions of the two int4 kernels
against quanto_tpu.

- `WeightQBitsHopperArray` round-trips to the generic layout bit for bit.
- The plain version behind each kernel wrapper (a CPU tensor takes it)
  agrees with `qbits_matmul_kernel_call(..., interpret=True)`, the JAX Pallas
  kernels run in interpret mode: M = 8, 64 and 512 (the serving engine's
  [1, 64] and [8, 64] chunks) run `_kernel`, M = 600 `_prefill_kernel`.

The CUDA kernels themselves are held against their plain versions on the card
by `tests/test_torch_gpu_kernels.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.ops.pallas.qbits_mm import qbits_matmul_kernel_call
from quanto_tpu.tensor.weights import WeightQBitsTpuArray
from quanto_tpu_torch.ops.cuda.qbits_mm import MAX_M, qbits_mm_small_m, qbits_mm_tiled
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

from .test_torch_quantize import bits_of


def torch_qweight(w: np.ndarray, dtype, group_size=128, zeropoint=False, device="cpu"):
    t = torch.from_numpy(w).to(device=device, dtype=dtype)
    scale, shift = qtt.MaxOptimizer()(t, qtt.qint4, axis=0, group_size=group_size, zeropoint=zeropoint)
    return qtt.quantize_weight(t, qtt.qint4, 0, scale, shift=shift, group_size=group_size)


@pytest.mark.parametrize(
    "shape,dtype,group_size,zeropoint",
    [
        ((256, 1024), torch.float32, 128, False),
        ((128, 512), torch.bfloat16, 128, False),
        ((256, 512), torch.float32, None, False),
        ((256, 1024), torch.float32, 128, True),
    ],
)
def test_hopper_layout_roundtrip(shape, dtype, group_size, zeropoint):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    generic = torch_qweight(w, dtype, group_size, zeropoint)
    hop = WeightQBitsHopperArray.from_generic(generic)
    assert hop is not None and hop._packed.shape == (shape[0], shape[1] // 2)
    torch.testing.assert_close(hop.dequantize(), generic.dequantize(), rtol=1e-6, atol=1e-6)
    back = hop.to_generic()
    np.testing.assert_array_equal(bits_of(back._data.packed_data), bits_of(generic._data.packed_data))
    np.testing.assert_array_equal(bits_of(back._scale), bits_of(generic._scale))
    if zeropoint:
        # Integer zero-points come back as the float shifts scale * zp.
        expected = (generic._scale.float() * generic._shift.float()).to(dtype)
        np.testing.assert_array_equal(bits_of(back._shift), bits_of(expected))
    else:
        np.testing.assert_array_equal(bits_of(back._shift), bits_of(generic._shift))


@pytest.mark.parametrize("shape,bits", [((96, 512), 4), ((256, 384), 4), ((256, 384), 2)])
def test_off_envelope_stays_generic(shape, bits):
    """Shapes the JAX layout pads (int4, and int2 at K / 4 = 96) keep the
    generic layout."""
    w = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    qtype = qtt.qtypes[f"qint{bits}"]
    scale, shift = qtt.MaxOptimizer()(w, qtype, axis=0, group_size=128)
    generic = qtt.quantize_weight(w, qtype, 0, scale, shift=shift, group_size=128)
    assert WeightQBitsHopperArray.from_generic(generic) is None
    assert not WeightQBitsTpuArray.eligible(shape, bits, 128)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [8, 64, 512, 600])
def test_plain_matches_pallas_interpret(m, dtype_name):
    N, K, gs = 256, 1024, 128
    rng = np.random.default_rng(m)
    w = rng.standard_normal((N, K)).astype(np.float32)
    x = rng.standard_normal((m, K)).astype(np.float32)
    jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype_name == "float32" else torch.bfloat16

    wj = jnp.asarray(w).astype(jdt)
    sj, zj = qt.MaxOptimizer()(wj, qt.qint4, axis=0, group_size=gs)
    tpu = WeightQBitsTpuArray.from_generic(qt.quantize_weight(wj, qt.qint4, 0, sj, shift=zj, group_size=gs))
    ref = qbits_matmul_kernel_call(
        jnp.asarray(x).astype(jdt), tpu._packed, tpu._scale_t, tpu._shift_t, 4, gs, interpret=True
    )
    ref = np.asarray(ref.astype(jnp.float32))

    hop = WeightQBitsHopperArray.from_generic(torch_qweight(w, tdt, gs))
    wrapper = qbits_mm_small_m if m <= MAX_M else qbits_mm_tiled
    before = wrapper.launches
    out = wrapper(torch.from_numpy(x).to(tdt), hop._packed, hop._scale_t, hop._shift_t, gs)
    assert wrapper.launches == before  # a CPU tensor takes the plain version: no launch
    assert out.dtype == tdt and out.shape == (m, N)
    out = out.float().numpy()
    if dtype_name == "float32":
        assert np.max(np.abs(out - ref)) <= 1e-4 * np.max(np.abs(ref))
    else:
        cos = np.sum(out * ref) / (np.linalg.norm(out) * np.linalg.norm(ref))
        assert cos > 1 - 1e-4
