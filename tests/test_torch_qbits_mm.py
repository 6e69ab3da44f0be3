"""The Hopper weight layout and the plain versions of the two int4 kernels
against quanto_tpu.

- `WeightQBitsHopperArray` round-trips to the generic layout bit for bit.
- The plain version behind each kernel wrapper (a CPU tensor takes it)
  agrees with `qbits_matmul_kernel_call(..., interpret=True)`, the JAX Pallas
  kernels run in interpret mode: M = 8, 64 and 512 (the serving engine's
  [1, 64] and [8, 64] chunks) run `_kernel`, M = 600 `_prefill_kernel`, and
  `_prefill_kernel` at M = 513 and 1030 (both sides of the Hopper GEMM's
  128-row tiles) with group size 256. Group size 64 is below JAX's TPU-layout
  envelope (gs % 128), so there the plain version is held against a float64
  NumPy reference instead.
- `tiled_workspace_bytes`: the workspace the two tiled kernels take.
- A per-axis int4 weight (group size = K) at M = 600: the port's `qlinear`
  takes `qbits_mm_tiled` (its plain version on the CPU), where JAX's
  `_prefill_route` refuses the shape and its `qlinear` dequantizes and runs
  `jnp.matmul`; the two agree within 1e-5 * max|ref| for float32 x, and
  within 1e-2 * max|ref| at cosine > 1 - 1e-4 for bf16 x (JAX rounds the
  dequantized weight to bf16 first).

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
from quanto_tpu.ops.qlinear import qlinear as jax_qlinear
from quanto_tpu.tensor.weights import WeightQBitsTpuArray
from quanto_tpu_torch.ops import qlinear as QL
from quanto_tpu_torch.ops.cuda import qbits_mm as K
from quanto_tpu_torch.ops.cuda.qbits_mm import (
    MAX_M,
    pack_k_codes,
    qbits_mm_plain,
    qbits_mm_small_m,
    qbits_mm_tiled,
    tiled_workspace_bytes,
)
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

from .test_torch_int2 import weight_pair
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


# M, or (M, group size) where it is not 128: the tiled route's 128-row tile edges at group size 256.
PALLAS_M = [8, 64, 512, 600, pytest.param((513, 256), id="513-gs256"), pytest.param((1030, 256), id="1030-gs256")]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", PALLAS_M)
def test_plain_matches_pallas_interpret(m, dtype_name):
    m, gs = m if isinstance(m, tuple) else (m, 128)
    N, K = 256, 1024
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


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("m", [513, 1030])
def test_tiled_plain_at_group_size_64(m, bits):
    """Group size 64, which the kernels take and JAX's TPU layout does not:
    the plain version behind `qbits_mm_tiled` (float32 x) against a float64
    NumPy product of the dequantized weight, within 1e-5 * max|ref|."""
    N, K, gs = 256, 1024, 64
    rng = np.random.default_rng(m + bits)
    codes = rng.integers(0, 2**bits, (N, K)).astype(np.uint8)
    scale = (rng.random((K // gs, N)) * 0.01 + 0.001).astype(np.float32)
    shift = (scale * rng.random((K // gs, N)) * (2**bits - 1)).astype(np.float32)
    x = rng.standard_normal((m, K)).astype(np.float32)
    packed = pack_k_codes(torch.from_numpy(codes), bits)
    before = qbits_mm_tiled.launches
    out = qbits_mm_tiled(torch.from_numpy(x), packed, torch.from_numpy(scale), torch.from_numpy(shift), gs, bits)
    assert qbits_mm_tiled.launches == before and out.shape == (m, N) and out.dtype == torch.float32
    w = codes.astype(np.float64).reshape(N, K // gs, gs) * scale.T[:, :, None] - shift.T[:, :, None]
    ref = x.astype(np.float64) @ w.reshape(N, K).T
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))
    np.testing.assert_array_equal(out.numpy(), qbits_mm_plain(
        torch.from_numpy(x), packed, torch.from_numpy(scale), torch.from_numpy(shift), gs, bits).numpy())


@pytest.mark.parametrize(
    "m,n,k,gs,dtype,want",
    [
        # bf16 codes [N, K] + x sums [K / gs, M rounded up to 192], float32
        (4096, 14336, 4096, 128, torch.bfloat16, 2 * 14336 * 4096 + 32 * 4224 * 4),
        (513, 14336, 4096, 128, torch.bfloat16, 2 * 14336 * 4096 + 32 * 576 * 4),
        # float32 x: + its bf16 high and low planes [2, M, K]
        (600, 384, 2048, 2048, torch.float32, 2 * 384 * 2048 + 1 * 768 * 4 + 2 * 600 * 2048 * 2),
        # int8 x: int8 codes
        (4064, 4096, 14336, 128, torch.int8, 4096 * 14336 + 112 * 4224 * 4),
        (1, 128, 1024, 64, torch.int8, 128 * 1024 + 16 * 192 * 4),
    ],
)
def test_tiled_workspace_bytes(m, n, k, gs, dtype, want):
    assert tiled_workspace_bytes(m, n, k, gs, dtype) == want
    assert want % 4 == 0  # the wrapper allocates it in float32 elements


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_per_axis_qlinear_matches_jax_fallback(monkeypatch, dtype_name):
    N, Kd, m = 256, 1024, 600
    rng = np.random.default_rng(21)
    jdt, tdt = (jnp.float32, torch.float32) if dtype_name == "float32" else (jnp.bfloat16, torch.bfloat16)
    tpu, hop = weight_pair(rng.standard_normal((N, Kd)).astype(np.float32), 4, jdt, tdt, group_size=None)
    assert hop.kernel_group_size == Kd
    x = rng.standard_normal((m, Kd)).astype(np.float32)
    ref = np.asarray(jax_qlinear(jnp.asarray(x).astype(jdt), tpu).astype(jnp.float32))
    calls = []
    tiled = K.qbits_mm_tiled
    monkeypatch.setattr(K, "qbits_mm_tiled", lambda *a, **kw: calls.append(a[0].shape) or tiled(*a, **kw))
    out = QL.qlinear(torch.from_numpy(x).to(tdt), hop)
    assert calls == [(m, Kd)] and out.dtype == tdt and out.shape == (m, N)
    out = out.float().numpy()
    err = np.max(np.abs(out - ref))
    if dtype_name == "float32":
        assert err <= 1e-5 * np.max(np.abs(ref))
    else:
        assert err <= 1e-2 * np.max(np.abs(ref))
        assert np.sum(out * ref) / (np.linalg.norm(out) * np.linalg.norm(ref)) > 1 - 1e-4
