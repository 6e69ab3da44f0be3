"""quanto_tpu_torch quantization core against quanto_tpu, bit for bit.

The same seeded numpy inputs go through the JAX functions and their PyTorch
counterparts: grouping, quanto's packed bytes, MaxOptimizer scale/shift,
affine codes and `quantize_weight(..., group_size=128)` must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.nn.qmodule import _auto_group_size as jax_auto_group_size
from quanto_tpu.ops.pack import pack_weights as jax_pack_weights
from quanto_tpu.ops.quantize import quantize_affine as jax_quantize_affine
from quanto_tpu_torch.nn.qmodule import _auto_group_size
from quanto_tpu_torch.ops.pack import pack_weights, unpack_weights
from quanto_tpu_torch.ops.quantize import quantize_affine
from quanto_tpu_torch.tensor.grouped import group, ungroup
from quanto_tpu_torch.tensor.packed import PackedArray

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def bits_of(a) -> np.ndarray:
    """Bit pattern of a JAX array or torch tensor as a numpy array (bfloat16
    as uint16), for exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def inputs(shape, dtype_name, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize(
    "shape,axis,group_size",
    [((256, 512), 0, 128), ((128, 384), 0, 128), ((64, 256), -1, 64), ((96, 128), -1, 32)],
)
def test_group_ungroup_match(shape, axis, group_size):
    xj, xt = inputs(shape, "float32", 0)
    gj = qt.group(xj, axis, group_size)
    gt = group(xt, axis, group_size)
    np.testing.assert_array_equal(bits_of(gt), bits_of(gj))
    np.testing.assert_array_equal(bits_of(ungroup(gt, axis, shape)), bits_of(xj))


@pytest.mark.parametrize("bits,shape", [(4, (64, 128)), (4, (33, 16)), (2, (64, 96)), (2, (31, 8))])
def test_pack_matches(bits, shape):
    codes = np.random.default_rng(1).integers(0, 2**bits, shape, dtype=np.uint8)
    pj = jax_pack_weights(jnp.asarray(codes), bits)
    pt = pack_weights(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(bits_of(pt), bits_of(pj))
    np.testing.assert_array_equal(unpack_weights(pt, bits, shape[0]).numpy(), codes)
    packed = PackedArray.pack(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(
        bits_of(packed.packed_data), bits_of(qt.PackedArray.pack(jnp.asarray(codes), bits)._data)
    )
    np.testing.assert_array_equal(packed.unpack().numpy(), codes)


CASES = [
    # (shape, dtype, qtype, group_size, zeropoint)
    ((256, 512), "float32", "qint4", 128, False),
    ((256, 512), "bfloat16", "qint4", 128, False),
    ((384, 1024), "bfloat16", "qint4", 128, False),
    ((128, 256), "float32", "qint4", None, False),
    ((128, 256), "float32", "qint2", 128, False),
    ((256, 512), "float32", "qint4", 128, True),
]


@pytest.mark.parametrize("shape,dtype_name,qtype_name,group_size,zeropoint", CASES)
def test_optimizer_codes_and_weights_match(shape, dtype_name, qtype_name, group_size, zeropoint):
    xj, xt = inputs(shape, dtype_name, 2)
    qj, qtq = qt.qtypes[qtype_name], qtt.qtypes[qtype_name]
    sj, zj = qt.MaxOptimizer()(xj, qj, axis=0, group_size=group_size, zeropoint=zeropoint)
    st, zt = qtt.MaxOptimizer()(xt, qtq, axis=0, group_size=group_size, zeropoint=zeropoint)
    np.testing.assert_array_equal(bits_of(st), bits_of(sj))
    np.testing.assert_array_equal(bits_of(zt), bits_of(zj))
    assert bits_of(zt).dtype == bits_of(zj).dtype

    cj = jax_quantize_affine(xj, qj.bits, 0, group_size, sj, zj)
    ct = quantize_affine(xt, qtq.bits, 0, group_size, st, zt)
    np.testing.assert_array_equal(bits_of(ct), bits_of(cj))

    wj = qt.quantize_weight(xj, qj, 0, sj, shift=zj, group_size=group_size)
    wt = qtt.quantize_weight(xt, qtq, 0, st, shift=zt, group_size=group_size)
    np.testing.assert_array_equal(bits_of(wt._data.packed_data), bits_of(wj._data.packed_data))
    np.testing.assert_array_equal(bits_of(wt._scale), bits_of(wj._scale))
    np.testing.assert_array_equal(bits_of(wt._shift), bits_of(wj._shift))
    # Dequantization is float arithmetic on identical operands.
    np.testing.assert_allclose(
        wt.dequantize().float().numpy(), np.asarray(wj.dequantize(), np.float32), rtol=0, atol=1e-6
    )


@pytest.mark.parametrize("in_features", [64, 96, 256, 4096, 14336])
def test_auto_group_size_matches(in_features):
    assert _auto_group_size(in_features) == jax_auto_group_size(in_features)
