"""Each Hopper kernel of quanto_tpu_torch against its plain PyTorch version,
on a CUDA card (marked `gpu`; skips without one).

This file imports only torch, numpy and the port, so it runs on a card whose
machine lacks the JAX reference's own dependencies:

    python -m pytest -m gpu tests/test_torch_gpu_kernels.py

Tolerances of the int4 matmuls: float32 x within 1e-4 * max|ref| (the tiled
kernel sees x as a bf16 high + low pair, about 16 mantissa bits); bfloat16 x
within 1e-2 * max|ref| and cosine > 1 - 1e-4 (sums in another order, rounded
to bf16).

`flash_decode` against `flash_decode_plain` for every pair of K and V payload
types (float32 and bfloat16 caches; int8, int4 and the three float8 formats
paired freely, with and without shifts), S in {1, 127, 1088, 8192}, ragged
positions including 0, float32 and bfloat16 q. Tolerances: float32 q within
1e-5 * max|ref| (float32 sums in another order, `__expf`); bfloat16 q within
1e-2 * max|ref| and cosine > 1 - 1e-4 (the same, then rounded to bf16).
"""

import numpy as np
import pytest
import torch

import quanto_tpu_torch as qtt
from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain
from quanto_tpu_torch.ops.cuda.qbits_mm import (
    MAX_M,
    qbits_mm_plain,
    qbits_mm_small_m,
    qbits_mm_tiled,
)
from quanto_tpu_torch.tensor import kv_cache as tkv
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

CODE_TYPES = ["qint8", "qint4", "qfloat8_e4m3fn", "qfloat8_e5m2", "qfloat8_e4m3fnuz"]
CACHES = (
    [(t, t, False) for t in ("float32", "bfloat16")]
    + [(k, v, shifted) for k in CODE_TYPES for v in CODE_TYPES for shifted in (False, True)]
)


def cache_id(cache) -> str:
    k, v, shifted = cache
    return f"{k}-{v}-shifted" if shifted else f"{k}-{v}"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("group_size", [128, None])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 4, 7, 512, 513, 700])
def test_kernels_match_plain(cuda_device, m, dtype, group_size):
    N, K = 384, 2048
    rng = np.random.default_rng(m)
    w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)).to(cuda_device, dtype)
    scale, shift = qtt.MaxOptimizer()(w, qtt.qint4, axis=0, group_size=group_size)
    hop = WeightQBitsHopperArray.from_generic(
        qtt.quantize_weight(w, qtt.qint4, 0, scale, shift=shift, group_size=group_size)
    )
    x = torch.from_numpy(rng.standard_normal((m, K)).astype(np.float32)).to(cuda_device, dtype)
    args = (x, hop._packed, hop._scale_t, hop._shift_t, hop.kernel_group_size)
    wrapper = qbits_mm_small_m if m <= MAX_M else qbits_mm_tiled
    before = wrapper.launches
    out = wrapper(*args).float()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = qbits_mm_plain(*args).float()
    err = (out - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * ref.abs().max().item()
    else:
        assert err <= 1e-2 * ref.abs().max().item()
        assert torch.nn.functional.cosine_similarity(out.flatten(), ref.flatten(), dim=0) > 1 - 1e-4


def cache_operands(k_type, v_type, shifted, S, D, device, seed):
    """(k, v, k_scale, v_scale, k_shift, v_shift) of one cache layer, B = 3,
    Hkv = 2, written by the port's `kv_update` from seeded K/V."""
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.standard_normal((3, S, 2, D)).astype(np.float32) * 2 + 0.5).to(device)
    v = torch.from_numpy(rng.standard_normal((3, S, 2, D)).astype(np.float32)).to(device)
    if k_type in ("float32", "bfloat16"):
        dtype = getattr(torch, k_type)
        return k.to(dtype), v.to(dtype), None, None, None, None
    suffix = "a" if shifted else ""
    ck = tkv.init_quantized_kv_cache(1, 3, S, 2, D, k_type + suffix, device=device)[0]
    cv = tkv.init_quantized_kv_cache(1, 3, S, 2, D, v_type + suffix, device=device)[0]
    tkv.kv_update(ck, k, v, 0)
    tkv.kv_update(cv, k, v, 0)
    return ck._k_data, cv._v_data, ck._k_scale, cv._v_scale, ck._k_shift, cv._v_shift


def check_flash_decode(device, cache, S, D, dtype, G=4):
    k_type, v_type, shifted = cache
    ops = cache_operands(k_type, v_type, shifted, S, D, device, seed=S + D)
    rng = np.random.default_rng(D)
    q = torch.from_numpy(rng.standard_normal((3, 2, G, D)).astype(np.float32)).to(device, dtype)
    pos = torch.tensor([S - 1, S // 2, 0], dtype=torch.int32, device=device)
    k, v, ks, vs, km, vm = ops
    before = flash_decode.launches
    out = flash_decode(q, k, v, ks, vs, pos, k_shift=km, v_shift=vm).float()
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    ref = flash_decode_plain(q, k, v, ks, vs, pos, k_shift=km, v_shift=vm).float()
    err = (out - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * ref.abs().max().item()
    else:
        assert err <= 1e-2 * ref.abs().max().item()
        assert torch.nn.functional.cosine_similarity(out.flatten(), ref.flatten(), dim=0) > 1 - 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("S", [1, 127, 1088, 8192])
@pytest.mark.parametrize("cache", CACHES, ids=cache_id)
def test_flash_decode_matches_plain(cuda_device, cache, S, dtype):
    check_flash_decode(cuda_device, cache, S, 128, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("cache", CACHES, ids=cache_id)
def test_flash_decode_head_dim_64(cuda_device, cache):
    check_flash_decode(cuda_device, cache, 1088, 64, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 3, 6, 8])
@pytest.mark.parametrize("cache", [("bfloat16", "bfloat16", False), ("qint4", "qint8", True)],
                         ids=["bf16", "k4v8-shifted"])
def test_flash_decode_query_groups(cuda_device, cache, G):
    """Query groups that fill part of a block's 4 rows, or span two blocks."""
    check_flash_decode(cuda_device, cache, 1088, 128, torch.float32, G=G)
