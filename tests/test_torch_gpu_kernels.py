"""Each Hopper kernel of quanto_tpu_torch against its plain PyTorch version,
on a CUDA card (marked `gpu`; skips without one).

This file imports only torch, numpy and the port, so it runs on a card whose
machine lacks the JAX reference's own dependencies:

    python -m pytest -m gpu tests/test_torch_gpu_kernels.py

Tolerances of the int4 matmuls: float32 x within 1e-4 * max|ref| (the tiled
kernel sees x as a bf16 high + low pair, about 16 mantissa bits); bfloat16 x
within 1e-2 * max|ref| and cosine > 1 - 1e-4 (sums in another order, rounded
to bf16).

The 8-bit weight-only kernel (`qbytes_mm_int8`, `qbytes_mm_e4m3fn`) over
ragged M in 1..256, N multiples of 128, several K, bf16 and f32 x (and a f32
scale beside bf16 x), against `qbytes_mm_plain`: f32 x within 1e-4 *
max|ref| (a bf16 high + low pair), bf16 x within 1e-2 * max|ref| and cosine
> 1 - 1e-4. The W4A8 kernels (`qbits_mm_int8_small_m` at M in 1..512,
`qbits_mm_tiled_int8` at M > 512) against `qbits_int8_mm_plain`: the integer
sums are exact, so a float32 output is held within 1e-5 * max|ref| and a
bf16 output within 1e-2 * max|ref| (one rounding) and cosine > 1 - 1e-4.

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
from quanto_tpu_torch.ops.cuda import qbytes_mm as QB
from quanto_tpu_torch.ops.cuda.qbits_mm import (
    MAX_M,
    qbits_int8_mm_plain,
    qbits_mm_int8_small_m,
    qbits_mm_plain,
    qbits_mm_small_m,
    qbits_mm_tiled,
    qbits_mm_tiled_int8,
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


def check_close(out, ref, f32_tol):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    if f32_tol is not None:
        assert err <= f32_tol * ref.abs().max().item()
    else:
        assert err <= 1e-2 * ref.abs().max().item()
        assert torch.nn.functional.cosine_similarity(out.flatten(), ref.flatten(), dim=0) > 1 - 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16"), ("float32", "float32"), ("bfloat16", "float32")],
                         ids=["bf16", "f32", "bf16-f32scale"])
@pytest.mark.parametrize("payload", ["qint8", "qfloat8_e4m3fn"])
@pytest.mark.parametrize("n,k", [(128, 128), (384, 640), (256, 2048)])
@pytest.mark.parametrize("m", [1, 2, 5, 16, 17, 64, 100, 256])
def test_qbytes_mm_matches_plain(cuda_device, m, n, k, payload, dtypes):
    x_dtype, s_dtype = (getattr(torch, d) for d in dtypes)
    rng = np.random.default_rng(m * 7 + k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(cuda_device)
    qtype = qtt.qtypes[payload]
    qw = qtt.quantize_weight(w, qtype, 0, qtt.AbsmaxOptimizer()(w, qtype, 0).to(s_dtype))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device, x_dtype)
    wrapper = QB.qbytes_mm_int8 if payload == "qint8" else QB.qbytes_mm_e4m3fn
    before = wrapper.launches
    out = wrapper(x, qw._data, qw._scale)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and out.dtype == x_dtype and out.shape == (m, n)
    check_close(out, QB.qbytes_mm_plain(x, qw._data, qw._scale), 1e-4 if x_dtype == torch.float32 else None)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k,group_size", [(1024, 128), (2048, 128), (1024, 1024), (2048, 256)])
@pytest.mark.parametrize("m", [1, 3, 8, 33, 512, 513, 700, 1030])
def test_w4a8_kernels_match_plain(cuda_device, m, k, group_size, out_dtype):
    n = 384
    rng = np.random.default_rng(m + k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(cuda_device)
    gs = None if group_size == k else group_size
    scale, shift = qtt.MaxOptimizer()(w, qtt.qint4, axis=0, group_size=gs)
    hop = WeightQBitsHopperArray.from_generic(
        qtt.quantize_weight(w, qtt.qint4, 0, scale, shift=shift, group_size=gs)
    )
    xq = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(cuda_device)
    sx = torch.tensor(0.0173, device=cuda_device)
    args = (xq, sx, hop._packed, hop._scale_t, hop._shift_t, hop.kernel_group_size, out_dtype)
    wrapper = qbits_mm_int8_small_m if m <= MAX_M else qbits_mm_tiled_int8
    before = wrapper.launches
    out = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and out.dtype == out_dtype and out.shape == (m, n)
    check_close(out, qbits_int8_mm_plain(*args), 1e-5 if out_dtype == torch.float32 else None)


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
