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
ragged M in 1..256, N multiples of 128, several K (Llama-3.1-8B's 1024 x
4096 and 14336 x 4096 among them, and shapes that split K), bf16 and f32 x
(and a f32 scale beside bf16 x), two launches bit-identical, against
`qbytes_mm_plain`: f32 x within 1e-4 *
max|ref| (a bf16 high + low pair), bf16 x within 1e-2 * max|ref| and cosine
> 1 - 1e-4. The W4A8 kernels (`qbits_mm_int8_small_m` at M in 1..512,
`qbits_mm_tiled_int8` at M > 512) against `qbits_int8_mm_plain`: the integer
sums are exact, so a float32 output is held within 1e-5 * max|ref| and a
bf16 output within 1e-2 * max|ref| (one rounding) and cosine > 1 - 1e-4.

The W4A8 requant kernel (`qbits_mm_requant_int8`) against
`qbits_requant_int8_mm_plain` at the Llama-3.1-8B linear shapes (N in
{1024, 4096, 14336}, K in {4096, 14336}), M in {2048, 2049, 2111, 2176,
4095, 4096, 4097} (both sides of its 128-row M tiles and of its 128- and
256-wide N tiles' choice), group sizes 128 and 256: its codes and int32 sums
are exact and its epilogue is the plain version's two float32 multiplies, so
float32 and bf16 outputs are held EQUAL to the plain version's; its first
pass's codes EQUAL to `requant_codes`; two launches bit-identical; and its
refusals on CUDA tensors.

`flash_decode` against `flash_decode_plain` for every pair of K and V payload
types (float32 and bfloat16 caches; int8, int4 and the three float8 formats
paired freely, with and without shifts), S in {1, 63, 64, 65, 127, 1088,
8192}, ragged positions including 0, float32 and bfloat16 q (bfloat16 q over
a cache without float32 payloads takes the tensor-core arm, the rest the
CUDA-core arm), G in {1, 3, 6, 8, 12}; positions that leave most tiles empty
(rows at 0, rows inside the first tile, one row at S - 1 beside rows at 0,
the engine's three decode steps over 4352 slots) and 40 or 100 rows at random
positions; each call one launch, two calls the same bits. Its paged arm
(`flash_decode_paged`) over caches of bf16, qint8, qint4, k8v4 and qint4a pages
of 4, 16 and 64 slots behind a shuffled table, D 64 and 128, both q dtypes, and
a bf16 pool past 2^31 bytes: one launch on its own counter, EQUAL to the dense
arm on the pages gathered through the table (the same plan and sums), and
within the dense tolerances of its plain version. Tolerances: float32 q within 1e-5 * max|ref| (float32 sums in
another order, ex2.approx); bfloat16 q within 1e-2 * max|ref| and cosine > 1 -
1e-4 (the same, p s_v rounded to bf16 inside the tensor-core product, the
output rounded to bf16).

The MoE kernels (`qbits_moe_small_m`, `qbits_moe_tiled`) against
`qbits_moe_plain` over 8 stacked experts at both projection shapes (N > K and
N < K), bf16 and f32 x: the selective form at nsel in {1, 2, 9, 32}, the all
form at ragged S in {1, 3, 8, 512} and at the all-experts route's S in {9,
16, 32} (TPU #12; also int2, through `qbits_moe_all`, whose own count ticks
once a call without a table; and with a device count that skips slots), a
6-slot expert table (U < E) with and without a device count that skips slots; the batched-expert GEMM at M in
{1, 4, 8, 16} (the per-slot small-M body) and at M in {17, 33, 127, 129, 130, 255,
257, 600, 2048, 2049} (the pipelined GEMM: both sides of its 128-row M
tiles), group sizes 64, 128 and 256, with and without a table and a device
count; its M <= 16 arm (TPU #15 on the main path, the per-slot tensor-core
body) at M in {1, 4, 16} with each slot's own rows, a table and dead slots,
int4 and int2, counted in `launches_small_m`. Float32 outputs within 1e-4 *
max|ref| (sums in another order; f32 x seen as a bf16 high + low pair) and
cosine > 1 - 1e-5; skipped slots exactly zero; two launches bit-identical; one
launch counted a call.

The int2 arms of the four float-x kernels, with the tolerances of their int4
arms: `qbits_mm_small_m` and `qbits_mm_tiled` over M in 1..1024 (the int2
envelope of the tiled route) for qint2 weights of group size 128 and per
axis, and over random packed bytes (every crumb value in every position);
the MoE kernels over 8 stacked qint2 experts in each form and tile height.
The int2 arms of the three int8-x kernels (W2A8) over random packed bytes
(every crumb value in every position) and random int8 x, with the
tolerances of their int4 arms: `qbits_mm_int8_small_m` at M in 1..512 and
`qbits_mm_tiled_int8` at M in 513..1024 (the int2 envelope of the tiled
route) for group sizes 128, 256 and per axis, bf16 and f32 output; the
requant kernel at the Llama-3.1-8B linear shapes, M at the requant M-tile
edges above, EQUAL to its plain version.

`qbits_mm_partitioned` (TPU kernel #5) on one rank's part of a 512 x 2048
weight, column, row and replicated, float and int8 x, int4 and int2, against
the same call through its plain local product (`_local_mm_plain`): bf16 x
with the tolerances of the bf16 int4 matmuls above (the partial is the
kernel's bf16 output), int8 x within 1e-5 * max|ref| (exact integer sums);
one launch a call.
The row part's all_reduce runs over a one-rank gloo group on the card's
tensors (gloo stages them through the host), so it returns the partial.

Both arms of TPU #2 (`qbits_mm_tiled`, `qbits_mm_tiled_int8`, the pipelined
wgmma GEMMs) over random packed bytes, int4 and int2: M on both sides of
every 128-row tile edge (513 to 4097, 4064 included), N in {384, 1024, 1152,
14336} and the down projection, K in {2048, 4096, 14336}, group sizes 64,
128, 256 and K, bf16 and float32 x, bf16 and float32 output for int8 x, with
the tolerances above; two launches give the same bits; one launch counted a
call; refused shapes raise on CUDA tensors.

The W8A8 route (`ops/qbytes_mm.py`: `torch._int_mm`, and for e4m3fn JAX's
convert formula on bf16 operands with float32 sums; no TPU kernel) at M in
{1, 4, 16, 17, 64, 4096} against its plain formula (int8 EQUAL, e4m3fn within
1e-5 * max|ref|: exact products, float32 sums in another order); `qlinear` over weights
zero-padded onto the envelope (SmolLM2-360M's and Qwen2.5-0.5B's linears,
float and int8 x, M in {4, 600, 4096}) against the same call on the CPU;
`flash_decode` at the small models' heads, (Hkv, G, D) = (5, 3, 64) and
(2, 7, 64).

The tensor-core small-M kernels (#1 `qbits_mm_small_m`, #4
`qbits_mm_int8_small_m`) at every M-tile edge (M in 9..512), N in {1024,
14336}, group sizes 64, 128 and 256, int4 and int2, over a K (4352) that
leaves a split-K remainder, with the tolerances above; two launches give the
same bits; one launch counted a call.
"""

import dataclasses

import numpy as np
import pytest
import torch

import quanto_tpu_torch as qtt
from quanto_tpu_torch.ops.cuda.flash_decode import (
    flash_decode,
    flash_decode_paged,
    flash_decode_paged_plain,
    flash_decode_plain,
)
from quanto_tpu_torch.ops.cuda import moe_mm as MM
from quanto_tpu_torch.ops.cuda import qbytes_mm as QB
from quanto_tpu_torch.ops.cuda.qbits_mm import (
    MAX_M,
    qbits_int8_mm,
    qbits_mm,
    qbits_int8_mm_plain,
    qbits_mm_int8_small_m,
    qbits_mm_plain,
    qbits_mm_small_m,
    qbits_mm_tiled,
    qbits_mm_requant_int8,
    qbits_mm_tiled_int8,
    qbits_requant_int8_mm_plain,
    requant_codes,
    requant_pass,
    requant_step,
)
from quanto_tpu_torch.ops.cuda import qbits_mm_sharded as SH
from quanto_tpu_torch.ops.collectives import TPGroup
from quanto_tpu_torch.tensor import kv_cache as tkv
from quanto_tpu_torch.tensor import paged_kv as tpk
from quanto_tpu_torch.tensor.activations import ActivationQBytesArray
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray, shard_qbits

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
@pytest.mark.parametrize("n,k", [(128, 128), (384, 640), (256, 2048), (1024, 4096), (14336, 4096)])
@pytest.mark.parametrize("m", [1, 2, 5, 8, 16, 17, 64, 100, 256])
def test_qbytes_mm_matches_plain(cuda_device, m, n, k, payload, dtypes):
    """Also at Llama-3.1-8B's k/v and gate/up shapes; 384 x 640, 256 x 2048 and
    1024 x 4096 at small M split K over a cluster (2 to 8 ways). Two launches
    give the same bits."""
    x_dtype, s_dtype = (getattr(torch, d) for d in dtypes)
    rng = np.random.default_rng(m * 7 + k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(cuda_device)
    qtype = qtt.qtypes[payload]
    qw = qtt.quantize_weight(w, qtype, 0, qtt.AbsmaxOptimizer()(w, qtype, 0).to(s_dtype))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device, x_dtype)
    wrapper = QB.qbytes_mm_int8 if payload == "qint8" else QB.qbytes_mm_e4m3fn
    before = wrapper.launches
    out = wrapper(x, qw._data, qw._scale)
    again = wrapper(x, qw._data, qw._scale)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2 and out.dtype == x_dtype and out.shape == (m, n)
    assert torch.equal(out, again)
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


def requant_operands(device, m, n, k, gs, seed):
    """Random int8 x, sx and an int4 weight in the requant form: codes, group
    scales and shifts anywhere in [0, 15] steps, and its s8."""
    g = torch.Generator(device=device).manual_seed(seed)
    xq = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=device, generator=g)
    packed = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device=device, generator=g)
    scale_t = torch.rand((k // gs, n), device=device, generator=g) * 0.01 + 0.001
    shift_t = scale_t * torch.rand((k // gs, n), device=device, generator=g) * 15
    sx = torch.tensor(0.0173, device=device)
    return xq, sx, packed, scale_t, shift_t, requant_step(scale_t, shift_t)


# M on both sides of the requant GEMM's 128-row tiles, at the route's least M and at phase 10's.
REQUANT_EDGES = [2048, 2049, 2111, 2176, 4095, 4096, 4097]


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("gs", [128, 256])
@pytest.mark.parametrize("k", [4096, 14336])
@pytest.mark.parametrize("n", [1024, 4096, 14336])
@pytest.mark.parametrize("m", REQUANT_EDGES)
def test_requant_kernel_equals_plain(cuda_device, m, n, k, gs, out_dtype):
    xq, sx, packed, scale_t, shift_t, s8 = requant_operands(cuda_device, m, n, k, gs, seed=m + n + k + gs)
    args = (xq, sx, packed, scale_t, shift_t, s8, gs, out_dtype)
    before = qbits_mm_requant_int8.launches
    out = qbits_mm_requant_int8(*args)
    torch.cuda.synchronize()
    assert qbits_mm_requant_int8.launches == before + 1 and out.dtype == out_dtype and out.shape == (m, n)
    ref = qbits_requant_int8_mm_plain(*args)
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("n,k,gs", [(1024, 4096, 128), (4096, 14336, 256)])
def test_requant_pass_equals_requant_codes(cuda_device, n, k, gs, bits):
    """The kernel's first pass writes each weight code's requant code once:
    EQUAL to the plain `requant_codes` (the same float32 roundings)."""
    operands = requant_operands if bits == 4 else w2a8_operands
    _, _, packed, scale_t, shift_t, s8 = operands(cuda_device, 1, n, k, gs, seed=n + k + bits)
    c8 = requant_pass(packed, scale_t, shift_t, s8, gs, bits)
    assert c8.dtype == torch.int8 and c8.shape == (n, k)
    assert torch.equal(c8, requant_codes(packed, scale_t, shift_t, s8, gs, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("m", [2049, 4096])
def test_requant_kernel_bit_identical_and_counted(cuda_device, m, bits):
    """Two launches give the same bits (exact int32 sums), and each call of
    the wrapper or of the router on the requant route is one launch."""
    operands = requant_operands if bits == 4 else w2a8_operands
    xq, sx, packed, scale_t, shift_t, s8 = operands(cuda_device, m, 4096, 4096, 128, seed=m + bits)
    args = (xq, sx, packed, scale_t, shift_t, s8, 128, torch.float32, bits)
    first = qbits_mm_requant_int8(*args)
    assert torch.equal(first, qbits_mm_requant_int8(*args))
    before = (qbits_mm_requant_int8.launches, qbits_mm_requant_int8.launches_int2)
    out = qbits_int8_mm(xq, sx, packed, scale_t, shift_t, 128, torch.float32, s8=s8, bits=bits)
    torch.cuda.synchronize()
    assert (qbits_mm_requant_int8.launches, qbits_mm_requant_int8.launches_int2) == (
        before[0] + 1, before[1] + (bits == 2))
    assert torch.equal(out, first)


@pytest.mark.gpu
def test_requant_kernel_refusals(cuda_device):
    xq, sx, packed, scale_t, shift_t, s8 = requant_operands(cuda_device, 2048, 1024, 4096, 128, seed=0)
    w = (packed, scale_t, shift_t)
    with pytest.raises(ValueError, match="one device"):
        qbits_mm_requant_int8(xq, sx, *w, s8.cpu(), 128, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        qbits_mm_requant_int8(xq.t().contiguous().t(), sx, *w, s8, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="group size"):
        qbits_mm_requant_int8(xq, sx, packed, scale_t[:1], shift_t[:1], s8, 4096, torch.bfloat16)
    with pytest.raises(ValueError, match="sx"):
        qbits_mm_requant_int8(xq, sx.cpu(), *w, s8, 128, torch.bfloat16)
    with pytest.raises(TypeError, match="int8"):
        qbits_mm_requant_int8(xq.float(), sx, *w, s8, 128, torch.bfloat16)


def cache_operands(k_type, v_type, shifted, S, D, device, seed, B=3, Hkv=2):
    """(k, v, k_scale, v_scale, k_shift, v_shift) of one cache layer, B = 3,
    Hkv = 2 unless given, written by the port's `kv_update` from seeded K/V."""
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32) * 2 + 0.5).to(device)
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32)).to(device)
    if k_type in ("float32", "bfloat16"):
        dtype = getattr(torch, k_type)
        return k.to(dtype), v.to(dtype), None, None, None, None
    suffix = "a" if shifted else ""
    ck = tkv.init_quantized_kv_cache(1, B, S, Hkv, D, k_type + suffix, device=device)[0]
    cv = tkv.init_quantized_kv_cache(1, B, S, Hkv, D, v_type + suffix, device=device)[0]
    tkv.kv_update(ck, k, v, 0)
    tkv.kv_update(cv, k, v, 0)
    return ck._k_data, cv._v_data, ck._k_scale, cv._v_scale, ck._k_shift, cv._v_shift


def check_flash_decode(device, cache, S, D, dtype, G=4, positions=None, Hkv=2, seed=None):
    """One cache layer (B = len(positions), rows at S - 1, S // 2 and 0 unless
    given): each call one launch, two calls the same bits, and the result
    against the plain version: float32 q within 1e-5 * max|ref|, bfloat16 q
    within 1e-2 * max|ref| and cosine > 1 - 1e-4."""
    positions = [S - 1, S // 2, 0] if positions is None else positions
    seed = S + D if seed is None else seed
    k_type, v_type, shifted = cache
    B = len(positions)
    k, v, ks, vs, km, vm = cache_operands(k_type, v_type, shifted, S, D, device, seed=seed, B=B, Hkv=Hkv)
    rng = np.random.default_rng(seed + 1)
    q = torch.from_numpy(rng.standard_normal((B, Hkv, G, D)).astype(np.float32)).to(device, dtype)
    pos = torch.tensor(positions, dtype=torch.int32, device=device)
    before = flash_decode.launches
    out = flash_decode(q, k, v, ks, vs, pos, k_shift=km, v_shift=vm)
    assert flash_decode.launches == before + 1
    assert torch.equal(out, flash_decode(q, k, v, ks, vs, pos, k_shift=km, v_shift=vm))
    torch.cuda.synchronize()
    out = out.float()
    ref = flash_decode_plain(q, k, v, ks, vs, pos, k_shift=km, v_shift=vm).float()
    err = (out - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * ref.abs().max().item()
    else:
        assert err <= 1e-2 * ref.abs().max().item()
        assert torch.nn.functional.cosine_similarity(out.flatten(), ref.flatten(), dim=0) > 1 - 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 1088, 8192])
@pytest.mark.parametrize("cache", CACHES, ids=cache_id)
def test_flash_decode_matches_plain(cuda_device, cache, S, dtype):
    check_flash_decode(cuda_device, cache, S, 128, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("cache", CACHES, ids=cache_id)
def test_flash_decode_head_dim_64(cuda_device, cache):
    check_flash_decode(cuda_device, cache, 1088, 64, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("G", [1, 3, 6, 8, 12])
@pytest.mark.parametrize("cache", [("bfloat16", "bfloat16", False), ("qint4", "qint8", True)],
                         ids=["bf16", "k4v8-shifted"])
def test_flash_decode_query_groups(cuda_device, cache, G, dtype):
    """Query groups that fill part of a group of rows, or take a second one
    (bf16 q: 8 rows an n tile, two from G = 9; float32 q: 4 rows a group)."""
    check_flash_decode(cuda_device, cache, 1088, 128, dtype, G=G)


# Caches of the ragged-position cases: a float cache, symmetric and asymmetric int4, k8v4 and a
# float8 pair, so both arms (bf16 q: tensor cores; float32 q: CUDA cores) meet every decode path.
RAGGED_CACHES = [("bfloat16", "bfloat16", False), ("qint4", "qint4", False), ("qint4", "qint4", True),
                 ("qint8", "qint4", False), ("qfloat8_e4m3fn", "qfloat8_e5m2", True)]
# Positions whose visible slots leave most tiles of the cache empty (S = 1088): every row at 0,
# rows inside the first 64 slots, one row at S - 1 beside rows at 0; and the engine's decode
# step (B = 8 over 4352 slots; chip_smoke.py's FD_ENGINE_POS): every row decoding a long prompt,
# four rows at a 1024-token prompt's positions beside four long ones, four free rows at 0.
RAGGED = {
    "zeros": (1088, [0, 0, 0]),
    "first_tile": (1088, [5, 63, 0]),
    "one_full": (1088, [1087, 0, 0]),
    "engine_batch": (4352, [3200, 4224, 3712, 3456, 4096, 3328, 3968, 3584]),
    "engine_stream": (4352, [1040, 3400, 1056, 3700, 1072, 3950, 1088, 4200]),
    "engine_free": (4352, [0, 3200, 0, 3712, 0, 4224, 0, 3968]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("case", list(RAGGED))
@pytest.mark.parametrize("cache", RAGGED_CACHES, ids=cache_id)
def test_flash_decode_ragged_positions(cuda_device, cache, case, dtype):
    """Positions that leave most tiles empty: the device plan visits only the
    visible tiles of each row."""
    S, positions = RAGGED[case]
    check_flash_decode(cuda_device, cache, S, 128, dtype, positions=positions, seed=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("B", [40, 100])
def test_flash_decode_many_rows(cuda_device, B, dtype):
    """More rows than a warp scans at once (and, at B = 100, than the grid's
    occupancy allows for), at random positions: blocks that see whole pairs
    between partial ones, and pairs split over many blocks."""
    positions = np.random.default_rng(B).integers(0, 520, B).tolist()
    check_flash_decode(cuda_device, ("qint4", "qint4", True), 520, 128, dtype, positions=positions, Hkv=8, seed=B)


def stacked_experts(device, N, K, E=8, seed=0, bits=4):
    """E experts' weights of `bits` in the Hopper layout, stacked: (packed, scale_t, shift_t)."""
    rng = np.random.default_rng(seed)
    qtype = qtt.qtypes[f"qint{bits}"]
    ws = []
    for _ in range(E):
        w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)).to(device)
        scale, shift = qtt.MaxOptimizer()(w, qtype, axis=0, group_size=128)
        ws.append(WeightQBitsHopperArray.from_generic(
            qtt.quantize_weight(w, qtype, 0, scale, shift=shift, group_size=128)
        ))
    return tuple(torch.stack([getattr(w, f) for w in ws]) for f in ("_packed", "_scale_t", "_shift_t"))


def check_moe(wrapper, x3, weights, eids=None, nslots=None, bits=4, group_size=128):
    """One launch of `wrapper` (counted in its int2 arm's count too at bits = 2)
    against the plain version."""
    before = (wrapper.launches, wrapper.launches_int2)
    out = wrapper(x3, *weights, group_size, bits, eids=eids, nslots=nslots)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_int2) == (before[0] + 1, before[1] + (bits == 2))
    assert out.dtype == torch.float32
    ref = MM.qbits_moe_plain(x3, *weights, group_size, bits, eids=eids, nslots=nslots)
    assert out.shape == ref.shape
    if nslots is not None:
        assert not out[int(nslots):].any()
        out, ref = out[: int(nslots)], ref[: int(nslots)]
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert torch.nn.functional.cosine_similarity(out.flatten(), ref.flatten(), dim=0) > 1 - 1e-5


MOE_SHAPES = [(768, 512), (512, 768)]
MOE_TABLE = np.array([6, 1, 3, 0, 7, 4], np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,k", MOE_SHAPES)
@pytest.mark.parametrize("kind,size,nslots", [
    ("sel", 1, None), ("sel", 2, None), ("sel", 9, None), ("sel", 32, None),
    ("all", 1, None), ("all", 3, None), ("all", 8, None), ("all", 512, None),
    ("all", 9, None), ("all", 16, None), ("all", 32, None), ("all", 16, 5),
    ("uniq", 4, None), ("uniq", 4, 3), ("uniq", 8, None), ("uniq", 8, 4),
], ids=lambda v: str(v))
def test_moe_small_m_matches_plain(cuda_device, kind, size, nslots, n, k, dtype):
    weights = stacked_experts(cuda_device, n, k, seed=n)
    rng = np.random.default_rng(size)
    x = torch.from_numpy(rng.standard_normal((size, k)).astype(np.float32)).to(cuda_device, dtype)
    if kind == "sel":
        eids = torch.from_numpy(rng.integers(0, 8, size).astype(np.int32)).to(cuda_device)
        check_moe(MM.qbits_moe_small_m, x[:, None, :], weights, eids=eids)
        out = MM.qbits_moe_sel(x, eids, *weights, 128)
        torch.testing.assert_close(out, MM.qbits_moe_small_m(x[:, None, :], *weights, 128, eids=eids)[:, 0])
    elif kind == "all":
        count = None if nslots is None else torch.tensor(nslots, dtype=torch.int32, device=cuda_device)
        check_moe(MM.qbits_moe_small_m, x.expand(8, *x.shape), weights, nslots=count)
    else:
        eids = torch.from_numpy(MOE_TABLE).to(cuda_device)
        count = None if nslots is None else torch.tensor(nslots, dtype=torch.int32, device=cuda_device)
        check_moe(MM.qbits_moe_small_m, x.expand(len(MOE_TABLE), *x.shape), weights, eids, count)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("rows", [9, 16, 32])
def test_moe_all_form_counted_bit_identical(cuda_device, rows, bits):
    """TPU #12's form through its entry point: `qbits_moe_all` without a table
    launches `qbits_moe_small_m` once and counts it in its own `launches`
    (with a table it counts nothing), two launches give the same bits, and the
    int2 arm and dead slots past a device count hold against the plain
    version."""
    weights = stacked_experts(cuda_device, 768, 512, seed=rows, bits=bits)
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal((rows, 512)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    before = (MM.qbits_moe_all.launches, MM.qbits_moe_small_m.launches, MM.qbits_moe_small_m.launches_int2)
    out = MM.qbits_moe_all(x, *weights, 128, bits)
    again = MM.qbits_moe_all(x, *weights, 128, bits)
    torch.cuda.synchronize()
    assert (MM.qbits_moe_all.launches, MM.qbits_moe_small_m.launches, MM.qbits_moe_small_m.launches_int2) == (
        before[0] + 2, before[1] + 2, before[2] + 2 * (bits == 2))
    assert torch.equal(out, again)
    ref = MM.qbits_moe_plain(x.expand(8, *x.shape), *weights, 128, bits)
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    table = torch.from_numpy(MOE_TABLE).to(cuda_device)
    MM.qbits_moe_all(x, *weights, 128, bits, eids=table)
    assert MM.qbits_moe_all.launches == before[0] + 2
    check_moe(MM.qbits_moe_small_m, x.expand(8, *x.shape), weights, nslots=torch.tensor(
        5, dtype=torch.int32, device=cuda_device), bits=bits)


# Slab rows of the batched-expert GEMM: the per-slot small-M body (M <= 16), then both sides of the pipelined
# GEMM's 128-row M tiles, up to a prefill slab of 2048.
MOE_TILED_M = [1, 4, 8, 16, 17, 33, 127, 129, 130, 255, 257, 600, 2048, 2049]


def random_experts(device, n, k, gs, bits, seed, E=8):
    """E stacked weights in the Hopper layout from random packed bytes (every
    code value in every position of a byte) and group scales and shifts
    anywhere in [0, 2**bits - 1] steps, at any group size the kernels take
    (the quantizer's layout takes only multiples of 128)."""
    g = torch.Generator(device=device).manual_seed(seed)
    packed = torch.randint(0, 256, (E, n, k * bits // 8), dtype=torch.uint8, device=device, generator=g)
    scale_t = torch.rand((E, k // gs, n), device=device, generator=g) * 0.01 + 0.001
    shift_t = scale_t * torch.rand((E, k // gs, n), device=device, generator=g) * (2**bits - 1)
    return packed, scale_t, shift_t


def moe_tiled_case(device, m, table, n, k, dtype, gs, bits):
    """Weights of group size `gs`, x [U, m, k] and the table of one batched-expert case."""
    weights = random_experts(device, n, k, gs, bits, seed=n + k + gs)
    U = 8 if table == "experts" else len(MOE_TABLE)
    rng = np.random.default_rng(m)
    xg = torch.from_numpy(rng.standard_normal((U, m, k)).astype(np.float32)).to(device, dtype)
    eids = None if table == "experts" else torch.from_numpy(MOE_TABLE).to(device)
    nslots = torch.tensor(4, dtype=torch.int32, device=device) if table == "uniq-n4" else None
    return xg, weights, eids, nslots


@pytest.mark.gpu
@pytest.mark.parametrize("gs", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,k", MOE_SHAPES)
@pytest.mark.parametrize("table", ["experts", "uniq", "uniq-n4"])
@pytest.mark.parametrize("m", MOE_TILED_M)
def test_moe_tiled_matches_plain(cuda_device, m, table, n, k, dtype, gs):
    xg, weights, eids, nslots = moe_tiled_case(cuda_device, m, table, n, k, dtype, gs, 4)
    check_moe(MM.qbits_moe_tiled, xg, weights, eids, nslots, group_size=gs)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 4, 16, 130, 2049])
def test_moe_tiled_bit_identical_and_dead_slots(cuda_device, m, dtype, bits):
    """Two launches give the same bits; with a device count, the slots at or
    past it are exactly zero (none, some, all) and the live ones are the same
    bits as without a count; each call of the wrapper or of
    `qbits_moe_prefill` is one launch, one of the M <= 16 arm's (TPU #15:
    `launches_small_m`, `launches_small_m_int2`) at m <= 16."""
    xg, weights, eids, _ = moe_tiled_case(cuda_device, m, "uniq", 512, 768, dtype, 128, bits)
    full = MM.qbits_moe_tiled(xg, *weights, 128, bits, eids=eids)
    assert torch.equal(full, MM.qbits_moe_tiled(xg, *weights, 128, bits, eids=eids))
    tiled = MM.qbits_moe_tiled
    for n in (0, 3, len(MOE_TABLE)):
        count = torch.tensor(n, dtype=torch.int32, device=cuda_device)
        before = (tiled.launches, tiled.launches_int2, tiled.launches_small_m, tiled.launches_small_m_int2)
        out = MM.qbits_moe_prefill(xg, *weights, 128, bits, eids=eids, nslots=count)
        torch.cuda.synchronize()
        small = m <= 16
        assert (tiled.launches, tiled.launches_int2, tiled.launches_small_m, tiled.launches_small_m_int2) == (
            before[0] + 1, before[1] + (bits == 2), before[2] + small, before[3] + (small and bits == 2))
        assert not out[n:].any()
        assert torch.equal(out[:n], full[:n])


# --- the int2 arms -----------------------------------------------------------------------------


def hopper_weight(device, n, k, bits, group_size, seed):
    """A seeded float32 weight quantized to qint{bits} and repacked to the Hopper layout."""
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)).to(device)
    qtype = qtt.qtypes[f"qint{bits}"]
    scale, shift = qtt.MaxOptimizer()(w, qtype, axis=0, group_size=group_size)
    hop = WeightQBitsHopperArray.from_generic(
        qtt.quantize_weight(w, qtype, 0, scale, shift=shift, group_size=group_size)
    )
    assert hop is not None and hop.bits == bits
    return hop


def check_int2(wrapper, x, packed, scale_t, shift_t, gs):
    before = (wrapper.launches, wrapper.launches_int2)
    out = wrapper(x, packed, scale_t, shift_t, gs, 2).float()
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_int2) == (before[0] + 1, before[1] + 1)
    ref = qbits_mm_plain(x, packed, scale_t, shift_t, gs, 2).float()
    err = (out - ref).abs().max().item()
    if x.dtype == torch.float32:
        assert err <= 1e-4 * ref.abs().max().item()
    else:
        assert err <= 1e-2 * ref.abs().max().item()
        assert torch.nn.functional.cosine_similarity(out.flatten(), ref.flatten(), dim=0) > 1 - 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("group_size", [128, None])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 4, 7, 512, 513, 700, 1024])
def test_int2_kernels_match_plain(cuda_device, m, dtype, group_size):
    hop = hopper_weight(cuda_device, 384, 2048, 2, group_size, seed=m)
    x = torch.from_numpy(np.random.default_rng(m + 1).standard_normal((m, 2048)).astype(np.float32))
    wrapper = qbits_mm_small_m if m <= MAX_M else qbits_mm_tiled
    check_int2(wrapper, x.to(cuda_device, dtype), hop._packed, hop._scale_t, hop._shift_t, hop.kernel_group_size)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(1024, 4096), (4096, 14336)])
@pytest.mark.parametrize("m", [4, 1024])
def test_int2_kernels_every_crumb(cuda_device, m, n, k):
    """Random packed bytes: every crumb value in every position of a byte,
    bytes >= 0xC0 included, at the Llama-3.1-8B linear shapes."""
    g = torch.Generator(device=cuda_device).manual_seed(m + n)
    packed = torch.randint(0, 256, (n, k // 4), dtype=torch.uint8, device=cuda_device, generator=g)
    scale_t = torch.rand((k // 128, n), device=cuda_device, generator=g) * 0.01 + 0.001
    shift_t = scale_t * 1.5
    x = torch.randn((m, k), device=cuda_device, generator=g, dtype=torch.bfloat16)
    check_int2(qbits_mm_small_m if m <= MAX_M else qbits_mm_tiled, x, packed, scale_t, shift_t, 128)


def w2a8_operands(device, m, n, k, gs, seed):
    """Random int8 x, sx, random packed int2 bytes (every crumb value in every
    position of a byte), group scales and shifts anywhere in [0, 3] steps,
    and the requant step s8."""
    g = torch.Generator(device=device).manual_seed(seed)
    xq = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=device, generator=g)
    packed = torch.randint(0, 256, (n, k // 4), dtype=torch.uint8, device=device, generator=g)
    scale_t = torch.rand((k // gs, n), device=device, generator=g) * 0.01 + 0.001
    shift_t = scale_t * torch.rand((k // gs, n), device=device, generator=g) * 3
    sx = torch.tensor(0.0173, device=device)
    return xq, sx, packed, scale_t, shift_t, requant_step(scale_t, shift_t, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k,group_size", [(512, 128), (1024, 256), (2048, 2048), (4096, 128)])
@pytest.mark.parametrize("m", [1, 3, 8, 33, 512, 513, 700, 1024])
def test_w2a8_kernels_match_plain(cuda_device, m, k, group_size, out_dtype):
    xq, sx, packed, scale_t, shift_t, _ = w2a8_operands(cuda_device, m, 384, k, group_size, seed=m + k)
    args = (xq, sx, packed, scale_t, shift_t, group_size, out_dtype, 2)
    wrapper = qbits_mm_int8_small_m if m <= MAX_M else qbits_mm_tiled_int8
    before = (wrapper.launches, wrapper.launches_int2)
    out = wrapper(*args)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_int2) == (before[0] + 1, before[1] + 1)
    assert out.dtype == out_dtype and out.shape == (m, 384)
    check_close(out, qbits_int8_mm_plain(*args), 1e-5 if out_dtype == torch.float32 else None)
    # The router takes the same arm at this M.
    assert torch.equal(qbits_int8_mm(*args[:7], bits=2), out)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("gs", [128, 256])
@pytest.mark.parametrize("n,k", [(1024, 4096), (14336, 4096), (4096, 14336)])
@pytest.mark.parametrize("m", REQUANT_EDGES)
def test_w2a8_requant_kernel_equals_plain(cuda_device, m, n, k, gs, out_dtype):
    xq, sx, packed, scale_t, shift_t, s8 = w2a8_operands(cuda_device, m, n, k, gs, seed=m + n + k + gs)
    args = (xq, sx, packed, scale_t, shift_t, s8, gs, out_dtype, 2)
    before = (qbits_mm_requant_int8.launches, qbits_mm_requant_int8.launches_int2)
    out = qbits_mm_requant_int8(*args)
    torch.cuda.synchronize()
    assert (qbits_mm_requant_int8.launches, qbits_mm_requant_int8.launches_int2) == (before[0] + 1, before[1] + 1)
    assert out.dtype == out_dtype and out.shape == (m, n)
    ref = qbits_requant_int8_mm_plain(*args)
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()


MOE_INT2_SHAPES = [(1024, 512), (512, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,k", MOE_INT2_SHAPES)
@pytest.mark.parametrize("kind,size,nslots", [
    ("sel", 2, None), ("sel", 32, None), ("all", 3, None), ("all", 512, None),
    ("uniq", 4, 3), ("uniq", 8, None),
], ids=lambda v: str(v))
def test_moe_int2_small_m_matches_plain(cuda_device, kind, size, nslots, n, k, dtype):
    weights = stacked_experts(cuda_device, n, k, seed=n, bits=2)
    rng = np.random.default_rng(size)
    x = torch.from_numpy(rng.standard_normal((size, k)).astype(np.float32)).to(cuda_device, dtype)
    if kind == "sel":
        eids = torch.from_numpy(rng.integers(0, 8, size).astype(np.int32)).to(cuda_device)
        check_moe(MM.qbits_moe_small_m, x[:, None, :], weights, eids=eids, bits=2)
    elif kind == "all":
        check_moe(MM.qbits_moe_small_m, x.expand(8, *x.shape), weights, bits=2)
    else:
        eids = torch.from_numpy(MOE_TABLE).to(cuda_device)
        count = None if nslots is None else torch.tensor(nslots, dtype=torch.int32, device=cuda_device)
        check_moe(MM.qbits_moe_small_m, x.expand(len(MOE_TABLE), *x.shape), weights, eids, count, bits=2)


@pytest.mark.gpu
@pytest.mark.parametrize("gs", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,k", MOE_INT2_SHAPES)
@pytest.mark.parametrize("table", ["experts", "uniq", "uniq-n4"])
@pytest.mark.parametrize("m", [1, 16, 17, 33, 127, 129, 255, 257, 600, 2048, 2049])
def test_moe_int2_tiled_matches_plain(cuda_device, m, table, n, k, dtype, gs):
    xg, weights, eids, nslots = moe_tiled_case(cuda_device, m, table, n, k, dtype, gs, 2)
    check_moe(MM.qbits_moe_tiled, xg, weights, eids, nslots, bits=2, group_size=gs)


@pytest.fixture
def one_rank_gloo(cuda_device, tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("xk", ["float", "int8"])
@pytest.mark.parametrize("mode", ["column", "row", "replicated"])
@pytest.mark.parametrize("m", [4, 600])
def test_partitioned_matches_plain(cuda_device, one_rank_gloo, m, mode, xk, bits):
    N, K = 512, 2048
    rng = np.random.default_rng(m + bits)
    qtype = qtt.qint4 if bits == 4 else qtt.qint2
    w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)).to(cuda_device)
    scale, shift = qtt.MaxOptimizer()(w, qtype, axis=0, group_size=128)
    qw = qtt.quantize_weight(w, qtype, 0, scale, shift=shift, group_size=128)
    part = shard_qbits(qw, mode, TPGroup(rank=1, world_size=2, group=one_rank_gloo, device=cuda_device))
    assert isinstance(part, WeightQBitsHopperArray)
    k = part.shape[1]
    if xk == "float":
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    else:
        codes = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(cuda_device)
        x = ActivationQBytesArray(codes, torch.tensor(0.0123, device=cuda_device), qtt.qint8, torch.float32)
    before = (SH.qbits_mm_partitioned.launches, SH.qbits_mm_partitioned.all_reduces)
    out = SH.qbits_mm_partitioned(x, part)
    torch.cuda.synchronize()
    assert (SH.qbits_mm_partitioned.launches, SH.qbits_mm_partitioned.all_reduces) == (
        before[0] + 1, before[1] + (mode == "row"))
    saved, SH._local_mm = SH._local_mm, SH._local_mm_plain
    try:
        ref = SH.qbits_mm_partitioned(x, part)
    finally:
        SH._local_mm = saved
    assert out.dtype == ref.dtype and out.shape == (m, part.shape[0])
    check_close(out, ref, None if xk == "float" else 1e-5)


# --- the tensor-core small-M kernels (#1 and #4): the M-tile edges, split K, bit-stable ------------

# M on both sides of every M-tile edge (8, 16, 32, 64, 128) and its multiples up to MAX_M.
SMALL_M_EDGES = [9, 15, 16, 17, 31, 33, 63, 64, 65, 127, 129, 255, 257, 511, 512]
# K of 68 stages of 64 codes: at N = 1024 the small M tiles split it 14 ways of 5 stages and a last
# one of 3, cutting groups of 256 codes in two.
SPLIT_K = 4352


def small_m_operands(device, m, n, k, gs, bits, seed, x_dtype):
    """Random x (float, or int8 with sx), random packed bytes (every code value
    in every position of a byte) and group scales and shifts anywhere in
    [0, 2**bits - 1] steps."""
    g = torch.Generator(device=device).manual_seed(seed)
    packed = torch.randint(0, 256, (n, k * bits // 8), dtype=torch.uint8, device=device, generator=g)
    scale_t = torch.rand((k // gs, n), device=device, generator=g) * 0.01 + 0.001
    shift_t = scale_t * torch.rand((k // gs, n), device=device, generator=g) * (2**bits - 1)
    if x_dtype == torch.int8:
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=device, generator=g)
    else:
        x = torch.randn((m, k), device=device, generator=g, dtype=x_dtype)
    return x, packed, scale_t, shift_t


def assert_close_to_plain(out, ref, rel):
    out, ref = out.float(), ref.float()
    assert (out - ref).abs().max().item() <= rel * ref.abs().max().item()
    assert torch.nn.functional.cosine_similarity(out.flatten(), ref.flatten(), dim=0) > 1 - 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1024, 14336])
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("gs", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", SMALL_M_EDGES)
def test_small_m_tiles_match_plain(cuda_device, m, dtype, gs, bits, n):
    """#1 against its plain version at every M-tile edge, bf16 and float32 x,
    group sizes 64 / 128 / 256 (the 128-code stages only where 128 divides the
    group), a K that leaves a split-K remainder: float32 x within 1e-4 *
    max|ref| (a bf16 high + low pair), bf16 x within 1e-2 * max|ref|."""
    x, packed, scale_t, shift_t = small_m_operands(cuda_device, m, n, SPLIT_K, gs, bits, m + gs + n, dtype)
    args = (x, packed, scale_t, shift_t, gs, bits)
    out = qbits_mm_small_m(*args)
    assert out.dtype == dtype and out.shape == (m, n)
    assert_close_to_plain(out, qbits_mm_plain(*args), 1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1024, 14336])
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("gs", [64, 128, 256])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", SMALL_M_EDGES)
def test_int8_small_m_tiles_match_plain(cuda_device, m, out_dtype, gs, bits, n):
    """#4 against its plain version at the same edges, bf16 and float32
    output: the integer sums are exact, so float32 within 1e-5 * max|ref| and
    bf16 within 1e-2 * max|ref|."""
    xq, packed, scale_t, shift_t = small_m_operands(cuda_device, m, n, SPLIT_K, gs, bits, m + gs + n, torch.int8)
    args = (xq, torch.tensor(0.0173, device=cuda_device), packed, scale_t, shift_t, gs, out_dtype, bits)
    out = qbits_mm_int8_small_m(*args)
    assert out.dtype == out_dtype and out.shape == (m, n)
    assert_close_to_plain(out, qbits_int8_mm_plain(*args), 1e-5 if out_dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("x_kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("m", [4, 64, 512])
def test_small_m_bit_identical_across_launches(cuda_device, m, x_kind):
    """Split K sums its partials in a fixed order (no atomics), and the first
    pass's sums of x are deterministic: two launches give the same bits."""
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}[x_kind]
    x, packed, scale_t, shift_t = small_m_operands(cuda_device, m, 1024, SPLIT_K, 256, 4, m, dtype)
    if x_kind == "int8":
        sx = torch.tensor(0.0173, device=cuda_device)
        run = lambda: qbits_mm_int8_small_m(x, sx, packed, scale_t, shift_t, 256, torch.float32)  # noqa: E731
    else:
        run = lambda: qbits_mm_small_m(x, packed, scale_t, shift_t, 256)  # noqa: E731
    first = run()
    assert torch.equal(first, run())


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("m", [4, 64, 512])
def test_small_m_launch_counts(cuda_device, m, bits):
    """Each call of either small-M wrapper, or of the routers on M <= MAX_M,
    is one launch in `launches` (and, for int2 codes, in `launches_int2`),
    whatever passes (first pass, split-K sum) it runs."""
    x, packed, scale_t, shift_t = small_m_operands(cuda_device, m, 1024, SPLIT_K, 256, bits, m, torch.bfloat16)
    xq = torch.randint(-128, 128, x.shape, dtype=torch.int8, device=cuda_device)
    sx = torch.tensor(0.0173, device=cuda_device)
    calls = [
        (qbits_mm_small_m, lambda: qbits_mm_small_m(x, packed, scale_t, shift_t, 256, bits)),
        (qbits_mm_small_m, lambda: qbits_mm(x, packed, scale_t, shift_t, 256, bits)),
        (qbits_mm_int8_small_m,
         lambda: qbits_mm_int8_small_m(xq, sx, packed, scale_t, shift_t, 256, torch.bfloat16, bits)),
        (qbits_mm_int8_small_m, lambda: qbits_int8_mm(xq, sx, packed, scale_t, shift_t, 256, torch.bfloat16, bits=bits)),
    ]
    for wrapper, call in calls:
        before = (wrapper.launches, wrapper.launches_int2)
        call()
        torch.cuda.synchronize()
        assert (wrapper.launches, wrapper.launches_int2) == (before[0] + 1, before[1] + (bits == 2))


# TPU #2, both arms (`qbits_mm_tiled`, `qbits_mm_tiled_int8`): the pipelined wgmma GEMMs of
# csrc/qbits_mm_tiled.cu, 128 x 128 output tiles. M on both sides of the tile edges (128-row M
# tiles; 4064 is the ctx-8192 run's chunk of 4 x 1016 rows).
TILED_M = [513, 640, 1023, 1024, 1025, 2047, 4064, 4096, 4097]


def tiled_run(device, m, n, k, gs, bits, x_kind, seed):
    """The arm's kernel and plain version on random operands (small_m_operands):
    float x (bf16 or f32, out in x's dtype) or int8 x with sx (x_kind
    "int8-bf16" / "int8-f32": the output dtype); returns (out, ref, f32 tol)."""
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}.get(x_kind, torch.int8)
    x, packed, scale_t, shift_t = small_m_operands(device, m, n, k, gs, bits, seed, dtype)
    if dtype == torch.int8:
        out_dtype = torch.float32 if x_kind == "int8-f32" else torch.bfloat16
        args = (x, torch.tensor(0.0173, device=device), packed, scale_t, shift_t, gs, out_dtype, bits)
        out = qbits_mm_tiled_int8(*args)
        assert out.dtype == out_dtype and out.shape == (m, n)
        return out, qbits_int8_mm_plain(*args), 1e-5 if out_dtype == torch.float32 else None
    args = (x, packed, scale_t, shift_t, gs, bits)
    out = qbits_mm_tiled(*args)
    assert out.dtype == dtype and out.shape == (m, n)
    return out, qbits_mm_plain(*args), 1e-4 if dtype == torch.float32 else None


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("x_kind", ["bf16", "f32", "int8-bf16", "int8-f32"])
@pytest.mark.parametrize("m", TILED_M)
def test_tiled_m_edges_match_plain(cuda_device, m, x_kind, bits):
    """Both arms of #2 at every M-tile edge, N = 1152 (not a multiple of 256),
    K = 2048, group size 128, over random packed bytes: float32 x within
    1e-4 * max|ref| (a bf16 high + low pair), int8 x with a float32 output
    within 1e-5 * max|ref| (exact int32 group sums), bf16 outputs within
    1e-2 * max|ref| and cosine > 1 - 1e-4."""
    out, ref, tol = tiled_run(cuda_device, m, 1152, 2048, 128, bits, x_kind, m + bits)
    check_close(out, ref, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("x_kind", ["bf16", "f32", "int8-f32"])
@pytest.mark.parametrize("k", [2048, 4096, 14336])
@pytest.mark.parametrize("gs", [64, 128, 256, "K"])
def test_tiled_group_sizes_match_plain(cuda_device, gs, k, x_kind, bits):
    """Both arms at group sizes 64, 128, 256 and K (per axis: one fold a tile)
    and K in {2048, 4096, 14336}, M = 1025, N = 384; tolerances as above."""
    gs = k if gs == "K" else gs
    out, ref, tol = tiled_run(cuda_device, 1025, 384, k, gs, bits, x_kind, gs + k + bits)
    check_close(out, ref, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("x_kind", ["bf16", "int8-bf16"])
@pytest.mark.parametrize("n,k", [(384, 4096), (1024, 4096), (1152, 4096), (14336, 4096), (4096, 14336)])
def test_tiled_widths_match_plain(cuda_device, n, k, x_kind, bits):
    """Both arms at N in {384, 1024, 1152, 14336} (K = 4096) and the down
    projection (4096 x 14336), M = 4097; tolerances as above."""
    out, ref, tol = tiled_run(cuda_device, 4097, n, k, 128, bits, x_kind, n + k + bits)
    check_close(out, ref, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("x_kind", ["bf16", "f32", "int8-bf16", "int8-f32"])
def test_tiled_bit_identical_and_counted(cuda_device, x_kind, bits):
    """Two launches give the same bits (sums in a fixed order, no atomics),
    and each call of the wrapper or of the router at M > MAX_M is one launch
    in `launches` (and, for int2 codes, in `launches_int2`), whatever passes
    it runs."""
    m, n, k = 2047, 1024, 4096
    out, _, _ = tiled_run(cuda_device, m, n, k, 128, bits, x_kind, 5)
    again, _, _ = tiled_run(cuda_device, m, n, k, 128, bits, x_kind, 5)
    assert torch.equal(out, again)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}.get(x_kind, torch.int8)
    x, packed, scale_t, shift_t = small_m_operands(cuda_device, m, n, k, 128, bits, 5, dtype)
    if dtype == torch.int8:
        sx, od = torch.tensor(0.0173, device=cuda_device), out.dtype
        wrapper = qbits_mm_tiled_int8
        calls = [lambda: qbits_mm_tiled_int8(x, sx, packed, scale_t, shift_t, 128, od, bits),
                 lambda: qbits_int8_mm(x, sx, packed, scale_t, shift_t, 128, od, bits=bits)]
    else:
        wrapper = qbits_mm_tiled
        calls = [lambda: qbits_mm_tiled(x, packed, scale_t, shift_t, 128, bits),
                 lambda: qbits_mm(x, packed, scale_t, shift_t, 128, bits)]
    for call in calls:
        before = (wrapper.launches, wrapper.launches_int2)
        assert torch.equal(call(), out)
        torch.cuda.synchronize()
        assert (wrapper.launches, wrapper.launches_int2) == (before[0] + 1, before[1] + (bits == 2))


@pytest.mark.gpu
def test_tiled_refusals(cuda_device):
    """Shapes off the envelope raise on CUDA tensors before any launch."""
    x, packed, scale_t, shift_t = small_m_operands(cuda_device, 600, 384, 2048, 128, 4, 0, torch.bfloat16)
    xq = torch.randint(-128, 128, x.shape, dtype=torch.int8, device=cuda_device)
    sx = torch.tensor(0.0173, device=cuda_device)
    before = (qbits_mm_tiled.launches, qbits_mm_tiled_int8.launches)
    with pytest.raises(ValueError, match="multiple of 128"):
        qbits_mm_tiled(x, packed[:320], scale_t[:, :320], shift_t[:, :320], 128)
    with pytest.raises(ValueError, match="multiple of 64"):
        qbits_mm_tiled(x, packed, scale_t.repeat(2, 1)[:21], shift_t.repeat(2, 1)[:21], 96)
    with pytest.raises(ValueError, match="contiguous"):
        qbits_mm_tiled(x.t().contiguous().t(), packed, scale_t, shift_t, 128)
    with pytest.raises(ValueError, match="one device"):
        qbits_mm_tiled(x, packed, scale_t.cpu(), shift_t.cpu(), 128)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        qbits_mm_tiled(x.half(), packed, scale_t, shift_t, 128)
    with pytest.raises(TypeError, match="int8"):
        qbits_mm_tiled_int8(x, sx, packed, scale_t, shift_t, 128, torch.bfloat16)
    with pytest.raises(TypeError, match="output dtype"):
        qbits_mm_tiled_int8(xq, sx, packed, scale_t, shift_t, 128, torch.float16)
    with pytest.raises(ValueError, match="bits"):
        qbits_mm_tiled_int8(xq, sx, packed, scale_t, shift_t, 128, torch.bfloat16, 3)
    assert (qbits_mm_tiled.launches, qbits_mm_tiled_int8.launches) == before


# (page size, slots a row, rows, spec, D): the paged arm's cases; positions at random below S.
PAGED = {
    "ps4_qint4": (4, 96, 3, "qint4", 128),
    "ps16_bf16": (16, 1088, 4, None, 128),
    "ps16_k8v4": (16, 1088, 4, "k8v4", 64),
    "ps64_qint8": (64, 4352, 8, "qint8", 128),
    "ps64_qint4a": (64, 768, 8, "qint4a", 128),
}


def check_flash_decode_paged(device, ps, S, B, spec, D, dtype, Hkv=2, spare=0, seed=0):
    """A paged cache of B rows of S slots over a shuffled table (`spare` pages
    before them), written by `kv_update`, and q: the paged arm one launch on
    its counter, two calls the same bits, EQUAL to the dense arm on the
    gathered pages, and within the dense tolerances of its plain version."""
    P = S // ps
    g = torch.Generator(device=device).manual_seed(seed)
    layer = tpk.init_paged_kv_cache(1, 1 + spare + B * P, ps, B, P, Hkv, D, spec, torch.bfloat16, device)[0]
    perm = torch.randperm(B * P, generator=torch.Generator().manual_seed(seed)) + 1 + spare
    layer._table.copy_(perm.reshape(B, P).to(torch.int32))
    k = torch.randn((B, S, Hkv, D), device=device, generator=g) * 2 + 0.5
    tkv.kv_update(layer, k, torch.randn(k.shape, device=device, generator=g), 0)
    q = torch.randn((B, Hkv, 4, D), device=device, generator=g).to(dtype)
    pos = torch.randint(0, S, (B,), device=device, generator=g, dtype=torch.int32)
    pos[0] = S - 1
    c = layer
    args = (q, c._k_pages, c._v_pages, c._k_scale, c._v_scale, c._table, pos)
    kw = dict(k_shift=c._k_shift, v_shift=c._v_shift)
    before = (flash_decode_paged.launches, flash_decode.launches)
    out = flash_decode_paged(*args, **kw)
    assert (flash_decode_paged.launches, flash_decode.launches) == (before[0] + 1, before[1])
    assert torch.equal(out, flash_decode_paged(*args, **kw))
    kg, vg, ks, vs, km, vm = tpk.paged_gather(layer, B)
    assert torch.equal(out, flash_decode(q, kg, vg, ks, vs, pos, k_shift=km, v_shift=vm))
    torch.cuda.synchronize()
    ref = flash_decode_paged_plain(*args, **kw).float()
    err = (out.float() - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * ref.abs().max().item()
    else:
        assert err <= 1e-2 * ref.abs().max().item()
        assert torch.nn.functional.cosine_similarity(out.float().flatten(), ref.flatten(), dim=0) > 1 - 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("case", list(PAGED))
def test_flash_decode_paged_matches_dense(cuda_device, case, dtype):
    ps, S, B, spec, D = PAGED[case]
    check_flash_decode_paged(cuda_device, ps, S, B, spec, D, dtype, Hkv=8 if ps == 64 else 2)


@pytest.mark.gpu
def test_flash_decode_paged_pool_past_2gb(cuda_device):
    """A bf16 pool of 16400 pages of 64 x 8 x 128 (2.15 GB each for K and
    V), the rows' pages at its end: page offsets need 64 bits."""
    check_flash_decode_paged(cuda_device, 64, 1024, 4, None, 128, torch.bfloat16, Hkv=8, spare=16336)


# --- W8A8, the padded layout and the small models' attention heads -----------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("payload", ["qint8", "qfloat8_e4m3fn"])
@pytest.mark.parametrize("n,k", [(1024, 4096), (14336, 4096), (4096, 14336), (96, 200)])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 4096])
def test_w8a8_route_matches_plain(cuda_device, m, n, k, payload):
    """The W8A8 route of `ops/qbytes_mm.py` (`torch._int_mm`, rows padded to
    its least M; e4m3fn through `_fp8_dot`, JAX's convert formula on bf16
    operands) against its plain formula: int8 EQUAL (the int32 sum is exact
    on both), e4m3fn within 1e-5 * max|ref| (exact products, float32 sums in
    another order). One library call counted a call inside the envelope;
    none outside it (N = 96 and K = 200 do take `_int_mm`; e4m3fn has no
    envelope)."""
    from quanto_tpu_torch.ops import qbytes_mm as W8A8

    qtype = qtt.qtypes[payload]
    rng = np.random.default_rng(m + n)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((2, m, k)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    qw = qtt.quantize_weight(w, qtype, 0, qtt.AbsmaxOptimizer()(w, qtype, 0))
    qx = qtt.quantize_activation(x, qtype, (x.float().abs().amax() / qtype.qmax).reshape(()))
    scale = qx._scale * qw._scale.float()
    fn, plain, eligible = (
        (W8A8.qbytes_int_mm, W8A8.qbytes_int_mm_plain, W8A8.int_mm_eligible) if payload == "qint8"
        else (W8A8.qbytes_fp8_mm, W8A8.qbytes_fp8_mm_plain, lambda k, n: True)
    )
    before = fn.launches
    out = W8A8.qbytes_mm(qx._data, qw._data, scale)
    torch.cuda.synchronize()
    assert fn.launches == before + eligible(k, n)
    assert out.shape == (2, m, n) and out.dtype == torch.float32
    ref = (plain(qx._data.reshape(-1, k), qw._data) * scale.t()).reshape(2, m, n)
    if payload == "qint8":
        assert torch.equal(out, ref)
    else:
        check_close(out, ref, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("xk", ["bf16", "int8"])
@pytest.mark.parametrize("n,k,gs", [(960, 960, 96), (320, 960, 96), (960, 2560, 128), (896, 896, 128),
                                    (128, 896, 128), (4864, 896, 128)])
@pytest.mark.parametrize("m", [4, 600, 4096])
def test_padded_qlinear_matches_plain(cuda_device, m, n, k, gs, xk):
    """`qlinear` over a weight zero-padded onto the envelope (SmolLM2-360M's and
    Qwen2.5-0.5B's linears): one launch of #1 / #2 (float x) or #4 / #2's int8
    arm (int8 x) on x padded by `pad_activations`, the padded columns dropped,
    against the same `qlinear` on the CPU (the plain versions), with the
    tolerances of the unpadded kernels (bf16 output: 1e-2 * max|ref| and
    cosine > 1 - 1e-4)."""
    from quanto_tpu_torch.ops.qlinear import qlinear

    rng = np.random.default_rng(m + n + k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(torch.bfloat16)
    scale, shift = qtt.MaxOptimizer()(w, qtt.qint4, axis=0, group_size=gs)
    generic = qtt.quantize_weight(w, qtt.qint4, 0, scale, shift=shift, group_size=gs)
    cpu = WeightQBitsHopperArray.from_generic(generic)
    hop = WeightQBitsHopperArray.from_generic(dataclasses.replace(
        generic, _data=dataclasses.replace(generic._data, _data=generic._data._data.to(cuda_device)),
        _scale=generic._scale.to(cuda_device), _shift=generic._shift.to(cuda_device),
    ))
    assert hop.pad is not None and hop.pad == cpu.pad
    assert torch.equal(hop._packed.cpu(), cpu._packed) and torch.equal(hop._scale_t.cpu(), cpu._scale_t)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    if xk == "int8":
        x = qtt.quantize_activation(x, qtt.qint8, (x.float().abs().amax() / 127).reshape(()))
        xd = ActivationQBytesArray(_data=x._data.to(cuda_device), _scale=x._scale.to(cuda_device),
                                   qtype=x.qtype, float_dtype=x.float_dtype)
        wrapper = qbits_mm_int8_small_m if m <= MAX_M else qbits_mm_tiled_int8
    else:
        xd = x.to(cuda_device)
        wrapper = qbits_mm_small_m if m <= MAX_M else qbits_mm_tiled
    before = wrapper.launches
    out = qlinear(xd, hop)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and out.shape == (m, n) and out.is_contiguous()
    # Compared on the card: a float32 cosine over millions of elements summed on the CPU is itself
    # off by about 1e-4 (0.99994 for two equal vectors of 4096 x 960).
    check_close(out, qlinear(x, cpu).to(cuda_device), None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("heads", [(5, 3), (2, 7)], ids=["smollm2-5x3", "qwen2.5-2x7"])
@pytest.mark.parametrize("cache", [("bfloat16", "bfloat16", False), ("qint8", "qint8", False),
                                   ("qint4", "qint4", False)], ids=["bf16", "qint8", "qint4"])
def test_flash_decode_small_model_heads(cuda_device, cache, heads, dtype):
    """`flash_decode` at SmolLM2-360M's (Hkv, G) = (5, 3) and Qwen2.5-0.5B's
    (2, 7), D = 64, over the decode run's 1088 slots."""
    Hkv, G = heads
    check_flash_decode(cuda_device, cache, 1088, 64, dtype, G=G, Hkv=Hkv)
