"""The plain versions behind the MoE kernel wrappers against quanto_tpu's
stacked-expert Pallas kernels (`quanto_tpu/ops/pallas/moe_mm.py`), run in
interpret mode.

Both sides hold the same int4 codes: each expert's float32 weight is
quantized by both packages (codes, scales and shifts bit for bit, checked
here), frozen into the TPU layout on the JAX side and repacked with
`WeightQBitsHopperArray.from_generic` on the port's, then stacked. The port's
entry points take the plain version on a CPU tensor (no launch is counted).

Cases: `qbits_moe_sel` at nsel in {2, 9, 30}; `qbits_moe_all` at S = 8, over
every expert and over a 6-slot expert table; `qbits_moe_prefill` over 8-,
24- and 136-row slabs, with and without a table; at both projection shapes of the
tiny Mixtral (N x K = 512 x 256, 256 x 512). Tolerance: max abs error <=
1e-5 * max|ref| in float32 (the TPU kernels sum group-factored, the plain
version dequantizes first). The port's device count `nslots` is held to the
same result with the skipped slots zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.ops.pallas import moe_mm as jax_moe
from quanto_tpu.tensor.weights import WeightQBitsTpuArray
from quanto_tpu_torch.ops.cuda import moe_mm
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

from .test_torch_quantize import bits_of

E, GS = 8, 128
SHAPES = [(512, 256), (256, 512)]  # (N, K): the tiny Mixtral's w1/w3 and w2


def stacked(N: int, K: int, seed: int):
    """(JAX (packed, scale_t, shift_t), port (packed, scale_t, shift_t)) of E experts."""
    rng = np.random.default_rng(seed)
    jax_w, port_w = [], []
    for _ in range(E):
        w = rng.standard_normal((N, K)).astype(np.float32)
        wj = jnp.asarray(w)
        sj, zj = qt.MaxOptimizer()(wj, qt.qint4, axis=0, group_size=GS)
        gj = qt.quantize_weight(wj, qt.qint4, 0, sj, shift=zj, group_size=GS)
        wt = torch.from_numpy(w)
        st, zt = qtt.MaxOptimizer()(wt, qtt.qint4, axis=0, group_size=GS)
        gt = qtt.quantize_weight(wt, qtt.qint4, 0, st, shift=zt, group_size=GS)
        for a, b in ((gt._data.packed_data, gj._data._data), (gt._scale, gj._scale), (gt._shift, gj._shift)):
            np.testing.assert_array_equal(bits_of(a), bits_of(b))
        jax_w.append(WeightQBitsTpuArray.from_generic(gj))
        port_w.append(WeightQBitsHopperArray.from_generic(gt))
    j = tuple(jnp.stack([getattr(w, f) for w in jax_w]) for f in ("_packed", "_scale_t", "_shift_t"))
    p = tuple(torch.stack([getattr(w, f) for w in port_w]) for f in ("_packed", "_scale_t", "_shift_t"))
    return j, p


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def weights(request):
    N, K = request.param
    return N, K, *stacked(N, K, seed=N + K)


def close(out: torch.Tensor, ref) -> None:
    ref = np.asarray(ref, np.float32)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))


def no_launch(fn, *args, **kw):
    """Run a port entry point on CPU tensors: its wrapper counts no launch."""
    before = (moe_mm.qbits_moe_small_m.launches, moe_mm.qbits_moe_tiled.launches)
    out = fn(*args, **kw)
    assert (moe_mm.qbits_moe_small_m.launches, moe_mm.qbits_moe_tiled.launches) == before
    return out


@pytest.mark.parametrize("nsel", [2, 9, 30])
def test_sel_matches_pallas(weights, nsel):
    N, K, jw, pw = weights
    rng = np.random.default_rng(nsel)
    x = rng.standard_normal((nsel, K)).astype(np.float32)
    eids = rng.integers(0, E, nsel).astype(np.int32)
    ref = jax_moe.qbits_moe_sel_call(jnp.asarray(x), jnp.asarray(eids), *jw, 4, GS, interpret=True)
    out = no_launch(moe_mm.qbits_moe_sel, torch.from_numpy(x), torch.from_numpy(eids), *pw, GS)
    close(out, ref)


def test_sel_takes_at_most_sel_max(weights):
    N, K, _, pw = weights
    x = torch.zeros((moe_mm.SEL_MAX + 1, K))
    with pytest.raises(ValueError, match="at most"):
        moe_mm.qbits_moe_sel(x, torch.zeros(moe_mm.SEL_MAX + 1, dtype=torch.int32), *pw, GS)


UNIQ = np.array([6, 1, 3, 0, 7, 4], np.int32)


@pytest.mark.parametrize("table", [False, True], ids=["all", "uniq"])
def test_all_matches_pallas(weights, table):
    N, K, jw, pw = weights
    x = np.random.default_rng(8).standard_normal((8, K)).astype(np.float32)
    kw_j = dict(eids=jnp.asarray(UNIQ)) if table else {}
    kw_p = dict(eids=torch.from_numpy(UNIQ)) if table else {}
    ref = jax_moe.qbits_moe_all_call(jnp.asarray(x), *jw, 4, GS, interpret=True, **kw_j)
    out = no_launch(moe_mm.qbits_moe_all, torch.from_numpy(x), *pw, GS, **kw_p)
    close(out, ref)


@pytest.mark.parametrize("table", [False, True], ids=["experts", "uniq"])
@pytest.mark.parametrize("cap", [8, 24, 136])
def test_prefill_matches_pallas(weights, cap, table):
    """cap 136: not a multiple of the Hopper GEMM's 128-row M tile (JAX's
    `_moe_prefill_call` takes any multiple of 8)."""
    N, K, jw, pw = weights
    U = len(UNIQ) if table else E
    xg = np.random.default_rng(cap).standard_normal((U, cap, K)).astype(np.float32)
    kw_j = dict(eids=jnp.asarray(UNIQ)) if table else {}
    kw_p = dict(eids=torch.from_numpy(UNIQ)) if table else {}
    ref = jax_moe.qbits_moe_prefill_call(jnp.asarray(xg), *jw, 4, GS, interpret=True, **kw_j)
    out = no_launch(moe_mm.qbits_moe_prefill, torch.from_numpy(xg), *pw, GS, **kw_p)
    close(out, ref)


@pytest.mark.parametrize("nslots", [0, 3, 6])
def test_nslots_zeroes_the_skipped_slots(weights, nslots):
    """The device count: the slots below it as without a count, the rest zero."""
    N, K, _, pw = weights
    rng = np.random.default_rng(nslots)
    x = torch.from_numpy(rng.standard_normal((8, K)).astype(np.float32))
    eids = torch.from_numpy(UNIQ)
    n = torch.tensor(nslots, dtype=torch.int32)
    full = moe_mm.qbits_moe_all(x, *pw, GS, eids=eids)
    out = moe_mm.qbits_moe_all(x, *pw, GS, eids=eids, nslots=n)
    torch.testing.assert_close(out[:nslots], full[:nslots], rtol=0, atol=0)
    assert not out[nslots:].any()
    xg = torch.from_numpy(rng.standard_normal((len(UNIQ), 8, K)).astype(np.float32))
    out = moe_mm.qbits_moe_prefill(xg, *pw, GS, eids=eids, nslots=n)
    torch.testing.assert_close(out[:nslots], moe_mm.qbits_moe_prefill(xg, *pw, GS, eids=eids)[:nslots])
    assert not out[nslots:].any()


def test_wrappers_check_operands(weights):
    N, K, _, (packed, scale_t, shift_t) = weights
    x3 = torch.zeros((E, 4, K))
    with pytest.raises(ValueError, match="one slot per expert"):
        moe_mm.qbits_moe_tiled(x3[:3], packed, scale_t, shift_t, GS)
    with pytest.raises(ValueError, match="eids must be int32"):
        moe_mm.qbits_moe_tiled(x3, packed, scale_t, shift_t, GS, eids=torch.arange(E))
    with pytest.raises(ValueError, match="M <="):
        moe_mm.qbits_moe_small_m(torch.zeros((E, 513, K)), packed, scale_t, shift_t, GS)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        moe_mm.qbits_moe_tiled(x3.half(), packed, scale_t, shift_t, GS)
