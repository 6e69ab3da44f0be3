"""`HqqOptimizer` of quanto_tpu_torch against quanto_tpu's.

Seeded weights (float32 and bfloat16, axis 0 and -1, int4 and int2, the
group sizes 64, 96 and 128) through both packages' optimizers, in both of
each one's loops (the default one without host syncs, JAX's
`lax.while_loop`, and the `verbose` eager one):

- the scale is `MaxOptimizer`'s, bit for bit;
- the shift agrees with JAX's within 1e-5 * max|shift| in 99% of the groups
  at least, and the quantized weight's mean error within 1e-5 of JAX's,
  relative: the means over a group are float32 sums in another order, so a
  value at a rounding half can take the other code in one package and its
  group a slightly different step (one group of 512 in the first case);
- JAX's eager loop computes in the base dtype and its default loop in
  float32, so for a bfloat16 weight the two differ in JAX and the port
  (float32 in both loops, as JAX's default) is held to JAX's default loop;
- the port's two loops give the same shift bit for bit, and the verbose loop
  prints JAX's lines;
- its error is no larger than `MaxOptimizer`'s (JAX's `test_hqq_beats_max`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.tensor.optimizers import HqqOptimizer as JaxHqq

from .test_torch_quantize import bits_of

# (shape, dtype, axis, bits, group size)
CASES = [
    ((128, 256), "float32", 0, 4, 64),
    ((192, 384), "bfloat16", 0, 4, 96),
    ((128, 256), "float32", -1, 4, 128),
    ((64, 256), "float32", 0, 2, 64),
]
IDS = [f"{s[0]}x{s[1]}-{d}-axis{a}-int{b}-gs{g}" for s, d, a, b, g in CASES]


def mean_error(t: torch.Tensor, qt_, axis, scale, shift, group_size) -> float:
    w = qtt.quantize_weight(t, qt_, axis, scale, shift=shift, group_size=group_size)
    return float((w.dequantize().float() - t.float()).abs().mean())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_hqq_matches_jax(case, capsys):
    shape, dtype, axis, bits, gs = case
    w = (np.random.default_rng(0).standard_normal(shape) * 0.05).astype(np.float32)
    t = torch.from_numpy(w).to(getattr(torch, dtype))
    j = jnp.asarray(w).astype(getattr(jnp, dtype))
    qtype_t, qtype_j = qtt.qtypes[f"qint{bits}"], qt.qtypes[f"qint{bits}"]

    scale, shift = qtt.HqqOptimizer()(t, qtype_t, axis=axis, group_size=gs)
    scale_v, shift_v = qtt.HqqOptimizer(verbose=True)(t, qtype_t, axis=axis, group_size=gs)
    port_lines = capsys.readouterr().out.splitlines()
    assert torch.equal(scale_v, scale) and torch.equal(shift_v, shift)
    assert port_lines[0].startswith("Start error: ") and len(port_lines) >= 2

    for verbose in (False, True) if dtype == "float32" else (False,):
        sj, zj = JaxHqq(verbose=verbose)(j, qtype_j, axis=axis, group_size=gs)
        np.testing.assert_array_equal(bits_of(scale), bits_of(sj))
        zj = np.array(zj, np.float32)
        assert shift.shape == zj.shape and shift.dtype == t.dtype
        off = np.abs(shift.float().numpy() - zj) > 1e-5 * np.abs(zj).max()
        assert off.mean() <= 0.01, off.sum()
        err_j = mean_error(t, qtype_t, axis, scale, torch.from_numpy(zj).to(t.dtype), gs)
        err = mean_error(t, qtype_t, axis, scale, shift, gs)
        assert abs(err - err_j) <= 1e-5 * err_j
    jax_lines = capsys.readouterr().out.splitlines()
    if dtype == "float32":
        assert [line.split(":")[0] for line in jax_lines] == [line.split(":")[0] for line in port_lines]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_hqq_beats_max(case):
    shape, dtype, axis, bits, gs = case
    t = torch.from_numpy((np.random.default_rng(1).standard_normal(shape) * 0.05).astype(np.float32))
    t = t.to(getattr(torch, dtype))
    qtype = qtt.qtypes[f"qint{bits}"]
    err_hqq = mean_error(t, qtype, axis, *qtt.HqqOptimizer(iters=10)(t, qtype, axis=axis, group_size=gs), gs)
    err_max = mean_error(t, qtype, axis, *qtt.MaxOptimizer()(t, qtype, axis=axis, group_size=gs), gs)
    assert err_hqq <= err_max + 1e-6
