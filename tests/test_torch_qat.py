"""Quantization-aware training of quanto_tpu_torch against quanto_tpu.

- `fake_quantize_weight` (qint8, qint4 group-wise, qfloat8_e4m3fn) and
  `fake_quantize_activation` (qint8, qfloat8_e4m3fn): the forward equal to
  JAX's bit for bit, and the gradients of sum(out * g) equal to
  `jax.grad`'s: g for the tensor (straight through), zeros for the scale
  and the shift.
- A `qat` `QLinear` (JAX's `test_qlinear_qat_gradients` setup: a [64 -> 128]
  linear with bias, qint8 or qint4 weights and qint8 activations, with
  input and output scales set): its forward against JAX's module, and the
  gradients of mean(out ** 2) with respect to its weight and bias against
  `nnx.grad`'s, within 1e-5 * max|ref| (float32 sums in another order).
  Freezing it afterwards leaves the fake-quantized product behind: the
  frozen forward equals the QAT forward within 1e-5 * max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.nn import QLinear as JaxQLinear
from quanto_tpu.tensor.activations import fake_quantize_activation as jax_fqa
from quanto_tpu.tensor.weights import fake_quantize_weight as jax_fqw
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.tensor.activations import fake_quantize_activation
from quanto_tpu_torch.tensor.weights import fake_quantize_weight

from .test_torch_llama import close
from .test_torch_quantize import bits_of


def _t(a: np.ndarray, grad: bool = False) -> torch.Tensor:
    return torch.tensor(a, requires_grad=grad)


@pytest.mark.parametrize("name,group_size", [("qint8", None), ("qint4", 32), ("qfloat8_e4m3fn", None)])
def test_fake_quantize_weight_matches_jax(name, group_size):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 128)).astype(np.float32)
    g = rng.standard_normal((64, 128)).astype(np.float32)
    q_t, q_j = qtt.qtypes[name], qt.qtypes[name]
    if q_t.bits == 8:
        scale = qtt.AbsmaxOptimizer()(torch.from_numpy(w), q_t, 0).numpy()
        shift = None
    else:
        s, z = qtt.MaxOptimizer()(torch.from_numpy(w), q_t, 0, group_size=group_size)
        scale, shift = s.numpy(), z.numpy()
    wt, st = _t(w, True), _t(scale, True)
    zt = None if shift is None else _t(shift, True)
    out = fake_quantize_weight(wt, q_t, 0, st, zt, group_size)
    (out * torch.from_numpy(g)).sum().backward()

    def f(w_, s_, z_):
        return jnp.sum(jax_fqw(w_, q_j, 0, s_, z_, group_size) * g)

    zj = None if shift is None else jnp.asarray(shift)
    ref = jax_fqw(jnp.asarray(w), q_j, 0, jnp.asarray(scale), zj, group_size)
    np.testing.assert_array_equal(bits_of(out.detach()), bits_of(ref))
    argnums = (0, 1) if shift is None else (0, 1, 2)
    grads = jax.grad(f, argnums=argnums)(jnp.asarray(w), jnp.asarray(scale), zj)
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(grads[0]))
    np.testing.assert_array_equal(st.grad.numpy(), np.asarray(grads[1]))
    assert not st.grad.any()
    if shift is not None:
        np.testing.assert_array_equal(zt.grad.numpy(), np.asarray(grads[2]))
        assert not zt.grad.any()


@pytest.mark.parametrize("name", ["qint8", "qfloat8_e4m3fn"])
def test_fake_quantize_activation_matches_jax(name):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    g = rng.standard_normal((4, 64)).astype(np.float32)
    scale = np.float32(0.02)
    xt, st = _t(x, True), _t(scale, True)
    out = fake_quantize_activation(xt, qtt.qtypes[name], st)
    (out * torch.from_numpy(g)).sum().backward()
    ref = jax_fqa(jnp.asarray(x), qt.qtypes[name], jnp.float32(scale))
    np.testing.assert_array_equal(bits_of(out.detach()), bits_of(ref))
    gx, gs = jax.grad(lambda a, s: jnp.sum(jax_fqa(a, qt.qtypes[name], s) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.float32(scale)
    )
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx))
    assert st.grad.item() == float(gs) == 0.0


@pytest.mark.parametrize("weights", ["qint8", "qint4"])
def test_qat_qlinear_gradients_match_jax(weights):
    linear = nnx.Linear(64, 128, use_bias=True, rngs=nnx.Rngs(0))
    jq = JaxQLinear.from_module(linear, weights=qt.qtypes[weights], activations=qt.qint8)
    jq.qat = True
    jq.input_scale.set_value(jnp.float32(0.03))
    jq.output_scale.set_value(jnp.float32(0.05))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (4, 64), jnp.float32))

    def loss_fn(model, x_):
        return jnp.mean(jnp.square(model(x_)))

    grads = nnx.grad(loss_fn)(jq, jnp.asarray(x))
    ref_out = np.asarray(jq(jnp.asarray(x)))

    m = QLinear(64, 128, bias=True, weights=weights, activations="qint8", device="cpu")
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.array(jq.weight.get_value())))
        m.bias.copy_(torch.from_numpy(np.array(jq.bias.get_value())))
        m.input_scale.fill_(0.03)
        m.output_scale.fill_(0.05)
    m.qat = True
    m.weight.requires_grad_(True)
    m.bias.requires_grad_(True)
    out = m(torch.from_numpy(x))
    torch.mean(torch.square(out)).backward()
    close(out, ref_out, 1e-5)
    for name in ("weight", "bias"):
        ref = np.asarray(getattr(grads, name).get_value())
        got = getattr(m, name).grad
        assert got is not None and torch.isfinite(got).all() and got.abs().sum() > 0
        close(got, ref, 1e-5)
    assert m.input_scale.grad is None and m.output_scale.grad is None  # buffers: no gradient

    m.freeze()  # `qat` stays on: the activations are still fake-quantized, as in JAX
    with torch.no_grad():
        frozen = m(torch.from_numpy(x))
    close(frozen, out.detach().numpy(), 1e-5)
