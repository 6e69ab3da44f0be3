"""The off-envelope padding rule of the Hopper layout against quanto_tpu's.

A weight whose shape is off the kernels' envelope (N % 128, K * bits / 8 %
128, or a group size that is not a multiple of 128, as quanto's auto group
size 96 gives every linear of SmolLM2-360M) is zero-padded onto it, as
`WeightQBitsTpuArray.from_generic` pads (`tests/tensor/
test_padded_kernel_layout.py`). The cases: that file's, SmolLM2-360M's
linears (hidden 960, group size 96) and Qwen2.5-0.5B's K = 896 ones, at
shapes small enough for JAX's kernels in interpret mode.

- `pad_geometry` equal to JAX's over a grid of (N, K, group size, bits).
- `from_generic`: the same geometry as JAX's, the padded codes, scales and
  shifts equal to JAX's padded ones, the true grid (`true_grid`,
  `to_generic`, `dequantize`) equal to the generic weight's bit for bit.
- Padded `qlinear` against JAX's `qlinear` with its Pallas kernels in
  interpret mode (`set_backend(pallas_qbits=True)`): float32 x within
  1e-5 * max|ref| (float32 sums in another order), and W4A8 (int8 codes of
  x padded with zeros) within 1e-5 * max|ref|.
- A padded tiny tied model (hidden 192, group size 96): the port's
  checkpoint of its padded weights (JAX's geometry) is JAX's byte for byte
  (JAX's padded layout saves its generic bytes, as its own test holds), the
  port loads JAX's into the same logits, and JAX loads the port's into the
  same state and logits within 1e-4 * max|ref|.
- The padded requant form (`WeightQBitsRequantArray`) equal to the requant
  plain version on the true grid: the tail groups' zero scales do not move
  `_s8`, and the padded codes multiply zero.
- A padded weight under tensor parallelism (tp = 2): `shard_model` replicates
  it, and the rank's product equals the unsharded one; a row shard after a
  replicated producer takes its columns of the whole x (the partials sum to
  the unsharded product within 1e-5 * max|ref|).
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch import nn

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quanto_tpu.models.llama import LlamaForCausalLM as JaxLlama
from quanto_tpu.models.loading import hf_state_dict as jax_hf_state_dict
from quanto_tpu.models.transformers_models import QuantizedModelForCausalLM as JaxQModel
from quanto_tpu.ops import config as jax_ops_config
from quanto_tpu.ops.pallas.qbits_mm import unpack_split_half
from quanto_tpu.ops.qlinear import qlinear as jax_qlinear
from quanto_tpu.tensor.weights import WeightQBitsTpuArray
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from quanto_tpu_torch.models.loading import hf_state_dict, load_hf_state_dict
from quanto_tpu_torch.models.transformers_models import QuantizedModelForCausalLM
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.ops.collectives import TPGroup
from quanto_tpu_torch.ops.cuda import qbits_mm_sharded as SH
from quanto_tpu_torch.ops.cuda.qbits_mm import pack_k_codes, requant_codes, requant_step, unpack_k_codes
from quanto_tpu_torch.ops.qlinear import qlinear
from quanto_tpu_torch.parallel.sharding import shard_model
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray, WeightQBitsRequantArray

from .test_torch_checkpoint import assert_same_state, jax_logits, numpy_state, port_logits, read, to_hopper
from .test_torch_int2 import weight_pair
from .test_torch_llama import close
from .test_torch_quantize import bits_of

# (N, K, group size, bits): two of JAX's padded-layout cases, SmolLM2-360M's q/o, k/v and down,
# Qwen2.5-0.5B's k/v (K = 896), a per-tensor weight. The geometry test covers the others' shapes.
CASES = [
    (320, 576, 96, 4),
    (256, 2880, 96, 2),
    (960, 960, 96, 4),
    (320, 960, 96, 4),
    (960, 2560, 128, 4),
    (128, 896, 128, 4),
    (100, 700, None, 4),
]
CASE_IDS = [f"{n}x{k}-gs{gs}-int{b}" for n, k, gs, b in CASES]


@pytest.mark.parametrize("bits", [2, 4])
def test_pad_geometry_matches_jax(bits):
    for n in (96, 100, 128, 320, 896, 960, 2560, 2880, 4864):
        for k in (512, 576, 700, 896, 960, 1024, 2560, 2880, 4864):
            for gs in (None, 64, 96, 128, 256):
                want = WeightQBitsTpuArray.pad_geometry((n, k), bits, gs)
                assert WeightQBitsHopperArray.pad_geometry((n, k), bits, gs) == want, (n, k, gs)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_padded_layout_matches_jax(case):
    N, K, gs, bits = case
    w = (np.random.default_rng(0).standard_normal((N, K)) * 0.1).astype(np.float32)
    tpu, hop = weight_pair(w, bits, group_size=gs)
    assert tpu.pad is not None and hop.pad == tpu.pad and hop.orig_shape == (N, K)
    assert hop.kernel_group_size == tpu.kernel_group_size or (gs is None and hop.kernel_group_size == hop.pad[1])
    assert WeightQBitsHopperArray.eligible(hop.kernel_shape, bits, hop.kernel_group_size)
    codes = unpack_split_half(tpu._packed, bits, hop.kernel_shape[1], 1)
    np.testing.assert_array_equal(unpack_k_codes(hop._packed, bits).numpy(), np.asarray(codes))
    np.testing.assert_array_equal(hop._scale_t.numpy(), np.asarray(tpu._scale_t))
    np.testing.assert_array_equal(hop._shift_t.numpy(), np.asarray(tpu._shift_t))
    for got, want in zip(hop.true_grid(), tpu._true_codes()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(hop.dequantize().numpy(), np.asarray(tpu.dequantize()))
    back, ref = hop.to_generic(), tpu.to_generic()
    for a, b in ((back._data.packed_data, ref._data._data), (back._scale, ref._scale), (back._shift, ref._shift)):
        np.testing.assert_array_equal(bits_of(a), bits_of(b))


def jax_kernels(fn):
    jax_ops_config.set_backend(pallas_qbits=True)
    try:
        return np.asarray(fn())
    finally:
        jax_ops_config.set_backend()


# (N, K, group size, bits, M): float x.
FLOAT_CASES = [(320, 576, 96, 4, 4), (320, 576, 96, 4, 600), (320, 960, 96, 4, 4), (128, 896, 128, 4, 4),
               (128, 896, 128, 4, 600), (256, 2880, 96, 2, 4)]


@pytest.mark.parametrize("case", FLOAT_CASES, ids=[f"{n}x{k}-gs{gs}-int{b}-m{m}" for n, k, gs, b, m in FLOAT_CASES])
def test_padded_qlinear_matches_jax_kernels(case):
    N, K, gs, bits, m = case
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((N, K)) * 0.1).astype(np.float32)
    x = (rng.standard_normal((m, K)) * 0.3).astype(np.float32)
    tpu, hop = weight_pair(w, bits, group_size=gs)
    bias = np.linspace(-1, 1, N).astype(np.float32)
    out = qlinear(torch.from_numpy(x), hop, torch.from_numpy(bias))
    ref = jax_kernels(lambda: jax_qlinear(jnp.asarray(x), tpu, jnp.asarray(bias)))
    assert out.shape == (m, N) and out.is_contiguous()
    close(out, ref, 1e-5)


@pytest.mark.parametrize("m", [8, 600])
def test_padded_w4a8_matches_jax_kernels(m):
    N, K, gs = 320, 960, 96
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((N, K)) * 0.1).astype(np.float32)
    x = (rng.standard_normal((m, K)) * 0.3).astype(np.float32)
    tpu, hop = weight_pair(w, 4, group_size=gs)
    xs = np.float32(np.abs(x).max() / 127)
    xt = qtt.quantize_activation(torch.from_numpy(x), qtt.qint8, torch.tensor(xs))
    xj = qt.quantize_activation(jnp.asarray(x), qt.qint8, jnp.float32(xs))
    np.testing.assert_array_equal(xt._data.numpy(), np.asarray(xj._data))
    out = qlinear(xt, hop)
    ref = jax_kernels(lambda: jax_qlinear(xj, tpu))
    close(out, ref, 1e-5)


def test_padded_requant_form_matches_true_grid():
    N, K, gs = 320, 960, 96
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((N, K)) * 0.1).astype(np.float32)
    _, hop = weight_pair(w, 4, group_size=gs)
    rq = WeightQBitsRequantArray.from_hopper(hop)
    codes, scale, shift = hop.true_grid()
    s8 = requant_step(scale.t(), shift.t())
    np.testing.assert_array_equal(rq._s8[:N].numpy(), s8.numpy())
    assert (rq._s8[N:] > 0).all()
    m = 2048  # the requant route's least M
    xq = torch.from_numpy(rng.integers(-127, 128, (m, K)).astype(np.int8))
    sx = torch.tensor(0.0173)
    x = qtt.ActivationQBytesArray(_data=xq, _scale=sx, qtype=qtt.qint8, float_dtype=torch.float32)
    out = qlinear(x, rq)
    c8 = requant_codes(pack_k_codes(codes, 4), scale.t().contiguous(), shift.t().contiguous(), s8, gs)
    ref = ((xq.double() @ c8.double().t()).float() * s8 * sx).to(torch.float32)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    # Below the route's M the exact kernels take it, as the plain Hopper weight.
    assert torch.equal(qlinear(x._data[:8].float() * sx, rq), qlinear(x._data[:8].float() * sx, hop))


def test_padded_weight_is_replicated_under_tp(monkeypatch):
    """q/o off the envelope are replicated on both ranks and give the unsharded
    product; a row-parallel down_proj on the envelope after a replicated
    (padded) up_proj takes the rank's columns of the whole x, and the ranks'
    partials sum to the unsharded product (the all_reduce done by hand)."""
    torch.manual_seed(0)
    block = nn.Sequential()
    block.add_module("q_proj", nn.Linear(960, 320, bias=True))  # column rule, padded
    block.add_module("o_proj", nn.Linear(960, 960, bias=False))  # row rule, padded
    block.add_module("up_proj", nn.Linear(896, 512, bias=False))  # column rule, padded (K = 896)
    block.add_module("down_proj", nn.Linear(512, 896, bias=False))  # row rule, on the envelope
    qtt.quantize(block, weights="qint4")
    qtt.freeze(block)
    to_hopper(block)
    assert block.down_proj.weight.pad is None
    xs = {"q_proj": torch.randn((4, 960)), "o_proj": torch.randn((4, 960)), "up_proj": torch.randn((4, 896)),
          "down_proj": torch.randn((4, 512))}
    want = {n: qlinear(xs[n], m.weight, m.bias) for n, m in block.named_children()}
    monkeypatch.setattr(SH, "all_reduce", lambda t, group: t)  # each rank's partial, summed below
    partials = []
    for rank in (0, 1):
        sharded = copy.deepcopy(block)
        shard_model(sharded, TPGroup(rank, 2, None, torch.device("cpu")))
        for n, m in sharded.named_children():
            if n == "down_proj":
                assert m.weight.shard.mode == "row" and m.weight.shape == (896, 256)
                partials.append(qlinear(xs[n], m.weight, m.bias).float())
                continue
            assert m.weight.shard.mode == "replicated" and m.weight.pad is not None, n
            assert torch.equal(qlinear(xs[n], m.weight, m.bias), want[n]), n
    close(partials[0] + partials[1], want["down_proj"].numpy(), 1e-5)


# A SmolLM2-shaped tiny model: tied, hidden 192 (auto group size 96), one KV head of 64.
SMOL = dict(vocab_size=512, hidden_size=192, intermediate_size=320, num_hidden_layers=1, num_attention_heads=3,
            num_key_value_heads=1, tie_word_embeddings=True, rope_theta=100000.0, rms_norm_eps=1e-5)


@pytest.fixture(autouse=True)
def jax_plain_reader(monkeypatch):
    """JAX reads safetensors through its plain reader (`test_torch_checkpoint.py`)."""
    from quanto_tpu.utils import safetensors_io as jax_io

    monkeypatch.setattr(jax_io, "_try_mmap", lambda path: None)


def test_padded_checkpoint_both_ways(tmp_path):
    jmodel = JaxLlama(JaxLlamaConfig(**SMOL), rngs=nnx.Rngs(0))
    float_state = numpy_state(jax_hf_state_dict(jmodel))
    qt.quantize(jmodel, weights="qint4")
    qt.freeze(jmodel)  # generic: JAX's padded layout saves the same bytes (its own padded-layout test)
    pads = {n: WeightQBitsTpuArray.pad_geometry(m.weight_shape, 4, m.weight_group_size)
            for n, m in qt.named_qmodules(jmodel)}
    assert len(pads) == 7 and all(p is not None for p in pads.values())
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxQModel(jmodel).save_pretrained(jax_dir)
    jax_state = numpy_state(jax_hf_state_dict(jmodel))

    model = LlamaForCausalLM(LlamaConfig(**SMOL), device="cpu")
    assert model.lm_head is None
    assert load_hf_state_dict(model, float_state) == {"missing": [], "unexpected": []}
    QuantizedModelForCausalLM.quantize(model, weights="qint4")
    to_hopper(model)
    assert {n: m.weight.pad for n, m in model.named_modules() if isinstance(m, QLinear)} == pads
    assert_same_state(hf_state_dict(model), jax_state)
    QuantizedModelForCausalLM(model).save_pretrained(port_dir)
    for name in ("model.safetensors", "quanto_qmap.json"):
        assert read(os.path.join(port_dir, name)) == read(os.path.join(jax_dir, name)), name

    logits = port_logits(model)
    loaded = QuantizedModelForCausalLM.from_pretrained(jax_dir, dtype=torch.float32, device="cpu")._wrapped
    to_hopper(loaded)
    assert torch.equal(port_logits(loaded), logits)
    jloaded = JaxQModel.from_pretrained(port_dir, dtype=jnp.float32)._wrapped
    assert_same_state(numpy_state(jax_hf_state_dict(jloaded)), jax_state)
    close(logits, jax_logits(jloaded), 1e-4)
