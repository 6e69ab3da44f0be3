"""quanto-compatible checkpoints of quanto_tpu_torch against quanto_tpu.

Each case builds a tiny JAX model (float32, seeded), quantizes it (W4A8:
calibrated with `calibrate_jit`) and freezes it; the port's model takes the
same float weights (and, for W4A8, JAX's activation scales) and quantizes
and freezes itself. Cases: a tiny Llama (hidden 256, 2 layers) in qint4,
qint8 and qfloat8_e4m3fn (the lm_head left float), calibrated
W4A8; Llama in qint2 at the int2 widths of `test_torch_int2.py` (hidden 512,
intermediate 1024: at hidden 256 an int2 weight is off the Hopper envelope);
a tiny Mixtral in qint4, and one with qint2 experts at those int2 widths.
For each case:
- the port's `hf_state_dict` is JAX's, key for key in order, bit for bit,
  also from the Hopper layout (taken on the CPU by `from_generic`), and the
  quantization maps are equal;
- `save_pretrained` writes the JAX package's `model.safetensors` and
  `quanto_qmap.json` byte for byte;
- JAX's checkpoint loads in the port (`from_pretrained(device="cpu")`) and
  the port's in JAX: the same tensors, and logits within 1e-4 * max|ref| of
  the other package's loaded model (`test_torch_llama.close`; W4A8 within
  1e-3, the seed without a moved activation code of `test_torch_w4a8.py`);
- the port's checkpoint loads back into the port with logits EQUAL to the
  model it was saved from.
A loaded model quantizes every output of a module with quantized activations
(Calibration's streamline flags are not part of quanto's format, in either
package), so loaded models are compared with loaded models, and the port's
saved model keeps its flags on.

Beside the cases: `requantize` onto a float and a "meta" skeleton, strict
loading (`KeyError`, and the missing / unexpected report), a sharded
checkpoint, the e4m3fn NaN codes 0x7F / 0xFF in a loaded lm_head (NaN in
those logits in both packages, as JAX's `qlinear` converts the codes), the
requant form's `_s8` after a reload, a stacked Mixtral refusing to save,
`config.json` both ways through `transformers.AutoConfig` and the keys the
port refuses, and the local hub resolver against JAX's.
"""

import copy
import dataclasses
import functools
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import quanto_tpu as qt
import quanto_tpu_torch as qtt
from quanto_tpu.models import hub as jax_hub
from quanto_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quanto_tpu.models.llama import LlamaForCausalLM as JaxLlama
from quanto_tpu.models.loading import hf_state_dict as jax_hf_state_dict
from quanto_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from quanto_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from quanto_tpu.models.transformers_models import QuantizedModelForCausalLM as JaxQModel
from quanto_tpu.utils import safetensors_io as jax_io
from quanto_tpu_torch import serialization
from quanto_tpu_torch.models import hub
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from quanto_tpu_torch.models.loading import hf_state_dict, load_hf_state_dict
from quanto_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
from quanto_tpu_torch.models.transformers_models import QMAP_NAME, QuantizedModelForCausalLM, build_model
from quanto_tpu_torch.nn import QLinear
from quanto_tpu_torch.tensor.weights import WeightQBitsArray, WeightQBitsHopperArray, WeightQBitsRequantArray
from quanto_tpu_torch.utils import safetensors_io

from .test_torch_int2 import LLAMA as LLAMA_INT2
from .test_torch_int2 import MIXTRAL as MIXTRAL_INT2
from .test_torch_llama import TINY as LLAMA, close
from .test_torch_mixtral import TINY as MIXTRAL
from .test_torch_quantize import bits_of

W4A8 = dict(weights="qint4", activations="qint8", exclude="lm_head")
# name -> (family, config, quantize() calls, calibrated)
CASES = {
    "qint4": ("llama", LLAMA, [dict(weights="qint4")], False),
    "qint2": ("llama", LLAMA_INT2, [dict(weights="qint2")], False),
    "qint8": ("llama", LLAMA, [dict(weights="qint8", exclude="lm_head")], False),
    "qfloat8_e4m3fn": ("llama", LLAMA, [dict(weights="qfloat8_e4m3fn", exclude="lm_head")], False),
    "w4a8": ("llama", LLAMA, [W4A8], True),
    "mixtral_qint4": ("mixtral", MIXTRAL, [dict(weights="qint4")], False),
    "mixtral_qint2_experts": (
        "mixtral", MIXTRAL_INT2, [dict(weights="qint2", include="*experts*"), dict(weights="qint4")], False,
    ),
}
FAMILIES = {
    "llama": (JaxLlama, JaxLlamaConfig, LlamaForCausalLM, LlamaConfig),
    "mixtral": (JaxMixtral, JaxMixtralConfig, MixtralForCausalLM, MixtralConfig),
}
B, T = 2, 16
# The prompts of `test_torch_w4a8.py`: no activation code moves between the packages.
IDS = np.random.default_rng(1).integers(0, 512, (B, T))


def tol(case: str) -> float:
    return 1e-3 if CASES[case][3] else 1e-4


@nnx.jit
def _jax_logits(model, ids):
    return model(ids)[0]


def jax_logits(model) -> np.ndarray:
    return np.asarray(_jax_logits(model, jnp.asarray(IDS, jnp.int32)))


def port_logits(model) -> torch.Tensor:
    with torch.no_grad():
        return model(torch.from_numpy(IDS))[0]


def numpy_state(state) -> dict:
    return {k: np.asarray(v) for k, v in state.items()}


def bits(a) -> np.ndarray:
    """The bit pattern of a tensor or array (bfloat16 as uint16, float8 as uint8)."""
    if isinstance(a, torch.Tensor) and a.dtype.itemsize == 1 and a.is_floating_point():
        return a.view(torch.uint8).numpy()
    if not isinstance(a, torch.Tensor) and "float8" in np.asarray(a).dtype.name:
        return np.asarray(a).view(np.uint8)
    return bits_of(a)


def assert_same_state(port: dict, ref: dict) -> None:
    """Key for key in order, dtype, shape and bits."""
    assert list(port) == list(ref)
    for k, v in ref.items():
        p, r = bits(port[k]), bits(v)
        assert p.dtype == r.dtype and p.shape == r.shape, k
        np.testing.assert_array_equal(p, r, err_msg=k)


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def to_hopper(model) -> None:
    """The Hopper layout on the CPU, as a CUDA freeze takes it (where it fits)."""
    for m in model.modules():
        if isinstance(m, QLinear) and isinstance(m.weight, WeightQBitsArray):
            m.weight = WeightQBitsHopperArray.from_generic(m.weight) or m.weight


@pytest.fixture(autouse=True)
def jax_plain_reader(monkeypatch):
    """JAX reads safetensors here through its plain reader. Its native mmap
    reader (`quanto_tpu/utils/safetensors_io.py:_try_mmap`) unmaps the file
    right after `jnp.array(view, copy=True)`, whose host-to-device transfer
    may still be reading the view: under load that crashed a test worker
    (a segmentation fault in JAX's `from_pretrained`). Both readers give the
    same bytes."""
    monkeypatch.setattr(jax_io, "_try_mmap", lambda path: None)

class Case:
    """One case's JAX model and checkpoint, and the port's model and checkpoint."""

    def __init__(self, name: str, root):
        family, config, steps, calibrated = CASES[name]
        jax_cls, jax_config_cls, port_cls, port_config_cls = FAMILIES[family]
        self.name = name
        jmodel = jax_cls(jax_config_cls(**config), rngs=nnx.Rngs(0))
        float_state = numpy_state(jax_hf_state_dict(jmodel))
        for kw in steps:
            qt.quantize(jmodel, **kw)
        scales = {}
        if calibrated:
            cal = [jnp.asarray(np.random.default_rng(20 + i).integers(0, 512, (B, 16)), jnp.int32) for i in range(2)]
            qt.calibrate_jit(jmodel, cal)
            scales = {k: v for k, v in numpy_state(jax_hf_state_dict(jmodel)).items() if k.endswith("_scale")}
        qt.freeze(jmodel)
        self.jax_model = jmodel
        self.jax_state = numpy_state(jax_hf_state_dict(jmodel))
        self.jax_qmap = qt.quantization_map(jmodel)
        self.jax_dir = str(root / f"{name}-jax")
        JaxQModel(jmodel).save_pretrained(self.jax_dir)

        model = port_cls(port_config_cls(**config), device="cpu")
        assert load_hf_state_dict(model, float_state) == {"missing": [], "unexpected": []}
        if calibrated:  # JAX's activation scales, then freeze
            qtt.quantize(model, **steps[0])
            assert load_hf_state_dict(model, scales)["unexpected"] == []
            qtt.freeze(model)
        for kw in () if calibrated else steps:
            QuantizedModelForCausalLM.quantize(model, **kw)  # quantize + freeze
        self.port_model = model
        self.port_dir = str(root / f"{name}-port")
        QuantizedModelForCausalLM(model).save_pretrained(self.port_dir)

    @functools.cached_property
    def port_from_jax(self):
        return QuantizedModelForCausalLM.from_pretrained(self.jax_dir, dtype=torch.float32, device="cpu")

    @functools.cached_property
    def port_from_port(self):
        return QuantizedModelForCausalLM.from_pretrained(self.port_dir, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkpoints")
    built = {}

    def get(name: str) -> Case:
        if name not in built:
            built[name] = Case(name, root)
        return built[name]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_hf_state_dict_and_qmap_match_jax(cases, case):
    c = cases(case)
    assert_same_state(hf_state_dict(c.port_model), c.jax_state)
    assert list(qtt.quantization_map(c.port_model).items()) == list(c.jax_qmap.items())
    hopper = copy.deepcopy(c.port_model)
    to_hopper(hopper)
    if not case.startswith("qint8") and not case.startswith("qfloat8"):
        assert any(isinstance(m.weight, WeightQBitsHopperArray) for m in hopper.modules() if isinstance(m, QLinear))
    assert_same_state(hf_state_dict(hopper), c.jax_state)


@pytest.mark.parametrize("case", list(CASES))
def test_save_pretrained_writes_jax_bytes(cases, case):
    c = cases(case)
    for name in ("model.safetensors", QMAP_NAME):
        assert read(os.path.join(c.port_dir, name)) == read(os.path.join(c.jax_dir, name)), name
    assert sorted(os.listdir(c.port_dir)) == sorted(os.listdir(c.jax_dir))


@pytest.mark.parametrize("case", list(CASES))
def test_jax_checkpoint_loads_in_the_port(cases, case):
    c = cases(case)
    loaded = c.port_from_jax
    assert_same_state(hf_state_dict(loaded._wrapped), c.jax_state)
    ref = jax_logits(JaxQModel.from_pretrained(c.jax_dir, dtype=jnp.float32)._wrapped)
    close(port_logits(loaded), ref, tol(case))


@pytest.mark.parametrize("case", list(CASES))
def test_port_checkpoint_loads_in_jax(cases, case):
    c = cases(case)
    jloaded = JaxQModel.from_pretrained(c.port_dir, dtype=jnp.float32)._wrapped
    assert_same_state(numpy_state(jax_hf_state_dict(jloaded)), c.jax_state)
    assert type(jloaded).__name__ == type(c.jax_model).__name__
    close(port_logits(c.port_from_port), jax_logits(jloaded), tol(case))


@pytest.mark.parametrize("case", list(CASES))
def test_port_round_trip_is_exact(cases, case):
    c = cases(case)
    loaded = c.port_from_port._wrapped
    assert type(loaded) is type(c.port_model) and loaded.config == c.port_model.config
    assert list(qtt.quantization_map(loaded).items()) == list(qtt.quantization_map(c.port_model).items())
    assert_same_state(hf_state_dict(loaded), hf_state_dict(c.port_model))
    assert torch.equal(port_logits(loaded), port_logits(c.port_model))


@pytest.mark.parametrize("case", ["qint4", "w4a8", "mixtral_qint2_experts"])
@pytest.mark.parametrize("skeleton", ["float", "meta"])
def test_requantize(cases, case, skeleton):
    c = cases(case)
    family, config, _, _ = CASES[case]
    port_cls, config_cls = FAMILIES[family][2:]
    model = port_cls(config_cls(**config), device="cpu" if skeleton == "float" else "meta")
    qmap = json.loads(read(os.path.join(c.jax_dir, QMAP_NAME)))
    report = qtt.requantize(model, safetensors_io.load_file(os.path.join(c.jax_dir, "model.safetensors")), qmap, device="cpu")
    assert report == {"missing": [], "unexpected": []}
    if skeleton == "meta":
        model.init_rope_("cpu")
    assert torch.equal(port_logits(model), port_logits(c.port_from_jax))


def test_load_state_dict_strict(cases, tmp_path):
    c = cases("qint4")
    sd = serialization.state_dict(c.port_model)
    target = QuantizedModelForCausalLM.from_pretrained(c.port_dir, dtype=torch.float32, device="cpu")._wrapped
    partial = dict(sd, **{"extra.weight": torch.zeros(3)})
    with pytest.raises(KeyError, match="state dict mismatch"):
        serialization.load_state_dict(target, partial)
    report = serialization.load_state_dict(target, partial, strict=False)
    assert report == {"missing": [], "unexpected": ["extra.weight"]}
    del partial["extra.weight"], partial["model.norm.weight"]
    assert serialization.load_state_dict(target, partial, strict=False) == {
        "missing": ["model.norm.weight"], "unexpected": []
    }
    path = str(tmp_path / "state.safetensors")
    serialization.save_file(c.port_model, path)
    assert serialization.load_file(target, path) == {"missing": [], "unexpected": []}
    assert torch.equal(port_logits(target), port_logits(c.port_model))


def test_sharded_checkpoint_round_trip(cases, tmp_path):
    c = cases("qint4")
    QuantizedModelForCausalLM(c.port_model).save_pretrained(str(tmp_path), max_shard_size="64KB")
    with open(tmp_path / "model.safetensors.index.json") as f:
        index = json.load(f)
    shards = sorted(set(index["weight_map"].values()))
    assert len(shards) > 2 and not (tmp_path / "model.safetensors").exists()
    assert list(index["weight_map"]) == list(c.jax_state)
    loaded = QuantizedModelForCausalLM.from_pretrained(str(tmp_path), dtype=torch.float32, device="cpu")
    assert torch.equal(port_logits(loaded), port_logits(c.port_model))
    jloaded = JaxQModel.from_pretrained(str(tmp_path), dtype=jnp.float32)._wrapped
    assert_same_state(numpy_state(jax_hf_state_dict(jloaded)), c.jax_state)


def test_from_pretrained_float_matches_jax(tmp_path):
    """A float checkpoint (torch names, `config.json`) in both packages'
    `from_pretrained_float`: the port's logits equal the model it was written
    from, and JAX's agree within 1e-4 * max|ref|."""
    from quanto_tpu.models.transformers_models import from_pretrained_float as jax_from_pretrained_float
    from quanto_tpu_torch.models.transformers_models import from_pretrained_float

    model = MixtralForCausalLM(MixtralConfig(**MIXTRAL), device="cpu", generator=torch.Generator().manual_seed(5))
    safetensors_io.save_file(hf_state_dict(model), str(tmp_path / "model.safetensors"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(model.config.to_hf(), f)
    loaded = from_pretrained_float(str(tmp_path), dtype=torch.float32, device="cpu")
    assert loaded.hf_config["model_type"] == "mixtral"
    assert torch.equal(port_logits(loaded), port_logits(model))
    close(port_logits(loaded), jax_logits(jax_from_pretrained_float(str(tmp_path), dtype=jnp.float32)))


def test_e4m3fn_nan_codes_load_as_nan_in_both(tmp_path):
    """An lm_head in qfloat8_e4m3fn whose codes hold 0x7F and 0xFF (the
    quantizer never writes them; a checkpoint can). Both packages keep JAX's
    `qlinear` decode (`quanto_tpu/ops/qbytes_mm.py:116-118`): those codes
    convert to NaN, so the logits of their vocabulary rows are NaN in both,
    and the rest agree."""
    jmodel = JaxLlama(JaxLlamaConfig(**LLAMA), rngs=nnx.Rngs(3))
    qt.quantize(jmodel, weights="qfloat8_e4m3fn")
    qt.freeze(jmodel)
    JaxQModel(jmodel).save_pretrained(str(tmp_path))
    path = str(tmp_path / "model.safetensors")
    tensors = safetensors_io.load_file(path)
    codes = tensors["lm_head.weight._data"].view(torch.uint8)
    codes[5, 7], codes[200, 30] = 0x7F, 0xFF
    safetensors_io.save_file(tensors, path)
    out = port_logits(QuantizedModelForCausalLM.from_pretrained(str(tmp_path), dtype=torch.float32, device="cpu"))
    ref = jax_logits(JaxQModel.from_pretrained(str(tmp_path), dtype=jnp.float32)._wrapped)
    nan_cols = np.zeros(LLAMA["vocab_size"], bool)
    nan_cols[[5, 200]] = True
    np.testing.assert_array_equal(np.isnan(ref), np.broadcast_to(nan_cols, ref.shape))
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(ref))
    close(out[..., ~nan_cols], ref[..., ~nan_cols])


def test_requant_form_after_reload(cases):
    """`freeze(loaded, w4a8_requant_dot=True)` on a reloaded model gives the
    original requant form's tensors and `_s8`, bit for bit (`_s8` is not stored)."""
    c = cases("w4a8")

    def requant_form(model) -> dict:
        to_hopper(model)
        qtt.freeze(model, w4a8_requant_dot=True)
        return {n: m.weight for n, m in model.named_modules() if isinstance(m, QLinear)}

    original = requant_form(copy.deepcopy(c.port_model))
    reloaded = requant_form(QuantizedModelForCausalLM.from_pretrained(c.port_dir, dtype=torch.float32, device="cpu"))
    assert len(original) == 14 and all(isinstance(w, WeightQBitsRequantArray) for w in original.values())
    for n, w in reloaded.items():
        for f in ("_packed", "_scale_t", "_shift_t", "_s8"):
            assert torch.equal(getattr(w, f), getattr(original[n], f)), (n, f)


def test_stacked_mixtral_refuses_to_save(cases, tmp_path):
    c = cases("mixtral_qint4")
    model = QuantizedModelForCausalLM.from_pretrained(c.port_dir, dtype=torch.float32, device="cpu")._wrapped
    to_hopper(model)
    assert qtt.convert_moe_to_stacked(model) == 1
    with pytest.raises(ValueError, match="convert_moe_to_stacked"):
        QuantizedModelForCausalLM(model).save_pretrained(str(tmp_path))
    with pytest.raises(ValueError, match="convert_moe_to_stacked"):
        load_hf_state_dict(model, {})


LLAMA31_8B = dict(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, max_position_embeddings=131072, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
)


# mistralai/Mixtral-8x7B-v0.1 config.json (no rope_scaling: JAX's synthesized
# Mixtral config.json has no such key, as transformers' MixtralConfig has none).
MIXTRAL_8X7B = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=1e6,
    num_local_experts=8, num_experts_per_tok=2,
)


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_config_json_both_ways(tmp_path, family):
    """The port's `config.json` through `transformers.AutoConfig` into JAX's
    `from_hf` gives JAX's config of the same fields; JAX's `config.json` (the
    one `save_pretrained` synthesizes) gives the port's back."""
    import transformers

    jax_cls, jax_config_cls, _, port_config_cls = FAMILIES[family]
    fields = LLAMA31_8B if family == "llama" else MIXTRAL_8X7B
    port = port_config_cls(**fields, dtype=torch.bfloat16)
    # `from_hf` keeps rope_scaling as sorted (key, value) pairs, as JAX does.
    rope = tuple(sorted(port.rope_scaling.items())) if port.rope_scaling else None
    assert port_config_cls.from_hf(port.to_hf()) == dataclasses.replace(port, rope_scaling=rope)

    with open(tmp_path / "config.json", "w") as f:
        json.dump(port.to_hf(), f)
    hf = transformers.AutoConfig.from_pretrained(str(tmp_path))
    assert hf.model_type == family and hf.architectures == [port.hf_architecture]
    jax = jax_config_cls.from_hf(hf, dtype=jnp.bfloat16)
    for name in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                 "num_key_value_heads", "head_dim", "max_position_embeddings", "rms_norm_eps", "rope_theta",
                 *(("num_local_experts", "num_experts_per_tok") if family == "mixtral" else ())):
        assert getattr(jax, name) == getattr(port, name), name
    assert jax.rope_scaling == rope
    assert not jax.tie_word_embeddings and not jax.attention_bias and not jax.mlp_bias and jax.hidden_act == "silu"

    small = dict(fields, num_hidden_layers=1, vocab_size=64, hidden_size=64, intermediate_size=64,
                 num_attention_heads=4, num_key_value_heads=2)
    JaxQModel(jax_cls(jax_config_cls(**small), rngs=nnx.Rngs(0))).save_pretrained(str(tmp_path / "jax"))
    with open(tmp_path / "jax" / "config.json") as f:
        back = port_config_cls.from_hf(json.load(f), dtype=torch.float32)
    assert back == port_config_cls(**dict(small, rope_scaling=rope), dtype=torch.float32)


@pytest.mark.parametrize(
    "extra",
    [
        {"model_type": "gemma"},
        {"model_type": "gemma2"},
        {"use_sliding_window": True},
        {"hidden_act": "gelu"},
        {"hidden_activation": "gelu_pytorch_tanh"},
        {"rope_scaling": {"rope_type": "longrope", "factor": 4.0}},
    ],
    ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items() if k != "rope_scaling") or "rope_scaling",
)
def test_config_refuses_what_the_port_lacks(extra):
    hf = dict(LlamaConfig(**LLAMA31_8B).to_hf(), **extra)
    with pytest.raises(NotImplementedError, match=r"Queue 1, item [48]\)"):
        LlamaConfig.from_hf(hf)


def test_unported_model_type_raises():
    hf = dict(LlamaConfig(**LLAMA).to_hf(), model_type="phi3")
    with pytest.raises(NotImplementedError, match="Queue 1, item 8"):
        build_model(hf)
    model = build_model(dict(LlamaConfig(**LLAMA).to_hf(), model_type="mistral"), dtype=torch.float32)
    assert type(model) is LlamaForCausalLM and model.lm_head.weight.is_meta
    # qwen2 is ported: a Llama with q/k/v biases.
    model = build_model(dict(LlamaConfig(**LLAMA).to_hf(), model_type="qwen2"), dtype=torch.float32)
    attn = model.model.layers[0].self_attn
    assert attn.q_proj.bias is not None and attn.v_proj.bias is not None and attn.o_proj.bias is None


def test_resolve_model_path_matches_jax(tmp_path, monkeypatch):
    """A local directory, and hub ids in a Hugging Face cache layout: refs/main,
    a ref and a commit prefix as revisions, an incomplete snapshot skipped,
    and an id in no cache raising (no download is tried)."""
    for var in ("QUANTO_TPU_HF_CACHE", "HF_HUB_CACHE", "HF_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("QUANTO_TPU_OFFLINE", "1")
    cache = tmp_path / "cache"
    repo = cache / "models--org--tiny"
    for commit, complete in (("abc123", True), ("def456", True), ("fff000", False)):
        snap = repo / "snapshots" / commit
        snap.mkdir(parents=True)
        (snap / "config.json").write_text("{}")
        if complete:
            (snap / "model.safetensors").write_bytes(b"")
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("abc123")
    (repo / "refs" / "v1").write_text("def456")
    local = tmp_path / "local"
    local.mkdir()
    asks = [(str(local), None), ("org/tiny", None), ("org/tiny", "v1"), ("org/tiny", "def4")]
    for name, rev in asks:
        want = jax_hub.resolve_model_path(name, revision=rev, cache_dir=str(cache))
        assert hub.resolve_model_path(name, revision=rev, cache_dir=str(cache)) == want
    assert hub.resolve_model_path("org/tiny", cache_dir=str(cache)).endswith("abc123")
    assert hub.is_hub_id("org/tiny") and not hub.is_hub_id(str(local)) and not hub.is_hub_id("a/b/c")
    for name in ("org/other", "not a path"):
        with pytest.raises(FileNotFoundError):
            jax_hub.resolve_model_path(name, cache_dir=str(cache))
        with pytest.raises(FileNotFoundError):
            hub.resolve_model_path(name, cache_dir=str(cache))
    shutil.rmtree(repo / "snapshots" / "abc123")
    assert hub.resolve_model_path("org/tiny", cache_dir=str(cache)) == jax_hub.resolve_model_path(
        "org/tiny", cache_dir=str(cache)
    )
