"""Llama-family causal LM in PyTorch (RMSNorm + rotary + GQA + SwiGLU MLP):
Llama 2/3, Mistral and Qwen2-style configurations.

Counterpart of `quanto_tpu/models/llama.py`, built from `nn.Linear` /
`nn.Embedding` so that `quanto_tpu_torch.quantize()` swaps the projections for
`QLinear`s. Module names follow the Hugging Face llama layout
(`model.layers.N.self_attn.q_proj`, ...), so state dicts and include/exclude
patterns transfer 1:1 with the JAX package.

The model is built on `device` (CUDA unless the caller passes "cpu") with
random weights drawn from an explicit `torch.Generator` (normal, std 0.02,
Llama's `initializer_range` as Hugging Face initializes it); real weights
come in through `models/loading.py`. Under tensor parallelism
(`parallel/sharding.py:shard_model`) each rank runs its own heads and
vocabulary rows: the embedding is a masked lookup of the rank's rows summed
over the ranks, and a vocabulary-sharded lm_head's logits are gathered to
the full vocabulary on every rank, so that every rank samples the same
tokens.

The options of the JAX config (`quanto_tpu/models/llama.py:36-101`) are
ported but Gemma's: tied embeddings (no `lm_head`; the logits come from the
embedding), attention biases (q/k/v/o), Qwen2's q/k/v-only biases, MLP
biases, an explicit `head_dim`, and the `default`, `linear`, `llama3`,
`dynamic` and `yarn` ropes, with the attention factor that yarn multiplies
into cos and sin. `LlamaConfig.from_hf` refuses Gemma (`rms_norm_unit_offset`,
`scale_embeddings`, head_dim 256, which `flash_decode` does not take), an
activation other than silu and a sliding window (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import decode_attention, gqa_attention
from ..ops.collectives import all_reduce
from ..tensor.kv_cache import cache_max_len, init_quantized_kv_cache, kv_read_raw, kv_update
from ..tensor.qarray import QArray


__all__ = ["LlamaConfig", "LlamaForCausalLM", "init_kv_cache", "rope_params"]


_INIT_STD = 0.02


_ROPE_TYPES = ("default", "linear", "llama3", "dynamic", "yarn")  # `rope_params`


def _not_ported(what: str, item: int = 4):
    raise NotImplementedError(f"{what}: not ported yet (ROADMAP.md Queue 1, item {item})")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None  # None: hidden_size // num_attention_heads
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # HF `rope_scaling`: a dict, or its (key, value) pairs; None for default rope.
    rope_scaling: Optional[Any] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # biases on q/k/v/o
    qkv_bias: bool = False  # Qwen2: biases on q/k/v only
    mlp_bias: bool = False
    dtype: torch.dtype = torch.float32

    # What `to_hf` writes as `model_type` and `architectures`.
    hf_model_type = "llama"
    hf_architecture = "LlamaForCausalLM"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            object.__setattr__(self, "num_key_value_heads", self.num_attention_heads)
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden_size // self.num_attention_heads)

    @classmethod
    def from_hf(cls, hf: Mapping[str, Any], dtype=torch.bfloat16) -> "LlamaConfig":
        """From the plain dict of a Hugging Face `config.json` (llama, mistral,
        qwen2), the keys `quanto_tpu/models/llama.py:69-101` reads from a
        `PretrainedConfig`; a qwen2 config has q/k/v biases whatever its
        `attention_bias` says, as Hugging Face's Qwen2 hardcodes them. Raises
        `NotImplementedError` on what the port does not implement: Gemma, an
        activation other than silu, a sliding window, a rope other than
        default, linear, llama3, dynamic and yarn."""
        model_type = hf.get("model_type", "llama")
        if model_type in ("gemma", "gemma2"):
            _not_ported(f"model_type {model_type!r} (rms_norm_unit_offset, scale_embeddings; its head_dim 256 is "
                        "outside flash_decode's {64, 128}, ROADMAP.md Queue 2)")
        act = hf.get("hidden_activation") or hf.get("hidden_act") or "silu"
        if act != "silu":
            _not_ported(f"hidden_act {act!r}")
        if hf.get("use_sliding_window", False):
            _not_ported("use_sliding_window (sliding.py: ring caches, the paged+ring hybrid)", item=8)
        rope = hf.get("rope_scaling") or None
        if rope is not None:
            rope_type = rope.get("rope_type", rope.get("type", "default"))
            if rope_type not in _ROPE_TYPES:
                _not_ported(f"rope_scaling type {rope_type!r}")
            rope = tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in rope.items()))
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads"),
            head_dim=hf.get("head_dim"),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=rope,
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            attention_bias=hf.get("attention_bias", False),
            qkv_bias=model_type == "qwen2" or hf.get("attention_bias", False),
            mlp_bias=hf.get("mlp_bias", False),
            dtype=dtype,
            **cls._hf_extra(hf),
        )

    @classmethod
    def _hf_extra(cls, hf: Mapping[str, Any]) -> dict:
        """A subclass's own fields from a `config.json` dict."""
        return {}

    def to_hf(self) -> dict:
        """This configuration as a `config.json` dict, plain JSON that
        `transformers.AutoConfig` reads (and so the JAX package's
        `from_pretrained`) and that `from_hf` inverts. q/k/v biases without an
        o_proj bias are Qwen2's, so such a config is written as qwen2."""
        rope = {k: list(v) if isinstance(v, tuple) else v for k, v in dict(self.rope_scaling or {}).items()}
        qwen2 = self.qkv_bias and not self.attention_bias
        return {
            "architectures": ["Qwen2ForCausalLM" if qwen2 else self.hf_architecture],
            "model_type": "qwen2" if qwen2 else self.hf_model_type,
            "vocab_size": self.vocab_size,
            "hidden_size": self.hidden_size,
            "intermediate_size": self.intermediate_size,
            "num_hidden_layers": self.num_hidden_layers,
            "num_attention_heads": self.num_attention_heads,
            "num_key_value_heads": self.num_key_value_heads,
            "head_dim": self.head_dim,
            "max_position_embeddings": self.max_position_embeddings,
            "rms_norm_eps": self.rms_norm_eps,
            "rope_theta": self.rope_theta,
            "rope_scaling": rope or None,
            "hidden_act": "silu",
            "attention_bias": self.attention_bias,
            "mlp_bias": self.mlp_bias,
            "tie_word_embeddings": self.tie_word_embeddings,
            "torch_dtype": str(self.dtype).removeprefix("torch."),
        }


def rope_params(
    head_dim: int, theta: float, scaling: Optional[Any] = None, max_position_embeddings: int = 0
) -> Tuple[torch.Tensor, float]:
    """Per-dim rotary inverse frequencies (float32) and the attention scale
    factor, computed in numpy from the config: the `default`, `linear`,
    `llama3`, `dynamic` and `yarn` variants of
    `quanto_tpu/models/llama.py:rope_params` (Hugging Face's
    `ROPE_INIT_FUNCTIONS`). The factor is 1 but for yarn.

    `dynamic`, as in JAX: the frequencies are the defaults within the
    pretraining window, and the NTK formula is evaluated once at a fixed
    length only where the scaling dict names a `seq_len` beyond
    `max_position_embeddings`."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    attn_scale = 1.0
    s = dict(scaling) if scaling else {}
    rope_type = s.get("rope_type", s.get("type", "default"))
    factor = float(s.get("factor", 1.0))
    if rope_type == "default":
        pass
    elif rope_type == "linear":
        inv_freq = inv_freq / factor
    elif rope_type == "dynamic":
        seq_len = int(s.get("seq_len", 0))
        orig = int(max_position_embeddings)
        if seq_len > orig > 0:
            base = theta * ((factor * seq_len / orig) - (factor - 1)) ** (head_dim / (head_dim - 2))
            inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    elif rope_type == "llama3":
        low_freq_factor = float(s["low_freq_factor"])
        high_freq_factor = float(s["high_freq_factor"])
        old_len = float(s["original_max_position_embeddings"])
        low_freq_wavelen = old_len / low_freq_factor
        high_freq_wavelen = old_len / high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        scaled = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
        smooth = (old_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
        smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
        is_medium = (wavelen >= high_freq_wavelen) & (wavelen <= low_freq_wavelen)
        inv_freq = np.where(is_medium, smoothed, scaled)
    elif rope_type == "yarn":
        orig = float(s.get("original_max_position_embeddings") or max_position_embeddings)
        beta_fast = float(s.get("beta_fast") or 32.0)
        beta_slow = float(s.get("beta_slow") or 1.0)

        def mscale(scale, m=1.0):
            return 0.1 * m * math.log(scale) + 1.0 if scale > 1.0 else 1.0

        attn = s.get("attention_factor")
        if attn is None:
            ms, ms_all = s.get("mscale"), s.get("mscale_all_dim")
            attn = mscale(factor, ms) / mscale(factor, ms_all) if ms and ms_all else mscale(factor)
        attn_scale = float(attn)

        def correction_dim(n_rot):
            return head_dim * math.log(orig / (n_rot * 2 * math.pi)) / (2 * math.log(theta))

        low, high = correction_dim(beta_fast), correction_dim(beta_slow)
        if s.get("truncate", True):  # Hugging Face's truthiness: None and 0 also skip the rounding
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, head_dim - 1)
        if low == high:
            high += 0.001
        ramp = np.clip((np.arange(head_dim // 2, dtype=np.float64) - low) / (high - low), 0.0, 1.0)
        extrap = 1.0 - ramp
        inv_freq = (inv_freq / factor) * (1.0 - extrap) + inv_freq * extrap
    else:
        raise ValueError(f"unsupported rope_scaling type: {rope_type!r}")
    return torch.from_numpy(inv_freq.astype(np.float32)), attn_scale


def _rope(positions: torch.Tensor, inv_freq: torch.Tensor, dtype, attn_scale: float = 1.0):
    """cos/sin tables [B, T, D] for the positions, HF 'half-rotation' layout,
    times the attention scale factor in float32, cast to the model dtype."""
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    cos, sin = torch.cos(emb), torch.sin(emb)
    if attn_scale != 1.0:
        cos, sin = cos * attn_scale, sin * attn_scale
    return cos.to(dtype), sin.to(dtype)


def _deq(a):
    """A projection's output as a float tensor: a module whose output
    quantization calibration did not streamline away returns a `QArray`,
    which the model dequantizes where `quanto_tpu/models/llama.py` does."""
    return a.dequantize() if isinstance(a, QArray) else a


def _vocab_parallel_embed(emb: nn.Embedding, ids: torch.Tensor, group) -> torch.Tensor:
    """The embedding of `ids` from a rank's rows [r n, (r+1) n) of the
    vocabulary: rows off this rank are zeros, and the all_reduce sums them
    (in float32; exact, since one rank contributes each row)."""
    n = emb.weight.shape[0]
    local = ids - group.rank * n
    hit = (local >= 0) & (local < n)
    x = F.embedding(local.clamp(0, n - 1), emb.weight).float()
    return all_reduce(torch.where(hit[..., None], x, 0.0), group).to(emb.weight.dtype)


def _gather_vocab(logits: torch.Tensor, group, vocab: int) -> torch.Tensor:
    """A rank's logits over vocabulary [r n, (r+1) n) -> the full vocabulary on
    every rank: a sum into a zeroed float32 [..., vocab] buffer (exact)."""
    n = logits.shape[-1]
    full = logits.new_zeros((*logits.shape[:-1], vocab), dtype=torch.float32)
    full[..., group.rank * n : (group.rank + 1) * n] = logits
    return all_reduce(full, group).to(logits.dtype)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply_rope(x, cos, sin):
    # x: [B, T, H, D]; cos/sin: [B, T, D] -> broadcast over heads.
    return x * cos[:, :, None, :] + _rotate_half(x) * sin[:, :, None, :]


def init_kv_cache(
    config: LlamaConfig, batch: int, max_len: int, dtype=None, kv_quant=None, device="cuda"
):
    """KV cache on `device`: per layer a float (k, v) tuple of zeros
    [B, max_len, Hkv, D] in `dtype` (default the model dtype), or, when
    `kv_quant` is a qtype or KV spec name (`tensor/kv_cache.py:parse_kv_spec`),
    a quantized `QKVCacheLayer`."""
    if kv_quant is not None:
        return init_quantized_kv_cache(
            config.num_hidden_layers, batch, max_len, config.num_key_value_heads,
            config.head_dim, kv_quant, device=device,
        )
    shape = (batch, max_len, config.num_key_value_heads, config.head_dim)
    kw = dict(dtype=dtype or config.dtype, device=device)
    return tuple(
        (torch.zeros(shape, **kw), torch.zeros(shape, **kw))
        for _ in range(config.num_hidden_layers)
    )


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (out * self.weight.float()).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, c: LlamaConfig, **kw):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.head_dim
        q_out, kv_out = self.num_heads * self.head_dim, self.num_kv_heads * self.head_dim
        qkv_bias = c.attention_bias or c.qkv_bias
        self.q_proj = nn.Linear(c.hidden_size, q_out, bias=qkv_bias, **kw)
        self.k_proj = nn.Linear(c.hidden_size, kv_out, bias=qkv_bias, **kw)
        self.v_proj = nn.Linear(c.hidden_size, kv_out, bias=qkv_bias, **kw)
        self.o_proj = nn.Linear(q_out, c.hidden_size, bias=c.attention_bias, **kw)

    def forward(self, x, cos, sin, mask, layer_cache=None, cache_pos=None, decode_pos=None):
        """`decode_pos` int32 [B]: each row's position in a T == 1 step over a
        cache, made once per forward by the model."""
        B, T, _ = x.shape
        scale = self.head_dim**-0.5
        q = _deq(self.q_proj(x)).view(B, T, self.num_heads, self.head_dim)
        k = _deq(self.k_proj(x)).view(B, T, self.num_kv_heads, self.head_dim)
        v = _deq(self.v_proj(x)).view(B, T, self.num_kv_heads, self.head_dim)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        new_cache = None
        k_scale = v_scale = k_shift = v_shift = None
        if layer_cache is not None:
            new_cache = kv_update(layer_cache, k, v, cache_pos)
            if T == 1:
                return _deq(self.o_proj(decode_attention(q, new_cache, decode_pos))), new_cache
            k, v, k_scale, v_scale, k_shift, v_shift = kv_read_raw(new_cache, q.dtype, B)
        q5 = q.view(B, T, self.num_kv_heads, self.num_heads // self.num_kv_heads, self.head_dim)
        out = gqa_attention(
            q5, k, v, mask, scale,
            k_scale=k_scale, v_scale=v_scale, k_shift=k_shift, v_shift=v_shift,
        )
        return _deq(self.o_proj(out)), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, c: LlamaConfig, **kw):
        super().__init__()
        self.gate_proj = nn.Linear(c.hidden_size, c.intermediate_size, bias=c.mlp_bias, **kw)
        self.up_proj = nn.Linear(c.hidden_size, c.intermediate_size, bias=c.mlp_bias, **kw)
        self.down_proj = nn.Linear(c.intermediate_size, c.hidden_size, bias=c.mlp_bias, **kw)

    def forward(self, x):
        g, u = _deq(self.gate_proj(x)), _deq(self.up_proj(x))
        return _deq(self.down_proj(F.silu(g) * u))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, c: LlamaConfig, **kw):
        super().__init__()
        self.self_attn = LlamaAttention(c, **kw)
        self.mlp = LlamaMLP(c, **kw)
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, **kw)

    def forward(self, x, cos, sin, mask, layer_cache=None, cache_pos=None, decode_pos=None):
        h, new_cache = self.self_attn(
            self.input_layernorm(x), cos, sin, mask, layer_cache, cache_pos, decode_pos
        )
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_cache


class LlamaModel(nn.Module):
    def __init__(self, c: LlamaConfig, layer_cls=LlamaDecoderLayer, **kw):
        super().__init__()
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size, **kw)
        self.layers = nn.ModuleList([layer_cls(c, **kw) for _ in range(c.num_hidden_layers)])
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, **kw)


@torch.no_grad()
def _init_weights(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, _INIT_STD, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)


class LlamaForCausalLM(nn.Module):
    """Causal LM head over LlamaModel, HF-compatible module names. A model
    family with another decoder layer subclasses it and sets `layer_cls`."""

    layer_cls = LlamaDecoderLayer
    # The tensor-parallel group (`ops/collectives.py:TPGroup`) once
    # `parallel/sharding.py:shard_model` has sharded the model; None on one device.
    tp = None

    def __init__(
        self,
        config: LlamaConfig,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        """On `device="meta"` the model holds no memory until `materialize_`."""
        super().__init__()
        self.config = config
        kw = dict(device="meta", dtype=config.dtype)
        self.model = LlamaModel(config, self.layer_cls, **kw)
        # Tied embeddings: no lm_head, the logits come from the embedding (`llama.py:454-460`).
        self.lm_head = (
            None if config.tie_word_embeddings
            else nn.Linear(config.hidden_size, config.vocab_size, bias=False, **kw)
        )
        self.register_buffer("inv_freq", torch.empty(config.head_dim // 2, device="meta"), persistent=False)
        self.attn_scale = 1.0
        self.requires_grad_(False)
        if torch.device(device).type != "meta":
            self.materialize_(device, generator or torch.Generator(device=device).manual_seed(0))

    @torch.no_grad()
    def materialize_(self, device, generator: torch.Generator, layer_fn=None) -> None:
        """Allocate a model built on "meta" on `device` and draw its weights
        from `generator`, one part at a time (the embedding, each decoder
        layer, the norm, the lm_head) in the order of `modules()`.
        `layer_fn(layer)` runs on each decoder layer as soon as its weights
        are drawn (say `quantize`, `freeze` and `convert_moe_to_stacked` on
        it), so the device holds one float layer beyond what `layer_fn`
        leaves: the way a model larger than the device in float is built."""
        parts = [self.model.embed_tokens, *self.model.layers, self.model.norm, self.lm_head]
        for part in filter(None, parts):
            part.to_empty(device=device)
            _init_weights(part, generator)
            if layer_fn is not None and isinstance(part, self.layer_cls):
                layer_fn(part)
        self.init_rope_(device)

    def init_rope_(self, device) -> None:
        """The rotary inverse frequencies on `device` (a buffer no checkpoint
        holds) and the attention scale factor."""
        c = self.config
        inv_freq, self.attn_scale = rope_params(c.head_dim, c.rope_theta, c.rope_scaling, c.max_position_embeddings)
        self.inv_freq = inv_freq.to(device)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def forward(
        self,
        input_ids: torch.Tensor,
        cache=None,
        cache_pos=0,
        logits_indices=None,
    ):
        """Forward pass; returns (logits, cache or None).

        Without a cache: causal self-attention over `input_ids` [B, T]. With a
        cache (float or quantized): the tokens are written at `cache_pos` (a
        scalar, or a [B] tensor of per-row positions) and attend to every
        cache slot up to their position; a T == 1 step goes through the
        decode-attention kernel (`ops/attention.py:decode_attention`).
        `logits_indices` (scalar or [B]) computes logits only at those per-row
        positions ([B, 1, V]): the hidden states are sliced before the lm_head.
        """
        B, T = input_ids.shape
        dev = input_ids.device
        V = self.config.vocab_size
        embed = self.model.embed_tokens
        if embed.weight.shape[0] == V:
            x = embed(input_ids.long())
        else:
            x = _vocab_parallel_embed(embed, input_ids.long(), self.tp)
        pos0 = torch.as_tensor(cache_pos, device=dev).reshape(-1, 1)
        positions = (pos0 + torch.arange(T, device=dev)[None, :]).expand(B, T)
        cos, sin = _rope(positions, self.inv_freq, x.dtype, self.attn_scale)
        neg = torch.finfo(torch.float32).min
        mask = decode_pos = None
        if cache is None:
            causal = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
            mask = torch.where(causal, 0.0, neg)[None, None]
        elif T == 1:
            decode_pos = positions[:, 0].to(torch.int32).contiguous()
        else:
            k_pos = torch.arange(cache_max_len(cache[0]), device=dev)[None, None, None, :]
            mask = torch.where(k_pos <= positions[:, None, :, None], 0.0, neg)

        new_cache = [] if cache is not None else None
        for i, layer in enumerate(self.model.layers):
            layer_cache = cache[i] if cache is not None else None
            x, lc = layer(x, cos, sin, mask, layer_cache, cache_pos, decode_pos)
            if cache is not None:
                new_cache.append(lc)

        x = self.model.norm(x)
        if logits_indices is not None:
            idx = torch.as_tensor(logits_indices, device=dev).reshape(-1).expand(B)
            x = x[torch.arange(B, device=dev), idx][:, None, :]
        logits = self._logits(x)
        if logits.shape[-1] != V:
            logits = _gather_vocab(logits, self.tp, V)
        return logits, (tuple(new_cache) if new_cache is not None else None)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The logits of the final hidden states: from the embedding when tied
        (`llama.py:454-460`), else from the lm_head. A float head or
        embedding meets a hidden state of another dtype (float32 after a W8A8
        linear) in that dtype, as JAX's dtype promotion has it."""
        head = self.lm_head
        if head is None:
            return torch.matmul(x, self.model.embed_tokens.weight.to(x.dtype).t())
        if isinstance(head, nn.Linear) and head.weight.dtype != x.dtype:
            return F.linear(x, head.weight.to(x.dtype))
        return _deq(head(x))
