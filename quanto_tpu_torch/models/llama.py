"""Llama-family causal LM in PyTorch (RMSNorm + rotary + GQA + SwiGLU MLP).

Counterpart of `quanto_tpu/models/llama.py`, built from `nn.Linear` /
`nn.Embedding` so that `quanto_tpu_torch.quantize()` swaps the projections for
`QLinear`s. Module names follow the Hugging Face llama layout
(`model.layers.N.self_attn.q_proj`, ...), so state dicts and include/exclude
patterns transfer 1:1 with the JAX package.

The model is built on `device` (CUDA unless the caller passes "cpu") with
random weights drawn from an explicit `torch.Generator` (normal, std 0.02,
Llama's `initializer_range` as Hugging Face initializes it); real weights
come in through `models/loading.py`. Bias, tied-embedding, yarn/dynamic rope
and Gemma options of the JAX config wait for the models that need them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import decode_attention, gqa_attention
from ..tensor.kv_cache import cache_max_len, init_quantized_kv_cache, kv_read_raw, kv_update
from ..tensor.qarray import QArray


__all__ = ["LlamaConfig", "LlamaForCausalLM", "init_kv_cache", "rope_params"]


_INIT_STD = 0.02


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # HF `rope_scaling`: a dict, or its (key, value) pairs; None for default rope.
    rope_scaling: Optional[Any] = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.num_key_value_heads is None:
            object.__setattr__(self, "num_key_value_heads", self.num_attention_heads)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def rope_params(head_dim: int, theta: float, scaling: Optional[Any] = None) -> torch.Tensor:
    """Per-dim rotary inverse frequencies (float32), computed in numpy from the
    config: the `default`, `linear` and `llama3` variants of
    `quanto_tpu/models/llama.py:rope_params` (whose attention scale factor is
    1 for all three)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    s = dict(scaling) if scaling else {}
    rope_type = s.get("rope_type", s.get("type", "default"))
    factor = float(s.get("factor", 1.0))
    if rope_type == "default":
        pass
    elif rope_type == "linear":
        inv_freq = inv_freq / factor
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
    else:
        raise ValueError(f"unsupported rope_scaling type: {rope_type!r}")
    return torch.from_numpy(inv_freq.astype(np.float32))


def _rope(positions: torch.Tensor, inv_freq: torch.Tensor, dtype):
    """cos/sin tables [B, T, D] for the positions, HF 'half-rotation' layout,
    cast to the model dtype."""
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _deq(a):
    """A projection's output as a float tensor: a module whose output
    quantization calibration did not streamline away returns a `QArray`,
    which the model dequantizes where `quanto_tpu/models/llama.py` does."""
    return a.dequantize() if isinstance(a, QArray) else a


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
        self.q_proj = nn.Linear(c.hidden_size, q_out, bias=False, **kw)
        self.k_proj = nn.Linear(c.hidden_size, kv_out, bias=False, **kw)
        self.v_proj = nn.Linear(c.hidden_size, kv_out, bias=False, **kw)
        self.o_proj = nn.Linear(q_out, c.hidden_size, bias=False, **kw)

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
            k, v, k_scale, v_scale, k_shift, v_shift = kv_read_raw(new_cache, q.dtype)
        q5 = q.view(B, T, self.num_kv_heads, self.num_heads // self.num_kv_heads, self.head_dim)
        out = gqa_attention(
            q5, k, v, mask, scale,
            k_scale=k_scale, v_scale=v_scale, k_shift=k_shift, v_shift=v_shift,
        )
        return _deq(self.o_proj(out)), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, c: LlamaConfig, **kw):
        super().__init__()
        self.gate_proj = nn.Linear(c.hidden_size, c.intermediate_size, bias=False, **kw)
        self.up_proj = nn.Linear(c.hidden_size, c.intermediate_size, bias=False, **kw)
        self.down_proj = nn.Linear(c.intermediate_size, c.hidden_size, bias=False, **kw)

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
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)


class LlamaForCausalLM(nn.Module):
    """Causal LM head over LlamaModel, HF-compatible module names. A model
    family with another decoder layer subclasses it and sets `layer_cls`."""

    layer_cls = LlamaDecoderLayer

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
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False, **kw)
        self.register_buffer("inv_freq", torch.empty(config.head_dim // 2, device="meta"), persistent=False)
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
        for part in parts:
            part.to_empty(device=device)
            _init_weights(part, generator)
            if layer_fn is not None and isinstance(part, self.layer_cls):
                layer_fn(part)
        c = self.config
        self.inv_freq = rope_params(c.head_dim, c.rope_theta, c.rope_scaling).to(device)

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
        x = self.model.embed_tokens(input_ids.long())
        pos0 = torch.as_tensor(cache_pos, device=dev).reshape(-1, 1)
        positions = (pos0 + torch.arange(T, device=dev)[None, :]).expand(B, T)
        cos, sin = _rope(positions, self.inv_freq, x.dtype)
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
        return _deq(self.lm_head(x)), (tuple(new_cache) if new_cache is not None else None)
