"""Qwen3 and Qwen3-MoE causal LMs in PyTorch.

Counterpart of `quanto_tpu/models/qwen3.py` (Hugging Face
`modeling_qwen3.py`, `modeling_qwen3_moe.py`): the Llama layout with

- QK-norm: plain RMSNorms on the [B, T, H, D] query and key heads before
  rope, the scale head_dim ** -0.5, no biases;
- an explicit `head_dim`, and sliding-window attention on the tail layers
  (`layer_types`, sliding for i >= `max_window_layers` when
  `use_sliding_window`) by mask over flat caches: JAX's Qwen3 builds no rings;
- Qwen3-MoE: sparse MoE MLPs (`mlp.gate`, `mlp.experts.{e}.gate_proj/up_proj/
  down_proj`) on the layers `is_moe_layer` names, routed by softmax, top-k,
  and a renormalization only under `norm_topk_prob`; no shared expert.
  `parallel/moe.py:convert_moe_to_stacked` swaps the dense-mask block for the
  stacked dispatch through the MoE kernels.

Attention is Gemma-2's module (`models/gemma2.py:Gemma2Attention`) with the
q/k norms and no softcap: a T == 1 step over a cache takes `flash_decode`
(with the window on a sliding layer), a step causal from position 0 takes
`flash_prefill` where the window covers it, every other step `gqa_attention`
with the layer's mask. Module names are Hugging Face's, so state dicts and
checkpoints transfer with the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from ..ops.attention import static_zero_pos
from ..tensor.kv_cache import cache_max_len
from .gemma2 import SLIDING, Gemma2Attention
from .llama import (
    LlamaForCausalLM, LlamaMLP, RMSNorm, _rope, _select_logit_rows, freeze_rope_scaling, init_kv_cache,
)
from .mixtral import route, routing_mask
from .sliding import flat_masks


__all__ = ["Qwen3Config", "Qwen3ForCausalLM", "Qwen3MoeConfig", "Qwen3MoeForCausalLM", "Qwen3MoeSparseBlock"]


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int = 151936
    hidden_size: int = 4096
    intermediate_size: int = 22016
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    head_dim: int = 128
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # Hugging Face's rope_scaling as (key, value) pairs (`LlamaConfig.rope_scaling`).
    rope_scaling: Optional[Any] = None
    sliding_window: Optional[int] = None
    layer_types: Optional[Tuple[str, ...]] = None
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"
    mlp_bias: bool = False
    dtype: torch.dtype = torch.float32

    # Read by the Llama and Gemma-2 modules: plain norms (also on q and k), no biases, no softcap.
    rms_norm_unit_offset = False
    attention_bias = False
    attn_logit_softcapping = None
    hf_model_type = "qwen3"
    hf_architecture = "Qwen3ForCausalLM"

    @property
    def query_pre_attn_scalar(self) -> int:
        """The query scale is head_dim ** -0.5 (JAX `qwen3.py:170`)."""
        return self.head_dim

    def __post_init__(self):
        if self.num_key_value_heads is None:
            object.__setattr__(self, "num_key_value_heads", self.num_attention_heads)
        lt = ("full_attention",) * self.num_hidden_layers if self.layer_types is None else self.layer_types
        object.__setattr__(self, "layer_types", tuple(lt))

    @classmethod
    def from_hf(cls, hf: Mapping[str, Any], dtype=torch.bfloat16):
        """From the plain dict of a Hugging Face qwen3 (or qwen3_moe)
        `config.json`, deriving what transformers' config derives (4.57.6
        `configuration_qwen3.py:186-216`) and JAX then reads from it:
        `sliding_window` is None unless `use_sliding_window`, and a qwen3
        config's `layer_types` slide from `max_window_layers` on only where a
        window is set (a qwen3_moe config has none: every layer full). The
        rope types are `LlamaConfig.from_hf`'s."""
        window = hf.get("sliding_window", 4096) if hf.get("use_sliding_window", False) else None
        n = hf.get("num_hidden_layers", cls.num_hidden_layers)
        layer_types = hf.get("layer_types")
        if layer_types is None and window is not None and hf.get("model_type", "qwen3") == "qwen3":
            mwl = hf.get("max_window_layers", 28)
            layer_types = [SLIDING if i >= mwl else "full_attention" for i in range(n)]
        return cls(
            vocab_size=hf.get("vocab_size", cls.vocab_size),
            hidden_size=hf.get("hidden_size", cls.hidden_size),
            intermediate_size=hf.get("intermediate_size", cls.intermediate_size),
            num_hidden_layers=n,
            num_attention_heads=hf.get("num_attention_heads", cls.num_attention_heads),
            num_key_value_heads=hf.get("num_key_value_heads"),
            head_dim=hf.get("head_dim", 128),
            max_position_embeddings=hf.get("max_position_embeddings", 32768),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=freeze_rope_scaling(hf.get("rope_scaling")),
            sliding_window=window,
            layer_types=tuple(layer_types) if layer_types else None,
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            hidden_act=hf.get("hidden_act", "silu"),
            dtype=dtype,
            **cls._hf_extra(hf),
        )

    @classmethod
    def _hf_extra(cls, hf: Mapping[str, Any]) -> dict:
        return {}

    def to_hf(self) -> dict:
        """This configuration as a `config.json` dict that
        `transformers.AutoConfig` reads and `from_hf` inverts."""
        rope = {k: list(v) if isinstance(v, tuple) else v for k, v in dict(self.rope_scaling or {}).items()}
        sliding = [i for i, t in enumerate(self.layer_types) if t == SLIDING]
        return {
            "architectures": [self.hf_architecture],
            "model_type": self.hf_model_type,
            **{f.name: getattr(self, f.name) for f in dataclasses.fields(Qwen3Config)
               if f.name not in ("rope_scaling", "sliding_window", "layer_types", "mlp_bias", "dtype")},
            "rope_scaling": rope or None,
            "use_sliding_window": self.sliding_window is not None,
            "sliding_window": self.sliding_window,
            "max_window_layers": sliding[0] if sliding else self.num_hidden_layers,
            "layer_types": list(self.layer_types),
            "attention_bias": False,
            "torch_dtype": str(self.dtype).removeprefix("torch."),
        }


@dataclasses.dataclass(frozen=True)
class Qwen3MoeConfig(Qwen3Config):
    num_experts: int = 128
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 768
    norm_topk_prob: bool = True
    decoder_sparse_step: int = 1
    mlp_only_layers: Tuple[int, ...] = ()

    hf_model_type = "qwen3_moe"
    hf_architecture = "Qwen3MoeForCausalLM"

    @classmethod
    def _hf_extra(cls, hf: Mapping[str, Any]) -> dict:
        """The MoE keys, with transformers' `Qwen3MoeConfig` defaults
        (`norm_topk_prob` False there) where the file names none."""
        return {
            "num_experts": hf.get("num_experts", 128),
            "num_experts_per_tok": hf.get("num_experts_per_tok", 8),
            "moe_intermediate_size": hf.get("moe_intermediate_size", 768),
            "norm_topk_prob": hf.get("norm_topk_prob", False),
            "decoder_sparse_step": hf.get("decoder_sparse_step", 1),
            "mlp_only_layers": tuple(hf.get("mlp_only_layers") or ()),
        }

    def to_hf(self) -> dict:
        out = super().to_hf()
        del out["layer_types"], out["max_window_layers"]  # not keys of transformers' Qwen3MoeConfig
        return {**out, **{k: getattr(self, k) for k in self._hf_extra({})}, "mlp_only_layers": list(self.mlp_only_layers)}

    def is_moe_layer(self, layer_idx: int) -> bool:
        return (
            layer_idx not in self.mlp_only_layers
            and self.num_experts > 0
            and (layer_idx + 1) % self.decoder_sparse_step == 0
        )


class Qwen3Attention(Gemma2Attention):
    """Plain q/k norms, the scale head_dim ** -0.5, no bias (JAX `qwen3.py:124-172`)."""

    qk_norm = True


class Qwen3MoeSparseBlock(nn.Module):
    """The dense-mask block (JAX `qwen3.py:175-200`): every expert on every
    token, weighted by its routing weight (softmax, top-k, renormalized only
    under `norm_topk_prob`)."""

    def __init__(self, c: Qwen3MoeConfig, **kw):
        super().__init__()
        self.num_experts = c.num_experts
        self.top_k = c.num_experts_per_tok
        self.norm_topk_prob = c.norm_topk_prob
        self.gate = nn.Linear(c.hidden_size, c.num_experts, bias=False, **kw)
        self.experts = nn.ModuleList(
            [LlamaMLP(c, intermediate_size=c.moe_intermediate_size, **kw) for _ in range(c.num_experts)])

    def forward(self, x):
        mask = routing_mask(*route(self.gate, x, self.top_k, self.norm_topk_prob), self.num_experts)
        out = torch.zeros_like(x)
        for e, expert in enumerate(self.experts):
            out = out + (mask[..., e : e + 1] * expert(x).float()).to(x.dtype)
        return out


class Qwen3DecoderLayer(nn.Module):
    def __init__(self, c: Qwen3Config, layer_idx: int = 0, **kw):
        super().__init__()
        self.self_attn = Qwen3Attention(c, **kw)
        moe = isinstance(c, Qwen3MoeConfig) and c.is_moe_layer(layer_idx)
        self.mlp = Qwen3MoeSparseBlock(c, **kw) if moe else LlamaMLP(c, **kw)
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, **kw)

    def forward(self, x, cos, sin, mask, layer_cache=None, cache_pos=None, decode_pos=None, **attn):
        h, new_cache = self.self_attn(
            self.input_layernorm(x), cos, sin, mask, layer_cache, cache_pos, decode_pos, **attn)
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_cache


class Qwen3ForCausalLM(LlamaForCausalLM):
    """Qwen3 with the `(logits, cache)` decode API of the other families;
    built as `LlamaForCausalLM` builds (on `device`, or on "meta" until
    `materialize_`). Also the base of Qwen3-MoE."""

    layer_cls = Qwen3DecoderLayer

    def forward(self, input_ids: torch.Tensor, cache=None, cache_pos=0, logits_indices=None):
        """Forward pass; returns (logits, cache or None), as
        `LlamaForCausalLM.forward`; the sliding layers attend to the last
        `sliding_window` positions by mask (JAX `qwen3.py:247-285`)."""
        c = self.config
        B, T = input_ids.shape
        dev = input_ids.device
        x = self.model.embed_tokens(input_ids.long())
        pos0 = torch.as_tensor(cache_pos, device=dev).reshape(-1, 1)
        positions = (pos0 + torch.arange(T, device=dev)[None, :]).expand(B, T)
        cos, sin = _rope(positions, self.inv_freq, x.dtype, self.attn_scale)
        w = c.sliding_window
        full_mask = sliding_mask = decode_pos = None
        if cache is not None and T == 1:
            decode_pos = positions[:, 0].to(torch.int32).contiguous()
        else:
            full_mask, sliding_mask = flat_masks(positions, None if cache is None else cache_max_len(cache[0]), w)
        causal0 = static_zero_pos(cache_pos)
        for i, layer in enumerate(self.model.layers):
            sliding = w is not None and c.layer_types[i] == SLIDING
            # A sliding layer whose window covers the whole step is still causal from 0.
            x, _ = layer(
                x, cos, sin, sliding_mask if sliding else full_mask, cache[i] if cache is not None else None,
                cache_pos, decode_pos, causal_ok=causal0 and (not sliding or w >= T), window=w if sliding else None,
            )
        x = _select_logit_rows(self.model.norm(x), logits_indices)
        return self._logits(x), cache

    def init_kv_cache(self, batch: int, max_len: int, dtype=None, kv_quant=None):
        """Flat caches on the model's device, float in `dtype` (default the
        model dtype) or quantized when `kv_quant` names a qtype or KV spec
        (JAX `qwen3.py:287-299`)."""
        return init_kv_cache(self.config, batch, max_len, dtype=dtype, kv_quant=kv_quant, device=self.device)


class Qwen3MoeForCausalLM(Qwen3ForCausalLM):
    """Qwen3-MoE: Qwen3's attention and sparse MoE MLPs (no shared expert)."""
