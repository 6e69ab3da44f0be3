"""GPT-OSS (OpenAI's open-weight MoE family, 2025) causal LM in PyTorch.

Counterpart of `quanto_tpu/models/gpt_oss.py` (Hugging Face
`modeling_gpt_oss.py`). Its distinctives:

- attention sinks: a learned logit per query head (`self_attn.sinks`) joins
  every softmax as a slot without a value, after the scale and the mask (a
  denominator term of `gqa_attention` and of `flash_decode`, `sinks=`);
- alternating sliding (window 128, the even layers) and full attention, by
  `layer_types`, with W-slot ring caches on the sliding layers
  (`init_kv_cache(sliding_ring=True)`, `models/sliding.py`);
- biased q/k/v/o projections, the scale head_dim ** -0.5, plain RMSNorms,
  yarn rope with `truncate: False`, an untied head;
- an MoE MLP with FUSED expert parameters, as Hugging Face stores them:
  `experts.gate_up_proj` [E, H, 2I] with gate and up INTERLEAVED on the last
  dim (`[..., 0::2]`, `[..., 1::2]`), `experts.down_proj` [E, I, H], all
  biased, and the clamped SwiGLU `(clip(up, +-7) + 1) * g sigmoid(1.702 g)`,
  g = min(gate, 7); the router (`mlp.router`, a plain [E, H] weight and an [E]
  bias) takes top-k of its biased logits and a softmax over the selected
  logits only. `GptOssMLP` is the dense float loop over the experts, as JAX's;
  `parallel/moe.py:convert_gpt_oss_moe_to_stacked` quantizes the experts as it
  swaps the block for the stacked dispatch through the MoE kernels.

The attention is Gemma-2's module with the sinks (`Gemma2Attention._sinks`):
a T == 1 step over a cache goes to `flash_decode` with the sinks (the window on
a flat sliding layer, the post-write ring on a ring layer); every T > 1 step
runs `gqa_attention`'s float32 chain with the sinks over the cache readback,
the ring's concatenation or the raw K/V, as JAX does at every T. It never takes
`flash_prefill`: JAX's gpt-oss never calls splash, and D = 64 is outside its
envelope. The model is Gemma-2's forward (`write_len`, `logits_indices`, the
masks and rings of `models/sliding.py`) without Gemma's embedding normalizer
or softcaps. Module names are Hugging Face's, so `models/loading.py` carries
JAX's (or a checkpoint's) tensors into the model by name; the router and the
fused experts are plain parameters that `quantize` leaves in float, as JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from .gemma2 import SLIDING, Gemma2Attention, Gemma2ForCausalLM
from .llama import _INIT_STD, RMSNorm, freeze_rope_scaling


__all__ = ["GptOssConfig", "GptOssForCausalLM", "GptOssMLP"]

# openai/gpt-oss-20b's rope: yarn, factor 32 over 4096 positions, un-rounded correction range.
_YARN = {"beta_fast": 32.0, "beta_slow": 1.0, "factor": 32.0, "original_max_position_embeddings": 4096,
         "rope_type": "yarn", "truncate": False}


@dataclasses.dataclass(frozen=True)
class GptOssConfig:
    """The released defaults (openai/gpt-oss-20b's config.json, JAX
    `gpt_oss.py:50-77`); `layer_types` alternate, layer 0 sliding."""

    vocab_size: int = 201088
    hidden_size: int = 2880
    intermediate_size: int = 2880
    num_hidden_layers: int = 24
    num_attention_heads: int = 64
    num_key_value_heads: int = 8
    head_dim: int = 64
    num_local_experts: int = 32
    num_experts_per_tok: int = 4
    sliding_window: int = 128
    layer_types: Optional[Tuple[str, ...]] = None
    rope_theta: float = 150000.0
    # Hugging Face's rope_scaling as sorted (key, value) pairs; None: unscaled rope.
    rope_scaling: Optional[Any] = freeze_rope_scaling(_YARN)
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5
    attention_bias: bool = True
    tie_word_embeddings: bool = False
    swiglu_alpha: float = 1.702
    swiglu_limit: float = 7.0
    dtype: torch.dtype = torch.float32

    # Read by the Llama and Gemma-2 modules: plain norms, no softcaps.
    rms_norm_unit_offset = False
    attn_logit_softcapping = None
    final_logit_softcapping = None
    hf_model_type = "gpt_oss"

    @property
    def query_pre_attn_scalar(self) -> int:
        """The query scale is head_dim ** -0.5 (JAX `gpt_oss.py:181`)."""
        return self.head_dim

    def __post_init__(self):
        lt = self.layer_types
        if lt is None:
            lt = (SLIDING if i % 2 == 0 else "full_attention" for i in range(self.num_hidden_layers))
        object.__setattr__(self, "layer_types", tuple(lt))

    @classmethod
    def from_hf(cls, hf: Mapping[str, Any], dtype=torch.bfloat16) -> "GptOssConfig":
        """From the plain dict of a Hugging Face gpt_oss `config.json`, a
        missing key taking Hugging Face's `GptOssConfig` default, as JAX's
        `from_hf` reads the config object (`gpt_oss.py:91-116`)."""
        get = hf.get
        lt = get("layer_types")
        return cls(
            vocab_size=get("vocab_size", 201088),
            hidden_size=get("hidden_size", 2880),
            intermediate_size=get("intermediate_size", 2880),
            num_hidden_layers=get("num_hidden_layers", 36),
            num_attention_heads=get("num_attention_heads", 64),
            num_key_value_heads=get("num_key_value_heads", 8),
            head_dim=get("head_dim", 64),
            num_local_experts=get("num_local_experts", 128),
            num_experts_per_tok=get("num_experts_per_tok", 4),
            sliding_window=get("sliding_window", 128),
            layer_types=tuple(lt) if lt else None,
            rope_theta=get("rope_theta", 150000.0),
            rope_scaling=freeze_rope_scaling(get("rope_scaling", _YARN)),
            max_position_embeddings=get("max_position_embeddings", 131072),
            rms_norm_eps=get("rms_norm_eps", 1e-5),
            attention_bias=get("attention_bias", True),
            tie_word_embeddings=get("tie_word_embeddings", False),
            dtype=dtype,
        )


class GptOssAttention(Gemma2Attention):
    """Gemma-2's attention with biased q/k/v/o, no softcap and the per-head
    sinks (JAX `gpt_oss.py:124-183`)."""

    def __init__(self, c: GptOssConfig, **kw):
        super().__init__(c, **kw)
        self.sinks = nn.Parameter(torch.zeros(c.num_attention_heads, **kw))

    def _sinks(self):
        return self.sinks.float()

    def init_weights_(self, generator: torch.Generator) -> None:
        """Hugging Face's initializer: the sinks normal (0.02), as the weights."""
        self.sinks.normal_(0.0, _INIT_STD, generator=generator)


class GptOssExperts(nn.Module):
    """The fused expert parameters in Hugging Face's layout (plain parameters,
    not linears), and one expert's clamped-SwiGLU MLP (JAX `gpt_oss.py:186-218`)."""

    def __init__(self, c: GptOssConfig, **kw):
        super().__init__()
        E, H, I = c.num_local_experts, c.hidden_size, c.intermediate_size
        self.gate_up_proj = nn.Parameter(torch.zeros((E, H, 2 * I), **kw))
        self.gate_up_proj_bias = nn.Parameter(torch.zeros((E, 2 * I), **kw))
        self.down_proj = nn.Parameter(torch.zeros((E, I, H), **kw))
        self.down_proj_bias = nn.Parameter(torch.zeros((E, H), **kw))
        self.alpha = c.swiglu_alpha
        self.limit = c.swiglu_limit

    def init_weights_(self, generator: torch.Generator) -> None:
        """Hugging Face's initializer: the weights normal (0.02), the biases zero."""
        for p in (self.gate_up_proj, self.down_proj):
            p.normal_(0.0, _INIT_STD, generator=generator)
        for p in (self.gate_up_proj_bias, self.down_proj_bias):
            p.zero_()

    def expert(self, x: torch.Tensor, e: int) -> torch.Tensor:
        """Expert e on tokens x [N, H] -> [N, H] in x's dtype."""
        gu = x @ self.gate_up_proj[e].to(x.dtype) + self.gate_up_proj_bias[e].to(x.dtype)
        h = clamped_swiglu(gu[..., 0::2], gu[..., 1::2], self.alpha, self.limit)
        return h @ self.down_proj[e].to(x.dtype) + self.down_proj_bias[e].to(x.dtype)


def clamped_swiglu(g: torch.Tensor, u: torch.Tensor, alpha: float, limit: float) -> torch.Tensor:
    """gpt-oss's GLU: (clip(u, -limit, limit) + 1) * g sigmoid(alpha g), g = min(g, limit)."""
    g = g.clamp(max=limit)
    return (u.clamp(-limit, limit) + 1.0) * (g * torch.sigmoid(g * alpha))


class GptOssTopKRouter(nn.Module):
    """The router (JAX `gpt_oss.py:221-243`): a plain [E, H] weight and an [E]
    bias, not a linear, so `quantize` leaves it in float."""

    def __init__(self, c: GptOssConfig, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((c.num_local_experts, c.hidden_size), **kw))
        self.bias = nn.Parameter(torch.zeros(c.num_local_experts, **kw))
        self.top_k = c.num_experts_per_tok
        self.num_experts = c.num_local_experts

    def init_weights_(self, generator: torch.Generator) -> None:
        """Hugging Face's initializer: weight and bias normal (0.02)."""
        for p in (self.weight, self.bias):
            p.normal_(0.0, _INIT_STD, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[..., H] -> float32 logits [..., E]: x's dtype plus the bias, then float32."""
        return (x @ self.weight.t().to(x.dtype) + self.bias.to(x.dtype)).float()

    def topk(self, x: torch.Tensor):
        """[..., H] -> (top_i [..., K] int64, top_p [..., K] float32): top-k of
        the logits and a softmax over the selected logits only."""
        top_v, top_i = torch.topk(self(x), self.top_k, dim=-1)
        return top_i, torch.softmax(top_v, dim=-1)


class GptOssMLP(nn.Module):
    """The dense float MoE MLP (JAX `gpt_oss.py:246-260`): every expert on
    every token, weighted by its routing weight, summed in float32."""

    def __init__(self, c: GptOssConfig, **kw):
        super().__init__()
        self.router = GptOssTopKRouter(c, **kw)
        self.experts = GptOssExperts(c, **kw)
        self.num_experts = c.num_local_experts

    def forward(self, x: torch.Tensor, valid=None) -> torch.Tensor:
        """x [B, T, H]; `valid` (a chunk's real columns) is the stacked block's
        (`parallel/moe.py`): each token here runs on its own, so pads move nothing."""
        B, T, H = x.shape
        flat = x.reshape(-1, H)
        top_i, top_p = self.router.topk(flat)
        scores = torch.zeros((flat.shape[0], self.num_experts), dtype=torch.float32, device=x.device)
        scores.scatter_(1, top_i, top_p)
        out = torch.zeros(flat.shape, dtype=torch.float32, device=x.device)
        for e in range(self.num_experts):
            out += scores[:, e : e + 1] * self.experts.expert(flat, e).float()
        return out.to(x.dtype).reshape(B, T, H)


class GptOssDecoderLayer(nn.Module):
    def __init__(self, c: GptOssConfig, layer_idx: int = 0, **kw):
        super().__init__()
        self.self_attn = GptOssAttention(c, **kw)
        self.mlp = GptOssMLP(c, **kw)
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, **kw)

    def forward(self, x, cos, sin, mask, layer_cache=None, cache_pos=None, decode_pos=None, **attn):
        h, new_cache = self.self_attn(
            self.input_layernorm(x), cos, sin, mask, layer_cache, cache_pos, decode_pos, **attn)
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x), attn.get("write_valid"))
        return x, new_cache


class GptOssForCausalLM(Gemma2ForCausalLM):
    """GPT-OSS with the `(logits, cache)` decode API of the other families
    (`forward(input_ids, cache, cache_pos, write_len, logits_indices)`,
    `init_kv_cache(batch, max_len, dtype, kv_quant, sliding_ring=True)`: W-slot
    rings on the sliding layers past W, JAX `gpt_oss.py:377-410`); built as
    `LlamaForCausalLM` builds (on `device`, or on "meta" until `materialize_`,
    a decoder layer at a time)."""

    layer_cls = GptOssDecoderLayer
    normalize_embeddings = False
    flash_prefill = False
