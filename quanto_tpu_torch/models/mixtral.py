"""Mixtral (a sparse mixture-of-experts llama) causal LM in PyTorch.

Counterpart of `quanto_tpu/models/mixtral.py:41-185`: a router
(`block_sparse_moe.gate`) and per-expert SwiGLU MLPs
(`block_sparse_moe.experts.E.w1/w2/w3`, w1 = gate, w2 = down, w3 = up) in
place of the llama MLP; attention, norms, rope, the KV cache and the forward
pass are the llama model's (`models/llama.py`), so state dicts, include /
exclude patterns and `models/serve.py` carry over unchanged.

`MixtralSparseMoeBlock` is the dense-mask block, exactly as JAX's: every
expert runs on every token and is weighted by its (mostly zero) routing
weight. `parallel/moe.py:convert_moe_to_stacked` swaps it for the
stacked-expert dispatch through the MoE kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .llama import LlamaAttention, LlamaConfig, LlamaForCausalLM, RMSNorm, _deq


__all__ = ["MixtralConfig", "MixtralForCausalLM", "MixtralSparseMoeBlock", "route"]


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2

    hf_model_type = "mixtral"
    hf_architecture = "MixtralForCausalLM"

    @classmethod
    def _hf_extra(cls, hf: Mapping[str, Any]) -> dict:
        """The expert keys (`quanto_tpu/models/mixtral.py:47-53`)."""
        return {
            "num_local_experts": hf.get("num_local_experts", 8),
            "num_experts_per_tok": hf.get("num_experts_per_tok", 2),
        }

    def to_hf(self) -> dict:
        return {
            **super().to_hf(),
            "num_local_experts": self.num_local_experts,
            "num_experts_per_tok": self.num_experts_per_tok,
        }


def route(gate: nn.Module, x: torch.Tensor, top_k: int):
    """The mixtral router (`quanto_tpu/models/mixtral.py:84-89`): float32
    softmax over the gate's logits, top-k, renormalized. x [..., H] ->
    (top_i [..., K] int64, top_p [..., K] float32)."""
    probs = torch.softmax(_deq(gate(x)).float(), dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    return top_i, top_p / top_p.sum(dim=-1, keepdim=True)


def routing_mask(top_i: torch.Tensor, top_p: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Dense routing weights [..., E] float32: top_p scattered to the routed
    experts, zero elsewhere (the one-hot sum of `mixtral.py:91-95`; the top-k
    ids of a token are distinct, so each weight lands alone)."""
    mask = torch.zeros((*top_i.shape[:-1], num_experts), dtype=torch.float32, device=top_p.device)
    return mask.scatter_(-1, top_i.long(), top_p)


class MixtralExpert(nn.Module):
    """One expert's SwiGLU MLP (HF names w1 = gate, w2 = down, w3 = up)."""

    def __init__(self, c: MixtralConfig, **kw):
        super().__init__()
        self.w1 = nn.Linear(c.hidden_size, c.intermediate_size, bias=False, **kw)
        self.w2 = nn.Linear(c.intermediate_size, c.hidden_size, bias=False, **kw)
        self.w3 = nn.Linear(c.hidden_size, c.intermediate_size, bias=False, **kw)

    def forward(self, x):
        return _deq(self.w2(F.silu(_deq(self.w1(x))) * _deq(self.w3(x))))


class MixtralSparseMoeBlock(nn.Module):
    """The dense-mask block (`quanto_tpu/models/mixtral.py:77-99`)."""

    def __init__(self, c: MixtralConfig, **kw):
        super().__init__()
        self.num_experts = c.num_local_experts
        self.top_k = c.num_experts_per_tok
        self.gate = nn.Linear(c.hidden_size, c.num_local_experts, bias=False, **kw)
        self.experts = nn.ModuleList([MixtralExpert(c, **kw) for _ in range(c.num_local_experts)])

    def forward(self, x):
        mask = routing_mask(*route(self.gate, x, self.top_k), self.num_experts)
        out = torch.zeros_like(x)
        for e, expert in enumerate(self.experts):
            out = out + (mask[..., e : e + 1] * expert(x).float()).to(x.dtype)
        return out


class MixtralDecoderLayer(nn.Module):
    def __init__(self, c: MixtralConfig, **kw):
        super().__init__()
        self.self_attn = LlamaAttention(c, **kw)
        self.block_sparse_moe = MixtralSparseMoeBlock(c, **kw)
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, **kw)

    def forward(self, x, cos, sin, mask, layer_cache=None, cache_pos=None, decode_pos=None):
        h, new_cache = self.self_attn(
            self.input_layernorm(x), cos, sin, mask, layer_cache, cache_pos, decode_pos
        )
        x = x + h
        x = x + self.block_sparse_moe(self.post_attention_layernorm(x))
        return x, new_cache


class MixtralForCausalLM(LlamaForCausalLM):
    """Mixtral causal LM, HF-compatible module names; the llama forward."""

    layer_cls = MixtralDecoderLayer
