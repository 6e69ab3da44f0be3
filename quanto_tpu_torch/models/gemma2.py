"""Gemma-2 causal LM in PyTorch.

Counterpart of `quanto_tpu/models/gemma2.py`: a Llama-shaped decoder with
Gemma-2's four mechanisms (Hugging Face `modeling_gemma2.py`):

- alternating attention: the layers `layer_types` names "sliding_attention"
  (by default the even ones) attend to the last `sliding_window` positions,
  the current one included; the others are fully causal;
- logit softcaps: attention logits pass through c tanh(x / c) after the
  query scale and before the mask, the final logits through the same with
  `final_logit_softcapping`;
- the query scale `query_pre_attn_scalar ** -0.5`, not head_dim ** -0.5;
- four unit-offset RMSNorms a layer: `post_attention_layernorm` and
  `post_feedforward_layernorm` normalise a sublayer's output before the
  residual add.

It reuses the port's RMSNorm, rope, logit-row selection and "meta" build
(`materialize_`, a decoder layer at a time) from `models/llama.py`; module
names are Hugging Face's, so state dicts and checkpoints transfer with the JAX
package.

Attention (JAX `gemma2.py:126-185`, `:277-323`): a step of T > 1 that is
causal from position 0 takes `flash_prefill` with the softcap and the scale
where the layer is not a ring and (not sliding, or W >= T); a sliding ring
layer (`init_kv_cache(sliding_ring=True)` past W, `models/sliding.py`)
attends to its pre-write ring joined with the chunk; every other T > 1 step
runs `gqa_attention` over the cache readback with the layer's mask. Where JAX
runs every T == 1 step through `gqa_attention`, the port sends it to
`flash_decode` (`ops/attention.py:decode_attention`) with the scale, the
softcap and, on a flat sliding layer, the window; a ring layer's step reads
the post-write ring.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import decode_attention, gqa_attention, static_zero_pos, try_flash_prefill
from ..tensor.kv_cache import cache_max_len, init_quantized_kv_cache, kv_read_raw, kv_ring_update, kv_update
from .llama import LlamaForCausalLM, RMSNorm, _apply_rope, _deq, _rope, _select_logit_rows
from .sliding import flat_masks, layer_cache_len, ring_attention_inputs, ring_mask, use_ring, write_valid_mask


__all__ = ["Gemma2Config", "Gemma2ForCausalLM"]

SLIDING = "sliding_attention"


@dataclasses.dataclass(frozen=True)
class Gemma2Config:
    vocab_size: int = 256000
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_hidden_layers: int = 26
    num_attention_heads: int = 8
    num_key_value_heads: Optional[int] = None
    head_dim: int = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    query_pre_attn_scalar: float = 256.0
    attn_logit_softcapping: Optional[float] = 50.0
    final_logit_softcapping: Optional[float] = 30.0
    sliding_window: int = 4096
    layer_types: Optional[Tuple[str, ...]] = None
    attention_bias: bool = False
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.float32

    # Read by `LlamaForCausalLM.__init__`: Gemma's unit-offset norms and the default rope.
    rms_norm_unit_offset = True
    rope_scaling = None

    def __post_init__(self):
        if self.num_key_value_heads is None:
            object.__setattr__(self, "num_key_value_heads", self.num_attention_heads)
        if self.layer_types is None:
            # Hugging Face's default (configuration_gemma2.py): the even layers slide.
            object.__setattr__(self, "layer_types", tuple(
                SLIDING if (i + 1) % 2 else "full_attention" for i in range(self.num_hidden_layers)))
        else:
            object.__setattr__(self, "layer_types", tuple(self.layer_types))

    @classmethod
    def from_hf(cls, hf: Mapping[str, Any], dtype=torch.bfloat16) -> "Gemma2Config":
        """From the plain dict of a Hugging Face gemma2 `config.json`, with the
        defaults of JAX's `Gemma2Config.from_hf` (`gemma2.py:75-98`). Raises
        on a rope_scaling, as JAX does."""
        if hf.get("rope_scaling") is not None:
            raise ValueError("Gemma-2 rope_scaling is not supported")
        get = hf.get
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=get("num_key_value_heads"),
            head_dim=get("head_dim", 256),
            max_position_embeddings=get("max_position_embeddings", 8192),
            rms_norm_eps=get("rms_norm_eps", 1e-6),
            rope_theta=get("rope_theta", 10000.0),
            query_pre_attn_scalar=get("query_pre_attn_scalar", 256.0),
            attn_logit_softcapping=get("attn_logit_softcapping", 50.0),
            final_logit_softcapping=get("final_logit_softcapping", 30.0),
            sliding_window=get("sliding_window", 4096),
            layer_types=tuple(get("layer_types")) if get("layer_types") else None,
            attention_bias=get("attention_bias", False),
            tie_word_embeddings=get("tie_word_embeddings", True),
            dtype=dtype,
        )

    def to_hf(self) -> dict:
        """This configuration as a gemma2 `config.json` dict, plain JSON that
        `transformers.AutoConfig` reads and `from_hf` inverts."""
        return {
            "architectures": ["Gemma2ForCausalLM"],
            "model_type": "gemma2",
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
            "query_pre_attn_scalar": self.query_pre_attn_scalar,
            "attn_logit_softcapping": self.attn_logit_softcapping,
            "final_logit_softcapping": self.final_logit_softcapping,
            "sliding_window": self.sliding_window,
            "layer_types": list(self.layer_types),
            "hidden_activation": "gelu_pytorch_tanh",
            "hidden_act": "gelu_pytorch_tanh",
            "attention_bias": self.attention_bias,
            "tie_word_embeddings": self.tie_word_embeddings,
            "torch_dtype": str(self.dtype).removeprefix("torch."),
        }


class Gemma2Attention(nn.Module):
    # Gemma-3's and Qwen3's subclasses: RMSNorms (the config's unit offset) on the [B, T, H, D]
    # query and key heads before rope.
    qk_norm = False

    def __init__(self, c: Gemma2Config, **kw):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.head_dim
        self.scaling = c.query_pre_attn_scalar**-0.5
        self.softcap = c.attn_logit_softcapping
        q_out, kv_out = self.num_heads * self.head_dim, self.num_kv_heads * self.head_dim
        self.q_proj = nn.Linear(c.hidden_size, q_out, bias=c.attention_bias, **kw)
        self.k_proj = nn.Linear(c.hidden_size, kv_out, bias=c.attention_bias, **kw)
        self.v_proj = nn.Linear(c.hidden_size, kv_out, bias=c.attention_bias, **kw)
        self.o_proj = nn.Linear(q_out, c.hidden_size, bias=c.attention_bias, **kw)
        if self.qk_norm:
            self.q_norm = RMSNorm(c.head_dim, c.rms_norm_eps, c.rms_norm_unit_offset, **kw)
            self.k_norm = RMSNorm(c.head_dim, c.rms_norm_eps, c.rms_norm_unit_offset, **kw)

    def forward(self, x, cos, sin, mask, layer_cache=None, cache_pos=None, decode_pos=None, causal_ok=False,
                ring=False, write_valid=None, window=None):
        """`decode_pos` int32 [B]: each row's position in a T == 1 step over a
        cache; `causal_ok`: the step may take `flash_prefill`; `ring`: the
        layer's cache is a W-slot ring; `window`: a flat sliding layer's W,
        for the decode kernel."""
        B, T, _ = x.shape
        q = _deq(self.q_proj(x)).view(B, T, self.num_heads, self.head_dim)
        k = _deq(self.k_proj(x)).view(B, T, self.num_kv_heads, self.head_dim)
        v = _deq(self.v_proj(x)).view(B, T, self.num_kv_heads, self.head_dim)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        tf = dict(scale=self.scaling, softcap=self.softcap)
        sinks = self._sinks()
        k_scale = v_scale = k_shift = v_shift = None
        if layer_cache is not None and T == 1:
            if ring:
                kv_ring_update(layer_cache, k, v, cache_pos)
            else:
                kv_update(layer_cache, k, v, cache_pos)
            out = decode_attention(q, layer_cache, decode_pos, window=window, ring=ring, sinks=sinks, **tf)
            return _deq(self.o_proj(out)), layer_cache
        if layer_cache is not None and ring:
            k, v, k_scale, v_scale, k_shift, v_shift = ring_attention_inputs(
                layer_cache, k, v, cache_pos, write_valid, q.dtype, B)
        elif layer_cache is not None:
            kv_update(layer_cache, k, v, cache_pos)
            out = try_flash_prefill(q, k, v, **tf) if causal_ok else None
            if out is not None:
                return _deq(self.o_proj(out)), layer_cache
            k, v, k_scale, v_scale, k_shift, v_shift = kv_read_raw(layer_cache, q.dtype, B)
        elif causal_ok and T > 1:
            out = try_flash_prefill(q, k, v, **tf)
            if out is not None:
                return _deq(self.o_proj(out)), None
        q5 = q.view(B, T, self.num_kv_heads, self.num_heads // self.num_kv_heads, self.head_dim)
        out = gqa_attention(
            q5, k, v, mask, self.scaling, k_scale=k_scale, v_scale=v_scale, k_shift=k_shift, v_shift=v_shift,
            softcap=self.softcap, sinks=sinks,
        )
        return _deq(self.o_proj(out)), layer_cache

    def _sinks(self):
        """float32 [H] per-head sink logits that join every softmax (gpt-oss's
        subclass), or None."""
        return None


class Gemma2MLP(nn.Module):
    def __init__(self, c: Gemma2Config, **kw):
        super().__init__()
        self.gate_proj = nn.Linear(c.hidden_size, c.intermediate_size, bias=False, **kw)
        self.up_proj = nn.Linear(c.hidden_size, c.intermediate_size, bias=False, **kw)
        self.down_proj = nn.Linear(c.intermediate_size, c.hidden_size, bias=False, **kw)

    def forward(self, x):
        # hidden_activation gelu_pytorch_tanh
        g, u = _deq(self.gate_proj(x)), _deq(self.up_proj(x))
        return _deq(self.down_proj(F.gelu(g, approximate="tanh") * u))


class Gemma2DecoderLayer(nn.Module):
    attn_cls = Gemma2Attention

    def __init__(self, c: Gemma2Config, layer_idx: int = 0, **kw):
        super().__init__()
        self.self_attn = self.attn_cls(c, **kw)
        self.mlp = Gemma2MLP(c, **kw)
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, unit_offset=True, **kw)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, unit_offset=True, **kw)
        self.pre_feedforward_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, unit_offset=True, **kw)
        self.post_feedforward_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, unit_offset=True, **kw)

    def forward(self, x, cos, sin, mask, layer_cache=None, cache_pos=None, decode_pos=None, **attn):
        h, new_cache = self.self_attn(
            self.input_layernorm(x), cos, sin, mask, layer_cache, cache_pos, decode_pos, **attn)
        x = x + self.post_attention_layernorm(h)
        x = x + self.post_feedforward_layernorm(self.mlp(self.pre_feedforward_layernorm(x)))
        return x, new_cache


class Gemma2ForCausalLM(LlamaForCausalLM):
    """Gemma-2 with a tied head and the `(logits, cache)` decode API of the
    other families; built as `LlamaForCausalLM` builds (on `device`, or on
    "meta" until `materialize_`), with Gemma-2's decoder layer."""

    layer_cls = Gemma2DecoderLayer
    # Gemma's normalizer sqrt(hidden_size) on the embeddings, and the flash-prefill route of a step
    # causal from 0 (gpt-oss, which reuses this forward, has neither: JAX's never calls splash).
    normalize_embeddings = True
    flash_prefill = True

    def _masks(self, B, T, cache, cache_pos, positions, ring):
        """(full, sliding) additive float32 masks [B or 1, 1, T, S] of a T > 1
        step (JAX `gemma2.py:244-275`); S = W + T for a ring's sliding layers."""
        c = self.config
        slots = None
        if cache is not None:
            # Sized from a full layer: a ring's sliding layers hold W slots. (The model's own
            # layers: a layer-skip draft keeps its target's longer `layer_types`.)
            fi = next((i for i in range(len(cache)) if c.layer_types[i] != SLIDING), 0)
            slots = cache_max_len(cache[fi])
        full, sliding = flat_masks(positions, slots, None if ring else c.sliding_window)
        if ring:
            neg = torch.finfo(torch.float32).min
            sliding = ring_mask(positions, positions[:, None, :, None], cache_pos, c.sliding_window, B, neg)
        return full, sliding

    def forward(self, input_ids: torch.Tensor, cache=None, cache_pos=0, write_len=None, logits_indices=None):
        """Forward pass; returns (logits, cache or None). As
        `LlamaForCausalLM.forward`, and `write_len` (scalar or [B]): the real
        tokens of each row of a padded engine chunk, whose other columns a
        ring's write skips (JAX `sliding.py:write_valid_mask`)."""
        c = self.config
        B, T = input_ids.shape
        dev = input_ids.device
        x = self.model.embed_tokens(input_ids.long())
        if self.normalize_embeddings:  # Gemma's normalizer, rounded to the activation dtype first (JAX :289)
            x = x * torch.tensor(c.hidden_size**0.5, dtype=x.dtype)
        pos0 = torch.as_tensor(cache_pos, device=dev).reshape(-1, 1)
        positions = (pos0 + torch.arange(T, device=dev)[None, :]).expand(B, T)
        ropes = self._ropes(positions, x.dtype)
        ring = use_ring(c, cache)
        decode = cache is not None and T == 1
        full_mask = sliding_mask = decode_pos = write_valid = None
        if decode:
            decode_pos = positions[:, 0].to(torch.int32).contiguous()
        else:
            full_mask, sliding_mask = self._masks(B, T, cache, cache_pos, positions, ring)
            # Read by a ring layer's write, and by gpt-oss's MoE blocks (pad columns take no capacity).
            write_valid = write_valid_mask(write_len, T, dev)
        causal0 = self.flash_prefill and static_zero_pos(cache_pos)
        for i, layer in enumerate(self.model.layers):
            sliding = c.layer_types[i] == SLIDING
            lring = ring and sliding
            layer_cache = cache[i] if cache is not None else None
            # flash_prefill attends to the raw K/V from 0: not a ring's concatenation, nor a
            # window shorter than the step.
            ok = causal0 and (not sliding or c.sliding_window >= T) and not lring
            x, _ = layer(
                x, *ropes[sliding], sliding_mask if sliding else full_mask, layer_cache, cache_pos, decode_pos,
                causal_ok=ok, ring=lring, write_valid=write_valid,
                window=c.sliding_window if sliding and not lring else None,
            )
        x = _select_logit_rows(self.model.norm(x), logits_indices)
        logits = self._logits(x)
        cap = c.final_logit_softcapping
        if cap is not None:
            logits = torch.tanh(logits / cap) * cap
        return logits, cache

    def _ropes(self, positions: torch.Tensor, dtype):
        """(cos, sin) of the full layers and of the sliding ones: one table (Gemma-3 has two),
        times the rope's attention factor (yarn's, for gpt-oss; 1 for Gemma-2)."""
        cos_sin = _rope(positions, self.inv_freq, dtype, self.attn_scale)
        return cos_sin, cos_sin

    def init_kv_cache(self, batch: int, max_len: int, dtype=None, kv_quant=None, sliding_ring: bool = True):
        """Per layer a cache on the model's device (JAX `gemma2.py:325-349`):
        a sliding layer's holds W slots (a ring) where `sliding_ring` and
        max_len > W, every other layer's max_len; float zeros in `dtype`
        (default the model dtype), or quantized when `kv_quant` is a qtype or
        KV spec name."""
        c = self.config
        Hkv, D, dev = c.num_key_value_heads, c.head_dim, self.device
        lens = [layer_cache_len(c, i, max_len, bool(sliding_ring)) for i in range(c.num_hidden_layers)]
        if kv_quant is not None:
            return tuple(init_quantized_kv_cache(1, batch, n, Hkv, D, kv_quant, device=dev)[0] for n in lens)
        kw = dict(dtype=dtype or c.dtype, device=dev)
        return tuple((torch.zeros((batch, n, Hkv, D), **kw), torch.zeros((batch, n, Hkv, D), **kw)) for n in lens)
