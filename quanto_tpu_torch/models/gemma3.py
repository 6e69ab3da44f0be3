"""Gemma-3 (text) causal LM in PyTorch.

Counterpart of `quanto_tpu/models/gemma3.py`: Gemma-2 (`models/gemma2.py`)
with three changes (Hugging Face `modeling_gemma3.py`):

- QK-norm in place of the softcaps: unit-offset RMSNorms on the [B, T, H, D]
  query and key heads before rope; no attention or final logit softcap;
- a dual rope: the sliding layers use `rope_local_base_freq`, never scaled;
  the full layers use `rope_theta` at `positions / factor` under a linear
  `rope_scaling`, the division in float32 as JAX computes it (`:247-253`);
- the 5:1 pattern: layer i slides unless (i + 1) % `sliding_window_pattern`
  == 0, so the first full layer is layer 5.

The decoder layer's four norms, the MLP, the embedding normalizer, the tied
head, the ring caches (`init_kv_cache(sliding_ring=True)` past W), the masks
(the full one sized from the first full layer) and the routes of attention
are Gemma-2's, reused by subclassing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch

from .gemma2 import SLIDING, Gemma2Attention, Gemma2DecoderLayer, Gemma2ForCausalLM
from .llama import _rope, rope_params


__all__ = ["Gemma3TextConfig", "Gemma3ForCausalLM"]


@dataclasses.dataclass(frozen=True)
class Gemma3TextConfig:
    vocab_size: int = 262208
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_hidden_layers: int = 26
    num_attention_heads: int = 8
    num_key_value_heads: int = 4
    head_dim: int = 256
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    rope_local_base_freq: float = 10_000.0
    rope_scaling_factor: Optional[float] = None  # linear scaling of the full layers' rope
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 4096
    sliding_window_pattern: int = 6
    layer_types: Optional[Tuple[str, ...]] = None
    attention_bias: bool = False
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.float32

    # Read by the Gemma-2 and Llama modules: unit-offset norms (also on q and k), no softcaps.
    rms_norm_unit_offset = True
    attn_logit_softcapping = None
    final_logit_softcapping = None

    def __post_init__(self):
        if self.layer_types is None:
            object.__setattr__(self, "layer_types", tuple(
                SLIDING if (i + 1) % self.sliding_window_pattern else "full_attention"
                for i in range(self.num_hidden_layers)))
        else:
            object.__setattr__(self, "layer_types", tuple(self.layer_types))

    @classmethod
    def from_hf(cls, hf: Mapping[str, Any], dtype=torch.bfloat16) -> "Gemma3TextConfig":
        """From the plain dict of a Hugging Face gemma3_text `config.json` (or
        a gemma3 config's `text_config`), a missing key taking Hugging Face's
        `Gemma3TextConfig` default, as JAX's `from_hf` reads the object
        (`gemma3.py:69-92`). A linear `rope_scaling` gives the factor; the port
        refuses another type, which JAX ignores."""
        d = {f.name: f.default for f in dataclasses.fields(cls)}
        get = lambda k: hf.get(k, d[k])  # noqa: E731
        rs = hf.get("rope_scaling") or {}
        rope_type = rs.get("rope_type", rs.get("type"))
        if rs and rope_type != "linear":
            raise NotImplementedError(f"Gemma-3 rope_scaling type {rope_type!r}: only linear is supported")
        return cls(
            **{k: get(k) for k in (
                "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                "num_key_value_heads", "head_dim", "max_position_embeddings", "rms_norm_eps", "rope_theta",
                "rope_local_base_freq", "query_pre_attn_scalar", "sliding_window", "attention_bias",
                "tie_word_embeddings")},
            rope_scaling_factor=rs.get("factor") if rs else None,
            sliding_window_pattern=hf.get("_sliding_window_pattern", hf.get("sliding_window_pattern", 6)),
            layer_types=tuple(hf["layer_types"]) if hf.get("layer_types") else None,
            dtype=dtype,
        )

    def to_hf(self) -> dict:
        """This configuration as a gemma3_text `config.json` dict, plain JSON
        that `transformers.AutoConfig` reads and `from_hf` inverts."""
        factor = self.rope_scaling_factor
        return {
            "architectures": ["Gemma3ForCausalLM"],
            "model_type": "gemma3_text",
            **{f.name: getattr(self, f.name) for f in dataclasses.fields(self)
               if f.name not in ("rope_scaling_factor", "layer_types", "dtype")},
            "rope_scaling": {"rope_type": "linear", "factor": factor} if factor else None,
            "layer_types": list(self.layer_types),
            "hidden_activation": "gelu_pytorch_tanh",
            "attn_logit_softcapping": None,
            "final_logit_softcapping": None,
            "torch_dtype": str(self.dtype).removeprefix("torch."),
        }


class Gemma3Attention(Gemma2Attention):
    """Gemma-2's attention with unit-offset q/k norms and no softcap (JAX `gemma3.py:97-161`)."""

    qk_norm = True


class Gemma3DecoderLayer(Gemma2DecoderLayer):
    attn_cls = Gemma3Attention


class Gemma3ForCausalLM(Gemma2ForCausalLM):
    """Gemma-3 (text) with the `(logits, cache)` decode API of the other
    families; built as Gemma-2 builds, with a second rotary table."""

    layer_cls = Gemma3DecoderLayer

    def __init__(self, config: Gemma3TextConfig, device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__(config, device="meta")
        # The sliding layers' inverse frequencies (`inv_freq` holds the full layers').
        self.register_buffer("inv_freq_local", torch.empty(config.head_dim // 2, device="meta"), persistent=False)
        if torch.device(device).type != "meta":
            self.materialize_(device, generator or torch.Generator(device=device).manual_seed(0))

    def init_rope_(self, device) -> None:
        c = self.config
        self.inv_freq = rope_params(c.head_dim, c.rope_theta)[0].to(device)
        self.inv_freq_local = rope_params(c.head_dim, c.rope_local_base_freq)[0].to(device)
        self.attn_scale = 1.0

    def _ropes(self, positions: torch.Tensor, dtype):
        factor = self.config.rope_scaling_factor
        gpos = positions.float() / factor if factor else positions
        return _rope(gpos, self.inv_freq, dtype), _rope(positions, self.inv_freq_local, dtype)
