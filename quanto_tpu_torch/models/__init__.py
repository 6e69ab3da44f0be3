"""models of quanto_tpu_torch (see the package docstring)."""

from .gemma2 import Gemma2Config, Gemma2ForCausalLM
from .gemma3 import Gemma3ForCausalLM, Gemma3TextConfig
from .gpt_oss import GptOssConfig, GptOssForCausalLM
from .qwen3 import Qwen3Config, Qwen3ForCausalLM, Qwen3MoeConfig, Qwen3MoeForCausalLM
from .serving import BatchedEngine, PagedEngine
from .speculative import (
    SpeculativeGenerator,
    layerskip_draft,
    make_speculative_decode_fn,
    make_speculative_sample_decode_fn,
    speculative_generate,
)


__all__ = [
    "BatchedEngine",
    "Gemma2Config",
    "Gemma2ForCausalLM",
    "Gemma3ForCausalLM",
    "Gemma3TextConfig",
    "GptOssConfig",
    "GptOssForCausalLM",
    "PagedEngine",
    "Qwen3Config",
    "Qwen3ForCausalLM",
    "Qwen3MoeConfig",
    "Qwen3MoeForCausalLM",
    "SpeculativeGenerator",
    "layerskip_draft",
    "make_speculative_decode_fn",
    "make_speculative_sample_decode_fn",
    "speculative_generate",
]
