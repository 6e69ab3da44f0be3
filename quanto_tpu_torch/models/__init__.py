"""models of quanto_tpu_torch (see the package docstring)."""

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
    "PagedEngine",
    "SpeculativeGenerator",
    "layerskip_draft",
    "make_speculative_decode_fn",
    "make_speculative_sample_decode_fn",
    "speculative_generate",
]
