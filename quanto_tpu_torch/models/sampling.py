"""Token sampling for the decode loop (counterpart of
`quanto_tpu/models/sampling.py`; only `greedy` is ported so far)."""

from __future__ import annotations

import torch


__all__ = ["greedy"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab (logits [..., V] -> ids [...])."""
    return torch.argmax(logits, dim=-1)
