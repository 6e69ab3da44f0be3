"""Token sampling for the decode loops and the serving engine.

Counterpart of `quanto_tpu/models/sampling.py`. A sampler takes
`(logits [..., V], generator)` and returns ids [...]: `generator` is a
`torch.Generator` on the logits' device, where JAX threads a PRNG key. The
two give different random numbers from the same seed, so a stochastic
sampler's draws differ from JAX's; `make_logits_warp`, which decides the
distribution they are drawn from, is deterministic and matches JAX's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


__all__ = ["categorical", "greedy", "make_logits_warp", "make_sampler"]


def greedy(logits: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """argmax over the vocab (logits [..., V] -> ids [...]); `generator` is
    accepted and ignored, so greedy plugs in wherever a sampler does."""
    return torch.argmax(logits, dim=-1)


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw from softmax(logits) per row (logits [..., V] -> ids [...]) by
    the Gumbel-max rule, as `jax.random.categorical` draws:
    argmax(logits + g), g = -log(-log(u)) with u uniform in [0, 1) from
    `generator` (u = 0 gives g = -inf, never +inf or NaN). A logit of -inf
    (a masked token, log(0)) is never drawn."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def make_logits_warp(
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> Callable:
    """Logits filter fn(logits [..., V]) -> float32 logits with temperature
    scaling and top-k / nucleus masking applied (masked entries -> -inf), in
    the JAX package's order and arithmetic (`sampling.py:25-56`).
    `softmax(warp(logits))` is the distribution `make_sampler` draws from.
    temperature must be > 0."""

    def warp(logits: torch.Tensor) -> torch.Tensor:
        logits = logits.float() / temperature
        if top_k is not None:
            kth = torch.sort(logits, dim=-1).values[..., -top_k:][..., :1]
            logits = torch.where(logits < kth, -torch.inf, logits)
        if top_p is not None:
            sorted_logits = torch.sort(logits, dim=-1, descending=True).values
            probs = torch.softmax(sorted_logits, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            # Keep the smallest set of tokens with cumulative prob >= top_p
            # (always keep the first).
            keep = cum - probs < top_p
            cutoff = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
            logits = torch.where(logits < cutoff, -torch.inf, logits)
        return logits

    return warp


def make_sampler(
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> Callable:
    """Categorical sampler with temperature / top-k / nucleus filtering:
    fn(logits [..., V], generator) -> ids [...]. With temperature == 0 it is
    `greedy`. It draws `categorical(warp(logits), generator)`: the Gumbel-max
    rule, as `jax.random.categorical` draws."""
    if temperature == 0.0:
        return greedy

    warp = make_logits_warp(temperature, top_k, top_p)

    def sample(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return categorical(warp(logits), generator)

    return sample
