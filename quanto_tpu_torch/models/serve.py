"""Serving helpers: prefill, a decode loop (greedy or sampled), and `generate`.

Counterpart of `quanto_tpu/models/serve.py`. JAX compiles a prefill program
and a `lax.scan` decode program; PyTorch runs eagerly, so `decode` is a
Python loop of one forward per token (CUDA graphs are for a later slice).
Its sampler takes a `torch.Generator` where JAX's takes a PRNG key
(`sampling.py`), so sampled tokens follow JAX's distribution, not its draws.
Under tensor parallelism every rank runs these functions unchanged on its
shards; the logits are gathered on every rank, so each rank's tokens are the
same.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import torch

from .llama import init_kv_cache
from .sampling import greedy


__all__ = ["make_cache", "prefill", "decode", "generate"]


def make_cache(model, batch: int, cache_len: int, dtype=None, kv_quant=None, sliding_ring: bool = True):
    """KV cache for any model family: the model's own `init_kv_cache(batch,
    cache_len, dtype=, kv_quant=)` when it defines one (JAX's
    `serve.py:22-34`), else the llama-family layout on the model's device:
    float in `dtype` (default the model dtype), or quantized when `kv_quant`
    is a qtype or KV spec name ("qint8", "qint4", "k8v4", "qint4a", ...). It
    holds the kv heads the model's attention runs: under tensor parallelism
    this rank's (`parallel/sharding.py:shard_model`). `sliding_ring` goes to
    an `init_kv_cache` that takes it (Gemma-2: W-slot rings for the sliding
    layers past W; False: flat caches)."""
    if hasattr(model, "init_kv_cache"):
        kw = {}
        if "sliding_ring" in inspect.signature(model.init_kv_cache).parameters:
            kw["sliding_ring"] = sliding_ring
        return model.init_kv_cache(batch, cache_len, dtype=dtype, kv_quant=kv_quant, **kw)
    kv_heads = model.model.layers[0].self_attn.num_kv_heads
    config = dataclasses.replace(model.config, num_key_value_heads=kv_heads)
    return init_kv_cache(config, batch, cache_len, dtype=dtype, kv_quant=kv_quant, device=model.device)


@torch.no_grad()
def prefill(model, ids: torch.Tensor, cache, last_only: bool = False):
    """(logits, cache) for the prompt `ids` [B, T] written at cache position 0.

    `last_only`: logits only at the final position ([B, 1, V]) for models
    taking `logits_indices`, skipping the [B, T, V] logits tensor and
    (T-1)/T of the lm_head matmul."""
    if last_only and "logits_indices" in inspect.signature(type(model).forward).parameters:
        return model(ids, cache, 0, logits_indices=ids.shape[1] - 1)
    return model(ids, cache, 0)


def _default_generator(device, pos0) -> torch.Generator:
    """The generator of a sampled `decode` called without one: seeded with the
    sum of the start positions, where JAX folds `PRNGKey(0)` with it
    (`serve.py:74-80`), so chunked calls do not replay the same draws."""
    start = int(pos0.sum()) if torch.is_tensor(pos0) else int(pos0)
    return torch.Generator(device=device).manual_seed(start)


@torch.no_grad()
def decode(model, tok: torch.Tensor, cache, pos0, n_tokens: int, sample_fn=None, generator=None):
    """Decode `n_tokens` from `tok` [B, 1] at position `pos0` (int or [B]):
    one forward per token, each next token `sample_fn(logits [B, V],
    generator)` (`sampling.py`; greedy by default). A sampler given no
    `generator` draws from one on the logits' device seeded by the sum of
    `pos0` (`_default_generator`). Returns (tokens [B, n_tokens], cache)."""
    sampler = sample_fn or greedy
    if generator is None and sampler is not greedy:
        generator = _default_generator(tok.device, pos0)
    out = []
    pos = pos0
    for _ in range(n_tokens):
        logits, cache = model(tok, cache, pos)
        tok = sampler(logits[:, -1], generator).to(tok.dtype)[:, None]
        out.append(tok)
        pos = pos + 1
    if not out:
        return tok.new_empty((tok.shape[0], 0)), cache
    return torch.cat(out, dim=1), cache


def generate(model, input_ids: torch.Tensor, max_new_tokens: int, cache_len: Optional[int] = None):
    """Greedy generation: prefill (last position only), then decode.
    Returns [B, T + max_new_tokens] token ids."""
    B, T = input_ids.shape
    cache = make_cache(model, B, cache_len or (T + max_new_tokens))
    logits, cache = prefill(model, input_ids, cache, last_only=True)
    first = greedy(logits[:, -1]).to(input_ids.dtype)[:, None]
    rest, cache = decode(model, first, cache, T, max_new_tokens - 1)
    return torch.cat([input_ids, first, rest], dim=1)
