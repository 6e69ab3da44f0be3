"""Serving helpers: prefill, a greedy decode loop, and `generate`.

Counterpart of `quanto_tpu/models/serve.py`. JAX compiles a prefill program
and a `lax.scan` decode program; PyTorch runs eagerly, so `decode` is a
Python loop of one forward per token (CUDA graphs are for a later slice).
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


def make_cache(model, batch: int, cache_len: int, dtype=None, kv_quant=None):
    """KV cache in the llama-family layout on the model's device: float in
    `dtype` (default the model dtype), or quantized when `kv_quant` is a
    qtype or KV spec name ("qint8", "qint4", "k8v4", "qint4a", ...). It holds
    the kv heads the model's attention runs: under tensor parallelism this
    rank's (`parallel/sharding.py:shard_model`)."""
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


@torch.no_grad()
def decode(model, tok: torch.Tensor, cache, pos0, n_tokens: int):
    """Greedy-decode `n_tokens` from `tok` [B, 1] at position `pos0` (int or
    [B]): one forward per token. Returns (tokens [B, n_tokens], cache)."""
    out = []
    pos = pos0
    for _ in range(n_tokens):
        logits, cache = model(tok, cache, pos)
        tok = greedy(logits[:, -1]).to(tok.dtype)[:, None]
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
