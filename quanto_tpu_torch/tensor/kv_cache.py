"""Float KV cache helpers.

PyTorch counterpart of the float subset of `quanto_tpu/tensor/kv_cache.py`
(`cache_max_len`, `kv_update` at `:183-224`, `kv_read_raw`). A layer cache is
a `(k, v)` tuple of [B, S, Hkv, D] tensors. Quantized caches wait for a later
slice.

Unlike JAX, which returns updated copies, `kv_update` writes into the cache
tensors IN PLACE and returns the same tuple.
"""

from __future__ import annotations

from typing import Tuple

import torch


__all__ = ["cache_max_len", "kv_update", "kv_read_raw"]


def cache_max_len(layer_cache) -> int:
    """Sequence capacity of a layer cache."""
    return layer_cache[0].shape[1]


def _update_(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write `new` [B, T, ...] into `cache` [B, S, ...] in place at sequence
    offset `pos`: an int / 0-d tensor (shared) or a [B] tensor (per row)."""
    B, T = new.shape[0], new.shape[1]
    if not torch.is_tensor(pos) or pos.dim() == 0:
        p = int(pos)
        cache[:, p : p + T] = new.to(cache.dtype)
        return
    rows = torch.arange(B, device=cache.device)[:, None]
    cols = pos.reshape(B, 1) + torch.arange(T, device=cache.device)[None, :]
    cache[rows, cols] = new.to(cache.dtype)


def kv_update(layer_cache, k: torch.Tensor, v: torch.Tensor, pos):
    """Write new K/V ([B, T, Hkv, D]) at `pos` (scalar or per-row [B]), in place."""
    ck, cv = layer_cache
    _update_(ck, k, pos)
    _update_(cv, v, pos)
    return layer_cache


def kv_read_raw(layer_cache, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-cache (k, v) in the compute dtype."""
    ck, cv = layer_cache
    return ck.to(dtype), cv.to(dtype)
