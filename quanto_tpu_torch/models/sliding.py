"""Sliding-window ring caches: the model-side plumbing that alternating-attention
families share (Gemma-2: window 4096 on every other layer).

Counterpart of `quanto_tpu/models/sliding.py`. A sliding layer attends to the
last W positions only, so its ring cache holds W slots (position p at slot
p % W, `tensor/kv_cache.py:kv_ring_update`) instead of max_len:

- `use_ring(config, cache)`: whether the sliding layers' caches are rings;
- `layer_cache_len(config, i, max_len, sliding_ring)`: layer i's capacity;
- `flat_masks(positions, slots, w)`: the causal and windowed masks over flat
  caches (or none), which Qwen3's sliding tails use alone;
- `ring_mask(positions, q_pos, cache_pos, w, B, neg)`: the [B, 1, T, W + T]
  mask over [pre-write ring | chunk] keys by their absolute positions;
- `write_valid_mask(write_len, T)`: the real columns of an engine's padded chunk;
- `ring_attention_inputs(...)`: read-concat-write around a chunk's attention.

The port writes caches in place, where JAX returns new ones, so
`ring_attention_inputs` copies the pre-write ring out (the concatenation)
before it writes the chunk. A decode step (T == 1) takes another route
(`ops/attention.py:decode_attention`): after its write the ring holds
exactly the keys that JAX's mask lets the step see, so `flash_decode` reads
the post-write ring.
"""

from __future__ import annotations

import torch

from ..tensor.kv_cache import (
    QKVCacheLayer,
    cache_max_len,
    kv_read_raw,
    kv_ring_update,
    quantize_kv_chunk,
    ring_key_positions,
)
from ..tensor.paged_kv import PagedKVLayer


__all__ = ["use_ring", "layer_cache_len", "flat_masks", "ring_mask", "write_valid_mask", "ring_attention_inputs"]


def use_ring(config, cache) -> bool:
    """True when the sliding layers' caches hold exactly W slots, the layout
    `init_kv_cache(sliding_ring=True)` builds past W (and the dense rings of
    `PagedEngine`'s hybrid). A flat cache of W slots is a ring too, which is
    the more correct reading. Paged sliding layers never ring."""
    w = getattr(config, "sliding_window", None)
    if cache is None or w is None:
        return False
    sliding = [i for i, t in enumerate(config.layer_types) if t == "sliding_attention"]
    if not sliding or isinstance(cache[sliding[0]], PagedKVLayer):
        return False
    return cache_max_len(cache[sliding[0]]) == w


def layer_cache_len(config, i: int, max_len: int, sliding_ring: bool) -> int:
    """Capacity of layer i's cache: W for a sliding layer's ring, max_len
    otherwise; rings only where max_len passes W."""
    w = getattr(config, "sliding_window", None)
    if sliding_ring and w is not None and max_len > w and config.layer_types[i] == "sliding_attention":
        return w
    return max_len


def flat_masks(positions: torch.Tensor, slots, w):
    """(full, sliding) additive float32 masks of a T > 1 step over flat
    caches: causal, and causal within the window (q - w < k <= q, the
    current token included; None when `w` is None). With no cache (`slots`
    None) [1, 1, T, T] from position 0; over `slots` slots [B, 1, T, slots]
    at `positions` [B, T] (JAX `gemma2.py:244-275`, `qwen3.py:262-274`)."""
    T, dev = positions.shape[1], positions.device
    neg = torch.finfo(torch.float32).min
    if slots is None:
        q_pos = torch.arange(T, device=dev)[None, None, :, None]
        k_pos = torch.arange(T, device=dev)[None, None, None, :]
    else:
        q_pos = positions[:, None, :, None]
        k_pos = torch.arange(slots, device=dev)[None, None, None, :]
    causal = k_pos <= q_pos
    full = torch.where(causal, 0.0, neg)
    return full, None if w is None else torch.where(causal & (k_pos > q_pos - w), 0.0, neg)


def ring_mask(positions: torch.Tensor, q_pos: torch.Tensor, cache_pos, w: int, B: int, neg: float) -> torch.Tensor:
    """Additive float32 mask [B, 1, T, W + T] over the pre-write ring's W
    slots and the chunk's T keys, by absolute position (never-written slots
    are negative): key a is visible to query q iff 0 <= a <= q and a > q - w.
    `positions` [B, T] are the chunk's positions, `q_pos` [B, 1, T, 1]."""
    k_abs = torch.cat([ring_key_positions(cache_pos, w, B, positions.device), positions], dim=1)
    ka = k_abs[:, None, None, :]
    ok = (ka >= 0) & (ka <= q_pos) & (ka > q_pos - w)
    return torch.where(ok, 0.0, neg)


def write_valid_mask(write_len, T: int, device=None):
    """[B, T] bool: column t of row b is real iff t < write_len[b] (None: None)."""
    if write_len is None:
        return None
    wl = torch.as_tensor(write_len, device=device).reshape(-1, 1)
    return torch.arange(T, device=wl.device)[None, :] < wl


def ring_attention_inputs(layer_cache, k: torch.Tensor, v: torch.Tensor, cache_pos, write_valid, dtype, B: int):
    """Read-concat-write for a ring layer's chunk (T > 1): (k, v, k_scale,
    v_scale, k_shift, v_shift) of the PRE-write ring concatenated with the
    chunk's own K/V (quantized as the cache stores them, so in-chunk keys
    carry the cache's numerics), [B, W + T, ...] in `kv_read_raw`'s form; then
    the chunk is written into the ring in place (`write_valid` masking pad
    columns). The concatenation copies the ring, so the write cannot reach
    what attention reads."""
    rk, rv, rks, rvs, rkm, rvm = kv_read_raw(layer_cache, dtype, B)
    if isinstance(layer_cache, QKVCacheLayer):
        ck, cv, cks, cvs, ckm, cvm = quantize_kv_chunk(layer_cache.qtype_name, k, v, dtype)
    else:
        ck, cv = k.to(rk.dtype), v.to(rv.dtype)
        cks = cvs = ckm = cvm = None

    def cat(a, b):
        return None if a is None else torch.cat([a, b], dim=1)

    out = (cat(rk, ck), cat(rv, cv), cat(rks, cks), cat(rvs, cvs), cat(rkm, ckm), cat(rvm, cvm))
    kv_ring_update(layer_cache, k, v, cache_pos, valid=write_valid)
    return out
