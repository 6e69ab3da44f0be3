"""KV caches: float and quantized.

PyTorch counterpart of `quanto_tpu/tensor/kv_cache.py:54-271`. A float layer
cache is a `(k, v)` tuple of [B, S, Hkv, D] tensors in the model dtype; a
quantized one is a `QKVCacheLayer` holding per-slot (b, s, h) symmetric
codes with float32 scales, plus per-slot mean shifts for the asymmetric
"...a" specs (`parse_kv_spec`). Dequantization is `code * scale (+ shift)`.

Storage is JAX's, except for int4:
- int8 codes: int8 [B, S, Hkv, D];
- fp8 codes: `torch.float8_*` [B, S, Hkv, D];
- int4 codes: torch has no int4 dtype, so uint8 [B, S, Hkv, D/2]. Byte j of a
  (b, s, h) row holds code 2j in its low nibble and code 2j + 1 in its high
  nibble, each stored as code + 8 (codes lie in -7..7; a zero code is 0x88).
  Unpacking is a shift and a mask followed by `- 8`, with no sign extension;
- scales and shifts: float32 [B, S, Hkv, 1].

Unlike JAX, which returns updated copies, `kv_update` writes into the cache
tensors IN PLACE and returns the same cache object. `cache_max_len`,
`kv_update`, `slot_view` and `kv_read_raw` also take a paged layer
(`tensor/paged_kv.py:PagedKVLayer`), as JAX's do.

Ring caches (`kv_ring_update`, `ring_key_positions`, `quantize_kv_chunk`;
JAX `kv_cache.py:274-370`) hold a sliding-window layer's last W positions in
W slots, position p at slot p % W; `models/sliding.py` runs attention around
them. `kv_ring_update` writes in place too, so a caller that attends to the
PRE-write ring (JAX's read-concat-write) copies it out first. A chunk longer
than W keeps each row's last W valid columns, where JAX keeps its last W
columns whatever their validity (so pad columns at the end of a long chunk
would push real keys out of JAX's ring).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from .qtype import qint8, qtype, qtypes


__all__ = [
    "QKVCacheLayer",
    "cache_max_len",
    "parse_kv_spec",
    "pack_int4_codes",
    "unpack_int4_codes",
    "init_quantized_kv_cache",
    "kv_update",
    "slot_view",
    "kv_read",
    "kv_read_raw",
    "kv_ring_update",
    "ring_key_positions",
    "quantize_kv_chunk",
]


@dataclasses.dataclass
class QKVCacheLayer:
    """One layer's quantized KV cache (field names as in JAX).

    `qtype_name` is a KV spec (`parse_kv_spec`); the shifts are None for the
    symmetric specs."""

    _k_data: torch.Tensor  # [B, S, H, D] codes (uint8 [B, S, H, D/2] for int4)
    _k_scale: torch.Tensor  # [B, S, H, 1] float32
    _v_data: torch.Tensor
    _v_scale: torch.Tensor
    qtype_name: str
    _k_shift: Optional[torch.Tensor] = None  # [B, S, H, 1] float32 (asymmetric specs)
    _v_shift: Optional[torch.Tensor] = None


def cache_max_len(layer_cache) -> int:
    """Sequence capacity of a layer cache (float tuple, quantized, paged)."""
    from .paged_kv import PagedKVLayer, paged_max_len

    if isinstance(layer_cache, PagedKVLayer):
        return paged_max_len(layer_cache)
    if isinstance(layer_cache, QKVCacheLayer):
        return layer_cache._k_data.shape[1]
    return layer_cache[0].shape[1]


def _is_int4(qt: qtype) -> bool:
    return not qt.is_floating_point and qt.bits == 4


def parse_kv_spec(name: str):
    """KV cache spec -> (k_qtype, v_qtype, asymmetric).

    Accepted: any plain qtype name ("qint8", "qint4", "qfloat8_e4m3fn", ...),
    the mixed pairs "k8v4" (K int8, V int4) and "k4v8", and an "a" suffix for
    per-slot asymmetric (mean-shifted) quantization ("qint4a", "k8v4a")."""
    asym = False
    base = name
    if name.endswith("a") and name not in qtypes:
        asym = True
        base = name[:-1]
    if base == "k8v4":
        return qtypes["qint8"], qtypes["qint4"], asym
    if base == "k4v8":
        return qtypes["qint4"], qtypes["qint8"], asym
    if base not in qtypes:
        raise ValueError(f"unknown KV cache spec {name!r}")
    return qtypes[base], qtypes[base], asym


def pack_int4_codes(codes: torch.Tensor) -> torch.Tensor:
    """int4 codes [..., D] in -7..7 (any integer dtype) -> uint8 [..., D/2]:
    code 2j + 8 in the low nibble of byte j, code 2j + 1 + 8 in its high one."""
    u = (codes.to(torch.int16) + 8).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4_codes(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_int4_codes`: uint8 [..., D/2] -> int8 codes [..., D]."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def _payload_zeros(qt: qtype, shape, device) -> torch.Tensor:
    if _is_int4(qt):
        return torch.full((*shape[:-1], shape[-1] // 2), 0x88, dtype=torch.uint8, device=device)
    return torch.zeros(shape, dtype=qt.dtype, device=device)


def init_quantized_kv_cache(
    n_layers: int,
    batch: int,
    max_len: int,
    n_kv_heads: int,
    head_dim: int,
    qt: Union[qtype, str] = qint8,
    device="cuda",
) -> Tuple[QKVCacheLayer, ...]:
    """Per layer a `QKVCacheLayer` of zero codes, scales one and (asymmetric
    specs) shifts zero, as JAX initializes it. `qt` is a qtype or a KV spec."""
    spec = qt.name if isinstance(qt, qtype) else str(qt)
    k_qt, v_qt, asym = parse_kv_spec(spec)
    shape = (batch, max_len, n_kv_heads, head_dim)
    sshape = (batch, max_len, n_kv_heads, 1)
    if head_dim % 2 and (_is_int4(k_qt) or _is_int4(v_qt)):
        raise ValueError(f"an int4 cache needs an even head_dim, got {head_dim}")

    def ones():
        return torch.ones(sshape, dtype=torch.float32, device=device)

    def zeros():
        return torch.zeros(sshape, dtype=torch.float32, device=device) if asym else None

    return tuple(
        QKVCacheLayer(
            _k_data=_payload_zeros(k_qt, shape, device),
            _k_scale=ones(),
            _v_data=_payload_zeros(v_qt, shape, device),
            _v_scale=ones(),
            qtype_name=spec,
            _k_shift=zeros(),
            _v_shift=zeros(),
        )
        for _ in range(n_layers)
    )


def _quantize_slot(t: torch.Tensor, qt: qtype, asym: bool = False):
    """Per-(batch, pos, head) quantization over the head dim, in float32 and
    in JAX's order: (mean), amax, max(amax / qmax, 1e-8), divide, round half
    to even (integer qtypes), clip (int4 to +/-qmax). Returns (codes in
    storage form, scale, shift or None)."""
    tf = t.float()
    shift = None
    if asym:
        shift = tf.mean(dim=-1, keepdim=True)
        tf = tf - shift
    amax = tf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / qt.qmax, 1e-8)
    data = tf / scale
    if not qt.is_floating_point:
        data = torch.round(data)
    if _is_int4(qt):
        # Symmetric code range: stay off -8 so the range mirrors (+/-7).
        return pack_int4_codes(torch.clamp(data, -qt.qmax, qt.qmax)), scale, shift
    return torch.clamp(data, qt.qmin, qt.qmax).to(qt.dtype), scale, shift


def _scatter_view(cache: torch.Tensor, new: torch.Tensor):
    """(cache, new) to index-write `new` into `cache`: `new` in the cache's
    dtype, float8 tensors as uint8 views of the same bytes."""
    new = new.to(cache.dtype)
    if cache.element_size() == 1 and cache.is_floating_point():
        return cache.view(torch.uint8), new.view(torch.uint8)
    return cache, new


def _update_(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write `new` [B, T, ...] into `cache` [B, S, ...] in place at sequence
    offset `pos`: an int / 0-d tensor (shared) or a [B] tensor (per row)."""
    cache, new = _scatter_view(cache, new)
    B, T = new.shape[0], new.shape[1]
    if not torch.is_tensor(pos) or pos.dim() == 0:
        p = int(pos)
        cache[:, p : p + T] = new
        return
    rows = torch.arange(B, device=cache.device)[:, None]
    cols = pos.reshape(B, 1) + torch.arange(T, device=cache.device)[None, :]
    cache[rows, cols] = new


def kv_update(layer_cache, k: torch.Tensor, v: torch.Tensor, pos):
    """Write new K/V ([B, T, Hkv, D]) at `pos` (scalar or per-row [B]), in
    place; a quantized cache quantizes them per slot first."""
    from .paged_kv import PagedKVLayer, paged_update

    if isinstance(layer_cache, PagedKVLayer):
        return paged_update(layer_cache, k, v, pos)
    if isinstance(layer_cache, QKVCacheLayer):
        k_qt, v_qt, asym = parse_kv_spec(layer_cache.qtype_name)
        kd, ks, km = _quantize_slot(k, k_qt, asym)
        vd, vs, vm = _quantize_slot(v, v_qt, asym)
        _update_(layer_cache._k_data, kd, pos)
        _update_(layer_cache._k_scale, ks, pos)
        _update_(layer_cache._v_data, vd, pos)
        _update_(layer_cache._v_scale, vs, pos)
        if asym:
            _update_(layer_cache._k_shift, km, pos)
            _update_(layer_cache._v_shift, vm, pos)
        return layer_cache
    ck, cv = layer_cache
    _update_(ck, k, pos)
    _update_(cv, v, pos)
    return layer_cache


def slot_view(layer_cache, slot: int):
    """One layer cache restricted to batch row `slot`, as views of the same
    storage: `kv_update` on the view writes into the pooled cache. A paged
    layer keeps its pages and takes a view of table row `slot`."""
    from .paged_kv import PagedKVLayer

    s = slice(slot, slot + 1)
    if isinstance(layer_cache, PagedKVLayer):
        return dataclasses.replace(layer_cache, _table=layer_cache._table[s])
    if isinstance(layer_cache, QKVCacheLayer):
        return dataclasses.replace(layer_cache, **{
            f.name: getattr(layer_cache, f.name)[s]
            for f in dataclasses.fields(layer_cache)
            if torch.is_tensor(getattr(layer_cache, f.name))
        })
    k, v = layer_cache
    return (k[s], v[s])


def _codes(data: torch.Tensor) -> torch.Tensor:
    """Stored codes as a tensor of code values ([B, S, H, D]; int4 unpacked)."""
    return unpack_int4_codes(data) if data.dtype == torch.uint8 else data


def kv_read(layer_cache, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-cache K/V in the compute dtype, dequantized in float32."""
    if isinstance(layer_cache, QKVCacheLayer):
        c = layer_cache
        k = _codes(c._k_data).float() * c._k_scale
        v = _codes(c._v_data).float() * c._v_scale
        if c._k_shift is not None:
            k = k + c._k_shift
            v = v + c._v_shift
        return k.to(dtype), v.to(dtype)
    ck, cv = layer_cache
    return ck.to(dtype), cv.to(dtype)


def kv_read_raw(layer_cache, dtype, batch: Optional[int] = None):
    """(k, v, k_scale, v_scale, k_shift, v_shift): the codes (int4 unpacked)
    as `dtype` without the scale multiply, and the per-slot scales and shifts
    for attention to factor out of its contractions. Scales are None for a
    float cache, shifts None for the symmetric specs. For a paged cache,
    `batch` selects table rows 0..batch-1 (the dense gathered view)."""
    from .paged_kv import PagedKVLayer, paged_read_raw

    if isinstance(layer_cache, PagedKVLayer):
        return paged_read_raw(layer_cache, batch, dtype)
    if isinstance(layer_cache, QKVCacheLayer):
        c = layer_cache
        return (
            _codes(c._k_data).to(dtype),
            _codes(c._v_data).to(dtype),
            c._k_scale,
            c._v_scale,
            c._k_shift,
            c._v_shift,
        )
    ck, cv = layer_cache
    return ck.to(dtype), cv.to(dtype), None, None, None, None


# --- sliding-window ring caches ----------------------------------------------


def _ring_write_(cache: torch.Tensor, new: torch.Tensor, pos, valid: Optional[torch.Tensor] = None) -> None:
    """Write `new` [B, T, ...] into the ring `cache` [B, W, ...] in place,
    column t of row b at slot (pos[b] + t) % W; `pos` an int, a 0-d or a [B]
    tensor. `valid` [B, T] bool (None: all) masks pad and garbage columns:
    their slots keep their content, since (pos + t) % W of a column past the
    row's end would alias a live slot of the window. Of a chunk longer than
    W, each row keeps the valid columns among its last W positions up to its
    last valid column, so a row's slots are distinct and it holds its last W
    real keys (JAX `_ring_write` keeps the chunk's last W columns instead)."""
    W = cache.shape[1]
    B, T = new.shape[0], new.shape[1]
    dev = cache.device
    pos = torch.as_tensor(pos, device=dev).reshape(-1).expand(B)
    n = min(T, W)
    span = torch.arange(n, device=dev)[None, :]
    if valid is None:
        cols = (T - n) + span.expand(B, n)
    else:
        valid = valid.to(dev)
        t = torch.arange(T, device=dev)[None, :]
        last = torch.where(valid, t, -1).amax(dim=1, keepdim=True)  # each row's last valid column
        cols = (last + 1 - n).clamp_min(0) + span
        valid = valid.gather(1, cols)
    slots = (pos[:, None] + cols) % W
    rows = torch.arange(B, device=dev)[:, None]
    cache, new = _scatter_view(cache, new)
    vals = new[rows, cols]
    if valid is not None:
        keep = valid.reshape(B, n, *([1] * (vals.dim() - 2)))
        vals = torch.where(keep, vals, cache[rows, slots])
    cache[rows, slots] = vals


def kv_ring_update(layer_cache, k: torch.Tensor, v: torch.Tensor, pos, valid: Optional[torch.Tensor] = None):
    """Ring analogue of `kv_update` for a W-slot sliding-window cache (float
    tuple or `QKVCacheLayer`), in place: new K/V [B, T, Hkv, D] at slots
    (pos + t) % W, quantized per slot first for a quantized cache. `valid`
    [B, T] masks pad and garbage columns (`_ring_write_`)."""
    if isinstance(layer_cache, QKVCacheLayer):
        k_qt, v_qt, asym = parse_kv_spec(layer_cache.qtype_name)
        kd, ks, km = _quantize_slot(k, k_qt, asym)
        vd, vs, vm = _quantize_slot(v, v_qt, asym)
        pairs = [(layer_cache._k_data, kd), (layer_cache._k_scale, ks), (layer_cache._v_data, vd),
                 (layer_cache._v_scale, vs)]
        if asym:
            pairs += [(layer_cache._k_shift, km), (layer_cache._v_shift, vm)]
        for cache, new in pairs:
            _ring_write_(cache, new, pos, valid)
        return layer_cache
    ck, cv = layer_cache
    _ring_write_(ck, k, pos, valid)
    _ring_write_(cv, v, pos, valid)
    return layer_cache


def ring_key_positions(pos0, W: int, batch: int, device=None) -> torch.Tensor:
    """Absolute positions that the PRE-write ring slots hold: slot j the
    largest position below pos0 congruent to j mod W; negative where never
    written. `pos0` an int, a 0-d or a [B] tensor; returns int64 [B, W]."""
    p = torch.as_tensor(pos0, device=device).reshape(-1, 1).long().expand(batch, 1)
    j = torch.arange(W, device=p.device)[None, :]
    return j + W * torch.div(p - 1 - j, W, rounding_mode="floor")


def quantize_kv_chunk(spec_name: str, k: torch.Tensor, v: torch.Tensor, dtype):
    """A chunk's K/V quantized as a cache of KV spec `spec_name` stores them,
    in `kv_read_raw`'s form: (k codes, v codes as `dtype`, int4 unpacked,
    k_scale, v_scale, k_shift, v_shift), so that a ring layer's in-chunk keys
    carry the cache's numerics beside the ring's."""
    k_qt, v_qt, asym = parse_kv_spec(spec_name)
    kd, ks, km = _quantize_slot(k, k_qt, asym)
    vd, vs, vm = _quantize_slot(v, v_qt, asym)
    return _codes(kd).to(dtype), _codes(vd).to(dtype), ks, vs, km, vm
