"""Paged KV cache: a pool of fixed-size pages and per-slot page tables.

PyTorch counterpart of `quanto_tpu/tensor/paged_kv.py:43-191`. A layer holds
pages `[n_pages, page_size, Hkv, D]` and an int32 table `[max_slots,
pages_per_slot]`: slot position s of table row b lies at offset s % page_size
of page table[b, s // page_size]. A slot uses only the pages its sequence
reached, so the pool's `n_pages * page_size` tokens are shared by all slots
instead of reserving `max_slots * max_len`. Page 0 is scratch: table entries
that are 0 scatter there harmlessly.

Storage is `tensor/kv_cache.py`'s: float pages in the model dtype; int8 and
float8 codes as they are; int4 codes as uint8 nibbles `[..., D/2]` (code + 8);
float32 scale and shift pages `[n_pages, page_size, Hkv, 1]`. A float cache has
no scale pages (None), where JAX keeps a dummy [1, 1, 1, 1] of ones.

Differences by design:
- All layers share one table tensor (JAX copies it into each layer's pytree),
  so one host-to-device copy updates every layer. `PagedEngine` owns it.
- `paged_update` scatters in place, as `kv_update` does, and returns the same
  layer; page ids are computed on the device from the table.
- Decode attention reads the pages through the table inside the kernel
  (`ops/cuda/flash_decode.py:flash_decode_paged`), where JAX gathers a dense
  view first. `paged_read_raw` still gives that gathered view, for prefill's
  `gqa_attention` and for the kernel's plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .kv_cache import _codes, _payload_zeros, _quantize_slot, _scatter_view, parse_kv_spec
from .qtype import qtype


__all__ = [
    "PagedKVLayer",
    "init_paged_kv_cache",
    "paged_max_len",
    "paged_update",
    "gather_pages",
    "paged_gather",
    "paged_read_raw",
]


@dataclasses.dataclass
class PagedKVLayer:
    """One layer's paged KV storage (field names as in JAX)."""

    _k_pages: torch.Tensor  # [n_pages, ps, H, D] (uint8 [.., D/2] for int4)
    _v_pages: torch.Tensor
    _k_scale: Optional[torch.Tensor]  # [n_pages, ps, H, 1] float32, None for a float cache
    _v_scale: Optional[torch.Tensor]
    _table: torch.Tensor  # int32 [slots, pages_per_slot], shared by the layers
    qtype_name: Optional[str]  # KV spec (`parse_kv_spec`), None for a float cache
    _k_shift: Optional[torch.Tensor] = None  # asymmetric specs only
    _v_shift: Optional[torch.Tensor] = None


def init_paged_kv_cache(
    n_layers: int,
    n_pages: int,
    page_size: int,
    max_slots: int,
    pages_per_slot: int,
    n_kv_heads: int,
    head_dim: int,
    kv_quant=None,
    dtype=torch.bfloat16,
    device="cuda",
) -> Tuple[PagedKVLayer, ...]:
    """Per layer a `PagedKVLayer` of zero pages (scales one, shifts zero), all
    sharing one zero table, as JAX initializes them. `kv_quant`: None (float
    pages in `dtype`), a qtype or a KV spec."""
    spec = None
    k_qt = v_qt = None
    asym = False
    if kv_quant is not None:
        spec = kv_quant.name if isinstance(kv_quant, qtype) else str(kv_quant)
        k_qt, v_qt, asym = parse_kv_spec(spec)
    shape = (n_pages, page_size, n_kv_heads, head_dim)
    sshape = (n_pages, page_size, n_kv_heads, 1)
    if spec is not None and head_dim % 2 and any(q.bits == 4 and not q.is_floating_point for q in (k_qt, v_qt)):
        raise ValueError(f"an int4 cache needs an even head_dim, got {head_dim}")
    table = torch.zeros((max_slots, pages_per_slot), dtype=torch.int32, device=device)

    def pages(q):
        return torch.zeros(shape, dtype=dtype, device=device) if q is None else _payload_zeros(q, shape, device)

    def factor(value, on: bool):
        return torch.full(sshape, value, dtype=torch.float32, device=device) if on else None

    return tuple(
        PagedKVLayer(
            _k_pages=pages(k_qt),
            _v_pages=pages(v_qt),
            _k_scale=factor(1.0, spec is not None),
            _v_scale=factor(1.0, spec is not None),
            _table=table,
            qtype_name=spec,
            _k_shift=factor(0.0, asym),
            _v_shift=factor(0.0, asym),
        )
        for _ in range(n_layers)
    )


def paged_max_len(layer: PagedKVLayer) -> int:
    return layer._table.shape[1] * layer._k_pages.shape[1]


def paged_update(layer: PagedKVLayer, k: torch.Tensor, v: torch.Tensor, pos) -> PagedKVLayer:
    """Write new K/V [B, T, Hkv, D] at sequence offsets `pos` (an int, a 0-d
    or a [B] tensor) through table rows 0..B-1, in place; a quantized cache
    quantizes them per slot first, as `kv_update` does."""
    B, T = k.shape[0], k.shape[1]
    ps = layer._k_pages.shape[1]
    dev = layer._k_pages.device
    pos = torch.as_tensor(pos, device=dev).reshape(-1).expand(B)
    positions = pos[:, None] + torch.arange(T, device=dev)[None, :]  # [B, T]
    page_ids = layer._table[torch.arange(B, device=dev)[:, None], positions // ps].long()
    offsets = positions % ps

    def scatter(pages: torch.Tensor, values: torch.Tensor) -> None:
        pages, values = _scatter_view(pages, values)
        pages[page_ids, offsets] = values

    if layer.qtype_name is None:
        scatter(layer._k_pages, k)
        scatter(layer._v_pages, v)
        return layer
    k_qt, v_qt, asym = parse_kv_spec(layer.qtype_name)
    kd, ks, km = _quantize_slot(k, k_qt, asym)
    vd, vs, vm = _quantize_slot(v, v_qt, asym)
    scatter(layer._k_pages, kd)
    scatter(layer._v_pages, vd)
    scatter(layer._k_scale, ks)
    scatter(layer._v_scale, vs)
    if asym:
        scatter(layer._k_shift, km)
        scatter(layer._v_shift, vm)
    return layer


def gather_pages(pages: Optional[torch.Tensor], table: torch.Tensor) -> Optional[torch.Tensor]:
    """pages [n_pages, ps, ...] through table [B, P] -> the dense [B, P * ps, ...]
    (None stays None)."""
    if pages is None:
        return None
    B, P = table.shape
    return pages[table.long()].reshape(B, P * pages.shape[1], *pages.shape[2:])


def paged_gather(layer: PagedKVLayer, batch: int):
    """The dense view of table rows 0..batch-1 in storage form: (k, v,
    k_scale, v_scale, k_shift, v_shift), each [batch, P * page_size, ...],
    gathered through the table (None where the layer has no such pages)."""
    table = layer._table[:batch]
    return tuple(
        gather_pages(t, table)
        for t in (layer._k_pages, layer._v_pages, layer._k_scale, layer._v_scale, layer._k_shift, layer._v_shift)
    )


def paged_read_raw(layer: PagedKVLayer, batch: int, dtype):
    """(k, v, k_scale, v_scale, k_shift, v_shift) for slots 0..batch-1, as
    `kv_read_raw` gives them for a dense cache: the gathered codes (int4
    unpacked) as `dtype`, the scales and shifts as stored (None for a float
    cache, shifts None for the symmetric specs)."""
    k, v, ks, vs, km, vm = paged_gather(layer, batch)
    return _codes(k).to(dtype), _codes(v).to(dtype), ks, vs, km, vm
