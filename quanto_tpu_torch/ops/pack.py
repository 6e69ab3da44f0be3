"""Sub-byte bit packing / unpacking in quanto's serialized layout.

PyTorch counterpart of `quanto_tpu/ops/pack.py`, byte for byte: int4/int2
values are packed along axis 0 into uint8, where the value at row
`i * row_dim + r` occupies bits `[bits*i, bits*(i+1))` of the byte at row `r`
(`row_dim = ceil(rows / (8 // bits))`).
"""

from __future__ import annotations

from typing import Optional

import torch


__all__ = ["pack_weights", "unpack_weights"]


def pack_weights(intweights: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack int4/int2 values (stored in uint8/int8) into a uint8 tensor along axis 0."""
    if bits not in (2, 4):
        raise ValueError(f"Can only pack 2- or 4-bit values, got {bits}")
    unpacked = intweights.to(torch.uint8)
    original_shape = unpacked.shape
    values_per_item = 8 // bits
    row_dim = (original_shape[0] + values_per_item - 1) // values_per_item
    pad_rows = row_dim * values_per_item - original_shape[0]
    if pad_rows:
        pad = unpacked.new_zeros((pad_rows,) + tuple(original_shape[1:]))
        unpacked = torch.cat([unpacked, pad], dim=0)
    # (values_per_item, row_dim, *rest): plane i holds rows [i*row_dim, (i+1)*row_dim)
    planes = unpacked.reshape(values_per_item, row_dim, *original_shape[1:])
    packed = planes[0].clone()
    for i in range(1, values_per_item):
        packed |= planes[i] << (bits * i)
    return packed


def unpack_weights(packed: torch.Tensor, bits: int, orig_rows: Optional[int] = None) -> torch.Tensor:
    """Unpack a uint8 tensor produced by `pack_weights` back to per-value uint8,
    truncated to `orig_rows` rows when given."""
    if bits not in (2, 4):
        raise ValueError(f"Can only unpack 2- or 4-bit values, got {bits}")
    packed = packed.to(torch.uint8)
    mask = 2**bits - 1
    planes = [(packed >> (bits * i)) & mask for i in range(8 // bits)]
    unpacked = torch.cat(planes, dim=0)
    if orig_rows is not None:
        unpacked = unpacked[:orig_rows]
    return unpacked
