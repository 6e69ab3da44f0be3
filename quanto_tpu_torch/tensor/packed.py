"""PackedArray: bit-packed sub-byte integer payloads.

PyTorch counterpart of `quanto_tpu/tensor/packed.py`: a uint8 tensor holding
int4/int2 codes packed along axis 0 (quanto's byte layout), with the logical
(unpacked) shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops.pack import pack_weights, unpack_weights


__all__ = ["PackedArray"]


@dataclass(frozen=True, eq=False)
class PackedArray:
    _data: torch.Tensor  # uint8, packed along axis 0
    bits: int
    orig_shape: Tuple[int, ...]

    @classmethod
    def pack(cls, t: torch.Tensor, bits: int = 4) -> "PackedArray":
        if bits not in (2, 4):
            raise ValueError(f"PackedArray supports 2 or 4 bits, got {bits}")
        return cls(_data=pack_weights(t, bits), bits=bits, orig_shape=tuple(t.shape))

    def unpack(self) -> torch.Tensor:
        return unpack_weights(self._data, self.bits, self.orig_shape[0])

    @property
    def packed_data(self) -> torch.Tensor:
        return self._data
