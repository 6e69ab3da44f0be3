"""Quantized type descriptors.

PyTorch counterpart of `quanto_tpu/tensor/qtype.py`: a dtype-like descriptor
carrying the name, bit-width, storage dtype and representable range of an
integer quantization target. Sub-byte values are bit-packed separately (see
`quanto_tpu_torch.tensor.packed`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


__all__ = ["qtype", "qtypes", "qint", "qint2", "qint4", "qint8"]


@dataclass(frozen=True)
class qtype:
    """A quantized type descriptor mimicking a torch dtype."""

    name: str
    is_floating_point: bool
    bits: int
    # The dtype used to store (unpacked) quantized values.
    dtype: torch.dtype
    qmin: float
    qmax: float


def qint(bits: int) -> qtype:
    """Signed integer qtype of the given bit-width (storage: int8)."""
    qmin = -(2 ** (bits - 1))
    qmax = 2 ** (bits - 1) - 1
    return qtype(
        f"qint{bits}", is_floating_point=False, bits=bits, dtype=torch.int8, qmin=qmin, qmax=qmax
    )


qint2 = qint(2)
qint4 = qint(4)
qint8 = qint(8)

# Look a qtype up by name.
qtypes = {q.name: q for q in (qint2, qint4, qint8)}
