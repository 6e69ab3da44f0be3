"""Quantized type descriptors.

PyTorch counterpart of `quanto_tpu/tensor/qtype.py`: a dtype-like descriptor
carrying the name, bit-width, storage dtype and representable range of a
quantization target. Integer qtypes (qint2/qint4/qint8) store int8 (sub-byte
values are bit-packed separately, see `quanto_tpu_torch.tensor.packed`);
float8 qtypes map onto torch's `float8_*` dtypes with the JAX package's
qmin/qmax (the dtype's finite range).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


__all__ = [
    "qtype",
    "qtypes",
    "qint",
    "qfloat",
    "qint2",
    "qint4",
    "qint8",
    "qfloat8",
    "qfloat8_e4m3fn",
    "qfloat8_e4m3fnuz",
    "qfloat8_e5m2",
]


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


def qfloat(dtype: torch.dtype) -> qtype:
    """Float8 qtype stored in a torch `float8_*` dtype; qmin/qmax are the
    dtype's finite range."""
    finfo = torch.finfo(dtype)
    return qtype(
        f"qfloat8_{str(dtype).split('float8_')[-1]}",
        is_floating_point=True,
        bits=8,
        dtype=dtype,
        qmin=float(finfo.min),
        qmax=float(finfo.max),
    )


qint2 = qint(2)
qint4 = qint(4)
qint8 = qint(8)
qfloat8_e4m3fn = qfloat(torch.float8_e4m3fn)
qfloat8_e4m3fnuz = qfloat(torch.float8_e4m3fnuz)
qfloat8_e5m2 = qfloat(torch.float8_e5m2)
qfloat8 = qfloat8_e4m3fn

# Look a qtype up by name; "qfloat8" is the alias of "qfloat8_e4m3fn".
qtypes = {q.name: q for q in (qint2, qint4, qint8, qfloat8_e4m3fn, qfloat8_e4m3fnuz, qfloat8_e5m2)}
qtypes["qfloat8"] = qfloat8
