"""Quantized weights.

PyTorch counterpart of `quanto_tpu/tensor/weights.py`:
- `WeightQBytesArray` (`weights.py:45-110`): 8-bit (int8 or float8)
  symmetric weights, per-tensor or per-axis. `_data` [N, K] row-major is
  already K-contiguous, the layout the Hopper kernels of
  `ops/cuda/qbytes_mm.py` read, so it needs no kernel layout of its own.
- `WeightQBitsArray` (`weights.py:113-189`): int2/int4 affine weights with
  scale + shift, optionally group-wise, payload bit-packed in quanto's
  generic grouped layout (the serialized, kernel-agnostic form).
- `WeightQBitsHopperArray`: the device layout that the Hopper kernels of
  `ops/cuda/qbits_mm.py` read, the counterpart of `WeightQBitsTpuArray`
  (`weights.py:193-525`).

Hopper layout. `_packed` is uint8 [N, K/2] with K-contiguous nibbles: byte j
of row n holds code (n, 2j) in its low nibble and code (n, 2j + 1) in its high
nibble, so one 16-byte load holds 32 consecutive K codes of one row. The bytes
are unsigned, so unpacking needs no sign-extension care (the w16 fault of the
TPU layout, `ops/pallas/qbits_mm.py:166-177`). `_scale_t`/`_shift_t` are
float32 [G, N] (transposed, as on the TPU) with float-shift semantics
`deq = scale * code - shift`; integer zero-points become float shifts
`scale * zp` (as `weights.py:313-317`). The envelope is int4 with the TPU
layout's shape rule (`eligible`); off-envelope weights stay in the generic
layout, as JAX's `from_generic` returns None for shapes it cannot pad.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops.cuda.qbits_mm import dequantize_k_nibbles, pack_k_nibbles, unpack_k_nibbles
from ..ops.quantize import dequantize_affine, dequantize_symmetric, quantize_affine, quantize_symmetric
from .grouped import group, ungroup
from .packed import PackedArray
from .qarray import QArray
from .qtype import qtype


__all__ = ["WeightQBytesArray", "WeightQBitsArray", "WeightQBitsHopperArray", "quantize_weight"]


@dataclass(frozen=True, eq=False)
class WeightQBytesArray(QArray):
    """8-bit symmetric weights: int8 or float8 `_data` with a per-tensor
    (0-d) or per-axis (keepdim, e.g. [N, 1]) `_scale` in the base dtype."""

    _data: torch.Tensor
    _scale: torch.Tensor
    qtype: qtype
    axis: Optional[int]
    float_dtype: torch.dtype
    activation_qtype: Optional[qtype] = None

    @classmethod
    def quantize(
        cls,
        base: torch.Tensor,
        qt: qtype,
        axis: Optional[int],
        scale: torch.Tensor,
        activation_qtype: Optional[qtype] = None,
    ) -> "WeightQBytesArray":
        return cls(
            _data=quantize_symmetric(base, qt, axis, scale),
            _scale=scale,
            qtype=qt,
            axis=axis,
            float_dtype=base.dtype,
            activation_qtype=activation_qtype,
        )

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.float_dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    def dequantize(self) -> torch.Tensor:
        return dequantize_symmetric(self._data, self._scale, self.float_dtype)


@dataclass(frozen=True, eq=False)
class WeightQBitsArray(QArray):
    """Sub-byte (int2/int4) affine weights in quanto's generic grouped layout.

    `_data` is a `PackedArray` of unsigned codes in grouped layout; `_scale`
    and `_shift` broadcast against the grouped shape. A float `_shift` is a
    pre-scale offset; an integer `_shift` is a zero-point.
    """

    _data: PackedArray
    _scale: torch.Tensor
    _shift: torch.Tensor
    qtype: qtype
    axis: int
    group_size: Optional[int]
    orig_shape: Tuple[int, ...]
    float_dtype: torch.dtype

    @classmethod
    def quantize(
        cls,
        base: torch.Tensor,
        qt: qtype,
        axis: int,
        group_size: Optional[int],
        scale: torch.Tensor,
        shift: torch.Tensor,
    ) -> "WeightQBitsArray":
        data = quantize_affine(base, qt.bits, axis, group_size, scale, shift)
        return cls(
            _data=PackedArray.pack(data, qt.bits),
            _scale=scale,
            _shift=shift,
            qtype=qt,
            axis=axis,
            group_size=group_size,
            orig_shape=tuple(base.shape),
            float_dtype=base.dtype,
        )

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.orig_shape

    @property
    def dtype(self) -> torch.dtype:
        return self.float_dtype

    @property
    def device(self) -> torch.device:
        return self._data.packed_data.device

    def dequantize(self) -> torch.Tensor:
        codes = self._data.unpack()
        grouped = dequantize_affine(codes, self._scale, self._shift, torch.float32)
        return ungroup(grouped, self.axis, self.orig_shape).to(self.float_dtype)


@dataclass(frozen=True, eq=False)
class WeightQBitsHopperArray(QArray):
    """int4 weights in the layout of the Hopper kernels (module docstring)."""

    _packed: torch.Tensor  # uint8 [N, K/2]
    _scale_t: torch.Tensor  # float32 [G, N]
    _shift_t: torch.Tensor  # float32 [G, N]
    qtype: qtype
    group_size: Optional[int]
    orig_shape: Tuple[int, ...]
    float_dtype: torch.dtype

    @staticmethod
    def eligible(orig_shape: Tuple[int, ...], bits: int, group_size: Optional[int]) -> bool:
        """Kernel-layout constraints: the TPU layout's rule for one K block
        (`quanto_tpu/tensor/weights.py:231-251`), int4 only."""
        if len(orig_shape) != 2 or bits != 4:
            return False
        N, K = orig_shape
        kp = K // 2
        if K % 2 or N % 128 != 0 or kp % 128 != 0:
            return False
        gs = group_size if group_size is not None else K
        if gs == K:
            return True
        return gs % 128 == 0 and kp % gs == 0

    @classmethod
    def from_generic(cls, w: WeightQBitsArray) -> Optional["WeightQBitsHopperArray"]:
        """Repack a generic weight, or None when it is off the envelope."""
        if w.axis != 0 or not cls.eligible(w.orig_shape, w.qtype.bits, w.group_size):
            return None
        N, K = w.orig_shape
        G = K // (w.group_size if w.group_size is not None else K)
        codes = ungroup(w._data.unpack(), w.axis, w.orig_shape)
        scale = w._scale.float().reshape(N, G)
        if w._shift.is_floating_point():
            shift = w._shift.float().reshape(N, G)
        else:
            # Integer zero-point: deq = scale*(code - zp) = scale*code - scale*zp.
            shift = scale * w._shift.float().reshape(N, G)
        return cls(
            _packed=pack_k_nibbles(codes),
            _scale_t=scale.t().contiguous(),
            _shift_t=shift.t().contiguous(),
            qtype=w.qtype,
            group_size=w.group_size,
            orig_shape=tuple(w.orig_shape),
            float_dtype=w.float_dtype,
        )

    def to_generic(self) -> WeightQBitsArray:
        """Back to the serialized generic layout (float shifts)."""
        gs = self.group_size
        codes = unpack_k_nibbles(self._packed)
        scale, shift = self._scale_t.t(), self._shift_t.t()
        if gs is not None:
            codes = group(codes, 0, gs)
            scale, shift = scale.reshape(-1, 1), shift.reshape(-1, 1)
        return WeightQBitsArray(
            _data=PackedArray.pack(codes, self.qtype.bits),
            _scale=scale.to(self.float_dtype).contiguous(),
            _shift=shift.to(self.float_dtype).contiguous(),
            qtype=self.qtype,
            axis=0,
            group_size=gs,
            orig_shape=self.orig_shape,
            float_dtype=self.float_dtype,
        )

    @property
    def kernel_group_size(self) -> int:
        return self.group_size if self.group_size is not None else self.orig_shape[1]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.orig_shape

    @property
    def dtype(self) -> torch.dtype:
        return self.float_dtype

    @property
    def device(self) -> torch.device:
        return self._packed.device

    def dequantize(self) -> torch.Tensor:
        w = dequantize_k_nibbles(self._packed, self._scale_t, self._shift_t, self.kernel_group_size)
        return w.to(self.float_dtype)


def quantize_weight(
    t: torch.Tensor,
    qt: qtype,
    axis: int,
    scale: torch.Tensor,
    shift: Optional[torch.Tensor] = None,
    group_size: Optional[int] = None,
    activation_qtype: Optional[qtype] = None,
):
    """Quantize a weight tensor (`quanto_tpu/tensor/weights.py:528-555`):
    8-bit qtypes forbid shift and group size and collapse a size-1 axis to
    per-tensor; sub-byte qtypes require a shift."""
    if axis not in (0, -1):
        raise ValueError("axis parameter must be 0 (first axis) or -1 (last axis)")
    if qt.bits == 8:
        if shift is not None:
            raise ValueError("shift cannot be specified for 8-bit qtypes")
        if group_size is not None:
            raise ValueError("group_size cannot be specified for 8-bit qtypes.")
        q_axis = None if t.shape[axis] == 1 else axis
        return WeightQBytesArray.quantize(t, qt, q_axis, scale, activation_qtype)
    if shift is None:
        raise ValueError("shift must be specified for qtypes lower than 8-bit")
    return WeightQBitsArray.quantize(t, qt, axis, group_size, scale, shift)
