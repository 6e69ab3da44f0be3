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
- `WeightQBitsRequantArray`: a Hopper-layout weight that also carries the
  per-channel int8 step of the W4A8 requant route. The JAX package opts into
  that route with a global switch (`set_backend(w4a8_requant_dot=True)`);
  the port has no switches, so the choice is this weight type, made by
  `freeze(model, w4a8_requant_dot=True)`.

Hopper layout. `_packed` is uint8 [N, K * bits / 8] with K-contiguous codes.
int4: byte j of row n holds code (n, 2j) in its low nibble and code
(n, 2j + 1) in its high nibble, so one 16-byte load holds 32 consecutive K
codes of one row. int2: byte j holds codes (n, 4j) .. (n, 4j + 3) in bits
0-1, 2-3, 4-5 and 6-7, so one 16-byte load holds 64 codes. The bytes are
unsigned, so unpacking needs no sign-extension care (the w16 fault of the
TPU layout, `ops/pallas/qbits_mm.py:166-177`). `_scale_t`/`_shift_t` are
float32 [G, N] (transposed, as on the TPU) with float-shift semantics
`deq = scale * code - shift`; integer zero-points become float shifts
`scale * zp` (as `weights.py:313-317`). The envelope is int4 and int2 under
the TPU layout's shape rule (`eligible`); off-envelope weights stay in the
generic layout, as JAX's `from_generic` returns None for shapes it cannot
pad.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops.cuda.qbits_mm import dequantize_k_codes, pack_k_codes, requant_step, unpack_k_codes
from ..ops.quantize import dequantize_affine, dequantize_symmetric, quantize_affine, quantize_symmetric
from .grouped import group, ungroup
from .packed import PackedArray
from .qarray import QArray
from .qtype import qtype


__all__ = [
    "WeightQBytesArray",
    "WeightQBitsArray",
    "WeightQBitsHopperArray",
    "WeightQBitsRequantArray",
    "quantize_weight",
]


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
    """int4 or int2 weights in the layout of the Hopper kernels (module docstring)."""

    _packed: torch.Tensor  # uint8 [N, K * bits / 8]
    _scale_t: torch.Tensor  # float32 [G, N]
    _shift_t: torch.Tensor  # float32 [G, N]
    qtype: qtype
    group_size: Optional[int]
    orig_shape: Tuple[int, ...]
    float_dtype: torch.dtype

    @staticmethod
    def eligible(orig_shape: Tuple[int, ...], bits: int, group_size: Optional[int]) -> bool:
        """Kernel-layout constraints: the TPU layout's rule for one K block
        (`quanto_tpu/tensor/weights.py:231-251`), with kp = K * bits / 8."""
        if len(orig_shape) != 2 or bits not in (2, 4):
            return False
        N, K = orig_shape
        kp = K * bits // 8
        if K % (8 // bits) or N % 128 != 0 or kp % 128 != 0:  # whole bytes per row
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
            _packed=pack_k_codes(codes, w.qtype.bits),
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
        codes = unpack_k_codes(self._packed, self.bits)
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
    def bits(self) -> int:
        return self.qtype.bits

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
        w = dequantize_k_codes(self._packed, self._scale_t, self._shift_t, self.kernel_group_size, self.bits)
        return w.to(self.float_dtype)


@dataclass(frozen=True, eq=False)
class WeightQBitsRequantArray(WeightQBitsHopperArray):
    """A Hopper-layout int4 or int2 weight frozen for the requant route
    (`ops/cuda/qbits_mm.py:qbits_mm_requant_int8`).

    `_s8` float32 [N] is the per-channel int8 step (`requant_step`,
    `quanto_tpu/ops/pallas/qbits_mm.py:484-488`); the per-group factors
    s / s8 and z / s8 are computed in the kernel, not stored. With a qint8
    activation at M >= 2048 `qlinear` takes the requant kernel, which is
    approximate: the codes are requantized to a per-channel int8 step
    (127 steps over the row's largest |weight|) about 8x finer than the
    coarsest group's int4 step (15 steps over it) and about 42x finer than
    an int2 one (3 steps; `quanto_tpu/ops/config.py:164-185`). Everything
    else (float x, smaller M, `dequantize`, `to_generic`) is the parent's,
    exact."""

    _s8: torch.Tensor  # float32 [N]

    @classmethod
    def from_hopper(cls, w: WeightQBitsHopperArray) -> "WeightQBitsRequantArray":
        """The requant form of a Hopper-layout int4 or int2 weight (its
        payload, scales and shifts shared, not copied)."""
        fields = {f: getattr(w, f) for f in WeightQBitsHopperArray.__dataclass_fields__}
        return cls(**fields, _s8=requant_step(w._scale_t, w._shift_t, w.qtype.bits))


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
