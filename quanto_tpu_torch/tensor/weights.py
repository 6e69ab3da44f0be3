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

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch

from ..ops.cuda.qbits_mm import dequantize_k_codes, pack_k_codes, requant_step, unpack_k_codes
from ..ops.quantize import dequantize_affine, dequantize_symmetric, quantize_affine, quantize_symmetric
from .grouped import group, ungroup
from .packed import PackedArray
from .qarray import QArray
from .qtype import qtype


__all__ = [
    "Shard",
    "shard_qbits",
    "WeightQBytesArray",
    "WeightQBitsArray",
    "WeightQBitsHopperArray",
    "WeightQBitsRequantArray",
    "quantize_weight",
]


@dataclass(frozen=True, eq=False)
class Shard:
    """Which part of a weight a rank holds: `mode` "column" (N / world rows of
    the [N, K] weight), "row" (K / world columns) or "replicated" (all of
    it), in `group` (`ops/collectives.py:TPGroup`). A row part's
    products are partial sums that the group adds."""

    mode: str
    group: Any


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
    shard: Optional[Shard] = field(default=None, kw_only=True)

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

    def dequantize(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """In `dtype`, by default the weight's float dtype (computed in float32)."""
        codes = self._data.unpack()
        grouped = dequantize_affine(codes, self._scale, self._shift, torch.float32)
        return ungroup(grouped, self.axis, self.orig_shape).to(dtype or self.float_dtype)


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
    shard: Optional[Shard] = field(default=None, kw_only=True)

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
        """Repack a generic weight, or None when it is off the envelope. The
        codes are repacked a block of rows at a time (`_repack_generic`), so
        the device holds at most one block of unpacked codes beside the two
        payloads: what lets a checkpoint load a module at a time within its
        weights' bytes plus a margin."""
        if w.axis != 0 or not cls.eligible(w.orig_shape, w.qtype.bits, w.group_size):
            return None
        return cls._from_packed(_repack_generic(w), *_scales_shifts(w), w, w.shard)

    @classmethod
    def _from_packed(cls, packed, scale, shift, like, shard=None) -> "WeightQBitsHopperArray":
        """From the Hopper payload uint8 [N, K * bits / 8] and float32
        scale/shift [N, G], with the qtype, group size and float dtype of
        `like`; no envelope check."""
        return cls(
            _packed=packed,
            _scale_t=scale.t().contiguous(),
            _shift_t=shift.t().contiguous(),
            qtype=like.qtype,
            group_size=like.group_size,
            orig_shape=(packed.shape[0], packed.shape[1] * 8 // like.qtype.bits),
            float_dtype=like.float_dtype,
            shard=shard,
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
            shard=self.shard,
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

    def dequantize(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """In `dtype`, by default the weight's float dtype (computed in float32)."""
        w = dequantize_k_codes(self._packed, self._scale_t, self._shift_t, self.kernel_group_size, self.bits)
        return w.to(dtype or self.float_dtype)


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


_REPACK_BLOCK_BYTES = 64 << 20  # unpacked codes per block of `_repack_generic`


def _repack_generic(w: WeightQBitsArray) -> torch.Tensor:
    """The Hopper payload uint8 [N, K * bits / 8] of a generic weight (axis 0,
    on the envelope), a block of rows at a time. quanto's `PackedArray` packs
    the grouped rows [N * G, gs] along axis 0: grouped row g lies in packed
    row g % (N * G / per) at bit plane g // (N * G / per), per = 8 / bits
    (`ops/pack.py`). Output rows [p N / per, (p + 1) N / per) are plane p,
    so a block of rows within one plane is one slice of packed rows and one
    shift."""
    N, K = w.orig_shape
    bits = w.qtype.bits
    per, mask = 8 // bits, (1 << bits) - 1
    G = K // (w.group_size if w.group_size is not None else K)
    src = w._data.packed_data
    out = torch.empty((N, K // per), dtype=torch.uint8, device=src.device)
    plane_rows = N // per
    block = max(1, _REPACK_BLOCK_BYTES // K)
    for p in range(per):
        for r0 in range(0, plane_rows, block):
            r1 = min(r0 + block, plane_rows)
            codes = (src[r0 * G : r1 * G] >> (bits * p)) & mask
            out[p * plane_rows + r0 : p * plane_rows + r1] = pack_k_codes(codes.reshape(r1 - r0, K), bits)
    return out


def _scales_shifts(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """An int4/int2 weight's (generic layout, axis 0, or Hopper layout)
    float32 scale and float shift [N, G]."""
    if isinstance(w, WeightQBitsHopperArray):
        return w._scale_t.t(), w._shift_t.t()
    if w.axis != 0:
        raise ValueError("an int4/int2 weight quantized along axis -1 has no Hopper layout")
    N, K = w.orig_shape
    G = K // (w.group_size if w.group_size is not None else K)
    scale = w._scale.float().reshape(N, G)
    if w._shift.is_floating_point():
        shift = w._shift.float().reshape(N, G)
    else:
        # Integer zero-point: deq = scale*(code - zp) = scale*code - scale*zp.
        shift = scale * w._shift.float().reshape(N, G)
    return scale, shift


def _codes_scales(w) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """An int4/int2 weight (generic layout, axis 0, or Hopper layout) as uint8
    codes [N, K] and float32 scale and float shift [N, G]."""
    scale, shift = _scales_shifts(w)
    if isinstance(w, WeightQBitsHopperArray):
        return unpack_k_codes(w._packed, w.bits), scale, shift
    return ungroup(w._data.unpack(), w.axis, w.orig_shape), scale, shift


def shard_qbits(w, mode: str, group):
    """This rank's part of an int4/int2 weight (generic or Hopper layout) in
    the TP group `group` (rank, world_size), for `mode` "column", "row" or
    "replicated": rank r of p holds rows [r N/p, (r+1) N/p) of a column
    shard, columns [r K/p, (r+1) K/p) of a row shard (whole groups: the
    group size must divide K / p), or all of it. The part takes the Hopper
    layout where its own shape is on the envelope (`eligible`) and stays in
    the generic layout where it is not; JAX replicates such a row-parallel
    weight instead (`sharding.py:242-247`), which changes only the order of
    the float32 sum. The caller replicates where p does not divide the
    dimension (`parallel/sharding.py`, the pad-free rule)."""
    if isinstance(w, WeightQBitsRequantArray):
        raise NotImplementedError(
            "shard_qbits: the requant form under tensor parallelism is not ported yet: ROADMAP.md Queue 1, item 10"
        )
    codes, scale, shift = _codes_scales(w)
    N, K = codes.shape
    p, r = group.world_size, group.rank
    if mode == "column":
        rows = slice(r * N // p, (r + 1) * N // p)
        codes, scale, shift = codes[rows], scale[rows], shift[rows]
    elif mode == "row":
        gs = w.group_size if w.group_size is not None else K
        k = K // p
        if gs != K and k % gs:
            raise ValueError(f"shard_qbits: a row shard of K = {K} over {p} ranks splits groups of {gs}")
        codes = codes[:, r * k : (r + 1) * k]
        if gs != K:
            g = slice(r * k // gs, (r + 1) * k // gs)
            scale, shift = scale[:, g], shift[:, g]
    elif mode != "replicated":
        raise ValueError(f"shard_qbits: mode must be column, row or replicated, got {mode!r}")
    packed = pack_k_codes(codes, w.qtype.bits)
    local = WeightQBitsHopperArray._from_packed(packed, scale, shift, w, Shard(mode, group))
    if WeightQBitsHopperArray.eligible(local.orig_shape, local.bits, local.group_size):
        return local
    return local.to_generic()


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
