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
the TPU layout's shape rule (`eligible`). A weight off it is zero-padded onto
it where `pad_geometry` finds a geometry, as JAX's `from_generic` pads
(`quanto_tpu/tensor/weights.py:220-380`): each group's gs codes to gs_pad,
then the N and K tails, with zero scales and shifts for the tail rows and
groups; `pad_activations` pads x's K the same way (the pads multiply zeros,
so the product is exact) and `slice_out` drops the padded output columns.
`dequantize` and `to_generic` read the true grid, so a padded weight's
checkpoint is the unpadded one's, byte for byte. A weight that no geometry
puts on the envelope (a group size that does not divide K, axis -1) stays
in the generic layout, as JAX's `from_generic` returns None for it.

`fake_quantize_weight` is the quantize-dequantize round trip of
quantization-aware training, with straight-through gradients
(`weights.py:559-588`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import dataclasses

import torch
import torch.nn.functional as F

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
    "fake_quantize_weight",
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
    """int4 or int2 weights in the layout of the Hopper kernels (module docstring).

    `pad` (Npad, Kpad, gs_pad) marks a weight zero-padded onto the envelope:
    `_packed` is then [Npad, Kpad * bits / 8] and `_scale_t`/`_shift_t` are
    [Kpad / gs_pad, Npad] (gs_pad None: per-tensor, [1, Npad]), while
    `orig_shape` and `group_size` stay the true ones. None: no padding."""

    _packed: torch.Tensor  # uint8 [N, K * bits / 8] (padded: [Npad, Kpad * bits / 8])
    _scale_t: torch.Tensor  # float32 [G, N]
    _shift_t: torch.Tensor  # float32 [G, N]
    qtype: qtype
    group_size: Optional[int]
    orig_shape: Tuple[int, ...]
    float_dtype: torch.dtype
    shard: Optional[Shard] = field(default=None, kw_only=True)
    pad: Optional[Tuple[int, int, Optional[int]]] = field(default=None, kw_only=True)

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

    @staticmethod
    def pad_geometry(
        orig_shape: Tuple[int, ...], bits: int, group_size: Optional[int]
    ) -> Optional[Tuple[int, int, Optional[int]]]:
        """The least zero-padded geometry (Npad, Kpad, gs_pad) that puts an
        off-envelope [N, K] weight of `group_size` onto the envelope, or None
        where none is needed or none helps (`quanto_tpu/tensor/weights.py:
        pad_geometry`): N up to a multiple of 128; per-tensor, K up to a
        multiple of 128 * 8 / bits; grouped, each group of gs codes up to
        gs_pad (gs rounded up to 128) and then the groups' K up to a multiple
        of gs_pad * 8 / bits, so that whole groups tile the packed columns."""
        if len(orig_shape) != 2 or bits not in (2, 4):
            return None
        N, K = orig_shape
        vals = 8 // bits
        npad = -128 * (-N // 128)
        if group_size is None:
            align = vals * 128
            geom = (npad, -align * (-K // align), None)
        else:
            if K % group_size:
                return None
            gs_pad = -128 * (-group_size // 128)
            align = vals * gs_pad
            geom = (npad, -align * (-(K // group_size * gs_pad) // align), gs_pad)
        if (geom[0], geom[1]) == (N, K) and geom[2] in (group_size, None):
            return None
        if not WeightQBitsHopperArray.eligible(geom[:2], bits, geom[2]):
            return None
        return geom

    @classmethod
    def from_generic(cls, w: WeightQBitsArray) -> Optional["WeightQBitsHopperArray"]:
        """Repack a generic weight, zero-padded onto the envelope where it is
        off it (`pad_geometry`), or None where it cannot be (axis -1, or no
        geometry): JAX's `from_generic`. The codes are repacked a block of
        rows at a time (`_repack_generic`), so the device holds at most one
        block of unpacked codes beside the two payloads: what lets a
        checkpoint load a module at a time within its weights' bytes plus a
        margin."""
        if w.axis != 0:
            return None
        pad = None
        if not cls.eligible(w.orig_shape, w.qtype.bits, w.group_size):
            pad = cls.pad_geometry(w.orig_shape, w.qtype.bits, w.group_size)
            if pad is None:
                return None
        scale, shift = _pad_scales(*_scales_shifts(w), pad)
        return cls._from_packed(_repack_generic(w, pad), scale, shift, w, w.shard, pad=pad)

    @classmethod
    def _from_packed(cls, packed, scale, shift, like, shard=None, pad=None) -> "WeightQBitsHopperArray":
        """From the Hopper payload uint8 [N, K * bits / 8] and float32
        scale/shift [N, G] (padded where `pad` is given), with the qtype,
        group size and float dtype of `like`; no envelope check."""
        bits = like.qtype.bits
        shape = (packed.shape[0], packed.shape[1] * 8 // bits) if pad is None else tuple(like.orig_shape)
        return cls(
            _packed=packed,
            _scale_t=scale.t().contiguous(),
            _shift_t=shift.t().contiguous(),
            qtype=like.qtype,
            group_size=like.group_size,
            orig_shape=shape,
            float_dtype=like.float_dtype,
            shard=shard,
            pad=pad,
        )

    def true_grid(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The codes uint8 [N, K] and float32 scale and float shift [N, G] on
        the true grid, the padding dropped (JAX's `_true_codes`)."""
        N, K = self.orig_shape
        G = K // (self.group_size if self.group_size is not None else K)
        codes = _unpad_k(unpack_k_codes(self._packed, self.bits)[:N], K, self.group_size, self.pad)
        return codes, self._scale_t.t()[:N, :G], self._shift_t.t()[:N, :G]

    def to_generic(self) -> WeightQBitsArray:
        """Back to the serialized generic layout (float shifts), on the true grid."""
        gs = self.group_size
        codes, scale, shift = self.true_grid()
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
    def kernel_shape(self) -> Tuple[int, int]:
        """(N, K) of the payload the kernels read: (Npad, Kpad) when padded."""
        return self._packed.shape[0], self._packed.shape[1] * 8 // self.bits

    @property
    def kernel_group_size(self) -> int:
        """The group size of the payload the kernels read: gs_pad when padded,
        the whole (padded) K per tensor."""
        if self.pad is not None and self.pad[2] is not None:
            return self.pad[2]
        return self.group_size if self.group_size is not None else self.kernel_shape[1]

    def pad_activations(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., K] zero-padded to the payload's K as the codes are (each group
        gs -> gs_pad, then the tail), float or int8 codes alike; x itself when
        the weight is not padded."""
        return _pad_k(x, self.group_size, self.pad)

    def slice_out(self, out: torch.Tensor) -> torch.Tensor:
        """Drop the padded output columns ([..., Npad] -> [..., N], contiguous)."""
        N = self.orig_shape[0]
        return out if out.shape[-1] == N else out[..., :N].contiguous()

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
        """In `dtype`, by default the weight's float dtype (computed in float32),
        on the true grid."""
        w = dequantize_k_codes(self._packed, self._scale_t, self._shift_t, self.kernel_group_size, self.bits)
        if self.pad is not None:
            w = _unpad_k(w[: self.orig_shape[0]], self.orig_shape[1], self.group_size, self.pad)
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
    exact. A padded weight's tail groups have zero scales and shifts, so they
    do not move `_s8`; its padded rows get the least step and zero codes."""

    _s8: torch.Tensor  # float32 [N] (padded: [Npad])

    @classmethod
    def from_hopper(cls, w: WeightQBitsHopperArray) -> "WeightQBitsRequantArray":
        """The requant form of a Hopper-layout int4 or int2 weight, padded or
        not (its payload, scales and shifts shared, not copied)."""
        fields = {f: getattr(w, f) for f in WeightQBitsHopperArray.__dataclass_fields__}
        return cls(**fields, _s8=requant_step(w._scale_t, w._shift_t, w.qtype.bits))


_REPACK_BLOCK_BYTES = 64 << 20  # unpacked codes per block of `_repack_generic`


def _pad_k(t: torch.Tensor, group_size: Optional[int], pad) -> torch.Tensor:
    """t [..., K] (codes or activations) zero-padded along its last dimension
    to the padded K of `pad` (Npad, Kpad, gs_pad): each group of `group_size`
    to gs_pad values, then the tail (JAX's `pad_activations`); t where `pad`
    is None."""
    if pad is None:
        return t
    _, kpad, gs_pad = pad
    lead, K = t.shape[:-1], t.shape[-1]
    if gs_pad is not None and group_size is not None:
        g = K // group_size
        t = F.pad(t.reshape(*lead, g, group_size), (0, gs_pad - group_size)).reshape(*lead, g * gs_pad)
    return F.pad(t, (0, kpad - t.shape[-1]))


def _unpad_k(t: torch.Tensor, K: int, group_size: Optional[int], pad) -> torch.Tensor:
    """Inverse of `_pad_k`: t [..., Kpad] -> the true [..., K]."""
    if pad is None:
        return t
    _, kpad, gs_pad = pad
    if gs_pad is None or group_size is None:
        return t[..., :K]
    lead, g = t.shape[:-1], K // group_size
    return t.reshape(*lead, kpad // gs_pad, gs_pad)[..., :g, :group_size].reshape(*lead, K)


def _pad_scales(scale: torch.Tensor, shift: torch.Tensor, pad):
    """float32 scale and shift [N, G] with zero rows and tail groups up to the
    padded [Npad, Kpad / gs_pad] of `pad` (one group per tensor stays one)."""
    if pad is None:
        return scale, shift
    npad, kpad, gs_pad = pad
    N, G = scale.shape
    extra = (0, (kpad // gs_pad - G) if gs_pad is not None else 0, 0, npad - N)
    return F.pad(scale, extra), F.pad(shift, extra)


def _repack_generic(w: WeightQBitsArray, pad=None) -> torch.Tensor:
    """The Hopper payload uint8 [N, K * bits / 8] of a generic weight (axis 0),
    or, with `pad`, the padded [Npad, Kpad * bits / 8], a block of rows at a
    time. quanto's `PackedArray` packs the grouped rows [N * G, gs] along
    axis 0 into R = ceil(N * G * bits / 8) packed rows: grouped row g lies in
    packed row g % R at bit plane g // R (`ops/pack.py`)."""
    N, K = w.orig_shape
    bits = w.qtype.bits
    mask = (1 << bits) - 1
    G = K // (w.group_size if w.group_size is not None else K)
    src = w._data.packed_data
    R = src.shape[0]
    npad, kpad = (pad[0], pad[1]) if pad is not None else (N, K)
    out = torch.zeros((npad, kpad * bits // 8), dtype=torch.uint8, device=src.device)
    block = max(1, _REPACK_BLOCK_BYTES // kpad)
    for r0 in range(0, N, block):
        r1 = min(r0 + block, N)
        g = torch.arange(r0 * G, r1 * G, device=src.device)
        shifts = (bits * torch.div(g, R, rounding_mode="floor")).to(torch.uint8)[:, None]
        codes = ((src[g % R] >> shifts) & mask).reshape(r1 - r0, K)
        out[r0:r1] = pack_k_codes(_pad_k(codes, w.group_size, pad), bits)
    return out


def _scales_shifts(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """An int4/int2 weight's (generic layout, axis 0, or Hopper layout)
    float32 scale and float shift [N, G] on the true grid."""
    if isinstance(w, WeightQBitsHopperArray):
        return w.true_grid()[1:]
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
    codes [N, K] and float32 scale and float shift [N, G], on the true grid."""
    if isinstance(w, WeightQBitsHopperArray):
        return w.true_grid()
    return (ungroup(w._data.unpack(), w.axis, w.orig_shape), *_scales_shifts(w))


def padded(w) -> bool:
    """Whether an int4/int2 weight is, or in the Hopper layout would be,
    zero-padded onto the envelope."""
    if isinstance(w, WeightQBitsHopperArray):
        return w.pad is not None
    return (
        isinstance(w, WeightQBitsArray) and w.axis == 0
        and not WeightQBitsHopperArray.eligible(w.orig_shape, w.qtype.bits, w.group_size)
        and WeightQBitsHopperArray.pad_geometry(w.orig_shape, w.qtype.bits, w.group_size) is not None
    )


def shard_qbits(w, mode: str, group):
    """This rank's part of an int4/int2 weight (generic or Hopper layout) in
    the TP group `group` (rank, world_size), for `mode` "column", "row" or
    "replicated": rank r of p holds rows [r N/p, (r+1) N/p) of a column
    shard, columns [r K/p, (r+1) K/p) of a row shard (whole groups: the
    group size must divide K / p), or all of it. A column or row part takes
    the Hopper layout where its own shape is on the envelope and stays in the
    generic layout where it is not; JAX replicates such a row-parallel
    weight instead (`sharding.py:242-247`), which changes only the order of
    the float32 sum. A replicated weight keeps its layout, and a generic one
    takes the Hopper layout (padded where it is off the envelope) where
    `from_generic` gives it. The caller replicates where p does not divide
    the dimension (the pad-free rule) and where the weight is padded, as
    JAX's `_shard_qweight` does (`quanto_tpu/parallel/sharding.py:237-241`;
    `parallel/sharding.py:shard_model`)."""
    if isinstance(w, WeightQBitsRequantArray):
        raise NotImplementedError(
            "shard_qbits: the requant form under tensor parallelism is not ported yet: ROADMAP.md Queue 1, item 10"
        )
    if mode == "replicated":
        hopper = w if isinstance(w, WeightQBitsHopperArray) else WeightQBitsHopperArray.from_generic(w)
        return dataclasses.replace(hopper or w, shard=Shard(mode, group))
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
    else:
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


class _FakeQuantizeWeight(torch.autograd.Function):
    """`fake_quantize_weight`'s straight-through round trip: the gradient
    passes to the tensor unchanged; scale and shift get zeros (JAX's
    `_fake_qw_bwd`, `quanto_tpu/tensor/weights.py:579-585`)."""

    @staticmethod
    def forward(ctx, t, qt, axis, scale, shift, group_size):
        ctx.save_for_backward(scale, *(() if shift is None else (shift,)))
        qw = quantize_weight(t, qt, axis, scale, shift=shift, group_size=group_size)
        return qw.dequantize().to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        scale, *shift = ctx.saved_tensors
        return g, None, None, torch.zeros_like(scale), (torch.zeros_like(shift[0]) if shift else None), None


def fake_quantize_weight(
    t: torch.Tensor,
    qt: qtype,
    axis: Optional[int],
    scale: torch.Tensor,
    shift: Optional[torch.Tensor],
    group_size: Optional[int],
) -> torch.Tensor:
    """Quantize-dequantize round trip with straight-through gradients, the QAT
    path (`quanto_tpu/tensor/weights.py:559-577`): the forward is
    `quantize_weight(...).dequantize()` in t's dtype; gradients flow
    unchanged to `t`, and scale and shift receive zeros."""
    return _FakeQuantizeWeight.apply(t, qt, axis, scale, shift, group_size)
