"""Decode attention over a float or quantized KV cache: the Hopper kernel, its
plain version and its launch count.

Counterpart of the three TPU kernels `quanto_tpu/ops/pallas/flash_decode.py`,
`flash_decode2.py` and `flash_decode3.py`, which compute one function; one
split-S flash-decoding kernel in `quanto_tpu_torch/csrc/flash_decode.cu`
replaces all three. For each batch row b, KV head h and query g, over the
cache slots s <= positions[b]:

    logit[s] = ((q . c_k[s]) * s_k[s] + (sum_d q) * m_k[s]) / sqrt(D)
    out      = softmax(logit) . (s_v * c_v + m_v)

The wrapper's contract is JAX's `flash_decode_call`, widened to the port's
caches (`tensor/kv_cache.py`): q [B, Hkv, G, D] (bfloat16 or float32, D 64 or
128); k/v payloads [B, S, Hkv, D] in float32, bfloat16, int8 or a float8 type,
or int4 as uint8 [B, S, Hkv, D/2], the K and V types independent (k8v4,
k4v8); scales and shifts float32 [B, S, Hkv, 1] or None; positions int [B].
It returns [B, Hkv, G, D] in q's dtype.

`flash_decode` takes the plain version when q lies on the CPU; on a CUDA
tensor it launches the kernel or raises. `flash_decode.launches` counts its
calls that launched the kernel (one C call runs the split pass and the merge
pass, and counts once).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...tensor.kv_cache import unpack_int4_codes
from ._build import kernel


__all__ = ["flash_decode_plain", "flash_decode"]

_FLOAT_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_CODE_TYPES = {torch.int8: 2, torch.uint8: 3}  # uint8 is the int4 nibble layout
_FP8 = 4


def _codes_f32(payload: torch.Tensor) -> torch.Tensor:
    """A cache payload as float32 values [B, S, Hkv, D] (int4 unpacked)."""
    if payload.dtype == torch.uint8:
        return unpack_int4_codes(payload).float()
    return payload.float()


def flash_decode_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    positions: torch.Tensor,
    k_shift: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel: `gqa_attention`'s factored float32 chain
    over the decoded payloads, slots past positions[b] masked, the PV product
    kept in float32 as the kernel keeps it, the output cast to q's dtype."""
    from ..attention import gqa_attention  # ops/attention.py imports this module

    B, Hkv, G, D = q.shape
    S = k.shape[1]
    hidden = torch.arange(S, device=q.device)[None, :] > positions.reshape(B, 1).to(q.device)
    mask = torch.zeros((B, 1, 1, S), device=q.device).masked_fill(hidden[:, None, None, :], float("-inf"))
    out = gqa_attention(
        q[:, None], _codes_f32(k), _codes_f32(v), mask, D**-0.5,
        k_scale=k_scale, v_scale=v_scale, k_shift=k_shift, v_shift=v_shift, f32_pv=True,
    )
    return out.reshape(B, Hkv, G, D)


def _payload_type(t: torch.Tensor, D: int, name: str) -> int:
    if t.dim() != 4:
        raise ValueError(f"flash_decode: {name} must be [B, S, Hkv, D], got {tuple(t.shape)}")
    width = D // 2 if t.dtype == torch.uint8 else D
    if t.shape[-1] != width:
        raise ValueError(f"flash_decode: {name} {tuple(t.shape)} does not match D = {D}")
    if t.dtype in _FLOAT_TYPES:
        return _FLOAT_TYPES[t.dtype]
    if t.dtype in _CODE_TYPES:
        return _CODE_TYPES[t.dtype]
    if t.element_size() == 1 and t.is_floating_point():
        return _FP8
    raise TypeError(f"flash_decode: unsupported {name} payload dtype {t.dtype}")


def _check(q, k, v, k_scale, v_scale, k_shift, v_shift, positions):
    """Validate the operands; returns (k_type, v_type, mode)."""
    if q.dim() != 4:
        raise ValueError(f"flash_decode: q must be [B, Hkv, G, D], got {tuple(q.shape)}")
    B, Hkv, G, D = q.shape
    if q.dtype not in _FLOAT_TYPES:
        raise TypeError(f"flash_decode: q must be bfloat16 or float32, got {q.dtype}")
    if D not in (64, 128):
        raise ValueError(f"flash_decode: head dim {D} must be 64 or 128")
    k_type, v_type = _payload_type(k, D, "k"), _payload_type(v, D, "v")
    if k.shape[0] != B or k.shape[2] != Hkv or v.shape[:3] != k.shape[:3] or k.shape[1] < 1:
        raise ValueError(
            f"flash_decode: k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}"
        )
    floats = k_type in (0, 1)
    if floats != (v_type in (0, 1)) or (floats and k.dtype != v.dtype):
        raise TypeError(f"flash_decode: a float cache has one float type, got {k.dtype} / {v.dtype}")
    if floats != (k_scale is None) or (k_scale is None) != (v_scale is None):
        raise ValueError("flash_decode: a quantized cache needs k_scale and v_scale; a float one neither")
    if (k_shift is None) != (v_shift is None) or (floats and k_shift is not None):
        raise ValueError("flash_decode: shifts come in pairs, with scales")
    slot_shape = (*k.shape[:3], 1)
    for t in (k_scale, v_scale, k_shift, v_shift):
        if t is not None and (tuple(t.shape) != slot_shape or t.dtype != torch.float32):
            raise ValueError(f"flash_decode: scales and shifts must be float32 {slot_shape}")
    if positions.shape != (B,):
        raise ValueError(f"flash_decode: positions must be [{B}], got {tuple(positions.shape)}")
    mode = 0 if floats else (2 if k_shift is not None else 1)
    return k_type, v_type, mode


_LUTS: dict = {}


def _fp8_table(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The 256 values of a float8 format, float32 on `device` (made once)."""
    key = (dtype, device)
    if key not in _LUTS:
        _LUTS[key] = torch.arange(256, dtype=torch.uint8).view(dtype).float().to(device)
    return _LUTS[key]


# C signatures of `flash_decode_workspace` and `flash_decode` in csrc/flash_decode.cu.
_WS_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    positions: torch.Tensor,
    k_shift: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention out [B, Hkv, G, D] in q's dtype (see the module
    docstring). Replaces `quanto_tpu/ops/pallas/flash_decode.py:_kernel`,
    `flash_decode2.py:_kernel` and `flash_decode3.py:_kernel`."""
    k_type, v_type, mode = _check(q, k, v, k_scale, v_scale, k_shift, v_shift, positions)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, k_scale, v_scale, positions, k_shift, v_shift)
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    tensors = [t for t in (q, k, v, k_scale, v_scale, k_shift, v_shift, positions) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_decode: q, k and v must be 16-byte aligned")
    if positions.dtype != torch.int32:
        raise TypeError(f"flash_decode: positions must be int32, got {positions.dtype}")
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    # Partials of the split pass, read by the merge pass; the kernel's source
    # picks the number of splits and so the size. Freed when this returns: the
    # caching allocator hands the block only to later work on the same
    # stream, which runs after both passes.
    n_ws = ctypes.c_longlong()
    rc = kernel("flash_decode_workspace", _WS_ARGTYPES)(device, B, Hkv, G, S, D, ctypes.byref(n_ws))
    if rc != 0:
        raise RuntimeError(f"flash_decode workspace query failed: cudaError {rc}")
    ws = torch.empty(n_ws.value, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    k_lut = _fp8_table(k.dtype, q.device) if k_type == _FP8 else None
    v_lut = _fp8_table(v.dtype, q.device) if v_type == _FP8 else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    rc = kernel("flash_decode", _ARGTYPES)(
        device,
        ptr(q), ptr(k), ptr(v), ptr(k_scale), ptr(v_scale), ptr(k_shift), ptr(v_shift),
        ptr(positions), ptr(k_lut), ptr(v_lut), ptr(ws), ptr(out),
        B, Hkv, G, S, D, k_type, v_type, mode, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
