"""Decode attention over a float or quantized KV cache: the Hopper kernel, its
plain version and its launch count.

Counterpart of the three TPU kernels `quanto_tpu/ops/pallas/flash_decode.py`,
`flash_decode2.py` and `flash_decode3.py`, which compute one function; one
flash-decoding kernel in `quanto_tpu_torch/csrc/flash_decode.cu` (its
CUDA-core arm for float32 q or a float32 cache in `flash_decode_cc.cu`, its
tensor-core arm one source per head dim, `flash_decode_tc{64,128,256}.cu`)
replaces all three. For each batch row b, KV head h and query g, over the
cache slots s <= positions[b], and s > positions[b] - window under a
sliding window:

    x[s]     = ((q . c_k[s]) * s_k[s] + (sum_d q) * m_k[s]) * scale
    logit[s] = softcap * tanh(x[s] / softcap)        (x[s] without a softcap)
    out      = softmax(logit) . (s_v * c_v + m_v)

`scale` defaults to D**-0.5; `softcap` (None: none) and `window` (None: none)
are Gemma-2's attention softcap and sliding window. `sinks` (None: none),
float32 [Hkv * G], are gpt-oss's attention sinks: one learned logit per query
head that joins the softmax as a slot without a value, after the scale, the
softcap and the mask (m = max(max_s logit, sink), the denominator gains
exp(sink - m); JAX's `gqa_attention(..., sinks=)`). The four are runtime
arguments of one kernel; under a window a row reads only its window's slots,
and only the last store of a row reads its sink.

The wrapper's contract is JAX's `flash_decode_call`, widened to the port's
caches (`tensor/kv_cache.py`): q [B, Hkv, G, D] (bfloat16 or float32, D 64,
128 or 256); k/v payloads [B, S, Hkv, D] in float32, bfloat16, int8 or a float8 type,
or int4 as uint8 [B, S, Hkv, D/2], the K and V types independent (k8v4,
k4v8); scales and shifts float32 [B, S, Hkv, 1] or None; positions int [B].
It returns [B, Hkv, G, D] in q's dtype.

`flash_decode_paged` is the same kernel over a paged cache
(`tensor/paged_kv.py`): k/v pools [n_pages, page_size, Hkv, D] (int4 as
uint8 [..., D/2]), scales and shifts [n_pages, page_size, Hkv, 1], and an int32
page table [B, P]; slot s of row b is offset s % page_size of page
table[b, s // page_size], over S = P * page_size slots. The kernel reads the
pages through the table (JAX gathers a dense view and runs its kernels on
that, `quanto_tpu/ops/attention.py:310-319`); its plain version is exactly
JAX's route, the gathered view through `flash_decode_plain`. It computes the
dense call's function over the gathered view with the same plan and the same
order of sums, so on the card it equals `flash_decode` on that view bit for
bit. `flash_decode_paged.launches` counts its launches apart.

Each wrapper takes the plain version when q lies on the CPU; on a CUDA
tensor it launches the kernel or raises. `flash_decode.launches` counts its
calls that launched the kernel: one C call, one launch. The kernel plans its
work from `positions` on the device, so a call reads nothing back to the
host. It takes a float32 workspace for the partials of its grid (its size
depends on the device, G, D, the payload types and q's dtype only, and is
asked of the C side once per such key) and int32 arrival counters, one per
(b, h, query group), which the wrapper keeps per device and stream: zeroed
once, left zero by every call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ...tensor.kv_cache import unpack_int4_codes
from ...tensor.paged_kv import gather_pages
from ._build import kernel


__all__ = ["flash_decode_plain", "flash_decode", "flash_decode_paged_plain", "flash_decode_paged"]

_FLOAT_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_CODE_TYPES = {torch.int8: 2, torch.uint8: 3}  # uint8 is the int4 nibble layout
_FP8 = 4
_HEAD_DIMS = (64, 128, 256)  # every head dim of the port's model families (Gemma: 256)


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
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel: `gqa_attention`'s factored float32 chain
    over the decoded payloads (scale, then softcap, then the mask, then the
    sinks, JAX's order), slots past positions[b] and, under a window, at or
    before positions[b] - window masked, the PV product kept in float32 as
    the kernel keeps it, the output cast to q's dtype."""
    from ..attention import gqa_attention  # ops/attention.py imports this module

    B, Hkv, G, D = q.shape
    S = k.shape[1]
    s = torch.arange(S, device=q.device)[None, :]
    p = positions.reshape(B, 1).to(q.device)
    hidden = s > p
    if window is not None:
        hidden |= s <= p - window
    mask = torch.zeros((B, 1, 1, S), device=q.device).masked_fill(hidden[:, None, None, :], float("-inf"))
    out = gqa_attention(
        q[:, None], _codes_f32(k), _codes_f32(v), mask, D**-0.5 if scale is None else scale,
        k_scale=k_scale, v_scale=v_scale, k_shift=k_shift, v_shift=v_shift, softcap=softcap, sinks=sinks,
        f32_pv=True,
    )
    return out.reshape(B, Hkv, G, D)


def _check_transforms(q, scale, softcap, window, sinks) -> None:
    if sinks is not None:
        H = q.shape[1] * q.shape[2]
        if sinks.dtype != torch.float32 or tuple(sinks.shape) != (H,) or sinks.device != q.device:
            raise ValueError(f"flash_decode: sinks must be float32 [{H}] on q's device, got "
                             f"{sinks.dtype} {tuple(sinks.shape)} on {sinks.device}")
    if scale is not None and not scale > 0:
        raise ValueError(f"flash_decode: scale must be positive, got {scale}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_decode: softcap must be positive, got {softcap}")
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"flash_decode: window must be a positive int, got {window}")


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


def _check(q, k, v, k_scale, v_scale, k_shift, v_shift, positions, paged: bool = False):
    """Validate the operands (k/v [B, S, ...], or page pools when `paged`);
    returns (k_type, v_type, mode)."""
    if q.dim() != 4:
        raise ValueError(f"flash_decode: q must be [B, Hkv, G, D], got {tuple(q.shape)}")
    B, Hkv, G, D = q.shape
    if q.dtype not in _FLOAT_TYPES:
        raise TypeError(f"flash_decode: q must be bfloat16 or float32, got {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {D} must be one of {_HEAD_DIMS}")
    k_type, v_type = _payload_type(k, D, "k"), _payload_type(v, D, "v")
    if (k.shape[0] != B and not paged) or k.shape[2] != Hkv or v.shape[:3] != k.shape[:3] or k.shape[1] < 1:
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
_WS_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _plan(device: int, G: int, D: int, k_type: int, v_type: int, q_bf16: bool):
    """(float32 elements of the partials' workspace, query groups a KV head
    is cut into) of a launch on `device`, as csrc/flash_decode.cu plans it."""
    floats, groups = ctypes.c_longlong(), ctypes.c_int()
    rc = kernel("flash_decode_workspace", _WS_ARGTYPES)(
        device, G, D, k_type, v_type, int(q_bf16), ctypes.byref(floats), ctypes.byref(groups)
    )
    if rc != 0:
        raise RuntimeError(f"flash_decode workspace query failed: cudaError {rc}")
    return floats.value, groups.value


_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least `n` int32 arrival counters for launches on `stream`, all zero:
    made zero once, and every launch leaves them so."""
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * (0 if buf is None else buf.numel())), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf


def _launch(q, k, v, k_scale, v_scale, positions, k_shift, v_shift, types, S: int, table=None, page_size: int = 0,
            scale=None, softcap=None, window=None, sinks=None):
    """One launch of the kernel on q's CUDA device, dense (`table` None) or
    paged; returns the output. `types`: `_check`'s (k_type, v_type, mode)."""
    k_type, v_type, mode = types
    B, Hkv, G, D = q.shape
    tensors = [t for t in (q, k, v, k_scale, v_scale, k_shift, v_shift, positions, table, sinks) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_decode: q, k and v must be 16-byte aligned")
    if positions.dtype != torch.int32:
        raise TypeError(f"flash_decode: positions must be int32, got {positions.dtype}")
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    q_bf16 = q.dtype == torch.bfloat16
    n_ws, groups = _plan(device, G, D, k_type, v_type, q_bf16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # The partials, freed when this returns: the caching allocator hands the
    # block only to later work on the same stream, which runs after the kernel.
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    counters = _counters(q.device, stream, B * Hkv * groups)
    out = torch.empty_like(q)
    k_lut = _fp8_table(k.dtype, q.device) if k_type == _FP8 else None
    v_lut = _fp8_table(v.dtype, q.device) if v_type == _FP8 else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    P = table.shape[1] if table is not None else 0
    rc = kernel("flash_decode", _ARGTYPES)(
        device,
        ptr(q), ptr(k), ptr(v), ptr(k_scale), ptr(v_scale), ptr(k_shift), ptr(v_shift),
        ptr(positions), ptr(k_lut), ptr(v_lut), ptr(ws), ptr(counters), ptr(out),
        B, Hkv, G, S, D, k_type, v_type, mode, int(q_bf16), ptr(table), P, page_size,
        D**-0.5 if scale is None else float(scale), float(softcap or 0.0), int(window or 0), ptr(sinks), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
    return out


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    positions: torch.Tensor,
    k_shift: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention out [B, Hkv, G, D] in q's dtype (see the module
    docstring). Replaces `quanto_tpu/ops/pallas/flash_decode.py:_kernel`,
    `flash_decode2.py:_kernel` and `flash_decode3.py:_kernel`."""
    types = _check(q, k, v, k_scale, v_scale, k_shift, v_shift, positions)
    _check_transforms(q, scale, softcap, window, sinks)
    tf = dict(scale=scale, softcap=softcap, window=window, sinks=sinks)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, k_scale, v_scale, positions, k_shift, v_shift, **tf)
    out = _launch(q, k, v, k_scale, v_scale, positions, k_shift, v_shift, types, k.shape[1], **tf)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_paged_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    table: torch.Tensor,
    positions: torch.Tensor,
    k_shift: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the paged arm, JAX's route: the pages gathered
    through the table into the dense view, then `flash_decode_plain`."""
    g = [gather_pages(t, table) for t in (k_pages, v_pages, k_scale, v_scale, k_shift, v_shift)]
    return flash_decode_plain(q, g[0], g[1], g[2], g[3], positions, g[4], g[5], scale=scale, softcap=softcap,
                              window=window, sinks=sinks)


def flash_decode_paged(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    table: torch.Tensor,
    positions: torch.Tensor,
    k_shift: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention out [B, Hkv, G, D] over a paged cache, reading the
    pages through `table` (int32 [B, P]; see the module docstring). Replaces
    the same TPU kernels as `flash_decode`, which JAX runs on the gathered view."""
    types = _check(q, k_pages, v_pages, k_scale, v_scale, k_shift, v_shift, positions, paged=True)
    _check_transforms(q, scale, softcap, window, sinks)
    tf = dict(scale=scale, softcap=softcap, window=window, sinks=sinks)
    B = q.shape[0]
    if table.dim() != 2 or table.shape[0] != B or table.dtype != torch.int32:
        raise ValueError(f"flash_decode_paged: table must be int32 [{B}, P], got {table.dtype} {tuple(table.shape)}")
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pages, v_pages, k_scale, v_scale, table, positions, k_shift, v_shift,
                                        **tf)
    ps = k_pages.shape[1]
    out = _launch(q, k_pages, v_pages, k_scale, v_scale, positions, k_shift, v_shift, types,
                  table.shape[1] * ps, table, ps, **tf)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
