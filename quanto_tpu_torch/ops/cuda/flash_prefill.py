"""Causal prefill attention over the raw K/V: the Hopper kernel, its plain
version and its launch count.

Counterpart of `quanto_tpu/ops/attention.py:206 try_flash_prefill`, which runs
JAX's splash-attention MQA kernel (one per batch row and kv head, the G query
heads of a kv head inside it, `:237-265`). One hand-written kernel,
`quanto_tpu_torch/csrc/flash_prefill.cu`, replaces it. For query head
hq = h G + g and position t, over the positions u <= t of the same prompt:

    s[u] = rnd(q[t, hq] * scale) . k[u, h]      (rnd: to q's dtype, as JAX at :257)
    s[u] = softcap * tanh(s[u] / softcap)        (when a softcap is given)
    out  = softmax(s) . v

`flash_prefill(q, k, v, softcap=None, scale=None)`: q [B, T, H, D], k/v
[B, T, Hkv, D], one dtype, bfloat16 or float32; scale defaults to D**-0.5. It
returns [B, T, H * D] in q's dtype. `in_envelope(T, D, dtype)` is JAX's
envelope exactly (`:229-233`: T >= 256, T % 128 == 0, D % 128 == 0, bfloat16
or float32), so the port's route (`models/llama.py`) is JAX's on the TPU;
the kernel takes D = 128 and 256 (every head dim of the port's model
families) and raises on a wider head.

The wrapper takes the plain version when q lies on the CPU; on a CUDA tensor
it launches the kernel or raises. `flash_prefill.launches` counts its calls
that launched the kernel: one C call, one launch. The bf16 arm is a persistent
kernel that hands out its work items through one int32 counter on the device
per (device, stream), which the wrapper makes once and every launch leaves at 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import kernel


__all__ = ["in_envelope", "flash_prefill_plain", "flash_prefill"]

_DTYPES = (torch.bfloat16, torch.float32)
_KERNEL_D = (128, 256)


def in_envelope(T: int, D: int, dtype: torch.dtype) -> bool:
    """Whether a causal-from-zero step of T tokens at head dim D in `dtype`
    takes the fused prefill: JAX's `try_flash_prefill` envelope."""
    return T >= 256 and T % 128 == 0 and D % 128 == 0 and dtype in _DTYPES


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_prefill: q [B, T, H, D], k/v [B, T, Hkv, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != D or H % k.shape[2] != 0:
        raise ValueError(f"flash_prefill: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_prefill: q, k and v must share bfloat16 or float32, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not in_envelope(T, D, q.dtype):
        raise ValueError(f"flash_prefill: T = {T}, D = {D} outside the envelope (T >= 256, T % 128 == 0, "
                         "D % 128 == 0)")


def flash_prefill_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the kernel: the scale folded into q in float32 and
    rounded to q's dtype, then `gqa_attention`'s causal float32 chain over the
    raw K/V, the PV product kept in float32 as the kernel (and JAX's splash
    kernel) keeps it; [B, T, H * D] in q's dtype."""
    from ..attention import gqa_attention  # ops/attention.py imports this module

    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = D**-0.5
    qs = (q.float() * scale).to(q.dtype)
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    mask = torch.where(causal, 0.0, torch.finfo(torch.float32).min)[None, None]
    return gqa_attention(qs.view(B, T, Hkv, H // Hkv, D), k, v, mask, 1.0, softcap=softcap, f32_pv=True)


# C signature of `flash_prefill` in csrc/flash_prefill.cu.
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
             + [ctypes.c_void_p])

# The kernel's work-item counter, one int32 per (device, stream): zeroed once, left 0 by every
# launch (its last claim resets it), so launches in one stream share it in turn.
_NEXT: dict = {}


def _next_counter(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _NEXT:
        _NEXT[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _NEXT[key]


def flash_prefill(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention of a prompt to its own keys from position 0, out
    [B, T, H * D] in q's dtype (see the module docstring). Replaces the splash
    kernel of `quanto_tpu/ops/attention.py:206 try_flash_prefill`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, softcap=softcap, scale=scale)
    B, T, H, D = q.shape
    if D not in _KERNEL_D:
        raise NotImplementedError(f"flash_prefill: the kernel takes head dims {_KERNEL_D}, got {D}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_prefill: q, k and v must be on one device")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_prefill: softcap must be positive, got {softcap}")
    out = torch.empty((B, T, H * D), dtype=q.dtype, device=q.device)
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = kernel("flash_prefill", _ARGTYPES)(
        device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _next_counter(torch.device("cuda", device), stream).data_ptr(), B, T, H, k.shape[2], D,
        int(q.dtype == torch.float32), D**-0.5 if scale is None else float(scale), float(softcap or 0.0), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: cudaError {rc}")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
