"""Fused 8-bit weight-only matmul: the Hopper kernel, its plain version and
its launch counts.

Counterpart of `quanto_tpu/ops/pallas/qbytes_mm.py`. One CUDA kernel in
`quanto_tpu_torch/csrc/qbytes_mm.cu`, templated on the payload, computes

    y[M, N] = (x[M, K] @ w[N, K]^T) * scale[N]^T      (M <= MAX_M)

with float32 sums and the per-output-channel scale applied to the output, in
x's dtype. Its two payloads have a wrapper and a launch count each:
- `qbytes_mm_int8` replaces the TPU kernel `_kernel` (int8 weights);
- `qbytes_mm_e4m3fn` replaces `_fp8_kernel` (float8 e4m3fn weights).

`eligible` is the envelope of both TPU kernels
(`quanto_tpu/ops/pallas/qbytes_mm.py:154-168`, `:189-202`); `ops/qlinear.py`
takes the JAX package's XLA formula (`ops/qbytes_mm.py:qbytes_mm`) outside it.
Each wrapper takes the plain PyTorch version (`qbytes_mm_plain`) when x lies
on the CPU; on a CUDA tensor it launches the kernel or raises. Where the card
would be short of blocks (decode, narrow N) the kernel splits K: the wrapper
allocates a float32 workspace of the size the C side plans
(`qbytes_mm_workspace`) and a last pass sums the splits in a fixed order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import kernel


__all__ = ["MAX_M", "eligible", "qbytes_mm_plain", "qbytes_mm_int8", "qbytes_mm_e4m3fn", "qbytes_mm"]

# The TPU kernels keep all of x in VMEM, which bounds M; prefill takes the XLA route.
MAX_M = 256

_PAYLOADS = (torch.int8, torch.float8_e4m3fn)
_FLOATS = (torch.bfloat16, torch.float32)


def eligible(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> bool:
    """True when the kernels take x [..., K] against w [N, K] with scale [N, 1]:
    an int8 or e4m3fn payload, N and K multiples of 128, bf16 or f32 x and
    scale, M = prod(lead dims) <= MAX_M."""
    if w.dim() != 2 or w.dtype not in _PAYLOADS or tuple(scale.shape) != (w.shape[0], 1):
        return False
    N, K = w.shape
    if N % 128 or K % 128 or x.shape[-1] != K:
        return False
    if x.dtype not in _FLOATS or scale.dtype not in _FLOATS:
        return False
    return 1 <= x.numel() // K <= MAX_M


def qbytes_mm_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: `x.float() @ w.float().T`, times the scale
    in float32, cast to x's dtype. x [M, K] -> [M, N]."""
    return ((x.float() @ w.float().t()) * scale.float().t()).to(x.dtype)


# C signatures of the entry points in csrc/qbytes_mm.cu: device, x, w, scale, out, workspace, M, N,
# K, x_bf16, scale_bf16, w_e4m3, stream; and device, M, N, K, x_f32, the 4-byte elements (out).
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_WS_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]


@functools.lru_cache(maxsize=None)
def _workspace_floats(device: int, M: int, N: int, K: int, x_f32: bool) -> int:
    """4-byte elements of the workspace of a launch at these shapes on
    `device`: the split-K partials where the kernel splits K, else 0."""
    n = ctypes.c_longlong()
    rc = kernel("qbytes_mm_workspace", _WS_ARGTYPES)(device, M, N, K, int(x_f32), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"qbytes_mm workspace query failed: cudaError {rc}")
    return n.value


def _run(name: str, payload: torch.dtype, x, w, scale):
    """Validate the operands, then launch the kernel (CUDA) or compute its plain
    version (CPU); returns (out, launched)."""
    if w.dtype != payload:
        raise TypeError(f"{name}: w must be {payload}, got {w.dtype}")
    if x.dim() != 2 or not eligible(x, w, scale):
        raise ValueError(
            f"{name}: outside the kernel's envelope: x {tuple(x.shape)} {x.dtype}, "
            f"w {tuple(w.shape)}, scale {tuple(scale.shape)} {scale.dtype}"
        )
    if x.device.type == "cpu":
        return qbytes_mm_plain(x, w, scale), False
    tensors = (x, w, scale)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and w must be 16-byte aligned")
    (M, K), N = x.shape, w.shape[0]
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    # Freed on return: the caching allocator hands the block only to later work on this stream,
    # which runs after both passes.
    n_ws = _workspace_floats(device, M, N, K, x.dtype == torch.float32)
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device) if n_ws else None
    rc = kernel("qbytes_mm", _ARGTYPES)(
        device, x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K,
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
        int(payload == torch.float8_e4m3fn), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out, True


def qbytes_mm_int8(x, w, scale) -> torch.Tensor:
    """x [M, K] @ w_int8[N, K]^T * scale[N, 1]^T -> [M, N] in x's dtype.
    Replaces `quanto_tpu/ops/pallas/qbytes_mm.py:_kernel`."""
    out, launched = _run("qbytes_mm_int8", torch.int8, x, w, scale)
    qbytes_mm_int8.launches += launched
    return out


def qbytes_mm_e4m3fn(x, w, scale) -> torch.Tensor:
    """x [M, K] @ w_e4m3fn[N, K]^T * scale[N, 1]^T -> [M, N] in x's dtype.
    Replaces `quanto_tpu/ops/pallas/qbytes_mm.py:_fp8_kernel`."""
    out, launched = _run("qbytes_mm_e4m3fn", torch.float8_e4m3fn, x, w, scale)
    qbytes_mm_e4m3fn.launches += launched
    return out


qbytes_mm_int8.launches = 0
qbytes_mm_e4m3fn.launches = 0


def qbytes_mm(x, w, scale) -> torch.Tensor:
    """y[..., N] = x[..., K] @ w^T * scale^T through the wrapper of w's payload
    (inside `eligible`), as `qbytes_matmul_kernel_call` and
    `qbytes_fp8_matmul_kernel_call` run it."""
    lead = x.shape[:-1]
    wrapper = qbytes_mm_int8 if w.dtype == torch.int8 else qbytes_mm_e4m3fn
    out = wrapper(x.reshape(-1, x.shape[-1]).contiguous(), w, scale)
    return out.reshape(*lead, w.shape[0])
