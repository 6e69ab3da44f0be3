"""Fused int4 group-wise dequant matmul: the Hopper kernels, their plain
versions and their launch counts.

Counterpart of `quanto_tpu/ops/pallas/qbits_mm.py`. Four CUDA kernels in
`quanto_tpu_torch/csrc/qbits_mm.cu` compute

    y[M, N] = x[M, K] @ deq(W)^T,   deq(W)[n, k] = s[g, n] * c[n, k] - z[g, n]

for float x:
- `qbits_mm_small_m` (M <= `MAX_M`) replaces the TPU decode kernel `_kernel`;
- `qbits_mm_tiled` (M > `MAX_M`) replaces the TPU prefill kernel `_prefill_kernel`;

and for W4A8, int8 x `xq` with a per-tensor scale `sx` (a 0-d float32 tensor
that stays on the device), `y = sx * (xq @ deq(W)^T)` in the weight's float
dtype:
- `qbits_mm_int8_small_m` (M <= `MAX_M`) replaces `_int8_kernel`;
- `qbits_mm_tiled_int8` (M > `MAX_M`) replaces the integer arm of
  `_prefill_kernel`.

The weight is in the Hopper layout of `WeightQBitsHopperArray`: `packed`
uint8 [N, K/2] with the two codes of byte j at K positions 2j (low nibble) and
2j + 1 (high nibble), `scale_t`/`shift_t` float32 [G, N].

Each wrapper takes its kernel's plain PyTorch version (`qbits_mm_plain`,
`qbits_int8_mm_plain`) when x lies on the CPU; on a CUDA tensor it launches
the kernel or raises. Each wrapper's `launches` attribute counts its kernel
launches.

The kernels are built with `nvcc` into `quanto_tpu_torch/build/` at first use
(`ops/cuda/_build.py:build`), as a shared library with a plain C interface
bound by `ctypes`.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import kernel


__all__ = [
    "MAX_M",
    "pack_k_nibbles",
    "unpack_k_nibbles",
    "dequantize_k_nibbles",
    "qbits_mm_plain",
    "qbits_mm_small_m",
    "qbits_mm_tiled",
    "qbits_mm",
    "qbits_int8_mm_plain",
    "qbits_mm_int8_small_m",
    "qbits_mm_tiled_int8",
    "qbits_int8_mm",
]

# Routing threshold between the two kernels: the JAX package's `_MAX_M`, so
# each TPU kernel maps to one Hopper kernel.
MAX_M = 512


def pack_k_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes [N, K] in [0, 15] -> the Hopper layout uint8 [N, K/2]:
    byte j holds code 2j in its low nibble and code 2j + 1 in its high nibble."""
    codes = codes.to(torch.uint8)
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).contiguous()


def unpack_k_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_k_nibbles`: uint8 [N, K/2] -> uint8 codes [N, K]."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)


def dequantize_k_nibbles(
    packed: torch.Tensor, scale_t: torch.Tensor, shift_t: torch.Tensor, group_size: int
) -> torch.Tensor:
    """The Hopper layout dequantized in float32: [N, K], scale * code - shift."""
    codes = unpack_k_nibbles(packed).float()
    N, K = codes.shape
    G = K // group_size
    w = codes.view(N, G, group_size) * scale_t.t().unsqueeze(-1) - shift_t.t().unsqueeze(-1)
    return w.view(N, K)


def qbits_mm_plain(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale_t: torch.Tensor,
    shift_t: torch.Tensor,
    group_size: int,
) -> torch.Tensor:
    """Plain version of both kernels: unpack, dequantize in float32,
    `x.float() @ w.T`, cast to x's dtype. x [M, K] -> [M, N]."""
    w = dequantize_k_nibbles(packed, scale_t, shift_t, group_size)
    return (x.float() @ w.t()).to(x.dtype)


# --- wrappers ---------------------------------------------------------------

# C signature of both entry points in csrc/qbits_mm.cu.
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(x, packed, scale_t, shift_t, group_size):
    """Validate the operands a float-x kernel takes; returns (M, N, K)."""
    M, N, K = _check_shapes(x, packed, scale_t, shift_t, group_size)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qbits_mm: x must be bfloat16 or float32, got {x.dtype}")
    return M, N, K


def _check_shapes(x, packed, scale_t, shift_t, group_size):
    """Shapes and weight dtypes every kernel of this module takes; returns (M, N, K)."""
    if x.dim() != 2 or packed.dim() != 2 or scale_t.dim() != 2 or shift_t.dim() != 2:
        raise ValueError("qbits_mm: x, packed, scale_t and shift_t must be 2-D")
    M, K = x.shape
    N = packed.shape[0]
    if packed.shape[1] * 2 != K:
        raise ValueError(f"qbits_mm: packed {tuple(packed.shape)} does not match K = {K}")
    if group_size <= 0 or K % group_size or group_size % 64:
        raise ValueError(f"qbits_mm: group size {group_size} must divide K = {K} and be a multiple of 64")
    G = K // group_size
    if tuple(scale_t.shape) != (G, N) or tuple(shift_t.shape) != (G, N):
        raise ValueError(f"qbits_mm: scale_t/shift_t must be [{G}, {N}]")
    if N % 128 or M < 1:
        raise ValueError(f"qbits_mm: N = {N} must be a multiple of 128 and M = {M} >= 1")
    if packed.dtype != torch.uint8 or scale_t.dtype != torch.float32 or shift_t.dtype != torch.float32:
        raise TypeError("qbits_mm: packed must be uint8 and scale_t/shift_t float32")
    return M, N, K


def _launch(name, argtypes, operands, out_dtype, M, N, K, group_size):
    """Launch the C entry point `name` on `operands` (x, packed, scale_t,
    shift_t and, for int8 x, sx) into a new [M, N] output; raises on a
    refused launch."""
    x, packed = operands[0], operands[1]
    if any(t.device != x.device for t in operands):
        raise ValueError(f"{name}: all operands must be on one device")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError(f"{name}: x and packed must be 16-byte aligned")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    rc = kernel(name, argtypes)(
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        *(t.data_ptr() for t in operands), out.data_ptr(),
        M, N, K, group_size, int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out


def qbits_mm_small_m(x, packed, scale_t, shift_t, group_size: int) -> torch.Tensor:
    """x [M, K] @ deq(W)^T -> [M, N] in x's dtype, M <= MAX_M. Replaces
    `quanto_tpu/ops/pallas/qbits_mm.py:_kernel`."""
    M, N, K = _check(x, packed, scale_t, shift_t, group_size)
    if M > MAX_M:
        raise ValueError(f"qbits_mm_small_m takes M <= {MAX_M}, got {M}")
    if x.device.type == "cpu":
        return qbits_mm_plain(x, packed, scale_t, shift_t, group_size)
    out = _launch("qbits_mm_small_m", _ARGTYPES, (x, packed, scale_t, shift_t), x.dtype, M, N, K, group_size)
    qbits_mm_small_m.launches += 1
    return out


def qbits_mm_tiled(x, packed, scale_t, shift_t, group_size: int) -> torch.Tensor:
    """x [M, K] @ deq(W)^T -> [M, N] in x's dtype, any M (routed at M > MAX_M).
    Replaces `quanto_tpu/ops/pallas/qbits_mm.py:_prefill_kernel`."""
    M, N, K = _check(x, packed, scale_t, shift_t, group_size)
    if x.device.type == "cpu":
        return qbits_mm_plain(x, packed, scale_t, shift_t, group_size)
    out = _launch("qbits_mm_tiled", _ARGTYPES, (x, packed, scale_t, shift_t), x.dtype, M, N, K, group_size)
    qbits_mm_tiled.launches += 1
    return out


qbits_mm_small_m.launches = 0
qbits_mm_tiled.launches = 0


def qbits_mm(x, packed, scale_t, shift_t, group_size: int) -> torch.Tensor:
    """y[..., N] = x[..., K] @ deq(W)^T, routed by M = prod(lead dims) as
    `qbits_matmul_kernel_call` routes (`quanto_tpu/ops/pallas/qbits_mm.py:777`)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    wrapper = qbits_mm_small_m if x2.shape[0] <= MAX_M else qbits_mm_tiled
    out = wrapper(x2, packed, scale_t, shift_t, group_size)
    return out.reshape(*lead, packed.shape[0])


# --- W4A8: int8 x ---------------------------------------------------------------


def qbits_int8_mm_plain(xq, sx, packed, scale_t, shift_t, group_size: int, out_dtype) -> torch.Tensor:
    """Plain version of both int8-x kernels, group-factored as they are:
    y = sx * sum_g [s_g * (xq_g @ c_g^T) - z_g * sum(xq_g)] in float32, cast to
    `out_dtype`. Each group's integer product is exact in float32 while
    128 * 15 * group_size < 2**24. xq [M, K] int8 -> [M, N]."""
    M, K = xq.shape
    G = K // group_size
    xg = xq.float().view(M, G, group_size)
    cg = unpack_k_nibbles(packed).float().view(-1, G, group_size)
    y = torch.zeros((M, packed.shape[0]), dtype=torch.float32, device=xq.device)
    for g in range(G):
        acc = xg[:, g] @ cg[:, g].t()
        y += acc * scale_t[g] - xg[:, g].sum(-1, keepdim=True) * shift_t[g]
    return (y * sx.float()).to(out_dtype)


# C signature of both int8-x entry points in csrc/qbits_mm.cu.
_INT8_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _run_int8(name, xq, sx, packed, scale_t, shift_t, group_size, out_dtype):
    """Validate the operands of an int8-x kernel, then launch it (CUDA) or
    compute its plain version (CPU); returns (out, launched)."""
    if xq.dtype != torch.int8:
        raise TypeError(f"{name}: x must be int8, got {xq.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the output dtype must be bfloat16 or float32, got {out_dtype}")
    if sx.numel() != 1 or sx.dtype != torch.float32 or sx.device != xq.device:
        raise ValueError(f"{name}: sx must be one float32 value on x's device")
    M, N, K = _check_shapes(xq, packed, scale_t, shift_t, group_size)
    if xq.device.type == "cpu":
        return qbits_int8_mm_plain(xq, sx, packed, scale_t, shift_t, group_size, out_dtype), False
    operands = (xq, packed, scale_t, shift_t, sx.reshape(()))
    return _launch(name, _INT8_ARGTYPES, operands, out_dtype, M, N, K, group_size), True


def qbits_mm_int8_small_m(xq, sx, packed, scale_t, shift_t, group_size: int, out_dtype) -> torch.Tensor:
    """sx * (xq [M, K] @ deq(W)^T) -> [M, N] in `out_dtype`, M <= MAX_M.
    Replaces `quanto_tpu/ops/pallas/qbits_mm.py:_int8_kernel`."""
    if xq.dim() == 2 and xq.shape[0] > MAX_M:
        raise ValueError(f"qbits_mm_int8_small_m takes M <= {MAX_M}, got {xq.shape[0]}")
    out, launched = _run_int8(
        "qbits_mm_int8_small_m", xq, sx, packed, scale_t, shift_t, group_size, out_dtype
    )
    qbits_mm_int8_small_m.launches += launched
    return out


def qbits_mm_tiled_int8(xq, sx, packed, scale_t, shift_t, group_size: int, out_dtype) -> torch.Tensor:
    """sx * (xq [M, K] @ deq(W)^T) -> [M, N] in `out_dtype`, any M (routed at
    M > MAX_M). Replaces the integer arm of
    `quanto_tpu/ops/pallas/qbits_mm.py:_prefill_kernel`."""
    out, launched = _run_int8(
        "qbits_mm_tiled_int8", xq, sx, packed, scale_t, shift_t, group_size, out_dtype
    )
    qbits_mm_tiled_int8.launches += launched
    return out


qbits_mm_int8_small_m.launches = 0
qbits_mm_tiled_int8.launches = 0


def qbits_int8_mm(xq, sx, packed, scale_t, shift_t, group_size: int, out_dtype) -> torch.Tensor:
    """W4A8: y[..., N] = sx * (xq[..., K] @ deq(W)^T) in `out_dtype`, routed by
    M = prod(lead dims) as `qbits_int8_matmul_kernel_call` routes
    (`quanto_tpu/ops/pallas/qbits_mm.py:665-726`)."""
    lead = xq.shape[:-1]
    x2 = xq.reshape(-1, xq.shape[-1]).contiguous()
    wrapper = qbits_mm_int8_small_m if x2.shape[0] <= MAX_M else qbits_mm_tiled_int8
    out = wrapper(x2, sx, packed, scale_t, shift_t, group_size, out_dtype)
    return out.reshape(*lead, packed.shape[0])
