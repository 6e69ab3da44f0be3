"""Fused int4/int2 group-wise dequant matmul: the Hopper kernels, their plain
versions and their launch counts.

Counterpart of `quanto_tpu/ops/pallas/qbits_mm.py`. CUDA kernels in
`quanto_tpu_torch/csrc/qbits_mm_small_m.cu` (M <= `MAX_M`, on the tensor cores)
and `quanto_tpu_torch/csrc/qbits_mm.cu` (larger M) compute

    y[M, N] = x[M, K] @ deq(W)^T,   deq(W)[n, k] = s[g, n] * c[n, k] - z[g, n]

for float x, with int4 or int2 codes (`bits`, each width its own
instantiation of the kernel):
- `qbits_mm_small_m` (M <= `MAX_M`) replaces the TPU decode kernel `_kernel`;
- `qbits_mm_tiled` (M > `MAX_M`) replaces the TPU prefill kernel `_prefill_kernel`;

and for W4A8 and W2A8, int8 x `xq` with a per-tensor scale `sx` (a 0-d
float32 tensor that stays on the device), `y = sx * (xq @ deq(W)^T)` in the
weight's float dtype, with int4 or int2 codes (`bits`, as above):
- `qbits_mm_int8_small_m` (M <= `MAX_M`) replaces `_int8_kernel`;
- `qbits_mm_tiled_int8` (M > `MAX_M`) replaces the integer arm of
  `_prefill_kernel`;
- `qbits_mm_requant_int8` (M >= `INT8_DOT_MIN_M`, weights in the requant
  form of `WeightQBitsRequantArray`) replaces `_int8pc_kernel`. It is
  approximate: each weight tile is requantized to per-channel int8 codes
  `c8 = clip(round(c * s_g/s8 - z_g/s8), -127, 127)` with the per-channel
  step `s8` (`requant_step`), and `y = sx * s8 * (xq @ c8^T)` with one int32
  sum over the whole K.

The weight is in the Hopper layout of `WeightQBitsHopperArray`: `packed`
uint8 [N, K * bits / 8] with K-contiguous codes, code k of a row at bits
`bits * (k % (8 / bits))` of byte `k // (8 / bits)` (int4: codes 2j, 2j + 1 in
the low and high nibble of byte j; int2: codes 4j .. 4j + 3 in its crumbs),
`scale_t`/`shift_t` float32 [G, N].

Each wrapper takes its kernel's plain PyTorch version (`qbits_mm_plain`,
`qbits_int8_mm_plain`, `qbits_requant_int8_mm_plain`) when x lies on the
CPU; on a CUDA tensor it launches the kernel or raises. Each wrapper's
`launches` attribute counts its kernel launches, of either width, and its
`launches_int2` those of its int2 arm. The two small-M kernels take a
workspace the wrapper allocates at the size the C side plans
(`qbits_mm_small_m_workspace`): from M = 33 (bf16 and int8 x) a first pass
of the same call sums x over each 64 values once, and where the card would
be short of blocks K is split over them and a last pass sums the splits in a
fixed order.

The kernels are built with `nvcc` into `quanto_tpu_torch/build/` at first use
(`ops/cuda/_build.py:build`), as a shared library with a plain C interface
bound by `ctypes`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import kernel


__all__ = [
    "MAX_M",
    "INT2_MAX_M",
    "INT8_DOT_MIN_M",
    "pack_k_codes",
    "unpack_k_codes",
    "dequantize_k_codes",
    "qbits_mm_plain",
    "qbits_mm_small_m",
    "qbits_mm_tiled",
    "qbits_mm",
    "qbits_int8_mm_plain",
    "qbits_mm_int8_small_m",
    "qbits_mm_tiled_int8",
    "requant_route",
    "requant_step",
    "requant_codes",
    "qbits_requant_int8_mm_plain",
    "qbits_mm_requant_int8",
    "qbits_int8_mm",
]

# Routing threshold between the two kernels: the JAX package's `_MAX_M`, so
# each TPU kernel maps to one Hopper kernel.
MAX_M = 512

# Largest M an int2 weight takes a kernel at: above it the JAX package's
# `_prefill_route` returns None for bits == 2 (`quanto_tpu/ops/pallas/
# qbits_mm.py:339-344`) and the caller runs dequantize + matmul.
INT2_MAX_M = 1024

# Least M of the W4A8 requant route: the JAX package's `_INT8_DOT_MIN_M`
# (`quanto_tpu/ops/pallas/qbits_mm.py:398`).
INT8_DOT_MIN_M = 2048


def pack_k_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 codes [N, K] in [0, 2**bits) -> the Hopper layout uint8
    [N, K * bits / 8]: byte j holds codes (8 / bits) * j + i at bits
    bits * i (int4: nibbles, int2: crumbs)."""
    per = 8 // bits
    codes = codes.to(torch.uint8)
    out = codes[:, 0::per].clone()
    for i in range(1, per):
        out |= codes[:, i::per] << (bits * i)
    return out.contiguous()


def unpack_k_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of `pack_k_codes`: uint8 [N, K * bits / 8] -> uint8 codes [N, K]."""
    mask = (1 << bits) - 1
    parts = [(packed >> (bits * i)) & mask for i in range(8 // bits)]
    return torch.stack(parts, dim=-1).reshape(packed.shape[0], -1)


def dequantize_k_codes(
    packed: torch.Tensor, scale_t: torch.Tensor, shift_t: torch.Tensor, group_size: int, bits: int
) -> torch.Tensor:
    """The Hopper layout dequantized in float32: [N, K], scale * code - shift."""
    codes = unpack_k_codes(packed, bits).float()
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
    bits: int = 4,
) -> torch.Tensor:
    """Plain version of both kernels: unpack, dequantize in float32,
    `x.float() @ w.T`, cast to x's dtype. x [M, K] -> [M, N]."""
    w = dequantize_k_codes(packed, scale_t, shift_t, group_size, bits)
    return (x.float() @ w.t()).to(x.dtype)


# --- wrappers ---------------------------------------------------------------

# `qbits_mm_small_m_workspace`: device, M, N, K, gs, x_f32, the 4-byte elements (out).
_WS_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]


@functools.lru_cache(maxsize=None)
def _workspace_floats(device: int, M: int, N: int, K: int, group_size: int, x_f32: bool) -> int:
    """4-byte elements of the workspace of a small-M launch at these shapes on
    `device` (its first pass's sums of x and its split-K partials; 0: neither),
    as csrc/qbits_mm_small_m.cu plans it."""
    n = ctypes.c_longlong()
    rc = kernel("qbits_mm_small_m_workspace", _WS_ARGTYPES)(
        device, M, N, K, group_size, int(x_f32), ctypes.byref(n)
    )
    if rc != 0:
        raise RuntimeError(f"qbits_mm_small_m workspace query failed: cudaError {rc}")
    return n.value


def _check(x, packed, scale_t, shift_t, group_size, bits):
    """Validate the operands a float-x kernel takes; returns (M, N, K)."""
    M, N, K = _check_shapes(x, packed, scale_t, shift_t, group_size, bits)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qbits_mm: x must be bfloat16 or float32, got {x.dtype}")
    return M, N, K


def _check_shapes(x, packed, scale_t, shift_t, group_size, bits):
    """Shapes and weight dtypes every kernel of this module takes; returns (M, N, K)."""
    if bits not in (2, 4):
        raise ValueError(f"qbits_mm: bits must be 2 or 4, got {bits}")
    if x.dim() != 2 or packed.dim() != 2 or scale_t.dim() != 2 or shift_t.dim() != 2:
        raise ValueError("qbits_mm: x, packed, scale_t and shift_t must be 2-D")
    M, K = x.shape
    N = packed.shape[0]
    if packed.shape[1] * 8 != K * bits:
        raise ValueError(f"qbits_mm: packed {tuple(packed.shape)} does not match K = {K} at {bits} bits")
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


def _launch(name, operands, out_dtype, M, N, K, group_size, bits, workspace=False):
    """Launch the C entry point `name` on `operands` (x, packed, scale_t,
    shift_t and, for int8 x, the requant route's s8 and sx) into a new [M, N]
    output, with the code width `bits`; with `workspace` (the small-M entry
    points) also on a new workspace. Every entry point of csrc/qbits_mm*.cu
    takes (device, those pointers, out[, workspace], M, N, K, gs, bits,
    bf16 flag, stream). Raises on a refused launch."""
    x, packed = operands[0], operands[1]
    if any(t.device != x.device for t in operands):
        raise ValueError(f"{name}: all operands must be on one device")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError(f"{name}: x and packed must be 16-byte aligned")
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ptrs = [t.data_ptr() for t in operands] + [out.data_ptr()]
    if workspace:
        # Freed on return: the caching allocator hands the block only to later work on this
        # stream, which runs after both passes.
        n_ws = _workspace_floats(device, M, N, K, group_size, x.dtype == torch.float32)
        ws = torch.empty(n_ws, dtype=torch.float32, device=x.device) if n_ws else None
        ptrs.append(ws.data_ptr() if ws is not None else None)
    argtypes = [ctypes.c_int] + [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = kernel(name, argtypes)(
        device, *ptrs, M, N, K, group_size, bits, int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out


def _count(wrapper, bits) -> None:
    """One launch of `wrapper`'s kernel, in `launches` and, for an int2
    weight, in `launches_int2`."""
    wrapper.launches += 1
    wrapper.launches_int2 += bits == 2


def _run_float(wrapper, name, x, packed, scale_t, shift_t, group_size, bits):
    """The plain version on a CPU tensor; on a CUDA tensor the launch of the
    C entry point `name`, counted on `wrapper`."""
    M, N, K = _check(x, packed, scale_t, shift_t, group_size, bits)
    if x.device.type == "cpu":
        return qbits_mm_plain(x, packed, scale_t, shift_t, group_size, bits)
    out = _launch(
        name, (x, packed, scale_t, shift_t), x.dtype, M, N, K, group_size, bits,
        workspace=name == "qbits_mm_small_m",
    )
    _count(wrapper, bits)
    return out


def qbits_mm_small_m(x, packed, scale_t, shift_t, group_size: int, bits: int = 4) -> torch.Tensor:
    """x [M, K] @ deq(W)^T -> [M, N] in x's dtype, M <= MAX_M, int4 or int2
    codes. Replaces `quanto_tpu/ops/pallas/qbits_mm.py:_kernel`."""
    if x.dim() == 2 and x.shape[0] > MAX_M:
        raise ValueError(f"qbits_mm_small_m takes M <= {MAX_M}, got {x.shape[0]}")
    return _run_float(qbits_mm_small_m, "qbits_mm_small_m", x, packed, scale_t, shift_t, group_size, bits)


def qbits_mm_tiled(x, packed, scale_t, shift_t, group_size: int, bits: int = 4) -> torch.Tensor:
    """x [M, K] @ deq(W)^T -> [M, N] in x's dtype, any M (routed at M > MAX_M),
    int4 or int2 codes. Replaces `quanto_tpu/ops/pallas/qbits_mm.py:_prefill_kernel`."""
    return _run_float(qbits_mm_tiled, "qbits_mm_tiled", x, packed, scale_t, shift_t, group_size, bits)


qbits_mm_small_m.launches = qbits_mm_small_m.launches_int2 = 0
qbits_mm_tiled.launches = qbits_mm_tiled.launches_int2 = 0


def qbits_mm(x, packed, scale_t, shift_t, group_size: int, bits: int = 4) -> torch.Tensor:
    """y[..., N] = x[..., K] @ deq(W)^T, routed by M = prod(lead dims) as
    `qbits_matmul_kernel_call` routes (`quanto_tpu/ops/pallas/qbits_mm.py:777`).
    An int2 weight above INT2_MAX_M takes no kernel in JAX: `ops/qlinear.py`
    routes it before this call."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    wrapper = qbits_mm_small_m if x2.shape[0] <= MAX_M else qbits_mm_tiled
    out = wrapper(x2, packed, scale_t, shift_t, group_size, bits)
    return out.reshape(*lead, packed.shape[0])


# --- W4A8: int8 x ---------------------------------------------------------------


def qbits_int8_mm_plain(xq, sx, packed, scale_t, shift_t, group_size: int, out_dtype, bits: int = 4) -> torch.Tensor:
    """Plain version of both int8-x kernels, group-factored as they are:
    y = sx * sum_g [s_g * (xq_g @ c_g^T) - z_g * sum(xq_g)] in float32, cast to
    `out_dtype`. Each group's integer product is exact in float32 while
    128 * (2**bits - 1) * group_size < 2**24. xq [M, K] int8 -> [M, N]."""
    M, K = xq.shape
    G = K // group_size
    xg = xq.float().view(M, G, group_size)
    cg = unpack_k_codes(packed, bits).float().view(-1, G, group_size)
    y = torch.zeros((M, packed.shape[0]), dtype=torch.float32, device=xq.device)
    for g in range(G):
        acc = xg[:, g] @ cg[:, g].t()
        y += acc * scale_t[g] - xg[:, g].sum(-1, keepdim=True) * shift_t[g]
    return (y * sx.float()).to(out_dtype)


def _check_int8(name, xq, sx, packed, scale_t, shift_t, group_size, out_dtype, bits):
    """Validate the operands every int8-x kernel takes; returns (M, N, K)."""
    if xq.dtype != torch.int8:
        raise TypeError(f"{name}: x must be int8, got {xq.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the output dtype must be bfloat16 or float32, got {out_dtype}")
    if sx.numel() != 1 or sx.dtype != torch.float32 or sx.device != xq.device:
        raise ValueError(f"{name}: sx must be one float32 value on x's device")
    return _check_shapes(xq, packed, scale_t, shift_t, group_size, bits)


def _run_int8(wrapper, name, xq, sx, packed, scale_t, shift_t, group_size, out_dtype, bits):
    """Validate the operands of an int8-x kernel, then compute its plain
    version (CPU) or launch it, counted on `wrapper` (CUDA)."""
    M, N, K = _check_int8(name, xq, sx, packed, scale_t, shift_t, group_size, out_dtype, bits)
    if xq.device.type == "cpu":
        return qbits_int8_mm_plain(xq, sx, packed, scale_t, shift_t, group_size, out_dtype, bits)
    operands = (xq, packed, scale_t, shift_t, sx.reshape(()))
    out = _launch(
        name, operands, out_dtype, M, N, K, group_size, bits, workspace=name == "qbits_mm_int8_small_m"
    )
    _count(wrapper, bits)
    return out


def qbits_mm_int8_small_m(xq, sx, packed, scale_t, shift_t, group_size: int, out_dtype, bits: int = 4):
    """sx * (xq [M, K] @ deq(W)^T) -> [M, N] in `out_dtype`, M <= MAX_M.
    Replaces `quanto_tpu/ops/pallas/qbits_mm.py:_int8_kernel`."""
    if xq.dim() == 2 and xq.shape[0] > MAX_M:
        raise ValueError(f"qbits_mm_int8_small_m takes M <= {MAX_M}, got {xq.shape[0]}")
    return _run_int8(
        qbits_mm_int8_small_m, "qbits_mm_int8_small_m", xq, sx, packed, scale_t, shift_t, group_size,
        out_dtype, bits,
    )


def qbits_mm_tiled_int8(xq, sx, packed, scale_t, shift_t, group_size: int, out_dtype, bits: int = 4):
    """sx * (xq [M, K] @ deq(W)^T) -> [M, N] in `out_dtype`, any M (routed at
    M > MAX_M). Replaces the integer arm of
    `quanto_tpu/ops/pallas/qbits_mm.py:_prefill_kernel`."""
    return _run_int8(
        qbits_mm_tiled_int8, "qbits_mm_tiled_int8", xq, sx, packed, scale_t, shift_t, group_size,
        out_dtype, bits,
    )


qbits_mm_int8_small_m.launches = qbits_mm_int8_small_m.launches_int2 = 0
qbits_mm_tiled_int8.launches = qbits_mm_tiled_int8.launches_int2 = 0


# --- W4A8 requant route: per-channel int8 weights, one int32 sum over K ------------


def requant_envelope(K: int, group_size: int) -> bool:
    """The shapes the requant kernel takes: the JAX route's envelope
    (`qbits_mm.py:534`), several groups of a multiple of 128 codes each."""
    return group_size % 128 == 0 and group_size != K


def requant_route(M: int, K: int, group_size: int, s8) -> bool:
    """Whether `qbits_int8_mm` takes the requant kernel: a weight in the
    requant form (its step `s8` given), M >= INT8_DOT_MIN_M and the route's
    envelope, at either code width. JAX's `qbits_int8_matmul_kernel_call`
    tries `_int8pc_route` first (`qbits_mm.py:694-704`), so an int2 weight
    takes it where `_prefill_route` would refuse M > INT2_MAX_M."""
    return s8 is not None and M >= INT8_DOT_MIN_M and requant_envelope(K, group_size)


def requant_step(scale_t: torch.Tensor, shift_t: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Per-channel int8 step s8 float32 [N] of an affine weight with float32
    scale_t/shift_t [G, N], as `_int8pc_call` computes it
    (`quanto_tpu/ops/pallas/qbits_mm.py:484-488`): the largest |deq| a code
    can take, amax = max_g max(|z|, |s * qmax - z|), then
    max(amax, 1e-30) * (1 / 127) as a float32 multiply."""
    s, z = scale_t.float(), shift_t.float()
    amax = torch.maximum(z.abs(), (s * float(2**bits - 1) - z).abs()).amax(dim=0)
    return amax.clamp_min(1e-30) * torch.tensor(1.0 / 127.0, dtype=torch.float32, device=amax.device)


def requant_codes(packed, scale_t, shift_t, s8, group_size: int, bits: int = 4) -> torch.Tensor:
    """The int8 codes [N, K] the requant route takes for the Hopper layout:
    c8 = clip(round(c * rs - rz), -127, 127) with rs = s / s8 and rz = z / s8
    per group (`qbits_mm.py:443-458`, `:489-490`), each operation rounded
    to float32 on its own, round half to even."""
    codes = unpack_k_codes(packed, bits).float()
    N, K = codes.shape
    G = K // group_size
    rs = (scale_t / s8).t().unsqueeze(-1)  # [N, G, 1]
    rz = (shift_t / s8).t().unsqueeze(-1)
    c8 = torch.round(codes.view(N, G, group_size) * rs - rz).clamp_(-127, 127)
    return c8.view(N, K).to(torch.int8)


def qbits_requant_int8_mm_plain(xq, sx, packed, scale_t, shift_t, s8, group_size: int, out_dtype, bits: int = 4):
    """Plain version of `qbits_mm_requant_int8`: the requant codes, their exact
    integer product with xq (a float64 matmul: |sum| <= 128 * 127 * K < 2**53),
    converted to float32, times s8, times sx, cast to `out_dtype`.
    xq [M, K] int8 -> [M, N]."""
    c8 = requant_codes(packed, scale_t, shift_t, s8, group_size, bits)
    acc = (xq.double() @ c8.double().t()).float()
    return (acc * s8 * sx.float()).to(out_dtype)


def qbits_mm_requant_int8(xq, sx, packed, scale_t, shift_t, s8, group_size: int, out_dtype, bits: int = 4):
    """sx * s8 * (xq [M, K] @ c8^T) -> [M, N] in `out_dtype`, c8 the requant
    codes of W (`requant_codes`), any M (routed at M >= INT8_DOT_MIN_M).
    Replaces `quanto_tpu/ops/pallas/qbits_mm.py:_int8pc_kernel`."""
    name = "qbits_mm_requant_int8"
    M, N, K = _check_int8(name, xq, sx, packed, scale_t, shift_t, group_size, out_dtype, bits)
    if not requant_envelope(K, group_size):
        raise ValueError(f"{name}: group size {group_size} must be a multiple of 128 and below K = {K}")
    if tuple(s8.shape) != (N,) or s8.dtype != torch.float32:
        raise ValueError(f"{name}: s8 must be float32 [{N}]")
    if xq.device.type == "cpu":
        return qbits_requant_int8_mm_plain(xq, sx, packed, scale_t, shift_t, s8, group_size, out_dtype, bits)
    operands = (xq, packed, scale_t, shift_t, s8, sx.reshape(()))
    out = _launch(name, operands, out_dtype, M, N, K, group_size, bits)
    _count(qbits_mm_requant_int8, bits)
    return out


qbits_mm_requant_int8.launches = qbits_mm_requant_int8.launches_int2 = 0


def qbits_int8_mm(xq, sx, packed, scale_t, shift_t, group_size: int, out_dtype, s8=None, bits: int = 4):
    """W4A8 and W2A8: y[..., N] = sx * (xq[..., K] @ deq(W)^T) in `out_dtype`,
    routed by M = prod(lead dims) and the weight's form as
    `qbits_int8_matmul_kernel_call` routes (`quanto_tpu/ops/pallas/
    qbits_mm.py:665-726`), int4 or int2 codes alike:
    - M <= MAX_M (512): `qbits_mm_int8_small_m`;
    - `requant_route` (a weight in the requant form, its per-channel step
      `s8` given, M >= INT8_DOT_MIN_M = 2048 and the route's envelope):
      `qbits_mm_requant_int8`, approximate;
    - otherwise: `qbits_mm_tiled_int8`, exact.
    An int2 weight off the requant route above INT2_MAX_M takes no kernel:
    `ops/qlinear.py` routes it before this call, as JAX's `_prefill_route`
    refuses it after `_int8pc_route`."""
    lead = xq.shape[:-1]
    x2 = xq.reshape(-1, xq.shape[-1]).contiguous()
    M, K = x2.shape
    args = (x2, sx, packed, scale_t, shift_t)
    if M <= MAX_M:
        out = qbits_mm_int8_small_m(*args, group_size, out_dtype, bits)
    elif requant_route(M, K, group_size, s8):
        out = qbits_mm_requant_int8(*args, s8, group_size, out_dtype, bits)
    else:
        out = qbits_mm_tiled_int8(*args, group_size, out_dtype, bits)
    return out.reshape(*lead, packed.shape[0])
