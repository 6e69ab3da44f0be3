"""Stacked-expert int4/int2 matmuls (the MoE kernels): the Hopper kernels, their
plain version and their launch counts.

Counterpart of `quanto_tpu/ops/pallas/moe_mm.py`. Two kernels compute, for
each slot u of a [U, M, K] activation,

    out[u] = x[u] @ deq(W[e_u])^T   in float32,   e_u = eids[u] (u without a table),

over a stacked weight in the Hopper layout of `WeightQBitsHopperArray`:
`packed` uint8 [E, N, K * bits / 8], `scale_t`/`shift_t` float32 [E, G, N],
int4 or int2 codes (`bits`; every M takes the kernels at either width: the
JAX MoE kernels have no int2 gate on M).
- `qbits_moe_small_m` (M <= `MAX_M`; `csrc/moe_mm.cu`, the tensor-core
  small-M body of `csrc/small_m_tc.cuh` per slot) replaces the TPU kernels
  `_moe_sel_kernel`, `_moe_all_kernel` and `_moe_uniq_kernel`;
- `qbits_moe_tiled` (any M) replaces `_moe_prefill_kernel` and
  `_moe_prefill_uniq_kernel`: above 16 rows the pipelined tensor-core GEMM of
  `csrc/moe_gemm.cu`, at M <= 16 (a decode step's down projection, each slot
  its own rows) the same per-slot body as `qbits_moe_small_m`.

x's slots may share their rows (slot stride 0, the all and uniq forms) or
each hold their own (the selective form and the batched-expert GEMM). With
`nslots`, an int32 scalar on x's device, the slots at or past it give zeros
and read no weight: the routed-expert table of
`parallel/moe.py:StackedSparseMoeBlock` counts its experts on the device, so
no host sync decides how many slots run.

The three entry points keep the semantics of the JAX calls:
`qbits_moe_sel` (`qbits_moe_sel_call`), `qbits_moe_all`
(`qbits_moe_all_call`) and `qbits_moe_prefill` (`qbits_moe_prefill_call`).

Each wrapper takes the plain PyTorch version `qbits_moe_plain` when x lies on
the CPU; on a CUDA tensor it launches its kernel or raises. Each wrapper's
`launches` attribute counts its kernel launches, of either width, and
`launches_int2` those of its int2 arm; `qbits_moe_tiled` also counts its
M <= 16 arm (TPU #15 on the main path) in `launches_small_m` and
`launches_small_m_int2`. Expert ids must lie in
[0, E): the kernels read them on the device and do not check them.
`qbits_moe_all` also counts, in its own `launches`, the calls of TPU #12's
form (every expert, no table) that launched `qbits_moe_small_m`'s kernel.
The per-slot tensor-core body takes a workspace the wrapper allocates at the
size the C side plans (`qbits_moe_small_m_workspace`): from M = 33 a first
pass sums x over each 64 values, and where the card would be short of blocks
K is split and a last pass sums the splits in a fixed order. `qbits_moe_tiled`
at M > 16 with float32 x takes a workspace of x's bytes: a first pass of the
same call splits x into the bf16 high and low planes the tensor cores
multiply.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import kernel
from .qbits_mm import MAX_M, dequantize_k_codes


__all__ = [
    "SEL_MAX",
    "qbits_moe_plain",
    "qbits_moe_small_m",
    "qbits_moe_tiled",
    "qbits_moe_sel",
    "qbits_moe_all",
    "qbits_moe_prefill",
]

# Most (token, expert) pairs the selective route takes: the JAX package's `_SEL_MAX`.
SEL_MAX = 32


def qbits_moe_plain(
    x3, packed, scale_t, shift_t, group_size: int, bits: int = 4, eids=None, nslots=None
) -> torch.Tensor:
    """Plain version of both kernels: each slot's expert dequantized in
    float32, `x3[u].float() @ w.T`; slots at or past `nslots` are zeros.
    x3 [U, M, K] -> float32 [U, M, N]."""
    U = x3.shape[0]
    ids = eids.long() if eids is not None else torch.arange(U, device=x3.device)
    w = dequantize_k_codes(packed[ids], scale_t[ids], shift_t[ids], group_size, bits)
    out = torch.bmm(x3.float(), w.transpose(1, 2))
    if nslots is not None:
        live = torch.arange(U, device=x3.device) < nslots.reshape(())
        out = torch.where(live[:, None, None], out, 0.0)
    return out


# --- wrappers ---------------------------------------------------------------

# C signatures in csrc/moe_mm.cu: device, x, x_slot_stride, eids, nslots, packed, scale_t,
# shift_t, out, workspace, U, M, N, K, gs, bits, x_bf16, stream; `qbits_moe_tiled` also takes the
# stacked weight's expert count E after the workspace. `qbits_moe_small_m_workspace`: device, U,
# M, N, K, gs, x_f32, shared_rows, the 4-byte elements (out).
_ARGTYPES = {
    "qbits_moe_small_m": (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.c_void_p]
    ),
    "qbits_moe_tiled": (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.c_void_p]
    ),
}
_WS_ARGTYPES = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)]


@functools.lru_cache(maxsize=None)
def _small_m_workspace_floats(device: int, U: int, M: int, N: int, K: int, group_size: int, x_f32: bool,
                              shared_rows: bool) -> int:
    """4-byte elements of the workspace of a `qbits_moe_small_m` launch at
    these shapes on `device` (the first pass's sums of x, one set for rows
    the slots share, and the split-K partials; 0: neither), as
    csrc/moe_mm.cu plans it."""
    n = ctypes.c_longlong()
    rc = kernel("qbits_moe_small_m_workspace", _WS_ARGTYPES)(
        device, U, M, N, K, group_size, int(x_f32), int(shared_rows), ctypes.byref(n)
    )
    if rc != 0:
        raise RuntimeError(f"qbits_moe_small_m workspace query failed: cudaError {rc}")
    return n.value


def _check(name, x3, packed, scale_t, shift_t, group_size, bits, eids, nslots):
    """Validate the operands both kernels take; returns (U, M, N, K)."""
    if bits not in (2, 4):
        raise ValueError(f"{name}: bits must be 2 or 4, got {bits}")
    if x3.dim() != 3 or packed.dim() != 3 or scale_t.dim() != 3 or shift_t.dim() != 3:
        raise ValueError(f"{name}: x, packed, scale_t and shift_t must be 3-D")
    U, M, K = x3.shape
    E, N, Kp = packed.shape
    if Kp * 8 != K * bits:
        raise ValueError(f"{name}: packed {tuple(packed.shape)} does not match K = {K} at {bits} bits")
    if group_size <= 0 or K % group_size or group_size % 64:
        raise ValueError(f"{name}: group size {group_size} must divide K = {K} and be a multiple of 64")
    G = K // group_size
    if tuple(scale_t.shape) != (E, G, N) or tuple(shift_t.shape) != (E, G, N):
        raise ValueError(f"{name}: scale_t/shift_t must be [{E}, {G}, {N}]")
    if N % 128 or M < 1 or U < 1:
        raise ValueError(f"{name}: N = {N} must be a multiple of 128, M = {M} and U = {U} >= 1")
    if x3.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be bfloat16 or float32, got {x3.dtype}")
    if packed.dtype != torch.uint8 or scale_t.dtype != torch.float32 or shift_t.dtype != torch.float32:
        raise TypeError(f"{name}: packed must be uint8 and scale_t/shift_t float32")
    if eids is None and U != E:
        raise ValueError(f"{name}: without an expert table there must be one slot per expert ({E}), got {U}")
    if eids is not None and (eids.dtype != torch.int32 or tuple(eids.shape) != (U,)):
        raise ValueError(f"{name}: eids must be int32 [{U}]")
    if nslots is not None and (nslots.dtype != torch.int32 or nslots.numel() != 1):
        raise ValueError(f"{name}: nslots must be one int32 value")
    return U, M, N, K


def _run(wrapper, name, x3, packed, scale_t, shift_t, group_size, bits, eids, nslots):
    """Launch the C entry point `name` into a new float32 [U, M, N] output,
    counted in `wrapper.launches` (and `launches_int2`), or compute the plain
    version on a CPU tensor."""
    U, M, N, K = _check(name, x3, packed, scale_t, shift_t, group_size, bits, eids, nslots)
    if x3.device.type == "cpu":
        return qbits_moe_plain(x3, packed, scale_t, shift_t, group_size, bits, eids, nslots)
    tables = [t for t in (eids, nslots) if t is not None]
    if any(t.device != x3.device for t in (packed, scale_t, shift_t, *tables)):
        raise ValueError(f"{name}: all operands must be on one device")
    if not all(t.is_contiguous() for t in (packed, scale_t, shift_t, *tables)):
        raise ValueError(f"{name}: packed, scale_t, shift_t and the tables must be contiguous")
    if x3.stride(2) != 1 or (M > 1 and x3.stride(1) != K):
        raise ValueError(f"{name}: the rows of x must be contiguous")
    slot_stride = x3.stride(0) if U > 1 else 0
    if any(t.data_ptr() % 16 for t in (x3, packed, scale_t, shift_t)) or (slot_stride * x3.element_size()) % 16:
        raise ValueError(f"{name}: x, its slots, packed, scale_t and shift_t must be 16-byte aligned")
    device = x3.device.index if x3.device.index is not None else torch.cuda.current_device()
    out = torch.empty((U, M, N), dtype=torch.float32, device=x3.device)
    # The workspace, freed on return: the caching allocator hands the block only to later work on
    # this stream, which runs after every pass.
    small = name == "qbits_moe_small_m" or M <= 16
    if small:  # the per-slot tensor-core body: the first pass's sums of x and the split-K partials
        n_ws = _small_m_workspace_floats(device, U, M, N, K, group_size, x3.dtype == torch.float32,
                                         slot_stride == 0)
    else:
        # The GEMM with float32 x: its bf16 high and low planes, [2, U', M, K] (U' = 1 for
        # shared rows), the bytes of x's own float32 [U', M, K].
        n_ws = (1 if slot_stride == 0 else U) * M * K if x3.dtype == torch.float32 else 0
    extra = [packed.shape[0]] if name == "qbits_moe_tiled" else []
    ws = torch.empty(n_ws, dtype=torch.float32, device=x3.device) if n_ws else None
    rc = kernel(name, _ARGTYPES[name])(
        device, x3.data_ptr(), slot_stride,
        None if eids is None else eids.data_ptr(),
        None if nslots is None else nslots.data_ptr(),
        packed.data_ptr(), scale_t.data_ptr(), shift_t.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), *extra,
        U, M, N, K, group_size, bits, int(x3.dtype == torch.bfloat16),
        torch.cuda.current_stream(x3.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    wrapper.launches += 1
    wrapper.launches_int2 += bits == 2
    if name == "qbits_moe_tiled" and small:
        wrapper.launches_small_m += 1
        wrapper.launches_small_m_int2 += bits == 2
    return out


def qbits_moe_small_m(
    x3, packed, scale_t, shift_t, group_size: int, bits: int = 4, eids=None, nslots=None
) -> torch.Tensor:
    """out[u] = x3[u] @ deq(W[e_u])^T -> float32 [U, M, N], M <= MAX_M.
    Replaces `quanto_tpu/ops/pallas/moe_mm.py:_moe_sel_kernel`,
    `_moe_all_kernel` and `_moe_uniq_kernel`."""
    if x3.dim() == 3 and x3.shape[1] > MAX_M:
        raise ValueError(f"qbits_moe_small_m takes M <= {MAX_M}, got {x3.shape[1]}")
    return _run(qbits_moe_small_m, "qbits_moe_small_m", x3, packed, scale_t, shift_t, group_size, bits, eids, nslots)


def qbits_moe_tiled(
    x3, packed, scale_t, shift_t, group_size: int, bits: int = 4, eids=None, nslots=None
) -> torch.Tensor:
    """out[u] = x3[u] @ deq(W[e_u])^T -> float32 [U, M, N], any M.
    Replaces `quanto_tpu/ops/pallas/moe_mm.py:_moe_prefill_kernel` and
    `_moe_prefill_uniq_kernel`."""
    return _run(qbits_moe_tiled, "qbits_moe_tiled", x3, packed, scale_t, shift_t, group_size, bits, eids, nslots)


qbits_moe_small_m.launches = qbits_moe_small_m.launches_int2 = 0
qbits_moe_tiled.launches = qbits_moe_tiled.launches_int2 = 0
qbits_moe_tiled.launches_small_m = qbits_moe_tiled.launches_small_m_int2 = 0


# --- entry points (the JAX calls' semantics) -----------------------------------


def qbits_moe_sel(x_sel, eids, packed, scale_t, shift_t, group_size: int, bits: int = 4) -> torch.Tensor:
    """out[i] = x_sel[i] @ deq(W[eids[i]])^T, reading only the selected
    experts: x_sel [nsel, K] with nsel <= SEL_MAX, eids int32 [nsel] ->
    float32 [nsel, N] (`qbits_moe_sel_call`, `moe_mm.py:148`)."""
    if x_sel.shape[0] > SEL_MAX:
        raise ValueError(f"qbits_moe_sel takes at most {SEL_MAX} pairs, got {x_sel.shape[0]}")
    x_sel = x_sel.contiguous()
    return qbits_moe_small_m(x_sel[:, None, :], packed, scale_t, shift_t, group_size, bits, eids=eids)[:, 0]


def qbits_moe_all(
    x, packed, scale_t, shift_t, group_size: int, bits: int = 4,
    eids: Optional[torch.Tensor] = None, nslots: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[e] = x @ deq(W[e])^T for every expert: x [S, K], S <= MAX_M ->
    float32 [E, S, N] (`qbits_moe_all_call`, `moe_mm.py:287`). With `eids`
    int32 [U], the unique-expert route: slot u against W[eids[u]] ->
    [U, S, N]; with `nslots` as well, the slots at or past it are zeros."""
    U = eids.shape[0] if eids is not None else packed.shape[0]
    x = x.contiguous()
    launches = getattr(qbits_moe_small_m, "launches", 0)
    out = qbits_moe_small_m(x.expand(U, *x.shape), packed, scale_t, shift_t, group_size, bits, eids, nslots)
    if eids is None:  # TPU #12's own form: every expert over the same rows, no table
        qbits_moe_all.launches += getattr(qbits_moe_small_m, "launches", 0) - launches
    return out


qbits_moe_all.launches = 0


def qbits_moe_prefill(
    xg, packed, scale_t, shift_t, group_size: int, bits: int = 4,
    eids: Optional[torch.Tensor] = None, nslots: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[e] = xg[e] @ deq(W[e])^T over per-expert token slabs xg [E, cap, K]
    -> float32 [E, cap, N] (`qbits_moe_prefill_call`, `moe_mm.py:429`). With
    `eids` int32 [U] (U == xg.shape[0]): slot u against W[eids[u]]; with
    `nslots` as well, the slots at or past it are zeros."""
    return qbits_moe_tiled(xg.contiguous(), packed, scale_t, shift_t, group_size, bits, eids, nslots)
