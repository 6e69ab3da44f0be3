"""Tensor-parallel dispatch of the int4/int2 matmul kernels.

Counterpart of `quanto_tpu/ops/pallas/qbits_mm_sharded.py:146
qbits_mm_partitioned` (TPU kernel #5). There a `custom_partitioning` wrapper
runs the sub-byte Pallas kernels per device on its local shards and XLA adds
only the collective the math needs. In the port the sharding is explicit
(Megatron-style): each rank holds its part of the weight
(`tensor/weights.py:shard_qbits`, recorded in the weight's `shard`), calls
the Hopper kernels of `ops/cuda/qbits_mm.py` on it, and sums partial
products with `torch.distributed.all_reduce` (`ops/collectives.py`), the
counterpart of XLA's psum:
- column (the weight's N sharded): each rank computes its own output
  columns, no collective;
- row (K sharded, whole groups): each rank computes a float32 partial
  product from its own K slice of x and the weight, then all_reduce;
- replicated: each rank computes the whole product (batch-parallel only);
  a weight zero-padded onto the envelope is only ever replicated, and x is
  padded and the output sliced around the kernel as `ops/qlinear.py` does.

No kernel of its own: what bounds it is its local kernel's bound (bytes at
decode, operations at prefill) plus the all_reduce of the [M, N] float32
partials of a row shard.
"""

from __future__ import annotations

import torch

from ...tensor.activations import ActivationQBytesArray
from ..collectives import all_reduce
from ...tensor.weights import WeightQBitsHopperArray, WeightQBitsRequantArray
from .qbits_mm import INT2_MAX_M, qbits_int8_mm, qbits_int8_mm_plain, qbits_mm, qbits_mm_plain


__all__ = ["qbits_mm_partitioned"]


def _kernel_route(x2: torch.Tensor, w) -> bool:
    """Whether the rank's part takes a kernel: a Hopper-layout part (a part off
    the envelope stays generic), and for an int2 part M <= INT2_MAX_M, as
    JAX's `_local_mm` finds its kernel call refused above it."""
    return isinstance(w, WeightQBitsHopperArray) and (w.bits == 4 or x2.shape[0] <= INT2_MAX_M)


def _fallback(x2: torch.Tensor, w) -> torch.Tensor:
    """JAX's `_local_mm` fallback (`qbits_mm_sharded.py:66-73`): dequantize
    the local part in float32, x (float, or int8 codes) in float32."""
    return x2.float() @ w.dequantize(torch.float32).t()


def _unit_scale(device) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=device)


def _local_mm(x2: torch.Tensor, w) -> torch.Tensor:
    """One rank's product of x [M, K_local] with its part of the weight, float32
    [M, N_local], as `_local_mm` (`qbits_mm_sharded.py:40-72`): float x
    through `qbits_mm` in x's dtype, then cast up; int8 x through
    `qbits_int8_mm` with a unit activation scale and float32 output (the
    caller applies the scale after the sum). A CPU tensor takes the kernels'
    plain versions (the wrappers dispatch by device); on a CUDA tensor each
    call launches a kernel, counted in `qbits_mm_partitioned.launches`."""
    if not _kernel_route(x2, w):
        return _fallback(x2, w)
    args = (w._packed, w._scale_t, w._shift_t, w.kernel_group_size)
    xk = w.pad_activations(x2)
    if x2.dtype == torch.int8:
        out = qbits_int8_mm(xk, _unit_scale(x2.device), *args, torch.float32, bits=w.bits)
    else:
        out = qbits_mm(xk, *args, w.bits).float()
    qbits_mm_partitioned.launches += x2.is_cuda
    return w.slice_out(out)


def _local_mm_plain(x2: torch.Tensor, w) -> torch.Tensor:
    """The plain version of `_local_mm` on any device: the kernels' plain
    versions, no launch."""
    if not _kernel_route(x2, w):
        return _fallback(x2, w)
    args = (w._packed, w._scale_t, w._shift_t, w.kernel_group_size)
    xk = w.pad_activations(x2)
    if x2.dtype == torch.int8:
        return w.slice_out(qbits_int8_mm_plain(xk, _unit_scale(x2.device), *args, torch.float32, w.bits))
    return w.slice_out(qbits_mm_plain(xk, *args, w.bits).float())


def qbits_mm_partitioned(x, w) -> torch.Tensor:
    """y[..., N_local] = x[..., K_local] @ deq(W_local)^T on this rank, summed
    over the part's group for a row shard (`w.shard`), with JAX's numerics
    (`quanto_tpu/ops/qlinear.py:48-60`, `:110-123`):
    - float x: the local product in x's dtype, cast up to float32, summed
      (row), cast back to x's dtype;
    - a qint8 `ActivationQBytesArray` x: the int8 product with a unit scale
      in float32, summed (row), times x's scale in float32, cast to the
      weight's float dtype.
    Each all_reduce adds one to `qbits_mm_partitioned.all_reduces`."""
    if isinstance(w, WeightQBitsRequantArray):
        raise NotImplementedError(
            "qbits_mm_partitioned: the requant form under tensor parallelism is not ported yet "
            "(its step s8 comes from the shard's own scale rows): ROADMAP.md Queue 1, item 10"
        )
    int8_x = isinstance(x, ActivationQBytesArray)
    xd = x._data if int8_x else x
    if w.shard.mode == "row" and xd.shape[-1] != w.shape[1]:
        # A replicated (padded) producer gave the whole K: take this rank's columns.
        k = w.shape[1]
        xd = xd[..., w.shard.group.rank * k : (w.shard.group.rank + 1) * k]
    lead = xd.shape[:-1]
    out = _local_mm(xd.reshape(-1, xd.shape[-1]).contiguous(), w)
    if w.shard.mode == "row":
        all_reduce(out, w.shard.group)
        qbits_mm_partitioned.all_reduces += 1
    out = (out * x._scale.float()).to(w.float_dtype) if int8_x else out.to(x.dtype)
    return out.reshape(*lead, out.shape[-1])


qbits_mm_partitioned.launches = qbits_mm_partitioned.all_reduces = 0
