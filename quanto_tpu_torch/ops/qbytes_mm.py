"""8-bit weight-only matmul outside the kernel's envelope.

PyTorch counterpart of the weight-only arm of `quanto_tpu/ops/qbytes_mm.py:87-119`
(XLA's convert-fused dot on the TPU): `dot(x, w^T)` with both operands in the
scale's dtype and float32 sums and result (`preferred_element_type`), then the
per-output-channel scale applied to the output in float32, then one rounding
to the scale's dtype. `ops/qlinear.py` takes it where the Hopper kernel of
`ops/cuda/qbytes_mm.py` does not (prefill M > 256, e5m2 and e4m3fnuz
payloads): a plain large product, as the JAX package left it to XLA.
"""

from __future__ import annotations

import torch


__all__ = ["qbytes_mm"]


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [N, K]^T with float32 sums, as a float32 [M, N]: on a CUDA
    tensor the 16-bit operands go to the tensor cores with a float32 output;
    elsewhere both operands are widened to float32 (exact)."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return torch.mm(x.float(), w.float().t())


def qbytes_mm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y[..., N] = (x[..., K] @ w[N, K]^T) * scale^T in the scale's dtype; the
    scale is [N, 1] (per output channel) or a scalar."""
    dtype = scale.dtype
    x2 = x.reshape(-1, x.shape[-1]).to(dtype)
    out = _dot_f32(x2, w.to(dtype)).reshape(*x.shape[:-1], w.shape[0])
    scales = scale.t() if scale.dim() == 2 else scale
    return (out * scales.float()).to(dtype)
