"""8-bit weight-only matmul outside the kernel's envelope.

PyTorch counterpart of the weight-only arm of `quanto_tpu/ops/qbytes_mm.py:87-119`
(XLA's convert-fused dot on the TPU): `dot(x, w^T)` with both operands in the
scale's dtype, then the per-output-channel scale applied to the output in
float32. `ops/qlinear.py` takes it where the Hopper kernel of
`ops/cuda/qbytes_mm.py` does not (prefill M > 256, e5m2 and e4m3fnuz
payloads): a plain large product, as the JAX package left it to XLA.
"""

from __future__ import annotations

import torch


__all__ = ["qbytes_mm"]


def qbytes_mm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y[..., N] = (x[..., K] @ w[N, K]^T) * scale^T in the scale's dtype; the
    scale is [N, 1] (per output channel) or a scalar."""
    dtype = scale.dtype
    out = torch.matmul(x.to(dtype), w.to(dtype).t())
    scales = scale.t() if scale.dim() == 2 else scale
    return (out.float() * scales.float()).to(dtype)
