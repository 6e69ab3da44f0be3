"""8-bit matmuls outside the weight-only kernel: W8A8 and the XLA formula.

PyTorch counterpart of `quanto_tpu/ops/qbytes_mm.py:67-119`. The JAX package
computes these as XLA dots outside any Pallas kernel, so the port computes
them with PyTorch's own calls on the card:

- `qbytes_int_mm` (int8 x int8, `qbytes_mm.py:67-84`): the exact int32
  product, then the float32 scale product as JAX orders it. On a CUDA tensor
  the product is `torch._int_mm` where its envelope takes the shapes
  (`int_mm_eligible`: K and N multiples of 8; fewer than 17 rows are padded
  with zero rows to 17 and sliced, which is exact); its plain version, the
  CPU's route and the card's outside that envelope, sums in float64, which
  is exact for int8 while 127 * 128 * K < 2**53. Both round the integer sum
  to float32 once, so the card equals the plain version bit for bit.
- `qbytes_fp8_mm` (e4m3fn x e4m3fn): JAX's convert formula (`:114-119`),
  the dot JAX runs on every TPU generation before v6 (its native fp8 dot,
  `:105-113`, only where `use_native_fp8_dot` names v6 or v7). Every e4m3fn
  value is exact in bf16, so on a CUDA tensor both operands go to the bf16
  tensor cores with float32 sums and a float32 output (`_fp8_dot`): the
  products are exact and only the order of the float32 sums differs from the
  plain version (both operands in float32, float32 sums). `torch._scaled_mm`
  (Hopper's fp8 tensor cores) is not used: its sums are not float32's, one
  product erred by 6e-4 to 1.8e-3 at |y| <~ 5 and 32 layers carried that to
  a logits cosine of 0.94 (`PERF.md`, the W8A8 rows; `chip_smoke.py` times
  it beside the route as a yardstick).
- `qbytes_mm`, the dispatch of `qbytes_mm.py:87-119`: int8 x int8 and
  e4m3fn x e4m3fn as above; any other pair (fp8 x int8, other fp8 formats,
  a float x with an 8-bit weight outside the Hopper kernel's envelope) takes
  the convert formula: both operands in the scale's dtype, a dot with
  float32 sums and result, the per-output-channel scale applied to the
  output in float32, one rounding to the scale's dtype.

The output dtype is the scale's, as in JAX: W8A8 passes the combined scale
x.scale * w.scale, float32 (the activation's scale is float32), so a W8A8
linear returns float32, as JAX's does.

`qbytes_int_mm.launches` and `qbytes_fp8_mm.launches` count the library
calls (`torch._int_mm`, the bf16 product of `_fp8_dot`) made on a CUDA
tensor, so that a run shows the W8A8 route it took.
"""

from __future__ import annotations

import torch


__all__ = [
    "INT_MM_MIN_M",
    "int_mm_eligible",
    "qbytes_int_mm_plain",
    "qbytes_int_mm",
    "qbytes_fp8_mm_plain",
    "qbytes_fp8_mm",
    "qbytes_mm",
]

# `torch._int_mm` on CUDA takes more than 16 rows.
INT_MM_MIN_M = 17


def _row_scales(output_scales: torch.Tensor) -> torch.Tensor:
    """The scale broadcast over the output's last dimension: [N, 1] -> [1, N],
    a scalar as it is, in float32."""
    s = output_scales.t() if output_scales.dim() == 2 else output_scales
    return s.float()


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [N, K]^T with float32 sums, as a float32 [M, N]: on a CUDA
    tensor the 16-bit operands go to the tensor cores with a float32 output;
    elsewhere both operands are widened to float32 (exact)."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return torch.mm(x.float(), w.float().t())


def int_mm_eligible(K: int, N: int) -> bool:
    """The shapes `torch._int_mm` takes on CUDA (rows padded to INT_MM_MIN_M)."""
    return K % 8 == 0 and N % 8 == 0


def _pad_rows(x2: torch.Tensor, m: int) -> torch.Tensor:
    """x2 [M, K] with zero rows added up to m rows (exact: each output row
    depends on its own x row only)."""
    if x2.shape[0] >= m:
        return x2
    return torch.cat([x2, x2.new_zeros((m - x2.shape[0], x2.shape[1]))])


def qbytes_int_mm_plain(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int32 product x2 [M, K] @ w [N, K]^T of int8 operands, exact, as
    float32 [M, N] rounded once from the exact sum (float64 sums are exact
    while 127 * 128 * K < 2**53)."""
    return (x2.double() @ w.double().t()).float()


def _int_mm_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int8 product as float32: `torch._int_mm` on a CUDA tensor
    inside its envelope (counted), else the plain version."""
    M, K = x2.shape
    N = w.shape[0]
    if not x2.is_cuda or not int_mm_eligible(K, N):
        return qbytes_int_mm_plain(x2, w)
    acc = torch._int_mm(_pad_rows(x2, INT_MM_MIN_M), w.t())
    qbytes_int_mm.launches += 1
    return acc[:M].float()


def qbytes_int_mm(activations: torch.Tensor, weights: torch.Tensor, output_scales: torch.Tensor) -> torch.Tensor:
    """int8 activations [..., K] x int8 weights [N, K] -> [..., N] in the scale's
    dtype: the exact int32 product converted to float32, times the scale in
    float32 ([N, 1] per output channel, or a scalar), cast to the scale's
    dtype (`quanto_tpu/ops/qbytes_mm.py:67-84`)."""
    lead = activations.shape[:-1]
    x2 = activations.reshape(-1, activations.shape[-1]).contiguous()
    out = _int_mm_f32(x2, weights) * _row_scales(output_scales)
    return out.to(output_scales.dtype).reshape(*lead, weights.shape[0])


qbytes_int_mm.launches = 0


def qbytes_fp8_mm_plain(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp8 x2 [M, K] @ fp8 w [N, K]^T as float32 [M, N]: JAX's convert formula
    (both operands to float32, exact, float32 sums)."""
    return x2.float() @ w.float().t()


def _fp8_dot(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The card's product of `qbytes_fp8_mm`: JAX's convert formula with the
    operands in bf16, which holds every e4m3fn value (NaN codes stay NaN), on
    the tensor cores with float32 sums and output."""
    return _dot_f32(x2.to(torch.bfloat16), w.to(torch.bfloat16))


def qbytes_fp8_mm(activations: torch.Tensor, weights: torch.Tensor, output_scales: torch.Tensor) -> torch.Tensor:
    """e4m3fn activations [..., K] x e4m3fn weights [N, K] -> [..., N] in the
    scale's dtype: the product in float32, times the scale in float32, cast to
    the scale's dtype (`quanto_tpu/ops/qbytes_mm.py:114-119`). On a CUDA
    tensor the product is `_fp8_dot` (counted); elsewhere its plain version."""
    lead = activations.shape[:-1]
    x2 = activations.reshape(-1, activations.shape[-1]).contiguous()
    if x2.is_cuda:
        acc = _fp8_dot(x2, weights)
        qbytes_fp8_mm.launches += 1
    else:
        acc = qbytes_fp8_mm_plain(x2, weights)
    out = acc * _row_scales(output_scales)
    return out.to(output_scales.dtype).reshape(*lead, weights.shape[0])


qbytes_fp8_mm.launches = 0


def _convert_mm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """JAX's convert formula (`qbytes_mm.py:115-119`): both operands in the
    scale's dtype, float32 sums and result, the scale applied to the output
    in float32, one rounding to the scale's dtype."""
    dtype = scale.dtype
    x2 = x.reshape(-1, x.shape[-1]).to(dtype)
    out = _dot_f32(x2, w.to(dtype)).reshape(*x.shape[:-1], w.shape[0])
    return (out * _row_scales(scale)).to(dtype)


def qbytes_mm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y[..., N] = (x[..., K] @ w[N, K]^T) * scale^T in the scale's dtype; the
    scale is [N, 1] (per output channel) or a scalar. int8 x int8 takes
    `qbytes_int_mm`, e4m3fn x e4m3fn `qbytes_fp8_mm`, anything else the
    convert formula."""
    if x.dtype == torch.int8 and w.dtype == torch.int8:
        return qbytes_int_mm(x, w, scale)
    if x.dtype == torch.float8_e4m3fn and w.dtype == torch.float8_e4m3fn:
        return qbytes_fp8_mm(x, w, scale)
    return _convert_mm(x, w, scale)
