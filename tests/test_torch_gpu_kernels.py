"""Each Hopper kernel of quanto_tpu_torch against its plain PyTorch version,
on a CUDA card (marked `gpu`; skips without one).

This file imports only torch, numpy and the port, so it runs on a card whose
machine lacks the JAX reference's own dependencies:

    python -m pytest -m gpu tests/test_torch_gpu_kernels.py

Tolerances: float32 x within 1e-4 * max|ref| (the tiled kernel sees x as a
bf16 high + low pair, about 16 mantissa bits); bfloat16 x within
1e-2 * max|ref| and cosine > 1 - 1e-4 (sums in another order, rounded to bf16).
"""

import numpy as np
import pytest
import torch

import quanto_tpu_torch as qtt
from quanto_tpu_torch.ops.cuda.qbits_mm import (
    MAX_M,
    qbits_mm_plain,
    qbits_mm_small_m,
    qbits_mm_tiled,
)
from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("group_size", [128, None])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 4, 7, 512, 513, 700])
def test_kernels_match_plain(cuda_device, m, dtype, group_size):
    N, K = 384, 2048
    rng = np.random.default_rng(m)
    w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)).to(cuda_device, dtype)
    scale, shift = qtt.MaxOptimizer()(w, qtt.qint4, axis=0, group_size=group_size)
    hop = WeightQBitsHopperArray.from_generic(
        qtt.quantize_weight(w, qtt.qint4, 0, scale, shift=shift, group_size=group_size)
    )
    x = torch.from_numpy(rng.standard_normal((m, K)).astype(np.float32)).to(cuda_device, dtype)
    args = (x, hop._packed, hop._scale_t, hop._shift_t, hop.kernel_group_size)
    wrapper = qbits_mm_small_m if m <= MAX_M else qbits_mm_tiled
    before = wrapper.launches
    out = wrapper(*args).float()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = qbits_mm_plain(*args).float()
    err = (out - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * ref.abs().max().item()
    else:
        assert err <= 1e-2 * ref.abs().max().item()
        assert torch.nn.functional.cosine_similarity(out.flatten(), ref.flatten(), dim=0) > 1 - 1e-4
