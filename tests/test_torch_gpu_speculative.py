"""Speculative decoding on a CUDA card (marked `gpu`; skips without one).

This file imports only torch, numpy and the port, so it runs on the card's
machine:

    python -m pytest -m gpu tests/test_torch_gpu_speculative.py

A tiny Llama (head_dim 64, so that `flash_decode` takes its decode steps),
float32, seeded: greedy speculation gives tokens EQUAL to the target's own
`generate` for a qint4 draft of a qint8 target, a layer-skip draft of a
qint4 target and a qint8 target with itself as draft; the R rounds of one
call run under `torch.cuda.set_sync_debug_mode("error")` (no host sync);
and the launch counters tick per round as `chip_smoke.py`'s phase 21
asserts: k+1 draft forwards at M = B (`qbits_mm_small_m`, `flash_decode`),
one verify at M = B (k+1) through the target's 8-bit or int4 kernel and no
`flash_decode`.
"""

import pytest
import torch

import quanto_tpu_torch as qtt
from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from quanto_tpu_torch.models.sampling import greedy, make_sampler
from quanto_tpu_torch.models.serve import decode, generate, make_cache, prefill
from quanto_tpu_torch.models.speculative import (
    SpeculativeGenerator,
    layerskip_draft,
    make_speculative_decode_fn,
    make_speculative_sample_decode_fn,
)
from quanto_tpu_torch.ops.cuda import flash_decode as fd_mod
from quanto_tpu_torch.ops.cuda import qbits_mm, qbytes_mm

LLAMA = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, rope_theta=500000.0)
B, T, NEW, K, ROUNDS = 4, 16, 24, 4, 3
WRAPPERS = {"qbits_mm_small_m": qbits_mm.qbits_mm_small_m, "qbytes_mm_int8": qbytes_mm.qbytes_mm_int8,
            "flash_decode": fd_mod.flash_decode}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def model(weights: str, exclude=None, layers: int = LLAMA["num_hidden_layers"]):
    """The seeded float32 model quantized with `weights` and frozen on the card."""
    m = LlamaForCausalLM(LlamaConfig(**dict(LLAMA, num_hidden_layers=layers)), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    qtt.quantize(m, weights=weights, exclude=exclude)
    qtt.freeze(m)
    return m


def prompt() -> torch.Tensor:
    return torch.randint(0, LLAMA["vocab_size"], (B, T), generator=torch.Generator().manual_seed(1)).cuda()


def counts() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def rounds_checked(spec, ids, target, draft, *extra):
    """Prefill both models, then one call of `spec` (R rounds) under the
    sync check, its launches counted; returns (blocks, counts, launches)."""
    cache_len = T + 1 + K + 2 * ROUNDS * (K + 1)
    t_cache, d_cache = make_cache(target, B, cache_len), make_cache(draft, B, cache_len)
    with torch.no_grad():
        logits, t_cache = prefill(target, ids, t_cache, last_only=True)
        _, d_cache = prefill(draft, ids, d_cache, last_only=True)
    first = greedy(logits[:, -1])[:, None]
    spec(first, t_cache, d_cache, T, *extra)  # warm-up: each wrapper's workspaces and tables
    torch.cuda.synchronize()
    before = counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blocks, n, _, _, pos = spec(first, t_cache, d_cache, T, *extra)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = {name: c - before[name] for name, c in counts().items()}
    assert torch.equal(pos, T + n.sum(dim=1).to(torch.int32))
    return blocks, n, launches


@pytest.mark.gpu
@pytest.mark.parametrize("pair", ["qint8_target_qint4_draft", "qint4_layerskip", "qint8_self"])
def test_greedy_speculation_equals_generate(cuda_device, pair):
    ids = prompt()
    if pair == "qint8_target_qint4_draft":
        target, draft = model("qint8", exclude="lm_head"), model("qint4")
    elif pair == "qint4_layerskip":
        target = model("qint4")
        draft = layerskip_draft(target, 2)
    else:
        target = model("qint8", exclude="lm_head")
        draft = target
    want = generate(target, ids, NEW)
    out, acceptance = SpeculativeGenerator(target, draft, K).generate(ids, NEW)
    assert torch.equal(out, want)
    assert 0.0 <= acceptance <= 1.0
    if draft is target:
        assert acceptance == 1.0


@pytest.mark.gpu
def test_rounds_no_sync_and_launch_counts(cuda_device):
    """qint8 target, qint4 draft: each round k+1 draft forwards of 7 L + 1
    int4 launches and L `flash_decode`, and one verify of 7 L 8-bit launches
    at M = B (k+1) and no `flash_decode`; no host sync in the R rounds."""
    L = LLAMA["num_hidden_layers"]
    target, draft = model("qint8", exclude="lm_head"), model("qint4")
    spec = make_speculative_decode_fn(target, draft, ROUNDS, K)
    blocks, n, launches = rounds_checked(spec, prompt(), target, draft)
    assert blocks.shape == (B, ROUNDS, K + 1) and n.shape == (B, ROUNDS)
    assert launches == {
        "qbits_mm_small_m": ROUNDS * (K + 1) * (7 * L + 1),
        "qbytes_mm_int8": ROUNDS * 7 * L,
        "flash_decode": ROUNDS * (K + 1) * L,
    }


@pytest.mark.gpu
def test_layerskip_rounds_no_sync_and_launch_counts(cuda_device):
    """A 2-layer draft of a 4-layer qint4 target: no bytes added on the card,
    and per round k+1 draft forwards of 7 x 2 + 1 int4 launches and 2
    `flash_decode`, one verify of 7 L + 1 int4 launches at M = B (k+1)."""
    L = LLAMA["num_hidden_layers"]
    target = model("qint4")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    draft = layerskip_draft(target, 2)
    assert torch.cuda.memory_allocated() == before
    assert draft.lm_head.weight._packed.data_ptr() == target.lm_head.weight._packed.data_ptr()
    spec = make_speculative_decode_fn(target, draft, ROUNDS, K)
    _, _, launches = rounds_checked(spec, prompt(), target, draft)
    assert launches == {
        "qbits_mm_small_m": ROUNDS * ((K + 1) * (7 * 2 + 1) + 7 * L + 1),
        "qbytes_mm_int8": 0,
        "flash_decode": ROUNDS * (K + 1) * 2,
    }


@pytest.mark.gpu
def test_sampled_rounds_no_sync_and_seeded_decode(cuda_device):
    """Rejection sampling at temperature 0.8, top-k 50, top-p 0.95 from a
    seeded generator: the rounds run with no host sync, the ids lie in the
    vocabulary, and `serve.decode` with a sampler repeats from equal seeds."""
    target, draft = model("qint8", exclude="lm_head"), model("qint4")
    warp_args = (0.8, 50, 0.95)
    gen = SpeculativeGenerator(target, draft, K, *warp_args)
    spec = make_speculative_sample_decode_fn(target, draft, ROUNDS, K, gen._warp)
    blocks, n, _ = rounds_checked(spec, prompt(), target, draft, torch.Generator("cuda").manual_seed(5))
    assert bool(((blocks >= 0) & (blocks < LLAMA["vocab_size"])).all())
    assert bool(((n >= 1) & (n <= K + 1)).all())
    out, acceptance = gen.generate(prompt(), NEW, generator=torch.Generator("cuda").manual_seed(2))
    assert out.shape == (B, T + NEW) and 0.0 <= acceptance <= 1.0
    runs = []
    for _ in range(2):
        cache = make_cache(target, B, T + 17)
        with torch.no_grad():
            logits, cache = prefill(target, prompt(), cache, last_only=True)
        first = greedy(logits[:, -1])[:, None]
        runs.append(decode(target, first, cache, T, 16, sample_fn=make_sampler(*warp_args),
                           generator=torch.Generator("cuda").manual_seed(3))[0])
    assert torch.equal(runs[0], runs[1])
