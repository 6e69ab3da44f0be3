#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (each raises on failure; the script exits 0 only when all pass):
1. device: a CUDA card must be present; prints `nvidia-smi` name and power limit.
2. build: builds the Hopper kernels from `quanto_tpu_torch/csrc` (build seconds
   and the `-Xptxas -v` report).
3. kernels vs plain: each kernel against its plain PyTorch version at the
   main path's shapes (bf16 x, group size 128), with its time, its bound, the
   plain version's time and, as a yardstick only, `torch.matmul` on the
   dequantized bf16 weight. Times are CUDA-event medians with the L2 cache
   flushed before each launch, as the main path finds it.
4. main path: the Llama-3.1-8B configuration in bf16 (32 layers, full width,
   random weights from a seed), `quantize(weights="qint4")` with the lm_head
   included, `freeze`; B = 4 prompts of 1024 tokens: prefill (last position
   only) and 63 greedy decode steps (64 new tokens) over a bf16 cache of 1088
   slots. Asserts the exact kernel launch counts of that run.
5. end-to-end numerics: at full width and 2 layers, the prefill's
   last-position logits from the kernel path against the same forward
   through the plain versions called explicitly.

The second-to-last line is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

import gc
import json
import subprocess
import sys
import time
import types

import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

GS = 128
SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (128256, 4096)]  # (N, K)
KERNEL_M = {"qbits_mm_small_m": (4, 512), "qbits_mm_tiled": (513, 4096)}
# Shape of each kernel's summary entry: the gate/up projection at decode (M = B) and prefill (M = B*T).
SUMMARY_SHAPE = {"qbits_mm_small_m": (4, 14336, 4096), "qbits_mm_tiled": (4096, 14336, 4096)}
REPLACES = {
    "qbits_mm_small_m": "quanto_tpu/ops/pallas/qbits_mm.py:180",
    "qbits_mm_tiled": "quanto_tpu/ops/pallas/qbits_mm.py:223",
}
SOURCE = "quanto_tpu_torch/csrc/qbits_mm.cu"

# meta-llama/Llama-3.1-8B config.json.
LLAMA31_8B = dict(
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    rope_theta=500000.0,
    rope_scaling={
        "rope_type": "llama3",
        "factor": 8.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192,
    },
    rms_norm_eps=1e-5,
)
B, T, NEW = 4, 1024, 64
LINEARS_PER_LAYER = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor, budget_ms: float = 100.0) -> float:
    """Median CUDA-event time of fn(), L2 flushed before each launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    n = 3
    while len(times) < n:
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if len(times) == 1:
            n = int(min(30, max(3, budget_ms / max(times[0], 1e-3))))
    return sorted(times)[len(times) // 2]


def bound(M: int, N: int, K: int):
    """Least time (ms) on the card for one call, and what bounds it: each input
    read once (x bf16, packed codes, scale and shift), the output written once."""
    G = K // GS
    nbytes = M * K * 2 + N * K // 2 + 2 * G * N * 4 + M * N * 2
    flops = 2 * M * N * K
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(), dim=0).item()


def phase_kernels(K_mod, flush):
    """Phase 3: every kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    for N, K in SHAPES:
        G = K // GS
        packed = torch.randint(0, 256, (N, K // 2), dtype=torch.uint8, device=dev, generator=g)
        scale_t = torch.rand((G, N), device=dev, generator=g) * 0.01 + 0.001
        shift_t = scale_t * 7.5  # deq = s * (c - 7.5): codes centred on zero
        w_bf16 = K_mod.dequantize_k_nibbles(packed, scale_t, shift_t, GS).to(torch.bfloat16)
        for name, ms in KERNEL_M.items():
            kernel = getattr(K_mod, name)
            for M in ms:
                x = torch.randn((M, K), device=dev, generator=g, dtype=torch.bfloat16)
                args = (x, packed, scale_t, shift_t, GS)
                out = kernel(*args)
                ref = K_mod.qbits_mm_plain(*args)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ref_max = ref.float().abs().max().item()
                cos = cosine(out, ref)
                if not (cos > 1 - 1e-4 and err <= 1e-2 * ref_max):
                    raise RuntimeError(
                        f"{name} M={M} N={N} K={K}: cosine {cos} max_abs_err {err} (max|ref| {ref_max})"
                    )
                b_ms, b_by = bound(M, N, K)
                row = dict(
                    name=name, M=M, N=N, K=K, max_abs_err=err, cosine=cos,
                    ms=time_ms(lambda: kernel(*args), flush),
                    plain_ms=time_ms(lambda: K_mod.qbits_mm_plain(*args), flush),
                    library_ms=time_ms(lambda: torch.matmul(x, w_bf16.t()), flush),
                    bound_ms=b_ms, bound_by=b_by,
                )
                rows.append(row)
                log("kernel " + json.dumps(row))
                del out, ref
        del packed, scale_t, shift_t, w_bf16
        torch.cuda.empty_cache()
    return rows


def build_model(config, seed: int):
    from quanto_tpu_torch import freeze, quantize
    from quanto_tpu_torch.models.llama import LlamaForCausalLM
    from quanto_tpu_torch.nn import QLinear
    from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

    model = LlamaForCausalLM(config, device="cuda", generator=torch.Generator("cuda").manual_seed(seed))
    quantize(model, weights="qint4")
    freeze(model)
    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    expected = LINEARS_PER_LAYER * config.num_hidden_layers + 1
    if len(qlinears) != expected or not all(
        isinstance(m.weight, WeightQBitsHopperArray) for m in qlinears
    ):
        raise RuntimeError(f"expected {expected} QLinears in the Hopper layout")
    return model, qlinears


def phase_main_path(K_mod, ids):
    """Phase 4: qint4 Llama-3.1-8B prefill + greedy decode, with exact launch counts."""
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, generate, make_cache, prefill

    config = LlamaConfig(**LLAMA31_8B, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model, qlinears = build_model(config, seed=0)
    torch.cuda.synchronize()
    log(f"main path: built + quantized + frozen {config.num_hidden_layers} layers in "
        f"{time.perf_counter() - t0:.1f} s")
    small, tiled = K_mod.qbits_mm_small_m, K_mod.qbits_mm_tiled

    # Warm-up through the user-facing `generate`; its tokens must equal the timed run's.
    ref_tokens = generate(model, ids, NEW)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    small.launches = tiled.launches = 0
    cache = make_cache(model, B, T + NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(model, ids, cache, last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre_small, pre_tiled = small.launches, tiled.launches
    first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
    t0 = time.perf_counter()
    rest, cache = decode(model, first, cache, T, NEW - 1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {"qbits_mm_small_m": small.launches, "qbits_mm_tiled": tiled.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_lin = LINEARS_PER_LAYER * config.num_hidden_layers
    steps = NEW - 1
    if (pre_tiled, pre_small) != (n_lin, 1):
        raise RuntimeError(f"prefill launches tiled={pre_tiled} small_m={pre_small}, want {n_lin}, 1")
    if launches != {"qbits_mm_small_m": 1 + (n_lin + 1) * steps, "qbits_mm_tiled": n_lin}:
        raise RuntimeError(f"decode launches {launches}, want {(n_lin + 1) * steps} more small_m")
    if logits.shape != (B, 1, config.vocab_size) or not torch.isfinite(logits).all():
        raise RuntimeError(f"prefill logits: shape {tuple(logits.shape)} or non-finite values")
    tokens = torch.cat([ids, first, rest], dim=1)
    if not torch.equal(tokens, ref_tokens):
        raise RuntimeError("generate() and prefill + decode gave different tokens")
    if int(rest.min()) < 0 or int(rest.max()) >= config.vocab_size:
        raise RuntimeError("decoded token ids out of the vocabulary")

    step_bytes = sum(
        m.weight._packed.numel() + 8 * m.weight._scale_t.numel() for m in qlinears
    )
    log(json.dumps({
        "main_path": "llama-3.1-8b-config qint4+head4 bf16",
        "batch": B, "prompt": T, "new_tokens": NEW, "decode_steps": steps,
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_per_step": decode_s / steps * 1e3,
        "decode_tok_s": B * steps / decode_s,
        "peak_memory_gb": peak_gb,
        "launches": launches,
        "decode_step_weight_bytes": step_bytes,
        "decode_step_bound_ms": step_bytes / PEAK_BYTES_PER_S * 1e3,
    }))
    del model, qlinears, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_end_to_end(K_mod, ids):
    """Phase 5: 2 layers at full width, kernel path vs plain versions called explicitly."""
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.serve import make_cache, prefill

    config = LlamaConfig(**dict(LLAMA31_8B, num_hidden_layers=2), dtype=torch.bfloat16)
    model, qlinears = build_model(config, seed=1)
    small, tiled = K_mod.qbits_mm_small_m, K_mod.qbits_mm_tiled

    logits_k, _ = prefill(model, ids, make_cache(model, B, T), last_only=True)

    def plain_forward(self, x):
        w = self.weight
        out = K_mod.qbits_mm_plain(
            x.reshape(-1, x.shape[-1]).contiguous(), w._packed, w._scale_t, w._shift_t,
            w.kernel_group_size,
        )
        return out.reshape(*x.shape[:-1], out.shape[-1])

    for m in qlinears:
        m.forward = types.MethodType(plain_forward, m)
    before = (small.launches, tiled.launches)
    logits_p, _ = prefill(model, ids, make_cache(model, B, T), last_only=True)
    torch.cuda.synchronize()
    if (small.launches, tiled.launches) != before:
        raise RuntimeError("the plain forward launched a kernel")
    lk, lp = logits_k[:, -1].float(), logits_p[:, -1].float()
    cos = torch.nn.functional.cosine_similarity(lk, lp, dim=-1)
    top_k, top_p = lk.argmax(-1), lp.argmax(-1)
    log(json.dumps({"end_to_end_cosine": cos.tolist(), "top1_kernel": top_k.tolist(),
                    "top1_plain": top_p.tolist()}))
    if not bool((cos > 0.999).all()) or not torch.equal(top_k, top_p):
        raise RuntimeError("end-to-end logits of the kernel path disagree with the plain path")
    del model, qlinears
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    # Phase 1: device.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(card)

    # Phase 2: build.
    from quanto_tpu_torch.ops.cuda import qbits_mm as K_mod

    info = K_mod.build()
    log(f"build: {info['seconds']:.1f} s -> {info['path']}")
    if info["log"]:
        log(info["log"].strip())

    # Phase 3: kernels vs plain.
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    rows = phase_kernels(K_mod, flush)
    del flush

    # Phases 4 and 5.
    ids = torch.randint(
        0, LLAMA31_8B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(7)
    ).cuda()
    launches = phase_main_path(K_mod, ids)
    phase_end_to_end(K_mod, ids)

    kernels = []
    for name in KERNEL_M:
        mine = [r for r in rows if r["name"] == name]
        rep = next(r for r in mine if (r["M"], r["N"], r["K"]) == SUMMARY_SHAPE[name])
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            shape=list(SUMMARY_SHAPE[name]),
        ))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
