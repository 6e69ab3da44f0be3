#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (each raises on failure; the script exits 0 only when all pass):
1. device: a CUDA card must be present; prints `nvidia-smi` name and power limit.
2. build: builds every Hopper kernel source in `quanto_tpu_torch/csrc` into
   one library (one nvcc per source, in parallel; build seconds and the
   `-Xptxas -v` report).
3. kernels vs plain: each kernel against its plain PyTorch version at the
   main path's shapes, with its time, its bound, the plain version's time
   and, as a yardstick only, one PyTorch call computing the same function.
   int4 matmuls: bf16 x, group size 128, yardstick `torch.matmul` on the
   dequantized bf16 weight. `flash_decode`: B = 4, Hkv = 8, G = 4, D = 128,
   bf16 q, caches bf16, qint8, qint4, k8v4 and qint4a of 1088 and 8192 slots,
   every slot visible; yardstick `scaled_dot_product_attention` (GQA, boolean
   mask) on the cache dequantized to bf16. Times are CUDA-event medians with
   the L2 cache flushed before each launch, as the main path finds it.
4. main path: the Llama-3.1-8B configuration in bf16 (32 layers, full width,
   random weights from a seed), `quantize(weights="qint4")` with the lm_head
   included, `freeze`; B = 4 prompts of 1024 tokens: prefill (last position
   only) and 63 greedy decode steps (64 new tokens) over a bf16 cache of 1088
   slots. Asserts the exact kernel launch counts of that run.
4b. long context, on the same model: a qint4 KV cache of 8192 slots, B = 4
   prompts of 8128 tokens prefilled in 8 chunks of 1016 (each with the logits
   of its last position only), then 63 greedy decode steps. Asserts the
   exact launch counts and prints prefill ms, decode ms/step, tok/s, peak
   memory, the cache's bytes and the step's byte bound.
   The 8-bit weight-only kernel (int8 and e4m3fn payloads, M in {4, 256})
   and the W4A8 kernels (int8 small-M at M in {4, 512}, int8 tiled at M in
   {513, 4096}) at the four linear shapes, bf16 x or output, yardstick
   `torch.matmul` on the operands dequantized to bf16.
5. end-to-end numerics: at full width and 2 layers, the kernel path against
   the same forward through the plain versions called explicitly: the
   prefill's last-position logits (bf16 cache), and one decode step at
   ragged per-row positions over a qint4 cache; for qint4 weights (lm_head
   included), and for qint8, qfloat8 (e4m3fn) and calibrated W4A8 weights
   (lm_head excluded).
6. the `int8` arm of the JAX package's 8B decode grid (`bench.py:main_8b`):
   the Llama-3.1-8B configuration, `quantize(weights="qint8",
   exclude="lm_head")`, `freeze`; the prefill and decode of phase 4, with
   exact launch counts (prefill M = 4096 takes the XLA formula, each decode
   step 224 launches of the 8-bit kernel).
7. the `w4a8` arm: `quantize(weights="qint4", activations="qint8",
   exclude="lm_head")`, `Calibration` over 2 batches of 4 x 128 seeded
   tokens (streamline must turn output quantization off for all 224
   linears), `freeze`; the same prefill and decode, with exact launch counts.

The second-to-last line is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import gc
import json
import subprocess
import sys
import time
import types

import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16 and int8 tensor-core rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12

GS = 128
SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (128256, 4096)]  # (N, K)
KERNEL_M = {"qbits_mm_small_m": (4, 512), "qbits_mm_tiled": (513, 4096)}
# Shape of each kernel's summary entry: the gate/up projection at decode (M = B) and prefill (M = B*T).
SUMMARY_SHAPE = {"qbits_mm_small_m": (4, 14336, 4096), "qbits_mm_tiled": (4096, 14336, 4096)}
REPLACES = {
    "qbits_mm_small_m": "quanto_tpu/ops/pallas/qbits_mm.py:180",
    "qbits_mm_tiled": "quanto_tpu/ops/pallas/qbits_mm.py:223",
}
SOURCE = {
    "qbits_mm_small_m": "quanto_tpu_torch/csrc/qbits_mm.cu",
    "qbits_mm_tiled": "quanto_tpu_torch/csrc/qbits_mm.cu",
    "flash_decode": "quanto_tpu_torch/csrc/flash_decode.cu",
}
REPLACES["flash_decode"] = (
    "quanto_tpu/ops/pallas/flash_decode.py:53, quanto_tpu/ops/pallas/flash_decode2.py:44, "
    "quanto_tpu/ops/pallas/flash_decode3.py:36"
)
# flash_decode's phase-3 shapes: (Hkv, G, D) of Llama-3.1-8B, caches and lengths.
FD_HEADS = (8, 4, 128)
FD_CACHES = ["bf16", "qint8", "qint4", "k8v4", "qint4a"]
FD_SLOTS = [1088, 8192]
FD_SUMMARY = ("qint4", 8192)  # the long-context path's cache
# The kernels of this slice: their phase-3 M values at the four linear shapes (no lm_head:
# the 8-bit and W4A8 arms exclude it), summary shapes, sources and the TPU kernels they replace.
LINEAR_SHAPES = SHAPES[:4]
QBYTES_M = {"qbytes_mm_int8": (4, 256), "qbytes_mm_e4m3fn": (4, 256)}
W4A8_M = {"qbits_mm_int8_small_m": (4, 512), "qbits_mm_tiled_int8": (513, 4096)}
SUMMARY_SHAPE.update({
    "qbytes_mm_int8": (4, 14336, 4096), "qbytes_mm_e4m3fn": (4, 14336, 4096),
    "qbits_mm_int8_small_m": (4, 14336, 4096), "qbits_mm_tiled_int8": (4096, 14336, 4096),
})
SOURCE.update({
    "qbytes_mm_int8": "quanto_tpu_torch/csrc/qbytes_mm.cu",
    "qbytes_mm_e4m3fn": "quanto_tpu_torch/csrc/qbytes_mm.cu",
    "qbits_mm_int8_small_m": "quanto_tpu_torch/csrc/qbits_mm.cu",
    "qbits_mm_tiled_int8": "quanto_tpu_torch/csrc/qbits_mm.cu",
})
REPLACES.update({
    "qbytes_mm_int8": "quanto_tpu/ops/pallas/qbytes_mm.py:30",
    "qbytes_mm_e4m3fn": "quanto_tpu/ops/pallas/qbytes_mm.py:108",
    "qbits_mm_int8_small_m": "quanto_tpu/ops/pallas/qbits_mm.py:577",
    "qbits_mm_tiled_int8": "quanto_tpu/ops/pallas/qbits_mm.py:223 (int8-x arm, :248-251)",
})

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
CAL_BATCHES, CAL_T = 2, 128
LINEARS_PER_LAYER = 7
# Long context: the JAX package's headline decode (ctx 8192, qint4 cache).
LONG_SLOTS, LONG_PROMPT, LONG_CHUNK = 8192, 8128, 1016


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor, budget_ms: float = 100.0) -> float:
    """Median CUDA-event time of fn(), L2 flushed before each launch. A spin
    of about 0.5 ms on the stream between the flush and the start event keeps
    the card busy while the host enqueues fn, so the time is the device's and
    not the wrapper's Python."""
    fn()
    torch.cuda.synchronize()
    times = []
    n = 3
    while len(times) < n:
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if len(times) == 1:
            n = int(min(30, max(3, budget_ms / max(times[0], 1e-3))))
    return sorted(times)[len(times) // 2]


def host_us(fn, n: int = 200) -> float:
    """Host time of one call, in µs: `n` calls issued back to back, timed
    before the card has finished them (their launches queue), so it is what
    the caller's thread spends in the wrapper."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def bound(M: int, N: int, K: int, x_bytes: int = 2, w_bytes: float = 0.5, side_bytes=None,
          peak_ops: float = PEAK_BF16_FLOPS):
    """Least time (ms) on the card for one call, and what bounds it: each input
    read once (x, the weight payload, its scales and shifts: by default the
    int4 layout's float32 [G, N] pair), the bf16 output written once; 2MNK
    operations at `peak_ops`."""
    if side_bytes is None:
        side_bytes = 2 * (K // GS) * N * 4
    nbytes = M * K * x_bytes + N * K * w_bytes + side_bytes + M * N * 2
    ops = 2 * M * N * K
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(what: str, out: torch.Tensor, ref: torch.Tensor):
    """Kernel output against its plain version: cosine > 1 - 1e-4 and max abs
    error <= 1e-2 * max|ref| (bf16 outputs). Returns (max_abs_err, cosine)."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    cos = cosine(out, ref)
    if not (cos > 1 - 1e-4 and err <= 1e-2 * ref_max):
        raise RuntimeError(f"{what}: cosine {cos} max_abs_err {err} (max|ref| {ref_max})")
    return err, cos


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


def phase_qbytes(flush):
    """Phase 3, the 8-bit weight-only kernel: both payloads against the plain
    version, bf16 x and the bf16 [N, 1] scale of a bf16 model."""
    import quanto_tpu_torch as qtt
    from quanto_tpu_torch.ops.cuda import qbytes_mm as QB

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2345)
    rows = []
    for N, K in LINEAR_SHAPES:
        w = torch.randn((N, K), device=dev, generator=g, dtype=torch.bfloat16) * 0.02
        for name, ms in QBYTES_M.items():
            qtype = qtt.qint8 if name == "qbytes_mm_int8" else qtt.qfloat8
            qw = qtt.quantize_weight(w, qtype, 0, qtt.AbsmaxOptimizer()(w, qtype, 0))
            w_bf16 = qw.dequantize()
            kernel = getattr(QB, name)
            for M in ms:
                x = torch.randn((M, K), device=dev, generator=g, dtype=torch.bfloat16)
                args = (x, qw._data, qw._scale)
                err, cos = check_kernel(f"{name} M={M} N={N} K={K}", kernel(*args), QB.qbytes_mm_plain(*args))
                b_ms, b_by = bound(M, N, K, w_bytes=1, side_bytes=2 * N)
                row = dict(
                    name=name, M=M, N=N, K=K, max_abs_err=err, cosine=cos,
                    ms=time_ms(lambda: kernel(*args), flush),
                    plain_ms=time_ms(lambda: QB.qbytes_mm_plain(*args), flush),
                    library_ms=time_ms(lambda: torch.matmul(x, w_bf16.t()), flush),
                    bound_ms=b_ms, bound_by=b_by,
                )
                rows.append(row)
                log("kernel " + json.dumps(row))
            del qw, w_bf16
        del w
        torch.cuda.empty_cache()
    return rows


def phase_w4a8(K_mod, flush):
    """Phase 3, the W4A8 kernels: int8 x with a device scalar sx against random
    int4 codes, bf16 output, against their plain version."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3456)
    rows = []
    sx = torch.tensor(0.0173, device=dev)
    for N, K in LINEAR_SHAPES:
        G = K // GS
        packed = torch.randint(0, 256, (N, K // 2), dtype=torch.uint8, device=dev, generator=g)
        scale_t = torch.rand((G, N), device=dev, generator=g) * 0.01 + 0.001
        shift_t = scale_t * 7.5
        w_bf16 = K_mod.dequantize_k_nibbles(packed, scale_t, shift_t, GS).to(torch.bfloat16)
        for name, ms in W4A8_M.items():
            kernel = getattr(K_mod, name)
            for M in ms:
                xq = torch.randint(-128, 128, (M, K), dtype=torch.int8, device=dev, generator=g)
                x_bf16 = (xq.float() * sx).to(torch.bfloat16)
                args = (xq, sx, packed, scale_t, shift_t, GS, torch.bfloat16)
                err, cos = check_kernel(
                    f"{name} M={M} N={N} K={K}", kernel(*args), K_mod.qbits_int8_mm_plain(*args)
                )
                b_ms, b_by = bound(M, N, K, x_bytes=1, side_bytes=2 * (K // GS) * N * 4 + 4, peak_ops=PEAK_INT8_OPS)
                row = dict(
                    name=name, M=M, N=N, K=K, max_abs_err=err, cosine=cos,
                    ms=time_ms(lambda: kernel(*args), flush),
                    plain_ms=time_ms(lambda: K_mod.qbits_int8_mm_plain(*args), flush),
                    library_ms=time_ms(lambda: torch.matmul(x_bf16, w_bf16.t()), flush),
                    bound_ms=b_ms, bound_by=b_by,
                )
                rows.append(row)
                log("kernel " + json.dumps(row))
        del packed, scale_t, shift_t, w_bf16
        torch.cuda.empty_cache()
    return rows


def fd_bound(S: int, k_row: int, v_row: int, per_slot: int):
    """Least time (ms) of one flash_decode call with every slot visible: each
    visible slot's K and V rows (`k_row` + `v_row` bytes per head) and
    per-slot factors (`per_slot` bytes per head) read once, bf16 q read and
    the output written once; two dots of D per slot and query at the bf16
    tensor-core rate."""
    Hkv, G, D = FD_HEADS
    nbytes = B * S * Hkv * (k_row + v_row + per_slot) + 2 * 2 * B * Hkv * G * D
    flops = 4 * B * Hkv * G * D * S
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fd_cache(kind: str, S: int, g: torch.Generator):
    """One layer's cache of `kind` with every slot written by `kv_update`
    from random K (skewed, as RoPE'd K heads are) and V."""
    from quanto_tpu_torch.tensor.kv_cache import init_quantized_kv_cache, kv_update

    Hkv, _, D = FD_HEADS
    k = torch.randn((B, S, Hkv, D), device="cuda", generator=g) * 2 + 0.5
    v = torch.randn((B, S, Hkv, D), device="cuda", generator=g)
    if kind == "bf16":
        return (k.to(torch.bfloat16), v.to(torch.bfloat16))
    layer = init_quantized_kv_cache(1, B, S, Hkv, D, kind, device="cuda")[0]
    return kv_update(layer, k, v, 0)


def phase_flash_decode(flush):
    """Phase 3, flash_decode: the kernel against its plain version and SDPA."""
    from quanto_tpu_torch.ops.attention import decode_attention
    from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain
    from quanto_tpu_torch.tensor.kv_cache import kv_read

    Hkv, G, D = FD_HEADS
    g = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    for S in FD_SLOTS:
        for kind in FD_CACHES:
            cache = fd_cache(kind, S, g)
            q = torch.randn((B, Hkv, G, D), device="cuda", generator=g).to(torch.bfloat16)
            pos = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
            if kind == "bf16":
                args = (q, *cache, None, None, pos)
                kw = {}
                k_row = v_row = 2 * D
                per_slot = 0
            else:
                c = cache
                args = (q, c._k_data, c._v_data, c._k_scale, c._v_scale, pos)
                kw = dict(k_shift=c._k_shift, v_shift=c._v_shift)
                k_row, v_row = c._k_data[0, 0, 0].numel(), c._v_data[0, 0, 0].numel()
                per_slot = 8 if c._k_shift is None else 16
            out = flash_decode(*args, **kw)
            ref = flash_decode_plain(*args, **kw)
            # The model's dispatch gives the same result as the direct call.
            out2 = decode_attention(q.reshape(B, 1, Hkv * G, D), cache, pos)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            cos = cosine(out, ref)
            if not (cos > 1 - 1e-4 and err <= 1e-2 * ref_max) or not torch.equal(
                out2.reshape(out.shape), out
            ):
                raise RuntimeError(
                    f"flash_decode {kind} S={S}: cosine {cos} max_abs_err {err} (max|ref| {ref_max})"
                )
            # Yardstick: SDPA over the cache dequantized to bf16, q [B, H, 1, D].
            kd, vd = cache if kind == "bf16" else kv_read(cache, torch.bfloat16)
            kt, vt = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
            qs = q.reshape(B, Hkv * G, 1, D)
            mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask, enable_gqa=True)

            lib = sdpa().reshape(B, Hkv, G, D)
            lib_cos = cosine(lib, ref)
            b_ms, b_by = fd_bound(S, k_row, v_row, per_slot)
            row = dict(
                name="flash_decode", cache=kind, S=S, B=B, Hkv=Hkv, G=G, D=D,
                max_abs_err=err, cosine=cos, sdpa_cosine=lib_cos,
                ms=time_ms(lambda: flash_decode(*args, **kw), flush),
                plain_ms=time_ms(lambda: flash_decode_plain(*args, **kw), flush),
                library_ms=time_ms(sdpa, flush),
                bound_ms=b_ms, bound_by=b_by,
                host_us=host_us(lambda: flash_decode(*args, **kw)),
            )
            rows.append(row)
            log("kernel " + json.dumps(row))
            del cache, kd, vd, kt, vt, out, ref, out2, lib
            torch.cuda.empty_cache()
    return rows


def calibration_batches(config):
    """Phase 7's (and phase 5's W4A8) calibration data: 2 batches of 4 x 128 seeded token ids."""
    g = torch.Generator().manual_seed(11)
    return [torch.randint(0, config.vocab_size, (B, CAL_T), generator=g).cuda() for _ in range(CAL_BATCHES)]


def build_model(config, seed: int, weights: str = "qint4", activations=None, exclude=None):
    """The configuration with random weights from `seed`, quantized, calibrated
    when activations are quantized (streamline must turn every linear's output
    quantization off, as it does in JAX on this model), and frozen."""
    from quanto_tpu_torch import Calibration, freeze, named_qmodules, quantize
    from quanto_tpu_torch.models.llama import LlamaForCausalLM
    from quanto_tpu_torch.nn import QLinear
    from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray, WeightQBytesArray

    model = LlamaForCausalLM(config, device="cuda", generator=torch.Generator("cuda").manual_seed(seed))
    quantize(model, weights=weights, activations=activations, exclude=exclude)
    if activations is not None:
        with torch.no_grad(), Calibration(model):
            for batch in calibration_batches(config):
                model(batch)
        still_on = [name for name, m in named_qmodules(model) if m.quantize_outputs]
        if still_on:
            raise RuntimeError(f"streamline left output quantization on for {still_on}")
    freeze(model)
    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    expected = LINEARS_PER_LAYER * config.num_hidden_layers + (0 if exclude else 1)
    layout = WeightQBytesArray if weights in ("qint8", "qfloat8") else WeightQBitsHopperArray
    if len(qlinears) != expected or not all(isinstance(m.weight, layout) for m in qlinears):
        raise RuntimeError(f"expected {expected} QLinears holding {layout.__name__}")
    return model, qlinears


def phase_main_path(K_mod, FD_mod, model, qlinears, ids):
    """Phase 4: qint4 Llama-3.1-8B prefill + greedy decode, with exact launch counts."""
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, generate, make_cache, prefill

    config = model.config
    small, tiled, fd = K_mod.qbits_mm_small_m, K_mod.qbits_mm_tiled, FD_mod.flash_decode

    # Warm-up through the user-facing `generate`; its tokens must equal the timed run's.
    ref_tokens = generate(model, ids, NEW)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cache = make_cache(model, B, T + NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(model, ids, cache, last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = (small.launches, tiled.launches, fd.launches)
    first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
    t0 = time.perf_counter()
    rest, cache = decode(model, first, cache, T, NEW - 1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {
        "qbits_mm_small_m": small.launches, "qbits_mm_tiled": tiled.launches, "flash_decode": fd.launches,
    }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    layers = config.num_hidden_layers
    n_lin = LINEARS_PER_LAYER * layers
    steps = NEW - 1
    if pre != (1, n_lin, 0):
        raise RuntimeError(f"prefill launches (small_m, tiled, flash_decode) = {pre}, want (1, {n_lin}, 0)")
    want = {
        "qbits_mm_small_m": 1 + (n_lin + 1) * steps, "qbits_mm_tiled": n_lin, "flash_decode": layers * steps,
    }
    if launches != want:
        raise RuntimeError(f"launches {launches}, want {want}")
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
    del cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


@torch.no_grad()
def phase_long_context(K_mod, FD_mod, model, qlinears):
    """Phase 4b: ctx-8192 decode over a qint4 KV cache, on the phase-4 model."""
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, make_cache

    config = model.config
    small, tiled, fd = K_mod.qbits_mm_small_m, K_mod.qbits_mm_tiled, FD_mod.flash_decode
    ids = torch.randint(
        0, config.vocab_size, (B, LONG_PROMPT), generator=torch.Generator().manual_seed(8)
    ).cuda()
    n_chunks = LONG_PROMPT // LONG_CHUNK
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cache = make_cache(model, B, LONG_SLOTS, kv_quant="qint4")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_chunks):
        p0 = i * LONG_CHUNK
        logits, cache = model(ids[:, p0 : p0 + LONG_CHUNK], cache, p0, logits_indices=LONG_CHUNK - 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = (small.launches, tiled.launches, fd.launches)
    first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
    t0 = time.perf_counter()
    rest, cache = decode(model, first, cache, LONG_PROMPT, NEW - 1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {
        "qbits_mm_small_m": small.launches, "qbits_mm_tiled": tiled.launches, "flash_decode": fd.launches,
    }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    layers = config.num_hidden_layers
    n_lin = LINEARS_PER_LAYER * layers
    steps = NEW - 1
    if pre != (n_chunks, n_chunks * n_lin, 0):
        raise RuntimeError(
            f"prefill launches (small_m, tiled, flash_decode) = {pre}, want ({n_chunks}, {n_chunks * n_lin}, 0)"
        )
    want = {
        "qbits_mm_small_m": n_chunks + (n_lin + 1) * steps,
        "qbits_mm_tiled": n_chunks * n_lin,
        "flash_decode": layers * steps,
    }
    if launches != want:
        raise RuntimeError(f"launches {launches}, want {want}")
    if logits.shape != (B, 1, config.vocab_size) or not torch.isfinite(logits).all():
        raise RuntimeError(f"prefill logits: shape {tuple(logits.shape)} or non-finite values")
    if rest.shape != (B, steps) or int(rest.min()) < 0 or int(rest.max()) >= config.vocab_size:
        raise RuntimeError("decoded token ids out of the vocabulary")

    cache_bytes = sum(
        t.numel() * t.element_size()
        for layer in cache
        for t in (layer._k_data, layer._v_data, layer._k_scale, layer._v_scale)
    )
    weight_bytes = sum(m.weight._packed.numel() + 8 * m.weight._scale_t.numel() for m in qlinears)
    # KV bytes a step reads: every visible slot's K and V rows and scales, at the mean fill.
    mean_fill = LONG_PROMPT + 1 + (steps - 1) / 2
    kv_step_bytes = cache_bytes * mean_fill / LONG_SLOTS
    log(json.dumps({
        "long_context": "llama-3.1-8b-config qint4+head4 bf16, qint4 KV cache",
        "batch": B, "cache_slots": LONG_SLOTS, "prompt": LONG_PROMPT, "prefill_chunk": LONG_CHUNK,
        "new_tokens": NEW, "decode_steps": steps,
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_per_step": decode_s / steps * 1e3,
        "decode_tok_s": B * steps / decode_s,
        "peak_memory_gb": peak_gb,
        "kv_cache_bytes": cache_bytes,
        "launches": launches,
        "decode_step_weight_bytes": weight_bytes,
        "decode_step_kv_bytes": kv_step_bytes,
        "decode_step_bound_ms": (weight_bytes + kv_step_bytes) / PEAK_BYTES_PER_S * 1e3,
    }))
    del cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def counters():
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from quanto_tpu_torch.ops.cuda import flash_decode as FD_mod
    from quanto_tpu_torch.ops.cuda import qbits_mm as K_mod
    from quanto_tpu_torch.ops.cuda import qbytes_mm as QB_mod

    return {
        "qbits_mm_small_m": K_mod.qbits_mm_small_m, "qbits_mm_tiled": K_mod.qbits_mm_tiled,
        "qbits_mm_int8_small_m": K_mod.qbits_mm_int8_small_m, "qbits_mm_tiled_int8": K_mod.qbits_mm_tiled_int8,
        "qbytes_mm_int8": QB_mod.qbytes_mm_int8, "qbytes_mm_e4m3fn": QB_mod.qbytes_mm_e4m3fn,
        "flash_decode": FD_mod.flash_decode,
    }


def read_counts() -> dict:
    return {name: w.launches for name, w in counters().items()}


def reset_counts() -> None:
    for w in counters().values():
        w.launches = 0


@contextlib.contextmanager
def plain_versions():
    """Route every kernel call of the model to its plain PyTorch version."""
    import quanto_tpu_torch.ops.attention as attention
    import quanto_tpu_torch.ops.qlinear as QL
    from quanto_tpu_torch.ops.cuda import flash_decode as FD_mod
    from quanto_tpu_torch.ops.cuda import qbits_mm as K_mod
    from quanto_tpu_torch.ops.cuda import qbytes_mm as QB_mod

    def flat(fn):
        def run(x, *args):
            out = fn(x.reshape(-1, x.shape[-1]).contiguous(), *args)
            return out.reshape(*x.shape[:-1], out.shape[-1])
        return run

    saved = (QL.qbits_mm, QL.qbits_int8_mm, QL.cuda_qbytes, attention.flash_decode)
    QL.qbits_mm = flat(K_mod.qbits_mm_plain)
    QL.qbits_int8_mm = flat(K_mod.qbits_int8_mm_plain)
    QL.cuda_qbytes = types.SimpleNamespace(eligible=QB_mod.eligible, qbytes_mm=flat(QB_mod.qbytes_mm_plain))
    attention.flash_decode = FD_mod.flash_decode_plain
    try:
        yield
    finally:
        QL.qbits_mm, QL.qbits_int8_mm, QL.cuda_qbytes, attention.flash_decode = saved


# Phase 5's arms: (quantize arguments, the kernel the ragged decode step must launch 7 x 2 times).
E2E_ARMS = {
    "qint4": (dict(weights="qint4"), "qbits_mm_small_m"),
    "qint8": (dict(weights="qint8", exclude="lm_head"), "qbytes_mm_int8"),
    "qfloat8": (dict(weights="qfloat8", exclude="lm_head"), "qbytes_mm_e4m3fn"),
    "w4a8": (dict(weights="qint4", activations="qint8", exclude="lm_head"), "qbits_mm_int8_small_m"),
}


def phase_end_to_end(ids):
    """Phase 5: 2 layers at full width, kernel path vs plain versions called
    explicitly, for each arm. Returns each arm's launch counts in its kernel run."""
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.serve import make_cache, prefill

    config = LlamaConfig(**dict(LLAMA31_8B, num_hidden_layers=2), dtype=torch.bfloat16)
    layers = config.num_hidden_layers
    ragged = torch.tensor([T, T - 4, T - 100, 300], device="cuda")
    step_ids = ids[:, -1:]
    arm_counts = {}
    for arm, (kw, step_kernel) in E2E_ARMS.items():
        model, _ = build_model(config, seed=1, **kw)

        @torch.no_grad()
        def run():
            """Prefill logits over a bf16 cache; one ragged decode step over a qint4 cache."""
            pre, _ = prefill(model, ids, make_cache(model, B, T), last_only=True)
            cache = make_cache(model, B, T + 8, kv_quant="qint4")
            _, cache = prefill(model, ids, cache, last_only=True)
            before = read_counts()
            step, _ = model(step_ids, cache, ragged)
            torch.cuda.synchronize()
            after = read_counts()
            return pre, step, {n: after[n] - before[n] for n in after}

        reset_counts()
        logits_k, step_k, step_counts = run()
        arm_counts[arm] = read_counts()
        want = {n: 0 for n in step_counts}
        want["flash_decode"] = layers
        want[step_kernel] = LINEARS_PER_LAYER * layers + (0 if kw.get("exclude") else 1)
        if step_counts != want:
            raise RuntimeError(f"{arm}: ragged decode step launches {step_counts}, want {want}")
        before = read_counts()
        with plain_versions():
            logits_p, step_p, _ = run()
        torch.cuda.synchronize()
        if read_counts() != before:
            raise RuntimeError(f"{arm}: the plain forward launched a kernel")
        for what, k_out, p_out in (("prefill", logits_k, logits_p), ("ragged decode step", step_k, step_p)):
            lk, lp = k_out[:, -1].float(), p_out[:, -1].float()
            cos = torch.nn.functional.cosine_similarity(lk, lp, dim=-1)
            top_k, top_p = lk.argmax(-1), lp.argmax(-1)
            log(json.dumps({"end_to_end": what, "arm": arm, "cosine": cos.tolist(),
                            "top1_kernel": top_k.tolist(), "top1_plain": top_p.tolist()}))
            if not bool((cos > 0.999).all()) or not torch.equal(top_k, top_p):
                raise RuntimeError(f"end-to-end {arm} {what} logits of the kernel path disagree with the plain path")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return arm_counts


def step_weight_bytes(model) -> int:
    """Bytes of every weight a decode step reads: the quantized linears'
    payloads, scales and shifts, and a float lm_head."""
    from quanto_tpu_torch.nn import QLinear

    total = 0
    for m in model.modules():
        if isinstance(m, QLinear):
            w = m.weight
            fields = (w._data, w._scale) if hasattr(w, "_data") else (w._packed, w._scale_t, w._shift_t)
            total += sum(t.numel() * t.element_size() for t in fields)
    if not isinstance(model.lm_head, QLinear):
        total += model.lm_head.weight.numel() * model.lm_head.weight.element_size()
    return total


@torch.no_grad()
def phase_arm(label: str, model, ids, want_prefill: dict, want_decode: dict) -> dict:
    """Phases 6 and 7: the 8B model's prefill (last position only) and 63 greedy
    decode steps over a bf16 cache of T + NEW slots, with exact launch counts of
    every kernel in each half. Returns the run's launch counts."""
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, generate, make_cache, prefill

    config = model.config
    steps = NEW - 1
    ref_tokens = generate(model, ids, NEW)  # warm-up through the user-facing entry point
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cache = make_cache(model, B, T + NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(model, ids, cache, last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = read_counts()
    first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
    t0 = time.perf_counter()
    rest, cache = decode(model, first, cache, T, steps)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dec = {n: launches[n] - pre[n] for n in launches}
    zeros = {n: 0 for n in launches}
    if pre != {**zeros, **want_prefill}:
        raise RuntimeError(f"{label}: prefill launches {pre}, want {want_prefill} and 0 elsewhere")
    if dec != {**zeros, **want_decode}:
        raise RuntimeError(f"{label}: decode launches {dec}, want {want_decode} and 0 elsewhere")
    if logits.shape != (B, 1, config.vocab_size) or not torch.isfinite(logits).all():
        raise RuntimeError(f"{label}: prefill logits: shape {tuple(logits.shape)} or non-finite values")
    if not torch.equal(torch.cat([ids, first, rest], dim=1), ref_tokens):
        raise RuntimeError(f"{label}: generate() and prefill + decode gave different tokens")
    if int(rest.min()) < 0 or int(rest.max()) >= config.vocab_size:
        raise RuntimeError(f"{label}: decoded token ids out of the vocabulary")
    weight_bytes = step_weight_bytes(model)
    log(json.dumps({
        "arm": label, "batch": B, "prompt": T, "new_tokens": NEW, "decode_steps": steps,
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_per_step": decode_s / steps * 1e3,
        "decode_tok_s": B * steps / decode_s,
        "peak_memory_gb": peak_gb,
        "prefill_launches": {n: c for n, c in pre.items() if c},
        "decode_launches": {n: c for n, c in dec.items() if c},
        "decode_step_weight_bytes": weight_bytes,
        "decode_step_bound_ms": weight_bytes / PEAK_BYTES_PER_S * 1e3,
    }))
    del cache, logits
    return launches


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
    from quanto_tpu_torch.ops.cuda import _build
    from quanto_tpu_torch.ops.cuda import flash_decode as FD_mod
    from quanto_tpu_torch.ops.cuda import qbits_mm as K_mod

    info = _build.build()
    log(f"build: {info['seconds']:.1f} s, {', '.join(info['sources'])} -> {info['path']}")
    if info["log"]:
        log(info["log"].strip())

    # Phase 3: kernels vs plain.
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    rows = phase_kernels(K_mod, flush) + phase_flash_decode(flush) + phase_qbytes(flush) + phase_w4a8(K_mod, flush)
    del flush
    torch.cuda.empty_cache()

    # Phases 4, 4b and 5.
    ids = torch.randint(
        0, LLAMA31_8B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(7)
    ).cuda()
    from quanto_tpu_torch.models.llama import LlamaConfig

    config = LlamaConfig(**LLAMA31_8B, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model, qlinears = build_model(config, seed=0)
    torch.cuda.synchronize()
    log(f"main path: built + quantized + frozen {config.num_hidden_layers} layers in "
        f"{time.perf_counter() - t0:.1f} s")
    launches_1088 = phase_main_path(K_mod, FD_mod, model, qlinears, ids)
    launches = phase_long_context(K_mod, FD_mod, model, qlinears)
    del model, qlinears
    gc.collect()
    torch.cuda.empty_cache()
    arm_counts = phase_end_to_end(ids)

    # Phases 6 and 7: the int8 and w4a8 arms of the 8B decode grid, one model at a time.
    n_lin, steps = LINEARS_PER_LAYER * config.num_hidden_layers, NEW - 1
    fd_decode = {"flash_decode": config.num_hidden_layers * steps}
    model, _ = build_model(config, seed=0, weights="qint8", exclude="lm_head")
    launches_int8 = phase_arm(
        "int8: llama-3.1-8b-config qint8 (lm_head bf16), bf16 cache", model, ids,
        want_prefill={}, want_decode={"qbytes_mm_int8": n_lin * steps, **fd_decode},
    )
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, _ = build_model(config, seed=0, weights="qint4", activations="qint8", exclude="lm_head")
    torch.cuda.synchronize()
    log(f"w4a8: built + quantized + calibrated ({CAL_BATCHES} x {B} x {CAL_T} tokens) + frozen in "
        f"{time.perf_counter() - t0:.1f} s")
    launches_w4a8 = phase_arm(
        "w4a8: llama-3.1-8b-config qint4 weights, qint8 activations (lm_head bf16), bf16 cache", model, ids,
        want_prefill={"qbits_mm_tiled_int8": n_lin},
        want_decode={"qbits_mm_int8_small_m": n_lin * steps, **fd_decode},
    )
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # Where each kernel's `launches` in the summary comes from: the long-context run for the
    # kernels of PRs 1-2, the phase-6/7 runs for this slice's; e4m3fn runs in phase 5 only.
    launch_runs = {
        "qbytes_mm_int8": ("phase 6 (int8)", launches_int8),
        "qbytes_mm_e4m3fn": ("phase 5 (qfloat8, 2 layers)", arm_counts["qfloat8"]),
        "qbits_mm_int8_small_m": ("phase 7 (w4a8)", launches_w4a8),
        "qbits_mm_tiled_int8": ("phase 7 (w4a8)", launches_w4a8),
    }
    kernels = []
    for name in [*KERNEL_M, "flash_decode", *QBYTES_M, *W4A8_M]:
        mine = [r for r in rows if r["name"] == name]
        if name == "flash_decode":
            rep = next(r for r in mine if (r["cache"], r["S"]) == FD_SUMMARY)
            shape = dict(cache=FD_SUMMARY[0], B=B, S=FD_SUMMARY[1], Hkv=FD_HEADS[0], G=FD_HEADS[1], D=FD_HEADS[2])
        else:
            rep = next(r for r in mine if (r["M"], r["N"], r["K"]) == SUMMARY_SHAPE[name])
            shape = list(SUMMARY_SHAPE[name])
        run, counts = launch_runs.get(name, ("phase 4b (ctx 8192)", launches))
        extra = {} if name in launch_runs else {"launches_ctx1088": launches_1088[name]}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
            launches=counts[name], launches_run=run, **extra,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            shape=shape,
        ))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
