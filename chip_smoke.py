#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card
    python3 chip_smoke.py --only sweep,serving   # phases 1-2, phase 3's small-M sweep and
                                                 # phase 15 alone (a tree's kernels, A/B)
    python3 chip_smoke.py --only prefill         # phases 1-2, phase 3's tiled, requant and MoE
                                                 # rows, the prefills of phases 4 and 7, phases
                                                 # 10, 8, 12, phase 11's B = 1 prefill, phase 13
                                                 # (a tree's kernels, A/B)
    python3 chip_smoke.py --only qbytes,moe      # phases 1-2, phase 3's 8-bit sweep and MoE rows,
                                                 # phase 6 and its phase-15 serial arm, phase 8
                                                 # at B = 4 and 16 (a tree's kernels, A/B)
    python3 chip_smoke.py --only decode          # phases 1-2, phase 3's flash_decode and TPU #15
                                                 # rows, the decode steps of phases 4, 4b, 10 and
                                                 # 8 (B = 4 and 16) (a tree's kernels, A/B)
    python3 chip_smoke.py --only checkpoint      # phases 1-2 and 16 (save, load, run again)
    python3 chip_smoke.py --only numerics        # phases 1-2, phase 3's W8A8, padded and small-head
                                                 # rows, phases 17-19 (W8A8, SmolLM2, Qwen2.5)
    python3 chip_smoke.py --only paged           # phases 1-2, phase 3's rows of the paged arm of
                                                 # flash_decode, phase 20 (PagedEngine)

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
   every slot visible, and float32 q (the CUDA-core arm) over the bf16 and
   qint4 caches of 8192 slots; yardstick `scaled_dot_product_attention` (GQA,
   boolean mask) on the cache dequantized to bf16; each row also gives the
   host's µs a call (`host_us`). Times are CUDA-event medians with the L2
   cache flushed before each launch, as the main path finds it.
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
   The 8-bit weight-only kernel (int8 and e4m3fn payloads, M in {1, 4, 8,
   16, 32, 64, 128, 256}) and the W4A8 kernels (int8 small-M at M in {4, 512}, int8 tiled at M in
   {513, 4096}) at the four linear shapes, bf16 x or output, yardstick
   `torch.matmul` on the operands dequantized to bf16 (the tiled int8 rows
   also `torch._int_mm` on the int8 codes, `int_mm_ms`). Every row of TPU #2
   (`qbits_mm_tiled`, `qbits_mm_tiled_int8`, both widths) carries its share of
   its bound (`bound_share`). The W4A8 requant
   kernel at M in {2048, 4096} and the four linear shapes, held EQUAL to its
   plain version (bf16 out), timed beside the exact route
   (`qbits_mm_tiled_int8`) at the same shape; its first pass alone
   (`requant_pass`: the codes EQUAL to `requant_codes`, its time and its
   workspace's bytes); yardstick `torch._int_mm` on the requantized int8
   weight.
5. end-to-end numerics: at full width and 2 layers, the kernel path against
   the same forward through the plain versions called explicitly: the
   prefill's last-position logits (bf16 cache), and one decode step at
   ragged per-row positions over a qint4 cache; for qint4 weights (lm_head
   included), and for qint8, qfloat8 (e4m3fn) and calibrated W4A8 weights
   (lm_head excluded), and the W4A8 model frozen again into the requant
   form (its prefill through `qbits_mm_requant_int8`), also held against
   the exact form of the same weights (`check_requant_vs_exact`).
6. the `int8` arm of the JAX package's 8B decode grid (`bench.py:main_8b`):
   the Llama-3.1-8B configuration, `quantize(weights="qint8",
   exclude="lm_head")`, `freeze`; the prefill and decode of phase 4, with
   exact launch counts (prefill M = 4096 takes the XLA formula, each decode
   step 224 launches of the 8-bit kernel); then phase 15's serial arm on
   that model (below).
7. the `w4a8` arm: `quantize(weights="qint4", activations="qint8",
   exclude="lm_head")`, `Calibration` over 2 batches of 4 x 128 seeded
   tokens (streamline must turn output quantization off for all 224
   linears), `freeze`; the same prefill and decode, with exact launch counts.
10. the serving engine (run right after phase 7, on its model frozen again
   with `freeze(model, w4a8_requant_dot=True)`): `BatchedEngine` with 8
   slots, max_len 4352 and prefill chunks of 512 over a bf16 cache, the
   `--long-ctx` slice of the JAX package's serving bench. Batch arm:
   `add_batch` of 8 prompts of 3200-4096 tokens (8 chunk forwards of
   [8, 512], M = 4096), then `run_to_completion(burst=16)` for 128 new
   tokens each. Stream arm: `add_batch` of 4 x 1024 tokens, then 4 prompts
   of 3328-4096 tokens `enqueue`d, their chunks riding the decode steps as
   mixed steps, drained with bursts of 16, 64 new tokens each. Every chunk
   forward must launch exactly 224 `qbits_mm_requant_int8`, every decode
   forward 224 `qbits_mm_int8_small_m` and 32 `flash_decode`, and nothing
   else; every request returns its max_new_tokens, and its first token is
   the argmax of a standalone `prefill(last_only=True)` of its prompt over a
   cache of the engine's length, or a logit tie (LOGIT_TIE). Prints prefill
   ms per chunk and tok/s, decode ms/step and tok/s, mixed-step ms, peak
   memory and the bounds.
3 (MoE). The two MoE kernels against their plain version over 8 stacked
   experts at both Mixtral-8x7B projection shapes (14336 x 4096, 4096 x
   14336), bf16 x, float32 outputs: `qbits_moe_small_m` in its selective form
   (nsel = 2), all form (S = 8, and TPU #12's own rows at S = 9, 16 and 32,
   over the 8 experts) and uniq form (S = 8 over a 6-expert table); `qbits_moe_tiled` over 8 slabs of M in {8, 512, 2048}
   and over 8 slabs of 2048 rows with a routed-first table and 6 live slots;
   and both kernels at phase 8's B = 4 decode shapes: M = 4 over 8 slots of a
   routed-first table with a device count of 6 or 8 live slots (gate/up over
   shared rows, down over per-slot rows); `qbits_moe_tiled` also at the B = 16
   step's down call (8 slots of 16 rows of their own, no table; its M <= 16
   arm, TPU #15, as at B = 4). Yardstick: one `torch.bmm` over the live slots'
   experts, gathered and dequantized to bf16 beforehand. Bound: the live
   experts' bytes once. Each row also gives the host's µs a call.
8. Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1 config.json; 32 layers, full
   width, 8 experts, top-2), random weights from a seed, built on "meta" and
   materialized one decoder layer at a time (`quantize(weights="qint4")`,
   `freeze`, `convert_moe_to_stacked(capacity_factor=2.0)` on each layer;
   lm_head bf16), so the card never holds the 93 GB bf16 model. B = 4 x 1024-
   token prompts (prefill through the capacity gather, then 63 greedy decode
   steps through the unique-expert route over a bf16 cache of 1088 slots),
   B = 1 (the selective route) and B = 16 x 256-token prompts (31 decode
   steps through the all-experts route: gate and up through TPU #12,
   `qbits_moe_all`, 64 launches a step), each with exact launch counts per
   prefill and per decode step; one MoE block's decode forward at B = 1, 4
   and 16 under `torch.cuda.set_sync_debug_mode("error")`.
9. Mixtral end-to-end numerics at full width and 2 layers: the stacked model
   against the same model's dense-mask blocks (through `qbits_mm`), and
   against the stacked model through the plain versions called explicitly:
   the prefill's last-position logits and one decode step, at B = 1 and 4,
   and at B = 16 x 256 the decode step (the all-experts route) from one
   prefill cache in every path (its prefill logits logged only), for two
   weight seeds. Every layer's routing is recorded: a row routed
   alike by both paths needs cosine > MIXTRAL_E2E_COS and the same top-1
   token unless its two logits tie (LOGIT_TIE); a row routed differently
   needs a routing tie (ROUTE_TIE) in each layer where it differs.

3 (int2). The int2 arms of the four float-x kernels over random packed bytes
   (every 2-bit code in every position of a byte), bf16 x: `qbits_mm_small_m`
   at M in {4, 8} and `qbits_mm_tiled` at M = 1024 over the four linear
   shapes; `qbits_moe_small_m` in its selective form, its all form at S = 16
   and both MoE kernels at phase 12's B = 4 decode shapes, `qbits_moe_tiled`
   over 8 slabs of 512 rows; bounds with the int2 payload's bytes.
11. Llama-3.1-8B in qint2 (`quantize(weights="qint2", exclude="lm_head")`,
   group size 128, `freeze`): the decode run of phase 6 (B = 4 x 1024, 63
   greedy steps; every step exactly 224 launches of `qbits_mm_small_m`'s
   int2 arm, the M = 4096 prefill none: an int2 weight takes no kernel above
   M = 1024, as in JAX) and a B = 1 prefill of 1024 tokens (exactly 224
   launches of `qbits_mm_tiled`'s int2 arm); then the 2-layer check of that
   model, kernel path against the plain versions: the B = 1 prefill's and a
   decode step's logits, cosine > INT2_E2E_COS and top-1 tokens equal or at
   a logit tie.
12. Mixtral-8x7B with qint2 experts (`quantize(layer, weights="qint2",
   include="*experts*")`) and qint4 attention and router, lm_head bf16, built
   as phase 8 builds it: the B = 4 and B = 1 runs of phase 8 with exact
   launch counts of each MoE route's int2 arm and of the attention's int4
   launches, the no-sync check, and phase 9's check at 2 layers (one seed).

3 (W2A8). The int2 arms of the three int8-x kernels over random packed bytes
   (every 2-bit code in every position of a byte), int8 x, bf16 output, at the
   four linear shapes: `qbits_mm_int8_small_m` at M in {4, 8} and
   `qbits_mm_tiled_int8` at M in {513, 1024} within the W4A8 rows'
   tolerance; `qbits_mm_requant_int8` at M in {2048, 4096} held EQUAL to its
   plain version and timed beside the exact int2 route at that M
   (dequantize + `torch.matmul`: JAX's `_prefill_route` refuses int2 above
   M = 1024). Bounds with the int2 payload's bytes.
13. Llama-3.1-8B in W2A8 (`quantize(weights="qint2", activations="qint8",
   exclude="lm_head")`, group size 128, calibrated as phase 7, `freeze`):
   (a) phase 6's decode run (every step exactly 224 launches of
   `qbits_mm_int8_small_m`'s int2 arm and 32 `flash_decode`; the M = 4096
   prefill none, as in JAX) and a B = 1 prefill of 1024 tokens (exactly 224
   launches of `qbits_mm_tiled_int8`'s int2 arm); (b) frozen again with
   `freeze(model, w4a8_requant_dot=True)`, every linear in the requant form,
   and phase 6's run again, its M = 4096 prefill through exactly 224
   launches of `qbits_mm_requant_int8`'s int2 arm; prefill ms, decode
   ms/step, tok/s and peak memory beside their bounds; (c) at 2 layers, the
   kernel path against the plain versions (B = 1 prefill, B = 4 prefill, a
   ragged decode step; cosine > W2A8_E2E_COS and top-1 equal or at a logit
   tie), in both forms, and the requant form against the exact form
   (`check_requant_vs_exact`, phase 5's limits). Prints its seconds.
3 (sweep). The two small-M kernels over the M they take: `qbits_mm_small_m`
   (bf16 x) and `qbits_mm_int8_small_m` (int8 x, bf16 output), int4 and int2
   codes over random packed bytes, at M in {1, 4, 8, 16, 32, 64, 128, 256,
   512} on 14336 x 4096 and 4096 x 14336 and at M in {1, 4} on the lm_head
   (128256 x 4096), with phase 3's check; yardstick `torch.matmul` on the bf16
   operands. The 8-bit weight-only kernel (TPU #6/#7) is swept the same
   way: both payloads at M in {1, 4, 8, 16, 32, 64, 128, 256} on the four
   linear shapes, each row with its bound's share.
3 (#5). `qbits_mm_partitioned`'s rank-local product (`_local_mm`: the int4
   kernel on the rank's part, cast up to float32) at each tp = 2 shard of
   Llama-3.1-8B (q 2048 x 4096, k/v 512 x 4096, o 4096 x 2048, gate/up 7168 x
   4096, down 4096 x 7168, lm_head 64128 x 4096) and M in {4, 4096}, against
   its plain version; yardstick `torch.matmul` on the part dequantized to
   bf16.
15. the default 8B slice of the JAX package's serving bench
   (bench/serving_bench.py without `--long-ctx`): `BatchedEngine` with 8
   slots, max_len 768 and prefill chunks of 64 over a bf16 cache, prompts of
   512, 384, 448, 256, 512, 320, 192 and 448 random ids, 128 new tokens each,
   decode bursts of 16; run on phase 4's qint4 model (before it is deleted)
   and on phase 7's calibrated W4A8 model in the exact form (before phase 10
   freezes it again). Two arms on each, on a fresh engine: serial `add` of
   every prompt ([1, 64] chunk forwards, M = 64) and `add_batch` ([8, 64],
   M = 512), each drained by `run_to_completion(burst=16)` (decode at M = 8).
   Every forward launches exactly 224 `qbits_mm_small_m` (qint4) or
   `qbits_mm_int8_small_m` (W4A8) at its M (a pre-hook on each quantized
   linear records the M), one more at M = its rows for the qint4 lm_head, 32
   `flash_decode` at decode, and nothing else; every request returns 128 ids
   in the vocabulary and its first token is a standalone prefill's or at a
   logit tie. Prints the median ms per chunk beside its linears' bound, time
   to first token, decode ms/step beside the bytes a step reads, tok/s and
   peak memory. On phase 6's int8 model (lm_head bf16) only the serial arm
   runs, every forward exactly 224 `qbytes_mm_int8` (chunks at M = 64,
   decode at M = 8): the batch arm's M = 512 lies outside that kernel's
   envelope and takes JAX's XLA formula.
14. tensor parallelism: 2 ranks (`torch.multiprocessing` spawn, a `file://`
   store) share the one card over gloo (NCCL refuses two ranks on one
   device). Each rank builds phase 4's model from phase 4's seed, each
   decoder layer quantized, frozen and sharded at tp = 2 as it is drawn
   (`shard_model`), and times gloo's all_reduce of float32 [4, 4096] and
   [4096, 4096]. (a) phase 4's run (prefill of B = 4 x 1024, 63 greedy decode
   steps over a bf16 cache of 1088 slots), with each rank's exact counts: 224
   `qbits_mm_tiled` and 1 `qbits_mm_small_m` in the prefill, 225
   `qbits_mm_small_m` and 32 `flash_decode` a decode step, 225
   `qbits_mm_partitioned` launches and 66 all_reduces a forward (64 row
   linears, the embedding, the gathered logits); the ranks' tokens equal. Then
   phase 4's tokens fed to the TP model (teacher forcing): at the prefill's
   last position and each of the 63 steps, 1 - cosine against phase 4's
   logits within TP_1MCOS, and a top-1 token other than phase 4's only at a
   phase-4 logit gap within TP_TOP1_GAP; and a witness of the cause, the
   prefill with float32 row partials, closer to phase 4's by TP_WITNESS_FALL
   at least. (b) phase 5's 2-layer check of the qint4 and
   calibrated W4A8 arms on each rank, sharded after freezing. Every time it
   prints is labelled: 2 ranks sharing one H100 over gloo measure no TP
   speed. A rank that fails fails the phase.
16. checkpoints: for phase 4's qint4 model and phase 7's calibrated W4A8
   model (full depth), phase 6's qint8 quantization and Mixtral-8x7B qint4
   (lm_head bf16, per-expert modules) at full width and CKPT_LAYERS layers,
   each built anew: `QuantizedModelForCausalLM(model).save_pretrained` into a
   `tempfile.mkdtemp()` (its free space printed; under twice the model's
   bytes raises), fsync'd and dropped from the page cache; the run of the
   phase that built it on the original (phase 4's, 7's and 6's: prefill of B
   = 4 x 1024 and 63 decode steps; phase 8's at B = 4, after
   `convert_moe_to_stacked`); the model freed; `from_pretrained` on the card
   (peak device memory within the loaded model's bytes + CKPT_LOAD_MARGIN);
   the streamline flags set from the original's (quanto's format does not
   hold them); Mixtral converted again; every tensor a forward reads, the
   prefill logits, the tokens and the launch counts EQUAL to the original's;
   the W4A8 model frozen into the requant form with the original's `_s8`
   (phase 10's conversion). One JSON line per model: saved bytes, shards,
   save and load seconds, load GB/s, peak device memory during the load.
3 (numerics). The W8A8 route (`ops/qbytes_mm.py`: `torch._int_mm` for
   int8 x int8, JAX's convert formula on bf16 operands for e4m3fn x e4m3fn,
   no TPU kernel) at M in W8A8_M over the four linear shapes against its
   plain formula (int8 EQUAL, e4m3fn within 1e-5 * max|ref|; beside it
   `torch._scaled_mm`'s error and time); #1, #2 (both arms) and #4 at SmolLM2-360M's and Qwen2.5-0.5B's
   linears off the envelope, zero-padded (`PADDED_SHAPES`; the bound on the
   true bytes, the padded bytes' ratio and `pad_activations`' time beside
   it); `flash_decode` at (Hkv, G, D) = (5, 3, 64) and (2, 7, 64) over bf16,
   qint8 and qint4 caches of 1088 slots.
17. W8A8 Llama-3.1-8B at full depth and width (lm_head bf16): qint8, then
   qfloat8_e4m3fn, weights and activations, calibrated as phase 7: phase 6's
   run with exactly 224 W8A8 library calls a forward (`torch._int_mm`; the
   e4m3fn product on the bf16 tensor cores) and 32 `flash_decode` a
   step, no other kernel and no weight dequantized (the hidden state is
   float32 after the first W8A8 linear, as in JAX); the prefill logits
   against the plain formula's: int8 EQUAL, e4m3fn within W8A8_FP8_COS (and
   at 2 layers within W8A8_FP8_COS_2L with the same top-1 tokens).
18. SmolLM2-360M (published config, random weights; every linear padded):
   (a) qint4 with `HqqOptimizer()`, its error at most `MaxOptimizer`'s for
   every linear (seconds of each), phase 6's run (224 `qbits_mm_tiled` in
   the prefill, 224 `qbits_mm_small_m` + 32 `flash_decode` a step) and the
   prefill against the plain versions (SMALL_E2E_COS); (b) calibrated W4A8
   through #2's int8 arm and #4, the same; (c) QAT in float32 (qint4 +
   qint8 activations, calibrated), QAT_STEPS steps with finite gradients and
   a falling loss, then `freeze` onto the padded kernels, its logits against
   the QAT forward's within QAT_FROZEN_COS.
19. Qwen2.5-0.5B (published config, random weights and q/k/v biases), qint4
   (the K = 896 linears padded, `down_proj` not): phase 6's run (168
   `qbits_mm_tiled`; 168 `qbits_mm_small_m` + 24 `flash_decode` a step), the
   plain-version check, and phase 16's save -> load -> run again.

3 (paged). The paged arm of `flash_decode` (`flash_decode_paged`, TPU #8-#10
   over a paged cache): Hkv = 8, G = 4, D = 128, B = 8 rows at their last
   slot over 768 and 4352 slots a row, pages of 64 and 16 behind a table that
   is a random permutation of the pool's pages, bf16, qint8, qint4 and qint4a
   caches, and float32 q over qint4; each row EQUAL to the dense arm on the
   pages gathered through the table and within the dense rows' limits of its
   plain version, timed beside that dense call, the gather + dense call
   (JAX's route) and SDPA on the gathered cache dequantized to bf16.
20. `PagedEngine` (run right after phase 15, on phase 4's model): phase 15's
   requests admitted by `add` (bursts of 16). (b) pages of 64 over a bf16
   cache, reserved in full, no sharing, 65 pages: tokens EQUAL to phase 15's
   serial arm or a recorded tie within SERVE_TOP1_GAP. (c) the prompts
   sharing their first 128 ids, over a qint4 cache, pages reserved for the
   prompt and grown on demand, prefix sharing on, 41 pages: at least one
   preemption and one prefix hit, tokens held to the unshared full-reserve
   run the same way. Every forward exactly 224 + 1 `qbits_mm_small_m`, every
   decode forward 32 `flash_decode_paged`, no dense `flash_decode` and no
   gathered view of the pages. Prints ms per chunk beside its bound, time to
   first token, decode ms/step beside its bytes, peak memory, the pool's KV
   bytes beside `BatchedEngine`'s 8 x 768 and the three counters.

`--only prefill` runs phases 1-2 and the prefill paths of TPU #2, #3 and #14
alone: phase 3's #2 rows (both arms, both widths), requant and MoE rows (and
the W4A8 and `flash_decode` rows phase 10 reads); phase 4's qint4 prefill
(B = 4 x 1024, no decode) and phase 7's exact-form W4A8 prefill, each timed
after a warm-up with its exact launch counts and peak memory; phase 10 on
phase 7's model frozen into the requant form; phases 8 and 12 (B = 4, then
1); phase 11's B = 1 prefill; phase 13 (a, b). `--only qbytes,moe` runs
phases 1-2 and the paths of TPU #6/#7 and #11-#13 alone: phase 3's 8-bit
sweep and MoE rows (int4 and int2), phase 6 and phase 15's serial arm on its
model, phase 8 at B = 4 and B = 16. `--only decode` runs phases 1-2 and
the decode paths of TPU #8-#10 and #15 alone: phase 3's `flash_decode` rows
and the MoE rows at M <= 16 (int4 and int2; the W4A8 small-M rows phase 10
reads), phase 4's qint4 run at ctx 1088 and phase 4b's at ctx 8192 (each
prefill, then 63 decode steps, exact counts), phase 10 on phase 7's model
frozen into the requant form, and phase 8 at B = 4 and B = 16. Copied into
another tree's checkout, each of these modes times that tree's kernels beside
this one's in one call. `--only checkpoint` runs phases 1-2 and 16 alone.
`--only numerics` runs phases 1-2, phase 3's numerics rows and phases 17-19.
`--only paged` runs phases 1-2, phase 3's paged rows and phase 20 (with phase
15's serial arm as its reference).

The second-to-last line is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import copy
import ctypes
import dataclasses
import functools
import gc
import json
import mmap
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
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
    "qbits_mm_small_m": "quanto_tpu_torch/csrc/qbits_mm_small_m.cu",
    "qbits_mm_tiled": "quanto_tpu_torch/csrc/qbits_mm_tiled.cu",
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
FD_F32_Q = ["bf16", "qint4"]  # caches of 8192 slots also read with float32 q (the CUDA-core arm)
# The kernels of this slice: their phase-3 M values at the four linear shapes (no lm_head:
# the 8-bit and W4A8 arms exclude it), summary shapes, sources and the TPU kernels they replace.
LINEAR_SHAPES = SHAPES[:4]
# The 8-bit weight-only kernel (TPU #6/#7): every M it takes, both payloads (phase 3's sweep).
QBYTES_SWEEP_M = (1, 4, 8, 16, 32, 64, 128, 256)
QBYTES_M = {"qbytes_mm_int8": QBYTES_SWEEP_M, "qbytes_mm_e4m3fn": QBYTES_SWEEP_M}
W4A8_M = {"qbits_mm_int8_small_m": (4, 8, 512), "qbits_mm_tiled_int8": (513, 4096)}  # M = 8: phase 10's decode
SUMMARY_SHAPE.update({
    "qbytes_mm_int8": (4, 14336, 4096), "qbytes_mm_e4m3fn": (4, 14336, 4096),
    "qbits_mm_int8_small_m": (4, 14336, 4096), "qbits_mm_tiled_int8": (4096, 14336, 4096),
})
SOURCE.update({
    "qbytes_mm_int8": "quanto_tpu_torch/csrc/qbytes_mm.cu",
    "qbytes_mm_e4m3fn": "quanto_tpu_torch/csrc/qbytes_mm.cu",
    "qbits_mm_int8_small_m": "quanto_tpu_torch/csrc/qbits_mm_small_m.cu",
    "qbits_mm_tiled_int8": "quanto_tpu_torch/csrc/qbits_mm_tiled.cu",
})
REPLACES.update({
    "qbytes_mm_int8": "quanto_tpu/ops/pallas/qbytes_mm.py:30",
    "qbytes_mm_e4m3fn": "quanto_tpu/ops/pallas/qbytes_mm.py:108",
    "qbits_mm_int8_small_m": "quanto_tpu/ops/pallas/qbits_mm.py:577",
    "qbits_mm_tiled_int8": "quanto_tpu/ops/pallas/qbits_mm.py:223 (int8-x arm, :248-251)",
})

# The W4A8 requant kernel (phase 3): the route's least M and the M of phase 10's [8, 512] chunks.
REQUANT_M = (2048, 4096)
SUMMARY_SHAPE["qbits_mm_requant_int8"] = (4096, 14336, 4096)
SOURCE["qbits_mm_requant_int8"] = "quanto_tpu_torch/csrc/qbits_mm_requant.cu"
REPLACES["qbits_mm_requant_int8"] = "quanto_tpu/ops/pallas/qbits_mm.py:401"

# The MoE kernels (phase 3): Mixtral-8x7B's expert shapes (N, K), the forms each kernel is run in.
MOE_SHAPES = [(14336, 4096), (4096, 14336)]
MOE_EXPERTS = 8
MOE_SEL_EIDS = [3, 5]  # the selective form: nsel = 2 pairs on two experts
MOE_UNIQ_EIDS = [6, 1, 3, 0, 7, 4]  # the uniq form: 6 of the 8 experts
MOE_S = 8
# TPU #12 (`_moe_all_kernel`): every expert over the same S rows, at the S its route takes
# (`parallel/moe.py`: S·K > 2E and S <= 32, so 9-32 rows at Mixtral's E = 8, top-2); int2 at S = 16.
MOE_ALL_S = {4: (9, 16, 32), 2: (16,)}
MOE_TILED_M = (8, 512, 2048)
MOE_INT2_TILED_M = (512,)  # phase 12's B = 1 prefill: capacity slabs of 512 rows
# The B = 4 decode step's unique-expert route (S = 4 rows, S·K = 8 = E): both kernels over 8 slots
# of a routed-first table (the routed experts ascending, then the others) with the routed count
# on the device, as `StackedSparseMoeBlock._uniq_boundary` builds them; 6 and all 8 routed.
MOE_DECODE_M = 4
MOE_DECODE_TABLES = [(6, [0, 2, 3, 5, 6, 7, 1, 4]), (8, list(range(8)))]
# `qbits_moe_tiled` over a routed-first table at prefill slabs (8 x 2048, 6 of 8 live).
MOE_PREFILL_UNIQ = MOE_DECODE_TABLES[0]
# (form, nslots, M, N, K) of the MoE summary entries: the B = 4 decode step's gate/up call with all
# 8 experts routed (the run its launches come from), and the prefill's gate/up GEMM.
# `qbits_moe_all` is TPU #12's own entry: `qbits_moe_small_m`'s all form (no table), counted apart,
# its summary row the B = 16 decode step's gate/up call.
SUMMARY_SHAPE.update({
    "qbits_moe_small_m": ("uniq", 8, 4, 14336, 4096), "qbits_moe_tiled": ("experts", None, 2048, 14336, 4096),
    "qbits_moe_all": ("all", None, 16, 14336, 4096),
})
SOURCE.update({
    "qbits_moe_small_m": "quanto_tpu_torch/csrc/moe_mm.cu",
    "qbits_moe_tiled": "quanto_tpu_torch/csrc/moe_mm.cu",
    "qbits_moe_all": "quanto_tpu_torch/csrc/moe_mm.cu",
    "qbits_moe_tiled_small_m": "quanto_tpu_torch/csrc/moe_mm.cu",
})
REPLACES.update({
    "qbits_moe_small_m": "quanto_tpu/ops/pallas/moe_mm.py:75, quanto_tpu/ops/pallas/moe_mm.py:183, "
                         "quanto_tpu/ops/pallas/moe_mm.py:225",
    "qbits_moe_tiled": "quanto_tpu/ops/pallas/moe_mm.py:330, quanto_tpu/ops/pallas/moe_mm.py:337",
    "qbits_moe_all": "quanto_tpu/ops/pallas/moe_mm.py:183",
    "qbits_moe_tiled_small_m": "quanto_tpu/ops/pallas/moe_mm.py:337 (qbits_moe_tiled at M <= 16)",
})
# TPU #15 on the main path: `qbits_moe_tiled`'s M <= 16 arm, counted apart (`launches_small_m`), its
# summary row the B = 4 decode step's down call with all 8 experts routed. The B = 16 step's down
# call (8 slots of 16 rows, no table) is a phase-3 row of its own.
SUMMARY_SHAPE["qbits_moe_tiled_small_m"] = ("uniq", 8, 4, 4096, 14336)

# The int2 arms of the four float-x kernels (phase 3): the small-M kernel at phase 11's decode
# (M = 4) and at M = 8, the tiled one at its B = 1 prefill (M = 1024, the int2 route's largest M),
# over the four linear shapes; the MoE kernels at phase 12's shapes (`phase_moe`). Each arm is a
# summary entry of its own, its launches from phase 11 or 12.
INT2_KERNEL_M = {"qbits_mm_small_m": (4, 8), "qbits_mm_tiled": (1024,)}
# The int2 arms of the three int8-x kernels (W2A8, phase 3): the small-M kernel at phase 13's decode
# (M = 4) and at M = 8, the tiled one just above its least M and at phase 13's B = 1 prefill
# (M = 1024), the requant kernel at REQUANT_M (phase 13's requant prefill is M = 4096).
W2A8_M = {"qbits_mm_int8_small_m": (4, 8), "qbits_mm_tiled_int8": (513, 1024)}
INT2_ARMS = ["qbits_mm_small_m", "qbits_mm_tiled", "qbits_moe_small_m", "qbits_moe_tiled",
             "qbits_moe_tiled_small_m", "qbits_mm_int8_small_m", "qbits_mm_tiled_int8", "qbits_mm_requant_int8"]
SUMMARY_SHAPE.update({
    "qbits_mm_small_m_int2": (4, 14336, 4096), "qbits_mm_tiled_int2": (1024, 14336, 4096),
    "qbits_moe_small_m_int2": ("uniq", 8, 4, 14336, 4096),
    "qbits_moe_tiled_int2": ("experts", None, 512, 14336, 4096),
    "qbits_moe_tiled_small_m_int2": ("uniq", 8, 4, 4096, 14336),
    "qbits_mm_int8_small_m_int2": (4, 14336, 4096), "qbits_mm_tiled_int8_int2": (1024, 14336, 4096),
    "qbits_mm_requant_int8_int2": (4096, 14336, 4096),
})
for _arm in INT2_ARMS:
    SOURCE[_arm + "_int2"] = SOURCE[_arm]
    REPLACES[_arm + "_int2"] = REPLACES[_arm] + " (int2 arm)"

# TPU kernel #5, `qbits_mm_partitioned` (phase 3 and phase 14): Llama-3.1-8B at tp = 2, each rank's
# part (N x K) of every sharded linear; q/k/v/gate/up/lm_head column shards, o/down row shards. Phase
# 3 times the rank-local product at decode (M = 4) and prefill (M = 4096); phase 14's ranks time
# gloo's all_reduce of the float32 partials of a row shard at those M.
TP_WORLD = 2
TP_SHARDS = {
    "q_proj": (2048, 4096), "k_proj, v_proj": (512, 4096), "o_proj": (4096, 2048),
    "gate_proj, up_proj": (7168, 4096), "down_proj": (4096, 7168), "lm_head": (64128, 4096),
}
TP_M = (4, 4096)
TP_ALL_REDUCE = [(4, 4096), (4096, 4096)]
SUMMARY_SHAPE["qbits_mm_partitioned"] = (4, 4096, 7168)  # the down_proj shard at decode
SOURCE["qbits_mm_partitioned"] = "quanto_tpu_torch/ops/cuda/qbits_mm_sharded.py"
REPLACES["qbits_mm_partitioned"] = "quanto_tpu/ops/pallas/qbits_mm_sharded.py:146"
TP_LABEL = "2 ranks sharing one H100 over gloo; not a TP speed"

# mistralai/Mixtral-8x7B-v0.1 config.json (default rope, no sliding window, untied embeddings).
MIXTRAL_8X7B = dict(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    rope_theta=1e6,
    rms_norm_eps=1e-5,
    num_local_experts=8,
    num_experts_per_tok=2,
)

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
# Mixtral serving 16 sequences: every decode step's MoE blocks take the all-experts route (TPU #12
# for gate and up). 16 prompts of 256 tokens (a prefill of S = 4096, as B x T), 31 decode steps.
B16, T16, NEW16 = 16, 256, 32
CAL_BATCHES, CAL_T = 2, 128
LINEARS_PER_LAYER = 7
# Long context: the JAX package's headline decode (ctx 8192, qint4 cache).
LONG_SLOTS, LONG_PROMPT, LONG_CHUNK = 8192, 8128, 1016
# Phase 10, the serving engine: the `--long-ctx` slice of the JAX package's serving bench
# (bench/serving_bench.py:77-79): 8 slots, max_len 4352, chunks of 512 (M = 8 x 512 = 4096).
ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_CHUNK = 8, 4352, 512
ENGINE_BATCH = [4096, 3328, 3840, 3584, 4096, 3456, 3200, 3968]  # serving_bench.py:78
ENGINE_BATCH_NEW = 128
# The stream arm: four 1024-token prompts decoding, then four long prompts enqueued.
ENGINE_SHORT, ENGINE_SHORT_NEW = (4, 1024), 64
ENGINE_STREAM, ENGINE_STREAM_NEW = [3328, 3584, 3840, 4096], 64
# flash_decode at phase 10's decode step (phase 3): 8 rows over the engine's bf16 pool of 4352
# slots, at positions like each arm's: every row decoding a long prompt (batch arm), four rows at
# a 1024-token prompt's and four at a long one's (stream arm), and four free rows at 0.
FD_ENGINE_POS = {
    "batch": [3200, 4224, 3712, 3456, 4096, 3328, 3968, 3584],
    "stream": [1040, 3400, 1056, 3700, 1072, 3950, 1088, 4200],
    "free": [0, 3200, 0, 3712, 0, 4224, 0, 3968],
}
# Phase 3's sweep of the two small-M kernels (#1 at bf16 x, #4 at int8 x and bf16 output) over the
# M they take, at both code widths: the gate/up and down shapes at SWEEP_M, the lm_head at M = 1, 4.
SWEEP_M = (1, 4, 8, 16, 32, 64, 128, 256, 512)
SWEEP_SHAPES = [((14336, 4096), SWEEP_M), ((4096, 14336), SWEEP_M), ((128256, 4096), (1, 4))]
# Phase 15's first-token check: the engine's chunks (M = 64 or 512) and the standalone prefill
# (M = the batched prompts' rows, 192-1024) take kernels whose float32 sums are ordered by their
# M tiles and K splits, so a bf16 output moves by one step here and there and 32 random-weight
# layers carry it to the logits. A first token may differ from the standalone's where the latter's
# logits of the two tokens lie within SERVE_TOP1_GAP of its largest |logit|. Readings (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md section 6): 0.0054 with the CUDA-core small-M kernels (one request, in
# both qint4 arms), 0.0054-0.0234 with the tensor-core ones (four flips); a K summed in two halves
# flipped tokens at up to 0.029 (phase 14). The limit is 1.7x the largest of these.
SERVE_TOP1_GAP = 0.05
# Phase 15: the 8B slice of the JAX package's serving bench without `--long-ctx`
# (bench/serving_bench.py:81-82, :133, :37-43): 8 slots, max_len 768, these prompts, chunks of 64,
# 128 new tokens each, decode bursts of 16.
SERVE_PROMPTS = [512, 384, 448, 256, 512, 320, 192, 448]
SERVE_MAX_LEN, SERVE_CHUNK, SERVE_NEW, SERVE_BURST = 768, 64, 128, 16

# Phase 3's rows of the paged arm of flash_decode (`flash_decode_paged`, TPU #8-#10 over a paged
# cache): phase 15's and phase 10's slots a row, pages of 64 (the engines of phase 20) and 16.
FD_PAGED_SLOTS = [SERVE_MAX_LEN, ENGINE_MAX_LEN]
FD_PAGE_SIZES = [64, 16]
FD_PAGED_CACHES = ["bf16", "qint8", "qint4", "qint4a"]
FD_PAGED_SUMMARY = ("bf16", SERVE_MAX_LEN, 64)  # phase 20(b)'s pool: its decode step's call
SOURCE["flash_decode_paged"] = "quanto_tpu_torch/csrc/flash_decode.cu (paged arm: flash_decode.cuh:CacheRows)"
REPLACES["flash_decode_paged"] = REPLACES["flash_decode"] + " (over JAX's gathered view of the pages)"
# Phase 20: `PagedEngine` on phase 4's model, serving phase 15's requests. (b) pages of 64, every
# request's pages reserved at admission, no sharing: 64 usable pages hold the 8 requests' 4096
# tokens. (c) the prompts share their first PAGED_SHARED ids, over a qint4 cache, with pages of
# 64 reserved for the prompt only and grown on demand: PAGED_PRESSURE_PAGES usable pages hold
# every prompt (34 pages with the shared ones mapped once) but not every request's growth (50).
PAGED_PAGE_SIZE, PAGED_FULL_PAGES = 64, 65
PAGED_SHARED, PAGED_PRESSURE_PAGES, PAGED_KV = 128, 41, "qint4"

# Phases 17-19 and their phase-3 rows (`--only numerics`).
# HuggingFaceTB/SmolLM2-360M config.json: tied embeddings, hidden 960 (quanto's auto group size
# 96, so every linear is off the kernels' envelope and padded), 15 heads over 5 KV heads of 64.
SMOLLM2_360M = dict(
    model_type="llama",
    vocab_size=49152,
    hidden_size=960,
    intermediate_size=2560,
    num_hidden_layers=32,
    num_attention_heads=15,
    num_key_value_heads=5,
    max_position_embeddings=8192,
    rope_theta=100000.0,
    rms_norm_eps=1e-5,
    tie_word_embeddings=True,
    hidden_act="silu",
)
# Qwen/Qwen2.5-0.5B config.json: qwen2 (q/k/v biases), tied embeddings, hidden 896 (K = 896 is
# off the int4 envelope: K / 2 = 448 bytes), 14 heads over 2 KV heads of 64, no sliding window.
QWEN25_05B = dict(
    model_type="qwen2",
    vocab_size=151936,
    hidden_size=896,
    intermediate_size=4864,
    num_hidden_layers=24,
    num_attention_heads=14,
    num_key_value_heads=2,
    max_position_embeddings=32768,
    rope_theta=1000000.0,
    rms_norm_eps=1e-6,
    tie_word_embeddings=True,
    use_sliding_window=False,
    hidden_act="silu",
)
# Phase 3's W8A8 rows: the route of `ops/qbytes_mm.py` (`torch._int_mm` for int8, JAX's convert
# formula on bf16 operands for e4m3fn) at these M over the four linear shapes of Llama-3.1-8B.
W8A8_M = (1, 4, 16, 17, 64, 4096)
# Phase 3's padded rows: SmolLM2-360M's and Qwen2.5-0.5B's linears off the envelope, true (N, K,
# group size); #1 and #4 at the decode step's M = 4, #2's two arms at the prefill's M = 4096.
PADDED_SHAPES = {
    "smollm2-360m": [(960, 960, 96), (320, 960, 96), (2560, 960, 96), (960, 2560, 128)],
    "qwen2.5-0.5b": [(896, 896, 128), (128, 896, 128), (4864, 896, 128)],
}
PADDED_M = {"qbits_mm_small_m": 4, "qbits_mm_int8_small_m": 4, "qbits_mm_tiled": 4096, "qbits_mm_tiled_int8": 4096}
# Phase 3's flash_decode rows at the two small models' heads, (Hkv, G, D), over the decode run's
# 1088 slots.
FD_NEW_HEADS = [(5, 3, 64), (2, 7, 64)]
FD_NEW_CACHES = ["bf16", "qint8", "qint4"]
# Phase 17(b): the e4m3fn W8A8 model's prefill logits against the plain formula's (exact fp8
# products summed in float32). The route is JAX's convert formula (bf16 operands, float32 sums on
# the tensor cores): one product within 4.1e-5 of the plain formula at |y| <~ 13 (phase 3's rows;
# `torch._scaled_mm`, the earlier route, 6e-4 to 1.8e-3: Hopper's fp8 sums are not float32's).
# Yet the two orders of float32 sums still part: each layer quantizes its activations to fp8
# again, and a sum a little off moves an fp8 code by a whole step (1/16 of its value) where it
# lies near a rounding half. Readings (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): 32
# random-weight layers 0.9570-0.9649 with 2 of 4 top-1 tokens moved (0.9386-0.9500 and 4 of 4
# through `torch._scaled_mm`), 2 layers 0.9981-0.9995 with the same top-1 tokens (0.9967-0.9976).
# So the full depth is held to its cosine only, W8A8_FP8_COS, and two layers to W8A8_FP8_COS_2L
# and the same top-1 token or a logit tie, each raised with the readings.
W8A8_FP8_COS = 0.93
W8A8_FP8_COS_2L = 0.995
# Phases 18 and 19: the full-depth kernel path against the plain versions, last-position
# prefill logits: each row's cosine above SMALL_E2E_COS, top-1 equal or at a logit tie.
# Readings (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): SmolLM2 qint4 0.99988-0.99990,
# W4A8 1 - 5e-6, Qwen2.5 qint4 0.99980-0.99984, the same in every run.
SMALL_E2E_COS = 0.999
# Phase 18(c): QAT of SmolLM2-360M in float32, qint4 weights and qint8 activations (calibrated
# over CAL_BATCHES x 4 x 128 tokens first): QAT_STEPS AdamW steps at QAT_LR on one seeded batch
# of B x QAT_T tokens, then `freeze`; the frozen model's logits on a held batch against the QAT
# forward's, each row's cosine above QAT_FROZEN_COS (reading: 1 - 5e-7 in every run; PERF.md
# section 6).
QAT_STEPS, QAT_T, QAT_LR = 16, 256, 1e-3
QAT_FROZEN_COS = 0.999


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


def phase_kernels(K_mod, flush, bits: int = 4, names=None):
    """Phase 3: the two float-x kernels (or those in `names`) against their
    plain version at the main path's shapes, over random codes of `bits`
    (every code value in every position of a byte); an int2 row's name ends in
    `_int2`. Each row carries its share of its bound (`bound_share`)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234 + bits)
    rows = []
    shapes, kernel_m = (SHAPES, KERNEL_M) if bits == 4 else (LINEAR_SHAPES, INT2_KERNEL_M)
    kernel_m = {n: ms for n, ms in kernel_m.items() if names is None or n in names}
    for N, K in shapes:
        G = K // GS
        packed = torch.randint(0, 256, (N, K * bits // 8), dtype=torch.uint8, device=dev, generator=g)
        scale_t = torch.rand((G, N), device=dev, generator=g) * 0.01 + 0.001
        shift_t = scale_t * (2**bits - 1) / 2  # deq = s * (c - qmax / 2): codes centred on zero
        w_bf16 = K_mod.dequantize_k_codes(packed, scale_t, shift_t, GS, bits).to(torch.bfloat16)
        for name, ms in kernel_m.items():
            kernel = getattr(K_mod, name)
            for M in ms:
                x = torch.randn((M, K), device=dev, generator=g, dtype=torch.bfloat16)
                args = (x, packed, scale_t, shift_t, GS, bits)
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
                b_ms, b_by = bound(M, N, K, w_bytes=bits / 8)
                row = dict(
                    name=name + ("_int2" if bits == 2 else ""), M=M, N=N, K=K, max_abs_err=err, cosine=cos,
                    ms=time_ms(lambda: kernel(*args), flush),
                    plain_ms=time_ms(lambda: K_mod.qbits_mm_plain(*args), flush),
                    library_ms=time_ms(lambda: torch.matmul(x, w_bf16.t()), flush),
                    bound_ms=b_ms, bound_by=b_by,
                )
                row["bound_share"] = b_ms / row["ms"]
                rows.append(row)
                log("kernel " + json.dumps(row))
                del out, ref
        del packed, scale_t, shift_t, w_bf16
        torch.cuda.empty_cache()
    return rows


def phase_small_m_sweep(K_mod, flush):
    """Phase 3, the sweep: `qbits_mm_small_m` (bf16 x) and `qbits_mm_int8_small_m`
    (int8 x, bf16 output) against their plain versions at SWEEP_SHAPES, int4
    and int2 codes (every code value in every position of a byte), with phase
    3's check; yardstick `torch.matmul` on the bf16 operands. Rows carry
    `sweep`; an int2 row's name ends in `_int2`."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(910)
    sx = torch.tensor(0.0173, device=dev)
    rows = []
    for bits in (4, 2):
        for (N, K), ms in SWEEP_SHAPES:
            G = K // GS
            packed = torch.randint(0, 256, (N, K * bits // 8), dtype=torch.uint8, device=dev, generator=g)
            scale_t = torch.rand((G, N), device=dev, generator=g) * 0.01 + 0.001
            shift_t = scale_t * (2**bits - 1) / 2
            w_bf16 = K_mod.dequantize_k_codes(packed, scale_t, shift_t, GS, bits).to(torch.bfloat16)
            for M in ms:
                x = torch.randn((M, K), device=dev, generator=g, dtype=torch.bfloat16)
                xq = torch.randint(-128, 128, (M, K), dtype=torch.int8, device=dev, generator=g)
                arms = [
                    ("qbits_mm_small_m", K_mod.qbits_mm_small_m, K_mod.qbits_mm_plain,
                     (x, packed, scale_t, shift_t, GS, bits), x, 2, 0, PEAK_BF16_FLOPS),
                    ("qbits_mm_int8_small_m", K_mod.qbits_mm_int8_small_m, K_mod.qbits_int8_mm_plain,
                     (xq, sx, packed, scale_t, shift_t, GS, torch.bfloat16, bits),
                     (xq.float() * sx).to(torch.bfloat16), 1, 4, PEAK_INT8_OPS),
                ]
                for name, kernel, plain, args, x_lib, x_bytes, sx_bytes, peak in arms:
                    name += "_int2" if bits == 2 else ""
                    err, cos = check_kernel(f"{name} M={M} N={N} K={K}", kernel(*args), plain(*args))
                    b_ms, b_by = bound(M, N, K, x_bytes=x_bytes, w_bytes=bits / 8,
                                       side_bytes=2 * G * N * 4 + sx_bytes, peak_ops=peak)
                    row = dict(
                        name=name, sweep=True, M=M, N=N, K=K, max_abs_err=err, cosine=cos,
                        ms=time_ms(lambda: kernel(*args), flush),
                        plain_ms=time_ms(lambda: plain(*args), flush),
                        library_ms=time_ms(lambda: torch.matmul(x_lib, w_bf16.t()), flush),
                        bound_ms=b_ms, bound_by=b_by,
                    )
                    rows.append(row)
                    log("kernel " + json.dumps(row))
            del packed, scale_t, shift_t, w_bf16
            torch.cuda.empty_cache()
    return rows


def phase_partitioned(flush):
    """Phase 3, TPU kernel #5: the rank-local product of `qbits_mm_partitioned`
    (`_local_mm`: the int4 kernel on the rank's part, cast up to float32) at
    each tp = 2 shard of Llama-3.1-8B (TP_SHARDS) and M in TP_M, over random
    codes, bf16 x, against its plain version (`_local_mm_plain`); bound:
    the local work, as `bound` counts it; yardstick `torch.matmul` on the
    part dequantized to bf16."""
    from quanto_tpu_torch import qint4
    from quanto_tpu_torch.ops.cuda import qbits_mm_sharded as SH
    from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5678)
    rows = []
    for proj, (N, K) in TP_SHARDS.items():
        G = K // GS
        scale_t = torch.rand((G, N), device=dev, generator=g) * 0.01 + 0.001
        w = WeightQBitsHopperArray(
            _packed=torch.randint(0, 256, (N, K // 2), dtype=torch.uint8, device=dev, generator=g),
            _scale_t=scale_t, _shift_t=scale_t * 7.5, qtype=qint4, group_size=GS, orig_shape=(N, K),
            float_dtype=torch.bfloat16,
        )
        w_bf16 = w.dequantize()
        for M in TP_M:
            x = torch.randn((M, K), device=dev, generator=g, dtype=torch.bfloat16)
            err, cos = check_kernel(f"qbits_mm_partitioned {proj} M={M} N={N} K={K}", SH._local_mm(x, w),
                                    SH._local_mm_plain(x, w))
            b_ms, b_by = bound(M, N, K)
            row = dict(
                name="qbits_mm_partitioned", proj=proj, M=M, N=N, K=K, max_abs_err=err, cosine=cos,
                ms=time_ms(lambda: SH._local_mm(x, w), flush),
                plain_ms=time_ms(lambda: SH._local_mm_plain(x, w), flush),
                library_ms=time_ms(lambda: torch.matmul(x, w_bf16.t()), flush),
                bound_ms=b_ms, bound_by=b_by,
            )
            rows.append(row)
            log("kernel " + json.dumps(row))
        del w, w_bf16, scale_t
        torch.cuda.empty_cache()
    return rows


def phase_qbytes(flush):
    """Phase 3, the 8-bit weight-only kernel (TPU #6/#7): both payloads against
    the plain version at every M of QBYTES_SWEEP_M and the four linear
    shapes, bf16 x and the bf16 [N, 1] scale of a bf16 model; yardstick
    `torch.matmul` on the bf16 operands. Each row carries its share of its
    bound (`bound_share`)."""
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
                row["bound_share"] = b_ms / row["ms"]
                rows.append(row)
                log("kernel " + json.dumps(row))
            del qw, w_bf16
        del w
        torch.cuda.empty_cache()
    return rows


def phase_w4a8(K_mod, flush, bits: int = 4, names=None):
    """Phase 3, the W4A8 kernels (W2A8 at `bits` = 2; or those in `names`):
    int8 x with a device scalar sx against random codes of `bits` (every code
    value in every position of a byte), bf16 output, against their plain
    version; an int2 row's name ends in `_int2`. Yardsticks: `torch.matmul` on
    the operands in bf16 (`library_ms`) and, for the tiled arm,
    `torch._int_mm` on the int8 codes (`int_mm_ms`: the integer products
    without the group scales). Each row carries its share of its bound."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3456 + (bits != 4))
    rows = []
    sx = torch.tensor(0.0173, device=dev)
    for N, K in LINEAR_SHAPES:
        G = K // GS
        packed = torch.randint(0, 256, (N, K * bits // 8), dtype=torch.uint8, device=dev, generator=g)
        scale_t = torch.rand((G, N), device=dev, generator=g) * 0.01 + 0.001
        shift_t = scale_t * (2**bits - 1) / 2
        w_bf16 = K_mod.dequantize_k_codes(packed, scale_t, shift_t, GS, bits).to(torch.bfloat16)
        codes_t = K_mod.unpack_k_codes(packed, bits).to(torch.int8).t()  # [K, N], column-major
        for name, ms in (W4A8_M if bits == 4 else W2A8_M).items():
            if names is not None and name not in names:
                continue
            kernel = getattr(K_mod, name)
            for M in ms:
                xq = torch.randint(-128, 128, (M, K), dtype=torch.int8, device=dev, generator=g)
                x_bf16 = (xq.float() * sx).to(torch.bfloat16)
                args = (xq, sx, packed, scale_t, shift_t, GS, torch.bfloat16, bits)
                err, cos = check_kernel(
                    f"{name} int{bits} M={M} N={N} K={K}", kernel(*args), K_mod.qbits_int8_mm_plain(*args)
                )
                b_ms, b_by = bound(M, N, K, x_bytes=1, w_bytes=bits / 8, side_bytes=2 * G * N * 4 + 4,
                                   peak_ops=PEAK_INT8_OPS)
                row = dict(
                    name=name + ("_int2" if bits == 2 else ""), M=M, N=N, K=K, max_abs_err=err, cosine=cos,
                    ms=time_ms(lambda: kernel(*args), flush),
                    plain_ms=time_ms(lambda: K_mod.qbits_int8_mm_plain(*args), flush),
                    library_ms=time_ms(lambda: torch.matmul(x_bf16, w_bf16.t()), flush),
                    bound_ms=b_ms, bound_by=b_by,
                )
                if name == "qbits_mm_tiled_int8":
                    row["int_mm_ms"] = time_ms(lambda: torch._int_mm(xq, codes_t), flush)
                row["bound_share"] = b_ms / row["ms"]
                rows.append(row)
                log("kernel " + json.dumps(row))
        del packed, scale_t, shift_t, w_bf16, codes_t
        torch.cuda.empty_cache()
    return rows


def phase_requant(K_mod, flush, bits: int = 4):
    """Phase 3, the requant kernel: int8 x with a device scalar sx against
    random codes of `bits`, group scales and shifts anywhere in [0, qmax]
    steps, bf16 output, held EQUAL to its plain version (exact codes and int32
    sums, the same two float32 multiplies). Beside it, timed at the same shape:
    the exact route, as a user's `qlinear` takes it without the requant form
    (int4: `qbits_mm_tiled_int8`, the A/B of the JAX package's
    bench/prefill8b_bench.py:125-130; int2: dequantize + `torch.matmul`, since
    JAX's `_prefill_route` refuses int2 above M = 1024) and, as a yardstick
    the port never calls, `torch._int_mm` on the requantized int8 weight. An
    int2 row's name ends in `_int2`."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6789 + (bits != 4))
    rows = []
    sx = torch.tensor(0.0173, device=dev)
    for N, K in LINEAR_SHAPES:
        G = K // GS
        packed = torch.randint(0, 256, (N, K * bits // 8), dtype=torch.uint8, device=dev, generator=g)
        scale_t = torch.rand((G, N), device=dev, generator=g) * 0.01 + 0.001
        shift_t = scale_t * torch.rand((G, N), device=dev, generator=g) * (2**bits - 1)
        s8 = K_mod.requant_step(scale_t, shift_t, bits)
        c8_t = K_mod.requant_codes(packed, scale_t, shift_t, s8, GS, bits).t()  # [K, N], column-major
        # The kernel's first pass alone (its codes EQUAL to the plain version's) and its workspace;
        # absent from trees before the two-pass design, which this script also times.
        requant_pass = getattr(K_mod, "requant_pass", None)
        first_pass = {}
        if requant_pass is not None:
            if not torch.equal(requant_pass(packed, scale_t, shift_t, s8, GS, bits), c8_t.t()):
                raise RuntimeError(f"requant_pass int{bits} N={N} K={K}: codes differ from requant_codes")
            first_pass = dict(pass_ms=time_ms(lambda: requant_pass(packed, scale_t, shift_t, s8, GS, bits), flush),
                              workspace_bytes=N * K)
        for M in REQUANT_M:
            xq = torch.randint(-128, 128, (M, K), dtype=torch.int8, device=dev, generator=g)
            args = (xq, sx, packed, scale_t, shift_t, s8, GS, torch.bfloat16, bits)
            out = K_mod.qbits_mm_requant_int8(*args)
            ref = K_mod.qbits_requant_int8_mm_plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.equal(out, ref):
                raise RuntimeError(
                    f"qbits_mm_requant_int8 int{bits} M={M} N={N} K={K}: not equal to its plain version ({err})"
                )
            b_ms, b_by = bound(M, N, K, x_bytes=1, w_bytes=bits / 8, side_bytes=2 * G * N * 4 + 4 * N + 4,
                               peak_ops=PEAK_INT8_OPS)
            if bits == 4:
                exact = (xq, sx, packed, scale_t, shift_t, GS, torch.bfloat16)
                exact_route = ("tiled_int8_ms", lambda: K_mod.qbits_mm_tiled_int8(*exact))
            else:
                def dequantized_matmul():
                    x = (xq.float() * sx).to(torch.bfloat16)  # `ActivationQBytesArray.dequantize`
                    w = K_mod.dequantize_k_codes(packed, scale_t, shift_t, GS, bits).to(torch.bfloat16)
                    return torch.matmul(x, w.t())
                exact_route = ("exact_ms", dequantized_matmul)
            row = dict(
                name="qbits_mm_requant_int8" + ("_int2" if bits == 2 else ""), M=M, N=N, K=K,
                max_abs_err=err, equal=True,
                ms=time_ms(lambda: K_mod.qbits_mm_requant_int8(*args), flush),
                plain_ms=time_ms(lambda: K_mod.qbits_requant_int8_mm_plain(*args), flush),
                library_ms=time_ms(lambda: torch._int_mm(xq, c8_t), flush),
                **{exact_route[0]: time_ms(exact_route[1], flush)}, **first_pass,
                bound_ms=b_ms, bound_by=b_by,
            )
            rows.append(row)
            log("kernel " + json.dumps(row))
            del out, ref
        del packed, scale_t, shift_t, s8, c8_t
        torch.cuda.empty_cache()
    return rows


def phase_moe(flush, bits: int = 4, decode_tiled: bool = False):
    """Phase 3, the MoE kernels: each form against the plain version over 8
    stacked experts with random codes of `bits`, bf16 x, float32 outputs held
    within 1e-4 * max|ref| and cosine > 1 - 1e-5 (sums in another order). The
    int2 arms run at the selective form of phase 12's B = 1 step, its B = 4
    decode shapes and its B = 1 prefill's slabs (MOE_INT2_TILED_M); their rows'
    names end in `_int2`. `decode_tiled`: only `qbits_moe_tiled`'s rows at
    M <= 16 (TPU #15)."""
    from quanto_tpu_torch.ops.cuda import moe_mm as MM
    from quanto_tpu_torch.ops.cuda.qbits_mm import dequantize_k_codes

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5678 + bits)
    rows = []
    for N, K in MOE_SHAPES:
        G = K // GS
        packed = torch.randint(
            0, 256, (MOE_EXPERTS, N, K * bits // 8), dtype=torch.uint8, device=dev, generator=g
        )
        scale_t = torch.rand((MOE_EXPERTS, G, N), device=dev, generator=g) * 0.01 + 0.001
        shift_t = scale_t * (2**bits - 1) / 2
        w_bf16 = torch.stack([
            dequantize_k_codes(packed[e], scale_t[e], shift_t[e], GS, bits).to(torch.bfloat16)
            for e in range(MOE_EXPERTS)
        ])
        weights = (packed, scale_t, shift_t, GS, bits)
        x8 = torch.randn((MOE_S, K), device=dev, generator=g, dtype=torch.bfloat16)

        def table(ids):
            return torch.tensor(ids, dtype=torch.int32, device=dev)

        # (form, kernel, x3 [U, M, K], eids, the device count of live slots or None for all U)
        cases = [("sel", MM.qbits_moe_small_m, x8[: len(MOE_SEL_EIDS), None, :], table(MOE_SEL_EIDS), None)]
        if bits == 4:
            cases += [
                ("all", MM.qbits_moe_small_m, x8.expand(MOE_EXPERTS, MOE_S, K), None, None),
                ("uniq", MM.qbits_moe_small_m, x8.expand(len(MOE_UNIQ_EIDS), MOE_S, K), table(MOE_UNIQ_EIDS),
                 None),
            ]
        slabs = {M: torch.randn((MOE_EXPERTS, M, K), device=dev, generator=g, dtype=torch.bfloat16)
                 for M in (MOE_TILED_M if bits == 4 else MOE_INT2_TILED_M)}
        cases += [("experts", MM.qbits_moe_tiled, x3, None, None) for x3 in slabs.values()]
        if bits == 4:  # the uniq route's GEMM at prefill slabs: 6 of 8 slots live
            n, ids = MOE_PREFILL_UNIQ
            cases.append(("uniq", MM.qbits_moe_tiled, slabs[MOE_TILED_M[-1]], table(ids), n))
        # The B = 4 decode step: gate/up over the shared rows, down over each slot's own rows.
        x4 = torch.randn((MOE_DECODE_M, K), device=dev, generator=g, dtype=torch.bfloat16)
        h4 = torch.randn((MOE_EXPERTS, MOE_DECODE_M, K), device=dev, generator=g, dtype=torch.bfloat16)
        cases += [
            ("uniq", kernel, x3, table(ids), n)
            for n, ids in MOE_DECODE_TABLES
            for kernel, x3 in ((MM.qbits_moe_small_m, x4.expand(MOE_EXPERTS, MOE_DECODE_M, K)),
                               (MM.qbits_moe_tiled, h4))
        ]
        # The B = 16 decode step's down call: every expert over its own 16 rows, no table.
        h16 = torch.randn((MOE_EXPERTS, B16, K), device=dev, generator=g, dtype=torch.bfloat16)
        cases.append(("all", MM.qbits_moe_tiled, h16, None, None))
        for S in MOE_ALL_S[bits]:  # TPU #12's own rows: the all form over every expert, no table
            xs = torch.randn((S, K), device=dev, generator=g, dtype=torch.bfloat16)
            cases.append(("all", MM.qbits_moe_small_m, xs.expand(MOE_EXPERTS, S, K), None, None))
        if decode_tiled:
            cases = [c for c in cases if c[1] is MM.qbits_moe_tiled and c[2].shape[1] <= 16]
        for form, kernel, x3, eids, count in cases:
            U, M = x3.shape[:2]
            n_live = U if count is None else count
            nslots = None if count is None else torch.tensor(count, dtype=torch.int32, device=dev)
            ids = (eids.long() if eids is not None else torch.arange(U, device=dev))[:n_live]
            experts = set(ids.tolist())
            # The yardstick computes the live slots only, on their experts in bf16.
            x_lib, w_lib = x3[:n_live], w_bf16[ids]
            out = kernel(x3, *weights, eids=eids, nslots=nslots)
            ref = MM.qbits_moe_plain(x3, *weights, eids=eids, nslots=nslots)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ref_max = ref.abs().max().item()
            cos = cosine(out, ref)
            name = kernel.__name__ + ("_int2" if bits == 2 else "")
            if not (cos > 1 - 1e-5 and err <= 1e-4 * ref_max):
                raise RuntimeError(
                    f"{name} {form} U={U} nslots={count} M={M} N={N} K={K}: cosine {cos} max_abs_err {err} "
                    f"(max|ref| {ref_max})"
                )
            # Least time: the live slots' x read once (shared rows once), their experts'
            # payloads, scales and shifts once, the float32 output written once; 2 n M N K
            # operations in bf16 over the n live slots.
            x_bytes = (M if x3.stride(0) == 0 else n_live * M) * K * 2
            nbytes = x_bytes + len(experts) * (N * K * bits // 8 + 2 * G * N * 4) + U * M * N * 4
            ops = 2 * n_live * M * N * K
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_BF16_FLOPS * 1e3
            row = dict(
                name=name, form=form, U=U, nslots=count, M=M, N=N, K=K, experts=len(experts),
                max_abs_err=err, cosine=cos,
                ms=time_ms(lambda: kernel(x3, *weights, eids=eids, nslots=nslots), flush),
                plain_ms=time_ms(lambda: MM.qbits_moe_plain(x3, *weights, eids=eids, nslots=nslots), flush),
                library_ms=time_ms(lambda: torch.bmm(x_lib, w_lib.transpose(1, 2)), flush),
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                host_us=host_us(lambda: kernel(x3, *weights, eids=eids, nslots=nslots), n=20),
            )
            rows.append(row)
            log("kernel " + json.dumps(row))
            del out, ref
        del packed, scale_t, shift_t, w_bf16, cases, slabs
        torch.cuda.empty_cache()
    return rows


def fd_bound(slots: int, batch: int, k_row: int, v_row: int, per_slot: int, q_bytes: int = 2, heads=FD_HEADS):
    """Least time (ms) of one flash_decode call over `batch` rows that see
    `slots` cache slots in all (each row its positions up to its own): each
    visible slot's K and V rows (`k_row` + `v_row` bytes per head) and
    per-slot factors (`per_slot` bytes per head) read once, q read and the
    output written once (`q_bytes` a value); two dots of D per slot and query
    at the bf16 tensor-core rate. `heads`: (Hkv, G, D)."""
    Hkv, G, D = heads
    nbytes = slots * Hkv * (k_row + v_row + per_slot) + 2 * q_bytes * batch * Hkv * G * D
    flops = 4 * Hkv * G * D * slots
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fd_cache(kind: str, S: int, g: torch.Generator, batch: int = B, heads=FD_HEADS):
    """One layer's cache of `kind` with every slot written by `kv_update`
    from random K (skewed, as RoPE'd K heads are) and V."""
    from quanto_tpu_torch.tensor.kv_cache import init_quantized_kv_cache, kv_update

    Hkv, _, D = heads
    k = torch.randn((batch, S, Hkv, D), device="cuda", generator=g) * 2 + 0.5
    v = torch.randn((batch, S, Hkv, D), device="cuda", generator=g)
    if kind == "bf16":
        return (k.to(torch.bfloat16), v.to(torch.bfloat16))
    layer = init_quantized_kv_cache(1, batch, S, Hkv, D, kind, device="cuda")[0]
    return kv_update(layer, k, v, 0)


def phase_flash_decode(flush, heads=FD_HEADS):
    """Phase 3, flash_decode: the kernel against its plain version and SDPA,
    at B = 4 with every slot visible over each cache type (and with float32 q
    over FD_F32_Q at 8192 slots), and at phase 10's decode step (bf16, 8
    ragged rows, `FD_ENGINE_POS`). With other `heads` (Hkv, G, D): B = 4
    over FD_NEW_CACHES of T + NEW slots, the decode run of phases 18 and 19."""
    from quanto_tpu_torch.ops.attention import decode_attention
    from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain
    from quanto_tpu_torch.tensor.kv_cache import kv_read

    Hkv, G, D = heads
    g = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    # (cache, S, positions, the engine arm they stand for or None, q's dtype)
    if heads != FD_HEADS:
        cases = [(kind, T + NEW, [T + NEW - 1] * B, None, torch.bfloat16) for kind in FD_NEW_CACHES]
    else:
        cases = [(kind, S, [S - 1] * B, None, torch.bfloat16) for S in FD_SLOTS for kind in FD_CACHES]
        cases += [(kind, FD_SLOTS[-1], [FD_SLOTS[-1] - 1] * B, None, torch.float32) for kind in FD_F32_Q]
        cases += [("bf16", ENGINE_MAX_LEN, p, arm, torch.bfloat16) for arm, p in FD_ENGINE_POS.items()]
    for kind, S, positions, arm, q_dtype in cases:
        nb = len(positions)
        cache = fd_cache(kind, S, g, nb, heads)
        q = torch.randn((nb, Hkv, G, D), device="cuda", generator=g).to(q_dtype)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
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
        out2 = decode_attention(q.reshape(nb, 1, Hkv * G, D), cache, pos)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        cos = cosine(out, ref)
        if not (cos > 1 - 1e-4 and err <= 1e-2 * ref_max) or not torch.equal(
            out2.reshape(out.shape), out
        ):
            raise RuntimeError(
                f"flash_decode {kind} S={S} positions={positions}: cosine {cos} max_abs_err {err} (max|ref| {ref_max})"
            )
        # Yardstick: SDPA over the cache dequantized to bf16, q [B, H, 1, D] in bf16.
        kd, vd = cache if kind == "bf16" else kv_read(cache, torch.bfloat16)
        kt, vt = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
        qs = q.reshape(nb, Hkv * G, 1, D).to(torch.bfloat16)
        mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask, enable_gqa=True)

        lib = sdpa().reshape(nb, Hkv, G, D)
        lib_cos = cosine(lib, ref)
        # float32 q reads q and writes the output in 4 bytes a value.
        b_ms, b_by = fd_bound(sum(p + 1 for p in positions), nb, k_row, v_row, per_slot, q.element_size(), heads)
        row = dict(
            name="flash_decode", cache=kind, S=S, B=nb, engine_arm=arm, Hkv=Hkv, G=G, D=D,
            q="f32" if q_dtype == torch.float32 else "bf16",
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


def phase_flash_decode_paged(flush):
    """Phase 3, the paged arm of flash_decode (`flash_decode_paged`): at
    Llama-3.1-8B's heads, B = 8 rows at their last slot over FD_PAGED_SLOTS
    slots a row, in pages of FD_PAGE_SIZES slots behind a table that is a
    random permutation of the pool's pages (a kernel that ignored the table
    would read other rows' pages), over FD_PAGED_CACHES and, with float32 q,
    the qint4 cache of the largest row. Each row EQUAL to the dense arm on
    the pages gathered through the table (the same plan and order of sums),
    and within the dense rows' limits of its plain version; timed beside the
    dense arm on the gathered view, the gather + dense arm (JAX's route: it
    gathers a dense view and runs its kernels on that), SDPA on the gathered
    cache dequantized to bf16 (the yardstick), and the plain version. Bound:
    the visible K/V bytes and factors at 3.35 TB/s (the table's 4 bytes a
    page beside them)."""
    from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_paged, flash_decode_paged_plain
    from quanto_tpu_torch.tensor import kv_cache as tkv
    from quanto_tpu_torch.tensor import paged_kv as tpk

    Hkv, G, D = FD_HEADS
    nb = ENGINE_SLOTS
    g = torch.Generator(device="cuda").manual_seed(2020)
    cases = [(kind, S, ps, torch.bfloat16) for S in FD_PAGED_SLOTS for ps in FD_PAGE_SIZES for kind in FD_PAGED_CACHES]
    cases.append(("qint4", FD_PAGED_SLOTS[-1], FD_PAGE_SIZES[0], torch.float32))
    rows = []
    for kind, S, ps, q_dtype in cases:
        P = S // ps
        spec = None if kind == "bf16" else kind
        layer = tpk.init_paged_kv_cache(1, 1 + nb * P, ps, nb, P, Hkv, D, spec, torch.bfloat16, "cuda")[0]
        perm = torch.randperm(nb * P, generator=torch.Generator().manual_seed(S + ps)) + 1
        layer._table.copy_(perm.reshape(nb, P).to(torch.int32))
        k = torch.randn((nb, S, Hkv, D), device="cuda", generator=g) * 2 + 0.5
        tkv.kv_update(layer, k, torch.randn(k.shape, device="cuda", generator=g), 0)
        del k
        q = torch.randn((nb, Hkv, G, D), device="cuda", generator=g).to(q_dtype)
        pos = torch.full((nb,), S - 1, dtype=torch.int32, device="cuda")
        c = layer
        args = (q, c._k_pages, c._v_pages, c._k_scale, c._v_scale, c._table, pos)
        kw = dict(k_shift=c._k_shift, v_shift=c._v_shift)
        out = flash_decode_paged(*args, **kw)
        gathered = tpk.paged_gather(layer, nb)
        kg, vg, ks, vs, km, vm = gathered

        def dense():
            return flash_decode(q, kg, vg, ks, vs, pos, k_shift=km, v_shift=vm)

        def gather_dense():
            g_ = tpk.paged_gather(layer, nb)
            return flash_decode(q, *g_[:4], pos, k_shift=g_[4], v_shift=g_[5])

        dense_out = dense()
        ref = flash_decode_paged_plain(*args, **kw)
        torch.cuda.synchronize()
        what = f"flash_decode_paged {kind} S={S} page_size={ps} q={q_dtype}"
        if not torch.equal(out, dense_out):
            raise RuntimeError(f"{what}: not EQUAL to the dense arm on the gathered view")
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        cos = cosine(out, ref)
        limit = 1e-5 if q_dtype == torch.float32 else 1e-2
        if not (err <= limit * ref_max and (q_dtype == torch.float32 or cos > 1 - 1e-4)):
            raise RuntimeError(f"{what}: cosine {cos} max_abs_err {err} (max|ref| {ref_max})")
        if spec is None:
            kd, vd = kg, vg
        else:
            kd = (tkv._codes(kg).float() * ks + (km if km is not None else 0)).to(torch.bfloat16)
            vd = (tkv._codes(vg).float() * vs + (vm if vm is not None else 0)).to(torch.bfloat16)
        kt, vt = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
        qs = q.reshape(nb, Hkv * G, 1, D).to(torch.bfloat16)
        mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask, enable_gqa=True)

        k_row, v_row = c._k_pages[0, 0, 0].numel() * c._k_pages.element_size(), \
            c._v_pages[0, 0, 0].numel() * c._v_pages.element_size()
        per_slot = 0 if spec is None else (8 if c._k_shift is None else 16)
        b_ms, b_by = fd_bound(nb * S, nb, k_row, v_row, per_slot, q.element_size())
        row = dict(
            name="flash_decode_paged", cache=kind, S=S, B=nb, page_size=ps, Hkv=Hkv, G=G, D=D,
            q="f32" if q_dtype == torch.float32 else "bf16", max_abs_err=err, cosine=cos,
            sdpa_cosine=cosine(sdpa().reshape(nb, Hkv, G, D), ref),
            ms=time_ms(lambda: flash_decode_paged(*args, **kw), flush),
            dense_ms=time_ms(dense, flush), gather_dense_ms=time_ms(gather_dense, flush),
            plain_ms=time_ms(lambda: flash_decode_paged_plain(*args, **kw), flush),
            library_ms=time_ms(sdpa, flush), bound_ms=b_ms, bound_by=b_by,
        )
        row["bound_share"] = b_ms / row["ms"]
        rows.append(row)
        log("kernel " + json.dumps(row))
        del layer, gathered, kg, vg, ks, vs, km, vm, kd, vd, kt, vt, out, dense_out, ref
        torch.cuda.empty_cache()
    return rows


def calibration_batches(config):
    """Phase 7's (and phase 5's W4A8) calibration data: 2 batches of 4 x 128 seeded token ids."""
    g = torch.Generator().manual_seed(11)
    return [torch.randint(0, config.vocab_size, (B, CAL_T), generator=g).cuda() for _ in range(CAL_BATCHES)]


def build_model(config, seed: int, weights: str = "qint4", activations=None, exclude=None, optimizer=None,
                init=None):
    """The configuration with random weights from `seed` (then `init(model)`,
    if given), quantized (with `optimizer`, if given), calibrated when
    activations are quantized (streamline must turn every linear's output
    quantization off, as it does in JAX on this model), and frozen."""
    from quanto_tpu_torch import Calibration, freeze, named_qmodules, quantize
    from quanto_tpu_torch.models.llama import LlamaForCausalLM
    from quanto_tpu_torch.nn import QLinear
    from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray, WeightQBytesArray

    model = LlamaForCausalLM(config, device="cuda", generator=torch.Generator("cuda").manual_seed(seed))
    if init is not None:
        init(model)
    quantize(model, weights=weights, activations=activations, exclude=exclude, optimizer=optimizer)
    if activations is not None:
        with torch.no_grad(), Calibration(model):
            for batch in calibration_batches(config):
                model(batch)
        still_on = [name for name, m in named_qmodules(model) if m.quantize_outputs]
        if still_on:
            raise RuntimeError(f"streamline left output quantization on for {still_on}")
    freeze(model)
    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    expected = LINEARS_PER_LAYER * config.num_hidden_layers + (0 if exclude or model.lm_head is None else 1)
    layout = WeightQBytesArray if weights in ("qint8", "qfloat8", "qfloat8_e4m3fn") else WeightQBitsHopperArray
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
    # Phase 14's reference: phase 4's tokens and the logits that chose them, taken again by
    # feeding those tokens (the same forwards as the timed run).
    forced = forced_logits(model, ids, torch.cat([first, rest], dim=1))
    reference = (forced, torch.cat([first, rest], dim=1).cpu())
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
        "forced_logits_reproduce_tokens": bool(torch.equal(forced.float().argmax(-1).t(), reference[1])),
    }))
    del cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches, reference


@torch.no_grad()
def forced_logits(model, ids, tokens) -> torch.Tensor:
    """Teacher forcing: the last-position logits of the prefill of `ids` [B, T]
    and of each decode step fed `tokens` [B, NEW] in turn (the last one is not
    fed), over a bf16 cache of T + NEW slots; [NEW, B, V] bf16 on the host."""
    from quanto_tpu_torch.models.serve import make_cache, prefill

    cache = make_cache(model, B, T + NEW)
    logits, cache = prefill(model, ids, cache, last_only=True)
    out = [logits[:, -1]]
    for i in range(NEW - 1):
        logits, cache = model(tokens[:, i : i + 1].to(ids.device, ids.dtype), cache, T + i)
        out.append(logits[:, -1])
    return torch.stack(out).cpu()


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


class ArmCount:
    """One arm of a kernel wrapper counted apart: the wrapper's `<attr>` and
    `<attr>_int2` read and set as this object's `launches` and
    `launches_int2`."""

    def __init__(self, wrapper, attr: str):
        self.wrapper, self.attr = wrapper, attr

    launches = property(lambda self: getattr(self.wrapper, self.attr),
                        lambda self, v: setattr(self.wrapper, self.attr, v))
    launches_int2 = property(lambda self: getattr(self.wrapper, self.attr + "_int2"),
                             lambda self, v: setattr(self.wrapper, self.attr + "_int2", v))


@functools.lru_cache(maxsize=None)
def counters():
    """Every kernel wrapper of the port, by name; each counts its launches.
    Taken once, so that `plain_versions` swapping a module's names does not
    change what is counted."""
    from quanto_tpu_torch.ops.cuda import flash_decode as FD_mod
    from quanto_tpu_torch.ops.cuda import moe_mm as MM
    from quanto_tpu_torch.ops.cuda import qbits_mm as K_mod
    from quanto_tpu_torch.ops.cuda import qbits_mm_sharded as SH
    from quanto_tpu_torch.ops.cuda import qbytes_mm as QB_mod

    wrappers = {
        "qbits_mm_partitioned": SH.qbits_mm_partitioned,
        "qbits_mm_small_m": K_mod.qbits_mm_small_m, "qbits_mm_tiled": K_mod.qbits_mm_tiled,
        "qbits_mm_int8_small_m": K_mod.qbits_mm_int8_small_m, "qbits_mm_tiled_int8": K_mod.qbits_mm_tiled_int8,
        "qbits_mm_requant_int8": K_mod.qbits_mm_requant_int8,
        "qbytes_mm_int8": QB_mod.qbytes_mm_int8, "qbytes_mm_e4m3fn": QB_mod.qbytes_mm_e4m3fn,
        "flash_decode": FD_mod.flash_decode,
        "qbits_moe_small_m": MM.qbits_moe_small_m, "qbits_moe_tiled": MM.qbits_moe_tiled,
    }
    # TPU #12's own count: `qbits_moe_small_m`'s launches in its all form (absent from trees
    # before it was counted apart, which this script also times).
    if hasattr(MM.qbits_moe_all, "launches"):
        wrappers["qbits_moe_all"] = MM.qbits_moe_all
    # TPU #15's own count: `qbits_moe_tiled`'s M <= 16 arm (absent from trees before it was
    # counted apart).
    if hasattr(MM.qbits_moe_tiled, "launches_small_m"):
        wrappers["qbits_moe_tiled_small_m"] = ArmCount(MM.qbits_moe_tiled, "launches_small_m")
    # The paged arm of flash_decode, counted apart (absent from trees before it was ported).
    if hasattr(FD_mod, "flash_decode_paged"):
        wrappers["flash_decode_paged"] = FD_mod.flash_decode_paged
    # The W8A8 route's library calls (`torch._int_mm`; the e4m3fn product), counted where they are
    # made (absent from trees before W8A8 was ported).
    from quanto_tpu_torch.ops import qbytes_mm as W8A8

    if hasattr(W8A8, "qbytes_int_mm"):
        wrappers["qbytes_int_mm"], wrappers["qbytes_fp8_mm"] = W8A8.qbytes_int_mm, W8A8.qbytes_fp8_mm
    return wrappers


def read_counts() -> dict:
    """Each wrapper's launches, and those of each int2 arm under `<name>_int2`."""
    counts = {name: w.launches for name, w in counters().items()}
    counts.update({f"{name}_int2": counters()[name].launches_int2 for name in INT2_ARMS if name in counters()})
    return counts


def reset_counts() -> None:
    for w in counters().values():
        w.launches = 0
    for name in INT2_ARMS:
        if name in counters():
            counters()[name].launches_int2 = 0


@contextlib.contextmanager
def plain_versions():
    """Route every kernel call of the model to its plain PyTorch version."""
    import quanto_tpu_torch.ops.attention as attention
    import quanto_tpu_torch.ops.qlinear as QL
    from quanto_tpu_torch.ops.cuda import flash_decode as FD_mod
    from quanto_tpu_torch.ops.cuda import moe_mm as MM
    from quanto_tpu_torch.ops.cuda import qbits_mm as K_mod
    from quanto_tpu_torch.ops.cuda import qbits_mm_sharded as SH
    from quanto_tpu_torch.ops.cuda import qbytes_mm as QB_mod

    def flat(fn):
        def run(x, *args, **kw):
            out = fn(x.reshape(-1, x.shape[-1]).contiguous(), *args, **kw)
            return out.reshape(*x.shape[:-1], out.shape[-1])
        return run

    saved = (QL.qbits_mm, QL.cuda_qbytes, attention.flash_decode, MM.qbits_moe_small_m, MM.qbits_moe_tiled,
             K_mod.qbits_mm_int8_small_m, K_mod.qbits_mm_tiled_int8, K_mod.qbits_mm_requant_int8, SH._local_mm)
    paged = getattr(attention, "flash_decode_paged", None)
    if paged is not None:
        attention.flash_decode_paged = FD_mod.flash_decode_paged_plain
    QL.qbits_mm = flat(K_mod.qbits_mm_plain)
    QL.cuda_qbytes = types.SimpleNamespace(eligible=QB_mod.eligible, qbytes_mm=flat(QB_mod.qbytes_mm_plain))
    attention.flash_decode = FD_mod.flash_decode_plain
    # `qbits_int8_mm` routes by shape and weight form to its three kernel wrappers, and the
    # MoE entry points call theirs, by their modules' names.
    K_mod.qbits_mm_int8_small_m = K_mod.qbits_mm_tiled_int8 = K_mod.qbits_int8_mm_plain
    K_mod.qbits_mm_requant_int8 = K_mod.qbits_requant_int8_mm_plain
    MM.qbits_moe_small_m = MM.qbits_moe_tiled = MM.qbits_moe_plain
    SH._local_mm = SH._local_mm_plain  # a rank's part of a sharded weight (phase 14)
    # The W8A8 route (phase 17): outside its library calls' envelopes it takes the plain formula.
    import quanto_tpu_torch.ops.qbytes_mm as W8A8

    w8a8 = {n: getattr(W8A8, n) for n in ("int_mm_eligible", "scaled_mm_eligible") if hasattr(W8A8, n)}
    for n in w8a8:
        setattr(W8A8, n, lambda K, N: False)
    fp8_mm = W8A8.qbytes_fp8_mm
    if hasattr(W8A8, "_fp8_dot"):  # e4m3fn on the card has no envelope: the plain formula by hand

        def fp8_plain(a, w, scale):
            out = W8A8.qbytes_fp8_mm_plain(a.reshape(-1, a.shape[-1]).contiguous(), w) * W8A8._row_scales(scale)
            return out.to(scale.dtype).reshape(*a.shape[:-1], w.shape[0])

        W8A8.qbytes_fp8_mm = fp8_plain
    try:
        yield
    finally:
        W8A8.qbytes_fp8_mm = fp8_mm
        if paged is not None:
            attention.flash_decode_paged = paged
        for n, fn in w8a8.items():
            setattr(W8A8, n, fn)
        (QL.qbits_mm, QL.cuda_qbytes, attention.flash_decode, MM.qbits_moe_small_m, MM.qbits_moe_tiled,
         K_mod.qbits_mm_int8_small_m, K_mod.qbits_mm_tiled_int8, K_mod.qbits_mm_requant_int8, SH._local_mm) = saved


# Phase 5's arms: (quantize arguments, the kernel the ragged decode step must launch 7 x 2 times).
E2E_ARMS = {
    "qint4": (dict(weights="qint4"), "qbits_mm_small_m"),
    "qint8": (dict(weights="qint8", exclude="lm_head"), "qbytes_mm_int8"),
    "qfloat8": (dict(weights="qfloat8", exclude="lm_head"), "qbytes_mm_e4m3fn"),
    "w4a8": (dict(weights="qint4", activations="qint8", exclude="lm_head"), "qbits_mm_int8_small_m"),
    # The same W4A8 model frozen again into the requant form: its prefill (M = 4096) takes
    # `qbits_mm_requant_int8`, its decode step the exact small-M kernel.
    "w4a8_requant": (dict(weights="qint4", activations="qint8", exclude="lm_head"), "qbits_mm_int8_small_m"),
}


def phase_end_to_end(ids):
    """Phase 5: 2 layers at full width, kernel path vs plain versions called
    explicitly, for each arm. Returns each arm's launch counts in its kernel run."""
    from quanto_tpu_torch import freeze
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.serve import make_cache, prefill
    from quanto_tpu_torch.nn import QLinear

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

        if arm == "w4a8_requant":
            logits_exact, _, _ = run()
            with float_activations(model):
                logits_float_x, _, _ = run()
            freeze(model, w4a8_requant_dot=True)
            with dense_weights(model, requant=False):
                logits_int4_w, _, _ = run()
            with dense_weights(model, requant=True):
                logits_requant_w, _, _ = run()
        reset_counts()
        logits_k, step_k, step_counts = run()
        arm_counts[arm] = read_counts()
        want = {n: 0 for n in step_counts}
        want["flash_decode"] = layers
        want[step_kernel] = LINEARS_PER_LAYER * layers + (0 if kw.get("exclude") else 1)
        if step_counts != want:
            raise RuntimeError(f"{arm}: ragged decode step launches {step_counts}, want {want}")
        if arm == "w4a8_requant":
            prefill_counts = {n: c - step_counts[n] for n, c in arm_counts[arm].items() if c - step_counts[n]}
            if prefill_counts != {"qbits_mm_requant_int8": 2 * LINEARS_PER_LAYER * layers}:
                raise RuntimeError(f"{arm}: the two prefills launched {prefill_counts}")
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
        if arm == "w4a8_requant":
            weight_change = []
            for m in model.modules():
                if isinstance(m, QLinear):
                    w4 = m.weight.dequantize().float()
                    weight_change.append(((requant_dense(m.weight) - w4).norm() / w4.norm()).item())
            check_requant_vs_exact(*(t[:, -1].float() for t in (
                logits_k, logits_exact, logits_float_x, logits_requant_w, logits_int4_w)), weight_change)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return arm_counts


@contextlib.contextmanager
def float_activations(model):
    """Every quantized linear of `model` with its activations left in float
    (its frozen weights as they are)."""
    from quanto_tpu_torch.nn import QLinear

    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    saved = [m.activation_qtype for m in qlinears]
    for m in qlinears:
        m.activation_qtype = None
    try:
        yield
    finally:
        for m, qt in zip(qlinears, saved):
            m.activation_qtype = qt


def requant_dense(w) -> torch.Tensor:
    """A requant-form weight's requant codes times their step, c8 · s8, float32 [N, K]."""
    from quanto_tpu_torch.ops.cuda.qbits_mm import requant_codes

    return requant_codes(w._packed, w._scale_t, w._shift_t, w._s8, w.group_size, w.bits).float() * w._s8[:, None]


@contextlib.contextmanager
def dense_weights(model, requant: bool):
    """Every quantized linear of `model` (requant form) as `F.linear` of its
    float activations with a dense weight in the model's dtype: the int4
    weight dequantized, or (`requant`) c8 · s8. Both arms then differ only in
    their weights' values."""
    from quanto_tpu_torch.nn import QLinear

    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    for m in qlinears:
        dense = requant_dense(m.weight) if requant else m.weight.dequantize()
        m.forward = functools.partial(F.linear, weight=dense.to(model.config.dtype), bias=m.bias)
    try:
        yield
    finally:
        for m in qlinears:
            del m.forward


# Phase 5's limits on the requant form, set from its readings on random weights (NVIDIA H100):
# - with float activations, the requant weights c8 · s8 against the int4 weights: each row's
#   1 - cosine of the logits at most REQUANT_WEIGHT_LIMIT. Each weight moves by at most half a
#   step s8 (`tests/test_torch_requant.py`), about 0.9 % rms (logged), and the 14 linears of the
#   2 layers add up: readings 1.02e-3-1.37e-3. The limit is 2.9x the largest reading and 0.38x
#   the smallest reading with int8 activations, so it still tells the two apart;
# - with int8 activations, the requant form against the exact form: each row's 1 - cosine at
#   most REQUANT_X_RATIO times the exact form's own 1 - cosine against float activations
#   (readings 0.73-0.89: 1 - cosine 0.0105-0.0131 against 0.0127-0.0161).
REQUANT_WEIGHT_LIMIT = 4e-3
REQUANT_X_RATIO = 2.0


def check_requant_vs_exact(lr: torch.Tensor, le: torch.Tensor, lf: torch.Tensor, lw: torch.Tensor,
                           li: torch.Tensor, weight_change: list, label: str = "") -> None:
    """Phase 5: the requant form's prefill logits `lr` [B, V] against the
    exact W4A8 form's `le` of the same weights. The requant codes lie within
    half a step s8 of the int4 weights, a small change of each weight, as
    the witness shows: `lw` (c8 · s8) against `li` (int4), both with float
    activations. With int8 activations at one static scale per tensor, a
    value near a step's edge re-rounds by a whole step, which amplifies that
    change; so the requant form is held to the error W4A8 itself takes, the
    exact form's against float activations (`lf`), times REQUANT_X_RATIO.
    Top-1 tokens are logged, not held: at this size of move, random-weight
    logits whose two largest differ by a few percent of max|logit| swap.
    `weight_change` holds each linear's rms of c8 · s8 minus its int4 weight
    over the int4 weight's rms. Phase 13 holds a W2A8 model (int2 weights
    in place of int4) to the same limits (`label` names it in the log)."""
    def one_minus_cos(a, b):
        return 1 - torch.nn.functional.cosine_similarity(a, b, dim=-1)

    weights_only = one_minus_cos(lw, li)
    requant = one_minus_cos(lr, le)
    int8_x = one_minus_cos(le, lf)
    top_r, top_e = lr.argmax(-1), le.argmax(-1)
    gaps = [(le[r, top_e[r]] - le[r, top_r[r]]).item() / le[r].abs().max().item() for r in range(le.shape[0])]
    log(json.dumps({"end_to_end": f"{label}prefill, requant vs exact form",
                    "weight_change_rms": [min(weight_change), max(weight_change)],
                    "one_minus_cos_weights_float_x": weights_only.tolist(),
                    "one_minus_cos_requant_vs_exact": requant.tolist(),
                    "one_minus_cos_exact_vs_float_x": int8_x.tolist(),
                    "ratio": (requant / int8_x).tolist(),
                    "top1_requant": top_r.tolist(), "top1_exact": top_e.tolist(), "relative_gaps": gaps}))
    if not bool((weights_only <= REQUANT_WEIGHT_LIMIT).all()):
        raise RuntimeError(f"{label}the requant weights move float-activation logits by 1 - cosine "
                           f"{weights_only.tolist()}")
    if not bool((requant <= REQUANT_X_RATIO * int8_x).all()):
        raise RuntimeError(f"{label}the requant form moves the logits by 1 - cosine {requant.tolist()}, more than "
                           f"{REQUANT_X_RATIO} x int8 activations' {int8_x.tolist()}")


def linears_operations(model, M: int) -> int:
    """2 M N K over the model's quantized linears: their operations on M rows."""
    from quanto_tpu_torch.nn import QLinear

    return 2 * M * sum(m.out_features * m.in_features for m in model.modules() if isinstance(m, QLinear))


def step_weight_bytes(model, padded: bool = False) -> int:
    """Bytes of every weight a decode step reads: the quantized linears'
    payloads, scales and shifts, and a float lm_head or, tied, the embedding.
    A weight zero-padded onto the kernels' envelope counts its true bytes
    (the bound's), or with `padded` the padded bytes the kernels read."""
    from quanto_tpu_torch.nn import QLinear

    total = 0
    for m in model.modules():
        if isinstance(m, QLinear):
            w = m.weight
            if hasattr(w, "_data"):
                total += sum(t.numel() * t.element_size() for t in (w._data, w._scale))
            elif getattr(w, "pad", None) is not None and not padded:
                N, K = w.shape
                total += N * K * w.bits // 8 + 2 * 4 * N * (K // (w.group_size or K))
            else:
                total += sum(t.numel() * t.element_size() for t in (w._packed, w._scale_t, w._shift_t))
    head = model.lm_head if model.lm_head is not None else model.model.embed_tokens
    if not isinstance(head, QLinear):
        total += head.weight.numel() * head.weight.element_size()
    return total


@torch.no_grad()
def phase_arm(label: str, model, ids, want_prefill: dict, want_decode: dict, prefill_peak_ops=None,
              record=None) -> dict:
    """Phases 6 and 7: the 8B model's prefill (last position only) and 63 greedy
    decode steps over a bf16 cache of T + NEW slots, with exact launch counts of
    every kernel in each half. With `prefill_peak_ops` it also logs the
    prefill's linears' least time (2 M N K operations at that rate). Returns
    the run's launch counts; a `record` dict takes the prefill logits, the
    tokens and the counts (phase 16)."""
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
    if record is not None:
        record.update(logits=logits.cpu(), tokens=torch.cat([first, rest], dim=1).cpu(), launches=launches)
    weight_bytes, padded_bytes = step_weight_bytes(model), step_weight_bytes(model, padded=True)
    prefill_bound = {}
    if prefill_peak_ops is not None:
        ops = linears_operations(model, B * T)
        prefill_bound = {"prefill_linears_operations": ops, "prefill_linears_bound_ms": ops / prefill_peak_ops * 1e3}
    log(json.dumps({
        "arm": label, "batch": B, "prompt": T, "new_tokens": NEW, "decode_steps": steps,
        "prefill_ms": prefill_s * 1e3, **prefill_bound,
        "decode_ms_per_step": decode_s / steps * 1e3,
        "decode_tok_s": B * steps / decode_s,
        "peak_memory_gb": peak_gb,
        "prefill_launches": {n: c for n, c in pre.items() if c},
        "decode_launches": {n: c for n, c in dec.items() if c},
        "decode_step_weight_bytes": weight_bytes,
        "decode_step_bound_ms": weight_bytes / PEAK_BYTES_PER_S * 1e3,
        **({"decode_step_padded_weight_bytes": padded_bytes} if padded_bytes != weight_bytes else {}),
    }))
    del cache, logits
    return launches


def instrument(engine, per_forward: dict) -> dict:
    """Wrap a phase-10 engine's forward, mixed step, step and burst (on the
    instance) to record its schedule and hold every forward's kernel launches
    to `per_forward[T]` exactly (T = the forward's token columns). Records
    the decode forwards' KV slots read (each row's positions up to its own,
    free rows included, as they run) and the chunk forwards' attention
    operations (causal: each query against the keys up to its position)."""
    config = engine.model.config
    rec = dict(chunks=0, decodes=0, mixed=0, mixed_s=0.0, bursts=[], steps=0, fallback_steps=0,
               decode_slots=0, attn_ops=0, bad=[], burst_pos=None)
    forward, mixed, step, burst = engine._forward, engine._mixed_chunk_step, engine.step, engine.decode_burst

    def counted_forward(ids, cache, pos, last_idx):
        T = ids.shape[1]
        before = read_counts()
        out = forward(ids, cache, pos, last_idx)
        after = read_counts()
        delta = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        if delta != per_forward[T]:
            rec["bad"].append((T, delta))
        if T == 1:
            rec["decodes"] += 1
            if isinstance(pos, np.ndarray):
                p = pos.astype(np.int64)
            else:  # inside a burst: its start positions plus the steps taken
                p = rec["burst_pos"]
                rec["burst_pos"] = p + 1
            rec["decode_slots"] += int((p + 1).sum())
        else:
            rec["chunks"] += 1
            p = np.asarray(pos, np.int64)
            keys = int((T * p + T * (T + 1) // 2).sum())  # sum over rows and queries of pos + t + 1
            rec["attn_ops"] += 4 * config.num_attention_heads * config.head_dim * keys * config.num_hidden_layers
        return out

    def timed_mixed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mixed()  # ends in the fetch of its sampled tokens
        rec["mixed_s"] += time.perf_counter() - t0
        rec["mixed"] += 1
        return out

    def counted_step():
        if engine._by_slot:
            rec["steps"] += 1
            rec["fallback_steps"] += bool(engine._prefill_by_slot)
        return step()

    def counted_burst(n):
        rec["bursts"].append(n)
        rec["burst_pos"] = engine._pos.astype(np.int64)
        return burst(n)

    engine._forward, engine._mixed_chunk_step = counted_forward, timed_mixed
    engine.step, engine.decode_burst = counted_step, counted_burst
    return rec


def check_first_tokens(label: str, model, prompts, tokens, max_len: int = ENGINE_MAX_LEN, tie=None) -> list:
    """Each request's first token against the argmax of a standalone
    `prefill(last_only=True)` of its prompt (prompts of equal length
    batched; in phase 10 every such prefill has M >= 2048, so the same
    requant route) over a cache of the engine's length `max_len`, so that
    attention reduces over the same slots: equal, or the standalone's logits
    of the two tokens within `tie` (default LOGIT_TIE) of its largest
    |logit|. Returns the ties it accepted."""
    from quanto_tpu_torch.models.serve import make_cache, prefill

    tie = LOGIT_TIE if tie is None else tie

    ties = []
    by_len = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(len(p), []).append(i)
    for L, idx in by_len.items():
        ids = torch.tensor(np.stack([prompts[i] for i in idx]), device="cuda")
        logits, _ = prefill(model, ids, make_cache(model, len(idx), max_len), last_only=True)
        lv = logits[:, -1].float()
        for row, i in enumerate(idx):
            top = int(lv[row].argmax())
            if top != tokens[i]:
                gap = (lv[row, top] - lv[row, tokens[i]]).item() / lv[row].abs().max().item()
                ties.append({"request": i, "engine": tokens[i], "standalone": top, "relative_gap": gap})
                log(json.dumps({"engine_first_token_tie": label, **ties[-1]}))
                if gap > tie:
                    raise RuntimeError(f"{label}: request {i}'s first token {tokens[i]} is not the standalone "
                                       f"prefill's {top} and no logit tie (relative gap {gap})")
    return ties


@torch.no_grad()
def phase_engine(model, rows) -> dict:
    """Phase 10: the continuous-batching engine serving the calibrated w4a8
    Llama-3.1-8B frozen into the requant form, in two arms, each on a fresh
    engine of 8 slots, max_len 4352 and chunks of 512 over a bf16 cache.
    The batch arm: `add_batch` of 8 long prompts (8 chunk forwards of
    [8, 512]), then `run_to_completion(burst=16)` for 128 new tokens each.
    The stream arm: `add_batch` of 4 x 1024-token prompts, then 4 long
    prompts `enqueue`d, whose chunks ride the decode steps as mixed steps,
    drained with `run_to_completion(burst=16)`, 64 new tokens each. Every
    chunk forward launches 224 `qbits_mm_requant_int8` and nothing else of
    the port's kernels, every decode forward 224 `qbits_mm_int8_small_m` and
    32 `flash_decode`; the totals follow from the schedule. Beside each arm's
    decode ms/step stand its kernels' time, summed from phase 3's `rows` at
    the step's shapes, and the bf16 lm_head's, timed here. Returns each arm's
    launch counts."""
    from quanto_tpu_torch.models.serving import BatchedEngine
    from quanto_tpu_torch.nn import QLinear

    config = model.config
    L = config.num_hidden_layers
    n_lin = LINEARS_PER_LAYER * L
    zeros = {n: 0 for n in read_counts()}
    per_forward = {
        ENGINE_CHUNK: {"qbits_mm_requant_int8": n_lin},
        1: {"qbits_mm_int8_small_m": n_lin, "flash_decode": L},
    }
    g = torch.Generator().manual_seed(10)

    def prompt(n):
        return torch.randint(0, config.vocab_size, (n,), generator=g).numpy()

    batch_prompts = [prompt(n) for n in ENGINE_BATCH]
    short_prompts = [prompt(ENGINE_SHORT[1]) for _ in range(ENGINE_SHORT[0])]
    stream_prompts = [prompt(n) for n in ENGINE_STREAM]
    weight_bytes = step_weight_bytes(model)
    lin_ops = 2 * ENGINE_SLOTS * ENGINE_CHUNK * sum(
        m.weight.shape[0] * m.weight.shape[1] for m in model.modules() if isinstance(m, QLinear)
    )
    head_ops = 2 * ENGINE_SLOTS * config.hidden_size * config.vocab_size  # logits of one column per row

    # A decode step's device work at phase 3's medians (cold L2): 224 `qbits_mm_int8_small_m` at
    # M = 8 on the linears' shapes, 32 `flash_decode` at the arm's positions (`FD_ENGINE_POS`),
    # and the bf16 lm_head on 8 rows (`F.linear`, no port kernel), timed here.
    small_ms = {(r["N"], r["K"]): r["ms"] for r in rows
                if r["name"] == "qbits_mm_int8_small_m" and r["M"] == ENGINE_SLOTS}
    fd_ms = {r["engine_arm"]: r["ms"] for r in rows if r["name"] == "flash_decode" and r["engine_arm"]}
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    x_head = torch.randn((ENGINE_SLOTS, config.hidden_size), device="cuda", dtype=torch.bfloat16)
    step_kernels = {
        "qbits_mm_int8_small_m": sum(
            small_ms[tuple(m.weight.shape)] for m in model.modules() if isinstance(m, QLinear)
        ),
        "lm_head": time_ms(lambda: model.lm_head(x_head), flush),
    }
    del flush, x_head

    def engine_run(label, admit, new_tokens):
        engine = BatchedEngine(model, max_batch=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN, prefill_chunk=ENGINE_CHUNK)
        slot_bytes = sum(t[0, 0].numel() * t.element_size() for layer in engine._cache for t in layer)
        rec = instrument(engine, per_forward)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        rids = admit(engine)
        torch.cuda.synchronize()
        admit_s = time.perf_counter() - t0
        admit_chunks = rec["chunks"]
        t0 = time.perf_counter()
        engine.run_to_completion(burst=16)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        results = [engine.result(r) for r in rids]
        if rec["bad"]:
            raise RuntimeError(f"{label}: forwards with other launches than {per_forward}: {rec['bad'][:4]}")
        want = dict(zeros, qbits_mm_requant_int8=n_lin * rec["chunks"], qbits_mm_int8_small_m=n_lin * rec["decodes"],
                    flash_decode=L * rec["decodes"])
        if counts != want:
            raise RuntimeError(f"{label}: launches {counts}, want {want}")
        if rec["decodes"] != rec["steps"] + sum(rec["bursts"]) or rec["chunks"] != admit_chunks + rec["mixed"]:
            raise RuntimeError(f"{label}: forwards do not add up to the schedule {rec}")
        if rec["fallback_steps"]:
            raise RuntimeError(f"{label}: {rec['fallback_steps']} steps fell back from mixed steps")
        if [len(r) for r in results] != new_tokens:
            raise RuntimeError(f"{label}: tokens per request {[len(r) for r in results]}, want {new_tokens}")
        if min(min(r) for r in results) < 0 or max(max(r) for r in results) >= config.vocab_size:
            raise RuntimeError(f"{label}: token ids out of the vocabulary")
        decode_s = run_s - rec["mixed_s"]
        kv_bytes = rec["decode_slots"] * slot_bytes / rec["decodes"]
        chunk_bound_ms = (lin_ops / PEAK_INT8_OPS + (rec["attn_ops"] / rec["chunks"] + head_ops) / PEAK_BF16_FLOPS) * 1e3
        out = {
            "engine": label, "model": "llama-3.1-8b-config w4a8 (calibrated), requant form, lm_head bf16, bf16 cache",
            "slots": ENGINE_SLOTS, "max_len": ENGINE_MAX_LEN, "prefill_chunk": ENGINE_CHUNK,
            "requests": len(rids), "new_tokens": new_tokens,
            "schedule": {"chunk_forwards": rec["chunks"], "admit_chunk_forwards": admit_chunks,
                         "mixed_steps": rec["mixed"], "decode_forwards": rec["decodes"], "bursts": rec["bursts"],
                         "single_steps": rec["steps"]},
            "admit_ms": admit_s * 1e3, "run_ms": run_s * 1e3,
            "chunk_bound_ms": chunk_bound_ms,
            "decode_ms_per_step": decode_s / rec["decodes"] * 1e3,
            "decode_step_weight_bytes": weight_bytes, "decode_step_kv_bytes": kv_bytes,
            "decode_step_bound_ms": (weight_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3,
            "decode_step_kernels_ms": dict(step_kernels, flash_decode=L * fd_ms[label],
                                           total=sum(step_kernels.values()) + L * fd_ms[label]),
            "peak_memory_gb": peak_gb, "launches": {n: c for n, c in counts.items() if c},
        }
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        return results, rec, out

    # The batch arm.
    results, rec, out = engine_run(
        "batch", lambda e: e.add_batch(batch_prompts, ENGINE_BATCH_NEW), [ENGINE_BATCH_NEW] * len(ENGINE_BATCH)
    )
    prompt_tokens = sum(ENGINE_BATCH)
    out.update(
        prefill_ms_per_chunk=out["admit_ms"] / rec["chunks"],
        prefill_tok_s=prompt_tokens / (out["admit_ms"] / 1e3),
        decode_tok_s=ENGINE_SLOTS * rec["decodes"] / (out["run_ms"] / 1e3),
    )
    out["first_token_ties"] = check_first_tokens("batch", model, batch_prompts, [r[0] for r in results])
    log(json.dumps(out))
    batch_counts = out["launches"]

    # The stream arm.
    def stream_admit(e):
        rids = e.add_batch(short_prompts, ENGINE_SHORT_NEW)
        return rids + [e.enqueue(p, ENGINE_STREAM_NEW) for p in stream_prompts]

    results, rec, out = engine_run(
        "stream", stream_admit, [ENGINE_SHORT_NEW] * ENGINE_SHORT[0] + [ENGINE_STREAM_NEW] * len(ENGINE_STREAM)
    )
    out.update(
        prefill_ms_per_chunk=out["admit_ms"] / out["schedule"]["admit_chunk_forwards"],
        mixed_step_ms=rec["mixed_s"] / rec["mixed"] * 1e3,
        serve_tok_s=sum(out["new_tokens"]) / ((out["admit_ms"] + out["run_ms"]) / 1e3),
    )
    out["first_token_ties"] = check_first_tokens(
        "stream", model, short_prompts + stream_prompts, [r[0] for r in results]
    )
    log(json.dumps(out))
    return {"batch": batch_counts, "stream": out["launches"]}


def linears_bound(model, rows: int, T: int, x_bytes: int, peak_ops: float):
    """Least time (ms) of one forward's quantized linears over `rows` x `T`
    tokens (a quantized lm_head on the `rows` last positions), and what bounds
    it: each call's x, weight payload, scales and shifts read once and its
    bf16 output written once; 2 M N K operations at `peak_ops`."""
    from quanto_tpu_torch.nn import QLinear

    nbytes = ops = 0
    for m in model.modules():
        if isinstance(m, QLinear):
            M = rows if m is model.lm_head else rows * T
            w = m.weight
            fields = (w._data, w._scale) if hasattr(w, "_data") else (w._packed, w._scale_t, w._shift_t)
            nbytes += M * m.in_features * x_bytes + sum(t.numel() * t.element_size() for t in fields)
            nbytes += M * m.out_features * 2
            ops += 2 * M * m.out_features * m.in_features
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@torch.no_grad()
def phase_serving(label: str, model, kernel: str, new_tokens: int = SERVE_NEW, arms=("serial", "batch"),
                  tokens=None) -> dict:
    """Phase 15: the default 8B slice of the JAX package's serving bench on
    `model`, whose linears all take `kernel` (#1 or #4) below M = 513: a
    `BatchedEngine` of 8 slots, max_len 768, chunks of 64 over a bf16 cache,
    SERVE_PROMPTS (random ids from a seed), each arm on a fresh engine:
    (a) serial `add` of each prompt ([1, 64] chunk forwards, M = 64), (b)
    `add_batch` of all ([8, 64], M = 512); then `run_to_completion(burst=16)`
    for `new_tokens` each (decode forwards of [8, 1], M = 8); `arms` picks
    which of (a) and (b) run. Every forward is
    held to exactly 224 launches of `kernel` at its M, one more at M = its
    rows for a quantized lm_head, 32 `flash_decode` at decode and nothing
    else (a pre-hook on every quantized linear records the M it is called
    at); each request's first token is held to a standalone prefill's, or a
    logit tie. Chunk forwards are timed between synchronizations. Prints per
    arm the median ms per chunk beside its linears' bound, time to first
    token (the requests all arrive at once), decode ms/step beside the bytes
    a step reads, tok/s and peak memory. Returns each arm's launch counts; a
    `tokens` dict takes each arm's tokens (phase 20 holds its own to them)."""
    from quanto_tpu_torch.models.serving import BatchedEngine
    from quanto_tpu_torch.nn import QLinear

    config = model.config
    L = config.num_hidden_layers
    n_lin = LINEARS_PER_LAYER * L
    head_q = isinstance(model.lm_head, QLinear)
    x_bytes, peak_ops = (1, PEAK_INT8_OPS) if kernel == "qbits_mm_int8_small_m" else (2, PEAK_BF16_FLOPS)
    g = torch.Generator().manual_seed(15)
    prompts = [torch.randint(0, config.vocab_size, (n,), generator=g).numpy() for n in SERVE_PROMPTS]
    slots = len(prompts)
    weight_bytes = step_weight_bytes(model)
    seen_m = []  # the M of every quantized linear's call, in order
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen_m.append(args[0].numel() // args[0].shape[-1]))
             for m in model.modules() if isinstance(m, QLinear)]

    def run(arm: str, admit):
        engine = BatchedEngine(model, max_batch=slots, max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK)
        slot_bytes = sum(t[0, 0].numel() * t.element_size() for layer in engine._cache for t in layer)
        rec = dict(chunks=0, chunk_ms=[], chunk_m=set(), decodes=0, bad=[])
        forward = engine._forward

        def counted_forward(ids, cache, pos, last_idx):
            R, T = ids.shape
            before = read_counts()
            seen_m.clear()
            if T > 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = forward(ids, cache, pos, last_idx)
            if T > 1:
                torch.cuda.synchronize()
                rec["chunk_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["chunks"] += 1
                rec["chunk_m"].add(R * T)
            else:
                rec["decodes"] += 1
            after = read_counts()
            delta = {n: after[n] - before[n] for n in after if after[n] != before[n]}
            want = {kernel: n_lin + head_q, **({} if T > 1 else {"flash_decode": L})}
            want_m = [R * T] * n_lin + [R] * head_q
            if delta != want or seen_m != want_m:
                rec["bad"].append((R, T, delta, sorted(set(seen_m))))
            return out

        engine._forward = counted_forward
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        rids, ttft = admit(engine, t0)
        admit_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        engine.run_to_completion(burst=SERVE_BURST)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        results = [engine.result(r) for r in rids]
        if tokens is not None:
            tokens[arm] = results
        del engine
        if rec["bad"]:
            raise RuntimeError(f"{label} {arm}: forwards off their launches or M: {rec['bad'][:4]}")
        chunks = sum(-(-n // SERVE_CHUNK) for n in SERVE_PROMPTS) if arm == "serial" else \
            -(-max(SERVE_PROMPTS) // SERVE_CHUNK)
        if rec["chunks"] != chunks or rec["decodes"] != new_tokens - 1:
            raise RuntimeError(f"{label} {arm}: {rec['chunks']} chunk and {rec['decodes']} decode forwards, "
                               f"want {chunks} and {new_tokens - 1}")
        want = {n: 0 for n in counts}
        want.update({kernel: (n_lin + head_q) * (chunks + rec["decodes"]), "flash_decode": L * rec["decodes"]})
        if counts != want:
            raise RuntimeError(f"{label} {arm}: launches {counts}, want {want}")
        if [len(r) for r in results] != [new_tokens] * slots:
            raise RuntimeError(f"{label} {arm}: tokens per request {[len(r) for r in results]}")
        if min(min(r) for r in results) < 0 or max(max(r) for r in results) >= config.vocab_size:
            raise RuntimeError(f"{label} {arm}: token ids out of the vocabulary")
        (chunk_m,) = rec["chunk_m"]
        b_ms, b_by = linears_bound(model, chunk_m // SERVE_CHUNK, SERVE_CHUNK, x_bytes, peak_ops)
        # A decode step's bytes: the weights, and every row's visible KV slots at its position.
        kv_bytes = slot_bytes * np.mean([n + j + 1 for n in SERVE_PROMPTS for j in range(rec["decodes"])]) * slots
        out = {
            "serving": label, "arm": arm, "slots": slots, "max_len": SERVE_MAX_LEN, "prefill_chunk": SERVE_CHUNK,
            "prompts": SERVE_PROMPTS, "new_tokens": new_tokens, "chunk_forwards": rec["chunks"], "chunk_m": chunk_m,
            "ms_per_chunk": float(np.median(rec["chunk_ms"])), "chunk_bound_ms": b_ms, "chunk_bound_by": b_by,
            "ttft_first_ms": min(ttft) * 1e3, "ttft_mean_ms": float(np.mean(ttft)) * 1e3, "admit_ms": admit_s * 1e3,
            "prefill_tok_s": sum(SERVE_PROMPTS) / admit_s,
            "decode_forwards": rec["decodes"], "decode_ms_per_step": run_s / rec["decodes"] * 1e3,
            "decode_step_bound_ms": (weight_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3,
            "decode_tok_s": slots * rec["decodes"] / run_s,
            "serve_tok_s": slots * new_tokens / (admit_s + run_s),
            "peak_memory_gb": peak_gb, "launches": {n: c for n, c in counts.items() if c},
        }
        log(json.dumps(out))
        check_first_tokens(f"{label} {arm}", model, prompts, [r[0] for r in results], SERVE_MAX_LEN,
                           SERVE_TOP1_GAP)
        gc.collect()
        torch.cuda.empty_cache()
        return out["launches"]

    def serial(engine, t0):
        rids, ttft = [], []
        for p in prompts:
            rids.append(engine.add(p, new_tokens))  # returns after fetching the request's first token
            ttft.append(time.perf_counter() - t0)
        return rids, ttft

    def batched(engine, t0):
        rids = engine.add_batch(prompts, new_tokens)
        return rids, [time.perf_counter() - t0] * len(rids)

    t0 = time.perf_counter()
    try:
        counts = {arm: run(arm, admit) for arm, admit in (("serial", serial), ("batch", batched)) if arm in arms}
    finally:
        for h in hooks:
            h.remove()
    log(f"serving: phase 15 ({label}) took {time.perf_counter() - t0:.1f} s")
    return counts


def check_same_tokens(label: str, model, prompts, got, want, kv_quant=None) -> list:
    """Each request's tokens `got` against `want`: equal, or at the first
    index j where they part, the two tokens' logits within SERVE_TOP1_GAP of
    the largest |logit| of a standalone `prefill(last_only=True)` of the
    prompt and want[:j] (over a cache of max_len SERVE_MAX_LEN, `kv_quant`).
    Returns the ties it accepted (each logged)."""
    from quanto_tpu_torch.models.serve import make_cache, prefill

    ties = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        if len(a) != len(b):
            raise RuntimeError(f"{label}: request {i} gave {len(a)} tokens, want {len(b)}")
        j = next(j for j in range(len(b)) if a[j] != b[j])
        ctx = np.concatenate([prompts[i], np.asarray(b[:j], np.int64)])
        ids = torch.tensor(ctx[None], device="cuda")
        logits, _ = prefill(model, ids, make_cache(model, 1, SERVE_MAX_LEN, kv_quant=kv_quant), last_only=True)
        lv = logits[0, -1].float()
        gap = abs((lv[b[j]] - lv[a[j]]).item()) / lv.abs().max().item()
        ties.append({"request": i, "index": j, "want": b[j], "got": a[j], "relative_gap": gap})
        log(json.dumps({"paged_token_tie": label, **ties[-1]}))
        if gap > SERVE_TOP1_GAP:
            raise RuntimeError(f"{label}: request {i}'s token {j} is {a[j]}, want {b[j]}, and no logit tie "
                               f"(relative gap {gap})")
    return ties


@torch.no_grad()
def phase_paged(model, reference=None) -> dict:
    """Phase 20: `PagedEngine` on phase 4's model (qint4 incl. lm_head),
    serving phase 15's requests (SERVE_PROMPTS, max_len 768, chunks of 64,
    128 new tokens each, bursts of 16), every request admitted by `add`.
    (b) a bf16 cache in pages of 64 reserved in full at admission, no prefix
    sharing, 65 pages (64 usable: the requests' 4096 tokens): its tokens
    EQUAL to phase 15's serial `BatchedEngine` arm (`reference`; run here
    when None), or a recorded tie within SERVE_TOP1_GAP. (c) the same lengths
    with the first PAGED_SHARED ids shared by all prompts, over a qint4 cache,
    pages reserved for the prompt only and grown on demand, prefix sharing
    on, PAGED_PRESSURE_PAGES - 1 usable pages: every prompt fits, not every
    request's growth, so at least one request is preempted and recomputed;
    prefix hits > 0; its tokens held to the same requests with sharing off
    and pages reserved in full (ties recorded). Every forward is held to 224
    `qbits_mm_small_m` + 1 for the qint4 lm_head; a decode forward to 32
    launches of the paged arm (`flash_decode_paged`), none of the dense arm
    and no gathered view of the pages (a chunk forward reads one a layer:
    prefill's attention reads the gathered view, as JAX's). Prints per arm
    ms per chunk beside its linears' bound, time to first token, decode
    ms/step beside the bytes a step reads, peak memory, and the KV bytes the
    pool holds against `BatchedEngine`'s 8 x 768. Returns each run's counts."""
    from quanto_tpu_torch.models.serving import BatchedEngine, PagedEngine
    from quanto_tpu_torch.nn import QLinear
    from quanto_tpu_torch.tensor import paged_kv as tpk

    config = model.config
    L = config.num_hidden_layers
    n_lin = LINEARS_PER_LAYER * L
    head_q = isinstance(model.lm_head, QLinear)
    g = torch.Generator().manual_seed(15)  # phase 15's prompts
    prompts = [torch.randint(0, config.vocab_size, (n,), generator=g).numpy() for n in SERVE_PROMPTS]
    shared = [np.concatenate([prompts[0][:PAGED_SHARED], p[PAGED_SHARED:]]) for p in prompts]
    weight_bytes = step_weight_bytes(model)
    gathers = [0]
    real_gather = tpk.paged_gather

    def counted_gather(layer, batch):
        gathers[0] += 1
        return real_gather(layer, batch)

    def run(label: str, engine, reqs, full_schedule: bool):
        rec = dict(chunks=0, chunk_ms=[], decodes=0, bad=[])
        forward = engine._forward

        def counted_forward(ids, cache, pos, last_idx):
            R, T = ids.shape
            before, g0 = read_counts(), gathers[0]
            if T > 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = forward(ids, cache, pos, last_idx)
            if T > 1:
                torch.cuda.synchronize()
                rec["chunk_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["chunks"] += 1
            else:
                rec["decodes"] += 1
            after = read_counts()
            delta = {n: after[n] - before[n] for n in after if after[n] != before[n]}
            want = {"qbits_mm_small_m": n_lin + head_q, **({} if T > 1 else {"flash_decode_paged": L})}
            if delta != want or gathers[0] - g0 != (L if T > 1 else 0):
                rec["bad"].append((R, T, delta, gathers[0] - g0))
            return out

        engine._forward = counted_forward
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        rids, ttft = [], []
        for p in reqs:
            rids.append(engine.add(p, SERVE_NEW))  # returns after fetching the request's first token
            ttft.append(time.perf_counter() - t0)
        admit_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        engine.run_to_completion(burst=SERVE_BURST)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        results = [engine.result(r) for r in rids]
        if rec["bad"]:
            raise RuntimeError(f"paged {label}: forwards off their launches or gathers: {rec['bad'][:4]}")
        chunks = sum(-(-n // SERVE_CHUNK) for n in SERVE_PROMPTS)
        if full_schedule and (rec["chunks"] != chunks or rec["decodes"] != SERVE_NEW - 1):
            raise RuntimeError(f"paged {label}: {rec['chunks']} chunk and {rec['decodes']} decode forwards, "
                               f"want {chunks} and {SERVE_NEW - 1}")
        if [len(r) for r in results] != [SERVE_NEW] * len(reqs):
            raise RuntimeError(f"paged {label}: tokens per request {[len(r) for r in results]}")
        if min(min(r) for r in results) < 0 or max(max(r) for r in results) >= config.vocab_size:
            raise RuntimeError(f"paged {label}: token ids out of the vocabulary")
        layer = engine._cache[0]
        fields = (layer._k_pages, layer._v_pages, layer._k_scale, layer._v_scale, layer._k_shift, layer._v_shift)
        pool_bytes = L * sum(t.numel() * t.element_size() for t in fields if t is not None)
        slot_bytes = pool_bytes / (engine.n_pages * engine.page_size)
        b_ms, b_by = linears_bound(model, 1, SERVE_CHUNK, 2, PEAK_BF16_FLOPS)
        steps = max(rec["decodes"], 1)
        kv_bytes = slot_bytes * np.mean([n + j + 1 for n in SERVE_PROMPTS for j in range(SERVE_NEW - 1)]) * len(reqs)
        out = {
            "paged": label, "page_size": engine.page_size, "n_pages": engine.n_pages, "reserve": engine.reserve,
            "prefix_sharing": engine.prefix_sharing, "kv_cache": layer.qtype_name or "bf16",
            "prompts": SERVE_PROMPTS, "new_tokens": SERVE_NEW, "chunk_forwards": rec["chunks"],
            "ms_per_chunk": float(np.median(rec["chunk_ms"])), "chunk_bound_ms": b_ms, "chunk_bound_by": b_by,
            "ttft_first_ms": min(ttft) * 1e3, "ttft_mean_ms": float(np.mean(ttft)) * 1e3, "admit_ms": admit_s * 1e3,
            "decode_forwards": rec["decodes"], "decode_ms_per_step": run_s / steps * 1e3,
            "decode_step_bound_ms": (weight_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3,
            "serve_tok_s": len(reqs) * SERVE_NEW / (admit_s + run_s), "peak_memory_gb": peak_gb,
            "kv_pool_bytes": pool_bytes, "batched_engine_kv_bytes": slot_bytes * ENGINE_SLOTS * SERVE_MAX_LEN,
            "prefix_hits": engine.prefix_hits, "prefix_tokens_saved": engine.prefix_tokens_saved,
            "preemptions": engine.preemptions, "launches": {n: c for n, c in counts.items() if c},
        }
        log(json.dumps(out))
        return results, out["launches"], out

    def paged(**kw):
        return PagedEngine(model, max_batch=ENGINE_SLOTS, max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK,
                           page_size=PAGED_PAGE_SIZE, **kw)

    t0 = time.perf_counter()
    if reference is None:  # phase 15's serial arm
        engine = BatchedEngine(model, max_batch=ENGINE_SLOTS, max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK)
        rids = [engine.add(p, SERVE_NEW) for p in prompts]
        engine.run_to_completion(burst=SERVE_BURST)
        reference = [engine.result(r) for r in rids]
        del engine
    tpk.paged_gather = counted_gather  # `paged_read_raw` calls it by its module's name
    try:
        res_b, counts_b, _ = run("b: bf16, full reserve", paged(
            n_pages=PAGED_FULL_PAGES, reserve="full", prefix_sharing=False), prompts, True)
        ties_b = check_same_tokens("phase 20(b) against phase 15's serial arm", model, prompts, res_b, reference)
        gc.collect()
        torch.cuda.empty_cache()
        res_ref, _, _ = run("c reference: qint4 cache, full reserve, no sharing", paged(
            n_pages=PAGED_FULL_PAGES, reserve="full", prefix_sharing=False, kv_quant=PAGED_KV), shared, True)
        res_c, counts_c, out_c = run("c: qint4 cache, prompt reserve, prefix sharing, pool pressure", paged(
            n_pages=PAGED_PRESSURE_PAGES, reserve="prompt", prefix_sharing=True, kv_quant=PAGED_KV), shared, False)
    finally:
        tpk.paged_gather = real_gather
    if out_c["preemptions"] < 1 or out_c["prefix_hits"] < 1:
        raise RuntimeError(f"phase 20(c): preemptions {out_c['preemptions']}, prefix hits {out_c['prefix_hits']}: "
                           "want at least one of each")
    ties_c = check_same_tokens("phase 20(c) against its unshared full-reserve run", model, shared, res_c, res_ref,
                               PAGED_KV)
    log(json.dumps({"phase20_ties": {"b": len(ties_b), "c": len(ties_c)}}))
    log(f"paged: phase 20 took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return {"b": counts_b, "c": counts_c}


def phase_serving_int8(model) -> dict:
    """Phase 15 on phase 6's int8 model (lm_head bf16): the serial `add` arm,
    its [1, 64] chunks through #6 at M = 64 (224 launches a chunk forward),
    its decode steps over 8 rows at M = 8 (224 a step). The batch arm's
    [8, 64] chunks are M = 512, outside #6's envelope (M <= 256), where the
    port takes JAX's XLA formula as JAX does: no kernel runs there, so that
    arm is left out for this model. Returns the arm's launch counts."""
    log("serving: phase 15 on the int8 model runs the serial arm only: the batch arm's [8, 64] chunks "
        "(M = 512) lie outside qbytes_mm's envelope (M <= 256) and take JAX's XLA formula, no kernel")
    return phase_serving("llama-3.1-8b-config qint8 (lm_head bf16), bf16 cache", model, "qbytes_mm_int8",
                         arms=("serial",))


def build_mixtral(config, seed: int, stacked: bool = True, experts: str = "qint4"):
    """The Mixtral configuration with random weights from `seed`, built on
    "meta" and materialized on the card one decoder layer at a time: each
    layer's experts are quantized to `experts` (`quantize(layer,
    weights=experts, include="*experts*")`), its other linears (attention,
    router) to qint4, all frozen, and its MoE block converted to the stacked
    dispatch (when `stacked`), before the next layer's weights are drawn. The
    lm_head and the embedding stay bf16, as `quantize(..., exclude="lm_head")`
    leaves them."""
    from quanto_tpu_torch import StackedSparseMoeBlock, convert_moe_to_stacked, freeze, quantize
    from quanto_tpu_torch.models.mixtral import MixtralForCausalLM
    from quanto_tpu_torch.nn import QLinear
    from quanto_tpu_torch.tensor.weights import WeightQBitsArray, WeightQBitsHopperArray

    bits = int(experts[len("qint"):])

    def per_layer(layer):
        if experts != "qint4":
            quantize(layer, weights=experts, include="*experts*")
        quantize(layer, weights="qint4")
        freeze(layer)
        if stacked and convert_moe_to_stacked(layer, capacity_factor=2.0) != 1:
            raise RuntimeError("convert_moe_to_stacked did not convert the layer's MoE block")

    model = MixtralForCausalLM(config, device="meta")
    model.materialize_("cuda", torch.Generator("cuda").manual_seed(seed), layer_fn=per_layer)
    for layer in model.model.layers:
        attn = [layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj, layer.self_attn.o_proj]
        moe = layer.block_sparse_moe
        if not all(isinstance(m, QLinear) and isinstance(m.weight, WeightQBitsHopperArray)
                   and m.weight.bits == 4 for m in attn):
            raise RuntimeError("attention projections are not qint4 in the Hopper layout")
        if stacked:
            expert_bits = {p.bits for p in (moe.proj_gate, moe.proj_up, moe.proj_down)}
        else:
            expert_bits = {w.bits if isinstance(w, WeightQBitsHopperArray) else None
                           for e in moe.experts for w in (e.w1.weight, e.w2.weight, e.w3.weight)}
        if expert_bits != {bits}:
            raise RuntimeError(f"experts of widths {expert_bits} in the Hopper layout, want {{{bits}}}")
        # The router (N = 8) is off the kernels' envelope: zero-padded onto it, where the tree has the
        # padding rule (before it, the router kept the generic layout).
        router, padding = moe.gate.weight, hasattr(WeightQBitsHopperArray, "pad_geometry")
        if not isinstance(router, WeightQBitsHopperArray if padding else WeightQBitsArray) or (
                padding and router.pad is None):
            raise RuntimeError(f"the router is in the {type(router).__name__} layout")
        if stacked != isinstance(moe, StackedSparseMoeBlock):
            raise RuntimeError(f"MoE block {type(moe).__name__}, stacked={stacked}")
    if isinstance(model.lm_head, QLinear):
        raise RuntimeError("the lm_head should stay bf16")
    return model


def moe_step_bytes(model, routed_experts: int) -> int:
    """Bytes a decode step reads at least: every weight but the experts, and
    `routed_experts` experts' stacked payloads, scales and shifts per layer."""
    total = 0
    for layer in model.model.layers:
        moe = layer.block_sparse_moe
        for m in [layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj,
                  layer.self_attn.o_proj, moe.gate]:
            w = m.weight
            fields = (w._packed, w._scale_t, w._shift_t) if hasattr(w, "_packed") else (
                w._data.packed_data, w._scale, w._shift)
            total += sum(t.numel() * t.element_size() for t in fields)
        for proj in (moe.proj_gate, moe.proj_up, moe.proj_down):
            per_expert = sum(t[0].numel() * t.element_size() for t in (proj.packed, proj.scale_t, proj.shift_t))
            total += routed_experts * per_expert
    return total + model.lm_head.weight.numel() * model.lm_head.weight.element_size()


def mixtral_want(config, batch: int, expert_bits: int = 4, router_kernel: bool = True):
    """Exact launches of one prefill (4096 tokens: B x T, or B16 x T16) and
    one decode step: the attention's q/k/v/o through `qbits_mm`, the MoE
    block's three projections through the MoE kernels on the route the shape
    takes (prefill: the capacity gather, 3 `qbits_moe_tiled`; decode at B = 1:
    the selective route, 3 `qbits_moe_small_m`; at B = 4 the unique-expert
    route and at B = 16 the all-experts route, each 2 `qbits_moe_small_m`
    (gate, up) and the down projection's `qbits_moe_tiled`, whose M <= 16 arm
    is TPU #15 (`qbits_moe_tiled_small_m`); at B = 16 the two are
    `qbits_moe_all`'s, TPU #12). With int2 experts every MoE kernel launch is
    one of the int2 arm's too. The router (N = 8, off the envelope) is
    zero-padded onto it and takes `qbits_mm` too, once a layer, where
    `router_kernel` (trees before the padding rule kept it generic)."""
    L = config.num_hidden_layers
    S_K, E = batch * config.num_experts_per_tok, config.num_local_experts
    dense = (5 if router_kernel else 4) * L
    prefill = {"qbits_mm_tiled": dense, "qbits_moe_tiled": 3 * L}
    step = {"qbits_mm_small_m": dense, "flash_decode": L}
    if S_K < E:
        step["qbits_moe_small_m"] = 3 * L
    else:
        step.update(qbits_moe_small_m=2 * L, qbits_moe_tiled=L)
        if "qbits_moe_tiled_small_m" in counters():  # the down call at M = B <= 16: TPU #15
            step["qbits_moe_tiled_small_m"] = L
    if expert_bits == 2:
        for want in (prefill, step):
            want.update({f"{n}_int2": c for n, c in want.items() if n.startswith("qbits_moe")})
    if S_K > 2 * E and "qbits_moe_all" in counters():
        step["qbits_moe_all"] = 2 * L
    return prefill, step


@torch.no_grad()
def phase_mixtral(model, ids, expert_bits: int = 4, new: int = NEW, record=None) -> dict:
    """Phase 8 (phase 12 with int2 experts) at one batch: prefill of the
    prompts `ids` [B, T'] (last position only) and `new` - 1 greedy decode
    steps over a bf16 cache of T' + `new` slots, with exact launch counts of
    every kernel in each half. Returns the run's launch counts; a `record`
    dict takes the prefill logits, the tokens and the counts (phase 16)."""
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, generate, make_cache, prefill

    config = model.config
    batch, prompt = ids.shape
    steps = new - 1
    ref_tokens = generate(model, ids, new)  # warm-up through the user-facing entry point
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cache = make_cache(model, batch, prompt + new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(model, ids, cache, last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = read_counts()
    first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
    t0 = time.perf_counter()
    rest, cache = decode(model, first, cache, prompt, steps)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dec = {n: launches[n] - pre[n] for n in launches}
    router = model.model.layers[0].block_sparse_moe.gate.weight
    want_pre, want_step = mixtral_want(config, batch, expert_bits, router_kernel=hasattr(router, "_packed"))
    zeros = {n: 0 for n in launches}
    if pre != {**zeros, **want_pre}:
        raise RuntimeError(f"mixtral B={batch}: prefill launches {pre}, want {want_pre} and 0 elsewhere")
    want_dec = {n: c * steps for n, c in want_step.items()}
    if dec != {**zeros, **want_dec}:
        raise RuntimeError(f"mixtral B={batch}: decode launches {dec}, want {want_dec} and 0 elsewhere")
    if logits.shape != (batch, 1, config.vocab_size) or not torch.isfinite(logits).all():
        raise RuntimeError(f"mixtral B={batch}: prefill logits: shape {tuple(logits.shape)} or non-finite values")
    if not torch.equal(torch.cat([ids, first, rest], dim=1), ref_tokens):
        raise RuntimeError(f"mixtral B={batch}: generate() and prefill + decode gave different tokens")
    if int(rest.min()) < 0 or int(rest.max()) >= config.vocab_size:
        raise RuntimeError(f"mixtral B={batch}: decoded token ids out of the vocabulary")
    if record is not None:
        record.update(logits=logits.cpu(), tokens=torch.cat([first, rest], dim=1).cpu(), launches=launches)
    # Least bytes of a step: top-2 of 8 reads 2 experts per layer at B = 1; at B = 4 and 16 between
    # 2 and all 8, as the step routes (the bound is given at both ends).
    lo, hi = moe_step_bytes(model, 2), moe_step_bytes(model, 2 if batch == 1 else MOE_EXPERTS)
    log(json.dumps({
        "mixtral": f"mixtral-8x7b-config qint{expert_bits} experts, qint4 attention (lm_head bf16), "
                   "stacked MoE, bf16 cache",
        "batch": batch, "prompt": prompt, "new_tokens": new, "decode_steps": steps,
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_per_step": decode_s / steps * 1e3,
        "decode_tok_s": batch * steps / decode_s,
        "peak_memory_gb": peak_gb,
        "prefill_launches": {n: c for n, c in pre.items() if c},
        "decode_launches": {n: c for n, c in dec.items() if c},
        "decode_step_bytes_2_experts": lo, "decode_step_bytes_routed_max": hi,
        "decode_step_bound_ms": [lo / PEAK_BYTES_PER_S * 1e3, hi / PEAK_BYTES_PER_S * 1e3],
    }))
    del cache, logits
    return launches


def check_no_sync(model) -> None:
    """Phase 8: one MoE block's decode forward at B = 1 (selective), B = 4
    (unique-expert) and B = 16 (all-experts) must not synchronize the host
    with the card."""
    block = model.model.layers[0].block_sparse_moe
    g = torch.Generator(device="cuda").manual_seed(21)
    for batch in (1, 4, B16):
        x = torch.randn((batch, 1, model.config.hidden_size), device="cuda", generator=g).to(torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = block(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if y.shape != x.shape or not torch.isfinite(y).all():
            raise RuntimeError(f"MoE block at B={batch}: output {tuple(y.shape)} or non-finite values")
    log(f"mixtral: the MoE block's decode forward at B = 1, 4 and {B16} ran with no host sync")


# Phase 9's limits, set from its readings on random weights (NVIDIA H100). Cosine of the stacked
# model's logits against the dense-mask and plain paths, per row whose routing agrees between the
# two (readings 0.99988-0.99997).
MIXTRAL_E2E_COS = 0.9998
# A top-1 token may differ only at a logit tie: the other path's logits of the two tokens within
# LOGIT_TIE of the row's largest |logit|, about one bf16 step there (the logits are bf16; the
# one flip seen was an exact tie, gap 0).
LOGIT_TIE = 2.0 ** -7
# A row whose top-2 experts differ between the two paths in some layer took other experts, so its
# logits are not compared; that is allowed only at a routing tie: in that layer both paths' 2nd
# and 3rd routing probabilities within ROUTE_TIE. The largest router-probability difference
# between the paths on rows whose routing agrees is 0.0065, which moves a 2nd-3rd margin by at
# most 0.013.
ROUTE_TIE = 0.02
# Two weight seeds, so that a tie seen on one is not the whole evidence.
MIXTRAL_E2E_SEEDS = (1, 2)
# MIXTRAL_B16_PREFILL: the B16 x T16 prefill takes the capacity route, where an expert routed
# more tokens than its capacity keeps those of the largest routing weights; weights that differ
# between the paths in their last bits can keep another token there, and that token's hidden
# state moves its sequence's later positions. Phase 8's split (`split_mixtral_prefill`) found no
# kernel at fault: fed the same input and routing, every layer's attention, MoE block (#14, #15)
# and output agree with the plain path within cosine 1 - 6e-7, and the two routers set no token
# apart on the same input; the paths part only as such last-bit differences compound over depth. Its rows read cosine down to
# 0.99937 (seed 1) and 0.99966 (seed 2) against the plain path, 0.99991 or more against the
# dense-mask path (NVIDIA H100 80GB HBM3), below MIXTRAL_E2E_COS on some rows against the plain
# path, so its logits are logged, not held; the B16 decode step, the all-experts route that TPU
# #12 carries, starts from one prefill cache in every path and is held to phase 9's limits
# (read 0.99990 or more against both).


def route_record(model):
    """Record, for each call of each layer's router, the softmax over the
    experts at the last position [B, E]; returns (records, hook handles)."""
    from quanto_tpu_torch.models.llama import _deq

    records = []

    def hook(_mod, _args, out):
        records.append(torch.softmax(_deq(out).float()[:, -1], dim=-1))

    return records, [layer.block_sparse_moe.gate.register_forward_hook(hook) for layer in model.model.layers]


def compare_rows(what: str, k, o, route_k, route_o) -> None:
    """Hold the stacked path's logits `k` [B, V] against another path's `o`,
    row by row, given both paths' routing probabilities [L, B, E] at the same
    position: a row routed alike needs cosine > MIXTRAL_E2E_COS and the same
    top-1 token or a logit tie; a row routed differently needs a routing tie.
    Logs every tie it accepts; raises on anything else."""
    top_k, top_o = k.argmax(-1), o.argmax(-1)
    cos = torch.nn.functional.cosine_similarity(k, o, dim=-1)
    sets_k = route_k.topk(2, dim=-1).indices.sort(dim=-1).values  # [L, B, 2]
    sets_o = route_o.topk(2, dim=-1).indices.sort(dim=-1).values
    p_k = route_k.sort(dim=-1, descending=True).values
    p_o = route_o.sort(dim=-1, descending=True).values
    margin_k, margin_o = p_k[..., 1] - p_k[..., 2], p_o[..., 1] - p_o[..., 2]  # [L, B]
    for r in range(k.shape[0]):
        differ = (sets_k[:, r] != sets_o[:, r]).any(dim=-1).nonzero().flatten().tolist()
        row = {"row": r, "top1": [int(top_k[r]), int(top_o[r])], "cosine": cos[r].item()}
        if differ:
            margins = [[margin_k[layer, r].item(), margin_o[layer, r].item()] for layer in differ]
            log(json.dumps({"mixtral_routing_tie": what, **row, "layers": differ, "margins_2nd_3rd": margins}))
            if max(max(m) for m in margins) > ROUTE_TIE:
                raise RuntimeError(f"{what}: row {r} is routed differently with no routing tie: {margins}")
            continue
        if not cos[r] > MIXTRAL_E2E_COS:
            raise RuntimeError(f"{what}: row {r}, routed alike, has cosine {cos[r].item()} <= {MIXTRAL_E2E_COS}")
        if top_k[r] != top_o[r]:
            gap = (o[r, top_o[r]] - o[r, top_k[r]]).item()
            scale = o[r].abs().max().item()
            log(json.dumps({"mixtral_logit_tie": what, **row, "logit_gap": gap, "max_abs_logit": scale}))
            if gap > LOGIT_TIE * scale:
                raise RuntimeError(f"{what}: row {r}'s top-1 token differs with no logit tie (gap {gap})")


@torch.no_grad()
def split_mixtral_prefill(model, ids) -> dict:
    """Phase 8's split of MIXTRAL_B16_PREFILL (ROADMAP.md Queue 3): the B16 x
    T16 prefill of the full-depth stacked model, once on the kernel path
    (recording each decoder layer's input, each router's output and each MoE
    block's input), then through the plain versions with every layer fed the
    kernel path's input, every MoE block its input and every router the
    kernel path's output (the same routing, so the same capacity choice). Per
    layer: the attention output's, the MoE block's and the layer output's
    cosine and max |difference| / max |kernel| against the kernel path, and
    the tokens whose top-2 experts the two routers' own outputs would set
    apart. Also the last-position logits of an unforced plain prefill against
    the kernel path's. Logs all; returns the worst of each."""
    from quanto_tpu_torch.models.serve import make_cache, prefill

    t0 = time.perf_counter()
    rec = {"kernel": {}, "plain": {}}
    mode = ["kernel"]
    handles = []

    def keep(key):
        def hook(_mod, _args, out):
            rec[mode[0]][key] = out[0] if isinstance(out, tuple) else out
        return hook

    def feed(key):
        def hook(_mod, args):
            if mode[0] == "kernel":
                rec["kernel"][key] = args[0]
                return None
            return (rec["kernel"][key], *args[1:])
        return hook

    def router(i):
        def hook(_mod, _args, out):
            rec[mode[0]][("gate", i)] = out
            return rec["kernel"][("gate", i)] if mode[0] == "plain" else None
        return hook

    for i, layer in enumerate(model.model.layers):
        moe = layer.block_sparse_moe
        handles += [
            layer.register_forward_pre_hook(feed(("in", i))), layer.register_forward_hook(keep(("out", i))),
            layer.self_attn.register_forward_hook(keep(("attn", i))),
            moe.register_forward_pre_hook(feed(("moe_in", i))), moe.register_forward_hook(keep(("moe", i))),
            moe.gate.register_forward_hook(router(i)),
        ]
    cache_len = ids.shape[1] + 8
    try:
        k_logits, _ = prefill(model, ids, make_cache(model, ids.shape[0], cache_len), last_only=True)
        mode[0] = "plain"
        with plain_versions():
            prefill(model, ids, make_cache(model, ids.shape[0], cache_len), last_only=True)
    finally:
        for h in handles:
            h.remove()
    with plain_versions():
        p_logits, _ = prefill(model, ids, make_cache(model, ids.shape[0], cache_len), last_only=True)
    torch.cuda.synchronize()

    def compare(a, b):
        a, b = a.float().flatten(), b.float().flatten()
        return cosine(a, b), ((a - b).abs().max() / a.abs().max()).item()

    per_layer = []
    for i in range(len(model.model.layers)):
        k, p = rec["kernel"], rec["plain"]
        row = {"layer": i}
        for part in ("attn", "moe", "out"):
            row[f"{part}_cosine"], row[f"{part}_rel_err"] = compare(k[(part, i)], p[(part, i)])
        top_k = k[("gate", i)].float().topk(2, dim=-1).indices.sort(dim=-1).values
        top_p = p[("gate", i)].float().topk(2, dim=-1).indices.sort(dim=-1).values
        row["tokens_routed_apart"] = int((top_k != top_p).any(-1).sum())
        per_layer.append(row)
        log("mixtral_split " + json.dumps(row))
    cos_rows = F.cosine_similarity(k_logits[:, -1].float(), p_logits[:, -1].float(), dim=-1)
    out = {
        "min_attn_cosine": min(r["attn_cosine"] for r in per_layer),
        "min_moe_cosine": min(r["moe_cosine"] for r in per_layer),
        "min_layer_cosine": min(r["out_cosine"] for r in per_layer),
        "max_moe_rel_err": max(r["moe_rel_err"] for r in per_layer),
        "tokens_routed_apart": sum(r["tokens_routed_apart"] for r in per_layer),
        "unforced_logits_cosine_min": cos_rows.min().item(), "rows": ids.shape[0], "tokens": ids.numel(),
    }
    out["seconds"] = time.perf_counter() - t0
    log("mixtral_split_summary " + json.dumps(out))
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    return out


@torch.no_grad()
def phase_mixtral_end_to_end(ids, ids16, seed: int, experts: str = "qint4"):
    """Phase 9 (phase 12's check with int2 experts): 2 layers at full width,
    B = 1 and B = 4 (prompts `ids`): prefill last-position logits and one
    decode step of the stacked model, against the same model's dense-mask
    blocks (run first, through `qbits_mm`) and against the stacked model
    through the plain versions, row by row (`compare_rows`). B = 16 (prompts
    `ids16`): its decode step, on the all-experts route (TPU #12), from the
    dense path's prefill cache in every path, held the same way; its prefill
    logits are logged only (MIXTRAL_B16_PREFILL)."""
    from quanto_tpu_torch import convert_moe_to_stacked
    from quanto_tpu_torch.models.mixtral import MixtralConfig
    from quanto_tpu_torch.models.serve import make_cache, prefill

    config = MixtralConfig(**dict(MIXTRAL_8X7B, num_hidden_layers=2), dtype=torch.bfloat16)
    model = build_mixtral(config, seed=seed, stacked=False, experts=experts)
    records, hooks = route_record(model)
    L = config.num_hidden_layers

    prompts = {1: ids[:1], 4: ids[:4], B16: ids16}
    shared = {}  # B16's prefill cache from the first path (dense), its decode step's input in all

    def run(batch):
        """(prefill logits, decode-step logits, routing [2, L, B, E]) at the last position."""
        x = prompts[batch]
        records.clear()
        pre, cache = prefill(model, x, make_cache(model, batch, x.shape[1] + 8), last_only=True)
        if batch == B16:
            cache = copy.deepcopy(shared.setdefault(batch, cache))
        step, _ = model(x[:, -1:], cache, x.shape[1])
        torch.cuda.synchronize()
        if len(records) != 2 * L:
            raise RuntimeError(f"recorded {len(records)} router calls, want {2 * L}")
        return pre[:, -1].float(), step[:, -1].float(), torch.stack(records).reshape(2, L, batch, -1)

    dense = {b: run(b) for b in prompts}
    if convert_moe_to_stacked(model, capacity_factor=2.0) != L:
        raise RuntimeError("convert_moe_to_stacked did not convert every block")
    reset_counts()
    kernel = {b: run(b) for b in prompts}
    counts = read_counts()
    arms = ("qbits_moe_small_m", "qbits_moe_tiled")
    if counts.get("qbits_moe_all", 2 * L) != 2 * L:  # the B = 16 step's gate and up, TPU #12
        raise RuntimeError(f"the stacked model launched TPU #12 {counts['qbits_moe_all']} times, want {2 * L}")
    if not all(counts[n] for n in arms) or (experts == "qint2" and not all(counts[n + "_int2"] for n in arms)):
        raise RuntimeError(f"the stacked model did not launch both MoE kernels' {experts} arms: {counts}")
    with plain_versions():
        plain = {b: run(b) for b in prompts}
    if read_counts() != counts:
        raise RuntimeError("the plain forward launched a kernel")
    for h in hooks:
        h.remove()
    for b in prompts:
        for i, what in enumerate(("prefill", "decode step")):
            k, d, p = kernel[b][i], dense[b][i], plain[b][i]
            rk, rd, rp = kernel[b][2][i], dense[b][2][i], plain[b][2][i]
            top_k, top_d, top_p = k.argmax(-1), d.argmax(-1), p.argmax(-1)
            log(json.dumps({
                "mixtral_end_to_end": what, "experts": experts, "batch": b, "seed": seed,
                "cosine_vs_dense": torch.nn.functional.cosine_similarity(k, d, dim=-1).tolist(),
                "cosine_vs_plain": torch.nn.functional.cosine_similarity(k, p, dim=-1).tolist(),
                "top1_stacked": top_k.tolist(), "top1_dense": top_d.tolist(), "top1_plain": top_p.tolist(),
                "top1_agree_dense": int((top_k == top_d).sum()), "top1_agree_plain": int((top_k == top_p).sum()),
                "route_max_abs_diff_vs_dense": (rk - rd).abs().max().item(),
                "route_max_abs_diff_vs_plain": (rk - rp).abs().max().item(),
            }))
            if b == B16 and what == "prefill":
                continue  # logged above, not held: MIXTRAL_B16_PREFILL
            compare_rows(f"{experts} seed {seed} B={b} {what} vs dense", k, d, rk, rd)
            compare_rows(f"{experts} seed {seed} B={b} {what} vs plain", k, p, rk, rp)
    del model
    gc.collect()
    torch.cuda.empty_cache()


@torch.no_grad()
def phase_llama_int2(config, ids) -> tuple:
    """Phase 11: Llama-3.1-8B in qint2 (group size 128, lm_head bf16). The
    decode run of phase 6 (B = 4 x 1024 prompts, 63 greedy steps over a bf16
    cache): every step 224 launches of `qbits_mm_small_m`'s int2 arm, the
    prefill at M = 4096 none (an int2 weight takes no kernel above M = 1024, as
    in JAX). Then a B = 1 prefill of 1024 tokens: 224 launches of
    `qbits_mm_tiled`'s int2 arm. Returns both runs' launch counts."""
    from quanto_tpu_torch.models.serve import make_cache, prefill

    layers = config.num_hidden_layers
    n_lin, steps = LINEARS_PER_LAYER * layers, NEW - 1
    t0 = time.perf_counter()
    model, qlinears = build_model(config, seed=0, weights="qint2", exclude="lm_head")
    torch.cuda.synchronize()
    log(f"int2: built + quantized + frozen {layers} layers in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    if not all(m.weight.bits == 2 for m in qlinears):
        raise RuntimeError("a linear of the qint2 model is not int2")
    step = n_lin * steps
    decode_counts = phase_arm(
        "int2: llama-3.1-8b-config qint2 (lm_head bf16), bf16 cache", model, ids, want_prefill={},
        want_decode={"qbits_mm_small_m": step, "qbits_mm_small_m_int2": step, "flash_decode": layers * steps},
    )

    counts = phase_prefill(
        "int2", "llama-3.1-8b-config qint2 (lm_head bf16), B = 1 x 1024 tokens, bf16 cache", model, ids[:1],
        want={"qbits_mm_tiled": n_lin, "qbits_mm_tiled_int2": n_lin}, peak_ops=PEAK_BF16_FLOPS,
    )
    del model, qlinears
    gc.collect()
    torch.cuda.empty_cache()
    return decode_counts, counts


@torch.no_grad()
def phase_prefill(tag: str, what: str, model, ids, want: dict, peak_ops: float) -> dict:
    """A prefill of the prompts `ids` (B x T tokens, last position only) over a
    bf16 cache, after a warm-up, with exact launch counts (`want`, 0
    elsewhere); logs its time and peak memory beside its linears' least time
    (2 M N K operations at `peak_ops`) under the key `<tag>_prefill`. Phases 11
    and 13 (B = 1) and `--only prefill` (phases 4 and 7 at B = 4). Returns its
    launch counts."""
    from quanto_tpu_torch.models.serve import make_cache, prefill

    batch = ids.shape[0]
    prefill(model, ids, make_cache(model, batch, T), last_only=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cache = make_cache(model, batch, T)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(model, ids, cache, last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = read_counts()
    if counts != {**{n: 0 for n in counts}, **want}:
        raise RuntimeError(f"{tag} B = {batch} prefill launches {counts}, want {want} and 0 elsewhere")
    if logits.shape != (batch, 1, model.config.vocab_size) or not torch.isfinite(logits).all():
        raise RuntimeError(f"{tag} B = {batch} prefill logits: shape {tuple(logits.shape)} or non-finite values")
    ops = linears_operations(model, batch * T)
    log(json.dumps({
        f"{tag}_prefill": what,
        "prefill_ms": prefill_s * 1e3, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": {n: c for n, c in counts.items() if c},
        "linears_operations": ops, "linears_bound_ms": ops / peak_ops * 1e3,
    }))
    return counts


# Phase 11's 2-layer check, kernel path against the plain versions on the same qint2 weights:
# cosine per row (phase 5's limit; readings in PERF.md), top-1 tokens equal or at a logit tie.
INT2_E2E_COS = 0.999


@torch.no_grad()
def phase_llama_int2_end_to_end(ids):
    """Phase 11's check at 2 layers and full width: a B = 1 prefill of 1024
    tokens (last-position logits, through the tiled kernel's int2 arm) and one
    decode step after a B = 4 prefill (through the small-M kernel's int2 arm),
    against the same model through the plain versions."""
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.serve import make_cache, prefill

    config = LlamaConfig(**dict(LLAMA31_8B, num_hidden_layers=2), dtype=torch.bfloat16)
    model, _ = build_model(config, seed=1, weights="qint2", exclude="lm_head")
    n_lin = LINEARS_PER_LAYER * config.num_hidden_layers

    def run():
        pre, _ = prefill(model, ids[:1], make_cache(model, 1, T), last_only=True)
        _, cache = prefill(model, ids, make_cache(model, B, T + 8), last_only=True)
        step, _ = model(ids[:, -1:], cache, T)
        torch.cuda.synchronize()
        return pre[:, -1].float(), step[:, -1].float()

    reset_counts()
    kernel = run()
    counts = read_counts()
    want = {**{n: 0 for n in counts}, "qbits_mm_tiled": n_lin, "qbits_mm_tiled_int2": n_lin,
            "qbits_mm_small_m": n_lin, "qbits_mm_small_m_int2": n_lin, "flash_decode": config.num_hidden_layers}
    if counts != want:
        raise RuntimeError(f"int2 end-to-end launches {counts}, want {want}")
    with plain_versions():
        plain = run()
    if read_counts() != counts:
        raise RuntimeError("int2: the plain forward launched a kernel")
    for what, k, p in (("B = 1 prefill", kernel[0], plain[0]), ("decode step", kernel[1], plain[1])):
        check_rows("int2", what, k, p, INT2_E2E_COS)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def check_rows(tag: str, what: str, k: torch.Tensor, p: torch.Tensor, min_cos: float) -> None:
    """Phases 11 and 13: last-position logits [rows, V] of the kernel path `k`
    against the plain versions' `p`: each row's cosine above `min_cos`, and
    the same top-1 token or a logit tie (LOGIT_TIE)."""
    cos = F.cosine_similarity(k, p, dim=-1)
    top_k, top_p = k.argmax(-1), p.argmax(-1)
    log(json.dumps({f"{tag}_end_to_end": what, "cosine": cos.tolist(), "top1_kernel": top_k.tolist(),
                    "top1_plain": top_p.tolist()}))
    if not bool((cos > min_cos).all()):
        raise RuntimeError(f"{tag} {what}: cosine {cos.tolist()} <= {min_cos}")
    for r in (top_k != top_p).nonzero().flatten().tolist():
        gap = (p[r, top_p[r]] - p[r, top_k[r]]).item()
        scale = p[r].abs().max().item()
        log(json.dumps({f"{tag}_logit_tie": what, "row": r, "logit_gap": gap, "max_abs_logit": scale}))
        if gap > LOGIT_TIE * scale:
            raise RuntimeError(f"{tag} {what}: row {r}'s top-1 token differs with no logit tie (gap {gap})")


@torch.no_grad()
def phase_llama_w2a8(config, ids) -> dict:
    """Phase 13: Llama-3.1-8B in W2A8 (`quantize(weights="qint2",
    activations="qint8", exclude="lm_head")`, group size 128, calibrated as
    phase 7, frozen). (a) The exact form: phase 6's decode run (every step
    224 launches of `qbits_mm_int8_small_m`'s int2 arm, the M = 4096 prefill
    none: an int2 weight off the requant route takes no kernel above M =
    1024, as in JAX) and a B = 1 prefill of 1024 tokens (224 launches of
    `qbits_mm_tiled_int8`'s int2 arm). (b) Frozen again with
    `freeze(model, w4a8_requant_dot=True)`: every linear in the requant form,
    and phase 6's run again, its M = 4096 prefill through 224 launches of
    `qbits_mm_requant_int8`'s int2 arm. Returns each run's launch counts."""
    from quanto_tpu_torch import WeightQBitsRequantArray, freeze

    layers = config.num_hidden_layers
    n_lin, steps = LINEARS_PER_LAYER * layers, NEW - 1
    t_phase = time.perf_counter()
    model, qlinears = build_model(config, seed=0, weights="qint2", activations="qint8", exclude="lm_head")
    torch.cuda.synchronize()
    log(f"w2a8: built + quantized + calibrated ({CAL_BATCHES} x {B} x {CAL_T} tokens) + frozen in "
        f"{time.perf_counter() - t_phase:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    if not all(m.weight.bits == 2 for m in qlinears):
        raise RuntimeError("a linear of the W2A8 model is not int2")
    decode = {"qbits_mm_int8_small_m": n_lin * steps, "qbits_mm_int8_small_m_int2": n_lin * steps,
              "flash_decode": layers * steps}
    what = "llama-3.1-8b-config qint2 weights, qint8 activations (lm_head bf16), bf16 cache"
    counts = {"decode": phase_arm(f"w2a8: {what}", model, ids, want_prefill={}, want_decode=decode,
                                  prefill_peak_ops=PEAK_BF16_FLOPS)}
    counts["b1_prefill"] = phase_prefill(
        "w2a8", f"{what}, B = 1 x 1024 tokens", model, ids[:1],
        want={"qbits_mm_tiled_int8": n_lin, "qbits_mm_tiled_int8_int2": n_lin}, peak_ops=PEAK_INT8_OPS,
    )
    freeze(model, w4a8_requant_dot=True)
    if not all(isinstance(m.weight, WeightQBitsRequantArray) for m in qlinears):
        raise RuntimeError("freeze(w4a8_requant_dot=True) left a W2A8 linear outside the requant form")
    counts["requant"] = phase_arm(
        f"w2a8 requant form: {what}", model, ids,
        want_prefill={"qbits_mm_requant_int8": n_lin, "qbits_mm_requant_int8_int2": n_lin}, want_decode=decode,
        prefill_peak_ops=PEAK_INT8_OPS,
    )
    del model, qlinears
    gc.collect()
    torch.cuda.empty_cache()
    log(f"w2a8: phase 13 (a, b) took {time.perf_counter() - t_phase:.1f} s")
    return counts


# Phase 13's 2-layer checks, set from its readings on random weights (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md §6):
# - the kernel path against the plain versions: each row's cosine above W2A8_E2E_COS. Readings:
#   1.0 in 23 of the 24 rows of both forms; 0.997975 in the exact form's ragged decode row 0, the
#   same in two calls, where one int8 activation code of layer 0's o_proj input moved (a value
#   0.0008 of a step from the rounding half in one path, `flash_decode` against its plain
#   version) and then hundreds of the next linears' codes (logged, `first_moved_codes`). Phase
#   5's 0.999 would refuse that one code; the limit allows 5x its 1 - cosine;
# - the requant form against the exact form (`check_requant_vs_exact`), to phase 5's limits:
#   witness readings 0.98e-3-1.48e-3 (REQUANT_WEIGHT_LIMIT is 2.7x the largest, 0.48x the
#   smallest requant vs exact reading of 8.3e-3), ratio readings 1.01-1.17 (W4A8: 0.73-0.89).
W2A8_E2E_COS = 0.99


@contextlib.contextmanager
def decode_inputs(model, record: list):
    """Record (name, module, float input) of every quantized linear's call on
    one-token rows (a decode step) of `model`."""
    from quanto_tpu_torch.nn import QLinear

    def hook(m, args, name):
        if isinstance(args[0], torch.Tensor) and args[0].shape[-2] == 1:
            record.append((name, m, args[0].float().clone()))

    handles = [m.register_forward_pre_hook(functools.partial(hook, name=n))
               for n, m in model.named_modules() if isinstance(m, QLinear)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def first_moved_codes(rec_k: list, rec_p: list) -> dict:
    """For each row of a decode step recorded by `decode_inputs` in two runs:
    the first quantized linear whose int8 input codes differ between them, how
    many differ, and the moved value nearest a rounding half (in steps, in
    each run)."""
    from quanto_tpu_torch.tensor.activations import quantize_activation

    moved = {}
    for (name, m, a), (_, _, b) in zip(rec_k, rec_p):
        ca, cb = (quantize_activation(t, m.activation_qtype, m.input_scale)._data for t in (a, b))
        step = m.input_scale.float()
        for r in range(a.shape[0]):
            diff = (ca[r] != cb[r]).flatten()
            if r in moved or not diff.any():
                continue
            xa, xb = (t[r].flatten()[diff] / step for t in (a, b))
            i = ((xa - xa.round()).abs() - 0.5).abs().argmin()
            moved[r] = {"linear": name, "codes_moved": int(diff.sum()),
                        "x_over_step": [xa[i].item(), xb[i].item()]}
    return moved


@torch.no_grad()
def phase_w2a8_end_to_end(ids) -> None:
    """Phase 13's check at 2 layers and full width, on a calibrated W2A8 model:
    the kernel path against the plain versions called explicitly, for a B = 1
    prefill of 1024 tokens (last-position logits, through the tiled int8
    kernel's int2 arm) and one decode step at ragged per-row positions after a
    B = 4 prefill (through the small-M int8 kernel's int2 arm); then the same
    weights frozen into the requant form, its B = 4 prefill (through the
    requant kernel's int2 arm) held against the exact form's as phase 5 holds
    W4A8's, and its kernel path against its plain versions."""
    from quanto_tpu_torch import freeze
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.serve import make_cache, prefill
    from quanto_tpu_torch.nn import QLinear

    config = LlamaConfig(**dict(LLAMA31_8B, num_hidden_layers=2), dtype=torch.bfloat16)
    layers = config.num_hidden_layers
    model, _ = build_model(config, seed=1, weights="qint2", activations="qint8", exclude="lm_head")
    n_lin = LINEARS_PER_LAYER * layers
    ragged = torch.tensor([T, T - 4, T - 100, 300], device="cuda")

    def run():
        """Last-position logits of a B = 1 prefill, a B = 4 prefill, a ragged decode step."""
        pre1, _ = prefill(model, ids[:1], make_cache(model, 1, T), last_only=True)
        pre4, cache = prefill(model, ids, make_cache(model, B, T + 8), last_only=True)
        step, _ = model(ids[:, -1:], cache, ragged)
        torch.cuda.synchronize()
        return pre1[:, -1].float(), pre4[:, -1].float(), step[:, -1].float()

    def kernel_vs_plain(form: str, want: dict):
        rec_k, rec_p = [], []
        reset_counts()
        with decode_inputs(model, rec_k):
            kernel = run()
        counts = read_counts()
        if counts != {**{n: 0 for n in counts}, **want}:
            raise RuntimeError(f"w2a8 {form} end-to-end launches {counts}, want {want} and 0 elsewhere")
        with plain_versions(), decode_inputs(model, rec_p):
            plain = run()
        if read_counts() != counts:
            raise RuntimeError(f"w2a8 {form}: the plain forward launched a kernel")
        log(json.dumps({"w2a8_first_moved_codes": f"{form}, ragged decode step, kernel vs plain",
                        "rows": first_moved_codes(rec_k, rec_p)}))
        for what, k, p in zip(("B = 1 prefill", "B = 4 prefill", "ragged decode step"), kernel, plain):
            check_rows("w2a8", f"{form}, {what}", k, p, W2A8_E2E_COS)
        return kernel

    exact_want = {"qbits_mm_tiled_int8": n_lin, "qbits_mm_tiled_int8_int2": n_lin,
                  "qbits_mm_int8_small_m": n_lin, "qbits_mm_int8_small_m_int2": n_lin, "flash_decode": layers}
    logits_exact = kernel_vs_plain("exact form", exact_want)[1]
    with float_activations(model):
        logits_float_x = run()[1]
    freeze(model, w4a8_requant_dot=True)
    with dense_weights(model, requant=False):
        logits_int2_w = run()[1]
    with dense_weights(model, requant=True):
        logits_requant_w = run()[1]
    logits_requant = kernel_vs_plain("requant form", {
        **exact_want, "qbits_mm_requant_int8": n_lin, "qbits_mm_requant_int8_int2": n_lin,
    })[1]
    weight_change = []
    for m in model.modules():
        if isinstance(m, QLinear):
            w2 = m.weight.dequantize().float()
            weight_change.append(((requant_dense(m.weight) - w2).norm() / w2.norm()).item())
    check_requant_vs_exact(logits_requant, logits_exact, logits_float_x, logits_requant_w, logits_int2_w,
                           weight_change, label="w2a8 ")
    del model
    gc.collect()
    torch.cuda.empty_cache()


# Phase 14, (a): 1 - cosine of each row of the TP logits against phase 4's unsharded ones, at
# most TP_1MCOS, at the prefill's last position and at each teacher-forced decode step. Predicted
# <= 1e-3 for the prefill; read 1.24e-3-1.40e-3 over the 4 rows, and 1.34e-3-1.78e-3 over the
# 64 teacher-forced positions (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6). The limit is about
# twice the largest prefill reading.
TP_1MCOS = 3e-3
# The witness of the cause: the same prefill with float32 row partials (nothing rounded before
# the sum) must come closer to phase 4's than the bf16-partials run by TP_WITNESS_FALL at least.
# Predicted a fall of 10x or more; read 2.05x-2.18x per row (1 - cosine 5.69e-4-6.62e-4): the
# bf16 rounding of the partials is about half of the difference, the rest comes from summing K
# in two halves at all, which the model's bf16 roundings carry through 32 layers. The limit is
# about 0.7x the smallest reading.
TP_WITNESS_FALL = 1.5
# Where TP's top-1 token differs from phase 4's at a teacher-forced position, phase 4's logit gap
# between the two, at most TP_TOP1_GAP. Read: 28 flips in the 256 positions, gaps 0-0.21875
# (max |logit| 7.47, max |TP - unsharded| 0.41). The limit is about 1.4x the largest gap, below
# the 2 x max |TP - unsharded| that a flip's gap can reach.
TP_TOP1_GAP = 0.3125


def build_tp_model(config, seed: int, group):
    """Phase 4's model on this rank: built on "meta", each decoder layer drawn
    (phase 4's draw order and generator, so the same weights), quantized to
    qint4, frozen and sharded as it is drawn, so that no rank holds the bf16
    model; then the lm_head quantized and frozen, and the embedding and the
    lm_head sharded."""
    from quanto_tpu_torch import freeze, quantize
    from quanto_tpu_torch.models.llama import LlamaForCausalLM
    from quanto_tpu_torch.parallel import shard_model

    def layer_fn(layer):
        quantize(layer, weights="qint4")
        freeze(layer)
        shard_model(layer, group)

    model = LlamaForCausalLM(config, device="meta")
    model.materialize_("cuda", torch.Generator("cuda").manual_seed(seed), layer_fn)
    quantize(model, weights="qint4")  # the lm_head: the layers' linears are quantized already
    freeze(model)
    shard_model(model, group)
    return model


def tp_counts() -> dict:
    """The kernel launches (`read_counts`), with `all_reduce` calls and the
    partitioned matmul's all_reduces."""
    from quanto_tpu_torch.ops.cuda import qbits_mm_sharded as SH
    from quanto_tpu_torch.ops.collectives import all_reduce

    return {**read_counts(), "all_reduce": all_reduce.calls,
            "qbits_mm_partitioned_all_reduces": SH.qbits_mm_partitioned.all_reduces}


def reset_tp_counts() -> None:
    from quanto_tpu_torch.ops.cuda import qbits_mm_sharded as SH
    from quanto_tpu_torch.ops.collectives import all_reduce

    reset_counts()
    all_reduce.calls = SH.qbits_mm_partitioned.all_reduces = 0


def tp_all_reduce_us(group) -> dict:
    """Median host time of one gloo all_reduce of float32 zeros on the card, in µs,
    at each shape of TP_ALL_REDUCE (a row shard's partials at decode and
    prefill), each call synchronised."""
    from quanto_tpu_torch.ops.collectives import all_reduce

    out = {}
    for shape in TP_ALL_REDUCE:
        t = torch.zeros(shape, device="cuda")
        times = []
        for _ in range(3 + 20 * (shape[0] == B)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce(t, group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e6)
        out["x".join(map(str, shape))] = sorted(times[1:])[len(times[1:]) // 2]
    return out


@contextlib.contextmanager
def float32_partials():
    """The witness of phase 14: each rank-local float product takes x cast to
    float32 into the same kernel, so a row shard's partial stays float32 up
    to the sum (a column shard's product is rounded to bf16 as before)."""
    from quanto_tpu_torch.ops.cuda import qbits_mm_sharded as SH

    saved = SH.qbits_mm
    SH.qbits_mm = lambda x2, *args: saved(x2.float(), *args)
    try:
        yield
    finally:
        SH.qbits_mm = saved


@torch.no_grad()
def tp_full_depth(group, ids, ref_tokens) -> dict:
    """Phase 14 (a) on one rank: phase 4's run at tp = 2, with exact counts;
    then the same model fed phase 4's tokens `ref_tokens` (teacher forcing),
    and the witness prefill with float32 partials."""
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, make_cache, prefill

    config = LlamaConfig(**LLAMA31_8B, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = build_tp_model(config, 0, group)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    layers, steps = config.num_hidden_layers, NEW - 1
    n_lin = LINEARS_PER_LAYER * layers
    torch.cuda.reset_peak_memory_stats()
    reset_tp_counts()
    cache = make_cache(model, B, T + NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(model, ids, cache, last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = tp_counts()
    first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
    t0 = time.perf_counter()
    rest, cache = decode(model, first, cache, T, steps)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = tp_counts()
    dec = {n: counts[n] - pre[n] for n in counts}
    zeros = {n: 0 for n in counts}
    # Per forward: 225 partitioned products (7 a layer and the lm_head), 64 of them row shards; the
    # all_reduces of those 64, of the embedding and of the gathered logits.
    per_forward = {"qbits_mm_partitioned": n_lin + 1, "qbits_mm_partitioned_all_reduces": 2 * layers,
                   "all_reduce": 2 * layers + 2}
    want_pre = {**zeros, **per_forward, "qbits_mm_tiled": n_lin, "qbits_mm_small_m": 1}
    want_dec = {**zeros, **{n: c * steps for n, c in per_forward.items()},
                "qbits_mm_small_m": (n_lin + 1) * steps, "flash_decode": layers * steps}
    if pre != want_pre:
        raise RuntimeError(f"tp rank {group.rank}: prefill counts {pre}, want {want_pre}")
    if dec != want_dec:
        raise RuntimeError(f"tp rank {group.rank}: decode counts {dec}, want {want_dec}")
    if logits.shape != (B, 1, config.vocab_size) or not torch.isfinite(logits).all():
        raise RuntimeError(f"tp rank {group.rank}: prefill logits: shape {tuple(logits.shape)} or non-finite values")
    attn = model.model.layers[0].self_attn
    log(json.dumps({
        "tp": f"llama-3.1-8b-config qint4+head4 bf16, tp = {group.world_size}, rank {group.rank}; {TP_LABEL}",
        "backend": group.backend, "local_heads": [attn.num_heads, attn.num_kv_heads],
        "build_s": build_s, "prefill_ms": prefill_s * 1e3, "decode_ms_per_step": decode_s / steps * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "prefill_counts": {n: c for n, c in pre.items() if c}, "decode_counts": {n: c for n, c in dec.items() if c},
    }))
    out = {"logits": logits[:, -1].float().cpu(), "tokens": torch.cat([first, rest], dim=1).cpu(), "counts": counts,
           "prefill_ms": prefill_s * 1e3, "decode_ms_per_step": decode_s / steps * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del cache, logits
    out["forced"] = forced_logits(model, ids, ref_tokens)
    with float32_partials():
        out["witness"] = prefill(model, ids, make_cache(model, B, T + NEW), last_only=True)[0][:, -1].float().cpu()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


@torch.no_grad()
def tp_two_layers(group, ids) -> None:
    """Phase 14 (b) on one rank: phase 5's check of the qint4 and W4A8 arms at
    tp = 2, each model built, calibrated (W4A8) and frozen whole, then sharded;
    the kernel path against the plain versions called explicitly."""
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.serve import make_cache, prefill
    from quanto_tpu_torch.parallel import shard_model

    config = LlamaConfig(**dict(LLAMA31_8B, num_hidden_layers=2), dtype=torch.bfloat16)
    layers = config.num_hidden_layers
    ragged = torch.tensor([T, T - 4, T - 100, 300], device="cuda")
    for arm in ("qint4", "w4a8"):
        kw, step_kernel = E2E_ARMS[arm]
        model, _ = build_model(config, seed=1, **kw)
        shard_model(model, group)

        def run():
            """Prefill logits over a bf16 cache; one ragged decode step over a qint4 cache."""
            pre, _ = prefill(model, ids, make_cache(model, B, T), last_only=True)
            cache = make_cache(model, B, T + 8, kv_quant="qint4")
            _, cache = prefill(model, ids, cache, last_only=True)
            step, _ = model(ids[:, -1:], cache, ragged)
            torch.cuda.synchronize()
            return pre[:, -1].float(), step[:, -1].float()

        reset_counts()
        kernel = run()
        counts = read_counts()
        # Two prefills (M = 4096 in the layers, M = 4 in a quantized lm_head) and one decode step.
        head = 0 if kw.get("exclude") else 1
        n_lin = LINEARS_PER_LAYER * layers + head
        prefill_kernel = "qbits_mm_tiled" if arm == "qint4" else "qbits_mm_tiled_int8"
        want = {prefill_kernel: 2 * LINEARS_PER_LAYER * layers, step_kernel: n_lin + 2 * head,
                "flash_decode": layers, "qbits_mm_partitioned": 3 * n_lin}
        if counts != {**{n: 0 for n in counts}, **want}:
            raise RuntimeError(f"tp rank {group.rank} {arm}: 2-layer launches {counts}, want {want}")
        with plain_versions():
            plain = run()
        if read_counts() != counts:
            raise RuntimeError(f"tp rank {group.rank} {arm}: the plain forward launched a kernel")
        for what, k, p in zip(("prefill", "ragged decode step"), kernel, plain):
            check_rows(f"tp_rank{group.rank}_{arm}", what, k, p, 0.999)
        del model
        gc.collect()
        torch.cuda.empty_cache()


def tp_rank(rank: int, d) -> None:
    """One rank of phase 14 (spawned): join the group on the one card, load the
    kernels phase 2 built, time gloo's all_reduce, run (a) and (b), save what
    the parent checks to `d`."""
    import torch.distributed as dist

    from quanto_tpu_torch.ops.cuda import _build
    from quanto_tpu_torch.parallel import initialize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = initialize(rank, TP_WORLD, f"file://{d}/store", device="cuda:0")
    try:
        _build.build()
        ids = torch.randint(
            0, LLAMA31_8B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(7)
        ).cuda()  # phase 4's prompts
        out = {"all_reduce_us": tp_all_reduce_us(group), "backend": group.backend}
        out["full"] = tp_full_depth(group, ids, torch.load(d / "phase4_tokens.pt"))
        tp_two_layers(group, ids)
        torch.save(out, d / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_tp(ref_forced: torch.Tensor, ref_tokens: torch.Tensor) -> dict:
    """Phase 14: TP_WORLD ranks (spawned) share the one card over gloo, each
    running `tp_rank`; every rank must exit 0. Then the ranks' tokens, logits
    and teacher-forced logits must be equal. Rank 0's teacher-forced logits
    (phase 4's tokens fed in) are held against phase 4's `ref_forced` [NEW, B,
    V], whose greedy tokens are `ref_tokens` [B, NEW]: 1 - cosine at most
    TP_1MCOS at every position and row, and where the top-1 token differs,
    phase 4's logit gap between the two at most TP_TOP1_GAP. The witness (the
    prefill with float32 partials) must come closer to phase 4's prefill by
    TP_WITNESS_FALL at least. Returns rank 0's results."""
    import tempfile
    from pathlib import Path

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        torch.save(ref_tokens, d / "phase4_tokens.pt")
        ctx = mp.start_processes(tp_rank, args=(d,), nprocs=TP_WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + 900
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise RuntimeError("phase 14: the ranks did not finish in 900 s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        ranks = [torch.load(d / f"rank{r}.pt") for r in range(TP_WORLD)]
    full = [r["full"] for r in ranks]
    if not all(all(torch.equal(f[k], full[0][k]) for k in ("tokens", "logits", "forced", "witness")) for f in full):
        raise RuntimeError("phase 14: the ranks' tokens or logits differ")
    if any(r["backend"] != "gloo" for r in ranks):
        raise RuntimeError(f"phase 14: ranks sharing one card took {[r['backend'] for r in ranks]}, want gloo")
    for r, rank in enumerate(ranks):
        log(json.dumps({"tp_all_reduce_us": rank["all_reduce_us"], "rank": r, "float32": True, "note": TP_LABEL}))
    lt, lr = full[0]["forced"].float(), ref_forced.float()  # [NEW, B, V]
    one_minus_cos = 1 - F.cosine_similarity(lt, lr, dim=-1)  # [NEW, B]
    witness = (1 - F.cosine_similarity(full[0]["witness"], lr[0], dim=-1)).tolist()
    top_tp, top_ref = lt.argmax(-1), ref_tokens.t()
    flips = [(i, r, int(top_ref[i, r]), int(top_tp[i, r]),
              (lr[i, r, top_ref[i, r]] - lr[i, r, top_tp[i, r]]).item())
             for i, r in torch.nonzero(top_tp != top_ref).tolist()]
    log(json.dumps({
        "tp_vs_unsharded": "rank 0 fed phase 4's tokens (teacher forcing), against phase 4's logits; "
                           "position 0 is the prefill's last",
        "prefill_one_minus_cosine": one_minus_cos[0].tolist(), "limit": TP_1MCOS,
        "forced_one_minus_cosine_max_per_position": one_minus_cos.amax(dim=1).tolist(),
        "forced_one_minus_cosine_median": one_minus_cos.median().item(),
        "forced_one_minus_cosine_max": one_minus_cos.max().item(),
        "max_abs_logit": lr.abs().amax(dim=-1).max().item(), "max_abs_diff": (lt - lr).abs().amax().item(),
        "top1_equal_share": 1 - len(flips) / top_ref.numel(),
        "flips_position_row_phase4_tp_gap": flips, "top1_gap_limit": TP_TOP1_GAP,
        "witness_float32_partials_one_minus_cosine": witness, "witness_fall_limit": TP_WITNESS_FALL,
        "free_running_tokens_equal_share": (full[0]["tokens"] == ref_tokens).float().mean(dim=1).tolist(),
    }))
    if one_minus_cos.max() > TP_1MCOS:
        raise RuntimeError(f"phase 14: 1 - cosine {one_minus_cos.max().item()} against phase 4 above {TP_1MCOS}")
    if any(gap > TP_TOP1_GAP for *_, gap in flips):
        raise RuntimeError(f"phase 14: a top-1 token differs from phase 4's by a logit gap above {TP_TOP1_GAP}: {flips}")
    if max(witness) * TP_WITNESS_FALL > one_minus_cos[0].min():
        raise RuntimeError(f"phase 14: the float32-partials witness {witness} does not fall {TP_WITNESS_FALL}x "
                           f"below the bf16-partials prefill {one_minus_cos[0].tolist()}")
    return ranks[0]


# Phase 16: how far the peak device memory of `from_pretrained` may pass the loaded model's own
# bytes: one module's generic tensors and one block of unpacked codes (`from_generic`) at a time.
CKPT_LOAD_MARGIN = 1e9
CKPT_LAYERS = 4  # phase 16's qint8 Llama and Mixtral: full width, 4 layers


def weight_tensors(model) -> dict:
    """Every tensor a forward reads, by name: parameters, buffers and the
    fields of each frozen weight (`_packed`, `_scale_t`, `_shift_t`, `_data`,
    `_scale`, ...)."""
    from quanto_tpu_torch.tensor.packed import PackedArray
    from quanto_tpu_torch.tensor.qarray import QArray

    out = {}
    for name, m in model.named_modules():
        for n, t in [*m.named_parameters(recurse=False), *m.named_buffers(recurse=False)]:
            out[f"{name}.{n}"] = t
        w = getattr(m, "weight", None)
        if isinstance(w, QArray):
            for f in dataclasses.fields(w):
                v = getattr(w, f.name)
                v = v.packed_data if isinstance(v, PackedArray) else v
                if isinstance(v, torch.Tensor):
                    out[f"{name}.weight.{f.name}"] = v
    return out


def sync_and_evict(directory: str) -> None:
    """fsync every file of a saved checkpoint, then ask the kernel to drop
    its pages from the page cache (posix_fadvise DONTNEED, advisory), so that
    the load reads the disk rather than the memory the save just wrote."""
    for name in os.listdir(directory):
        fd = os.open(os.path.join(directory, name), os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def page_cache_share(paths) -> float:
    """The share of the files' pages in the page cache (mincore(2) over a
    private mapping of each): whether a load will read the disk or memory."""
    libc = ctypes.CDLL(None, use_errno=True)
    page = mmap.PAGESIZE
    resident = total = 0
    for path in paths:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), size, access=mmap.ACCESS_COPY)
        anchor = ctypes.c_char.from_buffer(mm)
        pages = -(-size // page)
        vec = (ctypes.c_ubyte * pages)()
        if libc.mincore(ctypes.c_void_p(ctypes.addressof(anchor)), ctypes.c_size_t(size), vec) != 0:
            raise OSError(ctypes.get_errno(), "mincore failed")
        resident += sum(v & 1 for v in vec)
        total += pages
        del anchor
        mm.close()
    return resident / max(total, 1)


def phase_checkpoint(label: str, build, run, stacked: bool = False, requant: bool = False) -> dict:
    """Phase 16 for one model: `build()` gives it quantized and frozen (a
    Mixtral with per-expert modules); `QuantizedModelForCausalLM(model)
    .save_pretrained` into a fresh `tempfile.mkdtemp()` (fsync'd, then its
    pages dropped from the page cache, the share still cached measured);
    `run(model, record, when)` (the run
    of the phase that built the model, its launch counts asserted) on the original,
    converted by `convert_moe_to_stacked` when `stacked`; the model freed;
    `from_pretrained` on the card, its peak device memory within the loaded
    model's bytes + CKPT_LOAD_MARGIN; Calibration's streamline flags (not in
    quanto's format) set from the original's; converted as the original;
    every tensor a forward reads EQUAL to the original's; the same run with
    prefill logits, tokens and launch counts EQUAL to the original's; with
    `requant`, `freeze(loaded, w4a8_requant_dot=True)` gives the original's
    requant form and `_s8` (phase 10's conversion). Prints one JSON line and
    returns the loaded run's launch counts."""
    from quanto_tpu_torch import (
        WeightQBitsHopperArray, WeightQBitsRequantArray, convert_moe_to_stacked, freeze, named_qmodules,
    )
    from quanto_tpu_torch.models.transformers_models import QuantizedModelForCausalLM

    model = build()
    need = 2 * sum(t.numel() * t.element_size() for t in weight_tensors(model).values())
    directory = tempfile.mkdtemp(prefix="quanto-tpu-torch-ckpt-")
    try:
        free = shutil.disk_usage(directory).free
        log(f"checkpoint {label}: {free / 1e9:.1f} GB free where tempfile writes ({directory})")
        if free < need:
            raise RuntimeError(f"checkpoint {label}: {free / 1e9:.1f} GB free, under twice the model's "
                               f"{need / 2e9:.1f} GB")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        QuantizedModelForCausalLM(model).save_pretrained(directory)
        t1 = time.perf_counter()
        sync_and_evict(directory)
        save_s, fsync_s = time.perf_counter() - t0, time.perf_counter() - t1
        shards = [os.path.join(directory, n) for n in os.listdir(directory) if n.endswith(".safetensors")]
        saved = sum(os.path.getsize(p) for p in shards)

        flags = {n: m.quantize_outputs for n, m in named_qmodules(model)}
        if stacked and convert_moe_to_stacked(model, capacity_factor=2.0) != model.config.num_hidden_layers:
            raise RuntimeError(f"checkpoint {label}: convert_moe_to_stacked missed a block")
        original = {}
        run(model, original, "original")
        want = {k: t.cpu() for k, t in weight_tensors(model).items()}
        s8 = {}
        if requant:
            s8 = {n: WeightQBitsRequantArray.from_hopper(m.weight)._s8.cpu() for n, m in model.named_modules()
                  if type(getattr(m, "weight", None)) is WeightQBitsHopperArray}
        del model
        gc.collect()
        torch.cuda.empty_cache()

        cached = page_cache_share(shards)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loaded = QuantizedModelForCausalLM.from_pretrained(directory)._wrapped
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak, held = torch.cuda.max_memory_allocated() - base, torch.cuda.memory_allocated() - base
        if peak > held + CKPT_LOAD_MARGIN:
            raise RuntimeError(f"checkpoint {label}: from_pretrained peaked at {peak / 1e9:.2f} GB for a model "
                               f"of {held / 1e9:.2f} GB")
        for n, m in named_qmodules(loaded):
            m.quantize_outputs = flags[n]
        if stacked:
            convert_moe_to_stacked(loaded, capacity_factor=2.0)
        got = weight_tensors(loaded)
        if list(got) != list(want):
            raise RuntimeError(f"checkpoint {label}: the loaded model's tensors are not the original's")
        unequal = [k for k, t in want.items() if got[k].dtype != t.dtype or not torch.equal(got[k].cpu(), t)]
        if unequal:
            raise RuntimeError(f"checkpoint {label}: loaded tensors differ from the original's: {unequal[:5]}")
        again = {}
        run(loaded, again, "loaded")
        if not torch.equal(again["logits"], original["logits"]):
            raise RuntimeError(f"checkpoint {label}: the loaded model's prefill logits differ from the original's")
        if not torch.equal(again["tokens"], original["tokens"]):
            raise RuntimeError(f"checkpoint {label}: the loaded model decoded other tokens")
        if again["launches"] != original["launches"]:
            raise RuntimeError(f"checkpoint {label}: launches {again['launches']}, the original's "
                               f"{original['launches']}")
        if requant:
            freeze(loaded, w4a8_requant_dot=True)
            forms = {n: m.weight for n, m in loaded.named_modules() if n in s8}
            if len(forms) != len(s8) or not all(isinstance(w, WeightQBitsRequantArray) and torch.equal(w._s8.cpu(), s8[n])
                                               for n, w in forms.items()):
                raise RuntimeError(f"checkpoint {label}: the reloaded requant form's _s8 is not the original's")
        log(json.dumps({
            "checkpoint": label, "saved_bytes": saved, "shards": len(shards), "save_s": save_s,
            "save_fsync_s": fsync_s, "page_cache_share_at_load": cached, "load_s": load_s,
            "load_gb_s": saved / load_s / 1e9, "load_peak_gb": peak / 1e9, "loaded_model_gb": held / 1e9,
            "disk_free_gb": free / 1e9, "tensors_equal": len(want), "logits_equal": True, "tokens_equal": True,
            "launches_equal": True, **({"requant_s8_equal": len(s8)} if requant else {}),
        }))
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        return again["launches"]
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def phase_checkpoints(ids, mixtral_ids) -> dict:
    """Phase 16: `phase_checkpoint` for phase 4's qint4 model and phase 7's
    calibrated W4A8 model (then its requant form) at full depth, phase 6's
    qint8 quantization at CKPT_LAYERS layers (TPU #6), and Mixtral-8x7B
    (qint4) at CKPT_LAYERS layers, built with per-expert modules and stacked
    after the load (B = 4 decode: #13 and #15). Each run is its phase's, with
    its launch counts. Returns {model label: the loaded run's launch counts}."""
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.mixtral import MixtralConfig

    config = LlamaConfig(**LLAMA31_8B, dtype=torch.bfloat16)
    config4 = LlamaConfig(**dict(LLAMA31_8B, num_hidden_layers=CKPT_LAYERS), dtype=torch.bfloat16)
    mixtral4 = MixtralConfig(**dict(MIXTRAL_8X7B, num_hidden_layers=CKPT_LAYERS), dtype=torch.bfloat16)
    L, L4, steps = config.num_hidden_layers, CKPT_LAYERS, NEW - 1
    n, n4 = LINEARS_PER_LAYER * L, LINEARS_PER_LAYER * L4

    def llama_run(label, want_prefill, want_decode):
        return lambda model, record, when: phase_arm(
            f"checkpoint {label} ({when})", model, ids, want_prefill, want_decode, record=record)

    models = [
        ("llama-3.1-8b-config qint4+head4 (phase 4)", lambda: build_model(config, seed=0)[0],
         {"qbits_mm_tiled": n, "qbits_mm_small_m": 1},
         {"qbits_mm_small_m": (n + 1) * steps, "flash_decode": L * steps}, {}),
        ("llama-3.1-8b-config w4a8, calibrated, lm_head bf16 (phase 7)",
         lambda: build_model(config, seed=0, weights="qint4", activations="qint8", exclude="lm_head")[0],
         {"qbits_mm_tiled_int8": n}, {"qbits_mm_int8_small_m": n * steps, "flash_decode": L * steps},
         {"requant": True}),
        (f"llama-3.1-8b-config qint8, lm_head bf16 (phase 6), {L4} layers",
         lambda: build_model(config4, seed=0, weights="qint8", exclude="lm_head")[0],
         {}, {"qbytes_mm_int8": n4 * steps, "flash_decode": L4 * steps}, {}),
    ]
    t0 = time.perf_counter()
    runs = {label: phase_checkpoint(label, build, llama_run(label, pre, dec), **kw)
            for label, build, pre, dec, kw in models}
    label = f"mixtral-8x7b-config qint4, lm_head bf16 (phase 8), {L4} layers"
    runs[label] = phase_checkpoint(
        label, lambda: build_mixtral(mixtral4, seed=0, stacked=False),
        lambda model, record, when: phase_mixtral(model, mixtral_ids, record=record), stacked=True)
    log(f"checkpoint: phase 16 took {time.perf_counter() - t0:.1f} s")
    return runs


# --- Phases 17-19 and their phase-3 rows: W8A8, the padded layout, HQQ, QAT, the small models -------


def phase_w8a8(flush):
    """Phase 3, the W8A8 route of `ops/qbytes_mm.py` (no TPU kernel: JAX
    computes it as an XLA dot): int8 x int8 through `torch._int_mm` and
    e4m3fn x e4m3fn through JAX's convert formula (`_fp8_dot`: bf16
    operands, exact for e4m3fn, float32 sums on the tensor cores), at W8A8_M
    over the four linear shapes, with the activation's scale times the
    weight's per-channel one in float32 and a float32 output, against the
    plain formula (float32 operands and sums): int8 EQUAL, e4m3fn within
    1e-5 * max|ref| (the order of float32 sums). The e4m3fn rows split the
    cause of the earlier route's error: `torch._scaled_mm`
    (`use_fast_accum=False`, Hopper's fp8 tensor cores) against the same
    plain formula, with its time (`scaled_mm_ms`, the yardstick of the fp8
    rate). Bound: the int8/fp8 operands, the scale and the float32 output
    once; 2MNK at the int8/fp8 tensor-core rate. Yardstick `torch.matmul` on
    the operands dequantized to bf16."""
    import quanto_tpu_torch as qtt
    from quanto_tpu_torch.ops import qbytes_mm as W8A8

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5678)
    rows = []
    for N, K in LINEAR_SHAPES:
        w = torch.randn((N, K), device=dev, generator=g, dtype=torch.bfloat16) * 0.02
        for name, qtype, plain, count in (
            ("w8a8_int8", qtt.qint8, W8A8.qbytes_int_mm_plain, "qbytes_int_mm"),
            ("w8a8_e4m3fn", qtt.qtypes["qfloat8_e4m3fn"], W8A8.qbytes_fp8_mm_plain, "qbytes_fp8_mm"),
        ):
            qw = qtt.quantize_weight(w, qtype, 0, qtt.AbsmaxOptimizer()(w, qtype, 0))
            w_bf16 = qw.dequantize()
            for M in W8A8_M:
                x = torch.randn((M, K), device=dev, generator=g, dtype=torch.bfloat16)
                qx = qtt.quantize_activation(x, qtype, (x.float().abs().amax() / qtype.qmax).reshape(()))
                x_bf16 = qx.dequantize()
                scale = qx._scale * qw._scale.float()

                def route():
                    return W8A8.qbytes_mm(qx._data, qw._data, scale)

                def reference():
                    return plain(qx._data, qw._data) * scale.t()

                before = read_counts()[count]
                out = route()
                if read_counts()[count] != before + 1:
                    raise RuntimeError(f"{name} M={M} N={N} K={K}: the route made no {count} call")
                ref = reference()
                extra = {}
                if name == "w8a8_int8":
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        raise RuntimeError(f"{name} M={M} N={N} K={K}: the route is not EQUAL to the plain formula")
                    err, cos = 0.0, 1.0
                else:
                    err, cos = check_kernel(f"{name} M={M} N={N} K={K}", out, ref)
                    if err > 1e-5 * ref.abs().max().item():
                        raise RuntimeError(f"{name} M={M} N={N} K={K}: max_abs_err {err} against the float32 formula")
                    xp = torch.cat([qx._data, qx._data.new_zeros(((-M) % 16, K))])

                    def scaled_mm():
                        one = torch.ones((), dtype=torch.float32, device=dev)
                        return torch._scaled_mm(xp, qw._data.t(), scale_a=one, scale_b=one, out_dtype=torch.float32,
                                                use_fast_accum=False)[:M] * scale.t()

                    extra = dict(scaled_mm_max_abs_err=(scaled_mm() - ref).abs().max().item(),
                                 max_abs_ref=ref.abs().max().item(), scaled_mm_ms=time_ms(scaled_mm, flush))
                nbytes = M * K + N * K + 4 * N + 4 + 4 * M * N
                t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, 2 * M * N * K / PEAK_INT8_OPS * 1e3
                row = dict(
                    name=name, M=M, N=N, K=K, max_abs_err=err, cosine=cos,
                    ms=time_ms(route, flush), plain_ms=time_ms(reference, flush),
                    library_ms=time_ms(lambda: torch.matmul(x_bf16, w_bf16.t()), flush),
                    bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations", **extra,
                )
                row["bound_share"] = row["bound_ms"] / row["ms"]
                rows.append(row)
                log("w8a8 " + json.dumps(row))
                del out, ref
            del qw, w_bf16
        del w
        torch.cuda.empty_cache()
    return rows


def phase_padded(K_mod, flush):
    """Phase 3, TPU #1, #2 (both arms) and #4 at the linears of SmolLM2-360M
    and Qwen2.5-0.5B that are off the envelope (`PADDED_SHAPES`): a random
    bf16 weight quantized qint4 with its group size and repacked by
    `from_generic`, zero-padded onto the envelope; each kernel on x padded by
    `pad_activations` against its plain version on the same padded operands,
    at the M of `PADDED_M`. The bound counts the true bytes and operations;
    `padded_bytes_ratio` is what the kernel reads beside them, `pad_ms` the
    time of `pad_activations`. Yardstick `torch.matmul` on the true operands
    in bf16."""
    import quanto_tpu_torch as qtt
    from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6789)
    sx = torch.tensor(0.0173, device=dev)
    rows = []
    for model_name, shapes in PADDED_SHAPES.items():
        for N, K, gs in shapes:
            w = torch.randn((N, K), device=dev, generator=g, dtype=torch.bfloat16) * 0.02
            scale, shift = qtt.MaxOptimizer()(w, qtt.qint4, axis=0, group_size=gs)
            hw = WeightQBitsHopperArray.from_generic(qtt.quantize_weight(w, qtt.qint4, 0, scale, shift=shift,
                                                                         group_size=gs))
            if hw is None or hw.pad is None:
                raise RuntimeError(f"{model_name} [{N}, {K}] gs {gs}: not in the padded Hopper layout")
            (Np, Kp), gsp = hw.kernel_shape, hw.kernel_group_size
            side = 2 * (K // gs) * N * 4
            ratio = (Np * Kp // 2 + 2 * (Kp // gsp) * Np * 4) / (N * K // 2 + side)
            w_bf16 = hw.dequantize()
            for name, M in PADDED_M.items():
                kernel = getattr(K_mod, name)
                int8 = "int8" in name
                if int8:
                    x = torch.randint(-128, 128, (M, K), dtype=torch.int8, device=dev, generator=g)
                    x_lib = (x.float() * sx).to(torch.bfloat16)
                else:
                    x = x_lib = torch.randn((M, K), device=dev, generator=g, dtype=torch.bfloat16)
                xp = hw.pad_activations(x)
                ops = (hw._packed, hw._scale_t, hw._shift_t, gsp)
                args = (xp, sx, *ops, torch.bfloat16, 4) if int8 else (xp, *ops, 4)
                plain = K_mod.qbits_int8_mm_plain if int8 else K_mod.qbits_mm_plain
                err, cos = check_kernel(f"{name} {model_name} padded M={M} N={N} K={K}", kernel(*args), plain(*args))
                b_ms, b_by = bound(M, N, K, x_bytes=1 if int8 else 2, side_bytes=side + (4 if int8 else 0),
                                   peak_ops=PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS)
                row = dict(
                    name=name, padded=model_name, M=M, N=N, K=K, group_size=gs, Npad=Np, Kpad=Kp, gs_pad=gsp,
                    padded_bytes_ratio=ratio, max_abs_err=err, cosine=cos,
                    ms=time_ms(lambda: kernel(*args), flush), plain_ms=time_ms(lambda: plain(*args), flush),
                    library_ms=time_ms(lambda: torch.matmul(x_lib, w_bf16.t()), flush),
                    pad_ms=time_ms(lambda: hw.pad_activations(x), flush),
                    bound_ms=b_ms, bound_by=b_by,
                )
                row["bound_share"] = b_ms / row["ms"]
                rows.append(row)
                log("kernel " + json.dumps(row))
            del w, hw, w_bf16
            torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def count_dequantize():
    """Count the `dequantize` calls of every quantized weight type while the
    block runs (the routes of phases 17-19 dequantize no weight)."""
    from quanto_tpu_torch.tensor import weights as W

    counter = types.SimpleNamespace(calls=0)
    saved = {c: c.__dict__["dequantize"] for c in (W.WeightQBytesArray, W.WeightQBitsArray, W.WeightQBitsHopperArray)}

    def counted(fn):
        def run(self, *args, **kw):
            counter.calls += 1
            return fn(self, *args, **kw)
        return run

    for c, fn in saved.items():
        c.dequantize = counted(fn)
    try:
        yield counter
    finally:
        for c, fn in saved.items():
            c.dequantize = fn


def check_plain_prefill(tag: str, model, ids, kernel_logits, min_cos=None, top1: bool = True):
    """The prefill (last position, over a cache of T + NEW slots) through the
    plain versions, no kernel launched, against the kernel path's logits
    `kernel_logits` [B, 1, V] (on the host): EQUAL when `min_cos` is None,
    else `check_rows` (without `top1`: each row's cosine alone)."""
    from quanto_tpu_torch.models.serve import make_cache, prefill

    before = read_counts()
    with plain_versions():
        plain_logits, _ = prefill(model, ids, make_cache(model, ids.shape[0], T + NEW), last_only=True)
    torch.cuda.synchronize()
    if read_counts() != before:
        raise RuntimeError(f"{tag}: the plain forward launched a kernel")
    k, p = kernel_logits[:, -1].float(), plain_logits[:, -1].float().cpu()
    if min_cos is None:
        equal = torch.equal(kernel_logits, plain_logits.cpu())
        log(json.dumps({f"{tag}_end_to_end": "prefill", "equal": equal, "max_abs_diff": (k - p).abs().max().item()}))
        if not equal:
            raise RuntimeError(f"{tag}: prefill logits of the route are not EQUAL to the plain formula's")
    elif top1:
        check_rows(tag, "prefill", k, p, min_cos)
    else:
        cos = F.cosine_similarity(k, p, dim=-1)
        log(json.dumps({f"{tag}_end_to_end": "prefill", "cosine": cos.tolist(), "top1_kernel": k.argmax(-1).tolist(),
                        "top1_plain": p.argmax(-1).tolist()}))
        if not bool((cos > min_cos).all()):
            raise RuntimeError(f"{tag} prefill: cosine {cos.tolist()} <= {min_cos}")


@torch.no_grad()
def phase_llama_w8a8(config, ids) -> dict:
    """Phase 17: Llama-3.1-8B in W8A8 at full depth and width, lm_head bf16:
    (a) qint8 weights and activations, (b) qfloat8_e4m3fn ones, each built,
    quantized, calibrated as phase 7 and frozen; phase 6's run (B = 4 x 1024
    prefill, 63 greedy decode steps over a bf16 cache), every forward exactly
    224 W8A8 library calls (`torch._int_mm` / the e4m3fn bf16 product) and each
    step 32 `flash_decode`, no other kernel and no weight dequantized; then
    the prefill through the plain formula: (a) EQUAL, (b) each row's cosine
    above W8A8_FP8_COS, and at 2 layers (as phase 5) above W8A8_FP8_COS_2L
    with the same top-1 token or a tie. Returns each run's launch counts."""
    from quanto_tpu_torch.models.serve import make_cache, prefill

    L = config.num_hidden_layers
    n_lin, steps = LINEARS_PER_LAYER * L, NEW - 1
    runs = {}
    for label, qtype, count in (("int8", "qint8", "qbytes_int_mm"), ("e4m3fn", "qfloat8_e4m3fn", "qbytes_fp8_mm")):
        t0 = time.perf_counter()
        model, _ = build_model(config, seed=0, weights=qtype, activations=qtype, exclude="lm_head")
        torch.cuda.synchronize()
        log(f"w8a8 {label}: built + quantized + calibrated + frozen in {time.perf_counter() - t0:.1f} s")
        record = {}
        with count_dequantize() as deq:
            runs[f"phase 17 ({label})"] = phase_arm(
                f"w8a8 {label}: llama-3.1-8b-config {qtype} weights and activations (lm_head bf16), bf16 cache",
                model, ids, want_prefill={count: n_lin}, want_decode={count: n_lin * steps, "flash_decode": L * steps},
                prefill_peak_ops=PEAK_INT8_OPS, record=record,
            )
        if deq.calls:
            raise RuntimeError(f"w8a8 {label}: the run dequantized a weight {deq.calls} times")
        check_plain_prefill(f"w8a8_{label}", model, ids, record["logits"],
                            None if label == "int8" else W8A8_FP8_COS, top1=False)
        del model, record
        gc.collect()
        torch.cuda.empty_cache()
        if label == "e4m3fn":
            model, _ = build_model(dataclasses.replace(config, num_hidden_layers=2), seed=1, weights=qtype,
                                   activations=qtype, exclude="lm_head")
            logits, _ = prefill(model, ids, make_cache(model, B, T + NEW), last_only=True)
            check_plain_prefill("w8a8_e4m3fn_2_layers", model, ids, logits.cpu(), W8A8_FP8_COS_2L)
            del model, logits
            gc.collect()
            torch.cuda.empty_cache()
    return runs


def small_ids(config, seed: int, batch: int = B, length: int = T) -> torch.Tensor:
    return torch.randint(0, config.vocab_size, (batch, length), generator=torch.Generator().manual_seed(seed)).cuda()


def check_padded(model, label: str, want_padded) -> None:
    """Every quantized linear in the Hopper layout, none generic, and padded
    exactly where `want_padded(name)` says."""
    from quanto_tpu_torch.nn import QLinear
    from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

    bad = [n for n, m in model.named_modules() if isinstance(m, QLinear)
           and (not isinstance(m.weight, WeightQBitsHopperArray) or (m.weight.pad is not None) != want_padded(n))]
    if bad:
        raise RuntimeError(f"{label}: linears out of the expected (padded) Hopper layout: {bad[:5]}")


def hqq_against_max(model) -> dict:
    """Phase 18(a): each float linear of `model` quantized qint4 at its group
    size by `HqqOptimizer()` and by `MaxOptimizer()`: the mean |W - deq(W)| of
    each, HQQ's no larger than Max's for every linear (JAX's
    `test_hqq_beats_max`), and the seconds each optimizer took over all of
    them."""
    import quanto_tpu_torch as qtt
    from quanto_tpu_torch.nn.qmodule import _auto_group_size

    linears = [(n, m) for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)]
    seconds, errors = {}, {}
    for opt_name, opt in (("hqq", qtt.HqqOptimizer()), ("max", qtt.MaxOptimizer())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        found = [opt(m.weight, qtt.qint4, 0, group_size=_auto_group_size(m.in_features)) for _, m in linears]
        torch.cuda.synchronize()
        seconds[opt_name] = time.perf_counter() - t0
        errors[opt_name] = torch.stack([
            (qtt.quantize_weight(m.weight, qtt.qint4, 0, s, shift=z, group_size=_auto_group_size(m.in_features))
             .dequantize().float() - m.weight.float()).abs().mean()
            for (_, m), (s, z) in zip(linears, found)
        ]).cpu()
    worse = [linears[i][0] for i in (errors["hqq"] > errors["max"] + 1e-6).nonzero().flatten().tolist()]
    out = {"hqq_vs_max": "smollm2-360m", "linears": len(linears), "hqq_s": seconds["hqq"], "max_s": seconds["max"],
           "mean_error_hqq": errors["hqq"].mean().item(), "mean_error_max": errors["max"].mean().item(),
           "largest_error_ratio": (errors["hqq"] / errors["max"]).max().item(), "hqq_worse": worse}
    log(json.dumps(out))
    if worse:
        raise RuntimeError(f"HqqOptimizer's error above MaxOptimizer's for {worse[:5]}")
    return out


def phase_qat(config) -> dict:
    """Phase 18(c): QAT of SmolLM2-360M (float32, random weights from a seed):
    `quantize(weights="qint4", activations="qint8")`, `Calibration` over
    CAL_BATCHES x 4 x 128 tokens, `qat` on every QLinear and every parameter
    trained: QAT_STEPS AdamW steps of next-token loss on one seeded batch of
    B x QAT_T tokens, every gradient finite, none on the activation scales,
    the last loss below the first. Then the QAT forward's logits on a held
    batch, `freeze` (every linear in the padded Hopper layout), `qat` off, and
    the frozen model's logits on the same batch through exactly 224
    `qbits_mm_tiled_int8` (M = B x QAT_T = 1024): each row's last-position
    cosine above QAT_FROZEN_COS, top-1 equal or at a logit tie."""
    from quanto_tpu_torch import Calibration, freeze, quantize
    from quanto_tpu_torch.models.llama import LlamaForCausalLM
    from quanto_tpu_torch.nn import QLinear

    config = dataclasses.replace(config, dtype=torch.float32)
    V = config.vocab_size
    model = LlamaForCausalLM(config, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    quantize(model, weights="qint4", activations="qint8")
    with torch.no_grad(), Calibration(model):
        for batch in calibration_batches(config):
            model(batch)
    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    for m in qlinears:
        m.qat = True
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    opt = torch.optim.AdamW(params, lr=QAT_LR)
    batch, held = small_ids(config, 17, length=QAT_T + 1), small_ids(config, 18, length=QAT_T)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(QAT_STEPS):
        logits, _ = model(batch[:, :-1])
        loss = F.cross_entropy(logits.float().reshape(-1, V), batch[:, 1:].reshape(-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        bad = [n for n, p in model.named_parameters() if p.grad is None or not torch.isfinite(p.grad).all()]
        if bad:
            raise RuntimeError(f"qat: gradients missing or not finite: {bad[:5]}")
        if any(b.grad is not None for b in model.buffers()):
            raise RuntimeError("qat: a buffer (activation scale) took a gradient")
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    del opt, logits, loss
    for p in params:
        p.requires_grad_(False)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"qat: the loss did not fall: {losses}")
    with torch.no_grad():
        qat_logits = model(held)[0][:, -1].float().cpu()
    freeze(model)
    for m in qlinears:
        m.qat = False
    check_padded(model, "qat", lambda n: True)
    reset_counts()
    with torch.no_grad():
        frozen_logits = model(held)[0][:, -1].float().cpu()
    torch.cuda.synchronize()
    counts = {n: c for n, c in read_counts().items() if c}
    want = {"qbits_mm_tiled_int8": LINEARS_PER_LAYER * config.num_hidden_layers}
    if counts != want:
        raise RuntimeError(f"qat: the frozen forward launched {counts}, want {want}")
    out = {"qat": "smollm2-360m float32 qint4 + qint8 activations", "steps": QAT_STEPS, "batch": B, "tokens": QAT_T,
           "losses": losses, "train_s": train_s, "frozen_launches": counts}
    log(json.dumps(out))
    check_rows("qat_frozen", "held batch, frozen vs QAT forward", frozen_logits, qat_logits, QAT_FROZEN_COS)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


@torch.no_grad()
def phase_smollm2() -> dict:
    """Phase 18: SmolLM2-360M (its published config.json, SMOLLM2_360M;
    random weights from a seed; every linear off the envelope and padded).
    (a) qint4 with `HqqOptimizer()` (against `MaxOptimizer` per linear,
    `hqq_against_max`), all 224 linears in the padded Hopper layout, phase
    6's run (B = 4 x 1024 prefill through exactly 224 `qbits_mm_tiled`,
    63 decode steps of 224 `qbits_mm_small_m` and 32 `flash_decode` each, no
    weight dequantized) and its prefill through the plain versions (each row
    within SMALL_E2E_COS, top-1 or a tie). (b) Calibrated W4A8 (qint4 + qint8
    activations, as phase 7): the same run through #2's int8 arm and #4, and
    the same check. (c) QAT (`phase_qat`). Returns each run's launch counts."""
    from quanto_tpu_torch import HqqOptimizer
    from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    config = LlamaConfig.from_hf(SMOLLM2_360M, dtype=torch.bfloat16)
    L = config.num_hidden_layers
    n_lin, steps = LINEARS_PER_LAYER * L, NEW - 1
    ids = small_ids(config, 13)
    runs = {}
    float_model = LlamaForCausalLM(config, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    hqq_against_max(float_model)
    del float_model
    t0 = time.perf_counter()
    model, _ = build_model(config, seed=0, optimizer=HqqOptimizer())
    torch.cuda.synchronize()
    log(f"smollm2: built + quantized (HQQ) + frozen in {time.perf_counter() - t0:.1f} s")
    check_padded(model, "smollm2 qint4", lambda n: True)
    record = {}
    with count_dequantize() as deq:
        runs["phase 18 (smollm2-360m qint4, hqq)"] = phase_arm(
            "smollm2-360m qint4 (HqqOptimizer, tied, padded), bf16 cache", model, ids,
            want_prefill={"qbits_mm_tiled": n_lin},
            want_decode={"qbits_mm_small_m": n_lin * steps, "flash_decode": L * steps},
            prefill_peak_ops=PEAK_BF16_FLOPS, record=record,
        )
    if deq.calls:
        raise RuntimeError(f"smollm2 qint4: the run dequantized a weight {deq.calls} times")
    check_plain_prefill("smollm2_qint4", model, ids, record["logits"], SMALL_E2E_COS)
    del model, record
    gc.collect()
    torch.cuda.empty_cache()

    model, _ = build_model(config, seed=0, weights="qint4", activations="qint8")
    check_padded(model, "smollm2 w4a8", lambda n: True)
    record = {}
    with count_dequantize() as deq:
        runs["phase 18 (smollm2-360m w4a8)"] = phase_arm(
            "smollm2-360m w4a8 (calibrated, tied, padded), bf16 cache", model, ids,
            want_prefill={"qbits_mm_tiled_int8": n_lin},
            want_decode={"qbits_mm_int8_small_m": n_lin * steps, "flash_decode": L * steps},
            prefill_peak_ops=PEAK_INT8_OPS, record=record,
        )
    if deq.calls:
        raise RuntimeError(f"smollm2 w4a8: the run dequantized a weight {deq.calls} times")
    check_plain_prefill("smollm2_w4a8", model, ids, record["logits"], SMALL_E2E_COS)
    del model, record
    gc.collect()
    torch.cuda.empty_cache()
    with torch.enable_grad():
        runs["phase 18 (smollm2-360m qat, frozen forward)"] = phase_qat(config)
    return runs


def qwen_biases(model) -> None:
    """Random q/k/v biases (the model's init zeroes them), so that phase 19 runs real ones."""
    g = torch.Generator("cuda").manual_seed(19)
    for layer in model.model.layers:
        for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj):
            proj.bias.normal_(0.0, 0.02, generator=g)


def phase_qwen25() -> dict:
    """Phase 19: Qwen2.5-0.5B (its published config.json, QWEN25_05B: qwen2,
    q/k/v biases, tied; random weights and biases from a seed), qint4: the
    six K = 896 linears of each layer padded (Kpad 1024), `down_proj` on the
    envelope. Through `phase_checkpoint` (phase 16 for this model): phase 6's
    run (B = 4 x 1024 prefill, exactly 168 `qbits_mm_tiled`; 63 decode steps
    of 168 `qbits_mm_small_m` and 24 `flash_decode` each) and the prefill
    through the plain versions, then `save_pretrained` -> `from_pretrained`
    on the card: the loaded model equal to the original in tensors, logits,
    tokens and launch counts. Returns the original's and the loaded run's
    launch counts."""
    from quanto_tpu_torch.models.llama import LlamaConfig

    config = LlamaConfig.from_hf(QWEN25_05B, dtype=torch.bfloat16)
    L = config.num_hidden_layers
    n_lin, steps = LINEARS_PER_LAYER * L, NEW - 1
    ids = small_ids(config, 14)
    label = "qwen2.5-0.5b qint4 (tied, q/k/v biases, K = 896 padded), bf16 cache"
    runs = {}

    def build():
        model, _ = build_model(config, seed=0, init=qwen_biases)
        check_padded(model, "qwen2.5", lambda n: "down_proj" not in n)
        return model

    def run(model, record, when):
        with count_dequantize() as deq:
            counts = phase_arm(
                f"{label} ({when})", model, ids, want_prefill={"qbits_mm_tiled": n_lin},
                want_decode={"qbits_mm_small_m": n_lin * steps, "flash_decode": L * steps},
                prefill_peak_ops=PEAK_BF16_FLOPS, record=record,
            )
        if deq.calls:
            raise RuntimeError(f"qwen2.5 ({when}): the run dequantized a weight {deq.calls} times")
        if when == "original":
            runs["phase 19 (qwen2.5-0.5b qint4)"] = counts
            check_plain_prefill("qwen25_qint4", model, ids, record["logits"], SMALL_E2E_COS)

    runs["phase 19 (qwen2.5-0.5b qint4, loaded)"] = phase_checkpoint(label, build, run)
    return runs


def phases_numerics() -> dict:
    """Phases 17, 18 and 19. Returns {run label: launch counts}."""
    from quanto_tpu_torch.models.llama import LlamaConfig

    config = LlamaConfig(**LLAMA31_8B, dtype=torch.bfloat16)
    ids = torch.randint(
        0, LLAMA31_8B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(7)
    ).cuda()
    runs = {}
    for phase, fn in (("17", lambda: phase_llama_w8a8(config, ids)), ("18", phase_smollm2), ("19", phase_qwen25)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        runs.update(fn())
        log(f"numerics: phase {phase} took {time.perf_counter() - t0:.1f} s")
    return runs


def numerics_rows(K_mod, flush) -> list:
    """Phase 3's rows of this slice: the W8A8 route, the padded kernels and
    `flash_decode` at the small models' heads."""
    rows = phase_w8a8(flush) + phase_padded(K_mod, flush)
    for heads in FD_NEW_HEADS:
        rows += phase_flash_decode(flush, heads=heads)
    return rows


def only_numerics(K_mod, card: str) -> int:
    """`--only numerics`: phase 3's rows of this slice (`numerics_rows`) and
    phases 17-19."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    numerics_rows(K_mod, flush)
    del flush
    torch.cuda.empty_cache()
    phases_numerics()
    log(card)
    log(json.dumps({"ok": True, "only": "numerics", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def only_checkpoint(card: str) -> int:
    """`--only checkpoint`: phase 16 alone (after phases 1-2)."""
    ids = torch.randint(
        0, LLAMA31_8B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(7)
    ).cuda()
    mixtral_ids = torch.randint(
        0, MIXTRAL_8X7B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(9)
    ).cuda()
    phase_checkpoints(ids, mixtral_ids)
    log(card)
    log(json.dumps({"ok": True, "only": "checkpoint", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def only_sweep_and_serving(K_mod, card: str) -> int:
    """`--only sweep,serving`: phase 3's small-M sweep and phase 15 on both of
    its models, built as phases 4 and 7 build them; for timing a tree's
    small-M kernels against another's."""
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.serve import generate

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    phase_small_m_sweep(K_mod, flush)
    del flush
    config = LlamaConfig(**LLAMA31_8B, dtype=torch.bfloat16)
    warm = torch.randint(0, config.vocab_size, (1, 64), generator=torch.Generator().manual_seed(3)).cuda()
    for kw, kernel, label in [
        (dict(), "qbits_mm_small_m", "llama-3.1-8b-config qint4+head4, bf16 cache"),
        (dict(weights="qint4", activations="qint8", exclude="lm_head"), "qbits_mm_int8_small_m",
         "llama-3.1-8b-config w4a8 (calibrated, exact form), lm_head bf16, bf16 cache"),
    ]:
        model, _ = build_model(config, seed=0, **kw)
        generate(model, warm, 4)  # warm-up, as phases 4 and 7 warm the full run's phase 15
        phase_serving(label, model, kernel)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    log(card)
    log(json.dumps({"ok": True, "only": "sweep,serving", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def only_prefill(K_mod, card: str) -> int:
    """`--only prefill`: the prefill paths of TPU #2, #3 and #14, for timing a
    tree's kernels against another's. Phase 3's #2 rows (both arms, both
    widths), requant and MoE rows (and the W4A8 and `flash_decode` rows phase
    10 reads); phase 4's qint4 prefill (B = 4 x 1024, no decode); phase 7's
    exact-form W4A8 prefill, then phase 10 on that model frozen into the
    requant form; phases 8 and 12 (B = 4, then 1); phase 11's B = 1 prefill;
    phase 13 (a, b). The 2-layer checks of phases 5, 9, 11, 12 and 13 are left
    to the full run."""
    from quanto_tpu_torch import freeze
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.mixtral import MixtralConfig
    from quanto_tpu_torch.models.serve import generate

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    tiled = {"qbits_mm_tiled"}
    rows = (phase_kernels(K_mod, flush, names=tiled) + phase_kernels(K_mod, flush, bits=2, names=tiled)
            + phase_w4a8(K_mod, flush) + phase_w4a8(K_mod, flush, bits=2, names={"qbits_mm_tiled_int8"})
            + phase_flash_decode(flush) + phase_requant(K_mod, flush)
            + phase_requant(K_mod, flush, bits=2) + phase_moe(flush) + phase_moe(flush, bits=2))
    del flush
    torch.cuda.empty_cache()
    ids = torch.randint(
        0, LLAMA31_8B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(7)
    ).cuda()
    config = LlamaConfig(**LLAMA31_8B, dtype=torch.bfloat16)
    n_lin = LINEARS_PER_LAYER * config.num_hidden_layers
    model, _ = build_model(config, seed=0)
    phase_prefill("qint4", "llama-3.1-8b-config qint4+head4, B = 4 x 1024 tokens, bf16 cache (phase 4)", model, ids,
                  want={"qbits_mm_tiled": n_lin, "qbits_mm_small_m": 1}, peak_ops=PEAK_BF16_FLOPS)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model, _ = build_model(config, seed=0, weights="qint4", activations="qint8", exclude="lm_head")
    phase_prefill("w4a8", "llama-3.1-8b-config w4a8 (calibrated, exact form), B = 4 x 1024 tokens, bf16 cache "
                  "(phase 7)", model, ids, want={"qbits_mm_tiled_int8": n_lin}, peak_ops=PEAK_INT8_OPS)
    freeze(model, w4a8_requant_dot=True)
    generate(model, ids, 2)  # warm-up: one M = 4096 prefill through the requant route
    phase_engine(model, rows)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_config = MixtralConfig(**MIXTRAL_8X7B, dtype=torch.bfloat16)
    mixtral_ids = torch.randint(
        0, MIXTRAL_8X7B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(9)
    ).cuda()
    for experts, bits in (("qint4", 4), ("qint2", 2)):
        model = build_mixtral(mixtral_config, seed=0, experts=experts)
        phase_mixtral(model, mixtral_ids, expert_bits=bits)
        phase_mixtral(model, mixtral_ids[:1], expert_bits=bits)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    model, _ = build_model(config, seed=0, weights="qint2", exclude="lm_head")
    phase_prefill("int2", "llama-3.1-8b-config qint2 (lm_head bf16), B = 1 x 1024 tokens, bf16 cache (phase 11)",
                  model, ids[:1], want={"qbits_mm_tiled": n_lin, "qbits_mm_tiled_int2": n_lin},
                  peak_ops=PEAK_BF16_FLOPS)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    phase_llama_w2a8(config, ids)
    log(card)
    log(json.dumps({"ok": True, "only": "prefill", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def only_qbytes_and_moe(K_mod, card: str) -> int:
    """`--only qbytes,moe`: the paths of TPU #6/#7 and #11-#13, for timing a
    tree's kernels against another's. Phase 3's 8-bit weight-only sweep and
    MoE rows (int4 and int2); phase 6's int8 run (B = 4 x 1024 prefill, 63
    decode steps) and phase 15's serial arm on that model; phase 8's Mixtral
    runs at B = 4 and B = 16 (the all-experts route, TPU #12). The 2-layer
    checks are left to the full run."""
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.mixtral import MixtralConfig

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    phase_qbytes(flush)
    phase_moe(flush)
    phase_moe(flush, bits=2)
    del flush
    torch.cuda.empty_cache()
    ids = torch.randint(
        0, LLAMA31_8B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(7)
    ).cuda()
    config = LlamaConfig(**LLAMA31_8B, dtype=torch.bfloat16)
    n_lin, steps = LINEARS_PER_LAYER * config.num_hidden_layers, NEW - 1
    model, _ = build_model(config, seed=0, weights="qint8", exclude="lm_head")
    phase_arm("int8: llama-3.1-8b-config qint8 (lm_head bf16), bf16 cache", model, ids, want_prefill={},
              want_decode={"qbytes_mm_int8": n_lin * steps, "flash_decode": config.num_hidden_layers * steps})
    phase_serving_int8(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_config = MixtralConfig(**MIXTRAL_8X7B, dtype=torch.bfloat16)
    mixtral_ids = torch.randint(
        0, MIXTRAL_8X7B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(9)
    ).cuda()
    mixtral_ids16 = torch.randint(
        0, MIXTRAL_8X7B["vocab_size"], (B16, T16), generator=torch.Generator().manual_seed(10)
    ).cuda()
    model = build_mixtral(mixtral_config, seed=0)
    phase_mixtral(model, mixtral_ids)
    phase_mixtral(model, mixtral_ids16, new=NEW16)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(card)
    log(json.dumps({"ok": True, "only": "qbytes,moe", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def only_decode(K_mod, FD_mod, card: str) -> int:
    """`--only decode`: the decode paths of TPU #8-#10 (`flash_decode`) and #15
    (`qbits_moe_tiled` at M <= 16), for timing a tree's kernels against
    another's. Phase 3's `flash_decode` rows and `qbits_moe_tiled` rows at M <=
    16 (int4 and int2), and the W4A8 small-M rows phase 10 reads; phase 4's
    qint4 run at ctx 1088 (prefill, 63 decode steps) and phase 4b's at ctx
    8192 on the same model; phase 10 on phase 7's model frozen into the
    requant form; phase 8 at B = 4 and B = 16. Exact launch counts throughout;
    the 2-layer checks are left to the full run."""
    from quanto_tpu_torch import freeze
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.mixtral import MixtralConfig
    from quanto_tpu_torch.models.serve import generate

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    rows = (phase_flash_decode(flush) + phase_moe(flush, decode_tiled=True) + phase_moe(flush, bits=2, decode_tiled=True)
            + phase_w4a8(K_mod, flush, names={"qbits_mm_int8_small_m"}))
    del flush
    torch.cuda.empty_cache()
    ids = torch.randint(
        0, LLAMA31_8B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(7)
    ).cuda()
    config = LlamaConfig(**LLAMA31_8B, dtype=torch.bfloat16)
    L = config.num_hidden_layers
    n_lin, steps = LINEARS_PER_LAYER * L, NEW - 1
    model, qlinears = build_model(config, seed=0)
    phase_arm("qint4: llama-3.1-8b-config qint4+head4, bf16 cache (phase 4)", model, ids,
              want_prefill={"qbits_mm_tiled": n_lin, "qbits_mm_small_m": 1},
              want_decode={"qbits_mm_small_m": (n_lin + 1) * steps, "flash_decode": L * steps})
    phase_long_context(K_mod, FD_mod, model, qlinears)
    del model, qlinears
    gc.collect()
    torch.cuda.empty_cache()
    model, _ = build_model(config, seed=0, weights="qint4", activations="qint8", exclude="lm_head")
    freeze(model, w4a8_requant_dot=True)
    generate(model, ids, 2)  # warm-up: one M = 4096 prefill through the requant route
    phase_engine(model, rows)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_config = MixtralConfig(**MIXTRAL_8X7B, dtype=torch.bfloat16)
    mixtral_ids = torch.randint(
        0, MIXTRAL_8X7B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(9)
    ).cuda()
    mixtral_ids16 = torch.randint(
        0, MIXTRAL_8X7B["vocab_size"], (B16, T16), generator=torch.Generator().manual_seed(10)
    ).cuda()
    model = build_mixtral(mixtral_config, seed=0)
    phase_mixtral(model, mixtral_ids)
    phase_mixtral(model, mixtral_ids16, new=NEW16)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(card)
    log(json.dumps({"ok": True, "only": "decode", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def only_paged(card: str) -> int:
    """`--only paged`: phase 3's rows of the paged arm, then phase 20 on phase
    4's model (which also runs phase 15's serial arm, its reference)."""
    from quanto_tpu_torch.models.llama import LlamaConfig

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    phase_flash_decode_paged(flush)
    del flush
    torch.cuda.empty_cache()
    config = LlamaConfig(**LLAMA31_8B, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model, _ = build_model(config, seed=0)
    torch.cuda.synchronize()
    log(f"paged: phase 4's model built in {time.perf_counter() - t0:.1f} s")
    phase_paged(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(card)
    log(json.dumps({"ok": True, "only": "paged", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def main() -> int:
    # Phase 1: device.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else None
    if only not in (None, "sweep,serving", "prefill", "qbytes,moe", "decode", "checkpoint", "numerics", "paged"):
        print(f"chip_smoke: --only takes sweep,serving, prefill, qbytes,moe, decode, checkpoint, numerics or "
              f"paged, got {only}", file=sys.stderr)
        return 2
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
    if only == "prefill":
        return only_prefill(K_mod, card)
    if only == "qbytes,moe":
        return only_qbytes_and_moe(K_mod, card)
    if only == "decode":
        return only_decode(K_mod, FD_mod, card)
    if only == "checkpoint":
        return only_checkpoint(card)
    if only == "numerics":
        return only_numerics(K_mod, card)
    if only == "paged":
        return only_paged(card)
    if only:
        return only_sweep_and_serving(K_mod, card)

    # Phase 3: kernels vs plain.
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    rows = (phase_kernels(K_mod, flush) + phase_small_m_sweep(K_mod, flush) + phase_flash_decode(flush)
            + phase_flash_decode_paged(flush) + phase_qbytes(flush)
            + phase_w4a8(K_mod, flush) + phase_requant(K_mod, flush) + phase_moe(flush)
            + phase_kernels(K_mod, flush, bits=2) + phase_moe(flush, bits=2)
            + phase_w4a8(K_mod, flush, bits=2) + phase_requant(K_mod, flush, bits=2) + phase_partitioned(flush)
            + numerics_rows(K_mod, flush))
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
    launches_1088, phase4_reference = phase_main_path(K_mod, FD_mod, model, qlinears, ids)
    launches = phase_long_context(K_mod, FD_mod, model, qlinears)
    # Phase 15 on this model: the serving bench's default slice, its chunks through #1.
    serve_tokens = {}
    serving = {"qbits_mm_small_m": phase_serving(
        "llama-3.1-8b-config qint4+head4, bf16 cache", model, "qbits_mm_small_m", tokens=serve_tokens)}
    # Phase 20 on this model: PagedEngine over the same requests, held to phase 15's serial arm.
    launches_paged = phase_paged(model, serve_tokens["serial"])
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
    # Phase 15 on this model: the int8 engine, its [1, 64] chunks and 8-row decode steps through #6.
    serving["qbytes_mm_int8"] = phase_serving_int8(model)
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
    # Phase 15 on this model in the exact form (before phase 10 freezes it again): its chunks
    # through #4.
    serving["qbits_mm_int8_small_m"] = phase_serving(
        "llama-3.1-8b-config w4a8 (calibrated, exact form), lm_head bf16, bf16 cache", model,
        "qbits_mm_int8_small_m")

    # Phase 10: the serving engine, on phase 7's model frozen again into the requant form.
    from quanto_tpu_torch import WeightQBitsRequantArray, freeze
    from quanto_tpu_torch.nn import QLinear

    freeze(model, w4a8_requant_dot=True)
    if not all(isinstance(m.weight, WeightQBitsRequantArray) for m in model.modules() if isinstance(m, QLinear)):
        raise RuntimeError("freeze(w4a8_requant_dot=True) left a linear outside the requant form")
    t0 = time.perf_counter()
    launches_engine = phase_engine(model, rows)
    log(f"engine: phase 10 took {time.perf_counter() - t0:.1f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 8: Mixtral-8x7B at B = 4, then B = 1, on one model; phase 9 at 2 layers.
    from quanto_tpu_torch.models.mixtral import MixtralConfig

    mixtral_config = MixtralConfig(**MIXTRAL_8X7B, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = build_mixtral(mixtral_config, seed=0)
    torch.cuda.synchronize()
    log(f"mixtral: built on meta, then {mixtral_config.num_hidden_layers} layers materialized + quantized + "
        f"frozen + stacked one at a time in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    mixtral_ids = torch.randint(
        0, MIXTRAL_8X7B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(9)
    ).cuda()
    mixtral_ids16 = torch.randint(
        0, MIXTRAL_8X7B["vocab_size"], (B16, T16), generator=torch.Generator().manual_seed(10)
    ).cuda()
    launches_moe = phase_mixtral(model, mixtral_ids)
    launches_moe_b1 = phase_mixtral(model, mixtral_ids[:1])
    launches_moe_b16 = phase_mixtral(model, mixtral_ids16, new=NEW16)
    split_mixtral_prefill(model, mixtral_ids16)
    check_no_sync(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for seed in MIXTRAL_E2E_SEEDS:
        phase_mixtral_end_to_end(mixtral_ids, mixtral_ids16, seed)

    # Phase 11: Llama-3.1-8B in qint2, and its 2-layer check.
    launches_int2_decode, launches_int2_prefill = phase_llama_int2(config, ids)
    phase_llama_int2_end_to_end(ids)

    # Phase 12: Mixtral-8x7B with qint2 experts (attention qint4) at B = 4, then B = 1; its
    # 2-layer check.
    t0 = time.perf_counter()
    model = build_mixtral(mixtral_config, seed=0, experts="qint2")
    torch.cuda.synchronize()
    log(f"mixtral int2: built on meta, then {mixtral_config.num_hidden_layers} layers materialized + "
        f"quantized + frozen + stacked one at a time in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    launches_moe_int2 = phase_mixtral(model, mixtral_ids, expert_bits=2)
    launches_moe_int2_b1 = phase_mixtral(model, mixtral_ids[:1], expert_bits=2)
    check_no_sync(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    phase_mixtral_end_to_end(mixtral_ids, mixtral_ids16, MIXTRAL_E2E_SEEDS[0], experts="qint2")

    # Phase 13: Llama-3.1-8B in W2A8, exact and requant forms, and its 2-layer check.
    t0 = time.perf_counter()
    launches_w2a8 = phase_llama_w2a8(config, ids)
    phase_w2a8_end_to_end(ids)
    log(f"w2a8: phase 13 took {time.perf_counter() - t0:.1f} s")

    # Phase 14: tensor parallelism, 2 ranks sharing the card over gloo.
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp = phase_tp(*phase4_reference)
    log(f"tp: phase 14 took {time.perf_counter() - t0:.1f} s ({TP_LABEL})")

    # Phase 16: checkpoints, save -> free -> load -> each model's run again.
    gc.collect()
    torch.cuda.empty_cache()
    checkpoints = phase_checkpoints(ids, mixtral_ids)

    # Phases 17-19: W8A8 Llama-3.1-8B, SmolLM2-360M (HQQ, W4A8, QAT; padded), Qwen2.5-0.5B.
    numerics = phases_numerics()

    # Where each kernel's `launches` in the summary comes from: the long-context run for the
    # int4 and flash-decode kernels, the phase-6/7 runs for the 8-bit and W4A8 kernels, phase
    # 8's B = 4 run for the MoE kernels; e4m3fn runs in phase 5 only.
    launch_runs = {
        "qbytes_mm_int8": ("phase 6 (int8)", launches_int8),
        "qbytes_mm_e4m3fn": ("phase 5 (qfloat8, 2 layers)", arm_counts["qfloat8"]),
        "qbits_mm_int8_small_m": ("phase 7 (w4a8)", launches_w4a8),
        "qbits_mm_tiled_int8": ("phase 7 (w4a8)", launches_w4a8),
        "qbits_mm_requant_int8": ("phase 10 (serving engine, batch arm)", launches_engine["batch"]),
        "qbits_moe_small_m": ("phase 8 (mixtral-8x7b, B = 4)", launches_moe),
        "qbits_moe_tiled": ("phase 8 (mixtral-8x7b, B = 4)", launches_moe),
        "qbits_moe_tiled_small_m": ("phase 8 (mixtral-8x7b, B = 4)", launches_moe),
        "qbits_moe_all": ("phase 8 (mixtral-8x7b, B = 16)", launches_moe_b16),
        "qbits_mm_small_m_int2": ("phase 11 (llama-3.1-8b qint2, decode run)", launches_int2_decode),
        "qbits_mm_tiled_int2": ("phase 11 (llama-3.1-8b qint2, B = 1 prefill)", launches_int2_prefill),
        "qbits_moe_small_m_int2": ("phase 12 (mixtral-8x7b qint2 experts, B = 4)", launches_moe_int2),
        "qbits_moe_tiled_int2": ("phase 12 (mixtral-8x7b qint2 experts, B = 4)", launches_moe_int2),
        "qbits_moe_tiled_small_m_int2": ("phase 12 (mixtral-8x7b qint2 experts, B = 4)", launches_moe_int2),
        "qbits_mm_int8_small_m_int2": ("phase 13 (llama-3.1-8b w2a8, decode run)", launches_w2a8["decode"]),
        "qbits_mm_tiled_int8_int2": ("phase 13 (llama-3.1-8b w2a8, B = 1 prefill)", launches_w2a8["b1_prefill"]),
        "qbits_mm_requant_int8_int2": ("phase 13 (llama-3.1-8b w2a8, requant form)", launches_w2a8["requant"]),
        "qbits_mm_partitioned": ("phase 14 (llama-3.1-8b qint4, tp = 2, rank 0)", tp["full"]["counts"]),
        "flash_decode_paged": ("phase 20(b) (PagedEngine, bf16 pages of 64)", launches_paged["b"]),
    }
    kernels = []
    for name in [*KERNEL_M, "flash_decode", "flash_decode_paged", *QBYTES_M, *W4A8_M, "qbits_mm_requant_int8",
                 "qbits_moe_small_m",
                 "qbits_moe_all", "qbits_moe_tiled", "qbits_moe_tiled_small_m", *(f"{arm}_int2" for arm in INT2_ARMS),
                 "qbits_mm_partitioned"]:
        mine = [r for r in rows if r["name"] == name]
        if name == "qbits_moe_all":  # `qbits_moe_small_m`'s rows in TPU #12's form
            mine = [r for r in rows if r["name"] == "qbits_moe_small_m" and r["form"] == "all" and r["U"] == 8
                    and r["nslots"] is None]
        if name.startswith("qbits_moe_tiled_small_m"):  # `qbits_moe_tiled`'s rows at M <= 16: TPU #15
            mine = [r for r in rows if r["name"] == name.replace("_small_m", "") and r["M"] <= 16]
        if name == "flash_decode":
            rep = next(r for r in mine if (r["cache"], r["S"], r["q"], r["Hkv"]) == (*FD_SUMMARY, "bf16", FD_HEADS[0]))
            shape = dict(cache=FD_SUMMARY[0], B=B, S=FD_SUMMARY[1], Hkv=FD_HEADS[0], G=FD_HEADS[1], D=FD_HEADS[2])
        elif name == "flash_decode_paged":
            rep = next(r for r in mine if (r["cache"], r["S"], r["page_size"], r["q"]) == (*FD_PAGED_SUMMARY, "bf16"))
            shape = dict(cache=rep["cache"], B=rep["B"], S=rep["S"], page_size=rep["page_size"], Hkv=FD_HEADS[0],
                         G=FD_HEADS[1], D=FD_HEADS[2])
        elif name.startswith("qbits_moe"):
            rep = next(r for r in mine if (r["form"], r["nslots"], r["M"], r["N"], r["K"]) == SUMMARY_SHAPE[name])
            shape = dict(form=rep["form"], U=rep["U"], nslots=rep["nslots"], M=rep["M"], N=rep["N"], K=rep["K"])
        else:
            rep = next(r for r in mine if (r["M"], r["N"], r["K"]) == SUMMARY_SHAPE[name])
            shape = list(SUMMARY_SHAPE[name])
        run, counts = launch_runs.get(name, ("phase 4b (ctx 8192)", launches))
        extra = {} if name in launch_runs else {"launches_ctx1088": launches_1088[name]}
        if name.startswith("qbits_moe") and name != "qbits_moe_all":
            extra = {"launches_b1": (launches_moe_int2_b1 if name.endswith("_int2") else launches_moe_b1)[name]}
            if not name.endswith("_int2"):
                extra["launches_b16"] = launches_moe_b16[name]
        if name == "qbits_mm_requant_int8":
            extra = {"launches_stream": launches_engine["stream"][name], "tiled_int8_ms": rep["tiled_int8_ms"],
                     "pass_ms": rep["pass_ms"]}
        if name == "qbits_mm_requant_int8_int2":
            extra = {"exact_ms": rep["exact_ms"], "pass_ms": rep["pass_ms"]}
        if name.startswith("qbits_mm_tiled"):
            extra["bound_share"] = rep["bound_share"]
        if name.startswith("qbits_mm_tiled_int8"):
            extra["int_mm_ms"] = rep["int_mm_ms"]
        if name in serving:
            extra["launches_phase15"] = {arm: c[name] for arm, c in serving[name].items()}
        phase16 = {label: c[name] for label, c in checkpoints.items() if c.get(name)}
        if phase16:
            extra["launches_phase16"] = phase16
        phases17_19 = {label: c[name] for label, c in numerics.items() if c.get(name)}
        if phases17_19:
            extra["launches_phases_17_19"] = phases17_19
        if name == "flash_decode_paged":
            extra = {"launches_phase20c": launches_paged["c"][name], "dense_ms": rep["dense_ms"],
                     "gather_dense_ms": rep["gather_dense_ms"]}
        if name == "qbits_mm_partitioned":  # ms: the rank-local product; the row shard's all_reduce beside it
            extra = {"all_reduce_ms": {k: v / 1e3 for k, v in tp["all_reduce_us"].items()}, "note": TP_LABEL}
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
