#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card
    python3 chip_smoke.py --only sweep,serving   # phases 1-2, phase 3's small-M sweep and
                                                 # phase 15 alone (a tree's kernels, A/B)
    python3 chip_smoke.py --only prefill         # phases 1-2, phase 3's tiled, requant, MoE and
                                                 # flash_prefill rows, the prefills of phases 4
                                                 # and 7, phases 10, 8, 12, phase 11's B = 1
                                                 # prefill, phase 13 (a tree's kernels, A/B)
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
    python3 chip_smoke.py --only speculative     # phases 1-2 and 21 (speculative decoding)
    python3 chip_smoke.py --only gemma           # phases 1-2, phase 3's flash_prefill and D = 256
                                                 # flash_decode rows, phase 22 (Gemma-7B)
    python3 chip_smoke.py --only gemma2          # phases 1-2, phase 3's Gemma-2 rows, phase 23
    python3 chip_smoke.py --only gemma3          # phases 1-2, phase 3's Gemma-3 rows, phase 24
    python3 chip_smoke.py --only qwen3           # phases 1-2, phase 3's Qwen3-30B-A3B rows (its
                                                 # heads and 128 experts), phase 25

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
   qint4 caches of 8192 slots, and bf16 caches of phase 21's lengths (1094 and
   1354 slots) with rows at ragged positions; yardstick `scaled_dot_product_attention` (GQA,
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
   16, 20, 32, 64, 128, 256}) and the W4A8 kernels (int8 small-M at M in {4, 512}, int8 tiled at M in
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
   codes over random packed bytes, at M in {1, 4, 8, 16, 20, 32, 64, 128,
   256, 512} on 14336 x 4096 and 4096 x 14336, at M in {1, 4, 20} on the
   lm_head (128256 x 4096) and at M = 20 on 4096 x 4096 and 1024 x 4096 (20:
   phase 21's verify), with phase 3's check; yardstick `torch.matmul` on the
   bf16 operands. The 8-bit weight-only kernel (TPU #6/#7) is swept the same
   way: both payloads at M in {1, 4, 8, 16, 20, 32, 64, 128, 256} on the four
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
   model, phase 6's qint8 quantization and Mixtral-8x7B qint4
   (lm_head bf16, per-expert modules) at full width and CKPT_LAYERS layers,
   each built anew: `QuantizedModelForCausalLM(model).save_pretrained` into a
   `tempfile.mkdtemp()` (its free space printed; under twice the model's
   bytes raises) in shards of CKPT_SHARD_SIZE (several shards and their
   index, or it raises), fsync'd and dropped from the page cache; the run of the
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

21. speculative decoding (`models/speculative.py`; run last) on phase 4's prompts, 64 new
   tokens, k = 4 drafts a round, at full width and SPEC_LAYERS = 8 of Llama-3.1-8B's layers: (a) the JAX package's speculative bench recipe with `--target
   qint8`, built one after the other: a qint8 target (phase 6's recipe) and a qint4 draft of the
   same float weights (phase 4's recipe, lm_head qint4); greedy `SpeculativeGenerator.generate`
   with tokens EQUAL to the target's own `generate` (phase 6's run, timed) or a recorded tie
   within SERVE_TOP1_GAP where a row parts. (c) the same pair by rejection sampling at
   temperature 0.8, top-k 50, top-p 0.95 from a seeded generator (shape, ids, acceptance), and
   `serve.decode` with that sampler on the target for 16 tokens: equal tokens from equal seeds.
   (b) `layerskip_draft` of the qint4 model's first 2 layers (< 1 MB added on the card, its
   weights the target's by data_ptr), greedy against the qint4 model's own `generate`. (d) the
   qint8 target drafting for itself: acceptance >= 0.9, so rounds accept in full (the bonus token
   and the draft's write at pos + k run at full width). Every greedy output is also held, token by
   token, to one prefill of its target over it: the argmax or a tie within SERVE_TOP1_GAP, at
   most SPEC_FORCED_TIES ties a row. For each, one call of R = 13 rounds from prefilled caches
   is timed, and run again under
   `torch.cuda.set_sync_debug_mode("error")` with exact launches (a: (k+1) x 225
   `qbits_mm_small_m` and (k+1) x 32 `flash_decode` for the draft, 224 `qbytes_mm_int8` and no
   `flash_decode` for the verify, a round; b: (k+1) x 57 + 225 `qbits_mm_small_m`, (k+1) x 8
   `flash_decode`; d: (k+2) x 224 `qbytes_mm_int8`, (k+1) x 32 `flash_decode`) and the M of
   every quantized linear's call (the draft's at B = 4, the verify's at B (k+1) = 20; phase 3
   checks #1 and #6 at M = 20 and `flash_decode` over phase 21's caches). Prints acceptance,
   tokens and ms per round, where a round's time goes (draft steps, the verify, its float32
   attention chain), spec tok/s beside the target's own decode tok/s, and peak memory.

`--only prefill` runs phases 1-2 and the prefill paths of TPU #2, #3, #14 and
#16 alone: phase 3's #2 rows (both arms, both widths), requant, MoE and
`flash_prefill` rows (and the W4A8 and `flash_decode` rows phase 10 reads);
phase 4's qint4 prefill (B = 4 x 1024, no decode) and phase 7's exact-form W4A8 prefill, each timed
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
15's serial arm as its reference). `--only speculative` runs phases 1-2 and 21.
`--only gemma` runs phases 1-2, phase 3's `flash_prefill` rows and `flash_decode`
rows at D = 256, and phase 22.

3 (prefill). `flash_prefill` (TPU #16, the causal prefill over the raw K/V that
every prefill from position 0 inside JAX's envelope takes: phases 4-8, 11-17,
21 and 22 at T = 1024, phase 8 at 16 x 256; a cache-less T > 1 forward too)
against its plain version at B = 4, T = 1024: Llama-3.1-8B's heads (8 x 4 of
128), Gemma-7B's (16 x 1 of 256) and Gemma-2B's (1 x 8 of 256) in bf16, a
softcap of 50 at Gemma-7B's, float32 at Llama's (FP_ROWS), within FP_BF16_ERR
and FP_BF16_COS (bf16) or FP_F32_ERR; timed beside its bound (2 B H T^2 D at
989 TFLOP/s), its plain version and `scaled_dot_product_attention(is_causal=
True)`, the yardstick. `flash_decode` at Gemma-7B's heads (16 x 1 of 256) over
every cache type of phase 22's 1088 slots, and its paged arm over bf16 and
qint4 pages of 64 (768 slots a row), as the D = 128 rows. Every phase's exact
prefill counts include `flash_prefill`'s, one a layer (`prefill_attention_want`).
22. Gemma-7B (google/gemma-7b config.json through `LlamaConfig.from_hf`: 28
   layers, hidden 3072, 16 heads and 16 kv heads of 256, intermediate 24576,
   vocab 256000, tied embeddings scaled by sqrt(3072), the unit-offset RMSNorm,
   the tanh GELU, rope theta 10000) at full width and 4 of its 28 layers
   (GEMMA_7B_LAYERS), random weights from a seed, built on "meta" and
   quantized to qint4 (group size 128) a layer at a time; the tied embedding
   (the head) bf16. B = 4 x 1024 prompts: prefill and 63 greedy decode steps
   over a bf16 cache, then over a qint4 cache, each after a warm-up, with
   exact launches (7 `qbits_mm_tiled` and one `flash_prefill` a layer and
   prefill; 7 `qbits_mm_small_m` and one `flash_decode` at D = 256 a layer
   and step); the same model through the plain versions: prefill
   logits within GEMMA_E2E_COS, tokens equal or parting at a logit tie within
   SERVE_TOP1_GAP. Prints prefill ms, decode ms/step and peak memory beside
   their bounds. Runs before phase 21.
23. Gemma-2-9B (`phase_gemma2`): softcaps, windows, ring caches, the engines'
   `write_len` and the paged+ring hybrid, with exact launches and a tally of
   ring and windowed attention calls.
24. Gemma-3-12B (`phase_gemma3`; google/gemma-3-12b-pt's nested config through
   `build_model`): q/k norms, the dual rope, 1024-slot rings on 40 of 48
   layers at B = 4 x 1024 + 64, the same prompts over flat caches, and both
   engines past the window, against the plain versions and `generate`.
25. Qwen3-30B-A3B (`phase_qwen3`: 128 experts, top-8, built and stacked a
   layer at a time) at B = 4 x 1024 (the selective decode route, TPU #11) and
   at 16 x 256 (the unique-expert route, #13 and #15), each with its routing
   held to the plain path's by the phase 9 rule at top-8 and its tokens equal
   or at a recorded tie (past SERVE_TOP1_GAP only behind a routing tie), and
   Qwen3-8B at 8 layers. Runs before phase 21, after phase 24.

The second-to-last line is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

import collections
import contextlib
import copy
import ctypes
import dataclasses
import functools
import gc
import json
import mmap
import os
import re
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
    "flash_decode": "quanto_tpu_torch/csrc/flash_decode.cu (entries; the tensor-core arm flash_decode_tc.cuh, "
                    "built per head dim by flash_decode_tc{64,128,256}.cu; the CUDA-core arm flash_decode_cc.cu)",
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
# The 8-bit weight-only kernel (TPU #6/#7): every M it takes, both payloads (phase 3's sweep); M = 20
# is phase 21's verify, B (SPEC_K + 1), a partial M tile.
QBYTES_SWEEP_M = (1, 4, 8, 16, 20, 32, 64, 128, 256)
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
# M they take, at both code widths: the gate/up and down shapes at SWEEP_M, the lm_head at M = 1, 4,
# and every linear shape at M = 20, phase 21's verify (B (SPEC_K + 1), a partial M tile).
SWEEP_M = (1, 4, 8, 16, 20, 32, 64, 128, 256, 512)
SWEEP_SHAPES = [((14336, 4096), SWEEP_M), ((4096, 14336), SWEEP_M), ((128256, 4096), (1, 4, 20)),
                ((4096, 4096), (20,)), ((1024, 4096), (20,))]
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
# TPU #16, `flash_prefill` (phase 3): the causal prefill over the raw K/V at B = 4, T = 1024, per
# model heads (Hkv, G, D); the softcap row at Gemma-7B's heads, the float32 row at Llama-3.1-8B's.
FP_HEADS = {"llama-3.1-8b": (8, 4, 128), "gemma-7b": (16, 1, 256), "gemma-2b": (1, 8, 256),
            "gemma-2-9b": (8, 2, 256), "gemma-3-12b": (8, 2, 256), "qwen3-30b-a3b": (4, 8, 128)}
FP_ROWS = [("llama-3.1-8b", None, torch.bfloat16), ("gemma-7b", None, torch.bfloat16),
           ("gemma-2b", None, torch.bfloat16), ("gemma-7b", 50.0, torch.bfloat16), ("llama-3.1-8b", None, torch.float32),
           ("gemma-2-9b", 50.0, torch.bfloat16), ("gemma-3-12b", None, torch.bfloat16),
           ("qwen3-30b-a3b", None, torch.bfloat16)]
SOURCE["flash_prefill"] = "quanto_tpu_torch/csrc/flash_prefill.cu"
REPLACES["flash_prefill"] = ("quanto_tpu/ops/attention.py:206 (try_flash_prefill: JAX's splash-attention MQA "
                             "kernel, :237-265)")
# Limits of `flash_prefill` against its plain version: bf16 within one bf16 step at max|ref|
# (2^-7 * max|ref| bounds that step) and cosine > 1 - 1e-5 (exact bf16 products, float32 sums in
# another order, P as a 16-bit hi + lo pair: an output rounds to a neighbouring bf16 value at
# most); float32 within 1e-4 * max|ref| (each operand a bf16 hi + lo pair, about 16 bits). Read
# on every bf16 row here: 0.0078125 (a neighbour of a value in [1, 2)) at max|ref| 3.8-4.6,
# cosine 1 - 1.2e-7 or closer, with the wgmma kernel as with the mma.sync one before it; the `gpu`
# test's Llama case 0.015625 (a neighbour in [2, 4)) at max|ref| 3.98; float32 9.5e-6 * max|ref|
# (measured on one NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6).
FP_BF16_ERR, FP_BF16_COS, FP_F32_ERR = 2.0**-7, 1 - 1e-5, 1e-4
# Phase 3's flash_decode rows at Gemma's head dim: Gemma-7B's heads over every cache of phase 22's
# T + NEW slots, and the paged arm (bf16 and qint4 pages of 64 over phase 15's 768 slots a row).
FD_GEMMA_HEADS = FP_HEADS["gemma-7b"]
FD_GEMMA_PAGED = [("bf16", SERVE_MAX_LEN, 64, torch.bfloat16), ("qint4", SERVE_MAX_LEN, 64, torch.bfloat16)]
# google/gemma-7b config.json (tied embeddings: Hugging Face's GemmaConfig default, the file names
# none), as `LlamaConfig.from_hf` reads it. Phase 22 runs it at full width, GEMMA_7B_LAYERS deep.
GEMMA_7B = dict(
    architectures=["GemmaForCausalLM"],
    model_type="gemma",
    vocab_size=256000,
    hidden_size=3072,
    intermediate_size=24576,
    num_hidden_layers=28,
    num_attention_heads=16,
    num_key_value_heads=16,
    head_dim=256,
    hidden_act="gelu",
    max_position_embeddings=8192,
    rms_norm_eps=1e-6,
    rope_theta=10000.0,
    attention_bias=False,
    torch_dtype="bfloat16",
)
# Phase 22's depth: the published width at 4 of Gemma-7B's 28 layers, cut so that the full run keeps
# its time limit with phases 24 and 25.
GEMMA_7B_LAYERS = 4
# Phase 22: each row of the kernel path's last-position prefill logits against the plain versions'
# (cosine), GEMMA_7B_LAYERS random-weight layers. Read 0.999951-0.999954 over the 4 rows, alike
# over both caches (the prefill attends to the raw K/V either way), greedy tokens EQUAL over both,
# in two runs (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 4). The limit is about 3x the largest
# 1 - cosine read. (At 28 layers: 0.99934-0.99945, limit 0.998.)
GEMMA_E2E_COS = 0.99985
# google/gemma-2-9b config.json, as `Gemma2Config.from_hf` reads it (tied embeddings and the layer
# types are Hugging Face's Gemma2Config defaults, which the file leaves out: the even layers slide).
# Phase 23 runs it at full depth and width.
GEMMA2_9B = dict(
    architectures=["Gemma2ForCausalLM"],
    model_type="gemma2",
    vocab_size=256000,
    hidden_size=3584,
    intermediate_size=14336,
    num_hidden_layers=42,
    num_attention_heads=16,
    num_key_value_heads=8,
    head_dim=256,
    query_pre_attn_scalar=256,
    attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0,
    sliding_window=4096,
    hidden_act="gelu_pytorch_tanh",
    hidden_activation="gelu_pytorch_tanh",
    max_position_embeddings=8192,
    rms_norm_eps=1e-6,
    rope_theta=10000.0,
    attention_bias=False,
    torch_dtype="float32",
)
# Phase 3's Gemma-2 rows of flash_decode (TPU #8-#10 with the softcap, the query scale and the
# window): (label, (Hkv, G, D), cache, S, positions, transforms, ring). Gemma-2-9B's heads (8 x 2 of
# 256, query_pre_attn_scalar 256) over phase 23(a)'s T + NEW slots; its window of 4096 at S = 8192
# beside the same call without one; the ring arm over a 4096-slot ring (positions past W, clamped
# to W - 1 by `decode_attention(ring=True)`); Gemma-2-27B's heads (16 x 2 of 128,
# query_pre_attn_scalar 144: a scale that is not D**-0.5).
G2_HEADS, G2_27B_HEADS = (8, 2, 256), (16, 2, 128)
G2_TF = dict(scale=256**-0.5, softcap=50.0)
FD_GEMMA2_ROWS = [
    ("softcap", G2_HEADS, "bf16", T + NEW, [T + NEW - 1] * B, G2_TF, False),
    ("softcap", G2_HEADS, "qint4", T + NEW, [T + NEW - 1] * B, G2_TF, False),
    ("no-window", G2_HEADS, "bf16", 8192, [8191] * B, G2_TF, False),
    ("window", G2_HEADS, "bf16", 8192, [8191] * B, dict(G2_TF, window=4096), False),
    ("ring", G2_HEADS, "bf16", 4096, [5183] * B, G2_TF, True),
    ("ring", G2_HEADS, "qint4", 4096, [5183] * B, G2_TF, True),
    ("scale144", G2_27B_HEADS, "bf16", T + NEW, [T + NEW - 1] * B, dict(scale=144**-0.5, softcap=50.0), False),
]
# Phase 23 (b, c): one prompt past the window, over a qint4 cache with rings and over flat caches.
G2_LONG = 5120
# Phase 23 (d): the JAX serving bench's long-context shape (bench/serving_bench.py:77-79) past
# Gemma-2's window: 4 requests, chunks of 512, 16 new tokens, a bf16 cache of 4736 slots.
G2_ENGINE_PROMPTS = (4224, 4352, 4480, 4608)
G2_ENGINE_CHUNK, G2_ENGINE_NEW, G2_ENGINE_MAX_LEN = 512, 16, 4736
# Phase 23(a): each row's last-position prefill logits, kernel path against the plain versions
# (cosine), 42 random-weight layers. Predicted near phase 22's 0.9993-0.9995 (PERF.md section 6).
GEMMA2_E2E_COS = 0.998
# Phase 23 (b) against (c): the same kernels over a ring and over a flat cache with the window; the
# attention chain reduces over W + T keys against S slots and the decode reads the window in
# another slot order, so float32 sums part in their last bits. Predicted above 0.9999.
GEMMA2_RING_COS = 0.9995

# --- Phases 24 and 25: the QK-norm families ----------------------------------------------------
# google/gemma-3-12b-pt config.json: the language model nests under `text_config`, whose missing
# keys take Hugging Face's Gemma3TextConfig defaults (vocab 262208, head_dim 256,
# query_pre_attn_scalar 256, rope_theta 1e6, rope_local_base_freq 1e4, the 5:1 pattern, tied
# embeddings, eps 1e-6, gelu_pytorch_tanh). Phase 24 runs it at full depth and width.
GEMMA3_12B = {
    "architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3",
    "text_config": {
        "hidden_size": 3840, "intermediate_size": 15360, "model_type": "gemma3_text", "num_attention_heads": 16,
        "num_hidden_layers": 48, "num_key_value_heads": 8, "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
        "sliding_window": 1024,
    },
    "vision_config": {"model_type": "siglip_vision_model"},
}
# Phase 24 (b): the prompts of (a) over flat caches, this many new tokens.
G3_FLAT_NEW = 16
# Phase 24 (c): four prompts past the window through the engines, chunks of 512, 16 new tokens.
G3_ENGINE_PROMPTS = (1100, 1230, 1370, 1500)
G3_ENGINE_CHUNK, G3_ENGINE_NEW, G3_ENGINE_MAX_LEN = 512, 16, 1536
# Phase 24(a): each row's last-position prefill logits, kernel path against the plain versions
# (cosine), 48 random-weight layers. Predicted near phases 22 and 23 (0.9993-0.9997); read
# 0.99974-0.99976, tokens EQUAL (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6). The limit is
# about 3x the largest 1 - cosine read.
GEMMA3_E2E_COS = 0.9992
# Phase 24 (a) against (b): the 40 sliding layers take the concatenation chain (float32 over W + T
# keys) in (a) and `flash_prefill` (bf16 P) in (b): two attention routes, not one route in two
# orders as phase 23's (b) against (c), so they part as the kernel and plain paths do. Predicted
# above 0.9995 (missed); read 0.99974, tokens EQUAL. The limit is about 3x 1 - cosine.
GEMMA3_RING_COS = 0.9992
# Qwen/Qwen3-30B-A3B config.json (128 experts, top-8, norm_topk_prob, untied head). Phase 25 runs it
# at full depth and width.
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe", "attention_bias": False,
    "decoder_sparse_step": 1, "head_dim": 128, "hidden_act": "silu", "hidden_size": 2048,
    "intermediate_size": 6144, "max_position_embeddings": 40960, "max_window_layers": 48, "mlp_only_layers": [],
    "moe_intermediate_size": 768, "norm_topk_prob": True, "num_attention_heads": 32, "num_experts": 128,
    "num_experts_per_tok": 8, "num_hidden_layers": 48, "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
    "rope_scaling": None, "rope_theta": 1000000.0, "sliding_window": None, "tie_word_embeddings": False,
    "use_sliding_window": False, "vocab_size": 151936, "torch_dtype": "bfloat16",
}
# Qwen/Qwen3-8B config.json. Phase 25(c) runs it at full width and QWEN3_8B_LAYERS layers.
QWEN3_8B = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3", "attention_bias": False, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 12288, "max_position_embeddings": 40960,
    "max_window_layers": 36, "num_attention_heads": 32, "num_hidden_layers": 36, "num_key_value_heads": 8,
    "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 1000000, "sliding_window": None,
    "tie_word_embeddings": False, "use_sliding_window": False, "vocab_size": 151936, "torch_dtype": "bfloat16",
}
QWEN3_8B_LAYERS = 8
# Phase 25: (a) B = 4 x 1024 + Q3_NEW new tokens; (b) B16 x T16 + Q3_B16_NEW (the unique-expert
# route, S·K = 128 = E, at each step); (c) B = 4 x 1024 + Q3_8B_NEW.
Q3_NEW, Q3_B16_NEW, Q3_8B_NEW = 32, 16, 16
# Phase 25: the kernel path's last-position prefill logits against the plain versions', each row
# held to QWEN3_E2E_COS and the same top-1 token or a logit tie (LOGIT_TIE), and its routing (the
# top-8 experts of each layer at the last position) to the phase 9 rule at top-8 of 128: where a
# row's experts part between the paths, the first layer where they part holds a routing tie, both
# paths' 8th and 9th probabilities within QWEN3_ROUTE_TIE (they average 1/128, so phase 9's 0.02
# would call anything a tie). The router's logits are bf16, so its 8th and 9th probabilities are
# often exactly equal. Readings (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): every row's
# routing parted somewhere in the 48 layers, the first parting layers' margins 0-4.7e-4 (later
# layers, routing other experts' hidden states, up to 1.1e-3); cosine 0.99962-0.99989 all the same.
# (b) at B = 16 x 256: every row parted in 2-10 layers, first at margins 0-4.3e-4 (later up to
# 2.5e-3), cosine 0.99979-0.99992. Limits: about 2x the largest first-layer margin; about 4x the
# largest 1 - cosine.
QWEN3_E2E_COS = 0.9985
QWEN3_ROUTE_TIE = 1e-3
# A greedy token of phase 25 (a, b) may part from the plain path's at a relative logit gap past
# SERVE_TOP1_GAP (a dense model's), up to QWEN3_TOP1_GAP, only where a routing flip at a tie is
# shown behind it (`routing_tie_behind`: over the context both paths share, the first layer where
# their top-8 experts part holds a routing tie at every position where they part): such a flip
# swaps an expert's whole output, which moves the logits more than sums in another order. Read:
# 0.0586 at (a)'s request 0, token 17, behind which layer 0 parts at 12 of its 1041 positions, at
# margins 0-4.0e-4; (b)'s three ties 0.0077-0.0217 (NVIDIA H100 80GB HBM3, 700 W; PERF.md section
# 6). The limit is 1.5x the largest reading.
QWEN3_TOP1_GAP = 0.09
# Phase 3's rows at the QK-norm families' heads: (label, (Hkv, G, D), cache, S, positions,
# transforms, ring), as FD_GEMMA2_ROWS. Qwen3-30B-A3B's 4 x 8 of 128 over phase 25(a)'s T + Q3_NEW
# slots; Gemma-3-12B's 8 x 2 of 256 (query_pre_attn_scalar 256, no softcap) over phase 24(a)'s
# 1024-slot rings (positions past W, clamped to W - 1), flat with the window of 1024, and its full
# layers over T + NEW slots.
G3_HEADS, Q3_HEADS = (8, 2, 256), (4, 8, 128)
FD_QK_NORM_ROWS = [
    ("qwen3-30b-a3b", Q3_HEADS, "bf16", T + Q3_NEW, [T + Q3_NEW - 1] * B, {}, False),
    ("gemma-3-12b full", G3_HEADS, "bf16", T + NEW, [T + NEW - 1] * B, dict(scale=256**-0.5), False),
    ("gemma-3-12b ring", G3_HEADS, "bf16", 1024, [T + NEW - 1] * B, dict(scale=256**-0.5), True),
    ("gemma-3-12b window", G3_HEADS, "bf16", T + NEW, [T + NEW - 1] * B, dict(scale=256**-0.5, window=1024),
     False),
]
# Phase 3's MoE rows at Qwen3-30B-A3B's experts (128 of gate/up 2048 -> 768 and down 768 -> 2048,
# top-8): the B = 4 decode step's 32 selective pairs, the B = 16 step's unique-expert route over a
# 128-slot routed-first table (QWEN3_ROUTED experts live; gate/up over 16 shared rows, down over
# each slot's own 16 rows: TPU #15), and the B = 4 x 1024 prefill's capacity slabs of 512 rows.
QWEN3_MOE_SHAPES = [(768, 2048), (2048, 768)]
QWEN3_ROUTED = 96
# openai/gpt-oss-20b config.json (24 layers of 64 heads over 8 kv heads of 64, sinks, window 128 on the
# even layers, 32 experts of 2880 top-4, yarn x 32 over 4096, untied head; the keys the model reads, its
# mxfp4 quantization_config left out: the weights are random, quantized here). Phase 26 runs it at full
# depth and width.
GPT_OSS_20B = {
    "architectures": ["GptOssForCausalLM"], "model_type": "gpt_oss", "attention_bias": True, "head_dim": 64,
    "hidden_act": "silu", "hidden_size": 2880, "intermediate_size": 2880,
    "layer_types": ["sliding_attention", "full_attention"] * 12, "max_position_embeddings": 131072,
    "num_attention_heads": 64, "num_experts_per_tok": 4, "experts_per_token": 4, "num_hidden_layers": 24,
    "num_key_value_heads": 8, "num_local_experts": 32, "rms_norm_eps": 1e-05,
    "rope_scaling": {"beta_fast": 32.0, "beta_slow": 1.0, "factor": 32.0, "original_max_position_embeddings": 4096,
                     "rope_type": "yarn", "truncate": False},
    "rope_theta": 150000, "sliding_window": 128, "swiglu_limit": 7.0, "tie_word_embeddings": False,
    "vocab_size": 201088, "torch_dtype": "bfloat16",
}
# Phase 26: (a) B = 4 x 1024 + GO_NEW over bf16 rings; (b) B16 x T16 + GO_B16_NEW (the unique-expert
# route, S·K = 64 = 2E); (c) (a)'s prompts over flat caches, GO_FLAT_NEW new; (d) the engines:
# GO_ENGINE_PROMPTS through chunks of 512 (each prompt's last chunk partial, longer than W), 16 new,
# over caches of two whole chunks (a shorter max_len sends the padded chunks that would spill past it
# through serial admission at their own length).
GO_NEW, GO_B16_NEW, GO_FLAT_NEW = 32, 16, 16
GO_ENGINE_PROMPTS = (300, 410, 520, 600)
GO_ENGINE_CHUNK, GO_ENGINE_NEW, GO_ENGINE_MAX_LEN = 512, 16, 1024
# Phase 3's rows at gpt-oss-20b's heads (8 kv heads, G = 8, D = 64) with its sinks (GO_SINKS_RANGE):
# (label, cache, S, positions, sinks, transforms, ring, q's dtype). Phase 26(a)'s full layers over
# T + GO_NEW slots, the same bf16 call without sinks beside them, qint4, the 128-slot ring (positions
# past W, clamped to W - 1), the flat sliding layer's window of 128 and float32 q (the CUDA-core arm);
# then the paged arm (GO_PAGED: bf16 pages of 64 over T + 64 slots, with the sinks).
GO_HEADS = (8, 8, 64)
GO_SINKS_RANGE = 4.0
FD_GPT_OSS_ROWS = [
    ("sinks", "bf16", T + GO_NEW, [T + GO_NEW - 1] * B, True, {}, False, torch.bfloat16),
    ("no-sinks", "bf16", T + GO_NEW, [T + GO_NEW - 1] * B, False, {}, False, torch.bfloat16),
    ("sinks", "qint4", T + GO_NEW, [T + GO_NEW - 1] * B, True, {}, False, torch.bfloat16),
    ("ring", "bf16", 128, [T + GO_NEW - 1] * B, True, {}, True, torch.bfloat16),
    ("window", "bf16", T + GO_NEW, [T + GO_NEW - 1] * B, True, dict(window=128), False, torch.bfloat16),
    ("f32-q", "bf16", T + GO_NEW, [T + GO_NEW - 1] * B, True, {}, False, torch.float32),
]
GO_PAGED = [("bf16", T + 64, 64, torch.bfloat16)]
# Phase 3's MoE rows at gpt-oss-20b's experts: gate, up and down all [2944, 3072] after the padding
# (2880 rounded up to 128 and to 1024), 32 experts; a B = 16 step routes 64 pairs, about 28 experts.
GO_MOE_SHAPE = (2944, 3072)
GO_ROUTED = 28
# Phase 3's rows of #1 and #2 at gpt-oss-20b's attention, true (N, K, group size): q at K = 2880 in the
# auto group size 96 (padded to groups of 128 over K 3840), k and v, and o_proj's N = 2880 (to 2944);
# #1 at the B = 4 decode step's M = 4, #2 at the B = 4 x 1024 prefill's M = 4096.
GO_LINEAR_SHAPES = {"gpt-oss-20b": [(4096, 2880, 96), (512, 2880, 96), (2880, 4096, 128)]}
GO_LINEAR_M = {"qbits_mm_small_m": 4, "qbits_mm_tiled": 4096}
# Phases 23(a), 24(a) and 25(a): the tokens held against the plain path, the first PLAIN_NEW of the
# kernel run's (64, 64 and 32 before the plain runs' decode was cut to make room for phase 26; the
# prefill logits held to their cosine limits are unchanged, so the limits stand).
PLAIN_NEW = 16
# Phase 26's limits. On random weights gpt-oss-20b parts from any computation that sums in another
# order: a bf16 router tie at one of 4096 prompt positions swaps that token's expert (a quarter of
# its MoE output, about as large as the residual), attention carries it to every later position, and
# 24 layers compound it (read: a 6-layer cut's last-position logits at cosine 0.87 against the plain
# path, each block within 4e-3 of max|ref| of the plain block on one input; PERF.md section 6). So
# two computations are held (1) by their routing over every position: the first layer where any
# position's top-4 experts part must hold a routing tie at every such position, both computations'
# 4th and 5th probabilities over the 32 experts within GPT_OSS_ROUTE_TIE (`first_parting_ties`), and
# (2) with one computation forced through the other's tokens and replaying its expert choices
# (`RoutingTape`): every step's logits within GPT_OSS_E2E_COS of the other's, and where the two top-1
# tokens differ, a logit tie (`check_forced`). Read at full
# depth against the plain path (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): layer 0 parts first,
# at 22 of (a)'s 4096 positions (13 of (b)'s), margins up to 1.23e-3 (1.68e-3), then thousands of
# positions a layer; forced and replayed, cosine 0.99867-0.99934 over (a)'s 32 steps and 0.99949-0.99967
# over (b)'s 16, ties at relative gaps <= 0.0256; (d)'s serial arm against `generate` on the plain
# versions 0.99943-0.99963, its capacity arm against the same engine on the plain versions
# 0.99939-0.99956 (ties <= 0.0166). The limits: about 2.4x the largest margin and 3x the largest
# 1 - cosine.
GPT_OSS_E2E_COS = 0.996
GPT_OSS_ROUTE_TIE = 0.004
# Phase 26 (c) against (a), forced through (a)'s tokens with its choices replayed: the sliding layers
# attend through the flat window's mask in (c) and the ring's concatenation in (a), one f32 chain over
# other key sets. Read: no position's routing parts at any layer; cosine 0.99975-0.99983 over 16 steps.
# The limit: 2x 1 - cosine.
GPT_OSS_RING_COS = 0.9995
# Phase 26(d)'s batch engine against `generate`'s computation on the kernels, forced through the
# engine's tokens and replaying its expert choices: [4, 512] chunks over rings against a [1, n] prefill.
# Read: cosine 0.99961-0.99986 over 16 steps, ties at relative gaps <= 0.0067 (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md section 6). The limit: 3x the largest 1 - cosine.
GPT_OSS_ENGINE_COS = 0.9988

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


def phase_moe_qwen3(flush):
    """Phase 3, the MoE kernels at Qwen3-30B-A3B's experts (QWEN3_MOE_SHAPES,
    128 stacked experts of random int4 codes, bf16 x): each route of the
    stacked block against the plain version, held and timed as `phase_moe`'s
    rows (rows marked `qwen3`)."""
    return phase_moe_family(flush, "qwen3", 128, QWEN3_MOE_SHAPES, QWEN3_ROUTED, B * 8, 512, 2525)


def phase_moe_gpt_oss(flush):
    """Phase 3, the MoE kernels at gpt-oss-20b's padded experts (GO_MOE_SHAPE
    for gate, up and down, 32 stacked experts, top-4): the B = 4 decode step's
    16 selective pairs, the B = 16 step's 32-slot routed-first table
    (GO_ROUTED live), the B = 4 x 1024 prefill's 32 capacity slabs of 1024 rows
    and the engines' serial [1, GO_ENGINE_CHUNK] chunks, which take the
    all-experts route (gate and up through #12 over 512 shared rows, down
    through #14 over 32 slabs of 512) (rows marked `gpt_oss`)."""
    return phase_moe_family(flush, "gpt_oss", 32, [GO_MOE_SHAPE], GO_ROUTED, B * 4, 1024, 2626,
                            all_m=GO_ENGINE_CHUNK)


def phase_moe_family(flush, tag: str, E: int, shapes, routed: int, pairs: int, slab: int, seed: int,
                     all_m=None):
    """A model family's MoE rows: over `E` stacked experts of random int4 codes
    at each (N, K) of `shapes`, bf16 x, the selective form over `pairs` pairs,
    the unique-expert form over an E-slot routed-first table with `routed`
    live (gate/up over B16 shared rows; down, TPU #15, over each slot's own
    B16 rows), the capacity form over E slabs of `slab` rows and, with
    `all_m`, the all-experts form (all E slots over `all_m` shared rows, then
    the down projection over E slabs of `all_m` rows), each against
    the plain version (cosine > 1 - 1e-5, max abs error <= 1e-4 max|ref|) and
    timed beside its bound, the plain version and `torch.bmm` over the live
    experts dequantized to bf16 (rows marked `tag`)."""
    from quanto_tpu_torch.ops.cuda import moe_mm as MM
    from quanto_tpu_torch.ops.cuda.qbits_mm import dequantize_k_codes

    dev, bits = torch.device("cuda"), 4
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for N, K in shapes:
        G = K // GS
        packed = torch.randint(0, 256, (E, N, K * bits // 8), dtype=torch.uint8, device=dev, generator=g)
        scale_t = torch.rand((E, G, N), device=dev, generator=g) * 0.01 + 0.001
        shift_t = scale_t * (2**bits - 1) / 2
        weights = (packed, scale_t, shift_t, GS, bits)
        perm = torch.randperm(E, device=dev, generator=g)
        live = perm[:routed].sort().values
        table = torch.cat([live, perm[routed:].sort().values]).to(torch.int32)
        count = torch.tensor(routed, dtype=torch.int32, device=dev)
        x16 = torch.randn((B16, K), device=dev, generator=g, dtype=torch.bfloat16)
        # (route, kernel, x3 [U, M, K], eids, nslots)
        cases = [
            ("sel", MM.qbits_moe_small_m, torch.randn((pairs, 1, K), device=dev, generator=g, dtype=torch.bfloat16),
             torch.randint(0, E, (pairs,), device=dev, generator=g, dtype=torch.int32), None),
            ("uniq", MM.qbits_moe_small_m, x16.expand(E, B16, K), table, count),
            ("uniq", MM.qbits_moe_tiled, torch.randn((E, B16, K), device=dev, generator=g, dtype=torch.bfloat16),
             table, count),
            ("experts", MM.qbits_moe_tiled, torch.randn((E, slab, K), device=dev, generator=g, dtype=torch.bfloat16),
             None, None),
        ]
        if all_m is not None:
            xs = torch.randn((all_m, K), device=dev, generator=g, dtype=torch.bfloat16)
            cases += [
                ("all", MM.qbits_moe_small_m, xs.expand(E, all_m, K), None, None),
                ("experts", MM.qbits_moe_tiled,
                 torch.randn((E, all_m, K), device=dev, generator=g, dtype=torch.bfloat16), None, None),
            ]
        for form, kernel, x3, eids, nslots in cases:
            U, M = x3.shape[:2]
            n_live = U if nslots is None else routed
            ids = (eids.long() if eids is not None else torch.arange(U, device=dev))[:n_live]
            experts = sorted(set(ids.tolist()))
            w_lib = torch.stack([dequantize_k_codes(packed[e], scale_t[e], shift_t[e], GS, bits).to(torch.bfloat16)
                                 for e in ids.tolist()])
            x_lib = x3[:n_live]
            out = kernel(x3, *weights, eids=eids, nslots=nslots)
            ref = MM.qbits_moe_plain(x3, *weights, eids=eids, nslots=nslots)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ref_max = ref.abs().max().item()
            cos = cosine(out, ref)
            if not (cos > 1 - 1e-5 and err <= 1e-4 * ref_max):
                raise RuntimeError(f"{kernel.__name__} {tag} {form} U={U} M={M} N={N} K={K}: cosine {cos} "
                                   f"max_abs_err {err} (max|ref| {ref_max})")
            x_bytes = (M if x3.stride(0) == 0 else n_live * M) * K * 2
            nbytes = x_bytes + len(experts) * (N * K * bits // 8 + 2 * G * N * 4) + U * M * N * 4
            ops = 2 * n_live * M * N * K
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_BF16_FLOPS * 1e3
            row = dict(
                name=kernel.__name__, **{tag: True}, form=form, U=U, nslots=None if nslots is None else routed,
                M=M, N=N, K=K, experts=len(experts), max_abs_err=err, cosine=cos,
                ms=time_ms(lambda: kernel(x3, *weights, eids=eids, nslots=nslots), flush),
                plain_ms=time_ms(lambda: MM.qbits_moe_plain(x3, *weights, eids=eids, nslots=nslots), flush),
                library_ms=time_ms(lambda: torch.bmm(x_lib, w_lib.transpose(1, 2)), flush),
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                host_us=host_us(lambda: kernel(x3, *weights, eids=eids, nslots=nslots), n=20),
            )
            rows.append(row)
            log("kernel " + json.dumps(row))
            del out, ref, w_lib, x_lib
        del packed, scale_t, shift_t, cases
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


def phase_flash_decode(flush, heads=FD_HEADS, kinds=None):
    """Phase 3, flash_decode: the kernel against its plain version and SDPA,
    at B = 4 with every slot visible over each cache type (and with float32 q
    over FD_F32_Q at 8192 slots), and at phase 10's decode step (bf16, 8
    ragged rows, `FD_ENGINE_POS`). With other `heads` (Hkv, G, D): B = 4
    over `kinds` (default FD_NEW_CACHES) of T + NEW slots, the decode run of
    phases 18 and 19, or of phase 22 at Gemma-7B's heads."""
    from quanto_tpu_torch.ops.attention import decode_attention
    from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain
    from quanto_tpu_torch.tensor.kv_cache import kv_read

    Hkv, G, D = heads
    g = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    # (cache, S, positions, the engine arm or phase 21's caches they stand for or None, q's dtype)
    if heads != FD_HEADS:
        cases = [(kind, T + NEW, [T + NEW - 1] * B, None, torch.bfloat16) for kind in kinds or FD_NEW_CACHES]
    else:
        cases = [(kind, S, [S - 1] * B, None, torch.bfloat16) for S in FD_SLOTS for kind in FD_CACHES]
        cases += [(kind, FD_SLOTS[-1], [FD_SLOTS[-1] - 1] * B, None, torch.float32) for kind in FD_F32_Q]
        cases += [("bf16", ENGINE_MAX_LEN, p, arm, torch.bfloat16) for arm, p in FD_ENGINE_POS.items()]
        cases += [("bf16", S, spec_positions(S), "speculative", torch.bfloat16) for S in spec_cache_lens()]
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


def phase_flash_decode_paged(flush, heads=FD_HEADS, cases=None, tf=None, tag=None):
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
    page beside them). With other `heads` (Hkv, G, D), the given `cases`
    (cache, slots a row, page size, q's dtype); `tf` (gpt-oss's sinks) goes to
    every call of the kernel and its plain version, and `tag` marks the rows."""
    from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_paged, flash_decode_paged_plain
    from quanto_tpu_torch.tensor import kv_cache as tkv
    from quanto_tpu_torch.tensor import paged_kv as tpk

    Hkv, G, D = heads
    nb = ENGINE_SLOTS
    g = torch.Generator(device="cuda").manual_seed(2020)
    if cases is None:
        cases = [(kind, S, ps, torch.bfloat16) for S in FD_PAGED_SLOTS for ps in FD_PAGE_SIZES
                 for kind in FD_PAGED_CACHES]
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
        kw = dict(k_shift=c._k_shift, v_shift=c._v_shift, **(tf or {}))
        out = flash_decode_paged(*args, **kw)
        gathered = tpk.paged_gather(layer, nb)
        kg, vg, ks, vs, km, vm = gathered

        def dense():
            return flash_decode(q, kg, vg, ks, vs, pos, k_shift=km, v_shift=vm, **(tf or {}))

        def gather_dense():
            g_ = tpk.paged_gather(layer, nb)
            return flash_decode(q, *g_[:4], pos, k_shift=g_[4], v_shift=g_[5], **(tf or {}))

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
        b_ms, b_by = fd_bound(nb * S, nb, k_row, v_row, per_slot, q.element_size(), heads)
        row = dict(
            name="flash_decode_paged", **({tag: True} if tag else {}), cache=kind, S=S, B=nb, page_size=ps,
            Hkv=Hkv, G=G, D=D,
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


def phase_flash_decode_gemma2(flush, cases=FD_GEMMA2_ROWS, tag: str = "gemma2"):
    """Phase 3, flash_decode with Gemma-2's extras (FD_GEMMA2_ROWS; the
    QK-norm families' rows FD_QK_NORM_ROWS under `tag` "qk_norm"): the
    kernel against its plain version (cosine > 1 - 1e-4, max abs error <=
    1e-2 max|ref|) and the model's dispatch (`decode_attention`, with `ring`
    for the ring rows) equal to the direct call; timed beside its bound
    (the slots each row sees: its window only under a window), the plain
    version and SDPA (the cache dequantized to bf16, the same scale and
    visible slots as a boolean mask, without the softcap, which it does not
    take)."""
    from quanto_tpu_torch.ops.attention import decode_attention
    from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain
    from quanto_tpu_torch.tensor.kv_cache import kv_read

    g = torch.Generator(device="cuda").manual_seed(2323)
    rows = []
    for label, heads, kind, S, positions, tf, ring in cases:
        Hkv, G, D = heads
        nb = len(positions)
        cache = fd_cache(kind, S, g, nb, heads)
        q = (torch.randn((nb, Hkv, G, D), device="cuda", generator=g) * 4).to(torch.bfloat16)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        kpos = pos.clamp(max=S - 1) if ring else pos  # what the ring arm hands the kernel
        if kind == "bf16":
            args, kw = (q, *cache, None, None, kpos), dict(tf)
            k_row = v_row = 2 * D
            per_slot = 0
        else:
            c = cache
            args = (q, c._k_data, c._v_data, c._k_scale, c._v_scale, kpos)
            kw = dict(k_shift=c._k_shift, v_shift=c._v_shift, **tf)
            k_row, v_row = c._k_data[0, 0, 0].numel(), c._v_data[0, 0, 0].numel()
            per_slot = 8 if c._k_shift is None else 16
        out = flash_decode(*args, **kw)
        ref = flash_decode_plain(*args, **kw)
        out2 = decode_attention(q.reshape(nb, 1, Hkv * G, D), cache, pos, ring=ring, **tf)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        cos = cosine(out, ref)
        what = f"flash_decode {tag} {label} {kind} heads={heads} S={S}"
        if not (cos > 1 - 1e-4 and err <= 1e-2 * ref_max) or not torch.equal(out2.reshape(out.shape), out):
            raise RuntimeError(f"{what}: cosine {cos} max_abs_err {err} (max|ref| {ref_max})")
        s = torch.arange(S, device="cuda")[None, :]
        visible = s <= kpos[:, None]
        if tf.get("window"):
            visible &= s > kpos[:, None] - tf["window"]
        kd, vd = cache if kind == "bf16" else kv_read(cache, torch.bfloat16)
        kt, vt = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
        qs = q.reshape(nb, Hkv * G, 1, D)
        mask = visible[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask, enable_gqa=True,
                                                  scale=tf.get("scale", D**-0.5))

        b_ms, b_by = fd_bound(int(visible.sum()), nb, k_row, v_row, per_slot, 2, heads)
        row = dict(
            name="flash_decode", **{tag: label}, cache=kind, S=S, B=nb, engine_arm=None, positions=positions, Hkv=Hkv,
            G=G, D=D,
            q="bf16", scale=tf.get("scale"), softcap=tf.get("softcap"), window=tf.get("window"), ring=ring,
            max_abs_err=err, cosine=cos,
            ms=time_ms(lambda: flash_decode(*args, **kw), flush),
            plain_ms=time_ms(lambda: flash_decode_plain(*args, **kw), flush),
            library_ms=time_ms(sdpa, flush),
            bound_ms=b_ms, bound_by=b_by,
        )
        rows.append(row)
        log("kernel " + json.dumps(row))
        del cache, kd, vd, kt, vt, out, ref, out2
        torch.cuda.empty_cache()
    by = {r[tag]: r for r in rows if r["cache"] == "bf16"}
    if "window" in by and "no-window" in by:
        log(json.dumps({"flash_decode_window_vs_none_s8192": by["window"]["ms"] / by["no-window"]["ms"]}))
    return rows


def fp_bound(batch: int, T_: int, heads, elem: int):
    """Least time (ms) of one causal prefill: q, k, v read and the output
    written once (`elem` bytes a value), 2 B H T^2 D operations (QK^T and PV
    over the lower triangle) at the bf16 tensor-core rate (a float32 call is
    counted at that rate too: the kernel's split products run there)."""
    Hkv, G, D = heads
    H = Hkv * G
    nbytes = elem * batch * T_ * D * (2 * H + 2 * Hkv)
    ops = 2 * batch * H * T_ * T_ * D
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The build's `-Xptxas -v` report, kernel by kernel (phase 2; empty when the library was built before).
PTXAS: dict = {}


def ptxas_entries(report: str) -> dict:
    """{mangled kernel name: {"registers", "spill_bytes"}} from an `-Xptxas -v`
    report. A kernel that moves registers between its warpgroups (setmaxnreg)
    reports its launch count; its spills are those of every warpgroup."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


def fp_ptxas(D: int, softcap, dtype) -> dict:
    """The report's entry of the `flash_prefill` kernel that a row runs (the bf16
    arm's `bf16_kernel<D, softcap>`, the float32 arm's `f32_kernel<D>`; a tree
    from before the bf16 arm's redesign: `flash_prefill_kernel<D, float32>`), or
    None when the library was not built in this run."""
    f32 = dtype == torch.float32
    patterns = [rf"f32_kernelILi{D}E" if f32 else rf"bf16_kernelILi{D}ELb{int(bool(softcap))}E",
                rf"flash_prefill_kernelILi{D}ELb{int(f32)}E"]
    for pattern in patterns:
        for name, entry in PTXAS.items():
            if re.search(pattern, name):
                return dict(kernel=name, **entry)
    return None


def phase_flash_prefill(flush):
    """Phase 3, `flash_prefill` (TPU #16): the kernel against its plain
    version at B = 4, T = 1024 over FP_ROWS (Llama-3.1-8B's, Gemma-7B's and
    Gemma-2B's heads, a softcap of 50, float32), within FP_BF16_ERR and
    FP_BF16_COS (bf16) or FP_F32_ERR (float32); timed beside its bound, the
    plain version and, as the yardstick only, `scaled_dot_product_attention`
    (causal, GQA; without the softcap, which it does not take)."""
    from quanto_tpu_torch.ops.cuda.flash_prefill import flash_prefill, flash_prefill_plain

    g = torch.Generator(device="cuda").manual_seed(1616)
    rows = []
    for model_name, softcap, dtype in FP_ROWS:
        Hkv, G, D = FP_HEADS[model_name]
        q = torch.randn((B, T, Hkv * G, D), device="cuda", generator=g).to(dtype)
        k = (torch.randn((B, T, Hkv, D), device="cuda", generator=g) * 2 + 0.5).to(dtype)
        v = torch.randn((B, T, Hkv, D), device="cuda", generator=g).to(dtype)

        def kernel():
            return flash_prefill(q, k, v, softcap=softcap)

        def plain():
            return flash_prefill_plain(q, k, v, softcap=softcap)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        cos = cosine(out, ref)
        ok = err <= FP_F32_ERR * ref_max if dtype == torch.float32 else (
            err <= FP_BF16_ERR * ref_max and cos > FP_BF16_COS)
        what = f"flash_prefill {model_name} softcap={softcap} {dtype}"
        if not ok or out.shape != (B, T, Hkv * G * D):
            raise RuntimeError(f"{what}: cosine {cos} max_abs_err {err} (max|ref| {ref_max})")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True, scale=D**-0.5)

        b_ms, b_by = fp_bound(B, T, (Hkv, G, D), q.element_size())
        row = dict(
            name="flash_prefill", model=model_name, B=B, T=T, Hkv=Hkv, G=G, D=D, softcap=softcap,
            dtype=str(dtype).removeprefix("torch."), max_abs_err=err, max_abs_ref=ref_max, cosine=cos,
            sdpa_cosine=None if softcap else cosine(sdpa().transpose(1, 2).reshape(out.shape), ref),
            ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush), library_ms=time_ms(sdpa, flush),
            bound_ms=b_ms, bound_by=b_by, host_us=host_us(kernel), ptxas=fp_ptxas(D, softcap, dtype),
        )
        row["bound_share"] = b_ms / row["ms"]
        rows.append(row)
        log("kernel " + json.dumps(row))
        del q, k, v, qt, kt, vt, out, ref
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
    fp = counters().get("flash_prefill")

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
    pre = (small.launches, tiled.launches, fd.launches, fp.launches if fp else 0)
    first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
    t0 = time.perf_counter()
    rest, cache = decode(model, first, cache, T, NEW - 1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {
        "qbits_mm_small_m": small.launches, "qbits_mm_tiled": tiled.launches, "flash_decode": fd.launches,
        **({"flash_prefill": fp.launches} if fp else {}),
    }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    layers = config.num_hidden_layers
    n_lin = LINEARS_PER_LAYER * layers
    steps = NEW - 1
    n_fp = layers if fp else 0  # TPU #16: one causal prefill a layer
    if pre != (1, n_lin, 0, n_fp):
        raise RuntimeError(f"prefill launches (small_m, tiled, flash_decode, flash_prefill) = {pre}, "
                           f"want (1, {n_lin}, 0, {n_fp})")
    want = {
        "qbits_mm_small_m": 1 + (n_lin + 1) * steps, "qbits_mm_tiled": n_lin, "flash_decode": layers * steps,
        **({"flash_prefill": n_fp} if fp else {}),
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
    # TPU #16, the causal prefill over the raw K/V (absent from trees before it was ported).
    try:
        from quanto_tpu_torch.ops.cuda import flash_prefill as FP_mod
    except ImportError:
        FP_mod = None
    if FP_mod is not None:
        wrappers["flash_prefill"] = FP_mod.flash_prefill
    # The W8A8 route's library calls (`torch._int_mm`; the e4m3fn product), counted where they are
    # made (absent from trees before W8A8 was ported).
    from quanto_tpu_torch.ops import qbytes_mm as W8A8

    if hasattr(W8A8, "qbytes_int_mm"):
        wrappers["qbytes_int_mm"], wrappers["qbytes_fp8_mm"] = W8A8.qbytes_int_mm, W8A8.qbytes_fp8_mm
    return wrappers


def prefill_attention_want(config, prompt: int, prefills: int = 1) -> dict:
    """The `flash_prefill` launches of `prefills` prefills of `prompt` tokens
    from position 0 (TPU #16): one a layer inside JAX's envelope (T >= 256,
    T % 128 == 0, head_dim a multiple of 128), none outside it or on a tree
    without the kernel."""
    if "flash_prefill" not in counters():
        return {}
    from quanto_tpu_torch.ops.cuda.flash_prefill import in_envelope

    if not in_envelope(prompt, config.head_dim, config.dtype):
        return {}
    return {"flash_prefill": prefills * config.num_hidden_layers}


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
def plain_versions(keep_prefill_kernel: bool = False):
    """Route every kernel call of the model to its plain PyTorch version
    (`flash_prefill` excepted with `keep_prefill_kernel`: the checks of models
    with quantized activations (phases 5, 13, 14, 17), where both paths then
    run the same deterministic attention kernel)."""
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
    fused_prefill = None if keep_prefill_kernel else getattr(attention, "flash_prefill", None)
    if fused_prefill is not None:
        from quanto_tpu_torch.ops.cuda import flash_prefill as FP_mod

        attention.flash_prefill = FP_mod.flash_prefill_plain
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
        if fused_prefill is not None:
            attention.flash_prefill = fused_prefill
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
            if prefill_counts != {"qbits_mm_requant_int8": 2 * LINEARS_PER_LAYER * layers,
                                  **prefill_attention_want(config, T, prefills=2)}:
                raise RuntimeError(f"{arm}: the two prefills launched {prefill_counts}")
        # The W4A8 arms keep `flash_prefill` in both paths: their activation quantizers turn the
        # kernel's other float32 order into moved int8 codes (read: one w4a8 row's top-1 token moved
        # at cosine 0.99966 with the prefill's attention plain on one side; measured on one NVIDIA
        # H100 80GB HBM3, 700 W), so the arm holds its linears and decode attention to their
        # plain versions as before; the fused prefill's own end-to-end checks are phases 9, 11, 13
        # and 22.
        keep = kw.get("activations") is not None
        before = read_counts()
        with plain_versions(keep_prefill_kernel=keep):
            logits_p, step_p, _ = run()
        torch.cuda.synchronize()
        after = read_counts()
        if {n: after[n] - before[n] for n in after if after[n] != before[n]} != (
                prefill_attention_want(config, T, prefills=2) if keep else {}):
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
    tokens and the counts (phase 16). The prefill's `flash_prefill` launches
    (one a layer inside its envelope, `prefill_attention_want`) are wanted
    beside `want_prefill`."""
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
    want_prefill = {**prefill_attention_want(config, T), **want_prefill}
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
        record.update(logits=logits.cpu(), tokens=torch.cat([first, rest], dim=1).cpu(), launches=launches,
                      decode_tok_s=B * steps / decode_s)
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

    def counted_forward(ids, cache, pos, last_idx, **kw):  # kw: write_len (ring-cache models)
        T = ids.shape[1]
        before = read_counts()
        out = forward(ids, cache, pos, last_idx, **kw)
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


def readback_prefill(model, ids, cache):
    """A prefill of `ids` from position 0 that attends as the engines' chunks
    do: the position given as a tensor, so every layer takes `gqa_attention`
    over the cache readback, not `flash_prefill` over the raw K/V (the route
    of a prefill written at the int 0, `serve.prefill`'s). (logits at the last
    position [B, 1, V], cache)."""
    pos = torch.zeros(ids.shape[0], dtype=torch.long, device=ids.device)
    return model(ids, cache, pos, logits_indices=ids.shape[1] - 1)


def check_first_tokens(label: str, model, prompts, tokens, max_len: int = ENGINE_MAX_LEN, tie=None) -> list:
    """Each request's first token against the argmax of a standalone prefill
    of its prompt (prompts of equal length batched; in phase 10 every such
    prefill has M >= 2048, so the same requant route) over a cache of the
    engine's length `max_len` through the attention the engine's chunks take
    (`readback_prefill`), so that attention reduces over the same slots the
    same way: equal, or the standalone's logits of the two tokens within
    `tie` (default LOGIT_TIE) of its largest |logit|. Returns the ties it
    accepted."""
    from quanto_tpu_torch.models.serve import make_cache

    tie = LOGIT_TIE if tie is None else tie

    ties = []
    by_len = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(len(p), []).append(i)
    for L, idx in by_len.items():
        ids = torch.tensor(np.stack([prompts[i] for i in idx]), device="cuda")
        logits, _ = readback_prefill(model, ids, make_cache(model, len(idx), max_len))
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

        def counted_forward(ids, cache, pos, last_idx, **kw):  # kw: write_len (ring-cache models)
            R, T = ids.shape
            before = read_counts()
            seen_m.clear()
            if T > 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = forward(ids, cache, pos, last_idx, **kw)
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


def check_same_tokens(label: str, model, prompts, got, want, kv_quant=None, max_len: int = SERVE_MAX_LEN,
                      tie_gap: float = SERVE_TOP1_GAP) -> list:
    """Each request's tokens `got` against `want`: equal, or at the first
    index j where they part, the two tokens' logits within `tie_gap` of
    the largest |logit| of a standalone prefill of the prompt and want[:j]
    (over a cache of `max_len` slots, `kv_quant`, through `readback_prefill`).
    Returns the ties it accepted (each logged)."""
    from quanto_tpu_torch.models.serve import make_cache

    ties = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        if len(a) != len(b):
            raise RuntimeError(f"{label}: request {i} gave {len(a)} tokens, want {len(b)}")
        j = next(j for j in range(len(b)) if a[j] != b[j])
        ctx = np.concatenate([prompts[i], np.asarray(b[:j], np.int64)])
        ids = torch.tensor(ctx[None], device="cuda")
        logits, _ = readback_prefill(model, ids, make_cache(model, 1, max_len, kv_quant=kv_quant))
        gap = relative_gap(logits[0, -1], b[j], a[j])
        ties.append({"request": i, "index": j, "want": b[j], "got": a[j], "relative_gap": gap})
        log(json.dumps({"token_tie": label, **ties[-1]}))
        if gap > tie_gap:
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

        def counted_forward(ids, cache, pos, last_idx, **kw):  # kw: write_len (ring-cache models)
            R, T = ids.shape
            before, g0 = read_counts(), gathers[0]
            if T > 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = forward(ids, cache, pos, last_idx, **kw)
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
    `router_kernel` (trees before the padding rule kept it generic). Each
    prefill (T = 1024 or 256 from position 0) takes `flash_prefill` once a
    layer."""
    L = config.num_hidden_layers
    S_K, E = batch * config.num_experts_per_tok, config.num_local_experts
    dense = (5 if router_kernel else 4) * L
    prefill = {"qbits_mm_tiled": dense, "qbits_moe_tiled": 3 * L,
               **prefill_attention_want(config, T16 if batch == B16 else T)}
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
    """Phases 8 and 25: one MoE block's decode forward at B = 1 and 4 and 16
    must not synchronize the host with the card (Mixtral: selective,
    unique-expert, all-experts; Qwen3-MoE: selective at 8 and 32 pairs, then
    the unique-expert route over its 128-slot table)."""
    block = moe_block(model.model.layers[0])
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
    log(f"{model.config.hf_model_type}: the MoE block's decode forward at B = 1, 4 and {B16} ran with no host sync")


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


def moe_block(layer):
    """A decoder layer's MoE block: Mixtral's `block_sparse_moe`, Qwen3-MoE's `mlp`."""
    return layer.block_sparse_moe if hasattr(layer, "block_sparse_moe") else layer.mlp


def route_record(model, last_only: bool = True):
    """Record, for each call of each layer's router, the softmax over the
    experts at the last position [B, E] (every position [B, T, E] unless
    `last_only`); returns (records, hook handles)."""
    from quanto_tpu_torch.models.llama import _deq

    records = []

    def hook(_mod, _args, out):
        logits = _deq(out).float()
        records.append(torch.softmax(logits[:, -1] if last_only else logits, dim=-1))

    return records, [moe_block(layer).gate.register_forward_hook(hook) for layer in model.model.layers]


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
    through the plain versions fed the stacked kernel path's router outputs
    (so the same capacity choices; the plain routers' own outputs are what
    `compare_rows` reads), row by row (`compare_rows`). B = 16 (prompts
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

    # The plain path takes the stacked kernel path's router outputs, as phase 8's split feeds them:
    # on the capacity route (S = 1024 and 4096) an expert over its capacity keeps the tokens of the
    # largest routing weights, and weights that differ in their last bits keep another token
    # (MIXTRAL_B16_PREFILL). With the fused prefill's attention a routed-alike B = 4 row read cosine
    # 0.99814 against the plain path and 0.99994 against the dense-mask path, which has no capacity
    # (seed 2; measured on one NVIDIA H100 80GB HBM3, 700 W).
    route = {"mode": None, "batch": None, "n": 0}
    fed = {}

    def feed_route(_mod, _args, out):
        key = (route["batch"], route["n"])
        route["n"] += 1
        if route["mode"] == "kernel":
            fed[key] = out
        elif route["mode"] == "plain":
            return fed[key]
        return None

    def run(batch):
        """(prefill logits, decode-step logits, routing [2, L, B, E]) at the last position."""
        x = prompts[batch]
        records.clear()
        route.update(batch=batch, n=0)
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
    hooks += [layer.block_sparse_moe.gate.register_forward_hook(feed_route) for layer in model.model.layers]
    reset_counts()
    route["mode"] = "kernel"
    kernel = {b: run(b) for b in prompts}
    counts = read_counts()
    arms = ("qbits_moe_small_m", "qbits_moe_tiled")
    if counts.get("qbits_moe_all", 2 * L) != 2 * L:  # the B = 16 step's gate and up, TPU #12
        raise RuntimeError(f"the stacked model launched TPU #12 {counts['qbits_moe_all']} times, want {2 * L}")
    if not all(counts[n] for n in arms) or (experts == "qint2" and not all(counts[n + "_int2"] for n in arms)):
        raise RuntimeError(f"the stacked model did not launch both MoE kernels' {experts} arms: {counts}")
    route["mode"] = "plain"
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
    bf16 cache, after a warm-up, with exact launch counts (`want` and the
    prefill's `flash_prefill` launches, 0 elsewhere); logs its time and peak memory beside its linears' least time
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
    want = {**prefill_attention_want(model.config, ids.shape[1]), **want}
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
            "qbits_mm_small_m": n_lin, "qbits_mm_small_m_int2": n_lin, "flash_decode": config.num_hidden_layers,
            **prefill_attention_want(config, T, prefills=2)}
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
        # `flash_prefill` in both paths, as phase 5's W4A8 arms: the activation quantizers turn its
        # other float32 order into moved codes; this phase holds the W2A8 linears.
        with plain_versions(keep_prefill_kernel=True), decode_inputs(model, rec_p):
            plain = run()
        after = read_counts()
        if {n: after[n] - counts[n] for n in after if after[n] != counts[n]} != prefill_attention_want(
                config, T, prefills=2):
            raise RuntimeError(f"w2a8 {form}: the plain forward launched a kernel")
        log(json.dumps({"w2a8_first_moved_codes": f"{form}, ragged decode step, kernel vs plain",
                        "rows": first_moved_codes(rec_k, rec_p)}))
        for what, k, p in zip(("B = 1 prefill", "B = 4 prefill", "ragged decode step"), kernel, plain):
            check_rows("w2a8", f"{form}, {what}", k, p, W2A8_E2E_COS)
        return kernel

    exact_want = {"qbits_mm_tiled_int8": n_lin, "qbits_mm_tiled_int8_int2": n_lin,
                  "qbits_mm_int8_small_m": n_lin, "qbits_mm_int8_small_m_int2": n_lin, "flash_decode": layers,
                  **prefill_attention_want(config, T, prefills=2)}
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
    want_pre = {**zeros, **per_forward, "qbits_mm_tiled": n_lin, "qbits_mm_small_m": 1,
                **prefill_attention_want(config, T)}
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
                "flash_decode": layers, "qbits_mm_partitioned": 3 * n_lin,
                **prefill_attention_want(config, T, prefills=2)}
        if counts != {**{n: 0 for n in counts}, **want}:
            raise RuntimeError(f"tp rank {group.rank} {arm}: 2-layer launches {counts}, want {want}")
        keep = kw.get("activations") is not None  # as phase 5's W4A8 arm
        with plain_versions(keep_prefill_kernel=keep):
            plain = run()
        after = read_counts()
        if {n: after[n] - counts[n] for n in after if after[n] != counts[n]} != (
                prefill_attention_want(config, T, prefills=2) if keep else {}):
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
# Phase 16's models at full width and 4 layers (the qint4 and W4A8 Llama-3.1-8B at full depth before
# phases 24 and 25 needed their time).
CKPT_LAYERS = 4
# Phase 16's shard limit: at 4 layers each model holds 1.8-3.6 GB, under `save_pretrained`'s default
# of 5 GiB, so a smaller limit keeps the sharded path (model-0000N-of-0000M files, their index, and
# `from_pretrained` reading across them) on the card; 32 layers of W4A8 (5.81 GB) took it by default.
CKPT_SHARD_SIZE = "1GB"


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


def phase_checkpoint(label: str, build, run, stacked: bool = False, requant: bool = False,
                     max_shard_size=None) -> dict:
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
    requant form and `_s8` (phase 10's conversion). With `max_shard_size`,
    the save must write several shards and their index. Prints one JSON line
    and returns the loaded run's launch counts."""
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
        QuantizedModelForCausalLM(model).save_pretrained(directory, **(
            {"max_shard_size": max_shard_size} if max_shard_size else {}))
        t1 = time.perf_counter()
        sync_and_evict(directory)
        save_s, fsync_s = time.perf_counter() - t0, time.perf_counter() - t1
        shards = [os.path.join(directory, n) for n in os.listdir(directory) if n.endswith(".safetensors")]
        saved = sum(os.path.getsize(p) for p in shards)
        if max_shard_size and (len(shards) < 2 or not os.path.exists(
                os.path.join(directory, "model.safetensors.index.json"))):
            raise RuntimeError(f"checkpoint {label}: {saved / 1e9:.2f} GB saved at max_shard_size "
                               f"{max_shard_size} as {len(shards)} file(s), want several shards and their index")

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
    """Phase 16: `phase_checkpoint` for phase 4's qint4 Llama-3.1-8B and
    phase 7's calibrated W4A8 one (then its requant form), phase 6's qint8
    quantization (TPU #6), and Mixtral-8x7B (qint4), each at full width and
    CKPT_LAYERS layers; Mixtral built with per-expert modules and stacked
    after the load (B = 4 decode: #13 and #15). Each run is its phase's, with
    its launch counts. Returns {model label: the loaded run's launch counts}."""
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.mixtral import MixtralConfig

    config = LlamaConfig(**dict(LLAMA31_8B, num_hidden_layers=CKPT_LAYERS), dtype=torch.bfloat16)
    mixtral4 = MixtralConfig(**dict(MIXTRAL_8X7B, num_hidden_layers=CKPT_LAYERS), dtype=torch.bfloat16)
    L, steps = config.num_hidden_layers, NEW - 1
    n = LINEARS_PER_LAYER * L

    def llama_run(label, want_prefill, want_decode):
        return lambda model, record, when: phase_arm(
            f"checkpoint {label} ({when})", model, ids, want_prefill, want_decode, record=record)

    models = [
        (f"llama-3.1-8b-config qint4+head4 (phase 4), {L} layers", lambda: build_model(config, seed=0)[0],
         {"qbits_mm_tiled": n, "qbits_mm_small_m": 1},
         {"qbits_mm_small_m": (n + 1) * steps, "flash_decode": L * steps}, {}),
        (f"llama-3.1-8b-config w4a8, calibrated, lm_head bf16 (phase 7), {L} layers",
         lambda: build_model(config, seed=0, weights="qint4", activations="qint8", exclude="lm_head")[0],
         {"qbits_mm_tiled_int8": n}, {"qbits_mm_int8_small_m": n * steps, "flash_decode": L * steps},
         {"requant": True}),
        (f"llama-3.1-8b-config qint8, lm_head bf16 (phase 6), {L} layers",
         lambda: build_model(config, seed=0, weights="qint8", exclude="lm_head")[0],
         {}, {"qbytes_mm_int8": n * steps, "flash_decode": L * steps}, {}),
    ]
    t0 = time.perf_counter()
    runs = {label: phase_checkpoint(label, build, llama_run(label, pre, dec), max_shard_size=CKPT_SHARD_SIZE, **kw)
            for label, build, pre, dec, kw in models}
    label = f"mixtral-8x7b-config qint4, lm_head bf16 (phase 8), {L} layers"
    runs[label] = phase_checkpoint(
        label, lambda: build_mixtral(mixtral4, seed=0, stacked=False),
        lambda model, record, when: phase_mixtral(model, mixtral_ids, record=record), stacked=True,
        max_shard_size=CKPT_SHARD_SIZE)
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


def phase_padded(K_mod, flush, shapes=None, m=None):
    """Phase 3, TPU #1, #2 (both arms) and #4 at the linears of SmolLM2-360M
    and Qwen2.5-0.5B that are off the envelope (`PADDED_SHAPES`): a random
    bf16 weight quantized qint4 with its group size and repacked by
    `from_generic`, zero-padded onto the envelope; each kernel on x padded by
    `pad_activations` against its plain version on the same padded operands,
    at the M of `PADDED_M`. The bound counts the true bytes and operations;
    `padded_bytes_ratio` is what the kernel reads beside them, `pad_ms` the
    time of `pad_activations`. Yardstick `torch.matmul` on the true operands
    in bf16. Other `shapes` ({model: [(N, K, group size)]}) and `m`
    ({kernel: M}) in their place (gpt-oss-20b's attention, phase 3)."""
    import quanto_tpu_torch as qtt
    from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6789)
    shapes, m = shapes or PADDED_SHAPES, m or PADDED_M
    sx = torch.tensor(0.0173, device=dev)
    rows = []
    for model_name, model_shapes in shapes.items():
        for N, K, gs in model_shapes:
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
            for name, M in m.items():
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
    else `check_rows` (without `top1`: each row's cosine alone). The
    attention keeps `flash_prefill` in both paths (a deterministic kernel: the
    same inputs give the same bits; it launches there exactly its prefill's
    count), so the EQUAL check holds a route that has no kernel of its own
    (phase 17's W8A8 library calls) to its plain formula, and the W8A8
    activation quantizers see one attention (as phase 5's W4A8 arms); the
    small models' heads of 64 take no fused prefill."""
    from quanto_tpu_torch.models.serve import make_cache, prefill

    before = read_counts()
    with plain_versions(keep_prefill_kernel=True):
        plain_logits, _ = prefill(model, ids, make_cache(model, ids.shape[0], T + NEW), last_only=True)
    torch.cuda.synchronize()
    after = read_counts()
    delta = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    if delta != prefill_attention_want(model.config, ids.shape[1]):
        raise RuntimeError(f"{tag}: the plain forward launched {delta}")
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


# Phase 21: speculative decoding (`models/speculative.py`) on phase 4's prompts (B = 4 x 1024, NEW
# tokens, k = SPEC_K drafts a round). (a) The recipe of the JAX package's speculative bench
# (bench/speculative_bench.py --target qint8): a qint8 target (phase 6's recipe, lm_head bf16) and a
# qint4 draft of the same float weights (phase 4's recipe, lm_head qint4). (b) A layer-skip draft
# (`layerskip_draft`) of the qint4 model's first SPEC_SKIP_LAYERS layers, the qint4 model the target.
# (c) The pair of (a) by rejection sampling at SPEC_SAMPLE (temperature, top-k, top-p). (d) The
# qint8 target as its own draft, so that rounds accept in full (the bonus token, the draft's write at
# pos + k) at full width. The target and its drafts run SPEC_LAYERS of Llama-3.1-8B's 32 layers
# (cut so that the full run keeps its time limit with phases 24 and 25), the layer-skip draft a
# quarter of them, as 8 of 32 before the cut; the readings below are from SPEC_LAYERS layers.
SPEC_LAYERS = 8
SPEC_K, SPEC_SKIP_LAYERS = 4, 2
SPEC_SAMPLE = (0.8, 50, 0.95)
SPEC_DECODE_NEW = 16  # (c): `serve.decode` with the sampler, twice from equal seeds
SPEC_SKIP_BYTES = 1 << 20  # (b): the layer-skip draft adds less than this on the card
# (d): the least acceptance of the target drafting for itself. Its [B, 1] draft steps and its
# [B, k+1] verify sum in other orders (M = 4 against 20, `flash_decode` against the f32 chain), and
# bf16 logits of random weights flip the argmax at about 1 token in 8 between them, so a round
# stops early that often: 0.868 read in two runs (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 4;
# 0.762 at 32 layers, limit 0.65). The limit is 0.85x that reading; a draft cache missing its write
# at pos + k, or a match against shifted predictions, drafts at another position's numerics and
# accepts far less.
SPEC_SELF_ACCEPTANCE = 0.73
# Greedy output held to one prefill of the target over it (`check_forced_argmax`): a row may hold
# at most this many of its NEW tokens that are not that prefill's argmax, each a tie within
# SERVE_TOP1_GAP. The prefill sums in other orders than the verify (M = B T against B (k+1)), so a
# right round parts at such ties: 1-6 a row read in (a), (b) and (d), gaps up to 0.0173, in two runs
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 4; 3-8 at 32 layers, limit 12). The limit is 1.5x
# the largest; a verify that took a wrong draft or the correction from another position parts at
# most of its tokens.
SPEC_FORCED_TIES = 9


def spec_rounds_per_call() -> int:
    """`SpeculativeGenerator.generate`'s R (rounds a call) for NEW tokens."""
    return max(1, -(-NEW // (SPEC_K + 1)))


def spec_cache_lens() -> tuple:
    """Phase 21's cache lengths: one call of R rounds from a prefill
    (`spec_rounds`), and `SpeculativeGenerator.generate`'s worst-case bound
    for NEW tokens."""
    R = spec_rounds_per_call()
    return T + 1 + SPEC_K + R * (SPEC_K + 1), T + 1 + SPEC_K + -(-(NEW - 1) // R) * R * (SPEC_K + 1)


def spec_positions(S: int) -> list:
    """B rows spread from the first decode position T to the last of S
    slots: rows that have accepted different amounts."""
    return [T + (S - 1 - T) * i // (B - 1) for i in range(B)]


def linear_calls(models):
    """A forward pre-hook on every quantized linear of `models` (a module
    shared by two models once) counting its calls by M. Returns (the
    counter, the hooks)."""
    from quanto_tpu_torch.nn import QLinear

    seen = collections.Counter()
    mods = {id(m): m for model in models for m in model.modules() if isinstance(m, QLinear)}
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.update([args[0].numel() // args[0].shape[-1]]))
             for m in mods.values()]
    return seen, hooks


def wall_ms(fn, n: int = 5) -> float:
    """Median wall ms of `fn()` between synchronizations."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


@torch.no_grad()
def spec_rounds(label: str, spec, target, draft, ids, rounds: int, want: dict, want_m: dict, extra=tuple) -> dict:
    """Phase 21: prefill `ids` into both models' caches (each prefill
    timed), then one call of `spec` (R = `rounds` rounds) timed between
    synchronizations, then the same call again under
    `torch.cuda.set_sync_debug_mode("error")` with every kernel's launches
    and the M of every quantized linear's call counted: held to `want` and
    `want_m`, 0 elsewhere. `extra()` gives a call's trailing arguments (a
    sampler's generator). Then where a round's time goes: a draft forward
    and the verify forward (median wall ms between synchronizations), and
    the verify's float32 attention chain (`gqa_attention`, its CUDA-event
    spans summed over the layers). Returns the readings."""
    from quanto_tpu_torch.models import llama as llama_mod
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import make_cache, prefill

    cache_len = spec_cache_lens()[0]
    t_cache, d_cache = make_cache(target, B, cache_len), make_cache(draft, B, cache_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, t_cache = prefill(target, ids, t_cache, last_only=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, d_cache = prefill(draft, ids, d_cache, last_only=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
    spec(first, t_cache, d_cache, T, *extra())
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t2
    args = extra()
    seen, hooks = linear_calls((target, draft))
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blocks, counts, _, _, pos = spec(first, t_cache, d_cache, T, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    launches = read_counts()
    zeros = {n: 0 for n in launches}
    if launches != {**zeros, **want}:
        raise RuntimeError(f"{label}: launches of {rounds} rounds {launches}, want {want} and 0 elsewhere")
    if dict(seen) != want_m:
        raise RuntimeError(f"{label}: quantized linear calls by M {dict(seen)}, want {want_m}")
    if blocks.shape != (B, rounds, SPEC_K + 1) or int(blocks.min()) < 0 or int(blocks.max()) >= target.config.vocab_size:
        raise RuntimeError(f"{label}: blocks of shape {tuple(blocks.shape)} or ids out of the vocabulary")
    if not torch.equal(pos, T + counts.sum(dim=1).to(torch.int32)):
        raise RuntimeError(f"{label}: positions {pos.tolist()} are not the start plus the emitted counts")

    # Where a round's time goes: a draft step, the verify, and the verify's attention chain.
    pos_t = torch.full((B,), T, dtype=torch.int32, device="cuda")
    seq = first.expand(B, SPEC_K + 1).contiguous()
    draft_ms = wall_ms(lambda: draft(first, d_cache, pos_t))
    verify_ms = wall_ms(lambda: target(seq, t_cache, pos_t))
    spans = []
    chain = llama_mod.gqa_attention

    def timed_chain(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = chain(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    llama_mod.gqa_attention = timed_chain
    try:
        target(seq, t_cache, pos_t)
    finally:
        llama_mod.gqa_attention = chain
    torch.cuda.synchronize()
    attention_ms = sum(a.elapsed_time(b) for a, b in spans)
    if len(spans) != target.config.num_hidden_layers:
        raise RuntimeError(f"{label}: the verify ran the attention chain {len(spans)} times")
    ms_per_round = call_s / rounds * 1e3
    return {
        "target_prefill_ms": (t1 - t0) * 1e3, "draft_prefill_ms": (t2 - t1) * 1e3,
        "rounds_per_call": rounds, "ms_per_round": ms_per_round,
        "tokens_per_round_checked_call": float(counts.float().mean()),
        "full_rounds_checked_call": int((counts == SPEC_K + 1).sum()),
        "launches_per_call": {n: c for n, c in launches.items() if c},
        "linear_calls_by_m": {str(m): c for m, c in sorted(seen.items())},
        "round_split": {
            "draft_step_ms": draft_ms, "draft_steps_ms": (SPEC_K + 1) * draft_ms, "verify_ms": verify_ms,
            "verify_attention_chain_ms": attention_ms,
            "draft_steps_share": (SPEC_K + 1) * draft_ms / ((SPEC_K + 1) * draft_ms + verify_ms),
            "note": "each part alone, wall ms between synchronizations (in a round host and card overlap, so "
                    "the parts sum to more than ms_per_round); the attention chain: CUDA-event spans of "
                    "gqa_attention in one verify",
        },
        "no_host_sync": True,
        "launches": launches,
    }


@torch.no_grad()
def check_forced_argmax(label: str, model, out: torch.Tensor) -> list:
    """Phase 21: the emitted tokens out[:, T:] against the argmax of one
    prefill of `model` over out[:, :-1], each token's target given the
    emitted prefix. Where the two differ, their logits must lie within
    SERVE_TOP1_GAP of the position's largest |logit|, and a row may hold at
    most SPEC_FORCED_TIES of them. Returns the ties (each logged)."""
    from quanto_tpu_torch.models.serve import make_cache, prefill

    logits, _ = prefill(model, out[:, :-1], make_cache(model, B, out.shape[1]))
    lv = logits[:, T - 1:].float()  # [B, NEW, V]: the logits each emitted token answers
    del logits
    want = lv.argmax(dim=-1)
    ties = []
    for b, j in (want != out[:, T:]).nonzero().tolist():
        w, g = int(want[b, j]), int(out[b, T + j])
        gap = (lv[b, j, w] - lv[b, j, g]).item() / lv[b, j].abs().max().item()
        ties.append({"request": b, "index": j, "want": w, "got": g, "relative_gap": gap})
        log(json.dumps({"forced_token_tie": label, **ties[-1]}))
    per_row = collections.Counter(t["request"] for t in ties)
    worst = max(ties, key=lambda t: t["relative_gap"], default=None)
    if worst is not None and worst["relative_gap"] > SERVE_TOP1_GAP:
        raise RuntimeError(f"{label}: request {worst['request']}'s token {worst['index']} is {worst['got']}, the "
                           f"target's prefill gives {worst['want']}, and no logit tie ({worst['relative_gap']})")
    if per_row and max(per_row.values()) > SPEC_FORCED_TIES:
        raise RuntimeError(f"{label}: tokens that are not the target's prefill argmax per request {dict(per_row)}, "
                           f"more than {SPEC_FORCED_TIES}")
    return ties


@torch.no_grad()
def spec_generate(label: str, gen, model, ids, want_tokens: torch.Tensor, greedy_mode: bool, **kwargs) -> dict:
    """Phase 21: `gen.generate(ids, NEW)` timed, its shape, ids and
    acceptance checked; in greedy mode its tokens held to `want_tokens` (the
    target's own `generate`), EQUAL or a recorded tie within SERVE_TOP1_GAP
    at the first index where a row parts (`check_same_tokens` over the
    target `model`), and every token to the target's prefill over the
    output (`check_forced_argmax`). Returns the readings."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, acceptance = gen.generate(ids, NEW, **kwargs)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if out.shape != (B, T + NEW) or int(out.min()) < 0 or int(out.max()) >= model.config.vocab_size:
        raise RuntimeError(f"{label}: ids of shape {tuple(out.shape)} or out of the vocabulary")
    if not torch.equal(out[:, :T], ids) or not 0.0 <= acceptance <= 1.0:
        raise RuntimeError(f"{label}: the prompt not kept, or acceptance {acceptance} outside [0, 1]")
    ties, forced = [], []
    if greedy_mode:
        ties = check_same_tokens(label, model, ids.cpu().numpy(), out[:, T:].tolist(), want_tokens.tolist(),
                                 max_len=T + NEW)
        forced = check_forced_argmax(label, model, out)
    return {"acceptance": acceptance, "tokens_per_round": 1 + SPEC_K * acceptance, "generate_s": generate_s,
            "peak_memory_gb": peak / 1e9, "ties": ties, "forced": forced, "tokens": out[:, T:].cpu()}


def phase_speculative(config, ids) -> dict:
    """Phase 21 (see the module docstring). Returns each arm's launches of
    one checked call of R rounds."""
    from quanto_tpu_torch.models.sampling import greedy, make_logits_warp, make_sampler
    from quanto_tpu_torch.models.serve import decode, make_cache, prefill
    from quanto_tpu_torch.models.speculative import (
        SpeculativeGenerator,
        layerskip_draft,
        make_speculative_decode_fn,
        make_speculative_sample_decode_fn,
    )

    t_start = time.perf_counter()
    L, k = config.num_hidden_layers, SPEC_K
    n_lin, steps, skip = LINEARS_PER_LAYER * L, NEW - 1, SPEC_SKIP_LAYERS
    rounds = spec_rounds_per_call()
    fd_decode = {"flash_decode": L * steps}
    out = {}

    def report(arm: str, what: str, target, draft, gen: dict, rnd: dict, target_rate: float, **more) -> None:
        """One JSON line of readings; the round's limit is the weight bytes of its k+1 draft steps
        and its verify at 3.35 TB/s."""
        spec_s = gen["generate_s"] - (rnd["target_prefill_ms"] + rnd["draft_prefill_ms"]) / 1e3
        round_bytes = (k + 1) * step_weight_bytes(draft) + step_weight_bytes(target)
        log(json.dumps({
            "speculative": f"21({arm}) {what}", "batch": B, "prompt": T, "new_tokens": NEW, "k": k,
            "round_weight_bytes": round_bytes, "round_bound_ms": round_bytes / PEAK_BYTES_PER_S * 1e3,
            **{key: v for key, v in gen.items() if key not in ("ties", "forced", "tokens")},
            "token_ties": len(gen["ties"]),
            "forced_ties_per_request": [sum(t["request"] == b for t in gen["forced"]) for b in range(B)],
            "spec_decode_tok_s": B * steps / spec_s, "target_decode_tok_s": target_rate,
            **{key: v for key, v in rnd.items() if key != "launches"}, **more,
        }))
        out[arm] = rnd["launches"]

    # (a) The qint8 target and the qint4 draft, greedy.
    target, _ = build_model(config, seed=0, weights="qint8", exclude="lm_head")
    ref = {}
    phase_arm("spec target: llama-3.1-8b-config qint8 (lm_head bf16), bf16 cache (phase 21)", target, ids,
              want_prefill={}, want_decode={"qbytes_mm_int8": n_lin * steps, **fd_decode}, record=ref)
    draft, _ = build_model(config, seed=0)
    pair_want = {"qbits_mm_small_m": rounds * (k + 1) * (n_lin + 1), "qbytes_mm_int8": rounds * n_lin,
                 "flash_decode": rounds * (k + 1) * L}
    pair_m = {B: rounds * (k + 1) * (n_lin + 1), B * (k + 1): rounds * n_lin}
    gen = spec_generate("phase 21(a)", SpeculativeGenerator(target, draft, k), target, ids, ref["tokens"], True)
    rnd = spec_rounds("phase 21(a)", make_speculative_decode_fn(target, draft, rounds, k), target, draft, ids,
                      rounds, pair_want, pair_m)
    report("a", "qint8 target, qint4 draft (lm_head qint4), greedy", target, draft, gen, rnd, ref["decode_tok_s"])
    pair_tokens = gen["tokens"]

    # (d) The qint8 target as its own draft: rounds that accept every draft. Greedy output does not
    # depend on the draft: every emitted token is the argmax of a verify row, and a row's sums do not
    # depend on the other rows of its call, so (d) is EQUAL to (a) token for token.
    gen = spec_generate("phase 21(d)", SpeculativeGenerator(target, target, k), target, ids, ref["tokens"], True)
    rnd = spec_rounds("phase 21(d)", make_speculative_decode_fn(target, target, rounds, k), target, target, ids,
                      rounds, {"qbytes_mm_int8": rounds * (k + 2) * n_lin, "flash_decode": rounds * (k + 1) * L},
                      {B: rounds * (k + 1) * n_lin, B * (k + 1): rounds * n_lin})
    report("d", "qint8 target drafting for itself, greedy", target, target, gen, rnd, ref["decode_tok_s"])
    if gen["acceptance"] < SPEC_SELF_ACCEPTANCE or rnd["full_rounds_checked_call"] == 0:
        raise RuntimeError(f"phase 21(d): acceptance {gen['acceptance']} below {SPEC_SELF_ACCEPTANCE}, or no round "
                           "of the checked call accepted every draft")
    if not torch.equal(gen["tokens"], pair_tokens):
        raise RuntimeError("phase 21(d): the self-drafted tokens are not (a)'s: the greedy output moved with the draft")

    # (c) The same pair by rejection sampling, then the target's sampled decode.
    warp = make_logits_warp(*SPEC_SAMPLE)
    gen = spec_generate("phase 21(c)", SpeculativeGenerator(target, draft, k, *SPEC_SAMPLE), target, ids, None,
                        False, generator=torch.Generator("cuda").manual_seed(21))
    rnd = spec_rounds("phase 21(c)", make_speculative_sample_decode_fn(target, draft, rounds, k, warp), target,
                      draft, ids, rounds, pair_want, pair_m,
                      extra=lambda: (torch.Generator("cuda").manual_seed(22),))
    runs = []
    for _ in range(2):
        cache = make_cache(target, B, T + 1 + SPEC_DECODE_NEW)
        logits, cache = prefill(target, ids, cache, last_only=True)
        first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
        toks, _ = decode(target, first, cache, T, SPEC_DECODE_NEW, sample_fn=make_sampler(*SPEC_SAMPLE),
                         generator=torch.Generator("cuda").manual_seed(23))
        runs.append(toks)
    if not torch.equal(runs[0], runs[1]) or int(runs[0].min()) < 0 or int(runs[0].max()) >= config.vocab_size:
        raise RuntimeError("phase 21(c): serve.decode with a sampler gave other tokens from equal seeds, or ids "
                           "out of the vocabulary")
    report("c", f"qint8 target, qint4 draft, sampled (temperature, top_k, top_p) = {SPEC_SAMPLE}", target, draft,
           gen, rnd, ref["decode_tok_s"], sampled_decode_repeats=True)
    del target, gen, ref
    gc.collect()
    torch.cuda.empty_cache()

    # (b) A layer-skip draft of the qint4 model, which is the target.
    target = draft
    ref = {}
    phase_arm("spec target: llama-3.1-8b-config qint4+head4, bf16 cache (phase 21)", target, ids,
              want_prefill={"qbits_mm_tiled": n_lin, "qbits_mm_small_m": 1},
              want_decode={"qbits_mm_small_m": (n_lin + 1) * steps, **fd_decode}, record=ref)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    draft = layerskip_draft(target, skip)
    torch.cuda.synchronize()
    added = torch.cuda.memory_allocated() - before
    if added >= SPEC_SKIP_BYTES:
        raise RuntimeError(f"phase 21(b): the layer-skip draft added {added} bytes on the card")
    shared = (draft.model.layers[skip - 1].mlp.down_proj.weight._packed.data_ptr()
              == target.model.layers[skip - 1].mlp.down_proj.weight._packed.data_ptr()
              and draft.lm_head.weight._packed.data_ptr() == target.lm_head.weight._packed.data_ptr())
    if not shared or len(draft.model.layers) != skip or len(make_cache(draft, 1, 1)) != skip:
        raise RuntimeError("phase 21(b): the layer-skip draft does not share the target's weights or depth")
    n_skip = LINEARS_PER_LAYER * skip + 1
    gen = spec_generate("phase 21(b)", SpeculativeGenerator(target, draft, k), target, ids, ref["tokens"], True)
    rnd = spec_rounds("phase 21(b)", make_speculative_decode_fn(target, draft, rounds, k), target, draft, ids,
                      rounds, {"qbits_mm_small_m": rounds * ((k + 1) * n_skip + n_lin + 1),
                               "flash_decode": rounds * (k + 1) * skip},
                      {B: rounds * (k + 1) * n_skip, B * (k + 1): rounds * (n_lin + 1)})
    report("b", f"qint4 target, layer-skip draft of its first {skip} layers, greedy", target, draft, gen, rnd,
           ref["decode_tok_s"], draft_added_bytes=added)
    del target, draft, gen, ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"speculative: phase 21 took {time.perf_counter() - t_start:.1f} s")
    return out


def build_gemma(seed: int):
    """Phase 22's model: google/gemma-7b's config.json through `from_hf`, built
    on "meta" and materialized on the card one decoder layer at a time, each
    quantized to qint4 (group size 128) and frozen as soon as its weights are
    drawn; the tied embedding (which is also the head) stays bf16."""
    from quanto_tpu_torch import freeze, quantize
    from quanto_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from quanto_tpu_torch.nn import QLinear
    from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

    config = LlamaConfig.from_hf(dict(GEMMA_7B, num_hidden_layers=GEMMA_7B_LAYERS), dtype=torch.bfloat16)
    if not (config.rms_norm_unit_offset and config.scale_embeddings and config.tie_word_embeddings
            and config.hidden_act == "gelu" and config.head_dim == 256):
        raise RuntimeError(f"from_hf did not read google/gemma-7b's options: {config}")

    def per_layer(layer):
        quantize(layer, weights="qint4")
        freeze(layer)

    model = LlamaForCausalLM(config, device="meta")
    model.materialize_("cuda", torch.Generator("cuda").manual_seed(seed), layer_fn=per_layer)
    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    if model.lm_head is not None or len(qlinears) != LINEARS_PER_LAYER * config.num_hidden_layers or not all(
            isinstance(m.weight, WeightQBitsHopperArray) and m.weight.bits == 4 for m in qlinears):
        raise RuntimeError(f"gemma-7b: expected {LINEARS_PER_LAYER * config.num_hidden_layers} qint4 linears in the "
                           "Hopper layout and a tied head")
    return model


@torch.no_grad()
def phase_gemma() -> dict:
    """Phase 22: Gemma-7B (google/gemma-7b config.json: 16 heads and 16 kv
    heads of 256, tied embeddings scaled by sqrt(3072), the unit-offset
    RMSNorm, the tanh GELU) at full width and GEMMA_7B_LAYERS of its 28
    layers, random weights from a seed, qint4 (group size 128; the tied
    embedding bf16). B = 4 prompts of 1024 tokens: prefill (last position
    only) and 63 greedy decode steps, over a bf16 cache and over a qint4
    cache, each after a warm-up, with exact launches: the prefill 7
    `qbits_mm_tiled` and one `flash_prefill` (TPU #16 at D = 256) a layer,
    each step 7 `qbits_mm_small_m` and one `flash_decode` at D = 256 a
    layer, nothing else. Then the same model
    through the plain versions (no kernel launched): the prefill's
    last-position logits, each row's cosine above GEMMA_E2E_COS, and its 63
    greedy steps, whose tokens must equal the kernel path's or part from
    them at a logit tie within SERVE_TOP1_GAP (`check_same_tokens`). Prints
    prefill ms, decode ms/step and peak memory beside their bounds. Returns
    each cache's launch counts."""
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, make_cache, prefill

    t0 = time.perf_counter()
    model = build_gemma(seed=22)
    torch.cuda.synchronize()
    config = model.config
    L, steps = config.num_hidden_layers, NEW - 1
    n_lin = LINEARS_PER_LAYER * L
    log(f"gemma: built on meta, then {L} layers materialized + quantized + frozen one at a time in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    ids = torch.randint(0, config.vocab_size, (B, T), generator=torch.Generator().manual_seed(22)).cuda()
    want_pre = {"qbits_mm_tiled": n_lin, "flash_prefill": L}
    want_dec = {"qbits_mm_small_m": n_lin * steps, "flash_decode": L * steps}
    Hkv, D = config.num_key_value_heads, config.head_dim
    weight_bytes = step_weight_bytes(model)
    prefill_ops = linears_operations(model, B * T) + 2 * B * config.num_attention_heads * T * T * D
    out = {}

    def run(kv):
        logits, cache = prefill(model, ids, make_cache(model, B, T + NEW, kv_quant=kv), last_only=True)
        first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
        rest, _ = decode(model, first, cache, T, steps)
        return logits, torch.cat([first, rest], dim=1)

    for kv in (None, "qint4"):
        label = f"gemma-7b qint4 (tied embedding bf16), {kv or 'bf16'} cache"
        run(kv)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        cache = make_cache(model, B, T + NEW, kv_quant=kv)
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
        if pre != {**zeros, **want_pre}:
            raise RuntimeError(f"{label}: prefill launches {pre}, want {want_pre} and 0 elsewhere")
        if dec != {**zeros, **want_dec}:
            raise RuntimeError(f"{label}: decode launches {dec}, want {want_dec} and 0 elsewhere")
        if logits.shape != (B, 1, config.vocab_size) or not torch.isfinite(logits).all():
            raise RuntimeError(f"{label}: prefill logits: shape {tuple(logits.shape)} or non-finite values")
        tokens = torch.cat([first, rest], dim=1)
        if int(tokens.min()) < 0 or int(tokens.max()) >= config.vocab_size:
            raise RuntimeError(f"{label}: decoded token ids out of the vocabulary")
        kv_row = sum(t[0, 0].numel() * t.element_size() for t in (
            (cache[0][0], cache[0][1]) if kv is None else
            (cache[0]._k_data, cache[0]._v_data, cache[0]._k_scale, cache[0]._v_scale)))
        mean_fill = T + 1 + (steps - 1) / 2
        kv_step_bytes = B * mean_fill * kv_row * L
        with plain_versions():
            plain_logits, plain_tokens = run(kv)
            torch.cuda.synchronize()
            if read_counts() != launches:
                raise RuntimeError(f"{label}: the plain forward launched a kernel")
            cos = F.cosine_similarity(logits[:, -1].float(), plain_logits[:, -1].float(), dim=-1)
            ties = check_same_tokens(f"phase 22 {label}", model, ids.cpu().numpy(), tokens.tolist(),
                                     plain_tokens.tolist(), kv_quant=kv, max_len=T + NEW)
        if read_counts() != launches:
            raise RuntimeError(f"{label}: the plain tie check launched a kernel")
        log(json.dumps({
            "gemma": label, "batch": B, "prompt": T, "new_tokens": NEW, "decode_steps": steps,
            "prefill_ms": prefill_s * 1e3, "prefill_operations": prefill_ops,
            "prefill_bound_ms": prefill_ops / PEAK_BF16_FLOPS * 1e3,
            "decode_ms_per_step": decode_s / steps * 1e3, "decode_tok_s": B * steps / decode_s,
            "decode_step_weight_bytes": weight_bytes, "decode_step_kv_bytes": kv_step_bytes,
            "decode_step_bound_ms": (weight_bytes + kv_step_bytes) / PEAK_BYTES_PER_S * 1e3,
            "peak_memory_gb": peak_gb, "model_bytes": torch.cuda.memory_allocated(),
            "prefill_launches": {n: c for n, c in pre.items() if c},
            "decode_launches": {n: c for n, c in dec.items() if c},
            "cosine_vs_plain": cos.tolist(), "top1_kernel": logits[:, -1].argmax(-1).tolist(),
            "top1_plain": plain_logits[:, -1].argmax(-1).tolist(), "token_ties": ties,
            "tokens_equal_plain": bool(torch.equal(tokens, plain_tokens)),
        }))
        if not bool((cos > GEMMA_E2E_COS).all()):
            raise RuntimeError(f"{label}: kernel vs plain prefill logits cosine {cos.tolist()} <= {GEMMA_E2E_COS}")
        out[kv or "bf16"] = launches
        del cache, logits, plain_logits
        gc.collect()
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def build_gemma2(seed: int):
    """Phase 23's model: google/gemma-2-9b's config.json through
    `Gemma2Config.from_hf`, built on "meta" and materialized on the card one
    decoder layer at a time, each quantized to qint4 (group size 128) and
    frozen as soon as its weights are drawn; the tied embedding (also the
    head) stays bf16."""
    from quanto_tpu_torch import freeze, quantize
    from quanto_tpu_torch.models import Gemma2Config, Gemma2ForCausalLM
    from quanto_tpu_torch.nn import QLinear
    from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

    config = Gemma2Config.from_hf(GEMMA2_9B, dtype=torch.bfloat16)
    sliding = sum(t == "sliding_attention" for t in config.layer_types)
    if not (config.head_dim == 256 and config.tie_word_embeddings and config.sliding_window == 4096
            and sliding == 21 and config.query_pre_attn_scalar == 256 and config.attn_logit_softcapping == 50.0):
        raise RuntimeError(f"Gemma2Config.from_hf did not read google/gemma-2-9b's options: {config}")

    def per_layer(layer):
        quantize(layer, weights="qint4")
        freeze(layer)

    model = Gemma2ForCausalLM(config, device="meta")
    model.materialize_("cuda", torch.Generator("cuda").manual_seed(seed), layer_fn=per_layer)
    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    if model.lm_head is not None or len(qlinears) != LINEARS_PER_LAYER * config.num_hidden_layers or not all(
            isinstance(m.weight, WeightQBitsHopperArray) and m.weight.bits == 4 for m in qlinears):
        raise RuntimeError("gemma-2-9b: expected 294 qint4 linears in the Hopper layout and a tied head")
    return model


@torch.no_grad()
def measured_run(label: str, model, batch_ids, new_cache, steps: int, want_pre: dict, want_dec: dict,
                 tally=None) -> tuple:
    """One measured prefill (last position) + `steps` greedy decode steps
    over `new_cache()`, made after the launch counts, `tally` (pre-hook
    counts) and the peak memory are reset: exact launches of each half
    (`check_counts`), finite logits of the right shape, tokens in the
    vocabulary. Returns (logits, tokens, cache, {prefill_s, decode_s, pre,
    dec, pre_tally, dec_tally, peak_gb})."""
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, prefill

    vocab = model.config.vocab_size
    Bn, Tn = batch_ids.shape
    tally = {} if tally is None else tally
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for k in tally:
        tally[k] = 0
    cache = new_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(model, batch_ids, cache, last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre, pre_tally = read_counts(), dict(tally)
    first = greedy(logits[:, -1]).to(batch_ids.dtype)[:, None]
    t0 = time.perf_counter()
    rest, cache = decode(model, first, cache, Tn, steps)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read_counts()
    dec = {n: launches[n] - pre[n] for n in launches}
    check_counts(f"{label} prefill", pre, want_pre)
    check_counts(f"{label} decode", dec, want_dec)
    tokens = torch.cat([first, rest], dim=1)
    if logits.shape != (Bn, 1, vocab) or not torch.isfinite(logits).all():
        raise RuntimeError(f"{label}: prefill logits: shape {tuple(logits.shape)} or non-finite values")
    if int(tokens.min()) < 0 or int(tokens.max()) >= vocab:
        raise RuntimeError(f"{label}: decoded token ids out of the vocabulary")
    return logits, tokens, cache, {
        "prefill_s": prefill_s, "decode_s": decode_s, "pre": pre, "dec": dec, "pre_tally": pre_tally,
        "dec_tally": {k: tally[k] - pre_tally.get(k, 0) for k in tally},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


@torch.no_grad()
def sliding_measured(model, tally, tag: str, label: str, batch_ids, max_len: int, kv, sliding_ring: bool,
                     want_pre: dict, want_dec: dict, steps: int):
    """`measured_run` of a sliding-window model (phases 23 and 24) over a
    fresh cache (`kv`, rings where `sliding_ring`), with the attention tally
    (`attention_tally`) of each half, times and peak memory beside their
    bounds. Returns (prefill logits, tokens, the decode half's tally, a
    record whose `tag` key holds the label)."""
    from quanto_tpu_torch.models.serve import make_cache
    from quanto_tpu_torch.tensor.kv_cache import QKVCacheLayer, cache_max_len

    config = model.config
    L = config.num_hidden_layers
    D, H = config.head_dim, config.num_attention_heads
    Bn, Tn = batch_ids.shape
    logits, tokens, cache, run = measured_run(
        label, model, batch_ids, lambda: make_cache(model, Bn, max_len, kv_quant=kv, sliding_ring=sliding_ring),
        steps, want_pre, want_dec, tally)
    layers = [cache[i] for i in range(L)]

    def row_bytes(c):  # K and V bytes of one slot of one layer, all heads
        ts = (c[0], c[1]) if not isinstance(c, QKVCacheLayer) else (c._k_data, c._v_data, c._k_scale, c._v_scale)
        return sum(t[0, 0].numel() * t.element_size() for t in ts)

    # A decode step reads each layer's visible slots: a sliding layer's window at most.
    mean_pos = Tn + (steps - 1) / 2
    kv_step_bytes = Bn * sum(row_bytes(c) * (min(mean_pos + 1, config.sliding_window)
                                             if t == "sliding_attention" else mean_pos + 1)
                             for c, t in zip(layers, config.layer_types))
    weight_bytes = step_weight_bytes(model)
    prefill_ops = linears_operations(model, Bn * Tn) + 2 * Bn * H * Tn * Tn * D * L
    rec = {
        tag: label, "batch": Bn, "prompt": Tn, "new_tokens": steps + 1, "decode_steps": steps,
        # The slots of the first sliding layer's cache and of the first full layer's.
        "cache_slots": [cache_max_len(layers[config.layer_types.index(t)]) for t in ("sliding_attention",
                                                                                   "full_attention")],
        "prefill_ms": run["prefill_s"] * 1e3, "prefill_operations": prefill_ops,
        "prefill_bound_ms": prefill_ops / PEAK_BF16_FLOPS * 1e3,
        "decode_ms_per_step": run["decode_s"] / steps * 1e3, "decode_tok_s": Bn * steps / run["decode_s"],
        "decode_step_weight_bytes": weight_bytes, "decode_step_kv_bytes": kv_step_bytes,
        "decode_step_bound_ms": (weight_bytes + kv_step_bytes) / PEAK_BYTES_PER_S * 1e3,
        "peak_memory_gb": run["peak_gb"],
        "model_bytes": torch.cuda.memory_allocated(),
        "prefill_launches": {n: c for n, c in run["pre"].items() if c},
        "decode_launches": {n: c for n, c in run["dec"].items() if c},
        "prefill_attention": run["pre_tally"], "decode_attention": run["dec_tally"],
    }
    del cache
    return logits, tokens, run["dec_tally"], rec


def attention_tally(model):
    """Pre-hooks on every Gemma-2 attention: the T == 1 calls (decode steps)
    over a ring and with a window, and the T > 1 calls over a ring. Returns
    (tally dict, the hooks' handles)."""
    tally = {"decode": 0, "decode_ring": 0, "decode_window": 0, "chunk_ring": 0}

    def hook(module, args, kwargs):
        if args[4] is None:  # no cache
            return
        step = args[0].shape[1] == 1
        tally["decode" if step else "chunk"] = tally.get("decode" if step else "chunk", 0) + 1
        if kwargs.get("ring"):
            tally["decode_ring" if step else "chunk_ring"] += 1
        if step and kwargs.get("window"):
            tally["decode_window"] += 1

    handles = [layer.self_attn.register_forward_pre_hook(hook, with_kwargs=True) for layer in model.model.layers]
    return tally, handles


def check_counts(label: str, got: dict, want: dict) -> None:
    zeros = {n: 0 for n in got}
    if got != {**zeros, **want}:
        raise RuntimeError(f"{label}: launches {got}, want {want} and 0 elsewhere")


@torch.no_grad()
def phase_gemma2() -> dict:
    """Phase 23: Gemma-2-9B (google/gemma-2-9b config.json: 42 layers of 16
    heads over 8 kv heads of 256, the softcaps 50 and 30, a window of 4096
    on the 21 even layers, tied embeddings) at full depth and width, random
    weights (seed 23), qint4 (group size 128; the tied embedding bf16).

    (a) B = 4 x 1024 prompts + NEW greedy tokens over a bf16 cache of 1088
    slots (no ring: max_len <= W): after a warm-up, exact launches (each
    prefill 294 `qbits_mm_tiled` and 42 `flash_prefill`, each step 294
    `qbits_mm_small_m` and 42 `flash_decode`), then the plain versions:
    each row's last-position logits within GEMMA2_E2E_COS, tokens equal or
    at a recorded tie. (b) B = 1 x G2_LONG + NEW over a qint4 cache with
    rings (max_len > W: the sliding layers hold 4096-slot rings that the
    decode wraps): the prefill 21 `flash_prefill` (the full layers; the
    rings take the concatenation chain), each step 42 `flash_decode`, 21 of
    them over rings. (c) (b) over flat caches: 21 `flash_prefill` (the
    sliding layers take the chain with the window's mask, T > W), each step
    42 `flash_decode`, 21 with window 4096; (b) and (c) agree within
    GEMMA2_RING_COS, tokens equal or at recorded ties. (d) `BatchedEngine`
    over G2_ENGINE_PROMPTS (batched [4, 512] chunks, whose last chunks
    `write_len` masks in the rings), each request's tokens equal to its own
    `generate` or at recorded ties; then serial admission in the dense
    engine and in `PagedEngine` (the paged+ring hybrid, pages of 64), whose
    tokens must equal each other's (or recorded ties). Prints prefill ms,
    decode ms/step and peak memory beside their bounds. Returns each arm's
    launch counts."""
    from quanto_tpu_torch.models import BatchedEngine, PagedEngine
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, generate, make_cache, prefill

    t_start = time.perf_counter()
    model = build_gemma2(seed=23)
    torch.cuda.synchronize()
    config = model.config
    L, steps = config.num_hidden_layers, NEW - 1
    n_lin, half = LINEARS_PER_LAYER * L, L // 2
    log(f"gemma2: built on meta, then {L} layers materialized + quantized + frozen one at a time in "
        f"{time.perf_counter() - t_start:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    ids = torch.randint(0, config.vocab_size, (B, T), generator=torch.Generator().manual_seed(23)).cuda()
    tally, handles = attention_tally(model)
    out = {}

    def run(batch_ids, max_len, kv=None, sliding_ring=True, n_steps=steps):
        cache = make_cache(model, batch_ids.shape[0], max_len, kv_quant=kv, sliding_ring=sliding_ring)
        logits, cache = prefill(model, batch_ids, cache, last_only=True)
        first = greedy(logits[:, -1]).to(batch_ids.dtype)[:, None]
        rest, cache = decode(model, first, cache, batch_ids.shape[1], n_steps)
        return logits, torch.cat([first, rest], dim=1), cache

    # (a) B = 4 x 1024 over a bf16 cache of T + NEW slots: no ring.
    label = "gemma-2-9b qint4 (tied embedding bf16), bf16 cache, B = 4 x 1024"
    want_pre = {"qbits_mm_tiled": n_lin, "flash_prefill": L}
    want_dec = {"qbits_mm_small_m": n_lin * steps, "flash_decode": L * steps}
    run(ids, T + NEW)  # warm-up
    logits, tokens, dec_tally, rec = sliding_measured(model, tally, "gemma2", label, ids, T + NEW, None, True,
                                                      want_pre, want_dec, steps)
    if dec_tally["decode_ring"] or dec_tally["decode_window"] != half * steps:
        raise RuntimeError(f"{label}: decode attention {dec_tally}, want {half * steps} with the window, none over rings")
    launches_a = read_counts()
    with plain_versions():
        plain_logits, plain_tokens, _ = run(ids, T + NEW, n_steps=PLAIN_NEW - 1)
        torch.cuda.synchronize()
        if read_counts() != launches_a:
            raise RuntimeError(f"{label}: the plain forward launched a kernel")
        cos = F.cosine_similarity(logits[:, -1].float(), plain_logits[:, -1].float(), dim=-1)
        ties = check_same_tokens(f"phase 23(a) {label}", model, ids.cpu().numpy(), tokens[:, :PLAIN_NEW].tolist(),
                                 plain_tokens.tolist(), max_len=T + NEW)
    if read_counts() != launches_a:
        raise RuntimeError(f"{label}: the plain tie check launched a kernel")
    rec.update({"cosine_vs_plain": cos.tolist(), "token_ties": ties,
                "tokens_equal_plain": bool(torch.equal(tokens[:, :PLAIN_NEW], plain_tokens))})
    log(json.dumps(rec))
    if not bool((cos > GEMMA2_E2E_COS).all()):
        raise RuntimeError(f"{label}: kernel vs plain prefill logits cosine {cos.tolist()} <= {GEMMA2_E2E_COS}")
    out["a"] = launches_a
    del logits, plain_logits

    # (b) and (c): one prompt past the window over a qint4 cache, with rings and flat.
    long_ids = torch.randint(0, config.vocab_size, (1, G2_LONG), generator=torch.Generator().manual_seed(230)).cuda()
    res = {}
    for arm, ring in (("b", True), ("c", False)):
        label = f"gemma-2-9b qint4, qint4 cache, B = 1 x {G2_LONG}, {'rings' if ring else 'flat caches'}"
        want_pre = {"qbits_mm_tiled": n_lin, "flash_prefill": half}
        want_dec = {"qbits_mm_small_m": n_lin * steps, "flash_decode": L * steps}
        logits, tokens, dec_tally, rec = sliding_measured(model, tally, "gemma2", label, long_ids, G2_LONG + NEW,
                                                          "qint4", ring, want_pre, want_dec, steps)
        want_tally = {"decode": L * steps, "decode_ring": half * steps if ring else 0,
                      "decode_window": 0 if ring else half * steps, "chunk_ring": 0}
        if {k: dec_tally.get(k, 0) for k in want_tally} != want_tally:
            raise RuntimeError(f"{label}: decode attention {dec_tally}, want {want_tally}")
        if rec["prefill_attention"].get("chunk_ring", 0) != (half if ring else 0):
            raise RuntimeError(f"{label}: prefill attention {rec['prefill_attention']}")
        if rec["cache_slots"] != [config.sliding_window if ring else G2_LONG + NEW, G2_LONG + NEW]:
            raise RuntimeError(f"{label}: layer cache slots {rec['cache_slots']}")
        log(json.dumps(rec))
        res[arm] = (logits, tokens)
        out[arm] = read_counts()
    cos = F.cosine_similarity(res["b"][0][:, -1].float(), res["c"][0][:, -1].float(), dim=-1)
    ties = check_same_tokens("phase 23 (b) vs (c)", model, long_ids.cpu().numpy(), res["b"][1].tolist(),
                             res["c"][1].tolist(), kv_quant="qint4", max_len=G2_LONG + NEW)
    log(json.dumps({"gemma2_ring_vs_flat": {"cosine": cos.tolist(), "token_ties": ties,
                                            "tokens_equal": bool(torch.equal(res["b"][1], res["c"][1]))}}))
    if not bool((cos > GEMMA2_RING_COS).all()):
        raise RuntimeError(f"phase 23: ring vs flat prefill logits cosine {cos.tolist()} <= {GEMMA2_RING_COS}")
    del res
    for h in handles:
        h.remove()

    # (d) the engines over the serving bench's long-context shape.
    rng = np.random.default_rng(231)
    prompts = [rng.integers(0, config.vocab_size, n).astype(np.int64) for n in G2_ENGINE_PROMPTS]
    C, new, max_len = G2_ENGINE_CHUNK, G2_ENGINE_NEW, G2_ENGINE_MAX_LEN
    n_chunks = [-(-n // C) for n in G2_ENGINE_PROMPTS]
    kw = dict(max_batch=len(prompts), max_len=max_len, prefill_chunk=C)

    def serve(engine, batched: bool):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = engine.add_batch(prompts, new) if batched else [engine.add(p, new) for p in prompts]
        engine.run_to_completion()
        torch.cuda.synchronize()
        return [engine.result(r) for r in rids], read_counts(), time.perf_counter() - t0

    engine = BatchedEngine(model, **kw)
    if not isinstance(engine._cache[0], tuple) or engine._cache[0][0].shape[1] != config.sliding_window:
        raise RuntimeError("phase 23(d): the dense engine's sliding layers hold no rings")
    got_batch, counts_batch, s_batch = serve(engine, True)
    dec_steps = new - 1
    check_counts("phase 23(d) batch arm", counts_batch, {
        "qbits_mm_tiled": n_lin * max(n_chunks), "qbits_mm_small_m": n_lin * dec_steps, "flash_decode": L * dec_steps})
    want = [generate(model, torch.tensor(p[None], device="cuda"), new)[0, len(p):].tolist() for p in prompts]
    ties_batch = check_same_tokens("phase 23(d) batch arm vs generate", model, prompts, got_batch, want,
                                   max_len=max_len)
    got_serial, counts_serial, s_serial = serve(engine, False)
    check_counts("phase 23(d) serial arm", counts_serial, {
        "qbits_mm_small_m": n_lin * (sum(n_chunks) + dec_steps), "flash_decode": L * dec_steps})
    del engine
    paged = PagedEngine(model, n_pages=1 + len(prompts) * -(-max_len // 64), page_size=64, **kw)
    if paged.prefix_sharing or not isinstance(paged._cache[0], tuple) or \
            paged._cache[0][0].shape[1] != config.sliding_window or not hasattr(paged._cache[1], "_table"):
        raise RuntimeError("phase 23(d): PagedEngine did not build the paged+ring hybrid")
    got_paged, counts_paged, s_paged = serve(paged, False)
    check_counts("phase 23(d) paged arm", counts_paged, {
        "qbits_mm_small_m": n_lin * (sum(n_chunks) + dec_steps), "flash_decode": half * dec_steps,
        "flash_decode_paged": half * dec_steps})
    ties_paged = check_same_tokens("phase 23(d) paged vs dense", model, prompts, got_paged, got_serial,
                                   max_len=max_len)
    log(json.dumps({"gemma2_engines": {
        "prompts": G2_ENGINE_PROMPTS, "chunk": C, "new_tokens": new, "max_len": max_len,
        "batch_s": s_batch, "serial_s": s_serial, "paged_s": s_paged,
        "batch_vs_generate_ties": ties_batch, "batch_equal_generate": got_batch == want,
        "paged_vs_serial_ties": ties_paged, "paged_equal_serial": got_paged == got_serial,
        "launches": {arm: {n: c for n, c in counts.items() if c} for arm, counts in
                     (("batch", counts_batch), ("serial", counts_serial), ("paged", counts_paged))},
    }}))
    out["d_batch"], out["d_paged"] = counts_batch, counts_paged
    del paged, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"gemma2: phase 23 took {time.perf_counter() - t_start:.1f} s")
    return out


def build_qk_norm_model(hf_config: dict, seed: int, per_layer, layers=None):
    """A model of the QK-norm families from its `config.json` dict through
    `build_model` (a nested gemma3 config through its `text_config`), cut to
    `layers` decoder layers where given, on "meta", then materialized on the
    card one decoder layer at a time, `per_layer` quantizing and freezing
    each (and stacking its experts) as soon as its weights are drawn. Returns
    (model, build seconds)."""
    from quanto_tpu_torch.models.transformers_models import build_model

    t0 = time.perf_counter()
    if layers is not None:
        hf_config = dict(hf_config, num_hidden_layers=layers)
    model = build_model(hf_config, dtype=torch.bfloat16)
    model.materialize_("cuda", torch.Generator("cuda").manual_seed(seed), layer_fn=per_layer)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def qint4_layer(layer) -> None:
    from quanto_tpu_torch import freeze, quantize

    quantize(layer, weights="qint4")
    freeze(layer)


def check_qint4_linears(label: str, model, want: int) -> None:
    from quanto_tpu_torch.nn import QLinear
    from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    if len(qlinears) != want or not all(isinstance(m.weight, WeightQBitsHopperArray) and m.weight.bits == 4
                                        and m.weight.pad is None for m in qlinears):
        raise RuntimeError(f"{label}: expected {want} qint4 linears in the Hopper layout, on the envelope")


@torch.no_grad()
def phase_gemma3() -> dict:
    """Phase 24: Gemma-3-12B (google/gemma-3-12b-pt's text_config: 48 layers
    of 16 heads over 8 kv heads of 256, q/k norms, the dual rope, a window of
    1024 on 40 layers in the 5:1 pattern, tied embeddings) at full depth and
    width, random weights (seed 24), qint4 (group size 128; the tied
    embedding bf16).

    (a) B = 4 x 1024 prompts + NEW greedy tokens over a bf16 cache of T + NEW
    slots: max_len > W, so the 40 sliding layers hold 1024-slot rings that the
    decode wraps. After a warm-up, exact launches: the prefill 336
    `qbits_mm_tiled` and 8 `flash_prefill` (the full layers; a ring layer
    takes the concatenation chain), each step 336 `qbits_mm_small_m` and 48
    `flash_decode`, 40 of them over rings. Then the plain versions: each row's
    last-position logits within GEMMA3_E2E_COS, tokens equal or at a recorded
    tie. (b) The same prompts over flat caches, G3_FLAT_NEW new: the prefill
    48 `flash_prefill` (W >= T), each step 48 `flash_decode`, 40 with the
    window; against (a) within GEMMA3_RING_COS, tokens equal or at recorded
    ties. (c) `BatchedEngine` over G3_ENGINE_PROMPTS (batched [4, 512]
    chunks, their last ones masked by `write_len` in the rings) and
    `PagedEngine` (the paged+ring hybrid, pages of 64, serial admission),
    each request's tokens equal to its own `generate` or at recorded ties.
    Returns each arm's launch counts."""
    from quanto_tpu_torch.models import BatchedEngine, Gemma3ForCausalLM, PagedEngine
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, generate, make_cache, prefill

    t_start = time.perf_counter()
    model, build_s = build_qk_norm_model(GEMMA3_12B, 24, qint4_layer)
    config = model.config
    L, W = config.num_hidden_layers, config.sliding_window
    n_lin = LINEARS_PER_LAYER * L
    full = config.layer_types.count("full_attention")
    sliding = L - full
    if not (isinstance(model, Gemma3ForCausalLM) and model.lm_head is None and W == 1024 and full == 8
            and config.rope_scaling_factor == 8.0 and config.query_pre_attn_scalar == 256):
        raise RuntimeError(f"build_model did not read google/gemma-3-12b's text_config: {config}")
    check_qint4_linears("gemma-3-12b", model, n_lin)
    log(f"gemma3: built on meta, then {L} layers materialized + quantized + frozen one at a time in "
        f"{build_s:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    ids = torch.randint(0, config.vocab_size, (B, T), generator=torch.Generator().manual_seed(24)).cuda()
    tally, handles = attention_tally(model)
    out = {}

    def run(batch_ids, max_len, steps, sliding_ring=True):
        cache = make_cache(model, batch_ids.shape[0], max_len, sliding_ring=sliding_ring)
        logits, cache = prefill(model, batch_ids, cache, last_only=True)
        first = greedy(logits[:, -1]).to(batch_ids.dtype)[:, None]
        rest, _ = decode(model, first, cache, batch_ids.shape[1], steps)
        return logits, torch.cat([first, rest], dim=1)

    # (a) rings: max_len T + NEW passes W.
    steps = NEW - 1
    label = "gemma-3-12b qint4 (tied embedding bf16), bf16 cache with rings, B = 4 x 1024"
    want_pre = {"qbits_mm_tiled": n_lin, "flash_prefill": full}
    want_dec = {"qbits_mm_small_m": n_lin * steps, "flash_decode": L * steps}
    run(ids, T + NEW, steps)  # warm-up
    logits, tokens, dec_tally, rec = sliding_measured(model, tally, "gemma3", label, ids, T + NEW, None, True,
                                                      want_pre, want_dec, steps)
    want_tally = {"decode": L * steps, "decode_ring": sliding * steps, "decode_window": 0, "chunk_ring": 0}
    if {k: dec_tally.get(k, 0) for k in want_tally} != want_tally or \
            rec["prefill_attention"].get("chunk_ring") != sliding or rec["cache_slots"] != [W, T + NEW]:
        raise RuntimeError(f"{label}: decode attention {dec_tally}, prefill {rec['prefill_attention']}, "
                           f"cache slots {rec['cache_slots']}")
    launches_a = read_counts()
    with plain_versions():
        plain_logits, plain_tokens = run(ids, T + NEW, PLAIN_NEW - 1)
        torch.cuda.synchronize()
        if read_counts() != launches_a:
            raise RuntimeError(f"{label}: the plain forward launched a kernel")
        cos = F.cosine_similarity(logits[:, -1].float(), plain_logits[:, -1].float(), dim=-1)
        ties = check_same_tokens(f"phase 24(a) {label}", model, ids.cpu().numpy(), tokens[:, :PLAIN_NEW].tolist(),
                                 plain_tokens.tolist(), max_len=T + NEW)
    if read_counts() != launches_a:
        raise RuntimeError(f"{label}: the plain tie check launched a kernel")
    rec.update({"cosine_vs_plain": cos.tolist(), "token_ties": ties,
                "tokens_equal_plain": bool(torch.equal(tokens[:, :PLAIN_NEW], plain_tokens)), "build_s": build_s})
    log(json.dumps(rec))
    if not bool((cos > GEMMA3_E2E_COS).all()):
        raise RuntimeError(f"{label}: kernel vs plain prefill logits cosine {cos.tolist()} <= {GEMMA3_E2E_COS}")
    out["a"] = launches_a
    del plain_logits

    # (b) flat caches: every layer's prefill through flash_prefill, the sliding layers' decode windowed.
    steps_b = G3_FLAT_NEW - 1
    label = f"gemma-3-12b qint4, bf16 flat caches, B = 4 x 1024 + {G3_FLAT_NEW}"
    want_pre = {"qbits_mm_tiled": n_lin, "flash_prefill": L}
    want_dec = {"qbits_mm_small_m": n_lin * steps_b, "flash_decode": L * steps_b}
    logits_b, tokens_b, dec_tally, rec = sliding_measured(model, tally, "gemma3", label, ids, T + G3_FLAT_NEW, None,
                                                          False, want_pre, want_dec, steps_b)
    want_tally = {"decode": L * steps_b, "decode_ring": 0, "decode_window": sliding * steps_b, "chunk_ring": 0}
    if {k: dec_tally.get(k, 0) for k in want_tally} != want_tally:
        raise RuntimeError(f"{label}: decode attention {dec_tally}, want {want_tally}")
    cos = F.cosine_similarity(logits[:, -1].float(), logits_b[:, -1].float(), dim=-1)
    ties = check_same_tokens("phase 24 (a) vs (b)", model, ids.cpu().numpy(), tokens_b.tolist(),
                             tokens[:, :G3_FLAT_NEW].tolist(), max_len=T + NEW)
    rec.update({"cosine_vs_rings": cos.tolist(), "token_ties_vs_rings": ties,
                "tokens_equal_rings": bool(torch.equal(tokens_b, tokens[:, :G3_FLAT_NEW]))})
    log(json.dumps(rec))
    if not bool((cos > GEMMA3_RING_COS).all()):
        raise RuntimeError(f"phase 24: flat vs ring prefill logits cosine {cos.tolist()} <= {GEMMA3_RING_COS}")
    out["b"] = read_counts()
    del logits, logits_b
    for h in handles:
        h.remove()

    # (c) the engines past the window.
    rng = np.random.default_rng(241)
    prompts = [rng.integers(0, config.vocab_size, n).astype(np.int64) for n in G3_ENGINE_PROMPTS]
    C, new, max_len = G3_ENGINE_CHUNK, G3_ENGINE_NEW, G3_ENGINE_MAX_LEN
    n_chunks = [-(-n // C) for n in G3_ENGINE_PROMPTS]
    kw = dict(max_batch=len(prompts), max_len=max_len, prefill_chunk=C)
    dec_steps = new - 1

    def serve(engine, batched: bool):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = engine.add_batch(prompts, new) if batched else [engine.add(p, new) for p in prompts]
        engine.run_to_completion()
        torch.cuda.synchronize()
        return [engine.result(r) for r in rids], read_counts(), time.perf_counter() - t0

    want = [generate(model, torch.tensor(p[None], device="cuda"), new)[0, len(p):].tolist() for p in prompts]
    engine = BatchedEngine(model, **kw)
    if not isinstance(engine._cache[0], tuple) or engine._cache[0][0].shape[1] != W:
        raise RuntimeError("phase 24(c): the dense engine's sliding layers hold no rings")
    got_batch, counts_batch, s_batch = serve(engine, True)
    check_counts("phase 24(c) batch arm", counts_batch, {
        "qbits_mm_tiled": n_lin * max(n_chunks), "qbits_mm_small_m": n_lin * dec_steps, "flash_decode": L * dec_steps})
    ties_batch = check_same_tokens("phase 24(c) batch arm vs generate", model, prompts, got_batch, want,
                                   max_len=max_len)
    del engine
    paged = PagedEngine(model, n_pages=1 + len(prompts) * -(-max_len // 64), page_size=64, **kw)
    if paged.prefix_sharing or not isinstance(paged._cache[0], tuple) or \
            paged._cache[0][0].shape[1] != W or not hasattr(paged._cache[5], "_table"):
        raise RuntimeError("phase 24(c): PagedEngine did not build the paged+ring hybrid")
    got_paged, counts_paged, s_paged = serve(paged, False)
    check_counts("phase 24(c) paged arm", counts_paged, {
        "qbits_mm_small_m": n_lin * (sum(n_chunks) + dec_steps), "flash_decode": sliding * dec_steps,
        "flash_decode_paged": full * dec_steps})
    ties_paged = check_same_tokens("phase 24(c) paged arm vs generate", model, prompts, got_paged, want,
                                   max_len=max_len)
    log(json.dumps({"gemma3_engines": {
        "prompts": G3_ENGINE_PROMPTS, "chunk": C, "new_tokens": new, "max_len": max_len,
        "batch_s": s_batch, "paged_s": s_paged,
        "batch_vs_generate_ties": ties_batch, "batch_equal_generate": got_batch == want,
        "paged_vs_generate_ties": ties_paged, "paged_equal_generate": got_paged == want,
        "launches": {arm: {n: c for n, c in counts.items() if c} for arm, counts in
                     (("batch", counts_batch), ("paged", counts_paged))},
    }}))
    out["c_batch"], out["c_paged"] = counts_batch, counts_paged
    del paged, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"gemma3: phase 24 took {time.perf_counter() - t_start:.1f} s")
    return out


def qwen3_moe_layer(layer) -> None:
    """Phase 25's per-layer build step: every linear of the layer (attention,
    router, the 128 experts' three projections) qint4, frozen, and the sparse
    block swapped for the stacked dispatch, before the next layer is drawn:
    the card never holds a layer's experts both per expert and stacked past
    this call."""
    from quanto_tpu_torch import convert_moe_to_stacked

    qint4_layer(layer)
    if convert_moe_to_stacked(layer, capacity_factor=2.0) != 1:
        raise RuntimeError("convert_moe_to_stacked did not convert the layer's sparse block")


def compare_routed_rows(what: str, k, o, route_k, route_o, top: int) -> dict:
    """Phase 25's check of the kernel path's last-position logits `k` [B, V]
    against another path's `o`, given both paths' routing probabilities [L,
    B, E] at that position: every row within QWEN3_E2E_COS and with the same
    top-1 token or a logit tie (LOGIT_TIE); where a row's top-`top` experts
    part between the paths, the first layer where they part must hold a
    routing tie (both paths' top-th and (top+1)-th probabilities within
    QWEN3_ROUTE_TIE). Later layers route hidden states that other experts
    made, so they may part anywhere; their margins are logged. Returns what it
    read."""
    top_k, top_o = k.argmax(-1), o.argmax(-1)
    cos = F.cosine_similarity(k.float(), o.float(), dim=-1)
    sets_k = route_k.topk(top, dim=-1).indices.sort(dim=-1).values  # [L, B, top]
    sets_o = route_o.topk(top, dim=-1).indices.sort(dim=-1).values
    p_k = route_k.sort(dim=-1, descending=True).values
    p_o = route_o.sort(dim=-1, descending=True).values
    margin_k, margin_o = p_k[..., top - 1] - p_k[..., top], p_o[..., top - 1] - p_o[..., top]
    read = {"cosine": cos.tolist(), "routed_alike": [], "routing_ties": [], "logit_ties": []}
    for r in range(k.shape[0]):
        differ = (sets_k[:, r] != sets_o[:, r]).any(dim=-1).nonzero().flatten().tolist()
        if differ:
            margins = [[margin_k[layer, r].item(), margin_o[layer, r].item()] for layer in differ]
            read["routing_ties"].append({"row": r, "layers": differ, "margins": margins})
            if max(margins[0]) > QWEN3_ROUTE_TIE:
                raise RuntimeError(f"{what}: row {r} parts from the other path's routing in layer {differ[0]} "
                                   f"with no routing tie: margins {margins[0]}")
        else:
            read["routed_alike"].append(r)
        if not cos[r] > QWEN3_E2E_COS:
            raise RuntimeError(f"{what}: row {r} has cosine {cos[r].item()} <= {QWEN3_E2E_COS}")
        if top_k[r] != top_o[r]:
            gap = (o[r, top_o[r]] - o[r, top_k[r]]).item()
            read["logit_ties"].append({"row": r, "gap": gap, "max_abs_logit": o[r].abs().max().item()})
            if gap > LOGIT_TIE * o[r].abs().max().item():
                raise RuntimeError(f"{what}: row {r}'s top-1 token differs with no logit tie (gap {gap})")
    log(json.dumps({"qwen3_vs_plain": what, **read}))
    return read


@torch.no_grad()
def routing_tie_behind(what: str, model, ids, top: int) -> dict:
    """Qwen3-MoE's evidence for a greedy token that parts from the plain
    path's at a relative gap past SERVE_TOP1_GAP: both paths' routing over
    every position of `ids` [1, n] (the prompt and the tokens both paths gave
    before the parting one), from one forward of each. The first layer where
    any position's top-`top` experts part must hold a routing tie at each
    position where they part (both paths' top-th and (top+1)-th
    probabilities within QWEN3_ROUTE_TIE): a part there has no earlier part
    to cause it. Raises when the paths route alike everywhere (no flip
    explains the gap) or part there with no tie. Returns what it read."""
    from quanto_tpu_torch.models.serve import make_cache

    L, n = model.config.num_hidden_layers, ids.shape[1]
    records, handles = route_record(model, last_only=False)
    try:
        model(ids, make_cache(model, 1, n), 0, logits_indices=n - 1)
        with plain_versions():
            model(ids, make_cache(model, 1, n), 0, logits_indices=n - 1)
    finally:
        for h in handles:
            h.remove()
    route_k, route_o = torch.stack(records[:L])[:, 0], torch.stack(records[L:])[:, 0]  # [L, n, E]
    read = first_parting_ties(what, route_k, route_o, top, QWEN3_ROUTE_TIE)
    if "first_layer" not in read:
        raise RuntimeError(f"{what}: both paths route alike at every layer and position, so no routing tie "
                           f"explains a gap past SERVE_TOP1_GAP")
    return read


@torch.no_grad()
def qwen3_run(label: str, model, ids, new: int, want_pre: dict, want_step: dict, route_top=None) -> tuple:
    """`measured_run` over a bf16 cache of T' + new slots after a warm-up,
    then the same through the plain versions: logits held by
    `compare_routed_rows` (MoE: `route_top`) or QWEN3_E2E_COS, tokens equal
    or at a recorded tie (MoE: a tie past SERVE_TOP1_GAP, up to
    QWEN3_TOP1_GAP, only with `routing_tie_behind`). Returns (launches,
    record)."""
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, make_cache, prefill

    t_run = time.perf_counter()
    config = model.config
    batch, prompt = ids.shape
    steps = new - 1

    def run(n_steps=steps):
        logits, cache = prefill(model, ids, make_cache(model, batch, prompt + new), last_only=True)
        first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
        rest, _ = decode(model, first, cache, prompt, n_steps)
        return logits, torch.cat([first, rest], dim=1)

    run()  # warm-up
    logits, tokens, cache, measured = measured_run(
        label, model, ids, lambda: make_cache(model, batch, prompt + new), steps, want_pre,
        {n: c * steps for n, c in want_step.items()})
    del cache
    launches = read_counts()
    # Limits: the prefill's operations at 989 TFLOP/s (the quantized linears, each token through its
    # top-k experts' three projections, attention as phase 23 counts it); a step's bytes at 3.35
    # TB/s (every weight but the experts, the routed experts' stacked bytes, between top-k and
    # min(E, B top-k) experts a layer, and the cache's visible slots).
    L, H, D = config.num_hidden_layers, config.num_attention_heads, config.head_dim
    blocks = [layer.mlp for layer in model.model.layers if hasattr(layer.mlp, "proj_gate")]
    per_expert = sum(t[0].numel() * t.element_size() for b in blocks[:1]
                     for proj in (b.proj_gate, b.proj_up, b.proj_down) for t in (proj.packed, proj.scale_t, proj.shift_t))
    top = getattr(config, "num_experts_per_tok", 0)
    expert_ops = 2 * batch * prompt * top * 3 * config.hidden_size * getattr(config, "moe_intermediate_size", 0)
    prefill_ops = linears_operations(model, batch * prompt) + expert_ops * len(blocks) + 2 * batch * H * prompt**2 * D * L
    kv_bytes = batch * (prompt + (steps + 1) / 2) * 2 * config.num_key_value_heads * D * 2 * L
    step_bytes = [step_weight_bytes(model) + kv_bytes + n * per_expert * len(blocks)
                  for n in (top, min(getattr(config, "num_experts", 0), batch * top))]
    rec = {
        "qwen3": label, "batch": batch, "prompt": prompt, "new_tokens": new, "decode_steps": steps,
        "prefill_ms": measured["prefill_s"] * 1e3, "prefill_operations": prefill_ops,
        "prefill_bound_ms": prefill_ops / PEAK_BF16_FLOPS * 1e3, "decode_step_bytes": step_bytes,
        "decode_step_bound_ms": [b / PEAK_BYTES_PER_S * 1e3 for b in step_bytes],
        "decode_ms_per_step": measured["decode_s"] / steps * 1e3,
        "decode_tok_s": batch * steps / measured["decode_s"], "peak_memory_gb": measured["peak_gb"],
        "model_bytes": torch.cuda.memory_allocated(),
        "prefill_launches": {n: c for n, c in measured["pre"].items() if c},
        "decode_launches": {n: c for n, c in measured["dec"].items() if c},
        "measured_s": time.perf_counter() - t_run,  # the warm-up and the measured run
    }
    t_plain = time.perf_counter()
    records = handles = None
    if route_top:  # the kernel path's routing at the last prompt position, layer by layer
        records, handles = route_record(model)
        model(ids, make_cache(model, batch, prompt + new), 0, logits_indices=prompt - 1)
    counts = read_counts()
    with plain_versions():
        if route_top:
            n = len(records)
            model(ids, make_cache(model, batch, prompt + new), 0, logits_indices=prompt - 1)
            route_k, route_o = torch.stack(records[:n]), torch.stack(records[n:])
            for h in handles:
                h.remove()
        plain_new = min(new, PLAIN_NEW)
        plain_logits, plain_tokens = run(plain_new - 1)
        torch.cuda.synchronize()
        if read_counts() != counts:
            raise RuntimeError(f"{label}: the plain forward launched a kernel")
        if route_top:
            rec["vs_plain"] = compare_routed_rows(label, logits[:, -1], plain_logits[:, -1], route_k, route_o,
                                                  route_top)
        else:
            cos = F.cosine_similarity(logits[:, -1].float(), plain_logits[:, -1].float(), dim=-1)
            rec["vs_plain"] = {"cosine": cos.tolist()}
            if not bool((cos > QWEN3_E2E_COS).all()):
                raise RuntimeError(f"{label}: kernel vs plain prefill logits cosine {cos.tolist()} <= "
                                   f"{QWEN3_E2E_COS}")
        rec["token_ties"] = check_same_tokens(f"phase 25 {label}", model, ids.cpu().numpy(),
                                              tokens[:, :plain_new].tolist(), plain_tokens.tolist(),
                                              max_len=prompt + new,
                                              tie_gap=QWEN3_TOP1_GAP if route_top else SERVE_TOP1_GAP)
    if read_counts() != counts:
        raise RuntimeError(f"{label}: the plain tie check launched a kernel")
    for tie in rec["token_ties"]:
        if tie["relative_gap"] > SERVE_TOP1_GAP:
            i, j = tie["request"], tie["index"]
            tie["routing"] = routing_tie_behind(f"phase 25 {label}, request {i}, token {j}", model,
                                                torch.cat([ids[i], plain_tokens[i, :j]])[None], route_top)
    rec["tokens_equal_plain"] = bool(torch.equal(tokens[:, :plain_new], plain_tokens))
    rec["plain_check_s"] = time.perf_counter() - t_plain
    return launches, rec


@torch.no_grad()
def phase_qwen3() -> dict:
    """Phase 25: the Qwen3 families. (a) Qwen3-30B-A3B (Qwen/Qwen3-30B-A3B
    config.json: 48 layers of 32 heads over 4 kv heads of 128, q/k norms, 128
    experts of 768, top-8 renormalized, untied head) at full depth and width,
    random weights (seed 25), attention, router and experts qint4 (group size
    128; the head and embedding bf16), built a layer at a time (quantize,
    freeze, stack). B = 4 x 1024 + Q3_NEW over a bf16 cache: the prefill 240
    `qbits_mm_tiled` (q/k/v/o and the router, on the envelope at N = 128),
    144 `qbits_moe_tiled` (the capacity gather, TPU #14, 128 slabs of 512
    rows) and 48 `flash_prefill` (G = 8 at D = 128); each step 240
    `qbits_mm_small_m`, 144 `qbits_moe_small_m` (the selective route: 32
    pairs, TPU #11) and 48 `flash_decode`. One block's decode forward runs
    under `set_sync_debug_mode("error")`. Against the plain versions: the
    phase 9 rule at top-8 (`compare_routed_rows`), tokens equal or at a
    recorded tie. (b) The same model at B16 x T16 + Q3_B16_NEW: each step's
    blocks take the unique-expert route (S·K = 128 = E): 96
    `qbits_moe_small_m` (gate and up over the routed-first table, TPU #13)
    and 48 `qbits_moe_tiled` at M = 16 (TPU #15, `qbits_moe_tiled_small_m`),
    held to the plain versions as (a). (c) Qwen3-8B at full width and QWEN3_8B_LAYERS layers, qint4 (head bf16),
    B = 4 x 1024 + Q3_8B_NEW: 7 linears a layer through #2 and #1, one
    `flash_prefill` and one `flash_decode` a layer; its logits against the
    plain versions within QWEN3_E2E_COS. Returns each run's launches."""
    from quanto_tpu_torch.models import Qwen3ForCausalLM, Qwen3MoeForCausalLM
    from quanto_tpu_torch.parallel import StackedSparseMoeBlock

    t_start = time.perf_counter()
    model, build_s = build_qk_norm_model(QWEN3_30B_A3B, 25, qwen3_moe_layer)
    config = model.config
    L = config.num_hidden_layers
    if not (isinstance(model, Qwen3MoeForCausalLM) and config.num_experts == 128 and config.norm_topk_prob
            and config.num_experts_per_tok == 8 and config.head_dim == 128 and model.lm_head is not None
            and all(isinstance(layer.mlp, StackedSparseMoeBlock) for layer in model.model.layers)):
        raise RuntimeError(f"build_model did not read Qwen/Qwen3-30B-A3B's config.json: {config}")
    check_qint4_linears("qwen3-30b-a3b", model, 5 * L)
    log(f"qwen3: built on meta, then {L} layers materialized + quantized + frozen + stacked one at a time in "
        f"{build_s:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    check_no_sync(model)
    dense = 5 * L  # q, k, v, o and the router
    out = {}
    ids = torch.randint(0, config.vocab_size, (B, T), generator=torch.Generator().manual_seed(25)).cuda()
    label = "qwen3-30b-a3b qint4 (head bf16), stacked MoE, bf16 cache, B = 4 x 1024"
    out["a"], rec = qwen3_run(
        label, model, ids, Q3_NEW,
        {"qbits_mm_tiled": dense, "qbits_moe_tiled": 3 * L, "flash_prefill": L},
        {"qbits_mm_small_m": dense, "qbits_moe_small_m": 3 * L, "flash_decode": L}, route_top=8)
    log(json.dumps({**rec, "build_s": build_s}))
    ids16 = torch.randint(0, config.vocab_size, (B16, T16), generator=torch.Generator().manual_seed(250)).cuda()
    label = f"qwen3-30b-a3b qint4, stacked MoE, bf16 cache, B = {B16} x {T16}"
    out["b"], rec = qwen3_run(
        label, model, ids16, Q3_B16_NEW,
        {"qbits_mm_tiled": dense, "qbits_moe_tiled": 3 * L, "flash_prefill": L},
        {"qbits_mm_small_m": dense, "qbits_moe_small_m": 2 * L, "qbits_moe_tiled": L, "qbits_moe_tiled_small_m": L,
         "flash_decode": L}, route_top=8)
    log(json.dumps(rec))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model, build_s = build_qk_norm_model(QWEN3_8B, 26, qint4_layer, layers=QWEN3_8B_LAYERS)
    n_lin = LINEARS_PER_LAYER * QWEN3_8B_LAYERS
    if not isinstance(model, Qwen3ForCausalLM) or model.config.intermediate_size != 12288:
        raise RuntimeError(f"build_model did not read Qwen/Qwen3-8B's config.json: {model.config}")
    check_qint4_linears("qwen3-8b", model, n_lin)
    ids = torch.randint(0, model.config.vocab_size, (B, T), generator=torch.Generator().manual_seed(26)).cuda()
    label = f"qwen3-8b qint4 (head bf16), {QWEN3_8B_LAYERS} layers, bf16 cache, B = 4 x 1024"
    out["c"], rec = qwen3_run(
        label, model, ids, Q3_8B_NEW,
        {"qbits_mm_tiled": n_lin, "flash_prefill": QWEN3_8B_LAYERS},
        {"qbits_mm_small_m": n_lin, "flash_decode": QWEN3_8B_LAYERS})
    log(json.dumps({**rec, "build_s": build_s}))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"qwen3: phase 25 took {time.perf_counter() - t_start:.1f} s")
    return out


def go_sinks(g: torch.Generator, heads=GO_HEADS) -> torch.Tensor:
    """float32 [Hkv * G] sink logits, uniform in +-GO_SINKS_RANGE (about the
    logits' scale: some rows mostly sink, some barely)."""
    H = heads[0] * heads[1]
    return (torch.rand(H, device="cuda", generator=g) * 2 - 1) * GO_SINKS_RANGE


def phase_flash_decode_gpt_oss(flush):
    """Phase 3, flash_decode with gpt-oss's sinks (FD_GPT_OSS_ROWS) at 8 kv
    heads, G = 8, D = 64, B = 4: the kernel against its plain version (bf16 q:
    cosine > 1 - 1e-4, max abs error <= 1e-2 max|ref|; float32 q: <= 1e-5
    max|ref|) and the model's dispatch (`decode_attention`, with `ring` for
    the ring row) equal to the direct call; timed beside its bound (the slots
    each row sees; the sinks' 4 bytes a head), the plain version and SDPA
    (the cache dequantized to bf16, the same visible slots, WITHOUT the
    sinks, which it does not take). Then the paged arm with the sinks
    (`phase_flash_decode_paged`, GO_PAGED). Logs the bf16 call with sinks
    over the one without."""
    from quanto_tpu_torch.ops.attention import decode_attention
    from quanto_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain
    from quanto_tpu_torch.tensor.kv_cache import kv_read

    Hkv, G, D = GO_HEADS
    g = torch.Generator(device="cuda").manual_seed(2626)
    rows = []
    for label, kind, S, positions, with_sinks, tf, ring, q_dtype in FD_GPT_OSS_ROWS:
        nb = len(positions)
        cache = fd_cache(kind, S, g, nb, GO_HEADS)
        q = (torch.randn((nb, Hkv, G, D), device="cuda", generator=g) * 2).to(q_dtype)
        tf = dict(tf, sinks=go_sinks(g)) if with_sinks else dict(tf)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        kpos = pos.clamp(max=S - 1) if ring else pos  # what the ring arm hands the kernel
        if kind == "bf16":
            args, kw = (q, *cache, None, None, kpos), dict(tf)
            k_row = v_row = 2 * D
            per_slot = 0
        else:
            c = cache
            args = (q, c._k_data, c._v_data, c._k_scale, c._v_scale, kpos)
            kw = dict(k_shift=c._k_shift, v_shift=c._v_shift, **tf)
            k_row, v_row = c._k_data[0, 0, 0].numel(), c._v_data[0, 0, 0].numel()
            per_slot = 8 if c._k_shift is None else 16
        out = flash_decode(*args, **kw)
        ref = flash_decode_plain(*args, **kw)
        out2 = decode_attention(q.reshape(nb, 1, Hkv * G, D), cache, pos, ring=ring, **tf)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        cos = cosine(out, ref)
        what = f"flash_decode gpt_oss {label} {kind} S={S} q={q_dtype}"
        ok = err <= 1e-5 * ref_max if q_dtype == torch.float32 else (cos > 1 - 1e-4 and err <= 1e-2 * ref_max)
        if not ok or not torch.equal(out2.reshape(out.shape), out):
            raise RuntimeError(f"{what}: cosine {cos} max_abs_err {err} (max|ref| {ref_max})")
        s_ = torch.arange(S, device="cuda")[None, :]
        visible = s_ <= kpos[:, None]
        if tf.get("window"):
            visible &= s_ > kpos[:, None] - tf["window"]
        kd, vd = cache if kind == "bf16" else kv_read(cache, torch.bfloat16)
        kt, vt = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
        qs = q.reshape(nb, Hkv * G, 1, D).to(torch.bfloat16)
        mask = visible[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask, enable_gqa=True)

        b_ms, b_by = fd_bound(int(visible.sum()), nb, k_row, v_row, per_slot, q.element_size(), GO_HEADS)
        b_ms += (4 * Hkv * G / PEAK_BYTES_PER_S * 1e3) if with_sinks and b_by == "bytes" else 0.0
        row = dict(
            name="flash_decode", gpt_oss=label, cache=kind, S=S, B=nb, engine_arm=None, positions=positions,
            Hkv=Hkv, G=G, D=D, q="f32" if q_dtype == torch.float32 else "bf16", sinks=with_sinks,
            window=tf.get("window"), ring=ring, max_abs_err=err, cosine=cos,
            ms=time_ms(lambda: flash_decode(*args, **kw), flush),
            plain_ms=time_ms(lambda: flash_decode_plain(*args, **kw), flush),
            library_ms=time_ms(sdpa, flush),
            bound_ms=b_ms, bound_by=b_by,
        )
        rows.append(row)
        log("kernel " + json.dumps(row))
        del cache, kd, vd, kt, vt, out, ref, out2
        torch.cuda.empty_cache()
    by = {r["gpt_oss"]: r for r in rows if r["cache"] == "bf16" and r["q"] == "bf16"}
    log(json.dumps({"flash_decode_sinks_vs_none": by["sinks"]["ms"] / by["no-sinks"]["ms"],
                    "sinks_ms": by["sinks"]["ms"], "no_sinks_ms": by["no-sinks"]["ms"]}))
    rows += phase_flash_decode_paged(flush, GO_HEADS, GO_PAGED, tf=dict(sinks=go_sinks(g)), tag="gpt_oss")
    return rows


def go_random_extras(layer, g: torch.Generator) -> None:
    """Phase 26's draws beyond Hugging Face's initializer, so that every term
    of the model moves its outputs: the sinks in +-GO_SINKS_RANGE (HF draws them
    at 0.02), and the router's, experts' and attention's biases (HF's zeros)
    normal at 0.02."""
    attn, mlp = layer.self_attn, layer.mlp
    attn.sinks.copy_(go_sinks(g, (1, attn.num_heads)).to(attn.sinks.dtype))
    biases = [attn.q_proj.bias, attn.k_proj.bias, attn.v_proj.bias, attn.o_proj.bias,
              mlp.experts.gate_up_proj_bias, mlp.experts.down_proj_bias]
    for b in biases:
        b.copy_((torch.randn(b.shape, device=b.device, generator=g) * 0.02).to(b.dtype))


def build_gpt_oss(seed: int):
    """Phase 26's model: openai/gpt-oss-20b's config.json through
    `GptOssConfig.from_hf`, built on "meta" and materialized on the card one
    decoder layer at a time: each layer's weights drawn (`go_random_extras`
    beside them), its q/k/v/o quantized to qint4 (the auto group size: 96 at
    K = 2880, padded onto the envelope; o_proj's N = 2880 padded to 2944) and
    frozen, and its experts quantized to qint4 at group size 128 as they are
    stacked (`convert_gpt_oss_moe_to_stacked`: padded to [2944, 3072] first),
    before the next layer is drawn. The router, the embedding and the head
    stay bf16. Returns (model, build seconds)."""
    from quanto_tpu_torch import freeze, quantize
    from quanto_tpu_torch.models import GptOssConfig, GptOssForCausalLM
    from quanto_tpu_torch.parallel import convert_gpt_oss_moe_to_stacked

    t0 = time.perf_counter()
    config = GptOssConfig.from_hf(GPT_OSS_20B, dtype=torch.bfloat16)
    if config != GptOssConfig(dtype=torch.bfloat16):
        raise RuntimeError(f"GptOssConfig.from_hf did not read openai/gpt-oss-20b's config.json: {config}")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)

    def per_layer(layer):
        go_random_extras(layer, g)
        quantize(layer, weights="qint4")
        freeze(layer)
        if convert_gpt_oss_moe_to_stacked(layer, weights="qint4", group_size=128) != 1:
            raise RuntimeError("convert_gpt_oss_moe_to_stacked did not convert the layer's MoE MLP")

    model = GptOssForCausalLM(config, device="meta")
    model.materialize_("cuda", torch.Generator("cuda").manual_seed(seed), layer_fn=per_layer)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def check_gpt_oss_build(model) -> None:
    """96 qint4 attention linears in the Hopper layout, every one padded onto
    the envelope (q/k/v at K = 2880 to [N, 3840] in groups of 128, o_proj to
    [2944, 4096]); 24 stacked blocks of 32 experts [2944, 3072] at group size
    128; the router, embedding and head in bf16."""
    from quanto_tpu_torch.nn import QLinear
    from quanto_tpu_torch.parallel import StackedGptOssMoE
    from quanto_tpu_torch.tensor.weights import WeightQBitsHopperArray

    c = model.config
    qlinears = [m for m in model.modules() if isinstance(m, QLinear)]
    shapes = sorted({m.weight.kernel_shape for m in qlinears})
    blocks = [layer.mlp for layer in model.model.layers]
    ok = (len(qlinears) == 4 * c.num_hidden_layers
          and all(isinstance(m.weight, WeightQBitsHopperArray) and m.weight.bits == 4 and m.weight.pad is not None
                  for m in qlinears)
          and shapes == [(512, 3840), (2944, 4096), (4096, 3840)]
          and all(isinstance(b, StackedGptOssMoE) and tuple(b.proj_gate.packed.shape) == (32, 2944, 1536)
                  and tuple(b.proj_down.packed.shape) == (32, 2944, 1536) and b.gate.weight.dtype == torch.bfloat16
                  for b in blocks)
          and model.lm_head is not None and model.lm_head.weight.dtype == torch.bfloat16)
    if not ok:
        raise RuntimeError(f"gpt-oss-20b: unexpected build: {len(qlinears)} linears of kernel shapes {shapes}")


class RoutingTape:
    """The expert choices of a gpt-oss model's stacked MoE blocks, keyed by
    (row, position, layer): recorded from one computation (`use("record")`)
    and replayed into another (`use("replay")`), whose blocks then take the
    recorded experts, weighed by a softmax of their own router logits at them
    (as `router.topk` weighs its own choice). With the same choices two
    computations differ by the order of their sums alone; otherwise a routing
    flip at a tie (the router's logits are bf16; 4 of 32 experts) swaps a
    token's expert, and 24 random-weight layers carry that to every later
    position (`PERF.md` section 6). A row is a batch row, or what `rows(B)`
    names for the current forward of B rows (an engine's slots:
    `engine_rows`). Where nothing was recorded (an engine chunk's pad
    columns), a replaying block takes its own choice."""

    def __init__(self, model):
        self.model = model
        self.choices = {}

    @contextlib.contextmanager
    def use(self, mode: str, rows=None):
        blocks = [layer.mlp for layer in self.model.model.layers]
        state = {}

        def pre(_mod, args, kwargs):  # the forward's positions, real columns and row keys
            ids = args[0]
            pos = args[2] if len(args) > 2 else kwargs.get("cache_pos", 0)
            B, T = ids.shape
            p0 = torch.as_tensor(pos).reshape(-1, 1).cpu().long()
            state["pos"] = (p0 + torch.arange(T)[None, :]).expand(B, T).tolist()
            wl = kwargs.get("write_len")
            state["n"] = [T] * B if wl is None else torch.as_tensor(wl).reshape(-1).cpu().expand(B).tolist()
            state["rows"] = list(range(B)) if rows is None else rows(B)

        def make(layer, block):
            def _route(x):
                B, T = x.shape[:2]
                if mode == "record":
                    top_i, top_p = type(block)._route(block, x)
                    ti = top_i.reshape(B, T, -1).cpu().tolist()
                    for b, r in enumerate(state["rows"]):
                        for t in range(state["n"][b]):
                            self.choices[(r, state["pos"][b][t], layer)] = ti[b][t]
                    return top_i, top_p
                own = type(block)._route(block, x)[0].reshape(B, T, -1).cpu().tolist()
                idx = torch.tensor([self.choices.get((r, state["pos"][b][t], layer), own[b][t])
                                    for b, r in enumerate(state["rows"]) for t in range(T)], device=x.device)
                logits = block.gate(x).reshape(B * T, -1)
                return idx, torch.softmax(logits.gather(1, idx), dim=-1)
            return _route

        handle = self.model.register_forward_pre_hook(pre, with_kwargs=True)
        for i, block in enumerate(blocks):
            block._route = make(i, block)
        try:
            yield self
        finally:
            handle.remove()
            for block in blocks:
                del block._route


@torch.no_grad()
def greedy_steps(model, ids, new: int, cache, forced=None):
    """`generate`'s computation (a prefill at the int 0, last position only,
    then greedy steps) over `cache`, returning (tokens [B, new], each token's
    logits [B, new, V]). With `forced` [B, new], each step takes forced's
    token in place of its own (teacher forcing), and the tokens returned are
    forced's."""
    from quanto_tpu_torch.models.serve import prefill

    logits, cache = prefill(model, ids, cache, last_only=True)
    out, toks = [logits[:, -1]], []
    for i in range(new):
        toks.append(out[-1].argmax(-1)[:, None] if forced is None else forced[:, i : i + 1])
        if i < new - 1:
            step, cache = model(toks[-1], cache, ids.shape[1] + i)
            out.append(step[:, -1])
    return torch.cat(toks, dim=1), torch.stack(out, dim=1)


def relative_gap(logits, a: int, b: int) -> float:
    """Tokens a and b apart in `logits` [V], relative to its largest |logit|."""
    lv = logits.float()
    return abs((lv[a] - lv[b]).item()) / lv.abs().max().item()


def check_forced(what: str, tokens, logits, ref_logits, min_cos: float) -> dict:
    """A computation's greedy tokens [R, n] and their logits [R, n, V] against
    another computation's logits over the same contexts (forced through
    `tokens`, replaying the first's expert choices: `RoutingTape`): every
    step's logits within `min_cos` of the other's and, where the other's top-1
    token is not the first's, a logit tie (the two tokens within
    SERVE_TOP1_GAP of the other's largest |logit|). Returns what it read."""
    cos = F.cosine_similarity(logits.float(), ref_logits.float(), dim=-1)  # [R, n]
    read = {"rows": tokens.shape[0], "steps": tokens.shape[1], "cosine_min": cos.min(dim=1).values.tolist(),
            "ties": []}
    if not bool((cos > min_cos).all()):
        r, j = divmod(int(cos.argmin()), cos.shape[1])
        raise RuntimeError(f"{what}: row {r}'s step {j} logits at cosine {cos[r, j].item()} <= {min_cos} "
                           f"of the reference's")
    ref_top = ref_logits.argmax(-1)
    for r, j in (ref_top != tokens).nonzero().tolist():
        gap = relative_gap(ref_logits[r, j], tokens[r, j].item(), ref_top[r, j].item())
        read["ties"].append({"row": r, "index": j, "relative_gap": gap})
        if gap > SERVE_TOP1_GAP:
            raise RuntimeError(f"{what}: row {r}'s token {j} is not the reference's top-1 and no logit tie "
                               f"(relative gap {gap})")
    log(json.dumps({"forced_replay": what, **read}))
    return read


class EngineTap:
    """An engine's sampler (`sample_fn`) that keeps each call's logits: greedy,
    or, given another run's tap (`forced`), that run's tokens call by call
    (teacher forcing an engine that makes the same calls)."""

    def __init__(self, forced=None):
        self.forced, self.logits, self.ids = forced, [], []

    def __call__(self, logits, generator=None):
        ids = logits.argmax(-1) if self.forced is None else self.forced.ids[len(self.ids)]
        self.logits.append(logits.to(torch.float32, copy=True))
        self.ids.append(ids)
        return ids

    def per_request(self, slots) -> torch.Tensor:
        """Each request's logits [R, n, V] where the engine admitted R requests
        first (one [1, V] call each, in order) and then stepped them all
        (a [max_batch, V] call a step): request i's first call, then its
        slot's row of every step."""
        first, steps = self.logits[: len(slots)], self.logits[len(slots) :]
        if any(f.shape[0] != 1 for f in first) or len({s.shape[0] for s in steps}) != 1:
            raise RuntimeError(f"EngineTap: calls of {[t.shape[0] for t in self.logits]} rows, not R admissions "
                               f"and then steps")
        return torch.stack([torch.cat([f] + [s[slot : slot + 1] for s in steps]) for f, slot in zip(first, slots)])


def engine_rows(engine):
    """`RoutingTape`'s rows for an engine's forwards: every slot for a forward
    over the pool, the slot being prefilled for a one-row forward (wraps the
    engine's `_prefill_into`)."""
    current = {}
    inner = engine._prefill_into

    def prefill_into(slot, *args, **kw):
        current["slot"] = slot
        return inner(slot, *args, **kw)

    engine._prefill_into = prefill_into
    return lambda B: list(range(B)) if B == engine.max_batch else [current["slot"]]


@torch.no_grad()
def hold_to_generate(what: str, model, prompts, engine, rids, tap, tape, min_cos: float, plain: bool) -> dict:
    """An engine's requests (their logits in `tap`, their expert choices in
    `tape`, recorded by slot) against `generate`'s computation of each prompt
    alone, forced through the request's tokens and replaying its choices
    (`greedy_steps`, `check_forced` within `min_cos`); with `plain`, on the
    plain versions (no kernel launched)."""
    from quanto_tpu_torch.models.serve import make_cache

    slots = [engine._requests[r].slot for r in rids]
    tokens = torch.tensor([engine.result(r) for r in rids], device="cuda")
    new, ref = tokens.shape[1], []
    counts = read_counts()
    with plain_versions() if plain else contextlib.nullcontext():
        for p, slot, toks in zip(prompts, slots, tokens):
            with tape.use("replay", rows=lambda B, slot=slot: [slot]):
                ref.append(greedy_steps(model, torch.tensor(p[None], device="cuda"), new,
                                        make_cache(model, 1, len(p) + new), forced=toks[None])[1])
        torch.cuda.synchronize()
    if plain and read_counts() != counts:
        raise RuntimeError(f"{what}: the plain forward launched a kernel")
    return check_forced(what, tokens, tap.per_request(slots), torch.cat(ref), min_cos)


def first_parting_ties(what: str, route_a, route_b, top: int, tie: float) -> dict:
    """Two computations' routing probabilities [L, N, E] over the same N
    positions: the first layer where any position's top-`top` experts part
    must hold a routing tie at every position where they part (both
    computations' top-th and (top+1)-th probabilities within `tie`): before
    it both computations route alike everywhere, so nothing but the order of
    their sums moves that layer's input. Later layers are logged. Returns what
    it read (none parting is fine)."""
    differ = (route_a.topk(top, dim=-1).indices.sort(dim=-1).values
              != route_b.topk(top, dim=-1).indices.sort(dim=-1).values).any(dim=-1)  # [L, N]
    per_layer = differ.sum(dim=-1).tolist()
    layers = [i for i, n in enumerate(per_layer) if n]
    read = {"positions": route_a.shape[1], "parting_per_layer": per_layer}
    if layers:
        first = layers[0]
        pos = differ[first].nonzero().flatten()
        p_a = route_a[first, pos].sort(dim=-1, descending=True).values
        p_b = route_b[first, pos].sort(dim=-1, descending=True).values
        margins = torch.stack([p_a[:, top - 1] - p_a[:, top], p_b[:, top - 1] - p_b[:, top]], dim=1)
        read.update(first_layer=first, first_layer_max_margin=margins.max().item(),
                    first_layer_margins=margins.max(dim=1).values.tolist()[:16])
        if margins.max().item() > tie:
            raise RuntimeError(f"{what}: the routing first parts in layer {first} with no routing tie at "
                               f"{int((margins.max(dim=1).values > tie).sum())} of {len(pos)} positions "
                               f"(largest margin {margins.max().item()})")
    log(json.dumps({"routing_first_parting": what, **read}))
    return read


@torch.no_grad()
def prefill_routes(model, ids, cache):
    """One prefill of `ids` from 0 over `cache`: the last position's logits
    [B, V] and every layer's routing probabilities at every position [L, B T, E]."""
    records, handles = route_record(model, last_only=False)
    try:
        logits, _ = model(ids, cache, 0, logits_indices=ids.shape[1] - 1)
    finally:
        for h in handles:
            h.remove()
    L = model.config.num_hidden_layers
    return logits[:, -1], torch.stack(records[:L]).flatten(1, 2)


@torch.no_grad()
def gpt_oss_run(label: str, model, ids, new: int, want_pre: dict, want_step: dict, sliding_ring: bool = True,
                tally=None, plain: bool = True, record: bool = True) -> tuple:
    """`measured_run` of phase 26 over a bf16 cache of T' + new slots (rings
    where `sliding_ring`) after a warm-up, with the attention tally, times and
    peak memory beside their bounds; then the kernel path once more recording
    its expert choices (a `RoutingTape`; its tokens EQUAL to the measured
    run's). With `plain`, against the plain versions: the routing of one
    prefill of each path over every position (`first_parting_ties`), then the
    plain path forced through the kernel path's tokens, replaying its choices
    (`check_forced`, within GPT_OSS_E2E_COS), the plain path's own
    last-position cosine logged. Without `record` (nor `plain`) no tape. Returns (launches,
    record, tape, the recorded tokens and logits)."""
    from quanto_tpu_torch.models.sampling import greedy
    from quanto_tpu_torch.models.serve import decode, make_cache, prefill

    t_run = time.perf_counter()
    config = model.config
    batch, prompt = ids.shape
    steps = new - 1
    top = config.num_experts_per_tok

    def new_cache():
        return make_cache(model, batch, prompt + new, sliding_ring=sliding_ring)

    def run():
        logits, cache = prefill(model, ids, new_cache(), last_only=True)
        first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
        decode(model, first, cache, prompt, steps)

    run()  # warm-up
    logits, tokens, cache, measured = measured_run(
        label, model, ids, new_cache, steps, want_pre, {n: c * steps for n, c in want_step.items()}, tally)
    del cache, logits
    launches = read_counts()
    # Limits: the prefill's operations at 989 TFLOP/s (the quantized linears at their true shapes, each
    # token through its top-4 experts' three projections, attention over its visible keys: the window's
    # on the sliding layers); a step's bytes at 3.35 TB/s (the linears, the routers and the head, the
    # routed experts' stacked bytes between top-4 and min(32, 4 B) experts a layer, the visible cache).
    L, H, D, W = config.num_hidden_layers, config.num_attention_heads, config.head_dim, config.sliding_window
    blocks = [layer.mlp for layer in model.model.layers]
    per_expert = sum(t[0].numel() * t.element_size() for proj in (blocks[0].proj_gate, blocks[0].proj_up,
                                                                  blocks[0].proj_down)
                     for t in (proj.packed, proj.scale_t, proj.shift_t))
    router_bytes = sum(b.gate.weight.numel() * b.gate.weight.element_size() for b in blocks)
    expert_ops = 2 * batch * prompt * top * 3 * config.hidden_size * config.intermediate_size * L
    keys = sum(min(t + 1, W) if lt == "sliding_attention" else t + 1 for lt in config.layer_types
               for t in range(prompt))
    prefill_ops = linears_operations(model, batch * prompt) + expert_ops + 4 * batch * H * D * keys
    mean_pos = prompt + (steps - 1) / 2
    kv_bytes = batch * 2 * config.num_key_value_heads * D * 2 * sum(
        min(mean_pos + 1, W) if lt == "sliding_attention" else mean_pos + 1 for lt in config.layer_types)
    step_bytes = [step_weight_bytes(model) + router_bytes + kv_bytes + n * per_expert * L
                  for n in (top, min(config.num_local_experts, batch * top))]
    rec = {
        "gpt_oss": label, "batch": batch, "prompt": prompt, "new_tokens": new, "decode_steps": steps,
        "sliding_ring": sliding_ring,
        "prefill_ms": measured["prefill_s"] * 1e3, "prefill_operations": prefill_ops,
        "prefill_bound_ms": prefill_ops / PEAK_BF16_FLOPS * 1e3, "decode_step_bytes": step_bytes,
        "decode_step_bound_ms": [b / PEAK_BYTES_PER_S * 1e3 for b in step_bytes],
        "decode_ms_per_step": measured["decode_s"] / steps * 1e3,
        "decode_tok_s": batch * steps / measured["decode_s"], "peak_memory_gb": measured["peak_gb"],
        "model_bytes": torch.cuda.memory_allocated(),
        "prefill_launches": {n: c for n, c in measured["pre"].items() if c},
        "decode_launches": {n: c for n, c in measured["dec"].items() if c},
        "prefill_attention": measured["pre_tally"], "decode_attention": measured["dec_tally"],
        "measured_s": time.perf_counter() - t_run,  # the warm-up and the measured run
    }
    t_check = time.perf_counter()
    if not record:
        return launches, rec, None, None, None
    tape = RoutingTape(model)
    with tape.use("record"):
        rec_tokens, rec_logits = greedy_steps(model, ids, new, new_cache())
    if not torch.equal(rec_tokens, tokens):
        raise RuntimeError(f"{label}: the recorded kernel run's tokens are not the measured run's")
    if plain:
        logits_k, route_k = prefill_routes(model, ids, new_cache())
        counts = read_counts()
        with plain_versions():
            logits_o, route_o = prefill_routes(model, ids, new_cache())
            rec["routing_vs_plain"] = first_parting_ties(label, route_k, route_o, top, GPT_OSS_ROUTE_TIE)
            with tape.use("replay"):
                _, p_logits = greedy_steps(model, ids, new, new_cache(), forced=rec_tokens)
            torch.cuda.synchronize()
            if read_counts() != counts:
                raise RuntimeError(f"{label}: the plain forward launched a kernel")
        rec["vs_plain_replayed"] = check_forced(f"phase 26 {label}: plain, forced, the kernel path's experts",
                                                rec_tokens, rec_logits, p_logits, GPT_OSS_E2E_COS)
        rec["plain_own_routing"] = {  # the plain path on its own choices: logged, not held
            "cosine_last_prefill": F.cosine_similarity(logits_k.float(), logits_o.float(), dim=-1).tolist()}
        del route_k, route_o, p_logits
    rec["check_s"] = time.perf_counter() - t_check
    return launches, rec, tape, rec_tokens, rec_logits


@torch.no_grad()
def phase_gpt_oss() -> dict:
    """Phase 26: openai/gpt-oss-20b (GPT_OSS_20B: 24 layers of 64 heads over 8
    kv heads of 64 with sinks, a window of 128 on the 12 even layers, 32
    experts of 2880 top-4 with biases and the clamped SwiGLU, yarn rope,
    untied head) at full depth and width, random weights (seed 26),
    attention and experts qint4 (`build_gpt_oss`; router, embedding and head
    bf16).

    (a) B = 4 x 1024 + GO_NEW over bf16 caches with 128-slot rings on the
    sliding layers: after a warm-up, exact launches: the prefill 96
    `qbits_mm_tiled` (q/k/v/o, padded, TPU #2) and 72 `qbits_moe_tiled` (the
    capacity gather, TPU #14: 32 slabs of 1024 rows a projection), no
    `flash_prefill` (JAX's gpt-oss never calls splash); each step 96
    `qbits_mm_small_m` (#1), 72 `qbits_moe_small_m` (the selective route:
    16 pairs, #11) and 24 `flash_decode` with the sinks (#8-#10), 12 of them
    over rings. One block's decode forward at B = 1, 4, 16 with no host sync.
    Against the plain versions (`gpt_oss_run`): the routing first parts at a
    tie, and forced through the kernel path's tokens with its expert choices
    the plain path's logits agree at every step (cosine, logit ties). (b) B16 x T16 + GO_B16_NEW: each
    step's blocks take the unique-expert route (S·K = 64 = 2E): 48
    `qbits_moe_small_m` (gate and up over the routed-first table, #13) and 24
    `qbits_moe_tiled` at M = 16 (#15), held to the plain versions as (a).
    (c) (a)'s prompts over flat caches, GO_FLAT_NEW new: each step's 12
    sliding layers through `flash_decode` with the window of 128; against (a):
    the routing first parts at a tie, and forced through (a)'s tokens with its
    expert choices within GPT_OSS_RING_COS, logit ties. (d) the engines past
    W, chunks of 512 over 128-slot rings, first with the blocks' dispatch
    exact (`capacity_factor=None`): `BatchedEngine` over GO_ENGINE_PROMPTS
    (batched [4, 512] chunks, their last ones masked by `write_len`), each
    request's logits at every step against `generate`'s computation forced
    through its tokens and replaying its expert choices (`hold_to_generate`,
    GPT_OSS_ENGINE_COS); serial admission ([1, 512] chunks: #12 over 512
    rows) held so to `generate` on the plain versions (GPT_OSS_E2E_COS), and
    in `PagedEngine` (the paged+ring hybrid, pages of 64), one computation,
    tokens equal (or logit ties); then the batch arm at capacity 2.0 (the
    pad columns kept out of the slabs by `valid`) against the same engine on
    the plain versions, forced and replayed. Prints prefill ms, decode ms/step and peak memory beside their
    bounds. Returns each arm's launch counts."""
    from quanto_tpu_torch.models import BatchedEngine, PagedEngine
    from quanto_tpu_torch.models.serve import generate, make_cache

    t_start = time.perf_counter()
    model, build_s = build_gpt_oss(26)
    check_gpt_oss_build(model)
    config = model.config
    L, W = config.num_hidden_layers, config.sliding_window
    half, top = L // 2, config.num_experts_per_tok
    log(f"gpt-oss: built on meta, then {L} layers materialized + quantized + frozen + stacked one at a time in "
        f"{build_s:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    check_no_sync(model)
    lin, moe = 4 * L, 3 * L
    out = {}
    tally, handles = attention_tally(model)
    ids = torch.randint(0, config.vocab_size, (B, T), generator=torch.Generator().manual_seed(26)).cuda()

    # (a) rings: max_len T + GO_NEW passes W.
    label = "gpt-oss-20b qint4 (router, head bf16), stacked MoE, bf16 cache with rings, B = 4 x 1024"
    out["a"], rec, tape_a, tokens_a, logits_a = gpt_oss_run(
        label, model, ids, GO_NEW, {"qbits_mm_tiled": lin, "qbits_moe_tiled": moe},
        {"qbits_mm_small_m": lin, "qbits_moe_small_m": moe, "flash_decode": L}, tally=tally)
    steps = GO_NEW - 1
    want_tally = {"decode": L * steps, "decode_ring": half * steps, "decode_window": 0, "chunk_ring": 0}
    if {k: rec["decode_attention"].get(k, 0) for k in want_tally} != want_tally or \
            rec["prefill_attention"].get("chunk_ring") != half:
        raise RuntimeError(f"{label}: decode attention {rec['decode_attention']}, prefill {rec['prefill_attention']}")
    log(json.dumps({**rec, "build_s": build_s}))

    # (b) the unique-expert decode.
    ids16 = torch.randint(0, config.vocab_size, (B16, T16), generator=torch.Generator().manual_seed(260)).cuda()
    label = f"gpt-oss-20b qint4, stacked MoE, bf16 cache with rings, B = {B16} x {T16}"
    out["b"], rec, *_ = gpt_oss_run(
        label, model, ids16, GO_B16_NEW, {"qbits_mm_tiled": lin, "qbits_moe_tiled": moe},
        {"qbits_mm_small_m": lin, "qbits_moe_small_m": 2 * L, "qbits_moe_tiled": L, "qbits_moe_tiled_small_m": L,
         "flash_decode": L}, tally=tally)
    log(json.dumps(rec))

    # (c) flat caches: the sliding layers' decode through the window.
    label = f"gpt-oss-20b qint4, bf16 flat caches, B = 4 x 1024 + {GO_FLAT_NEW}"
    out["c"], rec, *_ = gpt_oss_run(
        label, model, ids, GO_FLAT_NEW, {"qbits_mm_tiled": lin, "qbits_moe_tiled": moe},
        {"qbits_mm_small_m": lin, "qbits_moe_small_m": moe, "flash_decode": L}, sliding_ring=False, tally=tally,
        plain=False, record=False)
    steps_c = GO_FLAT_NEW - 1
    want_tally = {"decode": L * steps_c, "decode_ring": 0, "decode_window": half * steps_c, "chunk_ring": 0}
    if {k: rec["decode_attention"].get(k, 0) for k in want_tally} != want_tally:
        raise RuntimeError(f"{label}: decode attention {rec['decode_attention']}, want {want_tally}")
    ring_cache, flat_cache = (make_cache(model, B, T + GO_NEW, sliding_ring=r) for r in (True, False))
    _, route_ring = prefill_routes(model, ids, ring_cache)
    _, route_flat = prefill_routes(model, ids, flat_cache)
    del ring_cache, flat_cache
    rec["routing_vs_rings"] = first_parting_ties(label + " vs (a)", route_flat, route_ring, top, GPT_OSS_ROUTE_TIE)
    del route_ring, route_flat
    with tape_a.use("replay"):
        _, logits_c = greedy_steps(model, ids, GO_FLAT_NEW, make_cache(model, B, T + GO_NEW, sliding_ring=False),
                                   forced=tokens_a[:, :GO_FLAT_NEW])
    rec["vs_rings_replayed"] = check_forced(f"phase 26 {label}: forced, (a)'s experts", tokens_a[:, :GO_FLAT_NEW],
                                            logits_a[:, :GO_FLAT_NEW], logits_c, GPT_OSS_RING_COS)
    log(json.dumps(rec))
    del logits_a, logits_c, tape_a
    for h in handles:
        h.remove()

    # (d) the engines: chunks of 512 over 128-slot rings. First every block's dispatch exact (no capacity):
    # with one, an expert keeps the top-capacity tokens of the forward it runs in, so a [4, 512] chunk and
    # `generate`'s [1, 300] prefill drop other tokens and compute two functions.
    for layer in model.model.layers:
        layer.mlp.capacity_factor = None
    rng = np.random.default_rng(261)
    prompts = [rng.integers(0, config.vocab_size, n).astype(np.int64) for n in GO_ENGINE_PROMPTS]
    C, new, max_len = GO_ENGINE_CHUNK, GO_ENGINE_NEW, GO_ENGINE_MAX_LEN
    n_chunks = [-(-n // C) for n in GO_ENGINE_PROMPTS]
    kw = dict(max_batch=len(prompts), max_len=max_len, prefill_chunk=C)
    dec_steps = new - 1

    def serve(engine, batched: bool, tape=None):
        """The prompts through `engine` (recording its expert choices by slot in
        `tape`); returns (tokens, launches, seconds with the tape's host copies,
        request ids)."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tape.use("record", rows=engine_rows(engine)) if tape else contextlib.nullcontext():
            rids = engine.add_batch(prompts, new) if batched else [engine.add(p, new) for p in prompts]
            engine.run_to_completion()
        torch.cuda.synchronize()
        return [engine.result(r) for r in rids], read_counts(), time.perf_counter() - t0, rids

    engine = BatchedEngine(model, sample_fn=(tap := EngineTap()), **kw)
    if not isinstance(engine._cache[0], tuple) or engine._cache[0][0].shape[1] != W:
        raise RuntimeError("phase 26(d): the dense engine's sliding layers hold no rings")
    got_batch, counts_batch, s_batch, rids = serve(engine, True, tape := RoutingTape(model))
    # [4, 512] chunks: M = 2048 through #2 and the gather (#14, slabs of 2048); decode steps of 4 rows:
    # selective.
    want_batch = {"qbits_mm_tiled": lin * max(n_chunks), "qbits_moe_tiled": moe * max(n_chunks),
                  "qbits_mm_small_m": lin * dec_steps, "qbits_moe_small_m": moe * dec_steps,
                  "flash_decode": L * dec_steps}
    check_counts("phase 26(d) batch arm", counts_batch, want_batch)
    # Each request through `generate`'s computation on the kernels, forced through the batch arm's tokens
    # and replaying its expert choices: every step's logits against the engine's.
    ties_batch = hold_to_generate("phase 26(d) batch arm vs generate (its tokens and experts)", model, prompts,
                                  engine, rids, tap, tape, GPT_OSS_ENGINE_COS, plain=False)
    want = [generate(model, torch.tensor(p[None], device="cuda"), new)[0, len(p):].tolist() for p in prompts]
    del engine, tape, tap
    engine = BatchedEngine(model, sample_fn=(tap := EngineTap()), **kw)
    got_serial, counts_serial, s_serial, rids = serve(engine, False, tape := RoutingTape(model))
    # [1, 512] chunks: M = 512 through #1 and the all-experts route (gate and up #12, down #14).
    chunk_moe = {"qbits_moe_small_m": 2 * L * sum(n_chunks) + moe * dec_steps, "qbits_moe_all": 2 * L * sum(n_chunks),
                 "qbits_moe_tiled": L * sum(n_chunks)}
    check_counts("phase 26(d) serial arm", counts_serial, {
        "qbits_mm_small_m": lin * (sum(n_chunks) + dec_steps), **chunk_moe, "flash_decode": L * dec_steps})
    # The serial arm against `generate`'s computation on the plain versions, forced and replayed as the
    # batch arm: this holds #12 at M = 512 and #14 over slabs of 512 to their plain versions end to end.
    ties_serial = hold_to_generate("phase 26(d) serial arm vs generate on the plain versions (its tokens and "
                                   "experts)", model, prompts, engine, rids, tap, tape, GPT_OSS_E2E_COS, plain=True)
    del engine, tape, tap
    paged = PagedEngine(model, n_pages=1 + len(prompts) * -(-max_len // 64), page_size=64, **kw)
    if paged.prefix_sharing or not isinstance(paged._cache[0], tuple) or \
            paged._cache[0][0].shape[1] != W or not hasattr(paged._cache[1], "_table"):
        raise RuntimeError("phase 26(d): PagedEngine did not build the paged+ring hybrid")
    got_paged, counts_paged, s_paged, _ = serve(paged, False)
    # The serial arm's launches, the 12 full layers' decode through the paged arm.
    check_counts("phase 26(d) paged arm", counts_paged, {
        "qbits_mm_small_m": lin * (sum(n_chunks) + dec_steps), **chunk_moe, "flash_decode": half * dec_steps,
        "flash_decode_paged": half * dec_steps})
    ties_paged = check_same_tokens("phase 26(d) paged arm vs the dense serial arm", model, prompts, got_paged,
                                   got_serial, max_len=max_len)
    del paged
    # The batch arm at the blocks' default capacity (2.0: slabs of 512 of a [4, 512] chunk's 2048 rows), where
    # `valid` gives the chunks' pad columns (and the finished rows' columns) no routing weight, so that they
    # take no slab row from a real token; against the same engine on the plain versions, forced through its
    # tokens and replaying its expert choices.
    for layer in model.model.layers:
        layer.mlp.capacity_factor = 2.0
    engine = BatchedEngine(model, sample_fn=(tap := EngineTap()), **kw)
    got_cap, counts_cap, s_cap, rids = serve(engine, True, tape := RoutingTape(model))
    check_counts("phase 26(d) capacity arm", counts_cap, want_batch)
    counts = read_counts()
    plain_engine = BatchedEngine(model, sample_fn=(plain_tap := EngineTap(forced=tap)), **kw)
    with plain_versions(), tape.use("replay", rows=engine_rows(plain_engine)):
        plain_rids = plain_engine.add_batch(prompts, new)
        plain_engine.run_to_completion()
    torch.cuda.synchronize()
    if read_counts() != counts or len(plain_tap.ids) != len(tap.ids):
        raise RuntimeError("phase 26(d) capacity arm: the plain engine launched a kernel or sampled otherwise")
    slots = [engine._requests[r].slot for r in rids]
    if [plain_engine._requests[r].slot for r in plain_rids] != slots:
        raise RuntimeError("phase 26(d) capacity arm: the plain engine took other slots")
    ties_cap = check_forced("phase 26(d) capacity arm vs the same engine on the plain versions (its tokens and "
                            "experts)", torch.tensor(got_cap, device="cuda"), tap.per_request(slots),
                            plain_tap.per_request(slots), GPT_OSS_E2E_COS)
    del engine, plain_engine, tape, tap, plain_tap
    log(json.dumps({"gpt_oss_engines": {
        "prompts": GO_ENGINE_PROMPTS, "chunk": C, "new_tokens": new, "max_len": max_len,
        "batch_s": s_batch, "serial_s": s_serial, "paged_s": s_paged, "capacity_s": s_cap,
        "batch_vs_generate": ties_batch, "serial_vs_plain_generate": ties_serial,
        "capacity_vs_plain_engine": ties_cap, "paged_vs_serial_ties": ties_paged,
        "paged_equal_serial": got_paged == got_serial, "capacity_equal_exact": got_cap == got_batch,
        # `generate` on its own expert choices: logged, not held (a flip at a tie moves every later token).
        "batch_equal_generate": [a == b for a, b in zip(got_batch, want)],
        "serial_equal_generate": [a == b for a, b in zip(got_serial, want)],
        "launches": {arm: {n: c for n, c in counts.items() if c} for arm, counts in
                     (("batch", counts_batch), ("serial", counts_serial), ("paged", counts_paged),
                      ("capacity", counts_cap))},
    }}))
    out["d_batch"], out["d_paged"] = counts_batch, counts_paged
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"gpt-oss: phase 26 took {time.perf_counter() - t_start:.1f} s")
    return out


def only_gpt_oss(K_mod, card: str) -> int:
    """`--only gpt_oss`: phase 3's rows at gpt-oss-20b's heads (with sinks)
    and experts, then phase 26."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    phase_flash_decode_gpt_oss(flush)
    phase_padded(K_mod, flush, GO_LINEAR_SHAPES, GO_LINEAR_M)
    phase_moe_gpt_oss(flush)
    del flush
    torch.cuda.empty_cache()
    phase_gpt_oss()
    log(card)
    log(json.dumps({"ok": True, "only": "gpt_oss", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def only_gemma3(card: str) -> int:
    """`--only gemma3`: phase 3's rows of `flash_prefill` and `flash_decode` at
    Gemma-3-12B's heads, then phase 24."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    phase_flash_decode_gemma2(flush, [r for r in FD_QK_NORM_ROWS if r[0].startswith("gemma-3")], tag="qk_norm")
    with only_rows(FP_ROWS, lambda r: r[0] == "gemma-3-12b"):
        phase_flash_prefill(flush)
    del flush
    torch.cuda.empty_cache()
    phase_gemma3()
    log(card)
    log(json.dumps({"ok": True, "only": "gemma3", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def only_qwen3(card: str) -> int:
    """`--only qwen3`: phase 3's rows at Qwen3-30B-A3B's heads and experts,
    then phase 25."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    phase_flash_decode_gemma2(flush, [r for r in FD_QK_NORM_ROWS if r[0].startswith("qwen3")], tag="qk_norm")
    with only_rows(FP_ROWS, lambda r: r[0] == "qwen3-30b-a3b"):
        phase_flash_prefill(flush)
    phase_moe_qwen3(flush)
    del flush
    torch.cuda.empty_cache()
    phase_qwen3()
    log(card)
    log(json.dumps({"ok": True, "only": "qwen3", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


@contextlib.contextmanager
def only_rows(rows: list, keep):
    """`rows` (a module-level list of phase-3 rows) cut to those `keep` takes, for the block."""
    saved = rows[:]
    rows[:] = [r for r in rows if keep(r)]
    try:
        yield
    finally:
        rows[:] = saved


def only_gemma(card: str) -> int:
    """`--only gemma`: phase 3's rows of `flash_prefill` and of `flash_decode`
    at D = 256, then phase 22 (Gemma-7B)."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    phase_flash_prefill(flush)
    phase_flash_decode(flush, heads=FD_GEMMA_HEADS, kinds=FD_CACHES)
    phase_flash_decode_paged(flush, heads=FD_GEMMA_HEADS, cases=FD_GEMMA_PAGED)
    del flush
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_gemma()
    log(f"gemma: phase 22 took {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "only": "gemma", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def only_gemma2(card: str) -> int:
    """`--only gemma2`: phase 3's Gemma-2 rows of `flash_decode` and
    `flash_prefill`, then phase 23 (Gemma-2-9B)."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    phase_flash_decode_gemma2(flush)
    with only_rows(FP_ROWS, lambda r: r[0] == "gemma-2-9b"):
        phase_flash_prefill(flush)
    del flush
    torch.cuda.empty_cache()
    phase_gemma2()
    log(card)
    log(json.dumps({"ok": True, "only": "gemma2", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def only_speculative(card: str) -> int:
    """`--only speculative`: phase 21 alone (after phases 1-2)."""
    from quanto_tpu_torch.models.llama import LlamaConfig

    ids = torch.randint(
        0, LLAMA31_8B["vocab_size"], (B, T), generator=torch.Generator().manual_seed(7)
    ).cuda()
    phase_speculative(LlamaConfig(**dict(LLAMA31_8B, num_hidden_layers=SPEC_LAYERS), dtype=torch.bfloat16), ids)
    log(card)
    log(json.dumps({"ok": True, "only": "speculative", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


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
    """`--only prefill`: the prefill paths of TPU #2, #3, #14 and #16, for
    timing a tree's kernels against another's. Phase 3's #2 rows (both arms,
    both widths), requant and MoE rows (and the W4A8 and `flash_decode` rows
    phase 10 reads), `flash_prefill`'s rows; phase 4's qint4 prefill (B = 4 x
    1024, no decode); phase 7's exact-form W4A8 prefill, then phase 10 on that
    model frozen into the requant form; phases 8 and 12 (B = 4, then 1); phase
    11's B = 1 prefill; phase 13 (a, b). The 2-layer checks of phases 5, 9, 11,
    12 and 13 are left to the full run."""
    from quanto_tpu_torch import freeze
    from quanto_tpu_torch.models.llama import LlamaConfig
    from quanto_tpu_torch.models.mixtral import MixtralConfig
    from quanto_tpu_torch.models.serve import generate

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    tiled = {"qbits_mm_tiled"}
    rows = (phase_kernels(K_mod, flush, names=tiled) + phase_kernels(K_mod, flush, bits=2, names=tiled)
            + phase_w4a8(K_mod, flush) + phase_w4a8(K_mod, flush, bits=2, names={"qbits_mm_tiled_int8"})
            + phase_flash_decode(flush) + phase_requant(K_mod, flush)
            + phase_requant(K_mod, flush, bits=2) + phase_moe(flush) + phase_moe(flush, bits=2)
            + phase_flash_prefill(flush))
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
    if only not in (None, "sweep,serving", "prefill", "qbytes,moe", "decode", "checkpoint", "numerics", "paged",
                    "speculative", "gemma", "gemma2", "gemma3", "qwen3", "gpt_oss"):
        print(f"chip_smoke: --only takes sweep,serving, prefill, qbytes,moe, decode, checkpoint, numerics, "
              f"paged, speculative, gemma, gemma2, gemma3, qwen3 or gpt_oss, got {only}", file=sys.stderr)
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
    PTXAS.update(ptxas_entries(info["log"]))
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
    if only == "speculative":
        return only_speculative(card)
    if only == "gemma":
        return only_gemma(card)
    if only == "gemma2":
        return only_gemma2(card)
    if only == "gemma3":
        return only_gemma3(card)
    if only == "qwen3":
        return only_qwen3(card)
    if only == "gpt_oss":
        return only_gpt_oss(K_mod, card)
    if only:
        return only_sweep_and_serving(K_mod, card)

    # Phase 3: kernels vs plain.
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    rows = (phase_kernels(K_mod, flush) + phase_small_m_sweep(K_mod, flush) + phase_flash_decode(flush)
            + phase_flash_decode_paged(flush) + phase_flash_prefill(flush)
            + phase_flash_decode(flush, heads=FD_GEMMA_HEADS, kinds=FD_CACHES)
            + phase_flash_decode_paged(flush, heads=FD_GEMMA_HEADS, cases=FD_GEMMA_PAGED)
            + phase_flash_decode_gemma2(flush) + phase_flash_decode_gemma2(flush, FD_QK_NORM_ROWS, tag="qk_norm")
            + phase_flash_decode_gpt_oss(flush)
            + phase_qbytes(flush)
            + phase_w4a8(K_mod, flush) + phase_requant(K_mod, flush) + phase_moe(flush) + phase_moe_qwen3(flush)
            + phase_moe_gpt_oss(flush) + phase_padded(K_mod, flush, GO_LINEAR_SHAPES, GO_LINEAR_M)
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

    # Phase 22: Gemma-7B at full width, 4 layers, through flash_prefill and flash_decode at D = 256.
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gemma = phase_gemma()
    log(f"gemma: phase 22 took {time.perf_counter() - t0:.1f} s")

    # Phase 23: Gemma-2-9B at full depth and width: softcaps, rings, windows, the engines' write_len
    # and the paged+ring hybrid.
    gc.collect()
    torch.cuda.empty_cache()
    gemma2 = phase_gemma2()

    # Phase 24: Gemma-3-12B at full depth and width: q/k norms, the dual rope, 1024-slot rings on 40
    # of 48 layers, the engines.
    gc.collect()
    torch.cuda.empty_cache()
    gemma3 = phase_gemma3()

    # Phase 25: Qwen3-30B-A3B (128 experts, top-8) at full depth and width, and Qwen3-8B.
    gc.collect()
    torch.cuda.empty_cache()
    qwen3 = phase_qwen3()

    # Phase 26: openai/gpt-oss-20b (32 experts, top-4; sinks; 128-slot rings) at full depth and width.
    gc.collect()
    torch.cuda.empty_cache()
    gpt_oss = phase_gpt_oss()

    # Phase 21: speculative decoding (greedy and sampled, a qint4 draft and a layer-skip draft).
    gc.collect()
    torch.cuda.empty_cache()
    speculative = phase_speculative(LlamaConfig(**dict(LLAMA31_8B, num_hidden_layers=SPEC_LAYERS),
                                                dtype=torch.bfloat16), ids)

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
        "flash_prefill": ("phase 4 (ctx 1088, its prefill)", launches_1088),
    }
    kernels = []
    for name in [*KERNEL_M, "flash_decode", "flash_decode_paged", "flash_prefill", *QBYTES_M, *W4A8_M,
                 "qbits_mm_requant_int8",
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
            rep = next(r for r in mine if (r["cache"], r["S"], r["page_size"], r["q"], r["D"])
                       == (*FD_PAGED_SUMMARY, "bf16", FD_HEADS[2]))
            shape = dict(cache=rep["cache"], B=rep["B"], S=rep["S"], page_size=rep["page_size"], Hkv=FD_HEADS[0],
                         G=FD_HEADS[1], D=FD_HEADS[2])
        elif name == "flash_prefill":  # the main path's: Llama-3.1-8B's heads, bf16, B = 4 x 1024
            rep = next(r for r in mine if (r["model"], r["softcap"], r["dtype"]) == (FP_ROWS[0][0], None, "bfloat16"))
            shape = dict(model=rep["model"], B=B, T=T, Hkv=rep["Hkv"], G=rep["G"], D=rep["D"])
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
        phase21 = {arm: c[name] for arm, c in speculative.items() if c.get(name)}
        if phase21:
            extra["launches_phase21"] = phase21
        if name == "flash_decode_paged":
            extra = {"launches_phase20c": launches_paged["c"][name], "dense_ms": rep["dense_ms"],
                     "gather_dense_ms": rep["gather_dense_ms"]}
        if name in ("flash_prefill", "flash_decode"):  # phases 22 and 23, Gemma-7B and Gemma-2-9B at D = 256
            extra["launches_phase22"] = {cache: c[name] for cache, c in gemma.items()}
            extra["launches_phase23"] = {arm: c[name] for arm, c in gemma2.items()}
        if name == "flash_decode":
            extra["gemma2_rows"] = {f"{r['gemma2']} {r['cache']} S={r['S']} D={r['D']}": dict(
                ms=r["ms"], bound_ms=r["bound_ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"])
                for r in mine if r.get("gemma2")}
        if name == "flash_prefill":
            extra["rows"] = {f"{r['model']} {r['dtype']}{' softcap' if r['softcap'] else ''}": dict(
                ms=r["ms"], bound_ms=r["bound_ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"])
                for r in mine}
        if name == "qbits_mm_partitioned":  # ms: the rank-local product; the row shard's all_reduce beside it
            extra = {"all_reduce_ms": {k: v / 1e3 for k, v in tp["all_reduce_us"].items()}, "note": TP_LABEL}
        for phase, runs in (("24", gemma3), ("25", qwen3), ("26", gpt_oss)):  # Gemma-3; Qwen3; gpt-oss-20b
            got = {arm: c[name] for arm, c in runs.items() if c.get(name)}
            if got:
                extra[f"launches_phase{phase}"] = got
        # Phase 3's rows at gpt-oss-20b's heads (sinks), padded attention linears and experts.
        go_rows = [r for r in mine if r.get("gpt_oss") or r.get("padded") == "gpt-oss-20b"]
        if go_rows:
            extra["gpt_oss_rows"] = {
                (f"{r['gpt_oss']} {r['cache']} S={r['S']} q={r['q']}" if name == "flash_decode" else
                 f"paged {r['cache']} S={r['S']} ps={r['page_size']}" if name == "flash_decode_paged" else
                 f"M={r['M']} {r['N']}x{r['K']} gs {r['group_size']}" if r.get("padded") else
                 f"{r['form']} U={r['U']} M={r['M']} {r['N']}x{r['K']}"): dict(
                        ms=r["ms"], bound_ms=r["bound_ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"])
                    for r in go_rows}
        if name == "flash_decode" or name.startswith("qbits_moe"):  # phase 3's rows at the new shapes
            new_rows = [r for r in mine if r.get("qk_norm") or r.get("qwen3")]
            if new_rows:
                extra["qk_norm_family_rows"] = {
                    (r["qk_norm"] + f" {r['cache']} S={r['S']}" if r.get("qk_norm") else
                     f"qwen3-30b-a3b {r['form']} U={r['U']} M={r['M']} {r['N']}x{r['K']}"): dict(
                        ms=r["ms"], bound_ms=r["bound_ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"])
                    for r in new_rows}
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
