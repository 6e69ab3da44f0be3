"""Speculative decoding: a small (typically more aggressively quantized)
draft model proposes k tokens a round; the target model verifies all k+1
positions in ONE batched forward and keeps the longest matching prefix plus
one corrected or bonus token.

Counterpart of `quanto_tpu/models/speculative.py`, with its names. JAX runs
R rounds as one jitted `lax.scan`; PyTorch runs eagerly, so a decode fn is a
Python loop of R rounds, each k draft forwards, the draft's extra write and
one target forward. Every value a round computes stays on the device:
positions are int32 [B] tensors, and the accepted lengths, the blocks and
the next token come from cumprod / gather / where, so the R rounds of a call
run without a host sync (the blocks and counts are read once a call, by
`SpeculativeGenerator.generate`). The decode fns take the modules where
JAX's take a graphdef and its state.

Per-row positions let rows accept different amounts. Rejected cache slots
are never cleaned: both caches are rewritten by the next round's write
window before any query attends them (the write offset only moves forward,
and the causal mask hides every slot at or beyond the query's position).
The caches are flat (`serve.make_cache(..., sliding_ring=False)`), also for
a sliding-window target such as Gemma-2 or gpt-oss, where JAX builds rings: a round
rewrites slots that a rejected draft wrote, which a flat cache allows and a
ring, whose slots alias positions W apart, would not. Past W the window
bites through `flash_decode`'s `window` and the verify's sliding mask.

Greedy mode: the output is the target model's own greedy continuation,
token for token, up to the target's numerics across forward shapes (see
`speculative_generate`).

Stochastic mode (`temperature > 0`): rejection sampling. Draft token
x_i ~ q_i is accepted with probability min(1, p_i(x_i) / q_i(x_i)); at the
first rejection the replacement is drawn from norm(max(0, p_i - q_i)), and a
full acceptance draws the bonus token from p_k. Each emitted token is then
distributed as the warped target distribution, whatever the draft
(Leviathan et al., 2023). p and q are softmax(warp(.)) in float32, with the
same `sampling.make_logits_warp` filter. Every draw is `sampling.categorical`
(the Gumbel-max rule) or a uniform, from one `torch.Generator`, in this
order: the first token after the prefill, then in each round
  1. the k draft tokens, one [B, V] draw each;
  2. u [B, k] for the acceptance test;
  3. the correction, one [B, V] draw.
JAX splits a PRNG key per round instead, so the port's draws are not JAX's:
sampled outputs agree with JAX's in distribution, never token for token.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .sampling import categorical, greedy, make_logits_warp
from .serve import make_cache, prefill


__all__ = [
    "SpeculativeGenerator",
    "layerskip_draft",
    "make_speculative_decode_fn",
    "make_speculative_sample_decode_fn",
    "speculative_generate",
]


def _start(tok: torch.Tensor, pos0) -> torch.Tensor:
    """`pos0` (an int or [B]) as int32 [B] on `tok`'s device, made there:
    a Python int is filled in by a kernel, not copied from the host."""
    B = tok.shape[0]
    if torch.is_tensor(pos0):
        return pos0.to(device=tok.device, dtype=torch.int32).reshape(-1).expand(B).contiguous()
    return torch.full((B,), int(pos0), dtype=torch.int32, device=tok.device)


def _block(drafts: torch.Tensor, n_acc: torch.Tensor, correction: torch.Tensor) -> torch.Tensor:
    """A round's [B, k+1] block: the n_acc accepted drafts, the correction,
    then zeros (`speculative.py:96-106`)."""
    k = drafts.shape[1]
    ar = torch.arange(k + 1, device=drafts.device)[None, :]
    drafts_pad = torch.cat([drafts, torch.zeros_like(correction)], dim=1)
    n = n_acc[:, None]
    return torch.where(ar < n, drafts_pad, torch.where(ar == n, correction, torch.zeros_like(drafts_pad)))


def _run_rounds(round_fn: Callable, n_rounds: int, tok, t_cache, d_cache, pos0):
    """R rounds of `round_fn(tok, pos, t_cache, d_cache) -> (correction,
    pos, t_cache, d_cache, block, counts)`; returns (blocks [B, R, k+1],
    counts [B, R], t_cache, d_cache, pos [B])."""
    pos = _start(tok, pos0)
    blocks, counts = [], []
    for _ in range(n_rounds):
        tok, pos, t_cache, d_cache, block, count = round_fn(tok, pos, t_cache, d_cache)
        blocks.append(block)
        counts.append(count)
    return torch.stack(blocks, dim=1), torch.stack(counts, dim=1), t_cache, d_cache, pos


def make_speculative_decode_fn(target, draft, n_rounds: int, k: int):
    """The greedy speculative decode of `n_rounds` rounds.

    Returns fn(tok [B, 1], t_cache, d_cache, pos0) -> (blocks [B, R, k+1],
    counts [B, R], t_cache, d_cache, pos [B]) where round r contributes
    `counts[b, r]` valid tokens in `blocks[b, r, :]` (accepted drafts, then
    the correction or bonus token). `tok` must already be an emitted token
    (say the argmax of the prefill logits) whose KV is not yet written;
    `pos0` (an int or [B]) is its position."""

    @torch.no_grad()
    def round_fn(tok, pos, t_cache, d_cache):
        # Draft k tokens autoregressively (k cheap forwards).
        dtok, drafts = tok, []
        for i in range(k):
            dlogits, d_cache = draft(dtok, d_cache, pos + i)
            dtok = greedy(dlogits[:, -1]).to(tok.dtype)[:, None]
            drafts.append(dtok)
        drafts = torch.cat(drafts, dim=1)  # [B, k]
        # Write the last draft's KV so a full acceptance leaves the draft
        # cache complete up to the next round's start position.
        _, d_cache = draft(drafts[:, -1:], d_cache, pos + k)

        # One target forward verifies all k+1 positions.
        t_logits, t_cache = target(torch.cat([tok, drafts], dim=1), t_cache, pos)
        preds = greedy(t_logits).to(tok.dtype)  # [B, k+1]

        # Accepted drafts: the longest prefix where the target agrees.
        match = (preds[:, :k] == drafts).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)  # [B], 0..k
        correction = torch.gather(preds, 1, n_acc[:, None])  # [B, 1]
        counts = (n_acc + 1).to(torch.int32)
        return correction, pos + counts, t_cache, d_cache, _block(drafts, n_acc, correction), counts

    def spec_decode(tok, t_cache, d_cache, pos0):
        return _run_rounds(round_fn, n_rounds, tok, t_cache, d_cache, pos0)

    return spec_decode


def make_speculative_sample_decode_fn(target, draft, n_rounds: int, k: int, warp=None):
    """The stochastic speculative decode (rejection sampling) of `n_rounds`
    rounds: fn(tok, t_cache, d_cache, pos0, generator) with the returns of
    `make_speculative_decode_fn`; `generator` is a `torch.Generator` on the
    models' device, drawn from in the module docstring's order.
    `warp(logits) -> float32 logits` applies temperature / top-k / top-p
    (`sampling.make_logits_warp`); emitted tokens are exact samples of
    softmax(warp(target logits))."""
    if warp is None:
        warp = lambda logits: logits.float()  # noqa: E731

    @torch.no_grad()
    def round_fn(tok, pos, t_cache, d_cache, generator):
        B = tok.shape[0]
        # Draft k tokens ~ q_i, keeping each full draft distribution (the
        # acceptance test and the residual need them).
        dtok, drafts, qs = tok, [], []
        for i in range(k):
            dlogits, d_cache = draft(dtok, d_cache, pos + i)
            wl = warp(dlogits[:, -1])  # [B, V]
            dtok = categorical(wl, generator).to(tok.dtype)[:, None]
            drafts.append(dtok)
            qs.append(torch.softmax(wl, dim=-1))
        drafts = torch.cat(drafts, dim=1)  # [B, k]
        qs = torch.stack(qs, dim=1)  # [B, k, V]
        # Keep the draft cache complete on full acceptance (see greedy).
        _, d_cache = draft(drafts[:, -1:], d_cache, pos + k)

        # One target forward gives p_0..p_k for all k+1 positions.
        t_logits, t_cache = target(torch.cat([tok, drafts], dim=1), t_cache, pos)
        ps = torch.softmax(warp(t_logits), dim=-1)  # [B, k+1, V]

        # Accept draft i iff u_i < p_i(x_i) / q_i(x_i), written u * q < p to
        # avoid the division: a q(x) that underflows to 0 accepts whenever
        # p > 0, the limit of min(1, p / q).
        p_x = torch.gather(ps[:, :k], 2, drafts[..., None])[..., 0]
        q_x = torch.gather(qs, 2, drafts[..., None])[..., 0]
        u = torch.rand((B, k), generator=generator, device=tok.device)
        accept = (u * q_x < p_x).to(torch.int32)
        n_acc = torch.cumprod(accept, dim=1).sum(dim=1)  # [B], 0..k

        # The replacement from the residual norm(max(0, p - q)) at the first
        # rejected position; a zero q row padded at index k makes a full
        # acceptance draw the bonus token from p_k itself.
        V = ps.shape[-1]
        qs_pad = torch.cat([qs, torch.zeros_like(ps[:, :1])], dim=1)
        sel = n_acc[:, None, None].expand(B, 1, V)
        p_sel = torch.gather(ps, 1, sel)[:, 0]
        q_sel = torch.gather(qs_pad, 1, sel)[:, 0]
        resid = torch.clamp_min(p_sel - q_sel, 0.0)
        norm = resid.sum(dim=-1, keepdim=True)
        # norm == 0 only where p <= q everywhere (p == q): fall back to p.
        repl = torch.where(norm > 0, resid / torch.where(norm > 0, norm, torch.ones_like(norm)), p_sel)
        correction = categorical(torch.log(repl), generator).to(tok.dtype)[:, None]
        counts = (n_acc + 1).to(torch.int32)
        return correction, pos + counts, t_cache, d_cache, _block(drafts, n_acc, correction), counts

    def spec_decode(tok, t_cache, d_cache, pos0, generator):
        return _run_rounds(
            lambda *carry: round_fn(*carry, generator), n_rounds, tok, t_cache, d_cache, pos0
        )

    return spec_decode


class SpeculativeGenerator:
    """Reusable speculative generation (`speculative.py:220-340`).

    JAX builds its jitted prefill and spec-step programs once here, so that
    repeated calls pay no re-trace; eager PyTorch has nothing to compile, so
    this class holds the models and the warp and makes a decode fn per
    `generate` call. Target and draft must lie on one device and share the
    vocabulary."""

    def __init__(
        self,
        target,
        draft,
        k: int = 4,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ):
        if target.device != draft.device:
            raise ValueError(f"target on {target.device} and draft on {draft.device}: put both on one device")
        if target.config.vocab_size != draft.config.vocab_size:
            raise ValueError(
                f"target vocabulary {target.config.vocab_size} != draft vocabulary {draft.config.vocab_size}"
            )
        self.target, self.draft, self.k = target, draft, k
        self._warp = None if temperature == 0.0 else make_logits_warp(temperature, top_k, top_p)

    @torch.no_grad()
    def generate(
        self,
        input_ids: torch.Tensor,
        max_new_tokens: int,
        cache_len: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, float]:
        """Generate; returns (ids [B, T + max_new_tokens], acceptance) (see
        `speculative_generate`). A sampling generator given no `generator`
        draws from one seeded with 0, as JAX starts from `PRNGKey(0)`."""
        k = self.k
        dev = self.target.device
        ids = input_ids.to(dev)
        B, T = ids.shape
        rounds = max(1, -(-max_new_tokens // (k + 1)))
        # Worst-case cache bound (JAX's formula, `speculative.py:279-285`):
        # the host loop runs until the SLOWEST row has max_new tokens (at
        # most ceil((max_new - 1) / rounds) calls, each round advancing a row
        # by at most k+1), and every round writes k+1 slots ahead of its
        # start. It must hold: a write past the cache raises here (JAX's
        # dynamic_update_slice clamps instead).
        chunks_bound = max(1, -(-(max_new_tokens - 1) // rounds))
        cache_len = cache_len or (T + 1 + k + chunks_bound * rounds * (k + 1))

        t_cache = make_cache(self.target, B, cache_len, sliding_ring=False)
        d_cache = make_cache(self.draft, B, cache_len, sliding_ring=False)
        # Only the last position's logits are used from either prefill (the
        # draft's are discarded outright).
        logits, t_cache = prefill(self.target, ids, t_cache, last_only=True)
        _, d_cache = prefill(self.draft, ids, d_cache, last_only=True)

        if self._warp is None:
            first = greedy(logits[:, -1]).to(ids.dtype)[:, None]
            step = make_speculative_decode_fn(self.target, self.draft, rounds, k)
        else:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            first = categorical(self._warp(logits[:, -1]), generator).to(ids.dtype)[:, None]
            spec = make_speculative_sample_decode_fn(self.target, self.draft, rounds, k, self._warp)
            step = lambda *args: spec(*args, generator)  # noqa: E731

        produced = np.ones((B,), np.int64)  # `first` already emitted
        tok, pos = first, T
        acc_total, acc_rounds = 0.0, 0
        rows = [[] for _ in range(B)]
        while (produced < max_new_tokens).any():
            blocks, counts, t_cache, d_cache, pos = step(tok, t_cache, d_cache, pos)
            # Continue from the last correction token of the final round.
            tok = blocks[torch.arange(B, device=dev), -1, counts[:, -1].long() - 1][:, None]
            blocks_h, counts_h = blocks.cpu().numpy(), counts.cpu().numpy()
            for b in range(B):
                for r in range(counts_h.shape[1]):
                    rows[b].extend(blocks_h[b, r, : counts_h[b, r]].tolist())
            produced = 1 + np.asarray([len(r) for r in rows])
            acc_total += float(counts_h.sum() - counts_h.size)  # accepted drafts
            acc_rounds += counts_h.size
        rest = torch.tensor([r[: max_new_tokens - 1] for r in rows], dtype=ids.dtype, device=dev)
        out = torch.cat([ids, first, rest.reshape(B, max_new_tokens - 1)], dim=1)
        acceptance = acc_total / (acc_rounds * k) if acc_rounds else 0.0
        return out, acceptance


def speculative_generate(
    target,
    draft,
    input_ids: torch.Tensor,
    max_new_tokens: int,
    k: int = 4,
    cache_len: Optional[int] = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, float]:
    """One-shot speculative generation; returns (ids, acceptance), where
    `acceptance` is the mean accepted drafts per round over k.

    With `temperature == 0` (the default) the output is the target model's
    own greedy generation (`serve.generate`); with `temperature > 0` each
    token is an exact sample of the temperature / top-k / top-p warped
    target distribution, by rejection sampling. Either way the draft only
    changes the cost per token. Draft and target must share the vocabulary.

    Exactness caveat shared with every speculative implementation: "the
    target's greedy output" holds up to the target's own numerics across
    forward shapes. The verify pass runs [B, k+1] tokens at once (its
    linears at M = B (k+1), its attention the float32 chain over the cache),
    the decode forward [B, 1] (M = B, `flash_decode`); they sum in other
    orders, so in bf16 an argmax near-tie can resolve differently. Exact in
    float32 on the CPU."""
    gen = SpeculativeGenerator(target, draft, k, temperature=temperature, top_k=top_k, top_p=top_p)
    return gen.generate(input_ids, max_new_tokens, cache_len=cache_len, generator=generator)


def _graft(dst: nn.Module, src: nn.Module, lists: set, prefix: str = "") -> None:
    """Make `dst`'s modules `src`'s objects: every child is replaced by the
    module at its path in `src`, except the ancestors of the module lists
    cut short (`lists`), whose children are grafted in turn and whose own
    parameters and buffers become `src`'s tensors."""
    for name, _ in [*dst.named_parameters(recurse=False), *dst.named_buffers(recurse=False)]:
        setattr(dst, name, getattr(src, name))
    for name, child in list(dst.named_children()):
        path = prefix + name
        if any(p == path or p.startswith(path + ".") for p in lists):
            _graft(child, src.get_submodule(name), lists, path + ".")
        else:
            setattr(dst, name, src.get_submodule(name))


def layerskip_draft(target, num_layers: int):
    """Self-speculative (layer-skip) draft: a `num_layers`-deep copy of the
    target SHARING its weights (the embedding, the first `num_layers`
    decoder layers, the final norm, the lm_head, the rotary frequencies), so
    it adds no bytes on the device and reads about num_layers / L of a
    step's weights plus the head (`speculative.py:380-442`; the "Draft &
    Verify" recipe, Zhang et al., 2023).

    The target's class is built on "meta" with `num_hidden_layers =
    num_layers`, then each of its modules is replaced by the target's module
    at the same path (the decoder layers one by one); quantized or not, the
    draft runs the target's own modules. Raises where a path of the shallow
    model is missing from the target (a family whose modules do not line
    up). Caches made for the draft (`serve.make_cache`) have `num_layers`
    layers. Pass it as `SpeculativeGenerator(target, layerskip_draft(target,
    n), ...)`."""
    cfg = dataclasses.replace(target.config, num_hidden_layers=num_layers)
    draft = type(target)(cfg, device="meta")
    target_paths = {name for name, _ in target.named_modules()}
    missing = [name for name, _ in draft.named_modules() if name not in target_paths]
    if missing:
        raise ValueError(
            f"layerskip_draft: the target lacks module paths {missing[:3]}...: this family's shallow "
            "model is not path-compatible"
        )
    lists = {
        name for name, m in draft.named_modules()
        if isinstance(m, nn.ModuleList) and len(m) != len(target.get_submodule(name))
    }
    _graft(draft, target, lists)
    draft.attn_scale, draft.tp = target.attn_scale, target.tp
    return draft
