"""Continuous-batching serving engine.

Counterpart of `quanto_tpu/models/serving.py:BatchedEngine` (`:58-790`):
slot-based continuous batching over one pooled KV cache
[max_batch, max_len, Hkv, D], float or quantized (`make_cache(kv_quant=...)`):
- `add` prefills a prompt into a free slot (in fixed `prefill_chunk` pieces
  when that is set); `add_batch` prefills several prompts together, one
  [max_batch, prefill_chunk] forward over the pool per chunk;
- `enqueue` admits a request without prefilling it; `serve_step` then feeds
  its prompt chunk by chunk through mixed steps, each one [max_batch,
  prefill_chunk] forward in which the decoding rows emit a token too;
- `step` decodes one token for every active slot (one [max_batch, 1]
  forward with per-slot positions), `decode_burst(n)` n of them;
- finished slots are released and reused at once.

The host state is JAX's: `_pos` and `_last_tok` as numpy, the request and
slot tables, the admission queue. Differences by design:
- PyTorch runs eagerly, so each of JAX's compiled programs is one forward
  call, and `decode_burst` is a Python loop of steps (JAX scans them in one
  program). It fetches its tokens once at the end, and it draws from the
  engine's generator in the order `step()` does, so burst tokens equal
  stepwise tokens for any sampler.
- A prompt is prefilled in place into a view of its slot in the pool, for
  float and quantized caches alike (`kv_update` writes in place), where JAX
  prefills a fresh one-slot cache and scatters it into the pool
  (`_scatter_slot`). The slot's entries past the prompt keep an earlier
  request's values, which the attention mask hides, as it hides the padding
  of a chunk and the rows' garbage chunk writes.
- A sampler takes `(logits, generator)`: the engine's `torch.Generator` on
  the model's device, seeded with 0, as JAX's engine starts from key 0.
- Not ported here: `mesh` (tensor- and sequence-parallel serving wait for
  the parallel layer), ring caches and their `write_len` (sliding-window
  models, ROADMAP.md Queue 1, item 8) and `DistributedEngine` (item 10).

`PagedEngine` (`serving.py:793-1196`) serves over a paged cache
(`tensor/paged_kv.py`): prefix sharing, on-demand page growth and preemption
with exact recompute, as JAX's; its decode attention reads the pages through
the table (`ops/cuda/flash_decode.py:flash_decode_paged`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..tensor.kv_cache import slot_view
from .sampling import greedy
from .serve import make_cache


__all__ = ["BatchedEngine", "PagedEngine"]


@dataclasses.dataclass
class _Request:
    rid: int
    slot: int
    prompt_len: int
    max_new_tokens: int
    tokens: List[int]
    done: bool = False
    # The prompt ids of an enqueue()'d request whose prefill is pending.
    prompt: Optional[np.ndarray] = None


@dataclasses.dataclass
class _PrefillState:
    """An admitted request whose prompt is prefilled chunk by chunk,
    interleaved with decode (mixed steps)."""

    req: _Request
    next_chunk: int = 0


class BatchedEngine:
    """Slot-based continuous batching (module docstring) on the model's
    device. `sample_fn(logits [n, V], generator) -> ids [n]`, greedy by
    default."""

    def __init__(
        self,
        model,
        max_batch: int = 8,
        max_len: int = 512,
        kv_quant=None,
        eos_token_id: Optional[int] = None,
        sample_fn: Optional[Callable] = None,
        prefill_chunk: Optional[int] = None,
    ):
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_token_id = eos_token_id
        # Chunked prefill: prompts go in fixed `prefill_chunk`-token pieces,
        # padded at the end. Padding past the prompt's end is never read:
        # decode step q overwrites position q before attending, and the
        # causal mask hides the rest.
        self.prefill_chunk = prefill_chunk
        self._device = model.device
        self._cache = self._make_cache(kv_quant)
        self._pos = np.zeros((max_batch,), np.int32)  # next write position per slot
        self._last_tok = np.zeros((max_batch,), np.int32)
        self._free = list(range(max_batch))
        self._requests: Dict[int, _Request] = {}
        self._by_slot: Dict[int, _Request] = {}
        self._prefill_by_slot: Dict[int, _PrefillState] = {}
        self._queue: List[_Request] = []  # enqueue()'d, awaiting a free slot
        self._next_rid = 0
        self._sample = sample_fn or greedy
        self._generator = torch.Generator(device=self._device).manual_seed(0)

    def _make_cache(self, kv_quant):
        """The pooled cache [max_batch, max_len] on the model's device."""
        return make_cache(self.model, self.max_batch, self.max_len, kv_quant=kv_quant)

    # --- device calls ---------------------------------------------------------

    @torch.no_grad()
    def _forward(self, ids, cache, pos, last_idx) -> torch.Tensor:
        """One forward of `ids` [B, T] written at `pos` (an int, or one
        position per row) over `cache`; returns each row's logits at
        `last_idx` (an int or one per row, clipped into the T columns) [B, V]."""
        dev = self._device
        ids = torch.as_tensor(ids, device=dev)
        if not isinstance(pos, int):
            pos = torch.as_tensor(pos, device=dev).long()
        if not isinstance(last_idx, int):
            last_idx = torch.as_tensor(last_idx, device=dev).long().clamp(0, ids.shape[1] - 1)
        logits, _ = self.model(ids, cache, pos, logits_indices=last_idx)
        return logits[:, 0]

    def _sample_host(self, logits: torch.Tensor) -> np.ndarray:
        """Sample on the device from the engine's generator, fetch the ids."""
        return self._sample(logits, self._generator).to(torch.int32).cpu().numpy()

    def _prefill_into(self, slot: int, prompt: np.ndarray, start_pos: int = 0) -> torch.Tensor:
        """Prefill `prompt` into the pool's `slot` in place, from
        `start_pos`; returns the last real token's logits [1, V]. Fixed-shape
        chunks when `prefill_chunk` is set, the whole prompt otherwise."""
        view = tuple(slot_view(layer, slot) for layer in self._cache)
        C = self.prefill_chunk
        if C is None:
            return self._forward(prompt[None, :], view, start_pos, len(prompt) - 1)
        last = None
        n = len(prompt)
        c0 = 0
        while c0 < n:
            chunk = prompt[c0 : c0 + C]
            r = len(chunk)
            if r < C and start_pos + c0 + C > self.max_len:
                # Padding would spill past the cache: run the remainder at its
                # own length.
                return self._forward(chunk[None, :], view, start_pos + c0, r - 1)
            if r < C:
                chunk = np.pad(chunk, (0, C - r))
            last = self._forward(chunk[None, :], view, start_pos + c0, r - 1)
            c0 += C
        return last

    # --- request lifecycle ----------------------------------------------------

    def can_add(self) -> bool:
        return len(self._free) > 0

    def _register(self, slot: int, prompt_len: int, max_new_tokens: int, first_tok: int,
                  prompt: Optional[np.ndarray] = None) -> int:
        """Register a prefilled request in `slot` with its first token (JAX
        inlines this in `add`); `prompt` is kept for a paged engine's recompute."""
        self._pos[slot] = prompt_len
        self._last_tok[slot] = first_tok
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, slot, prompt_len, max_new_tokens, [first_tok], prompt=prompt)
        self._requests[rid] = req
        self._by_slot[slot] = req
        self._maybe_finish(req, first_tok)
        return rid

    def add(self, prompt_ids, max_new_tokens: int = 64) -> int:
        """Prefill a prompt into a free slot; returns the request id."""
        if not self._free:
            raise RuntimeError("no free slots (call step() until one finishes)")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds engine max_len")
        slot = self._free.pop()
        last_logits = self._prefill_into(slot, prompt)
        first_tok = int(self._sample_host(last_logits)[0])
        return self._register(slot, len(prompt), max_new_tokens, first_tok)

    def add_batch(self, prompts, max_new_tokens=64) -> List[int]:
        """Admit several requests at once, prefilling them together.

        Each fixed-size chunk is one forward over every slot of the pool, so
        k prompts cost ceil(max len / chunk) forwards, not the sum of their
        chunk counts. Requires `prefill_chunk`; prompts whose padded length
        would spill past max_len, and any overflow beyond the free slots, go
        through serial `add()`. Slots not being prefilled (mid-generation or
        free) run their row at their current position: its chunk writes land
        at positions >= their next decode position, which decode overwrites
        before attending. `max_new_tokens`: scalar or per-prompt list.
        """
        C = self.prefill_chunk
        budgets = (
            list(max_new_tokens)
            if isinstance(max_new_tokens, (list, tuple))
            else [max_new_tokens] * len(prompts)
        )
        if len(budgets) != len(prompts):
            raise ValueError("max_new_tokens list must match prompts")
        if C is None:
            return [self.add(p, m) for p, m in zip(prompts, budgets)]
        # An active slot whose next position exceeds max_len - C cannot take
        # this call's garbage chunk write: serial-prefill everything instead.
        if any(int(self._pos[s]) > self.max_len - C for s in self._by_slot):
            return [self.add(p, m) for p, m in zip(prompts, budgets)]

        candidates = []
        for p, m in zip(prompts, budgets):
            p = np.asarray(p, np.int32).reshape(-1)
            if len(p) + m > self.max_len:
                raise ValueError("prompt + max_new_tokens exceeds engine max_len")
            candidates.append((p, m, -(-len(p) // C)))

        # Participation gates: (a) the padded prompt fits the cache; (b) a
        # row that finishes before the batch's last chunk needs room for its
        # remaining garbage chunks at [len(p), len(p) + C), i.e.
        # len(p) <= max_len - C. Demoting a row can lower the chunk count,
        # which can requalify others, so iterate to a fixed point.
        batched, serial = [], []
        for p, m, nc in candidates:
            if nc * C <= self.max_len and len(batched) < len(self._free):
                batched.append((p, m, nc))
            else:
                serial.append((p, m))
        while batched:
            max_chunks = max(nc for _, _, nc in batched)
            bad = [t for t in batched if t[2] < max_chunks and len(t[0]) > self.max_len - C]
            if not bad:
                break
            serial += [(p, m) for p, m, _ in bad]
            batched = [t for t in batched if all(t is not b for b in bad)]
        batched = [(p, m) for p, m, _ in batched]

        rids_batched: List[int] = []
        if batched:
            slots = [self._free.pop() for _ in batched]
            max_chunks = max(-(-len(p) // C) for p, _ in batched)
            B = self.max_batch
            ids = np.zeros((B, max_chunks * C), np.int32)
            for (p, _), slot in zip(batched, slots):
                ids[slot, : len(p)] = p
            last_logits = {}
            for j in range(max_chunks):
                pos = np.array([min(int(self._pos[s]), self.max_len - C) for s in range(B)], np.int32)
                last_idx = np.full((B,), -1, np.int32)
                for (p, _), slot in zip(batched, slots):
                    if j * C < len(p):  # this row still has real tokens
                        pos[slot] = j * C
                        li = len(p) - 1 - j * C
                        if 0 <= li < C:
                            last_idx[slot] = li
                    else:
                        # The row finished its prompt in an earlier chunk: park
                        # its garbage writes just past the prompt (the
                        # participation gate keeps them inside the cache).
                        pos[slot] = len(p)
                last = self._forward(ids[:, j * C : (j + 1) * C], self._cache, pos, last_idx)
                for s in slots:
                    if last_idx[s] >= 0:
                        last_logits[s] = last[s : s + 1]
            for (p, m), slot in zip(batched, slots):
                first_tok = int(self._sample_host(last_logits[slot])[0])
                rids_batched.append(self._register(slot, len(p), m, first_tok))

        rids_serial = [self.add(p, m) for p, m in serial]
        return rids_batched + rids_serial

    # --- mixed prefill/decode scheduling (chunked-prefill interleaving) -------

    def enqueue(self, prompt_ids, max_new_tokens: int = 64) -> int:
        """Admit a request without prefilling it: its prompt is consumed in
        fixed-size chunks by `serve_step()`, each chunk sharing one forward
        with the active slots' decode step, so a new arrival never stalls
        the decode streams.

        Requires `prefill_chunk`; a prompt whose padded length would spill
        past `max_len` prefills blockingly when its slot frees instead.
        Returns the request id at once, also when no slot is free (the
        request then waits in an admission queue)."""
        C = self.prefill_chunk
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds engine max_len")
        if (C is None or -(-len(prompt) // C) * C > self.max_len) and self._free:
            return self.add(prompt, max_new_tokens)
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, -1, len(prompt), max_new_tokens, [], prompt=prompt)
        self._requests[rid] = req
        self._queue.append(req)
        self._admit_queued()
        return rid

    def _admit_queued(self) -> None:
        C = self.prefill_chunk
        while self._queue and self._free:
            req = self._queue.pop(0)
            if C is None or -(-req.prompt_len // C) * C > self.max_len:
                # Off the chunk envelope: blocking prefill now that a slot is free.
                inner_rid = self.add(req.prompt, req.max_new_tokens)
                admitted = self._requests.pop(inner_rid)
                req.slot = admitted.slot
                req.tokens = admitted.tokens
                req.done = admitted.done
                self._requests[req.rid] = req
                if not req.done:
                    self._by_slot[req.slot] = req
                continue
            slot = self._free.pop()
            req.slot = slot
            self._pos[slot] = 0
            self._last_tok[slot] = 0
            self._prefill_by_slot[slot] = _PrefillState(req)

    def _mixed_ok(self) -> bool:
        """A mixed step writes a garbage chunk at every row's position; a
        decoding row within `prefill_chunk` of max_len cannot absorb it.
        Prefilling rows are safe by the enqueue() gate."""
        C = self.prefill_chunk
        return all(int(self._pos[s]) <= self.max_len - C for s in self._by_slot)

    def _mixed_chunk_step(self) -> Dict[int, int]:
        """One mixed step: every prefilling row advances one prompt chunk and
        every decoding row emits one token, in one [B, C] forward and one
        fetch of [B] tokens. Returns {rid: token} for the rows that produced
        one (decode rows, and prefill rows that just finished)."""
        C = self.prefill_chunk
        B = self.max_batch
        ids = np.zeros((B, C), np.int32)
        pos = np.array([min(int(self._pos[s]), self.max_len - C) for s in range(B)], np.int32)
        last_idx = np.zeros((B,), np.int32)
        finals = set()
        for slot, st in self._prefill_by_slot.items():
            p = st.req.prompt
            c0 = st.next_chunk * C
            chunk = p[c0 : c0 + C]
            ids[slot, : len(chunk)] = chunk
            pos[slot] = c0
            if c0 + len(chunk) >= len(p):
                last_idx[slot] = len(chunk) - 1
                finals.add(slot)
            st.next_chunk += 1
        for slot in self._by_slot:
            ids[slot, 0] = self._last_tok[slot]
            pos[slot] = self._pos[slot]
        nxt = self._sample_host(self._forward(ids, self._cache, pos, last_idx))
        out: Dict[int, int] = {}
        for slot, req in list(self._by_slot.items()):
            tok = int(nxt[slot])
            req.tokens.append(tok)
            out[req.rid] = tok
            self._pos[slot] += 1
            self._last_tok[slot] = tok
            self._maybe_finish(req, tok)
        for slot, st in list(self._prefill_by_slot.items()):
            req = st.req
            if slot in finals:
                del self._prefill_by_slot[slot]
                tok = int(nxt[slot])
                self._pos[slot] = req.prompt_len
                self._last_tok[slot] = tok
                req.tokens.append(tok)
                out[req.rid] = tok
                self._by_slot[slot] = req
                self._maybe_finish(req, tok)
            else:
                self._pos[slot] = st.next_chunk * C
        return out

    def serve_step(self, burst: Optional[int] = None):
        """One scheduling quantum: admit queued requests, then either a mixed
        prefill + decode step (when prefill work is pending) or a decode
        quantum (a power-of-two burst, or a single step)."""
        self._admit_queued()
        if self._prefill_by_slot:
            if self._mixed_ok():
                return self._mixed_chunk_step()
            # A decode row within C of max_len blocks garbage chunk writes:
            # single-step it until it finishes (it is about to, by the
            # admission-time max_len check).
            return self.step()
        return self._decode_quantum(burst)

    def _decode_quantum(self, burst: Optional[int]):
        if not self._by_slot:
            # Only queued or preempted work is left: step() lets PagedEngine
            # readmit; the dense engine returns {} (admission needs a slot).
            return self.step() if self._has_work() else {}
        if burst is None:
            return self.step()
        n = min(burst, min(r.max_new_tokens - len(r.tokens) for r in self._by_slot.values()))
        n = 1 << (n.bit_length() - 1) if n > 0 else 0  # floor to a power of two
        if n <= 1:
            return self.step()
        return self.decode_burst(n)

    def _maybe_finish(self, req: _Request, tok: int) -> None:
        if req.done:
            return
        if len(req.tokens) >= req.max_new_tokens or (
            self.eos_token_id is not None and tok == self.eos_token_id
        ):
            req.done = True
            self._free.append(req.slot)
            del self._by_slot[req.slot]
            # A freed slot decodes garbage at position 0 until it is reused.
            self._pos[req.slot] = 0
            self._last_tok[req.slot] = 0

    @property
    def num_active(self) -> int:
        return len(self._by_slot)

    def step(self) -> Dict[int, int]:
        """Decode one token for every active slot; returns {rid: token}."""
        if not self._by_slot:
            return {}
        nxt = self._sample_host(self._forward(self._last_tok[:, None], self._cache, self._pos, 0))
        out: Dict[int, int] = {}
        for slot, req in list(self._by_slot.items()):
            tok = int(nxt[slot])
            req.tokens.append(tok)
            out[req.rid] = tok
            self._pos[slot] += 1
            self._last_tok[slot] = tok
            self._maybe_finish(req, tok)
        return out

    def decode_burst(self, n: int) -> Dict[int, List[int]]:
        """Decode `n` tokens for every active slot with one fetch of the
        tokens at the end: n forwards, each sampled as `step()` samples, so
        the tokens equal n `step()` calls. A slot that finishes (eos or
        max_new_tokens) inside the burst keeps its tokens up to the finish;
        its later writes land past its live region and are overwritten or
        masked when the slot is reused."""
        if not self._by_slot or n <= 0:
            return {}
        toks = torch.as_tensor(self._last_tok[:, None], device=self._device)
        pos = torch.as_tensor(self._pos, device=self._device).long()
        outs = []
        for _ in range(n):
            nxt = self._sample(self._forward(toks, self._cache, pos, 0), self._generator)
            toks = nxt.to(torch.int32)[:, None]
            outs.append(toks)
            pos = pos + 1
        out_toks = torch.cat(outs, dim=1).cpu().numpy()  # [B, n]
        out: Dict[int, List[int]] = {}
        for slot, req in list(self._by_slot.items()):
            taken: List[int] = []
            for j in range(n):
                tok = int(out_toks[slot, j])
                req.tokens.append(tok)
                taken.append(tok)
                self._pos[slot] += 1
                self._last_tok[slot] = tok
                self._maybe_finish(req, tok)
                if req.done:
                    break
            out[req.rid] = taken
        return out

    def result(self, rid: int) -> List[int]:
        return self._requests[rid].tokens

    def is_done(self, rid: int) -> bool:
        return self._requests[rid].done

    def run_to_completion(self, burst: Optional[int] = None) -> None:
        """Drain every request. With `burst` (e.g. 16) decode goes in bursts,
        bounded by the shortest active request's remaining budget and
        floored to a power of two, so no sequence overshoots its
        max_new_tokens. Pending `enqueue()`'d prefills interleave as mixed
        steps."""
        while self._has_work():
            self.serve_step(burst)

    def _has_work(self) -> bool:
        return bool(self._by_slot) or bool(self._queue) or bool(self._prefill_by_slot)


class PagedEngine(BatchedEngine):
    """Continuous batching over a PAGED KV cache (`tensor/paged_kv.py`).

    Counterpart of `quanto_tpu/models/serving.py:PagedEngine` (`:793-1196`).
    The cache is `n_pages * page_size` tokens shared by all slots instead of
    `max_batch * max_len` reserved per slot. With `reserve="prompt"` (the
    default) `add` allocates the prompt's pages only and decode grows a slot
    page by page as its positions cross page boundaries; `reserve="full"`
    allocates `prompt + max_new_tokens` up front, so an admitted request never
    stalls. Page 0 is scratch (never allocated): a table entry of 0, and so a
    free slot's row, writes there harmlessly.

    When growth exhausts the pool (after evicting cold prefix pages), the
    youngest active request is preempted: its pages are released and it is
    recomputed from its prompt and the tokens it has emitted once capacity
    frees (`preemptions` counts them). With a deterministic sampler its
    tokens equal an unpreempted run's.

    Prefix sharing (`prefix_sharing=True`): a page that a prompt fills
    completely is registered under the exact token prefix it ends. A later
    prompt that starts with the same blocks maps those pages into its table
    row, and only its suffix is prefilled, at cache offset `shared_len`.
    Shared pages are never written again (prefill writes from `shared_len`,
    decode from the prompt's end); they are refcounted by their users, stay
    resident after release, and are evicted oldest first when the pool runs
    dry (`prefix_hits`, `prefix_tokens_saved` count the reuse).

    The host table is numpy, as in JAX; the device table [max_batch, P] is
    one int32 tensor that every layer shares, updated by one host-to-device
    copy per change. `add_batch` and `enqueue` admit serially through `add`,
    as JAX's do: a batched or mixed chunk step would write a garbage chunk
    through every row's table, for which no pages are reserved. Sliding-window
    models (JAX's paged+ring hybrid) are refused.
    """

    def __init__(
        self,
        model,
        max_batch: int = 8,
        max_len: int = 512,
        n_pages: int = 64,
        page_size: int = 64,
        kv_quant=None,
        eos_token_id: Optional[int] = None,
        sample_fn: Optional[Callable] = None,
        prefix_sharing: bool = True,
        prefill_chunk: Optional[int] = None,
        reserve: str = "prompt",
    ):
        if reserve not in ("prompt", "full"):
            raise ValueError('reserve must be "prompt" or "full"')
        self.reserve = reserve
        # Read by _make_cache, which BatchedEngine.__init__ calls.
        self.page_size = page_size
        self.n_pages = n_pages
        self.pages_per_slot = -(-max_len // page_size)
        super().__init__(
            model, max_batch=max_batch, max_len=max_len, kv_quant=kv_quant,
            eos_token_id=eos_token_id, sample_fn=sample_fn, prefill_chunk=prefill_chunk,
        )
        self._table = np.zeros((max_batch, self.pages_per_slot), np.int32)
        self._free_pages = list(range(1, n_pages))  # page 0 reserved
        self._slot_pages: Dict[int, List[int]] = {}
        self.prefix_sharing = prefix_sharing
        self._prefix_pages: Dict[bytes, int] = {}  # token-prefix key -> page id
        self._page_key: Dict[int, bytes] = {}  # page id -> its prefix key
        self._page_refs: Dict[int, int] = {}  # prefix page -> active users
        self._prefix_lru: List[bytes] = []  # oldest first
        self.prefix_hits = 0  # shared pages reused
        self.prefix_tokens_saved = 0  # prompt tokens not recomputed
        self._pending: List[_Request] = []  # preempted, awaiting readmission
        self.preemptions = 0

    def _make_cache(self, kv_quant):
        from ..tensor.paged_kv import init_paged_kv_cache

        c = self.model.config
        w = getattr(c, "sliding_window", None)
        lt = getattr(c, "layer_types", None)
        if w is not None and lt is not None and w < self.max_len and "sliding_attention" in lt:
            raise NotImplementedError(
                "PagedEngine over sliding-window layers (the paged+ring hybrid): not ported yet "
                "(ROADMAP.md Queue 1, item 8)"
            )
        attn = self.model.model.layers[0].self_attn
        cache = init_paged_kv_cache(
            c.num_hidden_layers, self.n_pages, self.page_size, self.max_batch, self.pages_per_slot,
            attn.num_kv_heads, attn.head_dim, kv_quant=kv_quant, dtype=c.dtype, device=self._device,
        )
        self._table_dev = cache[0]._table
        return cache

    def _sync_table(self) -> None:
        """The host table into the device table every layer shares."""
        self._table_dev.copy_(torch.from_numpy(self._table))

    def _prefix_key(self, prompt: np.ndarray, n_pages: int) -> bytes:
        """Exact-match key of the first `n_pages` full token blocks."""
        return prompt[: n_pages * self.page_size].tobytes()

    def _lru_touch(self, key: bytes) -> None:
        if key in self._prefix_lru:
            self._prefix_lru.remove(key)
        self._prefix_lru.append(key)

    def _evict_prefix_pages(self, n_needed: int) -> None:
        """Evict zero-ref prefix pages, oldest first, until `n_needed` pages
        are free."""
        for key in list(self._prefix_lru):
            if len(self._free_pages) >= n_needed:
                return
            page = self._prefix_pages[key]
            if self._page_refs.get(page, 0) == 0:
                del self._prefix_pages[key]
                del self._page_key[page]
                self._page_refs.pop(page, None)
                self._prefix_lru.remove(key)
                self._free_pages.append(page)

    def add_batch(self, prompts, max_new_tokens=64) -> List[int]:
        budgets = (
            list(max_new_tokens) if isinstance(max_new_tokens, (list, tuple)) else [max_new_tokens] * len(prompts)
        )
        return [self.add(p, m) for p, m in zip(prompts, budgets)]

    def enqueue(self, prompt_ids, max_new_tokens: int = 64) -> int:
        return self.add(prompt_ids, max_new_tokens)

    def add(self, prompt_ids, max_new_tokens: int = 64) -> int:
        if not self._free:
            raise RuntimeError("no free slots (call step() until one finishes)")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        total = len(prompt) + max_new_tokens
        if total > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds engine max_len")
        slot, last_logits = self._admit(prompt, total if self.reserve == "full" else len(prompt))
        first_tok = int(self._sample_host(last_logits)[0])
        return self._register(slot, len(prompt), max_new_tokens, first_tok, prompt=prompt)

    def _admit(self, prompt: np.ndarray, reserve_tokens: int):
        """Map the shared prefix pages of `prompt`, allocate pages up to
        `reserve_tokens` positions, and prefill the unshared suffix through
        the slot's table row. Returns (slot, the last token's logits [1, V]).
        Serves fresh admission and recompute (`prompt` then the original
        prompt and the tokens emitted so far)."""
        ps = self.page_size
        n_total = -(-reserve_tokens // ps)
        # The longest chain of cached full prompt pages; one prompt token at
        # least stays unshared, so that prefill gives the last token's logits.
        shared: List[int] = []
        if self.prefix_sharing:
            for i in range((len(prompt) - 1) // ps):
                page = self._prefix_pages.get(self._prefix_key(prompt, i + 1))
                if page is None:
                    break
                shared.append(page)
        shared_len = len(shared) * ps
        n_new = n_total - len(shared)
        if n_new > len(self._free_pages):
            self._evict_prefix_pages(n_new)
        if n_new > len(self._free_pages):
            raise RuntimeError("page pool exhausted")
        slot = self._free.pop()
        pages = shared + [self._free_pages.pop() for _ in range(n_new)]
        for i, page in enumerate(shared):
            self._page_refs[page] = self._page_refs.get(page, 0) + 1
            self._lru_touch(self._prefix_key(prompt, i + 1))
        if shared:
            self.prefix_hits += len(shared)
            self.prefix_tokens_saved += shared_len
        self._slot_pages[slot] = pages
        self._table[slot] = 0
        self._table[slot, : len(pages)] = pages
        self._sync_table()
        last_logits = self._prefill_into(slot, prompt[shared_len:], start_pos=shared_len)
        # Register the prompt's new full pages for reuse.
        if self.prefix_sharing:
            for i in range(len(shared), len(prompt) // ps):
                key = self._prefix_key(prompt, i + 1)
                if key in self._prefix_pages:
                    continue  # a concurrent duplicate: keep the existing entry
                page = pages[i]
                self._prefix_pages[key] = page
                self._page_key[page] = key
                self._page_refs[page] = self._page_refs.get(page, 0) + 1
                self._lru_touch(key)
        return slot, last_logits

    # --- on-demand page growth and preemption ---------------------------------

    def _release_slot_pages(self, slot: int) -> None:
        """Return a slot's pages to the pool (prefix pages stay resident with
        one user fewer) and clear its table row."""
        for page in self._slot_pages.pop(slot, []):
            if page in self._page_key:
                self._page_refs[page] = max(0, self._page_refs.get(page, 1) - 1)
            else:
                self._free_pages.append(page)
        self._table[slot] = 0
        self._sync_table()

    def _preempt(self, req: _Request) -> None:
        """Release `req`'s slot and pages; it is recomputed when capacity frees."""
        self._release_slot_pages(req.slot)
        del self._by_slot[req.slot]
        self._free.append(req.slot)
        self._pos[req.slot] = 0
        self._last_tok[req.slot] = 0
        self._pending.append(req)
        self.preemptions += 1

    def _try_readmit(self) -> None:
        """Readmit preempted requests, oldest first, while slots and pages
        allow. The recomputed context is the prompt and every emitted token
        but the last, whose K/V the next decode step writes, as it would have."""
        while self._pending and self._free:
            req = self._pending[0]
            ctx = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)]).astype(np.int32)
            reserve_tokens = req.prompt_len + req.max_new_tokens if self.reserve == "full" else len(ctx)
            try:
                slot, _ = self._admit(ctx, reserve_tokens)
            except RuntimeError:
                if not self._by_slot:
                    raise RuntimeError(
                        "page pool too small to readmit a preempted request; increase n_pages"
                    ) from None
                return  # retry once active requests release pages
            self._pending.pop(0)
            req.slot = slot
            self._pos[slot] = len(ctx)
            self._last_tok[slot] = req.tokens[-1]
            self._by_slot[slot] = req

    def _grow_for_decode(self, n: int) -> None:
        """Give every active slot's table row its next `n` write positions
        (capped at the request's remaining budget: a slot that finishes
        inside a burst parks its extra writes in the scratch page). Under
        pressure, evict cold prefix pages first, then preempt the youngest
        active request until the rest fit."""
        while True:
            need: Dict[int, int] = {}
            for slot, req in self._by_slot.items():
                remaining = req.max_new_tokens - len(req.tokens)
                last_pos = int(self._pos[slot]) + min(n, remaining) - 1
                k = last_pos // self.page_size + 1 - len(self._slot_pages[slot])
                if k > 0:
                    need[slot] = k
            total = sum(need.values())
            if total == 0:
                return
            if total > len(self._free_pages):
                self._evict_prefix_pages(total)
            if total <= len(self._free_pages):
                break
            if len(self._by_slot) == 1:
                raise RuntimeError("page pool exhausted by a single request; increase n_pages")
            self._preempt(max(self._by_slot.values(), key=lambda r: r.rid))
        for slot, k in need.items():
            row = self._slot_pages[slot]
            pages = [self._free_pages.pop() for _ in range(k)]
            self._table[slot, len(row) : len(row) + k] = pages
            row.extend(pages)
        self._sync_table()

    def _has_work(self) -> bool:
        return super()._has_work() or bool(self._pending)

    def step(self) -> Dict[int, int]:
        self._try_readmit()
        if self._by_slot:
            self._grow_for_decode(1)
        return super().step()

    def decode_burst(self, n: int) -> Dict[int, List[int]]:
        self._try_readmit()
        if self._by_slot:
            self._grow_for_decode(n)
        return super().decode_burst(n)

    def _maybe_finish(self, req: _Request, tok: int) -> None:
        was_done = req.done
        super()._maybe_finish(req, tok)
        if req.done and not was_done:
            self._release_slot_pages(req.slot)
