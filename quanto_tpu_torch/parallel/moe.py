"""Single-device stacked-expert MoE dispatch through the MoE kernels.

Counterpart of the single-device half of `quanto_tpu/parallel/moe.py`:
`_stack_expert_projs` (`:468`), `StackedSparseMoeBlock` (`:484-802`) and
`convert_moe_to_stacked` (`:1047`) for Mixtral and Qwen3-MoE blocks, and
`StackedGptOssMoE` (`:884-1004`) with `convert_gpt_oss_moe_to_stacked`
(`:1064-1083`) for gpt-oss, which quantizes its fused float experts as it
converts. Each
projection of the experts (gate, up, down: Mixtral's w1, w3, w2, Qwen3-MoE's
gate_proj, up_proj, down_proj) is stacked along a leading expert axis in
the Hopper layout, and the expert index lives in the kernels' grid
(`ops/cuda/moe_mm.py`), so no expert is sliced or copied per step and a small
decode batch reads only the routed experts' weights.

Routing by shape, unchanged from JAX (S = tokens, K = top_k, E = experts):
- S*K < E and S*K <= SEL_MAX: SELECTIVE, one (token, expert) pair per slot;
- S <= 512 and (capacity >= S or S <= 32): ALL-EXPERTS, the dense-mask math
  over the stacked weights; when E >= 8 and E <= S*K <= 2E, only the routed
  experts (the unique-expert boundary route);
- otherwise CAPACITY GATHER: each expert's top-`capacity` tokens by routing
  weight through the batched-expert GEMM, overflow tokens dropped at a
  finite `capacity_factor`, scatter-added back.

Where JAX takes a device-side branch (`jnp.unique(size=U)` and a `lax.cond`
on the count of routed experts, `moe.py:662-693`), the port builds a table of
all E experts with the routed ones first and their count on the device; the
kernels skip the slots past the count. That is the result of both JAX
branches (unrouted experts carry zero weight) with no host sync in any layer
of any step. JAX's dense fallback and its kernel-envelope probe have no
counterpart: the converter refuses experts off the kernels' envelope, and a
CUDA tensor always reaches a kernel. The router renormalizes the top-k
weights where the block's `norm_topk_prob` says so (Mixtral's always does;
`:580-592`).

A family changes the block through JAX's hooks (`:522-535`): `_route` (the
router), `_glu` (the gate/up combination) and `_post_mm` (after each
projection, with the expert of each row on the selective route, of each slot
on the unique-expert route, none on the [E, M, N] routes), beside `_mm`, the
one place a projection reaches a kernel. gpt-oss's block adds its per-expert
biases in `_post_mm` on every route: the unique-expert route's slots past the
routed count and the capacity route's zero-weight fillers then hold a bias,
but weigh zero where the slots are combined, so they still add exactly zero.
The gathered and expert-parallel blocks and the families qwen2_moe and
deepseek_v3 wait for later slices (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.gpt_oss import clamped_swiglu
from ..models.mixtral import MixtralSparseMoeBlock, route, routing_mask
from ..models.qwen3 import Qwen3MoeSparseBlock
from ..nn.qmodule import QModuleMixin
from ..ops.cuda import moe_mm
from ..ops.cuda.qbits_mm import MAX_M
from ..quantize import set_module_by_name
from ..tensor.optimizers import MaxOptimizer
from ..tensor.qtype import qtypes
from ..tensor.weights import WeightQBitsHopperArray, quantize_weight


__all__ = ["StackedSparseMoeBlock", "StackedGptOssMoE", "convert_moe_to_stacked", "convert_gpt_oss_moe_to_stacked"]


class _StackedProj(nn.Module):
    """One projection of every expert, stacked: `packed` uint8
    [E, N, K * bits / 8], `scale_t` / `shift_t` float32 [E, G, N] (buffers),
    the kernels' group size and code width."""

    def __init__(self, weights):
        super().__init__()
        w0 = weights[0]
        if any(w.orig_shape != w0.orig_shape or w.group_size != w0.group_size for w in weights):
            raise ValueError("stacked experts must share their shape and group size")
        if any(w.bits != w0.bits for w in weights):
            raise ValueError(f"stacked experts must share their bits, got {sorted({w.bits for w in weights})}")
        if any(w.pad is not None for w in weights):
            raise NotImplementedError("stacked experts off the kernels' envelope (padded) are not ported yet")
        self.group_size = w0.kernel_group_size
        self.bits = w0.bits
        for name in ("packed", "scale_t", "shift_t"):
            self.register_buffer(name, torch.stack([getattr(w, f"_{name}") for w in weights]))

    def operands(self):
        return self.packed, self.scale_t, self.shift_t, self.group_size, self.bits


def _stack_expert_projs(experts, names, who: str):
    """Stack the (gate, up, down) projections of the experts: each must be a
    bias-free quantized module whose frozen weight is in the Hopper layout."""
    projs = []
    for name in names:
        mods = [getattr(e, name) for e in experts]
        ws = [m.weight if isinstance(m, QModuleMixin) and m.bias is None else None for m in mods]
        if not all(isinstance(w, WeightQBitsHopperArray) for w in ws):
            raise ValueError(
                f"{who} needs frozen int4 or int2 experts in the Hopper layout (WeightQBitsHopperArray): "
                "quantize with qint4 or qint2 and freeze on a CUDA device first"
            )
        projs.append(_StackedProj(ws))
    return projs


class StackedSparseMoeBlock(nn.Module):
    """Drop-in replacement for a dense-mask `MixtralSparseMoeBlock` or
    `Qwen3MoeSparseBlock` (module docstring). Keeps the block's `gate`;
    stores the experts stacked only."""

    def __init__(self, block, *, capacity_factor: Optional[float] = 2.0):
        super().__init__()
        self.capacity_factor = capacity_factor
        self.num_experts = len(block.experts)
        self.top_k = block.top_k
        self.norm_topk_prob = getattr(block, "norm_topk_prob", True)
        self.gate = block.gate
        names = ("w1", "w3", "w2") if hasattr(block.experts[0], "w1") else ("gate_proj", "up_proj", "down_proj")
        self.proj_gate, self.proj_up, self.proj_down = _stack_expert_projs(
            list(block.experts), names, "StackedSparseMoeBlock"
        )

    def _capacity(self, n_tokens: int) -> int:
        """Tokens each expert takes on the capacity route (`moe.py:214-220`)."""
        if self.capacity_factor is None:
            return n_tokens
        c = math.ceil(self.capacity_factor * self.top_k * n_tokens / self.num_experts)
        c = min(n_tokens, max(1, c))
        return min(n_tokens, -8 * (-c // 8)) if n_tokens >= 8 else c

    def forward(self, x, valid=None):
        """x [B, T, H]. `valid` [B, T] bool (None: every column): the real columns
        of an engine's padded chunk (`write_len`); the others take zero routing
        weight, so that they never take a capacity slot from a real token (the
        capacity route keeps each expert's tokens of largest weight). JAX's block
        has no such argument: there a chunk's pad columns, which share a token and
        so an expert, can push real tokens out of an expert's slab."""
        B, T, H = x.shape
        top_i, top_p = self._route(x)
        if valid is not None:
            top_p = top_p * valid.reshape(-1, 1)
        return self._dispatch(x, top_i, top_p).reshape(B, T, H)

    # --- the family hooks (JAX `moe.py:522-535`, `:582-592`) ---------------------------------

    def _route(self, x):
        """[B, T, H] -> (top_i [S, K], top_p [S, K] float32): the Mixtral / Qwen3-MoE
        router, softmax, top-k and the renormalization `norm_topk_prob` asks for."""
        top_i, top_p = route(self.gate, x, self.top_k, self.norm_topk_prob)
        return top_i.reshape(-1, self.top_k), top_p.reshape(-1, self.top_k)

    def _glu(self, g, u):
        """The gate/up combination: the Llama family's SwiGLU."""
        return F.silu(g) * u

    def _post_mm(self, which: str, y, eids=None):
        """After each projection ("gate", "up", "down"), float32 [..., N]:
        `eids` is the expert of each row [nsel] (the selective route) or of
        each slot [U] (the unique-expert route), None on the [E, M, N] routes.
        Identity; gpt-oss adds its per-expert biases here."""
        return y

    def _mm(self, kind: str, which: str, x, eids=None, nslots=None):
        """x through the stacked projection `which` by the MoE entry point of
        `kind`: "sel" (`qbits_moe_sel`, x [nsel, K]), "all" (`qbits_moe_all`, x
        [S, K] shared by the slots) or "prefill" (`qbits_moe_prefill`, x
        [U, M, K]); then `_post_mm`. float32."""
        ops = getattr(self, f"proj_{which}").operands()
        if kind == "sel":
            y = moe_mm.qbits_moe_sel(x, eids, *ops)
        else:
            fn = moe_mm.qbits_moe_all if kind == "all" else moe_mm.qbits_moe_prefill
            y = fn(x, *ops, eids=eids, nslots=nslots)
        return self._post_mm(which, y, eids)

    def _all_math(self, xf, top_i, top_p, uids=None, nuniq=None):
        """Every expert over all S rows: gate and up through the all-experts
        kernel, down through the batched-expert GEMM, combined with the
        routing mask. With `uids`, the unique-expert math: slot u against
        W[uids[u]], and the slots at or past `nuniq` (a device int) read no
        weight and give zeros (and weigh zero in the mask, whatever a bias
        adds to them). Returns [S, H] float32."""
        g3 = self._mm("all", "gate", xf, uids, nuniq)
        u3 = self._mm("all", "up", xf, uids, nuniq)
        h3 = self._glu(g3, u3).to(xf.dtype)  # [slots, S, I]
        d3 = self._mm("prefill", "down", h3, uids, nuniq)
        mask = routing_mask(top_i, top_p, self.num_experts)  # [S, E]
        if uids is not None:
            mask = mask[:, uids.long()]
        return torch.einsum("ush,su->sh", d3, mask)

    def _uniq_boundary(self, xf, top_i, top_p):
        """The unique-expert route, built on the device: the routed experts
        first (ascending, as `jnp.unique` orders them), then the others, and
        the routed count as a 0-d int32 tensor."""
        routed = torch.zeros(self.num_experts, dtype=torch.bool, device=xf.device)
        routed.index_fill_(0, top_i.reshape(-1).long(), True)
        nuniq = routed.sum(dtype=torch.int32)
        uids = torch.sort((~routed).to(torch.int32), stable=True).indices.to(torch.int32)
        return self._all_math(xf, top_i, top_p, uids, nuniq)

    def _dispatch(self, x, top_i, top_p):
        """Routed-expert dispatch: top_i / top_p are [S, K]. Returns [S, H]
        in x's dtype."""
        B, T, H = x.shape
        S, E, K = B * T, self.num_experts, self.top_k
        cap = self._capacity(S)
        xf = x.reshape(S, H)
        if S * K < E and S * K <= moe_mm.SEL_MAX:
            # SELECTIVE: one slot per (token, expert) pair.
            x_sel = xf.repeat_interleave(K, dim=0)  # [S*K, H]
            eids = top_i.reshape(S * K).to(torch.int32)
            g = self._mm("sel", "gate", x_sel, eids)
            u = self._mm("sel", "up", x_sel, eids)
            h = self._glu(g, u).to(x.dtype)
            d = self._mm("sel", "down", h, eids)
            out = (top_p.reshape(S * K, 1) * d).reshape(S, K, -1).sum(dim=1)
        elif S <= MAX_M and (cap >= S or S <= 32):
            # ALL-EXPERTS; at S*K just past the selective gate, only the routed experts.
            if E >= 8 and E <= S * K <= 2 * E:
                out = self._uniq_boundary(xf, top_i, top_p)
            else:
                out = self._all_math(xf, top_i, top_p)
        else:
            # CAPACITY GATHER: each expert's top-`cap` tokens by routing weight. Where fewer
            # tokens are routed, zero-weight fillers complete the slab and add nothing.
            top_v, idx = torch.topk(routing_mask(top_i, top_p, E).t(), min(cap, S), dim=-1)  # [E, cap]
            xg = xf[idx.reshape(-1)].reshape(E, -1, H)
            g3 = self._mm("prefill", "gate", xg)
            u3 = self._mm("prefill", "up", xg)
            h3 = self._glu(g3, u3).to(x.dtype)
            d3 = self._mm("prefill", "down", h3)  # [E, cap, H]
            out = torch.zeros((S, d3.shape[-1]), dtype=torch.float32, device=x.device)
            for e in range(E):
                out.index_add_(0, idx[e], top_v[e][:, None] * d3[e])
        return out.to(x.dtype)


class StackedGptOssMoE(StackedSparseMoeBlock):
    """gpt-oss's stacked block (JAX `moe.py:884-1004`). The fused float experts
    of a `GptOssMLP` ([E, H, 2I] interleaved gate/up, [E, I, H] down, all
    biased) are QUANTIZED here, as JAX's block does: each expert's gate
    (`[..., 0::2]`), up (`[..., 1::2]`) and down, transposed to [out, in], are
    zero-padded to N rounded up to 128 and K rounded up to 1024 and quantized
    at `group_size` with the max optimizer, then stacked in the Hopper layout.
    Padding comes BEFORE quantization: at gpt-oss-20b's 2880, the last group
    of each row holds 64 real values and 64 zeros, and its scale and shift
    see both; codes, scales and shifts are JAX's bit for bit ([2944, 3072] for
    gate, up and down). `_mm` pads x with zeros to the padded K; `_post_mm`
    slices the output back to the true N and adds the per-expert biases
    (float32) on every route; the clamped SwiGLU is the GLU. The router is the
    block's own (`router.topk`). No shared expert."""

    def __init__(self, block, *, weights="qint4", group_size: int = 128, capacity_factor: Optional[float] = 2.0):
        nn.Module.__init__(self)
        qt = qtypes[weights] if isinstance(weights, str) else weights
        if qt.bits not in (2, 4):
            raise ValueError(f"StackedGptOssMoE quantizes the experts to qint4 or qint2, got {qt.name}")
        router, ex = block.router, block.experts
        self.capacity_factor = capacity_factor
        self.num_experts = router.num_experts
        self.top_k = router.top_k
        self.norm_topk_prob = False
        self.gate = router
        self.alpha, self.limit = ex.alpha, ex.limit
        gu, dn = ex.gate_up_proj.detach(), ex.down_proj.detach()  # [E, H, 2I], [E, I, H]

        def quant(w):  # [out, in] float -> the Hopper layout, padded before quantization
            w = F.pad(w, (0, -w.shape[1] % 1024, 0, -w.shape[0] % 128))
            scale, shift = MaxOptimizer()(w, qt, axis=0, group_size=group_size)
            hop = WeightQBitsHopperArray.from_generic(
                quantize_weight(w, qt, 0, scale, shift=shift, group_size=group_size))
            if hop is None or hop.pad is not None:
                raise ValueError(f"StackedGptOssMoE: a padded expert {tuple(w.shape)} is off the kernels' envelope")
            return hop

        E = self.num_experts
        self.proj_gate = _StackedProj([quant(gu[e][:, 0::2].t()) for e in range(E)])
        self.proj_up = _StackedProj([quant(gu[e][:, 1::2].t()) for e in range(E)])
        self.proj_down = _StackedProj([quant(dn[e].t()) for e in range(E)])
        self._true_n = {"gate": gu.shape[2] // 2, "up": gu.shape[2] // 2, "down": dn.shape[2]}
        gu_b = ex.gate_up_proj_bias.detach()
        self.register_buffer("bias_gate", gu_b[:, 0::2].float().contiguous())  # [E, I]
        self.register_buffer("bias_up", gu_b[:, 1::2].float().contiguous())
        self.register_buffer("bias_down", ex.down_proj_bias.detach().float().contiguous())  # [E, H]

    def _route(self, x):
        top_i, top_p = self.gate.topk(x)  # [B, T, K]: the router's forward sees [B, T, H]
        return top_i.reshape(-1, self.top_k), top_p.reshape(-1, self.top_k)

    def _glu(self, g, u):
        return clamped_swiglu(g, u, self.alpha, self.limit)

    def _mm(self, kind: str, which: str, x, eids=None, nslots=None):
        proj = getattr(self, f"proj_{which}")
        K = proj.packed.shape[-1] * 8 // proj.bits
        if x.shape[-1] < K:
            x = F.pad(x, (0, K - x.shape[-1]))
        return super()._mm(kind, which, x, eids, nslots)

    def _post_mm(self, which: str, y, eids=None):
        y = y[..., : self._true_n[which]]
        b = getattr(self, f"bias_{which}")
        if eids is None:
            return y + b[:, None, :]  # the [E, M, N] routes
        be = b[eids.long()]
        return y + (be[:, None, :] if y.dim() == 3 else be)  # per slot [U, M, N], per row [nsel, N]


def convert_moe_to_stacked(model: nn.Module, *, capacity_factor: Optional[float] = 2.0) -> int:
    """Replace every dense-mask `MixtralSparseMoeBlock` and
    `Qwen3MoeSparseBlock` under `model` with a `StackedSparseMoeBlock`, in
    place; returns how many were replaced. Apply after quantize + freeze (or
    loading), as `quanto_tpu`'s converter (`:1007-1061`)."""
    types = (MixtralSparseMoeBlock, Qwen3MoeSparseBlock)
    blocks = [(name, m) for name, m in model.named_modules() if isinstance(m, types)]
    for name, block in blocks:
        if not name:
            raise ValueError("convert_moe_to_stacked replaces blocks inside a model, not the model itself")
        set_module_by_name(model, name, StackedSparseMoeBlock(block, capacity_factor=capacity_factor))
    return len(blocks)


def convert_gpt_oss_moe_to_stacked(
    model: nn.Module, *, weights="qint4", group_size: int = 128, capacity_factor: Optional[float] = 2.0
) -> int:
    """Replace every `GptOssMLP` under `model` with a `StackedGptOssMoE`, in
    place, QUANTIZING its fused float experts as it converts (they are
    parameters, not linears, so `quantize` never touches them); returns how
    many were replaced. Run it after quantize + freeze of the rest of the
    model, or on each decoder layer as it is built (JAX `moe.py:1064-1083`)."""
    from ..models.gpt_oss import GptOssMLP

    blocks = [(name, m) for name, m in model.named_modules() if isinstance(m, GptOssMLP)]
    for name, block in blocks:
        if not name:
            raise ValueError("convert_gpt_oss_moe_to_stacked replaces blocks inside a model, not the model itself")
        new = StackedGptOssMoE(block, weights=weights, group_size=group_size, capacity_factor=capacity_factor)
        set_module_by_name(model, name, new)
    return len(blocks)
