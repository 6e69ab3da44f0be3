"""Single-device stacked-expert MoE dispatch through the MoE kernels.

Counterpart of the single-device half of `quanto_tpu/parallel/moe.py`:
`_stack_expert_projs` (`:468`), `StackedSparseMoeBlock` (`:484-802`) and
`convert_moe_to_stacked` (`:1047`) for Mixtral blocks. Each projection of the
experts (gate w1, up w3, down w2) is stacked along a leading expert axis in
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
CUDA tensor always reaches a kernel. The gathered and expert-parallel blocks
and the other MoE families wait for later slices (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.mixtral import MixtralSparseMoeBlock, route, routing_mask
from ..nn.qmodule import QModuleMixin
from ..ops.cuda import moe_mm
from ..ops.cuda.qbits_mm import MAX_M
from ..quantize import set_module_by_name
from ..tensor.weights import WeightQBitsHopperArray


__all__ = ["StackedSparseMoeBlock", "convert_moe_to_stacked"]


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
    """Drop-in replacement for a dense-mask `MixtralSparseMoeBlock` (module
    docstring). Keeps the block's `gate`; stores the experts stacked only."""

    def __init__(self, block: MixtralSparseMoeBlock, *, capacity_factor: Optional[float] = 2.0):
        super().__init__()
        self.capacity_factor = capacity_factor
        self.num_experts = len(block.experts)
        self.top_k = block.top_k
        self.gate = block.gate
        self.proj_gate, self.proj_up, self.proj_down = _stack_expert_projs(
            list(block.experts), ("w1", "w3", "w2"), "StackedSparseMoeBlock"
        )

    def _capacity(self, n_tokens: int) -> int:
        """Tokens each expert takes on the capacity route (`moe.py:214-220`)."""
        if self.capacity_factor is None:
            return n_tokens
        c = math.ceil(self.capacity_factor * self.top_k * n_tokens / self.num_experts)
        c = min(n_tokens, max(1, c))
        return min(n_tokens, -8 * (-c // 8)) if n_tokens >= 8 else c

    def forward(self, x):
        B, T, H = x.shape
        top_i, top_p = route(self.gate, x, self.top_k)
        return self._dispatch(x, top_i.reshape(B * T, -1), top_p.reshape(B * T, -1)).reshape(B, T, H)

    def _all_math(self, xf, top_i, top_p, uids=None, nuniq=None):
        """Every expert over all S rows: gate and up through the all-experts
        kernel, down through the batched-expert GEMM, combined with the
        routing mask. With `uids`, the unique-expert math: slot u against
        W[uids[u]], and the slots at or past `nuniq` (a device int) read no
        weight and give zeros. Returns [S, H] float32."""
        tables = dict(eids=uids, nslots=nuniq)
        g3 = moe_mm.qbits_moe_all(xf, *self.proj_gate.operands(), **tables)
        u3 = moe_mm.qbits_moe_all(xf, *self.proj_up.operands(), **tables)
        h3 = (F.silu(g3) * u3).to(xf.dtype)  # [slots, S, I]
        d3 = moe_mm.qbits_moe_prefill(h3, *self.proj_down.operands(), **tables)
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
            g = moe_mm.qbits_moe_sel(x_sel, eids, *self.proj_gate.operands())
            u = moe_mm.qbits_moe_sel(x_sel, eids, *self.proj_up.operands())
            h = (F.silu(g) * u).to(x.dtype)
            d = moe_mm.qbits_moe_sel(h, eids, *self.proj_down.operands())
            out = (top_p.reshape(S * K, 1) * d).reshape(S, K, H).sum(dim=1)
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
            g3 = moe_mm.qbits_moe_prefill(xg, *self.proj_gate.operands())
            u3 = moe_mm.qbits_moe_prefill(xg, *self.proj_up.operands())
            h3 = (F.silu(g3) * u3).to(x.dtype)
            d3 = moe_mm.qbits_moe_prefill(h3, *self.proj_down.operands())  # [E, cap, H]
            out = torch.zeros((S, H), dtype=torch.float32, device=x.device)
            for e in range(E):
                out.index_add_(0, idx[e], top_v[e][:, None] * d3[e])
        return out.to(x.dtype)


def convert_moe_to_stacked(model: nn.Module, *, capacity_factor: Optional[float] = 2.0) -> int:
    """Replace every dense-mask `MixtralSparseMoeBlock` under `model` with a
    `StackedSparseMoeBlock`, in place; returns how many were replaced. Apply
    after quantize + freeze (or loading), as `quanto_tpu`'s converter."""
    blocks = [(name, m) for name, m in model.named_modules() if isinstance(m, MixtralSparseMoeBlock)]
    for name, block in blocks:
        if not name:
            raise ValueError("convert_moe_to_stacked replaces blocks inside a model, not the model itself")
        set_module_by_name(model, name, StackedSparseMoeBlock(block, capacity_factor=capacity_factor))
    return len(blocks)
