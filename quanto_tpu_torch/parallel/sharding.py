"""Tensor-parallel sharding of a frozen, quantized Llama-family model.

Counterpart of `quanto_tpu/parallel/sharding.py`. JAX places each parameter
on a mesh with a `PartitionSpec` and XLA inserts the collectives; the port
runs one process per rank (`parallel/distributed.py:initialize`), keeps only
the rank's part of each sharded weight, and sums partial products
explicitly (Megatron-style):
- q/k/v/gate/up projections column-parallel: each rank computes its own
  heads and intermediate columns;
- o/down projections row-parallel: partial sums over the rank's K slice,
  then all_reduce (`ops/cuda/qbits_mm_sharded.py:qbits_mm_partitioned`);
- the embedding vocab-parallel: a masked lookup of the rank's rows, then
  all_reduce (exact: one rank contributes each row);
- the lm_head column-parallel over the vocabulary: each rank's logits are
  gathered to the full vocabulary on every rank
  (`models/llama.py:LlamaForCausalLM.forward`), so that the samplers see
  the same logits everywhere.

Pad-free rule (`_put`, `sharding.py:203-212`): where the world size does not
divide the sharded dimension, the weight is replicated. A weight zero-padded
onto the kernels' envelope is replicated too (`sharding.py:237-241`). Float linears stay
whole on every rank (sharding float weights is a later slice): a float
lm_head then computes every logit on every rank, which is what the gather
gives.
"""

from __future__ import annotations

import re
from typing import Iterable, Optional, Tuple

import torch
from torch import nn

from ..models.llama import LlamaAttention, LlamaForCausalLM
from ..nn.qmodule import QModuleMixin
from ..tensor.weights import WeightQBitsArray, WeightQBitsHopperArray, padded, shard_qbits


__all__ = ["LLAMA_TP_RULES", "shard_model"]


# A rule: (module-name regex, spec of the [out, in] weight), the specs as JAX's PartitionSpecs:
# ("tp", None) shards the first axis (out, or the vocabulary of an embedding), (None, "tp") the second.
ShardingRule = Tuple[str, Tuple[Optional[str], Optional[str]]]

# `quanto_tpu/parallel/sharding.py:70-75`, over the same Hugging Face module names.
LLAMA_TP_RULES: Tuple[ShardingRule, ...] = (
    (r"\b(q_proj|k_proj|v_proj|gate_proj|up_proj)\b", ("tp", None)),  # column-parallel
    (r"\b(o_proj|down_proj)\b", (None, "tp")),  # row-parallel
    (r"\bembed_tokens\b", ("tp", None)),  # vocab-parallel embedding [vocab, hidden]
    (r"\blm_head\b", ("tp", None)),  # vocab-parallel head [vocab, hidden]
)


def _match_spec(name: str, rules: Iterable[ShardingRule]):
    """The spec of the first rule whose regex `re.search`es `name`, else None."""
    for pattern, spec in rules:
        if re.search(pattern, name):
            return spec
    return None


def _shard_qlinear(m: QModuleMixin, name: str, spec, group) -> None:
    w = m.weight
    if not m.frozen:
        raise NotImplementedError(f"shard_model: {name} is not frozen; sharding float weights is not ported yet: "
                                  "ROADMAP.md Queue 1, item 10")
    if not isinstance(w, (WeightQBitsArray, WeightQBitsHopperArray)):
        raise NotImplementedError(f"shard_model: {name} holds a {type(w).__name__}; tensor parallelism takes "
                                  "int4/int2 weights only so far: ROADMAP.md Queue 1, item 10")
    if w.shard is not None:
        return  # sharded already
    axis = 0 if spec[0] is not None else 1
    mode = "column" if axis == 0 else "row"
    if w.shape[axis] % group.world_size or padded(w):
        mode = "replicated"  # pad-free rule; a padded weight is replicated
    m.weight = shard_qbits(w, mode, group)
    if m.bias is not None and mode == "column":
        n = m.weight.shape[0]
        m.bias = nn.Parameter(m.bias[group.rank * n : (group.rank + 1) * n].clone(), requires_grad=False)


def _shard_embedding(m: nn.Embedding, group) -> None:
    """The rank's rows of the vocabulary; the whole table where the world size
    does not divide it (pad-free rule) or it is sharded already."""
    V = m.num_embeddings
    if m.weight.shape[0] != V or V % group.world_size:
        return
    n = V // group.world_size
    m.weight = nn.Parameter(m.weight[group.rank * n : (group.rank + 1) * n].clone(), requires_grad=False)


def _local_heads(attn: LlamaAttention, name: str) -> None:
    """Set the attention's head counts to those its projections give this rank,
    and check that they are whole heads that fit together."""
    D = attn.head_dim
    q, kv = attn.q_proj.weight.shape[0], attn.k_proj.weight.shape[0]
    whole = q % D == 0 and kv % D == 0 and (q // D) % (kv // D) == 0
    if not whole or attn.v_proj.weight.shape[0] != kv or attn.o_proj.weight.shape[1] != q:
        raise ValueError(f"shard_model: {name}'s shards are not whole, matching heads (q {q}, kv {kv}, head dim {D})")
    attn.num_heads, attn.num_kv_heads = q // D, kv // D


@torch.no_grad()
def shard_model(model: nn.Module, group, rules: Iterable[ShardingRule] = LLAMA_TP_RULES) -> None:
    """Keep, in place, only this rank's part of every module of `model` that
    a rule names (`quanto_tpu/parallel/sharding.py:272`): a frozen int4/int2
    `QLinear` column- or row-parallel (its weight's `shard` records which,
    and `group`), an `nn.Embedding` vocab-parallel; then give each attention
    its local heads and, on a whole `LlamaForCausalLM`, record `group` as
    its `tp`. `model` may be one decoder layer (module names relative to
    it), so that a model larger than the card is sharded as it is built;
    parts sharded already are left as they are.

    Raises `NotImplementedError` on an unfrozen `QLinear` and on 8-bit
    weights (later slices)."""
    rules = tuple(rules)
    for name, m in model.named_modules():
        spec = _match_spec(name, rules)
        if spec is None:
            continue
        if isinstance(m, QModuleMixin):
            _shard_qlinear(m, name, spec, group)
        elif isinstance(m, nn.Embedding) and spec[0] is not None:
            _shard_embedding(m, group)
    for name, m in model.named_modules():
        if isinstance(m, LlamaAttention):
            _local_heads(m, name)
    if isinstance(model, LlamaForCausalLM):
        model.tp = group

