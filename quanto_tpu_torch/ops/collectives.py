"""The tensor-parallel group and the one collective the port runs over it.

`all_reduce` is the counterpart of XLA's psum in the JAX package: the
row-parallel matmul (`ops/cuda/qbits_mm_sharded.py`), the vocab-parallel
embedding and the gathered logits (`models/llama.py`) sum over the group
with it. The group comes from `parallel/distributed.py:initialize`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


__all__ = ["TPGroup", "all_reduce"]


@dataclass(frozen=True, eq=False)
class TPGroup:
    """One rank's view of its tensor-parallel group."""

    rank: int
    world_size: int
    group: Optional[dist.ProcessGroup]  # None only for a group that never reduces (tests of sharding)
    device: torch.device
    backend: str = "gloo"


def all_reduce(t: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """Sum `t` over the group's ranks, in place; returns `t`. Each call adds
    one to `all_reduce.calls`."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.group)
    all_reduce.calls += 1
    return t


all_reduce.calls = 0
