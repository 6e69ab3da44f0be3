"""Process groups for tensor parallelism over `torch.distributed`.

Counterpart of `quanto_tpu/parallel/distributed.py:24 initialize`. JAX runs
one program over a mesh and XLA inserts the collectives; the port runs one
process per rank, each holding its own shards, and sums partial results with
`ops/collectives.py:all_reduce`, the counterpart of XLA's psum.

The backend follows where the ranks' tensors live, not a switch:
- `nccl` when each rank has a CUDA device of its own;
- `gloo` when ranks share one device or run on the CPU. NCCL refuses two
  ranks on one device ("Duplicate GPU detected"). Gloo takes CUDA tensors
  for `all_reduce` by staging them through the host: it copies each to a
  pinned host buffer, sums there, and copies the sum back, so every call
  waits for the work queued before it. On ranks that share one card it
  checks what is real in tensor parallelism (each rank's kernels at the
  shard shapes, the collectives, the agreement with the unsharded model),
  and measures no tensor-parallel speed.

A device is told apart from another by what names it on any host: the
host's name and the card's UUID. A device index such as "cuda:0" names a
different card in each rank that sees only its own card (a per-process
`CUDA_VISIBLE_DEVICES`), or on another host.
"""

from __future__ import annotations

import socket
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.collectives import TPGroup


__all__ = ["initialize"]


def device_identity(device: torch.device) -> Tuple[str, str]:
    """(host name, the card's UUID) for a CUDA device; (host name, "cpu") for the CPU."""
    host = socket.gethostname()
    if device.type != "cuda":
        return host, "cpu"
    return host, str(torch.cuda.get_device_properties(device).uuid)


def choose_backend(identities: Sequence[Tuple[str, str]]) -> str:
    """"nccl" when every rank is on a CUDA device and no two ranks are on the
    same one (`device_identity`); else "gloo"."""
    on_cards = all(ident[1] != "cpu" for ident in identities)
    return "nccl" if on_cards and len(set(identities)) == len(identities) else "gloo"


def initialize(rank: int, world_size: int, init_method: str, device="cuda") -> TPGroup:
    """Join the process group `init_method` (say "file:///tmp/tp_store" or
    "tcp://localhost:29500") as `rank` of `world_size`, with this rank's
    tensors on `device`; returns the TP group.

    Every rank first joins over gloo and tells the others its device's
    identity (`device_identity`). Where `choose_backend` takes NCCL, the
    group is a new NCCL group; otherwise the gloo group (module docstring).
    Asked for the card where there is none, it raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA device; pass device='cpu' to run the ranks on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world_size)
    identities = [None] * world_size
    dist.all_gather_object(identities, device_identity(device))
    if choose_backend(identities) == "nccl":
        return TPGroup(rank, world_size, dist.new_group(backend="nccl"), device, "nccl")
    return TPGroup(rank, world_size, dist.group.WORLD, device, "gloo")
