"""parallel of quanto_tpu_torch: the single-device stacked-expert MoE
dispatch (`moe.py`) and tensor parallelism for the Llama family over
`torch.distributed` (`distributed.py`, `sharding.py`); the other sharded and
expert-parallel layers of the JAX package wait for later slices."""

from .distributed import initialize
from .moe import StackedSparseMoeBlock, convert_moe_to_stacked
from .sharding import LLAMA_TP_RULES, shard_model


__all__ = [
    "initialize",
    "LLAMA_TP_RULES",
    "shard_model",
    "StackedSparseMoeBlock",
    "convert_moe_to_stacked",
]
