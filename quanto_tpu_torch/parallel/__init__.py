"""parallel of quanto_tpu_torch: the single-device stacked-expert MoE
dispatch (`moe.py`: Mixtral, Qwen3-MoE and gpt-oss) and tensor parallelism for the Llama family over
`torch.distributed` (`distributed.py`, `sharding.py`); the other sharded and
expert-parallel layers of the JAX package wait for later slices."""

from .distributed import initialize
from .moe import StackedGptOssMoE, StackedSparseMoeBlock, convert_gpt_oss_moe_to_stacked, convert_moe_to_stacked
from .sharding import LLAMA_TP_RULES, shard_model


__all__ = [
    "initialize",
    "LLAMA_TP_RULES",
    "shard_model",
    "StackedGptOssMoE",
    "StackedSparseMoeBlock",
    "convert_gpt_oss_moe_to_stacked",
    "convert_moe_to_stacked",
]
