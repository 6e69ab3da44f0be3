"""parallel of quanto_tpu_torch: the single-device stacked-expert MoE
dispatch (`moe.py`); the sharded and expert-parallel layers of the JAX
package wait for later slices."""

from .moe import StackedSparseMoeBlock, convert_moe_to_stacked


__all__ = ["StackedSparseMoeBlock", "convert_moe_to_stacked"]
