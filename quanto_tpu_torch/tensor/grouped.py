"""Group-wise reshaping for grouped quantization.

PyTorch counterpart of `quanto_tpu/tensor/grouped.py`: a tensor quantized
along `axis` with `group_size` is reshaped so that each group occupies one row
(axis 0) or one column (axis -1), so per-group scales broadcast per axis.
"""

from __future__ import annotations

from typing import Sequence

import torch


__all__ = ["group", "ungroup"]


def group(base: torch.Tensor, axis: int, group_size: int) -> torch.Tensor:
    if axis not in (0, -1):
        raise ValueError("Axis must be 0 or -1 for group-wise quantization")
    axis_dim = base.shape[axis]
    axis_numel = base.numel() // axis_dim
    if group_size > axis_numel or axis_numel % group_size != 0:
        raise ValueError(f"Group size ({group_size}) must be a divisor of ({axis_numel})")
    axis_groups = axis_numel // group_size
    if axis == 0:
        return base.reshape(-1, group_size)
    # axis == -1: (group_size, axis_dim * axis_groups), one group per column.
    grouped = base.reshape(axis_groups, group_size, axis_dim).permute(1, 2, 0)
    return grouped.reshape(group_size, axis_dim * axis_groups)


def ungroup(grouped: torch.Tensor, axis: int, orig_shape: Sequence[int]) -> torch.Tensor:
    orig_shape = tuple(orig_shape)
    if tuple(grouped.shape) == orig_shape:
        return grouped
    if axis == 0:
        return grouped.reshape(orig_shape)
    group_size = grouped.shape[0]
    axis_dim = orig_shape[axis]
    axis_groups = grouped.numel() // axis_dim // group_size
    ungrouped = grouped.reshape(group_size, axis_dim, axis_groups).permute(2, 0, 1)
    return ungrouped.reshape(orig_shape)
