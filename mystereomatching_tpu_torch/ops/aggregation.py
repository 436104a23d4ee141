"""Cost aggregation (L2): cross-based cost aggregation (CBCA) and the NL
tree filter.

Counterpart of the ``"cbca"`` and ``"nl"`` branches of
``mystereomatching_tpu/ops/aggregation.py``. :func:`nl` is
``ops/nl.nl_aggregate`` on the view's tree. :func:`cbca` follows the JAX
CPU branch: iteration i runs an H pass then a V pass when i is even, V
then H when odd (cbca_core cpp:5605-5616). The first pass is an
arm-bounded sum; the second sums the volume and the first pass's support
count together and divides (genfinalVm_cbca cpp:3969-3992). Both passes
are CUDA kernel B on a CUDA tensor (``arms.arm_bounded_sum`` /
``arms.arm_bounded_sum_area``).
"""

from __future__ import annotations

import torch

from mystereomatching_tpu_torch.ops import nl as nl_ops
from mystereomatching_tpu_torch.ops.arms import arm_bounded_sum, arm_bounded_sum_area

_H, _W = 1, 2  # axes of a [D, H, W] volume


def cbca(vol: torch.Tensor, arms_int: torch.Tensor, iterations: int = 2,
         max_arm: int = 34) -> torch.Tensor:
    """vol: [D, H, W] float32 or bfloat16 (every tap's add and the division
    round in it, as the JAX CPU path does); arms_int: [4, D, H, W] int8
    intersected arms (left, right, up, down). Returns the aggregated
    [D, H, W] volume in vol's dtype."""
    arm_l, arm_r, arm_u, arm_d = arms_int.unbind(0)
    horizontal = (_W, arm_l, arm_r)
    vertical = (_H, arm_u, arm_d)
    for it in range(iterations):
        first, second = (horizontal, vertical) if it % 2 == 0 else (vertical, horizontal)
        ax1, an1, ap1 = first
        ax2, an2, ap2 = second
        vol = arm_bounded_sum(vol, an1, ap1, ax1, max_arm)
        vol = arm_bounded_sum_area(vol, an1, ap1, an2, ap2, ax2, max_arm)
    return vol


def nl(vol: torch.Tensor, tree, cfg) -> torch.Tensor:
    """NL aggregation (the JAX ``aggregate``'s ``"nl"`` branch) of a float32
    [D, H, W] volume on ``tree``, its image's MST (``ops/mst.RootedTree``).
    Only the float32 filter is ported (``nl_filter_dtype``)."""
    if cfg.nl_filter_dtype != "float32":
        raise NotImplementedError(f"nl_filter_dtype {cfg.nl_filter_dtype!r} is not ported yet")
    return nl_ops.nl_aggregate(vol, tree, cfg.nl_sigma)
