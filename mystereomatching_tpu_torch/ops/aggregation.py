"""Cost aggregation (L2): cross-based cost aggregation (CBCA), the box
and guided filters, FIF, AWS, JBF, GFNL and the NL tree filter.

Counterpart of ``mystereomatching_tpu/ops/aggregation.py``. :func:`nl` is
``ops/nl.nl_aggregate`` on the view's tree; :func:`box_filter_volume` the
box mean, :func:`aggregate` the dispatcher of the volumes that are
aggregated whole (``"bf"``, ``"gf"``, ``"fif"``, ``"aws"``, ``"jbf"`` and
``"gfnl"``), none with a kernel of its own, as in the JAX package.
:func:`cbca` follows the JAX
CPU branch: iteration i runs an H pass then a V pass when i is even, V
then H when odd (cbca_core cpp:5605-5616). The first pass is an
arm-bounded sum; the second sums the volume and the first pass's support
count together and divides (genfinalVm_cbca cpp:3969-3992). Both passes
are CUDA kernel B on a CUDA tensor (``arms.arm_bounded_sum`` /
``arms.arm_bounded_sum_area``).
"""

from __future__ import annotations

import torch

from mystereomatching_tpu_torch.ops import aws, fif, guided
from mystereomatching_tpu_torch.ops import nl as nl_ops
from mystereomatching_tpu_torch.ops.arms import arm_bounded_sum, arm_bounded_sum_area
from mystereomatching_tpu_torch.ops.cost import _box_sum

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
    """NL aggregation (the JAX ``aggregate``'s ``"nl"`` branch) of a
    [D, H, W] volume, float32 or bfloat16, on ``tree``, its image's MST
    (``ops/mst.RootedTree``), filtered in ``nl_filter_dtype``; float32."""
    return nl_ops.nl_aggregate(vol, tree, cfg.nl_sigma, compute_dtype=cfg.nl_filter_dtype)


def box_filter_volume(vol: torch.Tensor, radius: int = 6) -> torch.Tensor:
    """BF aggregation (cpp:1023-1043): the mean over the in-image pixels of
    a 2r x 2r window, [-(r-1), r] on each axis (cv::boxFilter 12x12), of
    every disparity plane of a [D, H, W] volume."""
    lo, hi = -(radius - 1), radius
    s = _box_sum(vol, radius, radius, lo, hi, lo, hi)
    ones = torch.ones(vol.shape[-2:], dtype=vol.dtype, device=vol.device)
    return s / _box_sum(ones, radius, radius, lo, hi, lo, hi)


def aggregate(vol: torch.Tensor, cfg, image: torch.Tensor, gray: torch.Tensor,
              other_image=None, lor: int = 0, tree=None) -> torch.Tensor:
    """A whole [D, H, W] float32 volume of view ``lor`` aggregated by
    ``cfg.aggregation``: the box filter (``"bf"``), the guided filter
    (``"gf"``, guided by ``image`` with ``gf_color_guide``, else by
    ``gray``), FIF (``"fif"``, FIF_Improve with ``fif_improve``), AWS
    (``"aws"``, joint weights of ``image`` and ``other_image``, the
    opposite view's image), JBF (``"jbf"``) or GFNL (``"gfnl"``, on
    ``tree``, the MST of ``image``); image/gray: the view's [H, W, 3] image
    and its gray."""
    if cfg.aggregation == "bf":
        return box_filter_volume(vol, cfg.bf_radius)
    if cfg.aggregation == "gf":
        guide = image if cfg.gf_color_guide else gray
        return guided.guided_filter_volume(vol, guide, cfg.gf_radius, cfg.gf_eps)
    if cfg.aggregation == "fif":
        fn = fif.fif_improve if cfg.fif_improve else fif.fif
        return fn(vol, image, sigma=cfg.fif_sigma, pn=cfg.fif_pn)
    if cfg.aggregation == "aws":
        left_img, right_img = (image, other_image) if lor == 0 else (other_image, image)
        return aws.aws_aggregate(vol, left_img, cfg, right_img, lor=lor)
    if cfg.aggregation == "jbf":
        return aws.jbf_volume(vol, image, cfg.jbf_radius, cfg.jbf_sigma_c, cfg.jbf_sigma_s)
    if cfg.aggregation == "gfnl":
        if tree is None:
            raise ValueError("aggregate: GFNL needs the view's tree (pipeline.nl_trees)")
        return nl_ops.gfnl_aggregate(vol, image, gray, tree, cfg)
    raise NotImplementedError(f"aggregation {cfg.aggregation!r} is not aggregated whole here")
