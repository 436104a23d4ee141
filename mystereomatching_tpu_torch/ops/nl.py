"""NL: non-local cost aggregation on the image's MST, its GFNL blend with
the guided filter, and the standalone qx NL disparity flow.

Counterpart of ``nl_aggregate``, ``nl_aggregate_batch``, ``gfnl_aggregate``,
``flip_corr_vol``, ``detect_occlusion_lr`` and ``nl_disparity`` in
``mystereomatching_tpu/ops/nl.py`` (NL() stereoMatching.cpp:4892-4917,
GFNL cpp:4421-4490, qx_nonlocal_cost_aggregation.cpp:72-109).
The trees come from ``pipeline.nl_trees``: built on the device
(``ops/mst.build_tree``, the JAX default) or, with ``nl_tree_host``, on the
host (``ops/mst.build_tree_host``); a batch's from
``ops/mst.build_tree_batch``. The filter is ``ops/mst.filter_rows``. The
JAX flow filters the left and right trees as one forest (a speed device of its own); here each tree is filtered alone,
which gives each node the same sums. WTA is kernel D (``ops/wta.wta``) on a
CUDA tensor; the rest is plain torch: the JAX package has no TPU kernel here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mystereomatching_tpu_torch.ops import guided, mst
from mystereomatching_tpu_torch.ops.cost import _box_sum, fma32
from mystereomatching_tpu_torch.ops import wta as wta_ops
from mystereomatching_tpu_torch.ops.median import median_small
from mystereomatching_tpu_torch.ops.volume import flip_volume_lr


def _filter_cols(tree: mst.RootedTree, cols: torch.Tensor, sigma: float, normalize: bool,
                 bf16_peels: bool) -> torch.Tensor:
    """Tree filter of [C, N] node-order columns, float32 [C, N]; with
    ``normalize`` divided by the filter of an all-ones column, at least
    1e-12, which rides as one more column of the same filter (a bfloat16
    volume joins float32 there, as the JAX concatenation promotes it)."""
    c = cols.shape[0]
    if normalize:
        cols = torch.cat([cols.to(torch.float32), cols.new_ones((1, cols.shape[1]),
                                                               dtype=torch.float32)])
    f = mst.from_rows(tree, mst.filter_rows(tree, mst.to_rows(tree, cols), sigma, bf16_peels))
    if normalize:
        f = f[:c] / torch.clamp(f[c:], min=1e-12)
    return f


def filter_volume(tree: mst.RootedTree, vol: torch.Tensor, sigma: float,
                  normalize: bool = False, compute_dtype=None) -> torch.Tensor:
    """Tree filter of each [H, W] plane of a [D, H, W] volume, float32 [D,
    H, W] (:func:`_filter_cols`); ``compute_dtype`` "bfloat16" rounds as
    the JAX filter's bfloat16 mode where it applies (``mst.filter_rows``)."""
    d = vol.shape[0]
    bf16 = mst.peels_in_bfloat16(compute_dtype, vol.shape[1] * vol.shape[2])
    return _filter_cols(tree, vol.reshape(d, -1), sigma, normalize, bf16).reshape(vol.shape)


def nl_aggregate(vol: torch.Tensor, tree: mst.RootedTree, sigma: float = 0.1,
                 compute_dtype=None) -> torch.Tensor:
    """NL aggregation of a [D, H, W] volume (float32 or bfloat16) on its
    image's MST, normalised by the filter of an all-ones volume as the
    reference's caller does (cpp:4899-4910), float32. ``compute_dtype``:
    ``nl_filter_dtype`` (:func:`filter_volume`)."""
    return filter_volume(tree, vol, sigma, normalize=True, compute_dtype=compute_dtype)


def nl_aggregate_batch(vols: torch.Tensor, forest: mst.RootedTree, sigma: float = 0.1,
                       compute_dtype=None) -> torch.Tensor:
    """NL aggregation of B [D, H, W] volumes ([B, D, H, W]) on the forest of
    their images' MSTs (``mst.build_tree_batch``) in one filter, float32
    [B, D, H, W]: each frame's equal to :func:`nl_aggregate` on its own
    tree, bit for bit, ``compute_dtype`` applying as it does to one frame
    (the JAX ``nl_aggregate_batch``, nl.py:82, filters in float32)."""
    b, d, h, w = vols.shape
    bf16 = mst.peels_in_bfloat16(compute_dtype, h * w)
    f = _filter_cols(forest, vols.transpose(0, 1).reshape(d, b * h * w), sigma, True, bf16)
    return f.view(d, b, h, w).transpose(0, 1)


def gfnl_blend(gf_vol: torch.Tensor, nl_vol: torch.Tensor, gray: torch.Tensor) -> torch.Tensor:
    """GFNL's blend of a GF and an NL [D, H, W] volume by the 3x3 variance
    of the [H, W] gray image: pure NL where it is below 400, else half and
    half. The variance rounds as jitted XLA-CPU computes it: the box sums
    times the float32 reciprocal of 9, and box(g^2) / 9 - mean^2 one fused
    multiply-add of box(g^2) and that reciprocal."""
    g = gray.to(torch.float32)
    ninth = float(np.float32(1.0) / np.float32(9.0))
    mean = _box_sum(g, 1, 1) * ninth
    var = fma32(_box_sum(g * g, 1, 1), ninth, -(mean * mean))
    blend = torch.where(var < 400.0, 1.0, 0.5)[None]
    return blend * nl_vol + (1.0 - blend) * gf_vol


def gfnl_aggregate(vol: torch.Tensor, image: torch.Tensor, gray: torch.Tensor,
                   tree: mst.RootedTree, cfg) -> torch.Tensor:
    """GFNL (cpp:4421-4490): the guided filter (``guided.guided_filter_volume``,
    guided by the image with ``gf_color_guide``, else the gray) and the
    NL aggregation on ``tree`` (float32, as the JAX package calls it,
    whatever ``nl_filter_dtype``) of a [D, H, W] volume, blended by
    :func:`gfnl_blend`."""
    gf_vol = guided.guided_filter_volume(vol, image if cfg.gf_color_guide else gray,
                                         cfg.gf_radius, cfg.gf_eps)
    return gfnl_blend(gf_vol, nl_aggregate(vol, tree, cfg.nl_sigma), gray)


def flip_corr_vol(vol: torch.Tensor) -> torch.Tensor:
    """The right-view volume with the reference's edge quirk
    (qx_stereo_flip_corr_vol, qx_basic.cpp:577-588): vmR[d, y, x] =
    vmL[d, y, x + d] while x + d < W; past the border the previous
    disparity's value repeats, which is vmL[W-1-x, y, W-1]."""
    d_, _, w = vol.shape
    vr = flip_volume_lr(vol)
    d_idx = torch.arange(d_, device=vol.device)[:, None, None]
    d_max = (w - 1) - torch.arange(w, device=vol.device)[None, None, :]
    sel = torch.clamp(w - 1 - torch.arange(w, device=vol.device), 0, d_ - 1)
    vb = vol[:, :, w - 1][sel].t()                      # [H, W]
    return torch.where(d_idx <= d_max, vr, vb[None])


def detect_occlusion_lr(d_left: torch.Tensor, d_right: torch.Tensor) -> torch.Tensor:
    """Occlusion mask, True where occluded (qx_detect_occlusion_left_right,
    qx_basic.cpp:603-633): a pixel survives only when d > 0, x - d >= 0 and
    the right map at x - d equals d exactly."""
    w = d_left.shape[1]
    xr = torch.arange(w, device=d_left.device)[None, :] - d_left
    dr = torch.gather(d_right, 1, torch.clamp(xr, 0, w - 1).to(torch.int64))
    return (xr < 0) | (d_left == 0) | (d_left != dr)


def nl_disparity(vol: torch.Tensor, trees: Tuple[mst.RootedTree, mst.RootedTree],
                 sigma: float = 0.1):
    """The standalone NL flow, qx_nonlocal_cost_aggregation::disparity
    (cpp:72-109), unnormalised as the qx filter is:

      1. left tree filter of the [D, H, W] volume -> WTA -> 5x5 median;
      2. right tree filter of the flipped volume -> WTA -> median;
      3. the exact-agreement occlusion mask;
      4. the rebuilt volume |d_hat - d| on unoccluded pixels, 0 elsewhere;
      5. left tree filter of it at sigma / 2 -> WTA -> median.

    ``trees``: the (left, right) images' trees. Returns (disparity int32
    [H, W], the stage-1 map)."""
    tree_l, tree_r = trees

    def filt_wta(v, tree, sig):
        return median_small(wta_ops.wta(filter_volume(tree, v, sig)), 5)

    d_l = filt_wta(vol, tree_l, sigma)
    d_r = filt_wta(flip_corr_vol(vol), tree_r, sigma)
    occ = detect_occlusion_lr(d_l, d_r)
    ds = torch.arange(vol.shape[0], dtype=torch.float32, device=vol.device)[:, None, None]
    dd = torch.abs(d_l[None].to(torch.float32) - ds)
    vol2 = torch.where(occ[None], torch.zeros((), device=vol.device), dd)
    return filt_wta(vol2, tree_l, sigma / 2), d_l
