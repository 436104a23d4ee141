"""NL: non-local cost aggregation on the image's MST, and the standalone
qx NL disparity flow.

Counterpart of ``nl_aggregate``, ``flip_corr_vol``, ``detect_occlusion_lr``
and ``nl_disparity`` in ``mystereomatching_tpu/ops/nl.py`` (NL()
stereoMatching.cpp:4892-4917, qx_nonlocal_cost_aggregation.cpp:72-109).
The trees come from the host build (``ops/mst.build_tree``, which
``pipeline.nl_trees`` calls for a frame); the filter is
``ops/mst.filter_rows``. The JAX flow filters the left and right trees as
one forest (a speed device of its own); here each tree is filtered alone,
which gives each node the same sums. WTA is kernel D (``ops/wta.wta``) on a
CUDA tensor; the rest is plain torch: the JAX package has no TPU kernel here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mystereomatching_tpu_torch.ops import mst
from mystereomatching_tpu_torch.ops import wta as wta_ops
from mystereomatching_tpu_torch.ops.median import median_small
from mystereomatching_tpu_torch.ops.volume import flip_volume_lr


def filter_volume(tree: mst.RootedTree, vol: torch.Tensor, sigma: float,
                  normalize: bool = False) -> torch.Tensor:
    """Tree filter of each [H, W] plane of a [D, H, W] volume, float32 [D,
    H, W]; with ``normalize`` divided by the filter of an all-ones plane,
    at least 1e-12, which rides as one more column of the same filter."""
    d = vol.shape[0]
    cols = vol.reshape(d, -1)
    if normalize:
        cols = torch.cat([cols, torch.ones_like(cols[:1])])
    f = mst.from_rows(tree, mst.filter_rows(tree, mst.to_rows(tree, cols), sigma))
    if normalize:
        f = f[:d] / torch.clamp(f[d:], min=1e-12)
    return f.reshape(vol.shape)


def nl_aggregate(vol: torch.Tensor, tree: mst.RootedTree, sigma: float = 0.1) -> torch.Tensor:
    """NL aggregation of a [D, H, W] volume on its image's MST, normalised
    by the filter of an all-ones volume as the reference's caller does
    (cpp:4899-4910)."""
    return filter_volume(tree, vol, sigma, normalize=True)


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
