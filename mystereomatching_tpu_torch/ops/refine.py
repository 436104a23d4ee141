"""Disparity refinement of the default, ``sgm8_full`` and ``fullres_occfill``
presets: LR check (plain and classifying), region vote, proper
interpolation, background fill, subpixel enhancement and the median.

Counterpart of those chains' functions in
``mystereomatching_tpu/ops/refine.py`` (refine() stereoMatching.cpp:1138-1511).
Disparity maps are int32 [H, W]; the plain LR check marks a failure -1
(cpp:2277) and the other sentinels are negative too (DISP_OCC -32, DISP_MIS
-48, h:215-218).
Region vote runs the CUDA kernel ``csrc/region_vote.cu`` (one launch a
pass) and proper interpolation ``csrc/pi_scan.cu`` on a CUDA tensor, and
:func:`region_vote_plain` and :func:`proper_interpolation_plain` on a CPU
one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops.arms import arm_bounded_reduce_plain
from mystereomatching_tpu_torch.ops.median import median_small
from mystereomatching_tpu_torch.ops.wta import neighbour_costs

_INT32_MAX = torch.iinfo(torch.int32).max


def lr_consistency(d_left: torch.Tensor, d_right: torch.Tensor,
                   max_diff: int = 0) -> torch.Tensor:
    """Plain LRC (LRConsistencyCheck_normal cpp:2262-2282): -1 where d < 0,
    u - d < 0 or |d_L(u) - d_R(u - d)| > max_diff.

    A gather along W with the column clamped into the image. The JAX code's
    rolls wrap around the row instead, but only where u - d < 0, which the
    range test masks, so the maps are equal."""
    w = d_left.shape[1]
    u = torch.arange(w, dtype=d_left.dtype, device=d_left.device)[None, :]
    x = u - d_left
    dr = torch.gather(d_right, 1, x.clamp(0, w - 1).to(torch.int64))
    ok = (d_left >= 0) & (x >= 0) & ((d_left - dr).abs() <= max_diff)
    return torch.where(ok, d_left, torch.full_like(d_left, -1))


def lr_consistency_classify(d_left: torch.Tensor, d_right: torch.Tensor,
                            num_disp: int, max_diff: int = 0, disp_occ: int = -32,
                            disp_mis: int = -48) -> torch.Tensor:
    """Classifying LRC (cpp:2284-2364): the pixels :func:`lr_consistency`
    fails become ``disp_mis`` where some right pixel x with 0 <= d_R(x) <
    num_disp maps onto their column (x + d_R(x) == u), else ``disp_occ``.

    The existence test scatters a count onto the columns; only ``> 0`` is
    read, so the order of the adds does not matter."""
    h, w = d_left.shape
    u = torch.arange(w, dtype=d_left.dtype, device=d_left.device)[None, :]
    x = u - d_left
    dr = torch.gather(d_right, 1, x.clamp(0, w - 1).to(torch.int64))
    ok = (d_left >= 0) & (x >= 0) & ((d_left - dr).abs() <= max_diff)
    tgt = u + d_right
    src = (d_right >= 0) & (d_right < num_disp) & (tgt < w)
    mark = torch.zeros((h, w), dtype=torch.int32, device=d_left.device)
    mark.scatter_add_(1, tgt.clamp(0, w - 1).to(torch.int64), src.to(torch.int32))
    fill = torch.where(mark > 0, torch.full_like(d_left, disp_mis),
                       torch.full_like(d_left, disp_occ))
    return torch.where(ok, d_left, fill)


def region_vote(disp: torch.Tensor, arms: torch.Tensor, num_disp: int,
                s_thres: int = 20, h_ratio: float = 0.4,
                int_ratio_quirk: bool = True, max_arm: int = 34) -> torch.Tensor:
    """One region-vote pass (regionVote_my cpp:7219-7277) in its unanimity
    form, the reference's integer-ratio quirk (cpp:7266): an invalid pixel
    takes the disparity of its cross support when more than ``s_thres``
    support pixels are valid and all of them agree.

    The support is the anchor's vertical arms over rows whose horizontal
    arms are each row's own, so the min, max (as min of -d) and valid count
    run along W with the left/right arms, then along H with the up/down
    arms. ``arms`` are the left image's raw [4, H, W] cross arms. A CUDA
    tensor runs the whole pass as one launch of ``csrc/region_vote.cu``
    (``max_arm`` at most 127), a CPU one :func:`region_vote_plain`. The
    histogram form (``int_ratio_quirk=False``) is not ported; ``num_disp``
    and ``h_ratio`` only serve it.
    """
    if not int_ratio_quirk:
        raise NotImplementedError("region vote's histogram form "
                                  "(rv_int_ratio_quirk=False) is not ported yet")
    if ck.on_cuda(disp):
        return ck.region_vote(disp.contiguous(), arms.contiguous(), max_arm, s_thres)
    return region_vote_plain(disp, arms, s_thres, max_arm)


def region_vote_plain(disp: torch.Tensor, arms: torch.Tensor, s_thres: int = 20,
                      max_arm: int = 34) -> torch.Tensor:
    """Plain torch unanimity region vote: the min and max (as min of -d) of
    the valid disparities and their count, each an arm-bounded reduction
    along W and then along H (``arms.arm_bounded_reduce_plain``), and the
    accept rule."""
    valid = disp >= 0
    big = torch.full_like(disp, _INT32_MAX)
    mm = torch.stack([torch.where(valid, disp, big), torch.where(valid, -disp, big)])
    left, right, up, down = arms.unbind(0)
    mm = arm_bounded_reduce_plain(mm, left, right, 2, max_arm, "min")
    mm = arm_bounded_reduce_plain(mm, up, down, 1, max_arm, "min")
    count = arm_bounded_reduce_plain(valid.to(torch.int32)[None], left, right, 2, max_arm,
                                     "sum")
    count = arm_bounded_reduce_plain(count, up, down, 1, max_arm, "sum")[0]
    dmin, dmax = mm[0], -mm[1]
    accept = ~valid & (count > s_thres) & (dmin == dmax) & (dmin != _INT32_MAX)
    return torch.where(accept, dmin, disp)


# the 16 ray directions of properIpol (cpp:7403-7404), as half steps
_PI_DIR_W = (0, 2, 2, 2, 0, -2, -2, -2, 1, 2, 2, 1, -1, -2, -2, -1)
_PI_DIR_H = (2, 2, 0, -2, -2, -2, 0, 2, 2, 1, -1, -2, -2, -1, 1, 2)


def pi_offsets(search_depth: int) -> np.ndarray:
    """[16, search_depth, 2] int32 cumulative (dv, du) per direction and
    step, with the reference's C++ truncating half steps (cpp:7430-7441)."""
    def cdiv2(x):  # C++ integer division truncates toward zero
        return int(x / 2) if x >= 0 else -int(-x / 2)

    offs = np.zeros((16, search_depth, 2), np.int32)
    for k in range(16):
        ph, pw = _PI_DIR_H[k], _PI_DIR_W[k]
        v = u = 0
        for dep in range(search_depth):
            if dep % 2 == 0:
                v += cdiv2(ph)
                u += cdiv2(pw)
            else:
                v += ph - cdiv2(ph)
                u += pw - cdiv2(pw)
            offs[k, dep] = (v, u)
    return offs


def proper_interpolation_plain(disp: torch.Tensor, image: torch.Tensor,
                               offsets: torch.Tensor,
                               disp_occ: int = -32) -> torch.Tensor:
    """Plain torch proper interpolation, the JAX XLA path's rules
    (refine.py:515-566): along each ray the first valid tap and its
    max-channel colour difference; DISP_OCC pixels take the smallest ray
    disparity, other invalid pixels the first strict colour minimum among
    rays with difference < 255. disp: int32 [H, W]; image: float32
    [H, W, 3]; offsets: [16, depth, 2] from :func:`pi_offsets`."""
    h, w = disp.shape
    offs = offsets.tolist()
    m = max(1, int(offsets.abs().max()))
    img = image.permute(2, 0, 1)                                 # [3, H, W]
    dpad = F.pad(disp, (m, m, m, m), value=-1)
    cpad = F.pad(img, (m, m, m, m), value=1e9)
    inf = torch.full((h, w), float("inf"), device=disp.device)
    found_any = torch.zeros((h, w), dtype=torch.bool, device=disp.device)
    occ_min = torch.full_like(disp, 10 ** 6)
    best_cd = inf
    best_d = torch.full_like(disp, -1)
    any_mis = torch.zeros_like(found_any)
    for ray in offs:
        found = torch.zeros_like(found_any)
        dsp = torch.full_like(disp, -1)
        cdf = inf
        for dv, du in ray:
            nd = dpad[m + dv:m + dv + h, m + du:m + du + w]
            nc = cpad[:, m + dv:m + dv + h, m + du:m + du + w]
            hit = ~found & (nd >= 0)
            dsp = torch.where(hit, nd, dsp)
            cdf = torch.where(hit, (nc - img).abs().amax(0), cdf)
            found = found | hit
        found_any = found_any | found
        occ_min = torch.minimum(occ_min, torch.where(found, dsp, torch.full_like(dsp, 10 ** 6)))
        cd_eff = torch.where(found & (cdf < 255.0), cdf, inf)
        upd = cd_eff < best_cd
        best_d = torch.where(upd, dsp, best_d)
        best_cd = torch.where(upd, cd_eff, best_cd)
        any_mis = any_mis | torch.isfinite(cd_eff)
    mis_fill = torch.where(any_mis, best_d, disp)
    fill = torch.where(disp == disp_occ, torch.where(found_any, occ_min, disp), mis_fill)
    return torch.where(disp < 0, fill, disp)


def proper_interpolation(disp: torch.Tensor, image: torch.Tensor,
                         search_depth: int = 20, disp_occ: int = -32) -> torch.Tensor:
    """16-direction nearest-valid fill of the invalid pixels (properIpol
    cpp:7395-7490) of an int32 [H, W] map, colours from the [H, W, 3] image."""
    offsets = torch.from_numpy(pi_offsets(search_depth)).to(disp.device)
    image = image.to(torch.float32).contiguous()
    if ck.on_cuda(disp):
        return ck.pi_scan(disp.contiguous(), image, offsets, disp_occ)
    return proper_interpolation_plain(disp, image, offsets, disp_occ)


def _nearest_valid_left(disp: torch.Tensor) -> torch.Tensor:
    """Per row, the value of the nearest valid (>= 0) pixel strictly to the
    left, -1 where there is none: a running max of the valid pixels' column
    indices, then a gather. The JAX package packs value and column into one
    int32 key for its TPU scan, which limits W * num_disp; this has no
    such limit."""
    w = disp.shape[1]
    u = torch.arange(w, dtype=torch.int64, device=disp.device)[None, :]
    col = torch.where(disp >= 0, u, -1)
    col = torch.cat([torch.full_like(col[:, :1], -1), col[:, :-1]], 1).cummax(1).values
    return torch.where(col >= 0, torch.gather(disp, 1, col.clamp(min=0)),
                       torch.full_like(disp, -1))


def bg_interpolation(disp: torch.Tensor, num_disp: int = 1024) -> torch.Tensor:
    """Horizontal nearest-valid fill of the invalid pixels of an int32
    [H, W] map, taking the smaller (background) disparity of the two sides
    where both exist (backgroundInterpolateCore cpp:7010-7044, search depth
    unbounded). ``num_disp`` is kept for the JAX signature; the fill does
    not need it."""
    left = _nearest_valid_left(disp)
    right = _nearest_valid_left(disp.flip(1)).flip(1)
    both = (left >= 0) & (right >= 0)
    fill = torch.where(both, torch.minimum(left, right), torch.maximum(left, right))
    return torch.where((disp < 0) & (fill >= 0), fill, disp)


def subpixel_enhance(disp: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
    """Quadratic subpixel refinement of an int32 [H, W] map from the [D, H, W]
    cost volume (subpixelEnhancement cpp:6138-6167): d - (c[d+1] - c[d-1]) /
    (2 (c[d+1] + c[d-1] - 2 c[d])), the offset kept only inside (-1, 1);
    disparities 0 and D-1 and the negative sentinels stay as they are.
    Returns float32, as the JAX package does by default (the reference
    truncates back to short, cpp:6154)."""
    cm, c0, cp = neighbour_costs(vol, disp)
    denom = 2.0 * (cp + cm - 2.0 * c0)
    diff = torch.where(denom.abs() > 1e-12, (cp - cm) / denom, 0.0)
    diff = torch.where((diff > -1) & (diff < 1), diff, 0.0)
    inner = (disp > 0) & (disp < vol.shape[0] - 1)
    d = disp.to(torch.float32)
    return torch.where(inner, d - diff, d)


def median_blur_disp(disp: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """The median blur (refine() cpp:1499) of an int32 or float32 map;
    sentinels take part as values, as cv::medianBlur on CV_16S."""
    return median_small(disp, ksize)
