"""Disparity refinement: LR check (plain and classifying), fill of the
census border, PKR, the region votes (unanimity, histogram, tilted and
whole-image) and RV_combine_BG with its background fills, proper
interpolation, the background fills (plain and KITTI), the weighted
median, discontinuity adjustment, subpixel enhancement and the median.

Counterpart of ``mystereomatching_tpu/ops/refine.py`` (refine()
stereoMatching.cpp:1138-1511). Disparity maps are int32 [H, W]; the plain
LR check marks a failure -1 (cpp:2277) and the other sentinels are
negative too (DISP_INV -16, DISP_OCC -32, DISP_MIS -48, DISP_PKR -64,
h:215-218).
The unanimity region vote runs the CUDA kernel ``csrc/region_vote.cu``
(one launch a pass), the histogram votes' arm-bounded sums kernel B's
integer mode ``csrc/arm_reduce.cu`` (two launches a pass) and proper
interpolation ``csrc/pi_scan.cu`` on a CUDA tensor, and their plain
versions (:func:`region_vote_plain`, ``arms.arm_bounded_reduce_plain``,
:func:`proper_interpolation_plain`) on a CPU one. The rest is plain torch
on every device, as it is plain jnp in the JAX package. Integer work is
exact; the float work (PKR's ratio, the weighted median's weights)
rounds as jitted XLA-CPU does (see each function).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops.arms import (arm_bounded_reduce, arm_bounded_reduce_plain,
                                                 arm_bounded_sum_dir)
from mystereomatching_tpu_torch.ops.cost import cumsum_blocked, exp32, fma32
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
    """One region-vote pass (regionVote_my cpp:7219-7277): an invalid pixel
    takes the majority disparity of the valid pixels in its cross support
    when more than ``s_thres`` of them are valid and the majority's share
    passes the ratio test.

    The support is the anchor's vertical arms over rows whose horizontal
    arms are each row's own, so every sum runs along W with the left/right
    arms, then along H with the up/down arms. ``arms`` are the left image's
    raw [4, H, W] cross arms.

    With ``int_ratio_quirk`` (the reference's C++ integer division in
    ``hist[dispMost] / validNum >= rv_ratio``, cpp:7266) every valid support
    pixel must agree: the min, max (as min of -d) and valid count decide
    it. A CUDA tensor runs that pass as one launch of
    ``csrc/region_vote.cu`` (``max_arm`` at most 127), a CPU one
    :func:`region_vote_plain`. Without it, the float-ratio vote: the
    histogram of the support's disparities (:func:`vote_sums`, two
    ``arm_reduce`` launches on the card) and ``10 n_most >= 10 h_ratio
    validNum`` in float32, as the JAX package tests it; ties in the
    majority go to the smaller disparity.
    """
    if not int_ratio_quirk:
        hist, count = vote_sums(disp, arms, num_disp, max_arm)
        n_most, most = hist.amax(0), hist.argmax(0)
        ratio_ok = n_most.to(torch.float32) * 10 >= _f32(h_ratio * 10, disp) * count.to(
            torch.float32)
        accept = (disp < 0) & (count > s_thres) & ratio_ok
        return torch.where(accept, most.to(disp.dtype), disp)
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


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """x rounded to float32, as a 0-dim tensor on ``like``'s device."""
    return torch.full((), float(np.float32(x)), dtype=torch.float32, device=like.device)


def shift2d(x: torch.Tensor, dv: int, du: int, fill) -> torch.Tensor:
    """x[..., v + dv, u + du] of an [..., H, W] tensor, ``fill`` off the
    image (the JAX package's ``refine._shift2d``)."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    if abs(dv) >= h or abs(du) >= w:
        return out
    out[..., max(0, -dv): h - max(0, dv), max(0, -du): w - max(0, du)] = \
        x[..., max(0, dv): h - max(0, -dv), max(0, du): w - max(0, -du)]
    return out


def pkr_mask(vol: torch.Tensor, thresh: float = 0.1) -> torch.Tensor:
    """True where the peak ratio (c2 - c1) / c2 of the two smallest costs of
    a [D, H, W] volume is under ``thresh``: ambiguous (calPKR,
    cpp:4087-4126). c2 is the smallest cost once the FIRST minimum alone is
    masked (cpp:4115), so a repeated minimum gives ratio 0; c1 == c2 == 0
    gives NaN, which is not under ``thresh``. In the volume's dtype: a
    bfloat16 volume rounds the difference and the quotient to bfloat16 and
    compares with bfloat16(thresh), as the JAX package does on the CPU."""
    best = vol.argmin(0)
    c1 = vol.amin(0)
    ds = torch.arange(vol.shape[0], device=vol.device)[:, None, None]
    inf = torch.full((), float("inf"), dtype=vol.dtype, device=vol.device)
    c2 = torch.where(ds == best[None], inf, vol).amin(0)
    ratio = (c2 - c1) / c2
    return ratio < torch.full((), thresh, dtype=vol.dtype, device=vol.device)


def apply_pkr(disp: torch.Tensor, vol: torch.Tensor, thresh: float = 0.1,
              disp_pkr: int = -64) -> torch.Tensor:
    """signDp_UsingPKR (cpp:4128-4140): DISP_PKR where :func:`pkr_mask` marks
    the pixel ambiguous and the map still holds a valid (>= 0) disparity."""
    return torch.where(pkr_mask(vol, thresh) & (disp >= 0), torch.full_like(disp, disp_pkr),
                       disp)


def vote_stack(disp: torch.Tensor, num_disp: int) -> torch.Tensor:
    """[D + 1, H, W] int32: a one-hot plane a disparity of the valid (>= 0)
    pixels, and their count plane last, so that one arm-bounded sum
    aggregates both (the JAX ``_vote_stack``). Written with one scatter of
    an [H, W] index: no bool or int64 copy of the whole stack (at 1988x2880,
    D=256 the stack alone is 5.89 GB)."""
    valid = disp >= 0
    h, w = disp.shape
    stack = torch.zeros((num_disp + 1, h, w), dtype=torch.int32, device=disp.device)
    idx = torch.where(valid & (disp < num_disp), disp, num_disp).to(torch.int64)
    stack.scatter_(0, idx[None], valid.to(torch.int32)[None])
    stack[num_disp] = valid.to(torch.int32)
    return stack


def vote_sums(disp: torch.Tensor, arms: torch.Tensor, num_disp: int, max_arm: int = 34):
    """(histogram [D, H, W], valid count [H, W]) of each pixel's HV cross
    support: :func:`vote_stack` summed along W with the left/right arms,
    then along H with the up/down arms (``arms.arm_bounded_reduce``: two
    ``arm_reduce`` launches on the card, ``arm_bounded_reduce_plain`` on the
    CPU). Integer sums, exact."""
    arms = arms.to(torch.int32)
    left, right, up, down = (a.contiguous() for a in arms[:4].unbind(0))
    stack = arm_bounded_reduce(vote_stack(disp, num_disp), left, right, 2, max_arm, "sum")
    stack = arm_bounded_reduce(stack, up, down, 1, max_arm, "sum")
    return stack[:num_disp], stack[num_disp]


def _vote_result(hist: torch.Tensor, count: torch.Tensor, s_thres: int,
                 h_ratio: float) -> torch.Tensor:
    """The tail of cal_histogram_for_HV/Tile (cpp:6853-6861, 6902-6910): the
    majority disparity (ties to the smaller) where validNum > s_thres and
    n_most > h_ratio validNum (float32, both strict), else -1."""
    most = hist.argmax(0).to(torch.int32)
    n_most = hist.amax(0)
    ok = (count > s_thres) & (n_most.to(torch.float32)
                              > _f32(h_ratio, hist) * count.to(torch.float32))
    return torch.where(ok, most, torch.full_like(most, -1))


def vote_hv(disp: torch.Tensor, arms: torch.Tensor, num_disp: int, s_thres: int,
            h_ratio: float, max_arm: int = 34) -> torch.Tensor:
    """cal_histogram_for_HV (cpp:6830-6862): the histogram vote over each
    pixel's HV cross support (:func:`vote_sums`) for EVERY pixel, -1 where
    rejected; callers mask."""
    return _vote_result(*vote_sums(disp, arms, num_disp, max_arm), s_thres, h_ratio)


def vote_tilt(disp: torch.Tensor, arms_tilt: torch.Tensor, num_disp: int, s_thres: int,
              h_ratio: float, max_arm: int = 34) -> torch.Tensor:
    """cal_histogram_for_Tile (cpp:6864-6911): the 45-degree vote. A branch
    pass along (1, 1) with each pixel's own left-up / right-down arms
    (tilted arms 0 and 1), then the main pass along (1, -1) with the
    anchor's right-up / left-down arms (2 and 3), both plain torch
    (``arms.arm_bounded_sum_dir``, as in the JAX package). Only the anchor
    votes: the reference's two-point extension is dead code (cpp:6874)."""
    arms_tilt = arms_tilt.to(torch.int32)
    stack = arm_bounded_sum_dir(vote_stack(disp, num_disp), arms_tilt[0][None],
                                arms_tilt[1][None], (1, 1), max_arm)
    stack = arm_bounded_sum_dir(stack, arms_tilt[2][None], arms_tilt[3][None], (1, -1),
                                max_arm)
    return _vote_result(stack[:num_disp], stack[num_disp], s_thres, h_ratio)


def region_vote_core(disp: torch.Tensor, arms: torch.Tensor, arms_tilt, num_disp: int,
                     s_thres: int, h_ratio: float, reg_vote_type: int = 0,
                     max_arm: int = 34) -> torch.Tensor:
    """regionVoteCore (cpp:6925-6947) with its regVote_type dispatch: 0 the
    HV vote, 1 the tilted vote, 2 per pixel the HV vote where the HV arms'
    total is strictly longer than the tilted arms' (compareArmL
    cpp:6913-6923), else the tilted vote."""
    if reg_vote_type == 0:
        return vote_hv(disp, arms, num_disp, s_thres, h_ratio, max_arm)
    if reg_vote_type == 1:
        return vote_tilt(disp, arms_tilt, num_disp, s_thres, h_ratio, max_arm)
    hv = vote_hv(disp, arms, num_disp, s_thres, h_ratio, max_arm)
    tl = vote_tilt(disp, arms_tilt, num_disp, s_thres, h_ratio, max_arm)
    len_hv = arms[:4].to(torch.int32).sum(0)
    len_tl = arms_tilt[:4].to(torch.int32).sum(0)
    return torch.where(len_hv > len_tl, hv, tl)


def region_vote_whole_image(disp: torch.Tensor, arms: torch.Tensor, num_disp: int,
                            max_arm: int = 34) -> torch.Tensor:
    """regionVoteForWholeDispImg (cpp:6949-6962): every pixel becomes its HV
    support's majority disparity, thresholds (0, 0), -1 where the support
    holds no valid pixel. It votes on a snapshot of the map (one Jacobi
    step of the reference's in-place raster update), as the JAX package
    does."""
    return vote_hv(disp, arms, num_disp, 0, 0.0, max_arm)


def nearest_valid_with_index(disp: torch.Tensor, axis: int, reverse: bool):
    """(value, index along ``axis``) of the nearest valid (>= 0) pixel
    strictly before each pixel along ``axis`` (after it with ``reverse``),
    (-1, -1) where there is none; int32 both (the JAX
    ``_nearest_valid_with_index``): a running max of the valid pixels'
    indices, shifted to exclude the pixel itself, and a gather."""
    x = disp.flip(axis) if reverse else disp
    n = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = n
    pos = torch.arange(n, dtype=torch.int64, device=x.device).reshape(shape)
    idx = torch.where(x >= 0, pos, -1)
    idx = torch.cat([torch.full_like(idx.narrow(axis, 0, 1), -1), idx.narrow(axis, 0, n - 1)],
                    axis)
    last = idx.cummax(axis).values
    val = torch.where(last >= 0, torch.gather(x, axis, last.clamp(min=0)),
                      torch.full_like(x, -1))
    if reverse:
        val, last = val.flip(axis), last.flip(axis)
        last = torch.where(last >= 0, n - 1 - last, -1)
    return val, last.to(torch.int32)


def bg_fill_2dir(disp: torch.Tensor, depth: int = 1000, num_disp: int = 1024):
    """backgroundInterpolateCore (cpp:7010-7044): the first valid disparity
    to the right and to the left within ``depth`` steps; one found -> that
    one, both -> the smaller (background). Returns (fill, n_found), fill -1
    where neither side finds one. One nearest-valid pass a side with a
    distance test, in place of the JAX package's ``depth`` shifted passes
    (it takes those for ``depth < W - 1``; the maps are the same).
    ``num_disp`` is kept for the JAX signature."""
    w = disp.shape[1]
    u = torch.arange(w, dtype=torch.int32, device=disp.device)[None, :]
    left, li = nearest_valid_with_index(disp, 1, False)
    right, ri = nearest_valid_with_index(disp, 1, True)
    none = torch.full_like(disp, -1)
    left = torch.where((li >= 0) & (u - li <= depth), left, none)
    right = torch.where((ri >= 0) & (ri - u <= depth), right, none)
    n_found = (left >= 0).to(torch.int32) + (right >= 0).to(torch.int32)
    both = (left >= 0) & (right >= 0)
    fill = torch.where(both, torch.minimum(left, right), torch.maximum(left, right))
    return fill, n_found


def bg_fill_4dir(disp: torch.Tensor, image: torch.Tensor, depth: int = 1000) -> torch.Tensor:
    """backgroundInterpolateCore_ (cpp:7045-7144): the color-checked fill
    over four directions (left, right, up, down). Each direction's
    candidate is its first valid disparity within ``depth`` steps, with the
    max-channel |colour difference| between the pixel and that source (on
    the left image, cpp:7057). The winner is the smallest disparity (ties
    to the earlier direction); where a vertical one wins but the better
    horizontal candidate is strictly more colour-similar, that one takes
    over (cpp:7116-7141). -1 where no direction finds one."""
    h, w = disp.shape
    img = image.to(torch.float32).permute(2, 0, 1)                     # [C, H, W]
    here = {1: torch.arange(w, dtype=torch.int32, device=disp.device)[None, :].expand(h, w),
            0: torch.arange(h, dtype=torch.int32, device=disp.device)[:, None].expand(h, w)}
    inf = torch.full((), float("inf"), device=disp.device)
    cands, cdifs = [], []
    for axis, rev in ((1, False), (1, True), (0, False), (0, True)):
        val, src = nearest_valid_with_index(disp, axis, rev)
        ok = (val >= 0) & (src >= 0) & ((here[axis] - src).abs() <= depth)
        srcc = src.clamp(min=0).to(torch.int64)[None].expand_as(img)
        nc = torch.gather(img, axis + 1, srcc)
        cands.append(torch.where(ok, val, torch.full_like(val, -1)))
        cdifs.append(torch.where(ok, (nc - img).abs().amax(0), inf))
    cand, cdif = torch.stack(cands), torch.stack(cdifs)
    cval = torch.where(cand >= 0, cand, torch.full_like(cand, 10000))
    j = cval.argmin(0)[None]
    z = cval[:2].argmin(0)[None]
    j_val, j_dif = cand.gather(0, j)[0], cdif.gather(0, j)[0]
    z_val, z_dif = cand.gather(0, z)[0], cdif.gather(0, z)[0]
    swap = (j[0] >= 2) & (z_val >= 0) & (z_dif < j_dif)
    return torch.where(swap, z_val, j_val)


def rv_bg_policy(disp: torch.Tensor, rv, bg, interpolate_type: int, disp_occ: int = -32,
                 disp_mis: int = -48) -> torch.Tensor:
    """The pointwise fill policy of RV_combine_BG (cpp:7160-7213): 0 the
    region vote, 1 the background fill, 2 OCC the background fill and MIS
    the vote, 3 OCC min(vote, fill) where both hit (else the one that hits)
    and MIS the vote. Only invalid pixels change, and only to a fill >= 0;
    under 2 and 3 sentinels other than OCC and MIS stay as they are."""
    inval = disp < 0
    none = torch.full_like(disp, -1)
    if interpolate_type == 0:
        fill = torch.where(inval, rv, none)
    elif interpolate_type == 1:
        fill = torch.where(inval, bg, none)
    else:
        is_occ, is_mis = disp == disp_occ, disp == disp_mis
        if interpolate_type == 2:
            occ_fill = bg
        else:
            both = (bg >= 0) & (rv >= 0)
            occ_fill = torch.where(both, torch.minimum(rv, bg), torch.maximum(rv, bg))
        fill = torch.where(is_occ, occ_fill, torch.where(is_mis, rv, none))
    return torch.where(inval & (fill >= 0), fill, disp)


def rv_combine_bg(disp: torch.Tensor, arms: torch.Tensor, arms_tilt, image: torch.Tensor,
                  num_disp: int, s_thres: int = 15, h_ratio: float = 0.4,
                  interpolate_type: int = 0, reg_vote_type: int = 0, bg_depth: int = 1000,
                  bg_dirs: int = 2, disp_occ: int = -32, disp_mis: int = -48,
                  max_arm: int = 34) -> torch.Tensor:
    """RV_combine_BG (cpp:7146-7216): the invalid pixels filled by
    ``interpolate_type``'s policy (:func:`rv_bg_policy`) from the region
    vote of ``reg_vote_type`` (:func:`region_vote_core`; types 0, 2 and 3)
    and the background fill (types 1, 2 and 3) along two directions
    (:func:`bg_fill_2dir`) or four (``bg_dirs=4``, :func:`bg_fill_4dir`).
    Both read the map as it came in, as the reference reads a snapshot;
    sentinels other than OCC and MIS are left unchanged under types 2 and
    3 (the reference leaks the previous pixel's value into them)."""
    rv = bg = None
    if interpolate_type in (0, 2, 3):
        rv = region_vote_core(disp, arms, arms_tilt, num_disp, s_thres, h_ratio,
                              reg_vote_type, max_arm)
    if interpolate_type in (1, 2, 3):
        bg = (bg_fill_4dir(disp, image, bg_depth) if bg_dirs == 4
              else bg_fill_2dir(disp, bg_depth, num_disp)[0])
    return rv_bg_policy(disp, rv, bg, interpolate_type, disp_occ, disp_mis)


def fill_surrounding(disp: torch.Tensor, w_v: int, w_u: int,
                     disp_inv: int = -16) -> torch.Tensor:
    """fillSurronding (cpp:2214-2260): ``disp_inv`` on the w_v-row top and
    bottom and the w_u-column left and right bands (the census window's
    border)."""
    h, w = disp.shape
    v = torch.arange(h, device=disp.device)[:, None]
    u = torch.arange(w, device=disp.device)[None, :]
    border = (v < w_v) | (v >= h - w_v) | (u < w_u) | (u >= w - w_u)
    return torch.where(border, torch.full_like(disp, disp_inv), disp)


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


def bg_interpolation(disp: torch.Tensor, num_disp: int = 1024) -> torch.Tensor:
    """Horizontal nearest-valid fill of the invalid pixels of an int32
    [H, W] map, taking the smaller (background) disparity of the two sides
    where both exist (backgroundInterpolateCore cpp:7010-7044, search depth
    unbounded): :func:`bg_fill_2dir` over the whole row. The JAX package
    packs value and column into one int32 key for its TPU scan, which
    limits W * num_disp; this has no such limit, and ``num_disp`` is kept
    for the JAX signature."""
    fill, _ = bg_fill_2dir(disp, disp.shape[1], num_disp)
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


def _nearest_valid_scan(disp: torch.Tensor, valid: torch.Tensor, axis: int,
                        reverse: bool) -> torch.Tensor:
    """The value of the nearest ``valid`` pixel at or before each pixel
    along ``axis`` (at or after it with ``reverse``), -1 where there is
    none: a running max of the valid pixels' indices and a gather (the JAX
    ``_nearest_valid_scan``, which includes the pixel itself)."""
    x = disp.flip(axis) if reverse else disp
    v = valid.flip(axis) if reverse else valid
    n = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = n
    pos = torch.arange(n, dtype=torch.int64, device=x.device).reshape(shape)
    last = torch.where(v, pos, -1).cummax(axis).values
    out = torch.where(last >= 0, torch.gather(x, axis, last.clamp(min=0)),
                      torch.full_like(x, -1))
    return out.flip(axis) if reverse else out


def interpolate_background_kitti(disp: torch.Tensor, thres: int = 0) -> torch.Tensor:
    """iterpolateBackground (cpp:5864-5948), the KITTI-style filler: along
    each row an invalid run takes the smaller of its flanking valid
    disparities, and a run at a row's end the one valid side; then along
    each column the pixels above the first valid row take it, and those
    below the last valid row take that. Valid means ``disp > thres``: at
    the default threshold 0, disparity 0 counts as invalid."""
    valid = disp > thres
    left = _nearest_valid_scan(disp, valid, 1, False)
    right = _nearest_valid_scan(disp, valid, 1, True)
    both = (left >= 0) & (right >= 0)
    fill = torch.where(both, torch.minimum(left, right), torch.maximum(left, right))
    d = torch.where(valid | (fill < 0), disp, fill)
    valid2 = d > thres
    up = _nearest_valid_scan(d, valid2, 0, False)
    dn = _nearest_valid_scan(d, valid2, 0, True)
    top_fill = torch.where((up < 0) & (dn >= 0), dn, d)
    return torch.where((dn < 0) & (up >= 0), up, top_fill)


def wm_weight(cdis: torch.Tensor, dv: int, du: int, sigma_c: float = 25.0,
              sigma_s: float = 9.0) -> torch.Tensor:
    """The weighted median's weight exp(-cdis / sigma_c^2 - (dv^2 + du^2) /
    sigma_s^2) of a squared colour distance, as jitted XLA-CPU computes it:
    the division by the constant a product with its float32 reciprocal,
    contracted with the spatial term into one fused multiply-add, and the
    exp taken correctly rounded (``cost.exp32``; XLA's is within an ULP)."""
    spatial = (dv * dv + du * du) / (sigma_s * sigma_s)
    rec = float(np.float32(1.0) / np.float32(sigma_c * sigma_c))
    return exp32(fma32(-cdis, rec, -float(np.float32(spatial))))


def wm_color_distance(img: torch.Tensor, nc: torch.Tensor) -> torch.Tensor:
    """sum_c (img_c - nc_c)^2 over the channels of [C, H, W] images, as
    jitted XLA-CPU computes it: each square after the first added by a
    fused multiply-add."""
    diff = img - nc
    out = diff[0] * diff[0]
    for c in range(1, diff.shape[0]):
        out = fma32(diff[c], diff[c], out)
    return out


def weighted_median(disp: torch.Tensor, image: torch.Tensor, mask: torch.Tensor,
                    num_disp: int, radius: int = 9, sigma_c: float = 25.0,
                    sigma_s: float = 9.0) -> torch.Tensor:
    """The (2 radius + 1)^2 bilateral-weighted median (WM cpp:7340-7393): each
    neighbour's weight (:func:`wm_weight`) goes to its disparity's bin of
    a [D, H, W] histogram when that is one of 0..D-1, and to the total
    always, so the half-weight threshold counts invalid neighbours too (the
    reference's negative-index histogram writes are lost). The median is
    the first disparity whose cumulative weight reaches half the total,
    cumulated in XLA-CPU's blocked order (``cost.cumsum_blocked``). Pixels
    where ``mask`` holds take it. The weights add in the JAX package's
    order, one offset after another: a scatter-add a row of offsets, each
    adding at most one weight to a pixel's bins."""
    img = image.to(torch.float32).permute(2, 0, 1)                      # [C, H, W]
    h, w = disp.shape
    hist = torch.zeros((num_disp, h, w), dtype=torch.float32, device=disp.device)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=disp.device)
    for dv in range(-radius, radius + 1):
        for du in range(-radius, radius + 1):
            nd = shift2d(disp, dv, du, -1)
            wgt = wm_weight(wm_color_distance(img, shift2d(img, dv, du, 1e4)), dv, du,
                            sigma_c, sigma_s)
            wsum = wsum + wgt
            bin_ok = (nd >= 0) & (nd < num_disp)
            hist.scatter_add_(0, torch.where(bin_ok, nd, 0).to(torch.int64)[None],
                              torch.where(bin_ok, wgt, 0.0)[None])
    reached = cumsum_blocked(hist, 0) >= (wsum * 0.5)[None]
    med = reached.to(torch.uint8).argmax(0).to(disp.dtype)
    return torch.where(mask & reached.any(0), med, disp)


def cost_at_shifted(vol: torch.Tensor, d: torch.Tensor, dv: int, du: int) -> torch.Tensor:
    """vol[clip(d[v, u]), v + dv, u + du], +inf where (v + dv, u + du) is off
    the image: the neighbour's cost at the disparity ``d`` holds for it (the
    JAX ``cost_at_shifted``), gathered without a shifted copy of the
    volume."""
    nd, h, w = vol.shape
    v = torch.arange(h, device=vol.device)[:, None] + dv
    u = torch.arange(w, device=vol.device)[None, :] + du
    inside = (v >= 0) & (v < h) & (u >= 0) & (u < w)
    flat = (d.clamp(0, nd - 1).to(torch.int64) * h + v.clamp(0, h - 1)) * w + u.clamp(0, w - 1)
    got = vol.reshape(-1)[flat.reshape(-1)].reshape(h, w)
    return torch.where(inside, got, torch.full((), float("inf"), dtype=vol.dtype,
                                                   device=vol.device))


def discontinuity_adjust(disp: torch.Tensor, vol: torch.Tensor,
                         edges: torch.Tensor = None) -> torch.Tensor:
    """discontinuityAdjust (cpp:6057-6136): along the normal of a disparity
    edge, an edge pixel takes a neighbour's disparity where that
    neighbour's cost at its own disparity is lower than the pixel's.

    The edge direction, exclusive as written (cpp:6080-6099): main diagonal
    -> 4, anti-diagonal -> 0, else a top-row edge leaves only 6 (the bottom
    row must hit too), else left and right columns -> 2. Border pixels and
    invalid ones stay. The d1 neighbour counts where its cost is ``>= 0``
    and the d2 one where it is ``!= -1`` (cpp:6115-6130), verbatim. It reads
    a snapshot of the map (one Jacobi step of the reference's in-place
    scan), as the JAX package does. ``edges``: [H, W] bool, by default the
    equalised, Gaussian-blurred Canny of the map clipped to 0..255
    (cpp:6060-6064)."""
    if edges is None:
        from mystereomatching_tpu_torch.ops.canny import canny_edges

        edges = canny_edges(disp.clamp(0, 255).to(torch.uint8), low=20.0, high=60.0,
                            equalize=True, blur_sigma=4.0)
    nb = {(dv, du): shift2d(edges, dv, du, False) for dv in (-1, 0, 1) for du in (-1, 0, 1)}
    top_any = nb[(-1, 0)] | nb[(-1, -1)] | nb[(-1, 1)]
    bot_any = nb[(1, 0)] | nb[(1, -1)] | nb[(1, 1)]
    left_any = nb[(-1, -1)] | nb[(0, -1)] | nb[(1, -1)]
    right_any = nb[(-1, 1)] | nb[(0, 1)] | nb[(1, 1)]
    none = torch.full_like(disp, -1)
    dir_sel = torch.where(
        nb[(-1, -1)] & nb[(1, 1)], 4, torch.where(
            nb[(-1, 1)] & nb[(1, -1)], 0, torch.where(
                top_any & bot_any, 6, torch.where(~top_any & left_any & right_any, 2, none))))
    # (d1, d2) neighbour offsets of each direction (directionsH/W cpp:6069-6070)
    pairs = {4: ((-1, 1), (1, -1)), 0: ((-1, -1), (1, 1)),
             6: ((0, -1), (0, 1)), 2: ((-1, 0), (1, 0))}
    h, w = disp.shape
    vv = torch.arange(h, device=disp.device)[:, None]
    uu = torch.arange(w, device=disp.device)[None, :]
    inner = (vv >= 1) & (vv < h - 1) & (uu >= 1) & (uu < w - 1)
    cost0 = cost_at_shifted(vol, disp, 0, 0)
    minus1 = torch.full((), -1.0, dtype=vol.dtype, device=vol.device)
    out = disp
    for sel, ((dv1, du1), (dv2, du2)) in pairs.items():
        d1 = shift2d(disp, dv1, du1, -1)
        d2 = shift2d(disp, dv2, du2, -1)
        c1 = torch.where(d1 >= 0, cost_at_shifted(vol, d1, dv1, du1), minus1)
        c2 = torch.where(d2 >= 0, cost_at_shifted(vol, d2, dv2, du2), minus1)
        take1 = (c1 >= 0) & (c1 < cost0)
        best = torch.where(take1, d1, disp)
        bestc = torch.where(take1, c1, cost0)
        best = torch.where((c2 != -1.0) & (c2 < bestc), d2, best)
        out = torch.where(edges & inner & (dir_sel == sel) & (disp >= 0), best, out)
    return out
