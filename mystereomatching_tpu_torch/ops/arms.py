"""Cross-based support arms and arm-bounded 1-D sums.

Counterpart of ``mystereomatching_tpu/ops/arms.py``: ``cross_arms``,
``cross_arms_multilevel``, ``cross_arms_adaptive`` and ``build_arms`` (the
three ``cbca_arm_mode`` schedules, grown along the four axis directions or
the four tilted ones, ``TILT_DIRECTIONS``), ``_border_floor``,
``intersect_arms`` and its disparity-block form ``intersect_arms_block``,
the arm-bounded sums CBCA runs, the integer arm-bounded reductions (the
histogram region votes run their sums) and ``arm_bounded_sum_dir``, the
tilted vote's sum along a diagonal. Arm growth along the axes is CUDA
kernel A (``csrc/arms_grow.cu``), the arm-bounded sums are kernel B
(``csrc/arm_taps.cu``) and the integer reductions its integer mode
(``csrc/arm_reduce.cu``); their plain torch versions sit beside the
functions that dispatch to them. The tilted arms and the diagonal sums are
plain torch on every device, as they are plain jnp in the JAX package
(only the axis directions go to its Pallas kernel, arms.py:98).

Arm rule (calHorVerDis cpp:3009-3024): the arm in direction a reaches
length k iff for every j <= k, p + j a is inside the image,
max_c |I(p + j a) - I(p + (j-1) a)| <= neigh_thresh and
max_c |I(p + j a) - I(p)| <= sched[j-1]. The arm is then raised to
min(min_arm, distance to the border) (cpp:3030-3041).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops.volume import shifted_stack, valid_mask

# the reference's cross channel order (cpp:2976-2995): left, right, up, down
DIRECTIONS = ck.ARM_DIRECTIONS
# the tilted (45-degree) cross of calTileDis (cpp:3362-3381): left-up,
# right-down, right-up, left-down
TILT_DIRECTIONS = ((-1, -1), (1, 1), (-1, 1), (1, -1))

_PAD_FAIL = 10000.0  # off-image colour that fails every threshold


def _shift(img: torch.Tensor, dv: int, du: int, k: int, fill: float) -> torch.Tensor:
    """img[v + k dv, u + k du] of an [H, W, C] image, ``fill`` off-image."""
    h, w = img.shape[:2]
    ov, ou = dv * k, du * k
    out = torch.full_like(img, fill)
    if abs(ov) >= h or abs(ou) >= w:
        return out
    out[max(0, -ov): h - max(0, ov), max(0, -ou): w - max(0, ou)] = \
        img[max(0, ov): h - max(0, -ov), max(0, ou): w - max(0, -ou)]
    return out


def border_floor(h: int, w: int, dv: int, du: int, min_arm: int, device) -> torch.Tensor:
    """min(min_arm, distance to the border in direction (dv, du)), [H, W]."""
    v = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    big = torch.full((h, w), 1 << 30, dtype=torch.int32, device=device)
    dist_v = v if dv < 0 else (h - 1 - v if dv > 0 else big)
    dist_u = u if du < 0 else (w - 1 - u if du > 0 else big)
    return torch.clamp(torch.minimum(dist_v, dist_u), max=min_arm)


def grow_arms_plain(img: torch.Tensor, sched: Sequence[float],
                    neigh_thresh: float, min_arm: int, directions=DIRECTIONS) -> torch.Tensor:
    """Plain torch arm growth: [H, W, 3] -> int32 [len(directions), H, W],
    in the order of ``directions`` (L, R, U, D by default)."""
    img = img.to(torch.float32)
    h, w = img.shape[:2]
    arms = []
    for dv, du in directions:
        alive = torch.ones((h, w), dtype=torch.bool, device=img.device)
        arm = torch.zeros((h, w), dtype=torch.int32, device=img.device)
        prev = img
        for k in range(1, len(sched) + 1):
            cur = _shift(img, dv, du, k, _PAD_FAIL)
            anchor_ok = (cur - img).abs().amax(-1) <= sched[k - 1]
            chain_ok = (cur - prev).abs().amax(-1) <= neigh_thresh
            alive &= anchor_ok & chain_ok
            arm += alive.to(torch.int32)
            prev = cur
        arms.append(torch.maximum(arm, border_floor(h, w, dv, du, min_arm, img.device)))
    return torch.stack(arms)


def grow_arms(img: torch.Tensor, sched: Sequence[float], neigh_thresh: float,
              min_arm: int, directions=DIRECTIONS) -> torch.Tensor:
    """Cross arms of an [H, W, 3] image, int32 [4, H, W] in the order of
    ``directions``: the axis arms (L, R, U, D) through kernel A on the card,
    any other directions (``TILT_DIRECTIONS``) plain torch on every device."""
    img = img.to(torch.float32).contiguous()
    directions = tuple(map(tuple, directions))
    if directions == DIRECTIONS and ck.on_cuda(img):
        return ck.arms_grow(img, sched, neigh_thresh, min_arm)
    return grow_arms_plain(img, sched, neigh_thresh, min_arm, directions)


def two_level_schedule(l_in: int = 17, l_out: int = 34, c_in: int = 20,
                       c_out: int = 6) -> list:
    """The anchor thresholds of calHorVerDis (cpp:2959): c_in up to l_in,
    c_out beyond, to l_out steps."""
    return [float(c_in if k <= l_in else c_out) for k in range(1, l_out + 1)]


def multilevel_schedule(levels_l=(17, 23, 34), levels_t=(20, 30, 30)) -> list:
    """The anchor thresholds of the vector overload of calHorVerDis
    (cpp:3152-3253): threshold levels_t[n] while the step is at most
    levels_l[n], to levels_l[-1] steps."""
    sched = []
    for k in range(1, levels_l[-1] + 1):
        for ll, tt in zip(levels_l, levels_t):
            if k <= ll:
                sched.append(float(tt))
                break
    return sched


def adaptive_schedule(l_in: int = 17, l_out: int = 34, c_in: int = 20,
                      c_out: int = 6) -> list:
    """The anchor thresholds of calHorVerDis2 (cpp:3255-3349): within l_in
    the threshold decays with the step k, int(c_in - c_in / l_in * k + 10)
    (the C++ float expression truncated, cpp:3305), and is c_out beyond."""
    return [float(int(c_in - c_in / l_in * k + 10) if k <= l_in else c_out)
            for k in range(1, l_out + 1)]


def cross_arms(img: torch.Tensor, l_in: int = 17, l_out: int = 34,
               c_in: int = 20, c_out: int = 6, min_arm: int = 1,
               directions=DIRECTIONS) -> torch.Tensor:
    """Two-level arms: anchor threshold c_in up to l_in, c_out beyond."""
    return grow_arms(img, two_level_schedule(l_in, l_out, c_in, c_out), float(c_in), min_arm,
                     directions)


def cross_arms_multilevel(img: torch.Tensor, levels_l=(17, 23, 34), levels_t=(20, 30, 30),
                          neigh_thresh: int = 20, min_arm: int = 1,
                          directions=DIRECTIONS) -> torch.Tensor:
    """Multilevel arms (:func:`multilevel_schedule`), the neighbour
    threshold ``neigh_thresh`` (the vector overload hard-codes 20,
    cpp:3209)."""
    return grow_arms(img, multilevel_schedule(levels_l, levels_t), float(neigh_thresh),
                     min_arm, directions)


def cross_arms_adaptive(img: torch.Tensor, l_in: int = 17, l_out: int = 34,
                        c_in: int = 20, c_out: int = 6, min_arm: int = 1,
                        directions=DIRECTIONS) -> torch.Tensor:
    """Adaptive arms (:func:`adaptive_schedule`), the neighbour threshold
    c_in."""
    return grow_arms(img, adaptive_schedule(l_in, l_out, c_in, c_out), float(c_in), min_arm,
                     directions)


def arm_schedule(cfg):
    """(anchor schedule, neighbour threshold) of ``cfg.cbca_arm_mode``:
    ``"two_level"`` (calHorVerDis cpp:2959), ``"multilevel"`` (cpp:3152)
    or ``"adaptive"`` (calHorVerDis2 cpp:3255). The schedule's length is
    the longest arm, ``cfg.arm_l_out``."""
    if cfg.cbca_arm_mode == "multilevel":
        return (multilevel_schedule(cfg.cbca_cross_ls, cfg.cbca_c_threshes),
                float(cfg.cbca_ml_neigh_thresh))
    args = (cfg.cbca_cross_l, cfg.cbca_cross_l_out, cfg.cbca_c_thresh, cfg.cbca_c_thresh_out)
    if cfg.cbca_arm_mode == "adaptive":
        return adaptive_schedule(*args), float(cfg.cbca_c_thresh)
    return two_level_schedule(*args), float(cfg.cbca_c_thresh)


def build_arms(img: torch.Tensor, cfg, directions=DIRECTIONS) -> torch.Tensor:
    """The calArms family (cpp:5354-5472): the cross arms of ``img`` under
    ``cfg.cbca_arm_mode``'s schedule (:func:`arm_schedule`) along
    ``directions``: the axis arms through kernel A on the card, the tilted
    ones (``TILT_DIRECTIONS``) plain torch."""
    sched, neigh = arm_schedule(cfg)
    return grow_arms(img, sched, neigh, cfg.cbca_min_arm, directions)


def intersect_arms(arms_l: torch.Tensor, arms_r: torch.Tensor, num_disp: int,
                   lor: int) -> torch.Tensor:
    """Per-disparity arm intersection (genTrueHorVerArms, cpp:2794-2845).

    out[dir, d, v, u] = min(ref[dir, v, u], other[dir, v, u -/+ d]) with
    entries whose matching pixel is off-image set to 0. Arms are clamped
    to 127 and narrowed to int8. Returns [4, D, H, W] int8.
    """
    return intersect_arms_block(arms_l, arms_r,
                                torch.arange(num_disp, device=arms_l.device), lor)


def intersect_arms_block(arms_l: torch.Tensor, arms_r: torch.Tensor, ds: torch.Tensor,
                         lor: int) -> torch.Tensor:
    """:func:`intersect_arms` for the disparities of the int [Db] index
    ``ds`` (a block of the disparity-streamed volume): [4, Db, H, W] int8,
    each disparity's planes those of the dense intersection."""
    ref, oth = (arms_l, arms_r) if lor == 0 else (arms_r, arms_l)
    ref8 = torch.clamp(ref, max=127).to(torch.int8)
    oth8 = torch.clamp(oth, max=127).to(torch.int8)
    n = len(ds)
    sh = shifted_stack(oth8, n, lor, ds).transpose(0, 1)     # [4, Db, H, W]
    ok = valid_mask(arms_l.shape[-1], n, lor, arms_l.device, ds)
    out = torch.where(ok[None], torch.minimum(ref8[:, None], sh),
                      torch.zeros((), dtype=torch.int8, device=sh.device))
    return out.contiguous()


def arm_bounded_sum_plain(vol: torch.Tensor, arm_neg: torch.Tensor,
                          arm_pos: torch.Tensor, axis: int,
                          max_arm: int) -> torch.Tensor:
    """Plain torch arm-bounded sum of ``vol`` over [x - arm_neg, x + arm_pos]
    along ``axis``, with the arms capped at ``max_arm``.

    The taps are added in ascending offset from -max_arm to +max_arm,
    masked taps adding 0.0 — the JAX CPU path's order
    (``arms._arm_bounded_reduce_taps``), so the sums are bit-identical. Each
    add rounds in ``vol``'s dtype (float32 or bfloat16), as there.
    """
    n = vol.shape[axis]
    pad = [0, 0] * (vol.ndim - 1 - axis) + [max_arm, max_arm]
    padded = F.pad(vol, pad)
    out = torch.zeros_like(vol)
    for k in range(-max_arm, max_arm + 1):
        shifted = padded.narrow(axis, k + max_arm, n)
        mask = (k >= -arm_neg) & (k <= arm_pos)
        out = out + torch.where(mask, shifted, 0.0)
    return out


def arm_bounded_sum(vol: torch.Tensor, arm_neg: torch.Tensor,
                    arm_pos: torch.Tensor, axis: int, max_arm: int) -> torch.Tensor:
    """Arm-bounded sum of a [D, H, W] float32 or bfloat16 volume along H
    (axis 1) or W (axis 2); arms are int8 [D, H, W]."""
    if ck.on_cuda(vol):
        return ck.arm_taps(vol, arm_neg, arm_pos, axis, max_arm)
    return arm_bounded_sum_plain(vol, arm_neg, arm_pos, axis, max_arm)


def _area(arm_neg: torch.Tensor, arm_pos: torch.Tensor, max_arm: int,
          dtype: torch.dtype) -> torch.Tensor:
    """min(arm_neg, m) + min(arm_pos, m) + 1 in ``dtype``, counted in int32:
    int8 arms would wrap past 127 once max_arm exceeds 63. The count is at
    most 255, exact in bfloat16 too."""
    return (torch.clamp(arm_neg.to(torch.int32), max=max_arm)
            + torch.clamp(arm_pos.to(torch.int32), max=max_arm) + 1).to(dtype)


def arm_bounded_sum_area_plain(vol: torch.Tensor, an1: torch.Tensor,
                               ap1: torch.Tensor, arm_neg: torch.Tensor,
                               arm_pos: torch.Tensor, axis: int,
                               max_arm: int) -> torch.Tensor:
    """Plain torch CBCA second pass: the arm-bounded sums of ``vol`` and of
    the first pass's support count min(an1,m) + min(ap1,m) + 1, divided.
    Both sums round at each tap in ``vol``'s dtype; in bfloat16 the count's
    partial sums above 256 round too, as the JAX CPU path's do."""
    stacked = torch.stack([vol, _area(an1, ap1, max_arm, vol.dtype)])
    s = arm_bounded_sum_plain(stacked, arm_neg[None], arm_pos[None], axis + 1,
                              max_arm)
    return s[0] / torch.clamp(s[1], min=1.0)


def arm_bounded_sum_area(vol: torch.Tensor, an1: torch.Tensor, ap1: torch.Tensor,
                         arm_neg: torch.Tensor, arm_pos: torch.Tensor, axis: int,
                         max_arm: int) -> torch.Tensor:
    """CBCA's second pass along H (axis 1) or W (axis 2): sum / area, where
    an1/ap1 are the first pass's arms; all arms int8 [D, H, W]."""
    if ck.on_cuda(vol):
        return ck.arm_taps(vol, arm_neg, arm_pos, axis, max_arm, an1=an1, ap1=ap1)
    return arm_bounded_sum_area_plain(vol, an1, ap1, arm_neg, arm_pos, axis,
                                      max_arm)


_IDENTITY = {"sum": 0, "min": torch.iinfo(torch.int32).max,
             "max": torch.iinfo(torch.int32).min}
_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def arm_bounded_reduce_plain(vol: torch.Tensor, arm_neg: torch.Tensor,
                             arm_pos: torch.Tensor, axis: int, max_arm: int,
                             op: str) -> torch.Tensor:
    """Plain torch arm-bounded ``op`` ("sum", "min" or "max") of an int32
    [C, H, W] volume over [x - arm_neg, x + arm_pos] along H (axis 1) or W
    (axis 2); arms [H, W], shared by every channel, capped at ``max_arm``.

    The ascending-offset taps of the JAX ``_arm_bounded_reduce_taps``:
    padding and masked taps hold the op's identity (int32 max for min,
    int32 min for max, 0 for sum).
    """
    ident = _IDENTITY[op]
    combine = _COMBINE[op]
    n = vol.shape[axis]
    pad = [0, 0] * (vol.ndim - 1 - axis) + [max_arm, max_arm]
    padded = F.pad(vol, pad, value=ident)
    an, ap = arm_neg[None], arm_pos[None]
    fill = torch.full((), ident, dtype=vol.dtype, device=vol.device)
    out = torch.full_like(vol, ident)
    for k in range(-max_arm, max_arm + 1):
        shifted = padded.narrow(axis, k + max_arm, n)
        out = combine(out, torch.where((k >= -an) & (k <= ap), shifted, fill))
    return out


def arm_bounded_reduce(vol: torch.Tensor, arm_neg: torch.Tensor,
                       arm_pos: torch.Tensor, axis: int, max_arm: int,
                       op: str = "sum") -> torch.Tensor:
    """Arm-bounded ``op`` ("sum", "min" or "max") of an int32 [C, H, W]
    volume along H (axis 1) or W (axis 2), with int32 [H, W] arms shared by
    every channel (``arms.arm_bounded_reduce`` of the JAX package)."""
    if ck.on_cuda(vol):
        return ck.arm_reduce(vol, arm_neg, arm_pos, axis, max_arm, op)
    return arm_bounded_reduce_plain(vol, arm_neg, arm_pos, axis, max_arm, op)


def arm_bounded_sum_dir(vol: torch.Tensor, arm_neg: torch.Tensor, arm_pos: torch.Tensor,
                        step, max_arm: int = 34) -> torch.Tensor:
    """Arm-bounded sum of an int32 [C, H, W] volume along the 2-D step
    (dv, du) (the tilted supports, cal_histogram_for_Tile cpp:6864-6910):
    out[x] = sum over k in [-arm_neg[x], arm_pos[x]] of vol[x + k step],
    zero off the image; arms [H, W] (or broadcastable), bounded by
    ``max_arm`` taps each way. The JAX ``arm_bounded_sum_dir``'s taps in
    its order (integer sums, exact in any); plain torch on every device,
    as in the JAX package."""
    dv, du = step
    h, w = vol.shape[-2:]
    m = max_arm
    padded = F.pad(vol, (m, m, m, m))
    out = torch.zeros_like(vol)
    zero = torch.zeros((), dtype=vol.dtype, device=vol.device)
    for k in range(-m, m + 1):
        ov, ou = m + k * dv, m + k * du
        shifted = padded[..., ov:ov + h, ou:ou + w]
        out += torch.where((k >= -arm_neg) & (k <= arm_pos), shifted, zero)
    return out
