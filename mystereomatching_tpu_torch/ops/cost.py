"""Matching cost (L1): the [D, H, W] cost volumes of the ported costs.

Counterpart of every branch of ``mystereomatching_tpu/ops/cost.py``
(``central_gradient``, ``grad_volume`` in each of its modes, ``ad_volume``
with ``squared`` and ``normalize``, ``trunc_ad_volume``, ``_nei_max_min``,
``bt_volume``, ``exp_fuse2``, ``exp_fuse3``, ``fix_weight_fuse``,
``_box_sum``, ``zncc_volume``, ``ssd_volume``, ``census_from2_volume``
(:func:`census_from2_builder`),
``_qx_gray``, ``_qx_gradient``, ``qx_ad_grad_volume``,
``_census_code_fn``, ``compute_cost_volume``, ``block_cost_builder`` and
``grad_mag_phase_volume``).
Images are float32 in [0, 255]; off-image entries take each cost's
default. A division by a constant divides by a 0-dim tensor on the data's
device (:func:`_div`): a CUDA tensor divided by a Python number is
multiplied by its reciprocal instead, which rounds otherwise than the
CPU's division. The box sums of ZNCC, the box filter and the guided
filter (:func:`_box_sum`) take their integral images in XLA-CPU's order
of adds (:func:`cumsum_blocked`), never ``torch.cumsum``, whose order
differs on the CPU and again on the card. The JAX package has no Pallas
kernel here, so neither does this.

Four helpers round as jitted XLA-CPU does, on every device:
:func:`fma32` (XLA contracts ``c + a * b`` into one fused multiply-add,
also inside ``lax.scan`` bodies), :func:`mul_rec` (XLA divides by a
constant through the product with its float32 reciprocal),
:func:`exp32` (float32 ``exp`` taken in float64, subnormal results
flushed to zero as XLA-CPU flushes them) and :func:`_sqrt`. The costs
that came before them (``zncc``, ``exp_fuse2``, the adaptive gradient's
blend, the normalised census) round as the JAX functions do op by op;
the costs added with them (the normalised AD and one-direction gradient,
``census_from2``, ``exp_fuse3``) round as the jitted pipeline does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mystereomatching_tpu_torch.ops import census as census_ops
from mystereomatching_tpu_torch.ops.volume import shifted_stack, valid_mask


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once, on every device (see the module's note)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def mul_rec(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as jitted XLA-CPU computes a division by a constant: the
    product with the float32 reciprocal of float32(c), on every device."""
    rec = np.float32(1.0) / np.float32(c)
    return x * torch.full((), float(rec), dtype=x.dtype, device=x.device)


CUMSUM_BLOCK = 16  # the block of XLA-CPU's rewrite of a cumulative sum


def _scan_in_order(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum along the last axis, one add after another."""
    parts = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        parts.append(parts[-1] + x[..., i])
    return torch.stack(parts, -1)


def cumsum_blocked(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumulative sum along ``dim`` in the order of adds of
    ``jnp.cumsum`` on XLA-CPU, which lowers it to a ``reduce_window`` that it
    rewrites into a blocked scan: the axis padded with zeros to a multiple
    of 16, a running sum within each block of 16, the block totals scanned
    the same way (recursively; an axis of 16 or fewer is one block), their
    prefix shifted to exclusive and added to every element of its block.
    Every add is a plain IEEE add, so a CUDA tensor gets the same bits."""
    dim = dim % x.ndim
    xt = x.movedim(dim, -1)
    n = xt.shape[-1]
    if n <= CUMSUM_BLOCK:
        return _scan_in_order(xt).movedim(-1, dim)
    nb = -(-n // CUMSUM_BLOCK)
    xb = F.pad(xt, (0, nb * CUMSUM_BLOCK - n)).reshape(*xt.shape[:-1], nb, CUMSUM_BLOCK)
    inner = _scan_in_order(xb)
    prefix = cumsum_blocked(inner[..., -1], -1)
    exclusive = F.pad(prefix[..., :-1], (1, 0))
    out = (inner + exclusive[..., None]).reshape(*xt.shape[:-1], nb * CUMSUM_BLOCK)
    return out[..., :n].movedim(-1, dim)


def _box_sum(x: torch.Tensor, rv: int, ru: int, lo_v: Optional[int] = None,
             hi_v: Optional[int] = None, lo_u: Optional[int] = None,
             hi_u: Optional[int] = None) -> torch.Tensor:
    """Windowed sum of x [..., H, W] over dv in [lo_v, hi_v], du in [lo_u,
    hi_u] (the full +-r window by default), zero-padded: the four corners of
    the integral image of the padded x, cumulated along W then H
    (:func:`cumsum_blocked`), combined as the JAX package's ``_box_sum``
    combines them."""
    lo_v = -rv if lo_v is None else lo_v
    hi_v = rv if hi_v is None else hi_v
    lo_u = -ru if lo_u is None else lo_u
    hi_u = ru if hi_u is None else hi_u
    h, w = x.shape[-2:]
    xp = F.pad(x, (max(0, -lo_u), max(0, hi_u), max(0, -lo_v), max(0, hi_v)))
    cs = F.pad(cumsum_blocked(cumsum_blocked(xp, -1), -2), (1, 0, 1, 0))
    a = hi_v - lo_v + 1
    b = hi_u - lo_u + 1
    return (cs[..., a:a + h, b:b + w] - cs[..., a:a + h, :w]
            - cs[..., :h, b:b + w] + cs[..., :h, :w])


def zncc_volume(gray_l: torch.Tensor, gray_r: torch.Tensor, num_disp: int, lor: int,
                rv: int = 3, ru: int = 4) -> torch.Tensor:
    """ZNCC cost (gen_NCC_vm cpp:2419-2464, transform_NCCVm2): 1 - NCC, and
    1 where NCC < 0 or off the inner band, with the reference's window
    quirks as the JAX package has them: the means and the deviations over
    the full (2rv+1) x (2ru+1) window, the correlation over dv in [-rv, rv),
    du in [-ru, ru), the deviation sqrt(sum of squared deviations) without
    the area. Where rounding makes that sum negative (a flat window, or the
    integral image's rounding on a large picture) the deviation is NaN, and
    so is the cost there: the WTA takes the first NaN as the minimum, as
    ``jnp.argmin`` does."""
    gl = gray_l.to(torch.float32)
    gr = gray_r.to(torch.float32)
    area = (2 * rv + 1) * (2 * ru + 1)
    sum_l, sum_r = _box_sum(gl, rv, ru), _box_sum(gr, rv, ru)
    mean_l, mean_r = _div(sum_l, area), _div(sum_r, area)
    std_l = _sqrt(_box_sum(gl * gl, rv, ru) - 2 * mean_l * sum_l + area * mean_l * mean_l)
    std_r = _sqrt(_box_sum(gr * gr, rv, ru) - 2 * mean_r * sum_r + area * mean_r * mean_r)
    ref, oth = (gl, gr) if lor == 0 else (gr, gl)
    ref_mean, oth_mean = (mean_l, mean_r) if lor == 0 else (mean_r, mean_l)
    ref_std, oth_std = (std_l, std_r) if lor == 0 else (std_r, std_l)
    sh = shifted_stack(oth, num_disp, lor)
    sh_mean = shifted_stack(oth_mean, num_disp, lor)
    sh_std = shifted_stack(oth_std, num_disp, lor)

    def asym(x):
        return _box_sum(x, rv, ru, -rv, rv - 1, -ru, ru - 1)

    s_rr = asym(ref[None] * sh)
    s_r = asym(ref)[None]           # the same for every disparity
    s_s = asym(sh)
    a_area = (2 * rv) * (2 * ru)
    numer = (s_rr - ref_mean[None] * s_s - sh_mean * s_r
             + a_area * ref_mean[None] * sh_mean)
    ncc = numer / torch.maximum(ref_std[None] * sh_std,
                                torch.full((), 1e-12, device=numer.device))
    h, w = gl.shape
    dev = gl.device
    u = torch.arange(w, device=dev)[None, None, :]
    v = torch.arange(h, device=dev)[None, :, None]
    d = torch.arange(num_disp, device=dev)[:, None, None]
    inner = ((u - d >= ru) & (u < w - ru)) if lor == 0 else ((u + d < w - ru) & (u >= ru))
    inner = inner & (v >= rv) & (v < h - rv)
    ncc = torch.where(inner, ncc, -1.0)
    return torch.where(ncc < 0, 1.0, 1.0 - ncc)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, on every device: taken in
    float64 and rounded once more, which cannot round otherwise (float64
    holds more than twice float32's digits). torch's float32 sqrt on the
    CPU is off by an ULP on about 0.6% of inputs."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _f64(x):
    """x as a float64 operand: a tensor widened, a number rounded to float32
    first (the constant XLA sees) and then widened."""
    return x.to(torch.float64) if isinstance(x, torch.Tensor) else float(np.float32(x))


def fma32(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32: XLA-CPU's contraction of ``c + a *
    b`` into one fused multiply-add. The product of two float32 values is
    exact in float64, so only the sum rounds there, then once more to
    float32. Numbers are float32 constants; at least one operand is a
    tensor."""
    a64, b64, c64 = _f64(a), _f64(b), _f64(c)
    if all(isinstance(x, torch.Tensor) for x in (a64, b64, c64)):
        return torch.addcmul(c64, a64, b64).to(torch.float32)
    return (a64 * b64 + c64).to(torch.float32)


FLT_MIN = float(np.finfo(np.float32).tiny)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """x with its float32 subnormals set to 0, as XLA-CPU flushes them."""
    return torch.where(x.abs() < FLT_MIN, torch.zeros((), dtype=x.dtype, device=x.device), x)


def exp32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp of float32 x: taken in float64 and rounded once, so the
    card and the CPU give the same bits (their float32 ``exp`` differ), a
    subnormal result flushed to 0 (:func:`flush_subnormal`). XLA's own
    float32 ``exp`` is within one ULP of it."""
    return flush_subnormal(torch.exp(x.to(torch.float64)).to(torch.float32))


def ad_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int, lor: int,
              trunc: float = 1e9, squared: bool = False, normalize: bool = False,
              disps=None) -> torch.Tensor:
    """Mean over the channels of |dI| (dI^2 with ``squared``), truncated at
    ``trunc`` (gen_ad_sd_vm cpp:2468-2509). left/right: [H, W, C].
    Off-image entries take ``trunc``; with ``normalize`` the volume is
    divided by ``trunc`` (as the jitted JAX function divides: by the
    reciprocal, :func:`mul_rec`) and off-image entries take 1."""
    lc = left.to(torch.float32).permute(2, 0, 1)
    rc = right.to(torch.float32).permute(2, 0, 1)
    ref, oth = (lc, rc) if lor == 0 else (rc, lc)
    diff = torch.abs(ref[None] - shifted_stack(oth, num_disp, lor, disps))  # [D, C, H, W]
    if squared:
        diff = diff * diff
    total = diff[:, 0]
    for c in range(1, diff.shape[1]):
        total = total + diff[:, c]
    # the mean as jnp.mean computes it: XLA turns its division by the
    # constant count into a product with the count's float32 reciprocal
    vol = torch.clamp(total * (1.0 / diff.shape[1]), max=trunc)
    valid = valid_mask(left.shape[1], num_disp, lor, vol.device, disps)
    if normalize:
        return torch.where(valid, mul_rec(vol, trunc), 1.0)
    return torch.where(valid, vol, trunc)


def trunc_ad_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int, lor: int,
                    trunc: float = 60.0) -> torch.Tensor:
    """Truncated AD (gen_truncAD_vm cpp:2511-2551): the sum, not the mean,
    of the channels' |dI|, truncated at ``trunc``; off-image entries take
    ``trunc``. left/right: [H, W, C]."""
    lc = left.to(torch.float32).permute(2, 0, 1)
    rc = right.to(torch.float32).permute(2, 0, 1)
    ref, oth = (lc, rc) if lor == 0 else (rc, lc)
    diff = torch.abs(ref[None] - shifted_stack(oth, num_disp, lor))   # [D, C, H, W]
    total = diff[:, 0]
    for c in range(1, diff.shape[1]):
        total = total + diff[:, c]
    valid = valid_mask(left.shape[1], num_disp, lor, total.device)
    return torch.where(valid, torch.clamp(total, max=trunc), trunc)


def _nei_max_min(img: torch.Tensor):
    """(min, max) at each pixel of [..., W] over {I, (I + I_left) / 2,
    (I + I_right) / 2} with the reference's border quirks (calNeiMaxMin
    cpp:196-233): {I_0, avg(I_0, I_1)} at u = 0 and {avg(I_W-2, I_W-1),
    I_W-1} at u = W-1."""
    g = img.to(torch.float32)
    il = 0.5 * (torch.roll(g, 1, -1) + g)
    ir = 0.5 * (torch.roll(g, -1, -1) + g)
    mn = torch.minimum(g, torch.minimum(il, ir))
    mx = torch.maximum(g, torch.maximum(il, ir))
    first = 0.5 * (g[..., 0] + g[..., 1])
    last = 0.5 * (g[..., -2] + g[..., -1])
    mn[..., 0] = torch.minimum(g[..., 0], first)
    mx[..., 0] = torch.maximum(g[..., 0], first)
    mn[..., -1] = torch.minimum(last, g[..., -1])
    mx[..., -1] = torch.maximum(last, g[..., -1])
    return mn, mx


def bt_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int, lor: int,
              trunc: float = 20.0) -> torch.Tensor:
    """Birchfield-Tomasi cost (calCostForBT cpp:142-194): the channel mean
    of min(d(L->R), d(R->L)) against the other image's neighbour min/max,
    truncated at ``trunc``; off-image entries take ``trunc``. left/right:
    [H, W] gray (the pipeline's) or [H, W, C]."""
    if left.ndim == 2:
        left, right = left[..., None], right[..., None]
    lc = left.to(torch.float32).permute(2, 0, 1)       # [C, H, W]
    rc = right.to(torch.float32).permute(2, 0, 1)
    (lmin, lmax), (rmin, rmax) = _nei_max_min(lc), _nei_max_min(rc)
    ref, oth = (lc, rc) if lor == 0 else (rc, lc)
    ref_min, ref_max = (lmin, lmax) if lor == 0 else (rmin, rmax)
    oth_min, oth_max = (rmin, rmax) if lor == 0 else (lmin, lmax)
    sh = shifted_stack(oth, num_disp, lor)              # [D, C, H, W]
    sh_min = shifted_stack(oth_min, num_disp, lor)
    sh_max = shifted_stack(oth_max, num_disp, lor)
    zero = torch.zeros((), device=sh.device)
    v0 = torch.maximum(zero, torch.maximum(sh_min - ref[None], ref[None] - sh_max))
    v1 = torch.maximum(zero, torch.maximum(ref_min[None] - sh, sh - ref_max[None]))
    m = torch.minimum(v0, v1)
    total = m[:, 0]
    for c in range(1, m.shape[1]):
        total = total + m[:, c]
    # jnp.mean's division by the count, which is 1 for the pipeline's gray
    cost = torch.clamp(total * (1.0 / m.shape[1]), max=trunc)
    valid = valid_mask(left.shape[1], num_disp, lor, cost.device)
    return torch.where(valid, cost, trunc)


def central_gradient(img: torch.Tensor, axis: int) -> torch.Tensor:
    """0.5*(I[x+1]-I[x-1]) inside; one-sided differences at the borders."""
    g = img.to(torch.float32)
    grad = 0.5 * (torch.roll(g, -1, axis) - torch.roll(g, 1, axis))
    n = g.shape[axis]
    first = g.narrow(axis, 1, 1) - g.narrow(axis, 0, 1)
    last = g.narrow(axis, n - 1, 1) - g.narrow(axis, n - 2, 1)
    grad.narrow(axis, 0, 1).copy_(first)
    grad.narrow(axis, n - 1, 1).copy_(last)
    return grad


def grad_volume(gray_l: torch.Tensor, gray_r: torch.Tensor, num_disp: int,
                lor: int, trunc: float, arms: Optional[torch.Tensor] = None,
                grad_y_pair=None, disps=None, use_2dir: bool = True,
                adaptive_weight: bool = True, normalize: bool = False) -> torch.Tensor:
    """Gradient cost (grad() cpp:603-657 + calgradvm 388-466) of the
    central-difference gradients of the gray images, each difference
    truncated at ``trunc``. Two directions (``use_2dir``):
    a*min(|dGx|,T) + (1-a)*min(|dGy|,T) with a = shortestH / (shortestH +
    shortestV) from the reference image's cross arms [4, H, W]
    (``adaptive_weight``), else the sum min(|dGx|,T) + min(|dGy|,T)
    (cpp:455); off-image entries take sqrt(2 T^2), and, as in the JAX
    package, ``normalize`` does not apply. One direction: min(|dGx|,T),
    divided by T with ``normalize`` (by the reciprocal, as the jitted JAX
    function divides: :func:`mul_rec`), off-image entries T (1 normalised).
    ``arms`` is read by the adaptive form alone.

    ``grad_y_pair``: optional (gy_left, gy_right) y-gradients to use instead
    of the images' own: the row-band pipeline's, whose one-sided rows sit at
    the true picture borders, not at the band's edges. ``disps``: an int
    [Db] index of disparities, for a [Db, H, W] block of the volume."""

    def build(pair):
        ref, oth = (pair[0], pair[1]) if lor == 0 else (pair[1], pair[0])
        sh = shifted_stack(oth, num_disp, lor, disps)
        return torch.clamp(torch.abs(ref[None] - sh), max=trunc)

    valid = valid_mask(gray_l.shape[-1], num_disp, lor, gray_l.device, disps)
    cx = build((central_gradient(gray_l, 1), central_gradient(gray_r, 1)))
    if not use_2dir:
        if normalize:
            return torch.where(valid, mul_rec(cx, trunc), 1.0)
        return torch.where(valid, cx, trunc)
    gy = (grad_y_pair if grad_y_pair is not None
          else (central_gradient(gray_l, 0), central_gradient(gray_r, 0)))
    cy = build(gy)
    if adaptive_weight:
        if arms is None:
            raise ValueError("grad_volume: the adaptive weight needs the cross arms")
        short_h = torch.clamp(torch.minimum(arms[0], arms[1]), min=1).to(torch.float32)
        short_v = torch.clamp(torch.minimum(arms[2], arms[3]), min=1).to(torch.float32)
        a = short_h / (short_h + short_v)
        vol = a[None] * cx + (1.0 - a)[None] * cy
    else:
        vol = cx + cy
    return torch.where(valid, vol, math.sqrt(2.0 * trunc * trunc))


def fix_weight_fuse(vm0: torch.Tensor, w0: float, vm1: torch.Tensor,
                    w1: float) -> torch.Tensor:
    """w0*vm0 + w1*vm1 (gen_vm_from2vm_fixWgt cpp:3622-3645)."""
    return w0 * vm0 + w1 * vm1


def qx_gray(img: torch.Tensor) -> torch.Tensor:
    """The NL path's gray (qx rgb_2_gray, qx_basic.h:72) with its channel
    quirk: the reference feeds imread's BGR bytes, so the 0.299 weight
    lands on blue. uchar(0.299 b + 0.587 g + 0.114 r + 0.5) as the exact
    integer (299 b + 587 g + 114 r + 500) // 1000, float32 [H, W]; img: [H,
    W, 3] RGB. (The JAX package documents where this differs from the C
    double sum: on 0.1% of colour triples, which its golden budgets absorb.)"""
    r, g, b = (img[..., c].to(torch.int32) for c in range(3))
    return ((299 * b + 587 * g + 114 * r + 500) // 1000).to(torch.float32)


def qx_gradient(gray: torch.Tensor) -> torch.Tensor:
    """compute_gradient (qx_nonlocal_cost_aggregation.cpp:219-240): 0.5 (g[x+1]
    - g[x-1]) + 127.5 inside, the full one-sided difference + 127.5 at both
    borders."""
    interior = 0.5 * (gray[:, 2:] - gray[:, :-2]) + 127.5
    first = (gray[:, 1:2] - gray[:, 0:1]) + 127.5
    last = (gray[:, -1:] - gray[:, -2:-1]) + 127.5
    return torch.cat([first, interior, last], 1)


def qx_ad_grad_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int,
                      lor: int = 0, disps=None) -> torch.Tensor:
    """The standalone NL cost (matching_cost_from_color_and_gradient,
    qx_nonlocal_cost_aggregation.cpp:190-218): 0.11 min(mean |dRGB|, 7) +
    0.89 min(|d grad|, 2). Past the border the shifted image repeats its
    edge column (cpp:202-206), which is :func:`shifted_stack`'s clamp.
    lor=1 builds the right volume directly."""
    gl, gr = qx_gray(left), qx_gray(right)
    grad_l, grad_r = qx_gradient(gl), qx_gradient(gr)
    ref_img, oth_img = (left, right) if lor == 0 else (right, left)
    ref_grad, oth_grad = (grad_l, grad_r) if lor == 0 else (grad_r, grad_l)
    diff = torch.abs(ref_img.permute(2, 0, 1)[None]
                     - shifted_stack(oth_img.permute(2, 0, 1), num_disp, lor, disps))
    color = torch.clamp(_div(diff[:, 0] + diff[:, 1] + diff[:, 2], 3.0), max=7.0)
    grad = torch.clamp(torch.abs(ref_grad[None] - shifted_stack(oth_grad, num_disp, lor, disps)),
                       max=2.0)
    return 0.11 * color + 0.89 * grad


def exp_fuse2(vm0: torch.Tensor, vm1: torch.Tensor, lam0: float,
              lam1: float) -> torch.Tensor:
    """2 - exp(-vm0/lam0) - exp(-vm1/lam1) (gen_vm_from2vm_exp cpp:3566-3590)."""
    return 2.0 - torch.exp(-vm0 / lam0) - torch.exp(-vm1 / lam1)


def exp_fuse3(vm0: torch.Tensor, vm1: torch.Tensor, vm2: torch.Tensor, lam0: float,
              lam1: float, lam2: float) -> torch.Tensor:
    """3 - exp(-vm0/lam0) - exp(-vm1/lam1) - exp(-vm2/lam2)
    (gen_vm_from3vm_exp cpp:3592-3620), as the jitted JAX function rounds
    it: each division a product with the float32 reciprocal
    (:func:`mul_rec`), each ``exp`` :func:`exp32`, so the card and the CPU
    give the same bits (XLA's own ``exp`` is within an ULP of it)."""
    out = 3.0 - exp32(-mul_rec(vm0, lam0))
    out = out - exp32(-mul_rec(vm1, lam1))
    return out - exp32(-mul_rec(vm2, lam2))


def ssd_volume(gray_l: torch.Tensor, gray_r: torch.Tensor, num_disp: int, lor: int,
               rv: int = 3, ru: int = 4) -> torch.Tensor:
    """SSD (gen_ssd_vm cpp:2589-2638): the squared gray difference,
    truncated at 255^2 (off-image entries take it), summed over the
    (2rv+1) x (2ru+1) window by :func:`_box_sum`, whose integral images add
    in XLA-CPU's order."""
    sd = ad_volume(gray_l[..., None], gray_r[..., None], num_disp, lor, trunc=255.0 ** 2,
                   squared=True)
    return _box_sum(sd, rv, ru)


def grad_mag_phase_volume(gray_l: torch.Tensor, gray_r: torch.Tensor, num_disp: int,
                          lor: int, trunc_mag: float = 2.0, trunc_phase: float = 0.3,
                          w_phase: float = 0.5) -> torch.Tensor:
    """Gradient magnitude and phase cost (calgradvm_mag_and_phase /
    getAtanGrad, cpp:466-534): min(|mag_l - mag_r|, trunc_mag) + w_phase
    min(|phase_l - phase_r| wrapped to [0, pi], trunc_phase), of the
    central-difference gradients; off-image entries take trunc_mag +
    w_phase trunc_phase. The gradients are halves of integers, so gx^2 +
    gy^2 is exact and the magnitude is its correctly rounded root; the
    phase is atan2 in float64, rounded once."""
    def mag_phase(g):
        gx, gy = central_gradient(g, 1), central_gradient(g, 0)
        mag = _sqrt(gx * gx + gy * gy)
        phase = torch.atan2(gy.to(torch.float64), gx.to(torch.float64)).to(torch.float32)
        return mag, phase

    (mag_l, ph_l), (mag_r, ph_r) = mag_phase(gray_l), mag_phase(gray_r)
    ref_m, oth_m = (mag_l, mag_r) if lor == 0 else (mag_r, mag_l)
    ref_p, oth_p = (ph_l, ph_r) if lor == 0 else (ph_r, ph_l)
    dm = torch.clamp(torch.abs(ref_m[None] - shifted_stack(oth_m, num_disp, lor)),
                     max=trunc_mag)
    dp = torch.abs(ref_p[None] - shifted_stack(oth_p, num_disp, lor))
    dp = torch.clamp(torch.minimum(dp, float(np.float32(2 * math.pi)) - dp), max=trunc_phase)
    valid = valid_mask(gray_l.shape[-1], num_disp, lor, gray_l.device)
    return torch.where(valid, dm + w_phase * dp, trunc_mag + w_phase * trunc_phase)


def _census_code_fn(func: int, rv: int, ru: int):
    """censusFunc (h:244) -> (code builder, code length in bits): 0
    classic, 1 and 2 the neighbour walks, 3 classic + 8 surround pairs
    (the default), 4 symmetric, 5 mean census."""
    win = (2 * rv + 1) * (2 * ru + 1)
    return {
        0: (lambda g: census_ops.census_code_classic(g, rv, ru), win),
        1: (lambda g: census_ops.census_code_neighbor(g, rv, ru, 1),
            census_ops.neigh_code_length(rv, ru, 1)),
        2: (lambda g: census_ops.census_code_neighbor(g, rv, ru, 2),
            census_ops.neigh_code_length(rv, ru, 2)),
        3: (lambda g: census_ops.census_code_ncsur(g, rv, ru), win + 8),
        4: (lambda g: census_ops.census_code_symmetric(g, rv, ru), win),
        5: (lambda g: census_ops.census_code_mean(g, rv, ru), win),
    }[func]


def _hamming_normalized(code_l: torch.Tensor, code_r: torch.Tensor, num_disp: int,
                        lor: int, code_length: int, trunc_ratio: float, disps=None):
    """The normalised Hamming volume as the jitted JAX ``hamming_volume``
    rounds it: min(hamming, L) times the float32 reciprocal of L =
    code_length * trunc_ratio (:func:`mul_rec`), 1 off-image.
    ``census_ops.hamming_volume(normalize=True)`` divides, as the JAX
    function does op by op."""
    cost = census_ops.hamming_volume(code_l, code_r, num_disp, lor, code_length,
                                     trunc_ratio, False, disps)
    valid = valid_mask(code_l.shape[-1], num_disp, lor, cost.device, disps)
    return torch.where(valid, mul_rec(cost, code_length * trunc_ratio), 1.0)


def census_from2_builder(gray_l: torch.Tensor, gray_r: torch.Tensor, cfg,
                         lor: int) -> Callable:
    """The two-window census blend (gen_cenVM_XOR_From2Code(_tem),
    h:983-1142) as ``block(ds) -> [Db, H, W]``, the codes built once, here.
    ``census_from2_blend="first"``: the truncated, normalised Hamming cost
    of the first window; ``"grad"``: (1 - a) c0 + a c1 of the two windows'
    untruncated normalised costs, a = 1 - exp(-0.1 / (g + 1)) of the
    reference image's x-gradient g, the blend one fused multiply-add as
    jitted XLA-CPU computes it. Off-image entries take 1."""
    nd = cfg.num_disp
    fn0, n0 = _census_code_fn(cfg.census_func, cfg.census_rv, cfg.census_ru)
    c0_codes = fn0(gray_l), fn0(gray_r)
    if cfg.census_from2_blend == "first":
        return lambda ds: _hamming_normalized(*c0_codes, nd, lor, n0, cfg.census_trunc_ratio, ds)
    fn1, n1 = _census_code_fn(cfg.census_func, cfg.census_rv2, cfg.census_ru2)
    c1_codes = fn1(gray_l), fn1(gray_r)
    g = central_gradient(gray_l if lor == 0 else gray_r, 1)
    a = 1.0 - exp32(-0.1 / (g + 1.0))

    def blend(ds) -> torch.Tensor:
        c0 = _hamming_normalized(*c0_codes, nd, lor, n0, 1.0, ds)
        c1 = _hamming_normalized(*c1_codes, nd, lor, n1, 1.0, ds)
        return fma32((1.0 - a)[None], c0, a[None] * c1)

    return blend


# the costs of block_cost_builder, which the disparity-streaming path builds on
BLOCK_COSTS = ("census", "census_grad", "ad_grad", "ad_census", "ad", "sd", "grad",
               "census_from2", "ad_census_grad")


def compute_cost_volume(left: torch.Tensor, right: torch.Tensor,
                        gray_l: torch.Tensor, gray_r: torch.Tensor, cfg,
                        lor: int, arms: Optional[torch.Tensor] = None,
                        grad_y_pair=None) -> torch.Tensor:
    """The cost volume of ``cfg.cost`` (costCalculate, cpp:945-1021): the
    costs of :func:`block_cost_builder` (``BLOCK_COSTS``), ``zncc``
    (:func:`zncc_volume`), ``ssd`` (:func:`ssd_volume`), ``ad_census_zncc``
    (exp fusion of census, ZNCC and untruncated AD, lambdas ``lam_cen``, 1
    and 10), ``trunc_ad`` (:func:`trunc_ad_volume`), ``bt``
    (:func:`bt_volume` on the gray images, truncated at ``bt_trunc``), or
    the NL flow's ``qx_ad_grad`` (left volume only, as in the JAX package)
    and ``qx_census`` (the 80-bit 9x9 census). ``grad_y_pair`` goes to
    :func:`grad_volume`."""
    nd = cfg.num_disp
    if cfg.cost == "qx_ad_grad":
        if lor != 0:
            raise NotImplementedError(
                "qx_ad_grad is left-volume only; the NL flow flips the left volume "
                "(ops/nl.flip_corr_vol) as the reference does")
        return qx_ad_grad_volume(left, right, nd)
    if cfg.cost == "zncc":
        return zncc_volume(gray_l, gray_r, nd, lor, cfg.zncc_win_rv, cfg.zncc_win_ru)
    if cfg.cost == "ssd":
        return ssd_volume(gray_l, gray_r, nd, lor, cfg.ssd_win_rv, cfg.ssd_win_ru)
    if cfg.cost == "ad_census_zncc":
        census = block_cost_builder(left, right, gray_l, gray_r, cfg.replace(cost="census"),
                                    lor)(None)
        zvm = zncc_volume(gray_l, gray_r, nd, lor, cfg.zncc_win_rv, cfg.zncc_win_ru)
        return exp_fuse3(census, zvm, ad_volume(left, right, nd, lor, trunc=1e9),
                         cfg.lam_cen, 1.0, 10.0)
    if cfg.cost == "trunc_ad":
        return trunc_ad_volume(left, right, nd, lor)
    if cfg.cost == "bt":
        return bt_volume(gray_l, gray_r, nd, lor, cfg.bt_trunc)
    if cfg.cost == "qx_census":
        return census_ops.hamming_volume(census_ops.census_code_qx80(left),
                                         census_ops.census_code_qx80(right), nd, lor, 80)
    return block_cost_builder(left, right, gray_l, gray_r, cfg, lor, arms,
                              grad_y_pair)(None)


def block_cost_builder(left: torch.Tensor, right: torch.Tensor,
                       gray_l: torch.Tensor, gray_r: torch.Tensor, cfg,
                       lor: int, arms: Optional[torch.Tensor] = None,
                       grad_y_pair=None) -> Callable:
    """The disparity-streaming form of :func:`compute_cost_volume`: returns
    ``block(ds) -> [Db, H, W]`` float32, the cost of the disparities in the
    int [Db] index ``ds`` (None: all of them), each plane the dense
    volume's bit for bit, for the costs of ``BLOCK_COSTS``: ``ad`` and
    ``sd`` (untruncated channel means of |dI| and dI^2), ``grad``
    (:func:`grad_volume` at ``grad_trunc`` in the configured mode),
    ``census`` (the Hamming volume of the ``census_func`` code),
    ``census_from2`` (:func:`census_from2_builder`), ``census_grad``
    (cpp:25-48, exp fusion of census and the gradient), ``ad_grad``
    (cpp:50-70, AD truncated at ``ad_trunc`` and the gradient truncated at
    2, not normalised, weighted 0.11 / 0.89), ``ad_census`` (cpp:5250-5277,
    exp fusion of census, lambda 30, and untruncated AD, lambda 10) and
    ``ad_census_grad`` (exp fusion of census, the gradient and untruncated
    AD, lambdas ``lam_cen``, ``lam_g`` and 10). The census codes, which do
    not depend on the disparity, are computed once, here. Every other cost
    raises NotImplementedError naming it."""
    method = cfg.cost
    if method not in BLOCK_COSTS:
        raise NotImplementedError(f"cost {method!r} has no block form in this package")
    nd = cfg.num_disp
    if method == "census_from2":
        return census_from2_builder(gray_l, gray_r, cfg, lor)

    def ad(ds, trunc=1e9, squared=False):
        return ad_volume(left, right, nd, lor, trunc=trunc, squared=squared, disps=ds)

    def grad(ds, trunc, normalize):
        return grad_volume(gray_l, gray_r, nd, lor, trunc, arms, grad_y_pair, ds,
                           cfg.grad_use_2dir, cfg.grad_fuse_adaptive, normalize)

    if method in ("ad", "sd"):
        return lambda ds: ad(ds, squared=method == "sd")
    if method == "grad":
        return lambda ds: grad(ds, cfg.grad_trunc, cfg.is_grad_norm)
    if method == "ad_grad":
        return lambda ds: fix_weight_fuse(ad(ds, cfg.ad_trunc), 0.11, grad(ds, 2.0, False), 0.89)
    code_fn, n_bits = _census_code_fn(cfg.census_func, cfg.census_rv, cfg.census_ru)
    code_l, code_r = code_fn(gray_l), code_fn(gray_r)

    def census(ds) -> torch.Tensor:
        return census_ops.hamming_volume(code_l, code_r, nd, lor, n_bits,
                                         cfg.census_trunc_ratio, cfg.is_census_norm, ds)

    if method == "census":
        return census
    if method == "ad_census":
        return lambda ds: exp_fuse2(census(ds), ad(ds), 30.0, 10.0)
    if method == "ad_census_grad":
        return lambda ds: exp_fuse3(census(ds), grad(ds, cfg.grad_trunc, cfg.is_grad_norm),
                                    ad(ds), cfg.lam_cen, cfg.lam_g, 10.0)
    return lambda ds: exp_fuse2(census(ds), grad(ds, cfg.grad_trunc, cfg.is_grad_norm),
                                cfg.lam_cen, cfg.lam_g)
