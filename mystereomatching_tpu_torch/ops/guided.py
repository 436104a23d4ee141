"""Guided-filter aggregation (GF): box means and the analytic 3x3 inverse.

Counterpart of ``mystereomatching_tpu/ops/guided.py`` (the reference's GF
path, stereoMatching.cpp:4404-4419, its gray ``guideFilterCore``
cpp:4919-4973 and colour ``guideFilterCore_matlab`` cpp:4975-5104). Every
box sum is ``cost._box_sum``, whose integral images add in the JAX
package's order, and every operation is the JAX function's, in its order,
so the filtered volumes equal those of the JAX functions run op by op. A
division by a constant divides by a 0-dim tensor (``cost._div``), so that a
CUDA tensor is divided and not multiplied by a reciprocal. The JAX module
has no Pallas kernel, so neither has this.
"""

from __future__ import annotations

import torch

from mystereomatching_tpu_torch.ops.cost import _box_sum, _div
from mystereomatching_tpu_torch.ops.volume import pad_reflect101


def _box_mean(x: torch.Tensor, r: int) -> torch.Tensor:
    """MATLAB-style truncated-window mean (cpp:5143-5208): the box sum over
    the image divided by the count of in-image pixels of the window."""
    n = _box_sum(torch.ones(x.shape[-2:], dtype=x.dtype, device=x.device), r, r)
    return _box_sum(x, r, r) / n


def _box_mean_cv(x: torch.Tensor, r: int) -> torch.Tensor:
    """cv::boxFilter(normalize=true) mean: reflect-101 border and the full
    (2r+1)^2 divisor (cpp:4951-4954)."""
    return _div(_box_sum(pad_reflect101(x, r), r, r)[..., r:-r, r:-r], float((2 * r + 1) ** 2))


def guided_filter_gray(p: torch.Tensor, guide: torch.Tensor, radius: int,
                       eps: float) -> torch.Tensor:
    """Gray-guide GF (guideFilterCore cpp:4919-4973) with cv::boxFilter
    means. p: [..., H, W], guide: [H, W]."""
    mean = _box_mean_cv
    i = guide
    mean_i = mean(i, radius)
    mean_p = mean(p, radius)
    corr_i = mean(i * i, radius)
    corr_ip = mean(i[None] * p if p.ndim == 3 else i * p, radius)
    var_i = corr_i - mean_i * mean_i
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return mean(a, radius) * i + mean(b, radius)


def guided_filter_color(p: torch.Tensor, guide: torch.Tensor, radius: int,
                        eps: float) -> torch.Tensor:
    """Colour-guide GF with the analytic 3x3 inverse (guideFilterCore_matlab
    cpp:4975-5104). p: [D, H, W]; guide: [H, W, 3] in [0, 1]."""
    chans = {c: guide[..., k] for k, c in enumerate("rgb")}
    mean_c = {c: _box_mean(chans[c], radius) for c in "rgb"}
    var = {}
    for a in "rgb":
        for b in "rgb":
            if a + b in var or b + a in var:
                continue
            var[a + b] = _box_mean(chans[a] * chans[b], radius) - mean_c[a] * mean_c[b]
    rr, gg, bb = var["rr"] + eps, var["gg"] + eps, var["bb"] + eps
    rg, rb, gb = var["rg"], var["rb"], var["gb"]
    # the inverse of [[rr, rg, rb], [rg, gg, gb], [rb, gb, bb]] by cofactors
    c00 = gg * bb - gb * gb
    c01 = gb * rb - rg * bb
    c02 = rg * gb - gg * rb
    c11 = rr * bb - rb * rb
    c12 = rb * rg - rr * gb
    c22 = rr * gg - rg * rg
    det = rr * c00 + rg * c01 + rb * c02
    inv = [[c00, c01, c02], [c01, c11, c12], [c02, c12, c22]]
    mean_p = _box_mean(p, radius)
    cov = [_box_mean(chans[c][None] * p, radius) - mean_c[c][None] * mean_p for c in "rgb"]
    a_ch = [sum(inv[k][j][None] * cov[j] for j in range(3)) / det[None] for k in range(3)]
    mr, mg, mb = (mean_c[c] for c in "rgb")
    b = mean_p - a_ch[0] * mr[None] - a_ch[1] * mg[None] - a_ch[2] * mb[None]
    return (_box_mean(a_ch[0], radius) * chans["r"][None]
            + _box_mean(a_ch[1], radius) * chans["g"][None]
            + _box_mean(a_ch[2], radius) * chans["b"][None]
            + _box_mean(b, radius))


def guided_filter_volume(vol: torch.Tensor, guide: torch.Tensor, radius: int = 9,
                         eps: float = 1e-4) -> torch.Tensor:
    """GF aggregation of a [D, H, W] cost volume (guideFilter cpp:4492-4516)
    at unit scale: the guide ([H, W] gray or [H, W, 3] RGB, 0..255) divided
    by 255 and eps by 255^2, which the filter's identity GF(I, eps) =
    GF(I / s, eps / s^2) allows, as in the JAX package."""
    g = _div(guide.to(torch.float32), 255.0)
    eps = eps / (255.0 * 255.0)
    if g.ndim == 3:
        return guided_filter_color(vol, g, radius, eps)
    return guided_filter_gray(vol, g, radius, eps)
