"""AWS: adaptive support-weight aggregation (Yoon & Kweon), and the joint
bilateral filter (JBF).

Counterpart of ``mystereomatching_tpu/ops/aws.py`` (the reference's AWS,
stereoMatching.cpp:5692-5801, calvm_AWS h:1305-1350, genWeight_AWS
h:1472-1493, calW4_AWS h:1533-1548; JBF_STANDARD cpp:5738-5767). AWS
weighs each pixel of a 35x35 window by exp(-dLab / 5) in both views, the
L channel scaled by 100/255, and normalises; JBF weighs by colour and
distance in one view. As in the JAX package, a walk over the window's
offsets accumulates numerator and denominator volumes, each offset one
dense multiply-add over [D, H, W], in the JAX offset order, with
``numer + w * C`` as one fused multiply-add (``cost.fma32``) as the jitted
``lax.scan`` body computes it.

The Lab image (:func:`rgb_to_lab`) rounds as jitted XLA-CPU computes it:
its constants folded as XLA folds them, its fused multiply-adds, and its
``cbrt``, which is pow(|x|, float32(1/3)) with the sign put back, taken
here in float64 and rounded. Over all 2^24 colours it differs from JAX's
at 2 (Lab channel off by one level). The weights take ``cost.exp32``:
within one ULP of JAX's and equal on the card and the CPU. The JAX module
has no Pallas kernel, so neither has this.
"""

from __future__ import annotations

import numpy as np
import torch

from mystereomatching_tpu_torch.ops.cost import _sqrt, exp32, fma32
from mystereomatching_tpu_torch.ops.volume import pad_reflect101, shifted_stack, valid_mask

_f32 = np.float32
_INV255 = float(_f32(1.0) / _f32(255.0))
_THIRD = float(_f32(1.0) / _f32(3.0))
_XN = _f32(1.0) / _f32(0.950456)    # x / Xn as XLA folds it: times the reciprocal
_ZN = _f32(1.0) / _f32(1.088754)
_K16 = float(_f32(16.0) / _f32(116.0))
_XYZ = ((0.412453, 0.357580, 0.180423), (0.212671, 0.715160, 0.072169),
        (0.019334, 0.119193, 0.950227))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's float32 cbrt: pow(|x|, float32(1/3)) with x's sign."""
    return torch.sign(x) * torch.pow(x.abs().to(torch.float64), _THIRD).to(torch.float32)


def rgb_to_lab(img: torch.Tensor) -> torch.Tensor:
    """sRGB [0, 255] [H, W, 3] -> Lab with OpenCV's 8-bit scaling (L * 255
    / 100, a + 128, b + 128), rounded half to even and clipped to [0, 255]
    as the reference's uint8 Lab, float32 [H, W, 3]."""
    img = img.to(torch.float32)
    rgb = img * _INV255
    lin = torch.where(
        rgb > 0.04045,
        torch.pow(((rgb + 0.055) * float(_f32(1.0) / _f32(1.055))).to(torch.float64),
                  float(_f32(2.4))).to(torch.float32),
        img * float(_f32(_INV255) * (_f32(1.0) / _f32(12.92))))
    r, g, b = lin.unbind(-1)

    def mix(k):
        c0, c1, c2 = _XYZ[k]
        return fma32(b, c2, fma32(r, c0, g * float(_f32(c1))))

    xs, y, zs = mix(0), mix(1), mix(2)
    x, z = xs * float(_XN), zs * float(_ZN)
    thr = 0.008856

    def f(t, lin_sum, k):
        return torch.where(t > thr, _cbrt(t), fma32(lin_sum, k, _K16))

    fx = f(x, xs, _f32(7.787) * _XN)
    fy = f(y, y, 7.787)
    fz = f(z, zs, _f32(7.787) * _ZN)
    l_ = torch.where(y > thr, fma32(_cbrt(y), 116.0, -16.0), y * 903.3)
    lab = torch.stack([l_ * float(_f32(255.0) / _f32(100.0)),
                       fma32(fx - fy, 500.0, 128.0), fma32(fy - fz, 200.0, 128.0)], -1)
    return torch.clamp(torch.round(lab), 0.0, 255.0)


def _lab_weight(center: torch.Tensor, neigh: torch.Tensor, gamma: float) -> torch.Tensor:
    """exp(-||dLab|| / gamma) with (100/255)^2 on the L term (h:1538-1542):
    the squared distance summed with XLA-CPU's fused multiply-adds, the
    division by gamma a product with its float32 reciprocal."""
    d = center - neigh
    s = fma32(d[..., 2], d[..., 2], fma32(d[..., 0] * d[..., 0], 0.153787, d[..., 1] * d[..., 1]))
    return exp32(_sqrt(s) * -float(_f32(1.0) / _f32(gamma)))


def _pad_image(img: torch.Tensor, r: int) -> torch.Tensor:
    """[H, W, C] padded by r on both spatial axes with reflect-101."""
    return pad_reflect101(img.permute(2, 0, 1), r).permute(1, 2, 0)


def _offsets(r: int):
    return [(dv, du) for dv in range(-r, r + 1) for du in range(-r, r + 1)]


def _row_weights(lab: torch.Tensor, lab_pad: torch.Tensor, dv: int, r: int,
                 gamma: float) -> torch.Tensor:
    """[2r+1, H, W] weights of the offsets (dv, -r .. r) of a window row, in
    one batch of launches (element for element the weights of
    :func:`_lab_weight` taken an offset at a time)."""
    h, w = lab.shape[:2]
    neigh = lab_pad[dv + r:dv + r + h].unfold(1, w, 1)      # [H, 2r+1, 3, W]
    return _lab_weight(lab[None], neigh.permute(1, 0, 3, 2), gamma)


def aws_aggregate(vol: torch.Tensor, image_left: torch.Tensor, cfg,
                  image_right=None, lor: int = 0) -> torch.Tensor:
    """Joint-bilateral AWS aggregation of a float32 [D, H, W] volume: at
    each offset the reference view's weight at the pixel times the other
    view's at the matched pixel (u - d for the left volume, u + d for the
    right; calvm_AWS h:1326-1336), or the left image's alone without
    ``image_right``. Window radius ``cfg.aws_win``, reflect-101 borders;
    numer / max(denom, 1e-12), the raw cost kept where the matched pixel
    is off the image. The weights of a window row are computed together;
    the volumes accumulate an offset at a time, in the JAX order."""
    r, gamma = cfg.aws_win, cfg.aws_gamma
    d_, h, w = vol.shape
    lab_l = rgb_to_lab(image_left)
    lab_r = rgb_to_lab(image_right) if image_right is not None else None
    lab_l_pad = _pad_image(lab_l, r)
    lab_r_pad = _pad_image(lab_r, r) if lab_r is not None else None
    vol_pad = pad_reflect101(vol, r).to(torch.float64)   # widened once for fma32
    numer, denom = vol * 0.0, vol * 0.0
    for dv in range(-r, r + 1):
        w_l = _row_weights(lab_l, lab_l_pad, dv, r, gamma)
        w_r = _row_weights(lab_r, lab_r_pad, dv, r, gamma) if lab_r is not None else None
        for k in range(2 * r + 1):
            if w_r is not None:
                w_ref, w_oth = (w_l[k], w_r[k]) if lor == 0 else (w_r[k], w_l[k])
                ele = w_ref[None] * shifted_stack(w_oth, d_, lor)
            else:
                ele = w_l[k][None].expand(d_, h, w)
            numer = fma32(ele, vol_pad[:, dv + r:dv + r + h, k:k + w], numer)
            denom = denom + ele
    out = numer / torch.clamp(denom, min=1e-12)
    return torch.where(valid_mask(w, d_, lor, vol.device), out, vol)


def jbf_volume(vol: torch.Tensor, image: torch.Tensor, radius: int = 9,
               sigma_c: float = 25.0, sigma_s: float = 9.0) -> torch.Tensor:
    """Joint bilateral filter of each disparity plane of a float32 [D, H,
    W] volume guided by the [H, W, 3] image (cv::ximgproc::
    jointBilateralFilter, cpp:5738-5767): w = exp(-||dI||^2 / 2 sigma_c^2)
    exp(-||dp||^2 / 2 sigma_s^2), reflect-101 borders, normalised."""
    d_, h, w = vol.shape
    r = radius
    img = image.to(torch.float32)
    img_pad = _pad_image(img, r)
    vol_pad = pad_reflect101(vol, r)
    offs = np.array(_offsets(r), np.float64)
    w_sp = np.exp(-np.sum(offs ** 2, axis=1) / (2.0 * sigma_s ** 2)).astype(np.float32)
    inv_c = float(_f32(1.0) / _f32(2.0 * sigma_c ** 2))
    numer, denom = vol * 0.0, vol[0] * 0.0
    for (dv, du), ws in zip(_offsets(r), w_sp):
        rows, cols = slice(dv + r, dv + r + h), slice(du + r, du + r + w)
        dc = img - img_pad[rows, cols]
        dc = (dc * dc).sum(-1)
        wgt = float(ws) * exp32(dc * -inv_c)
        numer = fma32(wgt[None], vol_pad[:, rows, cols], numer)
        denom = denom + wgt
    return numer / torch.clamp(denom[None], min=1e-12)
