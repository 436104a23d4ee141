"""Edge detection: histogram equalisation, Gaussian blur, Canny.

Counterpart of ``mystereomatching_tpu/ops/canny.py``, the OpenCV calls of
the reference's DA and CBBI stages (equalizeHist + GaussianBlur + Canny,
stereoMatching.cpp:6059-6063 and execCanny h:2319-2327), in plain torch on
every device (the JAX module has no Pallas kernel). Hysteresis is a fixed
number of masked dilations. The float work rounds as jitted XLA-CPU
computes it: the blur's taps a chain of fused multiply-adds, the angle's
scaling one more; ``atan2`` is taken in float64 and rounded once, so that
the card and the CPU give the same bits (XLA's own float32 ``atan2`` is
within an ULP of it).
"""

from __future__ import annotations

import numpy as np
import torch

from mystereomatching_tpu_torch.ops.cost import fma32
from mystereomatching_tpu_torch.ops.volume import pad_reflect101


def equalize_hist(img: torch.Tensor) -> torch.Tensor:
    """cv::equalizeHist of a uint8 [H, W] image: each level mapped through
    round((cdf - cdf_min) / (n - cdf_min) * 255), clipped to 0..255, with
    cdf_min the count at the first level present."""
    x = img.to(torch.int64)
    hist = torch.bincount(x.reshape(-1), minlength=256)
    cdf = torch.cumsum(hist, 0)
    n = img.numel()
    cdf_min = torch.where(hist > 0, cdf, n + 1).amin()
    denom = torch.clamp(n - cdf_min, min=1)
    lut = torch.round((cdf - cdf_min).to(torch.float32) / denom.to(torch.float32) * 255.0)
    return lut.clamp(0, 255)[x].to(torch.uint8)


def _taps(xp: torch.Tensor, k: np.ndarray, n: int, axis: int) -> torch.Tensor:
    """sum_i k[i] x[i + j] along ``axis`` of the padded ``xp`` as jitted
    XLA-CPU computes the JAX package's ``sum(k[i] * x[i:...])``: the first
    tap fused onto the second's product, fma(k0, x0, k1 x1), then each later
    tap added by a fused multiply-add (the plain chain, from either end,
    differs from the jitted JAX function at 163-1,282 of 3,072 pixels)."""
    if len(k) == 1:
        return float(k[0]) * xp.narrow(axis, 0, n)
    out = fma32(float(k[0]), xp.narrow(axis, 0, n), float(k[1]) * xp.narrow(axis, 1, n))
    for i in range(2, len(k)):
        out = fma32(float(k[i]), xp.narrow(axis, i, n), out)
    return out


def gaussian_blur(img: torch.Tensor, ksize: int = 3, sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur of an [H, W] image, float32: along H, then W,
    each with reflect-101 borders (``jnp.pad(mode="reflect")``)."""
    r = ksize // 2
    xs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-xs * xs / (2 * sigma * sigma))      # float32 taps, as the JAX blur builds them
    k = k / k.sum()
    h, w = img.shape
    x = img.to(torch.float32)
    x = _taps(pad_reflect101(x, r)[:, r:r + w], k, h, 0)
    out = _taps(pad_reflect101(x, r)[r:r + h, :], k, w, 1)
    if len(k) == 3 and w > 1:
        # the first column, whose outer taps reflect-101 makes one element:
        # jitted XLA-CPU computes it as fma(k1, x0, p) + p, p = k0 x1 (the
        # other columns, the rows and the 7-tap blur as _taps)
        p = float(k[0]) * x[:, 1]
        out[:, 0] = fma32(float(k[1]), x[:, 0], p) + p
    return out


def _shift_edge(a: torch.Tensor, dv: int, du: int) -> torch.Tensor:
    """a[v + dv, u + du] with the border value repeated (pad mode "edge")."""
    h, w = a.shape
    v = (torch.arange(h, device=a.device) + dv).clamp(0, h - 1)
    u = (torch.arange(w, device=a.device) + du).clamp(0, w - 1)
    return a[v][:, u]


_DEG = float(np.float32(180 / np.pi))


def gradient_degrees(gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """The gradient's direction in degrees in [0, 180): jnp.mod(degrees(
    arctan2(gy, gx)) + 180, 180), with the degrees and the + 180 one fused
    multiply-add, as jitted XLA-CPU contracts them; the angle taken in
    float64 and rounded once to float32."""
    ang = torch.atan2(gy.to(torch.float64), gx.to(torch.float64)).to(torch.float32)
    x = fma32(ang, _DEG, 180.0)
    mod = torch.fmod(x, 180.0)       # jnp.mod: the truncated remainder, moved to [0, 180)
    return torch.where((mod != 0) & (mod < 0), mod + 180.0, mod)


def canny_edges(img: torch.Tensor, low: float = 20.0, high: float = 60.0,
                equalize: bool = False, blur_sigma: float = 0.0,
                hysteresis_iters: int = 8) -> torch.Tensor:
    """Simplified Canny of an [H, W] image -> bool edges: Sobel gradients
    (edge-replicated border), their L1 magnitude, non-maximum suppression
    along one of four direction bins, thresholds ``low`` and ``high``, and
    hysteresis as ``hysteresis_iters`` 8-neighbour dilations of the strong
    edges through the weak ones. ``equalize`` first equalises the image
    clipped to uint8; ``blur_sigma`` > 0 blurs it 3x3."""
    x = img
    if equalize:
        x = equalize_hist(x.clamp(0, 255).to(torch.uint8))
    x = x.to(torch.float32)
    if blur_sigma > 0:
        x = gaussian_blur(x, 3, blur_sigma)
    s = _shift_edge
    gx = (s(x, -1, 1) + 2 * s(x, 0, 1) + s(x, 1, 1)
          - s(x, -1, -1) - 2 * s(x, 0, -1) - s(x, 1, -1))
    gy = (s(x, 1, -1) + 2 * s(x, 1, 0) + s(x, 1, 1)
          - s(x, -1, -1) - 2 * s(x, -1, 0) - s(x, -1, 1))
    mag = gx.abs() + gy.abs()
    deg = gradient_degrees(gy, gx)
    b0 = (deg < 22.5) | (deg >= 157.5)
    b1 = (deg >= 22.5) & (deg < 67.5)
    b2 = (deg >= 67.5) & (deg < 112.5)
    n_a = torch.where(b0, s(mag, 0, 1), torch.where(b1, s(mag, -1, 1), torch.where(
        b2, s(mag, -1, 0), s(mag, -1, -1))))
    n_b = torch.where(b0, s(mag, 0, -1), torch.where(b1, s(mag, 1, -1), torch.where(
        b2, s(mag, 1, 0), s(mag, 1, 1))))
    keep = (mag >= n_a) & (mag >= n_b)
    strong = keep & (mag > high)
    weak = keep & (mag > low)
    e = strong
    for _ in range(hysteresis_iters):
        grown = e
        for dv in (-1, 0, 1):
            for du in (-1, 0, 1):
                grown = grown | s(e, dv, du)
        e = (weak & grown) | strong
    return e
