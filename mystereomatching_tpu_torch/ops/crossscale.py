"""Cross-scale cost aggregation (Zhang et al., CVPR 2014).

Counterpart of ``mystereomatching_tpu/ops/crossscale.py``: the Gaussian
pyramid of the reference's main program (main_.cpp:131-155, PY_LEV) and
``SolveAll`` (stereoMatching.cpp:2142-2208), which fuses the per-scale
cost volumes with the first row of the inverse of the tridiagonal
(1 + lambda) I - lambda coupling matrix, reading each coarser level at
(y / 2^s, x / 2^s, ceil(d / 2^s)). No kernel of its own: each level is
the pipeline's ``compute_volumes`` on the kernels, and the fusion is a
few gathers. The fused volume is float32 whatever the levels' dtype: the
JAX function's float32 weights promote a bfloat16 volume.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from mystereomatching_tpu_torch.ops.cost import fma32
from mystereomatching_tpu_torch.ops.volume import _reflect101_index

PYR_KERNEL = (0.0625, 0.25, 0.375, 0.25, 0.0625)  # [1, 4, 6, 4, 1] / 16, exact in float32


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown's shape of blur: the 5-tap [1, 4, 6, 4, 1] / 16 filter
    along H, then along W, each over a reflect-101 border, then every
    second row and column. img: [H, W] or [H, W, C]; float32, unrounded
    (the next level's gray conversion truncates it, as in the JAX
    package). The taps add in the JAX function's order."""
    x = img.to(torch.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    h, w = x.shape[:2]
    xp = x.index_select(0, _reflect101_index(h, 2, x.device))
    x = sum(PYR_KERNEL[i] * xp[i:i + h] for i in range(5))
    xp = x.index_select(1, _reflect101_index(w, 2, x.device))
    x = sum(PYR_KERNEL[i] * xp[:, i:i + w] for i in range(5))
    x = x[::2, ::2]
    return x[..., 0] if squeeze else x


def reg_inverse_weights(n_levels: int, reg_lambda: float = 0.3) -> np.ndarray:
    """The first row of the inverse of the regularisation matrix
    (cpp:2147-2168), in float64, returned as float32."""
    m = np.zeros((n_levels, n_levels), np.float64)
    for s in range(n_levels):
        m[s, s] = 1 + (reg_lambda if s in (0, n_levels - 1) else 2 * reg_lambda)
        if s > 0:
            m[s, s - 1] = -reg_lambda
        if s < n_levels - 1:
            m[s, s + 1] = -reg_lambda
    return np.linalg.inv(m)[0].astype(np.float32)


def solve_all(volumes: Sequence[torch.Tensor], reg_lambda: float = 0.3) -> torch.Tensor:
    """Cross-scale fusion at the finest level (SolveAll cpp:2142-2208):
    volumes are the per-level [D_s, H_s, W_s] cost volumes, level 0 the
    finest. Entry (d, y, x) is the sum of w_s times level s at the
    reference's index chain (y and x halved, d -> (d + 1) // 2 at each
    level, each clamped into the level), added level by level and rounded
    as jitted XLA-CPU contracts w_0 v_0 + w_1 v_1 + ...: the first two
    terms as fma(w_0, v_0, w_1 v_1), each later one fused into the sum
    (:func:`cost.fma32`; the JAX function op by op rounds every product).
    float32."""
    wgt = [float(w) for w in reg_inverse_weights(len(volumes), reg_lambda)]
    v0 = volumes[0].to(torch.float32)
    if len(volumes) == 1:
        return wgt[0] * v0
    d0, h0, w0 = v0.shape
    dev = v0.device
    cy = torch.arange(h0, device=dev)
    cx = torch.arange(w0, device=dev)
    cd = torch.arange(d0, device=dev)
    out = None
    for s in range(1, len(volumes)):
        cy, cx, cd = cy // 2, cx // 2, (cd + 1) // 2
        vs = volumes[s]
        dsz, hsz, wsz = vs.shape
        gathered = vs[cd.clamp(max=dsz - 1)][:, cy.clamp(max=hsz - 1)][:, :, cx.clamp(max=wsz - 1)]
        gathered = gathered.to(torch.float32)
        out = (fma32(wgt[0], v0, wgt[1] * gathered) if s == 1
               else fma32(wgt[s], gathered, out))
    return out


def levels(left: torch.Tensor, right: torch.Tensor, cfg, n_levels: int):
    """(left, right, cfg) of each pyramid level, finest first (the
    main_.cpp:135-155 loop): each level's images ``pyr_down``'ed from the
    one before and its max_disp halved (max_disp // 2 + 1, main_.cpp:152)."""
    lvl, rvl, c = left.to(torch.float32), right.to(torch.float32), cfg
    for s in range(n_levels):
        yield lvl, rvl, c
        if s + 1 < n_levels:
            lvl, rvl = pyr_down(lvl), pyr_down(rvl)
            c = c.replace(max_disp=c.max_disp // 2 + 1)


def build_pyramid_volumes(left: torch.Tensor, right: torch.Tensor, cfg, n_levels: int,
                          lor: int = 0) -> List[torch.Tensor]:
    """The per-level aggregated cost volumes of view ``lor``, each level's
    built by ``pipeline.level_volumes``."""
    from mystereomatching_tpu_torch.pipeline import level_volumes

    return [level_volumes(lvl, rvl, c)[lor] for lvl, rvl, c in levels(left, right, cfg, n_levels)]


def cross_scale_volume(left: torch.Tensor, right: torch.Tensor, cfg, n_levels: int = 2,
                       reg_lambda: float = 0.3, lor: int = 0) -> torch.Tensor:
    """The cross-scale aggregated volume of view ``lor`` at full resolution."""
    return solve_all(build_pyramid_volumes(left, right, cfg, n_levels, lor), reg_lambda)
