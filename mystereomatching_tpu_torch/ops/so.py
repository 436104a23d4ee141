"""Scanline optimisation (SO): a 1-D Viterbi DP along each row, then its
backtrace.

Counterpart of ``mystereomatching_tpu/ops/so.py`` (the reference's ``so``,
stereoMatching.cpp:6272-6416, ``so_R2L`` cpp:6683-6828, ``so_T2D``
cpp:6580-6681 and ``so_change`` cpp:6419-6578). The forward pass walks the
columns, carrying the accumulated [D, H] cost plane and keeping each
column's choice of predecessor; the backtrace walks back through those
choices with one gather a column. At each column

    A(u, d) = C(u, d) + min(A(u-1, d), A(u-1, d-1) + Pn2, A(u-1, d+1) + Pn2,
                            min_d' A(u-1, d') + Pn3)

taken in that order of priority with strict ``<``, the global minimum at
its first argmin; Pn2 and Pn3 are halved where the channel mean of |dI|
between u and u-1 of the guiding image exceeds ``so_dif_thres``. Every
step is a compare, a select or one IEEE add, so the card gives the CPU's
bits. The JAX module has no Pallas kernel, so neither has this: the two
walks are a few plain torch launches a column.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BIG = 3.4e38  # the DP's "no predecessor" cost, as in the JAX package


def discontinuities(img: torch.Tensor, thres: float) -> torch.Tensor:
    """[H, W] bool: the mean over the channels of |I(v, u) - I(v, u-1)|
    (wrapping at u = 0) above ``thres``. The mean is jitted ``jnp.mean``'s:
    the channel sum times the float32 reciprocal of the count."""
    diff = torch.abs(img - torch.roll(img, 1, 1))
    total = diff[..., 0]
    for c in range(1, diff.shape[-1]):
        total = total + diff[..., c]
    return total * float(np.float32(1.0) / np.float32(diff.shape[-1])) > thres


def _backtrace(acc_last: torch.Tensor, traces: torch.Tensor) -> torch.Tensor:
    """int32 [H, W] disparities: the argmin of the last column's costs,
    then each column's choice of predecessor, from the last column back.
    traces: int64 [W-1, D, H], the choices made at columns 1 .. W-1."""
    w = traces.shape[0] + 1
    d = torch.argmin(acc_last, 0)[None]
    out = torch.empty((w,) + tuple(d.shape[1:]), dtype=torch.int64, device=d.device)
    out[w - 1] = d[0]
    for u in range(w - 2, -1, -1):
        d = torch.gather(traces[u], 0, d)
        out[u] = d[0]
    return out.t().to(torch.int32)


def _so_core(vol: torch.Tensor, disc: torch.Tensor, pn2: float, pn3: float) -> torch.Tensor:
    """The DP and its backtrace along the last axis of a float32 [D, H, W]
    volume; disc: [H, W] bool, the pixels whose penalties are halved.
    Returns int32 [H, W]. Ties take the first argmin."""
    d_, h, w = vol.shape
    dev = vol.device
    vol_t = vol.permute(2, 0, 1)                       # [W, D, H]
    scales = torch.where(disc.t(), 0.5, 1.0)[:, None, :]   # [W, 1, H]
    p2s, p3s = pn2 * scales, pn3 * scales
    ds = torch.arange(d_, device=dev)[:, None].expand(d_, h)
    d_minus, d_plus = ds - 1, ds + 1
    traces = torch.empty((w - 1, d_, h), dtype=torch.int64, device=dev)
    acc = vol_t[0]                                     # column 0: the raw cost
    for u in range(1, w):
        accp = F.pad(acc, (0, 0, 1, 1), value=BIG)    # acc[d-1] and acc[d+1] beside acc[d]
        cands = ((accp[:-2] + p2s[u], d_minus), (accp[2:] + p2s[u], d_plus),
                 (acc.amin(0, keepdim=True) + p3s[u], torch.argmin(acc, 0)[None].expand(d_, h)))
        cost, dmin = acc, ds
        for cand, choice in cands:
            upd = cand < cost
            cost = torch.where(upd, cand, cost)
            dmin = torch.where(upd, choice, dmin)
        acc = vol_t[u] + cost
        traces[u - 1] = dmin
    return _backtrace(acc, traces)


def scanline_optimize(vol: torch.Tensor, image: torch.Tensor, cfg,
                      mode: str = "l2r") -> torch.Tensor:
    """The SO disparity map, int32 [H, W], of a float32 [D, H, W] volume
    guided by its view's [H, W, 3] image. mode: ``"l2r"`` (so), ``"r2l"``
    (so_R2L) or ``"t2b"`` (so_T2D)."""
    img = image.to(torch.float32)
    if mode == "t2b":
        imgx = img.transpose(0, 1)
        disc = discontinuities(imgx, cfg.so_dif_thres)
        return _so_core(vol.transpose(1, 2), disc, cfg.so_pn2, cfg.so_pn3).t()
    if mode == "r2l":
        imgx = img.flip(1)
        disc = discontinuities(imgx, cfg.so_dif_thres)
        return _so_core(vol.flip(2), disc, cfg.so_pn2, cfg.so_pn3).flip(1)
    if mode != "l2r":
        raise ValueError(f"unknown SO mode {mode!r}")
    return _so_core(vol, discontinuities(img, cfg.so_dif_thres), cfg.so_pn2, cfg.so_pn3)


def _shift_d(acc: torch.Tensor, k: int, big: torch.Tensor) -> torch.Tensor:
    """acc [D, H] moved k rows along D (down for k > 0), BIG shifted in."""
    pad = big.expand(abs(k), acc.shape[1])
    return torch.cat([pad, acc[:-k]]) if k > 0 else torch.cat([acc[-k:], pad])


def scanline_optimize_change(vol: torch.Tensor, image: torch.Tensor, ref_disp: torch.Tensor,
                             cfg) -> torch.Tensor:
    """so_change (cpp:6419-6578): SO with d+-2 transitions at penalty 2 (not
    halved at discontinuities: the reference's ``Pn2_ / 2;`` has no effect)
    and, in place of the global minimum, a jump to the previous column's
    disparity in ``ref_disp`` (int [H, W], clamped into [0, D-1]) at +Pn3.
    Candidates in the JAX package's order: d, d-1, d+1, the reference
    disparity, d-2, d+2. Returns int32 [H, W]."""
    d_, h, w = vol.shape
    dev = vol.device
    img = image.to(torch.float32)
    scales = torch.where(discontinuities(img, cfg.so_dif_thres).t(), 0.5, 1.0)[:, None, :]
    vol_t = vol.permute(2, 0, 1)                       # [W, D, H]
    ref_t = ref_disp.clamp(0, d_ - 1).to(torch.int64).t()     # [W, H]
    big = torch.full((1, 1), BIG, dtype=torch.float32, device=dev)
    pn2, pn3, pn2b = cfg.so_pn2, cfg.so_pn3, 2.0
    ds = torch.arange(d_, device=dev)[:, None].expand(d_, h)
    traces = torch.empty((w - 1, d_, h), dtype=torch.int64, device=dev)
    acc = vol_t[0]
    for u in range(1, w):
        scale = scales[u]
        rd = ref_t[u - 1][None]                        # [1, H]
        ref_cost = torch.gather(acc, 0, rd) + pn3 * scale
        cands = (
            (_shift_d(acc, 1, big) + pn2 * scale, ds - 1),
            (_shift_d(acc, -1, big) + pn2 * scale, ds + 1),
            (ref_cost.expand(d_, h), rd.expand(d_, h)),
            (_shift_d(acc, 2, big) + pn2b, ds - 2),
            (_shift_d(acc, -2, big) + pn2b, ds + 2),
        )
        cost, dmin = acc, ds
        for cand, choice in cands:
            upd = cand < cost
            cost = torch.where(upd, cand, cost)
            dmin = torch.where(upd, choice, dmin)
        acc = vol_t[u] + cost
        traces[u - 1] = dmin
    return _backtrace(acc, traces)
