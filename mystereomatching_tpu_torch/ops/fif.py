"""FIF: full-image recursive cost-volume filtering.

Counterpart of ``mystereomatching_tpu/ops/fif.py`` (the reference's FIF,
stereoMatching.cpp:4541-4705, and FIF_Improve, cpp:4707-4890, the live
variant): edge weights exp(-||dI||^2 / sigma^2) between neighbouring pixels
of the [0, 1]-scaled image (:func:`edge_weights`); along W a forward and a
backward first-order recursion of the volume, combined as fwd + bwd - C,
then the same along H on the result. Plain FIF's recursion is linear,
y[u] = C[u] + w[u-1] y[u-1] (:func:`_linear_recur`); FIF_Improve's is
min-plus with SGM-like +-1 disparity transitions (:func:`_mp`).

The weights are kept apart from the recursions, so that each can be held
against the JAX package's alone. The weights round as jitted XLA-CPU
computes them (its contractions into fused multiply-adds, its reciprocal
of sigma^2), with ``cost.exp32``, so they are within one ULP of JAX's and
equal on the card and the CPU. Each recursion equals JAX's bit for bit
given the same weights: ``_mp`` sequentially, with ``c + w * m`` as one
fused multiply-add (taken as ``cost.fma32`` takes it: in float64, rounded
once), as the jitted ``lax.scan`` body computes it; ``_linear_recur`` in the order of adds of
``lax.associative_scan`` (:func:`_associative_scan`). The JAX module has no
Pallas kernel, so neither has this: the recursions are a few plain torch
launches a step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mystereomatching_tpu_torch.ops.cost import exp32, flush_subnormal, fma32

BIG = 3.4e38  # the min-plus recursion's edge cost past d = 0 and d = D-1


def edge_weights(image: torch.Tensor, sigma: float = 0.08):
    """(w_h, w_v) float32 [H, W]: w_h[v, u] between (v, u) and (v, u+1),
    w_v[v, u] between (v, u) and (v+1, u) (cpp:4556-4580), on the image
    times 1/255; the last column's and row's entries wrap and are unused.
    The squared channel differences are summed as XLA-CPU contracts them:
    each difference a fused multiply-add of the neighbour's value and the
    scale, each square after the first fused into the sum."""
    img = image.to(torch.float32)
    scale = float(np.float32(1.0) / np.float32(255.0))
    inv_s2 = float(np.float32(1.0) / np.float32(sigma * sigma))
    scaled = img * scale

    def weights(axis: int) -> torch.Tensor:
        d = fma32(torch.roll(img, -1, axis), scale, -scaled)
        total = d[..., 0] * d[..., 0]
        for c in range(1, d.shape[-1]):
            total = fma32(d[..., c], d[..., c], total)
        return exp32(total * -inv_s2)

    return weights(1), weights(0)


def _rev_w(w: torch.Tensor) -> torch.Tensor:
    """Edge weights along the reversed last axis: w_rev[k] = w[n-2-k]
    (clamped), the coupling k <-> k+1 of the reversed sequence."""
    n = w.shape[-1]
    idx = torch.clamp(n - 2 - torch.arange(n, device=w.device), 0, n - 1)
    return w.index_select(-1, idx)


def _combine(x, y):
    """lax.associative_scan's combine of the linear recurrence: (a1, b1)
    then (a2, b2) -> (a2 a1, a2 b1 + b2), the latter one fused
    multiply-add, a subnormal product of weights flushed to 0."""
    (a1, b1), (a2, b2) = x, y
    return flush_subnormal(a2 * a1), fma32(a2, b1, b2)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """e0, o0, e1, o1, ... along the last axis (``even`` one longer, or as long)."""
    n = even.shape[-1] + odd.shape[-1]
    out = even.new_empty(even.shape[:-1] + (n,))
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) pairs under :func:`_combine` along the last
    axis, in ``lax.associative_scan``'s recursive order: adjacent pairs
    combined, the odd positions scanned recursively, the even ones (but
    the first) combined from the odd prefix before them."""
    n = a.shape[-1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[..., 0:n - 1:2], b[..., 0:n - 1:2]), (a[..., 1::2], b[..., 1::2]))
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[..., :-1], ob[..., :-1]), (a[..., 2::2], b[..., 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[..., 2::2], b[..., 2::2]))
    ea = torch.cat([a[..., :1], ea], -1)
    eb = torch.cat([b[..., :1], eb], -1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _linear_recur(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[..., k] = c[..., k] + w[..., k-1] y[..., k-1] along the last axis,
    w[..., k] the coupling of k to k+1 (broadcast against c)."""
    return _associative_scan(F.pad(w[..., :-1], (1, 0)), c)[1]


def _axis_passes(vol: torch.Tensor, wh: torch.Tensor, wv: torch.Tensor, recur) -> torch.Tensor:
    """fwd + bwd - C along W with wh, then along H on the result with wv."""
    def axis_pass(x, w_edge):
        fwd = recur(x, w_edge)
        bwd = recur(x.flip(-1), _rev_w(w_edge)).flip(-1)
        return fwd + bwd - x

    hres = axis_pass(vol, wh)
    return axis_pass(hres.transpose(1, 2), wv.t()).transpose(1, 2)


def fif(vol: torch.Tensor, image: torch.Tensor, sigma: float = 0.08,
        pn: float = 2.0) -> torch.Tensor:
    """Plain FIF (cpp:4541-4705) of a float32 [D, H, W] volume guided by
    its view's [H, W, 3] image (``pn`` is unused, as in the JAX package)."""
    wh, wv = edge_weights(image, sigma)
    return _axis_passes(vol, wh, wv, lambda x, w: _linear_recur(x, w[None]))


def _mp(vol: torch.Tensor, w_edge: torch.Tensor, pn: float) -> torch.Tensor:
    """The min-plus forward recursion along the last axis of [D, H, W]:
    y[u] = C[u] + w[u-1] min(y[u-1][d], y[u-1][d+-1] + pn), y before
    column 0 being 0 and w[-1] 0. Each step's fused multiply-add is
    ``cost.fma32``'s, its operands widened to float64 once for all steps
    and its float32 rounding the copy into the output."""
    d_, h, w = vol.shape
    vol_t = vol.permute(2, 0, 1).to(torch.float64)          # [W, D, H]
    a_t = F.pad(w_edge[:, :-1], (1, 0)).t()[:, None, :].to(torch.float64)   # [W, 1, H]
    out = torch.empty((w, d_, h), dtype=vol.dtype, device=vol.device)
    y = vol[..., 0] * 0
    for u in range(w):
        yp = F.pad(y, (0, 0, 1, 1), value=BIG)              # y[d-1] and y[d+1] beside y[d]
        m = torch.minimum(y, torch.minimum(yp[:-2], yp[2:]) + pn)
        out[u].copy_(torch.addcmul(vol_t[u], a_t[u], m.to(torch.float64)))
        y = out[u]
    return out.permute(1, 2, 0)


def fif_improve(vol: torch.Tensor, image: torch.Tensor, sigma: float = 0.08,
                pn: float = 2.0) -> torch.Tensor:
    """FIF_Improve (cpp:4707-4890): the min-plus recursion with penalty
    ``pn`` in FIF's fwd + bwd - C, W-then-H structure."""
    wh, wv = edge_weights(image, sigma)
    return _axis_passes(vol, wh, wv, lambda x, w: _mp(x, w, pn))
