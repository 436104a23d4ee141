"""CBBI: cut-based border interpolation.

Counterpart of ``mystereomatching_tpu/ops/cbbi.py`` (the reference's
``cbbi``, stereoMatching.cpp:7571-7762), plain torch on every device (the
JAX module has no Pallas kernel): the left image blurred and equalised,
its Canny edges, a segmentation into the connected components of the
edge-free colour-tolerance graph (|dI| <= 4 in every channel between
4-neighbours), and invalid pixels adopting the disparity of the first
valid (> 0) same-segment neighbour over 16 one-step directions, in Jacobi
sweeps. The labels are integers (the component's smallest flat index,
after a fixed number of rounds), so they are exact; the blur and the gray
mix round as jitted XLA-CPU does (chains of fused multiply-adds).

The reference's quirk is kept: its 16-entry direction-Y table holds the
expression ``-2. - 1`` (= -3) as one element, leaving 15 explicit entries
and an implicit trailing 0 (cpp:7617).
"""

from __future__ import annotations

import torch

from mystereomatching_tpu_torch.ops.canny import canny_edges, gaussian_blur
from mystereomatching_tpu_torch.ops.cost import fma32
from mystereomatching_tpu_torch.ops.refine import shift2d

# direction tables with the reference's initializer quirk (cpp:7616-7617)
DIR_X = (1, 1, 1, 0, 0, -1, -1, -1, 2, 2, 1, -1, -2, -2, -1, 1)
DIR_Y = (0, -1, 1, -1, 1, -1, 1, 0, 1, -1, -2, -3, 1, 2, 2, 0)


def gray_mix(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0.299 r + 0.587 g + 0.114 b as jitted XLA-CPU computes it:
    fma(b, 0.114, fma(r, 0.299, 0.587 g)), the form of ``aws.rgb_to_lab``'s
    mixes (two roundings a term differ at hundreds of 3,072 pixels)."""
    return fma32(b, 0.114, fma32(r, 0.299, 0.587 * g))


def segment_labels(image: torch.Tensor, tol: int = 4, blur_sigma: float = 4.0,
                   n_rounds: int = 24) -> torch.Tensor:
    """[H, W] int32 segment labels of an [H, W, 3] image: each pixel's
    component's smallest flat index, after ``n_rounds`` rounds of
    :func:`label_components`."""
    img = image.to(torch.float32)
    sm = torch.stack([gaussian_blur(img[..., c], 7, blur_sigma) for c in range(3)])
    gray = torch.round(gray_mix(sm[0], sm[1], sm[2]))
    edges = canny_edges(gray.clamp(0, 255).to(torch.uint8), low=20.0, high=60.0,
                        equalize=True, blur_sigma=0.0)

    def conn(dv, du):
        ok = (sm - shift2d(sm, dv, du, 1e9)).abs().amax(0) <= tol
        return ok & ~edges & ~shift2d(edges, dv, du, True)

    return label_components(conn(0, -1), conn(0, 1), conn(-1, 0), conn(1, 0), n_rounds)


def _scan_min(lab: torch.Tensor, conn: torch.Tensor, axis: int, reverse: bool) -> torch.Tensor:
    """The masked running min along ``axis``: x_i = min(x_{i-1}, lab_i)
    where conn_i holds, else lab_i (the JAX package's associative scan;
    from the far end with ``reverse``). One cummin over the labels lifted
    by their run's rank: a run starts where ``conn`` is false, each run sits
    H W above the next, so no min crosses into an earlier run's labels."""
    x = lab.flip(axis) if reverse else lab
    m = conn.flip(axis) if reverse else conn
    n_lab = lab.numel()
    starts = ~m
    starts.narrow(axis, 0, 1).fill_(True)
    run = torch.cumsum(starts.to(torch.int64), axis)
    lift = (run.amax() - run) * n_lab
    out = ((x.to(torch.int64) + lift).cummin(axis).values - lift).to(lab.dtype)
    return out.flip(axis) if reverse else out


def label_components(c_l: torch.Tensor, c_r: torch.Tensor, c_u: torch.Tensor,
                     c_d: torch.Tensor, n_rounds: int = 24) -> torch.Tensor:
    """Connected-component labels (smallest flat index) of the 4-neighbour
    graph whose directed masks are c_l[v, u] = (v, u) ~ (v, u - 1), c_r,
    c_u and c_d alike: exactly ``n_rounds`` rounds (not to convergence, as
    in the JAX package) of masked running mins along the rows forward and
    back, then the columns forward and back (:func:`_scan_min`)."""
    h, w = c_l.shape
    lab = torch.arange(h * w, dtype=torch.int32, device=c_l.device).reshape(h, w)
    for _ in range(n_rounds):
        lab = _scan_min(lab, c_l, 1, False)
        lab = _scan_min(lab, c_r, 1, True)
        lab = _scan_min(lab, c_u, 0, False)
        lab = _scan_min(lab, c_d, 0, True)
    return lab


def cbbi(disp: torch.Tensor, image: torch.Tensor, cfg=None, n_sweeps: int = 4) -> torch.Tensor:
    """Fill the invalid (< 0) pixels of an int32 [H, W] map from
    same-segment neighbours (cpp:7694-7753): ``n_sweeps`` Jacobi sweeps, in
    each of which an invalid pixel takes the first of the 16 one-step
    directions (``DIR_Y``, ``DIR_X``) whose neighbour is valid (> 0) and in
    its segment (:func:`segment_labels` of the left image). ``cfg`` is
    kept for the JAX signature."""
    labels = segment_labels(image)
    d = disp
    for _ in range(n_sweeps):
        fill = torch.full_like(d, -1)
        found = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
        for dv, du in zip(DIR_Y, DIR_X):
            nd = shift2d(d, dv, du, -1)
            ok = ~found & (nd > 0) & (shift2d(labels, dv, du, -1) == labels)
            fill = torch.where(ok, nd, fill)
            found = found | ok
        d = torch.where((d < 0) & found, fill, d)
    return d
