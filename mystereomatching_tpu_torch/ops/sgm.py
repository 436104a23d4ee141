"""Semi-global matching over the four axis-aligned and four diagonal paths.

Counterpart of ``mystereomatching_tpu/ops/sgm.py`` (``penalty_scale``,
``_scan_down`` with its carried-in row and in-image mask, ``_skew``,
``_unskew``, ``scan_direction``, ``sgm``, ``sgm_multi``,
``sgm_directions``). Each axis direction's path costs are CUDA kernel C
(``csrc/sgm_scan.cu``) on a CUDA tensor, each diagonal's kernel E
(``csrc/sgm_diag.cu``); the row-band pipeline's W-chunk scans along H go
as tables of scans (:func:`sgm_scan_table`) through kernel C's table
kernel. Volumes are float32 or bfloat16; in bfloat16 every
operation rounds to it (see :func:`_step`), the direction sum's adds too.

Recurrence (updateCost h:2268-2274), along the scan from the predecessor:
    L(p,d) = C(p,d) + min(L(p-r,d), minL + P2 s, min(L(p-r,d-1), L(p-r,d+1)) + P1 s) - minL
with minL = min_d L(p-r,d) and s the adaptive penalty scale; the first
pixel of each scan line takes L = C. The volumes' sum over directions is
associated as the JAX package's CPU path does it: the vertical pair, then
each diagonal in ``DIRECTIONS_8`` order, then the horizontal pair summed
on its own:
(((((L(1,0) + L(-1,0)) + L(1,-1)) + L(1,1)) + L(-1,1)) + L(-1,-1))
+ (L(0,1) + L(0,-1)).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops.cuda_kernels import ChunkScan

# predecessor offsets (rv, ru), reference order (cpp:6206-6208)
DIRECTIONS_8: Tuple[Tuple[int, int], ...] = (
    (1, 0), (-1, 0), (0, 1), (0, -1),
    (1, -1), (1, 1), (-1, 1), (-1, -1),
)

def penalty_scale(image: torch.Tensor, rv: int, ru: int, thres: int = 15,
                  coeff: float = 4.0) -> torch.Tensor:
    """Per-pixel P1/P2 multiplier for predecessor offset (rv, ru): 1/coeff
    where the max-channel |I(p) - I(p+r)| exceeds thres, else 1. [H, W]."""
    img = image.to(torch.float32)
    shifted = torch.roll(img, shifts=(-rv, -ru), dims=(0, 1))
    d1 = (img - shifted).abs().amax(-1)
    return torch.where(d1 > thres, 1.0 / coeff, 1.0).to(torch.float32)


def _step(prev: torch.Tensor, cost: torch.Tensor, ps: torch.Tensor, p1: float,
          p2: float) -> torch.Tensor:
    """One step of the recurrence, ``sgm._scan_down``'s in its operation
    order: prev [G, D, L] predecessors' path costs (0 outside the image),
    cost [G, D, L], ps [G, 1, L] float32 -> the [G, D, L] path costs.

    Every operation rounds in the volume's dtype. In bfloat16 the scaled
    penalties p1 s and p2 s are rounded to it first: the JAX package's
    penalty scale is a weakly typed float32, so its adds stay in bfloat16,
    where torch would promote them to float32. The edge fill is the dtype's
    largest finite value."""
    big = torch.full_like(prev[:, :1], torch.finfo(prev.dtype).max)
    min_l = prev.amin(1, keepdim=True)
    up = torch.cat([big, prev[:, :-1]], 1)
    dn = torch.cat([prev[:, 1:], big], 1)
    p1s, p2s = (p1 * ps).to(prev.dtype), (p2 * ps).to(prev.dtype)
    best = torch.minimum(torch.minimum(prev, min_l + p2s), torch.minimum(up, dn) + p1s)
    return cost + best - min_l


def sgm_scan_plain(vol: torch.Tensor, pscale: torch.Tensor, p1: float, p2: float,
                   axis: int, reverse: bool, init: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch path costs of [G, D, H, W] volumes scanned along H
    (axis 2) or W (axis 3), from the far end when ``reverse``; pscale
    [G, H, W]. The step is ``sgm._scan_down``'s, in its operation order.

    init: the carry before the first step, [G, D, W] along H ([G, D, H]
    along W), instead of zeros: the neighbouring row band's last path costs.
    mask: [G, H, W] of 0s and 1s in vol's dtype, by which each step's path
    costs are multiplied after their last rounding, and carried so
    (``_scan_down``'s ``in_image``, ``_sgm_kernel``'s ``mask_ref``)."""
    # scan axis first: [S, G, D, L] costs and [S, G, 1, L] scales and masks
    v = vol.movedim(axis, 0)
    ps = pscale.movedim(axis - 1, 0)[:, :, None]
    ms = mask.movedim(axis - 1, 0)[:, :, None] if mask is not None else None
    out = torch.empty_like(v)
    prev = init.to(vol.dtype) if init is not None else torch.zeros_like(v[0])
    steps = range(v.shape[0] - 1, -1, -1) if reverse else range(v.shape[0])
    for t in steps:
        prev = _step(prev, v[t], ps[t], p1, p2)
        if ms is not None:
            prev = prev * ms[t]
        out[t] = prev
    return out.movedim(0, axis)


def sgm_scan(vol: torch.Tensor, pscale: torch.Tensor, p1: float, p2: float,
             axis: int, reverse: bool, init: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if ck.on_cuda(vol):
        return ck.sgm_scan(vol, pscale, p1, p2, axis, reverse, init, mask)
    return sgm_scan_plain(vol, pscale, p1, p2, axis, reverse, init, mask)


def sgm_scan_table_plain(scans: Sequence[ChunkScan], p1: float, p2: float) -> None:
    """Plain torch version of kernel C's table: each :class:`ChunkScan`
    scanned by :func:`sgm_scan_plain` on views of its buffers' columns
    lo .. lo + width - 1, its path costs written into those columns of its
    ``out`` and its last row scanned into its ``edge``, in place. The mask
    is taken in the costs' dtype (0 and 1 are exact in either)."""
    for sc in scans:
        cols = slice(sc.lo, sc.lo + sc.width)
        mask = sc.mask[None, :, cols].to(sc.vol.dtype) if sc.mask is not None else None
        res = sgm_scan_plain(sc.vol[None, :, :, cols], sc.pscale[None, :, cols], p1, p2, 2,
                             sc.reverse, sc.init[None] if sc.init is not None else None,
                             mask)[0]
        sc.out[:, :, cols] = res
        if sc.edge is not None:
            sc.edge.copy_(res[:, 0 if sc.reverse else -1])


def sgm_scan_table(scans: Sequence[ChunkScan], p1: float, p2: float) -> None:
    """Every scan of ``scans`` in place: one kernel launch on CUDA tensors,
    the plain version on CPU ones."""
    if ck.on_cuda(scans[0].vol):
        ck.sgm_scan_table(scans, p1, p2)
    else:
        sgm_scan_table_plain(scans, p1, p2)


def _skew(x: torch.Tensor, sign: int, fill: float):
    """Skew the rows of [..., H, W] into [..., H, W + H - 1]: row v moves
    right by v (sign +1) or by H - 1 - v (sign -1), so that a diagonal
    predecessor becomes the vertical one; the margins take ``fill``.
    Returns (skewed, in-image mask [H, W + H - 1] bool). The JAX package's
    pad, flatten, truncate and reshape, gather-free."""
    h, w = x.shape[-2:]
    ws = w + h - 1
    if sign < 0:
        out, ok = _skew(x.flip(-2), 1, fill)
        return out.flip(-2), ok.flip(0)
    lead = x.shape[:-2]
    flat = F.pad(x, (0, h), value=fill).reshape(lead + (h * (w + h),))
    out = flat[..., :h * ws].reshape(lead + (h, ws))
    u = (torch.arange(ws, device=x.device)[None, :]
         - torch.arange(h, device=x.device)[:, None])
    return out, (u >= 0) & (u < w)


def _unskew(x: torch.Tensor, sign: int, w: int) -> torch.Tensor:
    """Inverse of :func:`_skew`: [..., H, W + H - 1] -> [..., H, W]."""
    h, ws = x.shape[-2:]
    if sign < 0:
        return _unskew(x.flip(-2), 1, w).flip(-2)
    lead = x.shape[:-2]
    flat = F.pad(x.reshape(lead + (h * ws,)), (0, h))
    return flat.reshape(lead + (h, w + h))[..., :w]


def sgm_diag_scan_plain(vol: torch.Tensor, pscale: torch.Tensor, p1: float, p2: float,
                        rv: int, ru: int) -> torch.Tensor:
    """Plain torch path costs of [G, D, H, W] volumes along the diagonal
    with predecessor offset (rv, ru), each -1 or +1; pscale [G, H, W].

    Rows are walked from the predecessor's side; each step's predecessors
    are the carried [G, D, W] row shifted by one column, with 0 entering at
    the border (the first pixel of each diagonal line takes L = C). This is
    the formulation of ``_sgm_diag_kernel`` (``pallas_kernels.py:980-1006``),
    equal bit for bit to ``sgm.scan_direction``'s skewed scan."""
    out = torch.empty_like(vol)
    prev = torch.zeros_like(vol[:, :, 0])
    edge = torch.zeros_like(prev[..., :1])
    rows = range(vol.shape[2] - 1, -1, -1) if rv > 0 else range(vol.shape[2])
    for v in rows:
        pred = (torch.cat([prev[..., 1:], edge], -1) if ru > 0
                else torch.cat([edge, prev[..., :-1]], -1))
        prev = _step(pred, vol[:, :, v], pscale[:, None, v], p1, p2)
        out[:, :, v] = prev
    return out


def sgm_diag_scan(vol: torch.Tensor, pscale: torch.Tensor, p1: float, p2: float,
                  rv: int, ru: int) -> torch.Tensor:
    if ck.on_cuda(vol):
        return ck.sgm_diag_scan(vol, pscale, p1, p2, rv, ru)
    return sgm_diag_scan_plain(vol, pscale, p1, p2, rv, ru)


def sgm_directions(vol_list: Sequence[torch.Tensor], img_list: Sequence[torch.Tensor],
                   dirs, p1: float = 1.0, p2: float = 3.0, cor_dif_thres: int = 15,
                   redu_coeff: float = 4.0) -> List[torch.Tensor]:
    """Path-cost sum over ``dirs``, all volumes batched into each
    direction's scan; summed in the module docstring's order (vertical,
    then diagonal, each in ``dirs`` order, then the horizontal sum)."""
    vols = torch.stack(list(vol_list)).contiguous()

    def path(rv, ru):
        ps = torch.stack([penalty_scale(img, rv, ru, cor_dif_thres, redu_coeff)
                          for img in img_list]).contiguous()
        if ru == 0:
            return sgm_scan(vols, ps, p1, p2, axis=2, reverse=rv > 0)
        if rv == 0:
            return sgm_scan(vols, ps, p1, p2, axis=3, reverse=ru > 0)
        return sgm_diag_scan(vols, ps, p1, p2, rv, ru)

    out = torch.zeros_like(vols)
    for rv, ru in [d for d in dirs if d[1] == 0] + [d for d in dirs if d[0] and d[1]]:
        out += path(rv, ru)
    horizontal = None
    for rv, ru in [d for d in dirs if d[0] == 0]:
        p = path(rv, ru)
        horizontal = p if horizontal is None else horizontal.add_(p)
    if horizontal is not None:
        out += horizontal
    return list(out.unbind(0))


def sgm_multi(vol_list, img_list, num_directions: int = 4, p1: float = 1.0,
              p2: float = 3.0, cor_dif_thres: int = 15,
              redu_coeff: float = 4.0) -> List[torch.Tensor]:
    """SGM over several volumes at once (left and right for the LR check)."""
    return sgm_directions(vol_list, img_list, DIRECTIONS_8[:num_directions],
                          p1, p2, cor_dif_thres, redu_coeff)


def sgm(vol: torch.Tensor, image: torch.Tensor, num_directions: int = 4,
        p1: float = 1.0, p2: float = 3.0, cor_dif_thres: int = 15,
        redu_coeff: float = 4.0) -> torch.Tensor:
    """Full SGM of one [D, H, W] volume; image: its [H, W, 3] reference image."""
    return sgm_multi([vol], [image], num_directions, p1, p2, cor_dif_thres,
                     redu_coeff)[0]
