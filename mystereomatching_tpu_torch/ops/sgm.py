"""Semi-global matching over the four axis-aligned paths.

Counterpart of ``mystereomatching_tpu/ops/sgm.py`` (``penalty_scale``,
``_scan_down``, ``sgm``, ``sgm_multi``, ``sgm_directions``) for the
default 4-path set. Each direction's path costs are CUDA kernel C
(``csrc/sgm_scan.cu``) on a CUDA tensor.

Recurrence (updateCost h:2268-2274), along the scan from the predecessor:
    L(p,d) = C(p,d) + min(L(p-r,d), minL + P2 s, min(L(p-r,d-1), L(p-r,d+1)) + P1 s) - minL
with minL = min_d L(p-r,d) and s the adaptive penalty scale; the first
pixel of each scan line takes L = C. The volumes' sum over directions is
associated as the JAX package does it:
(L(1,0) + L(-1,0)) + (L(0,1) + L(0,-1)).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from mystereomatching_tpu_torch.ops import cuda_kernels as ck

# predecessor offsets (rv, ru), reference order (cpp:6206-6208)
DIRECTIONS_8: Tuple[Tuple[int, int], ...] = (
    (1, 0), (-1, 0), (0, 1), (0, -1),
    (1, -1), (1, 1), (-1, 1), (-1, -1),
)

_FLT_MAX = torch.finfo(torch.float32).max


def penalty_scale(image: torch.Tensor, rv: int, ru: int, thres: int = 15,
                  coeff: float = 4.0) -> torch.Tensor:
    """Per-pixel P1/P2 multiplier for predecessor offset (rv, ru): 1/coeff
    where the max-channel |I(p) - I(p+r)| exceeds thres, else 1. [H, W]."""
    img = image.to(torch.float32)
    shifted = torch.roll(img, shifts=(-rv, -ru), dims=(0, 1))
    d1 = (img - shifted).abs().amax(-1)
    return torch.where(d1 > thres, 1.0 / coeff, 1.0).to(torch.float32)


def sgm_scan_plain(vol: torch.Tensor, pscale: torch.Tensor, p1: float, p2: float,
                   axis: int, reverse: bool) -> torch.Tensor:
    """Plain torch path costs of [G, D, H, W] volumes scanned along H
    (axis 2) or W (axis 3), from the far end when ``reverse``; pscale
    [G, H, W]. The step is ``sgm._scan_down``'s, in its operation order."""
    # scan axis first: [S, G, D, L] costs and [S, G, 1, L] scales
    v = vol.movedim(axis, 0)
    ps = pscale.movedim(axis - 1, 0)[:, :, None]
    out = torch.empty_like(v)
    prev = torch.zeros_like(v[0])
    big = torch.full_like(prev[:, :1], _FLT_MAX)
    steps = range(v.shape[0] - 1, -1, -1) if reverse else range(v.shape[0])
    for t in steps:
        min_l = prev.amin(1, keepdim=True)
        up = torch.cat([big, prev[:, :-1]], 1)
        dn = torch.cat([prev[:, 1:], big], 1)
        best = torch.minimum(torch.minimum(prev, min_l + p2 * ps[t]),
                             torch.minimum(up, dn) + p1 * ps[t])
        prev = v[t] + best - min_l
        out[t] = prev
    return out.movedim(0, axis)


def sgm_scan(vol: torch.Tensor, pscale: torch.Tensor, p1: float, p2: float,
             axis: int, reverse: bool) -> torch.Tensor:
    if ck.on_cuda(vol):
        return ck.sgm_scan(vol, pscale, p1, p2, axis, reverse)
    return sgm_scan_plain(vol, pscale, p1, p2, axis, reverse)


def sgm_directions(vol_list: Sequence[torch.Tensor], img_list: Sequence[torch.Tensor],
                   dirs, p1: float = 1.0, p2: float = 3.0, cor_dif_thres: int = 15,
                   redu_coeff: float = 4.0) -> List[torch.Tensor]:
    """Path-cost sum over axis-aligned directions, all volumes batched into
    each direction's scan."""
    if any(rv != 0 and ru != 0 for rv, ru in dirs):
        raise NotImplementedError("diagonal SGM paths (8-path SGM) are not ported yet")
    vols = torch.stack(list(vol_list)).contiguous()
    vertical = torch.zeros_like(vols)
    horizontal = None
    for rv, ru in dirs:
        ps = torch.stack([penalty_scale(img, rv, ru, cor_dif_thres, redu_coeff)
                          for img in img_list]).contiguous()
        if ru == 0:
            vertical = vertical + sgm_scan(vols, ps, p1, p2, axis=2, reverse=rv > 0)
        else:
            path = sgm_scan(vols, ps, p1, p2, axis=3, reverse=ru > 0)
            horizontal = path if horizontal is None else horizontal + path
    out = vertical if horizontal is None else vertical + horizontal
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
