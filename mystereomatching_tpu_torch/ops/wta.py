"""Disparity decision: winner-take-all, cooperative WTA, uniqueness check,
quadratic subpixel.

Counterpart of ``wta``, ``wta_pair_cooperative``, ``uniqueness_mask`` and
``subpixel_quadratic`` in ``mystereomatching_tpu/ops/wta.py``
(gen_dispFromVm cpp:3928-3967, wta_Co cpp:2709-2792). WTA is CUDA kernel D
(``csrc/wta.cu``) on a CUDA tensor, float32 or bfloat16; the others have no
TPU kernel of their own and are plain torch on every device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops.volume import flip_volume_lr


def wta_plain(vol: torch.Tensor, choose_small: bool = True) -> torch.Tensor:
    """Plain torch WTA: first-occurrence argmin (argmax unless
    choose_small) over D of [D, H, W] -> int32 [H, W]."""
    arg = torch.argmin(vol, 0) if choose_small else torch.argmax(vol, 0)
    return arg.to(torch.int32)


def wta(vol: torch.Tensor, choose_small: bool = True) -> torch.Tensor:
    if ck.on_cuda(vol):
        return ck.wta(vol, choose_small)
    return wta_plain(vol, choose_small)


def cooperative_volume(vol_left: torch.Tensor, lor: int,
                       choose_small: bool = True) -> torch.Tensor:
    """The volume the cooperative WTA decides view ``lor`` from, given one
    left-reference [D, H, W] volume: for the left view (0) the volume with d
    > u masked, for the right view (1) the volume reindexed into the right
    view (:func:`flip_volume_lr`) with d > W - 1 - u masked. The mask is
    +-float32 max cast to the volume's dtype (+-inf in bfloat16, as in the
    JAX package)."""
    nd, _, w = vol_left.shape
    bad = torch.tensor(torch.finfo(torch.float32).max * (1 if choose_small else -1),
                       device=vol_left.device).to(vol_left.dtype)
    u = torch.arange(w, device=vol_left.device)[None, :]
    d = torch.arange(nd, device=vol_left.device)[:, None]
    if lor == 0:
        return torch.where(((u - d) >= 0)[:, None, :], vol_left, bad)
    return torch.where(((u + d) < w)[:, None, :], flip_volume_lr(vol_left), bad)


def wta_pair_cooperative(vol_left: torch.Tensor,
                         choose_small: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_left, d_right) int32 maps from one left-reference [D, H, W] volume,
    the reference's cooperative WTA (wta_Co cpp:2709-2792) without its
    DISP_SCALE encoding: each the WTA of its :func:`cooperative_volume`."""
    return tuple(wta(cooperative_volume(vol_left, lor, choose_small), choose_small)
                 for lor in (0, 1))


def uniqueness_mask(vol: torch.Tensor, disp: torch.Tensor,
                    ratio: float = 0.95) -> torch.Tensor:
    """True where the WTA disparity fails the uniqueness test (wta_Co
    cpp:2762-2775): some d with |d - disp| > 1 has cost[d] * ratio below
    the minimum cost. vol [D, H, W], disp int32 [H, W] -> bool [H, W]."""
    ds = torch.arange(vol.shape[0], dtype=disp.dtype, device=vol.device)[:, None, None]
    near = (ds - disp[None]).abs() <= 1
    return ((vol * ratio < vol.amin(0)[None]) & ~near).any(0)


def neighbour_costs(vol: torch.Tensor, disp: torch.Tensor):
    """Costs at d0 - 1, d0 and d0 + 1 for d0 = disp clamped into [1, D-2]."""
    d0 = disp.clamp(1, vol.shape[0] - 2).to(torch.int64)[None]
    return tuple(torch.gather(vol, 0, d0 + k)[0] for k in (-1, 0, 1))


def subpixel_quadratic(vol: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """+-1 quadratic interpolation around the WTA disparity (wta_Co
    cpp:2778-2784): disp + (c[d-1] - c[d+1]) / (2 (c[d-1] + c[d+1] - 2 c[d])),
    float32 [H, W] without DISP_SCALE; disparities 0 and D-1 (and the
    negative sentinels) are returned unrefined."""
    cm, c0, cp = neighbour_costs(vol, disp)
    denom = cm + cp - 2.0 * c0
    off = torch.where(denom.abs() > 1e-12, (cm - cp) / (2.0 * denom), 0.0)
    inner = (disp >= 1) & (disp <= vol.shape[0] - 2)
    d = disp.to(torch.float32)
    return torch.where(inner, d + off, d)
