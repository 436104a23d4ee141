"""Cost-volume plumbing: disparity-shifted gathers and validity masks.

Counterpart of ``mystereomatching_tpu/ops/volume.py``. The left volume
(lor=0) matches I_L(v, u) against I_R(v, u-d); the right volume (lor=1)
matches I_L(v, u+d) against I_R(v, u).
"""

from __future__ import annotations

import torch


def _disparity_index(w: int, num_disp: int, lor: int, device) -> torch.Tensor:
    u = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    d = torch.arange(num_disp, dtype=torch.int64, device=device)[:, None]
    return u - d if lor == 0 else u + d                  # [D, W]


def shifted_stack(img: torch.Tensor, num_disp: int, lor: int) -> torch.Tensor:
    """Disparity-shifted stack of the *other* image.

    img: [..., W]. Returns [D, ..., W] with S[d, ..., u] = img[..., u-d]
    for lor=0 and img[..., u+d] for lor=1; out-of-range columns are
    clamped (mask them with :func:`valid_mask`).
    """
    w = img.shape[-1]
    idx = _disparity_index(w, num_disp, lor, img.device).clamp(0, w - 1)
    return torch.movedim(img[..., idx], -2, 0)           # [..., D, W] -> [D, ..., W]


def valid_mask(w: int, num_disp: int, lor: int, device) -> torch.Tensor:
    """[D, 1, W] bool: True where the matching pixel is inside the image."""
    idx = _disparity_index(w, num_disp, lor, device)
    ok = idx >= 0 if lor == 0 else idx < w
    return ok[:, None, :]


def flip_volume_lr(vol_left: torch.Tensor) -> torch.Tensor:
    """Reindex a left-reference [D, H, W] volume into the right view:
    vmR[d, v, u] = vmL[d, v, (u + d) mod W] (qx_stereo_flip_corr_vol,
    NL/qx_basic.cpp:577), with the JAX package's wrap-around for u + d >= W.
    One gather along W; its index is broadcast over H, not materialised."""
    nd, h, w = vol_left.shape
    idx = _disparity_index(w, nd, 1, vol_left.device) % w          # [D, W]
    return torch.gather(vol_left, 2, idx[:, None, :].expand(nd, h, w))
