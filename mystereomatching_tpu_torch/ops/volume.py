"""Cost-volume plumbing: disparity-shifted gathers and validity masks.

Counterpart of ``mystereomatching_tpu/ops/volume.py``. The left volume
(lor=0) matches I_L(v, u) against I_R(v, u-d); the right volume (lor=1)
matches I_L(v, u+d) against I_R(v, u).
"""

from __future__ import annotations

import torch


def _disparity_index(w: int, num_disp: int, lor: int, device, disps=None) -> torch.Tensor:
    """[D, W] matching columns u - d (lor=0) or u + d (lor=1), over
    d in 0..num_disp-1, or over ``disps`` where given."""
    u = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    d = (torch.arange(num_disp, dtype=torch.int64, device=device) if disps is None
         else torch.as_tensor(disps, device=device).to(torch.int64))[:, None]
    return u - d if lor == 0 else u + d


def shifted_stack(img: torch.Tensor, num_disp: int, lor: int, disps=None) -> torch.Tensor:
    """Disparity-shifted stack of the *other* image.

    img: [..., W]. Returns [D, ..., W] with S[d, ..., u] = img[..., u-d]
    for lor=0 and img[..., u+d] for lor=1; out-of-range columns are
    clamped (mask them with :func:`valid_mask`). ``disps``: an int [Db]
    index of disparities (a block of the disparity-streamed volume) in
    place of 0..num_disp-1; the stack is then [Db, ..., W].
    """
    w = img.shape[-1]
    idx = _disparity_index(w, num_disp, lor, img.device, disps).clamp(0, w - 1)
    return torch.movedim(img[..., idx], -2, 0)           # [..., D, W] -> [D, ..., W]


def valid_mask(w: int, num_disp: int, lor: int, device, disps=None) -> torch.Tensor:
    """[D, 1, W] bool ([Db, 1, W] over ``disps``): True where the matching
    pixel is inside the image."""
    idx = _disparity_index(w, num_disp, lor, device, disps)
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


def _reflect101_index(n: int, r: int, device) -> torch.Tensor:
    """[n + 2r] indices of an axis of n padded by r on both sides with
    reflect-101 (cv::BORDER_REFLECT_101, numpy's "reflect"), r >= n too:
    the axis extended with period 2 (n - 1)."""
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = i.abs() % (2 * (n - 1))
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def pad_reflect101(x: torch.Tensor, r: int) -> torch.Tensor:
    """x [..., H, W] padded by r on both sides of its last two axes with
    reflect-101 (``jnp.pad(mode="reflect")``), whatever r is against H, W."""
    h, w = x.shape[-2:]
    x = x.index_select(-2, _reflect101_index(h, r, x.device))
    return x.index_select(-1, _reflect101_index(w, r, x.device))
