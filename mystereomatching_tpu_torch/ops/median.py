"""Median filters: the small-window sort (replicate border) and the
histogram median (the window cut at the border).

Counterpart of ``median_small``, ``median_histogram`` and ``median_filter``
in ``mystereomatching_tpu/ops/median.py`` (cv::medianBlur semantics; the
histogram form is ctmf's, NL/ctmf.c:108-433). The JAX package has no TPU
kernel here: this is plain torch on every device.
"""

from __future__ import annotations

import torch

from mystereomatching_tpu_torch.ops.cost import _box_sum


def _shifted_planes(img: torch.Tensor, radius: int) -> torch.Tensor:
    """[(2r+1)^2, ..., H, W] stack of window samples with a replicate border.

    Built from clamped row and column indices, which works on every dtype
    (``F.pad(mode="replicate")`` refuses integer tensors)."""
    h, w = img.shape[-2:]
    offs = torch.arange(-radius, radius + 1, device=img.device)
    rows = (torch.arange(h, device=img.device)[None, :] + offs[:, None]).clamp(0, h - 1)
    cols = (torch.arange(w, device=img.device)[None, :] + offs[:, None]).clamp(0, w - 1)
    return torch.stack([img[..., rows[i], :][..., cols[j]]
                        for i in range(2 * radius + 1) for j in range(2 * radius + 1)])


def median_small(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Median over the ksize x ksize window (odd ksize, replicate border)
    of an [..., H, W] tensor of any dtype: the middle of the sorted window."""
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"median_small: ksize must be odd and positive, got {ksize}")
    planes = _shifted_planes(img, ksize // 2)
    return torch.sort(planes, dim=0).values[planes.shape[0] // 2]


def median_histogram(img: torch.Tensor, radius: int, levels: int = 256) -> torch.Tensor:
    """Median over the (2r+1) x (2r+1) window of an integer-valued [H, W]
    image in [0, levels), the window cut at the border (ctmf): each
    pixel's windowed histogram is the box sum (``cost._box_sum``) of a
    one-hot [levels, H, W] volume, and its median the first level whose
    cumulative count reaches half the window's count plus one. Every count
    is an integer below 2^24, so the float32 sums are exact. In ``img``'s
    dtype."""
    x = img.to(torch.int64)
    onehot = x[None] == torch.arange(levels, device=img.device)[:, None, None]
    hist = _box_sum(onehot.to(torch.float32), radius, radius)
    half = (hist.sum(0) + 1.0) * 0.5
    reached = torch.cumsum(hist, 0) >= half[None]
    return torch.argmax(reached.to(torch.uint8), 0).to(img.dtype)


def median_filter(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """The sorting median for ksize <= 5, else the histogram median at
    radius ksize // 2 (JAX ``median_filter``)."""
    if ksize <= 5:
        return median_small(img, ksize)
    return median_histogram(img, ksize // 2)
