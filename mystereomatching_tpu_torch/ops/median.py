"""Small-window median filter with a replicate border.

Counterpart of ``median_small`` in ``mystereomatching_tpu/ops/median.py``
(cv::medianBlur semantics). The JAX package has no TPU kernel here: this is
plain torch on every device.
"""

from __future__ import annotations

import torch


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
