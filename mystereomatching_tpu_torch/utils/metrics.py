"""Evaluation: the bad-pixel rate.

Counterpart of the bad ratio of ``bad_pixel_stats`` in
``mystereomatching_tpu/utils/metrics.py`` (calErr, h:1748-1825).
"""

from __future__ import annotations

from typing import Optional

import torch


def bad_pixel_rate(disp: torch.Tensor, gt: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   thresh: float = 1.0) -> float:
    """Share of evaluated pixels with |disp - gt| > thresh; negative
    (invalid) disparities always count as bad. Pixels with gt == 0 have no
    ground truth and are skipped, as are pixels outside ``mask``."""
    disp = disp.to(torch.float32)
    gt = gt.to(device=disp.device, dtype=torch.float32)
    region = gt > 0
    if mask is not None:
        region = region & mask.to(disp.device)
    bad = (disp < 0) | ((disp - gt).abs() > thresh)
    return float((bad & region).sum()) / max(int(region.sum()), 1)
