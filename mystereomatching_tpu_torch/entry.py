"""Entry point: the flagship pipeline and an example pair to call it on.

The torch counterpart of the JAX package's ``__graft_entry__.entry()``:

    from mystereomatching_tpu_torch.entry import entry
    fn, (left, right) = entry()            # on the card; entry("cpu") on the CPU
    out = fn(left, right)                  # {"disparity", "disp_left_raw", "disp_right_raw"}
    fn, args = entry("cpu", "aws_wta")     # any preset of models.list_models()
"""

from __future__ import annotations

import torch

from mystereomatching_tpu_torch.config import default_config
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.pipeline import StereoPipeline

MAX_DISP = 31
SHAPE = (120, 160)


def entry(device="cuda", preset=None):
    """(fn, example_args): the reference's measured default (censusGrad,
    CBCA, 4-path SGM, LR check, region vote, proper interpolation, median),
    or the named ``preset`` of the registry, at max_disp 31 as a
    :class:`StereoPipeline` on ``device`` (the card unless the caller asks
    for the CPU; it raises without CUDA), and a 120x160 pair on that
    device: a float32 RGB image uniform in [0, 255) from seed 0 and the
    same image rolled 3 columns right."""
    cfg = (default_config(max_disp=MAX_DISP) if preset is None
           else get_model(preset, max_disp=MAX_DISP))
    fn = StereoPipeline(cfg, device=device)
    gen = torch.Generator().manual_seed(0)
    left = (torch.rand(*SHAPE, 3, generator=gen) * 255.0).to(fn.device)
    right = torch.roll(left, 3, dims=1)
    return fn, (left, right)
