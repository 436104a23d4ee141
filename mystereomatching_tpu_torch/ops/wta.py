"""Disparity decision: winner-take-all over the disparity axis.

Counterpart of ``wta.wta`` in ``mystereomatching_tpu/ops/wta.py``
(gen_dispFromVm cpp:3928-3967). CUDA kernel D (``csrc/wta.cu``) on a CUDA
tensor.
"""

from __future__ import annotations

import torch

from mystereomatching_tpu_torch.ops import cuda_kernels as ck


def wta_plain(vol: torch.Tensor, choose_small: bool = True) -> torch.Tensor:
    """Plain torch WTA: first-occurrence argmin (argmax unless
    choose_small) over D of [D, H, W] -> int32 [H, W]."""
    arg = torch.argmin(vol, 0) if choose_small else torch.argmax(vol, 0)
    return arg.to(torch.int32)


def wta(vol: torch.Tensor, choose_small: bool = True) -> torch.Tensor:
    if ck.on_cuda(vol):
        return ck.wta(vol, choose_small)
    return wta_plain(vol, choose_small)
