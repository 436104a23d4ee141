"""The merges of double-window CBCA (``cbca_double_win``).

Counterpart of ``combine2vm_arm_limit``, ``combine2vm_min`` and
``combine2vm_4`` of ``mystereomatching_tpu/ops/combine.py`` (the reference's
combine2Vm_2, _3 and _4, cpp:4173-4331): each merges the small-window CBCA
volume ``vm`` with the large-window one ``vm2``, a disparity vector at a
time. ``combine2vm_pkr`` (``cbca_combine=1``) needs the peak-ratio mask of
PKR, which is not ported. The JAX module has no Pallas kernel, so neither
has this.
"""

from __future__ import annotations

import torch

from mystereomatching_tpu_torch.ops.cost import _div
from mystereomatching_tpu_torch.ops.volume import pad_reflect101


def combine2vm_arm_limit(vm: torch.Tensor, vm2: torch.Tensor, arms: torch.Tensor,
                         arm_limit: int = 10, w: float = 0.3) -> torch.Tensor:
    """combine2Vm_2 (cpp:4173-4228): vm w + vm2 (1 - w) where all four of
    the view's arms [4, H, W] are at most ``arm_limit``, else vm."""
    small = (arms[:4] <= arm_limit).all(0)[None]
    return torch.where(small, vm * w + vm2 * (1.0 - w), vm)


def combine2vm_min(vm: torch.Tensor, vm2: torch.Tensor, dis_thres: float = 0.0,
                   w: float = 0.3) -> torch.Tensor:
    """combine2Vm_3 (cpp:4217-4271): where min_d vm2 < min_d vm and the
    relative gain (min vm - min vm2) / min vm exceeds ``dis_thres`` (+inf
    where min vm is 0), the whole vector w vm + (1 - w) vm2, else vm."""
    c0 = vm.amin(0)
    c1 = vm2.amin(0)
    take = (c1 < c0) & ((c0 - c1) / c0 > dis_thres)
    return torch.where(take[None], w * vm + (1.0 - w) * vm2, vm)


def combine2vm_4(vm: torch.Tensor, vm2: torch.Tensor, arms_left: torch.Tensor,
                 arm_thres: float = 5.0) -> torch.Tensor:
    """combine2Vm_4 (cpp:4273-4331), the preset's merge: the longest of the
    LEFT image's four small-window arms at each pixel, its 3x3 mean with a
    reflect-101 border (cv::boxFilter), and vm2's whole vector where that
    mean is under ``arm_thres``, else vm's. Both views' volumes take the
    left image's mask, as in the reference."""
    arm_lst = arms_left[:4].amax(0).to(vm.dtype)
    h, w = arm_lst.shape
    p = pad_reflect101(arm_lst, 1)
    sm = _div(sum(p[i:i + h, j:j + w] for i in range(3) for j in range(3)), 9.0)
    return torch.where((sm < arm_thres)[None], vm2, vm)


def combine(vm: torch.Tensor, vm2: torch.Tensor, cbca_combine: int, arms_view: torch.Tensor,
            arms_left: torch.Tensor) -> torch.Tensor:
    """The merge ``cbca_combine`` names, as the JAX ``compute_volumes`` calls
    it: arms_view the volume's own view's small-window arms, arms_left the
    left image's."""
    if cbca_combine == 2:
        return combine2vm_arm_limit(vm, vm2, arms_view)
    if cbca_combine == 3:
        return combine2vm_min(vm, vm2)
    if cbca_combine == 4:
        return combine2vm_4(vm, vm2, arms_left)
    raise NotImplementedError(f"cbca_combine {cbca_combine} (combine2vm_pkr needs PKR, "
                              "which is not ported)")
