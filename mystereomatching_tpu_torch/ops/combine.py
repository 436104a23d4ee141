"""Volume combiners and the merges of double-window CBCA (``cbca_double_win``).

Counterpart of ``mystereomatching_tpu/ops/combine.py``: the merges
``combine2vm_pkr``, ``combine2vm_arm_limit``, ``combine2vm_min`` and
``combine2vm_4`` (the reference's combine2Vm, _2, _3 and _4,
cpp:4142-4331), each merging the small-window CBCA volume ``vm`` with the
large-window one ``vm2`` a disparity vector at a time; and the combiners
no pipeline of the JAX package calls, ``exp_adaptive_fuse``,
``min_combine``, ``weighted_combine``, ``combine_cross_fw`` and
``combine_hv_tilt``. The JAX module has no Pallas kernel, so neither has
this. The blends round as jitted XLA-CPU computes them (see each).
"""

from __future__ import annotations

import numpy as np
import torch

from mystereomatching_tpu_torch.ops.cost import _div, exp32, fma32, mul_rec
from mystereomatching_tpu_torch.ops.refine import pkr_mask
from mystereomatching_tpu_torch.ops.volume import pad_reflect101


def combine2vm_pkr(vm: torch.Tensor, vm2: torch.Tensor, pkr_thresh: float = 0.1,
                   w: float = 0.3) -> torch.Tensor:
    """combine2Vm (cpp:4142-4170): where vm's peak ratio marks the pixel
    ambiguous (``refine.pkr_mask``), the blend vm w + vm2 (1 - w), else vm.
    The blend as jitted XLA-CPU contracts it: fma(vm2, 1 - w, vm w) (the
    other orders differ from the jitted JAX function at 946 and 985 of
    49,152 entries of two seeded volumes)."""
    blend = fma32(vm2, 1.0 - w, vm * float(np.float32(w)))
    return torch.where(pkr_mask(vm, pkr_thresh)[None], blend, vm)


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
    if cbca_combine == 1:
        return combine2vm_pkr(vm, vm2)
    if cbca_combine == 2:
        return combine2vm_arm_limit(vm, vm2, arms_view)
    if cbca_combine == 3:
        return combine2vm_min(vm, vm2)
    if cbca_combine == 4:
        return combine2vm_4(vm, vm2, arms_left)
    raise ValueError(f"unknown cbca_combine {cbca_combine}")


def exp_adaptive_fuse(vm0: torch.Tensor, vm1: torch.Tensor, arms: torch.Tensor, lam0: float,
                      lam1: float, k: float = 0.5) -> torch.Tensor:
    """gen_vm_from2vm_expadpWgt (cpp:3696-3724): a = 1 - exp(-k / shortest
    arm) per pixel, out = a (1 - e^(-vm0 / lam0)) + (1 - a) (1 - e^(-vm1 /
    lam1)). Divisions by constants as reciprocal products and the last sum
    one fused multiply-add, as jitted XLA-CPU computes them; ``exp`` is
    ``cost.exp32``."""
    shortest = torch.clamp(arms[:4].amin(0), min=1).to(torch.float32)
    a = (1.0 - exp32(-k / shortest))[None]
    t0 = 1.0 - exp32(mul_rec(-vm0, lam0))
    t1 = 1.0 - exp32(mul_rec(-vm1, lam1))
    return fma32(a, t0, (1.0 - a) * t1)


def min_combine(vm0: torch.Tensor, vm1: torch.Tensor) -> torch.Tensor:
    """cross2Vm (h:2597-2614): the elementwise min of two volumes."""
    return torch.minimum(vm0, vm1)


def weighted_combine(vm0: torch.Tensor, w0: float, vm1: torch.Tensor,
                     w1: float) -> torch.Tensor:
    """fuse_2vm (h:2577-2595): w0 vm0 + w1 vm1, as jitted XLA-CPU contracts
    it: fma(vm0, w0, w1 vm1)."""
    return fma32(vm0, w0, vm1 * float(np.float32(w1)))


def combine_cross_fw(vm_cross: torch.Tensor, vm_fw: torch.Tensor, arms_int: torch.Tensor,
                     fw_type: int = 4, arm_len_limit: int = 12, arm_l_sum: int = 8,
                     arm_l_single: int = 6, cost_compare: bool = True,
                     area_is=None) -> torch.Tensor:
    """combine_Cross_FW (cpp:5803-5862): the fixed-window volume where the
    intersected cross support ([4, D, H, W] arms) is too small. Type 1: the
    arm sum under ``arm_len_limit``; type 3: the aggregated support area
    ``area_is`` [D, H, W] under 5; type 4 (the default): the arm sum under
    ``arm_l_sum`` and both axes' sums under ``arm_l_single``, taking
    min(cross, FW) with ``cost_compare``, else FW."""
    arm_sum = arms_int[:4].to(torch.int32).sum(0)
    if fw_type == 1:
        return torch.where(arm_sum < arm_len_limit, vm_fw, vm_cross)
    if fw_type == 3:
        if area_is is None:
            raise ValueError("combine_Cross_FW type 3 needs area_is "
                             "(the aggregated intersected support area)")
        return torch.where(area_is < 5, vm_fw, vm_cross)
    if fw_type == 4:
        # the per-axis sums in the arms' own dtype, as in the JAX package
        # (int8 intersected arms wrap past 127 there too)
        take = (arm_sum < arm_l_sum) & (arms_int[0] + arms_int[1] < arm_l_single) & (
            arms_int[2] + arms_int[3] < arm_l_single)
        fw = torch.minimum(vm_cross, vm_fw) if cost_compare else vm_fw
        return torch.where(take, fw, vm_cross)
    raise ValueError(f"unknown combine_Cross_FW type {fw_type}")


def combine_hv_tilt(vm_hv: torch.Tensor, vm_tilt: torch.Tensor, arms_hv: torch.Tensor,
                    arms_tilt: torch.Tensor) -> torch.Tensor:
    """combine_HV_Tilt (cpp:3994-4085) with compareArmL (cpp:6912-6923): per
    pixel the HV-aggregated volume where the HV arms' total is strictly
    longer than the tilted arms', else the tilted one."""
    len_hv = arms_hv[:4].to(torch.int32).sum(0)
    len_tilt = arms_tilt[:4].to(torch.int32).sum(0)
    return torch.where((len_hv > len_tilt)[None], vm_hv, vm_tilt)
