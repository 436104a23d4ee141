"""The SGM-layout probes' plain versions, on no pipeline path.

Counterpart of ``scripts/check_sgm3.py``, ``check_sgm4.py`` and
``check_sgm5.py``, the TPU probes of kernel C's layout: the SGM scan down H
of float32 volumes laid out [G, H, D, W] (the D values of a row together),
with penalty scales ps [G, H, W], from a zero carry, p1 = 1, p2 = 3, and
``check_sgm5.py``'s two trivial row bodies. Their kernels are
``cuda_kernels.sgm_probe_hdw``, ``sgm_probe_g``, ``sgm_probe_rolled`` and
``sgm_probe_unrolled`` (``csrc/sgm_probes.cu``), which
``tools/sgm_layouts.py`` times and holds against the functions here bit
for bit, and the ``full`` kinds against kernel C.
"""

from __future__ import annotations

import torch

from mystereomatching_tpu_torch.ops import sgm as sgm_ops
from mystereomatching_tpu_torch.ops.cuda_kernels import SGM_PROBE_P1, SGM_PROBE_P2


def full_plain(vol: torch.Tensor, ps: torch.Tensor) -> torch.Tensor:
    """The recurrence of every full kind: kernel C's downward scan
    (``sgm.sgm_scan_plain`` along H) of the [G, D, H, W] transpose,
    transposed back. Its edge beyond D, FLT_MAX, stands for the probes'
    3.4e38 too: neither ever wins a min of finite costs below it."""
    down = sgm_ops.sgm_scan_plain(vol.transpose(1, 2), ps, SGM_PROBE_P1, SGM_PROBE_P2, axis=2,
                                  reverse=False)
    return down.transpose(1, 2).contiguous()


def copy_plain(vol: torch.Tensor) -> torch.Tensor:
    """``check_sgm5.py``'s copy body: vol * 1.01 (float32)."""
    return vol * 1.01


def prev_plain(vol: torch.Tensor) -> torch.Tensor:
    """``check_sgm5.py``'s prev body: L(r) = C(r) + L(r - 1) * 0.5 down H,
    from L(-1) = 0."""
    out = torch.empty_like(vol)
    prev = torch.zeros_like(vol[:, 0])
    for r in range(vol.shape[1]):
        prev = vol[:, r] + prev * 0.5
        out[:, r] = prev
    return out


def plain(vol: torch.Tensor, ps: torch.Tensor, kind: str) -> torch.Tensor:
    """The plain version of a probe's ``kind``: ``full``, ``copy`` or ``prev``."""
    if kind == "full":
        return full_plain(vol, ps)
    return copy_plain(vol) if kind == "copy" else prev_plain(vol)
