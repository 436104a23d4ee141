"""The copy-bandwidth probe: out = x * 1.0001, on no pipeline path.

Counterpart of ``copy_kern`` in ``scripts/check_bw.py``, the TPU probe that
times a scaled copy in several VMEM block shapes. Its kernel is
``cuda_kernels.copy_bw`` (``csrc/copy_bw.cu``), which ``tools/check_bw.py``
times and holds against the plain version here.
"""

from __future__ import annotations

import torch

COPY_SCALE = 1.0001


def scaled_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """x * 1.0001 in x's float32, rounded once: the kernel's result bit for bit."""
    return x * COPY_SCALE

