"""The taps probes' plain versions, on no pipeline path.

Counterpart of the TPU probes of kernel B's taps pass in ``scripts/``:
``micro3.py``'s ``_kb`` (rolled registers) and ``_kc`` (dynamic slices of a
zero-padded scratch), ``micro_cbca2.py``'s ``_taps_kernel_fixed``,
``_taps_kernel_seg`` and ``_taps_kernel_clones`` (also in
``micro_cbca3.py``), ``micro_cbca3.py``'s ``_taps_kernel_oct`` and
``_taps_kernel_clseg``, and ``micro_cbca5.py``'s ``_taps_kernel_static``.
Each is an arm-bounded sum of a float32 volume [N, H, W] along H (axis 1)
or W (axis 2) with int arms [N, H, W] of at most ``max_arm``; arms above it
are capped there. Their kernels are ``cuda_kernels.taps_probe_roll``,
``taps_probe_slice``, ``taps_probe_clones`` and ``taps_probe_static``
(``csrc/taps_probes.cu``), which ``tools/taps_probes.py`` times and holds
against the functions here bit for bit.

Every probe adds in the production ``_taps_kernel``'s order, not kernel
B's: from the centre value, for k = 1, 2, ..., max_arm the forward tap
(masked by ap >= k) and then the backward tap (an >= k), a masked tap
adding +0.0. Kernel B adds in ascending offset, so the probes agree with it
within rounding only. A probe whose trip count stops at its block's largest
arm adds fewer masked +0.0s, which changes no value (at most the sign of a
zero).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _taps(vol: torch.Tensor, an: torch.Tensor, ap: torch.Tensor, max_arm: int, fwd, bwd):
    """vol plus, for k = 1 .. max_arm, fwd(k) where ap >= k and then bwd(k)
    where an >= k, each add rounded in float32."""
    an, ap = an.clamp(max=max_arm), ap.clamp(max=max_arm)
    acc = vol.clone()
    for k in range(1, max_arm + 1):
        acc = acc + torch.where(ap >= k, fwd(k), 0.0)
        acc = acc + torch.where(an >= k, bwd(k), 0.0)
    return acc


def bounded_plain(vol: torch.Tensor, an: torch.Tensor, ap: torch.Tensor, axis: int,
                  max_arm: int) -> torch.Tensor:
    """The zero-padded sum: vol[x + k e] for k in [-an, ap], 0 off the image.
    ``_kc``, ``_seg``, ``_clones``, ``_oct``, ``_clseg`` and ``_static``
    compute it."""
    n = vol.shape[axis]
    pad = [0, 0] * (vol.ndim - 1 - axis) + [max_arm, max_arm]
    padded = F.pad(vol, pad)
    return _taps(vol, an, ap, max_arm, lambda k: padded.narrow(axis, max_arm + k, n),
                 lambda k: padded.narrow(axis, max_arm - k, n))


def circular_plain(vol: torch.Tensor, an: torch.Tensor, ap: torch.Tensor, axis: int,
                   max_arm: int) -> torch.Tensor:
    """``_kb``'s sum: the taps wrap around the whole axis (vol[(x + k) mod n]).
    It equals :func:`bounded_plain` wherever no arm reaches past the image
    edge, as real arms never do."""
    return _taps(vol, an, ap, max_arm, lambda k: torch.roll(vol, -k, axis),
                 lambda k: torch.roll(vol, k, axis))


def fixed_plain(vol: torch.Tensor, an: torch.Tensor, ap: torch.Tensor,
                max_arm: int) -> torch.Tensor:
    """``_taps_kernel_fixed``'s sum along H, wrong by design (a timing
    floor): every tap reads the scratch at its aligned base m - m % 8, that
    is vol shifted down by m % 8 rows, zero-filled, added once for each
    k <= min(arm, m) on each side."""
    shift = max_arm % 8
    shifted = F.pad(vol, [0, 0, shift, 0])[:, :vol.shape[1]]
    return _taps(vol, an, ap, max_arm, lambda k: shifted, lambda k: shifted)
