"""The gather and prefix-sum probes on a float32 plane, on no pipeline path.

Counterpart of ``scripts/micro4.py``, the TPU probe of the NL tree
filter's primitive moves: ``take_along_axis`` along axis 0 and axis 1 and
``cumsum`` along axis 0 and axis 1 of a [375, 450] float32 plane. Their
kernels are ``cuda_kernels.gather_rows``, ``gather_cols`` and ``cumsum``
(``csrc/plane_probes.cu``), which ``tools/micro4.py`` times and holds
against the plain versions here.

The gathers equal ``torch.gather`` bit for bit. The kernels' cumsums add
in sequential float32 order, so they equal :func:`cumsum_sequential` bit
for bit. ``torch.cumsum`` on the card sums in a parallel scan's order, so
it is held to a float64 cumsum, rounded to float32, within
:func:`cumsum_tolerance`.
"""

from __future__ import annotations

import numpy as np
import torch

U32 = 2.0 ** -24  # unit roundoff of float32


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[a, b] = x[idx[a, b], b] (``jnp.take_along_axis(x, idx, 0)``)."""
    return torch.gather(x, 0, idx.to(torch.int64))


def gather_cols_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[a, b] = x[a, idx[a, b]] (``jnp.take_along_axis(x, idx, 1)``)."""
    return torch.gather(x, 1, idx.to(torch.int64))


def cumsum_plain(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.cumsum(x, axis)


def cumsum_sequential(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The kernels' own sums: float32 partial sums along ``axis`` added in
    sequential order (numpy's accumulate), on x's device. The cumsum
    kernels equal it bit for bit."""
    return torch.from_numpy(np.cumsum(x.cpu().numpy(), axis, dtype=np.float32)).to(x.device)


def cumsum_reference(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The float64 cumsum of x along ``axis``, rounded to float32."""
    return torch.cumsum(x.to(torch.float64), axis).to(torch.float32)


def cumsum_tolerance(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-element bound on |s - cumsum_reference(x)| for any float32 sum
    s of the same k terms, in any order: (k + 1) u sum_{i<=k} |x_i|, u =
    2^-24. The sum's own rounding contributes at most (k - 1) u sum |x_i|
    (to first order; the extra term covers the second), the reference's
    rounding to float32 at most u |sum x_i|."""
    k = torch.arange(1, x.shape[axis] + 1, dtype=torch.float64, device=x.device)
    k = k[:, None] if axis == 0 else k[None, :]
    return ((k + 1) * U32 * torch.cumsum(x.abs().to(torch.float64), axis)).to(torch.float32)


def cumsum_error(got: torch.Tensor, x: torch.Tensor, axis: int) -> float:
    """The largest |got - reference| over :func:`cumsum_tolerance`: within
    the bound where at most 1."""
    diff = (got.to(torch.float64) - cumsum_reference(x, axis).to(torch.float64)).abs()
    return float((diff / cumsum_tolerance(x, axis).to(torch.float64)).max())
