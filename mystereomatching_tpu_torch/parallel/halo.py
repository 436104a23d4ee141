"""Row-halo exchange between neighbouring row bands.

Counterpart of ``mystereomatching_tpu/parallel/halo.py``. Windowed stages
(census, arms, CBCA, region vote, proper interpolation, medians) need up
to ``halo`` rows of the bands above and below: each rank sends its first
``halo`` rows up and its last ``halo`` rows down, point to point, computes
on the extended band and crops. At the true picture borders the halo is
filled by the caller's pad mode, the border handling the dense stage
itself would apply.
"""

from __future__ import annotations

import torch

from mystereomatching_tpu_torch.parallel.counters import note_halo
from mystereomatching_tpu_torch.parallel.mesh import RowMesh, sendrecv

PAD_MODES = ("edge", "reflect101", "zero")


def _border_fill(x: torch.Tensor, halo: int, row_axis: int, pad_mode, top: bool) -> torch.Tensor:
    h = x.shape[row_axis]
    if pad_mode == "edge":
        row = x.narrow(row_axis, 0 if top else h - 1, 1)
        return row.repeat_interleave(halo, dim=row_axis)
    if pad_mode == "reflect101":
        # virtual row -k = row k; virtual row H-1+k = row H-1-k
        return x.narrow(row_axis, 1 if top else h - 1 - halo, halo).flip(row_axis)
    shape = list(x.shape)
    shape[row_axis] = halo
    if pad_mode == "zero":
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    return torch.full(shape, pad_mode, dtype=x.dtype, device=x.device)


def exchange_rows(x: torch.Tensor, halo: int, mesh: RowMesh, row_axis: int = 0,
                  pad_mode="edge", stage: str = "") -> torch.Tensor:
    """x extended by ``halo`` rows of the band above and of the band below
    (along ``row_axis``). The first and last bands fill their outer side by
    ``pad_mode``: 'edge', 'reflect101', 'zero' or a number. Raises when the
    band is shorter than the halo (reflect101 needs one row more): the
    rows would have to come from beyond the neighbouring band."""
    if halo == 0:
        return x
    if not (pad_mode in PAD_MODES or isinstance(pad_mode, (int, float))) \
            or isinstance(pad_mode, bool):
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    h = x.shape[row_axis]
    need = halo + 1 if pad_mode == "reflect101" else halo
    if h < need:
        raise ValueError(f"exchange_rows: a band of {h} rows cannot give a halo of {halo} "
                         f"rows{' with reflect101' if need > halo else ''}; use fewer bands")
    i, n = mesh.row_index, mesh.n_row
    sends, recvs = [], []
    shape = list(x.shape)
    shape[row_axis] = halo
    if i > 0:          # my first rows go up; the band above's last rows come down
        sends.append((x.narrow(row_axis, 0, halo), mesh.row_peer(i - 1)))
        recvs.append((shape, x.dtype, mesh.row_peer(i - 1)))
    if i < n - 1:      # my last rows go down; the band below's first rows come up
        sends.append((x.narrow(row_axis, h - halo, halo), mesh.row_peer(i + 1)))
        recvs.append((shape, x.dtype, mesh.row_peer(i + 1)))
    note_halo(x, halo, row_axis, len(sends), stage)
    got = sendrecv(mesh, sends, recvs)
    above = got.pop(0) if i > 0 else _border_fill(x, halo, row_axis, pad_mode, top=True)
    below = got.pop(0) if i < n - 1 else _border_fill(x, halo, row_axis, pad_mode, top=False)
    return torch.cat([above, x, below], row_axis)


def crop_rows(x: torch.Tensor, halo: int, row_axis: int = 0) -> torch.Tensor:
    """The band without its ``halo`` rows on either side."""
    if halo == 0:
        return x
    return x.narrow(row_axis, halo, x.shape[row_axis] - 2 * halo)
