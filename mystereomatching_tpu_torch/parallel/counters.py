"""Communication counters of the row-band pipeline.

Counterpart of ``mystereomatching_tpu/parallel/counters.py``. Each rank
records the exchanges it takes part in, as they happen: every halo
exchange's bytes sent, every SGM wavefront's chunk steps and boundary rows
sent, every all-gather of the disparity blocks over the 'disp' group, and
every gather's bytes contributed. A rank's record is its own;
summing over ranks gives the traffic of a frame.

Usage::

    with record_comm() as rec:
        ...                        # the band pipeline on this rank
    rec.summary()

Recording costs one global check a call when inactive.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

_active: Optional["CommRecord"] = None


class CommRecord:
    def __init__(self):
        self.events: List[dict] = []

    def add(self, **ev):
        self.events.append(ev)

    def _of(self, kind: str):
        return [e for e in self.events if e["kind"] == kind]

    def total_bytes(self) -> int:
        return sum(e["bytes"] for e in self.events)

    def summary(self) -> dict:
        halo, wave, gather = self._of("halo"), self._of("wavefront"), self._of("gather")
        all_gather = self._of("all_gather")
        return {
            "halo_exchanges": len(halo),
            "halo_bytes": sum(e["bytes"] for e in halo),
            "wavefront_scans": len(wave),
            "wavefront_steps": [e["steps"] for e in wave],
            "wavefront_chunks": [e["chunks"] for e in wave],
            "wavefront_bytes": sum(e["bytes"] for e in wave),
            "all_gathers": len(all_gather),
            "all_gather_bytes": sum(e["bytes"] for e in all_gather),
            "gathers": len(gather),
            "gather_bytes": sum(e["bytes"] for e in gather),
            "total_bytes": self.total_bytes(),
        }


@contextlib.contextmanager
def record_comm():
    global _active
    rec = CommRecord()
    prev, _active = _active, rec
    try:
        yield rec
    finally:
        _active = prev


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def note_halo(x: torch.Tensor, halo: int, row_axis: int, sends: int, stage: str = "") -> None:
    """One exchange_rows call: this rank sent ``halo`` rows of x to each of
    its ``sends`` neighbouring bands."""
    if _active is None:
        return
    shape = list(x.shape)
    shape[row_axis] = halo
    _active.add(kind="halo", stage=stage, bytes=sends * _nbytes(shape, x.dtype))


def note_wavefront(chunks: int, bands: int, boundary_shape, dtype: torch.dtype, sends: int,
                   stage: str = "sgm") -> None:
    """One wavefront scan over ``bands`` row bands in ``chunks`` W chunks:
    chunks + bands - 1 chunk steps from the first band's first chunk to the
    last band's last (efficiency chunks / steps), and ``sends`` boundary
    rows of ``boundary_shape`` sent by this rank."""
    if _active is None:
        return
    _active.add(kind="wavefront", stage=stage, chunks=int(chunks),
                steps=int(chunks + bands - 1),
                bytes=int(sends) * _nbytes(boundary_shape, dtype))


def note_all_gather(x: torch.Tensor, axis_ranks: int, stage: str = "") -> None:
    """One all-gather over ``axis_ranks`` ranks: this rank sent its block x
    to each of the other ranks of the group."""
    if _active is None:
        return
    _active.add(kind="all_gather", stage=stage,
                bytes=(axis_ranks - 1) * _nbytes(x.shape, x.dtype))


def note_gather(x: torch.Tensor, stage: str = "") -> None:
    """One gather: this rank sent its block x to the gathering rank."""
    if _active is None:
        return
    _active.add(kind="gather", stage=stage, bytes=_nbytes(x.shape, x.dtype))
