"""The ranks of the row-band pipeline and their process groups.

Counterpart of ``mystereomatching_tpu/parallel/mesh.py`` (``make_mesh``,
``initialize_multihost``). A world of ``n_data * n_row * n_disp`` ranks, one
process each, in the JAX mesh's order: rank = (data_index * n_row +
row_index) * n_disp + disp_index. Stereo pairs are split over the
``'data'`` axis, image rows over the ``'row'`` axis, and the disparities of
the volume-building stage over the ``'disp'`` axis. Each rank has a
``'row'`` group (the bands of its pairs with its disparity index), a
``'data'`` group (its band and disparity index of the other pairs) and,
with ``n_disp > 1``, a ``'disp'`` group (the disparity blocks of its band),
made with ``dist.new_group``.

The backend is the caller's choice: NCCL when every rank has a card of its
own, gloo on the CPU and where several ranks share one card. gloo moves
CPU tensors only, so there the rows a rank exchanges are copied through
host memory and back to its device; every stage still computes on the
rank's device.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class RowMesh:
    """One rank's place in the ('data', 'row', 'disp') world."""

    rank: int
    n_data: int
    n_row: int
    device: torch.device
    backend: str
    n_disp: int = 1
    row_group: Optional[object] = None
    data_group: Optional[object] = None
    disp_group: Optional[object] = None

    @property
    def disp_index(self) -> int:
        return self.rank % self.n_disp

    @property
    def row_index(self) -> int:
        return self.rank // self.n_disp % self.n_row

    @property
    def data_index(self) -> int:
        return self.rank // (self.n_disp * self.n_row)

    def row_peer(self, row_index: int) -> int:
        """The global rank of band ``row_index`` of this rank's pairs, with
        this rank's disparity index."""
        return (self.data_index * self.n_row + row_index) * self.n_disp + self.disp_index

    @property
    def host_transport(self) -> bool:
        """True where exchanged tensors go through host memory (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def default_backend(devices: Sequence[str]) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def init_mesh(rank: int, n_row: int, n_data: int, device, backend: str,
              init_method: str, timeout_s: float = 600.0, n_disp: int = 1) -> RowMesh:
    """Joins the world as ``rank`` and makes every rank's 'row', 'data' and
    (n_disp > 1) 'disp' groups (each rank makes all of them, in the same
    order). init_method is the rendezvous, e.g. ``file:///tmp/dir/store``.
    Ends with a barrier, so that NCCL's communicator exists before the
    first point-to-point call."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not one of {BACKENDS}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device, rank {rank} has {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(0, device=device)           # the card's context, before any stat
    world = n_row * n_data * n_disp
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))

    def at(d, i, k):
        return (d * n_row + i) * n_disp + k

    rows: List[object] = [dist.new_group([at(d, i, k) for i in range(n_row)])
                          for d in range(n_data) for k in range(n_disp)]
    datas: List[object] = [dist.new_group([at(d, i, k) for d in range(n_data)])
                           for i in range(n_row) for k in range(n_disp)]
    disps: List[object] = [dist.new_group([at(d, i, k) for k in range(n_disp)])
                           for d in range(n_data) for i in range(n_row)] if n_disp > 1 else []
    mesh = RowMesh(rank, n_data, n_row, device, backend, n_disp)
    mesh.row_group = rows[mesh.data_index * n_disp + mesh.disp_index]
    mesh.data_group = datas[mesh.row_index * n_disp + mesh.disp_index]
    if disps:
        mesh.disp_group = disps[mesh.data_index * n_row + mesh.row_index]
    if backend == "nccl":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()
    return mesh


def sendrecv(mesh: RowMesh, sends, recvs) -> List[torch.Tensor]:
    """Point-to-point exchange, all posted together: sends is a list of
    (tensor, peer rank), recvs of (shape, dtype, peer rank). Returns the
    received tensors on the rank's device."""
    host = mesh.host_transport
    ops, bufs = [], []
    for t, peer in sends:
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if host else t, peer))
    for shape, dtype, peer in recvs:
        buf = torch.empty(shape, dtype=dtype, device="cpu" if host else mesh.device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(mesh.device) for b in bufs]


def all_gather_disp(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    """The blocks t of every rank of this rank's 'disp' group concatenated
    along axis 0, in disparity order, on the rank's device."""
    t = t.contiguous()
    if mesh.host_transport:
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(mesh.n_disp)]
    dist.all_gather(parts, t, group=mesh.disp_group)
    return torch.cat(parts, 0).to(mesh.device)
