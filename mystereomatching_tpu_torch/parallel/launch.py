"""Launching the row-band pipeline: one process a rank.

Plays the part of ``shard_map``'s in and out specs in the JAX package: it
starts ``n_data * n_row * n_disp`` processes (spawned, so that no parent
state is inherited), joins them into one ``torch.distributed`` world
(:func:`mesh.init_mesh`, rendezvous through a file in a fresh temporary
directory), hands each rank its rows of the inputs, runs the band
pipeline and gathers the bands of disparity index 0 (the result is
replicated over 'disp') on rank 0, along the 'row' group and then the
'data' group. A rank that raises ends the run: the other ranks are
terminated and the error is raised here.

:func:`run_row_bands` is the entry point of the pipeline
(``sharded_match_pair``). :func:`run_ranks` runs any rank function
``fn(mesh, *args)`` of an importable module in such a world.
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mystereomatching_tpu_torch.config import MatchConfig, as_port_config
from mystereomatching_tpu_torch.parallel.counters import note_gather
from mystereomatching_tpu_torch.parallel.mesh import RowMesh, default_backend, init_mesh
from mystereomatching_tpu_torch.parallel.sharded import _match_pair_band, check_sharded_support


def band_rows(x: torch.Tensor, mesh: RowMesh, row_axis: int) -> torch.Tensor:
    """This rank's band of x along ``row_axis`` (which n_row must divide)."""
    n = x.shape[row_axis]
    if n % mesh.n_row:
        raise ValueError(f"{n} rows do not split into {mesh.n_row} bands")
    h = n // mesh.n_row
    return x.narrow(row_axis, mesh.row_index * h, h).contiguous()


def band_pairs(x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """This rank's pairs of a [B, ...] batch (which n_data must divide)."""
    b = x.shape[0]
    if b % mesh.n_data:
        raise ValueError(f"{b} pairs do not split over {mesh.n_data} data ranks")
    per = b // mesh.n_data
    return x[mesh.data_index * per:(mesh.data_index + 1) * per]


def band_pipeline(mesh: RowMesh, left, right, cfg: MatchConfig, n_chunks: int) -> torch.Tensor:
    """The pipeline on this rank's band of its pairs: left/right [B, H, W, 3]
    -> [B / n_data, H / n_row, W] float32 disparities."""
    check_sharded_support(cfg, mesh.n_disp)
    lb = band_rows(band_pairs(torch.as_tensor(left), mesh), mesh, 1)
    rb = band_rows(band_pairs(torch.as_tensor(right), mesh), mesh, 1)
    lb = lb.to(mesh.device, torch.float32)
    rb = rb.to(mesh.device, torch.float32)
    return torch.stack([_match_pair_band(lb[i], rb[i], cfg, n_chunks, mesh)
                        for i in range(lb.shape[0])])


def _gather(t: torch.Tensor, axis: int, group, root: int, mesh: RowMesh):
    """The blocks of every rank of ``group`` concatenated along ``axis`` on
    ``root`` (None elsewhere), in the group's rank order."""
    note_gather(t, stage="result")
    size = dist.get_world_size(group)
    t = t.contiguous()
    if mesh.host_transport:
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(size)] if mesh.rank == root else None
    dist.gather(t, parts, dst=root, group=group)
    return torch.cat(parts, axis).to(mesh.device) if parts is not None else None


def gather_bands(t: torch.Tensor, mesh: RowMesh, row_axis: int,
                 batch_axis: Optional[int] = None) -> Optional[torch.Tensor]:
    """Every rank's block t on rank 0 (None elsewhere): the bands along
    'row' (on ``row_axis``) on each data group's band 0, then the pairs
    along 'data' (on ``batch_axis``). Only the ranks of disparity index 0
    take part: the result is the same at every index."""
    if mesh.disp_index:
        return None
    result = _gather(t, row_axis, mesh.row_group, mesh.row_peer(0), mesh)
    if mesh.n_data > 1 and mesh.row_index == 0:
        if batch_axis is None:
            raise ValueError("a result over several data ranks needs a batch axis")
        result = _gather(result, batch_axis, mesh.data_group, 0, mesh)
    return result if mesh.rank == 0 else None


def _pipeline_rank(mesh: RowMesh, left, right, cfg: MatchConfig, n_chunks: int):
    """Rank job of :func:`run_row_bands`: the band pipeline, gathered as
    numpy on rank 0."""
    disp = gather_bands(band_pipeline(mesh, left, right, cfg, n_chunks), mesh, 1, 0)
    return disp.cpu().numpy() if disp is not None else None


def _worker(rank: int, n_row: int, n_data: int, n_disp: int, devices, backend: str,
            init_method: str, fn: Callable, args: tuple, out_queue) -> None:
    device = torch.device(devices[rank])
    if device.type == "cpu":
        torch.set_num_threads(1)
    mesh = init_mesh(rank, n_row, n_data, device, backend, init_method, n_disp=n_disp)
    try:
        out_queue.put((rank, fn(mesh, *args)))
    finally:
        dist.destroy_process_group()


def _resolve_devices(devices, world: int) -> List[str]:
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            raise RuntimeError(f"{world} ranks need {world} CUDA devices, one a rank; "
                               f"{have} found (pass devices=['cuda:0'] * {world} to share "
                               f"one, or devices=['cpu'] * {world})")
        devices = [f"cuda:{i}" for i in range(world)]
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if any(torch.device(d).type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("CUDA devices requested but CUDA is not available")
    return devices


def run_ranks(fn: Callable, args: tuple, n_row: int, n_data: int = 1, devices=None,
              backend: Optional[str] = None, n_disp: int = 1) -> list:
    """Runs fn(mesh, *args) on a world of n_data x n_row x n_disp ranks, one
    process each, and returns each rank's value in rank order. fn must be a
    function of an importable module (the ranks are spawned). devices: one
    a rank (default: one card a rank, raising when there are fewer);
    backend: 'nccl' or 'gloo' (default: NCCL when every rank has a card of
    its own, else gloo)."""
    world = n_row * n_data * n_disp
    devices = _resolve_devices(devices, world)
    backend = backend or default_backend(devices)
    tmp = tempfile.mkdtemp(prefix="mysm_rows_")
    out_queue = mp.get_context("spawn").Queue()
    values, done = [None] * world, [False] * world

    def drain(block: bool):
        while True:
            try:
                rank, value = out_queue.get(timeout=0.2 if block else 0.0)
            except queue_mod.Empty:
                return
            values[rank], done[rank] = value, True
            block = False

    try:
        procs = mp.start_processes(
            _worker, args=(n_row, n_data, n_disp, devices, backend,
                           "file://" + os.path.join(tmp, "store"), fn, args, out_queue),
            nprocs=world, join=False, start_method="spawn")
        while not procs.join(timeout=0.1):
            drain(block=True)
        drain(block=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [r for r in range(world) if not done[r]]
    if missing:
        raise RuntimeError(f"ranks ended without reporting: {missing}")
    return values


def run_row_bands(left, right, cfg: MatchConfig, n_row: int, n_data: int = 1,
                  n_chunks: int = 8, devices=None, backend: Optional[str] = None,
                  n_disp: int = 1):
    """The row-band pipeline (the JAX ``sharded_match_pair``): left/right
    [B, H, W, 3] (or [H, W, 3] for one pair), numpy or CPU tensors; pairs
    split over n_data, rows over n_row (which must divide B and H), and the
    cost and CBCA's disparities over n_disp (which must divide them; the
    JAX mesh's 'disp' axis). Returns the float32 disparities [B, H, W] (or
    [H, W]) as a CPU tensor."""
    cfg = as_port_config(cfg).validate()
    check_sharded_support(cfg, n_disp)   # here as well as in each rank: refuse before spawning
    left, right = np.asarray(left), np.asarray(right)
    single = left.ndim == 3
    if single:
        left, right = left[None], right[None]
    disp = run_ranks(_pipeline_rank, (left, right, cfg, n_chunks), n_row, n_data, devices,
                     backend, n_disp)[0]
    disp = torch.from_numpy(disp)
    return disp[0] if single else disp
