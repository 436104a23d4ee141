"""Measurement and test harness of the row-band pipeline; on no user's path.

Runs several band functions ("jobs") over one world of ranks
(:func:`launch.run_ranks`), so that a check of several configurations
spawns its processes once, and measures each rank: host-clock ms a frame
over several frames, the device time of the last under torch.profiler,
peak device memory, kernel launches and communication
(:class:`counters.CommRecord`). ``chip_smoke.py`` and the tests use it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from mystereomatching_tpu_torch.config import MatchConfig
from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.parallel.counters import record_comm
from mystereomatching_tpu_torch.parallel.halo import exchange_rows
from mystereomatching_tpu_torch.parallel.launch import band_rows, gather_bands, run_ranks
from mystereomatching_tpu_torch.parallel.mesh import RowMesh
from mystereomatching_tpu_torch.parallel.sharded import _sgm_sharded, sgm_band_direction


@dataclasses.dataclass
class Job:
    """One band function run on every rank.

    fn(mesh, *args) returns this rank's rows of the result, on axis
    ``row_axis`` (and its pairs on ``batch_axis``, where the job splits
    pairs over 'data'). It runs ``frames`` times, each timed; the last
    result is gathered, under torch.profiler when ``profile`` and the rank
    has a card. ``finish(gathered, *args)``, when given, runs on rank 0 on
    the gathered result (on its device) and its return value is returned
    in place of the result."""

    fn: Callable
    args: tuple
    row_axis: int
    batch_axis: Optional[int] = None
    frames: int = 1
    profile: bool = False
    finish: Optional[Callable] = None


def band_sgm(mesh: RowMesh, vol, image, cfg: MatchConfig, n_chunks: int,
             direction=None) -> torch.Tensor:
    """SGM of this rank's band of a [D, H, W] volume with its [H, W, 3]
    image: all of cfg's directions summed, or the one ``direction``
    (rv, ru)."""
    vb = band_rows(torch.as_tensor(vol), mesh, 1).to(mesh.device)
    ib = band_rows(torch.as_tensor(image), mesh, 0).to(mesh.device, torch.float32)
    if direction is None:
        return _sgm_sharded([vb], [ib], cfg, n_chunks, mesh)[0]
    return sgm_band_direction(vb, ib, cfg, *direction, n_chunks, mesh)


def band_exchange(mesh: RowMesh, x, halo: int, row_axis: int, pad_mode) -> torch.Tensor:
    """This rank's band of x extended by :func:`halo.exchange_rows`."""
    xb = band_rows(torch.as_tensor(x), mesh, row_axis).to(mesh.device)
    return exchange_rows(xb, halo, mesh, row_axis, pad_mode)


def _device_time(prof, top: int = 8):
    """(device ms of every kernel and copy in a profile, of those NCCL's
    kernels, which include their waits for the peer, and the ``top``
    largest by name as [name, ms, count]). Annotations of the device
    timeline (NCCL's 'nccl:coalesced') are not kernels and are left out."""
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            ms, n = per.get(e.name, (0.0, 0))
            per[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])[:top]
    return (sum(ms for ms, _ in per.values()),
            sum(ms for name, (ms, _) in per.items() if "nccl" in name.lower()),
            [[k[:100], ms, n] for k, (ms, n) in ranked])


def _sync(mesh: RowMesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _run_job(job: Job, mesh: RowMesh):
    on_card = mesh.device.type == "cuda"
    report = dict(rank=mesh.rank, device=str(mesh.device), backend=mesh.backend,
                  wall_ms=[], device_ms=None, nccl_ms=None, top_kernels=[])
    if on_card:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    for frame in range(job.frames):
        last = frame == job.frames - 1
        ck.reset_launches()
        dist.barrier()
        _sync(mesh)
        prof = None
        if last and job.profile and on_card:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        with record_comm() as rec:
            t0 = time.perf_counter()
            out = job.fn(mesh, *job.args)
            _sync(mesh)
            report["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            if prof is not None:
                prof.__exit__(None, None, None)
                report["device_ms"], report["nccl_ms"], report["top_kernels"] = \
                    _device_time(prof)
            if last:
                result = gather_bands(out, mesh, job.row_axis, job.batch_axis)
    report.update(launches=dict(ck.launches), launches_bf16=dict(ck.launches_bf16),
                  launches_scans=dict(ck.launches_scans), comm=rec.summary())
    if on_card:
        report["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    if result is None:
        return None, report
    if job.finish is not None:
        return job.finish(result, *job.args), report
    return result.cpu().numpy(), report


def _jobs_rank(mesh: RowMesh, jobs: Sequence[Job]):
    return [_run_job(job, mesh) for job in jobs]


def run_jobs(jobs: Sequence[Job], n_row: int, n_data: int = 1, devices=None,
             backend: Optional[str] = None, n_disp: int = 1):
    """Runs ``jobs`` in order on one world of n_data x n_row x n_disp ranks
    (:func:`launch.run_ranks`'s devices and backend). Returns, for each job,
    (rank 0's gathered result as numpy, or finish's value; the ranks'
    reports, in rank order)."""
    per_rank = run_ranks(_jobs_rank, (list(jobs),), n_row, n_data, devices, backend, n_disp)
    return [(per_rank[0][i][0], [ranks[i][1] for ranks in per_rank])
            for i in range(len(jobs))]
