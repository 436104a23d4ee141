#!/usr/bin/env python3
"""The row-band pipeline's measured frames of one or more trees, in turns.

Run from the repository root on a machine with NVIDIA GPUs and nvcc:

    python3 tools/band_frames.py [--case NAME] [--frames N] [DIR ...]

Each DIR is the root of a tree of this repository: this one (the default),
or an earlier commit unpacked under ``build/`` with ``git archive``. A DIR
named twice runs twice, so ``parent this this parent`` interleaves two
trees. Each run is a process of its own that imports the package from its
DIR (its kernels built into that tree's ``build/cuda/`` first) and runs, through that
tree's ``parallel._harness``:

- ``sgm8_full`` on a 750x1000 pair (D=128) over 3 bands;
- ``fullres_occfill`` frame A, 1000x1400 (D=192, float32), over 4 bands;

each in 8 W chunks (``--case`` runs one of them alone), ``FRAMES`` frames
a rank (``--frames``): a warm-up, the timed ones, and a last one under
torch.profiler. One card a rank over NCCL where there
are cards enough, else every rank on card 0 over gloo. Prints each rank's
wall ms a frame, the profiled frame's device ms, peak device memory and
kernel C's launches, and a JSON line a run and frame with the card's name
and power limit and a digest of the frame's disparity map, then each tree's
median wall ms a frame over its runs; fails unless every run of a frame
gives the same map.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 4
CHUNKS = 8
# frame -> (preset, make_synthetic_pair arguments, bands)
CASES = {
    "sgm8_full": ("sgm8_full", dict(h=750, w=1000, max_disp=127, seed=0), 3),
    "fullres_occfill_A": ("fullres_occfill", dict(h=1000, w=1400, max_disp=191, seed=0), 4),
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_tree(tree: str, card_line: str, cases, frames: int) -> None:
    """One run: each of ``cases`` through the package of ``tree`` (already
    first on sys.path), ``frames`` frames a rank."""
    import torch

    from mystereomatching_tpu_torch.data import make_synthetic_pair
    from mystereomatching_tpu_torch.models import get_model
    from mystereomatching_tpu_torch.ops import cuda_kernels as ck
    from mystereomatching_tpu_torch.parallel import _harness
    from mystereomatching_tpu_torch.parallel.launch import band_pipeline

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    t0 = time.perf_counter()
    ck.build()
    print(f"{tree}: kernels built in {time.perf_counter() - t0:.3f} s from {ck.CSRC}")
    for case in cases:
        preset, pair_args, n_row = CASES[case]
        pair = make_synthetic_pair(**pair_args)
        cfg = get_model(preset, max_disp=pair_args["max_disp"])
        if torch.cuda.device_count() >= n_row:
            devices, backend = [f"cuda:{i}" for i in range(n_row)], "nccl"
        else:
            devices, backend = ["cuda:0"] * n_row, "gloo"
        job = _harness.Job(band_pipeline, (pair.left[None], pair.right[None], cfg, CHUNKS),
                           row_axis=1, batch_axis=0, frames=frames, profile=True)
        [(disp, reports)] = _harness.run_jobs([job], n_row, devices=devices, backend=backend)
        for r in reports:
            print(f"{tree} {case} rank {r['rank']} on {r['device']} ({backend}): wall ms/frame "
                  f"{', '.join(f'{t:.3f}' for t in r['wall_ms'])} (the first a warm-up, the "
                  f"last under the profiler); device {r['device_ms']:.3f} ms; peak "
                  f"{r['peak_bytes'] / 2**20:.1f} MiB; sgm_scan_ext "
                  f"{r['launches']['sgm_scan_ext']}, sgm_scan {r['launches']['sgm_scan']} "
                  f"launches [{card_line}]", flush=True)
        timed = [t for r in reports for t in r["wall_ms"][1:-1]]
        print(json.dumps({
            "tree": tree, "case": case, "backend": backend, "card": card_line,
            "map_sha256": hashlib.sha256(disp.tobytes()).hexdigest(),
            "wall_ms_max_rank": [max(r["wall_ms"][i] for r in reports)
                                 for i in range(1, frames - 1)],
            "wall_ms_mean": sum(timed) / len(timed),
            "device_ms": [r["device_ms"] for r in reports],
            "peak_mib": [r["peak_bytes"] / 2**20 for r in reports],
            "sgm_scan_ext": [r["launches"]["sgm_scan_ext"] for r in reports],
            "sgm_scan": [r["launches"]["sgm_scan"] for r in reports]}), flush=True)


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--run":
        tree = str(Path(sys.argv[2]).resolve())
        sys.path.insert(0, tree)
        run_tree(sys.argv[2], card(), sys.argv[3].split(","), int(sys.argv[4]))
        return 0
    args, cases, frames = sys.argv[1:], list(CASES), FRAMES
    while args and args[0] in ("--case", "--frames"):
        if args[0] == "--case":
            if args[1] not in CASES:
                raise SystemExit(f"--case: one of {list(CASES)}")
            cases = [args[1]]
        else:
            frames = int(args[1])
            if frames < 3:
                raise SystemExit("--frames: at least 3 (a warm-up, one timed, one profiled)")
        args = args[2:]
    trees = args or [str(ROOT)]
    for tree in trees:
        if not Path(tree, "mystereomatching_tpu_torch", "parallel", "_harness.py").is_file():
            raise SystemExit(f"{tree}: not a tree with the row-band harness")
    card_line = card()
    maps, walls = {}, {}
    for i, tree in enumerate(trees):
        print(f"run {i}: {tree} [{card_line}]", flush=True)
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
        res = subprocess.run([sys.executable, __file__, "--run", tree, ",".join(cases),
                              str(frames)], env=env,
                             stdout=subprocess.PIPE, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(f"run {i}: {tree} failed ({res.returncode})", flush=True)
            return res.returncode
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                maps.setdefault(rec["case"], set()).add(rec["map_sha256"])
                walls.setdefault((rec["case"], tree), []).append(rec["wall_ms_mean"])
    for (case, tree), ms in walls.items():
        print(f"{case} {tree}: wall ms/frame over {len(ms)} runs: median "
              f"{statistics.median(ms):.2f}, {min(ms):.2f} to {max(ms):.2f} [{card_line}]")
    for case, digests in maps.items():
        print(f"{case}: {'the same map in every run' if len(digests) == 1 else 'MAPS DIFFER'}")
    return 0 if all(len(d) == 1 for d in maps.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
