#!/usr/bin/env python3
"""fullres_occfill's bfloat16 cooperative configuration at 1988x2880, D=256,
on one CUDA card, streamed over 32-disparity blocks (``d_stream_block=32``,
scripts/bench_suite.py:59-63) and without streaming (the dense path): does a
frame fit, and in how much device memory.

Run from the repository root:

    python3 tools/occfill_fullres_memory.py

It builds the kernels if needed, makes a synthetic 1988x2880 pair
(``make_synthetic_pair(seed=0)``) and runs two frames of each of
``StereoPipeline(get_model("fullres_occfill", max_disp=255,
vol_dtype="bfloat16", compute_both_volumes=False, d_stream_block=32), "cuda")``
and the same configuration with ``d_stream_block=0``: it prints each frame's
peak device memory and host-clock time, the launches of the second and its
bad-1.0 rate, or, when the card runs out of memory, the error and the peak
reached; then whether the two paths' maps are equal.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mystereomatching_tpu_torch import StereoPipeline  # noqa: E402
from mystereomatching_tpu_torch.data import make_synthetic_pair  # noqa: E402
from mystereomatching_tpu_torch.models import get_model  # noqa: E402
from mystereomatching_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mystereomatching_tpu_torch.utils.metrics import bad_pixel_rate  # noqa: E402

SHAPE = dict(h=1988, w=2880, max_disp=255, seed=0)


def run_frames(pipe, left, right, label: str, card: str, dev):
    """Two frames; returns the second's maps, or None when the card ran out
    of memory."""
    for frame in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ck.reset_launches()
        t0 = time.perf_counter()
        try:
            out = pipe(left, right)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as err:
            print(f"{label}, frame {frame}: out of device memory after "
                  f"{time.perf_counter() - t0:.3f} s, peak "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB: "
                  f"{str(err).splitlines()[0]} [{card}]")
            return None
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{label}, frame {frame}: {ms:.3f} ms host clock, peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB of "
              f"{torch.cuda.get_device_properties(dev).total_memory / 2**20:.1f} [{card}]")
    print(f"{label}: launches {json.dumps(ck.launches)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    ck.build()
    pair = make_synthetic_pair(**SHAPE)
    left = torch.from_numpy(pair.left).to(dev)
    right = torch.from_numpy(pair.right).to(dev)
    cfg = get_model("fullres_occfill", max_disp=SHAPE["max_disp"], vol_dtype="bfloat16",
                    compute_both_volumes=False, d_stream_block=32)
    outs = {}
    for block in (cfg.d_stream_block, 0):
        label = (f"fullres_occfill bf16 cooperative {SHAPE['h']}x{SHAPE['w']} "
                 f"D={cfg.num_disp} d_stream_block={block}")
        out = run_frames(StereoPipeline(cfg.replace(d_stream_block=block), device=dev), left,
                         right, label, card, dev)
        if out is None:
            continue
        bad1 = bad_pixel_rate(out["disparity"], torch.from_numpy(pair.gt).to(dev),
                              torch.from_numpy(pair.masks["nonocc"]).to(dev))
        print(f"{label}: bad-1.0 nonocc {bad1:.6f}")
        outs[block] = out
    if len(outs) == 2:
        same = all(torch.equal(outs[cfg.d_stream_block][k], outs[0][k]) for k in outs[0])
        print(f"streamed and dense maps equal: {same}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
