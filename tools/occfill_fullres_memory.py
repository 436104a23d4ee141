#!/usr/bin/env python3
"""fullres_occfill's bfloat16 cooperative configuration at 1988x2880, D=256,
without disparity streaming, on one CUDA card: does a frame fit, and in how
much device memory.

Run from the repository root:

    python3 tools/occfill_fullres_memory.py

It builds the kernels if needed, makes a synthetic 1988x2880 pair
(``make_synthetic_pair(seed=0)``) and runs two frames of
``StereoPipeline(get_model("fullres_occfill", max_disp=255,
vol_dtype="bfloat16", compute_both_volumes=False), "cuda")``: it prints each
frame's peak device memory and host-clock time, the launches of the second
and its bad-1.0 rate, or, when the card runs out of memory, the error and the
peak reached. The JAX package streams this shape over 32-disparity blocks
(``d_stream_block=32``, scripts/bench_suite.py:59-63), which the port does
not run yet; this measures what the dense path needs instead.
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
                    compute_both_volumes=False)
    pipe = StereoPipeline(cfg, device=dev)
    label = f"fullres_occfill bf16 cooperative {SHAPE['h']}x{SHAPE['w']} D={cfg.num_disp}"
    for frame in (1, 2):
        torch.cuda.synchronize()
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
            return 0
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{label}, frame {frame}: {ms:.3f} ms host clock, peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB of "
              f"{torch.cuda.get_device_properties(dev).total_memory / 2**20:.1f} [{card}]")
    bad1 = bad_pixel_rate(out["disparity"], torch.from_numpy(pair.gt).to(dev),
                          torch.from_numpy(pair.masks["nonocc"]).to(dev))
    print(f"{label}: launches {json.dumps(ck.launches)}; bad-1.0 nonocc {bad1:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
