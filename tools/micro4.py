#!/usr/bin/env python3
"""The gather and prefix-sum probes of one GPU: the hand-written kernels
``gather_rows``, ``gather_cols``, ``cumsum_rows`` and ``cumsum_cols``
(``csrc/plane_probes.cu``) against their plain versions and the library
calls ``torch.gather`` and ``torch.cumsum``.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/micro4.py

Counterpart of ``scripts/micro4.py``, the TPU probe of the same four moves
(``take_along_axis`` and ``cumsum`` along each axis) on a [375, 450]
float32 plane. Two shapes: that plane, with the probe's inputs (seed 0:
uniform values, uniform indices along the gathered axis), and the NL tree
filter's rows at Teddy size, [168750, 61] (375 x 450 nodes by D + 1 = 61
columns), made the same way. Each gather must equal ``torch.gather`` bit
for bit; each cumsum kernel must equal the sequential float32 sums
(``plane_probes.cumsum_sequential``) bit for bit, and ``torch.cumsum``
must lie within ``plane_probes.cumsum_tolerance`` of the float64 cumsum
rounded to float32. ``cumsum_cols`` stages bands of rows through shared
memory, a thread adding its own row in sequential order; its lines end
with its time over ``torch.cumsum``'s. Times are the mean device time
between CUDA events around ``REPS`` calls after a warm-up, with the card's
name and power limit on every line.
"""

from __future__ import annotations

import os
import subprocess
import sys
from functools import partial

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mystereomatching_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mystereomatching_tpu_torch.ops import plane_probes as pp  # noqa: E402

PROBE_SHAPE = (375, 450)        # scripts/micro4.py's plane
NL_SHAPE = (375 * 450, 61)      # the NL filter's rows at Teddy size, D = 60
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
REPS = 20
# kernels line name -> (the TPU kernel it replaces, axis, gather or cumsum)
PROBES = {
    "gather_rows": ("scripts/micro4.py:8", 0, "gather"),
    "gather_cols": ("scripts/micro4.py:14", 1, "gather"),
    "cumsum_rows": ("scripts/micro4.py:19", 0, "cumsum"),
    "cumsum_cols": ("scripts/micro4.py:22", 1, "cumsum"),
}


def inputs(shape, dev, seed: int = 0):
    """(x, idx along axis 0, idx along axis 1) as scripts/micro4.py makes them."""
    rng = np.random.default_rng(seed)
    h, w = shape
    x = rng.random(shape, np.float32)
    idx_s = rng.integers(0, h, shape).astype(np.int32)
    idx_l = rng.integers(0, w, shape).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, idx_s, idx_l))


def cases(dev):
    """Each probe at each shape: (kernels line name, what, kernel, plain,
    library call, check, bytes, operations). ``check(got, want)`` raises
    where the kernel's result or the plain one is off, and returns the
    largest |kernel - plain|."""
    for shape, suffix in ((PROBE_SHAPE, ""), (NL_SHAPE, "_nl")):
        x, idx_s, idx_l = inputs(shape, dev)
        n = x.numel()
        for name, (_, axis, kind) in PROBES.items():
            what = f"{name} on {list(shape)} float32" + (
                " (the NL filter's rows at Teddy size)" if suffix else " (scripts/micro4.py)")
            if kind == "gather":
                idx = idx_s if axis == 0 else idx_l
                kernel = partial(ck.gather_rows if axis == 0 else ck.gather_cols, x, idx)
                plain = partial(pp.gather_rows_plain if axis == 0 else pp.gather_cols_plain, x, idx)
                library = partial(torch.gather, x, axis, idx.to(torch.int64))
                yield (name + suffix, what, kernel, plain, library, gather_check(name), 12 * n, n)
            else:
                plain = partial(pp.cumsum_plain, x, axis)
                yield (name + suffix, what, partial(ck.cumsum, x, axis), plain, plain,
                       cumsum_check(name, x, axis), 8 * n, n)


def gather_check(name):
    def check(got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: differs from torch.gather")
        return 0.0
    return check


def cumsum_check(name, x, axis):
    """The kernel's sums equal the sequential float32 sums bit for bit;
    torch.cumsum's parallel scan lies within the bound of the float64 sums."""
    sequential = pp.cumsum_sequential(x, axis)

    def check(got, want):
        if not torch.equal(got, sequential):
            raise AssertionError(f"{name}: differs from the sequential float32 sums at "
                                 f"{int((got != sequential).sum())} entries")
        err = pp.cumsum_error(want, x, axis)
        if not err <= 1.0:
            raise AssertionError(f"{name}: torch.cumsum's sums are {err:.3f} times the bound "
                                 "from the float64 cumsum")
        return float((got - want).abs().max())
    return check


def events_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def run(dev, card_line: str) -> None:
    """Checks and times every probe at both shapes; raises where a kernel
    or its plain version is off."""
    for name, what, kernel, plain, library, check, nbytes, _ in cases(dev):
        err = check(kernel(), plain())
        ms, plain_ms, lib_ms = events_ms(kernel), events_ms(plain), events_ms(library)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
              f"(kernel / library {ms / lib_ms:.3f}); bound {bound_ms:.4f} ms by bytes, "
              f"{bound_ms / ms:.3f} of it; max |kernel - plain| {err} [{card_line}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card_line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()[0]
    ck.build()
    run(torch.device("cuda", 0), card_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
