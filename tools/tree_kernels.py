#!/usr/bin/env python3
"""Kernel B (``arm_taps.cu``) and proper interpolation (``pi_scan.cu``) of
other trees against this tree's, timed on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/tree_kernels.py DIR [DIR ...]

Each DIR holds a tree's ``arm_taps.cu`` and ``pi_scan.cu`` with their
headers, such as the ``csrc/`` of an earlier commit unpacked with ``git
archive``, or this tree's own ``mystereomatching_tpu_torch/csrc``. A DIR
named twice runs twice, so ``parent this this parent`` interleaves two trees.
A DIR whose name ends in ``_copy`` holds a diagnostic variant that need not
compute the same function (say, one that only stages and copies): its
outputs are compared but may differ.
All trees are built at once, one nvcc each, by the build step of
``tools/sgm_band_variants.py``.

Cases, on the inputs ``chip_smoke.py`` gives the kernels:
- kernel B's four launch kinds of a frame's CBCA (sum along W, area along
  H, sum along H, area along W) on the ``sgm8_full`` frame's CBCA input
  [128, 750, 1000] and on the Teddy frame's [60, 375, 450];
- kernel B's first CBCA iteration (sum along W, area along H) on the
  full-resolution [32, 1988, 2880] volume;
- ``pi_scan`` on the Teddy region-voted map and on the 1988x2880 map.

For each case and tree in turn: device time between CUDA events around one
launch, a 256 MiB fill evicting L2 before each, mean of ``REPS``; every
launch's output must equal this tree's kernel's (but see ``_copy``).
Prints one line a (case, kind, run) and, for kernel B, each run's sum over
a case's kinds, with the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import sgm_band_variants  # noqa: E402
from mystereomatching_tpu_torch.models import get_model  # noqa: E402
from mystereomatching_tpu_torch.data import make_synthetic_pair  # noqa: E402
from mystereomatching_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mystereomatching_tpu_torch.ops import refine as refine_ops  # noqa: E402

REPS = 10


def event_ms(launch, flush, reps: int = REPS) -> float:
    """Mean ms between CUDA events around one launch, L2 evicted before each."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    total = 0.0
    for _ in range(reps):
        flush.fill_(0)
        start.record()
        launch()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def b_cases(dev, t: dict, f: dict) -> dict:
    """case -> (max_arm, kernel B's launches from ``cs.cbca_launches``), on
    the sgm8_full frame, the Teddy inputs ``t`` and the full-resolution ones
    ``f``."""
    cfg = get_model("sgm8_full", max_disp=cs.SGM8["max_disp"])
    pair = make_synthetic_pair(**cs.SGM8)
    left, right = (torch.from_numpy(x).to(dev, torch.float32) for x in (pair.left, pair.right))
    vol, arms_int = cs.frame_cbca_inputs(left, right, cfg)
    m = cfg.arm_l_out
    cases = {f"sgm8_full frame {list(vol.shape)}": (m, cs.cbca_launches(vol, arms_int, m))}
    cases[f"Teddy frame {list(t['vol'].shape)}"] = (
        t["cfg"].arm_l_out, cs.cbca_launches(t["vol"], t["arms_int"], t["cfg"].arm_l_out))
    cases[f"full resolution {list(f['vol'].shape)}, first iteration"] = (
        m, cs.cbca_launches(f["vol"], f["arms_int"], m, 1))
    return cases


def pi_cases(dev, t: dict, f: dict) -> dict:
    """case -> (disp, image, offsets, disp_occ) of ``pi_scan``."""
    depth = t["cfg"].pi_search_depth
    offs = torch.from_numpy(refine_ops.pi_offsets(depth)).to(dev)
    return {f"Teddy region-voted map, depth {depth}": (t["rv"], t["left"].contiguous(), offs,
                                                       t["cfg"].disp_occ),
            "full resolution 1988x2880 map, depth 20": (f["disp"], f["img"], offs, -32)}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    runs = sys.argv[1:] or [str(ck.CSRC)]
    for run in runs:
        if not Path(run, "arm_taps.cu").is_file():
            raise SystemExit(f"{run}: no arm_taps.cu there")
    libs = sgm_band_variants.compile_libs(
        {run: run for run in dict.fromkeys(runs)}, ("arm_taps.cu", "pi_scan.cu"),
        ("mysm_arm_taps", "mysm_pi_scan"), r"((?:arm_taps|pi_scan)_\w*kernel\w*)")
    dev = torch.device("cuda", 0)
    flush = torch.empty((256 << 20) // 4, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what}: launch failed ({rc})")

    t, f = cs.teddy_inputs(dev), cs.fullres_inputs(dev)
    for case, (m, launches) in b_cases(dev, t, f).items():
        sums = [0.0] * len(runs)
        for kind, (vol, an, ap, axis, an1, ap1) in launches:
            want = ck.arm_taps(vol, an, ap, axis, m, an1, ap1)
            out = torch.empty_like(vol)
            nd, h, w = vol.shape
            for i, run in enumerate(runs):
                def launch():
                    check(libs[run].mysm_arm_taps(
                        vol.data_ptr(), an.data_ptr(), ap.data_ptr(),
                        an1.data_ptr() if an1 is not None else None,
                        ap1.data_ptr() if ap1 is not None else None, out.data_ptr(),
                        nd, h, w, int(axis == 2), m, stream), f"{run} {kind}")

                launch()
                torch.cuda.synchronize()
                equal = torch.equal(out, want)
                if not equal and not run.endswith("_copy"):
                    raise AssertionError(f"{run}: kernel B {kind} on {case} differs from "
                                         "this tree's kernel")
                ms = event_ms(launch, flush)
                sums[i] += ms
                print(f"kernel B {case}: {kind} run {i} {run}: {ms:.4f} ms (equal to this "
                      f"tree's kernel: {equal}) [{card}]", flush=True)
        for i, run in enumerate(runs):
            print(f"kernel B {case}: {len(launches)} launch kinds, run {i} {run}: "
                  f"{sums[i]:.4f} ms [{card}]")
        del launches, want, out

    for case, (disp, img, offs, occ) in pi_cases(dev, t, f).items():
        want = ck.pi_scan(disp, img, offs, occ)
        out = torch.empty_like(disp)
        h, w = disp.shape
        for i, run in enumerate(runs):
            def launch():
                check(libs[run].mysm_pi_scan(disp.data_ptr(), img.data_ptr(), offs.data_ptr(),
                                             out.data_ptr(), h, w, offs.shape[1], occ, stream),
                      f"{run} pi_scan")

            launch()
            torch.cuda.synchronize()
            equal = torch.equal(out, want)
            if not equal and not run.endswith("_copy"):
                raise AssertionError(f"{run}: pi_scan on {case} differs from this tree's kernel")
            print(f"pi_scan {case}: run {i} {run}: {event_ms(launch, flush):.4f} ms (equal to "
                  f"this tree's kernel: {equal}) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
