#!/usr/bin/env python3
"""The taps probes of one GPU: the hand-written kernels ``taps_probe_roll``,
``taps_probe_slice``, ``taps_probe_clones`` and ``taps_probe_static``
(``csrc/taps_probes.cu``) against their plain versions
(``ops/taps_probes.py``) and beside kernel B on the same values.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/taps_probes.py

Counterpart of ``scripts/micro3.py``, ``micro_cbca2.py``, ``micro_cbca3.py``
and ``micro_cbca5.py``, the TPU probes of kernel B's taps pass: one
arm-bounded sum of a float32 [D, H, W] = [60, 375, 450] volume with
max_arm 34, by layout and by offset scheme. Inputs as the scripts make
them. ``micro3.py``: a seed-0 ``rng.integers(0, 255, (375, 450, 3))`` image
and the same image rolled by 3 columns, then the volume ``rng.random`` from
the same generator; the probes along H take the intersected arms' planes 2
and 3, along W planes 0 and 1. ``micro_cbca*.py``: the pair
``make_synthetic_pair(h=375, w=450, max_disp=59, seed=0)`` and a seed-0
``rng.random`` volume, along H only; ``micro_cbca5.py`` also on 16 frames
(the volume plus 1e-3 times the frame index, the arms repeated). Arms:
``cross_arms(img, 17, 34, 20, 6, 1)`` of both images, ``intersect_arms(...,
60, 0)``, as int32 (the scripts' type).

Each kernel must equal its plain version bit for bit, and all but
``fixed`` (wrong by design, a timing floor) must be within
(2 max_arm + 1) 2^-24 sum |terms| of kernel B's sum pass at each pixel:
the probes add the centre first, then +k and -k, B in ascending offset.
Times are the mean device time between CUDA events around each call, a
256 MiB fill evicting the L2 before it (``sgm_layouts.flushed_ms``); the
bound is the bytes read and written (16 an element with int32 arms, 10 for
kernel B's int8 ones) at the nominal 3.35 TB/s and at ``copy_bw``'s
measured rate (``sgm_layouts.COPY_BYTES_PER_S``). Every line carries the
card's name and power limit.
Last, each probe instance's registers and spills from ``nvcc -Xptxas -v``.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mystereomatching_tpu_torch.data import make_synthetic_pair  # noqa: E402
from mystereomatching_tpu_torch.ops import arms as arms_ops  # noqa: E402
from mystereomatching_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mystereomatching_tpu_torch.ops import taps_probes  # noqa: E402
from tools.sgm_layouts import bound_line, flushed_ms, ptxas_report  # noqa: E402

D, H, W, MAX_ARM, FRAMES = 60, 375, 450, 34, 16
# the scripts' first listed parameters, the kernels line's rows
ROWS = ("taps_probe_roll_h", "taps_probe_roll_w", "taps_probe_slice_dyn_h",
        "taps_probe_slice_dyn_w", "taps_probe_slice_fixed", "taps_probe_slice_seg64",
        "taps_probe_clones", "taps_probe_clones_oct", "taps_probe_clones_seg64",
        "taps_probe_static_o8", "taps_probe_static_o8_b16")
MICRO3 = "scripts/micro3.py:99"
CBCA2, CBCA3, CBCA5 = ("scripts/micro_cbca2.py:168", "scripts/micro_cbca3.py:165",
                       "scripts/micro_cbca5.py:79")
# name -> (entry point, kind, axis, seg or octave, inputs, the pallas_call it replaces)
CASES = {
    "taps_probe_roll_h": ("taps_probe_roll", "roll", 1, None, "micro3", MICRO3),
    "taps_probe_roll_w": ("taps_probe_roll", "roll", 2, None, "micro3", MICRO3),
    "taps_probe_slice_dyn_h": ("taps_probe_slice", "dyn", 1, None, "micro3", MICRO3),
    "taps_probe_slice_dyn_w": ("taps_probe_slice", "dyn", 2, None, "micro3", MICRO3),
    "taps_probe_slice_fixed": ("taps_probe_slice", "fixed", 1, None, "cbca", CBCA2),
    "taps_probe_slice_seg64": ("taps_probe_slice", "seg", 1, 64, "cbca", CBCA2),
    "taps_probe_slice_seg32": ("taps_probe_slice", "seg", 1, 32, "cbca", CBCA2),
    "taps_probe_clones": ("taps_probe_clones", "clones", 1, None, "cbca", CBCA2),
    "taps_probe_clones_oct": ("taps_probe_clones", "oct", 1, None, "cbca", CBCA3),
    "taps_probe_clones_seg64": ("taps_probe_clones", "clseg", 1, 64, "cbca", CBCA3),
    "taps_probe_clones_seg32": ("taps_probe_clones", "clseg", 1, 32, "cbca", CBCA3),
    "taps_probe_clones_seg96": ("taps_probe_clones", "clseg", 1, 96, "cbca", CBCA3),
    **{f"taps_probe_static_o{o}{b}": ("taps_probe_static", "static", 1, o,
                                      "cbca_b16" if b else "cbca", CBCA5)
       for b in ("", "_b16") for o in (8, 16, 34)},
}
BYTES_PER_ELEMENT = 16   # float32 vol in and out, two int32 arm planes
B_BYTES_PER_ELEMENT = 10  # kernel B: its arms are int8


def arms(img: np.ndarray, img2: np.ndarray, dev) -> torch.Tensor:
    """The scripts' intersected arms [4, D, H, W] (L, R, U, D) as int32."""
    a0, a1 = (arms_ops.cross_arms(torch.from_numpy(i).to(dev, torch.float32), 17, 34, 20, 6, 1)
              for i in (img, img2))
    return arms_ops.intersect_arms(a0, a1, D, 0).to(torch.int32)


def inputs(dev) -> dict:
    """name -> (vol [N, H, W] float32, its arms by axis {1: (an, ap), 2: ...})."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (H, W, 3))
    vol = torch.from_numpy(rng.random((D, H, W), np.float32)).to(dev)
    ai = arms(img, np.roll(img, 3, axis=1), dev)
    out = {"micro3": (vol, {1: (ai[2], ai[3]), 2: (ai[0], ai[1])})}
    pair = make_synthetic_pair(h=H, w=W, max_disp=D - 1, seed=0)
    vol = torch.from_numpy(np.random.default_rng(0).random((D, H, W), np.float32)).to(dev)
    ai = arms(pair.left, pair.right, dev)
    out["cbca"] = (vol, {1: (ai[2], ai[3])})
    frames = vol[None] + torch.arange(FRAMES, dtype=torch.float32, device=dev)[:, None, None,
                                                                                None] * 1e-3
    out["cbca_b16"] = (frames.reshape(FRAMES * D, H, W),
                       {1: tuple(a.repeat(FRAMES, 1, 1) for a in (ai[2], ai[3]))})
    return out


def probe(name: str, vol, an, ap):
    entry, kind, axis, param, _, _ = CASES[name]
    if entry == "taps_probe_roll":
        return ck.taps_probe_roll(vol, an, ap, axis, MAX_ARM)
    if entry == "taps_probe_slice":
        return ck.taps_probe_slice(vol, an, ap, kind, MAX_ARM, axis, param)
    if entry == "taps_probe_clones":
        return ck.taps_probe_clones(vol, an, ap, kind, MAX_ARM, param)
    return ck.taps_probe_static(vol, an, ap, param, MAX_ARM)


def plain(name: str, vol, an, ap):
    kind, axis = CASES[name][1:3]
    if kind == "roll":
        return taps_probes.circular_plain(vol, an, ap, axis, MAX_ARM)
    if kind == "fixed":
        return taps_probes.fixed_plain(vol, an, ap, MAX_ARM)
    return taps_probes.bounded_plain(vol, an, ap, axis, MAX_ARM)


def adds(an, ap) -> int:
    """The adds the sum needs: one a tap inside the capped arms."""
    return int(an.clamp(max=MAX_ARM).sum(dtype=torch.int64)
               + ap.clamp(max=MAX_ARM).sum(dtype=torch.int64))


class KernelB:
    """Kernel B's sum pass on one input's values along one axis, with the
    rounding bound that holds a probe to it."""

    def __init__(self, vol, an, ap, axis):
        self.an8, self.ap8 = an.to(torch.int8), ap.to(torch.int8)
        self.call = lambda: ck.arm_taps(vol, self.an8, self.ap8, axis, MAX_ARM)
        self.out = self.call()
        # every term's |value| summed, in float64: the bound on reordering the adds
        terms = taps_probes.bounded_plain(vol.abs().double(), an, ap, axis, MAX_ARM)
        self.tol = (terms * ((2 * MAX_ARM + 1) * 2.0 ** -24)).float()
        self.nbytes = B_BYTES_PER_ELEMENT * vol.numel()

    def diff(self, name: str, got) -> float:
        """The largest |got - B|; raises where it exceeds the bound, but for fixed."""
        d = (got.double() - self.out.double()).abs()
        if CASES[name][1] != "fixed" and bool((d > self.tol.double()).any()):
            raise AssertionError(f"{name}: beyond the rounding bound of kernel B at "
                                 f"{int((d > self.tol.double()).sum())} pixels")
        return float(d.max())


def cases(dev):
    """Every probe as (name, entry, what, kernel, plain, kernel B, bytes,
    operations); the inputs are built once and kernel B once a volume and
    axis."""
    data = inputs(dev)
    b_runs = {}
    for name, (entry, kind, axis, param, which, _) in CASES.items():
        vol, by_axis = data[which]
        an, ap = by_axis[axis]
        if (which, axis) not in b_runs:
            b_runs[which, axis] = KernelB(vol, an, ap, axis)
        frames = f"{FRAMES} frames of " if which == "cbca_b16" else ""
        extra = f" {'octave' if kind == 'static' else 'of'} {param}" if param else ""
        what = (f"{entry} {kind}{extra} along {'HW'[axis - 1]} on {frames}[{D}, {H}, {W}] "
                f"float32, max_arm {MAX_ARM}, {'micro3.py' if which == 'micro3' else 'micro_cbca'}"
                f"'s arms")
        yield (name, entry, what,
               lambda n=name, v=vol, a=an, p=ap: probe(n, v, a, p),
               lambda n=name, v=vol, a=an, p=ap: plain(n, v, a, p),
               b_runs[which, axis], BYTES_PER_ELEMENT * vol.numel(), adds(an, ap))


def check(name: str, got, want) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: differs from its plain version at "
                             f"{int((got != want).sum())} entries")


def ptxas_lines(log: str):
    """Each probe instance's (kernel, template arguments, registers, spill
    stores, spill loads) from an ``nvcc -Xptxas -v`` report."""
    found, current, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(taps_probe_[a-z]+_kernel(?:_[hw])?)(?:I((?:Li\d+E)+)E)?", m.group(1))
            current = (k.group(1), ", ".join(re.findall(r"Li(\d+)E", k.group(2) or ""))) \
                if k else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            found.append(current + (int(m.group(1)),) + spills)
            current = None
    return found


def print_registers(log: str, card_line: str) -> None:
    rows = ptxas_lines(ptxas_report(log, "taps_probes"))
    if not rows:
        raise AssertionError("no taps_probe instance in the nvcc report")
    for kernel, args, regs, stores, loads in sorted(rows):
        print(f"nvcc {kernel}{f'<{args}>' if args else ''}: {regs} registers, {stores} bytes "
              f"spill stores, {loads} bytes spill loads [{card_line}]")


def run(dev, card_line: str, log: str = "") -> None:
    """Checks and times every probe beside kernel B; raises where a kernel
    differs from its plain version or from B beyond rounding."""
    b_ms = {}
    for name, _, what, kernel, plain_fn, b, nb, _ in cases(dev):
        got = kernel()
        check(name, got, plain_fn())
        b_diff = b.diff(name, got)
        ms, plain_ms = flushed_ms(kernel), flushed_ms(plain_fn, 3)
        if id(b) not in b_ms:
            b_ms[id(b)] = flushed_ms(b.call)
        print(f"{name}, {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, kernel B "
              f"{b_ms[id(b)]:.4f} ms ({bound_line(b.nbytes, b_ms[id(b)])}); max |probe - B| "
              f"{b_diff!r}; {bound_line(nb, ms)}; equal to plain [{card_line}]")
    torch.cuda.empty_cache()
    print_registers(log, card_line)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card_line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()[0]
    log = ck.build()
    run(torch.device("cuda", 0), card_line, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
