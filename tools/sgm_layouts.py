#!/usr/bin/env python3
"""The SGM-layout probes of one GPU: the hand-written kernels
``sgm_probe_hdw``, ``sgm_probe_g``, ``sgm_probe_rolled`` and
``sgm_probe_unrolled`` (``csrc/sgm_probes.cu``) against their plain
versions (``ops/sgm_probes.py``) and against kernel C on the same values.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/sgm_layouts.py

Counterpart of ``scripts/check_sgm3.py``, ``check_sgm4.py`` and
``check_sgm5.py``, the TPU probes of kernel C's layout: the SGM scan down H
of float32 volumes laid out [G, H, D, W] with a D row stored together, G
volumes in a block or one, the row loop rolled or unrolled, and the
trivial row bodies ``copy`` and ``prev`` beside the full recurrence. Both
copies, rolled and unrolled, are one streaming pass over the whole volume
(the copy carries nothing from row to row, so neither walks rows); a line
for each shape gives each copy's time over ``torch.mul``'s and their
ratio, which should be 1, as a check of the measurement. Two shapes: the
scripts' [G, H, D, W] = [4, 375, 60, 450], and ``sgm8_full``'s scan
[2, 750, 128, 1000] (its left and right volumes at 750x1000, D=128);
inputs ``rng.random`` from seed 0, as the scripts make them. Each kernel
must equal its plain version bit for bit, and each ``full`` kind kernel
C's downward scan (``cuda_kernels.sgm_scan`` along H) of the [G, D, H, W]
transpose. Times are the mean device time between CUDA events around each
call, a 256 MiB fill evicting the L2 before it; the bound is the bytes read
and written at the nominal 3.35 TB/s and at the copy rate ``copy_bw``
measured on an H100 (``COPY_BYTES_PER_S``, ``tools/check_bw.py``). Every
line carries the card's name and power limit. Last, each probe instance's
registers and spills from ``nvcc -Xptxas -v``.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mystereomatching_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mystereomatching_tpu_torch.ops import sgm_probes  # noqa: E402

SHAPES = {"": (4, 375, 60, 450),         # the scripts' [G, H, D, W]
          "_sgm8": (2, 750, 128, 1000)}  # sgm8_full's two volumes, 750x1000, D=128
# (entry point, kind) -> the pallas_call of the TPU kernel it replaces
PROBES = {
    ("sgm_probe_hdw", "full"): "scripts/check_sgm3.py:49",
    ("sgm_probe_g", "full"): "scripts/check_sgm4.py:48",
    ("sgm_probe_rolled", "copy"): "scripts/check_sgm5.py:53",
    ("sgm_probe_rolled", "prev"): "scripts/check_sgm5.py:53",
    ("sgm_probe_rolled", "full"): "scripts/check_sgm5.py:53",
    ("sgm_probe_unrolled", "copy"): "scripts/check_sgm5.py:108",
    ("sgm_probe_unrolled", "full"): "scripts/check_sgm5.py:108",
}
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
COPY_BYTES_PER_S = 3.1059e12    # copy_bw's measured rate on an H100 (4 GiB, chip_smoke.py)
FLUSH_BYTES = 256 << 20         # five times the H100's 50 MB L2
REPS = 10
OPS = {"copy": 1, "prev": 2, "full": 7}  # operations an element
# the probes' instances by carried disparities a thread (kPer), D <= 8 kPer;
# 0 for the copies' streaming kernel, which carries none
D_CLASS = {8: "the D <= 64 (D=60) instance (8 disparities a thread)",
           16: "the D <= 128 (D=128) instance (16 disparities a thread)",
           32: "the D <= 256 instance (32 disparities a thread)",
           0: "the streaming kernel (any D)"}


def inputs(shape, dev, seed: int = 0):
    """(vol [G, H, D, W], ps [G, H, W]) float32, rng.random as the scripts."""
    rng = np.random.default_rng(seed)
    g, h, _, w = shape
    vol = rng.random(shape, np.float32)
    ps = rng.random((g, h, w), np.float32)
    return torch.from_numpy(vol).to(dev), torch.from_numpy(ps).to(dev)


def probe(entry: str, kind: str, vol, ps):
    if entry in ("sgm_probe_hdw", "sgm_probe_g"):
        return getattr(ck, entry)(vol, ps)
    return getattr(ck, entry)(vol, ps, kind)


def kernel_c(vol_t, ps):
    """Kernel C's downward scan of vol_t [G, D, H, W] with the probes' penalties."""
    return ck.sgm_scan(vol_t, ps, ck.SGM_PROBE_P1, ck.SGM_PROBE_P2, 2, False)


def nbytes(vol, kind: str) -> int:
    """Bytes the function moves: the costs read and the path costs written
    once, and in full the scales read once."""
    return 8 * vol.numel() + (4 * vol[:, :, 0].numel() if kind == "full" else 0)


def shape_cases(suffix: str, dev):
    """The probes at one shape: (vol, ps, the [G, D, H, W] transpose, kernel
    C's path costs on it, and each probe as (kernels line name, entry, kind,
    what, kernel, plain, library call or None, check, bytes, operations)).
    ``check(got, want)`` raises where the kernel differs from its plain
    version or, in full, from kernel C, and returns 0.0."""
    shape = SHAPES[suffix]
    vol, ps = inputs(shape, dev)
    vol_t = vol.transpose(1, 2).contiguous()
    want_c = kernel_c(vol_t, ps).transpose(1, 2)
    cases = []
    for (entry, kind) in PROBES:
        name = f"{entry}_{kind}{suffix}"

        def check(got, want, name=name, kind=kind):
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: differs from its plain version at "
                                     f"{int((got != want).sum())} entries")
            if kind == "full" and not torch.equal(got, want_c):
                raise AssertionError(f"{name}: differs from kernel C's downward scan")
            return 0.0

        library = (lambda: torch.mul(vol, 1.01)) if kind == "copy" else None
        what = (f"{entry} {kind} on [G, H, D, W] = {list(shape)} float32"
                + (" (sgm8_full's scan)" if suffix else " (scripts/check_sgm*.py)"))
        cases.append((name, entry, kind, what,
                      lambda e=entry, k=kind: probe(e, k, vol, ps),
                      lambda k=kind: sgm_probes.plain(vol, ps, k), library, check,
                      nbytes(vol, kind), OPS[kind] * vol.numel()))
    return vol, ps, vol_t, want_c, cases


def flushed_ms(fn, reps: int = REPS) -> float:
    """Mean device ms of fn() between CUDA events around each call, after a
    warm-up, with the L2 flushed before each start event."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    stops = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    fn()
    torch.cuda.synchronize()
    for start, stop in zip(starts, stops):
        flush.fill_(0)
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, stops)) / reps


def copy_line(suffix: str, times: dict, card_line: str) -> str:
    """Each copy, rolled and unrolled (one streaming pass each), over
    torch.mul's time, and their ratio, from ``times``: kernels line name ->
    (kernel ms, library ms or None), measured in one run."""
    ms, lib_ms = times[f"sgm_probe_unrolled_copy{suffix}"]
    rolled_ms, rolled_lib_ms = times[f"sgm_probe_rolled_copy{suffix}"]
    return (f"sgm_probe_rolled and sgm_probe_unrolled copy on {list(SHAPES[suffix])}: "
            f"{rolled_ms:.4f} and {ms:.4f} ms, torch.mul {rolled_lib_ms:.4f} and {lib_ms:.4f} "
            f"ms (kernel / library {rolled_ms / rolled_lib_ms:.3f} and {ms / lib_ms:.3f}); "
            f"rolled / unrolled {rolled_ms / ms:.3f}, one streaming pass each [{card_line}]")


def bound_line(nb: int, ms: float) -> str:
    b, bc = nb / HBM_BYTES_PER_S * 1e3, nb / COPY_BYTES_PER_S * 1e3
    return (f"bound {b:.4f} ms by bytes ({nb / 1e6:.1f} MB) at 3.35 TB/s [{bc:.4f} at "
            f"{COPY_BYTES_PER_S / 1e12:.4f}], {b / ms:.3f} of it [{bc / ms:.3f}]")


def transposed_hdw_ms(vol_t, ps) -> float:
    """check_sgm3.py's last line: the HDW kernel with the two transposes
    around it, from and back to [G, D, H, W]."""
    return flushed_ms(lambda: ck.sgm_probe_hdw(vol_t.transpose(1, 2).contiguous(), ps)
                      .transpose(1, 2).contiguous())


def ptxas_lines(log: str):
    """Each probe instance's (entry, kind, kPer or 0 for the streaming
    copy, registers, spill stores, spill loads) from an ``nvcc -Xptxas -v``
    report."""
    kinds = {0: "copy", 1: "prev", 2: "full"}
    found, current, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(sgm_probe_[a-z]+)_kernelI((?:Li\d+E)+)E", m.group(1))
            copy = re.search(r"(sgm_probe_[a-z]+)_kernel_copy", m.group(1))
            current = None
            if k:
                args = [int(a) for a in re.findall(r"Li(\d+)E", k.group(2))]
                current = (k.group(1), kinds[args[0]] if len(args) == 2 else "full", args[-1])
            elif copy:
                current = (copy.group(1), "copy", 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            found.append(current + (int(m.group(1)),) + spills)
            current = None
    return found


def ptxas_report(log: str = "", stem: str = "sgm_probes") -> str:
    """The nvcc report of ``csrc/{stem}.cu``'s probes: ``log`` (a build's)
    when it names them (``stem`` without its last letter), else a compile
    of that source alone."""
    if stem[:-1] not in log:
        from torch.utils.cpp_extension import CUDA_HOME

        out = Path(ck.BUILD_DIR) / f"{stem}_report.o"
        out.parent.mkdir(parents=True, exist_ok=True)
        log = subprocess.run([str(Path(CUDA_HOME) / "bin" / "nvcc"), *ck.NVCC_FLAGS, "-c", "-o",
                              str(out), str(ck.CSRC / f"{stem}.cu")],
                             capture_output=True, text=True, check=True).stderr
    return log


def print_registers(log: str, card_line: str) -> None:
    rows = ptxas_lines(ptxas_report(log))
    if not rows:
        raise AssertionError("no sgm_probe instance in the nvcc report")
    for entry, kind, per, regs, stores, loads in sorted(rows):
        print(f"nvcc {entry} {kind}, {D_CLASS[per]}: {regs} registers, {stores} bytes spill "
              f"stores, {loads} bytes spill loads [{card_line}]")


def run(dev, card_line: str, log: str = "") -> None:
    """Checks and times every probe at both shapes beside kernel C; raises
    where a kernel differs from its plain version or from kernel C."""
    for suffix in SHAPES:
        vol, ps, vol_t, _, cases = shape_cases(suffix, dev)
        c_ms = flushed_ms(lambda: kernel_c(vol_t, ps))
        print(f"kernel C, the same values as [G, D, H, W] {list(vol_t.shape)}, downward: "
              f"{c_ms:.4f} ms; {bound_line(nbytes(vol, 'full'), c_ms)} [{card_line}]")
        print(f"sgm_probe_hdw with the two transposes around it: "
              f"{transposed_hdw_ms(vol_t, ps):.4f} ms [{card_line}]")
        times = {}
        for name, _, _, what, kernel, plain, library, check, nb, _ in cases:
            check(kernel(), plain())
            ms, plain_ms = flushed_ms(kernel), flushed_ms(plain, 3)
            lib_ms = flushed_ms(library) if library else None
            times[name] = ms, lib_ms
            lib = f", library (torch.mul) {lib_ms:.4f} ms" if library else ""
            print(f"{what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, kernel C "
                  f"{c_ms:.4f} ms; {bound_line(nb, ms)}; equal to plain"
                  f"{' and to kernel C' if 'full' in name else ''} [{card_line}]")
        print(copy_line(suffix, times, card_line))
        del vol, ps, vol_t, cases
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
