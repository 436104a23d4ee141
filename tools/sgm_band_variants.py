#!/usr/bin/env python3
"""Variants of the SGM scan kernels C and E (``csrc/sgm_band.cuh``) timed on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/sgm_band_variants.py [variant ...]

Each variant is a copy of ``csrc/sgm_scan.cu``, ``csrc/sgm_diag.cu`` and
``csrc/sgm_band.cuh`` under ``build/variants/`` (other headers come from
``csrc/``) with other band shapes,
another ring depth, or with the recurrence left out. Its name says which:
``h16x64_w4x64_d16x64_r4`` has bands of 16 lines and boxes of 64 pixels
along H, 4 lines and 64 pixels along W, 16 lines and 64 pixels on the
diagonals (a band of L lines advances box / L steps a stage), and a ring of
at most 4 stages (``kMaxRing``); a ``_copy`` suffix copies each stage's box
in and stores it back unchanged (the memory traffic alone). A variant may
also be a directory holding another tree's ``sgm_scan.cu`` and
``sgm_diag.cu`` (with their headers), such as the ``csrc/`` of an earlier
commit unpacked with ``git archive``: its kernels are built as they are.
A variant named twice runs twice (parent, change, change, parent).

All variants are built at once, one nvcc each. For each size (the
``sgm8_full`` frame's [2,128,750,1000] and the Teddy [2,60,375,450] in
float32, and fullres_occfill frame B's [1,256,1280,1500] in bfloat16) and
each of the eight directions, every variant in turn: device time between
CUDA events around one launch, a 256 MiB fill evicting L2 before each,
mean of ``REPS``. A variant that runs the recurrence must equal the
repository's kernel exactly. Prints the registers and spills of each
variant's D = 64 and D = 128 instances, one line a (size, direction,
variant), and for each size and variant the sums over kernel C's four
directions and kernel E's four diagonals, with the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mystereomatching_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

OUT = ROOT / "build" / "variants"
REPS = 10
VARIANTS = ["h16x64_w4x64_d16x64_r4", "h16x64_w4x64_d16x64_r4_copy"]
NAME = re.compile(r"h(\d+)x(\d+)_w(\d+)x(\d+)_d(\d+)x(\d+)_r(\d+)(_copy)?$")
SIZES = {"full": ((2, 128, 750, 1000), torch.float32), "teddy": ((2, 60, 375, 450), torch.float32),
         "frame_b_bf16": ((1, 256, 1280, 1500), torch.bfloat16)}
# direction (rv, ru) -> (kernel, entry point, its direction arguments)
DIRECTIONS = {(1, 0): ("C", "mysm_sgm_scan", (0, 1)), (-1, 0): ("C", "mysm_sgm_scan", (0, 0)),
              (0, 1): ("C", "mysm_sgm_scan", (1, 1)), (0, -1): ("C", "mysm_sgm_scan", (1, 0)),
              (1, -1): ("E", "mysm_sgm_diag", (1, -1)), (1, 1): ("E", "mysm_sgm_diag", (1, 1)),
              (-1, 1): ("E", "mysm_sgm_diag", (-1, 1)), (-1, -1): ("E", "mysm_sgm_diag", (-1, -1))}


def variant_sources(name: str) -> dict:
    """File name -> source of the variant's sgm_band.cuh, sgm_scan.cu and
    sgm_diag.cu."""
    m = NAME.match(name)
    if m is None:
        raise ValueError(f"{name}: not a variant name (h16x64_w4x64_d16x64_r4[_copy])")
    lh, bh, lw, bw, ld, bd, ring = (int(v) for v in m.groups()[:7])

    def sub(pattern: str, repl: str, src: str) -> str:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f"the kernel sources no longer match {pattern!r}")
        return src

    def band(src: str, geom: str, lines: int, box: int) -> str:
        return sub(rf"(struct {geom} {{\n  static constexpr int kLines = )\d+(, kBox = )\d+",
                   rf"\g<1>{lines}\g<2>{box}", src)

    hdr = sub(r"constexpr int kMaxRing = \d+;", f"constexpr int kMaxRing = {ring};",
              (ck.CSRC / "sgm_band.cuh").read_text())
    if m.group(8):
        hdr = sub(r"(\n\s*sgm_steps<T, kSlots, kPitch>\([^;]*\);)", r"\n#if 0\1\n#endif", hdr)
    scan = band(band((ck.CSRC / "sgm_scan.cu").read_text(), "AlongH", lh, bh), "AlongW", lw, bw)
    diag = band((ck.CSRC / "sgm_diag.cu").read_text(), "Diagonal", ld, bd)
    return {"sgm_band.cuh": hdr, "sgm_scan.cu": scan, "sgm_diag.cu": diag}


def compile_libs(dirs: dict, files, entry_points, kernel_re: str) -> dict:
    """name -> the loaded library of each name's directory ``dirs[name]``:
    nvcc builds ``files`` of it into one library under ``build/variants/``
    (one nvcc a name, all at once; headers not beside the sources come from
    this tree's csrc/), and binds ``entry_points`` with this tree's
    signatures. Prints the registers and spills of each kernel whose mangled
    name matches ``kernel_re`` (its first group is printed)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    stem = "_".join(Path(f).stem for f in files)
    procs, libs = {}, {}
    for name, src in dirs.items():
        out = OUT / re.sub(r"\W", "_", name)
        out.mkdir(parents=True, exist_ok=True)
        libs[name] = out / f"lib_{stem}.so"
        cmd = [nvcc, *ck.NVCC_FLAGS, "-I", str(ck.CSRC), "-shared", "-o", str(libs[name]),
               *(str(Path(src) / f) for f in files)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(kernel_re, line)
            if m and "Compiling entry" in line:
                print(f"{name}: {m.group(1)}: {lines[i + 2].strip()}; {lines[i + 3].strip()}")
        lib = ctypes.CDLL(str(libs[name]))
        for fn in entry_points:
            getattr(lib, fn).argtypes = ck._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def build(names) -> dict:
    """name -> the loaded library of each variant; prints its ptxas lines."""
    dirs = {}
    for name in names:
        if Path(name).is_dir():
            dirs[name] = name
            continue
        d = OUT / re.sub(r"\W", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        for file, text in variant_sources(name).items():
            (d / file).write_text(text)
        dirs[name] = d
    return compile_libs(dirs, ("sgm_scan.cu", "sgm_diag.cu"),
                        ("mysm_sgm_scan", "mysm_sgm_diag", "mysm_sgm_scan_bf16",
                         "mysm_sgm_diag_bf16"), r"(sgm_(?:scan|diag)_kernelIf\w*?)EEv")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    runs = sys.argv[1:] or VARIANTS
    libs = build(dict.fromkeys(runs))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty((256 << 20) // 4, dtype=torch.int32, device=dev)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    stream = torch.cuda.current_stream().cuda_stream
    for size, ((g, nd, h, w), dtype) in SIZES.items():
        vol = (torch.rand((g, nd, h, w), generator=gen, device=dev) * 3).to(dtype)
        ps = torch.where(torch.rand((g, h, w), generator=gen, device=dev) < 0.3, 0.25, 1.0)
        out = torch.empty_like(vol)
        sums = {}  # (run, kernel) -> ms
        for direction, (kernel, fn, args) in DIRECTIONS.items():
            fn += "_bf16" if dtype == torch.bfloat16 else ""
            if kernel == "C":
                want = ck.sgm_scan(vol, ps, 1.0, 3.0, 2 + args[0], bool(args[1]))
            else:
                want = ck.sgm_diag_scan(vol, ps, 1.0, 3.0, *args)
            for i, name in enumerate(runs):
                def launch():
                    rc = getattr(libs[name], fn)(vol.data_ptr(), ps.data_ptr(), out.data_ptr(),
                                                 g, nd, h, w, *args, 1.0, 3.0, stream)
                    if rc:
                        raise RuntimeError(f"{name} {direction}: launch failed ({rc})")

                launch()
                torch.cuda.synchronize()
                equal = torch.equal(out, want)
                if not name.endswith("_copy") and not equal:
                    raise AssertionError(f"{name} {direction} {size}: differs from the kernel")
                total = 0.0
                for _ in range(REPS):
                    flush.fill_(0)
                    start.record()
                    launch()
                    stop.record()
                    torch.cuda.synchronize()
                    total += start.elapsed_time(stop)
                sums[i, kernel] = sums.get((i, kernel), 0.0) + total / REPS
                print(f"{size} {list(vol.shape)} kernel {kernel} direction {direction} run {i} "
                      f"{name}: {total / REPS:.4f} ms (equal to the kernel: {equal}) [{card}]",
                      flush=True)
        for i, name in enumerate(runs):
            print(f"{size} {list(vol.shape)} run {i} {name}: kernel C, 4 directions, "
                  f"{sums[i, 'C']:.4f} ms; kernel E, 4 diagonals, {sums[i, 'E']:.4f} ms [{card}]")
        del vol, ps, out, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
