#!/usr/bin/env python3
"""The copy-bandwidth probe ``copy_bw`` of other trees, or of candidate
designs, against this tree's, checked and timed on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/copy_bw_variants.py DIR [DIR ...]

Each DIR holds a ``copy_bw.cu`` with this tree's C interface
(``mysm_copy_bw``), such as the ``csrc/`` of an earlier commit unpacked with
``git archive``, or this tree's own ``mystereomatching_tpu_torch/csrc``.
Every DIR is built at once under ``build/variants/``, one nvcc each, by the
build step of ``tools/sgm_band_variants.py``, which prints each kernel's
registers and spills. A DIR named twice is built once and timed twice.

Cases, as ``tools/check_bw.py`` makes them (``torch.rand`` from seed 0):
the 4 GiB buffer [262144, 4096] in tiles of 8 x 4096, and the TPU probe's
[4, 375, 60, 450] in its four tiles (as [90000, 450] rows: W = 450, so
every build takes its float path there). Each build must equal
``x * 1.0001`` bit for bit on each case and, in the probe's tiles, on
1,000 of its rows one float off 16-byte alignment. Then, in turns (the
DIRs in order, then in reverse), each build's device time from ``torch.profiler`` with a 256 MiB
fill evicting L2 before each call (``chip_smoke.device_ms``), beside
``torch.mul`` (``x * 1.0001``) and ``Tensor.copy_`` in the same turn: one
line a (case, build, turn) with its rate, its share of the nominal
3.35 TB/s, its time over each library call's, and the card's name and power
limit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import check_bw  # noqa: E402
import sgm_band_variants  # noqa: E402
from mystereomatching_tpu_torch.ops import bandwidth  # noqa: E402


def copy(lib, x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``ck.copy_bw`` through the library ``lib``."""
    w = x.shape[-1]
    out = torch.empty_like(x)
    vec = 4 if (w % 4 == 0 and cols % 4 == 0 and x.data_ptr() % 16 == 0
                and out.data_ptr() % 16 == 0) else 1
    rc = lib.mysm_copy_bw(x.data_ptr(), out.data_ptr(), x.numel() // w, w, rows, cols, vec,
                          torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"mysm_copy_bw failed with error {rc}")
    return out


def cases(dev):
    """(label, input, tile) of each timed case, the 4 GiB buffer first."""
    yield (f"buffer {list(check_bw.BIG_SHAPE)} (4 GiB), tile {check_bw.BIG_TILE}",
           check_bw.big_buffer(dev), check_bw.BIG_TILE)
    yield from check_bw.probe_cases(dev)


def main(dirs) -> int:
    if not torch.cuda.is_available() or not dirs:
        print("usage: a CUDA device and python3 tools/copy_bw_variants.py DIR [DIR ...]",
              file=sys.stderr)
        return 1
    card_line = cs.card()
    dev = torch.device("cuda", 0)
    libs = sgm_band_variants.compile_libs({d: d for d in dict.fromkeys(dirs)}, ["copy_bw.cu"],
                                          ["mysm_copy_bw"], r"(copy_bw_kernel\w*)")
    order = list(dirs) + list(reversed(dirs))
    for label, x, (rows, cols) in cases(dev):
        checks = [(x, bandwidth.scaled_copy_plain(x))]
        if x.shape[-1] == 450:
            off = x.view(-1)[1:1 + 450 * 1000].view(1000, 450)
            checks.append((off, bandwidth.scaled_copy_plain(off)))
        for d, lib in libs.items():
            for v, want in checks:
                if not torch.equal(copy(lib, v, rows, cols), want):
                    raise AssertionError(f"{d}: differs from x * 1.0001 on {label} "
                                         f"(data_ptr % 16 = {v.data_ptr() % 16})")
        del checks
        out = torch.empty_like(x)
        sums = {}
        for turn, d in enumerate(order):
            ms, ms_from = cs.device_ms(lambda: copy(libs[d], x, rows, cols), "copy_bw")
            mul_ms = cs.device_ms(lambda: x * bandwidth.COPY_SCALE)[0]
            copy_ms = cs.device_ms(lambda: out.copy_(x))[0]
            sums.setdefault(d, []).append(ms)
            rate = check_bw.gbs(x, ms)
            print(f"copy_bw {label}, {d} (turn {turn}): {ms:.4f} ms ({ms_from}), {rate:.1f} "
                  f"GB/s, {rate / 3350:.3f} of 3.35 TB/s; torch.mul {mul_ms:.4f} ms (kernel / "
                  f"mul {ms / mul_ms:.3f}); Tensor.copy_ {copy_ms:.4f} ms (kernel / copy_ "
                  f"{ms / copy_ms:.3f}) [{card_line}]")
        for d, times in sums.items():
            print(f"copy_bw {label}, {d}: mean {sum(times) / len(times):.4f} ms over "
                  f"{len(times)} turns [{card_line}]")
        del x, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
