#!/usr/bin/env python3
"""Copy bandwidth of one GPU: the hand-written probe kernel ``copy_bw``
(``csrc/copy_bw.cu``, out = in * 1.0001) against ``Tensor.copy_`` and
``torch.mul`` (``x * 1.0001``, the same function).

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/check_bw.py

Counterpart of ``scripts/check_bw.py``, the TPU probe that times the same
scaled copy of a [4, 375, 60, 450] float32 array (161 MB) in four VMEM
block shapes. Here the array is viewed as [90000, 450] rows and the kernel
takes tiles of the minor two dimensions of those blocks ((60, 256),
(64, 512), (64, 128), (60, 450): rows x columns, a block a tile); then a
4 GiB buffer viewed as [262144, 4096] in tiles of (8, 4096).
Each kernel result must equal ``x * 1.0001`` bit for bit. Each rate is the
bytes read and written (twice the buffer) over the mean device time between
CUDA events around ``REPS`` calls, after a warm-up; the buffers exceed the
50 MB L2. Prints one line a case with the card's name and power limit, and
the largest rate on the 4 GiB buffer last.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mystereomatching_tpu_torch.ops import bandwidth  # noqa: E402
from mystereomatching_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

PROBE_SHAPE = (4, 375, 60, 450)
# the TPU probe's block shapes -> their minor two dimensions as a tile
PROBE_TILES = {(4, 8, 60, 256): (60, 256), (1, 8, 64, 512): (64, 512),
               (4, 24, 64, 128): (64, 128), (1, 375, 60, 450): (60, 450)}
BIG_SHAPE = (262144, 4096)      # 4 GiB of float32
BIG_TILE = (8, 4096)
REPS = 20


def events_ms(fn, reps: int = REPS) -> float:
    """Mean ms of fn() between two CUDA events around ``reps`` calls, after
    a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def gbs(x: torch.Tensor, ms: float) -> float:
    return 2 * x.numel() * x.element_size() / (ms * 1e-3) / 1e9


def probe_cases(dev):
    """(label, input, tile) of the probe's shape in each tile."""
    x = torch.rand(PROBE_SHAPE, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    for block, tile in PROBE_TILES.items():
        yield f"probe {list(PROBE_SHAPE)} (TPU block {block}), tile {tile}", x, tile


def big_buffer(dev) -> torch.Tensor:
    """The 4 GiB float32 buffer, [262144, 4096], from seed 0."""
    return torch.rand(BIG_SHAPE, generator=torch.Generator(device=dev).manual_seed(0), device=dev)


def check(x: torch.Tensor, rows: int, cols: int, label: str) -> None:
    """Raises where the kernel differs from its plain version on x."""
    if not torch.equal(ck.copy_bw(x, rows, cols), bandwidth.scaled_copy_plain(x)):
        raise AssertionError(f"copy_bw {label}: differs from x * 1.0001")


def run(dev, card_line: str, big: bool = True):
    """Checks and times every probe tiling, and the 4 GiB buffer unless
    ``big`` is false, each beside ``Tensor.copy_`` and ``torch.mul``
    (``x * 1.0001``); raises where the kernel
    differs from its plain version. Returns the kernel's rate on the 4 GiB
    buffer in GB/s, or None without it."""
    cases = list(probe_cases(dev))
    if big:
        cases.append((f"buffer {list(BIG_SHAPE)} (4 GiB)", big_buffer(dev), BIG_TILE))
    rate = None
    for label, x, (rows, cols) in cases:
        check(x, rows, cols, label)
        ms = events_ms(lambda: ck.copy_bw(x, rows, cols))
        out = torch.empty_like(x)
        lib_ms = events_ms(lambda: out.copy_(x))
        mul_ms = events_ms(lambda: x * bandwidth.COPY_SCALE)
        rate = gbs(x, ms)
        print(f"copy_bw {label}: {ms:.4f} ms, {rate:.1f} GB/s; Tensor.copy_ {lib_ms:.4f} ms, "
              f"{gbs(x, lib_ms):.1f} GB/s; torch.mul {mul_ms:.4f} ms, {gbs(x, mul_ms):.1f} "
              f"GB/s [{card_line}]")
        del out
    del cases
    if not big:
        return None
    print(f"copy_bw measured copy rate (4 GiB buffer): {rate:.1f} GB/s, "
          f"{rate / 3350:.3f} of the nominal 3.35 TB/s [{card_line}]")
    return rate


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
