#!/usr/bin/env python3
"""Kernel A (``csrc/arms_grow.cu``) and region vote (``csrc/region_vote.cu``)
against their variants, checked and timed on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/arms_vote_variants.py [DIR ...]

Kernel A: this tree's ``arms_grow.cu`` (``this``) and each DIR's, such as
another tree's ``csrc/`` unpacked with ``git archive``; a DIR's kernel
whose source has no ``__grid_constant__`` (the trees before the schedule
became a launch parameter) is given the schedule as a float32 array on
the card. Region vote: this tree's ``region_vote.cu`` built at each tile
height of ``TILE_HEIGHTS`` (its ``kTileH`` rewritten). Every build is made
at once under ``build/variants/``, one nvcc each, by the build step of
``tools/sgm_band_variants.py``, which prints each kernel's registers and
spills.

Cases, with the default preset's arms (``default_config``: l_out and
max_arm 34): kernel A on the Teddy pair's left image (375x450), frame C's
two images (1988x2880, ``make_synthetic_pair`` as ``chip_smoke.py`` makes
them), ``chip_smoke.fullres_image`` (flat 24-px blocks plus noise) and a
flat 1988x2880 image (every arm the full l_out); region vote on the Teddy
frame's LR map (``chip_smoke.teddy_inputs``), frame C's classified LR map
(one frame of its streamed pipeline) and ``chip_smoke.fullres_inputs``'s
blocky map with 20% holes, each with its left image's arms. Every build
must equal the plain version (``arms.grow_arms_plain``,
``refine.region_vote_plain``) bit for bit; then, in turns (each build in
order, then in reverse), its device time between CUDA events around one
call, a 256 MiB fill evicting L2 before each, mean of ``REPS``: one line a
(case, build, turn) with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import sgm_band_variants  # noqa: E402
from mystereomatching_tpu_torch import StereoPipeline, default_config  # noqa: E402
from mystereomatching_tpu_torch.data import make_synthetic_pair  # noqa: E402
from mystereomatching_tpu_torch.models import get_model  # noqa: E402
from mystereomatching_tpu_torch.ops import arms as arms_ops  # noqa: E402
from mystereomatching_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from mystereomatching_tpu_torch.ops import refine as refine_ops  # noqa: E402

REPS = 20
TILE_HEIGHTS = (32, 64)


def images(pair, dev) -> list:
    return [torch.from_numpy(x).to(dev, torch.float32).contiguous()
            for x in (pair.left, pair.right)]


def arms_cases(dev, frame_c: list) -> dict:
    """case -> the [H, W, 3] float32 images one timed run grows arms of."""
    blocky = torch.from_numpy(cs.fullres_image(np.random.default_rng(0))).to(dev)
    return {"Teddy left image 375x450": images(make_synthetic_pair(**cs.TEDDY), dev)[:1],
            "frame C's two images 1988x2880": frame_c,
            "blocky 1988x2880 (chip_smoke.fullres_image)": [blocky],
            "flat 1988x2880": [torch.full(cs.FULLRES + (3,), 77.0, device=dev)]}


def vote_cases(dev, frame_c: list) -> dict:
    """case -> (int32 [H, W] map, its left image's raw [4, H, W] arms)."""
    t = cs.teddy_inputs(dev)
    params, overrides = cs.FRAME_C
    cfg = get_model("fullres_occfill", max_disp=params["max_disp"], **overrides)
    out = StereoPipeline(cfg, device=dev)(*frame_c)
    lrc = refine_ops.lr_consistency_classify(out["disp_left_raw"], out["disp_right_raw"],
                                             cfg.num_disp, cfg.lr_max_diff, cfg.disp_occ,
                                             cfg.disp_mis)
    f = cs.fullres_inputs(dev)
    return {"Teddy LR map 375x450": (t["lrc"], t["arms"][0]),
            "frame C's LR map 1988x2880": (lrc, arms_ops.build_arms(frame_c[0], cfg)),
            "blocky 1988x2880 map, 20% holes": (f["disp"], arms_ops.cross_arms(f["img"]))}


def vote_sources() -> dict:
    """build name -> a directory holding region_vote.cu at that tile height."""
    src = (ck.CSRC / "region_vote.cu").read_text()
    pattern = r"constexpr int kTileH = \d+;"
    if len(re.findall(pattern, src)) != 1:
        raise SystemExit("region_vote.cu: no single kTileH to rewrite")
    dirs = {}
    for th in TILE_HEIGHTS:
        d = sgm_band_variants.OUT / "src" / f"region_vote_h{th}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "region_vote.cu").write_text(re.sub(pattern, f"constexpr int kTileH = {th};", src))
        dirs[f"kTileH {th}"] = d
    return dirs


def timed(label: str, names: list, call, flush, card: str) -> None:
    """Device ms of ``call(name)`` for each name in turn, then in reverse."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for name in names + names[::-1]:
        total = 0.0
        for _ in range(REPS):
            flush.fill_(0)
            start.record()
            call(name)
            stop.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(stop)
        print(f"{label}, {name}: {total / REPS:.4f} ms device [{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = cs.card()
    a_dirs = {"this": ck.CSRC, **{d: Path(d) for d in sys.argv[1:]}}
    for name, d in a_dirs.items():
        if not (d / "arms_grow.cu").is_file():
            raise SystemExit(f"{name}: no arms_grow.cu there")
    on_card = {name for name, d in a_dirs.items()
               if "__grid_constant__" not in (d / "arms_grow.cu").read_text()}
    a_libs = sgm_band_variants.compile_libs(a_dirs, ("arms_grow.cu",), ("mysm_arms_grow",),
                                            r"(arms_grow_kernel)")
    v_libs = sgm_band_variants.compile_libs(vote_sources(), ("region_vote.cu",),
                                            ("mysm_region_vote",), r"(region_vote_kernel)")
    ck.build()
    dev = torch.device("cuda", 0)
    cfg = default_config()
    sched = [float(cfg.cbca_c_thresh if k <= cfg.cbca_cross_l else cfg.cbca_c_thresh_out)
             for k in range(1, cfg.cbca_cross_l_out + 1)]
    sched_host = (ctypes.c_float * len(sched))(*sched)
    sched_dev = torch.tensor(sched, dtype=torch.float32, device=dev)
    neigh, min_arm, m, s_thres = float(cfg.cbca_c_thresh), cfg.cbca_min_arm, cfg.arm_l_out, \
        cfg.rv_s_thres
    flush = torch.empty((256 << 20) // 4, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what}: launch failed ({rc})")

    frame_c = images(make_synthetic_pair(**cs.FRAME_C[0]), dev)
    for case, imgs in arms_cases(dev, frame_c).items():
        outs = [torch.empty((4,) + img.shape[:2], dtype=torch.int32, device=dev)
                for img in imgs]
        wants = [arms_ops.grow_arms_plain(img, sched, neigh, min_arm) for img in imgs]
        mean_arm = float(torch.stack(wants).float().mean())

        def grow(name):
            sched_arg = sched_dev.data_ptr() if name in on_card else sched_host
            for img, out in zip(imgs, outs):
                check(a_libs[name].mysm_arms_grow(img.data_ptr(), sched_arg, out.data_ptr(),
                                                  img.shape[0], img.shape[1], len(sched),
                                                  neigh, min_arm, stream), f"{name} arms_grow")

        for name in a_libs:
            for out in outs:
                out.fill_(-1)
            grow(name)
            torch.cuda.synchronize()
            for out, want in zip(outs, wants):
                if not torch.equal(out, want):
                    raise AssertionError(f"{case}: {name} differs from grow_arms_plain at "
                                         f"{int((out != want).sum())} values")
        timed(f"arms_grow, {case} (mean arm {mean_arm:.2f}, l_out {len(sched)}; every build "
              "equal to grow_arms_plain)", list(a_libs), grow, flush, card)
        del outs, wants

    for case, (disp, arms) in vote_cases(dev, frame_c).items():
        disp, arms = disp.contiguous(), arms.contiguous()
        want = refine_ops.region_vote_plain(disp, arms, s_thres, m)
        out = torch.empty_like(disp)
        h, w = disp.shape

        def vote(name):
            check(v_libs[name].mysm_region_vote(disp.data_ptr(), arms.data_ptr(),
                                                out.data_ptr(), h, w, m, s_thres, stream),
                  f"{name} region_vote")

        for name in v_libs:
            out.fill_(-7)
            vote(name)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{case}: {name} differs from region_vote_plain at "
                                     f"{int((out != want).sum())} px")
        timed(f"region_vote, {case} ({int((disp < 0).sum())} invalid px, max_arm {m}; every "
              "build equal to region_vote_plain)", list(v_libs), vote, flush, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
