#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compile the CUDA kernels from ``mystereomatching_tpu_torch/csrc``;
3. kernels: each kernel against its plain torch version on the card, on
   the inputs the main path gives it for a Teddy-sized pair
   (375x450, D=60); every kernel must equal its plain version exactly;
4. slice: ``StereoPipeline(default_config(do_refine=False), "cuda")`` on
   the three golden scenes; the left WTA map must match the reference
   binary's (tests/golden/*_wta.bin) within the JAX package's budgets
   (0, 0 and 2 px), and every kernel's launch count must move;
5. timing: ms/frame and MP*disp/s of the kernel path and of the same
   pipeline with every kernel replaced by its plain torch version, and
   each kernel's time beside its plain version's.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from mystereomatching_tpu_torch import StereoPipeline, default_config
from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.ops import aggregation as agg_ops
from mystereomatching_tpu_torch.ops import arms as arms_ops
from mystereomatching_tpu_torch.ops import cost as cost_ops
from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops import sgm as sgm_ops
from mystereomatching_tpu_torch.ops import wta as wta_ops
from mystereomatching_tpu_torch.pipeline import to_gray
from mystereomatching_tpu_torch.utils.metrics import bad_pixel_rate

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
TEDDY = dict(h=375, w=450, max_disp=59, seed=0)
# scene -> (make_synthetic_pair arguments, WTA px budget of the JAX golden test)
SCENES = {
    "small_scale": (dict(h=144, w=192, max_disp=23, seed=3), 0),
    "tsukuba_scale": (dict(h=288, w=384, max_disp=15, seed=1), 0),
    "teddy_scale": (TEDDY, 2),
}
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "arms_grow": ("mystereomatching_tpu_torch/csrc/arms_grow.cu",
                  "mystereomatching_tpu/ops/pallas_kernels.py:1069"),
    "arm_taps": ("mystereomatching_tpu_torch/csrc/arm_taps.cu",
                 "mystereomatching_tpu/ops/pallas_kernels.py:67"),
    "sgm_scan": ("mystereomatching_tpu_torch/csrc/sgm_scan.cu",
                 "mystereomatching_tpu/ops/pallas_kernels.py:762"),
    "wta": ("mystereomatching_tpu_torch/csrc/wta.cu",
            "mystereomatching_tpu/ops/pallas_kernels.py:718"),
}
FRAME_REPS = 10


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() in ms, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def load_ref_disp(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        return np.frombuffer(f.read(h * w * 2), np.int16).reshape(h, w).astype(np.int32)


def plain_path():
    """Route every kernel-backed op to its plain torch version, on any device."""
    return mock.patch.object(ck, "on_cuda", lambda t: False)


def phase_environment(card_line: str) -> None:
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {card_line}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    print(f"devices: {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")


def phase_build() -> None:
    t0 = time.perf_counter()
    log = ck.build()
    ck._load()
    print(f"build: {time.perf_counter() - t0:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  nvcc: {line.strip()}")


def teddy_inputs(dev):
    """The inputs the main path gives each kernel for the Teddy-sized pair."""
    cfg = default_config(max_disp=TEDDY["max_disp"], do_refine=False)
    pair = make_synthetic_pair(**TEDDY)
    left = torch.from_numpy(pair.left).to(dev, torch.float32)
    right = torch.from_numpy(pair.right).to(dev, torch.float32)
    with plain_path():
        arms = [arms_ops.build_arms(img, cfg) for img in (left, right)]
        gl, gr = to_gray(left), to_gray(right)
        raw, agg, arms_int = [], [], []
        for lor in (0, 1):
            vol = cost_ops.compute_cost_volume(left, right, gl, gr, cfg, lor, arms=arms[lor])
            ai = arms_ops.intersect_arms(arms[0], arms[1], cfg.num_disp, lor)
            raw.append(vol)
            arms_int.append(ai)
            agg.append(agg_ops.cbca(vol, ai, cfg.cbca_iterations, cfg.arm_l_out))
        vols = torch.stack(agg).contiguous()
        pscales = {d: torch.stack([sgm_ops.penalty_scale(img, *d, cfg.sgm_cor_dif_thres,
                                                         cfg.sgm_redu_coeff)
                                   for img in (left, right)]).contiguous()
                   for d in sgm_ops.DIRECTIONS_8[:4]}
        sgm_vol = sgm_ops.sgm_multi(agg, [left, right], 4, cfg.sgm_p1_eff, cfg.sgm_p2_eff,
                                    cfg.sgm_cor_dif_thres, cfg.sgm_redu_coeff)[0]
    return cfg, left, raw[0], arms_int[0], vols, pscales, sgm_vol


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs plain "
                             f"{want.dtype}{tuple(want.shape)}")
    err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: differs from its plain version, max |err| {err}")
    return err


def phase_kernels(dev, card_line: str):
    cfg, left, vol, ai, vols, pscales, sgm_vol = teddy_inputs(dev)
    m = cfg.arm_l_out
    sched = [float(cfg.cbca_c_thresh if k <= cfg.cbca_cross_l else cfg.cbca_c_thresh_out)
             for k in range(1, cfg.cbca_cross_l_out + 1)]
    neigh, min_arm = float(cfg.cbca_c_thresh), cfg.cbca_min_arm
    arm_l, arm_r, arm_u, arm_d = ai.unbind(0)
    dirs = [(d, 2 if d[1] == 0 else 3, d[0] > 0 if d[1] == 0 else d[1] > 0)
            for d in sgm_ops.DIRECTIONS_8[:4]]

    def taps_iteration(sum_fn, area_fn):
        v1 = sum_fn(vol, arm_l, arm_r, 2, m)
        return area_fn(v1, arm_l, arm_r, arm_u, arm_d, 1, m)

    def sgm_all(fn):
        return [fn(vols, pscales[d], cfg.sgm_p1_eff, cfg.sgm_p2_eff, axis, rev)
                for d, axis, rev in dirs]

    cases = {
        "arms_grow": (lambda: ck.arms_grow(left, sched, neigh, min_arm),
                      lambda: arms_ops.grow_arms_plain(left, sched, neigh, min_arm),
                      "arms of one 375x450 image"),
        "arm_taps": (lambda: taps_iteration(
                         ck.arm_taps,
                         lambda v, a1, b1, a2, b2, ax, mm: ck.arm_taps(v, a2, b2, ax, mm, a1, b1)),
                     lambda: taps_iteration(arms_ops.arm_bounded_sum_plain,
                                            arms_ops.arm_bounded_sum_area_plain),
                     "one CBCA iteration (sum pass along W + area pass along H), D=60"),
        "sgm_scan": (lambda: torch.stack(sgm_all(ck.sgm_scan)),
                     lambda: torch.stack(sgm_all(sgm_ops.sgm_scan_plain)),
                     "4 directions over the left+right pair [2,60,375,450]"),
        "wta": (lambda: ck.wta(sgm_vol), lambda: wta_ops.wta_plain(sgm_vol),
                "one [60,375,450] volume"),
    }
    rows = {}
    for name, (kernel, plain, what) in cases.items():
        err = compare(name, kernel(), plain())
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, reps=3)
        print(f"kernel {name}: equal to plain (max |err| {err}); {what}: "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms [{card_line}]")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rows


def phase_slice(dev) -> dict:
    ck.reset_launches()
    results = {}
    for name, (params, _) in SCENES.items():
        pair = make_synthetic_pair(name=name, **params)
        pipe = StereoPipeline(default_config(max_disp=params["max_disp"], do_refine=False),
                              device=dev)
        out = pipe(pair.left, pair.right)
        torch.cuda.synchronize()
        results[name] = (pair, out)
    counts = dict(ck.launches)
    print(f"launches on the main path: {json.dumps(counts)}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for name, (pair, out) in results.items():
        params, budget = SCENES[name]
        h, w, nd = params["h"], params["w"], params["max_disp"] + 1
        for key in ("disp_left_raw", "disp_right_raw"):
            d = out[key]
            if d.shape != (h, w) or d.dtype != torch.int32 or d.device != dev:
                raise AssertionError(f"{name} {key}: {d.dtype}{tuple(d.shape)} on {d.device}")
            if int(d.min()) < 0 or int(d.max()) >= nd:
                raise AssertionError(f"{name} {key}: values outside [0, {nd})")
        disp = out["disparity"]
        if not bool(torch.isfinite(disp).all()):
            raise AssertionError(f"{name}: non-finite disparity")
        ref = load_ref_disp(os.path.join(GOLDEN, f"{name}_wta.bin"))
        n_diff = int((out["disp_left_raw"].cpu().numpy() != ref).sum())
        bad1 = bad_pixel_rate(disp, torch.from_numpy(pair.gt),
                              torch.from_numpy(pair.masks["nonocc"]))
        print(f"slice {name}: WTA differs from the reference binary at {n_diff} px "
              f"(budget {budget}); bad-1.0 nonocc {bad1:.6f}")
        if n_diff > budget:
            raise AssertionError(f"{name}: WTA differs at {n_diff} px > {budget}")
    return counts


def frame_ms(pipe, left, right):
    """Median and quartiles of host-clock ms per frame, each synchronised."""
    pipe(left, right)
    torch.cuda.synchronize()
    times = []
    for _ in range(FRAME_REPS):
        t0 = time.perf_counter()
        pipe(left, right)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return np.percentile(times, [25, 50, 75])


def phase_timing(dev, card_line: str) -> None:
    pair = make_synthetic_pair(**TEDDY)
    pipe = StereoPipeline(default_config(max_disp=TEDDY["max_disp"], do_refine=False),
                          device=dev)
    left = torch.from_numpy(pair.left).to(dev)
    right = torch.from_numpy(pair.right).to(dev)
    mp_disp = TEDDY["h"] * TEDDY["w"] * (TEDDY["max_disp"] + 1) / 1e6
    kernel_out = pipe(left, right)
    with plain_path():
        plain_out = pipe(left, right)
    for key in ("disp_left_raw", "disp_right_raw"):
        if not torch.equal(kernel_out[key], plain_out[key]):
            raise AssertionError(f"kernel and plain paths disagree on {key}")
    for label, ctx in (("plain", plain_path), ("kernel", contextlib.nullcontext),
                       ("kernel", contextlib.nullcontext), ("plain", plain_path)):
        with ctx():
            q1, med, q3 = frame_ms(pipe, left, right)
        print(f"timing {label} path, Teddy 375x450 D=60, left+right: median {med:.3f} ms/frame "
              f"(quartiles {q1:.3f}-{q3:.3f}, n={FRAME_REPS}), {mp_disp / med * 1e3:.3f} "
              f"MP*disp/s [{card_line}]")


def main() -> int:
    card_line = card() if torch.cuda.is_available() else "no card"
    phase_environment(card_line)
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev, card_line)
    counts = phase_slice(dev)
    phase_timing(dev, card_line)
    kernels = [dict(name=name, route="cuda", source=src, replaces=tpu,
                    launches=counts[name], **rows[name])
               for name, (src, tpu) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
