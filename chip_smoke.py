#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compile the CUDA kernels from ``mystereomatching_tpu_torch/csrc``
   (one nvcc a source, all started together);
3. kernels: each kernel against its plain torch version on the card, on
   the inputs the default preset gives it for a Teddy-sized pair (375x450,
   D=60), with its device time (torch.profiler; CUDA events around each
   call where the profiler drops events), its time between CUDA
   events around the wrapper, its plain version's and its bound (kernel E,
   ``sgm_diag``, on the same CBCA volumes); then kernel B on a
   [32, 1988, 2880] volume and the proper-interpolation kernel on a
   1988x2880 map (full resolution). Region vote is measured twice: as one
   iteration's four ``arm_reduce`` passes (on no path) and as one pass of
   ``region_vote`` (one launch). Every kernel must equal its plain version
   exactly (``torch.equal``);
4. slice: ``StereoPipeline(default_config(do_refine=False), "cuda")`` and
   then ``StereoPipeline(default_config(), "cuda")`` (refine on) on the
   three golden scenes and the adversarial one (``adv_small``:
   ``make_adversarial_pair(h=144, w=192, max_disp=23, seed=3)``), each with
   the launch counts set to 0 just before it. The left WTA map must match
   the reference binary's (tests/golden/*_wta.bin) within the JAX package's
   budgets (0, 0, 2 and 0 px), the refined map (tests/golden/*_final.bin)
   at 0 px on every scene, and every kernel of each path must have
   launched;
5. sgm8_full: the preset ``get_model("sgm8_full", max_disp=127)`` on a
   750x1000 pair (Middlebury half resolution, D=128, left and right
   volumes). Kernel B's four launch kinds (sum along W, area along H, sum
   along H, area along W) on the frame's CBCA input [128, 750, 1000] and
   intersected arms, each against its plain version with its bound; kernels
   C (4 axis directions) and E (4 diagonals) against their plain versions
   on the frame's own CBCA volumes [2, 128, 750, 1000], with the device time
   of each direction; one frame with the launch counts set to 0
   just before it, in which all seven kernels must launch (``sgm_diag``
   4 times) and whose three maps must equal the plain path's; its bad-1.0
   rate; kernel and plain frame times, peak device memory, and a profile;
6. fullres_occfill: the preset at its two bench-suite configurations
   (scripts/bench_suite.py:53-58), uncut: A, ``get_model("fullres_occfill",
   max_disp=191)`` at 1000x1400 (float32, left and right volumes), and B,
   ``get_model("fullres_occfill", max_disp=255, vol_dtype="bfloat16",
   compute_both_volumes=False)`` at 1280x1500 (one bfloat16 volume, the
   cooperative WTA). On B's own inputs the bfloat16 instances of kernels B
   (its four launch kinds on the CBCA input), C (4 axis directions) and E
   (4 diagonals) on the CBCA volume, and D on the cooperative WTA's two
   volumes, each against its plain version with its bound at the bfloat16
   widths. Each frame with the launch counts set to 0 just before it: the
   asserted launches (kernel B 8 times in A, 4 in B, and in B every launch
   of B, C and D a bfloat16 one), the three maps equal to the plain path's,
   both DISP_OCC and DISP_MIS in its classifying LR check, its bad-1.0
   rate, kernel and plain frame times, peak device memory and a profile;
7. fullres_occfill frame C: the preset's third bench-suite configuration
   (scripts/bench_suite.py:59-63), uncut: ``get_model("fullres_occfill",
   max_disp=255, vol_dtype="bfloat16", compute_both_volumes=False,
   d_stream_block=32)`` at 1988x2880, cost and CBCA streamed over eight
   32-disparity blocks. The streamed frame and the same configuration
   unstreamed (the dense path), each with the launch counts set to 0 just
   before it and its peak device memory: the streamed frame's launches
   (kernel B 32 times, every launch of B, C and D a bfloat16 one), its three
   maps equal to the dense kernel path's and to the streamed plain path's
   (one frame, untimed, its seconds printed), its peak at most half of the
   dense frame's; both paths' frame times and profiles. Then each kernel at
   the shapes this frame launches it, against its plain version: A on the
   two images, B's four launch kinds on one [32, 1988, 2880] block, C's
   four directions on the [1, 256, 1988, 2880] CBCA volume, D on the
   cooperative WTA's two volumes, the region vote's four integer passes
   (``arm_reduce``) and its one-launch pass (``region_vote``) on the frame's
   LR map and proper interpolation on its region-voted map;
8. row bands: the row-band pipeline (``parallel.run_row_bands``), one
   process a rank, one card a rank over NCCL where there are cards enough,
   else every rank on card 0 over gloo (the phase prints which). First
   kernel C's table kernel (``sgm_scan_ext``: a table of W-chunk scans
   along H with carried-in rows, in-image masks and boundary-row outputs,
   read and written in place) against the plain table, in float32 and
   bfloat16, each with its bound, device time, and device time at each
   block width it is built for (16 and 4 columns, with the ring depth,
   shared memory and blocks an SM each allows), on the sgm8_full frame's
   two CBCA volumes as the band path scans them: band 1's down-order chunk
   step (6 scans: the vertical W chunk [1, 128, 250, 125] and the two
   diagonals' chunks [1, 128, 250, 219] of their skewed buffers with their
   in-image masks, for both volumes; chunk 1, from band 0's boundary rows)
   in one launch, and its vertical and first diagonal scan alone; each of
   those two also (``whole_band``) over its whole buffer [1, 128, 250,
   1000] or [1, 128, 250, 1749] from a random initial row. Then
   over 3 bands of 250 rows, 8 W chunks: the downward vertical path costs
   and two diagonals' gathered on rank 0 must equal kernels C's and E's on
   the whole volume bit for bit; sgm8_full's three maps (raw, refined
   integer, float) must equal the dense pipeline's with its directions
   summed in the band path's order (the same kernels' path costs, another
   association than the dense sum's) exactly; against the dense maps the
   differing pixels are counted, and the float map may differ by more
   than 1e-4 at no more than 16 pixels and by 1e-2 nowhere. On every rank
   of every measured banded frame, each band scan along H must have gone
   through the table kernel, one launch a chunk step of each band order
   (plain kernel C only for the two horizontal directions). Then kernel
   C's table kernel as above on frame A's two CBCA volumes (the chunk step
   of its 2 vertical scans [1, 192, 250, 175], and one alone), then
   fullres_occfill's frame A over 4 bands through ``run_row_bands``: its
   map must equal the dense map exactly; then frame A over 2 bands x 2
   blocks of 96 disparities (``n_disp=2``: each rank builds the cost and
   CBCA of its block, and an all-gather over the 'disp' group rebuilds the
   band's volume), whose map must equal the dense map exactly too. Each
   banded frame is run again through the measurement harness
   (``parallel._harness``), three frames, and prints its wall time, each
   rank's device time, peak memory, launches and communication (halo,
   wavefront, all-gather and gather bytes); a failing rank fails the script;
9. copy bandwidth: ``tools/check_bw.py``'s probe kernel ``copy_bw`` (out =
   in * 1.0001) against its plain version, its rate in each tiling and on
   a 4 GiB buffer beside ``Tensor.copy_``'s and ``torch.mul``'s;
10. NL: ``get_model("nl_tree_filter", max_disp=59)`` on the Teddy-sized
   pair (375x450, D=60; the trees built on the card, the JAX package's
   default, the filter level by level on the card), with the launch counts
   set to 0 just before its frame: kernels A, D, ``region_vote`` and
   ``pi_scan`` must launch, and its three maps must equal a second kernel
   frame's, the card's plain path's and the CPU port's, and two tree filter
   runs the same bits; its frame time, tree build, tree height, peak
   device memory, and a profile
   (device time, idle share, launches a frame); then A, D, ``arm_reduce``,
   ``region_vote`` and ``pi_scan`` at its shapes on its inputs against their plain
   versions. ``nl_post`` and ``nl_census_post`` on the golden scenes
   ``small_scale``, ``adv_small`` and ``teddy_scale``: each frame equal to
   the plain path and the CPU port, and within the JAX golden test's
   budgets of the reference binary's maps
   (tests/golden/*_{adgrad,census}_nl_*.bin; ``nl_post`` 10, 6 and 142 px,
   ``nl_census_post`` 0 px). ``nl_8nr``
   once at Teddy size, equal to the plain path and the CPU port. Then, for
   4 and 8 neighbours, the device-built tree equal to the host-built one
   (parent, weight, BFS order, layout), both builds' ms and the device
   build's launches, and nl_tree_filter's and nl_8nr's frames on host trees
   (``nl_tree_host=True``) equal to theirs on device trees, nl_tree_filter's
   ms/frame on both in turns; the batched path
   ``match_pair_nl_batch`` on 8 Teddy-sized pairs (seeds 0-7), each frame
   equal to ``match_pair``'s, its ms/frame beside the frames' one by one;
   the bfloat16 filter's frame, equal to the CPU port's, its share of
   disparities off the float32 frame's (at most 2%) and its ms/frame; and
   ``entry.entry("cuda", "nl_tree_filter")``, every kernel of its path
   launched, its maps equal to ``entry("cpu", ...)``'s;
11. plane probes: ``tools/micro4.py``'s gathers and cumsums
   (``csrc/plane_probes.cu``) on micro4.py's [375, 450] plane and on the
   NL filter's [168750, 61] rows, each against its plain version (the
   gathers exactly; the kernel's sums equal to the sequential float32 sums
   bit for bit, ``torch.cumsum``'s within
   ``plane_probes.cumsum_tolerance`` of the float64 sum), with its bound
   and the time of ``torch.gather`` or ``torch.cumsum``, and
   ``cumsum_cols``'s time over ``torch.cumsum``'s;
12. census: ``ad_census_wta`` and ``census_wta`` at 288x384, D=16, and
   ``census_cbca_lrc`` at 375x450, D=64 (BASELINE configs 1 and 2 at
   scripts/bench_suite.py:39-40's sizes, uncut), each on
   ``make_synthetic_pair(seed=0)`` with the launch counts set to 0 just
   before its frame: exactly the kernels of ``kernels_launched`` must
   launch (D alone in the first two; A, B and D in census_cbca_lrc), its
   maps must equal the card's plain path's, and census_wta's and
   census_cbca_lrc's the CPU port's (ad_census_wta prints its count of
   differing pixels); each frame's time, peak device memory and profile
   (device time, idle share, launches a frame); then A, B (its four
   launch kinds) and D at census_cbca_lrc's shapes against their plain
   versions, and ``region_vote`` on its LR map (the frame runs none);
13. SGM layouts: ``tools/sgm_layouts.py``'s probes (``csrc/sgm_probes.cu``:
   ``sgm_probe_hdw``, ``sgm_probe_g``, ``sgm_probe_rolled`` in its kinds
   copy, prev and full, ``sgm_probe_unrolled`` in copy and full) on
   [G, H, D, W] = [4, 375, 60, 450] and [2, 750, 128, 1000], each equal to
   its plain version and, in full, to kernel C's downward scan of the
   transposed volume, bit for bit, with its bound, kernel C's time on the
   same values, ``torch.mul``'s for copy, each copy's time over
   ``torch.mul``'s (the rolled and the unrolled copy are one streaming
   pass, so their ratio is a consistency check), and each instance's
   registers and spills;
14. taps probes: ``tools/taps_probes.py``'s probes (``csrc/taps_probes.cu``:
   ``taps_probe_roll`` along H and W, ``taps_probe_slice`` in its kinds
   dyn (H and W), fixed and seg (64, 32), ``taps_probe_clones`` in clones,
   oct and clseg (64, 32, 96), ``taps_probe_static`` at octaves 8, 16 and
   34 on one frame and on 16) on the scripts' [60, 375, 450] volumes with
   max_arm 34, each equal to its plain version bit for bit, with its
   bound, kernel B's sum pass on the same values along the same axis (its
   device time, and the largest difference to it, within (2 max_arm + 1)
   2^-24 sum |terms| at each pixel but for fixed, which is wrong by
   design), and each instance's registers and spills;
15. presets: ``census_cbca_vmtop`` (vmTop in place of WTA),
   ``cbca_double`` (CBCA at two arm scales, merged by combine2Vm_4),
   ``ad_grad_gf`` (the guided filter), ``zncc_bf_wta`` (ZNCC and the box
   filter), ``aws_wta`` (truncated AD and AWS), ``census_fif_sgm`` (FIF),
   ``bt_so`` (the BT cost and scanline optimisation) and ``gfnl_wta``
   (GFNL), at their own widths (``aws_win=17``), and the default preset
   beside them, each on ``make_synthetic_pair(seed=0)`` at 375x450, D=60,
   with the launch counts set to 0 just before its frame: exactly the
   kernels of ``kernels_launched``, each as many times a frame as
   ``PRESET_FRAMES`` says (A and B twice the default frame's on
   cbca_double, D never on census_cbca_vmtop or bt_so, A once on
   aws_wta), the maps equal to the same pipeline's with every kernel
   replaced by its plain version, the median ms/frame of 3 frames on both
   paths, the peak device memory and, for ``PRESETS_ON_CPU``, the pixels
   differing from the CPU port (0 required for bt_so and gfnl_wta;
   aws_wta's on a 96x128 crop, its whole frame taking minutes on the
   host). Then the default
   preset on the committed ``photo_small`` pair
   (``data.load_photo_pair``): 0/0 px off the reference binary's goldens
   (tests/golden/photo_small_{wta,final}.bin), bad-1.0 at least 0.01.
   Then kernel B's four launch kinds of a CBCA pass on cbca_double's left
   raw volume at its large window (max_arm 23) and its small one (34),
   each against its plain version, in turns, and their ratio;
16. costs, arm modes and the pyramid (ROADMAP §1 item 5): the default
   preset on ``make_synthetic_pair(seed=0)`` at 375x450, D=60, as it is
   and with each of the costs ``ad``, ``sd``, ``grad`` (two directions, arm-adaptive),
   ``grad`` in one direction normalised, ``ssd``, ``census_from2`` (both
   blends), ``ad_census_grad`` and ``ad_census_zncc``, with
   ``cbca_arm_mode`` ``multilevel`` and ``adaptive``, with
   ``pyramid_levels`` 2 and 3, and ``ad_census_grad`` streamed in blocks
   of 15 disparities (16 does not divide 60), each with the launch counts
   set to 0 just before its frame: exactly the kernels of
   ``kernels_launched``, each as many times a frame as ``ITEM5_FRAMES``
   says (A and B once a pyramid level, B once a streamed block), the maps
   equal to the card's plain path's (0 px), the streamed frame's to the
   dense frame's, and on the top-left 96x128 crop (the card running the
   crop too) the pixels differing from the CPU port's printed, 0 required
   where ``ITEM5`` says so (the costs without an ``exp``, and the arm
   modes and the pyramid on censusGrad); the median ms/frame of 3 frames
   and the peak device memory above what was held before the frame. Then
   kernel A on the Teddy image and on a blocky 1988x2880 one under the
   two-level, multilevel and adaptive schedules, each against its plain
   version with its bound (bytes at 3.35 TB/s and at ``COPY_BYTES_PER_S``)
   and the steps its walk takes;
17. refinement variants (ROADMAP §1 item 6): the default preset on
   ``make_synthetic_pair(seed=0)`` at 375x450, D=60, in two
   configurations (``ITEM6``) that between them turn on every item-6 flag:
   (a) the classifying LR check, the census border fill, PKR, RV_combine_BG
   (``interpolate_type=3``, ``reg_vote_type=2``, ``bg_ip_dir=4``), the
   KITTI fill, the whole-image vote and double-window CBCA merged by PKR's
   blend (``cbca_combine=1``); (b) the histogram region vote
   (``rv_int_ratio_quirk=False``), CBBI, WM, DA and the last median. Each
   with the launch counts set to 0 just before its frame: exactly the
   kernels of ``kernels_launched``, each as many times a frame as
   ``ITEM6_FRAMES`` says (``arm_reduce`` two launches a histogram vote), the
   maps equal to the card's plain path's and, on the top-left 96x128 crop
   (the card running the crop too), to the CPU port's (0 px); the median
   ms/frame of 3 frames and the peak device memory. Then ``arm_reduce``'s
   sum (both passes of a vote) against its plain version on (b)'s first
   vote's [61, 375, 450] stack and on a seeded [257, 1988, 2880] stack with
   arms up to 34, each with its byte bound;
18. timing: ms/frame and MP*disp/s of the kernel path and of the same
   pipeline with every kernel replaced by its plain torch version, for the
   full default configuration and for ``do_refine=False``, in alternating
   rounds; the refine chain alone, kernel and plain; and the peak device
   memory of a frame;
19. profile: ``torch.profiler`` over frames of the full default
   configuration: device time, idle share, launches per frame, the largest
   device kernels and each hand kernel's device time a launch; ``region_vote``
   must launch twice a frame and ``arm_reduce`` never, and the frame must make
   fewer launches than the same frame profiled with region vote as four
   ``arm_reduce`` passes (both figures printed, the maps equal).

Each phase prints its seconds.

The line before the last is ``{"kernels": [...]}`` (each row's ``case``
names what was measured: kernels B, C and E at full width, on the
``sgm8_full`` frame, with that frame's launches; the bfloat16 instances
``*_bf16`` on frame B, with its launches; kernel C's table kernel
``sgm_scan_ext*`` on a chunk step of the banded sgm8_full frame's and
frame A's inputs, with the launches (and, as ``path_scans``, the scans)
of that banded frame summed over its ranks, 0 for the bfloat16 rows, and
on one scan of that step, with 0 launches (the path launches it only
within the step row that ``within`` names); the rows ``*_frame_c`` at frame C's
shapes, with its launches; ``copy_bw`` on the 4 GiB buffer, on no frame's
path, with the main path's launches, which must be 0, as must
``arm_reduce``'s on the default preset (its rows measure the unanimity
vote's four integer passes, which that vote no longer runs); the rows ``*_nl``
of A, D, ``arm_reduce``, ``region_vote`` and ``pi_scan`` at the
nl_tree_filter frame's shapes, with its launches; the probes ``gather_rows``, ``gather_cols``,
``cumsum_rows`` and ``cumsum_cols`` on micro4.py's plane and, as ``*_nl``,
on the NL filter's rows, on no path, with the main path's launches, which
must be 0, as must the NL frame's; the rows ``*_census`` of A, B, D and
``region_vote`` at census_cbca_lrc's shapes, with its launches; the SGM-layout probes
``sgm_probe_{hdw,g,rolled,unrolled}_{kind}`` on the scripts' shape and, as
``*_sgm8``, on sgm8_full's, on no path, with the main path's launches,
which must be 0, as must the census frame's, and kernel C's time on the
same values as ``kernel_c_ms``; the taps probes ``taps_probe_*`` at the
scripts' first listed parameters (the others are printed only), on no
path, with the main path's launches, which must be 0, as must the census
frame's, kernel B's time on the same values as ``kernel_b_ms`` and the
largest difference to it as ``kernel_b_max_diff``; the rows
``arms_grow_multilevel`` and ``arms_grow_adaptive`` of kernel A on the
Teddy image under those schedules, with the launches of that arm mode's
frame and the bound at ``COPY_BYTES_PER_S`` as ``bound_copy_ms``; the rows
``arm_reduce_hist`` and ``arm_reduce_hist_frame_c`` of the histogram
vote's two sum passes on item 6 (b)'s stack, with that frame's launches,
and on the seeded frame-C-sized stack, with 0 (no frame of the script
runs it there); ``ms_from`` says
whether ``ms`` came from the profiler or from CUDA events); the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from mystereomatching_tpu_torch import StereoPipeline, default_config, match_pair_nl_batch
from mystereomatching_tpu_torch.data import (load_photo_pair, make_adversarial_pair,
                                             make_synthetic_pair)
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import aggregation as agg_ops
from mystereomatching_tpu_torch.ops import arms as arms_ops
from mystereomatching_tpu_torch.ops import bandwidth
from mystereomatching_tpu_torch.ops import cost as cost_ops
from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops import mst
from mystereomatching_tpu_torch.ops import nl as nl_ops
from mystereomatching_tpu_torch.ops import refine as refine_ops
from mystereomatching_tpu_torch.ops import sgm as sgm_ops
from mystereomatching_tpu_torch.ops import wta as wta_ops
from mystereomatching_tpu_torch.parallel import _harness as band_harness
from mystereomatching_tpu_torch.parallel import run_row_bands
from mystereomatching_tpu_torch.parallel.launch import band_pipeline
from mystereomatching_tpu_torch.parallel.mesh import RowMesh
from mystereomatching_tpu_torch.parallel.sharded import (BAND_ORDERS, _band_scan, _cost_halo,
                                                         sgm_band_direction)
from mystereomatching_tpu_torch.pipeline import (compute_volumes, kernels_launched, match_pair,
                                                 nl_trees, refine, to_gray)
from mystereomatching_tpu_torch.utils.metrics import bad_pixel_rate

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
TEDDY = dict(h=375, w=450, max_disp=59, seed=0)
SGM8 = dict(h=750, w=1000, max_disp=127, seed=0)  # Middlebury half resolution, D=128
FULLRES = (1988, 2880)  # the fullres_occfill shape (H, W)
# scene -> (make_synthetic_pair, or with adversarial make_adversarial_pair,
# arguments, WTA px budget of the JAX golden test, adversarial)
SCENES = {
    "small_scale": (dict(h=144, w=192, max_disp=23, seed=3), 0, False),
    "tsukuba_scale": (dict(h=288, w=384, max_disp=15, seed=1), 0, False),
    "teddy_scale": (TEDDY, 2, False),
    "adv_small": (dict(h=144, w=192, max_disp=23, seed=3), 0, True),
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
    "arm_reduce": ("mystereomatching_tpu_torch/csrc/arm_reduce.cu",
                   "mystereomatching_tpu/ops/pallas_kernels.py:67"),
    "region_vote": ("mystereomatching_tpu_torch/csrc/region_vote.cu",
                    "mystereomatching_tpu/ops/pallas_kernels.py:67"),
    "pi_scan": ("mystereomatching_tpu_torch/csrc/pi_scan.cu",
                "mystereomatching_tpu/ops/pallas_kernels.py:483"),
    "sgm_diag": ("mystereomatching_tpu_torch/csrc/sgm_diag.cu",
                 "mystereomatching_tpu/ops/pallas_kernels.py:938"),
}
AXES, DIAGONALS = sgm_ops.DIRECTIONS_8[:4], sgm_ops.DIRECTIONS_8[4:]
SGM_KERNELS = {  # name -> (kernel, plain version, its four directions)
    "sgm_scan": (ck.sgm_scan, sgm_ops.sgm_scan_plain, AXES),
    "sgm_diag": (ck.sgm_diag_scan, sgm_ops.sgm_diag_scan_plain, DIAGONALS),
}
# fullres_occfill's bench-suite configurations: frame -> (make_synthetic_pair
# arguments, the preset's overrides)
OCCFILL = {
    "A": (dict(h=1000, w=1400, max_disp=191, seed=0), {}),
    "B": (dict(h=1280, w=1500, max_disp=255, seed=0),
          dict(vol_dtype="bfloat16", compute_both_volumes=False)),
}
# a fullres_occfill frame's launches, kernel B's aside (8 with two volumes, 4 with one)
OCCFILL_LAUNCHES = {"arms_grow": 2, "sgm_scan": 4, "wta": 2, "arm_reduce": 0, "region_vote": 2,
                    "pi_scan": 2, "sgm_diag": 0, "sgm_scan_ext": 0, "copy_bw": 0}
# fullres_occfill's third bench-suite configuration (scripts/bench_suite.py:59-63),
# frame C: one bfloat16 volume, the cooperative WTA, cost and CBCA streamed
# over 32-disparity blocks; uncut
FRAME_C = (dict(h=1988, w=2880, max_disp=255, seed=0),
           dict(vol_dtype="bfloat16", compute_both_volumes=False, d_stream_block=32))
# its launches a frame: kernel B 4 a block, 8 blocks
FRAME_C_LAUNCHES = dict(OCCFILL_LAUNCHES, arm_taps=32)
FRAME_C_PEAK_SHARE = 0.5  # of the dense frame's peak device memory, at most
# kernels line row at frame C's shapes -> (kernel, the TPU kernel it replaces there)
FRAME_C_ROWS = {
    "arms_grow_frame_c": ("arms_grow", "mystereomatching_tpu/ops/pallas_kernels.py:1069"),
    "arm_taps_bf16_frame_c": ("arm_taps", "mystereomatching_tpu/ops/pallas_kernels.py:298"),
    "sgm_scan_bf16_frame_c": ("sgm_scan", "mystereomatching_tpu/ops/pallas_kernels.py:762"),
    "wta_bf16_frame_c": ("wta", "mystereomatching_tpu/ops/pallas_kernels.py:718"),
    "arm_reduce_frame_c": ("arm_reduce", "mystereomatching_tpu/ops/pallas_kernels.py:67"),
    "region_vote_frame_c": ("region_vote", "mystereomatching_tpu/ops/pallas_kernels.py:67"),
    "pi_scan_frame_c": ("pi_scan", "mystereomatching_tpu/ops/pallas_kernels.py:631"),
}
COPY_BW = ("mystereomatching_tpu_torch/csrc/copy_bw.cu", "scripts/check_bw.py:28")
BF16_ROWS = {f"{name}_bf16": name for name in ("arm_taps", "sgm_scan", "wta", "sgm_diag")}
# kernel C's table kernel (sgm_scan_ext), at the shapes the banded frames
# launch it: kernels line row -> the TPU kernel's lines it replaces (788:
# the carried-in row, init_ref; 803: the in-image mask, mask_ref)
_INIT, _MASK = (f"mystereomatching_tpu/ops/pallas_kernels.py:{n}" for n in (788, 803))
EXT_ROWS = {f"sgm_scan_ext{row}{dtype}": tpu
            for row, tpu in (("_step", _INIT), ("", _INIT), ("_mask", _MASK),
                             ("_frame_a_step", _INIT), ("_frame_a", _INIT))
            for dtype in ("", "_bf16")}
# the NL presets at Teddy size (scripts/bench_suite.py:42: nl_tree_filter
# at 375x450, D=60), uncut; the qx flows on the golden scenes of
# tests/test_nl_golden.py (teddy_scale's are its slow tests): scene -> (make_synthetic_pair or
# make_adversarial_pair arguments, adversarial, {preset: (golden mode,
# px budget of the JAX golden test)})
NL_GOLDEN = {
    "small_scale": (dict(h=144, w=192, max_disp=23, seed=3), False,
                    {"nl_post": ("adgrad", 10), "nl_census_post": ("census", 0)}),
    "adv_small": (dict(h=144, w=192, max_disp=23, seed=3), True,
                  {"nl_post": ("adgrad", 6), "nl_census_post": ("census", 0)}),
    "teddy_scale": (TEDDY, False, {"nl_post": ("adgrad", 142), "nl_census_post": ("census", 0)}),
}
NL_REPS = 3
NL_PROFILE_FRAMES = 2
NL_BUILD_REPS = 5   # device and host tree builds timed, in turns
NL_BATCH = 8        # match_pair_nl_batch's frames: Teddy-sized pairs of seeds 0-7
NL_FLIP_SHARE = 0.02  # the bfloat16 filter's bound on flipped pixels (tests/test_mst.py:233)
# kernels line rows at the nl_tree_filter frame's shapes -> the kernel
NL_ROWS = {f"{name}_nl": name
           for name in ("arms_grow", "wta", "arm_reduce", "region_vote", "pi_scan")}
PLANE_PROBES = "mystereomatching_tpu_torch/csrc/plane_probes.cu"
SGM_PROBES = "mystereomatching_tpu_torch/csrc/sgm_probes.cu"
TAPS_PROBES = "mystereomatching_tpu_torch/csrc/taps_probes.cu"
# BASELINE configs 1 and 2 at the JAX bench suite's sizes
# (scripts/bench_suite.py:39-40), uncut, and census_wta (config.fast_config)
# at config 1's: preset -> make_synthetic_pair arguments
CENSUS = {
    "ad_census_wta": dict(h=288, w=384, max_disp=15, seed=0),
    "census_wta": dict(h=288, w=384, max_disp=15, seed=0),
    "census_cbca_lrc": dict(h=375, w=450, max_disp=63, seed=0),
}
# the census presets whose card maps must equal the CPU port's (integer
# costs); ad_census_wta's exp fusion divides by constants, so its count of
# differing pixels is printed
CENSUS_EXACT = ("census_wta", "census_cbca_lrc")
CENSUS_REPS = 10
CENSUS_PROFILE_FRAMES = 3
# kernels line rows at census_cbca_lrc's shapes -> the kernel
CENSUS_ROWS = {f"{name}_census": name
               for name in ("arms_grow", "arm_taps", "wta", "region_vote")}
# the presets of the box and guided filters, vmTop, double-window CBCA,
# AWS, FIF, SO and GFNL at Teddy size (375x450, D=60) beside the default
# preset, and each one's launches a frame: the default's, with
# cbca_double's second arm build and CBCA pass doubling A and B, vmTop in
# place of D, the filters, AWS and GFNL without B or C (and AWS's cost
# without arms: A once, for region vote), FIF without B, and SO in place of
# C and D
PRESET_REPS = 3
DEFAULT_FRAME = {"arms_grow": 2, "arm_taps": 8, "sgm_scan": 4, "wta": 2, "region_vote": 2,
                 "pi_scan": 2}
PRESET_FRAMES = {
    "census_grad_cbca_sgm": DEFAULT_FRAME,
    "census_cbca_vmtop": {k: n for k, n in DEFAULT_FRAME.items() if k != "wta"},
    "cbca_double": dict(DEFAULT_FRAME, arms_grow=4, arm_taps=16),
    "ad_grad_gf": {"arms_grow": 2, "wta": 2, "region_vote": 2, "pi_scan": 2},
    "zncc_bf_wta": {"wta": 1},
    "aws_wta": {"arms_grow": 1, "wta": 2, "region_vote": 2, "pi_scan": 2},
    "census_fif_sgm": {"arms_grow": 2, "sgm_scan": 4, "wta": 2, "region_vote": 2, "pi_scan": 2},
    "bt_so": {"arms_grow": 2, "arm_taps": 8, "region_vote": 2, "pi_scan": 2},
    "gfnl_wta": {"arms_grow": 2, "wta": 2, "region_vote": 2, "pi_scan": 2},
}
# the presets also held against the CPU port: True where the card must give
# its maps to the pixel (no float32 exp on the card that the CPU takes
# otherwise; NL's weight table is built on the CPU), False where the
# differing pixels are printed only (census_fif_sgm's censusGrad and the
# filters' costs take torch's float32 exp, which rounds otherwise on the card)
PRESETS_ON_CPU = {"ad_grad_gf": False, "zncc_bf_wta": False, "aws_wta": False,
                  "census_fif_sgm": False, "bt_so": True, "gfnl_wta": True}
# presets held against the CPU port on the frame's top-left crop (H, W), the
# card running the crop too: aws_wta's whole frame takes minutes on the host
# (float64 passes over [60, 375, 450] at each of 1,225 offsets a view)
CPU_CROPS = {"aws_wta": (96, 128)}

ROW_BANDS_CHUNKS = 8
ROW_BANDS_SGM8 = 3       # ranks: 250-row bands of the 750-row frame
ROW_BANDS_OCCFILL = 4    # ranks: 250-row bands of frame A's 1000 rows
ROW_BANDS_DISP = (2, 2)  # frame A over 2 bands of 500 rows x 2 blocks of 96 disparities
ROW_BANDS_FRAMES = 3     # a warm-up, a timed frame, then a profiled one
# sgm8_full's banded float map against the dense one (another association
# of the direction sum): at most this many pixels beyond the first bound,
# none beyond the second (5 px, 5.49e-4 at most, on an H100)
FLOAT_PX, FLOAT_TOL, FLOAT_MAX = 16, 1e-4, 1e-2
OCCFILL_REPS = 3
FRAME_REPS = 10
PROFILE_FRAMES = 5
SGM8_REPS = 5
SGM8_PROFILE_FRAMES = 3
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and float32
# operations/s outside the tensor cores, against which integer and compare
# operations are counted too.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean ms of fn() between two CUDA events, after a warm-up. For a short
    kernel this is the host's issue rate, not the card's."""
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


def event_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Mean ms of fn() between two CUDA events recorded just before and just
    after each call, with the L2 flushed before each start event, after a
    warm-up: the device span of the call, gaps between its launches
    included."""
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


def device_ms(fn, kernel=None, reps: int = 20, launches: int = 1, tries: int = 3):
    """(mean device ms of fn(), where it was read). From torch.profiler's
    device events, after a warm-up: the ``launches`` launches of
    ``{kernel}_kernel`` a call only, or every device event when kernel is
    None. Before each rep a 256 MiB fill evicts the 50 MB L2, so inputs come
    from HBM as in a frame; the fill's own events are not counted. The
    profiler can drop events: a kernel's mean is taken over the launches it
    recorded, and a profile that recorded under 90% of them (or of the
    fills, when kernel is None) is taken again, at most ``tries`` times in
    all. After that the time is read from CUDA events around each call
    (:func:`event_ms`), and the second value says so."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    what = kernel or "the call"
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.fill_(0)
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        fills = sum("FillFunctor" in e.name for e in device)
        us = [e.time_range.elapsed_us() for e in device if "FillFunctor" not in e.name
              and (kernel is None or f"{kernel}_kernel" in e.name)]
        if kernel is None and us and fills >= 0.9 * reps:
            return sum(us) / 1e3 / reps, "profiler"
        if kernel is not None and len(us) >= 0.9 * reps * launches:
            return sum(us) / 1e3 / (len(us) / launches), "profiler"
        want = f"{reps * launches} {kernel} launches" if kernel else f"{reps} fills"
        print(f"  profiler recorded {len(us) if kernel else fills} of {want}; profiling again")
    print(f"  profiler recorded under 90% of the events of {what} {tries} times; its device "
          "time is read from CUDA events around each call")
    return event_ms(fn, flush, reps), "cuda events"


def bound(nbytes: float, nops: float):
    """(least ms, what bounds it): bytes over HBM rate vs operations over
    the vector peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / VECTOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def taps(arm_neg: torch.Tensor, arm_pos: torch.Tensor, axis: int, max_arm: int) -> int:
    """Taps an arm-bounded pass reads: sum of the arms capped at max_arm and
    at the image border, plus the centre, over every element."""
    n = arm_neg.shape[axis]
    shape = [1] * arm_neg.ndim
    shape[axis] = n
    pos = torch.arange(n, device=arm_neg.device).reshape(shape)
    lo = torch.minimum(arm_neg.to(torch.int64).clamp(max=max_arm), pos)
    hi = torch.minimum(arm_pos.to(torch.int64).clamp(max=max_arm), n - 1 - pos)
    return int((lo + hi + 1).sum())


def pi_work(disp: torch.Tensor, offsets: torch.Tensor):
    """(taps walked, rays that hit) of one proper-interpolation pass: each
    invalid pixel walks each ray up to its first valid tap."""
    h, w = disp.shape
    m = int(offsets.abs().max())
    dpad = torch.nn.functional.pad(disp, (m, m, m, m), value=-1)
    inval = disp < 0
    walked = hits = 0
    for ray in offsets.tolist():
        found = torch.zeros_like(inval)
        for dv, du in ray:
            walked += int((inval & ~found).sum())
            found |= dpad[m + dv:m + dv + h, m + du:m + du + w] >= 0
        hits += int((inval & found).sum())
    return walked, hits


def load_ref_disp(path: str, dtype=np.int16) -> np.ndarray:
    """A golden map: int16 (tests/golden/*_{wta,final}.bin) or uint8 (the
    NL flow's, tests/golden/*_nl_*.bin), as int32."""
    with open(path, "rb") as f:
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        size = h * w * np.dtype(dtype).itemsize
        return np.frombuffer(f.read(size), dtype).reshape(h, w).astype(np.int32)


def plain_path():
    """Route every kernel-backed op to its plain torch version, on any device."""
    return mock.patch.object(ck, "on_cuda", lambda t: False)


def phase_environment(card_line: str) -> None:
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {card_line}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    print(f"devices: {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")


def phase_build() -> str:
    """Builds the kernels and prints nvcc's report; returns it."""
    t0 = time.perf_counter()
    log = ck.build()
    ck._load()
    print(f"build: {time.perf_counter() - t0:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  nvcc: {line.strip()}")
    return log


def pair_scales(left, right, cfg, dirs) -> dict:
    """Direction -> the left and right images' [2, H, W] SGM penalty scales."""
    return {d: torch.stack([sgm_ops.penalty_scale(img, *d, cfg.sgm_cor_dif_thres,
                                                  cfg.sgm_redu_coeff)
                            for img in (left, right)]).contiguous()
            for d in dirs}


def scan_args(d) -> tuple:
    """The direction arguments of direction d's scan: (axis, reverse) for
    kernel C, (rv, ru) for kernel E."""
    if d[0] and d[1]:
        return d
    return (2, d[0] > 0) if d[1] == 0 else (3, d[1] > 0)


def sgm_case(vols, pscales, cfg, name: str):
    """Kernel C (``sgm_scan``) over the four axis directions of the
    [G, D, H, W] volumes, or kernel E (``sgm_diag``) over the four
    diagonals, as (kernel, plain, bytes, operations): each direction reads
    the volumes (float32 or bfloat16) and the float32 scales once and writes
    its path costs once; 7 operations an element."""
    kernel, plain, dirs = SGM_KERNELS[name]

    def run(fn):
        return torch.stack([fn(vols, pscales[d], cfg.sgm_p1_eff, cfg.sgm_p2_eff, *scan_args(d))
                            for d in dirs])

    return (lambda: run(kernel), lambda: run(plain),
            len(dirs) * (vols.numel() * 2 * vols.element_size() + vols[:, 0].numel() * 4),
            len(dirs) * 7 * vols.numel())


def teddy_inputs(dev) -> dict:
    """The inputs the main path gives each kernel for the Teddy-sized pair,
    computed on the plain path."""
    cfg = default_config(max_disp=TEDDY["max_disp"])
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
        pscales = pair_scales(left, right, cfg, sgm_ops.DIRECTIONS_8)
        sgm_vols = sgm_ops.sgm_multi(agg, [left, right], 4, cfg.sgm_p1_eff, cfg.sgm_p2_eff,
                                     cfg.sgm_cor_dif_thres, cfg.sgm_redu_coeff)
        dl, dr = (wta_ops.wta_plain(v) for v in sgm_vols)
        lrc = refine_ops.lr_consistency(dl, dr, cfg.lr_max_diff)
        rv = lrc
        for _ in range(cfg.region_vote_iters):
            rv = refine_ops.region_vote(rv, arms[0], cfg.num_disp, cfg.rv_s_thres,
                                        cfg.rv_h_ratio, cfg.rv_int_ratio_quirk, cfg.arm_l_out)
    return dict(cfg=cfg, left=left, arms=arms, vol=raw[0], arms_int=arms_int[0], vols=vols,
                pscales=pscales, sgm_vol=sgm_vols[0], lrc=lrc, rv=rv)


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs plain "
                             f"{want.dtype}{tuple(want.shape)}")
    if torch.equal(got, want):
        return 0.0
    # in chunks: frame C's outputs are 5.9e9 elements, 47 GB in float64
    err = max(float((g.to(torch.float64) - w.to(torch.float64)).abs().max())
              for g, w in zip(got.flatten().split(1 << 26), want.flatten().split(1 << 26)))
    raise AssertionError(f"{name}: differs from its plain version, max |err| {err}")


def frame_cbca_inputs(left, right, cfg):
    """CBCA's inputs for the left view of a pair of [H, W, 3] float32
    images: the raw cost volume [D, H, W] and the intersected arms
    [4, D, H, W] int8, as the main path computes them."""
    arms = [arms_ops.build_arms(img, cfg) for img in (left, right)]
    vol = cost_ops.compute_cost_volume(left, right, to_gray(left), to_gray(right), cfg, 0,
                                       arms=arms[0])
    return vol, arms_ops.intersect_arms(arms[0], arms[1], cfg.num_disp, 0)


def cbca_launches(vol, arms_int, m, iterations=2):
    """Kernel B's launches in a frame's CBCA (iteration 0: sum along W, area
    along H; iteration 1: sum along H, area along W), each with the input
    the frame gives it (the volume chained through the kernel), as
    (kind, (vol, arm_neg, arm_pos, axis, an1, ap1)); an1/ap1 are None in a
    sum pass."""
    arm_l, arm_r, arm_u, arm_d = arms_int.unbind(0)
    horizontal, vertical = (2, arm_l, arm_r), (1, arm_u, arm_d)
    launches = []
    for (ax1, an1, ap1), (ax2, an2, ap2) in ((horizontal, vertical),
                                             (vertical, horizontal))[:iterations]:
        launches.append((f"sum along {'HW'[ax1 - 1]}", (vol, an1, ap1, ax1, None, None)))
        vol = ck.arm_taps(vol, an1, ap1, ax1, m)
        launches.append((f"area along {'HW'[ax2 - 1]}", (vol, an2, ap2, ax2, an1, ap1)))
        vol = ck.arm_taps(vol, an2, ap2, ax2, m, an1, ap1)
    return launches


def cbca_kinds(vol, arms_int, m, iterations=2):
    """:func:`cbca_launches` as (kind, (kernel, plain, bytes, operations)):
    a sum pass reads vol and two int8 arms and writes out (10 bytes an
    element in float32, 6 in bfloat16), an area pass reads two more arms
    (12 or 8); one operation a tap in a sum pass, 6 in an area pass."""
    n, es = vol.numel(), vol.element_size()
    kinds = []
    for kind, (v, an, ap, ax, an1, ap1) in cbca_launches(vol, arms_int, m, iterations):
        if an1 is None:
            case = (lambda v=v, a=an, b=ap, ax=ax: ck.arm_taps(v, a, b, ax, m),
                    lambda v=v, a=an, b=ap, ax=ax: arms_ops.arm_bounded_sum_plain(v, a, b, ax, m),
                    n * (2 * es + 2), taps(an, ap, ax, m))
        else:
            case = (lambda v=v, a=an, b=ap, ax=ax, a1=an1, b1=ap1:
                    ck.arm_taps(v, a, b, ax, m, a1, b1),
                    lambda v=v, a=an, b=ap, ax=ax, a1=an1, b1=ap1:
                    arms_ops.arm_bounded_sum_area_plain(v, a1, b1, a, b, ax, m),
                    n * (2 * es + 4), 6 * taps(an, ap, ax, m))
        kinds.append((kind, case))
    return kinds


def combined(cases):
    """Cases run one after the other as one (kernel, plain, bytes, operations)."""
    return (lambda: tuple(c[0]() for c in cases), lambda: tuple(c[1]() for c in cases),
            sum(c[2] for c in cases), sum(c[3] for c in cases))


def cbca_iteration_case(vol, arms_int, m):
    """One CBCA iteration (kernel B sum pass along W + area pass along H)."""
    return combined([case for _, case in cbca_kinds(vol, arms_int, m, 1)])


def region_vote_case(lrc, arms0, m):
    """One region-vote iteration's four integer passes (min of d and -d
    along W then H, valid count along W then H) as (kernel, plain, bytes,
    operations)."""
    left, right, up, down = arms0.unbind(0)
    big = torch.iinfo(torch.int32).max
    valid = lrc >= 0
    mm = torch.stack([torch.where(valid, lrc, big), torch.where(valid, -lrc, big)])
    count = valid.to(torch.int32)[None].contiguous()

    def run(fn):
        return (fn(fn(mm, left, right, 2, m, "min"), up, down, 1, m, "min"),
                fn(fn(count, left, right, 2, m, "sum"), up, down, 1, m, "sum"))

    hw = lrc.numel()
    nbytes = 2 * (2 * hw * 4 + 2 * hw * 4 + 2 * hw * 4) + 2 * (hw * 4 + 2 * hw * 4 + hw * 4)
    nops = 3 * (taps(left, right, 1, m) + taps(up, down, 0, m))
    return (lambda: run(ck.arm_reduce), lambda: run(arms_ops.arm_bounded_reduce_plain),
            nbytes, nops)


def region_vote_kernel_case(disp, arms0, m, s_thres):
    """One region-vote pass in one launch (``csrc/region_vote.cu``) against
    ``region_vote_plain``, as (kernel, plain, bytes, operations): the map, its
    four arm planes and the new map, each once (24 bytes a pixel); three
    operations a tap (min, max, count) of both passes over every pixel, no
    fewer than the kernel does (it skips the rows no invalid pixel's support
    reaches) and, at real arm lengths, far under the bytes' time."""
    arms0 = arms0.contiguous()
    left, right, up, down = arms0.unbind(0)
    nops = 3 * (taps(left, right, 1, m) + taps(up, down, 0, m))
    return (lambda: ck.region_vote(disp, arms0, m, s_thres),
            lambda: refine_ops.region_vote_plain(disp, arms0, s_thres, m),
            disp.numel() * 24, nops)


def pi_case(disp, image, depth, disp_occ):
    """One proper-interpolation iteration as (kernel, plain, bytes,
    operations): per tap walked a bounds test and a load test (5), per ray
    that hits the colour difference and the reduction (12)."""
    offs = torch.from_numpy(refine_ops.pi_offsets(depth)).to(disp.device)
    image = image.contiguous()
    walked, hits = pi_work(disp, offs)
    nbytes = disp.numel() * (4 + 12 + 4) + offs.numel() * 4
    return (lambda: ck.pi_scan(disp, image, offs, disp_occ),
            lambda: refine_ops.proper_interpolation_plain(disp, image, offs, disp_occ),
            nbytes, 5 * walked + 12 * hits)


def run_case(name, what, case, card_line, library=None, check=None, kernel_name=None):
    """One kernels line row: the kernel against its plain version (exactly,
    or by ``check(got, want)``, which returns the error it measured),
    its device time, host time, plain time, bound and library time.
    ``kernel_name``: the kernel's launch counter and ``*_kernel`` name, if
    not ``name``."""
    kernel, plain, nbytes, nops = case
    kernel_name = kernel_name or name
    before = ck.launches[kernel_name]
    got, want = kernel(), plain()
    launches = ck.launches[kernel_name] - before  # a call's launches of the kernel
    if isinstance(got, tuple):
        got, want = torch.cat(got), torch.cat(want)
    err = check(got, want) if check is not None else compare(name, got, want)
    ms, ms_from = device_ms(kernel, kernel_name, launches=launches)
    host_ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, reps=3)
    bound_ms, bound_by = bound(nbytes, nops)
    library_ms = device_ms(library)[0] if library is not None else None
    lib = f", library {library_ms:.4f} ms device" if library_ms is not None else ""
    print(f"kernel {name}: equal to plain (max |err| {err}); {what}: {ms:.4f} ms device "
          f"({host_ms:.4f} ms between events) vs plain {plain_ms:.4f} ms{lib}; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.3f} MB, {nops / 1e6:.3f} M ops), "
          f"{bound_ms / ms:.3f} of it [{card_line}]")
    return dict(max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, ms_from=ms_from, case=what)


def fullres_image(rng):
    """A 1988x2880 colour image of flat 24-px blocks plus noise, float32."""
    h, w = FULLRES
    base = np.kron(rng.integers(0, 256, (-(-h // 24), -(-w // 24), 3)),
                   np.ones((24, 24, 1)))[:h, :w]
    return np.clip(np.round(base + rng.normal(0, 2.0, base.shape)), 0, 255).astype(np.float32)


def fullres_inputs(dev) -> dict:
    """Inputs at full resolution (1988x2880): a blocky image ``img``, the
    per-disparity intersected arms ``arms_int`` [4, 32, H, W] of it and of
    itself shifted by 8 px, a random volume ``vol`` [32, H, W], and a blocky
    map ``disp`` with 10% -1 and 10% -32 holes."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy(fullres_image(rng)).to(dev)
    arms_full = [arms_ops.cross_arms(x) for x in (img, torch.roll(img, -8, dims=1))]
    arms_int = arms_ops.intersect_arms(arms_full[0], arms_full[1], 32, 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    vol = torch.rand((32,) + FULLRES, generator=gen, device=dev)
    h, w = FULLRES
    disp = torch.from_numpy(np.kron(rng.integers(0, 256, (-(-h // 24), -(-w // 24))),
                                    np.ones((24, 24)))[:h, :w].astype(np.int32)).to(dev)
    r = torch.rand(FULLRES, generator=gen, device=dev)
    disp = torch.where(r < 0.1, -1, torch.where(r < 0.2, -32, disp)).to(torch.int32)
    return dict(img=img, arms_int=arms_int, vol=vol, disp=disp)


def arms_grow_case(img, arms, cfg):
    """Kernel A on an [H, W, 3] float32 image whose arms are ``arms``, under
    ``cfg``'s arm schedule, as (kernel, plain, bytes, operations): the image
    read and the arms written once; 18 operations a step walked (each arm's
    steps plus its failing one, within the image and the schedule)."""
    sched, neigh = arms_ops.arm_schedule(cfg)
    min_arm = cfg.cbca_min_arm
    room = [torch.minimum(arms_ops.border_floor(*img.shape[:2], dv, du, 1 << 20, img.device),
                          torch.tensor(len(sched), device=img.device))
            for dv, du in arms_ops.DIRECTIONS]
    grow_steps = int(sum(torch.minimum(arms[i] + 1, room[i]).sum() for i in range(4)))
    return (lambda: ck.arms_grow(img, sched, neigh, min_arm),
            lambda: arms_ops.grow_arms_plain(img, sched, neigh, min_arm),
            img.shape[0] * img.shape[1] * (12 + 16), 18 * grow_steps)


def phase_kernels(dev, card_line: str) -> dict:
    t = teddy_inputs(dev)
    cfg, left, m = t["cfg"], t["left"], t["cfg"].arm_l_out
    vols, sgm_vol = t["vols"], t["sgm_vol"]
    hw = left.shape[0] * left.shape[1]
    arms = t["arms"][0]
    cases = {
        "arms_grow": ("arms of one 375x450 image", arms_grow_case(left, arms, cfg), None),
        "arm_taps": ("one CBCA iteration (sum pass along W + area pass along H), D=60",
                     cbca_iteration_case(t["vol"], t["arms_int"], m), None),
        "sgm_scan": ("4 directions over the left+right pair [2,60,375,450]",
                     sgm_case(vols, t["pscales"], cfg, "sgm_scan"), None),
        "wta": ("one [60,375,450] volume",
                (lambda: ck.wta(sgm_vol), lambda: wta_ops.wta_plain(sgm_vol),
                 sgm_vol.numel() * 4 + hw * 4, sgm_vol.numel()),
                lambda: torch.argmin(sgm_vol, 0)),
        "arm_reduce": ("one region-vote iteration (2 min + 2 sum passes) on the LRC map, on "
                       "no path", region_vote_case(t["lrc"], arms, m), None),
        "region_vote": ("one region-vote pass in one launch on the LRC map",
                        region_vote_kernel_case(t["lrc"], arms, m, cfg.rv_s_thres), None),
        "pi_scan": ("one proper-interpolation iteration on the region-voted map, depth "
                    f"{cfg.pi_search_depth}",
                    pi_case(t["rv"], left, cfg.pi_search_depth, cfg.disp_occ), None),
        "sgm_diag": ("4 diagonals over the left+right pair [2,60,375,450]",
                     sgm_case(vols, t["pscales"], cfg, "sgm_diag"), None),
    }
    rows = {name: run_case(name, what, case, card_line, library)
            for name, (what, case, library) in cases.items()}
    print(f"teddy maps: {int((t['lrc'] < 0).sum())} px invalid after LRC, "
          f"{int((t['rv'] < 0).sum())} after region vote, of {hw}")
    del t, cases

    # full resolution: kernel B on a D block, PI on a map with ~20% holes
    f = fullres_inputs(dev)
    run_case("arm_taps", "full resolution, one CBCA iteration on [32,1988,2880]",
             cbca_iteration_case(f["vol"], f["arms_int"], m), card_line)
    print(f"full-resolution map: {float((f['disp'] < 0).float().mean()):.4f} of pixels invalid")
    run_case("pi_scan", "full resolution, one iteration on 1988x2880, depth 20",
             pi_case(f["disp"], f["img"], 20, -32), card_line)
    return rows


def check_launches(label: str, counts: dict, cfg) -> None:
    """Every kernel of ``cfg``'s path must have launched."""
    print(f"launches on the main path, {label}: {json.dumps(counts)}")
    missing = [k for k in kernels_launched(cfg) if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the main path: {missing}")


def check_maps(name: str, out: dict, cfg, shape, dev) -> None:
    """A frame's maps: the raw ones int32 in [0, D) (the left one also
    DISP_INV where the uniqueness check is on), the disparity finite
    float32, all of ``shape`` on ``dev``."""
    for key in ("disp_left_raw", "disp_right_raw"):
        d = out[key]
        if d.shape != shape or d.dtype != torch.int32 or d.device != dev:
            raise AssertionError(f"{name} {key}: {d.dtype}{tuple(d.shape)} on {d.device}")
        ok = (d >= 0) & (d < cfg.num_disp)
        if key == "disp_left_raw" and cfg.uniq_check:
            ok |= d == cfg.disp_inv
        if not bool(ok.all()):
            raise AssertionError(f"{name} {key}: values outside [0, {cfg.num_disp})")
    disp = out["disparity"]
    if disp.shape != shape or disp.dtype != torch.float32 or \
            not bool(torch.isfinite(disp).all()):
        raise AssertionError(f"{name}: disparity {disp.dtype}{tuple(disp.shape)}, "
                             "or not finite")


def run_scenes(dev, do_refine: bool):
    """The golden scenes through StereoPipeline, with the launch counts set
    to 0 just before and read just after."""
    pairs = {name: (make_adversarial_pair if adversarial else make_synthetic_pair)(
        name=name, **params) for name, (params, _, adversarial) in SCENES.items()}
    cfgs = {name: default_config(max_disp=params["max_disp"], do_refine=do_refine)
            for name, (params, _, _) in SCENES.items()}
    pipes = {name: StereoPipeline(cfg, device=dev) for name, cfg in cfgs.items()}
    torch.cuda.synchronize()
    ck.reset_launches()
    outs = {name: pipes[name](pair.left, pair.right) for name, pair in pairs.items()}
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    label = "default (refine on)" if do_refine else "do_refine=False"
    check_launches(label, counts, cfgs["small_scale"])
    for name, want in (("arm_taps", 8), ("pi_scan", 2 if do_refine else 0)):
        if counts[name] != want * len(pairs):
            raise AssertionError(f"{label}: {name} launched {counts[name]} times in "
                                 f"{len(pairs)} frames, not {want} a frame")
    for name, pair in pairs.items():
        params, budget, _ = SCENES[name]
        out = outs[name]
        check_maps(name, out, cfgs[name], (params["h"], params["w"]), dev)
        disp = out["disparity"]
        n_wta = int((out["disp_left_raw"].cpu().numpy()
                     != load_ref_disp(os.path.join(GOLDEN, f"{name}_wta.bin"))).sum())
        final = torch.round(disp).to(torch.int32).cpu().numpy()
        if do_refine:
            n_final = int((final != load_ref_disp(
                os.path.join(GOLDEN, f"{name}_final.bin"))).sum())
        else:
            n_final = int((final != out["disp_left_raw"].cpu().numpy()).sum())
        bad1 = bad_pixel_rate(disp, torch.from_numpy(pair.gt),
                              torch.from_numpy(pair.masks["nonocc"]))
        what = "refined map differs from the reference binary's" if do_refine else \
            "disparity differs from the WTA map"
        print(f"slice {label} {name}: WTA differs from the reference binary at {n_wta} px "
              f"(budget {budget}); {what} at {n_final} px (budget 0); "
              f"bad-1.0 nonocc {bad1:.6f}")
        if n_wta > budget or n_final:
            raise AssertionError(f"{name}: WTA differs at {n_wta} px (budget {budget}), "
                                 f"final at {n_final} px (budget 0)")
    return counts


def phase_slice(dev) -> dict:
    run_scenes(dev, do_refine=False)
    return run_scenes(dev, do_refine=True)


def frame_ms(pipe, left, right, reps: int = FRAME_REPS, warm_up: bool = True):
    """Quartiles of host-clock ms per frame, each synchronised, after a
    warm-up frame unless ``warm_up`` is false."""
    if warm_up:
        pipe(left, right)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pipe(left, right)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return np.percentile(times, [25, 50, 75])


def refine_ms(cfg, out, left):
    """Quartiles of host-clock ms of the refine chain alone on one frame's
    WTA maps, each synchronised."""
    left = left.to(torch.float32)
    arms0 = arms_ops.build_arms(left, cfg)
    times = []
    for _ in range(FRAME_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refine(out["disp_left_raw"], out["disp_right_raw"], None, left, arms0, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return np.percentile(times[1:], [25, 50, 75])


def phase_timing(dev, card_line: str) -> None:
    pair = make_synthetic_pair(**TEDDY)
    left = torch.from_numpy(pair.left).to(dev)
    right = torch.from_numpy(pair.right).to(dev)
    mp_disp = TEDDY["h"] * TEDDY["w"] * (TEDDY["max_disp"] + 1) / 1e6
    cfg = default_config(max_disp=TEDDY["max_disp"])
    out = StereoPipeline(cfg, device=dev)(left, right)
    for path, ctx in (("plain", plain_path), ("kernel", contextlib.nullcontext),
                      ("kernel", contextlib.nullcontext), ("plain", plain_path)):
        with ctx():
            q1, med, q3 = refine_ms(cfg, out, left)
        print(f"timing refine chain alone (LRC, region vote x2, proper interpolation x2, "
              f"median), {path} path, Teddy: median {med:.3f} ms (quartiles {q1:.3f}-{q3:.3f}, "
              f"n={FRAME_REPS}) [{card_line}]")
    for do_refine in (True, False):
        label = "default (refine on)" if do_refine else "do_refine=False"
        pipe = StereoPipeline(default_config(max_disp=TEDDY["max_disp"], do_refine=do_refine),
                              device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernel_out = pipe(left, right)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        with plain_path():
            plain_out = pipe(left, right)
        for key in ("disp_left_raw", "disp_right_raw", "disparity"):
            if not torch.equal(kernel_out[key], plain_out[key]):
                raise AssertionError(f"{label}: kernel and plain paths disagree on {key}")
        print(f"timing {label}: peak device memory of a kernel-path frame "
              f"{peak / 2**20:.1f} MiB [{card_line}]")
        for path, ctx in (("plain", plain_path), ("kernel", contextlib.nullcontext),
                          ("kernel", contextlib.nullcontext), ("plain", plain_path)):
            with ctx():
                q1, med, q3 = frame_ms(pipe, left, right)
            print(f"timing {label}, {path} path, Teddy 375x450 D=60, left+right: median "
                  f"{med:.3f} ms/frame (quartiles {q1:.3f}-{q3:.3f}, n={FRAME_REPS}), "
                  f"{mp_disp / med * 1e3:.3f} MP*disp/s [{card_line}]")


def profile_frames(pipe, left, right, label: str, card_line: str, frames: int,
                   warm_up: int) -> float:
    """torch.profiler over ``frames`` frames of ``pipe`` after ``warm_up``
    frames: wall and device time, idle share, launches, the largest device
    kernels and each hand kernel's device time a launch. Returns the kernel
    launches a frame."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm_up):
        pipe(left, right)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            pipe(left, right)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    events = list(prof.events())
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel"))
    cpu_ms = sum(e.self_cpu_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU) / 1e3 / frames
    print(f"profile, {label}, {frames} frames after {warm_up} warm-up: "
          f"{wall_ms:.3f} ms/frame wall under the profiler, {launches / frames:.1f} "
          f"kernel launches/frame, {cpu_ms:.3f} ms/frame of host op time [{card_line}]")
    if not device:
        print("profile: no device events recorded; device time not measured")
        return launches / frames
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        per_kernel[e.name][0] += e.time_range.elapsed_us()
        per_kernel[e.name][1] += 1
    busy_ms = sum(v[0] for v in per_kernel.values()) / 1e3 / frames
    print(f"profile: {busy_ms:.3f} ms/frame of device kernel time, device idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {len(device) / frames:.1f} device "
          f"kernels/frame")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, n) in top:
        print(f"profile:   {us / 1e3 / frames:8.3f} ms/frame  {n / frames:7.1f}"
              f"/frame  {name[:110]}")
    for kernel in KERNELS:
        hits = [v for name, v in per_kernel.items() if f"{kernel}_kernel" in name]
        us, n = sum(v[0] for v in hits), sum(v[1] for v in hits)
        if n:
            print(f"profile: kernel {kernel}: {us / 1e3 / frames:.4f} ms/frame of device "
                  f"time in {n / frames:.1f} launches/frame ({us / n:.2f} us a launch)")
    return launches / frames


def four_pass_region_vote():
    """Region vote as it ran before it was one kernel: ``region_vote_plain``'s
    composition on the card, its four arm-bounded reductions each one
    ``arm_reduce`` launch (``arms.arm_bounded_reduce``), with the elementwise
    ops around them."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(refine_ops, "arm_bounded_reduce_plain",
                                          arms_ops.arm_bounded_reduce))
    stack.enter_context(mock.patch.object(
        ck, "region_vote",
        lambda disp, arms, max_arm, s_thres: refine_ops.region_vote_plain(disp, arms, s_thres,
                                                                          max_arm)))
    return stack


def phase_profile(dev, card_line: str) -> None:
    """torch.profiler over frames of the full default configuration, twice:
    as the port runs it, and with region vote as four ``arm_reduce`` passes
    (:func:`four_pass_region_vote`). Before each profile one frame with the
    launch counts set to 0 just before it: region vote must launch
    ``region_vote`` twice (one launch a pass) and ``arm_reduce`` never, or
    ``arm_reduce`` 8 times and ``region_vote`` never; the two frames' maps
    must be equal, and the port's frame must make fewer launches a frame."""
    pair = make_synthetic_pair(**TEDDY)
    left = torch.from_numpy(pair.left).to(dev)
    right = torch.from_numpy(pair.right).to(dev)
    pipe = StereoPipeline(default_config(max_disp=TEDDY["max_disp"]), device=dev)
    label = "default (refine on), Teddy"
    runs, outs = {}, {}
    for way, want in (("one region_vote launch a pass", (2, 0)),
                      ("region vote as four arm_reduce passes", (0, 8))):
        with four_pass_region_vote() if want[1] else contextlib.nullcontext():
            pipe(left, right)
            torch.cuda.synchronize()
            ck.reset_launches()
            outs[way] = pipe(left, right)
            torch.cuda.synchronize()
            got = (ck.launches["region_vote"], ck.launches["arm_reduce"])
            if got != want:
                raise AssertionError(f"{label}, {way}: region_vote and arm_reduce launched "
                                     f"{got} times a frame, not {want}")
            runs[way] = profile_frames(pipe, left, right, f"{label}, {way}", card_line,
                                       PROFILE_FRAMES, warm_up=3)
    (new, n_new), (old, n_old) = runs.items()
    equal_maps(label, outs[new], outs[old], old)
    print(f"profile, {label}: {n_new:.1f} kernel launches/frame with {new}, {n_old:.1f} with "
          f"{old}: {n_old - n_new:.1f} fewer; the maps equal [{card_line}]")
    if n_new >= n_old:
        raise AssertionError(f"{label}: {n_new:.1f} launches a frame with {new}, not under "
                             f"{n_old:.1f} with {old}")


def arm_taps_frame(left, right, cfg, label: str, card_line: str) -> dict:
    """Kernel B on a frame's CBCA inputs (left view): each of its four
    launch kinds against its plain version, with its bound, then the four
    together, whose row is returned."""
    vol, arms_int = frame_cbca_inputs(left, right, cfg)
    kinds = cbca_kinds(vol, arms_int, cfg.arm_l_out)
    for kind, case in kinds:
        run_case("arm_taps", f"{label}: {kind} on the frame's CBCA input {list(vol.shape)}",
                 case, card_line)
    whole = combined([case for _, case in kinds])
    return run_case("arm_taps", f"{label}: the frame's four launch kinds (sum along W, area "
                    f"along H, sum along H, area along W) on its CBCA input {list(vol.shape)}",
                    whole, card_line)


def phase_sgm8(dev, card_line: str):
    """The sgm8_full preset at 750x1000, D=128. Returns the rows of kernel
    B (on the frame's CBCA input), C and E (on its CBCA volumes) and the
    frame's launch counts."""
    pair = make_synthetic_pair(**SGM8)
    left = torch.from_numpy(pair.left).to(dev)
    right = torch.from_numpy(pair.right).to(dev)
    cfg = get_model("sgm8_full", max_disp=SGM8["max_disp"])
    shape = (SGM8["h"], SGM8["w"])
    label = f"sgm8_full {shape[0]}x{shape[1]} D={cfg.num_disp}"

    lf, rf = left.to(torch.float32), right.to(torch.float32)
    rows = {"arm_taps": arm_taps_frame(lf, rf, cfg, label, card_line)}
    vols, _ = compute_volumes(lf, rf, cfg)
    vols = torch.stack([vols[0], vols[1]]).contiguous()
    pscales = pair_scales(lf, rf, cfg, sgm_ops.DIRECTIONS_8)
    for name, what in (("sgm_scan", "4 axis directions"), ("sgm_diag", "4 diagonals")):
        rows[name] = run_case(name, f"{label}: {what} over the frame's CBCA volumes "
                              f"{list(vols.shape)}", sgm_case(vols, pscales, cfg, name),
                              card_line)
        kernel, _, dirs = SGM_KERNELS[name]
        for d in dirs:
            ms, _ = device_ms(lambda: kernel(vols, pscales[d], cfg.sgm_p1_eff, cfg.sgm_p2_eff,
                                             *scan_args(d)), name)
            print(f"kernel {name} direction (rv, ru) = {d}: {ms:.4f} ms device on "
                  f"{list(vols.shape)} [{card_line}]")
    del vols, pscales

    pipe = StereoPipeline(cfg, device=dev)
    torch.cuda.synchronize()
    ck.reset_launches()
    out = pipe(left, right)
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    check_launches(label, counts, cfg)
    for name, want in (("sgm_diag", 4), ("arm_taps", 8), ("pi_scan", 2)):
        if counts[name] != want:
            raise AssertionError(f"{label}: {name} launched {counts[name]} times, not {want}")
    check_maps(label, out, cfg, shape, dev)
    with plain_path():
        plain_out = pipe(left, right)
    for key in ("disp_left_raw", "disp_right_raw", "disparity"):
        if not torch.equal(out[key], plain_out[key]):
            raise AssertionError(f"{label}: kernel and plain paths disagree on {key}")
    del plain_out
    bad1 = bad_pixel_rate(out["disparity"], torch.from_numpy(pair.gt).to(dev),
                          torch.from_numpy(pair.masks["nonocc"]).to(dev))
    n_inv = int((out["disp_left_raw"] == cfg.disp_inv).sum())
    print(f"{label}: kernel path equal to plain path on the three maps; {n_inv} px fail the "
          f"uniqueness check; bad-1.0 nonocc {bad1:.6f}")

    torch.cuda.reset_peak_memory_stats(dev)
    pipe(left, right)
    torch.cuda.synchronize()
    print(f"timing {label}: peak device memory of a kernel-path frame "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB [{card_line}]")
    mp_disp = shape[0] * shape[1] * cfg.num_disp / 1e6
    for path, ctx, reps in (("plain", plain_path, 1), ("kernel", contextlib.nullcontext, SGM8_REPS),
                            ("kernel", contextlib.nullcontext, SGM8_REPS),
                            ("plain", plain_path, 1)):
        with ctx():
            q1, med, q3 = frame_ms(pipe, left, right, reps)
        print(f"timing {label}, {path} path, left+right: median {med:.3f} ms/frame (quartiles "
              f"{q1:.3f}-{q3:.3f}, n={reps}), {mp_disp / med * 1e3:.3f} MP*disp/s [{card_line}]")
    profile_frames(pipe, left, right, label, card_line, SGM8_PROFILE_FRAMES, warm_up=1)
    return rows, counts


def bf16_kernel_rows(left, right, cfg, label: str, card_line: str) -> dict:
    """The bfloat16 instances of kernels B, C, E and D on a bfloat16 frame's
    own inputs, each against its plain version: B's four launch kinds on the
    CBCA input, C's four axis directions and E's four diagonals on the CBCA
    volume, D on the cooperative WTA's two volumes (with torch.argmin on
    each as the library call). Returns the rows of the kernels line."""
    rows = {}
    vol, arms_int = frame_cbca_inputs(left, right, cfg)
    vol = vol.to(torch.bfloat16)
    kinds = cbca_kinds(vol, arms_int, cfg.arm_l_out)
    for kind, case in kinds:
        run_case("arm_taps", f"{label}: bf16 {kind} on the frame's CBCA input {list(vol.shape)}",
                 case, card_line)
    rows["arm_taps_bf16"] = run_case(
        "arm_taps", f"{label}: bf16, the frame's four launch kinds (sum along W, area along H, "
        f"sum along H, area along W) on its CBCA input {list(vol.shape)}",
        combined([case for _, case in kinds]), card_line)
    del kinds
    float32_instance("arm_taps", "the four launch kinds",
                     combined([c for _, c in cbca_kinds(vol.float(), arms_int, cfg.arm_l_out)]),
                     4, card_line)
    agg = agg_ops.cbca(vol, arms_int, cfg.cbca_iterations, cfg.arm_l_out)
    del vol, arms_int
    vols = agg[None].contiguous()
    pscales = {d: sgm_ops.penalty_scale(left, *d, cfg.sgm_cor_dif_thres,
                                        cfg.sgm_redu_coeff)[None].contiguous()
               for d in sgm_ops.DIRECTIONS_8}
    for name, what in (("sgm_scan", "4 axis directions"), ("sgm_diag", "4 diagonals")):
        rows[f"{name}_bf16"] = run_case(
            name, f"{label}: bf16, {what} over the frame's CBCA volume {list(vols.shape)}",
            sgm_case(vols, pscales, cfg, name), card_line)
        float32_instance(name, what, sgm_case(vols.float(), pscales, cfg, name), 4, card_line)
    sgm_vol = sgm_ops.sgm_multi([agg], [left], 4, cfg.sgm_p1_eff, cfg.sgm_p2_eff,
                                cfg.sgm_cor_dif_thres, cfg.sgm_redu_coeff)[0]
    del vols, agg
    coop = [wta_ops.cooperative_volume(sgm_vol, lor, cfg.choose_small) for lor in (0, 1)]
    del sgm_vol
    cs = cfg.choose_small
    hw = coop[0][0].numel()
    rows["wta_bf16"] = run_case(
        "wta", f"{label}: bf16, both volumes of the cooperative WTA {list(coop[0].shape)}",
        (lambda: tuple(ck.wta(v, cs) for v in coop),
         lambda: tuple(wta_ops.wta_plain(v, cs) for v in coop),
         2 * (coop[0].numel() * 2 + hw * 4), 2 * coop[0].numel()),
        card_line, lambda: tuple(torch.argmin(v, 0) for v in coop))
    coop = [v.float() for v in coop]
    float32_instance("wta", "both volumes", (lambda: tuple(ck.wta(v, cs) for v in coop),), 2,
                     card_line)
    return rows


def float32_instance(name: str, what: str, case, launches: int, card_line: str) -> None:
    """Prints the device time of kernel ``name``'s float32 instance on the
    same values widened to float32 (``case[0]``), beside its bfloat16 row:
    what the storage type alone changes at this shape."""
    ms, _ = device_ms(case[0], name, launches=launches)
    print(f"kernel {name}: float32 instance on the same values, {what}: {ms:.4f} ms device "
          f"[{card_line}]")


def occfill_frame(name: str, card_line: str, dev):
    """One fullres_occfill frame of OCCFILL: the bfloat16 kernels on its
    inputs (frame B), then the frame through StereoPipeline with the
    launch counts set to 0 just before it. Returns (rows, launches,
    bfloat16 launches)."""
    params, overrides = OCCFILL[name]
    pair = make_synthetic_pair(**params)
    left = torch.from_numpy(pair.left).to(dev)
    right = torch.from_numpy(pair.right).to(dev)
    cfg = get_model("fullres_occfill", max_disp=params["max_disp"], **overrides)
    shape = (params["h"], params["w"])
    bf16 = cfg.vol_dtype == "bfloat16"
    label = (f"fullres_occfill {name} {shape[0]}x{shape[1]} D={cfg.num_disp} {cfg.vol_dtype}"
             f"{', cooperative WTA' if not cfg.compute_both_volumes else ', left+right'}")
    rows = bf16_kernel_rows(left.float(), right.float(), cfg, label, card_line) if bf16 else {}

    pipe = StereoPipeline(cfg, device=dev)
    torch.cuda.synchronize()
    ck.reset_launches()
    out = pipe(left, right)
    torch.cuda.synchronize()
    counts, counts_bf16 = dict(ck.launches), dict(ck.launches_bf16)
    check_launches(label, counts, cfg)
    want = dict(OCCFILL_LAUNCHES, arm_taps=8 if cfg.compute_both_volumes else 4)
    for kernel, n in want.items():
        if counts[kernel] != n:
            raise AssertionError(f"{label}: {kernel} launched {counts[kernel]} times, not {n}")
    for kernel, n in counts_bf16.items():
        if n != (want[kernel] if bf16 else 0):
            raise AssertionError(f"{label}: {n} of {kernel}'s launches were bfloat16 ones")
    print(f"{label}: bfloat16 launches {json.dumps(counts_bf16)}")
    check_maps(label, out, cfg, shape, dev)
    with plain_path():
        plain_out = pipe(left, right)
    for key in ("disp_left_raw", "disp_right_raw", "disparity"):
        if not torch.equal(out[key], plain_out[key]):
            raise AssertionError(f"{label}: kernel and plain paths disagree on {key}")
    del plain_out
    lrc = refine_ops.lr_consistency_classify(out["disp_left_raw"], out["disp_right_raw"],
                                             cfg.num_disp, cfg.lr_max_diff, cfg.disp_occ,
                                             cfg.disp_mis)
    n_occ, n_mis = int((lrc == cfg.disp_occ).sum()), int((lrc == cfg.disp_mis).sum())
    if not (n_occ and n_mis):
        raise AssertionError(f"{label}: the LR check gave {n_occ} DISP_OCC and {n_mis} "
                             "DISP_MIS pixels; the frame must reach both")
    bad1 = bad_pixel_rate(out["disparity"], torch.from_numpy(pair.gt).to(dev),
                          torch.from_numpy(pair.masks["nonocc"]).to(dev))
    print(f"{label}: kernel path equal to plain path on the three maps; LR check: {n_occ} px "
          f"DISP_OCC, {n_mis} px DISP_MIS, of {lrc.numel()}; final map: "
          f"{int((out['disparity'] < 0).sum())} px negative; bad-1.0 nonocc {bad1:.6f}")
    del out, lrc

    torch.cuda.reset_peak_memory_stats(dev)
    pipe(left, right)
    torch.cuda.synchronize()
    print(f"timing {label}: peak device memory of a kernel-path frame "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB [{card_line}]")
    mp_disp = shape[0] * shape[1] * cfg.num_disp / 1e6
    for path, ctx, reps in (("plain", plain_path, 1),
                            ("kernel", contextlib.nullcontext, OCCFILL_REPS),
                            ("kernel", contextlib.nullcontext, OCCFILL_REPS),
                            ("plain", plain_path, 1)):
        with ctx():
            q1, med, q3 = frame_ms(pipe, left, right, reps, warm_up=path == "kernel")
        print(f"timing {label}, {path} path: median {med:.3f} ms/frame (quartiles "
              f"{q1:.3f}-{q3:.3f}, n={reps}), {mp_disp / med * 1e3:.3f} MP*disp/s [{card_line}]")
    profile_frames(pipe, left, right, label, card_line, 2, warm_up=1)
    return rows, counts, counts_bf16


def phase_occfill(dev, card_line: str):
    """fullres_occfill's frames A and B. Returns the rows of the bfloat16
    kernels and frame B's bfloat16 launches."""
    occfill_frame("A", card_line, dev)
    torch.cuda.empty_cache()
    rows, _, counts_bf16 = occfill_frame("B", card_line, dev)
    torch.cuda.empty_cache()
    return rows, counts_bf16


def equal_maps(label: str, got: dict, want: dict, what: str) -> None:
    """Every map of ``want`` equal to ``got``'s, on ``want``'s device."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: maps {sorted(got)}, {what} {sorted(want)}")
    for key, w in want.items():
        g = got[key].to(w.device)
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: differs from {what} on {key}, at "
                                 f"{int((g != w).sum())} px")


def frame_c_kernel_rows(left, right, out, cfg, label: str, card_line: str) -> dict:
    """Each kernel of frame C's path at the shapes the streamed frame
    launches it, against its plain version: A on the two images, B's four
    launch kinds on one [32, H, W] block (the first; the last, at the image
    edge, checked too), C's four directions on the [1, 256, H, W] CBCA
    volume, D on the cooperative WTA's two volumes, the region vote's
    integer passes on the frame's LR map and proper interpolation on its
    region-voted map. Returns the kernels line's rows."""
    m, db = cfg.arm_l_out, cfg.d_stream_block
    rows = {}
    arms_pair = [arms_ops.build_arms(img, cfg) for img in (left, right)]
    rows["arms_grow_frame_c"] = run_case(
        "arms_grow", f"{label}: arms of the two images",
        combined([arms_grow_case(img, a, cfg) for img, a in zip((left, right), arms_pair)]),
        card_line)
    block_fn = cost_ops.block_cost_builder(left, right, to_gray(left), to_gray(right), cfg, 0,
                                           arms=arms_pair[0])
    for first in (cfg.num_disp - db, 0):
        ds = torch.arange(first, first + db, device=left.device)
        blk = block_fn(ds).to(torch.bfloat16)
        arms_int = arms_ops.intersect_arms_block(arms_pair[0], arms_pair[1], ds, 0)
        kinds = cbca_kinds(blk, arms_int, m)
        what = f"block d={first}..{first + db - 1} {list(blk.shape)} bf16"
        if first == 0:
            for kind, case in kinds:
                run_case("arm_taps", f"{label}: {kind} on {what}", case, card_line)
        row = run_case("arm_taps", f"{label}: the four launch kinds (sum along W, area along "
                       f"H, sum along H, area along W) on {what}",
                       combined([case for _, case in kinds]), card_line)
        del blk, arms_int, kinds
    rows["arm_taps_bf16_frame_c"] = row
    del block_fn

    vols, _ = compute_volumes(left, right, cfg)
    vol = vols.pop(0)[None]
    pscales = {d: sgm_ops.penalty_scale(left, *d, cfg.sgm_cor_dif_thres,
                                        cfg.sgm_redu_coeff)[None].contiguous()
               for d in AXES}
    rows["sgm_scan_bf16_frame_c"] = run_case(
        "sgm_scan", f"{label}: 4 axis directions over the CBCA volume {list(vol.shape)} bf16",
        sgm_case(vol, pscales, cfg, "sgm_scan"), card_line)
    sgm_vol = sgm_ops.sgm_multi([vol[0]], [left], 4, cfg.sgm_p1_eff, cfg.sgm_p2_eff,
                                cfg.sgm_cor_dif_thres, cfg.sgm_redu_coeff)[0]
    del vol, pscales
    cs = cfg.choose_small
    coop = [wta_ops.cooperative_volume(sgm_vol, lor, cs) for lor in (0, 1)]
    del sgm_vol
    hw = coop[0][0].numel()
    rows["wta_bf16_frame_c"] = run_case(
        "wta", f"{label}: both volumes of the cooperative WTA {list(coop[0].shape)} bf16",
        (lambda: tuple(ck.wta(v, cs) for v in coop),
         lambda: tuple(wta_ops.wta_plain(v, cs) for v in coop),
         2 * (coop[0].numel() * 2 + hw * 4), 2 * coop[0].numel()),
        card_line, lambda: tuple(torch.argmin(v, 0) for v in coop))
    del coop

    lrc = refine_ops.lr_consistency_classify(out["disp_left_raw"], out["disp_right_raw"],
                                             cfg.num_disp, cfg.lr_max_diff, cfg.disp_occ,
                                             cfg.disp_mis)
    rows["arm_reduce_frame_c"] = run_case(
        "arm_reduce", f"{label}: one region-vote iteration (2 min + 2 sum passes) on the "
        "frame's LR map, on no path", region_vote_case(lrc, arms_pair[0], m), card_line)
    rows["region_vote_frame_c"] = run_case(
        "region_vote", f"{label}: one region-vote pass in one launch on the frame's LR map",
        region_vote_kernel_case(lrc, arms_pair[0], m, cfg.rv_s_thres), card_line)
    rv = lrc
    for _ in range(cfg.region_vote_iters):
        rv = refine_ops.region_vote(rv, arms_pair[0], cfg.num_disp, cfg.rv_s_thres,
                                    cfg.rv_h_ratio, cfg.rv_int_ratio_quirk, m)
    print(f"{label}: {int((rv < 0).sum())} px invalid after region vote, of {rv.numel()}")
    rows["pi_scan_frame_c"] = run_case(
        "pi_scan", f"{label}: one proper-interpolation iteration on the frame's region-voted "
        f"map, depth {cfg.pi_search_depth}", pi_case(rv, left, cfg.pi_search_depth,
                                                     cfg.disp_occ), card_line)
    return rows


def phase_stream(dev, card_line: str):
    """fullres_occfill's frame C, streamed: launches, maps equal to the
    dense kernel path's and to the streamed plain path's, peak memory
    against the dense frame's, times and profiles of both; then its
    kernels at its shapes. Returns (the kernels line's rows, the streamed
    frame's launches)."""
    params, overrides = FRAME_C
    pair = make_synthetic_pair(**params)
    left = torch.from_numpy(pair.left).to(dev)
    right = torch.from_numpy(pair.right).to(dev)
    cfg = get_model("fullres_occfill", max_disp=params["max_disp"], **overrides)
    shape = (params["h"], params["w"])
    label = (f"fullres_occfill C {shape[0]}x{shape[1]} D={cfg.num_disp} {cfg.vol_dtype}, "
             f"cooperative WTA, d_stream_block={cfg.d_stream_block}")
    pipes = {"streamed": StereoPipeline(cfg, device=dev),
             "dense": StereoPipeline(cfg.replace(d_stream_block=0), device=dev)}

    outs, peaks, counts = {}, {}, {}
    for path, pipe in pipes.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ck.reset_launches()
        outs[path] = pipe(left, right)
        torch.cuda.synchronize()
        peaks[path] = torch.cuda.max_memory_allocated(dev)
        counts[path] = dict(ck.launches)
        counts[f"{path}_bf16"] = dict(ck.launches_bf16)
        print(f"{label}, {path}: launches {json.dumps(counts[path])}, bfloat16 "
              f"{json.dumps(counts[f'{path}_bf16'])}; peak device memory "
              f"{peaks[path] / 2**20:.1f} MiB [{card_line}]")
    stream = counts["streamed"]
    check_launches(label, stream, cfg)
    for kernel, n in FRAME_C_LAUNCHES.items():
        if stream[kernel] != n:
            raise AssertionError(f"{label}: {kernel} launched {stream[kernel]} times, not {n}")
    for kernel, n in counts["streamed_bf16"].items():
        if n != FRAME_C_LAUNCHES[kernel]:
            raise AssertionError(f"{label}: {n} of {kernel}'s launches were bfloat16 ones")
    check_maps(label, outs["streamed"], cfg, shape, dev)
    equal_maps(label, outs["streamed"], outs["dense"], "the dense kernel path")
    share = peaks["streamed"] / peaks["dense"]
    print(f"{label}: equal to the dense kernel path on the three maps; peak device memory "
          f"{peaks['streamed'] / 2**20:.1f} MiB streamed against {peaks['dense'] / 2**20:.1f} "
          f"MiB dense, {share:.3f} of it (limit {FRAME_C_PEAK_SHARE}) [{card_line}]")
    if share > FRAME_C_PEAK_SHARE:
        raise AssertionError(f"{label}: the streamed frame's peak is {share:.3f} of the dense "
                             f"one's, over {FRAME_C_PEAK_SHARE}")
    del outs["dense"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with plain_path():
        plain = pipes["streamed"](left, right)
    torch.cuda.synchronize()
    print(f"{label}: streamed plain path, one frame in {time.perf_counter() - t0:.3f} s "
          f"[{card_line}]")
    equal_maps(label, outs["streamed"], plain, "the streamed plain path")
    del plain
    out = outs["streamed"]
    lrc = refine_ops.lr_consistency_classify(out["disp_left_raw"], out["disp_right_raw"],
                                             cfg.num_disp, cfg.lr_max_diff, cfg.disp_occ,
                                             cfg.disp_mis)
    bad1 = bad_pixel_rate(out["disparity"], torch.from_numpy(pair.gt).to(dev),
                          torch.from_numpy(pair.masks["nonocc"]).to(dev))
    print(f"{label}: equal to the streamed plain path on the three maps; LR check: "
          f"{int((lrc == cfg.disp_occ).sum())} px DISP_OCC, {int((lrc == cfg.disp_mis).sum())} "
          f"px DISP_MIS, of {lrc.numel()}; bad-1.0 nonocc {bad1:.6f}")
    del lrc

    mp_disp = shape[0] * shape[1] * cfg.num_disp / 1e6
    for path in ("streamed", "dense", "dense", "streamed"):
        torch.cuda.empty_cache()
        q1, med, q3 = frame_ms(pipes[path], left, right, OCCFILL_REPS)
        print(f"timing {label}, {path} kernel path: median {med:.3f} ms/frame (quartiles "
              f"{q1:.3f}-{q3:.3f}, n={OCCFILL_REPS}), {mp_disp / med * 1e3:.3f} MP*disp/s "
              f"[{card_line}]")
    for path, pipe in pipes.items():
        torch.cuda.empty_cache()
        profile_frames(pipe, left, right, f"{label}, {path}", card_line, 2, warm_up=1)
    del pipes
    torch.cuda.empty_cache()
    rows = frame_c_kernel_rows(left.float(), right.float(), out, cfg, label, card_line)
    torch.cuda.empty_cache()
    return rows, stream


def phase_copy_bw(dev, card_line: str) -> dict:
    """The copy-bandwidth probe (tools/check_bw.py), once: every probe
    tiling's rate beside Tensor.copy_'s and torch.mul's, then the kernels
    line's row on the 4 GiB buffer, with Tensor.copy_ as the library call
    and torch.mul's (x * 1.0001) device time beside it, and the measured
    copy rate from that row's device time."""
    from tools import check_bw

    check_bw.run(dev, card_line, big=False)
    x = check_bw.big_buffer(dev)
    out = torch.empty_like(x)
    rows, cols = check_bw.BIG_TILE
    n = x.numel()
    row = run_case("copy_bw", f"x * 1.0001 of a 4 GiB float32 buffer {list(x.shape)} in tiles "
                   f"{rows}x{cols}", (lambda: ck.copy_bw(x, rows, cols),
                                      lambda: bandwidth.scaled_copy_plain(x), 8 * n, n),
                   card_line, lambda: out.copy_(x))
    row["torch_mul_ms"] = device_ms(lambda: x * bandwidth.COPY_SCALE)[0]
    rate = check_bw.gbs(x, row["ms"])
    print(f"copy_bw measured copy rate (4 GiB buffer, device time): {rate:.1f} GB/s, "
          f"{rate / 3350:.3f} of the nominal 3.35 TB/s; Tensor.copy_ "
          f"{check_bw.gbs(x, row['library_ms']):.1f} GB/s ({row['library_ms']:.4f} ms, kernel / "
          f"copy_ {row['ms'] / row['library_ms']:.3f}); torch.mul "
          f"{check_bw.gbs(x, row['torch_mul_ms']):.1f} GB/s ({row['torch_mul_ms']:.4f} ms, "
          f"kernel / mul {row['ms'] / row['torch_mul_ms']:.3f}) [{card_line}]")
    row["copy_rate_gbs"] = rate
    del x, out
    torch.cuda.empty_cache()
    return row


def nl_frame(cfg, left, right, dev, label: str):
    """One frame of an NL preset with the launch counts set to 0 just before
    it: its launches (every kernel of its path must launch), its maps
    equal to a second kernel frame's, to the card's plain path's and to the
    CPU port's. Returns (maps, launches, the pipeline, the second frame's
    host-clock ms, synchronised)."""
    pipe = StereoPipeline(cfg, device=dev)
    torch.cuda.synchronize()
    ck.reset_launches()
    out = pipe(left, right)
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    check_launches(label, counts, cfg)
    t0 = time.perf_counter()
    again = pipe(left, right)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    equal_maps(label, again, out, "a second kernel-path frame")
    with plain_path():
        equal_maps(label, out, pipe(left, right), "the plain path on the card")
    equal_maps(label, out, StereoPipeline(cfg, device="cpu")(left.cpu(), right.cpu()),
               "the CPU port")
    return out, counts, pipe, ms


def nl_kernel_rows(left, right, out, cfg, label: str, card_line: str) -> dict:
    """A, D, arm_reduce, region_vote and pi_scan at the nl_tree_filter
    frame's shapes, on its inputs: the left image's arms, the cooperative
    WTA's two views of the NL-aggregated volume, one region-vote iteration
    on its LR map (as four arm_reduce passes, and as one pass of
    region_vote), one proper-interpolation iteration on its region-voted
    map."""
    m = cfg.arm_l_out
    with plain_path():
        vols, arms_pair = compute_volumes(left, right, cfg, nl_trees(left, right, cfg))
        arms0 = arms_pair[0]
        lrc = refine_ops.lr_consistency(out["disp_left_raw"], out["disp_right_raw"],
                                        cfg.lr_max_diff)
        rv = lrc
        for _ in range(cfg.region_vote_iters):
            rv = refine_ops.region_vote(rv, arms0, cfg.num_disp, cfg.rv_s_thres, cfg.rv_h_ratio,
                                        cfg.rv_int_ratio_quirk, m)
    coop = [wta_ops.cooperative_volume(vols[0], lor).contiguous() for lor in (0, 1)]
    hw = lrc.numel()
    cases = {
        "arms_grow_nl": ("arms of the left image", arms_grow_case(left, arms0, cfg), None),
        "wta_nl": ("the cooperative WTA's two views of the NL-aggregated [60,375,450] volume",
                   (lambda: tuple(ck.wta(v) for v in coop),
                    lambda: tuple(wta_ops.wta_plain(v) for v in coop),
                    2 * (coop[0].numel() * 4 + hw * 4), 2 * coop[0].numel()),
                   lambda: [torch.argmin(v, 0) for v in coop]),
        "arm_reduce_nl": ("one region-vote iteration on the frame's LR map, on no path",
                          region_vote_case(lrc, arms0, m), None),
        "region_vote_nl": ("one region-vote pass in one launch on the frame's LR map",
                           region_vote_kernel_case(lrc, arms0, m, cfg.rv_s_thres), None),
        "pi_scan_nl": (f"one proper-interpolation iteration on the frame's region-voted map, "
                       f"depth {cfg.pi_search_depth}",
                       pi_case(rv, left, cfg.pi_search_depth, cfg.disp_occ), None),
    }
    return {row: run_case(row, f"{label}: {what}", case, card_line, library,
                          kernel_name=NL_ROWS[row])
            for row, (what, case, library) in cases.items()}


def launches_of(fn) -> int:
    """The kernel launches of one call of fn (torch.profiler's launch events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name in ("cudaLaunchKernel", "cuLaunchKernel"))


def nl_tree_builds(left, right, frames: dict, dev, card_line: str) -> None:
    """For 4 and 8 neighbours on the Teddy-sized left image: the device tree
    (mst.build_tree) equal to the host tree (mst.build_tree_host) in parent,
    weight, BFS order and layout; both builds' host-clock ms (synchronised,
    in turns) and the device build's launches; and the frame of ``frames``
    (preset -> (cfg, its maps on device trees)) equal to the same frame on
    host trees (``nl_tree_host=True``) on every map, and for 4 neighbours
    both frames' ms in turns."""
    for neighbors, (name, (cfg, out)) in zip((4, 8), frames.items()):
        host = mst.build_tree_host(left, neighbors)
        tree = mst.build_tree(left, neighbors)
        for field in ("parent", "weight", "order", "child_idx"):
            if not torch.equal(getattr(tree, field), getattr(host, field)):
                raise AssertionError(f"{neighbors}-neighbour device tree: {field} differs from "
                                     "the host tree's")
        if (tree.starts, tree.child_k) != (host.starts, host.child_k):
            raise AssertionError(f"{neighbors}-neighbour device tree: levels differ")
        times = {"device": [], "host": []}
        for _ in range(NL_BUILD_REPS):
            for kind, build in (("device", mst.build_tree), ("host", mst.build_tree_host)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                build(left, neighbors)
                torch.cuda.synchronize()
                times[kind].append((time.perf_counter() - t0) * 1e3)
        launches = launches_of(lambda: mst.build_tree(left, neighbors))
        dev_ms, host_ms = (float(np.median(times[k])) for k in ("device", "host"))
        print(f"NL trees, {neighbors} neighbours, {tuple(left.shape[:2])}: device tree = host "
              f"tree (parent, weight, order, layout; height {tree.height}); device build "
              f"median {dev_ms:.3f} ms ({min(times['device']):.3f}-{max(times['device']):.3f}, "
              f"n={NL_BUILD_REPS}), {launches} launches; host build median {host_ms:.3f} ms "
              f"({min(times['host']):.3f}-{max(times['host']):.3f}) [{card_line}]")
        pipes = {"device": StereoPipeline(cfg, device=dev),
                 "host": StereoPipeline(cfg.replace(nl_tree_host=True), device=dev)}
        equal_maps(f"{name} on host trees", pipes["host"](left, right), out,
                   "the frame on device trees")
        line = f"{name}: the frame on device trees = the frame on host trees, every map"
        if neighbors == 4:
            frame = {"device": [], "host": []}
            for kind in ("device", "host", "host", "device"):
                frame[kind].append(frame_ms(pipes[kind], left, right, NL_REPS)[1])
            line += (f"; median ms/frame on device trees {frame['device'][0]:.3f}, "
                     f"{frame['device'][1]:.3f}, on host trees {frame['host'][0]:.3f}, "
                     f"{frame['host'][1]:.3f} (n={NL_REPS} each, in turns: device, host, host, "
                     f"device) [{card_line}]")
        print(line)


def nl_batch(cfg, dev, card_line: str) -> None:
    """match_pair_nl_batch on NL_BATCH Teddy-sized pairs (seeds 0-7): each
    frame's maps equal to match_pair's on that frame, and the batch's
    ms/frame beside the frames' one by one (host clock, synchronised, a
    warm-up first)."""
    pairs = [make_synthetic_pair(**dict(TEDDY, seed=s)) for s in range(NL_BATCH)]
    lefts = torch.from_numpy(np.stack([p.left for p in pairs])).to(dev, torch.float32)
    rights = torch.from_numpy(np.stack([p.right for p in pairs])).to(dev, torch.float32)
    out = match_pair_nl_batch(lefts, rights, cfg)
    for k in range(NL_BATCH):
        equal_maps(f"match_pair_nl_batch frame {k}", {key: v[k] for key, v in out.items()},
                   match_pair(lefts[k], rights[k], cfg), "match_pair on that frame")
    ms = {}
    for kind in ("batch", "frames", "frames", "batch"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "batch":
            match_pair_nl_batch(lefts, rights, cfg)
        else:
            for k in range(NL_BATCH):
                match_pair(lefts[k], rights[k], cfg)
        torch.cuda.synchronize()
        ms.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3 / NL_BATCH)
    print(f"match_pair_nl_batch, {NL_BATCH} frames {TEDDY['h']}x{TEDDY['w']} D={cfg.num_disp}: "
          f"every frame equal to match_pair's; {ms['batch'][0]:.3f}, {ms['batch'][1]:.3f} "
          f"ms/frame batched against {ms['frames'][0]:.3f}, {ms['frames'][1]:.3f} one frame at "
          f"a time (runs in turns: batch, frames, frames, batch) [{card_line}]")


def nl_bf16(cfg, left, right, out, dev, card_line: str) -> None:
    """The bfloat16 filter (``nl_filter_dtype``) at Teddy size: its frame
    equal to the CPU port's, its share of disparities off the float32
    frame's ``out`` (at most NL_FLIP_SHARE), its ms/frame."""
    cfg16 = cfg.replace(nl_filter_dtype="bfloat16")
    pipe = StereoPipeline(cfg16, device=dev)
    got = pipe(left, right)
    equal_maps("nl_tree_filter bfloat16 filter", got,
               StereoPipeline(cfg16, device="cpu")(left.cpu(), right.cpu()), "the CPU port")
    share = float((got["disparity"] != out["disparity"]).float().mean())
    q1, med, q3 = frame_ms(pipe, left, right, NL_REPS)
    print(f"nl_tree_filter, bfloat16 filter: {share:.6f} of the disparities differ from the "
          f"float32 filter's (bound {NL_FLIP_SHARE}); equal to the CPU port; median {med:.3f} "
          f"ms/frame (quartiles {q1:.3f}-{q3:.3f}, n={NL_REPS}) [{card_line}]")
    if not share <= NL_FLIP_SHARE:
        raise AssertionError(f"bfloat16 filter: {share:.4f} of the disparities flipped")


def nl_entry(dev) -> None:
    """``entry.entry("cuda", "nl_tree_filter")``, the user's entry point,
    with the launch counts set to 0 just before it: every kernel of the
    path launches, and the maps equal the CPU entry's."""
    from mystereomatching_tpu_torch.entry import entry

    fn, args = entry(str(dev), "nl_tree_filter")
    torch.cuda.synchronize()
    ck.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    check_launches("entry('cuda', 'nl_tree_filter')", dict(ck.launches), fn.cfg)
    cpu_fn, cpu_args = entry("cpu", "nl_tree_filter")
    equal_maps("entry('cuda', 'nl_tree_filter')", out, cpu_fn(*cpu_args), "entry('cpu')")
    print(f"entry('cuda', 'nl_tree_filter'): {tuple(out['disparity'].shape)}, device trees in "
          f"{fn.tree_ms:.3f} ms, equal to entry('cpu')")


def phase_nl(dev, card_line: str):
    """The NL presets: nl_tree_filter at Teddy size (its frame timed, with its
    tree build on the device, tree height, device time, idle share, launches
    and peak memory, then its kernels at its shapes), the qx flows nl_post
    and nl_census_post on the golden scenes against the reference binary's
    maps, and nl_8nr once, all on device-built trees; then the device trees
    against the host trees (:func:`nl_tree_builds`), the batched path
    (:func:`nl_batch`), the bfloat16 filter (:func:`nl_bf16`) and the
    entry point (:func:`nl_entry`). Returns (the kernels line's rows,
    nl_tree_filter's launches)."""
    pair = make_synthetic_pair(**TEDDY)
    left = torch.from_numpy(pair.left).to(dev, torch.float32)
    right = torch.from_numpy(pair.right).to(dev, torch.float32)
    shape = (TEDDY["h"], TEDDY["w"])
    cfg = get_model("nl_tree_filter", max_disp=TEDDY["max_disp"])
    label = f"nl_tree_filter {shape[0]}x{shape[1]} D={cfg.num_disp}"
    out, counts, pipe, _ = nl_frame(cfg, left, right, dev, label)
    check_maps(label, out, cfg, shape, dev)
    tree = nl_trees(left, right, cfg)[0]
    vol = cost_ops.compute_cost_volume(left, right, to_gray(left), to_gray(right), cfg, 0,
                                       arms=arms_ops.build_arms(left, cfg))
    if not torch.equal(nl_ops.nl_aggregate(vol, tree, cfg.nl_sigma),
                       nl_ops.nl_aggregate(vol, tree, cfg.nl_sigma)):
        raise AssertionError(f"{label}: two tree filter runs differ")
    del vol
    bad1 = bad_pixel_rate(out["disparity"], torch.from_numpy(pair.gt).to(dev),
                          torch.from_numpy(pair.masks["nonocc"]).to(dev))
    print(f"{label}: launches {json.dumps(counts)}; maps equal to a second frame, the plain "
          f"path and the CPU port; two filter runs equal; bad-1.0 nonocc {bad1:.6f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    q1, med, q3 = frame_ms(pipe, left, right, NL_REPS)
    peak = torch.cuda.max_memory_allocated(dev)
    mp_disp = shape[0] * shape[1] * cfg.num_disp / 1e6
    print(f"timing {label}, kernel path: median {med:.3f} ms/frame (quartiles {q1:.3f}-{q3:.3f}, "
          f"n={NL_REPS}), {mp_disp / med * 1e3:.3f} MP*disp/s; device tree build "
          f"{pipe.tree_ms:.3f} ms of the last frame; tree height {tree.height} ({tree.n} nodes, "
          f"{len(tree.starts) - 1} levels); peak device memory {peak / 2**20:.1f} MiB "
          f"[{card_line}]")
    profile_frames(pipe, left, right, label, card_line, NL_PROFILE_FRAMES, warm_up=0)
    rows = nl_kernel_rows(left, right, out, cfg, label, card_line)

    for scene, (params, adversarial, presets) in NL_GOLDEN.items():
        gen = make_adversarial_pair if adversarial else make_synthetic_pair
        p = gen(name=scene, **params)
        sl = torch.from_numpy(p.left).to(dev, torch.float32)
        sr = torch.from_numpy(p.right).to(dev, torch.float32)
        for preset, (mode, budget) in presets.items():
            pcfg = get_model(preset, max_disp=params["max_disp"])
            plabel = f"{preset} {scene}"
            pout, pcounts, ppipe, ms = nl_frame(pcfg, sl, sr, dev, plabel)
            raw = pout["disp_left_raw"].cpu().numpy()
            disp = pout["disparity"].cpu().numpy().astype(np.int32)
            n_raw, n_post = (int((m != load_ref_disp(os.path.join(
                GOLDEN, f"{scene}_{mode}_nl_{kind}.bin"), np.uint8)).sum())
                for m, kind in ((raw, "nopost"), (disp, "post")))
            print(f"{plabel}: differs from the reference binary at {n_raw} px before and {n_post} "
                  f"px after post-processing (budget {budget}); equal to the plain path and the "
                  f"CPU port; launches {json.dumps({k: v for k, v in pcounts.items() if v})}; "
                  f"{ms:.3f} ms a frame (the second), device tree builds {ppipe.tree_ms:.3f} ms "
                  f"[{card_line}]")
            if n_raw > budget or n_post > budget:
                raise AssertionError(f"{plabel}: differs from the reference binary at {n_raw}/"
                                     f"{n_post} px, budget {budget}")
    cfg8 = get_model("nl_8nr", max_disp=TEDDY["max_disp"])
    label8 = f"nl_8nr {shape[0]}x{shape[1]} D={cfg8.num_disp}"
    out8, counts8, pipe8, ms8 = nl_frame(cfg8, left, right, dev, label8)
    check_maps(label8, out8, cfg8, shape, dev)
    tree8 = nl_trees(left, right, cfg8)[0]
    print(f"{label8}: equal to the plain path and the CPU port; launches "
          f"{json.dumps({k: v for k, v in counts8.items() if v})}; {ms8:.3f} ms a frame (the "
          f"second); tree height {tree8.height}; device tree build {pipe8.tree_ms:.3f} ms "
          f"[{card_line}]")
    nl_tree_builds(left, right, {"nl_tree_filter": (cfg, out), "nl_8nr": (cfg8, out8)}, dev,
                   card_line)
    nl_batch(cfg, dev, card_line)
    nl_bf16(cfg, left, right, out, dev, card_line)
    nl_entry(dev)
    return rows, counts


def phase_micro4(dev, card_line: str) -> dict:
    """The gather and prefix-sum probes (tools/micro4.py) at micro4.py's
    [375, 450] plane and at the NL filter's [168750, 61] rows: each kernel
    against its plain version (gathers exactly; the kernel's cumsums equal
    to the sequential float32 sums, torch.cumsum's within the stated bound
    of the float64 sum), with its bound and the library call's
    time. Returns the kernels line's rows."""
    from tools import micro4

    rows = {}
    for name, what, kernel, plain, library, check, nbytes, nops in micro4.cases(dev):
        rows[name] = run_case(name, what, (kernel, plain, nbytes, nops), card_line, library,
                              check=check, kernel_name=name.removesuffix("_nl"))
    for name in ("cumsum_cols", "cumsum_cols_nl"):
        ms, lib_ms = rows[name]["ms"], rows[name]["library_ms"]
        print(f"kernel {name}: {ms:.4f} ms device, torch.cumsum {lib_ms:.4f} ms (kernel / "
              f"library {ms / lib_ms:.3f}), {rows[name]['case']} [{card_line}]")
    torch.cuda.empty_cache()
    return rows


def near_ties(label: str, out: dict, cpu: dict, left, right, cfg, most: int = 8) -> None:
    """Where the left WTA map on the card differs from the CPU port's: each
    pixel's two disparities and the CPU's costs there (an unaggregated
    volume, built on the CPU)."""
    got, want = out["disp_left_raw"].cpu(), cpu["disp_left_raw"]
    where = torch.nonzero(got != want).tolist()
    if not where:
        return
    vol = compute_volumes(left.cpu(), right.cpu(), cfg)[0][0]
    for y, x in where[:most]:
        a, b = int(want[y, x]), int(got[y, x])
        print(f"{label}: pixel ({y}, {x}): the CPU port's disparity {a} costs "
              f"{float(vol[a, y, x])!r}, the card's {b} costs {float(vol[b, y, x])!r} on the CPU")


def census_frame(name: str, dev, card_line: str):
    """One frame of a census preset at its bench-suite size, with the launch
    counts set to 0 just before it: exactly the kernels of
    ``kernels_launched`` must launch, and its maps must equal the card's
    plain path's and (for ``CENSUS_EXACT``) the CPU port's. Then its bad-1.0
    rate, peak device memory, frame time and a profile (device time, idle
    share, launches a frame). Returns (maps, launches, left, right, cfg,
    label)."""
    params = CENSUS[name]
    pair = make_synthetic_pair(**params)
    left = torch.from_numpy(pair.left).to(dev, torch.float32)
    right = torch.from_numpy(pair.right).to(dev, torch.float32)
    cfg = get_model(name, max_disp=params["max_disp"])
    shape = (params["h"], params["w"])
    label = f"{name} {shape[0]}x{shape[1]} D={cfg.num_disp}"
    pipe = StereoPipeline(cfg, device=dev)
    torch.cuda.synchronize()
    ck.reset_launches()
    out = pipe(left, right)
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    launched = [k for k, n in counts.items() if n]
    if launched != kernels_launched(cfg):
        raise AssertionError(f"{label}: launched {launched}, not {kernels_launched(cfg)}")
    for key, d in out.items():
        want_dtype = torch.float32 if key == "disparity" else torch.int32
        if d.shape != shape or d.dtype != want_dtype or not bool(torch.isfinite(d).all()):
            raise AssertionError(f"{label} {key}: {d.dtype}{tuple(d.shape)}, or not finite")
    with plain_path():
        equal_maps(label, out, pipe(left, right), "the plain path on the card")
    cpu = StereoPipeline(cfg, device="cpu")(left.cpu(), right.cpu())
    differing = {key: int((out[key].cpu() != cpu[key]).sum()) for key in cpu}
    if name in CENSUS_EXACT:
        equal_maps(label, out, cpu, "the CPU port")
    else:
        near_ties(label, out, cpu, left, right, cfg)
    bad1 = bad_pixel_rate(out["disparity"], torch.from_numpy(pair.gt).to(dev),
                          torch.from_numpy(pair.masks["nonocc"]).to(dev))
    print(f"{label}: launches {json.dumps({k: n for k, n in counts.items() if n})}, exactly "
          f"kernels_launched; maps equal to the plain path on the card; pixels differing from "
          f"the CPU port {json.dumps(differing)}; bad-1.0 nonocc {bad1:.6f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    q1, med, q3 = frame_ms(pipe, left, right, CENSUS_REPS)
    peak = torch.cuda.max_memory_allocated(dev)
    mp_disp = shape[0] * shape[1] * cfg.num_disp / 1e6
    print(f"timing {label}, kernel path: median {med:.3f} ms/frame (quartiles {q1:.3f}-"
          f"{q3:.3f}, n={CENSUS_REPS}), {mp_disp / med * 1e3:.3f} MP*disp/s; peak device "
          f"memory {peak / 2**20:.1f} MiB [{card_line}]")
    profile_frames(pipe, left, right, label, card_line, CENSUS_PROFILE_FRAMES, warm_up=1)
    return out, counts, left, right, cfg, label


def phase_census(dev, card_line: str):
    """The census cost family's presets: ad_census_wta and census_wta at
    288x384, D=16, and census_cbca_lrc at 375x450, D=64 (each a
    :func:`census_frame`), then A, B and D at census_cbca_lrc's shapes on
    its inputs, and region_vote on its LR map. Returns (the kernels line's
    rows, census_cbca_lrc's launches)."""
    for name in ("ad_census_wta", "census_wta"):
        census_frame(name, dev, card_line)
    out, counts, left, right, cfg, label = census_frame("census_cbca_lrc", dev, card_line)
    with plain_path():
        vols, arms_pair = compute_volumes(left, right, cfg)
    lrc = refine_ops.lr_consistency(out["disp_left_raw"], out["disp_right_raw"], cfg.lr_max_diff)
    vols = [vols[lor].contiguous() for lor in (0, 1)]
    hw = left.shape[0] * left.shape[1]
    rows = {
        "arms_grow_census": run_case(
            "arms_grow_census", f"{label}: arms of the left image",
            arms_grow_case(left, arms_pair[0], cfg), card_line, kernel_name="arms_grow"),
        "arm_taps_census": arm_taps_frame(left, right, cfg, label, card_line),
        "wta_census": run_case(
            "wta_census", f"{label}: the frame's two CBCA volumes {list(vols[0].shape)}",
            (lambda: tuple(ck.wta(v) for v in vols),
             lambda: tuple(wta_ops.wta_plain(v) for v in vols),
             2 * (vols[0].numel() * 4 + hw * 4), 2 * vols[0].numel()),
            card_line, lambda: [torch.argmin(v, 0) for v in vols], kernel_name="wta"),
        "region_vote_census": run_case(
            "region_vote_census", f"{label}: one region-vote pass on the frame's LR map (the "
            "frame itself runs none)", region_vote_kernel_case(lrc, arms_pair[0], cfg.arm_l_out,
                                                               cfg.rv_s_thres),
            card_line, kernel_name="region_vote"),
    }
    del vols
    torch.cuda.empty_cache()
    return rows, counts


def phase_sgm_layouts(dev, card_line: str, build_log: str) -> dict:
    """The SGM-layout probes (tools/sgm_layouts.py) at the scripts' [4, 375,
    60, 450] and sgm8_full's scan [2, 750, 128, 1000]: each kernel against
    its plain version and, in full, kernel C's downward scan on the same
    values (bit for bit), with its bound, kernel C's device time on the
    [G, D, H, W] transpose, the HDW kernel's time with its two transposes,
    and for copy ``torch.mul``'s; then each instance's registers and
    spills. Returns the kernels line's rows."""
    from tools import sgm_layouts

    rows = {}
    for suffix in sgm_layouts.SHAPES:
        vol, ps, vol_t, _, cases = sgm_layouts.shape_cases(suffix, dev)
        c_ms, c_from = device_ms(lambda: sgm_layouts.kernel_c(vol_t, ps), "sgm_scan")
        print(f"kernel sgm_scan, the probes' values as [G, D, H, W] {list(vol_t.shape)}, "
              f"downward: {c_ms:.4f} ms device ({c_from}) [{card_line}]")
        print(f"sgm_probe_hdw with the two transposes around it, {list(vol_t.shape)}: "
              f"{sgm_layouts.transposed_hdw_ms(vol_t, ps):.4f} ms between events [{card_line}]")
        for name, entry, _, what, kernel, plain, library, check, nbytes, nops in cases:
            rows[name] = run_case(name, what, (kernel, plain, nbytes, nops), card_line, library,
                                  check=check, kernel_name=entry)
            rows[name]["kernel_c_ms"] = c_ms
        print(sgm_layouts.copy_line(suffix, {name: (row["ms"], row["library_ms"])
                                             for name, row in rows.items()}, card_line))
        del vol, ps, vol_t, cases
        torch.cuda.empty_cache()
    sgm_layouts.print_registers(build_log, card_line)
    return rows


def phase_taps_probes(dev, card_line: str, build_log: str) -> dict:
    """The taps probes (tools/taps_probes.py) on the scripts' [60, 375, 450]
    volumes with max_arm 34 (and micro_cbca5.py's 16 frames): each kernel
    against its plain version bit for bit, with its bound, kernel B's device
    time on the same values along the same axis and the largest difference
    to B (within the reordering bound, but for fixed); then each instance's
    registers and spills. Returns the kernels line's rows."""
    from tools import taps_probes

    rows, b_ms, b_diff = {}, {}, {}
    for name, entry, what, kernel, plain, b, nbytes, nops in taps_probes.cases(dev):
        def check(got, want, name=name, b=b):
            b_diff[name] = b.diff(name, got)
            return compare(name, got, want)

        row = run_case(name, what, (kernel, plain, nbytes, nops), card_line, check=check,
                       kernel_name=entry)
        if id(b) not in b_ms:
            b_ms[id(b)] = device_ms(b.call, "arm_taps")[0]
            bound_ms, bound_by = bound(b.nbytes, nops)
            print(f"kernel arm_taps (B), its sum pass on the same values, int8 arms: "
                  f"{b_ms[id(b)]:.4f} ms device; bound {bound_ms:.4f} ms by {bound_by} "
                  f"({b.nbytes / 1e6:.3f} MB), {bound_ms / b_ms[id(b)]:.3f} of it [{card_line}]")
        print(f"  {name}: max |probe - B| {b_diff[name]!r}"
              f"{' (wrong by design: no bound)' if 'fixed' in name else ''}")
        row.update(kernel_b_ms=b_ms[id(b)], kernel_b_max_diff=b_diff[name])
        if name in taps_probes.ROWS:
            rows[name] = row
    torch.cuda.empty_cache()
    taps_probes.print_registers(build_log, card_line)
    return rows


def row_band_devices(n: int):
    """(devices, backend) for n ranks: one card a rank over NCCL where there
    are cards enough, else all on card 0 over gloo."""
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)], "nccl"
    return ["cuda:0"] * n, "gloo"


def frame_volume(left, right, cfg) -> torch.Tensor:
    """The left view's CBCA volume [D, H, W] of a pair, as the dense path
    computes it."""
    vols, _ = compute_volumes(left, right, cfg.replace(compute_both_volumes=False))
    return vols[0]


def direction_band(mesh, left, right, cfg, n_chunks, direction):
    """Rank job: the band's path costs of one direction of the frame's left
    CBCA volume, through the row-band pipeline's SGM (sgm_band_direction)."""
    lf = torch.from_numpy(left).to(mesh.device, torch.float32)
    rf = torch.from_numpy(right).to(mesh.device, torch.float32)
    vol = frame_volume(lf, rf, cfg)
    h = vol.shape[1] // mesh.n_row
    rows = slice(mesh.row_index * h, (mesh.row_index + 1) * h)
    return sgm_band_direction(vol[:, rows].contiguous(), lf[rows].contiguous(), cfg,
                              *direction, n_chunks, mesh)


def direction_dense(gathered, left, right, cfg, n_chunks, direction):
    """On rank 0: the gathered band path costs against the dense kernel's
    (C along an axis, E on a diagonal) on the whole volume."""
    del n_chunks
    lf = torch.from_numpy(left).to(gathered.device, torch.float32)
    rf = torch.from_numpy(right).to(gathered.device, torch.float32)
    vol = frame_volume(lf, rf, cfg)[None].contiguous()
    ps = sgm_ops.penalty_scale(lf, *direction, cfg.sgm_cor_dif_thres,
                               cfg.sgm_redu_coeff)[None].contiguous()
    diagonal = bool(direction[0] and direction[1])
    name = "sgm_diag" if diagonal else "sgm_scan"
    scan = sgm_ops.sgm_diag_scan if diagonal else sgm_ops.sgm_scan  # C or E on the card
    want = scan(vol, ps, cfg.sgm_p1_eff, cfg.sgm_p2_eff, *scan_args(direction))[0]
    err = float((gathered.double() - want.double()).abs().max())
    return dict(equal=bool(torch.equal(gathered, want)), max_abs_err=err, dense=name)


def table_case(scans, cfg, lines=None):
    """Kernel C's table kernel on ``scans`` (ChunkScans) as (kernel, plain,
    bytes, operations): each chunk's costs read and path costs written once,
    its scales, mask and initial row read once and its edge row written
    once; 7 operations an element, 8 with the mask. The plain version writes
    outputs and edge rows of its own, and :func:`table_check` holds the
    kernel's against them."""
    p1, p2 = cfg.sgm_p1_eff, cfg.sgm_p2_eff
    outs = {}
    plain_scans = []
    for sc in scans:
        outs.setdefault(sc.out.data_ptr(), torch.empty_like(sc.out))
        plain_scans.append(dataclasses.replace(
            sc, out=outs[sc.out.data_ptr()],
            edge=torch.empty_like(sc.edge) if sc.edge is not None else None))
    nbytes = nops = 0
    for sc in scans:
        d, h = sc.vol.shape[:2]
        n, es = d * h * sc.width, sc.vol.element_size()
        nbytes += 2 * n * es + h * sc.width * 4 * (1 + (sc.mask is not None))
        nbytes += sum(d * sc.width * es for t in (sc.init, sc.edge) if t is not None)
        nops += (8 if sc.mask is not None else 7) * n
    return (lambda: ck.sgm_scan_table(scans, p1, p2, lines),
            lambda: sgm_ops.sgm_scan_table_plain(plain_scans, p1, p2),
            nbytes, nops, plain_scans)


def table_check(scans, plain_scans):
    """check for run_case: every chunk and edge row of the kernel's table
    equal to the plain version's; returns the largest difference."""
    def check(got, want):
        del got, want
        err = 0.0
        for sc, ref in zip(scans, plain_scans):
            pairs = [(sc.out[:, :, sc.lo:sc.lo + sc.width], ref.out[:, :, sc.lo:sc.lo + sc.width])]
            if sc.edge is not None:
                pairs.append((sc.edge, ref.edge))
            for a, b in pairs:
                err = max(err, compare("sgm_scan_ext", a, b))
        return err
    return check


def band_step(vols, images, cfg, n_row: int, dirs, chunk: int, dtype):
    """Band 1's chunk ``chunk`` of every direction of ``dirs`` (one band
    order) of every volume [D, Hg, W] (with its [Hg, W, 3] image), in
    ``dtype``, as the row-band pipeline launches it: ChunkScans over the
    band path's own buffers (``sharded._band_scan``: the volume for a
    vertical scan, the skewed buffer of W + Hg - 1 columns with its in-image
    mask for a diagonal one), each from band 0's boundary row of that chunk
    (the plain version's), with an edge row to send on."""
    thres, coeff = cfg.sgm_cor_dif_thres, cfg.sgm_redu_coeff
    h = vols[0].shape[1] // n_row

    def band(b):
        mesh = RowMesh(rank=b, n_data=1, n_row=n_row, device=vols[0].device, backend="gloo")
        rows = slice(b * h, (b + 1) * h)
        scans = []
        for rv, ru in dirs:
            for vol, image in zip(vols, images):
                ps = sgm_ops.penalty_scale(image, rv, ru, thres, coeff)[rows].contiguous()
                whole, _ = _band_scan(vol[:, rows].to(dtype).contiguous(), ps, rv, ru, mesh)
                cw = -(-whole.width // ROW_BANDS_CHUNKS)
                scans.append(dataclasses.replace(whole, lo=chunk * cw,
                                                 width=min(cw, whole.width - chunk * cw)))
        return scans

    first = band(0)
    for sc in first:
        sc.edge = torch.empty((sc.vol.shape[0], sc.width), dtype=dtype, device=sc.vol.device)
    sgm_ops.sgm_scan_table_plain(first, cfg.sgm_p1_eff, cfg.sgm_p2_eff)
    scans = band(1)
    for sc, prev in zip(scans, first):
        sc.init, sc.edge = prev.edge, torch.empty_like(prev.edge)
    return scans


def ext_row(name: str, what: str, scans, cfg, card_line: str) -> dict:
    """One kernels line row of the table kernel: run_case at the wrapper's
    block width, then the device time at each width the kernel is built
    for, with the ring depth, shared memory and blocks an SM each allows;
    ``row_walk_us``: the time a row of the walk (ms / rows)."""
    kernel, plain, nbytes, nops, plain_scans = table_case(scans, cfg)
    d, h = scans[0].vol.shape[:2]
    row = run_case("sgm_scan_ext", what, (kernel, plain, nbytes, nops), card_line,
                   check=table_check(scans, plain_scans))
    row.update(scans=len(scans), lines=ck.scan_table_lines([sc.width for sc in scans],
                                                           scans[0].vol.device),
               row_walk_us=row["ms"] / h * 1e3, widths={})
    dtype = scans[0].vol.dtype
    for lines in ck.SCAN_TABLE_LINES:
        ms, ms_from = device_ms(table_case(scans, cfg, lines)[0], "sgm_scan_ext")
        info = ck.scan_table_info(d, dtype, lines)
        blocks = sum(-(-sc.width // lines) for sc in scans)
        row["widths"][lines] = dict(ms=ms, ms_from=ms_from, blocks=blocks, **info)
        print(f"kernel {name} at {lines} columns a block: {ms:.4f} ms device ({ms_from}); "
              f"{blocks} blocks, ring of {info['ring']} stages, {info['smem_bytes']} B of shared "
              f"memory a block, {info['blocks_per_sm']} blocks an SM [{card_line}]")
    return row


def ext_kernel_rows(vols, images, cfg, n_row: int, frame: str, label: str,
                    card_line: str) -> dict:
    """Kernel C's table kernel on a frame's CBCA volumes, in float32 and
    bfloat16, against the plain table, at the shapes the banded frame
    launches it: the down order's chunk step (chunk 1 of band 1, every
    direction of the order for every volume), and one scan of it alone, the
    vertical one and (8 paths) the first diagonal, which takes the in-image
    mask. The sgm8_full frame's one-scan rows also give ``whole_band``: the
    same scan over its buffer's whole width from a random initial row, one
    launch where the wavefront makes ROW_BANDS_CHUNKS."""
    gen = torch.Generator(device=vols[0].device).manual_seed(1)
    dirs = BAND_ORDERS[0] if cfg.sgm_scan_num >= 8 else BAND_ORDERS[0][:1]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        suffix = "" if dtype == torch.float32 else "_bf16"
        scans = band_step(vols, images, cfg, n_row, dirs, 1, dtype)
        shapes = ", ".join(f"[1, {sc.vol.shape[0]}, {sc.vol.shape[1]}, {sc.width}]"
                           + (" masked" if sc.mask is not None else "") for sc in scans)
        name = f"sgm_scan_ext{frame}_step{suffix}"
        what = (f"chunk step of {label}'s band 1 down order, {len(scans)} scans "
                f"{shapes} {str(dtype)[6:]}, from band 0's boundary rows")
        rows[name] = ext_row(name, what, scans, cfg, card_line)
        # one scan alone: the first volume's vertical one and, with 8 paths, its first diagonal
        alone = {"": scans[0]}
        if len(dirs) > 1:
            alone["_mask"] = scans[len(vols)]
        for kind, sc in alone.items():
            name = f"sgm_scan_ext{frame}{kind}{suffix}"
            buf = "skewed diagonal buffer with its in-image mask" if kind else "band"
            what = (f"W chunk [1, {sc.vol.shape[0]}, {sc.vol.shape[1]}, {sc.width}] of band 1's "
                    f"{buf} {str(dtype)[6:]}, scanned down from band 0's boundary row")
            rows[name] = ext_row(name, what, [sc], cfg, card_line)
            rows[name]["within"] = f"sgm_scan_ext{frame}_step{suffix}"
            rows[name]["step_ms"] = rows[rows[name]["within"]]["ms"]
            if frame:
                continue
            init = (torch.rand((sc.vol.shape[0], sc.vol.shape[-1]), generator=gen,
                               device=sc.vol.device) * 4 + 0.5).to(dtype)
            whole = ck.ChunkScan(sc.vol, sc.pscale, sc.out, 0, sc.vol.shape[-1], sc.reverse,
                                 init, sc.mask)
            what = (f"whole {buf} {[1] + list(sc.vol.shape)} {str(dtype)[6:]}, from a random "
                    "initial row")
            kernel, plain, nbytes, nops, plain_scans = table_case([whole], cfg)
            res = run_case("sgm_scan_ext", what, (kernel, plain, nbytes, nops), card_line,
                           check=table_check([whole], plain_scans))
            rows[name]["whole_band"] = {k: res[k] for k in ("case", "ms", "ms_from", "plain_ms",
                                                            "bound_ms", "max_abs_err")}
        # the row walk's floor of the step: its rows at the one-scan walk's time a row
        step = rows[f"sgm_scan_ext{frame}_step{suffix}"]
        step["walk_floor_ms"] = rows[f"sgm_scan_ext{frame}{suffix}"]["ms"]
        del scans, alone
        torch.cuda.empty_cache()
    return rows


def sgm_multi_band_order(vol_list, img_list, num_directions: int = 4, p1: float = 1.0,
                         p2: float = 3.0, cor_dif_thres: int = 15, redu_coeff: float = 4.0):
    """``sgm_ops.sgm_multi`` with the directions summed in the row-band
    path's order (``sharded._sgm_sharded``): 0 + down + up + (the horizontal
    pair) + each diagonal, each direction from the dense kernels."""
    groups = [((-1, 0),), ((1, 0),), ((0, 1), (0, -1))]
    if num_directions >= 8:
        groups += [(d,) for d in DIAGONALS]
    outs = []
    for vol, img in zip(vol_list, img_list):
        out = torch.zeros_like(vol)
        for dirs in groups:
            out = out + sgm_ops.sgm_directions([vol], [img], dirs, p1, p2, cor_dif_thres,
                                               redu_coeff)[0]
        outs.append(out)
    return outs


def band_report(label: str, reports, card_line: str) -> None:
    """Each rank's wall time per frame, device time of the profiled frame,
    peak memory, launches, kernel C's table scans and communication."""
    for r in reports:
        comm = r["comm"]
        chunks, steps = comm["wavefront_chunks"], comm["wavefront_steps"]
        eff = f"{chunks[0]}/{steps[0]} = {chunks[0] / steps[0]:.3f}" if steps else "none"
        dev_ms = (f"{r['device_ms']:.3f} ms ({r['nccl_ms']:.3f} of it NCCL's kernels, waits "
                  "included)" if r["device_ms"] is not None else "not measured")
        launches = {k: v for k, v in r["launches"].items() if v}
        scans = {k: v for k, v in r["launches_scans"].items() if v}
        print(f"{label} rank {r['rank']} on {r['device']} ({r['backend']}): wall ms/frame "
              f"{', '.join(f'{t:.3f}' for t in r['wall_ms'])} (the last under the profiler); "
              f"device {dev_ms}; peak {r['peak_bytes'] / 2**20:.1f} MiB; launches "
              f"{json.dumps(launches)}; sgm_scan_ext scans {json.dumps(scans)}; halo "
              f"{comm['halo_exchanges']} exchanges {comm['halo_bytes']} B sent, wavefront "
              f"{comm['wavefront_scans']} scans of {eff} chunk steps, {comm['wavefront_bytes']} "
              f"B sent, all-gather {comm['all_gathers']}x {comm['all_gather_bytes']} B sent, "
              f"gather {comm['gather_bytes']} B, total {comm['total_bytes']} B [{card_line}]")
        for name, ms, n in r["top_kernels"]:
            print(f"{label} rank {r['rank']}:   {ms:9.3f} ms {n:6d}x  {name}")


def check_band_launches(label: str, reports, masked: bool) -> dict:
    """Every band scan along H went through kernel C's table kernel: on each
    rank its scans are the wavefront's chunks (one a chunk of a scan), with
    the in-image mask exactly when ``masked`` (the diagonals), in one launch
    a chunk step of each band order; plain kernel C ran only the
    band-local horizontal pair (one launch a direction, the volumes
    batched), kernel E never (the band path skews through C). Returns the
    launches and scans summed over the ranks."""
    total = collections.Counter()
    for r in reports:
        chunks = r["comm"]["wavefront_chunks"]
        scans = r["launches_scans"]
        steps = 2 * max(chunks)          # the down order's chunk steps, then the up order's
        ok = (sum(chunks) == scans["sgm_scan_ext"] + scans["sgm_scan_ext_mask"]
              and bool(scans["sgm_scan_ext_mask"]) == masked
              and r["launches"]["sgm_scan_ext"] == steps and r["launches"]["sgm_scan"] == 2
              and not r["launches"]["sgm_diag"] and not r["launches_bf16"]["sgm_scan_ext"])
        print(f"{label} rank {r['rank']}: sgm_scan_ext {r['launches']['sgm_scan_ext']} launches "
              f"(one a chunk step: {steps}) of {sum(scans.values())} scans ({json.dumps(scans)}; "
              f"wavefront chunks {sum(chunks)}), plain sgm_scan {r['launches']['sgm_scan']}, "
              f"sgm_diag {r['launches']['sgm_diag']}")
        if not ok:
            raise AssertionError(f"{label} rank {r['rank']}: not every band scan went through "
                                 f"sgm_scan_ext, one launch a chunk step")
        total.update(launches=r["launches"]["sgm_scan_ext"], scans=sum(scans.values()),
                     masked=scans["sgm_scan_ext_mask"])
    print(f"{label}: sgm_scan_ext {total['launches']} launches of {total['scans']} scans "
          f"({total['masked']} masked) over {len(reports)} ranks")
    return dict(total)


def frame_ext_rows(left, right, cfg, n_row: int, frame: str, label: str,
                   card_line: str) -> dict:
    """:func:`ext_kernel_rows` on the frame's CBCA volumes as the band path
    scans them (both views where it keeps both)."""
    vols, _ = compute_volumes(left, right, cfg)
    rows = ext_kernel_rows([vols[k] for k in sorted(vols)], [(left, right)[k] for k in
                                                              sorted(vols)],
                           cfg, n_row, frame, label, card_line)
    del vols
    torch.cuda.empty_cache()
    return rows


def phase_row_bands(dev, card_line: str):
    """The row-band pipeline at full width. Returns the kernels line's rows
    of sgm_scan_ext and, for each, the launches and scans of its frame
    (banded sgm8_full, or frame A over 4 bands) summed over the ranks, 0
    for the bfloat16 rows."""
    torch.cuda.empty_cache()
    pair = make_synthetic_pair(**SGM8)
    left = torch.from_numpy(pair.left).to(dev, torch.float32)
    right = torch.from_numpy(pair.right).to(dev, torch.float32)
    cfg = get_model("sgm8_full", max_disp=SGM8["max_disp"])
    label = f"row bands sgm8_full {SGM8['h']}x{SGM8['w']} D={cfg.num_disp}"
    print(f"{label}: cost halo {_cost_halo(cfg)} rows, bands of "
          f"{SGM8['h'] // ROW_BANDS_SGM8} rows")
    rows = frame_ext_rows(left, right, cfg, ROW_BANDS_SGM8, "", "sgm8_full", card_line)

    # the dense references on this card, in the dense sum's order and in
    # the band path's
    cfg_raw = cfg.replace(do_refine=False, sub_ipol=False)
    cfg_int = cfg.replace(do_subpixel=False, sub_ipol=False)
    dense, band_order = {}, {}
    for key, c in (("raw", cfg_raw), ("int", cfg_int), ("float", cfg)):
        pipe = StereoPipeline(c, device=dev)
        dense[key] = pipe(left, right)["disparity"]
        with mock.patch.object(sgm_ops, "sgm_multi", sgm_multi_band_order):
            band_order[key] = pipe(left, right)["disparity"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    devices, backend = row_band_devices(ROW_BANDS_SGM8)
    print(f"{label}: {ROW_BANDS_SGM8} ranks on {devices} over {backend}")
    pipe_args = (pair.left[None], pair.right[None])
    Job = band_harness.Job
    jobs = [Job(band_pipeline, pipe_args + (cfg, ROW_BANDS_CHUNKS), row_axis=1, batch_axis=0,
                frames=ROW_BANDS_FRAMES, profile=True),
            Job(band_pipeline, pipe_args + (cfg_int, ROW_BANDS_CHUNKS), row_axis=1,
                batch_axis=0),
            Job(band_pipeline, pipe_args + (cfg_raw, ROW_BANDS_CHUNKS), row_axis=1,
                batch_axis=0)]
    directions = [(-1, 0), (1, 1), (-1, -1)]
    jobs += [Job(direction_band, (pair.left, pair.right, cfg, ROW_BANDS_CHUNKS, d),
                 row_axis=1, finish=direction_dense) for d in directions]
    t0 = time.perf_counter()
    (band_float, reports), (band_int, _), (band_raw, _), *dirs = band_harness.run_jobs(
        jobs, ROW_BANDS_SGM8, devices=devices, backend=backend)
    print(f"{label}: {len(jobs)} jobs over {ROW_BANDS_SGM8} ranks in "
          f"{time.perf_counter() - t0:.3f} s, processes included")
    band_report(label, reports, card_line)
    path = {"": check_band_launches(label, reports, masked=True)}
    for d, (res, _) in zip(directions, dirs):
        print(f"{label}: direction {d} over {ROW_BANDS_SGM8} bands vs dense kernel "
              f"{res['dense']}: equal {res['equal']} (max |err| {res['max_abs_err']})")
        if not res["equal"]:
            raise AssertionError(f"{label}: direction {d} differs from the dense kernel's")

    banded = {"raw": band_raw, "int": band_int, "float": band_float}
    for key, got in banded.items():
        got = banded[key] = torch.from_numpy(got[0]).to(dev)
        same = torch.equal(got, band_order[key])
        print(f"{label}: {key} map equal to the dense one summed in the band order: {same}; "
              f"differs from the dense one at {int((got != dense[key]).sum())} px")
        if not same:
            raise AssertionError(f"{label}: the {key} map differs from the dense pipeline's "
                                 "with the band path's direction sum")
    diff = (banded["float"] - dense["float"]).abs()
    n_over, err = int((diff > FLOAT_TOL).sum()), float(diff.max())
    print(f"{label}: float map against the dense one: max |diff| {err}, {n_over} px beyond "
          f"{FLOAT_TOL} (limits {FLOAT_PX} px, {FLOAT_MAX})")
    if n_over > FLOAT_PX or err >= FLOAT_MAX:
        raise AssertionError(f"{label}: the float map strays from the dense one: {n_over} px "
                             f"beyond {FLOAT_TOL}, max {err}")
    del left, right, dense, band_order, banded, diff
    torch.cuda.empty_cache()

    # fullres_occfill frame A over 4 bands: the map through the entry
    # point, then the measured frames
    params, overrides = OCCFILL["A"]
    pair = make_synthetic_pair(**params)
    cfg = get_model("fullres_occfill", max_disp=params["max_disp"], **overrides)
    label = f"row bands fullres_occfill A {params['h']}x{params['w']} D={cfg.num_disp}"
    left = torch.from_numpy(pair.left).to(dev, torch.float32)
    right = torch.from_numpy(pair.right).to(dev, torch.float32)
    rows.update(frame_ext_rows(left, right, cfg, ROW_BANDS_OCCFILL, "_frame_a",
                               "fullres_occfill frame A", card_line))
    del left, right
    dense = StereoPipeline(cfg, device=dev)(pair.left, pair.right)["disparity"].cpu()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    devices, backend = row_band_devices(ROW_BANDS_OCCFILL)
    print(f"{label}: {ROW_BANDS_OCCFILL} ranks on {devices} over {backend}; cost halo "
          f"{_cost_halo(cfg)} rows, bands of {params['h'] // ROW_BANDS_OCCFILL} rows")
    t0 = time.perf_counter()
    disp = run_row_bands(pair.left, pair.right, cfg, n_row=ROW_BANDS_OCCFILL,
                         n_chunks=ROW_BANDS_CHUNKS, devices=devices, backend=backend)
    print(f"{label}: run_row_bands in {time.perf_counter() - t0:.3f} s, processes included")
    n_diff = int((disp != dense).sum())
    print(f"{label}: banded map differs from the dense one at {n_diff} px (budget 0)")
    if n_diff:
        raise AssertionError(f"{label}: the banded map differs at {n_diff} px")
    job = band_harness.Job(band_pipeline, (pair.left[None], pair.right[None], cfg,
                                           ROW_BANDS_CHUNKS), row_axis=1, batch_axis=0,
                           frames=ROW_BANDS_FRAMES, profile=True)
    [(again, reports)] = band_harness.run_jobs([job], ROW_BANDS_OCCFILL, devices=devices,
                                               backend=backend)
    band_report(label, reports, card_line)
    path["_frame_a"] = check_band_launches(label, reports, masked=False)
    if not torch.equal(torch.from_numpy(again[0]), disp):
        raise AssertionError(f"{label}: the measured frames' map differs from run_row_bands'")

    row_bands_disp(dev, card_line)
    # the path launches the table only as chunk steps: a one-scan row is
    # launched within its frame's step row, and counts none of its own
    counts = {}
    for row in rows:
        frame = "_frame_a" if row.startswith("sgm_scan_ext_frame_a") else ""
        on_path = "within" not in rows[row] and not row.endswith("_bf16")
        counts[row] = path[frame]["launches"] if on_path else 0
        rows[row]["path_scans"] = path[frame]["scans"] if on_path else 0
    return rows, counts


def row_bands_disp(dev, card_line: str) -> None:
    """Frame A over 2 bands x 2 disparity blocks: each rank builds the cost
    and CBCA of its 96 disparities and an all-gather over its 'disp' group
    rebuilds the band's volume. The map through run_row_bands, then the
    measured frames, each equal to the dense map."""
    params, overrides = OCCFILL["A"]
    pair = make_synthetic_pair(**params)
    cfg = get_model("fullres_occfill", max_disp=params["max_disp"], **overrides)
    dense = StereoPipeline(cfg, device=dev)(pair.left, pair.right)["disparity"].cpu()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_row, n_disp = ROW_BANDS_DISP
    devices, backend = row_band_devices(n_row * n_disp)
    label = (f"row bands x disp fullres_occfill A {params['h']}x{params['w']} "
             f"D={cfg.num_disp} n_row={n_row} n_disp={n_disp}")
    print(f"{label}: {n_row * n_disp} ranks on {devices} over {backend}")
    t0 = time.perf_counter()
    disp = run_row_bands(pair.left, pair.right, cfg, n_row=n_row, n_disp=n_disp,
                         n_chunks=ROW_BANDS_CHUNKS, devices=devices, backend=backend)
    print(f"{label}: run_row_bands in {time.perf_counter() - t0:.3f} s, processes included")
    n_diff = int((disp != dense).sum())
    print(f"{label}: map differs from the dense one at {n_diff} px (budget 0)")
    if n_diff:
        raise AssertionError(f"{label}: the map differs at {n_diff} px")
    job = band_harness.Job(band_pipeline, (pair.left[None], pair.right[None], cfg,
                                           ROW_BANDS_CHUNKS), row_axis=1, batch_axis=0,
                           frames=ROW_BANDS_FRAMES, profile=True)
    [(again, reports)] = band_harness.run_jobs([job], n_row, devices=devices, backend=backend,
                                               n_disp=n_disp)
    band_report(label, reports, card_line)
    check_band_launches(label, reports, masked=False)
    if any(r["comm"]["all_gathers"] != 2 for r in reports):
        raise AssertionError(f"{label}: a rank did not all-gather its two volumes")
    if not torch.equal(torch.from_numpy(again[0]), disp):
        raise AssertionError(f"{label}: the measured frames' map differs from run_row_bands'")


def checked_frame(label: str, cfg, want: dict, left, right, dev, card_line: str,
                  on_cpu=None, crop=None, time_plain: bool = True):
    """One frame of ``cfg`` with the launch counts set to 0 just before it:
    exactly the kernels of ``kernels_launched``, each as many times as
    ``want`` says; its maps finite, of the frame's shape, and equal to the
    plain path's on the card; with ``on_cpu`` not None the pixels differing
    from the CPU port's maps printed (on the top-left ``crop``, the card
    running the crop too, where given), and required to be none where
    ``on_cpu`` is true, with the CPU frame's host seconds; the median ms of
    ``PRESET_REPS`` frames on the kernel path (and the plain path with
    ``time_plain``), and the kernel path's peak device memory above what was
    held before the frame (earlier phases leave tensors alive). Returns (its
    launches, its maps)."""
    pipe = StereoPipeline(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    ck.reset_launches()
    out = pipe(left, right)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ck.launches.items() if n}
    peak = torch.cuda.max_memory_allocated(dev) - held
    if list(counts) != kernels_launched(cfg) or counts != want:
        raise AssertionError(f"{label}: launched {counts}, not {want} "
                             f"(kernels_launched {kernels_launched(cfg)})")
    for key, d in out.items():
        want_dtype = torch.float32 if key == "disparity" else torch.int32
        if d.shape != left.shape[:2] or d.dtype != want_dtype or not bool(torch.isfinite(d).all()):
            raise AssertionError(f"{label} {key}: {d.dtype}{tuple(d.shape)}, or not finite")
    with plain_path():
        equal_maps(label, out, pipe(left, right), "the plain path on the card")
    cpu = ""
    if on_cpu is not None:
        l_cpu, r_cpu, got = left.cpu(), right.cpu(), out
        if crop:
            l_cpu, r_cpu = l_cpu[:crop[0], :crop[1]], r_cpu[:crop[0], :crop[1]]
            got = pipe(l_cpu, r_cpu)
        t0 = time.perf_counter()
        ref = StereoPipeline(cfg, device="cpu")(l_cpu, r_cpu)
        off = {k: int((got[k].cpu() != ref[k]).sum()) for k in ref}
        where = f" on the top-left {crop[0]}x{crop[1]} crop" if crop else ""
        cpu = (f"; pixels differing from the CPU port{where} {json.dumps(off)}"
               f"{' (0 required)' if on_cpu else ''}, its frame "
               f"{time.perf_counter() - t0:.1f} s on the host")
        if on_cpu and any(off.values()):
            raise AssertionError(f"{label}: the card's maps differ from the CPU port's: {off}")
    times = {}
    for path, ctx in (("kernel", contextlib.nullcontext), ("plain", plain_path))[:1 + time_plain]:
        with ctx():
            times[path] = frame_ms(pipe, left, right, PRESET_REPS, warm_up=False)[1]
    print(f"{label}: launches a frame {json.dumps(counts)} (exactly kernels_launched); "
          f"maps equal to the plain path on the card{cpu}; median of {PRESET_REPS} frames: "
          + ", ".join(f"{path} path {ms:.3f} ms/frame" for path, ms in times.items())
          + f"; peak device memory {peak / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB "
          f"held before the frame [{card_line}]")
    return counts, out


def preset_frame(name: str, left, right, dev, card_line: str) -> dict:
    """One frame of preset ``name`` at Teddy size (:func:`checked_frame`):
    its launches ``PRESET_FRAMES[name]``, held against the CPU port where
    ``PRESETS_ON_CPU`` says, on the crop of ``CPU_CROPS``. Returns its
    launches."""
    cfg = get_model(name, max_disp=TEDDY["max_disp"])
    return checked_frame(f"preset {name} {TEDDY['h']}x{TEDDY['w']} D={cfg.num_disp}", cfg,
                         PRESET_FRAMES[name], left, right, dev, card_line,
                         on_cpu=PRESETS_ON_CPU.get(name), crop=CPU_CROPS.get(name))[0]


def window1_arm_taps(left, right, card_line: str) -> None:
    """Kernel B's four launch kinds of a CBCA pass on cbca_double's left raw
    volume at both of its windows: the large one (``cfg.window1()``,
    max_arm 23) and the small one (max_arm 34), each against its plain
    version, in turns (34, 23, 23, 34), and the ratio of their device
    times."""
    cfg = get_model("cbca_double", max_disp=TEDDY["max_disp"])
    w1 = cfg.window1()
    vol, arms_int = frame_cbca_inputs(left, right, cfg)
    arms1 = [arms_ops.build_arms(img, w1) for img in (left, right)]
    windows = {cfg.arm_l_out: arms_int,
               w1.arm_l_out: arms_ops.intersect_arms(arms1[0], arms1[1], cfg.num_disp, 0)}
    ms = collections.defaultdict(list)
    for m in (cfg.arm_l_out, w1.arm_l_out, w1.arm_l_out, cfg.arm_l_out):
        row = run_case("arm_taps", f"cbca_double {TEDDY['h']}x{TEDDY['w']} D={cfg.num_disp}: "
                       f"the four launch kinds of a CBCA pass at max_arm {m} on its left raw "
                       f"volume {list(vol.shape)}", combined([case for _, case in cbca_kinds(
                           vol, windows[m], m)]), card_line)
        ms[m].append(row["ms"])
    small, large = (float(np.mean(ms[m])) for m in (cfg.arm_l_out, w1.arm_l_out))
    print(f"kernel B on cbca_double's volume: max_arm {w1.arm_l_out} {large:.4f} ms, max_arm "
          f"{cfg.arm_l_out} {small:.4f} ms for the four kinds (means of 2 turns), ratio "
          f"{large / small:.3f} [{card_line}]")


def phase_presets(dev, card_line: str) -> None:
    """The presets of the box and guided filters, vmTop, double-window CBCA,
    AWS, FIF, SO and GFNL (``census_cbca_vmtop``, ``cbca_double``,
    ``ad_grad_gf``, ``zncc_bf_wta``, ``aws_wta``, ``census_fif_sgm``,
    ``bt_so``, ``gfnl_wta``) beside the default one, each a :func:`preset_frame` on
    ``make_synthetic_pair(seed=0)`` at 375x450, D=60; then the default
    preset on the committed ``photo_small`` pair against the reference
    binary's goldens at 0/0 px; then kernel B at both of cbca_double's
    windows on the same volume (:func:`window1_arm_taps`)."""
    pair = make_synthetic_pair(**TEDDY)
    left = torch.from_numpy(pair.left).to(dev, torch.float32)
    right = torch.from_numpy(pair.right).to(dev, torch.float32)
    counts = {name: preset_frame(name, left, right, dev, card_line) for name in PRESET_FRAMES}
    base = counts["census_grad_cbca_sgm"]
    if any(counts["cbca_double"].get(k) != 2 * base.get(k, -1) for k in ("arms_grow", "arm_taps")) \
            or "wta" in counts["census_cbca_vmtop"] or "wta" in counts["bt_so"] \
            or "sgm_scan" in counts["bt_so"]:
        raise AssertionError(f"launches against the default frame's: {json.dumps(counts)}")
    photo = load_photo_pair("photo_small")
    cfg = get_model("census_grad_cbca_sgm", max_disp=photo.max_disp)
    out = StereoPipeline(cfg, device=dev)(photo.left, photo.right)
    n_wta = int((out["disp_left_raw"].cpu().numpy()
                 != load_ref_disp(os.path.join(GOLDEN, "photo_small_wta.bin"))).sum())
    final = torch.round(out["disparity"]).to(torch.int32).cpu().numpy()
    n_final = int((final != load_ref_disp(os.path.join(GOLDEN, "photo_small_final.bin"))).sum())
    m = photo.masks["nonocc"]
    bad1 = float((((np.abs(final - photo.gt) > 1) | (final < 0)) & m).sum() / m.sum())
    print(f"photo_small (committed pair) default preset on the card: WTA differs from the "
          f"reference binary at {n_wta} px, the refined map at {n_final} px (budgets 0, 0); "
          f"bad-1.0 nonocc {bad1:.6f}")
    if n_wta or n_final or bad1 < 0.01:
        raise AssertionError(f"photo_small: {n_wta} / {n_final} px off the goldens, bad-1.0 "
                             f"{bad1}")
    window1_arm_taps(left, right, card_line)
    torch.cuda.empty_cache()


# ROADMAP §1 item 5 on the default preset at Teddy size, the default frame
# first for its times and memory in the same run: frame -> (overrides,
# whether the card's maps on the CPU crop must equal the CPU port's: those
# without an exp, and the arm modes and the pyramid on censusGrad, whose
# only exp is the default's; the others' count of differing pixels is
# printed)
ITEM5 = {
    "default": (dict(), True),
    "ad": (dict(cost="ad"), True),
    "sd": (dict(cost="sd"), True),
    "grad": (dict(cost="grad"), True),
    "grad_1dir_norm": (dict(cost="grad", grad_use_2dir=False, is_grad_norm=True), True),
    "ssd": (dict(cost="ssd"), True),
    "census_from2": (dict(cost="census_from2"), False),
    "census_from2_first": (dict(cost="census_from2", census_from2_blend="first"), False),
    "ad_census_grad": (dict(cost="ad_census_grad"), False),
    "ad_census_zncc": (dict(cost="ad_census_zncc"), False),
    "multilevel": (dict(cbca_arm_mode="multilevel"), True),
    "adaptive": (dict(cbca_arm_mode="adaptive"), True),
    "pyramid2": (dict(pyramid_levels=2), True),
    "pyramid3": (dict(pyramid_levels=3), True),
    # 15 divides D=60 (16 does not): four blocks
    "ad_census_grad_streamed": (dict(cost="ad_census_grad", d_stream_block=15), False),
}
# each frame's launches: the default frame's, with A and B once a pyramid
# level and B once a streamed block
ITEM5_FRAMES = {name: dict(DEFAULT_FRAME) for name in ITEM5}
for _levels in (2, 3):
    ITEM5_FRAMES[f"pyramid{_levels}"].update(arms_grow=2 * _levels, arm_taps=8 * _levels)
ITEM5_FRAMES["ad_census_grad_streamed"]["arm_taps"] = 8 * 4
ITEM5_CROP = (96, 128)
ARM_MODES = ("two_level", "multilevel", "adaptive")


def item5_frame(name: str, left, right, dev, card_line: str):
    """One frame of ``ITEM5[name]`` (:func:`checked_frame`, the kernel path
    timed), held against the CPU port on the ``ITEM5_CROP`` crop. Returns
    (its launches, its maps)."""
    overrides, exact_on_cpu = ITEM5[name]
    cfg = get_model("census_grad_cbca_sgm", max_disp=TEDDY["max_disp"], **overrides)
    return checked_frame(f"item 5 {name} {TEDDY['h']}x{TEDDY['w']} D={cfg.num_disp}", cfg,
                         ITEM5_FRAMES[name], left, right, dev, card_line, on_cpu=exact_on_cpu,
                         crop=ITEM5_CROP, time_plain=False)


def arm_mode_rows(left, card_line: str) -> dict:
    """Kernel A under each schedule of ``ARM_MODES`` on the Teddy image and
    on a blocky 1988x2880 one (24-px flat blocks: long arms), against its
    plain version, with the steps its walk takes and its bound at
    ``COPY_BYTES_PER_S`` too; returns the Teddy rows of the new schedules."""
    from tools.sgm_layouts import COPY_BYTES_PER_S

    images = {"teddy": (f"one {TEDDY['h']}x{TEDDY['w']} image", left),
              "blocky": ("one blocky 1988x2880 image",
                         torch.from_numpy(fullres_image(np.random.default_rng(1))).to(left.device))}
    rows = {}
    for where, (what, img) in images.items():
        for mode in ARM_MODES:
            cfg = default_config(cbca_arm_mode=mode)
            arms = arms_ops.build_arms(img, cfg)
            case = arms_grow_case(img, arms, cfg)
            row = run_case("arms_grow", f"{what}, {mode} schedule ({cfg.arm_l_out} steps; mean "
                           f"arm {float(arms.float().mean()):.3f}, {case[3] // 18:,} steps "
                           "walked)", case, card_line)
            row["bound_copy_ms"] = case[2] / COPY_BYTES_PER_S * 1e3
            print(f"  bound at COPY_BYTES_PER_S {COPY_BYTES_PER_S / 1e12:.4f} TB/s: "
                  f"{row['bound_copy_ms']:.4f} ms, {row['bound_copy_ms'] / row['ms']:.3f} of it")
            if where == "teddy" and mode != "two_level":
                rows[f"arms_grow_{mode}"] = row
    return rows


def phase_item5(dev, card_line: str):
    """ROADMAP §1 item 5 (see the module's docstring, phase 16): each
    ``ITEM5`` frame (:func:`item5_frame`), the streamed frame's maps equal
    to the dense one's, then kernel A's schedules (:func:`arm_mode_rows`).
    Returns (A's rows, each arm mode's frame launches)."""
    pair = make_synthetic_pair(**TEDDY)
    left = torch.from_numpy(pair.left).to(dev, torch.float32)
    right = torch.from_numpy(pair.right).to(dev, torch.float32)
    counts, maps = {}, {}
    for name in ITEM5:
        counts[name], maps[name] = item5_frame(name, left, right, dev, card_line)
    equal_maps("ad_census_grad streamed in blocks of 15", maps["ad_census_grad_streamed"],
               maps["ad_census_grad"], "its dense frame")
    print("item 5: ad_census_grad streamed in blocks of 15 equals its dense frame")
    del maps
    rows = arm_mode_rows(left, card_line)
    torch.cuda.empty_cache()
    return rows, {f"arms_grow_{mode}": counts[mode]["arms_grow"]
                  for mode in ARM_MODES if mode != "two_level"}


# ROADMAP §1 item 6, the refinement variants, on the default preset at Teddy
# size: configuration -> its overrides. Between them they turn on every
# item-6 flag: (a) the classifying LR check (so that OCC and MIS reach the
# fill policy), the census border fill, PKR, RV_combine_BG (OCC to min(vote,
# fill), the gated HV/tilted vote, the four-direction fill), the KITTI fill,
# the whole-image vote and double-window CBCA merged by PKR's blend; (b) the
# histogram region vote, CBBI, WM, DA and the last median
ITEM6 = {
    "a": dict(lrc_classify=True, do_fill_surrounding=True, do_pkr=True, rv_use_combine_bg=True,
              interpolate_type=3, reg_vote_type=2, bg_ip_dir=4, do_bg_ipol=True,
              bg_ipol_kitti=True, do_rv_whole_image=True, cbca_double_win=True,
              cbca_combine=1),
    "b": dict(rv_int_ratio_quirk=False, do_cbbi=True, do_wm=True, do_da=True,
              do_last_median=True),
}
# each one's launches a frame: (a) A and B twice the default's (two windows),
# arm_reduce twice a histogram vote (the gated vote's HV half in each of the
# two RV_combine_BG passes, and the whole-image vote), no region_vote; (b)
# arm_reduce twice a histogram pass, two passes; the tilted arms, CBBI, WM and
# DA are plain torch
ITEM6_FRAMES = {
    "a": {"arms_grow": 4, "arm_taps": 16, "sgm_scan": 4, "wta": 2, "arm_reduce": 6,
          "pi_scan": 2},
    "b": {"arms_grow": 2, "arm_taps": 8, "sgm_scan": 4, "wta": 2, "arm_reduce": 4,
          "pi_scan": 2},
}
ITEM6_CROP = (96, 128)
ITEM6_STACK_ARM = 34  # the seeded frame-C stack's longest arm (max_arm)


def hist_vote_case(stack, arms0, m):
    """The histogram vote's sums of a [D + 1, H, W] one-hot stack, as the
    vote calls ``arm_reduce``: along W with the left/right arms, then along
    H with the up/down arms, as (kernel, plain, bytes, operations). Each
    pass reads the stack and its two [H, W] arm planes and writes its
    output once; one add a tap."""
    left, right, up, down = (a.contiguous() for a in arms0[:4].unbind(0))

    def run(fn):
        return fn(fn(stack, left, right, 2, m, "sum"), up, down, 1, m, "sum")

    c = stack.shape[0]
    per_pass = 2 * stack.numel() * 4 + 2 * left.numel() * 4
    nops = c * (taps(left, right, 1, m) + taps(up, down, 0, m))
    return (lambda: run(ck.arm_reduce), lambda: run(arms_ops.arm_bounded_reduce_plain),
            2 * per_pass, nops)


def item6_stack_rows(left, out, cfg, counts, card_line: str) -> dict:
    """arm_reduce's sum against its plain version on the histogram stack of
    configuration (b)'s first vote (its LR map, [61, 375, 450]) and on a
    seeded [257, 1988, 2880] stack with arms up to 34, each a kernels line
    row, its bound by bytes (a pass: the stack read and written once and two
    arm planes; 83.7 MB and 11.82 GB)."""
    rows = {}
    lrc = refine_ops.lr_consistency(out["disp_left_raw"], out["disp_right_raw"],
                                    cfg.lr_max_diff)
    stack = refine_ops.vote_stack(lrc, cfg.num_disp)
    arms0 = arms_ops.build_arms(left, cfg)
    rows["arm_reduce_hist"] = run_case(
        "arm_reduce", f"item 6 (b) {TEDDY['h']}x{TEDDY['w']} D={cfg.num_disp}: the histogram "
        f"vote's two sum passes on its first vote's stack {list(stack.shape)} (a frame "
        f"launches it {counts['arm_reduce']} times)",
        hist_vote_case(stack, arms0, cfg.arm_l_out), card_line)
    del stack
    gen = torch.Generator(device=left.device).manual_seed(0)
    h, w = FULLRES
    disp = torch.randint(-1, 256, (h, w), generator=gen, device=left.device, dtype=torch.int32)
    arms_c = torch.randint(0, ITEM6_STACK_ARM + 1, (4, h, w), generator=gen,
                           device=left.device, dtype=torch.int32)
    stack = refine_ops.vote_stack(disp, 256)
    rows["arm_reduce_hist_frame_c"] = run_case(
        "arm_reduce", f"the histogram vote's two sum passes on a seeded {list(stack.shape)} "
        f"stack (frame C's shape, D=256, arms up to {ITEM6_STACK_ARM}; no frame of this "
        "script runs a histogram vote at this shape)",
        hist_vote_case(stack, arms_c, ITEM6_STACK_ARM), card_line)
    del stack, disp, arms_c
    for name in ("arm_reduce_hist", "arm_reduce_hist_frame_c"):
        row = rows[name]
        print(f"  {name}: a pass {row['ms'] / 2:.4f} ms device against its byte bound "
              f"{row['bound_ms'] / 2:.4f} ms [{card_line}]")
    torch.cuda.empty_cache()
    return rows


def phase_item6(dev, card_line: str):
    """ROADMAP §1 item 6 (see the module's docstring, phase 17): each
    ``ITEM6`` frame (:func:`checked_frame`: the launches of ``ITEM6_FRAMES``,
    the maps equal to the plain path's and, on the ``ITEM6_CROP`` crop, to
    the CPU port's), then arm_reduce on the histogram stacks
    (:func:`item6_stack_rows`). Returns (its rows, (b)'s frame launches)."""
    pair = make_synthetic_pair(**TEDDY)
    left = torch.from_numpy(pair.left).to(dev, torch.float32)
    right = torch.from_numpy(pair.right).to(dev, torch.float32)
    counts, maps = {}, {}
    for name, overrides in ITEM6.items():
        cfg = get_model("census_grad_cbca_sgm", max_disp=TEDDY["max_disp"], **overrides)
        counts[name], maps[name] = checked_frame(
            f"item 6 ({name}) {TEDDY['h']}x{TEDDY['w']} D={cfg.num_disp}", cfg,
            ITEM6_FRAMES[name], left, right, dev, card_line, on_cpu=True, crop=ITEM6_CROP,
            time_plain=False)
    cfg_b = get_model("census_grad_cbca_sgm", max_disp=TEDDY["max_disp"], **ITEM6["b"])
    rows = item6_stack_rows(left, maps["b"], cfg_b, counts["b"], card_line)
    del maps
    torch.cuda.empty_cache()
    return rows, counts["b"]


def timed(phase, *args):
    t0 = time.perf_counter()
    result = phase(*args)
    print(f"{phase.__name__}: {time.perf_counter() - t0:.3f} s")
    return result


def main() -> int:
    from tools import micro4, sgm_layouts, taps_probes

    card_line = card() if torch.cuda.is_available() else "no card"
    phase_environment(card_line)
    dev = torch.device("cuda", 0)
    build_log = timed(phase_build)
    rows = timed(phase_kernels, dev, card_line)
    counts = timed(phase_slice, dev)
    # the rows and launches of kernels B, C and E are those of the sgm8_full
    # frame at full width (the Teddy rows are printed by phase_kernels)
    sgm_rows, sgm8_counts = timed(phase_sgm8, dev, card_line)
    for name in sgm_rows:
        rows[name], counts[name] = sgm_rows[name], sgm8_counts[name]
    bf16_rows, bf16_counts = timed(phase_occfill, dev, card_line)
    stream_rows, stream_counts = timed(phase_stream, dev, card_line)
    ext_rows, ext_counts = timed(phase_row_bands, dev, card_line)
    copy_row = timed(phase_copy_bw, dev, card_line)
    nl_rows, nl_counts = timed(phase_nl, dev, card_line)
    probe_rows = timed(phase_micro4, dev, card_line)
    census_rows, census_counts = timed(phase_census, dev, card_line)
    layout_rows = timed(phase_sgm_layouts, dev, card_line, build_log)
    taps_rows = timed(phase_taps_probes, dev, card_line, build_log)
    timed(phase_presets, dev, card_line)
    arm_rows, arm_counts = timed(phase_item5, dev, card_line)
    hist_rows, item6_counts = timed(phase_item6, dev, card_line)
    timed(phase_timing, dev, card_line)
    timed(phase_profile, dev, card_line)
    kernels = [dict(name=name, route="cuda", source=src, replaces=tpu,
                    launches=counts[name], **rows[name])
               for name, (src, tpu) in KERNELS.items()]
    # the bfloat16 instances, with frame B's launches (kernel E runs on no
    # 4-path frame: its row has 0)
    kernels += [dict(name=row, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
                     launches=bf16_counts[name], **bf16_rows[row])
                for row, name in BF16_ROWS.items()]
    # kernel C's table kernel, with its banded frame's launches summed over
    # the ranks (no banded path runs bfloat16 volumes)
    kernels += [dict(name=row, route="cuda", source=KERNELS["sgm_scan"][0], replaces=tpu,
                     launches=ext_counts[row], **ext_rows[row])
                for row, tpu in EXT_ROWS.items()]
    # frame C's kernels at its shapes, with the streamed frame's launches
    kernels += [dict(name=row, route="cuda", source=KERNELS[name][0], replaces=tpu,
                     launches=stream_counts[name], **stream_rows[row])
                for row, (name, tpu) in FRAME_C_ROWS.items()]
    # arm_reduce and the copy-bandwidth probe, on no frame's path: the main
    # path's counts
    if counts["arm_reduce"]:
        raise AssertionError(f"arm_reduce launched {counts['arm_reduce']} times on the main path")
    if counts["copy_bw"]:
        raise AssertionError(f"copy_bw launched {counts['copy_bw']} times on the main path")
    kernels.append(dict(name="copy_bw", route="cuda", source=COPY_BW[0], replaces=COPY_BW[1],
                        launches=counts["copy_bw"], **copy_row))
    # A, D, arm_reduce, region_vote and pi_scan at the nl_tree_filter frame's
    # shapes, with its launches
    kernels += [dict(name=row, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
                     launches=nl_counts[name], **nl_rows[row])
                for row, name in NL_ROWS.items()]
    # the gather and prefix-sum probes, on no path: the main path's counts, and
    # the NL frame's, must be 0
    for name, (tpu, _, _) in micro4.PROBES.items():
        if counts[name] or nl_counts[name]:
            raise AssertionError(f"{name} launched on the main path or the NL frame")
        kernels += [dict(name=row, route="cuda", source=PLANE_PROBES, replaces=tpu,
                         launches=counts[name], **probe_rows[row])
                    for row in (name, f"{name}_nl")]
    # A, B, D and region_vote at census_cbca_lrc's shapes, with its launches
    kernels += [dict(name=row, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
                     launches=census_counts[name], **census_rows[row])
                for row, name in CENSUS_ROWS.items()]
    # the SGM-layout probes, on no path: the main path's counts, and the
    # census frame's, must be 0
    for (entry, kind), tpu in sgm_layouts.PROBES.items():
        if counts[entry] or census_counts[entry]:
            raise AssertionError(f"{entry} launched on the main path or the census frame")
        kernels += [dict(name=f"{entry}_{kind}{suffix}", route="cuda", source=SGM_PROBES,
                         replaces=tpu, launches=counts[entry],
                         **layout_rows[f"{entry}_{kind}{suffix}"])
                    for suffix in sgm_layouts.SHAPES]
    # the taps probes, on no path: the main path's counts, and the census
    # frame's, must be 0
    for name in taps_probes.ROWS:
        entry, tpu = taps_probes.CASES[name][0], taps_probes.CASES[name][-1]
        if counts[entry] or census_counts[entry]:
            raise AssertionError(f"{entry} launched on the main path or the census frame")
        kernels.append(dict(name=name, route="cuda", source=TAPS_PROBES, replaces=tpu,
                            launches=counts[entry], **taps_rows[name]))
    # kernel A on the multilevel and adaptive schedules, with the launches of
    # that arm mode's Teddy frame
    kernels += [dict(name=row, route="cuda", source=KERNELS["arms_grow"][0],
                     replaces=KERNELS["arms_grow"][1], launches=arm_counts[row], **arm_rows[row])
                for row in arm_rows]
    # arm_reduce on the histogram vote's stacks: configuration (b)'s frame
    # launches it at Teddy size; no frame of this script runs it at frame C's
    kernels += [dict(name=row, route="cuda", source=KERNELS["arm_reduce"][0],
                     replaces=KERNELS["arm_reduce"][1],
                     launches=item6_counts["arm_reduce"] if row == "arm_reduce_hist" else 0,
                     **hist_rows[row])
                for row in hist_rows]
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
