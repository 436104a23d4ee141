"""The CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips when
torch sees no CUDA device. Run them on a machine with an NVIDIA GPU and
nvcc with ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(the repository's conftest imports jax, which that machine need not have);
the kernels are built on first use. Every comparison is exact (``torch.equal``): the
kernels keep their plain versions' operation order and are built with
-fmad=false. The prefix-sum probe's kernel equals the sequential float32
sums; its plain version, ``torch.cumsum``, sums in a parallel scan's order
and is held within a stated bound of the float64 sum.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import mystereomatching_tpu_torch as port
from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import aggregation, arms, cost, refine, sgm, wta
from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.pipeline import compute_volumes, kernels_launched

pytestmark = pytest.mark.cuda

M = 34
SCHED = [20.0 if k <= 17 else 6.0 for k in range(1, M + 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("shape", [(45, 70), (9, 50), (1, 1)])
def test_arms_grow_kernel(cuda, shape):
    rng = np.random.default_rng(shape[0])
    base = np.kron(rng.integers(0, 256, (-(-shape[0] // 30), -(-shape[1] // 30), 3)),
                   np.ones((30, 30, 1)))[:shape[0], :shape[1]]
    img = _t(np.clip(np.round(base + rng.normal(0, 2.0, base.shape)), 0, 255)
             .astype(np.float32), cuda)
    assert torch.equal(ck.arms_grow(img, SCHED, 20.0, 1),
                       arms.grow_arms_plain(img, SCHED, 20.0, 1))


def _arms_image(rng, shape, flat):
    """A blocky noisy colour image of ``shape``, or one colour everywhere."""
    if flat:
        return np.full(shape + (3,), 77.0, np.float32)
    base = np.kron(rng.integers(0, 256, (-(-shape[0] // 30), -(-shape[1] // 30), 3)),
                   np.ones((30, 30, 1)))[:shape[0], :shape[1]]
    return np.clip(np.round(base + rng.normal(0, 2.0, base.shape)), 0, 255).astype(np.float32)


# Kernel A runs a thread a (pixel, direction pair), 256 pixels a block, and
# walks at most l_out steps: sides shorter and narrower than l_out, images of
# fewer and of more pixels than a block, and a flat image, whose arms all
# reach min(l_out, distance to the border).
@pytest.mark.parametrize("shape", [(1, 1), (9, 50), (20, 300), (300, 20), (45, 70),
                                   (150, 261)])
@pytest.mark.parametrize("l_out", [34, 127])
@pytest.mark.parametrize("flat", [False, True])
def test_arms_grow_kernel_l_out(cuda, shape, l_out, flat):
    rng = np.random.default_rng(shape[0] + l_out)
    img = _t(_arms_image(rng, shape, flat), cuda)
    sched = [20.0 if k <= l_out // 2 else 6.0 for k in range(1, l_out + 1)]
    got = ck.arms_grow(img, sched, 20.0, 1)
    assert torch.equal(got, arms.grow_arms_plain(img, sched, 20.0, 1))
    if flat:
        room = torch.stack([arms.border_floor(*shape, dv, du, l_out, cuda)
                            for dv, du in arms.DIRECTIONS])
        assert torch.equal(got, room)


def test_arms_grow_copies_nothing_to_the_card(cuda):
    from torch.profiler import ProfilerActivity, profile

    img = _t(_arms_image(np.random.default_rng(1), (45, 70), False), cuda)
    ck.arms_grow(img, SCHED, 20.0, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ck.arms_grow(img, SCHED, 20.0, 1)
        torch.cuda.synchronize()
    copies = [e.name for e in prof.events() if "memcpy" in e.name.lower()]
    assert not copies, copies


# Kernel B stages 8 rows over a tile of at most 512 columns along W (W in
# ceil(W / 512) tiles of a multiple of 4 columns), and walks strips of 32
# columns down H, 8 rows a stage. The shapes straddle a tile's and a strip's
# width (-1, +0, +1, 2 * width + 3) and a stage's height, take every W % 4
# (16-byte copies only for W % 4 == 0), sides shorter than max_arm and of 1,
# D = 1, and rows longer than a tile; max_arm 0, 1, 34 and 127, with arms at
# 0 and at 127. For odd D the arm planes start one byte into their buffer,
# so that they are not 4-byte aligned (their rows then come byte by byte).
ARM_TAPS_CASES = [((7, 33, 41), 34), ((1, 9, 511), 34), ((2, 9, 512), 34), ((1, 9, 513), 34),
                  ((1, 5, 1027), 34), ((2, 7, 31), 34), ((1, 8, 32), 34), ((1, 9, 33), 34),
                  ((2, 19, 67), 34), ((3, 20, 50), 34), ((1, 1, 1), 34), ((2, 1, 30), 34),
                  ((2, 30, 1), 34), ((1, 5, 6), 34), ((2, 40, 45), 0), ((2, 40, 45), 1),
                  ((2, 150, 140), 127), ((1, 21, 300), 127), ((2, 9, 9000), 34),
                  ((2, 9000, 9), 34)]


def _arm_taps_case(cuda, shape, max_arm, axis, area, dtype):
    """Kernel B and its plain version on random costs of ``dtype`` and
    random int8 arms (some at 0, some at 127)."""
    rng = np.random.default_rng(axis + 2 * area + shape[2] + max_arm)

    def arm():
        a = rng.integers(0, min(max_arm + 6, 127) + 1, shape)
        a[rng.random(shape) < 0.1] = 0
        a[rng.random(shape) < 0.1] = 127
        a = _t(a.astype(np.int8), cuda)
        if shape[0] % 2:
            buf = torch.empty(a.numel() + 1, dtype=torch.int8, device=cuda)
            a = buf[1:].view(shape).copy_(a)
        return a

    vol = _t(rng.random(shape).astype(np.float32), cuda).to(dtype)
    an1, ap1, an, ap = (arm() for _ in range(4))
    if area:
        got = ck.arm_taps(vol, an, ap, axis, max_arm, an1=an1, ap1=ap1)
        want = arms.arm_bounded_sum_area_plain(vol, an1, ap1, an, ap, axis, max_arm)
    else:
        got = ck.arm_taps(vol, an, ap, axis, max_arm)
        want = arms.arm_bounded_sum_plain(vol, an, ap, axis, max_arm)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,max_arm", ARM_TAPS_CASES)
@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("area", [False, True])
def test_arm_taps_kernel(cuda, shape, max_arm, axis, area):
    _arm_taps_case(cuda, shape, max_arm, axis, area, torch.float32)


# In bfloat16 the volume's rows are staged as the 16-byte words covering
# them (8 elements a word), so W % 8 and the rows' alignment matter: the
# shapes above cover W % 8 from 0 to 7 (with D odd, the arm planes are
# unaligned too). The area pass's running count rounds once it passes 256:
# with max_arm 34 or 127 most windows' counts pass it.
@pytest.mark.parametrize("shape,max_arm", ARM_TAPS_CASES + [((3, 70, 77), 127), ((2, 8, 15), 2)])
@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("area", [False, True])
def test_arm_taps_kernel_bf16(cuda, shape, max_arm, axis, area):
    _arm_taps_case(cuda, shape, max_arm, axis, area, torch.bfloat16)


# The SGM kernels stage bands of scan lines through a ring of 4 stages (3
# for D > 192): 16 columns 4 rows at a time along H, 4 rows 16 columns at a
# time along W, 16 diagonals 4 rows at a time. Sizes at a band's width - 1,
# + 0, + 1, 2 * width + 3 and 1 cut bands and stages short, 3 * steps + 1
# and 4 * steps + 1 steps (13 and 17 along H and on the diagonals, 49 and
# 65 along W) wrap the ring, and D crosses the 32-lane slots.
SGM_DS = [1, 31, 32, 33, 37, 60, 128, 255, 256]


SGM_SCAN_SHAPES = [(2, 11, 19), (1, 3, 15), (2, 4, 16), (1, 5, 17), (2, 11, 35), (1, 1, 1),
                   (2, 1, 49), (1, 2, 65), (1, 13, 1), (2, 49, 13), (1, 50, 41)]
SGM_DIAG_SHAPES = [(21, 30), (40, 7), (1, 17), (17, 1), (8, 8), (8, 9), (9, 9), (18, 18), (1, 1),
                   (13, 35), (60, 9), (9, 60), (3, 45)]


def _sgm_inputs(cuda, seed, shape, dtype):
    """Random [G, D, H, W] costs in [0, 3) of ``dtype`` and float32 scales."""
    rng = np.random.default_rng(seed)
    vol = _t((rng.random(shape) * 3).astype(np.float32), cuda).to(dtype)
    ps = _t(np.where(rng.random(shape[:1] + shape[2:]) < 0.3, 0.25, 1.0).astype(np.float32),
            cuda)
    return vol, ps


@pytest.mark.parametrize("nd", SGM_DS)
@pytest.mark.parametrize("g,h,w", SGM_SCAN_SHAPES)
@pytest.mark.parametrize("axis,reverse", [(2, False), (2, True), (3, False), (3, True)])
def test_sgm_scan_kernel(cuda, nd, g, h, w, axis, reverse):
    vol, ps = _sgm_inputs(cuda, nd + h * w, (g, nd, h, w), torch.float32)
    assert torch.equal(ck.sgm_scan(vol, ps, 1.0, 3.0, axis, reverse),
                       sgm.sgm_scan_plain(vol, ps, 1.0, 3.0, axis, reverse))


# In bfloat16 each cost is staged as the aligned 4-byte word holding it, so
# the parity of its element index matters: odd planes H * W flip it from
# one disparity to the next, odd G * D * H * W from one volume to the next.
@pytest.mark.parametrize("nd", SGM_DS)
@pytest.mark.parametrize("g,h,w", SGM_SCAN_SHAPES)
@pytest.mark.parametrize("axis,reverse", [(2, False), (2, True), (3, False), (3, True)])
def test_sgm_scan_kernel_bf16(cuda, nd, g, h, w, axis, reverse):
    vol, ps = _sgm_inputs(cuda, nd + h * w, (g, nd, h, w), torch.bfloat16)
    got = ck.sgm_scan(vol, ps, 1.0, 3.0, axis, reverse)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, sgm.sgm_scan_plain(vol, ps, 1.0, 3.0, axis, reverse))


# Kernel C's carried-in row and in-image mask, which the row-band pipeline
# passes to its scans along H (sgm_scan_ext): a nonzero init [G, D, W]; a
# mask whose ones end mid-line at a different column on each row (as a
# skewed diagonal buffer's margins do), every fourth row all zeros. Widths
# at the band's 16 columns - 1, + 0, + 1 and beyond, and not multiples of it.
SGM_EXT_SHAPES = [(2, 11, 19), (1, 3, 15), (2, 4, 16), (1, 5, 17), (2, 13, 35), (1, 1, 1),
                  (1, 17, 33), (2, 40, 47)]


def _sgm_ext_inputs(cuda, seed, shape, dtype, inputs):
    vol, ps = _sgm_inputs(cuda, seed, shape, dtype)
    g, nd, h, w = shape
    rng = np.random.default_rng(seed + 1)
    init = None
    if "init" in inputs:
        init = _t((rng.random((g, nd, w)) * 4 + 0.5).astype(np.float32), cuda).to(dtype)
    mask = None
    if "mask" in inputs:
        m = np.zeros((g, h, w), np.float32)
        for v in range(h):
            m[:, v, v % 5: v % 5 + max(1, w // 2)] = 1.0
        m[:, ::4] = 0.0
        mask = _t(m, cuda).to(dtype)
    return vol, ps, init, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inputs", ["init", "mask", "init_mask"])
@pytest.mark.parametrize("nd", SGM_DS)
@pytest.mark.parametrize("g,h,w", SGM_EXT_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_sgm_scan_kernel_init_mask(cuda, dtype, inputs, nd, g, h, w, reverse):
    vol, ps, init, mask = _sgm_ext_inputs(cuda, nd + h * w + len(inputs), (g, nd, h, w), dtype,
                                          inputs)
    before = dict(ck.launches)
    got = ck.sgm_scan(vol, ps, 1.0, 3.0, 2, reverse, init=init, mask=mask)
    assert ck.launches["sgm_scan_ext"] == before["sgm_scan_ext"] + 1
    assert ck.launches["sgm_scan"] == before["sgm_scan"]
    assert got.dtype == dtype
    assert torch.equal(got, sgm.sgm_scan_plain(vol, ps, 1.0, 3.0, 2, reverse, init, mask))


def test_sgm_scan_kernel_init_mask_refusals(cuda):
    """init and mask only along H, of the volume's shape and type; without
    them the scan is the plain kernel C, counted as before."""
    vol, ps, init, mask = _sgm_ext_inputs(cuda, 1, (2, 5, 7, 9), torch.float32, "init_mask")
    for call in (lambda: ck.sgm_scan(vol, ps, 1.0, 3.0, 3, False, init=init),
                 lambda: ck.sgm_scan(vol, ps, 1.0, 3.0, 3, False, mask=mask),
                 lambda: ck.sgm_scan(vol, ps, 1.0, 3.0, 2, False, init=init[:, :, :-1]),
                 lambda: ck.sgm_scan(vol, ps, 1.0, 3.0, 2, False, mask=mask[:1])):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(TypeError):
        ck.sgm_scan(vol, ps, 1.0, 3.0, 2, False, init=init.to(torch.bfloat16))
    before = dict(ck.launches)
    ck.sgm_scan(vol, ps, 1.0, 3.0, 2, False, init=None, mask=None)
    assert ck.launches["sgm_scan"] == before["sgm_scan"] + 1
    assert ck.launches["sgm_scan_ext"] == before["sgm_scan_ext"]


# Kernel C's table of W-chunk scans (sgm_scan_ext): buffers (h, pitch) and
# tables of 1, 2 and 6 scans (buffer, lo, width, masked, with init,
# reverse, with edge) at odd offsets and pitches, of different widths (a
# block's 16 or 4 columns - 1, + 0, + 1 and beyond), masked beside
# unmasked, down and up; two scans of a table may share a buffer and its
# output, at disjoint columns.
SGM_TABLE_BUFFERS = [(13, 37), (17, 41), (4, 16)]
SGM_TABLE_SCANS = {
    "one": [(1, 3, 33, True, True, False, True)],
    "two": [(0, 1, 17, False, True, True, True), (1, 20, 15, True, False, False, False)],
    "six": [(0, 0, 1, True, True, False, True), (0, 1, 16, False, False, True, True),
            (0, 17, 20, True, True, True, False), (1, 5, 9, False, True, False, True),
            (1, 14, 27, True, False, False, True), (2, 3, 13, False, True, True, True)],
}


def _sgm_table(cuda, nd, dtype, name):
    """The table's buffers on the card, each output filled with -7."""
    rng = np.random.default_rng(nd + len(name))
    vols, scales, masks = [], [], []
    for h, w in SGM_TABLE_BUFFERS:
        vols.append(_t((rng.random((nd, h, w)) * 3).astype(np.float32), cuda).to(dtype))
        scales.append(_t(np.where(rng.random((h, w)) < 0.3, 0.25, 1.0).astype(np.float32), cuda))
        m = np.zeros((h, w), np.float32)
        for v in range(h):
            m[v, v % 5: v % 5 + max(1, w // 2)] = 1.0
        masks.append(_t(m, cuda))
    outs = [torch.full_like(v, -7.0) for v in vols]
    table = []
    for b, lo, width, masked, init, reverse, edge in SGM_TABLE_SCANS[name]:
        init_row = (_t((rng.random((nd, width)) * 4 + 0.5).astype(np.float32), cuda).to(dtype)
                    if init else None)
        table.append(sgm.ChunkScan(vols[b], scales[b], outs[b], lo, width, reverse, init_row,
                                   masks[b] if masked else None,
                                   torch.empty((nd, width), dtype=dtype, device=cuda)
                                   if edge else None))
    return table


def _cpu_copy(table):
    """The same table on the CPU, with outputs and edges of its own."""
    outs = {}
    copy = []
    for sc in table:
        if sc.out.data_ptr() not in outs:
            outs[sc.out.data_ptr()] = sc.out.cpu()
        copy.append(sgm.ChunkScan(sc.vol.cpu(), sc.pscale.cpu(), outs[sc.out.data_ptr()], sc.lo,
                                  sc.width, sc.reverse,
                                  sc.init.cpu() if sc.init is not None else None,
                                  sc.mask.cpu() if sc.mask is not None else None,
                                  torch.empty_like(sc.edge.cpu()) if sc.edge is not None
                                  else None))
    return copy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nd", SGM_DS)
@pytest.mark.parametrize("name", list(SGM_TABLE_SCANS))
@pytest.mark.parametrize("lines", ck.SCAN_TABLE_LINES)
def test_sgm_scan_table_kernel(cuda, dtype, nd, name, lines):
    """One launch for the whole table, bit-equal to the plain table: every
    chunk of every output, every edge row, and the columns no scan covers
    left as they were."""
    table = _sgm_table(cuda, nd, dtype, name)
    want = _cpu_copy(table)
    before, scans = dict(ck.launches), dict(ck.launches_scans)
    ck.sgm_scan_table(table, 1.0, 3.0, lines=lines)
    torch.cuda.synchronize()
    assert ck.launches["sgm_scan_ext"] == before["sgm_scan_ext"] + 1
    bf16 = "_bf16" if dtype == torch.bfloat16 else ""
    masked = sum(sc.mask is not None for sc in table)
    assert ck.launches_scans["sgm_scan_ext_mask" + bf16] == \
        scans["sgm_scan_ext_mask" + bf16] + masked
    assert ck.launches_scans["sgm_scan_ext" + bf16] == \
        scans["sgm_scan_ext" + bf16] + len(table) - masked
    sgm.sgm_scan_table_plain(want, 1.0, 3.0)
    for got, ref in zip(table, want):
        assert torch.equal(got.out.cpu(), ref.out)
        if got.edge is not None:
            assert torch.equal(got.edge.cpu(), ref.edge)


def test_sgm_scan_table_kernel_refusals(cuda):
    """Tables of one D and one dtype, float32 scales and masks, chunks
    inside their buffers, 1 to 32 scans, block widths 16 or 4."""
    table = _sgm_table(cuda, 5, torch.float32, "two")
    other_d = _sgm_table(cuda, 6, torch.float32, "one")
    bf16 = _sgm_table(cuda, 5, torch.bfloat16, "one")
    sc = table[1]
    value_errors = [
        table[:1] + other_d,
        [dataclasses.replace(sc, lo=sc.vol.shape[-1] - sc.width + 1)],
        [dataclasses.replace(sc, lo=-1)],
        [dataclasses.replace(sc, width=0)],
        [dataclasses.replace(sc, init=torch.zeros((5, sc.width + 1), device=cuda))],
        [dataclasses.replace(sc, out=sc.out[:, :-1])],
        [],
        table * 17,
    ]
    for bad in value_errors:
        with pytest.raises(ValueError):
            ck.sgm_scan_table(bad, 1.0, 3.0)
    with pytest.raises(ValueError):
        ck.sgm_scan_table(table, 1.0, 3.0, lines=32)
    type_errors = [
        table[:1] + bf16,
        [dataclasses.replace(sc, vol=sc.vol.to(torch.float16), out=sc.out.to(torch.float16))],
        [dataclasses.replace(sc, mask=sc.mask.to(torch.bfloat16))],
        [dataclasses.replace(sc, pscale=sc.pscale.double())],
        [dataclasses.replace(sc, out=sc.out.to(torch.bfloat16))],
    ]
    for bad in type_errors:
        with pytest.raises(TypeError):
            ck.sgm_scan_table(bad, 1.0, 3.0)


@pytest.mark.parametrize("preset", ["census_grad_cbca_sgm", "sgm8_full"])
def test_row_bands_on_one_card_equal_cpu(cuda, preset):
    """Two ranks sharing the card (gloo): the row-band maps equal the same
    bands' maps on the CPU, and each rank launched kernel C's new entry
    points (sgm_diag none: the band path's diagonals skew through C). The
    integer maps are held; the float subpixel map of sgm8_full also carries
    the cost's exp, which rounds differently on the card."""
    from mystereomatching_tpu_torch.parallel import run_row_bands
    from mystereomatching_tpu_torch.parallel._harness import Job, run_jobs
    from mystereomatching_tpu_torch.parallel.launch import band_pipeline

    pair = make_synthetic_pair(h=48, w=64, max_disp=15, seed=3, noise_sigma=0.5)
    cfg = get_model(preset, max_disp=15, census_rv=2, census_ru=3, cbca_cross_l=3,
                    cbca_cross_l_out=5, pi_search_depth=4, rv_s_thres=4,
                    do_subpixel=False, sub_ipol=False)
    job = Job(band_pipeline, (pair.left[None], pair.right[None], cfg, 3), row_axis=1,
              batch_axis=0)
    [(gpu, reports)] = run_jobs([job], 2, devices=[str(cuda)] * 2)
    gpu = torch.from_numpy(gpu[0])
    cpu = run_row_bands(pair.left, pair.right, cfg, n_row=2, n_chunks=3, devices=["cpu"] * 2)
    assert torch.equal(gpu, cpu)
    for r in reports:
        assert r["backend"] == "gloo" and r["launches"]["sgm_scan_ext"] > 0
        assert r["launches"]["sgm_diag"] == 0
        assert (r["launches_scans"]["sgm_scan_ext_mask"] > 0) == (cfg.sgm_scan_num == 8)


def _sgm_diag_case(cuda, nd, shape, g, dtype):
    vol, ps = _sgm_inputs(cuda, nd * 7 + shape[0] + g, (g, nd) + shape, dtype)
    for rv, ru in sgm.DIRECTIONS_8[4:]:
        assert torch.equal(ck.sgm_diag_scan(vol, ps, 1.0, 3.0, rv, ru),
                           sgm.sgm_diag_scan_plain(vol, ps, 1.0, 3.0, rv, ru)), (rv, ru)


@pytest.mark.parametrize("nd", SGM_DS)
@pytest.mark.parametrize("shape", SGM_DIAG_SHAPES)
@pytest.mark.parametrize("g", [1, 2])
def test_sgm_diag_kernel(cuda, nd, shape, g):
    """Kernel E on every diagonal, lines of every length, the corner's
    line included, against its plain version; 8x8 to 18x18 have 15, 16, 17
    and 35 lines, and (60, 9), (9, 60) and (3, 45) far more lines of the
    longest length than a band holds."""
    _sgm_diag_case(cuda, nd, shape, g, torch.float32)


@pytest.mark.parametrize("nd", SGM_DS)
@pytest.mark.parametrize("shape", SGM_DIAG_SHAPES)
@pytest.mark.parametrize("g", [1, 2])
def test_sgm_diag_kernel_bf16(cuda, nd, shape, g):
    _sgm_diag_case(cuda, nd, shape, g, torch.bfloat16)


@pytest.mark.parametrize("choose_small", [True, False])
def test_wta_kernel(cuda, choose_small):
    vol = _t(np.random.default_rng(6).integers(0, 3, (11, 14, 15)).astype(np.float32), cuda)
    assert torch.equal(ck.wta(vol, choose_small), wta.wta_plain(vol, choose_small))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("choose_small", [True, False])
def test_wta_kernel_takes_the_first_nan(cuda, dtype, choose_small):
    """A NaN is the extreme: the first NaN along D wins, as in torch.argmin
    and jnp.argmin (ZNCC's cost is NaN where a window's squared deviation
    rounds below 0), at d = 0, in the middle and last, with ties before it."""
    rng = np.random.default_rng(7)
    vol = rng.integers(0, 3, (17, 13, 40)).astype(np.float32)
    vol[:, :, 6:][rng.random((17, 13, 34)) < 0.05] = np.nan
    for u, ds in enumerate(([0], [5], [16], [3, 9], [9, 3, 12], list(range(17)))):
        vol[ds, :, u] = np.nan
    vol = _t(vol, cuda).to(dtype)
    got = ck.wta(vol, choose_small)
    assert torch.equal(got, wta.wta_plain(vol, choose_small))
    assert got[0, :6].tolist() == [0, 5, 16, 3, 3, 0]


@pytest.mark.parametrize("shape", [(11, 14, 15), (256, 9, 33)])
@pytest.mark.parametrize("choose_small", [True, False])
def test_wta_kernel_bf16(cuda, shape, choose_small):
    """Ties (integer costs) and +-inf, the cooperative WTA's mask in
    bfloat16."""
    rng = np.random.default_rng(shape[0])
    vol = rng.integers(0, 3, shape).astype(np.float32) + rng.random(shape).astype(np.float32) / 8
    vol[rng.random(shape) < 0.2] = np.inf if choose_small else -np.inf
    vol = _t(vol, cuda).to(torch.bfloat16)
    assert torch.equal(ck.wta(vol, choose_small), wta.wta_plain(vol, choose_small))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_volume_kernels_refuse_other_dtypes(cuda, dtype):
    vol = torch.zeros((2, 3, 5, 7), dtype=dtype, device=cuda)
    ps = torch.ones((2, 5, 7), device=cuda)
    arm = torch.zeros((3, 5, 7), dtype=torch.int8, device=cuda)
    calls = [lambda: ck.arm_taps(vol[0], arm, arm, 2, 4),
             lambda: ck.arm_taps(vol[0], arm, arm, 1, 4, arm, arm),
             lambda: ck.sgm_scan(vol, ps, 1.0, 3.0, 2, False),
             lambda: ck.sgm_diag_scan(vol, ps, 1.0, 3.0, 1, 1),
             lambda: ck.wta(vol[0])]
    for call in calls:
        with pytest.raises(TypeError):
            call()


@pytest.mark.parametrize("shape", [(33, 41), (1, 1), (5, 70)])
@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_arm_reduce_kernel(cuda, shape, axis, op):
    rng = np.random.default_rng(shape[0] + axis)
    vol = _t(rng.integers(-1000, 1000, (2,) + shape).astype(np.int32), cuda)
    an, ap = (_t(rng.integers(0, 40, shape).astype(np.int32), cuda) for _ in range(2))
    assert torch.equal(ck.arm_reduce(vol, an, ap, axis, M, op),
                       arms.arm_bounded_reduce_plain(vol, an, ap, axis, M, op))


def _region_vote_inputs(rng, shape, max_arm, holes):
    """A map of 16-px blocks with ``holes`` of its pixels -1 or -32, and
    [4, H, W] arms mostly short (geometric, at most 7) with 5% past
    max_arm, which the kernel caps."""
    h, w = shape
    base = np.kron(rng.integers(0, 60, (-(-h // 16), -(-w // 16))), np.ones((16, 16), np.int64))
    r = rng.random(shape)
    disp = np.where(r < holes / 2, -1, np.where(r < holes, -32, base[:h, :w])).astype(np.int32)
    arms0 = np.minimum(rng.geometric(0.3, (4,) + shape) - 1, 7)
    long = rng.random((4,) + shape) < 0.05
    arms0 = np.where(long, rng.integers(max_arm, max_arm + 6, (4,) + shape), arms0)
    return disp, arms0.astype(np.int32)


# Region vote's tiles are 32 columns by 32 rows; (77, 101) and (1100, 1950)
# are several tiles and a partial one along each axis. holes=1.0: an
# all-invalid map.
@pytest.mark.parametrize("shape", [(1, 1), (5, 70), (33, 41), (77, 101), (1100, 1950)])
@pytest.mark.parametrize("max_arm", [34, 127])
@pytest.mark.parametrize("holes", [0.3, 1.0])
def test_region_vote_kernel(cuda, shape, max_arm, holes):
    """Two chained passes, each one launch, against region_vote_plain."""
    rng = np.random.default_rng(shape[0] + max_arm)
    disp, arms0 = _region_vote_inputs(rng, shape, max_arm, holes)
    d, a = _t(disp, cuda), _t(arms0, cuda)
    for _ in range(2):
        before = ck.launches["region_vote"]
        got = ck.region_vote(d, a, max_arm, 3)
        assert ck.launches["region_vote"] == before + 1
        want = refine.region_vote_plain(d, a, 3, max_arm)
        assert torch.equal(got, want)
        d = want
    if holes == 1.0:
        assert torch.equal(d, _t(disp, cuda))


def test_region_vote_on_cuda_is_one_launch(cuda):
    """refine.region_vote on a CUDA tensor: one region_vote launch a pass,
    no arm_reduce launch."""
    disp, arms0 = _region_vote_inputs(np.random.default_rng(2), (45, 70), 34, 0.3)
    d, a = _t(disp, cuda), _t(arms0, cuda)
    ck.reset_launches()
    got = refine.region_vote(d, a, 60, 3, 0.4, True, 34)
    assert ck.launches["region_vote"] == 1 and ck.launches["arm_reduce"] == 0
    assert sum(ck.launches.values()) == 1
    assert torch.equal(got, refine.region_vote_plain(d, a, 3, 34))


def test_region_vote_refuses_long_arms(cuda):
    d = torch.zeros((4, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ck.region_vote(d, torch.zeros((4, 4, 5), dtype=torch.int32, device=cuda), 128, 3)


def _holed_map(rng, shape, holes):
    """A map with -1 and -32 holes: about ``holes`` of the pixels, or, for
    a pattern name, holes at given places of each warp's 32 pixels (the
    kernel's warps take 32 consecutive pixels, a half-warp a hole):
    ``edges`` at lanes 0, 15, 16 and 31, ``one`` one hole, ``odd`` three."""
    d = rng.integers(0, 60, shape).astype(np.int32)
    if isinstance(holes, str):
        lane = np.arange(d.size) % 32
        rel = (lane - 5 * (np.arange(d.size) // 32)) % 32   # moves from warp to warp
        hole = {"edges": np.isin(lane, [0, 15, 16, 31]), "one": rel == 0,
                "odd": np.isin(rel, [0, 11, 22])}[holes].reshape(shape)
        return np.where(hole, np.where(rng.random(shape) < 0.5, -1, -32), d).astype(np.int32)
    r = rng.random(shape)
    return np.where(r < holes / 2, -1, np.where(r < holes, -32, d)).astype(np.int32)


@pytest.mark.parametrize("depth", [1, 6, 20, 256])
@pytest.mark.parametrize("shape,holes,flat", [
    ((45, 70), 0.3, False), ((9, 50), 0.8, False), ((1, 1), 1.0, False), ((30, 30), 1.0, False),
    ((20, 64), "edges", False), ((20, 64), "one", False), ((21, 61), "odd", False),
    ((1, 300), 0.5, False), ((300, 1), 0.5, False), ((45, 70), 0.5, True)])
def test_pi_scan_kernel(cuda, depth, shape, holes, flat):
    """holes=1.0: all-invalid warps, no valid pixel within reach; flat: one
    colour everywhere, so every ray ties and the lowest ray must win."""
    rng = np.random.default_rng(depth + shape[0])
    disp = _holed_map(rng, shape, holes)
    img = np.full(shape + (3,), 77.0, np.float32) if flat else \
        rng.integers(0, 256, shape + (3,)).astype(np.float32)
    offs = _t(refine.pi_offsets(depth), cuda)
    d, im = _t(disp, cuda), _t(img, cuda)
    assert torch.equal(ck.pi_scan(d, im, offs, -32),
                       refine.proper_interpolation_plain(d, im, offs, -32))


@pytest.mark.parametrize("do_refine", [False, True])
def test_pipeline_on_cuda_equals_cpu(cuda, do_refine):
    pair = make_synthetic_pair(h=64, w=96, max_disp=11, seed=3, noise_sigma=0.5)
    cfg = port.default_config(max_disp=pair.max_disp, do_refine=do_refine)
    ck.reset_launches()
    gpu = port.StereoPipeline(cfg, device=cuda)(pair.left, pair.right)
    used = kernels_launched(cfg)
    assert all((n > 0) == (k in used) for k, n in ck.launches.items()), ck.launches
    cpu = port.StereoPipeline(cfg, device="cpu")(pair.left, pair.right)
    for key in ("disp_left_raw", "disp_right_raw", "disparity"):
        assert torch.equal(gpu[key].cpu(), cpu[key])


@pytest.mark.parametrize("do_subpixel,h,w,max_disp", [(True, 64, 96, 11), (False, 64, 96, 11),
                                                      (True, 37, 53, 20)])
def test_sgm8_full_kernel_path_equals_plain_path(cuda, do_subpixel, h, w, max_disp):
    """sgm8_full on the card, kernels against their plain versions on the
    same device. The float map is not held against the CPU's: the cost
    stage's plain torch ops (its exp) round differently on the card and the
    CPU, which moves the subpixel fits' last bits; the integer maps agree.
    37x53 cuts the SGM kernels' bands and stages short."""
    pair = make_synthetic_pair(h=h, w=w, max_disp=max_disp, seed=3, noise_sigma=0.5)
    cfg = get_model("sgm8_full", max_disp=pair.max_disp, do_subpixel=do_subpixel)
    pipe = port.StereoPipeline(cfg, device=cuda)
    ck.reset_launches()
    gpu = pipe(pair.left, pair.right)
    used = kernels_launched(cfg)
    assert all((n > 0) == (k in used) for k, n in ck.launches.items()), ck.launches
    assert ck.launches["sgm_diag"] == 4
    with mock.patch.object(ck, "on_cuda", lambda t: False):
        plain = pipe(pair.left, pair.right)
    for key in ("disp_left_raw", "disp_right_raw", "disparity"):
        assert torch.equal(gpu[key], plain[key]), key
    cpu = port.StereoPipeline(cfg, device="cpu")(pair.left, pair.right)
    for key in ("disp_left_raw", "disp_right_raw"):
        assert torch.equal(gpu[key].cpu(), cpu[key]), key


@pytest.mark.parametrize("variant", [{}, dict(vol_dtype="bfloat16", compute_both_volumes=False)])
def test_fullres_occfill_kernel_path_equals_plain_path(cuda, variant):
    """fullres_occfill in float32 with both volumes, and in bfloat16 with
    the cooperative WTA, on the card: the kernels against their plain
    versions on the same device, and the launches a frame (kernel B 8 or 4
    times, D twice either way)."""
    pair = make_synthetic_pair(h=48, w=64, max_disp=15, seed=3, noise_sigma=0.5)
    cfg = get_model("fullres_occfill", max_disp=15, **variant)
    pipe = port.StereoPipeline(cfg, device=cuda)
    ck.reset_launches()
    gpu = pipe(pair.left, pair.right)
    used = kernels_launched(cfg)
    assert all((n > 0) == (k in used) for k, n in ck.launches.items()), ck.launches
    assert ck.launches["arm_taps"] == (8 if cfg.compute_both_volumes else 4)
    assert ck.launches["wta"] == 2 and ck.launches["sgm_scan"] == 4
    with mock.patch.object(ck, "on_cuda", lambda t: False):
        plain = pipe(pair.left, pair.right)
    for key in ("disp_left_raw", "disp_right_raw", "disparity"):
        assert torch.equal(gpu[key], plain[key]), key


@pytest.mark.parametrize("variant", [dict(d_stream_block=4),
                                     dict(d_stream_block=4, vol_dtype="bfloat16",
                                          compute_both_volumes=False)])
def test_streamed_occfill_on_cuda_equals_dense_and_plain(cuda, variant):
    """fullres_occfill streamed over blocks of 4 of its 16 disparities:
    kernel B runs 4 launches a block and volume; the maps equal the dense
    kernel path's and the streamed plain path's on the card."""
    pair = make_synthetic_pair(h=48, w=64, max_disp=15, seed=3, noise_sigma=0.5)
    cfg = get_model("fullres_occfill", max_disp=15, **variant)
    pipe = port.StereoPipeline(cfg, device=cuda)
    ck.reset_launches()
    gpu = pipe(pair.left, pair.right)
    used = kernels_launched(cfg)
    assert all((n > 0) == (k in used) for k, n in ck.launches.items()), ck.launches
    n_vols = 2 if cfg.compute_both_volumes else 1
    assert ck.launches["arm_taps"] == 4 * (16 // 4) * n_vols
    dense = port.StereoPipeline(cfg.replace(d_stream_block=0), device=cuda)(pair.left,
                                                                          pair.right)
    with mock.patch.object(ck, "on_cuda", lambda t: False):
        plain = pipe(pair.left, pair.right)
    for key in ("disp_left_raw", "disp_right_raw", "disparity"):
        assert torch.equal(gpu[key], dense[key]), key
        assert torch.equal(gpu[key], plain[key]), key


def test_row_bands_disp_axis_on_one_card_equal_cpu(cuda):
    """fullres_occfill over 2 bands x 2 disparity blocks, four ranks sharing
    the card (gloo): the map equals the dense pipeline's on the CPU, and
    every rank all-gathered its block once a volume."""
    from mystereomatching_tpu_torch.parallel._harness import Job, run_jobs
    from mystereomatching_tpu_torch.parallel.launch import band_pipeline

    pair = make_synthetic_pair(h=48, w=64, max_disp=15, seed=3, noise_sigma=0.5)
    cfg = get_model("fullres_occfill", max_disp=15, census_rv=2, census_ru=3, cbca_cross_l=3,
                    cbca_cross_l_out=5, pi_search_depth=4, rv_s_thres=4)
    job = Job(band_pipeline, (pair.left[None], pair.right[None], cfg, 3), row_axis=1,
              batch_axis=0)
    [(gpu, reports)] = run_jobs([job], 2, devices=[str(cuda)] * 4, n_disp=2)
    cpu = port.StereoPipeline(cfg, device="cpu")(pair.left, pair.right)["disparity"]
    assert torch.equal(torch.from_numpy(gpu[0]), cpu)
    for r in reports:
        assert r["backend"] == "gloo" and r["comm"]["all_gathers"] == 2
        assert r["launches"]["arm_taps"] == 8 and r["launches"]["sgm_scan_ext"] > 0


# Frame C's shapes, past 32-bit offsets: kernel B on one [32, H, W] block
# with H * W >= 2**22, kernels C and D on a bfloat16 volume of more than
# 2**30 elements (its byte offsets pass 2**31). Inputs are made on the card.
def _big_arms(gen, shape, dev):
    a = torch.randint(0, 41, shape, generator=gen, device=dev, dtype=torch.int8)
    return torch.where(torch.rand(shape, generator=gen, device=dev) < 0.05,
                       torch.full_like(a, 127), a)


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("area", [False, True])
def test_arm_taps_kernel_bf16_large_block(cuda, axis, area):
    shape = (32, 1988, 2880)
    gen = torch.Generator(device=cuda).manual_seed(axis + 2 * area)
    vol = torch.rand(shape, generator=gen, device=cuda).to(torch.bfloat16)
    an, ap = _big_arms(gen, shape, cuda), _big_arms(gen, shape, cuda)
    if area:
        an1, ap1 = _big_arms(gen, shape, cuda), _big_arms(gen, shape, cuda)
        got = ck.arm_taps(vol, an, ap, axis, M, an1=an1, ap1=ap1)
        want = arms.arm_bounded_sum_area_plain(vol, an1, ap1, an, ap, axis, M)
    else:
        got = ck.arm_taps(vol, an, ap, axis, M)
        want = arms.arm_bounded_sum_plain(vol, an, ap, axis, M)
    assert torch.equal(got, want)


BIG_VOL = (256, 2048, 2100)      # 1.10e9 elements > 2**30


@pytest.fixture(scope="module")
def big_bf16_volume():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    vol = torch.empty(BIG_VOL, dtype=torch.bfloat16, device=dev)
    for d in range(BIG_VOL[0]):              # a plane at a time: no float32 copy of it all
        vol[d] = (torch.rand(BIG_VOL[1:], generator=gen, device=dev) * 3).to(torch.bfloat16)
    ps = torch.where(torch.rand((1,) + BIG_VOL[1:], generator=gen, device=dev) < 0.3,
                     0.25, 1.0).to(torch.float32)
    return vol, ps


@pytest.mark.parametrize("axis,reverse", [(2, False), (2, True), (3, False), (3, True)])
def test_sgm_scan_kernel_bf16_past_2_31_bytes(cuda, big_bf16_volume, axis, reverse):
    vol, ps = big_bf16_volume
    got = ck.sgm_scan(vol[None], ps, 1.0, 3.0, axis, reverse)
    assert torch.equal(got, sgm.sgm_scan_plain(vol[None], ps, 1.0, 3.0, axis, reverse))


@pytest.mark.parametrize("choose_small", [True, False])
def test_wta_kernel_bf16_past_2_31_bytes(cuda, big_bf16_volume, choose_small):
    vol, _ = big_bf16_volume
    assert torch.equal(ck.wta(vol, choose_small), wta.wta_plain(vol, choose_small))


# the copy-bandwidth probe: the TPU probe's shape in its tiles (W = 450,
# floats), ragged tiles, bulk copies (W and the tile a multiple of 4), and
# a buffer one float off 16-byte alignment; then the persistent grid's
# edges: a tile count that is no multiple of the grid (1,125 tiles), tile
# rows that are no multiple of a 4,096-float stage (6,000 floats: a stage
# and a part; a tile wider than W), a width that is no multiple of 4 with
# rows past a stage, and a buffer past 2**31 bytes
COPY_CASES = [((4, 375, 60, 450), (60, 256)), ((4, 375, 60, 450), (60, 450)),
              ((7, 33), (3, 5)), ((5, 12), (2, 6)), ((64, 4096), (8, 4096)), ((9, 20), (4, 8)),
              ((1,), (1, 1)),
              ((9000, 4096), (8, 4096)), ((40, 12000), (4, 6000)), ((33, 6004), (3, 10000)),
              ((37, 4098), (5, 4098)), ((131073, 4096), (8, 4096))]


@pytest.mark.parametrize("shape,tile", COPY_CASES)
@pytest.mark.parametrize("aligned", [True, False])
def test_copy_bw_kernel(cuda, shape, tile, aligned):
    from mystereomatching_tpu_torch.ops import bandwidth

    n = int(np.prod(shape))
    buf = torch.rand(n + 1, generator=torch.Generator(device=cuda).manual_seed(n),
                     device=cuda)
    x = (buf[:n] if aligned else buf[1:]).view(shape)
    before = ck.launches["copy_bw"]
    got = ck.copy_bw(x, *tile)
    assert ck.launches["copy_bw"] == before + 1
    assert torch.equal(got, bandwidth.scaled_copy_plain(x))


# the gather and prefix-sum probes (csrc/plane_probes.cu): micro4.py's plane,
# sides that are not multiples of 32, one row or one column, and the NL
# filter's rows at Teddy size (375 x 450 nodes by D + 1 = 61 columns); for
# cumsum_cols' row bands, a band of one row past 128, rows longer than one
# shared-memory tile (column chunks), and rows that start off 16 bytes
PROBE_SHAPES = [(375, 450), (33, 65), (1, 97), (97, 1), (31, 32), (168750, 61),
                (129, 450), (3, 70000), (257, 61), (5, 3)]


@pytest.mark.parametrize("shape", PROBE_SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
def test_gather_probe_kernels(cuda, shape, axis):
    from mystereomatching_tpu_torch.ops import plane_probes as pp

    gen = torch.Generator(device=cuda).manual_seed(shape[0] * 7 + axis)
    x = torch.rand(shape, generator=gen, device=cuda)
    out_shape = (shape[0] + 3, shape[1]) if axis == 0 else (shape[0], shape[1] + 5)
    idx = torch.randint(0, shape[axis], out_shape, generator=gen, device=cuda,
                        dtype=torch.int32)
    name = "gather_rows" if axis == 0 else "gather_cols"
    before = ck.launches[name]
    got = ck.gather_rows(x, idx) if axis == 0 else ck.gather_cols(x, idx)
    assert ck.launches[name] == before + 1
    want = pp.gather_rows_plain(x, idx) if axis == 0 else pp.gather_cols_plain(x, idx)
    assert torch.equal(got, want)


def test_gather_probe_kernels_out_of_range_give_nan(cuda):
    x = torch.ones((4, 6), device=cuda)
    idx = torch.tensor([[0, 4, -1, 3, 2, 1]], dtype=torch.int32, device=cuda)
    assert torch.isnan(ck.gather_rows(x, idx)).tolist() == [[False, True, True] + [False] * 3]
    idx = torch.tensor([[0, 6, -1, 5]], dtype=torch.int32, device=cuda).expand(4, 4).contiguous()
    assert torch.isnan(ck.gather_cols(x, idx))[:, 1:3].all()


@pytest.mark.parametrize("shape", PROBE_SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
def test_cumsum_probe_kernels(cuda, shape, axis):
    """The kernel's sums equal the sequential float32 sums bit for bit and
    torch.cumsum's parallel scan lies within the stated bound of the
    float64 cumsum; values of both signs."""
    from mystereomatching_tpu_torch.ops import plane_probes as pp

    gen = torch.Generator(device=cuda).manual_seed(shape[1] * 5 + axis)
    x = torch.rand(shape, generator=gen, device=cuda) * 2 - 0.5
    name = "cumsum_rows" if axis == 0 else "cumsum_cols"
    before = ck.launches[name]
    got = ck.cumsum(x, axis)
    assert ck.launches[name] == before + 1
    assert torch.equal(got, pp.cumsum_sequential(x, axis))
    assert pp.cumsum_error(pp.cumsum_plain(x, axis), x, axis) <= 1.0


@pytest.mark.parametrize("offsets", [(1, 0), (2, 3), (3, 3)])
def test_cumsum_cols_kernel_on_unaligned_views(cuda, offsets):
    """Input and output starting 4, 8 or 12 bytes past a 16-byte boundary,
    alike or not: the band's 16-byte words start elsewhere in each."""
    from mystereomatching_tpu_torch.ops import plane_probes as pp

    shape, (off_x, off_out) = (300, 61), offsets
    n = shape[0] * shape[1]
    gen = torch.Generator(device=cuda).manual_seed(off_x)
    x = (torch.rand(n + 4, generator=gen, device=cuda) * 2 - 0.5)[off_x:off_x + n].view(shape)
    out = torch.empty(n + 4, device=cuda)[off_out:off_out + n].view(shape)
    before = ck.launches["cumsum_cols"]
    with mock.patch.object(torch, "empty_like", lambda t: out):
        got = ck.cumsum(x, 1)
    assert ck.launches["cumsum_cols"] == before + 1
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, pp.cumsum_sequential(x, 1))


@pytest.mark.parametrize("neighbors", [4, 8])
def test_tree_filter_on_cuda_repeats_and_equals_cpu(cuda, neighbors):
    """No atomics: two runs on the card give the same bits, and the CPU's."""
    from mystereomatching_tpu_torch.ops import mst, nl

    pair = make_synthetic_pair(h=96, w=128, max_disp=15, seed=4)
    tree_cpu = mst.build_tree_host(pair.left, neighbors=neighbors)
    tree = mst.build_tree_host(pair.left, neighbors=neighbors, device=cuda)
    vol = torch.rand((16, 96, 128), generator=torch.Generator().manual_seed(1)) * 30
    for normalize in (False, True):
        a = nl.filter_volume(tree, vol.to(cuda), 0.1, normalize)
        b = nl.filter_volume(tree, vol.to(cuda), 0.1, normalize)
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), nl.filter_volume(tree_cpu, vol, 0.1, normalize))


@pytest.mark.parametrize("neighbors", [4, 8])
def test_device_tree_on_cuda_equals_host_tree(cuda, neighbors):
    """The device build on the card: the host build's tree, field by field."""
    from mystereomatching_tpu_torch.ops import mst

    pair = make_synthetic_pair(h=96, w=128, max_disp=15, seed=4)
    host = mst.build_tree_host(pair.left, neighbors)
    tree = mst.build_tree(torch.from_numpy(pair.left).to(cuda), neighbors)
    assert tree.parent.is_cuda and tree.child_idx.is_cuda
    for field in ("parent", "weight", "order", "pos", "parent_pos", "child_idx"):
        assert torch.equal(getattr(tree, field).cpu(), getattr(host, field)), field
    assert (tree.starts, tree.child_off, tree.child_k) == (host.starts, host.child_off,
                                                           host.child_k)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_nl_aggregate_batch_on_cuda_equals_cpu(cuda, dtype):
    """The forest build and filter on the card give the CPU's bits, in
    float32 and in the bfloat16 mode (136x128 frames, past its threshold)."""
    from mystereomatching_tpu_torch.ops import mst, nl

    lefts = torch.from_numpy(np.stack([make_synthetic_pair(h=136, w=128, max_disp=7, seed=s).left
                                       for s in range(2)])).float()
    vols = torch.rand((2, 4, 136, 128), generator=torch.Generator().manual_seed(2)) * 30
    want = nl.nl_aggregate_batch(vols, mst.build_tree_batch(lefts), 0.1, dtype)
    got = nl.nl_aggregate_batch(vols.to(cuda), mst.build_tree_batch(lefts.to(cuda)), 0.1, dtype)
    assert torch.equal(got.cpu(), want)


def test_match_pair_nl_batch_on_cuda_equals_cpu(cuda):
    pairs = [make_synthetic_pair(h=64, w=96, max_disp=15, seed=s) for s in range(3)]
    lefts, rights = (torch.from_numpy(np.stack([getattr(p, side) for p in pairs])).float()
                     for side in ("left", "right"))
    cfg = get_model("nl_tree_filter", max_disp=15)
    gpu = port.match_pair_nl_batch(lefts.to(cuda), rights.to(cuda), cfg)
    cpu = port.match_pair_nl_batch(lefts, rights, cfg)
    assert set(gpu) == set(cpu)
    for key in cpu:
        assert torch.equal(gpu[key].cpu(), cpu[key]), key


@pytest.mark.parametrize("preset", ["nl_tree_filter", "nl_8nr", "nl_post", "nl_census_post"])
def test_nl_preset_on_cuda_equals_cpu(cuda, preset):
    pair = make_synthetic_pair(h=64, w=96, max_disp=15, seed=3, noise_sigma=0.5)
    cfg = get_model(preset, max_disp=pair.max_disp)
    ck.reset_launches()
    gpu = port.StereoPipeline(cfg, device=cuda)(pair.left, pair.right)
    used = kernels_launched(cfg)
    assert all((n > 0) == (k in used) for k, n in ck.launches.items()), ck.launches
    cpu = port.StereoPipeline(cfg, device="cpu")(pair.left, pair.right)
    assert set(gpu) == set(cpu)
    for key in cpu:
        assert torch.equal(gpu[key].cpu(), cpu[key]), key


# the SGM-layout probes (csrc/sgm_probes.cu) on [G, H, D, W]: the scripts'
# D = 60 on a few rows, widths that are not multiples of 32, D of 1, below
# a warp group (8), above 128 and 256 with one volume, and G = 4 at D = 200
# (208 KB of shared memory in full); each against its plain version and, in
# full, against kernel C's downward scan of the transpose
SGM_PROBE_SHAPES = [(4, 24, 60, 40), (2, 9, 128, 33), (1, 5, 1, 7), (3, 17, 7, 70),
                    (1, 6, 256, 45), (4, 4, 200, 31),
                    (3, 41, 9, 37)]  # 40,959 elements: one short of 10 copy tiles, odd
SGM_PROBE_CASES = [(entry, kind) for entry, (_, kinds) in ck.SGM_PROBES.items() for kind in kinds]


@pytest.mark.parametrize("shape", SGM_PROBE_SHAPES)
@pytest.mark.parametrize("entry,kind", SGM_PROBE_CASES)
def test_sgm_probe_kernels(cuda, shape, entry, kind):
    from mystereomatching_tpu_torch.ops import sgm_probes

    gen = torch.Generator(device=cuda).manual_seed(shape[1] * shape[2])
    vol = torch.rand(shape, generator=gen, device=cuda)
    ps = torch.rand((shape[0], shape[1], shape[3]), generator=gen, device=cuda)
    before = ck.launches[entry]
    fn = getattr(ck, entry)
    got = fn(vol, ps) if entry in ("sgm_probe_hdw", "sgm_probe_g") else fn(vol, ps, kind)
    assert ck.launches[entry] == before + 1
    assert torch.equal(got, sgm_probes.plain(vol, ps, kind))
    if kind == "full":
        want_c = ck.sgm_scan(vol.transpose(1, 2).contiguous(), ps, 1.0, 3.0, 2, False)
        assert torch.equal(got, want_c.transpose(1, 2))


@pytest.mark.parametrize("entry", ["sgm_probe_rolled", "sgm_probe_unrolled"])
@pytest.mark.parametrize("offsets", [(1, 1), (2, 2), (3, 3), (1, 0), (0, 2)])
def test_sgm_probe_unrolled_copy_on_unaligned_views(cuda, offsets, entry):
    """The streaming copy, which both the rolled and the unrolled copy
    launch, with vol and out 4, 8 or 12 bytes past a 16-byte boundary:
    alike (a scalar head, then 16-byte words) or not (every element a
    scalar)."""
    from mystereomatching_tpu_torch.ops import sgm_probes

    shape, (off_vol, off_out) = (2, 30, 11, 45), offsets
    n = int(np.prod(shape))
    gen = torch.Generator(device=cuda).manual_seed(off_vol * 4 + off_out)
    vol = torch.rand(n + 4, generator=gen, device=cuda)[off_vol:off_vol + n].view(shape)
    ps = torch.rand((2, 30, 45), generator=gen, device=cuda)
    out = torch.empty(n + 4, device=cuda)[off_out:off_out + n].view(shape)
    before = {name: ck.launches[name] for name in ("sgm_probe_rolled", "sgm_probe_unrolled")}
    with mock.patch.object(torch, "empty_like", lambda t: out):
        got = getattr(ck, entry)(vol, ps, "copy")
    assert {name: ck.launches[name] - n0 for name, n0 in before.items()} == {
        name: int(name == entry) for name in before}
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, sgm_probes.copy_plain(vol))


def test_sgm_probe_refuses_more_shared_memory_than_a_block_has(cuda):
    vol = torch.zeros((4, 2, 256, 8), device=cuda)
    ps = torch.zeros((4, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ck.sgm_probe_g(vol, ps)
    assert ck.sgm_probe_rolled(vol, ps, "copy").shape == vol.shape  # copy keeps no carry


@pytest.mark.parametrize("kernel", ["arms_grow", "arm_taps"])
def test_window1_kernels(cuda, kernel):
    """Kernels A and B at double-window CBCA's large window
    (``cfg.window1()``: arms to 23 under thresholds 30 and 0, so max_arm
    23), on a frame's arms and a CBCA pass of its cost volume, each equal
    to its plain version."""
    pair = make_synthetic_pair(h=60, w=90, max_disp=15, seed=4, noise_sigma=0.5)
    cfg = get_model("cbca_double", max_disp=pair.max_disp)
    w1 = cfg.window1()
    assert w1.arm_l_out == 23 and cfg.arm_l_out == 34
    left, right = (_t(img.astype(np.float32), cuda) for img in (pair.left, pair.right))
    if kernel == "arms_grow":
        for img in (left, right):
            ck.reset_launches()
            got = arms.build_arms(img, w1)
            assert ck.launches["arms_grow"] == 1
            with mock.patch.object(ck, "on_cuda", lambda t: False):
                assert torch.equal(got, arms.build_arms(img, w1))
        return
    a_l, a_r = (arms.build_arms(img, w1) for img in (left, right))
    with mock.patch.object(ck, "on_cuda", lambda t: False):
        vol = compute_volumes(left, right, get_model(
            "census_grad_cbca_sgm", max_disp=pair.max_disp, aggregation="none"))[0][0]
    for lor in (0, 1):
        arms_int = arms.intersect_arms(a_l, a_r, cfg.num_disp, lor)
        ck.reset_launches()
        got = aggregation.cbca(vol, arms_int, cfg.cbca_iterations, w1.arm_l_out)
        assert ck.launches["arm_taps"] == 2 * cfg.cbca_iterations
        with mock.patch.object(ck, "on_cuda", lambda t: False):
            want = aggregation.cbca(vol, arms_int, cfg.cbca_iterations, w1.arm_l_out)
        assert torch.equal(got, want)


@pytest.mark.parametrize("preset", ["census_cbca_vmtop", "cbca_double", "ad_grad_gf",
                                    "zncc_bf_wta"])
def test_preset_on_cuda_equals_plain_path(cuda, preset):
    """The four presets of the box filters, the guided filter, vmTop and
    double-window CBCA: exactly the kernels of ``kernels_launched``, and the
    maps equal to the plain path's on the card."""
    pair = make_synthetic_pair(h=48, w=64, max_disp=15, seed=5, noise_sigma=0.5)
    cfg = get_model(preset, max_disp=pair.max_disp)
    pipe = port.StereoPipeline(cfg, device=cuda)
    ck.reset_launches()
    gpu = pipe(pair.left, pair.right)
    assert [k for k, n in ck.launches.items() if n] == kernels_launched(cfg)
    with mock.patch.object(ck, "on_cuda", lambda t: False):
        plain = pipe(pair.left, pair.right)
    assert set(gpu) == set(plain)
    for key in gpu:
        assert torch.equal(gpu[key], plain[key]), key


def test_fma32_and_exp32_on_cuda_equal_cpu(cuda):
    """``cost.fma32`` on 200,000 seeded float32 triples, and ``cost.exp32``
    on 200,000 arguments reaching the subnormal range: the card's bits are
    the CPU's (both take the operation in float64 and round once)."""
    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.standard_normal(200_000).astype(np.float32))
               for _ in range(3))
    want = cost.fma32(a, b, c)
    assert torch.equal(cost.fma32(a.to(cuda), b.to(cuda), c.to(cuda)).cpu(), want)
    x = torch.from_numpy(rng.uniform(-110.0, 5.0, 200_000).astype(np.float32))
    want = cost.exp32(x)
    assert (want == 0).any()
    assert torch.equal(cost.exp32(x.to(cuda)).cpu(), want)


@pytest.mark.parametrize("preset", ["aws_wta", "census_fif_sgm", "bt_so", "gfnl_wta"])
def test_last_presets_on_cuda_equal_plain_path_and_cpu(cuda, preset):
    """The presets of AWS, FIF, SO and GFNL: exactly the kernels of
    ``kernels_launched`` (no WTA for SO), the maps equal to the plain path's
    on the card and to the CPU port's (every operation of their new stages
    rounds alike on both: ``fma32``, ``exp32``, float64 cbrt and pow)."""
    pair = make_synthetic_pair(h=48, w=64, max_disp=15, seed=5, noise_sigma=0.5)
    cfg = get_model(preset, max_disp=pair.max_disp)
    pipe = port.StereoPipeline(cfg, device=cuda)
    ck.reset_launches()
    gpu = pipe(pair.left, pair.right)
    assert [k for k, n in ck.launches.items() if n] == kernels_launched(cfg)
    with mock.patch.object(ck, "on_cuda", lambda t: False):
        plain = pipe(pair.left, pair.right)
    cpu = port.StereoPipeline(cfg, device="cpu")(pair.left, pair.right)
    assert set(gpu) == set(plain) == set(cpu)
    for key in gpu:
        assert torch.equal(gpu[key], plain[key]), key
        assert torch.equal(gpu[key].cpu(), cpu[key]), key


@pytest.mark.parametrize("preset", ["ad_census_wta", "census_wta", "census_cbca_lrc"])
def test_census_preset_on_cuda_equals_plain_path(cuda, preset):
    """Exactly the kernels of ``kernels_launched``; the maps equal the plain
    path's on the card and, where the costs are integers (census_wta,
    census_cbca_lrc), the CPU port's."""
    pair = make_synthetic_pair(h=48, w=64, max_disp=15, seed=5, noise_sigma=0.5)
    cfg = get_model(preset, max_disp=pair.max_disp)
    pipe = port.StereoPipeline(cfg, device=cuda)
    ck.reset_launches()
    gpu = pipe(pair.left, pair.right)
    assert [k for k, n in ck.launches.items() if n] == kernels_launched(cfg)
    with mock.patch.object(ck, "on_cuda", lambda t: False):
        plain = pipe(pair.left, pair.right)
    assert set(gpu) == set(plain)
    for key in gpu:
        assert torch.equal(gpu[key], plain[key]), key
    if preset != "ad_census_wta":
        cpu = port.StereoPipeline(cfg, device="cpu")(pair.left, pair.right)
        for key in cpu:
            assert torch.equal(gpu[key].cpu(), cpu[key]), key


# the taps probes (csrc/taps_probes.cu) on float32 [N, H, W] with int32
# arms: an odd size, lines above 256 along H and along W (roll's 16-slot
# instance along W), one pixel; max_arm 34 (the scripts', static's only)
# and 5, arms up to 2 past it (capped), so that they reach past the edges
TAPS_PROBE_SHAPES = [(3, 41, 130), (2, 300, 33), (1, 7, 301), (2, 1, 1)]
TAPS_PROBE_CASES = [(entry, kind, axis, param, m)
                    for entry, (_, kinds) in ck.TAPS_PROBES.items()
                    for kind, (_, axes, params) in kinds.items()
                    for axis in axes for param in params or (None,)
                    for m in (34, 5) if entry != "taps_probe_static" or m == 34]


def _taps_probe(entry, kind, axis, param, m, vol, an, ap):
    if entry == "taps_probe_roll":
        return ck.taps_probe_roll(vol, an, ap, axis, m)
    if entry == "taps_probe_slice":
        return ck.taps_probe_slice(vol, an, ap, kind, m, axis, param)
    if entry == "taps_probe_clones":
        return ck.taps_probe_clones(vol, an, ap, kind, m, param)
    return ck.taps_probe_static(vol, an, ap, param, m)


@pytest.mark.parametrize("shape", TAPS_PROBE_SHAPES)
@pytest.mark.parametrize("entry,kind,axis,param,m", TAPS_PROBE_CASES)
def test_taps_probe_kernels(cuda, shape, entry, kind, axis, param, m):
    from mystereomatching_tpu_torch.ops import taps_probes

    gen = torch.Generator(device=cuda).manual_seed(shape[1] * shape[2] + m)
    vol = torch.rand(shape, generator=gen, device=cuda)
    an, ap = (torch.randint(0, m + 3, shape, generator=gen, device=cuda, dtype=torch.int32)
              for _ in range(2))
    before = ck.launches[entry]
    got = _taps_probe(entry, kind, axis, param, m, vol, an, ap)
    assert ck.launches[entry] == before + 1
    if kind == "roll":
        want = taps_probes.circular_plain(vol, an, ap, axis, m)
    elif kind == "fixed":
        want = taps_probes.fixed_plain(vol, an, ap, m)
    else:
        want = taps_probes.bounded_plain(vol, an, ap, axis, m)
    assert torch.equal(got, want)
    zero = torch.zeros_like(an)
    assert torch.equal(_taps_probe(entry, kind, axis, param, m, vol, zero, zero), vol)


def test_taps_probe_refusals(cuda):
    vol = torch.zeros((1, 4, 513), device=cuda)
    arms = torch.zeros((1, 4, 513), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="exceeds 512"):
        ck.taps_probe_roll(vol, arms, arms, 2, 5)
    with pytest.raises(TypeError, match="int32"):
        ck.taps_probe_slice(vol, arms.to(torch.int8), arms, "dyn", 5)
    with pytest.raises(ValueError, match="compiled"):
        ck.taps_probe_static(vol, arms, arms, 8, 10)
    assert torch.equal(ck.taps_probe_slice(vol, arms, arms, "dyn", 5, axis=2), vol)


@pytest.mark.parametrize("shape", [(45, 70), (150, 261)])
@pytest.mark.parametrize("mode", ["multilevel", "adaptive"])
def test_arms_grow_kernel_on_the_new_schedules(cuda, mode, shape):
    """Kernel A on the multilevel (thresholds 20/30/30 to 17/23/34 steps,
    neighbour threshold 20) and adaptive (int(30 - 20 k / 17), then 6)
    schedules equals the plain growth, through ``build_arms``."""
    img = _t(_arms_image(np.random.default_rng(shape[1]), shape, False), cuda)
    cfg = port.default_config(cbca_arm_mode=mode)
    sched, neigh = arms.arm_schedule(cfg)
    assert len(sched) == cfg.arm_l_out
    ck.reset_launches()
    got = arms.build_arms(img, cfg)
    assert ck.launches["arms_grow"] == 1
    assert torch.equal(got, arms.grow_arms_plain(img, sched, neigh, cfg.cbca_min_arm))


# frames of ROADMAP §1 item 5 at 96x128, D=16: name -> (overrides of the
# default preset, whether the card's maps must equal the CPU port's: every
# operation of these rounds alike on both, exp32 and fma32 included;
# ad_census_zncc's ZNCC is held against the plain path on the card only)
ITEM5_FRAMES = {
    "ad": (dict(cost="ad"), True),
    "sd": (dict(cost="sd"), True),
    "grad": (dict(cost="grad"), True),
    "grad_1dir_norm": (dict(cost="grad", grad_use_2dir=False, is_grad_norm=True), True),
    "ssd": (dict(cost="ssd"), True),
    "census_from2": (dict(cost="census_from2"), True),
    "census_from2_first": (dict(cost="census_from2", census_from2_blend="first"), True),
    "ad_census_grad": (dict(cost="ad_census_grad"), True),
    "ad_census_zncc": (dict(cost="ad_census_zncc"), False),
    "multilevel": (dict(cbca_arm_mode="multilevel"), True),
    "adaptive": (dict(cbca_arm_mode="adaptive"), True),
    "pyramid2": (dict(pyramid_levels=2), True),
    "pyramid2_bf16": (dict(pyramid_levels=2, vol_dtype="bfloat16"), True),
    "ad_census_grad_streamed": (dict(cost="ad_census_grad", d_stream_block=4), True),
}


@pytest.mark.parametrize("name", sorted(ITEM5_FRAMES))
def test_item5_frame_on_cuda_equals_plain_path(cuda, name):
    """A 96x128 frame of each new cost, arm mode and the pyramid on the
    card: exactly the kernels of ``kernels_launched`` (A and B once a
    pyramid level), the maps equal to the plain path's on the card and,
    where ``ITEM5_FRAMES`` says so, to the CPU port's."""
    overrides, on_cpu = ITEM5_FRAMES[name]
    pair = make_synthetic_pair(h=96, w=128, max_disp=15, seed=6)
    cfg = port.default_config(max_disp=pair.max_disp, **overrides)
    pipe = port.StereoPipeline(cfg, device=cuda)
    ck.reset_launches()
    gpu = pipe(pair.left, pair.right)
    counts = {k: n for k, n in ck.launches.items() if n}
    assert list(counts) == kernels_launched(cfg)
    assert counts["arms_grow"] == 2 * cfg.pyramid_levels
    with mock.patch.object(ck, "on_cuda", lambda t: False):
        plain = pipe(pair.left, pair.right)
    assert set(gpu) == set(plain)
    for key in gpu:
        assert torch.equal(gpu[key], plain[key]), key
    if on_cpu:
        cpu = port.StereoPipeline(cfg, device="cpu")(pair.left, pair.right)
        for key in gpu:
            assert torch.equal(gpu[key].cpu(), cpu[key]), key


def _same_with_nan(got, want):
    """Equal bits where not NaN, and NaN at the same entries."""
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.nan_to_num(got, nan=0.0), torch.nan_to_num(want, nan=0.0)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nd", [31, 60])
def test_sgm_kernels_carry_nan_as_plain(cuda, nd, dtype):
    """Kernels C and E take a NaN cost as their plain versions do (torch's
    amin and minimum, and jnp's, return NaN where an operand is NaN): from
    a NaN on a line the path costs run NaN to the line's end. ZNCC's cost is
    NaN where rounding makes a window's variance negative, which
    ad_census_zncc carries into SGM."""
    vol, ps = _sgm_inputs(cuda, nd + 5, (2, nd, 23, 29), dtype)
    vol[0, 3, 5, 7] = float("nan")
    vol[1, nd - 1, 20, 2] = float("nan")
    for axis, reverse in [(2, False), (2, True), (3, False), (3, True)]:
        got = ck.sgm_scan(vol, ps, 1.0, 3.0, axis, reverse)
        assert bool(torch.isnan(got).any())
        assert _same_with_nan(got, sgm.sgm_scan_plain(vol, ps, 1.0, 3.0, axis, reverse))
    for rv, ru in sgm.DIRECTIONS_8[4:]:
        assert _same_with_nan(ck.sgm_diag_scan(vol, ps, 1.0, 3.0, rv, ru),
                              sgm.sgm_diag_scan_plain(vol, ps, 1.0, 3.0, rv, ru)), (rv, ru)


# ROADMAP §1 item 6 on the card: configuration (a) and (b) of chip_smoke.py's
# phase_item6
ITEM6_FRAMES = {
    "a": dict(lrc_classify=True, do_fill_surrounding=True, do_pkr=True, rv_use_combine_bg=True,
              interpolate_type=3, reg_vote_type=2, bg_ip_dir=4, do_bg_ipol=True,
              bg_ipol_kitti=True, do_rv_whole_image=True, cbca_double_win=True,
              cbca_combine=1),
    "b": dict(rv_int_ratio_quirk=False, do_cbbi=True, do_wm=True, do_da=True,
              do_last_median=True),
}


def _one_hot_stack(dev, num_disp, h, w, seed):
    """A [D + 1, H, W] histogram stack of a seeded map with holes, its
    arms (up to 34) and the map."""
    rng = np.random.default_rng(seed)
    disp = rng.integers(-1, num_disp, (h, w)).astype(np.int32)
    arms0 = _t(rng.integers(0, 35, (4, h, w)).astype(np.int32), dev)
    return refine.vote_stack(_t(disp, dev), num_disp), arms0, _t(disp, dev)


@pytest.mark.parametrize("num_disp,h,w", [(16, 45, 70), (60, 96, 128)])
def test_arm_reduce_sum_on_vote_stack(cuda, num_disp, h, w):
    """arm_reduce's sum on a [D + 1, H, W] one-hot stack, along W then H,
    equals its plain version (integer sums, exact)."""
    stack, arms0, _ = _one_hot_stack(cuda, num_disp, h, w, num_disp)
    l_, r_, u_, d_ = (a.contiguous() for a in arms0.unbind(0))
    got = ck.arm_reduce(ck.arm_reduce(stack, l_, r_, 2, 34, "sum"), u_, d_, 1, 34, "sum")
    want = arms.arm_bounded_reduce_plain(arms.arm_bounded_reduce_plain(stack, l_, r_, 2, 34,
                                                                       "sum"),
                                         u_, d_, 1, 34, "sum")
    assert torch.equal(got, want)
    assert int(got[-1].max()) > 1


def test_histogram_vote_kernel_path_equals_plain(cuda):
    """The histogram region vote and the whole-image vote on the card: two
    arm_reduce launches a pass, the maps equal to the plain path's."""
    _, arms0, disp = _one_hot_stack(cuda, 24, 80, 100, 3)
    ck.reset_launches()
    got = refine.region_vote(disp, arms0, 24, 5, 0.4, False, 34)
    whole = refine.region_vote_whole_image(disp, arms0, 24, 34)
    assert ck.launches["arm_reduce"] == 4 and ck.launches["region_vote"] == 0
    with mock.patch.object(ck, "on_cuda", lambda t: False):
        assert torch.equal(got, refine.region_vote(disp, arms0, 24, 5, 0.4, False, 34))
        assert torch.equal(whole, refine.region_vote_whole_image(disp, arms0, 24, 34))


def test_arms_grow_kernel_refuses_tilted_directions(cuda):
    """Kernel A walks the axis directions only: the tilted ones raise there,
    and build_arms grows them in plain torch on the card (no launch), equal
    to the CPU's."""
    img = _t(np.random.default_rng(0).integers(0, 256, (30, 40, 3)).astype(np.float32), cuda)
    with pytest.raises(ValueError, match="axis directions"):
        ck.arms_grow(img, SCHED, 20.0, 1, directions=arms.TILT_DIRECTIONS)
    cfg = port.default_config()
    ck.reset_launches()
    tilt = arms.build_arms(img, cfg, directions=arms.TILT_DIRECTIONS)
    assert ck.launches["arms_grow"] == 0
    assert torch.equal(tilt.cpu(), arms.build_arms(img.cpu(), cfg,
                                                   directions=arms.TILT_DIRECTIONS))


def test_canny_and_wm_forms_on_cuda_equal_cpu(cuda):
    """The Canny angle (float64 atan2 rounded once, one FMA), the blur's FMA
    chains, the gray mix and the weighted median's weights (fma32, exp32) on
    the card give the CPU's bits."""
    from mystereomatching_tpu_torch.ops import canny, cbbi

    rng = np.random.default_rng(1)
    gy, gx = (torch.from_numpy((rng.standard_normal(200_000) * 300).astype(np.float32))
              for _ in range(2))
    assert torch.equal(canny.gradient_degrees(gy.to(cuda), gx.to(cuda)).cpu(),
                       canny.gradient_degrees(gy, gx))
    img = torch.from_numpy(rng.integers(0, 256, (60, 80)).astype(np.float32))
    for ksize in (3, 7):
        assert torch.equal(canny.gaussian_blur(img.to(cuda), ksize, 4.0).cpu(),
                           canny.gaussian_blur(img, ksize, 4.0))
    rgb = torch.from_numpy((rng.random((3, 60, 80)) * 255).astype(np.float32))
    assert torch.equal(cbbi.gray_mix(*rgb.to(cuda)).cpu(), cbbi.gray_mix(*rgb))
    cdis = torch.from_numpy(rng.uniform(0, 60000, 200_000).astype(np.float32))
    assert torch.equal(refine.wm_weight(cdis.to(cuda), 3, -5).cpu(), refine.wm_weight(cdis, 3, -5))
    e = canny.canny_edges(img.to(cuda), equalize=True, blur_sigma=4.0)
    assert torch.equal(e.cpu(), canny.canny_edges(img, equalize=True, blur_sigma=4.0))


@pytest.mark.parametrize("name", sorted(ITEM6_FRAMES))
def test_item6_frame_on_cuda_equals_plain_path_and_cpu(cuda, name):
    """A 96x128 frame of each item-6 configuration on the card: exactly the
    kernels of ``kernels_launched`` (arm_reduce for the histogram votes),
    the maps equal to the plain path's on the card and to the CPU port's."""
    pair = make_synthetic_pair(h=96, w=128, max_disp=15, seed=6)
    cfg = port.default_config(max_disp=pair.max_disp, **ITEM6_FRAMES[name])
    pipe = port.StereoPipeline(cfg, device=cuda)
    ck.reset_launches()
    gpu = pipe(pair.left, pair.right)
    assert [k for k, n in ck.launches.items() if n] == kernels_launched(cfg)
    with mock.patch.object(ck, "on_cuda", lambda t: False):
        plain = pipe(pair.left, pair.right)
    cpu = port.StereoPipeline(cfg, device="cpu")(pair.left, pair.right)
    assert set(gpu) == set(plain) == set(cpu)
    for key in gpu:
        assert torch.equal(gpu[key], plain[key]), key
        assert torch.equal(gpu[key].cpu(), cpu[key]), key
