"""The refinement variants (ROADMAP §1 item 6) against the JAX package, on the CPU.

At 48x64, D=16, seeded with numpy: PKR's mask and stamp (float32 and
bfloat16 volumes) and its merge ``combine2vm_pkr``; the histogram region
vote, the HV, tilted and gated votes, the whole-image vote; the background
fills (two directions at depth 5 and at depth >= W - 1, four directions),
``rv_combine_bg`` over every ``interpolate_type`` x ``reg_vote_type`` x
``bg_ip_dir``; the census border fill, the KITTI fill and the weighted
median; the tilted arms in the three arm modes and the diagonal sums; the
rest of ``combine.py``. Then configuration (a) of the card's item-6 phase
end to end against the jitted JAX ``match_pair`` on the synthetic and the
adversarial scene, with ``NARROW`` windows (tests/test_torch_vmtop.py;
configuration (b) is in tests/test_torch_canny_cbbi.py, so that the two
JAX compiles go to two workers), and ``match_pair_nl_batch`` with an
item-6 chain against its ``match_pair`` frame by frame.

Tolerances: the integer functions (masks, votes, fills, labels, maps) are
bit-equal to the JAX functions (called op by op where they are integer
work, jitted where float work enters). The float blends are bit-equal to
the jitted JAX functions (the port takes XLA-CPU's fused multiply-adds).
Where ``exp`` enters (the weighted median's weights, ``exp_adaptive_fuse``)
the port takes ``cost.exp32``, within one float32 ULP of XLA's ``exp``: the
test says how many entries differ and holds them to an ULP.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.config import default_config as jax_default_config
from mystereomatching_tpu.ops import arms as jax_arms
from mystereomatching_tpu.ops import combine as jax_combine
from mystereomatching_tpu.ops import refine as jax_refine

from mystereomatching_tpu_torch.config import as_port_config, default_config
from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import arms, combine, refine
from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.pipeline import (StereoPipeline, check_supported,
                                                 kernels_launched, match_pair,
                                                 match_pair_nl_batch)

from test_torch_vmtop import KEYS, NARROW, SCENES, check_maps, make_scenes

D, H, W = 16, 48, 64
M = 8  # the arms' longest step in the unit tests (NARROW's cbca_cross_l_out)
OCC, MIS, INV = -32, -48, -16

# the card's item-6 configurations (chip_smoke.py ITEM6), on the default preset:
# (a) the classifying LR check, the border fill, PKR and RV_combine_BG (OCC to
# min(vote, fill) with the gated vote and the four-direction fill), the KITTI
# fill, the whole-image vote and double-window CBCA merged by PKR's blend;
# (b) the histogram region vote, CBBI, WM, DA and the last median
CONFIG_A = dict(lrc_classify=True, do_fill_surrounding=True, do_pkr=True,
                rv_use_combine_bg=True, interpolate_type=3, reg_vote_type=2, bg_ip_dir=4,
                do_bg_ipol=True, bg_ipol_kitti=True, do_rv_whole_image=True,
                cbca_double_win=True, cbca_combine=1)
CONFIG_B = dict(rv_int_ratio_quirk=False, do_cbbi=True, do_wm=True, do_da=True,
                do_last_median=True)
# the CPU tests' narrowing of (b): the weighted median's window to 5x5 (the
# card runs its 19x19), which halves the JAX compile
NARROW_B = dict(wm_win=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.ascontiguousarray(a))


def _ulps(a, b):
    """Largest distance in float32 ULPs between two float32 arrays of one sign."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    return int(np.abs(ia - ib).max())


@pytest.fixture(scope="module")
def scene():
    """A seeded synthetic left image, its axis and tilted arms (NARROW
    widths, l_out = M) and a disparity map from its ground truth with
    holes of every sentinel: -1, DISP_INV, DISP_OCC and DISP_MIS."""
    p = make_synthetic_pair(h=H, w=W, max_disp=D - 1, seed=4)
    img = p.left.astype(np.float32)
    rng = np.random.default_rng(4)
    disp = np.clip(np.round(p.gt), 0, D - 1).astype(np.int32)
    r = rng.random((H, W))
    holed = np.select([r < 0.08, r < 0.12, r < 0.24, r < 0.34], [-1, INV, OCC, MIS],
                      disp).astype(np.int32)
    holed[10:16, 20:40] = OCC                                   # a wide occluded run
    axis_arms = arms.cross_arms(_t(img), l_in=4, l_out=M).numpy()
    tilt_arms = arms.cross_arms(_t(img), l_in=4, l_out=M,
                                directions=arms.TILT_DIRECTIONS).numpy()
    return img, holed, axis_arms, tilt_arms


def _volume(seed, shape=(D, H, W)):
    """Costs on a few levels plus eighths: ties in the minimum for PKR."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 5, shape) + rng.integers(0, 8, shape) / 8 + 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# PKR and its merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pkr_mask_and_stamp_exact(scene, dtype):
    """pkr_mask and apply_pkr against the jitted JAX functions, float32 and
    bfloat16 volumes (the bfloat16 ratio rounds in bfloat16 there too);
    zero-cost pixels with a repeated minimum give NaN ratios, not masked."""
    vol = _volume(1)
    vol[:, :4, :4] = 0.0
    _, holed, _, _ = scene
    jv = _j(vol).astype(jnp.dtype(dtype))
    tv = _t(vol).to(getattr(torch, dtype))
    want_mask = np.asarray(jax.jit(jax_refine.pkr_mask)(jv))
    want = np.asarray(jax.jit(jax_refine.apply_pkr)(_j(holed), jv))
    got_mask = refine.pkr_mask(tv)
    assert got_mask.dtype == torch.bool
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_array_equal(refine.apply_pkr(_t(holed), tv).numpy(), want)
    assert 0 < want_mask.mean() < 1 and not want_mask[:4, :4].any()
    assert (want == -64).any()


def test_combine2vm_pkr_exact():
    """PKR's merge (cbca_combine=1): the blend fma(vm2, 0.7, 0.3 vm) equals
    the jitted JAX function bit for bit."""
    vm, vm2 = _volume(2), (np.random.default_rng(3).random((D, H, W)) * 4).astype(np.float32)
    want = np.asarray(jax.jit(jax_combine.combine2vm_pkr)(_j(vm), _j(vm2)))
    got = combine.combine(_t(vm), _t(vm2), 1, None, None)
    np.testing.assert_array_equal(got.numpy(), want)
    took = (got.numpy() != vm).any(0)
    assert took.any() and not took.all()


# ---------------------------------------------------------------------------
# region votes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h_ratio,s_thres", [(0.4, 20), (0.7, 5)])
def test_histogram_region_vote_exact(scene, h_ratio, s_thres):
    """rv_int_ratio_quirk=False, two passes: the port's map equals JAX's."""
    _, holed, axis_arms, _ = scene
    want, got = _j(holed), _t(holed)
    for _ in range(2):
        want = jax_refine.region_vote(want, _j(axis_arms), D, s_thres, h_ratio, False, M)
        got = refine.region_vote(got, _t(axis_arms), D, s_thres, h_ratio, False, M)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) != holed).any() and (np.asarray(want) < 0).any()


def test_histogram_region_vote_differs_from_unanimity(scene):
    """The two forms fill different pixels on this map (the histogram one
    takes a majority where the unanimity one needs every pixel)."""
    _, holed, axis_arms, _ = scene
    hist = refine.region_vote(_t(holed), _t(axis_arms), D, 5, 0.4, False, M)
    unan = refine.region_vote(_t(holed), _t(axis_arms), D, 5, 0.4, True, M)
    assert (hist.numpy() >= 0).sum() > (unan.numpy() >= 0).sum()


@pytest.mark.parametrize("vote", ["hv", "tilt", "type2", "whole"])
def test_votes_exact(scene, vote):
    """vote_hv, vote_tilt, region_vote_core's gate (type 2) and the
    whole-image vote against the JAX functions."""
    _, holed, axis_arms, tilt_arms = scene
    j = [_j(a) for a in (holed, axis_arms, tilt_arms)]
    t = [_t(a) for a in (holed, axis_arms, tilt_arms)]
    if vote == "hv":
        want = jax_refine.vote_hv(j[0], j[1], D, 5, 0.4, M)
        got = refine.vote_hv(t[0], t[1], D, 5, 0.4, M)
    elif vote == "tilt":
        want = jax_refine.vote_tilt(j[0], j[2], D, 5, 0.4, M)
        got = refine.vote_tilt(t[0], t[2], D, 5, 0.4, M)
    elif vote == "type2":
        want = jax_refine.region_vote_core(j[0], j[1], j[2], D, 5, 0.4, 2, M)
        got = refine.region_vote_core(t[0], t[1], t[2], D, 5, 0.4, 2, M)
        hv = refine.vote_hv(t[0], t[1], D, 5, 0.4, M)
        tl = refine.vote_tilt(t[0], t[2], D, 5, 0.4, M)
        assert (got == hv).logical_and(got != tl).any() and (got == tl).logical_and(
            got != hv).any()
    else:
        want = jax_refine.region_vote_whole_image(j[0], j[1], D, M)
        got = refine.region_vote_whole_image(t[0], t[1], D, M)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) >= 0).any() and (np.asarray(want) == -1).any() or vote == "whole"


def test_vote_stack_is_the_one_hot_stack(scene):
    """vote_stack's scatter equals the JAX ``_vote_stack``, also with
    disparities past num_disp (no plane, but counted valid)."""
    _, holed, _, _ = scene
    d = holed.copy()
    d[0, :5] = D + 3
    np.testing.assert_array_equal(refine.vote_stack(_t(d), D).numpy(),
                                  np.asarray(jax_refine._vote_stack(_j(d), D)))


def test_histogram_vote_on_cpu_launches_no_kernel(scene):
    _, holed, axis_arms, _ = scene
    ck.reset_launches()
    refine.region_vote(_t(holed), _t(axis_arms), D, 5, 0.4, False, M)
    assert not any(ck.launches.values())


# ---------------------------------------------------------------------------
# background fills and RV_combine_BG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [5, W - 1, 1000])
def test_bg_fill_2dir_exact(scene, depth):
    """Depth 5 (the JAX loop of shifts) and depth >= W - 1 (its nearest-valid
    scans): one nearest-valid pass a side with a distance test in the
    port, the same fill and count."""
    _, holed, _, _ = scene
    want = jax_refine.bg_fill_2dir(_j(holed), depth, D)
    got = refine.bg_fill_2dir(_t(holed), depth, D)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    n_found = np.asarray(want[1])
    assert (n_found == 0).any() == (depth == 5) and (n_found == 1).any() and (n_found == 2).any()


@pytest.mark.parametrize("axis,reverse", [(0, False), (0, True), (1, False), (1, True)])
def test_nearest_valid_with_index_exact(scene, axis, reverse):
    _, holed, _, _ = scene
    want = jax_refine._nearest_valid_with_index(_j(holed), axis, reverse)
    got = refine.nearest_valid_with_index(_t(holed), axis, reverse)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("depth", [3, 1000])
def test_bg_fill_4dir_exact(scene, depth):
    img, holed, _, _ = scene
    want = np.asarray(jax_refine.bg_fill_4dir(_j(holed), _j(img), depth))
    got = refine.bg_fill_4dir(_t(holed), _t(img), depth)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any()


@pytest.mark.parametrize("bg_dirs", [2, 4])
@pytest.mark.parametrize("reg_vote_type", [0, 1, 2])
@pytest.mark.parametrize("interpolate_type", [0, 1, 2, 3])
def test_rv_combine_bg_exact(scene, interpolate_type, reg_vote_type, bg_dirs):
    """RV_combine_BG in every policy x vote type x fill, on one map with OCC,
    MIS, DISP_INV and -1 holes: OCC and MIS fill by the policy, and under
    types 2 and 3 the other sentinels stay."""
    img, holed, axis_arms, tilt_arms = scene
    args = (D, 5, 0.4, interpolate_type, reg_vote_type, 6, bg_dirs, OCC, MIS, M)
    want = np.asarray(jax_refine.rv_combine_bg(_j(holed), _j(axis_arms), _j(tilt_arms),
                                               _j(img), *args))
    got = refine.rv_combine_bg(_t(holed), _t(axis_arms), _t(tilt_arms), _t(img), *args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    changed = want != holed
    assert changed.any()
    if interpolate_type >= 2:
        other = (holed == -1) | (holed == INV)
        assert (want[other] == holed[other]).all()


def test_fill_surrounding_exact(scene):
    _, holed, _, _ = scene
    want = np.asarray(jax_refine.fill_surrounding(_j(holed), 3, 4, INV))
    np.testing.assert_array_equal(refine.fill_surrounding(_t(holed), 3, 4, INV).numpy(), want)


@pytest.mark.parametrize("thres", [0, 3])
def test_interpolate_background_kitti_exact(scene, thres):
    """The KITTI filler, its valid test ``disp > thres`` (disparity 0 counts
    as invalid at the default threshold 0), on the holed map with whole
    invalid rows and columns."""
    _, holed, _, _ = scene
    d = holed.copy()
    d[:, 50:] = -1
    d[40:] = np.where(d[40:] > 0, 0, d[40:])
    d[:3] = -1
    want = np.asarray(jax_refine.interpolate_background_kitti(_j(d), thres))
    got = refine.interpolate_background_kitti(_t(d), thres)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((d == 0) & (want != 0)).any()


# ---------------------------------------------------------------------------
# the weighted median
# ---------------------------------------------------------------------------

def test_wm_weights_within_an_ulp_of_jitted_jax(scene):
    """The colour distance and the exponent bit for bit against the jitted
    JAX expressions; the weight (exp) within one ULP, the count of differing
    entries stated (about 10%: XLA's float32 exp is not correctly rounded)."""
    img, _, _, _ = scene
    c = np.moveaxis(img, -1, 0)
    nc = np.roll(c, (3, -5), (1, 2))
    dv, du = 3, -5
    jd = jax.jit(lambda a, b: jnp.sum((a - b) ** 2, axis=0))
    jarg = jax.jit(lambda a, b: -jnp.sum((a - b) ** 2, axis=0) / (25.0 * 25.0)
                   - (dv * dv + du * du) / (9.0 * 9.0))
    jw = jax.jit(lambda a, b: jnp.exp(-jnp.sum((a - b) ** 2, axis=0) / (25.0 * 25.0)
                                      - (dv * dv + du * du) / (9.0 * 9.0)))
    cd = refine.wm_color_distance(_t(c), _t(nc))
    np.testing.assert_array_equal(cd.numpy(), np.asarray(jd(c, nc)))
    spatial = float(np.float32((dv * dv + du * du) / 81.0))
    rec = float(np.float32(1.0) / np.float32(625.0))
    arg = refine.fma32(-cd, rec, -spatial)
    np.testing.assert_array_equal(arg.numpy(), np.asarray(jarg(c, nc)))
    got, want = refine.wm_weight(cd, dv, du).numpy(), np.asarray(jw(c, nc))
    n_diff = int((got != want).sum())
    assert n_diff < 0.2 * got.size
    assert _ulps(got, want) <= 1


def test_weighted_median_exact(scene):
    """The weighted median (radius 4) on the holed map against the jitted
    JAX function. Its weights are within an ULP of XLA's, so a bin's
    cumulative weight could fall on the other side of half the total; on
    this map no pixel does, and the medians are equal at every pixel."""
    img, holed, _, _ = scene
    mask = holed < 0
    want = np.asarray(jax.jit(lambda d, i, m: jax_refine.weighted_median(d, i, m, D, 4))(
        _j(holed), _j(img), _j(mask)))
    got = refine.weighted_median(_t(holed), _t(img), _t(mask), D, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[mask] >= 0).any()


# ---------------------------------------------------------------------------
# tilted arms and the diagonal sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["two_level", "multilevel", "adaptive"])
def test_tilted_arms_exact(scene, mode):
    """build_arms(directions=TILT_DIRECTIONS) against the jitted JAX
    build_arms, in the three arm modes at NARROW widths."""
    img, _, _, _ = scene
    jcfg = jax_default_config(cbca_arm_mode=mode, cbca_cross_ls=(3, 5, 8), **{
        k: v for k, v in NARROW.items() if k.startswith("cbca_cross_l") and k != "cbca_cross_ls"})
    want = np.asarray(jax.jit(lambda x: jax_arms.build_arms(
        x, jcfg, directions=jax_arms.TILT_DIRECTIONS))(_j(img)))
    got = arms.build_arms(_t(img), as_port_config(jcfg), directions=arms.TILT_DIRECTIONS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 1).any()


def test_arm_bounded_sum_dir_exact(scene):
    _, holed, _, tilt_arms = scene
    stack = np.asarray(jax_refine._vote_stack(_j(holed), D))
    for step, (n, p) in (((1, 1), (0, 1)), ((1, -1), (2, 3))):
        want = jax_arms.arm_bounded_sum_dir(_j(stack), _j(tilt_arms[n])[None],
                                            _j(tilt_arms[p])[None], step, M)
        got = arms.arm_bounded_sum_dir(_t(stack), _t(tilt_arms[n])[None],
                                       _t(tilt_arms[p])[None], step, M)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the rest of combine.py (no JAX pipeline calls these: unit-tested only)
# ---------------------------------------------------------------------------

def test_min_and_weighted_combine_exact():
    vm0, vm1 = _volume(5), (np.random.default_rng(6).random((D, H, W)) * 4).astype(np.float32)
    np.testing.assert_array_equal(combine.min_combine(_t(vm0), _t(vm1)).numpy(),
                                  np.asarray(jax_combine.min_combine(_j(vm0), _j(vm1))))
    want = jax.jit(lambda a, b: jax_combine.weighted_combine(a, 0.4, b, 0.6))(_j(vm0), _j(vm1))
    np.testing.assert_array_equal(combine.weighted_combine(_t(vm0), 0.4, _t(vm1), 0.6).numpy(),
                                  np.asarray(want))


def test_exp_adaptive_fuse_within_an_ulp(scene):
    """exp_adaptive_fuse against the jitted JAX function: three exps, so
    within a few ULPs (bounded by 4e-7 absolute on results in [0, 1])."""
    _, _, axis_arms, _ = scene
    vm0, vm1 = _volume(7), _volume(8)
    want = np.asarray(jax.jit(lambda a, b, c: jax_combine.exp_adaptive_fuse(a, b, c, 13.0, 1.0))(
        _j(vm0), _j(vm1), _j(axis_arms)))
    got = combine.exp_adaptive_fuse(_t(vm0), _t(vm1), _t(axis_arms), 13.0, 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-7)
    assert (got == want).mean() > 0.5


@pytest.mark.parametrize("fw_type,cost_compare", [(1, True), (3, True), (4, True), (4, False)])
def test_combine_cross_fw_exact(fw_type, cost_compare):
    """Types 1, 3 and 4 on int8 intersected arms up to 127 (type 4's
    per-axis sums wrap in int8, as in the JAX package)."""
    rng = np.random.default_rng(fw_type)
    vm, fw = _volume(9), _volume(10)
    arms_int = rng.integers(0, 6, (4, D, H, W)).astype(np.int8)
    arms_int[:, :, :4] = 127
    area = rng.integers(0, 12, (D, H, W)).astype(np.float32)
    kw = dict(fw_type=fw_type, cost_compare=cost_compare,
              area_is=area if fw_type == 3 else None)
    want = np.asarray(jax_combine.combine_cross_fw(_j(vm), _j(fw), _j(arms_int),
                                                   **{**kw, "area_is": _j(area)
                                                      if fw_type == 3 else None}))
    got = combine.combine_cross_fw(_t(vm), _t(fw), _t(arms_int),
                                   **{**kw, "area_is": _t(area) if fw_type == 3 else None})
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != vm).any()


def test_combine_hv_tilt_exact(scene):
    _, _, axis_arms, tilt_arms = scene
    vm0, vm1 = _volume(11), _volume(12)
    want = np.asarray(jax_combine.combine_hv_tilt(_j(vm0), _j(vm1), _j(axis_arms),
                                                  _j(tilt_arms)))
    got = combine.combine_hv_tilt(_t(vm0), _t(vm1), _t(axis_arms), _t(tilt_arms))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == vm0).all(0).any() and (want == vm1).all(0).any()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def test_item6_flags_are_accepted_with_their_kernels():
    """Every item-6 flag passes check_supported; kernels_launched names
    arm_reduce for the histogram votes and region_vote for the unanimity
    form only."""
    base = dict(max_disp=D - 1)
    for it in range(4):
        for rt in range(3):
            for bd in (2, 4):
                check_supported(default_config(**base, rv_use_combine_bg=True,
                                               interpolate_type=it, reg_vote_type=rt,
                                               bg_ip_dir=bd))
    for name, want in (("a", ["arms_grow", "arm_taps", "sgm_scan", "wta", "arm_reduce",
                              "pi_scan"]),
                       ("b", ["arms_grow", "arm_taps", "sgm_scan", "wta", "arm_reduce",
                              "pi_scan"])):
        cfg = default_config(**base, **(CONFIG_A if name == "a" else CONFIG_B))
        check_supported(cfg)
        assert kernels_launched(cfg) == want
    tilt_only = default_config(**base, rv_use_combine_bg=True, interpolate_type=0,
                               reg_vote_type=1)
    assert "arm_reduce" not in kernels_launched(tilt_only)
    assert "region_vote" not in kernels_launched(tilt_only)
    assert "region_vote" in kernels_launched(default_config(**base))
    whole = default_config(**base, do_region_vote=False, do_rv_whole_image=True)
    assert "arms_grow" in kernels_launched(whole) and "arm_reduce" in kernels_launched(whole)


@pytest.fixture(scope="module")
def scenes():
    return make_scenes()


def _maps(scenes, overrides):
    """{scene: (jitted JAX match_pair maps, port maps)} of the default preset
    with ``overrides`` and NARROW windows, one jit for both scenes."""
    jcfg = jax_default_config(max_disp=D - 1, **NARROW, **overrides)
    fn = jax.jit(functools.partial(jax_pipeline.match_pair, cfg=jcfg))
    pipe = StereoPipeline(as_port_config(jcfg), device="cpu")
    out = {}
    for name, pair in scenes.items():
        ref = fn(jnp.asarray(pair.left), jnp.asarray(pair.right))
        out[name] = ({k: np.asarray(v) for k, v in ref.items()},
                     {k: v.numpy() for k, v in pipe(pair.left, pair.right).items()})
    return out


@pytest.fixture(scope="module")
def maps_a(scenes):
    return _maps(scenes, CONFIG_A)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("key", KEYS)
def test_config_a_matches_jax(maps_a, scene, key):
    check_maps(maps_a, scene, key)


def test_item6_stages_change_the_maps(scenes):
    """Each configuration's refinement differs from the default chain's on
    the synthetic scene, so the end-to-end tests above see the stages at
    work."""
    pair = scenes["synthetic"]
    base = match_pair(_t(pair.left), _t(pair.right), default_config(max_disp=D - 1, **NARROW))
    for overrides in (CONFIG_A, CONFIG_B):
        out = match_pair(_t(pair.left), _t(pair.right),
                         default_config(max_disp=D - 1, **NARROW, **overrides))
        assert not torch.equal(out["disparity"], base["disparity"])


def test_nl_batch_with_item6_chain_equals_match_pair():
    """match_pair_nl_batch with the histogram vote, the border fill, PKR,
    the KITTI fill, WM, DA and the whole-image vote (the cooperative WTA's
    right map for the LR check) equals its match_pair frame by frame."""
    cfg = get_model("nl_tree_filter", max_disp=7, rv_int_ratio_quirk=False,
                    do_fill_surrounding=True, do_pkr=True, do_bg_ipol=True, bg_ipol_kitti=True,
                    do_wm=True, wm_win=2, do_da=True, do_rv_whole_image=True,
                    cbca_cross_l=4, cbca_cross_l_out=8, pi_search_depth=4)
    pairs = [make_synthetic_pair(h=24, w=32, max_disp=7, seed=s) for s in (0, 1)]
    lefts = torch.stack([_t(p.left) for p in pairs])
    rights = torch.stack([_t(p.right) for p in pairs])
    batch = match_pair_nl_batch(lefts, rights, cfg)
    for i in range(2):
        one = match_pair(lefts[i], rights[i], cfg)
        assert set(one) == set(batch)
        for key in one:
            assert torch.equal(batch[key][i], one[key]), key
