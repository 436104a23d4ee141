"""The port's ``fullres_occfill`` preset against the JAX package's, on the CPU.

The classifying LR check, the background fill, the right-view reindexing
and the cooperative WTA, CBCA and SGM in bfloat16, and the whole preset in
its two bench-suite configurations: float32 with left and right volumes,
and one bfloat16 left volume with the cooperative WTA. Both sides get the
same numpy arrays, made from a seed. Every comparison is exact; bfloat16
results are compared as their uint16 bit patterns, so that equal means
bit-equal. The bfloat16 contract is the JAX CPU path's: every operation
rounds to bfloat16, the CBCA taps in ascending offset, the SGM step with
its scaled penalties rounded first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import models as jax_models
from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.ops import aggregation as jax_agg
from mystereomatching_tpu.ops import refine as jax_refine
from mystereomatching_tpu.ops import sgm as jax_sgm
from mystereomatching_tpu.ops import volume as jax_volume
from mystereomatching_tpu.ops import wta as jax_wta

from mystereomatching_tpu_torch import StereoPipeline
from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import aggregation, refine, sgm, volume, wta
from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.pipeline import check_supported, kernels_launched

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# the two bench-suite configurations (scripts/bench_suite.py:53-58), at D=16
CONFIGS = {"float32_both": {},
           "bf16_cooperative": dict(vol_dtype="bfloat16", compute_both_volumes=False)}
OCC, MIS = -32, -48


def _bits(x) -> np.ndarray:
    """A result as comparable numpy: bfloat16 as its uint16 bit patterns."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def assert_same(got, want):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape, w.dtype, w.shape)
    np.testing.assert_array_equal(g, w)


def _pair(vol: np.ndarray, dtype: str):
    """The same float32 array in each package, cast to ``dtype`` there."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(vol).to(tdt), jnp.asarray(vol).astype(jdt)


def _maps(rng, h, w, nd):
    """Left and right WTA-like maps in [0, nd): a smooth disparity field
    with noise, so that some pixels pass the LR check, and some -1s."""
    base = (np.arange(w)[None, :] * (nd - 1) // (2 * w) + np.arange(h)[:, None] % 3)
    dl = np.clip(base + rng.integers(-1, 2, (h, w)), 0, nd - 1)
    dr = np.clip(base + rng.integers(-1, 2, (h, w)), 0, nd - 1)
    dl[rng.random((h, w)) < 0.05] = -1
    return dl.astype(np.int32), dr.astype(np.int32)


@pytest.mark.parametrize("max_diff", [0, 1])
def test_lr_consistency_classify_matches_jax(max_diff):
    rng = np.random.default_rng(max_diff)
    dl, dr = _maps(rng, 23, 41, 12)
    want = jax_refine.lr_consistency_classify(jnp.asarray(dl), jnp.asarray(dr), 12, max_diff,
                                              OCC, MIS)
    got = refine.lr_consistency_classify(torch.from_numpy(dl), torch.from_numpy(dr), 12,
                                         max_diff, OCC, MIS)
    assert {OCC, MIS} <= set(np.unique(np.asarray(want)).tolist())
    assert (np.asarray(want) >= 0).any()
    assert_same(got, want)


@pytest.mark.parametrize("h,w,num_disp", [(9, 37, 16), (3, 2880, 256)])
def test_bg_interpolation_matches_jax(h, w, num_disp):
    """Holes of every code, rows with no valid pixel, and rows whose ends
    are holes (so one side has no valid pixel)."""
    rng = np.random.default_rng(w)
    d = rng.integers(0, num_disp, (h, w))
    r = rng.random((h, w))
    d = np.where(r < 0.15, -1, np.where(r < 0.3, OCC, np.where(r < 0.4, MIS, d)))
    d[0] = -1                      # a row with no valid pixel
    d[1, :5] = OCC                 # a row starting and ending in holes
    d[1, -4:] = MIS
    d = d.astype(np.int32)
    want = jax_refine.bg_interpolation(jnp.asarray(d), num_disp)
    got = refine.bg_interpolation(torch.from_numpy(d), num_disp)
    assert (np.asarray(want)[0] < 0).all() and (np.asarray(want)[1:] >= 0).all()
    assert_same(got, want)


def _volume(seed, shape):
    """Costs with many ties (integers plus a few fractions)."""
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, 5, shape).astype(np.float32)
    vol[..., ::3] += rng.random(vol[..., ::3].shape).astype(np.float32)
    return vol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flip_volume_lr_matches_jax(dtype):
    vt, vj = _pair(_volume(1, (7, 5, 11)), dtype)
    assert_same(volume.flip_volume_lr(vt), jax_volume.flip_volume_lr(vj))


@pytest.mark.parametrize("choose_small", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wta_pair_cooperative_matches_jax(dtype, choose_small):
    vt, vj = _pair(_volume(2, (9, 6, 13)), dtype)
    got = wta.wta_pair_cooperative(vt, choose_small)
    want = jax_wta.wta_pair_cooperative(vj, choose_small)
    for g, w_ in zip(got, want):
        assert_same(g, w_)


@pytest.mark.parametrize("max_arm,arm_max", [(34, 34), (127, 63)])
def test_cbca_bf16_matches_jax(max_arm, arm_max):
    """Two iterations in bfloat16. The support counts summed in a window pass
    256, so their partial sums round. Arms stay within 63 at max_arm 127:
    the JAX CPU path adds the first pass's count in int8, which wraps
    beyond that (ROADMAP section 3); the port counts in int32."""
    rng = np.random.default_rng(max_arm)
    shape = (3, 19, 150) if max_arm > 34 else (3, 21, 40)
    vol = (rng.random(shape) * 2).astype(np.float32)
    arms_int = rng.integers(0, arm_max + 1, (4,) + shape).astype(np.int8)
    arms_int[rng.random((4,) + shape) < 0.1] = 0
    vt, vj = _pair(vol, "bfloat16")
    want = jax_agg.cbca(vj, jnp.asarray(arms_int), 2, max_arm)
    got = aggregation.cbca(vt, torch.from_numpy(arms_int), 2, max_arm)
    assert got.dtype == torch.bfloat16
    assert_same(got, want)


def _image(rng, h, w):
    """Colours 0..39, so that about half the neighbour differences exceed
    the penalty threshold of 15."""
    return rng.integers(0, 40, (h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("rv,ru", sgm.DIRECTIONS_8)
def test_sgm_scan_bf16_matches_scan_direction(rv, ru):
    """Each axis direction (kernel C's plain version) and each diagonal
    (kernel E's) in bfloat16 against the JAX scan, whose penalty scale
    stays weakly typed."""
    rng = np.random.default_rng(rv * 3 + ru + 10)
    vt, vj = _pair((rng.random((6, 17, 23)) * 3).astype(np.float32), "bfloat16")
    img = _image(rng, 17, 23)
    want = jax_sgm.scan_direction(vj, jnp.asarray(img), rv, ru, 1.0, 3.0, 15, 4.0)
    ps = sgm.penalty_scale(torch.from_numpy(img), rv, ru, 15, 4.0)[None]
    if rv and ru:
        got = sgm.sgm_diag_scan_plain(vt[None], ps, 1.0, 3.0, rv, ru)[0]
    elif ru == 0:
        got = sgm.sgm_scan_plain(vt[None], ps, 1.0, 3.0, 2, rv > 0)[0]
    else:
        got = sgm.sgm_scan_plain(vt[None], ps, 1.0, 3.0, 3, ru > 0)[0]
    assert_same(got, want)


@pytest.mark.parametrize("n_vols", [1, 2])
def test_sgm_multi_bf16_matches_jax(n_vols):
    rng = np.random.default_rng(n_vols)
    pairs = [_pair((rng.random((5, 15, 21)) * 3).astype(np.float32), "bfloat16")
             for _ in range(n_vols)]
    imgs = [_image(rng, 15, 21) for _ in range(n_vols)]
    want = jax_sgm.sgm_multi([p[1] for p in pairs], [jnp.asarray(i) for i in imgs],
                             4, 1.0, 3.0, 15, 4.0)
    got = sgm.sgm_multi([p[0] for p in pairs], [torch.from_numpy(i) for i in imgs],
                        4, 1.0, 3.0, 15, 4.0)
    for g, w_ in zip(got, want):
        assert_same(g, w_)


@pytest.fixture(scope="module")
def preset_outputs():
    """fullres_occfill in both bench-suite configurations at D=16 on a small
    pair, in both packages; one JAX jit for both."""
    pair = make_synthetic_pair(h=48, w=64, max_disp=15)
    jcfgs = [jax_models.get_model("fullres_occfill", max_disp=15, **kw)
             for kw in CONFIGS.values()]
    fn = jax.jit(lambda l, r: [jax_pipeline.match_pair(l, r, c) for c in jcfgs])
    refs = jax.tree.map(np.asarray, fn(jnp.asarray(pair.left), jnp.asarray(pair.right)))
    ck.reset_launches()
    ours = [StereoPipeline(get_model("fullres_occfill", max_disp=15, **kw),
                           device="cpu")(pair.left, pair.right) for kw in CONFIGS.values()]
    assert sum(ck.launches.values()) == 0
    return dict(zip(CONFIGS, zip(refs, ours)))


@pytest.mark.parametrize("key", ["disp_left_raw", "disp_right_raw", "disparity"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fullres_occfill_matches_jax(preset_outputs, config, key):
    ref, ours = preset_outputs[config]
    assert_same(ours[key], ref[key])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fullres_occfill_reaches_both_lrc_codes(preset_outputs, config):
    """The scene's classified LR check holds both DISP_OCC and DISP_MIS, so
    region vote, proper interpolation and the background fill all meet
    them; the final map has no hole left."""
    _, ours = preset_outputs[config]
    cfg = get_model("fullres_occfill", max_disp=15, **CONFIGS[config])
    lrc = refine.lr_consistency_classify(ours["disp_left_raw"], ours["disp_right_raw"],
                                         cfg.num_disp, cfg.lr_max_diff, cfg.disp_occ,
                                         cfg.disp_mis)
    assert (lrc == OCC).any() and (lrc == MIS).any()
    assert (ours["disparity"] >= 0).all()


def test_fullres_occfill_is_supported_with_its_kernels():
    for kw in CONFIGS.values():
        cfg = get_model("fullres_occfill", max_disp=255, **kw)
        check_supported(cfg)
        assert kernels_launched(cfg) == ["arms_grow", "arm_taps", "sgm_scan", "wta",
                                         "region_vote", "pi_scan"]
    # the KITTI fill (ROADMAP §1 item 6) runs, with the same kernels, and a frame runs
    kitti = get_model("fullres_occfill", max_disp=7, bg_ipol_kitti=True)
    check_supported(kitti)
    assert kernels_launched(kitti) == ["arms_grow", "arm_taps", "sgm_scan", "wta",
                                       "region_vote", "pi_scan"]
    out = StereoPipeline(kitti, device="cpu")(np.zeros((8, 12, 3), np.uint8),
                                              np.zeros((8, 12, 3), np.uint8))
    assert tuple(out["disparity"].shape) == (8, 12)
    for bad in (dict(d_stream_block=32, cbca_double_win=True),
                dict(d_stream_block=32, cost="bt"),
                dict(bg_ipol_kitti=True, d_stream_block=32, cost="zncc"),
                dict(vol_dtype="float16")):
        with pytest.raises(NotImplementedError):
            check_supported(get_model("fullres_occfill", max_disp=255, **bad))
