"""The port's ``sgm8_full`` preset against the JAX package's, on the CPU.

The diagonal SGM scan, the 8-path sum, the uniqueness check, the two
quadratic subpixel fits and the whole preset (8-path SGM, uniqueness,
subpixel enhancement, and ``sub_ipol`` when ``do_subpixel`` is off). Both
sides get the same numpy arrays, made from a seed. Every comparison is
exact (``assert_array_equal``), the float subpixel maps included: the
port keeps the JAX CPU path's operation order, eager and under ``jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import models as jax_models
from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.ops import refine as jax_refine
from mystereomatching_tpu.ops import sgm as jax_sgm
from mystereomatching_tpu.ops import wta as jax_wta

import mystereomatching_tpu_torch as port
from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops import refine, sgm, wta
from mystereomatching_tpu_torch.pipeline import kernels_launched

DIAGONALS = [(1, -1), (1, 1), (-1, 1), (-1, -1)]
# the small sizes of tests/test_sharding.py's sgm8_full case
SMALL = dict(max_disp=7, census_rv=2, census_ru=3, cbca_cross_l=3, cbca_cross_l_out=5,
             pi_search_depth=4, rv_s_thres=4)


def _image(rng, h, w):
    """Colours 0..39, so that about half the neighbour differences exceed
    the penalty threshold of 15."""
    return rng.integers(0, 40, (h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("shape", [(21, 30), (30, 7), (1, 9), (9, 1)])
@pytest.mark.parametrize("rv,ru", DIAGONALS)
def test_sgm_diag_scan_plain_matches_scan_direction(shape, rv, ru):
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    vol = (rng.random((5,) + shape) * 3).astype(np.float32)
    img = _image(rng, *shape)
    want = jax_sgm.scan_direction(jnp.asarray(vol), jnp.asarray(img), rv, ru, 1.0, 3.0, 15, 4.0)
    ps = sgm.penalty_scale(torch.from_numpy(img), rv, ru, 15, 4.0)
    got = sgm.sgm_diag_scan_plain(torch.from_numpy(vol)[None], ps[None], 1.0, 3.0, rv, ru)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sgm_multi_8_matches_jax():
    rng = np.random.default_rng(8)
    vols = [(rng.random((5, 17, 23)) * 3).astype(np.float32) for _ in range(2)]
    imgs = [_image(rng, 17, 23) for _ in range(2)]
    want = jax_sgm.sgm_multi([jnp.asarray(v) for v in vols], [jnp.asarray(i) for i in imgs],
                             8, 1.0, 3.0, 15, 4.0)
    got = sgm.sgm_multi([torch.from_numpy(v) for v in vols],
                        [torch.from_numpy(i) for i in imgs], 8, 1.0, 3.0, 15, 4.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _decision_inputs():
    """A volume with integer costs (many ties), its argmin, and a map with
    disparities 0 and D-1 and the sentinels -1, -16 and -32 mixed in."""
    rng = np.random.default_rng(5)
    vol = rng.integers(0, 6, (9, 13, 17)).astype(np.float32)
    vol[:, :, :3] += rng.random((9, 13, 3)).astype(np.float32)  # and some fractions
    disp = np.argmin(vol, 0).astype(np.int32)
    r = rng.random(disp.shape)
    disp = np.select([r < 0.1, r < 0.2, r < 0.25, r < 0.3, r < 0.35],
                     [0, 8, -1, -16, -32], disp).astype(np.int32)
    return vol, disp


def test_uniqueness_mask_matches_jax():
    vol, disp = _decision_inputs()
    want = np.asarray(jax_wta.uniqueness_mask(jnp.asarray(vol), jnp.asarray(disp), 0.95))
    got = wta.uniqueness_mask(torch.from_numpy(vol), torch.from_numpy(disp), 0.95)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fit", ["subpixel_quadratic", "subpixel_enhance"])
def test_subpixel_fits_match_jax(fit):
    vol, disp = _decision_inputs()
    if fit == "subpixel_quadratic":
        want = jax_wta.subpixel_quadratic(jnp.asarray(vol), jnp.asarray(disp))
        got = wta.subpixel_quadratic(torch.from_numpy(vol), torch.from_numpy(disp))
    else:
        want = jax_refine.subpixel_enhance(jnp.asarray(disp), jnp.asarray(vol))
        got = refine.subpixel_enhance(torch.from_numpy(disp), torch.from_numpy(vol))
    want = np.asarray(want)
    assert got.dtype == torch.float32
    assert (want % 1 != 0).any()  # some offsets were applied
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def preset_outputs():
    """sgm8_full at small sizes, as it is and with do_subpixel=False, in both
    packages; one JAX jit for both configurations."""
    pair = make_synthetic_pair(h=40, w=56, max_disp=7, seed=5)
    jcfgs = [jax_models.get_model("sgm8_full", **SMALL)]
    jcfgs.append(jcfgs[0].replace(do_subpixel=False))
    fn = jax.jit(lambda l, r: [jax_pipeline.match_pair(l, r, c) for c in jcfgs])
    refs = jax.tree.map(np.asarray, fn(jnp.asarray(pair.left), jnp.asarray(pair.right)))
    ck.reset_launches()
    ours = [port.StereoPipeline(get_model("sgm8_full", **SMALL, do_subpixel=sub),
                                device="cpu")(pair.left, pair.right) for sub in (True, False)]
    launched = sum(ck.launches.values())
    return dict(zip(("as_is", "no_subpixel"), zip(refs, ours))), launched


@pytest.mark.parametrize("key", ["disp_left_raw", "disp_right_raw", "disparity"])
@pytest.mark.parametrize("variant", ["as_is", "no_subpixel"])
def test_sgm8_full_matches_jax(preset_outputs, variant, key):
    ref, ours = preset_outputs[0][variant]
    assert ours[key].numpy().dtype == ref[key].dtype
    np.testing.assert_array_equal(ours[key].numpy(), ref[key])


def test_sgm8_full_exercises_its_stages(preset_outputs):
    """The small pair reaches every stage the preset adds: uniqueness
    failures (DISP_INV) in the raw map, fractional disparities from
    subpixel enhancement and from sub_ipol, and no kernel on the CPU."""
    outs, launched = preset_outputs
    ref, _ = outs["as_is"]
    assert (ref["disp_left_raw"] == -16).any()
    for variant in ("as_is", "no_subpixel"):
        assert (outs[variant][0]["disparity"] % 1 != 0).any()
    assert launched == 0


def test_kernels_launched_per_preset():
    assert "sgm_diag" in kernels_launched(get_model("sgm8_full"))
    assert kernels_launched(port.default_config()) == [
        "arms_grow", "arm_taps", "sgm_scan", "wta", "region_vote", "pi_scan"]
    assert kernels_launched(port.default_config(do_refine=False)) == [
        "arms_grow", "arm_taps", "sgm_scan", "wta"]
