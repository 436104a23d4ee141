"""The box sums, ZNCC, the box filter and the guided filter against the JAX package, on the CPU.

``_box_sum`` takes its integral images in XLA-CPU's order of adds (a
blocked scan, ``cost.cumsum_blocked``), so it equals JAX's bit for bit at
every shape here, axes of more than 256 (two levels of blocks) included,
where ``torch.cumsum`` does not. ``zncc_volume``, ``box_filter_volume`` and
the gray and colour guided filters equal the JAX functions run op by op
bit for bit, NaNs included: a flat patch makes ZNCC's squared deviation
round below 0 (jitted, XLA-CPU contracts products into FMAs and divides by
a constant through its reciprocal, so its volumes differ by an ULP here
and there; the maps below do not). Then the presets ``ad_grad_gf`` and
``zncc_bf_wta`` end to end at 48x64, D=16, on a synthetic and an
adversarial scene against the jitted JAX ``match_pair``, one jit a preset,
``ad_grad_gf`` with ``tests/test_torch_vmtop.py``'s narrowed windows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu.ops import aggregation as jax_aggregation
from mystereomatching_tpu.ops import cost as jax_cost
from mystereomatching_tpu.ops import guided as jax_guided

from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import aggregation, cost, guided, wta
from mystereomatching_tpu_torch.pipeline import check_supported, kernels_launched
from test_torch_vmtop import KEYS, NARROW, SCENES, check_maps, jax_and_port_maps, make_scenes

D = 16
NO_WINDOWS = {}


def _equal_with_nans(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


def _plane(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "squares":          # the integral images of ZNCC's sum of squares
        return (rng.integers(0, 256, shape).astype(np.float32)) ** 2
    return rng.normal(0, 100, shape).astype(np.float32)


# (shape, window): the gray planes and the D-stacks of ZNCC's three box
# sums (full and asymmetric windows) and of the box filter, at the test
# scenes' 48x64 and the card's 375x450, and axes of 300 and 700 (two levels
# of 16-blocks: more than 256 elements)
BOX_CASES = [((48, 64), (3, 4)), ((D, 48, 64), (3, 4, -3, 2, -4, 3)),
             ((D, 48, 64), (6, 6, -5, 6, -5, 6)), ((375, 450), (3, 4)),
             ((2, 375, 450), (3, 4, -3, 2, -4, 3)), ((3, 300, 20), (9, 9)),
             ((2, 20, 700), (9, 9))]


@pytest.mark.parametrize("shape,window", BOX_CASES)
def test_box_sum_exact(shape, window):
    """Both kinds of plane through one jit of JAX's _box_sum (adds and
    subtractions only, which XLA-CPU leaves as they are)."""
    fn = jax.jit(lambda a: jax_cost._box_sum(a, *window))
    for kind in ("squares", "normal"):
        x = _plane(shape, kind)
        got = cost._box_sum(torch.from_numpy(x), *window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(fn(jnp.asarray(x))))


def test_cumsum_blocked_is_not_torch_cumsum():
    """The order matters: torch.cumsum's integral image of the same plane
    differs from JAX's (and the blocked one's) in many places."""
    x = torch.from_numpy(_plane((375, 450), "squares"))
    want = np.asarray(jnp.cumsum(jnp.cumsum(jnp.asarray(x.numpy()), -1), -2))
    ours = cost.cumsum_blocked(cost.cumsum_blocked(x, -1), -2).numpy()
    np.testing.assert_array_equal(ours, want)
    assert (torch.cumsum(torch.cumsum(x, -1), -2).numpy() != want).sum() > 1000


@pytest.fixture(scope="module")
def flat_grays():
    """A textured pair with a flat patch (seen in both views) in its lower
    right, where the integral images are large and round."""
    rng = np.random.default_rng(4)
    gl = rng.integers(0, 256, (48, 64)).astype(np.float32)
    gl[24:, 32:] = 251.0
    gr = np.roll(gl, -3, 1).copy()
    return gl, gr


@pytest.mark.parametrize("lor", [0, 1])
def test_zncc_volume_with_a_flat_patch(flat_grays, lor):
    """NaN where the flat patch's squared deviation rounds below 0, at the
    same entries as JAX's, and the WTA takes the first NaN as jnp.argmin
    does."""
    gl, gr = flat_grays
    want = jax_cost.zncc_volume(jnp.asarray(gl), jnp.asarray(gr), D, lor)
    got = cost.zncc_volume(torch.from_numpy(gl), torch.from_numpy(gr), D, lor)
    _equal_with_nans(got, want)
    assert np.isnan(np.asarray(want)).sum() > 100
    np.testing.assert_array_equal(wta.wta_plain(got).numpy(),
                                  np.asarray(jnp.argmin(want, 0)))


@pytest.mark.parametrize("radius", [6])
def test_box_filter_volume(flat_grays, radius):
    gl, gr = flat_grays
    vol = np.array(jax_cost.zncc_volume(jnp.asarray(gl), jnp.asarray(gr), D, 0))
    want = jax_aggregation.box_filter_volume(jnp.asarray(vol), radius)
    _equal_with_nans(aggregation.box_filter_volume(torch.from_numpy(vol), radius), want)


@pytest.fixture(scope="module")
def gf_inputs():
    rng = np.random.default_rng(5)
    vol = rng.random((D, 48, 64)).astype(np.float32)
    img = rng.integers(0, 256, (48, 64, 3)).astype(np.float32)
    img[:20, :24] = (40.0, 90.0, 200.0)             # a flat colour: near-singular windows
    return vol, img


@pytest.mark.parametrize("guide,radius,eps", [("color", 9, 1e-4), ("gray", 9, 1e-4),
                                              ("color", 3, 1e-2)])
def test_guided_filter_volume(gf_inputs, guide, radius, eps):
    vol, img = gf_inputs
    g = img if guide == "color" else img[..., 1].copy()
    want = jax_guided.guided_filter_volume(jnp.asarray(vol), jnp.asarray(g), radius, eps)
    got = guided.guided_filter_volume(torch.from_numpy(vol), torch.from_numpy(g), radius, eps)
    _equal_with_nans(got, want)


def test_box_means_exact(gf_inputs):
    """The two box means alone, at the guided filters' radius (whose ops the
    tests above have run already)."""
    vol, _ = gf_inputs
    t, j = torch.from_numpy(vol), jnp.asarray(vol)
    np.testing.assert_array_equal(guided._box_mean(t, 9).numpy(),
                                  np.asarray(jax_guided._box_mean(j, 9)))
    np.testing.assert_array_equal(guided._box_mean_cv(t, 9).numpy(),
                                  np.asarray(jax_guided._box_mean_cv(j, 9)))


def test_kernels_of_the_filter_frames():
    assert kernels_launched(get_model("ad_grad_gf")) == ["arms_grow", "wta", "region_vote",
                                                         "pi_scan"]
    assert kernels_launched(get_model("zncc_bf_wta")) == ["wta"]
    for name in ("ad_grad_gf", "zncc_bf_wta"):
        check_supported(get_model(name))


@pytest.fixture(scope="module")
def scenes():
    return make_scenes()


@pytest.fixture(scope="module", params=[("ad_grad_gf", NARROW), ("zncc_bf_wta", NO_WINDOWS)],
                ids=["ad_grad_gf", "zncc_bf_wta"])
def preset_maps(request, scenes):
    name, narrow = request.param
    return jax_and_port_maps(name, scenes, narrow)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("key", KEYS)
def test_preset_matches_jax(preset_maps, scene, key):
    ref, _ = preset_maps[scene]
    if key not in ref:      # zncc_bf_wta has no LR check, so no right map
        assert key == "disp_right_raw"
        return
    check_maps(preset_maps, scene, key)
