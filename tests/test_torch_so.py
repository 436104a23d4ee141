"""The BT cost and scanline optimisation against the JAX package, on the CPU.

``bt_volume`` (with ``_nei_max_min``'s border quirks) equals the JAX
function bit for bit, run op by op and jitted, on the gray images and in
colour. SO (``_so_core``, ``scanline_optimize`` in its three modes and
``scanline_optimize_change``) gives the jitted JAX functions' disparities
bit for bit on JAX's own volume passed in as numpy: a BT volume of a scene
with flat rows, whose many equal costs exercise the first-argmin ties and
the strict priority chain, and a volume of a few cost levels. Then the
preset ``bt_so`` end to end at 48x64, D=16, on a synthetic and an
adversarial scene against the jitted JAX ``match_pair`` (one jit), with
``tests/test_torch_vmtop.py``'s narrowed windows: 0 px.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.models import get_model as jax_get_model
from mystereomatching_tpu.ops import cost as jax_cost
from mystereomatching_tpu.ops import so as jax_so

from mystereomatching_tpu_torch.config import as_port_config
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import cost, so
from mystereomatching_tpu_torch.pipeline import apply_sub_ipol, check_supported, kernels_launched
from test_torch_vmtop import KEYS, SCENES, check_maps, jax_and_port_maps, make_scenes

D = 16


def _flat_row_pair(seed=3, h=24, w=40):
    """A textured pair (the right view shifted 3 columns) whose rows 5-9
    and columns 20-27 are flat: BT costs of 0 at many disparities."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    left[5:10] = 120.0
    left[:, 20:28] = 64.0
    right = np.roll(left, -3, axis=1)
    return left, right


def _gray(img):
    return np.array(jax_pipeline.to_gray(jnp.asarray(img)))


@pytest.mark.parametrize("color", [False, True], ids=["gray", "color"])
@pytest.mark.parametrize("lor", [0, 1])
def test_bt_volume_exact(lor, color):
    left, right = _flat_row_pair()
    if not color:
        left, right = _gray(left), _gray(right)
    eager = jax_cost.bt_volume(jnp.asarray(left), jnp.asarray(right), D, lor, 20.0)
    jitted = jax.jit(lambda a, b: jax_cost.bt_volume(a, b, D, lor, 20.0))(left, right)
    got = cost.bt_volume(torch.from_numpy(left), torch.from_numpy(right), D, lor, 20.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(eager))
    np.testing.assert_array_equal(got, np.asarray(jitted))
    assert (got == 0).any() and (got == 20.0).any()


def test_nei_max_min_borders_exact():
    g = np.random.default_rng(1).integers(0, 256, (3, 5, 9)).astype(np.float32)
    for got, want in zip(cost._nei_max_min(torch.from_numpy(g)),
                         jax_cost._nei_max_min(jnp.asarray(g))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def so_inputs():
    """JAX's own volumes as numpy, with the images that guide them: the BT
    volume of the flat-row pair (lor 0), and a volume of 4 cost levels."""
    left, right = _flat_row_pair()
    bt = np.array(jax_cost.bt_volume(jnp.asarray(_gray(left)), jnp.asarray(_gray(right)),
                                       D, 0, 20.0))
    rng = np.random.default_rng(7)
    levels = rng.integers(0, 4, bt.shape).astype(np.float32) * 0.6
    return {"bt": bt, "levels": levels}, left


JCFG = jax_get_model("bt_so", max_disp=D - 1)


@functools.lru_cache(maxsize=None)
def _jax_so(mode):
    """The jitted JAX scanline_optimize in ``mode`` (``"change"``:
    scanline_optimize_change), compiled once for both volumes."""
    if mode == "change":
        return jax.jit(lambda v, im, r: jax_so.scanline_optimize_change(v, im, r, JCFG))
    return jax.jit(lambda v, im: jax_so.scanline_optimize(v, im, JCFG, mode))


@pytest.mark.parametrize("mode", ["l2r", "r2l", "t2b"])
@pytest.mark.parametrize("vol_name", ["bt", "levels"])
def test_scanline_optimize_exact(so_inputs, vol_name, mode):
    vols, left = so_inputs
    vol = vols[vol_name]
    want = _jax_so(mode)(vol, left)
    got = so.scanline_optimize(torch.from_numpy(vol), torch.from_numpy(left),
                               as_port_config(JCFG), mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_so_core_ties_take_the_first_argmin():
    """All-equal costs: every step's candidates tie, so the DP keeps d and
    the backtrace the last column's first argmin, 0, everywhere."""
    vol = np.ones((D, 4, 9), np.float32)
    disc = np.zeros((4, 9), bool)
    want = jax.jit(lambda v, c: jax_so._so_core(v, c, 1.2, 3.6))(vol, disc)
    got = so._so_core(torch.from_numpy(vol), torch.from_numpy(disc), 1.2, 3.6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()


@pytest.mark.parametrize("vol_name", ["bt", "levels"])
def test_scanline_optimize_change_exact(so_inputs, vol_name):
    vols, left = so_inputs
    vol = vols[vol_name]
    ref = np.argmin(vol, 0).astype(np.int32)
    ref[::3] += 2            # a prior that is not the volume's own argmin, past D-1 too
    want = _jax_so("change")(vol, left, ref)
    got = so.scanline_optimize_change(torch.from_numpy(vol), torch.from_numpy(left),
                                      torch.from_numpy(ref), as_port_config(JCFG))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@jax.jit
def _jax_discontinuities(im, thres):
    return jnp.mean(jnp.abs(im - jnp.roll(im, 1, 1)), -1) > thres


@pytest.mark.parametrize("thres", [15, 40, 100])
def test_discontinuities_exact(thres):
    """The channel mean against the threshold, as the jitted jnp.mean
    computes it (times the float32 reciprocal of 3)."""
    rng = np.random.default_rng(thres)
    img = rng.integers(0, 256, (16, 40, 3)).astype(np.float32)
    img[:, ::2] = img[:, 1::2] + rng.integers(-60, 61, (16, 20, 3))
    want = _jax_discontinuities(img, np.float32(thres))
    got = so.discontinuities(torch.from_numpy(img), thres)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_bt_so_frame_kernels_and_no_sub_ipol():
    cfg = get_model("bt_so")
    check_supported(cfg)
    assert kernels_launched(cfg) == ["arms_grow", "arm_taps", "region_vote", "pi_scan"]
    d = torch.randint(0, D, (6, 7), dtype=torch.int32)
    assert apply_sub_ipol(d, d, torch.rand(D, 6, 7), cfg.replace(sub_ipol=True)) is d


@pytest.fixture(scope="module")
def preset_maps():
    return jax_and_port_maps("bt_so", make_scenes())


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("key", KEYS)
def test_preset_matches_jax(preset_maps, scene, key):
    check_maps(preset_maps, scene, key)
