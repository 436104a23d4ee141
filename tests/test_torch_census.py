"""The census cost family and aggregation "none" against the JAX package, on the CPU.

The six census codes (``census_func`` 0-5), compared bit by bit (the JAX
package packs 32 bits a uint32 word, the port 64 a int64 word); the
``census`` and ``ad_census`` cost volumes, whole and in disparity blocks;
and the presets ``ad_census_wta``, ``census_wta`` and ``census_cbca_lrc``
through ``match_pair`` against the jitted JAX ``match_pair``, one jit a
preset. The codes, the ``census`` volumes and the presets' maps are
exact; the ``ad_census`` volumes lie within 1e-6 of JAX's, because
torch's ``exp`` differs from XLA-CPU's by an ULP on some inputs (as for
``census_grad``, ``tests/test_torch_cost.py::test_exp_fuse2``), and its
blocks equal the port's dense volume exactly. Then the port alone: the
default preset holds the reference binary's adversarial golden
(``tests/golden/adv_small_*.bin``) at 0/0 px, and the streamed "none"
volume equals the dense one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import models as jax_models
from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.config import default_config as jax_default_config
from mystereomatching_tpu.ops import cost as jax_cost

import mystereomatching_tpu_torch as port
from mystereomatching_tpu_torch.config import as_port_config
from mystereomatching_tpu_torch.data import make_adversarial_pair, make_synthetic_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import cost
from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.pipeline import check_supported, compute_volumes, kernels_launched

D = 16
PRESETS = ("ad_census_wta", "census_wta", "census_cbca_lrc")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _bits(words: np.ndarray, per_word: int) -> np.ndarray:
    """[n_words, H, W] packed codes -> [n_words * per_word, H, W] 0/1 planes,
    bit i of the code at plane i."""
    u = words.view(np.uint64 if per_word == 64 else np.uint32)
    return np.stack([(u[i // per_word] >> u.dtype.type(i % per_word)) & 1
                     for i in range(per_word * u.shape[0])]).astype(np.uint8)


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(10)
    return {"scene": rng.integers(0, 256, (40, 56)).astype(np.float32),
            # four gray levels: many equal neighbours, where < and <= differ
            "ties": rng.integers(0, 4, (40, 56)).astype(np.float32)}


@pytest.mark.parametrize("plane", ["scene", "ties"])
@pytest.mark.parametrize("rv,ru", [(3, 4), (2, 2)])
@pytest.mark.parametrize("func", range(6))
def test_census_code_exact(planes, plane, rv, ru, func):
    gray = planes[plane]
    want_fn, want_n = jax_cost._census_code_fn(func, rv, ru)
    got_fn, got_n = cost._census_code_fn(func, rv, ru)
    assert got_n == want_n
    want = _bits(np.asarray(want_fn(jnp.asarray(gray))), 32)
    got = _bits(got_fn(torch.from_numpy(gray)).numpy(), 64)
    np.testing.assert_array_equal(got[:got_n], want[:want_n])
    assert not want[want_n:].any() and not got[got_n:].any()


@pytest.fixture(scope="module")
def scene():
    pair = make_synthetic_pair(h=40, w=56, max_disp=D - 1, seed=7, noise_sigma=0.5)
    imgs = [img.astype(np.float32) for img in (pair.left, pair.right)]
    grays = [np.asarray(jax_pipeline.to_gray(jnp.asarray(img))) for img in imgs]
    return imgs, grays


def assert_cost_equal(got, want, name):
    """Exact for census; for ad_census within 1e-6, a few ULPs of its
    [0, 2] range: torch's exp and XLA-CPU's differ by an ULP on some inputs."""
    if name == "ad_census":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _volumes(scene, overrides, lor, ds=None):
    """(JAX volume, port volume) of one view: whole (``ds`` None) or the
    block of disparities ``ds``."""
    (left, right), (gl, gr) = scene
    jcfg = jax_default_config(max_disp=D - 1, aggregation="none", **overrides)
    cfg = as_port_config(jcfg)
    jargs = [jnp.asarray(a) for a in (left, right, gl, gr)]
    gl, gr = gl.copy(), gr.copy()  # writable, for torch.from_numpy
    targs = [torch.from_numpy(a) for a in (left, right, gl, gr)]
    if ds is None:
        return (np.asarray(jax_cost.compute_cost_volume(*jargs, jcfg, lor)),
                cost.compute_cost_volume(*targs, cfg, lor).numpy())
    jblock = jax_cost.block_cost_builder(*jargs, jcfg, lor)(jnp.asarray(ds, jnp.int32))
    return (np.asarray(jblock),
            cost.block_cost_builder(*targs, cfg, lor)(torch.tensor(ds)).numpy())


COST_CASES = [dict(cost="census"), dict(cost="ad_census"),
              dict(cost="census", is_census_norm=True),
              dict(cost="census", census_trunc_ratio=0.5, is_census_norm=True),
              dict(cost="ad_census", census_func=5)]


@pytest.mark.parametrize("lor", [0, 1])
@pytest.mark.parametrize("overrides", COST_CASES)
def test_cost_volume_matches_jax(scene, overrides, lor):
    want, got = _volumes(scene, overrides, lor)
    assert got.shape == (D,) + scene[1][0].shape
    assert_cost_equal(got, want, overrides["cost"])


@pytest.mark.parametrize("func", range(6))
def test_census_volume_of_each_code_exact(scene, func):
    want, got = _volumes(scene, dict(cost="census", census_func=func), 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lor", [0, 1])
@pytest.mark.parametrize("name", ["census", "ad_census"])
def test_cost_blocks_match_jax(scene, name, lor):
    _, dense = _volumes(scene, dict(cost=name), lor)
    for d0 in range(0, D, 4):
        ds = list(range(d0, d0 + 4))
        want, got = _volumes(scene, dict(cost=name), lor, ds)
        assert_cost_equal(got, want, name)
        np.testing.assert_array_equal(got, dense[d0:d0 + 4])


@pytest.fixture(scope="module")
def preset_outputs():
    """Each preset on a 48x64 pair with D=16: the jitted JAX match_pair's
    maps (one jit a preset) and the port's, on the CPU."""
    pair = make_synthetic_pair(h=48, w=64, max_disp=D - 1, seed=5, noise_sigma=0.5)
    out = {}
    ck.reset_launches()
    for name in PRESETS:
        jcfg = jax_models.get_model(name, max_disp=D - 1)
        ref = jax.jit(lambda l, r, c=jcfg: jax_pipeline.match_pair(l, r, c))(
            jnp.asarray(pair.left), jnp.asarray(pair.right))
        ours = port.StereoPipeline(get_model(name, max_disp=D - 1), device="cpu")(
            pair.left, pair.right)
        out[name] = ({k: np.asarray(v) for k, v in ref.items()}, ours)
    assert sum(ck.launches.values()) == 0
    return out


@pytest.mark.parametrize("key", ["disparity", "disp_left_raw", "disp_right_raw"])
@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax(preset_outputs, name, key):
    ref, ours = preset_outputs[name]
    assert set(ours) == set(ref)
    if key not in ref:
        assert name != "census_cbca_lrc"  # the only one with an LR check
        return
    assert ours[key].dtype == (torch.float32 if key == "disparity" else torch.int32)
    np.testing.assert_array_equal(ours[key].numpy(), ref[key])


def test_presets_are_supported_with_their_kernels():
    for name in PRESETS:
        check_supported(get_model(name))
    assert kernels_launched(get_model("ad_census_wta")) == ["wta"]
    assert kernels_launched(get_model("census_wta")) == ["wta"]
    assert kernels_launched(get_model("census_cbca_lrc")) == ["arms_grow", "arm_taps", "wta"]
    # no aggregation with a region vote reads the left image's arms
    cfg = get_model("ad_census_wta").replace(do_refine=True, do_lr_consis=True,
                                             do_region_vote=True)
    assert kernels_launched(cfg) == ["arms_grow", "wta", "region_vote", "pi_scan"]
    # the census costs of ROADMAP §1 item 5 under census_wta: ad_census_grad
    # reads the arms for its gradient's adaptive weight
    assert kernels_launched(get_model("census_wta").replace(cost="census_from2")) == ["wta"]
    assert kernels_launched(get_model("census_wta").replace(cost="ad_census_grad")) == [
        "arms_grow", "wta"]
    for name in ("census_from2", "ad_census_grad"):
        check_supported(get_model("census_wta").replace(cost=name))
        check_supported(get_model("census_wta").replace(cost=name, d_stream_block=4))


@pytest.mark.parametrize("bad", [dict(aggregation="nl", d_stream_block=4),
                                 dict(cost="ssd", d_stream_block=4), dict(cost="qx_census"),
                                 dict(cost="ad_census_zncc", d_stream_block=4)])
def test_census_refusals(bad):
    """NL aggregation of a census cost streamed over disparity blocks (the
    JAX package has no streamed NL either; unstreamed, NL over the census
    costs runs: tests/test_torch_nl.py::test_nl_accepts), the NL flow's
    census under aggregation "none", and the costs with no block form
    streamed (``ssd`` and ``ad_census_zncc``: the JAX block builder refuses
    them too) are refused. census_from2 and ad_census_grad, refused here
    before, run (test_presets_are_supported_with_their_kernels)."""
    with pytest.raises(NotImplementedError):
        check_supported(get_model("census_wta").replace(**bad))


@pytest.mark.parametrize("name", ["ad_census_wta", "census_cbca_lrc"])
def test_streamed_volume_is_the_dense_one(name):
    """With ``d_stream_block`` the "none" volume is the cost alone, each
    block's planes the dense volume's."""
    pair = make_synthetic_pair(h=24, w=40, max_disp=D - 1, seed=2, noise_sigma=0.5)
    left, right = (torch.from_numpy(img.astype(np.float32)) for img in (pair.left, pair.right))
    cfg = get_model(name, max_disp=D - 1)
    dense, _ = compute_volumes(left, right, cfg)
    streamed, _ = compute_volumes(left, right, cfg.replace(d_stream_block=4))
    assert sorted(dense) == sorted(streamed)
    for lor in dense:
        assert torch.equal(streamed[lor], dense[lor])


def _golden(scene: str, kind: str) -> np.ndarray:
    with open(os.path.join(GOLDEN, f"{scene}_{kind}.bin"), "rb") as f:
        h, w = np.frombuffer(f.read(8), np.int32)
        return np.frombuffer(f.read(), np.int16).reshape(h, w).astype(np.int32)


def test_default_preset_holds_adv_small():
    """The reference binary's adversarial scene (slanted planes, non-integer
    ground truth): the port's WTA and final maps at 0 px, the JAX package's
    budgets (tests/test_reference_golden.py::test_adversarial_scene_matches_reference_binary)."""
    pair = make_adversarial_pair(name="adv_small", h=144, w=192, max_disp=23, seed=3)
    out = port.StereoPipeline(get_model("census_grad_cbca_sgm", max_disp=23), device="cpu")(
        pair.left, pair.right)
    final = torch.round(out["disparity"]).to(torch.int32).numpy()
    assert int((out["disp_left_raw"].numpy() != _golden("adv_small", "wta")).sum()) == 0
    assert int((final != _golden("adv_small", "final")).sum()) == 0
