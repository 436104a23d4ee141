"""The remaining costs and the multilevel and adaptive arms against the JAX package, on the CPU.

At 48x64, D=16, from a seeded synthetic pair: the cost volumes of ``ad``,
``sd``, ``grad`` (every mode), ``ssd``, ``census_from2`` (both blends),
``ad_census_grad`` and ``ad_census_zncc`` of both views against the
jitted JAX ``compute_cost_volume`` (one jit a cost, both views), and the
block forms (``block_cost_builder(...)(ds)``) against the port's dense
planes; ``grad_volume`` in each mode, ``ad_volume`` with ``squared`` and
``normalize``, ``exp_fuse3`` and ``grad_mag_phase_volume`` against the
jitted JAX functions; the two new arm schedules bit for bit against the
JAX ``build_arms`` (jitted: on the CPU it takes the plain path, not the
Pallas kernel). Each tolerance is stated where it is used: the port
rounds the new costs as jitted XLA-CPU does (products with float32
reciprocals for divisions by constants, fused multiply-adds), except for
``exp``, where it takes ``cost.exp32`` (correctly rounded; XLA's float32
``exp`` is within an ULP of it), and for the terms it shares with the
older costs (the adaptive gradient's blend, ZNCC), which round as the
JAX functions do op by op. Then two configurations end to end against
the jitted JAX ``match_pair`` on a synthetic and an adversarial scene
(one jit each): ``ad_census_grad`` with adaptive arms and the default
refine chain, and ``ad_census_zncc`` under no aggregation with WTA; the
port's three maps equal JAX's at 0 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu.config import default_config as jax_default_config
from mystereomatching_tpu.ops import arms as jax_arms
from mystereomatching_tpu.ops import cost as jax_cost

from mystereomatching_tpu_torch.config import as_port_config, default_config
from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import arms, cost
from mystereomatching_tpu_torch.pipeline import (check_supported, kernels_launched,
                                                 match_pair_nl_batch, to_gray)

from test_torch_vmtop import KEYS, NARROW, SCENES, check_maps, jax_and_port_maps, make_scenes

D = 16
# the costs of this slice: name -> (configuration overrides, tolerance kind)
#   exact: bit for bit;
#   fma:   the adaptive gradient's a*cx + (1-a)*cy, which the port rounds
#          product by product as the JAX function does op by op and jitted
#          XLA-CPU contracts into an FMA: within 1e-6 relative (an ULP);
#   exp:   a float32 exp, which XLA computes within an ULP of exp32: within
#          2e-6 absolute on costs in [0, 3] (a few ULPs there)
COSTS = {
    "ad": (dict(cost="ad"), "exact"),
    "sd": (dict(cost="sd"), "exact"),
    "grad": (dict(cost="grad"), "fma"),
    "grad_sum": (dict(cost="grad", grad_fuse_adaptive=False), "exact"),
    "grad_1dir": (dict(cost="grad", grad_use_2dir=False), "exact"),
    "grad_1dir_norm": (dict(cost="grad", grad_use_2dir=False, is_grad_norm=True), "exact"),
    "ssd": (dict(cost="ssd"), "exact"),
    "census_from2": (dict(cost="census_from2"), "exp"),
    "census_from2_first": (dict(cost="census_from2", census_from2_blend="first",
                                census_trunc_ratio=0.6), "exact"),
    "ad_census_grad": (dict(cost="ad_census_grad"), "exp"),
    "ad_census_zncc": (dict(cost="ad_census_zncc"), "exp"),
}
DENSE_ONLY = ("ssd", "ad_census_zncc")


def assert_close(got, want, kind):
    if kind == "exact":
        np.testing.assert_array_equal(got, want)
    elif kind == "fma":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def scene():
    """Images, grays and both images' two-level arms (the JAX arms, bit for
    bit: tests/test_torch_cost.py::test_cross_arms_exact)."""
    p = make_synthetic_pair(h=48, w=64, max_disp=D - 1, seed=0)
    imgs = [torch.from_numpy(x.astype(np.float32)) for x in (p.left, p.right)]
    grays = [to_gray(x) for x in imgs]
    arms_pair = [arms.cross_arms(x) for x in imgs]
    return imgs, grays, arms_pair


@pytest.fixture(scope="module")
def jax_volumes(scene):
    """name -> both views' JAX volumes of that cost, one jit a cost."""
    (left, right), (gl, gr), arms_pair = scene
    args = [jnp.asarray(t.numpy()) for t in (left, right, gl, gr, *arms_pair)]
    cache = {}

    def get(name):
        if name == "ad_census_zncc":
            return _ad_census_zncc(args, cache)
        if name not in cache:
            jcfg = jax_default_config(max_disp=D - 1, aggregation="none", **COSTS[name][0])
            fn = jax.jit(lambda *a: tuple(
                jax_cost.compute_cost_volume(*a[:4], jcfg, lor, arms=a[4 + lor])
                for lor in (0, 1)))
            cache[name] = [np.asarray(v) for v in fn(*args)]
        return cache[name]

    return get


def _ad_census_zncc(args, cache):
    """ad_census_zncc's JAX volumes with the ZNCC term of the JAX function
    run op by op, as the port's ZNCC rounds (jitted XLA-CPU contracts
    ZNCC's products, which moves the fused volume by up to 1.4e-5), the
    rest jitted: census, AD and exp_fuse3."""
    if "ad_census_zncc" not in cache:
        jcfg = jax_default_config(max_disp=D - 1, aggregation="none", cost="census")
        left, right, gl, gr = args[:4]
        fuse = jax.jit(lambda c, z, a: jax_cost.exp_fuse3(c, z, a, jcfg.lam_cen, 1.0, 10.0))
        parts = jax.jit(lambda *a: tuple(
            (jax_cost.compute_cost_volume(*a, jcfg, lor),
             jax_cost.ad_volume(a[0], a[1], D, lor, trunc=1e9)) for lor in (0, 1)))(*args[:4])
        cache["ad_census_zncc"] = [
            np.asarray(fuse(census, jax_cost.zncc_volume(gl, gr, D, lor, jcfg.zncc_win_rv,
                                                         jcfg.zncc_win_ru), ad))
            for lor, (census, ad) in enumerate(parts)]
    return cache["ad_census_zncc"]


def _port_cfg(name):
    return default_config(max_disp=D - 1, aggregation="none", **COSTS[name][0])


@pytest.mark.parametrize("lor", [0, 1])
@pytest.mark.parametrize("name", sorted(COSTS))
def test_cost_volume_matches_jax(scene, jax_volumes, name, lor):
    (left, right), (gl, gr), arms_pair = scene
    got = cost.compute_cost_volume(left, right, gl, gr, _port_cfg(name), lor, arms=arms_pair[lor])
    assert got.dtype == torch.float32 and got.shape == (D, 48, 64)
    assert bool(torch.isfinite(got).all())
    assert_close(got.numpy(), jax_volumes(name)[lor], COSTS[name][1])


@pytest.mark.parametrize("lor", [0, 1])
@pytest.mark.parametrize("name", sorted(set(COSTS) - set(DENSE_ONLY)))
def test_block_is_the_dense_planes(scene, name, lor):
    """Each block of disparities is the dense volume's planes, bit for bit."""
    (left, right), (gl, gr), arms_pair = scene
    cfg = _port_cfg(name)
    dense = cost.compute_cost_volume(left, right, gl, gr, cfg, lor, arms=arms_pair[lor])
    block = cost.block_cost_builder(left, right, gl, gr, cfg, lor, arms=arms_pair[lor])
    for ds in (torch.arange(0, 4), torch.arange(9, 16)):
        assert torch.equal(block(ds), dense[ds])


@pytest.mark.parametrize("name", DENSE_ONLY + ("zncc",))
def test_dense_costs_have_no_block_form(scene, name):
    (left, right), (gl, gr), arms_pair = scene
    with pytest.raises(NotImplementedError, match=name):
        cost.block_cost_builder(left, right, gl, gr,
                                default_config(max_disp=D - 1, cost=name), 0)


# grad_volume's modes: (use_2dir, adaptive_weight, normalize, trunc, tolerance kind)
GRAD_MODES = {
    "2dir_adaptive": (True, True, False, 500.0, "fma"),
    "2dir_sum": (True, False, False, 500.0, "exact"),
    "1dir": (False, False, False, 7.0, "exact"),
    "1dir_norm": (False, False, True, 500.0, "exact"),
    "1dir_norm_t7": (False, True, True, 7.0, "exact"),
}


@pytest.mark.parametrize("mode", sorted(GRAD_MODES))
def test_grad_volume_modes(scene, mode):
    """Every mode of grad_volume, both views (one jit). The one-direction
    normalised volume divides by the truncation through its float32
    reciprocal, as jitted XLA-CPU does (the JAX function op by op divides:
    it differs at thousands of entries). ``normalize`` does not apply to
    the two-direction forms."""
    _, (gl, gr), arms_pair = scene
    two, adaptive, norm, trunc, kind = GRAD_MODES[mode]
    fn = jax.jit(lambda a, b, a0, a1: tuple(
        jax_cost.grad_volume(a, b, D, lor, trunc, two, adaptive, (a0, a1)[lor], norm)
        for lor in (0, 1)))
    want = fn(*(jnp.asarray(t.numpy()) for t in (gl, gr, *arms_pair)))
    for lor in (0, 1):
        got = cost.grad_volume(gl, gr, D, lor, trunc, arms_pair[lor], use_2dir=two,
                               adaptive_weight=adaptive, normalize=norm)
        assert_close(got.numpy(), np.asarray(want[lor]), kind)
        if two:
            assert torch.equal(got, cost.grad_volume(gl, gr, D, lor, trunc, arms_pair[lor],
                                                     use_2dir=two, adaptive_weight=adaptive,
                                                     normalize=not norm))


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_ad_volume_squared_normalize(scene, squared, normalize):
    """ad_volume's ``squared`` and ``normalize`` (the latter has no JAX
    caller), truncated at 7 so that both bite, bit for bit against the
    jitted function: the normalised volume is the product with the
    float32 reciprocal of the truncation."""
    (left, right), _, _ = scene
    fn = jax.jit(lambda a, b: tuple(jax_cost.ad_volume(a, b, D, lor, 7.0, squared, normalize)
                                    for lor in (0, 1)))
    want = fn(jnp.asarray(left.numpy()), jnp.asarray(right.numpy()))
    for lor in (0, 1):
        got = cost.ad_volume(left, right, D, lor, 7.0, squared=squared, normalize=normalize)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[lor]))
        if normalize:
            assert float(got.max()) == 1.0


def test_exp_fuse3():
    """3 - exp(-v0/l0) - exp(-v1/l1) - exp(-v2/l2): the divisions as the
    jitted function's reciprocal products, exact; each exp within an ULP
    of XLA's, so the fused cost in [0, 3] lies within 2e-6."""
    rng = np.random.default_rng(3)
    vols = [(rng.random((D, 9, 11)) * s).astype(np.float32) for s in (71, 500, 120)]
    lams = (13.0, 1.0, 10.0)
    want = jax.jit(lambda *v: jax_cost.exp_fuse3(*v, *lams))(*(jnp.asarray(v) for v in vols))
    got = cost.exp_fuse3(*(torch.from_numpy(v) for v in vols), *lams)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


@pytest.mark.parametrize("lor", [0, 1])
def test_grad_mag_phase_volume(scene, lor):
    """The magnitude-and-phase gradient cost (no JAX caller) against the
    jitted function: the magnitude exact, the phase (atan2, which XLA-CPU
    rounds within an ULP of float64's) within 1e-6 of the [0, 2.15] cost."""
    _, (gl, gr), _ = scene
    want = jax.jit(lambda a, b: jax_cost.grad_mag_phase_volume(a, b, D, lor))(
        jnp.asarray(gl.numpy()), jnp.asarray(gr.numpy()))
    got = cost.grad_mag_phase_volume(gl, gr, D, lor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# the multilevel schedule at its defaults and at other levels, thresholds and
# neighbour threshold; the adaptive one with its default decay over 17 steps
# (then 3 steps of c_out, to keep the JAX compile short) and another
ARM_MODES = {"multilevel": dict(cbca_arm_mode="multilevel"),
             "multilevel_neigh": dict(cbca_arm_mode="multilevel", cbca_ml_neigh_thresh=12,
                                      cbca_cross_ls=(5, 11, 20), cbca_c_threshes=(14, 24, 40)),
             "adaptive": dict(cbca_arm_mode="adaptive", cbca_cross_l_out=20),
             "adaptive_short": dict(cbca_arm_mode="adaptive", cbca_cross_l=9,
                                    cbca_cross_l_out=15, cbca_c_thresh=25)}


@pytest.mark.parametrize("mode", sorted(ARM_MODES))
def test_arm_modes_exact(scene, mode):
    """``build_arms`` under the multilevel and adaptive schedules, bit for
    bit on the left image (one jit of the JAX function; its plain path on
    the CPU); the schedule's length is the mode's longest arm,
    ``arm_l_out``, which CBCA and region vote take as their max arm."""
    (left, _), _, _ = scene
    jcfg = jax_default_config(max_disp=D - 1, **ARM_MODES[mode])
    want = jax.jit(lambda a: jax_arms.build_arms(a, jcfg))(jnp.asarray(left.numpy()))
    cfg = as_port_config(jcfg)
    got = arms.build_arms(left, cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sched, _ = arms.arm_schedule(cfg)
    assert len(sched) == cfg.arm_l_out == jcfg.arm_l_out


def test_arm_schedules():
    """The schedules as the JAX functions build them: the level walk and
    int(c_in - c_in / l_in * k + 10)."""
    assert arms.multilevel_schedule((2, 3, 5), (20, 30, 40)) == [20, 20, 30, 40, 40]
    assert arms.adaptive_schedule(4, 6, 20, 6) == [int(20 - 20 / 4 * k + 10)
                                                   for k in range(1, 5)] + [6, 6]
    assert arms.adaptive_schedule(4, 6, 20, 6)[:4] == [25, 20, 15, 10]
    assert default_config(cbca_arm_mode="multilevel").arm_l_out == 34
    assert default_config(cbca_arm_mode="adaptive", cbca_cross_l_out=21).arm_l_out == 21


def test_gradient_costs_need_arms():
    """grad and ad_census_grad read the reference image's arms on the
    default gradient settings, as the JAX package's _needs_arms_for_cost
    says: kernel A launches under no aggregation too; not for the
    one-direction or summed forms."""
    for name in ("grad", "ad_census_grad", "census_grad", "ad_grad"):
        cfg = get_model("ad_census_wta", max_disp=D - 1, cost=name)
        assert kernels_launched(cfg) == ["arms_grow", "wta"]
        for off in (dict(grad_use_2dir=False), dict(grad_fuse_adaptive=False)):
            assert kernels_launched(cfg.replace(**off)) == ["wta"]
    for name in ("ad", "sd", "ssd", "census_from2", "ad_census_zncc", "zncc"):
        assert kernels_launched(get_model("ad_census_wta", max_disp=D - 1, cost=name)) == ["wta"]


ACCEPTED = [dict(cost=name, **extra) for name in ("ad", "sd", "grad", "ssd", "census_from2",
                                                  "ad_census_grad", "ad_census_zncc", "zncc")
            for extra in (dict(), dict(aggregation="none"), dict(aggregation="nl"),
                          dict(aggregation="bf"), dict(vol_dtype="bfloat16"),
                          dict(aggregation="none", vol_dtype="bfloat16"))]
ACCEPTED += [dict(cost=name, d_stream_block=4)
             for name in ("ad", "sd", "grad", "census_from2", "ad_census_grad")]
ACCEPTED += [dict(cost="grad", grad_use_2dir=two, grad_fuse_adaptive=ad, is_grad_norm=norm)
             for two in (False, True) for ad in (False, True) for norm in (False, True)]
ACCEPTED += [dict(cbca_arm_mode=m, vol_dtype=v) for m in ("multilevel", "adaptive")
             for v in ("float32", "bfloat16")]


def test_check_supported_accepts_the_new_costs():
    for kw in ACCEPTED:
        check_supported(default_config(max_disp=D - 1, **kw))


@pytest.mark.parametrize("name", DENSE_ONLY + ("zncc",))
def test_dense_costs_are_not_streamed(name):
    """ssd, zncc and ad_census_zncc have no block form (the JAX block
    builder refuses them too): streaming them is refused, naming the flag."""
    with pytest.raises(NotImplementedError, match="d_stream_block"):
        check_supported(default_config(max_disp=D - 1, cost=name, d_stream_block=4))


@pytest.fixture(scope="module")
def scenes():
    return make_scenes()


# the two configurations held end to end here (the third, census_from2
# with multilevel arms and the pyramid, is tests/test_torch_crossscale.py's)
END_TO_END = {
    "ad_census_grad_adaptive": ("census_grad_cbca_sgm",
                                dict(NARROW, cost="ad_census_grad", cbca_arm_mode="adaptive")),
    "ad_census_zncc_none": ("ad_census_wta", dict(cost="ad_census_zncc")),
}


@pytest.fixture(scope="module")
def end_to_end(scenes):
    return {name: jax_and_port_maps(preset, scenes, narrow=kw)
            for name, (preset, kw) in END_TO_END.items()}


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("name", sorted(END_TO_END))
def test_end_to_end_matches_jax(end_to_end, name, scene, key):
    if key not in end_to_end[name][scene][0]:
        assert name == "ad_census_zncc_none"     # WTA alone: no right map
        return
    check_maps(end_to_end[name], scene, key)


def test_nl_batch_refuses_the_pyramid():
    cfg = get_model("nl_tree_filter", max_disp=D - 1, compute_both_volumes=False,
                    pyramid_levels=2)
    frames = torch.zeros((2, 8, 12, 3))
    with pytest.raises(NotImplementedError, match="pyramid_levels"):
        match_pair_nl_batch(frames, frames, cfg)
