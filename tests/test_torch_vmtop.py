"""vmTop and the double-window merges against the JAX package, on the CPU.

The vmTop decision (``select_top_costs``, methods 0, 1 and 2) and the
double-window merges (``combine2vm_arm_limit``, ``combine2vm_min``,
``combine2vm_4``) on random volumes, equal bit for bit to the JAX
functions. Then the preset ``census_cbca_vmtop`` end to end at 48x64,
D=16, on a synthetic and an adversarial scene: the port's
``disp_left_raw``, ``disp_right_raw`` and ``disparity`` equal the jitted
JAX ``match_pair``'s, one jit for both scenes (``cbca_double`` end to end
is ``tests/test_torch_double.py``, so that the two JAX compiles go to two
workers). To keep the compile short the windows are narrowed
(:data:`NARROW`: census 5x5, arms of window 0 to 4 / 8 steps and of the
large window to 6 / 6, proper interpolation to depth 6); every stage of
the preset runs as it does at its own widths, which the card runs
(``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.data import make_adversarial_pair, make_synthetic_pair
from mystereomatching_tpu.models import get_model as jax_get_model
from mystereomatching_tpu.ops import combine as jax_combine
from mystereomatching_tpu.ops import vmtop as jax_vmtop

from mystereomatching_tpu_torch.config import as_port_config
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import combine, vmtop
from mystereomatching_tpu_torch.pipeline import (StereoPipeline, apply_sub_ipol,
                                                 kernels_launched)

D = 16
NARROW = dict(census_rv=2, census_ru=2, cbca_cross_l=4, cbca_cross_l_out=8,
              cbca_cross_ls=(4, 6, 34), cbca_cross_l_outs=(8, 6, 34), pi_search_depth=6)
SCENES = ("synthetic", "adversarial")
KEYS = ("disp_left_raw", "disp_right_raw", "disparity")


def _volume(seed, shape=(D, 24, 32), levels=6):
    """Costs on a few levels (ties for the argmins and the vote) plus
    eighths, so that several candidates pass a 1.5 threshold."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, levels, shape) + rng.integers(0, 8, shape) / 8 + 1.0).astype(
        np.float32)


def _candidates(seed, m, thres):
    vol = _volume(seed)
    return vol, [np.array(a) for a in jax_vmtop.select_top_costs(jnp.asarray(vol), m, thres)]


@pytest.mark.parametrize("m,thres", [(2, 1.09), (3, 1.5), (4, 3.0)])
def test_select_top_costs_exact(m, thres):
    vol, want = _candidates(m, m, thres)
    got = vmtop.select_top_costs(torch.from_numpy(vol), m, thres)
    for g, w in zip(got, want):
        assert g.dtype == {np.int32: torch.int32, np.float32: torch.float32}[w.dtype.type]
        np.testing.assert_array_equal(g.numpy(), w)
    assert (want[2] > 1).any() and (want[2] < m).any()


@pytest.mark.parametrize("m,thres,ts", [(2, 1.09, 10), (3, 1.5, 2)])
def test_method0_exact(m, thres, ts):
    """The Jacobi vote: the container, the neighbour support, the cost and
    disparity tie-breaks of the float32 order key (the JAX side jitted:
    XLA-CPU computes the key as the ops do, products rounded first)."""
    _, (cd, cc, cnt) = _candidates(10 + m, m, thres)
    jcfg = jax_get_model("census_cbca_vmtop", max_disp=D - 1, vmtop_ts=ts)
    want = jax.jit(lambda a, b, c: jax_vmtop.disp_from_top_method0(a, b, c, jcfg))(
        jnp.asarray(cd), jnp.asarray(cc), jnp.asarray(cnt))
    got = vmtop.disp_from_top_method0(torch.from_numpy(cd), torch.from_numpy(cc),
                                      torch.from_numpy(cnt), as_port_config(jcfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("m,thres", [(2, 1.5), (3, 3.0)])
def test_methods_1_and_2_exact(method, m, thres):
    _, (cd, _, cnt) = _candidates(20 + m, m, thres)
    if method == 1:
        want = jax_vmtop.disp_from_top_method1(jnp.asarray(cd), jnp.asarray(cnt))
        got = vmtop.disp_from_top_method1(torch.from_numpy(cd), torch.from_numpy(cnt))
    else:
        img = np.random.default_rng(m).integers(0, 4, cd.shape[1:] + (3,)).astype(np.float32)
        want = jax_vmtop.disp_from_top_method2(jnp.asarray(cd), jnp.asarray(cnt),
                                               jnp.asarray(img))
        got = vmtop.disp_from_top_method2(torch.from_numpy(cd), torch.from_numpy(cnt),
                                          torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("merge", [2, 3, 4])
def test_combine_exact(merge):
    """combine2Vm_2, _3 and _4 on two volumes and arms that make each take
    vm2 (or the blend) at some pixels and not at others."""
    rng = np.random.default_rng(merge)
    vm, vm2 = _volume(30 + merge), _volume(40 + merge)
    vm[:, 3:5, 3:5] = 0.0                       # min vm == 0: combine2Vm_3's +inf gain
    arms = rng.integers(0, 14, (4, 24, 32)).astype(np.int32)
    arms_left = rng.integers(0, 9, (4, 24, 32)).astype(np.int32)
    arms_left[:, :10] = rng.integers(0, 5, (4, 10, 32))   # short arms: combine2Vm_4 takes vm2
    t = [torch.from_numpy(a) for a in (vm, vm2, arms, arms_left)]
    j = [jnp.asarray(a) for a in (vm, vm2, arms, arms_left)]
    if merge == 2:
        want = jax_combine.combine2vm_arm_limit(j[0], j[1], j[2])
    elif merge == 3:
        want = jax_combine.combine2vm_min(j[0], j[1])
    else:
        want = jax_combine.combine2vm_4(j[0], j[1], j[3])
    got = combine.combine(t[0], t[1], merge, t[2], t[3])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    took = (got.numpy() != vm).any(0)
    assert took.any() and not took.all()


def test_combine_pkr_is_refused():
    """PKR's merge (``cbca_combine=1``) runs now (tests/test_torch_refine_variants.py
    holds it against JAX); a merge the JAX package does not know is
    refused, as its ``compute_volumes`` refuses it."""
    with pytest.raises(ValueError, match="unknown cbca_combine"):
        combine.combine(*(torch.zeros(2, 3, 4) for _ in range(2)), 5,
                        torch.zeros(4, 3, 4), torch.zeros(4, 3, 4))


def test_vmtop_decision_takes_no_sub_ipol():
    """sub_ipol refines WTA decisions only: after vmTop it is the identity."""
    cfg = get_model("census_cbca_vmtop", max_disp=D - 1, sub_ipol=True)
    d = torch.randint(0, D, (6, 7), dtype=torch.int32)
    vol = torch.rand(D, 6, 7)
    assert apply_sub_ipol(d, d, vol, cfg) is d
    assert not torch.equal(apply_sub_ipol(d, d, vol, cfg.replace(do_vmtop=False)),
                           d.to(torch.float32))


def test_kernels_of_the_vmtop_and_double_frames():
    assert kernels_launched(get_model("census_cbca_vmtop")) == [
        "arms_grow", "arm_taps", "sgm_scan", "region_vote", "pi_scan"]
    assert kernels_launched(get_model("cbca_double")) == [
        "arms_grow", "arm_taps", "sgm_scan", "wta", "region_vote", "pi_scan"]


@pytest.fixture(scope="module")
def scenes():
    return make_scenes()


@pytest.fixture(scope="module")
def preset_maps(scenes):
    return jax_and_port_maps("census_cbca_vmtop", scenes)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("key", KEYS)
def test_preset_matches_jax(preset_maps, scene, key):
    check_maps(preset_maps, scene, key)


def make_scenes():
    """The two 48x64, D=16 scenes of the end-to-end tests."""
    return {"synthetic": make_synthetic_pair(h=48, w=64, max_disp=D - 1, seed=1),
            "adversarial": make_adversarial_pair(h=48, w=64, max_disp=D - 1, seed=2)}


def jax_and_port_maps(name, scenes, narrow=NARROW):
    """{scene: (JAX maps, port maps)} of preset ``name``, its JAX side
    jitted once for every scene."""
    jcfg = jax_get_model(name, max_disp=D - 1, **narrow)
    fn = jax.jit(functools.partial(jax_pipeline.match_pair, cfg=jcfg))
    pipe = StereoPipeline(as_port_config(jcfg), device="cpu")
    maps = {}
    for scene, pair in scenes.items():
        ref = fn(jnp.asarray(pair.left), jnp.asarray(pair.right))
        maps[scene] = ({k: np.asarray(v) for k, v in ref.items()},
                       {k: v.numpy() for k, v in pipe(pair.left, pair.right).items()})
    return maps


def check_maps(maps, scene, key, differing=0):
    """The port's map ``key`` on ``scene`` differs from JAX's at
    ``differing`` pixels."""
    ref, ours = maps[scene]
    assert set(ours) == set(ref)
    assert ours[key].dtype == ref[key].dtype
    assert int((ours[key] != ref[key]).sum()) == differing
