"""Truncated AD, AWS and JBF against the JAX package, on the CPU.

``trunc_ad_volume`` equals the JAX function bit for bit, run op by op and
jitted. ``rgb_to_lab`` equals the jitted JAX function on the synthetic,
adversarial and ``photo_small`` images; over all 2^24 colours (checked
once, not here: 10 s on 4 cores) it differs at exactly the two colours of
:data:`LAB_DIFFERS`, by one level in one channel, which a sample of
colours below confirms. The AWS weights (``_lab_weight``) are within one
ULP of the jitted JAX function's (``exp`` in float64 against XLA's
float32 approximation; the distance equals JAX's bit for bit). The AWS
volume at the preset's window (``aws_win=17``) on a [4, 20, 24] volume,
and the JBF volume, differ from the jitted JAX functions' by those ULPs:
the largest relative differences are 3.91e-7 (both views) and 2.64e-7
here, asserted below :data:`AWS_REL`. Then
the preset ``aws_wta`` end to end at 48x64, D=16 with ``aws_win=5``, on a
synthetic and an adversarial scene against the jitted JAX ``match_pair``
(one jit), with ``tests/test_torch_vmtop.py``'s narrowed windows: 0 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu.config import default_config as jax_default_config
from mystereomatching_tpu.data import make_adversarial_pair, make_synthetic_pair
from mystereomatching_tpu.ops import aws as jax_aws
from mystereomatching_tpu.ops import cost as jax_cost

from mystereomatching_tpu_torch.config import as_port_config
from mystereomatching_tpu_torch.data import load_photo_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import aws, cost
from mystereomatching_tpu_torch.pipeline import check_supported, kernels_launched
from test_torch_vmtop import KEYS, NARROW, SCENES, check_maps, jax_and_port_maps, make_scenes

D = 16
AWS_REL = 1e-6   # the AWS and JBF volumes against JAX's, relative
# (colour, JAX's Lab, the port's Lab): the only colours of 2^24 where they differ
LAB_DIFFERS = (((2, 145, 95), (135, 83, 145), (135, 83, 146)),
               ((184, 44, 194), (119, 199, 80), (119, 199, 79)))


def _lab_pair(img):
    img = np.ascontiguousarray(img, np.float32)
    return (aws.rgb_to_lab(torch.from_numpy(img)).numpy(),
            np.asarray(jax.jit(jax_aws.rgb_to_lab)(img)))


@pytest.mark.parametrize("lor", [0, 1])
def test_trunc_ad_volume_exact(lor):
    p = make_synthetic_pair(h=24, w=40, max_disp=D - 1, seed=4)
    eager = jax_cost.trunc_ad_volume(jnp.asarray(p.left, jnp.float32),
                                     jnp.asarray(p.right, jnp.float32), D, lor)
    jitted = jax.jit(lambda a, b: jax_cost.trunc_ad_volume(a, b, D, lor))(
        p.left.astype(np.float32), p.right.astype(np.float32))
    got = cost.trunc_ad_volume(torch.from_numpy(p.left), torch.from_numpy(p.right), D, lor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jitted))
    assert (got.numpy() == 60.0).any() and (got.numpy() < 60.0).any()


@pytest.mark.parametrize("scene", ["synthetic", "adversarial", "photo_small"])
def test_rgb_to_lab_equals_jax_on_the_scenes(scene):
    if scene == "photo_small":
        p = load_photo_pair("photo_small")
    elif scene == "synthetic":
        p = make_synthetic_pair(h=96, w=128, max_disp=D - 1, seed=0)
    else:
        p = make_adversarial_pair(h=96, w=128, max_disp=D - 1, seed=2)
    for img in (p.left, p.right):
        got, want = _lab_pair(img)
        differ = np.argwhere((got != want).any(-1))
        assert len(differ) == 0, [(tuple(img[y, x]), want[y, x], got[y, x]) for y, x in differ]


def test_rgb_to_lab_differs_only_at_the_two_known_colours():
    rng = np.random.default_rng(0)
    colours = np.concatenate([rng.integers(0, 256, (1 << 16, 3)),
                              [c for c, _, _ in LAB_DIFFERS]]).astype(np.float32)
    got, want = _lab_pair(colours[None])
    differ = np.argwhere((got[0] != want[0]).any(-1))[:, 0]
    assert sorted(tuple(colours[i].astype(int)) for i in differ) == sorted(
        c for c, _, _ in LAB_DIFFERS)
    for colour, jax_lab, port_lab in LAB_DIFFERS:
        i = np.nonzero((colours == colour).all(-1))[0][-1]
        assert tuple(want[0, i]) == jax_lab and tuple(got[0, i]) == port_lab


def test_lab_weight_within_one_ulp():
    rng = np.random.default_rng(1)
    center = rng.integers(0, 256, (300, 200, 3)).astype(np.float32)
    neigh = np.clip(center + rng.integers(-8, 9, center.shape), 0, 255).astype(np.float32)
    neigh[::2] = rng.integers(0, 256, neigh[::2].shape)
    want = np.asarray(jax.jit(lambda a, b: jax_aws._lab_weight(a, b, 5.0))(center, neigh))
    got = aws._lab_weight(torch.from_numpy(center), torch.from_numpy(neigh), 5.0).numpy()
    u = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert u.max() <= 1, u.max()


@pytest.fixture(scope="module")
def small_case():
    p = make_synthetic_pair(h=20, w=24, max_disp=3, seed=6)
    vol = np.random.default_rng(2).uniform(0, 60, (4, 20, 24)).astype(np.float32)
    return p.left.astype(np.float32), p.right.astype(np.float32), vol


@pytest.mark.parametrize("lor", [0, 1])
def test_aws_aggregate_within_the_weights_rounding(small_case, lor):
    """At the preset's own window, 35x35 (1,225 offsets), which the
    20x24 images reflect more than once."""
    left, right, vol = small_case
    jcfg = jax_default_config(max_disp=3)
    assert jcfg.aws_win == 17
    want = np.asarray(jax.jit(lambda v, a, b: jax_aws.aws_aggregate(
        v, a, jcfg, b, lor=lor))(vol, left, right))
    l_t, r_t = torch.from_numpy(left), torch.from_numpy(right)
    got = aws.aws_aggregate(torch.from_numpy(vol), l_t, as_port_config(jcfg), r_t, lor=lor).numpy()
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= AWS_REL, rel.max()
    assert not np.array_equal(got, vol)


def test_jbf_volume_within_the_weights_rounding(small_case):
    left, _, vol = small_case
    want = np.asarray(jax.jit(lambda v, im: jax_aws.jbf_volume(v, im, 4))(vol, left))
    got = aws.jbf_volume(torch.from_numpy(vol), torch.from_numpy(left), 4).numpy()
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= AWS_REL, rel.max()


def test_aws_wta_frame_kernels():
    cfg = get_model("aws_wta")
    check_supported(cfg)
    assert kernels_launched(cfg) == ["arms_grow", "wta", "region_vote", "pi_scan"]


@pytest.fixture(scope="module")
def preset_maps():
    return jax_and_port_maps("aws_wta", make_scenes(), dict(NARROW, aws_win=5))


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("key", KEYS)
def test_preset_matches_jax(preset_maps, scene, key):
    check_maps(preset_maps, scene, key)
