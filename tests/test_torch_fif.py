"""FIF against the JAX package, on the CPU.

The edge weights are within one ULP of the jitted JAX ``_edge_weights``
(the port takes ``exp`` in float64, XLA its own float32 approximation;
every operation before it rounds as XLA's). Given JAX's own weights, the
min-plus recursion ``_mp`` and plain FIF's linear recursion
``_linear_recur`` equal the jitted JAX functions bit for bit: ``_mp``
with XLA's fused multiply-add of ``c + w * m``, ``_linear_recur`` in
``lax.associative_scan``'s recursive order with its fused ``a2 b1 + b2``,
at odd and even lengths. The whole ``fif_improve`` and ``fif`` volumes
differ from JAX's by the weights' ULPs: the largest relative differences
are 1.89e-7 and 2.82e-7 here, asserted below :data:`FIF_REL`. Then the
preset ``census_fif_sgm`` end to end at 48x64, D=16, on a synthetic and an
adversarial scene against the jitted JAX ``match_pair`` (one jit), with
``tests/test_torch_vmtop.py``'s narrowed windows: 0 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu.ops import fif as jax_fif

from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import cost, fif
from mystereomatching_tpu_torch.pipeline import check_supported, kernels_launched
from test_torch_vmtop import KEYS, SCENES, check_maps, jax_and_port_maps, make_scenes

D = 8
FIF_REL = 1e-6   # the fif_improve and fif volumes against JAX's, relative


def _image(seed=0, h=20, w=27):
    """Texture, a flat band (weights of 1) and steps (weights that flush
    to 0), in the 0..255 range of the pipeline's images."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    img[4:9] = img[4:5, :1] + rng.integers(-2, 3, (5, w, 3))
    img[12:16, ::4] = 255.0
    return np.clip(img, 0, 255)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.fixture(scope="module")
def weights():
    img = _image()
    want = [np.array(w) for w in jax.jit(jax_fif._edge_weights)(img)]
    return img, want


def test_edge_weights_within_one_ulp(weights):
    img, want = weights
    got = fif.edge_weights(torch.from_numpy(img))
    for g, w in zip(got, want):
        u = _ulps(g.numpy(), w)
        assert u.max() <= 1, u.max()
        assert (w == 0).any() and (w == 1).any()


def _volume(seed, shape):
    return np.random.default_rng(seed).uniform(0.0, 2.0, shape).astype(np.float32)


@pytest.mark.parametrize("axis", ["h", "v"])
def test_mp_exact_given_jax_weights(weights, axis):
    img, (wh, wv) = weights
    h, w = img.shape[:2]
    vol, w_edge = ((_volume(1, (D, h, w)), wh) if axis == "h"
                   else (_volume(2, (D, w, h)), np.ascontiguousarray(wv.T)))
    jax_mp = jax.jit(lambda v, e: jax_fif._mp(v, e, 2.0))
    for fwd in (True, False):
        ww = w_edge if fwd else np.array(jax_fif._rev_w(jnp.asarray(w_edge)))
        want = jax_mp(vol, ww)
        got = fif._mp(torch.from_numpy(vol), torch.from_numpy(ww), 2.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w", [27, 32, 33])
def test_linear_recur_exact_given_jax_weights(weights, w):
    img, (wh, _) = weights
    wt = np.concatenate([wh, wh], 1)[:, :w]                 # [H, w] weights
    vol = _volume(w, (D, wt.shape[0], w))
    want = jax.jit(jax_fif._linear_recur)(vol, wt[None])
    got = fif._linear_recur(torch.from_numpy(vol), torch.from_numpy(wt)[None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = vol.copy()                                       # the same sums, in order
    for k in range(1, w):
        plain[..., k] += wt[None, :, k - 1] * plain[..., k - 1]
    assert not np.array_equal(got.numpy(), plain)


def test_rev_w_exact(weights):
    _, (wh, _) = weights
    np.testing.assert_array_equal(fif._rev_w(torch.from_numpy(wh)).numpy(),
                                  np.asarray(jax_fif._rev_w(jnp.asarray(wh))))


@pytest.mark.parametrize("improve", [True, False], ids=["fif_improve", "fif"])
def test_fif_volume_within_the_weights_rounding(weights, improve):
    img, _ = weights
    vol = _volume(5, (D,) + img.shape[:2])
    jfn, fn = (jax_fif.fif_improve, fif.fif_improve) if improve else (jax_fif.fif, fif.fif)
    want = np.asarray(jax.jit(jfn)(vol, img))
    got = fn(torch.from_numpy(vol), torch.from_numpy(img)).numpy()
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= FIF_REL, rel.max()


def test_fma32_matches_jitted_contraction():
    """200,000 seeded float32 triples: fma32 equals the jitted c + a * b at
    every one; two roundings differ at tens of thousands."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(200_000).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: c + a * b)(a, b, c))
    got = cost.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)
    assert int((c + a * b != want).sum()) > 10_000


def test_census_fif_sgm_frame_kernels():
    cfg = get_model("census_fif_sgm")
    check_supported(cfg)
    assert kernels_launched(cfg) == ["arms_grow", "sgm_scan", "wta", "region_vote", "pi_scan"]


@pytest.fixture(scope="module")
def preset_maps():
    return jax_and_port_maps("census_fif_sgm", make_scenes())


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("key", KEYS)
def test_preset_matches_jax(preset_maps, scene, key):
    check_maps(preset_maps, scene, key)
