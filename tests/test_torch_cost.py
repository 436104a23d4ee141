"""The port's cost stage against the JAX package, on the same numpy inputs.

Exact: gray conversion, census bit planes, the Hamming volume, cross arms
and their per-disparity intersection (all integer arithmetic).
Within a tolerance, each with its reason at the assertion: the gradient
volume and the fused censusGrad volume.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.config import default_config as jax_default_config
from mystereomatching_tpu.ops import arms as jax_arms
from mystereomatching_tpu.ops import census as jax_census
from mystereomatching_tpu.ops import cost as jax_cost

from mystereomatching_tpu_torch.config import as_port_config
from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.ops import arms, census, cost
from mystereomatching_tpu_torch.pipeline import to_gray

D = 12


@pytest.fixture(scope="module")
def pair():
    return make_synthetic_pair(h=40, w=56, max_disp=D - 1, seed=7, noise_sigma=0.5)


@pytest.fixture(scope="module")
def grays(pair):
    return tuple(np.array(jax_pipeline.to_gray(jnp.asarray(img, jnp.float32)))
                 for img in (pair.left, pair.right))


@pytest.fixture(scope="module")
def jax_arms_pair(pair):
    grow = jax.jit(jax_arms.cross_arms)
    return tuple(np.array(grow(jnp.asarray(img, jnp.float32)))
                 for img in (pair.left, pair.right))


def test_to_gray_exact():
    img = np.random.default_rng(0).integers(0, 256, (23, 31, 3)).astype(np.float32)
    ref = np.asarray(jax_pipeline.to_gray(jnp.asarray(img)))
    np.testing.assert_array_equal(to_gray(torch.from_numpy(img)).numpy(), ref)


@pytest.mark.parametrize("source", ["scene", "flat_ties"])
def test_census_bits_exact(grays, source):
    if source == "scene":
        gray = grays[0]
    else:  # few gray levels: many equal neighbours, the strict < matters
        gray = np.random.default_rng(1).integers(0, 3, (17, 21)).astype(np.float32)
    ref = jax_census._census_bits_ncsur(jnp.asarray(gray), 3, 4)
    ours = census.census_bits_ncsur(torch.from_numpy(gray), 3, 4)
    assert len(ours) == len(ref) == census.ncsur_code_length(3, 4)
    for i, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"bit {i}")


@pytest.mark.parametrize("lor,trunc_ratio,normalize", [
    (0, 1.0, False), (1, 1.0, False), (0, 0.25, True),  # is_census_norm / truncRatio
])
def test_hamming_volume_exact(grays, lor, trunc_ratio, normalize):
    gl, gr = grays
    n = jax_census.ncsur_code_length(3, 4)
    ref = jax_census.hamming_volume(
        jax_census.census_code_ncsur(jnp.asarray(gl)),
        jax_census.census_code_ncsur(jnp.asarray(gr)), D, lor, n, trunc_ratio, normalize)
    ours = census.hamming_volume(
        census.census_code_ncsur(torch.from_numpy(gl)),
        census.census_code_ncsur(torch.from_numpy(gr)), D, lor, n, trunc_ratio, normalize)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_popcount_all_bit_positions():
    words = torch.tensor([0, 1, -1, -(1 << 63), 0x0F0F0F0F0F0F0F0F, 12345678901234])
    want = [bin(int(w) & (2 ** 64 - 1)).count("1") for w in words]
    assert census.popcount(words, census.POPCOUNT8).tolist() == want


def test_cross_arms_exact(pair, jax_arms_pair):
    for img, ref in zip((pair.left, pair.right), jax_arms_pair):
        ours = arms.cross_arms(torch.from_numpy(img.astype(np.float32)))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("lor", [0, 1])
def test_intersect_arms_exact(jax_arms_pair, lor):
    al, ar = jax_arms_pair
    ref = jax_arms.intersect_arms(jnp.asarray(al), jnp.asarray(ar), D, lor)
    ours = arms.intersect_arms(torch.from_numpy(al), torch.from_numpy(ar), D, lor)
    assert ours.dtype == torch.int8 and ours.is_contiguous()
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("axis", [0, 1])
def test_central_gradient_exact(grays, axis):
    ref = jax_cost.central_gradient(jnp.asarray(grays[0]), axis)
    ours = cost.central_gradient(torch.from_numpy(grays[0]), axis)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lor", [0, 1])
def test_grad_volume(grays, jax_arms_pair, lor):
    gl, gr = grays
    a = jax_arms_pair[lor]
    grad = jax.jit(lambda gl, gr, a: jax_cost.grad_volume(gl, gr, D, lor, 500.0,
                                                          True, True, a))
    ref = grad(jnp.asarray(gl), jnp.asarray(gr), jnp.asarray(a))
    ours = cost.grad_volume(torch.from_numpy(gl), torch.from_numpy(gr), D, lor,
                            500.0, torch.from_numpy(a))
    # Under jit, XLA-CPU contracts a*cx + (1-a)*cy into a fused
    # multiply-add; torch rounds each product first. On this scene 0.6% of
    # the entries differ, by at most 1 ULP.
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


def test_exp_fuse2():
    rng = np.random.default_rng(2)
    c = rng.integers(0, 72, (D, 9, 11)).astype(np.float32)
    g = (rng.integers(0, 1000, (D, 9, 11)) / 2.0).astype(np.float32)
    ref = jax_cost.exp_fuse2(jnp.asarray(c), jnp.asarray(g), 13.0, 1.0)
    ours = cost.exp_fuse2(torch.from_numpy(c), torch.from_numpy(g), 13.0, 1.0)
    # torch.exp and XLA-CPU's exp differ by 1 ULP on about 10% of float32
    # inputs in [-40, 0]; the fused cost lies in [0, 2], so 1e-6 absolute
    # covers a few ULPs there.
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("census_func", [3, 0])
@pytest.mark.parametrize("lor", [0, 1])
def test_census_grad_volume(pair, grays, jax_arms_pair, lor, census_func):
    """The default census code (3, classic + 8 surround pairs) and the
    classic one (0), which ``census_grad`` takes from ``census_func`` too."""
    jcfg = jax_default_config(max_disp=D - 1, do_refine=False, census_func=census_func)
    gl, gr = grays
    left, right = (img.astype(np.float32) for img in (pair.left, pair.right))
    a = jax_arms_pair[lor]
    ref = jax_cost.compute_cost_volume(jnp.asarray(left), jnp.asarray(right),
                                       jnp.asarray(gl), jnp.asarray(gr), jcfg, lor,
                                       arms=jnp.asarray(a))
    ours = cost.compute_cost_volume(torch.from_numpy(left), torch.from_numpy(right),
                                    torch.from_numpy(gl), torch.from_numpy(gr),
                                    as_port_config(jcfg), lor, arms=torch.from_numpy(a))
    # the exp ULP differences of test_exp_fuse2 plus the FMA ULP of
    # test_grad_volume passed through exp(-g): at most a few ULPs of [0, 2]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
