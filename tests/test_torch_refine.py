"""The port's refinement against the JAX package's, on the CPU.

LR check, arm-bounded integer reductions (kernel B's integer mode), region
vote (the dispatching function and its plain version), proper
interpolation, the median, the refine chain as a whole, and the port's
default preset against the reference binary's final map. Both
sides get the same numpy arrays. Every comparison is exact: the maps are
int32, and the plain torch versions keep the JAX CPU path's rules (tap
order, tie rules, float32 colour differences).
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.config import default_config as jax_default_config
from mystereomatching_tpu.ops import arms as jax_arms
from mystereomatching_tpu.ops import refine as jax_refine

import mystereomatching_tpu_torch as port
from mystereomatching_tpu_torch import pipeline
from mystereomatching_tpu_torch.config import as_port_config
from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.ops import arms, refine
from mystereomatching_tpu_torch.ops import cuda_kernels as ck

M = 34  # the default max arm (cbca_cross_l_out)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _blocky(rng, h, w, block, levels):
    """Piecewise-flat [h, w] blocks of values drawn from ``levels``."""
    cells = rng.choice(levels, (-(-h // block), -(-w // block)))
    return np.kron(cells, np.ones((block, block), np.int64))[:h, :w]


def _scene(rng, h, w, holes=0.3):
    """A blocky colour image, a disparity map constant on its blocks, and
    the map with -1 and -32 holes (about ``holes`` of the pixels)."""
    img = np.stack([_blocky(np.random.default_rng(c), h, w, 10, np.arange(0, 256, 17))
                    for c in range(3)], -1).astype(np.float32)
    img = np.clip(img + rng.normal(0, 2.0, img.shape).round(), 0, 255).astype(np.float32)
    disp = _blocky(np.random.default_rng(7), h, w, 10, np.arange(12)).astype(np.int32)
    r = rng.random((h, w))
    holed = np.where(r < holes / 2, -1, np.where(r < holes, -32, disp)).astype(np.int32)
    return img, disp, holed


@pytest.mark.parametrize("num_disp", [None, 12])
@pytest.mark.parametrize("max_diff", [0, 1])
def test_lr_consistency_exact(num_disp, max_diff):
    rng = np.random.default_rng(max_diff)
    dl = rng.integers(-1, 12, (17, 29)).astype(np.int32)
    dr = rng.integers(-1, 12, (17, 29)).astype(np.int32)
    dr[:, 5:15] = dl[:, 5:15]  # some consistent runs
    ref = jax_refine.lr_consistency(jnp.asarray(dl), jnp.asarray(dr), max_diff, num_disp)
    ours = refine.lr_consistency(torch.from_numpy(dl), torch.from_numpy(dr), max_diff)
    assert ours.dtype == torch.int32
    assert (np.asarray(ref) == -1).any() and (np.asarray(ref) >= 0).any()
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_arm_bounded_reduce_exact(op, axis):
    rng = np.random.default_rng(3 * axis + len(op))
    vol = rng.integers(-1000, 1000, (2, 21, 27)).astype(np.int32)
    an, ap = (rng.integers(0, 40, (21, 27)).astype(np.int32) for _ in range(2))
    ref = jax_arms.arm_bounded_reduce(jnp.asarray(vol), jnp.asarray(an)[None],
                                      jnp.asarray(ap)[None], axis, M, op)
    ours = arms.arm_bounded_reduce_plain(torch.from_numpy(vol), torch.from_numpy(an),
                                         torch.from_numpy(ap), axis, M, op)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_region_vote_two_iterations_exact():
    rng = np.random.default_rng(11)
    img, _, holed = _scene(rng, 40, 52)
    cfg = port.default_config(max_disp=11)
    arms0 = arms.build_arms(torch.from_numpy(img), cfg)
    ref, ours = jnp.asarray(holed), torch.from_numpy(holed)
    for _ in range(2):
        ref = jax_refine.region_vote(ref, jnp.asarray(arms0.numpy()), 12, 20, 0.4, True, M)
        ours = refine.region_vote(ours, arms0, 12, 20, 0.4, True, M)
    assert int((ours != torch.from_numpy(holed)).sum()) > 0  # some votes were accepted
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", ["arms_past_max_arm", "holes_on_every_border"])
def test_region_vote_plain_exact(case):
    """region_vote_plain against the JAX region vote: every arm at or past
    max_arm (capped there), or holes along all four borders, where the
    support is cut at the image's edge."""
    rng = np.random.default_rng(len(case))
    h, w, m = 23, 31, 5
    disp = _blocky(np.random.default_rng(9), h, w, 12, np.arange(6)).astype(np.int32)
    holed = np.where(rng.random((h, w)) < 0.2, -1, disp).astype(np.int32)
    if case == "arms_past_max_arm":
        arms0 = rng.integers(m, 3 * m, (4, h, w)).astype(np.int32)
    else:
        arms0 = rng.integers(0, 2 * m, (4, h, w)).astype(np.int32)
        holed[[0, -1], :] = -32
        holed[:, [0, -1]] = -1
    ref = jax_refine.region_vote(jnp.asarray(holed), jnp.asarray(arms0), 6, 3, 0.4, True, m)
    ours = refine.region_vote_plain(torch.from_numpy(holed), torch.from_numpy(arms0), 3, m)
    assert int((ours != torch.from_numpy(holed)).sum()) > 0  # some votes were accepted
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_region_vote_on_cpu_never_reaches_cuda_kernels():
    rng = np.random.default_rng(6)
    img, _, holed = _scene(rng, 20, 24)
    d = torch.from_numpy(holed)
    arms0 = arms.build_arms(torch.from_numpy(img), port.default_config(max_disp=11))
    ck.reset_launches()
    with mock.patch.object(ck, "region_vote", side_effect=AssertionError("region_vote")), \
            mock.patch.object(ck, "arm_reduce", side_effect=AssertionError("arm_reduce")):
        out = refine.region_vote(d, arms0, 12, 20, 0.4, True, M)
    assert ck.launches["region_vote"] == 0 and ck.launches["arm_reduce"] == 0
    assert torch.equal(out, refine.region_vote_plain(d, arms0, 20, M))


def test_region_vote_histogram_form_raises():
    """The histogram form runs (tests/test_torch_refine_variants.py holds it
    against JAX); like every kernel-backed op it raises on a tensor that is
    neither on the CPU nor on a CUDA device, rather than fall back."""
    with pytest.raises(ValueError, match="unsupported device"):
        refine.region_vote(torch.zeros((4, 5), dtype=torch.int32, device="meta"),
                           torch.ones((4, 4, 5), dtype=torch.int32, device="meta"), 3,
                           int_ratio_quirk=False)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("depth", [6, 20])
def test_proper_interpolation_exact(depth, flat):
    """flat: one colour everywhere, so every ray that finds a valid pixel
    ties on the colour difference and the lowest ray must win."""
    rng = np.random.default_rng(depth)
    img, _, holed = _scene(rng, 30, 44, holes=0.6)
    holed[12] = np.where(np.arange(44) % 2, -1, -32)  # an all-invalid row
    if flat:
        img[:] = 77.0
    else:
        img[:3, :4] = 0.0                             # colour differences of 255
        img[-3:, -4:] = 255.0
    ref = jax_refine.proper_interpolation(jnp.asarray(holed), jnp.asarray(img), depth, -32)
    ours = refine.proper_interpolation(torch.from_numpy(holed), torch.from_numpy(img),
                                       depth, -32)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_pi_offsets_equal_jax():
    for depth in (1, 6, 20):
        np.testing.assert_array_equal(refine.pi_offsets(depth), jax_refine._pi_offsets(depth))


@pytest.mark.parametrize("ksize", [3, 5])
def test_median_blur_exact(ksize):
    d = np.random.default_rng(ksize).integers(-2, 30, (13, 18)).astype(np.int32)
    d[d == -2] = -32  # sentinels take part as values
    ref = jax_refine.median_blur_disp(jnp.asarray(d), ksize)
    ours = refine.median_blur_disp(torch.from_numpy(d), ksize)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_refine_chain_exact():
    """The same (dl, dr, arms) through the JAX package's refine and the port's."""
    pair = make_synthetic_pair(h=48, w=64, max_disp=11, seed=2)
    cfg = port.default_config(max_disp=11)
    left = torch.from_numpy(pair.left).to(torch.float32)
    raw = port.StereoPipeline(cfg.replace(do_refine=False), device="cpu")(pair.left, pair.right)
    dl, dr = raw["disp_left_raw"], raw["disp_right_raw"]
    arms0 = arms.build_arms(left, cfg)
    jcfg = jax_default_config(max_disp=11)
    fn = jax.jit(lambda a, b, img, ar: jax_pipeline.refine(a, b, None, img, ar, jcfg))
    ref = fn(jnp.asarray(dl.numpy()), jnp.asarray(dr.numpy()), jnp.asarray(left.numpy()),
             jnp.asarray(arms0.numpy()))
    ours = pipeline.refine(dl, dr, None, left, arms0, as_port_config(jcfg))
    assert int((refine.lr_consistency(dl, dr) < 0).sum()) > 0  # the chain had holes to fill
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _load_ref_disp(path):
    with open(path, "rb") as f:
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        return np.frombuffer(f.read(h * w * 2), np.int16).reshape(h, w).astype(np.int32)


def test_default_config_matches_reference_binary_small_scale():
    pair = make_synthetic_pair(name="small_scale", h=144, w=192, max_disp=23, seed=3)
    out = port.StereoPipeline(port.default_config(max_disp=23), device="cpu")(pair.left,
                                                                               pair.right)
    final = np.round(out["disparity"].numpy()).astype(np.int32)
    assert out["disparity"].dtype == torch.float32
    assert int((final != _load_ref_disp(os.path.join(GOLDEN, "small_scale_final.bin"))).sum()) == 0
    assert int((out["disp_left_raw"].numpy()
                != _load_ref_disp(os.path.join(GOLDEN, "small_scale_wta.bin"))).sum()) == 0


def test_cpu_refine_launches_no_kernel():
    rng = np.random.default_rng(4)
    img, _, holed = _scene(rng, 20, 24)
    arms0 = arms.build_arms(torch.from_numpy(img), port.default_config(max_disp=11))
    ck.reset_launches()
    d = refine.region_vote(torch.from_numpy(holed), arms0, 12)
    refine.proper_interpolation(d, torch.from_numpy(img))
    assert all(n == 0 for n in ck.launches.values())
