"""Cross-scale aggregation against the JAX package, on the CPU.

``pyr_down`` (colour and gray, twice), ``reg_inverse_weights`` and
``solve_all`` on 2 and 3 levels (float32, and bfloat16 levels, which the
JAX function's float32 weights promote to a float32 volume) bit for bit
against the JAX functions, ``solve_all`` jitted: XLA-CPU contracts its
sum of products into fused multiply-adds, fma(w_0, v_0, w_1 v_1) and then
one a level, which the port follows (``cost.fma32``). Then the pyramid in the pipeline: what it
accepts and refuses, a streamed pyramid frame equal to the dense one, and
``census_from2`` with multilevel arms and ``pyramid_levels=2`` (CBCA,
4-path SGM, no refinement) end to end against the jitted JAX
``match_pair`` on a synthetic and an adversarial scene, one jit: the
port's maps equal JAX's at 0 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu.ops import crossscale as jax_cs

from mystereomatching_tpu_torch.config import default_config
from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.ops import crossscale
from mystereomatching_tpu_torch.pipeline import (StereoPipeline, check_supported,
                                                 compute_volumes, cross_scale,
                                                 kernels_launched)

from test_torch_vmtop import KEYS, NARROW, SCENES, check_maps, jax_and_port_maps, make_scenes

D = 16


@pytest.mark.parametrize("channels", [3, 0])
def test_pyr_down_exact(channels):
    """Two levels down from a 47x63 image (odd sides: the reflect-101
    border and the decimation's last row and column), unrounded floats."""
    rng = np.random.default_rng(channels)
    shape = (47, 63, channels) if channels else (47, 63)
    img = rng.integers(0, 256, shape).astype(np.float32)
    want, got = jnp.asarray(img), torch.from_numpy(img)
    for _ in range(2):
        want, got = jax_cs.pyr_down(want), crossscale.pyr_down(got)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[:2] == (12, 16)
    assert (got.numpy() != np.round(got.numpy())).any()


@pytest.mark.parametrize("n_levels", [1, 2, 3, 4])
@pytest.mark.parametrize("reg_lambda", [0.3, 0.5])
def test_reg_inverse_weights_exact(n_levels, reg_lambda):
    got = crossscale.reg_inverse_weights(n_levels, reg_lambda)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_cs.reg_inverse_weights(n_levels, reg_lambda))


# the level shapes of a 47x63 pair at D=16: max_disp 15 -> 8 -> 5
LEVELS = ((16, 47, 63), (9, 24, 32), (6, 12, 16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_levels", [2, 3])
def test_solve_all_exact(n_levels, dtype):
    """solve_all against the jitted JAX function, bit for bit: float32 out
    of bfloat16 levels too (numpy's float32 weights promote them)."""
    rng = np.random.default_rng(n_levels)
    vols = [(rng.random(shape) * 3).astype(np.float32) for shape in LEVELS[:n_levels]]
    tvols = [torch.from_numpy(v).to(getattr(torch, dtype)) for v in vols]
    jvols = [jnp.asarray(v, jnp.dtype(dtype)) for v in vols]
    want = jax.jit(lambda *v: jax_cs.solve_all(list(v), 0.3))(*jvols)
    got = crossscale.solve_all(tvols, 0.3)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


PYRAMID_CASES = [(kw, n) for kw in (dict(), dict(vol_dtype="bfloat16"), dict(aggregation="none"),
                                    dict(aggregation="nl"), dict(cbca_arm_mode="multilevel"))
                 for n in (2, 3)]
PYRAMID_CASES.append((dict(cost="census_from2", d_stream_block=2, max_disp=13), 2))


def test_pyramid_is_supported_with_the_same_kernels():
    """A pyramid frame launches the kernels of its finest level's frame (A
    and B once a level, the rest once: the levels are fused before SGM)."""
    for kw, levels in PYRAMID_CASES:
        base = default_config(**{"max_disp": D - 1, **kw})
        cfg = base.replace(pyramid_levels=levels)
        check_supported(cfg)
        assert kernels_launched(cfg) == kernels_launched(base)


def test_streamed_pyramid_needs_blocks_that_divide_each_level():
    """max_disp 15 -> 8 at level 1: 9 disparities, not in blocks of 4 (the
    JAX package's streamed loop would drop the ninth): refused, naming the
    flags; max_disp 13 -> 7 (14 and 8 disparities) streams in blocks of 2."""
    with pytest.raises(NotImplementedError, match="d_stream_block=4 with pyramid_levels=2"):
        check_supported(default_config(max_disp=15, d_stream_block=4, pyramid_levels=2))
    check_supported(default_config(max_disp=13, d_stream_block=2, pyramid_levels=2))


@pytest.mark.parametrize("vol_dtype", ["float32", "bfloat16"])
def test_streamed_pyramid_frame_is_the_dense_one(vol_dtype):
    p = make_synthetic_pair(h=24, w=40, max_disp=13, seed=4)
    cfg = default_config(max_disp=13, pyramid_levels=2, vol_dtype=vol_dtype, do_refine=False)
    dense = StereoPipeline(cfg, device="cpu")(p.left, p.right)
    streamed = StereoPipeline(cfg.replace(d_stream_block=2), device="cpu")(p.left, p.right)
    for key in dense:
        assert torch.equal(streamed[key], dense[key])


def test_cross_scale_fuses_float32_volumes():
    """The pipeline's pyramid step on bfloat16 volumes hands SGM float32
    volumes, level 0's weight times the finest volume plus the coarser
    levels' terms; one level is the finest volume times its weight."""
    p = make_synthetic_pair(h=24, w=40, max_disp=13, seed=5)
    left, right = (torch.from_numpy(x).to(torch.float32) for x in (p.left, p.right))
    cfg = default_config(max_disp=13, vol_dtype="bfloat16", pyramid_levels=3)
    vols, _ = compute_volumes(left, right, cfg)
    fused = cross_scale(vols, left, right, cfg)
    assert sorted(fused) == sorted(vols)
    for lor in vols:
        assert fused[lor].dtype == torch.float32 and fused[lor].shape == vols[lor].shape
        assert not torch.equal(fused[lor], float(crossscale.reg_inverse_weights(3)[0])
                               * vols[lor].float())
    one = crossscale.solve_all([vols[0]])
    assert torch.equal(one, float(crossscale.reg_inverse_weights(1)[0]) * vols[0].float())
    # the module's own form: each view's pyramid built from the finest level
    for lor in vols:
        assert torch.equal(crossscale.cross_scale_volume(left, right, cfg, 3, cfg.reg_lambda, lor),
                           fused[lor])


@pytest.fixture(scope="module")
def scenes():
    return make_scenes()


# census_from2 (its "grad" blend), multilevel arms and two pyramid levels,
# with CBCA and 4-path SGM; the windows narrowed (tests/test_torch_vmtop.py's
# NARROW, the multilevel levels to 4 / 6 / 8 steps, the second census window
# to 5x5) to keep the JAX compile short
CROSS_SCALE = dict(NARROW, cost="census_from2", census_rv2=2, census_ru2=2,
                   cbca_arm_mode="multilevel", cbca_cross_ls=(4, 6, 8), pyramid_levels=2,
                   do_refine=False)


@pytest.fixture(scope="module")
def cross_scale_maps(scenes):
    return jax_and_port_maps("census_grad_cbca_sgm", scenes, narrow=CROSS_SCALE)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("key", KEYS)
def test_cross_scale_matches_jax(cross_scale_maps, scene, key):
    check_maps(cross_scale_maps, scene, key)
