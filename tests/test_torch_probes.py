"""The gather and prefix-sum probes' plain versions (``ops/plane_probes.py``)
against the JAX functions of ``scripts/micro4.py``, on the CPU.

The probe's inputs are made as the script makes them (seed 0). The
gathers equal ``jnp.take_along_axis`` exactly. The cumsums of both
packages, and a sequential float32 sum, lie within
``plane_probes.cumsum_tolerance`` of the float64 cumsum; a sum off by
twice that bound is refused. ``plane_probes.cumsum_sequential``, which the
cumsum kernels must equal bit for bit, is the running float32 sum, one
term after another. The kernels themselves run on the card only
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu_torch.ops import plane_probes as pp

SHAPES = [(375, 450), (33, 65), (1, 97)]


def _inputs(shape):
    rng = np.random.default_rng(0)
    x = rng.random(shape, np.float32)
    return x, rng.integers(0, shape[0], shape).astype(np.int32), \
        rng.integers(0, shape[1], shape).astype(np.int32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
def test_gathers_equal_take_along_axis(shape, axis):
    x, idx_s, idx_l = _inputs(shape)
    idx = idx_s if axis == 0 else idx_l
    fn = pp.gather_rows_plain if axis == 0 else pp.gather_cols_plain
    ours = fn(torch.from_numpy(x), torch.from_numpy(idx))
    ref = jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx), axis=axis)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", SHAPES + [(20000, 3)])
@pytest.mark.parametrize("axis", [0, 1])
def test_cumsums_within_the_bound(shape, axis):
    x, _, _ = _inputs(shape)
    xt = torch.from_numpy(x)
    assert pp.cumsum_error(pp.cumsum_plain(xt, axis), xt, axis) <= 1.0
    assert pp.cumsum_error(torch.from_numpy(np.array(jnp.cumsum(jnp.asarray(x), axis))),
                           xt, axis) <= 1.0
    sequential = np.cumsum(x, axis, dtype=np.float32)
    assert pp.cumsum_error(torch.from_numpy(sequential), xt, axis) <= 1.0


def test_cumsum_bound_refuses_an_off_sum():
    x, _, _ = _inputs((375, 450))
    xt = torch.from_numpy(x)
    off = pp.cumsum_reference(xt, 0) + 2 * pp.cumsum_tolerance(xt, 0)
    assert pp.cumsum_error(off, xt, 0) > 1.0


@pytest.mark.parametrize("shape", SHAPES + [(20000, 3)])
@pytest.mark.parametrize("axis", [0, 1])
def test_cumsum_sequential_adds_in_order(shape, axis):
    x, _, _ = _inputs(shape)
    xs = np.moveaxis(x * 2 - 0.5, axis, 0)
    want = np.empty_like(xs)
    run = np.zeros(xs.shape[1:], np.float32)
    for i, term in enumerate(xs):
        run = run + term
        want[i] = run
    got = pp.cumsum_sequential(torch.from_numpy(np.moveaxis(xs, 0, axis)), axis)
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(want, 0, axis))
