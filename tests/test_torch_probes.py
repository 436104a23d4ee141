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

The TPU kernel ``k_cumsum_lane`` itself runs too, through the script's
``pallas_call`` in TPU interpret mode. ``scripts/micro4.py`` runs its
probes on a TPU at import, so it is parsed with ``ast`` and only that
kernel's definition runs.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mystereomatching_tpu_torch.ops import plane_probes as pp

MICRO4 = Path(__file__).resolve().parents[1] / "scripts" / "micro4.py"

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


def _k_cumsum_lane():
    """``scripts/micro4.py``'s ``k_cumsum_lane``, run alone in a namespace
    of its own (nothing else of the file runs)."""
    keep = [node for node in ast.parse(MICRO4.read_text()).body
            if isinstance(node, ast.FunctionDef) and node.name == "k_cumsum_lane"]
    ns = {"jnp": jnp}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(MICRO4), "exec"), ns)
    return ns["k_cumsum_lane"]


@pytest.mark.parametrize("shape", [(375, 450), (33, 65)])
def test_cumsum_lane_tpu_kernel_and_sequential_sums_within_the_bound(shape):
    """The TPU kernel in interpret mode, with the script's block specs (the
    whole plane in VMEM), and the sequential float32 sums that the
    ``cumsum_cols`` kernel equals both lie within the bound of the float64
    cumsum; they sum in different orders, so only the bound holds them
    together."""
    x, _, _ = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        tpu = pl.pallas_call(
            _k_cumsum_lane(),
            out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        )(jnp.asarray(x))
    xt = torch.from_numpy(x)
    assert pp.cumsum_error(torch.from_numpy(np.array(tpu)), xt, 1) <= 1.0
    assert pp.cumsum_error(pp.cumsum_sequential(xt, 1), xt, 1) <= 1.0
