"""The SGM-layout probes' plain versions against their JAX counterparts, on the CPU.

``scripts/check_sgm3.py``, ``check_sgm4.py`` and ``check_sgm5.py`` run on
a TPU at import, so their kernels are held here through the functions they
compute: the ``full`` recurrence is the JAX package's kernel C,
``pallas_kernels.sgm_scan_pallas``, on the [G, D, H, W] transpose (in
interpret mode, in 8-row chunks so that its carry crosses chunks);
``copy`` and ``prev`` are ``jnp`` expressions. ``check_sgm5.py``'s
two copies also run themselves: the file is parsed with ``ast`` and only
``_cdiv`` with ``make`` and ``scan`` (the rolled row loop) or with
``make_unrolled`` and ``scan_u`` run, in TPU interpret mode (8-row chunks,
a 256-column block over W = 40). Inputs as the scripts make
them (``rng.random``) at [G, H, D, W] = [4, 24, 60, 40]. Every comparison
is exact but one: in interpret mode XLA's CPU backend contracts the
kernel's minL + p2 s into a fused multiply-add, which the plain version
and the card's kernels (built with -fmad=false, as kernel C) do not. So
``full`` is exact where p2 s is exact, on the pipeline's own penalty
scales (1 and 1 / 4), and within a few ULPs on the scripts' random ones.
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

from mystereomatching_tpu.ops.pallas_kernels import sgm_scan_pallas

from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops import sgm_probes

SHAPE = (4, 24, 60, 40)  # [G, H, D, W]
CHECK_SGM5 = Path(__file__).resolve().parents[1] / "scripts" / "check_sgm5.py"


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    g, h, _, w = SHAPE
    return rng.random(SHAPE, np.float32), rng.random((g, h, w), np.float32)


def _full(vol, ps, hc):
    """(the JAX kernel C on the transpose, transposed back; the plain full)."""
    want = jnp.swapaxes(sgm_scan_pallas(jnp.swapaxes(jnp.asarray(vol), 1, 2), jnp.asarray(ps),
                                        interpret=True, hc_override=hc), 1, 2)
    got = sgm_probes.full_plain(torch.from_numpy(vol), torch.from_numpy(ps))
    assert got.is_contiguous() and tuple(got.shape) == SHAPE
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("hc", [8, 24])
def test_full_plain_is_the_jax_kernel_c(inputs, hc):
    """On the penalty scales the pipeline makes (``sgm.penalty_scale``: 1,
    or 1 / 4 across an edge), where p2 s is exact."""
    vol, _ = inputs
    g, h, _, w = SHAPE
    ps = np.where(np.random.default_rng(1).random((g, h, w)) < 0.5, 1.0, 0.25).astype(np.float32)
    want, got = _full(vol, ps, hc)
    np.testing.assert_array_equal(got, want)


def test_full_plain_near_the_jax_kernel_c_on_random_scales(inputs):
    """On the scripts' random scales: minL + p2 s, which the JAX kernel
    computes as one fused multiply-add in interpret mode, rounds twice here;
    the path costs lie in [0, 5), where 1e-6 is a few ULPs."""
    vol, ps = inputs
    want, got = _full(vol, ps, 8)
    assert got.max() < 5.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_copy_plain_is_jnp(inputs):
    vol, ps = inputs
    got = sgm_probes.plain(torch.from_numpy(vol), torch.from_numpy(ps), "copy")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(vol) * 1.01))


@pytest.mark.parametrize("make,scan", [("make_unrolled", "scan_u"), ("make", "scan")])
def test_copy_plain_is_the_unrolled_tpu_kernel(inputs, make, scan):
    """``scan_u(vol, ps, "copy")`` and ``scan(vol, ps, "copy")``, the TPU
    kernels that ``sgm_probe_unrolled``'s and ``sgm_probe_rolled``'s copy
    replace (the row loop unrolled and rolled), in interpret mode."""
    keep = [node for node in ast.parse(CHECK_SGM5.read_text()).body
            if isinstance(node, ast.FunctionDef) and node.name in ("_cdiv", make, scan)]
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu)
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(CHECK_SGM5), "exec"), ns)
    vol, ps = inputs
    with pltpu.force_tpu_interpret_mode():
        want = ns[scan](jnp.asarray(vol), jnp.asarray(ps), "copy")
    got = sgm_probes.copy_plain(torch.from_numpy(vol))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prev_plain_is_a_lax_scan(inputs):
    vol, ps = inputs

    def step(prev, c):
        nxt = c + prev * 0.5
        return nxt, nxt

    _, rows = jax.lax.scan(step, jnp.zeros_like(jnp.asarray(vol)[:, 0]),
                           jnp.moveaxis(jnp.asarray(vol), 1, 0))
    got = sgm_probes.plain(torch.from_numpy(vol), torch.from_numpy(ps), "prev")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.moveaxis(rows, 0, 1)))


@pytest.mark.parametrize("kind", ["copy", "prev", "full"])
def test_probe_wrappers_refuse(inputs, kind):
    """The wrappers take CUDA tensors only, a probe's own kinds, D <= 256
    and, outside hdw, G <= 4."""
    vol, ps = (torch.from_numpy(a) for a in inputs)
    with pytest.raises(ValueError, match="CUDA"):
        ck.sgm_probe_rolled(vol, ps, kind)
    if kind != "prev":
        with pytest.raises(ValueError, match="CUDA"):
            ck.sgm_probe_unrolled(vol, ps, kind)
    with pytest.raises(ValueError, match="kind"):
        ck.sgm_probe_unrolled(vol, ps, "prev")
    with pytest.raises(ValueError, match="G=5"):
        ck.sgm_probe_g(torch.zeros(5, 2, 3, 4), torch.zeros(5, 2, 4))
    with pytest.raises(ValueError, match="D=257"):
        ck.sgm_probe_hdw(torch.zeros(1, 2, 257, 4), torch.zeros(1, 2, 4))
    assert sum(ck.launches[name] for name in ck.SGM_PROBES) == 0
