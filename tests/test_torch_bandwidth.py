"""The copy-bandwidth probe's plain version (``ops/bandwidth.py``) against
the TPU kernel it replaces, on the CPU.

``scripts/check_bw.py`` builds a 161 MB array and times it on a TPU at
import, so it is parsed with ``ast`` and only ``copy_kern`` and its
``pallas_call`` wrapper ``pallas_copy`` run, in TPU interpret mode, on a
[2, 10, 60, 300] float32 array made with ``rng.random`` as the script
makes its own. Interpret mode takes all four of the script's block
shapes: it pads a block that passes the array's edge, as the TPU does, so
each shape runs on this small array with partial blocks ((4, 8, 60, 256)
along G, H and W; (1, 8, 64, 512) along H, D and W; (4, 24, 64, 128) along
all four; (1, 375, 60, 450) along H and W). The comparison is exact: both
multiply by 1.0001 in float32, rounded once. The kernel itself runs on
the card only (``tests/test_torch_cuda.py``).
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

from mystereomatching_tpu_torch.ops import bandwidth
from mystereomatching_tpu_torch.ops import cuda_kernels as ck

CHECK_BW = Path(__file__).resolve().parents[1] / "scripts" / "check_bw.py"
SHAPE = (2, 10, 60, 300)
BLOCKS = [(4, 8, 60, 256), (1, 8, 64, 512), (4, 24, 64, 128), (1, 375, 60, 450)]


@pytest.fixture(scope="module")
def pallas_copy():
    keep = [node for node in ast.parse(CHECK_BW.read_text()).body
            if isinstance(node, ast.FunctionDef) and node.name in ("copy_kern", "pallas_copy")]
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu)
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(CHECK_BW), "exec"), ns)
    return ns["pallas_copy"]


@pytest.mark.parametrize("block", BLOCKS)
def test_scaled_copy_plain_is_the_tpu_kernel(pallas_copy, block):
    x = np.random.default_rng(0).random(SHAPE, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_copy(jnp.asarray(x), block))
    got = bandwidth.scaled_copy_plain(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_copy_bw_wrapper_refuses():
    """The wrapper takes a CUDA float32 tensor and positive tiles only."""
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ck.copy_bw(x, 2, 4)
    with pytest.raises(ValueError, match="tile"):
        ck.copy_bw(x, 0, 4)
    assert ck.launches["copy_bw"] == 0
