"""The torch port as a whole: import, configuration, presets, the slice.

The slice is the default preset with ``do_refine=False``: censusGrad cost
-> cross arms -> CBCA (2 iterations) -> 4-path SGM -> WTA on the left and
right volumes. On the CPU every kernel-backed op runs its plain torch
version. Tolerances: none — every WTA map here must match exactly.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import config as jax_config
from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.models.presets import MODEL_REGISTRY as JAX_REGISTRY

import mystereomatching_tpu_torch as port
from mystereomatching_tpu_torch import data as port_data
from mystereomatching_tpu_torch.config import as_port_config
from mystereomatching_tpu_torch.models import presets as port_presets
from mystereomatching_tpu_torch.utils.metrics import bad_pixel_rate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
MODULES = [
    "mystereomatching_tpu_torch",
    "mystereomatching_tpu_torch.data",
    "mystereomatching_tpu_torch.models",
    "mystereomatching_tpu_torch.ops.aggregation",
    "mystereomatching_tpu_torch.ops.arms",
    "mystereomatching_tpu_torch.ops.census",
    "mystereomatching_tpu_torch.ops.cost",
    "mystereomatching_tpu_torch.ops.cuda_kernels",
    "mystereomatching_tpu_torch.ops.sgm",
    "mystereomatching_tpu_torch.ops.volume",
    "mystereomatching_tpu_torch.ops.wta",
    "mystereomatching_tpu_torch.pipeline",
    "mystereomatching_tpu_torch.utils.metrics",
]


def load_ref_disp(path):
    with open(path, "rb") as f:
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        return np.frombuffer(f.read(h * w * 2), np.int16).reshape(h, w).astype(np.int32)


def test_port_imports_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_default_config_equals_jax():
    ours = dataclasses.asdict(port.default_config(max_disp=23, do_refine=False))
    ref = dataclasses.asdict(jax_config.default_config(max_disp=23, do_refine=False))
    assert ours == ref


def test_as_port_config_converts_jax_instance():
    jcfg = jax_config.default_config(max_disp=31, lam_cen=11.0)
    cfg = as_port_config(jcfg)
    assert isinstance(cfg, port.MatchConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert as_port_config(cfg) is cfg


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_preset_equals_jax(name):
    assert sorted(port_presets.MODEL_REGISTRY) == sorted(JAX_REGISTRY)
    ours = dataclasses.asdict(port_presets.get_model(name, max_disp=31))
    assert ours == dataclasses.asdict(JAX_REGISTRY[name](max_disp=31))


@pytest.mark.parametrize("overrides", [
    dict(do_refine=True), dict(aggregation="bf"), dict(cost="census"),
    dict(optimization="so"), dict(optimization="wta"), dict(do_vmtop=True),
    dict(d_stream_block=4), dict(sub_ipol=True), dict(uniq_check=True), dict(sgm_scan_num=8),
    dict(cbca_arm_mode="multilevel"), dict(vol_dtype="bfloat16"),
])
def test_unported_stage_raises(overrides):
    cfg = port.default_config(max_disp=7, **{"do_refine": False, **overrides})
    with pytest.raises(NotImplementedError):
        port.StereoPipeline(cfg)(np.zeros((8, 12, 3), np.uint8), np.zeros((8, 12, 3), np.uint8))


def test_cuda_pipeline_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port.StereoPipeline(port.default_config(do_refine=False), device="cuda")


def test_synthetic_pair_is_the_jax_one():
    from mystereomatching_tpu.data import make_synthetic_pair

    a = port_data.make_synthetic_pair(h=32, w=40, max_disp=7, seed=5)
    b = make_synthetic_pair(h=32, w=40, max_disp=7, seed=5)
    np.testing.assert_array_equal(a.left, b.left)
    np.testing.assert_array_equal(a.right, b.right)
    np.testing.assert_array_equal(a.gt, b.gt)


@pytest.fixture(scope="module")
def slice_outputs(small_pair):
    """The slice on small_pair in both packages; JAX is jitted once."""
    jcfg = jax_config.default_config(max_disp=small_pair.max_disp, do_refine=False)
    fn = jax.jit(lambda l, r: jax_pipeline.match_pair(l, r, jcfg))
    ref = {k: np.asarray(v) for k, v in
           fn(jnp.asarray(small_pair.left), jnp.asarray(small_pair.right)).items()}
    ours = port.StereoPipeline(as_port_config(jcfg))(small_pair.left, small_pair.right)
    return ref, {k: v.numpy() for k, v in ours.items()}


@pytest.mark.parametrize("key", ["disp_left_raw", "disp_right_raw", "disparity"])
def test_slice_matches_jax(slice_outputs, key):
    ref, ours = slice_outputs
    assert ours[key].dtype == ref[key].dtype
    assert int((ours[key] != ref[key]).sum()) == 0


def test_slice_matches_reference_binary_small_scale():
    pair = port_data.make_synthetic_pair(name="small_scale", h=144, w=192,
                                         max_disp=23, seed=3)
    out = port.match_pair(torch.from_numpy(pair.left), torch.from_numpy(pair.right),
                          port.default_config(max_disp=23, do_refine=False))
    ref = load_ref_disp(os.path.join(GOLDEN, "small_scale_wta.bin"))
    assert int((out["disp_left_raw"].numpy() != ref).sum()) == 0
    bad = bad_pixel_rate(out["disparity"], torch.from_numpy(pair.gt),
                         torch.from_numpy(pair.masks["nonocc"]))
    assert 0.0 <= bad < 0.01


def test_bad_pixel_rate_counts_invalid_and_skips_no_gt():
    gt = torch.tensor([[0.0, 2.0, 3.0, 4.0]])
    disp = torch.tensor([[9.0, 2.5, -16.0, 6.0]])
    assert bad_pixel_rate(disp, gt) == pytest.approx(2 / 3)
    mask = torch.tensor([[True, True, False, False]])
    assert bad_pixel_rate(disp, gt, mask) == 0.0
