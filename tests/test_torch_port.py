"""The torch port as a whole: import, configuration, presets, the slice.

The slice compared with the JAX pipeline here is the default preset with
``do_refine=False``: censusGrad cost -> cross arms -> CBCA (2 iterations)
-> 4-path SGM -> WTA on the left and right volumes (the refine chain is
held against JAX in tests/test_torch_refine.py, the ``sgm8_full`` preset
in tests/test_torch_sgm8.py). On the CPU every
kernel-backed op runs its plain torch version. Tolerances: none — every
WTA map here must match exactly.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import config as jax_config
from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.models.presets import MODEL_REGISTRY as JAX_REGISTRY
from mystereomatching_tpu.models.presets import list_models as jax_list_models

import mystereomatching_tpu_torch as port
from mystereomatching_tpu_torch import data as port_data
from mystereomatching_tpu_torch.config import as_port_config
from mystereomatching_tpu_torch.pipeline import check_supported
from mystereomatching_tpu_torch.models import presets as port_presets
from mystereomatching_tpu_torch.utils.metrics import bad_pixel_rate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
MODULES = [
    "mystereomatching_tpu_torch",
    "mystereomatching_tpu_torch.data",
    "mystereomatching_tpu_torch.entry",
    "mystereomatching_tpu_torch.models",
    "mystereomatching_tpu_torch.ops.aggregation",
    "mystereomatching_tpu_torch.ops.arms",
    "mystereomatching_tpu_torch.ops.aws",
    "mystereomatching_tpu_torch.ops.bandwidth",
    "mystereomatching_tpu_torch.ops.canny",
    "mystereomatching_tpu_torch.ops.cbbi",
    "mystereomatching_tpu_torch.ops.census",
    "mystereomatching_tpu_torch.ops.combine",
    "mystereomatching_tpu_torch.ops.cost",
    "mystereomatching_tpu_torch.ops.cuda_kernels",
    "mystereomatching_tpu_torch.ops.fif",
    "mystereomatching_tpu_torch.ops.guided",
    "mystereomatching_tpu_torch.ops.median",
    "mystereomatching_tpu_torch.ops.mst",
    "mystereomatching_tpu_torch.ops.nl",
    "mystereomatching_tpu_torch.ops.refine",
    "mystereomatching_tpu_torch.ops.sgm",
    "mystereomatching_tpu_torch.ops.so",
    "mystereomatching_tpu_torch.ops.volume",
    "mystereomatching_tpu_torch.ops.vmtop",
    "mystereomatching_tpu_torch.ops.wta",
    "mystereomatching_tpu_torch.parallel",
    "mystereomatching_tpu_torch.parallel._harness",
    "mystereomatching_tpu_torch.parallel.counters",
    "mystereomatching_tpu_torch.parallel.halo",
    "mystereomatching_tpu_torch.parallel.launch",
    "mystereomatching_tpu_torch.parallel.mesh",
    "mystereomatching_tpu_torch.parallel.sharded",
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


def test_port_runs_from_a_copy_of_its_package_alone(tmp_path):
    """The package needs no file of the JAX package: a copy of it alone
    imports, builds its configuration and scenes, and runs the CPU pipeline."""
    shutil.copytree(os.path.join(ROOT, "mystereomatching_tpu_torch"),
                    tmp_path / "mystereomatching_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = textwrap.dedent("""
        import sys
        import mystereomatching_tpu_torch as port
        from mystereomatching_tpu_torch.data import make_synthetic_pair
        assert port.__file__.startswith(sys.argv[1]), port.__file__
        pair = make_synthetic_pair(h=16, w=24, max_disp=3, seed=1)
        out = port.StereoPipeline(port.default_config(max_disp=3), device="cpu")(
            pair.left, pair.right)
        assert tuple(out["disparity"].shape) == (16, 24)
        assert not any(m.startswith(("jax", "mystereomatching_tpu.")) for m in sys.modules)
    """)
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_default_config_equals_jax():
    ours = dataclasses.asdict(port.default_config(max_disp=23, do_refine=False))
    ref = dataclasses.asdict(jax_config.default_config(max_disp=23, do_refine=False))
    assert ours == ref
    assert dataclasses.asdict(port.default_config()) == dataclasses.asdict(
        jax_config.default_config())
    assert dataclasses.asdict(port.config.fast_config()) == dataclasses.asdict(
        jax_config.fast_config())


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


PORTED_FROM_THIS_LIST = [dict(do_refine=True, lrc_classify=True),
                         dict(do_refine=True, do_bg_ipol=True),
                         dict(do_refine=True, compute_both_volumes=False),
                         dict(vol_dtype="bfloat16"),
                         dict(optimization="wta"), dict(aggregation="nl"),
                         dict(aggregation="bf"), dict(do_vmtop=True),
                         dict(cbca_double_win=True), dict(aggregation="gf"),
                         dict(aggregation="gf", gf_color_guide=False),
                         dict(cost="zncc", aggregation="bf"),
                         dict(cbca_double_win=True, cbca_combine=2),
                         dict(cbca_double_win=True, cbca_combine=3),
                         dict(do_vmtop=True, vmtop_method=1), dict(do_vmtop=True, vmtop_method=2),
                         dict(cost="bt"), dict(optimization="so"), dict(cost="trunc_ad"),
                         dict(cost="trunc_ad", aggregation="bf"), dict(aggregation="aws"),
                         dict(aggregation="fif"), dict(aggregation="gfnl"),
                         dict(cost="bt", aggregation="gf"),
                         dict(cost="zncc", aggregation="nl"), dict(cost="bt", aggregation="nl"),
                         dict(pyramid_levels=2), dict(cbca_arm_mode="multilevel"),
                         dict(cost="census_from2", d_stream_block=4),
                         dict(cost="zncc", aggregation="none"), dict(cost="zncc"),
                         dict(do_refine=True, do_fill_surrounding=True),
                         dict(do_refine=True, do_pkr=True),
                         dict(do_refine=True, rv_use_combine_bg=True),
                         dict(do_refine=True, rv_int_ratio_quirk=False),
                         dict(do_refine=True, do_cbbi=True), dict(do_refine=True, do_wm=True),
                         dict(do_refine=True, do_da=True),
                         dict(do_refine=True, do_rv_whole_image=True),
                         dict(do_refine=True, do_bg_ipol=True, bg_ipol_kitti=True),
                         dict(cbca_double_win=True, cbca_combine=1),
                         dict(cbca_double_win=True, cbca_combine=1, do_refine=True)]


@pytest.mark.parametrize("overrides", [
    dict(do_refine=True, lrc_classify=True), dict(do_refine=True, do_fill_surrounding=True),
    dict(do_refine=True, do_pkr=True), dict(do_refine=True, rv_use_combine_bg=True),
    dict(do_refine=True, rv_int_ratio_quirk=False), dict(do_refine=True, do_cbbi=True),
    dict(do_refine=True, do_bg_ipol=True), dict(do_refine=True, do_wm=True),
    dict(do_refine=True, do_da=True), dict(cost="bt"),
    dict(do_refine=True, do_rv_whole_image=True),
    dict(do_refine=True, compute_both_volumes=False),
    dict(aggregation="bf"), dict(cost="zncc"),
    dict(optimization="so"), dict(optimization="wta"), dict(do_vmtop=True),
    dict(d_stream_block=4, cbca_double_win=True), dict(aggregation="nl"),
    dict(cbca_double_win=True), dict(pyramid_levels=2),
    dict(cbca_arm_mode="multilevel"), dict(vol_dtype="bfloat16"),
    dict(do_refine=True, do_bg_ipol=True, bg_ipol_kitti=True), dict(vol_dtype="float16"),
    dict(cost="census_from2", d_stream_block=4),
    dict(aggregation="gf"), dict(aggregation="gf", gf_color_guide=False),
    dict(cost="zncc", aggregation="bf"),
    dict(cbca_double_win=True, cbca_combine=2), dict(cbca_double_win=True, cbca_combine=3),
    dict(do_vmtop=True, vmtop_method=1), dict(do_vmtop=True, vmtop_method=2),
    dict(cbca_double_win=True, cbca_combine=1),
    dict(cbca_double_win=True, cbca_combine=1, do_refine=True),
    dict(cbca_double_win=True, vol_dtype="bfloat16"), dict(do_vmtop=True, vol_dtype="bfloat16"),
    dict(aggregation="bf", d_stream_block=4), dict(aggregation="gf", vol_dtype="bfloat16"),
    dict(cost="zncc", aggregation="nl"), dict(cost="zncc", aggregation="none"),
    dict(cost="trunc_ad"), dict(cost="trunc_ad", aggregation="bf"), dict(aggregation="aws"),
    dict(aggregation="fif"), dict(aggregation="gfnl"), dict(cost="bt", aggregation="gf"),
    dict(cost="bt", d_stream_block=4), dict(cost="trunc_ad", vol_dtype="bfloat16"),
    dict(optimization="so", vol_dtype="bfloat16"), dict(optimization="so", d_stream_block=4),
    dict(aggregation="fif", d_stream_block=4), dict(aggregation="aws", vol_dtype="bfloat16"),
    dict(aggregation="jbf", d_stream_block=4), dict(aggregation="gfnl", nl_neighbors=8),
    dict(cost="bt", aggregation="nl"),
    dict(cbca_double_win=True, cbca_combine=1, vol_dtype="bfloat16"),
    dict(cbca_double_win=True, cbca_combine=1, d_stream_block=4),
    dict(do_refine=True, do_pkr=True, aggregation="bf", vol_dtype="bfloat16"),
    dict(do_refine=True, do_wm=True, aggregation="gf", d_stream_block=4),
    dict(do_refine=True, do_da=True, cost="bt", d_stream_block=4),
    dict(do_refine=True, do_cbbi=True, optimization="so", vol_dtype="bfloat16"),
    dict(do_refine=True, rv_int_ratio_quirk=False, vol_dtype="float16"),
    dict(do_refine=True, rv_use_combine_bg=True, aggregation="fif", d_stream_block=4),
    dict(do_refine=True, do_fill_surrounding=True, aggregation="gfnl", nl_neighbors=8),
    dict(do_refine=True, do_rv_whole_image=True, do_vmtop=True, vol_dtype="bfloat16"),
    dict(do_refine=True, do_bg_ipol=True, bg_ipol_kitti=True, cost="zncc", d_stream_block=4),
])
def test_unported_stage_raises(overrides):
    """A stage the port does not run raises NotImplementedError. The
    stages that ``fullres_occfill`` brought in (the classifying LR check,
    the background fill, the cooperative WTA and bfloat16 volumes) and
    the NL presets (NL aggregation, WTA without SGM) were cases of this
    list and now must be accepted, and a frame must run.
    Disparity streaming (``d_stream_block``) is ported too: its cases pair
    it with what it still cannot run with. The census costs ``census`` and
    ``ad_census`` run too: their three cases name costs still refused
    instead (``bt``, ``zncc``, ``census_from2``). The box and guided
    filters, ZNCC, vmTop and double-window CBCA run too: their cases are
    in the list with what they still cannot run with (PKR's merge
    ``cbca_combine=1``, streaming, bfloat16, ZNCC under CBCA, NL or no
    aggregation). So do the BT and truncated-AD costs, SO, AWS, FIF and
    GFNL: their cases run, and the list gains what they cannot run with
    (streaming, bfloat16, GFNL on an 8-neighbour tree, BT under NL). NL
    over every cost runs too (ROADMAP §1 item 4): ZNCC and BT under NL are
    accepted, and a frame must run. So do the remaining costs, the
    multilevel and adaptive arms and the cross-scale pyramid (ROADMAP §1
    item 5): the pyramid, the multilevel arms, census_from2 streamed and
    ZNCC under CBCA or no aggregation are accepted, and a frame must run.
    So do the refinement variants (ROADMAP §1 item 6): the census border
    fill, PKR and its merge ``cbca_combine=1``, RV_combine_BG, the
    histogram region vote, CBBI, the KITTI fill, WM, DA and the whole-image
    vote are accepted, and a frame must run; the list gains each of them
    with what it still cannot run with (bfloat16 or streaming where those
    are refused, GFNL on an 8-neighbour tree, float16)."""
    cfg = port.default_config(max_disp=7, **{"do_refine": False, **overrides})

    def run():
        return port.StereoPipeline(cfg, device="cpu")(np.zeros((8, 12, 3), np.uint8),
                                                      np.zeros((8, 12, 3), np.uint8))

    if overrides in PORTED_FROM_THIS_LIST:
        check_supported(cfg)
        assert tuple(run()["disparity"].shape) == (8, 12)
        return
    with pytest.raises(NotImplementedError):
        run()


NEW_STAGES = {"bt_so": ("cost 'bt'", "SO"), "census_fif_sgm": ("aggregation 'fif'",),
              "aws_wta": ("cost 'trunc_ad'", "aggregation 'aws'"),
              "gfnl_wta": ("aggregation 'gfnl'",)}


@pytest.mark.parametrize("name", ["bt_so", "census_fif_sgm", "aws_wta", "gfnl_wta"])
def test_unported_preset_raises(name):
    """The last four presets ported (ROADMAP §1 items 3.5-3.8) run in
    float32 and dense only: in bfloat16 volumes, or streamed over blocks of
    disparities, each is refused, the message naming each of its new
    stages."""
    for bad in (dict(vol_dtype="bfloat16"), dict(d_stream_block=4)):
        with pytest.raises(NotImplementedError) as err:
            port_presets.build(name, max_disp=7, device="cpu", **bad)
        for stage in NEW_STAGES[name]:
            assert stage in str(err.value), (stage, str(err.value))


@pytest.mark.parametrize("name", jax_list_models())
def test_every_jax_preset_is_supported(name):
    """Every preset of the JAX registry, at its default arguments, runs in
    the port, whose registry names the same presets."""
    assert port_presets.list_models() == jax_list_models()
    check_supported(port_presets.get_model(name))


@pytest.mark.parametrize("name", ["aws_wta", "census_fif_sgm", "bt_so", "gfnl_wta"])
def test_entry_runs_the_preset_on_the_cpu(name):
    """``entry(device, preset)`` builds the named preset at max_disp 31; its
    pipeline runs on a 24x40 crop of the example pair."""
    from mystereomatching_tpu_torch.entry import MAX_DISP, entry

    fn, (left, right) = entry("cpu", name)
    assert dataclasses.asdict(fn.cfg) == dataclasses.asdict(
        port_presets.get_model(name, max_disp=MAX_DISP))
    out = fn(left[:24, :40], right[:24, :40])
    assert sorted(out) == ["disp_left_raw", "disp_right_raw", "disparity"]
    assert tuple(out["disparity"].shape) == (24, 40)
    assert bool(torch.isfinite(out["disparity"]).all())


@pytest.mark.parametrize("name", ["census_cbca_vmtop", "cbca_double", "ad_grad_gf",
                                  "zncc_bf_wta", "aws_wta", "census_fif_sgm", "bt_so",
                                  "gfnl_wta"])
def test_ported_preset_accepted(name):
    check_supported(port_presets.get_model(name))
    assert port_presets.build(name, max_disp=7, device="cpu").device == torch.device("cpu")


def test_cuda_pipeline_without_cuda_raises(monkeypatch):
    """The card is the default device: without CUDA the pipeline raises
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in (dict(device="cuda"), {}):
        with pytest.raises(RuntimeError):
            port.StereoPipeline(port.default_config(do_refine=False), **kw)
    for name in ("census_grad_cbca_sgm", "sgm8_full"):
        with pytest.raises(RuntimeError):
            port_presets.build(name, max_disp=7)


def test_synthetic_pair_is_the_jax_one():
    from mystereomatching_tpu.data import make_adversarial_pair, make_synthetic_pair

    for ours, ref, kw in ((port_data.make_synthetic_pair, make_synthetic_pair,
                           dict(h=32, w=40, max_disp=7, seed=5)),
                          (port_data.make_adversarial_pair, make_adversarial_pair,
                           dict(h=40, w=56, max_disp=11, seed=2))):
        a, b = ours(**kw), ref(**kw)
        np.testing.assert_array_equal(a.left, b.left)
        np.testing.assert_array_equal(a.right, b.right)
        np.testing.assert_array_equal(a.gt, b.gt)
        assert sorted(a.masks) == sorted(b.masks)
        for k in a.masks:
            np.testing.assert_array_equal(a.masks[k], b.masks[k])


@pytest.fixture(scope="module")
def slice_outputs(small_pair):
    """The slice on small_pair in both packages; JAX is jitted once."""
    jcfg = jax_config.default_config(max_disp=small_pair.max_disp, do_refine=False)
    fn = jax.jit(lambda l, r: jax_pipeline.match_pair(l, r, jcfg))
    ref = {k: np.asarray(v) for k, v in
           fn(jnp.asarray(small_pair.left), jnp.asarray(small_pair.right)).items()}
    ours = port.StereoPipeline(as_port_config(jcfg), device="cpu")(small_pair.left,
                                                                  small_pair.right)
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
