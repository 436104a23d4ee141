"""Disparity streaming and the row-band 'disp' axis of the port against the
JAX package, on the CPU.

The block builders (``intersect_arms_block``, ``hamming_volume(disps=)``,
``block_cost_builder``) against the JAX package's and against the dense
volume sliced at the block; ``fullres_occfill`` with ``d_stream_block=4`` in
its two bench-suite configurations at D=16 against the jitted JAX
``match_pair`` and the port's dense path (with narrow windows); and ``run_row_bands`` with
``n_row=2, n_disp=2`` (four gloo ranks) against the jitted JAX
``sharded_match_pair`` on a ('data', 'row', 'disp') mesh and the dense map.
Inputs are made with numpy from a seed. Every comparison is exact, but the
fused census-gradient cost against the JAX package's, whose tolerance is
stated where it is asserted; bfloat16 maps are compared as uint16 bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import models as jax_models
from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.ops import arms as jax_arms
from mystereomatching_tpu.ops import census as jax_census
from mystereomatching_tpu.ops import cost as jax_cost
from mystereomatching_tpu.parallel import sharded as jax_sharded
from mystereomatching_tpu.parallel.mesh import make_mesh

from mystereomatching_tpu_torch import StereoPipeline
from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import arms, census, cost
from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.parallel import check_sharded_support, run_row_bands
from mystereomatching_tpu_torch.parallel._harness import Job, run_jobs
from mystereomatching_tpu_torch.parallel.launch import band_pipeline
from mystereomatching_tpu_torch.parallel.mesh import RowMesh
from mystereomatching_tpu_torch.pipeline import check_supported, kernels_launched, to_gray

D, DB = 16, 4                      # disparities, and the streaming block
BLOCKS = [0, D // DB - 1]          # the first block and the last, at the image edge
# the two bench-suite configurations (scripts/bench_suite.py:53-63), streamed
CONFIGS = {"float32_both": {},
           "bf16_cooperative": dict(vol_dtype="bfloat16", compute_both_volumes=False)}
KEYS = ["disp_left_raw", "disp_right_raw", "disparity"]
# narrow census, arm and refinement windows (the JAX sharding tests'): the
# whole pipelines take a quarter of the JAX compile time of the preset's own
WINDOWS = dict(census_rv=2, census_ru=3, cbca_cross_l=3, cbca_cross_l_out=5,
               pi_search_depth=4, rv_s_thres=4)
# the row-band 'disp' axis: the JAX sharding tests' shapes (tests/test_sharding.py)
BAND_H, BAND_W, BAND_MAX_DISP, N_CHUNKS = 96, 64, 7, 4
SMALL = dict(max_disp=BAND_MAX_DISP, **WINDOWS)
CPU4 = ["cpu"] * 4


def _bits(x) -> np.ndarray:
    """A result as comparable numpy: bfloat16 as its uint16 bit patterns."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def assert_same(got, want):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape, w.dtype, w.shape)
    np.testing.assert_array_equal(g, w)


def _block(b: int) -> np.ndarray:
    return np.arange(b * DB, (b + 1) * DB, dtype=np.int32)


@pytest.fixture(scope="module")
def pair():
    return make_synthetic_pair(h=48, w=64, max_disp=D - 1, seed=0)


@pytest.fixture(scope="module")
def scene(pair):
    """The pair's float32 images, gray planes and cross arms (the port's,
    equal to the JAX package's: tests/test_torch_cost.py)."""
    imgs = [torch.from_numpy(img.astype(np.float32)) for img in (pair.left, pair.right)]
    grays = [to_gray(img) for img in imgs]
    arms_pair = [arms.cross_arms(img) for img in imgs]
    return imgs, grays, arms_pair


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("lor", [0, 1])
def test_intersect_arms_block_matches_jax(lor, block):
    """Random arms, some above the int8 clamp of 127, on a plane narrower
    than the disparities: the last block's d >= W have no pixel in the
    image, and its other disparities only a few columns."""
    rng = np.random.default_rng(10 * lor + block)
    al, ar = (rng.integers(0, 140, (4, 9, 14)).astype(np.int32) for _ in range(2))
    ds = _block(block)
    want = jax_arms.intersect_arms_block(jnp.asarray(al), jnp.asarray(ar), jnp.asarray(ds), lor)
    got = arms.intersect_arms_block(torch.from_numpy(al), torch.from_numpy(ar),
                                    torch.from_numpy(ds), lor)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert_same(got, want)
    dense = arms.intersect_arms(torch.from_numpy(al), torch.from_numpy(ar), D, lor)
    assert torch.equal(got, dense[:, block * DB:(block + 1) * DB])


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("lor", [0, 1])
def test_hamming_volume_block_matches_jax(scene, lor, block):
    _, (gl, gr), _ = scene
    n = census.ncsur_code_length(3, 4)
    ds = _block(block)
    want = jax_census.hamming_volume(
        jax_census.census_code_ncsur(jnp.asarray(gl.numpy())),
        jax_census.census_code_ncsur(jnp.asarray(gr.numpy())), D, lor, n,
        disps=jnp.asarray(ds))
    cl, cr = census.census_code_ncsur(gl), census.census_code_ncsur(gr)
    got = census.hamming_volume(cl, cr, D, lor, n, disps=torch.from_numpy(ds))
    assert_same(got, want)
    assert torch.equal(got, census.hamming_volume(cl, cr, D, lor, n)[ds])


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("lor", [0, 1])
def test_block_cost_builder_matches_jax_and_dense(scene, lor, block):
    (left, right), (gl, gr), arms_pair = scene
    cfg = get_model("fullres_occfill", max_disp=D - 1, d_stream_block=DB)
    jcfg = jax_models.get_model("fullres_occfill", max_disp=D - 1, d_stream_block=DB)
    ds = _block(block)
    jargs = [jnp.asarray(t.numpy()) for t in (left, right, gl, gr)]
    want = jax_cost.block_cost_builder(*jargs, jcfg, lor,
                                       arms=jnp.asarray(arms_pair[lor].numpy()))(jnp.asarray(ds))
    got = cost.block_cost_builder(left, right, gl, gr, cfg, lor,
                                  arms=arms_pair[lor])(torch.from_numpy(ds))
    assert got.dtype == torch.float32 and got.shape == (DB, 48, 64)
    # torch.exp and XLA-CPU's exp differ by 1 ULP on about 10% of float32
    # inputs in [-40, 0] (tests/test_torch_cost.py::test_exp_fuse2): the
    # fused cost lies in [0, 2], where 1e-6 covers a few ULPs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    dense = cost.compute_cost_volume(left, right, gl, gr, cfg, lor, arms=arms_pair[lor])
    assert torch.equal(got, dense[ds])


def test_block_cost_builder_refuses_other_costs(scene):
    (left, right), (gl, gr), arms_pair = scene
    for bad in ("bt", "zncc"):
        cfg = get_model("fullres_occfill", max_disp=D - 1, d_stream_block=DB, cost=bad)
        with pytest.raises(NotImplementedError, match=bad):
            cost.block_cost_builder(left, right, gl, gr, cfg, 0, arms=arms_pair[0])


@pytest.fixture(scope="module")
def streamed_outputs(pair):
    """fullres_occfill with d_stream_block=4 in both configurations, with
    narrow windows: the JAX package's (one jit for both), the port's
    streamed and the port's dense."""
    jcfgs = [jax_models.get_model("fullres_occfill", max_disp=D - 1, d_stream_block=DB, **kw,
                                  **WINDOWS)
             for kw in CONFIGS.values()]
    fn = jax.jit(lambda l, r: [jax_pipeline.match_pair(l, r, c) for c in jcfgs])
    refs = jax.tree.map(np.asarray, fn(jnp.asarray(pair.left), jnp.asarray(pair.right)))
    ck.reset_launches()
    out = {}
    for (name, kw), ref in zip(CONFIGS.items(), refs):
        cfg = get_model("fullres_occfill", max_disp=D - 1, **kw, **WINDOWS)
        run = [StereoPipeline(c, device="cpu")(pair.left, pair.right)
               for c in (cfg.replace(d_stream_block=DB), cfg)]
        out[name] = (ref, *run)
    assert sum(ck.launches.values()) == 0
    return out


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_streamed_occfill_matches_jax(streamed_outputs, config, key):
    ref, streamed, _ = streamed_outputs[config]
    assert_same(streamed[key], ref[key])


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_streamed_occfill_equals_dense(streamed_outputs, config, key):
    _, streamed, dense = streamed_outputs[config]
    assert_same(streamed[key], dense[key])


def test_streamed_volume_is_the_dense_one(pair):
    """Bit for bit, in bfloat16: the cast before each block's CBCA rounds
    at the dense path's points."""
    from mystereomatching_tpu_torch.pipeline import compute_volumes

    cfg = get_model("fullres_occfill", max_disp=D - 1, **CONFIGS["bf16_cooperative"])
    left, right = (torch.from_numpy(img.astype(np.float32)) for img in (pair.left, pair.right))
    streamed, _ = compute_volumes(left, right, cfg.replace(d_stream_block=DB))
    dense, _ = compute_volumes(left, right, cfg)
    assert streamed[0].dtype == torch.bfloat16
    assert_same(streamed[0], dense[0])


def test_streaming_is_supported_with_the_dense_kernels():
    """Streaming runs the dense path's kernels, census_from2's blocks too;
    double-window CBCA and ZNCC, which have no block form, are refused."""
    for kw in list(CONFIGS.values()) + [dict(cost="census_from2")]:
        cfg = get_model("fullres_occfill", max_disp=255, d_stream_block=32, **kw)
        check_supported(cfg)
        assert kernels_launched(cfg) == kernels_launched(cfg.replace(d_stream_block=0))
    for bad in (dict(cbca_double_win=True), dict(cost="zncc")):
        with pytest.raises(NotImplementedError):
            check_supported(get_model("fullres_occfill", max_disp=255, d_stream_block=32,
                                      **bad))


def test_row_mesh_rank_order_is_the_jax_meshs():
    """rank = (data * n_row + row) * n_disp + disp, the device at that
    place of ``make_mesh(n_row=2, n_data=2, n_disp=2)``; a rank's row
    neighbours have its data and disparity indices."""
    devices = make_mesh(n_row=2, n_data=2, n_disp=2).devices
    for rank in range(8):
        m = RowMesh(rank=rank, n_data=2, n_row=2, device=torch.device("cpu"), backend="gloo",
                    n_disp=2)
        assert devices[m.data_index, m.row_index, m.disp_index].id == rank
        for row in range(2):
            peer = RowMesh(rank=m.row_peer(row), n_data=2, n_row=2,
                           device=torch.device("cpu"), backend="gloo", n_disp=2)
            assert (peer.data_index, peer.row_index, peer.disp_index) == \
                (m.data_index, row, m.disp_index)


def test_check_sharded_support_disp_axis():
    cfg = get_model("fullres_occfill", **SMALL)
    check_sharded_support(cfg, n_disp=2)
    with pytest.raises(ValueError, match="'disp' axis"):
        check_sharded_support(cfg, n_disp=3)
    with pytest.raises(ValueError, match="'disp' axis"):
        run_row_bands(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), cfg, n_row=2, n_disp=3)
    for bad in (dict(d_stream_block=4), dict(vol_dtype="bfloat16")):
        with pytest.raises(NotImplementedError, match=next(iter(bad))):
            check_sharded_support(cfg.replace(**bad), n_disp=2)


@pytest.fixture(scope="module")
def disp_runs():
    """fullres_occfill (two float32 volumes) over n_row=2, n_disp=2: the JAX
    band path (jitted) and the port's through run_row_bands; the default
    preset over the same world through the harness, for its communication
    records; the dense maps of both."""
    pair = make_synthetic_pair(h=BAND_H, w=BAND_W, max_disp=BAND_MAX_DISP, seed=5)
    jcfg = jax_models.get_model("fullres_occfill", **SMALL)
    mesh = make_mesh(n_row=2, n_data=1, n_disp=2)
    fn = jax.jit(lambda l, r: jax_sharded.sharded_match_pair(l, r, jcfg, mesh, N_CHUNKS))
    ref = np.asarray(fn(jnp.asarray(pair.left[None]), jnp.asarray(pair.right[None])))[0]
    cfgs = {name: get_model(name, **SMALL) for name in ("fullres_occfill", "census_grad_cbca_sgm")}
    dense = {name: StereoPipeline(c, device="cpu")(pair.left, pair.right)["disparity"].numpy()
             for name, c in cfgs.items()}
    got = run_row_bands(pair.left, pair.right, cfgs["fullres_occfill"], n_row=2, n_disp=2,
                        n_chunks=N_CHUNKS, devices=CPU4).numpy()
    job = Job(band_pipeline, (pair.left[None], pair.right[None], cfgs["census_grad_cbca_sgm"],
                              N_CHUNKS), row_axis=1, batch_axis=0)
    [(default_map, reports)] = run_jobs([job], 2, devices=CPU4, n_disp=2)
    return dict(ref=ref, got=got, dense=dense, default_map=default_map[0], reports=reports)


def test_disp_axis_matches_jax(disp_runs):
    got = disp_runs["got"]
    assert got.dtype == np.float32 and got.shape == (BAND_H, BAND_W)
    np.testing.assert_array_equal(got, disp_runs["ref"])


@pytest.mark.parametrize("preset", ["fullres_occfill", "census_grad_cbca_sgm"])
def test_disp_axis_equals_dense(disp_runs, preset):
    got = disp_runs["got"] if preset == "fullres_occfill" else disp_runs["default_map"]
    np.testing.assert_array_equal(got, disp_runs["dense"][preset])


def test_disp_axis_comm_records(disp_runs):
    """Each rank builds D/2 disparities of its band and all-gathers them
    once over its 'disp' group (one left volume: the default preset's LR
    check needs the right one too, so two); its row neighbour is the rank
    of its own disparity index."""
    reports = disp_runs["reports"]
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    block = (BAND_MAX_DISP + 1) // 2 * (BAND_H // 2) * BAND_W * 4
    for r in reports:
        comm = r["comm"]
        assert comm["all_gathers"] == 2
        assert comm["all_gather_bytes"] == 2 * block
        assert comm["wavefront_steps"] == [N_CHUNKS + 1] * 4
        assert sum(r["launches"].values()) == 0          # the CPU runs no kernel
