"""The port's row-band pipeline against the JAX package's, on the CPU.

The JAX side runs ``sharded_match_pair`` (and its pieces under
``shard_map``) on the 8-device CPU mesh of ``conftest.py``; the port runs
``parallel.launch`` with one gloo process a rank (several checks in one
world through ``parallel._harness``). The shapes are the JAX
sharding tests': a 96x64 pair, D=8, small census and arm windows, 4 bands
of 24 rows and 4 W chunks. Inputs are made with numpy from a seed. Every
comparison is exact; bfloat16 results are compared as their uint16 bits.
Each JAX function is jitted once: the four configurations share one jit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

from mystereomatching_tpu import models as jax_models
from mystereomatching_tpu.ops import pallas_kernels as jax_pk
from mystereomatching_tpu.ops import sgm as jax_sgm
from mystereomatching_tpu.parallel import halo as jax_halo
from mystereomatching_tpu.parallel import sharded as jax_sharded
from mystereomatching_tpu.parallel.mesh import make_mesh

from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import sgm
from mystereomatching_tpu_torch.parallel import check_sharded_support, run_row_bands
from mystereomatching_tpu_torch.parallel.halo import exchange_rows
from mystereomatching_tpu_torch.parallel._harness import Job, band_exchange, band_sgm, run_jobs
from mystereomatching_tpu_torch.parallel.launch import band_pipeline
from mystereomatching_tpu_torch.parallel.mesh import RowMesh

H, W, MAX_DISP, N_ROW, N_CHUNKS = 96, 64, 7, 4, 4
SMALL = dict(max_disp=MAX_DISP, census_rv=2, census_ru=3, cbca_cross_l=3,
             cbca_cross_l_out=5, pi_search_depth=4, rv_s_thres=4)
CONFIGS = {
    "census_grad_cbca_sgm": ("census_grad_cbca_sgm", {}),
    "fullres_occfill": ("fullres_occfill", {}),
    "fullres_occfill_cooperative": ("fullres_occfill", dict(compute_both_volumes=False)),
    "sgm8_full": ("sgm8_full", {}),
}
PAD_MODES = ["edge", "reflect101", "zero", -1]
CPU = ["cpu"] * N_ROW


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


def _cfgs(name):
    preset, kw = CONFIGS[name]
    return jax_models.get_model(preset, **SMALL, **kw), get_model(preset, **SMALL, **kw)


@pytest.fixture(scope="module")
def pairs():
    return [make_synthetic_pair(h=H, w=W, max_disp=MAX_DISP, seed=s) for s in (5, 6)]


@pytest.fixture(scope="module")
def sgm_inputs():
    rng = np.random.default_rng(11)
    vol = (rng.random((MAX_DISP + 1, H, W)) * 3).astype(np.float32)
    image = rng.integers(0, 40, (H, W, 3)).astype(np.float32)
    return vol, image


@pytest.fixture(scope="module")
def jax_refs(pairs, sgm_inputs):
    """The JAX band path on the 4-band mesh: every configuration on both
    pairs (one jit), _sgm_sharded with 4 and 8 paths, exchange_rows in each
    pad mode."""
    mesh = make_mesh(n_row=N_ROW, n_data=1)
    cfgs = [_cfgs(name)[0] for name in CONFIGS]
    fn = jax.jit(lambda l, r: [jax_sharded.sharded_match_pair(l, r, c, mesh, N_CHUNKS)
                               for c in cfgs])
    maps = [np.stack([np.asarray(m[0]) for m in fn(jnp.asarray(p.left[None]),
                                                  jnp.asarray(p.right[None]))])
            for p in pairs]
    refs = {name: maps[0][i] for i, name in enumerate(CONFIGS)}
    refs["pair_b"] = maps[1][0]                  # census_grad_cbca_sgm on the second pair
    vol, image = sgm_inputs
    for n_dirs in (4, 8):
        body = functools.partial(jax_sharded._sgm_sharded,
                                 cfg=jax_models.get_model("census_grad_cbca_sgm",
                                                          **SMALL, sgm_scan_num=n_dirs),
                                 n_chunks=N_CHUNKS)
        run = shard_map(body, mesh=mesh, in_specs=(P(None, "row", None), P("row", None, None)),
                        out_specs=P(None, "row", None))
        refs[f"sgm{n_dirs}"] = np.asarray(jax.jit(run)(jnp.asarray(vol), jnp.asarray(image)))
    for mode in PAD_MODES:
        run = shard_map(functools.partial(jax_halo.exchange_rows, halo=3, pad_mode=mode),
                        mesh=mesh, in_specs=P("row"), out_specs=P("row"))
        refs[f"halo_{mode}"] = np.asarray(jax.jit(run)(jnp.asarray(image)))
    return refs


@pytest.fixture(scope="module")
def port_runs(pairs, sgm_inputs):
    """The same through the port, in one world of 4 gloo ranks."""
    left, right = pairs[0].left[None], pairs[0].right[None]
    vol, image = sgm_inputs
    jobs = {name: Job(band_pipeline, (left, right, _cfgs(name)[1], N_CHUNKS), row_axis=1,
                      batch_axis=0) for name in CONFIGS}
    for n_dirs in (4, 8):
        cfg = get_model("census_grad_cbca_sgm", **SMALL, sgm_scan_num=n_dirs)
        jobs[f"sgm{n_dirs}"] = Job(band_sgm, (vol, image, cfg, N_CHUNKS), row_axis=1)
    for mode in PAD_MODES:
        jobs[f"halo_{mode}"] = Job(band_exchange, (image, 3, 0, mode), row_axis=0)
    out = run_jobs(list(jobs.values()), N_ROW, devices=CPU)
    return {name: res for name, (res, _) in zip(jobs, out)}, {
        name: reports for name, (_, reports) in zip(jobs, out)}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_run_row_bands_matches_jax(jax_refs, port_runs, config):
    got = port_runs[0][config][0]
    want = jax_refs[config]
    assert got.dtype == np.float32 and got.shape == (H, W)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_dirs", [4, 8])
def test_sgm_sharded_matches_jax(jax_refs, port_runs, n_dirs):
    np.testing.assert_array_equal(port_runs[0][f"sgm{n_dirs}"], jax_refs[f"sgm{n_dirs}"])


@pytest.mark.parametrize("pad_mode", PAD_MODES)
def test_exchange_rows_matches_jax(jax_refs, port_runs, pad_mode):
    got = port_runs[0][f"halo_{pad_mode}"]
    assert got.shape == (N_ROW * (H // N_ROW + 6), W, 3)
    np.testing.assert_array_equal(got, jax_refs[f"halo_{pad_mode}"])


def test_comm_records(port_runs):
    """Each rank records its halo bytes and its wavefronts: 4 vertical
    scans (two per volume) of 4 chunks over 4 bands, 7 chunk steps each.
    A band sends a boundary row a chunk in each scan that does not end at
    it: the downward ones unless it is the last band, the upward ones
    unless it is the first."""
    reports = port_runs[1]["census_grad_cbca_sgm"]
    for rank, r in enumerate(reports):
        comm = r["comm"]
        assert comm["wavefront_steps"] == [N_CHUNKS + N_ROW - 1] * 4
        assert comm["halo_exchanges"] > 0 and comm["halo_bytes"] > 0
        sending = 2 * ((rank < N_ROW - 1) + (rank > 0))
        assert comm["wavefront_bytes"] == \
            sending * N_CHUNKS * (MAX_DISP + 1) * (W // N_CHUNKS) * 4
        assert sum(r["launches"].values()) == 0          # the CPU runs no kernel


def test_row_bands_data_and_row_axes(jax_refs, pairs):
    """n_data=2 x n_row=2: two different pairs, one a data rank, through
    the entry point; each equals the JAX band path's map of its pair."""
    left = np.stack([p.left for p in pairs])
    right = np.stack([p.right for p in pairs])
    got = run_row_bands(left, right, _cfgs("census_grad_cbca_sgm")[1], n_row=2, n_data=2,
                        n_chunks=N_CHUNKS, devices=CPU)
    assert got.shape == (2, H, W)
    np.testing.assert_array_equal(got[0].numpy(), jax_refs["census_grad_cbca_sgm"])
    np.testing.assert_array_equal(got[1].numpy(), jax_refs["pair_b"])


def _ps_sel(rng, shape):
    return rng.random(shape) < 0.4          # where the penalty scale is 1/4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inputs", ["init", "mask", "init_mask"])
def test_sgm_scan_init_mask_matches_scan_down(dtype, inputs):
    """The plain scan with a carried-in row and/or an in-image mask against
    JAX ``sgm._scan_down(in_image=, init=)``, with its weakly typed penalty
    scale (so bfloat16 rounds after every operation, as the port does)."""
    rng = np.random.default_rng(len(inputs) + 3 * (dtype == "bfloat16"))
    d_, h, w = 6, 17, 23
    vol = (rng.random((d_, h, w)) * 3).astype(np.float32)
    init = (rng.random((d_, w)) * 4).astype(np.float32) if "init" in inputs else None
    mask = rng.random((h, w)) < 0.7 if "mask" in inputs else None
    sel = _ps_sel(rng, (h, w))
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    want = jax_sgm._scan_down(
        jnp.asarray(vol).astype(jdt), jnp.where(jnp.asarray(sel), 0.25, 1.0), 1.0, 3.0,
        in_image=jnp.asarray(mask) if mask is not None else None,
        init=jnp.asarray(init).astype(jdt) if init is not None else None)
    got = sgm.sgm_scan_plain(
        torch.from_numpy(vol).to(tdt)[None], torch.from_numpy(np.where(sel, 0.25, 1.0)
                                                              .astype(np.float32))[None],
        1.0, 3.0, axis=2, reverse=False,
        init=torch.from_numpy(init).to(tdt)[None] if init is not None else None,
        mask=torch.from_numpy(mask).to(tdt)[None] if mask is not None else None)[0]
    assert got.dtype == tdt
    np.testing.assert_array_equal(_torch_bits(got), _bits(np.asarray(want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_sgm_scan_init_mask_matches_pallas(dtype, reverse):
    """Against the TPU kernel ``sgm_scan_pallas(..., mask=, init=)`` in
    interpret mode. That kernel rounds bfloat16 once on store, the port
    after every operation (ROADMAP section 3), so in bfloat16 the costs are
    small integers and quarters, on which every operation is exact in both."""
    rng = np.random.default_rng(7 + reverse)
    g, d_, h, w = 2, 5, 16, 19
    if dtype == "float32":
        vol = (rng.random((g, d_, h, w)) * 3).astype(np.float32)
        init = (rng.random((g, d_, w)) * 4).astype(np.float32)
    else:
        vol = rng.integers(0, 9, (g, d_, h, w)).astype(np.float32)
        init = rng.integers(0, 6, (g, d_, w)).astype(np.float32)
    mask = (rng.random((g, h, w)) < 0.7).astype(np.float32)
    ps = np.where(_ps_sel(rng, (g, h, w)), 0.25, 1.0).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    want = jax_pk.sgm_scan_pallas(jnp.asarray(vol).astype(jdt), jnp.asarray(ps),
                                  jnp.asarray(mask).astype(jdt), 1.0, 3.0,
                                  init=jnp.asarray(init).astype(jdt), reverse=reverse,
                                  interpret=True)
    got = sgm.sgm_scan_plain(torch.from_numpy(vol).to(tdt), torch.from_numpy(ps), 1.0, 3.0,
                             axis=2, reverse=reverse, init=torch.from_numpy(init).to(tdt),
                             mask=torch.from_numpy(mask).to(tdt))
    np.testing.assert_array_equal(_torch_bits(got), _bits(np.asarray(want)))


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("shape", [(5, 7, 11), (9, 4)])
def test_skew_unskew_match_jax(sign, shape):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    want, want_ok = jax_sgm._skew(jnp.asarray(x), sign, 1.5)
    got, got_ok = sgm._skew(torch.from_numpy(x), sign, 1.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    back = sgm._unskew(got, sign, shape[-1])
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jax_sgm._unskew(want, sign, shape[-1])))
    np.testing.assert_array_equal(back.numpy(), x)


REFUSED = [
    dict(vol_dtype="bfloat16"),
    dict(vol_dtype="bfloat16", compute_both_volumes=False),
    dict(d_stream_block=4),
    dict(cbca_double_win=True),
    dict(aggregation="bf"),
    dict(aggregation="gf"),
    dict(aggregation="jbf"),
    dict(aggregation="aws"),
    dict(aggregation="fif"),
    dict(aggregation="nl"),
    dict(pyramid_levels=2),
    dict(pyramid_levels=3),
    dict(cbca_arm_mode="multilevel"),
    dict(cbca_arm_mode="adaptive"),
    dict(cost="census_from2"),
    dict(cost="ad_census_grad"),
    dict(optimization="so"),
    dict(do_vmtop=True),
    dict(do_pkr=True),
    dict(rv_use_combine_bg=True),
    dict(bg_ipol_kitti=True),
    dict(do_wm=True),
    dict(do_da=True),
    dict(do_fill_surrounding=True),
    dict(do_rv_whole_image=True),
    dict(cost="zncc", aggregation="bf"),
    dict(cbca_double_win=True, cbca_combine=2),
    dict(do_vmtop=True, vmtop_method=1),
]


@pytest.mark.parametrize("flags", REFUSED, ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()))
def test_check_sharded_support_refuses(flags):
    cfg = get_model("fullres_occfill", **SMALL).replace(**flags)
    with pytest.raises(NotImplementedError) as err:
        check_sharded_support(cfg)
    assert any(k in str(err.value) for k in flags), str(err.value)


def test_check_sharded_support_accepts_the_three_presets():
    for name in CONFIGS:
        check_sharded_support(_cfgs(name)[1])


def test_exchange_rows_refuses_a_band_shorter_than_its_halo():
    mesh = RowMesh(rank=1, n_data=1, n_row=4, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="cannot give a halo"):
        exchange_rows(torch.zeros(5, 3), 6, mesh)
    with pytest.raises(ValueError, match="reflect101"):
        exchange_rows(torch.zeros(5, 3), 5, mesh, pad_mode="reflect101")


def test_run_row_bands_raises_where_the_halo_exceeds_the_band(pairs):
    """Arms of 8 need a cost halo of 27 rows: 24-row bands cannot give it.
    Every rank raises, and so does the launcher."""
    cfg = get_model("census_grad_cbca_sgm", **dict(SMALL, cbca_cross_l_out=8))
    with pytest.raises(Exception, match="cannot give a halo"):
        run_row_bands(pairs[0].left, pairs[0].right, cfg, n_row=N_ROW, n_chunks=N_CHUNKS,
                      devices=CPU)


def test_run_row_bands_needs_a_card_a_rank_by_default(pairs):
    cfg = _cfgs("census_grad_cbca_sgm")[1]
    with pytest.raises(RuntimeError, match="CUDA devices"):
        run_row_bands(pairs[0].left, pairs[0].right, cfg, n_row=64)
