"""The port's NL path against the JAX package and the reference binary, on
the CPU.

Exact: the host trees (the port's own runtime against the JAX package's:
parent, weight and BFS order) and the device-built ones against them, the
cost volumes ``ad``, ``ad_grad``, ``qx_ad_grad`` and ``qx_census`` and the
80-bit census code, the flipped
volume and the occlusion mask. Within a stated tolerance: the tree filter,
which sums in another association than the JAX filter's (level by level
against pointer doubling) and in float32 against the native float64
filter. Against the reference binary's goldens (``tests/golden/*_nl_*``),
read straight from disk with the JAX golden test's budgets: the NL flow on
an injected volume and the presets ``nl_post`` and ``nl_census_post``.
``nl_tree_filter`` and ``nl_8nr``, which have no golden, against the jitted
JAX ``match_pair`` on the same trees (two JAX jits in this file). Both
sides get the same numpy arrays, made from a seed.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import models as jax_models
from mystereomatching_tpu import native as jax_native
from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.ops import census as jax_census
from mystereomatching_tpu.ops import cost as jax_cost
from mystereomatching_tpu.ops import mst as jax_mst
from mystereomatching_tpu.ops import nl as jax_nl

from mystereomatching_tpu_torch import StereoPipeline, native
from mystereomatching_tpu_torch.data import make_adversarial_pair, make_synthetic_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import arms, census, cost, mst, nl
from mystereomatching_tpu_torch.parallel.sharded import check_sharded_support
from mystereomatching_tpu_torch.pipeline import (check_supported, kernels_launched,
                                                 match_pair, to_gray)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# the JAX golden test's scenes (tests/test_nl_golden.py:24-32)
SCENES = {"small_scale": (make_synthetic_pair, dict(h=144, w=192, max_disp=23, seed=3)),
          "adv_small": (make_adversarial_pair, dict(h=144, w=192, max_disp=23, seed=3))}
# tests/test_nl_golden.py's budgets: scene -> (injected volume, adgrad, census)
BUDGETS = {"small_scale": (8, 10, 0), "adv_small": (0, 6, 0)}
H, W, D = 64, 96, 16   # under the JAX filter's 16384-node peel threshold: its doubling form
NL_PRESETS = ("nl_tree_filter", "nl_8nr", "nl_post", "nl_census_post")
# tree filter against the JAX filter and the native float64 one: every
# output is a sum of positive terms over the tree, rounded in float32 in
# another order, so the relative error stays a few units of 2^-24 per
# level it crosses; 6.7e-7 measured against JAX, 4.8e-7 against float64
FILTER_RTOL = 4e-6
# nl_tree_filter against the jitted JAX match_pair: the filter's
# association may flip a WTA decision at a near-tie; 0 px measured
FRAME_PX = 6


def _scene(name):
    gen, kw = SCENES[name]
    return gen(name=name, **kw)


def _load_u8(path):
    with open(path, "rb") as f:
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        return np.frombuffer(f.read(h * w), np.uint8).reshape(h, w).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    p = make_synthetic_pair(h=H, w=W, max_disp=D - 1, seed=5)
    return p.left.astype(np.float32), p.right.astype(np.float32)


@pytest.fixture(scope="module")
def jax_tree(pair):
    return jax_nl.build_tree_host(pair[0])


@pytest.mark.parametrize("neighbors", [4, 8])
def test_trees_equal_the_jax_host_build(neighbors):
    """Both of the port's builders, the host one and the device one."""
    img = _scene("small_scale").left
    img8 = np.asarray(np.clip(np.round(img), 0, 255), np.uint8)
    for ours, ref in zip(native.mst_grid(native.median3x3(img8), neighbors),
                         jax_native.mst_grid(jax_native.median3x3(img8), neighbors)):
        np.testing.assert_array_equal(ours, ref)
    ref = jax_nl.build_tree_host(img, neighbors=neighbors)
    _, _, order = jax_native.mst_grid(jax_native.median3x3(img8), neighbors)
    for build in (mst.build_tree_host, mst.build_tree):
        tree = build(torch.from_numpy(img), neighbors)
        np.testing.assert_array_equal(tree.parent.numpy(), np.asarray(ref.parent))
        np.testing.assert_array_equal(tree.weight.numpy(), np.asarray(ref.weight))
        np.testing.assert_array_equal(tree.order.numpy(), order)
        assert tree.shape == img.shape[:2]


def test_tree_layout_is_level_by_level():
    """Depths are contiguous BFS ranges, every node's parent lies one level
    up, and the child table lists each non-root node once, in its
    parent's row."""
    tree = mst.build_tree(_scene("adv_small").left, neighbors=8)
    n, st = tree.n, tree.starts
    depth = np.repeat(np.arange(len(st) - 1), np.diff(st))
    ppos = tree.parent_pos.numpy()
    assert st[0] == 0 and st[1] == 1 and st[-1] == n and tree.height == len(st) - 2
    np.testing.assert_array_equal(depth[ppos[1:]], depth[1:] - 1)
    np.testing.assert_array_equal(tree.order.numpy()[ppos], tree.parent.numpy()[tree.order.numpy()])
    seen = np.zeros(n, np.int64)
    idx = tree.child_idx.numpy()
    for lvl in range(len(st) - 2):
        k, o = tree.child_k[lvl], tree.child_off[lvl]
        block = idx[o:o + (st[lvl + 1] - st[lvl]) * k].reshape(-1, k)
        for row, kids in zip(range(st[lvl], st[lvl + 1]), block):
            kids = kids[kids < n]
            assert np.all(ppos[kids] == row)
            seen[kids] += 1
    assert seen[0] == 0 and np.all(seen[1:] == 1)
    assert max(tree.child_k) <= 8


def test_tree_from_numpy_refuses_a_non_bfs_order(jax_tree):
    parent, weight = np.asarray(jax_tree.parent), np.asarray(jax_tree.weight)
    bad = np.arange(parent.shape[0])[::-1]
    with pytest.raises(ValueError, match="BFS"):
        mst.tree_from_numpy(parent, weight, bad, (H, W))


def test_tree_filter_matches_jax(pair, jax_tree):
    """On the JAX host tree carried in (the doubling form below 16384
    nodes), and against the native float64 filter."""
    vals = np.random.default_rng(0).random((H * W, 17)).astype(np.float32) * 30
    img8 = np.asarray(np.clip(np.round(pair[0]), 0, 255), np.uint8)
    parent, weight, order = jax_native.mst_grid(jax_native.median3x3(img8))
    tree = mst.tree_from_numpy(np.asarray(jax_tree.parent), np.asarray(jax_tree.weight),
                               order, (H, W))
    got = mst.tree_filter(tree, torch.from_numpy(vals), 0.1).numpy()
    ref = np.asarray(jax_mst.tree_filter(jax_tree, jnp.asarray(vals), 0.1))
    np.testing.assert_allclose(got, ref, rtol=FILTER_RTOL, atol=0)
    ref64 = jax_native.tree_filter(parent, weight, order, vals, 0.1)
    np.testing.assert_allclose(got, ref64, rtol=FILTER_RTOL, atol=0)
    # one column, the native order's layout, and sigma below the 0.01 floor
    tree_n = mst.tree_from_numpy(parent, weight, order, (H, W))
    one = mst.tree_filter(tree_n, torch.from_numpy(vals[:, 3]), 0.001).numpy()
    np.testing.assert_allclose(one, jax_native.tree_filter(parent, weight, order, vals[:, 3],
                                                           0.001), rtol=FILTER_RTOL, atol=0)


def test_tree_filter_repeats_its_bits(pair):
    tree = mst.build_tree(pair[0])
    vol = torch.from_numpy(np.random.default_rng(1).random((D, H, W)).astype(np.float32))
    a = nl.nl_aggregate(vol, tree, 0.1)
    b = nl.nl_aggregate(vol, tree, 0.1)
    assert torch.equal(a, b)
    assert torch.equal(nl.nl_aggregate(vol, mst.build_tree(torch.from_numpy(pair[0]))), a)


def _jax_arms(img):
    return jnp.asarray(arms.build_arms(torch.from_numpy(img), get_model("nl_tree_filter")).numpy())


@pytest.mark.parametrize("lor", [0, 1])
@pytest.mark.parametrize("kw", [dict(trunc=7.0), dict(trunc=1e9), dict(trunc=2.5),
                                dict(trunc=30.0)])
def test_ad_volume_exact(pair, lor, kw):
    left, right = pair
    ours = cost.ad_volume(torch.from_numpy(left), torch.from_numpy(right), D, lor, **kw)
    ref = jax_cost.ad_volume(jnp.asarray(left), jnp.asarray(right), D, lor, **kw)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name,lor", [("ad_grad", 0), ("ad_grad", 1), ("qx_ad_grad", 0),
                                      ("qx_census", 0), ("qx_census", 1)])
def test_cost_volume_exact(pair, name, lor):
    """compute_cost_volume against the JAX one, called op by op: eagerly,
    the JAX package rounds every operation as this package does."""
    left, right = pair
    cfg = get_model("nl_tree_filter", max_disp=D - 1, cost=name)
    jcfg = jax_models.get_model("nl_tree_filter", max_disp=D - 1, cost=name)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    gl, gr = to_gray(lt), to_gray(rt)
    img = (left, right)[lor]
    a = arms.build_arms(torch.from_numpy(img), cfg) if name == "ad_grad" else None
    ours = cost.compute_cost_volume(lt, rt, gl, gr, cfg, lor, arms=a)
    ref = jax_cost.compute_cost_volume(jnp.asarray(left), jnp.asarray(right),
                                       jnp.asarray(gl.numpy()), jnp.asarray(gr.numpy()), jcfg,
                                       lor, arms=None if a is None else _jax_arms(img))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_qx_pieces_exact(pair):
    """The qx gray (BGR quirk), gradient (full one-sided borders), the right
    qx_ad_grad volume (the flipped left one, as the JAX docstring says) and
    the 80-bit code, whose two int64 words hold the JAX package's three
    uint32 words' bits."""
    left, right = pair
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    gray = cost.qx_gray(lt)
    np.testing.assert_array_equal(gray.numpy(), np.asarray(jax_cost._qx_gray(jnp.asarray(left))))
    np.testing.assert_array_equal(cost.qx_gradient(gray).numpy(),
                                  np.asarray(jax_cost._qx_gradient(jnp.asarray(gray.numpy()))))
    np.testing.assert_array_equal(
        cost.qx_ad_grad_volume(lt, rt, D, lor=1).numpy(),
        np.asarray(jax_cost.qx_ad_grad_volume(jnp.asarray(left), jnp.asarray(right), D, lor=1)))
    ours = census.census_code_qx80(lt).numpy()
    ref = np.asarray(jax_census.census_code_qx80(jnp.asarray(left))).astype(np.int64)
    assert ours.shape == (2, H, W) and ref.shape == (3, H, W)
    np.testing.assert_array_equal(ours[0] & 0xFFFFFFFF, ref[0])
    np.testing.assert_array_equal((ours[0] >> 32) & 0xFFFFFFFF, ref[1])
    np.testing.assert_array_equal(ours[1], ref[2])


def test_flip_and_occlusion_exact():
    rng = np.random.default_rng(2)
    vol = rng.random((D, H, W)).astype(np.float32)
    np.testing.assert_array_equal(nl.flip_corr_vol(torch.from_numpy(vol)).numpy(),
                                  np.asarray(jax_nl.flip_corr_vol(jnp.asarray(vol))))
    dl = rng.integers(0, 5, (H, W)).astype(np.int32)
    dr = rng.integers(0, 5, (H, W)).astype(np.int32)
    ours = nl.detect_occlusion_lr(torch.from_numpy(dl), torch.from_numpy(dr)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_nl.detect_occlusion_lr(
        jnp.asarray(dl), jnp.asarray(dr))))
    assert ours.any() and not ours.all()


def _nl_golden_vol(p, num_disp):
    """tests/test_nl_golden.make_nl_vol: the injected volume the reference
    binary filtered."""
    gl, gr = p.left[:, :, 1].astype(np.float32), p.right[:, :, 1].astype(np.float32)
    w = gl.shape[1]
    return np.stack([np.minimum(np.abs(gl - np.concatenate(
        [np.repeat(gr[:, :1], d, 1), gr[:, :w - d]], 1)), 30.0) for d in range(num_disp)])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_nl_disparity_meets_the_goldens(scene):
    p = _scene(scene)
    vol = torch.from_numpy(_nl_golden_vol(p, SCENES[scene][1]["max_disp"] + 1))
    trees = tuple(mst.build_tree(img) for img in (p.left, p.right))
    d_post, d_raw = nl.nl_disparity(vol, trees)
    budget = BUDGETS[scene][0]
    assert int((d_raw.numpy() != _load_u8(f"{GOLDEN}/{scene}_nl_nopost.bin")).sum()) <= budget
    assert int((d_post.numpy() != _load_u8(f"{GOLDEN}/{scene}_nl_post.bin")).sum()) <= budget


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("preset,mode", [("nl_post", "adgrad"), ("nl_census_post", "census")])
def test_qx_presets_meet_the_goldens(scene, preset, mode):
    p = _scene(scene)
    pipe = StereoPipeline(get_model(preset, max_disp=SCENES[scene][1]["max_disp"]), device="cpu")
    out = pipe(p.left, p.right)
    assert pipe.tree_ms > 0
    budget = BUDGETS[scene][1 if mode == "adgrad" else 2]
    raw, disp = out["disp_left_raw"].numpy(), out["disparity"].numpy().astype(np.int32)
    assert int((raw != _load_u8(f"{GOLDEN}/{scene}_{mode}_nl_nopost.bin")).sum()) <= budget
    assert int((disp != _load_u8(f"{GOLDEN}/{scene}_{mode}_nl_post.bin")).sum()) <= budget
    again = pipe(p.left, p.right)
    assert all(torch.equal(out[k], again[k]) for k in out)


@pytest.mark.parametrize("preset", ["nl_tree_filter", "nl_8nr"])
def test_preset_matches_jax_match_pair(pair, preset):
    """The whole frame (ad_grad cost, NL aggregation, cooperative WTA, LR
    check, region vote, proper interpolation, median) against the jitted
    JAX match_pair on the same host trees, differing pixels counted."""
    left, right = pair
    cfg = get_model(preset, max_disp=D - 1)
    jcfg = jax_models.get_model(preset, max_disp=D - 1)
    jt = jax_nl.build_tree_host(left, neighbors=cfg.nl_neighbors)
    fn = jax.jit(lambda l, r, par, w: jax_pipeline.match_pair(l, r, jcfg, host_trees={0: (par, w)}))
    ref = fn(jnp.asarray(left), jnp.asarray(right), jt.parent, jt.weight)
    out = match_pair(torch.from_numpy(left), torch.from_numpy(right), cfg)
    for key in ("disp_left_raw", "disp_right_raw", "disparity"):
        n = int((out[key].numpy() != np.asarray(ref[key])).sum())
        assert n <= FRAME_PX, f"{key} differs from the JAX package at {n} px"


def test_nl_presets_are_supported():
    for name in NL_PRESETS:
        check_supported(get_model(name))
    assert kernels_launched(get_model("nl_tree_filter")) == [
        "arms_grow", "wta", "region_vote", "pi_scan"]
    assert kernels_launched(get_model("nl_8nr")) == kernels_launched(get_model("nl_tree_filter"))
    assert kernels_launched(get_model("nl_post")) == ["wta"]
    assert kernels_launched(get_model("nl_census_post")) == ["wta"]


@pytest.mark.parametrize("bad", [dict(d_stream_block=4), dict(d_stream_block=4, cost="census"),
                                 dict(d_stream_block=4, vol_dtype="bfloat16"),
                                 dict(aggregation="gfnl", nl_neighbors=8),
                                 dict(aggregation="gfnl", nl_neighbors=8,
                                      nl_filter_dtype="bfloat16"),
                                 dict(cost="qx_ad_grad", compute_both_volumes=True)])
def test_nl_refusals(bad):
    """What the JAX package refuses too: NL streamed over disparity blocks
    (JAX pipeline.py:160-162), GFNL on an 8-neighbour tree; and the qx
    cost's right volume. The bfloat16 filter, bfloat16 volumes and the
    census cost, once cases here, run (:func:`test_nl_accepts`)."""
    cfg = get_model("nl_tree_filter", max_disp=7).replace(**bad)
    with pytest.raises(NotImplementedError):
        check_supported(cfg)


@pytest.mark.parametrize("good", [dict(nl_filter_dtype="bfloat16"), dict(vol_dtype="bfloat16"),
                                  dict(cost="census"), dict(cost="ad_census"), dict(cost="zncc"),
                                  dict(cost="trunc_ad"), dict(cost="bt"),
                                  dict(cost="trunc_ad", vol_dtype="bfloat16",
                                       nl_filter_dtype="bfloat16")])
def test_nl_accepts(good):
    cfg = get_model("nl_tree_filter", max_disp=7).replace(**good)
    check_supported(cfg)
    p = make_synthetic_pair(h=12, w=20, max_disp=7, seed=1)
    out = match_pair(torch.from_numpy(p.left), torch.from_numpy(p.right), cfg)
    assert tuple(out["disparity"].shape) == (12, 20)


@pytest.mark.parametrize("neighbors", [4, 8])
def test_nl_refuses_a_frame_past_the_key_limit(neighbors):
    """The JAX device build keys an edge by weight << max(20, bit_length(E))
    | index in an int32 and raises past 2^22 edges (mst.py:736-739): so
    does the port's, before it builds anything."""
    # the widest grid under the limit: E = W - 1 on one row; 5 W - 4 on two rows of 8 neighbours
    h, w = (1, 1 << 22) if neighbors == 4 else (2, 838861)
    mst.check_key_limit(h, w, neighbors)
    with pytest.raises(ValueError, match="key limit"):
        mst.check_key_limit(h, w + 1, neighbors)
    big = torch.zeros((1500, 1400, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="key limit"):
        mst.build_tree(big, neighbors)
    with pytest.raises(ValueError, match="key limit"):
        StereoPipeline(get_model("nl_tree_filter", nl_neighbors=neighbors), device="cpu")(
            big, big)


@pytest.mark.parametrize("name", NL_PRESETS)
def test_row_bands_refuse_nl(name):
    with pytest.raises(NotImplementedError, match="aggregation 'nl'"):
        check_sharded_support(get_model(name))


def test_native_runtime_needs_a_compiler(monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.compiler()
    monkeypatch.setenv("CXX", "g++-from-env")
    assert native.compiler() == "g++-from-env"
