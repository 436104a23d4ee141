"""The batched NL path and NL over every cost, on the CPU.

``nl.nl_aggregate_batch`` filters B frames' volumes on the forest of their
trees (``mst.build_tree_batch``) in one filter: each frame's output equals
``nl.nl_aggregate`` on its own tree bit for bit (a forest's empty child
slots read -0.0, which every add leaves unchanged), in float32 and in the
bfloat16 mode past 16384 nodes a frame; ``match_pair_nl_batch`` equals
``match_pair`` frame by frame on every map (the JAX assertions of
tests/test_nl_batch.py:30-68, on the port alone). Against the JAX package:
``nl_aggregate_batch`` within the NL filter's tolerance of the JAX one on
two small frames (the JAX forest carried in through ``tree_from_numpy``;
one jit), and the NL aggregation of the ``census``, ``ad_census``,
``zncc``, ``trunc_ad`` and ``bt`` volumes and of bfloat16 volumes within
it of JAX ``aggregation.aggregate`` on the same host tree (the costs op by
op, no jit). Every input is made from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import models as jax_models
from mystereomatching_tpu.ops import aggregation as jax_aggregation
from mystereomatching_tpu.ops import cost as jax_cost
from mystereomatching_tpu.ops import mst as jax_mst
from mystereomatching_tpu.ops import nl as jax_nl

from mystereomatching_tpu_torch import match_pair, match_pair_nl_batch
from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import aggregation, cost, mst, nl
from mystereomatching_tpu_torch.pipeline import to_gray

# tests/test_torch_nl.py's tolerance of the tree filter against the JAX one
FILTER_RTOL = 4e-6


def _frames(b=2, h=40, w=48, seed0=5):
    """tests/test_nl_batch.py's frames."""
    pairs = [make_synthetic_pair(h=h, w=w, max_disp=11, seed=seed0 + s, noise_sigma=0.5)
             for s in range(b)]
    return (np.stack([p.left for p in pairs]).astype(np.float32),
            np.stack([p.right for p in pairs]).astype(np.float32))


@pytest.mark.parametrize("neighbors,shape,dtype", [
    (4, (40, 48), None), (8, (40, 48), None),
    (4, (136, 128), "bfloat16"),          # 17408 nodes a frame: the bfloat16 peels apply
    (4, (40, 48), "bfloat16"),            # 1920: they do not
])
def test_nl_aggregate_batch_equals_per_frame(neighbors, shape, dtype):
    lefts, _ = _frames(b=3 if shape == (40, 48) else 2, h=shape[0], w=shape[1])
    d = 12 if shape == (40, 48) else 3
    vols = torch.from_numpy(
        np.random.default_rng(0).random((lefts.shape[0], d) + shape).astype(np.float32) * 30)
    forest = mst.build_tree_batch(lefts, neighbors)
    got = nl.nl_aggregate_batch(vols, forest, 0.1, compute_dtype=dtype)
    for k in range(lefts.shape[0]):
        want = nl.nl_aggregate(vols[k], mst.build_tree(lefts[k], neighbors), 0.1,
                               compute_dtype=dtype)
        assert torch.equal(got[k], want), k


def test_nl_aggregate_batch_matches_jax():
    lefts, _ = _frames()
    b, h, w = lefts.shape[:3]
    vols = np.random.default_rng(0).random((b, 12, h, w)).astype(np.float32) * 30
    (parent, weight), want = jax.jit(lambda v, i: (jax_mst.build_tree_batch(i)[:2],
                                                   jax_nl.nl_aggregate_batch(v, i)))(
        jnp.asarray(vols), jnp.asarray(lefts))
    # the JAX forest carried in, laid out in tree_from_numpy's own BFS order
    forest = mst.tree_from_numpy(np.asarray(parent), np.asarray(weight), shape=(b * h, w))
    got = nl.nl_aggregate_batch(torch.from_numpy(vols), forest, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FILTER_RTOL, atol=0)
    # the port's own forest is the JAX one, with the same levels
    ours = mst.build_tree_batch(lefts)
    np.testing.assert_array_equal(ours.parent.numpy(), np.asarray(parent))
    np.testing.assert_array_equal(ours.weight.numpy(), np.asarray(weight))
    assert ours.starts == forest.starts and forest.roots == b
    np.testing.assert_allclose(nl.nl_aggregate_batch(torch.from_numpy(vols), ours, 0.1).numpy(),
                               got.numpy(), rtol=FILTER_RTOL, atol=0)


@pytest.mark.parametrize("overrides", [{}, dict(nl_neighbors=8), dict(vol_dtype="bfloat16"),
                                       dict(nl_filter_dtype="bfloat16"), dict(cost="census"),
                                       dict(do_refine=False)])
def test_match_pair_nl_batch_equals_match_pair(overrides):
    cfg = get_model("nl_tree_filter", max_disp=11, **overrides)
    lefts, rights = (torch.from_numpy(a) for a in _frames())
    out = match_pair_nl_batch(lefts, rights, cfg)
    assert out["disparity"].shape == (2, 40, 48)
    for k in range(lefts.shape[0]):
        one = match_pair(lefts[k], rights[k], cfg)
        assert sorted(one) == sorted(out)
        for key in one:
            assert torch.equal(out[key][k], one[key]), (k, key)


@pytest.mark.parametrize("bad", [dict(aggregation="gfnl"), dict(nl_post_process=True),
                                 dict(compute_both_volumes=True)])
def test_match_pair_nl_batch_refusals(bad):
    """What the JAX function refuses (another aggregation, the qx flow) and
    a right volume, which it does not build."""
    cfg = get_model("nl_tree_filter", max_disp=7, **bad)
    lefts, rights = (torch.from_numpy(a) for a in _frames(h=12, w=16))
    with pytest.raises(NotImplementedError):
        match_pair_nl_batch(lefts, rights, cfg)


@pytest.mark.parametrize("name,vol_dtype", [
    ("census", "float32"), ("ad_census", "float32"), ("zncc", "float32"),
    ("trunc_ad", "float32"), ("bt", "float32"), ("census", "bfloat16"), ("trunc_ad", "bfloat16"),
])
def test_nl_over_every_cost_matches_jax(name, vol_dtype):
    """The cost (each side's own, op by op), the cast to vol_dtype, then
    the NL filter on the JAX host tree, against JAX aggregation.aggregate."""
    left, right = (a[0] for a in _frames(b=1, h=32, w=40, seed0=11))
    cfg = get_model("nl_tree_filter", max_disp=11, cost=name, vol_dtype=vol_dtype)
    jcfg = jax_models.get_model("nl_tree_filter", max_disp=11, cost=name, vol_dtype=vol_dtype)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    gl, gr = to_gray(lt), to_gray(rt)
    vdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[vol_dtype]
    ours = cost.compute_cost_volume(lt, rt, gl, gr, cfg, 0).to(vdt)
    ref = jax_cost.compute_cost_volume(jnp.asarray(left), jnp.asarray(right),
                                       jnp.asarray(gl.numpy()), jnp.asarray(gr.numpy()), jcfg, 0)
    ref = ref.astype(jnp.dtype(vol_dtype))
    jt = jax_nl.build_tree_host(left)
    tree = mst.tree_from_numpy(np.asarray(jt.parent), np.asarray(jt.weight), None, (32, 40))
    got = aggregation.nl(ours, tree, cfg)
    want = jax_aggregation.aggregate(ref, jcfg, jnp.asarray(left), jnp.asarray(gl.numpy()),
                                     tree=jt)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FILTER_RTOL, atol=0)
