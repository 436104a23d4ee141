"""The port's device tree build against its host build and the JAX
package's device build, on the CPU; the bfloat16 filter against the JAX
package's; the histogram median.

Exact: ``mst.build_tree`` (Borůvka and two Euler tours in torch) against
``mst.build_tree_host`` (the native runtime's Kruskal and BFS) in every
field of the tree and its level layout, on images with heavy ties, a
constant image (every weight a tie), the synthetic and adversarial scenes
and the degenerate grids; parent and weight against the jitted JAX
``mst.build_tree`` on ``tests/test_mst.py:150``'s 23x31 image (its plain
Borůvka; median-prefiltered here, as every build of the port is) and on a
64x72 image, which takes its contracted Borůvka (with 8
neighbours, tests/test_mst.py:261 holds the JAX device build equal to the
JAX host build, and tests/test_torch_nl.py the port's device build equal
to that); the forest of ``mst.build_tree_batch`` against each frame's
build; and the histogram median against the JAX one. The bfloat16 filter at 16384 nodes
or fewer is the float32 filter bit for bit; above that it rounds in
another order than the JAX filter (``mst.filter_rows``), so it is held
within BF16_RTOL of it, and a frame's disparities within JAX's own 2%
flip bound (tests/test_mst.py:214-233) of the float32 frame's. Every input
is made from a seed with numpy. Three small JAX jits; no whole-pipeline jit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu.ops import median as jax_median
from mystereomatching_tpu.ops import mst as jax_mst

from mystereomatching_tpu_torch import StereoPipeline, native
from mystereomatching_tpu_torch.data import make_adversarial_pair, make_synthetic_pair
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import median, mst

TREE_FIELDS = ("parent", "weight", "order", "pos", "parent_pos", "weight_bfs", "child_idx")
LAYOUT = ("starts", "child_off", "child_k", "shape")
# port's bfloat16 filter against JAX's on one tree: both round each peeled
# term and add to bfloat16 (2^-9 relative), in other orders, over up to
# PEELS levels each way; 2.5e-2 largest and 8.5e-4 mean measured at 136x128
BF16_RTOL = 4e-2
BF16_MEAN_RTOL = 2e-3
FLIP_SHARE = 0.02   # tests/test_mst.py:233


def _images():
    rng = np.random.default_rng(7)
    syn = make_synthetic_pair(h=64, w=96, max_disp=15, seed=2)
    adv = make_adversarial_pair(h=64, w=96, max_disp=15, seed=3)
    return {
        "ties": rng.integers(0, 4, (37, 45, 3)).astype(np.float32),
        "constant": np.full((30, 40, 3), 7.0, np.float32),
        "synthetic": syn.left.astype(np.float32),
        "adversarial": adv.left.astype(np.float32),
        "row": rng.integers(0, 4, (1, 57, 3)).astype(np.float32),
        "column": rng.integers(0, 4, (57, 1, 3)).astype(np.float32),
        "2x2": rng.integers(0, 4, (2, 2, 3)).astype(np.float32),
        "1x1": rng.integers(0, 4, (1, 1, 3)).astype(np.float32),
    }


IMAGES = _images()


def assert_same_tree(got: mst.RootedTree, want: mst.RootedTree):
    for field in TREE_FIELDS:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    for field in LAYOUT:
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("neighbors", [4, 8])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_device_tree_equals_host_tree(name, neighbors):
    img = IMAGES[name]
    assert_same_tree(mst.build_tree(torch.from_numpy(img), neighbors),
                     mst.build_tree_host(img, neighbors))


def _jax_tree(img):
    fn = jax.jit(lambda i: jax_mst.build_tree(i)[:2])
    return tuple(np.asarray(a) for a in fn(jnp.asarray(img)))


@pytest.mark.parametrize("shape", [
    (23, 31),    # tests/test_mst.py:150, the plain Borůvka
    (64, 72),    # 4608 nodes: boruvka_mst_contracted
])
def test_device_tree_equals_jax_build_tree(shape):
    img = np.random.default_rng(0).integers(0, 255, shape + (3,)).astype(np.float32)
    tree = mst.build_tree(torch.from_numpy(img))
    parent, weight = _jax_tree(img)
    np.testing.assert_array_equal(tree.parent.numpy(), parent)
    np.testing.assert_array_equal(tree.weight.numpy(), weight)


@pytest.mark.parametrize("neighbors", [4, 8])
def test_forest_equals_per_frame_builds(neighbors):
    """Frames of other heights of tree and other most children a level:
    each frame's parents (rebased), weights and BFS order within each
    depth equal its own build's."""
    imgs = np.stack([IMAGES["synthetic"][:40, :48], IMAGES["adversarial"][:40, :48],
                     np.random.default_rng(9).integers(0, 4, (40, 48, 3)).astype(np.float32)])
    forest = mst.build_tree_batch(torch.from_numpy(imgs), neighbors)
    n = 40 * 48
    assert forest.roots == 3 and forest.shape == (120, 48)
    depth = np.repeat(np.arange(len(forest.starts) - 1), np.diff(forest.starts))
    for k in range(3):
        one = mst.build_tree(imgs[k], neighbors)
        sl = slice(k * n, (k + 1) * n)
        assert torch.equal(forest.parent[sl] - k * n, one.parent)
        assert torch.equal(forest.weight[sl], one.weight)
        mine = (forest.order.numpy() // n) == k
        np.testing.assert_array_equal(forest.order.numpy()[mine] - k * n, one.order.numpy())
        np.testing.assert_array_equal(np.bincount(depth[mine]), np.diff(one.starts))


def test_device_build_never_calls_the_native_runtime(monkeypatch):
    """nl_tree_host=False builds on the tensors' device and raises rather
    than fall back; nl_tree_host=True builds on the host and never on the
    device."""
    p = make_synthetic_pair(h=24, w=32, max_disp=7, seed=1)

    def refuse(*_):
        raise AssertionError("the other builder was called")

    cfg = get_model("nl_tree_filter", max_disp=7)
    host_cfg = cfg.replace(nl_tree_host=True)
    want = StereoPipeline(host_cfg, device="cpu")(p.left, p.right)
    with monkeypatch.context() as m:
        m.setattr(native, "mst_grid", refuse)
        m.setattr(native, "median3x3", refuse)
        got = StereoPipeline(cfg, device="cpu")(p.left, p.right)
        with pytest.raises(AssertionError, match="other builder"):
            StereoPipeline(host_cfg, device="cpu")(p.left, p.right)
    assert all(torch.equal(got[k], want[k]) for k in want)
    monkeypatch.setattr(mst, "build_tree_batch", refuse)
    again = StereoPipeline(host_cfg, device="cpu")(p.left, p.right)
    assert all(torch.equal(again[k], want[k]) for k in want)
    with pytest.raises(AssertionError, match="other builder"):
        StereoPipeline(cfg, device="cpu")(p.left, p.right)


@pytest.mark.parametrize("shape", [(64, 96), (128, 128)])
def test_bf16_filter_is_float32_at_16384_nodes_or_fewer(shape):
    img = make_synthetic_pair(h=shape[0], w=shape[1], max_disp=7, seed=4).left
    tree = mst.build_tree(img)
    vals = torch.from_numpy(np.random.default_rng(5).random((tree.n, 4)).astype(np.float32) * 30)
    assert torch.equal(mst.tree_filter(tree, vals, compute_dtype="bfloat16"),
                       mst.tree_filter(tree, vals))


@pytest.fixture(scope="module")
def big_pair():
    """136 x 128 = 17408 nodes, past the JAX filter's peel threshold."""
    return make_synthetic_pair(h=136, w=128, max_disp=15, seed=1)


def test_bf16_filter_within_rounding_of_jax(big_pair):
    tree = mst.build_tree(big_pair.left)
    vals = np.random.default_rng(0).random((tree.n, 5)).astype(np.float32) * 30
    fn = jax.jit(lambda p, w, v: jax_mst.tree_filter(jax_mst.RootedTree(p, w, tree.shape), v, 0.1,
                                                     compute_dtype=jnp.bfloat16))
    ref = np.asarray(fn(jnp.asarray(tree.parent.numpy(), jnp.int32),
                        jnp.asarray(tree.weight.numpy()), jnp.asarray(vals)))
    got = mst.tree_filter(tree, torch.from_numpy(vals), 0.1, compute_dtype="bfloat16").numpy()
    rel = np.abs(got - ref) / np.abs(ref)
    assert rel.max() <= BF16_RTOL and rel.mean() <= BF16_MEAN_RTOL, (rel.max(), rel.mean())
    # every output is a bfloat16 value, as the JAX mode's is
    assert np.array_equal(got, torch.from_numpy(got).to(torch.bfloat16).float().numpy())


def test_bf16_filter_flips_few_disparities(big_pair):
    cfg = get_model("nl_tree_filter", max_disp=15)
    f32 = StereoPipeline(cfg, device="cpu")(big_pair.left, big_pair.right)["disparity"]
    b16 = StereoPipeline(cfg.replace(nl_filter_dtype="bfloat16"), device="cpu")(
        big_pair.left, big_pair.right)["disparity"]
    assert bool(torch.isfinite(b16).all())
    share = float((f32 != b16).float().mean())
    assert 0 < share < FLIP_SHARE, share


@pytest.mark.parametrize("radius", [3, 4, 7])
def test_median_histogram_equals_jax(radius):
    img = np.random.default_rng(radius).integers(0, 256, (37, 45)).astype(np.uint8)
    img[5:20, 10:30] = 17                          # a flat patch: ties in every window
    want = np.asarray(jax_median.median_histogram(jnp.asarray(img), radius))
    got = median.median_histogram(torch.from_numpy(img), radius)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    k = 2 * radius + 1
    np.testing.assert_array_equal(median.median_filter(torch.from_numpy(img), k).numpy(),
                                  np.asarray(jax_median.median_filter(jnp.asarray(img), k)))
