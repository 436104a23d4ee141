"""The rooted grid MST and the two-pass tree filter of the NL path.

Counterpart of ``mystereomatching_tpu/ops/mst.py`` (``RootedTree``,
``build_tree``, ``tree_filter``) in the host-build form the JAX package
takes with ``nl_tree_host`` (``ops/nl.build_tree_host``): the tree is built
on the host by the native runtime (``mystereomatching_tpu_torch/native``:
3x3 median prefilter, counting-sort Kruskal, BFS from node 0, the
reference's tie order), then laid out level by level and moved to the
device once; the filter runs on the device. The JAX package's device
Borůvka, its Euler-tour rooting and its peeled filter are not ported.

The filter (qx_tree_filter.cpp:61-117) is level-synchronous over the BFS
depth. Rows are kept in BFS order, where every depth is a contiguous range
of rows and every node's children are consecutive. The up pass walks the
levels from the deepest up: each parent gathers its at most 4 (8 with the
8-neighbour tree) children through a child table and adds
``sim_c * S^(c)`` to its row in the table's fixed slot order. The down pass
walks down: ``S(c) = (1 - sim_c^2) S^(c) + sim_c S(parent(c))``, one
gather of the parents' rows a level. There are no atomics, so two runs
give the same bits, and a CUDA tensor gives the CPU's bits: every step is
a gather or one IEEE multiply or add, and ``sim`` comes from a 256-entry
table built once on the CPU (the card's ``exp`` rounds otherwise).

The JAX filter associates the sums otherwise (pointer doubling, peeled
above 16384 nodes), so the two agree within a tolerance, not in bits. No
TPU kernel does this work; the filter is plain torch on every device, a
few launches a level.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from mystereomatching_tpu_torch import native


@dataclass(frozen=True)
class RootedTree:
    """A rooted spanning tree over the H*W grid nodes (root node 0) and its
    level layout. Node ids are row-major pixel indices; positions index
    the BFS order."""

    parent: torch.Tensor       # [N] int64 node ids; the root is its own parent
    weight: torch.Tensor       # [N] int32 edge weight to the parent, 0..255
    order: torch.Tensor        # [N] int64 node at each BFS position
    pos: torch.Tensor          # [N] int64 BFS position of each node
    parent_pos: torch.Tensor   # [N] int64 BFS position of each position's parent
    weight_bfs: torch.Tensor   # [N] int64 weight of each position's edge to its parent
    child_idx: torch.Tensor    # int64: per level, [n, k] positions of the children, N if none
    starts: Tuple[int, ...]    # first position of each depth, then N
    child_off: Tuple[int, ...]  # start of each level's block of child_idx
    child_k: Tuple[int, ...]   # children slots of a node of each level (the level's most)
    shape: Tuple[int, int]

    @property
    def n(self) -> int:
        return int(self.parent.shape[0])

    @property
    def height(self) -> int:
        """The deepest node's depth."""
        return len(self.starts) - 2


def tree_from_numpy(parent: np.ndarray, weight: np.ndarray, order: np.ndarray,
                    shape: Optional[Tuple[int, int]] = None, device="cpu") -> RootedTree:
    """A :class:`RootedTree` on ``device`` from numpy [N] arrays: the JAX
    package's tree (``RootedTree.parent`` and ``.weight``) or the native
    runtime's, with ``order``, a BFS order from the root, node 0 (the
    native runtime's third output). ``shape``: (H, W), default (1, N)."""
    parent = np.asarray(parent, np.int64)
    weight = np.asarray(weight, np.int64)
    n = parent.shape[0]
    if parent[0] != 0:
        raise ValueError("tree_from_numpy: node 0 must be the root (its own parent)")
    order = np.asarray(order, np.int64)
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    ppos = pos[parent[order]]
    if order[0] != 0 or n != len(np.unique(order)) or (n > 1 and (
            np.any(ppos[1:] >= np.arange(1, n)) or np.any(np.diff(ppos[1:]) < 0))):
        raise ValueError("tree_from_numpy: order is not a BFS order of the tree from node 0")
    # depths: the children of the positions [lo, hi) are the next positions
    # whose parents lie below hi (parent positions never decrease)
    starts = [0, 1]
    while starts[-1] < n:
        hi = starts[-1]
        starts.append(hi + int(np.searchsorted(ppos[hi:], hi)))
    starts_a = np.asarray(starts, np.int64)
    nchild = np.bincount(ppos[1:], minlength=n).astype(np.int64)
    first = 1 + np.cumsum(nchild) - nchild
    kmax = np.maximum.reduceat(nchild, starts_a[:-1])             # a level's most children
    level = np.repeat(np.arange(len(kmax)), np.diff(starts_a))    # level of each position
    kpos = kmax[level]
    slot0 = np.cumsum(kpos) - kpos
    owner = np.repeat(np.arange(n), kpos)
    j = np.arange(int(kpos.sum())) - slot0[owner]
    child_idx = np.where(j < nchild[owner], first[owner] + j, n)
    child_off = np.append(slot0, kpos.sum())[starts_a[:-1]]
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return RootedTree(
        parent=as_t(parent), weight=as_t(weight.astype(np.int32)), order=as_t(order),
        pos=as_t(pos), parent_pos=as_t(ppos), weight_bfs=as_t(weight[order]),
        child_idx=as_t(child_idx), starts=tuple(int(s) for s in starts),
        child_off=tuple(int(o) for o in child_off), child_k=tuple(int(k) for k in kmax),
        shape=tuple(shape) if shape is not None else (1, n))


def build_tree(image, neighbors: int = 4, device=None) -> RootedTree:
    """The rooted MST of an [H, W, 3] image (tensor or numpy) over its 4- or
    8-neighbour grid, built on the host from the image clipped, rounded to
    uint8 and 3x3-median filtered (JAX ``nl.build_tree_host``); on
    ``device`` (default the image's device, the CPU for numpy)."""
    if isinstance(image, torch.Tensor):
        device = image.device if device is None else device
        image = image.detach().cpu().numpy()
    img8 = np.asarray(np.clip(np.round(np.asarray(image)), 0, 255), np.uint8)
    parent, weight, order = native.mst_grid(native.median3x3(img8), neighbors)
    return tree_from_numpy(parent, weight, order, img8.shape[:2], device or "cpu")


def sim_tables(sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sim, 1 - sim^2) over the 256 edge weights, float32 on the CPU:
    sim = exp(-w / (255 max(sigma, 0.01))) (update_table, qx_tree_filter.cpp:21-25)."""
    w = torch.arange(256, dtype=torch.float32)
    sim = torch.exp(-w / (255.0 * max(sigma, 0.01)))
    return sim, 1.0 - sim * sim


def to_rows(tree: RootedTree, cols: torch.Tensor) -> torch.Tensor:
    """[C, N] node-order columns -> the filter's [N + 1, C] float32 rows in
    BFS order, the last row zero (the empty child slot)."""
    c = cols.shape[0]
    rows = torch.empty((tree.n + 1, c), dtype=torch.float32, device=cols.device)
    torch.index_select(cols.to(torch.float32).t(), 0, tree.order, out=rows[:tree.n])
    rows[tree.n].zero_()
    return rows


def from_rows(tree: RootedTree, rows: torch.Tensor) -> torch.Tensor:
    """[N, C] rows in BFS order -> [C, N] node-order columns."""
    return rows[:tree.n].t().index_select(1, tree.pos)


def filter_rows(tree: RootedTree, rows: torch.Tensor, sigma: float) -> torch.Tensor:
    """The two-pass filter of ``rows`` (:func:`to_rows`; its first N rows
    are overwritten by the up pass). Returns the filtered [N, C] rows in
    BFS order."""
    sim_t, keep_t = (t.to(rows.device) for t in sim_tables(sigma))
    sim = sim_t[tree.weight_bfs]
    sim[0] = 0.0                                     # the root climbs nowhere
    keep = keep_t[tree.weight_bfs]
    keep[0] = 1.0
    slot_sim = torch.cat([sim, sim.new_zeros(1)])[tree.child_idx]
    st, n = tree.starts, tree.n
    # up pass: S^(p) = C(p) + sum over p's children c of sim_c S^(c)
    for lvl in range(len(st) - 3, -1, -1):
        k = tree.child_k[lvl]
        lo, hi = st[lvl], st[lvl + 1]
        o = tree.child_off[lvl]
        g = rows.index_select(0, tree.child_idx[o:o + (hi - lo) * k])
        g.mul_(slot_sim[o:o + (hi - lo) * k, None])
        g = g.view(hi - lo, k, -1)
        for j in range(k):
            rows[lo:hi].add_(g[:, j])
    # down pass: S(c) = (1 - sim_c^2) S^(c) + sim_c S(parent(c)); S(root) = S^(root)
    out = rows[:n] * keep[:, None]
    for lvl in range(1, len(st) - 1):
        lo, hi = st[lvl], st[lvl + 1]
        p = out.index_select(0, tree.parent_pos[lo:hi])
        p.mul_(sim[lo:hi, None])
        out[lo:hi].add_(p)
    return out


def tree_filter(tree: RootedTree, values: torch.Tensor, sigma: float = 0.1) -> torch.Tensor:
    """Two-pass MST filter of [N, C] (or [N]) node-order values, float32:
    up pass ``S^(p) = C(p) + sum_c sim_c S^(c)``, down pass
    ``S(c) = sim_c S(p) + (1 - sim_c^2) S^(c)``, unnormalised."""
    squeeze = values.ndim == 1
    cols = values[None] if squeeze else values.t()
    out = from_rows(tree, filter_rows(tree, to_rows(tree, cols), sigma)).t()
    return out[:, 0] if squeeze else out
