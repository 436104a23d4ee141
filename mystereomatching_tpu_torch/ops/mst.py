"""The rooted grid MST and the two-pass tree filter of the NL path.

Counterpart of ``mystereomatching_tpu/ops/mst.py`` (``RootedTree``,
``build_tree``, ``build_tree_batch``, ``tree_filter``) and of the host
build ``ops/nl.build_tree_host``. Two builders give the same tree:

* :func:`build_tree` (the JAX package's default, ``nl_tree_host=False``)
  builds on the image's device in plain torch: the edge weights of the
  3x3-median-prefiltered image, one Borůvka over the grid's edge list keyed
  by (weight, edge index), then two Euler tours ranked by pointer doubling,
  the first to orient the tree toward node 0, the second to lay it out in
  the native runtime's BFS order. :func:`build_tree_batch` builds B frames
  as one forest, each rooted at its own node 0.
* :func:`build_tree_host` (``nl_tree_host=True``) builds on the host with
  the native runtime (``mystereomatching_tpu_torch/native``: counting-sort
  Kruskal, BFS from node 0, the reference's tie order) and moves the tree
  to the device once.

Under the key (weight, edge index), which is the order of Kruskal's stable
counting sort, the MST is unique, so Borůvka picks Kruskal's edges. The
native BFS lists a node's children newest first, that is by descending
key, so its order is the sort by (depth, preorder of a walk that takes each
node's children by descending key): the second tour's cyclic order at a
node is its parent edge, then its children by descending key; a node's
preorder is the rank of its entering edge and its depth the prefix sum of
+1 (down) and -1 (up) along the tour. The JAX package's contraction, plane
and peeling phases are speed devices of the TPU that give the same edges
and parents; they are not copied.

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
table built once on the CPU (the card's ``exp`` rounds otherwise). A
forest's roots (every depth-0 position) climb nowhere; an empty child slot
reads a -0.0 row, which every add leaves unchanged, so each tree of a
forest gets the bits it gets alone.

The JAX filter associates the sums otherwise (pointer doubling, peeled
above 16384 nodes), so the two agree within a tolerance, not in bits. Its
bfloat16 mode (``compute_dtype``) rounds as :func:`filter_rows` says. No
TPU kernel does this work; the build and the filter are plain torch on
every device, a few launches a level.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mystereomatching_tpu_torch import native
from mystereomatching_tpu_torch.ops.median import median_small

# the JAX filter's peel rounds (tree_filter's ``peels``, mst.py:1150) and its
# _COND_MIN_N (mst.py:384): at or below that many nodes it filters in the
# doubling form, in float32 whatever its compute dtype
PEELS = 20
PEEL_MIN_N = 1 << 14


@dataclass(frozen=True)
class RootedTree:
    """A rooted spanning tree (or forest) over grid nodes and its level
    layout. Node ids are row-major pixel indices (frame-major in a forest,
    each frame's root its node 0); positions index the BFS order, whose
    depth-0 positions are the roots."""

    parent: torch.Tensor       # [N] int64 node ids; a root is its own parent
    weight: torch.Tensor       # [N] int32 edge weight to the parent, 0..255
    order: torch.Tensor        # [N] int64 node at each BFS position
    pos: torch.Tensor          # [N] int64 BFS position of each node
    parent_pos: torch.Tensor   # [N] int64 BFS position of each position's parent
    weight_bfs: torch.Tensor   # [N] int64 weight of each position's edge to its parent
    child_idx: torch.Tensor    # int64: per level, [n, k] positions of the children, N if none
    starts: Tuple[int, ...]    # first position of each depth, then N
    child_off: Tuple[int, ...]  # start of each level's block of child_idx
    child_k: Tuple[int, ...]   # children slots of a node of each level (the level's most)
    shape: Tuple[int, int]     # (H, W); (B * H, W) for a forest of B frames

    @property
    def n(self) -> int:
        return int(self.parent.shape[0])

    @property
    def roots(self) -> int:
        """The trees of the forest: 1 for a frame's tree."""
        return self.starts[1]

    @property
    def height(self) -> int:
        """The deepest node's depth."""
        return len(self.starts) - 2


def _layout(parent: torch.Tensor, weight: torch.Tensor, order: torch.Tensor,
            sizes: Sequence[int], shape) -> RootedTree:
    """The level layout of a tree or forest on its tensors' device, from
    ``order`` (a BFS order, the roots first) and ``sizes``, the positions at
    each depth. The only copy to the host is each level's most children."""
    dev = parent.device
    n = parent.shape[0]
    roots = int(sizes[0])
    ar = torch.arange(n, device=dev)
    pos = torch.empty_like(order)
    pos[order] = ar
    ppos = pos[parent[order]]
    nchild = torch.bincount(ppos[roots:], minlength=n)
    first = roots + torch.cumsum(nchild, 0) - nchild        # children are consecutive
    level = torch.repeat_interleave(torch.arange(len(sizes), device=dev),
                                    torch.tensor(list(sizes), device=dev), output_size=n)
    kmax = torch.zeros(len(sizes), dtype=torch.int64, device=dev).scatter_reduce_(
        0, level, nchild, "amax")
    child_k = tuple(int(k) for k in kmax.tolist())
    kpos = kmax[level]
    slot0 = torch.cumsum(kpos, 0) - kpos
    blocks = [k * int(s) for k, s in zip(child_k, sizes)]
    total = sum(blocks)
    owner = torch.repeat_interleave(ar, kpos, output_size=total)
    j = torch.arange(total, device=dev) - slot0[owner]
    child_idx = torch.where(j < nchild[owner], first[owner] + j, n)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    child_off = np.concatenate([[0], np.cumsum(blocks)])[:-1]
    return RootedTree(
        parent=parent, weight=weight.to(torch.int32), order=order, pos=pos, parent_pos=ppos,
        weight_bfs=weight.to(torch.int64)[order], child_idx=child_idx,
        starts=tuple(int(s) for s in starts), child_off=tuple(int(o) for o in child_off),
        child_k=child_k, shape=tuple(int(s) for s in shape))


def _bfs_order(parent: np.ndarray) -> np.ndarray:
    """A BFS order of a forest from its roots (ascending), children in
    ascending node id."""
    n = parent.shape[0]
    roots = np.flatnonzero(parent == np.arange(n))
    kids = np.flatnonzero(parent != np.arange(n))
    kids = kids[np.argsort(parent[kids], kind="stable")]
    count = np.bincount(parent[kids], minlength=n)
    first = np.cumsum(count) - count
    out, level = [roots], roots
    while level.size:
        c = count[level]
        idx = np.repeat(first[level] - (np.cumsum(c) - c), c) + np.arange(int(c.sum()))
        level = kids[idx]
        out.append(level)
    return np.concatenate(out)


def tree_from_numpy(parent: np.ndarray, weight: np.ndarray, order: Optional[np.ndarray] = None,
                    shape: Optional[Tuple[int, int]] = None, device="cpu") -> RootedTree:
    """A :class:`RootedTree` on ``device`` from numpy [N] arrays: a tree
    rooted at node 0 or a forest (every root its own parent, node 0 one of
    them): the JAX package's (``RootedTree.parent`` and ``.weight``, of
    ``build_tree`` or ``build_tree_batch``) or the native runtime's.
    ``order``: a BFS order from the roots, the roots first (the native
    runtime's third output); None takes the roots in ascending order and
    each node's children in ascending node id. ``shape``: (H, W), default
    (1, N)."""
    parent = np.asarray(parent, np.int64)
    weight = np.asarray(weight, np.int64)
    n = parent.shape[0]
    if parent[0] != 0:
        raise ValueError("tree_from_numpy: node 0 must be a root (its own parent)")
    order = _bfs_order(parent) if order is None else np.asarray(order, np.int64)
    is_root = parent == np.arange(n)
    roots = int(is_root.sum())
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    ppos = pos[parent[order]]
    if (n != len(np.unique(order)) or not is_root[order[:roots]].all() or (n > roots and (
            np.any(ppos[roots:] >= np.arange(roots, n)) or np.any(np.diff(ppos[roots:]) < 0)))):
        raise ValueError("tree_from_numpy: order is not a BFS order of the tree from its roots")
    # depths: the children of the positions [lo, hi) are the next positions
    # whose parents lie below hi (parent positions never decrease)
    starts = [0, roots]
    while starts[-1] < n:
        hi = starts[-1]
        starts.append(hi + int(np.searchsorted(ppos[hi:], hi)))
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return _layout(as_t(parent), as_t(weight), as_t(order), np.diff(starts),
                   shape if shape is not None else (1, n))


def build_tree_host(image, neighbors: int = 4, device=None) -> RootedTree:
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


def check_key_limit(h: int, w: int, neighbors: int = 4) -> None:
    """Raise where the JAX device build raises (``boruvka_mst``,
    ``boruvka_mst8``, ``boruvka_mst_contracted``): its int32 key packs the
    weight (9 bits, the batch's boundary edges weigh 256) above
    max(20, bit_length(E)) bits of the edge index, so a grid of E >= 2^22
    edges cannot be keyed. ``h``: the stacked height for a forest."""
    e = h * (w - 1) + w * (h - 1) + (2 * (h - 1) * (w - 1) if neighbors == 8 else 0)
    if 9 + max(20, int(e).bit_length()) > 31:
        raise ValueError(f"build_tree: a {h}x{w} grid has {e} edges ({neighbors} neighbours), "
                         "past the JAX device build's packed-key limit of 2^22: build it on "
                         "the host (nl_tree_host=True)")


def _prefiltered(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] images clipped to 0..255, rounded and 3x3-median
    filtered per channel (replicate border), int32: the host build's
    uint8 image (rounding and clipping commute with the median)."""
    img = images
    if img.is_floating_point():
        img = torch.clamp(torch.round(img), 0, 255)
    return median_small(img.to(torch.int32).movedim(-1, -3), 3).movedim(-3, -1)


def grid_edges(images: torch.Tensor, neighbors: int = 4):
    """(eu, ev, ew) of B [H, W, C] frames' grids, int64, in the native
    runtime's order within each frame (``_flatten_edges``/``_flatten_edges8``,
    mst.py:62, 252): right edges row-major, down edges column-major, then
    per cell, row-major, the down-right diagonal and the down-left one;
    frame after frame, node ids frame-major. ``ew``: the max-channel |dI|
    of the prefiltered images (``grid_edge_weights``, mst.py:47, 232)."""
    img = _prefiltered(images)
    b, h, w = img.shape[:3]
    ids = torch.arange(b * h * w, device=img.device).view(b, h, w)

    def diff(a, c):
        return (a - c).abs().amax(-1)

    def flat(x):
        return x.reshape(b, -1)

    us = [flat(ids[:, :, :-1]), flat(ids[:, :-1].transpose(1, 2))]
    vs = [flat(ids[:, :, 1:]), flat(ids[:, 1:].transpose(1, 2))]
    ws = [flat(diff(img[:, :, 1:], img[:, :, :-1])),
          flat(diff(img[:, 1:], img[:, :-1]).transpose(1, 2))]
    if neighbors == 8:
        us.append(flat(torch.stack([ids[:, :-1, :-1], ids[:, :-1, 1:]], -1)))
        vs.append(flat(torch.stack([ids[:, 1:, 1:], ids[:, 1:, :-1]], -1)))
        ws.append(flat(torch.stack([diff(img[:, 1:, 1:], img[:, :-1, :-1]),
                                    diff(img[:, 1:, :-1], img[:, :-1, 1:])], -1)))
    return tuple(torch.cat(p, 1).reshape(-1).to(torch.int64) for p in (us, vs, ws))


def edge_keys(ew: torch.Tensor) -> torch.Tensor:
    """The Borůvka key of each edge, ``weight * E + edge index``: distinct,
    and in the order of Kruskal's stable counting sort by weight."""
    e = ew.shape[0]
    return ew * e + torch.arange(e, device=ew.device)


def boruvka(eu: torch.Tensor, ev: torch.Tensor, key: torch.Tensor, n: int) -> torch.Tensor:
    """Minimum spanning forest of the graph on ``n`` nodes with edges
    (eu, ev) and keys ``key`` (:func:`edge_keys`), as a bool mask over the
    edges. Each round: every component's least key over its live edges (a
    segment min, ``scatter_reduce`` "amin", over both endpoints; the key
    names its edge), each component hooks onto the component across that
    edge, the smaller label of a mutual pair stays a root, and pointer
    jumping flattens the labels. It stops when no edge joins two components
    (``boruvka_mst``/``boruvka_mst8``, mst.py:75, 268, in one form for 4
    and 8 neighbours and for forests)."""
    dev = eu.device
    e = eu.shape[0]
    iota = torch.arange(n, device=dev)
    comp = iota.clone()
    chosen = torch.zeros(e + 1, dtype=torch.bool, device=dev)
    big = torch.iinfo(torch.int64).max
    while True:
        cu, cv = comp[eu], comp[ev]
        live = cu != cv
        if not bool(live.any()):
            return chosen[:e]
        k = torch.where(live, key, big)
        best = torch.full((n,), big, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, cu, k, "amin").scatter_reduce_(0, cv, k, "amin")
        has = best < big
        sel = torch.where(has, best % e, 0)
        other = torch.where(cu[sel] == iota, cv[sel], cu[sel])
        parent = torch.where(has, other, iota)
        mutual = parent[parent] == iota
        parent = torch.where(mutual & (parent > iota), iota, parent)
        chosen[torch.where(has, sel, e)] = True
        while True:
            jumped = parent[parent]
            if torch.equal(jumped, parent):
                break
            parent = jumped
        comp = parent[comp]


def _tour_suffix(src: torch.Tensor, cyc: torch.Tensor, roots: torch.Tensor, n: int,
                 val: torch.Tensor) -> torch.Tensor:
    """[2M, 2] int64: for each directed tree edge (``src``; edge 2t and
    2t + 1 are the two directions of tree edge t), the count of edges and
    the sum of ``val`` from it to the end of its tree's Euler tour. A node's
    out-edges lie in ascending ``cyc`` around it, cyclically; after the
    edge u -> v the tour takes v's out-edge that follows v -> u. Each tour
    starts at its root's first out-edge and ends where it would come back
    to it. Ranked by pointer doubling, with no copy to the host (the JAX
    package's ``_rank_tour``, mst.py:405)."""
    dev = src.device
    d = src.shape[0]
    perm = torch.argsort(cyc)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(d, device=dev)
    s_src = src[perm]
    count = torch.bincount(src, minlength=n)
    first = torch.cumsum(count, 0) - count
    last = torch.ones(d, dtype=torch.bool, device=dev)
    last[:-1] = s_src[1:] != s_src[:-1]
    nxt = torch.where(last, first[s_src], torch.arange(1, d + 1, device=dev))
    succ = nxt[inv[perm ^ 1]]                       # sorted index of the next edge
    start = torch.zeros(d + 1, dtype=torch.int64, device=dev)
    start.index_add_(0, torch.where(count[roots] > 0, first[roots], d), torch.ones_like(roots))
    step = torch.cat([torch.where(start[succ] > 0, d, succ), succ.new_full((1,), d)])
    acc = torch.stack([torch.ones_like(val), val], 1)[perm]
    acc = torch.cat([acc, acc.new_zeros(1, 2)])     # row d: past the end
    for _ in range(d.bit_length()):
        acc = acc + acc[step]
        step = step[step]
    return acc[:d][inv]


def _root_and_order(eu, ev, ew, key, chosen, n: int, frame_n: int, frames: int):
    """(parent, weight, BFS order, positions at each depth) of the forest
    whose edges ``chosen`` marks, each frame of ``frame_n`` nodes rooted at
    its node 0 (``root_tree``, mst.py:450, for the parents; the order is
    the native runtime's BFS, nl_runtime.cpp:101-131)."""
    dev = eu.device
    te = torch.nonzero(chosen).squeeze(1)
    tu, tv, tw, tk = eu[te], ev[te], ew[te], key[te]
    src = torch.stack([tu, tv], 1).reshape(-1)
    dst = torch.stack([tv, tu], 1).reshape(-1)
    dkey = tk.repeat_interleave(2)
    kmax = 256 * max(int(key.shape[0]), 1)          # above every key
    roots = torch.arange(frames, device=dev) * frame_n
    iota = torch.arange(n, device=dev)
    # tour 1 (any cyclic order: ascending key): the earlier direction of a
    # tree edge goes from the parent to the child
    cnt = _tour_suffix(src, src * kmax + dkey, roots, n, torch.zeros_like(src))[:, 0]
    fwd = cnt.view(-1, 2)[:, 0] > cnt.view(-1, 2)[:, 1]
    child = torch.where(fwd, tv, tu)
    parent = iota.clone()
    parent[child] = torch.where(fwd, tu, tv)
    weight = torch.zeros(n, dtype=torch.int64, device=dev)
    weight[child] = tw
    # tour 2: around each node its parent edge, then its children by
    # descending key; a node's preorder is its entering edge's rank, its
    # depth 1 - the sum of +1 (down) / -1 (up) from that edge on
    down = parent[dst] == src
    cyc = src * (kmax + 1) + torch.where(parent[src] == dst, 0, kmax - dkey)
    acc = _tour_suffix(src, cyc, roots, n, torch.where(down, 1, -1))
    enter = torch.where(down, dst, n)
    depth = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    depth[enter] = 1 - acc[:, 1]
    pre = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    pre[enter] = 2 * n - acc[:, 0]
    depth, pre = depth[:n], pre[:n]
    order = torch.argsort((depth * frames + iota // frame_n) * (2 * n + 1) + pre)
    return parent, weight, order, torch.bincount(depth).tolist()


def build_tree_batch(images, neighbors: int = 4) -> RootedTree:
    """B frames' rooted MSTs as one forest, built on the images' device
    ([B, H, W, C] tensor or numpy): node k * H * W + y * W + x is pixel
    (y, x) of frame k, and each frame is rooted at its node 0. Each frame's
    parents (rebased) and weights equal :func:`build_tree`'s on it, and its
    rows filter to the same bits. The JAX ``build_tree_batch`` (mst.py:1119)
    joins the frames by weight-256 edges and strips them; Borůvka on the
    disjoint grids simply stops. Raises past the JAX build's key limit
    (:func:`check_key_limit` on the stacked grid)."""
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(images)
    if images.ndim == 3:
        images = images[..., None]
    b, h, w = images.shape[:3]
    check_key_limit(b * h, w, neighbors)
    eu, ev, ew = grid_edges(images, neighbors)
    key = edge_keys(ew)
    n = b * h * w
    chosen = boruvka(eu, ev, key, n)
    parent, weight, order, sizes = _root_and_order(eu, ev, ew, key, chosen, n, h * w, b)
    return _layout(parent, weight, order, sizes, (b * h, w))


def build_tree(image, neighbors: int = 4) -> RootedTree:
    """The rooted MST of an [H, W, C] (or [H, W]) image over its 4- or
    8-neighbour grid, built on the image's device (the CPU for numpy), from
    the image clipped, rounded and 3x3-median filtered (JAX
    ``mst.build_tree``, mst.py:1097). Equal to :func:`build_tree_host` in
    every field: parent, weight, BFS order and layout."""
    if isinstance(image, np.ndarray):
        image = torch.from_numpy(image)
    return build_tree_batch(image[None], neighbors)


def sim_tables(sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sim, 1 - sim^2) over the 256 edge weights, float32 on the CPU:
    sim = exp(-w / (255 max(sigma, 0.01))) (update_table, qx_tree_filter.cpp:21-25)."""
    w = torch.arange(256, dtype=torch.float32)
    sim = torch.exp(-w / (255.0 * max(sigma, 0.01)))
    return sim, 1.0 - sim * sim


def to_rows(tree: RootedTree, cols: torch.Tensor) -> torch.Tensor:
    """[C, N] node-order columns -> the filter's [N + 1, C] float32 rows in
    BFS order, the last row -0.0 (the empty child slot)."""
    c = cols.shape[0]
    rows = torch.empty((tree.n + 1, c), dtype=torch.float32, device=cols.device)
    torch.index_select(cols.to(torch.float32).t(), 0, tree.order, out=rows[:tree.n])
    rows[tree.n].fill_(-0.0)
    return rows


def from_rows(tree: RootedTree, rows: torch.Tensor) -> torch.Tensor:
    """[N, C] rows in BFS order -> [C, N] node-order columns."""
    return rows[:tree.n].t().index_select(1, tree.pos)


def peels_in_bfloat16(compute_dtype, frame_nodes: int) -> bool:
    """Whether the JAX filter runs its peel phases in bfloat16: with that
    compute dtype, above ``PEEL_MIN_N`` nodes a frame (its doubling form
    below, float32 whatever the dtype)."""
    return compute_dtype in ("bfloat16", torch.bfloat16) and frame_nodes > PEEL_MIN_N


def filter_rows(tree: RootedTree, rows: torch.Tensor, sigma: float,
                bf16_peels: bool = False) -> torch.Tensor:
    """The two-pass filter of ``rows`` (:func:`to_rows`; its first N rows
    are overwritten by the up pass). Returns the filtered [N, C] rows in
    BFS order.

    ``bf16_peels``: round as the JAX filter's bfloat16 mode does
    (``_tree_filter_peeled`` with ``compute_dtype``, mst.py:1252-1406). Its
    peeled nodes are those, roots apart, whose subtree is less than
    ``PEELS`` deep; the others are its core. Every input row is rounded to
    bfloat16; a peeled child's term ``sim_c S^(c)`` and its add to the
    parent's row round to bfloat16, with ``sim_c`` in bfloat16, before a
    core child's float32 term; the core's sums are float32; a peeled
    node's down step is ``S = b(b(sim S(p)) + b(b(1 - b(sim^2)) S^))``, b()
    a rounding to bfloat16, from its parent's S in bfloat16; every output
    is rounded to bfloat16. The order of a parent's terms is the child
    table's, not the JAX peel rounds', so the two agree within bfloat16's
    rounding, not in bits."""
    sim_t, keep_t = (t.to(rows.device) for t in sim_tables(sigma))
    roots = tree.roots
    sim = sim_t[tree.weight_bfs]
    sim[:roots] = 0.0                                # the roots climb nowhere
    keep = keep_t[tree.weight_bfs]
    keep[:roots] = 1.0
    slot_sim = torch.cat([sim, sim.new_zeros(1)])[tree.child_idx]
    if bf16_peels:
        return _filter_rows_bf16(tree, rows, sim, keep, slot_sim)
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


def _filter_rows_bf16(tree: RootedTree, rows: torch.Tensor, sim: torch.Tensor,
                      keep: torch.Tensor, slot_sim: torch.Tensor) -> torch.Tensor:
    """:func:`filter_rows` with ``bf16_peels``. A bfloat16 add or multiply
    of bfloat16 operands rounds the exact result once, which is the JAX
    mode's rounding; a peeled child's term is -0.0 in a slot it does not
    fill, and a core child's too, so each add is the identity there."""
    st, n = tree.starts, tree.n
    dev = rows.device
    bf16 = torch.bfloat16
    sim_b = sim.to(bf16)
    slot_sim_b = slot_sim.to(bf16)
    fac_b = 1.0 - sim_b * sim_b
    rows[:n] = rows[:n].to(bf16)
    height = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)   # the empty slot: -1
    peeled = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    for lvl in range(len(st) - 2, -1, -1):
        k = tree.child_k[lvl]
        lo, hi = st[lvl], st[lvl + 1]
        o = tree.child_off[lvl]
        ci = tree.child_idx[o:o + (hi - lo) * k]
        height[lo:hi] = height[ci].view(hi - lo, k).amax(1) + 1 if k else 0
        r0 = max(lo, tree.roots)                    # the roots never peel
        peeled[r0:hi] = height[r0:hi] < PEELS
        if k == 0:
            continue
        g = rows.index_select(0, ci)
        pc = peeled[ci][:, None]
        core = (ci < n)[:, None] & ~pc
        term_b = torch.where(pc, g.to(bf16) * slot_sim_b[o:o + (hi - lo) * k, None],
                             -0.0).view(hi - lo, k, -1)
        term = torch.where(core, g * slot_sim[o:o + (hi - lo) * k, None],
                           -0.0).view(hi - lo, k, -1)
        acc = rows[lo:hi].to(bf16)                  # bfloat16 values: exact
        for j in range(k):
            acc = acc + term_b[:, j]
        acc = acc.to(torch.float32)
        for j in range(k):
            acc.add_(term[:, j])
        rows[lo:hi] = acc
    out = rows[:n] * keep[:, None]
    for lvl in range(1, len(st) - 1):
        lo, hi = st[lvl], st[lvl + 1]
        p = out.index_select(0, tree.parent_pos[lo:hi])
        core_v = out[lo:hi] + sim[lo:hi, None] * p
        peel_v = (sim_b[lo:hi, None] * p.to(bf16)
                  + fac_b[lo:hi, None] * rows[lo:hi].to(bf16)).to(torch.float32)
        out[lo:hi] = torch.where(peeled[lo:hi, None], peel_v, core_v)
    return out.to(bf16).to(torch.float32)


def tree_filter(tree: RootedTree, values: torch.Tensor, sigma: float = 0.1,
                compute_dtype=None) -> torch.Tensor:
    """Two-pass MST filter of [N, C] (or [N]) node-order values, float32:
    up pass ``S^(p) = C(p) + sum_c sim_c S^(c)``, down pass
    ``S(c) = sim_c S(p) + (1 - sim_c^2) S^(c)``, unnormalised.
    ``compute_dtype``: "bfloat16" rounds as the JAX filter's bfloat16 mode
    (:func:`filter_rows`) where it applies, a frame of ``tree.shape``
    above ``PEEL_MIN_N`` nodes."""
    squeeze = values.ndim == 1
    cols = values[None] if squeeze else values.t()
    bf16 = peels_in_bfloat16(compute_dtype, tree.shape[0] * tree.shape[1])
    out = from_rows(tree, filter_rows(tree, to_rows(tree, cols), sigma, bf16)).t()
    return out[:, 0] if squeeze else out
