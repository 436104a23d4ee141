"""Row-band pipeline: one stereo pair split into bands of image rows, one
band a rank.

Counterpart of ``mystereomatching_tpu/parallel/sharded.py`` for the
branches that the three ported presets reach (``census_grad_cbca_sgm``,
``sgm8_full``, ``fullres_occfill`` in float32):

* windowed stages (census, arms, CBCA, region vote, proper interpolation,
  the medians) compute on halo-extended bands and crop, exact with
  respect to the dense pipeline where the halo covers the stage's support;
* with a 'disp' axis, each of a band's ranks builds the cost and CBCA of
  its own block of disparities (the disparity-streaming builders) and an
  all-gather over the 'disp' group rebuilds the band's volume; everything
  after it runs replicated over 'disp';
* horizontal SGM scans are band-local; the vertical and diagonal scans
  cross the bands as a wavefront: the W axis is cut into chunks, and a
  band scans chunk c from the previous band's last path-cost row of chunk
  c, which arrives point to point (kernel C's carried-in row; the diagonals
  also take its in-image mask). Band p can start chunk c once band p-1 has
  finished it: C chunks over P bands take C + P - 1 chunk steps. Every
  scan of one band order (down: the vertical and the two diagonals whose
  predecessor lies above, for every volume; up: the other three) runs
  through the same chunk steps, each step one exchange of all their
  boundary rows and one launch of kernel C's table kernel, which reads
  and writes each chunk in place;
* WTA, the LR checks, the background fill and the subpixel steps are
  row-local.

The JAX package runs this body under ``shard_map``; here each rank runs it
on its own band in its own process (``parallel/launch.py``), with the
halos and boundary rows sent by ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mystereomatching_tpu_torch.config import MatchConfig
from mystereomatching_tpu_torch.ops import aggregation as agg_ops
from mystereomatching_tpu_torch.ops import arms as arms_ops
from mystereomatching_tpu_torch.ops import cost as cost_ops
from mystereomatching_tpu_torch.ops import refine as refine_ops
from mystereomatching_tpu_torch.ops import sgm as sgm_ops
from mystereomatching_tpu_torch.ops import wta as wta_ops
from mystereomatching_tpu_torch.ops.sgm import ChunkScan
from mystereomatching_tpu_torch.parallel.counters import note_all_gather, note_wavefront
from mystereomatching_tpu_torch.parallel.halo import crop_rows, exchange_rows
from mystereomatching_tpu_torch.parallel.mesh import RowMesh, all_gather_disp, sendrecv
from mystereomatching_tpu_torch.pipeline import apply_sub_ipol, check_supported, to_gray

_GRAD_COSTS = ("grad", "census_grad", "ad_grad", "ad_census_grad")
# the vertical and diagonal directions (rv, ru) of each band order: those
# whose predecessor lies above scan down (band 0 first), the others up
BAND_ORDERS = (((-1, 0), (-1, 1), (-1, -1)), ((1, 0), (1, -1), (1, 1)))


def _cost_halo(cfg: MatchConfig) -> int:
    """Rows of halo that make cost and aggregation exact on a band."""
    h = 1
    if "census" in cfg.cost:
        h = max(h, cfg.census_rv + 1)
    if cfg.cost in _GRAD_COSTS:
        h = max(h, cfg.arm_l_out + 1)           # the adaptive weight needs arms
    if cfg.aggregation == "cbca":
        # each iteration's V pass reaches l_out; arms reach l_out beyond that
        la = cfg.arm_l_out
        h = max(h, cfg.cbca_iterations * la + la + cfg.census_rv + 1)
    if cfg.do_refine and cfg.do_region_vote:
        # region vote keeps an arm_l_out halo on the cropped arms, and the
        # arms inside that halo need their own arm_l_out of support rows
        h = max(h, 2 * cfg.arm_l_out + 1)
    return h


def _band_order(mesh: RowMesh, down: bool) -> Tuple[int, Optional[int], Optional[int]]:
    """(place of this band in the scan's order, rank of the band scanned
    before it or None, rank of the band scanned after it or None) for a
    scan running down (band 0 first) or up (the last band first)."""
    i, n = mesh.row_index, mesh.n_row
    above = mesh.row_peer(i - 1) if i > 0 else None
    below = mesh.row_peer(i + 1) if i < n - 1 else None
    return (i, above, below) if down else (n - 1 - i, below, above)


def _band_scan(vol: torch.Tensor, pscale: torch.Tensor, rv: int, ru: int,
               mesh: RowMesh) -> Tuple[ChunkScan, torch.Tensor]:
    """The scan with predecessor (rv, ru), rv = -1 or +1, of a band's
    [D, h, W] volume over its buffers' whole width, which the wavefront
    cuts into chunks, and the direction's [D, h, W] path costs (the scan's
    output, or a view of its in-image pixels). pscale [h, W] is this
    direction's, from a 1-row image halo. The scan runs opposite the
    predecessor, down the band or up it in place (``reverse``) where the
    JAX package flips the band.

    A vertical scan reads the volume itself. A diagonal one reads a skewed
    buffer, in which the diagonal predecessor becomes the vertical one, with
    the skew offset of the global row: W + Hg - 1 columns for an image of Hg
    rows, zeros outside the image, scales 1 and the in-image mask 0 there.
    Its row v holds image row v from column r0 + v on (or r0 + h - 1 - v,
    where the skew falls), r0 the band's constant: the JAX package's local
    skew, pad and roll (with the band flipped to scan up), written by one
    copy through a strided view. The boundary row a band passes on then
    lands on the next band's first row at the same skewed column, the same
    image diagonal."""
    d_, h, w = vol.shape
    down = rv < 0
    if ru == 0:
        out = torch.empty_like(vol)
        return ChunkScan(vol, pscale, out, 0, w, not down), out
    hg = mesh.n_row * h
    ws = w + hg - 1
    sign = 1 if ru > 0 else -1
    g0 = _band_order(mesh, down)[0] * h  # global row offset in the scan's frame
    # sign +1: column u + g, a roll by g0; sign -1: column u + (Hg - 1 - g),
    # where the local skew gives u + (h - 1 - i): a roll by Hg - 1 - g0 - (h - 1)
    r0 = g0 if sign > 0 else hg - 1 - g0 - (h - 1)
    # in the band's own row order the skew rises with the row where the scan
    # frame's does and the band is not flipped, or neither
    row_step, first = (ws + 1, r0) if (sign > 0) == down else (ws - 1, r0 + h - 1)

    def image(buf: torch.Tensor) -> torch.Tensor:
        return buf.as_strided(buf.shape[:-2] + (h, w), buf.stride()[:-2] + (row_step, 1),
                              first)

    costs = vol.new_zeros((d_, h, ws))
    image(costs).copy_(vol)
    ps = pscale.new_ones((h, ws))
    image(ps).copy_(pscale)
    mask = torch.zeros((h, ws), dtype=torch.float32, device=vol.device)
    image(mask).fill_(1.0)
    out = torch.empty_like(costs)
    return ChunkScan(costs, ps, out, 0, ws, not down, mask=mask), image(out)


def _rows_of(flat: Optional[torch.Tensor], widths: Sequence[int], d_: int) -> list:
    """[D, width] views of consecutive pieces of a flat buffer, or Nones."""
    if flat is None:
        return [None] * len(widths)
    rows, at = [], 0
    for w in widths:
        rows.append(flat[at:at + d_ * w].view(d_, w))
        at += d_ * w
    return rows


def _wavefront(scans: Sequence[ChunkScan], order, p1: float, p2: float, n_chunks: int,
               mesh: RowMesh) -> None:
    """Every scan of one band order along H across the row bands, chunk by
    chunk of W, all through the same chunk steps; each scan (over its
    buffers' whole width) writes its ``out`` in place.

    order: (place, previous band's rank, next band's rank) from
    :func:`_band_order`. At chunk step c a band receives the previous
    band's boundary path-cost rows of every scan's chunk c in one exchange
    (none for the first band: its scans start from zeros), which also sends
    the rows of its step c - 1 on; scans all its chunks c in one launch of
    kernel C's table; and keeps their boundary rows, written by that launch
    into one contiguous buffer, for the next exchange. So band p scans chunk
    c while band p+1 scans chunk c-1. A scan's chunks are ceil(Ws / n_chunks)
    columns; columns scan independently, so the last, narrower chunk needs
    no padding."""
    _, prev_rank, next_rank = order
    d_ = scans[0].vol.shape[0]
    dtype, device = scans[0].vol.dtype, scans[0].vol.device
    chunks = []
    for sc in scans:
        cw = -(-sc.width // n_chunks)
        chunks.append([(lo, min(lo + cw, sc.width)) for lo in range(0, sc.width, cw)])
    edges = None                          # the last step's boundary rows, to send on
    for c in range(max(map(len, chunks))):
        step = [(sc, ch[c]) for sc, ch in zip(scans, chunks) if c < len(ch)]
        widths = [hi - lo for _, (lo, hi) in step]
        sends = [(edges, next_rank)] if edges is not None else []
        recvs = [((d_ * sum(widths),), dtype, prev_rank)] if prev_rank is not None else []
        got = sendrecv(mesh, sends, recvs) if sends or recvs else []
        inits = _rows_of(got[0] if recvs else None, widths, d_)
        edges = (torch.empty(d_ * sum(widths), dtype=dtype, device=device)
                 if next_rank is not None else None)
        sgm_ops.sgm_scan_table(
            [dataclasses.replace(sc, lo=lo, width=hi - lo, init=init, edge=edge)
             for (sc, (lo, hi)), init, edge in zip(step, inits, _rows_of(edges, widths, d_))],
            p1, p2)
    if edges is not None:
        sendrecv(mesh, [(edges, next_rank)], [])
    for ch in chunks:
        note_wavefront(len(ch), mesh.n_row, (d_, ch[0][1] - ch[0][0]), dtype,
                       len(ch) if next_rank is not None else 0)


def _order_paths(vols: Sequence[torch.Tensor], images: Sequence[torch.Tensor],
                 cfg: MatchConfig, dirs, n_chunks: int,
                 mesh: RowMesh) -> Dict[Tuple[int, Tuple[int, int]], torch.Tensor]:
    """The path costs of every direction of ``dirs`` (vertical or diagonal,
    all of one band order) of every band volume [D, h, W], with its band
    image [h, W, 3], through one wavefront: {(volume index, (rv, ru)):
    [D, h, W]}."""
    thres, coeff = cfg.sgm_cor_dif_thres, cfg.sgm_redu_coeff
    scans, paths = [], {}
    for rv, ru in dirs:
        for i, (vol, image) in enumerate(zip(vols, images)):
            ps = _band_pscale(image, rv, ru, thres, coeff, mesh)
            scan, paths[(i, (rv, ru))] = _band_scan(vol, ps, rv, ru, mesh)
            scans.append(scan)
    _wavefront(scans, _band_order(mesh, dirs[0][0] < 0), cfg.sgm_p1_eff, cfg.sgm_p2_eff,
               n_chunks, mesh)
    return paths


def _band_pscale(image: torch.Tensor, rv: int, ru: int, thres, coeff,
                 mesh: RowMesh) -> torch.Tensor:
    """The penalty scale of a band: the vertical part of the predecessor
    offset comes from a 1-row image halo, the horizontal part is a local
    roll (the column wrap mis-scales only scan-edge pixels, whose path cost
    is their cost anyway, as in the dense ``penalty_scale``)."""
    imgf = exchange_rows(image, 1, mesh, row_axis=0, pad_mode="edge",
                         stage="sgm_pscale").to(torch.float32)
    shifted = torch.roll(imgf, shifts=(-rv, -ru), dims=(0, 1))
    d1 = (imgf - shifted).abs().amax(-1)[1:-1]
    return torch.where(d1 > thres, 1.0 / coeff, 1.0).to(torch.float32)


def sgm_band_direction(vol: torch.Tensor, image: torch.Tensor, cfg: MatchConfig, rv: int,
                       ru: int, n_chunks: int, mesh: RowMesh) -> torch.Tensor:
    """One direction's path costs (predecessor (rv, ru)) of a band's
    [D, h, W] volume; image: the band's [h, W, 3] reference image."""
    if rv == 0:
        ps = sgm_ops.penalty_scale(image, rv, ru, cfg.sgm_cor_dif_thres,
                                   cfg.sgm_redu_coeff)[None].contiguous()
        return sgm_ops.sgm_scan(vol[None].contiguous(), ps, cfg.sgm_p1_eff, cfg.sgm_p2_eff,
                                axis=3, reverse=ru > 0)[0]
    return _order_paths([vol], [image], cfg, ((rv, ru),), n_chunks, mesh)[(0, (rv, ru))]


def _sgm_sharded(vols: Sequence[torch.Tensor], images: Sequence[torch.Tensor],
                 cfg: MatchConfig, n_chunks: int, mesh: RowMesh) -> List[torch.Tensor]:
    """SGM of a band's [D, h, W] volumes (each with its [h, W, 3] image),
    batched as the dense ``sgm_directions`` batches them: horizontal scans
    band-local, the vertical and (8 paths) diagonal ones as one wavefront a
    band order. The directions are summed as the JAX band path sums them,
    not as the dense path does: 0 + down + up + (the horizontal pair) +
    each diagonal in ``DIRECTIONS_8`` order. With 4 paths that is the dense
    sum; with 8 it is another association."""
    p1, p2 = cfg.sgm_p1_eff, cfg.sgm_p2_eff
    n_dirs = 3 if cfg.sgm_scan_num >= 8 else 1
    outs = [torch.zeros_like(vol) for vol in vols]
    diagonals = {}
    for order in BAND_ORDERS:
        paths = _order_paths(vols, images, cfg, order[:n_dirs], n_chunks, mesh)
        for i, out in enumerate(outs):
            out += paths.pop((i, order[0]))
        diagonals.update(paths)
    horizontal = sgm_ops.sgm_directions(vols, images, ((0, 1), (0, -1)), p1, p2,
                                        cfg.sgm_cor_dif_thres, cfg.sgm_redu_coeff)
    for i, out in enumerate(outs):
        out += horizontal[i]
        for d in sgm_ops.DIRECTIONS_8[4:] if n_dirs > 1 else ():
            out += diagonals.pop((i, d))
    return outs


def _global_rows(mesh: RowMesh, hext: int, halo: int) -> torch.Tensor:
    """The global image row of each row of a halo-extended band."""
    h = hext - 2 * halo
    return mesh.row_index * h + torch.arange(hext, dtype=torch.int32) - halo


def _true_border_arm_clamp(arms: torch.Tensor, halo: int, min_arm: int,
                           mesh: RowMesh) -> torch.Tensor:
    """The vertical arms of a halo-extended band, clamped to the true
    picture borders. Arms grown on the extended band take its reflect-101
    halo rows for pixels, so a pixel of image row 0 can grow an up-arm into
    them, where the dense path's off-image fill stops it. The dense rule:
    arm = max(min(raw, dist), min(min_arm, dist)), dist the distance to the
    true border (raw and dense growth agree up to dist, the halo rows being
    the values the dense padding would give)."""
    hext = arms.shape[1]
    g = _global_rows(mesh, hext, halo).to(arms.device)
    hg = mesh.n_row * (hext - 2 * halo)
    dist_u = g.clamp(min=0)[:, None].to(arms.dtype)
    dist_d = (hg - 1 - g).clamp(min=0)[:, None].to(arms.dtype)

    def cl(a, dist):
        return torch.maximum(torch.minimum(a, dist), dist.clamp(max=min_arm))

    return torch.stack([arms[0], arms[1], cl(arms[2], dist_u), cl(arms[3], dist_d)])


def _band_grad_y(gray_ext: torch.Tensor, halo: int, mesh: RowMesh) -> torch.Tensor:
    """The y-gradient of a halo-extended band as the dense
    ``central_gradient`` gives it: central differences, with the one-sided
    rows at the true picture borders (the band's own edges lie halo rows
    away, outside what is kept)."""
    g = cost_ops.central_gradient(gray_ext, 0)
    hext = gray_ext.shape[0]
    grow = _global_rows(mesh, hext, halo).to(gray_ext.device)[:, None]
    hg = mesh.n_row * (hext - 2 * halo)
    diff = gray_ext[1:] - gray_ext[:-1]
    down = torch.cat([diff, torch.zeros_like(gray_ext[:1])], 0)
    up = torch.cat([torch.zeros_like(gray_ext[:1]), diff], 0)
    g = torch.where(grow == 0, down, g)
    return torch.where(grow == hg - 1, up, g)


def _match_pair_band(left: torch.Tensor, right: torch.Tensor, cfg: MatchConfig,
                     n_chunks: int, mesh: RowMesh) -> torch.Tensor:
    """The pipeline on one band: left/right [h, W, 3] float32, this rank's
    rows of the pair. Returns its rows of the float32 disparity map."""
    halo = _cost_halo(cfg)
    left_ext = exchange_rows(left, halo, mesh, pad_mode="reflect101", stage="images")
    right_ext = exchange_rows(right, halo, mesh, pad_mode="reflect101", stage="images")
    gl, gr = to_gray(left_ext), to_gray(right_ext)

    arms_pair = tuple(_true_border_arm_clamp(arms_ops.build_arms(img, cfg), halo,
                                             cfg.cbca_min_arm, mesh)
                      for img in (left_ext, right_ext))
    gy_pair = (_band_grad_y(gl, halo, mesh), _band_grad_y(gr, halo, mesh))

    n_imgs = 2 if (cfg.compute_both_volumes and cfg.do_lr_consis) else 1
    # this rank's disparities: all of them, or its block on a 'disp' axis
    db = cfg.num_disp // mesh.n_disp
    ds = torch.arange(mesh.disp_index * db, (mesh.disp_index + 1) * db, device=left.device)
    vols = {}
    for lor in range(n_imgs):
        blk = cost_ops.block_cost_builder(left_ext, right_ext, gl, gr, cfg, lor,
                                          arms=arms_pair[lor], grad_y_pair=gy_pair)(ds)
        arms_int = arms_ops.intersect_arms_block(arms_pair[0], arms_pair[1], ds, lor)
        blk = agg_ops.cbca(blk, arms_int, cfg.cbca_iterations, max_arm=cfg.arm_l_out)
        del arms_int
        vols[lor] = crop_rows(blk, halo, row_axis=1).contiguous()
        if mesh.n_disp > 1:
            # the band's volume from its blocks (the JAX package gathers the
            # halo-extended blocks and crops after; cropping first sends less)
            note_all_gather(vols[lor], mesh.n_disp, stage="d_shard_volume")
            vols[lor] = all_gather_disp(mesh, vols[lor])

    # optimization (pipeline.optimize), the volumes batched
    images = {0: left, 1: right}
    vols = dict(zip(vols, _sgm_sharded(list(vols.values()), [images[lor] for lor in vols], cfg,
                                       n_chunks, mesh)))
    if 1 in vols:
        dl = wta_ops.wta(vols[0], cfg.choose_small)
        dr = wta_ops.wta(vols[1], cfg.choose_small)
    elif cfg.do_refine and cfg.do_lr_consis:
        dl, dr = wta_ops.wta_pair_cooperative(vols[0], cfg.choose_small)
    else:
        dl, dr = wta_ops.wta(vols[0], cfg.choose_small), None
    if cfg.uniq_check:
        bad = wta_ops.uniqueness_mask(vols[0], dl, cfg.uniqueness_ratio)
        dl = torch.where(bad, torch.full_like(dl, cfg.disp_inv), dl)
    if not cfg.do_refine:
        return apply_sub_ipol(dl, dl, vols[0], cfg).to(torch.float32)

    # refinement (pipeline.refine's order), with each stage's halo
    d = dl
    if cfg.do_lr_consis and dr is not None:                       # row-local
        if cfg.lrc_classify:
            d = refine_ops.lr_consistency_classify(d, dr, cfg.num_disp, cfg.lr_max_diff,
                                                   cfg.disp_occ, cfg.disp_mis)
        else:
            d = refine_ops.lr_consistency(d, dr, cfg.lr_max_diff)
    if cfg.do_region_vote:
        hr = cfg.arm_l_out
        arms0 = crop_rows(arms_pair[0], halo - hr, row_axis=1).contiguous()
        for _ in range(cfg.region_vote_iters):
            d_ext = exchange_rows(d, hr, mesh, pad_mode=-1, stage="region_vote")
            d_ext = refine_ops.region_vote(d_ext, arms0, cfg.num_disp, cfg.rv_s_thres,
                                           cfg.rv_h_ratio, cfg.rv_int_ratio_quirk,
                                           max_arm=cfg.arm_l_out)
            d = crop_rows(d_ext, hr)
    if cfg.do_proper_ipol:
        hp = 2 * cfg.pi_search_depth
        li_ext = exchange_rows(left, hp, mesh, pad_mode="edge", stage="proper_ipol_image")
        for _ in range(cfg.proper_ipol_iters):
            d_ext = exchange_rows(d, hp, mesh, pad_mode=-1, stage="proper_ipol")
            d_ext = refine_ops.proper_interpolation(d_ext, li_ext, cfg.pi_search_depth,
                                                    cfg.disp_occ)
            d = crop_rows(d_ext, hp)
    if cfg.do_bg_ipol:
        d = refine_ops.bg_interpolation(d, cfg.num_disp)           # row-local
    hm = cfg.median_kernel // 2
    if cfg.do_subpixel:
        sub = refine_ops.subpixel_enhance(d, vols[0])             # pointwise
        sub_ext = exchange_rows(sub, hm, mesh, pad_mode="edge", stage="median")
        return crop_rows(refine_ops.median_blur_disp(sub_ext, cfg.median_kernel),
                         hm).to(torch.float32)
    if cfg.do_last_median:
        d_ext = exchange_rows(d, hm, mesh, pad_mode="edge", stage="median")
        d = crop_rows(refine_ops.median_blur_disp(d_ext, cfg.median_kernel), hm)
    return apply_sub_ipol(d, dl, vols[0], cfg).to(torch.float32)


def check_sharded_support(cfg: MatchConfig, n_disp: int = 1) -> None:
    """Raise NotImplementedError, naming the flag, for every configuration
    the band path would not run with the dense path's meaning: whatever the
    dense port refuses (``pipeline.check_supported``), the refinement
    stages beyond the default chain (the census border fill, PKR,
    RV_combine_BG, the histogram region vote, CBBI, the KITTI fill, the
    weighted median, discontinuity adjustment and the whole-image vote), NL,
    box-filter and guided-filter aggregation, double-window CBCA, the vmTop decision, the
    cross-scale pyramid, the multilevel and adaptive arms, any cost but
    census_grad and any optimization but SGM, ``d_stream_block``
    (a 'disp' axis splits the disparities instead, as in the JAX package)
    and bfloat16 volumes. The JAX band path never casts to ``vol_dtype``
    (its ``_match_pair_band`` has no cast), so there a bfloat16
    configuration runs in float32 and differs from the dense one; the port
    refuses it instead. ValueError where n_disp does not divide the
    disparities."""
    check_supported(cfg)
    refining = cfg.do_refine
    for hit, flag in (
            (refining and cfg.do_fill_surrounding, "do_fill_surrounding"),
            (refining and cfg.do_pkr, "do_pkr"),
            (refining and cfg.do_region_vote and cfg.rv_use_combine_bg, "rv_use_combine_bg"),
            (refining and cfg.do_region_vote and not cfg.rv_use_combine_bg
             and not cfg.rv_int_ratio_quirk, "rv_int_ratio_quirk=False"),
            (refining and cfg.do_cbbi, "do_cbbi"),
            (refining and cfg.do_bg_ipol and cfg.bg_ipol_kitti, "bg_ipol_kitti"),
            (refining and cfg.do_wm, "do_wm"),
            (refining and cfg.do_da, "do_da"),
            (refining and cfg.do_rv_whole_image, "do_rv_whole_image")):
        if hit:
            raise NotImplementedError(
                f"sharded pipeline: {flag} (its band form, in the JAX parallel/sharded.py, is "
                "not ported)")
    if cfg.pyramid_levels > 1:
        raise NotImplementedError(
            f"sharded pipeline: pyramid_levels={cfg.pyramid_levels} (the band form of the "
            "cross-scale pyramid, in the JAX parallel/sharded.py, is not ported)")
    if cfg.cbca_arm_mode != "two_level":
        raise NotImplementedError(
            f"sharded pipeline: cbca_arm_mode {cfg.cbca_arm_mode!r} (the band path grows "
            "two-level arms only)")
    if cfg.aggregation != "cbca":
        raise NotImplementedError(
            f"sharded pipeline: aggregation {cfg.aggregation!r} (NL on row bands, the JAX "
            "nl_sharded.py, is not ported)")
    for flag in ("cbca_double_win", "do_vmtop"):
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"sharded pipeline: {flag} (its band form, in the JAX parallel/sharded.py, is "
                "not ported)")
    if cfg.cost != "census_grad" or cfg.optimization != "sgm":
        raise NotImplementedError(
            f"sharded pipeline: cost {cfg.cost!r}, optimization {cfg.optimization!r} (the band "
            "path runs census_grad and SGM)")
    if cfg.d_stream_block:
        raise NotImplementedError(
            "sharded pipeline: d_stream_block (use a 'disp' mesh axis instead)")
    if cfg.num_disp % n_disp:
        raise ValueError(f"num_disp={cfg.num_disp} must divide over the 'disp' axis "
                         f"({n_disp} ranks)")
    if cfg.vol_dtype != "float32":
        raise NotImplementedError(
            f"sharded pipeline: vol_dtype {cfg.vol_dtype!r} (the band path runs float32 "
            "volumes only; the JAX band path ignores vol_dtype)")
