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
  finished it: C chunks over P bands take C + P - 1 chunk steps;
* WTA, the LR checks, the background fill and the subpixel steps are
  row-local.

The JAX package runs this body under ``shard_map``; here each rank runs it
on its own band in its own process (``parallel/launch.py``), with the
halos and boundary rows sent by ``torch.distributed``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mystereomatching_tpu_torch.config import MatchConfig
from mystereomatching_tpu_torch.ops import aggregation as agg_ops
from mystereomatching_tpu_torch.ops import arms as arms_ops
from mystereomatching_tpu_torch.ops import cost as cost_ops
from mystereomatching_tpu_torch.ops import refine as refine_ops
from mystereomatching_tpu_torch.ops import sgm as sgm_ops
from mystereomatching_tpu_torch.ops import wta as wta_ops
from mystereomatching_tpu_torch.parallel.counters import note_all_gather, note_wavefront
from mystereomatching_tpu_torch.parallel.halo import crop_rows, exchange_rows
from mystereomatching_tpu_torch.parallel.mesh import RowMesh, all_gather_disp, sendrecv
from mystereomatching_tpu_torch.pipeline import apply_sub_ipol, check_supported, to_gray

_GRAD_COSTS = ("grad", "census_grad", "ad_grad", "ad_census_grad")


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


def _wavefront_scan(voln: torch.Tensor, psn: torch.Tensor, order, p1: float, p2: float,
                    n_chunks: int, mesh: RowMesh, mask: Optional[torch.Tensor] = None,
                    reverse: bool = False) -> torch.Tensor:
    """SGM scan along H across the row bands, chunk by chunk of W.

    voln: this band's [D, h, Ws] costs, psn [h, Ws] its penalty scales and
    mask an optional [h, Ws] in-image mask (skewed diagonal buffers); the
    scan runs down the band, or up when ``reverse``; order: (place, previous
    band's rank, next band's rank) from :func:`_band_order`. For each chunk
    the band receives the previous band's boundary path-cost row (none for
    the first band: the scan starts from zeros), scans the chunk from it
    (kernel C) and sends its own boundary row on, so that band p scans
    chunk c while band p+1 scans chunk c-1. Chunks are ceil(Ws / n_chunks)
    columns; columns scan independently, so the last, narrower chunk needs
    no padding."""
    place, prev_rank, next_rank = order
    d_, h, w = voln.shape
    cw = -(-w // n_chunks)
    chunks = [(lo, min(lo + cw, w)) for lo in range(0, w, cw)]
    out = torch.empty_like(voln)
    edge = 0 if reverse else h - 1          # the row the next band starts from
    for lo, hi in chunks:
        init = None
        if prev_rank is not None:
            init = sendrecv(mesh, [], [((1, d_, hi - lo), voln.dtype, prev_rank)])[0]
        res = sgm_ops.sgm_scan(
            voln[None, :, :, lo:hi].contiguous(), psn[None, :, lo:hi].contiguous(), p1, p2,
            axis=2, reverse=reverse, init=init,
            mask=mask[None, :, lo:hi].contiguous() if mask is not None else None)[0]
        out[:, :, lo:hi] = res
        if next_rank is not None:
            sendrecv(mesh, [(res[:, edge], next_rank)], [])
    note_wavefront(len(chunks), mesh.n_row, (d_, cw), voln.dtype,
                   len(chunks) if next_rank is not None else 0)
    return out


def _vertical_sgm_band(vol: torch.Tensor, pscale: torch.Tensor, down: bool, p1: float,
                       p2: float, n_chunks: int, mesh: RowMesh) -> torch.Tensor:
    """The vertical path costs of a band's [D, h, W] volume, exact across
    the full image height: down (predecessor above) or up. pscale [h, W]
    is this direction's, from a 1-row image halo. Scans up in place
    (``reverse``) where the JAX package flips the band."""
    return _wavefront_scan(vol, pscale, _band_order(mesh, down), p1, p2, n_chunks, mesh,
                           reverse=not down)


def _diag_sgm_band(vol: torch.Tensor, pscale: torch.Tensor, rv: int, ru: int, p1: float,
                   p2: float, n_chunks: int, mesh: RowMesh) -> torch.Tensor:
    """The diagonal path costs with predecessor (rv, ru) of a band's
    [D, h, W] volume, exact across the full image.

    The rows are skewed so that the diagonal predecessor becomes the
    vertical one, with the skew offset of the global row: the local skew
    and then a roll by a constant of the band, to a skewed width of
    W + Hg - 1 for an image of Hg rows. The boundary row a band passes on
    then lands on the next band's first row at the same skewed column, the
    same image diagonal, and the vertical wavefront scans it, with the
    in-image mask zeroing the skew margins (kernel C's mask)."""
    d_, h, w = vol.shape
    hg = mesh.n_row * h
    down = rv < 0                        # the scan runs opposite the predecessor
    vol_f = vol if down else vol.flip(1)
    ps_f = pscale if down else pscale.flip(0)
    order = _band_order(mesh, down)
    g0 = order[0] * h                    # global row offset in the scan's frame

    sign = 1 if ru > 0 else -1
    vol_s, ok = sgm_ops._skew(vol_f, sign, 0.0)
    ps_s, _ = sgm_ops._skew(ps_f, sign, 1.0)
    ok_s = ok.to(vol_s.dtype)
    grow = hg - h                        # W + Hg - 1 less the local W + h - 1
    vol_s = torch.nn.functional.pad(vol_s, (0, grow))
    ps_s = torch.nn.functional.pad(ps_s, (0, grow), value=1.0)
    ok_s = torch.nn.functional.pad(ok_s, (0, grow))
    # sign +1: column u + g, a roll by g0; sign -1: column u + (Hg - 1 - g),
    # where the local skew gives u + (h - 1 - i): a roll by Hg - 1 - g0 - (h - 1)
    r0 = g0 if sign > 0 else hg - 1 - g0 - (h - 1)
    vol_s = torch.roll(vol_s, r0, -1)
    ps_s = torch.roll(ps_s, r0, -1)
    ok_s = torch.roll(ok_s, r0, -1)

    out_s = _wavefront_scan(vol_s, ps_s, order, p1, p2, n_chunks, mesh, mask=ok_s)
    out_s = torch.roll(out_s, -r0, -1)[:, :, :w + h - 1]
    out_f = sgm_ops._unskew(out_s, sign, w)
    return out_f if down else out_f.flip(1)


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
    p1, p2 = cfg.sgm_p1_eff, cfg.sgm_p2_eff
    thres, coeff = cfg.sgm_cor_dif_thres, cfg.sgm_redu_coeff
    if rv == 0:
        ps = sgm_ops.penalty_scale(image, rv, ru, thres, coeff)[None].contiguous()
        return sgm_ops.sgm_scan(vol[None].contiguous(), ps, p1, p2, axis=3, reverse=ru > 0)[0]
    ps = _band_pscale(image, rv, ru, thres, coeff, mesh)
    if ru == 0:
        return _vertical_sgm_band(vol, ps, rv < 0, p1, p2, n_chunks, mesh)
    return _diag_sgm_band(vol, ps, rv, ru, p1, p2, n_chunks, mesh)


def _sgm_sharded(vol: torch.Tensor, image: torch.Tensor, cfg: MatchConfig, n_chunks: int,
                 mesh: RowMesh) -> torch.Tensor:
    """SGM of a band's [D, h, W] volume: horizontal scans band-local, the
    vertical and (8 paths) diagonal ones as wavefronts. The directions are
    summed as the JAX band path sums them, not as the dense path does:
    0 + down + up + (the horizontal pair) + each diagonal in order. With 4
    paths that is the dense sum; with 8 it is another association."""
    p1, p2 = cfg.sgm_p1_eff, cfg.sgm_p2_eff
    out = torch.zeros_like(vol)
    out = out + sgm_band_direction(vol, image, cfg, -1, 0, n_chunks, mesh)
    out = out + sgm_band_direction(vol, image, cfg, 1, 0, n_chunks, mesh)
    out = out + sgm_ops.sgm_directions([vol], [image], ((0, 1), (0, -1)), p1, p2,
                                       cfg.sgm_cor_dif_thres, cfg.sgm_redu_coeff)[0]
    if cfg.sgm_scan_num >= 8:
        for rv, ru in sgm_ops.DIRECTIONS_8[4:]:
            out = out + sgm_band_direction(vol, image, cfg, rv, ru, n_chunks, mesh)
    return out


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

    # optimization (pipeline.optimize), one volume at a time
    images = {0: left, 1: right}
    for lor in vols:
        vols[lor] = _sgm_sharded(vols[lor], images[lor], cfg, n_chunks, mesh)
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
    dense port refuses (``pipeline.check_supported``), NL aggregation, any
    cost but census_grad and any optimization but SGM, ``d_stream_block``
    (a 'disp' axis splits the disparities instead, as in the JAX package)
    and bfloat16 volumes. The JAX band path never casts to ``vol_dtype``
    (its ``_match_pair_band`` has no cast), so there a bfloat16
    configuration runs in float32 and differs from the dense one; the port
    refuses it instead. ValueError where n_disp does not divide the
    disparities."""
    check_supported(cfg)
    if cfg.aggregation != "cbca":
        raise NotImplementedError(
            f"sharded pipeline: aggregation {cfg.aggregation!r} (NL on row bands, the JAX "
            "nl_sharded.py, is not ported)")
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
