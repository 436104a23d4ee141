"""End-to-end stereo pipeline: cost -> aggregation -> optimization -> refine.

Counterpart of ``mystereomatching_tpu/pipeline.py`` for the stages ported
so far. Costs: every cost of the JAX package: the default censusGrad,
``census`` (any ``census_func``), ``census_from2`` (both blends),
``ad_census``, ``ad_census_grad``, ``ad_census_zncc``, ``ad_grad``,
``ad``, ``sd``, ``grad`` (one or two directions, adaptive or summed,
normalised or not), ``zncc``, ``ssd``, truncated AD (``trunc_ad``),
Birchfield-Tomasi (``bt``) and the NL flow's ``qx_ad_grad`` and
``qx_census``. Aggregation: cross arms (in any ``cbca_arm_mode``: two
levels, multilevel or adaptive) and CBCA (at one arm scale, or at two
merged by ``combine2Vm``, ``_2``, ``_3`` or ``_4``: ``cbca_double_win``), or
none, in float32 or bfloat16 volumes, whole or, for the costs with a
block form, streamed over blocks of ``d_stream_block`` disparities
(``trunc_ad`` and ``bt`` whole and in float32 only; ``zncc``, ``ssd`` and
``ad_census_zncc`` whole); the box or the guided filter, FIF, AWS, JBF or GFNL of a
float32 volume; or the NL tree filter on the image's MST (any of these
costs, float32 or bfloat16 volumes, the filter in float32 or in the JAX
package's bfloat16 mode), the tree built on the device or, with
``nl_tree_host``, on the host. Cross-scale aggregation
(``pyramid_levels``): the volumes of each coarser level of the images'
Gaussian pyramid fused into the finest by ``crossscale.solve_all``.
Optimization: 4- or 8-path SGM, or none,
then WTA on the left and right volumes, or the cooperative WTA of the left volume alone, and the
uniqueness check; or the vmTop decision in place of WTA; or scanline
optimisation (``"so"``), which decides each volume itself. Refinement: every
stage of the JAX package's chain (the census border fill, LR check plain
or classifying, PKR, region vote in its unanimity and histogram forms or
RV_combine_BG with its HV, tilted and gated votes and its background
fills, CBBI, proper interpolation, the background fill plain or KITTI's,
the weighted median, discontinuity adjustment, either the median or
subpixel enhancement with its median, and the whole-image vote), and the
decision-time subpixel (``sub_ipol``). And the standalone
qx NL flow (``nl_post_process``, ``ops/nl.nl_disparity``), which owns its
decision and refinement. That covers the presets ``census_grad_cbca_sgm``
(with or without ``do_refine``), ``ad_census_wta``, ``census_wta``,
``census_cbca_lrc``, ``sgm8_full``, ``fullres_occfill`` (with its bfloat16
cooperative variant and its disparity streaming), ``nl_tree_filter``,
``nl_8nr``, ``nl_post``, ``nl_census_post``, ``census_cbca_vmtop``,
``cbca_double``, ``ad_grad_gf``, ``zncc_bf_wta``, ``aws_wta``,
``census_fif_sgm``, ``bt_so`` and ``gfnl_wta``: every preset of the
registry. :func:`match_pair_nl_batch` runs a batch of NL frames on one
forest of trees. A configuration that needs any other stage raises
``NotImplementedError`` naming it.

PyTorch runs eagerly: :class:`StereoPipeline` validates the configuration,
moves the inputs to its device and, for NL and GFNL, builds the trees
first (:func:`nl_trees`, timed apart). On a CUDA device the kernel-backed ops launch their
CUDA kernels (:func:`kernels_launched` names those of a configuration); on
the CPU they run their plain torch versions.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List

import numpy as np
import torch

from mystereomatching_tpu_torch.config import MatchConfig, as_port_config
from mystereomatching_tpu_torch.ops import aggregation as agg_ops
from mystereomatching_tpu_torch.ops import arms as arms_ops
from mystereomatching_tpu_torch.ops import cbbi as cbbi_ops
from mystereomatching_tpu_torch.ops import combine as combine_ops
from mystereomatching_tpu_torch.ops import cost as cost_ops
from mystereomatching_tpu_torch.ops import crossscale
from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops import mst
from mystereomatching_tpu_torch.ops import nl as nl_ops
from mystereomatching_tpu_torch.ops import refine as refine_ops
from mystereomatching_tpu_torch.ops import sgm as sgm_ops
from mystereomatching_tpu_torch.ops import so as so_ops
from mystereomatching_tpu_torch.ops import vmtop as vmtop_ops
from mystereomatching_tpu_torch.ops import wta as wta_ops


def to_gray(img: torch.Tensor) -> torch.Tensor:
    """RGB -> gray as the reference reads it (libpng's rgb_to_gray):
    (9797 R + 19234 G + 3737 B) >> 15, float32 [H, W]. cvtColor-style
    rounding would flip about half the pixels by one level."""
    r, g, b = (img[..., c].to(torch.int32) for c in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).to(torch.float32)


VOL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
COSTS = ("census_grad", "ad_grad", "census", "ad_census", "ad", "sd", "grad", "census_from2",
         "ad_census_grad", "zncc", "ssd", "ad_census_zncc", "trunc_ad", "bt", "qx_ad_grad",
         "qx_census")
# the costs of cost_ops.block_cost_builder, which CBCA and no aggregation build
# on, whole or a block of disparities at a time
BLOCK_COSTS = cost_ops.BLOCK_COSTS
# the costs without a block form, which CBCA and no aggregation take whole, as
# the JAX package's dense path does: in float32 or bfloat16, never streamed
# (the JAX block builder refuses them too) ...
DENSE_COSTS = ("zncc", "ssd", "ad_census_zncc")
# ... and in float32 only
UNBLOCKED_COSTS = ("trunc_ad", "bt")
# the aggregations of a whole float32 volume (agg_ops.aggregate), and their costs
WHOLE_AGGREGATIONS = ("bf", "gf", "fif", "aws", "jbf", "gfnl")
WHOLE_COSTS = BLOCK_COSTS + DENSE_COSTS + UNBLOCKED_COSTS
# the aggregations filtering on the image's tree, which nl_trees builds
TREE_AGGREGATIONS = ("nl", "gfnl")


def _needs_arms_for_cost(cfg: MatchConfig) -> bool:
    """The gradient costs' arm-adaptive weight reads the reference image's arms."""
    return (cfg.cost in ("grad", "census_grad", "ad_grad", "ad_census_grad")
            and cfg.grad_use_2dir and cfg.grad_fuse_adaptive)


def _double_win(cfg: MatchConfig) -> bool:
    """Double-window CBCA, which only CBCA reads the flag for."""
    return cfg.aggregation == "cbca" and cfg.cbca_double_win


def _nl_flow(cfg: MatchConfig) -> bool:
    """The standalone qx NL flow, which owns its decision and refinement."""
    return cfg.aggregation == "nl" and cfg.nl_post_process


def _so(cfg: MatchConfig) -> bool:
    """Scanline optimisation, which decides each volume itself: no WTA,
    uniqueness check, vmTop or sub_ipol after it (the qx NL flow owns its
    decision instead)."""
    return cfg.optimization == "so" and not _nl_flow(cfg)


def _level_disparities(cfg: MatchConfig) -> List[int]:
    """The disparities of each pyramid level, finest first: max_disp
    becomes max_disp // 2 + 1 at each coarser level (main_.cpp:152)."""
    out, max_disp = [], cfg.max_disp
    for _ in range(cfg.pyramid_levels):
        out.append(max_disp + 1)
        max_disp = max_disp // 2 + 1
    return out


def _needs_vote_arms(cfg: MatchConfig) -> bool:
    """The region votes read the left image's cross arms (with refinement on)."""
    return cfg.do_region_vote or cfg.do_rv_whole_image


def _n_views(cfg: MatchConfig) -> int:
    """The volumes built: left, and right when the LR check reads one."""
    return 2 if (cfg.compute_both_volumes and cfg.do_lr_consis) else 1


def check_supported(cfg: MatchConfig) -> None:
    """Raise NotImplementedError for a stage this package does not run yet."""
    unported = [
        (cfg.cost not in COSTS, f"cost {cfg.cost!r}"),
        (cfg.aggregation in ("cbca", "none") and cfg.cost not in WHOLE_COSTS,
         f"cost {cfg.cost!r} with aggregation {cfg.aggregation!r}"),
        (cfg.cost in UNBLOCKED_COSTS and cfg.vol_dtype != "float32" and cfg.aggregation != "nl",
         f"vol_dtype {cfg.vol_dtype!r} with cost {cfg.cost!r}"),
        (cfg.cost in UNBLOCKED_COSTS + DENSE_COSTS and cfg.d_stream_block != 0,
         f"d_stream_block with cost {cfg.cost!r} (no disparity-streaming form)"),
        (cfg.aggregation in WHOLE_AGGREGATIONS and cfg.cost not in WHOLE_COSTS,
         f"cost {cfg.cost!r} with aggregation {cfg.aggregation!r}"),
        (cfg.aggregation in WHOLE_AGGREGATIONS and cfg.vol_dtype != "float32",
         f"vol_dtype {cfg.vol_dtype!r} with aggregation {cfg.aggregation!r}"),
        (cfg.aggregation in WHOLE_AGGREGATIONS and cfg.d_stream_block != 0,
         f"d_stream_block with aggregation {cfg.aggregation!r} (no disparity-streaming form)"),
        (cfg.cost == "qx_ad_grad" and not _nl_flow(cfg) and _n_views(cfg) == 2,
         "qx_ad_grad right volume (left volume only)"),
        (cfg.aggregation not in ("cbca", "none", "nl") + WHOLE_AGGREGATIONS,
         f"aggregation {cfg.aggregation!r}"),
        (cfg.aggregation == "nl" and cfg.d_stream_block != 0,
         "d_stream_block with NL aggregation (no disparity-streaming form)"),
        (cfg.aggregation == "gfnl" and cfg.nl_neighbors != 4,
         f"nl_neighbors={cfg.nl_neighbors} with GFNL aggregation (the JAX package filters "
         "its tree with 4-neighbour slots)"),
        (_double_win(cfg) and cfg.vol_dtype != "float32",
         f"vol_dtype {cfg.vol_dtype!r} with cbca_double_win"),
        (cfg.optimization not in ("sgm", "wta", "so"), f"optimization {cfg.optimization!r}"),
        (_so(cfg) and cfg.vol_dtype != "float32", f"vol_dtype {cfg.vol_dtype!r} with SO"),
        (_so(cfg) and cfg.d_stream_block != 0,
         "d_stream_block with SO (no disparity-streaming form)"),
        (cfg.optimization == "sgm" and cfg.sgm_scan_num not in (4, 8),
         f"{cfg.sgm_scan_num}-path SGM"),
        (cfg.do_vmtop and not _nl_flow(cfg) and cfg.vol_dtype != "float32",
         f"vol_dtype {cfg.vol_dtype!r} with do_vmtop"),
        (cfg.d_stream_block != 0 and cfg.cbca_double_win,
         "d_stream_block with cbca_double_win (no disparity-streaming form)"),
        (cfg.pyramid_levels > 1 and cfg.d_stream_block != 0 and any(
            nd % cfg.d_stream_block for nd in _level_disparities(cfg)),
         f"d_stream_block={cfg.d_stream_block} with pyramid_levels={cfg.pyramid_levels} (the "
         f"levels' {_level_disparities(cfg)} disparities do not all divide into blocks; the JAX "
         "package's streamed loop drops the remainder)"),
        (cfg.vol_dtype not in VOL_DTYPES, f"vol_dtype {cfg.vol_dtype!r}"),
    ]
    missing = [name for hit, name in unported if hit]
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


def kernels_launched(cfg: MatchConfig) -> List[str]:
    """The CUDA kernels a frame of ``cfg`` launches on the card, in the
    order of ``cuda_kernels.launches``."""
    cfg = as_port_config(cfg)
    refining = cfg.do_refine and not _nl_flow(cfg)
    used = set() if (cfg.do_vmtop and not _nl_flow(cfg)) or _so(cfg) else {"wta"}
    if cfg.aggregation == "cbca":
        used.add("arm_taps")
    if cfg.aggregation == "cbca" or _needs_arms_for_cost(cfg) or (
            refining and _needs_vote_arms(cfg)):
        used.add("arms_grow")
    if cfg.optimization == "sgm" and not _nl_flow(cfg):
        used.add("sgm_scan")
        if cfg.sgm_scan_num > 4:
            used.add("sgm_diag")
    if refining and cfg.do_region_vote and not cfg.rv_use_combine_bg:
        used.add("region_vote" if cfg.rv_int_ratio_quirk else "arm_reduce")
    if refining and (cfg.do_rv_whole_image and not cfg.do_subpixel or (
            cfg.do_region_vote and cfg.rv_use_combine_bg and cfg.interpolate_type != 1
            and cfg.reg_vote_type != 1)):
        # the histogram votes over the HV support: the whole-image vote
        # (after the early return of do_subpixel) and RV_combine_BG's vote of
        # types 0 and 2
        used.add("arm_reduce")
    if refining and cfg.do_proper_ipol:
        used.add("pi_scan")
    return [name for name in ck.launches if name in used]


def compute_volumes(left: torch.Tensor, right: torch.Tensor, cfg: MatchConfig,
                    trees=None):
    """L1 + L2: the aggregated cost volumes of the needed views.

    Returns (vols, arms_pair): vols is {0: volL, 1: volR} (volR only when
    the LR check is on and ``compute_both_volumes``), in ``vol_dtype`` from
    the cast after the cost on; arms_pair is the two images' [4, H, W]
    cross arms. CBCA and no aggregation (``"none"``): with
    ``d_stream_block`` each volume is built a block of disparities at a
    time (:func:`_aggregated_volume`); double-window CBCA also builds both
    images' arms at ``cfg.window1()``. The box and guided filters, FIF,
    AWS, JBF and GFNL (``WHOLE_AGGREGATIONS``): each view's whole cost
    volume aggregated by ``agg_ops.aggregate``, guided by that view's
    image (and, for AWS, the other view's; for GFNL, its tree). NL: each
    view's cost volume, cast to ``vol_dtype``, filtered on its image's
    tree. NL and GFNL need ``trees[lor]`` (:func:`nl_trees`). Both of the images'
    arms are built for CBCA; otherwise only those that the cost or the
    region vote reads (None for the others).
    """
    gl, gr = to_gray(left), to_gray(right)
    n_imgs = _n_views(cfg)
    images = (left, right)
    region_vote = cfg.do_refine and _needs_vote_arms(cfg)
    arms_pair = tuple(
        arms_ops.build_arms(images[lor], cfg)
        if cfg.aggregation == "cbca" or (_needs_arms_for_cost(cfg) and lor < n_imgs)
        or (lor == 0 and region_vote) else None
        for lor in (0, 1))
    if cfg.aggregation in TREE_AGGREGATIONS and trees is None:
        raise ValueError(f"compute_volumes: {cfg.aggregation!r} aggregation needs the frame's "
                         "trees (nl_trees)")
    if cfg.aggregation in WHOLE_AGGREGATIONS:
        grays = (gl, gr)
        # contiguous for the kernels after it (FIF's passes end transposed)
        vols = {lor: agg_ops.aggregate(
            cost_ops.compute_cost_volume(left, right, gl, gr, cfg, lor, arms=arms_pair[lor]),
            cfg, images[lor], grays[lor], other_image=images[1 - lor], lor=lor,
            tree=trees[lor] if trees is not None else None).contiguous()
            for lor in range(n_imgs)}
        return vols, arms_pair
    if cfg.aggregation != "nl":
        arms2_pair = (tuple(arms_ops.build_arms(img, cfg.window1()) for img in images)
                      if _double_win(cfg) else None)
        vols = {lor: _aggregated_volume(left, right, gl, gr, cfg, lor, arms_pair, arms2_pair)
                for lor in range(n_imgs)}
        return vols, arms_pair
    vdt = VOL_DTYPES[cfg.vol_dtype]
    vols = {lor: agg_ops.nl(cost_ops.compute_cost_volume(left, right, gl, gr, cfg, lor,
                                                         arms=arms_pair[lor]).to(vdt),
                            trees[lor], cfg)
            for lor in range(n_imgs)}
    return vols, arms_pair


def level_volumes(left: torch.Tensor, right: torch.Tensor, cfg: MatchConfig):
    """:func:`compute_volumes` of one level of the cross-scale pyramid
    ({lor: volume}), the NL or GFNL trees built here on the images' device
    whatever ``nl_tree_host``: the JAX package's coarser levels call its
    ``compute_volumes`` with no host trees, which builds them on the device.
    No arms are built for region vote, which reads the finest level's."""
    cfg = cfg.replace(do_refine=False)
    trees = (nl_trees(left, right, cfg.replace(nl_tree_host=False))
             if cfg.aggregation in TREE_AGGREGATIONS else None)
    return compute_volumes(left, right, cfg, trees)[0]


def cross_scale(vols, left: torch.Tensor, right: torch.Tensor,
                cfg: MatchConfig) -> Dict[int, torch.Tensor]:
    """Cross-scale aggregation (SolveAll, cpp:2142-2208; the JAX
    ``match_pair``'s pyramid step): each coarser level's volumes of the
    views in ``vols`` (:func:`level_volumes` on the images ``pyr_down``'ed
    once more, max_disp // 2 + 1 disparities, main_.cpp:152), fused with the
    finest ``vols`` by ``crossscale.solve_all``: float32 volumes.
    ``crossscale.cross_scale_volume`` is the same for one view, its finest
    level built too."""
    per_level = {lor: [vols[lor]] for lor in vols}
    coarser = itertools.islice(crossscale.levels(left, right, cfg, cfg.pyramid_levels), 1, None)
    for lvl, rvl, c in coarser:
        coarse = level_volumes(lvl, rvl, c)
        for lor in vols:
            per_level[lor].append(coarse[lor])
        del coarse
    return {lor: crossscale.solve_all(per_level[lor], cfg.reg_lambda) for lor in vols}


def nl_trees(left, right, cfg: MatchConfig) -> Dict[int, mst.RootedTree]:
    """The NL or GFNL trees a frame of ``cfg`` filters on, from the
    median-prefiltered images: {0: left, 1: right} for the views it filters
    (both in the qx NL flow), on the images' device. Built there
    (``mst.build_tree``, the JAX package's default) or, with
    ``nl_tree_host``, on the host by the native runtime
    (``mst.build_tree_host``); the two give the same trees, and neither
    falls back to the other. :func:`match_pair` calls it when given no
    trees, and :class:`StereoPipeline` to time the build apart."""
    views = 2 if _nl_flow(cfg) else _n_views(cfg)
    build = mst.build_tree_host if cfg.nl_tree_host else mst.build_tree
    return {lor: build(img, cfg.nl_neighbors)
            for lor, img in enumerate((left, right)[:views])}


def _aggregated_volume(left, right, gl, gr, cfg: MatchConfig, lor: int,
                       arms_pair, arms2_pair=None) -> torch.Tensor:
    """Cost and CBCA (none with ``aggregation="none"``) of view ``lor``:
    over all disparities at once, or, with ``d_stream_block``, a block of
    disparities at a time (the JAX package's ``pipeline._volume_dstream``).
    Cost and CBCA are independent across disparities:
    each block's cost is built, cast to ``vol_dtype`` before its CBCA as the
    dense path casts the whole volume, aggregated with its own [4, Db, H, W]
    intersected arms and written into the [D, H, W] ``vol_dtype`` volume,
    each plane equal to the dense path's bit for bit. Only one block's
    cost, arms and CBCA temporaries are live at a time: the census stack
    and the intersected arms, the largest tensors of the dense path, shrink
    by D / Db. With ``arms2_pair`` (double-window CBCA, never streamed) the
    raw volume also takes a CBCA pass at the large window's arms and
    ``max_arm``, run first as in the JAX package, and the two are merged by
    ``cbca_combine``'s merge."""
    vdt = VOL_DTYPES[cfg.vol_dtype]
    if cfg.cost in BLOCK_COSTS:
        block_fn = cost_ops.block_cost_builder(left, right, gl, gr, cfg, lor,
                                               arms=arms_pair[lor])
    else:
        # DENSE_COSTS and UNBLOCKED_COSTS: the whole volume, never streamed
        # (check_supported)
        def block_fn(ds):
            return cost_ops.compute_cost_volume(left, right, gl, gr, cfg, lor,
                                                arms=arms_pair[lor])

    def aggregated(ds: torch.Tensor) -> torch.Tensor:
        # contiguous for the kernels after it (AD's channel sum keeps the
        # shifted stack's strides)
        blk = block_fn(ds).to(vdt).contiguous()
        if cfg.aggregation == "none":
            return blk
        vol2 = None
        if arms2_pair is not None:
            arms2_int = arms_ops.intersect_arms_block(arms2_pair[0], arms2_pair[1], ds, lor)
            vol2 = agg_ops.cbca(blk, arms2_int, cfg.cbca_iterations,
                                max_arm=cfg.window1().arm_l_out)
            del arms2_int
        arms_int = arms_ops.intersect_arms_block(arms_pair[0], arms_pair[1], ds, lor)
        vol = agg_ops.cbca(blk, arms_int, cfg.cbca_iterations, max_arm=cfg.arm_l_out)
        if vol2 is None:
            return vol
        return combine_ops.combine(vol, vol2, cfg.cbca_combine, arms_pair[lor], arms_pair[0])

    nd = cfg.num_disp
    db = cfg.d_stream_block or nd
    if db == nd:
        return aggregated(torch.arange(nd, device=left.device))
    out = torch.empty((nd,) + tuple(left.shape[:2]), dtype=vdt, device=left.device)
    for d0 in range(0, nd, db):
        out[d0:d0 + db] = aggregated(torch.arange(d0, d0 + db, device=left.device))
    return out


def optimize(vols, left: torch.Tensor, right: torch.Tensor, cfg: MatchConfig):
    """L3: SGM over all volumes together (``optimization="sgm"``; none for
    ``"wta"``), then WTA on each (the cooperative WTA of the left volume
    alone when it is the only one and the LR check needs a right map) and,
    with ``uniq_check``, DISP_INV where the left map fails the uniqueness
    test. With ``do_vmtop`` the vmTop decision of each volume (its view's
    image for method 2) replaces WTA and the uniqueness check, as in the
    JAX package. Scanline optimisation (``"so"``) decides each volume, left
    to right guided by its view's image, and returns before all of that.

    Returns (d_left, d_right or None, vol_left after optimization)."""
    if _so(cfg):
        d1 = so_ops.scanline_optimize(vols[1], right, cfg) if 1 in vols else None
        return so_ops.scanline_optimize(vols[0], left, cfg), d1, vols[0]
    if cfg.optimization == "sgm":
        images = {0: left, 1: right}
        lors = sorted(vols)
        out = sgm_ops.sgm_multi(
            [vols[i] for i in lors], [images[i] for i in lors],
            num_directions=cfg.sgm_scan_num, p1=cfg.sgm_p1_eff, p2=cfg.sgm_p2_eff,
            cor_dif_thres=cfg.sgm_cor_dif_thres, redu_coeff=cfg.sgm_redu_coeff)
        vols = dict(zip(lors, out))
    if cfg.do_vmtop:
        dl = vmtop_ops.disp_from_top(vols[0], left, cfg, cfg.vmtop_method)
        dr = (vmtop_ops.disp_from_top(vols[1], right, cfg, cfg.vmtop_method)
              if 1 in vols else None)
        return dl, dr, vols[0]
    if 1 in vols:
        dl = wta_ops.wta(vols[0], cfg.choose_small)
        dr = wta_ops.wta(vols[1], cfg.choose_small)
    elif cfg.do_refine and cfg.do_lr_consis:
        dl, dr = wta_ops.wta_pair_cooperative(vols[0], cfg.choose_small)
    else:
        dl, dr = wta_ops.wta(vols[0], cfg.choose_small), None
    if cfg.uniq_check:
        # UniqCk (wta_Co cpp:2763-2775): refinement fills these pixels
        bad = wta_ops.uniqueness_mask(vols[0], dl, cfg.uniqueness_ratio)
        dl = torch.where(bad, torch.full_like(dl, cfg.disp_inv), dl)
    return dl, dr, vols[0]


def refine(d_left: torch.Tensor, d_right, vol_left, left: torch.Tensor,
           arms0: torch.Tensor, cfg: MatchConfig) -> torch.Tensor:
    """L4 (refine() cpp:1347-1511) on the left map, in the JAX package's
    stage order: the census border filled on both maps
    (``do_fill_surrounding``); the LR check (plain, or classifying failures
    as DISP_OCC or DISP_MIS), whose failures the weighted median reads;
    PKR from vol_left; ``region_vote_iters`` passes of the region vote
    (unanimity or histogram) or of RV_combine_BG (the tilted arms built from
    the left image for vote types 1 and 2); CBBI; proper interpolation; the
    background fill (KITTI's or the plain one); the weighted median;
    discontinuity adjustment from vol_left; then subpixel enhancement from
    vol_left and its median (returned at once), or the last median and the
    whole-image vote. vol_left is the left volume after SGM; arms0 the left
    image's [4, H, W] cross arms. Returns a float32 map with
    ``do_subpixel``, else int32."""
    d = d_left
    if cfg.do_fill_surrounding:
        # fillSurronding (cpp:2214-2260) on both maps before the LR check
        d = refine_ops.fill_surrounding(d, cfg.census_rv, cfg.census_ru, cfg.disp_inv)
        if d_right is not None:
            d_right = refine_ops.fill_surrounding(d_right, cfg.census_rv, cfg.census_ru,
                                                  cfg.disp_inv)
    if cfg.do_lr_consis and d_right is not None:
        if cfg.lrc_classify:
            d = refine_ops.lr_consistency_classify(d, d_right, cfg.num_disp, cfg.lr_max_diff,
                                                   cfg.disp_occ, cfg.disp_mis)
        else:
            d = refine_ops.lr_consistency(d, d_right, cfg.lr_max_diff)
    lrc_fail = d < 0
    if cfg.do_pkr:
        d = refine_ops.apply_pkr(d, vol_left, cfg.pkr_thresh, cfg.disp_pkr)
    if cfg.do_region_vote:
        arms_tilt = None
        if cfg.rv_use_combine_bg and cfg.reg_vote_type > 0:
            arms_tilt = arms_ops.build_arms(left, cfg, directions=arms_ops.TILT_DIRECTIONS)
        for _ in range(cfg.region_vote_iters):
            if cfg.rv_use_combine_bg:
                d = refine_ops.rv_combine_bg(
                    d, arms0, arms_tilt, left, cfg.num_disp, cfg.rv_s_thres, cfg.rv_h_ratio,
                    cfg.interpolate_type, cfg.reg_vote_type, cfg.bg_ipl_depth, cfg.bg_ip_dir,
                    cfg.disp_occ, cfg.disp_mis, max_arm=cfg.arm_l_out)
            else:
                d = refine_ops.region_vote(d, arms0, cfg.num_disp, cfg.rv_s_thres,
                                           cfg.rv_h_ratio, cfg.rv_int_ratio_quirk,
                                           max_arm=cfg.arm_l_out)
    if cfg.do_cbbi:
        d = cbbi_ops.cbbi(d, left, cfg)
    if cfg.do_proper_ipol:
        for _ in range(cfg.proper_ipol_iters):
            d = refine_ops.proper_interpolation(d, left, cfg.pi_search_depth,
                                                cfg.disp_occ)
    if cfg.do_bg_ipol:
        d = (refine_ops.interpolate_background_kitti(d, cfg.ipol_threshold)
             if cfg.bg_ipol_kitti else refine_ops.bg_interpolation(d, cfg.num_disp))
    if cfg.do_wm:
        d = refine_ops.weighted_median(d, left, lrc_fail, cfg.num_disp, cfg.wm_win,
                                       cfg.wm_sigma_c, cfg.wm_sigma_s)
    if cfg.do_da:
        d = refine_ops.discontinuity_adjust(d, vol_left)
    if cfg.do_subpixel:
        # the float map; the reference keeps a separate SE buffer
        return refine_ops.median_blur_disp(refine_ops.subpixel_enhance(d, vol_left),
                                           cfg.median_kernel)
    if cfg.do_last_median:
        d = refine_ops.median_blur_disp(d, cfg.median_kernel)
    if cfg.do_rv_whole_image:
        d = refine_ops.region_vote_whole_image(d, arms0, cfg.num_disp, max_arm=cfg.arm_l_out)
    return d


def match_pair(left: torch.Tensor, right: torch.Tensor, cfg: MatchConfig,
               trees=None) -> Dict[str, torch.Tensor]:
    """The pipeline on [H, W, 3] RGB tensors (uint8 or float) on one device.

    Returns 'disparity' (float32 [H, W], negatives are sentinel codes) and
    'disp_left_raw' / 'disp_right_raw' (int32 WTA maps before refinement,
    the left one with DISP_INV where the uniqueness check failed; the right
    one when the LR check is on; the SO maps with SO). Without refinement
    'disparity' is the left WTA map, with ``sub_ipol``'s subpixel offsets.
    The qx NL flow (``nl_post_process``) returns 'disparity' and its
    stage-1 map as 'disp_left_raw'. ``trees``: NL or GFNL aggregation's
    trees (:func:`nl_trees`), None to build them here.
    """
    cfg = as_port_config(cfg).validate()
    check_supported(cfg)
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    if cfg.aggregation in TREE_AGGREGATIONS and trees is None:
        trees = nl_trees(left, right, cfg)
    if _nl_flow(cfg):
        return _match_pair_nl_flow(left, right, cfg, trees)
    vols, arms_pair = compute_volumes(left, right, cfg, trees)
    if cfg.pyramid_levels > 1:
        vols = cross_scale(vols, left, right, cfg)
    dl, dr, vol0 = optimize(vols, left, right, cfg)
    out = {"disp_left_raw": dl}
    if dr is not None:
        out["disp_right_raw"] = dr
    d = refine(dl, dr, vol0, left, arms_pair[0], cfg) if cfg.do_refine else dl
    out["disparity"] = apply_sub_ipol(d, dl, vol0, cfg).to(torch.float32)
    return out


def _match_pair_nl_flow(left, right, cfg: MatchConfig, trees) -> Dict[str, torch.Tensor]:
    """The standalone qx NL flow (the JAX ``match_pair``'s ``nl_post_process``
    branch): the left cost volume, then ``nl_disparity`` on both trees."""
    arms = arms_ops.build_arms(left, cfg) if _needs_arms_for_cost(cfg) else None
    vol = cost_ops.compute_cost_volume(left, right, to_gray(left), to_gray(right), cfg, 0,
                                       arms=arms)
    d, d_raw = nl_ops.nl_disparity(vol, (trees[0], trees[1]), cfg.nl_sigma)
    return {"disparity": d.to(torch.float32), "disp_left_raw": d_raw}


def apply_sub_ipol(d: torch.Tensor, dl_raw: torch.Tensor, vol0: torch.Tensor,
                   cfg: MatchConfig) -> torch.Tensor:
    """SubIpl (wta_Co cpp:2778-2784): the decision-time quadratic subpixel,
    quantised to 1/DISP_SCALE as the reference's fixed-point map. Pixels the
    refinement changed keep their value; pixels still holding the raw WTA
    disparity take the subpixel one. ``do_subpixel`` supersedes it, and a
    vmTop or SO decision is not a WTA one (the identity then)."""
    if not cfg.sub_ipol or cfg.do_subpixel or cfg.do_vmtop or cfg.optimization == "so":
        return d
    sub = wta_ops.subpixel_quadratic(vol0, dl_raw.clamp(min=0))
    subq = torch.round(sub * cfg.disp_scale) / cfg.disp_scale
    keep = (d == dl_raw) & (dl_raw >= 0)
    return torch.where(keep, subq, d.to(torch.float32))


def match_pair_nl_batch(lefts: torch.Tensor, rights: torch.Tensor,
                        cfg: MatchConfig) -> Dict[str, torch.Tensor]:
    """The NL pipeline over B frames ([B, H, W, 3] RGB tensors on one
    device; the JAX ``match_pair_nl_batch``, pipeline.py:371-412): each
    frame's left cost volume (and the left image's arms where the cost or
    the region vote reads them), one forest build of the left images'
    trees on their device (``mst.build_tree_batch``, whatever
    ``nl_tree_host``, as in the JAX package), one forest filter
    (``nl.nl_aggregate_batch``), then each frame's decision and refinement.
    Returns 'disparity', 'disp_left_raw' and, with the cooperative WTA,
    'disp_right_raw', stacked [B, H, W]; each frame's equal to
    :func:`match_pair`'s bit for bit. It refuses what the JAX function
    refuses (another aggregation, the qx flow, ``d_stream_block``) and a
    right volume (``compute_both_volumes`` with the LR check): the JAX
    function builds the left one alone. It refuses the cross-scale pyramid
    too (``pyramid_levels > 1``): the JAX function skips it, so its frames
    would differ from its ``match_pair``'s."""
    cfg = as_port_config(cfg).validate()
    check_supported(cfg)
    if cfg.aggregation != "nl" or _nl_flow(cfg) or cfg.d_stream_block:
        raise NotImplementedError("match_pair_nl_batch supports the single-volume NL preset")
    if _n_views(cfg) == 2:
        raise NotImplementedError("match_pair_nl_batch builds the left volume alone "
                                  "(compute_both_volumes with the LR check)")
    if cfg.pyramid_levels > 1:
        raise NotImplementedError(
            f"match_pair_nl_batch: pyramid_levels={cfg.pyramid_levels} (the JAX "
            "match_pair_nl_batch skips the cross-scale pyramid, so its frames would differ "
            "from its match_pair's)")
    lefts = lefts.to(torch.float32)
    rights = rights.to(torch.float32)
    need_arms = _needs_arms_for_cost(cfg) or (cfg.do_refine and _needs_vote_arms(cfg))
    vdt = VOL_DTYPES[cfg.vol_dtype]
    arms0, vols = [], []
    for left, right in zip(lefts, rights):
        arms = arms_ops.build_arms(left, cfg) if need_arms else None
        arms0.append(arms)
        vols.append(cost_ops.compute_cost_volume(left, right, to_gray(left), to_gray(right),
                                                 cfg, 0, arms=arms).to(vdt))
    forest = mst.build_tree_batch(lefts, cfg.nl_neighbors)
    avols = nl_ops.nl_aggregate_batch(torch.stack(vols), forest, cfg.nl_sigma,
                                      compute_dtype=cfg.nl_filter_dtype)
    del vols
    outs = []
    for vol, left, right, arms in zip(avols, lefts, rights, arms0):
        dl, dr, vol0 = optimize({0: vol}, left, right, cfg)
        out = {"disp_left_raw": dl}
        if dr is not None:
            out["disp_right_raw"] = dr
        d = refine(dl, dr, vol0, left, arms, cfg) if cfg.do_refine else dl
        out["disparity"] = apply_sub_ipol(d, dl, vol0, cfg).to(torch.float32)
        outs.append(out)
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}


class StereoPipeline:
    """The pipeline bound to one configuration and one device.

    It runs on the card (``device="cuda"``) unless the caller asks for
    ``device="cpu"``, and raises when CUDA is not available; inputs (numpy
    arrays or tensors) are moved to the device. With NL or GFNL aggregation
    each call first builds the frame's trees (:func:`nl_trees`: on the
    device, or on the host with ``nl_tree_host``) and keeps that build's
    ms in ``tree_ms``, between two ``torch.cuda.synchronize()`` on the card.
    """

    def __init__(self, cfg: MatchConfig, device="cuda"):
        self.cfg = as_port_config(cfg).validate()
        check_supported(self.cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StereoPipeline: device 'cuda' requested but CUDA "
                               "is not available")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"StereoPipeline: unsupported device {self.device}")
        self.tree_ms = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, img) -> torch.Tensor:
        if isinstance(img, np.ndarray):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(self.device)

    def __call__(self, left, right) -> Dict[str, torch.Tensor]:
        left, right = self._tensor(left), self._tensor(right)
        trees = None
        if self.cfg.aggregation in TREE_AGGREGATIONS:
            self._sync()
            t0 = time.perf_counter()
            trees = nl_trees(left, right, self.cfg)
            self._sync()
            self.tree_ms = (time.perf_counter() - t0) * 1e3
        return match_pair(left, right, self.cfg, trees)
