"""Declarative configuration for the stereo pipeline.

This package's own copy of ``mystereomatching_tpu/config.py`` (standard
library only): the same ``MatchConfig`` fields, defaults and validation,
``default_config`` and ``fast_config``, held equal to the original by
``tests/test_torch_port.py``. The two packages therefore hold two distinct
``MatchConfig`` classes with the same fields; :func:`as_port_config`
converts an instance of the other one.

Defaults mirror the reference's measured configuration
(main_.cpp:15-17 + stereoMatching.h:204-350): censusGrad cost
(lam_cen=13, lam_g=1) + CBCA (2 iterations, arms 17/34, thresholds 20/6)
+ 4-path SGM (P1=1, P2=3, adaptive /4) + LRC + region-vote x2 +
proper-interpolation x2 + 3x3 median blur.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Cost functions (reference dispatcher costCalculate, stereoMatching.cpp:945-1021)
COST_METHODS = (
    "ad",          # absolute color difference           (cpp:2468 gen_ad_sd_vm AOS=0)
    "sd",          # squared color difference            (cpp:2468 gen_ad_sd_vm AOS=1)
    "trunc_ad",    # truncated AD, DEFAULT=60            (cpp:2511 gen_truncAD_vm)
    "bt",          # Birchfield-Tomasi                   (cpp:90-268)
    "grad",        # x/y gradient cost, adaptive fuse    (cpp:271-534, 603-786)
    "census",      # census bitstring Hamming            (h:566-1208, cpp:807-892)
    "zncc",        # zero-mean NCC                       (cpp:2384-2464)
    "ssd",         # box-summed SD                       (cpp:2589-2638)
    "census_grad", # DEFAULT: exp-fused census+grad      (cpp:25-48)
    "ad_grad",     # fixed-weight AD+grad 0.11/0.89      (cpp:50-70)
    "ad_census",   # exp-fused AD+census                 (cpp:5250-5277)
    "ad_census_grad",   # 3-way exp fusion               (cpp:917-943)
    "ad_census_zncc",   # AD+census+ZNCC                 (cpp:5296-5307, 3844-3894)
    "qx_ad_grad",  # NL standalone color+gradient cost   (NL/qx_nonlocal_cost_aggregation.cpp:190-218)
    "qx_census",   # NL 80-bit 9x9 wraparound census     (NL/qx_nonlocal_cost_aggregation.cpp:110-189)
    "census_from2",  # two-window census blend           (gen_cenVM_XOR_From2Code(_tem), h:983-1142)
)

AGG_METHODS = (
    "none",
    "cbca",   # cross-based cost aggregation (default)   (cpp:4333-4402, 5585-5690)
    "bf",     # box filter                               (cpp:1023-1043)
    "gf",     # guided filter                            (cpp:4404-4419, 4892-5248)
    "fif",    # full-image recursive filter              (cpp:4541-4890)
    "nl",     # non-local MST tree filter                (cpp:4892-4917, NL/)
    "gfnl",   # variance-blended GF+NL                   (cpp:4421-4490)
    "aws",    # adaptive support weight                  (cpp:5692-5801)
    "jbf",    # per-slice joint bilateral filter         (JBF_STANDARD path, cpp:5738-5767)
)

OPT_METHODS = (
    "wta",    # plain argmin                             (cpp:3928-3967)
    "sgm",    # semi-global matching (default)           (cpp:1983-2056, 6204-6269)
    "so",     # scanline optimization w/ backtracking    (cpp:6272-6416)
)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Full pipeline configuration. Frozen and hashable."""

    # --- geometry -----------------------------------------------------------
    max_disp: int = 59                 # main_.cpp:39 (teddy/cones)
    # num_disparities = max_disp + 1   (stereoMatching.h:209)

    # --- stage selection (main_.cpp:15-17) ----------------------------------
    cost: str = "census_grad"
    aggregation: str = "cbca"
    optimization: str = "sgm"

    # --- refinement switches (stereoMatching.h:57-83) -----------------------
    do_refine: bool = True
    do_lr_consis: bool = True          # Do_LRConsis
    do_pkr: bool = False               # Do_calPKR
    do_region_vote: bool = True        # Do_regionVote
    do_proper_ipol: bool = True        # Do_properIpol
    do_bg_ipol: bool = False           # Do_bgIpol
    do_wm: bool = False                # Do_WM
    do_da: bool = False                # Do_discontinuityAdjust
    do_subpixel: bool = False          # Do_subpixelEnhancement
    do_last_median: bool = True        # Do_lastMedianBlur
    do_cbbi: bool = False              # Do_cbbi
    uniq_check: bool = False           # UniqCk (h:57)
    sub_ipol: bool = False             # SubIpl (h:58)

    # --- cost parameters ----------------------------------------------------
    lam_cen: float = 13.0              # lamCen (main_.cpp:62)
    lam_g: float = 1.0                 # lamG (main_.cpp:61)
    grad_trunc: float = 500.0          # grad() Trunc in censusGrad (cpp:35)
    grad_use_2dir: bool = True         # grad_use2direc (h:247)
    grad_fuse_adaptive: bool = True    # gradFuse_adpWgt (h:246)
    ad_trunc: float = 7.0              # adGrad AD trunc (cpp:61)
    is_ad_norm: bool = False           # is_adNorm (h:249)
    is_census_norm: bool = False       # is_censusNorm (h:248)
    is_grad_norm: bool = False         # is_gradNorm (h:250)
    sd_ad_channels: int = 3            # SD_AD_channel (h:228)
    census_rv: int = 3                 # census window half-height W_V (cpp:813 census_W={3,4})
    census_ru: int = 4                 # census window half-width W_U
    census_func: int = 3               # censusFunc: 3 = classic + 8 surround pairs (h:244)
    census_trunc_ratio: float = 1.0    # truncRatio (cpp:36 censusCal arg)
    census_rv2: int = 5                # second code window for census_from2
    census_ru2: int = 5                #   (the {5,5} census_W[1], cpp:817)
    census_from2_blend: str = "grad"   # "grad": b*c0+a*c1, a=1-exp(-0.1/(g+1))
    #   (the _tem variant's active blend, h:1115-1116); "first": cost[0]
    #   only (the non-tem variant's active line, h:1073)
    bt_trunc: float = 20.0             # BT truncation (cpp:90-268)
    zncc_win_rv: int = 3               # ZNCC window half sizes (W_V/W_U, h:205-206)
    zncc_win_ru: int = 4
    ssd_win_rv: int = 3
    ssd_win_ru: int = 4

    # --- CBCA parameters (h:263-292) ----------------------------------------
    cbca_cross_l: int = 17             # cbca_crossL[0]
    cbca_cross_l_out: int = 34         # cbca_crossL_out[0]
    cbca_c_thresh: int = 20            # cbca_cTresh[0]
    cbca_c_thresh_out: int = 6         # cbca_cTresh_out[0]
    cbca_min_arm: int = 1              # cbca_minArmL
    cbca_iterations: int = 2           # cbca_iterationNum
    cbca_intersect: bool = True        # cbca_intersect
    cbca_arm_mode: str = "two_level"   # calArms overload family
                                       # (cpp:5354-5472): "two_level"
                                       # (default), "multilevel" (vector
                                       # L/thresh lists, cpp:3152-3253),
                                       # "adaptive" (calHorVerDis2
                                       # decaying threshold, cpp:3255-3349)
    cbca_cross_ls: tuple = (17, 23, 34)   # cbca_crossL (h:263-265)
    cbca_c_threshes: tuple = (20, 30, 30)  # cbca_cTresh list
    cbca_ml_neigh_thresh: int = 20     # vector overload's hard-coded
                                       # neighbor threshold (cpp:3209)
    cbca_double_win: bool = False      # cbca_double_win (h:144, h:275):
                                       # run CBCA at two arm scales and
                                       # merge (CBCA() cpp:4337-4357)
    cbca_combine: int = 4              # which combine2Vm variant merges
                                       # the two windows: 1 PKR mask
                                       # (cpp:4142), 2 arm-limit (cpp:4170),
                                       # 3 min-cost (cpp:4217), 4 smoothed
                                       # max-arm mask (cpp:4273, the
                                       # reference's active choice cpp:4354)
    cbca_cross_l_outs: tuple = (34, 23, 34)   # cbca_crossL_out (h:266-268)
    cbca_c_thresh_outs: tuple = (6, 0, 0)     # cbca_cTresh_out (h:272-274)

    # --- box / guided filter ------------------------------------------------
    bf_radius: int = 6                 # BF 12x12 boxFilter (cpp:1030) -> radius 6
    gf_radius: int = 9                 # gf_r[0] (h:295)
    gf_eps: float = 1e-4               # gf_eps[0]
    gf_color_guide: bool = True        # gf_channel_isColor (h:299)

    # --- FIF ----------------------------------------------------------------
    fif_sigma: float = 0.08            # edge-weight sigma exp(-||dI||^2/0.08^2) (cpp:4541)
    fif_improve: bool = True           # FIF_Improve is the live variant (cpp:1012)
    fif_pn: float = 2.0                # SGM-like +-1 transition penalty (cpp:4707)

    # --- NL tree filter -----------------------------------------------------
    nl_sigma: float = 0.1              # NLCCA sigma (NL/NLCCA.cpp:33)
    nl_filter_dtype: str = "float32"   # "bfloat16": filter the [N,D]
                                       # columns in bf16 (peel phases only;
                                       # tree build + core doubling stay
                                       # exact) — documented-approximate
                                       # NL fast mode, ~2x peel bandwidth
    nl_neighbors: int = 4              # MST edge mode: 4 or 8 neighbors
                                       # (qx_mst_kruskals_image.h:11-12,37)
    nl_tree_host: bool = False         # hybrid: host-C++ Kruskal MST build
    nl_post_process: bool = False      # qx non-local post-processing flow
    #   (disparity(..., true), NL/qx_nonlocal_cost_aggregation.cpp:72-109):
    #   L/R WTA of the same tree-filtered volume, exact-agreement occlusion
    #   detect, |d-d_hat| rebuild, sigma/2 re-filter, 5x5 ctmf medians.
    #   Replaces the optimize/refine stages when aggregation == "nl".
                                       # (pure_callback; exact reference tie
                                       # order), device tree filter

    # --- AWS ----------------------------------------------------------------
    aws_win: int = 17                  # 35x35 window -> radius 17 (h:1533)
    aws_gamma: float = 5.0             # exp(-dLab/5) (h:1533-1548)
    jbf_radius: int = 9                # JBF_STANDARD window radius
    jbf_sigma_c: float = 25.0          # joint bilateral color sigma
    jbf_sigma_s: float = 9.0           # joint bilateral spatial sigma

    # --- SGM (h:236-241) ----------------------------------------------------
    # P1/P2 default to None = "resolve per aggregation" exactly as the
    # reference constructor does (cpp:2088-2108): CBCA/GF -> 1.0/3.0,
    # AWS -> 0.5/1.0 (substring match, so GFNL hits the GF rule), anything
    # else 1.0/3.0 (the effective kernel values). Reference quirk: those
    # constructor stores are DEAD in the reference binary — updateCost
    # (h:2233-2235) hard-codes P1=1.0/P2=3.0 locally — so a user wanting
    # binary-exact AWS+SGM passes sgm_p1=1.0, sgm_p2=3.0 explicitly.
    sgm_p1: float = None               # None -> sgm_p1_eff resolves it
    sgm_p2: float = None
    sgm_scan_num: int = 4              # numOfDirec (cpp:6214)
    sgm_cor_dif_thres: int = 15        # sgm_corDifThres
    sgm_redu_coeff: float = 4.0        # sgm_reduCoeffi1

    # --- SO (cpp:6272) ------------------------------------------------------
    so_pn2: float = 1.2
    so_pn3: float = 3.6
    so_dif_thres: int = 15

    # --- WTA ----------------------------------------------------------------
    choose_small: bool = True          # ChooseSmall (h:208): argmin vs argmax
    uniqueness_ratio: float = 0.95     # uniquenessRatio_2small (h:210)

    # --- vmTop candidate voting (h:322-330) ---------------------------------
    do_vmtop: bool = False             # Do_vmTop
    vmtop_num: int = 2                 # vmTop_Num = M (main_.cpp:57)
    vmtop_thres: float = 1.09          # vmTop_thres = lamc*0.01 (main_.cpp:58)
    vmtop_method: int = 0              # vmTop_method
    vmtop_ts: int = 10                 # ts: pair-consistency threshold (main_.cpp:59)

    # --- refinement parameters ----------------------------------------------
    lr_max_diff: int = 0               # LRmaxDiff (h:212)
    lrc_classify: bool = False         # classifying LRC (OCC vs MIS) (cpp:2284)
    region_vote_iters: int = 2         # region_vote_nums (h:302)
    rv_s_thres: int = 20               # regVote_SThres
    rv_h_ratio: float = 0.4            # regVote_hratioThres
    rv_int_ratio_quirk: bool = True    # reproduce regionVote_my's C++ integer
                                       # division `hist/validNum >= ratio`
                                       # (cpp:7266) which makes the ratio test
                                       # "all valid pixels agree"
    reg_vote_type: int = 0             # regVote_type (h:309): 0 HV vote,
                                       # 1 tilted (cal_histogram_for_Tile),
                                       # 2 compareArmL per-pixel gate
                                       # (regionVoteCore cpp:6925-6947)
    rv_use_combine_bg: bool = False    # run RV_combine_BG (cpp:7146-7216,
                                       # the cpp:1408 commented alternative)
                                       # instead of regionVote_my in the RV
                                       # iterations
    interpolate_type: int = 0          # interpolateType (h:316): the
                                       # RV_combine_BG policy (0 RV, 1 BG,
                                       # 2 OCC->BG/MIS->RV, 3 combined min)
    bg_ipl_depth: int = 1000           # bgIplDepth (h:311)
    bg_ip_dir: int = 2                 # bgIpDir (h:312): 2 = horizontal
                                       # core; 4 = color-checked 4-direction
                                       # core (backgroundInterpolateCore_)
    do_rv_whole_image: bool = False    # regionVoteForWholeDispImg
                                       # (cpp:6949-6962; commented at
                                       # cpp:1500) after the final median
    do_fill_surrounding: bool = False  # fillSurronding (cpp:2214-2260):
                                       # invalidate the census-window border
                                       # band before LRC (SSD own-WTA flow,
                                       # h:490)
    proper_ipol_iters: int = 2         # refine() runs PI region_vote_nums times (cpp:1441)
    pi_search_depth: int = 20          # properIpol searchDepth (cpp:7401)
    pkr_thresh: float = 0.1            # calPKR (cpp:4087)
    wm_win: int = 9                    # WM 19x19 -> radius 9 (cpp:7340)
    wm_sigma_c: float = 25.0
    wm_sigma_s: float = 9.0
    median_kernel: int = 3             # medianKernelSize (h:213)

    # --- sentinels (h:215-219): negative codes in int16 disparity maps ------
    disp_inv: int = -16                # DISP_INV
    disp_occ: int = -32                # DISP_OCC
    disp_mis: int = -48                # DISP_MIS
    disp_pkr: int = -64                # DISP_PKR
    disp_scale: int = 16               # DISP_SCALE

    # --- evaluation (h:225) -------------------------------------------------
    error_threshold: float = 1.0       # errorThreshold (bad-1.0)

    # --- cross-scale pyramid (main_.cpp:131-158, SolveAll cpp:2142) ---------
    pyramid_levels: int = 1            # PY_LEV (1 = no cross-scale)
    reg_lambda: float = 0.3            # REG_LAMBDA (main_.cpp:158)
    bg_ipol_kitti: bool = False        # use iterpolateBackground (cpp:5864)
                                       # instead of the two-sided min fill
    ipol_threshold: int = 0            # ipolThrehold (h:226)

    # --- numerics / TPU -----------------------------------------------------
    vol_dtype: str = "float32"         # cost volume dtype
    compute_both_volumes: bool = True  # build left+right volumes (LRC needs both)
    d_stream_block: int = 0            # >0: build cost+CBCA in disparity
                                       # blocks of this size (bounds HBM for
                                       # full-res D=256; must divide num_disp)

    @property
    def num_disp(self) -> int:
        return self.max_disp + 1

    def replace(self, **kw) -> "MatchConfig":
        return dataclasses.replace(self, **kw)

    def show_params(self) -> str:
        """Human-readable dump of every parameter, grouped as set vs default
        (the reference's showParams, stereoMatching.cpp:7928-7961)."""
        lines = [f"MatchConfig ({self.cost} / {self.aggregation} / "
                 f"{self.optimization}, D={self.num_disp})"]
        defaults = MatchConfig()
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            mark = "" if v == getattr(defaults, f.name) else "   *"
            lines.append(f"  {f.name:24s} = {v!r}{mark}")
        return "\n".join(lines)

    @property
    def sgm_p1_eff(self) -> float:
        """Effective SGM P1: explicit value, else the reference
        constructor's per-aggregation resolution (cpp:2088-2108)."""
        if self.sgm_p1 is not None:
            return self.sgm_p1
        return 0.5 if "aws" in self.aggregation else 1.0

    @property
    def sgm_p2_eff(self) -> float:
        if self.sgm_p2 is not None:
            return self.sgm_p2
        return 1.0 if "aws" in self.aggregation else 3.0

    def window1(self) -> "MatchConfig":
        """The large-window arm parameters for double-window CBCA: the
        reference's first calArms call in CBCA() (cpp:4341) with index-1
        params (crossL[1]=23, crossL_out[1]=23, cTresh[1]=30,
        cTresh_out[1]=0)."""
        return self.replace(
            cbca_cross_l=int(self.cbca_cross_ls[1]),
            cbca_cross_l_out=int(self.cbca_cross_l_outs[1]),
            cbca_c_thresh=int(self.cbca_c_threshes[1]),
            cbca_c_thresh_out=int(self.cbca_c_thresh_outs[1]))

    @property
    def arm_l_out(self) -> int:
        """Longest possible arm under the active cbca_arm_mode — the tap
        bound every arm-bounded kernel must honor."""
        if self.cbca_arm_mode == "multilevel":
            return int(self.cbca_cross_ls[-1])
        return self.cbca_cross_l_out

    def validate(self) -> "MatchConfig":
        if self.cost not in COST_METHODS:
            raise ValueError(f"unknown cost {self.cost!r}; one of {COST_METHODS}")
        if self.aggregation not in AGG_METHODS:
            raise ValueError(f"unknown aggregation {self.aggregation!r}; one of {AGG_METHODS}")
        if self.optimization not in OPT_METHODS:
            raise ValueError(f"unknown optimization {self.optimization!r}; one of {OPT_METHODS}")
        if self.max_disp < 1:
            raise ValueError("max_disp must be >= 1")
        if self.d_stream_block and self.num_disp % self.d_stream_block:
            raise ValueError(
                f"d_stream_block={self.d_stream_block} must divide "
                f"num_disp={self.num_disp}")
        if max(self.cbca_cross_l, self.cbca_cross_l_out,
               self.arm_l_out) > 127:
            # arm intersection narrows to int8 (ops/arms.py); longer arms
            # would silently clamp and diverge from the reference (ADVICE r1)
            raise ValueError(
                f"cross arm lengths (l={self.cbca_cross_l}, "
                f"l_out={self.cbca_cross_l_out}, mode max "
                f"{self.arm_l_out}) must be <= 127 (int8 arms)")
        if self.cbca_arm_mode not in ("two_level", "multilevel", "adaptive"):
            raise ValueError(
                f"unknown cbca_arm_mode {self.cbca_arm_mode!r}")
        if self.cbca_combine not in (1, 2, 3, 4):
            raise ValueError(
                f"cbca_combine must be 1..4 (combine2Vm variants), "
                f"got {self.cbca_combine}")
        if self.nl_neighbors not in (4, 8):
            raise ValueError(
                f"nl_neighbors must be 4 or 8 "
                f"(qx_mst_kruskals_image.h:11-12), got {self.nl_neighbors}")
        return self


def default_config(max_disp: int = 59, **kw) -> MatchConfig:
    """The reference's measured default configuration (BASELINE.md)."""
    return MatchConfig(max_disp=max_disp, **kw).validate()


def fast_config(max_disp: int = 15, **kw) -> MatchConfig:
    """BASELINE.json config 1: AD+census cost + plain WTA, no aggregation."""
    base = dict(
        cost="census",
        aggregation="none",
        optimization="wta",
        do_refine=False,
        do_lr_consis=False,
        compute_both_volumes=False,
    )
    base.update(kw)
    return MatchConfig(max_disp=max_disp, **base).validate()


def as_port_config(cfg) -> MatchConfig:
    """This package's ``MatchConfig`` with the fields of ``cfg``, which may
    be an instance of the JAX package's class."""
    if isinstance(cfg, MatchConfig):
        return cfg
    return MatchConfig(**dataclasses.asdict(cfg))
