"""Named pipeline presets, the same registry as the JAX package's.

Every preset gives a ``MatchConfig`` equal field for field to the JAX
package's (``mystereomatching_tpu/models/presets.py``). The presets are
data: :class:`~mystereomatching_tpu_torch.pipeline.StereoPipeline` raises
``NotImplementedError`` for the stages this package does not run yet.
"""

from __future__ import annotations

from typing import Callable, Dict

from mystereomatching_tpu_torch.config import MatchConfig, default_config, fast_config

MODEL_REGISTRY: Dict[str, Callable[..., MatchConfig]] = {}


def register(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn
    return deco


def _preset(max_disp: int, base: dict, kw: dict) -> MatchConfig:
    base.update(kw)
    return MatchConfig(max_disp=max_disp, **base).validate()


@register("census_grad_cbca_sgm")
def _default(max_disp: int = 59, **kw) -> MatchConfig:
    """The reference's measured default (BASELINE.md)."""
    return default_config(max_disp=max_disp, **kw)


@register("ad_census_wta")
def _baseline1(max_disp: int = 15, **kw) -> MatchConfig:
    """BASELINE.json config 1: AD+census cost + WTA (Tsukuba D=16)."""
    return _preset(max_disp, dict(
        cost="ad_census", aggregation="none", optimization="wta",
        do_refine=False, do_lr_consis=False, compute_both_volumes=False), kw)


@register("census_wta")
def _census_wta(max_disp: int = 15, **kw) -> MatchConfig:
    return fast_config(max_disp=max_disp, **kw)


@register("census_cbca_lrc")
def _baseline2(max_disp: int = 63, **kw) -> MatchConfig:
    """BASELINE.json config 2: census + CBCA + LR check (Teddy/Cones)."""
    return _preset(max_disp, dict(
        cost="census", aggregation="cbca", optimization="wta",
        do_refine=True, do_lr_consis=True, do_region_vote=False,
        do_proper_ipol=False, do_last_median=False), kw)


@register("sgm8_full")
def _baseline3(max_disp: int = 59, **kw) -> MatchConfig:
    """BASELINE.json config 3: 8-path SGM + uniqueness + subpixel + median."""
    return _preset(max_disp, dict(
        cost="census_grad", aggregation="cbca", optimization="sgm",
        sgm_scan_num=8, uniq_check=True, sub_ipol=True, do_refine=True,
        do_subpixel=True), kw)


@register("nl_tree_filter")
def _baseline4(max_disp: int = 59, **kw) -> MatchConfig:
    """BASELINE.json config 4: NL MST tree-filter aggregation pipeline."""
    return _preset(max_disp, dict(
        cost="ad_grad", aggregation="nl", optimization="wta",
        do_refine=True, do_lr_consis=True, compute_both_volumes=False), kw)


@register("nl_8nr")
def _nl_8nr(max_disp: int = 59, **kw) -> MatchConfig:
    """nl_tree_filter with the 8-neighbour MST edge mode."""
    return _preset(max_disp, dict(
        cost="ad_grad", aggregation="nl", optimization="wta",
        do_refine=True, do_lr_consis=True, compute_both_volumes=False,
        nl_neighbors=8), kw)


@register("nl_post")
def _nl_post(max_disp: int = 59, **kw) -> MatchConfig:
    """The standalone NL pipeline with non-local post-processing."""
    return _preset(max_disp, dict(
        cost="qx_ad_grad", aggregation="nl", optimization="wta",
        nl_post_process=True, compute_both_volumes=False, do_refine=False), kw)


@register("nl_census_post")
def _nl_census_post(max_disp: int = 59, **kw) -> MatchConfig:
    """The same flow with the NL path's 80-bit 9x9 census cost."""
    return _preset(max_disp, dict(
        cost="qx_census", aggregation="nl", optimization="wta",
        nl_post_process=True, compute_both_volumes=False, do_refine=False), kw)


@register("fullres_occfill")
def _baseline5(max_disp: int = 255, **kw) -> MatchConfig:
    """BASELINE.json config 5: full-res D<=256 with occlusion fill."""
    return _preset(max_disp, dict(
        cost="census_grad", aggregation="cbca", optimization="sgm",
        do_refine=True, do_lr_consis=True, lrc_classify=True,
        do_region_vote=True, do_proper_ipol=True, do_bg_ipol=True,
        do_last_median=True), kw)


@register("cbca_double")
def _cbca_double(max_disp: int = 59, **kw) -> MatchConfig:
    """Double-window CBCA merged by the smoothed max-arm mask."""
    return _preset(max_disp, dict(
        cost="census_grad", aggregation="cbca", optimization="sgm",
        cbca_double_win=True, cbca_combine=4, do_refine=True), kw)


@register("bt_so")
def _bt_so(max_disp: int = 59, **kw) -> MatchConfig:
    return _preset(max_disp, dict(
        cost="bt", aggregation="cbca", optimization="so", do_refine=True), kw)


@register("ad_grad_gf")
def _adgrad_gf(max_disp: int = 59, **kw) -> MatchConfig:
    """AD+gradient cost with guided-filter aggregation."""
    return _preset(max_disp, dict(
        cost="ad_grad", aggregation="gf", optimization="wta",
        do_refine=True), kw)


@register("census_fif_sgm")
def _fif(max_disp: int = 59, **kw) -> MatchConfig:
    return _preset(max_disp, dict(
        cost="census_grad", aggregation="fif", optimization="sgm"), kw)


@register("zncc_bf_wta")
def _zncc(max_disp: int = 59, **kw) -> MatchConfig:
    return _preset(max_disp, dict(
        cost="zncc", aggregation="bf", optimization="wta", do_refine=False,
        do_lr_consis=False, compute_both_volumes=False), kw)


@register("aws_wta")
def _aws(max_disp: int = 59, **kw) -> MatchConfig:
    return _preset(max_disp, dict(
        cost="trunc_ad", aggregation="aws", optimization="wta",
        do_refine=True), kw)


@register("gfnl_wta")
def _gfnl(max_disp: int = 59, **kw) -> MatchConfig:
    return _preset(max_disp, dict(
        cost="ad_grad", aggregation="gfnl", optimization="wta",
        do_refine=True), kw)


@register("census_cbca_vmtop")
def _vmtop(max_disp: int = 59, **kw) -> MatchConfig:
    """Top-K candidate voting decision."""
    return _preset(max_disp, dict(
        cost="census_grad", aggregation="cbca", optimization="sgm",
        do_vmtop=True, do_refine=True), kw)


def list_models():
    return sorted(MODEL_REGISTRY)


def get_model(name: str, max_disp: int = 59, **kw) -> MatchConfig:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {list_models()}")
    return MODEL_REGISTRY[name](max_disp=max_disp, **kw)


def build(name: str, max_disp: int = 59, device="cuda", **kw):
    """A pipeline on ``device`` for a named preset."""
    from mystereomatching_tpu_torch.pipeline import StereoPipeline

    return StereoPipeline(get_model(name, max_disp, **kw), device=device)
