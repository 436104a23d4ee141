"""mystereomatching_tpu_torch — the stereo pipeline on PyTorch and CUDA.

The port of ``mystereomatching_tpu`` (JAX on a TPU) to PyTorch with
hand-written CUDA kernels for Hopper (``csrc/``). Module names mirror the
JAX package's. This package imports torch and never jax; the JAX package
is the reference it is tested against.

Ported so far: the default preset ``census_grad_cbca_sgm``
(``default_config()``) end to end: censusGrad cost -> cross arms -> CBCA ->
4-path SGM -> WTA -> LR check -> region vote -> proper interpolation ->
3x3 median; ``sgm8_full`` (8-path SGM, uniqueness check, subpixel
enhancement); and ``fullres_occfill`` (classifying LR check, background
fill), in float32 or with bfloat16 volumes and the cooperative WTA. The
three presets also run split into row bands over several processes and
cards (``parallel.run_row_bands``, float32 volumes). The NL presets
``nl_tree_filter``, ``nl_8nr``, ``nl_post`` and ``nl_census_post`` run
with the image's MST built on the device (Borůvka and Euler tours in
torch, the JAX default) or, with ``nl_tree_host``, on the host
(``native/``, a C++ runtime built at first use), and the tree filter on
the device; ``match_pair_nl_batch`` runs a batch of NL frames on one
forest. BASELINE configs 1-2,
``ad_census_wta`` and ``census_cbca_lrc``, and ``census_wta`` run the
census cost family (any ``census_func``) with no aggregation or CBCA.
``census_cbca_vmtop`` (the vmTop decision), ``cbca_double`` (CBCA at two
arm scales, merged), ``ad_grad_gf`` (the guided filter) and
``zncc_bf_wta`` (ZNCC and the box filter) run on the same kernels. The
photo scenes are ``data.make_photo_pair`` (``photo_small`` also committed
rendered, ``data.load_photo_pair``); ``entry.entry()`` gives the flagship
pipeline and an example pair.
"""

from mystereomatching_tpu_torch.config import MatchConfig, default_config
from mystereomatching_tpu_torch.pipeline import StereoPipeline, match_pair, match_pair_nl_batch

__version__ = "0.1.0"

__all__ = [
    "MatchConfig",
    "default_config",
    "StereoPipeline",
    "match_pair",
    "match_pair_nl_batch",
]
