"""GFNL against the JAX package, on the CPU.

``gfnl_aggregate`` equals the jitted JAX ``gfnl_aggregate`` bit for bit
when both are given the same GF and NL volumes (each package's guided
filter and NL aggregation replaced by functions returning them): the blend
by the 3x3 variance of the gray image, whose ``var < 400`` threshold one
rounding can flip, rounds as XLA-CPU computes it (the box sums times the
float32 reciprocal of 9, box(g^2) / 9 - mean^2 one fused multiply-add).
The gray image is drawn to put many variances near 400; the pixels within
1e-3 of it are counted, and the test needs some. Then the preset
``gfnl_wta`` end to end at 48x64, D=16, on a synthetic and an adversarial
scene against the jitted JAX ``match_pair`` given the same host trees
(``nl.build_tree_host``, one jit), with ``tests/test_torch_vmtop.py``'s
narrowed windows: 0 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu import pipeline as jax_pipeline
from mystereomatching_tpu.models import get_model as jax_get_model
from mystereomatching_tpu.ops import guided as jax_guided
from mystereomatching_tpu.ops import nl as jax_nl

from mystereomatching_tpu_torch.config import as_port_config
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.ops import guided, nl
from mystereomatching_tpu_torch.pipeline import (StereoPipeline, check_supported,
                                                 kernels_launched)
from test_torch_vmtop import KEYS, NARROW, SCENES, check_maps, make_scenes

D = 16


@pytest.fixture(scope="module")
def blend_inputs():
    rng = np.random.default_rng(0)
    h, w = 120, 160
    gray = np.clip(128 + rng.normal(0, 21, (h, w)), 0, 255).round().astype(np.float32)
    gray[:40] = np.clip(128 + rng.normal(0, 3, (40, w)), 0, 255).round()   # flat: pure NL
    # 3x3 windows of variance exactly 400 (9 sum g^2 - (sum g)^2 = 32400),
    # planted 4 px apart at the centre of the flat rows
    cand = 128 + rng.integers(-40, 41, (200_000, 9))
    hits = cand[9 * (cand ** 2).sum(1) - cand.sum(1) ** 2 == 32400]
    for k, (y, x) in enumerate((y, x) for y in range(2, 38, 4) for x in range(2, w - 2, 4)):
        gray[y - 1:y + 2, x - 1:x + 2] = hits[k % len(hits)].reshape(3, 3)
    gf_vol, nl_vol = (rng.uniform(0, 2, (4, h, w)).astype(np.float32) for _ in range(2))
    image = np.repeat(gray[..., None], 3, -1)
    return gray, image, gf_vol, nl_vol


def _exact_variance(gray):
    g = np.pad(gray.astype(np.float64), 1)
    win = np.stack([g[i:i + gray.shape[0], j:j + gray.shape[1]]
                    for i in range(3) for j in range(3)])
    return (win ** 2).sum(0) / 9 - (win.sum(0) / 9) ** 2


def test_gfnl_aggregate_exact_given_the_same_volumes(blend_inputs, monkeypatch):
    gray, image, gf_vol, nl_vol = blend_inputs
    near = int((np.abs(_exact_variance(gray) - 400.0) < 1e-3).sum())
    assert near > 0, "no variance within 1e-3 of 400: the threshold is not exercised"
    jcfg = jax_get_model("gfnl_wta", max_disp=3)
    monkeypatch.setattr(jax_guided, "guided_filter_volume", lambda *a: jnp.asarray(gf_vol))
    monkeypatch.setattr(jax_nl, "nl_aggregate", lambda *a, **k: jnp.asarray(nl_vol))
    want = np.asarray(jax.jit(lambda v, im, g: jax_nl.gfnl_aggregate(v, im, g, jcfg))(
        gf_vol, image, gray))
    monkeypatch.setattr(guided, "guided_filter_volume", lambda *a: torch.from_numpy(gf_vol))
    monkeypatch.setattr(nl, "nl_aggregate", lambda *a: torch.from_numpy(nl_vol))
    got = nl.gfnl_aggregate(torch.from_numpy(gf_vol), torch.from_numpy(image),
                            torch.from_numpy(gray), None, as_port_config(jcfg)).numpy()
    np.testing.assert_array_equal(got, want)
    took_nl = (got == nl_vol).all(0)
    assert took_nl.any() and not took_nl.all()


def test_gfnl_wta_frame_kernels():
    cfg = get_model("gfnl_wta")
    check_supported(cfg)
    assert kernels_launched(cfg) == ["arms_grow", "wta", "region_vote", "pi_scan"]


@pytest.fixture(scope="module")
def preset_maps():
    """{scene: (JAX maps, port maps)}: one jit of the JAX match_pair on
    both views' host trees, the port's StereoPipeline building the same."""
    jcfg = jax_get_model("gfnl_wta", max_disp=D - 1, **NARROW)
    fn = jax.jit(lambda l, r, t: jax_pipeline.match_pair(l, r, jcfg, host_trees=t))
    pipe = StereoPipeline(as_port_config(jcfg), device="cpu")
    maps = {}
    for scene, pair in make_scenes().items():
        trees = {lor: (t.parent, t.weight) for lor, t in enumerate(
            jax_nl.build_tree_host(img) for img in (pair.left, pair.right))}
        ref = fn(jnp.asarray(pair.left), jnp.asarray(pair.right), trees)
        maps[scene] = ({k: np.asarray(v) for k, v in ref.items()},
                       {k: v.numpy() for k, v in pipe(pair.left, pair.right).items()})
    assert pipe.tree_ms > 0
    return maps


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("key", KEYS)
def test_preset_matches_jax(preset_maps, scene, key):
    check_maps(preset_maps, scene, key)
