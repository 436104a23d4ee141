"""Canny, CBBI and discontinuity adjustment against the JAX package, on the CPU.

At 48x64 (D=16 volumes), seeded with numpy: ``equalize_hist``,
``gaussian_blur`` (3 and 7 taps), the gray mix and the gradient angle of
``ops/canny.py`` against the jitted JAX expressions; ``canny_edges``;
``label_components``, ``segment_labels`` and ``cbbi`` of ``ops/cbbi.py``;
``cost_at_shifted`` and ``discontinuity_adjust`` (its default edges and
given ones) of ``ops/refine.py``. Then configuration (b) of the card's
item-6 phase (the histogram region vote, CBBI, WM, DA and the last median)
end to end against the jitted JAX ``match_pair`` on the synthetic and the
adversarial scene, with ``NARROW`` windows and the weighted median's
window narrowed to 5x5 (the card runs its 19x19); every map at 0 px.

Tolerances: the labels, edges and maps are integers or booleans, bit-equal
to the JAX functions. The blur and the gray mix are bit-equal to the jitted
JAX functions: the port takes XLA-CPU's chains of fused multiply-adds. The
gradient angle takes ``atan2`` in float64, rounded once, where XLA's
float32 ``atan2`` is within one ULP of it: the test counts the angles that
differ on 200,000 seeded gradient pairs and requires their direction bins
(the only use of the angle) to be equal on all of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu.ops import canny as jax_canny
from mystereomatching_tpu.ops import cbbi as jax_cbbi
from mystereomatching_tpu.ops import refine as jax_refine

from mystereomatching_tpu_torch.data import make_synthetic_pair
from mystereomatching_tpu_torch.ops import canny, cbbi, refine

from test_torch_refine_variants import CONFIG_B, NARROW_B, _maps
from test_torch_vmtop import KEYS, SCENES, check_maps, make_scenes

D, H, W = 16, 48, 64
N_ANGLES = 200_000


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.ascontiguousarray(a))


def _bins(deg):
    """The four NMS direction bins of canny_edges."""
    return np.select([(deg < 22.5) | (deg >= 157.5), (deg >= 22.5) & (deg < 67.5),
                      (deg >= 67.5) & (deg < 112.5)], [0, 1, 2], 3)


@pytest.fixture(scope="module")
def pair():
    return make_synthetic_pair(h=H, w=W, max_disp=D - 1, seed=5)


@pytest.fixture(scope="module")
def disp_map(pair):
    """The pair's ground truth rounded, with holes (-1, -32) and a few
    pixels past 255 (clipped before Canny)."""
    rng = np.random.default_rng(5)
    d = np.clip(np.round(pair.gt), 0, D - 1).astype(np.int32) * 9
    r = rng.random((H, W))
    d = np.where(r < 0.1, -1, np.where(r < 0.2, -32, d)).astype(np.int32)
    d[0, :3] = 300
    return d


def test_equalize_hist_exact(pair):
    img = pair.left[..., 0].astype(np.uint8)
    img[img > 200] = 200                                 # levels missing at the top
    want = np.asarray(jax.jit(jax_canny.equalize_hist)(_j(img)))
    got = canny.equalize_hist(_t(img))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ksize,sigma", [(3, 4.0), (7, 4.0), (3, 1.0)])
def test_gaussian_blur_exact(pair, ksize, sigma):
    """Bit for bit against the jitted JAX blur: its taps as XLA-CPU
    contracts them (fma(k0, x0, k1 x1) and one FMA a later tap; the 3-tap
    W pass's first column as fma(k1, x0, p) + p)."""
    img = pair.left[..., 1].astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jax_canny.gaussian_blur(x, ksize, sigma))(_j(img)))
    np.testing.assert_array_equal(canny.gaussian_blur(_t(img), ksize, sigma).numpy(), want)


def test_gray_mix_exact():
    """0.299 r + 0.587 g + 0.114 b against the jitted JAX mix, bit for bit
    (the two-rounding sum differs at hundreds of the 3,072 pixels)."""
    sm = (np.random.default_rng(0).random((3, H, W)) * 255).astype(np.float32)
    want = np.asarray(jax.jit(lambda s: 0.299 * s[0] + 0.587 * s[1] + 0.114 * s[2])(_j(sm)))
    t = _t(sm)
    np.testing.assert_array_equal(cbbi.gray_mix(t[0], t[1], t[2]).numpy(), want)
    plain = (t[0] * np.float32(0.299) + t[1] * np.float32(0.587)
             + t[2] * np.float32(0.114)).numpy()
    assert (plain != want).sum() > 100


@pytest.mark.parametrize("kind", ["integer", "float"])
def test_gradient_angle_bins_equal_jax(kind):
    """jnp.mod(degrees(arctan2(gy, gx)) + 180, 180), jitted, against the
    port's angle on 200,000 seeded gradient pairs (Sobel sums of integer
    images, and floats): given JAX's float32 atan2 the port's scaling is
    bit-equal (one FMA); its float64 atan2 is within one ULP of XLA's, which
    moves about 7% of the angles by at most two ULPs of the degrees, and
    none across a bin."""
    rng = np.random.default_rng(len(kind))
    if kind == "integer":
        gy, gx = (rng.integers(-1020, 1021, N_ANGLES).astype(np.float32) for _ in range(2))
    else:
        gy, gx = ((rng.standard_normal(N_ANGLES) * 300).astype(np.float32) for _ in range(2))
    deg = jax.jit(lambda a, b: jnp.mod(jnp.degrees(jnp.arctan2(a, b)) + 180.0, 180.0))
    want = np.asarray(deg(_j(gy), _j(gx)))
    got = canny.gradient_degrees(_t(gy), _t(gx)).numpy()
    n_diff = int((got != want).sum())
    assert n_diff < 0.1 * N_ANGLES
    # an ULP of the angle, scaled by 57.3 and rounded again: at most two
    # ULPs of the degrees in [128, 256), 3.05e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=3.1e-5)
    np.testing.assert_array_equal(_bins(got), _bins(want))
    jang = np.asarray(jax.jit(jnp.arctan2)(_j(gy), _j(gx)))
    ang = torch.atan2(_t(gy).double(), _t(gx).double()).float()
    ulps = np.abs(jang.view(np.int32).astype(np.int64) - ang.numpy().view(np.int32))
    assert ulps.max() <= 1
    # given XLA's angle, the scaling and the mod are XLA's, bit for bit
    scaled = canny.fma32(_t(jang), canny._DEG, 180.0)
    mod = torch.fmod(scaled, 180.0)
    np.testing.assert_array_equal(torch.where(mod < 0, mod + 180.0, mod).numpy(), want)


@pytest.mark.parametrize("equalize,blur", [(False, 0.0), (True, 4.0)])
def test_canny_edges_exact(pair, equalize, blur):
    img = pair.left[..., 2].astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jax_canny.canny_edges(
        x, 20.0, 60.0, equalize=equalize, blur_sigma=blur))(_j(img)))
    got = canny.canny_edges(_t(img), 20.0, 60.0, equalize=equalize, blur_sigma=blur)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 0.5


def _serpentine():
    """Masks (c_l, c_r, c_u, c_d) of one component snaking through every
    row, rows joined at alternate ends: the smallest label moves about a
    row a round, so 24 rounds do not reach the last of the 48 rows."""
    c_l = np.ones((H, W), bool)
    c_l[:, 0] = False
    c_r = np.zeros((H, W), bool)
    c_r[:, :-1] = c_l[:, 1:]
    c_u = np.zeros((H, W), bool)
    for v in range(1, H):
        c_u[v, W - 1 if v % 2 else 0] = True
    c_d = np.zeros((H, W), bool)
    c_d[:-1] = c_u[1:]
    return c_l, c_r, c_u, c_d


def test_label_components_exact():
    """Exactly 24 rounds of masked running mins (not to convergence) on a
    snaking component, against the JAX function."""
    c = _serpentine()
    want = np.asarray(jax.jit(jax_cbbi.label_components)(*(_j(m) for m in c)))
    got = cbbi.label_components(*(_t(m) for m in c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1
    more = cbbi.label_components(*(_t(m) for m in c), n_rounds=60).numpy()
    assert (more != want).any()                           # 24 rounds had not converged


@pytest.fixture(scope="module")
def cbbi_case(pair, disp_map):
    """(the holed map, JAX's segment labels of the left image, JAX's CBBI of
    the map), one jit for both."""
    d = np.where(disp_map > 0, disp_map // 9, disp_map).astype(np.int32)
    img = _j(pair.left.astype(np.float32))
    labels, filled = jax.jit(lambda a, b: (jax_cbbi.segment_labels(b),
                                           jax_cbbi.cbbi(a, b, None)))(_j(d), img)
    return d, np.asarray(labels), np.asarray(filled)


def test_segment_labels_exact(pair, cbbi_case):
    want = cbbi_case[1]
    got = cbbi.segment_labels(_t(pair.left.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 1 < len(np.unique(want)) < H * W


def test_cbbi_exact(pair, cbbi_case):
    d, _, want = cbbi_case
    got = cbbi.cbbi(_t(d), _t(pair.left.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((d < 0) & (want >= 0)).any() and (want < 0).any()


def test_cbbi_direction_table_keeps_the_quirk():
    """The direction-Y table's ``-2. - 1`` element (cpp:7617): -3 at index
    11 and an implicit trailing 0, as in the JAX module."""
    assert cbbi.DIR_Y == jax_cbbi._DIR_Y and cbbi.DIR_X == jax_cbbi._DIR_X
    assert cbbi.DIR_Y[11] == -3 and cbbi.DIR_Y[15] == 0


@pytest.mark.parametrize("dv,du", [(0, 0), (-1, 1), (1, 1), (0, -1)])
def test_cost_at_shifted_exact(disp_map, dv, du):
    vol = np.random.default_rng(abs(dv) + 2 * abs(du)).random((D, H, W)).astype(np.float32)
    want = np.asarray(jax_refine.cost_at_shifted(_j(vol), _j(disp_map), dv, du))
    np.testing.assert_array_equal(refine.cost_at_shifted(_t(vol), _t(disp_map), dv, du).numpy(),
                                  want)


@pytest.mark.parametrize("edges", ["canny", "given"])
def test_discontinuity_adjust_exact(disp_map, edges):
    """DA with its default edges (the equalised, blurred Canny of the
    clipped map) and with given ones, against the jitted JAX function;
    negative costs at some entries exercise the asymmetric sentinels (the
    d1 test ``>= 0``, the d2 test ``!= -1``)."""
    rng = np.random.default_rng(9)
    vol = (rng.random((D, H, W)) * 4 - 0.5).astype(np.float32)
    vol[:, ::5] = -1.0
    d = np.where(disp_map > 0, disp_map % D, disp_map).astype(np.int32)
    e = rng.random((H, W)) < 0.4 if edges == "given" else None
    jfn = jax.jit(lambda a, b, c: jax_refine.discontinuity_adjust(a, b, c)) if e is not None \
        else jax.jit(lambda a, b: jax_refine.discontinuity_adjust(a, b))
    want = np.asarray(jfn(_j(d), _j(vol), _j(e)) if e is not None else jfn(_j(d), _j(vol)))
    got = refine.discontinuity_adjust(_t(d), _t(vol), None if e is None else _t(e))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != d).any()
    np.testing.assert_array_equal(want[0], d[0])         # border pixels untouched
    np.testing.assert_array_equal(want[:, -1], d[:, -1])


@pytest.fixture(scope="module")
def maps_b():
    return _maps(make_scenes(), {**CONFIG_B, **NARROW_B})


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("key", KEYS)
def test_config_b_matches_jax(maps_b, scene, key):
    check_maps(maps_b, scene, key)
