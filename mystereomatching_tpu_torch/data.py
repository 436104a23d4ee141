"""Stereo pairs: the synthetic stereo-pair generators (the test oracle).

This package's own copy of the numpy code in
``mystereomatching_tpu/data.py``: ``StereoPair``, ``rgb_to_gray``,
``make_synthetic_pair``, ``make_adversarial_pair`` and
``make_photo_pair`` with their helpers, so both packages make the same
pairs from the same seed (``tests/test_torch_port.py`` and
``tests/test_torch_photo.py`` hold them equal). The photo scenes read
matplotlib's and pygame's bundled photographs; where one is missing,
:func:`_load_photos` raises instead of skipping it, since a skipped source
changes the scene. ``photo_small`` is also kept rendered in
``photo_small.npz`` beside this module (:func:`load_photo_pair`; written by
``python3 -m mystereomatching_tpu_torch.data``), for machines without those
packages. The Middlebury directory loader is not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class StereoPair:
    """One stereo problem instance (host-side numpy)."""

    name: str
    left: np.ndarray          # [H,W,3] uint8
    right: np.ndarray         # [H,W,3] uint8
    gt: Optional[np.ndarray]  # [H,W] float32 disparity (0 = unknown) or None
    max_disp: int
    masks: Optional[Dict[str, np.ndarray]] = None  # bool [H,W] nonocc/all/disc

    @property
    def gray(self) -> Tuple[np.ndarray, np.ndarray]:
        return rgb_to_gray(self.left), rgb_to_gray(self.right)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """OpenCV-compatible RGB->gray (BGR coeffs applied to RGB order as cvtColor
    COLOR_BGR2GRAY does for its input; we store RGB so use the RGB weights)."""
    w = np.array([0.299, 0.587, 0.114], np.float32)
    g = img.astype(np.float32) @ w
    # match cv::cvtColor's round-to-nearest uint8
    return np.clip(np.round(g), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Synthetic stereo generator (the test oracle)
# ---------------------------------------------------------------------------

def _fractal_noise(rng, h, w, octaves=4, persistence=0.55):
    """Multi-octave value noise in [0,1] — cheap textured field."""
    out = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        step = max(1, 2 ** (octaves - o + 2))
        gh, gw = h // step + 2, w // step + 2
        grid = rng.random((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1.001, h)
        xs = np.linspace(0, gw - 1.001, w)
        y0 = ys.astype(int); x0 = xs.astype(int)
        fy = (ys - y0)[:, None]; fx = (xs - x0)[None, :]
        g00 = grid[y0][:, x0]; g01 = grid[y0][:, x0 + 1]
        g10 = grid[y0 + 1][:, x0]; g11 = grid[y0 + 1][:, x0 + 1]
        val = (g00 * (1 - fy) * (1 - fx) + g01 * (1 - fy) * fx
               + g10 * fy * (1 - fx) + g11 * fy * fx)
        out += amp * val
        total += amp
        amp *= persistence
    return out / total


def _forward_warp_right(left: np.ndarray, disp: np.ndarray):
    """Right image by forward-warping left: right(x - d) = left(x); the
    nearest surface (max disparity) wins collisions. Returns
    (right [H,W,3], right_d [H,W] with -1 at disocclusions)."""
    h, w = disp.shape
    right = np.zeros((h, w, 3), np.float32)
    right_d = np.full((h, w), -1, np.int32)
    xs = np.arange(w)
    for v in range(h):
        xr = xs - disp[v]
        ok = xr >= 0
        # iterate in disparity order so larger-d (nearer) overwrites
        order = np.argsort(disp[v], kind="stable")
        for u in order:
            if ok[u]:
                right[v, xr[u]] = left[v, u]
                right_d[v, xr[u]] = disp[v, u]
    return right, right_d


def _left_nonocc_mask(disp: np.ndarray) -> np.ndarray:
    """Left-image visibility: pixel (v,u) is occluded if some nearer pixel
    maps to the same right column (or maps off-image)."""
    h, w = disp.shape
    nonocc = np.ones((h, w), bool)
    for v in range(h):
        best: Dict[int, int] = {}
        for u in range(w):
            xr = u - disp[v, u]
            if xr < 0:
                nonocc[v, u] = False
                continue
            if xr in best and disp[v, best[xr]] >= disp[v, u]:
                nonocc[v, u] = False
            elif xr in best:  # current is nearer: previous was occluded
                nonocc[v, best[xr]] = False
                best[xr] = u
            else:
                best[xr] = u
    return nonocc


# Photographs bundled with matplotlib and pygame (no download): natural
# texture, smooth regions, JPEG noise and real edges.
_PHOTO_CANDIDATES = (
    "matplotlib:grace_hopper.jpg",
    "pygame:docs/generated/_images/intro_freedom.jpg",
    "pygame:docs/generated/_images/intro_blade.jpg",
    "pygame:examples/data/alien1.jpg",
)
# the photo scene of the reference goldens tests/golden/photo_small_*.bin,
# kept rendered beside this module
PHOTO_SCENES = {"photo_small": dict(h=144, w=192, max_disp=23, seed=3)}


def _photo_path(spec: str) -> str:
    """The file of a ``package:relative path`` source. pygame is located,
    not imported (its import prints a banner)."""
    import importlib.util

    mod_name, rel = spec.split(":", 1)
    if mod_name == "matplotlib":
        import matplotlib.cbook as cbook

        return str(cbook.get_sample_data(rel, asfileobj=False))
    found = importlib.util.find_spec(mod_name)
    if found is None or found.origin is None:
        raise ModuleNotFoundError(f"no module {mod_name!r}")
    return os.path.join(os.path.dirname(found.origin), rel)


def _load_photos():
    """The photographic sources as RGB uint8 [H, W, 3], in the order of
    ``_PHOTO_CANDIDATES``. Raises RuntimeError naming a source that cannot
    be read: the JAX package skips it, which changes the scene."""
    import matplotlib.image as mpimg

    out = []
    for spec in _PHOTO_CANDIDATES:
        try:
            path = _photo_path(spec)
            if not os.path.isfile(path):
                raise FileNotFoundError(path)
            img = mpimg.imread(path)
        except Exception as err:
            raise RuntimeError(f"photo source {spec!r} is missing: {err}") from err
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        out.append(np.asarray(img[..., :3], np.uint8))
    return out


def _box_blur(img: np.ndarray, radius: int, reps: int = 2) -> np.ndarray:
    """Repeated separable box blur (close to a Gaussian): the weak-texture maker."""
    out = img.astype(np.float32)
    k = 2 * radius + 1
    for _ in range(reps):
        for axis in (0, 1):
            pad = [(0, 0)] * out.ndim
            pad[axis] = (radius + 1, radius)
            c = np.cumsum(np.pad(out, pad, mode="edge"), axis=axis)
            out = (np.take(c, np.arange(k, c.shape[axis]), axis=axis)
                   - np.take(c, np.arange(c.shape[axis] - k), axis=axis)) / k
    return out


def make_photo_pair(h: int = 375, w: int = 450, max_disp: int = 59, seed: int = 0,
                    noise_sigma: float = 2.5, name: str = "photo") -> StereoPair:
    """A photographically textured pair of slanted planes (the JAX package's
    ``make_photo_pair``): a slanted background and six foreground surfaces,
    some of them box-blurred photo crops (weak texture), one a horizontally
    periodic strip (period < max_disp), each rendered by
    :func:`_render_slanted_scene` with sub-pixel inverse warping; sensor
    noise on both views and a 3% red-channel gain on the right one."""
    photos = _load_photos()
    rng = np.random.default_rng(seed)
    fmax = float(max_disp)

    def crop(idx, blur=0, gain=1.0):
        """[H, W, 3] float crop of photo ``idx`` (tiled only if needed)."""
        img = photos[idx % len(photos)]
        ih, iw = img.shape[:2]
        big = np.tile(img, (-(-h // ih) + 1, -(-w // iw) + 1, 1)).astype(np.float32)
        oy = int(rng.integers(0, ih))
        ox = int(rng.integers(0, iw))
        t = big[oy:oy + h, ox:ox + w] * gain
        if blur:
            t = _box_blur(t, blur)
        return np.clip(t, 0, 255)

    surfaces = [dict(u0=0.0, u1=float(w), v0=0.0, v1=float(h),
                     d0=1.0, a=(0.25 * fmax - 1.0) / w, b=0.0)]
    textures = [crop(0)]
    recipes = [("blur", "a"), ("plain", "b"), ("periodic", None), ("blur", "b"),
               ("plain", "a"), ("blur", None)]
    for i, (kind, slant) in enumerate(recipes):
        ow = float(rng.integers(w // 5, w // 2))
        oh = float(rng.integers(h // 5, h // 2))
        u0 = float(rng.integers(0, int(w - ow)))
        v0 = float(rng.integers(0, int(h - oh)))
        d0 = float(rng.uniform(0.4 * fmax, 0.9 * fmax))
        a = float(rng.uniform(-0.12, 0.12)) if slant == "a" else 0.0
        b = float(rng.uniform(-0.12, 0.12)) if slant == "b" else 0.0
        lo = d0 + min(0.0, a * ow) + min(0.0, b * oh)
        hi = d0 + max(0.0, a * ow) + max(0.0, b * oh)
        if hi > fmax - 0.5:
            d0 -= hi - (fmax - 0.5)
        if lo < 1.0:
            d0 += 1.0 - lo
        surfaces.append(dict(u0=u0, u1=u0 + ow, v0=v0, v1=v0 + oh, d0=d0, a=a, b=b))
        if kind == "blur":
            textures.append(crop(i + 1, blur=int(rng.integers(3, 7))))
        elif kind == "periodic":
            period = int(rng.integers(max(6, max_disp // 6), max(8, max_disp // 2)))
            t = crop(i + 1)
            textures.append(np.tile(t[:, :period], (1, -(-w // period), 1))[:, :w])
        else:
            textures.append(crop(i + 1))

    pair = _render_slanted_scene(h, w, surfaces, textures, rng, noise_sigma, name, max_disp)
    r = pair.right.astype(np.float32)
    r[..., 0] *= 1.03
    right8 = np.clip(np.round(r), 0, 255).astype(np.uint8)
    return StereoPair(name=pair.name, left=pair.left, right=right8, gt=pair.gt,
                      max_disp=max_disp, masks=pair.masks)


def _photo_file(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), f"{name}.npz")


def save_photo_pair(name: str = "photo_small") -> str:
    """Render photo scene ``name`` (``PHOTO_SCENES``) and write its left,
    right, gt and nonocc mask to ``<name>.npz`` beside this module."""
    pair = make_photo_pair(name=name, **PHOTO_SCENES[name])
    path = _photo_file(name)
    np.savez_compressed(path, left=pair.left, right=pair.right, gt=pair.gt,
                        nonocc=pair.masks["nonocc"])
    return path


def load_photo_pair(name: str = "photo_small") -> StereoPair:
    """Photo scene ``name`` as :func:`save_photo_pair` wrote it, without
    matplotlib or pygame."""
    with np.load(_photo_file(name)) as f:
        masks = {"nonocc": f["nonocc"], "all": np.ones(f["gt"].shape, bool)}
        return StereoPair(name=name, left=f["left"], right=f["right"], gt=f["gt"],
                          max_disp=PHOTO_SCENES[name]["max_disp"], masks=masks)


def make_synthetic_pair(
    h: int = 128,
    w: int = 192,
    max_disp: int = 15,
    seed: int = 0,
    n_objects: int = 6,
    noise_sigma: float = 1.0,
    name: str = "synthetic",
) -> StereoPair:
    """Generate a textured stereo pair with exact integer ground truth.

    Scene model: a textured background plane at small disparity plus
    ``n_objects`` textured rectangles at larger disparities (fronto-parallel,
    so GT is piecewise constant and warping is exact). The right image is
    I_R(x) = I_L(x + d(x)) with proper occlusion handling: nearer surfaces
    win where warped pixels collide.
    """
    rng = np.random.default_rng(seed)

    # per-pixel disparity of the LEFT image
    bg_disp = max(1, max_disp // 5)
    disp = np.full((h, w), bg_disp, np.int32)
    for i in range(n_objects):
        oh = rng.integers(h // 6, h // 2)
        ow = rng.integers(w // 6, w // 2)
        oy = rng.integers(0, h - oh)
        ox = rng.integers(0, w - ow)
        od = rng.integers(bg_disp + 1, max_disp + 1)
        # nearer (larger disparity) objects drawn over farther ones
        region = disp[oy:oy + oh, ox:ox + ow]
        disp[oy:oy + oh, ox:ox + ow] = np.maximum(region, od)

    # textured left image: correlated fractal noise + strong per-pixel
    # high-frequency texture (warped with the scene -> matchable detail)
    base = _fractal_noise(rng, h, w, octaves=5)
    detail = rng.random((h, w)).astype(np.float32)
    left = np.stack(
        [
            np.clip(base * 140 + _fractal_noise(rng, h, w, 3) * 45
                    + detail * 60 + rng.random((h, w)) * 15, 0, 255)
            for _ in range(3)
        ],
        axis=-1,
    ).astype(np.float32)

    right, right_d = _forward_warp_right(left, disp)
    # fill disocclusions in right image with background texture continuation
    holes = right_d < 0
    if holes.any():
        fill = _fractal_noise(rng, h, w, 3) * 255
        for c in range(3):
            ch = right[:, :, c]
            ch[holes] = fill[holes]

    if noise_sigma > 0:
        left = left + rng.normal(0, noise_sigma, left.shape)
        right = right + rng.normal(0, noise_sigma, right.shape)

    left8 = np.clip(np.round(left), 0, 255).astype(np.uint8)
    right8 = np.clip(np.round(right), 0, 255).astype(np.uint8)

    nonocc = _left_nonocc_mask(disp)

    gt = disp.astype(np.float32)
    masks = {
        "nonocc": nonocc,
        "all": np.ones((h, w), bool),
    }
    return StereoPair(name=name, left=left8, right=right8, gt=gt,
                      max_disp=max_disp, masks=masks)


def make_adversarial_pair(
    h: int = 375,
    w: int = 450,
    max_disp: int = 59,
    seed: int = 0,
    noise_sigma: float = 0.5,
    name: str = "adversarial",
) -> StereoPair:
    """Adversarial synthetic scene: slanted planes (non-integer GT),
    low-texture regions, and repeated (periodic) patterns.

    The fronto-parallel generator (:func:`make_synthetic_pair`) produces
    scenes where cost ties are rare, so bit-identity to the reference
    binary gates little beyond the happy path. This scene model is built
    to make ties and ambiguity DENSE — where f32-vs-f64 accumulation and
    traversal-order divergence actually surface:

      * every surface is a plane d(u,v) = d0 + a(u-u0) + b(v-v0); the
        right view is rendered by per-row analytic inverse warping with
        bilinear texture resampling (sub-pixel geometry, so matching costs
        sit between integer hypotheses);
      * one rectangle carries horizontally periodic texture with period
        < max_disp (repeated-pattern ambiguity: multiple disparities give
        near-identical costs);
      * one rectangle is nearly textureless (census/grad codes collapse,
        WTA runs on noise);
      * the slanted background sweeps a continuous disparity range.

    Visibility is exact: a surface point exists only where it wins the
    left-view depth composite, and each right pixel sees the max-disparity
    candidate among analytic solutions; nonocc follows from re-solving at
    each left pixel's own right-column.
    """
    rng = np.random.default_rng(seed)
    fmax = float(max_disp)

    # --- surfaces: background plane + rectangles (u0,u1,v0,v1,d0,a,b,kind)
    surfaces = [dict(u0=0.0, u1=float(w), v0=0.0, v1=float(h),
                     d0=1.0, a=(0.25 * fmax - 1.0) / w, b=0.0,
                     kind="normal")]
    kinds = ["slanted", "periodic", "lowtex", "slanted_v", "normal",
             "periodic"]
    for kind in kinds:
        ow = float(rng.integers(w // 6, w // 3))
        oh = float(rng.integers(h // 6, h // 3))
        u0 = float(rng.integers(0, int(w - ow)))
        v0 = float(rng.integers(0, int(h - oh)))
        d0 = float(rng.uniform(0.45 * fmax, 0.9 * fmax))
        a = b = 0.0
        if kind == "slanted":
            a = float(rng.uniform(-0.12, 0.12))
        elif kind == "slanted_v":
            b = float(rng.uniform(-0.12, 0.12))
        # clamp the plane inside [1, max_disp] over its rectangle
        lo = d0 + min(0.0, a * ow) + min(0.0, b * oh)
        hi = d0 + max(0.0, a * ow) + max(0.0, b * oh)
        if hi > fmax - 0.5:
            d0 -= hi - (fmax - 0.5)
        if lo < 1.0:
            d0 += 1.0 - lo
        surfaces.append(dict(u0=u0, u1=u0 + ow, v0=v0, v1=v0 + oh,
                             d0=d0, a=a, b=b, kind=kind))

    # --- per-surface texture layers (float RGB in LEFT coordinates) ----
    def tex_normal():
        base = _fractal_noise(rng, h, w, octaves=5)
        detail = rng.random((h, w)).astype(np.float32)
        return np.stack([np.clip(base * 140 + _fractal_noise(rng, h, w, 3)
                                 * 45 + detail * 60
                                 + rng.random((h, w)) * 15, 0, 255)
                         for _ in range(3)], -1).astype(np.float32)

    textures = []
    for s in surfaces:
        if s["kind"] == "lowtex":
            # near-uniform: one flat color + sub-quantization ripple
            c = rng.uniform(90, 160, 3).astype(np.float32)
            t = np.broadcast_to(c, (h, w, 3)).copy()
            t += rng.normal(0, 1.2, t.shape).astype(np.float32)
            textures.append(t)
        elif s["kind"] == "periodic":
            period = int(rng.integers(max(6, max_disp // 6),
                                      max(8, max_disp // 2)))
            t = tex_normal()
            tile = t[:, :period]
            reps = -(-w // period)
            textures.append(np.tile(tile, (1, reps, 1))[:, :w])
        else:
            textures.append(tex_normal())

    return _render_slanted_scene(h, w, surfaces, textures, rng, noise_sigma,
                                 name, max_disp)


def _render_slanted_scene(h, w, surfaces, textures, rng, noise_sigma,
                          name, max_disp):
    """Analytic slanted-plane scene renderer — shared by
    :func:`make_adversarial_pair`, as in the JAX package.

    Left view: per-pixel max-disparity composite of the covering surfaces.
    Right view: per-row analytic inverse warp with bilinear texture
    resampling (sub-pixel geometry). Visibility is exact: nonocc re-solves
    each left pixel's own right column. ``surfaces``: dicts with
    u0/u1/v0/v1/d0/a/b (plane d(u,v) = d0 + a(u-u0) + b(v-v0));
    ``textures``: per-surface [H,W,3] float layers in LEFT coordinates;
    textures[0] also fills right columns seeing no surface."""

    def d_of(s, u, v):
        return s["d0"] + s["a"] * (u - s["u0"]) + s["b"] * (v - s["v0"])

    uu = np.arange(w, dtype=np.float32)[None, :].repeat(h, 0)
    vv = np.arange(h, dtype=np.float32)[:, None].repeat(w, 1)

    # left composite: per-pixel argmax disparity over covering surfaces
    depth = np.full((h, w), -np.inf, np.float32)
    sid = np.zeros((h, w), np.int32)
    for i, s in enumerate(surfaces):
        cov = (uu >= s["u0"]) & (uu < s["u1"]) & (vv >= s["v0"]) & (vv < s["v1"])
        d = d_of(s, uu, vv).astype(np.float32)
        take = cov & (d > depth)
        depth = np.where(take, d, depth)
        sid = np.where(take, i, sid)
    gt = depth.astype(np.float32)
    left = np.zeros((h, w, 3), np.float32)
    for i in range(len(surfaces)):
        left = np.where((sid == i)[..., None], textures[i], left)

    def solve_visible(xr):
        """For right columns ``xr`` [h,w_cols]: winning surface id, left-u,
        and disparity of the scene point seen there (-1/nan if none)."""
        best_d = np.full(xr.shape, -np.inf, np.float32)
        best_u = np.zeros(xr.shape, np.float32)
        best_i = np.full(xr.shape, -1, np.int32)
        v = np.arange(h, dtype=np.float32)[:, None]
        for i, s in enumerate(surfaces):
            ui = (xr + s["d0"] - s["a"] * s["u0"]
                  + s["b"] * (v - s["v0"])) / (1.0 - s["a"])
            cov = (ui >= s["u0"]) & (ui < s["u1"]) & (v >= s["v0"]) & (v < s["v1"])
            di = ui - xr
            # the point must also WIN the left-view composite at (v, ui)
            uidx = np.clip(np.round(ui).astype(np.int32), 0, w - 1)
            vis = sid[np.arange(h)[:, None], uidx] == i
            ok = cov & vis & (di > best_d)
            best_d = np.where(ok, di, best_d)
            best_u = np.where(ok, ui, best_u)
            best_i = np.where(ok, i, best_i)
        return best_i, best_u, best_d

    # right view: analytic inverse warp + bilinear texture resample
    xr_cols = np.arange(w, dtype=np.float32)[None, :].repeat(h, 0)
    ri, ru, _rd = solve_visible(xr_cols)
    right = np.zeros((h, w, 3), np.float32)
    u0i = np.clip(np.floor(ru).astype(np.int32), 0, w - 2)
    fu = (ru - u0i)[..., None].astype(np.float32)
    rows = np.arange(h)[:, None]
    for i in range(len(surfaces)):
        t = textures[i]
        samp = t[rows, u0i] * (1 - fu) + t[rows, u0i + 1] * fu
        right = np.where((ri == i)[..., None], samp, right)
    # columns seeing no surface (left of the leftmost projection): bg fill
    hole = ri < 0
    right = np.where(hole[..., None], textures[0], right)

    # nonocc: re-solve at each left pixel's own right column
    xr_left = uu - gt
    oi, ou, od = solve_visible(xr_left)
    visible = (xr_left >= 0) & (oi == sid) & (np.abs(ou - uu) < 0.5) \
        & (od <= gt + 1e-3)
    if noise_sigma > 0:
        left = left + rng.normal(0, noise_sigma, left.shape)
        right = right + rng.normal(0, noise_sigma, right.shape)
    left8 = np.clip(np.round(left), 0, 255).astype(np.uint8)
    right8 = np.clip(np.round(right), 0, 255).astype(np.uint8)
    masks = {"nonocc": visible, "all": np.ones((h, w), bool)}
    return StereoPair(name=name, left=left8, right=right8, gt=gt,
                      max_disp=max_disp, masks=masks)


if __name__ == "__main__":
    print(save_photo_pair())
