"""The photo scenes and the entry point, on the CPU.

``make_photo_pair`` equals the JAX package's on ``photo_small`` (left,
right, ground truth, masks); the committed ``photo_small.npz`` equals a
fresh render; the port's loader raises where a photographic source is
missing (the JAX loader skips it, which changes the scene). The default
preset on the committed pair holds the reference binary's goldens
(``tests/golden/photo_small_{wta,final}.bin``) at 0/0 px with a
bad-1.0 rate on nonocc pixels of at least 0.01, as the JAX package's
``test_reference_golden.py`` does. ``entry(device="cpu")`` runs.
"""

import os

import numpy as np
import pytest
import torch

from mystereomatching_tpu import data as jax_data

import mystereomatching_tpu_torch as port
from mystereomatching_tpu_torch import data
from mystereomatching_tpu_torch.entry import entry
from mystereomatching_tpu_torch.models import get_model
from mystereomatching_tpu_torch.pipeline import StereoPipeline
from mystereomatching_tpu_torch.utils.metrics import bad_pixel_rate

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _load_ref_disp(path):
    with open(path, "rb") as f:
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        return np.frombuffer(f.read(h * w * 2), np.int16).reshape(h, w).astype(np.int32)


@pytest.fixture(scope="module")
def photo_small():
    return data.make_photo_pair(name="photo_small", **data.PHOTO_SCENES["photo_small"])


def _assert_same_pair(a, b):
    for key in ("left", "right", "gt"):
        got, want = getattr(a, key), getattr(b, key)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert a.max_disp == b.max_disp
    assert sorted(a.masks) == sorted(b.masks)
    for key in a.masks:
        np.testing.assert_array_equal(a.masks[key], b.masks[key])


def test_photo_pair_is_the_jax_one(photo_small):
    want = jax_data.make_photo_pair(name="photo_small", **data.PHOTO_SCENES["photo_small"])
    _assert_same_pair(photo_small, want)
    assert data.PHOTO_SCENES["photo_small"] == dict(h=144, w=192, max_disp=23, seed=3)


def test_committed_photo_pair_equals_a_fresh_render(photo_small):
    _assert_same_pair(data.load_photo_pair("photo_small"), photo_small)


def test_box_blur_is_the_jax_one():
    img = np.random.default_rng(1).integers(0, 256, (20, 30, 3)).astype(np.float32)
    for radius in (3, 6):
        np.testing.assert_array_equal(data._box_blur(img, radius),
                                      jax_data._box_blur(img, radius))


@pytest.mark.parametrize("spec", ["pygame:docs/generated/_images/no_such_photo.jpg",
                                  "no_such_package_xyz:photo.jpg",
                                  "matplotlib:no_such_sample.jpg"])
def test_load_photos_raises_on_a_missing_source(monkeypatch, spec):
    monkeypatch.setattr(data, "_PHOTO_CANDIDATES", data._PHOTO_CANDIDATES + (spec,))
    with pytest.raises(RuntimeError, match="is missing"):
        data._load_photos()
    with pytest.raises(RuntimeError, match="is missing"):
        data.make_photo_pair(name="photo_small", **data.PHOTO_SCENES["photo_small"])


def test_default_preset_holds_the_photo_small_goldens():
    pair = data.load_photo_pair("photo_small")
    cfg = get_model("census_grad_cbca_sgm", max_disp=pair.max_disp)
    out = StereoPipeline(cfg, device="cpu")(pair.left, pair.right)
    wta = out["disp_left_raw"].numpy()
    final = torch.round(out["disparity"]).to(torch.int32).numpy()
    assert int((wta != _load_ref_disp(os.path.join(GOLDEN, "photo_small_wta.bin"))).sum()) == 0
    assert int((final != _load_ref_disp(os.path.join(GOLDEN, "photo_small_final.bin"))).sum()) == 0
    m = pair.masks["nonocc"]
    bad1 = float((((np.abs(final - pair.gt) > 1) | (final < 0)) & m).sum() / m.sum())
    assert bad1 >= 0.01
    assert bad_pixel_rate(torch.round(out["disparity"]), torch.from_numpy(pair.gt),
                          torch.from_numpy(m)) == pytest.approx(bad1)


def test_entry_on_the_cpu():
    fn, (left, right) = entry(device="cpu")
    assert isinstance(fn, StereoPipeline) and fn.device == torch.device("cpu")
    assert fn.cfg == port.default_config(max_disp=31)
    assert left.shape == (120, 160, 3) and left.dtype == torch.float32
    assert 0.0 <= float(left.min()) and float(left.max()) < 255.0
    assert torch.equal(right, torch.roll(left, 3, dims=1))
    again = entry(device="cpu")[1][0]
    assert torch.equal(again, left)
    out = fn(left, right)
    assert set(out) == {"disparity", "disp_left_raw", "disp_right_raw"}
    assert out["disparity"].shape == (120, 160) and out["disparity"].dtype == torch.float32
    assert bool(torch.isfinite(out["disparity"]).all())


def test_entry_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry()
