"""Double-window CBCA (the preset ``cbca_double``) against the JAX package, on the CPU.

End to end at 48x64, D=16, on a synthetic and an adversarial scene: the
port's ``disp_left_raw``, ``disp_right_raw`` and ``disparity`` equal the
jitted JAX ``match_pair``'s, one jit for both scenes, with the windows of
``tests/test_torch_vmtop.py``'s ``NARROW`` (the large window's arms to 6 /
6, so kernel B's CBCA pass there takes max_arm 6 beside window 0's 8).
Every stage runs: the second arm build at ``window1()``, its CBCA pass on
the raw volume, the small-window pass and ``combine2Vm_4``'s mask from the
left image's arms for both volumes. The other merges, ``combine2Vm_2``
and ``_3``, are held against JAX in ``tests/test_torch_vmtop.py``.
"""

import pytest

from test_torch_vmtop import KEYS, NARROW, SCENES, check_maps, jax_and_port_maps, make_scenes


@pytest.fixture(scope="module")
def scenes():
    return make_scenes()


@pytest.fixture(scope="module")
def preset_maps(scenes):
    return jax_and_port_maps("cbca_double", scenes)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("key", KEYS)
def test_preset_matches_jax(preset_maps, scene, key):
    check_maps(preset_maps, scene, key)
