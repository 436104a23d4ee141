"""Plain torch versions of the four CUDA kernels against the JAX CPU path.

A arms_grow, B arm_taps (sum and CBCA area mode), C sgm_scan, D wta. Both
sides get the same numpy arrays, and every comparison is exact: the plain
versions keep the JAX CPU path's operation order (ascending taps, the
_scan_down step, first-occurrence argmin). The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu.ops import aggregation as jax_agg
from mystereomatching_tpu.ops import arms as jax_arms
from mystereomatching_tpu.ops import sgm as jax_sgm

from mystereomatching_tpu_torch.ops import aggregation, arms, sgm, wta
from mystereomatching_tpu_torch.ops import cuda_kernels as ck

M = 34  # the default max arm (cbca_cross_l_out)
SCHED = [20.0 if k <= 17 else 6.0 for k in range(1, M + 1)]


def _blocky_image(rng, h, w):
    """Piecewise-flat colour blocks plus noise: arms from 0 to l_out."""
    base = np.kron(rng.integers(0, 256, (-(-h // 30), -(-w // 30), 3)), np.ones((30, 30, 1)))
    img = base[:h, :w] + rng.normal(0, 2.0, (h, w, 3))
    return np.clip(np.round(img), 0, 255).astype(np.float32)


def _arms8(rng, shape, hi):
    return rng.integers(0, hi, shape).astype(np.int8)


@pytest.mark.parametrize("shape", [(45, 70), (9, 50)])
def test_arms_grow_plain_exact(shape):
    img = _blocky_image(np.random.default_rng(shape[0]), *shape)
    grow = jax.jit(lambda x: jax_arms._grow_arms(x, SCHED, 20.0, 1, jax_arms.DIRECTIONS))
    ref = np.asarray(grow(jnp.asarray(img)))
    ours = arms.grow_arms_plain(torch.from_numpy(img), SCHED, 20.0, 1)
    assert ours.dtype == torch.int32
    assert ref.max() > 17  # long arms reach the outer threshold
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("axis", [1, 2])
def test_arm_taps_sum_plain_exact(axis):
    rng = np.random.default_rng(axis)
    vol = rng.random((5, 24, 40)).astype(np.float32)
    an, ap = (_arms8(rng, vol.shape, 40) for _ in range(2))  # some above max_arm
    ref = jax_arms.arm_bounded_sum(jnp.asarray(vol), jnp.asarray(an), jnp.asarray(ap),
                                   axis=axis, max_arm=M)
    ours = arms.arm_bounded_sum_plain(torch.from_numpy(vol), torch.from_numpy(an),
                                      torch.from_numpy(ap), axis, M)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("axis", [1, 2])
def test_arm_taps_area_plain_exact(axis):
    rng = np.random.default_rng(10 + axis)
    vol = rng.random((4, 30, 36)).astype(np.float32)
    an1, ap1, an, ap = (_arms8(rng, vol.shape, 40) for _ in range(4))
    first = 3 - axis  # the other spatial axis
    v1, area = jax_arms.arm_bounded_sum_with_area(
        jnp.asarray(vol), jnp.asarray(an1), jnp.asarray(ap1), axis=first, max_arm=M)
    s = jax_arms.arm_bounded_sum(jnp.stack([v1, area]), jnp.asarray(an)[None],
                                 jnp.asarray(ap)[None], axis=axis + 1, max_arm=M)
    ref = s[0] / jnp.maximum(s[1], 1.0)
    ours = arms.arm_bounded_sum_area_plain(
        torch.from_numpy(np.array(v1)), torch.from_numpy(an1), torch.from_numpy(ap1),
        torch.from_numpy(an), torch.from_numpy(ap), axis, M)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("axis", [1, 2])
def test_arm_taps_area_plain_equals_integer_count(axis):
    """The fact kernel B's area mode rests on: the ascending float sum of the
    support counts equals their integer sum (a prefix-sum difference)
    converted to float, here at max_arm 127 with arms up to 127, where a
    window holds 255 counts of up to 255 each."""
    rng = np.random.default_rng(20 + axis)
    m = 127
    vol = rng.random((3, 140, 150)).astype(np.float32)
    an1, ap1, an, ap = (_arms8(rng, vol.shape, 128) for _ in range(4))
    an[:, ::7], ap[:, ::5] = 127, 127    # windows reaching max_arm on either side
    an[:, 3::11], ap[:, 4::13] = 0, 0
    t = [torch.from_numpy(a) for a in (vol, an1, ap1, an, ap)]
    ours = arms.arm_bounded_sum_area_plain(*t, axis, m)

    n = vol.shape[axis]
    count = (np.minimum(an1, m).astype(np.int64) + np.minimum(ap1, m) + 1)
    prefix = np.concatenate([np.zeros_like(count.take([0], axis)), np.cumsum(count, axis)], axis)
    pos = np.arange(n).reshape([-1 if a == axis else 1 for a in range(3)])
    lo = pos - np.minimum(np.minimum(an, m), pos)
    hi = pos + np.minimum(np.minimum(ap, m), n - 1 - pos)
    area = (np.take_along_axis(prefix, hi + 1, axis)
            - np.take_along_axis(prefix, lo, axis)).astype(np.float32)
    assert area.max() > 1 << 14  # far beyond what int8 or a short window holds
    sums = arms.arm_bounded_sum_plain(t[0], t[3], t[4], axis, m).numpy()
    np.testing.assert_array_equal(ours.numpy(), sums / np.maximum(area, np.float32(1.0)))


@pytest.mark.parametrize("axis", [1, 2])
def test_arm_taps_area_plain_long_arms_match_pallas(axis):
    """At max_arm 127 with arms up to 127 a support count reaches 255, past
    int8: the plain area pass counts it in int32, as the JAX package's
    Pallas kernel (``_taps_kernel_area``, interpret mode) does. The costs
    are small integers, so every sum is exact whatever order each side adds
    in, and the two agree exactly where their area counts do."""
    from mystereomatching_tpu.ops.pallas_kernels import sublane_pass_area

    rng = np.random.default_rng(30 + axis)
    m = 127
    vol = rng.integers(0, 8, (2, 150, 20)).astype(np.float32)
    an1, ap1, an, ap = (_arms8(rng, vol.shape, 128) for _ in range(4))
    an1[:, ::3], ap1[:, ::2] = 127, 127  # support counts of 255
    an[:, 5::7], ap[:, 4::5] = 127, 127  # windows reaching max_arm on either side
    assert (np.minimum(an1, m).astype(np.int32) + np.minimum(ap1, m) + 1).max() == 255
    ours = arms.arm_bounded_sum_area_plain(
        *(torch.from_numpy(a) for a in (vol, an1, ap1, an, ap)), axis, m)
    # sublane_pass_area reduces along axis 1 of [B, A, L]
    swap = (lambda a: np.swapaxes(a, 1, 2)) if axis == 2 else (lambda a: a)
    ref = sublane_pass_area(*(jnp.asarray(swap(a)) for a in (vol, an1, ap1, an, ap)), m,
                            interpret=True)
    np.testing.assert_array_equal(ours.numpy(), swap(np.asarray(ref)))


def test_cbca_plain_exact():
    rng = np.random.default_rng(3)
    vol = rng.random((6, 28, 33)).astype(np.float32)
    arms_int = _arms8(rng, (4,) + vol.shape, 9)
    ref = jax_agg.cbca(jnp.asarray(vol), jnp.asarray(arms_int), 2, max_arm=M)
    ours = aggregation.cbca(torch.from_numpy(vol), torch.from_numpy(arms_int), 2, M)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("axis,reverse", [(2, False), (2, True), (3, False), (3, True)])
def test_sgm_scan_plain_exact(axis, reverse):
    rng = np.random.default_rng(axis * 2 + reverse)
    vol = (rng.random((2, 37, 13, 17)) * 3).astype(np.float32)   # D > 32: two lane slots
    ps = np.where(rng.random((2, 13, 17)) < 0.3, 0.25, 1.0).astype(np.float32)
    # the JAX scan runs top-down along H: flip and transpose around it
    v, p = jnp.asarray(vol), jnp.asarray(ps)
    if axis == 3:
        v, p = jnp.swapaxes(v, 2, 3), jnp.swapaxes(p, 1, 2)
    if reverse:
        v, p = v[:, :, ::-1], p[:, ::-1]
    scan = jax.jit(jax.vmap(lambda a, b: jax_sgm._scan_down(a, b, 1.0, 3.0)))
    ref = scan(v, p)
    if reverse:
        ref = ref[:, :, ::-1]
    if axis == 3:
        ref = jnp.swapaxes(ref, 2, 3)
    ours = sgm.sgm_scan_plain(torch.from_numpy(vol), torch.from_numpy(ps), 1.0, 3.0,
                              axis, reverse)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_sgm_multi_exact():
    rng = np.random.default_rng(5)
    vols = [(rng.random((9, 15, 19)) * 2).astype(np.float32) for _ in range(2)]
    imgs = [_blocky_image(rng, 15, 19) for _ in range(2)]
    ref = jax.jit(lambda v, i: jax_sgm.sgm_multi(v, i, 4, 1.0, 3.0, 15, 4.0))(
        [jnp.asarray(v) for v in vols], [jnp.asarray(i) for i in imgs])
    ours = sgm.sgm_multi([torch.from_numpy(v) for v in vols],
                         [torch.from_numpy(i) for i in imgs], 4, 1.0, 3.0, 15, 4.0)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("choose_small", [True, False])
def test_wta_plain_exact_with_ties(choose_small):
    vol = np.random.default_rng(6).integers(0, 3, (11, 14, 15)).astype(np.float32)
    ref = jnp.argmin(vol, 0) if choose_small else jnp.argmax(vol, 0)
    ours = wta.wta_plain(torch.from_numpy(vol), choose_small)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(8)
    vol = torch.from_numpy(rng.random((3, 8, 9)).astype(np.float32))
    an, ap = (torch.from_numpy(_arms8(rng, (3, 8, 9), 5)) for _ in range(2))
    ck.reset_launches()
    assert torch.equal(arms.arm_bounded_sum(vol, an, ap, 2, M),
                       arms.arm_bounded_sum_plain(vol, an, ap, 2, M))
    assert torch.equal(wta.wta(vol), wta.wta_plain(vol))
    assert all(n == 0 for n in ck.launches.values())


def test_other_devices_are_refused():
    with pytest.raises(ValueError):
        wta.wta(torch.zeros((2, 3, 4), device="meta"))


@pytest.mark.parametrize("call", [
    lambda: ck.arms_grow(torch.zeros((4, 5, 3)), SCHED, 20.0, 1),
    lambda: ck.arm_taps(torch.zeros((2, 4, 5)), torch.zeros((2, 4, 5), dtype=torch.int8),
                        torch.zeros((2, 4, 5), dtype=torch.int8), 2, M),
    lambda: ck.sgm_scan(torch.zeros((1, 2, 4, 5)), torch.ones((1, 4, 5)), 1.0, 3.0, 2, False),
    lambda: ck.wta(torch.zeros((2, 4, 5))),
    lambda: ck.arm_reduce(torch.zeros((2, 4, 5), dtype=torch.int32),
                          torch.zeros((4, 5), dtype=torch.int32),
                          torch.zeros((4, 5), dtype=torch.int32), 2, M, "min"),
    lambda: ck.region_vote(torch.zeros((4, 5), dtype=torch.int32),
                           torch.zeros((4, 4, 5), dtype=torch.int32), M, 20),
    lambda: ck.pi_scan(torch.zeros((4, 5), dtype=torch.int32), torch.zeros((4, 5, 3)),
                       torch.zeros((16, 20, 2), dtype=torch.int32), -32),
])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError):
        call()
