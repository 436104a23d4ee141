"""The taps probes' plain versions against the TPU probes themselves, on the CPU.

``scripts/micro3.py``, ``micro_cbca2.py``, ``micro_cbca3.py`` and
``micro_cbca5.py`` are not imported: ``micro_cbca5.py`` calls ``main()`` at
import, and ``micro_cbca2.py`` and ``micro_cbca3.py`` set JAX's compilation
cache there. Each file is parsed with ``ast`` instead, and only the
definitions a probe needs (its kernel, the helpers it calls and the
function around its ``pallas_call``) run, in a namespace holding ``jax``,
``jnp``, ``pl``, ``pltpu`` and ``functools``. The kernels run in TPU
interpret mode at [D, H, W] = [3, 40, 128] (and W = 136, a partial
128-column block) with max_arm 10, on numpy inputs from seed 0: random arms
in [0, max_arm], and all arms 0. Every comparison is exact.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops import taps_probes

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
D, H, W, M = 3, 40, 128, 10
# script -> the definitions its probes need
NEEDS = {
    "micro3.py": ("_cdiv", "_kb", "_kc", "call"),
    "micro_cbca2.py": ("_cdiv", "_taps_kernel_fixed", "_taps_kernel_seg",
                       "_taps_kernel_clones", "run_variant"),
    "micro_cbca3.py": ("_cdiv", "_build_clones", "_taps_kernel_oct", "_taps_kernel_clseg",
                       "_taps_kernel_clones", "run_variant"),
    "micro_cbca5.py": ("MAX_ARM", "_cdiv", "_taps_kernel_static", "run_static"),
}


def _load(script: str) -> dict:
    """``NEEDS[script]``'s functions and constants of ``scripts/{script}``,
    run in a namespace of their own; nothing else of the file runs."""
    path = SCRIPTS / script
    names = NEEDS[script]
    keep = [node for node in ast.parse(path.read_text()).body
            if (isinstance(node, ast.FunctionDef) and node.name in names)
            or (isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                and any(getattr(t, "id", None) in names for t in node.targets))]
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools)
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    assert set(names) <= set(ns), f"{script}: missing {set(names) - set(ns)}"
    return ns


@pytest.fixture(scope="module")
def scripts():
    cache = jax.config.jax_compilation_cache_dir
    loaded = {script: _load(script) for script in NEEDS}
    assert jax.config.jax_compilation_cache_dir == cache  # no script's import-time code ran
    return loaded


def _inputs(w: int = W, zero: bool = False):
    rng = np.random.default_rng(0)
    vol = rng.random((D, H, w), np.float32)
    an, ap = (np.zeros((D, H, w), np.int32) if zero else
              rng.integers(0, M + 1, (D, H, w)).astype(np.int32) for _ in range(2))
    return vol, an, ap


def _plain(fn, vol, an, ap, *args):
    return fn(*(torch.from_numpy(a) for a in (vol, an, ap)), *args).numpy()


def _cbca_bodies(scripts):
    """The micro_cbca bodies as name -> (vol [1, D, H, W], an, ap) -> out."""
    c2, c3, c5 = (scripts[f"micro_cbca{i}.py"] for i in (2, 3, 5))
    part = functools.partial
    return {
        "fixed": lambda v, n, p: c2["run_variant"](c2["_taps_kernel_fixed"], v, n, p, M),
        "seg16": lambda v, n, p: c2["run_variant"](part(c2["_taps_kernel_seg"], seg=16),
                                                   v, n, p, M),
        "seg64": lambda v, n, p: c2["run_variant"](part(c2["_taps_kernel_seg"], seg=64),
                                                   v, n, p, M),
        "clones2": lambda v, n, p: c2["run_variant"](c2["_taps_kernel_clones"], v, n, p, M,
                                                     clones=True),
        "clones3": lambda v, n, p: c3["run_variant"](c3["_taps_kernel_clones"], v, n, p, M),
        "oct": lambda v, n, p: c3["run_variant"](c3["_taps_kernel_oct"], v, n, p, M),
        "clseg16": lambda v, n, p: c3["run_variant"](part(c3["_taps_kernel_clseg"], seg=16),
                                                     v, n, p, M),
        "clseg64": lambda v, n, p: c3["run_variant"](part(c3["_taps_kernel_clseg"], seg=64),
                                                     v, n, p, M),
        "static8": lambda v, n, p: c5["run_static"](v, n, p, max_arm=M, oct_size=8),
        "static16": lambda v, n, p: c5["run_static"](v, n, p, max_arm=M, oct_size=16),
    }


CBCA = ("fixed", "seg16", "seg64", "clones2", "clones3", "oct", "clseg16", "clseg64",
        "static8", "static16")


def _run_cbca(scripts, body, vol, an, ap):
    with pltpu.force_tpu_interpret_mode():
        out = _cbca_bodies(scripts)[body](jnp.asarray(vol)[None], jnp.asarray(an),
                                          jnp.asarray(ap))
    return np.asarray(out)[0]


def _run_micro3(scripts, kern, axis, vol, an, ap):
    m3 = scripts["micro3.py"]
    with pltpu.force_tpu_interpret_mode():
        out = m3["call"](m3[kern], jnp.asarray(vol), jnp.asarray(an), jnp.asarray(ap), axis, M,
                         kern == "_kc", 1)
    return np.asarray(out)


@pytest.mark.parametrize("w", [W, 136])
@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("kern", ["_kb", "_kc"])
def test_micro3_probes_are_the_plain_sums(scripts, kern, axis, w):
    """``_kb`` (rolled registers) wraps around the whole axis; ``_kc``
    (dynamic slices of a zero-padded scratch) does not. The scripts' block
    axis 2 is the port's H (axis 1), 3 its W."""
    vol, an, ap = _inputs(w)
    plain = taps_probes.circular_plain if kern == "_kb" else taps_probes.bounded_plain
    np.testing.assert_array_equal(_plain(plain, vol, an, ap, axis - 1, M),
                                  _run_micro3(scripts, kern, axis, vol, an, ap))


@pytest.mark.parametrize("body", CBCA)
def test_micro_cbca_probes_are_the_plain_sums(scripts, body):
    """Every micro_cbca body computes the zero-padded sum along H, but
    ``_taps_kernel_fixed``, which adds vol shifted down by max_arm % 8 rows."""
    vol, an, ap = _inputs()
    want = (_plain(taps_probes.fixed_plain, vol, an, ap, M) if body == "fixed" else
            _plain(taps_probes.bounded_plain, vol, an, ap, 1, M))
    np.testing.assert_array_equal(want, _run_cbca(scripts, body, vol, an, ap))


@pytest.mark.parametrize("body", ["_kb", "oct", "static16"])
def test_probes_with_arms_zero_return_the_volume(scripts, body):
    """The wrap, a trip count of 0 octaves (n_oct = 1, every tap masked) and
    every octave gated off."""
    vol, an, ap = _inputs(zero=True)
    got = (_run_micro3(scripts, body, 2, vol, an, ap) if body.startswith("_k") else
           _run_cbca(scripts, body, vol, an, ap))
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(_plain(taps_probes.bounded_plain, vol, an, ap, 1, M), vol)


def test_oct_probe_drops_the_taps_of_a_partial_block(scripts):
    """A fault of the JAX probe, not of the port: ``_taps_kernel_oct`` takes
    its trip count (kmax + 8) // 8 from a block's largest arm over all 128
    lanes, with no clamp. In interpret mode the lanes past the image hold
    int32's largest value, the sum overflows and no octave runs: the
    partial block's columns (>= 128) come out as the centre value alone.
    The port takes the largest arm over the image only."""
    vol, an, ap = _inputs(136)
    got = _run_cbca(scripts, "oct", vol, an, ap)
    want = _plain(taps_probes.bounded_plain, vol, an, ap, 1, M)
    np.testing.assert_array_equal(got[..., :128], want[..., :128])
    np.testing.assert_array_equal(got[..., 128:], vol[..., 128:])
    assert (want[..., 128:] != vol[..., 128:]).any()


def test_fixed_plain_shifts_by_max_arm_mod_8():
    vol, an, ap = _inputs()
    ones = np.ones_like(an)
    got = _plain(taps_probes.fixed_plain, vol, ones, np.zeros_like(ap), M)
    shift = M % 8
    np.testing.assert_array_equal(got[:, shift:], vol[:, shift:] + vol[:, :H - shift])
    np.testing.assert_array_equal(got[:, :shift], vol[:, :shift])


def test_circular_equals_bounded_where_no_arm_reaches_the_edge():
    vol, an, ap = _inputs()
    rows = np.arange(H)[None, :, None]
    an, ap = np.minimum(an, rows), np.minimum(ap, H - 1 - rows)
    np.testing.assert_array_equal(_plain(taps_probes.circular_plain, vol, an, ap, 1, M),
                                  _plain(taps_probes.bounded_plain, vol, an, ap, 1, M))


def test_plain_caps_the_arms_at_max_arm():
    vol, an, ap = _inputs()
    np.testing.assert_array_equal(_plain(taps_probes.bounded_plain, vol, an + 5, ap + 5, 2, M),
                                  _plain(taps_probes.bounded_plain, vol,
                                         np.minimum(an + 5, M), np.minimum(ap + 5, M), 2, M))


# a call with (vol, arms), and what it must refuse
REFUSALS = [
    (lambda v, a: ck.taps_probe_roll(v, a, a, 3, M), "axis"),
    (lambda v, a: ck.taps_probe_slice(v, a, a, "fixed", M, axis=2), "axis"),
    (lambda v, a: ck.taps_probe_slice(v, a, a, "seg", M, seg=16), "parameter"),
    (lambda v, a: ck.taps_probe_slice(v, a, a, "roll", M), "kind"),
    (lambda v, a: ck.taps_probe_clones(v, a, a, "clseg", M, seg=48), "parameter"),
    (lambda v, a: ck.taps_probe_clones(v, a, a, "oct", M, seg=64), "parameter"),
    (lambda v, a: ck.taps_probe_static(v, a, a, 12, 34), "parameter"),
    (lambda v, a: ck.taps_probe_static(v, a, a, 8, M), "compiled"),
    (lambda v, a: ck.taps_probe_roll(torch.zeros(1, 2, 513), a, a, 2, M), "exceeds"),
]


@pytest.mark.parametrize("call,match", REFUSALS)
def test_taps_probe_wrappers_refuse(call, match):
    """The wrappers refuse a kind, axis, segment or octave they do not have;
    nothing launches."""
    vol = torch.zeros(D, 4, 5)
    arms = torch.zeros(D, 4, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        call(vol, arms)
    assert sum(ck.launches[name] for name in ck.TAPS_PROBES) == 0


@pytest.mark.parametrize("entry", list(ck.TAPS_PROBES))
def test_taps_probe_wrappers_take_cuda_tensors_only(entry):
    vol = torch.zeros(D, 4, 5)
    arms = torch.zeros(D, 4, 5, dtype=torch.int32)
    _, kinds = ck.TAPS_PROBES[entry]
    kind, (_, axes, params) = next(iter(kinds.items()))
    call = {"taps_probe_roll": lambda: ck.taps_probe_roll(vol, arms, arms, axes[0], M),
            "taps_probe_slice": lambda: ck.taps_probe_slice(vol, arms, arms, kind, M),
            "taps_probe_clones": lambda: ck.taps_probe_clones(vol, arms, arms, kind, M),
            "taps_probe_static": lambda: ck.taps_probe_static(vol, arms, arms, params[0])}
    with pytest.raises(ValueError, match="CUDA"):
        call[entry]()
    assert ck.launches[entry] == 0
