"""Kernel C's table of W-chunk scans, plain version, against the JAX package.

``sgm.sgm_scan_table_plain`` scans each :class:`ChunkScan` of a table in
place: chunks at odd column offsets of wider buffers with odd pitches,
masked beside unmasked scans, with and without a carried-in row, down and
up (``reverse``), with and without a boundary-row output. Each scan is held
against JAX ``sgm._scan_down(init=, in_image=)`` on the same numpy inputs
(its chunk flipped for an upward scan), exactly; bfloat16 is compared as
bits. One JAX jit a parametrisation. The table kernel itself is held
against this plain version on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mystereomatching_tpu.ops import sgm as jax_sgm

from mystereomatching_tpu_torch.ops import cuda_kernels as ck
from mystereomatching_tpu_torch.ops import sgm
from mystereomatching_tpu_torch.ops.sgm import ChunkScan

D = 6
# buffers (h, pitch) and the table's scans: (buffer, lo, width, masked,
# with init, reverse, with edge); two scans share each buffer and its output
BUFFERS = [(17, 23), (24, 15)]
SCANS = [(0, 3, 7, True, True, False, True),
         (0, 11, 12, False, False, True, True),
         (1, 0, 9, True, False, True, False),
         (1, 9, 5, False, True, False, True)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    bufs = [dict(vol=(rng.random((D, h, w)) * 3).astype(np.float32),
                 sel=rng.random((h, w)) < 0.4,            # where the penalty scale is 1/4
                 mask=rng.random((h, w)) < 0.7) for h, w in BUFFERS]
    inits = [(rng.random((D, width)) * 4).astype(np.float32) if init else None
             for _, _, width, _, init, _, _ in SCANS]
    return bufs, inits


def _jax_scans(bufs, inits, jdt):
    """Each scan of SCANS by sgm._scan_down on its chunk, flipped to scan up."""
    def run(vols, sels, masks, inits):
        outs = []
        for (b, lo, width, masked, _, reverse, _), init in zip(SCANS, inits):
            cols = slice(lo, lo + width)
            vol = vols[b][:, :, cols].astype(jdt)
            ps = jnp.where(sels[b][:, cols], 0.25, 1.0)
            mask = masks[b][:, cols] if masked else None
            if reverse:
                vol, ps = vol[:, ::-1], ps[::-1]
                mask = mask[::-1] if mask is not None else None
            out = jax_sgm._scan_down(vol, ps, 1.0, 3.0, in_image=mask,
                                     init=init.astype(jdt) if init is not None else None)
            outs.append(out[:, ::-1] if reverse else out)
        return outs

    return jax.jit(run)([jnp.asarray(b["vol"]) for b in bufs],
                        [jnp.asarray(b["sel"]) for b in bufs],
                        [jnp.asarray(b["mask"]) for b in bufs],
                        [jnp.asarray(i) if i is not None else None for i in inits])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_table_matches_scan_down(dtype):
    tdt, jdt = DTYPES[dtype]
    bufs, inits = _inputs(3 + (dtype == "bfloat16"))
    want = _jax_scans(bufs, inits, jdt)

    vols = [torch.from_numpy(b["vol"]).to(tdt) for b in bufs]
    scales = [torch.from_numpy(np.where(b["sel"], 0.25, 1.0).astype(np.float32)) for b in bufs]
    masks = [torch.from_numpy(b["mask"].astype(np.float32)) for b in bufs]
    outs = [torch.full_like(v, -7.0) for v in vols]        # columns no scan covers stay -7
    edges = [torch.empty((D, width), dtype=tdt) if edge else None
             for _, _, width, _, _, _, edge in SCANS]
    table = [ChunkScan(vols[b], scales[b], outs[b], lo, width, reverse,
                       torch.from_numpy(init).to(tdt) if init is not None else None,
                       masks[b] if masked else None, edge)
             for (b, lo, width, masked, _, reverse, _), init, edge in zip(SCANS, inits, edges)]
    sgm.sgm_scan_table(table, 1.0, 3.0)                    # CPU tensors: the plain version

    covered = [torch.zeros(w, dtype=torch.bool) for _, w in BUFFERS]
    for (b, lo, width, _, _, reverse, _), got_edge, ref in zip(SCANS, edges, want):
        got = outs[b][:, :, lo:lo + width]
        assert got.dtype == tdt
        np.testing.assert_array_equal(_bits(got), _jbits(ref))
        if got_edge is not None:                           # the row the next band starts from
            row = 0 if reverse else -1
            np.testing.assert_array_equal(_bits(got_edge), _jbits(ref[:, row]))
        covered[b][lo:lo + width] = True
    for out, cov in zip(outs, covered):
        assert bool((out[:, :, ~cov] == -7.0).all())


def test_table_kernel_refuses_cpu_tensors():
    """The wrapper launches the kernel on CUDA tensors only; the dispatch
    in ops/sgm.py is what takes the plain version for CPU ones."""
    vol = torch.zeros((D, 4, 5))
    sc = ChunkScan(vol, torch.ones((4, 5)), torch.empty_like(vol), 0, 5)
    with pytest.raises(ValueError, match="CUDA"):
        ck.sgm_scan_table([sc], 1.0, 3.0)


@pytest.mark.parametrize("widths,lines", [
    ([125, 125, 219, 219, 219, 219], 16),   # a banded sgm8_full chunk step: 284 blocks at 4
    ([175, 175], 4),                        # a banded frame A chunk step: 88 blocks at 4
    ([125], 4), ([1000], 16),
    ([528], 4), ([529], 16),                # 132 blocks at 4 columns, then 133
])
def test_scan_table_lines(monkeypatch, widths, lines):
    """4 columns a block where the launch's blocks at 4 fit on the card's
    SMs (an H100's 132 here), else 16."""
    dev = torch.device("cuda", 0)
    monkeypatch.setitem(ck._sm_count, dev, 132)
    assert ck.scan_table_lines(widths, dev) == lines
