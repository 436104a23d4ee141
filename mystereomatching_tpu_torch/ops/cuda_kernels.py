"""Hand-written CUDA kernels for Hopper: build, bindings, launch wrappers.

Counterpart of ``mystereomatching_tpu/ops/pallas_kernels.py``. The sources
are ``csrc/*.cu`` (CUDA C++ for ``sm_90a``, one file a kernel, each with a
note on the TPU kernel it replaces) and the headers they share,
``csrc/*.cuh``. At first use they are compiled with ``nvcc`` (one process a
source, all started together, then one link) into one shared library with
a plain C interface under ``build/cuda/`` at the repository root, keyed by
a hash of the sources, headers and flags, and loaded with ctypes.

Each wrapper checks device, dtype, shape and contiguity, allocates the
output, launches on torch's current stream, raises if the launch failed,
and adds one to its entry of :data:`launches`. Wrappers take CUDA tensors
only; the op modules run their plain torch versions for CPU tensors.
Kernels B, C, D and E take float32 or bfloat16 volumes (the JAX package's
``vol_dtype``), each type through an entry point of its own, and refuse
any other dtype. Kernel C's scans along H with a carried-in row or an
in-image mask, which the row-band pipeline runs, are a kernel of their own
(``mysm_sgm_scan_ext``) that takes a table of W-chunk scans a launch
(:func:`sgm_scan_table`, each scan a :class:`ChunkScan`) and writes into
the caller's buffers in place, counted apart as ``sgm_scan_ext``, its scans
in :data:`launches_scans`.
Region vote's unanimity form runs one pass a launch (``csrc/region_vote.cu``);
``arm_reduce`` (``csrc/arm_reduce.cu``), the single-axis integer
reduction it was built from, sums the histogram region votes' one-hot
stacks, two launches a pass.
``copy_bw`` (``csrc/copy_bw.cu``), the gather and prefix-sum probes
``gather_rows``, ``gather_cols``, ``cumsum_rows`` and ``cumsum_cols``
(``csrc/plane_probes.cu``) and the SGM-layout probes ``sgm_probe_hdw``,
``sgm_probe_g``, ``sgm_probe_rolled`` and ``sgm_probe_unrolled``
(``csrc/sgm_probes.cu``) and the taps probes ``taps_probe_roll``,
``taps_probe_slice``, ``taps_probe_clones`` and ``taps_probe_static``
(``csrc/taps_probes.cu``) are on no pipeline path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
# -fmad=false keeps a*b+c as two rounded operations, as torch computes it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of each kernel since the last reset_launches(), of either dtype
launches = {"arms_grow": 0, "arm_taps": 0, "sgm_scan": 0, "wta": 0,
            "arm_reduce": 0, "region_vote": 0, "pi_scan": 0, "sgm_diag": 0, "sgm_scan_ext": 0,
            "copy_bw": 0,
            "gather_rows": 0, "gather_cols": 0, "cumsum_rows": 0, "cumsum_cols": 0,
            "sgm_probe_hdw": 0, "sgm_probe_g": 0, "sgm_probe_rolled": 0, "sgm_probe_unrolled": 0,
            "taps_probe_roll": 0, "taps_probe_slice": 0, "taps_probe_clones": 0,
            "taps_probe_static": 0}
# of those, the launches of the bfloat16 instances of kernels B, C, D and E
launches_bf16 = {"arm_taps": 0, "sgm_scan": 0, "wta": 0, "sgm_diag": 0, "sgm_scan_ext": 0}
# the scans of kernel C's table launches (sgm_scan_ext): all of them, those with an
# in-image mask, and of each the bfloat16 ones
launches_scans = {"sgm_scan_ext": 0, "sgm_scan_ext_mask": 0, "sgm_scan_ext_bf16": 0,
                  "sgm_scan_ext_mask_bf16": 0}
SCAN_TABLE_MAX = 32  # scans in one sgm_scan_ext launch (the kernel's kMaxScans)
SCAN_TABLE_LINES = (16, 4)  # the block widths, in columns, it is built for
REDUCE_OPS = {"sum": 0, "min": 1, "max": 2}
MAX_ARM = 127  # the longest arm kernels A and region_vote take (the config's bound)
ARM_DIRECTIONS = ((0, -1), (0, 1), (-1, 0), (1, 0))  # kernel A's walks: L, R, U, D
# the SGM-layout probes: entry point -> (its index, the kinds it takes)
SGM_PROBES = {"sgm_probe_hdw": (0, ("full",)), "sgm_probe_g": (1, ("full",)),
              "sgm_probe_rolled": (2, ("copy", "prev", "full")),
              "sgm_probe_unrolled": (3, ("copy", "full"))}
SGM_PROBE_KINDS = {"copy": 0, "prev": 1, "full": 2}
SGM_PROBE_MAX_G = 4  # volumes in one block of the g, rolled and unrolled probes
SGM_PROBE_P1, SGM_PROBE_P2 = 1.0, 3.0  # the TPU probes' penalties
FLT_MAX = float(torch.finfo(torch.float32).max)
# the taps probes: entry point -> (its index, {kind: (its code, the axes it
# takes, the segment lengths or octaves it takes, () for none)})
TAPS_PROBES = {
    "taps_probe_roll": (0, {"roll": (0, (1, 2), ())}),
    "taps_probe_slice": (1, {"dyn": (0, (1, 2), ()), "fixed": (1, (1,), ()),
                             "seg": (2, (1,), (32, 64))}),
    "taps_probe_clones": (2, {"clones": (0, (1,), ()), "oct": (1, (1,), ()),
                              "clseg": (2, (1,), (32, 64, 96))}),
    "taps_probe_static": (3, {"static": (0, (1,), (8, 16, 34))}),
}
TAPS_PROBE_MAX_LINE = 512  # roll: the longest line it holds in registers
TAPS_PROBE_STATIC_ARM = 34  # static: its compiled max_arm, the TPU probe's

_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "mysm_arms_grow": [_P, _P, _P, _I, _I, _I, _F, _I, _P],
    "mysm_arm_taps": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mysm_sgm_scan": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "mysm_wta": [_P, _P, _I, _I, _I, _I, _P],
    "mysm_arm_reduce": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mysm_region_vote": [_P, _P, _P, _I, _I, _I, _I, _P],
    "mysm_pi_scan": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mysm_sgm_diag": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "mysm_sgm_scan_ext": [_P, _I, _I, _I, _F, _F, _P],
    "mysm_sgm_scan_ext_info": [_I, _I, _I, _P],
    "mysm_copy_bw": [_P, _P, _L, _I, _I, _I, _I, _P],
    "mysm_gather_rows": [_P, _P, _P, _I, _L, _I, _P],
    "mysm_gather_cols": [_P, _P, _P, _I, _L, _I, _P],
    "mysm_cumsum": [_P, _P, _L, _I, _I, _P],
    "mysm_sgm_probe": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    "mysm_taps_probe": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
# the bfloat16 entry points of kernels B, C, D and E: the float32 ones' arguments
_BF16 = ("mysm_arm_taps", "mysm_sgm_scan", "mysm_wta", "mysm_sgm_diag", "mysm_sgm_scan_ext")
_SIGNATURES.update({f"{name}_bf16": _SIGNATURES[name] for name in _BF16})
VOL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for counts in (launches, launches_bf16, launches_scans):
        for name in counts:
            counts[name] = 0


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmysm_kernels_{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the kernels unless a library of the same sources exists.

    Each source is compiled by its own nvcc process, all started together,
    and the objects are linked into one shared library. Returns nvcc's
    report (registers and spills per kernel) when it ran, else "". Raises
    if nvcc is missing or fails."""
    so = library_path()
    if so.exists():
        return ""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs = [tmp / f"{src.stem}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [f"{src.name} ({p.returncode}):\n{log}"
              for src, p, log in zip(_sources(), procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    lib = tmp / so.name
    res = subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(lib, so)
    shutil.rmtree(tmp, ignore_errors=True)
    return "".join(logs)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t: torch.Tensor, what: str, dtype, shape=None, device=None) -> None:
    """dtype: one torch dtype, or a tuple of those accepted."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"{what}: must not be empty")


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    launches[name] += 1


def _launch_vol(name: str, lib: ctypes.CDLL, entry: str, vol: torch.Tensor, *args) -> None:
    """Launches kernel ``name`` through ``entry`` or, for a bfloat16 vol,
    ``entry``_bf16, with vol's pointer first."""
    bf16 = vol.dtype == torch.bfloat16
    _launch(name, getattr(lib, f"{entry}_bf16" if bf16 else entry), vol.data_ptr(), *args)
    if bf16:
        launches_bf16[name] += 1


def arms_grow(img: torch.Tensor, sched: Sequence[float], neigh_thresh: float,
              min_arm: int, directions=ARM_DIRECTIONS) -> torch.Tensor:
    """Kernel A. img: [H, W, 3] float32 -> int32 [4, H, W] arms (L, R, U, D);
    the anchor schedule (1 to 127 thresholds, rounded to float32) goes to
    the kernel as a launch parameter, with no copy to the card. It walks the
    four axis directions only: any other ``directions`` (the tilted arms)
    raise, as the JAX package sends only those four to its Pallas kernel."""
    if tuple(map(tuple, directions)) != ARM_DIRECTIONS:
        raise ValueError(f"arms_grow: grows the axis directions {ARM_DIRECTIONS} only, "
                         f"not {tuple(directions)}")
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"arms_grow: expected [H, W, 3], got {tuple(img.shape)}")
    _check(img, "arms_grow img", torch.float32)
    if not 1 <= len(sched) <= MAX_ARM:
        raise ValueError(f"arms_grow: a schedule of {len(sched)} thresholds, not 1 to {MAX_ARM}")
    lib = _load()
    h, w = img.shape[:2]
    with torch.cuda.device(img.device):
        out = torch.empty((4, h, w), dtype=torch.int32, device=img.device)
        _launch("arms_grow", lib.mysm_arms_grow, img.data_ptr(),
                (ctypes.c_float * len(sched))(*sched), out.data_ptr(), h, w, len(sched),
                float(neigh_thresh), int(min_arm))
    return out


def arm_taps(vol: torch.Tensor, arm_neg: torch.Tensor, arm_pos: torch.Tensor,
             axis: int, max_arm: int, an1: Optional[torch.Tensor] = None,
             ap1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel B. Arm-bounded sum of vol [D, H, W] float32 or bfloat16 along
    H (axis 1) or W (axis 2) with int8 [D, H, W] arms; with an1/ap1 (area
    mode) the sum is divided by the summed support count of those
    first-pass arms. The output has vol's dtype."""
    if vol.ndim != 3 or axis not in (1, 2):
        raise ValueError(f"arm_taps: expected [D, H, W] and axis 1 or 2, got "
                         f"{tuple(vol.shape)}, axis {axis}")
    if not 0 <= max_arm <= 127:
        raise ValueError(f"arm_taps: max_arm {max_arm} outside [0, 127]")
    if (an1 is None) != (ap1 is None):
        raise ValueError("arm_taps: area mode needs both an1 and ap1")
    _check(vol, "arm_taps vol", VOL_DTYPES)
    arms = [arm_neg, arm_pos] + ([an1, ap1] if an1 is not None else [])
    for a in arms:
        _check(a, "arm_taps arms", torch.int8, vol.shape, vol.device)
    lib = _load()
    d, h, w = vol.shape
    with torch.cuda.device(vol.device):
        out = torch.empty_like(vol)
        _launch_vol("arm_taps", lib, "mysm_arm_taps", vol, arm_neg.data_ptr(),
                    arm_pos.data_ptr(), an1.data_ptr() if an1 is not None else None,
                    ap1.data_ptr() if ap1 is not None else None, out.data_ptr(),
                    d, h, w, int(axis == 2), int(max_arm))
    return out


def sgm_scan(vol: torch.Tensor, pscale: torch.Tensor, p1: float, p2: float,
             axis: int, reverse: bool, init: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel C. SGM path costs of vol [G, D, H, W] float32 or bfloat16
    (D <= 256, the output in vol's dtype) scanned along H (axis 2) or W
    (axis 3), from the far end when ``reverse``; pscale: [G, H, W] float32
    penalty scale.

    Along H only, as the row-band pipeline scans: init [G, D, W] in vol's
    dtype is the carry before the first step (instead of zeros), and mask
    [G, H, W] (0s and 1s, float32 or vol's dtype) multiplies every path
    cost. Either launches ``sgm_scan_ext`` once, a table of one scan a
    volume (:func:`sgm_scan_table`)."""
    if vol.ndim != 4 or axis not in (2, 3):
        raise ValueError(f"sgm_scan: expected [G, D, H, W] and axis 2 or 3, got "
                         f"{tuple(vol.shape)}, axis {axis}")
    g, d, h, w = vol.shape
    if d > 256:
        raise ValueError(f"sgm_scan: D={d} exceeds 256")
    _check(vol, "sgm_scan vol", VOL_DTYPES)
    _check(pscale, "sgm_scan pscale", torch.float32, (g, h, w), vol.device)
    if init is not None or mask is not None:
        return _sgm_scan_ext(vol, pscale, p1, p2, axis, reverse, init, mask)
    lib = _load()
    with torch.cuda.device(vol.device):
        out = torch.empty_like(vol)
        _launch_vol("sgm_scan", lib, "mysm_sgm_scan", vol, pscale.data_ptr(),
                    out.data_ptr(), g, d, h, w, int(axis == 3), int(bool(reverse)),
                    float(p1), float(p2))
    return out


def _sgm_scan_ext(vol, pscale, p1, p2, axis, reverse, init, mask) -> torch.Tensor:
    """Kernel C along H with a carried-in row and/or an in-image mask: a
    table of G whole-width scans, one a volume."""
    if axis != 2:
        raise ValueError("sgm_scan: init and mask are taken along H (axis 2) only")
    g, d, h, w = vol.shape
    if init is not None:
        _check(init, "sgm_scan init", vol.dtype, (g, d, w), vol.device)
    if mask is not None:
        _check(mask, "sgm_scan mask", (torch.float32, vol.dtype), (g, h, w), vol.device)
        mask = mask.to(torch.float32)  # 0 and 1 are exact in either type
    with torch.cuda.device(vol.device):
        out = torch.empty_like(vol)
    sgm_scan_table([ChunkScan(vol[i], pscale[i], out[i], 0, w, bool(reverse),
                              init[i] if init is not None else None,
                              mask[i] if mask is not None else None) for i in range(g)],
                   p1, p2)
    return out


@dataclasses.dataclass
class ChunkScan:
    """One scan down (or, ``reverse``, up) the columns lo .. lo + width - 1
    of a [D, h, Ws] buffer of costs ``vol`` (float32 or bfloat16), with its
    [h, Ws] float32 penalty scales ``pscale``, into the same columns of
    ``out`` (vol's shape and dtype), in place.

    init: the [D, width] carry before the first step (vol's dtype), or None
    for zeros. mask: an [h, Ws] in-image mask of 0s and 1s (float32 for the
    kernel; the plain version takes vol's dtype too), multiplying every
    path cost, or None. edge: a [D, width] row (vol's dtype) that receives
    the last row scanned (row h - 1, or row 0 when reverse): the one the
    next band starts from."""

    vol: torch.Tensor
    pscale: torch.Tensor
    out: torch.Tensor
    lo: int
    width: int
    reverse: bool = False
    init: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    edge: Optional[torch.Tensor] = None


_sm_count = {}


def scan_table_lines(widths: Sequence[int], device: torch.device) -> int:
    """The block width of a table launch of chunks ``widths`` columns wide:
    4 columns where its blocks, one a band of 4 columns, fit on the card's
    SMs one a block, else 16. A launch of few blocks walks its rows faster
    the fewer warps share an SM; one that would not fit, with fewer and
    wider blocks (measured on an H100: PERF.md, section 6)."""
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return 4 if sum(-(-w // 4) for w in widths) <= _sm_count[device] else 16


def _scan_table_desc(scans: Sequence[ChunkScan]):
    """Checks a table of scans for kernel C's table kernel (1 to 32, all of
    one dtype and one D <= 256, on one card) and packs it: (the int64
    fields of each scan for ``mysm_sgm_scan_ext``, D, dtype, masked scans)."""
    if not 1 <= len(scans) <= SCAN_TABLE_MAX:
        raise ValueError(f"sgm_scan_table: {len(scans)} scans, not 1 to {SCAN_TABLE_MAX}")
    first = scans[0].vol
    _check(first, "sgm_scan_table vol", VOL_DTYPES)
    dtype, dev, d = first.dtype, first.device, first.shape[0] if first.ndim == 3 else 0
    if not 1 <= d <= 256:
        raise ValueError(f"sgm_scan_table: expected vol [D <= 256, h, Ws], got "
                         f"{tuple(first.shape)}")
    desc, masked = [], 0
    for sc in scans:
        _check(sc.vol, "sgm_scan_table vol", dtype, device=dev)
        if sc.vol.ndim != 3 or sc.vol.shape[0] != d:
            raise ValueError(f"sgm_scan_table: vol {tuple(sc.vol.shape)}, expected [{d}, h, Ws]"
                             " (one D a table)")
        _, h, ws = sc.vol.shape
        if not (0 <= sc.lo and 1 <= sc.width and sc.lo + sc.width <= ws):
            raise ValueError(f"sgm_scan_table: chunk {sc.lo} .. {sc.lo + sc.width} outside "
                             f"the buffer's {ws} columns")
        _check(sc.pscale, "sgm_scan_table pscale", torch.float32, (h, ws), dev)
        _check(sc.out, "sgm_scan_table out", dtype, sc.vol.shape, dev)
        for name, t in (("init", sc.init), ("edge", sc.edge)):
            if t is not None:
                _check(t, f"sgm_scan_table {name}", dtype, (d, sc.width), dev)
        if sc.mask is not None:
            _check(sc.mask, "sgm_scan_table mask", torch.float32, (h, ws), dev)
            masked += 1
        ptr = [t.data_ptr() + sc.lo * t.element_size() if t is not None else 0
               for t in (sc.vol, sc.pscale, sc.mask)]
        ptr += [sc.init.data_ptr() if sc.init is not None else 0,
                sc.out.data_ptr() + sc.lo * sc.out.element_size(),
                sc.edge.data_ptr() if sc.edge is not None else 0]
        desc += ptr + [h * ws, ws, h, sc.width, int(bool(sc.reverse)), 0]
    return desc, d, dtype, masked


def sgm_scan_table(scans: Sequence[ChunkScan], p1: float, p2: float,
                   lines: Optional[int] = None) -> None:
    """Kernel C's table kernel: every scan of ``scans`` (1 to 32
    :class:`ChunkScan`, all of one dtype and one D <= 256, all on one card)
    in one launch, each writing its chunk of ``out`` and its ``edge`` row
    in place. lines: the block width in columns (16 or 4), or None for
    :func:`scan_table_lines`'s choice."""
    if lines is not None and lines not in SCAN_TABLE_LINES:
        raise ValueError(f"sgm_scan_table: lines {lines} not one of {SCAN_TABLE_LINES}")
    desc, d, dtype, masked = _scan_table_desc(scans)
    dev = scans[0].vol.device
    if lines is None:
        lines = scan_table_lines([sc.width for sc in scans], dev)
    bf16 = "_bf16" if dtype == torch.bfloat16 else ""
    lib = _load()
    with torch.cuda.device(dev):
        _launch("sgm_scan_ext", getattr(lib, "mysm_sgm_scan_ext" + bf16),
                (ctypes.c_longlong * len(desc))(*desc), len(scans), d, int(lines), float(p1),
                float(p2))
    launches_bf16["sgm_scan_ext"] += bool(bf16)
    launches_scans["sgm_scan_ext" + bf16] += len(scans) - masked
    launches_scans["sgm_scan_ext_mask" + bf16] += masked


def scan_table_info(d: int, dtype: torch.dtype, lines: int) -> dict:
    """The table kernel's instance for D disparities of ``dtype`` at
    ``lines`` columns a block: its ring stages, dynamic shared memory
    bytes a block and blocks an SM (the occupancy calculator's)."""
    lib = _load()
    out = (ctypes.c_int * 3)()
    rc = lib.mysm_sgm_scan_ext_info(int(d), int(dtype == torch.bfloat16), int(lines), out)
    if rc != 0:
        raise RuntimeError(f"sgm_scan_ext_info: CUDA error {rc}")
    return dict(ring=out[0], smem_bytes=out[1], blocks_per_sm=out[2])


def wta(vol: torch.Tensor, choose_small: bool = True) -> torch.Tensor:
    """Kernel D. First-occurrence argmin (argmax unless choose_small) over
    D of vol [D, H, W] float32 or bfloat16 -> int32 [H, W]."""
    if vol.ndim != 3:
        raise ValueError(f"wta: expected [D, H, W], got {tuple(vol.shape)}")
    _check(vol, "wta vol", VOL_DTYPES)
    lib = _load()
    d, h, w = vol.shape
    with torch.cuda.device(vol.device):
        out = torch.empty((h, w), dtype=torch.int32, device=vol.device)
        _launch_vol("wta", lib, "mysm_wta", vol, out.data_ptr(), d, h, w,
                    int(bool(choose_small)))
    return out


def arm_reduce(vol: torch.Tensor, arm_neg: torch.Tensor, arm_pos: torch.Tensor,
               axis: int, max_arm: int, op: str) -> torch.Tensor:
    """Kernel B, integer mode. Arm-bounded ``op`` ("sum", "min" or "max")
    of vol [C, H, W] int32 along H (axis 1) or W (axis 2), with int32 [H, W]
    arms shared by every channel."""
    if vol.ndim != 3 or axis not in (1, 2):
        raise ValueError(f"arm_reduce: expected [C, H, W] and axis 1 or 2, got "
                         f"{tuple(vol.shape)}, axis {axis}")
    if op not in REDUCE_OPS:
        raise ValueError(f"arm_reduce: op {op!r} not one of {sorted(REDUCE_OPS)}")
    if max_arm < 0:
        raise ValueError(f"arm_reduce: max_arm {max_arm} < 0")
    _check(vol, "arm_reduce vol", torch.int32)
    for a in (arm_neg, arm_pos):
        _check(a, "arm_reduce arms", torch.int32, vol.shape[1:], vol.device)
    lib = _load()
    c, h, w = vol.shape
    with torch.cuda.device(vol.device):
        out = torch.empty_like(vol)
        _launch("arm_reduce", lib.mysm_arm_reduce, vol.data_ptr(), arm_neg.data_ptr(),
                arm_pos.data_ptr(), out.data_ptr(), c, h, w, int(axis == 2),
                int(max_arm), REDUCE_OPS[op])
    return out


def region_vote(disp: torch.Tensor, arms: torch.Tensor, max_arm: int,
                s_thres: int) -> torch.Tensor:
    """One unanimity region-vote pass of disp [H, W] int32 over the cross
    support of the left image's raw int32 [4, H, W] arms (L, R, U, D), each
    capped at max_arm (0 to 127), in one launch -> a new int32 [H, W] map."""
    if disp.ndim != 2:
        raise ValueError(f"region_vote: expected disp [H, W], got {tuple(disp.shape)}")
    if not 0 <= max_arm <= MAX_ARM:
        raise ValueError(f"region_vote: max_arm {max_arm} outside [0, {MAX_ARM}]")
    h, w = disp.shape
    _check(disp, "region_vote disp", torch.int32)
    _check(arms, "region_vote arms", torch.int32, (4, h, w), disp.device)
    lib = _load()
    with torch.cuda.device(disp.device):
        out = torch.empty_like(disp)
        _launch("region_vote", lib.mysm_region_vote, disp.data_ptr(), arms.data_ptr(),
                out.data_ptr(), h, w, int(max_arm), int(s_thres))
    return out


def pi_scan(disp: torch.Tensor, image: torch.Tensor, offsets: torch.Tensor,
            disp_occ: int) -> torch.Tensor:
    """Proper-interpolation kernel: one 16-direction nearest-valid fill of
    disp [H, W] int32, with image [H, W, 3] float32 and offsets
    [16, depth, 2] int32 (depth <= 256) -> a new int32 [H, W] map."""
    if disp.ndim != 2:
        raise ValueError(f"pi_scan: expected disp [H, W], got {tuple(disp.shape)}")
    if offsets.ndim != 3 or offsets.shape[0] != 16 or offsets.shape[2] != 2 \
            or not 1 <= offsets.shape[1] <= 256:
        raise ValueError(f"pi_scan: expected offsets [16, depth <= 256, 2], got "
                         f"{tuple(offsets.shape)}")
    h, w = disp.shape
    _check(disp, "pi_scan disp", torch.int32)
    _check(image, "pi_scan image", torch.float32, (h, w, 3), disp.device)
    _check(offsets, "pi_scan offsets", torch.int32, device=disp.device)
    lib = _load()
    with torch.cuda.device(disp.device):
        out = torch.empty_like(disp)
        _launch("pi_scan", lib.mysm_pi_scan, disp.data_ptr(), image.data_ptr(),
                offsets.data_ptr(), out.data_ptr(), h, w, offsets.shape[1], int(disp_occ))
    return out


def sgm_diag_scan(vol: torch.Tensor, pscale: torch.Tensor, p1: float, p2: float,
                  rv: int, ru: int) -> torch.Tensor:
    """Kernel E. SGM path costs of vol [G, D, H, W] float32 or bfloat16
    (D <= 256, the output in vol's dtype) along the diagonal with
    predecessor offset (rv, ru), each -1 or +1; pscale: [G, H, W] float32
    penalty scale."""
    if vol.ndim != 4 or rv not in (-1, 1) or ru not in (-1, 1):
        raise ValueError(f"sgm_diag_scan: expected [G, D, H, W] and rv, ru in (-1, 1), "
                         f"got {tuple(vol.shape)}, ({rv}, {ru})")
    g, d, h, w = vol.shape
    if d > 256:
        raise ValueError(f"sgm_diag_scan: D={d} exceeds 256")
    _check(vol, "sgm_diag_scan vol", VOL_DTYPES)
    _check(pscale, "sgm_diag_scan pscale", torch.float32, (g, h, w), vol.device)
    lib = _load()
    with torch.cuda.device(vol.device):
        out = torch.empty_like(vol)
        _launch_vol("sgm_diag", lib, "mysm_sgm_diag", vol, pscale.data_ptr(),
                    out.data_ptr(), g, d, h, w, int(rv), int(ru), float(p1), float(p2))
    return out


def copy_bw(x: torch.Tensor, tile_rows: int, tile_cols: int) -> torch.Tensor:
    """The copy-bandwidth probe: x * 1.0001 of a float32 x [..., W], viewed
    as [rows, W], in tiles of tile_rows x tile_cols elements, a block a
    tile; bulk copies through a ring of shared-memory stages where W and
    tile_cols are multiples of 4 and the buffers 16-byte aligned, floats
    otherwise."""
    if x.ndim < 1 or tile_rows < 1 or tile_cols < 1:
        raise ValueError(f"copy_bw: x {tuple(x.shape)}, tile {tile_rows}x{tile_cols}")
    _check(x, "copy_bw x", torch.float32)
    lib = _load()
    w = x.shape[-1]
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        vec = 4 if (w % 4 == 0 and tile_cols % 4 == 0 and x.data_ptr() % 16 == 0
                    and out.data_ptr() % 16 == 0) else 1
        _launch("copy_bw", lib.mysm_copy_bw, x.data_ptr(), out.data_ptr(), x.numel() // w, w,
                int(tile_rows), int(tile_cols), vec)
    return out


def _gather(name: str, fn, x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    if x.ndim != 2 or idx.ndim != 2 or idx.shape[1 - axis] != x.shape[1 - axis]:
        raise ValueError(f"{name}: expected 2-D x and idx agreeing off axis {axis}, got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    _check(x, f"{name} x", torch.float32)
    _check(idx, f"{name} idx", torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        out = torch.empty(idx.shape, dtype=torch.float32, device=x.device)
        _launch(name, fn, x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[axis],
                idx.numel(), idx.shape[1])
    return out


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather probe along axis 0: out[a, b] = x[idx[a, b], b] of a
    float32 x [R, C] with int32 idx [A, C]; an index outside [0, R) gives
    NaN."""
    return _gather("gather_rows", _load().mysm_gather_rows, x, idx, 0)


def gather_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather probe along axis 1: out[a, b] = x[a, idx[a, b]] of a
    float32 x [A, C] with int32 idx [A, B]; an index outside [0, C) gives
    NaN."""
    return _gather("gather_cols", _load().mysm_gather_cols, x, idx, 1)


def cumsum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The prefix-sum probe: running float32 sums of x [R, C] along axis 0
    (``cumsum_rows``, a thread a column) or 1 (``cumsum_cols``, bands of
    rows staged through shared memory, a thread a row), each added in
    sequential order."""
    if x.ndim != 2 or axis not in (0, 1):
        raise ValueError(f"cumsum: expected a 2-D x and axis 0 or 1, got {tuple(x.shape)}, "
                         f"axis {axis}")
    _check(x, "cumsum x", torch.float32)
    lib = _load()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        _launch("cumsum_rows" if axis == 0 else "cumsum_cols", lib.mysm_cumsum, x.data_ptr(),
                out.data_ptr(), x.shape[0], x.shape[1], int(axis == 0))
    return out


def _sgm_probe(name: str, vol: torch.Tensor, ps: torch.Tensor, kind: str,
               edge: float) -> torch.Tensor:
    entry, kinds = SGM_PROBES[name]
    if kind not in kinds:
        raise ValueError(f"{name}: kind {kind!r} not one of {kinds}")
    if vol.ndim != 4:
        raise ValueError(f"{name}: expected vol [G, H, D, W], got {tuple(vol.shape)}")
    g, h, d, w = vol.shape
    gb = 1 if name == "sgm_probe_hdw" else g  # volumes a block
    if d > 256 or gb > SGM_PROBE_MAX_G or (kind == "full" and 256 * (d + 8) * gb > 227 * 1024):
        raise ValueError(f"{name}: D={d} must be at most 256, G={g} at most "
                         f"{SGM_PROBE_MAX_G} outside hdw, and 256 (D + 8) G bytes of shared "
                         "memory at most 227 KB in full")
    _check(vol, f"{name} vol", torch.float32)
    _check(ps, f"{name} ps", torch.float32, (g, h, w), vol.device)
    lib = _load()
    with torch.cuda.device(vol.device):
        out = torch.empty_like(vol)
        _launch(name, lib.mysm_sgm_probe, vol.data_ptr(), ps.data_ptr(), out.data_ptr(), g, d,
                h, w, entry, SGM_PROBE_KINDS[kind], SGM_PROBE_P1, SGM_PROBE_P2, float(edge))
    return out


def sgm_probe_hdw(vol: torch.Tensor, ps: torch.Tensor) -> torch.Tensor:
    """The SGM scan down H of float32 vol [G, H, D, W] (D <= 256) with
    penalty scales ps [G, H, W], p1 = 1 and p2 = 3, a block a volume's tile
    of 32 columns (``check_sgm3.py``'s ``kern_hdw``; the edge beyond D is
    FLT_MAX)."""
    return _sgm_probe("sgm_probe_hdw", vol, ps, "full", FLT_MAX)


def sgm_probe_g(vol: torch.Tensor, ps: torch.Tensor) -> torch.Tensor:
    """The same scan with all G <= 4 volumes' tile of 32 columns in one
    block (``check_sgm4.py``'s ``kern_g``)."""
    return _sgm_probe("sgm_probe_g", vol, ps, "full", FLT_MAX)


def sgm_probe_rolled(vol: torch.Tensor, ps: torch.Tensor, kind: str) -> torch.Tensor:
    """``check_sgm5.py``'s ``make(kind)``, G <= 4 in a block, the row loop
    rolled: ``prev`` the running c + 0.5 prev, or ``full`` the scan with
    p1 = 1, p2 = 3 and the edge 3.4e38; ``copy``, vol * 1.01, carries
    nothing from row to row and is one streaming pass over the volume, as
    :func:`sgm_probe_unrolled`'s (``ps`` is checked but not read)."""
    return _sgm_probe("sgm_probe_rolled", vol, ps, kind, 3.4e38)


def sgm_probe_unrolled(vol: torch.Tensor, ps: torch.Tensor, kind: str) -> torch.Tensor:
    """``check_sgm5.py``'s ``make_unrolled(kind)``: as
    :func:`sgm_probe_rolled` (``copy`` or ``full``). ``full`` unrolls the
    row loop 8 rows a step at compile time; ``copy``, which carries nothing
    from row to row, is one streaming pass over the volume (``ps`` is
    checked but not read)."""
    return _sgm_probe("sgm_probe_unrolled", vol, ps, kind, 3.4e38)


def _taps_probe(name: str, vol: torch.Tensor, an: torch.Tensor, ap: torch.Tensor, kind: str,
                axis: int, max_arm: int, param: Optional[int] = None) -> torch.Tensor:
    entry, kinds = TAPS_PROBES[name]
    if kind not in kinds:
        raise ValueError(f"{name}: kind {kind!r} not one of {tuple(kinds)}")
    code, axes, params = kinds[kind]
    if axis not in axes:
        raise ValueError(f"{name} {kind}: axis {axis} not one of {axes}")
    if (param not in params) if params else param is not None:
        raise ValueError(f"{name} {kind}: parameter {param} not one of {params}")
    if vol.ndim != 3:
        raise ValueError(f"{name}: expected vol [N, H, W], got {tuple(vol.shape)}")
    if not 0 <= max_arm <= 127:
        raise ValueError(f"{name}: max_arm {max_arm} outside [0, 127]")
    if name == "taps_probe_roll" and vol.shape[axis] > TAPS_PROBE_MAX_LINE:
        raise ValueError(f"{name}: a line of {vol.shape[axis]} exceeds {TAPS_PROBE_MAX_LINE}")
    if name == "taps_probe_static" and max_arm != TAPS_PROBE_STATIC_ARM:
        raise ValueError(f"{name}: max_arm {max_arm} is not its compiled "
                         f"{TAPS_PROBE_STATIC_ARM}")
    _check(vol, f"{name} vol", torch.float32)
    for a in (an, ap):
        _check(a, f"{name} arms", torch.int32, vol.shape, vol.device)
    lib = _load()
    n, h, w = vol.shape
    with torch.cuda.device(vol.device):
        out = torch.empty_like(vol)
        _launch(name, lib.mysm_taps_probe, vol.data_ptr(), an.data_ptr(), ap.data_ptr(),
                out.data_ptr(), n, h, w, entry, code, int(axis), int(max_arm), int(param or 0))
    return out


def taps_probe_roll(vol: torch.Tensor, an: torch.Tensor, ap: torch.Tensor, axis: int,
                    max_arm: int) -> torch.Tensor:
    """``micro3.py``'s ``_kb``: the arm-bounded sum of float32 vol [N, H, W]
    with int32 arms [N, H, W] along H (axis 1) or W (axis 2), the line (at
    most 512 long) in registers, shifted one a step, wrapping at its end
    (``taps_probes.circular_plain``)."""
    return _taps_probe("taps_probe_roll", vol, an, ap, "roll", axis, max_arm)


def taps_probe_slice(vol: torch.Tensor, an: torch.Tensor, ap: torch.Tensor, kind: str,
                     max_arm: int, axis: int = 1, seg: Optional[int] = None) -> torch.Tensor:
    """The zero-padded strip in shared memory read at runtime offsets:
    ``dyn`` (``micro3.py``'s ``_kc``, axis 1 or 2), ``fixed``
    (``_taps_kernel_fixed``, every tap at the aligned base,
    ``taps_probes.fixed_plain``) or ``seg`` (``_taps_kernel_seg``, a trip
    count for each ``seg`` = 32 or 64 rows), the last two along H."""
    return _taps_probe("taps_probe_slice", vol, an, ap, kind, axis, max_arm, seg)


def taps_probe_clones(vol: torch.Tensor, an: torch.Tensor, ap: torch.Tensor, kind: str,
                      max_arm: int, seg: Optional[int] = None) -> torch.Tensor:
    """Four shifted copies of the zero-padded column in shared memory, every
    tap an aligned float4 read of 4 rows, along H: ``clones``
    (``_taps_kernel_clones``), ``oct`` (``_taps_kernel_oct``) or ``clseg``
    (``_taps_kernel_clseg``, a trip count for each ``seg`` = 32, 64 or 96
    rows)."""
    return _taps_probe("taps_probe_clones", vol, an, ap, kind, 1, max_arm, seg)


def taps_probe_static(vol: torch.Tensor, an: torch.Tensor, ap: torch.Tensor,
                      oct_size: int, max_arm: int = TAPS_PROBE_STATIC_ARM) -> torch.Tensor:
    """``micro_cbca5.py``'s ``_taps_kernel_static`` along H: max_arm 34 and
    every tap offset compiled in, each octave of ``oct_size`` (8, 16 or 34)
    taps gated by the block's largest arm."""
    return _taps_probe("taps_probe_static", vol, an, ap, "static", 1, max_arm, oct_size)
