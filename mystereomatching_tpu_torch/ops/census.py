"""Census transforms (the six ``censusFunc`` codes and the NL path's
80-bit code) and their Hamming cost volume.

Counterpart of ``mystereomatching_tpu/ops/census.py`` (``_window_bits``
and ``_census_bits_ncsur``, both :func:`census_bits_ncsur`;
``census_code_ncsur``, ``census_code_classic``, ``census_code_symmetric``,
``_neigh_c1_pairs``, ``_neigh_c2_pairs``, ``_pair_code``,
``census_code_neighbor``, ``neigh_code_length``, ``census_code_mean``,
``census_code_qx80``, ``hamming_volume``). Bit
semantics are the same. The default code (censusFunc=3):
window bits ``center < neighbor`` over the (2rv+1)x(2ru+1) window in row
order, then 8 surround-ring pair bits ``I[p+s_i] < I[p+s_{i+1}]``, with
reflect-101 borders.

torch has no popcount, and on the CPU ``>>`` is not implemented for uint32,
so the bits are packed into int64 words and the Hamming distance counts
the bytes of the XORed words through a 256-entry table: exact on every
device. The JAX package has no Pallas kernel here, so neither does this.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from mystereomatching_tpu_torch.ops.volume import shifted_stack, valid_mask

_SUR_DV = (-1, -1, -1, 0, 1, 1, 1, 0, -1)
_SUR_DU = (-1, 0, 1, 1, 1, 0, -1, -1, -1)

POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.int32)


def _reflect_pad(gray: torch.Tensor, rv: int, ru: int) -> torch.Tensor:
    """Reflect-101 padding (numpy/jnp ``mode="reflect"``) of an [H, W] plane."""
    return F.pad(gray.to(torch.float32)[None, None], (ru, ru, rv, rv),
                 mode="reflect")[0, 0]


def _offsets_classic(rv: int, ru: int):
    return [(dv, du) for dv in range(-rv, rv + 1) for du in range(-ru, ru + 1)]


def _shifted(gray: torch.Tensor, rv: int, ru: int):
    """``at(dv, du)``: the int32 [H, W] plane of I(p + (dv, du)), |dv| <= rv,
    |du| <= ru, reflect-101 extended. The pad is taken on exact integers
    (float32 holds every gray level) and cast back before any compare."""
    h, w = gray.shape
    pad = _reflect_pad(gray, rv, ru).to(torch.int32)
    return lambda dv, du: pad[rv + dv: rv + dv + h, ru + du: ru + du + w]


def census_bits_ncsur(gray: torch.Tensor, rv: int = 3, ru: int = 4,
                      surround: bool = True) -> List[torch.Tensor]:
    """The (2rv+1)(2ru+1) classic window bits ``center < neighbor`` in row
    order, then (``surround``) the 8 surround-ring pair bits, [H, W] bool
    each."""
    g = gray.to(torch.int32)
    at = _shifted(gray, rv, ru)
    bits = [g < at(dv, du) for dv, du in _offsets_classic(rv, ru)]
    if surround:
        bits += [at(_SUR_DV[i], _SUR_DU[i]) < at(_SUR_DV[i + 1], _SUR_DU[i + 1])
                 for i in range(8)]
    return bits


def pack_bits(bits: List[torch.Tensor]) -> torch.Tensor:
    """Pack [H, W] bool planes into [n_words, H, W] int64 (bit i of the
    code is bit i % 64 of word i // 64)."""
    words = []
    for start in range(0, len(bits), 64):
        acc = torch.zeros(bits[0].shape, dtype=torch.int64, device=bits[0].device)
        for pos, b in enumerate(bits[start:start + 64]):
            acc |= b.to(torch.int64) << pos
        words.append(acc)
    return torch.stack(words)


def census_code_ncsur(gray: torch.Tensor, rv: int = 3, ru: int = 4) -> torch.Tensor:
    """Packed default census code, [n_words, H, W] int64."""
    return pack_bits(census_bits_ncsur(gray, rv, ru))


def census_code_classic(gray: torch.Tensor, rv: int, ru: int) -> torch.Tensor:
    """Classic window-compare census (censusFunc=0, genCensusCode h:634-688)."""
    return pack_bits(census_bits_ncsur(gray, rv, ru, surround=False))


def census_code_symmetric(gray: torch.Tensor, rv: int, ru: int) -> torch.Tensor:
    """Symmetric census (censusFunc=4, genSymCensus h:1174-1208): over the
    full window, bit = I(p+o) <= I(p-o) (non-strict; the centre bit is
    always 1). Pixels within the rv/ru border band keep an all-zero code, as
    the reference skips them."""
    h, w = gray.shape
    at = _shifted(gray, rv, ru)
    code = pack_bits([at(dv, du) <= at(-dv, -du) for dv, du in _offsets_classic(rv, ru)])
    v = torch.arange(h, device=gray.device)[:, None]
    u = torch.arange(w, device=gray.device)[None, :]
    inner = (v >= rv) & (v < h - rv) & (u >= ru) & (u < w - ru)
    return torch.where(inner[None], code, torch.zeros_like(code))


def _neigh_c1_pairs(rv: int, ru: int):
    """Pair offsets of genCensusCode_neighC1 (h:691-791): clockwise ring
    walks comparing consecutive ring pixels, min(rv, ru) rings deep, then a
    horizontal remainder row. The remainder keeps the reference's quirk: it
    indexes the padded image without re-adding the (rv, ru) offset
    (h:769-784), so it compares pixels of row -rv at columns du - ru; its
    read one column left of the buffer at the left edge is taken from the
    reflect-101 extension."""
    pairs = []
    loop_num = min(rv, ru)
    for i in range(loop_num):
        vpos, upos = -(rv - i), -(ru - i)
        for loop_ in range(4):
            if loop_ % 2 == 0:
                cof = -1 if upos > 0 else 1
                du = upos
                while du != -upos:
                    pairs.append(((vpos, du), (vpos, du + cof)))
                    du += cof
                upos = -upos
            else:
                cof = -1 if vpos > 0 else 1
                dv = vpos
                while dv != -vpos:
                    pairs.append(((dv, upos), (dv + cof, upos)))
                    dv += cof
                vpos = -vpos
    urem = ru - loop_num
    for du in range(-urem, urem):
        pairs.append(((-rv, du - ru), (-rv, du + 1 - ru)))
    return pairs


def _neigh_c2_pairs(rv: int, ru: int):
    """Pair offsets of genCensusCode_neighC2 (h:793-864): a serpentine scan
    of the window comparing consecutive samples along the path, the
    vertical hop between rows included."""
    pairs = []
    u_start, u_end = -ru, ru
    cof = 1
    for dv in range(-rv, rv + 1):
        u_ = u_start
        while u_ != u_end:
            pairs.append(((dv, u_), (dv, u_ + cof)))
            u_ += cof
        if dv < rv:
            pairs.append(((dv, u_end), (dv + 1, u_end)))
        u_start, u_end, cof = u_end, u_start, -cof
    return pairs


def _pair_code(gray: torch.Tensor, pairs) -> torch.Tensor:
    """bit = I(p+a) < I(p+b) for each (a, b) offset pair, reflect-101
    extended as far as the pairs reach."""
    pv = max(max(abs(a[0]), abs(b[0])) for a, b in pairs)
    pu = max(max(abs(a[1]), abs(b[1])) for a, b in pairs)
    at = _shifted(gray, pv, pu)
    return pack_bits([at(*a) < at(*b) for a, b in pairs])


def census_code_neighbor(gray: torch.Tensor, rv: int, ru: int,
                         variant: int = 1) -> torch.Tensor:
    """Neighbour-compare census (censusFunc=1: the ring walk, neighC1; 2:
    the serpentine, neighC2): each bit compares consecutive pixels of the
    walk instead of a pixel with the centre."""
    return _pair_code(gray, _neigh_c1_pairs(rv, ru) if variant == 1 else _neigh_c2_pairs(rv, ru))


def neigh_code_length(rv: int, ru: int, variant: int) -> int:
    return len(_neigh_c1_pairs(rv, ru) if variant == 1 else _neigh_c2_pairs(rv, ru))


def census_code_mean(gray: torch.Tensor, rv: int, ru: int) -> torch.Tensor:
    """Mean census (censusFunc=5, genCensus cpp:5309-5351): each window
    pixel against the window's integer mean, bit = mean < neighbour. As the
    reference, the mean is taken over the window centred at (v+rv, u+ru),
    shifted down and right, reads past the image taken from the reflect-101
    extension, and floored: ``ssum // area`` on the exact int32 sum of the
    non-negative gray levels."""
    h, w = gray.shape
    at2 = _shifted(gray, 2 * rv, 2 * ru)
    ssum = torch.zeros((h, w), dtype=torch.int32, device=gray.device)
    for dv, du in _offsets_classic(rv, ru):
        ssum = ssum + at2(rv + dv, ru + du)
    mean = ssum // ((2 * rv + 1) * (2 * ru + 1))
    at = _shifted(gray, rv, ru)
    return pack_bits([mean < at(dv, du) for dv, du in _offsets_classic(rv, ru)])


def census_code_qx80(rgb: torch.Tensor) -> torch.Tensor:
    """The NL path's 80-bit census code (my_matching_cost_from_cencus,
    qx_nonlocal_cost_aggregation.cpp:110-189): the 9x9 window without its
    centre, bit = centre > neighbour, with wraparound borders (the
    reference indexes (y+wy+h)%h, (x+wx+w)%w: ``torch.roll``). Its gray
    keeps the reference's channel quirk, (9798 B + 19235 G + 3735 R +
    2^14) >> 15 of an RGB [H, W, 3] image. Returns [2, H, W] int64 (bits
    0-63 and 64-79, in the JAX package's bit order; its [3, H, W] uint32
    words hold the same bits)."""
    r, g, b = (rgb[..., c].to(torch.int32) for c in range(3))
    gray = (9798 * b + 19235 * g + 3735 * r + (1 << 14)) >> 15
    return pack_bits([gray > torch.roll(gray, (-wy, -wx), (0, 1))
                      for wy in range(-4, 5) for wx in range(-4, 5) if wy or wx])


def ncsur_code_length(rv: int, ru: int) -> int:
    return (2 * rv + 1) * (2 * ru + 1) + 8


def popcount(words: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 in ``words`` [..., W], as int32 [..., W];
    ``lut`` is the byte table ``POPCOUNT8`` on ``words``' device."""
    counts = lut[words.contiguous().view(torch.uint8).to(torch.int64)]
    return counts.view(*words.shape, 8).sum(-1, dtype=torch.int32)


def hamming_volume(code_left: torch.Tensor, code_right: torch.Tensor,
                   num_disp: int, lor: int, code_length: int,
                   trunc_ratio: float = 1.0, normalize: bool = False,
                   disps=None) -> torch.Tensor:
    """Census cost volume: min(hamming, code_length * trunc_ratio), [D, H, W]
    float32; off-image entries take that cap (1.0 when normalized).
    ``disps``: an int [Db] index of disparities, for the [Db, H, W] block
    of the disparity-streamed volume (each disparity's plane is the dense
    volume's, bit for bit)."""
    ref, other = (code_left, code_right) if lor == 0 else (code_right, code_left)
    sh = shifted_stack(other, num_disp, lor, disps)      # [D, n_words, H, W]
    # one disparity at a time: the byte table lookup widens to int64; the
    # table is copied to the device once, as each copy waits for the device
    lut = POPCOUNT8.to(ref.device)
    ham = torch.stack([popcount(ref ^ sh[d], lut).sum(0) for d in range(sh.shape[0])])
    ham = ham.to(torch.float32)
    default = code_length * trunc_ratio
    cost = torch.clamp(ham, max=default)
    fill = default
    if normalize:
        # a 0-dim divisor: a CUDA tensor divided by a Python number is
        # multiplied by its reciprocal, which rounds otherwise than the CPU
        cost = cost / torch.full((), default, dtype=cost.dtype, device=cost.device)
        fill = 1.0
    mask = valid_mask(code_left.shape[-1], num_disp, lor, cost.device, disps)
    return torch.where(mask, cost, torch.tensor(fill, dtype=cost.dtype,
                                                device=cost.device))
