"""Census transforms (default censusFunc=3, and the NL path's 80-bit
code) and their Hamming cost volume.

Counterpart of ``mystereomatching_tpu/ops/census.py`` (``_census_bits_ncsur``,
``census_code_ncsur``, ``census_code_qx80``, ``hamming_volume``). Bit
semantics are the same. The default code:
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


def census_bits_ncsur(gray: torch.Tensor, rv: int = 3, ru: int = 4) -> List[torch.Tensor]:
    """The (2rv+1)(2ru+1) + 8 census bit planes, [H, W] bool each."""
    h, w = gray.shape
    g = gray.to(torch.int32)
    pad = _reflect_pad(gray, rv, ru).to(torch.int32)

    def at(dv, du):
        return pad[rv + dv: rv + dv + h, ru + du: ru + du + w]

    bits = [g < at(dv, du)
            for dv in range(-rv, rv + 1) for du in range(-ru, ru + 1)]
    for i in range(8):
        bits.append(at(_SUR_DV[i], _SUR_DU[i]) < at(_SUR_DV[i + 1], _SUR_DU[i + 1]))
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
        cost = cost / default
        fill = 1.0
    mask = valid_mask(code_left.shape[-1], num_disp, lor, cost.device, disps)
    return torch.where(mask, cost, torch.tensor(fill, dtype=cost.dtype,
                                                device=cost.device))
