"""vmTop: top-M candidate extraction and the neighbour-supported vote.

Counterpart of ``mystereomatching_tpu/ops/vmtop.py``: the reference's
``selectTopCostFromVolumn`` (stereoMatching.h:2405-2461) as M rounds of
masked argmin, and ``genDispFromTopCostVm2`` (cpp:1514-1885): method 0,
the pair-consistency circle and the 8-neighbour vote, iterated as
``n_iters`` Jacobi sweeps as the JAX package does; methods 1 and 2, exact,
with their dependency on the previous column's decision a loop over the
columns. Ties go as in the JAX package: argmin and argmax take the first
occurrence (``torch.argmin``/``torch.argmax`` do, and both take a NaN as
the extreme), the ``c < first * thres`` test and the vote's ``order_key``
round in float32. The JAX module has no Pallas kernel, so neither has
this: every operation is plain torch on the volume's device.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _shift2d(x: torch.Tensor, dv: int, du: int, fill) -> torch.Tensor:
    """out[..., v, u] = x[..., v + dv, u + du], ``fill`` off the image (the
    JAX package's ``refine._shift2d``)."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    if abs(dv) >= h or abs(du) >= w:
        return out
    out[..., max(0, -dv): h - max(0, dv), max(0, -du): w - max(0, du)] = \
        x[..., max(0, dv): h - max(0, -dv), max(0, du): w - max(0, -du)]
    return out


def select_top_costs(vol: torch.Tensor, m: int, thres: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to m candidates a pixel (h:2405-2461): (disp int32 [m, H, W], cost
    [m, H, W], count int32 [H, W]). Candidate k > 0 counts while each
    candidate so far has cost < cost_0 * thres; the slots past the break
    hold the later argmins all the same."""
    v = vol
    ds = torch.arange(vol.shape[0], device=vol.device)[:, None, None]
    disps, costs = [], []
    count = torch.ones(vol.shape[1:], dtype=torch.int32, device=vol.device)
    alive = torch.ones(vol.shape[1:], dtype=torch.bool, device=vol.device)
    first = None
    for k in range(m):
        d = torch.argmin(v, 0)
        c = v.amin(0)
        if k == 0:
            first = c
        else:
            alive = alive & (c < first * thres)
            count = count + alive.to(torch.int32)
        disps.append(d.to(torch.int32))
        costs.append(c)
        v = torch.where(ds == d[None], torch.inf, v)
    return torch.stack(disps), torch.stack(costs), count


# 8-neighbour offsets: l, u, r, d, lu, rd, ru, ld (cpp:1532-1534)
_NEIGH = ((0, -1), (-1, 0), (0, 1), (1, 0), (-1, -1), (1, 1), (-1, 1), (1, -1))


def disp_from_top_method0(cand_d: torch.Tensor, cand_c: torch.Tensor, count: torch.Tensor,
                          cfg, n_iters: int = 2) -> torch.Tensor:
    """Method 0 (cpp:1518-1781), Jacobi-iterated: where the pair-consistency
    container is empty, the candidate closest to a decided neighbour (lt,
    left, up, rt, in that priority); else the container candidate with the
    most 8-neighbour support, then the least total cost, then the smaller
    disparity. The first row and column keep candidate 0. cand_d/cand_c:
    [M, H, W]; count: [H, W] valid candidates."""
    m, h, w = cand_d.shape
    dev = cand_d.device
    ts = cfg.vmtop_ts
    valid_k = torch.arange(m, device=dev)[:, None, None] < count[None]
    in_cont = [torch.zeros((h, w), dtype=torch.bool, device=dev) for _ in range(m)]
    for i in range(m):
        for j in range(i + 1, m):
            pair_ok = ((cand_d[i] - cand_d[j]).abs() < ts) & valid_k[j] & valid_k[i]
            in_cont[i] = in_cont[i] | pair_ok
            in_cont[j] = in_cont[j] | pair_ok
    in_cont = torch.stack(in_cont)
    any_cont = in_cont.any(0)
    vv = torch.arange(h, device=dev)[:, None]
    uu = torch.arange(w, device=dev)[None, :]
    edge = (vv == 0) | (uu == 0)
    big = torch.full((h, w), 1 << 30, dtype=torch.int32, device=dev)
    none = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    disp = cand_d[0]
    for _ in range(n_iters):
        refs = [_shift2d(disp, dv, du, -10000) for dv, du in ((-1, -1), (0, -1), (-1, 0), (-1, 1))]
        best_dif = [big] * len(refs)
        best_d = [none] * len(refs)
        for k in range(m):
            for ri, rdisp in enumerate(refs):
                dif = (cand_d[k] - rdisp).abs()
                better = valid_k[k] & (dif < best_dif[ri])
                best_dif[ri] = torch.where(better, dif, best_dif[ri])
                best_d[ri] = torch.where(better, cand_d[k], best_d[ri])
        overall = torch.minimum(torch.minimum(best_dif[0], best_dif[1]),
                                torch.minimum(best_dif[2], best_dif[3]))
        case2 = torch.where(overall == best_dif[0], best_d[0],
                            torch.where(overall == best_dif[1], best_d[1],
                                        torch.where(overall == best_dif[2], best_d[2],
                                                    best_d[3])))
        vote_n = [in_cont[i].to(torch.int32) for i in range(m)]
        vote_c = [torch.where(in_cont[i], cand_c[i], 0.0) for i in range(m)]
        for dv, du in _NEIGH:
            for x in range(m):
                nd = _shift2d(cand_d[x], dv, du, -1)
                nc = _shift2d(cand_c[x], dv, du, 0.0)
                n_valid = _shift2d(valid_k[x], dv, du, False)
                for i in range(m):
                    match = in_cont[i] & n_valid & (nd == cand_d[i])
                    vote_n[i] = vote_n[i] + match.to(torch.int32)
                    vote_c[i] = vote_c[i] + torch.where(match, nc, 0.0)
        vote_n, vote_c = torch.stack(vote_n), torch.stack(vote_c)
        order_key = (vote_n.to(torch.float32) * 1e6 - vote_c / (1.0 + vote_c)
                     - cand_d.to(torch.float32) * 1e-3)
        kbest = torch.argmax(torch.where(in_cont, order_key, -torch.inf), 0)
        case3 = torch.gather(cand_d, 0, kbest[None])[0]
        new_disp = torch.where(count > 1, torch.where(any_cont, case3, case2), cand_d[0])
        disp = torch.where(edge, cand_d[0], new_disp)
    return disp


def disp_from_top_method1(cand_d: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Method 1 (cpp:1786-1817): along each row, the valid candidate within
    |d - d(u-1)| < 2 closest to the previous decision, else candidate 0."""
    m, h, w = cand_d.shape
    big = torch.full((h,), 10000, dtype=torch.int32, device=cand_d.device)
    none = torch.full((h,), -1, dtype=torch.int32, device=cand_d.device)
    cols = [cand_d[0, :, 0]]
    for u in range(1, w):
        prev, n = cols[-1], count[:, u]
        best_s, best_d = big, none
        for k in range(m):
            s = (prev - cand_d[k, :, u]).abs()
            ok = (k < n) & (s < 2) & (s < best_s)
            best_s = torch.where(ok, s, best_s)
            best_d = torch.where(ok, cand_d[k, :, u], best_d)
        cols.append(torch.where((n == 1) | (best_d < 0), cand_d[0, :, u], best_d))
    return torch.stack(cols, 1)


def disp_from_top_method2(cand_d: torch.Tensor, count: torch.Tensor,
                          left_image: torch.Tensor) -> torch.Tensor:
    """Method 2 (cpp:1819-1883): along each row, d0 = the candidate closest
    to the previous decision and d1 = the one closest to the next pixel's
    candidate 0 (u < W-1), each within 2; one of them found: it; neither:
    candidate 0; both: the side whose colour is nearer (sum |dRGB|, ties to
    d0). Only d0 depends on the previous decision, in a loop over the
    columns; the rest is computed for the whole image."""
    m, h, w = cand_d.shape
    dev = cand_d.device
    valid_k = torch.arange(m, device=dev)[:, None, None] < count[None]
    nxt = F.pad(cand_d[0, :, 1:], (0, 1), value=-10000)
    dif1 = torch.where(valid_k, (cand_d - nxt[None]).abs(), 10000)
    k1 = torch.argmin(dif1, 0)
    d1_val = torch.gather(cand_d, 0, k1[None])[0]
    d1_ok = (torch.gather(dif1, 0, k1[None])[0] < 2) & (torch.arange(w, device=dev)[None, :] < w - 1)
    img = left_image.to(torch.int32)
    cl = (img[:, 1:] - img[:, :-1]).abs().sum(-1)
    prefer_d0 = F.pad(cl, (1, 0)) <= F.pad(cl, (0, 1))
    cols = [cand_d[0, :, 0]]
    for u in range(1, w):
        cands, vkc = cand_d[:, :, u], valid_k[:, :, u]
        dif0 = torch.where(vkc, (cands - cols[-1][None]).abs(), 10000)
        kk = torch.argmin(dif0, 0)
        d0v = torch.gather(cands, 0, kk[None])[0]
        d0ok = torch.gather(dif0, 0, kk[None])[0] < 2
        d1v, d1ok = d1_val[:, u], d1_ok[:, u]
        pick = torch.where(d0ok & ~d1ok, d0v,
                           torch.where(~d0ok & d1ok, d1v,
                                       torch.where(d0ok & d1ok,
                                                   torch.where(prefer_d0[:, u], d0v, d1v),
                                                   cands[0])))
        cols.append(torch.where(count[:, u] == 1, cands[0], pick))
    return torch.stack(cols, 1)


def disp_from_top(vol: torch.Tensor, left_image: torch.Tensor, cfg,
                  method: int = 0) -> torch.Tensor:
    """The vmTop decision (dispOptimize cpp:1112-1126) of a [D, H, W]
    volume: int32 [H, W]."""
    cand_d, cand_c, count = select_top_costs(vol, max(cfg.vmtop_num, 2), cfg.vmtop_thres)
    if method == 0:
        return disp_from_top_method0(cand_d, cand_c, count, cfg)
    if method == 1:
        return disp_from_top_method1(cand_d, count)
    if method == 2:
        return disp_from_top_method2(cand_d, count, left_image)
    raise ValueError(f"vmTop method {method} not supported")
