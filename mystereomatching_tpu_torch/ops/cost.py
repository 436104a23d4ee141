"""Matching cost (L1): the censusGrad [D, H, W] cost volume.

Counterpart of the ``census_grad`` branch of
``mystereomatching_tpu/ops/cost.py`` (``central_gradient``, ``grad_volume``,
``exp_fuse2``, ``compute_cost_volume``, ``block_cost_builder``). Images
are float32 in [0, 255]; off-image entries take each cost's default. The
JAX package has no Pallas kernel here, so neither does this.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from mystereomatching_tpu_torch.ops import census as census_ops
from mystereomatching_tpu_torch.ops.volume import shifted_stack, valid_mask


def central_gradient(img: torch.Tensor, axis: int) -> torch.Tensor:
    """0.5*(I[x+1]-I[x-1]) inside; one-sided differences at the borders."""
    g = img.to(torch.float32)
    grad = 0.5 * (torch.roll(g, -1, axis) - torch.roll(g, 1, axis))
    n = g.shape[axis]
    first = g.narrow(axis, 1, 1) - g.narrow(axis, 0, 1)
    last = g.narrow(axis, n - 1, 1) - g.narrow(axis, n - 2, 1)
    grad.narrow(axis, 0, 1).copy_(first)
    grad.narrow(axis, n - 1, 1).copy_(last)
    return grad


def grad_volume(gray_l: torch.Tensor, gray_r: torch.Tensor, num_disp: int,
                lor: int, trunc: float, arms: torch.Tensor,
                grad_y_pair=None, disps=None) -> torch.Tensor:
    """Two-direction gradient cost with arm-adaptive weights (grad()
    cpp:603-657 + calgradvm 388-466): a*min(|dGx|,T) + (1-a)*min(|dGy|,T),
    a = shortestH / (shortestH + shortestV) from the reference image's
    cross arms [4, H, W]. Off-image entries take sqrt(2 T^2). As in the JAX
    package, ``is_grad_norm`` does not apply to this two-direction form.

    ``grad_y_pair``: optional (gy_left, gy_right) y-gradients to use instead
    of the images' own: the row-band pipeline's, whose one-sided rows sit at
    the true picture borders, not at the band's edges. ``disps``: an int
    [Db] index of disparities, for a [Db, H, W] block of the volume."""
    gx = (central_gradient(gray_l, 1), central_gradient(gray_r, 1))
    gy = (grad_y_pair if grad_y_pair is not None
          else (central_gradient(gray_l, 0), central_gradient(gray_r, 0)))
    short_h = torch.clamp(torch.minimum(arms[0], arms[1]), min=1).to(torch.float32)
    short_v = torch.clamp(torch.minimum(arms[2], arms[3]), min=1).to(torch.float32)
    a = short_h / (short_h + short_v)

    def build(pair):
        ref, oth = (pair[0], pair[1]) if lor == 0 else (pair[1], pair[0])
        sh = shifted_stack(oth, num_disp, lor, disps)
        return torch.clamp(torch.abs(ref[None] - sh), max=trunc)

    vol = a[None] * build(gx) + (1.0 - a)[None] * build(gy)
    valid = valid_mask(gray_l.shape[-1], num_disp, lor, vol.device, disps)
    return torch.where(valid, vol, math.sqrt(2.0 * trunc * trunc))


def exp_fuse2(vm0: torch.Tensor, vm1: torch.Tensor, lam0: float,
              lam1: float) -> torch.Tensor:
    """2 - exp(-vm0/lam0) - exp(-vm1/lam1) (gen_vm_from2vm_exp cpp:3566-3590)."""
    return 2.0 - torch.exp(-vm0 / lam0) - torch.exp(-vm1 / lam1)


def compute_cost_volume(left: torch.Tensor, right: torch.Tensor,
                        gray_l: torch.Tensor, gray_r: torch.Tensor, cfg,
                        lor: int, arms: Optional[torch.Tensor] = None,
                        grad_y_pair=None) -> torch.Tensor:
    """The censusGrad cost (cpp:25-48): exp fusion of the census Hamming
    volume (lam_cen) and the gradient volume (lam_g). ``left``/``right``
    are unused by this cost and kept for the JAX signature;
    ``grad_y_pair`` goes to :func:`grad_volume`."""
    return block_cost_builder(left, right, gray_l, gray_r, cfg, lor, arms,
                              grad_y_pair)(None)


def block_cost_builder(left: torch.Tensor, right: torch.Tensor,
                       gray_l: torch.Tensor, gray_r: torch.Tensor, cfg,
                       lor: int, arms: Optional[torch.Tensor] = None,
                       grad_y_pair=None) -> Callable:
    """The disparity-streaming form of :func:`compute_cost_volume`: returns
    ``block(ds) -> [Db, H, W]`` float32, the cost of the disparities in the
    int [Db] index ``ds`` (None: all of them), each plane the dense
    volume's bit for bit. The two census codes, which do not depend on the
    disparity, are computed once, here. Every cost but ``census_grad``
    raises NotImplementedError naming it."""
    del left, right
    if cfg.cost != "census_grad":
        raise NotImplementedError(f"cost {cfg.cost!r} is not ported yet")
    if cfg.census_func != 3:
        raise NotImplementedError(
            f"census_func={cfg.census_func} is not ported yet")
    if not (cfg.grad_use_2dir and cfg.grad_fuse_adaptive):
        raise NotImplementedError(
            "only the two-direction arm-adaptive gradient cost is ported")
    rv, ru = cfg.census_rv, cfg.census_ru
    code_l = census_ops.census_code_ncsur(gray_l, rv, ru)
    code_r = census_ops.census_code_ncsur(gray_r, rv, ru)
    n_bits = census_ops.ncsur_code_length(rv, ru)

    def block(ds) -> torch.Tensor:
        census = census_ops.hamming_volume(code_l, code_r, cfg.num_disp, lor, n_bits,
                                           cfg.census_trunc_ratio, cfg.is_census_norm, ds)
        grad = grad_volume(gray_l, gray_r, cfg.num_disp, lor, cfg.grad_trunc, arms,
                           grad_y_pair, ds)
        return exp_fuse2(census, grad, cfg.lam_cen, cfg.lam_g)

    return block
