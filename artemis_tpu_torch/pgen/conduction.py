"""Steady conductive-flux problem + conductive boundary condition
(reference: src/pgen/conduction.hpp; port of
``artemis_tpu/pgen/conduction.py``).

Uniform gas (optionally in hydrostatic balance with uniform gravity) with
``conductive`` x1 boundaries: the inner boundary imposes a fixed heat flux
F = -K dT/dx, the outer a fixed temperature, with density extrapolated from
dP/dx = -rho g (conduction.hpp:160-250).  The steady state is a conductive
temperature profile tested in cartesian/axisymmetric/spherical geometry.
The initial state is numpy; the fill ``(w, grid, fluid, d, side) -> w``
works on the padded torch tensor, on its device and in its dtype, and like
the other fills returns a new tensor and reads only its input.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Problem
from ..geometry import geometry as geo


def build(pin, grid, gas_cfg, dust_cfg=None) -> Problem:
    shape = tuple(reversed(grid.nx))
    rho0 = pin.get_or_add_real("problem", "gas_rho", 1.0)
    v0 = [pin.get_or_add_real("problem", f"gas_vx{d}", 0.0) for d in (1, 2, 3)]
    temp = pin.get_or_add_real("problem", "gas_temp", 1.0)
    flux = pin.get_or_add_real("problem", "flux", 0.0)
    gx1 = 0.0
    if pin.get_or_add_bool("physics", "gravity", False) and \
            pin.has_block("gravity/uniform"):
        gx1 = pin.get_or_add_real("gravity/uniform", "gx1", 0.0)
    x1min = pin.get_real("parthenon/mesh", "x1min")

    gamma = gas_cfg.gamma
    cv = gas_cfg.cv
    x1v, _, _ = grid.cell_centers()
    # hydrostatic initial state: P = P0 exp(gx1 rho0 / P0 (x - x1min))
    P0 = (gamma - 1.0) * rho0 * cv * temp
    Rgas = P0 / (rho0 * temp)
    P = P0 * np.exp(gx1 * rho0 / P0 * (x1v - x1min))
    dens = np.broadcast_to(P / (Rgas * temp), shape)
    sie = np.broadcast_to(cv * temp, shape)
    p = (gamma - 1.0) * dens * sie
    w = np.stack([dens,
                  np.full(shape, v0[0]), np.full(shape, v0[1]),
                  np.full(shape, v0[2]), p, sie])[None, :]

    # conductive BC closure -------------------------------------------------
    # conductivity at the edge cell (constant unless powerlaw exponents set)
    cond_blk = "gas/conductivity"
    ctype = pin.get_str(cond_blk, "type")
    if ctype == "conductivity":
        k0 = pin.get_real(cond_blk, "cond")
        kind = "conductivity"
    else:
        k0 = pin.get_real(cond_blk, "kappa")
        kind = "diffusivity"
    temp_exp = pin.get_or_add_real(cond_blk, "temp_exp", 0.0)
    rho_exp = pin.get_or_add_real(cond_blk, "rho_exp", 0.0)
    T_ref = pin.get_or_add_real(cond_blk, "T_ref", 1.0)
    d_ref = pin.get_or_add_real(cond_blk, "rho_ref", 1.0)

    g = grid.geom
    ng = grid.nghost

    def kcoeff(rho_a, sie_a):
        T = sie_a / cv
        base = k0 * (T / T_ref) ** temp_exp * (rho_a / d_ref) ** rho_exp
        if kind == "diffusivity":
            base = base * rho_a * cv
        return base

    # physical distances |xv_ghost - xv_active| along x1 (1-D, ghost cells)
    cx, cy, cz = geo.convert_to_cart(
        grid.coords, g.xv1[None, None, :], g.xv2[None, :, None],
        g.xv3[:, None, None])

    def _dist(i_ghost, i_active):
        d2 = 0.0
        for c in (cx, cy, cz):
            cb = np.broadcast_to(c, grid.shape_entire)
            d2 = d2 + (cb[:, :, i_ghost] - cb[:, :, i_active]) ** 2
        return np.sqrt(d2)

    dists = {}

    def dist_of(gi, ia, like):
        """|x_ghost - x_active| of ghost column ``gi`` ([nz, ny]) as a
        tensor of the state's dtype on its device, made once."""
        key = (gi, ia, like.device, like.dtype)
        if key not in dists:
            dists[key] = torch.as_tensor(_dist(gi, ia), dtype=like.dtype, device=like.device)
        return dists[key]

    def cond_bc(w, grid_, fluid, d, side):
        if fluid != "gas" or d != 1:
            return w
        n1 = grid_.nx[0]
        ia = ng if side == 0 else ng + n1 - 1
        da = w[:, 0, :, :, ia]
        siea = w[:, 5, :, :, ia]
        Ta = siea / cv
        ka = kcoeff(da, siea)
        out = w.clone()
        ghosts = range(0, ng) if side == 0 else range(ng + n1, n1 + 2 * ng)
        for gi in ghosts:
            xma = (-1.0 if side == 0 else 1.0) * dist_of(gi, ia, w)
            if side == 0:
                Tg = Ta - flux * xma / ka
            else:
                Tg = temp
            densg = da * (Ta - 0.5 * gx1 * xma) / (Tg + 0.5 * gx1 * xma)
            sieg = cv * Tg
            out[:, 0, :, :, gi] = densg
            out[:, 5, :, :, gi] = sieg * torch.ones_like(densg)
            out[:, 4, :, :, gi] = (gamma - 1.0) * densg * sieg
            for c in (1, 2, 3):
                out[:, c, :, :, gi] = w[:, c, :, :, ia]
        return out

    return Problem(prims={"gas": w}, bc_custom={"conductive": cond_bc})
