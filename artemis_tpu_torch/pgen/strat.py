"""Stratified / unstratified shearing box (reference: src/pgen/strat.hpp;
port of ``artemis_tpu/pgen/strat.py``).

Background shear vy = -q Omega x with vertically Gaussian density (3-D),
run in the Cartesian rotating frame (shearing box forces).  Custom BCs,
fills ``(w, grid, fluid, d, side) -> w`` on the padded torch tensor, on
its device and in its dtype: ``extrap`` on x1 (copy + no-inflow vx +
linear vy extrapolation, strat.hpp:154-260), ``inflow`` on x2 (upstream
rows reset to the background shear, downstream no-inflow,
strat.hpp:262-420), and ``extrap`` on x3 (no-inflow vz + geometric density
extrapolation of the stratified profile into the vertical ghosts,
strat.hpp:477-639).  Like the other fills they return a new tensor and
read only their input.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Problem


def build(pin, grid, gas_cfg, dust_cfg=None) -> Problem:
    if grid.coords != "cartesian":
        raise ValueError("problem = strat only works for Cartesian coordinates!")
    if not pin.get_or_add_bool("physics", "rotating_frame", False):
        raise ValueError("strat requires the rotating frame")
    q = pin.get_or_add_real("rotating_frame", "qshear", 0.0)
    Om0 = pin.get_or_add_real("rotating_frame", "omega", 0.0)
    h = pin.get_or_add_real("problem", "h", 1.0)
    rho0 = pin.get_or_add_real("problem", "rho0", 1.0)
    dens_min = pin.get_or_add_real("problem", "dens_min", 1.0e-5)
    pin.get_or_add_real("problem", "pres_min", 1.0e-8)  # parsed as in strat.hpp:68
    d2g = pin.get_or_add_real("problem", "dust_to_gas", 0.01)
    temp0 = (h * Om0) ** 2
    cv = gas_cfg.cv
    gamma = gas_cfg.gamma

    shape = tuple(reversed(grid.nx))
    x1v, _, x3v = grid.cell_centers()
    three_d = grid.active(3)

    vx2 = np.broadcast_to(-q * Om0 * x1v, shape)
    efac = np.exp(-(x3v**2) / (2.0 * h * h)) if three_d else 1.0
    dens = np.broadcast_to(np.maximum(dens_min, efac * rho0), shape)
    sie = np.full(shape, cv * temp0)
    zero = np.zeros(shape)
    pres = (gamma - 1.0) * dens * sie
    prims = {"gas": np.stack([dens, zero, vx2, zero, pres, sie])[None]}
    if dust_cfg is not None:
        wd = np.stack([dens * d2g, zero, vx2, zero])
        prims["dust"] = np.broadcast_to(wd, (dust_cfg.nspecies,) + wd.shape).copy()

    # -- custom BCs -----------------------------------------------------
    g = grid.geom
    ng = grid.nghost
    rows = {}

    def x2_rows(like):
        """(lower x1 face, background vy) of each ghosted x1 column as
        [1, 1, nx] tensors of the state's dtype on its device, made once."""
        key = (like.device, like.dtype)
        if key not in rows:
            t = lambda a: torch.as_tensor(a[None, None, :], dtype=like.dtype, device=like.device)
            rows[key] = (t(g.xf1[:-1]), t(-q * Om0 * g.xv1))
        return rows[key]

    def take(w, ax, i):
        sl = [slice(None)] * w.ndim
        sl[ax] = i
        return tuple(sl)

    def extrap_bc(w, grid_, fluid, d, side):
        """x1: copy edge + no-inflow vx + linear vy slope (strat.hpp:154-260).
        x3: no-inflow vz + geometric density extrapolation rho_edge *
        (rho_next/rho_edge)**((z-z0)/dz) of the stratified profile
        (strat.hpp:477-639)."""
        n = grid_.nx[d - 1]
        ax = w.ndim - d
        edge = ng if side == 0 else ng + n - 1
        nxt = edge + 1 if side == 0 else edge - 1
        xv = {1: g.xv1, 2: g.xv2, 3: g.xv3}[d]
        x0, x1 = xv[edge], xv[nxt]
        dx = x1 - x0

        we = w[take(w, ax, edge)]
        wn = w[take(w, ax, nxt)]
        vnorm = (torch.clamp_max(we[:, d], 0.0) if side == 0
                 else torch.clamp_min(we[:, d], 0.0))
        out = w.clone()
        ghosts = range(0, ng) if side == 0 else range(ng + n, n + 2 * ng)
        for gi in ghosts:
            x = xv[gi]
            new = we.clone()
            new[:, d] = vnorm
            if d == 1:  # linear extrapolation of vy in x (strat.hpp:216-220)
                new[:, 2] = we[:, 2] + (wn[:, 2] - we[:, 2]) * (x - x0) / dx
            elif d == 3:
                # Geometric extrapolation of the vertically stratified
                # density (strat.hpp:526-529, 608-611): the inner/outer
                # forms both reduce to rho_e*(rho_n/rho_e)**((z-z0)/dz)
                # with the signed dz = z_next - z_edge used here.
                frac = float((x - x0) / dx)
                rho = we[:, 0] * (wn[:, 0] / we[:, 0]) ** frac
                new[:, 0] = rho
                if fluid == "gas":  # keep pres consistent with copied sie
                    new[:, 4] = (gamma - 1.0) * rho * new[:, 5]
            out[take(out, ax, gi)] = new
        return out

    def inflow_bc(w, grid_, fluid, d, side):
        """x2: upstream rows -> background shear; downstream no-inflow."""
        if d != 2:
            raise ValueError("strat inflow BC is an x2 boundary")
        n = grid_.nx[1]
        ax = w.ndim - 2
        edge = ng if side == 0 else ng + n - 1
        we = w[take(w, ax, edge)]
        # upstream half: inner-x2 at x<0, outer-x2 at x>0 (radial shear
        # sense), by the lower x-face of each cell
        xlo, vy0 = x2_rows(w)
        vy_e = we[:, 2]
        if side == 0:
            vy_new = torch.where(xlo >= 0, torch.clamp_max(vy_e, 0.0), vy0)
        else:
            vy_new = torch.where(xlo < 0, torch.clamp_min(vy_e, 0.0), vy0)
        new = we.clone()
        new[:, 2] = vy_new
        out = w.clone()
        ghosts = range(0, ng) if side == 0 else range(ng + n, n + 2 * ng)
        for gi in ghosts:
            out[take(out, ax, gi)] = new
        return out

    return Problem(prims=prims,
                   bc_custom={"extrap": extrap_bc, "inflow": inflow_bc})
