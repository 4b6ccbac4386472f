"""(Radiative) shock tube (reference: src/pgen/shock.hpp; port of
``artemis_tpu/pgen/shock.py``).

Left/right states separated at ``xdisc`` with ``ic`` boundary conditions
that hold the inflow/outflow states; radiation (if on) starts at
Er = a T^4 of the local gas.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Problem


def build(pin, grid, gas_cfg, dust_cfg=None) -> Problem:
    if dust_cfg is not None:
        raise ValueError("The shock problem does not permit dust hydrodynamics!")
    rhol = pin.get_or_add_real("problem", "rhol", 1.0)
    vxl = pin.get_or_add_real("problem", "vxl", 2.0)
    tl = pin.get_or_add_real("problem", "tl", 0.6)
    rhor = pin.get_or_add_real("problem", "rhor", 2.285714)
    vxr = pin.get_or_add_real("problem", "vxr", 0.875000)
    tr = pin.get_or_add_real("problem", "tr", 1.246875)
    xdisc = pin.get_or_add_real("problem", "xdisc", 0.0005)
    cv = gas_cfg.cv
    gamma = gas_cfg.gamma

    shape = tuple(reversed(grid.nx))
    x1v, _, _ = grid.cell_centers()
    up = np.broadcast_to(x1v <= xdisc, shape)
    d = np.where(up, rhol, rhor)
    vx = np.where(up, vxl, vxr)
    sie = np.where(up, cv * tl, cv * tr)
    z = np.zeros(shape)
    p = (gamma - 1.0) * d * sie
    prims = {"gas": np.stack([d, vx, z, z, p, sie])[None]}

    ng = grid.nghost

    def ic_bc(w, grid_, fluid, dim, side):
        """Hold the L/R states in the x1 ghost zones (shock.hpp:113-175)."""
        if dim != 1 or fluid != "gas":
            return w
        n1 = grid_.nx[0]
        rho, v, t = (rhol, vxl, tl) if side == 0 else (rhor, vxr, tr)
        sl = slice(0, ng) if side == 0 else slice(ng + n1, n1 + 2 * ng)
        vals = torch.tensor([rho, v, 0.0, 0.0, (gamma - 1.0) * rho * cv * t, cv * t],
                            dtype=w.dtype, device=w.device)
        out = w.clone()
        out[:, :, :, :, sl] = vals[None, :, None, None, None]
        return out

    return Problem(prims=prims, bc_custom={"ic": ic_bc})
