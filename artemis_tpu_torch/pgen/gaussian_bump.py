"""Gaussian bump problem (reference: src/pgen/gaussian_bump.hpp; a copy of
``artemis_tpu/pgen/gaussian_bump.py``, numpy only).

Uniform background with a Gaussian perturbation in velocity, temperature, or
density — the viscous/thermal spreading regression driver
(tst/scripts/diffusion/viscous_diffusion.py).
"""

from __future__ import annotations

import numpy as np

from . import Problem
from ..geometry import geometry as geo


def build(pin, grid, gas_cfg, dust_cfg=None) -> Problem:
    shape = tuple(reversed(grid.nx))
    xc = (pin.get_or_add_real("problem", "x1c", 0.0),
          pin.get_or_add_real("problem", "x2c", 0.0),
          pin.get_or_add_real("problem", "x3c", 0.0))
    sig = pin.get_real("problem", "sigma")
    dfac = pin.get_or_add_real("problem", "density_bump", 0.0)
    tfac = pin.get_or_add_real("problem", "temperature_bump", 0.0)
    vfac = (pin.get_or_add_real("problem", "vx1_bump", 0.0),
            pin.get_or_add_real("problem", "vx2_bump", 0.0),
            pin.get_or_add_real("problem", "vx3_bump", 0.0))

    x1v, x2v, x3v = grid.cell_centers()
    cx, cy, cz = geo.convert_to_cart(grid.coords, x1v, x2v, x3v)
    multi = 1.0 if grid.active(2) else 0.0
    three = 1.0 if grid.active(3) else 0.0
    dx2 = ((cx - xc[0]) ** 2 + multi * (cy - xc[1]) ** 2
           + three * (cz - xc[2]) ** 2)
    bump = np.broadcast_to(np.exp(-dx2 / (2.0 * sig * sig)), shape)

    prims = {}
    if gas_cfg is not None:
        gamma = gas_cfg.gamma
        rho0 = pin.get_or_add_real("problem", "gas_rho", 1.0)
        pres0 = pin.get_or_add_real("problem", "gas_pres", 1.0)
        vbg = [pin.get_or_add_real("problem", f"gas_vx{d}", 0.0) for d in (1, 2, 3)]
        v = [np.broadcast_to(vbg[c], shape) + vfac[c] * bump for c in range(3)]
        if tfac > 0.0:
            sie0 = pres0 / (rho0 * (gamma - 1.0))
            sie = sie0 * (1.0 + tfac * bump)
            dens = pres0 / (sie * (gamma - 1.0))
        else:
            dens = rho0 * (1.0 + dfac * bump)
            sie = pres0 / ((gamma - 1.0) * dens)
        p = (gamma - 1.0) * dens * sie
        prims["gas"] = np.stack([dens, v[0], v[1], v[2], p, sie])[None, :]
    if dust_cfg is not None:
        rho = pin.get_or_add_real("problem", "dust_rho", 1.0)
        dens = np.broadcast_to(rho * (1.0 + dfac * bump), shape)
        z = np.zeros(shape)
        w = np.stack([dens, z, z, z])
        prims["dust"] = np.broadcast_to(w, (dust_cfg.nspecies,) + w.shape).copy()
    return Problem(prims=prims)
