"""Radiation-matter thermal equilibration (reference:
src/pgen/thermalization.hpp; port of ``artemis_tpu/pgen/thermalization.py``).

Uniform gas initialized out of equilibrium with the radiation field:
Er = a trad^4, gas at tgas.  Relaxes to the equilibrium temperature given by
energy conservation: rho cv T + a T^4 = rho cv tgas + a trad^4.
"""

from __future__ import annotations

import numpy as np

from . import Problem


def build(pin, grid, gas_cfg, dust_cfg=None) -> Problem:
    if dust_cfg is not None:
        raise ValueError("Thermalization problem does not permit dust!")
    rho = pin.get_or_add_real("problem", "rho", 1.0)
    vx = pin.get_or_add_real("problem", "vx", 0.0)
    tgas = pin.get_or_add_real("problem", "tgas", 2.0)
    trad = pin.get_or_add_real("problem", "trad", 1.0)
    cv = gas_cfg.cv

    shape = tuple(reversed(grid.nx))
    d = np.full(shape, rho)
    sie = np.full(shape, cv * tgas)
    v1 = np.full(shape, vx)
    z = np.zeros(shape)
    p = (gas_cfg.gamma - 1.0) * d * sie
    prims = {"gas": np.stack([d, v1, z, z, p, sie])[None]}

    prob = Problem(prims=prims)
    # radiation initialized from trad (thermalization.hpp:66-74: radiation is
    # seeded before the gas is reset out of equilibrium)
    prob.rad_temp = np.full(shape, trad)
    return prob
