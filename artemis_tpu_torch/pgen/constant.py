"""Uniform-state problem generator (reference: src/pgen/constant.hpp; a
copy of ``artemis_tpu/pgen/constant.py``, numpy only).

Constant density/velocity/temperature everywhere; the input velocity vector
is given in the ``problem/system`` coordinate basis and projected onto the
problem coordinate basis (constant.hpp:103-160).  Used as the smoke test
and as the background for the drag coupling regression.
"""

from __future__ import annotations

import numpy as np

from . import Problem
from ..geometry import geometry as geo


def _basis_rows(input_system: str, grid):
    """Rows ex_i = problem basis vector i expressed in the input basis."""
    x1v, x2v, x3v = grid.cell_centers()
    c = grid.coords
    if input_system == "cartesian":
        return geo.vec_to_cart(c, x1v, x2v, x3v)
    if input_system == "cylindrical":
        return geo.vec_to_cyl(c, x1v, x2v, x3v)
    raise ValueError(f"constant pgen: input system {input_system!r} unsupported")


def build(pin, grid, gas_cfg, dust_cfg=None) -> Problem:
    shape = tuple(reversed(grid.nx))
    input_system = geo.coord_select(
        pin.get_or_add_str("problem", "system", "cartesian"), grid.ndim)
    if input_system == grid.coords:
        o = np.ones(shape)
        z = np.zeros(shape)
        ex = ((o, z, z), (z, o, z), (z, z, o))
    else:
        ex = _basis_rows(pin.get_str("problem", "system"), grid)

    prims = {}
    if gas_cfg is not None:
        rho = pin.get_or_add_real("problem", "gas_rho", 1.0)
        vin = [pin.get_or_add_real("problem", f"gas_vx{d}", 0.0) for d in (1, 2, 3)]
        temp = pin.get_or_add_real("problem", "gas_temp", 1.0)
        sie = gas_cfg.cv * temp
        v = [sum(vin[m] * np.broadcast_to(ex[i][m], shape) for m in range(3))
             for i in range(3)]
        d = np.full(shape, rho)
        s = np.full(shape, sie)
        p = (gas_cfg.gamma - 1.0) * d * s
        prims["gas"] = np.stack([d, v[0], v[1], v[2], p, s])[None, :]
    if dust_cfg is not None:
        rho = pin.get_or_add_real("problem", "dust_rho", 1.0)
        vin = [pin.get_or_add_real("problem", f"dust_vx{d}", 0.0) for d in (1, 2, 3)]
        v = [sum(vin[m] * np.broadcast_to(ex[i][m], shape) for m in range(3))
             for i in range(3)]
        w = np.stack([np.full(shape, rho), v[0], v[1], v[2]])
        prims["dust"] = np.broadcast_to(
            w, (dust_cfg.nspecies,) + w.shape).copy()
    return Problem(prims=prims)
