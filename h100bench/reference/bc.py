"""Boundary conditions as ghost-zone fills on primitive arrays
(port of ``artemis_tpu/bc.py``).

Replaces the reference's Parthenon boundary machinery + named artemis BCs
(``ArtemisBC``: reflect/outflow/extrap/inflow/conduct/ic/visc/user/periodic,
src/artemis.hpp:90-105 and src/pgen/problem_modifier.hpp:41-144).  Physical
BCs are pure functions ``w -> w`` writing the ghost slabs of the primitive
array: each returns a new tensor (a clone with the ghost slabs assigned) and
reads only from its input, as the JAX ``.at[].set`` form does.  Problem
generators register custom fills in a per-run registry.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def _axs(ndim: int, d: int, sl: slice):
    out = [slice(None)] * ndim
    out[-d] = sl
    return tuple(out)


def _set(w, dst, src):
    out = w.clone()
    out[dst] = src
    return out


def apply_periodic(w, d: int, ng: int, n: int):
    nd = w.ndim
    # lower ghosts <- last ng interior; upper ghosts <- first ng interior
    out = w.clone()
    out[_axs(nd, d, slice(0, ng))] = w[_axs(nd, d, slice(n, n + ng))]
    out[_axs(nd, d, slice(n + ng, n + 2 * ng))] = w[_axs(nd, d, slice(ng, 2 * ng))]
    return out


def apply_outflow(w, d: int, ng: int, n: int, side: int):
    nd = w.ndim
    if side == 0:
        edge = w[_axs(nd, d, slice(ng, ng + 1))]
        dst = _axs(nd, d, slice(0, ng))
    else:
        edge = w[_axs(nd, d, slice(n + ng - 1, n + ng))]
        dst = _axs(nd, d, slice(n + ng, n + 2 * ng))
    return _set(w, dst, edge)


def apply_reflecting(w, d: int, ng: int, n: int, side: int, vel_comp: int):
    """Mirror all components; negate the normal velocity component.

    ``vel_comp`` is the component index of the normal velocity within the
    variable axis (axis 1 of ``w``: [ns, C, z, y, x]).
    """
    nd = w.ndim
    if side == 0:
        src = torch.flip(w[_axs(nd, d, slice(ng, 2 * ng))], dims=(nd - d,))
        dst = _axs(nd, d, slice(0, ng))
    else:
        src = torch.flip(w[_axs(nd, d, slice(n, n + ng))], dims=(nd - d,))
        dst = _axs(nd, d, slice(n + ng, n + 2 * ng))
    src[:, vel_comp] = -src[:, vel_comp]
    return _set(w, dst, src)


# custom BC registry: name -> fn(w, grid, fluid, d, side) -> w
CustomBC = Callable[..., object]


def pad_prims(w_int, grid):
    """Pad an interior primitive array [ns, C, z, y, x] with ghost slabs
    (edge-replicated; every ghost cell is overwritten by fill_ghosts).
    The JAX version's ``extra`` alignment rows existed only for the TPU
    kernel's DMA rules and are not carried over."""
    g1, g2, g3 = grid.ng
    return F.pad(w_int, (g1, g1, g2, g2, g3, g3), mode="replicate")


def pad_and_fill(w_int, grid, fluid: str, custom: Optional[Dict[str, CustomBC]] = None):
    """Interior prims -> ghost-padded prims with all BCs applied."""
    if all(grid.bc[d - 1] == ("periodic", "periodic")
           for d in (1, 2, 3) if grid.active(d)):
        return _periodic_concat(w_int, grid)
    return fill_ghosts(pad_prims(w_int, grid), grid, fluid, custom)


def _periodic_concat(w_int, grid):
    """Fast ghost fill for all-periodic boundaries: one concatenate per
    active axis instead of pad + per-face scatter."""
    ng = grid.ng
    out = w_int
    for d in (1, 2, 3):
        g = ng[d - 1]
        if g == 0:
            continue
        ax = out.ndim - d
        lo = [slice(None)] * out.ndim
        hi = [slice(None)] * out.ndim
        lo[ax] = slice(-g, None)
        hi[ax] = slice(0, g)
        out = torch.cat([out[tuple(lo)], out, out[tuple(hi)]], dim=ax)
    return out


def fill_ghosts(w, grid, fluid: str, custom: Optional[Dict[str, CustomBC]] = None):
    """Apply all six boundary fills to a primitive array."""
    custom = custom or {}
    for d in (1, 2, 3):
        if not grid.active(d):
            continue
        ng = grid.nghost
        n = grid.nx[d - 1]
        inner, outer = grid.bc[d - 1]
        if inner == "periodic" or outer == "periodic":
            if inner != outer:
                raise ValueError(f"periodic BC must be two-sided in x{d}")
            w = apply_periodic(w, d, ng, n)
            continue
        for side, name in ((0, inner), (1, outer)):
            if name in custom:
                w = custom[name](w, grid, fluid, d, side)
            elif name == "outflow":
                w = apply_outflow(w, d, ng, n, side)
            elif name in ("reflecting", "reflect"):
                w = apply_reflecting(w, d, ng, n, side, vel_comp=d)
            elif name == "none":
                pass
            else:
                raise ValueError(f"unknown boundary condition {name!r} in x{d}")
    return w
