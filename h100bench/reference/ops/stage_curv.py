"""The fused curvilinear gas-hydro RK stage's plain version (a frozen copy
of ``artemis_tpu_torch/ops/stage_curv.py``'s plain functions and gates, the
reference of the benchmark).

One stage is everything between two ghost fills: the composable sequence
pad (the boundary fills, or six face strips) -> fluxes -> update -> flux
sources -> diffusion -> point gravity -> rotating-frame torque, then, in
full mode, the dual-energy sync, C2P/P2C and the CFL denominator.  A
refinement tree's fused path calls it per node, or over a batch of
same-shape nodes, with each node's six face strips.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bc as bc_mod
from ..geometry import geometry as geo

MAX_NODES = 16  # the node-batched kernel's node table (kMaxNodes)
STRIP_KEYS = (("x1", 0), ("x1", 1), ("x2", 0), ("x2", 1), ("x3", 0), ("x3", 1))


def supported_curv(grid, cfg) -> bool:
    """Is the config inside the curvilinear stage kernel's envelope?"""
    return (cfg is not None and cfg.fluid == "gas" and cfg.nspecies == 1
            and cfg.rsolver in ("hllc", "hlle") and cfg.recon in ("plm", "pcm")
            and grid.nghost == 2 and grid.nx[0] > 1 and grid.nx[1] > 1)


def gather6_supported(grid) -> bool:
    """Grid gate for the six-face strip gather (the boundary sourcing, all
    six faces ``ic`` with value caches, is the caller's check)."""
    return grid.nghost == 2 and grid.nx[0] > 1 and grid.nx[1] > 1 and grid.nx[2] > 1


def gather6_batch_ok(stages) -> bool:
    """May these nodes' stages run as one node-batched six-face call?  Two
    or more nodes of one grid shape and ghost width, Cartesian, without
    diffusion or a folded rotating frame, with the same point-gravity
    scalars, no more than MAX_NODES."""
    def gspec(cs):
        g = cs.gravity
        return None if g is None else (cs.gmode, g.gm, g.soft2, tuple(g.pos), g.tstart,
                                       g.tstop)

    c0 = stages[0]
    return 2 <= len(stages) <= MAX_NODES and all(
        cs.grid.nx == c0.grid.nx and cs.grid.ng == c0.grid.ng
        and geo.is_cartesian(cs.grid.coords) and cs.diffusion is None
        and (cs.rotating.omega if cs.rotating is not None else 0.0) == 0.0
        and gspec(cs) == gspec(c0) for cs in stages)


def prepare_gather6_root_strips(grid, ic_caches):
    """The six-face strips of an all-``ic`` grid from the ic BC value caches
    (make_ic_bc's shard_caches[0]), numpy: x1 lo/hi ghost slabs over the
    padded y and z extents [6, zp, yp, ng], x2 lo/hi over the padded z
    extent and the interior x range [6, zp, ng, nx], x3 lo/hi over the
    interior x and y ranges [6, ng, ny, nx]."""
    ng = grid.nghost
    nx, ny, _ = grid.nx
    out = {}
    for side in (0, 1):
        out[("x1", side)] = np.ascontiguousarray(np.asarray(ic_caches[(1, side)])[0])
        out[("x2", side)] = np.ascontiguousarray(
            np.asarray(ic_caches[(2, side)])[0][:, :, :, ng:ng + nx])
        a = np.asarray(ic_caches[(3, side)])[0]   # [6, ng, yp, xp]
        out[("x3", side)] = np.ascontiguousarray(a[:, :, ng:ng + ny, ng:ng + nx])
    return out


class CurvStage:
    """One node's stage, made once: what the stage folds in (the rotation
    velocity ``omf`` of the flux sources, the curvilinear ``rotating``
    frame torque, a central point-mass ``gravity`` source with its mode,
    the ``diffusion`` passes) and the boundary fills of the padded halo.
    ``full=False`` stops after the flux sources."""

    def __init__(self, hyd, *, omf=0.0, rotating=None, gravity=None, gmode=None,
                 diffusion=None, full=True, bc_custom=None):
        grid, cfg = hyd.grid, hyd.gas
        if not supported_curv(grid, cfg):
            raise ValueError("config outside the curvilinear stage kernel's envelope")
        if (gravity is None) != (gmode is None):
            raise ValueError("a folded gravity source needs its mode, and only then")
        self.hyd, self.grid, self.cfg = hyd, grid, cfg
        self.omf = omf
        self.rotating, self.gravity, self.gmode = rotating, gravity, gmode
        self.diffusion = diffusion
        self.full = full
        self.bc_custom = bc_custom or {}


def stage_curv(cs: CurvStage, w, u0, u1, gam0, gam1, beta, dt, time, force_pcm,
               strips=None, w_pad=None):
    """One stage from interior prims ``w`` [1, 6, nz, ny, nx] and the
    registers u0, u1: the halo from the six face ``strips``, or the padded
    prims ``w_pad``, or ``bc.pad_and_fill``.  Returns (u, w, dtden) with
    dtden of shape (1,) (zero in partial mode, where w passes through)."""
    hyd, cfg = cs.hyd, cs.cfg
    bdt = beta * dt
    if strips is not None:
        w_pad = pad_from_strips(w, cs.grid, strips)
    elif w_pad is None:
        w_pad = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)
    fx = hyd.compute_fluxes(w_pad, cfg, force_pcm)
    u = hyd.apply_update(u0, u1, fx, gam0, gam1, bdt)
    u = hyd.flux_source(u, w, fx, bdt, omf=cs.omf)
    if cs.diffusion is not None:
        u = cs.diffusion.update(u, w, cs.diffusion.fluxes(w_pad), bdt)
    st = {"gas": {"u": u, "w": w}}
    for src in (cs.gravity, cs.rotating):
        if src is not None:
            st = src.apply(st, {"gas": fx}, time, bdt, hyd)
    u = st["gas"]["u"]
    if not cs.full:
        return u, w, torch.zeros(1, dtype=u.dtype, device=u.device)
    u = hyd.set_auxiliary(u, cfg)
    u, w = hyd.prim_to_cons(hyd.cons_to_prim(u, cfg), cfg)
    den = torch.amax(hyd.dt_denominator(w, cfg))
    if cs.diffusion is not None:
        den = torch.maximum(den, 1.0 / cs.diffusion.estimate_dt(w))
    return u, w, den.reshape(1)


def pad_from_strips(w, grid, strips):
    """Interior prims [1, 6, nz, ny, nx] padded from the six face strips: an
    x1 strip over an x2 strip over an x3 strip over the interior (every
    halo cell belongs to one of them)."""
    nx, ny, nz = grid.nx
    g1, g2, g3 = grid.ng
    wp = w.new_zeros((1, 6, nz + 2 * g3, ny + 2 * g2, nx + 2 * g1))
    wp[:, :, g3:g3 + nz, g2:g2 + ny, g1:g1 + nx] = w
    wp[0, :, :g3, g2:g2 + ny, g1:g1 + nx] = strips[("x3", 0)]
    wp[0, :, g3 + nz:, g2:g2 + ny, g1:g1 + nx] = strips[("x3", 1)]
    wp[0, :, :, :g2, g1:g1 + nx] = strips[("x2", 0)]
    wp[0, :, :, g2 + ny:, g1:g1 + nx] = strips[("x2", 1)]
    wp[0, :, :, :, :g1] = strips[("x1", 0)]
    wp[0, :, :, :, g1 + nx:] = strips[("x1", 1)]
    return wp


def stage_curv_batched(stages, ws, u0s, u1s, strips_list, gam0, gam1, beta, dt, time,
                       force_pcm):
    """One stage for N nodes of one grid shape with six-face strip halos
    (``strips_list[k]``: node k's STRIP_KEYS dict for this stage), node by
    node.  Returns one (u, w, dtden) per node."""
    return [stage_curv(cs, w, u0, u1, gam0, gam1, beta, dt, time, force_pcm, strips=strips)
            for cs, w, u0, u1, strips in zip(stages, ws, u0s, u1s, strips_list)]
