"""Gas/dust hydrodynamics update machinery (a frozen copy of
``artemis_tpu_torch/ops/hydro.py``'s plain path, the reference of the
benchmark).

The reference hot path (SURVEY.md §3.2):
``CalculateFluxes -> ApplyUpdate -> FluxSource -> [external sources] ->
SetAuxillaryFields -> ConsToPrim -> BCs -> PrimToCons``, each as a
whole-array tensor pass.  The reference's runtime->template dispatch
(fluid_fluxes.hpp:216-292) becomes Python specialization.  These are the
plain (composable) versions.

State representation (mirrors the reference's communication pattern, where
only primitives carry FillGhost):
  * conserved ``u`` and primitive ``w`` live on the INTERIOR grid
  * each stage pads ``w`` with ghost zones (physical BCs) and derives
    everything else from the padded primitives

Component conventions (per species ``n``):
  gas  cons  u[:, 0:6] = (rho, m1, m2, m3, E, eint)     [m_i = rho v_i h_i]
  gas  prim  w[:, 0:6] = (rho, v1, v2, v3, p, sie)
  dust cons  u[:, 0:4] = (rho, m1, m2, m3)
  dust prim  w[:, 0:4] = (rho, v1, v2, v3)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..geometry import geometry as geo
from . import recon as recon_mod
from . import riemann as riemann_mod


@dataclass(frozen=True)
class FluidCfg:
    fluid: str               # "gas" | "dust"
    recon: str               # pcm | plm | ppm
    rsolver: str             # hllc | hlle | llf
    gamma: float = 5.0 / 3.0
    cv: float = 1.5
    cfl: float = 0.8
    dfloor: float = 1.0e-20
    siefloor: float = 1.0e-20
    de_switch: float = 0.0
    nspecies: int = 1


def _axslice(ndim: int, d: int, sl: slice):
    out = [slice(None)] * ndim
    out[-d] = sl
    return tuple(out)


def _int3(arr_np, grid):
    """Broadcast a factored geometry array to the entire grid, slice interior."""
    s = grid.int_slices
    return np.ascontiguousarray(np.broadcast_to(arr_np, grid.shape_entire)[s])


class Hydro:
    """Geometry constants for a Grid, made once as tensors on ``device`` in
    ``dtype`` (the run's precision: a float64 constant would promote a
    float32 state to float64), and the stage operations."""

    def __init__(self, grid, gas: Optional[FluidCfg], dust: Optional[FluidCfg] = None,
                 *, device, dtype):
        self.grid = grid
        self.gas = gas
        self.dust = dust
        self.device = torch.device(device)
        self.dtype = dtype
        g = grid.geom
        self.cartesian = geo.is_cartesian(grid.coords)
        self.dims = [d for d in (1, 2, 3) if grid.active(d)]
        self.ng = grid.ng  # (g1, g2, g3)
        self.nx = grid.nx

        def _t(a):
            return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

        self.vol = _t(_int3(g.volume(), grid))
        w1, w2, w3 = g.cell_widths()
        self.widths = [_t(_int3(w1, grid)), _t(_int3(w2, grid)), _t(_int3(w3, grid))]
        self.hxv_int = [_t(_int3(g.hv(c), grid)) for c in (1, 2, 3)]

        # interior-face areas: faces along d span entire-face idx [g_d, g_d+n_d]
        self.area = {}
        self.face_h = {}
        for d in (1, 2, 3):
            A = g.face_area(d)  # broadcastable over entire grid, faces along d
            self.area[d] = _t(self._faces_interior_np(A, d))
            if not self.cartesian:
                self.face_h[d] = [_t(self._faces_interior_np(g.face_h(c, d), d))
                                  for c in (1, 2, 3)]

        # interior coordinate widths per axis
        self.dxc = {
            1: _t(_int3(g.dx1[None, None, :], grid)),
            2: _t(_int3(g.dx2[None, :, None], grid)),
            3: _t(_int3(g.dx3[:, None, None], grid)),
        }
        # interior connection terms {dh(1,2,3)/dx1}, {dh(1,2,3)/dx2}
        zero1 = np.zeros_like(g.dh2dx1)
        self.conn1 = [
            _t(_int3(zero1[None, None, :], grid)),
            _t(_int3(g.dh2dx1[None, None, :], grid)),
            _t(_int3(g.dh3dx1[None, None, :], grid)),
        ]
        zero2 = np.zeros_like(g.dh3dx2)
        self.conn2 = [
            _t(_int3(zero2[None, :, None], grid)),
            _t(_int3(zero2[None, :, None], grid)),
            _t(_int3(g.dh3dx2[None, :, None], grid)),
        ]
        self.x1dep = geo.x1dep(grid.coords)
        self.x2dep = geo.x2dep(grid.coords) and grid.active(2)
        # rotation-velocity basis (omf == 1) as interior fields: omf scales
        # linearly
        self.vrot_base = None
        if not self.cartesian:
            base = _rotation_velocity(grid, grid.cell_centers(), 1.0)
            if base is not None:
                shape = tuple(reversed(grid.nx))
                self.vrot_base = [_t(np.broadcast_to(np.asarray(b), shape))
                                  for b in base]
        # PLM_G (Mignone) coordinate rows for curvilinear axes
        self.recon_rows = None
        if not self.cartesian:
            self.recon_rows = {}
            for d in (1, 2, 3):
                xv, xf, dx = recon_mod._axis_coords(g, d, 3)
                self.recon_rows[d] = [_t(a) for a in (xv, xf[0], xf[1], dx)]

    # -- helpers ---------------------------------------------------------
    def _faces_interior_np(self, A, d: int):
        """Slice a broadcastable entire-grid face array (faces along d) down
        to interior faces along d and interior cells across."""
        ng = self.ng
        nx = self.nx
        shape_f = list(self.grid.shape_entire)
        shape_f[-d] += 1
        A = np.broadcast_to(A, shape_f)
        sl = [
            slice(ng[2], ng[2] + nx[2]),
            slice(ng[1], ng[1] + nx[1]),
            slice(ng[0], ng[0] + nx[0]),
        ]
        sl[3 - d] = slice(ng[d - 1], ng[d - 1] + nx[d - 1] + 1)
        return np.ascontiguousarray(A[tuple(sl)])

    def _faces_interior(self, X, d: int):
        """Same slicing for a tensor on entire-grid faces."""
        ng = self.ng
        nx = self.nx
        nd = X.ndim
        sl = [slice(None)] * nd
        sl[nd - 3] = slice(ng[2], ng[2] + nx[2])
        sl[nd - 2] = slice(ng[1], ng[1] + nx[1])
        sl[nd - 1] = slice(ng[0], ng[0] + nx[0])
        sl[nd - d] = slice(ng[d - 1], ng[d - 1] + nx[d - 1] + 1)
        return X[tuple(sl)]

    def _dfaces(self, X, d: int, side: int):
        """Slice interior-face array to the lower (side=0) / upper (side=1)
        faces of each interior cell along d."""
        n = self.nx[d - 1]
        return X[_axslice(X.ndim, d, slice(side, side + n))]

    # -- fluxes ----------------------------------------------------------
    def compute_fluxes(self, w_pad, cfg: FluidCfg, force_pcm: bool):
        """Hydro fluxes in all active directions from padded primitives.

        Returns dict d -> (F, pface, vface) on interior faces
        (cf. CalculateFluxesImpl, fluid_fluxes.hpp:73-213).
        """
        out = {}
        method = "pcm" if force_pcm else cfg.recon
        for d in self.dims:
            rows = self.recon_rows.get(d) if self.recon_rows else None
            wl, wr = recon_mod.reconstruct(w_pad, d, method, self.grid.geom, rows=rows)
            wl = self._faces_interior(wl, d)
            wr = self._faces_interior(wr, d)
            F, pF, vF = riemann_mod.solve(wl, wr, d, cfg.fluid, cfg.rsolver, cfg.gamma)
            if not self.cartesian:
                # scale momentum fluxes by h_c at the face centroid
                # (ScaleMomentumFlux, fluid_fluxes.hpp:32-70)
                fh = self.face_h[d]
                F = F.clone()
                F[:, 1] *= fh[0]
                F[:, 2] *= fh[1]
                F[:, 3] *= fh[2]
            out[d] = (F, pF, vF)
        return out

    def apply_update(self, u0, u1, fluxes, gam0, gam1, beta_dt):
        """Two-register RK blend + flux divergence
        (cf. ArtemisUtils::ApplyUpdate, artemis_integrator.hpp:56-110)."""
        divf = 0.0
        for d in self.dims:
            AF = self.area[d] * fluxes[d][0]
            divf = divf + (self._dfaces(AF, d, 0) - self._dfaces(AF, d, 1))
        return gam0 * u0 + gam1 * u1 + divf * (beta_dt / self.vol)

    def flux_source(self, u, w, fluxes, dt, omf: float = 0.0):
        """Pressure-gradient force, PdV work, and curvilinear connection
        sources (cf. FluxSourceImpl, fluid_fluxes.hpp:295-420).
        ``u``/``w`` are interior arrays."""
        u = u.clone()
        is_gas = u.shape[1] == 6
        if is_gas:
            dmom = {1: 0.0, 2: 0.0, 3: 0.0}
            deint = 0.0
            for d in self.dims:
                _, pF, vF = fluxes[d]
                plo = self._dfaces(pF, d, 0)
                phi = self._dfaces(pF, d, 1)
                dmom[d] = dt / self.dxc[d] * (plo - phi)
                AvF = self.area[d] * vF
                deint = deint - (dt / self.vol) * 0.5 * (plo + phi) * (
                    self._dfaces(AvF, d, 1) - self._dfaces(AvF, d, 0)
                )
            for d in self.dims:
                u[:, d] += dmom[d]
            u[:, 5] += deint

        if self.x1dep or self.x2dep:
            rho = w[:, 0]
            vrot = None
            if omf != 0.0 and self.vrot_base is not None:
                vrot = [omf * b for b in self.vrot_base]
            vtot = [w[:, 1 + c] + (vrot[c] if vrot is not None else 0.0) for c in range(3)]
            rdt = rho * dt
            if self.x1dep:
                con = self.conn1
                u[:, 1] += rdt * (con[0] * vtot[0] ** 2 + con[1] * vtot[1] ** 2
                                  + con[2] * vtot[2] ** 2)
            if self.x2dep:
                con = self.conn2
                u[:, 2] += rdt * (con[0] * vtot[0] ** 2 + con[1] * vtot[1] ** 2
                                  + con[2] * vtot[2] ** 2)
        return u

    # -- derived fields --------------------------------------------------
    def sie_from_cons(self, u, cfg: FluidCfg):
        """Dual-energy specific internal energy from conserved fields, and
        the floored density it divides by (cf.
        ArtemisUtils::GetSpecificInternalEnergy, artemis_utils.hpp:41-78;
        the JAX package's ``sources._sie_from_cons``)."""
        rho = torch.clamp(u[:, 0], min=cfg.dfloor)
        hx = self.hxv_int
        ke = 0.5 * ((u[:, 1] / hx[0]) ** 2 + (u[:, 2] / hx[1]) ** 2
                    + (u[:, 3] / hx[2]) ** 2) / rho
        e_tot = u[:, 4]
        ue = e_tot - ke
        sie = torch.where(ue > cfg.de_switch * e_tot, ue / rho, u[:, 5] / rho)
        return torch.clamp(sie, min=cfg.siefloor), rho

    def set_auxiliary(self, u, cfg: FluidCfg):
        """Dual-energy sync of internal with total energy
        (cf. SetAuxillaryFields, fill_derived.cpp:30-75)."""
        sie, rho = self.sie_from_cons(u, cfg)
        out = u.clone()
        out[:, 5] = torch.maximum(sie * rho, cfg.siefloor * rho)
        return out

    def cons_to_prim(self, u, cfg: FluidCfg):
        """C2P with floors (cf. ConsToPrim, fill_derived.cpp:82-167).
        Interior arrays in, interior prims out (pressure from EOS as the
        subsequent P2C would set it)."""
        rho = torch.clamp(u[:, 0], min=cfg.dfloor)
        hx = self.hxv_int
        v1 = u[:, 1] / (rho * hx[0])
        v2 = u[:, 2] / (rho * hx[1])
        v3 = u[:, 3] / (rho * hx[2])
        if cfg.fluid == "gas":
            sie = torch.clamp(u[:, 5] / rho, min=cfg.siefloor)
            p = (cfg.gamma - 1.0) * rho * sie
            return torch.stack([rho, v1, v2, v3, p, sie], dim=1)
        return torch.stack([rho, v1, v2, v3], dim=1)

    def prim_to_cons(self, w, cfg: FluidCfg):
        """P2C (cf. PrimToCons, fill_derived.cpp:173-277): floors the prims,
        rebuilds conserved fields and the EOS pressure.  Returns (u, w)."""
        hx = self.hxv_int
        rho = torch.clamp(w[:, 0], min=cfg.dfloor)
        v1, v2, v3 = w[:, 1], w[:, 2], w[:, 3]
        m1 = rho * v1 * hx[0]
        m2 = rho * v2 * hx[1]
        m3 = rho * v3 * hx[2]
        if cfg.fluid == "gas":
            sie = torch.clamp(w[:, 5], min=cfg.siefloor)
            eint = sie * rho
            p = (cfg.gamma - 1.0) * rho * sie
            etot = eint + 0.5 * rho * (v1 * v1 + v2 * v2 + v3 * v3)
            return (torch.stack([rho, m1, m2, m3, etot, eint], dim=1),
                    torch.stack([rho, v1, v2, v3, p, sie], dim=1))
        return (torch.stack([rho, m1, m2, m3], dim=1),
                torch.stack([rho, v1, v2, v3], dim=1))

    # -- timestep --------------------------------------------------------
    def dt_denominator(self, w, cfg: FluidCfg):
        """Per-cell CFL denominator sum_d (|v_d| + cs) / dx_d; the fused
        stage kernel reduces the same field to per-block maxima (dtden)."""
        if cfg.fluid == "gas":
            cs = torch.sqrt(cfg.gamma * (cfg.gamma - 1.0) * w[:, 5])
        else:
            cs = 0.0
        denom = 0.0
        for d in self.dims:
            denom = denom + (w[:, d].abs() + cs) / self.widths[d - 1]
        return denom

    def estimate_dt(self, w, cfg: FluidCfg):
        """CFL timestep from interior primitives (cf. Gas::EstimateTimestepMesh,
        gas.cpp:392-468; Dust::EstimateTimestepMesh, dust.cpp:238-276)."""
        return cfg.cfl * torch.min(1.0 / self.dt_denominator(w, cfg))


def _rotation_velocity(grid, xv, omf: float):
    """RotatingFrame::RotationVelocity<GEOM> (src/rotating_frame); None when
    no rotating frame (omf == 0).  Host numpy arrays."""
    if omf == 0.0:
        return None
    x1, x2, x3 = xv
    c = grid.coords
    if geo.is_cartesian(c):
        return None
    if c == "cylindrical":
        return (0.0, omf * x1, 0.0)
    if c == "axisymmetric":
        return (0.0, 0.0, omf * x1)
    if c in ("spherical2D", "spherical3D"):
        return (0.0, 0.0, omf * x1 * np.sin(np.asarray(x2)))
    if c == "spherical1D":
        return (0.0, 0.0, omf * x1)
    return None
