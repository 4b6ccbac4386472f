"""Viscous and thermal diffusion with face fluxes (port of
``artemis_tpu/ops/diffusion.py``).

Rebuild of the reference diffusion framework
(src/utils/diffusion/{diffusion,diffusion_coeff,momentum_diffusion,
thermal_diffusion}.hpp): the full curvilinear viscous stress tensor
  T_j^i = dv^i/dx_j + (h_j^2/h_i^2) dv^j/dx_i + delta_j^i v^k (dh_i/dx_k)/h_i
evaluated on cell faces from contravariant velocities (v^i = v_i / h_i) with
physical centroid distances, a bulk-viscosity term -(1/3)(1-eta) div(v), and
conductive heat flux K grad(T).  Coefficient models: viscosity_plaw,
viscosity_alpha, conductivity_plaw, thermaldiff_plaw; arithmetic or harmonic
face averaging.

All sweeps are whole-array shifted slices on the ghost-padded primitives;
flux arrays live on interior faces with the same convention as ops.hydro.
The geometry fields are made once on the run's device, in its dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import geometry as geo
from .recon import _sh


@dataclass
class DiffParams:
    """Cf. Diffusion::DiffCoeffParams (diffusion_coeff.hpp:58-137)."""

    kind: str          # viscosity_plaw | viscosity_alpha | conductivity_plaw | thermaldiff_plaw
    avg: str = "arithmetic"
    nu_s: float = 0.0
    eta: float = 0.0
    r_exp: float = 0.0
    alpha: float = 0.0
    R0: float = 1.0
    Omega0: float = 1.0
    kappa_0: float = 0.0
    hcond_0: float = 0.0
    temp_exp: float = 0.0
    rho_exp: float = 0.0
    T0: float = 1.0
    d0: float = 1.0

    @classmethod
    def from_input(cls, block, dtype, pin, gm=None):
        type_ = pin.get_str(block, "type")
        avg = pin.get_or_add_str(block, "averaging", "arithmetic")
        if dtype == "viscosity" and type_ in ("constant", "powerlaw"):
            return cls(
                kind="viscosity_plaw", avg=avg,
                nu_s=pin.get_real(block, "nu"),
                eta=pin.get_or_add_real(block, "eta_bulk", 0.0),
                R0=pin.get_or_add_real("problem", "r0", 1.0),
                r_exp=pin.get_or_add_real(block, "r_exp", 0.0),
            )
        if dtype == "viscosity" and type_ == "alpha":
            R0 = pin.get_or_add_real("problem", "r0", 1.0)
            if gm is None:
                raise ValueError("alpha viscosity requires gravity (gm)")
            return cls(
                kind="viscosity_alpha", avg=avg,
                alpha=pin.get_real(block, "alpha"),
                eta=pin.get_or_add_real(block, "eta_bulk", 0.0),
                R0=R0, Omega0=math.sqrt(gm / R0**3),
            )
        if dtype == "conductivity" and type_ == "conductivity":
            return cls(
                kind="conductivity_plaw", avg=avg,
                hcond_0=pin.get_real(block, "cond"),
                temp_exp=pin.get_or_add_real(block, "temp_exp", 0.0),
                rho_exp=pin.get_or_add_real(block, "rho_exp", 0.0),
                d0=pin.get_or_add_real(block, "rho_ref", 1.0),
                T0=pin.get_or_add_real(block, "T_ref", 1.0),
            )
        if dtype == "conductivity" and type_ == "diffusivity":
            return cls(
                kind="thermaldiff_plaw", avg=avg,
                kappa_0=pin.get_real(block, "kappa"),
                temp_exp=pin.get_or_add_real(block, "temp_exp", 0.0),
                rho_exp=pin.get_or_add_real(block, "rho_exp", 0.0),
                d0=pin.get_or_add_real(block, "rho_ref", 1.0),
                T0=pin.get_or_add_real(block, "T_ref", 1.0),
            )
        raise ValueError(f"{type_} in {block} is not supported")


def _face_avg(avg: str, a, b):
    if avg == "arithmetic":
        return 0.5 * (a + b)
    if avg == "harmonic":
        return 2.0 * a * b / (a + b)
    raise ValueError(avg)


class Diffusion:
    """Precomputed geometry + the viscous/thermal flux and update passes.
    The geometry tensors live on ``hyd``'s device, in its dtype."""

    def __init__(self, grid, hyd, gas_cfg, visc: DiffParams = None,
                 cond: DiffParams = None):
        self.grid = grid
        self.hyd = hyd
        self.cfg = gas_cfg
        self.visc = visc
        self.cond = cond
        g = grid.geom
        shape_pad = grid.shape_entire
        self.dims = hyd.dims

        def _t(a):
            return torch.as_tensor(np.array(a), dtype=hyd.dtype,
                                   device=hyd.device)

        # padded scale factors and connection terms (broadcastable)
        self.h_pad = [_t(g.hv(c)) for c in (1, 2, 3)]
        zero1 = np.zeros_like(g.dh2dx1)[None, None, :]
        conn = {
            # conn[i][k] = dh_i/dx_k (volume-averaged)
            1: (zero1, zero1, zero1),
            2: (g.dh2dx1[None, None, :], zero1, zero1),
            3: (g.dh3dx1[None, None, :], g.dh3dx2[None, :, None], zero1),
        }
        self.conn = {i: tuple(_t(c) for c in cs) for i, cs in conn.items()}
        # cartesian centroid coordinates (for physical distances)
        cx, cy, cz = geo.convert_to_cart(
            g.coords, g.xv1[None, None, :], g.xv2[None, :, None],
            g.xv3[:, None, None])
        ccart = [np.broadcast_to(c, shape_pad).astype(np.float64) for c in (cx, cy, cz)]
        # physical distance between neighbors along d (lower-face indexed),
        # and between the +/- neighbors along d (cell centered)
        self.dist1 = {}
        self.dist2 = {}
        for d in self.dims:
            d1 = np.sqrt(sum((c - np.roll(c, 1, axis=-d)) ** 2 for c in ccart))
            d2 = np.sqrt(sum((np.roll(c, -1, axis=-d) - np.roll(c, 1, axis=-d)) ** 2
                             for c in ccart))
            self.dist1[d] = _t(np.maximum(d1, 1e-300))
            self.dist2[d] = _t(np.maximum(d2, 1e-300))
        # padded face areas / volume for div(v)
        self.area_pad = {}
        for d in self.dims:
            shp = list(shape_pad)
            shp[3 - d] += 1
            self.area_pad[d] = _t(np.broadcast_to(g.face_area(d), shp))
        self.vol_pad = _t(np.broadcast_to(g.volume(), shape_pad))
        # face h_d at the lower face along d (interior-face-sized), and all
        # face h_c for the off-diagonal ratios
        self.h_dface = {d: hyd.face_h[d][d - 1] if hyd.face_h else None
                        for d in (1, 2, 3)}
        self.h_cface = hyd.face_h if hyd.face_h else None
        # cylindrical/spherical radii on the padded grid for coeff models
        xcyl = geo.convert_to_cyl(g.coords, g.xv1[None, None, :],
                                  g.xv2[None, :, None], g.xv3[:, None, None])
        xsph = geo.convert_to_sph(g.coords, g.xv1[None, None, :],
                                  g.xv2[None, :, None], g.xv3[:, None, None])
        self.Rcyl_pad = _t(np.broadcast_to(xcyl[0], shape_pad))
        self.rsph_pad = _t(np.broadcast_to(xsph[0], shape_pad))
        self.x1dep = geo.x1dep(grid.coords)
        self.x2dep = geo.x2dep(grid.coords) and grid.active(2)

    # -- coefficient models ---------------------------------------------
    def _mu(self, dp: DiffParams, rho, sie, padded: bool):
        cfg = self.cfg
        if dp.kind == "viscosity_plaw":
            R = self.Rcyl_pad if padded else self.Rcyl_pad[self.grid.int_slices]
            return dp.nu_s * rho * (R / dp.R0) ** dp.r_exp
        if dp.kind == "viscosity_alpha":
            r = self.rsph_pad if padded else self.rsph_pad[self.grid.int_slices]
            Omk = dp.Omega0 * (r / dp.R0) ** -1.5
            bulk = cfg.gamma * (cfg.gamma - 1.0) * rho * sie
            return dp.alpha * bulk / Omk
        T = sie / cfg.cv
        base = (T / dp.T0) ** dp.temp_exp * (rho / dp.d0) ** dp.rho_exp
        if dp.kind == "conductivity_plaw":
            return dp.hcond_0 * base
        if dp.kind == "thermaldiff_plaw":
            return dp.kappa_0 * base * rho * cfg.cv
        raise ValueError(dp.kind)

    # -- div(v), cell-centered on the padded grid -----------------------
    def _divu(self, w_pad):
        divv = 0.0
        for d in self.dims:
            v = w_pad[:, d]
            A = self.area_pad[d]  # faces along d (n_pad+1)
            ax = A.ndim - d
            n = A.shape[ax] - 1
            A_lo = A.narrow(ax, 0, n)
            A_hi = A.narrow(ax, 1, n)
            divv = divv + (A_hi * (v + _sh(v, +1, d)) - A_lo * (v + _sh(v, -1, d)))
        return divv / (2.0 * self.vol_pad)

    # -- viscous + conductive fluxes ------------------------------------
    def fluxes(self, w_pad):
        """dict d -> F[ns, 4, interior faces along d]; rows (m1, m2, m3, en).

        Sign convention: the update subtracts (A F_lo - A F_hi)/vol
        (DiffusionUpdateImpl, diffusion.hpp:118-241)."""
        cfg = self.cfg
        hyd = self.hyd
        out = {}
        rho_pad = w_pad[:, 0]
        sie_pad = w_pad[:, 5]
        h = self.h_pad
        vcon = [w_pad[:, 1 + c] / h[c] for c in range(3)]

        do_visc = self.visc is not None
        do_cond = self.cond is not None
        if do_visc:
            mu_pad = self._mu(self.visc, rho_pad, sie_pad, padded=True)
            divu = self._divu(w_pad)
            # cell-centered diagonal sources src_i = v^k (dh_i/dx_k)
            src = {}
            for i in (1, 2, 3):
                c1, c2, c3 = self.conn[i]
                src[i] = vcon[0] * c1 + vcon[1] * c2 + vcon[2] * c3
        if do_cond:
            kap_pad = self._mu(self.cond, rho_pad, sie_pad, padded=True)
            T_pad = sie_pad / cfg.cv

        for d in self.dims:
            rows = []
            dist1 = self.dist1[d]
            if do_visc:
                mus = _face_avg(self.visc.avg, mu_pad, _sh(mu_pad, -1, d))
                davg = divu + _sh(divu, -1, d)
                hdf = self.h_dface[d] if self.h_dface[d] is not None else 1.0
                mus_i = hyd._faces_interior(mus, d)
                davg_i = hyd._faces_interior(davg, d)
                f_rows = []
                for c in (1, 2, 3):
                    if c == d:
                        # T_d^d = 2 dv^d/dx_d + <v^k dh_d/dx_k>
                        t = (2.0 * (vcon[d - 1] - _sh(vcon[d - 1], -1, d)) / dist1
                             + 0.5 * (src[d] + _sh(src[d], -1, d)))
                        t_i = hyd._faces_interior(t, d)
                        f = hdf * mus_i * (
                            t_i - (1.0 / 3.0) * (1.0 - self.visc.eta) * davg_i)
                    else:
                        # T_c^d = dv^d/dx_c + (h_c/h_d)^2 dv^c/dx_d
                        t = (vcon[c - 1] - _sh(vcon[c - 1], -1, d)) / dist1
                        t_i = hyd._faces_interior(t, d)
                        ratio = 1.0
                        if self.h_cface is not None:
                            hc = self.h_cface[d][c - 1]
                            hd = self.h_cface[d][d - 1]
                            ratio = (hc / hd) ** 2
                        tt_i = 0.0
                        if self.grid.active(c):
                            dist2 = self.dist2[c]
                            tr = (_sh(vcon[d - 1], +1, c)
                                  - _sh(vcon[d - 1], -1, c)) / dist2
                            tt_i = hyd._faces_interior(
                                0.5 * (tr + _sh(tr, -1, d)), d)
                        f = hdf * mus_i * (tt_i + ratio * t_i)
                    f_rows.append(f)
                # energy row: v.T with face-averaged contravariant velocities
                fen = 0.0
                for c in range(3):
                    vavg = 0.5 * (vcon[c] + _sh(vcon[c], -1, d))
                    fen = fen + hyd._faces_interior(vavg, d) * f_rows[c]
                rows = [f_rows[0], f_rows[1], f_rows[2], fen]
            if do_cond:
                kcond = _face_avg(self.cond.avg, kap_pad, _sh(kap_pad, -1, d))
                qf = kcond * (T_pad - _sh(T_pad, -1, d)) / dist1
                qf_i = hyd._faces_interior(qf, d)
                if rows:
                    rows[3] = rows[3] + qf_i
                else:
                    z = torch.zeros_like(qf_i)
                    rows = [z, z, z, qf_i]
            out[d] = torch.stack(rows, dim=1)
        return out

    # -- update ----------------------------------------------------------
    def update(self, u, w, fluxes, dt):
        """Apply diffusion flux divergence + curvilinear sources
        (DiffusionUpdateImpl, diffusion.hpp:114-241)."""
        hyd = self.hyd
        vol = hyd.vol
        do_visc = self.visc is not None
        divf = [0.0, 0.0, 0.0, 0.0]
        diag_avg = {}  # <F_d row d> cell average per direction
        for d in self.dims:
            F = fluxes[d]
            AF = hyd.area[d] * F
            lo = hyd._dfaces(AF, d, 0)
            hi = hyd._dfaces(AF, d, 1)
            for r in range(4):
                divf[r] = divf[r] + (lo[:, r] - hi[:, r]) / vol
            diag_avg[d] = 0.5 * (hyd._dfaces(F[:, d - 1], d, 0)
                                 + hyd._dfaces(F[:, d - 1], d, 1))

        if do_visc and (self.x1dep or self.x2dep):
            for d in self.dims:
                if self.x1dep:
                    divf[0] = divf[0] + hyd.conn1[d - 1] * diag_avg[d]
                if self.x2dep:
                    divf[1] = divf[1] + hyd.conn2[d - 1] * diag_avg[d]

        hx = hyd.hxv_int
        u = u.clone()
        if do_visc:
            u[:, 1] += -dt * divf[0]
            u[:, 2] += -dt * divf[1]
            u[:, 3] += -dt * divf[2]
        u[:, 4] += -dt * divf[3]
        heat = -dt * divf[3]
        if do_visc:
            heat = heat + dt * (divf[0] * w[:, 1] / hx[0]
                                + divf[1] * w[:, 2] / hx[1]
                                + divf[2] * w[:, 3] / hx[2])
        u[:, 5] += heat
        return u

    # -- diffusive timestep ----------------------------------------------
    def estimate_dt(self, w):
        """min(dx)^2 / (2 ndim mu_eff) (Diffusion::EstimateTimestep,
        diffusion.hpp:68-111); a 0-d tensor."""
        cfg = self.cfg
        hyd = self.hyd
        min_dx = None
        for d in hyd.dims:
            wd = torch.broadcast_to(hyd.widths[d - 1], w[:, 0].shape[-3:])
            min_dx = wd if min_dx is None else torch.minimum(min_dx, wd)
        rho = w[:, 0]
        sie = w[:, 5]
        dts = []
        for dp in (self.visc, self.cond):
            if dp is None:
                continue
            mu = self._mu(dp, rho, sie, padded=False)
            if dp.kind == "conductivity_plaw":
                mu = mu / (rho * cfg.cv)
            elif dp.kind in ("viscosity_plaw", "viscosity_alpha"):
                mu = mu * (1.0 + (dp.eta > 1.0) * (dp.eta - 1.0)) / rho
            dts.append(torch.min(min_dx**2 / (mu + 1e-300)))
        ndim = len(hyd.dims)
        return torch.min(torch.stack(dts)) / (2.0 * ndim)
