"""Fused curvilinear gas-hydro RK stage: the CUDA kernel's wrappers, their
plain PyTorch versions and the kernel's coefficient rows (port of the K3,
K4, K5a, K5b and K6 parts of ``artemis_tpu/ops/pallas_stage_curv.py``).

One stage is everything between two ghost fills on every supported
coordinate system (the production disk path): PLM_G/PCM reconstruction,
HLLC/HLLE fluxes with face scale factors, the two-register update with
exact area/volume factors, pressure-gradient/PdV/connection sources, the
rotating-frame torque, central point gravity and viscous/thermal diffusion
folded in, and (full mode) the dual-energy sync, C2P/P2C and the CFL
denominator with the diffusive limit.  Partial mode stops after the flux
sources, where the composable path hands off to the remaining sources.

``stage_curv`` dispatches on the tensor's device: on the CPU it runs
``stage_curv_reference``; on a CUDA device it launches
``csrc/stage_curv.cu`` (which replaces the TPU kernels K3
``stage_curv_gather``, K4 ``stage_curv`` and K5a/K5b, the two frontends of
``stage_curv_gather6``) or raises.  The kernel has three halo sources: the
disk boundary layout (x1/x2 ``ic``, x3 periodic) is gathered in-kernel
from the unpadded interior and the x1/x2 ic strips; the all-``ic`` layout
(the Cartesian disk of the radiation-hydro configuration) from the interior
and six face strips; every other layout is read from primitives padded by
``bc``.  ``stage_curv_batched`` launches the same kernel over N nodes of
one grid shape (a refined tree's nodes, each with its own coefficient rows
and six strips), the node index on the launch grid's y axis: the TPU's
node-batched K6 ``stage_curv_gather6_batched``.  The kernel has two bodies:
every launch, full or partial (K3, K4, K5a, K5b, K6: a gather or a padded
halo), takes the tiled one, which stages each plane of its footprint with
the halo in shared memory and solves each face, hydro and diffusive, once
(``CurvStage.tiled``); the per-cell one is reached only through the
private switch ``_percell_body``.  A full stage writes one dtden entry per
block of its body (``CurvStage.dtden_blocks``), a partial one none.

The coefficient packing (``_axis_pack`` ... ``CurvCoeffs.pack``,
``_dp_tuple``) is numpy only, copied from the JAX module; the rows are
built in float64 and cast to the run's dtype when they move to the device.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from .. import bc as bc_mod
from ..geometry import geometry as geo
from ..profiling import kernel_span

BLOCK = 128  # threads per block of the per-cell body (kBlock); one dtden entry per block
# the tiled body's footprint and planes per block (TileDims: TX, TY, TZ) by
# dtype and whether the stage has diffusion; one dtden entry per block of a
# full stage (a partial one writes none)
TILE = {(torch.float32, False): (32, 8, 16), (torch.float64, False): (32, 4, 16),
        (torch.float32, True): (32, 8, 16), (torch.float64, True): (32, 8, 16)}

# kernel launches since the last reset (the count a run reads to show that
# the main path went through the kernel), and of those (one-node and
# node-batched alike) the launches of the tiled body
stage_curv_launches = 0
tiled_launches = 0
# the one-node launches by halo source (the TPU kernels K4, K3, K5a/K5b)
halo_launches = {"padded": 0, "gather": 0, "gather6": 0}


# ---------------------------------------------------------------------------
# coefficient packing: per-axis 1-D rows over the PADDED axis extents
# ---------------------------------------------------------------------------

def _axis_pack(grid, d):
    """Rows along axis d (padded extents), as a dict name -> 1-D f64 array.
    The reconstruction coordinate rows are shifted by xv[0]: the kernel only
    ever uses their differences (Mignone PLM)."""
    g = grid.geom
    xv = {1: g.xv1, 2: g.xv2, 3: g.xv3}[d]
    xf = {1: g.xf1, 2: g.xf2, 3: g.xf3}[d]
    dx = {1: g.dx1, 2: g.dx2, 3: g.dx3}[d]
    n = len(xv)
    x0 = xv[0]
    rows = {
        "xv": xv - x0,
        "xf_lo": xf[:-1] - x0,
        "xf_hi": xf[1:] - x0,
        "dx": dx,
        "inv_dx": 1.0 / dx,
    }
    assert all(len(v) == n for v in rows.values())
    return rows


def _face_h_factors(grid, d):
    """Separable factors (f1[x1-extent], f2[x2-extent]) of the scale factor
    h_c at the lower-face centroids along direction d, for c = 1..3
    (cf. Geometry.face_h; hx(c,...) is separable in every system)."""
    g = grid.geom
    c = grid.coords
    if d == 1:
        x1 = g.xf1[:-1]          # lower face of each cell (cell-indexed)
        x2 = g.xv2
    elif d == 2:
        if geo.x1dep(c):
            rm, rp = g.xf1[:-1], g.xf1[1:]
            x1 = 2.0 / 3.0 * (rm * rm + rm * rp + rp * rp) / (rm + rp)
        else:
            x1 = g.xv1
        x2 = g.xf2[:-1]
    else:
        if geo.x1dep(c):
            rm, rp = g.xf1[:-1], g.xf1[1:]
            x1 = 2.0 / 3.0 * (rm * rm + rm * rp + rp * rp) / (rm + rp)
        else:
            x1 = g.xv1
        x2 = 0.5 * (g.xf2[:-1] + g.xf2[1:])
    out = []
    for comp in (1, 2, 3):
        h2d = g.hx(comp, x1[None, :], x2[:, None])  # [len(x2), len(x1)]
        f1 = h2d[0, :]
        g0 = np.where(np.abs(f1[0]) > 0, f1[0], 1.0)
        f2 = h2d[:, 0] / g0
        assert np.allclose(np.outer(f2, f1), h2d, rtol=1e-12, atol=1e-300)
        out.append((np.asarray(f1), np.asarray(f2)))
    return out


def _rf_bundle(grid):
    """Separable factorization of the rotating-frame conservative-torque
    ingredients (cf. sources._rf_weights): per direction and side, the flux
    weight is a 2-term separable sum w(i,j) = f1(i) g1(j) + f2(i) g2(j);
    plus phi-hat / R-hat / z-hat basis rows and the cylindrical radius, all
    over the PADDED axis extents."""
    g = grid.geom
    c = grid.coords
    n1 = len(g.xv1)
    n2 = len(g.xv2)
    z1 = np.zeros(n1)
    z2 = np.zeros(n2)
    o1 = np.ones(n1)
    o2 = np.ones(n2)
    zterm = ((z1, z2), (z1, z2))
    weights = {1: (zterm, zterm), 2: (zterm, zterm), 3: (zterm, zterm)}
    rm, rp = g.xf1[:-1], g.xf1[1:]
    if c in ("cylindrical", "axisymmetric"):
        ans = 0.5 * (rm + rp) * (rp - rm)
        t = ((ans, o2), (z1, z2))
        weights[1] = (t, t)
    elif c == "spherical1D":
        rv = g.xv1
        weights[1] = ((((rv**2 - rm**2), o2), (z1, z2)),
                      (((rp**2 - rv**2), o2), (z1, z2)))
    elif c in ("spherical2D", "spherical3D"):
        rv = g.xv1
        stv2 = np.sin(g.xv2) ** 2
        weights[1] = (
            (((rv**2 - rm**2), stv2), (z1, z2)),
            (((rp**2 - rv**2), stv2), (z1, z2)))
        rface = 2.0 / 3.0 * (rm**2 + rm * rp + rp**2) / (rm + rp)
        stm2 = np.sin(g.xf2[:-1]) ** 2
        stp2 = np.sin(g.xf2[1:]) ** 2
        weights[2] = (
            ((rv**2, stv2), (-rface**2, stm2)),
            ((-rv**2, stv2), (rface**2, stp2)))
    if c in ("cylindrical",):
        phihat = [(z1, z2), (o1, o2), (z1, z2)]
        rhat = [(o1, o2), (z1, z2), (z1, z2)]
        zhat = [(z1, z2), (z1, z2), (o1, o2)]
        Rcyl = (g.xv1, o2)
    elif c == "axisymmetric":
        phihat = [(z1, z2), (z1, z2), (o1, o2)]
        rhat = [(o1, o2), (z1, z2), (z1, z2)]
        zhat = [(z1, z2), (o1, o2), (z1, z2)]
        Rcyl = (g.xv1, o2)
    elif c == "spherical1D":
        phihat = [(z1, z2), (z1, z2), (o1, o2)]
        rhat = [(o1, o2), (z1, z2), (z1, z2)]
        zhat = [(z1, z2), (z1, z2), (z1, z2)]
        Rcyl = (g.xv1, o2)
    elif c in ("spherical2D", "spherical3D"):
        phihat = [(z1, z2), (z1, z2), (o1, o2)]
        rhat = [(o1, np.sin(g.xv2)), (o1, np.cos(g.xv2)), (z1, z2)]
        zhat = [(o1, np.cos(g.xv2)), (o1, -np.sin(g.xv2)), (z1, z2)]
        Rcyl = (g.xv1, np.sin(g.xv2))
    else:
        phihat = [(z1, z2)] * 3
        rhat = [(z1, z2)] * 3
        zhat = [(z1, z2)] * 3
        Rcyl = (z1, z2)
    return weights, phihat, rhat, zhat, Rcyl


def _rotation_factors(grid, omf):
    """Separable (f1, f2) factors of the rotation velocity component per
    coordinate direction (RotatingFrame::RotationVelocity)."""
    g = grid.geom
    c = grid.coords
    n1, n2 = len(g.xv1), len(g.xv2)
    zero = (np.zeros(n1), np.zeros(n2))
    one2 = np.ones(n2)
    if omf == 0.0 or geo.is_cartesian(c):
        return [zero, zero, zero]
    if c == "cylindrical" or c == "spherical1D":
        return [zero, (omf * g.xv1, one2), zero]
    if geo.is_spherical(c):
        return [zero, zero, (omf * g.xv1, np.sin(g.xv2))] \
            if c in ("spherical2D", "spherical3D") else [zero, zero, zero]
    if c == "axisymmetric":
        return [zero, zero, (omf * g.xv1, one2)]
    return [zero, zero, zero]


def _delta_rows(xv, two_sided: bool):
    """|x_i - x_{i-1}| (face-indexed at cell i) or |x_{i+1} - x_{i-1}|
    (cell-centered, two_sided) rows; edge entries cloned (never used at
    valid faces)."""
    d = np.empty_like(xv)
    if two_sided:
        d[1:-1] = xv[2:] - xv[:-2]
        d[0], d[-1] = d[1], d[-2]
    else:
        d[1:] = xv[1:] - xv[:-1]
        d[0] = d[1]
    return np.abs(d)


def _dist_factors(grid, d: int, two_sided: bool):
    """Separable (f1, f2, f3) per-axis rows of the physical distance between
    neighbor centroids along axis d (chord distances)."""
    g = grid.geom
    c = grid.coords
    o1 = np.ones_like(g.xv1)
    o2 = np.ones_like(g.xv2)
    o3 = np.ones_like(g.xv3)
    xv = {1: g.xv1, 2: g.xv2, 3: g.xv3}[d]
    dlin = _delta_rows(xv, two_sided)
    dang = 2.0 * np.sin(0.5 * dlin)  # chord of an angular separation
    f1, f2, f3 = o1, o2, o3
    if d == 1:
        f1 = dlin
    elif d == 2:
        if c == "cylindrical":                      # x2 = phi
            f1, f2 = g.xv1, dang
        elif geo.is_spherical(c):                   # x2 = theta
            f1, f2 = g.xv1, dang
        else:                                        # axisymmetric x2 = z
            f2 = dlin
    else:
        if c == "cylindrical":                       # x3 = z
            f3 = dlin
        elif geo.is_spherical(c):                    # x3 = phi
            f1, f2, f3 = g.xv1, np.sin(g.xv2), dang
        elif c == "axisymmetric":                    # x3 = phi
            f1, f3 = g.xv1, dang
        else:
            f3 = dlin
    return np.asarray(f1), np.asarray(f2), np.asarray(f3)


def _zcart_factors(grid):
    """Separable (f1, f2, f3) rows of the Cartesian z coordinate (for the
    spherical radius used by alpha viscosity: r^2 = Rcyl^2 + z^2)."""
    g = grid.geom
    c = grid.coords
    o1 = np.ones_like(g.xv1)
    o2 = np.ones_like(g.xv2)
    o3 = np.ones_like(g.xv3)
    z1 = np.zeros_like(g.xv1)
    if geo.is_spherical(c):
        return g.xv1, np.cos(g.xv2) if geo.x2dep(c) else o2 * 0.0, o3
    if c == "cylindrical":
        return o1, o2, g.xv3
    if c == "axisymmetric":
        return o1, g.xv2, o3
    return z1, o2, o3


# viscosity/conduction models the fused kernel can evaluate from separable
# coefficient rows (DiffusionCoeff<...>, diffusion_coeff.hpp)
_DIFF_KINDS = ("viscosity_plaw", "viscosity_alpha", "conductivity_plaw",
               "thermaldiff_plaw")


def _dp_tuple(dp):
    """Flatten DiffParams into (kind, avg, a, b, c, d, e, f) with per-kind
    slot meanings (see mu_model in the kernel)."""
    if dp is None:
        return None
    if dp.kind == "viscosity_plaw":
        return (dp.kind, dp.avg, dp.nu_s, dp.eta, dp.r_exp, dp.R0, 0.0, 0.0)
    if dp.kind == "viscosity_alpha":
        return (dp.kind, dp.avg, dp.alpha, dp.eta, dp.R0, dp.Omega0, 0.0, 0.0)
    coef = dp.hcond_0 if dp.kind == "conductivity_plaw" else dp.kappa_0
    return (dp.kind, dp.avg, coef, 0.0, dp.temp_exp, dp.rho_exp, dp.T0, dp.d0)


class CurvCoeffs:
    """Per-grid coefficient bundle for the curvilinear stage kernel."""

    def __init__(self, grid, omf: float, dtype=np.float64, diff=None):
        g = grid.geom
        c = grid.coords
        self.coords = c
        ax = {d: _axis_pack(grid, d) for d in (1, 2, 3)}

        def cells(d, row):
            return ax[d][row]

        # per-direction update factors A_d/V split per axis
        self.upd = {}
        vol = {1: g.vol1, 2: g.vol2, 3: g.vol3}
        areas = {
            1: (g.area1_f1, g.area1_c2, g.area1_c3),
            2: (g.area2_f2, g.area2_c1, g.area2_c3),
            3: (g.area3_f3, g.area3_c1, g.area3_c2),
        }
        for d in (1, 2, 3):
            af, cA, cB = areas[d]
            self.upd[d] = {
                "face": af,                # length n_d + 1
                "inv_vol_d": 1.0 / vol[d],
            }
            if d == 1:
                self.upd[d]["t2"] = cA / vol[2]
                self.upd[d]["t3"] = cB / vol[3]
            elif d == 2:
                self.upd[d]["t1"] = cA / vol[1]
                self.upd[d]["t3"] = cB / vol[3]
            else:
                self.upd[d]["t1"] = cA / vol[1]
                self.upd[d]["t2"] = cB / vol[2]

        self.recon = {d: (cells(d, "xv"), cells(d, "xf_lo"),
                          cells(d, "xf_hi"), cells(d, "dx")) for d in (1, 2, 3)}
        self.inv_dxc = {d: cells(d, "inv_dx") for d in (1, 2, 3)}
        self.face_h = {d: _face_h_factors(grid, d) for d in (1, 2, 3)}
        # hv factors (volume-averaged scale factors per component)
        self.hv = [(g.h1v_1, g.h1v_2), (g.h2v_1, g.h2v_2), (g.h3v_1, g.h3v_2)]
        # connection rows
        self.conn1 = (np.zeros_like(g.dh2dx1), g.dh2dx1, g.dh3dx1)  # x1 rows
        self.conn2 = g.dh3dx2                                        # x2 row
        self.x1dep = geo.x1dep(c)
        self.x2dep = geo.x2dep(c) and grid.nx[1] > 1
        self.vrot = _rotation_factors(grid, omf)
        self.rf = _rf_bundle(grid)
        # physical widths for the CFL denominator: w_d = dx_d * h_d(xv)
        hvx = lambda comp: g.hx(comp, g.xv1[None, :], g.xv2[:, None])
        self.inv_w = {}
        for d in (1, 2, 3):
            h2d = hvx(d)  # [n2, n1]
            f1 = h2d[0, :]
            f2 = h2d[:, 0] / np.where(np.abs(f1[0]) > 0, f1[0], 1.0)
            if d == 1:
                self.inv_w[d] = (1.0 / (g.dx1 * f1), 1.0 / f2)
            elif d == 2:
                self.inv_w[d] = (1.0 / f1, 1.0 / (g.dx2 * f2))
            else:
                # h3 separable f1(x1) f2(x2); width = dx3 * f1 * f2
                self.inv_w[d] = (1.0 / f1, 1.0 / f2)
        self.dx3 = g.dx3
        self.dtype = dtype
        self.zc = _zcart_factors(grid)  # cartesian z rows (rsph, gravity)
        # raw padded cell-center coordinates (NOT the shifted recon rows):
        # the Cartesian xyz gravity mode needs absolute positions
        self.xyzc = (g.xv1, g.xv2, g.xv3)
        # fused diffusion (viscosity/conduction) coefficient rows
        self.diff = None
        if diff is not None:
            if geo.is_cartesian(c):
                # the coefficient models factor through the cylindrical
                # radius, which is not (x)*(y)-separable on a Cartesian grid:
                # raise so the Driver keeps the composable diffusion pass
                raise ValueError("fused diffusion rows are not separable "
                                 "on Cartesian grids")
            for dp in (diff.visc, diff.cond):
                if dp is not None and dp.kind not in _DIFF_KINDS:
                    raise ValueError(f"unsupported diffusion kind {dp.kind}")
            self.diff = diff
            self.dims = [d for d in (1, 2, 3) if grid.active(d)]
            self.dist1 = {d: _dist_factors(grid, d, False) for d in self.dims}
            self.dist2 = {d: _dist_factors(grid, d, True) for d in self.dims}

    def pack(self):
        """Pack every row into three matrices CX [*, n1], CY [*, n2],
        CZ [*, n3] + an index map."""
        rows_x, rows_y, rows_z = [], [], []
        ix = {}
        cart_rows = geo.is_cartesian(self.coords)

        def add(rows, key, arr):
            rows.append(np.asarray(arr, self.dtype))
            return len(rows) - 1

        # X rows
        for d in (1, 2, 3):
            if d == 1:
                xv, xlo, xhi, dx = self.recon[1]
                ix["recon1"] = tuple(add(rows_x, None, a)
                                     for a in (xv, xlo, xhi, dx))
                ix["upd1_face"] = add(rows_x, None, self.upd[1]["face"][:-1])
                ix["upd1_facep"] = add(rows_x, None, self.upd[1]["face"][1:])
                ix["upd1_iv"] = add(rows_x, None, self.upd[1]["inv_vol_d"])
                ix["idx1"] = add(rows_x, None, self.inv_dxc[1])
            ix[f"upd{d}_t1"] = add(rows_x, None, self.upd[d].get(
                "t1", np.ones_like(self.recon[1][0])))
            ix[f"fh{d}_1"] = tuple(add(rows_x, None, self.face_h[d][cmp][0])
                                   for cmp in range(3))
        ix["hv_1"] = tuple(add(rows_x, None, self.hv[cmp][0]) for cmp in range(3))
        ix["conn1"] = tuple(add(rows_x, None, a) for a in self.conn1)
        ix["vrot_1"] = tuple(add(rows_x, None, self.vrot[cmp][0])
                             for cmp in range(3))
        ix["invw_1"] = tuple(add(rows_x, None, self.inv_w[d][0])
                             for d in (1, 2, 3))
        weights, phihat, rhat, zhat, Rcyl = self.rf
        for d in (1, 2, 3):
            lo_t, hi_t = weights[d]
            ix[f"rfw{d}_lo_1"] = tuple(add(rows_x, None, t[0]) for t in lo_t)
            ix[f"rfw{d}_hi_1"] = tuple(add(rows_x, None, t[0]) for t in hi_t)
        ix["phihat_1"] = tuple(add(rows_x, None, phihat[c][0]) for c in range(3))
        ix["rhat_1"] = tuple(add(rows_x, None, rhat[c][0]) for c in range(3))
        ix["zhat_1"] = tuple(add(rows_x, None, zhat[c][0]) for c in range(3))
        ix["rcyl_1"] = add(rows_x, None, Rcyl[0])
        ix["zc_1"] = add(rows_x, None, self.zc[0])
        if cart_rows:
            ix["gx_1"] = add(rows_x, None, self.xyzc[0])

        # Y rows
        xv, xlo, xhi, dx = self.recon[2]
        ix["recon2"] = tuple(add(rows_y, None, a) for a in (xv, xlo, xhi, dx))
        ix["upd2_face"] = add(rows_y, None, self.upd[2]["face"][:-1])
        ix["upd2_facep"] = add(rows_y, None, self.upd[2]["face"][1:])
        ix["upd2_iv"] = add(rows_y, None, self.upd[2]["inv_vol_d"])
        ix["idx2"] = add(rows_y, None, self.inv_dxc[2])
        for d in (1, 3):
            ix[f"upd{d}_t2"] = add(rows_y, None, self.upd[d]["t2"])
        for d in (1, 2, 3):
            ix[f"fh{d}_2"] = tuple(add(rows_y, None, self.face_h[d][cmp][1])
                                   for cmp in range(3))
        ix["hv_2"] = tuple(add(rows_y, None, self.hv[cmp][1]) for cmp in range(3))
        ix["conn2"] = add(rows_y, None, self.conn2)
        ix["vrot_2"] = tuple(add(rows_y, None, self.vrot[cmp][1])
                             for cmp in range(3))
        ix["invw_2"] = tuple(add(rows_y, None, self.inv_w[d][1])
                             for d in (1, 2, 3))
        for d in (1, 2, 3):
            lo_t, hi_t = weights[d]
            ix[f"rfw{d}_lo_2"] = tuple(add(rows_y, None, t[1]) for t in lo_t)
            ix[f"rfw{d}_hi_2"] = tuple(add(rows_y, None, t[1]) for t in hi_t)
        ix["phihat_2"] = tuple(add(rows_y, None, phihat[c][1]) for c in range(3))
        ix["rhat_2"] = tuple(add(rows_y, None, rhat[c][1]) for c in range(3))
        ix["zhat_2"] = tuple(add(rows_y, None, zhat[c][1]) for c in range(3))
        ix["rcyl_2"] = add(rows_y, None, Rcyl[1])
        ix["zc_2"] = add(rows_y, None, self.zc[1])
        if cart_rows:
            ix["gy_2"] = add(rows_y, None, self.xyzc[1])

        # Z rows
        xv, xlo, xhi, dx = self.recon[3]
        ix["recon3"] = tuple(add(rows_z, None, a) for a in (xv, xlo, xhi, dx))
        ix["upd3_face"] = add(rows_z, None, self.upd[3]["face"][:-1])
        ix["upd3_facep"] = add(rows_z, None, self.upd[3]["face"][1:])
        ix["upd3_iv"] = add(rows_z, None, self.upd[3]["inv_vol_d"])
        ix["idx3"] = add(rows_z, None, self.inv_dxc[3])
        for d in (1, 2):
            ix[f"upd{d}_t3"] = add(rows_z, None, self.upd[d]["t3"])
        ix["inv_dx3"] = add(rows_z, None, 1.0 / self.dx3)
        ix["zc_3"] = add(rows_z, None, self.zc[2])
        if cart_rows:
            ix["gz_3"] = add(rows_z, None, self.xyzc[2])

        # diffusion rows (distance chords)
        if self.diff is not None:
            for d in self.dims:
                for nm, bundle in (("d1", self.dist1), ("d2", self.dist2)):
                    f1, f2, f3 = bundle[d]
                    ix[f"{nm}_{d}_1"] = add(rows_x, None, f1)
                    ix[f"{nm}_{d}_2"] = add(rows_y, None, f2)
                    ix[f"{nm}_{d}_3"] = add(rows_z, None, f3)

        CX = np.stack(rows_x)
        CY = np.stack(rows_y)
        CZ = np.stack(rows_z)
        return CX, CY, CZ, ix


def _flat_ix(ix) -> list:
    """The row indices in the order of the kernel's CurvIdx struct
    (csrc/stage_curv.cu); -1 where a row does not exist."""
    get = lambda k: ix.get(k, -1)

    def dist(nm, a):
        return [get(f"{nm}_{d}_{a}") for d in (1, 2, 3)]

    def rfw(side, a):
        return [t for d in (1, 2, 3) for t in ix[f"rfw{d}_{side}_{a}"]]

    def fh(a):
        return [t for d in (1, 2, 3) for t in ix[f"fh{d}_{a}"]]

    out = list(ix["recon1"]) + [ix["upd1_face"], ix["upd1_facep"], ix["upd1_iv"], ix["idx1"]]
    out += [ix[f"upd{d}_t1"] for d in (1, 2, 3)] + fh(1)
    out += list(ix["hv_1"]) + list(ix["conn1"]) + list(ix["vrot_1"]) + list(ix["invw_1"])
    out += rfw("lo", 1) + rfw("hi", 1)
    out += list(ix["phihat_1"]) + list(ix["rhat_1"]) + list(ix["zhat_1"])
    out += [ix["rcyl_1"], ix["zc_1"], get("gx_1")] + dist("d1", 1) + dist("d2", 1)

    out += list(ix["recon2"]) + [ix["upd2_face"], ix["upd2_facep"], ix["upd2_iv"], ix["idx2"]]
    out += [ix["upd1_t2"], -1, ix["upd3_t2"]] + fh(2)
    out += list(ix["hv_2"]) + [ix["conn2"]] + list(ix["vrot_2"]) + list(ix["invw_2"])
    out += rfw("lo", 2) + rfw("hi", 2)
    out += list(ix["phihat_2"]) + list(ix["rhat_2"]) + list(ix["zhat_2"])
    out += [ix["rcyl_2"], ix["zc_2"], get("gy_2")] + dist("d1", 2) + dist("d2", 2)

    out += list(ix["recon3"]) + [ix["upd3_face"], ix["upd3_facep"], ix["upd3_iv"], ix["idx3"]]
    out += [ix["upd1_t3"], ix["upd2_t3"], -1]
    out += [ix["inv_dx3"], ix["zc_3"], get("gz_3")] + dist("d1", 3) + dist("d2", 3)
    return out


# ---------------------------------------------------------------------------
# gates and halo strips
# ---------------------------------------------------------------------------

def supported_curv(grid, cfg) -> bool:
    """Is the config inside the curvilinear stage kernel's envelope?  (The
    TPU's ny%TY, nz%TZ and 128-lane rules were Mosaic alignment rules; this
    kernel masks ragged edges instead.)  Cartesian grids are admitted too:
    the Driver only routes them here when the source-free Cartesian kernel
    does not apply."""
    return (cfg is not None and cfg.fluid == "gas" and cfg.nspecies == 1
            and cfg.rsolver in ("hllc", "hlle") and cfg.recon in ("plm", "pcm")
            and grid.nghost == 2 and grid.nx[0] > 1 and grid.nx[1] > 1)


def gather_supported(grid, cfg, bc_custom) -> bool:
    """Gate for the in-kernel halo gather: the disk boundary layout (x1/x2
    = ic custom fills with value caches, x3 periodic), 3-D."""
    if not supported_curv(grid, cfg):
        return False
    if grid.nx[2] <= 1 or grid.bc[2] != ("periodic", "periodic"):
        return False
    if any(grid.bc[d] != ("ic", "ic") for d in (0, 1)):
        return False
    ic = bc_custom.get("ic") if bc_custom else None
    caches = getattr(ic, "shard_caches", None)
    if not caches:
        return False
    return all(k in caches[0] for k in ((1, 0), (1, 1), (2, 0), (2, 1)))


def gather6_supported(grid) -> bool:
    """Grid gate for the six-face strip gather (the boundary sourcing, all
    six faces ``ic`` with value caches, is the caller's check).  The TPU's
    nx%128, ny%TY and nz%TZ rules were Mosaic tiling rules."""
    return grid.nghost == 2 and grid.nx[0] > 1 and grid.nx[1] > 1 and grid.nx[2] > 1


def gather6_batch_ok(stages) -> bool:
    """May these nodes' stages run as one node-batched six-face launch?
    (``gather6_batch_ok``, pallas_stage_curv.py:2446: two or more nodes of
    one grid shape and ghost width, Cartesian, without diffusion or a
    folded rotating frame, with the same point-gravity scalars; here also
    no more than the kernel's node table holds, MAX_NODES.)"""
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


def prepare_gather_strips(grid, ic_caches):
    """The halo strips of the gather kernel from the ic BC value caches
    (make_ic_bc's shard_caches[0]), numpy: x1 lo/hi ghost slabs over the
    padded y and z extents [6, zp, yp, ng], and x2 lo/hi ghost slabs over the
    padded z extent and the interior x range [6, zp, ng, nx]."""
    ng = grid.nghost
    nx = grid.nx[0]
    out = {}
    for side in (0, 1):
        out[("x1", side)] = np.ascontiguousarray(np.asarray(ic_caches[(1, side)])[0])
        out[("x2", side)] = np.ascontiguousarray(
            np.asarray(ic_caches[(2, side)])[0][:, :, :, ng:ng + nx])
    return out


def prepare_gather6_root_strips(grid, ic_caches):
    """The six-face strips of an all-``ic`` grid: the x1/x2 strips of
    ``prepare_gather_strips`` and x3 lo/hi ghost slabs over the interior x
    and y ranges [6, ng, ny, nx] (the kernel takes x1 before x2 before x3
    where they overlap; the TPU layout's 8-row alignment margins are not
    carried over)."""
    out = prepare_gather_strips(grid, ic_caches)
    ng = grid.nghost
    nx, ny, _ = grid.nx
    for side in (0, 1):
        a = np.asarray(ic_caches[(3, side)])[0]   # [6, ng, yp, xp]
        out[("x3", side)] = np.ascontiguousarray(a[:, :, ng:ng + ny, ng:ng + nx])
    return out


# ---------------------------------------------------------------------------
# the stage
# ---------------------------------------------------------------------------

_GRAV_MODES = {"sph": 0, "cart": 1, "xyz": 2}
_DIFF_CODES = {"viscosity_plaw": 0, "viscosity_alpha": 1, "conductivity_plaw": 2,
               "thermaldiff_plaw": 3}


def _diff_reals(dp, gamma):
    """The kernel's six coefficients of a diffusion model (CurvReals)."""
    kind, _, a, b, c, d, e, f = _dp_tuple(dp)
    if kind == "viscosity_plaw":
        return [a, b, c, 1.0 / d, 0.0, 0.0]
    if kind == "viscosity_alpha":
        return [a * gamma * (gamma - 1.0), b, 1.0 / (c * c), 1.0 / d, 0.0, 0.0]
    return [a, 0.0, c, d, 1.0 / e, 1.0 / f]


class CurvStage:
    """One driver's curvilinear stage, made once: the coefficient rows on
    the run's device in its dtype, the halo strips for the gather variant
    (``strips``, numpy from ``prepare_gather_strips``, or from
    ``prepare_gather6_root_strips`` for the six-face variant, or None), the
    boundary fills for the padded variant, and what the kernel folds in:
    the rotation velocity ``omf`` of the flux sources, the curvilinear
    ``rotating`` frame torque, a central point-mass ``gravity`` source with
    its mode (sph, cart or xyz; see ``driver.curv_point_grav``) and the
    ``diffusion`` passes.  ``full=False`` stops after the flux sources."""

    def __init__(self, hyd, *, omf=0.0, rotating=None, gravity=None, gmode=None,
                 diffusion=None, full=True, strips=None, bc_custom=None):
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
        self.coeffs = CurvCoeffs(grid, omf, dtype=np.float64, diff=diffusion)
        CX, CY, CZ, ix = self.coeffs.pack()

        def dev(a):
            return torch.as_tensor(np.array(a), dtype=hyd.dtype,
                                   device=hyd.device)

        self.rows = (dev(CX), dev(CY), dev(CZ))
        self.strips = None if strips is None else {k: dev(v) for k, v in strips.items()}
        nx, ny, nz = grid.nx
        g1, g2, g3 = grid.ng
        co = self.coeffs
        visc = diffusion.visc if diffusion is not None else None
        cond = diffusion.cond if diffusion is not None else None
        # the kernel's diffusive stage (its tiled body's own layout)
        self.diffusive = visc is not None or cond is not None
        self._ints_head = [nx, ny, nz, g1, g2, g3, CX.shape[1], CY.shape[1], CZ.shape[1]]
        self._ints_tail = [
            int(cfg.rsolver == "hlle"), int(co.x1dep), int(co.x2dep),
            int(any(np.any(f1 != 0) for f1, _ in co.vrot)),
            -1 if gmode is None else _GRAV_MODES[gmode],
            -1 if visc is None else _DIFF_CODES[visc.kind],
            int(visc is not None and visc.avg == "harmonic"),
            -1 if cond is None else _DIFF_CODES[cond.kind],
            int(cond is not None and cond.avg == "harmonic"),
        ] + _flat_ix(ix)
        rf_omega = rotating.omega if rotating is not None else 0.0
        grav = ([gravity.gm, gravity.soft2, *gravity.pos] if gravity is not None
                else [0.0] * 5)
        self._reals_mid = [cfg.gamma, cfg.cv, cfg.dfloor, cfg.siefloor, cfg.de_switch,
                           rf_omega] + grav
        self._reals_tail = ((_diff_reals(visc, cfg.gamma) if visc else [0.0] * 6)
                            + (_diff_reals(cond, cfg.gamma) if cond else [0.0] * 6)
                            + [1e-30 if hyd.dtype == torch.float32 else 1e-300])

    @property
    def halo(self) -> str:
        """The halo source the kernel takes unless asked for the padded one:
        "gather6" (six face strips), "gather" (x1/x2 strips, x3 wrapped) or
        "padded"."""
        if self.strips is None:
            return "padded"
        return "gather6" if ("x3", 0) in self.strips else "gather"

    def dtden_blocks(self, tiled=False) -> int:
        """Entries of the kernel's dtden output: one per block of the
        per-cell body, or of the tiled body when ``tiled``."""
        nx, ny, nz = self.grid.nx
        if not tiled:
            return -(-(nx * ny * nz) // BLOCK)
        tx, ty, tz = TILE[(self.hyd.dtype, self.diffusive)]
        return -(-nx // tx) * -(-ny // ty) * -(-nz // tz)

    def tiled(self, halo) -> bool:
        """Does a launch with halo source ``halo`` take the tiled body?
        Full and partial stages of every halo source do (K3, K5a, K5b, K6
        gathered, K4 padded), with or without diffusion, on the kernel's
        ghost width of two (none along x3 for a 2-D grid), unless
        ``_percell_body`` is on."""
        nz = self.grid.nx[2]
        return (halo in HALO_CODES and not _percell
                and tuple(self.grid.ng) == (2, 2, 2 if nz > 1 else 0))


def stage_curv_reference(cs: CurvStage, w, u0, u1, gam0, gam1, beta, dt, time, force_pcm,
                         w_pad=None):
    """The plain version: the composable sequence pad_and_fill (or the
    given padded prims ``w_pad``) ->
    compute_fluxes -> apply_update -> flux_source(omf) -> Diffusion
    fluxes/update -> Gravity point kick -> RotatingFrame torque, then (full)
    set_auxiliary -> C2P -> P2C and the CFL denominator maximum with the
    diffusive limit.  Returns (u, w, dtden) with dtden of shape (1,)
    (zero in partial mode, where w passes through)."""
    hyd, cfg = cs.hyd, cs.cfg
    bdt = beta * dt
    if w_pad is None:
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


def stage_curv(cs: CurvStage, w, u0, u1, gam0, gam1, beta, dt, time, force_pcm,
               padded=False, strips=None, w_pad=None):
    """One fused curvilinear RK stage from interior prims ``w`` [1, 6, nz,
    ny, nx] and the registers u0, u1; ``dt`` is a one-element tensor on w's
    device, ``time`` the stage's host time (the gravity window).  The halo
    comes from this call's six face strips ``strips`` (a refined patch's,
    which change every stage), or its padded prims ``w_pad``, or else (on
    the GPU) from ``cs``'s strips (``cs.halo``) unless ``padded``, else
    from ``bc.pad_and_fill``'s array.  Returns (u, w, dtden); on the GPU
    dtden holds one maximum per block (full mode)."""
    if strips is not None:
        halo = "gather6"
    elif w_pad is None and cs.strips is not None and not padded:
        halo = cs.halo
    else:
        halo = "padded"
    if w.device.type == "cpu":
        with kernel_span(KERNEL_NAMES[halo], "plain", w.device):
            if strips is not None:
                w_pad = pad_from_strips(w, cs.grid, strips)
            return stage_curv_reference(cs, w, u0, u1, gam0, gam1, beta, dt, time,
                                        force_pcm, w_pad=w_pad)
    if w.device.type != "cuda":
        raise RuntimeError(f"no curvilinear stage kernel for device {w.device}")
    if halo != "padded":
        return _launch(cs, w, w, u0, u1, gam0, gam1, beta, dt, time, force_pcm, halo,
                       strips=strips)
    if w_pad is None:
        w_pad = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)
    return _launch(cs, w_pad, w, u0, u1, gam0, gam1, beta, dt, time, force_pcm, "padded")


def build_defines(dtype, full=True):
    """The macros that build the kernel's library for one dtype and one
    mode only, full or partial (the four builds run in parallel, each a
    quarter of the kernels)."""
    return (f"ARTEMIS_CURV_DTYPE={0 if dtype == torch.float32 else 1}",
            f"ARTEMIS_CURV_FULL={int(bool(full))}")


def _lib(dtype, full=True):
    from .. import _build

    fn = _build.load("stage_curv", build_defines(dtype, full)).artemis_stage_curv
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = i
        fn.argtypes = [i, i, i, i, p, p, p, i, i, i, p]
    return fn


# Measurement only: while on, every launch, full or partial, takes the
# per-cell body, so that chip_smoke.py and the tests can time and compare
# the two designs on one state.  Nothing in Simulation, the deck or the CLI
# reaches it.
_percell = False


@contextlib.contextmanager
def _percell_body():
    global _percell
    before, _percell = _percell, True
    try:
        yield
    finally:
        _percell = before


# the kernel's halo source codes (kPadded, kGather, kGather6)
HALO_CODES = {"padded": 0, "gather": 1, "gather6": 2}
# the TPU kernel each halo source of a one-node launch replaces (K4, K3,
# K5a/K5b), and of a node-batched launch (K6): the names kernel_table gives
# their rows
KERNEL_NAMES = {"padded": "stage_curv", "gather": "stage_curv_gather",
                "gather6": "stage_curv_gather6"}
BATCHED_NAME = "stage_curv_gather6_batched"
STRIP_KEYS = (("x1", 0), ("x1", 1), ("x2", 0), ("x2", 1), ("x3", 0), ("x3", 1))
MAX_NODES = 16  # the kernel's kMaxNodes


def strip_shapes(grid):
    """The six-face strips' shapes (STRIP_KEYS order): x1 [6, zp, yp, ng],
    x2 [6, zp, ng, nx], x3 [6, ng, ny, nx]."""
    nx, ny, nz = grid.nx
    g1, g2, g3 = grid.ng
    zp, yp = nz + 2 * g3, ny + 2 * g2
    return ((6, zp, yp, g1),) * 2 + ((6, zp, g2, nx),) * 2 + ((6, g3, ny, nx),) * 2


def _launch(cs, src, w, u0, u1, gam0, gam1, beta, dt, time, force_pcm, halo, strips=None):
    """Launch the kernel for one node with halo source ``halo`` (a
    HALO_CODES key) on primitives ``src`` (the interior ``w`` itself when
    gathering, else the padded array), with ``strips`` or else the stage's
    own strips."""
    global stage_curv_launches
    if strips is None:
        strips = cs.strips
        if halo != "padded" and halo != cs.halo:
            raise ValueError(f"a {halo} launch needs the {halo} strips; the stage has "
                             f"{cs.halo}")
    out = _launch_nodes([cs], [src], [u0], [u1], gam0, gam1, beta, dt, time, force_pcm,
                        halo, [strips if halo != "padded" else None])
    stage_curv_launches += 1
    halo_launches[halo] += 1
    u, w_out, dmax = out[0]
    if not cs.full:
        return u, w, torch.zeros(1, dtype=u.dtype, device=u.device)
    return u, w_out, dmax


def _launch_nodes(stages, srcs, u0s, u1s, gam0, gam1, beta, dt, time, force_pcm, halo,
                  strips_list, name=None):
    """One launch over the nodes of ``stages`` (one grid shape, the same
    scalars): node k reads ``srcs[k]``, its registers and ``strips_list[k]``
    (a STRIP_KEYS dict, or None for the padded halo).  ``name``: the TPU
    kernel the launch stands for in ``kernel_table`` (by default the
    one-node kernel of ``halo``).  Returns one (u, w, dtden) per node; w is
    None in partial mode."""
    global tiled_launches
    cs0 = stages[0]
    nx, ny, nz = cs0.grid.nx
    g1, g2, g3 = cs0.grid.ng
    gather = halo != "padded"
    shape = (1, 6, nz, ny, nx)
    src_shape = shape if gather else (1, 6, nz + 2 * g3, ny + 2 * g2, nx + 2 * g1)
    dtype, device = srcs[0].dtype, srcs[0].device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stage_curv kernel takes float32 or float64, not {dtype}")
    if not 1 <= len(stages) <= MAX_NODES:
        raise ValueError(f"a launch takes 1 to {MAX_NODES} nodes, not {len(stages)}")
    if dt.numel() != 1:
        raise ValueError("dt must be a one-element tensor")
    ints = cs0._ints_head + [int(force_pcm or cs0.cfg.recon == "pcm")] + cs0._ints_tail
    gfac = 1.0 if cs0.gravity is None or cs0.gravity.active(time) else 0.0
    reals = [float(gam0), float(gam1), float(beta)] + cs0._reals_mid + [gfac] + cs0._reals_tail
    ptr = lambda t: None if t is None else t.data_ptr()
    tiled = cs0.tiled(halo)
    ptrs = [dt.data_ptr()]
    outs = []
    for cs, src, u0, u1, strips in zip(stages, srcs, u0s, u1s, strips_list):
        if cs is not cs0 and (
                cs.grid.nx != cs0.grid.nx or cs.grid.ng != cs0.grid.ng
                or cs._ints_head != cs0._ints_head or cs._ints_tail != cs0._ints_tail
                or cs._reals_mid != cs0._reals_mid or cs._reals_tail != cs0._reals_tail
                or cs.full != cs0.full
                or (cs.gravity is None) != (cs0.gravity is None)
                or (cs.gravity is not None and cs.gravity.active(time) != bool(gfac))):
            raise ValueError("the nodes of one launch must share the grid shape and "
                             "every scalar of the stage")
        if tuple(src.shape) != src_shape:
            raise ValueError(f"prims of shape {tuple(src.shape)}, expected {src_shape}")
        live = [t for t, g in ((u0, gam0), (u1, gam1)) if g != 0.0]
        for t in live:
            if tuple(t.shape) != shape:
                raise ValueError(f"register of shape {tuple(t.shape)}, expected {shape}")
        strip_ts = [] if not gather else [strips[k] for k in STRIP_KEYS
                                          if strips.get(k) is not None]
        if gather:
            want = strip_shapes(cs.grid)[:len(strip_ts)]
            if [tuple(t.shape) for t in strip_ts] != list(want):
                raise ValueError("halo strips of the wrong shape")
        for t in [src, dt, *live, *cs.rows, *strip_ts]:
            if t.device != device or t.dtype != dtype or not t.is_contiguous():
                raise ValueError("stage_curv kernel inputs must be contiguous tensors of "
                                 "one dtype on one device")
        u = torch.empty(shape, dtype=dtype, device=device)
        w_out = torch.empty(shape, dtype=dtype, device=device) if cs.full else None
        dmax = (torch.empty((cs.dtden_blocks(tiled),), dtype=dtype, device=device)
                if cs.full else None)
        s = strips if gather else {}
        ptrs += [src.data_ptr(), ptr(u0) if gam0 != 0.0 else None,
                 ptr(u1) if gam1 != 0.0 else None, u.data_ptr(), ptr(w_out), ptr(dmax),
                 *(t.data_ptr() for t in cs.rows), *(ptr(s.get(k)) for k in STRIP_KEYS)]
        outs.append((u, w_out, dmax))
    if halo == "gather6" and any(("x3", 0) not in (s or {}) for s in strips_list):
        raise ValueError("a gather6 launch needs the six face strips of every node")
    fn = _lib(dtype, cs0.full)
    ints = [len(ints) + 1] + ints
    reals = [float(len(reals) + 1)] + reals
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_reals = (ctypes.c_double * len(reals))(*reals)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(device), kernel_span(
            name or KERNEL_NAMES[halo], "tiled" if tiled else "per-cell", device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(0 if dtype == torch.float32 else 1, HALO_CODES[halo], int(cs0.full),
                 int(tiled), c_ints, c_reals, c_ptrs, len(ptrs), len(stages),
                 cs0.dtden_blocks(tiled) if cs0.full else 0, stream)
    if err != 0:
        raise RuntimeError(f"stage_curv kernel launch failed: CUDA error {err}")
    tiled_launches += int(tiled)
    return outs


# ---------------------------------------------------------------------------
# the node-batched six-face stage (K6)
# ---------------------------------------------------------------------------

# node-batched launches since the last reset
stage_curv_batched_launches = 0


def pad_from_strips(w, grid, strips):
    """Interior prims [1, 6, nz, ny, nx] padded from the six face strips as
    the kernel reads them: an x1 strip over an x2 strip over an x3 strip
    over the interior (every halo cell belongs to one of them)."""
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


def stage_curv_batched_reference(stages, ws, u0s, u1s, strips_list, gam0, gam1, beta, dt,
                                 time, force_pcm):
    """The plain version: per node, its prims padded from its six strips
    (``pad_from_strips``: ``pad_and_fill`` on an all-ic root, the prolonged
    ghost fill on a patch), then ``stage_curv_reference``'s chain.  Returns
    one (u, w, dtden) per node."""
    return [stage_curv_reference(cs, w, u0, u1, gam0, gam1, beta, dt, time, force_pcm,
                                 w_pad=pad_from_strips(w, cs.grid, strips))
            for cs, w, u0, u1, strips in zip(stages, ws, u0s, u1s, strips_list)]


def stage_curv_batched(stages, ws, u0s, u1s, strips_list, gam0, gam1, beta, dt, time,
                       force_pcm):
    """One fused stage for N nodes of one grid shape with six-face strip
    halos (``strips_list[k]``: node k's STRIP_KEYS dict for this stage;
    ``stages[k]``: its CurvStage, whose rows carry the node's geometry).
    On the CPU the plain version; on a CUDA device one launch of
    ``csrc/stage_curv.cu`` with N nodes on its grid's y axis (TPU kernel
    K6), or raise.  Returns one (u, w, dtden) per node."""
    global stage_curv_batched_launches
    if ws[0].device.type == "cpu":
        with kernel_span(BATCHED_NAME, "plain", ws[0].device):
            return stage_curv_batched_reference(stages, ws, u0s, u1s, strips_list, gam0,
                                                gam1, beta, dt, time, force_pcm)
    if ws[0].device.type != "cuda":
        raise RuntimeError(f"no curvilinear stage kernel for device {ws[0].device}")
    if not all(cs.full for cs in stages):
        raise ValueError("the node-batched stage runs full stages only")
    out = _launch_nodes(stages, ws, u0s, u1s, gam0, gam1, beta, dt, time, force_pcm,
                        "gather6", strips_list, name=BATCHED_NAME)
    stage_curv_batched_launches += 1
    return out
