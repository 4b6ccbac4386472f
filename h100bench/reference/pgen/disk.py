"""Protoplanetary disk problem (reference: src/pgen/disk.hpp; port of
``artemis_tpu/pgen/disk.py``).

Axisymmetric sub-Keplerian disk in pressure-rotational equilibrium around a
point mass: vertically isothermal or polytropic structure, cavity /
exponential cutoffs, optional viscous ``mdot`` steady state, dust at the
Keplerian flow.  Centrifugal balance is built from the *numerical* pressure
gradient on the actual grid (ComputeDiskProfile, disk.hpp:130-243) so the
initial state is discretely stationary.  The profiles and ``disk_ic`` are
numpy only, copied from the JAX package.

Custom boundaries: ``ic`` (the IC in the ghosts, from value caches made once),
``extrap`` (log-extrapolation on cylinders, disk.hpp:637-815), ``visc``
(viscous steady-state inflow, disk.hpp:418-592).  Each is a fill
``(w, grid, fluid, d, side) -> w`` on torch tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import Problem
from ..geometry import geometry as geo

FUZZ = 1e-300


@dataclass
class DiskParams:
    r0: float
    h0: float
    p: float
    q: float
    flare: float
    rho0: float
    dens_min: float
    pres_min: float
    gm: float
    Omega0: float
    l0: float
    omf: float
    dust_to_gas: float
    rexp: float
    rcav: float
    Gamma: float
    gamma_gas: float
    alpha: float
    nu0: float
    nu_indx: float
    mdot: float
    temp_soft2: float
    quiet_start: bool


def make_params(pin, gas_cfg, gm: float, omf: float) -> DiskParams:
    r0 = pin.get_or_add_real("problem", "r0", 1.0)
    Omega0 = math.sqrt(gm / r0**3)
    rho0 = pin.get_or_add_real("problem", "rho0", 1.0)
    gamma_gas = gas_cfg.gamma
    Gamma = pin.get_or_add_real("problem", "polytropic_index", gamma_gas)
    q = pin.get_or_add_real("problem", "tslope", -1e300)
    flare = pin.get_or_add_real("problem", "flare", -1e300)
    if flare == -1e300 and q == -1e300:
        raise ValueError("Set flare or tslope in <problem>")
    if flare == -1e300:
        flare = 0.5 * (1.0 + q)
    elif q == -1e300:
        q = 2.0 * flare - 1.0
    else:
        raise ValueError("Set either flare or tslope in <problem>, not both!")

    alpha, nu0, nu_indx, mdot = 0.0, 0.0, 0.0, 0.0
    if pin.get_or_add_bool("physics", "viscosity", False):
        vtype = pin.get_str("gas/viscosity", "type")
        if vtype == "alpha":
            alpha = pin.get_real("gas/viscosity", "alpha")
            nu0 = alpha * gamma_gas * (pin.get_or_add_real("problem", "h0", 0.05)
                                       * r0 * Omega0) ** 2
            nu_indx = 1.5 + q
        elif vtype == "powerlaw":
            nu0 = pin.get_real("gas/viscosity", "nu")
            nu_indx = pin.get_or_add_real("gas/viscosity", "r_exp", 0.0)
        else:
            raise ValueError("Disk pgen needs alpha or powerlaw viscosity")
        if pin.exists("problem", "mdot"):
            mdot = pin.get_real("problem", "mdot")
            rho0 = mdot / (3.0 * math.pi * nu0)
        else:
            mdot = 3.0 * math.pi * nu0 * rho0
    return DiskParams(
        r0=r0,
        h0=pin.get_or_add_real("problem", "h0", 0.05),
        p=pin.get_or_add_real("problem", "dslope", -2.25),
        q=q,
        flare=flare,
        rho0=rho0,
        dens_min=pin.get_or_add_real("problem", "dens_min", 1.0e-5),
        pres_min=pin.get_or_add_real("problem", "pres_min", 1.0e-8),
        gm=gm,
        Omega0=Omega0,
        l0=pin.get_or_add_real("problem", "l0", 0.0),
        omf=omf,
        dust_to_gas=pin.get_or_add_real("problem", "dust_to_gas", 0.01),
        rexp=pin.get_or_add_real("problem", "rexp", 0.0),
        rcav=pin.get_or_add_real("problem", "rcav", 0.0),
        Gamma=Gamma,
        gamma_gas=gamma_gas,
        alpha=alpha,
        nu0=nu0,
        nu_indx=nu_indx,
        mdot=mdot,
        temp_soft2=pin.get_or_add_real("problem", "temp_soft", 0.0),
        quiet_start=pin.get_or_add_bool("problem", "quiet_start", False),
    )


def den_profile(dp: DiskParams, R, z):
    """Density at cylindrical (R, z) (DenProfile, disk.hpp:72-90)."""
    r = np.sqrt(R * R + z * z)
    h = dp.h0 * (R / dp.r0) ** dp.flare
    exp_fac = 1.0 if dp.rexp == 0.0 else np.exp(-((R / dp.rexp) ** 2))
    dmid = (dp.rho0 * (R / dp.r0) ** dp.p
            * (1.0 - dp.l0 * np.sqrt(dp.r0 / R))
            * (dp.dens_min / dp.rho0
               + (1.0 - dp.dens_min / dp.rho0) * np.exp(-((dp.rcav / R) ** 12)))
            * exp_fac)
    sint = np.where(r == 0.0, 1.0, R / np.where(r == 0.0, 1.0, r))
    efac = (1.0 - sint) / (h * h)
    if dp.Gamma == 1.0:
        return np.maximum(dp.dens_min, dmid * np.exp(-efac))
    pfac = 1.0 - (dp.Gamma - 1.0) * efac
    return np.maximum(dp.dens_min,
                      dmid * np.maximum(pfac, 0.0) ** (1.0 / (dp.Gamma - 1.0)))


def temp_profile(dp: DiskParams, R, z):
    """Temperature at cylindrical (R, z) (TempProfile, disk.hpp:96-106)."""
    rho = den_profile(dp, R, z)
    rho0 = den_profile(dp, R, 0.0 * z)
    H = R * dp.h0 * (R / dp.r0) ** dp.flare
    ir1 = 1.0 / np.sqrt(R * R + dp.temp_soft2)
    omk2 = dp.Omega0**2 * ir1**3
    T0 = omk2 * H * H / dp.Gamma
    return T0 * (rho / rho0) ** (dp.Gamma - 1.0)


def pres_profile(dp: DiskParams, cv, R, z, T=None):
    """max(pres_min, P(rho, T)) (PresProfile, disk.hpp:112-116)."""
    df = den_profile(dp, R, z)
    tf = temp_profile(dp, R, z) if T is None else T
    P = (dp.gamma_gas - 1.0) * df * cv * tf
    return np.maximum(dp.pres_min, P)


def viscosity_profile(dp: DiskParams, R):
    return dp.nu0 * (R / dp.r0) ** dp.nu_indx



def disk_ic(dp: DiskParams, grid, cv, sl=None, do_dust=False, rt_fn=None):
    """Evaluate the equilibrium IC on (a slice of) the padded grid.

    Returns (w_gas [6,...], w_dust [4,...] or None) numpy arrays over the
    region selected by ``sl`` (a [z,y,x] slice tuple into the entire grid;
    None = interior).
    """
    g = grid.geom
    if sl is None:
        sl = grid.int_slices
    s3, s2, s1 = sl
    x1v = g.xv1[s1][None, None, :]
    x2v = g.xv2[s2][None, :, None]
    x3v = g.xv3[s3][:, None, None]
    shape = (len(g.xv3[s3]), len(g.xv2[s2]), len(g.xv1[s1]))
    c = grid.coords

    Rc, phic, zc = geo.convert_to_cyl(c, x1v, x2v, x3v)
    ex = geo.vec_to_cyl(c, x1v, x2v, x3v)   # rows: problem basis in (R,phi,z)

    gdens = den_profile(dp, Rc, zc)
    rtc = rt_fn(x1v, x2v, x3v) if rt_fn is not None else Rc
    gtemp = temp_profile(dp, rtc, zc)

    # numerical grad(P) from the 6 cell-face points (disk.hpp:151-210)
    xf1 = (g.xf1[s1.start:s1.stop][None, None, :],
           g.xf1[s1.start + 1:s1.stop + 1][None, None, :])
    xf2 = (g.xf2[s2.start:s2.stop][None, :, None],
           g.xf2[s2.start + 1:s2.stop + 1][None, :, None])
    xf3 = (g.xf3[s3.start:s3.stop][:, None, None],
           g.xf3[s3.start + 1:s3.stop + 1][:, None, None])
    h = lambda d: g.hx(d, x1v, x2v)
    widths = [h(1) * (xf1[1] - xf1[0]), h(2) * (xf2[1] - xf2[0]),
              h(3) * (xf3[1] - xf3[0])]

    pgrad = []
    faces = [
        ((xf1[0], x2v, x3v), (xf1[1], x2v, x3v)),
        ((x1v, xf2[0], x3v), (x1v, xf2[1], x3v)),
        ((x1v, x2v, xf3[0]), (x1v, x2v, xf3[1])),
    ]
    for d in range(3):
        (fm, fp) = faces[d]
        Rm, _, zm = geo.convert_to_cyl(c, *fm)
        Rp, _, zp = geo.convert_to_cyl(c, *fp)
        Tm = temp_profile(dp, rt_fn(*fm), zm) if rt_fn is not None else None
        Tp = temp_profile(dp, rt_fn(*fp), zp) if rt_fn is not None else None
        pfm = pres_profile(dp, cv, Rm, zm, T=Tm)
        pfp = pres_profile(dp, cv, Rp, zp, T=Tp)
        # if either face pressure floors out, zero the gradient
        # (disk.hpp:173-175 clamps both to pres_min)
        floored = np.logical_or(pfm <= dp.pres_min, pfp <= dp.pres_min)
        grad = np.where(floored, 0.0, (pfp - pfm) / widths[d])
        pgrad.append(grad)

    eR = [ex[0][0], ex[1][0], ex[2][0]]
    dpdr = sum(pgrad[d] * eR[d] for d in range(3))

    r = rtc if rt_fn is not None else np.sqrt(Rc * Rc + zc * zc)
    omk2 = dp.gm / np.maximum(r, FUZZ) ** 3
    vk2 = omk2 * Rc * Rc
    vp = np.sqrt(np.maximum(vk2 + dpdr * Rc / gdens, 0.0))
    nu = viscosity_profile(dp, rtc)
    vr = 0.0 if dp.quiet_start else -1.5 * nu / Rc
    vcyl = [vr * np.ones_like(vp), vp - dp.omf * Rc, np.zeros_like(vp)]
    gv = [sum(vcyl[m] * ex[i][m] for m in range(3)) for i in range(3)]

    b = lambda a: np.ascontiguousarray(np.broadcast_to(a, shape))
    sie = cv * gtemp
    pres = (dp.gamma_gas - 1.0) * gdens * sie
    w_gas = np.stack([b(gdens), b(gv[0]), b(gv[1]), b(gv[2]), b(pres), b(sie)])[None]

    w_dust = None
    if do_dust:
        ddens = dp.dust_to_gas * gdens
        vkep = [np.zeros_like(vp), np.sqrt(vk2) - dp.omf * Rc, np.zeros_like(vp)]
        dv = [sum(vkep[m] * ex[i][m] for m in range(3)) for i in range(3)]
        w_dust = np.stack([b(ddens), b(dv[0]), b(dv[1]), b(dv[2])])[None]
    return w_gas, w_dust


# ---------------------------------------------------------------------------
# boundary conditions
# ---------------------------------------------------------------------------
def _ghost_slices(grid, d, side):
    """[z,y,x] slice tuple of the ghost slab for boundary (d, side)."""
    ng = grid.nghost
    n = grid.nx[d - 1]
    se = grid.shape_entire
    sl = [slice(0, se[0]), slice(0, se[1]), slice(0, se[2])]
    sl[3 - d] = slice(0, ng) if side == 0 else slice(ng + n, n + 2 * ng)
    return tuple(sl)


class _TensorCache:
    """numpy arrays -> tensors, made once per (key, dtype, device)."""

    def __init__(self):
        self._t = {}

    def get(self, key, make, like):
        k = (key, like.dtype, like.device)
        if k not in self._t:
            self._t[k] = torch.as_tensor(np.array(make()),
                                         dtype=like.dtype, device=like.device)
        return self._t[k]


def make_ic_bc(dp: DiskParams, grid, cv, nd_dust: int, rt_fn=None):
    """``ic`` BC: the IC evaluated in the ghost zones (DiskBoundaryIC).
    The numpy value caches stay exposed as ``ic_bc.shard_caches`` (gas,
    dust): the curvilinear stage kernel reads its halo strips from them."""
    gas_cache = {}
    dust_cache = {}
    # full-extent slices (all of the non-boundary dims incl. their ghosts)
    full = (slice(0, grid.shape_entire[0]), slice(0, grid.shape_entire[1]),
            slice(0, grid.shape_entire[2]))

    for d in (1, 2, 3):
        if not grid.active(d):
            continue
        for side in (0, 1):
            sl = list(full)
            sl[3 - d] = _ghost_slices(grid, d, side)[3 - d]
            wg, wd = disk_ic(dp, grid, cv, tuple(sl), do_dust=nd_dust > 0,
                             rt_fn=rt_fn)
            gas_cache[(d, side)] = wg
            if wd is not None:
                dust_cache[(d, side)] = np.broadcast_to(
                    wd, (nd_dust,) + wd.shape[1:]).copy()
    tensors = _TensorCache()

    def ic_bc(w, grid_, fluid, d, side):
        sl = _ghost_slices(grid_, d, side)
        cache = gas_cache if fluid == "gas" else dust_cache
        out = w.clone()
        out[(slice(None), slice(None)) + sl] = tensors.get(
            (fluid, d, side), lambda: cache[(d, side)], w)
        return out

    ic_bc.shard_caches = (gas_cache, dust_cache)
    return ic_bc


def _bc_geom(dp, grid, d, side):
    """Precomputed coordinate data for extrap/visc boundaries (numpy)."""
    g = grid.geom
    ng = grid.nghost
    n = grid.nx[d - 1]
    lnx = grid.coords != "cartesian"
    xv = {1: g.xv1, 2: g.xv2, 3: g.xv3}[d]
    ia = ng if side == 0 else ng + n - 1
    ip1 = ia + 1 if side == 0 else ia
    im1 = ia if side == 0 else ia - 1

    ghosts = list(range(0, ng)) if side == 0 else list(range(ng + n, n + 2 * ng))
    if lnx:
        xma = [math.log(xv[gi] / xv[ia]) for gi in ghosts]
        dx = math.log(xv[ip1] / xv[im1])
    else:
        xma = [xv[gi] - xv[ia] for gi in ghosts]
        dx = xv[ip1] - xv[im1]
    xmadx = [x / dx for x in xma]

    # cylindrical coords + basis rows over the full padded grid
    x1v = g.xv1[None, None, :]
    x2v = g.xv2[None, :, None]
    x3v = g.xv3[:, None, None]
    xcyl = geo.convert_to_cyl(grid.coords, x1v, x2v, x3v)
    ex = geo.vec_to_cyl(grid.coords, x1v, x2v, x3v)
    shape = grid.shape_entire
    Rcyl = np.broadcast_to(xcyl[0], shape)
    rows = [[np.broadcast_to(ex[i][m], shape) for m in range(3)] for i in range(3)]
    return dict(ia=ia, ip1=ip1, im1=im1, ghosts=ghosts, xmadx=xmadx,
                Rcyl=Rcyl, rows=rows)


def _plane(arr, d, i):
    """The [z, y, x] numpy array's plane at index i along axis d."""
    sl = [slice(None)] * 3
    sl[3 - d] = i
    return np.ascontiguousarray(arr[tuple(sl)])


def _take(w, d, i):
    sl = [slice(None)] * w.ndim
    sl[w.ndim - d] = i
    return tuple(sl)


def _make_log_bc(dp: DiskParams, visc: bool):
    """Shared body of the ``extrap`` and ``visc`` fills: density, the
    azimuthal velocity and sie log-extrapolated from the last interior
    cells (``visc``: density and radial velocity from the viscous
    steady state instead, disk.hpp:418-592)."""
    geoms = {}
    tensors = _TensorCache()

    def fill(w, grid_, fluid, d, side):
        if visc and d != 1:
            raise ValueError("visc BC only supports x1 boundaries")
        key = (d, side)
        if key not in geoms:
            geoms[key] = _bc_geom(dp, grid_, d, side)
        geom = geoms[key]
        is_gas = fluid == "gas"
        ia, ip1, im1 = geom["ia"], geom["ip1"], geom["im1"]

        def cell(name, arr, i):
            # the plane as a tensor of w's dtype on w's device, and the
            # numpy plane (host formulas such as the viscosity profile)
            return tensors.get((key, name, i), lambda: _plane(arr, d, i), w)

        def row(i, m, gi):
            return cell(("row", i, m), geom["rows"][i][m], gi)

        Ra = cell("R", geom["Rcyl"], ia)
        Rp1 = cell("R", geom["Rcyl"], ip1)
        Rm1 = cell("R", geom["Rcyl"], im1)
        wa, wp, wm = w[_take(w, d, ia)], w[_take(w, d, ip1)], w[_take(w, d, im1)]
        v_a = [wa[:, 1 + c] for c in range(3)]
        v_p = [wp[:, 1 + c] for c in range(3)]
        v_m = [wm[:, 1 + c] for c in range(3)]
        rho_a = wa[:, 0]
        vp_a = sum(v_a[c] * row(c, 1, ia) for c in range(3)) + dp.omf * Ra
        vR_a = sum(v_a[c] * row(c, 0, ia) for c in range(3))
        vz_a = sum(v_a[c] * row(c, 2, ia) for c in range(3))
        vp_p1 = sum(v_p[c] * row(c, 1, ip1) for c in range(3)) + dp.omf * Rp1
        vp_m1 = sum(v_m[c] * row(c, 1, im1) for c in range(3)) + dp.omf * Rm1
        dgvp = torch.log(vp_p1 / vp_m1)
        if visc:
            nua = tensors.get((key, "nu", ia), lambda: viscosity_profile(
                dp, _plane(geom["Rcyl"], d, ia)), w)
        else:
            dgrho = torch.log(wp[:, 0] / wm[:, 0])
        if is_gas:
            sie_a = wa[:, 5]
            dgsie = torch.log(wp[:, 5] / wm[:, 5])

        out = w.clone()
        for gi, xmadx in zip(geom["ghosts"], geom["xmadx"]):
            Rg = cell("R", geom["Rcyl"], gi)
            if visc:
                nug = tensors.get((key, "nu", gi), lambda: viscosity_profile(
                    dp, _plane(geom["Rcyl"], d, gi)), w)
                vp_g = vp_a * torch.exp(dgvp * xmadx)
                if side == 0:
                    rho_g = rho_a * (nua / nug)
                    vR_g = -1.5 * nug / Rg
                else:
                    lg = Rg * vp_g
                    la = Ra * vp_a
                    rho_g = (3.0 * math.pi * rho_a * nua * la
                             + dp.mdot * (lg - la)) / (3.0 * math.pi * nug * lg)
                    vR_g = -dp.mdot / (2.0 * math.pi * Rg * rho_g)
                vcyl = [vR_g, vp_g - dp.omf * Rg, vz_a]
            else:
                rho_g = rho_a * torch.exp(dgrho * xmadx)
                vp_g = vp_a * torch.exp(dgvp * xmadx) - dp.omf * Rg
                vcyl = [vR_a, vp_g, vz_a]
            vg = [sum(vcyl[m] * row(i, m, gi) for m in range(3)) for i in range(3)]
            new = w[_take(w, d, gi)].clone()
            new[:, 0] = rho_g
            new[:, 1] = vg[0]
            new[:, 2] = vg[1]
            new[:, 3] = vg[2]
            if is_gas:
                sie_g = sie_a * torch.exp(dgsie * xmadx)
                new[:, 5] = sie_g
                new[:, 4] = (dp.gamma_gas - 1.0) * rho_g * sie_g
            out[_take(w, d, gi)] = new
        return out

    return fill


def make_extrap_bc(dp: DiskParams, grid, cv):
    """``extrap`` BC: log extrapolation on cylinders (DiskBoundaryExtrap)."""
    return _make_log_bc(dp, visc=False)


def make_visc_bc(dp: DiskParams, grid, cv):
    """``visc`` BC: viscous steady-state inflow (DiskBoundaryVisc).  x1
    boundaries only."""
    return _make_log_bc(dp, visc=True)


def build(pin, grid, gas_cfg, dust_cfg=None) -> Problem:
    if not pin.get_or_add_bool("physics", "gravity", False):
        raise ValueError("disk pgen requires gravity")
    from ..units import Constants, Units

    units = Units.from_input(pin)
    constants = Constants.from_units(units)
    if pin.has_block("gravity/point"):
        gm = constants.G_code * pin.get_or_add_real("gravity/point", "mass", 1.0) \
            if not pin.exists("gravity/point", "gm") \
            else pin.get_real("gravity/point", "gm")
    elif pin.has_block("gravity/binary"):
        gm = constants.G_code * pin.get_or_add_real("gravity/binary", "total_mass", 1.0)
    else:
        raise ValueError("the reference's disk takes point or binary gravity")
    omf = 0.0
    if pin.get_or_add_bool("physics", "rotating_frame", False):
        omf = pin.get_or_add_real("rotating_frame", "omega", 0.0)

    dp = make_params(pin, gas_cfg, gm, omf)
    cv = gas_cfg.cv
    nd = dust_cfg.nspecies if dust_cfg is not None else 0

    rt_fn = None
    w_gas, w_dust = disk_ic(dp, grid, cv, do_dust=nd > 0, rt_fn=rt_fn)
    prims = {"gas": w_gas}
    if nd:
        prims["dust"] = np.broadcast_to(w_dust, (nd,) + w_dust.shape[1:]).copy()

    visc_bc = make_visc_bc(dp, grid, cv)
    bc_custom = {
        "ic": make_ic_bc(dp, grid, cv, nd, rt_fn=rt_fn),
        "extrap": make_extrap_bc(dp, grid, cv),
        "visc": visc_bc,
        "viscous": visc_bc,
    }
    return Problem(prims=prims, bc_custom=bc_custom)
