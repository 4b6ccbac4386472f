"""Riemann solvers (HLLC / HLLE / LLF) for gas and pressureless dust
(port of ``artemis_tpu/ops/riemann.py``).

Vectorized equivalents of the reference solvers
(``src/utils/fluxes/riemann/{hllc,hlle,llf}.hpp``, themselves adapted from
Athena++/AthenaK), operating on full face arrays.

State layout (faces along direction ``d``):
  gas  : W[ns, 6, x3, x2, x1] = (rho, v1, v2, v3, p, sie)
  dust : W[ns, 4, x3, x2, x1] = (rho, v1, v2, v3)

Returns per-species conserved fluxes in *global* component order
  gas  : (rho, m1, m2, m3, E, eint)  [no pressure in the momentum flux —
          the pressure force enters via the flux-source scheme, cf.
          hllc.hpp:146-147 and FluxSourceImpl]
  dust : (rho, m1, m2, m3)
plus, for gas, the interface pressure (for the pressure-gradient source)
and the upwinded normal face velocity (for PdV work on internal energy).
"""

from __future__ import annotations

import torch

TINY = 1.0e-20


def _vel_indices(d: int):
    """Normal and transverse velocity component indices (1-based comps)."""
    ivx = 1 + (d - 1)
    ivy = 1 + (d % 3)
    ivz = 1 + ((d + 1) % 3)
    return ivx, ivy, ivz


def _scatter_momentum(fmx, fmy, fmz, d: int):
    """Reorder (normal, transverse1, transverse2) momentum fluxes into
    global (m1, m2, m3) order."""
    ivx, ivy, ivz = _vel_indices(d)
    out = [None, None, None]
    out[ivx - 1] = fmx
    out[ivy - 1] = fmy
    out[ivz - 1] = fmz
    return out


def llf(wl, wr, d: int, fluid: str, gamma: float):
    """Local Lax-Friedrichs (Rusanov) flux (cf. llf.hpp:86-168)."""
    ivx, ivy, ivz = _vel_indices(d)
    dl, dr = wl[:, 0], wr[:, 0]
    vxl, vxr = wl[:, ivx], wr[:, ivx]
    vyl, vyr = wl[:, ivy], wr[:, ivy]
    vzl, vzr = wl[:, ivz], wr[:, ivz]

    qa = dl * vxl
    qb = dr * vxr
    fsum_d = qa + qb
    fsum_mx = qa * vxl + qb * vxr
    fsum_my = qa * vyl + qb * vyr
    fsum_mz = qa * vzl + qb * vzr

    if fluid == "gas":
        pl, pr = wl[:, 4], wr[:, 4]
        sl_, sr_ = wl[:, 5], wr[:, 5]
        igm1 = 1.0 / (gamma - 1.0)
        el = pl * igm1 + 0.5 * dl * (vxl**2 + vyl**2 + vzl**2)
        er = pr * igm1 + 0.5 * dr * (vxr**2 + vyr**2 + vzr**2)
        fsum_e = (el + pl) * vxl + (er + pr) * vxr
        a = torch.maximum(
            vxl.abs() + torch.sqrt(gamma * pl / dl),
            vxr.abs() + torch.sqrt(gamma * pr / dr),
        )
    else:
        a = torch.maximum(vxl.abs(), vxr.abs())

    du_d = a * (dr - dl)
    du_mx = a * (dr * vxr - dl * vxl)
    du_my = a * (dr * vyr - dl * vyl)
    du_mz = a * (dr * vzr - dl * vzl)

    frho = 0.5 * (fsum_d - du_d)
    fmx = 0.5 * (fsum_mx - du_mx)
    fmy = 0.5 * (fsum_my - du_my)
    fmz = 0.5 * (fsum_mz - du_mz)
    m1, m2, m3 = _scatter_momentum(fmx, fmy, fmz, d)

    if fluid == "gas":
        du_e = a * (er - el)
        fen = 0.5 * (fsum_e - du_e)
        upwind_l = frho >= 0.0
        feint = frho * torch.where(upwind_l, sl_, sr_)
        vface = frho / torch.where(upwind_l, dl, dr)
        pface = 0.5 * (pl + pr)
        F = torch.stack([frho, m1, m2, m3, fen, feint], dim=1)
        return F, pface, vface
    F = torch.stack([frho, m1, m2, m3], dim=1)
    return F, None, None


def hlle(wl, wr, d: int, fluid: str, gamma: float):
    """HLLE flux with Roe-averaged wavespeeds (cf. hlle.hpp:95-220)."""
    ivx, ivy, ivz = _vel_indices(d)
    dl, dr = wl[:, 0], wr[:, 0]
    vxl, vxr = wl[:, ivx], wr[:, ivx]
    vyl, vyr = wl[:, ivy], wr[:, ivy]
    vzl, vzr = wl[:, ivz], wr[:, ivz]

    sqrtdl = torch.sqrt(dl)
    sqrtdr = torch.sqrt(dr)
    isdlpdr = 1.0 / (sqrtdl + sqrtdr)
    wroe_vx = (sqrtdl * vxl + sqrtdr * vxr) * isdlpdr
    wroe_vy = (sqrtdl * vyl + sqrtdr * vyr) * isdlpdr
    wroe_vz = (sqrtdl * vzl + sqrtdr * vzr) * isdlpdr

    if fluid == "gas":
        pl, pr = wl[:, 4], wr[:, 4]
        sl_, sr_ = wl[:, 5], wr[:, 5]
        gm1 = gamma - 1.0
        igm1 = 1.0 / gm1
        el = pl * igm1 + 0.5 * dl * (vxl**2 + vyl**2 + vzl**2)
        er = pr * igm1 + 0.5 * dr * (vxr**2 + vyr**2 + vzr**2)
        hroe = ((el + pl) / sqrtdl + (er + pr) / sqrtdr) * isdlpdr
        qa = torch.sqrt(gamma * pl / dl)
        qb = torch.sqrt(gamma * pr / dr)
        a2 = hroe - 0.5 * (wroe_vx**2 + wroe_vy**2 + wroe_vz**2)
        a = torch.sqrt(gm1 * torch.clamp(a2, min=0.0))
        sl = torch.minimum(wroe_vx - a, vxl - qa)
        sr = torch.maximum(wroe_vx + a, vxr + qb)
    else:
        sl = torch.minimum(wroe_vx, vxl)
        sr = torch.maximum(wroe_vx, vxr)

    bp = torch.where(sr > 0.0, sr, TINY)
    bm = torch.where(sl < 0.0, sl, -TINY)

    qa = vxl - bm
    qb = vxr - bp
    fl_d = dl * qa
    fr_d = dr * qb
    fl_mx = dl * vxl * qa
    fr_mx = dr * vxr * qb
    fl_my = dl * vyl * qa
    fr_my = dr * vyr * qb
    fl_mz = dl * vzl * qa
    fr_mz = dr * vzr * qb

    w = torch.where(bp != bm, 0.5 * (bp + bm) / (bp - bm), 0.0)

    frho = 0.5 * (fl_d + fr_d) + w * (fl_d - fr_d)
    fmx = 0.5 * (fl_mx + fr_mx) + w * (fl_mx - fr_mx)
    fmy = 0.5 * (fl_my + fr_my) + w * (fl_my - fr_my)
    fmz = 0.5 * (fl_mz + fr_mz) + w * (fl_mz - fr_mz)
    m1, m2, m3 = _scatter_momentum(fmx, fmy, fmz, d)

    if fluid == "gas":
        fl_e = el * qa + pl * vxl
        fr_e = er * qb + pr * vxr
        fen = 0.5 * (fl_e + fr_e) + w * (fl_e - fr_e)
        upwind_l = frho >= 0.0
        feint = frho * torch.where(upwind_l, sl_, sr_)
        vface = frho / torch.where(upwind_l, dl, dr)
        pface = 0.5 * (pl + pr) + w * (pl - pr)
        F = torch.stack([frho, m1, m2, m3, fen, feint], dim=1)
        return F, pface, vface
    F = torch.stack([frho, m1, m2, m3], dim=1)
    return F, None, None


def hllc(wl, wr, d: int, fluid: str, gamma: float):
    """HLLC flux (gas only; PVRS middle state + Toro/Batten wavespeeds,
    cf. hllc.hpp:79-180)."""
    if fluid != "gas":
        raise ValueError("HLLC requires the gas energy equation (use hlle/llf for dust)")
    ivx, ivy, ivz = _vel_indices(d)
    dl, dr = wl[:, 0], wr[:, 0]
    vxl, vxr = wl[:, ivx], wr[:, ivx]
    vyl, vyr = wl[:, ivy], wr[:, ivy]
    vzl, vzr = wl[:, ivz], wr[:, ivz]
    pl, pr = wl[:, 4], wr[:, 4]
    sel, ser = wl[:, 5], wr[:, 5]

    gm1 = gamma - 1.0
    igm1 = 1.0 / gm1
    alpha = (gamma + 1.0) / (2.0 * gamma)

    al = torch.sqrt(gamma * pl / dl)
    ar = torch.sqrt(gamma * pr / dr)
    el = pl * igm1 + 0.5 * dl * (vxl**2 + vyl**2 + vzl**2)
    er = pr * igm1 + 0.5 * dr * (vxr**2 + vyr**2 + vzr**2)

    # PVRS middle-state pressure (Toro 10.5.2)
    cbar = 0.25 * (dl + dr) * (al + ar)
    pmid = 0.5 * (pl + pr + (vxl - vxr) * cbar)

    ql = torch.where(pmid <= pl, 1.0, torch.sqrt(1.0 + alpha * (pmid / pl - 1.0)))
    qr = torch.where(pmid <= pr, 1.0, torch.sqrt(1.0 + alpha * (pmid / pr - 1.0)))

    sl = vxl - al * ql
    sr = vxr + ar * qr

    bp = torch.where(sr > 0.0, sr, TINY)
    bm = torch.where(sl < 0.0, sl, -TINY)

    # contact wave speed and pressure
    vxl_m_sl = vxl - sl
    vxr_m_sr = vxr - sr
    tl = pl + vxl_m_sl * dl * vxl
    tr = pr + vxr_m_sr * dr * vxr
    ml = dl * vxl_m_sl
    mr = -(dr * vxr_m_sr)
    am = (tl - tr) / (ml + mr)
    cp = torch.clamp((ml * tr + mr * tl) / (ml + mr), min=0.0)

    # L/R fluxes along bm / bp
    qe = dl * (vxl - bm)
    qf = dr * (vxr - bp)
    fld, frd = qe, qf
    flmx, frmx = qe * vxl, qf * vxr
    flmy, frmy = qe * vyl, qf * vyr
    flmz, frmz = qe * vzl, qf * vzr
    fle = el * (vxl - bm) + pl * vxl
    fre = er * (vxr - bp) + pr * vxr

    pos = am >= 0.0
    wc_l = torch.where(pos, am / (am - bm), 0.0)
    wc_r = torch.where(pos, 0.0, -am / (bp - am))
    wc_c = torch.where(pos, -bm / (am - bm), bp / (bp - am))

    pface = wc_l * pl + wc_r * pr + wc_c * cp

    frho = wc_l * fld + wc_r * frd
    fmx = wc_l * flmx + wc_r * frmx
    fmy = wc_l * flmy + wc_r * frmy
    fmz = wc_l * flmz + wc_r * frmz
    fen = wc_l * fle + wc_r * fre + wc_c * cp * am
    m1, m2, m3 = _scatter_momentum(fmx, fmy, fmz, d)

    upwind_l = frho >= 0.0
    feint = frho * torch.where(upwind_l, sel, ser)
    vface = frho / torch.where(upwind_l, dl, dr)

    F = torch.stack([frho, m1, m2, m3, fen, feint], dim=1)
    return F, pface, vface


_SOLVERS = {"hllc": hllc, "hlle": hlle, "llf": llf}


def solve(wl, wr, d: int, fluid: str, rsolver: str, gamma: float):
    return _SOLVERS[rsolver](wl, wr, d, fluid, gamma)
