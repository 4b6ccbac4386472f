"""Sedov-type blast wave problem, all coordinate systems
(reference: src/pgen/blast.hpp; a copy of ``artemis_tpu/pgen/blast.py``,
numpy only).

Uniform ambient medium with an over-pressured region of radius ``rinit``;
optional sub-cell sampling of the region/cell overlap (``samples``) for a
sharp deposited energy that is independent of grid alignment.  The grid
being uniform, the sub-sampled overlap is evaluated on one globally refined
lattice in a few vectorized passes rather than per-cell loops.
"""

from __future__ import annotations

import math

import numpy as np

from . import Problem
from ..geometry import geometry as geo


def _overlap_cyl_cart2d(grid, rad, samples, x0):
    """Fraction of each (x,y) cell covered by the circle of radius rad
    (cf. compute_overlap_cyl, blast.hpp:64-82).  Returns [ny, nx] areas."""
    g = grid.geom
    s3, s2, s1 = grid.int_slices
    xf = g.xf1[s1.start:s1.stop + 1]
    yf = g.xf2[s2.start:s2.stop + 1]
    nx, ny = grid.nx[0], grid.nx[1]
    dxf = (xf[1] - xf[0]) / samples
    dyf = (yf[1] - yf[0]) / samples
    # fine lattice of subcell centers
    fx = xf[0] + (np.arange(nx * samples) + 0.5) * dxf - x0[0]
    area = np.zeros((ny, nx))
    r2 = rad * rad
    for j in range(ny):
        fy = yf[j] + (np.arange(samples) + 0.5) * dyf - x0[1]
        mask = (fx[None, :] ** 2 + fy[:, None] ** 2) <= r2  # [s, nx*s]
        cnt = mask.reshape(samples, nx, samples).sum(axis=(0, 2))
        area[j] = cnt * dxf * dyf
    return area


def _overlap_sph_axi(grid, rad, samples, x0):
    """R-weighted overlap of each (R,z) cell with the sphere of radius rad
    (cf. compute_overlap_sph axisymmetric branch, blast.hpp:107-121).
    Returns [ny, nx] (z, R) volumes (per unit phi)."""
    g = grid.geom
    s3, s2, s1 = grid.int_slices
    Rf = g.xf1[s1.start:s1.stop + 1]
    zf = g.xf2[s2.start:s2.stop + 1]
    nR, nz = grid.nx[0], grid.nx[1]
    dxf = (Rf[1] - Rf[0]) / samples
    dyf = (zf[1] - zf[0]) / samples
    fR = Rf[0] + (np.arange(nR * samples) + 0.5) * dxf
    r2 = rad * rad
    out = np.zeros((nz, nR))
    for j in range(nz):
        fz = zf[j] + (np.arange(samples) + 0.5) * dyf - x0[1]
        mask = ((fR[None, :] - x0[0]) ** 2 + fz[:, None] ** 2) <= r2
        w = mask * fR[None, :]
        out[j] = w.reshape(samples, nR, samples).sum(axis=(0, 2)) * dxf * dyf
    return out


def _overlap_sph_cart3d(grid, rad, samples, x0):
    """Volume of each (x,y,z) cell covered by the sphere of radius rad
    (compute_overlap_sph Cartesian branch, blast.hpp:91-107).  Cells whose
    corner-distance bounds put them fully inside/outside the sphere skip
    the subsampling; partial cells evaluate the same samples^3 midpoint
    lattice as the reference.  Returns [nz, ny, nx] volumes."""
    g = grid.geom
    s3, s2, s1 = grid.int_slices
    xf = g.xf1[s1.start:s1.stop + 1] - x0[0]
    yf = g.xf2[s2.start:s2.stop + 1] - x0[1]
    zf = g.xf3[s3.start:s3.stop + 1] - x0[2]
    nx, ny, nz = grid.nx

    def ax_bounds(f):
        lo, hi = f[:-1], f[1:]
        mn = np.where((lo <= 0.0) & (hi >= 0.0), 0.0,
                      np.minimum(np.abs(lo), np.abs(hi)))
        mx = np.maximum(np.abs(lo), np.abs(hi))
        return mn, mx

    xmn, xmx = ax_bounds(xf)
    ymn, ymx = ax_bounds(yf)
    zmn, zmx = ax_bounds(zf)
    d2min = xmn[None, None, :] ** 2 + ymn[None, :, None] ** 2 \
        + zmn[:, None, None] ** 2
    d2max = xmx[None, None, :] ** 2 + ymx[None, :, None] ** 2 \
        + zmx[:, None, None] ** 2
    r2 = rad * rad
    dxc = np.diff(xf)
    dyc = np.diff(yf)
    dzc = np.diff(zf)
    vol_cell = dzc[:, None, None] * dyc[None, :, None] * dxc[None, None, :]
    out = np.where(d2max <= r2, vol_cell, 0.0)
    out[d2min >= r2] = 0.0
    mid = (np.arange(samples) + 0.5) / samples
    for k, j, i in np.argwhere((d2min < r2) & (d2max > r2)):
        fx = xf[i] + mid * dxc[i]
        fy = yf[j] + mid * dyc[j]
        fz = zf[k] + mid * dzc[k]
        cnt = int(((fx[None, None, :] ** 2 + fy[None, :, None] ** 2
                    + fz[:, None, None] ** 2) <= r2).sum())
        out[k, j, i] = cnt * (dxc[i] * dyc[j] * dzc[k]) / samples ** 3
    return out


def build(pin, grid, gas_cfg, dust_cfg=None) -> Problem:
    p = dict(
        rinit=pin.get_or_add_real("problem", "radius", 1.0),
        dz=pin.get_or_add_real("problem", "height", 1.0),
        internal_energy=pin.get_or_add_real("problem", "internal_energy", 1.0),
        p0=pin.get_or_add_real("problem", "p0", 1.0),
        d0=pin.get_or_add_real("problem", "d0", 1.0),
        x0=(pin.get_or_add_real("problem", "x1", 0.0),
            pin.get_or_add_real("problem", "x2", 0.0),
            pin.get_or_add_real("problem", "x3", 0.0)),
        samples=pin.get_or_add_int("problem", "samples", -1),
        symmetry=pin.get_or_add_str("problem", "symmetry", "spherical"),
    )
    if p["symmetry"] not in ("spherical", "cylindrical"):
        raise ValueError("Bad blast wave symmetry parameter in <problem>!")
    gm1 = gas_cfg.gamma - 1.0

    x1v, x2v, x3v = grid.cell_centers()
    shape = tuple(reversed(grid.nx))
    # Cartesian displacement from the blast center
    cx, cy, cz = geo.convert_to_cart(grid.coords, x1v, x2v, x3v)
    c0 = geo.convert_to_cart(grid.coords, *[np.asarray(v) for v in p["x0"]])
    dist2 = np.broadcast_to(
        (cx - c0[0]) ** 2 + (cy - c0[1]) ** 2 + (cz - c0[2]) ** 2, shape)

    s3, s2, s1 = grid.int_slices
    total_vol = np.broadcast_to(grid.geom.volume(), grid.shape_entire)[(s3, s2, s1)]

    e0 = p["p0"] / gm1
    rinit = p["rinit"]
    if p["samples"] > 0:
        if p["symmetry"] == "cylindrical" and grid.coords == "cartesian":
            vol = _overlap_cyl_cart2d(grid, rinit, p["samples"], p["x0"])[None, :, :]
        elif p["symmetry"] == "spherical" and grid.coords == "axisymmetric":
            vol = _overlap_sph_axi(grid, rinit, p["samples"], p["x0"])[None, :, :]
        elif p["symmetry"] == "spherical" and grid.coords == "cartesian":
            vol = _overlap_sph_cart3d(grid, rinit, p["samples"], p["x0"])
        else:
            vol = np.where(dist2 < rinit * rinit, total_vol, 0.0)
        vol = np.broadcast_to(vol, shape)
    else:
        vol = np.where(dist2 < rinit * rinit, total_vol, 0.0)

    frac = vol / total_vol
    if p["symmetry"] == "spherical":
        esrc = p["internal_energy"] / (4.0 * math.pi / 3.0 * rinit**3)
    else:
        esrc = p["internal_energy"] / (math.pi * rinit**2)
    eint = e0 * (1.0 - frac) + esrc * frac

    den = np.full(shape, p["d0"])
    zero = np.zeros(shape)
    sie = eint / den
    prs = gm1 * den * sie
    prims = {"gas": np.stack([den, zero, zero, zero, prs, sie])[None, :]}
    if dust_cfg is not None:
        # dust follows the ambient density, at rest
        w = np.stack([den, zero, zero, zero])
        prims["dust"] = np.broadcast_to(w, (dust_cfg.nspecies,) + w.shape).copy()

    return Problem(prims=prims)
