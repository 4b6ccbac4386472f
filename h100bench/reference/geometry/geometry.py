"""Coordinate geometry, precomputed as per-axis 1-D arrays.

TPU-native redesign of the reference geometry layer (``src/geometry/*.hpp``).
The reference constructs a per-cell CRTP ``Coords<GEOM>`` object inside every
kernel; every geometric quantity there depends only on the 1-D face positions
of each axis and *factorizes* into per-axis terms (e.g. spherical volume
= d(r^3/3)(i) * d(-cos th)(j) * dphi(k)).  Here we precompute those per-axis
factors once on the host and let XLA fuse the broadcasts into consumers —
no 3-D geometric arrays are ever materialized.

Supported systems and conventions (identical to the reference):
  cartesian      (x, y, z)
  spherical1D/2D/3D  (r, theta, phi)   h2 = r, h3 = r sin(theta)
                   [spherical1D keeps the base-class hx3 = 1 and hx2v = 1,
                    matching src/geometry/spherical.hpp:441-527]
  cylindrical    (R, phi, z)           h2 = R
  axisymmetric   (R, z, phi)           h3 = R

Volume-averaged centroids, exact face areas/volumes, and connection terms
follow src/geometry/{spherical,cylindrical,axisymmetric}.hpp.

Copied verbatim from ``artemis_tpu/geometry/geometry.py`` (it needs only the
standard library and numpy), so that ``artemis_tpu_torch`` runs where JAX is
not installed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

# axis index convention: arrays are laid out [..., x3, x2, x1];
# d in {1,2,3} refers to the coordinate direction (x1 fastest).

_SYSTEMS = (
    "cartesian",
    "spherical1D",
    "spherical2D",
    "spherical3D",
    "cylindrical",
    "axisymmetric",
)


def coord_select(sys: str, ndim: int) -> str:
    """String -> coordinate system, resolving spherical by dimension
    (cf. geometry::CoordSelect, src/geometry/geometry.hpp:38-56)."""
    if sys == "cartesian":
        return "cartesian"
    if sys == "spherical":
        return {1: "spherical1D", 2: "spherical2D"}.get(ndim, "spherical3D")
    if sys in ("cylindrical", "axisymmetric"):
        return sys
    if sys in _SYSTEMS:
        return sys
    raise ValueError(f"unknown coordinate system {sys!r}")


def is_spherical(c: str) -> bool:
    return c.startswith("spherical")


def is_axisymmetric(c: str) -> bool:
    return c in ("axisymmetric", "spherical1D", "spherical2D")


def is_cylindrical(c: str) -> bool:
    return c == "cylindrical"


def is_cartesian(c: str) -> bool:
    return c == "cartesian"


def x1dep(c: str) -> bool:
    return c != "cartesian"


def x2dep(c: str) -> bool:
    return c in ("spherical2D", "spherical3D")


def x3dep(c: str) -> bool:
    return False


def _bcast(f1, f2, f3):
    """Broadcast per-axis 1-D factors (along x1, x2, x3) to [x3, x2, x1]."""
    return f3[:, None, None] * f2[None, :, None] * f1[None, None, :]


def convert_to_cyl(coords: str, x1, x2, x3):
    """(x1,x2,x3) -> cylindrical (R, phi, z) (cf. ConvertCoordsToCyl)."""
    x1, x2, x3 = np.asarray(x1), np.asarray(x2), np.asarray(x3)
    if coords == "cartesian":
        R = np.sqrt(x1 * x1 + x2 * x2)
        return R, np.arctan2(x2, x1), x3 * np.ones_like(R)
    if coords in ("spherical2D", "spherical3D"):
        st, ct = np.sin(x2), np.cos(x2)
        phi = x3 if coords == "spherical3D" else 0.0 * x3
        return x1 * st, phi * np.ones_like(x1 * st), x1 * ct
    if coords == "spherical1D":
        return x1, 0.0 * x1, 0.0 * x1
    if coords == "cylindrical":
        return x1, x2, x3
    if coords == "axisymmetric":  # (R, z, phi) -> (R, phi, z)
        o = np.ones_like(x1 * x2 * x3)
        return x1 * o, x3 * o, x2 * o
    raise ValueError(coords)


def convert_to_sph(coords: str, x1, x2, x3):
    """(x1,x2,x3) -> spherical (r, theta, phi) (cf. ConvertCoordsToSph)."""
    x1, x2, x3 = np.asarray(x1), np.asarray(x2), np.asarray(x3)
    fuzz = 1e-300
    if coords == "cartesian":
        R = np.sqrt(x1 * x1 + x2 * x2)
        r = np.sqrt(R * R + x3 * x3)
        return r, np.arccos(x3 / (r + fuzz)), np.arctan2(x2, x1)
    if coords in ("spherical1D", "spherical2D", "spherical3D"):
        o = np.ones_like(x1 * x2 * x3)
        return x1 * o, x2 * o, x3 * o
    if coords == "cylindrical":  # (R, phi, z)
        r = np.sqrt(x1 * x1 + x3 * x3)
        th = np.arccos(x3 / (r + fuzz))
        return r, th, x2 * np.ones_like(r)
    if coords == "axisymmetric":  # (R, z, phi)
        r = np.sqrt(x1 * x1 + x2 * x2)
        th = np.arccos(x2 / (r + fuzz))
        return r, th, x3 * np.ones_like(r)
    raise ValueError(coords)


def vec_to_cyl(coords: str, x1, x2, x3):
    """Rows ex1, ex2, ex3: the problem-basis unit vectors expressed in the
    cylindrical (Rhat, phihat, zhat) basis (cf. ConvertVecToCyl)."""
    x1, x2, x3 = np.asarray(x1), np.asarray(x2), np.asarray(x3)
    o = np.ones_like(x1 * x2 * x3)
    z = np.zeros_like(o)
    if coords == "cartesian":
        R = np.sqrt(x1 * x1 + x2 * x2)
        fz = 1e-300
        cp, sp = x1 / (R + fz), x2 / (R + fz)
        return ((cp * o, -sp * o, z), (sp * o, cp * o, z), (z, z, o))
    if coords in ("spherical2D", "spherical3D", "spherical1D"):
        if coords == "spherical1D":
            st, ct = o, z
        else:
            st, ct = np.sin(x2) * o, np.cos(x2) * o
        return ((st, z, ct), (ct, z, -st), (z, o, z))
    if coords == "cylindrical":
        return ((o, z, z), (z, o, z), (z, z, o))
    if coords == "axisymmetric":  # (Rhat, zhat, phihat) -> (Rhat, phihat, zhat)
        return ((o, z, z), (z, z, o), (z, o, z))
    raise ValueError(coords)


def vec_to_cart(coords: str, x1, x2, x3):
    """Rows ex1, ex2, ex3 in the Cartesian basis (cf. ConvertVecToCart)."""
    x1, x2, x3 = np.asarray(x1), np.asarray(x2), np.asarray(x3)
    o = np.ones_like(x1 * x2 * x3)
    z = np.zeros_like(o)
    if coords == "cartesian":
        return ((o, z, z), (z, o, z), (z, z, o))
    if coords == "spherical3D":
        cp, sp = np.cos(x3) * o, np.sin(x3) * o
        ct, st = np.cos(x2) * o, np.sin(x2) * o
        return ((st * cp, st * sp, ct), (ct * cp, ct * sp, -st), (-sp, cp, z))
    if coords == "spherical2D":
        ct, st = np.cos(x2) * o, np.sin(x2) * o
        return ((st, z, ct), (ct, z, -st), (z, o, z))
    if coords == "spherical1D":
        return ((o, z, z), (z, z, -o), (z, o, z))
    if coords == "cylindrical":
        cp, sp = np.cos(x2) * o, np.sin(x2) * o
        return ((cp, sp, z), (-sp, cp, z), (z, z, o))
    if coords == "axisymmetric":  # (R, z, phi); Rhat, zhat, phihat in (x,y,z)
        cp, sp = np.cos(x3) * o, np.sin(x3) * o
        return ((cp, sp, z), (z, z, o), (-sp, cp, z))
    raise ValueError(coords)


def convert_to_cart(coords: str, x1, x2, x3):
    """Point conversion (x1,x2,x3) -> Cartesian (x,y,z) for each system
    (cf. ConvertCoordsToCart in src/geometry/*.hpp).  numpy, broadcastable."""
    x1, x2, x3 = np.asarray(x1), np.asarray(x2), np.asarray(x3)
    if coords == "cartesian":
        return x1, x2, x3
    if coords == "spherical3D":
        st, ct = np.sin(x2), np.cos(x2)
        return x1 * st * np.cos(x3), x1 * st * np.sin(x3), x1 * ct
    if coords == "spherical2D":
        st, ct = np.sin(x2), np.cos(x2)
        return x1 * st, 0.0 * x1, x1 * ct
    if coords == "spherical1D":
        return x1, 0.0 * x1, 0.0 * x1
    if coords == "cylindrical":  # (R, phi, z)
        return x1 * np.cos(x2), x1 * np.sin(x2), x3 * np.ones_like(x1 * x2)
    if coords == "axisymmetric":  # (R, z, phi)
        return x1 * np.cos(x3), x1 * np.sin(x3), x2 * np.ones_like(x1 * x3)
    raise ValueError(coords)


@dataclass(frozen=True)
class Geometry:
    """Per-axis geometric factor arrays over the *entire* (ghost-padded) grid.

    Host-side object: the step builder extracts concrete arrays from it at
    trace time (they become XLA constants), so no tracers ever flow through
    these numpy formulas.

    Face arrays (``xf*``) have ``n+1`` entries along their axis.  Quantities
    that factorize are stored as the per-axis factors; combine with
    :func:`_bcast` (XLA fuses the outer product into consumers).
    """

    coords: str
    # face coordinates (1-D, length n_d + 1)
    xf1: np.ndarray
    xf2: np.ndarray
    xf3: np.ndarray
    # volume-averaged centroids (1-D, length n_d)
    xv1: np.ndarray
    xv2: np.ndarray
    xv3: np.ndarray
    # coordinate widths (1-D)
    dx1: np.ndarray
    dx2: np.ndarray
    dx3: np.ndarray
    # cell volume factors: vol = prod of per-axis factors
    vol1: np.ndarray
    vol2: np.ndarray
    vol3: np.ndarray
    # face-area factors: area_d = (face factor along d) x (cell factors across)
    # areaD_fd is indexed by face along axis d (length n_d+1)
    area1_f1: np.ndarray
    area1_c2: np.ndarray
    area1_c3: np.ndarray
    area2_f2: np.ndarray
    area2_c1: np.ndarray
    area2_c3: np.ndarray
    area3_f3: np.ndarray
    area3_c1: np.ndarray
    area3_c2: np.ndarray
    # volume-averaged scale factors, factored per axis:
    # hx_dv = hdv_1(x1) * hdv_2(x2)   (never x3-dependent)
    h1v_1: np.ndarray
    h1v_2: np.ndarray
    h2v_1: np.ndarray
    h2v_2: np.ndarray
    h3v_1: np.ndarray
    h3v_2: np.ndarray
    # connection terms (volume-averaged <(1/h) dh/dx>)
    dh2dx1: np.ndarray  # 1-D along x1
    dh3dx1: np.ndarray  # 1-D along x1
    dh3dx2: np.ndarray  # 1-D along x2

    # ------------------------------------------------------------------
    @property
    def ncells(self) -> Tuple[int, int, int]:
        return (len(self.xv3), len(self.xv2), len(self.xv1))

    # scale-factor *functions* h_d(x1, x2) for pointwise evaluation
    # (face centers, etc.)
    def hx(self, d: int, x1, x2):
        c = self.coords
        if c == "cartesian":
            return np.ones_like(x1 * x2)
        if d == 1:
            return np.ones_like(x1 * x2)
        if d == 2:
            if is_spherical(c) or c == "cylindrical":
                return x1 * np.ones_like(x2)
            return np.ones_like(x1 * x2)
        # d == 3
        if c in ("spherical2D", "spherical3D"):
            return x1 * np.sin(x2)
        if c == "axisymmetric":
            return x1 * np.ones_like(x2)
        return np.ones_like(x1 * x2)

    # broadcast helpers -------------------------------------------------
    def volume(self):
        return _bcast(self.vol1, self.vol2, self.vol3)

    def hv(self, d: int):
        """Volume-averaged scale factor h_d, broadcast to [x3, x2, x1]."""
        f1, f2 = {
            1: (self.h1v_1, self.h1v_2),
            2: (self.h2v_1, self.h2v_2),
            3: (self.h3v_1, self.h3v_2),
        }[d]
        one3 = np.ones((1,), f1.dtype)
        return _bcast(f1, f2, one3)

    def cell_widths(self):
        """Physical cell widths broadcast to [x3, x2, x1].

        The reference evaluates hx at the cell centroid (GetCellWidths,
        src/geometry/geometry.hpp:347-354): width_d = hx_d(xv) * dx_d.
        """
        one = np.ones((1,), self.dx1.dtype)
        h = lambda d: self.hx(d, self.xv1[None, None, :], self.xv2[None, :, None])
        w1 = _bcast(self.dx1, one, one) * h(1)
        w2 = _bcast(one, self.dx2, one) * h(2)
        w3 = _bcast(one, one, self.dx3) * h(3)
        return w1, w2, w3

    def face_area(self, d: int):
        """Face areas along axis d, shaped [x3, x2, x1] with faces along d."""
        if d == 1:
            return _bcast(self.area1_f1, self.area1_c2, self.area1_c3)
        if d == 2:
            return _bcast(self.area2_c1, self.area2_f2, self.area2_c3)
        return _bcast(self.area3_c1, self.area3_c2, self.area3_f3)

    def face_h(self, d: int, fdir: int):
        """Scale factor h_d evaluated at the *lower* face centroid of each cell
        along direction fdir (for momentum-flux scaling,
        cf. ScaleMomentumFlux, src/utils/fluxes/fluid_fluxes.hpp:32-70).

        Returns a broadcastable [x3, x2, x1(+1 along fdir)] array.
        """
        # face centroid coordinates: the fdir coordinate is the face value,
        # others are centroids (with the <r>-face-average special cases).
        c = self.coords
        if fdir == 1:
            x1 = self.xf1  # faces: length n1+1
            x2 = self.xv2
        elif fdir == 2:
            # FaceCenX2 uses the area-averaged radius <r> = d(r^3/3)/d(r^2/2)
            if x1dep(c):
                rm, rp = self.xf1[:-1], self.xf1[1:]
                x1 = 2.0 / 3.0 * (rm * rm + rm * rp + rp * rp) / (rm + rp)
            else:
                x1 = self.xv1
            x2 = self.xf2
        else:
            if x1dep(c):
                rm, rp = self.xf1[:-1], self.xf1[1:]
                x1 = 2.0 / 3.0 * (rm * rm + rm * rp + rp * rp) / (rm + rp)
            else:
                x1 = self.xv1
            # FaceCenX3 uses the arithmetic x2 midpoint (spherical.hpp:97-104)
            x2 = 0.5 * (self.xf2[:-1] + self.xf2[1:])
        h = self.hx(d, x1[None, None, :], x2[None, :, None])
        return h


def _centroid_x1(coords: str, xm, xp):
    if is_spherical(coords):
        dr2 = xm * xm + xp * xp
        return 0.75 * (xm + xp) * dr2 / (dr2 + xm * xp)
    if coords in ("cylindrical", "axisymmetric"):
        return 2.0 / 3.0 * (xm * xm + xm * xp + xp * xp) / (xm + xp)
    return 0.5 * (xm + xp)


def _centroid_x2(coords: str, xm, xp):
    if coords in ("spherical2D", "spherical3D"):
        ctm, ctp = np.cos(xm), np.cos(xp)
        dst = np.sin(xp) - np.sin(xm)
        return (dst - xp * ctp + xm * ctm) / np.abs(ctm - ctp)
    return 0.5 * (xm + xp)


def build_geometry(coords: str, xf1, xf2, xf3, dtype=np.float64) -> Geometry:
    """Construct the factored geometry arrays from 1-D face positions."""
    if coords not in _SYSTEMS:
        raise ValueError(f"unknown coordinates {coords!r}")
    xf1 = np.asarray(xf1, dtype)
    xf2 = np.asarray(xf2, dtype)
    xf3 = np.asarray(xf3, dtype)
    x1m, x1p = xf1[:-1], xf1[1:]
    x2m, x2p = xf2[:-1], xf2[1:]
    x3m, x3p = xf3[:-1], xf3[1:]
    dx1, dx2, dx3 = x1p - x1m, x2p - x2m, x3p - x3m
    one1 = np.ones_like(dx1)
    one2 = np.ones_like(dx2)
    one3 = np.ones_like(dx3)
    onef1 = np.ones_like(xf1)
    onef2 = np.ones_like(xf2)
    onef3 = np.ones_like(xf3)

    xv1 = _centroid_x1(coords, x1m, x1p)
    xv2 = _centroid_x2(coords, x2m, x2p)
    xv3 = 0.5 * (x3m + x3p)

    zero1 = np.zeros_like(dx1)
    zero2 = np.zeros_like(dx2)
    sph_rfac = (x1m * x1m + x1m * x1p + x1p * x1p) / 3.0
    cyl_rfac = 0.5 * (x1m + x1p)
    dcos = np.abs(np.cos(x2m) - np.cos(x2p))
    dh_r = 1.5 * (x1m + x1p) / (x1m * x1m + x1m * x1p + x1p * x1p)
    dh_cyl = 1.0 / (0.5 * (x1m + x1p))

    if coords == "cartesian":
        vol = (dx1, dx2, dx3)
        a1 = (onef1, dx2, dx3)
        a2 = (dx1, onef2, dx3)
        a3 = (dx1, dx2, onef3)
        h1v = (one1, one2)
        h2v = (one1, one2)
        h3v = (one1, one2)
        conn = (zero1, zero1, zero2)
    elif coords == "spherical3D":
        vol = (sph_rfac * dx1, dcos, dx3)
        a1 = (xf1 * xf1, dcos, dx3)
        a2 = (cyl_rfac * dx1, np.sin(xf2), dx3)
        a3 = (cyl_rfac * dx1, dx2, onef3)
        stm, stp = np.sin(x2m), np.sin(x2p)
        ctm, ctp = np.cos(x2m), np.cos(x2p)
        dsc = stp * ctp - stm * ctm
        sinfac = 0.5 * (dx2 - dsc) / np.abs(ctm - ctp)
        h1v = (one1, one2)
        h2v = (xv1, one2)
        h3v = (xv1, sinfac)
        conn = (dh_r, dh_r, (stp - stm) / dcos)
    elif coords == "spherical2D":
        vol = (sph_rfac * dx1, dcos, one3)
        a1 = (xf1 * xf1, dcos, one3)
        a2 = (cyl_rfac * dx1, np.sin(xf2), one3)
        a3 = (cyl_rfac * dx1, dx2, onef3)
        stm, stp = np.sin(x2m), np.sin(x2p)
        ctm, ctp = np.cos(x2m), np.cos(x2p)
        dsc = stp * ctp - stm * ctm
        sinfac = 0.5 * (dx2 - dsc) / np.abs(ctm - ctp)
        h1v = (one1, one2)
        h2v = (xv1, one2)
        h3v = (xv1, sinfac)
        conn = (dh_r, dh_r, (stp - stm) / dcos)
    elif coords == "spherical1D":
        vol = (sph_rfac * dx1, one2, one3)
        a1 = (xf1 * xf1, one2, one3)
        a2 = (cyl_rfac * dx1, onef2, one3)
        a3 = (cyl_rfac * dx1, one2, onef3)
        # NOTE: spherical1D inherits base hx2v = hx3v = 1
        # (src/geometry/spherical.hpp:441-527 overrides only hx2(x), x1v).
        h1v = (one1, one2)
        h2v = (one1, one2)
        h3v = (one1, one2)
        conn = (dh_r, dh_r, zero2)
    elif coords == "cylindrical":
        # (R, phi, z)
        vol = (cyl_rfac * dx1, dx2, dx3)
        a1 = (xf1, dx2, dx3)
        a2 = (dx1, onef2, dx3)  # base-class AreaX2: dx1*dx3
        a3 = (cyl_rfac * dx1, dx2, onef3)
        h1v = (one1, one2)
        h2v = (xv1, one2)
        h3v = (one1, one2)
        conn = (dh_cyl, np.zeros_like(dx1), zero2)  # dh2dx1 only
    else:  # axisymmetric (R, z, phi)
        vol = (cyl_rfac * dx1, dx2, dx3)
        a1 = (xf1, dx2, dx3)
        a2 = (cyl_rfac * dx1, onef2, dx3)
        a3 = (dx1, dx2, onef3)  # base AreaX3: dx1*dx2
        h1v = (one1, one2)
        h2v = (one1, one2)
        h3v = (xv1, one2)
        conn = (np.zeros_like(dx1), dh_cyl, zero2)  # (dh2dx1, dh3dx1, dh3dx2)

    if coords in ("spherical1D", "spherical2D", "spherical3D"):
        conn_dh2dx1, conn_dh3dx1, conn_dh3dx2 = conn
    elif coords == "cylindrical":
        conn_dh2dx1, conn_dh3dx1, conn_dh3dx2 = dh_cyl, np.zeros_like(dx1), zero2
    elif coords == "axisymmetric":
        conn_dh2dx1, conn_dh3dx1, conn_dh3dx2 = np.zeros_like(dx1), dh_cyl, zero2
    else:
        conn_dh2dx1, conn_dh3dx1, conn_dh3dx2 = zero1, zero1, zero2

    return Geometry(
        coords=coords,
        xf1=xf1, xf2=xf2, xf3=xf3,
        xv1=xv1, xv2=xv2, xv3=xv3,
        dx1=dx1, dx2=dx2, dx3=dx3,
        vol1=vol[0], vol2=vol[1], vol3=vol[2],
        area1_f1=a1[0], area1_c2=a1[1], area1_c3=a1[2],
        area2_c1=a2[0], area2_f2=a2[1], area2_c3=a2[2],
        area3_c1=a3[0], area3_c2=a3[1], area3_f3=a3[2],
        h1v_1=h1v[0], h1v_2=h1v[1],
        h2v_1=h2v[0], h2v_2=h2v[1],
        h3v_1=h3v[0], h3v_2=h3v[1],
        dh2dx1=conn_dh2dx1, dh3dx1=conn_dh3dx1, dh3dx2=conn_dh3dx2,
    )
