"""Uniform structured grid with ghost zones.

Replacement for the Parthenon Mesh/MeshBlock machinery (reference L1; see
SURVEY.md).  Instead of many MeshBlocks distributed over MPI ranks, the mesh
is a single global array per variable, ghost-padded along active dimensions;
multi-device runs split it into slabs along one axis, one per device, each
shard filling its halo from its neighbours' slabs
(``artemis_tpu_torch/parallel/mesh.py``).  Refinement (``amr.py``) layers a
block list on top of these same kernels.

Array layout: ``[..., x3, x2, x1]`` (x1 fastest — maps to TPU lanes).

The code is copied verbatim from ``artemis_tpu/grid.py`` (it needs only the standard
library and numpy), so that ``artemis_tpu_torch`` runs where JAX is not
installed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .geometry import geometry as geo


@dataclass(frozen=True)
class Grid:
    coords: str                       # resolved coordinate system
    nx: Tuple[int, int, int]          # interior cells per direction (x1, x2, x3)
    xmin: Tuple[float, float, float]
    xmax: Tuple[float, float, float]
    nghost: int
    bc: Tuple[Tuple[str, str], Tuple[str, str], Tuple[str, str]]  # (inner, outer) per dir
    geom: geo.Geometry                # geometry over the entire padded grid
    # ROOT domain bounds: equal to xmin/xmax except on AMR patch grids,
    # where xmin/xmax are the patch bounds.  Problem generators that derive
    # quantities from the DOMAIN extent (linear_wave wavevector, advection
    # mode) must use these.
    dom_min: Tuple[float, float, float] = None
    dom_max: Tuple[float, float, float] = None

    def __post_init__(self):
        if self.dom_min is None:
            object.__setattr__(self, "dom_min", self.xmin)
        if self.dom_max is None:
            object.__setattr__(self, "dom_max", self.xmax)

    # ------------------------------------------------------------------
    @property
    def ndim(self) -> int:
        return 1 + (self.nx[1] > 1) + (self.nx[2] > 1)

    def active(self, d: int) -> bool:
        """Is direction d (1-based) evolved?"""
        return self.nx[d - 1] > 1

    @property
    def ng(self) -> Tuple[int, int, int]:
        """Ghost count per direction (0 for trivial dims), (x1, x2, x3)."""
        return tuple(self.nghost if n > 1 else 0 for n in self.nx)

    @property
    def shape_entire(self) -> Tuple[int, int, int]:
        """Padded array shape in [x3, x2, x1] order."""
        ng = self.ng
        return (self.nx[2] + 2 * ng[2], self.nx[1] + 2 * ng[1], self.nx[0] + 2 * ng[0])

    @property
    def int_slices(self) -> Tuple[slice, slice, slice]:
        """Interior slices in [x3, x2, x1] order."""
        ng = self.ng
        return (
            slice(ng[2], ng[2] + self.nx[2]),
            slice(ng[1], ng[1] + self.nx[1]),
            slice(ng[0], ng[0] + self.nx[0]),
        )

    def interior(self, arr):
        s3, s2, s1 = self.int_slices
        return arr[..., s3, s2, s1]

    # centroid coordinate arrays over the interior, broadcastable [x3,x2,x1]
    def cell_centers(self):
        s3, s2, s1 = self.int_slices
        g = self.geom
        return (
            g.xv1[s1][None, None, :],
            g.xv2[s2][None, :, None],
            g.xv3[s3][:, None, None],
        )

    def cell_centers_entire(self):
        g = self.geom
        return (
            g.xv1[None, None, :],
            g.xv2[None, :, None],
            g.xv3[:, None, None],
        )


def _face_coords(n: int, xmin: float, xmax: float, ng: int) -> np.ndarray:
    """Uniform face positions including ghost extensions."""
    dx = (xmax - xmin) / n
    return xmin + dx * np.arange(-ng, n + ng + 1, dtype=np.float64)


def grid_from_input(pin) -> Grid:
    """Build the Grid from a deck (``<parthenon/mesh>`` block, reference dialect)."""
    mb = "parthenon/mesh"
    nx1 = pin.get_int(mb, "nx1")
    nx2 = pin.get_or_add_int(mb, "nx2", 1)
    nx3 = pin.get_or_add_int(mb, "nx3", 1)
    ndim = 1 + (nx2 > 1) + (nx3 > 1)
    sys = pin.get_or_add_str("artemis", "coordinates", "cartesian")
    coords = geo.coord_select(sys, ndim)
    nghost = pin.get_or_add_int(mb, "nghost", 2)

    xmin = (pin.get_real(mb, "x1min"),
            pin.get_or_add_real(mb, "x2min", 0.0),
            pin.get_or_add_real(mb, "x3min", 0.0))
    xmax = (pin.get_real(mb, "x1max"),
            pin.get_or_add_real(mb, "x2max", 1.0),
            pin.get_or_add_real(mb, "x3max", 1.0))

    def bcpair(d):
        if (nx1, nx2, nx3)[d - 1] == 1:
            return ("none", "none")
        return (
            pin.get_or_add_str(mb, f"ix{d}_bc", "periodic"),
            pin.get_or_add_str(mb, f"ox{d}_bc", "periodic"),
        )

    bc = (bcpair(1), bcpair(2), bcpair(3))

    ng = tuple(nghost if n > 1 else 0 for n in (nx1, nx2, nx3))
    xf1 = _face_coords(nx1, xmin[0], xmax[0], ng[0])
    xf2 = _face_coords(nx2, xmin[1], xmax[1], ng[1])
    xf3 = _face_coords(nx3, xmin[2], xmax[2], ng[2])
    geom = geo.build_geometry(coords, xf1, xf2, xf3)

    return Grid(
        coords=coords,
        nx=(nx1, nx2, nx3),
        xmin=xmin,
        xmax=xmax,
        nghost=nghost,
        bc=bc,
        geom=geom,
    )
