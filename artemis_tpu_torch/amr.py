"""Static and adaptive mesh refinement (port of ``artemis_tpu/amr.py``,
single device).

The reference refines with Parthenon's oct-tree of MeshBlocks; the JAX
package replaced it with a tree of fixed-shape rectangular patches, factor
2 per level, advanced in lockstep with one global dt.  Per RK stage:

1. every node's ghosts: the root's from the deck's boundaries, a patch's
   from MinMod-prolonged parent primitives (ProlongateSharedMinMod) or,
   where an adjacent same-level sibling covers them, from its fine data;
2. every node's stage;
3. conservation at every coarse-fine face: the parent's face flux is
   replaced by the area mean of the child's fluxes (SetFluxCorrections);
4. the child's conserved state restricted onto the parent cells it covers
   (RestrictAverage), then the parent's primitives re-synced.

The composable path (every CPU run, ``fused=False``, and on the card every
curvilinear tree, every tree with dust and every tree coupled to N-body
particles, as the JAX package gates its own kernel path) runs this with
tensor operations over every fluid, the flux correction before the update;
on the card a Cartesian node's gas fluxes go through the flux sweep
kernel.  The fused path runs each node's whole stage as the curvilinear
stage kernel: one node-batched launch (``ops.stage_curv.stage_curv_batched``,
TPU kernel K6) when every node shares the grid shape, else one six-face
launch per node (K5b), or a padded launch per node (K4) when the tree has
no six-face halo; the coarse-fine fix-ups then land as rim deltas (the
pooled fine face flux minus the parent's own, recomputed on thin windows)
on the kernel's outputs, with restriction and the re-sync on the child's
bounding block.  Radiation runs after the stages, level by level: parents
first, patches with Dirichlet ghost planes prolonged from their parent's
new field, then the fine fields restrict back.

Ported: static and adaptive trees (``refinement = static | adaptive``) on
Cartesian and curvilinear grids, N levels, several disjoint or adjacent
patches per level, gas and dust with the sources and diffusion of the
single-level driver, gray FLD radiation, N-body coupling with the force
rows summed over the levels and particle-tracking patches
(``refine_distance``), and bit-exact restarts (the fine levels as the JAX
package's ``amr.*`` payloads, the tile pool's topology included).  A
curvilinear patch restricts by volume, corrects fluxes by area and
prolongs with centroid spacings; its weights depend on where it sits, so a
move rebuilds its grid.  Adaptive trees either spawn and destroy tiles of
a fixed lattice where the refinement tags land (``style = tiled``,
``regrid_tiles``) or move one patch per level onto the tagged cells
(``style = move``, ``_retag``); the tags are computed on the device and
only their bool masks reach the host.  Patch positions are host integers
on the nodes; every topology or position change re-runs the tree's set-up
(``_compile``).  The composable stage, the radiation pass and the set-up
reach the parent frames, the ghost exchange, the flux correction and the
restriction through hooks that are identities here;
``parallel.amr.ShardedSMR`` overrides them to run the tree over several
devices.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import bc as bc_mod
from .driver import apply_sources, curv_point_grav, nbody_coeffs
from .geometry import geometry as geo
from .grid import Grid
from .ops import recon as recon_mod
from .ops import refinement as ref_mod
from .ops import riemann as riemann_mod
from .ops import stage_curv as curv_mod
from .ops import sweeps
from .ops.hydro import FluidCfg, Hydro
from .profiling import host_read, span
from .sources import RotatingFrame
from .state import tree_rows, tree_topology_from_rows


def _refine_grid(coarse: Grid, lo: Tuple[int, int, int], n: Tuple[int, int, int]) -> Grid:
    """Fine-level Grid covering coarse cells [lo, lo+n) at 2x resolution."""
    g = coarse.geom
    s3, s2, s1 = coarse.int_slices
    xf = []
    for d, (l, nn) in enumerate(zip(lo, n)):
        sl = (s1, s2, s3)[d]
        faces = {0: g.xf1, 1: g.xf2, 2: g.xf3}[d]
        xf.append((faces[sl.start + l], faces[sl.start + l + nn]))
    nxf = tuple(2 * nn if coarse.nx[d] > 1 else 1 for d, nn in enumerate(n))
    ngf = tuple(coarse.nghost if coarse.nx[d] > 1 else 0 for d in range(3))

    def faces_1d(d):
        f0, f1 = xf[d]
        dxf = (f1 - f0) / nxf[d]
        return f0 + dxf * np.arange(-ngf[d], nxf[d] + ngf[d] + 1, dtype=np.float64)

    geom = geo.build_geometry(coarse.coords, faces_1d(0), faces_1d(1), faces_1d(2))
    return dataclasses.replace(
        coarse, nx=nxf, xmin=tuple(xf[d][0] for d in range(3)),
        xmax=tuple(xf[d][1] for d in range(3)), geom=geom,
        bc=(("amr", "amr"), ("amr", "amr"), ("amr", "amr")),
        # domain-derived pgen quantities use the ROOT extents
        dom_min=coarse.dom_min, dom_max=coarse.dom_max)


def _zyx(starts, sizes):
    """(Ellipsis, z, y, x) slices from [z, y, x] starts and sizes."""
    return (Ellipsis,) + tuple(slice(s, s + n) for s, n in zip(starts, sizes))


def _rows(a, like, ax):
    """A spacing row as a tensor broadcast along axis ``ax`` of ``like``:
    a 1-D row spans ``ax``; a 2-D [L, n] row (one per leading entry, as the
    paired ghost windows stack their sides) spans axes 0 and ``ax``."""
    a = torch.as_tensor(a, dtype=like.dtype, device=like.device)
    shp = [1] * like.ndim
    if a.ndim == 2:
        shp[0] = a.shape[0]
    shp[ax] = a.shape[-1]
    return a.reshape(shp)


def prolong_minmod(wc, active, spacings=None):
    """MinMod-limited prolongation coarse->fine (factor 2 per active axis) of
    an array [..., z, y, x].  Uniform (``spacings`` None): each fine child is
    the parent -/+ a quarter of its limited slope (ProlongateSharedMinMod,
    prolongation.hpp:39-66 with constant dx).  Curvilinear: ``spacings[d-1]
    = (dxm, dxp, dxfm, dxfp)``, the centroid distances along axis d
    (GetGridSpacings, prolongation.hpp:36-67), so gradients and child
    offsets use the volume-averaged centres; an entry None keeps the
    uniform stencil on that axis."""
    out = wc
    for d in (1, 2, 3):
        if not active[d - 1]:
            continue
        sp_d = None if spacings is None else spacings[d - 1]
        ax = out.ndim - d
        n = out.shape[ax]
        lo = torch.cat([out.narrow(ax, 0, 1), out.narrow(ax, 0, n - 1)], dim=ax)
        hi = torch.cat([out.narrow(ax, 1, n - 1), out.narrow(ax, n - 1, 1)], dim=ax)
        dl = out - lo
        dr = hi - out
        if sp_d is None:
            slope = torch.where(dl * dr > 0.0,
                                torch.sign(dl) * torch.minimum(dl.abs(), dr.abs()), 0.0)
            minus, plus = out - 0.25 * slope, out + 0.25 * slope
        else:
            dxm, dxp, dxfm, dxfp = (_rows(a, out, ax) for a in sp_d)
            gxm = dl / dxm
            gxp = dr / dxp
            g = 0.5 * (torch.sign(gxm) + torch.sign(gxp)) * torch.minimum(gxm.abs(), gxp.abs())
            minus, plus = out - g * dxfm, out + g * dxfp
        st = torch.stack([minus, plus], dim=ax + 1)
        shape = list(out.shape)
        shape[ax] *= 2
        out = st.reshape(shape)
    return out


def centroid_spacings(xc, xf):
    """(dxm, dxp, dxfm, dxfp) per-cell rows (numpy) from coarse centroids
    ``xc`` and the fine centroids ``xf`` (twice as many) they split into;
    the edge cells get one-sided spacings (their gradient goes to 0 through
    the minmod)."""
    xc = np.asarray(xc)
    xf = np.asarray(xf)
    xm = np.concatenate([[xc[0] - 1.0], xc[:-1]])
    xp = np.concatenate([xc[1:], [xc[-1] + 1.0]])
    return (xc - xm, xp - xc, xc - xf[0::2], xf[1::2] - xc)


def restrict_average(wf, active, volf=None):
    """Restriction fine->coarse: sum(u_child V_child) / sum(V_child) over
    each 2^ndim block (RestrictAverage, restriction.hpp:30-80), pairing z,
    then y, then x, as the JAX package sums them; the plain block mean when
    ``volf`` (the fine cell volumes [z, y, x]) is None, exact for
    Cartesian."""
    def down(a, mean):
        out = a
        for d in (3, 2, 1):
            if not active[d - 1]:
                continue
            ax = out.ndim - d
            shape = list(out.shape)
            shape[ax] //= 2
            shape.insert(ax + 1, 2)
            pair = out.reshape(shape)
            out = pair.mean(dim=ax + 1) if mean else pair.sum(dim=ax + 1)
        return out

    if volf is None:
        return down(wf, True)
    return down(wf * volf, False) / down(volf, False)


def _fine_centroid_row(fg: Grid, d: int, nextra: int):
    """Volume-averaged fine centroids along axis d (numpy), extended
    ``nextra`` cells beyond the padded fine extent (a patch's fine faces are
    uniform by construction, _refine_grid)."""
    g = fg.geom
    xf = {1: g.xf1, 2: g.xf2, 3: g.xf3}[d]
    dxf = xf[1] - xf[0]
    faces = np.concatenate([xf[0] + dxf * np.arange(-nextra, 0), xf,
                            xf[-1] + dxf * np.arange(1, nextra + 1)])
    xm, xp = faces[:-1], faces[1:]
    if d == 1:
        return geo._centroid_x1(fg.coords, xm, xp)
    if d == 2:
        return geo._centroid_x2(fg.coords, xm, xp)
    return 0.5 * (xm + xp)


def _slab_window(wp, grid, d, fi, tlo, tn):
    """The 4-row window of the padded primitives ``wp`` around interior
    face plane ``fi`` along ``d``, over the transverse window [tlo,
    tlo+tn): what the face's flux is recomputed from (the kernel does not
    expose its fluxes)."""
    ng = grid.ng
    starts, sizes = [], []
    for dd in (3, 2, 1):
        if dd == d:
            starts.append(ng[dd - 1] + fi - 2)
            sizes.append(4)
        elif grid.nx[dd - 1] > 1:
            starts.append(ng[dd - 1] + tlo[dd - 1])
            sizes.append(int(tn[dd - 1]))
        else:
            starts.append(0)
            sizes.append(1)
    return wp[_zyx(starts, sizes)]


_COMP = 1  # the variable axis of a [1, 6, z, y, x] array


def _vel_perm(d):
    """Components with the normal velocity of direction d in slot 1 and the
    transverse pair in riemann._vel_indices order."""
    return [0, d, d % 3 + 1, ((d + 1) % 3) + 1, 4, 5]


_PERM_INDEX = {}


def _perm_components(arr, perm):
    """Reorder the variable axis (one gather; the index is made once per
    permutation and device)."""
    key = (tuple(perm), arr.device)
    idx = _PERM_INDEX.get(key)
    if idx is None:
        idx = _PERM_INDEX[key] = torch.tensor(perm, dtype=torch.long, device=arr.device)
    return arr.index_select(_COMP, idx)


def _rim_canon(win, d):
    """Canonical face window: the normal velocity in component 1 and the
    flux axis at position -3, so one d=1 solve makes the very operations
    of the per-direction solve."""
    if d != 1:
        win = _perm_components(win, _vel_perm(d))
    if d != 3:
        win = win.movedim(win.ndim - d, win.ndim - 3)
    return win


def _rim_uncanon(F, d):
    """Inverse of _rim_canon on a face-flux array."""
    if d != 3:
        F = F.movedim(F.ndim - 3, F.ndim - d)
    if d != 1:
        inv = [0] * 6
        for pos, src in enumerate(_vel_perm(d)):
            inv[src] = pos
        F = _perm_components(F, inv)
    return F


def _rim_batched_flux(wins, cfg, force_pcm):
    """Face fluxes of canonical windows ``wins`` [(d, window)], one
    reconstruction + Riemann chain per distinct window shape, each flux
    returned in its own direction's layout (bitwise the flux each window
    gives alone in its own direction)."""
    groups = {}
    for k, (_, w) in enumerate(wins):
        assert w.shape[0] == 1, "one species per window"
        groups.setdefault(tuple(w.shape), []).append(k)
    fluxes = [None] * len(wins)
    for ks in groups.values():
        S = torch.cat([wins[k][1] for k in ks], dim=0)
        if force_pcm or cfg.recon == "pcm":
            wl, wr = recon_mod.pcm(S, 3)
        else:
            wl, wr = recon_mod.plm_uniform(S, 3)
        ax = S.ndim - 3
        F, _, _ = riemann_mod.solve(wl.narrow(ax, 2, 1), wr.narrow(ax, 2, 1), 1, cfg.fluid,
                                    cfg.rsolver, cfg.gamma)
        for j, k in enumerate(ks):
            fluxes[k] = _rim_uncanon(F[j:j + 1], wins[k][0])
    return fluxes


def _restrict_face_mean(F, d, active):
    """Pool a fine face-plane flux onto the parent faces (mean over each
    2x2 of transverse fine faces)."""
    for c in (3, 2, 1):
        if c == d or not active[c - 1]:
            continue
        ax = F.ndim - c
        shp = list(F.shape)
        shp[ax] //= 2
        shp.insert(ax + 1, 2)
        F = F.reshape(shp).mean(dim=ax + 1)
    return F


def _edge_pad(a, ng):
    """Pad the last three axes of ``a`` by ng = (g1, g2, g3) cells, each
    ghost a copy of the nearest interior cell."""
    for d in (1, 2, 3):
        g = ng[d - 1]
        if g == 0:
            continue
        ax = a.ndim - d
        n = a.shape[ax]
        idx = torch.clamp(torch.arange(-g, n + g, device=a.device), 0, n - 1)
        a = a.index_select(ax, idx)
    return a


def _host_mask(tags):
    """A bool mask (a tensor on any device, or array-like) as numpy."""
    if torch.is_tensor(tags):
        tags = host_read(tags.detach(), "regrid_tags")
    return np.asarray(tags, dtype=bool)


class _Node:
    """One mesh region: the root domain (level 0) or a refinement patch."""

    def __init__(self, ml: "MultiLevelSMR", grid: Grid, parent: Optional["_Node"], lo, n,
                 level: int, wrap=None, kind: str = "local"):
        self.ml = ml
        # how a sharded tree holds the node (parallel.amr): "replicated"
        # (global frame, the same on every shard), "distributed" (a slab of
        # the patch per shard) or neither (the root, a wrap patch, every
        # node of a tree on one device)
        self.replicated = kind == "replicated"
        self.distributed = kind == "distributed"
        self.parent = parent
        self.children: List[_Node] = []
        self.level = level
        self.lo = tuple(int(v) for v in lo) if lo is not None else None
        self.n = tuple(int(v) for v in n) if n is not None else None
        self.index = len(ml.nodes)
        ml.nodes.append(self)
        if parent is not None:
            parent.children.append(self)
        # a tile of an adaptive pool (regrid_tiles spawns and destroys it)
        self.pool = False
        self.active = tuple(grid.nx[d] > 1 for d in range(3))
        # wrap[d]: the patch spans a (transitively) periodic parent axis;
        # its ghosts there are the periodic image of its own fine data
        if wrap is not None:
            self.wrap = tuple(bool(v) for v in wrap)
        elif parent is None:
            self.wrap = (False, False, False)
        else:
            self.wrap = tuple(self.active[d] and self.lo[d] == 0
                              and self.n[d] == parent.grid.nx[d]
                              and MultiLevelSMR._axis_periodic(parent, d) for d in range(3))
        ng = grid.ng
        # coarse cells beyond the patch feeding ghost prolongation:
        # ceil(ng/2), +1 so every used ghost's parent has both neighbours
        # for its slope
        self.rim = tuple(max(1, -(-ng[d] // 2)) + 1 if self.active[d] else 0
                         for d in range(3))
        self.curv = not geo.is_cartesian(grid.coords)
        self._build(grid)

    def _build(self, grid):
        """The node's grid and what is made from it: the operators, its
        sources, diffusion and radiation, and a curvilinear patch's weights
        (once per placement; ``rebuild_at`` repeats it after a move)."""
        ml = self.ml
        self.grid = grid
        # this node's fused stage, made once (a regrid rebuilds only the
        # spawned nodes')
        self.curv_stage = None
        self.hydro = ml._node_hydro(grid)
        self.sources = ([s.place(ml.device, ml.dtype) for s in ml.sources_factory(grid)]
                        if ml.sources_factory else [])
        self.diffusion = ml.diffusion_factory(self.hydro) if ml.diffusion_factory else None
        self.radiation = ml.radiation_factory(self.hydro) if ml.radiation_factory else None
        self.volf = None
        self.ghost_spacings = None
        if self.parent is None or not self.curv:
            return
        # position-dependent curvilinear weights: the fine volumes of the
        # volume-weighted restriction, and the centroid spacings of the
        # ghost prolongation over the whole rim window (past the padded
        # fine rows: rebuilt from the uniform fine faces)
        cg = ml._parent_grid(self)
        self.volf = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
            grid.geom.volume(), grid.shape_entire)[grid.int_slices]),
            dtype=ml.dtype, device=ml.device)
        cxv = (cg.geom.xv1, cg.geom.xv2, cg.geom.xv3)
        sp = []
        for d in range(3):
            if not self.active[d]:
                sp.append(None)
                continue
            a = cg.ng[d] + self.lo[d] - self.rim[d]
            xc = cxv[d][a:a + self.n[d] + 2 * self.rim[d]]
            xf = _fine_centroid_row(grid, d + 1, 2 * self.rim[d] - grid.ng[d])
            sp.append(tuple(torch.as_tensor(r, dtype=ml.dtype, device=ml.device)
                            for r in centroid_spacings(xc, xf)))
        self.ghost_spacings = tuple(sp)

    def interior_spacings(self):
        """Centroid spacings of the prolongation over the patch interior
        (GetGridSpacings over [lo, lo+n)): curvilinear prolongation that
        keeps the volume-weighted mean, so restricting a freshly prolonged
        patch gives its parent back (conservative moves).  None per axis on
        inactive and wrap axes (the uniform stencil), None on a Cartesian
        node."""
        if not self.curv or self.parent is None:
            return None
        cg, fg = self.ml._parent_grid(self), self.grid
        cxv = (cg.geom.xv1, cg.geom.xv2, cg.geom.xv3)
        fxv = (fg.geom.xv1, fg.geom.xv2, fg.geom.xv3)
        sp = []
        for d in range(3):
            if not self.active[d] or self.wrap[d]:
                sp.append(None)
                continue
            xc = cxv[d][cg.ng[d] + self.lo[d]:cg.ng[d] + self.lo[d] + self.n[d]]
            xf = fxv[d][fg.ng[d]:fg.ng[d] + 2 * self.n[d]]
            sp.append(centroid_spacings(xc, xf))
        return tuple(sp)

    def rebuild_at(self, new_lo):
        """Move this curvilinear patch to parent cell ``new_lo``: its grid,
        operators, sources, diffusion and weights are rebuilt at the new
        window (every weight depends on where the patch sits; a Cartesian
        patch is translation-invariant and only changes ``lo``).  The
        caller re-runs the tree's set-up."""
        self.lo = tuple(int(v) for v in new_lo)
        self._build(_refine_grid(self.ml._parent_grid(self), self.lo, self.n))

    def fluids(self):
        """[(name, cfg)] of the node's fluids: gas, then dust."""
        out = [("gas", self.hydro.gas)] if self.hydro.gas else []
        if self.hydro.dust:
            out.append(("dust", self.hydro.dust))
        return out

    def fill_fine_ghosts(self, wf, wc, lo):
        """Patch prims padded, the ghosts from the parent's prims ``wc``
        prolonged (only the ng-deep slab outside each coarse-fine face)."""
        fg = self.grid
        ngf = fg.ng
        for d in range(3):
            if self.wrap[d]:
                wc = self._wrap_pad(wc, d, self.rim[d])
        reg = _edge_pad(wf, ngf)
        for d in range(3):
            if not self.active[d] or self.wrap[d]:
                continue
            pair = self._prolong_ghost_slab_pair(wc, d, lo)
            for side in (0, 1):
                slab = pair[side]
                sl = [slice(None)] * reg.ndim
                sl[reg.ndim - 1 - d] = (slice(0, ngf[d]) if side == 0
                                        else slice(ngf[d] + fg.nx[d], None))
                reg[tuple(sl)] = slab
        for d in range(3):
            if self.wrap[d]:
                reg = self._wrap_ghosts(reg, d, ngf[d])
        return reg

    def ghost_strips(self, wc, lo, sib_links=None, sib_arrs=None):
        """(strips, slabs) of the six-face stage: the six prolonged ghost
        slabs (sibling fine data folded in) cut into the kernel's strip
        layouts (``ops.stage_curv.strip_shapes``: x1 [6, zp, yp, ng], x2
        [6, zp, ng, nx], x3 [6, ng, ny, nx]; 3-D, no wrap axes), and the
        raw slabs, which the rim-delta windows read."""
        ng = self.grid.nghost
        nx, ny, _ = self.grid.nx
        pairs = {d: self._prolong_ghost_slab_pair(wc, d, lo) for d in range(3)}
        slabs, strips = {}, {}
        for side in (0, 1):
            for d in range(3):
                s = pairs[d][side]
                if sib_links:
                    s = self._fold_sib_into_slab(s, d, side, sib_links, sib_arrs)
                slabs[(d + 1, side)] = s
            strips[("x1", side)] = slabs[(1, side)][0].contiguous()
            strips[("x2", side)] = slabs[(2, side)][0][..., ng:ng + nx].contiguous()
            strips[("x3", side)] = slabs[(3, side)][0][:, :, ng:ng + ny, ng:ng + nx].contiguous()
        return strips, slabs

    def _fold_sib_into_slab(self, s, d, side, links, arrs):
        """Slab ``s`` of face (d, side) with the parts that a sibling link
        covers replaced by the sibling's interior values."""
        fg = self.grid
        ngs = fg.ng
        for (si, dst, src) in links:
            sub_dst, sub_src = [], []
            for t in range(3):              # array order [z, y, x]
                ds_, ss_ = dst[t], src[t]
                if 2 - t == d:
                    lo_r = 0 if side == 0 else ngs[d] + fg.nx[d]
                    a = max(ds_.start, lo_r)
                    b = min(ds_.stop, lo_r + ngs[d])
                    if a >= b:
                        break
                    sub_dst.append(slice(a - lo_r, b - lo_r))
                    off = ss_.start + (a - ds_.start)
                    sub_src.append(slice(off, off + (b - a)))
                else:
                    sub_dst.append(ds_)
                    sub_src.append(ss_)
            else:
                s = s.clone()
                s[(Ellipsis,) + tuple(sub_dst)] = arrs[si][(Ellipsis,) + tuple(sub_src)]
        return s

    @staticmethod
    def _axis_window(a, ax, start, count):
        """Rows [start-1, start+count+1) along ``ax``, the outer neighbour
        rows clamped to the array (an edge row stands in for a missing
        neighbour, as JAX's dynamic_slice clamps)."""
        n = a.shape[ax]
        start = min(max(start, 0), n - count)
        return torch.cat([a.narrow(ax, max(start - 1, 0), 1), a.narrow(ax, start, count),
                          a.narrow(ax, min(start + count, n - 1), 1)], dim=ax)

    def _side_spacings(self, d, side):
        """The ghost spacing rows of face (d, side)'s prolongation: the rows
        of its window along d, the whole rim rows across (None on a
        Cartesian node)."""
        if self.ghost_spacings is None:
            return None
        m, n = self.rim[d] - 1, self.n[d]
        r = slice(0, m + 3) if side == 0 else slice(n + m - 1, n + 2 * m + 2)
        return tuple(None if rows is None else rows if t != d
                     else tuple(a[r] for a in rows)
                     for t, rows in enumerate(self.ghost_spacings))

    def _prolong_ghost_slab(self, wc, d, side, lo):
        """MinMod-prolonged fine ghost slab outside face (d, side): ng deep
        along d, the full padded transverse extents (corners included)."""
        rim, n = self.rim, self.n
        nd = wc.ndim
        m = [r - 1 for r in rim]
        slab = wc
        for t in range(3):
            if not self.active[t]:
                continue
            off = rim[t] if self.wrap[t] else 0
            if t == d:
                start = (lo[t] - m[t] if side == 0 else lo[t] + n[t] - 1) + off
                count = m[t] + 1
            else:
                start = lo[t] - m[t] + off
                count = n[t] + 2 * m[t]
            slab = self._axis_window(slab, nd - 1 - t, start, count)
        fine = prolong_minmod(slab, self.active, self._side_spacings(d, side))
        return self._ghost_cut(fine[None], 0, d, side)

    def _prolong_ghost_slab_pair(self, wc, d, lo):
        """Both side slabs of face axis ``d`` in one prolongation (the two
        sides share every transverse window, stacked on a new leading
        axis; a curvilinear node's spacing rows along d stacked beside
        them); bitwise _prolong_ghost_slab per side."""
        fine = prolong_minmod(self._ghost_windows(wc, d, lo), self.active,
                              self._pair_spacings(d))
        return [self._ghost_cut(fine, side, d, side) for side in (0, 1)]

    def _pair_spacings(self, d):
        """The spacing rows of both sides of face axis ``d``, the rows along
        d stacked [2, n] in side order (None on a Cartesian node)."""
        if self.ghost_spacings is None:
            return None
        s0, s1 = self._side_spacings(d, 0), self._side_spacings(d, 1)
        return tuple(s0[t] if t != d or s0[t] is None
                     else tuple(torch.stack([a, b]) for a, b in zip(s0[t], s1[t]))
                     for t in range(3))

    def _ghost_windows(self, wc, d, lo):
        """The parent windows that both side slabs of face axis ``d``
        prolong from, stacked on a new leading axis (side 0, side 1)."""
        rim, n = self.rim, self.n
        nd = wc.ndim
        m = [r - 1 for r in rim]
        slab = wc
        for t in range(3):
            if not self.active[t] or t == d:
                continue
            off = rim[t] if self.wrap[t] else 0
            slab = self._axis_window(slab, nd - 1 - t, lo[t] - m[t] + off, n[t] + 2 * m[t])
        ax_d = nd - 1 - d
        off = rim[d] if self.wrap[d] else 0
        s0 = self._axis_window(slab, ax_d, lo[d] - m[d] + off, m[d] + 1)
        s1 = self._axis_window(slab, ax_d, lo[d] + n[d] - 1 + off, m[d] + 1)
        return torch.stack([s0, s1])

    def _ghost_cut(self, fine, j, d, side):
        """Side ``side``'s ghost slab of face axis ``d`` from entry ``j`` of
        the prolonged windows ``fine`` (stacked on the leading axis)."""
        fg = self.grid
        ngf = fg.ng
        fine = fine[j]
        nd = fine.ndim
        m = [r - 1 for r in self.rim]
        sl = [slice(None)] * nd
        for t in range(3):
            if not self.active[t]:
                continue
            if t == d:
                o = 2 * (m[t] + 1)
                sl[nd - 1 - t] = slice(o - ngf[t], o) if side == 0 else slice(4, 4 + ngf[t])
            else:
                o = 2 * (m[t] + 1) - ngf[t]
                sl[nd - 1 - t] = slice(o, o + fg.nx[t] + 2 * ngf[t])
        return fine[tuple(sl)]

    def _wrap_pad(self, a, d, width):
        """Interior array ``a`` extended periodically by ``width`` cells
        along axis d (0 = x1); on a sharded axis the images are the
        neighbour shards' (``_exchange``)."""
        ax = a.ndim - 1 - d
        n = a.shape[ax]
        tail, head = self.ml._exchange(a.narrow(ax, n - width, width), a.narrow(ax, 0, width), d)
        return torch.cat([tail, a, head], dim=ax)

    def _wrap_ghosts(self, a, d, ng):
        """The ng-wide ghosts of padded ``a`` along axis d filled with the
        periodic image of its interior (the neighbour shards' on a sharded
        axis)."""
        ax = a.ndim - 1 - d
        nint = a.shape[ax] - 2 * ng
        lo_img, hi_img = self.ml._exchange(a.narrow(ax, nint, ng), a.narrow(ax, ng, ng), d)
        out = a.clone()
        out.narrow(ax, 0, ng).copy_(lo_img)
        out.narrow(ax, ng + nint, ng).copy_(hi_img)
        return out

    def flux_correct(self, fx_c, fx_f, lo, hc=None, scatter=None):
        """The parent's fluxes ``fx_c`` with its patch-boundary faces
        replaced by the child fluxes ``fx_f`` over each face: their mean on
        a Cartesian patch, their area-weighted sum over the parent face's
        area on a curvilinear one (SetFluxCorrections).  ``hc``: the Hydro
        of the parent frame ``lo`` indexes (the parent's own by default);
        ``scatter(Fc, update, starts, d, side)``: how a face plane lands in
        the parent's fluxes (in place at ``starts`` by default)."""
        n = self.n
        hc = self.parent.hydro if hc is None else hc
        out = {}
        for d in hc.dims:
            if self.wrap[d - 1]:
                out[d] = fx_c[d]        # full-span periodic axis: no C-F faces
                continue
            Fc = fx_c[d][0].clone()
            Ff = fx_f[d][0]
            for side in (0, 1):
                f_res = Ff.select(Ff.ndim - d, side * 2 * n[d - 1])
                if self.curv:
                    af = self.hydro.area[d]
                    f_res = f_res * af.select(af.ndim - d, side * 2 * n[d - 1])
                for j, c in enumerate(c for c in (3, 2, 1) if c != d):
                    if not self.active[c - 1]:
                        continue
                    ax = f_res.ndim - 2 + j
                    shp = list(f_res.shape)
                    shp[ax] //= 2
                    shp.insert(ax + 1, 2)
                    pair = f_res.reshape(shp)
                    f_res = pair.sum(dim=ax + 1) if self.curv else pair.mean(dim=ax + 1)
                starts, sizes = [], []
                for c in (3, 2, 1):
                    if c == d:
                        starts.append(lo[d - 1] + side * n[d - 1])
                        sizes.append(1)
                    elif self.active[c - 1]:
                        starts.append(lo[c - 1])
                        sizes.append(n[c - 1])
                    else:
                        starts.append(0)
                        sizes.append(1)
                if self.curv:
                    f_res = f_res / hc.area[d][_zyx(starts, sizes)].squeeze(-d)
                if scatter is None:
                    Fc[_zyx(starts, sizes)] = f_res.unsqueeze(-d)
                else:
                    Fc = scatter(Fc, f_res.unsqueeze(-d), starts, d, side)
            out[d] = (Fc,) + tuple(fx_c[d][1:])
        return out


class MultiLevelSMR:
    """N-level static or adaptive refinement tree on one device.
    ``fused``: run each node's stage through the curvilinear stage kernel
    (its plain version on the CPU) with the rim-delta glue, as the card's
    main path does; else the composable tensor path.  ``gather6=False``
    keeps a fused tree on padded halos.  ``moving_patches``: patches may be
    moved by retagging (move style); such a tree keeps padded halos and
    links only its pool tiles to their siblings."""

    def __init__(self, root_grid: Grid, integrator, gas_cfg: FluidCfg, *, device, dtype,
                 dust_cfg: Optional[FluidCfg] = None, sources_factory=None,
                 diffusion_factory=None, bc_custom=None, omf: float = 0.0, patches=None,
                 radiation_factory=None, fused=False, moving_patches: bool = False,
                 nbody=None):
        self.device = torch.device(device)
        self.dtype = dtype
        self.integ = integrator
        self.cfg = gas_cfg
        self.dust_cfg = dust_cfg
        self.nbody = nbody
        self.sources_factory = sources_factory
        self.diffusion_factory = diffusion_factory
        self.radiation_factory = radiation_factory
        self.bc_custom = bc_custom or {}
        self.omf = omf
        self.moving_patches = moving_patches
        self._g6_root_strips = None
        self.nodes: List[_Node] = []
        self.root = _Node(self, root_grid, None, None, None, 0)
        for spec in sorted(patches or [], key=lambda s: s["level"]):
            self.add_patch(spec["level"], spec["lo"], spec["n"])
        self._compile(fused)

    @staticmethod
    def _axis_periodic(node: _Node, d: int) -> bool:
        """Is axis ``d`` of ``node`` (transitively) periodic?"""
        if node.parent is None:
            return node.grid.bc[d] == ("periodic", "periodic")
        return bool(node.wrap[d])

    # -- sharding hooks (identities on one device; parallel.amr.ShardedSMR
    # overrides them with the exchanges between its shards) ---------------
    _shard_axis = None  # 1..3 when the tree is sharded along x_d
    # the fused stage kernels and their glue (ShardedSMR keeps the
    # composable stage)
    _fused_ok = True

    @property
    def ic_grids(self):
        """Each node's global grid (the problem generator's initial state is
        made on these)."""
        return [nd.grid for nd in self.nodes]

    @property
    def global_nodes(self):
        """The nodes with their global positions and extents (a checkpoint's
        topology rows)."""
        return self.nodes

    def _node_hydro(self, grid):
        """A node's Hydro on ``grid``."""
        return Hydro(grid, self.cfg, self.dust_cfg, device=self.device, dtype=self.dtype)

    def _exchange(self, tail, head, d: int):
        """The (low, high) periodic images along axis ``d`` (0 = x1) from
        this block's own boundary slabs: on one device its other end."""
        return tail, head

    def _root_fill(self, w, node: _Node, fluid: str):
        """The root's padded prims, ghosts from the deck's boundaries."""
        return bc_mod.pad_and_fill(w, node.grid, fluid, self.bc_custom)

    def _parent_arrs(self, arrs, nodes=None):
        """Per node (of ``nodes``, every node by default; None elsewhere and
        for the root), its parent's array from the per-node ``arrs``, in the
        frame of the node's ``lo``."""
        want = self.nodes if nodes is None else nodes
        out = [None] * len(self.nodes)
        for nd in want:
            if nd.parent is not None:
                out[nd.index] = arrs[nd.parent.index]
        return out

    def _post_fine_ghosts(self, wp, node: _Node, fluid: str):
        """A patch's padded array after its ghosts are filled."""
        return wp

    def _parent_grid(self, node: _Node):
        """The grid of the parent frame ``node.lo`` indexes."""
        return node.parent.grid

    def _flux_correct(self, node: _Node, fx_c, fx_f, lo):
        return node.flux_correct(fx_c, fx_f, lo)

    def _restrict_into(self, node: _Node, arr, res, lo):
        """Deposit the node's restricted array ``res`` into its parent's
        ``arr`` at ``lo`` (in place; ``arr`` is a fresh output of this
        stage)."""
        return self._deposit(arr, res, lo)

    def _node_pforce(self, node: _Node, pf):
        """The node's N-body force rows as the levels' sum takes them."""
        return pf

    def _rad_solve(self, node: _Node, st, dt, ghosts):
        """One node's radiation step and gas re-sync."""
        rad = node.radiation
        st = rad.step(st, dt) if ghosts is None else rad.step(st, dt, ghosts=ghosts)
        return rad.sync_gas(st)

    def node_radiation(self, node: _Node):
        """The Radiation that steps ``node``'s field."""
        return node.radiation

    def _sib_pair_ok(self, a: _Node, b: _Node) -> bool:
        """May siblings ``a`` and ``b`` take each other's fine ghosts?"""
        return True

    def _place_node(self, node: _Node, lo):
        """Put a patch at parent cell ``lo`` (a curvilinear one is rebuilt
        there); the caller re-runs the set-up."""
        if node.curv:
            node.rebuild_at(lo)
        else:
            node.lo = tuple(int(v) for v in lo)

    def root_state(self, states):
        """The root's state as ``evolve`` sees it."""
        return {k: dict(v) for k, v in states[0].items()}

    def with_root(self, states, root_state):
        """``states`` with the root's state replaced by ``root_state``."""
        states[0] = {k: dict(v) for k, v in root_state.items()}
        return states

    def add_patch(self, level: int, lo, n, parent=None):
        """Register a patch; ``lo``/``n`` are in the interior cells of its
        level-1 parent: ``parent`` where given (a pool's tile windows can
        fall inside several same-level parents), else the first of that
        level that holds it."""
        parents = ([parent] if parent is not None
                   else [nd for nd in self.nodes if nd.level == level - 1])
        if not parents:
            raise ValueError(f"no level-{level - 1} parent for a level-{level} patch")
        parent = None
        for cand in parents:
            ok = True
            for d in range(3):
                if cand.grid.nx[d] <= 1:
                    continue
                # a full-span patch on a periodic axis wraps onto itself
                if lo[d] == 0 and n[d] == cand.grid.nx[d] and self._axis_periodic(cand, d):
                    continue
                rim = max(1, -(-cand.grid.ng[d] // 2))
                if lo[d] < rim or lo[d] + n[d] > cand.grid.nx[d] - rim:
                    ok = False
            if ok:
                parent = cand
                break
        if parent is None:
            raise ValueError(f"level-{level} patch {lo}+{n} is not nested (with ghost rim) "
                             "inside any coarser patch")
        for sib in parent.children:
            if not any(parent.grid.nx[d] > 1 and (lo[d] >= sib.lo[d] + sib.n[d]
                                                  or sib.lo[d] >= lo[d] + n[d])
                       for d in range(3)):
                raise ValueError("same-level patches must be disjoint")
        return _Node(self, _refine_grid(parent.grid, lo, n), parent, lo, n, level)

    def topology(self):
        """The node list and each node's attributes (position, grid,
        operators, index, children), for ``set_topology`` to put back after
        cycles that moved, spawned or dropped patches."""
        return [(node, dict(vars(node)), list(node.children)) for node in self.nodes]

    def set_topology(self, snap):
        """Put back a ``topology()`` snapshot and re-run the set-up."""
        self.nodes = [node for node, _, _ in snap]
        for node, attrs, children in snap:
            vars(node).clear()
            vars(node).update(attrs)
            node.children = list(children)
        self._compile(self.fused, self.gather6)

    # -- same-level links (Parthenon's same-level boundary buffers) -------
    def _links_static(self, node: _Node) -> bool:
        """Does this node stay put between set-ups?  Always on a tree whose
        patches do not move; on a moving tree only its pool tiles (a
        retagged patch keeps prolonged ghosts, as the JAX tree's traced
        positions do)."""
        return not self.moving_patches or node.pool

    def _sibling_links(self):
        """{node.index: [(sib_index, dst_slices, src_slices), ...]}: the
        overlap of each static patch's padded box with each static
        same-parent sibling's interior, as [z, y, x] slices into the padded
        patch (dst) and the sibling's interior (src)."""
        links = {node.index: [] for node in self.nodes}
        for node in self.nodes[1:]:
            if not self._links_static(node):
                continue
            ng = node.grid.ng
            for sib in node.parent.children:
                if sib is node or not self._links_static(sib) or not self._sib_pair_ok(node, sib):
                    continue
                dst, src = [], []
                for d in (2, 1, 0):
                    if not node.active[d]:
                        dst.append(slice(0, 1))
                        src.append(slice(0, 1))
                        continue
                    n_lo = 2 * node.lo[d] - ng[d]
                    n_hi = 2 * (node.lo[d] + node.n[d]) + ng[d]
                    s_lo = 2 * sib.lo[d]
                    s_hi = s_lo + 2 * sib.n[d]
                    a, b = max(n_lo, s_lo), min(n_hi, s_hi)
                    if a >= b:
                        break
                    dst.append(slice(a - n_lo, b - n_lo))
                    src.append(slice(a - s_lo, b - s_lo))
                else:
                    links[node.index].append((sib.index, tuple(dst), tuple(src)))
        return links

    def _padded_prims(self, ws, fluid="gas"):
        """Every node's padded prims of ``fluid`` from the interior prims
        ``ws``: the root's ghosts from the deck's boundaries, a patch's
        prolonged from its parent's (one prolongation per face axis and
        patch shape for the Cartesian patches without wrap axes: bitwise
        each patch's own fill_fine_ghosts) with the siblings' fine data
        written over."""
        wpads = [None] * len(self.nodes)
        pws = self._parent_arrs(ws)
        groups = {}
        for node in self.nodes:
            i = node.index
            if node.parent is None:
                wpads[i] = self._root_fill(ws[i], node, fluid)
            elif any(node.wrap) or node.curv:
                wpads[i] = node.fill_fine_ghosts(ws[i], pws[i], node.lo)
            else:
                groups.setdefault(node.n, []).append(node)
        for nodes in groups.values():
            for node in nodes:
                wpads[node.index] = _edge_pad(ws[node.index], node.grid.ng)
            for d in range(3):
                if not nodes[0].active[d]:
                    continue
                fine = prolong_minmod(torch.cat([nd._ghost_windows(pws[nd.index], d, nd.lo)
                                                 for nd in nodes]), nodes[0].active)
                for k, node in enumerate(nodes):
                    reg, fg = wpads[node.index], node.grid
                    for side in (0, 1):
                        sl = [slice(None)] * reg.ndim
                        sl[reg.ndim - 1 - d] = (slice(0, fg.ng[d]) if side == 0
                                                else slice(fg.ng[d] + fg.nx[d], None))
                        reg[tuple(sl)] = node._ghost_cut(fine, 2 * k + side, d, side)
        for node in self.nodes[1:]:
            wpads[node.index] = self._post_fine_ghosts(
                self._apply_sib_links(wpads[node.index], self._sib_links[node.index], ws),
                node, fluid)
        return wpads

    @staticmethod
    def _apply_sib_links(wp, links, arrs):
        """Padded ``wp`` with its ghost regions inside siblings overwritten
        by their fine data (``arrs``: node.index -> interior array)."""
        for (si, dst, src) in links:
            wp[(Ellipsis,) + dst] = arrs[si][(Ellipsis,) + src]
        return wp

    # -- set-up -----------------------------------------------------------
    def _compile(self, fused, gather6=True):
        """Choose the stage path: the fused kernel per node (``fused``), its
        six-face halo (``gather6``) and the node batch where the gates pass.
        Re-run after every topology or position change."""
        self.fused = fused
        self.gather6 = gather6
        self._fused = self._fused_setup() if fused and self._fused_ok else None
        self._sib_links = self._sibling_links()
        self._masks = [self._cover_mask(node) for node in self.nodes]
        self._gather6 = self._gather6_setup() if gather6 else None
        self._batched = (self._gather6 is not None
                         and curv_mod.gather6_batch_ok(self._fused))

    def _fused_setup(self):
        """Per-node CurvStages of the fused stage, or None when a node, a
        source or the config falls outside the kernel: Cartesian nodes, gas
        alone without N-body coupling (the rim deltas recompute the
        coarse-fine fluxes with the uniform stencils, artemis_tpu/amr.py:
        1097-1105), sources the kernel folds (a non-shearing rotating
        frame, one central point mass) and diffusion with separable rows,
        as the single-level driver gates it."""
        if self.dust_cfg is not None or self.nbody is not None \
                or any(node.curv for node in self.nodes):
            return None
        stages = []
        for node in self.nodes:
            if node.curv_stage is not None:
                stages.append(node.curv_stage)
                continue
            if not curv_mod.supported_curv(node.grid, self.cfg):
                return None
            flux_srcs = [s for s in node.sources if getattr(s, "uses_fluxes", False)]
            if not all(isinstance(s, RotatingFrame) and not s.shearing_box
                       for s in flux_srcs):
                return None
            rest = [s for s in node.sources if s not in flux_srcs]
            gravity = gmode = None
            for s in rest:
                gmode = curv_point_grav(node.grid, s)
                if gmode is not None:
                    gravity = s
                    rest.remove(s)
                    break
            if rest:
                return None
            try:
                node.curv_stage = curv_mod.CurvStage(
                    node.hydro, omf=self.omf, rotating=flux_srcs[0] if flux_srcs else None,
                    gravity=gravity, gmode=gmode, diffusion=node.diffusion,
                    bc_custom=self.bc_custom if node.parent is None else {})
            except ValueError:
                return None
            stages.append(node.curv_stage)
        return stages

    def _gather6_setup(self):
        """The root's six static ic strips when every node fits the six-face
        halo (all-ic root with value caches; 3-D patches without wrap axes,
        two parent rows outside every coarse-fine face so the rim windows
        never touch the parent's ghosts), else None (padded halos).  A
        moving tree keeps padded halos: a move would break the margins."""
        if self._fused is None or self.moving_patches or not self.root.children:
            return None
        root = self.root
        if not curv_mod.gather6_supported(root.grid) or any(
                root.grid.bc[d] != ("ic", "ic") for d in range(3)):
            return None
        caches = getattr(self.bc_custom.get("ic"), "shard_caches", None)
        if not caches or not all((d, s) in caches[0] for d in (1, 2, 3) for s in (0, 1)):
            return None
        for node in self.nodes[1:]:
            if any(node.wrap) or not all(node.active) \
                    or not curv_mod.gather6_supported(node.grid):
                return None
            pnx = node.parent.grid.nx
            if any(node.lo[d] < 2 or node.lo[d] + node.n[d] > pnx[d] - 2 for d in range(3)):
                return None
        if self._g6_root_strips is None:
            strips = curv_mod.prepare_gather6_root_strips(root.grid, caches[0])
            self._g6_root_strips = {
                k: torch.as_tensor(np.asarray(v), dtype=self.dtype, device=self.device)
                for k, v in strips.items()}
        return self._g6_root_strips

    @property
    def stage_kernel(self) -> str:
        """Which stage path the tree takes."""
        if self._fused is None:
            if (self.fused and self.device.type == "cuda"
                    and sweeps.sweep_supported(self.root.grid, self.cfg, self.dtype)):
                return "sweep"
            return "none"
        if self._batched:
            return f"stage_curv_batched ({len(self.nodes)} nodes, gather6)"
        return f"stage_curv per node ({'gather6' if self._gather6 else 'padded'})"

    # -- the fused stage and its glue --------------------------------------
    def _rim_apply(self, u_p, node, d, side, fi_c, dF, bdt, base=None):
        """Add a pooled fine-minus-coarse face-flux delta ``dF`` to the two
        parent cell rows beside face (d, side) of ``node``: the row below
        sees the plane as its upper face (-A dF bdt/V), the row above as its
        lower face.  ``base``: [z, y, x] start of the parent block ``u_p``
        holds (the block-framed glue), else u_p is the whole parent.  In
        place on u_p (a fresh output of this stage)."""
        hc = node.parent.hydro
        lo = node.lo
        fst, fsz, cst, csz = [], [], [], []
        for dd in (3, 2, 1):
            if dd == d:
                fst.append(fi_c)
                fsz.append(1)
                cst.append(fi_c - 1)
                csz.append(2)
            elif node.active[dd - 1]:
                fst += [lo[dd - 1]]
                fsz += [node.n[dd - 1]]
                cst += [lo[dd - 1]]
                csz += [node.n[dd - 1]]
            else:
                fst += [0]
                fsz += [1]
                cst += [0]
                csz += [1]
        scale = bdt * hc.area[d][_zyx(fst, fsz)] / hc.vol[_zyx(cst, csz)]
        du = torch.cat([-dF, dF], dim=-d) * scale
        if base is not None:
            cst = [c - b for c, b in zip(cst, base)]
        sl = _zyx(cst, csz)
        u_p[sl] = u_p[sl] + du
        return u_p

    def _padded_rim_deltas(self, wpads, force_pcm):
        """The conservation fix-ups of a fused update from padded prims:
        for every coarse-fine face plane of every patch, the pooled fine
        flux minus the parent's own, as {parent index: [(node, d, side,
        face, dF), ...]} in child and face order.  The windows of the whole
        tree go through one canonical batched flux chain per window shape
        (they read only the stage-entry prims)."""
        wins = []
        for node in self.nodes[1:]:
            pnode = node.parent
            for d in pnode.hydro.dims:
                if node.wrap[d - 1]:
                    continue
                for side in (0, 1):
                    fi_c = node.lo[d - 1] + side * node.n[d - 1]
                    wins.append((node, d, side, fi_c,
                                 _slab_window(wpads[pnode.index], pnode.grid, d, fi_c, node.lo,
                                              node.n),
                                 _slab_window(wpads[node.index], node.grid, d,
                                              side * 2 * node.n[d - 1], (0, 0, 0),
                                              node.grid.nx)))
        canon = [(d, _rim_canon(w, d)) for (_, d, _, _, wc, wf) in wins for w in (wc, wf)]
        fluxes = _rim_batched_flux(canon, self.cfg, force_pcm)
        deltas = {}
        for k, (node, d, side, fi_c, _, _) in enumerate(wins):
            dF = _restrict_face_mean(fluxes[2 * k + 1], d, node.active) - fluxes[2 * k]
            deltas.setdefault(node.parent.index, []).append((node, d, side, fi_c, dF))
        return deltas

    def _apply_rim_delta_g6(self, u_p, node, w_par, w_fine, slabs, bdt, force_pcm,
                            base=None):
        """The rim deltas of one child without padded arrays: the
        parent-side 4-row window comes from the parent's interior (two
        interior rows outside every face, by the six-face gate), the fine
        side is the patch's edge rows beside its prolonged ghost slab: the
        values the padded arrays held.  Every window goes through one
        canonical batched flux chain."""
        lo, n = node.lo, node.n
        wins = []
        for d in node.parent.hydro.dims:
            ax = w_par.ndim - d
            for side in (0, 1):
                fi_c = lo[d - 1] + side * n[d - 1]
                starts, sizes = [], []
                for dd in (3, 2, 1):
                    if dd == d:
                        starts.append(fi_c - 2)
                        sizes.append(4)
                    elif node.active[dd - 1]:
                        starts.append(lo[dd - 1])
                        sizes.append(n[dd - 1])
                    else:
                        starts.append(0)
                        sizes.append(1)
                win_c = w_par[_zyx(starts, sizes)]
                sint = slabs[(d, side)]
                for c in (1, 2, 3):
                    if c != d:
                        g = node.grid.ng[c - 1]
                        sint = sint.narrow(sint.ndim - c, g, node.grid.nx[c - 1])
                nfx = node.grid.nx[d - 1]
                if side == 0:
                    win_f = torch.cat([sint, w_fine.narrow(ax, 0, 2)], dim=ax)
                else:
                    win_f = torch.cat([w_fine.narrow(ax, nfx - 2, 2), sint], dim=ax)
                wins.append((d, side, fi_c, win_c, win_f))
        canon = [(d, _rim_canon(w, d)) for (d, _, _, wc, wf) in wins for w in (wc, wf)]
        fluxes = _rim_batched_flux(canon, self.cfg, force_pcm)
        for k, (d, side, fi_c, _, _) in enumerate(wins):
            dF = _restrict_face_mean(fluxes[2 * k + 1], d, node.active) - fluxes[2 * k]
            u_p = self._rim_apply(u_p, node, d, side, fi_c, dF, bdt, base=base)
        return u_p

    def _stage_fused(self, states, u1s, dt, time, stage):
        """One RK stage on the fused stage kernel: every node's gas stage in
        one pass (one node-batched launch where the batch gate passes), then
        coarse-fine conservation as rim deltas and restriction."""
        integ = self.integ
        gam0, gam1, beta = integ.gam0[stage - 1], integ.gam1[stage - 1], integ.beta[stage - 1]
        bdt = beta * dt
        force_pcm = integ.name == "vl2" and stage == 1
        g6 = self._gather6
        nn = len(self.nodes)
        wpads, strips, slabs = [None] * nn, [None] * nn, [None] * nn
        ws = [st["gas"]["w"] for st in states]
        # ghosts, parents' stage-entry prims feeding the prolongation
        if g6 is None:
            wpads = self._padded_prims(ws)
        else:
            for node in self.nodes:
                i = node.index
                if node.parent is None:
                    strips[i] = g6
                else:
                    strips[i], slabs[i] = node.ghost_strips(
                        ws[node.parent.index], node.lo, sib_links=self._sib_links[i],
                        sib_arrs=ws)
        dt1 = dt.reshape(1)
        u0s = [st["gas"]["u"] for st in states]
        u1l = [u1["gas"] for u1 in u1s]
        if self._batched:
            outs = curv_mod.stage_curv_batched(self._fused, ws, u0s, u1l, strips, gam0, gam1,
                                               beta, dt1, time, force_pcm)
        else:
            outs = [curv_mod.stage_curv(cs, ws[i], u0s[i], u1l[i], gam0, gam1, beta, dt1, time,
                                        force_pcm, strips=strips[i], w_pad=wpads[i])
                    for i, cs in enumerate(self._fused)]
        new_states = []
        for st, (u, w, _) in zip(states, outs):
            nst = {"gas": {"u": u, "w": w}}
            if "rad" in st:
                nst["rad"] = st["rad"]
            new_states.append(nst)
        return self._stage_fused_glue(states, new_states, wpads, slabs, bdt, force_pcm,
                                      final=stage == integ.nstages)

    def _restrict_band_into(self, child, u_p, u_f, lo):
        """Intermediate-stage restriction: only the parent band ``ng`` deep
        inside each coarse-fine face (every stencil of the next stage that
        reads covered parent cells reads at most ng rows, so this equals the
        full restriction wherever the next stage looks).  In place on u_p."""
        pg = child.parent.grid
        for d in range(3):
            if not child.active[d] or child.wrap[d]:
                continue
            depth = min(pg.ng[d], child.n[d])
            ax = u_f.ndim - 1 - d
            for side in (0, 1):
                f0 = 0 if side == 0 else 2 * (child.n[d] - depth)
                p_start = lo[d] if side == 0 else lo[d] + child.n[d] - depth
                res = restrict_average(u_f.narrow(ax, f0, 2 * depth), child.active)
                starts = [p_start if dd == d else (lo[dd] if child.active[dd] else 0)
                          for dd in (2, 1, 0)]
                u_p[_zyx(starts, res.shape[-3:])] = res
        return u_p

    @staticmethod
    def _deposit(arr, res, lo):
        """Deposit the restricted child array ``res`` into ``arr`` at ``lo``
        (in place; ``arr`` is a fresh output of this stage)."""
        arr[_zyx([lo[2], lo[1], lo[0]], res.shape[-3:])] = res
        return arr

    def _stage_fused_glue(self, states, new_states, wpads, slabs, bdt, force_pcm, final):
        """Rim deltas, the dual-energy switch, restriction and the C2P/P2C
        re-sync on each parent, deepest parents first, on the child's
        bounding block only (the kernel already synced everything else).
        The root takes the block-framed path when its children's blocks are
        disjoint; restriction covers only the ng-deep band on intermediate
        stages and the whole footprint on the last."""
        g6 = self._gather6
        deltas = self._padded_rim_deltas(wpads, force_pcm) if g6 is None else None
        blocked = set()
        for pnode in [nd for nd in reversed(self.nodes) if nd.children]:
            if g6 is not None and pnode.parent is None and self._blocks_disjoint(pnode):
                self._glue_parent_block(pnode, states, new_states, slabs, bdt, force_pcm,
                                        final)
                blocked.add(pnode.index)
                continue
            p = pnode.index
            u_p = new_states[p]["gas"]["u"]
            if g6 is None:
                for (node, d, side, fi_c, dF) in deltas[p]:
                    u_p = self._rim_apply(u_p, node, d, side, fi_c, dF, bdt)
            else:
                for child in pnode.children:
                    ci = child.index
                    u_p = self._apply_rim_delta_g6(u_p, child, states[p]["gas"]["w"],
                                                   states[ci]["gas"]["w"], slabs[ci], bdt,
                                                   force_pcm)
            for child in pnode.children:
                u_p = self._block_set_auxiliary(u_p, child)
            for child in pnode.children:
                u_f = new_states[child.index]["gas"]["u"]
                if final:
                    u_p = self._deposit(u_p, restrict_average(u_f, child.active), child.lo)
                else:
                    u_p = self._restrict_band_into(child, u_p, u_f, child.lo)
            new_states[p]["gas"]["u"] = u_p
        for node in self.nodes:
            if not node.children or node.index in blocked:
                continue
            g = new_states[node.index]["gas"]
            u_full, w_full = g["u"], g["w"]
            for child in node.children:
                u_full, w_full = self._block_resync(u_full, w_full, child)
            new_states[node.index]["gas"] = {"u": u_full, "w": w_full}
        return new_states

    @staticmethod
    def _child_block(child):
        """[z, y, x] starts and sizes of the parent block a child's fix-ups
        touch: its footprint and one rim row outside each coarse-fine face
        (a wrap axis covers the whole parent axis)."""
        pnx = child.parent.grid.nx
        starts, sizes = [], []
        for d in (2, 1, 0):
            if not child.active[d]:
                starts.append(0)
                sizes.append(1)
            elif child.wrap[d]:
                starts.append(0)
                sizes.append(pnx[d])
            else:
                starts.append(child.lo[d] - 1)
                sizes.append(child.n[d] + 2)
        return starts, sizes

    def _blocks_disjoint(self, pnode):
        """Are the children's bounding blocks pairwise disjoint?  (Then the
        block-framed glue composes per child as the phase-ordered one does.)"""
        bs = []
        for ch in pnode.children:
            s, z = self._child_block(ch)
            bs.append([(a, a + b) for a, b in zip(s, z)])
        return not any(all(bs[a][t][0] < bs[b][t][1] and bs[b][t][0] < bs[a][t][1]
                           for t in range(3))
                       for a in range(len(bs)) for b in range(a + 1, len(bs)))

    def _glue_parent_block(self, pnode, states, new_states, slabs, bdt, force_pcm, final):
        """Block-framed glue: per child, rim deltas + dual-energy switch +
        restriction + C2P/P2C on one copy of its bounding block, written
        back once into the parent's fresh u and w.  The same operations in
        the same order per child as the phase-ordered glue (the blocks are
        disjoint)."""
        p = pnode.index
        u_p = new_states[p]["gas"]["u"]
        w_p = new_states[p]["gas"]["w"]
        for child in pnode.children:
            ci = child.index
            base, z3 = self._child_block(child)
            lo_reb = tuple(child.lo[d] - base[2 - d] if child.active[d] else 0
                           for d in range(3))
            sl = _zyx(base, z3)
            B = u_p[sl].clone()
            B = self._apply_rim_delta_g6(B, child, states[p]["gas"]["w"], states[ci]["gas"]["w"],
                                         slabs[ci], bdt, force_pcm, base=base)
            B = self._aux_switch_math(B)
            u_f = new_states[ci]["gas"]["u"]
            if final:
                B = self._deposit(B, restrict_average(u_f, child.active), lo_reb)
            else:
                B = self._restrict_band_into(child, B, u_f, lo_reb)
            u_p[sl], w_p[sl] = self._resync_math(B)
        new_states[p]["gas"] = {"u": u_p, "w": w_p}

    def _aux_switch_math(self, ub):
        """Dual-energy switch (Hydro.set_auxiliary with h = 1) on a block."""
        cfg = self.cfg
        rho = torch.clamp_min(ub[:, 0], cfg.dfloor)
        ke = 0.5 * (ub[:, 1] ** 2 + ub[:, 2] ** 2 + ub[:, 3] ** 2) / rho
        e_tot = ub[:, 4]
        ue = e_tot - ke
        sie = torch.where(ue > cfg.de_switch * e_tot, ue / rho, ub[:, 5] / rho)
        sie = torch.clamp_min(sie, cfg.siefloor)
        out = ub.clone()
        out[:, 5] = torch.maximum(sie * rho, cfg.siefloor * rho)
        return out

    def _resync_math(self, ub):
        """C2P + P2C with floors (h = 1) on a block: (u, w)."""
        cfg = self.cfg
        rho = torch.clamp_min(ub[:, 0], cfg.dfloor)
        v1, v2, v3 = ub[:, 1] / rho, ub[:, 2] / rho, ub[:, 3] / rho
        sie = torch.clamp_min(ub[:, 5] / rho, cfg.siefloor)
        p = (cfg.gamma - 1.0) * rho * sie
        eint = sie * rho
        etot = eint + 0.5 * rho * (v1 * v1 + v2 * v2 + v3 * v3)
        return (torch.stack([rho, rho * v1, rho * v2, rho * v3, etot, eint], dim=1),
                torch.stack([rho, v1, v2, v3, p, sie], dim=1))

    def _block_set_auxiliary(self, u_p, child):
        """Dual-energy switch on the child's bounding block (in place)."""
        sl = _zyx(*self._child_block(child))
        u_p[sl] = self._aux_switch_math(u_p[sl])
        return u_p

    def _block_resync(self, u_full, w_full, child):
        """C2P + P2C on the child's bounding block (in place)."""
        sl = _zyx(*self._child_block(child))
        u_full[sl], w_full[sl] = self._resync_math(u_full[sl])
        return u_full, w_full

    # -- the composable stage ---------------------------------------------
    def _cover_mask(self, node: _Node):
        """Interior [z, y, x] mask: 0 under the node's children, 1 elsewhere
        (level reductions must not count covered cells twice)."""
        if not node.children:
            return None
        mask = torch.ones(tuple(reversed(node.grid.nx)), dtype=self.dtype, device=self.device)
        for ch in node.children:
            mask[_zyx([ch.lo[d] if node.grid.nx[d] > 1 else 0 for d in (2, 1, 0)],
                      [ch.n[d] if node.grid.nx[d] > 1 else 1 for d in (2, 1, 0)])] = 0.0
        return mask

    def _stage(self, states, u1s, dt, time, stage, particles=None):
        """One RK stage over the tree (the fused path where set up), every
        fluid of every node.  ``particles``: the N-body particles on the
        device (or None).  Returns (states, pforce): the back-reaction rows
        summed over the levels, or None without N-body gravity."""
        if self._fused is not None:
            return self._stage_fused(states, u1s, dt, time, stage), None
        integ = self.integ
        gam0, gam1 = integ.gam0[stage - 1], integ.gam1[stage - 1]
        bdt = integ.beta[stage - 1] * dt
        force_pcm = integ.name == "vl2" and stage == 1
        fluids = self.root.fluids()
        # 1. ghosts (parents' stage-entry prims feed the prolongation)
        wpads = {fl: self._padded_prims([st[fl]["w"] for st in states], fl) for fl, _ in fluids}
        # 2. fluxes (through the sweep kernel on a fused GPU tree, as the
        # single-level composable stage); 3. flux correction, deepest level
        # first
        kernel = self.fused and self.device.type == "cuda"
        fxs = [{fl: node.hydro.compute_fluxes(wpads[fl][node.index], cfg, force_pcm,
                                              kernel=kernel) for fl, cfg in fluids}
               for node in self.nodes]
        for node in reversed(self.nodes[1:]):
            p = node.parent.index
            for fl, _ in fluids:
                fxs[p][fl] = self._flux_correct(node, fxs[p][fl], fxs[node.index][fl], node.lo)
        # 4. update, diffusion and sources per node; the particles'
        # back-reaction summed over the levels, covered cells masked
        new_states = []
        pforce = None
        for node in self.nodes:
            i = node.index
            hyd = node.hydro
            st = {}
            for fl, _ in fluids:
                w = states[i][fl]["w"]
                u = hyd.apply_update(states[i][fl]["u"], u1s[i][fl], fxs[i][fl], gam0, gam1,
                                     bdt)
                u = hyd.flux_source(u, w, fxs[i][fl], bdt, omf=self.omf)
                if fl == "gas" and node.diffusion is not None:
                    u = node.diffusion.update(u, w, node.diffusion.fluxes(wpads[fl][i]), bdt)
                st[fl] = {"u": u, "w": w}
            if "rad" in states[i]:
                st["rad"] = states[i]["rad"]
            ctx = {"particles": particles, "mask": self._masks[i]}
            st = apply_sources(node.sources, st, fxs[i], time, bdt, hyd, ctx)
            if "pforce" in ctx:
                pf = self._node_pforce(node, ctx["pforce"])
                pforce = pf if pforce is None else pforce + pf
            if "gas" in st:
                st["gas"]["u"] = hyd.set_auxiliary(st["gas"]["u"], self.cfg)
            new_states.append(st)
        # 5. restriction, deepest level first
        for node in reversed(self.nodes[1:]):
            for fl, _ in fluids:
                self._restrict_into(node, new_states[node.parent.index][fl]["u"], restrict_average(
                    new_states[node.index][fl]["u"], node.active, node.volf), node.lo)
        # 6. prims re-synced per node
        out = []
        for node, st in zip(self.nodes, new_states):
            nst = {}
            for fl, cfg in fluids:
                u, w = node.hydro.prim_to_cons(node.hydro.cons_to_prim(st[fl]["u"], cfg), cfg)
                nst[fl] = {"u": u, "w": w}
            if "rad" in st:
                nst["rad"] = st["rad"]
            out.append(nst)
        return out, pforce

    # -- radiation over levels ----------------------------------------------
    # a tree whose same-shape patches may solve as one batched system (a
    # shard's tree solves node by node, as the JAX tree does under sharding)
    _batch_radiation = True

    def _radiation_pass(self, states, dt, *, _sequential=False):
        """Operator-split radiation after the stages, level by level:
        parents solve first, each patch against Dirichlet ghost planes
        prolonged from its parent's new field (siblings' fine fields from
        before any solve), then the fine Er and gas energies restrict back
        and the parents re-sync.  At each level the patches of one shape
        (the grid, the state's fields, the ghost planes' shapes and the
        Radiation's ``batch_key``), Cartesian and with no wrap axis, solve
        as one system over a node axis where there are two or more
        (``Radiation.step_batched``): the JAX tree's default pass, its
        ``vmap`` over each group (``artemis_tpu/amr.py:1939-1984``).  The
        others solve one by one.  ``_sequential``: solve every node one by
        one (the comparison of the tests and chip_smoke.py)."""
        states = list(states)
        sib_Er = [s["rad"]["Er"] for s in states]
        batch = self._batch_radiation and not _sequential
        for lev in sorted({n.level for n in self.nodes}):
            nodes = [n for n in self.nodes if n.level == lev]
            # the parents' new fields, in each patch's frame
            pEr = self._parent_arrs([s["rad"]["Er"] for s in states], nodes)
            groups = {}
            for node in nodes:
                i = node.index
                gh = None if node.parent is None else self._rad_ghost_planes(node, pEr[i], sib_Er)
                if gh is None or not batch or node.curv or any(node.wrap):
                    states[i] = self._rad_solve(node, dict(states[i]), dt, gh)
                    continue
                key = (tuple(node.grid.nx),
                       tuple((f, tuple(sorted(v))) for f, v in sorted(states[i].items())),
                       tuple((d, tuple(lo.shape), tuple(hi.shape))
                             for d, (lo, hi) in sorted(gh.items())),
                       node.radiation.batch_key())
                groups.setdefault(key, []).append((node, gh))
            for members in groups.values():
                if len(members) == 1:
                    node, gh = members[0]
                    states[node.index] = self._rad_solve(node, dict(states[node.index]), dt, gh)
                    continue
                rads = [node.radiation for node, _ in members]
                outs = rads[0].step_batched(rads, [states[node.index] for node, _ in members],
                                            dt, [gh for _, gh in members])
                for (node, _), st in zip(members, outs):
                    states[node.index] = node.radiation.sync_gas(st)
        for node in reversed(self.nodes[1:]):
            p = node.parent.index
            pst = dict(states[p])
            fine = states[node.index]
            u_p = pst["gas"]["u"].clone()
            self._restrict_into(node, u_p[:, 4:6], restrict_average(
                fine["gas"]["u"][:, 4:6], node.active, node.volf), node.lo)
            pst["gas"] = {"u": u_p, "w": pst["gas"]["w"]}
            pst["rad"] = {"Er": self._restrict_into(
                node, pst["rad"]["Er"].clone(),
                restrict_average(fine["rad"]["Er"], node.active, node.volf), node.lo)}
            states[p] = pst
        return [node.radiation.sync_gas(st) if node.children else st
                for node, st in zip(self.nodes, states)]

    def _rad_ghost_planes(self, node, Erp, sib_Er):
        """Per-face Dirichlet ghost planes of a patch's FLD solve: the
        innermost prolonged ghost row of each face slab (sibling fine values
        folded in) over the interior transverse window.  Wrap axes take the
        padded build's planes."""
        fgrid = node.grid
        links = self._sib_links[node.index]
        if any(node.wrap):
            Er_pad = self._apply_sib_links(
                node.fill_fine_ghosts(sib_Er[node.index], Erp, node.lo), links, sib_Er)
        gh = {}
        for d in (1, 2, 3):
            dd = d - 1
            if fgrid.nx[dd] <= 1:
                continue
            ngd = fgrid.ng[dd]
            if any(node.wrap):
                s0 = Er_pad.narrow(Er_pad.ndim - d, 0, ngd)
                s1 = Er_pad.narrow(Er_pad.ndim - d, ngd + fgrid.nx[dd], ngd)
            else:
                s0, s1 = node._prolong_ghost_slab_pair(Erp, dd, node.lo)
                if links:
                    s0 = node._fold_sib_into_slab(s0, dd, 0, links, sib_Er)
                    s1 = node._fold_sib_into_slab(s1, dd, 1, links, sib_Er)
            planes = []
            for s, row in ((s0, ngd - 1), (s1, 0)):
                s = s.narrow(s.ndim - d, row, 1)
                for c in (1, 2, 3):
                    if c != d and fgrid.nx[c - 1] > 1:
                        s = s.narrow(s.ndim - c, fgrid.ng[c - 1], fgrid.nx[c - 1])
                planes.append(s)
            gh[d] = tuple(planes)
        return gh

    # -- the step -------------------------------------------------------------
    def _stage_inputs(self, states):
        """Each node's u at the start of a cycle (the RK scheme's u1)."""
        return [{fl: st[fl]["u"] for fl in st if fl != "rad"} for st in states]

    def step(self, states, dt: float, time: float):
        """One cycle of every RK stage over the tree with the host ``dt``
        from the host ``time``, then the radiation pass.  With the run's
        N-body system the particles advance on the host between the stages
        from the force rows summed over the levels (NBody::Advance,
        nbody_advance.cpp:85-208)."""
        nbody = self.nbody
        dt_t = torch.full((), dt, dtype=self.dtype, device=self.device)
        u1s = self._stage_inputs(states)
        nstages = self.integ.nstages
        if nbody is not None:
            coeffs = nbody_coeffs(self.integ, float(dt))
            nbody.begin_step()
        for stage in range(1, nstages + 1):
            parts = None if nbody is None else nbody.particle_pytree(self.device, self.dtype)
            with span("stage"):
                states, pforce = self._stage(states, u1s, dt_t, time, stage, parts)
            if nbody is not None:
                pf = (host_read(pforce, "nbody_force").astype(np.float64)
                      if pforce is not None else np.zeros((nbody.npart, 7)))
                nbody.advance(pf, stage, nstages, float(time), coeffs)
        if self.radiation_factory is not None:
            with span("radiation"):
                states = self._radiation_pass(states, dt_t)
        return states

    def estimate_dt(self, states):
        """The global CFL dt over every node and fluid (a 0-d tensor): each
        advective limit, the gas's diffusive one and the radiation dt
        cap."""
        dts = []
        for node, st in zip(self.nodes, states):
            for fl, cfg in node.fluids():
                w = st[fl]["w"]
                dt = node.hydro.estimate_dt(w, cfg)
                if fl == "gas" and node.diffusion is not None:
                    dt = torch.minimum(dt, cfg.cfl * node.diffusion.estimate_dt(w))
                if fl == "gas" and node.radiation is not None:
                    dt = torch.clamp_max(dt, node.radiation.cfg.dt_rad)
                dts.append(dt)
        return torch.min(torch.stack(dts))

    def initialize(self, prims_per_node):
        """Node states from ``prims_per_node`` (topological order; per node
        {fluid: interior prims}, a bare array for the gas, or None to
        prolong the parent's), with P2C and, with radiation, Er = a T^4."""
        states = []
        for node in self.nodes:
            pr = prims_per_node[node.index]
            if pr is not None and not isinstance(pr, dict):
                pr = {"gas": pr}
            st = {}
            for fl, cfg in node.fluids():
                if pr is not None and pr.get(fl) is not None:
                    w = pr[fl]
                    w = torch.as_tensor(w if torch.is_tensor(w) else np.asarray(w)).to(
                        device=self.device, dtype=self.dtype)
                else:
                    wp = states[node.parent.index][fl]["w"]
                    w = prolong_minmod(wp[_zyx([node.lo[d] if node.active[d] else 0
                                                for d in (2, 1, 0)],
                                               [node.n[d] if node.active[d] else 1
                                                for d in (2, 1, 0)])], node.active,
                                       node.interior_spacings())
                u, w = node.hydro.prim_to_cons(w, cfg)
                st[fl] = {"u": u, "w": w}
            if node.radiation is not None:
                from .radiation import initialize_radiation

                st["rad"] = {"Er": initialize_radiation(st, self.cfg, node.radiation.cfg)["Er"]}
            states.append(st)
        return states

    # -- move-style retagging ---------------------------------------------------
    def retag_criteria(self, states, criterion):
        """Re-centre each patch on the refinement-tagged cells of its parent
        (ScalarFirstDerivative / ScalarMagnitude, amr_criteria.hpp; keys per
        gas.cpp:304-383)."""
        def tags_fn(node, wc):
            refine, _ = self._criterion_tags(wc, node.parent.grid, criterion)
            return host_read(refine.any(dim=0), "regrid_tags")

        return self._retag(states, tags_fn)

    def retag_user(self, states, fn):
        """Re-centre patches on a problem-defined criterion (<artemis>
        amr_user): ``fn(w_gas, grid) -> bool refine mask`` over the parent
        grid's interior cells."""
        return self._retag(states, lambda node, wc: _host_mask(fn(wc, node.parent.grid)))

    def _retag(self, states, tags_fn):
        """Move each patch so that its window centres on the bounding box of
        its parent's tagged cells, clamped inside the nesting rim; a moved
        patch is prolonged afresh from its parent."""
        if self._gather6 is not None:
            raise ValueError("adaptive patch moves on a six-face fused tree: construct "
                             "MultiLevelSMR with moving_patches=True")
        states = list(states)
        moved = False
        for node in self.nodes:
            if node.parent is None:
                continue
            tags = tags_fn(node, states[node.parent.index]["gas"]["w"])
            if not tags.any():
                continue
            idx = np.nonzero(tags)
            new_lo = list(node.lo)
            pg = node.parent.grid
            for d in (1, 2, 3):
                if pg.nx[d - 1] <= 1 or node.wrap[d - 1]:
                    continue
                ax = 3 - d
                c0, c1 = int(idx[ax].min()), int(idx[ax].max())
                want = (c0 + c1 + 1 - node.n[d - 1]) // 2
                hi = pg.nx[d - 1] - node.n[d - 1] - node.rim[d - 1]
                new_lo[d - 1] = int(np.clip(want, node.rim[d - 1], hi))
            if tuple(new_lo) == node.lo:
                continue
            states = self._move_patch(states, node, new_lo)
            moved = True
        if moved:
            self._compile(self.fused, self.gather6)
        return states

    def retag_particles(self, states, particle_nodes, positions):
        """Re-centre each particle-tracking patch on its particle's parent
        cell (refine_distance, nbody.cpp:276-312), clamped inside the
        nesting rim.  ``particle_nodes``: {node index: particle index};
        ``positions``: [npart, 3] Cartesian, relative to the frame."""
        states = list(states)
        moved = False
        for node in self.nodes:
            if node.index not in particle_nodes:
                continue
            pg = node.parent.grid
            want = self._cell_of(pg, positions[particle_nodes[node.index]])
            if want is None:
                continue
            new_lo = list(node.lo)
            for d in range(3):
                if pg.nx[d] <= 1 or node.wrap[d]:
                    continue
                hi = pg.nx[d] - node.n[d] - node.rim[d]
                new_lo[d] = int(np.clip(want[d] - node.n[d] // 2, node.rim[d], hi))
            if tuple(new_lo) != node.lo:
                states = self._move_patch(states, node, new_lo)
                moved = True
        if moved:
            self._compile(self.fused, self.gather6)
        return states

    @staticmethod
    def _cell_of(grid, pos_cart):
        """The interior cell [x1, x2, x3] of ``grid`` holding a Cartesian
        position, or None in coordinates it cannot invert."""
        x, y, z = float(pos_cart[0]), float(pos_cart[1]), float(pos_cart[2])
        c = grid.coords
        if geo.is_cartesian(c):
            nat = (x, y, z)
        elif c == "cylindrical":
            nat = (math.hypot(x, y), math.atan2(y, x), z)
        elif c == "axisymmetric":
            nat = (math.hypot(x, y), z, math.atan2(y, x))
        elif geo.is_spherical(c):
            r = math.sqrt(x * x + y * y + z * z)
            nat = (r, math.acos(z / r) if r > 0 else 0.0, math.atan2(y, x))
        else:
            return None
        out = []
        for d in range(3):
            if grid.nx[d] <= 1:
                out.append(0)
                continue
            frac = (nat[d] - grid.xmin[d]) / (grid.xmax[d] - grid.xmin[d])
            out.append(int(np.clip(frac * grid.nx[d], 0, grid.nx[d] - 1)))
        return out

    def _fresh_patch_state(self, parent_state, node: _Node, lo):
        """A node's state prolonged from its parent's current prims at window
        ``lo`` (a spawn, or a move), every fluid, with the centroid weights
        of a curvilinear patch.  A full-span periodic axis is padded by one
        wrapped parent cell on each side so the slopes see the seam, and
        cropped back after."""
        st = {}
        for fl, cfg in node.fluids():
            wp = parent_state[fl]["w"]
            starts, sizes, wrap_axes = [], [], []
            for d in (2, 1, 0):
                ax = wp.ndim - 1 - d
                if not node.active[d]:
                    starts.append(0)
                    sizes.append(1)
                elif node.wrap[d]:
                    starts.append(0)
                    sizes.append(wp.shape[ax])
                    wrap_axes.append(ax)
                else:
                    starts.append(lo[d])
                    sizes.append(node.n[d])
            reg = wp[_zyx(starts, sizes)]
            for ax in wrap_axes:
                n = reg.shape[ax]
                reg = torch.cat([reg.narrow(ax, n - 1, 1), reg, reg.narrow(ax, 0, 1)], dim=ax)
            wf = prolong_minmod(reg, node.active, node.interior_spacings())
            for ax in wrap_axes:
                wf = wf.narrow(ax, 2, wf.shape[ax] - 4)
            u, w = node.hydro.prim_to_cons(wf, cfg)
            st[fl] = {"u": u, "w": w}
        if node.radiation is not None:
            from .radiation import initialize_radiation

            st["rad"] = {"Er": initialize_radiation(st, self.cfg, node.radiation.cfg)["Er"]}
        return st

    def _move_patch(self, states, node: _Node, new_lo):
        """Move a leaf patch: restriction already deposited its data on the
        parent, so a move is a fresh prolongation at the new window.  A
        Cartesian patch keeps its grid (translation-invariant); only its
        ``lo`` moves; a curvilinear one is rebuilt there.  The caller
        re-runs the set-up once per pass."""
        if node.children:
            raise ValueError("cannot move a patch that has children")
        self._place_node(node, new_lo)
        states[node.index] = self._fresh_patch_state(states[node.parent.index], node, node.lo)
        return states

    # -- tag-driven spawn/destroy (Parthenon Refinement::Tag ->
    #    create/destroy MeshBlocks; artemis_driver.cpp:292) -------------------
    def remove_patch(self, node: _Node):
        """Drop a leaf patch.  Its fine data needs no deposit: every step
        already restricts it into the parent.  The caller re-runs the
        set-up."""
        if node.children:
            raise ValueError("cannot remove a patch that has children")
        node.parent.children.remove(node)
        self.nodes.remove(node)
        for i, nd in enumerate(self.nodes):
            nd.index = i

    @staticmethod
    def _criterion_tags(w, g, criterion):
        """(refine, derefine) per-species tags of the <gas> criterion on the
        interior prims ``w`` of grid ``g``, on w's device."""
        field = w[:, 0] if criterion.get("field", "density") == "density" else w[:, 4]
        deref_thr = criterion.get("deref_thr", 0.0)
        if criterion.get("type", "gradient") == "gradient":
            dims = [d for d in (1, 2, 3) if g.nx[d - 1] > 1]
            return ref_mod.scalar_first_derivative(
                field, ref_mod.grid_stencil_widths(g), dims, criterion["refine_thr"],
                deref_thr, bc=g.bc)
        return ref_mod.scalar_magnitude(field, criterion["refine_thr"], deref_thr)

    @staticmethod
    def _dilate(tags, nbuf):
        """``nbuf`` passes of a one-cell cross dilation along each active
        axis, no wrap."""
        for _ in range(max(0, nbuf)):
            out = tags
            for ax in range(3):
                n = tags.shape[ax]
                if n <= 1:
                    continue
                zero = torch.zeros_like(tags.narrow(ax, 0, 1))
                out = (out | torch.cat([tags.narrow(ax, 1, n - 1), zero], dim=ax)
                       | torch.cat([zero, tags.narrow(ax, 0, n - 1)], dim=ax))
            tags = out
        return tags

    def tile_masks(self, w, g, criterion, tags_fn=None, nbuf=1):
        """(refine, derefine) bool masks [z, y, x] of a parent window on
        the device: the refine tags dilated by ``nbuf`` cells, and where
        every species may derefine; ``tags_fn`` (amr_user) replaces the
        criterion, and its untagged cells derefine."""
        if tags_fn is not None:
            tags = torch.as_tensor(_host_mask(tags_fn(w, g)), device=w.device)
            while tags.ndim > 3:            # species axis
                tags = tags.any(dim=0)
            tags = self._dilate(tags, nbuf)
            return tags, ~tags
        refine, deref = self._criterion_tags(w, g, criterion)
        return self._dilate(refine.any(dim=0), nbuf), deref.all(dim=0)

    def regrid_tiles(self, states, criterion, tile, nbuf=1, tags_fn=None, numlevel=2,
                     forced=None):
        """Tag-driven spawn/destroy over fixed tile lattices, down to
        ``numlevel - 1`` refinement levels (the JAX package's regrid_tiles).

        Each parent window (the root, then every surviving tile) is tiled by
        ``tile``-sized windows anchored at its nesting rim.  A window spawns
        a patch when the ``nbuf``-dilated refine tags touch it, keeps it
        while they persist, and drops it when every cell satisfies the
        derefinement criterion (deref_thr; without one coverage only grows).
        A tile with children is never dropped (they derefine first).
        Deeper tiles spawn only inside tiles that already carry state, so a
        feature reaches full depth over ``numlevel - 1`` passes.  Survivors
        keep their state objects; new patches prolong from their parent.
        ``tags_fn`` (amr_user) replaces the <gas> criterion; ``forced`` are
        static_refinement windows (dict(level, c0, c1) in level-(level-1)
        global cells) whose tiles spawn and are never dropped.  The tags
        are computed on the device; one bool copy per parent crosses to the
        host.  Returns the new node states."""
        states = list(states)

        def masks(g, w):
            """Host (refine, derefine) masks and the deref threshold."""
            if tags_fn is None and not criterion:
                shp = tuple(g.nx[::-1])
                return np.zeros(shp, bool), np.zeros(shp, bool), 0.0
            refine, deref = self.tile_masks(w, g, criterion, tags_fn, nbuf)
            both = host_read(torch.stack([refine, deref]), "regrid_tags")
            self.mask_bytes += both.nbytes
            return both[0], both[1], (1.0 if tags_fn is not None
                                      else criterion.get("deref_thr", 0.0))

        def decide(parent, w, strict):
            """(tile, nodes to drop, windows to spawn) for one parent, or
            None when the lattice does not fit (skipped unless ``strict``,
            the root)."""
            g = parent.grid
            nx = g.nx
            rims = [max(1, -(-g.ng[d] // 2)) + 1 if nx[d] > 1 else 0 for d in range(3)]
            t = tuple(tile[d] if nx[d] > 1 else 1 for d in range(3))
            lattice = []
            for d in range(3):
                if nx[d] <= 1:
                    lattice.append([0])
                    continue
                last = nx[d] - rims[d] - t[d]
                if last < rims[d]:
                    if strict:
                        raise ValueError(f"tile_nx{d + 1}={t[d]} does not fit the root "
                                         f"interior with the nesting rim ({rims[d]})")
                    return None
                lattice.append(list(range(rims[d], last + 1, t[d])))
            tags, deref_all, deref_thr = masks(g, w)

            def window(lo_):
                return tuple(slice(lo_[d], lo_[d] + t[d]) if nx[d] > 1 else slice(None)
                             for d in (2, 1, 0))

            # forced windows at this parent's level, against the parent's
            # origin in global parent-level cells
            forced_here = []
            if forced:
                og = [0, 0, 0]
                chain = []
                nd_ = parent
                while nd_.parent is not None:
                    chain.append(nd_.lo)
                    nd_ = nd_.parent
                for lo_p in reversed(chain):
                    og = [2 * (og[d] + lo_p[d]) for d in range(3)]
                forced_here = [(s["c0"], s["c1"], og) for s in forced
                               if s["level"] == parent.level + 1]

            def is_forced(lo_):
                return any(all(nx[d] <= 1 or (og[d] + lo_[d] < c1[d]
                                              and og[d] + lo_[d] + t[d] > c0[d])
                               for d in range(3))
                           for c0, c1, og in forced_here)

            wanted = {lo_ for lo_ in itertools.product(*lattice)
                      if is_forced(lo_) or bool(tags[window(lo_)].any())}
            current = {nd.lo: nd for nd in parent.children if nd.pool}
            final = set(wanted)
            for lo_, nd in current.items():
                if lo_ in final:
                    continue
                if nd.children:
                    final.add(lo_)          # its children derefine first
                    continue
                if deref_thr > 0.0 and bool(deref_all[window(lo_)].all()):
                    continue                # derefine: drop this tile
                final.add(lo_)              # keep until the tags clear
            drop = [nd for lo_, nd in current.items() if lo_ not in final]
            return t, drop, sorted(final - set(current))

        # one decision per parent, level by level: tiles spawned in this
        # pass carry no state yet and get their children at the next one
        t, drop, add = decide(self.root, states[0]["gas"]["w"], strict=True)
        to_remove = list(drop)
        to_add = [(self.root, lo_, t) for lo_ in add]
        dropped = set(drop)
        for lev in range(1, max(1, numlevel - 1)):
            for parent in [nd for nd in self.nodes
                           if nd.level == lev and nd.pool and nd not in dropped]:
                dec = decide(parent, states[parent.index]["gas"]["w"], strict=False)
                if dec is None:
                    continue
                t, drop, add = dec
                to_remove += drop
                dropped |= set(drop)
                to_add += [(parent, lo_, t) for lo_ in add]
        if not to_remove and not to_add:
            return states

        keep = {nd: states[nd.index] for nd in self.nodes}
        for nd in sorted(to_remove, key=lambda n: -n.level):    # children first
            self.remove_patch(nd)
        spawned = set()
        for parent, lo_, t in to_add:
            node = self.add_patch(parent.level + 1, lo_, t, parent=parent)
            node.pool = True
            spawned.add(node)
        self._compile(self.fused, self.gather6)
        new_states = [states[0]]
        for nd in self.nodes[1:]:
            new_states.append(self._fresh_patch_state(new_states[nd.parent.index], nd, nd.lo)
                              if nd in spawned else keep[nd])
        return new_states

    # bytes of tag masks copied to the host by regrid_tiles (a counter the
    # chip smoke test reads)
    mask_bytes = 0


class TwoLevelSMR:
    """The two-level, one-patch interface of the JAX package's adapter on a
    moving tree: ``run`` advances with the tree's CFL dt and, given a
    criterion, re-centres the patch every ``retag_interval`` cycles.
    States are (u, w) pairs per level; positions are host tuples."""

    def __init__(self, coarse_grid: Grid, integrator, gas_cfg: FluidCfg, patch_lo, patch_n, *,
                 device, dtype):
        self.ml = MultiLevelSMR(
            coarse_grid, integrator, gas_cfg, device=device, dtype=dtype,
            patches=[dict(level=1, lo=tuple(int(v) for v in patch_lo),
                          n=tuple(int(v) for v in patch_n))],
            moving_patches=True)
        self.cg = coarse_grid
        self.node = self.ml.nodes[1]
        self.patch_lo = self.node.lo
        self.curv = self.node.curv

    @property
    def fg(self):
        return self.node.grid

    def initialize(self, wc, wf):
        states = self.ml.initialize([wc, wf])
        return ((states[0]["gas"]["u"], states[0]["gas"]["w"]),
                (states[1]["gas"]["u"], states[1]["gas"]["w"]))

    @staticmethod
    def _states(sc, sf):
        return [{"gas": {"u": sc[0], "w": sc[1]}}, {"gas": {"u": sf[0], "w": sf[1]}}]

    def _place(self, lo):
        """Put the patch at ``lo`` (a host tuple) when it is elsewhere (a
        curvilinear patch is rebuilt there)."""
        lo = tuple(int(v) for v in lo)
        if lo != self.node.lo:
            if self.curv:
                self.node.rebuild_at(lo)
            else:
                self.node.lo = lo
            self.ml._compile(self.ml.fused, self.ml.gather6)

    def _step(self, sc, sf, dt, lo):
        self._place(lo)
        states = self.ml.step(self._states(sc, sf), dt, 0.0)
        return ((states[0]["gas"]["u"], states[0]["gas"]["w"]),
                (states[1]["gas"]["u"], states[1]["gas"]["w"]))

    def _dt(self, sc, sf):
        return self.ml.estimate_dt(self._states(sc, sf))

    def run(self, sc, sf, tlim, nlim=-1, criterion=None, retag_interval=10):
        t, dt, nc = 0.0, float(self._dt(sc, sf)), 0
        lo = self.patch_lo
        while t < tlim * (1 - 1e-12) and (nlim < 0 or nc < nlim):
            use = min(dt, tlim - t)
            sc, sf = self._step(sc, sf, use, lo)
            t += use
            nc += 1
            dt = min(2 * use, float(self._dt(sc, sf)))
            if criterion is not None and nc % retag_interval == 0:
                sc, sf, lo = self.retag(sc, sf, lo, criterion)
        self.patch_lo = lo
        return sc, sf, t, nc

    def retag(self, sc, sf, lo, criterion):
        self._place(lo)
        states = self.ml.retag_criteria(self._states(sc, sf), criterion)
        return ((states[0]["gas"]["u"], states[0]["gas"]["w"]),
                (states[1]["gas"]["u"], states[1]["gas"]["w"]), self.node.lo)


class SMRDriver:
    """Deck-driven static or adaptive refinement behind the Driver surface
    ``evolve`` uses (``step``, ``estimate_dt``, ``grid``; host_coupled).

    Deck dialect (reference-compatible): ``<parthenon/mesh> refinement =
    static | adaptive``, ``numlevel``; ``<parthenon/static_refinementK>``
    blocks with ``level`` and physical bounds x1min..x3max (Parthenon static
    refinement, running.rst:121-135); without them, ``<parthenon/
    refinement> patch_lo{1,2,3}`` / ``patch_nx{1,2,3}`` (one centred patch
    per level by default).  Adaptive: ``<gas> refine_field / refine_type /
    refine_thr / deref_thr`` (gas.cpp:304-383) or a problem's own criterion
    (``<artemis> amr_user``), evaluated every ``<parthenon/refinement>
    check_interval`` cycles; ``style = tiled`` (the default with a
    criterion) spawns and destroys tiles of ``tile_nx{1,2,3}`` root cells
    dilated by ``nbuf`` cells, static_refinement blocks becoming forced
    tile windows; ``style = move`` re-centres the deck's patch per level.
    With the N-body package, ``<nbody/...> refine_distance > 0`` gives a
    particle its own level-1 tracking patch, re-centred on it every
    ``check_interval`` cycles (``<nbody> refine_type = none`` turns them
    off).  The state ``evolve`` sees is the root's, every fluid of it,
    which carries the restricted fine solution under the patches; the fine
    levels' states live here.  ``devices`` (one per shard) shards the tree
    along grid axis ``shard_axis`` (``parallel.amr.ShardedSMR``; ``<artemis>
    amr_distribute`` block-shards the patches that do not span that axis),
    each shard's custom fills built by ``bc_factory`` on its own grid."""

    host_coupled = True

    def __init__(self, grid, integrator, gas_cfg, pin, *, device, dtype, dust_cfg=None,
                 sources_factory=None, diffusion_factory=None, bc_custom=None,
                 omf=0.0, radiation_factory=None, fused=False, nbody=None, devices=None,
                 shard_axis: int = 3, bc_factory=None):
        mode = pin.get_str("parthenon/mesh", "refinement")
        if mode not in ("adaptive", "static"):
            raise ValueError(f"refinement {mode!r} not recognized")
        self.gas_cfg = gas_cfg
        self.dust_cfg = dust_cfg
        self.nbody = nbody
        self.grid = grid
        self.integrator = integrator
        self.adaptive = mode == "adaptive"
        numlevel = pin.get_or_add_int("parthenon/mesh", "numlevel", 2)
        self.numlevel = numlevel
        has_crit = pin.exists("gas", "refine_thr") or pin.get_or_add_bool(
            "artemis", "amr_user", False)
        self.tiled = self.adaptive and pin.get_or_add_str(
            "parthenon/refinement", "style", "tiled" if has_crit else "move") == "tiled"
        # the default tile: 16 root cells per active axis, clamped (even) to
        # what fits inside the nesting rim; an explicit tile that does not
        # fit raises in regrid_tiles
        tile = []
        for d in range(3):
            if grid.nx[d] <= 1:
                tile.append(1)
                continue
            rim = max(1, -(-grid.ng[d] // 2)) + 1
            fit = max(2, (grid.nx[d] - 2 * rim) // 2 * 2)
            tile.append(pin.get_or_add_int("parthenon/refinement", f"tile_nx{d + 1}",
                                           min(16, fit)))
        self.tile = tuple(tile)
        self.regrid_nbuf = pin.get_or_add_int("parthenon/refinement", "nbuf", 1)
        patches = []
        self.forced_windows = []
        for blk in pin.block_names():
            if not blk.startswith("parthenon/static_refinement"):
                continue
            level = pin.get_or_add_int(blk, "level", 1)
            if self.tiled:
                # a forced tile window (Parthenon keeps static regions
                # refined under refinement=adaptive)
                wins = self._bounds_to_windows(pin, blk, grid, level)
                for win in wins:
                    self._warn_uncoverable(blk, win, grid)
                self.forced_windows.extend(wins)
                self.numlevel = max(self.numlevel, level + 1)
                continue
            patches += self._bounds_to_patches(pin, blk, grid, level)
        if not patches and numlevel >= 2 and not self.tiled:
            for lev in range(1, numlevel):
                scale = 2 ** (lev - 1)
                base_nx = [grid.nx[d] * scale for d in range(3)]
                n = [max(4, base_nx[d] // 2) if grid.nx[d] > 1 else 1 for d in range(3)]
                for d in range(3):
                    if pin.exists("parthenon/refinement", f"patch_nx{d + 1}"):
                        n[d] = pin.get_int("parthenon/refinement", f"patch_nx{d + 1}")
                lo = [(base_nx[d] - n[d]) // 2 if grid.nx[d] > 1 else 0 for d in range(3)]
                for d in range(3):
                    if lev == 1 and pin.exists("parthenon/refinement", f"patch_lo{d + 1}"):
                        lo[d] = pin.get_int("parthenon/refinement", f"patch_lo{d + 1}")
                patches.append(dict(level=lev, lo=tuple(lo), n=tuple(n)))
        # N-body tracking patches (nbody.cpp:276-312): <nbody> refine_type
        # = distance enables them (nbody.cpp:238-241), none disables them
        # whatever the particles' refine_distance; without the key,
        # refine_distance > 0 alone enables.  derefine_factor is read and
        # unused (a moving patch needs no derefinement band).
        track = []
        if nbody is not None:
            rtype = pin.get_or_add_str("nbody", "refine_type", "")
            pin.get_or_add_real("nbody", "derefine_factor", 2.0)
            if rtype in ("", "distance"):
                track = [(k, float(rd)) for k, rd in enumerate(nbody.target_rad) if rd > 0.0]
        tree_kw = dict(
            dust_cfg=dust_cfg, sources_factory=sources_factory,
            diffusion_factory=diffusion_factory, omf=omf, patches=patches,
            radiation_factory=radiation_factory, fused=fused, nbody=nbody,
            # tiled pools stay put between regrids (each regrid re-runs the
            # set-up), so they keep sibling links and six-face halos
            moving_patches=(self.adaptive and not self.tiled) or bool(track))
        if devices is None:
            self.smr = MultiLevelSMR(grid, integrator, gas_cfg, device=device, dtype=dtype,
                                     bc_custom=bc_custom, **tree_kw)
        else:
            from .parallel.amr import ShardedSMR

            self.smr = ShardedSMR(
                grid, integrator, gas_cfg, devices=devices, dtype=dtype, axis=shard_axis,
                bc_factory=bc_factory,
                distribute=pin.get_or_add_bool("artemis", "amr_distribute", False), **tree_kw)
        # {node index: particle index} of the tracking patches, each wide
        # enough to cover +/- refine_distance around its particle on the
        # root grid
        self._particle_nodes = {}
        for k, rd in track:
            cell = MultiLevelSMR._cell_of(grid, nbody.pos[k] - nbody.Rf)
            rim = max(1, -(-grid.nghost // 2)) + 1
            lo, n = [], []
            for d in range(3):
                if grid.nx[d] <= 1:
                    lo.append(0)
                    n.append(1)
                    continue
                dx = (grid.xmax[d] - grid.xmin[d]) / grid.nx[d]
                nn = min(2 * max(2, int(np.ceil(rd / dx))), grid.nx[d] - 2 * rim)
                nn += nn % 2
                n.append(nn)
                lo.append(int(np.clip(cell[d] - nn // 2, rim, grid.nx[d] - nn - rim)))
            node = self.smr.add_patch(1, tuple(lo), tuple(n))
            self._particle_nodes[node.index] = k
        if track:
            self.smr._compile(self.smr.fused, self.smr.gather6)
        root = self.smr.root
        self.hydro, self.sources = root.hydro, root.sources
        self.diffusion, self.radiation = root.diffusion, self.smr.node_radiation(root)
        self.criterion = None
        if self.adaptive and pin.exists("gas", "refine_thr"):
            self.criterion = dict(
                field=pin.get_or_add_str("gas", "refine_field", "density"),
                type=pin.get_or_add_str("gas", "refine_type", "gradient"),
                refine_thr=pin.get_real("gas", "refine_thr"),
                deref_thr=pin.get_or_add_real("gas", "deref_thr", 0.0))
        # a problem-defined criterion (<artemis> amr_user; Simulation wires
        # Problem.amr_criterion here) overrides the <gas> keys
        self.user_criterion = None
        self.retag_interval = pin.get_or_add_int("parthenon/refinement", "check_interval", 10)
        # the retag and regrid schedule counts the global cycle: a resumed
        # run takes the checkpoint's (Simulation sets it, as the JAX
        # package's does, artemis_tpu/simulation.py:383-386)
        self._ncycle = 0
        # the patches' initial prims (set by Simulation from the problem
        # generator on each patch grid); None prolongs the parent's
        self._fine_prims = None
        self._states = None

    @property
    def stage_kernel(self) -> str:
        return self.smr.stage_kernel

    def _warn_uncoverable(self, blk, win, grid):
        """Print a warning where the tile lattice cannot cover a forced
        window: it anchors at the nesting rim with a uniform step, and each
        deeper level anchors one tile-wide window per parent tile."""
        for d in range(3):
            if grid.nx[d] <= 1:
                continue
            rim = max(1, -(-grid.nghost // 2)) + 1
            t = self.tile[d]
            kmax = (grid.nx[d] - 2 * rim - t) // t
            anchors = [rim + k * t for k in range(kmax + 1)]
            for _ in range(win["level"] - 1):
                anchors = [2 * a + rim for a in anchors]
            if win["level"] >= 2:
                ok = any(a <= win["c0"][d] and win["c1"][d] <= a + t for a in anchors)
            else:
                ok = (anchors and win["c1"][d] <= anchors[-1] + t
                      and win["c0"][d] >= anchors[0])
            if not ok:
                print(f"# WARNING: {blk} (level {win['level']}) is not fully coverable by "
                      f"the tile lattice on x{d + 1} (window cells [{win['c0'][d]}, "
                      f"{win['c1'][d]}) vs anchored {t}-cell tile windows at "
                      f"{anchors[:4]}...); align the region or adjust tile_nx{d + 1}",
                      flush=True)

    @property
    def _regrids(self) -> bool:
        """Does this tree spawn and destroy tiles?"""
        return self.tiled and (self.criterion is not None or self.user_criterion is not None
                               or bool(self.forced_windows))

    def _regrid(self):
        """One spawn/destroy pass; amr_user's criterion overrides the <gas>
        keys."""
        return self.smr.regrid_tiles(
            self._states, self.criterion if self.user_criterion is None else {}, self.tile,
            nbuf=self.regrid_nbuf, tags_fn=self.user_criterion, numlevel=self.numlevel,
            forced=self.forced_windows)

    @staticmethod
    def _bounds_to_windows(pin, blk, grid, level):
        """A static_refinement block's physical bounds as global cell
        windows at levels 1..level: dict(level, c0, c1) with [c0, c1) in
        level-(level-1) global cells, widened to even cells and clamped
        inside the nesting rim."""
        out = []
        lo_phys = [pin.get_or_add_real(blk, f"x{d + 1}min", grid.xmin[d]) for d in range(3)]
        hi_phys = [pin.get_or_add_real(blk, f"x{d + 1}max", grid.xmax[d]) for d in range(3)]
        for lev in range(1, level + 1):
            scale = 2 ** (lev - 1)
            c0s, c1s = [], []
            for d in range(3):
                if grid.nx[d] <= 1:
                    c0s.append(0)
                    c1s.append(1)
                    continue
                nd_lvl = grid.nx[d] * scale
                dx = (grid.xmax[d] - grid.xmin[d]) / nd_lvl
                c0 = int(np.floor((lo_phys[d] - grid.xmin[d]) / dx))
                c1 = int(np.ceil((hi_phys[d] - grid.xmin[d]) / dx))
                c0 -= c0 % 2
                c1 += c1 % 2
                if c0 <= 0 and c1 >= nd_lvl and grid.bc[d] == ("periodic", "periodic"):
                    c0, c1 = 0, nd_lvl          # full-span wrap patch
                else:
                    rim = max(1, -(-grid.nghost // 2)) + 1
                    c0 = int(np.clip(c0, rim, nd_lvl - rim))
                    c1 = int(np.clip(c1, c0 + 2, nd_lvl - rim))
                c0s.append(c0)
                c1s.append(c1)
            out.append(dict(level=lev, c0=tuple(c0s), c1=tuple(c1s)))
        return out

    @classmethod
    def _bounds_to_patches(cls, pin, blk, grid, level):
        """Nested patch specs at levels 1..level covering a block's bounds."""
        out = []
        prev_c0 = [0, 0, 0]
        for win in cls._bounds_to_windows(pin, blk, grid, level):
            lev, c0, c1 = win["level"], win["c0"], win["c1"]
            lo = [0 if grid.nx[d] <= 1 else (c0[d] - 2 * prev_c0[d] if lev > 1 else c0[d])
                  for d in range(3)]
            n = [1 if grid.nx[d] <= 1 else c1[d] - c0[d] for d in range(3)]
            out.append(dict(level=lev, lo=tuple(lo), n=tuple(n)))
            prev_c0 = list(c0)
        return out

    # -- Driver surface ----------------------------------------------------
    def initialize(self, state):
        prims = [None] * len(self.smr.nodes)
        prims[0] = {fl: state[fl]["w"] for fl in state}
        for i, pr in enumerate(self._fine_prims or []):
            if pr is not None and i + 1 < len(prims):
                prims[i + 1] = pr
        self._states = self.smr.initialize(prims)
        if self._regrids:
            # refine the initial condition before the first step, once per
            # level below the root so a feature reaches full depth
            for _ in range(max(1, self.numlevel - 1)):
                self._states = self._regrid()
        return self.smr.root_state(self._states)

    def restart_payloads(self):
        """The fine levels' arrays for a bit-exact restart (name -> fn), as
        the JAX package writes them: ``n{i}.{fluid}.u|w`` of each fluid,
        ``n{i}.rad.Er`` and the patch position ``n{i}.lo`` of every node
        below the root, and
        with a tile pool its topology, ``pool``: one row [level,
        parent_index, lo, n] per pool node in node order (pool nodes trail
        the deck's patches)."""
        def host(i, fl, kind):
            return lambda: self._states[i][fl][kind].detach().cpu().numpy()

        out = {}
        for node in self.smr.nodes[1:]:
            i = node.index
            for fl, _ in node.fluids():
                out[f"n{i}.{fl}.u"] = host(i, fl, "u")
                out[f"n{i}.{fl}.w"] = host(i, fl, "w")
            if node.radiation is not None:
                out[f"n{i}.rad.Er"] = host(i, "rad", "Er")
            out[f"n{i}.lo"] = (lambda lo: lambda: np.array(lo, dtype=np.int32))(node.lo)
        rows = tree_rows(self.smr.global_nodes)
        rows = rows[rows[:, 8] == 1, :8]
        if len(rows):
            out["pool"] = lambda: rows
        return out

    def load_restart(self, payloads, root_state):
        """The fine levels from a checkpoint's payloads, on the run's device:
        a tile pool's nodes are rebuilt from its ``pool`` rows first (a
        6-column row, [lo, n], is a level-1 tile of an older checkpoint),
        then every node takes its arrays.  A moving patch goes to its
        checkpointed ``n{i}.lo`` (a curvilinear one is rebuilt there); a
        static patch must already sit there."""
        ml = self.smr
        if "pool" in payloads:
            tree_topology_from_rows(ml, payloads["pool"])

        def dev(key):
            a = payloads[key]
            if a.dtype != np.dtype(str(ml.dtype).removeprefix("torch.")):
                raise ValueError(f"restart payload {key} is {a.dtype}, the tree runs "
                                 f"{ml.dtype}")
            return torch.as_tensor(a, device=ml.device)

        self._states = [None] * len(ml.nodes)
        self._states[0] = {k: dict(v) for k, v in root_state.items()}
        moved = False
        for node in ml.nodes[1:]:
            i = node.index
            lo = payloads.get(f"n{i}.lo")
            lo = node.lo if lo is None else tuple(int(v) for v in lo)
            if lo != node.lo:
                if ml._links_static(node):
                    raise ValueError(f"restart: node {i} sits at {lo}, the deck's static "
                                     f"tree puts it at {node.lo}")
                ml._place_node(node, lo)
                moved = True
            st = {fl: {"u": dev(f"n{i}.{fl}.u"), "w": dev(f"n{i}.{fl}.w")}
                  for fl, _ in node.fluids()}
            if node.radiation is not None:
                st["rad"] = {"Er": dev(f"n{i}.rad.Er")}
            self._states[i] = st
        if moved:
            ml._compile(ml.fused, ml.gather6)

    def _ensure_states(self, root_state):
        if self._states is None:
            prims = [None] * len(self.smr.nodes)
            prims[0] = {fl: root_state[fl]["w"] for fl in root_state if fl != "rad"}
            self._states = self.smr.initialize(prims)
        self._states = self.smr.with_root(self._states, root_state)

    def step(self, state, dt: float, time: float):
        self._ensure_states(state)
        self._states = self.smr.step(self._states, dt, time)
        self._ncycle += 1
        if self._ncycle % self.retag_interval == 0:
            if self._regrids:
                self._states = self._regrid()
            elif self.user_criterion is not None:
                self._states = self.smr.retag_user(self._states, self.user_criterion)
            elif self.criterion is not None:
                self._states = self.smr.retag_criteria(self._states, self.criterion)
            # a sharded tree keeps a curvilinear tracking patch where it is
            # (the JAX package's rule, artemis_tpu/amr.py:3105-3115)
            if self._particle_nodes and (self.smr._shard_axis is None or not self.smr.nodes[
                    next(iter(self._particle_nodes))].curv):
                self._states = self.smr.retag_particles(
                    self._states, self._particle_nodes, self.nbody.pos - self.nbody.Rf)
        return self.smr.root_state(self._states)

    def estimate_dt(self, state) -> float:
        self._ensure_states(state)
        return host_read(self.smr.estimate_dt(self._states), "dt")
