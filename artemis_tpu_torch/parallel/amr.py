"""Refinement trees over several devices: every level split along one
periodic grid axis (port of ``artemis_tpu/parallel/amr.py``).

Parthenon distributes a refined mesh's MeshBlocks over MPI ranks (SURVEY.md
§2.7); the JAX package instead block-shards every level of its patch tree
along one periodic axis and runs the whole step under one ``shard_map``.
The port keeps the JAX package's three kinds of node:

* a **wrap** patch spans the sharded axis and is split into the same slabs
  as the root, so its ghosts along that axis are its neighbour shards' fine
  data;
* a **replicated** patch keeps its global frame: its ghosts are prolonged
  from the parent gathered along the axis, and its restriction and flux
  correction land in each shard's window of the parent through masked
  global-frame scatters (N-body ``refine_distance`` tracking patches and
  adaptive tiles are of this kind);
* a **distributed** patch (``<artemis> amr_distribute = true``, a patch
  whose extent along the axis splits into an even number of fine cells per
  shard and whose geometry does not vary along it) is split into slabs: the
  internal seams take the neighbour shard's fine ghosts, the two global ends
  the prolonged parent, and its restriction and end-face flux corrections
  are routed to whichever shard's window they land in.  An uneven patch
  falls back to replication.

A global tree (``_gtree``) is built in lockstep with the shard trees: the
problem generator's initial states, the checkpoints' topology and the
host-side passes (adaptive moves and tile regrids tag on the gathered root,
then the shard trees take the new topology) use its global grids; its
Hydro is built only where a pass uses it.  Since those passes run on the
global tree, the JAX package's ``_ic_hydro`` and ``_place_fresh`` hooks have
no counterpart here; a distributed node's ``lo`` is its own slab's origin
in its parent's global frame, where the JAX package keeps the patch's and
offsets it per shard (``_node_lo``).

One process drives every shard, as the JAX package's single controller
drives its ``shard_map``.  Each shard is a ``MultiLevelSMR`` of its own
(``_ShardTree``) on its own device, with its own Hydro, sources, diffusion,
radiation and custom fills built on its own window, so the JAX package's
lazy per-shard views of a global build are not ported (as in
``parallel.mesh``).  The shard trees run the composable stage and the
radiation pass of ``MultiLevelSMR`` with its sharding hooks overridden:
``_Lockstep`` runs the shards' calls as cooperative threads, one at a time
and in shard order between two collectives, so a stage runs phase by phase
over all shards as a loop over them would.  A collective hands every shard
the values all of them gave, in shard order: the JAX package's ``ppermute``
becomes a slab copy from the neighbour, ``all_gather`` a ``torch.cat``
along the axis, ``psum`` an ordered sum (the N-body force rows, the routed
scatters) and ``pmin`` the minimum over shards (dt, read to the host once
per cycle).  A replicated node is computed identically on every shard,
as in the JAX package: each shard corrects and restricts it into its own
window of the parent, and its flux sweeps (K9) launch on every shard.

The sharded tree takes the composable stage, as the JAX package's does
(``_fused_ok = False``): on the card each Cartesian node's gas fluxes go
through the flux sweep kernel (K9) on every shard.  The root, wrap and
distributed nodes solve radiation on fields that hold one tensor per shard
(``parallel.mesh.Sharded``, the tensor operator); replicated nodes solve
unsharded, through the FLD kernels (K7, K8) where the single-device tree
would.  The same code runs four shards on the CPU, four on one card
(``devices=["cuda:0"] * 4``) or one per card.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from collections.abc import MutableMapping, Sequence

import numpy as np
import torch

from .. import bc as bc_mod
from ..amr import MultiLevelSMR, _Node, _refine_grid, _zyx
from ..driver import nbody_coeffs
from ..geometry import geometry as geo
from ..ops.hydro import Hydro
from ..profiling import host_read
from ..radiation import initialize_radiation
from .mesh import Sharded, _axis_slice, _local_grid_at


class _Aborted(Exception):
    """Another shard raised; this one stops at its next collective."""


class _Lockstep:
    """Runs one call per shard as cooperative threads: exactly one runs at a
    time, the shards in order between two collectives, so the calls make
    their tensor operations and kernel launches in the order of a loop over
    the shards, phase by phase, and counters need no lock.  Every shard must
    reach the same collectives in the same order."""

    def __init__(self, devices):
        self.devices = devices
        self.n = len(devices)
        self._cv = threading.Condition()
        self._turn = 0
        self._slots = [None] * self.n
        self._result = None
        self._error = None

    def run(self, fn):
        """``[fn(k) for k in range(n)]``, the calls in lockstep."""
        n = self.n
        if n == 1:
            return [fn(0)]
        self._turn, self._error, self._slots = 0, None, [None] * n
        out = [None] * n

        def body(k):
            try:
                if self.devices[k].type == "cuda":
                    torch.cuda.set_device(self.devices[k])
                self._wait(k)
                out[k] = fn(k)
            except _Aborted:
                return
            except BaseException as e:  # noqa: BLE001 -- re-raised by run
                with self._cv:
                    if self._error is None:
                        self._error = e
                    self._cv.notify_all()
                return
            with self._cv:
                self._turn = k + 1
                self._cv.notify_all()

        threads = [threading.Thread(target=body, args=(k,), name=f"shard-{k}", daemon=True)
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self._error is not None:
            raise self._error
        return out

    def _wait(self, k):
        with self._cv:
            self._cv.wait_for(lambda: self._turn == k or self._error is not None)
            if self._error is not None:
                raise _Aborted

    def collect(self, k, value, reduce=list):
        """Shard ``k`` gives ``value``; once every shard has, the last one
        computes ``reduce(values in shard order)`` and every shard gets it."""
        if self.n == 1:
            return reduce([value])
        with self._cv:
            self._slots[k] = value
            if k == self.n - 1:
                vals, self._slots = self._slots, [None] * self.n
                self._result = reduce(vals)
                self._turn = 0
            else:
                self._turn = k + 1
            self._cv.notify_all()
            self._cv.wait_for(lambda: self._turn == k or self._error is not None)
            if self._error is not None:
                raise _Aborted
            return self._result


class _LazyHydro:
    """A node's Hydro, built at the first use of anything but its grid (the
    global tree's nodes need one only for a host-side prolongation or a
    curvilinear patch's global face areas)."""

    def __init__(self, make, grid):
        self._make, self._hydro, self.grid = make, None, grid

    def __getattr__(self, name):
        if self._hydro is None:
            self._hydro = self._make()
        return getattr(self._hydro, name)


class _GlobalTree(MultiLevelSMR):
    """The global tree: the global grids of every node, in lockstep with the
    shard trees; it steps nothing."""

    def _node_hydro(self, grid):
        return _LazyHydro(lambda: MultiLevelSMR._node_hydro(self, grid), grid)


class _ShardTree(MultiLevelSMR):
    """Shard ``k``'s tree on its own device: the root's window, the wrap and
    distributed patches' slabs, the replicated patches whole.  Its hooks
    exchange with the other shards through the owner's ``_Lockstep``."""

    def __init__(self, owner: "ShardedSMR", k: int, root_grid, integrator, gas_cfg, **kw):
        self.owner = owner
        self.k = k
        self._shard_axis = owner.axis_d
        self._ghydro = {}
        super().__init__(root_grid, integrator, gas_cfg, **kw)

    _fused_ok = False
    # every node solves its own radiation step: the JAX tree batches only
    # when it is not sharded (artemis_tpu/amr.py:1952)
    _batch_radiation = False

    @property
    def _comm(self):
        return self.owner._lockstep

    def _global_child(self, node) -> bool:
        """Does ``node.lo`` index its parent's global frame?  (A replicated
        or distributed node under a node held in slabs.)"""
        return (node.parent is not None and (node.replicated or node.distributed)
                and not node.parent.replicated)

    def _add(self, gn, kind):
        """This shard's node of the global tree's node ``gn``."""
        d, S = self._shard_axis, self.owner.nshards
        parent = self.nodes[gn.parent.index]
        nn, lo = list(gn.n), list(gn.lo)
        if kind == "replicated":
            node = _Node(self, gn.grid, parent, gn.lo, gn.n, gn.level, wrap=gn.wrap,
                         kind=kind)
        else:
            nn[d - 1] //= S
            if kind == "wrap":
                node = _Node(self, _refine_grid(parent.grid, lo, nn), parent, lo, nn, gn.level)
            else:
                lo[d - 1] += self.k * nn[d - 1]
                pg = self.owner._gtree.nodes[gn.parent.index].grid
                node = _Node(self, _refine_grid(pg, lo, nn), parent, lo, nn, gn.level,
                             wrap=gn.wrap, kind=kind)
        node.pool = gn.pool
        return node

    def _place(self, gn):
        """Put this shard's node of ``gn`` where ``gn`` now sits."""
        node = self.nodes[gn.index]
        lo = list(gn.lo)
        if node.distributed:
            d = self._shard_axis
            lo[d - 1] += self.k * node.n[d - 1]
        MultiLevelSMR._place_node(self, node, lo)

    # -- hooks --------------------------------------------------------------
    def _exchange(self, tail, head, d: int):
        """The neighbours' slabs along the sharded axis: the lower shard's
        ``tail`` and the upper shard's ``head`` (periodic over the shards)."""
        if d != self._shard_axis - 1:
            return tail, head
        n, k = self.owner.nshards, self.k
        vals = self._comm.collect(k, (tail, head))
        return vals[(k - 1) % n][0].to(self.device), vals[(k + 1) % n][1].to(self.device)

    def _root_fill(self, w, node, fluid):
        """The root's ghosts along the sharded axis from the neighbours'
        slabs, then the deck's boundaries on the other axes (corners
        included)."""
        grid, d = node.grid, self._shard_axis
        gd, n_l = grid.ng[d - 1], grid.nx[d - 1]
        below, above = self._exchange(_axis_slice(w, d, n_l - gd, gd), _axis_slice(w, d, 0, gd),
                                      d - 1)
        w_pad = bc_mod.pad_prims(w, grid)
        sl = [slice(None)] * w_pad.ndim
        for c in (1, 2, 3):
            if c != d:
                sl[w_pad.ndim - c] = slice(grid.ng[c - 1], grid.ng[c - 1] + grid.nx[c - 1])
        sl[w_pad.ndim - d] = slice(0, gd)
        w_pad[tuple(sl)] = below
        sl[w_pad.ndim - d] = slice(gd + n_l, None)
        w_pad[tuple(sl)] = above
        bc = list(grid.bc)
        bc[d - 1] = ("none", "none")
        return bc_mod.fill_ghosts(w_pad, dataclasses.replace(grid, bc=tuple(bc)), fluid,
                                  self.bc_custom)

    def _gather_axis(self, a):
        """The global array of a node held in slabs (``all_gather``)."""
        parts = self._comm.collect(self.k, a)
        return torch.cat([p.to(self.device) for p in parts], dim=a.ndim - self._shard_axis)

    def _parent_arrs(self, arrs, nodes=None):
        out = MultiLevelSMR._parent_arrs(self, arrs, nodes)
        gathered = {}
        for nd in self.nodes if nodes is None else nodes:
            if self._global_child(nd):
                p = nd.parent.index
                if p not in gathered:
                    gathered[p] = self._gather_axis(arrs[p])
                out[nd.index] = gathered[p]
        return out

    def _post_fine_ghosts(self, wp, node, fluid):
        """A distributed patch's internal seams take the neighbour shard's
        fine rows; the two global ends keep the prolonged parent."""
        S, k = self.owner.nshards, self.k
        if not node.distributed or S == 1:
            return wp
        d = self._shard_axis
        ng, nloc = node.grid.ng[d - 1], node.grid.nx[d - 1]
        ax = wp.ndim - d
        vals = self._comm.collect(k, (wp.narrow(ax, nloc, ng).clone(),
                                      wp.narrow(ax, ng, ng).clone()))
        if k > 0:
            wp.narrow(ax, 0, ng).copy_(vals[k - 1][0].to(self.device))
        if k < S - 1:
            wp.narrow(ax, ng + nloc, ng).copy_(vals[k + 1][1].to(self.device))
        return wp

    def _parent_grid(self, node):
        if self._global_child(node):
            return self.owner._gtree.nodes[node.parent.index].grid
        return node.parent.grid

    def _global_hydro(self, p: int):
        """The Hydro of node ``p``'s global grid on this shard's device."""
        gh = self.owner._gtree.nodes[p].hydro
        if self.owner._gtree.device == self.device:
            return gh
        h = self._ghydro.get(p)
        if h is None or h.grid is not gh.grid:
            h = self._ghydro[p] = Hydro(gh.grid, self.cfg, self.dust_cfg, device=self.device,
                                        dtype=self.dtype)
        return h

    def _scatter_axis(self, A, upd, starts, face=False, apply=True, route=False):
        """Write ``upd``, placed at global-frame [z, y, x] ``starts``, into
        this shard's window of ``A`` where they overlap (in place).
        ``face``: ``A`` has face extent along the sharded axis (a seam face
        sits on both shards).  ``apply``: this shard's update lands at all.
        ``route``: every shard gives an update of its own and each lands
        wherever it overlaps (the JAX package's psum of the global
        buffers; the updates are disjoint)."""
        d = self._shard_axis
        ax = A.ndim - d
        w0 = self.k * (A.shape[ax] - (1 if face else 0))
        pieces = [(upd, starts, apply)]
        if route:
            pieces = self._comm.collect(self.k, pieces[0])
        for u, st, ok in pieces:
            if not ok:
                continue
            s = st[3 - d]
            a, b = max(s, w0), min(s + u.shape[u.ndim - d], w0 + A.shape[ax])
            if a >= b:
                continue
            st = list(st)
            st[3 - d] = a - w0
            sizes = list(u.shape[-3:])
            sizes[3 - d] = b - a
            A[_zyx(st, sizes)] = u.narrow(u.ndim - d, a - s, b - a).to(A.device)
        return A

    def _flux_correct(self, node, fx_c, fx_f, lo):
        if not self._global_child(node):
            return node.flux_correct(fx_c, fx_f, lo)
        d0, S, k = self._shard_axis, self.owner.nshards, self.k
        dist = node.distributed

        def scatter(Fc, upd, starts, d, side):
            # a distributed patch's seam faces along the axis are fine-fine:
            # only its global end faces, on the end shards, correct
            apply = not (dist and d == d0) or (k == 0 if side == 0 else k == S - 1)
            return self._scatter_axis(Fc, upd, starts, face=d == d0, apply=apply, route=dist)

        return node.flux_correct(fx_c, fx_f, lo, hc=self._global_hydro(node.parent.index),
                                 scatter=scatter)

    def _restrict_into(self, node, arr, res, lo):
        if not self._global_child(node):
            return self._deposit(arr, res, lo)
        return self._scatter_axis(arr, res, [lo[2], lo[1], lo[0]], route=node.distributed)

    def _cover_mask(self, node):
        """A node held in slabs: its replicated and distributed children
        cover their global footprints where they fall in its window."""
        if not node.children or node.replicated:
            return MultiLevelSMR._cover_mask(self, node)
        mask = torch.ones(tuple(reversed(node.grid.nx)), dtype=self.dtype, device=self.device)
        for ch in node.children:
            src = self.owner._gtree.nodes[ch.index] if self._global_child(ch) else ch
            starts = [src.lo[d] if node.grid.nx[d] > 1 else 0 for d in (2, 1, 0)]
            sizes = [src.n[d] if node.grid.nx[d] > 1 else 1 for d in (2, 1, 0)]
            if src is ch:
                mask[_zyx(starts, sizes)] = 0.0
            else:
                self._scatter_axis(mask, torch.zeros(sizes, dtype=self.dtype,
                                                     device=self.device), starts)
        return mask

    def _node_pforce(self, node, pf):
        """A node held in slabs: its force rows summed over the shards in
        shard order (``psum``); a replicated node's, the same on every
        shard, as they are."""
        if node.replicated:
            return pf

        def total(parts):
            out = parts[0]
            for p in parts[1:]:
                out = out + p.to(out.device)
            return out

        return self._comm.collect(self.k, pf, total).to(self.device)

    def _sib_pair_ok(self, a, b) -> bool:
        # replicated pairs share the global frame on every shard
        return a.replicated and b.replicated

    def _rad_solve(self, node, st, dt, ghosts):
        if node.replicated:
            return MultiLevelSMR._rad_solve(self, node, st, dt, ghosts)
        outs = self._comm.collect(
            self.k, (st, ghosts, dt), lambda vals: self.owner._rad_solve_sharded(node.index, vals))
        return outs[self.k]


class TreeStates(Sequence):
    """A sharded tree's per-node states: ``shards[k][i]`` is shard k's
    ``{name: {key: tensor}}`` of node i.  Read by node (``states[i]``), it
    gathers the node's global arrays on the first shard's device, once per
    node: the outputs, the checkpoints and the tests read a sharded tree as
    an unsharded one.  Set by node, it splits global arrays into the
    shards."""

    def __init__(self, smr: "ShardedSMR", shards):
        self.smr = smr
        self.shards = shards
        self._global = {}

    def __len__(self):
        return len(self.shards[0])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(len(self))[i]]
        i = range(len(self))[i]     # IndexError past the end
        if i not in self._global:
            self._global[i] = self.smr._gather_node(self.shards, i)
        return self._global[i]

    def __setitem__(self, i, st):
        for k, part in enumerate(self.smr._split_node(i, st)):
            self.shards[k][i] = part
        self._global.pop(i, None)

    def clone(self):
        """A copy that shares no tensor with this one."""
        return TreeStates(self.smr, [[{
            name: {key: v.clone() for key, v in kinds.items()} for name, kinds in st.items()}
            for st in sh] for sh in self.shards])


class _RootView(MutableMapping):
    """The root's state of a sharded tree as ``evolve`` and the outputs see
    it: read by name, the gathered global arrays; set by name, split into
    the shards."""

    def __init__(self, states: TreeStates):
        self.states = states

    def __getitem__(self, name):
        return self.states[0][name]

    def __setitem__(self, name, kinds):
        st = dict(self.states[0])
        st[name] = kinds
        self.states[0] = st

    def __delitem__(self, name):
        st = dict(self.states[0])
        del st[name]
        self.states[0] = st

    def __iter__(self):
        return iter(self.states.shards[0][0])

    def __len__(self):
        return len(self.states.shards[0][0])

    def clone(self):
        """The root's global state, copied."""
        return {name: {key: v.clone() for key, v in self[name].items()} for name in self}


class ShardedSMR:
    """A static or adaptive refinement tree split along periodic grid axis
    ``axis`` over ``devices`` (one per shard; ``parallel.mesh.
    make_device_mesh``): the surface of ``MultiLevelSMR`` that ``SMRDriver``
    uses, each method run over the shard trees.  ``distribute``: patches
    that do not span the axis are split into slabs where they split evenly
    (else replicated).  ``bc_factory(local_grid)`` builds each shard's
    custom fills.  ``nodes`` are the first shard's."""

    _shard_axis = None  # set per instance

    def __init__(self, global_grid, integrator, gas_cfg, *, devices, dtype, axis: int = 3,
                 dust_cfg=None, sources_factory=None, diffusion_factory=None, bc_factory=None,
                 omf: float = 0.0, patches=None, radiation_factory=None, fused=False,
                 moving_patches: bool = False, nbody=None, distribute: bool = False):
        d = int(axis)
        if d not in (1, 2, 3):
            raise ValueError(f"shard axis {axis} not in 1..3")
        if global_grid.bc[d - 1] != ("periodic", "periodic"):
            raise ValueError("sharded refinement needs a periodic sharded axis")
        self.devices = [torch.device(dv) for dv in devices]
        self.nshards = S = len(self.devices)
        self.axis_d = self._shard_axis = d
        self.device, self.dtype = self.devices[0], dtype
        self.integ, self.cfg, self.dust_cfg = integrator, gas_cfg, dust_cfg
        self.nbody = nbody
        self.radiation_factory = radiation_factory
        self.moving_patches = moving_patches
        self._distribute = bool(distribute)
        self._lockstep = _Lockstep(self.devices)
        # the global tree, built node by node in lockstep with the shards'
        self._gtree = _GlobalTree(global_grid, integrator, gas_cfg, device=self.device,
                                  dtype=dtype, dust_cfg=dust_cfg, moving_patches=moving_patches)
        self.trees = []
        for k, dv in enumerate(self.devices):
            g = _local_grid_at(global_grid, S, k, d)
            self.trees.append(_ShardTree(
                self, k, g, integrator, gas_cfg, device=dv, dtype=dtype, dust_cfg=dust_cfg,
                sources_factory=sources_factory, diffusion_factory=diffusion_factory,
                bc_custom=bc_factory(g) if bc_factory else None, omf=omf,
                radiation_factory=radiation_factory, fused=fused,
                moving_patches=moving_patches, nbody=nbody))
        self._rad_solvers = {}
        for spec in sorted(patches or [], key=lambda s: s["level"]):
            self.add_patch(spec["level"], spec["lo"], spec["n"])
        self._compile(fused)

    # -- the MultiLevelSMR surface -----------------------------------------
    @property
    def nodes(self):
        return self.trees[0].nodes

    @property
    def root(self):
        return self.trees[0].root

    @property
    def global_nodes(self):
        return self._gtree.nodes

    @property
    def ic_grids(self):
        return [gn.grid for gn in self._gtree.nodes]

    @property
    def fused(self):
        return self.trees[0].fused

    @property
    def gather6(self):
        return self.trees[0].gather6

    @property
    def _gather6(self):
        return None

    @property
    def _sib_links(self):
        return self.trees[0]._sib_links

    @property
    def mask_bytes(self):
        return self._gtree.mask_bytes

    @property
    def stage_kernel(self) -> str:
        return f"{self.trees[0].stage_kernel} on each of {self.nshards} shards"

    def _links_static(self, node) -> bool:
        return self.trees[0]._links_static(node)

    def node_radiation(self, node):
        """The Radiation that steps ``node``: a node held in slabs steps on
        its shards' fields at once (``Sharded``; ``nshards`` is theirs)."""
        node = self.nodes[node.index]
        return self._rad_solvers.get(node, node.radiation)

    def _kind(self, gn) -> str:
        """How the shards hold the global tree's new node ``gn``."""
        d, S = self.axis_d, self.nshards
        parent = self.nodes[gn.parent.index]
        dep = {1: geo.x1dep, 2: geo.x2dep, 3: geo.x3dep}[d]
        if (self._distribute and not gn.wrap[d - 1] and not (gn.curv and dep(gn.grid.coords))
                and gn.active[d - 1] and not parent.replicated
                # an uneven split falls back to replication (Parthenon
                # redistributes any block count over ranks)
                and gn.n[d - 1] % S == 0 and (gn.n[d - 1] // S) % 2 == 0):
            return "distributed"
        if gn.wrap[d - 1]:
            if parent.replicated:
                raise ValueError("a wrap patch cannot nest inside a replicated (non-wrap) patch")
            if gn.n[d - 1] % S:
                raise ValueError(f"patch x{d} extent {gn.n[d - 1]} not divisible by {S} shards")
            return "wrap"
        return "replicated"

    def add_patch(self, level: int, lo, n, parent=None):
        """Register a patch in the global tree and in every shard's (the
        same index); returns the first shard's node."""
        gparent = None if parent is None else self._gtree.nodes[parent.index]
        gn = self._gtree.add_patch(level, lo, n, parent=gparent)
        try:
            kind = self._kind(gn)
        except ValueError:
            self._gtree.remove_patch(gn)
            raise
        for t in self.trees:
            t._add(gn, kind)
        node = self.nodes[gn.index]
        d = self.axis_d
        need = max(node.grid.ng[d - 1], node.rim[d - 1])
        if not node.replicated and self.nshards > 1 and node.grid.nx[d - 1] < need:
            self.remove_patch(node)
            raise ValueError(f"level-{node.level} node has {node.grid.nx[d - 1]} x{d} cells "
                             f"per shard; single-hop halo exchange needs >= {need}")
        return node

    def remove_patch(self, node):
        """Drop a leaf in the global tree and in every shard's."""
        i = node.index
        for t in self.trees:
            MultiLevelSMR.remove_patch(t, t.nodes[i])
        self._gtree.remove_patch(self._gtree.nodes[i])

    def topology(self):
        """The global tree's and every shard tree's ``topology()``."""
        return [t.topology() for t in (self._gtree, *self.trees)]

    def set_topology(self, snap):
        for t, topo in zip((self._gtree, *self.trees), snap):
            t.set_topology(topo)
        self._compile(self.fused, self.gather6)

    def _place_node(self, node, lo):
        gn = self._gtree.nodes[node.index]
        MultiLevelSMR._place_node(self._gtree, gn, lo)
        for t in self.trees:
            t._place(gn)

    def _compile(self, fused, gather6=True):
        """Re-run every tree's set-up (pool flags follow the first shard's)
        and build the sharded radiation of each node held in slabs."""
        for i, node in enumerate(self.nodes):
            for nd in [self._gtree.nodes[i]] + [t.nodes[i] for t in self.trees[1:]]:
                nd.pool = node.pool
        self._gtree._compile(False)
        for t in self.trees:
            t._compile(fused, gather6)
        old, self._rad_solvers = self._rad_solvers, {}
        if self.radiation_factory is None:
            return
        for i, node in enumerate(self.nodes):
            if node.replicated:
                continue
            rad = old.get(node)
            if rad is None:
                rads = [t.nodes[i].radiation for t in self.trees]
                rad = copy.copy(rads[0])
                rad._edge_dirichlet = {}
                rad.enable_sharding(self.axis_d, self.nshards,
                                    [Sharded([r.widths[c] for r in rads], self.axis_d)
                                     for c in range(3)])
            self._rad_solvers[node] = rad

    def _rad_solve_sharded(self, i, vals):
        """Node i's radiation step on its shards' fields at once: ``vals``
        are the shards' (state, ghost planes, dt); each gets its part."""
        rad = self._rad_solvers[self.nodes[i]]
        d = self.axis_d
        sts = [v[0] for v in vals]
        view = {"gas": {key: Sharded([st["gas"][key] for st in sts], d) for key in ("u", "w")},
                "rad": {"Er": Sharded([st["rad"]["Er"] for st in sts], d)}}
        ghs = [v[1] for v in vals]
        if ghs[0] is None:
            new = rad.step(view, vals[0][2])
        else:
            gh = {dd: tuple(Sharded([g[dd][j] for g in ghs], d) for j in (0, 1))
                  for dd in ghs[0]}
            new = rad.step(view, vals[0][2], ghosts=gh)
        new = rad.sync_gas(new)
        out = []
        for k, st in enumerate(sts):
            st = dict(st)
            st["gas"] = {key: new["gas"][key].parts[k] for key in ("u", "w")}
            st["rad"] = {"Er": new["rad"]["Er"].parts[k]}
            out.append(st)
        return out

    # -- global <-> shards -------------------------------------------------
    def _gather_node(self, shards, i):
        node = self.nodes[i]
        dev, d = self.device, self.axis_d
        if node.replicated:
            return {name: dict(kinds) for name, kinds in shards[0][i].items()}
        out = {}
        for name, kinds in shards[0][i].items():
            out[name] = {}
            for key in kinds:
                parts = [sh[i][name][key].to(dev) for sh in shards]
                out[name][key] = torch.cat(parts, dim=parts[0].ndim - d)
        return out

    def _split_node(self, i, st):
        """Global ``st`` of node i -> each shard's part (a replicated node's
        whole)."""
        node = self.nodes[i]
        d, S = self.axis_d, self.nshards
        out = []
        for k, dv in enumerate(self.devices):
            part = {}
            for name, kinds in st.items():
                part[name] = {}
                for key, v in kinds.items():
                    if v is None or key == "dtden":
                        continue
                    v = torch.as_tensor(v)
                    if not node.replicated:
                        n_l = v.shape[v.ndim - d] // S
                        v = _axis_slice(v, d, k * n_l, n_l)
                    part[name][key] = v.to(dv, copy=True).contiguous()
            out.append(part)
        return out

    def _as_states(self, states) -> TreeStates:
        if isinstance(states, TreeStates):
            return states
        shards = [[None] * len(states) for _ in self.devices]
        for i, st in enumerate(states):
            for k, part in enumerate(self._split_node(i, st)):
                shards[k][i] = part
        return TreeStates(self, shards)

    def root_state(self, states):
        return _RootView(self._as_states(states))

    def with_root(self, states, root_state):
        if isinstance(root_state, _RootView) and root_state.states is states:
            return states
        states = self._as_states(states)
        states[0] = {name: dict(kinds) for name, kinds in root_state.items()}
        return states

    # -- the step ------------------------------------------------------------
    def _particles(self):
        by_dev = {}
        for dv in self.devices:
            if dv not in by_dev:
                by_dev[dv] = self.nbody.particle_pytree(dv, self.dtype)
        return [by_dev[dv] for dv in self.devices]

    def _stage_inputs(self, states):
        """Each shard's per-node u at the start of a cycle."""
        return [[{fl: st[fl]["u"] for fl in st if fl != "rad"} for st in sh]
                for sh in self._as_states(states).shards]

    def _dts(self, dt):
        return [torch.as_tensor(dt, dtype=self.dtype).to(dv) for dv in self.devices]

    def _stage(self, states, u1s, dt, time, stage, particles=None):
        """One RK stage of every shard's tree in lockstep.  ``particles``:
        one per shard, or None.  Returns (states, the N-body force rows
        summed over the shards and levels, or None)."""
        shards, dts = self._as_states(states).shards, self._dts(dt)
        parts = particles if particles is not None else [None] * self.nshards
        outs = self._lockstep.run(lambda k: self.trees[k]._stage(
            shards[k], u1s[k], dts[k], time, stage, parts[k]))
        return TreeStates(self, [o[0] for o in outs]), outs[0][1]

    def _radiation_pass(self, states, dt):
        shards, dts = self._as_states(states).shards, self._dts(dt)
        return TreeStates(self, self._lockstep.run(
            lambda k: self.trees[k]._radiation_pass(shards[k], dts[k])))

    def step(self, states, dt: float, time: float):
        """One cycle over every shard: each RK stage in lockstep, the
        particles advanced on the host between the stages from the force
        rows summed over the shards and levels, then the radiation pass."""
        states = self._as_states(states)
        nb = self.nbody
        u1s = self._stage_inputs(states)
        nstages = self.integ.nstages
        if nb is not None:
            coeffs = nbody_coeffs(self.integ, float(dt))
            nb.begin_step()
        for stage in range(1, nstages + 1):
            parts = self._particles() if nb is not None else None
            states, pforce = self._stage(states, u1s, dt, time, stage, parts)
            if nb is not None:
                pf = (host_read(pforce, "nbody_force").astype(np.float64)
                      if pforce is not None else np.zeros((nb.npart, 7)))
                nb.advance(pf, stage, nstages, float(time), coeffs)
        if self.radiation_factory is not None:
            states = self._radiation_pass(states, dt)
        return states

    def estimate_dt(self, states):
        """The minimum over every shard's tree dt (``pmin``), a 0-d tensor
        on the first shard's device."""
        shards = self._as_states(states).shards
        return torch.min(torch.stack([t.estimate_dt(sh).to(self.device)
                                      for t, sh in zip(self.trees, shards)]))

    def initialize(self, prims_per_node):
        """Each node's global prims split into the shards, then P2C on each
        shard's node and, with radiation, Er = a T^4.  A node without prims
        is prolonged from its parent by the global tree."""
        prims = list(prims_per_node)
        if any(pr is None for pr in prims):
            return self._as_states([self._with_er(st) for st in self._gtree.initialize(prims)])
        parts = [self._split_node(i, {fl: {"w": w} for fl, w in (
            pr.items() if isinstance(pr, dict) else [("gas", pr)])})
            for i, pr in enumerate(prims)]
        shards = []
        for k, tree in enumerate(self.trees):
            sts = []
            for node in tree.nodes:
                part = parts[node.index][k]
                st = {}
                for fl, cfg in node.fluids():
                    w = part[fl]["w"].to(dtype=self.dtype)
                    u, w = node.hydro.prim_to_cons(w, cfg)
                    st[fl] = {"u": u, "w": w}
                if node.radiation is not None:
                    st["rad"] = {"Er": initialize_radiation(st, self.cfg,
                                                            node.radiation.cfg)["Er"]}
                sts.append(st)
            shards.append(sts)
        return TreeStates(self, shards)

    def _with_er(self, st):
        if self.radiation_factory is None or "rad" in st:
            return st
        rcfg = self.trees[0].root.radiation.cfg
        st = dict(st)
        st["rad"] = {"Er": initialize_radiation(st, self.cfg, rcfg)["Er"]}
        return st

    # -- host-side passes on the global tree -------------------------------
    def _via_gtree(self, states, fn):
        """Run a host-side pass ``fn(global states)`` on the global tree,
        then give the shard trees its topology and positions and split the
        states it made afresh."""
        ts = self._as_states(states)
        gold = [ts[i] for i in range(len(ts))]
        before = list(self._gtree.nodes)
        lo_before = {gn: gn.lo for gn in before}
        gnew = fn(list(gold))
        gnodes = self._gtree.nodes
        if gnodes == before and all(gn.lo == lo_before[gn] for gn in gnodes) and all(
                a is b for a, b in zip(gnew, gold)):
            return ts
        live = set(gnodes)
        for i in sorted((j for j, gn in enumerate(before) if gn not in live), reverse=True):
            for t in self.trees:
                MultiLevelSMR.remove_patch(t, t.nodes[i])
        old_index = {gn: j for j, gn in enumerate(before)}
        for gn in gnodes:
            if gn not in old_index:
                kind = self._kind(gn)
                for t in self.trees:
                    t._add(gn, kind)
            elif gn.lo != lo_before[gn]:
                for t in self.trees:
                    t._place(gn)
        shards = [[None] * len(gnodes) for _ in self.devices]
        for i, gn in enumerate(gnodes):
            j = old_index.get(gn)
            if j is not None and gnew[i] is gold[j]:
                for k in range(self.nshards):
                    shards[k][i] = ts.shards[k][j]
        self._compile(self.fused, self.gather6)
        for i, gn in enumerate(gnodes):
            if shards[0][i] is None:
                for k, part in enumerate(self._split_node(i, self._with_er(gnew[i]))):
                    shards[k][i] = part
        return TreeStates(self, shards)

    def _no_curvilinear_moves(self, nodes, what):
        if any(nd.curv for nd in nodes):
            raise ValueError(f"curvilinear {what} moves are not supported on a sharded tree "
                             "(replicated-node frames are static)")

    def retag_criteria(self, states, criterion):
        self._no_curvilinear_moves(self.nodes, "adaptive patch")
        return self._via_gtree(states, lambda g: self._gtree.retag_criteria(g, criterion))

    def retag_user(self, states, fn):
        self._no_curvilinear_moves(self.nodes, "adaptive patch")
        return self._via_gtree(states, lambda g: self._gtree.retag_user(g, fn))

    def retag_particles(self, states, particle_nodes, positions):
        self._no_curvilinear_moves([self.nodes[i] for i in particle_nodes], "tracking-patch")
        return self._via_gtree(states, lambda g: self._gtree.retag_particles(
            g, particle_nodes, positions))

    def _move_patch(self, states, node, new_lo):
        self._no_curvilinear_moves([node], "adaptive patch")
        return self._via_gtree(states, lambda g: self._gtree._move_patch(
            g, self._gtree.nodes[node.index], new_lo))

    def regrid_tiles(self, states, criterion, tile, nbuf=1, tags_fn=None, numlevel=2,
                     forced=None):
        """``MultiLevelSMR.regrid_tiles`` on the global tree (the tags on the
        gathered root); spawned tiles are replicated nodes on every shard."""
        return self._via_gtree(states, lambda g: self._gtree.regrid_tiles(
            g, criterion, tile, nbuf=nbuf, tags_fn=tags_fn, numlevel=numlevel, forced=forced))
