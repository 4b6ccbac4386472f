"""Single-level multi-device runs: block decomposition along one grid axis
(port of ``artemis_tpu/parallel/mesh.py``).

Replaces the reference's MPI rank decomposition and Parthenon's ghost-buffer
exchange (SURVEY.md §2.7): the global grid is split into equal slabs along
one axis, one per entry of an explicit list of torch devices
(``make_device_mesh``).  One process drives every shard, as the JAX
package's single controller drives its ``shard_map``: ``ShardedDriver``
owns one port ``Driver`` per shard, built on that shard's own local grid
with its own sources, boundary fills, Hydro, diffusion, radiation and
curvilinear stage, and steps them in shard order.

Each RK stage first collects every shard's top and bottom ``nghost``
interior slabs along the sharded axis, and only then writes them into the
neighbours' padded arrays (periodic wrap between the last and the first
shard, as the JAX package's ``ppermute`` pairs do); then it fills the
physical boundaries of the unsharded axes, and those of the sharded axis on
the first and last shard only.  dt is the minimum over every shard, read to
the host once per cycle.  With radiation the FLD step runs on fields that
hold one tensor per shard (``Sharded``): stencil shifts take the
neighbour's boundary plane and the CG's dot products add the per-shard sums
in shard order.  With N-body gravity each shard's partial force rows are
summed in shard order before the one host read per stage; the particle
system stays replicated on the host.

The JAX package traces one program for every shard, so it needs lazy
per-shard views of precomputed fields (``ShardedZField``,
``_localize_obj_fields``, ``_localize_x3_fields``, ``localize_bc_caches``)
and a check that shared custom fills do not vary with the window
(``check_bc_x3_independent``).  A port shard builds its own fields and its
own fills on its own grid, so none of those is ported.

Kernels per shard: the periodic whole-stage kernel (K1) and the gather
halos (K3, K5a/K5b) wrap or gather their halo inside the kernel, so they
stay off on more than one shard, as the JAX package switches them off
(``parallel/mesh.py:344-352``).  A Cartesian box runs K2 on every shard
behind the exchanged fill, a curvilinear grid K4 (full or partial), on
x1/x2 shards too: each shard has its own coefficient rows, where the JAX
package keeps K4 only when every shard's rows are equal.  Sharded radiation
runs the tensor operator, as the JAX package gates its FLD kernels off
under sharding (``radiation.py:261-263``).

The same code runs four shards on the CPU, four on one card
(``shard_devices=["cuda:0"] * 4``) or one per card of a node.
"""

from __future__ import annotations

import copy
import dataclasses
from collections.abc import MutableMapping
from typing import Optional, Sequence

import numpy as np
import torch

from .. import bc as bc_mod
from ..driver import Driver
from ..geometry import geometry as geo


def make_device_mesh(n_devices: int, device="cpu", shard_devices: Optional[Sequence] = None):
    """The shards' torch devices: ``shard_devices`` as given, or every shard
    on the CPU, or one card each from ``device`` (a CUDA device) on.  Asking
    for more cards than are present raises: several shards go on one card
    only when ``shard_devices`` says so."""
    if shard_devices is not None:
        devs = [torch.device(d) for d in shard_devices]
        if len(devs) != n_devices:
            raise ValueError(f"{len(devs)} shard devices for {n_devices} shards")
        return devs
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * n_devices
    if dev.type != "cuda":
        raise ValueError(f"no sharded runs on device {dev}")
    first = dev.index or 0
    have = torch.cuda.device_count()
    if first + n_devices > have:
        raise ValueError(f"{n_devices} shards from {dev} need cards {first}.."
                         f"{first + n_devices - 1}, {have} present; pass shard_devices=[...] "
                         "to place several shards on one card")
    return [torch.device("cuda", first + i) for i in range(n_devices)]


def _local_grid_at(grid, nshards: int, shard: int, d: int = 3):
    """Shard-local Grid with the x_d window of the given shard."""
    nd = grid.nx[d - 1]
    if nd % nshards != 0:
        raise ValueError(f"nx{d}={nd} not divisible by {nshards} shards")
    n_l = nd // nshards
    dxd = (grid.xmax[d - 1] - grid.xmin[d - 1]) / nd
    ngd = grid.nghost if nd > 1 else 0
    if nshards > 1 and n_l < max(2, ngd):
        raise ValueError(
            f"need >= max(2, nghost)={max(2, ngd)} x{d} cells per shard for "
            f"single-hop halo exchange, got {n_l}")
    x0 = grid.xmin[d - 1] + dxd * n_l * shard
    xf = x0 + dxd * np.arange(-ngd, n_l + ngd + 1, dtype=np.float64)
    faces = [grid.geom.xf1, grid.geom.xf2, grid.geom.xf3]
    faces[d - 1] = xf
    geom = geo.build_geometry(grid.coords, *faces)
    nx = list(grid.nx)
    nx[d - 1] = n_l
    xmin = list(grid.xmin)
    xmax = list(grid.xmax)
    xmin[d - 1] = x0
    xmax[d - 1] = x0 + dxd * n_l
    return dataclasses.replace(
        grid, nx=tuple(nx), xmin=tuple(xmin), xmax=tuple(xmax), geom=geom)


def _only_d(grid, d: int, inner: bool):
    """Grid with only the requested x_d physical boundary active."""
    bd = grid.bc[d - 1]
    bcd = (bd[0], "none") if inner else ("none", bd[1])
    bc = [("none", "none")] * 3
    bc[d - 1] = bcd
    return dataclasses.replace(grid, bc=tuple(bc))


def _axis_slice(t, d, start, length):
    return t.narrow(t.ndim - d, start, length)


# ---------------------------------------------------------------------------
# fields with one tensor per shard (the sharded radiation step's fields)
# ---------------------------------------------------------------------------

# reductions over the whole sharded field when called without a dimension,
# each with the operation that combines two shards' results
_GLOBAL = {torch.sum: torch.add, torch.max: torch.maximum, torch.amax: torch.maximum,
           torch.min: torch.minimum, torch.amin: torch.minimum}
# functions that reduce, scan, move or join values along a dimension, each
# with the position of that dimension among the positional arguments and its
# default: shard by shard only along another axis than the sharded one
_ALONG = {f: (1, None) for f in (
    torch.sum, torch.max, torch.amax, torch.min, torch.amin, torch.mean, torch.prod,
    torch.any, torch.all, torch.std, torch.var, torch.argmax, torch.argmin,
    torch.count_nonzero, torch.nansum, torch.logsumexp, torch.median, torch.cumsum,
    torch.cumprod, torch.flip, torch.narrow)}
# (a dot product names no dimension)
_ALONG.update({torch.dot: (2, None), torch.vdot: (2, None), torch.roll: (2, None),
               torch.diff: (2, -1), torch.norm: (2, None), torch.linalg.norm: (2, None), torch.linalg.vector_norm: (2, None),
               torch.cat: (1, 0), torch.stack: (1, 0)})
# those that drop the reduced dimensions (unless ``keepdim``)
_REDUCING = set(_ALONG) - {torch.cumsum, torch.cumprod, torch.flip, torch.narrow, torch.roll,
                           torch.diff, torch.cat, torch.stack}
# the Tensor methods that name one of those (``x.sum()`` is ``torch.sum(x)``)
_ALONG_METHODS = {f.__name__ for f in _ALONG if hasattr(torch.Tensor, f.__name__)}
# functions and methods that change the layout (the sharded axis would lose
# its place) and those that give host values
_LAYOUT = {"reshape", "view", "flatten", "ravel", "permute", "transpose", "movedim",
           "squeeze", "unsqueeze", "item", "tolist", "numpy"}
# attributes that are the same on every shard
_SAME = {"dtype", "ndim", "device", "is_cuda", "layout", "requires_grad"}


def _check_along(func, args, kwargs, ref) -> int:
    """The sharded axis ``d`` of ``func``'s shard-by-shard result, where it
    means what ``func`` means on the whole field: a dimension is named and
    none of them is the sharded axis (a binary max/min is elementwise; a
    stacked axis must not fall after the sharded one).  Else raise."""
    if func in (torch.max, torch.min) and len(args) > 1 and (
            torch.is_tensor(args[1]) or isinstance(args[1], Sharded)):
        return ref.d
    pos, dims = _ALONG[func]
    dims = next((kwargs[k] for k in ("dim", "dims", "axis") if k in kwargs),
                args[pos] if len(args) > pos else dims)
    if dims is None:
        raise NotImplementedError(
            f"{func.__name__} of a sharded field: only {sorted(f.__name__ for f in _GLOBAL)} "
            "of one field without other arguments reduce over every shard")
    ndim = ref.parts[0].ndim
    ax = ndim - ref.d
    dims = dims if isinstance(dims, (tuple, list)) else (dims,)
    for dim in dims:
        if (dim % (ndim + 1) > ax) if func is torch.stack else (dim % ndim == ax):
            raise NotImplementedError(
                f"{func.__name__} along the sharded axis x{ref.d} of a sharded field")
    if func not in _REDUCING:
        return ref.d
    if "keepdim" not in kwargs and len(args) > pos + 1:
        raise NotImplementedError(f"{func.__name__} of a sharded field: pass keepdim by name")
    if kwargs.get("keepdim", False):
        return ref.d
    # each reduced axis after the sharded one moves it one place to the end
    return ref.d - sum(dim % ndim > ax for dim in dims)


def _key_axis(key, ndim, d):
    """The entry of an index ``key`` that falls on axis ``ndim - d``, or
    ``slice(None)`` where none does; a tensor key raises."""
    key = key if isinstance(key, tuple) else (key,)
    if any(torch.is_tensor(k) or isinstance(k, Sharded) or k is None for k in key):
        raise NotImplementedError("tensor, mask or new-axis index of a sharded field")
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (ndim - len(key) + 1) + key[i + 1:]
    ax = ndim - d
    return key[ax] if 0 <= ax < len(key) else slice(None)


def _cols(obj, parts):
    """``obj`` for each of ``parts``: its own parts, a plain tensor on each
    part's device, or the value itself."""
    if isinstance(obj, Sharded):
        return obj.parts
    if torch.is_tensor(obj):
        return [obj if obj.device == p.device else obj.to(p.device) for p in parts]
    return [obj] * len(parts)


def _part(obj, i, device):
    """``obj`` as shard i sees it: its part of a Sharded, a plain tensor on
    the shard's device, containers element by element."""
    if isinstance(obj, Sharded):
        return obj.parts[i]
    if torch.is_tensor(obj):
        return obj if obj.device == device else obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_part(v, i, device) for v in obj)
    if isinstance(obj, dict):
        return {k: _part(v, i, device) for k, v in obj.items()}
    return obj


class Sharded:
    """One tensor per shard of a field split along grid axis ``d``: torch
    functions and operators apply shard by shard (plain tensors and numbers
    broadcast into every shard), except that ``torch.sum``, ``max``,
    ``amax``, ``min`` and ``amin`` of one field without other arguments
    (and the same methods) reduce over the whole field, in shard order, to
    a 0-d tensor on the first shard's device.  ``shape`` is the whole
    field's; ``dtype``, ``device``, ``ndim`` are the first shard's.  A call
    that would mean another thing shard by shard than on the whole field
    raises: any other reduction, a scan, roll or index along the sharded
    axis, a reduction without a dimension, a change of layout (``reshape``,
    ``permute``, ...), a result that is not a tensor (``numel()``,
    ``item()``) or the field's truth value."""

    __slots__ = ("parts", "d")

    def __init__(self, parts, d: int):
        self.parts = list(parts)
        self.d = d

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ref = next(a for a in _flat([*args, *kwargs.values()]) if isinstance(a, Sharded))
        if getattr(func, "__name__", None) in _LAYOUT:
            raise NotImplementedError(f"{func.__name__} of a sharded field")
        if func in _GLOBAL and len(args) == 1 and not kwargs:
            out = func(ref.parts[0])
            for p in ref.parts[1:]:
                out = _GLOBAL[func](out, func(p).to(out.device))
            return out
        d = _check_along(func, args, kwargs, ref) if func in _ALONG else ref.d
        if not kwargs and not any(isinstance(a, (list, tuple, dict)) for a in args):
            # the common case, kept cheap: the CG loop is launch-bound
            return _wrap([func(*xs) for xs in zip(*(_cols(a, ref.parts) for a in args))],
                         d, func)
        outs = [func(*_part(args, i, p.device), **_part(kwargs, i, p.device))
                for i, p in enumerate(ref.parts)]
        return _wrap(outs, d, func)

    def _map(self, name, *args, **kwargs):
        return _wrap([getattr(p, name)(*_part(args, i, p.device), **_part(kwargs, i, p.device))
                      for i, p in enumerate(self.parts)], self.d, name)

    @property
    def shape(self):
        p = self.parts[0]
        if p.ndim < self.d:
            raise NotImplementedError(f"shape of a sharded field without axis x{self.d}")
        ax = p.ndim - self.d
        return p.shape[:ax] + (sum(q.shape[ax] for q in self.parts),) + p.shape[ax + 1:]

    def __getattr__(self, name):
        if name in _ALONG_METHODS:
            return lambda *args, **kwargs: getattr(torch, name)(self, *args, **kwargs)
        if name in _LAYOUT:
            raise NotImplementedError(f"{name} of a sharded field")
        attr = getattr(self.parts[0], name)
        if callable(attr):
            return lambda *args, **kwargs: self._map(name, *args, **kwargs)
        if torch.is_tensor(attr):
            return _wrap([getattr(p, name) for p in self.parts], self.d, name)
        if name not in _SAME:
            raise NotImplementedError(f"{name} of a sharded field")
        return attr

    def __bool__(self):
        raise TypeError("the truth value of a sharded field")

    def __getitem__(self, key):
        if _key_axis(key, self.parts[0].ndim, self.d) != slice(None):
            raise NotImplementedError(f"index along the sharded axis x{self.d}: {key}")
        return self._map("__getitem__", key)

    def __setitem__(self, key, value):
        if _key_axis(key, self.parts[0].ndim, self.d) != slice(None):
            raise NotImplementedError(f"index along the sharded axis x{self.d}: {key}")
        for i, p in enumerate(self.parts):
            p[key] = _part(value, i, p.device)

    def shift(self, d: int, sign: int):
        """``ops.fld.shift`` along the sharded axis: each shard's values at
        the neighbour +sign, the wrapped plane taken from the neighbouring
        shard (the last shard's from the first, and back)."""
        n = len(self.parts)
        out = []
        for i, p in enumerate(self.parts):
            m = p.shape[p.ndim - d]
            if sign > 0:
                nb = self.parts[(i + 1) % n]
                out.append(torch.cat([_axis_slice(p, d, 1, m - 1),
                                      _axis_slice(nb, d, 0, 1).to(p.device)], dim=p.ndim - d))
            else:
                nb = self.parts[(i - 1) % n]
                mn = nb.shape[nb.ndim - d]
                out.append(torch.cat([_axis_slice(nb, d, mn - 1, 1).to(p.device),
                                      _axis_slice(p, d, 0, m - 1)], dim=p.ndim - d))
        return Sharded(out, self.d)

    def edge_masks(self, d: int):
        """``ops.fld.edge_masks`` along the sharded axis: the first shard
        holds the lower physical edge, the last the upper one."""
        firsts, lasts = [], []
        n = len(self.parts)
        for i, p in enumerate(self.parts):
            ax = p.ndim - d
            m = p.shape[ax]
            idx = torch.arange(m, device=p.device).reshape(
                [m if k == ax else 1 for k in range(p.ndim)])
            firsts.append((idx == 0) & (i == 0))
            lasts.append((idx == m - 1) & (i == n - 1))
        return Sharded(firsts, self.d), Sharded(lasts, self.d)


def _flat(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _flat(a)
        else:
            yield a


def _wrap(outs, d, what):
    if torch.is_tensor(outs[0]):
        return Sharded(outs, d)
    if isinstance(outs[0], tuple):
        return tuple(_wrap(list(o), d, what) for o in zip(*outs))
    raise NotImplementedError(f"{getattr(what, '__name__', what)} of a sharded field gives "
                              f"{type(outs[0]).__name__} per shard")


def _binop(name):
    op = getattr(torch.Tensor, name)

    def binop(self, other):
        return Sharded([op(p, q) for p, q in zip(self.parts, _cols(other, self.parts))],
                       self.d)

    return binop


for _name in ("add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv", "pow",
              "rpow", "gt", "ge", "lt", "le", "eq", "ne", "and", "or", "xor"):
    setattr(Sharded, f"__{_name}__", _binop(f"__{_name}__"))
for _name in ("neg", "invert", "abs"):
    setattr(Sharded, f"__{_name}__", lambda self, _n=_name: self._map(f"__{_n}__"))
Sharded.__hash__ = None


# ---------------------------------------------------------------------------
# the sharded state
# ---------------------------------------------------------------------------

class ShardedState(MutableMapping):
    """A sharded run's state: ``shards[i]`` is shard i's ``{name: {key:
    tensor}}``.  Read by name (``state["gas"]["w"]``), it gathers the global
    arrays with the unsharded layout on the first shard's device, once per
    state: the outputs, the history, the analysis hooks and the tests read a
    sharded run as an unsharded one, and only when they read it.  Set by
    name, it splits global arrays into the shards."""

    def __init__(self, driver: "ShardedDriver", shards):
        self.driver = driver
        self.shards = shards
        self._global = {}

    def __getitem__(self, name):
        if name not in self._global:
            self._global[name] = self.driver.gather(self.shards, name)
        return self._global[name]

    def __setitem__(self, name, kinds):
        for st, part in zip(self.shards, self.driver.split(name, kinds)):
            st[name] = part
        self._global.pop(name, None)

    def __delitem__(self, name):
        for st in self.shards:
            del st[name]
        self._global.pop(name, None)

    def __iter__(self):
        return iter(self.shards[0])

    def __len__(self):
        return len(self.shards[0])

    def clone(self):
        return ShardedState(self.driver, [{n: {k: v.clone() for k, v in kinds.items()}
                                           for n, kinds in st.items()} for st in self.shards])


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

class _ShardDriver(Driver):
    """One shard's Driver: its fill takes the neighbours' slabs along the
    sharded axis (``halo``, set before each stage) and the physical
    boundaries of that axis only where the shard holds them."""

    def __init__(self, index, nshards, axis_d, *args, **kwargs):
        self.index, self.nshards, self.axis_d = index, nshards, axis_d
        self._exchanged = nshards > 1
        # fluid -> (slab from below, slab from above)
        self.halo = {}
        super().__init__(*args, **kwargs)

    def fill_ghosts(self, w_int, fluid: str):
        if not self._exchanged:
            return super().fill_ghosts(w_int, fluid)
        grid, d = self.grid, self.axis_d
        gd, n_l = grid.ng[d - 1], grid.nx[d - 1]
        w_pad = bc_mod.pad_prims(w_int, grid)
        sl = [slice(None)] * w_pad.ndim
        for c in (1, 2, 3):
            if c != d:
                sl[w_pad.ndim - c] = slice(grid.ng[c - 1], grid.ng[c - 1] + grid.nx[c - 1])
        below, above = self.halo[fluid]
        sl[w_pad.ndim - d] = slice(0, gd)
        w_pad[tuple(sl)] = below
        sl[w_pad.ndim - d] = slice(gd + n_l, None)
        w_pad[tuple(sl)] = above
        bc = list(grid.bc)
        bc[d - 1] = ("none", "none")
        w_pad = bc_mod.fill_ghosts(w_pad, dataclasses.replace(grid, bc=tuple(bc)), fluid,
                                   self.bc_custom)
        if grid.bc[d - 1][0] != "periodic":
            if self.index == 0:
                w_pad = bc_mod.fill_ghosts(w_pad, _only_d(grid, d, inner=True), fluid,
                                           self.bc_custom)
            if self.index == self.nshards - 1:
                w_pad = bc_mod.fill_ghosts(w_pad, _only_d(grid, d, inner=False), fluid,
                                           self.bc_custom)
        return w_pad


class ShardedDriver(Driver):
    """A single-level run decomposed along grid axis ``axis`` (1..3) over
    ``devices`` (one entry per shard; ``make_device_mesh``).  Every shard
    gets its own Driver on its local grid: ``sources_factory(local_grid)``
    and ``bc_factory(local_grid)`` build its sources and custom fills, and
    the diffusion and radiation factories its operators.  The state is a
    ``ShardedState``; the Driver surface that ``evolve``, the outputs and
    the profiler use (``step``, ``estimate_dt``, ``_cycle_inputs``,
    ``_stage_body``, ``_radiation_step``, ``_estimate_dt``) takes it
    whole.  ``grid`` is the global grid."""

    def __init__(self, grid, integrator, gas_cfg, dust_cfg=None, sources_factory=None,
                 bc_factory=None, omf: float = 0.0, diffusion=None, axis: int = 3,
                 radiation=None, nbody=None, *, devices, dtype, fused_stage: bool = True):
        # Driver.__init__ builds one grid's operators; every shard's are
        # built by its own Driver below
        self.axis_d = int(axis)
        if self.axis_d not in (1, 2, 3):
            raise ValueError(f"shard axis {axis} not in 1..3")
        self.devices = [torch.device(dv) for dv in devices]
        self.nshards = n = len(self.devices)
        self.grid = self.global_grid = grid
        self.integrator = integrator
        self.gas_cfg, self.dust_cfg = gas_cfg, dust_cfg
        self.nbody = nbody
        self.dtype = dtype
        self.device = self.devices[0]
        grids = [_local_grid_at(grid, n, i, self.axis_d) for i in range(n)]
        self.drivers = [
            _ShardDriver(i, n, self.axis_d, g, integrator, gas_cfg, dust_cfg,
                         sources=sources_factory(g) if sources_factory else None,
                         bc_custom=bc_factory(g) if bc_factory else None, omf=omf,
                         diffusion=diffusion, nbody=nbody, radiation=radiation,
                         device=dv, dtype=dtype, fused_stage=fused_stage)
            for i, (g, dv) in enumerate(zip(grids, self.devices))]
        d0 = self.drivers[0]
        self.hydro, self.sources, self.diffusion = d0.hydro, d0.sources, d0.diffusion
        self.radiation = d0.radiation
        if self.radiation is not None and n > 1:
            # one Radiation steps every shard's fields (its widths, one
            # tensor per shard, from the shards' own)
            rads = [drv.radiation for drv in self.drivers]
            self.radiation = copy.copy(rads[0])
            self.radiation._edge_dirichlet = {}
            self.radiation.enable_sharding(
                self.axis_d, n, [Sharded([r.widths[k] for r in rads], self.axis_d)
                                 for k in range(3)])

    @property
    def stage_kernel(self) -> str:
        return f"{self.drivers[0].stage_kernel} on each of {self.nshards} shards"

    # -- global <-> shards ----------------------------------------------------
    def split(self, name, kinds):
        """One global ``{key: array}`` -> per shard ``{key: tensor}`` on the
        shard's device.  ``dtden`` (the fused stages' CFL maxima) goes whole
        to every shard as its maximum: dt takes the maximum over shards."""
        n_l = self.global_grid.nx[self.axis_d - 1] // self.nshards
        out = []
        for i, dv in enumerate(self.devices):
            part = {}
            for k, v in kinds.items():
                if v is None:
                    part[k] = None
                    continue
                v = torch.as_tensor(v)
                if k == "dtden":
                    part[k] = torch.amax(v).reshape(1).to(dv)
                else:
                    part[k] = _axis_slice(v, self.axis_d, i * n_l, n_l).contiguous().to(dv)
            out.append(part)
        return out

    def gather(self, shards, name):
        """The global ``{key: tensor}`` of ``name`` on the first shard's
        device (``dtden``: the maximum over shards, one element)."""
        dev = self.devices[0]
        out = {}
        for k in shards[0][name]:
            parts = [st[name][k].to(dev) for st in shards]
            if k == "dtden":
                out[k] = torch.amax(torch.stack([torch.amax(p) for p in parts])).reshape(1)
            else:
                out[k] = torch.cat(parts, dim=parts[0].ndim - self.axis_d)
        return out

    def _shards_of(self, state):
        if isinstance(state, ShardedState):
            return state.shards
        parts = {name: self.split(name, kinds) for name, kinds in state.items()}
        return [{name: parts[name][i] for name in state} for i in range(self.nshards)]

    def initialize(self, state):
        """Split the problem generator's global prims into the shards and
        run P2C on each (PostInitialization)."""
        return ShardedState(self, [drv.initialize(st) for drv, st in
                                   zip(self.drivers, self._shards_of(state))])

    def prepare_state(self, state):
        """A global state (a checkpoint's) or a sharded one, each shard
        seeded for its fused stages."""
        return ShardedState(self, [drv.prepare_state(st) for drv, st in
                                   zip(self.drivers, self._shards_of(state))])

    # -- the stage ------------------------------------------------------------
    def _exchange(self, shards):
        """Collect every shard's top and bottom ``nghost`` interior slabs
        along the sharded axis, then hand each shard the slabs of its
        neighbours (the last shard's top wraps to the first)."""
        n, d = self.nshards, self.axis_d
        if n == 1:
            return
        g = self.global_grid.ng[d - 1]
        for name, _ in self._fluids():
            tops, bots = [], []
            for st in shards:
                w = st[name]["w"]
                m = w.shape[w.ndim - d]
                tops.append(_axis_slice(w, d, m - g, g))
                bots.append(_axis_slice(w, d, 0, g))
            for i, drv in enumerate(self.drivers):
                drv.halo[name] = (tops[(i - 1) % n].to(drv.device),
                                  bots[(i + 1) % n].to(drv.device))

    def _cycle_inputs(self, state, dt: float):
        ins = [drv._cycle_inputs(st, dt) for drv, st in zip(self.drivers, state.shards)]
        return [u1 for u1, _ in ins], [dt_t for _, dt_t in ins]

    def _particles(self, nb):
        by_dev = {}
        for dv in self.devices:
            if dv not in by_dev:
                by_dev[dv] = nb.particle_pytree(dv, self.dtype)
        return [by_dev[dv] for dv in self.devices]

    def _stage_body(self, state, u1, dt, time, stage, particles=None):
        """One RK stage on every shard behind the exchanged fill.  Returns
        (state, pforce): the N-body force rows summed over the shards in
        shard order on the first shard's device, or None."""
        self._exchange(state.shards)
        shards, pforce = [], None
        for i, (drv, st) in enumerate(zip(self.drivers, state.shards)):
            st, pf = drv._stage_body(st, u1[i], dt[i], time, stage,
                                     None if particles is None else particles[i])
            shards.append(st)
            if pf is not None:
                pf = pf.to(self.devices[0])
                pforce = pf if pforce is None else pforce + pf
        return ShardedState(self, shards), pforce

    def _radiation_step(self, state, dt):
        if self.radiation is None:
            return state
        if self.nshards == 1:
            return ShardedState(self, [self.drivers[0]._radiation_step(state.shards[0], dt[0])])
        d = self.axis_d
        view = {"gas": {k: Sharded([st["gas"][k] for st in state.shards], d)
                        for k in ("u", "w")},
                "rad": {"Er": Sharded([st["rad"]["Er"] for st in state.shards], d)}}
        new = self.radiation.sync_gas(self.radiation.step(view, dt[0]))
        shards = []
        for i, st in enumerate(state.shards):
            st = dict(st)
            st["gas"] = {k: new["gas"][k].parts[i] for k in ("u", "w")}
            st["rad"] = {"Er": new["rad"]["Er"].parts[i]}
            shards.append(st)
        return ShardedState(self, shards)

    def _estimate_dt(self, state):
        """The minimum over every shard's dt (fluids, diffusion, dt_rad), a
        0-d tensor on the first shard's device."""
        dts = [drv._estimate_dt(st).to(self.devices[0])
               for drv, st in zip(self.drivers, state.shards)]
        return torch.min(torch.stack(dts))
