"""Time integration driver (port of ``artemis_tpu/driver.py``, single level).

Equivalent of ``ArtemisDriver`` + Parthenon's ``EvolutionDriver``/
``LowStorageIntegrator`` (src/artemis_driver.cpp): a two-register low-storage
RK loop.  On the GPU each gas stage runs as one fused CUDA kernel where the
config allows: Cartesian source-free gas through ``ops.stage``, every other
supported grid (the disk decks, with rotating-frame torque, point gravity
and diffusion folded in) through ``ops.stage_curv``, whose halo comes from
one of three sources: the x1/x2 ic strips with x3 wrapped (the spherical
disk), all six face strips (the all-``ic`` Cartesian disk of the
radiation-hydro configuration), or a padded array.  Every other stage, and
every stage on the CPU, runs the composable tensor sequence, as the JAX
package runs its jnp path; on the GPU its Cartesian gas fluxes come from
the fused sweep kernel (``ops.sweeps``, one launch per direction), as the
JAX package's come from its Pallas sweep (the shearing box, and the gas of
a gas+dust run).  With radiation, the operator-split FLD step
(``radiation.Radiation``) follows the stages of every cycle.  With an
N-body system the step is host-coupled (``_host_step``): after each stage
the ``[npart, 7]`` back-reaction rows of ``NBodyGravity`` come to the host
(one read-back per stage) and the native integrator advances the particles
before the next stage reads them.

The JAX driver marches chunks of up to 256 cycles on the device inside a
``lax.while_loop``; this one is a host loop that reads dt back once per
cycle (``profiling.host_read``), with the same dt rules (2x growth limit,
tlim clamp, the ``(1 - 1e-12)`` end test) so cycle counts and times match.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from . import bc as bc_mod
from .geometry import geometry as geo
from .ops import stage as stage_mod
from .ops import stage_curv as curv_mod
from .ops import sweeps as sweep_mod
from .ops.hydro import FluidCfg, Hydro
from .profiling import host_read, span
from .sources import Gravity, RotatingFrame

BIG = 1.0e308

# set by the CLI's SIGTERM handler: evolve() finishes the current cycle and
# returns status "timeout" (the reference relies on Parthenon's signal
# handling; src/main.cpp)
STOP_REQUESTED = False


@dataclass(frozen=True)
class Integrator:
    """Two-register low-storage coefficients:
    u0 <- gam0*u0 + gam1*u1 + beta*dt*F(u0), per stage (Parthenon
    LowStorageIntegrator family: rk1, rk2, rk3, vl2)."""

    name: str
    gam0: Tuple[float, ...]
    gam1: Tuple[float, ...]
    beta: Tuple[float, ...]

    @property
    def nstages(self) -> int:
        return len(self.beta)

    @classmethod
    def make(cls, name: str) -> "Integrator":
        if name == "rk1":
            return cls(name, (0.0,), (1.0,), (1.0,))
        if name == "rk2":
            return cls(name, (0.0, 0.5), (1.0, 0.5), (1.0, 0.5))
        if name == "rk3":
            return cls(
                name,
                (0.0, 0.25, 2.0 / 3.0),
                (1.0, 0.75, 1.0 / 3.0),
                (1.0, 0.25, 2.0 / 3.0),
            )
        if name == "vl2":
            return cls(name, (0.0, 0.0), (1.0, 1.0), (0.5, 1.0))
        raise ValueError(f"unknown integrator {name!r}")


def nbody_coeffs(integ: Integrator, dt: float):
    """Derived stage-consistent N-body coupling integrator from the hydro
    low-storage coefficients (artemis_driver.cpp:71-87): gam0, gam1, beta
    per stage and the cycle's dt."""
    n = integ.nstages
    nbeta = [0.0] * n
    nbeta[0] = integ.beta[0]
    for s in range(2, n + 1):
        nbeta[s - 1] = integ.gam0[s - 1] * nbeta[s - 2] + integ.beta[s - 1]
    ngam0, ngam1 = [0.0] * n, [0.0] * n
    for s in range(1, n + 1):
        nbetam1 = nbeta[(s > 1) * (s - 2)]
        nfac = integ.beta[s - 1] / (integ.gam0[s - 1] * nbetam1
                                    + integ.beta[s - 1])
        ngam0[s - 1] = 0.0 if s == 1 else 1.0 - nfac
        ngam1[s - 1] = 1.0 if s == 1 else nfac
    return SimpleNamespace(gam0=ngam0, gam1=ngam1, beta=nbeta, dt=dt)


def apply_sources(srcs, state, fluxes, time, bdt, hyd, ctx):
    """The sources in order; those that read the particles (``needs_ctx``)
    get ``ctx`` and may leave their outputs in it."""
    for src in srcs:
        if getattr(src, "needs_ctx", False):
            state = src.apply(state, fluxes, time, bdt, hyd, ctx=ctx)
        else:
            state = src.apply(state, fluxes, time, bdt, hyd)
    return state


def curv_point_grav(grid, s_):
    """Fold mode of a central point-mass Gravity source in the curvilinear
    stage kernel ("sph", "cart" or "xyz"), or None when the source or
    geometry falls outside the kernel's gravity envelope (cf. the
    reference's point-mass branches, point_mass.cpp:70-105)."""
    if not (isinstance(s_, Gravity) and s_.gtype == "point"
            and (s_.sink_rate <= 0.0 or s_.sink_rad <= 0.0)):
        return None
    c_ = grid.coords
    if (geo.is_spherical(c_) and geo.is_axisymmetric(c_)) or c_ == "axisymmetric":
        return "sph"       # pure-radial branches (point_mass.cpp:70-105)
    if (c_ in ("spherical3D", "cylindrical") and grid.nx[1] > 1 and grid.nx[2] > 1
            and tuple(s_.pos) == (0.0, 0.0, 0.0)):
        return "cart"      # general cartesian branch at the origin
    if geo.is_cartesian(c_):
        return "xyz"       # r_vec from the coordinate rows; any mass position
    return None


class Driver:
    """Owns the stage sequence and the dt estimate of one single-level run.

    ``device``/``dtype`` place the geometry constants and the sources'
    fields; ``fused_stage=False`` keeps a CUDA run on the composable path
    with the tensor flux chain (the plain version the kernels, the sweep
    kernel included, are measured against).  ``diffusion``
    and ``radiation`` are factories ``fn(hydro) -> Diffusion`` and
    ``fn(hydro) -> Radiation``; ``nbody`` is the run's ``NBodySystem``,
    which makes every step host-coupled."""

    # a shard of a sharded run fills its halo from its neighbours' slabs
    # (``parallel.mesh``): no stage kernel wraps or gathers its own halo
    _exchanged = False

    def __init__(
        self,
        grid,
        integrator: Integrator,
        gas_cfg: Optional[FluidCfg],
        dust_cfg: Optional[FluidCfg] = None,
        sources=None,
        bc_custom: Optional[dict] = None,
        omf: float = 0.0,
        diffusion=None,
        nbody=None,
        radiation=None,
        *,
        device,
        dtype,
        fused_stage: bool = True,
    ):
        self.grid = grid
        self.nbody = nbody
        self.integrator = integrator
        self.device = torch.device(device)
        self.dtype = dtype
        self.hydro = Hydro(grid, gas_cfg, dust_cfg, device=self.device, dtype=dtype)
        self.gas_cfg = gas_cfg
        self.dust_cfg = dust_cfg
        self.bc_custom = bc_custom or {}
        self.sources = [s_.place(self.device, dtype) for s_ in (sources or [])]
        self.omf = omf  # rotating-frame rate for curvilinear flux sources
        self.diffusion = diffusion(self.hydro) if diffusion is not None else None
        self.radiation = radiation(self.hydro) if radiation is not None else None
        on_gpu = fused_stage and self.device.type == "cuda"
        # the Cartesian stage kernel: source-free gas
        self._fused_stage = (on_gpu and stage_mod.supported(grid, gas_cfg)
                             and dust_cfg is None and not self.sources
                             and self.diffusion is None)
        # the curvilinear stage kernel (the disk path), as the JAX driver
        # picks its K3/K4 (driver.py:196-252), in float32 and float64 alike;
        # dust keeps a run on the composable path
        self._curv = None
        if (on_gpu and not self._fused_stage and dust_cfg is None
                and curv_mod.supported_curv(grid, gas_cfg)):
            self._curv = self._make_curv_stage(grid, gas_cfg)
        # the composable path's gas fluxes: the fused sweep kernel (K9) on
        # the GPU; dust, and every fluid outside its envelope, keep the
        # tensor chain
        self._sweep = on_gpu

    def _make_curv_stage(self, grid, gas_cfg):
        """The CurvStage for this run, or None where the composable path
        must run: a flux-consuming source the kernel cannot fold, or
        diffusion rows that do not separate (Cartesian grids).  A full stage
        gathers its halo in-kernel where the JAX driver does
        (artemis_tpu/driver.py:230-252): the disk layout (x1/x2 ic, x3 periodic) from
        the x1/x2 strips, else an all-``ic`` layout from six face strips."""
        flux_srcs = [s_ for s_ in self.sources if getattr(s_, "uses_fluxes", False)]
        # the curvilinear RotatingFrame torque is folded into the kernel;
        # any other flux-consuming source forces the composable path
        if not all(isinstance(s_, RotatingFrame) and not s_.shearing_box
                   for s_ in flux_srcs):
            return None
        rest = [s_ for s_ in self.sources if s_ not in flux_srcs]
        gravity = gmode = None
        for s_ in rest:
            gmode = curv_point_grav(grid, s_)
            if gmode is not None:
                gravity = s_
                rest.remove(s_)
                break
        full = not rest
        strips = None
        # a shard's halo comes from its neighbours: the padded variant (K4)
        gather = full and not self._exchanged
        if gather and curv_mod.gather_supported(grid, gas_cfg, self.bc_custom):
            strips = curv_mod.prepare_gather_strips(
                grid, self.bc_custom["ic"].shard_caches[0])
        elif gather and curv_mod.gather6_supported(grid) and all(
                grid.bc[d] == ("ic", "ic") for d in range(3)):
            caches = getattr(self.bc_custom.get("ic"), "shard_caches", None)
            if caches and all((d, s_) in caches[0] for d in (1, 2, 3) for s_ in (0, 1)):
                strips = curv_mod.prepare_gather6_root_strips(grid, caches[0])
        try:
            cs = curv_mod.CurvStage(
                self.hydro, omf=self.omf, rotating=flux_srcs[0] if flux_srcs else None,
                gravity=gravity, gmode=gmode, diffusion=self.diffusion, full=full,
                strips=strips, bc_custom=self.bc_custom)
        except ValueError:
            return None
        # the sources the composable chain still applies after a partial stage
        self._curv_srcs = rest
        return cs

    @property
    def host_coupled(self) -> bool:
        """True when each step needs host-side work between stages."""
        return self.nbody is not None

    @property
    def stage_kernel(self) -> str:
        """Which stage kernel the GPU run launches ("none" off the GPU)."""
        if self._fused_stage:
            return "stage_cart"
        if self._curv is not None:
            if self._curv.full:
                return f"stage_curv ({self._curv.halo})"
            return "stage_curv (padded, partial)"
        if self._sweep and sweep_mod.sweep_supported(self.grid, self.gas_cfg, self.dtype):
            return "sweep"
        return "none"

    # ------------------------------------------------------------------
    def _fluids(self):
        out = []
        if self.gas_cfg is not None:
            out.append(("gas", self.gas_cfg))
        if self.dust_cfg is not None:
            out.append(("dust", self.dust_cfg))
        return out

    def _estimate_dt(self, state):
        dts = []
        for name, cfg in self._fluids():
            if name == "gas" and "dtden" in state["gas"]:
                dts.append(cfg.cfl / torch.max(state["gas"]["dtden"]))
                continue
            dt = self.hydro.estimate_dt(state[name]["w"], cfg)
            if name == "gas" and self.diffusion is not None:
                # cfl * min(advective, diffusive) (gas.cpp:435-468)
                dt = torch.minimum(dt, cfg.cfl * self.diffusion.estimate_dt(
                    state[name]["w"]))
            dts.append(dt)
        dt = torch.min(torch.stack(dts))
        if self.radiation is not None:
            dt = torch.clamp_max(dt, self.radiation.cfg.dt_rad)
        return dt

    def _sync_prims(self, state):
        """C2P + P2C re-sync on interior arrays, per fluid."""
        hyd = self.hydro
        new = dict(state)
        for name, cfg in self._fluids():
            w = hyd.cons_to_prim(state[name]["u"], cfg)
            u, w = hyd.prim_to_cons(w, cfg)
            new[name] = {"u": u, "w": w}
        return new

    def _stage_body(self, state, u1, dt, time, stage, particles=None):
        """One RK stage (the reference per-stage task list,
        artemis_driver.cpp:170-268).  ``dt`` is a 0-d tensor on the run's
        device, ``time`` the cycle's start time on the host, ``particles``
        the N-body particles on the device (or None).  Returns (state,
        pforce): the [npart, 7] back-reaction rows on the device, or None
        without N-body gravity."""
        hyd = self.hydro
        integ = self.integrator
        gam0 = integ.gam0[stage - 1]
        gam1 = integ.gam1[stage - 1]
        beta = integ.beta[stage - 1]
        force_pcm = (integ.name == "vl2") and stage == 1
        if self._fused_stage:
            u, w, dtden = stage_mod.stage(
                hyd, state["gas"]["w"], state["gas"]["u"], u1["gas"], gam0,
                gam1, beta, dt, force_pcm, self.bc_custom, w_pad=self._exchanged_fill(state))
            new_state = dict(state)
            # dtden: per-block CFL denominator maxima (estimate_dt takes the
            # max, skipping a full extra pass over w each cycle)
            new_state["gas"] = {"u": u, "w": w, "dtden": dtden}
            return new_state, None
        bdt = beta * dt
        ctx = {"particles": particles}
        if self._curv is not None:
            u, w, dtden = curv_mod.stage_curv(
                self._curv, state["gas"]["w"], state["gas"]["u"], u1["gas"], gam0,
                gam1, beta, dt, time, force_pcm, w_pad=self._exchanged_fill(state))
            new_state = dict(state)
            if self._curv.full:
                new_state["gas"] = {"u": u, "w": w, "dtden": dtden}
                return new_state, None
            # partial: the folded sources are in u; the composable chain
            # applies the rest
            new_state["gas"] = {"u": u, "w": w}
            new_state = apply_sources(self._curv_srcs, new_state, None, time, bdt, hyd, ctx)
            u = hyd.set_auxiliary(new_state["gas"]["u"], self.gas_cfg)
            new_state["gas"] = {"u": u, "w": new_state["gas"]["w"]}
            return self._sync_prims(new_state), ctx.get("pforce")
        new_state = dict(state)
        fluxes = {}
        for name, cfg in self._fluids():
            u, w = state[name]["u"], state[name]["w"]
            w_pad = self.fill_ghosts(w, name)
            fx = hyd.compute_fluxes(w_pad, cfg, force_pcm, kernel=self._sweep)
            fluxes[name] = fx
            u = hyd.apply_update(u, u1[name], fx, gam0, gam1, bdt)
            u = hyd.flux_source(u, w, fx, bdt, omf=self.omf)
            if name == "gas" and self.diffusion is not None:
                u = self.diffusion.update(u, w, self.diffusion.fluxes(w_pad), bdt)
            new_state[name] = {"u": u, "w": w}
        # external sources in reference task order
        # (gravity -> rotating frame -> drag -> cooling)
        new_state = apply_sources(self.sources, new_state, fluxes, time, bdt, hyd, ctx)
        # dual-energy sync for gas
        if self.gas_cfg is not None:
            u = hyd.set_auxiliary(new_state["gas"]["u"], self.gas_cfg)
            new_state["gas"] = {"u": u, "w": new_state["gas"]["w"]}
        return self._sync_prims(new_state), ctx.get("pforce")

    def fill_ghosts(self, w_int, fluid: str):
        """Interior prims -> padded prims."""
        return bc_mod.pad_and_fill(w_int, self.grid, fluid, self.bc_custom)

    def _exchanged_fill(self, state):
        """The gas's padded prims for a stage kernel on a shard (its
        exchanged fill), or None where the kernel makes its own halo."""
        return self.fill_ghosts(state["gas"]["w"], "gas") if self._exchanged else None

    # ------------------------------------------------------------------
    def initialize(self, state):
        """PostInitialization: P2C after the problem generator
        (fill_derived.cpp:283-287).  Prims arrive on the interior grid."""
        new = dict(state)
        for name, cfg in self._fluids():
            u, w = self.hydro.prim_to_cons(state[name]["w"], cfg)
            new[name] = {"u": u, "w": w}
        return self.prepare_state(new)

    def prepare_state(self, state):
        """Seed the one-element dtden on the fused paths, so the first dt
        comes from the same reduction as every later one."""
        curv_full = self._curv is not None and self._curv.full
        if not (self._fused_stage or curv_full) or "dtden" in state["gas"]:
            return state
        state = dict(state)
        state["gas"] = dict(state["gas"])
        w, cfg = state["gas"]["w"], self.gas_cfg
        if curv_full:
            dt0 = self.hydro.estimate_dt(w, cfg)
            if self.diffusion is not None:
                # the kernel folds the diffusive limit into dtden; the seed
                # must too, or the first dt can exceed it
                dt0 = torch.minimum(dt0, cfg.cfl * self.diffusion.estimate_dt(w))
            state["gas"]["dtden"] = (cfg.cfl / dt0).reshape(1)
        else:
            state["gas"]["dtden"] = torch.amax(self.hydro.dt_denominator(w, cfg)).reshape(1)
        return state

    def step(self, state, dt: float, time: float):
        """One cycle of all RK stages with the host-side ``dt``, starting at
        the host-side ``time``, then the operator-split radiation step
        (artemis_driver.cpp:111).  After radiation the state carries no
        ``dtden``: the stages' CFL maxima predate its energy change, so the
        next dt comes from w (the JAX package's fused loop keeps dtden in
        its carry here and cannot run this configuration; its jnp path
        takes dt from w as this does)."""
        if self.host_coupled:
            return self._host_step(state, dt, time)
        u1, dt_t = self._cycle_inputs(state, dt)
        for stage in range(1, self.integrator.nstages + 1):
            with span("stage"):
                state, _ = self._stage_body(state, u1, dt_t, time, stage)
        return self._radiation_step(state, dt_t)

    def _cycle_inputs(self, state, dt: float):
        """The cycle's second register (the stage-entry conserved fields)
        and its dt as a 0-d tensor on the run's device."""
        return ({name: state[name]["u"] for name, _ in self._fluids()},
                torch.full((), dt, dtype=self.dtype, device=self.device))

    def _particles(self, nb):
        """The N-body particles as the stage reads them, on the run's device."""
        return nb.particle_pytree(self.device, self.dtype)

    def _radiation_step(self, state, dt_t):
        if self.radiation is not None:
            with span("radiation"):
                state = self.radiation.sync_gas(self.radiation.step(state, dt_t))
        return state

    def _host_step(self, state, dt: float, time: float):
        """A step with host-side particle advances between stages
        (NBody::Advance pattern, nbody_advance.cpp:85-208): each stage's
        force rows come to the host once, and the next stage reads the
        advanced particles."""
        nb = self.nbody
        nstages = self.integrator.nstages
        coeffs = nbody_coeffs(self.integrator, float(dt))
        nb.begin_step()
        u1, dt_t = self._cycle_inputs(state, dt)
        for stage in range(1, nstages + 1):
            with span("stage"):
                state, pforce = self._stage_body(state, u1, dt_t, time, stage,
                                                 self._particles(nb))
            pf = (host_read(pforce, "nbody_force").astype(np.float64) if pforce is not None
                  else np.zeros((nb.npart, 7)))
            nb.advance(pf, stage, nstages, float(time), coeffs)
        return self._radiation_step(state, dt_t)

    def estimate_dt(self, state) -> float:
        return host_read(self._estimate_dt(state), "dt")


@dataclass
class SimTime:
    time: float = 0.0
    dt: float = BIG
    ncycle: int = 0
    tlim: float = 1.0
    nlim: int = -1
    # runaway-run guards (<parthenon/time> dt_min / dt_max,
    # doc/src/running.rst:46-56): halt when dt leaves [dt_min, dt_max]
    dt_min: float = 0.0
    dt_max: float = BIG
    # True when (time, dt) came from a checkpoint: the stored dt already had
    # the 2x growth limit applied when it was written, so the first resumed
    # cycle must use it as-is
    restored: bool = False


def interior_cells(driver) -> int:
    """The interior cells a cycle steps: every node's of a refinement tree
    (its topology as it stands), else the grid's."""
    smr = getattr(driver, "smr", None)
    if smr is None:
        return int(np.prod(driver.grid.nx))
    return sum(int(np.prod(node.grid.nx)) for node in smr.nodes)


def evolve(driver: Driver, state, tm: SimTime, observers=None, log_every: int = 0,
           deadline: Optional[float] = None):
    """Outer evolution loop (EvolutionDriver::Execute equivalent).

    ``observers``: callables (state, tm) -> None, invoked after each cycle
    (history output fires when a cycle crosses its next output time, the
    same crossing at which the JAX loop ends a chunk).  ``deadline``:
    wall-clock time (perf_counter) after which the loop stops with status
    "timeout" (the reference's -t walltime flag, src/main.cpp:108-138).
    Returns (state, tm, zone_cycles_per_sec, status): every node's
    interior cells stepped, over the loop's wall time.
    """
    observers = observers or []
    zone_cycles = 0
    t0 = _time.perf_counter()

    def set_global_dt(grow: bool = True):
        """Parthenon SetGlobalTimeStep semantics: at most doubles the previous
        dt, takes the global CFL minimum, clamps the next step to tlim."""
        dt = 2.0 * tm.dt if (grow and tm.dt < 0.1 * BIG) else tm.dt
        dt = min(dt, driver.estimate_dt(state))
        if tm.time < tm.tlim and (tm.tlim - tm.time) < dt:
            dt = tm.tlim - tm.time
        tm.dt = dt

    def check_dt_guards():
        """<parthenon/time> dt_min/dt_max runaway guards; NaN fails both."""
        if tm.time + tm.dt >= tm.tlim * (1.0 - 1e-12):
            return  # final tlim-clamped step may be arbitrarily small
        if not (tm.dt >= tm.dt_min and tm.dt <= tm.dt_max):
            raise RuntimeError(
                f"timestep dt={tm.dt:.6e} outside [dt_min={tm.dt_min:.6e}, "
                f"dt_max={tm.dt_max:.6e}] at cycle {tm.ncycle}, "
                f"t={tm.time:.6e} — halting (runaway run)")

    def unfinished():
        return (tm.time < tm.tlim * (1.0 - 1e-12)
                and (tm.nlim < 0 or tm.ncycle < tm.nlim))

    set_global_dt(grow=not tm.restored)
    tm.restored = False
    check_dt_guards()
    status = "complete"
    while unfinished():
        with span("cycle"):
            zone_cycles += interior_cells(driver)
            state = driver.step(state, tm.dt, tm.time)
            tm.time += tm.dt
            tm.ncycle += 1
            set_global_dt()
            check_dt_guards()
            for obs in observers:
                obs(state, tm)
        if log_every and tm.ncycle % log_every == 0:
            print(f"cycle={tm.ncycle} time={tm.time:.6e} dt={tm.dt:.6e}")
        timed_out = deadline is not None and _time.perf_counter() > deadline
        if (timed_out or STOP_REQUESTED) and unfinished():
            status = "timeout"
            break
    elapsed = _time.perf_counter() - t0
    zcps = zone_cycles / max(elapsed, 1e-30)
    return state, tm, zcps, status
