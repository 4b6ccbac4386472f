"""Time integration driver (a frozen copy of ``artemis_tpu_torch/driver.py``'s
plain path, the reference of the benchmark).

A two-register low-storage RK loop (``ArtemisDriver`` + Parthenon's
``EvolutionDriver``/``LowStorageIntegrator``, src/artemis_driver.cpp): every
stage runs the composable tensor sequence (ghost fill, fluxes, update, flux
sources, diffusion, external sources, the dual-energy sync, C2P/P2C).  With
radiation, the operator-split FLD step (``radiation.Radiation``) follows
the stages of every cycle.  The host loop reads dt back once per cycle,
with the 2x growth limit, the tlim clamp and the ``(1 - 1e-12)`` end test.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import bc as bc_mod
from .geometry import geometry as geo
from .ops.hydro import FluidCfg, Hydro
from .sources import Gravity

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
    fields.  ``diffusion`` and ``radiation`` are factories ``fn(hydro) ->
    Diffusion`` and ``fn(hydro) -> Radiation``."""

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
        radiation=None,
        *,
        device,
        dtype,
    ):
        self.grid = grid
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

    def _stage_body(self, state, u1, dt, time, stage):
        """One RK stage (the reference per-stage task list,
        artemis_driver.cpp:170-268).  ``dt`` is a 0-d tensor on the run's
        device, ``time`` the cycle's start time on the host."""
        hyd = self.hydro
        integ = self.integrator
        gam0 = integ.gam0[stage - 1]
        gam1 = integ.gam1[stage - 1]
        beta = integ.beta[stage - 1]
        force_pcm = (integ.name == "vl2") and stage == 1
        bdt = beta * dt
        ctx = {"particles": None}
        new_state = dict(state)
        fluxes = {}
        for name, cfg in self._fluids():
            u, w = state[name]["u"], state[name]["w"]
            w_pad = self.fill_ghosts(w, name)
            fx = hyd.compute_fluxes(w_pad, cfg, force_pcm)
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
        return self._sync_prims(new_state)

    def fill_ghosts(self, w_int, fluid: str):
        """Interior prims -> padded prims."""
        return bc_mod.pad_and_fill(w_int, self.grid, fluid, self.bc_custom)

    # ------------------------------------------------------------------
    def initialize(self, state):
        """PostInitialization: P2C after the problem generator
        (fill_derived.cpp:283-287).  Prims arrive on the interior grid."""
        new = dict(state)
        for name, cfg in self._fluids():
            u, w = self.hydro.prim_to_cons(state[name]["w"], cfg)
            new[name] = {"u": u, "w": w}
        return new

    def step(self, state, dt: float, time: float):
        """One cycle of all RK stages with the host-side ``dt``, starting at
        the host-side ``time``, then the operator-split radiation step
        (artemis_driver.cpp:111)."""
        u1, dt_t = self._cycle_inputs(state, dt)
        for stage in range(1, self.integrator.nstages + 1):
            state = self._stage_body(state, u1, dt_t, time, stage)
        return self._radiation_step(state, dt_t)

    def _cycle_inputs(self, state, dt: float):
        """The cycle's second register (the stage-entry conserved fields)
        and its dt as a 0-d tensor on the run's device."""
        return ({name: state[name]["u"] for name, _ in self._fluids()},
                torch.full((), dt, dtype=self.dtype, device=self.device))

    def _radiation_step(self, state, dt_t):
        if self.radiation is not None:
            state = self.radiation.sync_gas(self.radiation.step(state, dt_t))
        return state

    def estimate_dt(self, state) -> float:
        return float(self._estimate_dt(state))


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


def evolve(driver: Driver, state, tm: SimTime, observers=None, log_every: int = 0,
           deadline: Optional[float] = None):
    """Outer evolution loop (EvolutionDriver::Execute equivalent).

    ``observers``: callables (state, tm) -> None, invoked after each cycle
    (history output fires when a cycle crosses its next output time, the
    same crossing at which the JAX loop ends a chunk).  ``deadline``:
    wall-clock time (perf_counter) after which the loop stops with status
    "timeout" (the reference's -t walltime flag, src/main.cpp:108-138).
    Returns (state, tm, zone_cycles_per_sec, status).
    """
    observers = observers or []
    ncells = int(np.prod(driver.grid.nx))
    t0 = _time.perf_counter()
    cycles0 = tm.ncycle

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
    zcps = ncells * (tm.ncycle - cycles0) / max(elapsed, 1e-30)
    return state, tm, zcps, status
