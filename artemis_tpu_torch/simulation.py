"""Top-level simulation assembly (reference: src/artemis.cpp ProcessPackages
+ src/main.cpp LaunchWorkFlow; port of ``artemis_tpu/simulation.py`` on one
device).

Reads the input deck, builds the gas and dust fluids, the problem
generator, the source packages
(gravity, rotating frame, beta cooling, drag and damping zones,
viscosity/conduction, gray FLD radiation, the N-body system) and the
driver on the requested device, starts from the problem generator or a
restart checkpoint, and runs the evolution loop with the deck's outputs
(``.hst`` history, ``hdf5`` field dumps, ``rst`` checkpoints, the N-body
``.reb``/``.orb`` files).  ``nshards > 1`` decomposes a single-level run
along one axis (``<parthenon/mesh> shard_axis = auto | x1 | x2 | x3``) over
``nshards`` devices (``parallel.mesh``): every shard on the CPU, one card
each, or the shards named by ``shard_devices``.  A refinement tree shards
every level along a periodic axis (``parallel.amr``; ``<artemis>
amr_distribute`` splits the patches that do not span it).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .config import ParameterInput
from .driver import Driver, Integrator, SimTime, evolve
from .eos import eos_from_input
from .grid import grid_from_input
from .io.dumps import FieldOutput, RestartOutput, _next_boundary, load_restart
from .ops.hydro import FluidCfg
from .pgen import build_problem
from .sources import Drag, Gravity, sources_from_input
from .units import Constants, Units


def dtype_from_input(pin) -> torch.dtype:
    """<artemis> precision = float64 (default) | float32."""
    prec = pin.get_or_add_str("artemis", "precision", "float64")
    if prec == "float64":
        return torch.float64
    if prec == "float32":
        return torch.float32
    raise ValueError(f"unknown precision {prec!r}")


def _damp_to_visc(srcs, visc):
    """Damping zones with damp_to_visc relax the gas toward the viscous
    inflow of the gas viscosity model (drag.cpp:109-121), which they
    require."""
    for s in srcs:
        if isinstance(s, Drag) and s.gasp.damp_to_visc:
            if visc is None:
                raise ValueError("damp_to_visc requires gas viscosity "
                                 "(drag.cpp:109-121)")
            s.set_viscosity(visc)


class _NBodyOutputs:
    """Writes the N-body .reb/.orb files at the <nbody> dt_output cadence
    (cf. NBody::Outputs, nbody_outputs.cpp)."""

    def __init__(self, sim):
        self.sim = sim
        self.dt_out = sim.pin.get_or_add_real("nbody", "dt_output", 1.0e300)
        self.pid = sim.pin.get_or_add_str("parthenon/job", "problem_id", "artemis")
        self.next = 0.0

    def start(self, state, tm):
        self.sim.nbody.write_outputs(self.sim.data_dir, self.pid, tm.time)
        self.next = self.dt_out

    def resume(self, state, tm):
        self.next = _next_boundary(tm.time, self.dt_out)

    def __call__(self, state, tm):
        if tm.time >= self.next * (1.0 - 1e-12):
            self.sim.nbody.write_outputs(self.sim.data_dir, self.pid, tm.time)
            self.next = _next_boundary(tm.time, self.dt_out)

    @property
    def next_time(self):
        return self.next


class Simulation:
    def __init__(
        self,
        deck: str,
        overrides: Sequence[str] = (),
        data_dir: str = ".",
        is_path: Optional[bool] = None,
        *,
        device,
        nshards: int = 1,
        shard_devices: Optional[Sequence] = None,
        restart: Optional[str] = None,
        fused_stage: bool = True,
    ):
        if is_path is None:
            is_path = os.path.exists(deck)
        pin = ParameterInput.from_file(deck) if is_path else ParameterInput.from_string(deck)
        pin.apply_overrides(overrides)
        self.pin = pin
        self.device = torch.device(device)
        self.dtype = dtype_from_input(pin)
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)

        self.units = Units.from_input(pin)
        self.constants = Constants.from_units(self.units)

        self.do_gas = pin.get_or_add_bool("physics", "gas", True)
        self.do_dust = pin.get_or_add_bool("physics", "dust", False)
        refinement = pin.get_or_add_str("parthenon/mesh", "refinement", "none")
        if refinement not in ("none", "static", "adaptive"):
            raise ValueError(f"refinement {refinement!r} not recognized")

        self.grid = grid_from_input(pin)

        def _check(kind, val, allowed):
            if val not in allowed:
                raise ValueError(f"{kind} {val!r} not recognized (choices: {allowed})")

        gas_cfg = None
        if self.do_gas:
            eos = eos_from_input(pin, self.constants)
            recon = pin.get_or_add_str("gas", "reconstruct", "plm")
            rsolver = pin.get_or_add_str("gas", "riemann", "hllc")
            _check("reconstruction", recon, ("pcm", "plm", "ppm"))
            _check("riemann solver", rsolver, ("hllc", "hlle", "llf"))
            gas_cfg = FluidCfg(
                fluid="gas",
                recon=recon,
                rsolver=rsolver,
                gamma=eos.gamma,
                cv=eos.cv,
                cfl=pin.get_or_add_real("gas", "cfl", 0.8),
                dfloor=pin.get_or_add_real("gas", "dfloor", 1.0e-20),
                siefloor=pin.get_or_add_real("gas", "siefloor", 1.0e-20),
                de_switch=pin.get_or_add_real("gas", "de_switch", 0.0),
                nspecies=pin.get_or_add_int("gas", "nspecies", 1),
            )
            self.eos = eos
        dust_cfg = None
        if self.do_dust:
            drecon = pin.get_or_add_str("dust", "reconstruct", "plm")
            drsolver = pin.get_or_add_str("dust", "riemann", "hlle")
            _check("reconstruction", drecon, ("pcm", "plm", "ppm"))
            _check("riemann solver (dust)", drsolver, ("hlle", "llf"))
            dust_cfg = FluidCfg(
                fluid="dust",
                recon=drecon,
                rsolver=drsolver,
                cfl=pin.get_or_add_real("dust", "cfl", 0.8),
                dfloor=pin.get_or_add_real("dust", "dfloor", 1.0e-20),
                nspecies=pin.get_or_add_int("dust", "nspecies", 1),
            )
        self.gas_cfg = gas_cfg
        self.dust_cfg = dust_cfg

        # problem generator (may reset tlim etc.)
        problem_name = pin.get_str("artemis", "problem")
        self.problem = build_problem(problem_name, pin, self.grid, gas_cfg, dust_cfg)

        # physics source packages (artemis.cpp:63-164 wiring order)
        omf = 0.0
        if pin.get_or_add_bool("physics", "rotating_frame", False):
            omf = pin.get_or_add_real("rotating_frame", "omega", 0.0)
        # N-body package (a deterministic few-body system on the host)
        self.nbody = None
        if pin.get_or_add_bool("physics", "nbody", False):
            from .nbody import NBodySystem

            self.nbody = NBodySystem(pin, self.constants, omf=omf)
        srcs = sources_from_input(pin, self.grid, gas_cfg, dust_cfg, self.constants,
                                  nbody_sys=self.nbody)
        srcs += list(self.problem.sources)
        for s in srcs:
            # binary-orbit gravity solves its orbit in the rotating frame
            if isinstance(s, Gravity) and s.gtype == "binary":
                s.omf = omf

        # diffusion (viscosity / conduction) — gas only (gas.cpp:180-198)
        diffusion_factory = None
        visc = None
        do_visc = pin.get_or_add_bool("physics", "viscosity", False)
        do_cond = pin.get_or_add_bool("physics", "conduction", False)
        if (do_visc or do_cond) and gas_cfg is not None:
            from .ops.diffusion import DiffParams, Diffusion

            gm = None
            for s in srcs:
                if hasattr(s, "gm"):
                    gm = s.gm
            visc = (DiffParams.from_input("gas/viscosity", "viscosity", pin, gm)
                    if do_visc else None)
            cond = (DiffParams.from_input("gas/conductivity", "conductivity", pin, gm)
                    if do_cond else None)
            diffusion_factory = lambda hyd: Diffusion(hyd.grid, hyd, gas_cfg, visc, cond)
        _damp_to_visc(srcs, visc)

        # radiation (gray FLD, replacing the reference's jaybenne IMC)
        radiation_factory = None
        self.radiation_cfg = None
        if pin.get_or_add_bool("physics", "radiation", False):
            from .radiation import Radiation, radiation_from_input

            self.radiation_cfg = rc = radiation_from_input(pin, self.constants, gas_cfg)
            radiation_factory = lambda hyd: Radiation(rc, hyd.grid, hyd, gas_cfg,
                                                      fused=fused_stage)

        integrator = Integrator.make(pin.get_or_add_str("parthenon/time", "integrator", "rk2"))
        self._problems = {}
        self._srcs, self._omf, self._visc = srcs, omf, visc
        if refinement != "none":
            shard_kw = {}
            if nshards > 1:
                from .parallel.mesh import make_device_mesh

                axis = self._shard_axis(nshards, tree=True)
                devices = make_device_mesh(nshards, self.device, shard_devices)
                self.device = devices[0]
                # each shard's custom fills from the problem on its own grid
                shard_kw = dict(devices=devices, shard_axis=axis, bc_factory=(
                    (lambda g: self._problem_on(g).bc_custom)
                    if self.problem.bc_custom else None))
            self.driver = self._smr_driver(pin, problem_name, integrator, gas_cfg, dust_cfg,
                                           diffusion_factory, radiation_factory, omf,
                                           fused_stage, **shard_kw)
        elif nshards > 1:
            from .parallel.mesh import ShardedDriver, make_device_mesh

            devices = make_device_mesh(nshards, self.device, shard_devices)
            # the global arrays (outputs, history, checkpoints) live on the
            # first shard's device
            self.device = devices[0]
            self.driver = ShardedDriver(
                self.grid, integrator, gas_cfg, dust_cfg, sources_factory=self._sources_on,
                # each shard's custom fills from the problem on its own grid
                # (the disk's ic caches then hold its window)
                bc_factory=((lambda g: self._problem_on(g).bc_custom)
                            if self.problem.bc_custom else None),
                omf=omf, diffusion=diffusion_factory, axis=self._shard_axis(nshards),
                radiation=radiation_factory, nbody=self.nbody, devices=devices,
                dtype=self.dtype, fused_stage=fused_stage)
        else:
            self.driver = Driver(self.grid, integrator, gas_cfg, dust_cfg, sources=srcs,
                                 bc_custom=self.problem.bc_custom, omf=omf,
                                 diffusion=diffusion_factory, nbody=self.nbody,
                                 radiation=radiation_factory,
                                 device=self.device, dtype=self.dtype,
                                 fused_stage=fused_stage)

        # initial state: fresh from the problem generator, or from a restart
        # checkpoint (doc/src/running.rst:198-206, `-r name.final.rst`)
        self.restarted = restart is not None
        if restart is not None:
            meta = self._load_restart(restart)
        else:
            meta = {}
            state = {name: {"u": None,
                            "w": torch.as_tensor(w, dtype=self.dtype, device=self.device)}
                     for name, w in self.problem.prims.items()}
            self.state = self.driver.initialize(state)
            if self.radiation_cfg is not None:
                rc = self.radiation_cfg
                rad_T = getattr(self.problem, "rad_temp", None)
                if rad_T is not None:
                    Er = torch.as_tensor(rc.arad * np.asarray(rad_T)[None] ** 4,
                                         dtype=self.dtype, device=self.device)
                else:
                    from .radiation import initialize_radiation

                    Er = initialize_radiation(self.state, gas_cfg, rc)["Er"]
                self.state["rad"] = {"Er": Er}
        if self.radiation_cfg is not None:
            self._set_radiation_ic_edges()
        self.tm = SimTime(
            tlim=pin.get_real("parthenon/time", "tlim"),
            nlim=pin.get_or_add_int("parthenon/time", "nlim", -1),
            dt_min=pin.get_or_add_real("parthenon/time", "dt_min", 0.0),
            dt_max=pin.get_or_add_real("parthenon/time", "dt_max", 1.0e300),
            **meta,
        )
        if restart is not None and self.problem.on_restart is not None:
            self.problem.on_restart(self, self._restart_in_payloads)

    def _load_restart(self, path):
        """The state, the N-body system and the tree's fine levels from a
        checkpoint of either package, on the run's device.  A checkpoint
        whose dtype is not the deck's is refused.  ``gas.dtden`` (written
        by the fused paths) is kept, so the first resumed dt is the one an
        uninterrupted run takes; a checkpoint without it is seeded by
        ``prepare_state``.  Returns SimTime's (time, dt, ncycle,
        restored)."""
        arrays, meta, payloads = load_restart(path)
        want = str(self.dtype).removeprefix("torch.")
        for name, kinds in arrays.items():
            for kind, a in kinds.items():
                if a.dtype != np.dtype(want):
                    raise ValueError(f"restart {path}: {name}.{kind} is {a.dtype}, the deck "
                                     f"runs {want} (<artemis> precision)")
        self.state = {name: {kind: torch.as_tensor(a, device=self.device)
                             for kind, a in kinds.items()}
                      for name, kinds in arrays.items()}
        if hasattr(self.driver, "prepare_state"):
            self.state = self.driver.prepare_state(self.state)
        self._restart_in_payloads = payloads
        if self.nbody is not None and "nbody" in payloads:
            self.nbody.load_restart(payloads["nbody"])
        amr_pl = {k.removeprefix("amr."): v for k, v in payloads.items()
                  if k.startswith("amr.")}
        if amr_pl and hasattr(self.driver, "load_restart"):
            self.driver.load_restart(amr_pl, self.state)
        if hasattr(self.driver, "_ncycle"):
            # a tree retags and regrids on the global cycle, as an
            # uninterrupted run does
            self.driver._ncycle = meta["ncycle"]
        return dict(time=meta["time"], dt=meta["dt"], ncycle=meta["ncycle"], restored=True)

    def _problem_on(self, g):
        """The problem generator built on grid ``g`` (a patch's or a shard's),
        once per live grid: an entry goes with its grid, so a grid made
        after a regrid freed another cannot take the freed one's problem
        through a reused id."""
        import weakref

        if id(g) not in self._problems:
            self._problems[id(g)] = build_problem(
                self.pin.get_str("artemis", "problem"),
                ParameterInput.from_string(repr(self.pin)), g, self.gas_cfg, self.dust_cfg)
            weakref.finalize(g, self._problems.pop, id(g), None)
        return self._problems[id(g)]

    def _sources_on(self, g):
        """The deck's sources built on grid ``g`` (N-body gravity and cooling
        on the shared particles), with the problem's own where the problem
        has any (a spawned tile needs no prims of its own)."""
        if g is self.grid:
            return self._srcs
        ss = sources_from_input(self.pin, g, self.gas_cfg, self.dust_cfg, self.constants,
                                nbody_sys=self.nbody)
        if self.problem.sources:
            ss += list(self._problem_on(g).sources)
        for s in ss:
            if isinstance(s, Gravity) and s.gtype == "binary":
                s.omf = self._omf
        _damp_to_visc(ss, self._visc)
        return ss

    def _shard_axis(self, nshards, tree=False):
        """The sharded axis (<parthenon/mesh> shard_axis): ``auto`` takes x3,
        else x2, else x1, the first whose extent splits into shards of two
        cells or more, and on a refinement tree is periodic too
        (artemis_tpu/simulation.py:231-254, :297-345)."""
        axis_key = self.pin.get_or_add_str("parthenon/mesh", "shard_axis", "auto")
        if axis_key != "auto":
            return {"x1": 1, "x2": 2, "x3": 3}[axis_key]
        for d in (3, 2, 1):
            nd = self.grid.nx[d - 1]
            if (nd > 1 and nd % nshards == 0 and nd // nshards >= 2
                    and (not tree or self.grid.bc[d - 1] == ("periodic", "periodic"))):
                return d
        if tree:
            raise ValueError(f"sharded refinement needs a periodic axis divisible into "
                             f"{nshards} shards")
        raise ValueError(f"no grid axis divisible into {nshards} shards")

    def _smr_driver(self, pin, problem_name, integrator, gas_cfg, dust_cfg,
                    diffusion_factory, radiation_factory, omf, fused_stage, **shard_kw):
        """The static or adaptive refinement tree
        (artemis_tpu/simulation.py:223-296), with the run's fluids and its
        N-body system: every node gets the deck's sources (N-body gravity
        and cooling on the shared particles) and the problem's own, built on
        its grid; each deck or tracking patch's
        initial state comes from the problem generator on the patch grid
        (built once per patch, for its prims and, where the problem has
        sources, for those; an adaptive tree's spawned tiles prolong their
        prims).  ``<artemis> amr_user`` hands the problem's own criterion
        to the tree.  The tree's stage kernels run on the card
        (``fused_stage``).  ``shard_kw`` (devices, shard_axis, bc_factory)
        shards the tree."""
        from .amr import SMRDriver

        drv = SMRDriver(self.grid, integrator, gas_cfg, pin, device=self.device,
                        dtype=self.dtype, dust_cfg=dust_cfg, sources_factory=self._sources_on,
                        diffusion_factory=diffusion_factory,
                        bc_custom=self.problem.bc_custom, omf=omf,
                        radiation_factory=radiation_factory,
                        fused=fused_stage and self.device.type == "cuda", nbody=self.nbody,
                        **shard_kw)
        # a problem-defined refinement criterion (artemis.cpp:149-150)
        if pin.get_or_add_bool("artemis", "amr_user", False):
            if self.problem.amr_criterion is None:
                raise ValueError(f"{problem_name}: user-defined AMR criterion not implemented "
                                 "(amr_user = true needs the problem generator to provide "
                                 "Problem.amr_criterion)")
            drv.user_criterion = self.problem.amr_criterion
        drv._fine_prims = [dict(self._problem_on(g).prims) for g in drv.smr.ic_grids[1:]]
        return drv

    def _set_radiation_ic_edges(self):
        """Pin the FLD field outside ``ic`` boundaries to the IC equilibrium.

        The reference holds ghost zones at the IC for ix/ox*_bc = ic
        (shock.hpp decks); the FLD analogue is a Dirichlet edge at the IC
        radiation energy instead of a zero-flux wall, or the precursor flux
        reflects back into the domain.  Values derive from the problem
        generator (not the evolved state), one scalar per face: the plane's
        mean."""
        rc = self.radiation_cfg
        rad_T = getattr(self.problem, "rad_temp", None)
        if rad_T is not None:
            Er0 = rc.arad * np.asarray(rad_T) ** 4
        else:
            wg = np.asarray(self.problem.prims["gas"])
            Er0 = rc.arad * (wg[0, 5] / self.gas_cfg.cv) ** 4
        for d in (1, 2, 3):
            if self.grid.nx[d - 1] <= 1:
                continue
            inner, outer = self.grid.bc[d - 1]
            ax = Er0.ndim - d
            lo = float(np.take(Er0, 0, axis=ax).mean()) if inner == "ic" else None
            hi = float(np.take(Er0, -1, axis=ax).mean()) if outer == "ic" else None
            if lo is None and hi is None:
                continue
            self.driver.radiation.set_edge_dirichlet(d, lo=lo, hi=hi)

    def print_config(self):
        """Startup configuration banner (cf. PrintArtemisConfiguration,
        src/utils/artemis_utils.cpp:24-87)."""
        pin = self.pin
        lines = [
            "=" * 60,
            f"artemis_tpu_torch  |  problem = {pin.get_str('artemis', 'problem')}"
            f"  |  coords = {self.grid.coords}",
            f"mesh {self.grid.nx[0]}x{self.grid.nx[1]}x{self.grid.nx[2]}"
            f"  nghost={self.grid.nghost}  tlim={self.tm.tlim:g}",
            f"device {self.device}  dtype {str(self.dtype).removeprefix('torch.')}"
            f"  stage kernel: {self.driver.stage_kernel}",
        ]
        if self.gas_cfg:
            c = self.gas_cfg
            lines.append(f"gas: {c.recon}+{c.rsolver} gamma={c.gamma:g} "
                         f"cfl={c.cfl:g} nspecies={c.nspecies}")
        if self.dust_cfg:
            lines.append(f"dust: {self.dust_cfg.recon}+{self.dust_cfg.rsolver} "
                         f"nspecies={self.dust_cfg.nspecies}")
        pkgs = [type(s).__name__ for s in self.driver.sources]
        pkgs += [p for p, on in (("nbody", self.nbody is not None),
                                 ("radiation", self.radiation_cfg is not None),
                                 ("diffusion", self.driver.diffusion is not None)) if on]
        if pkgs:
            lines.append("packages: " + ", ".join(pkgs))
        if self.driver.radiation is not None:
            rad = self.driver.radiation
            lines.append(f"radiation: FLD {self.radiation_cfg.opacity_model} opacity, "
                         "operator " + ("fld_coeffs + fld_matvec kernels" if rad.use_kernels
                                        else "tensor operations"))
        lines.append("=" * 60)
        print("\n".join(lines))

    def _make_observers(self):
        """Attach outputs declared in the deck (<parthenon/outputN> blocks)."""
        from .io.history import HistoryOutput

        obs = []
        pid = self.pin.get_or_add_str("parthenon/job", "problem_id", "artemis")
        for block in self.pin.block_names():
            if not block.startswith("parthenon/output"):
                continue
            ftype = self.pin.get_or_add_str(block, "file_type", "hst")
            dt_out = self.pin.get_or_add_real(block, "dt", -1.0)
            n = block.removeprefix("parthenon/output")
            if dt_out <= 0.0:
                continue
            base = os.path.join(self.data_dir, f"{pid}.out{n}")
            if ftype == "hst":
                fname = base + ".hst"
                # restarts append to the existing history (Parthenon
                # behavior); fresh runs start clean
                if not self.restarted and os.path.exists(fname):
                    os.remove(fname)
                obs.append(HistoryOutput(self, dt_out, fname))
            elif ftype == "hdf5":
                variables = (self.pin.get_list(block, "variables")
                             if self.pin.exists(block, "variables") else None)
                obs.append(FieldOutput(self, dt_out, base, variables))
            elif ftype == "rst":
                obs.append(RestartOutput(self, dt_out, base))
        if self.nbody is not None and not self.pin.get_or_add_bool(
                "nbody", "disable_outputs", False):   # nbody_outputs.cpp:35
            obs.append(_NBodyOutputs(self))
        return obs

    @property
    def restart_payloads(self):
        """name -> fn() -> array restart extras: the N-body system and the
        tree's fine levels."""
        out = {}
        if self.nbody is not None:
            out["nbody"] = self.nbody.restart_payload
        if hasattr(self.driver, "restart_payloads"):
            for key, fn in self.driver.restart_payloads().items():
                out[f"amr.{key}"] = fn
        return out

    def write_restart(self, basename: str, tag: str = "final", state=None, tm=None) -> str:
        """A checkpoint as ``{basename}.{tag}.rst.npz`` (the name the CLI's
        walltime checkpoint and the rst output use): the run's state and
        time, or an observer's ``state`` and ``tm`` during the run."""
        return RestartOutput(self, 1.0, basename)._write(
            self.state if state is None else state, self.tm if tm is None else tm, tag=tag)

    def run(self, log_every: int = 0, extra_observers=(), walltime=None):
        import time as _t

        deadline = (_t.perf_counter() + walltime) if walltime else None
        observers = self._make_observers() + list(extra_observers)
        for ob in observers:
            # restarts resume counters/boundaries instead of re-emitting t=0
            # outputs (which would duplicate the original run's)
            if self.restarted and hasattr(ob, "resume"):
                ob.resume(self.state, self.tm)
            elif hasattr(ob, "start"):
                ob.start(self.state, self.tm)
        self.state, self.tm, zcps, self.status = evolve(
            self.driver, self.state, self.tm, observers=observers,
            log_every=log_every, deadline=deadline
        )
        for ob in observers:
            if hasattr(ob, "finish"):
                ob.finish(self.state, self.tm)
        if self.problem.after_loop is not None and self.status == "complete":
            self.problem.after_loop(self.grid, self.pin, self.state, self.tm, self.data_dir)
        return zcps
