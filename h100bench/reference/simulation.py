"""Top-level simulation assembly (a frozen copy of
``artemis_tpu_torch/simulation.py``'s single-device set-up on the plain
path, the reference of the benchmark).

Reads the input deck, builds the gas fluid, the problem generator, the
source packages (gravity, rotating frame, beta cooling, drag and damping
zones, viscosity/conduction, gray FLD radiation) and the driver (single
level, or a static refinement tree) on the requested device, and starts
from the problem generator.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .config import ParameterInput
from .driver import Driver, Integrator, SimTime
from .eos import eos_from_input
from .grid import grid_from_input
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


class Simulation:
    def __init__(self, deck: str, overrides: Sequence[str] = (), is_path: Optional[bool] = None,
                 *, device):
        if is_path is None:
            is_path = os.path.exists(deck)
        pin = ParameterInput.from_file(deck) if is_path else ParameterInput.from_string(deck)
        pin.apply_overrides(overrides)
        self.pin = pin
        self.device = torch.device(device)
        self.dtype = dtype_from_input(pin)

        self.units = Units.from_input(pin)
        self.constants = Constants.from_units(self.units)

        if not pin.get_or_add_bool("physics", "gas", True) or pin.get_or_add_bool(
                "physics", "dust", False):
            raise ValueError("the reference runs gas alone")
        if pin.get_or_add_bool("physics", "nbody", False):
            raise ValueError("the reference runs no N-body system")
        refinement = pin.get_or_add_str("parthenon/mesh", "refinement", "none")
        if refinement not in ("none", "static"):
            raise ValueError(f"refinement {refinement!r}: the reference runs none or static")

        self.grid = grid_from_input(pin)

        def _check(kind, val, allowed):
            if val not in allowed:
                raise ValueError(f"{kind} {val!r} not recognized (choices: {allowed})")

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
        self.gas_cfg = gas_cfg

        # problem generator (may reset tlim etc.)
        problem_name = pin.get_str("artemis", "problem")
        self.problem = build_problem(problem_name, pin, self.grid, gas_cfg)

        # physics source packages (artemis.cpp:63-164 wiring order)
        omf = 0.0
        if pin.get_or_add_bool("physics", "rotating_frame", False):
            omf = pin.get_or_add_real("rotating_frame", "omega", 0.0)
        srcs = sources_from_input(pin, self.grid, gas_cfg, None, self.constants)
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
        if do_visc or do_cond:
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
            radiation_factory = lambda hyd: Radiation(rc, hyd.grid, hyd, gas_cfg)

        integrator = Integrator.make(pin.get_or_add_str("parthenon/time", "integrator", "rk2"))
        self._problems = {}
        self._srcs, self._omf, self._visc = srcs, omf, visc
        if refinement == "static":
            from .amr import SMRDriver

            self.driver = SMRDriver(self.grid, integrator, gas_cfg, pin, device=self.device,
                                    dtype=self.dtype, sources_factory=self._sources_on,
                                    diffusion_factory=diffusion_factory,
                                    bc_custom=self.problem.bc_custom, omf=omf,
                                    radiation_factory=radiation_factory)
            self.driver._fine_prims = [dict(self._problem_on(g).prims)
                                       for g in self.driver.smr.ic_grids[1:]]
        else:
            self.driver = Driver(self.grid, integrator, gas_cfg, None, sources=srcs,
                                 bc_custom=self.problem.bc_custom, omf=omf,
                                 diffusion=diffusion_factory, radiation=radiation_factory,
                                 device=self.device, dtype=self.dtype)

        # initial state fresh from the problem generator
        state = {name: {"u": None,
                        "w": torch.as_tensor(w, dtype=self.dtype, device=self.device)}
                 for name, w in self.problem.prims.items()}
        self.state = self.driver.initialize(state)
        if self.radiation_cfg is not None:
            from .radiation import initialize_radiation

            self.state["rad"] = {"Er": initialize_radiation(self.state, gas_cfg,
                                                            self.radiation_cfg)["Er"]}
            self._set_radiation_ic_edges()
        self.tm = SimTime(
            tlim=pin.get_real("parthenon/time", "tlim"),
            nlim=pin.get_or_add_int("parthenon/time", "nlim", -1),
            dt_min=pin.get_or_add_real("parthenon/time", "dt_min", 0.0),
            dt_max=pin.get_or_add_real("parthenon/time", "dt_max", 1.0e300),
        )

    def _problem_on(self, g):
        """The problem generator built on grid ``g`` (a patch's), once per
        grid."""
        if id(g) not in self._problems:
            self._problems[id(g)] = build_problem(
                self.pin.get_str("artemis", "problem"),
                ParameterInput.from_string(repr(self.pin)), g, self.gas_cfg)
        return self._problems[id(g)]

    def _sources_on(self, g):
        """The deck's sources built on grid ``g``, with the problem's own
        where the problem has any."""
        if g is self.grid:
            return self._srcs
        ss = sources_from_input(self.pin, g, self.gas_cfg, None, self.constants)
        if self.problem.sources:
            ss += list(self._problem_on(g).sources)
        for s in ss:
            if isinstance(s, Gravity) and s.gtype == "binary":
                s.omf = self._omf
        _damp_to_visc(ss, self._visc)
        return ss

    def _set_radiation_ic_edges(self):
        """Pin the FLD field outside ``ic`` boundaries to the IC equilibrium:
        a Dirichlet edge at the IC radiation energy, one scalar per face
        (the plane's mean), from the problem generator's state."""
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
