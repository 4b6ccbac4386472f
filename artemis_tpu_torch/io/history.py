"""History (.hst) output: per-species volume integrals of conserved fields
(port of ``artemis_tpu/io/history.py``).

Writes the same self-describing ASCII format as the reference
(Parthenon .hst + src/utils/history.hpp reducers, gas.cpp:645-676,
dust.cpp:331-352):

    #  History data
    # [1]=time [2]=dt [3]=cycle [4]=nbtotal [5]=gas_mass_0 ...
    <rows>

Columns per gas species: mass, momentum_x1/2/3, energy, internal_energy;
per dust species: mass, momentum_x1/2/3.  Reductions are torch sums of
vol * u over the interior on the run's device.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch


class HistoryOutput:
    def __init__(self, sim, dt_out: float, fname: str):
        self.sim = sim
        self.dt_out = dt_out
        self.path = fname
        self.next_time = 0.0
        self._labels = self._build_labels()
        self._wrote_header = False
        g = sim.grid
        self._vol = torch.as_tensor(
            np.ascontiguousarray(np.broadcast_to(g.geom.volume(), g.shape_entire)[g.int_slices]),
            dtype=sim.dtype, device=sim.device)

    def _build_labels(self) -> List[str]:
        labels = ["time", "dt", "cycle", "nbtotal"]
        drv = self.sim.driver
        if drv.gas_cfg is not None:
            ns = drv.gas_cfg.nspecies
            for base in ("gas_mass", "gas_momentum_x1", "gas_momentum_x2",
                         "gas_momentum_x3", "gas_energy", "gas_internal_energy"):
                labels += [f"{base}_{n}" for n in range(ns)]
        if drv.dust_cfg is not None:
            ns = drv.dust_cfg.nspecies
            for base in ("dust_mass", "dust_momentum_x1", "dust_momentum_x2",
                         "dust_momentum_x3"):
                labels += [f"{base}_{n}" for n in range(ns)]
        return labels

    def _reduce(self, state):
        vals = []
        drv = self.sim.driver
        for name, cfg, ncomp in (("gas", drv.gas_cfg, 6), ("dust", drv.dust_cfg, 4)):
            if cfg is None:
                continue
            ints = torch.sum(self._vol * state[name]["u"], dim=(-3, -2, -1)).cpu()  # [ns, C]
            for c in range(ncomp):
                vals += [float(x) for x in ints[:, c]]
        return vals

    def _write_row(self, state, tm):
        self._last_written = (tm.time, tm.ncycle)
        if not self._wrote_header:
            with open(self.path, "a") as f:
                f.write("#  History data\n")
                f.write("# " + " ".join(
                    f"[{i + 1}]={lab}" for i, lab in enumerate(self._labels)) + "\n")
            self._wrote_header = True
        row = [tm.time, tm.dt if np.isfinite(tm.dt) else 0.0,
               float(tm.ncycle), 1.0] + self._reduce(state)
        with open(self.path, "a") as f:
            f.write(" ".join(f"{v:.8e}" for v in row) + "\n")

    # observer protocol ------------------------------------------------
    def start(self, state, tm):
        self._write_row(state, tm)
        self.next_time = self.dt_out

    def resume(self, state, tm):
        """Restart: append to the existing .hst (reference Parthenon behavior)
        and fire at the first output boundary strictly after tm.time."""
        self._wrote_header = os.path.exists(self.path) and os.path.getsize(self.path) > 0
        self.next_time = (np.floor(tm.time / self.dt_out * (1.0 + 1e-12)) + 1) * self.dt_out

    def __call__(self, state, tm):
        # one row per trigger even if the step crossed several dt_out
        # boundaries — duplicate rows at identical (time, state) are noise
        if tm.time >= self.next_time * (1.0 - 1e-12):
            self._write_row(state, tm)
            self.next_time = (np.floor(tm.time / self.dt_out * (1.0 + 1e-12)) + 1) * self.dt_out
            return True
        return False

    def finish(self, state, tm):
        # ensure the final state is recorded exactly once (Parthenon writes a
        # last output at tlim; the crossing logic usually already has)
        if getattr(self, "_last_written", None) != (tm.time, tm.ncycle):
            self._write_row(state, tm)
