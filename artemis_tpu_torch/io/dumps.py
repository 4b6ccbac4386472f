"""Field dumps and restart files (the port's own copy of
``artemis_tpu/io/dumps.py``, which is numpy only).

Replaces the reference's Parthenon HDF5 outputs (``file_type = hdf5`` data
dumps and ``rst`` restarts, doc/src/running.rst:60-76) with self-describing
``.npz`` archives: primitive fields + grid coordinates + time metadata.
``analysis/adump.py`` reads them with the same access patterns the
reference's ``ahdf`` reader offers.

Restart archives additionally hold the conserved state and the SimTime so a
run resumes bit-for-bit (``-r file.rst.npz``); package-specific restart
payloads (e.g. the N-body system state) register extra arrays.

File names, array keys, dtypes and the ``__meta__`` JSON are the JAX
package's, so a checkpoint written by either package loads in the other
and ``analysis/adump.py`` reads the port's dumps unchanged.  Tensors are
copied to the host with ``.detach().cpu().numpy()``.

One key differs on writing: the fused stages' CFL maxima (``gas.dtden``,
from which the next dt comes) go to ``payload.dtden``.  The JAX package's
jnp loop carries no ``dtden`` and its fused loop carries its own block
shape, so its ``lax.while_loop`` refuses a state that brings another; it
ignores unknown payloads.  ``load_restart`` reads either key back into
``gas.dtden``, so a port checkpoint resumes bit for bit in the port and
loads in the JAX package with or without the maxima.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _host(a) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class FieldOutput:
    """Writes ``{problem_id}.out{n}.{NNNNN}.npz`` every ``dt_out``."""

    def __init__(self, sim, dt_out: float, basename: str, variables=None):
        self.sim = sim
        self.dt_out = dt_out
        self.basename = basename  # e.g. data_dir/problem.out1
        self.next_time = 0.0
        self.count = 0
        self.variables = variables

    def _arrays(self, state):
        out = {}
        names = {"gas": ["density", "velocity_x1", "velocity_x2", "velocity_x3",
                         "pressure", "sie"],
                 "dust": ["density", "velocity_x1", "velocity_x2", "velocity_x3"]}
        for fluid in ("gas", "dust"):
            if fluid not in state:
                continue
            w = _host(state[fluid]["w"])
            for n in range(w.shape[0]):
                for c, nm in enumerate(names[fluid]):
                    out[f"{fluid}.prim.{nm}_{n}"] = w[n, c]
        if "rad" in state:
            # radiation energy density (reference dumps the analogous
            # field.jaybenne.energy_tally)
            Er = _host(state["rad"]["Er"])
            for n in range(Er.shape[0]):
                out[f"rad.energy_density_{n}"] = Er[n]
        return out

    def _write(self, state, tm, tag=None):
        grid = self.sim.grid
        g = grid.geom
        s3, s2, s1 = grid.int_slices
        fname = f"{self.basename}.{self.count:05d}.npz" if tag is None else \
            f"{self.basename}.{tag}.npz"
        meta = dict(time=tm.time, dt=tm.dt, ncycle=tm.ncycle,
                    coords=grid.coords, nx=list(grid.nx))
        np.savez(
            fname,
            __meta__=json.dumps(meta),
            x1f=g.xf1[s1.start:s1.stop + 1],
            x2f=g.xf2[s2.start:s2.stop + 1],
            x3f=g.xf3[s3.start:s3.stop + 1],
            x1v=g.xv1[s1], x2v=g.xv2[s2], x3v=g.xv3[s3],
            **self._arrays(state),
        )
        self.count += 1
        return fname

    def start(self, state, tm):
        self._write(state, tm)
        self.next_time = self.dt_out

    def resume(self, state, tm):
        """Restart: continue numbering after the original run's dumps and
        fire at the first boundary strictly after tm.time."""
        self.count = _next_count(self.basename, ".npz")
        self.next_time = _next_boundary(tm.time, self.dt_out)

    def __call__(self, state, tm):
        if tm.time >= self.next_time * (1.0 - 1e-12):
            self._write(state, tm)
            self.next_time = _next_boundary(tm.time, self.dt_out)

    def finish(self, state, tm):
        self._write(state, tm, tag="final")


def _next_boundary(time: float, dt_out: float) -> float:
    """First output boundary strictly after ``time``."""
    return (np.floor(time / dt_out * (1.0 + 1e-12)) + 1) * dt_out


def _next_count(basename: str, suffix: str) -> int:
    """Resume the dump counter after the highest existing numbered file."""
    import glob
    import re

    pat = re.compile(re.escape(os.path.basename(basename)) + r"\.(\d+)"
                     + re.escape(suffix) + "$")
    hi = -1
    for f in glob.glob(f"{basename}.*{suffix}"):
        m = pat.match(os.path.basename(f))
        if m:
            hi = max(hi, int(m.group(1)))
    return hi + 1


class RestartOutput:
    """Writes ``{problem_id}.out{n}.{NNNNN|final}.rst.npz`` checkpoints."""

    def __init__(self, sim, dt_out: float, basename: str):
        self.sim = sim
        self.dt_out = dt_out
        self.basename = basename
        self.next_time = 0.0
        self.count = 0

    def _write(self, state, tm, tag=None):
        arrays = {}
        for fluid in state:
            for kind, val in state[fluid].items():
                key = "payload.dtden" if kind == "dtden" else f"{fluid}.{kind}"
                arrays[key] = _host(val)
        # package restart payloads (e.g. nbody system snapshot)
        for name, payload in getattr(self.sim, "restart_payloads", {}).items():
            arrays[f"payload.{name}"] = _host(payload())
        meta = dict(time=tm.time, dt=tm.dt, ncycle=tm.ncycle)
        fname = f"{self.basename}.{self.count:05d}.rst.npz" if tag is None else \
            f"{self.basename}.{tag}.rst.npz"
        np.savez(fname, __meta__=json.dumps(meta), **arrays)
        self.count += 1
        return fname

    def start(self, state, tm):
        self.next_time = self.dt_out

    def resume(self, state, tm):
        self.count = _next_count(self.basename, ".rst.npz")
        self.next_time = _next_boundary(tm.time, self.dt_out)

    def __call__(self, state, tm):
        if tm.time >= self.next_time * (1.0 - 1e-12):
            self._write(state, tm)
            self.next_time = _next_boundary(tm.time, self.dt_out)

    def finish(self, state, tm):
        self._write(state, tm, tag="final")


def load_restart(path: str):
    """Returns (state_arrays, meta, payloads)."""
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(str(f["__meta__"]))
        state = {}
        payloads = {}
        for key in f.files:
            if key == "__meta__":
                continue
            if key.startswith("payload."):
                payloads[key.removeprefix("payload.")] = f[key]
                continue
            fluid, kind = key.split(".")
            state.setdefault(fluid, {})[kind] = f[key]
    if "dtden" in payloads:
        state["gas"]["dtden"] = payloads.pop("dtden")
    return state, meta, payloads
