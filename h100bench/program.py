"""The system under test: ``artemis_tpu_torch`` built from a cell's deck
and driven through ``driver.evolve``, the loop that ``Simulation.run``
drives.  From the program the benchmark takes its ``Simulation``, its
launch counters, its phase table and the names of its dispatch points,
around which it records its own spans."""

from __future__ import annotations

import contextlib
import time

import torch

from . import roofline
from .states import is_tree

# the program's launch counters the benchmark reads (module, attribute)
COUNTERS = {"stage_curv": ("artemis_tpu_torch.ops.stage_curv", "stage_curv_launches"),
            "stage_curv_batched": ("artemis_tpu_torch.ops.stage_curv",
                                   "stage_curv_batched_launches"),
            "fld_coeffs": ("artemis_tpu_torch.ops.fld", "fld_coeffs_launches"),
            "fld_matvec": ("artemis_tpu_torch.ops.fld", "fld_matvec_launches")}


def counters() -> dict:
    import importlib

    return {k: getattr(importlib.import_module(m), a) for k, (m, a) in COUNTERS.items()}


def build(cell, device, data_dir, precision=None):
    """The cell's ``Simulation`` on ``device`` from the deck the benchmark
    wrote (no file of the repo's ``inputs/`` is read); ``precision``
    overrides the deck's (the lower-precision control)."""
    from artemis_tpu_torch import Simulation

    overrides = [] if precision is None else [f"artemis/precision={precision}"]
    return Simulation(cell.deck_text(), overrides, data_dir, is_path=False, device=device)


class Clock:
    """Cycle boundaries: CUDA events on the card (read after the closing
    sync), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Run:
    """A program run: the evolution loop advanced by ``advance``, every dt
    it chose recorded (``dts[i]`` is the dt after cycle i + 1)."""

    def __init__(self, sim, device):
        self.sim = sim
        self.device = device
        self.dts = []

    def advance(self, ncycles=None, seconds=None, clock=None):
        """Advance ``ncycles`` cycles, or until ``seconds`` have passed on
        the host clock (the cycle that crosses it completes)."""
        from artemis_tpu_torch.driver import evolve

        sim = self.sim
        sim.tm.nlim = -1 if ncycles is None else sim.tm.ncycle + ncycles

        def observe(state, tm):
            self.dts.append(tm.dt)
            if clock is not None:
                clock.mark()

        deadline = None if seconds is None else time.perf_counter() + seconds
        n0 = sim.tm.ncycle
        sim.state, sim.tm, _, status = evolve(sim.driver, sim.state, sim.tm,
                                              observers=[observe], deadline=deadline)
        if ncycles is not None and (status != "complete" or sim.tm.ncycle - n0 != ncycles):
            raise RuntimeError(f"the loop stopped at cycle {sim.tm.ncycle} ({status}), "
                               f"wanted {n0 + ncycles}")
        return sim.tm.ncycle - n0

    def cells(self) -> int:
        """Interior cells over every node."""
        if is_tree(self.sim):
            return sum(n.grid.nx[0] * n.grid.nx[1] * n.grid.nx[2]
                       for n in self.sim.driver.smr.nodes)
        nx = self.sim.grid.nx
        return nx[0] * nx[1] * nx[2]


@contextlib.contextmanager
def spans(sim, calls):
    """Wrap the program's stage and FLD-operator dispatch points in the
    benchmark's spans for the traced window, recording into ``calls`` the
    compulsory bytes of each call from its shapes: ``calls["stage"]`` and
    ``calls["fld_matvec"]``, one (bytes, cells) per call."""
    from torch.profiler import record_function

    from artemis_tpu_torch.ops import fld, stage_curv

    ng = sim.grid.nghost
    # the halo a node's stage reads: every non-periodic axis of the root,
    # every axis of a patch
    root_axes = [d for d in range(3) if sim.grid.nx[d] > 1
                 and sim.grid.bc[d] != ("periodic", "periodic")]

    def node_axes(i, nx):
        return root_axes if i == 0 else [d for d in range(3) if nx[d] > 1]

    def shape_nx(w):
        nz, ny, nx = w.shape[-3:]
        return (nx, ny, nz)

    orig = stage_curv.stage_curv, stage_curv.stage_curv_batched, fld.fld_matvec

    def one(cs, w, u0, u1, gam0, *args, **kw):
        nx = shape_nx(w)
        # a call with its own strips is a patch's, or a six-face root's
        axes = node_axes(1, nx) if kw.get("strips") is not None else root_axes
        calls.setdefault("stage", []).append(
            (roofline.stage_bytes([(nx, axes)], ng, w.element_size(), gam0 != 0.0),
             nx[0] * nx[1] * nx[2]))
        with record_function("h100bench.stage"):
            return orig[0](cs, w, u0, u1, gam0, *args, **kw)

    def batched(stages, ws, u0s, u1s, strips_list, gam0, *args, **kw):
        nodes = [(shape_nx(w), node_axes(i, shape_nx(w))) for i, w in enumerate(ws)]
        calls.setdefault("stage", []).append(
            (roofline.stage_bytes(nodes, ng, ws[0].element_size(), gam0 != 0.0),
             sum(n[0] * n[1] * n[2] for n, _ in nodes)))
        with record_function("h100bench.stage"):
            return orig[1](stages, ws, u0s, u1s, strips_list, gam0, *args, **kw)

    def matvec(E, A, diag_geo, sf):
        calls.setdefault("fld_matvec", []).append(
            (roofline.matvec_bytes(E.numel(), E.element_size()), E.numel()))
        with record_function("h100bench.fld_matvec"):
            return orig[2](E, A, diag_geo, sf)

    stage_curv.stage_curv, stage_curv.stage_curv_batched, fld.fld_matvec = one, batched, matvec
    try:
        yield
    finally:
        stage_curv.stage_curv, stage_curv.stage_curv_batched, fld.fld_matvec = orig


def phase_table(sim, ncycles):
    """The program's phase table (``profiling.phase_table``: each phase
    between device syncs, on a copy of the state): {phase: seconds}."""
    import sys

    from artemis_tpu_torch import profiling

    return profiling.phase_table(sim, ncycles=ncycles, out=sys.stderr)
