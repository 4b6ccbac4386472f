"""How ``correct`` is decided: the program's output against the plain
reference (``reference/``), after the program's window has closed, its
peak memory has been read and its state has been freed.

The set-up drives the program's ``Simulation`` from the seeded initial
state through its first cycles (the warm-up) by the loop and the object
that then run the window; the state they produce is copied aside.  The
reference builds the cell's initial state from the deck and the same
seeded perturbation, holds the program's initial state against it, and
advances the same cycles from it with dts of its own choosing.  Only the
seeded perturbation passes from the benchmark to both sides; nothing the
program made goes into the reference.

The numbers compared, each with its limit in the cell file:

- ``ic_err``: the widest relative gap of the program's initial node states
  (each component group against its largest magnitude, and cell by cell);
- ``dt_err``: the widest relative gap of the dts chosen after each cycle;
- ``gas_err``: of the gas registers and primitives after the cycles, each
  component group against its largest magnitude;
- ``cell_err``: of the same, and of the radiation energy density, cell by
  cell against the reference's value in that cell (``states.compare``), so
  that the thin gas, many orders of magnitude below the disk's midplane,
  is held as closely as the midplane;
- ``rad_err``: of the radiation energy density after the cycles, against
  its largest magnitude (cells with radiation).
"""

from __future__ import annotations

import contextlib
import math

from . import roofline
from .states import apply_perturbation, compare, is_tree, node_shapes, node_states, \
    perturbation


def reference_run(cell, device, seed, start_host, check_cycles, count_flops):
    """Build the reference, perturb it from ``seed`` as the program was,
    check the start against ``start_host`` (the program's initial node
    states), and advance ``check_cycles`` cycles from it.  Returns
    (numbers, the reference's dts: one after each cycle, its final node
    states, and with ``count_flops`` the floating-point operations of a
    stage and of a cycle of the plain path)."""
    from .reference import Simulation
    from .reference.driver import evolve
    from .reference.radiation import initialize_radiation

    ref = Simulation(cell.deck_text(), [], is_path=False, device=device)
    apply_perturbation(ref, perturbation(node_shapes(ref), seed, cell.traffic["perturb_amp"],
                                         device, ref.dtype), initialize_radiation)
    numbers = {"ic_err": max(compare(start_host, node_states(ref)).values())}

    n = ref.tm.ncycle
    ref.tm.nlim = n + check_cycles
    dts = []
    counter = roofline.FlopCounter() if count_flops else None
    if counter is not None:
        owner, name = ((ref.driver.smr, "_stage") if is_tree(ref)
                       else (ref.driver, "_stage_body"))
        inner = getattr(owner, name)

        def counted(*args, **kw):
            with counter.bucket_as("stage"):
                return inner(*args, **kw)

        setattr(owner, name, counted)
    with counter if counter is not None else contextlib.nullcontext():
        ref.state, ref.tm, _, status = evolve(
            ref.driver, ref.state, ref.tm, observers=[lambda state, tm: dts.append(tm.dt)])
    if status != "complete" or ref.tm.ncycle != n + check_cycles:
        raise RuntimeError(f"the reference stopped at cycle {ref.tm.ncycle} ({status})")
    flops = None
    if counter is not None:
        nst = ref.driver.integrator.nstages
        flops = {"stage": counter.counts.get("stage", 0) / (check_cycles * nst),
                 "cycle": sum(counter.counts.values()) / check_cycles}
    return numbers, dts, node_states(ref), flops


def decide(numbers: dict, limits: dict) -> bool:
    """Correct when every number is finite and within its limit."""
    return all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())


def dt_gap(program_dts, reference_dts) -> float:
    gap = 0.0
    for p, r in zip(program_dts, reference_dts):
        if not (math.isfinite(p) and math.isfinite(r)) or r <= 0.0:
            return math.inf
        gap = max(gap, abs(p - r) / r)
    return gap if len(program_dts) == len(reference_dts) else math.inf
