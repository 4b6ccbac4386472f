"""What the benchmark hands to both sides and reads from both: the seeded
perturbation of the initial state, each node's state, and the comparison
of two sets of node states.  Both the program's ``Simulation`` and the
reference's have the same shape here: a single-level driver whose state
is ``sim.state``, or a refinement tree whose node states are
``sim.driver._states`` (the root first)."""

from __future__ import annotations

import math

import torch

# the gas primitives the perturbation touches: rho, v1, v2, v3
PERTURBED = slice(0, 4)
# the components compared together, each group against its own largest
# magnitude: density, momentum or velocity (a vector), total energy or
# pressure, internal energy or specific internal energy
GROUPS = ((0,), (1, 2, 3), (4,), (5,))
# the components that are positive in every cell (density, total energy or
# pressure, internal energy or specific internal energy), compared cell by
# cell against the reference's own value there; the vector (1, 2, 3) is
# compared cell by cell against its own magnitude plus the cell's sound
# scale, sqrt(rho p) for momentum and sqrt(p / rho) for velocity
POSITIVE = (0, 4, 5)
VECTOR = slice(1, 4)
TINY = 1e-300


def is_tree(sim) -> bool:
    return hasattr(sim.driver, "smr")


def node_states(sim) -> list:
    """The state of every node, the root first."""
    if is_tree(sim):
        sim.driver._ensure_states(sim.state)
        return list(sim.driver._states)
    return [sim.state]


def node_shapes(sim) -> list:
    """The interior shape (nx1, nx2, nx3) of every node."""
    if is_tree(sim):
        return [tuple(n.grid.nx) for n in sim.driver.smr.nodes]
    return [tuple(sim.grid.nx)]


def set_node_states(sim, states) -> None:
    """Put ``states`` (one per node) into ``sim`` as its current state."""
    if is_tree(sim):
        sim.driver._states = list(states)
        sim.state = sim.driver.smr.root_state(sim.driver._states)
    else:
        sim.state = states[0]


def copy_states(states, device=None, dtype=None, drop=("dtden",)) -> list:
    """A copy of node states that shares no tensor with them, on
    ``device`` and in ``dtype`` (default: as they are), without the keys in
    ``drop``."""
    return [{fl: {k: t.to(device=device, dtype=dtype, copy=True)
                  for k, t in kinds.items() if k not in drop}
             for fl, kinds in st.items()} for st in states]


def perturbation(shapes, seed: int, amp: float, device, dtype) -> list:
    """One factor per node, ``1 + amp * U(-1, 1)``, for the four perturbed
    primitives, drawn on ``device`` from ``seed`` in node order (float64,
    cast to ``dtype``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for nx1, nx2, nx3 in shapes:
        r = torch.rand((1, 4, nx3, nx2, nx1), generator=gen, device=device,
                       dtype=torch.float64)
        out.append((1.0 + amp * (2.0 * r - 1.0)).to(dtype))
    return out


def apply_perturbation(sim, factors, initialize_radiation) -> None:
    """Scale each node's density and velocities by its factor and rebuild
    the node states from the scaled primitives as the side's own driver
    does at start-up (P2C, and the radiation field from the gas
    temperature through the side's ``initialize_radiation``)."""
    ws = []
    for st, f in zip(node_states(sim), factors):
        w = st["gas"]["w"].clone()
        w[:, PERTURBED] *= f
        ws.append(w)
    if is_tree(sim):
        states = sim.driver.smr.initialize([{"gas": w} for w in ws])
        set_node_states(sim, states)
        return
    state = sim.driver.initialize({"gas": {"u": None, "w": ws[0]}})
    if sim.radiation_cfg is not None:
        state["rad"] = {"Er": initialize_radiation(state, sim.gas_cfg,
                                                   sim.radiation_cfg)["Er"]}
    sim.state = state


def _group_err(a, b) -> float:
    """max |a - b| over max |b|, each component group on its own; inf
    where either side is not finite."""
    worst = 0.0
    for grp in GROUPS:
        if grp[-1] >= a.shape[1]:
            continue
        x, y = a[:, list(grp)].double(), b[:, list(grp)].double()
        if not (bool(torch.isfinite(x).all()) and bool(torch.isfinite(y).all())):
            return math.inf
        scale = float(y.abs().max())
        err = float((x - y).abs().max())
        worst = max(worst, err / scale if scale > 0 else (0.0 if err == 0 else math.inf))
    return worst


def _field_err(a, b) -> float:
    """max |a - b| over max |b| of one field; inf where not finite."""
    x, y = a.double(), b.double()
    if not (bool(torch.isfinite(x).all()) and bool(torch.isfinite(y).all())):
        return math.inf
    scale = float(y.abs().max())
    err = float((x - y).abs().max())
    return err / scale if scale > 0 else (0.0 if err == 0 else math.inf)


def _cell_err(a, b, w_ref, momentum: bool) -> float:
    """The widest gap of one cell's value from the reference's, over every
    cell: each positive component against the reference's value in that
    cell, the vector against its magnitude plus the cell's sound scale
    (from the reference's primitives ``w_ref``); inf where either side is
    not finite."""
    x, y = a.double(), b.double()
    if not (bool(torch.isfinite(x).all()) and bool(torch.isfinite(y).all())):
        return math.inf
    worst = 0.0
    for c in POSITIVE:
        if c < y.shape[1]:
            gap = (x[:, c] - y[:, c]).abs() / y[:, c].abs().clamp_min(TINY)
            worst = max(worst, float(gap.max()))
    rho, p = w_ref[:, 0].double(), w_ref[:, 4].double().abs()
    sound = (rho * p).sqrt() if momentum else (p / rho.clamp_min(TINY)).sqrt()
    mag = torch.linalg.vector_norm(y[:, VECTOR], dim=1)
    gap = torch.linalg.vector_norm(x[:, VECTOR] - y[:, VECTOR], dim=1)
    return max(worst, float((gap / (mag + sound).clamp_min(TINY)).max()))


def compare(program_states, reference_states) -> dict:
    """The widest relative gaps between two sets of node states, over every
    node: ``gas`` (the conserved registers and the primitives, each
    component group against its own largest magnitude), ``cell`` (the same
    registers and primitives cell by cell against the reference's value in
    that cell, and the radiation energy density where the states carry
    one: a fault in the thin gas far below the largest magnitude shows
    here) and ``rad`` (the radiation energy density against its largest
    magnitude)."""
    if len(program_states) != len(reference_states):
        return {"gas": math.inf}
    gas, cell, rad = 0.0, 0.0, None
    for p, r in zip(program_states, reference_states):
        dev = r["gas"]["u"].device
        w_ref = r["gas"]["w"]
        for k in ("u", "w"):
            gas = max(gas, _group_err(p["gas"][k].to(dev), r["gas"][k]))
            cell = max(cell, _cell_err(p["gas"][k].to(dev), r["gas"][k], w_ref, k == "u"))
        if "rad" in r:
            if "rad" not in p:
                e, c = math.inf, math.inf
            else:
                x, y = p["rad"]["Er"].to(dev), r["rad"]["Er"]
                e = _field_err(x, y)
                c = (math.inf if not bool(torch.isfinite(x).all()) else
                     float(((x.double() - y.double()).abs()
                            / y.double().abs().clamp_min(TINY)).max()))
            rad = e if rad is None else max(rad, e)
            cell = max(cell, c)
    out = {"gas": gas, "cell": cell}
    if rad is not None:
        out["rad"] = rad
    return out
