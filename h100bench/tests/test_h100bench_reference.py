"""The plain reference agrees with the port's CPU path in float64 on a
small disk_sph and a small disk_rhd_amr tree (the tree on its fused path,
the card's, whose CPU version is the same plain stage), and the benchmark's modules
import neither JAX nor the JAX package, the reference nothing of the
port (top-level module names compared whole)."""

import ast
import warnings
from pathlib import Path

import pytest
import torch

from h100bench import spec
from h100bench.reference import Simulation as Reference
from h100bench.states import node_states

from .small import on_the_cards_path, small_cell, small_tree

FORBIDDEN = {"jax", "jaxlib", "flax", "artemis_tpu"}


def _imports(path: Path):
    """The top-level names a module imports, and whether it imports
    relatively."""
    tree = ast.parse(path.read_text())
    names = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            names |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.level == 0 and n.module:
            names.add(n.module.split(".")[0])
    return names


def _sources(sub=""):
    return sorted(p for p in (spec.HERE / sub).rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_anywhere(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", _sources("reference"),
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_reference_takes_nothing_of_the_port(path):
    assert not (_imports(path) & (FORBIDDEN | {"artemis_tpu_torch", "h100bench"}))


@pytest.mark.parametrize("name", ["disk_sph.uniform", "disk_rhd_amr.static"])
def test_reference_follows_the_port_on_the_cpu(name, tmp_path, monkeypatch):
    from artemis_tpu_torch import Simulation
    from artemis_tpu_torch.driver import evolve

    from h100bench.reference.driver import evolve as ref_evolve

    on_the_cards_path(monkeypatch)
    # the tree: disk_rhd_amr as written, with its static patch
    cell = small_tree() if name == "disk_rhd_amr.static" else small_cell(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        prog = Simulation(cell.deck_text(), [], str(tmp_path), is_path=False, device="cpu")
        ref = Reference(cell.deck_text(), [], is_path=False, device="cpu")
    assert prog.dtype == ref.dtype == torch.float64
    if hasattr(ref.driver, "smr"):
        assert prog.driver.stage_kernel == ref.driver.smr.stage_kernel != "none"
    for sim, ev in ((prog, evolve), (ref, ref_evolve)):
        sim.tm.nlim = 3
        sim.state, sim.tm, _, status = ev(sim.driver, sim.state, sim.tm)
        assert status == "complete"
    assert prog.tm.time == ref.tm.time and prog.tm.dt == ref.tm.dt
    for p, r in zip(node_states(prog), node_states(ref)):
        for fl in r:
            for k in r[fl]:
                torch.testing.assert_close(p[fl][k], r[fl][k], rtol=1e-13, atol=0.0)
