"""Tracing in the port (``artemis_tpu_torch.profiling``): the counters of
the host's reads and of the Newton outers, and the ``artemis.*`` spans.

On small decks of the benchmark's two configurations (disk_sph, and the
disk RHD root without its patch): every tensor read back to the host in a
run of cycles goes through ``profiling.host_read`` and is counted there;
``newton_outers`` and ``host_reads`` follow the radiation loops' own
iteration counts; under ``torch.profiler`` a cycle's spans nest as the
calls do and every scalar read lies inside a host-read span; the profiler
leaves the states bitwise as they are without it.  On the card
(``-m cuda``), CUDA's own count of synchronising operations equals the
rise of ``host_reads``.
"""

import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from artemis_tpu_torch import Simulation, profiling  # noqa: E402
from artemis_tpu_torch.driver import evolve  # noqa: E402
from artemis_tpu_torch.state import state_to_numpy  # noqa: E402

INP = os.path.join(os.path.dirname(__file__), "..", "inputs")
DECKS = {
    "disk_sph": (os.path.join(INP, "disk_sph.in"),
                 ["parthenon/mesh/nx1=16", "parthenon/mesh/nx2=8", "parthenon/mesh/nx3=8",
                  "parthenon/mesh/x1min=0.4", "parthenon/mesh/x1max=2.4"]),
    "disk_rhd": (os.path.join(INP, "disk_rhd_amr.in"),
                 ["parthenon/mesh/refinement=none", "parthenon/mesh/nx1=16",
                  "parthenon/mesh/nx2=16", "parthenon/mesh/nx3=8"]),
}
# the conversions that read a tensor back to the host
READS = ("__bool__", "item", "tolist", "__float__", "cpu")


def build(tmp_path, deck, device="cpu"):
    path, args = DECKS[deck]
    return Simulation(path, args, str(tmp_path / deck), device=device)


def advance(sim, ncycles, observers=()):
    """``ncycles`` cycles through ``evolve``, which reads one dt before its
    first cycle and one after each."""
    sim.tm.nlim = sim.tm.ncycle + ncycles
    sim.state, sim.tm, _, status = evolve(sim.driver, sim.state, sim.tm,
                                          observers=list(observers))
    assert status == "complete"


def in_host_read():
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code is profiling.host_read.__code__:
            return True
        frame = frame.f_back
    return False


@pytest.mark.parametrize("deck", DECKS)
def test_every_read_goes_through_host_read(tmp_path, monkeypatch, deck):
    sim = build(tmp_path, deck)
    advance(sim, 1)
    inside, outside = [], []
    for name in READS:
        def read(self, *args, _orig=getattr(torch.Tensor, name), _name=name, **kwargs):
            (inside if in_host_read() else outside).append(_name)
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, read)
    reads0 = profiling.host_reads
    advance(sim, 3)
    monkeypatch.undo()
    assert outside == []
    assert len(inside) == profiling.host_reads - reads0 >= 4


@pytest.mark.parametrize("deck", DECKS)
def test_counters_follow_the_loops(tmp_path, deck):
    sim = build(tmp_path, deck)
    advance(sim, 1)
    rad = sim.driver.radiation
    steps = []

    def observe(state, tm):
        steps.append(list(rad.cg_iters) if rad is not None else [])

    reads0, outers0, wait0 = (profiling.host_reads, profiling.newton_outers,
                              profiling.host_read_wait_s)
    ncyc = 4
    advance(sim, ncyc, [observe])
    assert profiling.newton_outers - outers0 == sum(len(its) for its in steps)
    cg_tests = newton_tests = 0
    if rad is not None:
        cfg = rad.cfg
        assert all(len(its) >= 1 for its in steps)
        # a CG solve tests once an iteration and once more where it
        # converged; a Newton loop tests before every outer after the first
        # and once more where it converged
        cg_tests = sum(it + (it < cfg.cg_maxiter) for its in steps for it in its)
        newton_tests = sum(len(its) - 1 + (len(its) < cfg.coupled_iters) for its in steps)
    assert profiling.host_reads - reads0 == cg_tests + newton_tests + ncyc + 1
    assert profiling.host_read_wait_s > wait0


# each span's nearest enclosing ``artemis.*`` span
PARENT = {"artemis.cycle": None, "artemis.stage": "artemis.cycle",
          "artemis.radiation": "artemis.cycle", "artemis.newton": "artemis.radiation",
          "artemis.cg": "artemis.newton", "artemis.host_read.dt": "artemis.cycle",
          "artemis.host_read.newton_test": "artemis.radiation",
          "artemis.host_read.cg_test": "artemis.cg"}
KERNEL_PARENTS = ("artemis.stage", "artemis.radiation", "artemis.newton", "artemis.cg")


def artemis_parent(evt):
    p = evt.cpu_parent
    while p is not None and not p.name.startswith("artemis."):
        p = p.cpu_parent
    return p


@pytest.mark.parametrize("deck", DECKS)
def test_spans_nest_under_the_profiler(tmp_path, deck):
    sim = build(tmp_path, deck)
    advance(sim, 1)
    assert profiling.span("cycle") is profiling._NULL
    assert profiling.kernel_span("fld_matvec", "plain", "cpu") is profiling._NULL
    reads0, outers0 = profiling.host_reads, profiling.newton_outers
    its = []
    rad = sim.driver.radiation
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        advance(sim, 1, [lambda st, tm: its.extend(rad.cg_iters if rad else [])])
    assert profiling.span("cycle") is profiling._NULL
    events = [e for e in prof.events() if e.name.startswith("artemis.")]
    names = [e.name for e in events]
    for e in events:
        parent = artemis_parent(e)
        if e.name.startswith("artemis.kernel."):
            assert parent is not None and (parent.name in KERNEL_PARENTS
                                           or parent.name.startswith("artemis.kernel.")), e.name
        elif not (e.name == "artemis.host_read.dt" and parent is None):
            assert (None if parent is None else parent.name) == PARENT[e.name], e.name
    # evolve's opening dt precedes its loop: one dt a cycle inside it
    assert names.count("artemis.host_read.dt") == 2
    assert names.count("artemis.cycle") == 1
    assert names.count("artemis.stage") == sim.driver.integrator.nstages
    assert sum(n.startswith("artemis.host_read.") for n in names) == \
        profiling.host_reads - reads0
    assert any(n.startswith("artemis.kernel.") for n in names)
    if rad is not None:
        assert names.count("artemis.radiation") == 1
        assert names.count("artemis.newton") == profiling.newton_outers - outers0 == len(its)
        # each CG iteration, and each solve's closing test
        assert names.count("artemis.cg") == sum(it + (it < rad.cfg.cg_maxiter) for it in its)
        assert {"artemis.kernel.fld_coeffs", "artemis.kernel.fld_matvec"} <= set(names)
    scalar = [e for e in prof.events() if e.name in ("aten::item", "aten::_local_scalar_dense")]
    assert scalar
    for e in scalar:
        parent = artemis_parent(e)
        assert parent is not None and parent.name.startswith("artemis.host_read."), e.name


@pytest.mark.parametrize("deck", DECKS)
def test_profiler_leaves_the_states_bitwise(tmp_path, deck):
    off, on = build(tmp_path / "off", deck), build(tmp_path / "on", deck)
    advance(off, 3)
    with profile(activities=[ProfilerActivity.CPU]):
        advance(on, 3)
    assert on.tm.dt == off.tm.dt and on.tm.time == off.tm.time
    a, b = state_to_numpy(off.state), state_to_numpy(on.state)
    assert a.keys() == b.keys()
    for name in a:
        for k in a[name]:
            assert np.array_equal(a[name][k], b[name][k]), (name, k)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("deck", DECKS)
def test_card_syncs_are_the_host_reads(cuda, tmp_path, deck):
    """On the card, with the kernels: every operation that synchronises the
    host with the device over a run of cycles is one of ``host_reads``."""
    sim = build(tmp_path, deck, device=cuda)
    advance(sim, 2)
    torch.cuda.synchronize()
    reads0 = profiling.host_reads
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            advance(sim, 3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == profiling.host_reads - reads0 >= 4
