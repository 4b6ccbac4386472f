"""Sharded refinement trees in the port (``artemis_tpu_torch.parallel.amr``,
``ShardedSMR``): twins of tests/test_amr_sharded.py's Cartesian boxes (its restarts are in
tests/test_torch_amr_sharded_restart.py, its adaptive cases in
tests/test_torch_amr_sharded_adaptive.py, its disks in
tests/test_torch_amr_sharded_disk.py: four files that ``--dist loadfile``
spreads over the workers).

Each twin runs the port's ``Simulation(..., device="cpu", nshards=4)`` (four
shard trees on ``cpu``, in lockstep) and holds it against the port's own
unsharded tree at the JAX test's tolerance, or bitwise where the JAX test
asks ``array_equal``, with the same decks, overrides and sizes; the linear
waves run 10 cycles where the JAX test runs 20 (every stage exchanges the
patch's slabs from the first cycle on):

* the linear wave on x3 slabs as a wrap patch, a replicated patch, a
  distributed patch (``<artemis> amr_distribute``) and an uneven extent that
  falls back to replication (one parametrised test), each also against the
  JAX package's serial tree (1e-13, its runs shared by a module fixture);
* gray FLD on a wrap patch and on a distributed patch (1e-11 of each
  field's maximum), the distributed one also against the JAX package's
  serial tree;
* the profiler's phase table on a sharded tree, the profiled run ending
  bitwise as an unprofiled one;
* the shard trees' scheduler under a shortened switch interval: one shard
  at a time in shard order, every value to every shard, an exception to
  the caller.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

from artemis_tpu_torch import Simulation  # noqa: E402
from artemis_tpu_torch.parallel.amr import ShardedSMR  # noqa: E402

INP = os.path.join(os.path.dirname(__file__), "..", "inputs")
LINWAVE = os.path.join(INP, "linwave.in")
SHOCK = os.path.join(INP, "rad_shock.in")

LIN_ARGS = ["parthenon/mesh/nghost=2", "parthenon/mesh/nx1=32", "parthenon/mesh/nx2=8",
            "parthenon/mesh/nx3=16", "problem/amp=1.0e-6", "gas/reconstruct=plm",
            "parthenon/mesh/refinement=static", "parthenon/refinement/patch_nx1=16",
            "parthenon/refinement/patch_nx2=4"]
# case -> (extra overrides, nlim, the node's kind)
LIN_CASES = {
    "wrap": (["parthenon/refinement/patch_nx3=16"], 10, "wrap"),
    "replicated": (["parthenon/refinement/patch_nx3=8"], 10, "replicated"),
    "distributed": (["parthenon/refinement/patch_nx3=8", "artemis/amr_distribute=true"], 10,
                    "distributed"),
    # 6 does not split into even slices over 4 shards
    "uneven": (["parthenon/refinement/patch_nx3=6", "artemis/amr_distribute=true"], 2,
               "replicated"),
}


def _gas_w(sim, i):
    return np.asarray(sim.driver._states[i]["gas"]["w"])


@pytest.fixture(scope="module")
def jax_linwave(tmp_path_factory):
    """The JAX package's serial linear-wave trees, one run per patch."""
    runs = {}

    def run(extra, nlim):
        key = (tuple(e for e in extra if "patch" in e), nlim)
        if key not in runs:
            s = JSimulation(LINWAVE, overrides=LIN_ARGS + [f"parthenon/time/nlim={nlim}", *key[0]],
                            data_dir=str(tmp_path_factory.mktemp("jax_lin")))
            s.run()
            runs[key] = [np.asarray(s.driver._states[i]["gas"]["w"]) for i in (0, 1)]
        return runs[key]

    return run


@pytest.mark.parametrize("case", sorted(LIN_CASES))
def test_sharded_linwave_tree_matches_serial(case, tmp_path, jax_linwave):
    """A wrap patch (``nodes[1].wrap[2]``), a replicated one, a distributed
    one (a quarter of the fine x3 cells per shard) and an uneven extent
    that replicates: every level within 1e-13 of the port's serial tree and
    of the JAX package's (a distributed patch reassembles to the serial
    shape)."""
    extra, nlim, kind = LIN_CASES[case]
    args = LIN_ARGS + [f"parthenon/time/nlim={nlim}", *extra]
    s0 = Simulation(LINWAVE, args, str(tmp_path / "serial"), device="cpu")
    s0.run()
    s1 = Simulation(LINWAVE, args, str(tmp_path / "shard"), device="cpu", nshards=4)
    assert isinstance(s1.driver.smr, ShardedSMR)
    node = s1.driver.smr.nodes[1]
    assert node.wrap[2] == (kind == "wrap")
    assert node.replicated == (kind == "replicated")
    assert node.distributed == (kind == "distributed")
    nx3 = s0.driver.smr.nodes[1].grid.nx[2]
    assert node.grid.nx[2] == (nx3 if kind == "replicated" else nx3 // 4)
    s1.run()
    ref = jax_linwave(extra, nlim) if case != "uneven" else None
    for lvl in (0, 1):
        a, b = _gas_w(s0, lvl), _gas_w(s1, lvl)
        assert a.shape == b.shape
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() < 1e-13, (lvl, np.abs(a - b).max())
        if ref is not None:
            assert np.abs(ref[lvl] - b).max() < 1e-13, (lvl, np.abs(ref[lvl] - b).max())


SHOCK_ARGS = ["parthenon/time/nlim=10", "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=1",
              "parthenon/mesh/ix3_bc=periodic", "parthenon/mesh/ox3_bc=periodic",
              "parthenon/mesh/x3min=0.0", "parthenon/mesh/x3max=1.0",
              "parthenon/mesh/refinement=static", "parthenon/refinement/patch_nx1=32",
              "parthenon/refinement/patch_nx3=8"]


@pytest.mark.parametrize("case", ["wrap", "distributed"])
def test_sharded_amr_radiation(case, tmp_path):
    """Gray FLD on sharded levels: per-level CG solves on fields that hold
    one tensor per shard, Dirichlet parent planes at the wrap patch's
    exchanged seams or, on a distributed patch, only at its global end
    faces.  The gas and Er within 1e-11 of each field's maximum of the
    port's serial tree; the distributed patch also of the JAX package's."""
    extra = (["parthenon/mesh/nx3=8"] if case == "wrap"
             else ["parthenon/mesh/nx3=16", "artemis/amr_distribute=true"])
    args = SHOCK_ARGS + extra
    s0 = Simulation(SHOCK, args, str(tmp_path / "serial"), device="cpu")
    s0.run()
    s1 = Simulation(SHOCK, args, str(tmp_path / "shard"), device="cpu", nshards=4)
    node = s1.driver.smr.nodes[1]
    assert node.radiation is not None
    assert node.distributed == (case == "distributed") and node.wrap[2] == (case == "wrap")
    assert s1.driver.smr.node_radiation(node).nshards == 4
    s1.run()
    refs = [s0.state]
    if case == "distributed":
        j = JSimulation(SHOCK, overrides=args, data_dir=str(tmp_path / "jax"))
        j.run()
        refs.append(j.state)
    for ref in refs:
        for key, kind in (("gas", "w"), ("rad", "Er")):
            a = np.asarray(ref[key][kind])
            b = s1.state[key][kind].numpy()
            assert np.isfinite(b).all()
            rel = np.abs(a - b).max() / np.abs(a).max()
            assert rel < 1e-11, (key, kind, rel)


def test_sharded_tree_phase_table(tmp_path):
    """The profiler's phase table runs on a sharded tree (each RK stage and
    the dt estimate over every shard) and leaves the run it profiled as an
    unprofiled run ends, bit for bit."""
    from artemis_tpu_torch.profiling import phase_table

    extra = LIN_CASES["replicated"][0]
    args = LIN_ARGS + ["parthenon/time/nlim=3", *extra]
    runs = [Simulation(LINWAVE, args, str(tmp_path / name), device="cpu", nshards=4)
            for name in ("profiled", "plain")]
    phases = phase_table(runs[0], ncycles=1)
    assert set(phases) == {"stage1", "stage2", "dt_estimate"}
    for sim in runs:
        sim.run()
    for i in (0, 1):
        a, b = (sim.driver._states[i]["gas"]["u"].numpy() for sim in runs)
        assert np.array_equal(a, b), i


def test_lockstep_runs_one_shard_at_a_time_in_order():
    """The shard trees' scheduler (``parallel.amr._Lockstep``) under a
    shortened thread switch interval with more shards than cores: between
    two collectives the shards run one at a time in shard order (an
    unlocked read-modify-write of a shared counter loses no update, and
    the segments come in shard order), every shard gets every shard's
    value, and an exception in one shard reaches the caller without a hang."""
    import sys
    import threading

    from artemis_tpu_torch.parallel.amr import _Lockstep

    n, rounds = 2 * (os.cpu_count() or 4), 50
    lock = _Lockstep([torch.device("cpu")] * n)
    state = {"count": 0, "order": []}

    def shard(k):
        got = []
        for r in range(rounds):
            c = state["count"]
            for _ in range(50):
                pass
            state["count"] = c + 1
            state["order"].append(k)
            got.append(lock.collect(k, (k, r)))
        return got

    def fails(k):
        lock.collect(k, k)
        if k == n // 2:
            raise RuntimeError("shard failed")
        lock.collect(k, k)

    out, errors = {}, []

    def drive():
        out["got"] = lock.run(shard)
        try:
            lock.run(fails)
        except RuntimeError as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=drive, daemon=True)
        t.start()
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive(), "the lockstep hung"
    assert state["count"] == n * rounds
    assert state["order"] == list(range(n)) * rounds
    for got in out["got"]:
        assert got == [[(k, r) for k in range(n)] for r in range(rounds)]
    assert len(errors) == 1 and str(errors[0]) == "shard failed"
