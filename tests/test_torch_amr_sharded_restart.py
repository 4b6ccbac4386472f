"""Sharded refinement trees in the port (``artemis_tpu_torch.parallel.amr``):
twins of tests/test_amr_sharded.py's restarts, and checkpoints across the
shard count.

* The linear-wave tree with a wrap patch on x3 slabs, four shards on
  ``cpu``, resumed from its checkpoint at cycle 10: every level bitwise the
  straight run's at tlim.  The same checkpoint holds global arrays: the
  port's unsharded tree loads it with every node's u bitwise the sharded
  tree's, and the JAX package's Simulation reads it to the same arrays.
* The cylindrical planet disk with a replicated tracking patch, resumed at
  cycle 8: the root, the patch and the particles bitwise the straight
  run's.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

from artemis_tpu_torch import Simulation  # noqa: E402

INP = os.path.join(os.path.dirname(__file__), "..", "inputs")
LINWAVE = os.path.join(INP, "linwave.in")
NBODY = os.path.join(INP, "disk_nbody_cyl.in")

LIN_ARGS = ["parthenon/mesh/nghost=2", "parthenon/mesh/nx1=32", "parthenon/mesh/nx2=8",
            "parthenon/mesh/nx3=16", "problem/amp=1.0e-6", "gas/reconstruct=plm",
            "parthenon/mesh/refinement=static", "parthenon/refinement/patch_nx1=16",
            "parthenon/refinement/patch_nx2=4"]


# tlim 0.1 (about 30 cycles; the JAX test's 0.3 is about 90): the resumed
# run goes 20 cycles past its checkpoint
RST_ARGS = LIN_ARGS + ["parthenon/refinement/patch_nx3=16", "parthenon/time/tlim=0.1"]


@pytest.fixture(scope="module")
def sharded_restart(tmp_path_factory):
    """The sharded linear-wave tree straight to tlim, and the same run in
    two pieces through a checkpoint at cycle 10."""
    d1 = str(tmp_path_factory.mktemp("straight"))
    s1 = Simulation(LINWAVE, RST_ARGS, d1, device="cpu", nshards=4)
    s1.run()
    d2 = str(tmp_path_factory.mktemp("chunked"))
    s2 = Simulation(LINWAVE, RST_ARGS + ["parthenon/output9/file_type=rst",
                                         "parthenon/output9/dt=0.1", "parthenon/time/nlim=10"],
                    d2, device="cpu", nshards=4)
    s2.run()
    rst = os.path.join(d2, [f for f in os.listdir(d2) if f.endswith("final.rst.npz")][0])
    return s1, d2, rst


def test_sharded_amr_restart_bitexact(sharded_restart):
    """A sharded tree resumed from its checkpoint ends with every level
    bitwise equal to the straight run (the payloads hold the gathered
    global arrays; loading splits them again)."""
    s1, d2, rst = sharded_restart
    s3 = Simulation(LINWAVE, RST_ARGS, d2, device="cpu", restart=rst, nshards=4)
    assert s3.driver._states is not None, "fine level not restored"
    s3.run()
    assert s3.tm.ncycle == s1.tm.ncycle
    for lvl in (0, 1):
        a = s1.driver._states[lvl]["gas"]["u"].numpy()
        b = s3.driver._states[lvl]["gas"]["u"].numpy()
        assert np.array_equal(a, b), f"level-{lvl} restart mismatch: {np.abs(a - b).max():g}"


def test_sharded_checkpoint_loads_unsharded_and_in_jax(sharded_restart, tmp_path):
    """The sharded tree's checkpoint holds global arrays: the port's
    unsharded tree loads it with every node's u bitwise the sharded
    tree's, and the JAX package's Simulation reads it to the same arrays."""
    _, _, rst = sharded_restart
    shard = Simulation(LINWAVE, RST_ARGS, str(tmp_path / "a"), device="cpu", restart=rst,
                       nshards=4)
    whole = Simulation(LINWAVE, RST_ARGS, str(tmp_path / "b"), device="cpu", restart=rst)
    jsim = JSimulation(LINWAVE, overrides=RST_ARGS, data_dir=str(tmp_path / "c"), restart=rst)
    for sim in (shard, whole):
        sim.driver._ensure_states(sim.state)
    assert whole.tm.ncycle == shard.tm.ncycle == jsim.tm.ncycle == 10
    for i in (0, 1):
        a = shard.driver._states[i]["gas"]["u"].numpy()
        assert np.array_equal(a, whole.driver._states[i]["gas"]["u"].numpy()), i
    assert np.array_equal(np.asarray(jsim.state["gas"]["u"]),
                          shard.driver._states[0]["gas"]["u"].numpy())
    assert np.array_equal(np.asarray(jsim.driver._states[1]["gas"]["u"]),
                          shard.driver._states[1]["gas"]["u"].numpy())


TRACK_ARGS = ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=1",
              "parthenon/time/tlim=0.2", "parthenon/mesh/refinement=static",
              "parthenon/mesh/numlevel=1", "nbody/planet1/mass=1.0e-4", "nbody/planet1/a=2.0",
              "nbody/planet1/f=0.0", "nbody/planet1/refine_distance=0.3"]


def test_sharded_tracking_restart_bitexact(tmp_path):
    """A sharded tree with a replicated tracking patch resumed from its
    checkpoint restores the patch and the particle system bit for bit."""
    d1 = str(tmp_path / "straight")
    s1 = Simulation(NBODY, TRACK_ARGS, d1, device="cpu", nshards=4)
    s1.run()
    d2 = str(tmp_path / "chunked")
    s2 = Simulation(NBODY, TRACK_ARGS + ["parthenon/output9/file_type=rst",
                                         "parthenon/output9/dt=0.05", "parthenon/time/nlim=8"],
                    d2, device="cpu", nshards=4)
    s2.run()
    rst = os.path.join(d2, [f for f in os.listdir(d2) if f.endswith("final.rst.npz")][0])
    s3 = Simulation(NBODY, TRACK_ARGS, d2, device="cpu", restart=rst, nshards=4)
    assert s3.driver._states is not None, "fine level not restored"
    s3.run()
    assert s3.tm.ncycle == s1.tm.ncycle
    ni = next(iter(s1.driver._particle_nodes))
    assert s1.driver.smr.nodes[ni].replicated
    for lvl in (0, ni):
        a = s1.driver._states[lvl]["gas"]["u"].numpy()
        b = s3.driver._states[lvl]["gas"]["u"].numpy()
        assert np.array_equal(a, b), f"node-{lvl} restart mismatch: {np.abs(a - b).max():g}"
    assert np.array_equal(s1.nbody.pos, s3.nbody.pos)
