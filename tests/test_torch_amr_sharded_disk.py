"""Sharded refinement trees in the port (``artemis_tpu_torch.parallel.amr``):
twins of tests/test_amr_sharded.py's curvilinear and N-body cases.

Each twin runs the port's ``Simulation(..., device="cpu", nshards=4)`` and
holds it against the port's own unsharded tree at the JAX test's tolerance,
with the same decks, overrides and sizes; the two full-phi rings, the cases
also run by the JAX package, run 5 cycles where the JAX test runs 10 (every
stage exchanges the ring's slabs from the first cycle on):

* the spherical viscous disk (``disk_sph``) on phi slabs, its full-phi ring
  a wrap patch (1e-9 of the maximum; each shard's geometry is built on its
  own window), also against the JAX package's serial tree;
* the same disk with a phi-partial ring distributed over the shards (the
  geometry does not vary along phi; root and patch 1e-11);
* the cylindrical planet disk (``disk_nbody_cyl``) with a full-phi ring: the
  N-body force rows summed over the shards (gas 1e-11, particles 1e-14),
  also against the JAX package's serial tree;
* a planet's ``refine_distance`` tracking patch as a replicated node (gas
  1e-11 on the root and the patch, particles 1e-14).
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
DISK = os.path.join(INP, "disk_sph.in")
NBODY = os.path.join(INP, "disk_nbody_cyl.in")

DISK_ARGS = ["parthenon/time/nlim=10", "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=16",
             "parthenon/mesh/nx3=16", "parthenon/mesh/refinement=static",
             "parthenon/refinement/patch_nx1=32", "parthenon/refinement/patch_nx2=8"]
# the full-phi rings' cycles (the last override wins)
RING_NLIM = "parthenon/time/nlim=5"


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(a).max()


@pytest.mark.parametrize("case", ["ring", "distributed"])
def test_sharded_amr_disk_phi(case, tmp_path):
    """The production shape: ring refinement of the 3-D spherical viscous
    disk (alpha viscosity, gravity, rotating frame, custom ic boundaries)
    on phi slabs.  The full-phi ring is a wrap patch; a phi-partial ring
    under ``amr_distribute`` is split into quarters.  The full ring's root
    within 1e-9 of the maximum of the port's serial tree and of the JAX
    package's; the distributed ring's root, and either patch, within
    1e-11."""
    extra = (["parthenon/refinement/patch_nx3=16", RING_NLIM] if case == "ring"
             else ["parthenon/refinement/patch_nx3=8", "artemis/amr_distribute=true"])
    args = DISK_ARGS + extra
    s0 = Simulation(DISK, args, str(tmp_path / "serial"), device="cpu")
    s0.run()
    s1 = Simulation(DISK, args, str(tmp_path / "shard"), device="cpu", nshards=4)
    node = s1.driver.smr.nodes[1]
    assert node.curv and node.wrap[2] == (case == "ring")
    assert node.distributed == (case == "distributed")
    assert node.grid.nx[2] == s0.driver.smr.nodes[1].grid.nx[2] // 4
    s1.run()
    b = s1.state["gas"]["w"].numpy()
    assert np.isfinite(b).all()
    assert _rel(s0.state["gas"]["w"], b) < (1e-9 if case == "ring" else 1e-11)
    a1, b1 = s0.driver._states[1]["gas"]["w"], s1.driver._states[1]["gas"]["w"]
    assert a1.shape == b1.shape and _rel(a1, b1) < 1e-11
    if case == "ring":
        j = JSimulation(DISK, overrides=args, data_dir=str(tmp_path / "jax"))
        j.run()
        assert _rel(j.state["gas"]["w"], b) < 1e-9


RING_ARGS = ["parthenon/time/nlim=10", "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64",
             "parthenon/mesh/nx3=1", "parthenon/mesh/refinement=static",
             "parthenon/refinement/patch_nx1=32", "parthenon/refinement/patch_nx2=64"]
TRACK_ARGS = ["parthenon/time/nlim=10", "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64",
              "parthenon/mesh/nx3=1", "parthenon/mesh/refinement=static",
              "parthenon/mesh/numlevel=1", "nbody/planet1/mass=1.0e-4", "nbody/planet1/a=2.0",
              "nbody/planet1/f=0.0", "nbody/planet1/refine_distance=0.3"]


@pytest.mark.parametrize("case", ["ring", "tracking"])
def test_sharded_amr_nbody(case, tmp_path):
    """Live planets under sharded refinement (the 2-D cylindrical planet
    disk on phi slabs): each shard's force rows summed over the shards in
    shard order, the particle system advanced once on the host.  A full-phi
    ring is a wrap patch; a planet's refine_distance patch is a small
    (r, phi) box, a replicated node (ghosts from the gathered parent,
    restriction and area-weighted flux correction scattered into each
    shard's window).  Gas within 1e-11 of the port's serial tree on the root
    and the patch, particles within 1e-14 (the ring also of the JAX
    package's serial tree)."""
    args = RING_ARGS + [RING_NLIM] if case == "ring" else TRACK_ARGS
    s0 = Simulation(NBODY, args, str(tmp_path / "serial"), device="cpu")
    s1 = Simulation(NBODY, args, str(tmp_path / "shard"), device="cpu", nshards=4)
    if case == "tracking":
        assert s0.driver._particle_nodes and s1.driver._particle_nodes
        ni = next(iter(s1.driver._particle_nodes))
        node = s1.driver.smr.nodes[ni]
        assert node.replicated and not any(node.wrap)
    else:
        ni = 1
        assert s1.driver.smr.nodes[1].wrap[1]
    s0.run()
    s1.run()
    for idx in (0, ni):
        b = s1.driver._states[idx]["gas"]["w"].numpy()
        assert np.isfinite(b).all()
        assert _rel(s0.driver._states[idx]["gas"]["w"], b) < 1e-11, idx
    assert np.abs(s0.nbody.pos - s1.nbody.pos).max() < 1e-14
    if case == "ring":
        j = JSimulation(NBODY, overrides=args, data_dir=str(tmp_path / "jax"))
        j.run()
        assert _rel(j.state["gas"]["w"], s1.state["gas"]["w"].numpy()) < 1e-11
        assert np.abs(np.asarray(j.nbody.pos) - s1.nbody.pos).max() < 1e-14
