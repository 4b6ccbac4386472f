"""N-body coupling and dust on refinement trees in the port
(``artemis_tpu_torch.amr``) against the JAX package's, on the CPU, in
float64:

* (a) tests/test_amr_multilevel.py's tracking patch on
  ``inputs/disk_nbody_cyl.in`` at 64x64 (``numlevel = 1``, an inline
  ``planet1`` with refine_distance 0.3): placed where JAX places it, lo
  (33, 28, 0) and n (18, 8, 1); with ``check_interval = 4`` it moves at
  cycle 20 (a curvilinear move, the patch rebuilt at (33, 29, 0)): the
  same position after every cycle, the particles at 1e-12 and both levels
  at 1e-12 of each array's max after the move;
* (b) ``<nbody> refine_type = none`` and ``disable_outputs`` as in
  tests/test_amr_multilevel.py: no tracking patch, no .reb/.orb files;
  and N-body gravity's force rows with a level's cover mask at 1e-12;
* (c) the port checkpointed right after the move and resumed for 4 cycles
  ends bitwise equal to its straight run, the patch rebuilt at the
  checkpoint's ``lo``; the same checkpoint in the JAX package restores the
  position (``_los``) but not the patch's grid, which stays where the
  deck's particles put it (a reference deviation, ROADMAP Queue 3 item 6);
* (d) the advection deck's gas and two dust species on a static tree
  (32x16x16 root, a 16x8x8 patch) for 3 cycles: every fluid on both nodes
  at 1e-12 of each array's max, the mass of the gas and of each dust
  species conserved to 1e-12 over cycles 1-3, and each package's final
  checkpoint loading in the other with numpy-equal node states.

The JAX runs share module-scoped fixtures.
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

from artemis_tpu_torch import Simulation  # noqa: E402
from artemis_tpu_torch.state import tree_to_numpy  # noqa: E402

DTYPE = torch.float64
INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "inputs")
NBODY_DECK = os.path.join(INPUTS, "disk_nbody_cyl.in")
ADVECTION = os.path.join(INPUTS, "advection.in")
TRACK = ["parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64", "parthenon/mesh/refinement=static",
         "parthenon/mesh/numlevel=1", "parthenon/refinement/check_interval=4",
         "nbody/planet1/mass=1.0e-4", "nbody/planet1/a=2.0", "nbody/planet1/f=0.0",
         "nbody/planet1/refine_distance=0.3", "nbody/disable_outputs=true"]
MOVE = 20                       # the cycle whose retag moves the patch
LO0, LO1, N = (33, 28, 0), (33, 29, 0), (18, 8, 1)


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def snapshot(sim):
    """Host copies of the tree's node states and of the particles."""
    return {"states": tree_to_numpy(sim.driver._states), "pos": np.array(sim.nbody.pos),
            "vel": np.array(sim.nbody.vel)}


@pytest.fixture(scope="module")
def tracking_runs(tmp_path_factory):
    """The tracking tree in JAX for MOVE cycles and in the port for MOVE + 4,
    each patch position read after every cycle; the port writes a
    checkpoint and a snapshot after cycle MOVE."""
    tmp = tmp_path_factory.mktemp("track")
    out = {}
    jsim = JSimulation(NBODY_DECK, TRACK + [f"parthenon/time/nlim={MOVE}"], str(tmp / "jax"))
    out["jax_init_lo"] = jsim.driver.smr.nodes[1].lo
    jlos = []
    jsim.run(extra_observers=[
        lambda state, tm: jlos.append(tuple(int(v) for v in np.asarray(jsim.driver._los[1])))])
    out["jax"] = dict(sim=jsim, los=jlos, end=snapshot(jsim))

    tsim = Simulation(NBODY_DECK, TRACK + [f"parthenon/time/nlim={MOVE + 4}"],
                      str(tmp / "port"), device="cpu")
    out["port_init"] = (dict(tsim.driver._particle_nodes),
                        [(nd.lo, nd.n) for nd in tsim.driver.smr.nodes[1:]])
    tlos, at_move = [], {}

    def observe(state, tm):
        tlos.append(tsim.driver.smr.nodes[1].lo)
        if tm.ncycle == MOVE:
            at_move.update(snapshot(tsim))
            at_move["path"] = tsim.write_restart(str(tmp / "port" / "move"), state=state, tm=tm)

    tsim.run(extra_observers=[observe])
    out["port"] = dict(sim=tsim, los=tlos, move=at_move, end=snapshot(tsim))
    return out


def test_tracking_placement_matches_jax(tracking_runs):
    """One tracking node, for particle 5 (the inline planet after the star
    and the deck's four), at JAX's lo (33, 28, 0) with n (18, 8, 1)."""
    j = tracking_runs["jax"]["sim"]
    nodes, rows = tracking_runs["port_init"]
    assert nodes == j.driver._particle_nodes == {1: 5}
    assert rows == [(LO0, N)] and tracking_runs["jax_init_lo"] == LO0
    assert tracking_runs["port"]["sim"].driver.smr.nodes[1].curv


def test_tracking_move_matches_jax(tracking_runs):
    """The patch moves at cycle MOVE in both packages, to (33, 29, 0); after
    the move the particles and every node state agree at 1e-12."""
    j, t = tracking_runs["jax"], tracking_runs["port"]
    assert j["los"] == t["los"][:MOVE] == [LO0] * (MOVE - 1) + [LO1]
    assert t["los"][MOVE:] == [LO1] * 4
    for k in ("pos", "vel"):
        assert rel(t["move"][k], j["end"][k]) <= 1e-12
    for a, b in zip(t["move"]["states"], j["end"]["states"]):
        for k in ("u", "w"):
            assert rel(a["gas"][k], b["gas"][k]) <= 1e-12
    node = t["sim"].driver.smr.nodes[1]
    pg = t["sim"].grid
    assert node.grid.xmin[1] == pg.geom.xf2[pg.ng[1] + LO1[1]]


def test_tracking_resume_is_bitwise(tracking_runs, tmp_path):
    """The port resumed from its checkpoint after the move: the patch is
    rebuilt at the checkpoint's lo, and 4 cycles end bitwise equal to the
    straight run, particles included.  The JAX package loading the same
    checkpoint restores the position but keeps the patch's grid at the
    deck's placement (artemis_tpu/amr.py:3049-3079), so its resumed run
    departs from its straight one."""
    t = tracking_runs["port"]
    path = t["move"]["path"]
    resumed = Simulation(NBODY_DECK, TRACK + [f"parthenon/time/nlim={MOVE + 4}"],
                         str(tmp_path / "port"), device="cpu", restart=path)
    node = resumed.driver.smr.nodes[1]
    straight = t["sim"].driver.smr.nodes[1]
    assert node.lo == LO1 and node.grid.xmin == straight.grid.xmin
    assert resumed.driver._ncycle == resumed.tm.ncycle == MOVE
    resumed.run()
    assert resumed.tm.ncycle == MOVE + 4 and node.lo == LO1
    end = snapshot(resumed)
    assert np.array_equal(end["pos"], t["end"]["pos"])
    assert np.array_equal(end["vel"], t["end"]["vel"])
    for a, b in zip(end["states"], t["end"]["states"]):
        for k in ("u", "w"):
            assert np.array_equal(a["gas"][k], b["gas"][k])
    jsim = JSimulation(NBODY_DECK, TRACK + [f"parthenon/time/nlim={MOVE + 4}"],
                       str(tmp_path / "jax"), restart=path)
    jnode = jsim.driver.smr.nodes[1]
    assert tuple(int(v) for v in np.asarray(jsim.driver._los[1])) == LO1
    assert jnode.lo == LO0 and jnode.grid.xmin != straight.grid.xmin


def test_nbody_gravity_cover_mask_matches_jax():
    """On a tree level, N-body gravity's force rows leave out the cells a
    finer level covers (ctx["mask"], artemis_tpu/sources.py:855-861): the
    disk_nbody_cyl sources of tests/test_torch_nbody.py with a sink next
    to the gas, a covered block holding it, applied once with dt = 0.01 in
    both packages: u and the rows within 1e-12 abs, the masked rows apart
    from the unmasked ones (the sink's mass row included)."""
    from .test_torch_nbody import DISK_NBODY, both_sources

    (jsrcs, jh, jnb), (tsrcs, th, tnb), w, u = both_sources(DISK_NBODY)
    js, ts = jsrcs[0], tsrcs[0]
    mask = np.ones(w.shape[2:])
    ny, nx = w.shape[3:]
    mask[:, ny // 2 - 4:ny // 2 + 4, nx // 2 - 4:nx // 2 + 4] = 0.0
    dt = 0.01
    rows = {}
    for name, m in (("masked", mask), ("plain", None)):
        with jax.enable_x64(True):
            jctx = {"particles": jnb.particle_pytree(),
                    "mask": None if m is None else jnp.asarray(m)}
            ju = np.asarray(js.apply({"gas": {"u": jnp.asarray(u), "w": jnp.asarray(w)}}, None,
                                     jnp.asarray(0.0), jnp.asarray(dt), jh, ctx=jctx)["gas"]["u"])
        tctx = {"particles": tnb.particle_pytree("cpu", DTYPE),
                "mask": None if m is None else torch.as_tensor(m)}
        tu = ts.apply({"gas": {"u": torch.as_tensor(u), "w": torch.as_tensor(w)}}, None, 0.0,
                      torch.tensor(dt, dtype=DTYPE), th, ctx=tctx)["gas"]["u"].numpy()
        assert float(np.abs(tu - ju).max()) <= 1e-12
        rows[name] = tctx["pforce"].numpy()
        assert float(np.abs(rows[name] - np.asarray(jctx["pforce"])).max()) <= 1e-12
    assert (rows["masked"][-1, :4] != rows["plain"][-1, :4]).all()


def test_refine_type_none_disables_tracking(tmp_path):
    """refine_type = none: no tracking patch though the planet asks for
    one; disable_outputs: no .reb/.orb files."""
    sim = Simulation(NBODY_DECK, TRACK + ["nbody/refine_type=none", "parthenon/time/nlim=1"],
                     str(tmp_path), device="cpu")
    assert not sim.driver._particle_nodes and len(sim.driver.smr.nodes) == 1
    sim.run()
    assert np.isfinite(sim.state["gas"]["w"].numpy()).all()
    assert not glob.glob(str(tmp_path / "*.reb")) and not glob.glob(str(tmp_path / "*.orb"))


# ---------------------------------------------------------------------------
# (d) the dust tree
# ---------------------------------------------------------------------------

DUST_TREE = ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=16", "parthenon/mesh/nx3=16",
             "parthenon/mesh/refinement=static", "parthenon/refinement/patch_nx1=16",
             "parthenon/refinement/patch_nx2=8", "parthenon/refinement/patch_nx3=8",
             "parthenon/time/nlim=3", "parthenon/output9/file_type=rst",
             "parthenon/output9/dt=100.0"]
DUST_RST = "advection.out9.final.rst.npz"


def masses(sim):
    """Root totals of the gas and of each dust species (the root carries
    the restricted fine solution)."""
    vol = sim.driver.smr.root.hydro.vol
    st = sim.driver._states[0]
    return np.array([float((st["gas"]["u"][0, 0] * vol).sum())]
                    + [float((st["dust"]["u"][s, 0] * vol).sum())
                       for s in range(st["dust"]["u"].shape[0])])


@pytest.fixture(scope="module")
def dust_runs(tmp_path_factory):
    out = {}
    for pkg in ("jax", "port"):
        d = tmp_path_factory.mktemp(pkg)
        sim = (JSimulation(ADVECTION, DUST_TREE, str(d)) if pkg == "jax"
               else Simulation(ADVECTION, DUST_TREE, str(d), device="cpu"))
        seen = []
        if pkg == "port":
            sim.run(extra_observers=[lambda state, tm: seen.append(masses(sim))])
        else:
            sim.run()
        out[pkg] = dict(sim=sim, dir=d, masses=seen)
    return out


def test_dust_tree_matches_jax(dust_runs):
    j, t = dust_runs["jax"]["sim"], dust_runs["port"]["sim"]
    assert t.driver.smr.nodes[1].lo == j.driver.smr.nodes[1].lo == (8, 4, 4)
    assert t.driver.stage_kernel == "none" and t.tm.ncycle == j.tm.ncycle == 3
    tt, jj = tree_to_numpy(t.driver._states), tree_to_numpy(j.driver._states)
    for a, b in zip(tt, jj):
        assert sorted(a) == sorted(b) == ["dust", "gas"]
        assert a["dust"]["u"].shape[0] == 2
        for fl in ("gas", "dust"):
            for k in ("u", "w"):
                assert rel(a[fl][k], b[fl][k]) <= 1e-12
    m = dust_runs["port"]["masses"]
    assert len(m) == 3
    assert (np.abs(m[-1] - m[0]) <= 1e-12 * np.abs(m[0])).all()


@pytest.mark.parametrize("src", ["jax", "port"])
def test_dust_tree_restart_across_packages(dust_runs, tmp_path, src):
    """Each package's final checkpoint of the dust tree loads in the other
    with numpy-equal node states of every fluid."""
    r = dust_runs[src]
    path = str(r["dir"] / DUST_RST)
    sim = (Simulation(ADVECTION, DUST_TREE, str(tmp_path), device="cpu", restart=path)
           if src == "jax" else JSimulation(ADVECTION, DUST_TREE, str(tmp_path), restart=path))
    for a, b in zip(tree_to_numpy(sim.driver._states), tree_to_numpy(r["sim"].driver._states)):
        for fl in ("gas", "dust"):
            for k in ("u", "w"):
                assert np.array_equal(a[fl][k], b[fl][k])
