"""Static mesh refinement in the port (``artemis_tpu_torch.amr``) against
the JAX package's tree (``artemis_tpu.amr``), on the CPU, in float64
unless stated; inputs are the deck's own or made from a seed with numpy:

* (a) the operators on a random two-node tree at 1e-12: ``prolong_minmod``,
  ``restrict_average``, the prolonged ghost slabs (one side and paired),
  the port's patch strips against the JAX slabs they are cut from,
  ``_apply_rim_delta_g6`` and ``_glue_parent_block``;
* (b) the composable tree (``inputs/disk_rhd_amr.in`` at a 32x32x8 root
  with its patch and radiation, 3 cycles, the JAX run's initial tree
  carried over by ``state.tree_from_numpy``) against the JAX jnp tree:
  every node's u and w at 1e-11 of each array's max, Er and the .hst rows
  at 1e-12 (times relative, conserved totals of the largest total);
* (c) the port's fused tree (the batched stage's plain version) against
  the JAX tree's node-batched K6 path in interpret mode, float32, the
  shape of tests/test_amr_gather6.py (128x32x8 root and an equal-shape
  patch), one step, at 4e-6 of each array's max;
* (d) the port's fused tree against its composable tree on (b)'s tree,
  u within 2e-6 of each variable's max and Er within 1e-12;
* (e) a static sibling pair through the fused tree's six-face halo and
  its padded halo, bitwise;
* a three-level 2-D tree (tests/test_amr_multilevel.py's box, two level-1
  patches and a nested level-2 one) against the JAX tree at 1e-12 after
  3 cycles, then conserving mass and energy to 1e-13 over 18 more;
* the refined deck through the CLI, a curvilinear tree that runs, and
  the twin of tests/test_decks.py's refined linear wave (L1 within 1.5x
  the unrefined run's).

The JAX package's interpret mode runs once, in (c).  The kernel's node
axis is tested in tests/test_torch_stage_curv.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from artemis_tpu_torch import Simulation  # noqa: E402
from artemis_tpu_torch import amr as A  # noqa: E402
from artemis_tpu_torch.state import (state_from_numpy, state_to_numpy,  # noqa: E402
                                     tree_from_numpy, tree_to_numpy)

DTYPE = torch.float64
DECK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "inputs",
                    "disk_rhd_amr.in")
# the deck at a 32x32x8 root: its patch [-1,1]^2 x [-0.25,0.25] is 16x16x4
# root cells, a 32x32x8 fine grid, the root's shape
SMALL = ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=8",
         "parthenon/time/nlim=3"]
HST = ["parthenon/output1/file_type=hst", "parthenon/output1/dt=1.0e-4"]
# two adjacent level-1 patches splitting the deck's window at x2 = 0
PAIR = ["parthenon/static_refinement1/x2min=-1.0", "parthenon/static_refinement1/x2max=0.0",
        "parthenon/static_refinement2/level=1",
        "parthenon/static_refinement2/x1min=-1.0", "parthenon/static_refinement2/x1max=1.0",
        "parthenon/static_refinement2/x2min=0.0", "parthenon/static_refinement2/x2max=1.0",
        "parthenon/static_refinement2/x3min=-0.25", "parthenon/static_refinement2/x3max=0.25"]


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def tree_rel(port_states, ref_states, keys=(("gas", "u"), ("gas", "w"), ("rad", "Er"))):
    """The worst per-array max |port - ref| / max |ref| over the nodes."""
    p, r = tree_to_numpy(port_states), tree_to_numpy(ref_states)
    assert len(p) == len(r)
    return max(rel(pi[f][k], ri[f][k]) for pi, ri in zip(p, r) for f, k in keys if f in ri)


def port_sim(tmp_path, overrides, tag="port"):
    return Simulation(DECK, overrides, str(tmp_path / tag), device="cpu")


def random_prims(shape, rng):
    """Smooth positive random primitives [1, 6, nz, ny, nx] (numpy)."""
    w = np.empty((1, 6) + shape)
    w[:, 0] = 1 + 0.2 * rng.random(shape)
    w[:, 1:4] = 0.3 * (rng.random((1, 3) + shape) - 0.5)
    w[:, 5] = 1 + 0.2 * rng.random(shape)
    w[:, 4] = 0.4 * w[:, 0] * w[:, 5]
    return w


# ---------------------------------------------------------------------------
# (a) the operators against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The JAX and the port's tree of the deck at a 32x32x8 root without
    radiation (two nodes), and a random tree state (numpy, float64)."""
    pytest.importorskip("jax")
    from artemis_tpu.simulation import Simulation as JSimulation

    tmp = tmp_path_factory.mktemp("trees")
    ov = SMALL + ["physics/radiation=false"]
    jsmr = JSimulation(DECK, ov, str(tmp / "jax")).driver.smr
    tsmr = Simulation(DECK, ov, str(tmp / "port"), device="cpu").driver.smr
    rng = np.random.default_rng(5)
    shape = tuple(reversed(tsmr.root.grid.nx))
    assert tuple(reversed(tsmr.nodes[1].grid.nx)) == shape
    st = {k: [random_prims(shape, rng) for _ in range(2)] for k in ("w", "u", "w1", "u1")}
    return jsmr, tsmr, st


def test_transfer_operators_match_jax(trees):
    """prolong_minmod and restrict_average on random arrays (3-D, and with
    an inactive axis), the one-sided and paired prolonged ghost slabs of the
    patch, its padded ghost fill, and the port's six strips against the JAX
    slabs they are cut from: all <= 1e-12 (float64)."""
    import jax.numpy as jnp
    from artemis_tpu import amr as JA

    jsmr, tsmr, st = trees
    rng = np.random.default_rng(3)
    for shape, active in (((1, 6, 4, 6, 5), (True, True, True)),
                          ((1, 6, 1, 6, 8), (True, True, False))):
        a = rng.random(shape) - 0.5
        assert rel(A.prolong_minmod(torch.as_tensor(a), active),
                   JA.prolong_minmod(jnp.asarray(a), active)) <= 1e-12
        f = rng.random(tuple(2 * n if n > 1 else 1 for n in shape[2:]))[None, None]
        assert rel(A.restrict_average(torch.as_tensor(f), active),
                   JA.restrict_average(jnp.asarray(f), active)) <= 1e-12
    jn, tn = jsmr.nodes[1], tsmr.nodes[1]
    assert tn.lo == jn.lo and tn.rim == jn.rim
    wc, wf = st["w"]
    wct, wcj = torch.as_tensor(wc), jnp.asarray(wc)
    for d in range(3):
        pair_t = tn._prolong_ghost_slab_pair(wct, d, tn.lo)
        pair_j = jn._prolong_ghost_slab_pair(wcj, d, jn.lo)
        for side in (0, 1):
            one_t = tn._prolong_ghost_slab(wct, d, side, tn.lo)
            assert rel(one_t, jn._prolong_ghost_slab(wcj, d, side, jn.lo)) <= 1e-12
            assert rel(pair_t[side], pair_j[side]) <= 1e-12
            assert torch.equal(one_t, pair_t[side])
    assert rel(tn.fill_fine_ghosts(torch.as_tensor(wf), wct, tn.lo),
               jn.fill_fine_ghosts(jnp.asarray(wf), wcj, jn.lo)) <= 1e-12
    strips, slabs = tn.ghost_strips(wct, tn.lo)
    _, jslabs = jn.ghost_strips(wcj, jn.lo)
    ng = tn.grid.nghost
    nx, ny, _ = tn.grid.nx
    for side in (0, 1):
        js = {d: np.asarray(jslabs[(d, side)])[0] for d in (1, 2, 3)}
        assert rel(strips[("x1", side)], js[1]) <= 1e-12
        assert rel(strips[("x2", side)], js[2][..., ng:ng + nx]) <= 1e-12
        assert rel(strips[("x3", side)], js[3][:, :, ng:ng + ny, ng:ng + nx]) <= 1e-12
        for d in (1, 2, 3):
            assert rel(slabs[(d, side)], jslabs[(d, side)]) <= 1e-12
    mask = tsmr._cover_mask(tsmr.root)
    assert rel(mask, jsmr._cover_mask(jsmr.root, [None, jn.lo])) == 0.0


def test_rim_delta_and_block_glue_match_jax(trees):
    """_apply_rim_delta_g6 (whole parent) and _glue_parent_block (rim
    deltas, dual-energy switch, band or full restriction, C2P/P2C on the
    child's block) on a random two-node state: <= 1e-12 (float64)."""
    import jax.numpy as jnp

    jsmr, tsmr, st = trees
    jn, tn = jsmr.nodes[1], tsmr.nodes[1]
    los = [None, np.asarray(jn.lo, np.int32)]
    wc, wf = st["w"]
    bdt = 1e-3
    _, slabs_t = tn.ghost_strips(torch.as_tensor(wc), tn.lo)
    _, slabs_j = jn.ghost_strips(jnp.asarray(wc), jn.lo)
    up = st["u"][0]
    out_t = tsmr._apply_rim_delta_g6(torch.as_tensor(up).clone(), tn, torch.as_tensor(wc),
                                     torch.as_tensor(wf), slabs_t,
                                     torch.tensor(bdt, dtype=DTYPE), False)
    out_j = jsmr._apply_rim_delta_g6(jnp.asarray(up), jn, los, jnp.asarray(wc),
                                     jnp.asarray(wf), slabs_j, bdt, False)
    assert rel(out_t, out_j) <= 1e-12
    assert rel(out_t, up) > 1e-6            # the delta moved the rim rows
    for final in (False, True):
        tstates = [{"gas": {"u": torch.as_tensor(u), "w": torch.as_tensor(w)}}
                   for u, w in zip(st["u"], st["w"])]
        tnew = [{"gas": {"u": torch.as_tensor(u).clone(), "w": torch.as_tensor(w).clone()}}
                for u, w in zip(st["u1"], st["w1"])]
        jstates = [{"gas": {"u": jnp.asarray(u), "w": jnp.asarray(w)}}
                   for u, w in zip(st["u"], st["w"])]
        jnew = [{"gas": {"u": jnp.asarray(u), "w": jnp.asarray(w)}}
                for u, w in zip(st["u1"], st["w1"])]
        tsmr._glue_parent_block(tsmr.root, tstates, tnew, [None, slabs_t],
                                torch.tensor(bdt, dtype=DTYPE), False, final)
        jsmr._glue_parent_block(jsmr.root, jstates, jnew, los, [None, slabs_j], bdt, False,
                                final)
        for k in ("u", "w"):
            assert rel(tnew[0]["gas"][k], jnew[0]["gas"][k]) <= 1e-12


# ---------------------------------------------------------------------------
# (b) the composable tree against the JAX jnp tree
# ---------------------------------------------------------------------------

def test_composable_tree_matches_jax(tmp_path):
    """The deck at a 32x32x8 root (its patch 32x32x8, gray FLD on both
    levels) for 3 cycles: the same cycle count and times, every node's u
    and w within 1e-11 of each array's max, Er within 1e-12, the .hst rows
    at 1e-12."""
    pytest.importorskip("jax")
    from artemis_tpu.simulation import Simulation as JSimulation

    ov = SMALL + HST
    jsim = JSimulation(DECK, ov, str(tmp_path / "jax"))
    jdrv = jsim.driver
    j0 = tree_to_numpy(jdrv._states)
    tsim = port_sim(tmp_path, ov)
    tdrv = tsim.driver
    assert len(tdrv.smr.nodes) == len(jdrv.smr.nodes) == 2
    assert [nd.lo for nd in tdrv.smr.nodes] == [nd.lo for nd in jdrv.smr.nodes]
    assert tdrv.smr._fused is None and tdrv.stage_kernel == "none"
    assert tree_rel(tdrv._states, j0) <= 1e-12
    tdrv._states = tree_from_numpy(j0, "cpu", DTYPE)
    tsim.state = state_from_numpy(j0[0], "cpu", DTYPE)
    jsim.run()
    tsim.run()
    assert tsim.tm.ncycle == jsim.tm.ncycle == 3
    assert abs(tsim.tm.time - jsim.tm.time) <= 1e-14 * jsim.tm.time
    assert tree_rel(tdrv._states, jdrv._states, keys=(("gas", "u"), ("gas", "w"))) <= 1e-11
    assert tree_rel(tdrv._states, jdrv._states, keys=(("rad", "Er"),)) <= 1e-12
    jh = np.loadtxt(os.path.join(jsim.data_dir, "disk_rhd_amr.out1.hst"), ndmin=2)
    th = np.loadtxt(tmp_path / "port" / "disk_rhd_amr.out1.hst", ndmin=2)
    assert jh.shape == th.shape and jh.shape[0] >= 3
    np.testing.assert_allclose(th[:, :4], jh[:, :4], rtol=1e-12, atol=0.0)
    # the conserved totals (the momenta cancel to 1e-17 on the symmetric
    # disk): within 1e-12 of the largest total
    assert np.abs(th[:, 4:] - jh[:, 4:]).max() <= 1e-12 * np.abs(jh[:, 4:]).max()


def run_tree(smr, states0, ncycles, dtype=DTYPE):
    """``ncycles`` steps of the tree from numpy node states at its own CFL
    dt; returns the node states."""
    states = tree_from_numpy(states0, "cpu", dtype)
    t = 0.0
    for _ in range(ncycles):
        dt = float(smr.estimate_dt(states))
        states = smr.step(states, dt, t)
        t += dt
    return states


# ---------------------------------------------------------------------------
# (d) fused tree vs composable tree; (e) six-face vs padded halos
# ---------------------------------------------------------------------------

def per_variable_rel(a, b):
    """max |a - b| over each variable's max |b| ([1, 6, z, y, x] arrays)."""
    a, b = np.asarray(a), np.asarray(b)
    axes = (0, 2, 3, 4)
    return float((np.abs(a - b).max(axis=axes) / np.abs(b).max(axis=axes)).max())


def test_fused_tree_matches_composable(tmp_path):
    """(b)'s tree for 3 cycles through the fused path (one node-batched
    stage per RK stage, rim deltas, band and full restriction, radiation)
    and the composable path: every node's conserved u within 2e-6 of each
    variable's max (tests/test_amr_fused.py holds the JAX tree to 2e-5; the
    port's trees part by 7.3e-7 at most, in the root's z momentum), and Er
    within 1e-12.  The fused path adds the coarse-fine flux delta after the
    kernel's dual-energy switch and C2P/P2C, the composable path before;
    where the switch fires (the disk's cold, fast atmosphere, density 1e-6)
    the two part by ~1e-6 of u's scale, and the primitives there by that
    over the density, so w is not held to this bound."""
    sim = port_sim(tmp_path, SMALL)
    smr = sim.driver.smr
    s0 = tree_to_numpy(sim.driver._states)
    comp = tree_to_numpy(run_tree(smr, s0, 3))
    smr._compile(True)
    assert smr._batched and smr.stage_kernel == "stage_curv_batched (2 nodes, gather6)"
    fused = tree_to_numpy(run_tree(smr, s0, 3))
    for f, c in zip(fused, comp):
        assert per_variable_rel(f["gas"]["u"], c["gas"]["u"]) <= 2e-6
        assert rel(f["rad"]["Er"], c["rad"]["Er"]) <= 1e-12


def test_sibling_pair_gather6_equals_padded(tmp_path):
    """Two adjacent patches (sibling links folded into the six-face strips,
    or written into the padded arrays; the overlapping rim blocks take the
    phase-ordered glue) for 2 cycles: the six-face and padded fused trees
    agree bitwise, and the pair conserves mass to 1e-14."""
    sim = port_sim(tmp_path, SMALL + PAIR + ["physics/radiation=false"])
    smr = sim.driver.smr
    assert len(smr.nodes) == 3 and all(smr._sib_links[i] for i in (1, 2))
    s0 = tree_to_numpy(sim.driver._states)
    smr._compile(True)
    assert smr._gather6 is not None and not smr._batched
    assert not smr._blocks_disjoint(smr.root)
    g6 = run_tree(smr, s0, 2)
    smr._compile(True, gather6=False)
    assert smr._gather6 is None and smr.stage_kernel == "stage_curv per node (padded)"
    padded = run_tree(smr, s0, 2)
    for a, b in zip(tree_to_numpy(g6), tree_to_numpy(padded)):
        for k in ("u", "w"):
            assert np.array_equal(a["gas"][k], b["gas"][k])


def test_three_level_tree_matches_jax_and_conserves():
    """tests/test_amr_multilevel.py's 2-D periodic box with two level-1
    patches and a level-2 patch nested in the larger one (composable path):
    after 3 cycles every node's u and w within 1e-12 of the JAX tree's
    (each array's max); then 18 more cycles conserve the root's mass and
    energy to 1e-13, as the JAX test holds its tree."""
    jnp = pytest.importorskip("jax.numpy")
    from artemis_tpu import amr as JA
    from artemis_tpu.config import ParameterInput as JPin
    from artemis_tpu.driver import Integrator as JInteg
    from artemis_tpu.grid import grid_from_input as jgrid
    from artemis_tpu.ops.hydro import FluidCfg as JCfg
    from tests.test_amr_multilevel import BOX, _bump_ic

    from artemis_tpu_torch.config import ParameterInput
    from artemis_tpu_torch.driver import Integrator
    from artemis_tpu_torch.grid import grid_from_input
    from artemis_tpu_torch.ops.hydro import FluidCfg

    patches = [dict(level=1, lo=(16, 16, 0), n=(24, 24, 1)),
               dict(level=1, lo=(46, 46, 0), n=(8, 8, 1)),
               dict(level=2, lo=(16, 16, 0), n=(16, 16, 1))]
    kw = dict(fluid="gas", recon="plm", rsolver="hllc", gamma=1.4, cfl=0.4)
    jml = JA.MultiLevelSMR(jgrid(JPin.from_string(BOX)), JInteg.make("rk2"), JCfg(**kw),
                           patches=patches)
    tml = A.MultiLevelSMR(grid_from_input(ParameterInput.from_string(BOX)),
                          Integrator.make("rk2"), FluidCfg(**kw), device="cpu", dtype=DTYPE,
                          patches=patches)
    assert len(tml.nodes) == 4 and tml.nodes[3].parent is tml.nodes[1]
    assert [nd.lo for nd in tml.nodes] == [nd.lo for nd in jml.nodes]
    jst = jml.initialize([{"gas": _bump_ic(nd.grid)} for nd in jml.nodes])
    tst = tml.initialize([_bump_ic(nd.grid) for nd in jml.nodes])
    los = [None] + [jnp.asarray(np.array(nd.lo, dtype=np.int32)) for nd in jml.nodes[1:]]
    dt = float(jml._dt(jst))
    assert abs(float(tml.estimate_dt(tst)) - dt) <= 1e-14 * dt
    for _ in range(3):
        jst = jml._step(jst, jnp.asarray(dt), jnp.asarray(0.0), los, None)
        tst = tml.step(tst, dt, 0.0)
    assert tree_rel(tst, jst, keys=(("gas", "u"), ("gas", "w"))) <= 1e-12
    vol = tml.root.hydro.vol

    def totals(states):
        u = states[0]["gas"]["u"][0]
        return float((vol * u[0]).sum()), float((vol * u[4]).sum())

    m0, e0 = totals(tst)
    for _ in range(18):
        tst = tml.step(tst, dt, 0.0)
    m1, e1 = totals(tst)
    assert abs(m1 / m0 - 1.0) < 1e-13 and abs(e1 / e0 - 1.0) < 1e-13
    assert bool((tst[0]["gas"]["w"][0, 0] > 0).all())


def test_cli_runs_a_static_tree(tmp_path, capsys):
    """The refined deck through the CLI on the CPU: the tree's banner and a
    finite run of 2 cycles."""
    from artemis_tpu_torch import cli

    rc = cli.main(["-i", DECK, "-d", str(tmp_path), "--device", "cpu",
                   "parthenon/mesh/nx1=32", "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=8",
                   "parthenon/time/nlim=2"])
    out = capsys.readouterr().out
    assert rc == 0 and "walltime-rate" in out and "ncycle=2" in out


def test_curvilinear_tree_raises(tmp_path):
    """A refinement tree on a curvilinear root (disk_sph, spherical) no
    longer raises: its patch is curvilinear with its volume weights and
    centroid spacings, the tree takes the composable path (the fused gate
    is shut), and two cycles stay finite with positive density on both
    levels (tests/test_torch_amr_curv.py holds such trees to JAX)."""
    ov = ["parthenon/mesh/refinement=static", "parthenon/mesh/nx1=16",
          "parthenon/mesh/nx2=8", "parthenon/mesh/nx3=8", "parthenon/mesh/x1min=0.4",
          "parthenon/mesh/x1max=2.4", "parthenon/time/nlim=2"]
    deck = os.path.join(os.path.dirname(DECK), "disk_sph.in")
    sim = Simulation(deck, ov, str(tmp_path), device="cpu")
    smr = sim.driver.smr
    patch = smr.nodes[1]
    assert patch.curv and patch.volf is not None and patch.ghost_spacings is not None
    assert smr._fused is None and sim.driver.stage_kernel == "none"
    sim.run()
    assert sim.tm.ncycle == 2
    for st in tree_to_numpy(sim.driver._states):
        assert np.isfinite(st["gas"]["w"]).all() and (st["gas"]["w"][:, 0] > 0).all()


def test_linear_wave_amr(tmp_path):
    """The twin of tests/test_decks.py's test_linear_wave_amr on the port:
    inputs/linear_wave_amr.in (a 64x32 root with a 32x16 patch over the
    wave) to t = 1, and again without refinement; the refined L1 error is
    within 1.5x the unrefined one (tests/test_decks.py:34-35)."""
    deck = os.path.join(os.path.dirname(DECK), "linear_wave_amr.in")
    errs = {}
    for tag, ov in (("amr", []), ("ref", ["parthenon/mesh/refinement=none"])):
        Simulation(deck, ov, str(tmp_path / tag), device="cpu").run()
        errs[tag] = np.loadtxt(str(tmp_path / tag / "linear_wave_amr-errs.dat"), ndmin=2)[0, 4]
    assert np.isfinite(errs["amr"]) and errs["amr"] <= 1.5 * errs["ref"]


# ---------------------------------------------------------------------------
# (c) the fused tree against the JAX tree's K6 path (interpret mode)
# ---------------------------------------------------------------------------

G6 = ["artemis/precision=float32", "physics/radiation=false", "parthenon/mesh/nx1=128",
      "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=8"]


def test_fused_tree_matches_jax_batched_kernel(tmp_path, monkeypatch):
    """tests/test_amr_gather6.py's tree (root 128x32x8, float32, no
    radiation; its patch has the root's shape) for one step at 0.3 x the
    CFL dt: the JAX tree takes its node-batched K6 kernel in interpret mode,
    the port's fused tree chooses its batched branch and runs the plain
    version with the same glue.  Every node's u and w within 4e-6 of each
    array's max, the bound test_amr_gather6.py holds the JAX paths to."""
    jnp = pytest.importorskip("jax.numpy")
    from artemis_tpu.simulation import Simulation as JSimulation

    monkeypatch.setenv("ARTEMIS_PALLAS_INTERPRET", "1")
    jsim = JSimulation(DECK, G6, str(tmp_path / "jax"))
    jdrv = jsim.driver
    jdrv._ensure_states(jsim.state)
    smr_j = jdrv.smr
    assert smr_j._gather6 is not None
    j0 = tree_to_numpy(jdrv._states)
    dt = jnp.asarray(0.3 * float(jdrv.estimate_dt(jsim.state)), dtype=jnp.float32)
    jout = tree_to_numpy(smr_j._step(jdrv._states, dt, jnp.asarray(0.0, jnp.float32),
                                     jdrv._los, None))

    tsim = port_sim(tmp_path, G6)
    smr = tsim.driver.smr
    smr._compile(True)
    assert smr._batched
    tout = tree_to_numpy(smr.step(tree_from_numpy(j0, "cpu", torch.float32), float(dt), 0.0))
    for t, j in zip(tout, jout):
        for k in ("u", "w"):
            assert t["gas"][k].dtype == np.float32
            assert rel(t["gas"][k], j["gas"][k]) < 4e-6, k
