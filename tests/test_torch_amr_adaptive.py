"""Adaptive refinement in the port (``artemis_tpu_torch.amr``: tiled
spawn/destroy pools, move-style retagging, pool restarts) against the JAX
package's, on the CPU, in float64, at tests/test_amr_adaptive.py's sizes:

* (a) the criteria: ``grid_stencil_widths`` at 1e-15 on Cartesian and
  cylindrical grids, and the tags of the gradient and the magnitude
  criterion, bool-equal, on seeded random fields with periodic and outflow
  axes;
* (b) ``regrid_tiles`` on the 32x32 blast box with tile (8, 8, 1): spawn,
  growth, derefinement with and without ``deref_thr``; the node rows
  (``state.tree_rows``) equal JAX's row for row and the spawned states
  match at 1e-12;
* (c) the four-tile seam pool and the numlevel-3 pool on the 32x32
  periodic box: rows equal, every node within 1e-12 of each array's max
  after 3 cycles of JAX's jnp step, the port's own 20 cycles conserving
  mass to 1e-12, and the nested derefinement sequence row for row;
* (d) ``TwoLevelSMR`` move-style on tests/test_amr.py's 2-D blast: the
  same patch positions after every retag, the states at 1e-12;
* (e) ``inputs/blast_amr.in`` through ``Simulation``, tiled, numlevel 2, at
  its own 64x64 with 8-cell tiles and check_interval 5 for 20 cycles: the
  pool rows after each regrid, the root state at 1e-12 of its max and the
  .hst rows; the forced-window case at set-up; the amr_user error; the
  deck at numlevel 3, move-style and through the CLI on the port;
* (f) the adaptive ``inputs/disk_rhd_amr.in`` (32x32x8 root over a shifted
  window, tiles 8x8x4, magnitude criterion, check_interval 1, 2 cycles):
  the composable tree against JAX's jnp tree (u and w 1e-11 of the max,
  Er 1e-12), the fused tree (the kernels' plain versions) against the
  composable tree as tests/test_torch_amr.py (d) holds them;
* (g) pool restarts: (e)'s JAX checkpoint resumes in the port with the
  same pool and numpy-equal node states, the port's checkpoint loads in
  the JAX package the same way, and the port resumed from a checkpoint at
  a multiple of check_interval ends bitwise equal to its straight run.

The JAX package compiles each tree once: the runs share module-scoped
fixtures.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from artemis_tpu import amr as JA  # noqa: E402
from artemis_tpu.config import ParameterInput as JPin  # noqa: E402
from artemis_tpu.driver import Integrator as JInteg  # noqa: E402
from artemis_tpu.grid import grid_from_input as jgrid  # noqa: E402
from artemis_tpu.ops import refinement as JR  # noqa: E402
from artemis_tpu.ops.hydro import FluidCfg as JCfg  # noqa: E402
from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

from artemis_tpu_torch import Simulation, cli  # noqa: E402
from artemis_tpu_torch import amr as A  # noqa: E402
from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.driver import Integrator  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops import refinement as R  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg  # noqa: E402
from artemis_tpu_torch.state import (state_from_numpy, tree_from_numpy, tree_rows,  # noqa: E402
                                     tree_to_numpy, tree_topology_from_rows)

DTYPE = torch.float64
HERE = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(HERE, "..", "inputs")
BLAST_AMR = os.path.join(INPUTS, "blast_amr.in")
RHD = os.path.join(INPUTS, "disk_rhd_amr.in")
CRIT = dict(field="density", type="gradient", refine_thr=0.5, deref_thr=0.1)
TILE = (8, 8, 1)
KW = dict(fluid="gas", recon="plm", rsolver="hlle", gamma=1.4, cfl=0.3)
# tests/test_amr_adaptive.py's 32^2 periodic box
BOX = """
<artemis>
problem = constant
coordinates = cartesian
<parthenon/time>
tlim = 1.0
<parthenon/mesh>
nghost = 2
nx1 = 32
x1min = -1.0
x1max = 1.0
ix1_bc = periodic
ox1_bc = periodic
nx2 = 32
x2min = -1.0
x2max = 1.0
ix2_bc = periodic
ox2_bc = periodic
nx3 = 1
x3min = -0.25
x3max = 0.25
<gas>
gamma = 1.4
<problem>
rho = 1.0
pres = 1.0
"""


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def tree_rel(port_states, ref_states, keys=(("gas", "u"), ("gas", "w"))):
    """The worst per-array max |port - ref| / max |ref| over the nodes."""
    p, r = tree_to_numpy(port_states), tree_to_numpy(ref_states)
    assert len(p) == len(r)
    return max(rel(pi[f][k], ri[f][k]) for pi, ri in zip(p, r) for f, k in keys if f in ri)


def rows_equal(port_nodes, jax_nodes):
    a, b = tree_rows(port_nodes), tree_rows(jax_nodes)
    return a.shape == b.shape and bool((a == b).all())


def trees(deck_text=None, deck_file=None, overrides=()):
    """The JAX and the port's MultiLevelSMR of one deck (no patches; JAX's
    tree moving as tests/test_amr_adaptive.py builds it)."""
    jp = JPin.from_string(deck_text) if deck_text else JPin.from_file(deck_file)
    tp = (ParameterInput.from_string(deck_text) if deck_text
          else ParameterInput.from_file(deck_file))
    jp.apply_overrides(list(overrides))
    tp.apply_overrides(list(overrides))
    jml = JA.MultiLevelSMR(jgrid(jp), JInteg.make("rk2"), JCfg(**KW), patches=[],
                           moving_patches=True)
    tml = A.MultiLevelSMR(grid_from_input(tp), Integrator.make("rk2"), FluidCfg(**KW),
                          device="cpu", dtype=DTYPE, patches=[], moving_patches=True)
    return jml, tml


def root_state(jml, w):
    """Both packages' one-node state list from root prims ``w`` (numpy)."""
    u, wj = jml.root.hydro.prim_to_cons(jnp.asarray(w), jml.cfg)
    js = [{"gas": {"u": u, "w": wj}}]
    return js, tree_from_numpy(tree_to_numpy(js), "cpu", DTYPE)


def bump_prims(centers, shape=(1, 32, 32), pres=None, size=4):
    """Ambient gas with dense squares at the (y, x) cells ``centers``."""
    w = np.ones((1, 6) + shape)
    w[:, 1:4] = 0.0
    w[:, 4] = 1.0
    for (cy, cx) in centers:
        w[:, 0, :, cy:cy + size, cx:cx + size] = 4.0
        if pres is not None:
            w[:, 4, :, cy:cy + size, cx:cx + size] = pres
    w[:, 5] = w[:, 4] / (0.4 * w[:, 0])
    return w


# ---------------------------------------------------------------------------
# (a) the criteria
# ---------------------------------------------------------------------------

CYL = """
<artemis>
problem = constant
coordinates = cylindrical
<parthenon/time>
tlim = 1.0
<parthenon/mesh>
nghost = 2
nx1 = 12
x1min = 0.5
x1max = 2.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 10
x2min = 0.0
x2max = 1.0
ix2_bc = periodic
ox2_bc = periodic
nx3 = 6
x3min = -0.5
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic
<gas>
gamma = 1.4
<problem>
rho = 1.0
pres = 1.0
"""


@pytest.mark.parametrize("deck", ["cyl", "blast", "box"])
def test_criteria_match_jax(deck):
    """grid_stencil_widths within 1e-15, and the gradient tags (with the
    grid's own boundaries and all-periodic) and the magnitude tags of a
    seeded random two-species field, bool-equal to JAX's."""
    if deck == "cyl":
        jp, tp = JPin.from_string(CYL), ParameterInput.from_string(CYL)
    elif deck == "box":
        jp, tp = JPin.from_string(BOX), ParameterInput.from_string(BOX)
    else:
        path = os.path.join(INPUTS, "blast.in")
        jp, tp = JPin.from_file(path), ParameterInput.from_file(path)
        for p in (jp, tp):
            p.apply_overrides(["parthenon/mesh/nx1=24", "parthenon/mesh/nx2=20"])
    jg, tg = jgrid(jp), grid_from_input(tp)
    jw, tw = JR.grid_stencil_widths(jg), R.grid_stencil_widths(tg)
    for a, b in zip(tw, jw):
        assert rel(a, b) <= 1e-15
    rng = np.random.default_rng(11)
    f = 1.0 + rng.random((2,) + tuple(reversed(tg.nx)))
    f[:, ::3] *= 3.0                    # steps for the gradient to find
    dims = [d for d in (1, 2, 3) if tg.nx[d - 1] > 1]
    ft = torch.as_tensor(f)
    for bc in (tg.bc, None):
        eps_thr = (0.3, 0.05)
        rt, dt_ = R.scalar_first_derivative(ft, tw, dims, *eps_thr, bc=bc)
        rj, dj = JR.scalar_first_derivative(jnp.asarray(f), jw, dims, *eps_thr,
                                            bc=None if bc is None else jg.bc)
        assert np.array_equal(rt.numpy(), np.asarray(rj))
        assert np.array_equal(dt_.numpy(), np.asarray(dj))
        assert 0 < int(rt.sum()) < rt.numel()
    mt, nt = R.scalar_magnitude(ft, 2.0, 1.2)
    mj, nj = JR.scalar_magnitude(jnp.asarray(f), 2.0, 1.2)
    assert np.array_equal(mt.numpy(), np.asarray(mj)) and np.array_equal(nt.numpy(),
                                                                           np.asarray(nj))


# ---------------------------------------------------------------------------
# (b) regrid_tiles on the blast box
# ---------------------------------------------------------------------------

def test_regrid_tiles_matches_jax():
    """Spawn over one dense square, growth when a second appears (the first
    tiles keep their state objects), derefinement of a smoothed field with
    deref_thr, and persistence without it: after every pass the port's node
    rows equal JAX's and its node states are within 1e-12."""
    jml, tml = trees(deck_file=os.path.join(INPUTS, "blast.in"),
                     overrides=["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=32"])
    for crit in (CRIT, dict(CRIT, deref_thr=0.0)):
        js, ts = root_state(jml, bump_prims([(12, 12)]))
        jlos = [None]
        counts = []
        for centres in (None, [(12, 12), (22, 22)], []):
            if centres is not None:
                js[0], ts[0] = (s[0] for s in root_state(jml, bump_prims(centres)))
            kept = {nd.lo: ts[nd.index] for nd in tml.nodes[1:]}
            js, jlos = jml.regrid_tiles(js, jlos, crit, TILE)
            ts = tml.regrid_tiles(ts, crit, TILE)
            assert rows_equal(tml.nodes, jml.nodes)
            assert tree_rel(ts, js) <= 1e-12
            for nd in tml.nodes[1:]:
                if nd.lo in kept:
                    assert ts[nd.index] is kept[nd.lo]
            counts.append(len(tml.nodes) - 1)
        # growth, then every tile dropped with deref_thr and none without
        assert 0 < counts[0] < counts[1]
        assert counts[2] == (0 if crit["deref_thr"] > 0 else counts[1])
        while len(tml.nodes) > 1:
            tml.remove_patch(tml.nodes[-1])
            jml.remove_patch(jml.nodes[-1])


# ---------------------------------------------------------------------------
# (c) the periodic pools against JAX's jnp step
# ---------------------------------------------------------------------------

def run_pair(jml, tml, js, ts, jlos, ncycles):
    """``ncycles`` of both trees at JAX's CFL dt of the first state."""
    dt = 0.8 * float(jml._dt(js))
    for _ in range(ncycles):
        js = jml._step(js, jnp.asarray(dt), jnp.asarray(0.0), jlos, None)
        ts = tml.step(ts, dt, 0.0)
    return js, ts, dt


def mass(tml, states):
    return float((tml.root.hydro.vol * states[0]["gas"]["u"][0, 0]).sum())


@pytest.mark.parametrize("numlevel", [2, 3])
def test_periodic_pools_match_jax_and_conserve(numlevel):
    """numlevel 2: the 2x2 seam pool (every tile linked to its three
    siblings); numlevel 3: two passes nest level-2 tiles in the level-1
    tiles.  Rows equal JAX's; after 3 cycles every node within 1e-12 of
    JAX's; 20 port cycles conserve mass to 1e-12.  At numlevel 3 a smooth
    field then drops the level-2 tiles first and the level-1 tiles at the
    next pass, row for row with JAX."""
    jml, tml = trees(deck_text=BOX)
    # a square over the corner where four tiles meet; at numlevel 3 one
    # inside a single level-1 tile, which nests one level-2 tile
    w = bump_prims([(14, 14)] if numlevel == 2 else [(12, 12)], pres=10.0,
                   size=6 if numlevel == 2 else 4)
    js, ts = root_state(jml, w)
    jlos = [None]
    for _ in range(numlevel - 1):
        js, jlos = jml.regrid_tiles(js, jlos, CRIT, TILE, numlevel=numlevel)
        ts = tml.regrid_tiles(ts, CRIT, TILE, numlevel=numlevel)
        assert rows_equal(tml.nodes, jml.nodes)
    if numlevel == 2:
        assert len(tml.nodes) == 5 and all(len(tml._sib_links[i]) == 3 for i in range(1, 5))
    else:
        assert [nd.level for nd in tml.nodes] == [0, 1, 2]
    assert tree_rel(ts, js) <= 1e-12
    js, ts, dt = run_pair(jml, tml, js, ts, jlos, 3)
    assert tree_rel(ts, js) <= 1e-12
    m0 = mass(tml, ts)
    for _ in range(17):
        ts = tml.step(ts, dt, 0.0)
    assert abs(mass(tml, ts) / m0 - 1.0) < 1e-12
    if numlevel == 3:
        smooth = []
        for nd in jml.nodes:
            ws = bump_prims([], shape=tuple(reversed(nd.grid.nx)))
            u, wj = nd.hydro.prim_to_cons(jnp.asarray(ws), jml.cfg)
            smooth.append({"gas": {"u": u, "w": wj}})
        js = smooth
        ts = tree_from_numpy(tree_to_numpy(smooth), "cpu", DTYPE)
        for left in ({0, 1}, {0}):
            js, jlos = jml.regrid_tiles(js, jlos, CRIT, TILE, numlevel=3)
            ts = tml.regrid_tiles(ts, CRIT, TILE, numlevel=3)
            assert rows_equal(tml.nodes, jml.nodes)
            assert {nd.level for nd in tml.nodes} == left


# ---------------------------------------------------------------------------
# (d) TwoLevelSMR move-style
# ---------------------------------------------------------------------------

def test_two_level_moves_match_jax():
    """tests/test_amr.py's off-centre blast (64x64, reflecting walls, the
    16x16 patch starting in the far corner) for 15 cycles with the pressure
    gradient criterion every 5: the patch moves toward the blast, to the
    same positions as JAX's, and both levels match at 1e-12."""
    from artemis_tpu.pgen import build_problem as jbuild

    ov = ["parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64", "gas/reconstruct=plm",
          "gas/riemann=hlle", "problem/x0=-0.25", "problem/y0=-0.25",
          "parthenon/mesh/ix1_bc=reflecting", "parthenon/mesh/ox1_bc=reflecting",
          "parthenon/mesh/ix2_bc=reflecting", "parthenon/mesh/ox2_bc=reflecting"]
    jp, tp = JPin.from_file(BLAST_AMR), ParameterInput.from_file(BLAST_AMR)
    jp.apply_overrides(ov)
    tp.apply_overrides(ov)
    kw = dict(fluid="gas", recon="plm", rsolver="hlle", gamma=jp.get_real("gas", "gamma"),
              cfl=jp.get_real("gas", "cfl"), dfloor=jp.get_real("gas", "dfloor"),
              siefloor=jp.get_real("gas", "siefloor"))
    lo0, n = (40, 40, 0), (16, 16, 1)
    jsmr = JA.TwoLevelSMR(jgrid(jp), JInteg.make("rk2"), JCfg(**kw), lo0, n)
    tsmr = A.TwoLevelSMR(grid_from_input(tp), Integrator.make("rk2"), FluidCfg(**kw), lo0, n,
                         device="cpu", dtype=DTYPE)
    wc = jbuild("blast", jp, jsmr.cg, jsmr.cfg).prims["gas"]
    wf = jbuild("blast", JPin.from_string(repr(jp)), jsmr.fg, jsmr.cfg).prims["gas"]
    jsc, jsf = jsmr.initialize(wc, wf)
    tsc, tsf = tsmr.initialize(np.asarray(wc), np.asarray(wf))
    crit = dict(field="pressure", type="gradient", refine_thr=0.3)
    jlo, tlo = jsmr.patch_lo, tsmr.patch_lo
    for _ in range(3):
        jsc, jsf, _, _ = jsmr.run(jsc, jsf, tlim=1.0, nlim=5, criterion=crit, retag_interval=5)
        tsc, tsf, _, _ = tsmr.run(tsc, tsf, tlim=1.0, nlim=5, criterion=crit, retag_interval=5)
        assert tsmr.patch_lo == jsmr.patch_lo
        for a, b in zip(tsc + tsf, jsc + jsf):
            assert rel(a, b) <= 1e-12
    assert tsmr.patch_lo != lo0 and tsmr.patch_lo[0] < 40 and tsmr.patch_lo[1] < 40
    assert jlo == tlo == lo0


# ---------------------------------------------------------------------------
# (e) blast_amr through Simulation; (g) pool restarts
# ---------------------------------------------------------------------------

TILED = ["parthenon/refinement/tile_nx1=8", "parthenon/refinement/tile_nx2=8",
         "parthenon/refinement/check_interval=5", "parthenon/time/nlim=20",
         "parthenon/output1/dt=1.0e-4",
         "parthenon/output9/file_type=rst", "parthenon/output9/dt=100.0"]
RST = "blast_amr.out9.final.rst.npz"


HALF = 10                         # the port's mid-run checkpoint (a regrid cycle)


@pytest.fixture(scope="module")
def blast_runs(tmp_path_factory):
    """blast_amr.in (tiled, numlevel 2) for 20 cycles in both packages, the
    node rows read after every cycle; each writes its final checkpoint, and
    the port one at cycle HALF too."""
    out = {}
    for pkg in ("jax", "port"):
        d = tmp_path_factory.mktemp(pkg)
        sim = (JSimulation(BLAST_AMR, TILED, str(d)) if pkg == "jax"
               else Simulation(BLAST_AMR, TILED, str(d), device="cpu"))
        rows = [tree_rows(sim.driver.smr.nodes)]
        init = tree_to_numpy(sim.driver._states)
        run = dict(sim=sim, dir=d, rows=rows, init=init)

        def observe(state, tm, s=sim, r=run, port=pkg == "port"):
            r["rows"].append(tree_rows(s.driver.smr.nodes))
            if port and tm.ncycle == HALF:
                r["half"] = s.write_restart(str(d / "half"), state=state, tm=tm)

        sim.run(extra_observers=[observe])
        out[pkg] = run
    return out


def test_blast_amr_matches_jax(blast_runs):
    """The pool rows after the pre-evolution pass and after every cycle
    (so after each regrid), equal; coverage grows at the last regrid; the
    initial tree at 1e-12, the root state after 20 cycles at 1e-12 of its
    max and the .hst rows at 1e-12."""
    j, t = blast_runs["jax"], blast_runs["port"]
    assert t["sim"].driver.tiled and t["sim"].driver.stage_kernel == "none"
    assert t["sim"].tm.ncycle == j["sim"].tm.ncycle == 20
    assert len(t["rows"]) == len(j["rows"]) == 21
    for a, b in zip(t["rows"], j["rows"]):
        assert a.shape == b.shape and (a == b).all()
    assert len(t["rows"][-1]) > len(t["rows"][0]) > 0
    assert tree_rel(tree_from_numpy(t["init"], "cpu", DTYPE), j["init"]) <= 1e-12
    assert abs(t["sim"].tm.time - j["sim"].tm.time) <= 1e-14 * j["sim"].tm.time
    for k in ("u", "w"):
        assert rel(t["sim"].state["gas"][k], j["sim"].state["gas"][k]) <= 1e-12
    assert tree_rel(t["sim"].driver._states, j["sim"].driver._states) <= 1e-12
    jh = np.loadtxt(j["dir"] / "blast_amr.out1.hst", ndmin=2)
    th = np.loadtxt(t["dir"] / "blast_amr.out1.hst", ndmin=2)
    assert jh.shape == th.shape and jh.shape[0] >= 20
    np.testing.assert_allclose(th[:, :4], jh[:, :4], rtol=1e-12, atol=0.0)
    assert np.abs(th[:, 4:] - jh[:, 4:]).max() <= 1e-12 * np.abs(jh[:, 4:]).max()


@pytest.mark.parametrize("src", ["jax", "port"])
def test_pool_restart_across_packages(blast_runs, tmp_path, src):
    """Each package's final checkpoint loads in the other: the same pool
    rows (topology rebuilt before the arrays) and numpy-equal node
    states."""
    r = blast_runs[src]
    path = str(r["dir"] / RST)
    sim = (Simulation(BLAST_AMR, TILED, str(tmp_path), device="cpu", restart=path)
           if src == "jax" else JSimulation(BLAST_AMR, TILED, str(tmp_path), restart=path))
    assert (tree_rows(sim.driver.smr.nodes) == r["rows"][-1]).all()
    for a, b in zip(tree_to_numpy(sim.driver._states), tree_to_numpy(r["sim"].driver._states)):
        for k in ("u", "w"):
            assert np.array_equal(a["gas"][k], b["gas"][k])


def test_pool_restart_resumes_bitwise(blast_runs, tmp_path):
    """The port checkpointed at cycle 10 (a multiple of check_interval)
    and resumed to cycle 20 ends bitwise equal to the straight 20 cycles
    (blast_runs' port run), every node and the pool rows included."""
    straight = blast_runs["port"]
    resumed = Simulation(BLAST_AMR, TILED, str(tmp_path), device="cpu",
                         restart=straight["half"])
    assert resumed.driver._ncycle == resumed.tm.ncycle == HALF
    assert (tree_rows(resumed.driver.smr.nodes) == straight["rows"][HALF]).all()
    resumed.run()
    assert resumed.tm.ncycle == 20
    assert (tree_rows(resumed.driver.smr.nodes) == straight["rows"][-1]).all()
    for a, b in zip(tree_to_numpy(resumed.driver._states),
                    tree_to_numpy(straight["sim"].driver._states)):
        for k in ("u", "w"):
            assert np.array_equal(a["gas"][k], b["gas"][k])


def test_blast_amr_fused_tree_matches_composable(blast_runs, tmp_path):
    """The card's path for blast_amr: the fused tree per node on padded
    halos (K4's plain version here) with the padded rim-delta glue, 2-D,
    outflow root, regrids re-running the set-up.  For 20 cycles with a
    regrid every 5 (coverage grows at the fourth): the node rows equal the
    composable tree's (blast_runs' port run) after every cycle, the stage
    path stays K4 per node, and every node's u and w are within 1e-12 of
    each array's max."""
    c = blast_runs["port"]
    f = Simulation(BLAST_AMR, TILED, str(tmp_path), device="cpu")
    f.driver.smr._compile(True)
    rec = []
    f.run(extra_observers=[lambda st, tm: rec.append(
        (tree_rows(f.driver.smr.nodes), f.driver.stage_kernel))])
    assert c["sim"].driver.stage_kernel == "none"
    assert all(k == "stage_curv per node (padded)" for _, k in rec)
    assert len(rec) == len(c["rows"]) - 1 == 20
    assert all(a.shape == b.shape and (a == b).all() for (a, _), b in zip(rec, c["rows"][1:]))
    assert len(rec[-1][0]) > len(c["rows"][0])
    assert tree_rel(f.driver._states, c["sim"].driver._states) <= 1e-12


FORCED = ["parthenon/refinement/tile_nx1=16", "parthenon/refinement/tile_nx2=16",
          "parthenon/static_refinement1/level=1",
          "parthenon/static_refinement1/x1min=0.05", "parthenon/static_refinement1/x1max=0.25",
          "parthenon/static_refinement1/x2min=0.05", "parthenon/static_refinement1/x2max=0.25"]


def test_forced_windows_and_amr_user(tmp_path, capsys):
    """A static_refinement block under tiled adaptivity is a forced tile
    window: the same windows, warnings and pool as JAX's at set-up, and
    the forced tiles persist over 10 port cycles.  amr_user on a problem
    without its own criterion raises JAX's ValueError."""
    ov = FORCED + ["parthenon/time/nlim=10", "parthenon/refinement/check_interval=5"]
    jsim = JSimulation(BLAST_AMR, ov, str(tmp_path / "jax"))
    jout = capsys.readouterr().out
    tsim = Simulation(BLAST_AMR, ov, str(tmp_path / "port"), device="cpu")
    tout = capsys.readouterr().out
    assert tsim.driver.forced_windows == jsim.driver.forced_windows
    assert [ln for ln in tout.splitlines() if "WARNING" in ln] == \
        [ln for ln in jout.splitlines() if "WARNING" in ln]
    assert rows_equal(tsim.driver.smr.nodes, jsim.driver.smr.nodes)
    forced = {tuple(r[2:5]) for r in tree_rows(tsim.driver.smr.nodes)}
    tsim.run()
    assert forced <= {tuple(r[2:5]) for r in tree_rows(tsim.driver.smr.nodes)}
    with pytest.raises(ValueError, match="user-defined AMR criterion"):
        Simulation(BLAST_AMR, ["artemis/amr_user=true"], str(tmp_path / "user"), device="cpu")


@pytest.mark.parametrize("extra", [["parthenon/mesh/numlevel=3"],
                                   ["parthenon/refinement/style=move"]],
                         ids=["tiled-numlevel3", "move"])
def test_blast_amr_variants_run_through_the_cli(tmp_path, capsys, monkeypatch, extra):
    """The deck as written through the CLI on the CPU at numlevel 3
    (level-2 tiles from the second pre-evolution pass) and move-style (the
    deck's 32x32 patch re-centred every check_interval): 12 finite cycles
    with the patches where they should be (the CLI's own Simulation read
    at set-up and after its run)."""
    from artemis_tpu_torch import simulation

    made = []

    def build(*a, **k):
        sim = Simulation(*a, **k)
        made.append((sim, tree_rows(sim.driver.smr.nodes)))
        return sim

    monkeypatch.setattr(simulation, "Simulation", build)
    args = ["parthenon/time/nlim=12", "parthenon/refinement/check_interval=5"] + extra
    rc = cli.main(["-i", BLAST_AMR, "-d", str(tmp_path), "--device", "cpu"] + args)
    out = capsys.readouterr().out
    assert rc == 0 and "walltime-rate" in out and "ncycle=12" in out
    (sim, rows), = made
    assert sim.tm.ncycle == 12
    if "move" in extra[0]:
        assert not sim.driver.tiled and rows[:, 8].sum() == 0
        assert tuple(tree_rows(sim.driver.smr.nodes)[0, 2:5]) != tuple(rows[0, 2:5])
    else:
        assert sim.driver.tiled and set(rows[:, 0]) == {1, 2}
    assert all(bool(torch.isfinite(st["gas"]["u"]).all()) for st in sim.driver._states)


# ---------------------------------------------------------------------------
# (f) the adaptive disk RHD tree
# ---------------------------------------------------------------------------

# the disk's centre at root cell 4 of 32 (the window [-0.5, 3.5]^2): the
# magnitude tags fall in an L of three tiles of the 3x3 lattice (two
# seams), and the deck's static_refinement1 block, shrunk, forces one
RHD_OV = ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=8",
          "parthenon/mesh/x1min=-0.5", "parthenon/mesh/x1max=3.5",
          "parthenon/mesh/x2min=-0.5", "parthenon/mesh/x2max=3.5",
          "parthenon/static_refinement1/x1min=0.0", "parthenon/static_refinement1/x1max=0.2",
          "parthenon/static_refinement1/x2min=0.0", "parthenon/static_refinement1/x2max=0.2",
          "parthenon/mesh/refinement=adaptive", "gas/refine_field=density",
          "gas/refine_type=magnitude", "gas/refine_thr=1.0",
          "parthenon/refinement/check_interval=1", "parthenon/refinement/tile_nx1=8",
          "parthenon/refinement/tile_nx2=8", "parthenon/refinement/tile_nx3=4",
          "parthenon/time/nlim=2"]


def test_adaptive_rhd_tree_matches_jax(tmp_path):
    """2 cycles with a regrid after each: the pool rows equal JAX's at
    set-up and after the run; the port's composable tree from JAX's initial
    tree is within 1e-11 of JAX's jnp tree in u and w and 1e-12 in Er; the
    port's fused tree (the kernels' plain versions, per node on the
    six-face halo) is within 2e-6 of each variable's max of its composable
    tree in u, and 1e-12 in Er."""
    jsim = JSimulation(RHD, RHD_OV, str(tmp_path / "jax"))
    tsim = Simulation(RHD, RHD_OV, str(tmp_path / "port"), device="cpu")
    jn, tn = jsim.driver.smr.nodes, tsim.driver.smr.nodes
    assert rows_equal(tn, jn) and len(tn) == 4
    j0 = tree_to_numpy(jsim.driver._states)
    tsim.driver._states = tree_from_numpy(j0, "cpu", DTYPE)
    tsim.state = state_from_numpy(j0[0], "cpu", DTYPE)
    jsim.run()
    tsim.run()
    assert rows_equal(tn, jn)
    assert tree_rel(tsim.driver._states, jsim.driver._states) <= 1e-11
    assert tree_rel(tsim.driver._states, jsim.driver._states, keys=(("rad", "Er"),)) <= 1e-12

    fsim = Simulation(RHD, RHD_OV, str(tmp_path / "fused"), device="cpu")
    smr = fsim.driver.smr
    smr._compile(True)
    assert smr.stage_kernel == "stage_curv per node (gather6)"
    fsim.driver._states = tree_from_numpy(j0, "cpu", DTYPE)
    fsim.state = state_from_numpy(j0[0], "cpu", DTYPE)
    fsim.run()
    assert rows_equal(smr.nodes, jn) and smr.stage_kernel == "stage_curv per node (gather6)"
    for f, c in zip(tree_to_numpy(fsim.driver._states), tree_to_numpy(tsim.driver._states)):
        a, b = f["gas"]["u"], c["gas"]["u"]
        axes = (0, 2, 3, 4)
        assert (np.abs(a - b).max(axis=axes) / np.abs(b).max(axis=axes)).max() <= 2e-6
        assert rel(f["rad"]["Er"], c["rad"]["Er"]) <= 1e-12


@pytest.mark.parametrize("layout", ["tree_rows", "pool payload", "legacy pool"])
def test_topology_from_rows(layout):
    """state.tree_topology_from_rows builds a JAX pool's topology into a
    fresh port tree from each row layout it reads (tree_rows' nine
    columns, the pool payload's eight, an older checkpoint's six): the
    same rows, pool flags and sibling links."""
    jml, tml = trees(deck_text=BOX)
    js, _ = root_state(jml, bump_prims([(14, 14)], pres=10.0, size=6))
    js, _ = jml.regrid_tiles(js, [None], CRIT, TILE)
    rows = tree_rows(jml.nodes)
    rows = {"tree_rows": rows, "pool payload": rows[:, :8], "legacy pool": rows[:, 2:8]}[layout]
    tree_topology_from_rows(tml, rows)
    assert rows_equal(tml.nodes, jml.nodes) and all(nd.pool for nd in tml.nodes[1:])
    assert tml._sib_links == {i: [(s, tuple(d), tuple(r)) for s, d, r in v]
                              for i, v in jml._sib_links.items()}
