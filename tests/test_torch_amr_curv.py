"""Curvilinear refinement trees in the port (``artemis_tpu_torch.amr``)
against the JAX package's, on the CPU, in float64:

* (a) the curvilinear weights and transfer operators on a cylindrical and
  a spherical 3-D tree: ``centroid_spacings``, ``_fine_centroid_row``, a
  patch's ghost spacings, volumes and interior spacings,
  ``prolong_minmod`` with spacings (the ghost slabs one side at a time and
  paired), ``restrict_average`` with the fine volumes and the
  area-weighted ``flux_correct`` on seeded random arrays, at 1e-14 of each
  array's max;
* (b) tests/test_amr.py's moving cylindrical blast (``TwoLevelSMR``, the
  16x16 patch starting in the far corner, the pressure gradient criterion
  every 5 cycles) for the 10 cycles of two retags, both of them moves: the
  same patch positions after every retag, both levels at 1e-12 of each
  array's max, the composite mass conserved to 1e-12 and the moved patch's
  inner edge on the parent face at its new ``lo``;
* (c) tests/test_amr_multilevel.py's refined disk_cyl (64x32x16, a level-1
  patch over x1 in [1, 2.5] and x3 in [-0.4, 0.4], viscosity, gravity and
  the rotating frame on both levels) for 3 cycles from JAX's initial tree,
  every node at 1e-12 of each array's max;
* (d) the fused gate: a curvilinear tree, a dust tree and an N-body tree
  keep the composable path when the set-up asks for the fused stage, as
  artemis_tpu/amr.py:1097-1105 does, while the same Cartesian gas trees
  without them take it.

Each JAX tree compiles once; the runs share module-scoped fixtures.
"""

import math
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
from artemis_tpu.ops.hydro import FluidCfg as JCfg  # noqa: E402
from artemis_tpu.pgen import build_problem as jbuild  # noqa: E402
from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

from artemis_tpu_torch import Simulation  # noqa: E402
from artemis_tpu_torch import amr as A  # noqa: E402
from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.driver import Integrator  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg  # noqa: E402
from artemis_tpu_torch.state import tree_from_numpy, tree_to_numpy  # noqa: E402

DTYPE = torch.float64
INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "inputs")
KW = dict(fluid="gas", recon="plm", rsolver="hlle", gamma=1.4, cfl=0.3)


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def box(coords, x1, x2, x3):
    """A 24x16x8 box of the constant problem in ``coords`` over the given
    (min, max) ranges, outflow everywhere."""
    lines = ["<artemis>", "problem = constant", f"coordinates = {coords}",
             "<parthenon/time>", "tlim = 1.0", "<parthenon/mesh>", "nghost = 2"]
    for d, (nx, (lo, hi)) in enumerate(zip((24, 16, 8), (x1, x2, x3)), start=1):
        lines += [f"nx{d} = {nx}", f"x{d}min = {lo!r}", f"x{d}max = {hi!r}",
                  f"ix{d}_bc = outflow", f"ox{d}_bc = outflow"]
    return "\n".join(lines + ["<gas>", "gamma = 1.4", "<problem>", "rho = 1.0",
                              "pres = 1.0"]) + "\n"


BOXES = {
    "cylindrical": box("cylindrical", (1.0, 3.0), (0.0, 1.2), (-0.5, 0.5)),
    "spherical": box("spherical", (1.0, 2.0), (0.6, 2.4), (0.0, 1.0)),
}
PATCH = dict(level=1, lo=(6, 4, 2), n=(8, 6, 4))


@pytest.fixture(scope="module", params=sorted(BOXES))
def curv_trees(request):
    """The JAX and the port's two-node tree on one curvilinear box."""
    text = BOXES[request.param]
    jml = JA.MultiLevelSMR(jgrid(JPin.from_string(text)), JInteg.make("rk2"), JCfg(**KW),
                           patches=[PATCH])
    tml = A.MultiLevelSMR(grid_from_input(ParameterInput.from_string(text)),
                          Integrator.make("rk2"), FluidCfg(**KW), device="cpu", dtype=DTYPE,
                          patches=[PATCH])
    return jml, tml


def test_curvilinear_weights_match_jax(curv_trees):
    """centroid_spacings and _fine_centroid_row on the patch's rows, the
    patch's ghost spacings, fine volumes and interior spacings: 1e-14."""
    jml, tml = curv_trees
    jn, tn = jml.nodes[1], tml.nodes[1]
    assert tn.curv and jn.curv and tn.grid.coords == jn.grid.coords != "cartesian"
    cg = tml.root.grid
    rng = np.random.default_rng(11)
    xc = np.sort(rng.random(9)) + 1.0
    xf = np.sort(rng.random(18)) + 1.0
    for a, b in zip(A.centroid_spacings(xc, xf), JA.centroid_spacings(xc, xf)):
        assert rel(a, b) <= 1e-14
    for d in (1, 2, 3):
        for nextra in (0, 1, 2):
            assert rel(A._fine_centroid_row(tn.grid, d, nextra),
                       JA._fine_centroid_row(jn.grid, d, nextra)) <= 1e-14
        xv = (cg.geom.xv1, cg.geom.xv2, cg.geom.xv3)[d - 1]
        for a, b in zip(tn.ghost_spacings[d - 1], jn.ghost_spacings[d - 1]):
            assert a.shape == np.shape(b) and rel(a, b) <= 1e-14
        for a, b in zip(tn.interior_spacings()[d - 1], jn.interior_spacings()[d - 1]):
            assert rel(a, b) <= 1e-14
        assert len(tn.ghost_spacings[d - 1][0]) == tn.n[d - 1] + 2 * tn.rim[d - 1] < len(xv)
    assert rel(tn.volf, jn.volf) <= 1e-14


def test_curvilinear_transfer_operators_match_jax(curv_trees):
    """prolong_minmod with the ghost spacings (each side's slab alone and
    the pair in one pass, and the fill they make), restrict_average with
    the fine volumes and the area-weighted flux_correct, on seeded random
    arrays: 1e-14 of each array's max."""
    jml, tml = curv_trees
    jn, tn = jml.nodes[1], tml.nodes[1]
    rng = np.random.default_rng(12)
    wc = 1.0 + rng.random((1, 6) + tuple(reversed(tml.root.grid.nx)))
    wf = 1.0 + rng.random((1, 6) + tuple(reversed(tn.grid.nx)))
    wct, wcj = torch.as_tensor(wc), jnp.asarray(wc)
    for d in range(3):
        pair = tn._prolong_ghost_slab_pair(wct, d, tn.lo)
        for side in (0, 1):
            ref = jn._prolong_ghost_slab(wcj, d, side, jn.lo)
            assert rel(tn._prolong_ghost_slab(wct, d, side, tn.lo), ref) <= 1e-14
            assert rel(pair[side], ref) <= 1e-14
    assert rel(tn.fill_fine_ghosts(torch.as_tensor(wf), wct, tn.lo),
               jn.fill_fine_ghosts(jnp.asarray(wf), wcj, jn.lo)) <= 1e-14
    sp = tn.interior_spacings()
    sub = wc[..., 2:6, 4:10, 6:14]
    assert rel(A.prolong_minmod(torch.as_tensor(sub), tn.active, sp),
               JA.prolong_minmod(jnp.asarray(sub), jn.active, spacings=jn.interior_spacings())
               ) <= 1e-14
    assert rel(A.restrict_average(torch.as_tensor(wf), tn.active, tn.volf),
               JA.restrict_average(jnp.asarray(wf), jn.active, volf=jn.volf)) <= 1e-14
    # flux_correct on random face fluxes of both levels
    fx_c, fx_f = {}, {}
    for d in (1, 2, 3):
        for fx, g in ((fx_c, tml.root.grid), (fx_f, tn.grid)):
            shp = [1, 6] + list(reversed(g.nx))
            shp[-d] += 1
            fx[d] = tuple(rng.standard_normal(shp) for _ in range(3))
    out_t = tn.flux_correct({d: tuple(torch.as_tensor(a) for a in v) for d, v in fx_c.items()},
                            {d: tuple(torch.as_tensor(a) for a in v) for d, v in fx_f.items()},
                            tn.lo)
    out_j = jn.flux_correct({d: tuple(jnp.asarray(a) for a in v) for d, v in fx_c.items()},
                            {d: tuple(jnp.asarray(a) for a in v) for d, v in fx_f.items()},
                            jn.lo)
    for d in (1, 2, 3):
        assert rel(out_t[d][0], out_j[d][0]) <= 1e-14
        assert not np.array_equal(np.asarray(out_t[d][0]), fx_c[d][0])


# ---------------------------------------------------------------------------
# (b) the moving cylindrical blast
# ---------------------------------------------------------------------------

BLAST = os.path.join(INPUTS, "blast.in")
CYL_BLAST = [
    "artemis/coordinates=cylindrical", "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64",
    "parthenon/mesh/x1min=1.0", "parthenon/mesh/x1max=5.0", "parthenon/mesh/x2min=0.0",
    f"parthenon/mesh/x2max={0.5 * math.pi:.16f}",
    "parthenon/mesh/ix1_bc=reflecting", "parthenon/mesh/ox1_bc=reflecting",
    "parthenon/mesh/ix2_bc=reflecting", "parthenon/mesh/ox2_bc=reflecting",
    "gas/reconstruct=plm", "gas/riemann=hlle", "gas/gamma=1.4",
    "problem/radius=0.15", "problem/height=1.0", "problem/symmetry=cylindrical",
    "problem/samples=0", "problem/x1=1.8", f"problem/x2={0.1 * math.pi:.16f}",
]


def test_moving_cylindrical_blast_matches_jax():
    """Two chunks of 5 cycles, a retag after each (both move the patch):
    positions equal after every retag, both levels at 1e-12, mass drift
    < 1e-12, the moved patch's grid rebuilt at its new window."""
    jp, tp = JPin.from_file(BLAST), ParameterInput.from_file(BLAST)
    jp.apply_overrides(CYL_BLAST)
    tp.apply_overrides(CYL_BLAST)
    kw = dict(fluid="gas", recon="plm", rsolver="hlle", gamma=jp.get_real("gas", "gamma"),
              cfl=jp.get_real("gas", "cfl"), dfloor=jp.get_real("gas", "dfloor"),
              siefloor=jp.get_real("gas", "siefloor"))
    lo0, n = (42, 42, 0), (16, 16, 1)
    jsmr = JA.TwoLevelSMR(jgrid(jp), JInteg.make("rk2"), JCfg(**kw), lo0, n)
    tsmr = A.TwoLevelSMR(grid_from_input(tp), Integrator.make("rk2"), FluidCfg(**kw), lo0, n,
                         device="cpu", dtype=DTYPE)
    assert tsmr.curv and jsmr.curv
    wc = jbuild("blast", jp, jsmr.cg, jsmr.cfg).prims["gas"]
    wf = jbuild("blast", JPin.from_string(repr(jp)), jsmr.fg, jsmr.cfg).prims["gas"]
    jsc, jsf = jsmr.initialize(wc, wf)
    tsc, tsf = tsmr.initialize(np.asarray(wc), np.asarray(wf))
    cg = tsmr.cg
    volc = np.broadcast_to(cg.geom.volume(), cg.shape_entire)[cg.int_slices]

    def mass(sc):
        return float((np.asarray(sc[0][:, 0]) * volc).sum())

    m0 = mass(tsc)
    crit = dict(field="pressure", type="gradient", refine_thr=0.3)
    seen = [lo0]
    for _ in range(2):
        jsc, jsf, _, _ = jsmr.run(jsc, jsf, tlim=1.0, nlim=5, criterion=crit, retag_interval=5)
        tsc, tsf, _, _ = tsmr.run(tsc, tsf, tlim=1.0, nlim=5, criterion=crit, retag_interval=5)
        assert tsmr.patch_lo == jsmr.patch_lo != seen[-1]
        seen.append(tsmr.patch_lo)
        for a, b in zip(tsc + tsf, jsc + jsf):
            assert rel(a, b) <= 1e-12
    assert tsmr.patch_lo[0] < 42 and tsmr.patch_lo[1] < 42
    node = tsmr.ml.nodes[1]
    assert node.grid.xmin[0] == pytest.approx(float(cg.geom.xf1[cg.ng[0] + tsmr.patch_lo[0]]),
                                              rel=0, abs=1e-14)
    assert node.grid.xmin[1] == pytest.approx(float(cg.geom.xf2[cg.ng[1] + tsmr.patch_lo[1]]),
                                              rel=0, abs=1e-14)
    assert abs(mass(tsc) - m0) / m0 < 1e-12
    rho = np.asarray(tsc[1][:, 0])
    assert np.isfinite(rho).all() and rho.min() > 0


# ---------------------------------------------------------------------------
# (c) the refined disk_cyl
# ---------------------------------------------------------------------------

DISK_CYL = os.path.join(INPUTS, "disk_cyl.in")
REFINED_DISK = [
    "parthenon/time/nlim=3", "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=32",
    "parthenon/mesh/nx3=16", "parthenon/mesh/refinement=static",
    "parthenon/static_refinement1/level=1", "parthenon/static_refinement1/x1min=1.0",
    "parthenon/static_refinement1/x1max=2.5", "parthenon/static_refinement1/x3min=-0.4",
    "parthenon/static_refinement1/x3max=0.4",
]


@pytest.fixture(scope="module")
def disk_runs(tmp_path_factory):
    """The refined disk_cyl for 3 cycles in both packages, the port from
    JAX's initial tree."""
    tmp = tmp_path_factory.mktemp("disk")
    jsim = JSimulation(DISK_CYL, REFINED_DISK, str(tmp / "jax"))
    tsim = Simulation(DISK_CYL, REFINED_DISK, str(tmp / "port"), device="cpu")
    tsim.driver._states = tree_from_numpy(tree_to_numpy(jsim.driver._states), "cpu", DTYPE)
    tsim.state = {k: dict(v) for k, v in tsim.driver._states[0].items()}
    jsim.run()
    tsim.run()
    return jsim, tsim


def test_refined_disk_cyl_matches_jax(disk_runs):
    jsim, tsim = disk_runs
    jn, tn = jsim.driver.smr.nodes, tsim.driver.smr.nodes
    assert [(n.lo, n.n) for n in tn[1:]] == [(n.lo, n.n) for n in jn[1:]]
    assert tn[1].curv and tn[1].diffusion is not None and len(tn[1].sources) >= 2
    assert tsim.tm.ncycle == jsim.tm.ncycle == 3
    for a, b in zip(tree_to_numpy(tsim.driver._states), tree_to_numpy(jsim.driver._states)):
        for k in ("u", "w"):
            assert rel(a["gas"][k], b["gas"][k]) <= 1e-12


# ---------------------------------------------------------------------------
# (d) the fused gate
# ---------------------------------------------------------------------------

LINWAVE = os.path.join(INPUTS, "linwave.in")
ADVECTION = os.path.join(INPUTS, "advection.in")
SMALL_BOX = ["parthenon/mesh/nx1=16", "parthenon/mesh/nx2=8", "parthenon/mesh/nx3=8",
             "parthenon/mesh/refinement=static"]
GATED = {
    # (deck, overrides with the feature, overrides of the same tree without)
    "curvilinear": (DISK_CYL, REFINED_DISK, None),
    "dust": (ADVECTION, SMALL_BOX, ["physics/dust=false"]),
    "nbody": (LINWAVE, SMALL_BOX + ["physics/nbody=true", "nbody/particle1/mass=1.0"],
              ["physics/nbody=false"]),
}


@pytest.mark.parametrize("kind", sorted(GATED))
def test_fused_gate_shuts_on_curvilinear_dust_and_nbody_trees(tmp_path, kind):
    """Asked for the fused stage, the tree's set-up gives None (the
    composable path) and stage_kernel reports no kernel on the CPU; the
    Cartesian gas trees without dust or N-body take the fused stage."""
    deck, ov, without = GATED[kind]
    smr = Simulation(deck, ov, str(tmp_path / "with"), device="cpu").driver.smr
    smr._compile(True)
    assert smr._fused is None and smr._gather6 is None and smr.stage_kernel == "none"
    if kind == "curvilinear":
        assert all(node.curv for node in smr.nodes)
        return
    assert (smr.dust_cfg is not None) == (kind == "dust")
    assert (smr.nbody is not None) == (kind == "nbody")
    plain = Simulation(deck, ov + without, str(tmp_path / "without"), device="cpu").driver.smr
    plain._compile(True)
    assert plain._fused is not None and len(plain._fused) == len(plain.nodes) == 2
    assert plain.stage_kernel.startswith("stage_curv")
