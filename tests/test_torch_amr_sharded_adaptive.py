"""Sharded refinement trees in the port (``artemis_tpu_torch.parallel.amr``):
twins of tests/test_amr_sharded.py's adaptive cases.

* A patch moved host-side on a wrap tree built directly (``MultiLevelSMR``
  against ``ShardedSMR`` on a ``cpu`` x 4 mesh): the moved state bitwise the
  serial tree's, the next step within 1e-13.
* ``inputs/blast_amr.in`` with a periodic x3 through ``Simulation``, tiled:
  the pool's tile set equal to the serial tree's and the root within 1e-11
  of it.  The JAX test runs to tlim = 0.02 (about 500 cycles); this twin
  runs 20 cycles at check_interval 5 with 8-cell tiles in x1 and x2 (the
  deck's 16-cell tiles spawn only at set-up within 40 cycles; 8-cell tiles
  spawn four at set-up and two more at each of cycles 15 and 20, as
  replicated nodes, four regrids in all).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from artemis_tpu_torch import Simulation  # noqa: E402
from artemis_tpu_torch.amr import MultiLevelSMR  # noqa: E402
from artemis_tpu_torch.config import ParameterInput  # noqa: E402
from artemis_tpu_torch.driver import Integrator  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input  # noqa: E402
from artemis_tpu_torch.ops.hydro import FluidCfg  # noqa: E402
from artemis_tpu_torch.parallel.amr import ShardedSMR  # noqa: E402
from artemis_tpu_torch.parallel.mesh import make_device_mesh  # noqa: E402

INP = os.path.join(os.path.dirname(__file__), "..", "inputs")
BLAST = os.path.join(INP, "blast_amr.in")


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
nx2 = 16
x2min = -0.5
x2max = 0.5
ix2_bc = periodic
ox2_bc = periodic
nx3 = 8
x3min = -0.25
x3max = 0.25
ix3_bc = periodic
ox3_bc = periodic
<gas>
gamma = 1.4
<problem>
rho = 1.0
pres = 1.0
"""


def _bump(g):
    x1, x2, x3 = g.cell_centers()
    nz, ny, nx = tuple(reversed(g.nx))
    w = np.zeros((1, 6, nz, ny, nx))
    r2 = np.broadcast_to(x1**2 + x2**2 + x3**2, (nz, ny, nx))
    w[:, 0] = 1.0 + 0.5 * np.exp(-r2 / 0.05)
    w[:, 4] = 1.0
    w[:, 5] = w[:, 4] / (0.4 * w[:, 0])
    return w


def test_sharded_adaptive_move_matches_serial():
    """A patch moved host-side on a sharded tree (the gathered parent
    re-prolonged at the new spot, the wrap axis keeping its full span) is
    bitwise the serial tree's move, and the next sharded step matches the
    serial one to 1e-13."""
    grid = grid_from_input(ParameterInput.from_string(BOX))
    cfg = FluidCfg(fluid="gas", recon="plm", rsolver="hllc", gamma=1.4, cfl=0.4)
    patches = [dict(level=1, lo=(16, 6, 0), n=(8, 4, 8))]  # wraps x3
    kw = dict(dtype=torch.float64, patches=patches)
    ml = MultiLevelSMR(grid, Integrator.make("rk2"), cfg, device="cpu", **kw)
    sml = ShardedSMR(grid, Integrator.make("rk2"), cfg, devices=make_device_mesh(4, "cpu"),
                     axis=3, **kw)
    assert sml.nodes[1].wrap[2] and sml.nodes[1].grid.nx[2] == 4
    prims = [{"gas": _bump(g)} for g in ml.ic_grids]
    st0 = ml.initialize(prims)
    st1 = sml.initialize(prims)
    new_lo = [10, 4, 0]
    st0 = ml._move_patch(list(st0), ml.nodes[1], new_lo)
    ml._compile(ml.fused)
    st1 = sml._move_patch(st1, sml.nodes[1], new_lo)
    assert sml.nodes[1].lo == ml.nodes[1].lo == (10, 4, 0)
    a, b = st0[1]["gas"]["w"].numpy(), st1[1]["gas"]["w"].numpy()
    assert np.array_equal(a, b), np.abs(a - b).max()
    st0 = ml.step(st0, 0.01, 0.0)
    st1 = sml.step(st1, 0.01, 0.0)
    a, b = st0[0]["gas"]["w"].numpy(), st1[0]["gas"]["w"].numpy()
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() < 1e-13


BLAST_ARGS = ["parthenon/time/nlim=20", "parthenon/mesh/nx3=8", "parthenon/mesh/x3min=-0.5",
              "parthenon/mesh/x3max=0.5", "parthenon/mesh/ix3_bc=periodic",
              "parthenon/mesh/ox3_bc=periodic", "parthenon/refinement/patch_nx3=8",
              "parthenon/refinement/check_interval=5", "parthenon/refinement/tile_nx1=8",
              "parthenon/refinement/tile_nx2=8"]


def test_sharded_adaptive_deck(tmp_path):
    """Deck-driven tiled refinement on four shards: the tags of each regrid
    taken on the gathered root, spawned tiles replicated nodes, the pool's
    tile set equal to the serial run's and non-empty, the root within 1e-11
    (the JAX test's tolerance)."""
    s0 = Simulation(BLAST, BLAST_ARGS, str(tmp_path / "serial"), device="cpu")
    assert s0.driver.tiled
    s0.run()
    s1 = Simulation(BLAST, BLAST_ARGS, str(tmp_path / "shard"), device="cpu", nshards=4)
    assert s1.driver.tiled
    s1.run()
    pool0 = sorted(nd.lo for nd in s0.driver.smr.nodes if nd.pool)
    pool1 = sorted(nd.lo for nd in s1.driver.smr.nodes if nd.pool)
    assert len(pool0) == 8 and pool0 == pool1, (pool0, pool1)
    assert all(nd.replicated for nd in s1.driver.smr.nodes[1:])
    a = s0.state["gas"]["w"].numpy()
    b = s1.state["gas"]["w"].numpy()
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() < 1e-11
