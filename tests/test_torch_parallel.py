"""Single-level multi-device runs in the port (``artemis_tpu_torch.parallel.
mesh``): twins of tests/test_parallel.py.

Each configuration runs three times on the CPU: the JAX package at
``nshards=4`` (``shard_map`` over four of the eight virtual devices of
tests/conftest.py), the port at ``nshards=4`` (four per-shard Drivers on
``cpu``, slab exchange) and the port unsharded.  The port's sharded end
state is held against both, at tests/test_parallel.py's own tolerances:
1e-10 relative on the linear wave and its sources (the JAX file's
``rtol=1e-10, atol=1e-14``), 1e-8 relative / 1e-12 absolute on the disk
(each shard's face positions are made as x0 + dx*arange, last-ulp
differences from the global build that the disk's gradients amplify),
1e-9 of each field's maximum on rad_shock, 1e-11 on the N-body gas and
1e-12 on the particles.  The runs are cut to a few cycles (the JAX file's
linear wave runs 1000).  Both packages take their composable path on the
CPU, so the sharded and unsharded runs make the same operations up to the
order of the global sums.

Also: the 3-D FLD operator on x3 slabs against the port's unsharded run,
the shard windows' divisibility and ``max(2, nghost)`` errors, a
``cuda`` mesh asking for more cards than are present, a refined disk RHD
tree on four shards, the ``Sharded`` fields of the radiation step against the
unsharded tensor, and checkpoints across the decomposition (a sharded
run's checkpoint resumes unsharded, an unsharded one sharded, each equal to
the straight run).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402

from artemis_tpu_torch import Simulation  # noqa: E402
from artemis_tpu_torch.ops.fld import edge_masks, shift  # noqa: E402
from artemis_tpu_torch.parallel.mesh import (Sharded, _local_grid_at,  # noqa: E402
                                             make_device_mesh)

INP = os.path.join(os.path.dirname(__file__), "..", "inputs")
LINWAVE = os.path.join(INP, "linwave.in")
DISK = os.path.join(INP, "disk_sph.in")
SHOCK = os.path.join(INP, "rad_shock.in")


def linwave_args(nlim=5, extra=()):
    return ["parthenon/job/problem_id=linear_wave", f"parthenon/time/nlim={nlim}",
            "parthenon/mesh/nghost=4", "parthenon/mesh/nx1=16", "parthenon/mesh/nx2=8",
            "parthenon/mesh/nx3=16", "problem/amp=1.0e-6", "gas/reconstruct=plm",
            "gas/riemann=hllc", "problem/wave_flag=0", "problem/vflow=0.0", *extra]


DISK_ARGS = ["parthenon/time/nlim=5", "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=16",
             "parthenon/mesh/nx3=8"]


def three_runs(tmp_path, deck, args, is_path=True):
    """(JAX at nshards=4, the port at nshards=4, the port unsharded)."""
    j4 = JSimulation(deck, overrides=args, data_dir=str(tmp_path / "j4"), is_path=is_path,
                     nshards=4)
    j4.run()
    t4 = Simulation(deck, args, str(tmp_path / "t4"), is_path=is_path, device="cpu",
                    nshards=4)
    t4.run()
    t1 = Simulation(deck, args, str(tmp_path / "t1"), is_path=is_path, device="cpu")
    t1.run()
    assert j4.tm.ncycle == t4.tm.ncycle == t1.tm.ncycle
    return j4, t4, t1


def fields(sim, name="gas", key="w"):
    v = sim.state[name][key]
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def assert_close(sims, name, key, rtol, atol):
    ref = fields(sims[0], name, key)
    for sim in sims[1:]:
        np.testing.assert_allclose(fields(sim, name, key), ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("extra", [
    (),
    ("physics/gravity=true", "gravity/uniform/gx1=1e-8"),
    ("physics/drag=true", "drag/type=self", "gas/damping/inner_x3=0.4",
     "gas/damping/inner_x3_rate=1.0"),
], ids=["linwave", "uniform_gravity", "x3_damping"])
def test_linwave_sharded_x3(tmp_path, extra):
    """x3 slabs (the auto axis): the linear wave alone, with uniform
    gravity, and with z damping zones whose fields each shard builds on its
    own window."""
    j4, t4, t1 = three_runs(tmp_path, LINWAVE, linwave_args(extra=extra))
    assert t4.driver.axis_d == j4.driver.axis_d == 3
    assert [drv.grid.nx for drv in t4.driver.drivers] == [(16, 8, 4)] * 4
    w1 = fields(t1)
    if extra and extra[-1].startswith("gas/damping"):
        # the damping did something (the field is asymmetric in z)
        assert not np.allclose(w1[..., 0, :, :], w1[..., -1, :, :])
    for key in ("u", "w"):
        assert_close([t4, j4, t1], "gas", key, 1e-10, 1e-14)


@pytest.mark.parametrize("axis", ["x1", "x2"])
def test_linwave_sharded_other_axes(tmp_path, axis):
    j4, t4, t1 = three_runs(tmp_path, LINWAVE, linwave_args(
        extra=(f"parthenon/mesh/shard_axis={axis}", "parthenon/mesh/nx2=16")))
    assert t4.driver.axis_d == j4.driver.axis_d == int(axis[1])
    assert_close([t4, j4, t1], "gas", "w", 1e-10, 1e-14)


@pytest.mark.parametrize("axis", ["x3", "x1", "x2"])
def test_disk_sharded(tmp_path, axis):
    """The spherical viscous disk with its custom ic boundaries (each
    shard's fill from the problem on its own grid) on x3 (phi) slabs and on
    curvilinear x1/x2 slabs."""
    j4, t4, t1 = three_runs(tmp_path, DISK, DISK_ARGS + [f"parthenon/mesh/shard_axis={axis}"])
    assert t4.driver.axis_d == j4.driver.axis_d == int(axis[1])
    w4 = fields(t4)
    assert np.isfinite(w4).all()
    for ref in (j4, t1):
        w = fields(ref)
        assert np.max(np.abs(w4 - w) / np.maximum(np.abs(w), 1e-12)) < 1e-8
        np.testing.assert_allclose(w4, w, rtol=1e-8, atol=1e-12)


def test_rad_shock_sharded_x1(tmp_path):
    """Gray FLD under decomposition: the stencil shifts take the neighbour
    shard's planes, the CG sums are global, and only the end shards hold
    the ic Dirichlet edges."""
    j4, t4, t1 = three_runs(tmp_path, SHOCK, ["parthenon/time/nlim=10",
                                              "parthenon/mesh/shard_axis=x1"])
    assert t4.driver.radiation.use_kernels is False
    for name, keys in (("gas", ("u", "w")), ("rad", ("Er",))):
        for key in keys:
            a = fields(t4, name, key)
            for ref in (j4, t1):
                b = fields(ref, name, key)
                assert np.abs(a - b).max() / max(np.abs(b).max(), 1e-300) < 1e-9, (name, key)


def test_rhd_disk_sharded_3d_radiation(tmp_path):
    """The 3-D FLD operator on x3 slabs (``disk_rhd_amr.in`` without its
    patch at 32x32x8, every face ic): shifts and edge masks in three
    directions, one of them across the shards, against the port's
    unsharded run (1e-9 of each field's maximum; measured ~5e-16)."""
    deck = os.path.join(INP, "disk_rhd_amr.in")
    args = ["parthenon/mesh/refinement=none", "parthenon/mesh/nx1=32",
            "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=8", "parthenon/time/nlim=3"]
    t4 = Simulation(deck, args, str(tmp_path / "t4"), device="cpu", nshards=4)
    t4.run()
    t1 = Simulation(deck, args, str(tmp_path / "t1"), device="cpu")
    t1.run()
    assert t4.driver.axis_d == 3 and t4.tm.ncycle == t1.tm.ncycle == 3
    for name, keys in (("gas", ("u", "w")), ("rad", ("Er",))):
        for key in keys:
            a, b = fields(t4, name, key), fields(t1, name, key)
            assert np.abs(a - b).max() / np.abs(b).max() < 1e-9, (name, key)


NBODY_DECK = """
<artemis>
problem = constant
coordinates = cartesian
<parthenon/job>
problem_id = nbshard
<parthenon/time>
tlim = 0.5
nlim = 6
integrator = rk2
<parthenon/mesh>
nghost = 2
nx1 = 16
x1min = -1.0
x1max = 1.0
nx2 = 16
x2min = -1.0
x2max = 1.0
nx3 = 16
x3min = -1.0
x3max = 1.0
<physics>
gravity = true
nbody = true
<gas>
gamma = 1.4
<gravity/nbody>
<nbody>
integrator = ias15
<nbody/particle1>
mass = 1.0
live = 1
couple = 1
<nbody/particle1/soft>
type = plummer
radius = 0.2
<nbody/particle2>
mass = 0.5
live = 1
couple = 1
<nbody/particle2/initialize>
x = 0.5
vy = 1.0
<nbody/particle2/soft>
type = plummer
radius = 0.2
<problem>
rho = 1.0
pres = 1.0
"""


def test_nbody_sharded(tmp_path):
    """The 16^3 N-body deck of test_sharded_nbody (cut to 6 cycles): the
    shards' force rows summed before the one host read per stage."""
    j4, t4, t1 = three_runs(tmp_path, NBODY_DECK, [], is_path=False)
    w4 = fields(t4)
    for ref in (j4, t1):
        assert np.abs(w4 - fields(ref)).max() < 1e-11
        assert np.abs(t4.nbody.pos - ref.nbody.pos).max() < 1e-12
        assert np.abs(t4.nbody.vel - ref.nbody.vel).max() < 1e-12


def test_sharded_checkpoints_cross_the_decomposition(tmp_path):
    """A sharded run's checkpoint (global arrays) resumes unsharded, and an
    unsharded one sharded, each within the linear wave's tolerance of the
    straight unsharded run (measured: equal)."""
    args = linwave_args(nlim=6)
    straight = Simulation(LINWAVE, args, str(tmp_path / "straight"), device="cpu")
    straight.run()
    for first, then in ((4, 1), (1, 4)):
        a = Simulation(LINWAVE, linwave_args(nlim=3), str(tmp_path / f"a{first}"),
                       device="cpu", nshards=first)
        a.run()
        path = a.write_restart(str(tmp_path / f"ck{first}"))
        b = Simulation(LINWAVE, args, str(tmp_path / f"b{then}"), device="cpu", nshards=then,
                       restart=path)
        b.run()
        assert b.tm.ncycle == straight.tm.ncycle == 6
        assert b.tm.time == straight.tm.time
        for key in ("u", "w"):
            np.testing.assert_allclose(fields(b, "gas", key), fields(straight, "gas", key),
                                       rtol=1e-10, atol=1e-14)


def test_shard_window_errors(tmp_path):
    sim = Simulation(LINWAVE, linwave_args(), str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        _local_grid_at(sim.grid, 3, 0, 3)
    # nghost 4: a shard of 2 x3 cells cannot hold the neighbour's slab
    with pytest.raises(ValueError, match=r"need >= max\(2, nghost\)=4 x3 cells"):
        _local_grid_at(sim.grid, 8, 0, 3)
    with pytest.raises(ValueError, match=r"need >= max\(2, nghost\)=4"):
        Simulation(LINWAVE, linwave_args(extra=("parthenon/mesh/shard_axis=x3",)),
                   str(tmp_path), device="cpu", nshards=8)


def test_cuda_mesh_needs_its_cards():
    """A cuda mesh of more shards than cards raises unless the shards are
    placed explicitly; nothing falls back to fewer cards or the CPU."""
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match="shard_devices"):
        make_device_mesh(have + 1, "cuda")
    assert make_device_mesh(4, "cuda", ["cuda:0"] * 4) == [torch.device("cuda", 0)] * 4
    assert make_device_mesh(4, "cpu") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="2 shard devices for 4 shards"):
        make_device_mesh(4, "cpu", ["cpu", "cpu"])


def test_sharded_trees_raise_item_11b(tmp_path):
    """The small refined disk RHD deck with a periodic x3 runs on four
    shards (its patch replicated, its root and radiation on x3 slabs) as it
    does in the JAX package, within 1e-11 of the port's unsharded tree
    after 2 cycles; without a periodic axis the tree refuses to shard."""
    deck = os.path.join(INP, "disk_rhd_amr.in")
    args = ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=32", "parthenon/mesh/nx3=8"]
    periodic = args + ["parthenon/mesh/ix3_bc=periodic", "parthenon/mesh/ox3_bc=periodic",
                       "parthenon/time/nlim=2"]
    whole = Simulation(deck, periodic, str(tmp_path / "whole"), device="cpu")
    whole.run()
    sim = Simulation(deck, periodic, str(tmp_path / "shard"), device="cpu", nshards=4)
    assert sim.driver.smr.nodes[1].replicated and sim.driver.smr.root.grid.nx[2] == 2
    sim.run()
    assert sim.tm.ncycle == 2
    for key, kind in (("gas", "w"), ("rad", "Er")):
        a, b = whole.state[key][kind].numpy(), sim.state[key][kind].numpy()
        assert np.abs(a - b).max() <= 1e-11 * np.abs(a).max(), (key, kind)
    # the JAX package's axis rule for trees: a periodic axis must split
    with pytest.raises(ValueError, match="sharded refinement needs a periodic axis"):
        Simulation(deck, args, str(tmp_path), device="cpu", nshards=4)


def test_sharded_fields_match_the_whole_tensor():
    """``Sharded``: shifts across shard boundaries, physical edge masks,
    global sums and maxima, operators and assignment against the same
    operations on the unsharded tensor."""
    rng = np.random.default_rng(5)
    full = torch.tensor(rng.random((1, 3, 8, 3, 5)))   # [ns, C, z, y, x]
    for d, n in ((1, 5), (3, 4)):
        parts = list(torch.tensor_split(full, n, dim=full.ndim - d))
        sh = Sharded(parts, d)

        def whole(x):
            return torch.cat(x.parts, dim=full.ndim - d)

        for sign in (1, -1):
            assert torch.equal(whole(sh.shift(d, sign)), shift(full, d, sign))
        first, last = sh.edge_masks(d)
        f0, l0 = edge_masks(full, d)
        assert torch.equal(whole(first).expand_as(full), f0.expand_as(full))
        assert torch.equal(whole(last).expand_as(full), l0.expand_as(full))
        assert torch.sum(sh) == pytest.approx(float(torch.sum(full)), rel=1e-14)
        assert float(torch.max(sh * 2.0)) == float(torch.max(full * 2.0))
        y = torch.where(sh > 0.5, 1.0 / sh, torch.clamp_min(sh, 0.25)) ** 2
        assert torch.equal(whole(y), torch.where(full > 0.5, 1.0 / full,
                                                 torch.clamp_min(full, 0.25)) ** 2)
        z = sh.clone()
        z[:1, 2] += 1.0
        ref = full.clone()
        ref[:1, 2] += 1.0
        assert torch.equal(whole(z), ref)


def test_sharded_fields_refuse_shard_local_meanings():
    """``Sharded`` gives a call the whole field's meaning or raises: the
    reduction methods are the global reductions, a reduction along another
    axis runs shard by shard, ``shape`` is the whole field's, and a
    reduction in another form, one along the sharded axis, a roll or index
    along it, a change of layout, a non-tensor result and the field's truth
    value raise."""
    rng = np.random.default_rng(6)
    full = torch.tensor(rng.random((1, 3, 8, 3, 4)))   # [ns, C, z, y, x]
    d = 3
    sh = Sharded(list(torch.tensor_split(full, 4, dim=full.ndim - d)), d)
    assert sh.shape == full.shape
    assert float(sh.sum()) == pytest.approx(float(full.sum()), rel=1e-14)
    assert float(sh.amax()) == float(full.amax()) and float(sh.min()) == float(full.min())
    along_x = torch.sum(sh, dim=-1)     # the sharded axis moves one place to the end
    assert along_x.d == d - 1 and along_x.shape == full.sum(dim=-1).shape
    assert torch.allclose(torch.cat(along_x.parts, dim=full.ndim - d),
                          torch.sum(full, dim=-1), rtol=1e-14, atol=0.0)
    kept = torch.sum(sh, dim=-1, keepdim=True)
    assert kept.d == d and kept.shape == full.sum(dim=-1, keepdim=True).shape
    assert torch.equal(torch.cat(torch.roll(sh, 1, dims=-1).parts, dim=full.ndim - d),
                       torch.roll(full, 1, dims=-1))
    refused = [lambda: sh.sum(dim=full.ndim - d), lambda: torch.sum(sh, dtype=torch.float64),
               lambda: torch.mean(sh), lambda: sh.norm(), lambda: torch.dot(sh, sh),
               lambda: torch.roll(sh, 1, dims=-d), lambda: torch.cumsum(sh, dim=-d),
               lambda: sh.numel(), lambda: sh.item(), lambda: sh[..., 0, :, :],
               lambda: sh.size(), lambda: torch.stack([sh, sh], dim=-1),
               lambda: torch.sum(sh, -1, True), lambda: sh.reshape(-1),
               lambda: torch.permute(sh, (0, 1, 4, 3, 2)), lambda: sh.unsqueeze(-1)]
    for call in refused:
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(TypeError):
        bool(sh > 0.5)
    with pytest.raises(NotImplementedError):
        sh[..., 0, :, :] = 1.0
