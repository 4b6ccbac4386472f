"""The batched radiation pass of the port's refinement tree
(``MultiLevelSMR._radiation_pass`` with ``Radiation.step_batched``), on the
CPU in float64, against the port's own sequential pass (the private
``_sequential`` keyword) and the JAX package's default pass, which solves
each level's same-shape patches as one ``vmap`` of ``Radiation.step``
(``artemis_tpu/amr.py:1939-1984``; run here under ``jax.jit``):

* the twin of tests/test_amr_radiation.py's
  ``test_batched_fine_solves_match_sequential``: its two-patch 64x32 deck and
  its distinct Er ramps per node; the batched pass makes the root's solve
  and one group call, and every node's fields are within 1e-12 of each
  field's max of the sequential pass and of the JAX package's batched pass,
  with the same CG iteration counts per node as the sequential pass;
* a 3-D tree (the deck made 3-D: a 32x16x8 root, periodic in x3, two
  same-shape 16x8x8 patches, Er ramps along z too) at dt = 1e-3, where the
  patches take different CG counts, so that a finished node's iterate is
  held while the other iterates, and the stacked plain operator runs its
  z stencil in each node's own box: the same checks;
* the plain FLD operator over a node axis (``fld_coeffs_reference`` /
  ``fld_matvec_reference`` on ``[N, nz, ny, nx]``) equal to the per-node
  calls stacked, with distinct fields per node, where a stack read as one
  box (its z neighbours crossing into the next node) differs;
* a sharded tree (``ShardedSMR``, two shards along x3) with the 3-D tree's
  two patches solves node by node (the JAX package batches only unsharded
  trees), and its pass equals the unsharded tree's;
* ``profiling.kernel_table`` on the 3-D tree: the group's FLD operator in
  rows of its own (``plain, node axis``), one set-up a cycle beside the
  root's;
* ``step_batched`` refuses members of differing configurations.

The module level imports no JAX; the JAX comparisons import it inside
their tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from artemis_tpu_torch import Simulation, profiling  # noqa: E402
from artemis_tpu_torch.ops import fld as FLD  # noqa: E402
from artemis_tpu_torch.profiling import kernel_table  # noqa: E402
from artemis_tpu_torch.radiation import Radiation  # noqa: E402
from artemis_tpu_torch.state import tree_from_numpy, tree_to_numpy  # noqa: E402

DTYPE = torch.float64
TOL = 1e-12
# tests/test_amr_radiation.py's two-patch deck in 3-D: the root 32x16x8,
# periodic in x3 (a sharded tree's axis), each patch 8x4x4 root cells
DECK3 = """
<artemis>
problem = constant
coordinates = cartesian

<parthenon/time>
tlim = 1.0e-8
nlim = 4
integrator = rk2

<parthenon/mesh>
nghost = 2
refinement = static
nx1 = 32
x1min = 0.0
x1max = 1.0
ix1_bc = reflecting
ox1_bc = reflecting
nx2 = 16
x2min = 0.0
x2max = 0.5
ix2_bc = reflecting
ox2_bc = reflecting
nx3 = 8
x3min = -0.125
x3max = 0.125
ix3_bc = periodic
ox3_bc = periodic

<parthenon/static_refinement1>
level = 1
x1min = 0.125
x1max = 0.375
x2min = 0.125
x2max = 0.25
x3min = -0.0625
x3max = 0.0625

<parthenon/static_refinement2>
level = 1
x1min = 0.5
x1max = 0.75
x2min = 0.25
x2max = 0.375
x3min = -0.0625
x3max = 0.0625

<physics>
gas = true
radiation = true

<gas>
gamma = 1.6666666666666667
cfl = 0.4
reconstruct = plm
riemann = hllc

<gas/opacity/absorption>
opacity_model = constant
kappa_a = 1.0

<jaybenne>
dt = 1.0e-10

<problem>
rho = 1.0
pres = 0.6666666666666666
"""


def ramped(states):
    """Distinct smooth Er ramps per node, tests/test_amr_radiation.py's
    along x and y, times one along z in 3-D (numpy node states)."""
    out = []
    for i, st in enumerate(tree_to_numpy(states)):
        Er = st["rad"]["Er"]
        nz, ny, nx = Er.shape[-3:]
        zz, yy, xx = np.meshgrid(np.linspace(0, 1, nz), np.linspace(0, 1, ny),
                                 np.linspace(0, 1, nx), indexing="ij")
        ramp = 1.0 + 0.4 * np.sin(2.5 * (xx + 0.3 * i)) * np.cos(1.7 * yy)
        if nz > 1:
            ramp = ramp * (1.0 + 0.2 * np.sin(3.1 * zz + i))
        st["rad"]["Er"] = Er * ramp
        out.append(st)
    return out


def worst(a_states, b_states):
    """The worst per-field max |a - b| / max |b| over the nodes (numpy)."""
    assert len(a_states) == len(b_states)
    out = 0.0
    for a, b in zip(a_states, b_states):
        assert set(a) == set(b)
        for f in b:
            for k in b[f]:
                x, y = np.asarray(a[f][k], np.float64), np.asarray(b[f][k], np.float64)
                out = max(out, float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300)))
    return out


def count(monkeypatch):
    """Calls of Radiation.step and Radiation.step_batched, by name."""
    calls = []
    for name in ("step", "step_batched"):
        orig = getattr(Radiation, name)

        def wrapped(self, *a, _o=orig, _n=name, **kw):
            calls.append(_n)
            return _o(self, *a, **kw)

        monkeypatch.setattr(Radiation, name, wrapped)
    return calls


def jax_tree(deck, tmp_path):
    """The JAX package's tree of the deck text and its ramped numpy states."""
    from artemis_tpu.simulation import Simulation as JSimulation

    jsim = JSimulation(deck, is_path=False, data_dir=str(tmp_path / "jax"))
    jsim.driver._ensure_states(jsim.state)
    return jsim, ramped(jsim.driver._states)


def port_tree(deck, tmp_path, tag="port", **kw):
    """The port's tree of the deck text (the deck written beside it)."""
    path = tmp_path / "deck.in"
    path.write_text(deck)
    return Simulation(str(path), [], str(tmp_path / tag), device="cpu", **kw).driver.smr


def jax_batched_pass(jsim, st0, dt, monkeypatch):
    """The JAX package's default (batched) pass from the numpy states st0,
    under ``jax.jit`` (its eager dispatch compiles op by op)."""
    import jax
    import jax.numpy as jnp

    monkeypatch.setenv("ARTEMIS_BATCH_RAD", "1")
    jdrv = jsim.driver
    states = [{f: {k: jnp.asarray(v) for k, v in kinds.items()} for f, kinds in st.items()}
              for st in st0]
    run = jax.jit(lambda s, t: jdrv.smr._radiation_pass(s, t, jdrv._los))
    return tree_to_numpy(run(states, jnp.asarray(dt)))


def check_passes(smr, jsim, st0, dt, monkeypatch):
    """The port's batched pass against its sequential pass (the calls each
    makes, the CG counts per node, every field) and against the JAX
    package's; returns the CG counts per node."""
    calls = count(monkeypatch)
    out = {}
    for seq in (True, False):
        calls.clear()
        outers0 = profiling.newton_outers
        s = smr._radiation_pass(tree_from_numpy(st0, "cpu", DTYPE),
                                torch.full((), dt, dtype=DTYPE), _sequential=seq)
        out[seq] = (tree_to_numpy(s), [list(n.radiation.cg_iters) for n in smr.nodes],
                    list(calls), profiling.newton_outers - outers0)
    (seq, seq_its, seq_calls, seq_outers), (bat, bat_its, bat_calls, bat_outers) = \
        out[True], out[False]
    assert seq_calls == ["step"] * len(smr.nodes)
    assert bat_calls == ["step", "step_batched"]
    assert bat_its == seq_its
    # the root's solve, then the pair's on the node axis, which counts each
    # outer once while either node runs
    assert seq_outers == sum(len(its) for its in seq_its)
    assert bat_outers == len(bat_its[0]) + max(len(its) for its in bat_its[1:])
    assert worst(bat, seq) <= TOL
    assert worst(bat, jax_batched_pass(jsim, st0, dt, monkeypatch)) <= TOL
    return bat_its


def test_batched_pass_twin_two_patches(tmp_path, monkeypatch):
    """The twin of tests/test_amr_radiation.py:181 on its own deck."""
    from tests.test_amr_radiation import TWO_PATCH_DECK

    jsim, st0 = jax_tree(TWO_PATCH_DECK, tmp_path)
    smr = port_tree(TWO_PATCH_DECK, tmp_path)
    assert [n.grid.nx for n in smr.nodes] == [(64, 32, 1), (32, 16, 1), (32, 16, 1)]
    its = check_passes(smr, jsim, st0, 2.0e-9, monkeypatch)
    assert all(sum(i) > 0 for i in its)


def test_batched_pass_3d(tmp_path, monkeypatch):
    """Two same-shape 3-D patches: their CG counts differ, and both passes
    and the JAX package's agree at 1e-12."""
    jsim, st0 = jax_tree(DECK3, tmp_path)
    smr = port_tree(DECK3, tmp_path)
    assert [n.grid.nx for n in smr.nodes] == [(32, 16, 8), (16, 8, 8), (16, 8, 8)]
    its = check_passes(smr, jsim, st0, 1.0e-3, monkeypatch)
    # the patches stop at different CG iterations: one is held while the
    # other goes on
    assert its[1] != its[2] and min(its[1][0], its[2][0]) > 1


def test_plain_node_axis_matches_per_node_calls():
    """fld_coeffs_reference / fld_matvec_reference over a node axis equal
    the per-node calls stacked (three nodes of distinct fields, Dirichlet
    flags mixed); the same stack read as one [3 nz, ny, nx] box differs,
    which a stencil wrapped across nodes would give."""
    rng = np.random.default_rng(7)
    shape = (3, 5, 6, 7)
    t = lambda a: torch.as_tensor(a, dtype=DTYPE)  # noqa: E731
    E, chi = t(0.5 + rng.random(shape)), t(3.0 * (1.0 + rng.random(shape)))
    sf, dt = t(rng.random(shape)), t(np.array([1e-3]))
    args = ((0.05, 0.07, 0.03), 10.0, 2.0, ((True, False), (False, True), (True, True)))
    A, diag, Dc = FLD.fld_coeffs_reference(E, chi, dt, *args)
    assert A.shape == (3, 6, 5, 6, 7)
    out = FLD.fld_matvec_reference(E, A, diag, sf)
    per = [FLD.fld_coeffs_reference(E[n], chi[n], dt, *args) for n in range(3)]
    for got, want in zip((A, diag, Dc), zip(*per)):
        assert torch.equal(got, torch.stack(want))
    assert torch.equal(out, torch.stack([FLD.fld_matvec_reference(E[n], *per[n][:2], sf[n])
                                         for n in range(3)]))
    # the stack as one box: the nodes' edge planes in z see each other
    box = FLD.fld_coeffs_reference(E.reshape(15, 6, 7), chi.reshape(15, 6, 7), dt, *args)
    assert not torch.equal(box[2].reshape(shape), Dc)


def test_sharded_tree_solves_per_node(tmp_path, monkeypatch):
    """A ShardedSMR tree (two shards along x3) with two same-shape patches
    never batches: each shard's tree solves node by node, and the pass
    equals the unsharded tree's (which batches the pair) within 1e-12."""
    smr = port_tree(DECK3, tmp_path)
    ssmr = port_tree(DECK3, tmp_path, "shard", nshards=2)
    assert ssmr.nshards == 2 and len(ssmr.nodes) == 3
    st0 = ramped(Simulation(str(tmp_path / "deck.in"), [], str(tmp_path / "ic"),
                            device="cpu").driver._states)
    dt = torch.full((), 1.0e-3, dtype=DTYPE)
    calls = count(monkeypatch)
    one = tree_to_numpy(smr._radiation_pass(tree_from_numpy(st0, "cpu", DTYPE), dt))
    assert calls == ["step", "step_batched"]
    calls.clear()
    sharded = ssmr._radiation_pass(tree_from_numpy(st0, "cpu", DTYPE), dt)
    assert calls and "step_batched" not in calls
    assert worst(tree_to_numpy([sharded[i] for i in range(3)]), one) <= TOL


def test_kernel_table_node_axis_rows(tmp_path):
    """On the CPU the batched solve's operator is the plain version on the
    node axis, in rows of its own: one set-up a cycle for the pair beside
    the root's, and per Newton outer one matvec plus one per CG iteration
    (the pair's: its slower node's)."""
    port_tree(DECK3, tmp_path)
    sim = Simulation(str(tmp_path / "deck.in"), [], str(tmp_path / "table"), device="cpu")
    rows = {}
    secs = kernel_table(sim, ncycles=1, out=open(tmp_path / "table.txt", "w"), calls=rows)
    root, *pair = [nd.radiation.cg_iters for nd in sim.driver.smr.nodes]
    assert len(pair) == 2
    assert rows["fld_coeffs (plain, node axis)"] == rows["fld_coeffs (plain)"] == 1
    assert rows["fld_matvec (plain)"] == sum(1 + it for it in root)
    assert rows["fld_matvec (plain, node axis)"] == sum(
        1 + max(its[k] for its in pair if len(its) > k) for k in range(max(map(len, pair))))
    assert all(secs[row] > 0.0 for row in rows)


def test_step_batched_refuses_mixed_configs(tmp_path):
    """A batch whose members do not share one configuration is refused
    before any work (the JAX tree steps every member with its first
    member's configuration)."""
    import dataclasses

    _, a, b = port_tree(DECK3, tmp_path).nodes
    assert a.radiation.batch_key() == b.radiation.batch_key()
    b.radiation.cfg = dataclasses.replace(b.radiation.cfg, kappa_a=2.0)
    with pytest.raises(ValueError, match="one configuration"):
        a.radiation.step_batched([a.radiation, b.radiation], [{}, {}], 1e-3, [{}, {}])
