"""The port's plain tensor ops against the JAX package's jnp functions.

Inputs are made with numpy from a fixed seed and handed to both packages;
each assert states its tolerance.  Boundary fills only move data, so they
must match bitwise; the arithmetic ops run the same IEEE operations in the
same order on the CPU and must agree to 1e-12 in float64.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from artemis_tpu import bc as jbc  # noqa: E402
from artemis_tpu.config import ParameterInput as JPin  # noqa: E402
from artemis_tpu.grid import grid_from_input as jgrid_from_input  # noqa: E402
from artemis_tpu.ops import hydro as jhydro  # noqa: E402
from artemis_tpu.ops import recon as jrecon  # noqa: E402
from artemis_tpu.ops import riemann as jriemann  # noqa: E402

from artemis_tpu_torch import bc as tbc  # noqa: E402
from artemis_tpu_torch.config import ParameterInput as TPin  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input as tgrid_from_input  # noqa: E402
from artemis_tpu_torch.ops import hydro as thydro  # noqa: E402
from artemis_tpu_torch.ops import recon as trecon  # noqa: E402
from artemis_tpu_torch.ops import riemann as triemann  # noqa: E402

DECK = os.path.join(os.path.dirname(__file__), "..", "inputs", "linwave.in")
TOL = 1e-12
F64 = torch.float64

# a small spherical shell for the curvilinear branches (PLM_G, face-h
# momentum scaling, connection sources)
SPHERICAL = ["artemis/coordinates=spherical", "parthenon/mesh/x1min=1.0",
             "parthenon/mesh/x1max=2.0", "parthenon/mesh/x2min=0.6",
             "parthenon/mesh/x2max=2.5", "parthenon/mesh/x3min=0.0",
             "parthenon/mesh/x3max=1.0"]


def grids(overrides):
    """The same deck + overrides as a JAX grid and a port grid."""
    out = []
    for pin_cls, build in ((JPin, jgrid_from_input), (TPin, tgrid_from_input)):
        pin = pin_cls.from_file(DECK)
        pin.apply_overrides(list(overrides))
        out.append(build(pin))
    return out


def small(nghost=3, bc="periodic", coords=()):
    ov = ["parthenon/mesh/nx1=16", "parthenon/mesh/nx2=8", "parthenon/mesh/nx3=8",
          f"parthenon/mesh/nghost={nghost}"] + list(coords)
    for d in (1, 2, 3):
        ov += [f"parthenon/mesh/ix{d}_bc={bc}", f"parthenon/mesh/ox{d}_bc={bc}"]
    return grids(ov)


def prims(shape, rng, gamma=5.0 / 3.0):
    """A smooth positive primitive state [1, 6, *shape]."""
    w = np.empty((1, 6) + tuple(shape))
    w[:, 0] = 1.0 + 0.2 * rng.random(shape)
    w[:, 1:4] = 0.3 * (rng.random((1, 3) + tuple(shape)) - 0.5)
    w[:, 5] = 1.0 + 0.2 * rng.random(shape)
    w[:, 4] = (gamma - 1.0) * w[:, 0] * w[:, 5]
    return w


def both(a):
    return jnp.asarray(a), torch.as_tensor(a, dtype=F64)


def maxdiff(j, t):
    return float(np.max(np.abs(np.asarray(j) - t.numpy())))


@pytest.mark.parametrize("bc", ["periodic", "outflow", "reflecting"])
def test_pad_and_fill_bitwise(bc):
    jg, tg = small(bc=bc)
    w = prims((8, 8, 16), np.random.default_rng(3))
    jw, tw = both(w)
    jp = np.asarray(jbc.pad_and_fill(jw, jg, "gas", {}))
    tp = tbc.pad_and_fill(tw, tg, "gas", {}).numpy()
    assert jp.shape == tp.shape == (1, 6, 14, 14, 22)
    assert np.array_equal(jp, tp)  # bitwise


@pytest.mark.parametrize("coords", ["cartesian", "spherical"])
@pytest.mark.parametrize("method", ["pcm", "plm", "ppm"])
def test_reconstruct(method, coords):
    jg, tg = small(coords=SPHERICAL if coords == "spherical" else ())
    w = prims((14, 14, 22), np.random.default_rng(4))
    jw, tw = both(w)
    for d in (1, 2, 3):
        jl, jr = jrecon.reconstruct(jw, d, method, jg.geom)
        tl, tr = trecon.reconstruct(tw, d, method, tg.geom)
        assert maxdiff(jl, tl) <= TOL and maxdiff(jr, tr) <= TOL


@pytest.mark.parametrize("fluid,solver", [("gas", "hllc"), ("gas", "hlle"), ("gas", "llf"),
                                          ("dust", "hlle"), ("dust", "llf")])
def test_riemann(fluid, solver):
    rng = np.random.default_rng(5)
    shape = (8, 8, 17)
    ncomp = 6 if fluid == "gas" else 4
    wl = prims(shape, rng)[:, :ncomp]
    wr = prims(shape, rng)[:, :ncomp]
    (jl, tl), (jr, tr) = both(wl), both(wr)
    jall = jax.jit(lambda a, b: [jriemann.solve(a, b, d, fluid, solver, 5.0 / 3.0)
                                 for d in (1, 2, 3)])(jl, jr)
    for d, jout in zip((1, 2, 3), jall):
        tout = triemann.solve(tl, tr, d, fluid, solver, 5.0 / 3.0)
        for j, t in zip(jout, tout):
            if j is None:
                assert t is None
                continue
            assert maxdiff(j, t) <= TOL


@pytest.mark.parametrize("coords", ["cartesian", "spherical"])
@pytest.mark.parametrize("recon,solver", [("plm", "hllc"), ("ppm", "hlle"), ("pcm", "llf")])
def test_hydro_methods(recon, solver, coords):
    """Every Hydro method of the stage sequence, one after the other, each
    fed the same inputs in both packages."""
    jg, tg = small(coords=SPHERICAL if coords == "spherical" else ())
    cfg_kw = dict(fluid="gas", recon=recon, rsolver=solver, gamma=5.0 / 3.0, cfl=0.8)
    jcfg, tcfg = jhydro.FluidCfg(**cfg_kw), thydro.FluidCfg(**cfg_kw)
    jh = jhydro.Hydro(jg, jcfg)
    th = thydro.Hydro(tg, tcfg, device="cpu", dtype=F64)
    w = prims((8, 8, 16), np.random.default_rng(6))

    def chain(hyd, bc, cfg, w):
        """Each stage-sequence method on the previous one's output."""
        u, w2 = hyd.prim_to_cons(w, cfg)
        fx = hyd.compute_fluxes(bc.pad_and_fill(w, jg if bc is jbc else tg, "gas", {}),
                                cfg, False)
        un = hyd.apply_update(u, u * 1.0, fx, 0.5, 0.5, 1e-3)
        us = hyd.flux_source(un, w, fx, 1e-3)
        ua = hyd.set_auxiliary(us, cfg)
        wn = hyd.cons_to_prim(ua, cfg)
        flat = [f for d in (1, 2, 3) for f in fx[d]]
        return [u, w2, *flat, un, us, ua, wn, hyd.estimate_dt(wn, cfg)]

    jout = chain(jh, jbc, jcfg, jnp.asarray(w))
    tout = chain(th, tbc, tcfg, torch.as_tensor(w, dtype=F64))
    assert len(jout) == len(tout) == 16
    for j, t in zip(jout, tout):
        assert maxdiff(j, t) <= TOL


def test_hydro_constants_take_the_run_dtype():
    """float32 runs keep float32: no geometry constant promotes the state."""
    _, tg = small(coords=SPHERICAL)
    cfg = thydro.FluidCfg(fluid="gas", recon="plm", rsolver="hllc")
    th = thydro.Hydro(tg, cfg, device="cpu", dtype=torch.float32)
    w = torch.as_tensor(prims((8, 8, 16), np.random.default_rng(7)), dtype=torch.float32)
    u, w = th.prim_to_cons(w, cfg)
    fx = th.compute_fluxes(tbc.pad_and_fill(w, tg, "gas"), cfg, False)
    u = th.flux_source(th.apply_update(u, u, fx, 0.5, 0.5, 1e-3), w, fx, 1e-3)
    assert u.dtype == torch.float32
    assert th.estimate_dt(th.cons_to_prim(u, cfg), cfg).dtype == torch.float32
