"""The port's fused-stage module (``artemis_tpu_torch.ops.stage``) against
the JAX package.

On the CPU ``stage`` runs its plain version, ``stage_reference``.  Two
cases hold it against the TPU kernels themselves in Pallas interpret mode
(``stage_periodic`` and ``stage``); the rest against the jnp stage
sequence that ``tests/test_pallas_stage.py`` ties to those kernels.  The
CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
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
from artemis_tpu.ops import pallas_stage  # noqa: E402
from artemis_tpu.ops import hydro as jhydro  # noqa: E402

from artemis_tpu_torch.config import ParameterInput as TPin  # noqa: E402
from artemis_tpu_torch.grid import grid_from_input as tgrid_from_input  # noqa: E402
from artemis_tpu_torch.ops import hydro as thydro  # noqa: E402
from artemis_tpu_torch.ops import stage as S  # noqa: E402

DECK = os.path.join(os.path.dirname(__file__), "..", "inputs", "linwave.in")
TOL = 1e-12


def setup(nx, ny, nz, recon="plm", nghost=2, bc="periodic"):
    """JAX and port (grid, cfg, Hydro, u, w) for one random smooth state."""
    ov = [f"parthenon/mesh/nx1={nx}", f"parthenon/mesh/nx2={ny}",
          f"parthenon/mesh/nx3={nz}", f"parthenon/mesh/nghost={nghost}"]
    for d in (1, 2, 3):
        ov += [f"parthenon/mesh/ix{d}_bc={bc}", f"parthenon/mesh/ox{d}_bc={bc}"]
    rng = np.random.default_rng(1)
    w = np.empty((1, 6, nz, ny, nx))
    w[:, 0] = 1.0 + 0.2 * rng.random((nz, ny, nx))
    w[:, 1:4] = 0.3 * (rng.random((1, 3, nz, ny, nx)) - 0.5)
    w[:, 5] = 1.0 + 0.2 * rng.random((nz, ny, nx))
    out = []
    for pin_cls, build, mod in ((JPin, jgrid_from_input, jhydro),
                                (TPin, tgrid_from_input, thydro)):
        pin = pin_cls.from_file(DECK)
        pin.apply_overrides(ov)
        grid = build(pin)
        cfg = mod.FluidCfg(fluid="gas", recon=recon, rsolver="hllc",
                           gamma=pin.get_real("gas", "gamma"), cfl=pin.get_real("gas", "cfl"))
        w[:, 4] = (cfg.gamma - 1) * w[:, 0] * w[:, 5]
        if mod is jhydro:
            hyd = jhydro.Hydro(grid, cfg)
            u, ww = hyd.prim_to_cons(jnp.asarray(w), cfg)
        else:
            hyd = thydro.Hydro(grid, cfg, device="cpu", dtype=torch.float64)
            u, ww = hyd.prim_to_cons(torch.as_tensor(w, dtype=torch.float64), cfg)
        out.append((grid, cfg, hyd, u, ww))
    return out


def jnp_stage(hyd, grid, cfg, u, w, u1, gam0, gam1, bdt, pcm):
    """The jnp stage sequence (tests/test_pallas_stage.py _ref_stage)."""
    wp = jbc.pad_and_fill(w, grid, "gas", {})
    fx = hyd.compute_fluxes(wp, cfg, pcm)
    ur = hyd.apply_update(u, u1, fx, gam0, gam1, bdt)
    ur = hyd.flux_source(ur, w, fx, bdt)
    ur = hyd.set_auxiliary(ur, cfg)
    wr = hyd.cons_to_prim(ur, cfg)
    u, w = hyd.prim_to_cons(wr, cfg)
    return u, w, hyd.estimate_dt(w, cfg)


def port_stage(hyd, u, w, gam0, gam1, beta, dt, pcm):
    dt_t = torch.full((), dt, dtype=u.dtype)
    return S.stage(hyd, w, u, u.clone(), gam0, gam1, beta, dt_t, pcm)


def diff(j, t):
    return float(np.max(np.abs(np.asarray(j) - t.cpu().numpy())))


def test_plain_matches_pallas_periodic_kernel():
    """K1 (stage_periodic, Pallas interpret mode) at 128x32x8, plm, rk2
    stage 2 (gam0 = gam1 = 0.5): u, w and the dtden maximum <= 1e-12."""
    (jg, jcfg, _, ju, jw), (_, _, th, tu, tw) = setup(128, 32, 8)
    uf, wf, dmax = pallas_stage.stage_periodic(jw, ju, ju * 1.0, jg, jcfg, 0.5, 0.5,
                                               0.5 * 1e-3, False, interpret=True)
    u, w, dtden = port_stage(th, tu, tw, 0.5, 0.5, 0.5, 1e-3, False)
    assert diff(uf[0], u[0]) <= TOL and diff(wf[0], w[0]) <= TOL
    assert abs(float(jnp.max(dmax)) - float(dtden.max())) <= TOL


def test_plain_matches_pallas_padded_kernel():
    """K2 (stage from ghost-padded prims, Pallas interpret mode) at
    32x32x8 with outflow walls, pcm: u, w and the dtden maximum <= 1e-12."""
    (jg, jcfg, _, ju, jw), (_, _, th, tu, tw) = setup(32, 32, 8, bc="outflow")
    wp = jbc.pad_and_fill(jw, jg, "gas", {})
    uf, wf, dmax = pallas_stage.stage(wp, ju, ju * 1.0, jg, jcfg, 0.0, 1.0, 1e-3, True,
                                      interpret=True)
    u, w, dtden = port_stage(th, tu, tw, 0.0, 1.0, 1.0, 1e-3, True)
    assert diff(uf[0], u[0]) <= TOL and diff(wf[0], w[0]) <= TOL
    assert abs(float(jnp.max(dmax)) - float(dtden.max())) <= TOL


@pytest.mark.parametrize("case", ["ppm-nghost3", "2d", "gam0-zero-reflecting"])
def test_plain_matches_jnp_stage(case):
    """Configs the Pallas kernels cover too, held against the jnp stage
    sequence: u, w <= 1e-12 and the implied dt (cfl / dtden max) <= 1e-12."""
    kw, gam0, gam1, beta = {
        "ppm-nghost3": (dict(nx=16, ny=8, nz=8, recon="ppm", nghost=3), 0.5, 0.5, 0.5),
        "2d": (dict(nx=16, ny=12, nz=1), 0.0, 1.0, 1.0),
        "gam0-zero-reflecting": (dict(nx=12, ny=8, nz=6, bc="reflecting"), 0.0, 1.0, 1.0),
    }[case]
    (jg, jcfg, jh, ju, jw), (_, tcfg, th, tu, tw) = setup(**kw)
    # one jit of the whole jnp sequence compiles far faster than its
    # hundreds of eager ops
    ur, wr, dtr = jax.jit(lambda u, w: jnp_stage(jh, jg, jcfg, u, w, u * 1.0, gam0, gam1,
                                                 beta * 2e-3, False))(ju, jw)
    u, w, dtden = port_stage(th, tu, tw, gam0, gam1, beta, 2e-3, False)
    assert diff(ur, u) <= TOL and diff(wr, w) <= TOL
    assert abs(tcfg.cfl / float(dtden.max()) - float(dtr)) <= TOL


def test_cpu_tensor_takes_the_plain_version():
    """stage() on CPU tensors is stage_reference, and launches nothing."""
    _, (_, _, th, tu, tw) = setup(16, 8, 4)
    S.stage_launches = 0
    dt = torch.full((), 1e-3, dtype=torch.float64)
    got = S.stage(th, tw, tu, tu, 0.5, 0.5, 0.5, dt, False)
    ref = S.stage_reference(th, tw, tu, tu, 0.5, 0.5, 0.5, dt, False)
    assert S.stage_launches == 0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("change,ok", [
    ({}, True),
    ({"recon": "ppm"}, True),
    ({"recon": "ppm", "nghost": 2}, False),   # ppm needs a 3-cell halo
    ({"rsolver": "hlle"}, False),
    ({"nspecies": 2}, False),
    ({"ny": 1}, False),
])
def test_kernel_envelope(change, ok):
    """supported(): Cartesian single-species gas, HLLC, pcm/plm/ppm,
    nghost >= 2 (>= 3 for ppm), nx and ny > 1; any extents."""
    grid_kw = {k: change[k] for k in ("nghost", "ny") if k in change}
    cfg_kw = {k: v for k, v in change.items() if k not in grid_kw}
    ny = grid_kw.get("ny", 20)
    pin = TPin.from_file(DECK)
    pin.apply_overrides(["parthenon/mesh/nx1=48", f"parthenon/mesh/nx2={ny}",
                         "parthenon/mesh/nx3=12",
                         f"parthenon/mesh/nghost={grid_kw.get('nghost', 3)}"])
    cfg = thydro.FluidCfg(**{**dict(fluid="gas", recon="plm", rsolver="hllc"), **cfg_kw})
    assert S.supported(tgrid_from_input(pin), cfg) is ok
