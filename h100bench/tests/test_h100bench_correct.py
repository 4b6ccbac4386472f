"""How ``correct`` comes out: a run of each cell, cut to a CPU test's
size, is correct; the lower-precision control (the program in float32)
and a run whose timed path is broken underneath are not.  The harness's
look for a card is skipped (``run_cell`` on the CPU); the rest of a run is
driven as on the card.  ``test_control_on_the_card`` runs the control at
each cell's own size on three seeds (marked ``cuda``)."""

import time
import warnings

import pytest
import torch

from h100bench import spec
from h100bench.run import run_cell

from .small import CELLS, on_the_cards_path, small_cell

SEED = 2 ** 31 + 977


@pytest.fixture(autouse=True)
def _cards_path(monkeypatch):
    on_the_cards_path(monkeypatch)


def _run(cell, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return run_cell(cell, SEED, 0.2, False, device="cpu", t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(small_cell(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = _run(small_cell(name), precision="float32")
    assert not out["correct"], out["checks"]


def _unchanged(step):
    def broken(self, state, dt, time):
        return state
    return broken


def _altered_at(pick, var, by):
    """The registers ``var`` of the cell that ``pick`` finds by density
    altered by the factor 1 + ``by`` where the step produces them."""
    def fault(step):
        def broken(self, state, dt, time):
            new = step(self, state, dt, time)
            u = new["gas"]["u"].clone()
            i = int(pick(u[:, 0]))
            for v in var:
                u[:, v].view(-1)[i] *= 1.0 + by
            new["gas"] = dict(new["gas"], u=u)
            return new
        return broken
    return fault


# the densest cell's density altered by 1e-5; the thinnest cell's mass, ten
# orders of magnitude below the midplane on disk_sph, by 10% with its
# velocity and specific energy kept (every register scaled)
_altered = _altered_at(torch.argmax, (0,), 1e-5)
_thin = _altered_at(torch.argmin, range(6), 0.1)


def _half(step):
    """The lower half of the x3 planes left as they were."""
    def broken(self, state, dt, time):
        new = step(self, state, dt, time)
        for fl, kinds in new.items():
            for k, t in kinds.items():
                if k in state.get(fl, {}) and t.ndim == 5:
                    kinds[k] = t.clone()
                    half = t.shape[2] // 2
                    kinds[k][:, :, :half] = state[fl][k][:, :, :half]
        return new
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _altered, _thin, _half],
                         ids=["unchanged", "altered", "thin", "half"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_step_is_not_correct(name, fault, monkeypatch):
    from artemis_tpu_torch import driver

    monkeypatch.setattr(driver.Driver, "step", fault(driver.Driver.step))
    out = _run(small_cell(name))
    assert not out["correct"], out["checks"]
    if fault is _thin:
        # the cell-by-cell gap holds the thin gas itself
        cell = out["checks"]["cell_err"]
        assert cell["value"] > cell["limit"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        out = run_cell(spec.load_cell(name), seed, 2.0, False,
                       t_start=time.perf_counter(), precision="float32")
        print(f"control {name} seed {seed}: " + ", ".join(
            f"{k} {c['value']}" for k, c in out["checks"].items()))
        assert not out["correct"], out["checks"]
