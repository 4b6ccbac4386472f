"""Multispecies gas+dust advection convergence problem
(reference: src/pgen/advection.hpp; port of
``artemis_tpu/pgen/advection.py``, numpy only).

A sinusoidal density/velocity perturbation advected along the grid diagonal;
dust species 2 counter-propagates.  Writes ``<problem_id>-errs.dat`` with
the reference column layout (advection.hpp:236-407) so the reference
thresholds (tst/scripts/advection/advection.py:142-146) apply.
"""

from __future__ import annotations

import math
import os

import numpy as np

from . import Problem
from .linear_wave import _setup_wave  # same wavevector geometry


def _analytic(av, gamma, x1v, x2v, x3v):
    x = av.cos_a2 * (x1v * av.cos_a3 + x2v * av.sin_a3) + x3v * av.sin_a2
    sn = np.sin(av.k_par * x)
    d0, vflow = 1.0, av.vflow
    p0 = 1.0 / gamma
    mx = d0 * vflow + av.amp * sn * vflow
    cd = d0 + av.amp * sn
    cm1 = mx * av.cos_a2 * av.cos_a3
    cm2 = mx * av.cos_a2 * av.sin_a3
    cm3 = mx * av.sin_a2
    ce = p0 / (gamma - 1.0) + 0.5 * d0 * vflow**2 + 0.5 * d0 * av.amp * sn * vflow**2
    return cd, cm1, cm2, cm3, ce


def build(pin, grid, gas_cfg, dust_cfg=None) -> Problem:
    if grid.coords != "cartesian":
        raise ValueError("advection pgen requires Cartesian geometry!")
    gamma = gas_cfg.gamma if gas_cfg is not None else 5.0 / 3.0
    av = _setup_wave(pin, grid, gamma, need_wave_flag=False)
    if av.vflow == 0.0:
        raise ValueError("advection pgen requires nonzero vflow")
    if gas_cfg is not None and gas_cfg.nspecies != 1:
        raise ValueError("Advection pgen requires a single gas species.")
    if dust_cfg is not None and dust_cfg.nspecies != 2:
        raise ValueError("Advection pgen requires two dust species.")

    nperiod = pin.get_or_add_real("problem", "nperiod", 1.0)
    pin.set("parthenon/time", "tlim", nperiod * abs(av.lam / av.vflow))

    x1v, x2v, x3v = grid.cell_centers()
    cd, cm1, cm2, cm3, ce = _analytic(av, gamma, x1v, x2v, x3v)
    shape = tuple(reversed(grid.nx))
    b = lambda a: np.broadcast_to(a, shape)
    cd, cm1, cm2, cm3, ce = b(cd), b(cm1), b(cm2), b(cm3), b(ce)

    prims = {}
    if gas_cfg is not None:
        cu = ce - 0.5 * (cm1**2 + cm2**2 + cm3**2) / cd
        prims["gas"] = np.stack(
            [cd, cm1 / cd, cm2 / cd, cm3 / cd, (gamma - 1.0) * cu, cu / cd])[None, :]
    if dust_cfg is not None:
        w1 = np.stack([cd, cm1 / cd, cm2 / cd, cm3 / cd])
        w2 = np.stack([cd, -cm1 / cd, -cm2 / cd, -cm3 / cd])
        prims["dust"] = np.stack([w1, w2])  # [2, 4, z, y, x]

    def after_loop(grid, pin, state, tm, data_dir):
        _write_errors(av, gamma, grid, pin, state, tm, data_dir,
                      do_gas=gas_cfg is not None, do_dust=dust_cfg is not None)

    return Problem(prims=prims, after_loop=after_loop)


def _write_errors(av, gamma, grid, pin, state, tm, data_dir, do_gas, do_dust):
    """Volume-weighted L1 errors of gas (5 columns) and of each dust species
    (4 columns each) against the initial condition, and their RMS per
    fluid, appended to <problem_id>-errs.dat."""
    s3, s2, s1 = grid.int_slices
    x1v, x2v, x3v = grid.cell_centers()
    cd, cm1, cm2, cm3, ce = _analytic(av, gamma, x1v, x2v, x3v)
    vol = np.broadcast_to(grid.geom.volume(), grid.shape_entire)[(s3, s2, s1)]
    total_vol = np.prod([grid.xmax[d] - grid.xmin[d] for d in range(3)])

    l1 = np.zeros(13)
    if do_gas:
        u = state["gas"]["u"][0].cpu().numpy()
        for i, ref in enumerate((cd, cm1, cm2, cm3, ce)):
            l1[i] = np.sum(vol * np.abs(u[i] - ref))
    if do_dust:
        ud = state["dust"]["u"].cpu().numpy()
        for i, ref in enumerate((cd, cm1, cm2, cm3)):
            l1[5 + i] = np.sum(vol * np.abs(ud[0, i] - ref))
            l1[9 + i] = np.sum(vol * np.abs(ud[1, i] + ref)) if i > 0 else \
                np.sum(vol * np.abs(ud[1, i] - ref))
    l1 /= total_vol

    rms_gas = math.sqrt(np.sum(l1[0:5] ** 2))
    rms_d1 = math.sqrt(np.sum(l1[5:9] ** 2))
    rms_d2 = math.sqrt(np.sum(l1[9:13] ** 2))

    pid = pin.get_str("parthenon/job", "problem_id")
    fname = os.path.join(data_dir, pid + "-errs.dat")
    new = not os.path.exists(fname)
    with open(fname, "a") as f:
        if new:
            f.write("# Nx1  Nx2  Nx3   Ncycle  RMS-L1-gas  RMS-L1-dust1  RMS-L1-dust2"
                    "  [13 component L1 columns]\n")
        f.write(f"{grid.nx[0]:04d}  {grid.nx[1]:04d}  {grid.nx[2]:04d}"
                f"  {tm.ncycle:05d}  {rms_gas:e}   {rms_d1:e}   {rms_d2:e} ")
        for e in l1:
            f.write(f"  {e:e}")
        f.write("\n")
