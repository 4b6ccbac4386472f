"""Linear wave convergence problem (reference: src/pgen/linear_wave.hpp;
port of ``artemis_tpu/pgen/linear_wave.py``, numpy only).

Initializes an eigenmode of the ideal-gas hydro equations along the grid
diagonal (or a chosen axis), evolves for an integer number of wave periods,
and measures volume-weighted L1 errors of the conserved fields against the
initial condition, writing ``<problem_id>-errs.dat`` in the reference format
so the reference regression thresholds apply verbatim
(tst/scripts/hydro/linwave.py:99-143).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

from . import Problem


def hydro_eigensystem(d, v1, v2, v3, p, gamma):
    """Right eigenvectors (columns) and eigenvalues of ideal-gas hydro
    (linear_wave.hpp:64-110)."""
    vsq = v1 * v1 + v2 * v2 + v3 * v3
    h = (p / (gamma - 1.0) + 0.5 * d * vsq + p) / d
    a = math.sqrt(gamma * p / d)
    ev = np.array([v1 - a, v1, v1, v1, v1 + a])
    rem = np.zeros((5, 5))
    rem[:, 0] = [1.0, v1 - a, v2, v3, h - v1 * a]
    rem[:, 1] = [0.0, 0.0, 1.0, 0.0, v2]
    rem[:, 2] = [0.0, 0.0, 0.0, 1.0, v3]
    rem[:, 3] = [1.0, v1, v2, v3, 0.5 * vsq]
    rem[:, 4] = [1.0, v1 + a, v2, v3, h + v1 * a]
    return ev, rem


@dataclass
class LinWave:
    wave_flag: int
    amp: float
    vflow: float
    lam: float
    k_par: float
    d0: float
    p0: float
    v1_0: float
    cos_a2: float
    cos_a3: float
    sin_a2: float
    sin_a3: float
    ev: np.ndarray
    rem: np.ndarray
    gamma: float


def _setup_wave(pin, grid, gamma, need_wave_flag: bool = True) -> LinWave:
    wave_flag = pin.get_int("problem", "wave_flag") if need_wave_flag else \
        pin.get_or_add_int("problem", "wave_flag", 0)
    amp = pin.get_real("problem", "amp")
    vflow = pin.get_or_add_real("problem", "vflow", 0.0)
    along_x1 = pin.get_or_add_bool("problem", "along_x1", False)
    along_x2 = pin.get_or_add_bool("problem", "along_x2", False)
    along_x3 = pin.get_or_add_bool("problem", "along_x3", False)
    ndim = grid.ndim
    multi_d = ndim > 1
    three_d = ndim > 2

    # wavevector from the ROOT DOMAIN extents (equal to the grid extents
    # except on AMR patch grids, where xmin/xmax are the patch bounds)
    x1size = grid.dom_max[0] - grid.dom_min[0]
    x2size = grid.dom_max[1] - grid.dom_min[1]
    x3size = grid.dom_max[2] - grid.dom_min[2]

    cos_a3, sin_a3, cos_a2, sin_a2 = 1.0, 0.0, 1.0, 0.0
    if multi_d and not along_x1:
        ang_3 = math.atan(x1size / x2size)
        sin_a3, cos_a3 = math.sin(ang_3), math.cos(ang_3)
    if three_d and not along_x1:
        ang_2 = math.atan(0.5 * (x1size * cos_a3 + x2size * sin_a3) / x3size)
        sin_a2, cos_a2 = math.sin(ang_2), math.cos(ang_2)
    if along_x2:
        cos_a3, sin_a3, cos_a2, sin_a2 = 0.0, 1.0, 1.0, 0.0
    if along_x3:
        cos_a3, sin_a3, cos_a2, sin_a2 = 0.0, 1.0, 0.0, 1.0

    lam = np.finfo(np.float32).max
    if cos_a2 * cos_a3 > 0.0:
        lam = min(lam, x1size * cos_a2 * cos_a3)
    if cos_a2 * sin_a3 > 0.0:
        lam = min(lam, x2size * cos_a2 * sin_a3)
    if sin_a2 > 0.0:
        lam = min(lam, x3size * sin_a2)

    k_par = 2.0 * math.pi / lam
    d0, v1_0 = 1.0, vflow
    p0 = 1.0 / gamma
    ev, rem = hydro_eigensystem(d0, v1_0, 0.0, 0.0, p0, gamma)
    return LinWave(
        wave_flag=wave_flag, amp=amp, vflow=vflow, lam=lam, k_par=k_par,
        d0=d0, p0=p0, v1_0=v1_0, cos_a2=cos_a2, cos_a3=cos_a3,
        sin_a2=sin_a2, sin_a3=sin_a3, ev=ev, rem=rem, gamma=gamma,
    )


def _analytic_cons(lw: LinWave, x1v, x2v, x3v):
    """Exact conserved eigenmode fields at given (broadcastable) coords."""
    x = lw.cos_a2 * (x1v * lw.cos_a3 + x2v * lw.sin_a3) + x3v * lw.sin_a2
    sn = np.sin(lw.k_par * x)
    f = lw.wave_flag
    mx = lw.d0 * lw.vflow + lw.amp * sn * lw.rem[1][f]
    my = lw.amp * sn * lw.rem[2][f]
    mz = lw.amp * sn * lw.rem[3][f]
    cd = lw.d0 + lw.amp * sn * lw.rem[0][f]
    cm1 = mx * lw.cos_a2 * lw.cos_a3 - my * lw.sin_a3 - mz * lw.sin_a2 * lw.cos_a3
    cm2 = mx * lw.cos_a2 * lw.sin_a3 + my * lw.cos_a3 - mz * lw.sin_a2 * lw.sin_a3
    cm3 = mx * lw.sin_a2 + mz * lw.cos_a2
    ce = (lw.p0 / (lw.gamma - 1.0) + 0.5 * lw.d0 * lw.v1_0**2
          + lw.amp * sn * lw.rem[4][f])
    return cd, cm1, cm2, cm3, ce


def build(pin, grid, gas_cfg, dust_cfg=None) -> Problem:
    if grid.coords != "cartesian":
        raise ValueError("linear_wave pgen requires Cartesian geometry!")
    lw = _setup_wave(pin, grid, gas_cfg.gamma)

    # reset tlim to nperiod wave-crossing times (linear_wave.hpp:209-211)
    nperiod = pin.get_or_add_real("problem", "nperiod", 1.0)
    pin.set("parthenon/time", "tlim", nperiod * abs(lw.lam / lw.ev[lw.wave_flag]))

    # initial primitive state over the interior grid
    x1v, x2v, x3v = grid.cell_centers()
    cd, cm1, cm2, cm3, ce = _analytic_cons(lw, x1v, x2v, x3v)
    shape = tuple(reversed((grid.nx[0], grid.nx[1], grid.nx[2])))
    cd = np.broadcast_to(cd, shape)
    cm1 = np.broadcast_to(cm1, shape)
    cm2 = np.broadcast_to(cm2, shape)
    cm3 = np.broadcast_to(cm3, shape)
    ce = np.broadcast_to(ce, shape)
    cu = ce - 0.5 * (cm1**2 + cm2**2 + cm3**2) / cd
    w = np.stack([cd, cm1 / cd, cm2 / cd, cm3 / cd,
                  (gas_cfg.gamma - 1.0) * cu, cu / cd])[None, :]  # [1, 6, z, y, x]

    def after_loop(grid, pin, state, tm, data_dir):
        _write_errors(lw, grid, pin, state, tm, data_dir)

    return Problem(prims={"gas": w}, after_loop=after_loop)


def _write_errors(lw: LinWave, grid, pin, state, tm, data_dir):
    """L1 errors of conserved fields vs ICs -> <problem_id>-errs.dat
    (linear_wave.hpp:266-377)."""
    u = state["gas"]["u"][0].cpu().numpy()  # [6, z, y, x] interior
    s3, s2, s1 = grid.int_slices
    x1v, x2v, x3v = grid.cell_centers()
    cd, cm1, cm2, cm3, ce = _analytic_cons(lw, x1v, x2v, x3v)
    g = grid.geom
    vol = np.broadcast_to(g.volume(), grid.shape_entire)[(s3, s2, s1)]

    errs = np.empty(5)
    for i, ref in enumerate((cd, cm1, cm2, cm3, ce)):
        errs[i] = np.sum(vol * np.abs(u[(0, 1, 2, 3, 4)[i]] - ref))

    total_vol = np.prod([grid.xmax[d] - grid.xmin[d] for d in range(3)])
    errs /= total_vol
    rms = math.sqrt(np.sum(errs**2))

    pid = pin.get_str("parthenon/job", "problem_id")
    fname = os.path.join(data_dir, pid + "-errs.dat")
    new = not os.path.exists(fname)
    with open(fname, "a") as f:
        if new:
            f.write("# Nx1  Nx2  Nx3   Ncycle  RMS-L1       "
                    "d_L1         M1_L1         M2_L1         M3_L1         E_L1\n")
        f.write(f"{grid.nx[0]:04d}  {grid.nx[1]:04d}  {grid.nx[2]:04d}"
                f"  {tm.ncycle:05d}  {rms:e} ")
        for e in errs:
            f.write(f"  {e:e}")
        f.write("\n")
