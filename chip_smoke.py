#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``artemis_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the last
line is printed:

1. toolchain: a CUDA device must be present; prints the card's name and
   power limit (nvidia-smi), torch's CUDA version, nvcc's version and
   whether triton imports;
2. build: compiles ``artemis_tpu_torch/csrc/stage_cart.cu`` with nvcc;
3. kernel vs plain version on the card: the fused stage kernel against
   ``stage_reference`` over {periodic, outflow, reflecting} x {pcm, plm,
   ppm} x {float64 <= 1e-12, float32 <= 1e-5 abs} x {gam0 = 0, gam0 != 0}
   on a ragged 3-D and a 2-D shape, the dtden maximum included;
4. the linear-wave deck through ``Simulation(..., device="cuda")``
   (rk2 + plm + hllc, float64, nghost 4, N = 16 and 32, L/R sound and
   entropy waves) against the reference's regression thresholds, with one
   kernel launch per RK stage;
5. the full-size Cartesian box (256x256x128 float32 rk2 + plm + hllc, the
   flagship configuration of bench.py): the main path driven through
   ``Simulation.run`` with the launch count reset before and read after,
   zone-cycles/s for the kernel path, the plain path and a float64 kernel
   run, the kernel's and the plain stage's time per launch, and the
   kernel and plain end states compared after the same cycles.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(HERE, "inputs", "linwave.in")
DEVICE = "cuda"
F64_TOL = 1e-12
F32_TOL = 1e-5


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- phase 1 -------------------------------------------------------------
def phase_toolchain(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}  torch.version.cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}")
    from artemis_tpu_torch import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print("nvcc: " + nvcc.strip().splitlines()[-1])
    try:
        import triton

        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")
    return smi


# -- phase 2 -------------------------------------------------------------
def phase_build():
    from artemis_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load("stage_cart")
    secs = time.perf_counter() - t0
    print(f"build: stage_cart.cu in {secs:.1f} s")
    for line in _build.build_log.get("stage_cart", (0, ""))[1].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())
    return secs


# -- phase 3 -------------------------------------------------------------
def setup_state(torch, nx, ny, nz, recon, bc, nghost, dtype, seed=1):
    """Grid, Hydro and a random smooth state (as tests/test_pallas_stage.py
    makes it) on the card."""
    import numpy as np

    from artemis_tpu_torch.config import ParameterInput
    from artemis_tpu_torch.grid import grid_from_input
    from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro

    pin = ParameterInput.from_file(DECK)
    ov = [f"parthenon/mesh/nx1={nx}", f"parthenon/mesh/nx2={ny}",
          f"parthenon/mesh/nx3={nz}", f"parthenon/mesh/nghost={nghost}"]
    for d in (1, 2, 3):
        ov += [f"parthenon/mesh/ix{d}_bc={bc}", f"parthenon/mesh/ox{d}_bc={bc}"]
    pin.apply_overrides(ov)
    grid = grid_from_input(pin)
    cfg = FluidCfg(fluid="gas", recon=recon, rsolver="hllc",
                   gamma=pin.get_real("gas", "gamma"), cfl=pin.get_real("gas", "cfl"))
    hyd = Hydro(grid, cfg, device=DEVICE, dtype=dtype)
    rng = np.random.default_rng(seed)
    w = np.empty((1, 6, nz, ny, nx))
    w[:, 0] = 1.0 + 0.2 * rng.random((nz, ny, nx))
    w[:, 1:4] = 0.3 * (rng.random((1, 3, nz, ny, nx)) - 0.5)
    w[:, 5] = 1.0 + 0.2 * rng.random((nz, ny, nx))
    w[:, 4] = (cfg.gamma - 1) * w[:, 0] * w[:, 5]
    u, w = hyd.prim_to_cons(torch.as_tensor(w, dtype=dtype, device=DEVICE), cfg)
    return hyd, u, w


def phase_compare(torch):
    from artemis_tpu_torch.ops import stage as S

    worst = {torch.float64: 0.0, torch.float32: 0.0}
    ncase = 0
    for shape in ((48, 20, 12), (40, 24, 1)):
        for bc in ("periodic", "outflow", "reflecting"):
            for recon in ("pcm", "plm", "ppm"):
                for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
                    hyd, u, w = setup_state(torch, *shape, recon, bc,
                                            3 if recon == "ppm" else 2, dtype)
                    u1 = u * 1.0
                    dt = torch.full((), 2e-3, dtype=dtype, device=DEVICE)
                    for gam0, gam1, beta in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
                        uk, wk, dk = S.stage(hyd, w, u, u1, gam0, gam1, beta, dt, False)
                        torch.cuda.synchronize()
                        ur, wr, dr = S.stage_reference(hyd, w, u, u1, gam0, gam1, beta, dt, False)
                        torch.cuda.synchronize()
                        err = max(float((uk - ur).abs().max()), float((wk - wr).abs().max()))
                        derr = float((dk.max() - dr.max()).abs() / dr.max())
                        check(err <= tol and derr <= tol,
                              f"kernel vs plain {shape} {bc} {recon} {dtype} gam0={gam0}: "
                              f"max|du|,|dw| = {err:.3e}, dtden rel {derr:.3e} > {tol:g}")
                        worst[dtype] = max(worst[dtype], err)
                        ncase += 1
    print(f"compare: {ncase} kernel-vs-plain cases pass; max abs err "
          f"f64 {worst[torch.float64]:.3e} (tol {F64_TOL:g}), "
          f"f32 {worst[torch.float32]:.3e} (tol {F32_TOL:g})")
    return worst[torch.float64], worst[torch.float32]


# -- phase 4 -------------------------------------------------------------
WAVES = {
    "L-sound": ["problem/wave_flag=0", "problem/vflow=0.0"],
    "R-sound": ["problem/wave_flag=4", "problem/vflow=0.0"],
    "entropy": ["problem/wave_flag=3", "problem/vflow=1.0"],
}


def phase_linwave(torch):
    import numpy as np

    from artemis_tpu_torch import Simulation
    from artemis_tpu_torch.ops import stage as S

    with tempfile.TemporaryDirectory() as data:
        for res in (16, 32):
            for wave, wargs in WAVES.items():
                args = ["parthenon/job/problem_id=linear_wave", "problem/nperiod=1",
                        "parthenon/time/nlim=1000", "parthenon/time/integrator=rk2",
                        "parthenon/mesh/nghost=4", f"parthenon/mesh/nx1={res}",
                        f"parthenon/mesh/nx2={res // 2}", f"parthenon/mesh/nx3={res // 2}",
                        "problem/amp=1.0e-6", "gas/reconstruct=plm", "gas/riemann=hllc",
                        "artemis/precision=float64"] + wargs
                sim = Simulation(DECK, args, data, device=DEVICE)
                check(sim.driver._fused_stage, "linwave did not select the fused stage kernel")
                S.stage_launches = 0
                sim.run()
                torch.cuda.synchronize()
                check(S.stage_launches == 2 * sim.tm.ncycle,
                      f"linwave N={res} {wave}: {S.stage_launches} launches for "
                      f"{sim.tm.ncycle} rk2 cycles")
                print(f"linwave N={res} {wave}: ncycle={sim.tm.ncycle} "
                      f"launches={S.stage_launches}")
        errs = np.loadtxt(os.path.join(data, "linear_wave-errs.dat"), ndmin=2)
    check(np.isfinite(errs).all(), "non-finite linwave errors")
    rms = errs.reshape(2, 3, -1)[:, :, 4]
    r16, r32 = rms
    print(f"linwave rms N=16 {r16.tolist()}  N=32 {r32.tolist()}")
    check(r32[0] <= 2.23e-7 and r32[1] <= 2.23e-7, f"sound error {r32[:2]} > 2.23e-7")
    check(r32[2] <= 2.21e-7, f"entropy error {r32[2]} > 2.21e-7")
    check(r32[0] / r16[0] <= 0.29 and r32[1] / r16[1] <= 0.29,
          f"sound convergence {r32[:2] / r16[:2]} > 0.29")
    check(r32[2] / r16[2] <= 0.30, f"entropy convergence {r32[2] / r16[2]} > 0.30")
    sym = float(r32[0] - r32[1])
    print(f"linwave L/R sound symmetry: rms32[L] - rms32[R] = {sym:.3e} "
          f"({'exact' if sym == 0.0 else 'NOT exact'})")
    return sym


# -- phase 5 -------------------------------------------------------------
FLAGSHIP = (256, 256, 128)


def flagship_sim(dtype, data, fused=True):
    from artemis_tpu_torch import Simulation

    nx, ny, nz = FLAGSHIP
    args = [f"parthenon/mesh/nx1={nx}", f"parthenon/mesh/nx2={ny}",
            f"parthenon/mesh/nx3={nz}", "parthenon/mesh/nghost=2",
            "problem/amp=1.0e-3", "gas/reconstruct=plm", "gas/riemann=hllc",
            "parthenon/time/integrator=rk2", f"artemis/precision={dtype}"]
    return Simulation(DECK, args, data, device=DEVICE, fused_stage=fused)


def warm_up(sim, ncycles):
    """Advance through the user entry point (Simulation.run, which adds
    the problem's outputs around the same loop)."""
    sim.tm.nlim = sim.tm.ncycle + ncycles
    sim.run()
    check(sim.status == "complete" and sim.tm.ncycle == sim.tm.nlim,
          f"run stopped at cycle {sim.tm.ncycle}, wanted {sim.tm.nlim}")


def run_cycles(torch, sim, ncycles):
    """Advance ``ncycles`` through the evolution loop that Simulation.run
    drives, timed by CUDA events; returns zone-cycles/s."""
    from artemis_tpu_torch.driver import evolve

    sim.tm.nlim = sim.tm.ncycle + ncycles
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sim.state, sim.tm, _, status = evolve(sim.driver, sim.state, sim.tm)
    end.record()
    torch.cuda.synchronize()
    check(status == "complete" and sim.tm.ncycle == sim.tm.nlim,
          f"run stopped at cycle {sim.tm.ncycle}, wanted {sim.tm.nlim}")
    secs = start.elapsed_time(end) / 1e3
    return FLAGSHIP[0] * FLAGSHIP[1] * FLAGSHIP[2] * ncycles / secs


def time_launches(torch, fn, n):
    """Mean ms per call of fn() over n calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_flagship(torch, smi):
    from artemis_tpu_torch.ops import stage as S

    res = {}
    with tempfile.TemporaryDirectory() as data:
        # the main path: 2 warm-up + 20 timed cycles, counting launches
        sim = flagship_sim("float32", data)
        check(sim.driver._fused_stage, "flagship did not select the fused stage kernel")
        S.stage_launches = 0
        warm_up(sim, 2)
        res["kernel_zcps"] = run_cycles(torch, sim, 20)
        launches = S.stage_launches
        check(launches == 2 * sim.tm.ncycle,
              f"flagship: {launches} launches for {sim.tm.ncycle} rk2 cycles")
        res["launches"] = launches
        print(f"flagship f32 kernel path: 20 cycles, {res['kernel_zcps']:.6e} "
              f"zone-cycles/s [{smi}]")
        u, w = sim.state["gas"]["u"], sim.state["gas"]["w"]
        check(tuple(u.shape) == (1, 6, FLAGSHIP[2], FLAGSHIP[1], FLAGSHIP[0])
              and bool(torch.isfinite(u).all()) and bool(torch.isfinite(w).all()),
              "flagship kernel state not finite / wrong shape")

        # per-launch kernel and plain stage times on the flagship state
        hyd = sim.driver.hydro
        u1 = u.clone()
        dt = torch.full((), sim.tm.dt, dtype=u.dtype, device=DEVICE)
        calls = itertools.cycle([(0.0, 1.0, 1.0), (0.5, 0.5, 0.5)])  # rk2 stages 1, 2

        def kern():
            g0, g1, b = next(calls)
            return S.stage(hyd, w, u, u1, g0, g1, b, dt, False)

        def plain():
            g0, g1, b = next(calls)
            return S.stage_reference(hyd, w, u, u1, g0, g1, b, dt, False)

        res["ms"] = time_launches(torch, kern, 20)
        res["plain_ms"] = time_launches(torch, plain, 4)
        print(f"flagship f32 per stage launch: kernel {res['ms']:.4f} ms, "
              f"plain {res['plain_ms']:.4f} ms [{smi}]")
        uk, wk, _ = S.stage(hyd, w, u, u1, 0.5, 0.5, 0.5, dt, False)
        ur, wr, _ = S.stage_reference(hyd, w, u, u1, 0.5, 0.5, 0.5, dt, False)
        err = max(float((uk - ur).abs().max()), float((wk - wr).abs().max()))
        check(err <= F32_TOL, f"flagship stage kernel vs plain: {err:.3e} > {F32_TOL:g}")
        res["flagship_stage_err"] = err
        del sim, u, w, u1, uk, wk, ur, wr, hyd
        torch.cuda.empty_cache()

        # the padded-halo variant (the K2 path) at the same shape, outflow
        # walls: the kernel alone on padded prims, with its ghost fill, and
        # the plain stage
        from artemis_tpu_torch import bc as bc_mod

        hyd, u, w = setup_state(torch, *FLAGSHIP, "plm", "outflow", 2, torch.float32)
        u1 = u.clone()
        w_pad = bc_mod.pad_and_fill(w, hyd.grid, "gas")
        dt = torch.full((), 1e-4, dtype=torch.float32, device=DEVICE)
        res["padded_ms"] = time_launches(
            torch, lambda: S._launch(hyd, w_pad, u, u1, 0.5, 0.5, 0.5, dt, False,
                                     periodic=False), 20)
        res["padded_stage_ms"] = time_launches(
            torch, lambda: S.stage(hyd, w, u, u1, 0.5, 0.5, 0.5, dt, False), 20)
        res["padded_plain_ms"] = time_launches(
            torch, lambda: S.stage_reference(hyd, w, u, u1, 0.5, 0.5, 0.5, dt, False), 4)
        uk, wk, _ = S.stage(hyd, w, u, u1, 0.5, 0.5, 0.5, dt, False)
        ur, wr, _ = S.stage_reference(hyd, w, u, u1, 0.5, 0.5, 0.5, dt, False)
        err = max(float((uk - ur).abs().max()), float((wk - wr).abs().max()))
        check(err <= F32_TOL, f"flagship padded stage kernel vs plain: {err:.3e} > {F32_TOL:g}")
        res["flagship_stage_err"] = max(res["flagship_stage_err"], err)
        print(f"flagship f32 padded halo (outflow) per stage: kernel {res['padded_ms']:.4f} ms, "
              f"with ghost fill {res['padded_stage_ms']:.4f} ms, plain "
              f"{res['padded_plain_ms']:.4f} ms [{smi}]")
        del hyd, u, w, u1, w_pad, uk, wk, ur, wr
        torch.cuda.empty_cache()

        # the plain path through the same entry point, and the kernel path
        # over the same cycles for an end-state comparison
        plain_sim = flagship_sim("float32", data, fused=False)
        warm_up(plain_sim, 1)
        res["plain_zcps"] = run_cycles(torch, plain_sim, 5)
        print(f"flagship f32 plain path: 5 cycles, {res['plain_zcps']:.6e} "
              f"zone-cycles/s [{smi}]")
        ksim = flagship_sim("float32", data)
        warm_up(ksim, 6)
        err = max(float((ksim.state["gas"][k_] - plain_sim.state["gas"][k_]).abs().max())
                  for k_ in ("u", "w"))
        check(abs(ksim.tm.time - plain_sim.tm.time) <= 1e-6 * plain_sim.tm.time
              and err <= F32_TOL,
              f"flagship 6-cycle kernel vs plain: t {ksim.tm.time} vs {plain_sim.tm.time}, "
              f"max abs diff {err:.3e}")
        print(f"flagship f32 after 6 cycles: kernel vs plain max abs diff {err:.3e} "
              f"(tol {F32_TOL:g})")
        res["flagship_6cycle_err"] = err
        del plain_sim, ksim
        torch.cuda.empty_cache()

        # one float64 kernel run
        sim64 = flagship_sim("float64", data)
        warm_up(sim64, 2)
        res["kernel_f64_zcps"] = run_cycles(torch, sim64, 10)
        check(bool(torch.isfinite(sim64.state["gas"]["u"]).all()), "f64 flagship not finite")
        print(f"flagship f64 kernel path: 10 cycles, {res['kernel_f64_zcps']:.6e} "
              f"zone-cycles/s [{smi}]")
        del sim64
        torch.cuda.empty_cache()
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    smi = phase_toolchain(torch)
    build_s = phase_build()
    err64, err32 = phase_compare(torch)
    sym = phase_linwave(torch)
    res = phase_flagship(torch, smi)
    kernels = {"kernels": [{
        "name": "stage_cart",
        "route": "cuda",
        "source": "artemis_tpu_torch/csrc/stage_cart.cu",
        "replaces": "artemis_tpu/ops/pallas_stage.py:337",
        "also_replaces": "artemis_tpu/ops/pallas_stage.py:132",
        "launches": res["launches"],
        "max_abs_err": max(err32, res["flagship_stage_err"]),
        "max_abs_err_f64": err64,
        "tol_f32": F32_TOL,
        "tol_f64": F64_TOL,
        "ms": res["ms"],
        "plain_ms": res["plain_ms"],
        "padded_ms": res["padded_ms"],
        "padded_stage_ms": res["padded_stage_ms"],
        "padded_plain_ms": res["padded_plain_ms"],
        "shape": list(FLAGSHIP),
        "dtype": "float32",
        "build_s": build_s,
        "linwave_lr_asymmetry": sym,
        "zone_cycles_per_s": {"kernel_f32": res["kernel_zcps"],
                              "plain_f32": res["plain_zcps"],
                              "kernel_f64": res["kernel_f64_zcps"]},
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
