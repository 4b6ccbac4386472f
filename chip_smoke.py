#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``artemis_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the last
line is printed.  The phases that only check kernels against their plain
versions (3, 4, 6, 9, 10, 12 and 17: CHECKS_BESIDE) run in a worker process
on the card beside rad_shock (15), whose loop is host-bound and untimed,
with phase 30's small trees and the untimed checks of phases 23 and 26:

1. toolchain: a CUDA device must be present; prints the card's name and
   power limit (nvidia-smi), torch's CUDA version, nvcc's version and
   whether triton imports;
2. build: compiles ``artemis_tpu_torch/csrc/stage_cart.cu``, ``fld.cu``,
   ``sweep.cu`` and ``stage_curv.cu`` (once per dtype and mode, full or
   partial) with nvcc and
   ``native/nbody.cpp`` with g++ (the N-body package's integrator), all at
   once, and prints the stage_cart build flags and ptxas's registers and
   spills;
3. kernel vs plain version on the card: the fused stage kernel on its
   tiled body against ``stage_reference`` and bitwise against its per-cell
   body (the wrapper's private switch) over {periodic, outflow,
   reflecting} x {pcm, plm, ppm} x {float64 <= 1e-12, float32 <= 1e-5 abs}
   x {gam0 = 0, gam0 != 0} on a ragged 3-D, a 2-D and a two-z-chunk shape
   and a periodic box narrower than the halo, the dtden maximum included;
4. the linear-wave deck through ``Simulation(..., device="cuda")``
   (rk2 + plm + hllc, float64, nghost 4, N = 16 and 32, L/R sound and
   entropy waves) against the reference's regression thresholds, with one
   kernel launch per RK stage, every one on the tiled body;
5. the full-size Cartesian box (256x256x128 float32 rk2 + plm + hllc, the
   flagship configuration of bench.py): the main path driven through
   ``Simulation.run`` with the launch counts reset before and read after
   (every launch on the tiled body), zone-cycles/s for the kernel path,
   the plain path and a float64 kernel run, the kernel's time per launch
   on the tiled and on the per-cell body (bitwise equal at full size) with
   ptxas's registers and spills of both, the plain stage's time per
   launch, the cycle's device busy time and idle share under
   torch.profiler, the padded halo (K2, outflow walls) on both bodies
   alone and with its ghost fill, and the kernel and plain end states
   compared after the same cycles;
6. the curvilinear stage kernel against ``stage_curv_reference`` on the
   card: the padded halo on spherical, cylindrical, axisymmetric and
   Cartesian grids (random states, ragged 20x12x6) over {full, partial} x
   {hllc, hlle} x {pcm, plm} x {float64 <= 1e-12, float32 <= 1e-5 abs} with
   the diffusion, gravity and rotating-frame variants; the disk_sph layout
   (ic strips) through both halo sources (<= 1e-12 / 1e-4: cells at the
   density floor amplify the two versions' operation orders to ~150 ulps),
   bitwise equal to each other, and its full and partial stages on the
   tiled body (K3 with viscosity, and its partial mode) bitwise equal to
   the per-cell body, the dtden maxima of the full ones included;
7. disk_sph at bench.py's shape (256x64x64 float32, rk2 + plm + hlle,
   alpha viscosity, point gravity, rotating frame): the main path through
   ``Simulation.run`` on the gather kernel with the launch counts reset
   before and read after (every launch on the tiled body), zone-cycles/s
   through the kernel (50 cycles after 2 warm-up), through the plain path
   and in float64, the kernel's time per launch on the tiled and on the
   per-cell body (bitwise equal at full size, and to the padded halo on
   both bodies) with ptxas's registers and spills of both, the plain
   stage's time per launch, K4 (the padded halo) on the same state on the
   tiled and on the per-cell body, alone and with the ic fill, against its
   bound, the cycle's split between the kernel
   and the host loop (and the device time by kernel under torch.profiler),
   the density-weighted L2 deviation from the initial condition (<= 6e-3,
   bench.py:100), and the kernel and plain end states compared after the
   same cycles;
8. disk_cyl and disk_axi at deck size in float64 for 5 cycles through the
   padded kernel (K4): L2 <= 6e-3 and two launches per cycle, every one on
   the tiled body; then the timed K4 cell, disk_cyl at 256x128x64 float32
   (the deck doubled on each axis; rk2 + plm + hllc, alpha viscosity,
   point gravity, rotating frame) through ``Simulation.run`` with the
   launch counts reset before and read after: zone-cycles/s, the cycle,
   the device's idle share, K4 per launch on the tiled and on the per-cell
   body (bitwise equal) alone and with its fill against the plain stage
   and the bound, and L2 vs IC <= 6e-3;
9. the FLD kernels (``csrc/fld.cu``: fld_coeffs, fld_matvec) against their
   plain versions on random states: float64 <= 1e-12 and float32 <= 1e-5
   relative, Dirichlet flags off, on and mixed, an odd nz, the smallest
   extents and a shape ragged across the tiled footprint and z chunks
   included, fld_coeffs' tiled body bitwise equal to its per-cell body;
   both over a node axis (N = 1, 2 and 16 nodes of 128x128x64 f32, 3 of
   17x9x33 f64, distinct fields): one launch each, bitwise equal to N
   one-node launches, within the same tolerances of the plain versions;
10. the six-face strip halo of ``stage_curv.cu`` on the tiled body against
   the plain version and bitwise equal to the padded halo and to the
   per-cell body (the wrapper's private switch) on small all-ic disks: the
   Cartesian radiation-hydro disk and the spherical disk with x3 ic
   without viscosity (K5b) and with alpha viscosity (K5a), both dtypes,
   four schemes (the dtden outputs compared by their maxima: the two bodies
   have different block counts);
11. the RHD cell (``inputs/disk_rhd_amr.in`` without refinement at
   bench.py's 512x512x64 root, float32, all faces ic, gray FLD): the main
   path through ``Simulation.run`` with the three kernels' counts reset
   before and read after (two six-face stage launches and one fld_coeffs
   launch per cycle, one fld_matvec launch per CG matvec), CG iterations
   per Newton outer iteration, host read-backs per cycle, zone-cycles/s of
   the kernel path (20 cycles after 2 warm-up) and of the plain path, the
   density L2 deviation from the initial condition (<= 3e-4, bench.py:185),
   each kernel's time per launch against its plain version and bound (K5b
   and K7 on the tiled body and on the per-cell body, with ptxas's
   registers and spills of both; K8 against one cuSPARSE SpMV of its
   operator as a CSR matrix, the library yardstick, built outside the
   timing and checked against K8), the tiled bodies bitwise equal to the
   per-cell bodies (K5b also to the padded halo) at full size, every
   fld_coeffs launch of the main path on the tiled body, and the cycle's
   split between the device's busy time and its idle share;
12. the node axis of ``stage_curv.cu`` (K6): N = 1, 2, 3 Cartesian nodes
   with their own coefficient rows and random six-face strips in one
   launch, bitwise equal to N one-node six-face launches, to the same
   launch on the per-cell body and to N padded launches of the same
   strips, and within 1e-12 (f64) / 1e-5 (f32) of
   ``stage_curv_batched_reference``;
13. the equal-shape AMR RHD cell (``inputs/disk_rhd_amr.in`` as written,
   its static patch included, at a 256x256x64 root, whose patch is
   256x256x64 too; float32): the main path through ``Simulation.run`` with
   every kernel count reset before and read after (K6 with N = 2 twice
   per cycle, fld_coeffs once per node per cycle, fld_matvec once per CG
   matvec of each node), zone-cycles/s over every zone of every level
   (20 cycles after 2 warm-up) and of the plain path, the root density L2
   deviation from the initial condition (<= 3e-4), K6's time per launch
   on the tiled and on the per-cell body, against two one-node six-face
   launches (K5b) and two padded launches (K4) with and without their
   ghost fill, all bitwise equal, fld_coeffs (K7) on each node on the
   tiled and the per-cell body against its bound, the tree
   stage's glue and the radiation pass per node, CG iterations per node,
   host read-backs per cycle and the device's idle share;
14. bench.py's production AMR shape (512x512x64 root over [-4, 4]^2 and a
   256x256x64 patch; the shapes differ, so one K5b launch per node):
   zone-cycles/s over every level, launch counts and the density L2 gate
   of bench.py:185 (run after phase 15: its tree, phase 26's tiled one
   and phase 25's straight AMR restart run are set up on a second thread
   while rad_shock's host-bound loop runs, the disk IC being numpy that
   releases the interpreter lock; likewise the kernel and plain sims of
   phases 11 and 13 are set up on two threads while nvcc builds the
   kernels in phase 2, and all are built before phase 3 starts);
15. rad_shock.in (1-D, float64) to t = 0.005 (``SHOCK_TLIM``) against
   the thresholds of tests/test_radiation.py's test_rad_shock; beside its host-bound,
   untimed loop a worker process runs on the card phase 30's small trees
   and the untimed checks of phase 23 (simple_drag, the other decks) and
   of phase 26 (blast_amr at numlevel 3), whose lines it prints after
   rad_shock's;
16. the six-face launch with alpha viscosity (K5a) at disk_sph's
   256x64x64 float32 with x3 ic: its launches through Simulation.run,
   every one on the tiled body, its time per launch on the tiled and on the
   per-cell body (bitwise equal, and to the padded halo) against the plain
   stage and the bound;
17. the flux sweep kernel (``csrc/sweep.cu``, K9) against
   ``sweep_reference`` on random padded states: d = 1, 2, 3 x {plm, pcm} x
   {float64 <= 1e-12, float32 <= 1e-5 abs} on a ragged 3-D and a 2-D
   shape, and its outputs against the tensor chain
   (``compute_fluxes(kernel=False)``) in shape, layout and value;
18. the strat cell (``inputs/strat.in`` at 256x128x512 float32, the
   shearing box on the composable path): the main path through
   ``Simulation.run`` with the sweep count reset before and read after (2
   stages x 3 directions per cycle), the equilibrium thresholds of
   tests/test_strat.py, zone-cycles/s of the kernel path (20 cycles after 2
   warm-up) and of the plain path, the kernel's time per launch in each
   direction against its plain version and bound, the cycle's device
   busy time and idle share, and the kernel and plain end states after the
   same 4 cycles;
19. ``inputs/ssheet.in`` at deck size (128x128 float64, point gravity,
   inflow x2) for 10 cycles: 2 sweep launches per stage, kernel and plain
   end states within 1e-10;
20. ``inputs/advection.in`` (gas on HLLC through the sweep, two dust
   species on HLLE): test_advection's N = 16 and 32 runs in float64 held to
   BASELINE's advection row, and the deck as written (128x64x64 float32):
   6 sweep launches per cycle and zone-cycles/s of both paths;
21. ``inputs/alpha_disk.in`` as written (512x1024 float64: cylindrical
   2-D, viscous x1 walls, alpha viscosity, point gravity, beta cooling) on
   the partial mode of the padded curvilinear stage (K4 on the tiled
   body; gravity and cooling run in the composable chain after it): the
   main path through ``Simulation.run`` with the launch counts reset
   before and read after (2 per cycle, every one partial and tiled),
   zone-cycles/s of the kernel path (20 cycles after 2 warm-up) and of the
   plain path, partial K4 per launch alone and with its viscous ghost fill
   on the tiled and on the per-cell body (the private switch) against the
   plain stage and the bound, the cycle's device busy time and idle share
   under torch.profiler split into K4, the viscous fill and the gravity +
   cooling chain, one partial launch on the deck's state against the plain
   version (float64 1e-12, float32 1e-4 abs) and bitwise against the
   per-cell body, the partial kernels' registers, and the kernel and plain
   end states after 5 cycles (1e-10 of each field's maximum);
22. ``inputs/binary_cyl.in`` at deck size (128x256 float64, 30 cycles,
   the twin of tests/test_binary.py's test_binary_smoke) on partial K4:
   launches (every one on the tiled body), finite state, positive density,
   the wake at the planet's radius, partial K4 against the plain version on
   the deck's state and bitwise against the per-cell body, and the kernel
   and plain end states;
23. ``inputs/simple_drag.in`` to t = 2 (the deck's tlim is 10) with
   tests/test_drag.py's thresholds (the plain chain: HLLE and dust);
   ``conduction.in`` and ``gaussian_bump.in`` for 50 cycles through the
   sweep kernel (K9, one launch per active direction per stage);
   ``blast.in`` for 50 cycles as
   written (HLLE: the driver gives a source-free Cartesian stage outside
   the Cartesian kernel's envelope to the padded curvilinear stage, K4)
   and with gas/riemann=hllc (the padded Cartesian stage, K2), both on the
   deck's outflow walls; each kernel path's end state against the plain
   path's;
24. the four N-body decks as written in float64 through
   ``Simulation.run`` (binary_nbody_cyl 128x256 for 40 cycles,
   disk_collision 128x256 and disk_nbody_cyl 96x192 on partial K4, cb_disk
   256x256 on the plain chain, its LLF solver outside every stage kernel;
   20 cycles each): per deck the stage kernel, its launches (counts set to
   0 before, read after; every partial launch on the tiled body), cycle
   ms, zone-cycles/s of the kernel and plain
   paths, the host time of the particle advance per stage, and the kernel
   and plain end states after 5 cycles (1e-10 of each field's maximum,
   particles 1e-12); binary_nbody_cyl: test_nbody_smoke's checks at cycle
   20, partial K4 against its plain stage on the deck's state (1e-12) and
   bitwise against the per-cell body, its time per launch on both bodies
   against the plain stage and the bound; every deck's
   device busy time and idle share under torch.profiler; disk_collision:
   its .reb file, the active particles' total mass conserved to 1e-12;
25. bitwise restarts: disk_sph at 256x64x64 float32 on K3 (10 cycles
   straight against 6 + checkpoint + 4, the dtden carry), binary_nbody_cyl
   on partial K4 with the nbody payload (10 against 6 + 4, its hdf5 dump
   read back by analysis/adump.py) and the equal-shape AMR RHD cell on
   K6/K7/K8 with the amr.* payloads (6 against 3 + 3): u, w, dtden, Er,
   every node, time, dt and the particles equal, each checkpoint's size and
   its write and load ms; then the CLI in a subprocess, ``-t`` with a tiny
   walltime exiting 2 with the walltime checkpoint and ``-r`` on it running
   to nlim with exit 0;
26. adaptive refinement: ``inputs/blast_amr.in`` as written (64x64 f64,
   tiled spawn/destroy, numlevel 2) to t = 0.1 through ``Simulation.run``
   with the stage count set to 0 before and read after: the padded
   curvilinear stage per node (K4) after every regrid, 2 launches per node
   a cycle, coverage growing, the pressure L2 against
   ``tests/data/sedov2d.dat`` < 1; the plain path over the first 50
   cycles (node rows equal to the kernel run's after every cycle, every
   node within 1e-10 of each array's max at cycle 50); the main run's
   checkpoint at cycle 20 resumed for 10 cycles, ``torch.equal`` to the
   main run at load and after; numlevel 3 to t = 0.05 (mass drift
   < 1e-8); then
   bench.py's tiled AMR disk RHD (512x512x64 f32 root over [-4, 4]^2,
   density magnitude criterion at 0.3, 64x64x32 tiles, a regrid every 25
   cycles): tiles, node shapes, the six-face stage per node (K5b), the
   batched radiation pass (K7 once a cycle for the root and once for each
   group of same-shape tiles on the node axis, K8 1 + the solve's CG
   iterations a Newton outer, checked from each pass's own counts), host
   reads a cycle, zone-cycles/s over every node's zones (25 cycles after 2
   warm-up, one regrid) and its ratio to the static production tree of
   phase 14, windows of cycles on the sequential and the batched pass, the
   device's idle share; the largest group on its own state: node-axis K7
   and K8 against their bounds, against as many one-node launches and the
   plain versions, K8 against a block-diagonal CSR SpMV, the stacking's
   cost, one pass batched against the sequential loop on a clone (every
   node's fields within 1e-4 of each array's max, CG counts equal); phase
   29's tables on the pool; one regrid's ms split into
   tags on the device, the mask copy, the set-up and a tile's
   prolongation, the mask bytes, peak device memory; and the same
   composition at 128x128x32 with 32x32x16 tiles, kernel against plain
   for 4 cycles with 2 regrids (rows equal, 1e-4 of each array's max);
27. the rest of refinement, float64, through ``Simulation(...,
   device="cuda")``: ``inputs/disk_cyl.in`` as written (128x64x32) with
   tests/test_amr_multilevel.py:99's static window (a cylindrical patch
   wrapping the full x2 axis, the composable tree) for 10 cycles, its
   first 2 against the port's CPU run of the same tree (1e-10 of each
   array's max), the root density L2 vs IC <= 6e-3, the fine level finite
   and positive, ms a cycle, zone-cycles/s over every level and the
   device's idle share; ``inputs/disk_nbody_cyl.in`` as written (96x192,
   the star and n4_sys.txt's four planets) with the inline planet's
   tracking patch, a retag every 2 cycles, 20 cycles that cross its first
   move (cycle 18), the positions, the particles (1e-12) and every node
   (1e-10) against the port's CPU run, ms a cycle and the idle share;
   ``inputs/advection.in`` as written (128x64x64, gas + 2 dust species)
   with a 64x32x32 static patch for 5 cycles: the gas of both nodes
   through the flux sweep (K9, 3 directions x 2 stages x 2 nodes a cycle,
   read from the launch count), every mass conserved to 1e-12 over cycles
   1-5, the end states within 1e-10 of the plain path's, zone-cycles/s;
   tests/test_amr.py's moving cylindrical blast (TwoLevelSMR) for two
   chunks of 5 cycles: the patch moves and the composite mass drifts
   <= 1e-12;
28. sharded single-level runs through ``Simulation(..., nshards=4,
   shard_devices=["cuda:0"] * 4)`` (four per-shard drivers on the one card,
   slab exchange): the flagship on x3 slabs of 256x256x32 for 6 cycles,
   K2 launched 4 times per stage on the tiled body and K1 never, its end
   state against phase 5's unsharded K1 run after the same cycles (bitwise
   or within 1e-5 abs, which is printed), then 10 timed cycles; disk_sph at
   256x64x64 f32 on x3 slabs for 4 cycles, K4 4 times per stage and K3
   never, against phase 7's unsharded K3 run after the same cycles (1e-4 of
   each field's scale), then 20 timed cycles and L2 vs IC <= 6e-3;
   rad_shock on x1 slabs for 30 cycles against phase 15's unsharded run at
   cycle 30 (1e-9 of each field's maximum); tests/test_parallel.py's 16^3
   N-body deck to t = 0.5 against its unsharded card run (gas 1e-11,
   particles 1e-12); the zone-cycles/s of both timed cells beside their
   unsharded rates and the share of the cycle that the exchanged fills
   take (recorded, not gated);
29. profiling (``artemis_tpu_torch.profiling``) on the sims of phases 7 and
   11 before they are freed: ``phase_table`` and ``kernel_table`` on
   disk_sph at 256x64x64 (K3) and on the RHD cell at 512x512x64 (K5b, K7,
   K8), both tables printed; every kernel_table row a kernel (none
   ``plain``) and each kernel's rows counting exactly the launches its
   wrapper's counter counted over the same cycles; each kernel's ms per
   launch printed beside the phase's own CUDA-event time (no gate);
30. sharded refinement trees (``parallel.amr.ShardedSMR``) through
   ``Simulation(..., nshards=4, shard_devices=["cuda:0"] * 4)``: the
   flagship box at 256x256x128 f32 with a 128^3-cell wrap patch (a 256^3
   fine node) on x3 slabs, and with a 128x128x64 patch distributed over the
   shards, each with the flux sweep (K9) launched 3 x 2 x 2 x 4 = 48 times
   a cycle (read from its counter over 4 cycles), its end state within
   1e-5 of each field's scale of the unsharded tree's on the card after 4
   cycles, and 10 timed cycles beside the unsharded tree's; disk_sph at
   256x64x64 f32 with a full-phi ring of 128x32x64 cells on phi slabs
   against its unsharded tree (1e-4), 10 cycles timed; then, in float64 at
   the tests' sizes, the distributed rad_shock tree, the disk_nbody_cyl
   tracking tree and the periodic-x3 blast_amr pool (the same tile set)
   against the port's CPU run of the same sharded case (1e-12), and a
   sharded checkpoint resumed bit for bit.

Each kernel's bound is the larger of its compulsory HBM traffic per launch
(every input read once, every output written once) over 3.35 TB/s and the
floating-point operations of its plain version on the same inputs (aten
add/sub/mul/div/pow/sqrt/rsqrt/reciprocal/exp/log elements, counted with a
dispatch mode) over 67 TFLOP/s float32, or 34 TFLOP/s for the float64
partial stage of phase 21 (the H100 SXM data sheet).  The SM
clock is printed beside the timings.  The line before the last is a JSON
object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(HERE, "inputs", "linwave.in")
DISK = {name: os.path.join(HERE, "inputs", f"{name}.in")
        for name in ("disk_sph", "disk_cyl", "disk_axi", "disk_rhd_amr")}
SHOCK = os.path.join(HERE, "inputs", "rad_shock.in")
# rad_shock's end time here (the test's is 0.02): the shock between the ic
# boundaries is steady by then, with the end states, the precursor and the
# smooth Trad of test_rad_shock's thresholds (490 cycles; its host-bound CG
# loop took 470-478 s on the H100 to t = 0.02)
SHOCK_TLIM = 0.005
DEVICE = "cuda"
F64_TOL = 1e-12
F32_TOL = 1e-5
DISK_F32_TOL = 1e-4
# the FLD kernels against their plain versions: max |kernel - plain| over
# max |plain| of each output
FLD_TOL = {"float64": 1e-12, "float32": 1e-5}
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SMOKE_LIMIT_S = 1200              # the whole script's time limit, the build included


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def smi_line(query="name,power.limit"):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def smi_clocks():
    """The card's SM clock (now and max), temperature and power draw: a
    compute-bound kernel's time scales with the clock it ran at."""
    return "clocks.sm, clocks.max.sm, temperature, power.draw: " + smi_line(
        "clocks.sm,clocks.max.sm,temperature.gpu,power.draw")


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
def phase_build(torch):
    """Build every kernel library, one nvcc per source and dtype variant,
    and the N-body package's native integrator (g++), all started
    together, so no timed run pays a build."""
    from artemis_tpu_torch import _build, nbody
    from artemis_tpu_torch.ops import stage_curv as SC

    builds = [("stage_cart", ()), ("fld", ()), ("sweep", ())] + [
        ("stage_curv", SC.build_defines(dt, full))
        for dt in (torch.float32, torch.float64) for full in (True, False)]

    def native():
        t1 = time.perf_counter()
        nbody._lib()
        return time.perf_counter() - t1

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        native_s = pool.submit(native)
        for f in [pool.submit(_build.load, name, d) for name, d in builds]:
            f.result()
        native_s = native_s.result()
    secs = time.perf_counter() - t0
    print(f"build: {len(builds)} nvcc runs and the N-body library (g++, {native_s:.1f} s) in "
          f"parallel, {secs:.1f} s")
    print("  stage_cart flags: " + " ".join((*_build.NVCC_FLAGS,
                                             *_build.SOURCE_FLAGS.get("stage_cart", ()))))
    for name, d in builds:
        log = _build.build_log.get(_build.variant(name, d), (0.0, ""))
        print(f"  {_build.variant(name, d)}: nvcc {log[0]:.1f} s")
        for line in log[1].splitlines():
            if "Compiling entry" in line or "Function properties" in line \
                    or "registers" in line or "spill" in line:
                print("    ptxas: " + line.strip())
    return secs


# -- bounds ----------------------------------------------------------------
# aten ops counted as one floating-point operation per output element
FLOP_OPS = {"add", "sub", "rsub", "mul", "div", "pow", "sqrt", "rsqrt", "reciprocal",
            "exp", "log"}


def count_flops(torch, fn):
    """Floating-point operations of ``fn()`` (a plain PyTorch version):
    the output elements of every FLOP_OPS aten op it dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.overloadpacket.__name__.rstrip("_") in FLOP_OPS
                    and isinstance(out, torch.Tensor) and out.is_floating_point()):
                Count.n += out.numel()
            return out

    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n


def bound(nbytes, flops, peak=None):
    """(bound_ms, bound_by): the larger of the HBM time and the arithmetic
    time at ``peak`` FLOP/s (default the float32 rate)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / (peak or F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# the gather launch's bodies in stage_curv.cu: a mangled-name piece of each
# f32 kernel (the tiled one without and with diffusion; the per-cell one
# with the gather halo, full mode)
KERNEL_ENTRIES = (("tiled", "stage_tiled_kernelIfLb0ELb1EE"),
                  ("per-cell", "stage_curv_kernelIfLb1ELb1EE"))
DIFF_KERNEL_ENTRIES = (("tiled diffusive", "stage_tiled_kernelIfLb1ELb1EE"),
                       ("per-cell", "stage_curv_kernelIfLb1ELb1EE"))
# the per-cell body's padded full-stage kernel (K4 through the private switch)
PADDED_PERCELL_ENTRY = (("per-cell padded", "stage_curv_kernelIfLb0ELb1EE"),)


# the Cartesian stage's two bodies in stage_cart.cu: a mangled-name piece of
# each f32 PLM kernel, periodic (K1) and padded (K2)
CART_ENTRIES = {periodic: (("tiled", f"stage_cart_tiled_kernelIfLi1ELb{periodic}EE"),
                           ("per-cell", f"stage_cart_kernelIfLi1ELb{periodic}EE"))
                for periodic in (1, 0)}


def ptxas_usage(torch, dtype, entry, source="stage_curv"):
    """(registers, spill store bytes, spill load bytes) that ptxas printed
    for the kernel of ``source`` (stage_curv: its full and partial builds
    for ``dtype``; any other source: its one build) whose mangled name
    holds ``entry``, from this process's build; None when it did not
    build."""
    import re

    from artemis_tpu_torch import _build
    from artemis_tpu_torch.ops import stage_curv as SC

    names = ([_build.variant("stage_curv", SC.build_defines(dtype, full))
              for full in (True, False)] if source == "stage_curv" else [source])
    logs = [_build.build_log.get(name) for name in names]
    cur = spill = None
    for line in "\n".join(log[1] for log in logs if log).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur, spill = m.group(1), None
        elif cur is not None and entry in cur:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and spill is None:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                return (int(m.group(1)),) + (spill or (0, 0))
    return None


def regs_text(regs):
    return "; ".join(f"{body} body " + (f"{r[0]} registers, spills {r[1]}/{r[2]} B st/ld"
                                         if r else "registers not read")
                     for body, r in regs.items())


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


# phase 3's shapes: ragged 3-D, 2-D, a short footprint with two z chunks
# (the second partial); and a periodic box narrower than PPM's halo
COMPARE_SHAPES = ((48, 20, 12), (40, 24, 1), (36, 10, 20))
NARROW = (24, 4, 4)


def phase_compare(torch):
    from artemis_tpu_torch.ops import stage as S

    worst = {torch.float64: 0.0, torch.float32: 0.0}
    ncase = 0
    cases = [(shape, bc, recon) for shape in COMPARE_SHAPES
             for bc in ("periodic", "outflow", "reflecting") for recon in ("pcm", "plm", "ppm")]
    cases += [(NARROW, "periodic", recon) for recon in ("pcm", "plm", "ppm")]
    for shape, bc, recon in cases:
        for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
            hyd, u, w = setup_state(torch, *shape, recon, bc, 3 if recon == "ppm" else 2, dtype)
            u1 = u * 1.0
            dt = torch.full((), 2e-3, dtype=dtype, device=DEVICE)
            for gam0, gam1, beta in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
                t0 = S.tiled_launches
                uk, wk, dk = S.stage(hyd, w, u, u1, gam0, gam1, beta, dt, False)
                with S._percell_body():
                    uc, wc, dc = S.stage(hyd, w, u, u1, gam0, gam1, beta, dt, False)
                torch.cuda.synchronize()
                check(S.tiled_launches == t0 + 1, "a stage launch did not take the tiled body")
                check(same_stage(torch, (uk, wk, dk), (uc, wc, dc)),
                      f"tiled vs per-cell body {shape} {bc} {recon} {dtype} gam0={gam0}: "
                      "not bitwise equal")
                ur, wr, dr = S.stage_reference(hyd, w, u, u1, gam0, gam1, beta, dt, False)
                torch.cuda.synchronize()
                err = max(float((uk - ur).abs().max()), float((wk - wr).abs().max()))
                derr = float((dk.max() - dr.max()).abs() / dr.max())
                check(err <= tol and derr <= tol,
                      f"kernel vs plain {shape} {bc} {recon} {dtype} gam0={gam0}: "
                      f"max|du|,|dw| = {err:.3e}, dtden rel {derr:.3e} > {tol:g}")
                worst[dtype] = max(worst[dtype], err)
                ncase += 1
    print(f"compare: {ncase} kernel-vs-plain cases pass, each on the tiled body and bitwise "
          f"equal to the per-cell body; max abs err f64 {worst[torch.float64]:.3e} "
          f"(tol {F64_TOL:g}), f32 {worst[torch.float32]:.3e} (tol {F32_TOL:g})")
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
                S.stage_launches = S.tiled_launches = 0
                sim.run()
                torch.cuda.synchronize()
                check(S.stage_launches == 2 * sim.tm.ncycle == S.tiled_launches,
                      f"linwave N={res} {wave}: {S.stage_launches} launches "
                      f"({S.tiled_launches} on the tiled body) for {sim.tm.ncycle} rk2 cycles")
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


def flagship_sim(dtype, data, fused=True, extra=(), **kw):
    from artemis_tpu_torch import Simulation

    nx, ny, nz = FLAGSHIP
    args = [f"parthenon/mesh/nx1={nx}", f"parthenon/mesh/nx2={ny}",
            f"parthenon/mesh/nx3={nz}", "parthenon/mesh/nghost=2",
            "problem/amp=1.0e-3", "gas/reconstruct=plm", "gas/riemann=hllc",
            "parthenon/time/integrator=rk2", f"artemis/precision={dtype}", *extra]
    return Simulation(DECK, args, data, device=DEVICE, fused_stage=fused, **kw)


def warm_up(sim, ncycles):
    """Advance through the user entry point (Simulation.run, which adds
    the problem's outputs around the same loop)."""
    sim.tm.nlim = sim.tm.ncycle + ncycles
    sim.run()
    check(sim.status == "complete" and sim.tm.ncycle == sim.tm.nlim,
          f"run stopped at cycle {sim.tm.ncycle}, wanted {sim.tm.nlim}")


def run_cycles(torch, sim, ncycles, observers=None):
    """Advance ``ncycles`` through the evolution loop that Simulation.run
    drives, timed by CUDA events; returns zone-cycles/s."""
    from artemis_tpu_torch.driver import evolve

    sim.tm.nlim = sim.tm.ncycle + ncycles
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sim.state, sim.tm, _, status = evolve(sim.driver, sim.state, sim.tm, observers=observers)
    end.record()
    torch.cuda.synchronize()
    check(status == "complete" and sim.tm.ncycle == sim.tm.nlim,
          f"run stopped at cycle {sim.tm.ncycle}, wanted {sim.tm.nlim}")
    secs = start.elapsed_time(end) / 1e3
    return sim.grid.nx[0] * sim.grid.nx[1] * sim.grid.nx[2] * ncycles / secs


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
        S.stage_launches = S.tiled_launches = 0
        warm_up(sim, 2)
        res["kernel_zcps"] = run_cycles(torch, sim, 20)
        launches = S.stage_launches
        check(launches == 2 * sim.tm.ncycle == S.tiled_launches,
              f"flagship: {launches} launches ({S.tiled_launches} on the tiled body) for "
              f"{sim.tm.ncycle} rk2 cycles")
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
        with S._percell_body():
            res["percell_ms"] = time_launches(torch, kern, 10)
        res["plain_ms"] = time_launches(torch, plain, 4)
        res["regs"] = {body: ptxas_usage(torch, torch.float32, entry, "stage_cart")
                       for body, entry in CART_ENTRIES[1]}
        for g in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
            ot = S.stage(hyd, w, u, u1, *g, dt, False)
            with S._percell_body():
                oc = S.stage(hyd, w, u, u1, *g, dt, False)
            torch.cuda.synchronize()
            check(same_stage(torch, ot, oc),
                  f"flagship K1 gam0={g[0]}: tiled and per-cell bodies differ")
        del ot, oc
        print(f"flagship f32 per stage launch (K1): kernel on the tiled body {res['ms']:.4f} ms, "
              f"on the per-cell body {res['percell_ms']:.4f} ms "
              f"({res['percell_ms'] / res['ms']:.2f}x), plain {res['plain_ms']:.4f} ms; tiled == "
              f"per-cell bitwise at {FLAGSHIP}; {regs_text(res['regs'])} [{smi}]")
        print("  " + smi_clocks())
        cycle_ms = 1e3 * FLAGSHIP[0] * FLAGSHIP[1] * FLAGSHIP[2] / res["kernel_zcps"]
        print(f"flagship f32 cycle (unprofiled): {cycle_ms:.4f} ms, of which 2 kernel launches "
              f"{2 * res['ms']:.4f} ms ({100 * (1 - 2 * res['ms'] / cycle_ms):.1f}% other)")
        res["profile"] = profile_cycles(torch, sim, 3)
        res["idle_share"] = (1.0 - res["profile"]["busy_ms"] / cycle_ms
                             if res["profile"] else None)
        print("flagship f32 device idle "
              + (f"{100 * res['idle_share']:.1f}% of the unprofiled cycle (busy "
                 f"{res['profile']['busy_ms']:.4f} ms)" if res["idle_share"] is not None
                 else "not measured"))
        # the bound of the same two launches: stage 1 reads w and u1,
        # stage 2 w, u0 and u1; both write u, w and the dtden blocks
        nblk = S.dtden_blocks(*FLAGSHIP, torch.float32)
        nbytes = (tensor_bytes(w, u1, w, u, u1)
                  + 2 * (tensor_bytes(u, w) + nblk * u.element_size())) / 2
        flops = sum(count_flops(torch, lambda g=g: S.stage_reference(
            hyd, w, u, u1, *g, dt, False)) for g in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5))) / 2
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
        print(f"flagship f32 stage bound: {nbytes / 1e6:.1f} MB and {flops / 1e9:.3f} GFLOP "
              f"per launch (plain version's count) -> {res['bound_ms']:.4f} ms, "
              f"{res['bound_by']}-bound")
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
        padded = (lambda: S._launch(hyd, w_pad, u, u1, 0.5, 0.5, 0.5, dt, False,
                                    periodic=False))
        filled = lambda: S.stage(hyd, w, u, u1, 0.5, 0.5, 0.5, dt, False)  # noqa: E731
        res["padded_ms"] = time_launches(torch, padded, 20)
        res["padded_stage_ms"] = time_launches(torch, filled, 20)
        with S._percell_body():
            res["padded_percell_ms"] = time_launches(torch, padded, 10)
            res["padded_percell_stage_ms"] = time_launches(torch, filled, 10)
        res["padded_plain_ms"] = time_launches(
            torch, lambda: S.stage_reference(hyd, w, u, u1, 0.5, 0.5, 0.5, dt, False), 4)
        res["padded_regs"] = {body: ptxas_usage(torch, torch.float32, entry, "stage_cart")
                              for body, entry in CART_ENTRIES[0]}
        ot = padded()
        with S._percell_body():
            oc = padded()
        torch.cuda.synchronize()
        check(same_stage(torch, ot, oc), "flagship K2: tiled and per-cell bodies differ")
        del ot, oc
        uk, wk, _ = S.stage(hyd, w, u, u1, 0.5, 0.5, 0.5, dt, False)
        ur, wr, _ = S.stage_reference(hyd, w, u, u1, 0.5, 0.5, 0.5, dt, False)
        err = max(float((uk - ur).abs().max()), float((wk - wr).abs().max()))
        check(err <= F32_TOL, f"flagship padded stage kernel vs plain: {err:.3e} > {F32_TOL:g}")
        res["flagship_stage_err"] = max(res["flagship_stage_err"], err)
        print(f"flagship f32 padded halo (outflow) per stage (K2): kernel on the tiled body "
              f"{res['padded_ms']:.4f} ms, with ghost fill {res['padded_stage_ms']:.4f} ms; on "
              f"the per-cell body {res['padded_percell_ms']:.4f} ms, with ghost fill "
              f"{res['padded_percell_stage_ms']:.4f} ms; plain {res['padded_plain_ms']:.4f} ms; "
              f"tiled == per-cell bitwise; {regs_text(res['padded_regs'])} [{smi}]")
        # its bound (stage 2: padded prims, u0 and u1 in; u, w, dtden out)
        nblk = S.dtden_blocks(*FLAGSHIP, torch.float32)
        res["padded_bound_ms"], res["padded_bound_by"] = bound(
            tensor_bytes(w_pad, u, u1, u, w) + nblk * u.element_size(),
            count_flops(torch, lambda: S.stage_reference(hyd, w, u, u1, 0.5, 0.5, 0.5, dt,
                                                         False)))
        print(f"flagship f32 padded halo bound: {res['padded_bound_ms']:.4f} ms, "
              f"{res['padded_bound_by']}-bound")
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
        # phase 28 holds the sharded flagship to this state
        res["shard_ref"] = shard_ref(ksim)
        del plain_sim, ksim
        torch.cuda.empty_cache()

        # one float64 kernel run
        sim64 = flagship_sim("float64", data)
        warm_up(sim64, 2)
        res["kernel_f64_zcps"] = run_cycles(torch, sim64, 10)
        check(bool(torch.isfinite(sim64.state["gas"]["u"]).all()), "f64 flagship not finite")
        u, w = sim64.state["gas"]["u"], sim64.state["gas"]["w"]
        u1, hyd = u.clone(), sim64.driver.hydro
        dt = torch.full((), sim64.tm.dt, dtype=u.dtype, device=DEVICE)
        res["f64_ms"] = time_launches(torch, kern, 10)
        with S._percell_body():
            res["f64_percell_ms"] = time_launches(torch, kern, 10)
        # the f32 launch's bytes in 8-byte words, its flops at the f64 rate
        nblk = S.dtden_blocks(*FLAGSHIP, torch.float64)
        nbytes = (tensor_bytes(w, u1, w, u, u1)
                  + 2 * (tensor_bytes(u, w) + nblk * u.element_size())) / 2
        res["f64_bound_ms"], res["f64_bound_by"] = bound(nbytes, flops, F64_FLOPS)
        print(f"flagship f64 kernel path: 10 cycles, {res['kernel_f64_zcps']:.6e} "
              f"zone-cycles/s; K1 per f64 launch on the tiled body {res['f64_ms']:.4f} ms, on "
              f"the per-cell body {res['f64_percell_ms']:.4f} ms; bound "
              f"{res['f64_bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB, {res['f64_bound_by']}-"
              f"bound) [{smi}]")
        del u, w, u1, hyd
        del sim64
        torch.cuda.empty_cache()
    return res


# -- phase 6 -------------------------------------------------------------
CURV_MESHES = {
    "cylindrical": "x1min=0.4 x1max=2.0 x2min=-3.14159 x2max=3.14159 x3min=-0.3 x3max=0.3",
    "cartesian": "x1min=-2.0 x1max=2.0 x2min=-1.0 x2max=1.0 x3min=-0.25 x3max=0.25",
    "spherical": "x1min=0.4 x1max=2.0 x2min=0.8 x2max=2.3 x3min=-3.14159 x3max=3.14159",
    "axisymmetric": "x1min=0.4 x1max=2.0 x2min=-0.6 x2max=0.6 x3min=-3.14 x3max=3.14",
}
# coords -> (viscosity, conduction, gravity, rotating frame): the variants
# each grid's padded-halo cases carry (Cartesian grids fold no diffusion)
CURV_VARIANTS = {
    "cylindrical": [("plaw", "cond", True, True), (None, None, False, False)],
    "spherical": [("alpha", None, True, True), ("plaw_harm", "tdiff", False, False)],
    "axisymmetric": [("alpha", None, True, True), (None, "tdiff", False, False)],
    "cartesian": [(None, None, True, False)],
}


def diff_params():
    from artemis_tpu_torch.ops.diffusion import DiffParams

    visc = {"plaw": DiffParams(kind="viscosity_plaw", nu_s=2.0e-3, eta=0.2, r_exp=0.5),
            "alpha": DiffParams(kind="viscosity_alpha", alpha=1.0e-3),
            "plaw_harm": DiffParams(kind="viscosity_plaw", avg="harmonic", nu_s=2.0e-3,
                                    eta=1.5)}
    cond = {"cond": DiffParams(kind="conductivity_plaw", hcond_0=1.0e-3, temp_exp=0.5,
                               rho_exp=0.3),
            "tdiff": DiffParams(kind="thermaldiff_plaw", avg="harmonic", kappa_0=1.0e-3,
                                temp_exp=0.4, T0=1.2)}
    return visc, cond


def curv_case(torch, coords, rsolver, recon, dtype, visc, cond, grav, rf, full, box=None,
              seed=2):
    """A CurvStage on a random smooth state (as tests/test_pallas_curv.py
    makes it) on a ragged 20x12x6 grid (20x12 axisymmetric), outflow x1/x2,
    periodic x3; ``box`` replaces the coordinates' default bounds."""
    import numpy as np

    from artemis_tpu_torch.config import ParameterInput
    from artemis_tpu_torch.driver import curv_point_grav
    from artemis_tpu_torch.grid import grid_from_input
    from artemis_tpu_torch.ops import stage_curv as SC
    from artemis_tpu_torch.ops.diffusion import Diffusion
    from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro
    from artemis_tpu_torch.sources import Gravity, RotatingFrame
    from artemis_tpu_torch.units import Constants, Units

    nx3 = 1 if coords == "axisymmetric" else 6
    mesh = (box or CURV_MESHES[coords]).split() + ["nx1=20", "nx2=12", f"nx3={nx3}",
                                                   "nghost=2"]
    pin = ParameterInput.from_string(
        f"<artemis>\ncoordinates = {coords}\n<parthenon/mesh>\n" + "\n".join(mesh)
        + "\nix1_bc = outflow\nox1_bc = outflow\nix2_bc = outflow\nox2_bc = outflow\n"
        "ix3_bc = periodic\nox3_bc = periodic\n<rotating_frame>\nomega = 1.0\n"
        "<gravity/point>\nmass = 1.0\nsoft = 0.05\n"
        + ("x = 0.3\ny = -0.2\nz = 0.1\n" if coords == "cartesian" else ""))
    grid = grid_from_input(pin)
    cfg = FluidCfg(fluid="gas", recon=recon, rsolver=rsolver, gamma=1.4, cfl=0.3)
    hyd = Hydro(grid, cfg, device=DEVICE, dtype=dtype)
    nz, ny, nx = tuple(reversed(grid.nx))
    rng = np.random.default_rng(seed)
    w = np.empty((1, 6, nz, ny, nx))
    w[:, 0] = 1 + 0.2 * rng.random((nz, ny, nx))
    w[:, 1:4] = 0.3 * (rng.random((1, 3, nz, ny, nx)) - 0.5)
    w[:, 5] = 1 + 0.2 * rng.random((nz, ny, nx))
    w[:, 4] = 0.4 * w[:, 0] * w[:, 5]
    u, w = hyd.prim_to_cons(torch.as_tensor(w, dtype=dtype, device=DEVICE), cfg)
    gsrc = Gravity(pin, grid, Constants.from_units(Units.from_input(pin))).place(DEVICE, dtype)
    vp, cp = diff_params()
    diff = (Diffusion(grid, hyd, cfg, vp.get(visc), cp.get(cond))
            if visc or cond else None)
    cs = SC.CurvStage(hyd, omf=1.0 if rf else 0.0,
                      rotating=RotatingFrame(pin, grid).place(DEVICE, dtype) if rf else None,
                      gravity=gsrc if grav else None,
                      gmode=curv_point_grav(grid, gsrc) if grav else None,
                      diffusion=diff, full=full)
    return cs, w, u


def disk_setup(torch, dtype, nx, data, fused=True, extra=(), **kw):
    """disk_sph through the user entry point at ``nx``."""
    from artemis_tpu_torch import Simulation

    args = [f"parthenon/mesh/nx1={nx[0]}", f"parthenon/mesh/nx2={nx[1]}",
            f"parthenon/mesh/nx3={nx[2]}", f"artemis/precision={dtype}", *extra]
    return Simulation(DISK["disk_sph"], args, data, device=DEVICE, fused_stage=fused, **kw)


def compare_curv(torch, cs, w, u, tol, padded=False):
    """Kernel vs plain version for both RK register patterns; returns the
    worst abs error and the kernel's outputs of the second pattern."""
    from artemis_tpu_torch.ops import stage_curv as SC

    dt = torch.full((), 2e-3, dtype=u.dtype, device=DEVICE)
    worst, out = 0.0, None
    for gam0, gam1, beta in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5)):
        out = SC.stage_curv(cs, w, u, u.clone(), gam0, gam1, beta, dt, 0.0, False,
                            padded=padded)
        torch.cuda.synchronize()
        ur, wr, dr = SC.stage_curv_reference(cs, w, u, u.clone(), gam0, gam1, beta, dt,
                                             0.0, False)
        err = max(float((out[0] - ur).abs().max()), float((out[1] - wr).abs().max()))
        derr = float((out[2].max() - dr.max()).abs() / dr.max()) if cs.full else 0.0
        check(err <= tol and derr <= tol and bool(torch.isfinite(out[0]).all()),
              f"stage_curv kernel vs plain ({cs.grid.coords}, padded={padded}, "
              f"full={cs.full}, gam0={gam0}): max abs {err:.3e}, dtden rel {derr:.3e} "
              f"> {tol:g}")
        worst = max(worst, err)
    return worst, out


def same_stage(torch, a, b):
    """Two launches' (u, w, dtden) bitwise equal: u and w, and the dtden
    maxima (the tiled and per-cell bodies have different block counts)."""
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2].amax(), b[2].amax()))


def phase_curv_compare(torch):
    worst = {torch.float64: 0.0, torch.float32: 0.0}
    ncase = 0
    for coords, variants in CURV_VARIANTS.items():
        for visc, cond, grav, rf in variants:
            for scheme in ("hllc-plm", "hlle-plm", "hllc-pcm", "hlle-pcm"):
                rsolver, recon = scheme.split("-")
                for full in (True, False):
                    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
                        cs, w, u = curv_case(torch, coords, rsolver, recon, dtype, visc,
                                             cond, grav, rf, full)
                        err, _ = compare_curv(torch, cs, w, u, tol, padded=True)
                        worst[dtype] = max(worst[dtype], err)
                        ncase += 2
    print(f"curv compare: {ncase} padded-halo kernel-vs-plain cases pass; max abs err "
          f"f64 {worst[torch.float64]:.3e} (tol {F64_TOL:g}), "
          f"f32 {worst[torch.float32]:.3e} (tol {F32_TOL:g})")
    # the disk layout: gather and padded halo sources, bitwise equal
    from artemis_tpu_torch.driver import curv_point_grav
    from artemis_tpu_torch.ops import stage_curv as SC
    from artemis_tpu_torch.sources import Gravity, RotatingFrame

    disk_worst = {}
    with tempfile.TemporaryDirectory() as data:
        for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, DISK_F32_TOL)):
            for full in (True, False):
                for scheme in ("hlle-plm", "hllc-plm", "hlle-pcm", "hllc-pcm"):
                    rsolver, recon = scheme.split("-")
                    sim = disk_setup(torch, str(dtype).removeprefix("torch."), (20, 12, 6),
                                     data, fused=False,
                                     extra=["parthenon/mesh/x1min=0.4", "parthenon/mesh/x1max=2.4",
                                            f"gas/riemann={rsolver}",
                                            f"gas/reconstruct={recon}"])
                    d = sim.driver
                    grav = [s_ for s_ in d.sources if isinstance(s_, Gravity)][0]
                    rf = [s_ for s_ in d.sources if isinstance(s_, RotatingFrame)][0]
                    strips = SC.prepare_gather_strips(sim.grid,
                                                      d.bc_custom["ic"].shard_caches[0])
                    cs = SC.CurvStage(d.hydro, omf=d.omf, rotating=rf, gravity=grav,
                                      gmode=curv_point_grav(sim.grid, grav),
                                      diffusion=d.diffusion, full=full, strips=strips,
                                      bc_custom=d.bc_custom)
                    w, u = sim.state["gas"]["w"], sim.state["gas"]["u"]
                    check(cs.tiled("gather") and cs.tiled("padded"),
                          f"disk layout full={full}: a launch off the tiled body")
                    eg, og = compare_curv(torch, cs, w, u, tol)
                    ep, op = compare_curv(torch, cs, w, u, tol, padded=True)
                    check(same_stage(torch, og, op),
                          f"disk layout {dtype} full={full} {scheme}: gather and padded halo "
                          "sources differ")
                    disk_worst[dtype] = max(disk_worst.get(dtype, 0.0), eg, ep)
                    ncase += 4
                    # the tiled viscous body against the per-cell one
                    with SC._percell_body():
                        ec, oc = compare_curv(torch, cs, w, u, tol)
                    check(same_stage(torch, og, oc),
                          f"disk layout {dtype} full={full} {scheme}: tiled and per-cell "
                          "bodies differ")
                    disk_worst[dtype] = max(disk_worst[dtype], ec)
                    ncase += 2
    print(f"curv compare: disk_sph layout (K3 with alpha viscosity), gather == padded "
          f"bitwise, and on full and partial stages the tiled body == the per-cell body "
          f"bitwise; max abs "
          f"err f64 {disk_worst[torch.float64]:.3e} (tol {F64_TOL:g}), f32 "
          f"{disk_worst[torch.float32]:.3e} (tol {DISK_F32_TOL:g}); {ncase} cases in all")
    return worst[torch.float64], worst[torch.float32], disk_worst[torch.float32]


# -- phase 7 -------------------------------------------------------------
DISK_BENCH = (256, 64, 64)


def padded_timings(torch, cs, w, u, u1, dt, tnow):
    """K4 on this state: a full padded launch per RK stage alone
    (``padded_ms``, 20 timed) and with the stage's ghost fill
    (``padded_stage_ms``, the main path's call for a padded halo) on the
    tiled body, the same on the per-cell body (10 each), the fill's share
    of the tiled padded stage, and the bound of one padded launch averaged
    over the two RK stages (the padded prims, rows and registers read
    once, u, w and dtden written once; the plain version's flops)."""
    from artemis_tpu_torch import bc as bc_mod
    from artemis_tpu_torch.ops import stage_curv as SC

    check(cs.tiled("padded"), "the full padded launch does not take the tiled body")
    w_pad = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)
    calls = itertools.cycle(RK2)

    def kern():
        return SC._launch(cs, w_pad, w, u, u1, *next(calls), dt, tnow, False, "padded")

    def stage():
        return SC.stage_curv(cs, w, u, u1, *next(calls), dt, tnow, False, padded=True)

    out = {"padded_ms": time_launches(torch, kern, 20),
           "padded_stage_ms": time_launches(torch, stage, 20)}
    with SC._percell_body():
        out["padded_percell_ms"] = time_launches(torch, kern, 10)
        out["padded_percell_stage_ms"] = time_launches(torch, stage, 10)
    out["padded_fill_share"] = 1.0 - out["padded_ms"] / out["padded_stage_ms"]
    nblk = cs.dtden_blocks(True)
    nbytes = (2 * tensor_bytes(w_pad, *cs.rows) + tensor_bytes(u1, u, u1)
              + 2 * (tensor_bytes(u, w) + nblk * u.element_size())) / 2
    flops = sum(count_flops(torch, lambda g=g: SC.stage_curv_reference(
        cs, w, u, u1, *g, dt, tnow, False, w_pad=w_pad)) for g in RK2) / 2
    out["padded_bound_ms"], out["padded_bound_by"] = bound(nbytes, flops)
    return out


def l2_vs_ic(torch, sim):
    import numpy as np

    d0 = np.asarray(sim.problem.prims["gas"][0][0], dtype=np.float64)
    d = sim.state["gas"]["w"][0, 0].double().cpu().numpy()
    return float(np.sqrt((d0 * (d - d0) ** 2).sum()) / d0.sum())


def profile_cycles(torch, sim, ncycles):
    """Device busy time per cycle by kernel over ``ncycles`` of the
    evolution loop under torch.profiler; None when it records no device
    time.  Only the device's own events count (an aten operator's row
    repeats the time of the kernels it launched).  The profiler slows the
    host, so the idle share comes from the unprofiled cycle time instead
    (``idle_share``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from artemis_tpu_torch.driver import evolve

    sim.tm.nlim = sim.tm.ncycle + ncycles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.state, sim.tm, _, _ = evolve(sim.driver, sim.state, sim.tm)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ncycles
    rows = [(e.key, e.self_device_time_total / 1e3 / ncycles)
            for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    rows = sorted([r for r in rows if r[1] > 0], key=lambda r: -r[1])
    if not rows:
        print("profile: no device time recorded (not measured)")
        return None
    busy = sum(t for _, t in rows)
    print(f"profile ({ncycles} cycles under torch.profiler, whose own host cost "
          f"stretches the cycle to {wall_ms:.3f} ms): device busy {busy:.3f} ms per cycle; "
          "by kernel per cycle:")
    for key, t in rows[:5]:
        print(f"    {t:.4f} ms  {key[:100]}")
    return {"cycle_ms": wall_ms, "busy_ms": busy, "top": rows[:5]}


def tiled_vs_percell(torch, cs, kern, w, u, u1, dt, tnow):
    """A full gather stage's launch on the tiled body (``kern``, 20 timed)
    and on the per-cell body (10), the two and the padded halo (K4, on the
    tiled and on the per-cell body) checked bitwise equal on this state,
    and ptxas's registers and spills of the diffusive tiled kernel and the
    per-cell one: ms, percell_ms, regs."""
    from artemis_tpu_torch.ops import stage_curv as SC

    check(cs.tiled(cs.halo), f"the {cs.halo} launch does not take the tiled body")
    out = {"ms": time_launches(torch, kern, 20)}
    with SC._percell_body():
        out["percell_ms"] = time_launches(torch, kern, 10)
    og = SC.stage_curv(cs, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False)
    with SC._percell_body():
        oc = SC.stage_curv(cs, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False)
    op = SC.stage_curv(cs, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False, padded=True)
    with SC._percell_body():
        opc = SC.stage_curv(cs, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False, padded=True)
    torch.cuda.synchronize()
    check(same_stage(torch, og, oc), f"{cs.halo} at full size: tiled and per-cell bodies differ")
    check(same_stage(torch, og, op), f"{cs.halo} at full size: gather and padded halo differ")
    check(same_stage(torch, op, opc),
          f"{cs.halo} state at full size: the padded halo on the tiled and the per-cell body "
          "differ")
    out["regs"] = {body: ptxas_usage(torch, u.dtype, entry) for body, entry in DIFF_KERNEL_ENTRIES}
    return out


def phase_disk(torch, smi):
    from artemis_tpu_torch.ops import stage_curv as SC

    res = {}
    with tempfile.TemporaryDirectory() as data:
        # the main path: 2 warm-up + 50 timed cycles, counting launches
        sim = disk_setup(torch, "float32", DISK_BENCH, data)
        check(sim.driver.stage_kernel == "stage_curv (gather)",
              f"disk_sph took {sim.driver.stage_kernel}, not the gather kernel")
        SC.stage_curv_launches = SC.tiled_launches = 0
        warm_up(sim, 2)
        res["kernel_zcps"] = run_cycles(torch, sim, 50)
        launches = SC.stage_curv_launches
        check(launches == 2 * sim.tm.ncycle and SC.tiled_launches == launches,
              f"disk_sph: {launches} launches ({SC.tiled_launches} on the tiled body) for "
              f"{sim.tm.ncycle} rk2 cycles")
        res["launches"] = launches
        res["l2"] = l2_vs_ic(torch, sim)
        u, w = sim.state["gas"]["u"], sim.state["gas"]["w"]
        check(bool(torch.isfinite(u).all()) and bool(torch.isfinite(w).all())
              and res["l2"] <= 6e-3,
              f"disk_sph f32 after {sim.tm.ncycle} cycles: L2 vs IC {res['l2']:.3e} > 6e-3 "
              "or not finite")
        print(f"disk_sph f32 kernel path: 50 cycles, {res['kernel_zcps']:.6e} zone-cycles/s, "
              f"{launches} launches for {sim.tm.ncycle} cycles, every one on the tiled body, "
              f"dt {sim.tm.dt:.6e}, L2 vs IC {res['l2']:.3e} (gate 6e-3) [{smi}]")

        # per-launch kernel and plain stage times on this state
        cs = sim.driver._curv
        u1 = u.clone()
        dt = torch.full((), sim.tm.dt, dtype=u.dtype, device=DEVICE)
        time_now = sim.tm.time
        calls = itertools.cycle([(0.0, 1.0, 1.0), (0.5, 0.5, 0.5)])  # rk2 stages 1, 2

        def kern():
            g0, g1, b = next(calls)
            return SC.stage_curv(cs, w, u, u1, g0, g1, b, dt, time_now, False)

        def plain():
            g0, g1, b = next(calls)
            return SC.stage_curv_reference(cs, w, u, u1, g0, g1, b, dt, time_now, False)

        res.update(tiled_vs_percell(torch, cs, kern, w, u, u1, dt, time_now))
        res["plain_ms"] = time_launches(torch, plain, 4)
        print(f"disk_sph f32 per stage launch (K3): kernel on the tiled body {res['ms']:.4f} ms, "
              f"on the per-cell body {res['percell_ms']:.4f} ms "
              f"({res['percell_ms'] / res['ms']:.2f}x), plain {res['plain_ms']:.4f} ms; tiled == "
              f"per-cell == padded bitwise at {DISK_BENCH}; {regs_text(res['regs'])} [{smi}]")
        print("  " + smi_clocks())
        res["profile"] = profile_cycles(torch, sim, 3)
        cycle_ms = 1e3 * DISK_BENCH[0] * DISK_BENCH[1] * DISK_BENCH[2] / res["kernel_zcps"]
        res["idle_share"] = 1.0 - 2 * res["ms"] / cycle_ms
        print(f"disk_sph f32 cycle (unprofiled): {cycle_ms:.4f} ms, of which 2 kernel launches "
              f"{2 * res['ms']:.4f} ms; the rest, {100 * res['idle_share']:.1f}%, is the device "
              "waiting on the host loop (dt read-back and the next launches)")
        nblk = cs.dtden_blocks(True)
        strips = tensor_bytes(*cs.strips.values(), *cs.rows)
        nbytes = (tensor_bytes(w, u1, w, u, u1) + 2 * strips
                  + 2 * (tensor_bytes(u, w) + nblk * u.element_size())) / 2
        flops = sum(count_flops(torch, lambda g=g: SC.stage_curv_reference(
            cs, w, u, u1, *g, dt, time_now, False)) for g in ((0.0, 1.0, 1.0),
                                                               (0.5, 0.5, 0.5))) / 2
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
        print(f"disk_sph f32 stage bound: {nbytes / 1e6:.1f} MB and {flops / 1e9:.3f} GFLOP "
              f"per launch (plain version's count) -> {res['bound_ms']:.4f} ms, "
              f"{res['bound_by']}-bound")
        # the padded-halo variant (K4) on the same state: the kernel alone
        # on the padded prims, and with the disk's ghost fill, on the tiled
        # body (every full padded launch's) and on the per-cell body
        res.update(padded_timings(torch, cs, w, u, u1, dt, time_now))
        print(f"disk_sph f32 padded halo (K4) per stage: kernel on the tiled body "
              f"{res['padded_ms']:.4f} ms, with the ic ghost fill {res['padded_stage_ms']:.4f} "
              f"ms (the fill {100 * res['padded_fill_share']:.1f}% of it); on the per-cell body "
              f"{res['padded_percell_ms']:.4f} ms, {res['padded_percell_stage_ms']:.4f} ms with "
              f"the fill; bound {res['padded_bound_ms']:.4f} ms, {res['padded_bound_by']}-bound; "
              f"the padded launch runs the tiled diffusive instantiation above (the halo source "
              f"is a runtime switch) [{smi}]")
        uk, wk, _ = SC.stage_curv(cs, w, u, u1, 0.5, 0.5, 0.5, dt, time_now, False)
        ur, wr, _ = SC.stage_curv_reference(cs, w, u, u1, 0.5, 0.5, 0.5, dt, time_now, False)
        res["stage_err"] = max(float((uk - ur).abs().max()), float((wk - wr).abs().max()))
        check(res["stage_err"] <= DISK_F32_TOL,
              f"disk_sph stage kernel vs plain: {res['stage_err']:.3e} > {DISK_F32_TOL:g}")
        del sim, cs, u, w, u1, uk, wk, ur, wr
        torch.cuda.empty_cache()

        # the plain path through the same entry point, and the kernel path
        # over the same cycles for an end-state comparison
        plain_sim = disk_setup(torch, "float32", DISK_BENCH, data, fused=False)
        check(plain_sim.driver.stage_kernel == "none", "plain disk run took a kernel")
        warm_up(plain_sim, 1)
        res["plain_zcps"] = run_cycles(torch, plain_sim, 3)
        print(f"disk_sph f32 plain path: 3 cycles, {res['plain_zcps']:.6e} zone-cycles/s "
              f"[{smi}]")
        ksim = disk_setup(torch, "float32", DISK_BENCH, data)
        warm_up(ksim, 4)
        # the two fold their sources in other orders and reduce dtden in
        # other orders (dt differs in the 7th digit), so they part at float32
        # rounding: held to 1e-4 of each field's scale, max(1, max |field|)
        errs = []
        for k_ in ("u", "w"):
            a, b = ksim.state["gas"][k_], plain_sim.state["gas"][k_]
            scale = b.abs().amax(dim=(0, 2, 3, 4)).clamp(min=1.0)
            errs.append(float(((a - b).abs().amax(dim=(0, 2, 3, 4)) / scale).max()))
        res["end_rel_err"] = max(errs)
        check(abs(ksim.tm.time - plain_sim.tm.time) <= 1e-5 * plain_sim.tm.time
              and res["end_rel_err"] <= 1e-4,
              f"disk_sph 4-cycle kernel vs plain: t {ksim.tm.time} vs {plain_sim.tm.time}, "
              f"max |diff| / max(1, field max) {res['end_rel_err']:.3e} > 1e-4")
        print(f"disk_sph f32 after 4 cycles: kernel vs plain max |diff| / max(1, field max) "
              f"{res['end_rel_err']:.3e} (bound 1e-4), t {ksim.tm.time:.9e} vs "
              f"{plain_sim.tm.time:.9e}")
        # phase 28 holds the sharded disk to this state
        res["shard_ref"] = shard_ref(ksim)
        del plain_sim
        res["tables"] = profile_tables(torch, smi, ksim, "disk_sph",
                                       {"stage_curv_gather (tiled)": res["ms"]})
        del ksim
        torch.cuda.empty_cache()

        # one float64 kernel run
        sim64 = disk_setup(torch, "float64", DISK_BENCH, data)
        warm_up(sim64, 2)
        res["kernel_f64_zcps"] = run_cycles(torch, sim64, 10)
        check(bool(torch.isfinite(sim64.state["gas"]["u"]).all()), "f64 disk_sph not finite")
        print(f"disk_sph f64 kernel path: 10 cycles, {res['kernel_f64_zcps']:.6e} "
              f"zone-cycles/s, L2 vs IC {l2_vs_ic(torch, sim64):.3e} [{smi}]")
        del sim64
        torch.cuda.empty_cache()
    return res


# -- phase 8 -------------------------------------------------------------
# the timed K4 cell: disk_cyl.in's 128x64x32 doubled on each axis, its
# domain and cell aspect kept (as disk_sph's 256x64x64 is bench.py's)
DISK_CYL_CELL = (256, 128, 64)
DISK_CYL_CYCLES = 20
DISK_CYL_PRECISION = "float32"


def phase_disk_decks(torch, smi):
    """disk_cyl (x1/x3 ic, x2 periodic) and disk_axi (2-D) at deck size,
    float64, 5 cycles, through the padded kernel, every launch on the tiled
    body; then the timed disk_cyl cell."""
    from artemis_tpu_torch import Simulation
    from artemis_tpu_torch.ops import stage_curv as SC

    out = {"deck_l2": {}}
    with tempfile.TemporaryDirectory() as data:
        for name in ("disk_cyl", "disk_axi"):
            sim = Simulation(DISK[name], ["parthenon/time/nlim=5"], data, device=DEVICE)
            check(sim.driver.stage_kernel == "stage_curv (padded)",
                  f"{name} took {sim.driver.stage_kernel}, not the padded kernel")
            SC.stage_curv_launches = SC.tiled_launches = 0
            sim.run()
            torch.cuda.synchronize()
            l2 = l2_vs_ic(torch, sim)
            check(SC.stage_curv_launches == 2 * sim.tm.ncycle == 10
                  and SC.tiled_launches == 10 and l2 <= 6e-3
                  and bool(torch.isfinite(sim.state["gas"]["u"]).all()),
                  f"{name}: {SC.stage_curv_launches} launches ({SC.tiled_launches} on the tiled "
                  f"body) for {sim.tm.ncycle} cycles, L2 vs IC {l2:.3e} (gate 6e-3)")
            print(f"{name} f64 {sim.grid.nx}: {sim.tm.ncycle} cycles, "
                  f"{SC.stage_curv_launches} launches, every one on the tiled body, L2 vs IC "
                  f"{l2:.3e}")
            out["deck_l2"][name] = l2
            del sim
        out.update(disk_cyl_cell(torch, smi, data))
    return out


def disk_cyl_cell(torch, smi, data):
    """The timed K4 cell: disk_cyl at DISK_CYL_CELL (rk2 + PLM + HLLC, the
    deck's alpha viscosity, point gravity and rotating frame; x1/x3 ic, x2
    periodic through the padded ghosts) through Simulation.run with the
    launch counts reset before and read after, zone-cycles/s over
    DISK_CYL_CYCLES cycles after 2 warm-up, the cycle's device busy time
    and idle share, K4's time per launch on the tiled and on the per-cell
    body (bitwise equal at full size) alone and with the fill, the plain
    stage's, the bound, and L2 vs IC <= 6e-3."""
    from artemis_tpu_torch import Simulation
    from artemis_tpu_torch.ops import stage_curv as SC

    nx, ny, nz = DISK_CYL_CELL
    res = {}
    sim = Simulation(DISK["disk_cyl"], [f"parthenon/mesh/nx1={nx}", f"parthenon/mesh/nx2={ny}",
                                        f"parthenon/mesh/nx3={nz}",
                                        f"artemis/precision={DISK_CYL_PRECISION}"],
                     data, device=DEVICE)
    check(sim.driver.stage_kernel == "stage_curv (padded)",
          f"the disk_cyl cell took {sim.driver.stage_kernel}, not the padded kernel")
    SC.stage_curv_launches = SC.tiled_launches = 0
    warm_up(sim, 2)
    res["zcps"] = run_cycles(torch, sim, DISK_CYL_CYCLES)
    launches = SC.stage_curv_launches
    check(launches == 2 * sim.tm.ncycle and SC.tiled_launches == launches,
          f"disk_cyl cell: {launches} launches ({SC.tiled_launches} on the tiled body) for "
          f"{sim.tm.ncycle} rk2 cycles")
    res["launches"] = launches
    res["l2"] = l2_vs_ic(torch, sim)
    u, w = sim.state["gas"]["u"], sim.state["gas"]["w"]
    check(bool(torch.isfinite(u).all()) and bool(torch.isfinite(w).all()) and res["l2"] <= 6e-3,
          f"disk_cyl {DISK_CYL_CELL} {DISK_CYL_PRECISION} after {sim.tm.ncycle} cycles: L2 vs "
          f"IC {res['l2']:.3e} > 6e-3 or not finite")
    res["cycle_ms"] = 1e3 * nx * ny * nz / res["zcps"]
    print(f"disk_cyl cell {DISK_CYL_CELL} {DISK_CYL_PRECISION}: {DISK_CYL_CYCLES} cycles, "
          f"{res['zcps']:.6e} zone-cycles/s, cycle {res['cycle_ms']:.4f} ms, {launches} launches "
          f"for {sim.tm.ncycle} cycles, every one on the tiled body, dt {sim.tm.dt:.6e}, L2 vs "
          f"IC {res['l2']:.3e} (gate 6e-3) [{smi}]")
    cs = sim.driver._curv
    u1 = u.clone()
    dt = torch.full((), sim.tm.dt, dtype=u.dtype, device=DEVICE)
    tnow = sim.tm.time
    res.update(padded_timings(torch, cs, w, u, u1, dt, tnow))
    calls = itertools.cycle(RK2)
    res["plain_ms"] = time_launches(torch, lambda: SC.stage_curv_reference(
        cs, w, u, u1, *next(calls), dt, tnow, False), 2)
    ot = SC.stage_curv(cs, w, u, u1, *RK2[1], dt, tnow, False)
    with SC._percell_body():
        oc = SC.stage_curv(cs, w, u, u1, *RK2[1], dt, tnow, False)
    ur, wr, _ = SC.stage_curv_reference(cs, w, u, u1, *RK2[1], dt, tnow, False)
    torch.cuda.synchronize()
    check(same_stage(torch, ot, oc), "disk_cyl cell: K4 on the tiled and the per-cell body differ")
    res["stage_err"] = max(float((ot[0] - ur).abs().max()), float((ot[1] - wr).abs().max()))
    tol = DISK_F32_TOL if u.dtype == torch.float32 else F64_TOL
    check(res["stage_err"] <= tol, f"disk_cyl K4 vs plain: {res['stage_err']:.3e} > {tol:g}")
    mangled = "Id" if u.dtype == torch.float64 else "If"
    res["regs"] = {body: ptxas_usage(torch, u.dtype, entry.replace("If", mangled))
                   for body, entry in DIFF_KERNEL_ENTRIES[:1] + PADDED_PERCELL_ENTRY}
    print(f"disk_cyl cell K4 per stage: kernel on the tiled body {res['padded_ms']:.4f} ms "
          f"({res['padded_stage_ms']:.4f} ms with the ic and periodic ghost fill, the fill "
          f"{100 * res['padded_fill_share']:.1f}%), on the per-cell body "
          f"{res['padded_percell_ms']:.4f} ms ({res['padded_percell_stage_ms']:.4f} ms with the "
          f"fill; {res['padded_percell_ms'] / res['padded_ms']:.2f}x), plain "
          f"{res['plain_ms']:.4f} ms; bound {res['padded_bound_ms']:.4f} ms, "
          f"{res['padded_bound_by']}-bound; tiled == per-cell bitwise, vs plain "
          f"{res['stage_err']:.3e}; {regs_text(res['regs'])} [{smi}]")
    print("  " + smi_clocks())
    res["profile"] = profile_cycles(torch, sim, 3)
    res["idle_share"] = (1.0 - res["profile"]["busy_ms"] / res["cycle_ms"]
                         if res["profile"] else None)
    print(f"disk_cyl cell cycle (unprofiled): {res['cycle_ms']:.4f} ms, of which 2 stages "
          f"with their fill {2 * res['padded_stage_ms']:.4f} ms; device idle "
          + (f"{100 * res['idle_share']:.1f}%" if res["idle_share"] is not None
             else "not measured"))
    del sim, cs, u, w, u1, ot, oc, ur, wr
    torch.cuda.empty_cache()
    return res


# -- phase 9 -------------------------------------------------------------
FLD_FLAGS = {"zero-flux": ((False, False),) * 3, "dirichlet": ((True, True),) * 3,
             "mixed": ((True, False), (False, True), (True, True))}
# (nz, ny, nx): odd nz included, the smallest extents where a cell's two
# neighbours coincide, and one ragged across fld_coeffs' tiled footprint
# (32 x 8) and its z chunks (16 planes)
FLD_SHAPES = ((32, 16, 32), (5, 7, 9), (63, 48, 40), (2, 2, 3), (17, 9, 33))


def errs(pairs):
    """(max abs, max relative) error over (kernel, plain) output pairs, the
    relative one against each output's max |plain|."""
    ab = max(float((k - p).abs().max()) for k, p in pairs)
    rl = max(float((k - p).abs().max() / p.abs().max()) for k, p in pairs)
    return ab, rl


def fld_pairs(torch, E, chi, dt, dxs, c_code, ext, flags, sf):
    """Both FLD kernels and their plain versions on the same inputs;
    fld_coeffs on its tiled body, checked bitwise equal to its per-cell
    body."""
    from artemis_tpu_torch.ops import fld as FLD

    args = (E, chi, dt, dxs, c_code, ext, flags)
    n0 = FLD.fld_coeffs_tiled_launches
    kc = FLD.fld_coeffs(*args)
    with FLD._percell_body():
        kp = FLD.fld_coeffs(*args)
    km = FLD.fld_matvec(E, kc[0], kc[1], sf)
    torch.cuda.synchronize()
    check(FLD.fld_coeffs_tiled_launches == n0 + 1
          and all(torch.equal(a, b) for a, b in zip(kc, kp)),
          f"fld_coeffs {tuple(E.shape)} {E.dtype} {flags}: the tiled and the per-cell body "
          "differ")
    pc = FLD.fld_coeffs_reference(*args)
    pm = FLD.fld_matvec_reference(E, pc[0], pc[1], sf)
    return list(zip(kc, pc)) + [(km, pm)]


# node-axis cases (N, (nz, ny, nx), dtype, flags): the tiled AMR RHD
# pool's 128x128x64 tiles at N = 1, 2 and 16 with its Dirichlet faces, and
# a small f64 stack ragged across fld_coeffs' footprint and z chunks
FLD_NODE_CASES = ((1, (64, 128, 128), "float32", "dirichlet"),
                  (2, (64, 128, 128), "float32", "mixed"),
                  (16, (64, 128, 128), "float32", "dirichlet"),
                  (3, (17, 9, 33), "float64", "mixed"))


def fld_node_pairs(torch, n, shape, dtype, flags):
    """Both FLD kernels over a node axis of n nodes with distinct random
    fields, checked bitwise equal to n one-node launches stacked (one
    launch each, counted as a node-axis launch); returns the (kernel,
    plain) output pairs."""
    from artemis_tpu_torch.ops import fld as FLD

    g = torch.Generator(device=DEVICE).manual_seed(n * 1000 + sum(shape))
    full = (n,) + shape
    rand = lambda: torch.rand(full, generator=g, dtype=dtype, device=DEVICE)  # noqa: E731
    E, chi, sf = 0.5 + rand(), 3.0 * (1.0 + rand()), rand()
    dt = torch.full((1,), 1e-3, dtype=dtype, device=DEVICE)
    const = ((0.05, 0.07, 0.03), 10.0, 2.0, FLD_FLAGS[flags])
    n0 = (FLD.fld_coeffs_node_launches, FLD.fld_matvec_node_launches)
    kc = FLD.fld_coeffs(E, chi, dt, *const)
    km = FLD.fld_matvec(E, kc[0], kc[1], sf)
    counted = (FLD.fld_coeffs_node_launches - n0[0], FLD.fld_matvec_node_launches - n0[1])
    one = [FLD.fld_coeffs(E[i], chi[i], dt, *const) for i in range(n)]
    om = torch.stack([FLD.fld_matvec(E[i], *one[i][:2], sf[i]) for i in range(n)])
    torch.cuda.synchronize()
    check(counted == (1, 1) and all(torch.equal(k, torch.stack(o)) for k, o in zip(kc, zip(*one)))
          and torch.equal(km, om),
          f"FLD node axis N = {n} {shape} {dtype} {flags}: not bitwise equal to {n} one-node "
          f"launches (node-axis launches counted {counted})")
    pc = FLD.fld_coeffs_reference(E, chi, dt, *const)
    pm = FLD.fld_matvec_reference(E, pc[0], pc[1], sf)
    return list(zip(kc, pc)) + [(km, pm)]


def phase_fld_compare(torch):
    """fld_coeffs and fld_matvec against their plain versions on random
    states: float64 and float32, Dirichlet flags off, on and mixed, an odd
    nz included; then both over a node axis (FLD_NODE_CASES), bitwise
    equal to one-node launches."""
    import numpy as np

    worst = {}
    ncase = 0
    for shape in FLD_SHAPES:
        rng = np.random.default_rng(sum(shape))
        E, chi, sf = 0.5 + rng.random(shape), 3.0 * (1.0 + rng.random(shape)), rng.random(shape)
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).removeprefix("torch.")
            t = lambda a: torch.as_tensor(a, dtype=dtype, device=DEVICE)
            for flags in FLD_FLAGS.values():
                ab, rl = errs(fld_pairs(torch, t(E), t(chi), t(np.array([1e-3])),
                                        (0.05, 0.07, 0.03), 10.0, 2.0, flags, t(sf)))
                check(rl <= FLD_TOL[name], f"FLD kernels vs plain {shape} {name} {flags}: "
                                           f"relative error {rl:.3e} > {FLD_TOL[name]:g}")
                w = worst.setdefault(name, [0.0, 0.0])
                w[0], w[1] = max(w[0], ab), max(w[1], rl)
                ncase += 1
    print(f"fld compare: {ncase} cases (coeffs + matvec; coeffs' tiled body == its per-cell "
          f"body bitwise in each) pass; max abs / relative err "
          f"f64 {worst['float64'][0]:.3e} / {worst['float64'][1]:.3e} "
          f"(tol {FLD_TOL['float64']:g} rel), f32 {worst['float32'][0]:.3e} / "
          f"{worst['float32'][1]:.3e} (tol {FLD_TOL['float32']:g} rel)")
    t0 = time.perf_counter()
    node = worst["node_axis"] = {}
    for n, shape, name, flags in FLD_NODE_CASES:
        ab, rl = errs(fld_node_pairs(torch, n, shape, getattr(torch, name), flags))
        check(rl <= FLD_TOL[name], f"FLD node axis N = {n} {shape} {name} vs plain: relative "
                                   f"error {rl:.3e} > {FLD_TOL[name]:g}")
        w = node.setdefault(name, [0.0, 0.0])
        w[0], w[1] = max(w[0], ab), max(w[1], rl)
        torch.cuda.empty_cache()
    print(f"fld node axis: {len(FLD_NODE_CASES)} cases (N = "
          + ", ".join(f"{n} x {'x'.join(map(str, shape))} {name}"
                      for n, shape, name, _ in FLD_NODE_CASES)
          + ") each one launch of K7 and of K8, bitwise equal to N one-node launches; max abs / "
          f"relative err vs the plain versions on the stack f32 {node['float32'][0]:.3e} / "
          f"{node['float32'][1]:.3e}, f64 {node['float64'][0]:.3e} / {node['float64'][1]:.3e} "
          f"({time.perf_counter() - t0:.1f} s)")
    return worst


# -- phase 10 ------------------------------------------------------------
def allic_sim(torch, dtype, deck, data, rsolver, recon, nx=(20, 12, 6)):
    """An all-ic disk through the user entry point at a small ragged size:
    "cartesian" is the radiation-hydro deck without refinement and
    radiation (no diffusion: K5b), "spherical" disk_sph with x3 ic over
    r in [0.4, 2.4] (alpha viscosity: K5a), "spherical-inviscid" the same
    without viscosity (K5b with Mignone PLM, connection and frame terms)."""
    from artemis_tpu_torch import Simulation

    ov = [f"parthenon/mesh/nx1={nx[0]}", f"parthenon/mesh/nx2={nx[1]}",
          f"parthenon/mesh/nx3={nx[2]}", f"artemis/precision={dtype}",
          f"gas/riemann={rsolver}", f"gas/reconstruct={recon}"]
    if deck == "cartesian":
        path = DISK["disk_rhd_amr"]
        ov += ["parthenon/mesh/refinement=none", "physics/radiation=false"]
    else:
        path = DISK["disk_sph"]
        ov += ["parthenon/mesh/x1min=0.4", "parthenon/mesh/x1max=2.4",
               "parthenon/mesh/ix3_bc=ic", "parthenon/mesh/ox3_bc=ic"]
        if deck == "spherical-inviscid":
            ov += ["physics/viscosity=false"]
    return Simulation(path, ov, data, device=DEVICE)


def phase_gather6_compare(torch):
    """The six-face strip halo on the tiled body against the plain version,
    bitwise equal to the padded halo and to the per-cell body (through the
    wrapper's private switch), with diffusion off (K5b: the Cartesian disk,
    and the spherical disk without viscosity) and on (K5a, the spherical
    disk with x3 ic), both dtypes, all four schemes."""
    from artemis_tpu_torch.ops import stage_curv as SC

    worst = {"float64": 0.0, "float32": 0.0}
    ncase = ntiled = 0
    with tempfile.TemporaryDirectory() as data:
        for deck in ("cartesian", "spherical-inviscid", "spherical"):
            for dtype in ("float64", "float32"):
                tol = F64_TOL if dtype == "float64" else DISK_F32_TOL
                for scheme in ("hllc-plm", "hlle-plm", "hllc-pcm", "hlle-pcm"):
                    sim = allic_sim(torch, dtype, deck, data, *scheme.split("-"))
                    d = sim.driver
                    check(d.stage_kernel == "stage_curv (gather6)"
                          and (d.diffusion is None) == (deck != "spherical")
                          and d._curv.tiled("gather6"),
                          f"all-ic {deck} took {d.stage_kernel}")
                    w, u = sim.state["gas"]["w"], sim.state["gas"]["u"]
                    eg, og = compare_curv(torch, d._curv, w, u, tol)
                    ep, op = compare_curv(torch, d._curv, w, u, tol, padded=True)
                    check(same_stage(torch, og, op),
                          f"all-ic {deck} {dtype} {scheme}: six-face and padded halo differ")
                    worst[dtype] = max(worst[dtype], eg, ep)
                    with SC._percell_body():
                        ec, oc = compare_curv(torch, d._curv, w, u, tol)
                    check(same_stage(torch, og, oc),
                          f"all-ic {deck} {dtype} {scheme}: tiled and per-cell bodies differ")
                    worst[dtype] = max(worst[dtype], ec)
                    ncase += 6
                    ntiled += 1
    print(f"gather6 compare: {ncase} cases, six-face == padded bitwise (K5b Cartesian and "
          f"spherical inviscid, K5a spherical with viscosity), tiled == per-cell bitwise on "
          f"all {ntiled} states; max abs err vs plain f64 {worst['float64']:.3e} "
          f"(tol {F64_TOL:g}), f32 {worst['float32']:.3e} (tol {DISK_F32_TOL:g})")
    return worst


# -- phase 11 ------------------------------------------------------------
RHD_CELL = (512, 512, 64)
RHD_CYCLES = 20
# fld.cu's two bodies of fld_coeffs in its build: a mangled-name piece of each f32 kernel
FLD_ENTRIES = (("tiled", "coeffs_tiled_kernelIfEE"), ("per-cell", "fld_kernelIfLb1EE"))


def coeffs_timings(torch, args):
    """fld_coeffs (K7) on these inputs: on the tiled body (20 timed) and
    on the per-cell body (10), the two checked bitwise equal, the bound
    (E and chi read once, A, diag and Dcell written once; the plain
    version's flops) and ptxas's registers and spills of both bodies."""
    from artemis_tpu_torch.ops import fld as FLD

    out = {"coeffs_ms": time_launches(torch, lambda: FLD.fld_coeffs(*args), 20)}
    with FLD._percell_body():
        out["coeffs_percell_ms"] = time_launches(torch, lambda: FLD.fld_coeffs(*args), 10)
        kp = FLD.fld_coeffs(*args)
    kt = FLD.fld_coeffs(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(kt, kp)),
          f"fld_coeffs {tuple(args[0].shape)}: the tiled and the per-cell body differ")
    out["coeffs_bound_ms"], out["coeffs_bound_by"] = bound(
        tensor_bytes(args[0], args[1], *kt),
        count_flops(torch, lambda: FLD.fld_coeffs_reference(*args)))
    out["coeffs_regs"] = {body: ptxas_usage(torch, None, entry, source="fld")
                          for body, entry in FLD_ENTRIES}
    return out


def matvec_csr(torch, A, diag, sf):
    """K8's operator as one CSR matrix: per row the cell's diag + sf and,
    at the wrapped neighbours' columns, -AL_d below and -AH_d above along
    x, y, z; columns sorted, int32 indices.  Over a node axis ([N, nz, ny,
    nx] fields) the matrix is block diagonal, each node wrapped in its own
    box."""
    n = diag.numel()
    idx = torch.arange(n, dtype=torch.int32, device=diag.device).reshape(diag.shape)
    cols, vals = [idx], [diag + sf]
    for d in (1, 2, 3):
        dim = idx.ndim - d
        cols += [torch.roll(idx, 1, dims=dim), torch.roll(idx, -1, dims=dim)]
        vals += [-A.select(-4, 2 * d - 2), -A.select(-4, 2 * d - 1)]
    cols, order = torch.sort(torch.stack(cols, -1).reshape(n, 7), dim=1)
    vals = torch.gather(torch.stack(vals, -1).reshape(n, 7), 1, order)
    crow = torch.arange(0, 7 * n + 1, 7, dtype=torch.int32, device=diag.device)
    return torch.sparse_csr_tensor(crow, cols.reshape(-1).contiguous(),
                                   vals.reshape(-1).contiguous(), size=(n, n),
                                   check_invariants=False)


def matvec_library(torch, E, A, diag, sf):
    """K8's library yardstick, used nowhere in the port: its operator as a
    CSR matrix built outside the timing, ``torch.mv`` of it with E (one
    cuSPARSE SpMV) timed (20) and checked against K8 within FLD_TOL."""
    from artemis_tpu_torch.ops import fld as FLD

    csr = matvec_csr(torch, A, diag, sf)
    v = E.reshape(-1)
    out = {"matvec_library_ms": time_launches(torch, lambda: torch.mv(csr, v), 20),
           "library_nnz": int(csr.values().numel())}
    y = torch.mv(csr, v).reshape(E.shape)
    k = FLD.fld_matvec(E, A, diag, sf)
    torch.cuda.synchronize()
    out["library_rel_err"] = float((y - k).abs().max() / k.abs().max())
    name = str(E.dtype).removeprefix("torch.")
    check(out["library_rel_err"] <= FLD_TOL[name],
          f"the CSR SpMV vs fld_matvec: relative {out['library_rel_err']:.3e} > "
          f"{FLD_TOL[name]:g}")
    del csr, v, y, k
    torch.cuda.empty_cache()
    return out


def rhd_sim(data, fused=True):
    """The RHD cell: inputs/disk_rhd_amr.in without refinement at
    bench.py's production root (512x512x64 over [-4, 4]^2 x [-0.5, 0.5]),
    float32."""
    from artemis_tpu_torch import Simulation

    nx, ny, nz = RHD_CELL
    args = ["parthenon/mesh/refinement=none", "artemis/precision=float32",
            f"parthenon/mesh/nx1={nx}", f"parthenon/mesh/nx2={ny}", f"parthenon/mesh/nx3={nz}",
            "parthenon/mesh/x1min=-4.0", "parthenon/mesh/x1max=4.0",
            "parthenon/mesh/x2min=-4.0", "parthenon/mesh/x2max=4.0"]
    return Simulation(DISK["disk_rhd_amr"], args, data, device=DEVICE, fused_stage=fused)


def fld_inputs(torch, rad, state, dt_value, ghosts=None):
    """The FLD operator's inputs as the radiation step ``rad`` makes them
    from a node's state: E, chi, dt (one element) and the first outer's
    sf; ``ghosts``: a patch's Dirichlet planes, which set its flags as
    ``rad.step`` sets them."""
    cfg, gas = rad.cfg, rad.gas
    u, Er = state["gas"]["u"], state["rad"]["Er"]
    dt = torch.full((1,), dt_value, dtype=u.dtype, device=DEVICE)
    rho = torch.clamp_min(u[:1, 0], gas.dfloor)
    T0 = u[:1, 5] / (rho * gas.cv)
    rcv = rho * gas.cv
    chi = (rad.kappa(rho, T0) + cfg.kappa_s) * rho
    sig = dt * cfg.c_code * rad.kappa(rho, T0) * rho
    sf = sig * (rcv / (rcv + sig * 4.0 * cfg.arad * T0 * T0 * T0))
    edges = {**rad._edge_dirichlet, **(ghosts or {})}
    flags = [tuple(v is not None for v in edges.get(d, (None, None))) for d in (1, 2, 3)]
    shp = tuple(Er.shape[-3:])
    return (Er.reshape(shp).contiguous(), chi.reshape(shp).contiguous(), dt, rad._wuni,
            cfg.c_code, rad._ext, flags), sf.reshape(shp).contiguous()


def phase_rhd(torch, smi, built, built_plain):
    """``built``, ``built_plain``: the kernel and plain sims and their set-up
    seconds (``timed_build``, made beside the build)."""
    from artemis_tpu_torch import profiling
    from artemis_tpu_torch import bc as bc_mod
    from artemis_tpu_torch.ops import fld as FLD
    from artemis_tpu_torch.ops import stage_curv as SC

    res = {}
    ncell = RHD_CELL[0] * RHD_CELL[1] * RHD_CELL[2]
    sim, res["setup_s"] = built
    del built
    drv, rad = sim.driver, sim.driver.radiation
    check(drv.stage_kernel == "stage_curv (gather6)" and rad.use_kernels
          and all(lo is not None and hi is not None
                  for lo, hi in rad._edge_dirichlet.values())
          and len(rad._edge_dirichlet) == 3,
          f"RHD cell took {drv.stage_kernel}, radiation kernels {rad.use_kernels}, "
          f"Dirichlet edges {rad._edge_dirichlet}")
    print(f"RHD cell {RHD_CELL} f32: set-up {res['setup_s']:.1f} s, stage kernel "
          f"{drv.stage_kernel}, radiation through fld_coeffs + fld_matvec")
    iters = []

    def record(state, tm):
        iters.append(list(rad.cg_iters))

    # the main path: 2 warm-up + RHD_CYCLES timed cycles, counting launches
    reads0 = profiling.host_reads
    SC.stage_curv_launches = FLD.fld_coeffs_launches = FLD.fld_matvec_launches = 0
    FLD.fld_coeffs_tiled_launches = 0
    sim.tm.nlim = 2
    sim.run(extra_observers=[record])
    check(sim.status == "complete" and sim.tm.ncycle == 2, "RHD warm-up did not complete")
    res["kernel_zcps"] = run_cycles(torch, sim, RHD_CYCLES, observers=[record])
    launches = (SC.stage_curv_launches, FLD.fld_coeffs_launches, FLD.fld_matvec_launches)
    ncyc = sim.tm.ncycle
    matvecs = sum(1 + it for its in iters for it in its)
    check(len(iters) == ncyc and launches == (2 * ncyc, ncyc, matvecs)
          and FLD.fld_coeffs_tiled_launches == ncyc,
          f"RHD cell: launches (stage_curv, fld_coeffs, fld_matvec) {launches} for "
          f"{ncyc} cycles ({FLD.fld_coeffs_tiled_launches} fld_coeffs on the tiled body), "
          f"{matvecs} matvecs expected from the CG counts")
    res["launches"] = launches
    res["cg_iters"] = iters
    outers = [len(its) for its in iters]
    res["cg_per_outer"] = sum(sum(its) for its in iters) / sum(outers)
    res["reads_per_cycle"] = (profiling.host_reads - reads0) / ncyc
    res["l2"] = l2_vs_ic(torch, sim)
    fin = all(bool(torch.isfinite(t).all()) for t in
              (sim.state["gas"]["u"], sim.state["gas"]["w"], sim.state["rad"]["Er"]))
    check(fin and res["l2"] <= 3e-4,
          f"RHD cell after {ncyc} cycles: L2 vs IC {res['l2']:.3e} > 3e-4 or not finite")
    print(f"RHD f32 kernel path: {RHD_CYCLES} cycles, {res['kernel_zcps']:.6e} "
          f"zone-cycles/s, dt {sim.tm.dt:.6e}, L2 vs IC {res['l2']:.3e} (gate 3e-4) [{smi}]")
    print(f"RHD launches in {ncyc} cycles: stage_curv {launches[0]}, fld_coeffs "
          f"{launches[1]} (every one on the tiled body), fld_matvec {launches[2]}; Newton "
          f"outers per cycle "
          f"{sum(outers) / ncyc:.2f}, CG iterations per outer {res['cg_per_outer']:.2f} "
          f"(per cycle: {iters}); host read-backs per cycle {res['reads_per_cycle']:.2f}")

    # per-launch times of the three kernels on this state, with their
    # plain versions, bounds and the halo checks
    cs = drv._curv
    u, w = sim.state["gas"]["u"], sim.state["gas"]["w"]
    u1 = u.clone()
    dt = torch.full((), sim.tm.dt, dtype=u.dtype, device=DEVICE)
    tnow = sim.tm.time
    calls = itertools.cycle([(0.0, 1.0, 1.0), (0.5, 0.5, 0.5)])

    def kern():
        g0, g1, b = next(calls)
        return SC.stage_curv(cs, w, u, u1, g0, g1, b, dt, tnow, False)

    def plain():
        g0, g1, b = next(calls)
        return SC.stage_curv_reference(cs, w, u, u1, g0, g1, b, dt, tnow, False)

    check(cs.tiled("gather6"), "RHD cell: the six-face launch does not take the tiled body")
    res["ms"] = time_launches(torch, kern, 20)
    with SC._percell_body():
        res["percell_ms"] = time_launches(torch, kern, 10)
    res["plain_ms"] = time_launches(torch, plain, 2)
    nblk = cs.dtden_blocks(True)
    nbytes = (tensor_bytes(w, u1, w, u, u1) + 2 * tensor_bytes(*cs.strips.values(), *cs.rows)
              + 2 * (tensor_bytes(u, w) + nblk * u.element_size())) / 2
    flops = sum(count_flops(torch, lambda g=g: SC.stage_curv_reference(
        cs, w, u, u1, *g, dt, tnow, False)) for g in ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5))) / 2
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
    og = SC.stage_curv(cs, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False)
    with SC._percell_body():
        oc = SC.stage_curv(cs, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False)
    op = SC.stage_curv(cs, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False, padded=True)
    ur, wr, _ = SC.stage_curv_reference(cs, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False)
    torch.cuda.synchronize()
    check(same_stage(torch, og, oc), "RHD cell: tiled and per-cell bodies differ")
    check(same_stage(torch, og, op), "RHD cell: six-face and padded halo differ")
    ug, wg = og[:2]
    res["stage_err"] = max(float((ug - ur).abs().max()), float((wg - wr).abs().max()))
    check(res["stage_err"] <= DISK_F32_TOL,
          f"RHD stage kernel vs plain: {res['stage_err']:.3e} > {DISK_F32_TOL:g}")
    w_pad = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)
    res["padded_ms"] = time_launches(torch, lambda: SC._launch(
        cs, w_pad, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False, "padded"), 20)
    res["padded_stage_ms"] = time_launches(torch, lambda: SC.stage_curv(
        cs, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False, padded=True), 10)
    res["regs"] = {body: ptxas_usage(torch, torch.float32, entry)
                   for body, entry in KERNEL_ENTRIES}
    print(f"RHD f32 stage per launch: six-face kernel (K5b) on the tiled body "
          f"{res['ms']:.4f} ms, on the per-cell body {res['percell_ms']:.4f} ms "
          f"({res['percell_ms'] / res['ms']:.2f}x), padded halo {res['padded_ms']:.4f} ms "
          f"({res['padded_stage_ms']:.4f} ms with the ic fill), plain "
          f"{res['plain_ms']:.4f} ms; bound {nbytes / 1e6:.1f} MB and {flops / 1e9:.3f} "
          f"GFLOP -> {res['bound_ms']:.4f} ms, {res['bound_by']}-bound; tiled == per-cell "
          f"== padded bitwise, vs plain {res['stage_err']:.3e}; {regs_text(res['regs'])} "
          f"[{smi}]")
    del og, oc, op, ug, wg, ur, wr, w_pad

    args, sf = fld_inputs(torch, rad, sim.state, sim.tm.dt)
    E = args[0]
    res.update(coeffs_timings(torch, args))
    res["coeffs_plain_ms"] = time_launches(torch, lambda: FLD.fld_coeffs_reference(*args), 4)
    A, dg3, Dc = FLD.fld_coeffs_reference(*args)
    res["matvec_ms"] = time_launches(torch, lambda: FLD.fld_matvec(E, A, dg3, sf), 20)
    res["matvec_plain_ms"] = time_launches(
        torch, lambda: FLD.fld_matvec_reference(E, A, dg3, sf), 4)
    res.update(matvec_library(torch, E, A, dg3, sf))
    pairs = fld_pairs(torch, *args, sf)
    res["coeffs_err"] = errs(pairs[:3])
    res["matvec_err"] = errs(pairs[3:])
    check(res["coeffs_err"][1] <= FLD_TOL["float32"]
          and res["matvec_err"][1] <= FLD_TOL["float32"],
          f"RHD FLD kernels vs plain: relative {res['coeffs_err'][1]:.3e}, "
          f"{res['matvec_err'][1]:.3e} > {FLD_TOL['float32']:g}")
    res["matvec_bound_ms"], res["matvec_bound_by"] = bound(
        tensor_bytes(E, A, dg3, sf, E),
        count_flops(torch, lambda: FLD.fld_matvec_reference(E, A, dg3, sf)))
    print(f"RHD f32 fld_coeffs (K7) per launch: kernel on the tiled body "
          f"{res['coeffs_ms']:.4f} ms, on the per-cell body {res['coeffs_percell_ms']:.4f} ms "
          f"({res['coeffs_percell_ms'] / res['coeffs_ms']:.2f}x; bitwise equal), plain "
          f"{res['coeffs_plain_ms']:.4f} ms, bound {res['coeffs_bound_ms']:.4f} ms "
          f"({res['coeffs_bound_by']}); vs plain abs {res['coeffs_err'][0]:.3e} rel "
          f"{res['coeffs_err'][1]:.3e}; {regs_text(res['coeffs_regs'])} [{smi}]")
    print(f"RHD f32 fld_matvec (K8) per launch: kernel {res['matvec_ms']:.4f} ms, plain "
          f"{res['matvec_plain_ms']:.4f} ms, one CSR SpMV (torch.mv, cuSPARSE; its matrix "
          f"built outside the timing, {res['library_nnz']} entries) "
          f"{res['matvec_library_ms']:.4f} ms, bound {res['matvec_bound_ms']:.4f} ms "
          f"({res['matvec_bound_by']}); vs plain abs {res['matvec_err'][0]:.3e} rel "
          f"{res['matvec_err'][1]:.3e}; the SpMV vs the kernel rel "
          f"{res['library_rel_err']:.3e} [{smi}]")
    print("  " + smi_clocks())
    del args, sf, E, A, dg3, Dc, pairs, u1, cs, u, w
    torch.cuda.empty_cache()

    # the cycle's split: the unprofiled cycle against the device's busy
    # time under torch.profiler
    cycle_ms = 1e3 * ncell / res["kernel_zcps"]
    kern_ms = (2 * res["ms"] + res["coeffs_ms"]
               + res["matvec_ms"] * launches[2] / ncyc)
    res["profile"] = profile_cycles(torch, sim, 3)
    res["idle_share"] = (1.0 - res["profile"]["busy_ms"] / cycle_ms
                         if res["profile"] else None)
    print(f"RHD f32 cycle (unprofiled): {cycle_ms:.4f} ms; the three kernels "
          f"{kern_ms:.4f} ms of it ({100 * kern_ms / cycle_ms:.1f}%); device idle "
          + (f"{100 * res['idle_share']:.1f}%" if res["idle_share"] is not None
             else "not measured"))
    res["tables"] = profile_tables(torch, smi, sim, "RHD", {
        "stage_curv_gather6 (tiled)": res["ms"], "fld_coeffs (tiled)": res["coeffs_ms"],
        "fld_matvec (per-cell)": res["matvec_ms"]})
    del sim, drv, rad
    torch.cuda.empty_cache()

    # the plain path through the same entry point
    psim = built_plain[0]
    del built_plain
    check(psim.driver.stage_kernel == "none" and not psim.driver.radiation.use_kernels,
          "plain RHD run took a kernel")
    warm_up(psim, 1)
    res["plain_zcps"] = run_cycles(torch, psim, 2)
    l2p = l2_vs_ic(torch, psim)
    check(bool(torch.isfinite(psim.state["rad"]["Er"]).all()) and l2p <= 3e-4,
          f"plain RHD run: L2 {l2p:.3e} or not finite")
    print(f"RHD f32 plain path: 2 cycles, {res['plain_zcps']:.6e} zone-cycles/s, "
          f"L2 vs IC {l2p:.3e} [{smi}]")
    del psim
    torch.cuda.empty_cache()
    return res


# -- phase 12 ------------------------------------------------------------
RK2 = ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5))   # (gam0, gam1, beta) of the two stages


def random_strips(torch, grid, rng, dtype):
    """Six-face strips (STRIP_KEYS order) of smooth positive random prims."""
    import numpy as np

    from artemis_tpu_torch.ops import stage_curv as SC

    out = {}
    for key, shp in zip(SC.STRIP_KEYS, SC.strip_shapes(grid)):
        a = np.empty(shp)
        a[0] = 1 + 0.2 * rng.random(shp[1:])
        a[1:4] = 0.3 * (rng.random((3,) + shp[1:]) - 0.5)
        a[5] = 1 + 0.2 * rng.random(shp[1:])
        a[4] = 0.4 * a[0] * a[5]
        out[key] = torch.as_tensor(a, dtype=dtype, device=DEVICE)
    return out


def phase_batched_compare(torch):
    """K6, the node axis of stage_curv.cu: N = 1, 2, 3 Cartesian nodes of
    one shape over different boxes (each its own coefficient rows), the
    same point mass, random states and random six-face strips, in one
    launch: bitwise equal to N one-node six-face launches, to the same
    launch on the per-cell body and to N padded launches of the same strips
    (dtden by maximum), and within F64_TOL / F32_TOL of
    stage_curv_batched_reference, both RK patterns."""
    import numpy as np

    from artemis_tpu_torch.ops import stage_curv as SC

    worst = {torch.float64: 0.0, torch.float32: 0.0}
    ncase = 0
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
        for n in (1, 2, 3):
            rng = np.random.default_rng(7 + n)
            stages, ws, us, strips = [], [], [], []
            for k in range(n):
                box = (f"x1min={-2.0 + 0.25 * k} x1max={2.0 + 0.5 * k} "
                       f"x2min={-1.0 - 0.125 * k} x2max=1.0 x3min=-0.25 x3max=0.25")
                cs, w, u = curv_case(torch, "cartesian", "hllc", "plm", dtype, None, None,
                                     True, False, True, box=box, seed=2 + k)
                stages.append(cs)
                ws.append(w)
                us.append(u)
                strips.append(random_strips(torch, cs.grid, rng, dtype))
            check(SC.gather6_batch_ok(stages) == (n >= 2), f"batch gate wrong for n={n}")
            dt = torch.full((1,), 2e-3, dtype=dtype, device=DEVICE)
            for g in RK2:
                u1s = [u.clone() for u in us]
                nb = SC.stage_curv_batched_launches
                out = SC.stage_curv_batched(stages, ws, us, u1s, strips, *g, dt, 0.0, False)
                one = [SC.stage_curv(cs, w, u, u1, *g, dt, 0.0, False, strips=st)
                       for cs, w, u, u1, st in zip(stages, ws, us, u1s, strips)]
                with SC._percell_body():
                    pc = SC.stage_curv_batched(stages, ws, us, u1s, strips, *g, dt, 0.0, False)
                pads = [SC.stage_curv(cs, w, u, u1, *g, dt, 0.0, False,
                                      w_pad=SC.pad_from_strips(w, cs.grid, st))
                        for cs, w, u, u1, st in zip(stages, ws, us, u1s, strips)]
                torch.cuda.synchronize()
                check(all(same_stage(torch, a, b) and same_stage(torch, a, c)
                          for a, b, c in zip(out, pc, pads)),
                      f"K6 n={n} {dtype} gam0={g[0]}: tiled, per-cell and padded differ")
                ref = SC.stage_curv_batched_reference(stages, ws, us, u1s, strips, *g, dt, 0.0,
                                                      False)
                check(SC.stage_curv_batched_launches == nb + 2, "batched launches not counted")
                for (ub, wb, db), (uo, wo, do), (ur, wr, dr) in zip(out, one, ref):
                    check(torch.equal(ub, uo) and torch.equal(wb, wo) and torch.equal(db, do),
                          f"K6 n={n} {dtype} gam0={g[0]}: not bitwise the one-node launches")
                    err = max(float((ub - ur).abs().max()), float((wb - wr).abs().max()))
                    derr = float((db.max() - dr.max()).abs() / dr.max())
                    check(err <= tol and derr <= tol and bool(torch.isfinite(ub).all()),
                          f"K6 n={n} {dtype} gam0={g[0]} vs plain: max abs {err:.3e}, "
                          f"dtden rel {derr:.3e} > {tol:g}")
                    worst[dtype] = max(worst[dtype], err)
                ncase += 1
    print(f"batched compare (K6): {ncase} launches of N = 1, 2, 3 nodes on the tiled body, "
          f"each bitwise equal to N one-node six-face launches, to the per-cell body and to N "
          f"padded launches; max abs err vs plain f64 "
          f"{worst[torch.float64]:.3e} (tol {F64_TOL:g}), f32 {worst[torch.float32]:.3e} "
          f"(tol {F32_TOL:g})")
    return worst[torch.float64], worst[torch.float32]


# -- phases 13 and 14 ----------------------------------------------------
AMR_CELL = (256, 256, 64)      # root over the deck's own domain; its patch has its shape
AMR_CYCLES = 20
AMR_PROD = (512, 512, 64)      # bench.py's production root; patch 256x256x64
AMR_PROD_CYCLES = 10


def amr_sim(data, shape, dom, fused=True, extra=(), restart=None):
    """inputs/disk_rhd_amr.in as written (its static refinement patch, gray
    FLD, all faces ic), float32, at root ``shape`` over [-dom, dom]^2 x
    [-0.5, 0.5]."""
    from artemis_tpu_torch import Simulation

    nx, ny, nz = shape
    args = ["artemis/precision=float32", f"parthenon/mesh/nx1={nx}",
            f"parthenon/mesh/nx2={ny}", f"parthenon/mesh/nx3={nz}",
            f"parthenon/mesh/x1min={-dom}", f"parthenon/mesh/x1max={dom}",
            f"parthenon/mesh/x2min={-dom}", f"parthenon/mesh/x2max={dom}", *extra]
    return Simulation(DISK["disk_rhd_amr"], args, data, device=DEVICE, fused_stage=fused,
                      restart=restart)


def ncells(grid):
    return grid.nx[0] * grid.nx[1] * grid.nx[2]


def amr_main_path(torch, sim, ncycles):
    """The tree's main path through the user entry points: every kernel
    count set to 0, 2 warm-up cycles through Simulation.run and
    ``ncycles`` timed through its evolution loop, the counts read after.
    Returns the counts, each cycle's CG iterations per node and outer, the
    zone-cycles/s over every zone of every level (bench.py:149; evolve's
    own rate counts the root, as the JAX package's evolve does), the root-only
    rate and the host read-backs per cycle."""
    from artemis_tpu_torch import profiling
    from artemis_tpu_torch.ops import fld as FLD
    from artemis_tpu_torch.ops import stage_curv as SC

    smr = sim.driver.smr
    iters = []

    def record(state, tm):
        iters.append([list(nd.radiation.cg_iters) for nd in smr.nodes])

    reads0 = profiling.host_reads
    SC.stage_curv_launches = SC.stage_curv_batched_launches = 0
    FLD.fld_coeffs_launches = FLD.fld_coeffs_tiled_launches = FLD.fld_matvec_launches = 0
    sim.tm.nlim = 2
    sim.run(extra_observers=[record])
    check(sim.status == "complete" and sim.tm.ncycle == 2, "AMR warm-up did not complete")
    root_zcps = run_cycles(torch, sim, ncycles, observers=[record])
    out = {"launches": {"stage_curv_batched": SC.stage_curv_batched_launches,
                        "stage_curv": SC.stage_curv_launches,
                        "fld_coeffs": FLD.fld_coeffs_launches,
                        "fld_coeffs_tiled": FLD.fld_coeffs_tiled_launches,
                        "fld_matvec": FLD.fld_matvec_launches}}
    ncyc = sim.tm.ncycle
    nnodes = len(smr.nodes)
    matvecs = sum(1 + it for cyc in iters for its in cyc for it in its)
    launches = out["launches"]
    check(len(iters) == ncyc and launches["fld_coeffs"] == nnodes * ncyc
          and launches["fld_coeffs_tiled"] == launches["fld_coeffs"]
          and launches["fld_matvec"] == matvecs,
          f"AMR {sim.grid.nx}: launches {launches} for {ncyc} cycles on {nnodes} nodes, "
          f"{matvecs} matvecs expected from the CG counts")
    zones = sum(ncells(nd.grid) for nd in smr.nodes)
    out.update(ncyc=ncyc, iters=iters, zones=zones, root_zcps=root_zcps,
               zcps=root_zcps * zones / ncells(sim.grid),
               reads_per_cycle=(profiling.host_reads - reads0) / ncyc,
               l2=l2_vs_ic(torch, sim))
    out["cg_per_outer"] = [
        sum(sum(cyc[k]) for cyc in iters) / max(1, sum(len(cyc[k]) for cyc in iters))
        for k in range(nnodes)]
    fin = all(bool(torch.isfinite(t).all()) for st in sim.driver._states
              for t in (st["gas"]["u"], st["gas"]["w"], st["rad"]["Er"]))
    check(fin and out["l2"] <= 3e-4,
          f"AMR {sim.grid.nx} after {ncyc} cycles: root density L2 vs IC {out['l2']:.3e} "
          "> 3e-4 or not finite")
    return out


def phase_amr(torch, smi, built, built_plain):
    """The equal-shape AMR RHD cell: the deck as written at a 256x256x64
    root, whose patch is 256x256x64 too, so one K6 launch with N = 2
    advances both nodes per RK stage.  ``built``, ``built_plain``: its
    kernel and plain sims and their set-up seconds (made beside the
    build)."""
    from artemis_tpu_torch import bc as bc_mod
    from artemis_tpu_torch.ops import stage_curv as SC

    res = {}
    sim, res["setup_s"] = built
    del built
    smr = sim.driver.smr
    nodes = smr.nodes
    check(len(nodes) == 2 and nodes[1].grid.nx == nodes[0].grid.nx and smr._batched
          and sim.driver.stage_kernel == "stage_curv_batched (2 nodes, gather6)"
          and all(nd.radiation.use_kernels for nd in nodes),
          f"AMR cell: {len(nodes)} nodes {[nd.grid.nx for nd in nodes]}, stage kernel "
          f"{sim.driver.stage_kernel}")
    print(f"AMR cell root {AMR_CELL} + patch {nodes[1].grid.nx} at {nodes[1].lo} f32: "
          f"set-up {res['setup_s']:.1f} s, stage kernel {sim.driver.stage_kernel}, "
          "radiation through fld_coeffs + fld_matvec on each node")
    m = amr_main_path(torch, sim, AMR_CYCLES)
    ncyc, launches = m["ncyc"], m["launches"]
    check(launches["stage_curv_batched"] == 2 * ncyc and launches["stage_curv"] == 0,
          f"AMR cell: {launches} for {ncyc} rk2 cycles (K6 twice per cycle expected)")
    res.update(m)
    print(f"AMR cell f32 kernel path: {AMR_CYCLES} cycles, {m['zcps']:.6e} zone-cycles/s "
          f"over all {m['zones']} zones ({m['root_zcps']:.6e} root-only, evolve's count), "
          f"dt {sim.tm.dt:.6e}, root density L2 vs IC {m['l2']:.3e} (gate 3e-4) [{smi}]")
    print(f"AMR cell launches in {ncyc} cycles: {launches}; CG iterations per outer by "
          f"node {[round(c, 2) for c in m['cg_per_outer']]} (per cycle and node: "
          f"{m['iters']}); host read-backs per cycle {m['reads_per_cycle']:.2f}")

    # per-launch times on this state: K6, the same nodes as two one-node
    # six-face launches (K5b), as two padded launches (K4) alone and
    # with their ghost fill, and the plain version
    states = sim.driver._states
    ws = [st["gas"]["w"] for st in states]
    us = [st["gas"]["u"] for st in states]
    u1s = [u.clone() for u in us]
    patch = nodes[1]
    strips = [smr._gather6, patch.ghost_strips(ws[0], patch.lo)[0]]
    stages = smr._fused
    dt1 = torch.full((1,), sim.tm.dt, dtype=us[0].dtype, device=DEVICE)
    tnow = sim.tm.time
    calls = itertools.cycle(RK2)

    def pads():
        return [bc_mod.pad_and_fill(ws[0], nodes[0].grid, "gas", smr.bc_custom),
                patch.fill_fine_ghosts(ws[1], ws[0], patch.lo)]

    wpads = pads()
    check(all(cs.tiled("gather6") for cs in stages),
          "AMR cell: the node-batched launch does not take the tiled body")

    def k6():
        return SC.stage_curv_batched(stages, ws, us, u1s, strips, *next(calls), dt1, tnow,
                                     False)

    res["ms"] = time_launches(torch, k6, 20)
    with SC._percell_body():
        res["percell_ms"] = time_launches(torch, k6, 10)
    res["k5b_pair_ms"] = time_launches(torch, lambda: [
        SC.stage_curv(cs, w, u, u1, *g, dt1, tnow, False, strips=st)
        for g in [next(calls)] for cs, w, u, u1, st in zip(stages, ws, us, u1s, strips)], 20)
    res["padded_pair_ms"] = time_launches(torch, lambda: [
        SC._launch(cs, wp, w, u, u1, *g, dt1, tnow, False, "padded")
        for g in [next(calls)] for cs, wp, w, u, u1 in zip(stages, wpads, ws, us, u1s)], 20)
    res["padded_fill_pair_ms"] = time_launches(torch, lambda: [
        SC.stage_curv(cs, w, u, u1, *g, dt1, tnow, False, w_pad=wp)
        for g in [next(calls)] for cs, wp, w, u, u1 in zip(stages, pads(), ws, us, u1s)],
        10)
    res["plain_ms"] = time_launches(torch, lambda: SC.stage_curv_batched_reference(
        stages, ws, us, u1s, strips, *next(calls), dt1, tnow, False), 2)
    kb = SC.stage_curv_batched(stages, ws, us, u1s, strips, *RK2[1], dt1, tnow, False)
    with SC._percell_body():
        kc = SC.stage_curv_batched(stages, ws, us, u1s, strips, *RK2[1], dt1, tnow, False)
    k1 = [SC.stage_curv(cs, w, u, u1, *RK2[1], dt1, tnow, False, strips=st)
          for cs, w, u, u1, st in zip(stages, ws, us, u1s, strips)]
    kp = [SC.stage_curv(cs, w, u, u1, *RK2[1], dt1, tnow, False, w_pad=wp)
          for cs, wp, w, u, u1 in zip(stages, wpads, ws, us, u1s)]
    ref = SC.stage_curv_batched_reference(stages, ws, us, u1s, strips, *RK2[1], dt1, tnow,
                                          False)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for x, y in zip(kb, k1) for a, b in zip(x, y)),
          "AMR cell: K6 and the two one-node six-face launches differ")
    check(all(same_stage(torch, x, y) for x, y in zip(kb, kc)),
          "AMR cell: K6 on the tiled and the per-cell bodies differ")
    check(all(torch.equal(a, b) for x, y in zip(kb, kp) for a, b in zip(x[:2], y[:2])),
          "AMR cell: K6 and the padded launches differ")
    res["stage_err"] = max(float((a - b).abs().max()) for x, y in zip(kb, ref)
                           for a, b in zip(x[:2], y[:2]))
    check(res["stage_err"] <= DISK_F32_TOL,
          f"AMR cell K6 vs plain: {res['stage_err']:.3e} > {DISK_F32_TOL:g}")
    del kb, kc, k1, kp, ref
    nblk = stages[0].dtden_blocks(True)
    nbytes = sum((tensor_bytes(w, u1, w, u, u1) + 2 * tensor_bytes(*st.values(), *cs.rows)
                  + 2 * (tensor_bytes(u, w) + nblk * u.element_size())) / 2
                 for cs, w, u, u1, st in zip(stages, ws, us, u1s, strips))
    flops = sum(count_flops(torch, lambda g=g: SC.stage_curv_batched_reference(
        stages, ws, us, u1s, strips, *g, dt1, tnow, False)) for g in RK2) / 2
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
    res["regs"] = {body: ptxas_usage(torch, torch.float32, entry)
                   for body, entry in KERNEL_ENTRIES}
    print(f"AMR cell f32 stage per launch over both nodes: K6 on the tiled body "
          f"{res['ms']:.4f} ms, on the per-cell body {res['percell_ms']:.4f} ms "
          f"({res['percell_ms'] / res['ms']:.2f}x); two K5b launches "
          f"{res['k5b_pair_ms']:.4f} ms; two padded K4 launches "
          f"{res['padded_pair_ms']:.4f} ms ({res['padded_fill_pair_ms']:.4f} ms with the "
          f"ic fill and the prolonged ghost fill); plain {res['plain_ms']:.4f} ms; bound "
          f"{nbytes / 1e6:.1f} MB and {flops / 1e9:.3f} GFLOP -> {res['bound_ms']:.4f} ms, "
          f"{res['bound_by']}-bound; K6 == per-cell K6 == K5b == K4 bitwise, vs plain "
          f"{res['stage_err']:.3e}; {regs_text(res['regs'])} [{smi}]")
    print("  " + smi_clocks())

    # fld_coeffs (K7) on each node's radiation inputs
    res["coeffs_nodes"] = []
    for nd, st in zip(nodes, states):
        args, _ = fld_inputs(torch, nd.radiation, st, sim.tm.dt)
        res["coeffs_nodes"].append(coeffs_timings(torch, args))
        del args
    print("AMR cell f32 fld_coeffs (K7) per launch by node (root, patch): tiled body "
          + ", ".join(f"{c['coeffs_ms']:.4f}" for c in res["coeffs_nodes"])
          + " ms; per-cell body "
          + ", ".join(f"{c['coeffs_percell_ms']:.4f}" for c in res["coeffs_nodes"])
          + " ms (bitwise equal); bound "
          + ", ".join(f"{c['coeffs_bound_ms']:.4f}" for c in res["coeffs_nodes"])
          + f" ms [{smi}]")

    # the tree stage around the kernel: the patch's ghost strips, and
    # the whole stage (strips, K6, rim deltas, restriction, re-sync)
    u1d = [{"gas": u} for u in u1s]
    dt_t = dt1.reshape(())
    stage_no = itertools.cycle((1, 2))
    res["strips_ms"] = time_launches(torch, lambda: patch.ghost_strips(ws[0], patch.lo), 20)
    res["tree_stage_ms"] = time_launches(torch, lambda: smr._stage(
        states, u1d, dt_t, tnow, next(stage_no)), 20)
    res["glue_ms"] = res["tree_stage_ms"] - res["ms"] - res["strips_ms"]
    # the radiation pass, and each node's solve within it
    sib_Er = [st["rad"]["Er"] for st in states]
    gh = smr._rad_ghost_planes(patch, states[0]["rad"]["Er"], sib_Er)
    res["rad_pass_ms"] = time_launches(torch, lambda: smr._radiation_pass(states, dt_t), 3)
    res["rad_node_ms"] = [
        time_launches(torch, lambda: nodes[0].radiation.step(dict(states[0]), dt_t), 3),
        time_launches(torch, lambda: patch.radiation.step(dict(states[1]), dt_t,
                                                           ghosts=gh), 3)]
    print(f"AMR cell f32 tree stage: {res['tree_stage_ms']:.4f} ms per RK stage = K6 "
          f"{res['ms']:.4f} + patch ghost strips {res['strips_ms']:.4f} + glue (rim "
          f"deltas, dual-energy switch, restriction, re-sync) {res['glue_ms']:.4f} ms; "
          f"radiation pass {res['rad_pass_ms']:.4f} ms per cycle, of which the solves "
          f"root {res['rad_node_ms'][0]:.4f} ms and patch {res['rad_node_ms'][1]:.4f} ms "
          f"[{smi}]")
    del states, ws, us, u1s, u1d, strips, wpads, sib_Er, gh

    cycle_ms = 1e3 * ncells(sim.grid) / m["root_zcps"]
    res["profile"] = profile_cycles(torch, sim, 3)
    res["idle_share"] = (1.0 - res["profile"]["busy_ms"] / cycle_ms
                         if res["profile"] else None)
    print(f"AMR cell f32 cycle (unprofiled): {cycle_ms:.4f} ms; 2 K6 launches "
          f"{2 * res['ms']:.4f} ms ({100 * 2 * res['ms'] / cycle_ms:.1f}%); device idle "
          + (f"{100 * res['idle_share']:.1f}%" if res["idle_share"] is not None
             else "not measured"))
    del sim, smr, nodes, patch, stages
    torch.cuda.empty_cache()

    # the plain path through the same entry point
    psim = built_plain[0]
    del built_plain
    pnodes = psim.driver.smr.nodes
    check(psim.driver.stage_kernel == "none"
          and not any(nd.radiation.use_kernels for nd in pnodes),
          "plain AMR run took a kernel")
    warm_up(psim, 1)
    zones = sum(ncells(nd.grid) for nd in pnodes)
    res["plain_zcps"] = run_cycles(torch, psim, 2) * zones / ncells(psim.grid)
    res["plain_l2"] = l2_vs_ic(torch, psim)
    check(bool(torch.isfinite(psim.state["rad"]["Er"]).all()) and res["plain_l2"] <= 3e-4,
          f"plain AMR run: L2 {res['plain_l2']:.3e} or not finite")
    print(f"AMR cell f32 plain path: 2 cycles, {res['plain_zcps']:.6e} zone-cycles/s over "
          f"all levels, L2 vs IC {res['plain_l2']:.3e} [{smi}]")
    del psim, pnodes
    torch.cuda.empty_cache()
    return res


def timed_build(make):
    """(make(), its wall seconds): a Simulation built off the main thread
    (the disk IC is numpy, which releases the interpreter lock)."""
    t0 = time.perf_counter()
    sim = make()
    return sim, time.perf_counter() - t0


def phase_amr_prod(torch, smi, built):
    """bench.py's production shape: a 512x512x64 root over [-4, 4]^2 and
    the deck's window as a 256x256x64 patch; the shapes differ, so each
    node runs its own six-face launch (K5b) per RK stage.  ``built``: the
    tree and its set-up seconds (timed_build)."""
    with tempfile.TemporaryDirectory() as data:
        sim, setup_s = built
        smr = sim.driver.smr
        check(len(smr.nodes) == 2 and smr.nodes[1].grid.nx == (256, 256, 64)
              and sim.driver.stage_kernel == "stage_curv per node (gather6)",
              f"AMR production tree: {[nd.grid.nx for nd in smr.nodes]}, stage kernel "
              f"{sim.driver.stage_kernel}")
        m = amr_main_path(torch, sim, AMR_PROD_CYCLES)
        ncyc, launches = m["ncyc"], m["launches"]
        check(launches["stage_curv"] == 4 * ncyc and launches["stage_curv_batched"] == 0,
              f"AMR production: {launches} for {ncyc} rk2 cycles (2 K5b per stage expected)")
        print(f"AMR production root {AMR_PROD} + patch {smr.nodes[1].grid.nx} f32 (set-up "
              f"{setup_s:.1f} s): {AMR_PROD_CYCLES} cycles, {m['zcps']:.6e} zone-cycles/s over "
              f"all {m['zones']} zones ({m['root_zcps']:.6e} root-only), root density L2 vs "
              f"IC {m['l2']:.3e} (gate 3e-4, bench.py:185); launches {launches}; CG iterations "
              f"per outer by node {[round(c, 2) for c in m['cg_per_outer']]}; host read-backs "
              f"per cycle {m['reads_per_cycle']:.2f} [{smi}]")
        del sim, smr
        torch.cuda.empty_cache()
    return m


# -- phase 15 ------------------------------------------------------------
def phase_rad_shock(torch):
    """rad_shock.in (1-D Lowrie-Edwards shock, float64, the tensor operator)
    to t = SHOCK_TLIM against tests/test_radiation.py's thresholds."""
    import numpy as np

    from artemis_tpu_torch import Simulation, profiling

    with tempfile.TemporaryDirectory() as data:
        sim = Simulation(SHOCK, [f"parthenon/time/tlim={SHOCK_TLIM}"], data, device=DEVICE)
        rad = sim.driver.radiation
        check(not rad.use_kernels, "1-D rad_shock took the FLD kernels")
        cg = []
        ref = {}

        def observe(state, tm):
            cg.append(sum(rad.cg_iters))
            if tm.ncycle == SHARD_SHOCK_CYCLES:
                # phase 28 holds the sharded rad_shock to this state
                ref.update(shard_ref(sim, state, tm))

        t0, reads0 = time.perf_counter(), profiling.host_reads
        sim.run(extra_observers=[observe])
        secs, reads = time.perf_counter() - t0, profiling.host_reads - reads0
    w = sim.state["gas"]["w"][0].cpu().numpy()
    Er = sim.state["rad"]["Er"][0].cpu().numpy()
    T = (w[5] / sim.gas_cfg.cv)[0, 0]
    rho = w[0][0, 0]
    Trad = (Er[0, 0] / sim.radiation_cfg.arad) ** 0.25
    jump = int(np.argmax(np.diff(rho)))
    ahead = Trad[max(0, jump - 40):jump]
    d2 = float(np.abs(np.diff(Trad, 2)).max())
    ok = (np.isfinite(w).all() and np.isfinite(Er).all()
          and abs(rho[0] - 1.0) < 0.05 and abs(rho[-1] - 2.285714) / 2.285714 < 0.05
          and abs(T[0] - 0.6) / 0.6 < 0.05 and abs(T[-1] - 1.246875) / 1.246875 < 0.05
          and Trad.min() > 0.5 and Trad.max() < 1.5 and d2 < 0.05
          and rho.max() >= 2.285714 and ahead.size and ahead.max() > 0.65)
    check(ok, f"rad_shock: rho ends {rho[0]:.4f} {rho[-1]:.4f}, T ends {T[0]:.4f} "
              f"{T[-1]:.4f}, Trad [{Trad.min():.4f}, {Trad.max():.4f}], d2 {d2:.3e}, "
              f"precursor {ahead.max() if ahead.size else float('nan'):.4f}")
    print(f"rad_shock f64 to t={SHOCK_TLIM}: {sim.tm.ncycle} cycles in {secs:.1f} s, {sum(cg)} CG "
          f"iterations ({1e3 * secs / sum(cg):.4f} ms each, the cycle's other work included), "
          f"{reads} host reads (the process's: the set-ups beside it included)")
    print(f"rad_shock thresholds: rho ends "
          f"{rho[0]:.4f} / {rho[-1]:.4f}, T ends {T[0]:.4f} / {T[-1]:.4f}, Trad in "
          f"[{Trad.min():.4f}, {Trad.max():.4f}], max |d2 Trad| {d2:.3e}, precursor "
          f"Trad {ahead.max():.4f}: tests/test_radiation.py thresholds met")
    return {"ncycle": sim.tm.ncycle, "d2": d2, "secs": secs, "cg_iters": sum(cg),
            "shard_ref": ref}


# -- phase 16 ------------------------------------------------------------
def phase_k5a(torch, smi):
    """The six-face launch with viscosity (K5a) at disk_sph's 256x64x64 in
    float32 with x3 ic (the layout of phase 10 at full size): its launches
    on that path through Simulation.run, every one on the tiled body, its
    time per launch on the tiled and on the per-cell body (bitwise equal,
    and to the padded halo), the plain stage's and the bound."""
    from artemis_tpu_torch.ops import stage_curv as SC

    res = {}
    with tempfile.TemporaryDirectory() as data:
        sim = allic_sim(torch, "float32", "spherical", data, "hlle", "plm", nx=DISK_BENCH)
        d = sim.driver
        check(d.stage_kernel == "stage_curv (gather6)" and d.diffusion is not None,
              f"K5a cell took {d.stage_kernel}, diffusion {d.diffusion is not None}")
        SC.stage_curv_launches = SC.tiled_launches = 0
        warm_up(sim, 5)
        res["launches"] = SC.stage_curv_launches
        check(res["launches"] == 2 * sim.tm.ncycle and SC.tiled_launches == res["launches"],
              f"K5a cell: {res['launches']} launches ({SC.tiled_launches} on the tiled body) "
              f"for {sim.tm.ncycle} rk2 cycles")
        cs = d._curv
        u, w = sim.state["gas"]["u"], sim.state["gas"]["w"]
        check(bool(torch.isfinite(u).all()), "K5a cell state not finite")
        u1 = u.clone()
        dt = torch.full((), sim.tm.dt, dtype=u.dtype, device=DEVICE)
        tnow = sim.tm.time
        calls = itertools.cycle(RK2)

        def kern():
            return SC.stage_curv(cs, w, u, u1, *next(calls), dt, tnow, False)

        def plain():
            return SC.stage_curv_reference(cs, w, u, u1, *next(calls), dt, tnow, False)

        res.update(tiled_vs_percell(torch, cs, kern, w, u, u1, dt, tnow))
        res["plain_ms"] = time_launches(torch, plain, 4)
        nblk = cs.dtden_blocks(True)
        nbytes = (tensor_bytes(w, u1, w, u, u1) + 2 * tensor_bytes(*cs.strips.values(), *cs.rows)
                  + 2 * (tensor_bytes(u, w) + nblk * u.element_size())) / 2
        flops = sum(count_flops(torch, lambda g=g: SC.stage_curv_reference(
            cs, w, u, u1, *g, dt, tnow, False)) for g in RK2) / 2
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
        uk, wk, _ = SC.stage_curv(cs, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False)
        ur, wr, _ = SC.stage_curv_reference(cs, w, u, u1, 0.5, 0.5, 0.5, dt, tnow, False)
        res["err"] = max(float((uk - ur).abs().max()), float((wk - wr).abs().max()))
        check(res["err"] <= DISK_F32_TOL,
              f"K5a stage kernel vs plain: {res['err']:.3e} > {DISK_F32_TOL:g}")
        print(f"K5a (six-face halo, alpha viscosity) disk_sph {DISK_BENCH} f32 x3 ic: "
              f"{res['launches']} launches in {sim.tm.ncycle} cycles, every one on the tiled "
              f"body; per launch kernel on the tiled body {res['ms']:.4f} ms, on the per-cell "
              f"body {res['percell_ms']:.4f} ms ({res['percell_ms'] / res['ms']:.2f}x), plain "
              f"{res['plain_ms']:.4f} ms; bound {nbytes / 1e6:.1f} MB and {flops / 1e9:.3f} "
              f"GFLOP -> {res['bound_ms']:.4f} ms, {res['bound_by']}-bound; tiled == per-cell "
              f"== padded bitwise; vs plain {res['err']:.3e} (tol {DISK_F32_TOL:g}) [{smi}]")
        del sim, d, cs, u, w, u1, uk, wk, ur, wr
        torch.cuda.empty_cache()
    return res


# -- phase 17 ------------------------------------------------------------
SWEEP_SHAPES = ((48, 20, 12), (40, 22, 1))    # ragged 3-D (nx2 % 8 != 0), 2-D
SWEEP_GAMMA = 5.0 / 3.0


def sweep_grid(shape, deck=DECK, extra=()):
    from artemis_tpu_torch.config import ParameterInput
    from artemis_tpu_torch.grid import grid_from_input

    pin = ParameterInput.from_file(deck)
    pin.apply_overrides([f"parthenon/mesh/nx1={shape[0]}", f"parthenon/mesh/nx2={shape[1]}",
                         f"parthenon/mesh/nx3={shape[2]}", "parthenon/mesh/nghost=2",
                         *extra])
    return grid_from_input(pin)


def random_padded(torch, grid, dtype, seed=3):
    """Random smooth primitives over the whole padded grid, ghosts
    included, made with numpy from ``seed``."""
    import numpy as np

    nx, ny, nz = grid.nx
    g1, g2, g3 = grid.ng
    shape = (nz + 2 * g3, ny + 2 * g2, nx + 2 * g1)
    rng = np.random.default_rng(seed)
    w = np.empty((1, 6) + shape)
    w[0, 0] = 1.0 + 0.2 * rng.random(shape)
    w[0, 1:4] = 0.3 * (rng.random((3,) + shape) - 0.5)
    w[0, 5] = 1.0 + 0.2 * rng.random(shape)
    w[0, 4] = (SWEEP_GAMMA - 1.0) * w[0, 0] * w[0, 5]
    return torch.as_tensor(w, dtype=dtype, device=DEVICE)


def phase_sweep_compare(torch):
    """The sweep kernel (K9) against sweep_reference on random padded
    states: d = 1, 2, 3 x {plm, pcm} x {float64 <= 1e-12, float32 <= 1e-5
    abs} on a ragged 3-D and a 2-D shape; and its three outputs against
    compute_fluxes(kernel=False) (the tensor chain) in shape, layout and
    value."""
    from artemis_tpu_torch.ops import sweeps as SW
    from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro

    worst = {torch.float64: 0.0, torch.float32: 0.0}
    chain = {torch.float64: 0.0, torch.float32: 0.0}
    ncase = 0
    for shape in SWEEP_SHAPES:
        grid = sweep_grid(shape)
        for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
            w = random_padded(torch, grid, dtype)
            for recon in ("plm", "pcm"):
                cfg = FluidCfg(fluid="gas", recon=recon, rsolver="hllc", gamma=SWEEP_GAMMA)
                hyd = Hydro(grid, cfg, device=DEVICE, dtype=dtype)
                fx = hyd.compute_fluxes(w, cfg, False)
                n0 = SW.sweep_launches
                fk = hyd.compute_fluxes(w, cfg, False, kernel=True)
                torch.cuda.synchronize()
                check(SW.sweep_launches == n0 + len(hyd.dims),
                      f"compute_fluxes(kernel=True) made {SW.sweep_launches - n0} launches")
                for d in hyd.dims:
                    ref = SW.sweep_reference(w, d, grid, SWEEP_GAMMA, recon)
                    for name, k, p, c in zip(("F", "pface", "vface"), fk[d], ref, fx[d]):
                        check(k.shape == p.shape == c.shape and k.is_contiguous(),
                              f"sweep {shape} d={d} {name}: shapes {tuple(k.shape)}, "
                              f"{tuple(p.shape)}, chain {tuple(c.shape)}")
                        err = float((k - p).abs().max())
                        cerr = float((k - c).abs().max())
                        check(err <= tol and cerr <= tol,
                              f"sweep {shape} d={d} {recon} {dtype} {name}: vs plain "
                              f"{err:.3e}, vs the chain {cerr:.3e} > {tol:g}")
                        worst[dtype] = max(worst[dtype], err)
                        chain[dtype] = max(chain[dtype], cerr)
                    ncase += 1
    print(f"sweep compare: {ncase} kernel-vs-plain cases pass (d = 1, 2, 3; plm, pcm; "
          f"{SWEEP_SHAPES}); max abs err f64 {worst[torch.float64]:.3e} (tol {F64_TOL:g}), "
          f"f32 {worst[torch.float32]:.3e} (tol {F32_TOL:g}); against the tensor chain "
          f"f64 {chain[torch.float64]:.3e}, f32 {chain[torch.float32]:.3e}, same layout")
    return worst[torch.float64], worst[torch.float32]


# -- phase 18 ------------------------------------------------------------
STRAT = os.path.join(HERE, "inputs", "strat.in")
STRAT_CELL = (256, 128, 512)    # strat.in's 16x8x32 scaled by 16, its domain and aspect
STRAT_CYCLES = 20
# the strat cell's kernel and plain end states after the same cycles: max
# |diff| / max(1, max |field|) per component (the energies are ~6e4 at
# gamma = 1.000001, and the two flux forms part at float32 rounding)
STRAT_F32_TOL = 1e-4


def strat_sim(data, fused=True, precision="float32"):
    from artemis_tpu_torch import Simulation

    nx, ny, nz = STRAT_CELL
    return Simulation(STRAT, [f"parthenon/mesh/nx1={nx}", f"parthenon/mesh/nx2={ny}",
                              f"parthenon/mesh/nx3={nz}", f"artemis/precision={precision}"],
                      data, device=DEVICE, fused_stage=fused)


def scaled_err(torch, a, b):
    """max |a - b| / max(1, max |b|) over each component (axis 1)."""
    dims = (0,) + tuple(range(2, a.ndim))
    scale = b.abs().amax(dim=dims).clamp(min=1.0)
    return float(((a - b).abs().amax(dim=dims) / scale).max())


def strat_equilibrium(torch, sim):
    """tests/test_strat.py's equilibrium numbers: the density's largest
    relative drift from the initial profile inside ~3 scale heights and
    the largest |vz|."""
    import numpy as np

    w = sim.state["gas"]["w"][0]
    d, vz = w[0].double().cpu().numpy(), w[3]
    _, _, x3v = sim.grid.cell_centers()
    h = sim.pin.get_real("problem", "h")
    rho_eq = np.broadcast_to(np.maximum(1e-5, np.exp(-(x3v**2) / (2 * h * h))), d.shape)
    rel = np.abs(d - rho_eq) / rho_eq
    return (float(rel[rho_eq > 1e-2].max()), float(vz.abs().max()),
            bool(torch.isfinite(w).all()))


def sweep_timings(torch, sim, nlaunch=20):
    """Per direction on the run's state: the kernel's ms per launch, the
    plain version's, the bound (the padded prims cut to the interior across
    d read once, the 8 face arrays written once; the plain version's
    operations) and the largest kernel - plain difference per output row,
    scaled by max(1, max |plain|)."""
    from artemis_tpu_torch.ops import sweeps as SW

    grid, cfg = sim.grid, sim.gas_cfg
    w_pad = sim.driver.fill_ghosts(sim.state["gas"]["w"], "gas")
    out = {"ms": [], "plain_ms": [], "bound_ms": [], "bound_by": [], "err": 0.0, "mb": []}
    for d in sim.driver.hydro.dims:
        out["ms"].append(time_launches(torch, lambda: SW.sweep(w_pad, d, grid, cfg.gamma,
                                                               cfg.recon), nlaunch))
        out["plain_ms"].append(time_launches(
            torch, lambda: SW.sweep_reference(w_pad, d, grid, cfg.gamma, cfg.recon), 3))
        k = SW.sweep(w_pad, d, grid, cfg.gamma, cfg.recon)
        p = SW.sweep_reference(w_pad, d, grid, cfg.gamma, cfg.recon)
        out["err"] = max(out["err"], scaled_err(torch, k[0], p[0]),
                         scaled_err(torch, k[1][:, None], p[1][:, None]),
                         scaled_err(torch, k[2][:, None], p[2][:, None]))
        nbytes = tensor_bytes(SW._interior_faces(w_pad[0], d, grid), *k)
        flops = count_flops(torch, lambda: SW.sweep_reference(w_pad, d, grid, cfg.gamma,
                                                              cfg.recon))
        b_ms, b_by = bound(nbytes, flops)
        out["bound_ms"].append(b_ms)
        out["bound_by"].append(b_by)
        out["mb"].append(nbytes / 1e6)
        del k, p
    del w_pad
    torch.cuda.empty_cache()
    return out


def phase_strat(torch, smi):
    """The strat cell: inputs/strat.in at 256x128x512 float32 through
    Simulation.run on the sweep kernel (the shearing box's composable
    path), the count reset before and read after."""
    from artemis_tpu_torch.ops import sweeps as SW

    res = {}
    ncell = STRAT_CELL[0] * STRAT_CELL[1] * STRAT_CELL[2]
    with tempfile.TemporaryDirectory() as data:
        t0 = time.perf_counter()
        sim = strat_sim(data)
        res["setup_s"] = time.perf_counter() - t0
        check(sim.driver.stage_kernel == "sweep",
              f"strat cell took {sim.driver.stage_kernel}, not the sweep kernel")
        SW.sweep_launches = 0
        warm_up(sim, 2)
        res["kernel_zcps"] = run_cycles(torch, sim, STRAT_CYCLES)
        res["launches"] = SW.sweep_launches
        ncyc = sim.tm.ncycle
        check(res["launches"] == 2 * 3 * ncyc,
              f"strat cell: {res['launches']} sweep launches for {ncyc} rk2 cycles "
              "(2 stages x 3 directions expected)")
        drift, vz, fin = strat_equilibrium(torch, sim)
        res.update(drift=drift, vz=vz, t=sim.tm.time)
        check(fin and drift <= 0.03 and vz <= 0.1,
              f"strat cell after {ncyc} cycles: density drift {drift:.3e} (<= 0.03), "
              f"|vz| {vz:.3e} (<= 0.1), finite {fin}")
        print(f"strat cell {STRAT_CELL} f32 (set-up {res['setup_s']:.1f} s): {STRAT_CYCLES} "
              f"cycles, {res['kernel_zcps']:.6e} zone-cycles/s, {res['launches']} sweep "
              f"launches in {ncyc} cycles, dt {sim.tm.dt:.6e}, t {sim.tm.time:.6e}; density "
              f"drift {drift:.3e} (<= 0.03), max |vz| {vz:.3e} (<= 0.1) [{smi}]")
        tm = sweep_timings(torch, sim)
        res.update(tm)
        check(tm["err"] <= F32_TOL,
              f"strat cell sweep kernel vs plain: {tm['err']:.3e} > {F32_TOL:g}")
        for d, (k, p, b, by, mb) in enumerate(zip(tm["ms"], tm["plain_ms"], tm["bound_ms"],
                                                  tm["bound_by"], tm["mb"]), 1):
            print(f"strat f32 sweep d={d} per launch: kernel {k:.4f} ms, plain {p:.4f} ms, "
                  f"bound {b:.4f} ms ({mb:.1f} MB, {by}) [{smi}]")
        print(f"strat f32 sweep vs plain: max |diff| / max(1, |row|) {tm['err']:.3e} "
              f"(tol {F32_TOL:g})")
        print("  " + smi_clocks())
        cycle_ms = 1e3 * ncell / res["kernel_zcps"]
        kern_ms = 2 * sum(tm["ms"])
        res["profile"] = profile_cycles(torch, sim, 3)
        res["idle_share"] = (1.0 - res["profile"]["busy_ms"] / cycle_ms
                             if res["profile"] else None)
        print(f"strat f32 cycle (unprofiled): {cycle_ms:.4f} ms; 6 sweep launches "
              f"{kern_ms:.4f} ms of it ({100 * kern_ms / cycle_ms:.1f}%); device idle "
              + (f"{100 * res['idle_share']:.1f}%" if res["idle_share"] is not None
                 else "not measured"))
        del sim
        torch.cuda.empty_cache()

        # the plain path through the same entry point, then the kernel path
        # over the same cycles for an end-state comparison
        psim = strat_sim(data, fused=False)
        check(psim.driver.stage_kernel == "none", "plain strat run took a kernel")
        warm_up(psim, 1)
        n0 = SW.sweep_launches
        res["plain_zcps"] = run_cycles(torch, psim, 3)
        check(SW.sweep_launches == n0, "the plain strat run launched the sweep kernel")
        print(f"strat f32 plain path: 3 cycles, {res['plain_zcps']:.6e} zone-cycles/s [{smi}]")
        ksim = strat_sim(data)
        warm_up(ksim, 4)
        res["end_err"] = max(scaled_err(torch, ksim.state["gas"][k_], psim.state["gas"][k_])
                             for k_ in ("u", "w"))
        check(abs(ksim.tm.time - psim.tm.time) <= 1e-5 * psim.tm.time
              and res["end_err"] <= STRAT_F32_TOL,
              f"strat 4-cycle kernel vs plain: t {ksim.tm.time} vs {psim.tm.time}, "
              f"max |diff| / max(1, field max) {res['end_err']:.3e} > {STRAT_F32_TOL:g}")
        print(f"strat f32 after 4 cycles: kernel vs plain max |diff| / max(1, field max) "
              f"{res['end_err']:.3e} (tol {STRAT_F32_TOL:g}), t {ksim.tm.time:.9e} vs "
              f"{psim.tm.time:.9e}")
        del psim, ksim
        torch.cuda.empty_cache()
    return res


# -- phase 19 ------------------------------------------------------------
SSHEET = os.path.join(HERE, "inputs", "ssheet.in")
SSHEET_CYCLES = 10
SSHEET_F64_TOL = 1e-10


def phase_ssheet(torch, smi):
    """inputs/ssheet.in at deck size (128x128, 2-D, float64, point gravity,
    inflow x2) for 10 cycles through the sweep kernel (2 launches per
    stage) and through the plain path: end states within 1e-10 of each
    component's scale."""
    from artemis_tpu_torch import Simulation
    from artemis_tpu_torch.ops import sweeps as SW

    res = {}
    with tempfile.TemporaryDirectory() as data:
        sims = {}
        for fused in (True, False):
            sim = Simulation(SSHEET, [f"parthenon/time/nlim={SSHEET_CYCLES}"], data,
                             device=DEVICE, fused_stage=fused)
            check(sim.driver.stage_kernel == ("sweep" if fused else "none"),
                  f"ssheet (fused_stage={fused}) took {sim.driver.stage_kernel}")
            SW.sweep_launches = 0
            sim.run()
            check(sim.tm.ncycle == SSHEET_CYCLES
                  and SW.sweep_launches == (2 * 2 * SSHEET_CYCLES if fused else 0),
                  f"ssheet (fused_stage={fused}): {SW.sweep_launches} sweep launches in "
                  f"{sim.tm.ncycle} cycles")
            if fused:
                res["launches"] = SW.sweep_launches
            sims[fused] = sim
        k, p = sims[True], sims[False]
        res["end_err"] = max(scaled_err(torch, k.state["gas"][k_], p.state["gas"][k_])
                             for k_ in ("u", "w"))
        check(abs(k.tm.time - p.tm.time) <= 1e-12 * p.tm.time
              and res["end_err"] <= SSHEET_F64_TOL
              and bool(torch.isfinite(k.state["gas"]["u"]).all()),
              f"ssheet kernel vs plain after {SSHEET_CYCLES} cycles: t {k.tm.time} vs "
              f"{p.tm.time}, {res['end_err']:.3e} > {SSHEET_F64_TOL:g}")
        print(f"ssheet 128x128 f64: {res['launches']} sweep launches in {SSHEET_CYCLES} "
              f"cycles; kernel vs plain max |diff| / max(1, field max) {res['end_err']:.3e} "
              f"(tol {SSHEET_F64_TOL:g}), t {k.tm.time:.9e}")
    return res


# -- phase 20 ------------------------------------------------------------
ADVECTION = os.path.join(HERE, "inputs", "advection.in")
ADV_CELL = (128, 64, 64)
ADV_CYCLES = 10


def phase_advection(torch, smi):
    """Gas+dust: inputs/advection.in (gas on HLLC through the sweep kernel,
    two dust species on the HLLE chain).  test_advection's convergence runs
    (N = 16, 32, float64, gas/riemann=hllc) held to BASELINE's advection
    row, then the deck as written (128x64x64, float32): launches and
    zone-cycles/s over 10 timed cycles."""
    import numpy as np

    from artemis_tpu_torch import Simulation
    from artemis_tpu_torch.ops import sweeps as SW

    res = {}
    with tempfile.TemporaryDirectory() as data:
        for n in (16, 32):
            sim = Simulation(ADVECTION, [
                "parthenon/job/problem_id=advection", "problem/nperiod=1",
                "parthenon/time/nlim=1000", "parthenon/time/integrator=rk2",
                "parthenon/mesh/nghost=4", f"parthenon/mesh/nx1={n}",
                f"parthenon/mesh/nx2={n // 2}", f"parthenon/mesh/nx3={n // 2}",
                "problem/amp=1.0e-6", "gas/reconstruct=plm", "dust/reconstruct=plm",
                "gas/riemann=hllc", "dust/riemann=hlle"], data, device=DEVICE)
            check(sim.driver.stage_kernel == "sweep",
                  f"advection N={n} took {sim.driver.stage_kernel}")
            SW.sweep_launches = 0
            sim.run()
            check(sim.status == "complete" and SW.sweep_launches == 6 * sim.tm.ncycle,
                  f"advection N={n}: {SW.sweep_launches} launches in {sim.tm.ncycle} cycles")
        e = np.loadtxt(os.path.join(data, "advection-errs.dat"), ndmin=2)
        l1 = [float(e[1, 4 + s]) for s in range(3)]
        ratio = [float(e[1, 4 + s] / e[0, 4 + s]) for s in range(3)]
        res.update(l1=l1, ratio=ratio)
        check(e.shape == (2, 20) and all(x <= 2.21e-7 for x in l1)
              and all(r <= 0.30 for r in ratio),
              f"advection (gas, dust1, dust2): N=32 L1 {l1} (<= 2.21e-7), N16->N32 {ratio} "
              "(<= 0.30)")
        print(f"advection f64 through the sweep kernel: N=32 L1 RMS gas/dust1/dust2 "
              f"{l1[0]:.4e} / {l1[1]:.4e} / {l1[2]:.4e} (<= 2.21e-7), N16->N32 "
              f"{ratio[0]:.4f} / {ratio[1]:.4f} / {ratio[2]:.4f} (<= 0.30)")

        for fused in (True, False):
            nx, ny, nz = ADV_CELL
            sim = Simulation(ADVECTION, [f"parthenon/mesh/nx1={nx}", f"parthenon/mesh/nx2={ny}",
                                         f"parthenon/mesh/nx3={nz}", "artemis/precision=float32"],
                             data, device=DEVICE, fused_stage=fused)
            SW.sweep_launches = 0
            warm_up(sim, 2)
            zcps = run_cycles(torch, sim, ADV_CYCLES)
            fin = all(bool(torch.isfinite(sim.state[f]["u"]).all()) for f in ("gas", "dust"))
            check(fin and SW.sweep_launches == (6 * sim.tm.ncycle if fused else 0),
                  f"advection deck (fused_stage={fused}): {SW.sweep_launches} launches in "
                  f"{sim.tm.ncycle} cycles, finite {fin}")
            res["kernel_zcps" if fused else "plain_zcps"] = zcps
            if fused:
                res["launches"] = SW.sweep_launches
            print(f"advection {ADV_CELL} f32 {'kernel' if fused else 'plain'} path: "
                  f"{ADV_CYCLES} cycles, {zcps:.6e} zone-cycles/s, {SW.sweep_launches} sweep "
                  f"launches in {sim.tm.ncycle} cycles [{smi}]")
            del sim
            torch.cuda.empty_cache()
    return res



# -- phases 21 to 23 -----------------------------------------------------
DECKS = {name: os.path.join(HERE, "inputs", f"{name}.in")
         for name in ("alpha_disk", "binary_cyl", "simple_drag", "conduction",
                      "gaussian_bump", "blast")}
ALPHA_CYCLES = 20
ALPHA_PLAIN_CYCLES = 4
DECK_CMP_CYCLES = 5
# the kernel and plain end states of a float64 deck after the same cycles:
# max |diff| / max |field| per component
DECK_F64_TOL = 1e-10
F64_FLOPS = 34e12   # the H100 SXM data sheet's float64 rate outside the tensor cores
# K4's partial mode in f64: the tiled body with diffusion (the decks' path)
# and without, and the per-cell body's padded partial kernel (the private
# switch)
PARTIAL_ENTRY = (("tiled partial", "stage_tiled_kernelIdLb1ELb0EE"),
                 ("tiled partial inviscid", "stage_tiled_kernelIdLb0ELb0EE"),
                 ("per-cell padded partial", "stage_curv_kernelIdLb0ELb0EE"))
# the partial tiled body's kernel, as the profiler names it
PARTIAL_KERNEL = "stage_tiled_kernel"



def rel_err(torch, a, b):
    """max |a - b| / max |b| over each component (axis 1); a component that
    is zero throughout (v3 of a 2-D disk) must match exactly."""
    dims = (0,) + tuple(range(2, a.ndim))
    scale = b.abs().amax(dim=dims).clamp(min=torch.finfo(b.dtype).tiny)
    return float(((a - b).abs().amax(dim=dims) / scale).max())


def run_timed(torch, sim, ncycles):
    """Advance ``ncycles`` through Simulation.run, timed by CUDA events;
    returns zone-cycles/s."""
    sim.tm.nlim = sim.tm.ncycle + ncycles
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sim.run()
    end.record()
    torch.cuda.synchronize()
    check(sim.status == "complete" and sim.tm.ncycle == sim.tm.nlim,
          f"run stopped at cycle {sim.tm.ncycle}, wanted {sim.tm.nlim}")
    return ncells(sim.grid) * ncycles / (start.elapsed_time(end) / 1e3)


def partial_check(torch, cs, w, u, tol):
    """One partial launch of ``cs`` on this state (the second RK stage's
    registers) against stage_curv_reference: max |kernel - plain| over u;
    the launch takes the tiled body, and its u is bitwise equal to the
    per-cell body's on the same state (the private switch)."""
    from artemis_tpu_torch.ops import stage_curv as SC

    check(not cs.full and cs.halo == "padded" and cs.tiled("padded"),
          "the deck's stage is not a partial padded stage on the tiled body")
    dt = torch.full((1,), 1e-3, dtype=u.dtype, device=u.device)
    n0 = SC.tiled_launches
    uk, wk, _ = SC.stage_curv(cs, w, u, u.clone(), *RK2[1], dt, 0.0, False)
    check(SC.tiled_launches == n0 + 1, "a partial launch did not take the tiled body")
    with SC._percell_body():
        uc, _, _ = SC.stage_curv(cs, w, u, u.clone(), *RK2[1], dt, 0.0, False)
    ur, _, _ = SC.stage_curv_reference(cs, w, u, u.clone(), *RK2[1], dt, 0.0, False)
    torch.cuda.synchronize()
    err = float((uk - ur).abs().max())
    check(torch.equal(uk, uc), "partial K4: the tiled and the per-cell body differ")
    check(wk is w and bool(torch.isfinite(uk).all()) and err <= tol,
          f"partial K4 vs plain on the deck's state: {err:.3e} > {tol:g}")
    return err


def partial_timings(torch, cs, w, u, u1, dt, tnow):
    """K4's partial launch on this state: the kernel alone on the tiled
    body (``ms``, 20 timed, the two RK stages in turn) and on the per-cell
    body (``percell_ms``, the private switch), each with its ghost fill
    (``stage_ms``, ``percell_stage_ms``), in turns (tiled, per-cell,
    per-cell, tiled: the mean of each pair), the plain stage
    (``plain_ms``), and the bound of one launch averaged over the two
    stages (the padded prims and rows read once, u0 on the second stage,
    u1, u written once; the plain version's flops at the float64 rate)."""
    from artemis_tpu_torch import bc as bc_mod
    from artemis_tpu_torch.ops import stage_curv as SC

    w_pad = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)
    calls = itertools.cycle(RK2)

    def kernel():
        return time_launches(torch, lambda: SC._launch(
            cs, w_pad, w, u, u1, *next(calls), dt, tnow, False, "padded"), 20)

    def stage():
        return time_launches(torch, lambda: SC.stage_curv(
            cs, w, u, u1, *next(calls), dt, tnow, False), 20)

    times = {}
    for key, percell in (("", False), ("percell_", True), ("percell_", True), ("", False)):
        with SC._percell_body() if percell else contextlib.nullcontext():
            times.setdefault(key + "ms", []).append(kernel())
            times.setdefault(key + "stage_ms", []).append(stage())
    out = {k: sum(v) / len(v) for k, v in times.items()}
    out["plain_ms"] = time_launches(torch, lambda: SC.stage_curv_reference(
        cs, w, u, u1, *next(calls), dt, tnow, False), 4)
    nbytes = (2 * tensor_bytes(w_pad, *cs.rows) + tensor_bytes(u1, u, u1)
              + 2 * tensor_bytes(u)) / 2
    flops = sum(count_flops(torch, lambda g=g: SC.stage_curv_reference(
        cs, w, u, u1, *g, dt, tnow, False, w_pad=w_pad)) for g in RK2) / 2
    out["bound_ms"], out["bound_by"] = bound(
        nbytes, flops, F64_FLOPS if u.dtype == torch.float64 else F32_FLOPS)
    out["mb"], out["gflop"] = nbytes / 1e6, flops / 1e9
    return out


def profile_split(torch, sim, ncycles, parts, kernels):
    """Device busy time per cycle over ``ncycles`` of Simulation.run under
    torch.profiler, and the device time of each part: ``parts`` maps a
    label to (object, attribute) pairs whose calls are wrapped in a
    record_function range of that label for the window (the kernels each
    range launches through torch, its children's included); ``kernels``
    maps a label to a piece of the names of the kernels it counts (a
    kernel launched through ctypes is tied to no torch operator).  None
    when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = []
    for label, targets in parts.items():
        for obj, attr in targets:
            fn = getattr(obj, attr)

            def wrapped(*a, _fn=fn, _label=label, **k):
                with record_function(_label):
                    return _fn(*a, **k)

            saved.append((obj, attr, attr in vars(obj), vars(obj).get(attr)))
            setattr(obj, attr, wrapped)
    sim.tm.nlim = sim.tm.ncycle + ncycles
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sim.run()
            torch.cuda.synchronize()
    finally:
        for obj, attr, own, fn in reversed(saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)
    rows = [(e.key, e.self_device_time_total / 1e3 / ncycles) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.key not in parts]
    busy = sum(t for _, t in rows)
    if busy <= 0.0:
        print("profile: no device time recorded (not measured)")
        return None
    split = {label: sum(e.device_time_total for e in prof.events()
                        if e.name == label and e.device_type == DeviceType.CPU)
             / 1e3 / ncycles for label in parts}
    split.update({label: sum(t for key, t in rows if piece in key)
                  for label, piece in kernels.items()})
    return {"busy_ms": busy, "split": split}


def phase_alpha_disk(torch, smi):
    """inputs/alpha_disk.in as written (512x1024 float64, cylindrical 2-D,
    viscous x1 walls, alpha viscosity, point gravity, beta cooling) on K4's
    partial mode: the main path through Simulation.run with the launch
    counts reset before and read after (2 per cycle, every one partial and
    on the tiled body), zone-cycles/s of the kernel path
    (ALPHA_CYCLES after 2 warm-up) and of the plain path, partial K4 per
    launch on the tiled and the per-cell body against its plain stage and
    its bound, the cycle's device busy
    time and idle share under torch.profiler split into K4, the viscous
    fill and the gravity + cooling chain, one partial launch on the deck's
    state against the plain version (float64 1e-12, float32 1e-4) and
    bitwise against the per-cell body, and the kernel and plain end states
    after DECK_CMP_CYCLES."""
    from artemis_tpu_torch import Simulation, bc as bc_mod
    from artemis_tpu_torch.ops import stage_curv as SC

    res = {}
    deck = DECKS["alpha_disk"]
    with tempfile.TemporaryDirectory() as data:
        sim = Simulation(deck, [], data, device=DEVICE)
        d = sim.driver
        check(d.stage_kernel == "stage_curv (padded, partial)" and sim.dtype == torch.float64
              and [type(s).__name__ for s in d._curv_srcs] == ["Gravity", "BetaCooling"],
              f"alpha_disk took {d.stage_kernel} with the chain {d._curv_srcs}")
        n = ncells(sim.grid)
        SC.stage_curv_launches = SC.tiled_launches = 0
        warm_up(sim, 2)
        res["zcps"] = run_timed(torch, sim, ALPHA_CYCLES)
        res["launches"] = SC.stage_curv_launches
        check(res["launches"] == 2 * sim.tm.ncycle and SC.tiled_launches == res["launches"],
              f"alpha_disk: {res['launches']} launches ({SC.tiled_launches} tiled) for "
              f"{sim.tm.ncycle} rk2 cycles")
        u, w = sim.state["gas"]["u"], sim.state["gas"]["w"]
        check(bool(torch.isfinite(u).all()) and bool((w[:, 0] > 0).all()),
              "alpha_disk state not finite or density not positive")
        res["cycle_ms"] = 1e3 * n / res["zcps"]
        print(f"alpha_disk {tuple(sim.grid.nx)} f64 on partial K4: {ALPHA_CYCLES} cycles "
              f"through Simulation.run, {res['zcps']:.6e} zone-cycles/s, cycle "
              f"{res['cycle_ms']:.4f} ms, {res['launches']} launches in {sim.tm.ncycle} cycles, "
              f"every one partial on the tiled body, dt {sim.tm.dt:.6e} [{smi}]")
        cs = d._curv
        u1 = u.clone()
        dt = torch.full((1,), sim.tm.dt, dtype=u.dtype, device=DEVICE)
        res.update(partial_timings(torch, cs, w, u, u1, dt, sim.tm.time))
        res["err_f64"] = partial_check(torch, cs, w, u, F64_TOL)
        res["regs"] = {body: ptxas_usage(torch, torch.float64, entry)
                       for body, entry in PARTIAL_ENTRY}
        print(f"alpha_disk partial K4 per launch (f64): tiled body {res['ms']:.4f} ms, with "
              f"the viscous ghost fill {res['stage_ms']:.4f} ms; per-cell body "
              f"{res['percell_ms']:.4f} ms, {res['percell_stage_ms']:.4f} ms; plain stage "
              f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms ({res['mb']:.1f} MB, "
              f"{res['gflop']:.3f} GFLOP, {res['bound_by']}-bound); vs plain on the deck's "
              f"state {res['err_f64']:.3e} (tol {F64_TOL:g}), bitwise equal to the per-cell "
              f"body; {regs_text(res['regs'])} [{smi}]")
        print("  " + smi_clocks())
        chain = [(s_, "apply") for s_ in d._curv_srcs]
        prof = profile_split(torch, sim, 3, {"viscous fill": [(bc_mod, "pad_and_fill")],
                                             "gravity + cooling": chain},
                             {"K4 partial": PARTIAL_KERNEL})
        res["profile"] = prof
        res["idle_share"] = 1.0 - prof["busy_ms"] / res["cycle_ms"] if prof else None
        if prof:
            sp = prof["split"]
            rest = prof["busy_ms"] - sum(sp.values())
            print(f"alpha_disk cycle {res['cycle_ms']:.4f} ms (unprofiled): device busy "
                  f"{prof['busy_ms']:.4f} ms, idle {100 * res['idle_share']:.1f}%; busy by "
                  f"part: K4 {sp['K4 partial']:.4f} ms, viscous fill {sp['viscous fill']:.4f} "
                  f"ms, gravity + cooling {sp['gravity + cooling']:.4f} ms, the rest (dual "
                  f"energy sync, C2P/P2C, dt) {rest:.4f} ms [{smi}]")
        del sim, cs, u, w, u1
        torch.cuda.empty_cache()

        s32 = Simulation(deck, ["artemis/precision=float32", "parthenon/time/nlim=0"], data,
                         device=DEVICE)
        res["err_f32"] = partial_check(torch, s32.driver._curv, s32.state["gas"]["w"],
                                       s32.state["gas"]["u"], DISK_F32_TOL)
        print(f"alpha_disk partial K4 (f32) vs plain on the deck's state: {res['err_f32']:.3e} "
              f"(tol {DISK_F32_TOL:g})")
        del s32

        psim = Simulation(deck, [], data, device=DEVICE, fused_stage=False)
        check(psim.driver.stage_kernel == "none", "the plain alpha_disk run took a kernel")
        warm_up(psim, 1)
        n0 = SC.stage_curv_launches
        res["plain_zcps"] = run_timed(torch, psim, ALPHA_PLAIN_CYCLES)
        check(SC.stage_curv_launches == n0, "the plain alpha_disk run launched K4")
        ksim = Simulation(deck, [], data, device=DEVICE)
        warm_up(ksim, DECK_CMP_CYCLES)
        res["end_err"] = max(rel_err(torch, ksim.state["gas"][k], psim.state["gas"][k])
                             for k in ("u", "w"))
        check(abs(ksim.tm.time - psim.tm.time) <= 1e-12 * psim.tm.time
              and res["end_err"] <= DECK_F64_TOL,
              f"alpha_disk kernel vs plain after {DECK_CMP_CYCLES} cycles: t {ksim.tm.time} vs "
              f"{psim.tm.time}, {res['end_err']:.3e} > {DECK_F64_TOL:g}")
        print(f"alpha_disk plain path: {ALPHA_PLAIN_CYCLES} cycles, {res['plain_zcps']:.6e} "
              f"zone-cycles/s (kernel path {res['zcps'] / res['plain_zcps']:.2f}x); kernel vs "
              f"plain after {DECK_CMP_CYCLES} cycles: max |diff| / max |field| "
              f"{res['end_err']:.3e} (tol {DECK_F64_TOL:g}) [{smi}]")
        del psim, ksim
        torch.cuda.empty_cache()
    return res


BINARY_CYCLES = 30


def binary_wake(sim):
    """test_binary_smoke's check: finite, positive density, and the wake
    forming (> 1e-6) at the planet's radius; returns the wake amplitude."""
    import numpy as np

    w = sim.state["gas"]["w"][0].cpu().numpy()
    d = w[0][0]
    rc = sim.grid.cell_centers()[0][0, 0]
    sig = np.abs(d - d.mean(axis=0))
    amp = float(sig[:, np.argwhere(rc >= 1.0)[0][0]].max())
    check(np.isfinite(w).all() and (d > 0).all() and amp > 1e-6,
          f"binary_cyl after {sim.tm.ncycle} cycles: finite {np.isfinite(w).all()}, "
          f"density > 0 {(d > 0).all()}, wake {amp:.3e} (> 1e-6)")
    return amp


def phase_binary(torch, smi):
    """inputs/binary_cyl.in at deck size (128x256 float64: binary gravity,
    rotating frame folded into partial K4, alpha viscosity, damping zones)
    for BINARY_CYCLES cycles, the twin of tests/test_binary.py's
    test_binary_smoke: launches counted (2 per cycle, partial, tiled
    body), its thresholds, one partial launch on the deck's end state
    against the plain version and bitwise against the per-cell body, and
    the kernel and plain end states."""
    from artemis_tpu_torch import Simulation
    from artemis_tpu_torch.ops import stage_curv as SC

    res = {}
    with tempfile.TemporaryDirectory() as data:
        sims = {}
        for fused in (True, False):
            sim = Simulation(DECKS["binary_cyl"], [f"parthenon/time/nlim={BINARY_CYCLES}"],
                             data, device=DEVICE, fused_stage=fused)
            check(sim.driver.stage_kernel == ("stage_curv (padded, partial)" if fused
                                              else "none"),
                  f"binary_cyl (fused_stage={fused}) took {sim.driver.stage_kernel}")
            SC.stage_curv_launches = SC.tiled_launches = 0
            t0 = time.perf_counter()
            sim.run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(sim.tm.ncycle == BINARY_CYCLES
                  and SC.stage_curv_launches == SC.tiled_launches
                  == (2 * BINARY_CYCLES if fused else 0),
                  f"binary_cyl (fused_stage={fused}): {SC.stage_curv_launches} launches "
                  f"({SC.tiled_launches} tiled) in {sim.tm.ncycle} cycles")
            amp = binary_wake(sim)
            if fused:
                res.update(launches=SC.stage_curv_launches, wake=amp)
            res["kernel_s" if fused else "plain_s"] = secs
            sims[fused] = sim
        k, p = sims[True], sims[False]
        res["end_err"] = max(rel_err(torch, k.state["gas"][x], p.state["gas"][x])
                             for x in ("u", "w"))
        check(abs(k.tm.time - p.tm.time) <= 1e-12 * p.tm.time
              and res["end_err"] <= DECK_F64_TOL,
              f"binary_cyl kernel vs plain after {BINARY_CYCLES} cycles: t {k.tm.time} vs "
              f"{p.tm.time}, {res['end_err']:.3e} > {DECK_F64_TOL:g}")
        res["err_f64"] = partial_check(torch, k.driver._curv, k.state["gas"]["w"],
                                       k.state["gas"]["u"], F64_TOL)
        s32 = Simulation(DECKS["binary_cyl"], ["artemis/precision=float32",
                                               "parthenon/time/nlim=0"], data, device=DEVICE)
        res["err_f32"] = partial_check(torch, s32.driver._curv, s32.state["gas"]["w"],
                                       s32.state["gas"]["u"], DISK_F32_TOL)
        print(f"binary_cyl {tuple(k.grid.nx)} f64: {res['launches']} partial K4 launches in "
              f"{BINARY_CYCLES} cycles ({res['kernel_s']:.1f} s; plain path "
              f"{res['plain_s']:.1f} s), wake {res['wake']:.3e} at r = 1 (> 1e-6); kernel vs "
              f"plain max |diff| / max |field| {res['end_err']:.3e} (tol {DECK_F64_TOL:g}); "
              f"partial K4 vs plain on the deck's state {res['err_f64']:.3e} (f64, tol "
              f"{F64_TOL:g}), {res['err_f32']:.3e} (f32, tol {DISK_F32_TOL:g}) [{smi}]")
        del sims, k, p, s32
        torch.cuda.empty_cache()
    return res


# the deck's tlim is 10: ~9,300 cycles of the launch-bound plain chain,
# 137 s on the H100; to t = 2 every species with tau <= 1 relaxes.
# tests/test_drag.py samples every 0.05 (over 100 samples to t = 10)
DRAG_TLIM = 2.0
DRAG_SAMPLE_DT = 0.05
DRAG_TAU = (1e-2, 0.1, 1.0, 10.0)
OTHER_CYCLES = 50


def phase_drag(torch, smi):
    """inputs/simple_drag.in to DRAG_TLIM (gas + 4 dust species, HLLE, the
    implicit coupling; the plain chain) with tests/test_drag.py's
    thresholds, sampled every DRAG_SAMPLE_DT as it samples: the velocity
    separations within 3e-3 of the analytic damped solution, the total x1
    momentum conserved to 1e-13, and a sample at every step of the run."""
    import math

    import numpy as np

    from artemis_tpu_torch import Simulation

    rows = []

    def sample(state, tm, every=DRAG_SAMPLE_DT):
        if tm.time >= every * (len(rows) + 1):
            vg = state["gas"]["w"][0, 1].mean()
            vsep = (state["dust"]["w"][:, 1].mean(dim=(1, 2, 3)) - vg).tolist()
            mom = float(state["gas"]["u"][0, 1].sum() + state["dust"]["u"][:, 1].sum())
            rows.append((tm.time, vsep, mom))

    with tempfile.TemporaryDirectory() as data:
        sim = Simulation(DECKS["simple_drag"], [f"parthenon/time/tlim={DRAG_TLIM:.8f}"], data,
                         device=DEVICE)
        check(sim.driver.stage_kernel == "none", f"simple_drag took {sim.driver.stage_kernel}")
        t0 = time.perf_counter()
        sim.run(extra_observers=[sample])
        secs = time.perf_counter() - t0
    eps = 0.01 / 10.0
    errs = [abs(v[d] - math.exp(-(1.0 + eps) * t / DRAG_TAU[d]) * -1.0)
            for t, v, _ in rows for d in range(4)]
    moms = np.array([m for _, _, m in rows])
    err, drift = max(errs), float(np.abs(moms / moms[0] - 1.0).max())
    nsamples = int(round(DRAG_TLIM / DRAG_SAMPLE_DT))
    check(len(rows) >= nsamples - 1 and err <= 3e-3 and drift <= 1e-13,
          f"simple_drag to t={DRAG_TLIM}: {len(rows)} samples (>= {nsamples - 1}), max err "
          f"{err:.3e} (<= 3e-3), "
          f"momentum drift {drift:.3e} (<= 1e-13)")
    print(f"simple_drag f64 to t={DRAG_TLIM}: {sim.tm.ncycle} cycles in {secs:.1f} s "
          f"({ncells(sim.grid) * sim.tm.ncycle / secs:.6e} zone-cycles/s), max drag error "
          f"{err:.3e} (<= 3e-3), momentum drift {drift:.3e} (<= 1e-13) [{smi}]")
    return {"err": err, "drift": drift, "ncycle": sim.tm.ncycle, "secs": secs}


def deck_pair(torch, name, overrides, kernel, counter, per_cycle):
    """The deck through the kernel path and the plain path for
    OTHER_CYCLES each, the launches of ``counter`` (a module and its count's
    name) reset before and read after each: per_cycle per cycle on the
    kernel path, none on the plain one.  Returns (launches, max |diff| /
    max(1, |field|) per component of the end states, the two runs'
    seconds)."""
    from artemis_tpu_torch import Simulation

    mod, attr = counter
    out, sims = {}, {}
    with tempfile.TemporaryDirectory() as data:
        for fused in (True, False):
            sim = Simulation(DECKS[name], overrides + [f"parthenon/time/nlim={OTHER_CYCLES}"],
                             data, device=DEVICE, fused_stage=fused)
            check(sim.driver.stage_kernel == (kernel if fused else "none"),
                  f"{name} (fused_stage={fused}) took {sim.driver.stage_kernel}")
            setattr(mod, attr, 0)
            t0 = time.perf_counter()
            sim.run()
            torch.cuda.synchronize()
            out["kernel_s" if fused else "plain_s"] = time.perf_counter() - t0
            got = getattr(mod, attr)
            check(sim.tm.ncycle == OTHER_CYCLES
                  and got == (per_cycle * OTHER_CYCLES if fused else 0)
                  and bool(torch.isfinite(sim.state["gas"]["u"]).all()),
                  f"{name} (fused_stage={fused}): {got} launches in {sim.tm.ncycle} cycles")
            if fused:
                out["launches"] = got
            sims[fused] = sim
        k, p = sims[True], sims[False]
        out["shape"] = tuple(k.grid.nx)
        out["end_err"] = max(scaled_err(torch, k.state["gas"][x], p.state["gas"][x])
                             for x in ("u", "w"))
        check(abs(k.tm.time - p.tm.time) <= 1e-12 * p.tm.time
              and out["end_err"] <= DECK_F64_TOL,
              f"{name} kernel vs plain after {OTHER_CYCLES} cycles: t {k.tm.time} vs "
              f"{p.tm.time}, {out['end_err']:.3e} > {DECK_F64_TOL:g}")
    return out


def phase_other_decks(torch, smi):
    """conduction.in and gaussian_bump.in for OTHER_CYCLES cycles through the
    sweep kernel (K9: one launch per active direction per stage); blast.in
    as written, whose HLLE source-free Cartesian stage the driver gives the
    padded curvilinear stage (K4, full, on its outflow walls), as the JAX
    driver gives it in float32; and blast.in with gas/riemann=hllc through
    the padded Cartesian stage (K2); one launch per stage of each; each
    kernel path against the plain path's end state."""
    from artemis_tpu_torch.ops import stage as S, stage_curv as SC, sweeps as SW

    res = {}
    for name, over, kernel, counter, per_cycle in (
            ("conduction", [], "sweep", (SW, "sweep_launches"), 2),
            ("gaussian_bump", [], "sweep", (SW, "sweep_launches"), 4),
            ("blast", [], "stage_curv (padded)", (SC, "stage_curv_launches"), 2),
            ("blast", ["gas/riemann=hllc"], "stage_cart", (S, "stage_launches"), 2)):
        key = name + ("_hllc" if over else "")
        r = deck_pair(torch, name, over, kernel, counter, per_cycle)
        res[key] = r
        print(f"{key} {r['shape']} f64: {r['launches']} {kernel} launches in {OTHER_CYCLES} "
              f"cycles ({r['kernel_s']:.1f} s; plain path {r['plain_s']:.1f} s); kernel vs "
              f"plain max |diff| / max(1, |field|) {r['end_err']:.3e} (tol {DECK_F64_TOL:g}) "
              f"[{smi}]")
    return res

# the four N-body decks as written (float64, the decks' precision): cycles
# through Simulation.run, and the stage kernel the driver must pick on the
# card (cb_disk's LLF solver is outside every stage kernel's envelope: the
# plain chain, as the JAX driver runs it)
PARTIAL_K4 = "stage_curv (padded, partial)"
NBODY_DECKS = (("binary_nbody_cyl", 40, PARTIAL_K4), ("cb_disk", 20, "none"),
               ("disk_collision", 20, PARTIAL_K4), ("disk_nbody_cyl", 20, PARTIAL_K4))
NBODY_INPUT_FILES = {"disk_collision": "n20_sys.txt", "disk_nbody_cyl": "n4_sys.txt"}
NBODY_SMOKE_CYCLES = 20      # tests/test_nbody.py's test_nbody_smoke
NBODY_CMP_CYCLES = 5
# the particles of the kernel and plain runs, max |diff| of positions and
# velocities: tests/test_torch_nbody.py's tolerance against the JAX package
NBODY_PARTICLE_TOL = 1e-12


def nbody_sim(name, overrides, data, **kw):
    """An N-body deck through the user entry point (its planet file, where
    it has one, named by its path in the checkout)."""
    from artemis_tpu_torch import Simulation

    over = list(overrides)
    if name in NBODY_INPUT_FILES:
        over.append("nbody/planets/input_file="
                    + os.path.join(HERE, "inputs", "planet_inputs", NBODY_INPUT_FILES[name]))
    return Simulation(os.path.join(HERE, "inputs", f"{name}.in"), over, data, device=DEVICE,
                      **kw)


def particle_err(a, b):
    return max(float(abs(getattr(a, k) - getattr(b, k)).max()) for k in ("pos", "vel"))


def nbody_smoke_check(torch, sim):
    """test_nbody_smoke's checks: every particle alive, the planet's
    separation within 1e-3 of 1, the gas finite with positive density."""
    import numpy as np

    w = sim.state["gas"]["w"]
    sep = float(np.linalg.norm(sim.nbody.pos[1] - sim.nbody.pos[0]))
    check(bool(sim.nbody.alive.all()) and abs(sep - 1.0) < 1e-3
          and bool(torch.isfinite(w).all()) and bool((w[:, 0] > 0).all()),
          f"binary_nbody_cyl at cycle {sim.tm.ncycle}: alive {sim.nbody.alive}, "
          f"separation {sep:.6f}, gas finite/positive failed")
    return sep


def nbody_deck(torch, smi, name, ncycles, kernel, data):
    """One N-body deck: the main path through Simulation.run for
    ``ncycles`` with the kernel counts set to 0 before and read after (2
    partial K4 launches per cycle, none on the tiled body, no sweep), the
    host time of the particle advance per stage, zone-cycles/s, the kernel
    and plain end states after NBODY_CMP_CYCLES and the plain path's
    zone-cycles/s."""
    from artemis_tpu_torch.ops import stage_curv as SC, sweeps as SW

    res = {"kernel": kernel}
    sim = nbody_sim(name, [f"parthenon/time/nlim={ncycles}"], data)
    d, nb = sim.driver, sim.nbody
    check(d.stage_kernel == kernel and d.host_coupled and sim.dtype == torch.float64,
          f"{name} took {d.stage_kernel} (host-coupled {d.host_coupled}, {sim.dtype})")
    host = []
    advance = nb.advance

    def timed_advance(*a, **k):
        t0 = time.perf_counter()
        advance(*a, **k)
        host.append(time.perf_counter() - t0)

    smoke = {}

    def at_smoke_cycle(state, tm):
        if name == "binary_nbody_cyl" and tm.ncycle == NBODY_SMOKE_CYCLES:
            sim.state = state
            smoke["sep"] = nbody_smoke_check(torch, sim)

    nb.advance = timed_advance
    SC.stage_curv_launches = SC.tiled_launches = SW.sweep_launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sim.run(extra_observers=[at_smoke_cycle])
    end.record()
    torch.cuda.synchronize()
    del nb.advance
    secs = start.elapsed_time(end) / 1e3
    res.update(launches=SC.stage_curv_launches, cycle_ms=1e3 * secs / ncycles,
               zcps=ncells(sim.grid) * ncycles / secs,
               host_ms_per_stage=1e3 * sum(host) / max(len(host), 1), npart=nb.npart,
               alive=int(nb.alive.sum()), shape=tuple(sim.grid.nx), **smoke)
    want = 2 * ncycles if kernel == PARTIAL_K4 else 0
    check(sim.tm.ncycle == ncycles and sim.status == "complete"
          and res["launches"] == want == SC.tiled_launches and SW.sweep_launches == 0
          and len(host) == 2 * ncycles,
          f"{name}: {res['launches']} partial K4 launches ({SC.tiled_launches} tiled, "
          f"{SW.sweep_launches} sweeps) and {len(host)} particle advances in "
          f"{sim.tm.ncycle} cycles, wanted {want} and {2 * ncycles}")
    w = sim.state["gas"]["w"]
    check(bool(torch.isfinite(sim.state["gas"]["u"]).all()) and bool((w[:, 0] > 0).all()),
          f"{name} after {ncycles} cycles: gas not finite or density not positive")
    if name == "binary_nbody_cyl":
        check("sep" in smoke, "binary_nbody_cyl: the smoke checks did not run at cycle 20")
        res["end_sep"] = nbody_smoke_check(torch, sim)
    res["sim"] = sim

    runs = {}
    for fused in (True, False):
        r = nbody_sim(name, [f"parthenon/time/nlim={NBODY_CMP_CYCLES}"], data, fused_stage=fused)
        check(r.driver.stage_kernel == (kernel if fused else "none"),
              f"{name} (fused_stage={fused}) took {r.driver.stage_kernel}")
        n0 = SC.stage_curv_launches
        res["kernel_cmp_zcps" if fused else "plain_zcps"] = run_timed(torch, r, NBODY_CMP_CYCLES)
        check(fused or SC.stage_curv_launches == n0, f"the plain {name} run launched K4")
        runs[fused] = r
    k, p = runs[True], runs[False]
    res["end_err"] = max(rel_err(torch, k.state["gas"][x], p.state["gas"][x]) for x in ("u", "w"))
    res["particle_err"] = particle_err(k.nbody, p.nbody)
    check(abs(k.tm.time - p.tm.time) <= 1e-12 * p.tm.time and res["end_err"] <= DECK_F64_TOL
          and res["particle_err"] <= NBODY_PARTICLE_TOL,
          f"{name} kernel vs plain after {NBODY_CMP_CYCLES} cycles: t {k.tm.time} vs "
          f"{p.tm.time}, fields {res['end_err']:.3e} (tol {DECK_F64_TOL:g}), particles "
          f"{res['particle_err']:.3e} (tol {NBODY_PARTICLE_TOL:g})")
    print(f"{name} {res['shape']} f64, {nb.npart} particles ({res['alive']} alive): stage "
          f"kernel {kernel!r}, {res['launches']} launches in {ncycles} cycles through "
          f"Simulation.run; cycle {res['cycle_ms']:.4f} ms, {res['zcps']:.6e} zone-cycles/s "
          f"(plain path {res['plain_zcps']:.6e}); particle advance on the host "
          f"{res['host_ms_per_stage']:.4f} ms a stage; kernel vs plain after "
          f"{NBODY_CMP_CYCLES} cycles: fields {res['end_err']:.3e} (tol {DECK_F64_TOL:g}), "
          f"particles {res['particle_err']:.3e} (tol {NBODY_PARTICLE_TOL:g}) [{smi}]")
    del runs, k, p
    return res


def reb_mass_check(sim, data, pid):
    """The .reb file with a last row written now: the total mass of the
    active particles against the first row's, relative."""
    sys.path.insert(0, os.path.join(HERE, "analysis"))
    from anbody import areb

    sim.nbody.write_outputs(data, pid, sim.tm.time)
    r = areb(os.path.join(data, f"{pid}.reb"))
    m0 = float(r.col("mass")[0].sum())
    m1 = float((r.col("mass")[-1] * r.col("active")[-1]).sum())
    drift = abs(m1 - m0) / m0
    check(r.rdata.shape[0] >= 2 and drift <= 1e-12,
          f"{pid}.reb: {r.rdata.shape[0]} outputs, mass drift {drift:.3e} (<= 1e-12)")
    return r.rdata.shape[0], int(r.col("active")[-1].sum()), drift


def phase_nbody(torch, smi):
    """The four N-body decks as written in float64 through Simulation.run
    (NBODY_DECKS): binary_nbody_cyl (40 cycles), disk_collision and
    disk_nbody_cyl on partial K4, cb_disk on the plain chain; per deck the
    stage kernel, its launches, cycle ms, zone-cycles/s of the kernel and
    plain paths, the host time of the particle advance per stage, and the
    kernel and plain end states after NBODY_CMP_CYCLES. binary_nbody_cyl:
    test_nbody_smoke's checks at cycle 20, partial K4 against its plain
    stage on the deck's state (f64 1e-12) and its time per launch against
    the plain stage and the bound. Every deck: the cycle's device busy time
    and idle share under torch.profiler (3 cycles), split into K4 and the
    sources. disk_collision: its .reb file, the total mass of the active
    particles conserved to 1e-12."""
    res = {}
    with tempfile.TemporaryDirectory() as data:
        for name, ncycles, kernel in NBODY_DECKS:
            d = os.path.join(data, name)
            os.makedirs(d)
            r = nbody_deck(torch, smi, name, ncycles, kernel, d)
            sim = r.pop("sim")
            srcs = sim.driver._curv_srcs if kernel == PARTIAL_K4 else sim.driver.sources
            prof = profile_split(torch, sim, 3, {"sources": [(s_, "apply") for s_ in srcs]},
                                 {"K4 partial": PARTIAL_KERNEL})
            r["busy_ms"] = prof["busy_ms"] if prof else None
            r["split"] = prof["split"] if prof else None
            r["idle_share"] = 1.0 - prof["busy_ms"] / r["cycle_ms"] if prof else None
            print(f"{name} cycle {r['cycle_ms']:.4f} ms: " + (
                f"device busy {r['busy_ms']:.4f} ms (K4 {r['split']['K4 partial']:.4f}, the "
                f"sources{' after it' if kernel == PARTIAL_K4 else ''} "
                f"{r['split']['sources']:.4f}), idle {100 * r['idle_share']:.1f}%" if prof
                else "device busy not measured") + f" [{smi}]")
            if name == "binary_nbody_cyl":
                cs = sim.driver._curv
                u, w = sim.state["gas"]["u"], sim.state["gas"]["w"]
                r["err_f64"] = partial_check(torch, cs, w, u, F64_TOL)
                dt = torch.full((1,), sim.tm.dt, dtype=u.dtype, device=DEVICE)
                r.update(partial_timings(torch, cs, w, u, u.clone(), dt, sim.tm.time))
                print(f"binary_nbody_cyl partial K4 per launch (f64): tiled body {r['ms']:.4f} "
                      f"ms, with its ic fill {r['stage_ms']:.4f} ms; per-cell body "
                      f"{r['percell_ms']:.4f} ms, {r['percell_stage_ms']:.4f} ms; plain stage "
                      f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms ({r['mb']:.2f} MB, {r['bound_by']}-"
                      f"bound); vs plain on the deck's state {r['err_f64']:.3e} (tol "
                      f"{F64_TOL:g}); planet separation {r['sep']:.6f} at cycle 20 [{smi}]")
            if name == "disk_collision":
                r["reb_outputs"], r["reb_active"], r["reb_mass_drift"] = reb_mass_check(
                    sim, d, "collisions")
                print(f"disk_collision .reb: {r['reb_outputs']} outputs, {r['reb_active']} "
                      f"active at the end, mass drift {r['reb_mass_drift']:.3e} (<= 1e-12)")
            res[name] = r
            del sim
            torch.cuda.empty_cache()
    return res


RESTART_AMR = (6, 3)          # the AMR case's cycles straight, and its checkpoint cycle
RESTART_DISK = ("parthenon/mesh/nx1=256", "parthenon/mesh/nx2=64", "parthenon/mesh/nx3=64",
                "artemis/precision=float32")


def restart_case(torch, smi, label, make, ncycles, k, kernel, counters, data, built=None):
    """``ncycles`` straight through Simulation.run, a checkpoint written at
    cycle ``k`` by an observer (the same write as the rst output's), and a
    second Simulation resumed from it for ``ncycles - k``: every array of
    the end state (u, w, dtden, Er; on a tree every node's), the time, dt
    and the particles torch.equal / equal. ``counters`` (module, count)
    must each count launches in both runs.  ``built``: the straight run's
    Simulation, made beforehand off the main thread."""
    import numpy as np

    res = {}
    b_dir = os.path.join(data, "b")
    a = built if built is not None else make([f"parthenon/time/nlim={ncycles}"],
                                             os.path.join(data, "a"))
    a_dir = a.data_dir
    check(a.driver.stage_kernel == kernel, f"{label} took {a.driver.stage_kernel}")
    ck = {}

    def checkpoint(state, tm):
        if tm.ncycle == k:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck["path"] = a.write_restart(os.path.join(a_dir, "ck"), state=state, tm=tm)
            ck["write_ms"] = 1e3 * (time.perf_counter() - t0)

    launches = {}
    for mod, attr in counters:
        setattr(mod, attr, 0)
    a.run(extra_observers=[checkpoint])
    launches["straight"] = {attr: getattr(mod, attr) for mod, attr in counters}
    check(a.tm.ncycle == ncycles and "path" in ck, f"{label}: straight run or checkpoint failed")
    res["mb"] = os.path.getsize(ck["path"]) / 1e6
    res["write_ms"] = ck["write_ms"]
    extra = (["parthenon/output2/file_type=hdf5", "parthenon/output2/dt=1.0e9"]
             if label == "binary_nbody_cyl" else [])
    b = make([f"parthenon/time/nlim={ncycles}", *extra], b_dir, restart=ck["path"])
    check(b.tm.ncycle == k and b.tm.restored, f"{label}: resumed at cycle {b.tm.ncycle}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b._load_restart(ck["path"])
    torch.cuda.synchronize()
    res["load_ms"] = 1e3 * (time.perf_counter() - t0)
    for mod, attr in counters:
        setattr(mod, attr, 0)
    b.run()
    launches["resumed"] = {attr: getattr(mod, attr) for mod, attr in counters}
    res["launches"] = launches
    check(all(n > 0 for run in launches.values() for n in run.values()),
          f"{label}: a kernel of the path was not launched: {launches}")
    same = [(b.tm.ncycle, b.tm.time, b.tm.dt) == (a.tm.ncycle, a.tm.time, a.tm.dt)]
    states = ([(b.state, a.state)] if not hasattr(a.driver, "smr")
              else list(zip(b.driver._states, a.driver._states)))
    keys = sorted({(f, x) for st, _ in states for f in st for x in st[f]})
    for sb, sa in states:
        check(sorted((f, x) for f in sb for x in sb[f])
              == sorted((f, x) for f in sa for x in sa[f]),
              f"{label}: the resumed state holds other arrays than the straight one")
        same += [torch.equal(sb[f][x], sa[f][x]) for f in sa for x in sa[f]]
    if a.nbody is not None:
        same += [np.array_equal(getattr(b.nbody, x), getattr(a.nbody, x))
                 for x in ("m", "pos", "vel", "alive", "pforce_step", "pforce_tot")]
    res["bitwise"] = all(same)
    res["arrays"] = [f"{f}.{x}" for f, x in keys]
    check(res["bitwise"], f"{label}: the resumed run is not bitwise the straight run "
          f"({same.count(False)} of {len(same)} comparisons differ)")
    if extra:
        sys.path.insert(0, os.path.join(HERE, "analysis"))
        from adump import adump

        pid = b.pin.get_str("parthenon/job", "problem_id")
        dump = adump(os.path.join(b_dir, f"{pid}.out2.final.npz"))
        w = b.state["gas"]["w"].cpu().numpy()
        names = ("density", "velocity_x1", "velocity_x2", "velocity_x3", "pressure", "sie")
        check(dump.time == b.tm.time and all(
            np.array_equal(dump.Get(f"gas.prim.{n}")[0], w[0, c]) for c, n in enumerate(names)),
            f"{label}: the hdf5 dump read by analysis/adump.py differs from the state")
        res["adump"] = True
    print(f"restart {label}: {ncycles} cycles straight and {k} + checkpoint + {ncycles - k} "
          f"resumed on {kernel!r}: bitwise equal ({', '.join(res['arrays'])}, time, dt"
          f"{', particles' if a.nbody is not None else ''}); checkpoint {res['mb']:.2f} MB, "
          f"written in {res['write_ms']:.1f} ms, loaded in {res['load_ms']:.1f} ms; launches "
          f"{launches}{'; hdf5 dump read by adump equals the state' if extra else ''} [{smi}]")
    del a, b
    torch.cuda.empty_cache()
    return res


def phase_restart(torch, smi, built_amr):
    """Bitwise restarts on the card in three cases: disk_sph at 256x64x64
    float32 on K3 (the dtden carry; N = 10, k = 6), binary_nbody_cyl as
    written on partial K4 with the nbody payload (N = 10, k = 6; its hdf5
    dump read back with analysis/adump.py) and the equal-shape AMR RHD cell
    on K6/K7/K8 with the amr.* payloads (N = 6, k = 3); then the CLI in a
    subprocess: -t with a tiny walltime exits 2 leaving the walltime
    checkpoint, and -r on it runs to nlim and exits 0.  ``built_amr``: the
    AMR case's straight run, set up beside phase 15."""
    from artemis_tpu_torch import Simulation
    from artemis_tpu_torch.ops import fld as FLD, stage_curv as SC

    res = {}
    cases = (
        ("disk_sph", lambda ov, d, **kw: Simulation(DISK["disk_sph"], [*RESTART_DISK, *ov], d,
                                                   device=DEVICE, **kw),
         10, 6, "stage_curv (gather)", [(SC, "stage_curv_launches")]),
        ("binary_nbody_cyl", lambda ov, d, **kw: nbody_sim("binary_nbody_cyl", ov, d, **kw),
         10, 6, PARTIAL_K4, [(SC, "stage_curv_launches")]),
        ("amr", lambda ov, d, **kw: amr_sim(d, AMR_CELL, 2.0, extra=ov, **kw),
         *RESTART_AMR, "stage_curv_batched (2 nodes, gather6)",
         [(SC, "stage_curv_batched_launches"), (FLD, "fld_coeffs_launches"),
          (FLD, "fld_matvec_launches")]))
    for label, make, n, k, kernel, counters in cases:
        with tempfile.TemporaryDirectory() as data:
            res[label] = restart_case(torch, smi, label, make, n, k, kernel, counters, data,
                                      built=built_amr if label == "amr" else None)
    with tempfile.TemporaryDirectory() as data:
        small = ["parthenon/mesh/nx1=16", "parthenon/mesh/nx2=8", "parthenon/mesh/nx3=8",
                 "parthenon/time/nlim=4"]
        cmd = [sys.executable, "-m", "artemis_tpu_torch.cli", "-i", DECK, "-d", data]
        first = subprocess.run(cmd + ["-t", "1e-9", *small], cwd=HERE, capture_output=True,
                               text=True, timeout=300)
        ck = os.path.join(data, "linear_wave.walltime.final.rst.npz")
        check(first.returncode == 2 and os.path.exists(ck),
              f"CLI -t 1e-9: exit {first.returncode}, checkpoint {os.path.exists(ck)}\n"
              f"{first.stdout[-2000:]}{first.stderr[-2000:]}")
        second = subprocess.run(cmd + ["-r", ck, *small], cwd=HERE, capture_output=True,
                                text=True, timeout=300)
        check(second.returncode == 0 and "ncycle=4" in second.stdout
              and "complete" in second.stdout,
              f"CLI -r: exit {second.returncode}\n{second.stdout[-2000:]}{second.stderr[-2000:]}")
        res["cli"] = {"timeout_rc": first.returncode, "restart_rc": second.returncode}
        print("CLI: -t 1e-9 exited 2 with linear_wave.walltime.final.rst.npz; -r on it ran to "
              "nlim = 4 and exited 0")
    return res


# -- phase 26 ------------------------------------------------------------
BLAST_AMR = os.path.join(HERE, "inputs", "blast_amr.in")
SEDOV2D = os.path.join(HERE, "tests", "data", "sedov2d.dat")
PADDED_PER_NODE = "stage_curv per node (padded)"
GATHER6_PER_NODE = "stage_curv per node (gather6)"
# bench.py:207-231: the tiled AMR disk RHD (its root, the magnitude
# criterion at 0.3, 64x64x32 tiles, a regrid every 25 cycles)
ADAPT_RHD = (512, 512, 64)
ADAPT_TILE = (64, 64, 32)
ADAPT_CHECK = 25
ADAPT_CYCLES = 25
ADAPT_SEQ_CYCLES = 3              # a window of the tiled RHD on either radiation pass
ADAPT_SMALL = (128, 128, 32)      # the kernel-vs-plain check
ADAPT_SMALL_TILE = (32, 32, 16)
ADAPT_SMALL_CYCLES = 4
ADAPT_TOL = 1e-10                 # blast_amr f64: kernel vs plain end states
ADAPT_RESTART = (20, 10)          # the main run's checkpoint cycle, cycles resumed


def adaptive_ov(tile, check):
    return ["parthenon/mesh/refinement=adaptive", "gas/refine_field=density",
            "gas/refine_type=magnitude", "gas/refine_thr=0.3",
            f"parthenon/refinement/check_interval={check}",
            *(f"parthenon/refinement/tile_nx{d + 1}={t}" for d, t in enumerate(tile))]


def blast_amr_sim(data, extra=(), fused=True, restart=None):
    """inputs/blast_amr.in as written (tiled, numlevel 2, float64) on the card."""
    from artemis_tpu_torch import Simulation

    return Simulation(BLAST_AMR, list(extra), data, device=DEVICE, fused_stage=fused,
                      restart=restart)


def tree_run(torch, sim, extra_observers=()):
    """Simulation.run with the stage counts set to 0 before and read after;
    after every cycle (so after every regrid) the node rows, the node count
    and the stage path.  Returns those and the wall seconds."""
    from artemis_tpu_torch.ops import stage_curv as SC
    from artemis_tpu_torch.state import tree_rows

    smr = sim.driver.smr
    rec = {"rows": [tree_rows(smr.nodes)], "nodes": [len(smr.nodes)],
           "kernels": [sim.driver.stage_kernel]}

    def observe(state, tm):
        rec["rows"].append(tree_rows(smr.nodes))
        rec["nodes"].append(len(smr.nodes))
        rec["kernels"].append(sim.driver.stage_kernel)

    SC.stage_curv_launches = SC.stage_curv_batched_launches = SC.tiled_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(extra_observers=[observe, *extra_observers])
    torch.cuda.synchronize()
    rec["secs"] = time.perf_counter() - t0
    rec["launches"] = SC.stage_curv_launches
    rec["batched"] = SC.stage_curv_batched_launches
    rec["tiled"] = SC.tiled_launches
    check(sim.status == "complete", f"{sim.pin.get_str('parthenon/job', 'problem_id')} did "
          f"not complete: {sim.status}")
    return rec


def root_mass(sim):
    smr = sim.driver.smr
    return float((smr.root.hydro.vol * sim.state["gas"]["u"][0, 0]).sum())


def sedov_l2(sim):
    """Pressure L2 of the root against tests/data/sedov2d.dat about the
    deck's blast centre (tests/test_amr_adaptive.py's gate, < 1)."""
    import numpy as np

    dat = np.loadtxt(SEDOV2D, comments="#")
    pres = sim.state["gas"]["w"][0, 4, 0].double().cpu().numpy()
    x1v, x2v, _ = sim.grid.cell_centers()
    rr = np.broadcast_to(np.sqrt((x1v + 0.2) ** 2 + (x2v + 0.2) ** 2)[0], pres.shape)
    inb = rr <= dat[:, 0].max()
    pans = np.interp(np.clip(rr, dat[0, 0], dat[:, 0].max()), dat[:, 0], dat[:, 3])
    return float(np.sqrt(((pres - pans)[inb] ** 2).mean()))


def node_field_err(torch, a_states, b_states):
    """max over nodes and fields (u, w, Er) of max |a - b| / max |b|."""
    worst = 0.0
    for a, b in zip(a_states, b_states):
        for fl, kinds in b.items():
            for k, t in kinds.items():
                if k != "dtden":
                    y = t.double()
                    worst = max(worst, float((a[fl][k].double() - y).abs().max()
                                             / y.abs().max().clamp_min(1e-300)))
    return worst


def clone_states(states):
    return [{fl: {kk: t.clone() for kk, t in kinds.items()} for fl, kinds in st.items()}
            for st in states]


def rows_same(a, b):
    return len(a) == len(b) and all(x.shape == y.shape and (x == y).all() for x, y in zip(a, b))


def tile_vs_plain(torch, sim):
    """One tile of a tiled RHD tree whose strips carry sibling data, on its
    own state, kernel against plain on the same inputs: its six-face stage
    (K5b) from the strips the tree builds for it, both RK register
    patterns, at DISK_F32_TOL; its FLD set-up (K7) and one matvec (K8)
    from the flags its Dirichlet ghost planes set, at FLD_TOL."""
    from artemis_tpu_torch.ops import stage_curv as SC

    smr = sim.driver.smr
    states = sim.driver._states
    node = next((nd for nd in smr.nodes[1:] if smr._sib_links[nd.index]), None)
    check(node is not None, "tiled RHD: no tile with sibling links")
    i, par = node.index, node.parent.index
    ws = [st["gas"]["w"] for st in states]
    strips, _ = node.ghost_strips(ws[par], node.lo, sib_links=smr._sib_links[i], sib_arrs=ws)
    cs, w, u = smr._fused[i], ws[i], states[i]["gas"]["u"]
    dt1 = torch.full((1,), sim.tm.dt, dtype=u.dtype, device=DEVICE)
    stage_err = 0.0
    for g in RK2:
        kern = SC.stage_curv(cs, w, u, u.clone(), *g, dt1, sim.tm.time, False, strips=strips)
        ref = SC.stage_curv_batched_reference([cs], [w], [u], [u.clone()], [strips], *g, dt1,
                                              sim.tm.time, False)[0]
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in kern[:2]),
              f"tiled RHD tile {i}: K5b gave non-finite values")
        stage_err = max(stage_err, *(float((a - b).abs().max())
                                     for a, b in zip(kern[:2], ref[:2])))
    check(stage_err <= DISK_F32_TOL,
          f"tiled RHD tile {i} {node.grid.nx}: K5b vs plain {stage_err:.3e} > {DISK_F32_TOL:g}")
    gh = smr._rad_ghost_planes(node, states[par]["rad"]["Er"],
                               [st["rad"]["Er"] for st in states])
    args, sf = fld_inputs(torch, node.radiation, states[i], sim.tm.dt, ghosts=gh)
    pairs = fld_pairs(torch, *args, sf)
    coeffs_err, matvec_err = errs(pairs[:3]), errs(pairs[3:])
    check(max(coeffs_err[1], matvec_err[1]) <= FLD_TOL["float32"],
          f"tiled RHD tile {i}: K7 / K8 vs plain relative {coeffs_err[1]:.3e} / "
          f"{matvec_err[1]:.3e} > {FLD_TOL['float32']:g}")
    return {"node": i, "shape": list(node.grid.nx), "links": len(smr._sib_links[i]),
            "flags": [list(f) for f in args[-1]], "stage_err": stage_err,
            "coeffs_err": coeffs_err, "matvec_err": matvec_err}


def adaptive_blast3(torch):
    """blast_amr.in at numlevel 3 to tlim 0.05 on K4 per node: the launches
    per node a cycle, the levels, the root's mass drift (< 1e-8)."""
    from artemis_tpu_torch.state import tree_rows

    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory() as data:
        sim = blast_amr_sim(os.path.join(data, "n3"), ["parthenon/mesh/numlevel=3",
                                                       "parthenon/time/tlim=0.05"])
        m0 = root_mass(sim)
        k3 = tree_run(torch, sim)
        drift = abs(root_mass(sim) - m0) / m0
        levels = sorted({int(r[0]) for r in tree_rows(sim.driver.smr.nodes)})
        check(drift < 1e-8 and levels == [1, 2]
              and all(s == PADDED_PER_NODE for s in k3["kernels"])
              and k3["launches"] == 2 * sum(k3["nodes"][:-1]),
              f"blast_amr numlevel 3: drift {drift:.3e}, levels {levels}, launches "
              f"{k3['launches']}")
        res = {"ncycle": sim.tm.ncycle, "launches": k3["launches"], "drift": drift,
               "part_s": time.perf_counter() - t_part,
               "nodes": [k3["nodes"][0], max(k3["nodes"])],
               "cycle_ms": 1e3 * k3["secs"] / sim.tm.ncycle}
        print(f"blast_amr numlevel 3 to t = 0.05: {sim.tm.ncycle} cycles, nodes "
              f"{k3['nodes'][0]} -> {max(k3['nodes'])}, {k3['launches']} K4 launches, "
              f"{res['cycle_ms']:.3f} ms a cycle (beside rad_shock), mass drift {drift:.3e} "
              "(gate 1e-8)")
        del sim
    return res


def window_ms(torch, sim, ncycles, sequential=False):
    """ms a cycle over ``ncycles`` of the evolution loop (CUDA events); with
    ``sequential`` the tree's radiation pass solves every node alone (the
    private keyword, set on the instance for the window only)."""
    from artemis_tpu_torch.driver import evolve

    smr = sim.driver.smr
    if sequential:
        smr._radiation_pass = functools.partial(type(smr)._radiation_pass, smr,
                                                _sequential=True)
    sim.tm.nlim = sim.tm.ncycle + ncycles
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        torch.cuda.synchronize()
        start.record()
        sim.state, sim.tm, _, status = evolve(sim.driver, sim.state, sim.tm)
        end.record()
        torch.cuda.synchronize()
    finally:
        if sequential:
            del smr._radiation_pass
    check(status == "complete", f"{ncycles} cycles stopped: {status}")
    return start.elapsed_time(end) / ncycles


def rad_pass_recorder(smr):
    """Wraps the tree's ``_radiation_pass`` (on the instance) to record, per
    pass, each node's (level, grid, is the root, CG iterations per outer)
    and the host reads of its loop tests; returns (records, undo)."""
    from artemis_tpu_torch import profiling

    orig = smr._radiation_pass
    recs = []

    def recorded(states, dt, **kw):
        reads = profiling.host_reads
        out = orig(states, dt, **kw)
        recs.append({"nodes": [(nd.level, tuple(nd.grid.nx), nd.parent is None,
                                list(nd.radiation.cg_iters)) for nd in smr.nodes],
                     "reads": profiling.host_reads - reads})
        return out

    smr._radiation_pass = recorded
    return recs, lambda: delattr(smr, "_radiation_pass")


def batched_fld_launches(nodes):
    """(K7, K8, node-axis K7, node-axis K8) launches that one batched pass
    over a tiled pool's ``nodes`` (rad_pass_recorder's rows; every patch
    Cartesian, unsharded, no wrap axis) makes: one K7 per solve (the root,
    each group of same-shape patches of a level, on the node axis where it
    holds two or more), and in each Newton outer of a solve 1 + the most
    CG iterations of the members whose Newton loop runs in it."""
    groups = {}
    for level, nx, root, its in nodes:
        groups.setdefault("root" if root else (level, nx), []).append(its)
    k7 = k8 = n7 = n8 = 0
    for members in groups.values():
        mv = sum(1 + max(m[k] for m in members if len(m) > k)
                 for k in range(max(len(m) for m in members)))
        k7, k8 = k7 + 1, k8 + mv
        if len(members) > 1:
            n7, n8 = n7 + 1, n8 + mv
    return k7, k8, n7, n8


def pool_group_timings(torch, sim):
    """The tiled pool's largest group of same-shape tiles on its own state:
    node-axis K7 and K8 against their bounds, the same nodes as one-node
    launches, the plain versions on the stack and K8's operator as one
    block-diagonal CSR SpMV; the stacking of the group's fields; and one
    radiation pass batched against the sequential loop on a clone of the
    tree's state (every node's fields within DISK_F32_TOL of each array's
    max, every node's CG counts equal)."""
    from artemis_tpu_torch import profiling
    from artemis_tpu_torch.ops import fld as FLD

    drv, smr = sim.driver, sim.driver.smr
    states = drv._states
    by_shape = {}
    for nd in smr.nodes[1:]:
        by_shape.setdefault((nd.level, tuple(nd.grid.nx)), []).append(nd)
    members = max(by_shape.values(), key=len)
    n = len(members)
    check(n >= 2, f"tiled RHD: no two tiles of one shape ({sorted(by_shape)})")
    faces = {d: (True, True) for d in (1, 2, 3)}
    ins = [fld_inputs(torch, nd.radiation, states[nd.index], sim.tm.dt, ghosts=faces)
           for nd in members]
    E, chi = (torch.stack([a[k] for a, _ in ins]) for k in (0, 1))
    sf = torch.stack([f for _, f in ins])
    dt, const = ins[0][0][2], ins[0][0][3:]
    cargs = (E, chi, dt, *const)
    del ins
    out = {"nodes": n, "shape": list(members[0].grid.nx)}
    kc = FLD.fld_coeffs(*cargs)
    km = FLD.fld_matvec(E, kc[0], kc[1], sf)
    pc = FLD.fld_coeffs_reference(*cargs)
    pm = FLD.fld_matvec_reference(E, kc[0], kc[1], sf)
    torch.cuda.synchronize()
    out["coeffs_err"], out["matvec_err"] = errs(list(zip(kc, pc))), errs([(km, pm)])
    check(max(out["coeffs_err"][1], out["matvec_err"][1]) <= FLD_TOL["float32"],
          f"tiled RHD group of {n}: node-axis K7 / K8 vs plain relative "
          f"{out['coeffs_err'][1]:.3e} / {out['matvec_err'][1]:.3e} > {FLD_TOL['float32']:g}")
    del pc, pm
    out["coeffs_ms"] = time_launches(torch, lambda: FLD.fld_coeffs(*cargs), 20)
    out["coeffs_one_ms"] = time_launches(
        torch, lambda: [FLD.fld_coeffs(E[i], chi[i], dt, *const) for i in range(n)], 10)
    out["coeffs_plain_ms"] = time_launches(torch, lambda: FLD.fld_coeffs_reference(*cargs), 3)
    out["coeffs_bound_ms"], out["coeffs_bound_by"] = bound(
        tensor_bytes(E, chi, *kc), count_flops(torch, lambda: FLD.fld_coeffs_reference(*cargs)))
    A, dg = kc[0], kc[1]
    out["matvec_ms"] = time_launches(torch, lambda: FLD.fld_matvec(E, A, dg, sf), 20)
    out["matvec_one_ms"] = time_launches(
        torch, lambda: [FLD.fld_matvec(E[i], A[i], dg[i], sf[i]) for i in range(n)], 10)
    out["matvec_plain_ms"] = time_launches(
        torch, lambda: FLD.fld_matvec_reference(E, A, dg, sf), 5)
    out["matvec_bound_ms"], out["matvec_bound_by"] = bound(
        tensor_bytes(E, A, dg, sf, km),
        count_flops(torch, lambda: FLD.fld_matvec_reference(E, A, dg, sf)))
    lib = matvec_library(torch, E, A, dg, sf)
    out["matvec_library_ms"], out["library_rel_err"] = lib["matvec_library_ms"], lib[
        "library_rel_err"]
    fields = [[states[nd.index]["rad"]["Er"] for nd in members],
              [states[nd.index]["gas"]["u"][:1, 0] for nd in members],
              [states[nd.index]["gas"]["u"][:1, 5] for nd in members]]
    out["stack_ms"] = time_launches(torch, lambda: [torch.stack(f) for f in fields], 10)
    out["stack_bytes"] = 2 * sum(tensor_bytes(*f) for f in fields)
    del E, chi, sf, kc, km, A, dg, cargs, fields
    torch.cuda.empty_cache()

    st0 = clone_states(states)
    dt_t = torch.full((), sim.tm.dt, dtype=sim.dtype, device=DEVICE)
    runs = {}
    for seq in (False, True):
        st = clone_states(st0)
        reads = profiling.host_reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = smr._radiation_pass(st, dt_t, _sequential=seq)
        torch.cuda.synchronize()
        runs[seq] = (new, [list(nd.radiation.cg_iters) for nd in smr.nodes],
                     1e3 * (time.perf_counter() - t0),
                     profiling.host_reads - reads)
    out["pass_err"] = node_field_err(torch, runs[False][0], runs[True][0])
    out["same_iters"] = runs[False][1] == runs[True][1]
    out["pass_ms"], out["pass_seq_ms"] = runs[False][2], runs[True][2]
    out["pass_reads"], out["pass_seq_reads"] = runs[False][3], runs[True][3]
    out["pass_cg"] = [sum(its) for its in runs[False][1]]
    check(out["pass_err"] <= DISK_F32_TOL and out["same_iters"],
          f"tiled RHD: batched pass vs sequential {out['pass_err']:.3e} (gate "
          f"{DISK_F32_TOL:g}), CG counts equal {out['same_iters']}")
    del st0, runs
    torch.cuda.empty_cache()
    return out


def adaptive_tiled_rhd(torch, smi, prod, built):
    """bench.py's tiled AMR disk RHD at full size (phase 26, part 3):
    ``built``, the tree and its set-up seconds (timed_build); ``prod``,
    phase 14's result (its zone-cycles/s)."""
    from artemis_tpu_torch.ops import fld as FLD
    from artemis_tpu_torch.ops import stage_curv as SC

    res = {}
    t_part = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sim, setup_s = built
    del built
    drv, smr = sim.driver, sim.driver.smr
    shapes = sorted({nd.grid.nx for nd in smr.nodes[1:]})
    ntiles = len(smr.nodes) - 1
    check(drv.tiled and ntiles > 0 and drv.stage_kernel == GATHER6_PER_NODE
          and all(nd.radiation.use_kernels for nd in smr.nodes),
          f"tiled RHD: {ntiles} tiles {shapes}, stage path {drv.stage_kernel}")
    print(f"tiled AMR RHD {ADAPT_RHD} root over [-4, 4]^2 f32, tiles {ADAPT_TILE} root "
          f"cells: {ntiles} tiles of {shapes} after the pre-evolution pass, stage path "
          f"{drv.stage_kernel}, set-up {setup_s:.1f} s")
    zones, iters, paths = [], [], []

    def record(state, tm):
        zones.append(sum(ncells(nd.grid) for nd in smr.nodes))
        iters.append([list(nd.radiation.cg_iters) for nd in smr.nodes])
        paths.append(drv.stage_kernel)

    # warm-up: 2 cycles through Simulation.run
    sim.tm.nlim = 2
    sim.run()
    SC.stage_curv_launches = SC.stage_curv_batched_launches = 0
    FLD.fld_coeffs_launches = FLD.fld_coeffs_tiled_launches = FLD.fld_matvec_launches = 0
    FLD.fld_coeffs_node_launches = FLD.fld_matvec_node_launches = 0
    passes, undo = rad_pass_recorder(smr)
    start_nodes = [len(smr.nodes)]

    def nodes_obs(state, tm):
        start_nodes.append(len(smr.nodes))

    zone_start = sum(ncells(nd.grid) for nd in smr.nodes)
    regrids_before = sim.tm.ncycle // drv.retag_interval
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sim.tm.nlim = sim.tm.ncycle + ADAPT_CYCLES
    from artemis_tpu_torch.driver import evolve

    torch.cuda.synchronize()
    start.record()
    sim.state, sim.tm, _, status = evolve(drv, sim.state, sim.tm,
                                          observers=[record, nodes_obs])
    end.record()
    torch.cuda.synchronize()
    undo()
    secs = start.elapsed_time(end) / 1e3
    check(status == "complete", f"tiled RHD run stopped: {status}")
    ncyc = ADAPT_CYCLES
    per_cycle_nodes = start_nodes[:-1]
    zone_cycles = zone_start + sum(zones[:-1])
    launches = {"stage_curv": SC.stage_curv_launches,
                "stage_curv_batched": SC.stage_curv_batched_launches,
                "fld_coeffs": FLD.fld_coeffs_launches,
                "fld_coeffs_tiled": FLD.fld_coeffs_tiled_launches,
                "fld_matvec": FLD.fld_matvec_launches,
                "fld_coeffs_node": FLD.fld_coeffs_node_launches,
                "fld_matvec_node": FLD.fld_matvec_node_launches}
    # one K7 per solve (the root, each group, each lone tile) and 1 + the
    # group's CG iterations a Newton outer, from each pass's own counts
    want = [sum(c) for c in zip(*(batched_fld_launches(r["nodes"]) for r in passes))]
    check(all(pth == GATHER6_PER_NODE for pth in paths) and len(passes) == ncyc
          and launches["stage_curv"] == 2 * sum(per_cycle_nodes)
          and launches["stage_curv_batched"] == 0
          and [launches[k] for k in ("fld_coeffs", "fld_matvec", "fld_coeffs_node",
                                     "fld_matvec_node")] == want
          and launches["fld_coeffs_tiled"] == launches["fld_coeffs"]
          and launches["fld_coeffs_node"] >= ncyc,
          f"tiled RHD: launches {launches} for {ncyc} cycles ({len(passes)} radiation "
          f"passes) on {per_cycle_nodes} nodes, (K7, K8, node-axis K7, node-axis K8) "
          f"{want} expected; stage paths {sorted(set(paths))}")
    solves = want[0] / ncyc
    reads = 1 + sum(r["reads"] for r in passes) / ncyc
    cycle_ms = 1e3 * secs / ncyc
    zcps = zone_cycles / secs
    l2 = l2_vs_ic(torch, sim)
    fin = all(bool(torch.isfinite(t).all()) for st in drv._states
              for t in (st["gas"]["u"], st["gas"]["w"], st["rad"]["Er"]))
    check(fin and l2 <= 3e-4, f"tiled RHD: root density L2 vs IC {l2:.3e} or not finite")
    regrids = sim.tm.ncycle // drv.retag_interval - regrids_before
    check(regrids >= 1, f"tiled RHD: no regrid in the {ncyc} timed cycles")
    res = {"tiles": ntiles, "shapes": [list(s) for s in shapes],
                  "setup_s": setup_s, "launches": launches, "cycle_ms": cycle_ms,
                  "zcps": zcps, "ratio_to_static": zcps / prod["zcps"], "l2": l2,
                  "regrids_timed": regrids, "nodes": [min(per_cycle_nodes),
                                                      max(per_cycle_nodes)],
                  "cg_iters": sum(it for cyc in iters for its in cyc for it in its),
                  "solves_per_cycle": solves, "reads_per_cycle": reads,
                  "matvec_per_cycle": want[1] / ncyc}
    print(f"tiled AMR RHD: {ncyc} cycles ({regrids} regrids) after 2 warm-up, "
          f"{per_cycle_nodes[0]}..{per_cycle_nodes[-1]} nodes, {zcps:.6e} zone-cycles/s "
          f"over every node's zones ({zcps / prod['zcps']:.3f}x the static production "
          f"tree's {prod['zcps']:.6e}), {cycle_ms:.3f} ms a cycle, root density L2 vs IC "
          f"{l2:.3e} (gate 3e-4); launches {launches} (K5b 2 per node a cycle; the batched "
          f"radiation pass: K7 {solves:.2f} a cycle, one per solve, the groups' on the node "
          f"axis, K8 {want[1] / ncyc:.2f} a cycle, 1 + the CG iterations of a solve's "
          f"outer, the group's most); {reads:.2f} host reads a cycle (the dt and the loop "
          f"tests) [{smi}]")

    # the same tree in windows on the sequential pass (every node solved
    # alone, the pass before the node axis) and on the batched one, in the
    # order sequential, batched, batched, sequential, before the profiled
    # cycles and with no regrid between
    order = (True, False, False, True)
    wins = [window_ms(torch, sim, ADAPT_SEQ_CYCLES, sequential=seq) for seq in order]
    res["seq_cycle_ms"] = [w for w, seq in zip(wins, order) if seq]
    res["batched_cycle_ms"] = [w for w, seq in zip(wins, order) if not seq]
    ratio = sum(res["seq_cycle_ms"]) / sum(res["batched_cycle_ms"])
    print(f"tiled AMR RHD windows of {ADAPT_SEQ_CYCLES} cycles, sequential / batched / batched "
          f"/ sequential radiation pass: " + " / ".join(f"{w:.3f}" for w in wins)
          + f" ms a cycle ({ratio:.2f}x) [{smi}]")

    # the device's idle share over a few profiled cycles
    prof = profile_cycles(torch, sim, 2)
    res["busy_ms"] = prof["busy_ms"] if prof else None
    res["idle_share"] = 1.0 - prof["busy_ms"] / cycle_ms if prof else None
    print("tiled AMR RHD device idle: "
          + (f"{100 * res['idle_share']:.1f}% of the unprofiled cycle"
             if prof else "not measured"))

    # one sibling-linked tile at the main path's shape, kernels against
    # their plain versions (these launches come after the counts' read)
    tv = res["tile_check"] = tile_vs_plain(torch, sim)
    print(f"tiled AMR RHD tile {tv['node']} {tuple(tv['shape'])} with {tv['links']} "
          f"sibling links, on its own state: K5b vs plain {tv['stage_err']:.3e} max abs "
          f"(both RK patterns, tol {DISK_F32_TOL:g}); K7 vs plain {tv['coeffs_err'][0]:.3e}"
          f" abs / {tv['coeffs_err'][1]:.3e} rel, K8 {tv['matvec_err'][0]:.3e} / "
          f"{tv['matvec_err'][1]:.3e} (Dirichlet flags {tv['flags']}, tol "
          f"{FLD_TOL['float32']:g} rel)")

    # the pool's largest group on its own state: node-axis K7/K8 against
    # their bounds and one-node launches; batched pass vs sequential
    t_grp = time.perf_counter()
    gp = res["group"] = pool_group_timings(torch, sim)
    n = gp["nodes"]
    print(f"tiled AMR RHD group of {n} tiles {tuple(gp['shape'])} on its own state: "
          f"node-axis K7 {gp['coeffs_ms']:.4f} ms a launch (bound {gp['coeffs_bound_ms']:.4f}"
          f" ms, {gp['coeffs_bound_by']}; {n} one-node launches {gp['coeffs_one_ms']:.4f} ms;"
          f" plain {gp['coeffs_plain_ms']:.4f} ms), node-axis K8 {gp['matvec_ms']:.4f} ms "
          f"(bound {gp['matvec_bound_ms']:.4f} ms, {gp['matvec_bound_by']}; {n} one-node "
          f"launches {gp['matvec_one_ms']:.4f} ms; plain {gp['matvec_plain_ms']:.4f} ms; "
          f"block-diagonal CSR SpMV {gp['matvec_library_ms']:.4f} ms, rel "
          f"{gp['library_rel_err']:.3e} of K8); vs plain rel {gp['coeffs_err'][1]:.3e} / "
          f"{gp['matvec_err'][1]:.3e}; stacking Er, rho and eint of the group "
          f"{gp['stack_ms']:.4f} ms ({gp['stack_bytes'] / 1e6:.1f} MB moved) [{smi}]")
    print(f"tiled AMR RHD one radiation pass on a clone of the state: batched "
          f"{gp['pass_ms']:.2f} ms, {gp['pass_reads']} host reads; sequential "
          f"{gp['pass_seq_ms']:.2f} ms, {gp['pass_seq_reads']} host reads; every node's Er, "
          f"u, w within {gp['pass_err']:.3e} of each array's max (gate {DISK_F32_TOL:g}), "
          f"CG counts equal per node (per node {gp['pass_cg']}) "
          f"({time.perf_counter() - t_grp:.1f} s)")
    # phase 29's tables on the pool: the node-axis rows against the counters
    res["tables"] = profile_tables(torch, smi, sim, "tiled AMR RHD", {
        "fld_coeffs (tiled, node axis)": gp["coeffs_ms"],
        "fld_matvec (per-cell, node axis)": gp["matvec_ms"]})

    # one regrid, and its parts: tags on the device, the mask copy,
    # the set-up, one tile's prolongation
    st0 = drv._states[0]
    bytes0 = smr.mask_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbefore = len(smr.nodes)
    drv._states = drv._regrid()
    torch.cuda.synchronize()
    regrid_ms = 1e3 * (time.perf_counter() - t0)
    mask_bytes = smr.mask_bytes - bytes0
    g = smr.root.grid
    tags_ms = time_launches(torch, lambda: smr.tile_masks(
        st0["gas"]["w"], g, drv.criterion, None, drv.regrid_nbuf), 10)
    masks = smr.tile_masks(st0["gas"]["w"], g, drv.criterion, None, drv.regrid_nbuf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        torch.stack(list(masks)).cpu()
    copy_ms = 1e2 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    smr._compile(smr.fused, smr.gather6)
    torch.cuda.synchronize()
    setup_ms = 1e3 * (time.perf_counter() - t0)
    tile = smr.nodes[-1]
    prolong_ms = time_launches(torch, lambda: smr._fresh_patch_state(st0, tile, tile.lo), 5)
    res.update(regrid_ms=regrid_ms, regrid_changed=len(smr.nodes) != nbefore,
                      tags_ms=tags_ms, copy_ms=copy_ms, setup_ms=setup_ms,
                      prolong_ms=prolong_ms, mask_bytes=mask_bytes,
                      peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"tiled AMR RHD regrid: {regrid_ms:.3f} ms a pass (topology "
          f"{'changed' if res['regrid_changed'] else 'kept'}); tags on the device "
          f"{tags_ms:.4f} ms, the mask copy {copy_ms:.4f} ms ({mask_bytes} bytes cross), "
          f"the set-up {setup_ms:.3f} ms (stages reused), one tile's prolongation "
          f"{prolong_ms:.4f} ms; peak device memory {res['peak_gb']:.2f} GiB [{smi}]")
    res["part_s"] = time.perf_counter() - t_part
    del sim, drv, smr, st0, masks, tile
    torch.cuda.empty_cache()
    return res

def phase_adaptive(torch, smi, prod, built, blast3):
    """Adaptive refinement on the card: blast_amr.in as written on K4 per
    node (and its plain path, a pool restart), and bench.py's tiled AMR
    disk RHD at full size on K5b per node and the batched radiation pass,
    K7 and K8 over each group of same-shape tiles' node axis (``built``:
    that tree and its set-up seconds, timed_build); ``blast3``:
    adaptive_blast3's result, run beside rad_shock."""
    import numpy as np

    from artemis_tpu_torch.state import tree_rows

    res = {}
    with tempfile.TemporaryDirectory() as data:
        # (1) blast_amr as written to tlim 0.1: K4 per node after every
        # regrid, 2 launches per node a cycle, coverage growing
        t_part = time.perf_counter()
        sim = blast_amr_sim(os.path.join(data, "k"))
        check(sim.driver.tiled and sim.dtype == torch.float64, "blast_amr is not tiled f64")
        at, more = ADAPT_RESTART
        ckpt = os.path.join(data, "k", "pool")
        snap = {}
        every = sim.driver.retag_interval

        def snapshot(state, tm):
            # the tree after every regrid (the plain comparison's cycles)
            # and after the cycles the pool restart resumes from and to
            if tm.ncycle % every == 0 or tm.ncycle == at + more:
                snap[tm.ncycle] = clone_states(sim.driver._states)
            if tm.ncycle == at:
                snap["path"] = sim.write_restart(ckpt, state=state, tm=tm)

        k = tree_run(torch, sim, [snapshot])
        ncyc = sim.tm.ncycle
        want = 2 * sum(k["nodes"][:-1])
        check(all(s == PADDED_PER_NODE for s in k["kernels"]),
              f"blast_amr stage paths {sorted(set(k['kernels']))}, want {PADDED_PER_NODE}")
        check(k["launches"] == want and k["batched"] == 0,
              f"blast_amr: {k['launches']} K4 launches in {ncyc} cycles, {want} expected "
              "(2 per node a cycle)")
        check(k["nodes"][-1] > k["nodes"][0], f"blast_amr coverage did not grow: {k['nodes'][0]}"
              f" -> {k['nodes'][-1]} nodes")
        l2 = sedov_l2(sim)
        check(np.isfinite(l2) and l2 < 1.0, f"blast_amr pressure L2 {l2:g} >= 1")
        res["blast"] = {"ncycle": ncyc, "launches": k["launches"], "tiled": k["tiled"],
                        "nodes": [k["nodes"][0], max(k["nodes"]), k["nodes"][-1]],
                        "secs": k["secs"], "l2": l2,
                        "cycle_ms": 1e3 * k["secs"] / ncyc}
        regrids = ncyc // sim.driver.retag_interval
        print(f"blast_amr as written (64x64 f64, tiled, numlevel 2) on the card: {ncyc} cycles "
              f"to t = {sim.tm.time:.6f}, {regrids} regrids, nodes {k['nodes'][0]} -> "
              f"{max(k['nodes'])} (last {k['nodes'][-1]}), stage path {PADDED_PER_NODE} after "
              f"every regrid, {k['launches']} K4 launches = 2 x nodes per cycle ({k['tiled']} "
              f"on the tiled body), {res['blast']['cycle_ms']:.3f} ms a cycle, pressure L2 vs "
              f"sedov2d {l2:.4f} (gate 1) [{smi}]")

        # (2) the same deck on the plain path up to one regrid past the
        # kernel run's first change of topology (spawns and drops, the
        # set-up re-run over renumbered nodes): rows equal after every
        # cycle, every node's u and w after every regrid
        grown = next((c for c, r in enumerate(k["rows"]) if not rows_same([r], [k["rows"][0]])),
                     None)
        check(grown is not None and grown + every <= ncyc,
              f"blast_amr: no change of topology a regrid before its last cycle ({grown})")
        nc = grown + every
        psim = blast_amr_sim(os.path.join(data, "p"), [f"parthenon/time/nlim={nc}"],
                             fused=False)
        psnap = {}

        def psnapshot(state, tm):
            if tm.ncycle % every == 0:
                psnap[tm.ncycle] = clone_states(psim.driver._states)

        p = tree_run(torch, psim, [psnapshot])
        check(psim.driver.stage_kernel == "none" and p["launches"] == 0,
              "plain blast_amr took a kernel")
        check(psim.tm.ncycle == nc and rows_same(k["rows"][:nc + 1], p["rows"]),
              f"blast_amr kernel and plain pools part within {nc} cycles")
        errs_at = {c: node_field_err(torch, snap[c], psnap[c]) for c in sorted(psnap)}
        err = max(errs_at.values())
        check(err <= ADAPT_TOL, f"blast_amr kernel vs plain after the regrids of cycles "
              f"{sorted(psnap)}: {err:.3e} > {ADAPT_TOL}")
        changes = [c for c in range(1, nc + 1) if not rows_same([k["rows"][c]],
                                                                [k["rows"][c - 1]])]
        res["blast"].update(end_err=err, plain_cycle_ms=1e3 * p["secs"] / nc,
                            cmp_cycles=nc, cmp_nodes=[p["nodes"][0], p["nodes"][-1]],
                            cmp_changes=changes)
        print(f"blast_amr plain path: the first {nc} cycles, {len(psnap)} regrids, the "
              f"topology changing at cycles {changes} (nodes {p['nodes'][0]} -> "
              f"{p['nodes'][-1]}), node rows equal to the kernel run's after every cycle, "
              f"every node's u and w after every regrid within {err:.3e} of each array's max "
              f"(gate {ADAPT_TOL:g}), {res['blast']['plain_cycle_ms']:.3f} ms a cycle")
        del psim, psnap

        # (5) a pool restart: the main run's checkpoint at a multiple of
        # check_interval resumed for 10 cycles, against the main run
        check(at % sim.driver.retag_interval == 0, "checkpoint not at a regrid")
        resumed = blast_amr_sim(os.path.join(data, "r"), [f"parthenon/time/nlim={at + more}"],
                                restart=snap["path"])

        def equal(a_states, b_states, b_rows):
            return (rows_same([tree_rows(resumed.driver.smr.nodes)], [b_rows])
                    and all(torch.equal(x["gas"][kk], y["gas"][kk])
                            for x, y in zip(a_states, b_states) for kk in ("u", "w")))

        at_load = equal(resumed.driver._states, snap[at], k["rows"][at])
        resumed.run()
        after = (resumed.tm.ncycle == at + more
                 and equal(resumed.driver._states, snap[at + more], k["rows"][at + more]))
        check(at_load and after, f"pool restart: equal at load {at_load}, after {more} more "
              f"cycles {after}")
        res["restart"] = {"nodes": len(resumed.driver.smr.nodes), "bitwise": True}
        print(f"blast_amr pool restart from the main run's checkpoint at cycle {at} "
              f"({len(k['rows'][at])} pool tiles): rows and every node's u and w torch.equal to "
              f"the main run's at load and after {more} more cycles")
        del sim, resumed, snap
        res["blast"]["part_s"] = time.perf_counter() - t_part
        res["blast3"] = blast3

        # (3) bench.py's tiled AMR disk RHD at full size
        res["rhd"] = adaptive_tiled_rhd(torch, smi, prod, built)
        del built

        # (4) the same composition at 128x128x32, kernel against plain
        t_part = time.perf_counter()
        ov = adaptive_ov(ADAPT_SMALL_TILE, 2) + [f"parthenon/time/nlim={ADAPT_SMALL_CYCLES}"]
        runs = {}
        for fused in (True, False):
            s = amr_sim(os.path.join(data, f"small{int(fused)}"), ADAPT_SMALL, 4.0,
                        fused=fused, extra=ov)
            runs[fused] = (s, tree_run(torch, s))
        (ks, kr), (ps, pr) = runs[True], runs[False]
        err = node_field_err(torch, ks.driver._states, ps.driver._states)
        check(rows_same(kr["rows"], pr["rows"]) and len(kr["rows"]) == ADAPT_SMALL_CYCLES + 1
              and all(s == GATHER6_PER_NODE for s in kr["kernels"]) and err <= DISK_F32_TOL,
              f"tiled RHD {ADAPT_SMALL}: rows equal {rows_same(kr['rows'], pr['rows'])}, paths "
              f"{sorted(set(kr['kernels']))}, kernel vs plain {err:.3e} > {DISK_F32_TOL:g}")
        res["small"] = {"nodes": kr["nodes"], "err": err, "launches": kr["launches"],
                        "part_s": time.perf_counter() - t_part}
        print(f"tiled AMR RHD {ADAPT_SMALL}, tiles {ADAPT_SMALL_TILE}: {ADAPT_SMALL_CYCLES} "
              f"cycles with 2 regrids, nodes {kr['nodes']}, node rows equal on both paths "
              f"after every cycle, kernel vs plain end states {err:.3e} of each array's max "
              f"(gate {DISK_F32_TOL:g})")
        del runs, ks, ps
        torch.cuda.empty_cache()
    print("phase adaptive by part: " + ", ".join(
        f"{key} {res[key]['part_s']:.1f} s" for key in ("blast", "blast3", "rhd", "small")))
    return res


# -- phase 27 -----------------------------------------------------------
# the static_refinement window of tests/test_amr_multilevel.py:99
REST_WINDOW = ["parthenon/mesh/refinement=static", "parthenon/static_refinement1/level=1",
               "parthenon/static_refinement1/x1min=1.0", "parthenon/static_refinement1/x1max=2.5",
               "parthenon/static_refinement1/x3min=-0.4", "parthenon/static_refinement1/x3max=0.4"]
REST_DISK_CYCLES = 10             # the card's refined disk_cyl run
REST_CPU_CYCLES = 2               # compared with the port on the CPU (Queue 3 item 4)
REST_PROFILE_CYCLES = 2           # the last cycles of a run, under torch.profiler
# the tracking patch of tests/test_amr_multilevel.py:168 at deck size; with
# a retag every 2 cycles it first moves at cycle 18
REST_TRACK = ["parthenon/mesh/refinement=static", "parthenon/mesh/numlevel=1",
              "parthenon/refinement/check_interval=2", "nbody/planet1/mass=1.0e-4",
              "nbody/planet1/a=2.0", "nbody/planet1/f=0.0", "nbody/planet1/refine_distance=0.3",
              "nbody/disable_outputs=true"]
REST_TRACK_CYCLES = 20
REST_DUST = ["parthenon/mesh/refinement=static", "parthenon/refinement/patch_nx1=64",
             "parthenon/refinement/patch_nx2=32", "parthenon/refinement/patch_nx3=32"]
REST_DUST_CYCLES = 5
REST_TOL = 1e-10                  # card against the CPU, kernel against plain (f64)
REST_MASS_TOL = 1e-12
REST_BUDGET_S = 100


def tree_cells(smr):
    """Zones over every node of a tree (a sharded tree's global nodes)."""
    return sum(nd.grid.nx[0] * nd.grid.nx[1] * nd.grid.nx[2] for nd in smr.global_nodes)


def host_states(states):
    return [{fl: {k: t.detach().cpu() for k, t in kinds.items()} for fl, kinds in st.items()}
            for st in states]


def timed_tree_cycles(torch, sim, ncycles, observers=()):
    """``ncycles`` more through Simulation.run timed by CUDA events: (ms a
    cycle, zone-cycles/s over every node)."""
    sim.tm.nlim = sim.tm.ncycle + ncycles
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sim.run(extra_observers=list(observers))
    end.record()
    torch.cuda.synchronize()
    check(sim.status == "complete" and sim.tm.ncycle == sim.tm.nlim,
          f"run stopped at cycle {sim.tm.ncycle}, wanted {sim.tm.nlim}")
    ms = start.elapsed_time(end) / ncycles
    return ms, tree_cells(sim.driver.smr) * 1e3 / ms


def tree_masses(sim):
    """Root totals of the gas and of each dust species (the root carries the
    restricted fine solution)."""
    st, vol = sim.driver._states[0], sim.driver.smr.root.hydro.vol
    return [float((st[fl]["u"][s, 0] * vol).sum()) for fl in ("gas", "dust")
            for s in range(st[fl]["u"].shape[0])]


def rest_idle(torch, sim, cycle_ms):
    """The device's idle share of the unprofiled cycle over
    REST_PROFILE_CYCLES more cycles under torch.profiler (None where it
    records no device time)."""
    prof = profile_cycles(torch, sim, REST_PROFILE_CYCLES)
    return None if prof is None else 1.0 - prof["busy_ms"] / cycle_ms


def idle_text(idle):
    return "not measured" if idle is None else f"{100 * idle:.1f}%"


def phase_refinement_rest(torch, smi):
    """The rest of refinement on the card, every path through
    ``Simulation(..., device="cuda")`` in float64 (``rest`` of the
    TwoLevelSMR blast through its own entry point): (a) the refined
    curvilinear disk_cyl, (b) the N-body tracking patch, (c) the dust tree
    through the flux sweep (K9), (d) the moving cylindrical blast."""
    import math

    import numpy as np

    from artemis_tpu_torch import Simulation
    from artemis_tpu_torch import amr as A
    from artemis_tpu_torch.config import ParameterInput
    from artemis_tpu_torch.driver import Integrator
    from artemis_tpu_torch.grid import grid_from_input
    from artemis_tpu_torch.ops import sweeps as SW
    from artemis_tpu_torch.ops.hydro import FluidCfg
    from artemis_tpu_torch.pgen import build_problem

    res = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as data:
        # (a) disk_cyl as written with the static window: the card's first
        # REST_CPU_CYCLES against the port on the CPU, then timed to
        # REST_DISK_CYCLES
        deck = DISK["disk_cyl"]
        sim = Simulation(deck, REST_WINDOW, os.path.join(data, "a"), device=DEVICE)
        smr = sim.driver.smr
        check(sim.dtype == torch.float64 and len(smr.nodes) == 2 and smr.nodes[1].curv
              and smr._fused is None and sim.driver.stage_kernel == "none",
              f"refined disk_cyl: {sim.dtype}, {len(smr.nodes)} nodes, stage path "
              f"{sim.driver.stage_kernel}")
        SW.sweep_launches = 0
        warm_up(sim, REST_CPU_CYCLES)
        card = host_states(sim.driver._states)
        cpu = Simulation(deck, REST_WINDOW + [f"parthenon/time/nlim={REST_CPU_CYCLES}"],
                         os.path.join(data, "a_cpu"), device="cpu")
        cpu.run()
        err = node_field_err(torch, card, cpu.driver._states)
        ms, zcps = timed_tree_cycles(torch, sim, REST_DISK_CYCLES - REST_CPU_CYCLES
                                     - REST_PROFILE_CYCLES)
        idle = rest_idle(torch, sim, ms)
        l2 = l2_vs_ic(torch, sim)
        wf = sim.driver._states[1]["gas"]["w"]
        check(sim.tm.ncycle == REST_DISK_CYCLES and err <= REST_TOL and l2 <= 6e-3
              and bool(torch.isfinite(wf).all()) and bool((wf[:, 0] > 0).all())
              and SW.sweep_launches == 0,
              f"refined disk_cyl: card vs CPU after {REST_CPU_CYCLES} cycles {err:.3e} (tol "
              f"{REST_TOL:g}), root L2 vs IC {l2:.3e} after {sim.tm.ncycle} cycles (<= 6e-3), "
              f"fine level finite/positive, {SW.sweep_launches} sweep launches")
        res["disk"] = dict(nodes=[list(nd.grid.nx) for nd in smr.nodes], err=err, l2=l2,
                           cycle_ms=ms, zcps=zcps, idle_share=idle)
        print(f"refined disk_cyl {tuple(sim.grid.nx)} f64 with a {tuple(smr.nodes[1].grid.nx)} "
              f"cylindrical patch (composable tree, no kernel): card vs the port on the CPU "
              f"after {REST_CPU_CYCLES} cycles {err:.3e} of each array's max (tol "
              f"{REST_TOL:g}); root density L2 vs IC {l2:.3e} after {sim.tm.ncycle} cycles "
              f"(<= 6e-3); {ms:.3f} ms a cycle, {zcps:.6e} zone-cycles/s over every level, "
              f"device idle {idle_text(idle)} [{smi}]")
        del sim, cpu, card, smr, wf
        torch.cuda.empty_cache()

        # (b) the tracking patch at deck size: card and CPU over the
        # window of the first move
        track = REST_TRACK + [f"parthenon/time/nlim={REST_TRACK_CYCLES}"]
        sim = nbody_sim("disk_nbody_cyl", track, os.path.join(data, "b"))
        cpu = Simulation(os.path.join(HERE, "inputs", "disk_nbody_cyl.in"), track + [
            "nbody/planets/input_file=" + os.path.join(HERE, "inputs", "planet_inputs",
                                                       NBODY_INPUT_FILES["disk_nbody_cyl"])],
            os.path.join(data, "b_cpu"), device="cpu")
        los = {}
        for key, s in (("card", sim), ("cpu", cpu)):
            drv = s.driver
            check(drv._particle_nodes == {1: 5} and drv.smr.nodes[1].curv
                  and drv.smr._fused is None,
                  f"disk_nbody_cyl tracking ({key}): nodes {drv._particle_nodes}")
            los[key] = [drv.smr.nodes[1].lo]
        ms, _ = timed_tree_cycles(torch, sim, REST_TRACK_CYCLES, [
            lambda state, tm: los["card"].append(sim.driver.smr.nodes[1].lo)])
        cpu.run(extra_observers=[
            lambda state, tm: los["cpu"].append(cpu.driver.smr.nodes[1].lo)])
        moves = [c for c in range(1, len(los["card"])) if los["card"][c] != los["card"][c - 1]]
        perr = particle_err(sim.nbody, cpu.nbody)
        err = node_field_err(torch, host_states(sim.driver._states), cpu.driver._states)
        check(moves and los["card"] == los["cpu"] and perr <= NBODY_PARTICLE_TOL
              and err <= REST_TOL,
              f"disk_nbody_cyl tracking: moves at cycles {moves}, positions equal "
              f"{los['card'] == los['cpu']}, card vs CPU particles {perr:.3e} (tol "
              f"{NBODY_PARTICLE_TOL:g}), states {err:.3e} (tol {REST_TOL:g})")
        idle = rest_idle(torch, sim, ms)
        res["track"] = dict(shape=list(sim.grid.nx), moves=moves, lo=list(los["card"][-1]),
                            particle_err=perr, err=err, cycle_ms=ms, idle_share=idle)
        print(f"disk_nbody_cyl {tuple(sim.grid.nx)} f64 tracking patch "
              f"{tuple(sim.driver.smr.nodes[1].n)}: moved at cycles {moves} to "
              f"{los['card'][-1]}, the same positions as the CPU run; card vs CPU after "
              f"{REST_TRACK_CYCLES} cycles: particles {perr:.3e}, every node {err:.3e} of each "
              f"array's max; {ms:.3f} ms a cycle, device idle {idle_text(idle)} [{smi}]")
        del sim, cpu
        torch.cuda.empty_cache()

        # (c) the dust tree: gas through K9 on both nodes, against the plain
        # path after the same cycles
        nx, ny, nz = ADV_CELL
        runs = {}
        for fused in (True, False):
            s = Simulation(ADVECTION, REST_DUST + [f"parthenon/time/nlim={REST_DUST_CYCLES}"],
                           os.path.join(data, f"c{int(fused)}"), device=DEVICE,
                           fused_stage=fused)
            check(tuple(s.grid.nx) == (nx, ny, nz) and s.dtype == torch.float64
                  and s.driver.stage_kernel == ("sweep" if fused else "none")
                  and len(s.driver.smr.nodes) == 2,
                  f"dust tree (fused_stage={fused}): {tuple(s.grid.nx)} {s.dtype}, stage path "
                  f"{s.driver.stage_kernel}")
            masses = []
            SW.sweep_launches = 0
            ms, zcps = timed_tree_cycles(torch, s, REST_DUST_CYCLES, [
                lambda state, tm, s=s: masses.append(tree_masses(s))])
            runs[fused] = dict(sim=s, launches=SW.sweep_launches, masses=np.array(masses),
                               cycle_ms=ms, zcps=zcps)
        k, p = runs[True], runs[False]
        m = k["masses"]
        drift = float((np.abs(m[-1] - m[0]) / np.abs(m[0])).max())
        err = node_field_err(torch, k["sim"].driver._states, p["sim"].driver._states)
        want = 3 * 2 * 2 * REST_DUST_CYCLES
        check(k["launches"] == want and p["launches"] == 0 and drift <= REST_MASS_TOL
              and err <= REST_TOL and m.shape == (REST_DUST_CYCLES, 3),
              f"dust tree: {k['launches']} sweep launches (wanted {want}), plain path "
              f"{p['launches']}, mass drift over cycles 1-{REST_DUST_CYCLES} {drift:.3e} (tol "
              f"{REST_MASS_TOL:g}), kernel vs plain {err:.3e} (tol {REST_TOL:g})")
        res["dust"] = dict(launches=k["launches"], drift=drift, err=err, cycle_ms=k["cycle_ms"],
                           zcps=k["zcps"], plain_zcps=p["zcps"])
        print(f"dust tree {ADV_CELL} f64 (gas + 2 dust species, a 64x32x32 patch): "
              f"{k['launches']} sweep launches in {REST_DUST_CYCLES} cycles (3 directions x 2 "
              f"stages x 2 nodes a cycle); gas and dust mass drift {drift:.3e} over cycles "
              f"1-{REST_DUST_CYCLES}; kernel vs plain end states {err:.3e} of each array's "
              f"max; {k['cycle_ms']:.3f} ms a cycle, {k['zcps']:.6e} zone-cycles/s over every "
              f"level (plain path {p['zcps']:.6e}) [{smi}]")
        del runs, k, p
        torch.cuda.empty_cache()

    # (d) tests/test_amr.py's moving cylindrical blast: two chunks of 5
    # cycles, a pressure-gradient retag after each
    pin = ParameterInput.from_file(DECKS["blast"])
    pin.apply_overrides([
        "artemis/coordinates=cylindrical", "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64",
        "parthenon/mesh/x1min=1.0", "parthenon/mesh/x1max=5.0", "parthenon/mesh/x2min=0.0",
        f"parthenon/mesh/x2max={0.5 * math.pi:.16f}",
        "parthenon/mesh/ix1_bc=reflecting", "parthenon/mesh/ox1_bc=reflecting",
        "parthenon/mesh/ix2_bc=reflecting", "parthenon/mesh/ox2_bc=reflecting",
        "gas/reconstruct=plm", "gas/riemann=hlle", "gas/gamma=1.4", "problem/radius=0.15",
        "problem/height=1.0", "problem/symmetry=cylindrical", "problem/samples=0",
        "problem/x1=1.8", f"problem/x2={0.1 * math.pi:.16f}"])
    cfg = FluidCfg(fluid="gas", recon="plm", rsolver="hlle", gamma=pin.get_real("gas", "gamma"),
                   cfl=pin.get_real("gas", "cfl"), dfloor=pin.get_real("gas", "dfloor"),
                   siefloor=pin.get_real("gas", "siefloor"))
    grid = grid_from_input(pin)
    lo0 = (42, 42, 0)
    smr = A.TwoLevelSMR(grid, Integrator.make("rk2"), cfg, lo0, (16, 16, 1), device=DEVICE,
                        dtype=torch.float64)
    wc = build_problem("blast", pin, grid, cfg).prims["gas"]
    wf = build_problem("blast", ParameterInput.from_string(repr(pin)), smr.fg, cfg).prims["gas"]
    sc, sf = smr.initialize(wc, wf)
    vol = smr.ml.root.hydro.vol
    m0 = float((sc[0][:, 0] * vol).sum())
    crit = dict(field="pressure", type="gradient", refine_thr=0.3)
    seen = [lo0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        sc, sf, _, _ = smr.run(sc, sf, tlim=1.0, nlim=5, criterion=crit, retag_interval=5)
        seen.append(smr.patch_lo)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 10
    drift = abs(float((sc[0][:, 0] * vol).sum()) - m0) / m0
    check(smr.curv and seen[1] != lo0 and sc[0].is_cuda and drift <= REST_MASS_TOL
          and bool(torch.isfinite(sf[1]).all()),
          f"moving cylindrical blast: positions {seen}, mass drift {drift:.3e} (tol "
          f"{REST_MASS_TOL:g})")
    res["blast"] = dict(positions=[list(p) for p in seen], drift=drift, cycle_ms=ms)
    print(f"moving cylindrical blast (TwoLevelSMR, 64x64 + 16x16 patch, f64): positions "
          f"{seen} after each retag, composite mass drift {drift:.3e} (tol "
          f"{REST_MASS_TOL:g}); {ms:.3f} ms a cycle, the retags and the patch rebuilds "
          f"included [{smi}]")
    res["secs"] = time.perf_counter() - t_phase
    print(f"phase refinement, the rest: {res['secs']:.1f} s (budget {REST_BUDGET_S} s)")
    return res


# -- phase 28 ------------------------------------------------------------
SHARDS = 4
SHARD_DEVICES = ["cuda:0"] * SHARDS     # four shards on the one card
SHARD_FLAG_CYCLES = (6, 10)             # compared with phase 5's run; timed
SHARD_DISK_CYCLES = (4, 20)             # compared with phase 7's run; timed
SHARD_DISK_XY_TIMED = 10                # timed cycles of the x1- and x2-sharded disk
SHARD_SHOCK_CYCLES = 30
SHARD_SHOCK_TOL = 1e-9                  # tests/test_parallel.py's rad_shock tolerance
SHARD_NBODY_TOL = (1e-11, 1e-12)        # gas, particles (test_sharded_nbody)
# tests/test_parallel.py's 16^3 N-body deck (test_sharded_nbody)
SHARD_NBODY_DECK = """
<artemis>
problem = constant
coordinates = cartesian
<parthenon/job>
problem_id = nbshard
<parthenon/time>
tlim = 0.5
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


def shard_ref(sim, state=None, tm=None):
    """A copy of an unsharded run's state (its own, or an observer's) and
    its time, for phase 28's comparison."""
    state = sim.state if state is None else state
    tm = sim.tm if tm is None else tm
    return {"state": {n: {k: v.clone() for k, v in kinds.items() if k != "dtden"}
                      for n, kinds in state.items()},
            "time": tm.time, "ncycle": tm.ncycle}


def sharded_sim(make, *args, **kw):
    """A run through ``make`` (one of this script's sim constructors) with SHARDS
    shards on SHARD_DEVICES; each shard must sit on the card."""
    sim = make(*args, nshards=SHARDS, shard_devices=SHARD_DEVICES, **kw)
    check(len(sim.driver.drivers) == SHARDS
          and all(d.device.type == "cuda" for d in sim.driver.drivers),
          f"sharded run placed its shards on {[str(d.device) for d in sim.driver.drivers]}")
    return sim


def field_err(torch, sim, ref, rel):
    """max |sim - ref| over the reference's fields: absolute, or relative
    to max(1, each component's max) (``rel``)."""
    errs = []
    for name, kinds in ref["state"].items():
        for k, b in kinds.items():
            a = sim.state[name][k]
            if rel:
                scale = b.abs().amax(dim=tuple(i for i in range(b.ndim) if i != 1),
                                     keepdim=True).clamp(min=1.0)
                errs.append(float(((a - b).abs() / scale).max()))
            else:
                errs.append(float((a - b).abs().max()))
    return max(errs)


def exchange_ms(torch, sim):
    """ms of one stage's slab exchange and exchanged fills over every shard
    (the work a sharded stage adds in front of its kernels), timed alone in
    a loop: its share of a cycle timed in another window is an estimate,
    not a trace of the sharded cycle."""
    drv = sim.driver
    shards = sim.state.shards

    def fills():
        drv._exchange(shards)
        for d, st in zip(drv.drivers, shards):
            d.fill_ghosts(st["gas"]["w"], "gas")

    return time_launches(torch, fills, 10)


def sharded_cell(torch, smi, name, sim, ref, counted, ncmp, ntimed, kernel, unsharded_zcps,
                 rel, tol):
    """Drive a sharded cell through Simulation.run for ``ncmp`` cycles with
    the launch counters reset before and read after (``counted()`` -> (its
    kernel's launches, launches of the kernel it replaces, the tiled
    body's)), hold it to the unsharded ``ref`` after the same cycles, then
    time ``ntimed`` cycles and the exchange's share of the cycle."""
    counted(reset=True)
    warm_up(sim, ncmp)
    k, other, tiled = counted()
    check(k == 2 * SHARDS * ncmp == tiled and other == 0,
          f"sharded {name}: {k} {kernel} launches ({tiled} tiled) and {other} of the unsharded "
          f"kernel in {ncmp} cycles, wanted {2 * SHARDS * ncmp}")
    check(sim.tm.ncycle == ref["ncycle"] and abs(sim.tm.time - ref["time"])
          <= 1e-6 * ref["time"], f"sharded {name}: cycle {sim.tm.ncycle} t {sim.tm.time} vs "
          f"unsharded {ref['ncycle']} t {ref['time']}")
    err = field_err(torch, sim, ref, rel)
    check(err <= tol, f"sharded {name} vs unsharded after {ncmp} cycles: {err:.3e} > {tol:g}")
    zcps = run_cycles(torch, sim, ntimed)
    ncell = sim.grid.nx[0] * sim.grid.nx[1] * sim.grid.nx[2]
    cycle_ms = 1e3 * ncell / zcps
    ex = exchange_ms(torch, sim)
    out = {"launches": k, "err": err, "bitwise": err == 0.0, "zcps": zcps,
           "unsharded_zcps": unsharded_zcps, "cycle_ms": cycle_ms, "exchange_ms": ex,
           "exchange_share": 2 * ex / cycle_ms}
    print(f"sharded {name} ({SHARDS} x {sim.driver.drivers[0].grid.nx} on "
          f"{SHARD_DEVICES[0]}): {k} {kernel} launches in {ncmp} cycles, all on the tiled body, "
          f"none of the unsharded kernel; vs unsharded after {ncmp} cycles "
          + ("bitwise equal" if err == 0.0 else f"{err:.3e} (tol {tol:g})")
          + f"; {ntimed} cycles {zcps:.6e} zone-cycles/s against unsharded "
          f"{unsharded_zcps:.6e} ({zcps / unsharded_zcps:.3f}x), cycle {cycle_ms:.4f} ms, "
          f"exchange and fills timed alone {ex:.4f} ms a stage (an estimated "
          f"{100 * out['exchange_share']:.1f}% of the cycle) [{smi}]")
    return out


def phase_sharded(torch, smi, flag_ref, flag_zcps, disk_ref, disk_zcps, shock_ref):
    """Phase 28: single-level runs on SHARDS shards of the one card."""
    from artemis_tpu_torch import Simulation
    from artemis_tpu_torch.ops import stage as S, stage_curv as SC

    def cart(reset=False):
        if reset:
            S.stage_launches = S.tiled_launches = S.padded_launches = 0
        return S.padded_launches, S.stage_launches - S.padded_launches, S.tiled_launches

    def curv(reset=False):
        if reset:
            SC.stage_curv_launches = SC.tiled_launches = 0
            for h in SC.halo_launches:
                SC.halo_launches[h] = 0
        return (SC.halo_launches["padded"],
                SC.stage_curv_launches - SC.halo_launches["padded"], SC.tiled_launches)

    res = {}
    with tempfile.TemporaryDirectory() as data:
        sim = sharded_sim(flagship_sim, "float32", os.path.join(data, "flag"))
        check(sim.driver.axis_d == 3 and all(d.stage_kernel == "stage_cart" and d._exchanged
                                             for d in sim.driver.drivers),
              f"sharded flagship took {sim.driver.stage_kernel} on axis {sim.driver.axis_d}")
        res["flagship"] = sharded_cell(torch, smi, "flagship f32", sim, flag_ref, cart,
                                       SHARD_FLAG_CYCLES[0], SHARD_FLAG_CYCLES[1],
                                       "stage (K2)", flag_zcps, False, F32_TOL)
        del sim
        torch.cuda.empty_cache()

        sim = sharded_sim(disk_setup, torch, "float32", DISK_BENCH, os.path.join(data, "disk"))
        check(sim.driver.axis_d == 3 and all(d.stage_kernel == "stage_curv (padded)"
                                             for d in sim.driver.drivers),
              f"sharded disk_sph took {sim.driver.stage_kernel}")
        r = sharded_cell(torch, smi, "disk_sph f32", sim, disk_ref, curv,
                         SHARD_DISK_CYCLES[0], SHARD_DISK_CYCLES[1], "stage_curv (K4)",
                         disk_zcps, True, DISK_F32_TOL)
        r["l2"] = l2_vs_ic(torch, sim)
        check(r["l2"] <= 6e-3, f"sharded disk_sph L2 vs IC {r['l2']:.3e} > 6e-3")
        print(f"sharded disk_sph after {sim.tm.ncycle} cycles: L2 vs IC {r['l2']:.3e} "
              "(gate 6e-3)")
        res["disk_sph"] = r
        del sim
        torch.cuda.empty_cache()

        # x1 and x2 shards: K4 with each shard's own coefficient rows (the
        # JAX package falls back to its tensor stage there)
        for axis in ("x1", "x2"):
            sim = sharded_sim(disk_setup, torch, "float32", DISK_BENCH,
                              os.path.join(data, f"disk_{axis}"),
                              extra=(f"parthenon/mesh/shard_axis={axis}",))
            check(sim.driver.axis_d == int(axis[1]) and all(
                d.stage_kernel == "stage_curv (padded)" for d in sim.driver.drivers),
                f"{axis}-sharded disk_sph took {sim.driver.stage_kernel} on axis "
                f"{sim.driver.axis_d}")
            res[f"disk_sph_{axis}"] = sharded_cell(
                torch, smi, f"disk_sph f32 on {axis}", sim, disk_ref, curv,
                SHARD_DISK_CYCLES[0], SHARD_DISK_XY_TIMED, "stage_curv (K4)", disk_zcps, True,
                DISK_F32_TOL)
            del sim
            torch.cuda.empty_cache()

        sim = sharded_sim(lambda **kw: Simulation(
            SHOCK, [f"parthenon/time/tlim={SHOCK_TLIM}", f"parthenon/time/nlim={SHARD_SHOCK_CYCLES}",
                    "parthenon/mesh/shard_axis=x1"], os.path.join(data, "shock"),
            device=DEVICE, **kw))
        check(sim.driver.axis_d == 1 and not sim.driver.radiation.use_kernels,
              "sharded rad_shock: not on x1 slabs with the tensor operator")
        t0 = time.perf_counter()
        sim.run()
        secs = time.perf_counter() - t0
        errs = {}
        for name, kinds in shock_ref["state"].items():
            for k, b in kinds.items():
                a = sim.state[name][k]
                errs[f"{name}.{k}"] = float((a - b).abs().max() / b.abs().max())
        err = max(errs.values())
        check(sim.tm.ncycle == shock_ref["ncycle"] and err <= SHARD_SHOCK_TOL,
              f"sharded rad_shock after {sim.tm.ncycle} cycles vs unsharded: {errs}")
        res["rad_shock"] = {"err": err, "secs": secs}
        print(f"sharded rad_shock f64 (x1, {SHARDS} x 128): {SHARD_SHOCK_CYCLES} cycles in "
              f"{secs:.1f} s, vs the unsharded run of phase 15 at cycle {shock_ref['ncycle']}: "
              f"max |diff| / max |field| {err:.3e} (tol {SHARD_SHOCK_TOL:g})")
        del sim

        one = Simulation(SHARD_NBODY_DECK, [], os.path.join(data, "nb1"), is_path=False,
                         device=DEVICE)
        one.run()
        sim = sharded_sim(lambda **kw: Simulation(
            SHARD_NBODY_DECK, [], os.path.join(data, "nb4"), is_path=False, device=DEVICE,
            **kw))
        sim.run()
        gas = float((sim.state["gas"]["w"] - one.state["gas"]["w"]).abs().max())
        part = float(max(abs(sim.nbody.pos - one.nbody.pos).max(),
                         abs(sim.nbody.vel - one.nbody.vel).max()))
        check(sim.tm.ncycle == one.tm.ncycle and gas <= SHARD_NBODY_TOL[0]
              and part <= SHARD_NBODY_TOL[1],
              f"sharded N-body deck: gas {gas:.3e}, particles {part:.3e} after "
              f"{sim.tm.ncycle} / {one.tm.ncycle} cycles")
        res["nbody"] = {"gas": gas, "particles": part, "ncycle": sim.tm.ncycle}
        print(f"sharded 16^3 N-body deck (x3, {SHARDS} x 4 planes) to t = 0.5: "
              f"{sim.tm.ncycle} cycles, vs unsharded on the card: gas {gas:.3e} (tol "
              f"{SHARD_NBODY_TOL[0]:g}), particles {part:.3e} (tol {SHARD_NBODY_TOL[1]:g})")
        del sim, one
        torch.cuda.empty_cache()
    return res


# -- phase 30 ------------------------------------------------------------
TREE_CMP_CYCLES = 4                 # sharded trees against the unsharded ones
TREE_TIMED_CYCLES = 10
# the flagship tree: linwave at FLAGSHIP with a wrap patch of 128^3 parent
# cells (a 256^3 fine node), or a 128x128x64 patch distributed over the
# shards (32 fine x3 cells each)
TREE_FLAG = ["parthenon/mesh/refinement=static", "parthenon/refinement/patch_nx1=128",
             "parthenon/refinement/patch_nx2=128"]
TREE_FLAG_WAYS = {"wrap": ["parthenon/refinement/patch_nx3=128"],
                  "distributed": ["parthenon/refinement/patch_nx3=64",
                                  "artemis/amr_distribute=true"]}
# disk_sph at DISK_BENCH with a full-phi ring of 128x32x64 parent cells
TREE_DISK = ["parthenon/mesh/refinement=static", "parthenon/refinement/patch_nx1=128",
             "parthenon/refinement/patch_nx2=32", "parthenon/refinement/patch_nx3=64"]
# the test-size float64 trees of tests/test_torch_amr_sharded*.py, on the
# card against the port's CPU run of the same sharded case (rad_shock cut
# from the tests' 10 cycles to 6 for the phase's budget)
TREE_SMALL = {
    "rad_shock_distributed": (SHOCK, [
        "parthenon/time/nlim=6", "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=1",
        "parthenon/mesh/nx3=16", "parthenon/mesh/ix3_bc=periodic",
        "parthenon/mesh/ox3_bc=periodic", "parthenon/mesh/x3min=0.0",
        "parthenon/mesh/x3max=1.0", "parthenon/mesh/refinement=static",
        "parthenon/refinement/patch_nx1=32", "parthenon/refinement/patch_nx3=8",
        "artemis/amr_distribute=true"]),
    "disk_nbody_cyl_tracking": (os.path.join(HERE, "inputs", "disk_nbody_cyl.in"), [
        "parthenon/time/nlim=10", "parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64",
        "parthenon/mesh/nx3=1", "parthenon/mesh/refinement=static",
        "parthenon/mesh/numlevel=1", "nbody/planet1/mass=1.0e-4", "nbody/planet1/a=2.0",
        "nbody/planet1/f=0.0", "nbody/planet1/refine_distance=0.3",
        "nbody/disable_outputs=true"]),
    "blast_amr_pool": (os.path.join(HERE, "inputs", "blast_amr.in"), [
        "parthenon/time/nlim=20", "parthenon/mesh/nx3=8", "parthenon/mesh/x3min=-0.5",
        "parthenon/mesh/x3max=0.5", "parthenon/mesh/ix3_bc=periodic",
        "parthenon/mesh/ox3_bc=periodic", "parthenon/refinement/patch_nx3=8",
        "parthenon/refinement/check_interval=5", "parthenon/refinement/tile_nx1=8",
        "parthenon/refinement/tile_nx2=8"]),
}
TREE_RESTART = ["parthenon/mesh/nghost=2", "parthenon/mesh/nx1=32", "parthenon/mesh/nx2=8",
                "parthenon/mesh/nx3=16", "problem/amp=1.0e-6", "gas/reconstruct=plm",
                "parthenon/mesh/refinement=static", "parthenon/refinement/patch_nx1=16",
                "parthenon/refinement/patch_nx2=4", "parthenon/refinement/patch_nx3=16"]
TREE_RESTART_CYCLES = (5, 10)       # the checkpoint's cycle, the end
TREE_BUDGET_S = 60


def tree_states(sim):
    """Copies of every node's global state (a sharded tree's gathered)."""
    drv = sim.driver
    return [{n: {k: v.clone() for k, v in kinds.items()} for n, kinds in drv._states[i].items()}
            for i in range(len(drv.smr.nodes))]


def tree_err(torch, states, ref):
    """max over nodes and fields of |a - b| / max(1, max |b| of b's
    component)."""
    errs = []
    for a_st, b_st in zip(states, ref):
        for name, kinds in b_st.items():
            for k, b in kinds.items():
                a = a_st[name][k].to(b.device, b.dtype)
                dims = tuple(i for i in range(b.ndim) if i != 1) if b.ndim == 5 else None
                scale = (b.abs().amax(dim=dims, keepdim=True) if dims else b.abs().amax())
                errs.append(float(((a - b).abs() / scale.clamp(min=1.0)).max()))
    return max(errs)


def tree_sharded(make, *args, **kw):
    """A run through ``make`` with SHARDS shards on SHARD_DEVICES; every
    shard tree must sit on the card."""
    sim = make(*args, nshards=SHARDS, shard_devices=SHARD_DEVICES, **kw)
    smr = sim.driver.smr
    check(len(smr.trees) == SHARDS and all(t.device.type == "cuda" for t in smr.trees),
          f"sharded tree placed its shards on {[str(t.device) for t in smr.trees]}")
    return sim


def tree_pair(torch, smi, name, make, want_kind, kernel_per_cycle, tol):
    """One full-size tree cell: the unsharded tree for TREE_CMP_CYCLES
    through Simulation.run, its node states kept, then TREE_TIMED_CYCLES
    timed; the sharded tree with the sweep count reset before and read
    after its TREE_CMP_CYCLES, held to the unsharded states at ``tol`` of
    each field's scale, then timed the same way.  The sharded tree is set
    up on a thread beside the unsharded tree's set-up and untimed cycles,
    and is done before the first timed window opens."""
    from artemis_tpu_torch.ops import sweeps as SW

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        pre = pool.submit(timed_build, lambda: tree_sharded(make))
        t0 = time.perf_counter()
        one = make()
        one_kernel = one.driver.stage_kernel
        split = {"build": time.perf_counter() - t0}
        warm_up(one, TREE_CMP_CYCLES)
        ref, ref_time = tree_states(one), one.tm.time
        t0 = time.perf_counter()
        sim, split["sharded_build"] = pre.result()
        split["wait"] = time.perf_counter() - t0
    one_ms, one_zcps = timed_tree_cycles(torch, one, TREE_TIMED_CYCLES)
    del one
    torch.cuda.empty_cache()
    smr = sim.driver.smr
    node = smr.nodes[1]
    kind = "distributed" if node.distributed else "replicated" if node.replicated else "wrap"
    check(kind == want_kind and smr.axis_d == 3 and node.wrap[2] == (kind == "wrap"),
          f"sharded {name}: node 1 {kind} on axis {smr.axis_d}, wanted {want_kind} on x3")
    SW.sweep_launches = 0
    warm_up(sim, TREE_CMP_CYCLES)
    launches = SW.sweep_launches
    want = kernel_per_cycle * TREE_CMP_CYCLES
    check(launches == want, f"sharded {name}: {launches} sweep launches in "
          f"{TREE_CMP_CYCLES} cycles, wanted {want}")
    check(abs(sim.tm.time - ref_time) <= 1e-6 * ref_time,
          f"sharded {name}: t {sim.tm.time} vs unsharded {ref_time}")
    err = tree_err(torch, tree_states(sim), ref)
    check(err <= tol, f"sharded {name} vs unsharded after {TREE_CMP_CYCLES} cycles: "
          f"{err:.3e} > {tol:g}")
    ms, zcps = timed_tree_cycles(torch, sim, TREE_TIMED_CYCLES)
    local = [nd.grid.nx for nd in smr.nodes]
    print(f"sharded tree {name} ({SHARDS} shards on {SHARD_DEVICES[0]}, nodes per shard "
          f"{local}, {smr.stage_kernel}): {launches} sweep (K9) launches in {TREE_CMP_CYCLES} "
          f"cycles ({kernel_per_cycle} a cycle); vs the unsharded tree ({one_kernel}) on the "
          f"same card after {TREE_CMP_CYCLES} cycles {err:.3e} (tol {tol:g}); "
          f"{TREE_TIMED_CYCLES} cycles {ms:.3f} ms a cycle, {zcps:.6e} zone-cycles/s over every "
          f"node against unsharded {one_zcps:.6e} ({one_ms:.3f} ms, {zcps / one_zcps:.3f}x); "
          f"set-ups {split['build']:.1f} s unsharded, {split['sharded_build']:.1f} s sharded "
          f"beside it (then waited {split['wait']:.1f} s) [{smi}]")
    out = {"launches": launches, "err": err, "ms": ms, "zcps": zcps, "unsharded_ms": one_ms,
           "unsharded_zcps": one_zcps, "unsharded_kernel": one_kernel,
           "nodes_per_shard": local}
    del sim
    torch.cuda.empty_cache()
    return out


def small_tree(torch, deck, args, data, device, **kw):
    from artemis_tpu_torch import Simulation

    sim = Simulation(deck, args, data, device=device, nshards=SHARDS, **kw)
    sim.run()
    check(sim.status == "complete", f"{deck} on {device} did not complete")
    return sim


def small_summary(sim):
    """A small tree's end: every node's global state on the host, the tile
    set, the particles' positions and the cycle."""
    states = [{n: {k: v.cpu().numpy() for k, v in kinds.items()} for n, kinds in st.items()}
              for st in tree_states(sim)]
    pool = sorted(nd.lo for nd in sim.driver.smr.global_nodes if nd.pool)
    pos = None if sim.nbody is None else sim.nbody.pos.copy()
    return states, pool, pos, sim.tm.ncycle


def cpu_small_trees():
    """The port's CPU runs of TREE_SMALL (run in a worker process beside
    the kernels' build): {name: small_summary}."""
    import torch

    torch.set_num_threads(1)
    out = {}
    with tempfile.TemporaryDirectory() as data:
        for name, (deck, args) in TREE_SMALL.items():
            out[name] = small_summary(small_tree(torch, deck, args, os.path.join(data, name),
                                                 "cpu"))
    return out


def card_small_trees():
    """TREE_SMALL on SHARDS shards of the card (run in a worker process
    beside rad_shock, whose loop is host-bound and untimed): {name:
    (small_summary, sweep launches, seconds)}."""
    import torch

    from artemis_tpu_torch.ops import sweeps as SW

    out = {}
    with tempfile.TemporaryDirectory() as data:
        for name, (deck, args) in TREE_SMALL.items():
            SW.sweep_launches = 0
            t0 = time.perf_counter()
            sim = small_tree(torch, deck, args, os.path.join(data, name), DEVICE,
                             shard_devices=SHARD_DEVICES)
            secs = time.perf_counter() - t0
            devs = [str(t.device) for t in sim.driver.smr.trees]
            check(devs == SHARD_DEVICES, f"sharded {name} placed its shards on {devs}")
            out[name] = (small_summary(sim), SW.sweep_launches, secs)
            del sim
    torch.cuda.empty_cache()
    return out


def start_worker(fn, *args):
    """A worker process running ``fn(*args)`` (spawned, so a CUDA context
    of its own where ``fn`` uses the card): (pool, future); the caller
    shuts the pool down."""
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(fn, *args)


# the phases that only check kernels against their plain versions (and the
# linear wave's thresholds), run beside rad_shock
CHECKS_BESIDE = ("compare", "linwave", "curv_compare", "fld_compare", "gather6_compare",
                 "batched_compare", "sweep_compare")


def beside_rad_shock(smi):
    """What a worker process runs on the card beside rad_shock, whose loop
    is host-bound and untimed: phase 30's small trees, the untimed checks
    of phase 23 (simple_drag, the other decks) and of phase 26 (blast_amr at
    numlevel 3), then the kernel-vs-plain phases (CHECKS_BESIDE).  Returns
    ({part: result}, {part: seconds}, what they printed), for the main
    process to print after rad_shock."""
    import io

    import torch

    parts = (("small_trees", card_small_trees), ("simple_drag", lambda: phase_drag(torch, smi)),
             ("other_decks", lambda: phase_other_decks(torch, smi)),
             ("blast3", lambda: adaptive_blast3(torch))) + tuple(
        (key, functools.partial(globals()[f"phase_{key}"], torch)) for key in CHECKS_BESIDE)
    res, secs, out = {}, {}, io.StringIO()
    with contextlib.redirect_stdout(out):
        for key, fn in parts:
            t0 = time.perf_counter()
            res[key] = fn()
            secs[key] = time.perf_counter() - t0
    return res, secs, out.getvalue()


def phase_sharded_trees(torch, smi, cpu_refs, cards_small):
    """Phase 30: sharded refinement trees on SHARDS shards of the one card;
    ``cpu_refs``: the future of the small trees' CPU references,
    ``cards_small``: their card runs (``card_small_trees``)."""
    from artemis_tpu_torch import Simulation

    t0 = time.perf_counter()
    res, secs = {}, {}
    with tempfile.TemporaryDirectory() as data:
        for way, extra in TREE_FLAG_WAYS.items():
            # the two trees of a cell are set up at once: a data directory each
            def make(**kw):
                return flagship_sim("float32", os.path.join(data, f"flag_{way}", str(len(kw))),
                                    extra=TREE_FLAG + extra, **kw)

            t1 = time.perf_counter()
            # 3 directions x 2 stages x 2 nodes per shard x SHARDS shards
            res[f"flagship_{way}"] = tree_pair(torch, smi, f"flagship f32 {way}", make, way,
                                               3 * 2 * 2 * SHARDS, F32_TOL)
            secs[f"flagship_{way}"] = time.perf_counter() - t1

        def disk(**kw):
            return disk_setup(torch, "float32", DISK_BENCH,
                              os.path.join(data, "disk", str(len(kw))), extra=TREE_DISK, **kw)

        t1 = time.perf_counter()
        # a curvilinear tree takes the tensor fluxes: no sweep launch
        res["disk_ring"] = tree_pair(torch, smi, "disk_sph f32 ring", disk, "wrap", 0,
                                     DISK_F32_TOL)
        secs["disk_ring"] = time.perf_counter() - t1
        small = {name: {"launches": n, "secs": t}
                 for name, (_, n, t) in cards_small.items()}
        cards = {name: summary for name, (summary, _, _) in cards_small.items()}
        t1 = time.perf_counter()

        # a sharded checkpoint resumed bit for bit
        k, n = TREE_RESTART_CYCLES

        def lin(sub, extra=(), **kw):
            return Simulation(DECK, TREE_RESTART + list(extra), os.path.join(data, sub),
                              device=DEVICE, nshards=SHARDS, shard_devices=SHARD_DEVICES, **kw)

        straight = lin("rst_a", [f"parthenon/time/nlim={n}"])
        straight.run()
        first = lin("rst_b", [f"parthenon/time/nlim={k}"])
        first.run()
        rst = first.write_restart(os.path.join(data, "rst_b", "tree"))
        resumed = lin("rst_b", [f"parthenon/time/nlim={n}"], restart=rst)
        resumed.run()
        same = all(bool(torch.equal(a[fl][key], b[fl][key]))
                   for a, b in zip(tree_states(straight), tree_states(resumed))
                   for fl in b for key in b[fl])
        check(resumed.tm.ncycle == straight.tm.ncycle == n and same,
              f"sharded tree checkpoint at cycle {k} did not resume bit for bit")
        res["restart_bitwise"] = same
        secs["restart"] = time.perf_counter() - t1
        print(f"sharded tree checkpoint at cycle {k} resumed to cycle {n}: every node bitwise "
              "equal to the straight run")
        t1 = time.perf_counter()
        refs = cpu_refs.result()
        secs["cpu_wait"] = time.perf_counter() - t1
    for name, (states, pools, pos, ncycle) in cards.items():
        r_states, r_pools, r_pos, r_ncycle = refs[name]
        err = tree_err(torch, [{nm: {key: torch.as_tensor(v) for key, v in kinds.items()}
                                for nm, kinds in st.items()} for st in states],
                       [{nm: {key: torch.as_tensor(v) for key, v in kinds.items()}
                         for nm, kinds in st.items()} for st in r_states])
        r = small[name]
        r.update(err=err, ncycle=ncycle, tiles=len(pools))
        check(ncycle == r_ncycle and err <= F64_TOL and pools == r_pools,
              f"sharded {name}: card vs CPU {err:.3e} after {ncycle} / {r_ncycle} cycles, "
              f"tiles {pools} / {r_pools}")
        if pos is not None:
            r["particles"] = float(abs(pos - r_pos).max())
            check(r["particles"] <= F64_TOL, f"sharded {name}: particles {r['particles']}")
        print(f"sharded tree {name} f64 on the card (beside rad_shock): {ncycle} cycles in "
              f"{r['secs']:.1f} s, "
              f"{r['launches']} sweep launches, {r['tiles']} tiles, vs the port's CPU run "
              f"{err:.3e} (tol {F64_TOL:g})"
              + (f", particles {r['particles']:.3e}" if "particles" in r else ""))
    res["small"] = small
    res["secs"] = time.perf_counter() - t0
    print(f"phase 30 (sharded trees): {res['secs']:.1f} s (budget {TREE_BUDGET_S} s): "
          + ", ".join(f"{key} {v:.1f} s" for key, v in secs.items()))
    return res


# -- phase 29 ------------------------------------------------------------
PROFILE_CYCLES = 3            # phase_table's timed cycles
PROFILE_KERNEL_CYCLES = 2     # kernel_table's


def profile_tables(torch, smi, sim, label, phase_ms):
    """Phase 29 on a sim of another phase: ``phase_table``, then
    ``kernel_table`` with every wrapper's launch counter reset before and
    read after (no warm-up: the sim's kernels are built).  Every row must
    be a kernel, and each kernel's rows must count its wrapper's launches.
    ``phase_ms``: {row: ms a launch} the phase measured itself, printed
    beside the table's (no gate)."""
    import io

    from artemis_tpu_torch import profiling
    from artemis_tpu_torch.ops import fld as F, stage as S, stage_curv as SC, sweeps as SW

    buf = io.StringIO()
    t0 = time.perf_counter()
    phases = profiling.phase_table(sim, ncycles=PROFILE_CYCLES, out=buf)
    S.stage_launches = S.tiled_launches = S.padded_launches = 0
    SC.stage_curv_launches = SC.tiled_launches = SC.stage_curv_batched_launches = 0
    for h in SC.halo_launches:
        SC.halo_launches[h] = 0
    F.fld_coeffs_launches = F.fld_coeffs_tiled_launches = F.fld_matvec_launches = 0
    SW.sweep_launches = 0
    calls = {}
    secs = profiling.kernel_table(sim, ncycles=PROFILE_KERNEL_CYCLES, out=buf, calls=calls,
                                  warmup=0)
    counted = {"stage_periodic": S.stage_launches - S.padded_launches,
               "stage": S.padded_launches, "stage_curv": SC.halo_launches["padded"],
               "stage_curv_gather": SC.halo_launches["gather"],
               "stage_curv_gather6": SC.halo_launches["gather6"],
               "stage_curv_gather6_batched": SC.stage_curv_batched_launches,
               "fld_coeffs": F.fld_coeffs_launches, "fld_matvec": F.fld_matvec_launches,
               "sweep": SW.sweep_launches}
    print(f"phase 29 (profiling) on {label}:")
    print(buf.getvalue().rstrip())
    plain = [row for row in calls if row.endswith("(plain)")]
    check(calls and not plain, f"{label} kernel_table: plain rows {plain} on the card")
    rows = {}
    for row, n in calls.items():
        name = row.split(" (")[0]
        rows[name] = rows.get(name, 0) + n
    for name, n in counted.items():
        check(rows.get(name, 0) == n, f"{label} kernel_table: {rows.get(name, 0)} {name} "
              f"launches, its counter {n}")
    ms = {row: 1e3 * secs[row] / calls[row] for row in calls}
    print(f"{label} kernel_table rows match the launch counters {rows}; ms a launch "
          + ", ".join(f"{row} {ms[row]:.4f} (phase's own {phase_ms[row]:.4f})"
                      if row in phase_ms else f"{row} {ms[row]:.4f}" for row in ms)
          + f"; tables took {time.perf_counter() - t0:.1f} s [{smi}]")
    return {"phases_s": phases, "rows": calls, "ms": ms}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    smi = phase_toolchain(torch)
    # phase 30's CPU references run in a worker process beside the build
    refs_pool, cpu_refs = start_worker(cpu_small_trees)
    try:
        return run_phases(torch, t0, smi, cpu_refs)
    finally:
        refs_pool.shutdown(wait=True, cancel_futures=True)


def run_phases(torch, t0, smi, cpu_refs):
    """Every phase after the toolchain's, then the kernels line and the
    device line."""
    # the set-ups of phases 11 and 13 (their disk IC is numpy on the host,
    # no kernel runs) go on two threads while nvcc builds the kernels, and
    # all are done before the first timed window
    set_dir = tempfile.TemporaryDirectory()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        pre = {key: pool.submit(timed_build, make) for key, make in (
            ("rhd", lambda: rhd_sim(os.path.join(set_dir.name, "rhd"))),
            ("rhd_plain", lambda: rhd_sim(os.path.join(set_dir.name, "rhd_plain"),
                                          fused=False)),
            ("amr", lambda: amr_sim(os.path.join(set_dir.name, "amr"), AMR_CELL, 2.0)),
            ("amr_plain", lambda: amr_sim(os.path.join(set_dir.name, "amr_plain"), AMR_CELL,
                                          2.0, fused=False)))}
        build_s = phase_build(torch)
        t1 = time.perf_counter()
        built = {key: f.result() for key, f in pre.items()}
        del pre
    print("the set-ups of phases 11 and 13 took " + ", ".join(
        f"{key} {secs:.1f} s" for key, (_, secs) in built.items())
          + f" beside the build; the main thread waited {time.perf_counter() - t1:.1f} s "
          "for them after it")
    phase_s = {}

    def run(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t1
        return out

    res = run("flagship", phase_flagship, torch, smi)
    disk = run("disk_sph", phase_disk, torch, smi)
    decks = run("disk_decks", phase_disk_decks, torch, smi)
    rhd = run("rhd", phase_rhd, torch, smi, built.pop("rhd"), built.pop("rhd_plain"))
    amr = run("amr", phase_amr, torch, smi, built.pop("amr"), built.pop("amr_plain"))
    set_dir.cleanup()
    # the two 512x512x64 disk RHD trees are set up (their disk IC on the
    # host) in the background while rad_shock's host-bound loop runs
    pre_dir = tempfile.TemporaryDirectory()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        pre_prod = pool.submit(timed_build, lambda: amr_sim(
            os.path.join(pre_dir.name, "prod"), AMR_PROD, 4.0))
        pre_adaptive = pool.submit(timed_build, lambda: amr_sim(
            os.path.join(pre_dir.name, "adaptive"), ADAPT_RHD, 4.0,
            extra=adaptive_ov(ADAPT_TILE, ADAPT_CHECK)))
        # and phase 25's straight AMR restart run
        pre_restart = pool.submit(timed_build, lambda: amr_sim(
            os.path.join(pre_dir.name, "restart"), AMR_CELL, 2.0,
            extra=[f"parthenon/time/nlim={RESTART_AMR[0]}"]))
        t1 = time.perf_counter()
        # and, in a worker process on the card, phase 30's small trees, the
        # untimed checks of phases 23 and 26 and the kernel-vs-plain phases
        side_pool, side = start_worker(beside_rad_shock, smi)
        try:
            shock = phase_rad_shock(torch)
            t2 = time.perf_counter()
            phase_s["rad_shock"] = t2 - t1
            side_res, side_secs, side_out = side.result()
            phase_s["rad_shock_wait"] = time.perf_counter() - t2
        finally:
            side_pool.shutdown(wait=True, cancel_futures=True)
        print(f"phase rad_shock: {t2 - t1:.1f} s (the 512x512x64 trees of phases 14 and 26 "
              "set up beside it, sharing the interpreter lock, and in a worker process on the "
              "card phase 30's small trees, simple_drag, the other decks, blast_amr at "
              "numlevel 3 and the kernel-vs-plain phases, which rad_shock then waited "
              f"{phase_s['rad_shock_wait']:.1f} s for)")
        print(side_out, end="")
        print("the worker beside rad_shock: " + ", ".join(
            f"{key} {secs:.1f} s" for key, secs in side_secs.items()))
        (err64, err32), sym, (cerr64, cerr32, cdisk32), fld, g6, (berr64, berr32), (
            serr64, serr32) = (side_res[k] for k in CHECKS_BESIDE)
        cards_small, drag, other = (side_res[k] for k in ("small_trees", "simple_drag",
                                                          "other_decks"))
        # both trees are built before any timed window opens
        t1 = time.perf_counter()
        built_prod, built_adaptive = pre_prod.result(), pre_adaptive.result()
        built_restart = pre_restart.result()
        print(f"the builds of phases 14, 26 and 25 took {built_prod[1]:.1f} + "
              f"{built_adaptive[1]:.1f} + {built_restart[1]:.1f} s; "
              f"the main thread waited {time.perf_counter() - t1:.1f} s for them after "
              "rad_shock")
        del pre_prod, pre_adaptive, pre_restart
    prod = run("amr_prod", phase_amr_prod, torch, smi, built_prod)
    del built_prod
    k5a = run("k5a", phase_k5a, torch, smi)
    strat = run("strat", phase_strat, torch, smi)
    sheet = run("ssheet", phase_ssheet, torch, smi)
    adv = run("advection", phase_advection, torch, smi)
    secs = {}
    for key, fn in (("alpha_disk", phase_alpha_disk), ("binary_cyl", phase_binary),
                    ("nbody", phase_nbody),
                    ("restart", lambda torch, smi: phase_restart(torch, smi, built_restart[0]))):
        t1 = time.perf_counter()
        secs[key] = (fn(torch, smi), time.perf_counter() - t1)
        phase_s[key] = secs[key][1]
        print(f"phase {key}: {secs[key][1]:.1f} s")
    alpha, binary, nbody, restart = (
        secs[k][0] for k in ("alpha_disk", "binary_cyl", "nbody", "restart"))
    del built_restart
    t1 = time.perf_counter()
    adaptive = run("adaptive", phase_adaptive, torch, smi, prod, built_adaptive,
                   side_res["blast3"])
    del built_adaptive
    pre_dir.cleanup()
    print(f"phase adaptive: {time.perf_counter() - t1:.1f} s")
    rest = run("refinement_rest", phase_refinement_rest, torch, smi)
    t1 = time.perf_counter()
    sharded = run("sharded", phase_sharded, torch, smi, res.pop("shard_ref"), res["kernel_zcps"],
                            disk.pop("shard_ref"), disk["kernel_zcps"], shock.pop("shard_ref"))
    print(f"phase sharded: {time.perf_counter() - t1:.1f} s")
    trees = run("sharded_trees", phase_sharded_trees, torch, smi, cpu_refs, cards_small)
    total = time.perf_counter() - t0
    print("main-thread phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))
    print(f"chip_smoke: every phase passed in {total:.0f} s, the build included "
          f"({SMOKE_LIMIT_S - total:.0f} s left of the {SMOKE_LIMIT_S} s limit)")
    group = adaptive["rhd"]["group"]
    kernels = {"kernels": [{
        "name": "stage_cart",
        "kernel": "stage_cart_tiled_kernel (the tiled body)",
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
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        "library_ms": None,
        "percell_ms": res["percell_ms"],
        "registers_spills": res["regs"],
        "padded_ms": res["padded_ms"],
        "padded_stage_ms": res["padded_stage_ms"],
        "padded_percell_ms": res["padded_percell_ms"],
        "padded_percell_stage_ms": res["padded_percell_stage_ms"],
        "padded_registers_spills": res["padded_regs"],
        "padded_plain_ms": res["padded_plain_ms"],
        "padded_bound_ms": res["padded_bound_ms"],
        "padded_bound_by": res["padded_bound_by"],
        "shape": list(FLAGSHIP),
        "dtype": "float32",
        "build_s": build_s,
        "linwave_lr_asymmetry": sym,
        "zone_cycles_per_s": {"kernel_f32": res["kernel_zcps"],
                              "plain_f32": res["plain_zcps"],
                              "kernel_f64": res["kernel_f64_zcps"]},
        "f64_ms": res["f64_ms"],
        "f64_percell_ms": res["f64_percell_ms"],
        "f64_bound_ms": res["f64_bound_ms"],
        "idle_share": res["idle_share"],
        "blast_hllc_launches": other["blast_hllc"]["launches"],
        "blast_hllc_shape": list(other["blast_hllc"]["shape"]),
        "blast_hllc_50cycle_err_f64": other["blast_hllc"]["end_err"],
        "sharded_launches": sharded["flagship"]["launches"],
        "sharded_shards": SHARDS,
        "sharded_zone_cycles_per_s": sharded["flagship"]["zcps"],
        "sharded_max_abs_err_vs_unsharded": sharded["flagship"]["err"],
        "sharded_exchange_share": sharded["flagship"]["exchange_share"],
    }, {
        "name": "stage_curv",
        "kernel": "stage_tiled_kernel (the tiled body, diffusive)",
        "route": "cuda",
        "source": "artemis_tpu_torch/csrc/stage_curv.cu",
        "replaces": "artemis_tpu/ops/pallas_stage_curv.py:1405",
        "launches": disk["launches"],
        "max_abs_err": max(cerr32, disk["stage_err"]),
        "max_abs_err_f64": cerr64,
        "max_abs_err_disk_f32": max(cdisk32, disk["stage_err"]),
        "tol_f32": F32_TOL,
        "tol_disk_f32": DISK_F32_TOL,
        "tol_f64": F64_TOL,
        "ms": disk["ms"],
        "plain_ms": disk["plain_ms"],
        "bound_ms": disk["bound_ms"],
        "bound_by": disk["bound_by"],
        "library_ms": None,
        "kernel_table_ms": disk["tables"]["ms"],
        "percell_ms": disk["percell_ms"],
        "registers_spills": disk["regs"],
        "padded_ms": disk["padded_ms"],
        "padded_stage_ms": disk["padded_stage_ms"],
        "padded_percell_ms": disk["padded_percell_ms"],
        "padded_percell_stage_ms": disk["padded_percell_stage_ms"],
        "padded_fill_share": disk["padded_fill_share"],
        "padded_bound_ms": disk["padded_bound_ms"],
        "padded_bound_by": disk["padded_bound_by"],
        "shape": list(DISK_BENCH),
        "dtype": "float32",
        "disk_l2_vs_ic": disk["l2"],
        "disk_4cycle_rel_err": disk["end_rel_err"],
        "zone_cycles_per_s": {"kernel_f32": disk["kernel_zcps"],
                              "plain_f32": disk["plain_zcps"],
                              "kernel_f64": disk["kernel_f64_zcps"]},
        "restart_launches": restart["disk_sph"]["launches"],
        "restart_bitwise": restart["disk_sph"]["bitwise"],
    }, {
        "name": "stage_curv_padded",
        "kernel": "stage_tiled_kernel (the tiled body, diffusive, padded halo)",
        "route": "cuda",
        "source": "artemis_tpu_torch/csrc/stage_curv.cu",
        "replaces": "artemis_tpu/ops/pallas_stage_curv.py:604",
        "launches": decks["launches"],
        "max_abs_err": max(cerr32, decks["stage_err"]),
        "max_abs_err_f64": cerr64,
        "tol_f32": F32_TOL,
        "tol_disk_f32": DISK_F32_TOL,
        "tol_f64": F64_TOL,
        "ms": decks["padded_ms"],
        "plain_ms": decks["plain_ms"],
        "bound_ms": decks["padded_bound_ms"],
        "bound_by": decks["padded_bound_by"],
        "library_ms": None,
        "sharded_launches": sharded["disk_sph"]["launches"],
        "sharded_shards": SHARDS,
        "sharded_zone_cycles_per_s": sharded["disk_sph"]["zcps"],
        "sharded_max_rel_err_vs_unsharded": sharded["disk_sph"]["err"],
        "sharded_exchange_share": sharded["disk_sph"]["exchange_share"],
        "sharded_l2_vs_ic": sharded["disk_sph"]["l2"],
        "sharded_x1_x2_launches": [sharded[f"disk_sph_{a}"]["launches"] for a in ("x1", "x2")],
        "sharded_x1_x2_max_rel_err_vs_unsharded": [sharded[f"disk_sph_{a}"]["err"]
                                                   for a in ("x1", "x2")],
        "sharded_x1_x2_zone_cycles_per_s": [sharded[f"disk_sph_{a}"]["zcps"]
                                            for a in ("x1", "x2")],
        "percell_ms": decks["padded_percell_ms"],
        "stage_ms": decks["padded_stage_ms"],
        "percell_stage_ms": decks["padded_percell_stage_ms"],
        "fill_share": decks["padded_fill_share"],
        "registers_spills": decks["regs"],
        "shape": list(DISK_CYL_CELL),
        "dtype": DISK_CYL_PRECISION,
        "disk_cyl_l2_vs_ic": decks["l2"],
        "blast_launches": other["blast"]["launches"],
        "blast_50cycle_err_f64": other["blast"]["end_err"],
        "adaptive_blast_amr_launches": adaptive["blast"]["launches"],
        "adaptive_blast_amr_cycles": adaptive["blast"]["ncycle"],
        "adaptive_blast_amr_nodes": adaptive["blast"]["nodes"],
        "adaptive_blast_amr_end_err_f64": adaptive["blast"]["end_err"],
        "adaptive_blast_amr_numlevel3_launches": adaptive["blast3"]["launches"],
        "deck_l2_vs_ic_f64": decks["deck_l2"],
        "cycle_ms": decks["cycle_ms"],
        "idle_share": decks["idle_share"],
        "zone_cycles_per_s": {"kernel": decks["zcps"]},
    }, {
        "name": "stage_curv_partial",
        "kernel": "stage_tiled_kernel (the tiled body, diffusive, padded halo, partial mode)",
        "route": "cuda",
        "source": "artemis_tpu_torch/csrc/stage_curv.cu",
        "replaces": "artemis_tpu/ops/pallas_stage_curv.py:604",
        "launches": alpha["launches"],
        "max_abs_err": max(alpha["err_f32"], binary["err_f32"]),
        "max_abs_err_f64": max(alpha["err_f64"], binary["err_f64"],
                               nbody["binary_nbody_cyl"]["err_f64"]),
        "tol_disk_f32": DISK_F32_TOL,
        "tol_f64": F64_TOL,
        "ms": alpha["ms"],
        "plain_ms": alpha["plain_ms"],
        "bound_ms": alpha["bound_ms"],
        "bound_by": alpha["bound_by"],
        "library_ms": None,
        "stage_ms": alpha["stage_ms"],
        "percell_ms": alpha["percell_ms"],
        "percell_stage_ms": alpha["percell_stage_ms"],
        "registers_spills": alpha["regs"],
        "shape": [512, 1024, 1],
        "dtype": "float64",
        "binary_cyl_launches": binary["launches"],
        "binary_cyl_wake": binary["wake"],
        "end_rel_err_f64": {"alpha_disk": alpha["end_err"], "binary_cyl": binary["end_err"]},
        "cycle_ms": alpha["cycle_ms"],
        "idle_share": alpha["idle_share"],
        "busy_split_ms": alpha["profile"]["split"] if alpha["profile"] else None,
        "zone_cycles_per_s": {"kernel_f64": alpha["zcps"], "plain_f64": alpha["plain_zcps"]},
        "simple_drag": {"err": drag["err"], "momentum_drift": drag["drift"],
                        "cycles": drag["ncycle"]},
        "binary_nbody_cyl_ms": nbody["binary_nbody_cyl"]["ms"],
        "binary_nbody_cyl_percell_ms": nbody["binary_nbody_cyl"]["percell_ms"],
        "binary_nbody_cyl_plain_ms": nbody["binary_nbody_cyl"]["plain_ms"],
        "binary_nbody_cyl_bound_ms": nbody["binary_nbody_cyl"]["bound_ms"],
        "binary_nbody_cyl_bound_by": nbody["binary_nbody_cyl"]["bound_by"],
        "binary_nbody_cyl_idle_share": nbody["binary_nbody_cyl"]["idle_share"],
        "nbody_decks": {name: {key: r[key] for key in (
            "kernel", "launches", "cycle_ms", "zcps", "plain_zcps", "host_ms_per_stage",
            "busy_ms", "idle_share", "end_err", "particle_err")} for name, r in nbody.items()},
        "restart_launches": restart["binary_nbody_cyl"]["launches"],
        "restart_bitwise": restart["binary_nbody_cyl"]["bitwise"],
    }, {
        "name": "stage_curv_gather6",
        "kernel": "stage_tiled_kernel (the tiled body)",
        "route": "cuda",
        "source": "artemis_tpu_torch/csrc/stage_curv.cu",
        "replaces": "artemis_tpu/ops/pallas_stage_curv.py:1867",
        "launches": rhd["launches"][0],
        "max_abs_err": max(g6["float32"], rhd["stage_err"],
                           adaptive["rhd"]["tile_check"]["stage_err"]),
        "max_abs_err_f64": g6["float64"],
        "tol_f32": DISK_F32_TOL,
        "tol_f64": F64_TOL,
        "ms": rhd["ms"],
        "plain_ms": rhd["plain_ms"],
        "bound_ms": rhd["bound_ms"],
        "bound_by": rhd["bound_by"],
        "library_ms": None,
        "kernel_table_ms": rhd["tables"]["ms"],
        "percell_ms": rhd["percell_ms"],
        "registers_spills": rhd["regs"],
        "padded_ms": rhd["padded_ms"],
        "padded_stage_ms": rhd["padded_stage_ms"],
        "shape": list(RHD_CELL),
        "dtype": "float32",
        "rhd_l2_vs_ic": rhd["l2"],
        "zone_cycles_per_s": {"kernel_f32": rhd["kernel_zcps"],
                              "plain_f32": rhd["plain_zcps"]},
        "idle_share": rhd["idle_share"],
        "host_reads_per_cycle": rhd["reads_per_cycle"],
        "rad_shock_cycles": shock["ncycle"],
        "adaptive_rhd_launches": adaptive["rhd"]["launches"]["stage_curv"],
        "adaptive_rhd_tiles": adaptive["rhd"]["tiles"],
        "adaptive_rhd_zone_cycles_per_s": adaptive["rhd"]["zcps"],
        "adaptive_rhd_idle_share": adaptive["rhd"]["idle_share"],
        "adaptive_small_end_err_f32": adaptive["small"]["err"],
        "adaptive_tile_shape": adaptive["rhd"]["tile_check"]["shape"],
        "adaptive_tile_err_f32": adaptive["rhd"]["tile_check"]["stage_err"],
    }, {
        "name": "stage_curv_gather6_viscous",
        "kernel": "stage_tiled_kernel (the tiled body, diffusive)",
        "route": "cuda",
        "source": "artemis_tpu_torch/csrc/stage_curv.cu",
        "replaces": "artemis_tpu/ops/pallas_stage_curv.py:1783",
        "launches": k5a["launches"],
        "max_abs_err": max(g6["float32"], k5a["err"]),
        "max_abs_err_f64": g6["float64"],
        "tol_f32": DISK_F32_TOL,
        "tol_f64": F64_TOL,
        "ms": k5a["ms"],
        "plain_ms": k5a["plain_ms"],
        "bound_ms": k5a["bound_ms"],
        "bound_by": k5a["bound_by"],
        "library_ms": None,
        "percell_ms": k5a["percell_ms"],
        "registers_spills": k5a["regs"],
        "shape": list(DISK_BENCH),
        "dtype": "float32",
    }, {
        "name": "fld_coeffs",
        "kernel": "coeffs_tiled_kernel (the tiled body)",
        "route": "cuda",
        "source": "artemis_tpu_torch/csrc/fld.cu",
        "replaces": "artemis_tpu/ops/pallas_fld.py:88",
        "launches": rhd["launches"][1],
        "max_abs_err": max(fld["float32"][0], rhd["coeffs_err"][0],
                           adaptive["rhd"]["tile_check"]["coeffs_err"][0]),
        "max_abs_err_f64": fld["float64"][0],
        "max_rel_err": max(fld["float32"][1], rhd["coeffs_err"][1],
                           adaptive["rhd"]["tile_check"]["coeffs_err"][1]),
        "max_rel_err_f64": fld["float64"][1],
        "tol_rel_f32": FLD_TOL["float32"],
        "tol_rel_f64": FLD_TOL["float64"],
        "ms": rhd["coeffs_ms"],
        "plain_ms": rhd["coeffs_plain_ms"],
        "bound_ms": rhd["coeffs_bound_ms"],
        "bound_by": rhd["coeffs_bound_by"],
        "library_ms": None,
        "percell_ms": rhd["coeffs_percell_ms"],
        "registers_spills": rhd["coeffs_regs"],
        "amr_nodes_ms": [c["coeffs_ms"] for c in amr["coeffs_nodes"]],
        "amr_nodes_percell_ms": [c["coeffs_percell_ms"] for c in amr["coeffs_nodes"]],
        "amr_nodes_bound_ms": [c["coeffs_bound_ms"] for c in amr["coeffs_nodes"]],
        "amr_launches": amr["launches"]["fld_coeffs"],
        "adaptive_rhd_launches": adaptive["rhd"]["launches"]["fld_coeffs"],
        "adaptive_tile_rel_err_f32": adaptive["rhd"]["tile_check"]["coeffs_err"][1],
        "shape": list(RHD_CELL),
        "dtype": "float32",
    }, {
        "name": "fld_matvec",
        "route": "cuda",
        "source": "artemis_tpu_torch/csrc/fld.cu",
        "replaces": "artemis_tpu/ops/pallas_fld.py:188",
        "launches": rhd["launches"][2],
        "max_abs_err": max(fld["float32"][0], rhd["matvec_err"][0],
                           adaptive["rhd"]["tile_check"]["matvec_err"][0]),
        "max_abs_err_f64": fld["float64"][0],
        "max_rel_err": max(fld["float32"][1], rhd["matvec_err"][1],
                           adaptive["rhd"]["tile_check"]["matvec_err"][1]),
        "max_rel_err_f64": fld["float64"][1],
        "tol_rel_f32": FLD_TOL["float32"],
        "tol_rel_f64": FLD_TOL["float64"],
        "ms": rhd["matvec_ms"],
        "plain_ms": rhd["matvec_plain_ms"],
        "bound_ms": rhd["matvec_bound_ms"],
        "bound_by": rhd["matvec_bound_by"],
        "library_ms": rhd["matvec_library_ms"],
        "library": "torch.mv of a CSR matrix (cuSPARSE SpMV)",
        "library_rel_err": rhd["library_rel_err"],
        "shape": list(RHD_CELL),
        "dtype": "float32",
        "cg_iters_per_outer": rhd["cg_per_outer"],
        "adaptive_rhd_launches": adaptive["rhd"]["launches"]["fld_matvec"],
        "adaptive_tile_rel_err_f32": adaptive["rhd"]["tile_check"]["matvec_err"][1],
    }] + [{
        "name": f"{name} (node axis)",
        "kernel": body + " over a node axis (blockIdx.y)",
        "route": "cuda",
        "source": "artemis_tpu_torch/csrc/fld.cu",
        "replaces": replaces,
        "launches": adaptive["rhd"]["launches"][f"{name}_node"],
        "max_abs_err": max(fld["node_axis"]["float32"][0], group[f"{key}_err"][0]),
        "max_abs_err_f64": fld["node_axis"]["float64"][0],
        "max_rel_err": max(fld["node_axis"]["float32"][1], group[f"{key}_err"][1]),
        "max_rel_err_f64": fld["node_axis"]["float64"][1],
        "tol_rel_f32": FLD_TOL["float32"],
        "tol_rel_f64": FLD_TOL["float64"],
        "ms": group[f"{key}_ms"],
        "plain_ms": group[f"{key}_plain_ms"],
        "bound_ms": group[f"{key}_bound_ms"],
        "bound_by": group[f"{key}_bound_by"],
        "library_ms": group.get(f"{key}_library_ms"),
        "one_node_launches_ms": group[f"{key}_one_ms"],
        "nodes": group["nodes"],
        "node_shape_x1_x2_x3": group["shape"],
        "dtype": "float32",
        "adaptive_rhd_launches_per_cycle": adaptive["rhd"]["launches"][f"{name}_node"]
        / ADAPT_CYCLES,
        "adaptive_rhd_host_reads_per_cycle": adaptive["rhd"]["reads_per_cycle"],
    } for name, key, body, replaces in (
        ("fld_coeffs", "coeffs", "coeffs_tiled_kernel", "artemis_tpu/ops/pallas_fld.py:88"),
        ("fld_matvec", "matvec", "fld_kernel", "artemis_tpu/ops/pallas_fld.py:188"))] + [{
        "name": "stage_curv_batched",
        "kernel": "stage_tiled_kernel (the tiled body)",
        "route": "cuda",
        "source": "artemis_tpu_torch/csrc/stage_curv.cu",
        "replaces": "artemis_tpu/ops/pallas_stage_curv.py:2209",
        "launches": amr["launches"]["stage_curv_batched"],
        "max_abs_err": max(berr32, amr["stage_err"]),
        "max_abs_err_f64": berr64,
        "tol_f32": F32_TOL,
        "tol_disk_f32": DISK_F32_TOL,
        "tol_f64": F64_TOL,
        "ms": amr["ms"],
        "plain_ms": amr["plain_ms"],
        "bound_ms": amr["bound_ms"],
        "bound_by": amr["bound_by"],
        "library_ms": None,
        "percell_ms": amr["percell_ms"],
        "registers_spills": amr["regs"],
        "nodes": 2,
        "k5b_pair_ms": amr["k5b_pair_ms"],
        "padded_pair_ms": amr["padded_pair_ms"],
        "padded_fill_pair_ms": amr["padded_fill_pair_ms"],
        "tree_stage_ms": amr["tree_stage_ms"],
        "glue_ms": amr["glue_ms"],
        "shape": list(AMR_CELL),
        "dtype": "float32",
        "amr_l2_vs_ic": amr["l2"],
        "amr_production_l2_vs_ic": prod["l2"],
        "zone_cycles_per_s": {"kernel_f32_all_levels": amr["zcps"],
                              "plain_f32_all_levels": amr["plain_zcps"],
                              "production_kernel_f32_all_levels": prod["zcps"]},
        "idle_share": amr["idle_share"],
        "host_reads_per_cycle": amr["reads_per_cycle"],
        "restart_launches": restart["amr"]["launches"],
        "restart_bitwise": restart["amr"]["bitwise"],
        "restart_checkpoint_mb": restart["amr"]["mb"],
    }, {
        "name": "sweep",
        "route": "cuda",
        "source": "artemis_tpu_torch/csrc/sweep.cu",
        "replaces": "artemis_tpu/ops/pallas_sweeps.py:162",
        "also_replaces": "artemis_tpu/ops/pallas_sweeps.py:210",
        "launches": strat["launches"],
        "max_abs_err": serr32,
        "max_abs_err_f64": serr64,
        "strat_max_scaled_err": strat["err"],
        "tol_f32": F32_TOL,
        "tol_f64": F64_TOL,
        "ms": sum(strat["ms"]) / 3,
        "plain_ms": sum(strat["plain_ms"]) / 3,
        "bound_ms": sum(strat["bound_ms"]) / 3,
        "bound_by": strat["bound_by"][0],
        "library_ms": None,
        "ms_by_direction": strat["ms"],
        "plain_ms_by_direction": strat["plain_ms"],
        "bound_ms_by_direction": strat["bound_ms"],
        "shape": list(STRAT_CELL),
        "dtype": "float32",
        "strat_density_drift": strat["drift"],
        "strat_max_vz": strat["vz"],
        "strat_4cycle_err": strat["end_err"],
        "ssheet_launches": sheet["launches"],
        "ssheet_10cycle_err_f64": sheet["end_err"],
        "advection_l1_n32": adv["l1"],
        "advection_ratio": adv["ratio"],
        "advection_launches": adv["launches"],
        "sharded_tree_launches": {key: trees[key]["launches"] for key in (
            "flagship_wrap", "flagship_distributed")},
        "sharded_tree_launches_per_cycle": {key: trees[key]["launches"] // TREE_CMP_CYCLES
                                            for key in ("flagship_wrap",
                                                        "flagship_distributed")},
        "sharded_tree_shards": SHARDS,
        "sharded_tree_max_err_vs_unsharded": {key: trees[key]["err"] for key in (
            "flagship_wrap", "flagship_distributed", "disk_ring")},
        "sharded_tree_zone_cycles_per_s": {key: [trees[key]["zcps"], trees[key]["unsharded_zcps"]]
                                           for key in ("flagship_wrap", "flagship_distributed",
                                                       "disk_ring")},
        "sharded_tree_small_f64": trees["small"],
        "sharded_tree_restart_bitwise": trees["restart_bitwise"],
        "dust_tree_launches": rest["dust"]["launches"],
        "dust_tree_end_err_f64": rest["dust"]["err"],
        "dust_tree_mass_drift_f64": rest["dust"]["drift"],
        "conduction_launches": other["conduction"]["launches"],
        "gaussian_bump_launches": other["gaussian_bump"]["launches"],
        "deck_50cycle_err_f64": {"conduction": other["conduction"]["end_err"],
                                 "gaussian_bump": other["gaussian_bump"]["end_err"]},
        "zone_cycles_per_s": {"kernel_f32": strat["kernel_zcps"],
                              "plain_f32": strat["plain_zcps"],
                              "advection_kernel_f32": adv["kernel_zcps"],
                              "advection_plain_f32": adv["plain_zcps"],
                              "dust_tree_kernel_f64_all_levels": rest["dust"]["zcps"],
                              "dust_tree_plain_f64_all_levels": rest["dust"]["plain_zcps"]},
        "idle_share": strat["idle_share"],
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
