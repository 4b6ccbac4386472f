#!/usr/bin/env python3
"""Where the time of the tiled stage goes (``stage_tiled_kernel`` in
``artemis_tpu_torch/csrc/stage_curv.cu``: without diffusion K5b and K6,
with it K3 and K5a), on one CUDA card.

Run from the repository root:

    python tools/tile_probe.py [--build-only] [VARIANT ...]

(all variants when none is named; ``--build-only`` prints ptxas's
registers and spills of the two tiled kernels and times nothing).

Each variant is a copy of ``artemis_tpu_torch`` in a temporary directory
with one textual change to the kernel source (and the wrapper's tile
constants where the change needs it), built for float32 with nvcc, all
builds in parallel.  Each is then timed in a process of its own, twice in
turn, 20 launches per timing after a warm-up, CUDA events, on one of two
states.  The inviscid variants take the RHD cell's shape: a 512x512x64
float32 Cartesian node with a point mass, a random smooth state and
random six-face strips (seeded).  The ``visc`` variants take disk_sph's
stage at bench.py's 256x64x64 float32 (alpha viscosity, point gravity,
rotating frame; x1/x2 ic strips, x3 wrapped: K3) from the deck's initial
state.  The variants:

* ``tiled``: the source as it is, and the per-cell body on the same state
  through the wrapper's private switch;
* ``no-ureg``: the update reads u0, u1 from device memory, not from the
  copies staged in shared memory;
* ``4-byte``: every staging copy 4 bytes through L1 (no 16-byte copies);
* ``one-block``: launch bounds of one block per SM (more registers, half
  the resident warps);
* ``z8``, ``z32``: z chunks of 8 and 32 planes per block (16 as built);
* probes that leave phases out (their outputs are wrong, their times are
  what is left): ``load-only`` (staging, barriers), ``no-update`` (the
  update, sources and C2P of phase C), ``no-solve`` (the Riemann solves of
  phase B), ``no-values`` (the reconstruction of the next plane's face
  values in phase C);
* ``visc``: the diffusive body as it is on K3, and the per-cell body;
  ``visc-z8``: its z chunks of 8 planes (512 blocks, two waves);
  ``visc-one-block``: its launch bound of one block per SM; and the
  probes ``visc-no-faces`` (no diffusive face is solved: x/y in phase B, z
  in phase C) and ``visc-no-cells`` (no cell quantity of the next plane is
  made: neither the rim's nor the column's own, nor the x3 face's
  gradients of v^3).

Prints the card's name and power limit, ptxas's registers and spills per
variant, and each variant's ms per launch; the variants that compute the
stage are checked bitwise against the per-cell body.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = "artemis_tpu_torch/csrc/stage_curv.cu"
PY = "artemis_tpu_torch/ops/stage_curv.py"
SKIP_UPDATE = ("      if (own) {\n        const int64_t cell", "      if (false) {\n        const int64_t cell")
SKIP_SOLVE = ("      tile_solve(C, m, tp, k, slot(k), slot(k + 1), slot(k + 2), tid, st);\n", "")
SKIP_VALUES = ("        tile_face_values(C, m, tp, slot(k + 1), tid);\n", "")
VEC16 = "reinterpret_cast<uintptr_t>(row) % 16 == 0"
# the TileDims of the f32 bodies without (F32) and with (F32D) diffusion
F32 = "struct TileDims<float, false> {\n  static constexpr int TX = 32, TY = 8, TZ = 16, MINB = 2;"
F32D = "struct TileDims<float, true> {\n  static constexpr int TX = 32, TY = 8, TZ = 16, MINB = 2;"
PY_TILE = "(torch.float32, {}): (32, 8, 16)"


def zchunk(n, diff=False):
    dims = F32D if diff else F32
    return [(CU, dims, dims.replace("TZ = 16", f"TZ = {n}")),
            (PY, PY_TILE.format(diff), PY_TILE.format(diff).replace("16)", f"{n})"))]


VARIANTS = {
    "tiled": [],
    "no-ureg": [(CU, F32 + "\n  static constexpr bool UREG = true;",
                 F32 + "\n  static constexpr bool UREG = false;")],
    "4-byte": [(CU, VEC16, "false")],
    "one-block": [(CU, F32, F32.replace("MINB = 2", "MINB = 1"))],
    "z8": zchunk(8),
    "z32": zchunk(32),
    "load-only": [(CU, *SKIP_UPDATE), (CU, *SKIP_SOLVE), (CU, *SKIP_VALUES)],
    "no-update": [(CU, *SKIP_UPDATE)],
    "no-solve": [(CU, *SKIP_SOLVE)],
    "no-values": [(CU, *SKIP_VALUES)],
    "visc": [],
    "visc-z8": zchunk(8, diff=True),
    "visc-one-block": [(CU, F32D, F32D.replace("MINB = 2", "MINB = 1"))],
    "visc-no-faces": [(CU, "    if (DIFF) {\n      T F[4];\n      visc_face",
                       "    if (false) {\n      T F[4];\n      visc_face"),
                      (CU, "          visc_face<T, true, 3>(C, k + 1, j, i, za, zb, vtop);\n",
                       "#pragma unroll\n          for (int q = 0; q < 4; ++q) vtop[q] = T(0);\n")],
    "visc-no-cells": [(CU, "        if (DIFF) tile_q(C, m, tp, s, slot(k + 1), slot(k + 2), k + 1, "
                           "tid, true);\n", ""),
                      (CU, "        cell_q(C, m, s, slot(k + 1), slot(k + 2), ty + 1, tx + 1, k + 1, "
                           "j, i, false, qb);\n",
                       "#pragma unroll\n        for (int w = 0; w < kQCell; ++w) qb[w] = T(1);\n"),
                      (CU, "          const ZCell<T> zb = zcell(C, m, slot(k + 1), ty + 1, tx + 1, "
                           "k + 1, j, i, qb);\n",
                       "          const ZCell<T> zb{{qb[0], qb[1], qb[2]}, qb[kQmuv], qb[kQmuc], "
                       "qb[kQdiv], T(0), T(0), T(0), T(0)};\n")],
}
PROBES = ("load-only", "no-update", "no-solve", "no-values", "visc-no-faces", "visc-no-cells")

BUILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
from artemis_tpu_torch import _build
from artemis_tpu_torch.ops import stage_curv as SC
_build.load("stage_curv", SC.build_defines(torch.float32))
log = _build.build_log.get(_build.variant("stage_curv", SC.build_defines(torch.float32)))
lines = (log[1] if log else "").splitlines()
out = []
for body, entry in (("inviscid", "stage_tiled_kernelIfLb0EE"), ("diffusive", "stage_tiled_kernelIfLb1EE")):
    at = [i for i, l in enumerate(lines) if "Compiling entry" in l and entry in l]
    out.append(body + ": " + (", ".join(l.split(":", 1)[-1].strip() for l in lines[at[0]:at[0] + 4]
                                         if "registers" in l or "spill" in l) if at else "not read"))
print("; ".join(out))
"""

TIMER = r"""
import itertools, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from artemis_tpu_torch.config import ParameterInput
from artemis_tpu_torch.driver import curv_point_grav
from artemis_tpu_torch.grid import grid_from_input
from artemis_tpu_torch.ops import stage_curv as SC
from artemis_tpu_torch.ops.hydro import FluidCfg, Hydro
from artemis_tpu_torch.sources import Gravity
from artemis_tpu_torch.units import Constants, Units

assert SC.__file__.startswith(sys.argv[1]), SC.__file__
name, probe, deck = sys.argv[2], sys.argv[3] == "1", sys.argv[4]
dev, dt_ = "cuda", torch.float32


def disk_stage():
    # disk_sph at bench.py's shape: its gather stage and initial state
    import tempfile

    from artemis_tpu_torch import Simulation

    sim = Simulation(deck, ["parthenon/mesh/nx1=256", "parthenon/mesh/nx2=64",
                            "parthenon/mesh/nx3=64", "artemis/precision=float32"],
                     tempfile.mkdtemp(), device=dev)
    return sim.driver._curv, sim.state["gas"]["u"], sim.state["gas"]["w"]


pin = ParameterInput.from_string('''
<artemis>
problem = constant
coordinates = cartesian
<parthenon/mesh>
nghost = 2
nx1 = 512
x1min = -4.0
x1max = 4.0
nx2 = 512
x2min = -4.0
x2max = 4.0
nx3 = 64
x3min = -0.5
x3max = 0.5
<gas>
gamma = 1.4
<gravity/point>
mass = 1.0
soft = 0.05
''')
grid = grid_from_input(pin)
cfg = FluidCfg(fluid="gas", recon="plm", rsolver="hllc", gamma=1.4, cfl=0.3)
hyd = Hydro(grid, cfg, device=dev, dtype=dt_)
rng = np.random.default_rng(1)


def prims(shape):
    a = np.empty((6,) + shape, dtype=np.float32)
    a[0] = 1 + 0.2 * rng.random(shape)
    a[1:4] = 0.3 * (rng.random((3,) + shape) - 0.5)
    a[5] = 1 + 0.2 * rng.random(shape)
    a[4] = 0.4 * a[0] * a[5]
    return a


if name.startswith("visc"):
    cs, u, w = disk_stage()
    assert cs.diffusive and cs.halo == "gather"
else:
    nx, ny, nz = grid.nx
    u, w = hyd.prim_to_cons(torch.as_tensor(prims((nz, ny, nx))[None], device=dev), cfg)
    strips = {k: prims(s[1:]) for k, s in zip(SC.STRIP_KEYS, SC.strip_shapes(grid))}
    grav = Gravity(pin, grid, Constants.from_units(Units.from_input(pin))).place(dev, dt_)
    cs = SC.CurvStage(hyd, gravity=grav, gmode=curv_point_grav(grid, grav), strips=strips)
u1 = u.clone()
dt = torch.full((1,), 1e-4, dtype=dt_, device=dev)
calls = itertools.cycle([(0.0, 1.0, 1.0), (0.5, 0.5, 0.5)])


def stage():
    return SC.stage_curv(cs, w, u, u1, *next(calls), dt, 0.0, False)


def ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


t = ms(stage)
line = f"{name}: {t:.4f} ms per launch"
if not probe:
    x = SC.stage_curv(cs, w, u, u1, 0.5, 0.5, 0.5, dt, 0.0, False)
    with SC._percell_body():
        y = SC.stage_curv(cs, w, u, u1, 0.5, 0.5, 0.5, dt, 0.0, False)
        pc = ms(stage, 10) if name in ("tiled", "visc") else None
    torch.cuda.synchronize()
    same = (torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
            and torch.equal(x[2].amax(), y[2].amax()))
    line += f", bitwise equal to the per-cell body: {same}"
    if pc is not None:
        line += f"; the per-cell body {pc:.4f} ms"
print(line, flush=True)
"""


def variant_tree(base, name, subs):
    d = os.path.join(base, name)
    shutil.copytree(os.path.join(ROOT, "artemis_tpu_torch"), os.path.join(d, "artemis_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, a, b in subs:
        path = os.path.join(d, rel)
        text = open(path).read()
        if a not in text:
            raise SystemExit(f"variant {name}: the source no longer holds {a!r}")
        with open(path, "w") as f:
            f.write(text.replace(a, b))
    return d


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    args = sys.argv[1:]
    build_only = "--build-only" in args
    names = [a for a in args if a != "--build-only"] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as base:
        dirs = {n: variant_tree(base, n, VARIANTS[n]) for n in names}
        builds = {n: subprocess.Popen([sys.executable, "-c", BUILD, d], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                  for n, d in dirs.items()}
        for n, p in builds.items():
            out = p.communicate()[0].strip().splitlines()
            if p.returncode != 0:
                raise SystemExit(f"variant {n} did not build:\n" + "\n".join(out[-30:]))
            print(f"{n}: {out[-1]}", flush=True)
        print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)
        if build_only:
            return
        timer = os.path.join(base, "timer.py")
        with open(timer, "w") as f:
            f.write(TIMER)
        for _ in range(2):
            for n, d in dirs.items():
                r = subprocess.run([sys.executable, timer, d, n, "1" if n in PROBES else "0",
                                    os.path.join(ROOT, "inputs", "disk_sph.in")],
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    raise SystemExit(f"variant {n} failed:\n{r.stderr[-3000:]}")
                print(r.stdout.strip() + f" [{smi}]", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
