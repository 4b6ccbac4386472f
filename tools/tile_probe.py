#!/usr/bin/env python3
"""Where the time of the tiled stages goes (``stage_tiled_kernel`` in
``artemis_tpu_torch/csrc/stage_curv.cu``: without diffusion K5b and K6,
with it K3, K5a and K4; ``stage_cart_tiled_kernel`` in ``stage_cart.cu``:
K1 and K2; ``coeffs_tiled_kernel`` in ``fld.cu``: K7), on one CUDA card.

Run from the repository root:

    python tools/tile_probe.py [--build-only] [VARIANT ...]
    python tools/tile_probe.py --build-split

(all variants when none is named; ``--build-only`` prints ptxas's
registers and spills of the variants' tiled kernels and times nothing;
``--build-split`` times the stage_curv build as the wrapper makes it, one
nvcc run per dtype and mode, four in parallel, against one run per dtype
carrying both modes, two in parallel, each from a fresh copy).

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
state.  The ``cart`` variants take the Cartesian flagship's K1: the
periodic 256x256x128 float32 box of ``inputs/linwave.in`` with PLM and
HLLC on a random smooth state (seeded), the two RK stages in turn.  The
variants:

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
* ``padded``: K4, the diffusive body reading a padded array (disk_sph's
  stage from the same state, its ic ghost fill made once outside the
  timing), and the per-cell body on the same padded array;
* ``visc``: the diffusive body as it is on K3, and the per-cell body;
  ``visc-z8``: its z chunks of 8 planes (512 blocks, two waves);
  ``visc-one-block``: its launch bound of one block per SM; and the
  probes ``visc-no-faces`` (no diffusive face is solved: x/y in phase B, z
  in phase C) and ``visc-no-cells`` (no cell quantity of the next plane is
  made: neither the rim's nor the column's own, nor the x3 face's
  gradients of v^3);
* ``cart``: the Cartesian tiled body as it is on K1, and the per-cell
  body; ``cart-no-ureg``, ``cart-4-byte``, ``cart-one-block``,
  ``cart-z8``, ``cart-z32``: as above; ``cart-no-ahead``: the ring
  without its extra slot, each plane asked for during the update only;
  ``cart-y-first``: the y face values past one per thread on the first
  warps too (with the x ones), not on the last; ``cart-fmad``: stage_cart
  built with multiply-add contraction (without ``-fmad=false``), both
  bodies timed; and the probes ``cart-no-faces`` (no Riemann
  solve: neither the x/y faces of phase B nor the z face), ``cart-no-update``
  (no cell of phase C is updated or stored), ``cart-no-values`` (no face
  value of the next plane is reconstructed) and ``cart-load-only``
  (staging and barriers only);
* ``fld``: fld_coeffs (K7) on its tiled body as it is, and on the per-cell
  body, with fld_matvec (K8), on the RHD cell's 512x512x64 float32 shape
  (random E, chi and sf, seeded; Dirichlet edges on every face);
  ``fld-fmad``: fld.cu built with multiply-add contraction (without
  ``-fmad=false``), both bodies and K8 timed; ``fld-ahead1``: the tiled
  body's copies one plane ahead instead of two; ``fld-z32``: z chunks of
  32 planes (16 as built); ``fld-ty16``: a 32 x 16 footprint of 512
  threads (32 x 8 as built); ``fld-no-minb``: no launch bound of blocks
  per SM (six in f32 as built; without it, 58 registers hold four);
  ``fld-two-pass``: the
  simpler alternative, Dcell of every cell in one pass, then each cell's
  faces from Dcell through L1/L2 in a second (11 fields moved instead of
  10).
* ``partial``: K4's partial mode on the tiled body as it is (float64, the
  diffusive body: a 32 x 8 footprint, the four-plane ring, one block per
  SM at ~231 registers), and on the per-cell body, on alpha_disk's
  512x1024 state as written (the deck's initial state, its viscous ghost
  fill made once outside the timing); the alternatives, which change the
  f64 diffusive body of full stages too but time the partial one:
  ``partial-ty4`` (a 32 x 4 footprint of 128 threads on the four-plane
  ring, one block per SM), ``partial-ring1`` (a 2-D node's ring sized for
  its one plane), ``partial-ty4-ring1`` (both: 91,200 B a block, two
  blocks per SM) and ``partial-ty4-ring1-minb3`` (with a launch bound of
  three blocks per SM, at most 168 registers); ``partial-nbody`` and
  ``partial-nbody-ty4-ring1``: the body as it is and the two-block
  alternative on binary_nbody_cyl's 128x256 state (the per-cell body
  beside the first); ``partial-coll``: the inviscid partial body as it is
  on disk_collision's 128x256 state, and the per-cell body.

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
CART = "artemis_tpu_torch/csrc/stage_cart.cu"
CART_SOLVE = ("      tile_solve(p, m, tp, tid);\n      if (az && own(tid)) tile_zface(", "      if (false) tile_zface(")
CART_UPDATE = ("      if (own(tid)) {\n        const int x = tid % L::TX", "      if (false) {\n        const int x = tid % L::TX")
CART_VALUES = ("      if (k + 1 < tp.z1) tile_face_values(p, m, tp, slot(k + 1), tid);\n", "")


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
FLD = "artemis_tpu_torch/csrc/fld.cu"
FLD_TWO_PASS = r"""
// two passes: Dcell of every cell, then each cell's faces from Dcell
template <typename T>
__global__ void __launch_bounds__(kBlock) dcell_pass(const __grid_constant__ FldParams p) {
  const int64_t n = int64_t(p.n.nx) * p.n.ny * p.n.nz;
  const int64_t cell = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  static_cast<T*>(p.out2)[cell] = dcell(p, static_cast<const T*>(p.E),
                                        static_cast<const T*>(p.chi), cell_of(p.n, cell));
}

template <typename T>
__global__ void __launch_bounds__(kBlock) faces_pass(const __grid_constant__ FldParams p) {
  const FldInts& n = p.n;
  const int64_t ncell = int64_t(n.nx) * n.ny * n.nz;
  const int64_t cell = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= ncell) return;
  const T* D = static_cast<const T*>(p.out2);
  const Cell c = cell_of(n, cell);
  const int pos[3] = {c.i, c.j, c.k};
  T Dp[3], Dm[3];
  for (int d = 0; d < 3; ++d) {
    const Cell a = step(n, c, d, 1), b = step(n, c, d, -1);
    Dp[d] = D[at(n, a.k, a.j, a.i)];
    Dm[d] = D[at(n, b.k, b.j, b.i)];
  }
  coeffs_store(p, static_cast<const T*>(p.dt)[0], cell, pos, D[cell], Dp, Dm);
}

int launch_two_pass(int dtype, const FldParams& p, void* stream) {
  const int64_t n = int64_t(p.n.nx) * p.n.ny * p.n.nz;
  const unsigned nblk = unsigned((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dcell_pass<float><<<nblk, kBlock, 0, s>>>(p);
    faces_pass<float><<<nblk, kBlock, 0, s>>>(p);
  } else {
    dcell_pass<double><<<nblk, kBlock, 0, s>>>(p);
    faces_pass<double><<<nblk, kBlock, 0, s>>>(p);
  }
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64.  tiled:"""
VARIANTS.update({
    "padded": [],
    "fld": [],
    "fld-fmad": [("artemis_tpu_torch/_build.py", '"stage_cart": ("-fmad=false",),\n                "fld": ("-fmad=false",)}',
                  '"stage_cart": ("-fmad=false",)}')],
    "fld-ahead1": [(FLD, "TZ = 16, NT = TX * TY, AHEAD = 2;", "TZ = 16, NT = TX * TY, AHEAD = 1;")],
    "fld-z32": [(FLD, "TX = 32, TY = 8, TZ = 16,", "TX = 32, TY = 8, TZ = 32,")],
    "fld-ty16": [(FLD, "TX = 32, TY = 8, TZ = 16,", "TX = 32, TY = 16, TZ = 16,")],
    "fld-no-minb": [(FLD, "__launch_bounds__(FldTile<T>::NT, FldTile<T>::MINB)",
                     "__launch_bounds__(FldTile<T>::NT)")],
    "fld-two-pass": [(FLD, "}  // namespace\n\n// dtype: 0 float32, 1 float64.  tiled:", FLD_TWO_PASS),
                     (FLD, "return tiled ? launch_tiled(dtype, p, stream)",
                      "return tiled ? launch_two_pass(dtype, p, stream)")],
})
VARIANTS.update({
    "cart": [],
    "cart-no-ureg": [(CART, "static constexpr bool UREG = !(F32 && METHOD == kPPM);",
                      "static constexpr bool UREG = false;")],
    "cart-no-ahead": [(CART, "static constexpr bool AHEAD = METHOD == kPCM || "
                             "(F32 ? METHOD == kPLM : METHOD == kPPM);",
                       "static constexpr bool AHEAD = false;")],
    "cart-4-byte": [(CART, "reinterpret_cast<uintptr_t>(g) % 16 == 0", "false"),
                    (CART, "reinterpret_cast<uintptr_t>(row) % 16 == 0", "false")],
    "cart-one-block": [(CART, "MINB = (!F32 && METHOD == kPPM) ? 1 : 2;", "MINB = 1;")],
    "cart-z8": [(CART, "TZ = 16;", "TZ = 8;"),
                ("artemis_tpu_torch/ops/stage.py", "torch.float32: (32, 8, 16)",
                 "torch.float32: (32, 8, 8)")],
    "cart-z32": [(CART, "TZ = 16;", "TZ = 32;"),
                 ("artemis_tpu_torch/ops/stage.py", "torch.float32: (32, 8, 16)",
                  "torch.float32: (32, 8, 32)")],
    "cart-fmad": [("artemis_tpu_torch/_build.py",
                   'SOURCE_FLAGS = {"stage_curv": ("-fmad=false",), "stage_cart": ("-fmad=false",),',
                   'SOURCE_FLAGS = {"stage_curv": ("-fmad=false",),')],
    "cart-y-first": [(CART, "for (int e = L::NT - 1 - tid; e < (L::TY + 2) * L::TX; e += L::NT)",
                      "for (int e = tid; e < (L::TY + 2) * L::TX; e += L::NT)")],
    "cart-no-faces": [(CART, *CART_SOLVE)],
    "cart-no-update": [(CART, *CART_UPDATE)],
    "cart-no-values": [(CART, *CART_VALUES)],
    "cart-load-only": [(CART, *CART_SOLVE), (CART, *CART_UPDATE), (CART, *CART_VALUES)],
})
# the f64 diffusive body's footprint and launch bound (TY, MINB)
F64D = "struct TileDims<double, true> {\n  static constexpr int TX = 32, TY = 8, TZ = 16, MINB = 1;"
TY4 = [(CU, F64D, F64D.replace("TY = 8, TZ = 16, MINB = 1", "TY = 4, TZ = 16, MINB = 2"))]
TY4_MINB3 = [(CU, F64D, F64D.replace("TY = 8, TZ = 16, MINB = 1", "TY = 4, TZ = 16, MINB = 3"))]
# a 2-D node's ring sized for its one plane: the layout's faces follow one
# plane, the slot is 0, and the launch asks for that much shared memory
RING1 = [(CU, "__device__ __forceinline__ TileMem(T* s, bool padded)\n"
              "      : ring(s + (padded ? 2 : 0)), xl(s + kRing * L::PLANE),",
          "__device__ __forceinline__ TileMem(T* s, bool padded, int nring = kRing)\n"
          "      : ring(s + (padded ? 2 : 0)), xl(s + nring * L::PLANE),"),
         (CU, "  const TileMem<T, DIFF> m(smem, padded);\n"
              "  const TilePos tp = tile_pos<T, DIFF>(n, blk);\n"
              "  const bool az = n.nz > 1;\n"
              "  auto slot = [&](int kk) { return (kk - tp.z0 + 2) & (kRing - 1); };",
          "  const TileMem<T, DIFF> m(smem, padded, n.nz > 1 ? kRing : 1);\n"
          "  const TilePos tp = tile_pos<T, DIFF>(n, blk);\n"
          "  const bool az = n.nz > 1;\n"
          "  auto slot = [&](int kk) { return az ? (kk - tp.z0 + 2) & (kRing - 1) : 0; };"),
         (CU, "<<<grid, TileLayout<T, DIFF>::NT, TileLayout<T, DIFF>::BYTES, stream>>>(p);",
          "<<<grid, TileLayout<T, DIFF>::NT, TileLayout<T, DIFF>::BYTES - (p.n.nz > 1 ? 0 : "
          "(kRing - 1) * TileLayout<T, DIFF>::PLANE * int(sizeof(T))), stream>>>(p);")]
VARIANTS.update({
    "partial": [],
    "partial-ty4": TY4,
    "partial-ring1": RING1,
    "partial-ty4-ring1": TY4 + RING1,
    "partial-ty4-ring1-minb3": TY4_MINB3 + RING1,
    "partial-nbody": [],
    "partial-nbody-ty4-ring1": TY4 + RING1,
    "partial-coll": [],
})
PARTIAL_DECKS = {"partial-coll": "disk_collision.in", "partial-nbody": "binary_nbody_cyl.in",
                 "partial-nbody-ty4-ring1": "binary_nbody_cyl.in"}
PROBES = ("load-only", "no-update", "no-solve", "no-values", "visc-no-faces", "visc-no-cells",
          "cart-no-faces", "cart-no-update", "cart-no-values", "cart-load-only")

BUILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
from artemis_tpu_torch import _build
from artemis_tpu_torch.ops import stage_curv as SC
if sys.argv[2] == "cart":
    name = "stage_cart"
    _build.load(name)
    entries = (("K1 f32 plm", "stage_cart_tiled_kernelIfLi1ELb1EE"),)
elif sys.argv[2] == "partial":
    name = _build.variant("stage_curv", SC.build_defines(torch.float64, False))
    _build.load("stage_curv", SC.build_defines(torch.float64, False))
    entries = (("partial diffusive", "stage_tiled_kernelIdLb1ELb0EE"),
               ("partial inviscid", "stage_tiled_kernelIdLb0ELb0EE"),
               ("per-cell partial", "stage_curv_kernelIdLb0ELb0EE"))
elif sys.argv[2] == "fld":
    name = "fld"
    _build.load(name)
    entries = (("K7 tiled", "coeffs_tiled_kernelIfEE"), ("K7 per-cell", "fld_kernelIfLb1EE"),
               ("K8", "fld_kernelIfLb0EE"))
else:
    name = _build.variant("stage_curv", SC.build_defines(torch.float32))
    _build.load("stage_curv", SC.build_defines(torch.float32))
    entries = (("inviscid", "stage_tiled_kernelIfLb0ELb1EE"), ("diffusive", "stage_tiled_kernelIfLb1ELb1EE"))
log = _build.build_log.get(name)
lines = (log[1] if log else "").splitlines()
out = []
for body, entry in entries:
    at = [i for i, l in enumerate(lines) if "Compiling entry" in l and entry in l]
    out.append(body + ": " + (", ".join(l.split(":", 1)[-1].strip() for l in lines[at[0]:at[0] + 4]
                                         if "registers" in l or "spill" in l) if at else "not read"))
print("; ".join(out) + f"; nvcc {log[0]:.1f} s" if log else "; ".join(out))
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


if name.startswith("fld"):
    # K7 and K8 at the RHD cell's shape
    from artemis_tpu_torch.ops import fld as FLD

    rng = np.random.default_rng(1)
    shape = (64, 512, 512)
    E, chi, sf = (torch.as_tensor(a, dtype=dt_, device=dev) for a in (
        0.5 + rng.random(shape), 3.0 * (1.0 + rng.random(shape)), rng.random(shape)))
    args = (E, chi, torch.full((1,), 1e-3, dtype=dt_, device=dev), (1 / 64, 1 / 64, 1 / 64),
            10.0, 2.0, ((True, True),) * 3)
    t = ms(lambda: FLD.fld_coeffs(*args))
    kt = FLD.fld_coeffs(*args)
    with FLD._percell_body():
        pc = ms(lambda: FLD.fld_coeffs(*args), 10)
        kp = FLD.fld_coeffs(*args)
    mv = ms(lambda: FLD.fld_matvec(E, kt[0], kt[1], sf))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(kt, kp))
    print(f"{name}: {t:.4f} ms per launch, bitwise equal to the per-cell body: {same}; the "
          f"per-cell body {pc:.4f} ms; fld_matvec {mv:.4f} ms", flush=True)
    sys.exit(0)


if name.startswith("partial"):
    # K4's partial mode on a deck's initial state (float64)
    import tempfile

    from artemis_tpu_torch import Simulation, bc as bc_mod

    sim = Simulation(deck, ["parthenon/time/nlim=0"], tempfile.mkdtemp(), device=dev)
    cs, u, w = sim.driver._curv, sim.state["gas"]["u"], sim.state["gas"]["w"]
    assert not cs.full and cs.tiled("padded") and u.dtype == torch.float64
    w_pad = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)
    u1 = u.clone()
    dt = torch.full((1,), 1e-5, dtype=u.dtype, device=dev)
    calls = itertools.cycle([(0.0, 1.0, 1.0), (0.5, 0.5, 0.5)])

    def launch(*g):
        return SC._launch(cs, w_pad, w, u, u1, *g, dt, 0.0, False, "padded")

    t = ms(lambda: launch(*next(calls)))
    x = launch(0.5, 0.5, 0.5)[0]
    with SC._percell_body():
        y = launch(0.5, 0.5, 0.5)[0]
        pc = (ms(lambda: launch(*next(calls)))
              if name in ("partial", "partial-coll", "partial-nbody") else None)
    torch.cuda.synchronize()
    line = (f"{name} ({tuple(cs.grid.nx)}, diffusive {cs.diffusive}): {t:.4f} ms per launch, "
            f"bitwise equal to the per-cell body: {torch.equal(x, y)}")
    print(line + (f"; the per-cell body {pc:.4f} ms" if pc is not None else ""), flush=True)
    sys.exit(0)


def disk_stage():
    # disk_sph at bench.py's shape: its gather stage and initial state
    import tempfile

    from artemis_tpu_torch import Simulation

    sim = Simulation(deck, ["parthenon/mesh/nx1=256", "parthenon/mesh/nx2=64",
                            "parthenon/mesh/nx3=64", "artemis/precision=float32"],
                     tempfile.mkdtemp(), device=dev)
    return sim.driver._curv, sim.state["gas"]["u"], sim.state["gas"]["w"]


def prims(shape):
    a = np.empty((6,) + shape, dtype=np.float32)
    a[0] = 1 + 0.2 * rng.random(shape)
    a[1:4] = 0.3 * (rng.random((3,) + shape) - 0.5)
    a[5] = 1 + 0.2 * rng.random(shape)
    a[4] = 0.4 * a[0] * a[5]
    return a


rng = np.random.default_rng(1)
calls = itertools.cycle([(0.0, 1.0, 1.0), (0.5, 0.5, 0.5)])
dt = torch.full((1,), 1e-4, dtype=dt_, device=dev)
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
cfg = FluidCfg(fluid="gas", recon="plm", rsolver="hllc", gamma=1.4, cfl=0.3)
switch = SC._percell_body
if name.startswith("cart"):
    # the Cartesian flagship's periodic box (K1)
    from artemis_tpu_torch.ops import stage as S

    pin = ParameterInput.from_file(deck)
    pin.apply_overrides(["parthenon/mesh/nx1=256", "parthenon/mesh/nx2=256",
                         "parthenon/mesh/nx3=128", "parthenon/mesh/nghost=2"])
    grid = grid_from_input(pin)
    hyd = Hydro(grid, cfg, device=dev, dtype=dt_)
    nx, ny, nz = grid.nx
    u, w = hyd.prim_to_cons(torch.as_tensor(prims((nz, ny, nx))[None], device=dev), cfg)
    u1 = u.clone()
    switch = S._percell_body

    def launch(*g):
        return S.stage(hyd, w, u, u1, *g, dt.reshape(()), False)
else:
    grid = grid_from_input(pin)
    hyd = Hydro(grid, cfg, device=dev, dtype=dt_)
    if name.startswith("visc") or name == "padded":
        cs, u, w = disk_stage()
        assert cs.diffusive and cs.halo == "gather"
    else:
        nx, ny, nz = grid.nx
        u, w = hyd.prim_to_cons(torch.as_tensor(prims((nz, ny, nx))[None], device=dev), cfg)
        strips = {k: prims(s[1:]) for k, s in zip(SC.STRIP_KEYS, SC.strip_shapes(grid))}
        grav = Gravity(pin, grid, Constants.from_units(Units.from_input(pin))).place(dev, dt_)
        cs = SC.CurvStage(hyd, gravity=grav, gmode=curv_point_grav(grid, grav), strips=strips)
    u1 = u.clone()

    def launch(*g):
        return SC.stage_curv(cs, w, u, u1, *g, dt, 0.0, False)

    if name == "padded":
        from artemis_tpu_torch import bc as bc_mod

        w_pad = bc_mod.pad_and_fill(w, cs.grid, "gas", cs.bc_custom)

        def launch(*g):
            return SC._launch(cs, w_pad, w, u, u1, *g, dt, 0.0, False, "padded")


def stage():
    return launch(*next(calls))


t = ms(stage)
line = f"{name}: {t:.4f} ms per launch"
if not probe:
    x = launch(0.5, 0.5, 0.5)
    with switch():
        y = launch(0.5, 0.5, 0.5)
        pc = ms(stage, 10) if name in ("tiled", "visc", "padded", "cart", "cart-fmad") else None
    torch.cuda.synchronize()
    same = (torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
            and torch.equal(x[2].amax(), y[2].amax()))
    line += f", bitwise equal to the per-cell body: {same}"
    if pc is not None:
        line += f"; the per-cell body {pc:.4f} ms"
print(line, flush=True)
"""


BUILD_SPLIT = r"""
import concurrent.futures, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from artemis_tpu_torch import _build
from artemis_tpu_torch.ops import stage_curv as SC
split = sys.argv[2] == "1"
defs = [SC.build_defines(dt, full) if split else SC.build_defines(dt)[:1]
        for dt in (torch.float32, torch.float64) for full in ((True, False) if split else (True,))]
t0 = time.perf_counter()
with concurrent.futures.ThreadPoolExecutor(len(defs)) as pool:
    for f in [pool.submit(_build.load, "stage_curv", d) for d in defs]:
        f.result()
each = "; ".join(f"{' '.join(d)}: {_build.build_log[_build.variant('stage_curv', d)][0]:.1f} s"
                 for d in defs)
print(f"{len(defs)} stage_curv nvcc runs in parallel, {time.perf_counter() - t0:.1f} s ({each})")
"""


def build_split(smi):
    """The stage_curv build in both partitions, each from a fresh copy."""
    with tempfile.TemporaryDirectory() as base:
        for split in ("0", "1"):
            d = variant_tree(base, f"split{split}", [])
            r = subprocess.run([sys.executable, "-c", BUILD_SPLIT, d, split],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise SystemExit(f"the build failed:\n{r.stderr[-3000:]}")
            print(r.stdout.strip() + f" [{smi}]", flush=True)


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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    if names == ["--build-split"]:
        return build_split(smi)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as base:
        dirs = {n: variant_tree(base, n, VARIANTS[n]) for n in names}
        builds = {n: subprocess.Popen([sys.executable, "-c", BUILD, d, n.split("-")[0]],
                                      stdout=subprocess.PIPE,
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
                deck = ("linwave.in" if n.startswith("cart") else PARTIAL_DECKS.get(
                    n, "alpha_disk.in") if n.startswith("partial") else "disk_sph.in")
                r = subprocess.run([sys.executable, timer, d, n, "1" if n in PROBES else "0",
                                    os.path.join(ROOT, "inputs", deck)],
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    raise SystemExit(f"variant {n} failed:\n{r.stderr[-3000:]}")
                print(r.stdout.strip() + f" [{smi}]", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
