"""Fused Cartesian gas-hydro RK stage: the CUDA kernel's wrapper and its
plain PyTorch version (port of ``artemis_tpu/ops/pallas_stage.py``).

One stage is everything between two ghost fills: reconstruction and HLLC
fluxes in every active direction, the two-register RK update
(ApplyUpdate, artemis_integrator.hpp:56-110), the Cartesian pressure-
gradient and PdV flux sources (FluxSourceImpl, fluid_fluxes.hpp:295-420),
the dual-energy sync (SetAuxillaryFields), the C2P/P2C floor re-sync
(fill_derived.cpp), and the CFL denominator maximum (dtden).

``stage`` dispatches on the tensor's device: on the CPU it runs
``stage_reference``; on a CUDA device it launches ``csrc/stage_cart.cu``
(which replaces both TPU kernels, ``stage_periodic`` and ``stage``) or
raises.  Periodic boxes are read with in-kernel index wrap from the
unpadded interior; other boundaries from primitives padded by ``bc``.
Every launch takes the kernel's tiled body (a footprint of columns per
block marching up a chunk of planes, each face solved once), whose dtden
holds one maximum per block (``dtden_blocks``); the per-cell body is
reached only through the private switch ``_percell_body``, which
measurements and tests use.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .. import bc as bc_mod
from ..profiling import kernel_span

BLOCK = 256  # threads per block of the per-cell body; one dtden entry per block
_METHODS = {"pcm": 0, "plm": 1, "ppm": 2}
# the tiled body's footprint and planes per block (TileDims: TX, TY, TZ) by
# dtype; one dtden entry per block
TILE = {torch.float32: (32, 8, 16), torch.float64: (32, 4, 16)}

# kernel launches since the last reset (the count a run reads to show that
# the main path went through the kernel), and of those the launches of the
# tiled body and those from a padded array (K2; the rest wrap their halo,
# K1)
stage_launches = 0
tiled_launches = 0
padded_launches = 0

# Measurement only: while on, launches take the per-cell body, so that
# chip_smoke.py and the tests can time and compare the two designs on one
# state.  Nothing in Simulation, the deck or the CLI reaches it.
_percell = False


@contextlib.contextmanager
def _percell_body():
    global _percell
    before, _percell = _percell, True
    try:
        yield
    finally:
        _percell = before


def dtden_blocks(nx, ny, nz, dtype, tiled=True) -> int:
    """Entries of the kernel's dtden output: one per block of the tiled
    body, or of the per-cell body when not ``tiled``."""
    if not tiled:
        return -(-(nx * ny * nz) // BLOCK)
    tx, ty, tz = TILE[dtype]
    return -(-nx // tx) * -(-ny // ty) * -(-nz // tz)


def supported(grid, cfg) -> bool:
    """Is the config inside the fused kernel's envelope?  (The TPU's
    ny%16, nz%4, nx%128 and nghost==2 rules were Mosaic alignment rules;
    this kernel masks ragged edges instead.)"""
    if cfg is None:
        return False
    min_ghost = 3 if cfg.recon == "ppm" else 2
    return (grid.coords == "cartesian" and cfg.fluid == "gas"
            and cfg.nspecies == 1 and cfg.rsolver == "hllc"
            and cfg.recon in _METHODS and grid.nghost >= min_ghost
            and grid.nx[0] > 1 and grid.nx[1] > 1)


def all_periodic(grid, bc_custom=None) -> bool:
    """Every active axis periodic and no custom fills: the kernel wraps
    its halo by index and no padded array is made."""
    return not bc_custom and all(grid.bc[d - 1] == ("periodic", "periodic")
                                 for d in (1, 2, 3) if grid.active(d))


def stage_reference(hyd, w, u0, u1, gam0, gam1, beta, dt, force_pcm, bc_custom=None,
                    w_pad=None):
    """The plain version: the composable stage sequence
    pad_and_fill (or the given padded prims ``w_pad``) -> compute_fluxes ->
    apply_update -> flux_source -> set_auxiliary -> cons_to_prim ->
    prim_to_cons, plus the CFL denominator maximum.  Returns (u, w, dtden)
    with dtden of shape (1,)."""
    cfg = hyd.gas
    bdt = beta * dt
    if w_pad is None:
        w_pad = bc_mod.pad_and_fill(w, hyd.grid, "gas", bc_custom)
    fx = hyd.compute_fluxes(w_pad, cfg, force_pcm)
    u = hyd.apply_update(u0, u1, fx, gam0, gam1, bdt)
    u = hyd.flux_source(u, w, fx, bdt)
    u = hyd.set_auxiliary(u, cfg)
    u, w = hyd.prim_to_cons(hyd.cons_to_prim(u, cfg), cfg)
    return u, w, torch.amax(hyd.dt_denominator(w, cfg)).reshape(1)


def stage(hyd, w, u0, u1, gam0, gam1, beta, dt, force_pcm, bc_custom=None, w_pad=None):
    """One fused RK stage from interior prims ``w`` [1, 6, nz, ny, nx] and
    the two registers u0, u1; ``dt`` is a one-element tensor on w's device.
    The halo is wrapped in the kernel on an all-periodic box, else read from
    ``w_pad`` (a shard's exchanged fill) or from ``bc.pad_and_fill``'s
    array.  Returns (u, w, dtden); on the GPU dtden holds one maximum per
    block of the body that ran (``dtden_blocks``)."""
    periodic = w_pad is None and all_periodic(hyd.grid, bc_custom)
    if w.device.type == "cpu":
        with kernel_span("stage_periodic" if periodic else "stage", "plain", w.device):
            return stage_reference(hyd, w, u0, u1, gam0, gam1, beta, dt, force_pcm,
                                   bc_custom, w_pad)
    if w.device.type != "cuda":
        raise RuntimeError(f"no stage kernel for device {w.device}")
    if not supported(hyd.grid, hyd.gas):
        raise ValueError("config outside the fused stage kernel's envelope")
    if periodic:
        return _launch(hyd, w, u0, u1, gam0, gam1, beta, dt, force_pcm, periodic=True)
    if w_pad is None:
        w_pad = bc_mod.pad_and_fill(w, hyd.grid, "gas", bc_custom)
    return _launch(hyd, w_pad, u0, u1, gam0, gam1, beta, dt, force_pcm, periodic=False)


def _lib():
    from .. import _build

    lib = _build.load("stage_cart")
    fn = lib.artemis_stage_cart
    if fn.argtypes is None:
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.restype = i
        fn.argtypes = ([i] * 4 + [p] * 7 + [ctypes.c_int64] + [i] * 6 + [d] * 10 + [i, p])
    return fn


def _launch(hyd, src, u0, u1, gam0, gam1, beta, dt, force_pcm, periodic):
    global stage_launches, tiled_launches, padded_launches
    grid, cfg = hyd.grid, hyd.gas
    nx, ny, nz = grid.nx
    g1, g2, g3 = (0, 0, 0) if periodic else grid.ng
    shape = (1, 6, nz, ny, nx)
    src_shape = (1, 6, nz + 2 * g3, ny + 2 * g2, nx + 2 * g1)
    dtype = src.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stage kernel takes float32 or float64, not {dtype}")
    if tuple(src.shape) != src_shape:
        raise ValueError(f"prims of shape {tuple(src.shape)}, expected {src_shape}")
    live = [t for t, g in ((u0, gam0), (u1, gam1)) if g != 0.0]
    for t in live:
        if tuple(t.shape) != shape:
            raise ValueError(f"register of shape {tuple(t.shape)}, expected {shape}")
    for t in [src, dt] + live:
        if t.device != src.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError("stage kernel inputs must be contiguous tensors of "
                             "one dtype on one device")
    if dt.numel() != 1:
        raise ValueError("dt must be a one-element tensor")
    method = "pcm" if force_pcm else cfg.recon
    tiled = not _percell
    fn = _lib()
    u = torch.empty(shape, dtype=dtype, device=src.device)
    w = torch.empty(shape, dtype=dtype, device=src.device)
    dmax = torch.empty((dtden_blocks(nx, ny, nz, dtype, tiled),), dtype=dtype,
                       device=src.device)
    g = grid.geom
    dx = float(g.xf1[1] - g.xf1[0])
    dy = float(g.xf2[1] - g.xf2[0])
    dz = float(g.xf3[1] - g.xf3[0])
    with torch.cuda.device(src.device), kernel_span(
            "stage_periodic" if periodic else "stage", "tiled" if tiled else "per-cell",
            src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(0 if dtype == torch.float32 else 1, _METHODS[method],
                 int(periodic), int(tiled), src.data_ptr(),
                 u0.data_ptr() if gam0 != 0.0 else None,
                 u1.data_ptr() if gam1 != 0.0 else None,
                 dt.data_ptr(), u.data_ptr(), w.data_ptr(), dmax.data_ptr(), dmax.numel(),
                 nx, ny, nz, g1, g2, g3, float(gam0), float(gam1), float(beta),
                 1.0 / dx, 1.0 / dy, 1.0 / dz, cfg.gamma, cfg.dfloor,
                 cfg.siefloor, cfg.de_switch, BLOCK, stream)
    if err != 0:
        raise RuntimeError(f"stage_cart kernel launch failed: CUDA error {err}")
    stage_launches += 1
    tiled_launches += int(tiled)
    padded_launches += int(not periodic)
    return u, w, dmax
