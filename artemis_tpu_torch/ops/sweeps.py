"""The fused PLM/PCM + HLLC flux sweep of one direction: the CUDA kernel's
wrapper and its plain PyTorch version (port of
``artemis_tpu/ops/pallas_sweeps.py``).

A sweep turns ghost-padded gas primitives into the HLLC fluxes on the
interior faces of one direction in one pass, without materialising the
reconstructed face states: the six flux rows, the face pressure and the
upwinded face velocity, exactly what ``Hydro.compute_fluxes`` returns for
that direction.  It runs on the composable Cartesian path, wherever neither
fused stage applies: the shearing box (whose rotating frame consumes the
stage fluxes) and the gas of a gas+dust run.

``sweep`` dispatches on the tensor's device: on the CPU it runs
``sweep_reference``; on a CUDA device it launches ``csrc/sweep.cu`` (which
replaces the TPU kernel ``sweep`` -> ``_sweep_kernel``) or raises.  The TPU
wrapper's nx2 % 8 rule and its exclusion of the z sweep were VMEM tiling
limits; the kernel takes every direction and any shape.
"""

from __future__ import annotations

import ctypes

import torch

from ..profiling import kernel_span

BLOCK = 256  # threads per CUDA block, one interior face each
TINY = 1.0e-20
_METHODS = {"pcm": 0, "plm": 1}

# kernel launches since the last reset (the count a run reads to show that
# the main path went through the kernel)
sweep_launches = 0


def sweep_supported(grid, cfg, dtype, force_pcm: bool = False) -> bool:
    """Is the fluid's flux sweep inside the kernel's envelope?  Cartesian
    gas, one species, HLLC, PLM or PCM (after ``force_pcm``), float32 or
    float64, two ghost cells or more."""
    if cfg is None:
        return False
    method = "pcm" if force_pcm else cfg.recon
    return (grid.coords == "cartesian" and cfg.fluid == "gas"
            and cfg.nspecies == 1 and cfg.rsolver == "hllc" and method in _METHODS
            and dtype in (torch.float32, torch.float64) and grid.nghost >= 2)


def _interior_faces(w, d, grid):
    """The padded prims [6, zp, yp, xp] cut to the interior across d, the
    full ghosted extent along d."""
    g1, g2, g3 = grid.ng
    nx, ny, nz = grid.nx
    sl = [slice(None), slice(g3, g3 + nz), slice(g2, g2 + ny), slice(g1, g1 + nx)]
    sl[4 - d] = slice(None)
    return w[tuple(sl)]


def _plm(qm, q0, qp):
    """_plm (pallas_sweeps.py:26): the cell's (upper, lower) face values."""
    dql = q0 - qm
    dqr = qp - q0
    dq2 = dql * dqr
    pos = dq2 > 0.0
    dqm = torch.where(pos, dq2 / torch.where(pos, dql + dqr, 1.0), 0.0)
    return q0 + dqm, q0 - dqm


def _hllc(wl, wr, d, gamma):
    """_hllc (pallas_sweeps.py:34-97) on L/R state tuples, in its operation
    order: one rsqrt per side for the sound speeds and the face velocity,
    and the shared reciprocals imlr, iamb, ibpa."""
    ivx, ivy, ivz = d, (d % 3) + 1, ((d + 1) % 3) + 1
    dl, dr = wl[0], wr[0]
    vxl, vxr = wl[ivx], wr[ivx]
    vyl, vyr = wl[ivy], wr[ivy]
    vzl, vzr = wl[ivz], wr[ivz]
    pl, pr = wl[4], wr[4]
    sel, ser = wl[5], wr[5]

    igm1 = 1.0 / (gamma - 1.0)
    alpha = (gamma + 1.0) / (2.0 * gamma)
    isq_l = torch.rsqrt(dl)
    isq_r = torch.rsqrt(dr)
    al = torch.sqrt(gamma * pl) * isq_l
    ar = torch.sqrt(gamma * pr) * isq_r
    el = pl * igm1 + 0.5 * dl * (vxl * vxl + vyl * vyl + vzl * vzl)
    er = pr * igm1 + 0.5 * dr * (vxr * vxr + vyr * vyr + vzr * vzr)
    cbar = 0.25 * (dl + dr) * (al + ar)
    pmid = 0.5 * (pl + pr + (vxl - vxr) * cbar)
    ql = torch.where(pmid <= pl, 1.0, torch.sqrt(1.0 + alpha * (pmid / pl - 1.0)))
    qr = torch.where(pmid <= pr, 1.0, torch.sqrt(1.0 + alpha * (pmid / pr - 1.0)))
    sl = vxl - al * ql
    sr = vxr + ar * qr
    bp = torch.where(sr > 0.0, sr, TINY)
    bm = torch.where(sl < 0.0, sl, -TINY)
    tl = pl + (vxl - sl) * dl * vxl
    tr = pr + (vxr - sr) * dr * vxr
    ml = dl * (vxl - sl)
    mr = -(dr * (vxr - sr))
    imlr = 1.0 / (ml + mr)
    am = (tl - tr) * imlr
    cp = torch.clamp_min((ml * tr + mr * tl) * imlr, 0.0)
    qe = dl * (vxl - bm)
    qf = dr * (vxr - bp)
    fle = el * (vxl - bm) + pl * vxl
    fre = er * (vxr - bp) + pr * vxr
    pos = am >= 0.0
    iamb = 1.0 / (am - bm)
    ibpa = 1.0 / (bp - am)
    wc_l = torch.where(pos, am * iamb, 0.0)
    wc_r = torch.where(pos, 0.0, -am * ibpa)
    wc_c = torch.where(pos, -bm * iamb, bp * ibpa)
    pface = wc_l * pl + wc_r * pr + wc_c * cp
    frho = wc_l * qe + wc_r * qf
    out = [None] * 6
    out[0] = frho
    out[ivx] = wc_l * qe * vxl + wc_r * qf * vxr
    out[ivy] = wc_l * qe * vyl + wc_r * qf * vyr
    out[ivz] = wc_l * qe * vzl + wc_r * qf * vzr
    out[4] = wc_l * fle + wc_r * fre + wc_c * cp * am
    upw = frho >= 0.0
    out[5] = frho * torch.where(upw, sel, ser)
    vface = frho * torch.where(upw, isq_l * isq_l, isq_r * isq_r)
    return torch.stack(out), pface, vface


def sweep_reference(w_pad, d, grid, gamma, recon="plm"):
    """The plain version: (F [1, 6, ...], pface [1, ...], vface [1, ...]) on
    the interior faces of direction d from padded prims w_pad
    [1, 6, zp, yp, xp], in the TPU kernel's operation order.  Face f sits
    between cells f-1 and f; wl comes from the cell below."""
    w = _interior_faces(w_pad[0], d, grid)
    ax = 4 - d
    n = grid.nx[d - 1]
    g = grid.ng[d - 1]

    def cells(lo):
        """The n + 1 cells starting at ghosted index lo along d."""
        return w.narrow(ax, lo, n + 1)

    if recon == "pcm":
        wl, wr = cells(g - 1), cells(g)
    elif recon == "plm":
        wl, _ = _plm(cells(g - 2), cells(g - 1), cells(g))
        _, wr = _plm(cells(g - 1), cells(g), cells(g + 1))
    else:
        raise ValueError(f"the sweep takes pcm or plm, not {recon!r}")
    F, pF, vF = _hllc(wl, wr, d, gamma)
    return F[None], pF[None], vF[None]


def sweep(w_pad, d, grid, gamma, recon="plm"):
    """One direction's fluxes: on the CPU the plain version, on a CUDA
    device the kernel (or an exception; there is no fallback)."""
    if w_pad.device.type == "cpu":
        with kernel_span("sweep", "plain", w_pad.device):
            return sweep_reference(w_pad, d, grid, gamma, recon)
    if w_pad.device.type != "cuda":
        raise RuntimeError(f"no sweep kernel for device {w_pad.device}")
    return _launch(w_pad, d, grid, gamma, recon)


def _lib():
    from .. import _build

    fn = _build.load("sweep").artemis_sweep
    if fn.argtypes is None:
        p, i, dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.restype = i
        fn.argtypes = [i, i, i] + [p] * 4 + [i] * 6 + [dbl, i, p]
    return fn


def face_shape(grid, d):
    """(nz, ny, nx) of the interior faces of direction d."""
    n = list(reversed(grid.nx))
    n[3 - d] += 1
    return tuple(n)


def _launch(w_pad, d, grid, gamma, recon):
    global sweep_launches
    nx, ny, nz = grid.nx
    g1, g2, g3 = grid.ng
    if d not in (1, 2, 3) or not grid.active(d):
        raise ValueError(f"no sweep along inactive direction {d}")
    if recon not in _METHODS:
        raise ValueError(f"the sweep kernel takes pcm or plm, not {recon!r}")
    if grid.nghost < 2:
        raise ValueError("the sweep kernel needs two ghost cells or more")
    dtype = w_pad.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sweep kernel takes float32 or float64, not {dtype}")
    shape = (1, 6, nz + 2 * g3, ny + 2 * g2, nx + 2 * g1)
    if tuple(w_pad.shape) != shape or not w_pad.is_contiguous():
        raise ValueError(f"padded prims of shape {tuple(w_pad.shape)}, expected a "
                         f"contiguous {shape}")
    fshape = face_shape(grid, d)
    F = torch.empty((1, 6) + fshape, dtype=dtype, device=w_pad.device)
    pF = torch.empty((1,) + fshape, dtype=dtype, device=w_pad.device)
    vF = torch.empty((1,) + fshape, dtype=dtype, device=w_pad.device)
    fn = _lib()
    with torch.cuda.device(w_pad.device), kernel_span("sweep", "per-cell", w_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(0 if dtype == torch.float32 else 1, d, _METHODS[recon], w_pad.data_ptr(),
                 F.data_ptr(), pF.data_ptr(), vF.data_ptr(), nx, ny, nz, g1, g2, g3,
                 float(gamma), BLOCK, stream)
    if err != 0:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
    sweep_launches += 1
    return F, pF, vF
