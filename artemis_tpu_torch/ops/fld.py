"""The FLD radiation operator: the CUDA kernels' wrappers and their plain
PyTorch versions (port of ``artemis_tpu/ops/pallas_fld.py``).

``fld_coeffs`` sets up the implicit operator ``I - dt div D grad`` of one
radiation step: the Levermore-Pomraning limiter, the capped diffusivity,
the masked face coefficients and the Jacobi diagonal.  ``fld_matvec``
applies it once per conjugate-gradient iteration.  Both take one node's
``[nz, ny, nx]`` fields or N same-shape nodes stacked on a leading axis
(``[N, nz, ny, nx]``, the coefficients ``A`` as ``[N, 6, nz, ny, nx]``):
the node axis of a tree level's batched radiation solve, one launch for
every node, each node's neighbours wrapped inside its own box (what the
JAX tree's ``vmap`` of the plain operator gives).  Both dispatch on the
tensor's device: a CPU tensor runs the plain version, a CUDA tensor
launches ``csrc/fld.cu`` (which replaces the TPU kernels K7 ``fld_coeffs``
and K8 ``fld_matvec``) or raises.  The JAX package keeps its kernels behind
an opt-in switch; here the kernel is the card's path.  Every
``fld_coeffs`` launch, at any extent, takes the kernel's tiled body (each
diffusivity made once per cell in shared memory); its per-cell body is
reached only through the private switch ``_percell_body``.

Neighbours wrap (``torch.roll``, the reference's ``jnp.roll``); physical
edges are masked through the coefficients only, so the limiter's gradient
at an edge cell reads the opposite edge, as the reference's does.  Gate
(``radiation.Radiation``): a 3-D grid of uniform Cartesian widths.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..profiling import kernel_span

# kernel launches since the last reset (the counts a run reads to show
# that the main path went through the kernels), of the fld_coeffs
# launches those of the tiled body, and of each kernel's launches those
# over a node axis (one launch however many nodes)
fld_coeffs_launches = 0
fld_coeffs_tiled_launches = 0
fld_matvec_launches = 0
fld_coeffs_node_launches = 0
fld_matvec_node_launches = 0

# Measurement only: while on, fld_coeffs launches take the per-cell body,
# so that chip_smoke.py and the tests can time and compare the two bodies
# on one state.  Nothing in Simulation, the deck or the CLI reaches it.
_percell = False


@contextlib.contextmanager
def _percell_body():
    global _percell
    before, _percell = _percell, True
    try:
        yield
    finally:
        _percell = before


def shift(a, d, sign):
    """a at the neighbour +sign along direction d (the last axis is x),
    wrapped: jnp.roll(a, -sign, axis=-d)."""
    return torch.roll(a, -sign, dims=a.ndim - d)


def grad_norm(gs):
    """sqrt(g_1^2 + g_2^2 + ...) of the gradient components ``gs``, summed
    in their order, with an IEEE square root.  ``torch.sqrt`` (and
    ``pow(x, 0.5)``) of a float64 CPU tensor goes through MKL's vector math
    library, one chunk per thread: it is not correctly rounded (one-ulp
    differences from the IEEE root), and its first call on a worker thread
    was seen to return one chunk off by ~2e-11 relative.  The reduction of
    ``vector_norm`` takes the root without that library."""
    return torch.linalg.vector_norm(torch.stack(gs), dim=0)


def edge_masks(a, d):
    """(first, last) boolean masks of the physical edges along d,
    broadcastable against a."""
    ax = a.ndim - d
    n = a.shape[ax]
    idx = torch.arange(n, device=a.device).reshape([n if i == ax else 1
                                                    for i in range(a.ndim)])
    return idx == 0, idx == n - 1


def fld_coeffs_reference(E, chi, dt, dxs, c_code, ext, flags):
    """The plain version: ``(A, diag_geo, Dcell)`` for E, chi [nz, ny, nx]
    (or [N, nz, ny, nx]: every stencil counts its dims from the end, so
    each node wraps inside its own box), a one-element ``dt`` tensor,
    uniform widths ``dxs`` = (dx, dy, dz), the cap extent ``ext`` and
    ``flags[d] = (lo_dirichlet, hi_dirichlet)``.
    A rows: [AL1, AH1, AL2, AH2, AL3, AH3] with dt / w^2 folded in, on the
    axis before the grid's.  The operations follow the TPU kernel's
    order."""
    tiny = torch.finfo(E.dtype).tiny
    dt = dt.reshape(())
    gs = [(shift(E, d, 1) - shift(E, d, -1)) * (0.5 / dxs[d - 1]) for d in (1, 2, 3)]
    R = grad_norm(gs) / (chi * torch.clamp_min(E, tiny) + tiny)
    lam = (2.0 + R) / (6.0 + 3.0 * R + R * R)        # Levermore-Pomraning
    Dc = torch.clamp_max(c_code * lam / (chi + tiny), c_code * ext)
    diag = torch.ones_like(Dc)
    rows = []
    for d in (1, 2, 3):
        first, last = edge_masks(Dc, d)
        D_hi = 0.5 * (Dc + shift(Dc, d, 1))
        D_lo = 0.5 * (Dc + shift(Dc, d, -1))
        lo_dir, hi_dir = flags[d - 1]
        if hi_dir:
            D_hi = torch.where(last, Dc, D_hi)
            A_hi = torch.where(last, 0.0, D_hi)
        else:
            D_hi = torch.where(last, 0.0, D_hi)
            A_hi = D_hi
        if lo_dir:
            D_lo = torch.where(first, Dc, D_lo)
            A_lo = torch.where(first, 0.0, D_lo)
        else:
            D_lo = torch.where(first, 0.0, D_lo)
            A_lo = D_lo
        iw2 = (1.0 / dxs[d - 1]) * (1.0 / dxs[d - 1])
        diag = diag + dt * ((D_hi + D_lo) * iw2)
        rows += [(dt * iw2) * A_lo, (dt * iw2) * A_hi]
    return torch.stack(rows, dim=-4), diag, Dc


def fld_matvec_reference(E, A, diag_geo, sf):
    """The plain version: (diag_geo + sf) E - sum_d (AH_d E_+d + AL_d E_-d)
    on [nz, ny, nx] (or [N, nz, ny, nx]) arrays, A as fld_coeffs returns
    it."""
    out = (diag_geo + sf) * E
    for d in (1, 2, 3):
        out = (out - A.select(-4, 2 * d - 1) * shift(E, d, 1)
               - A.select(-4, 2 * d - 2) * shift(E, d, -1))
    return out


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _lib():
    from .. import _build

    lib = _build.load("fld")
    if lib.artemis_fld_coeffs.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # coeffs: (dtype, tiled, ints, reals, 6 tensors, stream); matvec:
        # (dtype, ints, reals, 5 tensors, stream)
        lib.artemis_fld_coeffs.argtypes = [i, i, p, p] + [p] * 6 + [p]
        lib.artemis_fld_matvec.argtypes = [i, p, p] + [p] * 5 + [p]
        lib.artemis_fld_coeffs.restype = lib.artemis_fld_matvec.restype = i
    return lib


def _check(ts, shapes, dtype, device):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the FLD kernels take float32 or float64, not {dtype}")
    for t, shape in zip(ts, shapes):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"FLD kernel input of shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError("FLD kernel inputs must be contiguous tensors of one dtype "
                             "on one device")


def _args(shape, dxs=(1.0, 1.0, 1.0), c_code=0.0, ext=0.0, flags=((0, 0),) * 3, tiny=0.0):
    """The kernel's FldInts / FldReals arrays, led by their counts, for
    fields of ``shape`` ([nz, ny, nx] or [N, nz, ny, nx])."""
    nn = shape[0] if len(shape) == 4 else 1
    nz, ny, nx = shape[-3:]
    ints = ([nx, ny, nz] + [int(bool(f[0])) for f in flags]
            + [int(bool(f[1])) for f in flags] + [nn])
    reals = ([0.5 / w for w in dxs] + [(1.0 / w) * (1.0 / w) for w in dxs]
             + [c_code * ext, c_code, tiny])
    ints = [len(ints) + 1] + ints
    reals = [float(len(reals) + 1)] + reals
    return (ctypes.c_int * len(ints))(*ints), (ctypes.c_double * len(reals))(*reals)


def _run(fn, label, body, dtype, device, *args):
    with torch.cuda.device(device), kernel_span(label, body, device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(0 if dtype == torch.float32 else 1, *args, stream)
    if err != 0:
        raise RuntimeError(f"FLD kernel launch failed: CUDA error {err}")


def fld_coeffs(E, chi, dt, dxs, c_code, ext, flags):
    """``fld_coeffs_reference``'s function: on the CPU the plain version, on
    a CUDA device the kernel (``dt`` stays on the device: no host read)."""
    if E.device.type == "cpu":
        with kernel_span("fld_coeffs", "plain", E.device):
            return fld_coeffs_reference(E, chi, dt, dxs, c_code, ext, flags)
    if E.device.type != "cuda":
        raise RuntimeError(f"no FLD kernel for device {E.device}")
    return _launch_coeffs(E, chi, dt, dxs, c_code, ext, flags)


def fld_matvec(E, A, diag_geo, sf):
    """``fld_matvec_reference``'s function: on the CPU the plain version, on
    a CUDA device the kernel."""
    if E.device.type == "cpu":
        with kernel_span("fld_matvec", "plain", E.device):
            return fld_matvec_reference(E, A, diag_geo, sf)
    if E.device.type != "cuda":
        raise RuntimeError(f"no FLD kernel for device {E.device}")
    return _launch_matvec(E, A, diag_geo, sf)


def _a_shape(shape):
    """The coefficients' shape for fields of ``shape``: six rows per node."""
    return tuple(shape[:-3]) + (6,) + tuple(shape[-3:])


def _node_axis(shape, name):
    """Whether fields of ``shape`` carry a node axis, and the kernel table
    row's suffix; raises for a shape the kernels do not take."""
    if len(shape) == 3:
        return False, ""
    if len(shape) == 4 and 1 <= shape[0] <= 65535:
        return True, ", node axis"
    raise ValueError(f"{name} takes [nz, ny, nx] or [N, nz, ny, nx] fields (N <= 65535), "
                     f"not {tuple(shape)}")


def _launch_coeffs(E, chi, dt, dxs, c_code, ext, flags):
    global fld_coeffs_launches, fld_coeffs_tiled_launches, fld_coeffs_node_launches
    shape = tuple(E.shape)
    nodes, suffix = _node_axis(shape, "fld_coeffs")
    if dt.numel() != 1:
        raise ValueError("fld_coeffs takes a one-element dt")
    _check((E, chi, dt), (shape, shape, tuple(dt.shape)), E.dtype, E.device)
    A = torch.empty(_a_shape(shape), dtype=E.dtype, device=E.device)
    diag = torch.empty_like(E)
    Dc = torch.empty_like(E)
    ints, reals = _args(shape, tuple(float(w) for w in dxs), float(c_code), float(ext),
                        flags, torch.finfo(E.dtype).tiny)
    tiled = not _percell
    _run(_lib().artemis_fld_coeffs, "fld_coeffs", ("tiled" if tiled else "per-cell") + suffix,
         E.dtype, E.device, int(tiled), ints, reals,
         E.data_ptr(), chi.data_ptr(), dt.data_ptr(), A.data_ptr(), diag.data_ptr(),
         Dc.data_ptr())
    fld_coeffs_launches += 1
    fld_coeffs_tiled_launches += int(tiled)
    fld_coeffs_node_launches += int(nodes)
    return A, diag, Dc


def _launch_matvec(E, A, diag_geo, sf):
    global fld_matvec_launches, fld_matvec_node_launches
    shape = tuple(E.shape)
    nodes, suffix = _node_axis(shape, "fld_matvec")
    _check((E, A, diag_geo, sf), (shape, _a_shape(shape), shape, shape), E.dtype, E.device)
    out = torch.empty_like(E)
    ints, reals = _args(shape)
    _run(_lib().artemis_fld_matvec, "fld_matvec", "per-cell" + suffix, E.dtype, E.device,
         ints, reals, E.data_ptr(),
         A.data_ptr(), diag_geo.data_ptr(), sf.data_ptr(), out.data_ptr())
    fld_matvec_launches += 1
    fld_matvec_node_launches += int(nodes)
    return out
