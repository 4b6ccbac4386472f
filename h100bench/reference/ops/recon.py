"""Reconstruction methods (PCM / PLM / PPM), vectorized over whole arrays
(port of ``artemis_tpu/ops/recon.py``).

Each method maps the full ghost-padded array to left/right face states
along one axis in one elementwise pass over shifted views (the reference
sweeps per-(k,j) pencil through scratch pads,
``src/utils/fluxes/reconstruction/*.hpp``).

Face convention: along the chosen axis a face ``f`` (0..n) sits between
cells ``f-1`` and ``f``; ``wl[f]`` is reconstructed from cell ``f-1``,
``wr[f]`` from cell ``f``.  Edge faces outside the stencil reach of valid
data land in ghost regions and are never consumed.
"""

from __future__ import annotations

import numpy as np
import torch


def _ax(d: int) -> int:
    """Coordinate direction (1..3) -> array axis (x1 fastest)."""
    return -d


def _sh(a, s: int, d: int):
    """Shifted view a[i+s] along direction d, same length (edge-clamped).

    Interior cells always have their true neighbors; only ghost-edge cells
    see clamped values (never consumed).
    """
    ax = _ax(d) % a.ndim
    n = a.shape[ax]
    idx = torch.clamp(torch.arange(n, device=a.device) + s, 0, n - 1)
    return a.index_select(ax, idx)


def _cells_to_faces(ql, qr, d: int):
    """Map per-cell face values to per-face L/R states (n cells -> n+1 faces)."""
    ax = _ax(d) % ql.ndim
    n = ql.shape[ax]
    wl = torch.cat([ql.narrow(ax, 0, 1), ql], dim=ax)        # wl[f] = ql[f-1]
    wr = torch.cat([qr, qr.narrow(ax, n - 1, 1)], dim=ax)    # wr[f] = qr[f]
    return wl, wr


def pcm(W, d: int):
    """Piecewise-constant (donor cell)."""
    return _cells_to_faces(W, W, d)


def plm_uniform(W, d: int):
    """PLM with the uniform-Cartesian limiter (cf. ArtemisUtils::PLM,
    src/utils/fluxes/reconstruction/plm.hpp:31-47)."""
    dql = W - _sh(W, -1, d)
    dqr = _sh(W, +1, d) - W
    dq2 = dql * dqr
    pos = dq2 > 0.0
    denom = torch.where(pos, dql + dqr, 1.0)
    dqm = torch.where(pos, dq2 / denom, 0.0)
    return _cells_to_faces(W + dqm, W - dqm, d)


def plm_general(W, d: int, xv, xf_lo, xf_hi, dx):
    """PLM for non-uniform / curvilinear axes (Mignone 2013; cf. PLM_G,
    src/utils/fluxes/reconstruction/plm.hpp:53-73).

    xv / xf_lo / xf_hi / dx are broadcastable tensors over cells along d
    (volume-averaged centroids, lower/upper face coords, coordinate width).
    """
    xvm = _sh(xv, -1, d)
    xvp = _sh(xv, +1, d)
    dql = (W - _sh(W, -1, d)) * dx / (xv - xvm)
    dqr = (_sh(W, +1, d) - W) * dx / (xvp - xv)
    dq2 = dql * dqr
    cr = (xvp - xv) / (xf_hi - xv)
    cl = (xv - xvm) / (xv - xf_lo)
    pos = dq2 > 0.0
    denom = dql * dql + dqr * dqr + dq2 * (cl + cr - 2.0)
    denom = torch.where(pos, denom, 1.0)
    dqm = torch.where(pos, dq2 * (cr * dql + cl * dqr) / denom, 0.0)
    ql = W + dqm * (xf_hi - xv) / dx
    qr = W - dqm * (xv - xf_lo) / dx
    return _cells_to_faces(ql, qr, d)


def ppm4(W, d: int):
    """Original PPM (Colella & Woodward), Cartesian stencil (cf. PPM4,
    src/utils/fluxes/reconstruction/ppm.hpp:32-66)."""
    qm2 = _sh(W, -2, d)
    qm1 = _sh(W, -1, d)
    qp1 = _sh(W, +1, d)
    qp2 = _sh(W, +2, d)

    qlv = (7.0 * (W + qm1) - (qm2 + qp1)) / 12.0
    qrv = (7.0 * (W + qp1) - (qm1 + qp2)) / 12.0

    qlv = torch.clamp(qlv, min=torch.minimum(W, qm1), max=torch.maximum(W, qm1))
    qrv = torch.clamp(qrv, min=torch.minimum(W, qp1), max=torch.maximum(W, qp1))

    qc = qrv - W
    qd = qlv - W
    flat = (qc * qd) >= 0.0
    qrv = torch.where(flat, W, torch.where(qc.abs() >= 2.0 * qd.abs(), W - 2.0 * qd, qrv))
    qlv = torch.where(flat, W, torch.where(qd.abs() >= 2.0 * qc.abs(), W - 2.0 * qc, qlv))

    return _cells_to_faces(qrv, qlv, d)


def reconstruct(W, d: int, method: str, geom=None, rows=None):
    """Dispatch on the reconstruction method (the reference's
    runtime->template dispatch chain, src/utils/fluxes/fluid_fluxes.hpp:216-237).

    ``rows``: optional precomputed (xv, xf_lo, xf_hi, dx) coordinate rows
    for the PLM_G branch, as tensors of W's dtype and device."""
    if method == "pcm":
        return pcm(W, d)
    if method == "plm":
        if geom is None or not _axis_dep(geom.coords, d):
            # metric-independent axis on a uniformly spaced mesh: the
            # volume centroid is the arithmetic midpoint and the Mignone
            # limiter reduces algebraically to the uniform-spacing PLM
            # (plm.hpp:38 Cartesian branch)
            return plm_uniform(W, d)
        if rows is None:
            xv, xf, dx = _axis_coords(geom, d, W.ndim)
            rows = (xv, xf[0], xf[1], dx)
        xv, xlo, xhi, dx = (torch.as_tensor(r, dtype=W.dtype, device=W.device)
                            for r in rows)
        return plm_general(W, d, xv, xlo, xhi, dx)
    if method == "ppm":
        return ppm4(W, d)
    raise ValueError(f"unknown reconstruction {method!r}")


def _axis_dep(coords: str, d: int) -> bool:
    """Does the volume element depend on coordinate ``d``?  (Geometry
    traits x1dep/x2dep/x3dep — exactly the axes whose volume centroids
    are not arithmetic midpoints.)"""
    from ..geometry import geometry as geo

    return {1: geo.x1dep, 2: geo.x2dep, 3: geo.x3dep}[d](coords)


def _axis_coords(geom, d: int, ndim: int):
    """Per-axis centroid/face/width numpy arrays broadcast to rank ``ndim``."""
    xv = {1: geom.xv1, 2: geom.xv2, 3: geom.xv3}[d]
    xf = {1: geom.xf1, 2: geom.xf2, 3: geom.xf3}[d]
    dx = {1: geom.dx1, 2: geom.dx2, 3: geom.dx3}[d]
    shape = [1] * ndim
    shape[_ax(d) % ndim] = -1
    xv = np.reshape(xv, shape)
    dx = np.reshape(dx, shape)
    xf_lo = np.reshape(xf[:-1], shape)
    xf_hi = np.reshape(xf[1:], shape)
    return xv, (xf_lo, xf_hi), dx
