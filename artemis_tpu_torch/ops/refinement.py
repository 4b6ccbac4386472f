"""AMR tagging criteria (reference: src/utils/refinement/amr_criteria.hpp;
port of ``artemis_tpu/ops/refinement.py``).

Pure functions from a primitive field to refine/derefine tags, which the
adaptive refinement tree uses to place its fine patches.  The fields are
tensors on the run's device; the stencil widths are numpy rows from the
grid's geometry.
"""

from __future__ import annotations

import numpy as np
import torch


def scalar_magnitude(field, refine_thr, deref_thr):
    """Tag where the field exceeds refine_thr; untag below deref_thr
    (ScalarMagnitude)."""
    return field > refine_thr, field < deref_thr


def grid_stencil_widths(grid):
    """Per-cell physical stencil widths of the gradient criterion: the
    centroid span ``xv_{+1} - xv_{-1}`` times the scale factor at the cell
    (amr_criteria.hpp:69-86), as (w1, w2, w3) broadcastable to the interior
    [x3, x2, x1] layout (inactive axes get width 1)."""
    g = grid.geom
    ng1, ng2, ng3 = grid.ng
    n1, n2, n3 = grid.nx

    def span(xv, lo, n):
        if n <= 1:
            return np.ones((1,), xv.dtype)
        return xv[lo + 1:lo + n + 1] - xv[lo - 1:lo + n - 1]

    x1i = g.xv1[ng1:ng1 + n1][None, None, :]
    x2i = g.xv2[ng2:ng2 + n2][None, :, None]
    w1 = span(g.xv1, ng1, n1)[None, None, :] * g.hx(1, x1i, x2i)
    w2 = span(g.xv2, ng2, n2)[None, :, None] * g.hx(2, x1i, x2i)
    w3 = span(g.xv3, ng3, n3)[:, None, None] * g.hx(3, x1i, x2i)
    return w1, w2, w3


def scalar_first_derivative(field, widths, dims, refine_thr, deref_thr, bc=None):
    """Normalized gradient magnitude criterion (ScalarFirstDerivative,
    amr_criteria.hpp:28-96): ``eps = |grad f| sqrt(sum_d w_d^2) / |f|``
    with ``widths[d-1]`` the physical stencil width of axis d.  A periodic
    axis (``bc[d-1]``, or every axis when ``bc`` is None) wraps; any other
    sees edge-replicated neighbours, as the reference's BC-filled ghosts
    give a scalar at an outflow or reflecting wall."""
    g2 = 0.0
    w2 = 0.0
    for d in dims:
        # float64 widths promote a float32 field's differences, as the JAX
        # package's numpy rows do
        w = torch.as_tensor(np.asarray(widths[d - 1]), dtype=torch.float64,
                            device=field.device)
        ax = field.ndim - d
        if bc is None or tuple(bc[d - 1]) == ("periodic", "periodic"):
            fp = torch.roll(field, -1, dims=ax)
            fm = torch.roll(field, 1, dims=ax)
        else:
            n = field.shape[ax]
            fp = torch.cat([field.narrow(ax, 1, n - 1), field.narrow(ax, n - 1, 1)], dim=ax)
            fm = torch.cat([field.narrow(ax, 0, 1), field.narrow(ax, 0, n - 1)], dim=ax)
        df = (fp - fm) / w
        g2 = g2 + df ** 2
        w2 = w2 + w ** 2
    eps = torch.sqrt(g2) * torch.sqrt(w2) / torch.clamp_min(field.abs(), 1e-300)
    return eps > refine_thr, eps < deref_thr
