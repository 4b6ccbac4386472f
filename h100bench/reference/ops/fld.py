"""The stencil helpers of the FLD radiation operator (a frozen copy of
``artemis_tpu_torch/ops/fld.py``'s, the reference of the benchmark):
wrapped neighbour shifts (``torch.roll``), the gradient norm, and the
masks of the physical edges through which ``radiation.py``'s tensor
operator masks its coefficients.
"""

from __future__ import annotations

import torch


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



