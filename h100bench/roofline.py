"""The yardstick's arithmetic: the card's published peaks, the compulsory
bytes of the kernels the cells time, and an operation count of the plain
reference (the arithmetic of ``chip_smoke.py``'s ``bound``,
``tensor_bytes`` and ``count_flops``).

A kernel's least time is the larger of its compulsory bytes over the HBM
bandwidth and its floating-point operations over the non-tensor peak of
its dtype.  Compulsory bytes count every input read once and every output
written once, whatever the kernel reads again.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the FP32 / FP64 rates
# outside the tensor cores (the stage and FLD kernels use none)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

# aten ops counted as one floating-point operation per output element
FLOP_OPS = {"add", "sub", "rsub", "mul", "div", "pow", "sqrt", "rsqrt", "reciprocal",
            "exp", "log", "addcmul", "addcdiv"}

# gas variables of the stage's registers and primitives
# (rho, m1, m2, m3, E, eint) and (rho, v1, v2, v3, p, sie)
NVAR_GAS = 6
# operations of one FLD operator application per cell:
# (diag + sf) E - sum_d (AH_d E_+d + AL_d E_-d): 1 add, 1 mul, 6 mul, 6 sub
MATVEC_FLOPS_PER_CELL = 14


def bound_s(nbytes: float, flops: float, dtype) -> tuple:
    """(seconds, "bytes" | "operations"): the least time of ``nbytes`` of
    compulsory traffic and ``flops`` operations in ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def halo_cells(nx, ng: int, axes) -> int:
    """Ghost cells a stage reads beyond the interior ``nx`` = (nx1, nx2,
    nx3): ``ng`` layers on both faces of each axis in ``axes`` (0-based)."""
    total = 0
    for d in axes:
        other = 1
        for e in range(3):
            if e != d:
                other *= nx[e]
        total += 2 * ng * other
    return total


def stage_bytes(nodes, ng: int, esize: int, reads_u0: bool) -> int:
    """Compulsory bytes of one fused RK stage over ``nodes``, each
    ``(nx, halo_axes)``: the primitives w and the cycle's register u1 read,
    the stage register u0 read where the stage weighs it (gam0 != 0), the
    halo's primitives read, and u and w written."""
    total = 0
    for nx, axes in nodes:
        cells = nx[0] * nx[1] * nx[2]
        arrays = (3 if reads_u0 else 2) + 2
        total += (arrays * cells + halo_cells(nx, ng, axes)) * NVAR_GAS * esize
    return total


def matvec_bytes(cells: int, esize: int) -> int:
    """Compulsory bytes of one FLD operator application on ``cells`` cells:
    E, the six face coefficients, the geometric diagonal and the coupling
    ``sf`` read, the result written."""
    return (1 + 6 + 1 + 1 + 1) * cells * esize


class FlopCounter(TorchDispatchMode):
    """Counts the output elements of every FLOP_OPS aten op into
    ``counts[bucket]``; ``with counter.bucket_as(name):`` sets the bucket."""

    def __init__(self):
        super().__init__()
        self.counts = {}
        self.bucket = "other"

    @contextlib.contextmanager
    def bucket_as(self, name):
        before, self.bucket = self.bucket, name
        try:
            yield
        finally:
            self.bucket = before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.overloadpacket.__name__.rstrip("_") in FLOP_OPS
                and isinstance(out, torch.Tensor) and out.is_floating_point()):
            self.counts[self.bucket] = self.counts.get(self.bucket, 0) + out.numel()
        return out
