"""The whole cycle's share of the card's floating-point peak, in percent:
the operations of one cycle over the measured window's mean cycle, against
the dtype's peak outside the tensor cores.  The time is the host clock's,
over the untraced window (all its cycles and all its time); the operations
are the benchmark's own count of the plain reference's cycle (stages,
radiation, the dt estimate; each aten op's output elements,
``roofline.FlopCounter``), so a later kernel that does the same work reads
the same count."""

from h100bench import roofline


def read(run):
    w, flops = run.window, run.flops
    if flops is None or w["cycles"] == 0:
        return None
    cycle_s = w["seconds"] / w["cycles"]
    return 100.0 * flops["cycle"] / cycle_s / roofline.PEAK_FLOPS[run.dtype]
