"""The FLD operator application's share of its roofline, in percent: the
least time of every application in the traced window's host pass over the device time
of the kernels launched inside the operator's dispatch point (the
benchmark's ``h100bench.fld_matvec`` span).  An application's least time
is the larger of its compulsory bytes (``roofline.matvec_bytes``) over the
HBM bandwidth and its operations (``roofline.MATVEC_FLOPS_PER_CELL`` a
cell) over the dtype's peak."""

from h100bench import roofline


def read(run):
    t, calls = run.host_trace, run.calls.get("fld_matvec")
    if t is None or not calls:
        return None
    device_s = t.span_device_s.get("h100bench.fld_matvec", 0.0)
    if device_s <= 0.0:
        return None
    least = sum(roofline.bound_s(nbytes, roofline.MATVEC_FLOPS_PER_CELL * cells, run.dtype)[0]
                for nbytes, cells in calls)
    return 100.0 * least / device_s
