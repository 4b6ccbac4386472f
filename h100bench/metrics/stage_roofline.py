"""The RK stage's share of its roofline, in percent: the stage's least
time on the card over the device time of every kernel launched inside the
stage dispatch point (the benchmark's ``h100bench.stage`` span), summed
over the calls of the traced window's host pass.  Each call's least time is the larger of
its compulsory bytes (from its shapes, ``roofline.stage_bytes``) over the
HBM bandwidth and the plain reference's operations of one stage over the
dtype's peak."""

from h100bench import roofline


def read(run):
    t, calls, flops = run.host_trace, run.calls.get("stage"), run.flops
    if t is None or not calls or flops is None:
        return None
    device_s = t.span_device_s.get("h100bench.stage", 0.0)
    if device_s <= 0.0:
        return None
    least = sum(roofline.bound_s(nbytes, flops["stage"], run.dtype)[0] for nbytes, _ in calls)
    return 100.0 * least / device_s
