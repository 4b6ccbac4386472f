"""The device's idle share of the traced cycles, in percent: 100 x (1 -
busy / span), both from the profiler's trace of the same cycles (the
device pass, which records the CUDA activity alone, ``trace.traced``).
The busy time is the union of the device's kernel, copy and set intervals
inside the traced window; the span is the window's, from the cycles'
first CUDA call to the end of the device sync that closes them
(``trace.TraceWindow``).  What the profiler still adds to the host's time
a cycle, the run prints on standard error beside the untraced cycle."""


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0 or t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
