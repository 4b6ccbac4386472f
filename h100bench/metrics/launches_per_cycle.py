"""Device kernels a cycle in the traced window, from the profiler's
trace (the device pass): how many launches the host loop issues a cycle."""


def read(run):
    t = run.trace
    if t is None or t.kernels == 0:
        return None
    return t.kernels / t.cycles
