"""Milliseconds a cycle of the operator-split radiation step, from the
program's phase table (``profiling.phase_table``: the phase between two
device syncs, on a copy of the state after the traced window)."""


def read(run):
    if not run.phases or "radiation" not in run.phases:
        return None
    return 1e3 * run.phases["radiation"] / run.phase_cycles
