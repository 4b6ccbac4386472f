"""FLD operator applications a cycle in the measured window (1 + the CG
iterations of each Newton outer, per solve), from the program's launch
counter in ``ops/fld.py``: one launch applies the operator to one node, or
to a group of same-shape nodes on the node axis."""


def read(run):
    n = run.window["counters"].get("fld_matvec", 0)
    if n == 0:
        return None
    return n / run.window["cycles"]
