"""Does the JAX package resume a moved curvilinear tracking patch as its
straight run goes on?  And the port?

The disk_nbody_cyl tracking tree of tests/test_amr_multilevel.py:168 (64x64,
``numlevel = 1``, an inline planet with refine_distance 0.3, a retag every
4 cycles) moves its patch from (33, 28, 0) to (33, 29, 0) at cycle 20.
Each package runs it straight for 24 cycles, and again for 20 cycles with
a checkpoint that it then resumes to 24.  The script prints, per package,
where the resumed patch sits (its ``lo`` and its grid's x2 edge) and the
largest difference of every node's u and w between the resumed and the
straight run.  CPU, float64; the JAX runs take about a minute.

    JAX_PLATFORMS=cpu python tools/tracking_resume.py
"""

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from artemis_tpu.simulation import Simulation as JSimulation  # noqa: E402
from artemis_tpu_torch import Simulation  # noqa: E402
from artemis_tpu_torch.state import tree_to_numpy  # noqa: E402

DECK = os.path.join(ROOT, "inputs", "disk_nbody_cyl.in")
TRACK = ["parthenon/mesh/nx1=64", "parthenon/mesh/nx2=64", "parthenon/mesh/refinement=static",
         "parthenon/mesh/numlevel=1", "parthenon/refinement/check_interval=4",
         "nbody/planet1/mass=1.0e-4", "nbody/planet1/a=2.0", "nbody/planet1/f=0.0",
         "nbody/planet1/refine_distance=0.3", "nbody/disable_outputs=true",
         f"nbody/planets/input_file={ROOT}/inputs/planet_inputs/n4_sys.txt"]
RST = ["parthenon/output9/file_type=rst", "parthenon/output9/dt=100.0"]


def make(pkg, overrides, data, restart=None):
    if pkg == "jax":
        return JSimulation(DECK, overrides, data, restart=restart)
    return Simulation(DECK, overrides, data, device="cpu", restart=restart)


def main():
    with tempfile.TemporaryDirectory() as tmp:
        for pkg in ("jax", "port"):
            straight = make(pkg, TRACK + ["parthenon/time/nlim=24"], f"{tmp}/{pkg}_straight")
            straight.run()
            half = make(pkg, TRACK + RST + ["parthenon/time/nlim=20"], f"{tmp}/{pkg}_half")
            half.run()
            path = f"{tmp}/{pkg}_half/disk_nbody.out9.final.rst.npz"
            resumed = make(pkg, TRACK + ["parthenon/time/nlim=24"], f"{tmp}/{pkg}_half",
                           restart=path)
            node = resumed.driver.smr.nodes[1]
            print(f"{pkg}: resumed patch lo {node.lo}, x2min {node.grid.xmin[1]!r} (straight "
                  f"run's patch lo {straight.driver.smr.nodes[1].lo}, x2min "
                  f"{straight.driver.smr.nodes[1].grid.xmin[1]!r})", flush=True)
            resumed.run()
            diff = max(float(np.abs(a["gas"][k] - b["gas"][k]).max())
                       for a, b in zip(tree_to_numpy(resumed.driver._states),
                                       tree_to_numpy(straight.driver._states))
                       for k in ("u", "w"))
            print(f"{pkg}: resumed vs straight after cycle {resumed.tm.ncycle}: max |diff| "
                  f"of every node's u and w {diff!r}", flush=True)


if __name__ == "__main__":
    main()
