"""Count the PyTorch operations that the N-body decks' sources dispatch per
cycle, on the host.

Each dispatched aten operation is one kernel launch when the run is on the
card, so these counts say how launch-bound the chain behind the stage is.
The decks are run as written (float64) for one cycle on the CPU through
``Driver.step``, with the partial curvilinear stage the card takes (its
plain version here), and each source's ``apply`` counted by a
``TorchDispatchMode``.  A count needs no card: it is what the program does,
not a time.

    python tools/nbody_ops.py
"""

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from artemis_tpu_torch import Simulation  # noqa: E402

PLANETS = os.path.join(ROOT, "inputs", "planet_inputs")
DECKS = {"binary_nbody_cyl": [],
         "cb_disk": [],
         "disk_collision": [f"nbody/planets/input_file={PLANETS}/n20_sys.txt"],
         "disk_nbody_cyl": [f"nbody/planets/input_file={PLANETS}/n4_sys.txt"]}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count(name, overrides, data):
    sim = Simulation(os.path.join(ROOT, "inputs", f"{name}.in"), overrides, data,
                     device="cpu")
    d = sim.driver
    partial = d._make_curv_stage(d.grid, d.gas_cfg)   # the card's dispatch
    if partial is not None and not partial.full:
        d._curv = partial
    srcs = d._curv_srcs if d._curv is not None else d.sources
    counts = {}
    for s in srcs:
        c = counts.setdefault(type(s).__name__, Count())
        s.apply = (lambda fn, c: lambda *a, **k: _counted(c, fn, *a, **k))(s.apply, c)
    d.step(sim.state, d.estimate_dt(sim.state), 0.0)
    stages = d.integrator.nstages
    per = {k: c.n for k, c in counts.items()}
    grav = per.get("NBodyGravity", 0) / (stages * sim.nbody.npart)
    print(f"{name}: {sim.nbody.npart} particles, stage "
          f"{'partial K4' if d._curv is not None else 'the plain chain'}; operations "
          f"per cycle by source {per}; N-body gravity {grav:.1f} per particle a stage")


def _counted(c, fn, *a, **k):
    with c:
        return fn(*a, **k)


if __name__ == "__main__":
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as data:
        for name, over in DECKS.items():
            count(name, over, data)
