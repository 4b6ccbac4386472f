"""artemis_tpu_torch — the PyTorch/CUDA port of ``artemis_tpu``.

Plain tensor code is PyTorch; each TPU Pallas kernel on the ported path is
a CUDA kernel written for Hopper (``csrc/``), built by ``_build`` at first
use.  The package imports neither JAX nor ``artemis_tpu``: it runs where
only PyTorch is installed.  So far it covers single-level Cartesian gas
hydro (the linear-wave deck); ROADMAP.md lists what comes next.
"""

__version__ = "0.1.0"

from .config import ParameterInput  # noqa: F401,E402
from .simulation import Simulation  # noqa: F401,E402
