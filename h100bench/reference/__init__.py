"""The benchmark's plain reference: a frozen copy of the plain PyTorch path
of ``artemis_tpu_torch`` (its composable single-level driver, its static
refinement tree on the composable path, the tensor-operation FLD operator,
the disk problem generator and the source packages), taken at the commit
that added the benchmark, with every kernel dispatch, the adaptive and
sharded trees, N-body coupling, outputs and restarts taken out and the
imports made relative to this package.

It imports nothing of ``artemis_tpu_torch``, ``artemis_tpu`` or ``jax``, and
takes nothing that the program has made: it builds its own grid, geometry,
ghost-strip caches, initial state and operators from the deck.  It runs
on the card in the deck's precision, after the program's window, and is
what the benchmark's ``correct`` holds the program's output against.
"""

from .simulation import Simulation  # noqa: F401
