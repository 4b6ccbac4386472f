"""Carry simulation state between the JAX package and the port.

A state is ``{fluid: {"u": ..., "w": ..., ["dtden": ...]}}``.  The JAX
package holds jax arrays, this package torch tensors; both convert through
numpy, every key included (the fused paths' per-block CFL denominators
``dtden`` too), so a state made by one can be stepped by the other: the
disk and linear-wave slice tests hand the JAX run's initial state to the
port this way.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(state_np, device, dtype):
    """{fluid: {key: array-like}} -> {fluid: {key: tensor on device in dtype}}."""
    return {fluid: {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
                    for k, v in kinds.items()}
            for fluid, kinds in state_np.items()}


def state_to_numpy(state):
    """{fluid: {key: tensor}} -> {fluid: {key: numpy array on the host}}."""
    return {fluid: {k: v.detach().cpu().numpy() for k, v in kinds.items()}
            for fluid, kinds in state.items()}
