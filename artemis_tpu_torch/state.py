"""Carry simulation state between the JAX package and the port.

A state is ``{name: {key: array}}``: ``{fluid: {"u": ..., "w": ...,
["dtden": ...]}}`` per fluid (gas [1, 6, ...]; dust [nspecies, 4, ...]
where the run has it), and ``{"rad": {"Er": ...}}`` when radiation is
on.  The JAX package holds jax arrays, this package torch tensors; both
convert through numpy, every name and key included (the fused paths'
per-block CFL denominators ``dtden`` and the radiation energy density
``Er`` too), so a state made by one can be stepped by the other: the disk,
linear-wave and radiation slice tests hand the JAX run's initial state to
the port this way.  A refinement tree holds one such state per node, in
the tree's node order (the JAX package's ``SMRDriver._states``, the port's
``amr.SMRDriver._states``): ``tree_from_numpy`` and ``tree_to_numpy``
carry the whole list.  An adaptive tree's node list changes as it runs:
``tree_rows`` reads the topology of either package's tree as rows, and
``tree_topology_from_rows`` builds it into a port tree before its states
are carried (the port's restart rebuilds a tile pool from its checkpoint
rows through it too).
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(state_np, device, dtype):
    """{name: {key: array-like}} -> {name: {key: tensor on device in dtype}}."""
    return {name: {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
                   for k, v in kinds.items()}
            for name, kinds in state_np.items()}


def state_to_numpy(state):
    """{name: {key: tensor}} -> {name: {key: numpy array on the host}}."""
    return {name: {k: v.detach().cpu().numpy() for k, v in kinds.items()}
            for name, kinds in state.items()}


def tree_from_numpy(states_np, device, dtype):
    """A refinement tree's per-node states, numpy -> tensors."""
    return [state_from_numpy(st, device, dtype) for st in states_np]


def tree_to_numpy(states):
    """A refinement tree's per-node states, tensors (or any array the
    numpy interface reads, as the JAX package's) -> numpy."""
    return [{name: {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
                    for k, v in kinds.items()}
             for name, kinds in st.items()} for st in states]


def tree_rows(nodes):
    """Rows [level, parent_index, lo1, lo2, lo3, n1, n2, n3, pool] of the
    nodes below the root (either package's tree; the ``pool`` payload's
    layout and a pool flag), as int64 numpy."""
    return np.array([[nd.level, nd.parent.index, *nd.lo, *nd.n, int(getattr(nd, "pool", False))]
                     for nd in nodes[1:]], dtype=np.int64).reshape(-1, 9)


def tree_topology_from_rows(smr, rows):
    """Append the nodes of ``rows`` to a port tree, in row order, and re-run
    its set-up.  A row is ``tree_rows``' [level, parent_index, lo, n,
    pool], or a ``pool`` payload's [level, parent_index, lo, n] (a pool
    node), or an older checkpoint's pool row [lo, n] (a level-1 tile of
    the root)."""
    for row in np.asarray(rows, dtype=np.int64):
        if len(row) == 6:
            row = np.concatenate([[1, 0], row])
        level, parent, lo, n = int(row[0]), int(row[1]), row[2:5], row[5:8]
        node = smr.add_patch(level, tuple(int(v) for v in lo), tuple(int(v) for v in n),
                             parent=smr.nodes[parent])
        node.pool = bool(row[8]) if len(row) == 9 else True
    smr._compile(smr.fused, smr.gather6)
    return smr
