"""Problem generators of the reference (a frozen copy of
``artemis_tpu_torch/pgen``'s disk generator, src/pgen/disk.hpp)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List


@dataclass
class Problem:
    """What a problem generator provides to the driver."""

    prims: Dict[str, object]            # fluid name -> primitive array (interior grid)
    bc_custom: Dict[str, Callable] = field(default_factory=dict)
    sources: List[Callable] = field(default_factory=list)


def build_problem(name: str, pin, grid, gas_cfg=None, dust_cfg=None) -> Problem:
    if name == "disk":
        from . import disk
        return disk.build(pin, grid, gas_cfg, dust_cfg)
    raise ValueError(f"problem {name!r}: the reference builds the disk alone")
