"""Problem generators (reference: src/pgen/pgen.hpp name dispatch; port of
``artemis_tpu/pgen/__init__.py``).  Every problem of the reference is
ported.  ``ssheet`` has no module in the reference (its deck,
inputs/ssheet.in, runs ``problem = strat``), so it is an unknown problem
here."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

@dataclass
class Problem:
    """What a problem generator provides to the driver."""

    prims: Dict[str, object]            # fluid name -> primitive array (interior grid)
    bc_custom: Dict[str, Callable] = field(default_factory=dict)
    sources: List[Callable] = field(default_factory=list)
    after_loop: Optional[Callable] = None   # fn(grid, pin, state, tm, data_dir)
    on_restart: Optional[Callable] = None   # fn(sim, payloads) — rehydrate pkg state
    # user AMR criterion (<artemis> amr_user; ProblemCheckRefinementBlock,
    # artemis.cpp:149-150): fn(w_gas, grid) -> bool refine mask (interior)
    amr_criterion: Optional[Callable] = None


def build_problem(name: str, pin, grid, gas_cfg=None, dust_cfg=None) -> Problem:
    if name in ("linear_wave", "linear_wave1d"):
        from . import linear_wave
        return linear_wave.build(pin, grid, gas_cfg, dust_cfg)
    if name == "advection":
        from . import advection
        return advection.build(pin, grid, gas_cfg, dust_cfg)
    if name == "constant":
        from . import constant
        return constant.build(pin, grid, gas_cfg, dust_cfg)
    if name == "blast":
        from . import blast
        return blast.build(pin, grid, gas_cfg, dust_cfg)
    if name == "gaussian_bump":
        from . import gaussian_bump
        return gaussian_bump.build(pin, grid, gas_cfg, dust_cfg)
    if name == "conduction":
        from . import conduction
        return conduction.build(pin, grid, gas_cfg, dust_cfg)
    if name == "strat":
        from . import strat
        return strat.build(pin, grid, gas_cfg, dust_cfg)
    if name == "disk":
        from . import disk
        return disk.build(pin, grid, gas_cfg, dust_cfg)
    if name == "shock":
        from . import shock
        return shock.build(pin, grid, gas_cfg, dust_cfg)
    if name == "thermalization":
        from . import thermalization
        return thermalization.build(pin, grid, gas_cfg, dust_cfg)
    raise ValueError(f"unknown problem {name!r}")
