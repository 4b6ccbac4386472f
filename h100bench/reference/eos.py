"""Equations of state (port of ``artemis_tpu/eos.py``).

The reference instantiates only ``singularity::IdealGas`` (src/utils/eos/eos.hpp:25),
with the call surface: PressureFromDensityInternalEnergy, BulkModulus...,
GruneisenParam..., SpecificHeat... . Here that surface is a tiny frozen
dataclass whose methods are plain tensor expressions.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class IdealGas:
    """Ideal gas: p = (gamma-1) * rho * sie;  T = sie / cv."""

    gamma: float = 5.0 / 3.0
    cv: float = 1.0

    @property
    def gm1(self) -> float:
        return self.gamma - 1.0

    def pressure(self, rho, sie):
        return self.gm1 * rho * sie

    def bulk_modulus(self, rho, sie):
        return self.gamma * self.gm1 * rho * sie

    def sound_speed(self, rho, sie):
        return torch.sqrt(self.bulk_modulus(rho, sie) / rho)

    def sie_from_pressure(self, rho, p):
        return p / (self.gm1 * rho)

    def temperature(self, rho, sie):
        return sie / self.cv

    def sie_from_temperature(self, rho, T):
        return T * self.cv

    def specific_heat(self, rho=None, sie=None):
        return self.cv

    def gruneisen_param(self, rho=None, sie=None):
        """Gruneisen parameter (GruneisenParamFromDensity*, = gamma-1 for
        ideal gas) — completes the reference's singularity-eos call surface."""
        return self.gm1


def eos_from_input(pin, constants) -> IdealGas:
    """Build the gas EOS exactly as the reference does (src/gas/gas.cpp:102-122)."""
    name = pin.get_or_add_str("gas", "eos", "ideal")
    if name != "ideal":
        raise ValueError(f"unsupported EOS {name!r}")
    gamma = pin.get_or_add_real("gas", "gamma", 1.66666666667)
    if pin.exists("gas", "cv"):
        if pin.exists("gas", "mmw"):
            raise ValueError("Cannot specify both cv and mmw")
        cv = pin.get_real("gas", "cv")
        if cv <= 0:
            raise ValueError("Only positive cv allowed!")
    else:
        mu = pin.get_or_add_real("gas", "mu", 1.0)
        if mu <= 0:
            raise ValueError("Only positive mean molecular weight allowed!")
        cv = constants.kb_code / ((gamma - 1.0) * constants.amu_code * mu)
    return IdealGas(gamma=gamma, cv=cv)
