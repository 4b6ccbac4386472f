"""Units and physical constants (code-unit conversions).

TPU-native reimplementation of the reference unit system
(``src/utils/units.{hpp,cpp}``): ``scalefree`` or ``cgs`` physical units with
``base`` (explicit length/time/mass) or ``ppd`` (AU, Msun, yr/2pi) conversions,
plus physical constants converted to code units.

Copied verbatim from ``artemis_tpu/units.py`` (it needs only the standard
library and numpy), so that ``artemis_tpu_torch`` runs where JAX is not
installed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

# CGS constants (values as in the reference, src/utils/units.cpp:18-23 and
# parthenon::constants::CGS)
MSOLAR = 1.988416e33
AU = 1.495978707e13
YEAR = 31536000.0
PARSEC = 3.0857e18
RJUP = 6.991100e6
MJUP = 1.8982e30

G_CGS = 6.67430e-8
KB_CGS = 1.380649e-16
C_CGS = 2.99792458e10
H_CGS = 6.62607015e-27
AR_CGS = 7.565733250336727e-15  # 8 pi^5 kb^4 / (15 h^3 c^3)
AMU_CGS = 1.66053906660e-24
EV_CGS = 1.602176634e-12


@dataclass(frozen=True)
class Units:
    physical_units: str = "scalefree"  # "scalefree" | "cgs"
    length: float = 1.0  # code->physical conversion factors
    time: float = 1.0
    mass: float = 1.0

    @property
    def energy(self) -> float:
        return self.length**2 * self.mass / self.time**2

    @property
    def number_density(self) -> float:
        return self.length**-3

    @property
    def mass_density(self) -> float:
        return self.mass * self.number_density

    @property
    def speed(self) -> float:
        return self.length / self.time

    @property
    def opacity(self) -> float:
        return self.length**2 / self.mass

    @property
    def specific_heat(self) -> float:
        return self.energy / self.mass

    @classmethod
    def from_input(cls, pin) -> "Units":
        sys = pin.get_or_add_str("artemis", "physical_units", "scalefree")
        if sys == "scalefree":
            return cls("scalefree", 1.0, 1.0, 1.0)
        if sys != "cgs":
            raise ValueError(f"unknown physical_units {sys!r}")
        conv = pin.get_or_add_str("artemis", "unit_conversion", "base")
        if conv == "base":
            return cls(
                "cgs",
                pin.get_or_add_real("artemis", "length", 1.0),
                pin.get_or_add_real("artemis", "time", 1.0),
                pin.get_or_add_real("artemis", "mass", 1.0),
            )
        if conv == "ppd":
            return cls("cgs", AU, YEAR / (2.0 * math.pi), MSOLAR)
        raise ValueError(f"unknown unit_conversion {conv!r}")


@dataclass(frozen=True)
class Constants:
    """Physical constants in both physical and code units."""

    G: float
    kb: float
    c: float
    h: float
    ar: float
    amu: float
    eV: float
    Msolar: float
    AU: float
    Rjup: float
    Mjup: float
    pc: float
    Year: float
    # code-unit versions
    G_code: float = field(default=0.0)
    kb_code: float = field(default=0.0)
    c_code: float = field(default=0.0)
    h_code: float = field(default=0.0)
    ar_code: float = field(default=0.0)
    amu_code: float = field(default=0.0)
    eV_code: float = field(default=0.0)
    Msolar_code: float = field(default=0.0)
    AU_code: float = field(default=0.0)
    Rjup_code: float = field(default=0.0)
    Mjup_code: float = field(default=0.0)
    pc_code: float = field(default=0.0)
    Year_code: float = field(default=0.0)

    @classmethod
    def from_units(cls, units: Units) -> "Constants":
        if units.physical_units == "scalefree":
            phys = dict(
                G=1.0, kb=1.0, c=1.0, h=1.0, ar=1.0, amu=1.0, eV=1.0,
                Msolar=1.0, AU=1.0, Rjup=1.0, Mjup=1.0, pc=1.0, Year=1.0,
            )
        else:
            phys = dict(
                G=G_CGS, kb=KB_CGS, c=C_CGS, h=H_CGS, ar=AR_CGS, amu=AMU_CGS,
                eV=EV_CGS, Msolar=MSOLAR, AU=AU, Rjup=RJUP, Mjup=MJUP,
                pc=PARSEC, Year=YEAR,
            )
        L, T, M = units.length, units.time, units.mass
        code = dict(
            G_code=phys["G"] * L**-3 / M * T**2,
            kb_code=phys["kb"] * T**2 / M * L**-2,
            c_code=phys["c"] * T / L,
            h_code=phys["h"] * T / M * L**-2,
            ar_code=phys["ar"] * L * T**2 / M,
            amu_code=phys["amu"] / M,
            eV_code=phys["eV"] * T**2 / M * L**-2,
            Msolar_code=phys["Msolar"] / M,
            AU_code=phys["AU"] / L,
            Rjup_code=phys["Rjup"] / L,
            Mjup_code=phys["Mjup"] / M,
            pc_code=phys["pc"] / L,
            Year_code=phys["Year"] / T,
        )
        return cls(**phys, **code)
