"""N-body package: deterministic replicated few-body dynamics coupled to the
grid (the port's own copy of ``artemis_tpu/nbody.py``, which is numpy and
ctypes only; the port may not import ``artemis_tpu``).

Rebuild of the reference N-body machinery (src/nbody/, SURVEY.md §2.4):
the reference embeds the REBOUND C library on MPI rank 0 and broadcasts
particle state; here the (tiny) particle system is integrated on the host
by the in-repo native C++ integrator (native/nbody.cpp — IAS15-class
adaptive Gauss-Radau + leapfrog, PN extras, bound-merge collisions).

Coupling to the hydro RK stages follows nbody_advance.cpp:22-208: each stage
advances a *copy* of the master system from the step-start state using the
running stage-blended grid force as a velocity kick; the final stage
advances the master.  The stage-consistent coupling integrator is derived
from the hydro low-storage coefficients (artemis_driver.cpp:71-95).

Outputs: ASCII ``.reb`` (per-particle state + accreted mass/momentum) and
``.orb`` (orbital elements of bound pairs) files, in the reference's column
conventions (nbody_outputs.cpp; doc/src/physics.rst "N-Body Outputs").

The native library is built from the unchanged ``native/nbody.cpp`` with
g++ (``native/Makefile``'s flags) into ``artemis_tpu_torch/_build/`` at
first use, under a name carrying a hash of the source and the flags; the
build goes to a temporary name and is renamed into place, so concurrent
processes never load a half-written library.  Nothing is written under
``native/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import numpy as np

NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "nbody.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# native/Makefile's CXXFLAGS and link line
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_LIB = None


def library_path() -> Path:
    """Where the build of the current ``native/nbody.cpp`` lives."""
    h = hashlib.sha256("\0".join(CXX_FLAGS).encode() + b"\0" + NATIVE_SRC.read_bytes())
    return BUILD_DIR / f"libnbody-{h.hexdigest()[:16]}.so"


def _lib():
    global _LIB
    if _LIB is None:
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed building {NATIVE_SRC.name} "
                                   f"(exit {res.returncode}):\n{res.stdout}{res.stderr}")
            os.replace(tmp, so)
        _LIB = ctypes.CDLL(str(so))
        _LIB.nb_integrate.restype = ctypes.c_int
    return _LIB


# reference integrator menu (nbody.cpp:203-223), each backed by the genuine
# algorithm class in native/nbody.cpp: ias15 = adaptive 15th-order
# Gauss-Radau; bs = adaptive Gragg-Bulirsch-Stoer extrapolation;
# mercurius = WHFast with K-switched direct close encounters;
# whfast = fixed-step Wisdom-Holman symplectic; janus = bit-reversible
# integer-lattice DKD (Rein & Tamayo 2018); saba = SABA(2) two-stage
# symplectic (Laskar & Robutel 2001); leapfrog = plain kick-drift-kick
INTEGRATORS = {"ias15": 0, "bs": 4, "whfast": 3, "leapfrog": 1, "janus": 6,
               "saba": 7, "mercurius": 5, "none": 2}


def _init_orbit(gm, a, e, i, o, O, f):
    """Position/velocity of the relative orbit (cf. init_orbit,
    nbody_setup.cpp:102-140)."""
    n = math.sqrt(gm / a**3)
    vb = a * n / math.sqrt(1.0 - e * e)
    rb = a * (1.0 - e * e) / (1.0 + e * math.cos(f))
    xb, yb = rb * math.cos(f), rb * math.sin(f)
    vxb, vyb = -math.sin(f) * vb, (math.cos(f) + e) * vb
    co, so_ = math.cos(o), math.sin(o)
    cO, sO = math.cos(O), math.sin(O)
    cI, sI = math.cos(i), math.sin(i)
    cf = xb * co - so_ * yb
    sf = xb * so_ + co * yb
    pos = (cO * cf - sO * sf * cI, sO * cf + cO * sf * cI, sf * sI)
    cf = vxb * co - so_ * vyb
    sf = vxb * so_ + co * vyb
    vel = (cO * cf - sO * sf * cI, sO * cf + cO * sf * cI, sf * sI)
    return np.array(pos), np.array(vel)


@dataclass
class ParticleParams:
    m: float = 0.0
    radius: float = 0.0
    rs: float = 0.0
    spline: int = 0
    racc: float = 0.0
    gamma: float = 0.0
    beta: float = 0.0
    couple: int = 1
    live: int = 0
    live_after: float = 0.0
    target_rad: float = 0.0
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    vx: float = 0.0
    vy: float = 0.0
    vz: float = 0.0
    init: int = 0


def _soft(pin, block):
    st = pin.get_str(block, "type")
    if st == "none":
        return 0.0, 0
    rs = pin.get_real(block, "radius")
    if st == "plummer":
        return rs, 0
    if st == "spline":
        return rs, 1
    raise ValueError(f"Unknown particle softening type {st}")


def _loadtxt(fname):
    """ASCII table reader (cf. ArtemisUtils::loadtxt): '#' comments, any
    whitespace, ragged rows allowed."""
    rows = []
    with open(fname) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                rows.append([float(tok) for tok in line.replace(",", " ").split()])
    return rows


def setup_particles(pin, G: float, mtot_in: float):
    """Parse the <nbody/...> setup DSL (cf. NBodySetup, nbody_setup.cpp:650-723).

    Supports <nbody/particleN> (+/soft,/sink,/initialize), <nbody/binary*>,
    <nbody/triple*>, <nbody/system*> (input_file: m x y z vx vy vz sft
    [gamma beta target_rad radius]) and <nbody/planet*> — inline orbital
    elements or input_file (q a e i f o O sft [gamma beta target_rad
    radius], nbody_setup.cpp:562-623).  Returns (parts dict, mtot).
    """
    parts: Dict[int, ParticleParams] = {}

    def part_blocks(prefix):
        idx = set()
        for b in pin.block_names():
            segs = b.split("/")
            if len(segs) >= 2 and segs[0] == "nbody" and segs[1].startswith(prefix):
                tail = segs[1].removeprefix(prefix)
                if tail.isdigit():
                    idx.add(int(tail))
        return sorted(idx)

    def named_blocks(prefix):
        """All <nbody/prefix*> block names in file order (the reference
        prefix-matches, so <nbody/planets> counts too)."""
        seen = []
        for b in pin.block_names():
            segs = b.split("/")
            if (len(segs) == 2 and segs[0] == "nbody"
                    and segs[1].startswith(prefix) and b not in seen):
                seen.append(b)
        return seen

    for pid in part_blocks("particle"):
        blk = f"nbody/particle{pid}"
        p = ParticleParams()
        p.m = pin.get_real(blk, "mass")
        p.radius = pin.get_or_add_real(blk, "radius", 0.0)
        p.couple = pin.get_or_add_int(blk, "couple", 1)
        p.live = pin.get_or_add_int(blk, "live", 0)
        p.live_after = pin.get_or_add_real(blk, "live_after", 0.0)
        p.target_rad = pin.get_or_add_real(blk, "refine_distance", 0.0)
        if pin.has_block(blk + "/soft"):
            p.rs, p.spline = _soft(pin, blk + "/soft")
        if pin.has_block(blk + "/sink"):
            p.racc = pin.get_real(blk + "/sink", "radius")
            p.gamma = pin.get_real(blk + "/sink", "gamma")
            p.beta = pin.get_or_add_real(blk + "/sink", "beta", 0.0)
        if pin.has_block(blk + "/initialize"):
            ib = blk + "/initialize"
            p.x = pin.get_or_add_real(ib, "x", 0.0)
            p.y = pin.get_or_add_real(ib, "y", 0.0)
            p.z = pin.get_or_add_real(ib, "z", 0.0)
            p.vx = pin.get_or_add_real(ib, "vx", 0.0)
            p.vy = pin.get_or_add_real(ib, "vy", 0.0)
            p.vz = pin.get_or_add_real(ib, "vz", 0.0)
            p.init = 1
        parts[pid] = p

    for bid in part_blocks("binary"):
        blk = f"nbody/binary{bid}"
        mass = pin.get_or_add_real(blk, "mass", -1.0)
        a = pin.get_real(blk, "a")
        e = pin.get_or_add_real(blk, "e", 0.0)
        inc = math.radians(pin.get_or_add_real(blk, "i", 0.0))
        o = math.radians(pin.get_or_add_real(blk, "o", 0.0))
        O = math.radians(pin.get_or_add_real(blk, "O", 0.0))
        f = math.radians(pin.get_or_add_real(blk, "f", 180.0))
        Rb = np.array([pin.get_or_add_real(blk, k, 0.0) for k in ("x", "y", "z")])
        Vb = np.array([pin.get_or_add_real(blk, k, 0.0) for k in ("vx", "vy", "vz")])
        pp = pin.get_or_add_int(blk, "primary", -1)
        ss = pin.get_or_add_int(blk, "secondary", -1)
        if pp == -1 or ss == -1:
            # create the pair in place (nbody_setup.cpp:241-282)
            qb = pin.get_real(blk, "q")
            radius = pin.get_or_add_real(blk, "radius", 0.0)
            rs = pin.get_or_add_real(blk, "rsoft", 0.0)
            racc = pin.get_or_add_real(blk, "rsink", 0.0)
            gamma = pin.get_or_add_real(blk, "gamma", 0.0)
            beta = pin.get_or_add_real(blk, "beta", 0.0)
            target_rad = pin.get_or_add_real(blk, "refine_distance", 0.0)
            live = pin.get_or_add_int(blk, "live", 0)
            live_after = pin.get_or_add_real(blk, "live_after", 0.0)
            stype = pin.get_or_add_str(blk, "stype", "spline")
            couple = pin.get_or_add_int(blk, "couple", 0)
            if mass < 0:
                raise ValueError(f"mass < 0 for {blk}")
            spline = 1 if stype == "spline" else 0
            m1 = mass / (1.0 + qb)
            m2 = qb * m1
            maxid = max(parts.keys(), default=0)
            mk = lambda m: ParticleParams(m=m, radius=radius, rs=rs, spline=spline,
                                          racc=racc, gamma=gamma, beta=beta,
                                          couple=couple, live=live,
                                          live_after=live_after,
                                          target_rad=target_rad)
            if pp == -1:
                pp = maxid + 1
                parts[pp] = mk(m1)
                maxid += 1
            if ss == -1:
                ss = maxid + 1
                parts[ss] = mk(m2)
        p, s = parts[pp], parts[ss]
        qb = s.m / p.m
        if mass > 0:
            p.m = mass / (1.0 + qb)
            s.m = qb * p.m
        else:
            mass = s.m + p.m
        rb, vb = _init_orbit(G * mass, a, e, inc, o, O, f)
        mu1 = p.m / mass
        mu2 = s.m / mass
        p.x, p.y, p.z = Rb - mu2 * rb
        p.vx, p.vy, p.vz = Vb - mu2 * vb
        s.x, s.y, s.z = Rb + mu1 * rb
        s.vx, s.vy, s.vz = Vb + mu1 * vb
        p.init = 1
        s.init = 1

    for blk in named_blocks("triple"):
        # Hierarchical triple: outer orbit (ao,eo,...) between the primary and
        # the inner-binary barycenter; inner orbit (a,e,...) between secondary
        # and tertiary (cf. ReadTripleBlock, nbody_setup.cpp:327-492).
        mass = pin.get_or_add_real(blk, "mass", -1.0)
        oa = pin.get_real(blk, "ao")
        oe = pin.get_or_add_real(blk, "eo", 0.0)
        oi = math.radians(pin.get_or_add_real(blk, "io", 0.0))
        oo = math.radians(pin.get_or_add_real(blk, "oo", 0.0))
        oO = math.radians(pin.get_or_add_real(blk, "Oo", 0.0))
        of_ = math.radians(pin.get_or_add_real(blk, "fo", 180.0))
        a = pin.get_real(blk, "a")
        e = pin.get_or_add_real(blk, "e", 0.0)
        inc = math.radians(pin.get_or_add_real(blk, "i", 0.0))
        o = math.radians(pin.get_or_add_real(blk, "o", 0.0))
        O = math.radians(pin.get_or_add_real(blk, "O", 0.0))
        f = math.radians(pin.get_or_add_real(blk, "f", 180.0))
        Rc = np.array([pin.get_or_add_real(blk, k, 0.0) for k in ("x", "y", "z")])
        Vc = np.array([pin.get_or_add_real(blk, k, 0.0) for k in ("vx", "vy", "vz")])
        pp = pin.get_or_add_int(blk, "primary", -1)
        ss = pin.get_or_add_int(blk, "secondary", -1)
        tt = pin.get_or_add_int(blk, "tertiary", -1)
        if pp not in parts or ss not in parts or tt not in parts or -1 in (pp, ss, tt):
            qo = pin.get_real(blk, "qo")   # (m2+m3)/m1
            q = pin.get_real(blk, "q")     # m3/m2
            radius = pin.get_or_add_real(blk, "radius", 0.0)
            rs = pin.get_or_add_real(blk, "rsoft", 0.0)
            racc = pin.get_or_add_real(blk, "rsink", 0.0)
            gamma = pin.get_or_add_real(blk, "gamma", 0.0)
            beta = pin.get_or_add_real(blk, "beta", 0.0)
            target_rad = pin.get_or_add_real(blk, "refine_distance", 0.0)
            live = pin.get_or_add_int(blk, "live", 0)
            live_after = pin.get_or_add_real(blk, "live_after", 0.0)
            stype = pin.get_or_add_str(blk, "stype", "spline")
            couple = pin.get_or_add_int(blk, "couple", 0)
            if mass < 0:
                raise ValueError(f"mass < 0 for {blk}")
            spline = 1 if stype == "spline" else 0
            m1 = mass / (1.0 + qo)
            mb = qo * m1
            m2 = mb / (1.0 + q)
            m3 = q * m2
            mk = lambda m: ParticleParams(m=m, radius=radius, rs=rs, spline=spline,
                                          racc=racc, gamma=gamma, beta=beta,
                                          couple=couple, live=live,
                                          live_after=live_after,
                                          target_rad=target_rad)
            maxid = max(parts.keys(), default=0)
            if pp == -1:
                pp = maxid + 1
                parts[pp] = mk(m1)
                maxid = pp
            if ss == -1:
                ss = maxid + 1
                parts[ss] = mk(m2)
                maxid = ss
            if tt == -1:
                tt = maxid + 1
                parts[tt] = mk(m3)
        p, s, t = parts[pp], parts[ss], parts[tt]
        q1 = (s.m + t.m) / p.m
        q2 = t.m / s.m
        if mass > 0:
            p.m = mass / (1.0 + q1)
            s.m = q1 * p.m / (1.0 + q2)
            t.m = q2 * s.m
        else:
            mass = p.m + s.m + t.m
        mb = s.m + t.m
        Rb, Vb = _init_orbit(G * mass, oa, oe, oi, oo, oO, of_)
        mu1, mu2 = p.m / mass, mb / mass
        r0 = Rc - mu2 * Rb
        v0 = Vc - mu2 * Vb
        Rc = Rc + mu1 * Rb
        Vc = Vc + mu1 * Vb
        rb, vb = _init_orbit(G * mb, a, e, inc, o, O, f)
        mu1, mu2 = s.m / mb, t.m / mb
        p.x, p.y, p.z = r0
        p.vx, p.vy, p.vz = v0
        s.x, s.y, s.z = Rc - mu2 * rb
        s.vx, s.vy, s.vz = Vc - mu2 * vb
        t.x, t.y, t.z = Rc + mu1 * rb
        t.vx, t.vy, t.vz = Vc + mu1 * vb
        p.init = s.init = t.init = 1

    for blk in named_blocks("system"):
        # generic system from file: m x y z vx vy vz sft [gamma beta
        # target_rad radius] (ReadNBodySystemBlock, nbody_setup.cpp:499-551)
        couple = pin.get_or_add_int(blk, "couple", 1)
        live = pin.get_or_add_int(blk, "live", 0)
        live_after = pin.get_or_add_real(blk, "live_after", 0.0)
        spline = 1 if pin.get_or_add_str(blk, "stype", "spline") == "spline" else 0
        nid = max(parts.keys(), default=0) + 1
        for row in _loadtxt(pin.get_str(blk, "input_file")):
            p = ParticleParams(couple=couple, live=live, live_after=live_after,
                               spline=spline, init=1)
            p.m, p.x, p.y, p.z, p.vx, p.vy, p.vz, p.rs = row[:8]
            p.racc = p.rs
            opt = row[8:]
            p.gamma = opt[0] if len(opt) > 0 else 0.0
            p.beta = opt[1] if len(opt) > 1 else 0.0
            p.target_rad = opt[2] if len(opt) > 2 else 0.0
            p.radius = opt[3] if len(opt) > 3 else 0.0
            parts[nid] = p
            nid += 1

    for blk in named_blocks("planet"):
        couple = pin.get_or_add_int(blk, "couple", 1)
        if pin.exists(blk, "input_file"):
            # planetary system from file around a unit central mass:
            # q a e i f o O sft [gamma beta target_rad radius]
            # (ReadPlanetarySystemBlock, nbody_setup.cpp:562-623)
            live = pin.get_or_add_int(blk, "live", 0)
            live_after = pin.get_or_add_real(blk, "live_after", 0.0)
            spline = 1 if pin.get_or_add_str(blk, "stype", "spline") == "spline" else 0
            nid = max(parts.keys(), default=0) + 1
            for row in _loadtxt(pin.get_str(blk, "input_file")):
                q, a, e, inc, f, o, O, sft = row[:8]
                p = ParticleParams(m=q, rs=sft, racc=sft, couple=couple,
                                   live=live, live_after=live_after,
                                   spline=spline, init=1)
                opt = row[8:]
                p.gamma = opt[0] if len(opt) > 0 else 0.0
                p.beta = opt[1] if len(opt) > 1 else 0.0
                p.target_rad = opt[2] if len(opt) > 2 else 0.0
                p.radius = opt[3] if len(opt) > 3 else 0.0
                rb, vb = _init_orbit(G * 1.0, a, e, math.radians(inc),
                                     math.radians(o), math.radians(O),
                                     math.radians(f))
                p.x, p.y, p.z = rb
                p.vx, p.vy, p.vz = vb
                parts[nid] = p
                nid += 1
            continue
        # inline planet on a Kepler orbit around the running total mass
        m = pin.get_real(blk, "mass")
        a = pin.get_real(blk, "a")
        e = pin.get_or_add_real(blk, "e", 0.0)
        inc = math.radians(pin.get_or_add_real(blk, "i", 0.0))
        f = math.radians(pin.get_or_add_real(blk, "f", 180.0))
        rs = pin.get_or_add_real(blk, "rsoft", 0.0)
        racc = pin.get_or_add_real(blk, "rsink", 0.0)
        gamma = pin.get_or_add_real(blk, "gamma", 0.0)
        beta = pin.get_or_add_real(blk, "beta", 0.0)
        target_rad = pin.get_or_add_real(blk, "refine_distance", 0.0)
        mtot_sys = sum(p.m for p in parts.values()) + m
        rb, vb = _init_orbit(G * mtot_sys, a, e, inc, 0.0, 0.0, f)
        p = ParticleParams(m=m, rs=rs, spline=1, racc=racc, gamma=gamma, beta=beta,
                           couple=couple, init=1, target_rad=target_rad)
        p.x, p.y, p.z = rb
        p.vx, p.vy, p.vz = vb
        parts[max(parts.keys(), default=0) + 1] = p

    for p in parts.values():
        if not p.init and (p.x, p.y, p.z, p.vx, p.vy, p.vz) == (0,) * 6:
            p.init = 1
    mtot = sum(p.m for p in parts.values())
    # normalize: total mass → <gravity/nbody> mtot, barycenter → origin
    # (NBodySetup, nbody_setup.cpp:690-714)
    com_r = np.zeros(3)
    com_v = np.zeros(3)
    for p in parts.values():
        com_r += p.m * np.array([p.x, p.y, p.z]) / mtot
        com_v += p.m * np.array([p.vx, p.vy, p.vz]) / mtot
    for p in parts.values():
        p.x, p.y, p.z = np.array([p.x, p.y, p.z]) - com_r
        p.vx, p.vy, p.vz = np.array([p.vx, p.vy, p.vz]) - com_v
    if mtot_in > 0:
        fac = mtot_in / mtot
        for p in parts.values():
            p.m *= fac
        mtot = mtot_in
    return parts, mtot


class NBodySystem:
    """Replicated particle system + stage-coupling state."""

    def __init__(self, pin, constants, omf: float = 0.0):
        self.G = constants.G_code
        self.integrator = pin.get_or_add_str("nbody", "integrator", "ias15")
        if self.integrator not in INTEGRATORS:
            raise ValueError(f"unknown nbody integrator {self.integrator}")
        self.itype = INTEGRATORS[self.integrator]
        self.dt_reb = pin.get_or_add_real("nbody", "dt", 1e300)
        if pin.exists("nbody", "dt_reb"):
            self.dt_reb = pin.get_real("nbody", "dt_reb")
        self.mscale = pin.get_or_add_real("nbody", "mscale", 1.0)
        self.epsilon = pin.get_or_add_real("nbody", "epsilon", 1.0e-9)
        mtot_in = pin.get_or_add_real("nbody", "mtot", -1e300)
        self.pn = int(pin.get_or_add_real("nbody", "pn", 0))
        self.pn2 = pin.get_or_add_int("nbody", "pn2_corr", 1)
        self.c_code = constants.c_code
        self.merge_on_collision = pin.get_or_add_bool("nbody", "merge_on_collision", True)
        # rebound open-boundary box (nbody.cpp:161,197-198): particles that
        # leave the box of width box_size centered on the origin are removed
        self.box_size = pin.get_or_add_real("nbody", "box_size", 1.0e300)

        parts, mtot = setup_particles(pin, self.G, max(mtot_in, -1.0))
        self.mtot = mtot
        self.gm = self.G * mtot

        # frame offsets (shearing-box global frame; nbody.cpp:95-110)
        global_frame = pin.get_or_add_str("nbody", "frame", "global") == "global"
        qshear = pin.get_or_add_real("rotating_frame", "qshear", 0.0)
        self.frame_correction = global_frame
        self.omf = omf if global_frame else 0.0
        self.Rf = np.zeros(3)
        self.Vf = np.zeros(3)
        if global_frame and omf != 0.0 and qshear != 0.0:
            R0 = (self.G * mtot / omf**2) ** (1.0 / 3.0)
            self.Rf[0] = R0
            self.Vf[1] = R0 * omf

        ids = sorted(parts.keys())
        self.npart = len(ids)
        n = self.npart
        self.ids = ids
        self.m = np.array([parts[i].m for i in ids])
        self.pos = np.array([[parts[i].x, parts[i].y, parts[i].z] for i in ids])
        self.vel = np.array([[parts[i].vx, parts[i].vy, parts[i].vz] for i in ids])
        self.radius = np.array([parts[i].radius for i in ids])
        self.alive = np.ones(n, dtype=np.int32)
        self.rs = np.array([parts[i].rs for i in ids])
        self.spline = np.array([parts[i].spline for i in ids])
        self.racc = np.array([parts[i].racc for i in ids])
        self.sink_gamma = np.array([parts[i].gamma for i in ids])
        self.sink_beta = np.array([parts[i].beta for i in ids])
        self.couple = np.array([parts[i].couple for i in ids])
        self.live = np.array([parts[i].live & parts[i].couple for i in ids])
        self.live_after = np.array([parts[i].live_after for i in ids])
        self.target_rad = np.array([parts[i].target_rad for i in ids])

        # stage-coupling force state [npart, 7]
        self.pforce_step = np.zeros((n, 7))
        self.pforce_tot = np.zeros((n, 7))

        # copy-sim state for intermediate stages (master = .pos/.vel/.m)
        self._step_start = None
        self._output_count = 0
        self._orb_counts: Dict[tuple, int] = {}

    # ------------------------------------------------------------------
    def particle_pytree(self, device, dtype):
        """The per-stage particle inputs of the gravity and cooling
        sources, as tensors on the run's device."""
        import torch

        def t(a):
            # a copy: the native integrator later writes the arrays in place
            return torch.tensor(a, dtype=dtype, device=device)

        return {"gm": t(self.G * self.m * self.alive), "pos": t(self.pos),
                "vel": t(self.vel)}

    def begin_step(self):
        self._step_start = (self.m.copy(), self.pos.copy(), self.vel.copy(),
                            self.radius.copy(), self.alive.copy())

    def advance(self, pforce, stage: int, nstages: int, time: float,
                coeffs) -> None:
        """One coupling stage (cf. NBody::Advance, nbody_advance.cpp:85-208).

        ``pforce`` [npart, 7]: grid forces accumulated over this stage.
        ``coeffs``: the derived nbody coupling integrator (gam0, gam1, beta).
        """
        gam0 = coeffs.gam0[stage - 1]
        gam1 = coeffs.gam1[stage - 1]
        dt_stage = coeffs.beta[stage - 1] * coeffs.dt

        self.pforce_step = gam0 * self.pforce_step + gam1 * np.asarray(pforce)

        if stage < nstages:
            m, pos, vel, radius, alive = [a.copy() for a in self._step_start]
        else:
            m, pos, vel, radius, alive = (self.m, self.pos, self.vel,
                                          self.radius, self.alive)

        # gas-force kick on live particles
        if self.itype != 2:
            for k in range(self.npart):
                if alive[k] and self.live[k] and time >= self.live_after[k]:
                    mp = m[k]
                    if mp > 0:
                        vel[k] += (self.mscale * dt_stage
                                   * self.pforce_step[k, 1:4] / mp)

            merges = _lib().nb_integrate(
                self.npart,
                np.ctypeslib.as_ctypes(m),
                np.ctypeslib.as_ctypes(pos.reshape(-1)),
                np.ctypeslib.as_ctypes(vel.reshape(-1)),
                np.ctypeslib.as_ctypes(radius),
                np.ctypeslib.as_ctypes(alive),
                ctypes.c_double(time),
                ctypes.c_double(time + dt_stage),
                ctypes.c_double(self.dt_reb if self.dt_reb < 1e290 else -1.0),
                ctypes.c_int(self.itype),
                ctypes.c_double(self.G),
                ctypes.c_int(self.pn),
                ctypes.c_double(self.c_code),
                ctypes.c_int(self.pn2),
                ctypes.c_int(1 if self.merge_on_collision else 0),
                ctypes.c_double(self.epsilon),
            )

        # rotating-frame correction (nbody_advance.cpp:173-178)
        if self.omf != 0.0 and self.itype != 2:
            _lib().nb_rotate_z(self.npart,
                               np.ctypeslib.as_ctypes(pos.reshape(-1)),
                               np.ctypeslib.as_ctypes(vel.reshape(-1)),
                               ctypes.c_double(-self.omf * dt_stage))

        # sync back (SyncWithRebound equivalent)
        self.pos = pos
        self.vel = vel
        self.m = m
        self.radius = radius
        self.alive = alive
        # open-boundary escape (REB_BOUNDARY_OPEN, nbody.cpp:197-198):
        # drop particles outside the box of width box_size
        if self.box_size < 1.0e300:
            escaped = (np.abs(self.pos) > 0.5 * self.box_size).any(axis=1)
            self.alive = np.where(escaped, 0, self.alive).astype(np.int32)
        dead = self.alive == 0
        self.couple = np.where(dead, 0, self.couple)
        self.live = np.where(dead, 0, self.live)

        if stage == nstages:
            self.pforce_tot += dt_stage * self.pforce_step
            self.pforce_step[:] = 0.0

    # ------------------------------------------------------------------
    # outputs (cf. nbody_outputs.cpp:32-285; doc/src/physics.rst
    # "N-Body Outputs").  .reb: one row per particle per output (dead
    # particles included with active=0); .orb: one file per bound pair.
    # pforce_tot accumulates between outputs and is reset after each.
    REB_COLS = ("time", "hash", "active", "mass", "x", "y", "z",
                "vx", "vy", "vz", "dm", "dmx_g", "dmy_g", "dmz_g",
                "dmx_a", "dmy_a", "dmz_a")
    ORB_COLS = ("time", "mb", "xc", "yc", "zc", "xb", "yb", "zb",
                "vxc", "vyc", "vzc", "vxb", "vyb", "vzb", "qb", "nb",
                "ab", "eb", "Ib", "o", "O", "pomega", "f", "h",
                "ex", "ey", "ix", "iy", "dm",
                "Fx_grav_com", "Fy_grav_com", "Fz_grav_com",
                "Fx_acc_com", "Fy_acc_com", "Fz_acc_com",
                "Fx_grav_bin", "Fy_grav_bin", "Fz_grav_bin",
                "Fx_acc_bin", "Fy_acc_bin", "Fz_acc_bin")

    def write_outputs(self, data_dir: str, problem_id: str, time: float):
        base = os.path.join(data_dir, problem_id)
        new = self._output_count == 0
        with open(base + ".reb", "w" if new else "a") as f:
            if new:
                f.write(f"# NBody data N = {self.npart}\n")
                f.write("# " + "    ".join(
                    f"[{i + 1}]={c}"
                    for i, c in enumerate(self.REB_COLS)) + "    \n")
            for k in range(self.npart):
                row = [time, float(self.ids[k]), float(self.alive[k]),
                       self.G * self.m[k], *self.pos[k], *self.vel[k],
                       *self.pforce_tot[k]]
                f.write("\t".join(
                    str(int(v)) if 1 <= i <= 2 else f"{v:.8e}"
                    for i, v in enumerate(row)) + "\t\n")
        # per-pair orbit files for bound pairs
        for i in range(self.npart):
            for j in range(i + 1, self.npart):
                if not (self.alive[i] and self.alive[j]):
                    continue
                m1, m2 = self.G * self.m[i], self.G * self.m[j]
                mb = m1 + m2
                dr = self.pos[j] - self.pos[i]
                dv = self.vel[j] - self.vel[i]
                r = float(np.linalg.norm(dr))
                if 0.5 * float(dv @ dv) - mb / (r + 1e-300) >= 0.0:
                    continue  # unbound
                # primary = heavier particle; orbit of secondary about it
                ip, is_ = (i, j) if m1 >= m2 else (j, i)
                mp_, ms = max(m1, m2), min(m1, m2)
                el = orbital_elements(mb, self.pos[is_] - self.pos[ip],
                                      self.vel[is_] - self.vel[ip])
                if el is None:
                    continue
                a, e, inc, omega, Omega, ff = el
                pomega = omega + Omega
                hvec = np.cross(self.pos[is_] - self.pos[ip],
                                self.vel[is_] - self.vel[ip])
                mu1, mu2 = mp_ / mb, ms / mb
                F = self.pforce_tot
                row = [time, mb,
                       *(mu1 * self.pos[ip] + mu2 * self.pos[is_]),
                       *(self.pos[is_] + self.pos[ip]),
                       *(mu1 * self.vel[ip] + mu2 * self.vel[is_]),
                       *(self.vel[is_] + self.vel[ip]),
                       ms / mp_, math.sqrt(mb / a**3), a, e, inc,
                       omega, Omega, pomega, ff,
                       float(np.linalg.norm(hvec)),
                       e * math.cos(pomega), e * math.sin(pomega),
                       2 * math.sin(inc / 2) * math.cos(Omega),
                       2 * math.sin(inc / 2) * math.sin(Omega),
                       F[ip, 0] + F[is_, 0],
                       *(F[ip, 1:4] + F[is_, 1:4]),
                       *(F[ip, 4:7] + F[is_, 4:7]),
                       *(mu1 * F[is_, 1:4] - mu2 * F[ip, 1:4]),
                       *(mu1 * F[is_, 4:7] - mu2 * F[ip, 4:7])]
                fname = f"{base}.{i}_{j}.orb"
                first = (i, j) not in self._orb_counts
                self._orb_counts[(i, j)] = self._orb_counts.get((i, j), 0) + 1
                with open(fname, "w" if first else "a") as f:
                    if first:
                        f.write("# NBody Orbit data\n")
                        f.write("# " + "     ".join(
                            f"[{k + 1}]={c}"
                            for k, c in enumerate(self.ORB_COLS)) + "   \n")
                    f.write("\t".join(f"{v:.8e}" for v in row) + "\t\n")
        self.pforce_tot[:] = 0.0
        self._output_count += 1

    # restart payload --------------------------------------------------
    def restart_payload(self):
        return np.concatenate([
            self.m, self.radius, self.alive.astype(np.float64),
            self.pos.reshape(-1), self.vel.reshape(-1),
            self.pforce_step.reshape(-1), self.pforce_tot.reshape(-1),
        ])

    def load_restart(self, payload: np.ndarray):
        n = self.npart
        o = 0
        self.m = payload[o:o + n].copy(); o += n
        self.radius = payload[o:o + n].copy(); o += n
        self.alive = payload[o:o + n].astype(np.int32); o += n
        self.pos = payload[o:o + 3 * n].reshape(n, 3).copy(); o += 3 * n
        self.vel = payload[o:o + 3 * n].reshape(n, 3).copy(); o += 3 * n
        self.pforce_step = payload[o:o + 7 * n].reshape(n, 7).copy(); o += 7 * n
        self.pforce_tot = payload[o:o + 7 * n].reshape(n, 7).copy()


def orbital_elements(gm, dr, dv):
    """(a, e, i, omega, Omega, f) of a bound relative orbit; None if unbound."""
    r = float(np.linalg.norm(dr))
    v2 = float(dv @ dv)
    E = 0.5 * v2 - gm / r
    if E >= 0.0 or r == 0.0:
        return None
    a = -gm / (2.0 * E)
    hvec = np.cross(dr, dv)
    h = np.linalg.norm(hvec)
    evec = np.cross(dv, hvec) / gm - dr / r
    e = float(np.linalg.norm(evec))
    inc = math.acos(max(-1.0, min(1.0, hvec[2] / (h + 1e-300))))
    nvec = np.array([-hvec[1], hvec[0], 0.0])
    nn = np.linalg.norm(nvec)
    Omega = math.atan2(nvec[1], nvec[0]) if nn > 0 else 0.0
    if e > 1e-12 and nn > 0:
        omega = math.acos(max(-1.0, min(1.0, float(nvec @ evec) / (nn * e))))
        if evec[2] < 0:
            omega = 2 * math.pi - omega
    else:
        omega = 0.0
    if e > 1e-12:
        f = math.acos(max(-1.0, min(1.0, float(evec @ dr) / (e * r))))
        if float(dr @ dv) < 0:
            f = 2 * math.pi - f
    else:
        f = math.atan2(dr[1], dr[0])
    return (a, e, inc, omega, Omega, f)
