"""External source terms: gravity and the rotating frame (port of
``artemis_tpu/sources.py``).

Rebuild of the reference source packages (src/gravity/, src/rotating_frame/;
SURVEY.md §2.4).  Each source is a small object holding its precomputed
interior coordinate fields as tensors on the run's device, in the run's
dtype, and an ``apply(state, fluxes, time, dt, hyd) -> state`` method; the
driver applies them in the reference task order gravity -> rotating_frame
-> drag -> cooling (artemis_driver.cpp:224-248).  ``time`` is a host float
(the port's loop keeps it on the host), ``dt`` the stage's beta*dt tensor.

Beta cooling, drag/damping and N-body gravity are not ported yet: their
classes raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import geometry as geo

# "always on" sentinel for tstart/tstop windows (reference Big<Real>())
BIG = 1.0e38


class SourceBase:
    """A source term; ``place`` moves its precomputed fields to the run's
    device and dtype once, before the first stage."""

    def place(self, device, dtype):
        self.device, self.dtype = torch.device(device), dtype
        return self

    def _t(self, a):
        return torch.as_tensor(np.array(a), dtype=self.dtype, device=self.device)

    def apply(self, state, fluxes, time, dt, hyd):  # pragma: no cover
        raise NotImplementedError


# ----------------------------------------------------------------------------
# Gravity (src/gravity/)
# ----------------------------------------------------------------------------
class Gravity(SourceBase):
    """External gravity: uniform | point | binary (gravity.cpp:28-160).

    Point-mass accelerations are a static field; the binary's are
    recomputed each stage from its analytic orbit.  Momentum kick:
    dm_i = dt rho hx_i g_i; gas total energy gains dt rho v.g; point-mass
    sinks remove mass/momentum/energy with a quadratic ramp
    (point_mass.cpp:135-195).
    """

    def __init__(self, pin, grid, constants):
        self.grid = grid
        self.tstart = pin.get_or_add_real("gravity", "tstart", -BIG)
        self.tstop = pin.get_or_add_real("gravity", "tstop", BIG)
        gtypes = [b for b in ("gravity/uniform", "gravity/point", "gravity/binary")
                  if pin.has_block(b)]
        if len(gtypes) != 1:
            raise ValueError("artemis only supports exactly 1 gravity type")
        self.gtype = gtypes[0].split("/")[1]
        x1v, x2v, x3v = grid.cell_centers()
        shape = tuple(reversed(grid.nx))
        self.shape = shape

        if self.gtype == "uniform":
            self.g = (pin.get_or_add_real("gravity/uniform", "gx1", 0.0),
                      pin.get_or_add_real("gravity/uniform", "gx2", 0.0),
                      pin.get_or_add_real("gravity/uniform", "gx3", 0.0))
        elif self.gtype == "point":
            blk = "gravity/point"
            gm = pin.get_or_add_real(blk, "gm", None) if pin.exists(blk, "gm") else None
            if gm is None:
                mass = pin.get_or_add_real(blk, "mass", 1.0)
                gm = constants.G_code * mass
            self.gm = gm
            self.sink_rate = pin.get_or_add_real(blk, "sink_rate", 0.0)
            self.sink_rad = pin.get_or_add_real(blk, "sink", 0.0)
            self.soft2 = pin.get_or_add_real(blk, "soft", 0.0) ** 2
            pos = (pin.get_or_add_real(blk, "x", 0.0),
                   pin.get_or_add_real(blk, "y", 0.0),
                   pin.get_or_add_real(blk, "z", 0.0))
            self.pos = pos
            self._point_accel(grid, x1v, x2v, x3v, pos)
        else:  # binary
            blk = "gravity/binary"
            mtot = pin.get_or_add_real(blk, "total_mass", 1.0)
            self.gm = constants.G_code * mtot
            self.qbin = pin.get_real(blk, "q")
            self.sink1 = pin.get_or_add_real(blk, "sink1", 0.0)
            self.sink2 = pin.get_or_add_real(blk, "sink2", 0.0)
            self.sink_rate1 = pin.get_or_add_real(blk, "sink_rate1", 0.0)
            self.sink_rate2 = pin.get_or_add_real(blk, "sink_rate2", 0.0)
            self.soft2_1 = pin.get_or_add_real(blk, "soft1", 0.0) ** 2
            self.soft2_2 = pin.get_or_add_real(blk, "soft2", 0.0) ** 2
            self.orbit = Orbit(
                self.gm,
                pin.get_real(blk, "a"),
                pin.get_or_add_real(blk, "e", 0.0),
                math.radians(pin.get_or_add_real(blk, "i", 0.0)),
                math.radians(pin.get_or_add_real(blk, "omega", 0.0)),
                math.radians(pin.get_or_add_real(blk, "Omega", 0.0)),
                math.radians(pin.get_or_add_real(blk, "f", 180.0)),
            )
            self.omf = 0.0  # set by simulation when a rotating frame is on
            # cartesian cell positions + basis rows for on-the-fly binary force
            cx, cy, cz = geo.convert_to_cart(grid.coords, x1v, x2v, x3v)
            self.cart = tuple(np.broadcast_to(c, shape) for c in (cx, cy, cz))
            self.ex = geo.vec_to_cart(grid.coords, x1v, x2v, x3v)

    def place(self, device, dtype):
        super().place(device, dtype)
        if self.gtype == "point":
            self._gvec = [self._t(g) for g in self.gvec]
            self._dr = self._t(self.dr)
        elif self.gtype == "binary":
            self._cart = [self._t(c) for c in self.cart]
            self._ex = [[self._t(np.broadcast_to(self.ex[d][m], self.shape))
                         for m in range(3)] for d in range(3)]
        return self

    # -- helpers --------------------------------------------------------
    def _point_accel(self, grid, x1v, x2v, x3v, pos):
        """Static point-mass acceleration field (point_mass.cpp:70-130)."""
        c = grid.coords
        shape = self.shape
        if geo.is_axisymmetric(c) and geo.is_spherical(c):
            rad2 = x1v**2 + self.soft2
            g = -self.gm / rad2
            gx1, gx2, gx3 = g, 0.0 * g, 0.0 * g
            dr = np.sqrt(rad2)
            gx1 = np.broadcast_to(gx1, shape)
            gx2 = np.broadcast_to(gx2, shape)
            gx3 = np.broadcast_to(gx3, shape)
        elif c == "axisymmetric":
            r, th, _ = geo.convert_to_sph(c, x1v, x2v, x3v)
            rad2 = r**2 + self.soft2
            g = -self.gm / rad2
            # \hat r components along (R, z): (sin th, cos th)
            gx1 = np.broadcast_to(g * np.sin(th), shape)
            gx2 = np.broadcast_to(g * np.cos(th), shape)
            gx3 = np.zeros(shape)
            dr = r
        else:
            cx, cy, cz = geo.convert_to_cart(c, x1v, x2v, x3v)
            dx = cx - pos[0]
            dy = cy - pos[1]
            dz = cz - pos[2]
            dr = np.sqrt(dx * dx + dy * dy + dz * dz)
            rad2 = dr**2 + self.soft2
            idr3 = 1.0 / (np.sqrt(rad2) * rad2)
            multi_d = 1.0 if self.grid.active(2) else 0.0
            three_d = 1.0 if self.grid.active(3) else 0.0
            g = (-self.gm * dx * idr3, -self.gm * dy * idr3 * multi_d,
                 -self.gm * dz * idr3 * three_d)
            ex1, ex2, ex3 = geo.vec_to_cart(c, x1v, x2v, x3v)
            gx1 = np.broadcast_to(sum(g[m] * ex1[m] for m in range(3)), shape)
            gx2 = np.broadcast_to(sum(g[m] * ex2[m] for m in range(3)), shape)
            gx3 = np.broadcast_to(sum(g[m] * ex3[m] for m in range(3)), shape)
        self.gvec = (np.ascontiguousarray(gx1), np.ascontiguousarray(gx2),
                     np.ascontiguousarray(gx3))
        self.dr = np.ascontiguousarray(np.broadcast_to(dr, shape))

    @staticmethod
    def _sink_frac(dt, dr, sink_rate, sink_rad):
        """Fractional mass removal this step (point_mass.cpp:160-180)."""
        if sink_rate <= 0.0 or sink_rad <= 0.0:
            return None
        x = (dr - sink_rad) / sink_rad
        sramp = dt * sink_rate * (x * x)
        fd = torch.clamp(sramp / (1.0 + sramp), max=0.5)
        return torch.where(dr <= sink_rad, fd, torch.zeros_like(fd))

    @staticmethod
    def _kick(state, dt, gvec, hyd, fd=None):
        hx = hyd.hxv_int
        new = dict(state)
        for name in ("gas", "dust"):
            if name not in state:
                continue
            u, w = state[name]["u"].clone(), state[name]["w"]
            rho = w[:, 0]
            rdt = dt * rho
            u[:, 1] += rdt * hx[0] * gvec[0]
            u[:, 2] += rdt * hx[1] * gvec[1]
            u[:, 3] += rdt * hx[2] * gvec[2]
            if name == "gas":
                u[:, 4] += rdt * (w[:, 1] * gvec[0] + w[:, 2] * gvec[1] + w[:, 3] * gvec[2])
            if fd is not None:
                v1, v2, v3 = w[:, 1], w[:, 2], w[:, 3]
                u[:, 0] += -fd * rho
                u[:, 1] += -fd * hx[0] * rho * v1
                u[:, 2] += -fd * hx[1] * rho * v2
                u[:, 3] += -fd * hx[2] * rho * v3
                if name == "gas":
                    tote = rho * (w[:, 5] + 0.5 * (v1**2 + v2**2 + v3**2))
                    u[:, 4] += -fd * tote
            new[name] = {"u": u, "w": w}
        return new

    def active(self, time: float) -> bool:
        """The tstart/tstop window (gravity.cpp:35-37,141)."""
        return self.tstart <= time < self.tstop

    def apply(self, state, fluxes, time, dt, hyd):
        dt_eff = dt if self.active(time) else dt * 0.0
        if self.gtype == "uniform":
            g = [torch.full(self.shape, gi, dtype=self.dtype, device=self.device)
                 for gi in self.g]
            return self._kick(state, dt_eff, g, hyd)
        if self.gtype == "point":
            fd = self._sink_frac(dt_eff, self._dr, self.sink_rate, self.sink_rad)
            return self._kick(state, dt_eff, self._gvec, hyd, fd)
        # binary: two softened point masses on an analytic orbit
        pos, _ = self.orbit.solve(time, self.omf)
        m2frac = self.qbin / (1.0 + self.qbin)
        m1frac = 1.0 / (1.0 + self.qbin)
        # primary at -m2frac*pos, secondary at +m1frac*pos (center of mass at 0)
        cx, cy, cz = self._cart
        gx = [0.0, 0.0, 0.0]
        fd_tot = None
        for (mfrac, off, soft2, s_rad, s_rate) in (
            (m1frac, [-m2frac * p for p in pos], self.soft2_1, self.sink1,
             self.sink_rate1),
            (m2frac, [m1frac * p for p in pos], self.soft2_2, self.sink2,
             self.sink_rate2),
        ):
            dx, dy, dz = cx - off[0], cy - off[1], cz - off[2]
            dr = torch.sqrt(dx * dx + dy * dy + dz * dz)
            rad2 = dr * dr + soft2
            idr3 = 1.0 / (torch.sqrt(rad2) * rad2)
            gm = self.gm * mfrac
            gc = (-gm * dx * idr3, -gm * dy * idr3, -gm * dz * idr3)
            for d in range(3):
                gx[d] = gx[d] + sum(gc[m] * self._ex[d][m] for m in range(3))
            fd = self._sink_frac(dt_eff, dr, s_rate, s_rad)
            if fd is not None:
                fd_tot = fd if fd_tot is None else fd_tot + fd
        return self._kick(state, dt_eff, gx, hyd, fd_tot)


class Orbit:
    """Analytic Kepler orbit (cf. Gravity::Orbit, gravity.hpp:30-94); host
    floats, since the port's time lives on the host."""

    def __init__(self, gm, a, e, i, o, O, f0):
        self.a, self.e = a, e
        self.n = math.sqrt(gm / a**3)
        self.coso, self.sino = math.cos(o), math.sin(o)
        self.cosI, self.sinI = math.cos(i), math.sin(i)
        self.cosO, self.sinO = math.cos(O), math.sin(O)
        self.cosf0, self.sinf0 = math.cos(f0), math.sin(f0)

    def solve(self, t, omf=0.0):
        sint = math.sin(t * (self.n - omf))
        cost = math.cos(t * (self.n - omf))
        cosf = self.cosf0 * cost - self.sinf0 * sint
        sinf = self.cosf0 * sint + self.sinf0 * cost
        vb = self.a * self.n / math.sqrt(1.0 - self.e**2)
        rb = self.a * (1.0 - self.e**2) / (1.0 + self.e * cosf)
        xb, yb = rb * cosf, rb * sinf
        vxb, vyb = -sinf * vb, (cosf + self.e) * vb
        cf = xb * self.coso - self.sino * yb
        sf = xb * self.sino + self.coso * yb
        pos = (self.cosO * cf - self.sinO * sf * self.cosI,
               self.sinO * cf + self.cosO * sf * self.cosI,
               sf * self.sinI)
        cf = vxb * self.coso - self.sino * vyb
        sf = vxb * self.sino + self.coso * vyb
        vel = (self.cosO * cf - self.sinO * sf * self.cosI,
               self.sinO * cf + self.cosO * sf * self.cosI,
               sf * self.sinI)
        return pos, vel


# ----------------------------------------------------------------------------
# Rotating frame (src/rotating_frame/)
# ----------------------------------------------------------------------------
class RotatingFrame(SourceBase):
    """Shearing-box forces in Cartesian; conservative azimuthal-momentum
    torque + centrifugal energy in curvilinear systems
    (rotating_frame_impl.hpp:28-170)."""

    uses_fluxes = True  # curvilinear torque consumes the stage mass fluxes

    def __init__(self, pin, grid):
        self.grid = grid
        self.omega = pin.get_or_add_real("rotating_frame", "omega", 0.0)
        self.qshear = pin.get_or_add_real("rotating_frame", "qshear", 0.0)
        c = grid.coords
        self.shearing_box = geo.is_cartesian(c)
        shape = tuple(reversed(grid.nx))
        x1v, x2v, x3v = grid.cell_centers()
        if self.shearing_box:
            # tidal potential gradients from face values (impl.hpp:49-60)
            s3, s2, s1 = grid.int_slices
            g = grid.geom
            x1m, x1p = g.xf1[s1][None, None, :], g.xf1[s1.start + 1:s1.stop + 1][None, None, :]
            x3m = g.xf3[s3][:, None, None]
            x3p = g.xf3[s3.start + 1:s3.stop + 1][:, None, None]
            om2 = self.omega**2
            dpx = (-self.qshear * om2 * (x1p**2 - x1m**2)) / (x1p - x1m)
            dpz = (0.5 * om2 * (x3p**2 - x3m**2)) / (x3p - x3m) \
                if grid.active(3) else np.zeros((1, 1, 1))
            self.dpx = np.broadcast_to(dpx, shape)
            self.dpz = np.broadcast_to(dpz, shape)
        else:
            xcyl = geo.convert_to_cyl(c, x1v, x2v, x3v)
            self.Rcyl = np.broadcast_to(xcyl[0], shape)
            ex1, ex2, ex3 = geo.vec_to_cyl(c, x1v, x2v, x3v)
            # phi-hat and R-hat components of each problem basis vector
            self.phihat = [np.broadcast_to(e[1], shape) for e in (ex1, ex2, ex3)]
            self.rhat = [np.broadcast_to(e[0], shape) for e in (ex1, ex2, ex3)]
            self.rfw = _rf_weights(grid)

    def place(self, device, dtype):
        super().place(device, dtype)
        if self.shearing_box:
            self._dpx, self._dpz = self._t(self.dpx), self._t(self.dpz)
        else:
            self._Rcyl = self._t(self.Rcyl)
            self._phihat = [self._t(a) for a in self.phihat]
            self._rhat = [self._t(a) for a in self.rhat]
            self._rfw = {d: (self._t(lo), self._t(hi)) for d, (lo, hi) in self.rfw.items()}
        return self

    def apply(self, state, fluxes, time, dt, hyd):
        if self.shearing_box:
            return self._shearing_box(state, dt, hyd)
        return self._curvilinear(state, fluxes, dt, hyd)

    def _shearing_box(self, state, dt, hyd):
        om0 = self.omega
        dpx, dpz = self._dpx, self._dpz
        new = dict(state)
        for name in ("gas", "dust"):
            if name not in state:
                continue
            u, w = state[name]["u"].clone(), state[name]["w"]
            rho, v1, v2, v3 = w[:, 0], w[:, 1], w[:, 2], w[:, 3]
            rdt = rho * dt
            u[:, 1] += -rdt * (dpx - 2.0 * om0 * v2)
            u[:, 2] += -rdt * 2.0 * om0 * v1
            u[:, 3] += -rdt * dpz
            if name == "gas":
                u[:, 4] += -rdt * (v1 * dpx + v3 * dpz)
            new[name] = {"u": u, "w": w}
        return new

    def _curvilinear(self, state, fluxes, dt, hyd):
        """Conservative torque from mass-flux divergence weighted by
        +/-(<R^2>_pm - <R^2>) (rotating_frame_impl.hpp:96-170)."""
        om0 = self.omega
        omdt = om0 * dt
        om2dt = omdt * om0
        vol = hyd.vol
        new = dict(state)
        for name in ("gas", "dust"):
            if name not in state:
                continue
            u, w = state[name]["u"].clone(), state[name]["w"]
            divf = 0.0
            favg = [0.0, 0.0, 0.0]
            for d in hyd.dims:
                F = fluxes[name][d][0][:, 0]  # mass flux on interior faces
                A = hyd.area[d]
                blo, bhi = self._rfw[d]
                lo = hyd._dfaces(A * F, d, 0)
                hi = hyd._dfaces(A * F, d, 1)
                divf = divf + lo * blo + hi * bhi
                favg[d - 1] = 0.5 * (hyd._dfaces(F, d, 0) + hyd._dfaces(F, d, 1))
            for c in range(3):
                u[:, 1 + c] += -omdt * (divf / vol) * self._phihat[c]
            if name == "gas":
                fdotr = sum(favg[c] * self._rhat[c] for c in range(3))
                u[:, 4] += om2dt * self._Rcyl * fdotr
            new[name] = {"u": u, "w": w}
        return new


def _rf_weights(grid):
    """Per-axis (lower, upper) flux weights +/-(<R^2>_pm - <R^2>)
    (cf. RFWeights in src/geometry/*.hpp), interior-shaped numpy."""
    g = grid.geom
    s3, s2, s1 = grid.int_slices
    shape = tuple(reversed(grid.nx))
    c = grid.coords
    zero = np.zeros(shape)
    out = {1: (zero, zero), 2: (zero, zero), 3: (zero, zero)}
    if c in ("cylindrical", "axisymmetric"):
        rm = g.xf1[s1][None, None, :]
        rp = g.xf1[s1.start + 1:s1.stop + 1][None, None, :]
        ans = 0.5 * (rm + rp) * (rp - rm)
        out[1] = (np.broadcast_to(ans, shape), np.broadcast_to(ans, shape))
    elif c == "spherical1D":
        rv = g.xv1[s1][None, None, :]
        rm = g.xf1[s1][None, None, :]
        rp = g.xf1[s1.start + 1:s1.stop + 1][None, None, :]
        out[1] = (np.broadcast_to(rv**2 - rm**2, shape),
                  np.broadcast_to(rp**2 - rv**2, shape))
    elif c in ("spherical2D", "spherical3D"):
        rv = g.xv1[s1][None, None, :]
        rm = g.xf1[s1][None, None, :]
        rp = g.xf1[s1.start + 1:s1.stop + 1][None, None, :]
        stv = np.sin(g.xv2[s2])[None, :, None]
        r1m, r1p = g.xf1[s1], g.xf1[s1.start + 1:s1.stop + 1]
        rface = (2.0 / 3.0 * (r1m**2 + r1m * r1p + r1p**2) / (r1m + r1p))[None, None, :]
        stm = np.sin(g.xf2[s2])[None, :, None]
        stp = np.sin(g.xf2[s2.start + 1:s2.stop + 1])[None, :, None]
        r2cyl = (rv * stv) ** 2
        out[1] = (np.broadcast_to(r2cyl - (rm * stv) ** 2, shape),
                  np.broadcast_to((rp * stv) ** 2 - r2cyl, shape))
        out[2] = (np.broadcast_to(r2cyl - (rface * stm) ** 2, shape),
                  np.broadcast_to((rface * stp) ** 2 - r2cyl, shape))
    return {d: (np.ascontiguousarray(a), np.ascontiguousarray(b))
            for d, (a, b) in out.items()}


# ----------------------------------------------------------------------------
# not ported yet
# ----------------------------------------------------------------------------
class BetaCooling(SourceBase):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("beta cooling is not ported yet "
                                  "(ROADMAP Queue 1 item 6)")


class Drag(SourceBase):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("drag and damping are not ported yet "
                                  "(ROADMAP Queue 1 item 6)")


class NBodyGravity(SourceBase):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("N-body gravity is not ported yet "
                                  "(ROADMAP Queue 1 item 8)")


# ----------------------------------------------------------------------------
# assembly (cf. artemis.cpp ProcessPackages)
# ----------------------------------------------------------------------------
def sources_from_input(pin, grid, gas_cfg, dust_cfg, constants, nbody_sys=None):
    """Build the ordered source list from the deck's <physics> switches.
    The sources hold numpy fields until ``place`` moves them to a device."""
    srcs = []
    do_gravity = pin.get_or_add_bool("physics", "gravity", False)
    do_rotating = pin.get_or_add_bool("physics", "rotating_frame", False)
    do_cooling = pin.get_or_add_bool("physics", "cooling", False)
    do_drag = pin.get_or_add_bool("physics", "drag", False)
    omf = 0.0
    if do_rotating:
        omf = pin.get_or_add_real("rotating_frame", "omega", 0.0)

    gravity = None
    if do_gravity:
        if pin.has_block("gravity/nbody"):
            if nbody_sys is None:
                raise ValueError("<gravity/nbody> requires physics/nbody = true")
            gravity = NBodyGravity(pin, grid, nbody_sys, omf)
        else:
            gravity = Gravity(pin, grid, constants)
        srcs.append(gravity)
    if do_rotating:
        srcs.append(RotatingFrame(pin, grid))
    if do_drag:
        srcs.append(Drag(pin, grid, gas_cfg, dust_cfg))
    if do_cooling:
        gm = gravity.gm if (gravity is not None and hasattr(gravity, "gm")) else 1.0
        srcs.append(BetaCooling(pin, grid, gas_cfg, gm, cv=getattr(gas_cfg, "cv", None),
                                nbody_sys=nbody_sys))
    return srcs
