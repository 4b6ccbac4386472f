"""External source terms: gravity, the rotating frame, beta cooling, drag
and damping zones (port of ``artemis_tpu/sources.py``).

Rebuild of the reference source packages (src/gravity/, src/rotating_frame/,
src/gas/cooling/, src/drag/; SURVEY.md §2.4).  Each source is a small object
holding its precomputed interior coordinate fields as tensors on the run's
device, in the run's dtype, and an ``apply(state, fluxes, time, dt, hyd) ->
state`` method; the driver applies them in the reference task order gravity
-> rotating_frame -> drag -> cooling (artemis_driver.cpp:224-248).  ``time``
is a host float (the port's loop keeps it on the host), ``dt`` the stage's
beta*dt tensor.

Sources that read the N-body particles (``NBodyGravity``, and
``BetaCooling`` with ``tref = nbody``) set ``needs_ctx``: the driver passes
them ``ctx={"particles": ...}`` (the particles' gm, pos and vel as tensors
on the run's device), and ``NBodyGravity`` returns its ``[npart, 7]``
back-reaction rows in ``ctx["pforce"]``.
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
# Beta cooling (src/gas/cooling/)
# ----------------------------------------------------------------------------
def _idr1_soft(rs, spline, dr2):
    """Softened 1/r kernel (plummer or Gadget spline), literal replica of
    Particle::idr1 (particle_base.hpp:115-141)."""
    fz = 1e-300
    rs2 = rs * rs
    idr1_p = 1.0 / torch.sqrt(dr2 + rs2 + fz)
    if not spline:
        return idr1_p
    dr1 = torch.sqrt(dr2)
    hinv = 1.0 / (rs + fz)
    u2 = dr2 / (rs2 + fz)
    u = torch.sqrt(u2)
    u3, u4 = u * u2, u2 * u2
    u5 = u4 * u
    inner = torch.where(
        u < 0.5,
        hinv * (14.0 / 5.0 - 16.0 / 3.0 * u2 + 48.0 / 5.0 * u4 - 32.0 / 5.0 * u5),
        hinv * (16.0 / 5.0 - 32.0 / 3.0 * u2 + 16.0 * u3 - 48.0 / 5.0 * u4
                + 32.0 / 15.0 * u5 - 1.0 / (15.0 * u + fz)))
    return torch.where(dr2 >= rs2, 1.0 / (dr1 + fz), inner)


class BetaCooling(SourceBase):
    """Backward-Euler relaxation toward a reference temperature profile
    (beta_cooling.cpp:33-135): dE = -rho cv om dt/(beta + om dt) (T - T0),
    beta = beta_min + beta0 exp(-escale z^2 / T0), added to the total and
    the internal energy.

    tref=powerlaw: static T0 = tfloor + tcyl R^a + tsph r^b.
    tref=nbody (beta_cooling.cpp:92-104): 1/r proxy from the softened
    potential of all live particles, ir1 = -Phi_nbody/gm, then
    T0 = tfloor + tsph ir1^{-sph_plaw} and Omega = sqrt(gm ir1^3) —
    recomputed each stage from the particles in ``ctx``.
    """

    def __init__(self, pin, grid, gas_cfg, gm: float, cv: float = None,
                 nbody_sys=None):
        self.gas_cfg = gas_cfg
        self._cv = cv if cv is not None else 1.0 / (gas_cfg.gamma - 1.0)
        ctype = pin.get_str("cooling", "type")
        if ctype != "beta":
            raise ValueError("Unknown cooling type")
        self.beta0 = pin.get_real("cooling", "beta0")
        self.beta_min = pin.get_or_add_real("cooling", "beta_min", 1e-12)
        self.escale = pin.get_or_add_real("cooling", "exp_scale", 0.0)
        tref = pin.get_str("cooling", "tref")
        if tref not in ("powerlaw", "nbody"):
            raise ValueError(f"cooling tref {tref!r} not recognized")
        tfloor = pin.get_or_add_real("cooling", "tfloor", 0.0)
        tcyl = pin.get_or_add_real("cooling", "tcyl", 0.0)
        cyl_plaw = pin.get_or_add_real("cooling", "cyl_plaw", 0.0)
        tsph = pin.get_or_add_real("cooling", "tsph", 0.0)
        sph_plaw = pin.get_or_add_real("cooling", "sph_plaw", 0.0)
        self.gm = gm
        self.tref = tref

        shape = tuple(reversed(grid.nx))
        x1v, x2v, x3v = grid.cell_centers()
        xcyl = geo.convert_to_cyl(grid.coords, x1v, x2v, x3v)
        Rcyl, zcyl = xcyl[0], xcyl[2]
        if tref == "nbody":
            if nbody_sys is None:
                raise ValueError("cooling tref=nbody requires <physics> nbody")
            self.needs_ctx = True
            self.nb = nbody_sys
            self.tfloor, self.tsph, self.sph_plaw = tfloor, tsph, sph_plaw
            self.cart = [np.broadcast_to(c, shape)
                         for c in geo.convert_to_cart(grid.coords, x1v, x2v, x3v)]
            self.zcyl = np.broadcast_to(zcyl, shape)
            return
        rsph = np.sqrt(Rcyl**2 + zcyl**2)
        T0 = tfloor + tcyl * Rcyl**cyl_plaw + tsph * rsph**sph_plaw
        efac = np.where(T0 > 0.0, np.exp(-self.escale * zcyl**2
                                         / np.where(T0 > 0, T0, 1.0)), 1.0)
        self.beta = np.broadcast_to(self.beta_min + self.beta0 * efac, shape)
        self.T0 = np.broadcast_to(T0, shape)
        self.om = np.broadcast_to(np.sqrt(gm / rsph**3), shape)

    def place(self, device, dtype):
        super().place(device, dtype)
        if self.tref == "nbody":
            self._cart = [self._t(c) for c in self.cart]
            self._z2 = self._t(self.zcyl) ** 2
        else:
            self._T0, self._beta, self._om = (self._t(self.T0), self._t(self.beta),
                                              self._t(self.om))
        return self

    def _nbody_profile(self, parts, dt):
        """T0, beta and Omega dt from the particles' softened potential."""
        nb = self.nb
        cx, cy, cz = self._cart
        pot = 0.0
        for k in range(nb.npart):
            dx = cx - (parts["pos"][k, 0] - nb.Rf[0])
            dy = cy - (parts["pos"][k, 1] - nb.Rf[1])
            dz = cz - (parts["pos"][k, 2] - nb.Rf[2])
            dr2 = dx * dx + dy * dy + dz * dz
            pot = pot - parts["gm"][k] * _idr1_soft(nb.rs[k], nb.spline[k], dr2)
        ir1 = -pot / self.gm
        T0 = self.tfloor + self.tsph * ir1 ** (-self.sph_plaw)
        efac = torch.where(T0 > 0.0, torch.exp(-self.escale * self._z2
                                               / torch.where(T0 > 0, T0, 1.0)), 1.0)
        beta = self.beta_min + self.beta0 * efac
        return T0, beta, dt * torch.sqrt(self.gm * ir1**3)

    def apply(self, state, fluxes, time, dt, hyd, ctx=None):
        cfg = self.gas_cfg
        u = state["gas"]["u"]
        sie, _ = hyd.sie_from_cons(u, cfg)
        rho = u[:, 0]
        cv = self._cv  # ideal gas: T = sie/cv
        Tn = sie / cv
        if self.tref == "nbody":
            T0, beta, omdt = self._nbody_profile(ctx["particles"], dt)
        else:
            T0, beta, omdt = self._T0, self._beta, dt * self._om
        dE = -rho * cv * omdt / (beta + omdt) * (Tn - T0)
        u = u.clone()
        u[:, 4] += dE
        u[:, 5] += dE
        new = dict(state)
        new["gas"] = {"u": u, "w": state["gas"]["w"]}
        return new


# ----------------------------------------------------------------------------
# Drag: damping zones + implicit gas-dust coupling (src/drag/drag.hpp)
# ----------------------------------------------------------------------------
class DampingParams:
    """Quadratic damping-zone ramps (cf. SelfDragParams, drag.hpp:69-110)."""

    def __init__(self, block, pin):
        g = lambda k, d: pin.get_or_add_real(block, k, d)
        self.ix = [g("inner_x1", -BIG), g("inner_x2", -BIG), g("inner_x3", -BIG)]
        self.irate = [g("inner_x1_rate", 0.0), g("inner_x2_rate", 0.0),
                      g("inner_x3_rate", 0.0)]
        self.ox = [g("outer_x1", BIG), g("outer_x2", BIG), g("outer_x3", BIG)]
        self.orate = [g("outer_x1_rate", 0.0), g("outer_x2_rate", 0.0),
                      g("outer_x3_rate", 0.0)]
        self.damp_to_visc = pin.get_or_add_bool(block, "damp_to_visc", False)

    def ramps(self, grid):
        """Per-direction damping-rate fields (before the dt factor),
        interior-shaped numpy (drag.hpp:209-226)."""
        shape = tuple(reversed(grid.nx))
        xv = grid.cell_centers()
        xmin, xmax = grid.xmin, grid.xmax
        out = []
        for d in range(3):
            x = xv[d]
            inner = self.irate[d] * np.where(
                x < self.ix[d],
                ((x - self.ix[d]) / (self.ix[d] - xmin[d])) ** 2, 0.0) \
                if self.irate[d] > 0.0 else 0.0
            outer = self.orate[d] * np.where(
                x > self.ox[d],
                ((x - self.ox[d]) / (self.ox[d] - xmax[d])) ** 2, 0.0) \
                if self.orate[d] > 0.0 else 0.0
            active = 1.0 if grid.active(d + 1) else 0.0
            f = active * (np.asarray(inner) + np.asarray(outer))
            out.append(np.broadcast_to(f, shape))
        return out


def dust_sizes_from_input(pin, nspecies, length_conv=None):
    """Per-species grain sizes in code units: <dust> size_input =
    linspace | logspace | direct | file (dust.cpp:103-173)."""
    if length_conv is None:
        from .units import Units

        length_conv = 1.0 / Units.from_input(pin).length  # physical -> code
    dist = pin.get_or_add_str("dust", "size_input", "direct")
    if dist == "linspace":
        lo = length_conv * pin.get_real("dust", "min_size")
        hi = length_conv * pin.get_real("dust", "max_size")
        return np.linspace(lo, hi, nspecies)
    if dist == "logspace":
        lo = math.log10(length_conv * pin.get_real("dust", "min_size"))
        hi = math.log10(length_conv * pin.get_real("dust", "max_size"))
        return np.logspace(lo, hi, nspecies)
    if dist == "direct":
        return length_conv * np.array(pin.get_real_list("dust", "sizes")[:nspecies])
    if dist == "file":
        rows = []
        with open(pin.get_str("dust", "size_file")) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    rows.append([float(t) for t in line.split()])
        vals = rows[0] if len(rows) == 1 else [r[0] for r in rows]
        return length_conv * np.array(vals[:nspecies])
    raise ValueError("dust/size_input not recognized!")


class Drag(SourceBase):
    """Damping zones (`self`) and/or implicit gas<->dust momentum exchange
    (`simple_dust`), unconditionally stable backward-Euler two-pass solve
    (drag.hpp:296-482)."""

    def __init__(self, pin, grid, gas_cfg, dust_cfg):
        self.grid = grid
        self.gas_cfg = gas_cfg
        self.dust_cfg = dust_cfg
        dtype_s = pin.get_str("drag", "type")
        if dtype_s not in ("self", "simple_dust"):
            raise ValueError("Bad choice of drag type")
        self.coupling = dtype_s
        self.gasp = DampingParams("gas/damping", pin) if pin.has_block("gas/damping") \
            else DampingParams("gas/damping_null", pin)
        self.dustp = DampingParams("dust/damping", pin) if pin.has_block("dust/damping") \
            else DampingParams("dust/damping_null", pin)
        self.gas_ramps = self.gasp.ramps(grid) if gas_cfg is not None else None
        self.dust_ramps = self.dustp.ramps(grid) if dust_cfg is not None else None

        if self.coupling == "simple_dust":
            blk = "dust/stopping_time"
            model = pin.get_str(blk, "type")
            self.stopping_model = model
            self.tau_scale = pin.get_or_add_real(blk, "scale", 1.0)
            nd = dust_cfg.nspecies
            if model == "constant":
                taus = pin.get_real_list(blk, "tau")
                self.tau = np.array(taus[:nd]) * self.tau_scale
            elif model == "stokes":
                self.sizes = dust_sizes_from_input(pin, nd)
                self.grain_density = pin.get_or_add_real("dust", "grain_density", 1.0)
            else:
                raise ValueError("bad type for stopping time model")
        # damp_to_visc: gas damping target is the viscous inflow
        # v_R = -3/2 mu/(R rho) (drag.hpp:240-245); wired to the gas
        # viscosity model by Simulation via set_viscosity()
        self.visc_dp = None
        if self.gasp.damp_to_visc:
            x1v, x2v, x3v = grid.cell_centers()
            shape = tuple(reversed(grid.nx))
            xcyl = geo.convert_to_cyl(grid.coords, x1v, x2v, x3v)
            xsph = geo.convert_to_sph(grid.coords, x1v, x2v, x3v)
            self.Rcyl = np.broadcast_to(xcyl[0], shape)
            self.rsph = np.broadcast_to(xsph[0], shape)
            ex = geo.vec_to_cyl(grid.coords, x1v, x2v, x3v)
            self.exR = [np.broadcast_to(ex[d][0], shape) for d in range(3)]

    def place(self, device, dtype):
        super().place(device, dtype)
        ramps = lambda r: None if r is None else [self._t(f) for f in r]
        self._gas_ramps, self._dust_ramps = ramps(self.gas_ramps), ramps(self.dust_ramps)
        if self.coupling == "simple_dust":
            if self.stopping_model == "constant":
                self._tau = self._t(self.tau)[:, None, None, None]
            else:
                self._sizes = self._t(self.sizes)[:, None, None, None]
        if self.gasp.damp_to_visc:
            self._Rcyl, self._rsph = self._t(self.Rcyl), self._t(self.rsph)
            self._exR = [self._t(e) for e in self.exR]
        return self

    def set_viscosity(self, dp):
        """Attach the gas viscosity coefficient model for damp_to_visc
        (DragSource dispatch, drag.cpp:109-121)."""
        if dp is None or dp.kind not in ("viscosity_plaw", "viscosity_alpha"):
            raise ValueError(
                "The chosen viscosity model does not work with damping")
        self.visc_dp = dp

    def _visc_target(self, rho, sie):
        """Per-direction gas target velocity components: the viscous inflow
        v_R = -1.5 mu/(Rcyl rho) projected on the problem basis
        (drag.hpp:240-245)."""
        dp = self.visc_dp
        cfg = self.gas_cfg
        Rc = self._Rcyl
        if dp.kind == "viscosity_plaw":
            mu = dp.nu_s * rho * (Rc / dp.R0) ** dp.r_exp
        else:
            Omk = dp.Omega0 * (self._rsph / dp.R0) ** -1.5
            mu = dp.alpha * cfg.gamma * (cfg.gamma - 1.0) * rho * sie / Omk
        vR = -1.5 * mu / (Rc * rho)
        return [self._exR[d] * vR for d in range(3)]

    def apply(self, state, fluxes, time, dt, hyd):
        if self.coupling == "self":
            return self._self_drag(state, dt, hyd)
        return self._simple_dust(state, dt, hyd)

    def _self_drag(self, state, dt, hyd):
        hx = hyd.hxv_int
        cfg = self.gas_cfg
        new = dict(state)
        for name, ramps in (("gas", self._gas_ramps), ("dust", self._dust_ramps)):
            if name not in state or ramps is None:
                continue
            u, w = state[name]["u"], state[name]["w"]
            rho = torch.clamp(u[:, 0], min=1e-300)
            vt = [0.0, 0.0, 0.0]  # dust always damps to zero
            if name == "gas" and self.visc_dp is not None:
                vt = self._visc_target(rho, hyd.sie_from_cons(u, cfg)[0])
            u = u.clone()
            dE = 0.0
            for d in range(3):
                fx = dt * ramps[d]
                v = u[:, 1 + d] / (hx[d] * rho)
                dm = -fx * rho * (v - vt[d]) / (1.0 + fx)
                u[:, 1 + d] += hx[d] * dm
                if name == "gas":
                    dE = dE + dm * (v + 0.5 * dm / rho)
            if name == "gas":
                u[:, 4] += dE
            new[name] = {"u": u, "w": w}
        return new

    def _stopping_time(self, dg, sieg):
        """Per-species stopping time tau [ns_dust, ...] (drag.hpp:112-144,
        404-422)."""
        if self.stopping_model == "constant":
            return self._tau.expand((self._tau.shape[0],) + dg.shape[-3:])
        # stokes: tau = scale * rho_gr * a / (rho_g * vth), vth^2 = 8/pi gm1 sie
        gm1 = self.gas_cfg.gamma - 1.0
        vth = torch.sqrt(8.0 / math.pi * gm1 * sieg)
        return self.tau_scale * self.grain_density * self._sizes / (dg[0] * vth[0])

    def _simple_dust(self, state, dt, hyd):
        """Implicit single-gas <-> N-dust coupling + damping
        (drag.hpp:296-482)."""
        cfg = self.gas_cfg
        hx = hyd.hxv_int
        ug, wg = state["gas"]["u"], state["gas"]["w"]
        ud, wd = state["dust"]["u"], state["dust"]["w"]
        dg = torch.clamp(ug[:1, 0], min=cfg.dfloor)  # [1, ...]
        vg = [ug[:1, 1 + d] / (hx[d] * dg) for d in range(3)]
        sieg, _ = hyd.sie_from_cons(ug, cfg)

        bg = [dt * self._gas_ramps[d] for d in range(3)]
        bd = [dt * self._dust_ramps[d] for d in range(3)]

        tau = self._stopping_time(dg, sieg)  # [nd, ...]
        nonpos = tau <= 0.0
        alpha = dt * torch.where(nonpos, BIG, 1.0 / torch.where(nonpos, 1.0, tau))

        rho_d = torch.clamp(ud[:, 0], min=self.dust_cfg.dfloor)
        vd = [ud[:, 1 + d] / (hx[d] * rho_d) for d in range(3)]
        # gas target velocity: viscous inflow when damp_to_visc
        vt = (self._visc_target(dg, sieg) if self.visc_dp is not None
              else [0.0, 0.0, 0.0])
        vdt = [0.0, 0.0, 0.0]  # dust target velocity

        # first pass: sum rho' and rho' v -> new gas velocity (drag.hpp:409-434)
        fd, vgp, rhop = [], [], []
        for d in range(3):
            rhop.append(rho_d * alpha / (1.0 + alpha + bd[d]))
            fd_d = torch.sum(rhop[d] * (1.0 + bd[d]), dim=0, keepdim=True)
            fvd_d = torch.sum(rhop[d] * (vd[d] + bd[d] * vdt[d]), dim=0, keepdim=True)
            fd.append(fd_d)
            vgp.append((dg * (vg[d] + bg[d] * vt[d]) + fvd_d)
                       / (dg * (1.0 + bg[d]) + fd_d))

        # second pass: dust momenta + gas back-reaction (drag.hpp:436-477)
        new_ud = ud.clone()
        new_ug = ug.clone()
        dE = 0.0
        for d in range(3):
            delta = rhop[d] * ((vgp[d] - vd[d]) + bd[d] * (vgp[d] - vdt[d]))
            delta_d = delta - bd[d] * rho_d / (1.0 + alpha + bd[d]) * (
                vd[d] - vdt[d] + alpha * (vgp[d] - vdt[d]))
            fvd2 = torch.sum(rhop[d] * (vd[d] - vt[d] + bd[d] * (vdt[d] - vt[d])),
                             dim=0, keepdim=True)
            new_ud[:, 1 + d] += hx[d] * delta_d
            dsum = -torch.sum(delta, dim=0, keepdim=True)
            prefac = dg * bg[d] / (1.0 + bg[d] + fd[d])
            dsum = dsum - prefac * (dg * (vg[d] - vt[d]) + fvd2)
            new_ug[:1, 1 + d] += hx[d] * dsum
            dE = dE + 0.5 * (vg[d] + vgp[d]) * dsum
        new_ug[:1, 4] += dE

        new = dict(state)
        new["gas"] = {"u": new_ug, "w": wg}
        new["dust"] = {"u": new_ud, "w": wd}
        return new


# ----------------------------------------------------------------------------
# N-body particle gravity + sink accretion (src/gravity/nbody_gravity.hpp)
# ----------------------------------------------------------------------------
class NBodyGravity(SourceBase):
    """Softened gravity from all live particles + per-particle sink accretion
    with back-reaction force reduction (NBodyGravityImpl,
    nbody_gravity.hpp:26-221).  The particles arrive in ``ctx`` each stage;
    the reduced [npart, 7] force rows (torch sums over the interior, no
    atomics, so a rerun on the card reproduces them bit for bit) are
    returned in ``ctx["pforce"]`` for the host-side coupling kick.  On a
    sharded run each shard's source sums its own cells, and
    ``parallel.mesh.ShardedDriver`` adds the shards' rows in shard order
    before the one host read per stage (the JAX package's ``psum`` hook,
    artemis_tpu/sources.py:800-803).
    """

    needs_ctx = True

    def __init__(self, pin, grid, nbody_sys, omf: float):
        self.grid = grid
        self.nb = nbody_sys
        self.tstart = pin.get_or_add_real("gravity", "tstart", -BIG)
        self.tstop = pin.get_or_add_real("gravity", "tstop", BIG)
        shape = tuple(reversed(grid.nx))
        x1v, x2v, x3v = grid.cell_centers()
        self.cart = [np.broadcast_to(c, shape)
                     for c in geo.convert_to_cart(grid.coords, x1v, x2v, x3v)]
        ex = geo.vec_to_cart(grid.coords, x1v, x2v, x3v)  # rows in cart
        self.ex = [[np.broadcast_to(ex[i][m], shape) for m in range(3)] for i in range(3)]
        # cell rotation velocity in cartesian components (for accretion vb)
        self.vb = None
        omf = omf if nbody_sys.frame_correction else 0.0
        if omf != 0.0:
            from .ops.hydro import _rotation_velocity

            vrot = _rotation_velocity(grid, (x1v, x2v, x3v), omf)
            if vrot is not None:
                self.vb = [sum(self.ex[i][m] * np.broadcast_to(vrot[i], shape)
                               for i in range(3)) for m in range(3)]

    def place(self, device, dtype):
        super().place(device, dtype)
        self._cart = [self._t(c) for c in self.cart]
        self._ex = [[self._t(e) for e in row] for row in self.ex]
        self._vb = [self._t(v) for v in self.vb] if self.vb is not None else None
        return self

    def _idr3(self, k, dr2):
        """Softened 1/r^3 kernel for particle k (particle_base.hpp:144-164)."""
        nb = self.nb
        rs = nb.rs[k]
        rs2 = rs * rs
        fz = 1e-300
        idr3_p = 1.0 / (fz + torch.sqrt(dr2 + rs2) * (dr2 + rs2))
        if not nb.spline[k]:
            return idr3_p
        dr3 = dr2 * torch.sqrt(dr2)
        u2 = dr2 / (rs2 + fz)
        u = torch.sqrt(u2)
        u3 = u * u2
        h3inv = 1.0 / (rs2 * rs + fz)
        inner = torch.where(
            u < 0.5,
            h3inv * (32.0 / 3.0 - 192.0 / 5.0 * u2 + 32.0 * u3),
            h3inv * (64.0 / 3.0 - 48.0 * u + 192.0 / 5.0 * u2
                     - 32.0 / 3.0 * u3 - 1.0 / (15.0 * u3 + fz)))
        return torch.where(dr2 >= rs2, 1.0 / (dr3 + fz), inner)

    def apply(self, state, fluxes, time, dt, hyd, ctx=None):
        nb = self.nb
        parts = ctx["particles"]
        hx = hyd.hxv_int
        vol = hyd.vol
        # a refinement tree's level: the cells a finer level covers give
        # their back-reaction from that level, so they are masked out of
        # this level's sums (their updates are overwritten by restriction)
        mask = ctx.get("mask")
        rvol = vol if mask is None else vol * mask
        cx, cy, cz = self._cart
        ex = self._ex
        dt_eff = dt if self.tstart <= time < self.tstop else torch.zeros_like(dt)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)

        pforce_rows = []
        fluids = [f for f in ("gas", "dust") if f in state]
        us = {f: state[f]["u"].clone() for f in fluids}
        for k in range(nb.npart):
            row = [zero] * 7
            if not nb.couple[k]:
                pforce_rows.append(torch.stack(row))
                continue
            gmk = parts["gm"][k]
            # relative cell position in cartesian (minus the frame offset)
            dx = cx - (parts["pos"][k, 0] - nb.Rf[0])
            dy = cy - (parts["pos"][k, 1] - nb.Rf[1])
            dz = cz - (parts["pos"][k, 2] - nb.Rf[2])
            dr2 = dx * dx + dy * dy + dz * dz
            idr3 = self._idr3(k, dr2)
            gX = -gmk * idr3 * dx
            gY = -gmk * idr3 * dy
            gZ = -gmk * idr3 * dz
            # to problem basis
            g1 = gX * ex[0][0] + gY * ex[0][1] + gZ * ex[0][2]
            g2 = gX * ex[1][0] + gY * ex[1][1] + gZ * ex[1][2]
            g3 = gX * ex[2][0] + gY * ex[2][1] + gZ * ex[2][2]

            do_sink = nb.racc[k] > 0.0
            if do_sink:
                dr1 = torch.sqrt(dr2)
                # relative particle velocity (minus frame velocity offset)
                pvx = parts["vel"][k, 0] - nb.Vf[0]
                pvy = parts["vel"][k, 1] - nb.Vf[1]
                pvz = parts["vel"][k, 2] - nb.Vf[2]
                # CartToSph rows (particle_base.hpp:246-261), literal replica
                fz = 1e-300
                R = torch.sqrt(dx * dx + dy * dy)
                ct = dz / (dr1 + fz)
                st = R / (dr1 + fz)
                cp = dx / (R + fz)
                sp = dy / (R + fz)
                et = (st * sp, ct * sp, cp)
                ep = (ct, -st, torch.zeros_like(ct))
                ramp = ((nb.racc[k] - dr1) / (nb.racc[k] + fz)) ** 2

            for fluid in fluids:
                u = us[fluid]
                w = state[fluid]["w"]
                rho = w[:, 0]
                v1, v2, v3 = w[:, 1], w[:, 2], w[:, 3]
                # velocity in cartesian
                vX = ex[0][0] * v1 + ex[1][0] * v2 + ex[2][0] * v3
                vY = ex[0][1] * v1 + ex[1][1] * v2 + ex[2][1] * v3
                vZ = ex[0][2] * v1 + ex[1][2] * v2 + ex[2][2] * v3
                rdt = rho * dt_eff
                u[:, 1] += hx[0] * rdt * g1
                u[:, 2] += hx[1] * rdt * g2
                u[:, 3] += hx[2] * rdt * g3
                if fluid == "gas":
                    u[:, 4] += rdt * (v1 * g1 + v2 * g2 + v3 * g3)
                # back-reaction: gravity rows
                row[1] = row[1] - torch.sum(gX * rho * rvol)
                row[2] = row[2] - torch.sum(gY * rho * rvol)
                row[3] = row[3] - torch.sum(gZ * rho * rvol)

                if do_sink:
                    vb = self._vb if self._vb is not None else (0.0, 0.0, 0.0)
                    dvx = vX + vb[0] - pvx
                    dvy = vY + vb[1] - pvy
                    dvz = vZ + vb[2] - pvz
                    dv2 = dvx * dvx + dvy * dvy + dvz * dvz
                    bound = (-gmk / (dr1 + 1e-300) + 0.5 * dv2) <= 0.0
                    acc = torch.logical_and(dr1 <= nb.racc[k], bound)
                    gdt = torch.where(acc, torch.clamp_max(
                        ramp * nb.sink_gamma[k] * dt_eff, 1.0 / 9.0), 0.0)
                    bdt = torch.where(acc, torch.clamp_max(
                        ramp * nb.sink_beta[k] * dt_eff, 1.0 / 9.0), 0.0)
                    fm = -gdt / (1.0 + gdt)
                    fp = (gdt - bdt) / ((1.0 + gdt) * (1.0 + bdt))
                    dvt = dvx * et[0] + dvy * et[1] + dvz * et[2]
                    dvp = dvx * ep[0] + dvy * ep[1] + dvz * ep[2]
                    dm = rho * fm
                    denp = rho * (1.0 + fm)
                    dek = 0.0
                    dmom = []
                    for (vc, etc, epc) in ((vX, et[0], ep[0]), (vY, et[1], ep[1]),
                                           (vZ, et[2], ep[2])):
                        dmv = rho * (fm * vc + fp * (dvt * etc + dvp * epc))
                        dmom.append(dmv)
                        vxp = (rho * vc + dmv) / (denp + 1e-300)
                        dek = dek + 0.5 * (vc + vxp) * rho * (vxp - vc) \
                            + 0.5 * rho * fm * vxp * vxp
                    dm1 = dmom[0] * ex[0][0] + dmom[1] * ex[0][1] + dmom[2] * ex[0][2]
                    dm2 = dmom[0] * ex[1][0] + dmom[1] * ex[1][1] + dmom[2] * ex[1][2]
                    dm3 = dmom[0] * ex[2][0] + dmom[1] * ex[2][1] + dmom[2] * ex[2][2]
                    u[:, 0] += dm
                    u[:, 1] += hx[0] * dm1
                    u[:, 2] += hx[1] * dm2
                    u[:, 3] += hx[2] * dm3
                    if fluid == "gas":
                        u[:, 4] += dek
                    idt = 1.0 / torch.clamp_min(dt_eff, 1e-300)
                    if mask is not None:
                        dmom = [dmv * mask for dmv in dmom]
                    row[0] = row[0] - torch.sum(rvol * dm) * idt
                    row[4] = row[4] - torch.sum(dmom[0]) * idt
                    row[5] = row[5] - torch.sum(dmom[1]) * idt
                    row[6] = row[6] - torch.sum(dmom[2]) * idt
            pforce_rows.append(torch.stack(row))

        ctx["pforce"] = torch.stack(pforce_rows)
        new = dict(state)
        for f in fluids:
            new[f] = {"u": us[f], "w": state[f]["w"]}
        return new


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
            gravity.gm = nbody_sys.gm
        else:
            gravity = Gravity(pin, grid, constants)
        srcs.append(gravity)
    if do_rotating:
        srcs.append(RotatingFrame(pin, grid))
    if do_drag:
        srcs.append(Drag(pin, grid, gas_cfg, dust_cfg))
    if do_cooling:
        gm = gravity.gm if (gravity is not None and hasattr(gravity, "gm")) else 1.0
        if nbody_sys is not None and not hasattr(gravity, "gm"):
            gm = nbody_sys.gm
        srcs.append(BetaCooling(pin, grid, gas_cfg, gm, cv=getattr(gas_cfg, "cv", None),
                                nbody_sys=nbody_sys))
    return srcs
