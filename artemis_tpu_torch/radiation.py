"""Gray radiation transport: deterministic flux-limited diffusion (port of
``artemis_tpu/radiation.py``, single device).

The reference evolves radiation with jaybenne's implicit Monte Carlo; the
JAX package replaced it with a gray energy density Er, evolved by an
operator-split step after the hydro stages (artemis_driver.cpp:111):

1. implicit matter-radiation exchange (backward Euler, Newton on T):
       dEr/dt = c kap rho (a T^4 - Er),  rho cv dT/dt = -c kap rho (a T^4 - Er)
2. flux-limited diffusion with the Levermore-Pomraning limiter
       dEr/dt = div( c lambda/(kap rho) grad Er ),
   solved implicitly with Jacobi-preconditioned conjugate gradients.

Both are solved together: the Newton outer loop folds the linearized
emission into the diffusion operator, and the gas is charged with the
radiation field's actual gain, so total energy is conserved to rounding.

The operator has two paths, as in the reference.  On a CUDA device a 3-D
grid of uniform Cartesian widths sets it up with ``ops.fld.fld_coeffs`` and
applies it with ``ops.fld.fld_matvec`` (the CUDA kernels); every other grid,
every CPU run, a run with ``fused=False`` and a sharded run builds it from
tensor operations.  The two loops are host loops over device tensors: the CG
loop reads its residual test back once per iteration and the Newton loop its
convergence test once per outer iteration (``profiling.host_read``, which
counts them; ``profiling.newton_outers`` counts the outers).

A refinement tree's level solves its same-shape patches as one system
(``step_batched``, the JAX tree's ``vmap`` of ``step``): the fields stacked
on a node axis, the kernels launched once over it, the dot products, maxima
and loop tests per node, and a node whose loop has ended held where it
stopped while the others go on; one host read serves every node's test.

A sharded run (``parallel.mesh``) steps one Radiation whose fields hold one
tensor per shard (``enable_sharding``): along the sharded axis a stencil
shift takes the neighbour shard's boundary plane and only the first and last
shard have physical edges; the CG's dot products and the Newton loop's
maxima are global, so every shard makes the same number of trips.

Opacity models (src/utils/opacity/opacity.hpp:20-56): none/constant (gray),
thermalization (c = 1, a_rad = 1), shocktube_a (power law with c = 1732.05,
a_rad = 7.716e-4), plus gray constant scattering.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import profiling
from .ops import fld as fld_mod
from .ops.fld import edge_masks, grad_norm, shift
from .profiling import host_read, kernel_span, span


@dataclass(frozen=True)
class RadiationCfg:
    opacity_model: str = "constant"   # none|constant|shocktube_a|thermalization
    kappa_a: float = 0.0
    coef_kappa_a: float = 0.0
    rho_exp: float = 0.0
    temp_exp: float = 0.0
    kappa_s: float = 0.0              # gray scattering
    c_code: float = 1.0
    arad: float = 1.0
    dt_rad: float = 1.0e38            # max radiation (and hence global) dt
    cg_tol: float = 1.0e-10
    cg_maxiter: int = 200
    coupled_iters: int = 4            # Newton outer iterations of the
    #                                   coupled exchange+diffusion solve


def radiation_from_input(pin, constants, gas_cfg):
    """RadiationCfg from the deck (cf. gas.cpp:124-166 for opacity and the
    custom unit systems in opacity.hpp)."""
    model = pin.get_or_add_str("gas/opacity/absorption", "opacity_model", "constant")
    kappa_a = pin.get_or_add_real("gas/opacity/absorption", "kappa_a", 0.0)
    coef = pin.get_or_add_real("gas/opacity/absorption", "coef_kappa_a", 0.0)
    rho_exp = pin.get_or_add_real("gas/opacity/absorption", "rho_exp", 0.0)
    temp_exp = pin.get_or_add_real("gas/opacity/absorption", "temp_exp", 0.0)
    smodel = pin.get_or_add_str("gas/opacity/scattering", "scattering_model", "none")
    kappa_s = pin.get_or_add_real("gas/opacity/scattering", "kappa_s", 0.0) \
        if smodel == "constant" else 0.0

    if model == "thermalization":
        c_code, arad = 1.0, 1.0
    elif model == "shocktube_a":
        # custom units for the Lowrie-Edwards radiative shock problem
        c_code, arad = 1732.05, 7.716e-4
    else:
        c_code = constants.c_code
        arad = constants.ar_code

    # float32-safe "no limit" sentinel
    dt_rad = min(1.0e38, pin.get_or_add_real("jaybenne", "dt", 1.0e38)) \
        if pin.has_block("jaybenne") else 1.0e38

    return RadiationCfg(
        opacity_model=model, kappa_a=kappa_a, coef_kappa_a=coef,
        rho_exp=rho_exp, temp_exp=temp_exp, kappa_s=kappa_s,
        c_code=c_code, arad=arad, dt_rad=dt_rad,
    )


def _pow3(x):
    """x**3 as the reference computes an integer power: x * (x * x)."""
    return x * (x * x)


def _pow4(x):
    """x**4 as (x * x) * (x * x)."""
    x2 = x * x
    return x2 * x2


class Radiation:
    """Operator-split gray FLD radiation step bound to a Hydro and its grid.
    ``fused=False`` keeps a CUDA run on the tensor-operation operator (the
    plain version the kernels are measured against)."""

    def __init__(self, cfg: RadiationCfg, grid, hyd, gas_cfg, *, fused: bool = True):
        if grid.coords != "cartesian":
            raise ValueError("radiation currently requires Cartesian geometry "
                             "(as does the reference IMC, artemis.cpp:113-114)")
        self.cfg = cfg
        self.grid = grid
        self.hyd = hyd
        self.gas = gas_cfg
        self.dims = hyd.dims
        # physical cell widths per dim (Cartesian: uniform per axis)
        self.widths = hyd.widths
        # deck-BC Dirichlet edges: {d: (lo_value_or_None, hi_value_or_None)}
        # scalars, set for `ic` hydro BCs so the radiation field is pinned to
        # the IC equilibrium outside the domain instead of reflecting at a
        # zero-flux wall
        self._edge_dirichlet = {}
        # the sharded axis and the number of shards (enable_sharding)
        self._axis_d = None
        self.nshards = 1
        # the FLD cap extent: the largest domain extent over the active dims
        self._ext_t = self._cap_extent()
        # uniform cell widths (dx, dy, dz) and the kernels' cap extent
        wu = []
        for d in (1, 2, 3):
            arr = self.widths[d - 1]
            if arr.numel() and float(arr.max()) == float(arr.min()):
                wu.append(float(arr.reshape(-1)[0]))
        self._wuni = tuple(wu) if len(wu) == 3 else None
        self._ext = (max(grid.nx[d - 1] * wu[d - 1] for d in self.dims)
                     if self._wuni and self.dims else 0.0)
        # the operator runs through the CUDA kernels on the card: 3-D,
        # uniform Cartesian widths (the TPU gate's even-nz rule was a Mosaic
        # tiling rule)
        self.use_kernels = (fused and hyd.device.type == "cuda" and len(self.dims) == 3
                            and self._wuni is not None)
        # the last step's CG iterations per outer iteration
        self.cg_iters = []

    def _cap_extent(self, nshards: int = 1):
        """The largest domain extent over the active dims; along the sharded
        axis ``nshards`` windows of this radiation's widths (the JAX
        package's rule, radiation.py:237-241)."""
        ext = torch.zeros((), dtype=self.hyd.dtype, device=self.hyd.device)
        for d in self.dims:
            w = self.widths[d - 1]
            s = torch.amax(torch.sum(w, dim=w.ndim - d))
            if d == self._axis_d:
                s = s * nshards
            ext = torch.maximum(ext, s)
        return ext

    def enable_sharding(self, axis_d: int, nshards: int, widths):
        """Step a sharded run's state from here on: ``widths`` are the
        shards' cell widths (``parallel.mesh.Sharded`` fields), the cap
        extent spans every shard, and the operator runs as tensor
        operations (the JAX package gates its FLD kernels off under
        sharding, radiation.py:261-263)."""
        self._axis_d = axis_d
        self.nshards = nshards
        self._ext_t = self._cap_extent(nshards)
        self.widths = widths
        self.use_kernels = False

    def _shift(self, E, d, sign):
        """``ops.fld.shift``; along the sharded axis the wrapped plane is the
        neighbour shard's boundary plane."""
        return E.shift(d, sign) if d == self._axis_d else shift(E, d, sign)

    def _edge_masks(self, a, d):
        """``ops.fld.edge_masks``; along the sharded axis only the first and
        last shard have a physical edge."""
        return a.edge_masks(d) if d == self._axis_d else edge_masks(a, d)

    def set_edge_dirichlet(self, d: int, lo=None, hi=None):
        """Pin the radiation field outside the physical edge(s) along dim
        ``d`` to fixed scalar values (Dirichlet ghosts one cell out)."""
        self._edge_dirichlet[d] = (lo, hi)

    # -- opacity ---------------------------------------------------------
    def kappa(self, rho, T):
        cfg = self.cfg
        if cfg.opacity_model in ("constant", "thermalization"):
            return torch.full_like(rho, cfg.kappa_a)
        if cfg.opacity_model == "shocktube_a":
            return cfg.coef_kappa_a * rho**cfg.rho_exp * T**cfg.temp_exp
        return torch.zeros_like(rho)

    # -- step ------------------------------------------------------------
    def step(self, state, dt, ghosts=None, with_iters=False):
        """One operator-split radiation update (exchange + diffusion).

        ``dt``: a float or a 0-d tensor.  ``with_iters``: also return the
        CG iteration counts per Newton outer iteration (a list of
        ``coupled_iters`` ints, 0 for outers that did not run).
        ``ghosts``: optional {d: (E_lo_plane, E_hi_plane)} Dirichlet
        boundary planes one cell outside the domain along d (AMR patch
        solves); they take precedence over the deck's ``ic`` edges."""
        u = state["gas"]["u"]
        Er, de, iters, nk = self._coupled(u[:1, 0], u[:1, 5], state["rad"]["Er"], dt,
                                          self._ghosts(ghosts), None)
        self.cg_iters = iters[0][:nk[0]]
        new = self._charged(state, Er, de)
        if with_iters:
            return new, iters[0]
        return new

    def step_batched(self, rads, states, dt, ghosts):
        """One coupled radiation update of a tree level's group of same-shape
        nodes, as one system over a node axis: the JAX tree's ``vmap`` of
        ``step`` over its stacked group (``artemis_tpu/amr.py:1968-1984``).
        ``rads``: the members' Radiations, this one first; ``states`` and
        ``ghosts`` (their Dirichlet planes, as ``step`` takes them): theirs,
        in that order.  Each member's result is its own ``step``'s to
        round-off (the dot products and maxima are reduced per node over the
        stack), with its own CG iteration counts in ``cg_iters``; each loop
        test reads every node at once, one host read.  Returns the members'
        new states (not yet re-synced: each member runs its own
        ``sync_gas``).  Every member must share
        this one's configuration (``batch_key``): the JAX tree steps its
        group with its first member's Radiation without checking."""
        key = self.batch_key()
        for rad in rads[1:]:
            if rad.batch_key() != key:
                raise ValueError("a batched radiation step needs one configuration for every "
                                 f"member: {rad.batch_key()} against {key}")
        nb = len(states)
        gh = {d: tuple(None if pl[0] is None else torch.stack(pl)
                       for pl in zip(*(g[d] for g in ghosts))) for d in ghosts[0]}
        Er, de, iters, nk = self._coupled(
            torch.stack([st["gas"]["u"][:1, 0] for st in states]),
            torch.stack([st["gas"]["u"][:1, 5] for st in states]),
            torch.stack([st["rad"]["Er"] for st in states]), dt, self._ghosts(gh), nb)
        for rad, its, k in zip(rads, iters, nk):
            rad.cg_iters = its[:k]
        return [self._charged(st, e, x) for st, e, x in zip(states, Er.unbind(0),
                                                            de.unbind(0))]

    def batch_key(self):
        """What a batched step requires equal across its members: the
        configuration, the cell widths (uniform: the grid is Cartesian) and
        cap extent, the active dims, the operator's path and the deck's
        Dirichlet edges."""
        return (self.cfg, self._wuni, self._ext, tuple(self.dims), self.use_kernels,
                tuple(sorted(self._edge_dirichlet.items())))

    def _ghosts(self, ghosts):
        """The Dirichlet planes of a solve: ``ghosts``, then the deck's
        ``ic`` edges where ``ghosts`` has no plane along d."""
        gh = dict(ghosts) if ghosts else {}
        for d, (lo_v, hi_v) in self._edge_dirichlet.items():
            if d not in gh:
                gh[d] = (lo_v, hi_v)
        return gh

    def _charged(self, state, Er, de):
        """``state`` with the new field and the gas energy charged with
        ``de`` (the gas prims as they were: ``sync_gas`` re-syncs them)."""
        u = state["gas"]["u"].clone()
        u[:1, 5] += de
        u[:1, 4] += de
        new = dict(state)
        new["gas"] = {"u": u, "w": state["gas"]["w"]}
        new["rad"] = {"Er": Er}
        return new

    def _coupled(self, rho_u, eint, Er0, dt, gh, nb):
        """(Er, de, iters, nk) of one coupled solve from the gas density
        ``rho_u`` (u[:1, 0]), internal energy ``eint`` (u[:1, 5]) and the
        field Er0: the new field, the gas energy change, and per node its
        CG iterations per Newton outer and its outers.  ``nb``: None for
        one node, else the number of nodes stacked on the leading axis."""
        cfg = self.cfg
        gas = self.gas
        dt = torch.as_tensor(dt, dtype=Er0.dtype, device=Er0.device)
        rho = torch.clamp_min(rho_u, gas.dfloor)
        T0 = eint / (rho * gas.cv)
        rcv = rho * gas.cv

        # FLD coefficients, frozen at the pre-step state (the limiter and
        # diffusivity lag one step)
        kap_t = self.kappa(rho, T0) + cfg.kappa_s  # transport opacity
        chi = kap_t * rho  # 1/mfp
        ftiny = torch.finfo(Er0.dtype).tiny

        if self.use_kernels:
            matvec, diag_geo, b_ghost = self._kernel_operator(Er0, chi, dt, gh, nb)
        else:
            # the tensor operator (the plain versions of fld_coeffs and
            # fld_matvec)
            body = "plain" if nb is None else "plain, node axis"
            with kernel_span("fld_coeffs", body, Er0.device):
                matvec, diag_geo, b_ghost = self._tensor_operator(Er0, chi, dt, gh, ftiny,
                                                                  body)
        return self._solve_coupled(Er0, rho, rcv, T0, dt, matvec, diag_geo, b_ghost, nb)

    def _tensor_operator(self, Er0, chi, dt, gh, ftiny, body="plain"):
        """(matvec, diag_geo, b_ghost) of the operator from tensor
        operations: the limited, capped diffusivity, the masked face
        coefficients and the Jacobi diagonal.  Every stencil counts its
        dims from the end, so a stack of nodes wraps each in its own box."""
        cfg = self.cfg

        def grad_mag(E):
            return grad_norm([(self._shift(E, d, 1) - self._shift(E, d, -1))
                              / (2 * self.widths[d - 1]) for d in self.dims])

        R = grad_mag(Er0) / (chi * torch.clamp_min(Er0, ftiny) + ftiny)
        lam = (2.0 + R) / (6.0 + 3.0 * R + R * R)  # Levermore-Pomraning
        Dcell = cfg.c_code * lam / (chi + ftiny)
        # FLD validity cap at c * (domain extent): a transparent region
        # equilibrates within one light-crossing time of the domain
        # (optically thick problems never reach it)
        Dcell = torch.minimum(Dcell, cfg.c_code * self._ext_t)

        # face coefficients of the operator (I - dt div D grad): arithmetic
        # face averages, masked at the edges (zero flux, or the one-sided
        # Dcell at a Dirichlet face, whose wrapped neighbour ZH/ZL zero)
        DH, DL, ZH, ZL = {}, {}, {}, {}
        for d in self.dims:
            w = self.widths[d - 1]
            D_hi = 0.5 * (Dcell + self._shift(Dcell, d, 1))
            D_lo = 0.5 * (Dcell + self._shift(Dcell, d, -1))
            first, last = self._edge_masks(Dcell, d)
            lo_g, hi_g = gh.get(d, (None, None))
            if hi_g is not None:
                D_hi = torch.where(last, Dcell, D_hi)
                ZH[d] = (~last).to(Dcell.dtype)
            else:
                D_hi = torch.where(last, 0.0, D_hi)
                ZH[d] = None
            if lo_g is not None:
                D_lo = torch.where(first, Dcell, D_lo)
                ZL[d] = (~first).to(Dcell.dtype)
            else:
                D_lo = torch.where(first, 0.0, D_lo)
                ZL[d] = None
            iw2 = 1.0 / (w * w)
            DH[d] = D_hi * iw2
            DL[d] = D_lo * iw2

        # Dirichlet ghost contributions to the right-hand side
        b_ghost = 0.0
        for d in self.dims:
            lo_g, hi_g = gh.get(d, (None, None))
            if hi_g is not None:
                b_ghost = b_ghost + dt * DH[d] * (1.0 - ZH[d]) * hi_g
            if lo_g is not None:
                b_ghost = b_ghost + dt * DL[d] * (1.0 - ZL[d]) * lo_g

        # geometric part of the Jacobi diagonal
        diag_geo = torch.ones_like(Er0)
        for d in self.dims:
            diag_geo = diag_geo + dt * (DH[d] + DL[d])

        # off-diagonal coefficients with the Dirichlet masks folded in:
        #   matvec(E, sf) = (diag_geo + sf) E - sum_d (AH_d E+ + AL_d E-)
        AH, AL = {}, {}
        for d in self.dims:
            AH[d] = dt * (DH[d] * ZH[d] if ZH[d] is not None else DH[d])
            AL[d] = dt * (DL[d] * ZL[d] if ZL[d] is not None else DL[d])

        def matvec(E, sf):
            with kernel_span("fld_matvec", body, E.device):
                out = (diag_geo + sf) * E
                for d in self.dims:
                    out = out - (AH[d] * self._shift(E, d, 1) + AL[d] * self._shift(E, d, -1))
                return out

        return matvec, diag_geo, b_ghost

    def _kernel_operator(self, Er0, chi, dt, gh, nb):
        """(matvec, diag_geo, b_ghost) of the operator through the FLD
        kernels: one fld_coeffs launch per step, one fld_matvec launch per
        CG matvec, over the node axis where ``nb`` nodes are stacked."""
        shp = tuple(Er0.shape[-3:]) if nb is None else (nb,) + tuple(Er0.shape[-3:])
        flags = []
        for d in (1, 2, 3):
            lo_g, hi_g = gh.get(d, (None, None))
            flags.append((lo_g is not None, hi_g is not None))
        chi3 = torch.broadcast_to(chi, Er0.shape).reshape(shp).contiguous()
        A6, dg3, Dc3 = fld_mod.fld_coeffs(Er0.reshape(shp).contiguous(), chi3, dt.reshape(1),
                                          self._wuni, self.cfg.c_code, self._ext, flags)
        diag_geo = dg3.reshape(Er0.shape)
        Dc_f = Dc3.reshape(Er0.shape)
        b_ghost = 0.0
        for d in (1, 2, 3):
            lo_g, hi_g = gh.get(d, (None, None))
            if lo_g is None and hi_g is None:
                continue
            if isinstance(b_ghost, float):
                b_ghost = torch.zeros_like(Er0)
            iw2 = 1.0 / self._wuni[d - 1] ** 2
            ax = Er0.ndim - d
            n = Er0.shape[ax]
            for g, i in ((hi_g, n - 1), (lo_g, 0)):
                if g is None:
                    continue
                sl = [slice(None)] * Er0.ndim
                sl[ax] = slice(i, i + 1)
                sl = tuple(sl)
                b_ghost[sl] = b_ghost[sl] + (dt * iw2) * Dc_f[sl] * g

        def matvec(E, sf):
            sf3 = torch.broadcast_to(sf, E.shape).reshape(shp).contiguous()
            out = fld_mod.fld_matvec(E.reshape(shp).contiguous(), A6, dg3, sf3)
            return out.reshape(E.shape)

        return matvec, diag_geo, b_ghost

    def _solve_coupled(self, Er0, rho, rcv, T0, dt, matvec, diag_geo, b_ghost, nb):
        """Newton-outer coupled exchange+diffusion solve with exact energy
        bookkeeping, shared by both operator paths.  Returns (Er, de, iters,
        nk): per node its CG iterations per outer (``coupled_iters`` ints)
        and its outers.

        ``nb`` nodes stacked on the leading axis (None: one node) solve as
        the JAX tree's ``vmap`` of the one-node solve: the dot products and
        maxima are per node, each loop test is read for every node at once,
        and a node whose own test has ended keeps its iterate (``where`` on
        its carry, as ``vmap``'s ``while_loop`` selects the old one) while
        the others go on; a node whose Newton loop has ended takes no CG
        iteration in a later outer."""
        cfg = self.cfg
        fi = torch.finfo(Er0.dtype)
        # dtype-aware tolerance: in float32 the deck default 1e-10 is far
        # below roundoff; ~50 eps is the reachable relative-residual floor
        tol = max(cfg.cg_tol, 50.0 * fi.eps)
        tiny = fi.tiny
        n = 1 if nb is None else nb
        if nb is None:
            dot, big = torch.sum, torch.max
        else:
            per = (nb,) + (1,) * (Er0.ndim - 1)

            def dot(x):
                return x.reshape(nb, -1).sum(1).reshape(per)

            def big(x):
                return torch.amax(x.reshape(nb, -1), 1).reshape(per)

        def keep(run, new, old):
            """``new`` where ``run`` (None: every node runs), else ``old``."""
            return new if run is None else torch.where(run, new, old)

        def cg(b, x, sf, diag, live):
            """Jacobi-preconditioned CG from x; returns (x, r, iterations per
            node) with r the maintained residual b - matvec(x, sf).
            ``live``: None, or the nodes whose Newton loop runs (the others
            take no iteration)."""
            r = b - matvec(x, sf)
            rs = dot(r * r)
            if live is not None:
                rs = torch.where(live, rs, 0.0)
            bb = dot(b * b)
            # the first search direction is the preconditioned residual z
            # (seeding p = r loses conjugacy where dt D / w^2 is large)
            z = r / diag
            p = z
            rz = dot(r * z)
            thresh = tol * tol * bb
            its = [0] * n
            it = 0
            while it < cfg.cg_maxiter:
                with span("cg"):
                    # the residual test of every node: one host read
                    run = rs > thresh
                    act = host_read(run, "cg_test")
                    if not any(act):
                        break
                    run = None if all(act) else run
                    Ap = matvec(p, sf)
                    pAp = dot(p * Ap)
                    # breakdown guard: near the attainable-residual floor
                    # roundoff can make p.Ap <= 0; then freeze x and r and
                    # force rs to 0 so the loop ends with the best iterate
                    ok = pAp > tiny
                    alpha = torch.where(ok, rz, 0.0) / torch.where(ok, pAp, 1.0)
                    x = keep(run, x + alpha * p, x)
                    r_new = r - alpha * Ap
                    z = r_new / diag
                    rz_new = dot(r_new * z)
                    rs = keep(run, torch.where(ok, dot(r_new * r_new), 0.0), rs)
                    p = keep(run, z + (rz_new / torch.clamp_min(rz, tiny)) * p, p)
                    rz = keep(run, rz_new, rz)
                    r = keep(run, r_new, r)
                    its = [i + a for i, a in zip(its, act)]
                    it += 1
            return x, r, its

        # Coupled implicit exchange + diffusion: Newton-linearize the
        # emission (a T^4 ~ a Tk^4 + 4 a Tk^3 (T - Tk)), eliminate the local
        # matter equation and fold the effective coupling
        # sf = sig rcv / (rcv + 4 a Tk^3 sig) into the operator:
        #   (1 + sf) Er - dt div D grad Er = Er0 + sf emis.
        a_r = cfg.arad
        tol_outer = 50.0 * fi.eps
        Tscale = big(torch.abs(T0)) + tiny
        iters = [[0] * cfg.coupled_iters for _ in range(n)]
        nk = [0] * n
        Er_k, Tk = Er0, T0
        r = b = sf = dT = live = None
        k = 0
        # the first outer always runs; later ones only while the Newton
        # temperature iterate still moves at the dtype's resolution
        while k < cfg.coupled_iters:
            if k >= 1:
                run = dT > tol_outer * Tscale
                act = host_read(run, "newton_test")
                if not any(act):
                    break
                live = None if all(act) else run
            else:
                act = [True] * n
            profiling.newton_outers += 1
            with span("newton"):
                kap = self.kappa(rho, Tk)
                sig = dt * cfg.c_code * kap * rho
                beta = 4.0 * a_r * _pow3(Tk)
                f = rcv / (rcv + sig * beta)
                sf_k = sig * f
                emis = a_r * _pow4(Tk) + beta * (T0 - Tk)
                b_k = Er0 + sf_k * emis + b_ghost
                Er_new, r_k, its = cg(b_k, Er_k, sf_k, diag_geo + sf_k, live)
                Tk2 = T0 - sf_k * (emis - Er_new) / rcv
                dT = keep(live, big(torch.abs(Tk2 - Tk)), dT)
                for j in range(n):
                    if act[j]:
                        iters[j][k] = its[j]
                        nk[j] += 1
                Er_k, r, b, sf = (keep(live, Er_new, Er_k), keep(live, r_k, r),
                                  keep(live, b_k, b), keep(live, sf_k, sf))
                Tk = keep(live, Tk2, Tk)
            k += 1

        # Charge the gas with the radiation field's actual gain net of
        # diffusion, so total energy is conserved to rounding at any CG
        # residual: matvec(E, 0) - E = -dt div D grad E (homogeneous part),
        # recovered from the maintained residual without another matvec,
        # matvec(Er, 0) = b - r - sf Er; b_ghost restores the Dirichlet fluxes.
        LEr = b - r - sf * Er_k - Er_k
        de = -(Er_k - Er0 + LEr - b_ghost)
        return Er_k, de, iters, nk

    def sync_gas(self, state):
        """Re-sync the gas prims after the split update (IMC::SyncFields,
        imc.hpp:28-58).  The radiation update changes only the gas energy
        (u4 += de, u5 += de) and every other variable is already a fixed
        point of C2P/P2C, so the sync is the energy subchain of
        cons_to_prim + prim_to_cons.  The state leaves without ``dtden``:
        the stage's CFL maxima predate the energy change, so the next dt
        comes from w."""
        cfg = self.gas
        u = state["gas"]["u"]
        w = state["gas"]["w"]
        rho = w[:, 0]                      # = max(u0, dfloor) on entry
        sie = torch.clamp_min(u[:, 5] / rho, cfg.siefloor)
        p = (cfg.gamma - 1.0) * rho * sie
        eint = sie * rho
        ke = 0.5 * rho * (w[:, 1] * w[:, 1] + w[:, 2] * w[:, 2] + w[:, 3] * w[:, 3])
        u = u.clone()
        w = w.clone()
        u[:, 5] = eint
        u[:, 4] = eint + ke
        w[:, 4] = p
        w[:, 5] = sie
        new = dict(state)
        new["gas"] = {"u": u, "w": w}
        return new


def initialize_radiation(state, gas_cfg, cfg: RadiationCfg):
    """Er = a T^4 from the current gas temperature (the reference's
    jaybenne::InitializeRadiation)."""
    w = state["gas"]["w"]
    T = w[:1, 5] / gas_cfg.cv
    return {"Er": cfg.arad * _pow4(T)}
