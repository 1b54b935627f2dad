"""ShallowWaterModel.

Reference semantics: src/Models/ShallowWaterModels/ — struct
(shallow_water_model.jl:39-55), `ConservativeFormulation` (prognostic
transports uh, vh and height h) vs `VectorInvariantFormulation` (u, v, h)
(:57-59), tendencies (solution_and_tracer_tendencies.jl):

    ∂t uh = -∇·(𝐮 uh) - ∂x(g h²/2) - f×(uh,vh)|x - g h ∂x h_B + F
    ∂t h  = -∇·(uh, vh)
    ∂t c  = -∇·(𝐔 c) + c ∇·𝐔          (advective form via flux + correction)

vector-invariant:

    ∂t u = -(ζ+f) v̂ - ∂x(g(h+h_B) + |u|²/2) + F

RK3 stepping (the reference default for this model), no elliptic solve."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..advection import Centered
from ..advection.fluxes import _biased_by
from ..boundary_conditions import (apply_flux_bcs, fill_halo_regions,
                                   regularize_field_boundary_conditions)
from ..defaults import defaults
from ..fields import Field, set_on_padded
from ..grids.topology import FLAT, LOC_CCC, LOC_CFC, LOC_FCC
from ..operators.operators import (LOC_FFC, _delta_c, _delta_f, ddx, ddy,
                                   div_xy_ccc, dx_c, dy_c, interp, ix_c, ix_f,
                                   iy_c, iy_f, zeta3_ffc)
from ..timesteppers import RK3_GAMMAS, RK3_ZETAS

CONSERVATIVE = "conservative"
VECTOR_INVARIANT = "vector_invariant"


def ConservativeFormulation():
    """Reference formulation marker (shallow_water_model.jl:57-59)."""
    return CONSERVATIVE


def VectorInvariantFormulation():
    return VECTOR_INVARIANT


def advective_tracer_tendencies(grid, scheme, uh, vh, tracer_names,
                                fields):
    """Advective-form tracer tendencies via conservative flux + c·∇·U
    correction (reference: shallow_water_advection_operators.jl div_Uc for
    VectorInvariantFormulation — shared by both formulations; was
    duplicated verbatim in two places, round-5 review)."""
    out = {}
    divU = (dx_c(grid, grid.dy(LOC_FCC) * uh)
            + dy_c(grid, grid.dx(LOC_CFC) * vh)) / grid.Az(LOC_CCC)
    for name in tracer_names:
        c = fields[name]
        ct_l, ct_r = scheme.biased_pair(grid, c, 0, 0)
        chat_x = jnp.where(uh > 0, ct_l, ct_r)
        fx = dx_c(grid, grid.dy(LOC_FCC) * uh * chat_x)
        ct_l, ct_r = scheme.biased_pair(grid, c, 1, 0)
        chat_y = jnp.where(vh > 0, ct_l, ct_r)
        fy = dy_c(grid, grid.dx(LOC_CFC) * vh * chat_y)
        divUc = (fx + fy) / grid.Az(LOC_CCC)
        out[name] = -divUc + c * divU
    return out


def conservative_tendencies(grid, scheme, g, coriolis, hB, tracer_names,
                            fields):
    """Conservative-formulation tendencies G(uh, vh, h, tracers) (reference:
    solution_and_tracer_tendencies.jl) as pure local stencils over the
    model's padded grid. Excludes closure/forcing/boundary-flux terms
    (applied by the caller)."""
    h = fields["h"]
    uh, vh = fields["uh"], fields["vh"]
    u = uh / ix_f(grid, h)
    v = vh / iy_f(grid, h)
    G = {}

    # momentum flux divergence of transports: ∇·(𝐮 uh)
    ut = scheme.symmetric(grid, uh, 0, 1)            # fcc → ccc
    uhat = _biased_by(scheme, grid, u, 0, 1, ut)
    fx = _delta_f(grid, grid.dy(LOC_CCC) * ut * uhat, 0)
    vt = scheme.symmetric(grid, vh, 0, 0)            # cfc → ffc
    uhat = _biased_by(scheme, grid, u, 1, 0, vt)
    fy = _delta_c(grid, grid.dx(LOC_FFC) * vt * uhat, 1)
    div_mom_u = (fx + fy) / grid.Az(LOC_FCC)

    ut = scheme.symmetric(grid, uh, 1, 0)            # fcc → ffc
    vhat = _biased_by(scheme, grid, v, 0, 0, ut)
    fx = _delta_c(grid, grid.dy(LOC_FFC) * ut * vhat, 0)
    vt = scheme.symmetric(grid, vh, 1, 1)            # cfc → ccc
    vhat = _biased_by(scheme, grid, v, 1, 1, vt)
    fy = _delta_f(grid, grid.dx(LOC_CCC) * vt * vhat, 1)
    div_mom_v = (fx + fy) / grid.Az(LOC_CFC)

    Gu = (-div_mom_u
          - ddx(grid, 0.5 * g * h * h, LOC_FCC)
          - g * ix_f(grid, h) * ddx(grid, hB, LOC_FCC))
    Gv = (-div_mom_v
          - ddy(grid, 0.5 * g * h * h, LOC_CFC)
          - g * iy_f(grid, h) * ddy(grid, hB, LOC_CFC))
    if coriolis is not None:
        zero = jnp.zeros_like(h)
        Gu = Gu - coriolis.x_f_cross_U(grid, uh, vh, zero)
        Gv = Gv - coriolis.y_f_cross_U(grid, uh, vh, zero)
    G["uh"], G["vh"] = Gu, Gv

    G["h"] = -div_xy_ccc(grid, uh, vh) * grid.V(LOC_CCC) / grid.Az(LOC_CCC)

    G.update(advective_tracer_tendencies(grid, scheme, uh, vh,
                                         tracer_names, fields))
    return G


class ShallowWaterModel:
    def __init__(self, grid, gravitational_acceleration=None,
                 advection=None, coriolis=None, bathymetry=0.0,
                 tracers=(), forcing=None, boundary_conditions=None,
                 formulation=CONSERVATIVE, closure=None,
                 architecture=None, reference_datetime=None):
        from ..parallel.distributed import CPU as _CPU
        if isinstance(architecture, _CPU):
            architecture = None       # CPU()/GPU() markers = the default
        self.reference_datetime = reference_datetime
        if not grid.is_flat(2):
            raise ValueError("ShallowWaterModel requires a z-Flat grid "
                             "(reference: shallow_water_model.jl validation)")
        self.grid = grid
        self.g = (defaults.gravitational_acceleration
                  if gravitational_acceleration is None
                  else float(gravitational_acceleration))
        self.advection = advection if advection is not None else Centered(2)
        # +1: the advected velocity u = uh/ℑx(h) is a composed stencil —
        # reconstructing it at the innermost halo point reads h one slot
        # deeper than the scheme's own reach
        required = getattr(self.advection, "required_halo", 1) + 1
        halo = [max(h, required) if not grid.is_flat(i) else 0
                for i, h in enumerate(grid.H)]
        halo = tuple(halo)
        self.grid = grid.with_halo(halo)
        self.coriolis = coriolis
        self.closure = closure
        self.formulation = formulation
        if isinstance(tracers, str):
            tracers = (tracers,)
        self.tracer_names = tuple(tracers)
        from ..forcings.forcings import regularize_forcing
        self.forcing = regularize_forcing(forcing)

        if formulation == CONSERVATIVE:
            self._solution = ("uh", "vh", "h")
        elif formulation == VECTOR_INVARIANT:
            self._solution = ("u", "v", "h")
        else:
            raise ValueError(formulation)

        self.bathymetry = set_on_padded(self.grid, LOC_CCC, bathymetry)

        bcs_in = dict(boundary_conditions or {})
        self.bcs = {}
        locs = {self._solution[0]: LOC_FCC, self._solution[1]: LOC_CFC,
                "h": LOC_CCC}
        for name in self.tracer_names:
            locs[name] = LOC_CCC
        self._locs = locs
        # bind AFTER the loc map exists: forcings evaluate coords and
        # field_dependencies at the forced field's staggering
        for _name, _F in self.forcing.items():
            if hasattr(_F, "bind"):
                _F.bind(_name, locs[_name] if _name in locs else LOC_CCC,
                        locs=locs)
        for name, loc in locs.items():
            self.bcs[name] = regularize_field_boundary_conditions(
                bcs_in.get(name), self.grid, loc)

        zeros = lambda: jnp.zeros(self.grid.padded_shape, self.grid.dtype)
        fields = {n: zeros() for n in self.prognostic_names}
        clock = dict(time=jnp.zeros((), self.grid.dtype),
                     iteration=jnp.zeros((), jnp.int32),
                     last_dt=jnp.full((), np.inf, self.grid.dtype))
        self.state = dict(fields=fields, clock=clock)
        self.architecture = architecture
        self._step = jax.jit(self._build_step(), donate_argnums=(0,))

    @property
    def prognostic_names(self):
        return self._solution + self.tracer_names

    def loc(self, name):
        return self._locs[name]

    @property
    def time(self):
        return float(self.state["clock"]["time"])

    @property
    def datetime(self):
        """Calendar time = reference_datetime + model seconds (reference:
        clock.jl DateTime clocks); None without a reference_datetime."""
        from ..utils.dateclock import datetime_of
        return datetime_of(self.time, self.reference_datetime)

    @property
    def iteration(self):
        return int(self.state["clock"]["iteration"])

    def field(self, name):
        # refresh halos on access: the step fills halos at the start of
        # each stage, so between steps only the interiors are current
        data = fill_halo_regions(self.state["fields"][name], self.grid,
                                 self.loc(name), self.bcs[name],
                                 self.state["clock"]["time"])
        return Field(self.grid, self.loc(name), self.bcs[name],
                     data, _regularize=False)

    @property
    def fields(self):
        return {n: self.field(n) for n in self.prognostic_names}

    def set(self, **values):
        fields = dict(self.state["fields"])
        t = self.state["clock"]["time"]
        for name, value in values.items():
            data = set_on_padded(self.grid, self.loc(name), value)
            fields[name] = fill_halo_regions(data, self.grid, self.loc(name),
                                             self.bcs[name], t)
        self.state = {**self.state, "fields": fields}

    # -- physics --------------------------------------------------------------

    def _velocities(self, fields):
        if self.formulation == CONSERVATIVE:
            h = fields["h"]
            hx = ix_f(self.grid, h)
            hy = iy_f(self.grid, h)
            return fields["uh"] / hx, fields["vh"] / hy
        return fields[self._solution[0]], fields[self._solution[1]]

    def _transports(self, fields):
        if self.formulation == CONSERVATIVE:
            return fields["uh"], fields["vh"]
        h = fields["h"]
        return (fields["u"] * ix_f(self.grid, h),
                fields["v"] * iy_f(self.grid, h))

    def _compute_tendencies(self, fields, time):
        grid = self.grid
        g = self.g
        scheme = self.advection
        h = fields["h"]
        hB = self.bathymetry
        u, v = self._velocities(fields)
        uh, vh = self._transports(fields)
        G = {}

        if self.formulation == CONSERVATIVE:
            G.update(conservative_tendencies(
                grid, scheme, g, self.coriolis, hB, self.tracer_names,
                fields))
        else:
            # vector-invariant (reference: div_mom_u/v for
            # VectorInvariantFormulation reuses the SAME
            # horizontal_advection_U/V + bernoulli_head_U/V operators of
            # the VectorInvariant advection module, and Coriolis enters
            # via the generic x/y_f_cross_U on (u, v) — the old inline
            # form dropped rotation for every class except FPlane, used
            # an unweighted energy-conserving joint average while
            # claiming the enstrophy form, and carried dead scaffolding;
            # round-5 review findings)
            from ..advection.vector_invariant import VectorInvariant
            vi = (self.momentum_advection
                  if isinstance(getattr(self, "momentum_advection", None),
                                VectorInvariant) else VectorInvariant())
            h_u, h_v = vi._horizontal(grid, u, v)
            b_u, b_v = vi._bernoulli(grid, u, v)
            Gu = -(h_u + b_u) - ddx(grid, g * (h + hB), LOC_FCC)
            Gv = -(h_v + b_v) - ddy(grid, g * (h + hB), LOC_CFC)
            if self.coriolis is not None:
                w0 = jnp.zeros_like(u)
                Gu = Gu - self.coriolis.x_f_cross_U(grid, u, v, w0)
                Gv = Gv - self.coriolis.y_f_cross_U(grid, u, v, w0)
            G[self._solution[0]], G[self._solution[1]] = Gu, Gv

        if self.formulation != CONSERVATIVE:
            G["h"] = (-div_xy_ccc(grid, uh, vh) * grid.V(LOC_CCC)
                      / grid.Az(LOC_CCC))
            G.update(advective_tracer_tendencies(
                grid, scheme, uh, vh, self.tracer_names, fields))

        if self.closure is not None:
            aux = self.closure.compute_diffusivities(grid, dict(
                fields, u=u, v=v, w=jnp.zeros_like(u)), time)
            mt = self.closure.momentum_tendencies(
                grid, dict(fields, u=u, v=v, w=jnp.zeros_like(u)), aux)
            G[self._solution[0]] = G[self._solution[0]] + mt["u"]
            G[self._solution[1]] = G[self._solution[1]] + mt["v"]
            for name in self.tracer_names:
                G[name] = G[name] + self.closure.tracer_tendency(
                    grid, name, fields, aux)

        for name, F in self.forcing.items():
            G[name] = G[name] + (F(grid, fields, time) if callable(F) else F)
        locs = {n: self.loc(n) for n in fields}
        for name in G:
            G[name] = apply_flux_bcs(G[name], grid, self.loc(name),
                                     self.bcs[name], time, fields=fields,
                                     locs=locs)
        return G

    def _fill_all(self, fields, time):
        return {name: fill_halo_regions(data, self.grid, self.loc(name),
                                        self.bcs[name], time)
                for name, data in fields.items()}

    def _build_step(self):
        def step(state, dt):
            fields = state["fields"]
            clock = state["clock"]
            time = clock["time"]
            Gm = None
            for gamma, zeta in zip(RK3_GAMMAS, RK3_ZETAS):
                fields = self._fill_all(fields, time)
                G = self._compute_tendencies(fields, time)
                new = {}
                for name in fields:
                    inc = gamma * G[name]
                    if zeta != 0.0:
                        inc = inc + zeta * Gm[name]
                    new[name] = fields[name] + dt * inc
                fields = new
                Gm = G
                time = time + (gamma + zeta) * dt
            clock = dict(time=time, iteration=clock["iteration"] + 1,
                         last_dt=dt * jnp.ones_like(clock["last_dt"]))
            return dict(fields=fields, clock=clock)

        return step

    def time_step(self, dt):
        dt = jnp.asarray(dt, self.grid.dtype)
        self.state = self._step(self.state, dt)
        return self

    def __repr__(self):
        return (f"ShallowWaterModel(grid={self.grid!r}, "
                f"formulation={self.formulation})")
