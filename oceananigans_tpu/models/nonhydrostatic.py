"""NonhydrostaticModel: incompressible Boussinesq LES/DNS with a 3D pressure
projection.

Reference semantics: src/Models/NonhydrostaticModels/ —
* constructor pipeline (nonhydrostatic_model.jl:115-244): validate → inflate
  halos for the advection/closure order → regularize BCs → build fields →
  choose pressure solver by grid regularity (NonhydrostaticModels.jl:25-60)
* tendencies (nonhydrostatic_tendency_kernel_functions.jl:70-103):
  G_u = -∇·(𝐯u) - f×U|_x + b ẑ|_x - ∂ⱼτ₁ⱼ + F_u, etc.
* pressure projection (pressure_correction.jl, solve_for_pressure.jl):
  solve ∇²p = ∇·u*/Δt, then u ← u* - Δt ∇p
* RK3 / quasi-AB2 stepping (src/TimeSteppers/) with per-substep projection.

Design: the model state is an immutable pytree of padded arrays
({u, v, w, tracers…, clock}); ALL configuration (grid, schemes, physics) is
closed over by ONE jitted ``step(state, dt)`` built at construction. There is
no mutable Clock, no per-side kernel launches, no host logic in the hot loop —
the whole RK3 step (tendencies + Poisson solve + projection ×3) is a single
XLA program. G⁻ storage only exists for AB2 (RK3's ζ¹=0 makes tendencies
step-local, so checkpoints are smaller than the reference's)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..advection import Centered, div_Uc, div_Uu, div_Uv, div_Uw
from ..boundary_conditions import (apply_flux_bcs, fill_halo_regions,
                                   regularize_field_boundary_conditions)
from ..fields import Field, set_on_padded
from ..grids.topology import LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC
from ..operators.operators import ddx, ddy, ddz, div_ccc
from ..solvers.fft_poisson import FFTPoissonSolver
from ..solvers.fourier_tridiagonal import FourierTridiagonalPoissonSolver
from ..solvers.tridiagonal import solve_batched_tridiagonal
from ..timesteppers import (RK3_GAMMAS, RK3_ZETAS,
                            QuasiAdamsBashforth2TimeStepper,
                            RungeKutta3TimeStepper)

PROGNOSTIC_LOCS = {"u": LOC_FCC, "v": LOC_CFC, "w": LOC_CCF}


def select_pressure_solver(grid, fill_p=None):
    """Reference: NonhydrostaticModels.jl:25-60 — FFT on fully-regular grids,
    Fourier-tridiagonal with one stretched (vertical) direction,
    FFT-preconditioned CG on immersed grids."""
    from ..immersed import ImmersedBoundaryGrid
    if isinstance(grid, ImmersedBoundaryGrid):
        from ..solvers.conjugate_gradient import make_immersed_poisson_solver
        under = grid.underlying_grid
        fft = FFTPoissonSolver(under) if under.all_regular else None
        return make_immersed_poisson_solver(grid, fill_p, fft)
    from ..grids.rectilinear import RectilinearGrid
    if not isinstance(grid, RectilinearGrid):
        # transform solvers require RECTILINEAR metrics — coordinate
        # regularity is not metric regularity (a uniform lat-lon grid has
        # Δx ∝ cos φ). The reference types its FFT/Fourier-tridiagonal
        # dispatch on the XY/XZ/YZRegularRG RECTILINEAR aliases and routes
        # everything else to ConjugateGradientPoissonSolver
        # (Solvers.jl:50, NonhydrostaticModels.jl:35-40); selecting the
        # eigenvalue solvers here produced dimensionally inconsistent
        # pressure on curvilinear grids (round-5 review finding)
        from ..solvers.fourier_tridiagonal import (
            make_variable_spacing_poisson_solver)
        return make_variable_spacing_poisson_solver(grid, fill_p)
    if grid.all_regular:
        return FFTPoissonSolver(grid)
    stretched = grid.stretched_axes
    if len(stretched) == 1 and grid.topology[stretched[0]] == "bounded":
        # one stretched direction (x, y, OR z — reference:
        # fourier_tridiagonal_poisson_solver.jl:23-25)
        return FourierTridiagonalPoissonSolver(grid,
                                               stretched_axis=stretched[0])
    # multiply-stretched: FFT-preconditioned CG fallback (the reference
    # routes these to its ConjugateGradientPoissonSolver)
    from ..solvers.fourier_tridiagonal import (
        make_variable_spacing_poisson_solver)
    return make_variable_spacing_poisson_solver(grid, fill_p)


class NonhydrostaticModel:
    def __init__(self, grid, advection=None, tracers=(), buoyancy=None,
                 coriolis=None, closure=None, forcing=None,
                 boundary_conditions=None, timestepper="RungeKutta3",
                 pressure_solver=None, background_fields=None,
                 stokes_drift=None, biogeochemistry=None, particles=None,
                 auxiliary_fields=None, z_compact="auto", architecture=None,
                 reference_datetime=None):
        from ..parallel.distributed import CPU as _CPU
        if isinstance(architecture, _CPU):
            architecture = None       # CPU()/GPU() markers = the default
        self.reference_datetime = reference_datetime
        if advection is None:
            advection = Centered(order=2)
        self.advection = advection
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        if buoyancy is not None:
            for name in buoyancy.required_tracers:
                if name not in tracers:
                    tracers = tracers + (name,)
        if biogeochemistry is not None:
            for name in biogeochemistry.required_tracers:
                if name not in tracers:
                    tracers = tracers + (name,)
        if isinstance(closure, (tuple, list)):
            # reference parity: closure tuples sum their fluxes
            # (src/TurbulenceClosures/closure_tuples.jl)
            from ..closures.scalar_diffusivity import ClosureTuple
            closure = ClosureTuple(*closure)
        if closure is not None:
            for name in getattr(closure, "required_tracers", ()):
                if name not in tracers:
                    tracers = tracers + (name,)
        self.tracer_names = tracers
        self.stokes_drift = stokes_drift
        self.biogeochemistry = biogeochemistry
        # user auxiliary fields (reference: model.auxiliary_fields — extra
        # Fields carried on the model, reachable via model.field/outputs and
        # mutable from host callbacks; NOT stepped)
        self.auxiliary_fields = dict(auxiliary_fields or {})
        self.particles = particles
        self.buoyancy = buoyancy
        self.coriolis = coriolis
        self.closure = closure
        # closures that consume a buoyancy formulation (SmagorinskyLilly,
        # CATKE, k-eps, RiBased, isopycnal/GM, ...) inherit the model's when
        # none was given at closure construction (reference parity: the
        # reference's closures always receive buoyancy from the model)
        _cls = getattr(closure, "closures", (closure,)) if closure else ()
        for _c in _cls:
            if hasattr(_c, "buoyancy") and _c.buoyancy is None:
                _c.buoyancy = buoyancy
        from ..forcings.forcings import regularize_forcing
        self.forcing = regularize_forcing(forcing)
        for _name, _F in self.forcing.items():
            if hasattr(_F, "bind"):
                _F.bind(_name, self.loc(_name), locs=PROGNOSTIC_LOCS)
        self.background_fields = dict(background_fields or {})

        # adapt the advection order to small grids, then inflate halos
        # (reference: nonhydrostatic_model.jl:179-184 + automatic_halo_sizing.jl)
        from ..advection.schemes import adapt_advection_order
        advection = adapt_advection_order(advection, grid)
        self.advection = advection
        required = getattr(advection, "required_halo", 1)
        if closure is not None:
            required = max(required, getattr(closure, "required_halo", 1))
        halo = [max(h, required) if not grid.is_flat(i) else 0
                for i, h in enumerate(grid.H)]
        # z-compact layout: drop the z halos entirely, so no array carries
        # z halo slots and no z halo fill runs. Boundary conditions along z
        # are applied inside the stencils (operators/shifts.py shift_zbc);
        # eligible only for the default (no-flux / no-penetration) z BCs
        # with no closure/forcing/etc. that would consume z halos. The
        # N[2] % 128 gate is inherited from the original accelerator's lane
        # width; whether compact beats padded on the GPU is not measured.
        self._z_compact = False
        if z_compact in (True, "auto"):
            from ..grids.topology import BOUNDED, PERIODIC
            bcs_probe = dict(boundary_conditions or {})
            default_zbcs = not any(
                getattr(b, s, None) is not None
                for b in bcs_probe.values() for s in ("bottom", "top"))
            eligible_zc = (
                getattr(grid, "all_regular", False)
                and not grid.is_flat(2)
                and grid.topology[2] == BOUNDED
                and grid.topology[0] in (PERIODIC,)
                and grid.topology[1] in (PERIODIC,)
                and grid.N[2] % 128 == 0
                and closure is None and not (forcing or {})
                and stokes_drift is None and biogeochemistry is None
                and particles is None and not (background_fields or {})
                and default_zbcs
                and getattr(advection, "bounds", None) is None)
            if eligible_zc:
                halo[2] = 0
                self._z_compact = True
            elif z_compact is True:
                raise ValueError("model configuration is not eligible for "
                                 "the z-compact layout")
        halo = tuple(halo)
        self.grid = grid.with_halo(halo)
        if self._z_compact:
            # w's bottom boundary face (z slot 0) is pinned to 0 after every
            # update (the fill would have done it in the padded layout)
            m = np.ones((1, 1, self.grid.padded_shape[2]), np.float32)
            m[..., 0] = 0.0
            self._w_face_mask = jnp.asarray(m, self.grid.dtype)

        if timestepper in ("RungeKutta3", "rk3"):
            self.timestepper = RungeKutta3TimeStepper()
        elif timestepper in ("QuasiAdamsBashforth2", "ab2", "qab2"):
            self.timestepper = QuasiAdamsBashforth2TimeStepper()
        elif hasattr(timestepper, "n_stages"):
            self.timestepper = timestepper
        else:
            raise ValueError(f"unknown timestepper {timestepper}")

        # boundary conditions
        bcs_in = dict(boundary_conditions or {})
        # BCs on closure diffusivity fields (reference: κₑ=(b=...)-style
        # entries — see _ClosureBase.diffusivity_boundary_conditions):
        # pop them out, regularize at centers, hand to the closure(s)
        diff_bcs = {}
        for key in ("nu_e", "kappa_e"):
            spec = bcs_in.pop(key, None)
            if spec is None:
                continue
            if isinstance(spec, dict):
                diff_bcs[key] = {
                    n: regularize_field_boundary_conditions(
                        b, self.grid, LOC_CCC) for n, b in spec.items()}
            else:
                diff_bcs[key] = regularize_field_boundary_conditions(
                    spec, self.grid, LOC_CCC)
        if diff_bcs:
            if self.closure is None:
                raise ValueError("diffusivity boundary conditions "
                                 f"({sorted(diff_bcs)}) need a closure")
            for _c in getattr(self.closure, "closures", (self.closure,)):
                _c.diffusivity_boundary_conditions = diff_bcs
        self.bcs = {}
        for name, loc in PROGNOSTIC_LOCS.items():
            self.bcs[name] = regularize_field_boundary_conditions(
                bcs_in.get(name), self.grid, loc)
        for name in self.tracer_names:
            self.bcs[name] = regularize_field_boundary_conditions(
                bcs_in.get(name), self.grid, LOC_CCC)
        self.bcs["p"] = regularize_field_boundary_conditions(
            None, self.grid, LOC_CCC)
        from ..closures.scalar_diffusivity import \
            validate_implicit_closure_z_bcs
        validate_implicit_closure_z_bcs(self.closure, self.bcs)

        from ..immersed import ImmersedBoundaryGrid
        self.immersed = isinstance(self.grid, ImmersedBoundaryGrid)
        if pressure_solver is None:
            fill_p = (lambda p: fill_halo_regions(p, self.grid, LOC_CCC,
                                                  self.bcs["p"]))
            pressure_solver = select_pressure_solver(self.grid, fill_p)
        self.pressure_solver = pressure_solver

        # state pytree
        shape = self.grid.padded_shape
        dtype = self.grid.dtype
        zeros = lambda: jnp.zeros(shape, dtype)
        fields = {n: zeros() for n in self.prognostic_names}
        # closure-owned state fields (e.g. the Lagrangian-averaged dynamic
        # Smagorinsky JLM/JMM): carried in the state, stepped by the closure
        self._closure_state = tuple(getattr(self.closure, "state_fields",
                                            ()) or ())
        for name in self._closure_state:
            fields[name] = zeros()
            self.bcs[name] = regularize_field_boundary_conditions(
                None, self.grid, LOC_CCC)
        clock = dict(time=jnp.zeros((), dtype),
                     iteration=jnp.zeros((), jnp.int32),
                     last_dt=jnp.full((), np.inf, dtype))
        self.state = dict(fields=fields, clock=clock, pressure=zeros())
        if self.timestepper.needs_previous_tendencies:
            self.state["Gm"] = {n: zeros()
                                for n in (self.prognostic_names
                                          + self._closure_state)}
        if self.particles is not None:
            self.state["particles"] = dict(self.particles.initial)

        self.architecture = architecture
        self._tendency_hooks = []
        self._state_hooks = []
        self._step = jax.jit(self._build_step())

    # -- basic properties -----------------------------------------------------

    @property
    def prognostic_names(self):
        return ("u", "v", "w") + self.tracer_names

    def loc(self, name):
        return PROGNOSTIC_LOCS.get(name, LOC_CCC)

    @property
    def clock(self):
        return {k: np.asarray(v) for k, v in self.state["clock"].items()}

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
        if name == "p":
            return Field(self.grid, LOC_CCC, self.bcs["p"],
                         self.state["pressure"], _regularize=False)
        if name in self.auxiliary_fields:
            return self.auxiliary_fields[name]
        return Field(self.grid, self.loc(name), self.bcs[name],
                     self.state["fields"][name], _regularize=False)

    @property
    def fields(self):
        return {n: self.field(n) for n in self.prognostic_names}

    @property
    def velocities(self):
        return {n: self.field(n) for n in ("u", "v", "w")}

    @property
    def tracers(self):
        return {n: self.field(n) for n in self.tracer_names}

    # -- setting initial conditions -------------------------------------------

    def set(self, enforce_incompressibility=True, **values):
        """Set prognostic fields from scalars/arrays/functions (reference:
        src/Models/set_model.jl; incompressibility projection applied like the
        reference's update_state+pressure correction on set!)."""
        fields = dict(self.state["fields"])
        t = self.state["clock"]["time"]
        for name, value in values.items():
            if name not in fields:
                raise ValueError(f"unknown prognostic field {name!r}")
            data = set_on_padded(self.grid, self.loc(name), value)
            fields[name] = fill_halo_regions(data, self.grid, self.loc(name),
                                             self.bcs[name], t)
        if enforce_incompressibility and any(k in values for k in "uvw"):
            u, v, w, p = self._project(fields["u"], fields["v"], fields["w"],
                                       jnp.asarray(1.0, self.grid.dtype), t)
            fields.update(u=u, v=v, w=w)
        self.state = {**self.state, "fields": fields}

    # -- step construction ----------------------------------------------------

    def _fill_all(self, fields, time, dt=None, skip=()):
        """``skip``: fields whose halos are already valid. NOTE: skipping
        velocity fills after a projection is NOT valid in general — the
        pressure gradient is undefined in the OUTERMOST halo ring (∂x p at
        slot 0 has no left neighbor), and high-order stencils consume that
        ring."""
        out = {}
        for name, data in fields.items():
            if name not in skip:
                if self.immersed:
                    # zero prognostic fields inside the topography before
                    # the halo fill (reference: mask_immersed_field! in
                    # update_nonhydrostatic_model_state.jl:23-25)
                    data = self.grid.mask_immersed(data, self.loc(name))
                data = fill_halo_regions(data, self.grid, self.loc(name),
                                         self.bcs[name], time, dt=dt)
            out[name] = data
        return out

    @property
    def _open_sides(self):
        """All OPEN boundaries on the boundary-normal velocities:
        (name, axis, is_left, has_scheme). Fluxes are measured through every
        open boundary; only scheme-carrying (PerturbationAdvection) ones
        receive the mass correction (reference: boundary_mass_fluxes.jl —
        needs_mass_flux_correction(::IOBC) = false)."""
        from ..boundary_conditions.boundary_condition import (
            OPEN, PerturbationAdvection)
        sides = []
        for name, axis in (("u", 0), ("v", 1), ("w", 2)):
            if self.grid.topology[axis] != "bounded":
                continue
            bcs = self.bcs[name]
            for bc, is_left in ((bcs.pair(axis)[0], True),
                                (bcs.pair(axis)[1], False)):
                if bc is not None and bc.classification == OPEN:
                    scheme = isinstance(getattr(bc, "scheme", None),
                                        PerturbationAdvection)
                    # zero-imposed (condition None, no scheme) boundaries
                    # carry no flux by construction
                    if scheme or bc.condition is not None:
                        sides.append((name, axis, is_left, scheme))
        return sides

    @property
    def _pa_open_sides(self):
        return [s for s in self._open_sides if s[3]]

    def _balance_open_mass(self, vel):
        """Enforce zero NET mass flux through scheme-carrying open boundaries
        by shifting their boundary-normal velocity uniformly (reference:
        enforce_open_boundary_mass_conservation!, boundary_mass_fluxes.jl:
        223-239) — required for Poisson solvability."""
        sides = self._open_sides
        if not any(s[3] for s in sides):
            return vel
        grid = self.grid
        areas = (grid.Ax(LOC_FCC), grid.Ay(LOC_CFC), grid.Az(LOC_CCF))
        ii = grid.interior_slices
        total_flux = 0.0
        total_area = 0.0
        planes = []
        for name, axis, is_left, scheme in sides:
            H, N = grid.H[axis], grid.N[axis]
            fidx = H if is_left else H + N
            sl = list(ii)
            sl[axis] = slice(fidx, fidx + 1)
            sl = tuple(sl)
            A = jnp.broadcast_to(jnp.asarray(areas[axis], grid.dtype),
                                 grid.padded_shape)[sl]
            flux = jnp.sum(vel[name][sl] * A)
            total_flux = total_flux + (flux if is_left else -flux)
            if scheme:
                total_area = total_area + jnp.sum(A)
                planes.append((name, sl, is_left))
        corr = total_flux / total_area
        out = dict(vel)
        for name, sl, is_left in planes:
            out[name] = out[name].at[sl].add(-corr if is_left else corr)
        return out

    def _background_arrays(self, time):
        """Evaluate every background entry at ``time`` into padded arrays
        (reference: src/Models/NonhydrostaticModels/background_fields.jl —
        backgrounds may be time-dependent functions)."""
        from ..background_fields import evaluate_background
        out = {}
        for name, bg in self.background_fields.items():
            loc = {"u": LOC_FCC, "v": LOC_CFC, "w": LOC_CCF}.get(name,
                                                                 LOC_CCC)
            out[name] = evaluate_background(self.grid, loc, bg, time)
        return out

    def _total_velocities(self, fields, time, bg=None):
        """Add background (mean-flow) velocities for advection (reference:
        src/Models/NonhydrostaticModels/background_fields.jl)."""
        u, v, w = fields["u"], fields["v"], fields["w"]
        if not self.background_fields:
            return u, v, w
        if bg is None:
            bg = self._background_arrays(time)
        return (u + bg["u"] if "u" in bg else u,
                v + bg["v"] if "v" in bg else v,
                w + bg["w"] if "w" in bg else w)

    def _compute_tendencies(self, fields, time, aux_fields=None):
        """The hot stencil assembly (reference:
        nonhydrostatic_tendency_kernel_functions.jl:70-103 and
        compute_nonhydrostatic_tendencies.jl:97-131)."""
        grid = self.grid
        u, v, w = fields["u"], fields["v"], fields["w"]
        bg = self._background_arrays(time) if self.background_fields else {}
        ua, va, wa = self._total_velocities(fields, time, bg)
        adv = self.advection

        zbc = ({"u": "even", "v": "even", "w": "odd_face", "c": "even"}
               if self._z_compact else None)
        G = {}
        if bg:
            # perturbation decomposition (reference:
            # nonhydrostatic_tendency_kernel_functions.jl:93-94): advect the
            # PERTURBATION by the total velocity, plus the cross term of the
            # perturbation advecting the background; the background's
            # self-advection is excluded (it satisfies its own balance)
            G["u"] = -div_Uu(grid, adv, ua, va, wa, zbc=zbc, advected=u)
            G["v"] = -div_Uv(grid, adv, ua, va, wa, zbc=zbc, advected=v)
            G["w"] = -div_Uw(grid, adv, ua, va, wa, zbc=zbc, advected=w)
            for comp, div in (("u", div_Uu), ("v", div_Uv), ("w", div_Uw)):
                if comp in bg:
                    G[comp] = G[comp] - div(grid, adv, u, v, w, zbc=zbc,
                                            advected=bg[comp])
        else:
            G["u"] = -div_Uu(grid, adv, ua, va, wa, zbc=zbc)
            G["v"] = -div_Uv(grid, adv, ua, va, wa, zbc=zbc)
            G["w"] = -div_Uw(grid, adv, ua, va, wa, zbc=zbc)

        if self.coriolis is not None:
            G["u"] = G["u"] - self.coriolis.x_f_cross_U(grid, u, v, w)
            G["v"] = G["v"] - self.coriolis.y_f_cross_U(grid, u, v, w)
            G["w"] = G["w"] - self.coriolis.z_f_cross_U(grid, u, v, w)

        if self.buoyancy is not None:
            # arbitrary gravity direction (reference: BuoyancyForce with
            # gravity_unit_vector; x_dot_g_bᶠᶜᶜ terms)
            for comp, getter in (("u", "x_buoyancy"), ("v", "y_buoyancy"),
                                 ("w", "z_buoyancy")):
                term = getattr(self.buoyancy, getter, lambda g, f: None)(
                    grid, fields)
                if term is not None:
                    G[comp] = G[comp] + term

        if self.stokes_drift is not None:
            # Craik-Leibovich vortex force + ∂t uˢ (reference:
            # src/StokesDrifts.jl tendency contributions)
            G["u"] = G["u"] + self.stokes_drift.x_tendency(grid, u, v, w, time)
            G["v"] = G["v"] + self.stokes_drift.y_tendency(grid, u, v, w, time)
            G["w"] = G["w"] + self.stokes_drift.z_tendency(grid, u, v, w, time)

        aux = {}
        if self.closure is not None:
            aux = self.closure.compute_diffusivities(grid, fields, time)
            mt = self.closure.momentum_tendencies(grid, fields, aux)
            for k in ("u", "v", "w"):
                G[k] = G[k] + mt[k]

        uat, vat, wat = ua, va, wa
        if self.closure is not None and getattr(
                self.closure, "has_eddy_velocities", False):
            # GM-advective skew form: eddy transport velocities advect the
            # tracers (reference: closure_auxiliary_velocity +
            # advective_skew_diffusion.jl)
            ue, ve, we = self.closure.eddy_velocities(grid, fields)
            uat, vat, wat = ua + ue, va + ve, wa + we

        for name in self.tracer_names:
            Gc = -div_Uc(grid, adv, uat, vat, wat, fields[name], zbc=zbc)
            if name in bg:
                # perturbation advecting the background tracer (reference:
                # nonhydrostatic_tendency_kernel_functions.jl:293)
                Gc = Gc - div_Uc(grid, adv, u, v, w, bg[name], zbc=zbc)
            if self.closure is not None:
                Gc = Gc + self.closure.tracer_tendency(grid, name, fields, aux)
            if self.biogeochemistry is not None:
                Gc = Gc + self.biogeochemistry.tracer_tendency(
                    grid, name, fields, time)
                drift = self.biogeochemistry.drift_velocity(name)
                if drift is not None:
                    du, dv, dw = [jnp.full(grid.padded_shape, q, grid.dtype)
                                  if np.isscalar(q) else q
                                  for q in drift]
                    Gc = Gc - div_Uc(grid, adv, du, dv, dw, fields[name])
            G[name] = Gc

        # user forcing (discrete form: F(grid, fields, time) -> padded
        # array); forcings additionally see the model's auxiliary fields
        # as dependencies (reference: model_fields includes
        # auxiliary_fields)
        ffields = {**fields, **aux_fields} if aux_fields else fields
        for name, F in self.forcing.items():
            G[name] = G[name] + (F(grid, ffields, time) if callable(F)
                                 else F)

        # closure-owned state fields advance via update_state_fields at the
        # end of the step, not through the tendency machinery
        for name in self._closure_state:
            G[name] = jnp.zeros_like(fields[name])

        # boundary flux divergences (reference: compute_flux_bc_tendencies!)
        from ..boundary_conditions.fill_halos import (apply_immersed_flux_bcs,
                                                      immersed_diffusivity)
        locs = {n: self.loc(n) for n in fields if n in G or n in
                ("u", "v", "w")}
        for name in G:
            G[name] = apply_flux_bcs(G[name], grid, self.loc(name),
                                     self.bcs[name], time, fields=fields,
                                     locs=locs)
            ibc = getattr(self.bcs[name], "immersed", None)
            if self.immersed and ibc is not None:
                G[name] = apply_immersed_flux_bcs(
                    G[name], grid, self.loc(name), ibc, time,
                    c=fields[name],
                    kappa=immersed_diffusivity(self.closure, name))
        # TendencyCallsite hooks (reference: callback.jl TendencyCallsite —
        # callbacks mutating Gⁿ before the step; here traced functions)
        for h in self._tendency_hooks:
            G = h(grid, fields, G, time)
        return G, aux

    def _project(self, u, v, w, dtt, time):
        """Pressure projection (reference: pressure_correction.jl:8-53,
        solve_for_pressure.jl:12-108)."""
        grid = self.grid
        if self.immersed:
            u = grid.mask_immersed(u, LOC_FCC)
            v = grid.mask_immersed(v, LOC_CFC)
            w = grid.mask_immersed(w, LOC_CCF)
        u = fill_halo_regions(u, grid, LOC_FCC, self.bcs["u"], time, dt=dtt)
        v = fill_halo_regions(v, grid, LOC_CFC, self.bcs["v"], time, dt=dtt)
        w = fill_halo_regions(w, grid, LOC_CCF, self.bcs["w"], time, dt=dtt)
        if self._pa_open_sides:
            vel = self._balance_open_mass(dict(u=u, v=v, w=w))
            u, v, w = vel["u"], vel["v"], vel["w"]
        rhs = grid.interior(div_ccc(grid, u, v, w)) / dtt
        p_int = self.pressure_solver.solve(rhs)
        p = jnp.zeros(grid.padded_shape, grid.dtype)
        p = p.at[grid.interior_slices].set(p_int)
        p = fill_halo_regions(p, grid, LOC_CCC, self.bcs["p"], time)
        u = u - dtt * ddx(grid, p, LOC_FCC)
        v = v - dtt * ddy(grid, p, LOC_CFC)
        w = w - dtt * ddz(grid, p, LOC_CCF)
        if self._z_compact:
            # re-pin w's bottom boundary face (∂z p is undefined there)
            w = w * self._w_face_mask
        if self.immersed:
            u = grid.mask_immersed(u, LOC_FCC)
            v = grid.mask_immersed(v, LOC_CFC)
            w = grid.mask_immersed(w, LOC_CCF)
        return u, v, w, p

    def _implicit_step(self, fields, aux, dtt):
        """Vertically-implicit diffusion solve per field (reference:
        vertically_implicit_diffusion_solver.jl: implicit_step!)."""
        if self.closure is None:
            return fields
        kappas = self.closure.vertical_implicit_kappas(self.grid, fields, aux)
        if not kappas:
            return fields
        dampings = {}
        if hasattr(self.closure, "vertical_implicit_damping"):
            dampings = self.closure.vertical_implicit_damping(
                self.grid, fields, aux)
        out = dict(fields)
        for name, kz in kappas.items():
            if name == "w":
                # face-located solve with Dirichlet walls (reference:
                # ivd_upper/lower_diagonal ::Face variants)
                if not self.grid.is_flat(2):
                    out[name] = implicit_vertical_diffusion_w(
                        self.grid, fields[name], kz, dtt)
                continue
            out[name] = implicit_vertical_diffusion(
                self.grid, fields[name], kz, dtt,
                damping=dampings.get(name))
        if hasattr(self.closure, "clip_fields"):
            out = self.closure.clip_fields(out)
        return out

    def _build_step(self):
        ts = self.timestepper

        if isinstance(ts, RungeKutta3TimeStepper):
            def step(state, dt):
                fields = state["fields"]
                clock = state["clock"]
                time = clock["time"]
                Gm = None
                p = state["pressure"]
                for gamma, zeta in zip(RK3_GAMMAS, RK3_ZETAS):
                    fields = self._fill_all(fields, time,
                                            dt=(gamma + zeta) * dt)
                    G, aux = self._compute_tendencies(fields, time, state.get("aux"))
                    stage_dt = (gamma + zeta) * dt
                    new = {}
                    for name in fields:
                        inc = gamma * G[name]
                        if zeta != 0.0:
                            inc = inc + zeta * Gm[name]
                        new[name] = fields[name] + dt * inc
                    if self._z_compact:
                        new["w"] = new["w"] * self._w_face_mask
                    new = self._implicit_step(new, aux, stage_dt)
                    u, v, w, p = self._project(new["u"], new["v"], new["w"],
                                               stage_dt, time)
                    new.update(u=u, v=v, w=w)
                    fields = new
                    Gm = G
                    time = time + stage_dt
                if self._closure_state:
                    ffin = self._fill_all(fields, time)
                    fields = dict(fields)
                    fields.update(self.closure.update_state_fields(
                        self.grid, ffin, dt, clock["iteration"]))
                clock = dict(time=time, iteration=clock["iteration"] + 1,
                             last_dt=dt * jnp.ones_like(clock["last_dt"]))
                out = dict(fields=fields, clock=clock, pressure=p)
                if self.particles is not None:
                    parts = self.particles.advect(
                        self.grid, fields["u"], fields["v"], fields["w"],
                        state["particles"], dt, fields=fields)
                    out["particles"] = self.particles.track(
                        self.grid, fields, parts)
                return out

            return step

        if isinstance(ts, QuasiAdamsBashforth2TimeStepper):
            chi0 = ts.chi

            def step(state, dt):
                fields = state["fields"]
                clock = state["clock"]
                time = clock["time"]
                Gm = state["Gm"]
                # Euler (χ = -1/2) on the first iteration or when Δt changes
                # (reference: quasi_adams_bashforth_2.jl:88-96)
                euler = jnp.logical_or(clock["iteration"] == 0,
                                       clock["last_dt"] != dt)
                chi = jnp.where(euler, -0.5, chi0)
                not_euler = jnp.where(euler, 0.0, 1.0)
                fields = self._fill_all(fields, time, dt=dt)
                G, aux = self._compute_tendencies(fields, time, state.get("aux"))
                new = {}
                for name in fields:
                    inc = (1.5 + chi) * G[name] \
                        - (0.5 + chi) * Gm[name] * not_euler
                    new[name] = fields[name] + dt * inc
                if self._z_compact:
                    new["w"] = new["w"] * self._w_face_mask
                new = self._implicit_step(new, aux, dt)
                u, v, w, p = self._project(new["u"], new["v"], new["w"],
                                           dt, time)
                new.update(u=u, v=v, w=w)
                if self._closure_state:
                    ffin = self._fill_all(new, time)
                    new = dict(new)
                    new.update(self.closure.update_state_fields(
                        self.grid, ffin, dt, clock["iteration"]))
                clock = dict(time=time + dt, iteration=clock["iteration"] + 1,
                             last_dt=dt * jnp.ones_like(clock["last_dt"]))
                out = dict(fields=new, clock=clock, pressure=p, Gm=G)
                if self.particles is not None:
                    parts = self.particles.advect(
                        self.grid, new["u"], new["v"], new["w"],
                        state["particles"], dt, fields=new)
                    out["particles"] = self.particles.track(
                        self.grid, new, parts)
                return out

            return step

        raise ValueError(f"unsupported timestepper {ts}")

    # -- public stepping API --------------------------------------------------

    # class-level defaults: wrapper objects that borrow _compute_tendencies
    # without running __init__ (e.g. cubed-sphere panel physics) see no hooks
    _tendency_hooks = ()
    _state_hooks = ()

    def add_tendency_hook(self, fn):
        """Register a traced TendencyCallsite hook
        ``fn(grid, fields, G, time) -> G`` (reference: Callback with
        TendencyCallsite, callback.jl). Re-traces the step."""
        self._tendency_hooks.append(fn)
        self._step = jax.jit(self._build_step())
        return fn

    def add_state_hook(self, fn):
        """Register a traced UpdateStateCallsite hook
        ``fn(grid, fields, time) -> dict-of-field-updates`` applied at the
        end of every step (reference: Callback with UpdateStateCallsite)."""
        self._state_hooks.append(fn)
        self._apply_state_hooks = None
        return fn

    _apply_state_hooks = None

    def _run_state_hooks(self):
        if not self._state_hooks:
            return
        if self._apply_state_hooks is None:
            def apply(state):
                fields = dict(state["fields"])
                time = state["clock"]["time"]
                for h in self._state_hooks:
                    fields.update(h(self.grid, fields, time))
                return dict(state, fields=fields)
            self._apply_state_hooks = jax.jit(apply)
        self.state = self._apply_state_hooks(self.state)

    def _aux_data(self, f):
        # re-embed on the model grid when the field predates halo inflation
        if tuple(jnp.shape(f.data)) != tuple(self.grid.padded_shape):
            from ..fields.field import set_on_padded
            return set_on_padded(self.grid, f.loc, jnp.asarray(f.interior))
        return f.data

    def time_step(self, dt):
        """Advance the model state by one Δt (reference: time_step!)."""
        dt = jnp.asarray(dt, self.grid.dtype)
        if self.auxiliary_fields:
            # refresh the step's view of host-mutable auxiliary fields:
            # they ride in as plain step inputs, so a callback mutating one
            # changes the NEXT step without re-tracing
            self.state = dict(self.state,
                              aux={n: self._aux_data(f) for n, f in
                                   self.auxiliary_fields.items()})
        self.state = self._step(self.state, dt)
        self._run_state_hooks()
        if self.biogeochemistry is not None:
            # host-side hook (reference: update_biogeochemical_state!)
            self.biogeochemistry.update_state(self)
        return self

    def __repr__(self):
        return (f"NonhydrostaticModel(grid={self.grid!r}, "
                f"advection={self.advection!r}, tracers={self.tracer_names}, "
                f"timestepper={self.timestepper.name})")


def _vertical_spacings(grid):
    """Interior Δz at centers (n,) and at faces (n+1,), numpy."""
    h, n = grid.H[2], grid.N[2]
    npad = grid.padded_shape[2]
    dzc = np.broadcast_to(np.asarray(grid.dz(("c", "c", "c"))).reshape(-1),
                          (npad,))[h:h + n]
    dzf_all = np.broadcast_to(np.asarray(grid.dz(("c", "c", "f"))).reshape(-1),
                              (npad,))
    # face k of interior cell k sits at padded index h+k; the top face h+n is
    # stored in the first halo slot (uniform padded layout, grids/base.py)
    dzf = np.empty(n + 1)
    dzf[:n] = dzf_all[h:h + n]
    dzf[n] = dzf_all[h + n] if h + n < npad else dzf_all[-1]
    return dzc, dzf


def implicit_vertical_diffusion(grid, q, kappa, dtt, damping=None):
    """Solve (1 + Δt λ - Δt ∂z κ ∂z) q' = q on cell-centered z levels with
    no-flux walls (reference: vertically_implicit_diffusion_solver.jl:30-79).

    ``kappa`` is a scalar or a padded (c,c,f)-located 3D array (κ at the z-face
    below each cell). ``damping`` is an optional linear damping rate λ at cell
    centers (padded array) treated implicitly — used by CATKE-family closures
    for the TKE dissipation term (reference: time_step_catke_equation.jl
    implicit dissipation). The implicit operator drops the boundary-face
    fluxes (no-flux; Dirichlet/flux conditions enter explicitly via halo
    fills and apply_flux_bcs, as in the reference)."""
    from ..grids.topology import PERIODIC
    topo = getattr(grid, "topology", None)
    if topo is not None and topo[2] == PERIODIC and not grid.is_flat(2):
        raise ValueError("the vertically-implicit diffusion solve assumes "
                         "walls (no-flux rows at k=1, Nz); it cannot be "
                         "used on a z-periodic grid")
    h, n = grid.H[2], grid.N[2]
    dzc, dzf = _vertical_spacings(grid)

    inv_lo = np.zeros(n)            # couples q[k-1] via face k
    inv_up = np.zeros(n)            # couples q[k+1] via face k+1
    inv_lo[1:] = 1.0 / (dzc[1:] * dzf[1:n])
    inv_up[:-1] = 1.0 / (dzc[:-1] * dzf[1:n])

    dt_c = jnp.asarray(dtt, q.dtype)
    if hasattr(kappa, "ndim") and np.ndim(kappa) == 3:
        sx, sy, _ = grid.interior_slices
        kfaces = kappa[sx, sy, h:h + n + 1].astype(q.dtype)
        lo = -dt_c * jnp.asarray(inv_lo, q.dtype) * kfaces[..., :n]
        up = -dt_c * jnp.asarray(inv_up, q.dtype) * kfaces[..., 1:n + 1]
    else:
        lo = -dt_c * jnp.asarray(kappa * inv_lo, q.dtype)
        up = -dt_c * jnp.asarray(kappa * inv_up, q.dtype)
    diag = 1.0 - lo - up
    if damping is not None:
        lam = damping[grid.interior_slices] if jnp.ndim(damping) == 3 \
            else damping
        diag = diag + dtt * lam
    sol = solve_batched_tridiagonal(lo, diag, up, grid.interior(q))
    return q.at[grid.interior_slices].set(sol)


def implicit_vertical_diffusion_w(grid, w, nu, dtt):
    """Solve (1 - Δt ∂z ν ∂z) w' = w for the FACE-located vertical velocity
    (reference: vertically_implicit_diffusion_solver.jl — the (C,C,F)
    coefficient variants used by implicit_step! on w), with Dirichlet w = 0
    on both boundary faces (impenetrability at the walls).

    Stored faces are k = 0..n-1 (face 0 = bottom wall, pinned to 0; the lid
    face n is not stored and is identically 0 in the z-compact layout). ``nu`` is a scalar or a padded
    (c,c,c)-located 3D array (ν in the cell above face k)."""
    h, n = grid.H[2], grid.N[2]
    dzc, dzf = _vertical_spacings(grid)

    # face k couples w[k-1] through cell k-1 and w[k+1] through cell k
    inv_lo = np.zeros(n)            # ν_c[k-1]/(dzc[k-1]·dzf[k])
    inv_up = np.zeros(n)            # ν_c[k]  /(dzc[k]  ·dzf[k])
    inv_lo[1:] = 1.0 / (dzc[:-1] * dzf[1:n])
    inv_up[1:] = 1.0 / (dzc[1:] * dzf[1:n])

    dt_c = jnp.asarray(dtt, w.dtype)
    if hasattr(nu, "ndim") and np.ndim(nu) == 3:
        sx, sy, _ = grid.interior_slices
        nc = nu[sx, sy, h:h + n].astype(w.dtype)   # ν at centers 0..n-1
        lo_t = -dt_c * jnp.asarray(inv_lo, w.dtype) * jnp.concatenate(
            [jnp.zeros_like(nc[..., :1]), nc[..., :-1]], axis=-1)
        up_t = -dt_c * jnp.asarray(inv_up, w.dtype) * nc
    else:
        lo_t = -dt_c * jnp.asarray(nu * inv_lo, w.dtype)
        up_t = -dt_c * jnp.asarray(nu * inv_up, w.dtype)
    # Dirichlet walls: the couplings to the pinned faces w[0] = 0 and
    # w[n] = 0 stay in the diagonal but drop out of the off-diagonals
    diag = 1.0 - lo_t - up_t
    lo = jnp.where(_zmask(n, 1), 0.0, lo_t)          # row 1 couples face 0
    up = jnp.where(_zmask(n, n - 1), 0.0, up_t)      # row n-1 couples face n
    # row 0 = identity: the pinned boundary face passes through unchanged
    diag = jnp.where(_zmask(n, 0), 1.0, diag)
    lo = jnp.where(_zmask(n, 0), 0.0, lo)
    up = jnp.where(_zmask(n, 0), 0.0, up)
    sol = solve_batched_tridiagonal(lo, diag, up, grid.interior(w))
    return w.at[grid.interior_slices].set(sol)


def _zmask(n, k):
    m = np.zeros(n, bool)
    m[k] = True
    return jnp.asarray(m)
