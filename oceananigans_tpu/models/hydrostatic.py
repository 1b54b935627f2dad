"""HydrostaticFreeSurfaceModel: primitive equations with a free surface.

Reference semantics: src/Models/HydrostaticFreeSurfaceModels/ —
* struct + defaults (hydrostatic_free_surface_model.jl:37-64): prognostic
  u, v, tracers, η; w diagnosed from continuity
  (compute_w_from_continuity.jl:16-19); free surface Explicit / Implicit /
  SplitExplicit (by grid type).
* tendencies (hydrostatic_free_surface_tendency_kernel_functions.jl:27-140):
  vector-invariant momentum advection, Coriolis, ∂x pHY′ from the buoyancy
  integral (update_hydrostatic_pressure.jl), closures, forcing; no w equation.
* quasi-AB2 stepping (hydrostatic_free_surface_ab2_step.jl): explicit AB2 for
  u, v, tracers + implicit vertical diffusion + free-surface step + barotropic
  corrector.

Design: one jitted step; the split-explicit barotropic loop is a lax.scan
(models/free_surfaces.py); the hydrostatic pressure integral and w-from-
continuity are cumulative sums along the z (minor) axis — XLA lowers them to
efficient scans. The barotropic transports are re-initialized from ∫u dz each
step (the reference persists them across steps; the filtered average is
insensitive to this at O(Δt) — documented deviation)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..advection import Centered, WENO, div_Uc, div_Uu, div_Uv
from ..advection.vector_invariant import VectorInvariant
from ..boundary_conditions import (apply_flux_bcs, fill_halo_regions,
                                   regularize_field_boundary_conditions)
from ..boundary_conditions.fill_halos import _fill_axis
from ..fields import Field, set_on_padded
from ..grids.topology import BOUNDED, LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC
from ..operators.operators import ddx, ddy, div_xy_ccc, dx_c, dy_c, iz_f
from ..solvers.fft_poisson import poisson_eigenvalues, fft_along, ifft_along
from ..solvers.transforms import dct_forward, dct_inverse
from ..timesteppers import (QuasiAdamsBashforth2TimeStepper,
                            SplitRungeKutta3TimeStepper)
from .free_surfaces import (ExplicitFreeSurface, ImplicitFreeSurface,
                            SplitExplicitFreeSurface)
from .nonhydrostatic import implicit_vertical_diffusion, _vertical_spacings


def _dzc_interior(grid):
    """Interior Δz at centers: (n,) for 1D spacings, or the interior
    (Nx, Ny, n) block when the grid carries horizontally-varying effective
    Δz (PartialCellBottom shrinks bottom cells; immersed.py)."""
    h, n = grid.H[2], grid.N[2]
    dz = np.asarray(grid.dz(LOC_CCC), np.float64)
    if dz.ndim == 3 and (dz.shape[0] > 1 or dz.shape[1] > 1):
        sx, sy = grid.interior_slices[0], grid.interior_slices[1]
        return np.ascontiguousarray(
            np.broadcast_to(dz, grid.padded_shape)[sx, sy, h:h + n])
    return _vertical_spacings(grid)[0]

PROGNOSTIC_LOCS = {"u": LOC_FCC, "v": LOC_CFC}


def immersed_column_geometry(grid, dtype):
    """(H_fc, H_cf, fluid_int) on an ImmersedBoundaryGrid: per-column
    FLUID depths at (f,c)/(c,f) — land columns clamped away from 0/0 — and
    interior-z fluid masks at fcc/cfc/ccc (reference: column_depthᶠᶜᵃ on
    immersed grids, src/Models/HydrostaticFreeSurfaceModels/, +
    mask_immersed_field). Shared by the rectilinear/lat-lon model and the
    cubed-sphere panels."""
    import jax.numpy as _jnp
    h, n = grid.H[2], grid.N[2]
    Lz = grid.extent[2]
    dz3 = np.broadcast_to(np.asarray(grid.dz(LOC_CCC), float),
                          grid.padded_shape)

    def coldepth(solid):
        d = (dz3 * ~solid)[:, :, h:h + n].sum(2, keepdims=True)
        # wet BEFORE clamping: dry columns (land, and halo columns whose
        # mask slots are solid) must never receive 1/H-scaled increments —
        # the clamp exists only to keep the division finite, and anything
        # divided by it is garbage that must be gated out by `wet`
        return np.maximum(d, 1e-12 * abs(Lz)), d > 0.0

    H_fc, wet_fc = coldepth(grid.solid_fcc)
    H_cf, wet_cf = coldepth(grid.solid_cfc)
    sl = (slice(None), slice(None), slice(h, h + n))
    fluid_int = {
        LOC_FCC: _jnp.asarray((~grid.solid_fcc)[sl], dtype),
        LOC_CFC: _jnp.asarray((~grid.solid_cfc)[sl], dtype),
        LOC_CCC: _jnp.asarray((~grid.solid_ccc)[sl], dtype)}
    return H_fc, H_cf, fluid_int, wet_fc, wet_cf


def zstar_column_geometry(grid, dtype, H_fc, H_cf, immersed):
    """Per-staggering (fluid depth, wet-column mask) pairs for the z*
    scale factors σ = (H + η)/H; σ ≡ 1 on land columns (reference:
    column_depthᶜᶜᵃ/ᶠᶜᵃ/ᶜᶠᵃ in z_star_vertical_spacing.jl on immersed
    grids). Shared by the rectilinear/lat-lon model and the cubed-sphere
    panels."""
    import jax.numpy as _jnp
    Lz = grid.extent[2]
    if not immersed:
        return {loc: (abs(Lz), None) for loc in (LOC_CCC, LOC_FCC, LOC_CFC)}
    h, n = grid.H[2], grid.N[2]
    dz3 = np.broadcast_to(np.asarray(grid.dz(LOC_CCC), float),
                          grid.padded_shape)
    H_cc = (dz3 * ~grid.solid_ccc)[:, :, h:h + n].sum(2, keepdims=True)
    thresh = 1e-9 * abs(Lz)
    return {
        LOC_CCC: (_jnp.asarray(np.maximum(H_cc, thresh), dtype),
                  _jnp.asarray(H_cc > thresh)),
        LOC_FCC: (_jnp.asarray(np.asarray(H_fc), dtype),
                  _jnp.asarray(np.asarray(H_fc) > thresh)),
        LOC_CFC: (_jnp.asarray(np.asarray(H_cf), dtype),
                  _jnp.asarray(np.asarray(H_cf) > thresh))}


def ZCoordinate():
    """Reference vertical-coordinate marker (ZCoordinate/ZStarCoordinate,
    hydrostatic_free_surface_model.jl vertical_coordinate=)."""
    return "z"


def ZStarCoordinate():
    return "zstar"


class PrescribedVelocityFields:
    """Tracer-only mode: velocities are prescribed (constants or traceable
    callables of (x, y, z, t)) and NOT stepped (reference:
    prescribed_hydrostatic_velocity_fields.jl)."""

    def __init__(self, u=0.0, v=0.0, w=0.0):
        self.u, self.v, self.w = u, v, w

    def evaluate(self, grid, time):
        from ..grids.base import broadcastable_1d

        def ev(q, loc):
            if callable(q):
                coords = [broadcastable_1d(grid.coord_padded(ax, loc[ax]), ax)
                          for ax in range(3)]
                out = q(*coords, time)
                import jax.numpy as _jnp
                return _jnp.broadcast_to(_jnp.asarray(out, grid.dtype),
                                         grid.padded_shape)
            import jax.numpy as _jnp
            return _jnp.full(grid.padded_shape, q, grid.dtype)

        return (ev(self.u, LOC_FCC), ev(self.v, LOC_CFC),
                ev(self.w, LOC_CCF))


class HydrostaticFreeSurfaceModel:
    def __init__(self, grid, momentum_advection=None, tracer_advection=None,
                 free_surface=None, tracers=(), buoyancy=None, coriolis=None,
                 closure=None, forcing=None, boundary_conditions=None,
                 velocities=None, timestepper="QuasiAdamsBashforth2",
                 vertical_coordinate="z", reference_datetime=None,
                 biogeochemistry=None, auxiliary_fields=None):
        self.reference_datetime = reference_datetime
        if callable(vertical_coordinate):
            vertical_coordinate = vertical_coordinate()
        if vertical_coordinate not in ("z", "zstar"):
            raise ValueError(vertical_coordinate)
        self.vertical_coordinate = vertical_coordinate
        self.prescribed_velocities = (velocities if isinstance(
            velocities, PrescribedVelocityFields) else None)
        self.momentum_advection = (momentum_advection if momentum_advection
                                   is not None else VectorInvariant())
        # per-tracer schemes (reference: tracer_advection may be a
        # NamedTuple mapping tracer name -> scheme, e.g.
        # tracer_advection = (c=WENO(order=7), d=Centered(order=4));
        # tracer_advection.jl adapt_advection_order per field)
        if isinstance(tracer_advection, dict):
            self._tracer_advection_map = dict(tracer_advection)
            tracer_advection = self._tracer_advection_map.get(
                "default", Centered(2))
        else:
            self._tracer_advection_map = None
        self.tracer_advection = (tracer_advection if tracer_advection
                                 is not None else Centered(2))
        if free_surface is None:
            # reference default (hydrostatic_free_surface_model.jl:60-64):
            # ImplicitFreeSurface on an xy-regular RectilinearGrid, else
            # SplitExplicitFreeSurface(cfl=0.7) whose barotropic substep
            # count satisfies the gravity-wave CFL for any Δt (a fixed
            # substep count is unstable when Δt·√(gH)/Δx outruns it)
            from ..grids.rectilinear import RectilinearGrid
            xy_regular = (type(grid) is RectilinearGrid
                          and grid.regular(0) and grid.regular(1))
            free_surface = (ImplicitFreeSurface() if xy_regular
                            else SplitExplicitFreeSurface(cfl=0.7))
        self.free_surface = free_surface
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        if buoyancy is not None:
            for name in buoyancy.required_tracers:
                if name not in tracers:
                    tracers = tracers + (name,)
        if biogeochemistry is not None:
            # reference: Biogeochemistry.jl required_biogeochemical_tracers
            # apply to every model family, hydrostatic included
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
        self.biogeochemistry = biogeochemistry
        self.auxiliary_fields = dict(auxiliary_fields or {})
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
        if timestepper in ("QuasiAdamsBashforth2", "ab2", "qab2"):
            self.timestepper = QuasiAdamsBashforth2TimeStepper()
        elif timestepper in ("SplitRungeKutta3", "split_rk3"):
            self.timestepper = SplitRungeKutta3TimeStepper()
        elif hasattr(timestepper, "n_stages"):
            self.timestepper = timestepper
        else:
            raise ValueError(f"unknown timestepper {timestepper}")

        required = max(getattr(self.tracer_advection, "required_halo", 1),
                       getattr(self.momentum_advection, "required_halo", 1))
        for _sch in (self._tracer_advection_map or {}).values():
            required = max(required, getattr(_sch, "required_halo", 1))
        if closure is not None:
            required = max(required, getattr(closure, "required_halo", 1))
        halo = [max(h, required) if not grid.is_flat(i) else 0
                for i, h in enumerate(grid.H)]
        halo = tuple(halo)
        self.grid = grid.with_halo(halo)
        if not self.grid.is_bounded(2):
            raise ValueError("HydrostaticFreeSurfaceModel needs a Bounded "
                             "z direction")
        if hasattr(self.free_surface, "materialize"):
            self.free_surface.materialize(self.grid)

        # CATKE-family closures: derive the surface buoyancy flux from the
        # buoyancy tracer's top BC and install the surface TKE flux BC
        # −Cᵂu★u★³ − CᵂwΔ(w★Δ)³ derived from the momentum flux BCs
        # (reference: tke_top_boundary_condition.jl +
        # add_closure_specific_boundary_conditions, catke_equation.jl:98-140)
        self._substepped_tke = (closure is not None
                                and getattr(closure, "substepped_tke", False)
                                and self.prescribed_velocities is None)
        # the substepped turbulence tracers: ("e",) for CATKE, ("e", "eps")
        # for k-ε — advanced by closure.step_turbulence, not as ordinary
        # tracers
        self._substepped_names = (
            tuple(getattr(closure, "substepped_tracers", ("e",)))
            if self._substepped_tke else ())
        bcs_in = dict(boundary_conditions or {})
        if self._substepped_tke:
            bcs_in = self._install_tke_surface_flux(bcs_in)
        self.bcs = {}
        for name, loc in PROGNOSTIC_LOCS.items():
            self.bcs[name] = regularize_field_boundary_conditions(
                bcs_in.get(name), self.grid, loc)
        for name in self.tracer_names:
            self.bcs[name] = regularize_field_boundary_conditions(
                bcs_in.get(name), self.grid, LOC_CCC)
        self.bcs["w"] = regularize_field_boundary_conditions(
            None, self.grid, LOC_CCF)
        self.bcs["eta"] = regularize_field_boundary_conditions(
            bcs_in.get("eta"), self.grid, LOC_CCC)
        self.bcs["ph"] = regularize_field_boundary_conditions(
            None, self.grid, LOC_CCC)
        from ..closures.scalar_diffusivity import \
            validate_implicit_closure_z_bcs
        validate_implicit_closure_z_bcs(closure, self.bcs)

        shape = self.grid.padded_shape
        dtype = self.grid.dtype
        shape2d = (shape[0], shape[1], 1)
        zeros = lambda: jnp.zeros(shape, dtype)
        base_names = (() if self.prescribed_velocities is not None
                      else ("u", "v")) + self.tracer_names
        fields = {n: zeros() for n in base_names}
        fields["eta"] = jnp.zeros(shape2d, dtype)
        clock = dict(time=jnp.zeros((), dtype),
                     iteration=jnp.zeros((), jnp.int32),
                     last_dt=jnp.full((), np.inf, dtype))
        self.state = dict(fields=fields, clock=clock, w=zeros(),
                          Gm={n: zeros() for n in self.prognostic_3d})
        if isinstance(self.free_surface, SplitExplicitFreeSurface):
            # persistent barotropic transports (reference: the U/V fields of
            # SplitExplicitFreeSurface carried across steps — η,U,V ← the
            # filtered state at the end of each substepping,
            # _update_split_explicit_state!); initialized from ∫u dz on set()
            # (initialize_split_explicit_substepping.jl:15-27)
            self.state["barotropic"] = {"U": jnp.zeros(shape2d, dtype),
                                        "V": jnp.zeros(shape2d, dtype)}
        if vertical_coordinate == "zstar":
            # grid-motion rate ∂t_σ = -δh_U/H (enters the upwinded vector-
            # invariant divergence flux and w-from-continuity; reference:
            # Az_Δr_∂t_σ, _update_grid_vertical_velocity!)
            self.state["dt_sigma"] = jnp.zeros(shape2d, dtype)
            # the GRID's free surface: σ derives from this η, stepped with
            # the SAME AB2 discretization as the tracers from the barotropic
            # transport divergence δh_U, so the σ-weighted tracer update
            # telescopes exactly (uniform tracers stay uniform to machine
            # precision). Reference: z_star_vertical_spacing.jl
            # _ab2_update_grid_scaling! — "Note!!! This η is different than
            # the free surface coming from the barotropic step"; G_sigma is
            # the AB2 memory of δh_U (the reference's Gⁿ storage).
            self.state["eta_grid"] = jnp.zeros(shape2d, dtype)
            self.state["G_sigma"] = jnp.zeros(shape2d, dtype)

        # immersed boundaries: velocities/tracers masked in the solid, depth
        # integrals over the FLUID column, per-column depths in the
        # barotropic mode (reference: column_depthᶠᶜᵃ on immersed grids +
        # mask_immersed_field in update_hydrostatic_free_surface_model_state)
        from ..immersed import ImmersedBoundaryGrid
        self._immersed = isinstance(self.grid, ImmersedBoundaryGrid)

        # column depth (static z coordinate: H = depth of the water column;
        # reference column_depthᶠᶜᵃ — constant for ZCoordinate grids,
        # per-column fluid thickness on immersed grids)
        Lz = self.grid.extent[2]
        if self._immersed:
            # land columns clamped to avoid 0/0 in the barotropic corrector
            # (their velocities are masked to 0 anyway)
            self._H_fc, self._H_cf, self._fluid_int, wet_fc, wet_cf = \
                immersed_column_geometry(self.grid, dtype)
            self._wet_fc = jnp.asarray(wet_fc, dtype)
            self._wet_cf = jnp.asarray(wet_cf, dtype)
        else:
            self._H_fc = Lz
            self._H_cf = Lz
            self._wet_fc = self._wet_cf = None
        if vertical_coordinate == "zstar":
            self._zstar_geo = zstar_column_geometry(
                self.grid, dtype, self._H_fc, self._H_cf, self._immersed)

        # implicit free-surface solver selection (reference:
        # implicit_free_surface.jl:35-110 — :Default picks FFT on
        # horizontally-regular rectilinear grids with constant depth, else
        # the preconditioned conjugate-gradient solver,
        # pcg_implicit_free_surface_solver.jl)
        if isinstance(self.free_surface, ImplicitFreeSurface):
            from ..grids.rectilinear import RectilinearGrid
            base = getattr(self.grid, "underlying_grid", self.grid)
            fft_capable = (isinstance(base, RectilinearGrid)
                           and base.regular(0) and base.regular(1)
                           and not self._immersed)
            method = getattr(self.free_surface, "solver_method", "Default")
            if method in ("Default", None):
                method = ("FastFourierTransform" if fft_capable
                          else "PreconditionedConjugateGradient")
            if method == "HeptadiagonalIterativeSolver":
                # reference: matrix_implicit_free_surface_solver.jl assembles
                # the same 2D vertically-integrated Helmholtz operator as a
                # sparse heptadiagonal matrix for Krylov iteration. Sparse
                # assembly defeats XLA fusion; the matrix-free CG
                # applies the identical operator, so the method name maps
                # onto it (same operator, same Krylov family, no matrix).
                method = "PreconditionedConjugateGradient"
            if method == "FastFourierTransform" and not fft_capable:
                raise ValueError("the FFT implicit free-surface solver "
                                 "needs a horizontally-regular rectilinear "
                                 "grid with constant depth; use "
                                 "solver_method='PreconditionedConjugate"
                                 "Gradient'")
            self._ifs_method = method
            pc_capable = (isinstance(base, RectilinearGrid)
                          and base.regular(0) and base.regular(1))
            if method == "FastFourierTransform" or pc_capable:
                lam = np.zeros((1, 1, 1))
                self._fs_plan = []
                for axis in (0, 1):
                    topo = self.grid.topology[axis]
                    if self.grid.is_flat(axis):
                        continue
                    N, L = self.grid.N[axis], self.grid.extent[axis]
                    sh = [1, 1, 1]
                    sh[axis] = N
                    lam = lam + poisson_eigenvalues(N, L, topo).reshape(sh)
                    self._fs_plan.append(
                        (axis, "fft" if topo == "periodic" else "dct"))
                self._fs_lam = lam
            else:
                self._fs_plan = None
            if method == "PreconditionedConjugateGradient":
                # vertically-integrated lateral areas over the FLUID column
                # (reference: compute_vertically_integrated_lateral_areas!):
                # ∫ᶻAx = Δy·H at (f,c), ∫ᶻAy = Δx·H at (c,f)
                dy2 = np.broadcast_to(
                    np.asarray(self.grid.dy(LOC_FCC), float),
                    self.grid.padded_shape)[:, :, :1]
                dx2 = np.broadcast_to(
                    np.asarray(self.grid.dx(LOC_CFC), float),
                    self.grid.padded_shape)[:, :, :1]
                az2 = np.broadcast_to(
                    np.asarray(self.grid.Az(LOC_CCC), float),
                    self.grid.padded_shape)[:, :, :1]
                self._int_Ax = jnp.asarray(dy2 * np.asarray(self._H_fc),
                                           dtype)
                self._int_Ay = jnp.asarray(dx2 * np.asarray(self._H_cf),
                                           dtype)
                self._az2d = jnp.asarray(az2, dtype)
                self._pcg_precondition = pc_capable

        self._tendency_hooks = []
        self._state_hooks = []
        self._step = jax.jit(self._build_step())

    # -- properties -----------------------------------------------------------

    @property
    def prognostic_3d(self):
        if self.prescribed_velocities is not None:
            return self.tracer_names
        return ("u", "v") + self.tracer_names

    @property
    def prognostic_names(self):
        return self.prognostic_3d + ("eta",)

    def tracer_scheme(self, name):
        """The advection scheme for one tracer (reference: per-field
        tracer_advection NamedTuple)."""
        if self._tracer_advection_map is not None:
            return self._tracer_advection_map.get(name,
                                                  self.tracer_advection)
        return self.tracer_advection

    def loc(self, name):
        if name == "w":
            return LOC_CCF
        return PROGNOSTIC_LOCS.get(name, LOC_CCC)

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
        if name == "w":
            return Field(self.grid, LOC_CCF, self.bcs["w"], self.state["w"],
                         _regularize=False)
        if name in self.auxiliary_fields:
            return self.auxiliary_fields[name]
        return Field(self.grid, self.loc(name), self.bcs[name],
                     self.state["fields"][name], _regularize=False)

    @property
    def fields(self):
        out = {n: self.field(n) for n in self.prognostic_names}
        out["w"] = self.field("w")
        return out

    def set(self, intrinsic_velocities=False, **values):
        """Set prognostic fields. On OrthogonalSphericalShellGrid-family
        grids (rotated lat-lon, tripolar) ``u``/``v`` inputs are EXTRINSIC
        (geographic east/north) by default and are rotated into the grid's
        intrinsic coordinate system; pass ``intrinsic_velocities=True`` for
        grid-aligned components. As in the reference, the extrinsic path
        rotates the full horizontal vector: supplying only one of ``u``/``v``
        treats the other as zero and overwrites it (reference:
        set_hydrostatic_free_surface_model.jl:49-116 set_velocities! /
        set_from_extrinsic_velocities!)."""
        base = getattr(self.grid, "underlying_grid", self.grid)
        from ..grids.orthogonal_spherical_shell import (
            OrthogonalSphericalShellGrid, rotate_from_geographic)
        rotate = (isinstance(base, OrthogonalSphericalShellGrid)
                  and not intrinsic_velocities
                  and ("u" in values or "v" in values))
        if rotate:
            # the reference's set_from_extrinsic_velocities!: set at
            # centers, rotate extrinsic -> intrinsic, halo-fill, then
            # interpolate to the staggered velocity locations
            from ..operators.operators import ix_f, iy_f
            u_ccc = set_on_padded(self.grid, LOC_CCC, values.pop("u", 0.0))
            v_ccc = set_on_padded(self.grid, LOC_CCC, values.pop("v", 0.0))
            ui, vi = rotate_from_geographic(base, u_ccc, v_ccc)
            tnow = self.state["clock"]["time"]
            cbcs = self.bcs["ph"]
            if getattr(base, "zipper_north", False):
                # velocity components are ANTISYMMETRIC across the tripolar
                # fold even at centers; the tracer-signed (+1) zipper of the
                # pressure BCs would sign-flip them in the fold halos
                from ..boundary_conditions.boundary_condition import (
                    FieldBoundaryConditions, ZipperBoundaryCondition,
                    regularize_field_boundary_conditions)
                cbcs = regularize_field_boundary_conditions(
                    FieldBoundaryConditions(
                        north=ZipperBoundaryCondition(-1.0)),
                    self.grid, LOC_CCC)
            ui = fill_halo_regions(ui, self.grid, LOC_CCC, cbcs, tnow)
            vi = fill_halo_regions(vi, self.grid, LOC_CCC, cbcs, tnow)
            values["u"] = ix_f(self.grid, ui)   # ccc -> fcc
            values["v"] = iy_f(self.grid, vi)   # ccc -> cfc
        fields = dict(self.state["fields"])
        t = self.state["clock"]["time"]
        for name, value in values.items():
            if name == "eta":
                # accept 2D (Nx, Ny) or (Nx, Ny, 1) arrays for the surface
                # field (reference: set!(model, η=...) takes 2D data)
                if not callable(value) and not np.isscalar(value):
                    v2 = jnp.asarray(value)
                    if v2.ndim == 2:
                        v2 = v2[:, :, None]
                    if (v2.ndim == 3 and v2.shape[2] == 1
                            and self.grid.N[2] > 1
                            and v2.shape[:2] != self.grid.padded_shape[:2]):
                        v2 = jnp.broadcast_to(
                            v2, v2.shape[:2] + (self.grid.N[2],))
                    value = v2
                data = set_on_padded(self.grid, LOC_CCC, value)
                # take an INTERIOR z column (the low padded columns are
                # z-halo: zero for interior-shaped array input)
                kz = self.grid.H[2] if data.shape[2] > self.grid.H[2] else 0
                data = (data[:, :, kz:kz + 1] if data.shape[2] > 1 else data)
                fields["eta"] = self._fill_xy(data, LOC_CCC, self.bcs["eta"], t)
                continue
            data = set_on_padded(self.grid, self.loc(name), value)
            if self._immersed:
                # reference: set! → update_state! → mask_immersed_field!;
                # the stored state is solid-masked from the start
                data = self.grid.mask_immersed(data, self.loc(name))
            fields[name] = fill_halo_regions(data, self.grid, self.loc(name),
                                             self.bcs[name], t)
        self.state = {**self.state, "fields": fields}
        if "eta_grid" in self.state and "eta" in values:
            # the grid η starts from the same initial free surface
            # (reference: ηⁿ of the mutable grid initialized from η)
            self.state = {**self.state, "eta_grid": fields["eta"]}
        if ("barotropic" in self.state
                and ("u" in values or "v" in values or "eta" in values)):
            # re-initialize the barotropic mode from the velocity initial
            # condition (reference: initialize_free_surface!,
            # initialize_split_explicit_substepping.jl:15-27). On z* the
            # transports are MOVING-thickness integrals (σ·∫u dz, σ from
            # the just-mirrored grid η) — the static integral seeded a
            # one-time O(η/H·u) continuity mismatch that froze a
            # constancy error into the tracers on the first step
            U = self._depth_integral(fields["u"], LOC_FCC)
            V = self._depth_integral(fields["v"], LOC_CFC)
            if "eta_grid" in self.state:
                sig = self._sigma_fields(self.state["eta_grid"])
                U = U * sig[("f", "c")].astype(U.dtype)
                V = V * sig[("c", "f")].astype(V.dtype)
            U = self._fill_xy(U, LOC_FCC, self.bcs["u"], t)
            V = self._fill_xy(V, LOC_CFC, self.bcs["v"], t)
            self.state = {**self.state, "barotropic": {"U": U, "V": V}}

    # -- helpers --------------------------------------------------------------

    def _install_tke_surface_flux(self, bcs_in):
        """Derive CATKE's surface couplings from the user boundary
        conditions (reference: tke_top_boundary_condition.jl):

        * ``surface_buoyancy_flux`` Jᵇ from the buoyancy tracer's top flux
          BC (BuoyancyTracer: Jᵇ = J_b; SeawaterBuoyancy + linear EOS:
          Jᵇ = g(α J_T − β J_S)) unless user-supplied;
        * e's top flux BC: J = −Cᵂu★·u★³ − CᵂwΔ·max(Jᵇ,0)·Δz with
          u★ = (τx²+τy²)^¼ from the u/v top flux BCs."""
        from ..boundary_conditions.boundary_condition import (
            FLUX, BoundaryCondition, FieldBoundaryConditions)
        from ..buoyancy import BuoyancyTracer, SeawaterBuoyancy

        def top_flux(name):
            fb = bcs_in.get(name)
            bc = getattr(fb, "top", None) if fb is not None else None
            if bc is None or getattr(bc, "classification", None) != FLUX:
                return None
            cond = bc.condition
            deps = tuple(getattr(bc, "field_dependencies", ()))
            if deps and callable(cond):
                # carry the BC's field dependencies on the callable so the
                # closure coupling can evaluate them at the surface cell
                # (reference: continuous_boundary_function.jl
                # field_dependencies)
                def wrapped(x, y, t, *dep_vals, _c=cond):
                    return _c(x, y, t, *dep_vals)
                wrapped.field_dependencies = deps
                return wrapped
            return cond

        # a ClosureTuple exposes its substepped member as tke_member
        clo = getattr(self.closure, "tke_member", None) or self.closure

        if not hasattr(clo, "surface_buoyancy_flux"):
            # k-ε: derive the friction velocity u★ = (τx²+τy²)^¼ for the ε
            # Charnock roughness (reference: friction_velocity,
            # tke_top_boundary_condition.jl); surface e/ε fluxes have
            # Cᵂu★ = CᵂwΔ = 0 reference defaults, so no flux BC to install
            tau_x, tau_y = top_flux("u"), top_flux("v")
            if clo.friction_velocity is None and (tau_x is not None
                                                  or tau_y is not None):
                if callable(tau_x) or callable(tau_y):
                    def ustar_fn(x, y, t, _tx=tau_x, _ty=tau_y):
                        tx = _tx(x, y, t) if callable(_tx) else (_tx or 0.0)
                        ty = _ty(x, y, t) if callable(_ty) else (_ty or 0.0)
                        return (tx * tx + ty * ty) ** 0.25
                    clo.friction_velocity = ustar_fn
                else:
                    tx, ty = tau_x or 0.0, tau_y or 0.0
                    clo.friction_velocity = (tx * tx + ty * ty) ** 0.25
            return bcs_in

        if clo.surface_buoyancy_flux is None:
            buoy = clo.buoyancy or self.buoyancy
            Jb = None
            if isinstance(buoy, BuoyancyTracer):
                Jb = top_flux("b")
            elif isinstance(buoy, SeawaterBuoyancy) and hasattr(
                    buoy.eos, "alpha"):
                JT, JS = top_flux("T"), top_flux("S")
                if JT is not None or JS is not None:
                    g = buoy.g
                    al = buoy.eos.alpha
                    be = buoy.eos.beta

                    def Jb_fn(x, y, t, _JT=JT, _JS=JS):
                        jt = (_JT(x, y, t) if callable(_JT)
                              else (_JT or 0.0))
                        js = (_JS(x, y, t) if callable(_JS)
                              else (_JS or 0.0))
                        return g * (al * jt - be * js)

                    Jb = (g * (al * (JT or 0.0) - be * (JS or 0.0))
                          if not (callable(JT) or callable(JS)) else Jb_fn)
            if Jb is not None:
                clo.surface_buoyancy_flux = Jb

        # e's top flux unless the user set one
        fb_e = bcs_in.get("e")
        if fb_e is not None and getattr(fb_e, "top", None) is not None:
            return bcs_in
        tau_x, tau_y = top_flux("u"), top_flux("v")
        Jb = clo.surface_buoyancy_flux
        h, n = self.grid.H[2], self.grid.N[2]
        dz_top = float(np.asarray(np.broadcast_to(
            np.asarray(self.grid.dz(LOC_CCC), float),
            self.grid.padded_shape))[0, 0, h + n - 1])
        Cwu = clo.tke_equation.Cwu
        CwD = clo.tke_equation.CwD
        if tau_x is None and tau_y is None and Jb is None:
            return bcs_in

        def _deps(q):
            return (tuple(getattr(q, "field_dependencies", ()))
                    if callable(q) else ())

        e_deps = _deps(tau_x) + _deps(tau_y) + _deps(Jb)

        def e_top_flux(x, y, t, *dep_vals):
            k = [0]

            def ev(q):
                if q is None:
                    return 0.0
                if callable(q):
                    nd = len(_deps(q))
                    vals = dep_vals[k[0]:k[0] + nd]
                    k[0] += nd
                    return q(x, y, t, *vals)
                return q
            tx, ty = ev(tau_x), ev(tau_y)
            ustar = (tx * tx + ty * ty) ** 0.25
            wD3 = jnp.maximum(jnp.asarray(ev(Jb)), 0.0) * dz_top
            return -Cwu * ustar ** 3 - CwD * wD3

        top_bc = BoundaryCondition(FLUX, e_top_flux,
                                   field_dependencies=e_deps)
        if fb_e is None:
            bcs_in = dict(bcs_in)
            bcs_in["e"] = FieldBoundaryConditions(top=top_bc)
        else:
            fb = FieldBoundaryConditions(
                west=fb_e.west, east=fb_e.east, south=fb_e.south,
                north=fb_e.north, bottom=fb_e.bottom, top=top_bc,
                immersed=fb_e.immersed)
            bcs_in = dict(bcs_in)
            bcs_in["e"] = fb
        return bcs_in

    def _fill_xy(self, a, loc, bcs, time):
        """Horizontal-only halo fill (for 2D surface fields); zipper-aware."""
        from ..boundary_conditions.fill_halos import fill_halo_axes
        return fill_halo_axes(a, self.grid, loc, bcs, time, (0, 1))

    def _fill_all(self, fields, time):
        out = {}
        for name, data in fields.items():
            if name == "eta":
                out[name] = self._fill_xy(data, LOC_CCC, self.bcs["eta"], time)
            else:
                if self._immersed and name in self.prognostic_3d:
                    data = self.grid.mask_immersed(data, self.loc(name))
                out[name] = fill_halo_regions(
                    data, self.grid, self.loc(name), self.bcs[name], time)
        return out

    def _cum_matmul(self, d, tri):
        """z-scan as one (Nz, Nz) triangular matrix contraction instead of
        O(Nz) shifted adds (chosen on the original accelerator; not yet
        re-measured on the GPU). precision=HIGHEST keeps f32-exact
        accumulation (TF32 or bf16 passes would lose the small-increment
        sums)."""
        return jax.lax.dot_general(
            d, jnp.asarray(tri, d.dtype), (((2,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)

    def _w_from_continuity(self, u, v, dt_sigma=None, sigma=None):
        """Diagnose the (grid-relative) vertical velocity by integrating
        continuity upward from the bottom (reference:
        compute_w_from_continuity.jl:16-19). On a moving z* grid the
        grid-motion term enters: ω accumulates -Δr·∂t_σ per layer, and the
        horizontal divergence uses the MOVING (σ-scaled) face areas when
        ``sigma`` (the per-staggering σ dict) is given — required for the
        tracer flux divergence to telescope exactly with the σ update
        (reference: compute_w_from_continuity on the mutable grid +
        the Az·Δr·∂t_σ contribution of z_star_vertical_spacing.jl)."""
        grid = self.grid
        h, n = grid.H[2], grid.N[2]
        dzc = _dzc_interior(grid)
        sx, sy = grid.interior_slices[0], grid.interior_slices[1]
        if sigma is None:
            div_h = div_xy_ccc(grid, u, v)
            d = div_h[sx, sy, h:h + n] * jnp.asarray(dzc, div_h.dtype)
        else:
            from .zstar import ZStarGrid
            mg = ZStarGrid(grid, sigma)
            div_h = div_xy_ccc(mg, u, v)
            # div_h is per MOVING volume; × σΔr restores [δx+δy]/Az
            d = div_h[sx, sy, h:h + n] * jnp.asarray(dzc, div_h.dtype) \
                * sigma[("c", "c")][sx, sy].astype(div_h.dtype)
        if dt_sigma is not None:
            gm = dt_sigma[sx, sy] * jnp.asarray(dzc, div_h.dtype)
            if self._immersed:
                # the grid only moves over FLUID cells (σ ≡ 1 in the solid)
                gm = gm * self._fluid_int[LOC_CCC][sx, sy].astype(gm.dtype)
            d = d + gm
        if not hasattr(self, "_cumsum_tri"):
            self._cumsum_tri = np.tril(np.ones((n, n), np.float64), 0).T
        w_faces = -self._cum_matmul(d, self._cumsum_tri)  # faces 1..n
        w = jnp.zeros(grid.padded_shape, u.dtype)
        w = w.at[sx, sy, h + 1:h + n + 1].set(w_faces)
        return fill_halo_regions(w, grid, LOC_CCF, self.bcs["w"])

    def _hydrostatic_pressure(self, fields, time):
        """pHY′(z) = -∫_z^0 b dz′ at cell centers (reference:
        update_hydrostatic_pressure.jl)."""
        grid = self.grid
        if self.buoyancy is None:
            return None
        b = self.buoyancy.buoyancy_ccc(grid, fields)
        h, n = grid.H[2], grid.N[2]
        dzc = _dzc_interior(grid)
        sx, sy = grid.interior_slices[0], grid.interior_slices[1]
        b_int = b[sx, sy, h:h + n]
        # p[k] = -(b[k] dz[k]/2 + Σ_{k'>k} b[k'] dz[k'])  (centered integral)
        bdz = b_int * jnp.asarray(dzc, b.dtype)
        # one triangular contraction (see _cum_matmul):
        # M[k', k] = 1/2 at k'=k, 1 for k'>k
        if not hasattr(self, "_ph_tri"):
            self._ph_tri = (np.tril(np.ones((n, n), np.float64), -1)
                            + 0.5 * np.eye(n))
        p_int = -self._cum_matmul(bdz, self._ph_tri)
        p = jnp.zeros(grid.padded_shape, b.dtype)
        p = p.at[sx, sy, h:h + n].set(p_int)
        return self._fill_xy(p, LOC_CCC, self.bcs["ph"], time)

    def _mask_state(self, new):
        """Zero prognostic fields inside the topography at update time so the
        stored state is user-consistent (reference: mask_immersed_field! in
        update_state)."""
        if not self._immersed:
            return new
        for n in self.prognostic_3d:
            if n in new:
                new[n] = self.grid.mask_immersed(new[n], self.loc(n))
        return new

    def _mask_kz(self, kz):
        """Zero the implicit vertical diffusivity at faces adjacent to solid
        cells (no diffusive flux through the immersed bottom; solid rows
        decouple in the tridiagonal solve)."""
        if not self._immersed:
            return kz
        return kz * self.grid.fluid_mask(LOC_CCF, self.grid.dtype)

    def _depth_integral(self, q, loc):
        """∫ q dz over the fluid column as a padded 2D (…,1) array.
        PartialCellBottom grids carry horizontally-varying effective Δz
        (shrunken bottom cells), so the spacing may be 1D or 3D."""
        grid = self.grid
        h, n = grid.H[2], grid.N[2]
        dz = np.asarray(grid.dz(LOC_CCC), np.float64)
        if dz.ndim == 3 and (dz.shape[0] > 1 or dz.shape[1] > 1):
            dzc = jnp.asarray(
                np.broadcast_to(dz, grid.padded_shape)[:, :, h:h + n],
                q.dtype)
        else:
            dzc1, _ = _vertical_spacings(grid)
            dzc = jnp.asarray(dzc1, q.dtype)
        integrand = q[:, :, h:h + n] * dzc
        if self._immersed:
            integrand = integrand * self._fluid_int[tuple(loc)].astype(
                q.dtype)
        return jnp.sum(integrand, axis=2, keepdims=True)

    # -- tendencies -----------------------------------------------------------

    def _sigma_fields(self, eta):
        """σ at (c,c)/(f,c)/(c,f) from each staggering's fluid depth; land
        columns keep σ = 1 (reference: z_star_vertical_spacing.jl with
        column_depth at each staggering on immersed grids)."""
        from ..operators.operators import interp
        from .zstar import sigma_from_eta
        out = {}
        for loc, (H, wet) in self._zstar_geo.items():
            e = eta
            if loc[0] == "f":
                e = interp(self.grid, eta, 0, "f")
            elif loc[1] == "f":
                e = interp(self.grid, eta, 1, "f")
            out[(loc[0], loc[1])] = sigma_from_eta(self.grid, e, H, wet)
        return out

    def _barotropic_divergence(self, U, V):
        """δh_U = [δx(Δy U̅) + δy(Δx V̅)]/Az at ccc (padded 2D): the
        barotropic transport divergence that steps the grid η and defines
        ∂t_σ = -δh_U/H (reference: z_star_vertical_spacing.jl
        _update_grid_vertical_velocity! / _ab2_update_grid_scaling!)."""
        g = self.grid
        return (dx_c(g, g.dy(LOC_FCC) * U) + dy_c(g, g.dx(LOC_CFC) * V)) \
            / g.Az(LOC_CCC)

    def _grid_motion_rate(self, dhU):
        """∂t_σ = -δh_U/H over wet columns, 0 on land (reference:
        ifelse(hᶜᶜ == 0, 0, -δh_U/hᶜᶜ))."""
        H, wet = self._zstar_geo[LOC_CCC]
        r = -dhU / H
        if wet is not None:
            r = jnp.where(wet, r, jnp.zeros_like(r))
        return r

    def _moving_grid(self, fields):
        """The (possibly traced) grid used for metric-weighted physics:
        a σ-scaled proxy under the z* coordinate (reference:
        z_star_vertical_spacing.jl). σ derives from the GRID η
        (``eta_grid``, stepped from the barotropic transport divergence)
        when the caller provides it; the solver η is the fallback for
        direct tendency probes."""
        if self.vertical_coordinate != "zstar":
            return self.grid
        from .zstar import ZStarGrid
        eta = fields.get("eta_grid", fields["eta"])
        return ZStarGrid(self.grid, self._sigma_fields(eta))

    def _compute_tendencies(self, fields, w, time, dt_sigma=None,
                            aux_fields=None):
        grid = self._moving_grid(fields)
        u, v = fields["u"], fields["v"]
        G = {}

        if isinstance(self.momentum_advection, VectorInvariant):
            gm = None
            if dt_sigma is not None:
                # Az·Δr·∂t_σ at ccc (Δr = the static reference spacing)
                dzr = jnp.asarray(np.broadcast_to(
                    np.asarray(self.grid.dz(LOC_CCC)),
                    self.grid.padded_shape), u.dtype)
                gm = jnp.asarray(self.grid.Az(LOC_CCC), u.dtype) * dzr \
                    * dt_sigma
                if self._immersed:
                    # the grid only moves over FLUID cells
                    gm = gm * self.grid.fluid_mask(LOC_CCC, u.dtype)
            adv_u, adv_v = self.momentum_advection.momentum_tendencies(
                grid, u, v, w, grid_motion=gm,
                zeta=getattr(self, "_zeta_override", None))
        else:
            adv_u = div_Uu(grid, self.momentum_advection, u, v, w)
            adv_v = div_Uv(grid, self.momentum_advection, u, v, w)
        G["u"] = -adv_u
        G["v"] = -adv_v

        if self.coriolis is not None:
            G["u"] = G["u"] - self.coriolis.x_f_cross_U(grid, u, v, w)
            G["v"] = G["v"] - self.coriolis.y_f_cross_U(grid, u, v, w)

        ph = self._hydrostatic_pressure(fields, time)
        if ph is not None:
            G["u"] = G["u"] - ddx(grid, ph, LOC_FCC)
            G["v"] = G["v"] - ddy(grid, ph, LOC_CFC)

        if isinstance(self.free_surface, ExplicitFreeSurface):
            g = self.free_surface.g
            G["u"] = G["u"] - g * ddx(grid, fields["eta"], LOC_FCC)
            G["v"] = G["v"] - g * ddy(grid, fields["eta"], LOC_CFC)

        aux = {}
        if self.closure is not None:
            cf = dict(fields)
            cf["w"] = w
            aux = self.closure.compute_diffusivities(grid, cf, time)
            mt = self.closure.momentum_tendencies(grid, cf, aux)
            G["u"] = G["u"] + mt["u"]
            G["v"] = G["v"] + mt["v"]

        ut, vt, wt = u, v, w
        if self.closure is not None and getattr(
                self.closure, "has_eddy_velocities", False):
            # GM-advective skew form: eddy transport velocities advect the
            # tracers (reference: closure_auxiliary_velocity +
            # advective_skew_diffusion.jl)
            cf = dict(fields)
            cf["w"] = w
            ue, ve, we = self.closure.eddy_velocities(grid, cf)
            ut, vt, wt = u + ue, v + ve, w + we

        for name in self.tracer_names:
            Gc = -div_Uc(grid, self.tracer_scheme(name), ut, vt, wt,
                         fields[name])
            if self.closure is not None:
                cf = dict(fields)
                cf["w"] = w
                if name in self._substepped_names:
                    # substepped turbulence: the production/buoyancy-flux
                    # fast terms live inside closure.step_turbulence; the
                    # slow tendency keeps only advection + boundary fluxes
                    # (+ any NON-substepped tuple members' diffusion)
                    fn = getattr(self.closure,
                                 "tracer_tendency_excluding_tke", None)
                    if fn is not None:
                        Gc = Gc + fn(grid, name, cf, aux)
                else:
                    Gc = Gc + self.closure.tracer_tendency(grid, name, cf,
                                                           aux)
            if self.biogeochemistry is not None:
                # reactions + drift advection (reference: Biogeochemistry.jl
                # biogeochemical_transition + biogeochemical_drift_velocity)
                Gc = Gc + self.biogeochemistry.tracer_tendency(
                    grid, name, fields, time)
                drift = self.biogeochemistry.drift_velocity(name)
                if drift is not None:
                    du, dv, dw = [jnp.full(grid.padded_shape, q, grid.dtype)
                                  if np.isscalar(q) else q
                                  for q in drift]
                    Gc = Gc - div_Uc(grid, self.tracer_scheme(name),
                                     du, dv, dw, fields[name])
            G[name] = Gc

        ffields = {**fields, **aux_fields} if aux_fields else fields
        for name, F in self.forcing.items():
            G[name] = G[name] + (F(grid, ffields, time) if callable(F)
                                 else F)
        from ..boundary_conditions.fill_halos import (apply_immersed_flux_bcs,
                                                      immersed_diffusivity)
        locs = {n: self.loc(n) for n in fields}
        for name in list(G):
            G[name] = apply_flux_bcs(G[name], grid, self.loc(name),
                                     self.bcs[name], time, fields=fields,
                                     locs=locs)
            ibc = getattr(self.bcs[name], "immersed", None)
            if self._immersed and ibc is not None:
                G[name] = apply_immersed_flux_bcs(
                    G[name], grid, self.loc(name), ibc, time,
                    c=fields[name],
                    kappa=immersed_diffusivity(self.closure, name))
        # TendencyCallsite hooks (reference: callback.jl TendencyCallsite)
        for h in self._tendency_hooks:
            G = h(grid, fields, G, time)
        return G, aux

    # -- free surface steps ---------------------------------------------------

    def _step_free_surface_split_explicit(self, fields, ab2G, dt, time,
                                          barotropic, se_settings=None):
        """Substep the barotropic mode starting from the PERSISTED (η, U, V)
        state (reference: step_free_surface! keeps η,U,V across steps and
        resets only the filtered accumulators,
        initialize_split_explicit_substepping.jl:29-42)."""
        fs = self.free_surface
        grid = self.grid
        GU = self._depth_integral(ab2G["u"], LOC_FCC)
        GV = self._depth_integral(ab2G["v"], LOC_CFC)
        U0, V0 = barotropic["U"], barotropic["V"]
        fill_eta = lambda a: self._fill_xy(a, LOC_CCC, self.bcs["eta"], time)
        fill_U = lambda a: self._fill_xy(a, LOC_FCC, self.bcs["u"], time)
        fill_V = lambda a: self._fill_xy(a, LOC_CFC, self.bcs["v"], time)
        frac, weights = se_settings if se_settings is not None \
            else fs.settings(None)
        eta_f, U_f, V_f = fs.substep(
            grid, self._H_fc, self._H_cf, fields["eta"], U0, V0,
            GU, GV, dt, fill_eta, fill_U, fill_V, frac=frac, weights=weights)
        eta_f = fill_eta(eta_f)
        U_f = fill_U(U_f)
        V_f = fill_V(V_f)
        return eta_f, U_f, V_f

    def _barotropic_corrector(self, u, v, U_f, V_f, sigma=None):
        """Replace the depth mean of (u, v) with the filtered barotropic mode
        (reference: barotropic_split_explicit_corrector.jl). On immersed
        grids the increment is gated by the wet-column mask: dry columns
        (land, and halo columns whose mask slots are solid) carry the
        1e-12-clamped depth, and dividing a halo-filled transport by it
        would plant O(1e10) garbage in pad slots that the immersed mask
        does not cover (z-pad levels are not 'solid') — it then leaks into
        the interior through nonlinear stencils over days.

        On z* grids (``sigma`` given) the barotropic mode is the MOVING-
        thickness integral (reference: Δzᶠᶜᶜ on the mutable grid, and the
        moving column_depthᶠᶜᵃ divisor): σ is depth-uniform so
        ∫u σ dz = σ·∫u dz. This makes the corrected velocities carry
        exactly U̅ through the next step's σ-weighted fluxes."""
        Ustar = self._depth_integral(u, LOC_FCC)
        Vstar = self._depth_integral(v, LOC_CFC)
        H_fc, H_cf = self._H_fc, self._H_cf
        if sigma is not None:
            sfc = sigma[("f", "c")].astype(u.dtype)
            scf = sigma[("c", "f")].astype(v.dtype)
            Ustar, Vstar = Ustar * sfc, Vstar * scf
            H_fc, H_cf = H_fc * sfc, H_cf * scf
        du = (U_f - Ustar) / H_fc
        dv = (V_f - Vstar) / H_cf
        if self._wet_fc is not None:
            du = du * self._wet_fc
            dv = dv * self._wet_cf
        return u + du, v + dv

    def _implicit_free_surface_solve(self, eta_rhs, dt, H=None):
        """(1 + g H Δt² λ) η̂ = η̂* in transform space (reference:
        fft_based_implicit_free_surface_solver.jl). ``H`` overrides the
        column depth (a scalar — used when FFT preconditions the PCG solve
        on varying-depth grids)."""
        grid = self.grid
        sx, sy = grid.interior_slices[0], grid.interior_slices[1]
        b = eta_rhs[sx, sy, :]
        for axis, kind in self._fs_plan:
            b = fft_along(b, axis) if kind == "fft" \
                else dct_forward(b, axis)
        g = self.free_surface.g
        H = self._H_fc if H is None else H
        lam = jnp.asarray(self._fs_lam, eta_rhs.dtype)
        b = b / (1.0 + g * H * dt * dt * lam)
        for axis, kind in reversed(self._fs_plan):
            b = ifft_along(b, axis) if kind == "fft" \
                else dct_inverse(b, axis)
        if jnp.iscomplexobj(b):
            b = jnp.real(b)
        eta = jnp.zeros_like(eta_rhs)
        return eta.at[sx, sy, :].set(b.astype(eta_rhs.dtype))

    def _implicit_pcg_solve(self, eta_n, U, V, dt, time):
        """Matrix-free preconditioned CG for the implicit free surface on
        varying-depth / immersed / curvilinear grids (reference:
        pcg_implicit_free_surface_solver.jl:44-165):

            L(η) = δx(∫ᶻAx ∂x η) + δy(∫ᶻAy ∂y η) − Az η/(gΔt²)
            rhs  = (δx(Δy U★) + δy(Δx V★) − Az ηⁿ/Δt) / (gΔt)

        with ∫ᶻA the fluid-column-integrated lateral areas and U★,V★ the
        predictor barotropic transports. The FFT constant-depth solver
        preconditions on horizontally-regular rectilinear grids (reference:
        FFTImplicitFreeSurfaceSolver as preconditioner)."""
        from ..solvers.conjugate_gradient import conjugate_gradient
        grid = self.grid
        g = self.free_surface.g
        dtype = eta_n.dtype
        sx, sy = grid.interior_slices[0], grid.interior_slices[1]

        def m2(m):
            return jnp.asarray(np.broadcast_to(
                np.asarray(m, float), grid.padded_shape)[:, :, :1], dtype)

        dx_fc = m2(grid.dx(LOC_FCC))
        dy_cf = m2(grid.dy(LOC_CFC))
        dy_fc = m2(grid.dy(LOC_FCC))
        dx_cf = m2(grid.dx(LOC_CFC))
        fill = lambda a: self._fill_xy(a, LOC_CCC, self.bcs["eta"], time)
        shape2 = (grid.padded_shape[0], grid.padded_shape[1], 1)

        def embed(e_int):
            e = jnp.zeros(shape2, dtype)
            return e.at[sx, sy, :].set(e_int)

        from ..operators.operators import dx_f, dy_f

        def L(e_int):
            eta = fill(embed(e_int))
            fx = self._int_Ax * dx_f(grid, eta) / dx_fc
            fy = self._int_Ay * dy_f(grid, eta) / dy_cf
            lap = dx_c(grid, fx) + dy_c(grid, fy)
            out = lap - self._az2d * eta / (g * dt * dt)
            return out[sx, sy, :]

        rhs = ((dx_c(grid, dy_fc * U) + dy_c(grid, dx_cf * V)
                - self._az2d * eta_n / dt) / (g * dt))[sx, sy, :]

        precond = None
        if self._pcg_precondition:
            Lz = abs(self.grid.extent[2])
            az = self._az2d[sx, sy, :]

            def precond(r):
                # L ≈ −Az/(gΔt²)(1 − gH̄Δt²∇²) for constant depth H̄ = Lz:
                # invert with the FFT solver
                rr = embed(-(g * dt * dt) * r / az)
                return self._implicit_free_surface_solve(rr, dt, H=Lz)[
                    sx, sy, :]

        reltol = 1e-7 if dtype == jnp.float64 else 1e-5
        x, it, res = conjugate_gradient(
            L, rhs, x0=eta_n[sx, sy, :], preconditioner=precond,
            reltol=reltol, maxiter=grid.N[0] * grid.N[1])
        return embed(x)

    # -- the step -------------------------------------------------------------

    def _stage_free_surface(self, fields0, new, G_or_ab2G, sdt, time,
                            barotropic=None, se_settings=None, sigma=None):
        """Apply the configured free-surface treatment for one (sub)step of
        size sdt starting from fields0's eta; returns (new, barotropic').
        ``sigma``: z* scale factors at the stage's END (the corrector pins
        the moving-thickness integral)."""
        fs = self.free_surface
        if isinstance(fs, SplitExplicitFreeSurface):
            eta_f, U_f, V_f = self._step_free_surface_split_explicit(
                fields0, G_or_ab2G, sdt, time, barotropic, se_settings)
            u, v = self._barotropic_corrector(new["u"], new["v"], U_f, V_f,
                                              sigma=sigma)
            new.update(u=u, v=v)
            new["eta"] = eta_f
            return new, {"U": U_f, "V": V_f}
        U = self._depth_integral(new["u"], LOC_FCC)
        V = self._depth_integral(new["v"], LOC_CFC)
        if isinstance(fs, ExplicitFreeSurface):
            div = (dx_c(self.grid, self.grid.dy(LOC_FCC) * U)
                   + dy_c(self.grid, self.grid.dx(LOC_CFC) * V)) \
                / self.grid.Az(LOC_CCC)
            new["eta"] = fields0["eta"] - sdt * div
            return new, None
        if isinstance(fs, ImplicitFreeSurface):
            new = self._implicit_eta_step(fields0["eta"], new, U, V, sdt,
                                          time)
            return new, None
        raise ValueError(f"unknown free surface {fs}")

    def _implicit_eta_step(self, eta_n, new, U, V, sdt, time):
        """Backward-Euler free-surface step + barotropic velocity correction
        (reference: step_free_surface! for ImplicitFreeSurface +
        implicit_free_surface_step kernels)."""
        fs = self.free_surface
        if self._ifs_method == "FastFourierTransform":
            div = (dx_c(self.grid, self.grid.dy(LOC_FCC) * U)
                   + dy_c(self.grid, self.grid.dx(LOC_CFC) * V)) \
                / self.grid.Az(LOC_CCC)
            rhs = eta_n - sdt * div
            eta = self._implicit_free_surface_solve(rhs, sdt)
        else:
            eta = self._implicit_pcg_solve(eta_n, U, V, sdt, time)
        eta = self._fill_xy(eta, LOC_CCC, self.bcs["eta"], time)
        g = fs.g
        new["u"] = new["u"] - sdt * g * ddx(self.grid, eta, LOC_FCC)
        new["v"] = new["v"] - sdt * g * ddy(self.grid, eta, LOC_CFC)
        new["eta"] = eta
        return new

    def _prescribed_tracer_tendencies(self, fields, time):
        """Tracer tendencies in prescribed-velocity (tracer-only) mode.
        ``fields`` must have filled halos. Returns (G, aux, w)."""
        u, v, w = self.prescribed_velocities.evaluate(self.grid, time)
        G = {}
        aux = {}
        cf = dict(fields, u=u, v=v, w=w)
        if self.closure is not None:
            aux = self.closure.compute_diffusivities(self.grid, cf, time)
        ut, vt, wt = u, v, w
        if self.closure is not None and getattr(
                self.closure, "has_eddy_velocities", False):
            ue, ve, we = self.closure.eddy_velocities(self.grid, cf)
            ut, vt, wt = u + ue, v + ve, w + we
        for name in self.tracer_names:
            Gc = -div_Uc(self.grid, self.tracer_scheme(name), ut, vt,
                         wt, fields[name])
            if self.closure is not None:
                Gc = Gc + self.closure.tracer_tendency(
                    self.grid, name, cf, aux)
            G[name] = Gc
        for name, F in self.forcing.items():
            if name in G:
                G[name] = G[name] + (F(self.grid, fields, time)
                                     if callable(F) else F)
        locs = {n: self.loc(n) for n in fields}
        for name in list(G):
            G[name] = apply_flux_bcs(G[name], self.grid,
                                     self.loc(name), self.bcs[name],
                                     time, fields=fields, locs=locs)
        return G, aux, w

    def _build_step(self, se_settings=None, catke_substeps=1):
        if isinstance(self.timestepper, SplitRungeKutta3TimeStepper) \
                and self.prescribed_velocities is not None:
            # tracer-only RK3 averaging variant (reference:
            # split_hydrostatic_runge_kutta_3.jl over prescribed velocities)
            def step(state, dt):
                fields0 = state["fields"]
                clock = state["clock"]
                time = clock["time"]
                fields = fields0
                G = aux = w = None
                for beta in SplitRungeKutta3TimeStepper.betas:
                    sdt = dt / beta
                    ff = self._fill_all(fields, time)
                    G, aux, w = self._prescribed_tracer_tendencies(ff, time)
                    new = {name: fields0[name] + sdt * G[name]
                           for name in self.tracer_names}
                    new["eta"] = fields0["eta"]
                    new = self._mask_state(new)
                    if self.closure is not None:
                        kappas = self.closure.vertical_implicit_kappas(
                            self.grid, new, aux)
                        for name, kz in kappas.items():
                            if name in new and name != "eta":
                                new[name] = implicit_vertical_diffusion(
                                    self.grid, new[name],
                                    self._mask_kz(kz), sdt)
                    fields = new
                clock = dict(time=time + dt,
                             iteration=clock["iteration"] + 1,
                             last_dt=dt * jnp.ones_like(clock["last_dt"]))
                return dict(fields=fields, clock=clock, w=w, Gm=G)

            return step

        if isinstance(self.timestepper, SplitRungeKutta3TimeStepper):
            def step(state, dt):
                fields0 = state["fields"]
                clock = state["clock"]
                time = clock["time"]
                bt = state.get("barotropic")
                fields = fields0
                G = None
                zstar = self.vertical_coordinate == "zstar"
                substepped = getattr(self, "_substepped_names", ())
                if zstar:
                    # reference: cache_previous_fields! stores σ⁰c⁰ and the
                    # step-start grid η; every substep restarts from them
                    # (_euler_substep_tracer_field!, rk3_substep_grid!)
                    eta_g0 = self._fill_xy(state["eta_grid"], LOC_CCC,
                                           self.bcs["eta"], time)
                    sig0 = self._sigma_fields(eta_g0)
                    sc0 = {n: sig0[("c", "c")].astype(fields0[n].dtype)
                           * fields0[n] for n in self.tracer_names
                           if n not in substepped}
                    eta_g_stage, sig_stage = eta_g0, sig0
                    eta_g_new, dhU = eta_g0, None
                for beta in SplitRungeKutta3TimeStepper.betas:
                    sdt = dt / beta
                    ff = self._fill_all(fields, time)
                    if zstar:
                        if bt is not None:
                            Ubt = self._fill_xy(bt["U"], LOC_FCC,
                                                self.bcs["u"], time)
                            Vbt = self._fill_xy(bt["V"], LOC_CFC,
                                                self.bcs["v"], time)
                        else:
                            Ubt = self._fill_xy(
                                self._depth_integral(ff["u"], LOC_FCC)
                                * sig_stage[("f", "c")], LOC_FCC,
                                self.bcs["u"], time)
                            Vbt = self._fill_xy(
                                self._depth_integral(ff["v"], LOC_CFC)
                                * sig_stage[("c", "f")], LOC_CFC,
                                self.bcs["v"], time)
                        dhU = self._barotropic_divergence(Ubt, Vbt)
                        dt_sig = self._grid_motion_rate(dhU)
                        ff = dict(ff)
                        ff["eta_grid"] = eta_g_stage
                    else:
                        dt_sig, sig_stage = None, None
                    w = self._w_from_continuity(ff["u"], ff["v"],
                                                dt_sigma=dt_sig,
                                                sigma=sig_stage)
                    G, aux = self._compute_tendencies(
                        ff, w, time, dt_sigma=dt_sig,
                        aux_fields=state.get("aux"))
                    G = jax.lax.optimization_barrier(G)  # see QAB2 note
                    new = {n: fields0[n] + sdt * G[n]
                           for n in self.prognostic_3d}
                    sig_new = None
                    if zstar:
                        # grid-η substep from the step-start η (reference:
                        # _rk3_update_grid_scaling!: ηⁿ⁺¹ = ηⁿ⁻¹ - Δt δh_U)
                        eta_g_new = self._fill_xy(
                            eta_g0 - sdt * dhU, LOC_CCC, self.bcs["eta"],
                            time)
                        sig_new = self._sigma_fields(eta_g_new)
                        sc_new = sig_new[("c", "c")]
                        sig_g = sig_stage[("c", "c")]
                        for n in self.tracer_names:
                            if n not in substepped:
                                # (σ⁰c⁰ + Δt σ_stage G)/σ_new (reference:
                                # scale_by_stretching_factor! +
                                # _euler_substep_tracer_field!)
                                new[n] = (sc0[n] + sdt
                                          * sig_g.astype(G[n].dtype)
                                          * G[n]) \
                                    / sc_new.astype(G[n].dtype)
                    if self.closure is not None:
                        kappas = self.closure.vertical_implicit_kappas(
                            self.grid, new, aux)
                        dampings = {}
                        if self._substepped_tke:
                            for nm in self._substepped_names:
                                kappas.pop(nm, None)  # advance in step_turbulence
                        elif hasattr(self.closure,
                                     "vertical_implicit_damping"):
                            dampings = self.closure.vertical_implicit_damping(
                                self.grid, new, aux)
                        for name, kz in kappas.items():
                            if name in new:
                                new[name] = implicit_vertical_diffusion(
                                    self.grid, new[name],
                                    self._mask_kz(kz), sdt,
                                    damping=dampings.get(name))
                        if hasattr(self.closure, "clip_fields") \
                                and not self._substepped_tke:
                            new = self.closure.clip_fields(new)
                    new, bt = self._stage_free_surface(
                        fields0, new, G, sdt, time, barotropic=bt,
                        se_settings=se_settings, sigma=sig_new)
                    if zstar:
                        eta_g_stage, sig_stage = eta_g_new, sig_new
                    if self._substepped_tke:
                        # per-stage Euler turbulence step (reference:
                        # _euler_step_turbulent_kinetic_energy!,
                        # time_step_catke_equation.jl RK3 variant):
                        # χ = −1/2 makes the AB2 combination a forward
                        # Euler step of the stage tendency
                        fnew = dict(new)
                        fnew.update(
                            u=fill_halo_regions(new["u"], self.grid,
                                                LOC_FCC, self.bcs["u"],
                                                time),
                            v=fill_halo_regions(new["v"], self.grid,
                                                LOC_CFC, self.bcs["v"],
                                                time),
                            **{nm: fields0[nm]
                               for nm in self._substepped_names})
                        slow = {nm: G[nm] for nm in self._substepped_names}
                        upd, _ = self.closure.step_turbulence(
                            self.grid, ff, fnew, slow, slow, sdt,
                            -0.5, jnp.asarray(True), 1, time)
                        for nm, val in upd.items():
                            if self._immersed:
                                val = self.grid.mask_immersed(val, LOC_CCC)
                            new[nm] = val
                    fields = self._mask_state(new)
                uf = fill_halo_regions(fields["u"], self.grid, LOC_FCC,
                                       self.bcs["u"], time)
                vf = fill_halo_regions(fields["v"], self.grid, LOC_CFC,
                                       self.bcs["v"], time)
                dt_sigma_out = None
                if zstar:
                    if bt is not None:
                        Ub2 = self._fill_xy(bt["U"], LOC_FCC,
                                            self.bcs["u"], time)
                        Vb2 = self._fill_xy(bt["V"], LOC_CFC,
                                            self.bcs["v"], time)
                    else:
                        Ub2 = self._fill_xy(
                            self._depth_integral(uf, LOC_FCC)
                            * sig_stage[("f", "c")], LOC_FCC,
                            self.bcs["u"], time)
                        Vb2 = self._fill_xy(
                            self._depth_integral(vf, LOC_CFC)
                            * sig_stage[("c", "f")], LOC_CFC,
                            self.bcs["v"], time)
                    dt_sigma_out = self._grid_motion_rate(
                        self._barotropic_divergence(Ub2, Vb2))
                w_new = self._w_from_continuity(
                    uf, vf, dt_sigma=dt_sigma_out,
                    sigma=sig_stage if zstar else None)
                clock = dict(time=time + dt,
                             iteration=clock["iteration"] + 1,
                             last_dt=dt * jnp.ones_like(clock["last_dt"]))
                out = dict(fields=fields, clock=clock, w=w_new, Gm=G)
                if bt is not None:
                    out["barotropic"] = bt
                if zstar:
                    out["dt_sigma"] = dt_sigma_out
                    out["eta_grid"] = eta_g_new
                    out["G_sigma"] = dhU
                return out

            return step

        chi0 = self.timestepper.chi

        if self.prescribed_velocities is not None:
            # tracer-only mode (reference:
            # prescribed_hydrostatic_velocity_fields.jl)
            def step(state, dt):
                fields = state["fields"]
                clock = state["clock"]
                time = clock["time"]
                Gm = state["Gm"]
                euler = jnp.logical_or(clock["iteration"] == 0,
                                       clock["last_dt"] != dt)
                chi = jnp.where(euler, -0.5, chi0)
                not_euler = jnp.where(euler, 0.0, 1.0)
                fields = self._fill_all(fields, time)
                G, aux, w = self._prescribed_tracer_tendencies(fields, time)
                new = {name: fields[name] + dt * ((1.5 + chi) * G[name]
                       - (0.5 + chi) * Gm[name] * not_euler)
                       for name in self.tracer_names}
                new["eta"] = fields["eta"]
                new = self._mask_state(new)
                if self.closure is not None:
                    kappas = self.closure.vertical_implicit_kappas(
                        self.grid, new, aux)
                    for name, kz in kappas.items():
                        if name in new and name != "eta":
                            new[name] = implicit_vertical_diffusion(
                                self.grid, new[name],
                                self._mask_kz(kz), dt)
                clock = dict(time=time + dt,
                             iteration=clock["iteration"] + 1,
                             last_dt=dt * jnp.ones_like(clock["last_dt"]))
                return dict(fields=new, clock=clock, w=w, Gm=G)

            return step

        def step(state, dt):
            fields = state["fields"]
            clock = state["clock"]
            time = clock["time"]
            Gm = state["Gm"]

            euler = jnp.logical_or(clock["iteration"] == 0,
                                   clock["last_dt"] != dt)
            chi = jnp.where(euler, -0.5, chi0)
            not_euler = jnp.where(euler, 0.0, 1.0)

            fields = self._fill_all(fields, time)
            zstar = self.vertical_coordinate == "zstar"
            bt = state.get("barotropic")
            substepped = getattr(self, "_substepped_names", ())
            if zstar:
                # ∂t_σ and the grid-η step derive from the barotropic
                # transport divergence δh_U at tendency time — the
                # persisted filtered (U̅, V̅) under split-explicit, the
                # moving-thickness integral of u otherwise (reference:
                # barotropic_velocities / barotropic_U fallback in
                # z_star_vertical_spacing.jl)
                eta_g = self._fill_xy(state["eta_grid"], LOC_CCC,
                                      self.bcs["eta"], time)
                sig_n = self._sigma_fields(eta_g)
                sig_cc = sig_n[("c", "c")]
                if bt is not None:
                    Ubt = self._fill_xy(bt["U"], LOC_FCC, self.bcs["u"],
                                        time)
                    Vbt = self._fill_xy(bt["V"], LOC_CFC, self.bcs["v"],
                                        time)
                else:
                    Ubt = self._fill_xy(
                        self._depth_integral(fields["u"], LOC_FCC)
                        * sig_n[("f", "c")], LOC_FCC, self.bcs["u"], time)
                    Vbt = self._fill_xy(
                        self._depth_integral(fields["v"], LOC_CFC)
                        * sig_n[("c", "f")], LOC_CFC, self.bcs["v"], time)
                dhU = self._barotropic_divergence(Ubt, Vbt)
                dt_sigma_n = self._grid_motion_rate(dhU)
                fields = dict(fields)
                fields["eta_grid"] = eta_g
            else:
                sig_n = dt_sigma_n = None
            w = self._w_from_continuity(fields["u"], fields["v"],
                                        dt_sigma=dt_sigma_n, sigma=sig_n)
            G, aux = self._compute_tendencies(
                fields, w, time, dt_sigma=dt_sigma_n,
                aux_fields=state.get("aux"))
            if zstar:
                # scale tracer tendencies by σⁿ so the AB2 memory carries
                # σ-scaled tendencies at their own time levels (reference:
                # scale_by_stretching_factor!,
                # hydrostatic_free_surface_ab2_step.jl:23)
                for name in self.tracer_names:
                    if name not in substepped:
                        G[name] = G[name] * sig_cc.astype(G[name].dtype)

            ab2G = {name: (1.5 + chi) * G[name]
                    - (0.5 + chi) * Gm[name] * not_euler
                    for name in self.prognostic_3d}
            # ab2G feeds BOTH the 3D update and the barotropic depth
            # integrals; without a barrier XLA rematerializes the whole
            # (WENO-VI) tendency computation for the second consumer
            # (measured +20 ms at 512x256x32)
            ab2G = jax.lax.optimization_barrier(ab2G)

            new = {name: fields[name] + dt * ab2G[name]
                   for name in self.prognostic_3d}
            new = dict(new)
            sig_np1 = None
            if zstar:
                # grid-η AB2 step from δh_U with the SAME weights as the
                # tracer update; σⁿ⁺¹ then telescopes exactly with the
                # σ-scaled tracer tendencies (reference:
                # _ab2_update_grid_scaling!, z_star_vertical_spacing.jl)
                eta_g_new = eta_g - dt * ((1.5 + chi) * dhU
                                          - (0.5 + chi) * state["G_sigma"]
                                          * not_euler)
                eta_g_new = self._fill_xy(eta_g_new, LOC_CCC,
                                          self.bcs["eta"], time)
                sig_np1 = self._sigma_fields(eta_g_new)
                sig_np1_cc = sig_np1[("c", "c")]
                # conservative σ-weighted tracer update (reference:
                # _ab2_step_tracer_field!, hydrostatic_free_surface_ab2_step
                # .jl:116-130): θⁿ⁺¹ = (σⁿ θⁿ + Δt ∂t(σθ)) / σⁿ⁺¹
                for name in self.tracer_names:
                    if name not in substepped:
                        new[name] = (sig_cc.astype(fields[name].dtype)
                                     * fields[name] + dt * ab2G[name]) \
                            / sig_np1_cc.astype(fields[name].dtype)

            # implicit vertical diffusion
            if self.closure is not None:
                kappas = self.closure.vertical_implicit_kappas(
                    self.grid, new, aux)
                dampings = {}
                if self._substepped_tke:
                    # substepped tracers advance inside closure.
                    # step_turbulence below (per-substep diffusivity refresh
                    # + implicit dissipation)
                    for nm in self._substepped_names:
                        kappas.pop(nm, None)
                elif hasattr(self.closure, "vertical_implicit_damping"):
                    dampings = self.closure.vertical_implicit_damping(
                        self.grid, new, aux)
                for name, kz in kappas.items():
                    if name in new:
                        new[name] = implicit_vertical_diffusion(
                            self.grid, new[name], self._mask_kz(kz), dt,
                            damping=dampings.get(name))
                if hasattr(self.closure, "clip_fields") \
                        and not self._substepped_tke:
                    new = self.closure.clip_fields(new)

            fs = self.free_surface
            if isinstance(fs, SplitExplicitFreeSurface):
                # substepping starts from the PERSISTED barotropic (η, U, V)
                # state, forced by the AB2-weighted slow tendency
                eta_f, U_f, V_f = self._step_free_surface_split_explicit(
                    fields, ab2G, dt, time, bt, se_settings)
                u, v = self._barotropic_corrector(new["u"], new["v"],
                                                 U_f, V_f, sigma=sig_np1)
                new.update(u=u, v=v)
                new["eta"] = eta_f
                bt = {"U": U_f, "V": V_f}
            elif isinstance(fs, ExplicitFreeSurface):
                U = self._depth_integral(new["u"], LOC_FCC)
                V = self._depth_integral(new["v"], LOC_CFC)
                div = (dx_c(self.grid, self.grid.dy(LOC_FCC) * U)
                       + dy_c(self.grid, self.grid.dx(LOC_CFC) * V)) \
                    / self.grid.Az(LOC_CCC)
                new["eta"] = fields["eta"] - dt * div
            elif isinstance(fs, ImplicitFreeSurface):
                U = self._depth_integral(new["u"], LOC_FCC)
                V = self._depth_integral(new["v"], LOC_CFC)
                new = self._implicit_eta_step(fields["eta"], new, U, V, dt,
                                              time)
            else:
                raise ValueError(f"unknown free surface {fs}")

            new = self._mask_state(new)
            uf = fill_halo_regions(new["u"], self.grid, LOC_FCC,
                                   self.bcs["u"], time)
            vf = fill_halo_regions(new["v"], self.grid, LOC_CFC,
                                   self.bcs["v"], time)
            dt_sigma = None
            if zstar:
                # ∂t_σ for the NEXT step's diagnostics (the step itself
                # recomputes it from the persisted barotropic state)
                if isinstance(fs, SplitExplicitFreeSurface):
                    Ub2 = self._fill_xy(U_f, LOC_FCC, self.bcs["u"], time)
                    Vb2 = self._fill_xy(V_f, LOC_CFC, self.bcs["v"], time)
                else:
                    Ub2 = self._fill_xy(
                        self._depth_integral(uf, LOC_FCC)
                        * sig_np1[("f", "c")], LOC_FCC, self.bcs["u"], time)
                    Vb2 = self._fill_xy(
                        self._depth_integral(vf, LOC_CFC)
                        * sig_np1[("c", "f")], LOC_CFC, self.bcs["v"], time)
                dt_sigma = self._grid_motion_rate(
                    self._barotropic_divergence(Ub2, Vb2))
            if self._substepped_tke:
                # substepped turbulence equations with the updated
                # velocities as next_velocities (reference:
                # time_step_catke_equation.jl /
                # time_step_tke_dissipation_equations! run after ab2_step!)
                fnew = dict(new)
                fnew.update(u=uf, v=vf,
                            **{nm: fields[nm]
                               for nm in self._substepped_names})
                slow = {nm: G[nm] for nm in self._substepped_names}
                prev = {nm: Gm[nm] for nm in self._substepped_names}
                upd, Gm_t = self.closure.step_turbulence(
                    self.grid, fields, fnew, slow, prev, dt, chi0,
                    euler, catke_substeps, time)
                G = dict(G)
                for nm, val in upd.items():
                    if self._immersed:
                        val = self.grid.mask_immersed(val, LOC_CCC)
                    new[nm] = val
                    G[nm] = Gm_t[nm]
            w_new = self._w_from_continuity(uf, vf, dt_sigma=dt_sigma,
                                            sigma=sig_np1)
            clock = dict(time=time + dt, iteration=clock["iteration"] + 1,
                         last_dt=dt * jnp.ones_like(clock["last_dt"]))
            out = dict(fields=new, clock=clock, w=w_new, Gm=G)
            if bt is not None:
                out["barotropic"] = bt
            if zstar:
                out["dt_sigma"] = dt_sigma
                out["eta_grid"] = eta_g_new
                out["G_sigma"] = dhU
            return out

        return step

    def _step_for(self, dt):
        """The jitted step for a concrete Δt. Two substep counts depend on
        Δt: split-explicit FixedTimeStepSize (cfl-based barotropic
        substepping, reference: calculate_substeps) and the CATKE TKE
        substep count M = ceil(Δt/Δτ); the step is compiled (and cached)
        per distinct combination."""
        from .free_surfaces import FixedTimeStepSize
        fs = self.free_surface
        dyn_se = (isinstance(fs, SplitExplicitFreeSurface)
                  and isinstance(fs.substepping, FixedTimeStepSize))
        M = (self.closure.substeps_for(dt)
             if self._substepped_tke
             and self.closure.tke_time_step is not None else 1)
        if not dyn_se and M == 1:
            return self._step
        se = fs.settings(float(dt)) if dyn_se else None
        key = ((len(se[1]), se[0]) if se else None, M)
        if not hasattr(self, "_se_step_cache"):
            self._se_step_cache = {}
        if key not in self._se_step_cache:
            self._se_step_cache[key] = jax.jit(
                self._build_step(se_settings=se, catke_substeps=M))
        return self._se_step_cache[key]

    # class-level defaults: wrapper objects that borrow _compute_tendencies
    # without running __init__ (e.g. cubed-sphere panel physics) see no hooks
    _tendency_hooks = ()
    _state_hooks = ()

    def add_tendency_hook(self, fn):
        """Traced TendencyCallsite hook ``fn(grid, fields, G, time) -> G``
        (reference: Callback with TendencyCallsite, callback.jl); re-traces
        the step."""
        self._tendency_hooks.append(fn)
        self._step = jax.jit(self._build_step())
        self._se_step_cache = {}
        return fn

    def add_state_hook(self, fn):
        """Traced UpdateStateCallsite hook
        ``fn(grid, fields, time) -> dict-of-field-updates`` applied at the
        end of every step."""
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
        step = self._step_for(dt)
        dt = jnp.asarray(dt, self.grid.dtype)
        if self.auxiliary_fields:
            self.state = dict(self.state,
                              aux={n: self._aux_data(f) for n, f in
                                   self.auxiliary_fields.items()})
        self.state = step(self.state, dt)
        self._run_state_hooks()
        if self.biogeochemistry is not None:
            self.biogeochemistry.update_state(self)
        return self

    def __repr__(self):
        return (f"HydrostaticFreeSurfaceModel(grid={self.grid!r}, "
                f"free_surface={type(self.free_surface).__name__}, "
                f"tracers={self.tracer_names})")
