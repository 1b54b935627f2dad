"""Hydrostatic primitive equations on the composed (6-panel) cubed sphere.

Reference analogue: the FULL HydrostaticFreeSurfaceModel running on a
MultiRegion ConformalCubedSphereGrid (src/MultiRegion/multi_region_models.jl:
34-46 — the reference runs the SAME model, with the whole advection/closure/
free-surface capability set, per region with connectivity-driven halo
exchange; src/MultiRegion/cubed_sphere_boundary_conditions.jl;
multi_region_split_explicit_free_surface.jl).

Composition: ONE stacked (6, NP, NP, ZP) array per field, panels
unrolled inside a single jitted step, static-gather inter-panel exchanges
between stages (grids/cubed_sphere.py). The physics per panel is the SAME
code path as the rectilinear/lat-lon model: each panel gets a
:class:`_PanelPhysics` adapter that borrows
``HydrostaticFreeSurfaceModel._compute_tendencies`` — so WENO /
WENOVectorInvariant momentum, any tracer advection scheme, every closure
(CATKE with substepped TKE, k-ε, GM/Redi triads and the advective skew form,
Smagorinsky family, scalar/biharmonic), buoyancy formulations, forcings and
top/bottom boundary conditions all work on the sphere exactly as they do on
the other grids (hydrostatic_free_surface_tendency_kernel_functions.jl:27-140
is evaluated once per panel).

Cubed-sphere-specific pieces kept out of the shared path:
* inter-panel halo exchange with staggered-component rotation
  (fill_cubed_sphere_velocity_halos) replacing fill_halo_regions in x/y;
  panels are FULLY_CONNECTED horizontally so advection keeps full order
  through panel edges;
* the valence-3 cube-vertex vorticity (dual-triangle circulation,
  cubed_sphere_shallow_water._vertex_zeta) injected into the shared
  VectorInvariant via its ``zeta=`` override;
* GridFittedBottom / PartialCellBottom bathymetry: per-panel
  ImmersedBoundaryGrids built from the bottom height evaluated on the
  exchanged (exact-halo) panel nodes, with fluid-column depths feeding the
  barotropic mode (reference: column_depthᶠᶜᵃ on immersed MultiRegion
  grids);
* the z* moving vertical coordinate (vertical_coordinate="zstar"):
  per-panel, per-staggering σ = (H + η)/H with fluid-column depths, the
  lagged Az·Δr·∂t_σ grid-motion terms, and the conservative σ-weighted
  tracer update — the same machinery as the lat-lon model
  (z_star_vertical_spacing.jl), run per panel;
* free surfaces on the composed sphere: explicit (forward-backward),
  backward-Euler implicit by matrix-free CG with the panel exchange inside
  the operator (pcg_implicit_free_surface_solver.jl), and split-explicit
  barotropic subcycling with Shchepetkin averaging and per-column depths
  (multi_region_split_explicit_free_surface.jl).

Stepping: quasi-AB2 with the χ correction (default for split-explicit /
substepped closures) or Wicker-Skamarock RK3.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..advection import Centered
from ..advection.vector_invariant import VectorInvariant
from ..boundary_conditions import regularize_field_boundary_conditions
from ..boundary_conditions.fill_halos import fill_halo_axes
from ..defaults import defaults
from ..grids.cubed_sphere import (ConformalCubedSphereGrid,
                                  fast_exchange, fill_cubed_sphere_halos,
                                  fill_cubed_sphere_velocity_halos,
                                  sync_shared_velocity_faces)
from ..grids.topology import LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC
from ..operators.operators import (ddx, ddy, div_xy_ccc, dx_c, dy_c,
                                   zeta3_ffc)
from .cubed_sphere_shallow_water import (CubedSphereShallowWaterModel,
                                         _vertex_corner_info,
                                         staggered_points_and_bases)
from .free_surfaces import (ExplicitFreeSurface, ImplicitFreeSurface,
                            SplitExplicitFreeSurface)
from .hydrostatic import (HydrostaticFreeSurfaceModel, PROGNOSTIC_LOCS,
                          immersed_column_geometry)
from .nonhydrostatic import implicit_vertical_diffusion, _vertical_spacings


def _dzc_all_columns(grid):
    """Interior Δz at centers over EVERY column: (n,) for 1D spacings, or
    the full padded (NPX, NPY, n) block when the grid carries
    horizontally-varying effective Δz (PartialCellBottom, immersed.py)."""
    h, n = grid.H[2], grid.N[2]
    dz = np.asarray(grid.dz(("c", "c", "c")), np.float64)
    if dz.ndim == 3 and (dz.shape[0] > 1 or dz.shape[1] > 1):
        return np.ascontiguousarray(
            np.broadcast_to(dz, grid.padded_shape)[:, :, h:h + n])
    return _vertical_spacings(grid)[0]


class _AllColumnsProxy:
    """Grid view whose 'interior' spans every (x, y) column but only the
    interior z window — lets the batched tridiagonal solve cover halo-slot
    columns (shared-edge faces) too."""

    def __init__(self, g):
        self._g = g
        self.H, self.N = g.H, g.N
        self.padded_shape = g.padded_shape

    def dz(self, loc):
        return self._g.dz(loc)

    def is_flat(self, axis):
        return self._g.is_flat(axis)

    @property
    def topology(self):
        return getattr(self._g, "topology", None)

    @property
    def interior_slices(self):
        h, n = self._g.H[2], self._g.N[2]
        return (slice(None), slice(None), slice(h, h + n))

    def interior(self, a):
        return a[self.interior_slices]


class _NamedBuoyancyTracer:
    """BuoyancyTracer semantics on a tracer with a custom name."""

    def __init__(self, name):
        self.name = name
        self.required_tracers = (name,)

    def _fp(self):
        return ("NamedBuoyancyTracer", self.name)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()

    def buoyancy_ccc(self, grid, tracers):
        return tracers[self.name]

    def z_buoyancy(self, grid, tracers):
        from ..operators.operators import iz_f
        return iz_f(grid, tracers[self.name])


class _PanelPhysics:
    """Per-panel adapter: the SAME tendency assembly as the
    rectilinear/lat-lon HydrostaticFreeSurfaceModel, evaluated on one
    exchanged-halo panel (the analogue of the reference launching its
    tendency kernels per MultiRegion region). Borrowed methods see a panel
    grid (possibly immersed-wrapped); only the two z-integral diagnostics
    are overridden to run over EVERY column — halo columns carry
    exchange-valid velocities/buoyancy, so their w and pHY′ come out valid
    without an extra exchange."""

    # shared code path (models/hydrostatic.py)
    _tendency_hooks = ()       # borrowed _compute_tendencies consults these
    biogeochemistry = None
    _tracer_advection_map = None
    tracer_scheme = HydrostaticFreeSurfaceModel.tracer_scheme
    _compute_tendencies = HydrostaticFreeSurfaceModel._compute_tendencies
    _moving_grid = HydrostaticFreeSurfaceModel._moving_grid
    _depth_integral = HydrostaticFreeSurfaceModel._depth_integral
    _cum_matmul = HydrostaticFreeSurfaceModel._cum_matmul
    _mask_state = HydrostaticFreeSurfaceModel._mask_state
    _mask_kz = HydrostaticFreeSurfaceModel._mask_kz
    _install_tke_surface_flux = \
        HydrostaticFreeSurfaceModel._install_tke_surface_flux
    _sigma_fields = HydrostaticFreeSurfaceModel._sigma_fields
    loc = HydrostaticFreeSurfaceModel.loc

    def __init__(self, parent, grid, bcs):
        self.parent = parent
        self.grid = grid                      # panel OSSG or ImmersedBoundaryGrid
        self.bcs = bcs
        self.vertical_coordinate = parent.vertical_coordinate
        self._zeta_override = None            # set per tendency call
        self.momentum_advection = parent.momentum_advection
        self.tracer_advection = parent.tracer_advection
        self.coriolis = parent.coriolis
        self.buoyancy = parent.buoyancy
        self.closure = parent.closure
        self.forcing = parent.forcing
        self.free_surface = parent._fs_for_tendencies
        self.tracer_names = parent.tracer_names
        self._substepped_names = parent._substepped_names
        self._substepped_tke = parent._substepped_tke
        from ..immersed import ImmersedBoundaryGrid
        self._immersed = isinstance(grid, ImmersedBoundaryGrid)
        dtype = grid.dtype
        if self._immersed:
            self._H_fc, self._H_cf, self._fluid_int, _, _ = \
                immersed_column_geometry(grid, dtype)
        else:
            self._H_fc = self._H_cf = abs(grid.extent[2])
        if self.vertical_coordinate == "zstar":
            from .hydrostatic import zstar_column_geometry
            self._zstar_geo = zstar_column_geometry(
                grid, dtype, self._H_fc, self._H_cf, self._immersed)
        self._proxy = _AllColumnsProxy(grid)

    # -- all-column diagnostics ------------------------------------------------

    def _w_from_continuity(self, u, v, dt_sigma=None, sigma=None):
        """w at (c,c,f) by the upward continuity integral over EVERY column
        (compute_w_from_continuity.jl); valid in all but the outermost halo
        ring because u, v are exchange-valid there. On a moving z* grid the
        grid-motion term -Δr·∂t_σ accumulates per layer and, when ``sigma``
        is given, the horizontal divergence uses the MOVING face areas
        (reference: Az_Δr_∂t_σ, z_star_vertical_spacing.jl; see the
        telescoping note in models/hydrostatic.py _w_from_continuity)."""
        grid = self.grid
        h, n = grid.H[2], grid.N[2]
        dzc = _dzc_all_columns(grid)
        if sigma is None:
            div_h = div_xy_ccc(grid, u, v)
            d = div_h[:, :, h:h + n] * jnp.asarray(dzc, div_h.dtype)
        else:
            from .zstar import ZStarGrid
            div_h = div_xy_ccc(ZStarGrid(grid, sigma), u, v)
            d = div_h[:, :, h:h + n] * jnp.asarray(dzc, div_h.dtype) \
                * sigma[("c", "c")].astype(div_h.dtype)
        if dt_sigma is not None:
            gm = dt_sigma * jnp.asarray(dzc, div_h.dtype)
            if self._immersed:
                gm = gm * self._fluid_int[LOC_CCC].astype(gm.dtype)
            d = d + gm
        w_faces = -self._cum_matmul(d, self.parent._cumsum_tri)
        w = jnp.zeros(grid.padded_shape, u.dtype)
        return w.at[:, :, h + 1:h + n + 1].set(w_faces)

    def _hydrostatic_pressure(self, fields, time):
        """pHY′ = -∫_z^0 b dz′ over EVERY column (halo-valid b in, halo-valid
        pHY′ out — no horizontal fill needed; update_hydrostatic_pressure.jl)."""
        grid = self.grid
        if self.buoyancy is None:
            return None
        b = self.buoyancy.buoyancy_ccc(grid, fields)
        h, n = grid.H[2], grid.N[2]
        dzc = _dzc_all_columns(grid)
        bdz = b[:, :, h:h + n] * jnp.asarray(dzc, b.dtype)
        p_int = -self._cum_matmul(bdz, self.parent._ph_tri)
        p = jnp.zeros(grid.padded_shape, b.dtype)
        return p.at[:, :, h:h + n].set(p_int)

    def implicit_step(self, st_panel, aux, sdt, dampings=None):
        """Vertically-implicit diffusion over every column (implicit_step!;
        the solve covers halo-slot columns so duplicated shared-edge faces
        diffuse identically on both panels)."""
        kappas = self.closure.vertical_implicit_kappas(self.grid, st_panel,
                                                       aux)
        for nm in self._substepped_names:
            kappas.pop(nm, None)
        out = dict(st_panel)
        for name, kz in kappas.items():
            if name in ("w", "eta") or name not in out:
                continue
            damp = (dampings or {}).get(name)
            out[name] = implicit_vertical_diffusion(
                self._proxy, out[name], self._mask_kz(kz), sdt, damping=damp)
        return out


def _as_free_surface(fs, gravity):
    """Normalize the ``free_surface`` argument: the legacy strings or the
    ExplicitFreeSurface/ImplicitFreeSurface/SplitExplicitFreeSurface
    objects (models/free_surfaces.py)."""
    if isinstance(fs, str):
        if fs == "explicit":
            return ExplicitFreeSurface(gravity)
        if fs == "implicit":
            return ImplicitFreeSurface(gravity)
        if fs == "split_explicit":
            return SplitExplicitFreeSurface(gravity)
        raise ValueError(fs)
    if isinstance(fs, (ExplicitFreeSurface, ImplicitFreeSurface,
                       SplitExplicitFreeSurface)):
        return fs
    raise ValueError(f"unknown free surface {fs!r}")


class CubedSphereHydrostaticModel:
    """The full HydrostaticFreeSurfaceModel capability set on a
    :class:`ConformalCubedSphereGrid` built with a z coordinate
    (reference: HydrostaticFreeSurfaceModel on a MultiRegion
    ConformalCubedSphereGrid, src/MultiRegion/multi_region_models.jl).

    state: ``u``/``v`` (staggered local components), tracers (centers),
    ``eta`` ((6, NP, NP, 1)); ``w`` diagnosed from continuity.

    Capabilities shared with the rectilinear/lat-lon model (same code):
    ``momentum_advection`` — any VectorInvariant (incl. WENOVectorInvariant;
    the grid halo must cover its ``required_halo``); ``tracer_advection`` —
    any scheme (WENO/UpwindBiased/Centered); ``closure`` — any closure or
    tuple (CATKE and k-ε substep their turbulence fields exactly as on other
    grids); ``buoyancy`` (default: BuoyancyTracer semantics on
    ``buoyancy_tracer``); ``boundary_conditions`` — top/bottom Flux BCs
    (wind stress, buoyancy fluxes; callables get the panel's true (λ°, φ°)
    nodes); ``bottom_height`` — bathymetry as a callable of (λ_rad, φ_rad)
    or per-panel array (wrapped as GridFittedBottom), or an explicit
    GridFittedBottom/PartialCellBottom instance; ``vertical_coordinate`` —
    "z" (static) or "zstar" (free-surface-following, AB2 only);
    ``forcing`` — discrete forcings.

    ``rotation_rate``: builds a HydrostaticSphericalCoriolis (exact f at the
    panel ffc nodes) unless ``coriolis`` is given."""

    def __init__(self, grid: ConformalCubedSphereGrid, tracers=("b",),
                 gravity=None, rotation_rate=0.0, momentum_advection=None,
                 tracer_advection=None, coriolis=None, buoyancy=None,
                 buoyancy_tracer="b", closure=None, forcing=None,
                 boundary_conditions=None, bottom_height=None,
                 free_surface="explicit", implicit_solver_tol=1e-8,
                 substeps=30, timestepper="WickerSkamarockRK3",
                 vertical_coordinate="z", reference_datetime=None,
                 batch_panels=None):
        if grid.panel_grids[0].is_flat(2):
            raise ValueError("CubedSphereHydrostaticModel needs a grid "
                             "built with z=(bottom, top)")
        if vertical_coordinate not in ("z", "zstar"):
            raise ValueError("vertical_coordinate must be 'z' or 'zstar'")
        # z* runs under BOTH steppers since round 5: the AB2 path uses the
        # _ab2_update_grid_scaling! form, the Wicker-Skamarock RK3 path the
        # rk3_substep_grid! form (σ⁰-weighted step-start tracers, grid-η
        # substepped from the step-start η) — reference:
        # z_star_vertical_spacing.jl / hydrostatic_free_surface_rk3_step.jl
        self.vertical_coordinate = vertical_coordinate
        self.reference_datetime = reference_datetime
        self.grid = grid
        self.gravity = float(gravity if gravity is not None
                             else defaults.gravitational_acceleration)
        self.rotation_rate = float(rotation_rate)

        # -- physics configuration (the shared-model surface) ----------------
        self.momentum_advection = (
            momentum_advection if momentum_advection is not None
            else VectorInvariant(vorticity_scheme="energy_conserving"))
        if not isinstance(self.momentum_advection, VectorInvariant):
            raise ValueError("cubed-sphere momentum advection must be a "
                             "VectorInvariant form (as in the reference's "
                             "hydrostatic model)")
        self.tracer_advection = (tracer_advection if tracer_advection
                                 is not None else Centered(2))
        if coriolis is None and rotation_rate:
            from ..coriolis import HydrostaticSphericalCoriolis
            coriolis = HydrostaticSphericalCoriolis(self.rotation_rate)
        self.coriolis = coriolis
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        if buoyancy is None and buoyancy_tracer is not None \
                and buoyancy_tracer in tracers:
            from ..buoyancy import BuoyancyTracer
            buoyancy = (BuoyancyTracer() if buoyancy_tracer == "b"
                        else _NamedBuoyancyTracer(buoyancy_tracer))
        self.buoyancy = buoyancy
        if isinstance(closure, (tuple, list)):
            # reference parity: closure tuples sum their fluxes
            # (src/TurbulenceClosures/closure_tuples.jl); wrap BEFORE the
            # attribute assignment so _PanelPhysics sees the ClosureTuple
            from ..closures.scalar_diffusivity import ClosureTuple
            closure = ClosureTuple(*closure)
        self.closure = closure
        if closure is not None:
            for name in getattr(closure, "required_tracers", ()):
                if name not in tracers:
                    tracers = tracers + (name,)
            _cls = getattr(closure, "closures", (closure,))
            for _c in _cls:
                if getattr(_c, "buoyancy", "missing") is None:
                    _c.buoyancy = buoyancy
        self.tracer_names = tracers
        from ..forcings.forcings import regularize_forcing
        self.forcing = regularize_forcing(forcing)
        from ..grids.topology import LOC_CCC, LOC_CFC, LOC_FCC
        _locs = {"u": LOC_FCC, "v": LOC_CFC}
        for _name, _F in self.forcing.items():
            if hasattr(_F, "bind"):
                _F.bind(_name, _locs.get(_name, LOC_CCC), locs=_locs)
        self._substepped_tke = (closure is not None and
                                getattr(closure, "substepped_tke", False))
        self._substepped_names = (
            tuple(getattr(closure, "substepped_tracers", ("e",)))
            if self._substepped_tke else ())

        # -- free surface ------------------------------------------------------
        self.free_surface = _as_free_surface(free_surface, self.gravity)
        self.implicit_solver_tol = float(implicit_solver_tol)
        if isinstance(self.free_surface, SplitExplicitFreeSurface):
            timestepper = "QuasiAdamsBashforth2"
            if free_surface == "split_explicit":   # legacy substeps= kwarg
                self.free_surface = SplitExplicitFreeSurface(
                    self.gravity, substeps=substeps)
            self.free_surface.materialize(grid.panel_grids[0])
        # the tendency assembly adds −g∇η for the explicit surface AND for
        # the implicit one: the CS implicit step solves the INCREMENT (θ=1)
        # form — u* must carry the explicit −g∇η⁰, then the CG solve finds
        # δ = η¹ − η⁰ and corrects by −gΔt∂δ (algebraically the same
        # backward-Euler as the reference's full-form PCG solve; for a
        # balanced state ∇·U* ≈ 0 ⇒ δ ≈ 0, no splitting noise). Only the
        # split-explicit surface excludes the gradient (it lives in the
        # barotropic subcycle).
        self._fs_for_tendencies = (
            ExplicitFreeSurface(self.gravity)
            if isinstance(self.free_surface, ImplicitFreeSurface)
            else self.free_surface)
        if self._substepped_tke:
            timestepper = "QuasiAdamsBashforth2"
        if timestepper not in ("WickerSkamarockRK3", "QuasiAdamsBashforth2"):
            raise ValueError(timestepper)
        self.timestepper = timestepper

        # -- halo capacity check -----------------------------------------------
        required = max(getattr(self.tracer_advection, "required_halo", 1),
                       getattr(self.momentum_advection, "required_halo", 1))
        if closure is not None:
            required = max(required, getattr(closure, "required_halo", 1))
        if grid.H[0] < required:
            raise ValueError(
                f"this configuration needs halo >= {required} but the grid "
                f"was built with halo={grid.H[0]}; pass halo={required} to "
                f"ConformalCubedSphereGrid")

        # -- per-panel grids (immersed-wrapped when bathymetry given) ---------
        H, N = grid.H[0], grid.N[0]
        NP = N + 2 * H
        ZP = grid.panel_grids[0].padded_shape[2]
        dtype = grid.dtype
        self._immersed = bottom_height is not None
        panel_grids = list(grid.panel_grids)
        if self._immersed:
            from ..immersed import (GridFittedBottom, ImmersedBoundaryGrid,
                                    PartialCellBottom)
            # bottom_height may be a bare height (callable of geographic
            # (lon_rad, lat_rad) or a (6, N, N) array) — wrapped as
            # GridFittedBottom — or an explicit GridFittedBottom /
            # PartialCellBottom instance whose own bottom_height is
            # interpreted the same way (reference: both immersed-boundary
            # types run under the MultiRegion cubed-sphere model,
            # multi_region_models.jl)
            ib_cls, ib_kw = GridFittedBottom, {}
            if isinstance(bottom_height, PartialCellBottom):
                ib_cls = PartialCellBottom
                ib_kw = {"minimum_fractional_cell_height":
                         bottom_height.epsilon}
                bottom_height = bottom_height.bottom_height
            elif isinstance(bottom_height, GridFittedBottom):
                bottom_height = bottom_height.bottom_height
            wrapped = []
            for p in range(6):
                g = grid.panel_grids[p]
                if callable(bottom_height):
                    lam, phi = g.nodes2d_padded(("c", "c"))
                    zb = np.asarray(bottom_height(np.deg2rad(lam),
                                                  np.deg2rad(phi)),
                                    np.float64)
                    zb = np.broadcast_to(zb, (NP, NP))
                else:
                    zb = np.asarray(bottom_height, np.float64)
                    if zb.shape[:3] == (6, N, N):
                        full = np.full((NP, NP), np.asarray(zb).min())
                        full[H:H + N, H:H + N] = zb[p].reshape(N, N)
                        zb = full
                    elif zb.shape[:3] == (6, NP, NP):
                        zb = zb[p].reshape(NP, NP)
                    else:
                        raise ValueError("bottom_height array must be "
                                         "(6, N, N) or (6, NP, NP)")
                wrapped.append(ImmersedBoundaryGrid(g, ib_cls(zb, **ib_kw)))
            panel_grids = wrapped

        # -- boundary conditions (per panel — conditions evaluate on the
        #    panel's true 2D nodes) -------------------------------------------
        bcs_in = dict(boundary_conditions or {})
        g0 = grid.panel_grids[0]
        # z-integral scan matrices shared by all panels
        nz = g0.N[2]
        self._cumsum_tri = np.tril(np.ones((nz, nz), np.float64), 0).T
        self._ph_tri = (np.tril(np.ones((nz, nz), np.float64), -1)
                        + 0.5 * np.eye(nz))
        # CATKE-family: derive surface TKE flux / buoyancy flux from the
        # user BCs (same machinery as the main model; dz is panel-independent
        # so the prototype adapter's grid stands in for all panels)
        self.panels = []
        proto_bcs = {}
        for name, loc in PROGNOSTIC_LOCS.items():
            proto_bcs[name] = regularize_field_boundary_conditions(
                bcs_in.get(name), panel_grids[0], loc)
        proto = _PanelPhysics.__new__(_PanelPhysics)
        proto.grid, proto.closure, proto.buoyancy = (panel_grids[0],
                                                     closure, buoyancy)
        proto._substepped_tke = self._substepped_tke
        if self._substepped_tke:
            bcs_in = HydrostaticFreeSurfaceModel._install_tke_surface_flux(
                proto, bcs_in)
        from ..closures.scalar_diffusivity import \
            validate_implicit_closure_z_bcs

        def panel_bcs(g):
            bcs = {}
            for name, loc in PROGNOSTIC_LOCS.items():
                bcs[name] = regularize_field_boundary_conditions(
                    bcs_in.get(name), g, loc)
            for name in self.tracer_names:
                bcs[name] = regularize_field_boundary_conditions(
                    bcs_in.get(name), g, LOC_CCC)
            bcs["w"] = regularize_field_boundary_conditions(None, g, LOC_CCF)
            bcs["eta"] = regularize_field_boundary_conditions(None, g,
                                                              LOC_CCC)
            return bcs

        for p in range(6):
            bcs = panel_bcs(panel_grids[p])
            if p == 0:
                validate_implicit_closure_z_bcs(closure, bcs)
            self.panels.append(_PanelPhysics(self, panel_grids[p], bcs))

        # -- panel-batched physics (default): the six panels concatenate
        #    along x into ONE grid, so every shared-path stage (tendencies,
        #    vertical implicit solves, CATKE substeps, barotropic subcycle)
        #    runs as single whole-array kernels instead of 6 launch-bound
        #    copies (grids/cubed_sphere.py ConcatPanelsGrid). batch_panels=
        #    False keeps the per-panel loop (CS_BATCH_PANELS=0/1 overrides).
        if batch_panels is None:
            import os
            env = os.environ.get("CS_BATCH_PANELS")
            batch_panels = env != "0"
        self._batch = bool(batch_panels)
        self._NPX = NP
        if self._batch:
            from ..grids.cubed_sphere import (build_concat_exchange_catform,
                                              concat_panels_grid)
            cat_grid = concat_panels_grid(panel_grids)
            self._catp = _PanelPhysics(self, cat_grid, panel_bcs(cat_grid))
            # concat-native exchange: inside the batched step every array
            # stays in the (6·npx, npy, npz) form, so XLA lays the whole
            # step out once — stacked<->concat reshapes are physical
            # relayout copies under the compiler's preferred tiling and
            # appear only at the step's entry/exit state conversion
            self._exc_cat, self._exuv_cat, self._sync_cat = \
                build_concat_exchange_catform(grid)

        # -- barotropic geometry -----------------------------------------------
        dzr = np.asarray(g0.dz(LOC_CCC)).reshape(-1)
        if dzr.size == 1:
            dzr = np.full(nz, dzr[0])
        elif dzr.size == ZP:
            dzr = dzr[g0.H[2]:g0.H[2] + nz]
        self._dz_c = jnp.asarray(dzr, dtype)
        # per-column fluid depths at (f,c)/(c,f), stacked over panels
        if self._immersed:
            self._H_fc = jnp.asarray(
                np.stack([np.asarray(pp._H_fc) for pp in self.panels]), dtype)
            self._H_cf = jnp.asarray(
                np.stack([np.asarray(pp._H_cf) for pp in self.panels]), dtype)
        else:
            Hd = float(np.sum(dzr))
            self._H_fc = Hd
            self._H_cf = Hd

        # -- state --------------------------------------------------------------
        shape3 = (6, NP, NP, ZP)
        self.state = {"u": jnp.zeros(shape3, dtype),
                      "v": jnp.zeros(shape3, dtype),
                      "eta": jnp.zeros((6, NP, NP, 1), dtype),
                      "time": jnp.zeros((), dtype),
                      "iteration": jnp.zeros((), jnp.int32)}
        for name in self.tracer_names:
            self.state[name] = jnp.zeros(shape3, dtype)
        if timestepper == "QuasiAdamsBashforth2":
            self.state["Gm"] = {n: jnp.zeros_like(self.state[n])
                                for n in ("u", "v") + self.tracer_names}
        if isinstance(self.free_surface, SplitExplicitFreeSurface):
            self.state["barotropic"] = {
                "U": jnp.zeros((6, NP, NP, 1), dtype),
                "V": jnp.zeros((6, NP, NP, 1), dtype)}
        if vertical_coordinate == "zstar":
            # grid-motion rate ∂t_σ = -δh_U/H at cell centers, per panel,
            # plus the GRID's free surface and its AB2 δh_U memory — the
            # z* consistency machinery of models/hydrostatic.py (reference:
            # z_star_vertical_spacing.jl _ab2_update_grid_scaling!)
            self.state["dt_sigma"] = jnp.zeros((6, NP, NP, 1), dtype)
            self.state["eta_grid"] = jnp.zeros((6, NP, NP, 1), dtype)
            self.state["G_sigma"] = jnp.zeros((6, NP, NP, 1), dtype)
        self._geom = staggered_points_and_bases(grid)
        self._corner_info = _vertex_corner_info(grid)
        if self._batch:
            self._vertex_fix = self._build_vertex_fix()
        # the exchange as single static gathers (bitwise == the per-panel
        # reference path; collapses the ~48-op .at[].set chains that made
        # 6-panel XLA graphs enormous — grids/cubed_sphere.py
        # build_fast_exchange)
        self._exc, self._exuv = fast_exchange(grid)
        self._batch_default = self._batch
        self._se_step_cache = {}
        self._step = self._jitted_step(self._batch)

    # -- initialization -------------------------------------------------------

    def set_geographic(self, h=None, u_east=None, v_north=None):
        """Initialize (u, v) from zonal/meridional velocity functions of
        geographic (lon_rad, lat_rad) — depth-independent (barotropic)
        profiles broadcast over the interior z levels."""
        CubedSphereShallowWaterModel.set_geographic(
            self, h=h, u_east=u_east, v_north=v_north)
        g0 = self.grid.panel_grids[0]
        hz, nz = g0.H[2], g0.N[2]
        ZP = g0.padded_shape[2]
        st = dict(self.state)
        for n in ("u", "v"):
            a = st[n]
            if a.shape[-1] != ZP:          # the SW setter wrote (…, 1)
                col = jnp.zeros((ZP,), a.dtype).at[hz:hz + nz].set(1.0)
                st[n] = a * col
        self.state = st
        self._post_set()

    def _post_set(self):
        st = dict(self.state)
        if self._immersed:
            if self._batch:
                cp = self._catp
                for n in ("u", "v") + self.tracer_names:
                    st[n] = self._s(cp.grid.mask_immersed(self._c(st[n]),
                                                          cp.loc(n)))
            else:
                for p in range(6):
                    g = self.panels[p].grid
                    for n in ("u", "v") + self.tracer_names:
                        st[n] = st[n].at[p].set(
                            g.mask_immersed(st[n][p], self.panels[p].loc(n)))
        if "Gm" in st:
            # replacing prognostics abandons the trajectory: restart AB2
            st["Gm"] = {n: jnp.zeros_like(v) for n, v in st["Gm"].items()}
            st["iteration"] = jnp.zeros((), jnp.int32)
        if "dt_sigma" in st:
            st["dt_sigma"] = jnp.zeros_like(st["dt_sigma"])
            st["eta_grid"] = st["eta"]
            st["G_sigma"] = jnp.zeros_like(st["G_sigma"])
        if "barotropic" in st:
            # (re)initialize the persistent barotropic transports from
            # ∫u dz (initialize_split_explicit_substepping.jl:15-27); on z*
            # the MOVING-thickness integral σ·∫u dz (σ from the grid η) —
            # the flat model's set() got the same fix this round
            sig = None
            if "eta_grid" in st:
                eg = (self._exc_cat(self._c(st["eta_grid"]))
                      if self._batch else self._exc(st["eta_grid"]))
                sig = self._sigma_all(eg)
            if self._batch:
                U = self._catp._depth_integral(self._c(st["u"]), LOC_FCC)
                V = self._catp._depth_integral(self._c(st["v"]), LOC_CFC)
                if sig is not None:
                    U = U * sig[("f", "c")].astype(U.dtype)
                    V = V * sig[("c", "f")].astype(V.dtype)
                U, V = self._s(U), self._s(V)
            else:
                U = jnp.stack([self.panels[p]._depth_integral(st["u"][p],
                                                              LOC_FCC)
                               for p in range(6)])
                V = jnp.stack([self.panels[p]._depth_integral(st["v"][p],
                                                              LOC_CFC)
                               for p in range(6)])
                if sig is not None:
                    U = U * jnp.stack([sig[p][("f", "c")]
                                       for p in range(6)]).astype(U.dtype)
                    V = V * jnp.stack([sig[p][("c", "f")]
                                       for p in range(6)]).astype(V.dtype)
            st["barotropic"] = {"U": U, "V": V}
        self.state = st

    def set(self, **fields):
        """Set fields from arrays (interior (6, N, N, Nz) or padded) or
        callables of geographic (lon_rad, lat_rad, z)."""
        grid = self.grid
        H, N = grid.H[0], grid.N[0]
        g0 = grid.panel_grids[0]
        hz, nz = g0.H[2], g0.N[2]
        zc = np.asarray(g0.znodes("c"))
        st = dict(self.state)
        for name, val in fields.items():
            tgt = st[name]
            if callable(val):
                panels = []
                for p in range(6):
                    lam, phi = grid.panel_grids[p].nodes2d_padded(("c", "c"))
                    lam = np.deg2rad(lam)
                    phi = np.deg2rad(phi)
                    if name == "eta":
                        panels.append(np.broadcast_to(
                            np.asarray(val(lam, phi), np.float64),
                            lam.shape)[..., None])
                    else:
                        panels.append(np.stack(
                            [np.broadcast_to(
                                np.asarray(val(lam, phi, z), np.float64),
                                lam.shape) for z in zc], axis=-1))
                arr = np.stack(panels)
                if name != "eta":
                    full = np.zeros(tgt.shape, np.float64)
                    full[..., hz:hz + nz] = arr
                    arr = full
                st[name] = jnp.asarray(arr, grid.dtype)
            else:
                val = np.asarray(val)
                if val.shape == tgt.shape:
                    st[name] = jnp.asarray(val, grid.dtype)
                else:
                    full = np.zeros(tgt.shape, np.float64)
                    if name == "eta":
                        full[:, H:H + N, H:H + N, :] = val.reshape(
                            (6, N, N, 1))
                    else:
                        full[:, H:H + N, H:H + N, hz:hz + nz] = val
                    st[name] = jnp.asarray(full, grid.dtype)
        self.state = st
        self._post_set()

    # -- halo management --------------------------------------------------------

    def _c(self, a):
        """(6, npx, rest...) → (6·npx, rest...): the panel-batched view (a
        leading-axes merge — layout-preserving, compiles to nothing)."""
        return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])

    def _s(self, a):
        """(6·npx, rest...) → (6, npx, rest...)."""
        return a.reshape((6, self._NPX) + a.shape[1:])

    def _filled(self, st, time):
        """Exchange panel halos (staggered rotation for u/v), fill z halos
        per the top/bottom BCs, and mask immersed cells."""
        out = dict(st)
        u, v = st["u"], st["v"]
        if self._batch:
            # CAT CONTRACT: fields in `st` are panel-concatenated
            # (6·npx, npy, ...); so is the output
            cp = self._catp
            if self._immersed:
                u = cp.grid.mask_immersed(u, LOC_FCC)
                v = cp.grid.mask_immersed(v, LOC_CFC)
            u, v = self._exuv_cat(u, v)
            u = fill_halo_axes(u, cp.grid, LOC_FCC, cp.bcs["u"], time,
                               axes=(2,))
            v = fill_halo_axes(v, cp.grid, LOC_CFC, cp.bcs["v"], time,
                               axes=(2,))
            out["u"], out["v"] = u, v
            out["eta"] = self._exc_cat(st["eta"])
            for name in self.tracer_names:
                c = st[name]
                if self._immersed:
                    c = cp.grid.mask_immersed(c, LOC_CCC)
                c = self._exc_cat(c)
                out[name] = fill_halo_axes(c, cp.grid, LOC_CCC,
                                           cp.bcs[name], time, axes=(2,))
            return out
        if self._immersed:
            u = jnp.stack([self.panels[p].grid.mask_immersed(u[p], LOC_FCC)
                           for p in range(6)])
            v = jnp.stack([self.panels[p].grid.mask_immersed(v[p], LOC_CFC)
                           for p in range(6)])
        u, v = self._exuv(u, v)
        u = jnp.stack([fill_halo_axes(u[p], self.panels[p].grid, LOC_FCC,
                                      self.panels[p].bcs["u"], time,
                                      axes=(2,)) for p in range(6)])
        v = jnp.stack([fill_halo_axes(v[p], self.panels[p].grid, LOC_CFC,
                                      self.panels[p].bcs["v"], time,
                                      axes=(2,)) for p in range(6)])
        out["u"], out["v"] = u, v
        out["eta"] = self._exc(st["eta"])
        for name in self.tracer_names:
            c = st[name]
            if self._immersed:
                c = jnp.stack([self.panels[p].grid.mask_immersed(c[p],
                                                                 LOC_CCC)
                               for p in range(6)])
            c = self._exc(c)
            c = jnp.stack([fill_halo_axes(c[p], self.panels[p].grid, LOC_CCC,
                                          self.panels[p].bcs[name], time,
                                          axes=(2,)) for p in range(6)])
            out[name] = c
        return out

    # -- dynamics ----------------------------------------------------------------

    def _vertex_zetas(self, u, v):
        """Per-panel ffc vorticity with the valence-3 cube-vertex fix
        (dual-triangle circulation — cubed_sphere_shallow_water)."""
        zetas = [zeta3_ffc(self.grid.panel_grids[p], u[p], v[p])
                 for p in range(6)]
        ones_ff = [jnp.ones_like(z) for z in zetas]
        sw = CubedSphereShallowWaterModel
        zetas, _ = sw._vertex_zeta(self, zetas, ones_ff,
                                   jnp.ones_like(u), u, v)
        return zetas

    def _build_vertex_fix(self):
        """Static gather/scatter index tables for the valence-3 cube-vertex
        vorticity fix (the batched analogue of the per-member scalar reads
        and sets of cubed_sphere_shallow_water._vertex_zeta: each of the 8
        vertices sums 3 members' partial circulations ±Δy·v ∓Δx·u and the
        result overwrites the 24 corner ffc slots — here as two fancy-index
        gathers, one reshape-sum and one scatter)."""
        H = self.grid.H[0]
        vp, vi, vj, wv = [], [], [], []
        up_, ui, uj, wu = [], [], [], []
        sp, si, sj, zrow = [], [], [], []
        Av = []
        for gidx, (members, A) in enumerate(self._corner_info):
            Av.append(A)
            for (p, i0, j0) in members:
                g = self.grid.panel_grids[p]
                dycf = np.asarray(g.dy(LOC_CFC))
                dxfc = np.asarray(g.dx(LOC_FCC))
                if i0 == H:
                    vp.append(p), vi.append(i0), vj.append(j0)
                    wv.append(dycf[i0, j0, 0])
                else:
                    vp.append(p), vi.append(i0 - 1), vj.append(j0)
                    wv.append(-dycf[i0 - 1, j0, 0])
                if j0 == H:
                    up_.append(p), ui.append(i0), uj.append(j0)
                    wu.append(-dxfc[i0, j0, 0])
                else:
                    up_.append(p), ui.append(i0), uj.append(j0 - 1)
                    wu.append(dxfc[i0, j0 - 1, 0])
                sp.append(p), si.append(i0), sj.append(j0)
                zrow.append(gidx)
        ia = lambda x: np.asarray(x, np.int32)
        NPX = self._NPX
        return {"vrows": ia(vp) * NPX + ia(vi), "vj": ia(vj),
                "urows": ia(up_) * NPX + ia(ui), "uj": ia(uj),
                "wv": np.asarray(wv), "wu": np.asarray(wu),
                "srows": ia(sp) * NPX + ia(si), "sj": ia(sj),
                "zrow": ia(zrow), "Av": np.asarray(Av),
                "ngroups": len(self._corner_info)}

    def _zeta_cat(self, u, v):
        """Concat-panels ffc vorticity with the vectorized vertex fix:
        one whole-array curl + 2 gathers + 1 scatter (vs ~150 scalar ops
        in the per-panel path). ``u``/``v`` are CAT (6·npx, npy, z)."""
        zcat = zeta3_ffc(self._catp.grid, u, v)
        f = self._vertex_fix
        dt = u.dtype
        vg = v[f["vrows"], f["vj"]]                # (24, Z)
        ug = u[f["urows"], f["uj"]]
        tot = (jnp.asarray(f["wv"], dt)[:, None] * vg
               + jnp.asarray(f["wu"], dt)[:, None] * ug)
        tot = tot.reshape(f["ngroups"], 3, -1).sum(1)
        zv = tot / jnp.asarray(2.0 * f["Av"], dt)[:, None]
        zmem = zv[f["zrow"]]                       # (24, Z)
        return zcat.at[f["srows"], f["sj"]].set(zmem.astype(zcat.dtype))

    def _tendencies(self, sf, w, time, dt_sigma=None):
        """Shared-path tendencies. Batched mode: ONE `_compute_tendencies`
        over the panel concatenation (aux = single concat dict); per-panel
        mode: the original 6-call loop (aux = list per panel)."""
        names = ("u", "v") + self.tracer_names
        if self._batch:
            cp = self._catp
            fields_c = {n: sf[n] for n in names}
            fields_c["eta"] = sf["eta"]
            if "eta_grid" in sf:      # z*: σ derives from the grid η
                fields_c["eta_grid"] = sf["eta_grid"]
            cp._zeta_override = self._zeta_cat(sf["u"], sf["v"])
            Gc, aux = cp._compute_tendencies(fields_c, w, time,
                                             dt_sigma=dt_sigma)
            cp._zeta_override = None
            return Gc, aux
        zetas = self._vertex_zetas(sf["u"], sf["v"])
        G = {n: [] for n in names}
        auxs = []
        for p in range(6):
            pp = self.panels[p]
            fields_p = {n: sf[n][p] for n in names}
            fields_p["eta"] = sf["eta"][p]
            if "eta_grid" in sf:
                fields_p["eta_grid"] = sf["eta_grid"][p]
            pp._zeta_override = zetas[p]
            Gp, aux = pp._compute_tendencies(
                fields_p, w[p], time,
                dt_sigma=None if dt_sigma is None else dt_sigma[p])
            pp._zeta_override = None
            auxs.append(aux)
            for n in names:
                G[n].append(Gp[n])
        return {n: jnp.stack(vs) for n, vs in G.items()}, auxs

    def _w(self, sf, dt_sigma=None, sigma=None):
        if self._batch:
            return self._catp._w_from_continuity(sf["u"], sf["v"],
                                                 dt_sigma=dt_sigma,
                                                 sigma=sigma)
        return jnp.stack([self.panels[p]._w_from_continuity(
            sf["u"][p], sf["v"][p],
            dt_sigma=None if dt_sigma is None else dt_sigma[p],
            sigma=None if sigma is None else sigma[p])
            for p in range(6)])

    # -- z* grid-η machinery (reference: z_star_vertical_spacing.jl; the
    # -- flat-model analogue and the telescoping rationale live in
    # -- models/hydrostatic.py) ------------------------------------------------

    def _sigma_all(self, eta_grid):
        """Per-staggering σ dicts from the (halo-valid) grid η: the
        cat-form dict in batched mode, a list of 6 per-panel dicts
        otherwise."""
        if self._batch:
            return self._catp._sigma_fields(eta_grid)
        return [self.panels[p]._sigma_fields(eta_grid[p]) for p in range(6)]

    def _sig_cc(self, sig):
        if self._batch:
            return sig[("c", "c")]
        return jnp.stack([s[("c", "c")] for s in sig])

    def _grid_motion_rate_cs(self, dhU):
        """∂t_σ = -δh_U/H over wet columns (0 on land)."""
        if self._batch:
            H, wet = self._catp._zstar_geo[LOC_CCC]
            r = -dhU / H
            return r if wet is None else jnp.where(wet, r,
                                                   jnp.zeros_like(r))
        out = []
        for p in range(6):
            H, wet = self.panels[p]._zstar_geo[LOC_CCC]
            r = -dhU[p] / H
            out.append(r if wet is None
                       else jnp.where(wet, r, jnp.zeros_like(r)))
        return jnp.stack(out)

    def _transport_divergence(self, U, V):
        """δh_U from halo-exchanged barotropic transports, batched or
        stacked."""
        if self._batch:
            U, V = self._exuv_cat(U, V)
            return self._div_transport_cat(U, V)
        U, V = self._exuv(U, V)
        out = []
        for p in range(6):
            g = self.panels[p].grid
            out.append((dx_c(g, g.dy(LOC_FCC)[..., :1] * U[p])
                        + dy_c(g, g.dx(LOC_CFC)[..., :1] * V[p]))
                       / g.Az(LOC_CCC)[..., :1])
        return jnp.stack(out)

    # -- free surfaces ------------------------------------------------------------

    def _div_transport_cat(self, U, V):
        """∇·(transport) over the panel concatenation: (6·npx, npy, 1) in
        and out (seam columns garbage-only-in-halo, refilled on exchange)."""
        g = self._catp.grid
        return (dx_c(g, g.dy(LOC_FCC)[..., :1] * U)
                + dy_c(g, g.dx(LOC_CFC)[..., :1] * V)) \
            / g.Az(LOC_CCC)[..., :1]

    def _explicit_eta(self, eta0, u, v, sdt):
        """Forward-backward explicit step: η ← η − Δt ∇·∫u dz with the
        UPDATED velocities (explicit_free_surface.jl). Shared-edge faces are
        synced first so both panels compute bitwise-identical fluxes through
        a shared face (global mass conservation to summation roundoff)."""
        if self._batch:
            cp = self._catp
            u, v = self._sync_cat(u, v)
            U = cp._depth_integral(u, LOC_FCC)
            V = cp._depth_integral(v, LOC_CFC)
            return eta0 - sdt * self._div_transport_cat(U, V)
        u, v = sync_shared_velocity_faces(u, v, self.grid)
        divs = []
        for p in range(6):
            pp = self.panels[p]
            g = self.grid.panel_grids[p]
            U = pp._depth_integral(u[p], LOC_FCC)
            V = pp._depth_integral(v[p], LOC_CFC)
            divs.append((dx_c(g, g.dy(LOC_FCC)[..., :1] * U)
                         + dy_c(g, g.dx(LOC_CFC)[..., :1] * V))
                        / g.Az(LOC_CCC)[..., :1])
        return eta0 - sdt * jnp.stack(divs)

    def _split_explicit_substep(self, eta, U, V, GU, GV, dt, frac, weights):
        """Forward-backward barotropic subcycle on the composed panels with
        per-column fluid depths and Shchepetkin averaging (reference:
        multi_region_split_explicit_free_surface.jl +
        step_split_explicit_free_surface.jl). ``GU/GV`` EXCLUDE the surface
        gradient (applied here). Returns the filtered (η̄, Ū, V̄)."""
        grid = self.grid
        gy = self.free_surface.g
        dtau = frac * dt
        H_fc = self._H_fc if not np.isscalar(self._H_fc) else self._H_fc
        H_cf = self._H_cf

        # the substep body is identical for every substep (the weight enters
        # only the filtered accumulation), so the loop runs as a lax.scan —
        # at 6 panels × tens of substeps the unrolled graph made remote XLA
        # compiles take tens of minutes (the rectilinear fs.substep unrolls
        # for its ring-budget fill optimization; the CS exchange is a static
        # gather with no such budget, so scan costs nothing)
        if self._batch:
            # CAT CONTRACT: eta/U/V/GU/GV are panel-concatenated
            cg = self._catp.grid
            cp = self._catp
            Hfc = (H_fc if np.isscalar(H_fc)
                   else jnp.asarray(np.asarray(cp._H_fc), eta.dtype))
            Hcf = (H_cf if np.isscalar(H_cf)
                   else jnp.asarray(np.asarray(cp._H_cf), eta.dtype))
            GU, GV = self._exuv_cat(GU, GV)

            Hh = grid.H[0]
            mid_exc = Hh < 3   # see the cadence note below

            def substep(carry, w):
                eta, U, V, eta_f, U_f, V_f = carry
                eta = eta - dtau * self._div_transport_cat(U, V)
                if mid_exc:
                    eta = self._exc_cat(eta)
                U = U + dtau * (-gy * Hfc * ddx(cg, eta, LOC_FCC) + GU)
                V = V + dtau * (-gy * Hcf * ddy(cg, eta, LOC_CFC) + GV)
                return (eta, U, V, eta_f + w * eta, U_f + w * U,
                        V_f + w * V)

            # halo-deep subcycling: one (η, U, V) exchange per chunk of
            # c = (H-1)//2 substeps. Each substep consumes TWO halo rings
            # (δᶜ reads one slot outward on the high side, ∂ᶠ one slot
            # outward on the low side): after an exchange η is valid to
            # ring H and U/V to H-1, and substep k needs U ring validity
            # H-1-2(k-1) >= 1 and η ring validity H-2k >= 1 for the
            # interior updates to stay EXACT, giving k <= (H-1)/2.
            # At the default halo 3 this is c = 1 — still one eta exchange
            # per substep fewer than the per-panel reference body, which
            # re-exchanges η after its update (unnecessary for H >= 3:
            # the next substep's opening exchange rebuilds halos from
            # interiors). Interiors stay bitwise per-substep-exchange
            # values (tests/test_cubed_sphere_batched.py); only unread
            # halo rings go stale.
            c = max(1, (Hh - 1) // 2)
            M = len(np.asarray(weights))
            n_full, rem = divmod(M, c)
            ws_np = np.asarray(weights)

            # single-pass exchanges: the subcycle's +-shaped radius-1
            # stencils (δᶜ of transports, ∂ᶠ of η) never read the 3-panel
            # corner halo blocks — the only slots pass 2 exists for — so
            # one pass per exchange is exact here and halves the
            # launch-bound exchange kernel count
            exc1 = self._exc_cat.single_pass
            exuv1 = self._exuv_cat.single_pass

            def run_chunk(carry, wchunk):
                eta, U, V, eta_f, U_f, V_f = carry
                U, V = exuv1(U, V)
                eta = exc1(eta)
                carry = (eta, U, V, eta_f, U_f, V_f)
                for j in range(wchunk.shape[0]):
                    carry = substep(carry, wchunk[j])
                return carry, None

            carry = (eta, U, V, jnp.zeros_like(eta), jnp.zeros_like(U),
                     jnp.zeros_like(V))
            ws_j = jnp.asarray(ws_np, eta.dtype)
            if M <= 32:
                # fully unrolled: a lax.while adds a per-iteration device
                # sync barrier that dominates these tiny 2D bodies
                # (measured 1.67 ms of 4.9 at substeps=20); unrolled, XLA
                # pipelines across substeps
                for k in range(0, n_full * c, c):
                    carry, _ = run_chunk(carry, ws_j[k:k + c])
                if rem:
                    carry, _ = run_chunk(carry, ws_j[n_full * c:])
            else:
                if n_full:
                    wmat = ws_j[:n_full * c].reshape(n_full, c)
                    carry, _ = jax.lax.scan(run_chunk, carry, wmat)
                if rem:
                    carry, _ = run_chunk(carry, ws_j[n_full * c:])
            _, _, _, eta_f, U_f, V_f = carry
            return eta_f, U_f, V_f
        else:
            GU, GV = self._exuv(GU, GV)

            def body(carry, w):
                eta, U, V, eta_f, U_f, V_f = carry
                U, V = self._exuv(U, V)
                eta = self._exc(eta)
                divs = []
                for p in range(6):
                    g = grid.panel_grids[p]
                    divs.append((dx_c(g, g.dy(LOC_FCC)[..., :1] * U[p])
                                 + dy_c(g, g.dx(LOC_CFC)[..., :1] * V[p]))
                                / g.Az(LOC_CCC)[..., :1])
                eta = eta - dtau * jnp.stack(divs)
                eta = self._exc(eta)
                un, vn = [], []
                for p in range(6):
                    g = grid.panel_grids[p]
                    hf = H_fc if np.isscalar(H_fc) else H_fc[p]
                    hc = H_cf if np.isscalar(H_cf) else H_cf[p]
                    un.append(U[p] + dtau * (-gy * hf
                                             * ddx(g, eta[p], LOC_FCC)
                                             + GU[p]))
                    vn.append(V[p] + dtau * (-gy * hc
                                             * ddy(g, eta[p], LOC_CFC)
                                             + GV[p]))
                U, V = jnp.stack(un), jnp.stack(vn)
                eta_f = eta_f + w * eta
                U_f = U_f + w * U
                V_f = V_f + w * V
                return (eta, U, V, eta_f, U_f, V_f), None

        carry0 = (eta, U, V, jnp.zeros_like(eta), jnp.zeros_like(U),
                  jnp.zeros_like(V))
        ws = jnp.asarray(np.asarray(weights), eta.dtype)
        (eta, U, V, eta_f, U_f, V_f), _ = jax.lax.scan(body, carry0, ws)
        return eta_f, U_f, V_f

    def _barotropic_corrector(self, u, v, U_f, V_f, sigma=None):
        """Replace the depth mean of (u, v) with the filtered barotropic
        transports (barotropic_split_explicit_corrector.jl); per-column
        fluid depths on immersed panels; on z* panels (``sigma`` given) the
        MOVING-thickness integral is pinned (σ is depth-uniform so
        ∫u σ dz = σ ∫u dz — see models/hydrostatic.py). zmask also zeroes
        the unused z-halo slots (they would otherwise accumulate unbalanced
        Coriolis)."""
        g0 = self.grid.panel_grids[0]
        hz, nz = g0.H[2], g0.N[2]
        zmask = jnp.zeros((g0.padded_shape[2],), u.dtype
                          ).at[hz:hz + nz].set(1.0)
        if self._batch:
            # CAT CONTRACT: u/v/U_f/V_f are panel-concatenated
            cp = self._catp
            Ustar = cp._depth_integral(u, LOC_FCC)
            Vstar = cp._depth_integral(v, LOC_CFC)
            hf = cp._H_fc if not self._immersed else jnp.asarray(
                np.asarray(cp._H_fc), u.dtype)
            hc = cp._H_cf if not self._immersed else jnp.asarray(
                np.asarray(cp._H_cf), u.dtype)
            if sigma is not None:
                sfc = sigma[("f", "c")].astype(u.dtype)
                scf = sigma[("c", "f")].astype(v.dtype)
                Ustar, Vstar = Ustar * sfc, Vstar * scf
                hf, hc = hf * sfc, hc * scf
            up = (u + (U_f - Ustar) / hf) * zmask
            vp = (v + (V_f - Vstar) / hc) * zmask
            if self._immersed:
                up = cp.grid.mask_immersed(up, LOC_FCC)
                vp = cp.grid.mask_immersed(vp, LOC_CFC)
            return up, vp
        un, vn = [], []
        for p in range(6):
            pp = self.panels[p]
            Ustar = pp._depth_integral(u[p], LOC_FCC)
            Vstar = pp._depth_integral(v[p], LOC_CFC)
            hf = self._H_fc if np.isscalar(self._H_fc) else self._H_fc[p]
            hc = self._H_cf if np.isscalar(self._H_cf) else self._H_cf[p]
            if sigma is not None:
                sfc = sigma[p][("f", "c")].astype(u.dtype)
                scf = sigma[p][("c", "f")].astype(v.dtype)
                Ustar, Vstar = Ustar * sfc, Vstar * scf
                hf, hc = hf * sfc, hc * scf
            up = (u[p] + (U_f[p] - Ustar) / hf) * zmask
            vp = (v[p] + (V_f[p] - Vstar) / hc) * zmask
            if self._immersed:
                up = pp.grid.mask_immersed(up, LOC_FCC)
                vp = pp.grid.mask_immersed(vp, LOC_CFC)
            un.append(up)
            vn.append(vp)
        return jnp.stack(un), jnp.stack(vn)

    def _implicit_eta_step(self, st, sdt):
        """Backward-Euler free-surface step on the composed sphere in
        increment (θ = 1) form: solve
        Az·δ − gΔt² δᵢ(H A_edge ∂δ) = −Δt δᵢ(A_edge ∫u* dz) by matrix-free
        CG with the inter-panel exchange inside the operator and PER-COLUMN
        fluid depths (pcg_implicit_free_surface_solver.jl), then correct
        u ← u* − gΔt ∂δ."""
        from ..solvers.conjugate_gradient import conjugate_gradient
        grid = self.grid
        gy = self.free_surface.g
        u, v, eta0 = st["u"], st["v"], st["eta"]
        if self._batch:
            u, v = self._sync_cat(u, v)
            return self._implicit_eta_step_cat(st, u, v, eta0, sdt)
        u, v = sync_shared_velocity_faces(u, v, grid)

        def div_transport(a_fcc, a_cfc):
            outs = []
            for p in range(6):
                g = grid.panel_grids[p]
                outs.append(dx_c(g, g.dy(LOC_FCC)[..., :1] * a_fcc[p])
                            + dy_c(g, g.dx(LOC_CFC)[..., :1] * a_cfc[p]))
            return jnp.stack(outs)

        Ustar = jnp.stack([self.panels[p]._depth_integral(u[p], LOC_FCC)
                           for p in range(6)])
        Vstar = jnp.stack([self.panels[p]._depth_integral(v[p], LOC_CFC)
                           for p in range(6)])
        Az = jnp.stack([jnp.broadcast_to(
            jnp.asarray(np.asarray(grid.panel_grids[p].Az(LOC_CCC)),
                        grid.dtype), eta0[p].shape) for p in range(6)])
        Hh, N = grid.H[0], grid.N[0]
        mask = np.zeros(eta0.shape, bool)
        mask[:, Hh:Hh + N, Hh:Hh + N] = True
        mask = jnp.asarray(mask)
        rhs = jnp.where(mask, -sdt * div_transport(Ustar, Vstar), 0.0)

        def A(x):
            xf = self._exc(jnp.where(mask, x, 0.0))
            gx, gyy = [], []
            for p in range(6):
                g = grid.panel_grids[p]
                hf = self._H_fc if np.isscalar(self._H_fc) else self._H_fc[p]
                hc = self._H_cf if np.isscalar(self._H_cf) else self._H_cf[p]
                gx.append(hf * ddx(g, xf[p], LOC_FCC))
                gyy.append(hc * ddy(g, xf[p], LOC_CFC))
            lap = div_transport(jnp.stack(gx), jnp.stack(gyy))
            return jnp.where(mask, Az * x - gy * sdt * sdt * lap, 0.0)

        delta, _, _ = conjugate_gradient(A, rhs,
                                         reltol=self.implicit_solver_tol,
                                         maxiter=200)
        deltaf = self._exc(delta)
        un, vn = [], []
        for p in range(6):
            g = grid.panel_grids[p]
            up = u[p] - gy * sdt * ddx(g, deltaf[p], LOC_FCC)
            vp = v[p] - gy * sdt * ddy(g, deltaf[p], LOC_CFC)
            if self._immersed:
                up = self.panels[p].grid.mask_immersed(up, LOC_FCC)
                vp = self.panels[p].grid.mask_immersed(vp, LOC_CFC)
            un.append(up)
            vn.append(vp)
        out = dict(st)
        out["u"], out["v"] = jnp.stack(un), jnp.stack(vn)
        out["eta"] = eta0 + delta
        return out

    def _implicit_eta_step_cat(self, st, u, v, eta0, sdt):
        """Batched variant of :meth:`_implicit_eta_step`: the CG operator's
        gradient/divergence run over the panel concatenation; the inter-panel
        exchange stays on the stacked view inside the operator."""
        from ..solvers.conjugate_gradient import conjugate_gradient
        grid = self.grid
        cp = self._catp
        cg = cp.grid
        gy = self.free_surface.g
        Ustar = cp._depth_integral(u, LOC_FCC)
        Vstar = cp._depth_integral(v, LOC_CFC)

        def div_transport(a_fcc, a_cfc):
            return (dx_c(cg, cg.dy(LOC_FCC)[..., :1] * a_fcc)
                    + dy_c(cg, cg.dx(LOC_CFC)[..., :1] * a_cfc))

        Az = jnp.asarray(np.broadcast_to(np.asarray(cg.Az(LOC_CCC)),
                                         eta0.shape), grid.dtype)
        Hh, N = grid.H[0], grid.N[0]
        mask = np.zeros((6, self._NPX) + tuple(eta0.shape[1:]), bool)
        mask[:, Hh:Hh + N, Hh:Hh + N] = True
        mask = jnp.asarray(mask.reshape(eta0.shape))
        rhs = jnp.where(mask, -sdt * div_transport(Ustar, Vstar), 0.0)
        hf = cp._H_fc if not self._immersed else np.asarray(cp._H_fc)
        hc = cp._H_cf if not self._immersed else np.asarray(cp._H_cf)

        def A(x):
            xf = self._exc_cat(jnp.where(mask, x, 0.0))
            lap = div_transport(hf * ddx(cg, xf, LOC_FCC),
                                hc * ddy(cg, xf, LOC_CFC))
            return jnp.where(mask, Az * x - gy * sdt * sdt * lap, 0.0)

        delta, _, _ = conjugate_gradient(A, rhs,
                                         reltol=self.implicit_solver_tol,
                                         maxiter=200)
        deltaf = self._exc_cat(delta)
        up = u - gy * sdt * ddx(cg, deltaf, LOC_FCC)
        vp = v - gy * sdt * ddy(cg, deltaf, LOC_CFC)
        if self._immersed:
            up = cg.mask_immersed(up, LOC_FCC)
            vp = cg.mask_immersed(vp, LOC_CFC)
        out = dict(st)
        out["u"], out["v"] = up, vp
        out["eta"] = eta0 + delta
        return out

    # -- step -----------------------------------------------------------------

    def _mask_prognostics(self, st):
        if not self._immersed:
            return st
        out = dict(st)
        if self._batch:
            cp = self._catp
            for n in ("u", "v") + self.tracer_names:
                out[n] = cp.grid.mask_immersed(st[n], cp.loc(n))
            return out
        for n in ("u", "v") + self.tracer_names:
            out[n] = jnp.stack([self.panels[p].grid.mask_immersed(
                st[n][p], self.panels[p].loc(n)) for p in range(6)])
        return out

    def _build_step(self, se_settings=None, catke_substeps=1):
        grid = self.grid
        prog = ("u", "v", "eta") + self.tracer_names
        fs = self.free_surface
        split_explicit = isinstance(fs, SplitExplicitFreeSurface)
        implicit = isinstance(fs, ImplicitFreeSurface)

        def implicit_all(st, auxs, sdt, G=None, Gm=None, chi=None,
                         euler=None):
            if self.closure is None:
                return st
            out = dict(st)
            if self._batch:
                cp = self._catp
                st_c = {n: st[n] for n in prog if n in st}
                damp = None
                if hasattr(self.closure, "vertical_implicit_damping") \
                        and not self._substepped_tke:
                    damp = self.closure.vertical_implicit_damping(
                        cp.grid, st_c, auxs)
                new_c = cp.implicit_step(st_c, auxs, sdt, dampings=damp)
                for n, val in new_c.items():
                    if n in st and val is not st_c.get(n):
                        out[n] = val
                if hasattr(self.closure, "clip_fields") \
                        and not self._substepped_tke:
                    out = self.closure.clip_fields(out)
                return out
            names = None
            dampings = [None] * 6
            if hasattr(self.closure, "vertical_implicit_damping") \
                    and not self._substepped_tke:
                dampings = [self.closure.vertical_implicit_damping(
                    self.panels[p].grid,
                    {n: st[n][p] for n in prog if n in st}, auxs[p])
                    for p in range(6)]
            cols = {}
            for p in range(6):
                pp = self.panels[p]
                st_p = {n: st[n][p] for n in prog if n in st}
                new_p = pp.implicit_step(st_p, auxs[p], sdt,
                                         dampings=dampings[p])
                if names is None:
                    names = [n for n in new_p
                             if n in st and new_p[n] is not st_p[n]]
                for n in names:
                    cols.setdefault(n, []).append(new_p[n])
            for n, vs in cols.items():
                out[n] = jnp.stack(vs)
            if hasattr(self.closure, "clip_fields") \
                    and not self._substepped_tke:
                out = self.closure.clip_fields(out)
            return out

        def step_turbulence_all(sf, new, G, Gm, dt, chi, euler, time):
            """Substepped turbulence (CATKE/k-ε) per panel with the UPDATED,
            exchange-and-z-filled velocities (time_step_catke_equation.jl)."""
            nf = self._filled(new, time)
            if self._batch:
                cp = self._catp
                fields_c = {n: sf[n] for n in prog}
                fnew = {n: new[n] for n in prog}
                fnew.update(u=nf["u"], v=nf["v"],
                            **{nm: sf[nm]
                               for nm in self._substepped_names})
                slow = {nm: G[nm] for nm in self._substepped_names}
                prev = {nm: Gm[nm] for nm in self._substepped_names}
                upd, Gm_t = self.closure.step_turbulence(
                    cp.grid, fields_c, fnew, slow, prev, dt, chi,
                    euler, catke_substeps, time)
                outs = {}
                for nm, val in upd.items():
                    if self._immersed:
                        val = cp.grid.mask_immersed(val, LOC_CCC)
                    outs[nm] = val
                return outs, Gm_t
            upds = {nm: [] for nm in self._substepped_names}
            Gts = {nm: [] for nm in self._substepped_names}
            for p in range(6):
                pp = self.panels[p]
                fields_p = {n: sf[n][p] for n in prog}
                fnew = {n: new[n][p] for n in prog}
                fnew.update(u=nf["u"][p], v=nf["v"][p],
                            **{nm: sf[nm][p]
                               for nm in self._substepped_names})
                slow = {nm: G[nm][p] for nm in self._substepped_names}
                prev = {nm: Gm[nm][p] for nm in self._substepped_names}
                upd, Gm_t = self.closure.step_turbulence(
                    pp.grid, fields_p, fnew, slow, prev, dt, chi,
                    euler, catke_substeps, time)
                for nm, val in upd.items():
                    if self._immersed:
                        val = pp.grid.mask_immersed(val, LOC_CCC)
                    upds[nm].append(val)
                    Gts[nm].append(Gm_t[nm])
            return ({nm: jnp.stack(vs) for nm, vs in upds.items()},
                    {nm: jnp.stack(vs) for nm, vs in Gts.items()})

        if self.timestepper == "QuasiAdamsBashforth2":
            chi0 = 0.1

            def step(state, dt):
                # batched mode: convert the stacked state to the panel-
                # concatenated form ONCE here (and back at the end) — all
                # in-step math runs on (6·npx, npy, ...) arrays
                C = self._c if self._batch else (lambda a: a)
                S = self._s if self._batch else (lambda a: a)
                st0 = {n: C(state[n]) for n in prog}
                Gm = {n: C(g) for n, g in state["Gm"].items()}
                time = state["time"]
                euler = state["iteration"] == 0
                chi = jnp.where(euler, -0.5, chi0)
                not_euler = jnp.where(euler, 0.0, 1.0)
                zstar = "dt_sigma" in state
                sf = self._filled(st0, time)
                substepped = getattr(self, "_substepped_names", ())
                if zstar:
                    # z* grid-η machinery (see models/hydrostatic.py):
                    # δh_U at tendency time from the persisted barotropic
                    # transports (or moving-thickness integrals), σ from
                    # the grid η, ∂t_σ = -δh_U/H
                    eta_g = state["eta_grid"]
                    eta_g = (self._exc_cat(C(eta_g)) if self._batch
                             else self._exc(eta_g))
                    sig_n = self._sigma_all(eta_g)
                    sig_cc = self._sig_cc(sig_n)
                    if split_explicit:
                        bt_n = state["barotropic"]
                        Ubt, Vbt = C(bt_n["U"]), C(bt_n["V"])
                    elif self._batch:
                        cp = self._catp
                        Ubt = cp._depth_integral(sf["u"], LOC_FCC) \
                            * sig_n[("f", "c")]
                        Vbt = cp._depth_integral(sf["v"], LOC_CFC) \
                            * sig_n[("c", "f")]
                    else:
                        Ubt = jnp.stack([
                            self.panels[p]._depth_integral(
                                sf["u"][p], LOC_FCC)
                            * sig_n[p][("f", "c")] for p in range(6)])
                        Vbt = jnp.stack([
                            self.panels[p]._depth_integral(
                                sf["v"][p], LOC_CFC)
                            * sig_n[p][("c", "f")] for p in range(6)])
                    dhU = self._transport_divergence(Ubt, Vbt)
                    dts = self._grid_motion_rate_cs(dhU)
                    sf = dict(sf)
                    sf["eta_grid"] = eta_g
                else:
                    dts = sig_n = None
                w = self._w(sf, dt_sigma=dts, sigma=sig_n)
                G, auxs = self._tendencies(sf, w, time, dt_sigma=dts)
                if zstar:
                    # σⁿ-scale the tracer tendencies so the AB2 memory
                    # carries σ-scaled tendencies at their own time levels
                    # (reference: scale_by_stretching_factor!)
                    for n in self.tracer_names:
                        if n not in substepped:
                            G[n] = G[n] * sig_cc.astype(G[n].dtype)
                stepped = ("u", "v") + self.tracer_names
                ab2G = {n: (1.5 + chi) * G[n]
                        - (0.5 + chi) * Gm[n] * not_euler for n in stepped}
                ab2G = jax.lax.optimization_barrier(ab2G)
                st = dict(st0)
                for n in stepped:
                    st[n] = st0[n] + dt * ab2G[n]
                sig_np1 = None
                if zstar:
                    # grid-η AB2 step + conservative σ-weighted tracer
                    # update (θⁿ⁺¹ = (σⁿθⁿ + Δt ∂t(σθ))/σⁿ⁺¹); telescopes
                    # exactly — a uniform tracer stays uniform
                    eta_g_new = eta_g - dt * ((1.5 + chi) * dhU
                                              - (0.5 + chi)
                                              * C(state["G_sigma"])
                                              * not_euler)
                    eta_g_new = (self._exc_cat(eta_g_new) if self._batch
                                 else self._exc(eta_g_new))
                    sig_np1 = self._sigma_all(eta_g_new)
                    snp1_cc = self._sig_cc(sig_np1)
                    for n in self.tracer_names:
                        if n not in substepped:
                            st[n] = (sig_cc.astype(st0[n].dtype) * st0[n]
                                     + dt * ab2G[n]) \
                                / snp1_cc.astype(st0[n].dtype)
                st = implicit_all(st, auxs, dt)
                bt = None
                if split_explicit:
                    if self._batch:
                        GU = self._catp._depth_integral(ab2G["u"], LOC_FCC)
                        GV = self._catp._depth_integral(ab2G["v"], LOC_CFC)
                    else:
                        GU = jnp.stack([self.panels[p]._depth_integral(
                            ab2G["u"][p], LOC_FCC) for p in range(6)])
                        GV = jnp.stack([self.panels[p]._depth_integral(
                            ab2G["v"][p], LOC_CFC) for p in range(6)])
                    frac, weights = (se_settings if se_settings is not None
                                     else fs.settings(None))
                    bt0 = {k: C(vv)
                           for k, vv in state["barotropic"].items()}
                    eta_f, U_f, V_f = self._split_explicit_substep(
                        st0["eta"], bt0["U"], bt0["V"], GU, GV, dt,
                        frac, weights)
                    uc, vc = self._barotropic_corrector(st["u"], st["v"],
                                                        U_f, V_f,
                                                        sigma=sig_np1)
                    st.update(u=uc, v=vc, eta=eta_f)
                    bt = {"U": U_f, "V": V_f}
                elif implicit:
                    st = self._implicit_eta_step(st, dt)
                else:
                    st["eta"] = self._explicit_eta(st0["eta"], st["u"],
                                                   st["v"], dt)
                if self._substepped_tke:
                    upd, Gm_t = step_turbulence_all(sf, st, G, Gm, dt,
                                                    chi0, euler, time)
                    G = dict(G)
                    for nm, val in upd.items():
                        st[nm] = val
                        G[nm] = Gm_t[nm]
                st = self._mask_prognostics(st)
                # NO end-of-step halo refresh: every consumer of the stored
                # state either refills (the next step's opening _filled, the
                # subcycle's per-substep exchanges, diagnose_w) or reads
                # interiors only (field accessors, total_tracer). Dropping
                # the second full 3D exchange per step saves ~17% of the
                # measured step (the reference also fills once per step, at
                # update_state! — update_hydrostatic_free_surface_model_state.jl).
                out = dict(st)
                if zstar:
                    # ∂t_σ for the next step's diagnostics, from the
                    # post-step transports; the step itself recomputes it
                    # from the persisted barotropic state
                    if split_explicit:
                        Ub2, Vb2 = U_f, V_f
                    elif self._batch:
                        cp = self._catp
                        Ub2 = cp._depth_integral(st["u"], LOC_FCC) \
                            * sig_np1[("f", "c")]
                        Vb2 = cp._depth_integral(st["v"], LOC_CFC) \
                            * sig_np1[("c", "f")]
                    else:
                        Ub2 = jnp.stack([
                            self.panels[p]._depth_integral(
                                st["u"][p], LOC_FCC)
                            * sig_np1[p][("f", "c")] for p in range(6)])
                        Vb2 = jnp.stack([
                            self.panels[p]._depth_integral(
                                st["v"][p], LOC_CFC)
                            * sig_np1[p][("c", "f")] for p in range(6)])
                    out["dt_sigma"] = self._grid_motion_rate_cs(
                        self._transport_divergence(Ub2, Vb2))
                    out["eta_grid"] = eta_g_new
                    out["G_sigma"] = dhU
                # back to the stacked public state layout
                out = {n: S(v) if n in prog
                       or n in ("dt_sigma", "eta_grid", "G_sigma") else v
                       for n, v in out.items()}
                out["Gm"] = {n: S(G[n]) for n in stepped}
                out["time"] = time + dt
                out["iteration"] = state["iteration"] + 1
                if bt is not None:
                    out["barotropic"] = {k: S(v) for k, v in bt.items()}
                return out

            return step

        def step(state, dt):
            C = self._c if self._batch else (lambda a: a)
            S = self._s if self._batch else (lambda a: a)
            st0 = {n: C(state[n]) for n in prog}
            time = state["time"]
            st = st0
            zstar = "dt_sigma" in state
            dhU = None
            if zstar:
                # z* under Wicker–Skamarock RK3 (the reference's
                # rk3_substep_grid! form): every substep restarts from the
                # σ⁰-weighted step-start tracers and the step-start grid η
                eta_g0 = (self._exc_cat(C(state["eta_grid"]))
                          if self._batch else self._exc(state["eta_grid"]))
                sig0 = self._sigma_all(eta_g0)
                sig0_cc = self._sig_cc(sig0)
                sc0 = {n: sig0_cc.astype(st0[n].dtype) * st0[n]
                       for n in self.tracer_names}
                eta_g_stage, sig_stage = eta_g0, sig0
                eta_g_new = eta_g0
            for frac in (1.0 / 3.0, 0.5, 1.0):   # Wicker-Skamarock RK3
                sdt = frac * dt
                sf = self._filled(st, time)
                if zstar:
                    # stage transports: moving-thickness integrals of the
                    # stage velocities (no barotropic solver on this path)
                    if self._batch:
                        cp = self._catp
                        Ubt = cp._depth_integral(sf["u"], LOC_FCC) \
                            * sig_stage[("f", "c")]
                        Vbt = cp._depth_integral(sf["v"], LOC_CFC) \
                            * sig_stage[("c", "f")]
                    else:
                        Ubt = jnp.stack([
                            self.panels[p]._depth_integral(
                                sf["u"][p], LOC_FCC)
                            * sig_stage[p][("f", "c")] for p in range(6)])
                        Vbt = jnp.stack([
                            self.panels[p]._depth_integral(
                                sf["v"][p], LOC_CFC)
                            * sig_stage[p][("c", "f")] for p in range(6)])
                    dhU = self._transport_divergence(Ubt, Vbt)
                    dts = self._grid_motion_rate_cs(dhU)
                    sf = dict(sf)
                    sf["eta_grid"] = eta_g_stage
                else:
                    dts = None
                w = self._w(sf, dt_sigma=dts,
                            sigma=sig_stage if zstar else None)
                G, auxs = self._tendencies(sf, w, time, dt_sigma=dts)
                st = dict(st0)
                for n in ("u", "v") + self.tracer_names:
                    st[n] = st0[n] + sdt * G[n]
                if zstar:
                    # grid-η substep from the step-start η + σ-form tracer
                    # update (σ⁰c⁰ + Δt σ_stage G)/σ_new — telescopes, so
                    # a uniform tracer stays uniform on every substep
                    eta_g_new = eta_g0 - sdt * dhU
                    eta_g_new = (self._exc_cat(eta_g_new) if self._batch
                                 else self._exc(eta_g_new))
                    sig_new = self._sigma_all(eta_g_new)
                    sn_cc = self._sig_cc(sig_new)
                    sg_cc = self._sig_cc(sig_stage)
                    for n in self.tracer_names:
                        st[n] = (sc0[n] + sdt * sg_cc.astype(G[n].dtype)
                                 * G[n]) / sn_cc.astype(G[n].dtype)
                st = implicit_all(st, auxs, sdt)
                if implicit:
                    st = self._implicit_eta_step(st, sdt)
                else:
                    st["eta"] = self._explicit_eta(st0["eta"], st["u"],
                                                   st["v"], sdt)
                st = self._mask_prognostics(st)
                if zstar:
                    eta_g_stage, sig_stage = eta_g_new, sig_new
            # no end-of-step refresh (see the AB2 step note): the next
            # step's stage-1 _filled rebuilds every halo from interiors
            out = {n: S(v) for n, v in st.items()}
            if zstar:
                out["eta_grid"] = S(eta_g_new)
                out["G_sigma"] = S(dhU)
                out["dt_sigma"] = S(self._grid_motion_rate_cs(dhU))
            out["time"] = time + dt
            out["iteration"] = state["iteration"] + 1
            return out

        return step

    def _state_sharded(self):
        """True when the state's panel axis spans more than one device:
        the per-panel step is both the safe one under GSPMD (the batched
        x-concat stencils trip an observed partitioner miscompile — see
        _jitted_step) and the communication-optimal one (every panel's
        tendency assembly is device-local)."""
        sh = getattr(self.state["u"], "sharding", None)
        if sh is None:
            return False
        try:
            return len(sh.device_set) > 1
        except Exception:
            return False

    def _jitted_step(self, use_batch, se=None, M=1):
        """Compiled step for (panel-batching flag, split-explicit settings,
        CATKE substeps). The batched concat path is the single-device
        default; panel-sharded states dispatch to the per-panel build —
        measured: XLA's SPMD partitioner refuses the x-concatenated stencil
        reads across the exchange and produces ~1%-wrong interior
        tendencies on the CPU backend (jax 0.8, 6-way panel sharding), and
        per-panel is collective-free under panel sharding anyway. The flag
        is applied around each call and each ``.lower`` (tracing happens on
        first call)."""
        key = (bool(use_batch), (len(se[1]), se[0]) if se else None, M)
        hit = self._se_step_cache.get(key)
        if hit is None:
            inner = jax.jit(self._build_step(se_settings=se,
                                             catke_substeps=M))

            def with_flag(fn, _b=key[0]):
                def call(state, dt):
                    prev = self._batch
                    self._batch = _b
                    try:
                        return fn(state, dt)
                    finally:
                        self._batch = prev
                return call

            hit = with_flag(inner)
            hit.lower = with_flag(inner.lower)
            self._se_step_cache[key] = hit
        return hit

    def _step_for(self, dt):
        """Per-Δt compiled step: split-explicit FixedTimeStepSize substep
        counts and the CATKE substep count M = ceil(Δt/Δτ) are static."""
        from .free_surfaces import FixedTimeStepSize
        fs = self.free_surface
        dyn_se = (isinstance(fs, SplitExplicitFreeSurface)
                  and isinstance(fs.substepping, FixedTimeStepSize))
        M = (self.closure.substeps_for(dt)
             if self._substepped_tke
             and getattr(self.closure, "tke_time_step", None) is not None
             else 1)
        use_batch = self._batch_default and not self._state_sharded()
        se = fs.settings(float(dt)) if dyn_se else None
        return self._jitted_step(use_batch, se=se, M=M)

    def time_step(self, dt):
        step = self._step_for(dt)
        self.state = step(self.state, jnp.asarray(dt, self.grid.dtype))

    # -- diagnostics ------------------------------------------------------------

    @property
    def time(self):
        return float(self.state["time"])

    @property
    def datetime(self):
        from ..utils.dateclock import datetime_of
        return datetime_of(self.time, self.reference_datetime)

    @property
    def iteration(self):
        return int(self.state["iteration"])

    def diagnose_w(self):
        """(6, NP, NP, ZP) grid-relative w from continuity. On z* the
        moving (σ-scaled) face areas and the current ∂t_σ enter, matching
        the w used inside the step (the round-5 telescoping form)."""
        C = self._c if self._batch else (lambda a: a)
        S = self._s if self._batch else (lambda a: a)
        sf = self._filled({n: C(self.state[n])
                           for n in ("u", "v", "eta") + self.tracer_names},
                          self.state["time"])
        dts = self.state.get("dt_sigma")
        sig = None
        if dts is not None:
            eta_g = self.state["eta_grid"]
            eta_g = (self._exc_cat(C(eta_g)) if self._batch
                     else self._exc(eta_g))
            sig = self._sigma_all(eta_g)
        return S(self._w(sf, dt_sigma=C(dts) if dts is not None else None,
                         sigma=sig))

    def field(self, name):
        """Writer/diagnostic accessor (fetch_output protocol). 2D fields
        (eta) keep their size-1 z axis un-sliced; "w" is diagnosed;
        "u"/"v" are read through the shared-edge face sync so the
        duplicated faces report the canonical (owner-panel) value — the
        stored state carries each panel's own computed copy between the
        step-opening fills."""
        from .cubed_sphere_shallow_water import _PanelFieldView
        g0 = self.grid.panel_grids[0]
        H, N = self.grid.H[0], self.grid.N[0]
        if name == "w":
            a = self.diagnose_w()
        elif name in ("u", "v"):
            u, v = sync_shared_velocity_faces(self.state["u"],
                                              self.state["v"], self.grid)
            a = u if name == "u" else v
        else:
            a = self.state[name]
        zsl = (slice(g0.H[2], g0.H[2] + g0.N[2])
               if a.shape[-1] == g0.padded_shape[2] else slice(None))
        return _PanelFieldView(a[:, H:H + N, H:H + N, zsl])

    def total_tracer(self, name):
        """Global volume integral of a tracer (exactly conserved by the
        flux-form advection with exchanged shared-face values). Uses the
        effective Δz on PartialCellBottom panels, and the σ-weighted cell
        volumes under z* (the conserved quantity is ∑ c σ V)."""
        grid = self.grid
        H, N = grid.H[0], grid.N[0]
        g0 = grid.panel_grids[0]
        hz, nz = g0.H[2], g0.N[2]
        zstar = self.vertical_coordinate == "zstar"
        tot = 0.0
        for p in range(6):
            gp = self.panels[p].grid
            dz = np.asarray(gp.dz(LOC_CCC), np.float64)
            if dz.ndim == 3 and (dz.shape[0] > 1 or dz.shape[1] > 1):
                dzp = np.broadcast_to(dz, gp.padded_shape)[
                    H:H + N, H:H + N, hz:hz + nz]
            else:
                dzp = np.asarray(self._dz_c)
            Azp = np.asarray(grid.panel_grids[p].Az(LOC_CCC))[..., 0]
            cp = np.asarray(self.state[name][p])[H:H + N, H:H + N,
                                                 hz:hz + nz]
            if self._immersed:
                fm = np.asarray(self.panels[p]._fluid_int[LOC_CCC])[
                    H:H + N, H:H + N]
                cp = cp * fm
            w = cp * dzp
            if zstar:
                sig = np.asarray(self.panels[p]._sigma_fields(
                    self.state["eta"][p])[("c", "c")])[H:H + N, H:H + N]
                w = w * sig
            col = w.sum(axis=-1)
            tot += float((col * Azp[H:H + N, H:H + N]).sum())
        return tot
