"""Boundary condition types.

Reference semantics: src/BoundaryConditions/boundary_condition_classifications.jl
(Flux, Value/Dirichlet, Gradient/Neumann, Open, Periodic),
boundary_condition.jl (classification + condition), and
field_boundary_conditions.jl (per-side container + regularization that fills
topology-appropriate defaults).

Design differences: BCs are static, hashable configuration (they select the
halo-fill code path at trace time); conditions may be

* ``None``      — homogeneous (zero flux / zero value),
* a scalar      — uniform condition,
* a numpy/jnp array broadcastable over the boundary plane,
* a callable ``f(ξ1, ξ2, t)`` of the two transverse *padded broadcastable*
  coordinate arrays and time — the analogue of the reference's
  ContinuousBoundaryFunction (continuous_boundary_function.jl). It must be
  JAX-traceable.
"""

from __future__ import annotations

import numpy as np

from ..grids import topology as topo_mod
from ..grids.topology import BOUNDED, CENTER, FACE, FLAT, PERIODIC

# Classifications
PERIODIC_BC = "periodic"
FLUX = "flux"
VALUE = "value"
GRADIENT = "gradient"
OPEN = "open"
ZIPPER = "zipper"  # tripolar north fold (fill implemented with grid support)


class PerturbationAdvection:
    """Open-boundary scheme: nudge the boundary-normal velocity toward the
    exterior value with an upwind perturbation-advection update (reference:
    src/BoundaryConditions/perturbation_advection.jl — backward-Euler
    boundary step with inflow/outflow relaxation timescales)."""

    __slots__ = ("inflow_timescale", "outflow_timescale")

    def __init__(self, inflow_timescale=0.0, outflow_timescale=np.inf):
        self.inflow_timescale = float(inflow_timescale)
        self.outflow_timescale = float(outflow_timescale)

    def _fp(self):
        return ("PerturbationAdvection", self.inflow_timescale,
                self.outflow_timescale)


class PolarValue:
    """Pole-cap condition: the boundary value is the zonal mean of the
    boundary row of the field itself, recomputed at every halo fill
    (reference: src/BoundaryConditions/polar_boundary_condition.jl
    ``PolarValue`` + ``update_pole_value!`` — there the row average is
    launched into a side buffer before each fill; here it is a traced
    reduction inside the fill)."""

    __slots__ = ("side",)

    def __init__(self, side):
        self.side = side

    def _fp(self):
        return ("PolarValue", self.side)


class BoundaryCondition:
    __slots__ = ("classification", "condition", "scheme",
                 "field_dependencies")

    def __init__(self, classification, condition=None, scheme=None,
                 field_dependencies=()):
        self.classification = classification
        self.condition = condition
        self.scheme = scheme
        if isinstance(field_dependencies, str):
            field_dependencies = (field_dependencies,)
        self.field_dependencies = tuple(field_dependencies)

    def _fp(self):
        c = self.condition
        if c is None or np.isscalar(c):
            cf = c
        elif hasattr(c, "_fp"):
            cf = c._fp()
        elif callable(c):
            cf = id(c)
        else:
            cf = np.asarray(c).tobytes()
        sf = self.scheme._fp() if self.scheme is not None else None
        return (self.classification, cf, sf, self.field_dependencies)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, other):
        return (isinstance(other, BoundaryCondition)
                and self._fp() == other._fp())

    def __repr__(self):
        return f"BoundaryCondition({self.classification}, {self.condition})"


def PeriodicBoundaryCondition():
    return BoundaryCondition(PERIODIC_BC)


def FluxBoundaryCondition(condition=None, field_dependencies=()):
    """``field_dependencies`` names prognostic fields whose
    boundary-adjacent values are passed as trailing arguments to a callable
    condition: ``f(ξ1, ξ2, t, *values)`` (reference:
    continuous_boundary_function.jl — e.g. quadratic drag laws).
    Supported for flux conditions, which enter the tendencies where the
    model state is available."""
    return BoundaryCondition(FLUX, condition,
                             field_dependencies=field_dependencies)


def FieldTimeSeriesBoundaryCondition(fts, classification=FLUX,
                                     field_dependencies=()):
    """A boundary condition driven by a saved
    :class:`~oceananigans_tpu.simulation.output_readers.FieldTimeSeries`,
    linearly interpolated in time INSIDE the jitted step (reference:
    FieldTimeSeries used directly as a BC condition, refreshed by
    update_model_field_time_series! — src/Models/Models.jl:48 and
    validation/field_time_series_boundary_conditions; here the interpolant
    is a traced gather, so no host-side refresh is needed).

    Snapshots must cover the interior of a z-normal boundary plane —
    shape ``(Nx, Ny)`` or ``(Nx, Ny, 1)`` — and are padded into the halo
    ring topology-aware by the BC evaluator (wrap on periodic axes, edge
    on bounded ones, so periodic-halo flux values match an analytic
    condition exactly). Use for top/bottom (axis-2) conditions."""
    return BoundaryCondition(classification,
                             _FieldTimeSeriesCondition(fts),
                             field_dependencies=field_dependencies)


class _FieldTimeSeriesCondition:
    """Condition recognized by ``eval_bc``: a traced time interpolation of
    a FieldTimeSeries over a z-normal boundary plane, halo-padded with the
    grid's topology in view."""

    __slots__ = ("fts",)

    def __init__(self, fts):
        self.fts = fts

    def evaluate_padded(self, grid, time):
        import jax.numpy as jnp
        a = self.fts.traced(time)
        a = a.reshape(a.shape[0], a.shape[1], -1)[..., :1]
        pads, modes = [], []
        for ax in range(2):
            npad = grid.padded_shape[ax] - a.shape[ax]
            pads.append((npad // 2, npad - npad // 2))
            modes.append("wrap" if grid.topology[ax] == PERIODIC
                         else "edge")
        if modes[0] == modes[1]:
            return jnp.pad(a, pads + [(0, 0)], mode=modes[0])
        a = jnp.pad(a, (pads[0], (0, 0), (0, 0)), mode=modes[0])
        return jnp.pad(a, ((0, 0), pads[1], (0, 0)), mode=modes[1])

    def _fp(self):
        return ("FieldTimeSeriesCondition", id(self.fts))


def ValueBoundaryCondition(condition=None):
    return BoundaryCondition(VALUE, condition)


def GradientBoundaryCondition(condition=None):
    return BoundaryCondition(GRADIENT, condition)


class ImmersedBoundaryCondition:
    """Per-side boundary conditions applied at IMMERSED faces (reference:
    src/ImmersedBoundaries/immersed_boundary_condition.jl): goes in the
    ``immersed`` slot of FieldBoundaryConditions; each side holds a Flux,
    Value, or Gradient condition applied wherever a fluid cell touches the
    topography from that side (e.g. bottom drag, geothermal flux, heated
    walls). Value/Gradient produce one-sided diffusive fluxes -κ∇c with
    ∇c = ±2(c_b - c)/Δ or the given gradient (reference:
    src/TurbulenceClosures/immersed_diffusive_fluxes.jl left/right_gradient)
    using the model closure's scalar diffusivity."""

    __slots__ = ("west", "east", "south", "north", "bottom", "top")

    def __init__(self, west=None, east=None, south=None, north=None,
                 bottom=None, top=None):
        for name, bc in (("west", west), ("east", east), ("south", south),
                         ("north", north), ("bottom", bottom), ("top", top)):
            if bc is not None and bc.classification not in (FLUX, VALUE,
                                                            GRADIENT):
                raise NotImplementedError(
                    "immersed boundary conditions must be Flux, Value, or "
                    f"Gradient (got {bc.classification!r} on {name})")
            setattr(self, name, bc)

    def side(self, name):
        return getattr(self, name)

    def _fp(self):
        return ("ImmersedBoundaryCondition",) + tuple(
            getattr(self, s)._fp() if getattr(self, s) is not None else None
            for s in self.__slots__)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return (isinstance(o, ImmersedBoundaryCondition)
                and self._fp() == o._fp())


def OpenBoundaryCondition(condition=None, scheme=None):
    """Open (cross-boundary flow) BC; ``scheme=PerturbationAdvection(...)``
    activates the relaxed upwind boundary update (reference:
    boundary_condition_classifications.jl Open{scheme})."""
    return BoundaryCondition(OPEN, condition, scheme)


def ImpenetrableBoundaryCondition():
    """No-penetration: wall-normal velocity face pinned to zero (reference:
    default boundary condition for wall-normal velocities)."""
    return BoundaryCondition(OPEN, None)


_SIDES = ("west", "east", "south", "north", "bottom", "top")
# side index → (axis, is_left)
SIDE_AXIS = {"west": (0, True), "east": (0, False),
             "south": (1, True), "north": (1, False),
             "bottom": (2, True), "top": (2, False)}


class FieldBoundaryConditions:
    """Per-side container (west/east/south/north/bottom/top + immersed).
    ``None`` entries are filled with topology-appropriate defaults by
    :func:`regularize_field_boundary_conditions` (reference:
    field_boundary_conditions.jl regularization)."""

    __slots__ = _SIDES + ("immersed",)

    def __init__(self, west=None, east=None, south=None, north=None,
                 bottom=None, top=None, immersed=None):
        self.west, self.east = west, east
        self.south, self.north = south, north
        self.bottom, self.top = bottom, top
        self.immersed = immersed

    def side(self, name):
        return getattr(self, name)

    def pair(self, axis):
        return (self.side(_SIDES[2 * axis]), self.side(_SIDES[2 * axis + 1]))

    def _fp(self):
        return tuple(getattr(self, s)._fp() if getattr(self, s) is not None else None
                     for s in self.__slots__)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, other):
        return (isinstance(other, FieldBoundaryConditions)
                and self._fp() == other._fp())

    def __repr__(self):
        parts = [f"{s}={getattr(self, s)!r}" for s in self.__slots__
                 if getattr(self, s) is not None]
        return "FieldBoundaryConditions(" + ", ".join(parts) + ")"


def default_bc(topology_axis, loc_axis):
    """Default BC for one side of one direction, from topology + location
    (reference: field_boundary_conditions.jl default rules)."""
    if topology_axis == PERIODIC:
        return PeriodicBoundaryCondition()
    if topology_axis == FLAT:
        return None
    # Bounded:
    if loc_axis == FACE:
        return ImpenetrableBoundaryCondition()   # wall-normal velocity
    return FluxBoundaryCondition(None)           # no-flux for centered fields


def ZipperBoundaryCondition(sign=1.0):
    """Tripolar north-fold BC (reference: fill_halo_regions_zipper.jl);
    ``sign`` = -1 for velocity-like fields, +1 for tracers."""
    return BoundaryCondition(ZIPPER, float(sign))


def PolarBoundaryCondition(side, loc_y):
    """Pole-touching lat-lon boundary (reference:
    polar_boundary_condition.jl maybe_polar_boundary_condition): Value with
    the recomputed zonal-mean pole value for center-located fields, Open
    (boundary face set to the zonal mean) for y-face fields like ``v``."""
    cond = PolarValue(side)
    if loc_y == FACE:
        return BoundaryCondition(OPEN, cond)
    return BoundaryCondition(VALUE, cond)


def default_bcs(grid, loc):
    kw = {}
    for side, (axis, _) in SIDE_AXIS.items():
        kw[side] = default_bc(grid.topology[axis], loc[axis])
    if getattr(grid, "zipper_north", False):
        # tripolar fold: velocity-like (Face in x or y) fields flip sign
        sign = -1.0 if (loc[0] == FACE or loc[1] == FACE) else 1.0
        kw["north"] = ZipperBoundaryCondition(sign)
    for side in ("south", "north"):
        if getattr(grid, f"polar_{side}", False):
            kw[side] = PolarBoundaryCondition(side, loc[1])
    return FieldBoundaryConditions(**kw)


def regularize_field_boundary_conditions(bcs, grid, loc):
    """Fill missing sides with defaults and validate topology compatibility."""
    if bcs is None:
        return default_bcs(grid, loc)
    kw = {}
    for side, (axis, _) in SIDE_AXIS.items():
        user = bcs.side(side)
        if user is None:
            if side == "north" and getattr(grid, "zipper_north", False):
                sign = -1.0 if (loc[0] == FACE or loc[1] == FACE) else 1.0
                kw[side] = ZipperBoundaryCondition(sign)
                continue
            if side in ("south", "north") and getattr(
                    grid, f"polar_{side}", False):
                kw[side] = PolarBoundaryCondition(side, loc[1])
                continue
            kw[side] = default_bc(grid.topology[axis], loc[axis])
        else:
            if grid.topology[axis] == PERIODIC and user.classification != PERIODIC_BC:
                raise ValueError(
                    f"cannot set {user.classification} BC on {side} of a periodic direction")
            if grid.topology[axis] == FLAT:
                raise ValueError(f"cannot set a BC on {side} of a flat direction")
            kw[side] = user
    kw["immersed"] = bcs.immersed
    return FieldBoundaryConditions(**kw)
