"""The reference's test_time_stepping.jl matrix (test/test_time_stepping.jl):
time stepping works across flat topologies × Coriolis planes × closures ×
advection schemes × Stokes drifts × EOSes × float types × timesteppers, the
first-AB2-step semantics reduce to forward Euler, the velocity field stays
divergence-free over many steps, and a coarse channel conserves its tracer.
Every case is tiny (1³-3³ grids, 1-2 steps) — this file is breadth, the
physics-accuracy tests live in test_validation.py / test_convergence.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from oceananigans_tpu import (AnisotropicMinimumDissipation, BackgroundField,
                              CATKEVerticalDiffusivity,
                              HorizontalScalarDiffusivity,
                              IsopycnalSkewSymmetricDiffusivity,
                              RectilinearGrid, ScalarBiharmonicDiffusivity,
                              ScalarDiffusivity, Smagorinsky, SmagorinskyLilly,
                              TwoDimensionalLeith,
                              VerticalScalarDiffusivity)
from oceananigans_tpu.advection import WENO, Centered, UpwindBiased
from oceananigans_tpu.buoyancy import (BuoyancyTracer,
                                       RoquetSecondOrderEquationOfState,
                                       SeawaterBuoyancy,
                                       TEOS10EquationOfState)
from oceananigans_tpu.closures.smagorinsky import (DynamicCoefficient,
                                                   LagrangianAveraging)
from oceananigans_tpu.coriolis import (BetaPlane, ConstantCartesianCoriolis,
                                       FPlane, NonTraditionalBetaPlane)
from oceananigans_tpu.models import NonhydrostaticModel
from oceananigans_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from oceananigans_tpu.operators.operators import div_ccc
from oceananigans_tpu.stokes_drift import StokesDrift, UniformStokesDrift

TIMESTEPPERS = ("QuasiAdamsBashforth2", "RungeKutta3")


def tiny_grid(n=1, halo=None, dtype=None):
    kw = {} if halo is None else {"halo": (halo, halo, halo)}
    if dtype is not None:
        kw["dtype"] = dtype
    return RectilinearGrid(size=(n, n, n), x=(0, 1.0), y=(0, 2.0),
                           z=(-3.0, 0.0),
                           topology=("periodic", "periodic", "bounded"), **kw)


def steps_ok(model, n=2, dt=1e-3):
    for _ in range(n):
        model.time_step(dt)
    for name in ("u", "v"):
        assert np.isfinite(np.asarray(model.field(name).interior)).all()
    return True


# -- flat dimensions (time_stepping_works_with_flat_dimensions) --------------

@pytest.mark.parametrize("topology,size", [
    (("flat", "periodic", "bounded"), (4, 4)),
    (("periodic", "flat", "bounded"), (4, 4)),
    (("periodic", "periodic", "flat"), (4, 4)),
    (("flat", "flat", "bounded"), (4,)),
    (("periodic", "flat", "flat"), (4,)),
])
def test_flat_dimensions(topology, size):
    extent = tuple(1.0 for _ in size)
    grid = RectilinearGrid(size=size, extent=extent, topology=topology)
    model = NonhydrostaticModel(grid=grid)
    assert steps_ok(model)


# -- Coriolis planes × steppers (time_stepping_works_with_coriolis) ----------

@pytest.mark.parametrize("stepper", TIMESTEPPERS)
@pytest.mark.parametrize("plane", [
    FPlane(latitude=45.0),
    ConstantCartesianCoriolis(f=1e-4, rotation_axis=(0, 0.5, 0.866)),
    BetaPlane(latitude=45.0),
    NonTraditionalBetaPlane(latitude=45.0),
])
def test_coriolis_matrix(plane, stepper):
    model = NonhydrostaticModel(grid=tiny_grid(), coriolis=plane,
                                timestepper=stepper)
    assert steps_ok(model)


# -- closures × models (time_stepping_works_with_closure) --------------------

CLOSURES = [
    ScalarDiffusivity(nu=1e-4, kappa=1e-4),
    ScalarBiharmonicDiffusivity(nu=1e-4, kappa=1e-4),
    TwoDimensionalLeith(),
    IsopycnalSkewSymmetricDiffusivity(kappa_redi=1.0, kappa_gm=1.0),
    Smagorinsky(coefficient=0.16),
    SmagorinskyLilly(),
    Smagorinsky(coefficient=DynamicCoefficient(averaging=(0, 1))),
    Smagorinsky(coefficient=DynamicCoefficient(averaging=LagrangianAveraging())),
    AnisotropicMinimumDissipation(),
    AnisotropicMinimumDissipation(Cb=1.0),
    CATKEVerticalDiffusivity(),
]


@pytest.mark.parametrize("closure", CLOSURES,
                         ids=lambda c: type(c).__name__ + (
                             "_dyn" if getattr(c, "coefficient", None)
                             is not None and not np.isscalar(c.coefficient)
                             else ""))
def test_closure_matrix_nonhydrostatic(closure):
    tracers = ("T", "S")
    if isinstance(closure, CATKEVerticalDiffusivity):
        tracers = ("T", "S", "e")
    model = NonhydrostaticModel(grid=tiny_grid(3, halo=3), closure=closure,
                                tracers=tracers,
                                buoyancy=SeawaterBuoyancy())
    assert steps_ok(model)


@pytest.mark.parametrize("closure", [
    ScalarDiffusivity(nu=1e-4, kappa=1e-4),
    IsopycnalSkewSymmetricDiffusivity(kappa_redi=1.0, kappa_gm=1.0),
    CATKEVerticalDiffusivity(),
])
def test_closure_matrix_hydrostatic(closure):
    tracers = ("T", "S")
    if isinstance(closure, CATKEVerticalDiffusivity):
        tracers = ("T", "S", "e")
    model = HydrostaticFreeSurfaceModel(grid=tiny_grid(3, halo=3),
                                        closure=closure, tracers=tracers,
                                        buoyancy=SeawaterBuoyancy())
    assert steps_ok(model)


# -- advection schemes (time_stepping_works_with_advection_scheme) -----------

@pytest.mark.parametrize("scheme", [
    None, UpwindBiased(1), Centered(2), UpwindBiased(3), Centered(4),
    UpwindBiased(5), WENO(5), WENO(9)],
    ids=lambda s: repr(s))
def test_advection_scheme_matrix(scheme):
    halo = max(3, getattr(scheme, "required_halo", 1))
    model = NonhydrostaticModel(grid=tiny_grid(3, halo=halo),
                                advection=scheme)
    assert steps_ok(model)


# -- Stokes drifts (time_stepping_works_with_stokes_drift) -------------------

H = 20.0
STOKES = [
    UniformStokesDrift(),
    StokesDrift(),
    UniformStokesDrift(grad_t_us=lambda z, t: jnp.exp(z / H) * jnp.cos(t),
                       grad_t_vs=lambda z, t: jnp.exp(z / H) * jnp.cos(t),
                       grad_z_us=lambda z, t: jnp.exp(z / H) / H * jnp.sin(t),
                       grad_z_vs=lambda z, t: jnp.exp(z / H) / H * jnp.sin(t)),
    StokesDrift(dt_us=lambda x, y, z, t: jnp.exp(z / H) * jnp.cos(t),
                dt_vs=lambda x, y, z, t: jnp.exp(z / H) * jnp.cos(t),
                dz_us=lambda x, y, z, t: jnp.exp(z / H) / H * jnp.sin(t),
                dz_vs=lambda x, y, z, t: jnp.exp(z / H) / H * jnp.sin(t)),
]


@pytest.mark.parametrize("drift", STOKES,
                         ids=["uniform0", "general0", "uniform", "general"])
def test_stokes_drift_matrix(drift):
    model = NonhydrostaticModel(grid=tiny_grid(3, halo=3),
                                stokes_drift=drift, advection=None)
    assert steps_ok(model)


# -- nonlinear EOS (time_stepping_works_with_nonlinear_eos) ------------------

@pytest.mark.parametrize("eos", [None, RoquetSecondOrderEquationOfState,
                                 TEOS10EquationOfState],
                         ids=["linear", "roquet2", "teos10"])
def test_eos_matrix(eos):
    b = SeawaterBuoyancy() if eos is None \
        else SeawaterBuoyancy(equation_of_state=eos())
    model = NonhydrostaticModel(grid=tiny_grid(), buoyancy=b,
                                tracers=("T", "S"))
    model.set(T=10.0, S=35.0)
    assert steps_ok(model)


# -- float types -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("stepper", TIMESTEPPERS)
def test_float_types(dtype, stepper):
    model = NonhydrostaticModel(grid=tiny_grid(3, halo=3, dtype=dtype),
                                advection=WENO(5), timestepper=stepper)
    model.set(u=0.1)
    assert steps_ok(model)
    assert model.field("u").interior.dtype == dtype


# -- first AB2 step reduces to forward Euler (run_first_AB2_time_step_tests) -

def test_first_ab2_step_is_euler():
    # weird size catches the reference's issue #780 class of indexing bugs
    grid = RectilinearGrid(size=(13, 17, 19), extent=(1, 2, 3))
    model = NonhydrostaticModel(grid=grid, timestepper="QuasiAdamsBashforth2",
                                buoyancy=SeawaterBuoyancy(),
                                tracers=("T", "S"),
                                forcing={"T": lambda g, f, t: 1.0})
    dt = 1.0
    model.time_step(dt)
    # forcing 1 for one Euler step: T = dt exactly; the AB2 3/2-1/2 weights
    # would give 1.5 dt if the Euler fallback were broken
    T = np.asarray(model.field("T").interior)
    assert np.allclose(T, 1.0, atol=1e-12)
    assert np.allclose(np.asarray(model.field("S").interior), 0.0)
    for name in ("u", "v", "w"):
        assert np.allclose(np.asarray(model.field(name).interior), 0.0,
                           atol=1e-12)


# -- incompressibility over many steps (incompressible_in_time) --------------

@pytest.mark.parametrize("stepper", TIMESTEPPERS)
def test_incompressible_in_time(stepper):
    grid = RectilinearGrid(size=(16, 16, 16), extent=(1.0, 1.0, 1.0),
                           topology=("periodic", "periodic", "bounded"))
    model = NonhydrostaticModel(grid=grid, timestepper=stepper,
                                buoyancy=BuoyancyTracer(), tracers=("b",))
    b0 = np.zeros((16, 16, 16))
    b0[4:12, 4:12, 4:12] = 0.01
    model.set(b=b0)
    for _ in range(10):
        model.time_step(0.05)
    st = model.state["fields"]
    from oceananigans_tpu.boundary_conditions.fill_halos import \
        fill_halo_regions
    u = fill_halo_regions(st["u"], grid, ("f", "c", "c"), model.bcs["u"])
    v = fill_halo_regions(st["v"], grid, ("c", "f", "c"), model.bcs["v"])
    w = st["w"] if "w" in st else model.state["w"]
    div = np.asarray(div_ccc(grid, u, v, w))[grid.interior_slices]
    assert np.abs(div).max() < 5e-8


# -- coarse-channel tracer conservation (tracer_conserved_in_channel) --------

def test_tracer_conserved_in_channel():
    Nx, Ny, Nz = 8, 16, 8
    grid = RectilinearGrid(size=(Nx, Ny, Nz), extent=(160e3, 320e3, 1024.0),
                           topology=("periodic", "bounded", "bounded"))
    alpha = (1024.0 / Nz) / (160e3 / Nx)
    model = NonhydrostaticModel(
        grid=grid,
        closure=(HorizontalScalarDiffusivity(nu=20.0, kappa=20.0),
                 VerticalScalarDiffusivity(nu=alpha * 20.0,
                                           kappa=alpha * 20.0)),
        buoyancy=SeawaterBuoyancy(), tracers=("T", "S"))
    rng = np.random.default_rng(7)
    model.set(T=lambda x, y, z: 10 + 1e-4 * y + 5e-3 * z, S=35.0)
    model.set(T=np.asarray(model.field("T").interior)
              + 1e-4 * rng.random((Nx, Ny, Nz)))
    T0 = float(np.asarray(model.field("T").interior).mean())
    for _ in range(10):
        model.time_step(600.0)
    T1 = float(np.asarray(model.field("T").interior).mean())
    assert abs(T1 - T0) < Nx * Ny * Nz * np.finfo(np.float64).eps * 100


# -- background fields step (time_stepping_with_background_fields) -----------

def test_background_fields_step():
    model = NonhydrostaticModel(
        grid=tiny_grid(), buoyancy=SeawaterBuoyancy(),
        tracers=("T", "S", "R"),
        background_fields={
            "u": lambda x, y, z, t: np.pi,
            "v": lambda x, y, z, t: jnp.sin(x) * jnp.cos(y) * jnp.exp(t),
            "w": BackgroundField(lambda x, y, z, t, p:
                                 p["alpha"] * x + p["beta"]
                                 * jnp.exp(z / p["lam"]),
                                 parameters={"alpha": 1.2, "beta": 0.2,
                                             "lam": 43.0}),
            "T": lambda x, y, z, t: np.pi,
            "S": BackgroundField(lambda x, y, z, t, a: a * y,
                                 parameters=1.2),
            "R": BackgroundField(1.0),
        })
    assert steps_ok(model)


# -- round-5 review regressions ----------------------------------------------

def test_vertical_diffusivity_positional_time_discretization():
    """All positional spellings of the time discretization bind correctly
    (a review-found silent-explicit bug: the 3rd positional was dropped)."""
    from oceananigans_tpu import (VerticallyImplicitTimeDiscretization,
                                  VerticalScalarDiffusivity)
    td = VerticallyImplicitTimeDiscretization()
    assert VerticalScalarDiffusivity(
        1e-4, 1e-5, td).time_discretization == "vertically_implicit"
    assert VerticalScalarDiffusivity(
        td, 1e-4, 1e-5).time_discretization == "vertically_implicit"
    assert VerticalScalarDiffusivity(
        nu=1e-4, time_discretization=td
    ).time_discretization == "vertically_implicit"
    assert HorizontalScalarDiffusivity(1e-4, 1e-5).nu == 1e-4
    with pytest.raises(TypeError):
        VerticalScalarDiffusivity(1e-4, 1e-5, td, 7)


def test_cubed_sphere_closure_tuple_steps():
    """Closure tuples on the cubed sphere (a review-found crash: the tuple
    was wrapped after the attribute assignment)."""
    from oceananigans_tpu.grids.cubed_sphere import ConformalCubedSphereGrid
    from oceananigans_tpu.models import CubedSphereHydrostaticModel

    grid = RectilinearGrid  # silence linters; real grid below
    csgrid = ConformalCubedSphereGrid((8, 8, 3), z=(-1000.0, 0.0),
                                      radius=6.371e6)
    m = CubedSphereHydrostaticModel(
        csgrid, tracers=("b",), rotation_rate=7.292e-5,
        closure=(VerticalScalarDiffusivity(nu=1e-3, kappa=1e-3),
                 HorizontalScalarDiffusivity(nu=10.0, kappa=10.0)))
    m.set(b=lambda lam, phi, z: 1e-5 * z)
    m.time_step(300.0)
    assert np.isfinite(np.asarray(m.field("b").interior)).all()
