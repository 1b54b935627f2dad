"""NonhydrostaticModel integration tests (reference analogue:
test/test_nonhydrostatic_models.jl, test_dynamics.jl, test_time_stepping.jl)."""

import jax.numpy as jnp
import numpy as np
import pytest

from oceananigans_tpu import RectilinearGrid
from oceananigans_tpu.advection import Centered, WENO
from oceananigans_tpu.buoyancy import BuoyancyTracer, SeawaterBuoyancy
from oceananigans_tpu.closures.scalar_diffusivity import ScalarDiffusivity
from oceananigans_tpu.coriolis import FPlane
from oceananigans_tpu.models import NonhydrostaticModel
from oceananigans_tpu.operators import div_ccc


def max_divergence(model):
    g = model.grid
    f = model.state["fields"]
    from oceananigans_tpu.boundary_conditions import fill_halo_regions
    u = fill_halo_regions(f["u"], g, ("f", "c", "c"), model.bcs["u"])
    v = fill_halo_regions(f["v"], g, ("c", "f", "c"), model.bcs["v"])
    w = fill_halo_regions(f["w"], g, ("c", "c", "f"), model.bcs["w"])
    d = g.interior(div_ccc(g, u, v, w))
    return float(np.max(np.abs(np.asarray(d))))


def test_model_construction_and_step():
    grid = RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1))
    model = NonhydrostaticModel(grid=grid, advection=Centered(2),
                                tracers=("T",))
    assert model.prognostic_names == ("u", "v", "w", "T")
    model.set(u=lambda x, y, z: jnp.sin(2 * jnp.pi * x) * 0.1,
              T=lambda x, y, z: z)
    model.time_step(1e-3)
    assert model.iteration == 1
    assert np.isclose(model.time, 1e-3)
    assert np.all(np.isfinite(np.asarray(model.state["fields"]["u"])))


@pytest.mark.parametrize("stepper", ["RungeKutta3", "QuasiAdamsBashforth2"])
def test_divergence_free_after_steps(stepper, rng):
    grid = RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1),
                           topology=("periodic", "periodic", "periodic"))
    model = NonhydrostaticModel(grid=grid, advection=Centered(2),
                                timestepper=stepper)
    model.set(u=rng.normal(size=(8, 8, 8)) * 0.1,
              v=rng.normal(size=(8, 8, 8)) * 0.1,
              w=rng.normal(size=(8, 8, 8)) * 0.1)
    assert max_divergence(model) < 1e-10     # set() projects
    for _ in range(3):
        model.time_step(0.01)
    assert max_divergence(model) < 1e-9
    assert np.all(np.isfinite(np.asarray(model.state["fields"]["u"])))


@pytest.mark.slow
def test_taylor_green_viscous_decay():
    # 2D Taylor-Green: u = -cos(x) sin(y) e^{-2νt}, exact for the continuous
    # equations; at 64² with Centered(2) the decay rate should match within ~1%
    nu = 0.05
    n = 64
    grid = RectilinearGrid(size=(n, n), x=(0, 2 * np.pi), y=(0, 2 * np.pi),
                           topology=("periodic", "periodic", "flat"))
    model = NonhydrostaticModel(
        grid=grid, advection=Centered(2),
        closure=ScalarDiffusivity(nu=nu))
    model.set(u=lambda x, y, z: -jnp.cos(x) * jnp.sin(y),
              v=lambda x, y, z: jnp.sin(x) * jnp.cos(y))
    dt = 0.01
    T = 0.5
    for _ in range(int(T / dt)):
        model.time_step(dt)
    u = np.asarray(model.field("u").interior)
    xg = grid.xnodes("f")
    yg = grid.ynodes("c")
    exact = (-np.cos(xg)[:, None] * np.sin(yg)[None, :]
             * np.exp(-2 * nu * model.time))
    err = np.max(np.abs(u[:, :, 0] - exact))
    assert err < 2e-3, err


def test_tracer_diffusion_gaussian():
    # 1D diffusion: variance of a Gaussian grows like 2κt
    kappa = 0.1
    grid = RectilinearGrid(size=(128, 1, 1), x=(-2, 2), y=None, z=None,
                           topology=("periodic", "flat", "flat"))
    model = NonhydrostaticModel(grid=grid, tracers=("c",),
                                closure=ScalarDiffusivity(kappa={"c": kappa}))
    sig0 = 0.1
    model.set(c=lambda x, y, z: jnp.exp(-x ** 2 / (2 * sig0 ** 2)))
    dt = 2e-4
    nsteps = 250
    for _ in range(nsteps):
        model.time_step(dt)
    t = model.time
    x = grid.xnodes("c")
    c = np.asarray(model.field("c").interior)[:, 0, 0]
    var = np.sum(c * x ** 2) / np.sum(c)
    expected = sig0 ** 2 + 2 * kappa * t
    assert abs(var - expected) / expected < 0.02


def test_tracer_conservation():
    grid = RectilinearGrid(size=(16, 16, 8), extent=(1, 1, 1))
    model = NonhydrostaticModel(grid=grid, advection=WENO(5), tracers=("c",))
    rng = np.random.default_rng(5)
    model.set(u=rng.normal(size=(16, 16, 8)) * 0.1,
              v=rng.normal(size=(16, 16, 8)) * 0.1,
              c=rng.random(size=(16, 16, 8)))
    total0 = float(model.field("c").sum())
    for _ in range(5):
        model.time_step(0.005)
    total = float(model.field("c").sum())
    assert np.isclose(total, total0, rtol=1e-12)


def test_buoyancy_accelerates_w():
    grid = RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1))
    model = NonhydrostaticModel(grid=grid, buoyancy=BuoyancyTracer(),
                                tracers=("b",))
    model.set(b=lambda x, y, z: 0.01 * jnp.exp(
        -((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02 - ((z + 0.5) ** 2) / 0.02))
    model.time_step(0.01)
    w = np.asarray(model.field("w").interior)
    assert w.max() > 0  # buoyant blob rises


def test_coriolis_inertial_oscillation():
    # uniform flow on an f-plane rotates: u(t) = U cos(ft), v = -U sin(ft)
    f = 1.0
    grid = RectilinearGrid(size=(4, 4, 4), extent=(1, 1, 1),
                           topology=("periodic", "periodic", "periodic"))
    model = NonhydrostaticModel(grid=grid, coriolis=FPlane(f=f))
    U = 0.1
    model.set(u=U)
    dt = 0.01
    n = 100
    for _ in range(n):
        model.time_step(dt)
    t = model.time
    u = float(np.mean(np.asarray(model.field("u").interior)))
    v = float(np.mean(np.asarray(model.field("v").interior)))
    assert abs(u - U * np.cos(f * t)) < 1e-4
    assert abs(v + U * np.sin(f * t)) < 1e-4


def test_seawater_buoyancy_tracers():
    grid = RectilinearGrid(size=(4, 4, 4), extent=(1, 1, 1))
    model = NonhydrostaticModel(grid=grid, buoyancy=SeawaterBuoyancy())
    assert set(model.tracer_names) == {"T", "S"}
    model.set(T=lambda x, y, z: 20 + z, S=35.0)
    model.time_step(0.01)
    assert np.all(np.isfinite(np.asarray(model.state["fields"]["w"])))


def test_forcing_term():
    grid = RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1),
                           topology=("periodic", "periodic", "periodic"))
    F = 1e-3

    def u_forcing(grid, fields, time):
        return jnp.full(grid.padded_shape, F, grid.dtype)

    model = NonhydrostaticModel(grid=grid, forcing={"u": u_forcing})
    model.time_step(0.1)
    u = float(np.mean(np.asarray(model.field("u").interior)))
    assert np.isclose(u, F * 0.1, rtol=1e-6)


def test_vertically_implicit_diffusion_stability():
    # explicit stability limit dt < dz²/(2κ) strongly violated → implicit must
    # stay stable and conserve the tracer mean
    grid = RectilinearGrid(size=(4, 4, 32), extent=(1, 1, 1))
    kappa = 1.0
    model = NonhydrostaticModel(
        grid=grid, tracers=("c",),
        closure=ScalarDiffusivity(kappa={"c": kappa}, formulation="vertical",
                                  time_discretization="vertically_implicit"))
    model.set(c=lambda x, y, z: jnp.exp(-((z + 0.5) / 0.1) ** 2))
    total0 = float(model.field("c").sum())
    dt = 0.1  # dz² / 2κ ≈ 5e-4 ⇒ 200× the explicit limit
    for _ in range(5):
        model.time_step(dt)
    c = np.asarray(model.field("c").interior)
    assert np.all(np.isfinite(c))
    assert np.isclose(float(model.field("c").sum()), total0, rtol=1e-10)
    # end state ≈ fully mixed
    assert np.max(c) - np.min(c) < 0.05
