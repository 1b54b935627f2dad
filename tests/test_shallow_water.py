"""ShallowWaterModel tests (reference analogue:
test/test_shallow_water_models.jl)."""

import jax.numpy as jnp
import numpy as np
import pytest

from oceananigans_tpu import RectilinearGrid
from oceananigans_tpu.advection import WENO, Centered
from oceananigans_tpu.coriolis import FPlane
from oceananigans_tpu.models.shallow_water import (CONSERVATIVE,
                                                   VECTOR_INVARIANT,
                                                   ShallowWaterModel)


def grid2d(n=32, L=10.0):
    return RectilinearGrid(size=(n, n), x=(0, L), y=(0, L),
                           topology=("periodic", "periodic", "flat"))


def test_construction_and_step():
    model = ShallowWaterModel(grid=grid2d(), gravitational_acceleration=9.81)
    model.set(h=1.0)
    model.time_step(1e-3)
    assert model.iteration == 1
    # field() refreshes halos; between steps only interiors are
    # authoritative
    assert np.all(np.isfinite(np.asarray(model.field("h").data)))


def test_lake_at_rest_is_steady():
    # well-balanced: flat surface over bathymetry must stay at rest
    g = grid2d(16)
    depth = 1.0
    hB = lambda x, y, z: 0.2 * jnp.exp(-((x - 5) ** 2 + (y - 5) ** 2))
    model = ShallowWaterModel(grid=g, gravitational_acceleration=9.81,
                              bathymetry=hB)
    model.set(h=lambda x, y, z: depth - 0.2 * jnp.exp(
        -((x - 5) ** 2 + (y - 5) ** 2)))
    for _ in range(10):
        model.time_step(1e-3)
    uh = np.asarray(model.field("uh").interior)
    assert np.max(np.abs(uh)) < 1e-10


def test_gravity_wave_speed():
    # small-amplitude wave propagates at c = sqrt(g H)
    gacc, H = 9.81, 1.0
    n, L = 128, 10.0
    g = RectilinearGrid(size=(n, 1), x=(0, L), y=(0, 1),
                        topology=("periodic", "periodic", "flat"))
    model = ShallowWaterModel(grid=g, gravitational_acceleration=gacc,
                              advection=Centered(2))
    eps = 1e-6
    model.set(h=lambda x, y, z: H + eps * jnp.sin(2 * jnp.pi * x / L))
    c = np.sqrt(gacc * H)
    T = L / c  # one period across the domain
    dt = 0.2 * (L / n) / c
    steps = int(round(T / dt))
    dt = T / steps
    for _ in range(steps):
        model.time_step(dt)
    h = np.asarray(model.field("h").interior)[:, 0, 0]
    x = g.xnodes("c")
    # after one period the wave pattern returns (two counter-propagating
    # modes, both period T)
    expected = H + eps * np.sin(2 * np.pi * x / L)
    err = np.max(np.abs(h - expected)) / eps
    assert err < 0.05, err


def test_mass_conservation():
    model = ShallowWaterModel(grid=grid2d(), advection=WENO(5),
                              gravitational_acceleration=9.81,
                              coriolis=FPlane(f=1.0))
    rng = np.random.default_rng(0)
    model.set(h=1.0 + 0.1 * rng.random((32, 32)),
              uh=0.1 * rng.standard_normal((32, 32)),
              vh=0.1 * rng.standard_normal((32, 32)))
    m0 = float(model.field("h").sum())
    for _ in range(10):
        model.time_step(1e-3)
    m1 = float(model.field("h").sum())
    assert np.isclose(m0, m1, rtol=1e-12)
    assert np.all(np.isfinite(np.asarray(model.field("uh").data)))


def test_bickley_jet_instability_runs():
    # BASELINE config 2: Bickley jet with a perturbation develops without NaN
    g = grid2d(48, L=4 * np.pi)
    model = ShallowWaterModel(grid=g, gravitational_acceleration=10.0,
                              advection=WENO(5), coriolis=FPlane(f=1.0))
    Ly = 4 * np.pi

    def uh0(x, y, z):
        yc = y - Ly / 2
        U = 1.0 / jnp.cosh(yc) ** 2
        pert = 1e-4 * jnp.exp(-yc ** 2) * jnp.cos(3 * x * 2 * jnp.pi / Ly)
        return U + pert

    model.set(h=10.0, uh=uh0)
    for _ in range(50):
        model.time_step(2e-3)
    assert np.all(np.isfinite(np.asarray(model.field("uh").data)))


def test_vector_invariant_formulation():
    model = ShallowWaterModel(grid=grid2d(16),
                              gravitational_acceleration=9.81,
                              formulation=VECTOR_INVARIANT)
    assert model.prognostic_names[:3] == ("u", "v", "h")
    model.set(h=1.0, u=lambda x, y, z: 0.01 * jnp.sin(2 * jnp.pi * y / 10))
    for _ in range(5):
        model.time_step(1e-3)
    assert np.all(np.isfinite(np.asarray(model.state["fields"]["u"])))


def test_tracer_advection_in_swm():
    model = ShallowWaterModel(grid=grid2d(16), tracers=("c",),
                              gravitational_acceleration=9.81)
    model.set(h=1.0, c=lambda x, y, z: jnp.exp(-((x - 5) ** 2 + (y - 5) ** 2)),
              uh=0.1)
    c0 = float(model.field("c").max())
    for _ in range(10):
        model.time_step(1e-3)
    c1 = np.asarray(model.field("c").interior)
    assert np.all(np.isfinite(c1))
    assert abs(float(c1.max()) - c0) < 0.1


def test_requires_flat_z():
    with pytest.raises(ValueError):
        ShallowWaterModel(grid=RectilinearGrid(size=(8, 8, 8),
                                               extent=(1, 1, 1)))
