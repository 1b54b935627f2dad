"""Formal convergence-rate suite (reference: validation/convergence_tests —
one-dimensional advection/diffusion and point-exact solutions; the measured
orders are asserted, making the discretization order part of CI)."""

import jax.numpy as jnp
import numpy as np
import pytest

from oceananigans_tpu import RectilinearGrid
from oceananigans_tpu.advection import Centered, UpwindBiased, WENO, div_Uc
from oceananigans_tpu.models import NonhydrostaticModel


def _advection_operator_error(scheme, n):
    """L2 truncation error of -div_Uc for c = sin(x), u = 1 on a periodic
    line (analytic tendency: -cos(x))."""
    grid = RectilinearGrid(size=(n,), x=(0, 2 * np.pi),
                           topology=("periodic", "flat", "flat"),
                           halo=max(6, scheme.required_halo))
    xc = jnp.asarray(grid.coord_padded(0, "c")).reshape(-1, 1, 1)
    c = jnp.sin(xc) * jnp.ones(grid.padded_shape)
    u = jnp.ones(grid.padded_shape)
    G = -div_Uc(grid, scheme, u, 0 * u, 0 * u, c)
    xi = np.asarray(grid.xnodes("c"))
    err = np.asarray(grid.interior(G))[:, 0, 0] + np.cos(xi)
    return np.sqrt(np.mean(err ** 2))


def _order(errors, ns):
    return -np.polyfit(np.log(ns), np.log(errors), 1)[0]


@pytest.mark.parametrize("scheme,expected", [
    (Centered(2), 2), (Centered(4), 4),
    (UpwindBiased(3), 3), (UpwindBiased(5), 5),
    (WENO(5, smoothness_dtype=jnp.float64), 5),
    (WENO(7, smoothness_dtype=jnp.float64), 7),
])
def test_advection_operator_convergence(scheme, expected):
    ns = (16, 32, 64, 128)
    errs = [_advection_operator_error(scheme, n) for n in ns]
    p = _order(errs, ns)
    assert p > expected - 0.35, (p, errs)


def test_diffusion_operator_convergence():
    """∇² truncation: 2nd order."""
    from oceananigans_tpu.operators.operators import laplacian_ccc
    errs, ns = [], (16, 32, 64, 128)
    for n in ns:
        grid = RectilinearGrid(size=(n,), x=(0, 2 * np.pi),
                               topology=("periodic", "flat", "flat"))
        xc = jnp.asarray(grid.coord_padded(0, "c")).reshape(-1, 1, 1)
        c = jnp.sin(xc) * jnp.ones(grid.padded_shape)
        lap = np.asarray(grid.interior(laplacian_ccc(grid, c)))[:, 0, 0]
        xi = np.asarray(grid.xnodes("c"))
        errs.append(np.sqrt(np.mean((lap + np.sin(xi)) ** 2)))
    assert _order(errs, ns) > 1.8


def _advected_gaussian_error(n, scheme):
    """Time-stepped convergence (reference:
    validation/convergence_tests/point_exact_advection): a Gaussian tracer
    advected once around a periodic domain by u = 1 returns to its initial
    profile; dt shrinks with the grid so the spatial error dominates."""
    L, U, T = 1.0, 1.0, 0.5
    grid = RectilinearGrid(size=(n,), x=(0, L),
                           topology=("periodic", "flat", "flat"),
                           halo=6, dtype=jnp.float64)
    model = NonhydrostaticModel(grid=grid, advection=scheme, tracers=("c",))
    sig = 0.08
    c0 = lambda x, y, z: jnp.exp(-(x - 0.5) ** 2 / (2 * sig ** 2))
    model.set(u=U, c=c0)
    dt = 0.2 * (L / n) / U
    steps = int(round(T / dt))
    dt = T / steps
    for _ in range(steps):
        model.time_step(dt)
    x = np.asarray(grid.xnodes("c"))
    exact = np.exp(-(np.mod(x - U * T - 0.5 + L / 2, L) - L / 2) ** 2
                   / (2 * sig ** 2))
    c = np.asarray(model.field("c").interior)[:, 0, 0]
    return np.sqrt(np.mean((c - exact) ** 2))


@pytest.mark.parametrize("scheme,expected", [
    (Centered(2), 2.0),
    (WENO(5, smoothness_dtype=jnp.float64), 3.0),
])
def test_time_stepped_advection_convergence(scheme, expected):
    """End-to-end model convergence on the advected Gaussian (WENO-5's
    formal order shows as ≥3 at these resolutions because the nonlinear
    weights see the Gaussian's inflection points — same behavior as the
    reference's convergence study)."""
    ns = (32, 64, 128)
    errs = [_advected_gaussian_error(n, scheme) for n in ns]
    p = _order(errs, ns)
    assert p > expected - 0.3, (p, errs)


def test_diffusion_decay_exactness():
    """Diffusion of sin(x): c(t) = e^{-κt} sin(x); the implicit/explicit
    split matches the analytic decay to the scheme's temporal order."""
    from oceananigans_tpu.closures.scalar_diffusivity import ScalarDiffusivity
    n, kappa, T = 64, 0.1, 1.0
    grid = RectilinearGrid(size=(n,), x=(0, 2 * np.pi),
                           topology=("periodic", "flat", "flat"),
                           dtype=jnp.float64)
    model = NonhydrostaticModel(grid=grid, advection=None, tracers=("c",),
                                closure=ScalarDiffusivity(kappa=kappa))
    model.set(c=lambda x, y, z: jnp.sin(x))
    steps = 200
    for _ in range(steps):
        model.time_step(T / steps)
    x = np.asarray(grid.xnodes("c"))
    c = np.asarray(model.field("c").interior)[:, 0, 0]
    exact = np.exp(-kappa * T) * np.sin(x)
    err = np.abs(c - exact).max()
    assert err < 5e-4, err
