"""Automatic differentiation through the model step.

The reference needs a dedicated Enzyme extension with custom rules
(ext/OceananigansEnzymeExt.jl, 472 LoC); here the step IS a pure traced
function, so `jax.grad` works end-to-end for free — gradients of any scalar
diagnostic with respect to initial conditions or parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oceananigans_tpu import RectilinearGrid
from oceananigans_tpu.advection import Centered
from oceananigans_tpu.models import NonhydrostaticModel


@pytest.mark.slow
def test_gradient_through_steps():
    grid = RectilinearGrid(size=(8, 8, 4), extent=(1, 1, 1),
                           topology=("periodic", "periodic", "periodic"))
    model = NonhydrostaticModel(grid=grid, tracers=("c",),
                                advection=Centered(2))
    model.set(u=lambda x, y, z: 0.1 * jnp.sin(2 * jnp.pi * x))
    step = model._build_step()
    dt = jnp.asarray(1e-2, grid.dtype)
    base_state = model.state

    def loss(c0):
        state = dict(base_state)
        fields = dict(state["fields"])
        fields["c"] = c0
        state["fields"] = fields
        for _ in range(3):
            state = step(state, dt)
        return jnp.sum(state["fields"]["c"][grid.interior_slices] ** 2)

    c0 = model.state["fields"]["c"] + 0.1
    g = jax.grad(loss)(c0)
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.abs(g).max()) > 0

    # finite-difference check on one entry
    eps = 1e-4
    idx = (6, 6, 4)
    e = jnp.zeros_like(c0).at[idx].set(eps)
    fd = (loss(c0 + e) - loss(c0 - e)) / (2 * eps)
    assert np.isclose(float(fd), float(g[idx]), rtol=1e-4), (fd, g[idx])


def test_gradient_wrt_viscosity_parameter():
    # differentiate through the closure parameter: d KE / d nu < 0
    grid = RectilinearGrid(size=(8, 8, 4), extent=(1, 1, 1),
                           topology=("periodic", "periodic", "periodic"))
    from oceananigans_tpu.closures import ScalarDiffusivity
    rng = np.random.default_rng(0)
    u0 = 0.1 * rng.standard_normal((8, 8, 4))

    def ke_after(nu):
        # rebuild the tendency path with a traced nu: use forcing-style
        # diffusion to keep the configuration static
        model = NonhydrostaticModel(grid=grid)
        model.set(u=u0)
        state = model.state
        step = model._build_step()
        from oceananigans_tpu.closures.diffusion_operators import div_kappa_grad

        def diffuse(state, nu):
            f = dict(state["fields"])
            f["u"] = f["u"] + 1e-2 * div_kappa_grad(
                model.grid, f["u"], ("f", "c", "c"), nu)
            return dict(state, fields=f)

        for _ in range(2):
            state = step(state, jnp.asarray(1e-2, grid.dtype))
            state = diffuse(state, nu)
        return jnp.sum(state["fields"]["u"][grid.interior_slices] ** 2)

    g = jax.grad(ke_after)(jnp.asarray(0.01, grid.dtype))
    assert float(g) < 0  # more viscosity, less kinetic energy
