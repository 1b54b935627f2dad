"""The platform module: compile-cache placement, the GPU guard, and no
Pallas call left in any model's step."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oceananigans_tpu import RectilinearGrid, platform
from oceananigans_tpu.advection import WENO, WENOVectorInvariant
from oceananigans_tpu.models import (HydrostaticFreeSurfaceModel,
                                     NonhydrostaticModel)
from oceananigans_tpu.models.shallow_water import ShallowWaterModel


@pytest.mark.parametrize("from_env", [True, False])
def test_compilation_cache_dir(monkeypatch, from_env):
    before = jax.config.jax_compilation_cache_dir
    try:
        if from_env:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "cache-from-env")
            assert platform.configure_compilation_cache() == "cache-from-env"
            # JAX reads the variable itself; nothing is set in code
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(platform.REPO_ROOT, ".jax_cache")
            assert platform.configure_compilation_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="'cpu'"):
        platform.require_gpu()


def _nh():
    # N[2] = 128 engages the z-compact layout the removed kernels fused
    grid = RectilinearGrid(size=(8, 8, 128), extent=(1.0, 1.0, 1.0),
                           dtype=jnp.float32)
    model = NonhydrostaticModel(grid=grid, advection=WENO(5))
    assert model._z_compact
    return model, model._step


def _sw():
    grid = RectilinearGrid(size=(16, 16), extent=(1.0, 1.0),
                           topology=("periodic", "periodic", "flat"),
                           dtype=jnp.float32)
    model = ShallowWaterModel(grid=grid, advection=WENO(5),
                              gravitational_acceleration=9.81)
    model.set(h=1.0)
    return model, model._step


def _hydro():
    grid = RectilinearGrid(size=(16, 16, 4), x=(0, 1e5), y=(0, 1e5),
                           z=(-100.0, 0.0), dtype=jnp.float32,
                           topology=("periodic", "periodic", "bounded"))
    model = HydrostaticFreeSurfaceModel(
        grid=grid, momentum_advection=WENOVectorInvariant(order=5),
        tracers=("T",))
    return model, model._step_for(60.0)


@pytest.mark.parametrize("build", [_nh, _sw, _hydro],
                         ids=["nonhydrostatic", "shallow_water",
                              "hydrostatic"])
def test_no_pallas_call_in_step(build):
    with jax.enable_x64(False):
        model, step = build()
        dt = jnp.asarray(1e-3, model.grid.dtype)
        jaxpr = str(jax.make_jaxpr(step)(model.state, dt))
    assert "pallas_call" not in jaxpr
    assert np.prod(model.grid.padded_shape) > 0
