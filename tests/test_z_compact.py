"""z-compact (z-halo-free) fast-layout tests.

The z-compact layout drops the z halos; z boundary conditions are applied
inside the stencil reads (operators/shifts.py shift_zbc). These tests pin
the layout to the padded reference semantics."""

import jax.numpy as jnp
import numpy as np
import pytest

from oceananigans_tpu import RectilinearGrid
from oceananigans_tpu.advection import WENO
from oceananigans_tpu.buoyancy import BuoyancyTracer
from oceananigans_tpu.models import NonhydrostaticModel
from oceananigans_tpu.operators.shifts import shift, shift_zbc

pytestmark = pytest.mark.slow  # full-tier study/equivalence battery (see README testing tiers)

N = (16, 16, 128)


def _build(zc, u0, v0, b0):
    grid = RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0))
    m = NonhydrostaticModel(grid=grid, advection=WENO(5), tracers=("b",),
                            buoyancy=BuoyancyTracer(), z_compact=zc)
    m.set(u=u0, v=v0, b=b0)
    return m


def test_shift_zbc_matches_padded_fills(rng):
    n, H = 16, 3
    a = rng.standard_normal((4, 4, n))
    pad_even = np.zeros((4, 4, n + 2 * H))
    pad_even[:, :, H:H + n] = a
    for m in range(H):
        pad_even[:, :, H - 1 - m] = a[:, :, m]
        pad_even[:, :, H + n + m] = a[:, :, n - 1 - m]
    w = rng.standard_normal((4, 4, n))
    w[:, :, 0] = 0.0
    pad_odd = np.zeros((4, 4, n + 2 * H))
    pad_odd[:, :, H:H + n] = w
    for m in range(1, H + 1):
        pad_odd[:, :, H - m] = -w[:, :, m]
    for m in range(1, H):
        pad_odd[:, :, H + n + m] = -w[:, :, n - m]
    for s in (-3, -2, -1, 1, 2, 3):
        want = np.asarray(shift(jnp.asarray(pad_even), s, 2))[:, :, H:H + n]
        got = np.asarray(shift_zbc(jnp.asarray(a), s, 2, "even"))
        assert np.allclose(got, want, atol=1e-14), ("even", s)
        want = np.asarray(shift(jnp.asarray(pad_odd), s, 2))[:, :, H:H + n]
        got = np.asarray(shift_zbc(jnp.asarray(w), s, 2, "odd_face"))
        assert np.allclose(got, want, atol=1e-14), ("odd", s)


def test_z_compact_matches_padded(rng):
    u0 = 0.1 * rng.standard_normal(N)
    v0 = 0.1 * rng.standard_normal(N)
    b0 = 0.01 * rng.standard_normal(N)

    mp = _build(False, u0, v0, b0)
    mz = _build(True, u0, v0, b0)
    assert mz._z_compact and not mp._z_compact
    assert mz.grid.padded_shape[2] == 128          # no z halo slots

    # tendencies agree BITWISE (the zbc stencil fixes reproduce the mirror
    # halos exactly); full steps agree to jit-reassociation noise
    fp = mp._fill_all(mp.state["fields"], 0.0)
    fz = mz._fill_all(mz.state["fields"], 0.0)
    Gp, _ = mp._compute_tendencies(fp, 0.0)
    Gz, _ = mz._compute_tendencies(fz, 0.0)
    for n in ("u", "v", "b"):
        a = np.asarray(Gp[n])[mp.grid.interior_slices]
        b = np.asarray(Gz[n])[mz.grid.interior_slices]
        assert np.array_equal(a, b), n
    for _ in range(3):
        mp.time_step(1e-3)
        mz.time_step(1e-3)
    for n in ("u", "v", "b"):
        a = np.asarray(mp.field(n).interior)
        b = np.asarray(mz.field(n).interior)
        assert np.abs(a - b).max() < 5e-10, n
    aw = np.asarray(mp.field("w").interior)[:, :, :N[2]]
    bw = np.asarray(mz.field("w").interior)
    assert np.abs(aw - bw).max() < 5e-10
