"""Preconditioned conjugate-gradient solver.

Reference semantics: src/Solvers/conjugate_gradient_solver.jl:177 (generic
linear-operator CG with optional preconditioner) and
conjugate_gradient_poisson_solver.jl:10 (CG Poisson for immersed-boundary
grids with the FFT solver as preconditioner).

Design: the iteration is a ``lax.while_loop`` on the residual norm — fully
inside jit, no host round trips; dot products are single fused reductions."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def conjugate_gradient(A, b, x0=None, preconditioner=None, reltol=1e-7,
                       abstol=0.0, maxiter=500):
    """Solve A(x) = b. ``A`` and ``preconditioner`` are traceable callables
    array→array. Returns (x, iterations, residual_norm)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    M = preconditioner if preconditioner is not None else (lambda r: r)

    def dot(u, v):
        return jnp.sum(u * v)

    r0 = b - A(x0)
    z0 = M(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    bnorm = jnp.sqrt(dot(b, b))
    tol = jnp.maximum(reltol * bnorm, abstol)

    def cond(state):
        x, r, p, rz, it = state
        return jnp.logical_and(it < maxiter, jnp.sqrt(dot(r, r)) > tol)

    def body(state):
        x, r, p, rz, it = state
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, p, rz_new, it + 1)

    x, r, p, rz, it = lax.while_loop(cond, body, (x0, r0, p0, rz0,
                                                  jnp.zeros((), jnp.int32)))
    return x, it, jnp.sqrt(dot(r, r))


class ConjugateGradientPoissonSolver:
    """CG Poisson solve for grids where the FFT eigenfunction solver is
    inapplicable (immersed boundaries): the operator is the masked finite-
    volume Laplacian; the FFT solver preconditions (reference:
    conjugate_gradient_poisson_solver.jl)."""

    def __init__(self, grid, operator, preconditioner=None, reltol=1e-7,
                 maxiter=200):
        self.grid = grid
        self.operator = operator
        self.preconditioner = preconditioner
        self.reltol = reltol
        self.maxiter = maxiter

    def solve(self, b):
        b = b - jnp.mean(b)  # Neumann compatibility
        x, it, res = conjugate_gradient(
            self.operator, b, preconditioner=self.preconditioner,
            reltol=self.reltol, maxiter=self.maxiter)
        return x - jnp.mean(x)


def make_immersed_poisson_solver(grid, fill_p, fft_solver=None, reltol=1e-7,
                                 maxiter=200):
    """CG Poisson solver for an ImmersedBoundaryGrid: the operator is the
    finite-volume Laplacian with fluxes masked at immersed faces (no-flux
    through the topography), identity on solid cells; the regular-grid FFT
    solver preconditions (reference: conjugate_gradient_poisson_solver.jl:
    FFT-preconditioned CG for immersed grids).

    ``fill_p`` refreshes pressure halos (traceable)."""
    from ..operators.operators import (LOC_CCC, _delta_c, ddx, ddy, ddz)
    from ..grids.topology import CENTER, FACE

    lx = (FACE, CENTER, CENTER)
    ly = (CENTER, FACE, CENTER)
    lz = (CENTER, CENTER, FACE)
    mx = grid.fluid_mask(lx)
    my = grid.fluid_mask(ly)
    mz = grid.fluid_mask(lz)
    solid = jnp.asarray(grid.solid_ccc)
    ii = grid.interior_slices

    # The operator is kept in FLUX form (no 1/V): -Σ δ(A·m·∂p) is symmetric
    # in the plain dot product even when V varies in space (partial bottom
    # cells) — dividing by V would make it self-adjoint only in the
    # V-weighted inner product and break CG. The rhs is scaled by V to match.
    V3 = jnp.broadcast_to(jnp.asarray(grid.V(LOC_CCC)), grid.padded_shape)

    def masked_neg_laplacian(p_int):
        p = jnp.zeros(grid.padded_shape, p_int.dtype)
        p = p.at[ii].set(p_int)
        p = fill_p(p)
        terms = []
        if not grid.is_flat(0):
            terms.append(_delta_c(grid, grid.Ax(lx) * mx * ddx(grid, p, lx), 0))
        if not grid.is_flat(1):
            terms.append(_delta_c(grid, grid.Ay(ly) * my * ddy(grid, p, ly), 1))
        if not grid.is_flat(2):
            terms.append(_delta_c(grid, grid.Az(lz) * mz * ddz(grid, p, lz), 2))
        lap = sum(terms)
        out = jnp.where(solid, p, -lap)   # identity rows on solid cells
        return out[ii]

    precond = None
    if fft_solver is not None:
        # the FFT solver inverts ∇² (with the regular 1/V); undo the V scale
        Vr = fft_solver.grid.V(LOC_CCC)

        def precond(r):
            return -fft_solver.solve(r / Vr)

    class _Solver:
        def solve(self, b):
            bm = jnp.where(solid[ii], 0.0, -b * V3[ii])
            x, it, res = conjugate_gradient(
                masked_neg_laplacian, bm, preconditioner=precond,
                reltol=reltol, maxiter=maxiter)
            return x

    return _Solver()
