"""Batched tridiagonal (Thomas) solver along z.

Reference semantics: src/Solvers/batched_tridiagonal_solver.jl:11-19,79-89 —
solve, for every column (i, j), the system

    b[1] φ[1] + c[1] φ[2]                 = d[1]
    a[k-1] φ[k-1] + b[k] φ[k] + c[k] φ[k+1] = d[k],  k = 2…N-1
    a[N-1] φ[N-1] + b[N] φ[N]             = d[N]

Coefficients may be 1D (z-only) or full 3D arrays.

Design: the Thomas recurrence is sequential in z but embarrassingly
parallel over the (Nx, Ny) plane, so we ``lax.scan`` over the z-axis with
(Nx, Ny)-shaped carries — each scan step is one fused kernel over the
whole horizontal plane. z is moved to the leading axis for unit-stride plane
slices."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _to_zfirst(arr, nz, plane_shape):
    """Broadcast a scalar / 1D(z) / 3D (x,y,z) coefficient to (nz, ...plane)."""
    a = jnp.asarray(arr)
    if a.ndim == 0:
        return jnp.broadcast_to(a, (nz,) + plane_shape)
    if a.ndim == 1:
        return jnp.broadcast_to(a[:, None, None], (nz,) + plane_shape)
    return jnp.moveaxis(a, -1, 0)


def solve_batched_tridiagonal(a, b, c, d):
    """Solve the batched tridiagonal system along the LAST axis of ``d``.

    ``a`` (sub-diagonal, length N; a[0] unused), ``b`` (diagonal, length N),
    ``c`` (super-diagonal, length N; c[N-1] unused) may be scalars, 1D arrays
    along z, or arrays of d's shape. Returns φ with d's shape."""
    nz = d.shape[-1]
    plane = d.shape[:-1]
    dz = jnp.moveaxis(d, -1, 0)
    az = _to_zfirst(a, nz, plane)
    bz = _to_zfirst(b, nz, plane)
    cz = _to_zfirst(c, nz, plane)

    # forward sweep: c'[k] = c/(b - a c'[k-1]);  d'[k] = (d - a d'[k-1])/(…)
    def fwd(carry, xs):
        cp_prev, dp_prev = carry
        ak, bk, ck, dk = xs
        denom = bk - ak * cp_prev
        cp = ck / denom
        dp = (dk - ak * dp_prev) / denom
        return (cp, dp), (cp, dp)

    # derive from dz so the carry matches its sharding/varying type under
    # shard_map (jax vma typing)
    zero = jnp.zeros_like(dz[0])
    (_, _), (cps, dps) = jax.lax.scan(fwd, (zero, zero), (az, bz, cz, dz))

    # back substitution: φ[N-1] = d'[N-1]; φ[k] = d'[k] - c'[k] φ[k+1]
    def bwd(phi_next, xs):
        cp, dp = xs
        phi = dp - cp * phi_next
        return phi, phi

    _, phis = jax.lax.scan(bwd, zero, (cps, dps), reverse=True)
    return jnp.moveaxis(phis, 0, -1)
