"""Fourier-tridiagonal Poisson solver: FFT/DCT in the two regular
directions, tridiagonal solve along the one stretched direction — which may
be x, y, or z (reference: src/Solvers/fourier_tridiagonal_poisson_solver.jl:
23-25 dispatches on XYZRegular/XZRegular/YZRegular grids).

For each transformed mode, multiplying the ∇²φ = b rows by Δs_c(k) along the
stretched axis s gives

    (1/Δs_f[k])   φ[k-1]
  - (1/Δs_f[k] + 1/Δs_f[k+1] + Δs_c[k](λ₁+λ₂)) φ[k]
  + (1/Δs_f[k+1]) φ[k+1]  =  Δs_c[k] b̂[k]

with Neumann (staggered) walls: the boundary coupling terms are dropped. The
singular (λ=0) mode is regularized by pinning φ[0] = 0 for that mode (the
zero-mode fix, analogue of the reference's mean subtraction).

Design: the tridiagonal runs along the MINOR axis — for a stretched x or
y the batch is transposed so the scan axis is last (one cheap transpose pair
around the scan)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..grids.topology import BOUNDED, CENTER, FACE, FLAT, PERIODIC
from .fft_poisson import poisson_eigenvalues, fft_along, ifft_along
from .transforms import dct_forward, dct_inverse
from .tridiagonal import solve_batched_tridiagonal


class FourierTridiagonalPoissonSolver:
    def __init__(self, grid, stretched_axis=None):
        if stretched_axis is None:
            axes = getattr(grid, "stretched_axes", (2,))
            stretched_axis = axes[0] if len(axes) == 1 else 2
        self.grid = grid
        self.s = s = int(stretched_axis)
        if grid.topology[s] != BOUNDED:
            raise NotImplementedError("the stretched direction must be "
                                      "Bounded (staggered Neumann walls)")
        self._plan = []
        lam = np.zeros((1, 1, 1))
        for axis in range(3):
            if axis == s:
                continue
            topo = grid.topology[axis]
            if topo == FLAT:
                continue
            if not grid.regular(axis):
                raise ValueError("the two transformed directions must be "
                                 "regular")
            N, L = grid.N[axis], grid.extent[axis]
            shape = [1, 1, 1]
            shape[axis] = N
            lam = lam + poisson_eigenvalues(N, L, topo).reshape(shape)
            self._plan.append((axis, "fft" if topo == PERIODIC else "dct"))
        self.eigenvalues = lam

        # stretched-axis coefficients (interior, numpy)
        h, n = grid.H[s], grid.N[s]
        metric = (grid.dx, grid.dy, grid.dz)[s]
        loc_c = [CENTER, CENTER, CENTER]
        loc_f = list(loc_c)
        loc_f[s] = FACE
        npad = grid.padded_shape[s]

        def prof(loc):
            m = np.asarray(metric(tuple(loc)))
            if m.ndim == 3:
                # take the 1D profile along s (x-invariant by regularity of
                # the other axes)
                sl = [0, 0, 0]
                sl[s] = slice(None)
                m = m[tuple(sl)]
            return np.broadcast_to(m.reshape(-1), (npad,))

        dsc = prof(loc_c)[h:h + n].copy()
        dsf = prof(loc_f)[h:h + n + 1].copy()
        self._dsc = dsc
        # lower[k] couples φ[k-1]: 1/Δs_f[k]; upper[k] couples φ[k+1]
        lower = 1.0 / dsf[:n]
        upper = 1.0 / dsf[1:n + 1]
        lower[0] = 0.0     # Neumann: no coupling below the first cell
        upper[-1] = 0.0
        self._lower = lower
        self._upper = upper

    def solve(self, b):
        """Solve ∇²φ = b for interior b (shape grid.N); returns interior φ.
        DCT axes transform first so they always see real data (see
        FFTPoissonSolver.solve)."""
        s = self.s
        bh = b
        for axis, kind in sorted(self._plan, key=lambda p: p[1] != "dct"):
            bh = (fft_along(bh, axis) if kind == "fft"
                  else dct_forward(bh, axis))
        n = self.grid.N[s]
        rdt = bh.real.dtype
        lam = jnp.moveaxis(jnp.asarray(self.eigenvalues, rdt), s, 2)
        dsc = jnp.asarray(self._dsc, rdt)
        lower = jnp.asarray(self._lower, rdt)
        upper = jnp.asarray(self._upper, rdt)
        bh = jnp.moveaxis(bh, s, 2)      # scan along the minor axis

        diag = -(lower + upper)[None, None, :] - dsc[None, None, :] * lam
        rhs = bh * dsc[None, None, :]

        # regularize the singular λ=0 mode: pin φ[0] = 0 there
        singular = (lam == 0)            # broadcastable mask, size-1 last dim
        sing0 = jnp.broadcast_to(singular[..., 0], rhs.shape[:-1])
        diag0 = jnp.where(sing0, 1.0, diag[..., 0])
        diag = jnp.broadcast_to(diag, rhs.shape).at[..., 0].set(diag0)
        up0 = jnp.broadcast_to(upper, rhs.shape[:-1] + (n,))
        up0 = up0.at[..., 0].set(jnp.where(sing0, 0.0, upper[0]))
        rhs = rhs.at[..., 0].set(jnp.where(sing0, 0.0, rhs[..., 0]))

        lo = jnp.broadcast_to(lower, rhs.shape[:-1] + (n,))
        if jnp.iscomplexobj(rhs):
            pr = solve_batched_tridiagonal(lo, diag, up0, rhs.real)
            pi = solve_batched_tridiagonal(lo, diag, up0, rhs.imag)
            ph = pr + 1j * pi
        else:
            ph = solve_batched_tridiagonal(lo, diag, up0, rhs)
        ph = jnp.moveaxis(ph, 2, s)

        for axis, kind in self._plan:
            if kind == "fft":
                ph = ifft_along(ph, axis)
        if jnp.iscomplexobj(ph):
            ph = jnp.real(ph)
        for axis, kind in self._plan:
            if kind == "dct":
                ph = dct_inverse(ph, axis)
        # remove the volume mean (the solution is defined up to a constant)
        w = jnp.asarray(self._dsc, ph.dtype)
        w = w / jnp.sum(w)
        other = tuple(ax for ax in range(3) if ax != s)
        mean = jnp.sum(jnp.mean(ph, axis=other) * w.reshape(-1))
        return (ph - mean).astype(b.dtype)


def make_variable_spacing_poisson_solver(grid, fill_p=None, reltol=1e-8,
                                         maxiter=500):
    """CG fallback for multiply-stretched non-immersed grids (the reference
    routes these to its ConjugateGradientPoissonSolver): flux-form
    finite-volume Laplacian (symmetric in the plain dot product), optional
    FFT preconditioner built on a regular grid of the same size/extent."""
    from ..grids.rectilinear import RectilinearGrid
    from ..grids.topology import LOC_CCC
    from ..operators.operators import _delta_c, ddx, ddy, ddz
    from .conjugate_gradient import conjugate_gradient
    from .fft_poisson import FFTPoissonSolver

    lx = (FACE, CENTER, CENTER)
    ly = (CENTER, FACE, CENTER)
    lz = (CENTER, CENTER, FACE)
    ii = grid.interior_slices
    V3 = jnp.broadcast_to(jnp.asarray(grid.V(LOC_CCC)), grid.padded_shape)
    if fill_p is None:
        from ..boundary_conditions import (fill_halo_regions,
                                           regularize_field_boundary_conditions)
        bcs = regularize_field_boundary_conditions(None, grid, LOC_CCC)
        fill_p = lambda p: fill_halo_regions(p, grid, LOC_CCC, bcs)

    # x-face boundary couplings vanish through the Neumann fill; bounded
    # peripheral faces carry no flux because the mirrored halo value makes
    # the gradient zero there.
    def neg_laplacian(p_int):
        p = jnp.zeros(grid.padded_shape, p_int.dtype)
        p = p.at[ii].set(p_int)
        p = fill_p(p)
        terms = []
        if not grid.is_flat(0):
            terms.append(_delta_c(grid, grid.Ax(lx) * ddx(grid, p, lx), 0))
        if not grid.is_flat(1):
            terms.append(_delta_c(grid, grid.Ay(ly) * ddy(grid, p, ly), 1))
        if not grid.is_flat(2):
            terms.append(_delta_c(grid, grid.Az(lz) * ddz(grid, p, lz), 2))
        return -sum(terms)[ii]

    precond = None
    try:
        reg = RectilinearGrid(size=grid.N, extent=grid.extent,
                              topology=grid.topology, halo=grid.H,
                              dtype=grid.dtype)
        fft = FFTPoissonSolver(reg)
        Vr = reg.V(LOC_CCC)

        def precond(r):
            return -fft.solve(r / Vr)
    except Exception:
        precond = None

    class _Solver:
        def solve(self, b):
            bm = -b * V3[ii]
            bm = bm - jnp.mean(bm)
            x, it, res = conjugate_gradient(neg_laplacian, bm,
                                            preconditioner=precond,
                                            reltol=reltol, maxiter=maxiter)
            return x - jnp.mean(x)

    return _Solver()
