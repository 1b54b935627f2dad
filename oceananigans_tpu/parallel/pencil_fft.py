"""Pencil-decomposed distributed Poisson solvers.

Reference semantics: src/DistributedComputations/
distributed_fft_based_poisson_solver.jl:53-91 and
distributed_fft_tridiagonal_solver.jl — the 3D transform of an x-sharded
field is computed by making one direction local at a time:

    transform(z, y local) → transpose y↔x (MPI.Alltoallv!) → FFT(x) →
    eigen-divide (or vertical tridiagonal solve) → inverse chain

Design: the transposes are ``lax.all_to_all`` over the mesh axis (one
collective instead of the reference's buffer-packing Alltoallv,
distributed_transpose.jl:4-188), run inside a single shard_map region so XLA
can overlap them with the local transforms. The vertical direction is NEVER
sharded in this decomposition, so the bounded-z DCT (matmul, local) and the
stretched-z tridiagonal solve (Thomas scan, local) need no extra
communication — the analogue of the reference's
DistributedFourierTridiagonalPoissonSolver. Divisibility constraints mirror
the reference's (Ny % Px == 0 — :80-91)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..grids.topology import BOUNDED, CENTER, FACE, PERIODIC
from ..solvers.fft_poisson import fft_along, ifft_along, poisson_eigenvalues
from ..solvers.transforms import dct_forward, dct_inverse
from ..solvers.tridiagonal import solve_batched_tridiagonal


class DistributedFFTPoissonSolver:
    """Solve ∇²φ = b for an interior field sharded along x over a 1D mesh.

    x and y must be Periodic (or Flat); z may be Periodic, Bounded-regular
    (local DCT), or Bounded-stretched (local tridiagonal solve — the
    distributed Fourier-tridiagonal variant). Nx % P == 0, Ny % P == 0."""

    def __init__(self, grid, mesh, axis_name="x"):
        for i in (0, 1):
            if not (grid.is_periodic(i) or grid.is_flat(i)):
                raise NotImplementedError(
                    "pencil solver requires periodic horizontal dims")
        self.grid = grid
        self.mesh = mesh
        self.axis_name = axis_name
        self.P = mesh.shape[axis_name]
        nx, ny, nz = grid.N
        if nx % self.P or ny % self.P:
            raise ValueError(
                f"the mesh size {self.P} must divide Nx={nx} and Ny={ny} "
                "(reference analogue: distributed_fft_based_poisson_solver.jl"
                ":80-91 divisibility constraints)")

        if grid.is_flat(2):
            self.z_kind = "flat"
        elif grid.is_periodic(2):
            self.z_kind = "periodic"
        elif grid.regular(2):
            self.z_kind = "dct"
        else:
            self.z_kind = "tridiagonal"

        lam = np.zeros((1, 1, 1))
        for axis in range(3):
            if grid.is_flat(axis) or (axis == 2 and
                                      self.z_kind == "tridiagonal"):
                continue
            N, L = grid.N[axis], grid.extent[axis]
            topo = PERIODIC if grid.is_periodic(axis) else BOUNDED
            sh = [1, 1, 1]
            sh[axis] = N
            lam = lam + poisson_eigenvalues(N, L, topo).reshape(sh)
        self.eigenvalues = lam

        if self.z_kind == "tridiagonal":
            h, n = grid.H[2], grid.N[2]
            dzc = np.broadcast_to(np.asarray(grid.dz((CENTER,) * 3))
                                  .reshape(-1), (grid.padded_shape[2],))
            self._dzc = dzc[h:h + n].copy()
            dzf = np.broadcast_to(
                np.asarray(grid.dz((CENTER, CENTER, FACE))).reshape(-1),
                (grid.padded_shape[2],))[h:h + n + 1].copy()
            lower = 1.0 / dzf[:n]
            upper = 1.0 / dzf[1:n + 1]
            lower[0] = 0.0
            upper[-1] = 0.0
            self._lower, self._upper = lower, upper

        from jax import shard_map
        spec = P(axis_name, None, None)
        axn = axis_name
        z_kind = self.z_kind
        solver = self

        def zsolve(bh, lam_t):
            """Eigen-divide (fft/dct z) or vertical tridiagonal solve, in the
            (x-local, y-sharded) layout."""
            if z_kind != "tridiagonal":
                denom = jnp.where(lam_t == 0, 1.0, lam_t)
                return jnp.where(lam_t == 0, 0.0, -bh / denom)
            n = bh.shape[2]
            dzc = jnp.asarray(solver._dzc, bh.real.dtype)
            lower = jnp.asarray(solver._lower, bh.real.dtype)
            upper = jnp.asarray(solver._upper, bh.real.dtype)
            lam_h = lam_t[..., :1]                      # (Nx, Ny/P, 1)
            diag = -(lower + upper)[None, None, :] - dzc[None, None, :] * lam_h
            rhs = bh * dzc[None, None, :]
            singular = (lam_h == 0)
            diag = diag.at[..., 0].set(jnp.where(singular[..., 0], 1.0,
                                                 diag[..., 0]))
            up = jnp.broadcast_to(upper, rhs.shape[:-1] + (n,))
            up = up.at[..., 0].set(jnp.where(singular[..., 0], 0.0, upper[0]))
            rhs = rhs.at[..., 0].set(jnp.where(singular[..., 0], 0.0,
                                               rhs[..., 0]))
            lo = jnp.broadcast_to(lower, rhs.shape[:-1] + (n,))
            if jnp.iscomplexobj(rhs):
                return (solve_batched_tridiagonal(lo, diag, up, rhs.real)
                        + 1j * solve_batched_tridiagonal(lo, diag, up,
                                                         rhs.imag))
            return solve_batched_tridiagonal(lo, diag, up, rhs)

        def solve_local(b, lam_x_sharded):
            # b: local (nx/P, Ny, Nz); z and y transforms are local
            if z_kind == "dct":
                b = dct_forward(b, 2)
            bh = fft_along(b, 1)
            if z_kind == "periodic":
                bh = fft_along(bh, 2)
            # transpose x↔y: gather x, shard y
            bh = lax.all_to_all(bh, axn, split_axis=1, concat_axis=0,
                                tiled=True)     # (Nx, Ny/P, Nz)
            bh = fft_along(bh, 0)
            lam_t = lax.all_to_all(
                jnp.broadcast_to(lam_x_sharded,
                                 (lam_x_sharded.shape[0],) + b.shape[1:]),
                axn, split_axis=1, concat_axis=0, tiled=True)
            ph = zsolve(bh, lam_t)
            ph = ifft_along(ph, 0)
            ph = lax.all_to_all(ph, axn, split_axis=0, concat_axis=1,
                                tiled=True)     # back to x-sharded
            ph = ifft_along(ph, 1)
            if z_kind == "periodic":
                ph = ifft_along(ph, 2)
            ph = jnp.real(ph)
            if z_kind == "dct":
                ph = dct_inverse(ph, 2)
            return ph

        self._solve = jax.jit(shard_map(
            solve_local, mesh=mesh, in_specs=(spec, spec), out_specs=spec))

    def solve(self, b):
        """b: interior array (Nx, Ny, Nz) sharded (or shardable) along x."""
        lam = jnp.asarray(np.broadcast_to(self.eigenvalues, b.shape), b.dtype)
        sharding = NamedSharding(self.mesh, P(self.axis_name, None, None))
        b = jax.device_put(b, sharding)
        lam = jax.device_put(lam, sharding)
        return self._solve(b, lam).astype(b.dtype)


# reference naming parity (distributed_fft_tridiagonal_solver.jl)
DistributedFourierTridiagonalPoissonSolver = DistributedFFTPoissonSolver
