"""FFT-based Poisson solver on fully-regular grids.

Reference semantics: src/Solvers/fft_based_poisson_solver.jl (:5-11, :52-74,
:95-125) — solve ∇²φ = b by forward transform (FFT along Periodic dims, DCT
along Bounded dims), eigenvalue division φ̂ = -b̂/(λx+λy+λz), zero-mode fix
φ̂[0,0,0] = 0, inverse transform. Eigenvalues per
src/Solvers/poisson_eigenvalues.jl:

    Periodic: λ[k] = (2 sin(kπ/N)  · N/L)²,  k = 0…N-1
    Bounded:  λ[k] = (2 sin(kπ/2N) · N/L)²
    Flat:     λ = 0

The solver operates on INTERIOR arrays (no halos): the pressure-projection
step writes the solution back into a padded array and refreshes halos.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..grids.topology import BOUNDED, FLAT, PERIODIC
from ..platform import use_matmul_dft
from .transforms import dct_forward, dct_inverse


def poisson_eigenvalues(N, L, topology):
    k = np.arange(N)
    if topology == PERIODIC:
        return (2 * np.sin(k * np.pi / N) * N / L) ** 2
    if topology == BOUNDED:
        return (2 * np.sin(k * np.pi / (2 * N)) * N / L) ** 2
    return np.zeros(N)


class FFTPoissonSolver:
    """Eigenfunction solver for ∇²φ = b on an all-regular RectilinearGrid."""

    def __init__(self, grid):
        if not grid.all_regular:
            raise ValueError(
                "FFTPoissonSolver requires regular spacing in every direction "
                "(use FourierTridiagonalPoissonSolver for one stretched dim)")
        self.grid = grid
        lam = np.zeros((1, 1, 1))
        self._dct_axes = []
        self._fft_axes = []
        for axis in range(3):
            topo = grid.topology[axis]
            N = grid.N[axis]
            L = grid.extent[axis]
            if topo == FLAT:
                continue
            shape = [1, 1, 1]
            shape[axis] = N
            lam = lam + poisson_eigenvalues(N, L, topo).reshape(shape)
            (self._fft_axes if topo == PERIODIC
             else self._dct_axes).append(axis)
        self.eigenvalues = lam

    def solve(self, b):
        """Solve ∇²φ = b for interior array b (shape grid.N); returns interior
        φ with zero mean.

        Transform order: DCT axes first (real→real), then FFT axes — the axes
        commute, and this keeps every DCT on REAL data. The FIRST FFT axis
        uses a real FFT (half spectrum: ~2× less transform and eigen-divide
        work); the inverse takes the real part after the inverse FFTs."""
        if self._fft_axes + self._dct_axes and use_matmul_dft():
            return self._solve_matmul(b)
        bh = b
        for axis in self._dct_axes:
            bh = dct_forward(bh, axis)
        rfft_axis = self._fft_axes[0] if self._fft_axes else None
        lam = self.eigenvalues
        if rfft_axis is not None:
            n_r = bh.shape[rfft_axis]
            bh = rfft_along(bh, rfft_axis)
            sl = [slice(None)] * 3
            sl[rfft_axis] = slice(0, n_r // 2 + 1)
            lam = np.broadcast_to(lam, np.broadcast_shapes(
                lam.shape, tuple(1 if i != rfft_axis else n_r
                                 for i in range(3))))[tuple(sl)]
        for axis in self._fft_axes[1:]:
            bh = fft_along(bh, axis)
        lam = jnp.asarray(lam, b.dtype)
        denom = jnp.where(lam == 0, 1.0, lam)
        ph = -bh / denom
        # zero the (singular) volume-mean mode
        ph = jnp.where(lam == 0, 0.0, ph)
        for axis in reversed(self._fft_axes[1:]):
            ph = ifft_along(ph, axis)
        if rfft_axis is not None:
            ph = irfft_along(ph, rfft_axis, n_r)
        if jnp.iscomplexobj(ph):
            ph = jnp.real(ph)
        for axis in reversed(self._dct_axes):
            ph = dct_inverse(ph, axis)
        return ph.astype(b.dtype)

    def _solve_matmul(self, b):
        """All-matmul eigenfunction solve (the CPU path, see
        platform.use_matmul_dft): every 1D transform is a matmul (DCT-II for
        Bounded axes; split-real cos/sin DFT with a half spectrum on the
        first Periodic axis, full split-real DFT on the rest). The spectral
        state is an explicit (re, im) pair of REAL arrays — no complex dtype
        anywhere, so every contraction is a plain real matmul at
        transforms.MATMUL_PRECISION."""
        from .transforms import dct2_matrix, idct2_matrix
        re, im = b, None
        for axis in self._dct_axes:
            re = _matmul(dct2_matrix(b.shape[axis]), re, axis)
        lam = self.eigenvalues
        rfft_axis = self._fft_axes[0] if self._fft_axes else None
        if rfft_axis is not None:
            n_r = re.shape[rfft_axis]
            C, S = _rdft_cos_sin(n_r)
            re, im = _matmul(C, re, rfft_axis), _matmul(-S, re, rfft_axis)
            sl = [slice(None)] * 3
            sl[rfft_axis] = slice(0, n_r // 2 + 1)
            lam = np.broadcast_to(lam, np.broadcast_shapes(
                lam.shape, tuple(1 if i != rfft_axis else n_r
                                 for i in range(3))))[tuple(sl)]
        for axis in self._fft_axes[1:]:
            # 3-multiply complex DFT (Karatsuba): with W = C - iS,
            #   re' = C·re + S·im,  im' = C·im - S·re
            #   k1 = C·(re+im), k2 = (S-C)·im, k3 = (S+C)·re
            #   re' = k1 + k2,  im' = k1 - k3
            C, S = _dft_cos_sin(re.shape[axis])
            k1 = _matmul(C, re + im, axis)
            k2 = _matmul(S - C, im, axis)
            k3 = _matmul(S + C, re, axis)
            re, im = k1 + k2, k1 - k3

        lam = jnp.asarray(lam, b.dtype)
        denom = jnp.where(lam == 0, 1.0, lam)
        mask = lam != 0
        re = jnp.where(mask, -re / denom, 0.0)
        if im is not None:
            im = jnp.where(mask, -im / denom, 0.0)

        for axis in reversed(self._fft_axes[1:]):
            # inverse DFT: W⁻¹ = (C + iS)/n with C, S symmetric; same
            # 3-multiply structure with S ↦ -S, then the 1/n scale
            n = re.shape[axis]
            C, S = _dft_cos_sin(n)
            k1 = _matmul(C, re + im, axis)
            k2 = _matmul(-S - C, im, axis)
            k3 = _matmul(-S + C, re, axis)
            re, im = (k1 + k2) / n, (k1 - k3) / n
        if rfft_axis is not None:
            _, Wi = _rdft_matrices(n_r)
            re = (_matmul(np.real(Wi), re, rfft_axis)
                  - _matmul(np.imag(Wi), im, rfft_axis))
        for axis in reversed(self._dct_axes):
            re = _matmul(idct2_matrix(re.shape[axis]), re, axis)
        return re.astype(b.dtype)


import functools


@functools.lru_cache(maxsize=None)
def _dft_matrices(N):
    k = np.arange(N)
    W = np.exp(-2j * np.pi * np.outer(k, k) / N)
    return W, W.conj() / N


@functools.lru_cache(maxsize=None)
def _dft_cos_sin(N):
    ang = 2 * np.pi * np.outer(np.arange(N), np.arange(N)) / N
    return np.cos(ang), np.sin(ang)


def _matmul(M, a, axis):
    """M @ a contracting along ``axis`` — no physical transpose; at
    transforms.MATMUL_PRECISION."""
    from .transforms import MATMUL_PRECISION, _EINSUM_3D
    M = jnp.asarray(M, a.dtype)
    if a.ndim == 3:
        return jnp.einsum(_EINSUM_3D[axis], M, a, precision=MATMUL_PRECISION)
    a = jnp.moveaxis(a, axis, -1)
    out = jnp.einsum("kn,...n->...k", M, a, precision=MATMUL_PRECISION)
    return jnp.moveaxis(out, -1, axis)


def fft_along(a, axis):
    """FFT along ``axis`` — matmul-DFT (CPU) or native FFT on the innermost
    axis."""
    if use_matmul_dft():
        W, _ = _dft_matrices(a.shape[axis])
        return _matmul(W, a.astype(jnp.result_type(a.dtype, jnp.complex64)),
                       axis)
    if axis != a.ndim - 1:
        a = jnp.moveaxis(a, axis, -1)
        return jnp.moveaxis(jnp.fft.fft(a, axis=-1), -1, axis)
    return jnp.fft.fft(a, axis=-1)


def ifft_along(a, axis):
    if use_matmul_dft():
        _, Wi = _dft_matrices(a.shape[axis])
        return _matmul(Wi, a.astype(jnp.result_type(a.dtype, jnp.complex64)),
                       axis)
    if axis != a.ndim - 1:
        a = jnp.moveaxis(a, axis, -1)
        return jnp.moveaxis(jnp.fft.ifft(a, axis=-1), -1, axis)
    return jnp.fft.ifft(a, axis=-1)


@functools.lru_cache(maxsize=None)
def _rdft_matrices(N):
    k = np.arange(N // 2 + 1)
    n = np.arange(N)
    W = np.exp(-2j * np.pi * np.outer(k, n) / N)          # (N//2+1, N)
    # inverse: x = (1/N) Re( Σ_k w_k conj-symmetric expansion )
    Wi = np.exp(2j * np.pi * np.outer(n, k) / N)          # (N, N//2+1)
    scale = np.ones(N // 2 + 1)
    scale[1:] = 2.0
    if N % 2 == 0:
        scale[-1] = 1.0
    Wi = Wi * scale[None, :] / N
    return W, Wi


def rfft_along(a, axis):
    """Real FFT along ``axis`` (half spectrum). On the matmul path the REAL
    input is hit with separate cos/sin REAL matmuls (no complex promotion of
    the input)."""
    n = a.shape[axis]
    if use_matmul_dft():
        if not jnp.iscomplexobj(a):
            C, S = _rdft_cos_sin(n)
            return jax.lax.complex(_matmul(C, a, axis), -_matmul(S, a, axis))
        W, _ = _rdft_matrices(n)
        return _matmul(W, a, axis)
    if axis != a.ndim - 1:
        a = jnp.moveaxis(a, axis, -1)
        return jnp.moveaxis(jnp.fft.rfft(a, axis=-1), -1, axis)
    return jnp.fft.rfft(a, axis=-1)


def irfft_along(a, axis, n):
    if use_matmul_dft():
        _, Wi = _rdft_matrices(n)
        # x = Re(Wi @ X) = Re(Wi) @ Re(X) - Im(Wi) @ Im(X): 2 real matmuls
        return (_matmul(np.real(Wi), jnp.real(a), axis)
                - _matmul(np.imag(Wi), jnp.imag(a), axis))
    if axis != a.ndim - 1:
        a = jnp.moveaxis(a, axis, -1)
        return jnp.moveaxis(jnp.fft.irfft(a, n=n, axis=-1), -1, axis)
    return jnp.fft.irfft(a, n=n, axis=-1)


@functools.lru_cache(maxsize=None)
def _rdft_cos_sin(N):
    k = np.arange(N // 2 + 1)
    n = np.arange(N)
    ang = 2 * np.pi * np.outer(k, n) / N
    return np.cos(ang), np.sin(ang)
