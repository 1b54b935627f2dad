"""Discrete transforms for the eigenfunction Poisson solvers.

Reference semantics: src/Solvers/plan_transforms.jl + discrete_transforms.jl —
FFT along Periodic dimensions, DCT (FFTW REDFT10/01, i.e. DCT-II/III) along
Bounded dimensions.

XLA has no native real-to-real transform. There are two DCT paths:

* **matmul-DCT** (the solvers' path): the N×N cosine matrix applied as one
  matmul along the axis. Exact for any N; O(N²) per line.
* **fft-DCT** (Makhoul's even-permutation algorithm): DCT-II via a single
  complex FFT of the even/odd reordered sequence — O(N log N).

Both are validated against each other in tests (the analogue of the
reference's GPU index-permutation DCT, src/Solvers/index_permutations.jl).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


# -- matmul DCT ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def dct2_matrix(N):
    """Unnormalized DCT-II matrix (FFTW REDFT10 convention):
    X[k] = 2 Σ_n x[n] cos(π k (2n+1) / (2N))."""
    k = np.arange(N)[:, None]
    n = np.arange(N)[None, :]
    return 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2 * N))


@functools.lru_cache(maxsize=None)
def idct2_matrix(N):
    """Exact inverse of :func:`dct2_matrix` (≡ scaled DCT-III)."""
    return np.linalg.inv(dct2_matrix(N))


# Contract along any axis of a 3D array WITHOUT a physical transpose.
_EINSUM_3D = {0: "kn,nij->kij", 1: "kn,inj->ikj", 2: "kn,ijn->ijk"}
# Full float32 matmuls: a lower precision lets the GPU run float32 products
# in TF32 (about three decimal digits), which every pressure solve's
# bounded-z DCT would inherit.
MATMUL_PRECISION = "highest"


def _apply_matrix_along(a, M, axis):
    """Apply matrix M (acting on vectors along ``axis``): out = M @ a."""
    M = jnp.asarray(M, a.dtype)
    if a.ndim == 3:
        return jnp.einsum(_EINSUM_3D[axis], M, a,
                          precision=MATMUL_PRECISION)
    a = jnp.moveaxis(a, axis, -1)
    out = jnp.einsum("kn,...n->...k", M, a, precision=MATMUL_PRECISION)
    return jnp.moveaxis(out, -1, axis)


def dct_forward(a, axis):
    N = a.shape[axis]
    M = dct2_matrix(N)
    if jnp.iscomplexobj(a):
        return (_apply_matrix_along(a.real, M, axis)
                + 1j * _apply_matrix_along(a.imag, M, axis))
    return _apply_matrix_along(a, M, axis)


def dct_inverse(a, axis):
    N = a.shape[axis]
    M = idct2_matrix(N)
    if jnp.iscomplexobj(a):
        return (_apply_matrix_along(a.real, M, axis)
                + 1j * _apply_matrix_along(a.imag, M, axis))
    return _apply_matrix_along(a, M, axis)


# -- fft-based DCT (Makhoul) ---------------------------------------------------

def dct_forward_fft(a, axis):
    """DCT-II via FFT of the even/odd permuted sequence (Makhoul 1980):
    v = [x0, x2, …, x5, x3, x1]; X[k] = 2 Re(e^{-iπk/2N} FFT(v)[k])."""
    N = a.shape[axis]
    a = jnp.moveaxis(a, axis, -1)
    v = jnp.concatenate([a[..., 0::2], jnp.flip(a[..., 1::2], axis=-1)], axis=-1)
    V = jnp.fft.fft(v, axis=-1)
    k = jnp.arange(N)
    phase = jnp.exp(-1j * jnp.pi * k / (2 * N))
    X = 2.0 * jnp.real(phase * V)
    return jnp.moveaxis(X.astype(a.dtype), -1, axis)


def dct_inverse_fft(a, axis):
    """Inverse of :func:`dct_forward_fft` (scaled DCT-III via inverse FFT)."""
    N = a.shape[axis]
    a = jnp.moveaxis(a, axis, -1)
    k = jnp.arange(N)
    phase = jnp.exp(1j * jnp.pi * k / (2 * N))
    # V[k] = 0.5 * phase * (X[k] - i X[N-k]), with X[N] ≡ 0
    Xr = a
    Xi = jnp.concatenate([jnp.zeros_like(a[..., :1]),
                          -jnp.flip(a[..., 1:], axis=-1)], axis=-1)
    V = 0.5 * phase * (Xr + 1j * Xi)
    v = jnp.fft.ifft(V, axis=-1)
    x = jnp.zeros_like(a)
    half = (N + 1) // 2
    x = x.at[..., 0::2].set(jnp.real(v[..., :half]))
    x = x.at[..., 1::2].set(jnp.real(jnp.flip(v[..., half:], axis=-1)))
    return jnp.moveaxis(x, -1, axis)
