"""Index-shift primitive for stencil operators on halo-padded arrays.

``shift(a, s, axis)`` returns an array of the same shape with
``out[i] = a[i + s]``; slots that would read out of range are zero-filled.
Those slots are always in the outermost halo ring: provided the halo width is
at least the stencil radius and halos are refreshed by ``fill_halos`` between
stencil applications, garbage never reaches the interior. This mirrors the
reference's offset-array + halo design (reference: src/Grids/new_data.jl,
src/BoundaryConditions/fill_halo_regions.jl) but with static shapes so XLA
fuses every shifted read into the consuming elementwise kernel.

``jnp.roll`` is deliberately NOT used: wrap-around is wrong for Bounded
topologies.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def shift(a, s, axis):
    """out[i] = a[i + s] along ``axis``; zero-fill out-of-range (halo-only)."""
    if s == 0:
        return a
    n = a.shape[axis]
    pad = [(0, 0)] * a.ndim
    if s > 0:
        sl = lax.slice_in_dim(a, s, n, axis=axis)
        pad[axis] = (0, s)
    else:
        sl = lax.slice_in_dim(a, 0, n + s, axis=axis)
        pad[axis] = (-s, 0)
    return jnp.pad(sl, pad)


def shift_zbc(a, s, axis, kind, n=None):
    """``shift`` for a HALO-FREE bounded axis: out-of-range reads are fixed
    up with the boundary-condition values the halo would have carried
    (the nonhydrostatic model's z-compact layout):

    - ``"even"``   — mirror about the boundary faces (the default no-flux
      fill of center-located fields): a[-1-m] = a[m], a[N+m] = a[N-1-m].
    - ``"odd_face"`` — face-located field pinned to 0 on the boundary faces
      with odd reflection (w): a[-m] = -a[m], a[N] = 0, a[N+m] = -a[N-m].

    Fixes are iota-masked selects on the |s| affected slots only."""
    out = shift(a, s, axis)
    if s == 0 or kind is None:
        return out
    if n is None:
        n = a.shape[axis]
    lanes = lax.broadcasted_iota(jnp.int32, a.shape, axis)

    def plane(src):
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(src, src + 1)
        return a[tuple(idx)]

    if kind == "even":
        if s < 0:
            # out[k] = a[k+s]; k+s < 0 → a[-(k+s)-1]
            for k in range(-s):
                out = jnp.where(lanes == k, plane(-(k + s) - 1), out)
        else:
            # k+s > n-1 → a[2n-1-(k+s)]
            for k in range(n - s, n):
                out = jnp.where(lanes == k, plane(2 * n - 1 - (k + s)), out)
        return out
    if kind == "odd_face":
        if s < 0:
            # k+s < 0 → -a[-(k+s)]  (face 0 is the pinned boundary)
            for k in range(-s):
                src = -(k + s)
                out = jnp.where(lanes == k,
                                -plane(src) if src < n else 0.0 * plane(0),
                                out)
        else:
            # k+s = n → 0 (missing top face);  k+s = n+m → -a[n-m]
            for k in range(n - s, n):
                tgt = k + s
                if tgt == n:
                    out = jnp.where(lanes == k, 0.0 * plane(0), out)
                else:
                    out = jnp.where(lanes == k, -plane(2 * n - tgt), out)
        return out
    raise ValueError(f"unknown zbc kind {kind!r}")
