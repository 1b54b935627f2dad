"""Conservative regridding between grids.

Reference semantics: src/Fields/regridding_fields.jl — `regrid!` moves a
field between grids that differ in one (or more, by composition) direction,
conserving the integral: destination cell values are overlap-weighted means
of source cells.

Design: the 1D conservative remap is a precomputed overlap matrix
W[i_dst, j_src] = |dst_i ∩ src_j| / Δdst_i applied as a matmul along the
regridded axis (one contraction — the same pattern as the transform
solvers), not a scatter loop."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..grids.topology import CENTER


def overlap_matrix(src_faces, dst_faces):
    """W with W @ src_cell_values = dst_cell_values (conservative means)."""
    src = np.asarray(src_faces, np.float64)
    dst = np.asarray(dst_faces, np.float64)
    ns, nd = len(src) - 1, len(dst) - 1
    lo = np.maximum(dst[:-1, None], src[None, :-1])
    hi = np.minimum(dst[1:, None], src[None, 1:])
    overlap = np.maximum(hi - lo, 0.0)                    # (nd, ns)
    ddst = (dst[1:] - dst[:-1])[:, None]
    W = overlap / ddst
    # destination cells sticking out of the source range keep a conservative
    # renormalization over the covered part (zero-extension would lose mass)
    cover = W.sum(axis=1, keepdims=True)
    W = np.where(cover > 1e-12, W / np.maximum(cover, 1e-12), 0.0)
    return W


_EQ = {0: "dn,nij->dij", 1: "dn,inj->idj", 2: "dn,ijn->ijd"}


def regrid(data, src_grid, dst_grid, axes=(2,)):
    """Conservatively regrid an INTERIOR-shaped array from src_grid to
    dst_grid along ``axes`` (the other extents must match). Works on any
    grids exposing ``nodes1d(axis, 'f')`` (reference: regrid! one-dimension-
    at-a-time composition, regridding_fields.jl)."""
    out = jnp.asarray(data)
    for axis in axes:
        if src_grid.is_flat(axis) or dst_grid.is_flat(axis):
            continue
        src_f = src_grid.nodes1d(axis, "f")
        dst_f = dst_grid.nodes1d(axis, "f")
        if len(src_f) == src_grid.N[axis]:   # periodic: close the circle
            src_f = np.append(src_f, src_f[0] + src_grid.extent[axis])
        if len(dst_f) == dst_grid.N[axis]:
            dst_f = np.append(dst_f, dst_f[0] + dst_grid.extent[axis])
        W = jnp.asarray(overlap_matrix(src_f, dst_f), out.dtype)
        out = jnp.einsum(_EQ[axis], W, out, precision="float32")
    return out


def regrid_field(field, dst_grid, axes=(2,)):
    """Regrid a Field's interior onto ``dst_grid`` (center locations)."""
    return regrid(field.interior, field.grid, dst_grid, axes)
