"""Field: a staggered quantity on a grid.

Reference semantics: src/Fields/field.jl (Field = grid + offset data + BCs),
set!.jl (set from number/array/function), and field reductions.

Design: `Field` is a registered pytree whose only leaf is the padded
jnp data array; grid/location/BCs are static aux data. Models do NOT operate on
Field objects in the hot path — they carry raw padded arrays in the state
pytree and reconstruct Fields only at the user-facing API boundary. This keeps
the jitted step a pure array→array program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..boundary_conditions import (fill_halo_regions,
                                   regularize_field_boundary_conditions)
from ..grids.base import broadcastable_1d
from ..grids.topology import (BOUNDED, CENTER, FACE, LOC_CCC, LOC_CCF, LOC_CFC,
                              LOC_FCC, validate_location)


@jax.tree_util.register_pytree_node_class
class Field:
    def __init__(self, grid, loc=LOC_CCC, bcs=None, data=None, _regularize=True):
        self.grid = grid
        self.loc = validate_location(loc)
        if _regularize:
            bcs = regularize_field_boundary_conditions(bcs, grid, self.loc)
        self.bcs = bcs
        if data is None:
            data = jnp.zeros(grid.padded_shape, dtype=grid.dtype)
        self.data = data

    # -- pytree protocol ------------------------------------------------------

    def tree_flatten(self):
        return (self.data,), (self.grid, self.loc, self.bcs)

    @classmethod
    def tree_unflatten(cls, aux, children):
        grid, loc, bcs = aux
        obj = cls.__new__(cls)
        obj.grid, obj.loc, obj.bcs = grid, loc, bcs
        obj.data = children[0]
        return obj

    # -- views ----------------------------------------------------------------

    def view(self, indices):
        """Windowed interior view (reference: Field ``indices`` kwarg —
        e.g. ``f.view((slice(None), slice(None), -1))`` for the surface
        slice). ``indices`` is a 3-tuple of slices/ints over the interior."""
        return self.interior[tuple(indices)]


    @property
    def interior_slices(self):
        """Per-axis interior slices of THIS field: N points per direction,
        N+1 for a Face location in a Bounded direction (the boundary face
        lives in the first halo slot — see grids/base.py)."""
        sls = []
        for axis in range(3):
            if self.data.shape[axis] == 1:
                # reduced (e.g. surface) field: size-1 axis has no halo
                sls.append(slice(0, 1))
                continue
            n, h = self.grid.N[axis], self.grid.H[axis]
            extra = 1 if (self.loc[axis] == FACE
                          and self.grid.topology[axis] == BOUNDED) else 0
            sls.append(slice(h, h + n + extra))
        return tuple(sls)

    @property
    def interior(self):
        return self.data[self.interior_slices]

    @property
    def shape(self):
        return self.interior.shape

    def nodes(self):
        return self.grid.nodes(self.loc)

    # -- mutation API (reference: set!, fill_halo_regions! — src/Fields/set!.jl
    # mutates in place; this is host-side API, not part of the jitted step, so
    # in-place assignment is safe. Returns self so the chained style
    # ``f = CenterField(g).set(...)`` keeps working too.)

    def set(self, value, time=0.0):
        data = set_on_padded(self.grid, self.loc, value)
        self.data = fill_halo_regions(data, self.grid, self.loc,
                                      self.bcs, time)
        return self

    def fill_halos(self, time=0.0):
        self.data = fill_halo_regions(self.data, self.grid, self.loc,
                                      self.bcs, time)
        return self

    # -- reductions over the interior ----------------------------------------

    def _reduction_mask(self, condition=None):
        """Interior boolean mask for reductions: immersed grids auto-exclude
        solid cells and ``condition`` restricts further (reference:
        test_conditional_reductions.jl — mean/norm/… of an immersed field
        reduce over fluid cells only). Returns None when unconditioned on a
        non-immersed grid."""
        from ..abstract_operations import align_reduction_mask, condition_interior
        m = condition_interior(condition, self.grid, self.loc)
        fm = getattr(self.grid, "fluid_mask_at", None)
        if fm is not None:
            # slice with THIS FIELD's interior extents on full axes
            # (face/bounded fields carry N+1 points — the grid's N-point
            # slices crashed every masked reduction on them, round-5
            # review finding), but keep the FULL grid interior on
            # reduced (size-1) axes so align_reduction_mask can collapse
            # per-column wetness with `any`
            fsl = list(self.interior_slices)
            for ax in range(3):
                if self.data.shape[ax] == 1:
                    fsl[ax] = self.grid.interior_slices[ax]
            f = jnp.asarray(fm(self.loc)).astype(bool)[tuple(fsl)]
            if m is not None:
                m = align_reduction_mask(m, f.shape) & f
            else:
                m = f
        if m is not None:
            # window-aware: a reduced field (e.g. η with interior (N,M,1))
            # must see a mask of its own shape, not a broadcast 3D one —
            # otherwise eta.sum() silently multiplies by fluid-cells-per-column
            m = align_reduction_mask(m, self.interior.shape)
        return m

    def min(self, condition=None):
        m = self._reduction_mask(condition)
        x = self.interior
        return jnp.min(jnp.where(m, x, jnp.inf)) if m is not None else jnp.min(x)

    def max(self, condition=None):
        m = self._reduction_mask(condition)
        x = self.interior
        return jnp.max(jnp.where(m, x, -jnp.inf)) if m is not None else jnp.max(x)

    def mean(self, condition=None):
        m = self._reduction_mask(condition)
        x = self.interior
        if m is None:
            return jnp.mean(x)
        return (jnp.sum(jnp.where(m, x, 0.0))
                / jnp.sum(m.astype(x.dtype)))

    def sum(self, condition=None):
        m = self._reduction_mask(condition)
        x = self.interior
        return jnp.sum(jnp.where(m, x, 0.0)) if m is not None else jnp.sum(x)

    def prod(self, condition=None):
        m = self._reduction_mask(condition)
        x = self.interior
        return jnp.prod(jnp.where(m, x, 1.0)) if m is not None else jnp.prod(x)

    def norm(self, condition=None):
        m = self._reduction_mask(condition)
        x = self.interior
        if m is not None:
            x = jnp.where(m, x, 0.0)
        return jnp.linalg.norm(x.ravel())

    def __repr__(self):
        return (f"Field{self.loc} on {type(self.grid).__name__}, "
                f"size {self.shape}")


def set_on_padded(grid, loc, value):
    """Build a padded data array from a scalar / interior array / padded array
    / callable f(x, y, z) (reference: src/Fields/set!.jl:34-90)."""
    shape = grid.padded_shape
    dtype = grid.dtype
    if callable(value):
        coords = [broadcastable_1d(grid.coord_padded(ax, loc[ax]), ax)
                  for ax in range(3)]
        data = jnp.broadcast_to(jnp.asarray(value(*coords), dtype), shape)
        return data.astype(dtype)
    if np.isscalar(value):
        return jnp.full(shape, value, dtype=dtype)
    value = jnp.asarray(value, dtype)
    if value.ndim == 2:
        # allow 2D input for grids with one flat dimension
        flat_axes = [ax for ax in range(3) if grid.is_flat(ax)]
        if len(flat_axes) == 1:
            value = jnp.expand_dims(value, flat_axes[0])
    if value.shape == shape:
        return value
    data = jnp.zeros(shape, dtype=dtype)
    ints = grid.interior_slices
    int_shape = tuple(s.stop - s.start for s in ints)
    if value.shape == int_shape:
        return data.at[ints].set(value)
    # interior-plus-boundary-face shape (Face/Bounded dims have N+1 entries)
    sls, exp = [], []
    for axis in range(3):
        n, h = grid.N[axis], grid.H[axis]
        extra = 1 if (loc[axis] == FACE and grid.topology[axis] == BOUNDED) else 0
        sls.append(slice(h, h + n + extra))
        exp.append(n + extra)
    if value.shape == tuple(exp):
        return data.at[tuple(sls)].set(value)
    raise ValueError(f"cannot set field of interior shape {int_shape} "
                     f"from array of shape {value.shape}")


# -- constructors (reference: src/Fields/field.jl CenterField/XFaceField/…) ----

def CenterField(grid, bcs=None):
    return Field(grid, LOC_CCC, bcs)


def XFaceField(grid, bcs=None):
    return Field(grid, LOC_FCC, bcs)


def YFaceField(grid, bcs=None):
    return Field(grid, LOC_CFC, bcs)


def ZFaceField(grid, bcs=None):
    return Field(grid, LOC_CCF, bcs)


def VelocityFields(grid, u_bcs=None, v_bcs=None, w_bcs=None):
    """u, v, w at (f,c,c), (c,f,c), (c,c,f) (reference:
    src/Fields/field_tuples.jl)."""
    return dict(u=XFaceField(grid, u_bcs), v=YFaceField(grid, v_bcs),
                w=ZFaceField(grid, w_bcs))


def TracerFields(grid, names, bcs=None):
    bcs = bcs or {}
    return {name: CenterField(grid, bcs.get(name)) for name in names}
