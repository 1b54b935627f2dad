"""AbstractOperations: lazy expression trees over Fields for diagnostics.

Reference semantics: src/AbstractOperations/ — Unary/Binary/Multiary
operations with automatic location matching (AbstractOperations.jl:41-95,
binary_operations.jl), `Derivative` (derivatives.jl), `@at` relocation
(at.jl), `KernelFunctionOperation` (kernel_function_operation.jl),
`ConditionalOperation` (conditional_operations.jl), metric reductions
`Average`/`Integral`/`CumulativeIntegral` (metric_field_reductions.jl:65-206)
and `Field(op)`+`compute!` materialization (computed_field.jl).

Design: an operation is just a deferred, traceable function of padded
arrays — `compute()` evaluates the whole tree as one fused XLA program. The
layer exists purely for API parity; inside jitted model code you write plain
jnp expressions."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .fields import Field
from .grids.topology import CENTER, FACE, LOC_CCC
from .operators.operators import ddx, ddy, ddz, interp_to


class AbstractOperation:
    """Lazy node: has .grid, .loc; .materialize() returns a padded array."""

    grid = None
    loc = LOC_CCC

    def materialize(self):
        raise NotImplementedError

    # -- algebra --------------------------------------------------------------

    def __add__(self, other):
        return BinaryOperation(jnp.add, self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return BinaryOperation(jnp.subtract, self, other)

    def __rsub__(self, other):
        return BinaryOperation(jnp.subtract, other, self)

    def __mul__(self, other):
        return BinaryOperation(jnp.multiply, self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return BinaryOperation(jnp.divide, self, other)

    def __rtruediv__(self, other):
        return BinaryOperation(jnp.divide, other, self)

    def __pow__(self, other):
        return BinaryOperation(jnp.power, self, other)

    def __neg__(self):
        return UnaryOperation(jnp.negative, self)

    # -- evaluation -----------------------------------------------------------

    def compute(self):
        """Materialize into a Field (reference: Field(op) + compute!)."""
        data = self.materialize()
        return Field(self.grid, self.loc, None, data)

    @property
    def interior(self):
        return self.compute().interior


def _materialize(x, grid, loc):
    if isinstance(x, AbstractOperation):
        a = x.materialize()
        src_loc = x.loc
    elif isinstance(x, Field):
        a = x.data
        src_loc = x.loc
    else:
        return x
    if src_loc != loc:
        a = interp_to(grid, a, src_loc, loc)
    return a


def _grid_loc_of(*xs):
    for x in xs:
        if isinstance(x, (AbstractOperation, Field)):
            return x.grid, x.loc
    raise ValueError("no field operand")


class UnaryOperation(AbstractOperation):
    def __init__(self, op, a, loc=None):
        self.op = op
        self.a = a
        self.grid, aloc = _grid_loc_of(a)
        self.loc = loc or aloc

    def materialize(self):
        return self.op(_materialize(self.a, self.grid, self.loc))


class BinaryOperation(AbstractOperation):
    """Locations are matched by interpolating the second operand to the
    first's location (reference: binary operation location inference)."""

    def __init__(self, op, a, b, loc=None):
        self.op = op
        self.a, self.b = a, b
        self.grid, aloc = _grid_loc_of(a, b)
        self.loc = loc or aloc

    def materialize(self):
        return self.op(_materialize(self.a, self.grid, self.loc),
                       _materialize(self.b, self.grid, self.loc))


class MultiaryOperation(AbstractOperation):
    def __init__(self, op, *args, loc=None):
        self.op = op
        self.args = args
        self.grid, aloc = _grid_loc_of(*args)
        self.loc = loc or aloc

    def materialize(self):
        return self.op(*[_materialize(a, self.grid, self.loc)
                         for a in self.args])


class Derivative(AbstractOperation):
    def __init__(self, a, axis):
        self.a = a
        self.axis = axis
        self.grid, aloc = _grid_loc_of(a)
        loc = list(aloc)
        loc[axis] = FACE if aloc[axis] == CENTER else CENTER
        self.loc = tuple(loc)

    def materialize(self):
        src = (self.a.materialize() if isinstance(self.a, AbstractOperation)
               else self.a.data)
        dd = (ddx, ddy, ddz)[self.axis]
        return dd(self.grid, src, self.loc)


def partial_x(a):
    return Derivative(a, 0)


def partial_y(a):
    return Derivative(a, 1)


def partial_z(a):
    return Derivative(a, 2)


def at(loc, a):
    """Relocate an expression (reference: @at macro, at.jl)."""
    return UnaryOperation(lambda x: x, a, loc=tuple(loc))


class KernelFunctionOperation(AbstractOperation):
    """Wrap any traceable func(grid, *args) -> padded array (reference:
    kernel_function_operation.jl — func(i, j, k, grid, args...) becomes a
    whole-array function)."""

    def __init__(self, func, grid, *args, loc=LOC_CCC):
        self.func = func
        self.grid = grid
        self.args = args
        self.loc = tuple(loc)

    def materialize(self):
        args = [a.data if isinstance(a, Field)
                else (a.materialize() if isinstance(a, AbstractOperation)
                      else a)
                for a in self.args]
        return self.func(self.grid, *args)


class ConditionalOperation(AbstractOperation):
    """Mask an operand where a condition fails (reference:
    conditional_operations.jl; used by conditional reductions)."""

    def __init__(self, a, condition, mask_value=0.0):
        self.a = a
        self.condition = condition
        self.mask_value = mask_value
        self.grid, self.loc = _grid_loc_of(a)

    def materialize(self):
        data = _materialize(self.a, self.grid, self.loc)
        if isinstance(self.condition, AbstractOperation):
            cond = self.condition.materialize()
        elif isinstance(self.condition, Field):
            cond = self.condition.data
        elif callable(self.condition):
            from .fields.field import set_on_padded
            cond = set_on_padded(self.grid, self.loc,
                                 self.condition).astype(bool)
        else:
            cond = self.condition
        return jnp.where(cond, data, self.mask_value)


# -- metric reductions ---------------------------------------------------------

def _op_interior_slices(grid, loc, data_shape):
    """Face-aware interior slices: N points per axis, N+1 where the operand
    is Face-located in a Bounded direction (matching Field.interior; the
    grid's plain N-point slices silently dropped the boundary-face strip
    from Integral/Average of face fields — round-5 review finding)."""
    from .grids.topology import BOUNDED as _B, FACE as _F
    sls = []
    for ax in range(3):
        if data_shape[ax] == 1:
            sls.append(slice(0, 1))
            continue
        n, h = grid.N[ax], grid.H[ax]
        extra = 1 if (loc[ax] == _F and grid.topology[ax] == _B) else 0
        sls.append(slice(h, h + n + extra))
    return tuple(sls)


def _interior_and_weights(op_or_field, dims):
    """Interior data + metric weights for a dim-wise metric reduction. The
    weight is the product of the grid spacings over ``dims`` only (reference:
    metric_field_reductions.jl — ``Integral(c, dims=2)`` is ∫c dz with the
    z metric, ``dims=(0,1)`` integrates with the horizontal area, etc.; the
    full cell volume is the ``dims=(0,1,2)`` special case). Face-located
    operands in Bounded reduction directions include BOTH boundary faces
    with trapezoid (half) end weights, so the weights sum to the domain
    extent and linear fields integrate exactly."""
    if isinstance(op_or_field, Field):
        grid, loc, data = op_or_field.grid, op_or_field.loc, op_or_field.data
    else:
        grid, loc = op_or_field.grid, op_or_field.loc
        data = op_or_field.materialize()
    metric = {0: grid.dx, 1: grid.dy, 2: grid.dz}
    w = 1.0
    for ax in dims:
        w = w * jnp.asarray(metric[ax](loc), data.dtype)
    w = jnp.broadcast_to(jnp.asarray(w, data.dtype), data.shape)
    ii = _op_interior_slices(grid, loc, data.shape)
    data_i, w_i = data[ii], w[ii]
    from .grids.topology import BOUNDED as _B, FACE as _F
    for ax in dims:
        if (data.shape[ax] != 1 and loc[ax] == _F
                and grid.topology[ax] == _B):
            npts = data_i.shape[ax]
            fac = np.ones(npts)
            fac[0] = fac[-1] = 0.5
            shape = [1, 1, 1]
            shape[ax] = npts
            w_i = w_i * jnp.asarray(fac.reshape(shape), w_i.dtype)
    return data_i, w_i, grid, loc


def condition_interior(condition, grid, loc):
    """Interior boolean mask from a ``condition``: a Field, an
    AbstractOperation, an array (interior- or padded-shaped), or a callable
    ``f(x, y, z)`` evaluated at the operand's nodes (reference:
    src/AbstractOperations/conditional_operations.jl condition_operand;
    the reference's index-based ``(i, j, k, ...)`` conditions map here to
    coordinate-based callables, the idiom the rest of this API uses)."""
    if condition is None:
        return None
    ii = grid.interior_slices
    if isinstance(condition, AbstractOperation):
        return condition.materialize()[ii].astype(bool)
    if isinstance(condition, Field):
        return condition.data[ii].astype(bool)
    if callable(condition):
        from .fields.field import set_on_padded
        return set_on_padded(grid, loc, condition)[ii].astype(bool)
    c = jnp.asarray(condition)
    if c.shape == grid.padded_shape:
        return c[ii].astype(bool)
    int_shape = tuple(s.stop - s.start for s in ii)
    return jnp.broadcast_to(c, int_shape).astype(bool)


def align_reduction_mask(m, shape):
    """Align a full-interior mask to a (possibly already-reduced) operand
    shape: axes the operand holds at size 1 collapse with ``any`` — a column
    participates in the reduction if any of its cells do. Prevents the mask
    from silently broadcasting a reduced field (e.g. η, interior (N,M,1))
    back to 3D inside ``jnp.where(mask, x, 0)``."""
    axes = tuple(ax for ax in range(min(len(shape), m.ndim))
                 if shape[ax] == 1 and m.shape[ax] != 1)
    if axes:
        m = jnp.any(m, axis=axes, keepdims=True)
    # face-located operands in Bounded directions carry one point MORE
    # than the grid-interior mask: extend by the edge value (the boundary
    # face participates iff its adjacent cell does) — round-5 review
    pads = [(0, (shape[ax] - m.shape[ax])
             if (ax < len(shape) and 0 < shape[ax] - m.shape[ax] <= 1)
             else 0) for ax in range(m.ndim)]
    if any(p[1] for p in pads):
        m = jnp.pad(m, pads, mode="edge")
    return m


def reduction_mask(op_or_field, grid, loc, condition=None):
    """Combined interior boolean mask for reductions: the user ``condition``
    ∧ the immersed fluid mask (reference: immersed fields reduce over fluid
    cells only — conditional_length(fimm) counts fluid cells,
    test_conditional_reductions.jl) ∧ an operand ConditionalOperation's own
    condition (reference: mean(condition_operand) normalizes by conditional
    length). Returns None when unconditioned on a non-immersed grid."""
    m = condition_interior(condition, grid, loc)
    fm = getattr(grid, "fluid_mask_at", None)
    if fm is not None:
        # face-aware slice on full axes, full grid interior on reduced
        # ones (align_reduction_mask collapses those)
        _shape = (op_or_field.data.shape if isinstance(op_or_field, Field)
                  else grid.padded_shape)
        _fsl = list(_op_interior_slices(grid, loc, _shape))
        for _ax in range(3):
            if _shape[_ax] == 1:
                _fsl[_ax] = grid.interior_slices[_ax]
        f = jnp.asarray(fm(loc)).astype(bool)[tuple(_fsl)]
        m = f if m is None else (m & f)
    if condition is None and isinstance(op_or_field, ConditionalOperation):
        c = condition_interior(op_or_field.condition, grid, loc)
        if c is not None:
            m = c if m is None else (m & c)
    return m


def conditional_length(field, dims=None, condition=None):
    """Number of cells participating in a conditional reduction (reference:
    src/AbstractOperations/conditional_operations.jl conditional_length —
    e.g. for a half-immersed grid it is half the interior cell count)."""
    grid, loc = _grid_loc_of(field)
    m = reduction_mask(field, grid, loc, condition)
    ii = grid.interior_slices
    if m is None:
        shape = tuple(s.stop - s.start for s in ii)
        return (int(np.prod(shape)) if dims is None
                else jnp.ones(shape, jnp.int32).sum(
                    axis=tuple(dims) if np.iterable(dims) else (dims,),
                    keepdims=True))
    if dims is None:
        return jnp.sum(m)
    dims = tuple(dims) if np.iterable(dims) else (dims,)
    return jnp.sum(m, axis=dims, keepdims=True)


class Average(AbstractOperation):
    """Volume-weighted mean over ``dims`` (reference:
    metric_field_reductions.jl:65). With ``condition`` (or over an immersed
    grid, or over a ConditionalOperation operand) the mean is taken over
    condition-true fluid cells only — the normalization uses the conditional
    volume, matching the reference's conditional_length semantics."""

    def __init__(self, a, dims=(0, 1, 2), condition=None, mask=0.0):
        self.a = a
        self.dims = tuple(dims) if np.iterable(dims) else (dims,)
        self.condition = condition
        self.mask_value = mask
        self.grid, self.loc = _grid_loc_of(a)

    def materialize(self):
        data, w, grid, loc = _interior_and_weights(self.a, self.dims)
        m = reduction_mask(self.a, grid, loc, self.condition)
        if m is not None:
            m = align_reduction_mask(m, data.shape)
        if m is not None:
            data = jnp.where(m, data, self.mask_value)
            w = jnp.where(m, w, 0.0)
        num = jnp.sum(data * w, axis=self.dims, keepdims=True)
        den = jnp.sum(w, axis=self.dims, keepdims=True)
        return num / den

    def compute(self):
        return self.materialize()

    @property
    def interior(self):
        return self.materialize()


class Integral(Average):
    """Volume-weighted integral (reference: metric_field_reductions.jl:144);
    condition-masked cells contribute ``mask`` (default 0, i.e. excluded)."""

    def materialize(self):
        data, w, grid, loc = _interior_and_weights(self.a, self.dims)
        contrib = data * w
        m = reduction_mask(self.a, grid, loc, self.condition)
        if m is not None:
            m = align_reduction_mask(m, data.shape)
        if m is not None:
            contrib = jnp.where(m, contrib, self.mask_value)
        return jnp.sum(contrib, axis=self.dims, keepdims=True)


_REDUCERS = dict(sum=jnp.sum, mean=jnp.mean, maximum=jnp.max,
                 minimum=jnp.min, prod=jnp.prod)
_ACCUMULATORS = dict(cumsum=jnp.cumsum, cumprod=jnp.cumprod,
                     cummax=jax.lax.cummax, cummin=jax.lax.cummin)


# neutral fill for condition-masked slots, per reducing/accumulating op
# (reference: src/AbstractOperations/conditional_operations.jl picks the
# op's neutral element so masked cells cannot influence the result)
_NEUTRALS = dict(sum=0.0, mean=0.0, prod=1.0, maximum=-jnp.inf,
                 minimum=jnp.inf, cumsum=0.0, cumprod=1.0,
                 cummax=-jnp.inf, cummin=jnp.inf)


class Reduction(AbstractOperation):
    """Generic (unweighted) reduction over ``dims`` (reference:
    src/Fields/scans.jl Reduction(op!, operand; dims) — e.g.
    ``Reduction("maximum", op, dims=2)``; Average/Integral are the
    metric-weighted counterparts). ``op`` is a name from sum/mean/maximum/
    minimum/prod or a jnp-style callable taking (array, axis=...).
    ``condition`` restricts the reduction to condition-true cells (immersed
    grids auto-exclude solid cells); ``mean`` normalizes by the conditional
    count (reference: test_conditional_reductions.jl)."""

    def __init__(self, op, a, dims=(0, 1, 2), condition=None, mask=None):
        self.op_name = op if isinstance(op, str) else None
        self.op = _REDUCERS[op] if isinstance(op, str) else op
        self.a = a
        self.dims = tuple(dims) if np.iterable(dims) else (dims,)
        self.condition = condition
        self.mask_value = mask
        self.grid, self.loc = _grid_loc_of(a)

    def materialize(self):
        data, _, grid, loc = _interior_and_weights(self.a, self.dims)
        m = reduction_mask(self.a, grid, loc, self.condition)
        if m is not None:
            m = align_reduction_mask(m, data.shape)
        if m is not None:
            if self.op_name == "mean" and self.mask_value is None:
                mf = m.astype(data.dtype)
                num = jnp.sum(jnp.where(m, data, 0.0), axis=self.dims,
                              keepdims=True)
                den = jnp.sum(mf, axis=self.dims, keepdims=True)
                return num / den
            fill = (self.mask_value if self.mask_value is not None
                    else _NEUTRALS.get(self.op_name, 0.0))
            data = jnp.where(m, data, fill)
        return self.op(data, axis=self.dims, keepdims=True)

    def compute(self):
        return self.materialize()

    @property
    def interior(self):
        return self.materialize()


class Accumulation(AbstractOperation):
    """Generic accumulating scan along one dimension (reference:
    src/Fields/scans.jl Accumulation(op!, operand; dims) — e.g.
    ``Accumulation("cumsum", op, dims=2)``; CumulativeIntegral is the
    metric-weighted counterpart). ``reverse=True`` scans from the high end
    (reference: reverse_cumsum!)."""

    def __init__(self, op, a, dims=2, condition=None, mask=None,
                 reverse=False):
        self.op_name = op if isinstance(op, str) else None
        self.op = _ACCUMULATORS[op] if isinstance(op, str) else op
        self.a = a
        self.dim = int(dims)
        self.condition = condition
        self.mask_value = mask
        self.reverse = bool(reverse)
        self.grid, self.loc = _grid_loc_of(a)

    def materialize(self):
        data, _, grid, loc = _interior_and_weights(self.a, (self.dim,))
        m = reduction_mask(self.a, grid, loc, self.condition)
        if m is not None:
            m = align_reduction_mask(m, data.shape)
        if m is not None:
            fill = (self.mask_value if self.mask_value is not None
                    else _NEUTRALS.get(self.op_name, 0.0))
            data = jnp.where(m, data, fill)
        if self.reverse:
            data = jnp.flip(data, axis=self.dim)
        out = self.op(data, axis=self.dim)
        return jnp.flip(out, axis=self.dim) if self.reverse else out

    def compute(self):
        return self.materialize()

    @property
    def interior(self):
        return self.materialize()


class CumulativeIntegral(AbstractOperation):
    """∫ along one dimension, cumulative (reference:
    metric_field_reductions.jl:206); supports ``reverse`` and ``condition``
    like the reference's kwargs (masked cells contribute ``mask``·dz,
    default 0)."""

    def __init__(self, a, dims=2, condition=None, mask=0.0, reverse=False):
        self.a = a
        self.dim = int(dims)
        self.condition = condition
        self.mask_value = mask
        self.reverse = bool(reverse)
        self.grid, self.loc = _grid_loc_of(a)

    def materialize(self):
        data, w, grid, loc = _interior_and_weights(self.a, (self.dim,))
        m = reduction_mask(self.a, grid, loc, self.condition)
        if m is not None:
            m = align_reduction_mask(m, data.shape)
        if m is not None:
            data = jnp.where(m, data, self.mask_value)
        contrib = data * w
        if self.reverse:
            contrib = jnp.flip(contrib, axis=self.dim)
        out = jnp.cumsum(contrib, axis=self.dim)
        return jnp.flip(out, axis=self.dim) if self.reverse else out

    def compute(self):
        return self.materialize()


# -- Field operator overloads (reference: fields participate in the operation
# algebra; broadcasting_abstract_fields.jl) --

def _field_binop(op):
    def method(self, other):
        return BinaryOperation(op, self, other)
    return method


def _field_rbinop(op):
    def method(self, other):
        return BinaryOperation(op, other, self)
    return method


Field.__add__ = _field_binop(jnp.add)
Field.__radd__ = _field_binop(jnp.add)
Field.__sub__ = _field_binop(jnp.subtract)
Field.__rsub__ = _field_rbinop(jnp.subtract)
Field.__mul__ = _field_binop(jnp.multiply)
Field.__rmul__ = _field_binop(jnp.multiply)
Field.__truediv__ = _field_binop(jnp.divide)
Field.__rtruediv__ = _field_rbinop(jnp.divide)
Field.__pow__ = _field_binop(jnp.power)
Field.__neg__ = lambda self: UnaryOperation(jnp.negative, self)
Field.__abs__ = lambda self: UnaryOperation(jnp.abs, self)
AbstractOperation.__abs__ = lambda self: UnaryOperation(jnp.abs, self)


class ComputedField:
    """An operation materialized on demand with time-stamped caching
    (reference: src/AbstractOperations/computed_field.jl — ``Field(op)``
    whose ``compute!(f, t)`` is a no-op when ``f.status.time == t``).

    ``compute(time)`` re-evaluates only when ``time`` differs from the
    cached stamp, so several writers/diagnostics sharing one diagnostic at
    the same model time pay for a single evaluation. ``compute()`` with no
    argument always re-evaluates."""

    def __init__(self, op):
        self.op = op
        self.grid = op.grid
        self.loc = op.loc
        self._time = None
        self._cached = None

    def compute(self, time=None):
        if (time is None or self._cached is None
                or self._time is None or time != self._time):
            self._cached = self.op.compute()
            self._time = time
        return self._cached

    @property
    def interior(self):
        return self.compute().interior

    def __call__(self, model=None):
        # writer-protocol: fetch at the model's current time (cached)
        return self.compute(None if model is None else model.time)
