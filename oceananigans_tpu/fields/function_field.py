"""Lazy analytic fields: FunctionField, ConstantField, ZeroField, OneField.

Reference semantics: src/Fields/function_field.jl (FunctionField{LX,LY,LZ}:
a func(x, y, z[, t][, parameters]) evaluated on demand at the field's nodes,
carrying an optional clock) and src/Fields/constant_field.jl
(ConstantField/ZeroField/OneField: grid-free uniform fields usable anywhere
a field is).

Design: with a grid attached these are ordinary :class:`Field` objects
whose padded data is the traced evaluation of the function — XLA folds the
broadcast into consumers, so laziness buys nothing on-device. Without a grid
they are lightweight CALLABLE placeholders, accepted everywhere the package
takes ``f(x, y, z)`` setters (``model.set``, background fields, prescribed
velocities); attach a grid later with ``.on_grid(grid, loc)``."""

from __future__ import annotations

import inspect

import jax.numpy as jnp

from ..grids.topology import LOC_CCC
from .field import Field, set_on_padded


class FunctionField(Field):
    """``FunctionField(loc, func, grid, time=0.0, parameters=None)`` — the
    function is evaluated at the staggered nodes of ``loc``; re-evaluate at
    another time with ``at_time(t)`` (reference: function_field.jl — the
    clock-carrying lazy field; here evaluation is eager/traced).

    ``func(x, y, z)``, ``func(x, y, z, t)``, or ``func(x, y, z, t, p)``."""

    def __init__(self, loc, func, grid, time=0.0, parameters=None):
        self.func = func
        self.parameters = parameters
        try:
            self._nargs = len(inspect.signature(func).parameters)
        except (TypeError, ValueError):
            self._nargs = 3
        super().__init__(grid, loc, None,
                         self._evaluate(grid, tuple(loc), time))
        self.time = time

    def _evaluate(self, grid, loc, time):
        if self._nargs <= 3:
            return set_on_padded(grid, loc, self.func)
        if self.parameters is not None and self._nargs >= 5:
            f = lambda x, y, z: self.func(x, y, z, time, self.parameters)
        else:
            f = lambda x, y, z: self.func(x, y, z, time)
        return set_on_padded(grid, loc, f)

    def at_time(self, time):
        """Refresh the data at model time ``time`` (returns self)."""
        self.data = self._evaluate(self.grid, self.loc, time)
        self.time = time
        return self


class ConstantField:
    """A uniform field of ``value`` with no grid attached (reference:
    constant_field.jl). Callable as an ``f(x, y, z)`` setter, so it works in
    ``model.set(u=ConstantField(0.1))``, background fields, and prescribed
    velocities; ``on_grid(grid, loc)`` materializes a :class:`Field`."""

    def __init__(self, value):
        self.value = value

    def __call__(self, x, y, z, *rest):
        return jnp.zeros(jnp.broadcast_shapes(jnp.shape(x), jnp.shape(y),
                                              jnp.shape(z))) + self.value

    def __float__(self):
        return float(self.value)

    def on_grid(self, grid, loc=LOC_CCC):
        return Field(grid, loc, None, set_on_padded(grid, loc, self.value))

    def __repr__(self):
        return f"ConstantField({self.value})"


def ZeroField():
    """Reference: constant_field.jl ZeroField()."""
    return ConstantField(0.0)


def OneField():
    """Reference: constant_field.jl OneField()."""
    return ConstantField(1.0)


def GridMetricOperation(loc, metric, grid):
    """A grid metric as a (materialized) field: ``metric`` is one of
    ``"dx" | "dy" | "dz" | "Ax" | "Ay" | "Az" | "volume"`` (reference:
    AbstractOperations/grid_metrics.jl — Δx/Δy/Δz/Az/volume as operands;
    e.g. ``Integral(c)`` ≡ sum of ``c * GridMetricOperation(loc, "volume",
    grid)``)."""
    loc = tuple(loc)
    names = {"dx": grid.dx, "dy": grid.dy, "dz": grid.dz,
             "Ax": grid.Ax, "Ay": grid.Ay, "Az": grid.Az,
             "volume": grid.V, "V": grid.V}
    if metric not in names:
        raise ValueError(f"unknown metric {metric!r} "
                         f"(one of {sorted(names)})")
    data = jnp.broadcast_to(jnp.asarray(names[metric](loc), grid.dtype),
                            grid.padded_shape)
    return Field(grid, loc, None, data)


def interpolate(field, x, y, z):
    """Value(s) of ``field`` at arbitrary physical positions by trilinear
    interpolation with fractional indices (reference:
    src/Fields/interpolate.jl:265-281). ``x, y, z`` may be scalars or
    equal-length arrays; traceable."""
    from ..particles import interpolate_field
    x, y, z = (jnp.atleast_1d(jnp.asarray(q)) for q in (x, y, z))
    out = interpolate_field(field.grid, field.data, field.loc, x, y, z)
    return out[0] if out.shape == (1,) else out
