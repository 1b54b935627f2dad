"""Callback callsites (reference: src/Oceananigans.jl:202-204 —
`TimeStepCallsite`, `TendencyCallsite`, `UpdateStateCallsite`; callback.jl).

Design split: `TimeStepCallsite` callbacks are ordinary host callbacks
running between jitted steps (the default). `TendencyCallsite` and
`UpdateStateCallsite` callbacks run INSIDE the compiled step, so they must be
TRACEABLE functions with the traced signatures

    TendencyCallsite:     fn(grid, fields, G, time) -> G       (tendency dict)
    UpdateStateCallsite:  fn(grid, fields, time) -> fields     (field updates)

and they actuate every step (a traced step cannot consult a host-side
schedule). Registering one re-traces the model's step function."""

from __future__ import annotations


class TimeStepCallsite:
    """Host callback after each completed time step (the default)."""


class TendencyCallsite:
    """Traced hook over the tendency dict, applied after forcing and
    boundary-flux terms, before the timestepper update."""


class UpdateStateCallsite:
    """Traced hook over the prognostic fields at the end of each step."""
