"""Ensemble stepping: batch many independent model instances over a leading
ensemble axis.

Reference semantics: src/Models/HydrostaticFreeSurfaceModels/
slice_ensemble_model_mode.jl + single_column_model_mode.jl — the reference
fakes an ensemble by abusing grid dimensions (an "ensemble axis" replaces x);
the mechanism is `jax.vmap` of the SAME jitted step over stacked
states (SURVEY.md §5: "ensemble axes via SliceEnsembleMode — the DP analogue
for parameter-calibration ensembles"). The ensemble axis is also shardable
over a device mesh for embarrassingly-parallel calibration sweeps."""

from __future__ import annotations

import jax
import jax.numpy as jnp


class EnsembleModel:
    """n independent copies of ``model`` stepped in one vmapped program.

    Usage::

        ens = EnsembleModel(model, n=64)
        ens.set(member=7, b=lambda x, y, z: ...)   # or set_all(fn(i))
        ens.time_step(60.0)                        # all members, one launch
        e7 = ens.member_state(7)
    """

    def __init__(self, model, n):
        self.model = model
        self.n = int(n)
        self.state = jax.tree.map(
            lambda leaf: jnp.broadcast_to(leaf, (self.n,) + leaf.shape).copy()
            if hasattr(leaf, "shape") else leaf, model.state)
        self._vstep = jax.jit(jax.vmap(model._build_step(),
                                       in_axes=(0, None)))

    def set(self, member, **fields):
        """Set fields of ONE member (same kwargs as model.set)."""
        saved = self.model.state
        self.model.state = self.member_state(member)
        self.model.set(**fields)
        new = self.model.state
        self.model.state = saved
        self.state = jax.tree.map(
            lambda ens, one: ens.at[member].set(one), self.state, new)

    def set_all(self, fn):
        """``fn(member_index) -> dict of set() kwargs`` applied per member."""
        for m in range(self.n):
            self.set(m, **fn(m))

    def member_state(self, member):
        return jax.tree.map(lambda leaf: leaf[member], self.state)

    def time_step(self, dt):
        dt = jnp.asarray(dt, self.model.grid.dtype)
        self.state = self._vstep(self.state, dt)
        return self

    def field(self, member, name):
        saved = self.model.state
        self.model.state = self.member_state(member)
        out = self.model.field(name)
        self.model.state = saved
        return out
