"""Simulation: the host-side run loop around the jitted model step.

Reference semantics: src/Simulations/simulation.jl (struct :10-30, ctor
:68-110 — auto-installed stop criteria and NaNChecker) and run.jl (run! :92-113,
time_step! :125-176, Δt alignment :24-57).

Design: the loop itself is plain Python — everything inside
``model.time_step(dt)`` is one compiled XLA program. Callbacks/writers fire on
host between steps; NaN checking syncs device→host only every N iterations."""

from __future__ import annotations

import time as _time

import numpy as np

from ..utils.schedules import IterationInterval, Schedule, TimeInterval


class Callback:
    def __init__(self, func, schedule=None):
        self.func = func
        self.schedule = schedule or IterationInterval(1)

    def maybe_call(self, sim):
        if self.schedule(sim.model):
            self.func(sim)


class NaNChecker:
    """Abort when a NaN appears in the monitored fields (reference:
    src/Diagnostics/nan_checker.jl; installed every 100 iterations by default
    like simulation.jl:91-94)."""

    def __init__(self, fields=None):
        self.fields = fields

    def __call__(self, sim):
        names = self.fields
        if names is None:
            # first prognostic field of the model (reference default: the
            # first velocity) — "u" for 3D models, "uh" for shallow water
            st = sim.model.state
            avail = st["fields"] if "fields" in st else \
                {k: v for k, v in st.items()
                 if getattr(v, "ndim", 0) >= 2}
            names = ("u",) if "u" in avail else (next(iter(avail)),)
        for name in names:
            # sample the interior only: halo slots may be stale between
            # fills (the next fill re-derives halos)
            data = sim.model.field(name).interior
            if bool(np.isnan(np.asarray(data).ravel()[::max(1, data.size // 4096)]).any()):
                sim.running = False
                raise RuntimeError(
                    f"time = {sim.model.time}, iteration = "
                    f"{sim.model.iteration}: NaN found in field {name!r}. "
                    "Aborting simulation.")


class Simulation:
    def __init__(self, model, dt, stop_time=None, stop_iteration=None,
                 wall_time_limit=None, verbose=False):
        from ..utils.dateclock import interval_seconds, seconds_since
        self.model = model
        self.dt = interval_seconds(dt)
        # datetimes convert against the model's reference_datetime
        # (reference: Clock{DateTime}, clock.jl)
        if stop_time is not None:
            stop_time = seconds_since(
                stop_time, getattr(model, "reference_datetime", None))
        self.stop_time = stop_time
        self.stop_iteration = stop_iteration
        self.wall_time_limit = wall_time_limit
        self.verbose = verbose
        self.callbacks = {}
        self.output_writers = {}
        self.diagnostics = {}
        self.running = True
        self.initialized = False
        self.run_wall_time = 0.0
        self.add_callback(NaNChecker(), IterationInterval(100),
                          name="nan_checker")

    # -- registration ---------------------------------------------------------

    def add_callback(self, func, schedule=None, name=None, callsite=None):
        from .callsites import TendencyCallsite, UpdateStateCallsite
        if callsite is not None and not isinstance(callsite, type):
            callsite = type(callsite)
        if callsite is TendencyCallsite:
            # traced hook inside the compiled step (see callsites.py for the
            # signature); the schedule does not apply
            self.model.add_tendency_hook(func)
            return func
        if callsite is UpdateStateCallsite:
            self.model.add_state_hook(func)
            return func
        cb = Callback(func, schedule)
        name = name or f"callback{len(self.callbacks)}"
        self.callbacks[name] = cb
        return cb

    def add_output_writer(self, writer, name=None):
        name = name or f"writer{len(self.output_writers)}"
        self.output_writers[name] = writer
        return writer

    # -- stepping -------------------------------------------------------------

    def _aligned_dt(self):
        """Shrink Δt to land on schedules / stop_time (reference:
        run.jl:24-57 aligned_time_step)."""
        dt = self.dt
        for w in self.output_writers.values():
            sched = getattr(w, "schedule", None)
            if isinstance(sched, Schedule):
                dt = sched.aligned_time_step(self.model, dt)
        for cb in self.callbacks.values():
            dt = cb.schedule.aligned_time_step(self.model, dt)
        if self.stop_time is not None:
            remaining = self.stop_time - float(self.model.time)
            if remaining > 1e-6 * self.dt:
                dt = min(dt, remaining)
        return dt

    def _stop_criteria(self):
        if self.stop_iteration is not None \
                and self.model.iteration >= self.stop_iteration:
            return "stop_iteration"
        if self.stop_time is not None \
                and self.model.time >= self.stop_time - 1e-6 * self.dt:
            # tolerance relative to Δt: the model clock may be float32, so an
            # absolute 1e-12 margin can never be met and Δt would collapse to
            # ~0 (and 1/Δt in the pressure projection to NaN)
            return "stop_time"
        if self.wall_time_limit is not None \
                and self.run_wall_time >= self.wall_time_limit:
            return "wall_time_limit"
        return None

    def initialize(self):
        for cb in self.callbacks.values():
            cb.schedule.initialize(self.model)
            # callback initialize! hook (reference: callback.jl
            # initialize!(cb.func, sim) at simulation start)
            init = getattr(cb.func, "initialize", None)
            if callable(init):
                init(self)
        for d in self.diagnostics.values():
            sched = getattr(d, "schedule", None)
            if isinstance(sched, Schedule):
                sched.initialize(self.model)
        for w in self.output_writers.values():
            sched = getattr(w, "schedule", None)
            if isinstance(sched, Schedule):
                sched.initialize(self.model)
            if hasattr(w, "initialize"):
                w.initialize(self)
            w.maybe_write(self, force=True)
        self.initialized = True

    def step(self):
        dt = self._aligned_dt()
        self.model.time_step(dt)
        for cb in self.callbacks.values():
            cb.maybe_call(self)
        # registered diagnostics run in the loop on their schedules
        # (reference: run.jl time_step! actuates simulation.diagnostics);
        # entries are callables of the simulation, optionally carrying a
        # ``schedule`` attribute
        for d in self.diagnostics.values():
            if hasattr(d, "maybe_call"):
                d.maybe_call(self)
                continue
            sched = getattr(d, "schedule", None)
            if sched is None or sched(self.model):
                d(self)
        for w in self.output_writers.values():
            w.maybe_write(self)

    def run(self, pickup=False):
        """Reference: run!, src/Simulations/run.jl:92-113."""
        if pickup:
            from .checkpointer import Checkpointer, restore_latest
            cps = [w for w in self.output_writers.values()
                   if isinstance(w, Checkpointer)]
            restore_latest(self.model, pickup, checkpointers=cps)
        if not self.initialized:
            self.initialize()
        self.running = True
        t0 = _time.monotonic()
        while self.running:
            reason = self._stop_criteria()
            if reason is not None:
                if self.verbose:
                    print(f"Simulation is stopping ({reason}).")
                break
            self.step()
            self.run_wall_time = _time.monotonic() - t0
        # callback finalize! hooks (reference: run.jl calls
        # finalize!(callback, sim) when the run stops)
        for cb in self.callbacks.values():
            fin = getattr(cb.func, "finalize", None)
            if callable(fin):
                fin(self)
        return self
