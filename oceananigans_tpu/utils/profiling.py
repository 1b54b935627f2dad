"""Profiling helpers (SURVEY §5 tracing/profiling; the reference relies on
BenchmarkTools + wall clocks — here jax.profiler gives full XLA traces).

Typical use::

    from oceananigans_tpu.utils.profiling import profile_step, time_step
    time_step(model)                      # wall-clock ms/step, warm
    profile_step(model, logdir="/tmp/tb") # TensorBoard/Perfetto trace
"""

from __future__ import annotations

import time


def time_step(model, dt=None, steps=10, warmup=2):
    """Warm wall-clock seconds per step of ``model``, synchronized with
    ``jax.block_until_ready`` on the state."""
    import jax

    dt = model.grid.dtype(1e-4) if dt is None else dt
    state = model.state
    step = (model._step_for(float(dt)) if hasattr(model, "_step_for")
            else model._step)
    for _ in range(warmup):
        state = step(state, dt)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state, dt)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / steps


def profile_step(model, dt=None, steps=3, logdir="/tmp/oceananigans_trace"):
    """Capture a jax.profiler trace of ``steps`` model steps into
    ``logdir`` (open with TensorBoard's profile plugin or
    ui.perfetto.dev). Returns the logdir."""
    import jax
    import jax.numpy as jnp

    dt = model.grid.dtype(1e-4) if dt is None else dt
    state = model.state
    step = (model._step_for(float(dt)) if hasattr(model, "_step_for")
            else model._step)
    state = step(state, dt)                       # compile outside the trace
    jax.block_until_ready(state)
    with jax.profiler.trace(logdir):
        for _ in range(steps):
            state = step(state, dt)
        jax.block_until_ready(state)
    return logdir
