"""Secondary benchmarks mirroring the reference's published tables
(BASELINE.md), one JSON row each:

* shallow water WENO at 8192² and 16384² (reference: 16384² F64 → 681
  ms/step ≈ 394 M cu/s, 8192² F64 → 166.8 ms ≈ 402 M cu/s on a V100-32GB —
  docs/src/appendix/benchmarks.md:35-75); the rows here are float32, which
  the metric name says;
* LES closure cost at 128³ (reference: benchmarks.md:600-663 — F64,
  SmagorinskyLilly 23.97 ms / AMD 25.86 ms median on a V100);
* tracer-cost scaling at 256³ (reference: 12.8 ms @ 0 → 27.2 ms @ 12
  tracers — benchmarks.md:540-570), as the 12-vs-0 step-time ratio.

Also home of the timing helpers bench.py uses. Every row names the card
(``nvidia-smi`` name and power limit), the device and ``XLA_FLAGS``. Needs a
GPU. ``BENCH_ONLY=sw|les|tracers`` runs one group; ``BENCH_STEPS`` sets the
timed steps per block.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from oceananigans_tpu import RectilinearGrid
from oceananigans_tpu.advection import WENO, Centered
from oceananigans_tpu.buoyancy import BuoyancyTracer
from oceananigans_tpu.closures import (AnisotropicMinimumDissipation,
                                       SmagorinskyLilly)
from oceananigans_tpu.models import NonhydrostaticModel
from oceananigans_tpu.platform import configure_compilation_cache, require_gpu


def machine():
    """The card, the device as JAX reports it, and XLA_FLAGS — for every
    row. Raises without a GPU."""
    card = chip_smoke.query_card()
    configure_compilation_cache()
    devices = require_gpu()
    return {"card": card, "device_kind": devices[0].device_kind,
            "device_count": len(devices),
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "jax": jax.__version__}


def timed_blocks(advance, model, steps, blocks=3, target_spread=0.02,
                 max_doublings=2):
    """Median warm seconds per step over ``blocks`` blocks of ``steps``
    calls of ``advance(model, 1)``, each block ended by block_until_ready;
    the block length doubles (bounded) while the spread (max-min)/median
    exceeds ``target_spread``. Returns (median, spread, steps_used)."""
    advance(model, 1)                       # compile
    jax.block_until_ready(model.state)
    for attempt in range(max_doublings + 1):
        times = []
        for _ in range(blocks):
            t0 = time.perf_counter()
            advance(model, steps)
            jax.block_until_ready(model.state)
            times.append((time.perf_counter() - t0) / steps)
        med = sorted(times)[len(times) // 2]
        spread = (max(times) - min(times)) / med
        if spread <= target_spread or attempt == max_doublings:
            return med, spread, steps
        steps *= 2


def _stepper(dt):
    def advance(model, n):
        for _ in range(n):
            model.time_step(dt)
    return advance


def row(metric, cells, model, dt, steps, blocks=3, **extra):
    """Time ``model`` and return its cell-updates/s row."""
    med, spread, used = timed_blocks(_stepper(dt), model, steps, blocks)
    return {"metric": metric, "value": cells / med,
            "unit": "cell-updates/s", "step_ms": med * 1e3,
            "spread_pct": round(spread * 100, 2), "steps": used,
            "blocks": blocks, **extra}


def hydro_row(steps=None):
    """Hydrostatic lat-lon 512x256x32 WENO-VI split-explicit row (the
    production primitive-equation configuration; reference analogue:
    benchmark/benchmark_models_stepping.jl)."""
    steps = steps or int(os.environ.get("BENCH_STEPS", "20"))
    size = (512, 256, 32)
    m = chip_smoke.build_hydro(size, jnp.float32)
    return row("hydrostatic_latlon_512x256x32_wenoVI_splitexplicit_f32"
               "_cell_updates_per_s", int(np.prod(size)), m, 120.0, steps)


def cs_row(steps=None):
    """Cubed-sphere hydrostatic 6x64x64x32 split-explicit row (the
    panel-batched step; reference analogue: the MultiRegion cubed-sphere
    benchmarks)."""
    steps = steps or int(os.environ.get("BENCH_STEPS", "50"))
    m = chip_smoke.build_cs((64, 32), jnp.float32)
    return row("cubed_sphere_hydrostatic_6x64x64x32_splitexplicit_f32"
               "_cell_updates_per_s", 6 * 64 * 64 * 32, m, 600.0, steps)


def main():
    info = machine()
    only = os.environ.get("BENCH_ONLY", "")
    steps = int(os.environ.get("BENCH_STEPS", "10"))
    rng = np.random.default_rng(0)

    def emit(r):
        print(json.dumps({**r, **info}), flush=True)

    if only in ("", "sw"):
        for n, v100_s in ((8192, 0.1668), (16384, 0.681)):
            m = chip_smoke.build_sw(n, jnp.float32)
            r = row(f"shallow_water_{n}^2_weno5_f32_cell_updates_per_s",
                    n * n, m, 1e-5, steps)
            r["vs_v100_f64"] = r["value"] / (n * n / v100_s)
            emit(r)
            del m

    def box(n, **kw):
        grid = RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                               topology=("periodic", "periodic", "bounded"),
                               dtype=jnp.float32)
        return NonhydrostaticModel(grid=grid, **kw)

    if only in ("", "les"):
        n = 128
        for cname, closure, v100_ms in (
                ("smagorinsky_lilly", SmagorinskyLilly(), 23.969),
                ("amd", AnisotropicMinimumDissipation(), 25.856)):
            m = box(n, advection=WENO(5), tracers=("b",),
                    buoyancy=BuoyancyTracer(), closure=closure)
            m.set(u=0.1 * rng.standard_normal((n, n, n)),
                  b=1e-4 * rng.standard_normal((n, n, n)))
            r = row(f"les_{cname}_{n}^3_weno5_f32_cell_updates_per_s",
                    n ** 3, m, 1e-4, steps)
            r["vs_v100_f64_ms"] = v100_ms / r["step_ms"]
            emit(r)

    if only in ("", "tracers"):
        # the reference's tracer table used its default 2nd-order centered
        # advection for momentum AND tracers — the centered row is the
        # like-for-like comparison; the WENO row shows the high-order cost
        n = 256
        for scheme, label in ((Centered(2), "centered2"), (WENO(5), "weno5")):
            ms = {}
            for ntr in (0, 12):
                names = tuple(f"c{i}" for i in range(ntr))
                m = box(n, advection=scheme, tracers=names)
                m.set(u=0.1 * rng.standard_normal((n, n, n)),
                      **{nm: rng.random((n, n, n)) for nm in names})
                ms[ntr] = row("", n ** 3, m, 1e-4, steps)["step_ms"]
                del m
            ratio = ms[12] / ms[0]
            emit({"metric": f"tracer_scaling_{n}^3_{label}"
                            "_step_ratio_12_vs_0",
                  "value": ratio, "unit": "x",
                  "vs_v100": (27.2 / 12.8) / ratio,
                  "step_ms_0": ms[0], "step_ms_12": ms[12]})


if __name__ == "__main__":
    main()
