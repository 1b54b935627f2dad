"""Headline benchmarks, one JSON row each:

1. hydrostatic lat-lon 512x256x32 WENO-VI split-explicit (production
   primitive-equation configuration);
2. cubed-sphere hydrostatic 6x64x64x32 split-explicit (panel-batched step);
3. flagship: 256³ nonhydrostatic WENO LES, time per RK3 step — printed
   LAST so a single-line parser reads the flagship row.

Mirrors the reference's canonical benchmark setups
(benchmark/benchmark_nonhydrostatic_models.jl,
benchmark/benchmark_models_stepping.jl: build model, warm up, timed
time_step!). Baseline anchor for the flagship: 432 M cell-updates/s (V100,
Float32, WENO — docs/src/appendix/benchmarks.md:120-125; see BASELINE.md).

Each row is the median over 3 timing blocks, each ended by
block_until_ready, with the relative spread (max-min)/median; the block
length doubles (bounded) until the spread is <= 2%. Every row names the
card, its power limit, the device and XLA_FLAGS. Needs a GPU.

Env: BENCH_ONLY=flagship|hydro|cs (default: all three), BENCH_STEPS
(starting block length).
"""

import json
import os

import jax.numpy as jnp

import bench_extra
import chip_smoke

BASELINE_CU_PER_S = 432e6  # V100 Float32 256³ WENO (BASELINE.md)


def flagship_row():
    """The 256³ nonhydrostatic WENO-5 RK3 row."""
    n = 256
    steps = int(os.environ.get("BENCH_STEPS", "20"))
    model = chip_smoke.build_nh(n, jnp.float32)
    r = bench_extra.row("nonhydrostatic_256^3_weno5_f32_cell_updates_per_s",
                        n ** 3, model, 1e-4, steps)
    r["vs_baseline"] = r["value"] / BASELINE_CU_PER_S
    return r


def main():
    info = bench_extra.machine()
    only = os.environ.get("BENCH_ONLY", "")
    rows = (("hydro", bench_extra.hydro_row), ("cs", bench_extra.cs_row),
            ("flagship", flagship_row))
    for name, fn in rows:
        if only in ("", name):
            print(json.dumps({**fn(), **info}), flush=True)


if __name__ == "__main__":
    main()
