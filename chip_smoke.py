"""Drive every model's main path once on the GPU and check what comes out.

    python chip_smoke.py             # one card: the nh, hydro, cs, sw phases
    python chip_smoke.py --chips 4   # four cards: the sharded path only

A phase builds a model through its public constructor at the width the
repository benchmarks, steps it with the user's entry point (``Simulation``
for the nonhydrostatic model, ``model.time_step`` for the others), and prints
one JSON line: compile time, warm ms/step, the device busy time of a traced
step, the bytes a step must at least move, XLA's memory analysis, the peak
device memory, whether every field is finite, and the relative error of each
prognostic against the same model run in float64 on the same card. The nh
line also carries the Poisson residual and the matmul- and FFT-DCT times.

The card's name and power limit (from ``nvidia-smi``) are printed first and
carried in every line. The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``; a
failed phase or check ends the script with a non-zero exit code before it.
The phase functions take their sizes as arguments so the tests can run them
small on the CPU (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from oceananigans_tpu import (LatitudeLongitudeGrid,
                              RectilinearGrid, Simulation)
from oceananigans_tpu.advection import WENO, WENOVectorInvariant
from oceananigans_tpu.coriolis import HydrostaticSphericalCoriolis
from oceananigans_tpu.grids.cubed_sphere import (
    ConformalCubedSphereGrid)
from oceananigans_tpu.models import (CubedSphereHydrostaticModel,
                                     HydrostaticFreeSurfaceModel,
                                     NonhydrostaticModel,
                                     SplitExplicitFreeSurface)
from oceananigans_tpu.models.shallow_water import ShallowWaterModel
from oceananigans_tpu.parallel import (Distributed,
                                       DistributedFFTPoissonSolver, Partition)
from oceananigans_tpu.platform import (configure_compilation_cache,
                                       require_gpu)
from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver
from oceananigans_tpu.solvers.transforms import (
    dct_forward, dct_forward_fft, dct_inverse, dct_inverse_fft)

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TRACE_DIR = os.path.join(REPO, "chiprun_out", "smoke_traces")

# Relative L2 tolerance of each float32 prognostic against the float64 run
# of the same model after the phase's steps. Both runs start from the same
# float64-drawn fields; the difference is float32 rounding (eps 6e-8) of the
# initial fields and of every step's arithmetic, amplified by the nonlinear
# (WENO) reconstructions. On the CPU at the test sizes the largest error is
# 4e-6 (the cubed-sphere free surface), every other prognostic of every
# phase below 3e-7 (tests/test_chip_smoke.py); the GPU sums in other orders
# and uses cuFFT, so the bound leaves more than a decade on top of that. A
# wrong kernel or a lost term gives O(1e-2) or more.
F64_TOLERANCE = 1e-4

# Sharded against single-device runs of the same float32 model: the same
# arithmetic partitioned by GSPMD, which may reorder sums and reductions.
SHARDED_TOLERANCE = 1e-5

# ‖∇²p − b‖/‖b‖ of the float32 Poisson solve, and the largest difference of
# the two DCT paths: float32 transforms of a random field leave about 1e-6
# (4e-7 on the CPU at 16³); a solve in TF32 would leave about 1e-3.
POISSON_TOLERANCE = 1e-4


# -- the four model configurations --------------------------------------------

def _rng():
    return np.random.default_rng(SEED)


def build_nh(n, dtype):
    """256³ periodic/periodic/bounded WENO(5) RK3 LES (the flagship)."""
    grid = RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                           topology=("periodic", "periodic", "bounded"),
                           dtype=dtype)
    model = NonhydrostaticModel(grid=grid, advection=WENO(5))
    rng = _rng()
    model.set(u=0.1 * rng.standard_normal((n, n, n)),
              v=0.1 * rng.standard_normal((n, n, n)))
    return model


def build_hydro(size, dtype):
    """Lat-lon WENO vector-invariant split-explicit primitive equations."""
    nx, ny, nz = size
    grid = LatitudeLongitudeGrid(size=size, longitude=(0, 60),
                                 latitude=(15, 75), z=(-1800.0, 0.0),
                                 dtype=dtype)
    model = HydrostaticFreeSurfaceModel(
        grid=grid, momentum_advection=WENOVectorInvariant(),
        coriolis=HydrostaticSphericalCoriolis(),
        free_surface=SplitExplicitFreeSurface(substeps=30), tracers=("T",))
    model.set(u=0.05 * _rng().standard_normal(size),
              T=lambda lam, phi, z: 12 + 8e-3 * z + 2e-2 * phi)
    return model


def build_cs(size, dtype):
    """Cubed-sphere hydrostatic model, split-explicit with 20 substeps."""
    n, nz = size
    grid = ConformalCubedSphereGrid((n, n, nz), z=(-3000.0, 0.0),
                                    radius=6.371e6, dtype=dtype)
    model = CubedSphereHydrostaticModel(
        grid, tracers=("b",), rotation_rate=7.292e-5,
        free_surface="split_explicit", substeps=20)
    model.set(b=lambda lam, phi, z: 1e-5 * z
              + 1e-4 * np.exp(-(lam ** 2 + phi ** 2) / 0.2))
    model.set_geographic(u_east=lambda lam, phi: 5.0 * np.cos(phi))
    return model


def build_sw(n, dtype):
    """Doubly periodic WENO(5) shallow water (conservative formulation)."""
    grid = RectilinearGrid(size=(n, n), extent=(1.0, 1.0),
                           topology=("periodic", "periodic", "flat"),
                           dtype=dtype)
    model = ShallowWaterModel(grid=grid, advection=WENO(5),
                              gravitational_acceleration=9.81)
    rng = _rng()
    model.set(h=1.0 + 0.01 * rng.standard_normal((n, n)),
              uh=0.01 * rng.standard_normal((n, n)),
              vh=0.01 * rng.standard_normal((n, n)))
    return model


def _interior(grid, a):
    sl = [slice(h, h + n) for n, h in zip(grid.N, grid.H)]
    if a.shape[2] == 1:                     # 2D fields carry one z slot
        sl[2] = slice(None)
    return np.asarray(a[tuple(sl)])


def _advance_simulation(model, dt, n):
    sim = Simulation(model, dt=dt, stop_iteration=model.iteration + n)
    sim.run()


def _advance(model, dt, n):
    for _ in range(n):
        model.time_step(dt)


class Phase:
    """One model configuration: how to build it at a size, advance it, read
    its prognostics, and how many RK stages a step has (for the bytes)."""

    def __init__(self, name, build, size, dt, names, stages, advance,
                 read):
        self.name, self.build, self.size, self.dt = name, build, size, dt
        self.names, self.stages = names, stages
        self.advance, self.read = advance, read

    def fields(self, model):
        return {k: self.read(model, k) for k in self.names}


PHASES = {
    "nh": Phase("nh", build_nh, 256, 1e-4, ("u", "v", "w"), 3,
                _advance_simulation,
                lambda m, k: _interior(m.grid, m.state["fields"][k])),
    "hydro": Phase("hydro", build_hydro, (512, 256, 32), 120.0,
                   ("u", "v", "T", "eta"), 1, _advance,
                   lambda m, k: _interior(m.grid, m.state["fields"][k])),
    "cs": Phase("cs", build_cs, (64, 32), 600.0, ("u", "v", "b", "eta"), 1,
                _advance, lambda m, k: np.asarray(m.field(k).interior)),
    "sw": Phase("sw", build_sw, 8192, 1e-5, ("uh", "vh", "h"), 3, _advance,
                lambda m, k: _interior(m.grid, m.state["fields"][k])),
}


# -- measurement helpers ------------------------------------------------------

def _jitted_step(model, dt):
    """The jitted step ``model.time_step(dt)`` runs."""
    step_for = getattr(model, "_step_for", None)
    return step_for(dt) if step_for is not None else model._step


def _memory_analysis(compiled):
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys}


def _memory_stat(device, key):
    stats = device.memory_stats()          # None on the CPU
    return None if stats is None else int(stats[key])


def _state_bytes(model, names):
    state = model.state.get("fields", model.state)
    return int(sum(state[k].nbytes for k in names))


def busy_ns(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_busy(xplane_path):
    """Device busy time in a trace: the union of the kernel events on the
    GPU planes' stream lines (``XLA Ops`` where a plane has no stream
    line). Returns (busy_ns, line names used)."""
    from jax.profiler import ProfileData
    intervals, used = [], set()
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {line.name: line for line in plane.lines}
        names = ([n for n in lines if n.startswith("Stream")]
                 or [n for n in lines if n == "XLA Ops"])
        for n in names:
            used.add(n)
            intervals.extend((e.start_ns, e.end_ns) for e in lines[n].events)
    if not intervals:
        raise RuntimeError(f"no GPU kernel events in {xplane_path}")
    return busy_ns(intervals), sorted(used)


def _traced(phase, model, steps):
    """Device busy ms per step and idle share over ``steps`` traced steps."""
    out = os.path.join(TRACE_DIR, phase.name)
    shutil.rmtree(out, ignore_errors=True)
    jax.profiler.start_trace(out)
    t0 = time.perf_counter()
    phase.advance(model, phase.dt, steps)
    jax.block_until_ready(model.state)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = glob.glob(os.path.join(out, "**", "*.xplane.pb"), recursive=True)
    busy, lines = device_busy(path[0])
    shutil.rmtree(out, ignore_errors=True)
    return {"device_busy_ms_per_step": busy / 1e6 / steps,
            "wall_ms_per_step": wall * 1e3 / steps,
            "idle_share": 1.0 - busy / 1e9 / wall, "lines": lines}


def relative_errors(a, b):
    """‖a − b‖ / ‖b‖ per key (L2 over the interior)."""
    out = {}
    for k in b:
        ref = np.asarray(b[k], np.float64)
        den = np.linalg.norm(ref)
        num = np.linalg.norm(np.asarray(a[k], np.float64) - ref)
        out[k] = float(num / den) if den > 0 else float(num)
    return out


# -- one phase ----------------------------------------------------------------

def run_phase(phase, size=None, steps=10, trace_steps=3, card=None):
    """Build, compile, time, trace and check one model; return its line."""
    size = phase.size if size is None else size
    device = jax.devices()[0]
    with jax.enable_x64(False):
        model = phase.build(size, jnp.float32)
        dt = jnp.asarray(phase.dt, model.grid.dtype)
        t0 = time.perf_counter()
        compiled = _jitted_step(model, phase.dt).lower(model.state,
                                                       dt).compile()
        compile_s = time.perf_counter() - t0
        memory = _memory_analysis(compiled)
        phase.advance(model, phase.dt, 1)              # first call: warm-up
        jax.block_until_ready(model.state)
        t0 = time.perf_counter()
        phase.advance(model, phase.dt, steps)
        jax.block_until_ready(model.state)
        ms = (time.perf_counter() - t0) * 1e3 / steps
        trace = _traced(phase, model, trace_steps) if trace_steps else None
        q32 = phase.fields(model)
        moved = phase.stages * 2 * _state_bytes(model, phase.names)
        z_compact = getattr(model, "_z_compact", None)
        del model
    with jax.enable_x64(True):
        ref = phase.build(size, jnp.float64)
        phase.advance(ref, phase.dt, 1 + steps + trace_steps)
        q64 = phase.fields(ref)
        del ref
    errors = relative_errors(q32, q64)
    finite = all(bool(np.isfinite(q).all()) for q in q32.values())
    line = {
        "phase": phase.name, "card": card, "size": size,
        "steps": 1 + steps + trace_steps,
        "compile_s": compile_s, "ms_per_step": ms,
        "min_bytes_per_step": moved,
        "memory_analysis": memory,
        "peak_bytes_in_use": _memory_stat(device, "peak_bytes_in_use"),
        "finite": finite,
        "rel_err_vs_f64": errors, "tolerance": F64_TOLERANCE,
    }
    if trace is not None:
        line["trace"] = trace
        line["min_bytes_gb_per_s"] = (
            moved / (trace["device_busy_ms_per_step"] * 1e-3) / 1e9)
    if z_compact is not None:
        line["z_compact"] = z_compact
    line["ok"] = finite and all(e <= F64_TOLERANCE for e in errors.values())
    return line


# -- the nonhydrostatic pressure solve ----------------------------------------

def _laplacian_ppb(p, spacing):
    """Second-difference Laplacian, periodic in x and y, Neumann in z: the
    operator whose eigenvalues FFTPoissonSolver divides by."""
    lap = sum((np.roll(p, -1, ax) - 2 * p + np.roll(p, 1, ax)) / spacing ** 2
              for ax in (0, 1))
    q = np.concatenate([p[:, :, :1], p, p[:, :, -1:]], axis=2)
    return lap + (q[:, :, 2:] - 2 * p + q[:, :, :-2]) / spacing ** 2


def _best_ms(fn, x, reps=20):
    jax.block_until_ready(fn(x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def poisson_check(n):
    """Residual ‖∇²p − b‖/‖b‖ of the float32 solve on the nh phase's grid,
    and the times of the two DCT paths along z of an n³ array."""
    with jax.enable_x64(False):
        grid = RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                               topology=("periodic", "periodic", "bounded"),
                               dtype=jnp.float32)
        b = _rng().standard_normal((n, n, n))
        b -= b.mean()
        solve = jax.jit(FFTPoissonSolver(grid).solve)
        p = np.asarray(solve(jnp.asarray(b, jnp.float32)), np.float64)
        residual = (np.linalg.norm(_laplacian_ppb(p, 1.0 / n) - b)
                    / np.linalg.norm(b))
        x = jnp.asarray(b, jnp.float32)
        paths = {"matmul_dct": jax.jit(lambda a: dct_forward(a, 2)),
                 "matmul_idct": jax.jit(lambda a: dct_inverse(a, 2)),
                 "fft_dct": jax.jit(lambda a: dct_forward_fft(a, 2)),
                 "fft_idct": jax.jit(lambda a: dct_inverse_fft(a, 2))}
        ms = {k + "_ms": _best_ms(f, x) for k, f in paths.items()}
        agree = float(jnp.max(jnp.abs(paths["matmul_dct"](x)
                                      - paths["fft_dct"](x)))
                      / jnp.max(jnp.abs(paths["fft_dct"](x))))
    return {"poisson_residual": float(residual), "dct_n": n, **ms,
            "dct_paths_max_rel_diff": agree,
            "ok": residual <= POISSON_TOLERANCE and agree <= POISSON_TOLERANCE}


# -- the sharded path (four devices) ------------------------------------------

def _placement(tree):
    """Device ids and per-device block shape of each 3D state array."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): {
                "devices": sorted(d.id for d in v.sharding.device_set),
                "shard_shape": list(v.sharding.shard_shape(v.shape)),
                "replicated": v.sharding.is_fully_replicated}
            for k, v in flat if getattr(v, "ndim", 0) == 3}


def _spread(placement, n):
    return all(len(p["devices"]) == n and not p["replicated"]
               for p in placement.values())


def run_sharded(devices, nh_n=256, hydro_size=(512, 256, 32), poisson_n=256,
                steps=3, card=None):
    """The nh model under Distributed(Partition(2, 2)) and the hydrostatic
    model sharded over (x, y) against the same models on one device, and
    DistributedFFTPoissonSolver against FFTPoissonSolver; returns one line
    per comparison."""
    arch = Distributed(Partition(2, 2), devices=devices)
    lines = []
    with jax.enable_x64(False):
        for name, build, size, dt, names in (
                ("nh", build_nh, nh_n, 1e-4, ("u", "v", "w")),
                ("hydro", build_hydro, hydro_size, 120.0,
                 ("u", "v", "T", "eta"))):
            serial, sharded = build(size, jnp.float32), build(size,
                                                              jnp.float32)
            arch.validate_grid(sharded.grid)
            sharded.state = arch.shard(sharded.state)
            ms = {}
            for label, m in (("serial", serial), ("sharded", sharded)):
                # two warm-up steps: a sharded step's outputs come back with
                # other shardings than the placed inputs, so the second
                # call compiles again
                _advance(m, dt, 2)
                jax.block_until_ready(m.state)
                t0 = time.perf_counter()
                _advance(m, dt, steps)
                jax.block_until_ready(m.state)
                ms[label] = (time.perf_counter() - t0) * 1e3 / steps
            read = {k: _interior(serial.grid, serial.state["fields"][k])
                    for k in names}
            errors = relative_errors(
                {k: _interior(sharded.grid, sharded.state["fields"][k])
                 for k in names}, read)
            placement = _placement(sharded.state)
            # the prognostics must be split over every device; XLA may
            # choose to replicate a diagnosed array (the hydrostatic w)
            spread = _spread(_placement({k: sharded.state["fields"][k]
                                         for k in names}), len(devices))
            finite = all(bool(np.isfinite(q).all()) for q in read.values())
            lines.append({
                "phase": f"sharded_{name}", "card": card, "size": size,
                "steps": 2 + steps, "ms_per_step": ms,
                "rel_err_sharded_vs_serial": errors,
                "tolerance": SHARDED_TOLERANCE,
                "device_sets": placement,
                "bytes_in_use": [_memory_stat(d, "bytes_in_use")
                                 for d in devices],
                "ok": spread and finite and all(
                    e <= SHARDED_TOLERANCE for e in errors.values())})
            del serial, sharded

        grid = RectilinearGrid(size=(poisson_n,) * 3, extent=(1.0, 1.0, 1.0),
                               topology=("periodic", "periodic", "bounded"),
                               dtype=jnp.float32)
        b = _rng().standard_normal(grid.N)
        b = jnp.asarray(b - b.mean(), jnp.float32)
        mesh = jax.sharding.Mesh(np.asarray(devices), ("x",))
        serial = np.asarray(jax.jit(FFTPoissonSolver(grid).solve)(b))
        pencil = DistributedFFTPoissonSolver(grid, mesh).solve(b)
        placement = _placement({"p": pencil})
        err = relative_errors({"p": np.asarray(pencil)}, {"p": serial})
        lines.append({
            "phase": "sharded_poisson", "card": card, "size": poisson_n,
            "rel_err_sharded_vs_serial": err,
            "tolerance": SHARDED_TOLERANCE, "device_sets": placement,
            "bytes_in_use": [_memory_stat(d, "bytes_in_use")
                             for d in devices],
            "ok": (_spread(placement, len(devices))
                   and err["p"] <= SHARDED_TOLERANCE)})
    return lines


# -- entry point --------------------------------------------------------------

def query_card():
    """``name, power.limit`` of each card, as nvidia-smi prints them. A
    plain subprocess: it does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def _one_card(card):
    """Each phase's line, as it completes; the nh line carries the Poisson
    check."""
    for phase in PHASES.values():
        line = run_phase(phase, card=card)
        if phase.name == "nh":
            line["poisson"] = poisson_check(phase.size)
            line["ok"] = line["ok"] and line["poisson"]["ok"]
        yield line


def final_line(devices):
    d = devices[0]
    return {"ok": True, "device": {"platform": d.platform,
                                   "kind": d.device_kind,
                                   "count": len(devices)}}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1,
                        help="4: run only the sharded path on four cards")
    args = parser.parse_args(argv)

    card = query_card()
    print(card, flush=True)
    configure_compilation_cache()
    devices = require_gpu()
    if len(devices) != args.chips:
        raise RuntimeError(f"--chips {args.chips} but JAX sees "
                           f"{len(devices)} GPU(s)")
    print(json.dumps({"xla_flags": os.environ.get("XLA_FLAGS", ""),
                      "jax": jax.__version__, "card": card}), flush=True)

    lines = (run_sharded(devices, card=card) if args.chips == 4
             else _one_card(card))
    failed = []
    for line in lines:
        print(json.dumps(line), flush=True)
        if not line["ok"]:
            failed.append(line["phase"])
    if failed:
        print(f"failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps(final_line(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
