"""Output writers.

Reference semantics: src/OutputWriters/ — `JLD2Writer` (jld2_writer.jl:9,142:
serialize fields or arbitrary functions-of-model on a schedule, with file
splitting), `WindowedTimeAverage` (windowed_time_average.jl:15,151), and
`output_writer_utils.jl` (fetch_output).

Python-native format: instead of JLD2 (a Julia/HDF5 container), a
`FieldDataset` directory with one ``.npy`` per (output, iteration) plus a
``series.json`` index — append-only, dependency-free, and readable by the
OutputReaders.FieldTimeSeries analogue. NetCDF output is provided when a
netCDF library is importable (the reference likewise splits NetCDF into an
extension, ext/OceananigansNCDatasetsExt.jl)."""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.schedules import IterationInterval, TimeInterval


def fetch_output(output, model):
    """Materialize one output: a Field, a callable(model), a state array name,
    or a jnp array (reference: OutputWriters/fetch_output.jl:43)."""
    if callable(output) and not hasattr(output, "interior"):
        output = output(model)
    if hasattr(output, "interior"):
        return np.asarray(output.interior)
    return np.asarray(output)


class FieldWriter:
    """Append-only field snapshot writer (the JLD2Writer analogue).

    outputs: dict name → Field / callable(model) / prognostic name."""

    def __init__(self, model, outputs, path, schedule=None, overwrite=True,
                 with_halos=False, indices=None):
        """``indices``: windowed output view (reference: the Field
        ``indices`` kwarg of the JLD2/NetCDF writers, e.g.
        ``indices=(slice(None), slice(None), -1)`` for a surface slice) —
        a 3-tuple of slices/ints applied to each output's interior."""
        self.model = model
        self.outputs = dict(outputs)
        self.path = path
        self.schedule = schedule or IterationInterval(1)
        self._wta = None
        if isinstance(self.schedule, AveragedTimeInterval):
            self._wta = {
                name: WindowedTimeAverage(
                    (lambda m, s=spec: fetch_output(self._resolve(s), m)),
                    self.schedule.interval, self.schedule.window,
                    self.schedule.stride)
                for name, spec in self.outputs.items()}
        self.with_halos = with_halos
        self.indices = tuple(indices) if indices is not None else None
        os.makedirs(path, exist_ok=True)
        self.index_file = os.path.join(path, "series.json")
        if overwrite or not os.path.exists(self.index_file):
            self.index = {"times": [], "iterations": [],
                          "outputs": list(self.outputs)}
            self._grid_metadata()
        else:
            self.index = json.load(open(self.index_file))

    def _grid_metadata(self):
        g = self.model.grid
        meta = dict(size=list(g.N), halo=list(g.H),
                    topology=list(getattr(g, "topology", ())),
                    extent=[float(e) for e in getattr(g, "extent", ())])
        with open(os.path.join(self.path, "grid.json"), "w") as f:
            json.dump(meta, f)

    def _resolve(self, spec):
        if isinstance(spec, str):
            return self.model.field(spec)
        return spec

    def _write_arrays(self, model, arrays):
        it = model.iteration
        wrote = False
        for name, arr in arrays.items():
            if arr is None:
                continue
            if self.indices is not None and arr.ndim >= 3:
                arr = arr[self.indices]
            np.save(os.path.join(self.path, f"{name}_{it}.npy"), arr)
            wrote = True
        if wrote:
            self.index["times"].append(model.time)
            self.index["iterations"].append(it)
            with open(self.index_file, "w") as f:
                json.dump(self.index, f)

    def write(self, sim):
        model = sim.model
        self._write_arrays(model, {
            name: fetch_output(self._resolve(spec), model)
            for name, spec in self.outputs.items()})

    def maybe_write(self, sim, force=False):
        if self._wta is not None:
            for w in self._wta.values():
                w.collect(sim.model)
            if self.schedule(sim.model):
                self._write_arrays(sim.model, {name: w.result()
                                               for name, w in
                                               self._wta.items()})
            elif force:
                # forced (e.g. iteration-0) output of an averaging writer is
                # instantaneous — it must NOT consume or desync the windows
                self.write(sim)
            return
        if force or self.schedule(sim.model):
            self.write(sim)


class AveragedTimeInterval(TimeInterval):
    """TimeInterval whose outputs are windowed time averages (reference:
    windowed_time_average.jl AveragedTimeInterval): pass as a writer
    ``schedule=`` and the writer wraps every output in a
    :class:`WindowedTimeAverage` over ``window`` before each actuation."""

    def __init__(self, interval, window=None, stride=1):
        from ..utils.dateclock import interval_seconds
        super().__init__(interval)
        self.window = (self.interval if window is None
                       else interval_seconds(window))
        self.stride = int(stride)


class WindowedTimeAverage:
    """On-line time average of an output between actuations (reference:
    windowed_time_average.jl — AveragedTimeInterval semantics: average over
    ``window`` preceding each output)."""

    def __init__(self, output, interval, window=None, stride=1):
        self.output = output
        self.interval = float(interval)
        self.window = float(window if window is not None else interval)
        self.stride = int(stride)
        self._accum = None
        self._wsum = 0.0
        self._calls = 0
        self._last_t = None
        self._next_output = None

    def collect(self, model):
        t = model.time
        if self._next_output is None:
            self._next_output = t + self.interval
        # re-anchor after missed/forced actuations so windows stay aligned
        # to the schedule grid (reference: windowed_time_average.jl)
        while t > self._next_output + 1e-9 * self.interval:
            self._next_output += self.interval
        window_start = self._next_output - self.window
        if t >= window_start - 1e-9 * self.interval:
            self._calls += 1
            if (self._calls - 1) % self.stride:
                return          # sample every stride-th collection
            # trapezoid-free left-Riemann dt weighting: each sample is
            # weighted by the time elapsed since the previous one inside
            # the window (the reference integrates with Δt weights,
            # windowed_time_average.jl advance_time_average! — an
            # unweighted sample mean biased toward small-Δt intervals
            # under a TimeStepWizard; round-5 review finding)
            if self._last_t is None or self._last_t < window_start:
                w = max(t - window_start, 0.0)
            else:
                w = t - self._last_t
            self._last_t = t
            if w <= 0.0:
                # the forced t=window_start sample anchors the window but
                # carries no weight
                if self._accum is None:
                    val = fetch_output(self.output, model)
                    self._accum = np.zeros_like(val)
                return
            val = fetch_output(self.output, model)
            if self._accum is None:
                self._accum = np.zeros_like(val)
            self._accum = self._accum + w * val
            self._wsum += w

    def result(self):
        if not self._wsum:
            return None
        out = self._accum / self._wsum
        self._accum = None
        self._wsum = 0.0
        self._calls = 0
        self._last_t = None
        self._next_output += self.interval
        return out


# The real NetCDF writer (NetCDF-3 classic via scipy, reference:
# ext/OceananigansNCDatasetsExt.jl) lives in .netcdf_writer; re-export it so
# there is exactly ONE NetCDFWriter symbol in the package.
from .netcdf_writer import NetCDFWriter  # noqa: E402,F401
