"""chip_smoke.py at tiny sizes on the CPU: each phase against its float64
run, the sharded path on four virtual devices, the trace reduction and the
script's last line. The times it prints here are CPU times and mean
nothing; the checks are what the GPU run repeats at full width."""

import json

import jax
import pytest

import chip_smoke

SIZES = {"nh": 16, "hydro": (32, 16, 4), "cs": (8, 4), "sw": 32}


@pytest.mark.parametrize("name", list(SIZES))
def test_phase_matches_float64(name):
    phase = chip_smoke.PHASES[name]
    line = chip_smoke.run_phase(phase, size=SIZES[name], steps=2,
                                trace_steps=0)
    assert line["finite"] and line["ok"], line
    assert set(line["rel_err_vs_f64"]) == set(phase.names)
    # the CPU bound the float64 tolerance was set from
    assert max(line["rel_err_vs_f64"].values()) < 1e-5
    assert line["memory_analysis"]["argument_size_in_bytes"] > 0
    assert line["min_bytes_per_step"] > 0
    assert line["steps"] == 3


def test_sharded_path_on_four_devices():
    devices = jax.devices()[:4]
    lines = chip_smoke.run_sharded(devices, nh_n=10, hydro_size=(32, 16, 4),
                                   poisson_n=8, steps=1)
    assert [ln["phase"] for ln in lines] == [
        "sharded_nh", "sharded_hydro", "sharded_poisson"]
    for line in lines:
        assert line["ok"], line
        for key, placed in line["device_sets"].items():
            assert placed["devices"] == [d.id for d in devices]
            if "fields" in key or key == "['p']":
                assert not placed["replicated"], key


def test_poisson_residual_and_dct_paths():
    out = chip_smoke.poisson_check(16)
    assert out["poisson_residual"] < 1e-5
    assert out["dct_paths_max_rel_diff"] < 1e-5


def test_busy_time_is_the_union_of_intervals():
    assert chip_smoke.busy_ns([(20, 30), (0, 10), (5, 15), (12, 14)]) == 25
    assert chip_smoke.busy_ns([]) == 0


def test_last_line_keys():
    line = json.loads(json.dumps(chip_smoke.final_line(jax.devices()[:1])))
    assert line == {"ok": True,
                    "device": {"platform": "cpu", "kind": "cpu", "count": 1}}


def test_main_refuses_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "query_card", lambda: "no card")
    with pytest.raises(RuntimeError, match="'cpu'"):
        chip_smoke.main([])
    assert '"ok": true' not in capsys.readouterr().out
