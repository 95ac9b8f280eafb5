"""The official metric's trace parser (bench.py) — the headline number is
a sum of jit_* complete-event durations; a parser regression would
silently misreport performance, so pin its arithmetic here."""

import gzip
import json
import os


def test_device_ms_parser(tmp_path):
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    with gzip.open(os.path.join(tmp_path, "t.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "name": "jit_foo(1)", "dur": 2000},
            {"ph": "X", "name": "jit_foo(1)", "dur": 2000},
            {"ph": "X", "name": "jit_bar(2)", "dur": 1000},
            {"ph": "X", "name": "fusion.1", "dur": 500},  # op-level: excluded
            {"ph": "M", "name": "jit_meta(9)"},           # no dur: excluded
        ]}, f)
    per = bench._device_ms_by_program(str(tmp_path), 2)
    assert per == {"jit_foo(1)": 2.0, "jit_bar(2)": 0.5}
    assert abs(bench._device_ms_per_iter(str(tmp_path), 2) - 2.5) < 1e-12
    assert bench._device_ms_per_iter(str(tmp_path) + "/nope", 1) is None


def test_probe_service_answers_on_cpu(monkeypatch):
    """The device probe: forced onto the CPU backend (the suite never uses
    an accelerator) the subprocess jit answers within one attempt."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    monkeypatch.setenv("MELONIX_PROBE_PLATFORM", "cpu")
    assert bench._probe_service(deadline_s=240.0, attempt_timeout_s=240.0)


def test_probe_service_fails_closed(monkeypatch):
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    def boom(*a, **k):
        raise subprocess.TimeoutExpired(cmd="x", timeout=0.01)

    monkeypatch.setattr(bench.subprocess, "run", boom)
    assert not bench._probe_service(deadline_s=0.0)


def test_live_pv_sustained_cpu():
    """The sustained-live artifact runs on any backend: a short CPU pass
    must report the three fields with sane values (x_realtime > 0; the
    underrun counter only counts pulls completing after their audio-clock
    deadline)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    out = bench._live_pv_sustained(seconds=1.5)
    assert set(out) == {"live_pv_underruns", "live_pv_x_realtime",
                        "live_pv_worst_lag_ms"}
    assert out["live_pv_x_realtime"] > 0
    assert out["live_pv_underruns"] >= 0
