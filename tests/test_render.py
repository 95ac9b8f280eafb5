"""Granular renderer parity: plan+gather engine vs the literal process() oracle."""

import numpy as np
import pytest

import oracle
from melonix_tpu.engine import grains as G
from melonix_tpu.engine.maps import MapKnots
from melonix_tpu.engine.render import build_render_plan, render, render_track
from melonix_tpu.markers import Marker


def setup(chirp, markers):
    x, sr = chirp
    table = G.build_grain_table(x, backend="numpy")
    knots = MapKnots.from_markers(markers, sr, len(x))
    return x, sr, table, knots


MARKER_CASES = [
    [],
    [Marker(4000, 60.0, 0.0, 2.0)],  # pitch up 2 semitones at 0.5 s
    [Marker(4000, 60.0, 0.3, -3.0)],  # slow down + pitch down
    [Marker(2000, 60.0, 0.1, 1.0), Marker(8000, 62.0, -0.05, -1.0)],
    [Marker(3000, 60.0, 0.0, 12.0)],  # octave up
]


@pytest.mark.parametrize("markers", MARKER_CASES)
def test_export_parity(chirp, markers):
    x, sr, table, knots = setup(chirp, markers)
    tup = [(m.sample, m.note, m.d_time, m.pitch_bend) for m in markers]
    grains = list(zip(table.starts.tolist(), table.lengths.tolist()))

    want = oracle.export(x, grains, tup, sr)
    got = render_track(x, table, knots)

    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_export_no_grains():
    """Empty grain table → first process() call emits 1500 zeros and stops."""
    x = np.zeros(3000, np.float32)  # all zeros → wav[idx-j] < 0 never true
    table = G.build_grain_table(x, backend="numpy")
    assert len(table) == 0
    knots = MapKnots.from_markers([], 8000, len(x))
    out = render_track(x, table, knots)
    assert out.shape == (1500,)
    assert np.all(out == 0)


def test_plan_streaming_chunk(chirp):
    """min_out-limited plan matches the prefix of the full plan."""
    x, sr, table, knots = setup(chirp, [Marker(4000, 60.0, 0.0, 2.0)])
    full = build_render_plan(table, knots)
    part = build_render_plan(table, knots, min_out=4000)
    assert part.total_out >= 4000
    n = part.n_steps
    np.testing.assert_array_equal(part.grain_start, full.grain_start[:n])
    np.testing.assert_array_equal(part.sz, full.sz[:n])

    out_full = render(x, full)
    out_part = render(x, part, include_tail=False)
    np.testing.assert_allclose(out_part, out_full[: part.total_out], atol=2e-6)


def test_plan_from_cursor(chirp):
    """Plans can start mid-track (playback parity, app.cpp:274-276)."""
    x, sr, table, knots = setup(chirp, [])
    plan = build_render_plan(table, knots, start_cursor=0.5, min_out=2000)
    assert plan.n_steps > 0
    # First grain chosen by lower_bound(time2Sample(0.5))
    s = knots.time_to_sample(0.5)
    gi = int(np.searchsorted(table.starts, s))
    assert plan.grain_start[0] == table.starts[gi]


def test_identity_render_reproduces_source(chirp):
    """With no markers the render replays the source grains verbatim
    (rate=1 resampling is the identity; seams line up by construction)."""
    x, sr, table, knots = setup(chirp, [])
    out = render_track(x, table, knots)
    end = int(table.starts[-1] + table.lengths[-1])
    np.testing.assert_allclose(out[:end], x[:end], atol=1e-6)


@pytest.mark.parametrize("bend", [24.0, -24.0, 0.5])
def test_render_device_extreme_bends_match_oracle(bend):
    """Two-octave bends (the edit model's range) and a sub-semitone one,
    held on a plateau: the device render vs the literal process() oracle."""
    sr = 8000
    t = np.arange(int(sr * 0.5)) / sr
    x = (0.5 * np.sin(2 * np.pi * 210.0 * t)).astype(np.float32)
    n = len(x)
    markers = [Marker(n // 8, 57.0, 0.0, bend), Marker(7 * n // 8, 57.0, 0.0, bend)]
    table = G.build_grain_table(x, backend="numpy")
    knots = MapKnots.from_markers(markers, sr, n)
    tup = [(m.sample, m.note, m.d_time, m.pitch_bend) for m in markers]
    grains = list(zip(table.starts.tolist(), table.lengths.tolist()))
    want = oracle.export(x, grains, tup, sr)
    got = render_track(x, table, knots)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_render_device_hour_length_plan():
    """An hour-long plan at a reduced rate: 18M output samples, past the
    2^24 where float32 sample positions stop being exact — the device's
    int32 segmented broadcasts must still land every step on its grain
    (vs the float32 per-step plan evaluation)."""
    sr = 5000
    n = 3600 * sr
    period = 23  # 217.4 Hz; int arithmetic keeps the fixture exact
    x = (0.4 * np.sin(2 * np.pi * (np.arange(n) % period) / period)).astype(np.float32)
    markers = [Marker(int(i * n / 7), 57.0, 0.002 * (-1) ** i, 1.5 * (-1) ** i)
               for i in range(1, 7)]
    table = G.build_grain_table(x)
    knots = MapKnots.from_markers(markers, sr, n)
    plan = build_render_plan(table, knots)
    assert int(plan.out_offset[-1]) > 1 << 24
    got = render(x, plan, include_tail=False)
    want = oracle.render_plan_f32(x, plan)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
