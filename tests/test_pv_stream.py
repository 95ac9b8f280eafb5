"""Streaming PV engine (engine/pv_stream.py) vs the offline render.

The stream IS the chunked offline pipeline behind a pull API, so a stream
from t=0 must match ``render_track_pv`` under the PV comparison convention
(rms-relative, never waveform-tight: phase propagation is chaotic at the
ulp level — see test_chunked_stretch_matches_single_shot).  Mid-track
restarts re-anchor phase, so those compare rms + dominant frequency.
"""

import numpy as np
import pytest

from melonix_tpu.engine.maps import MapKnots
from melonix_tpu.engine.phase_vocoder import render_track_pv
from melonix_tpu.engine.pv_stream import PvStream
from melonix_tpu.markers import Marker

SR = 8000


def _sine(f, secs):
    t = np.arange(int(SR * secs)) / SR
    return (0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _knots(n, markers):
    return MapKnots.from_markers(markers, SR, n)


@pytest.fixture(scope="module")
def bent_track():
    x = _sine(330.0, 4.0)
    n = len(x)
    markers = [
        Marker(sample=n // 3, note=52.0, d_time=0.08, pitch_bend=4.0),
        Marker(sample=2 * n // 3, note=52.0, d_time=-0.03, pitch_bend=-2.0),
    ]
    return x, _knots(n, markers)


def _read_all(stream, quantum):
    chunks = []
    while not stream.exhausted:
        chunks.append(stream.read(quantum))
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def test_stream_from_zero_matches_offline(bent_track):
    x, knots = bent_track
    offline = render_track_pv(x, knots)
    stream = PvStream(x, knots, chunk_frames=96)  # force many chunks
    got = _read_all(stream, 1000)[: len(offline)]
    assert len(got) == len(offline)
    err = np.sqrt(np.mean((offline - got) ** 2)) / (
        np.sqrt(np.mean(offline**2)) + 1e-12
    )
    assert err < 2e-3, err


def test_read_granularity_invariant(bent_track):
    x, knots = bent_track
    a = _read_all(PvStream(x, knots, chunk_frames=128), 977)
    b = _read_all(PvStream(x, knots, chunk_frames=128), 4096)
    m = min(len(a), len(b))
    np.testing.assert_array_equal(a[:m], b[:m])
    # Past-the-end reads are silent zeros.
    s = PvStream(x, knots)
    _ = _read_all(s, 2048)
    assert np.all(s.read(512) == 0.0)


def test_stream_length_matches_warped_duration(bent_track):
    x, knots = bent_track
    s = PvStream(x, knots)
    got = _read_all(s, 2048)
    assert s.n_out == int(knots.duration() * SR)
    # Reads always return full buffers: real samples through n_out, zeros
    # after (the audio callback contract), so only the tail pad exceeds it.
    assert len(got) - s.n_out < 2048
    assert np.all(got[s.n_out :] == 0.0)
    assert np.any(got[: s.n_out] != 0.0)


def test_midtrack_restart_spectrally_consistent(bent_track):
    """A stream restarted at t0 (the edit/seek path) must produce the same
    *signal content* as the offline render from t0 on: equal rms and equal
    dominant frequency per half-second window (phase re-anchors, so the
    waveform itself may differ by a per-partial constant phase)."""
    x, knots = bent_track
    offline = render_track_pv(x, knots)
    t0 = 1.3
    j0 = round(t0 * SR)
    s = PvStream(x, knots, start_sec=t0, chunk_frames=256)
    got = _read_all(s, 2048)
    ref = offline[j0 : j0 + len(got)]
    got = got[: len(ref)]
    win = SR // 2
    skip = 2048  # the splice's OLA fade-in window
    for w0 in range(skip, len(ref) - win, win):
        a, b = ref[w0 : w0 + win], got[w0 : w0 + win]
        rms_a, rms_b = np.sqrt(np.mean(a**2)), np.sqrt(np.mean(b**2))
        assert abs(rms_a - rms_b) < 0.05 * (rms_a + 1e-9), (w0, rms_a, rms_b)
        fa = np.argmax(np.abs(np.fft.rfft(a * np.hanning(win))))
        fb = np.argmax(np.abs(np.fft.rfft(b * np.hanning(win))))
        assert abs(int(fa) - int(fb)) <= 1, (w0, fa, fb)


def test_empty_and_degenerate_tracks():
    knots = _knots(100, [])
    s = PvStream(np.zeros(100, np.float32), knots)  # shorter than one frame
    assert s.read(64).shape == (64,)
    assert s.exhausted


def test_tail_read_near_bucket_boundary(monkeypatch):
    """Seek into the final odd resample block of a track whose padded
    curve length sits within one quantum of the OUT_BUCKET boundary.
    Regression: the batched read's quantum cap could floor to zero there,
    and jax.lax.dynamic_slice clamps silently — the tail buffer then came
    from a window ~BLK samples earlier (review round 3).  OUT_BUCKET is
    shrunk so the boundary is reachable with a sub-second track."""
    from melonix_tpu.engine import pv_stream as ps

    monkeypatch.setattr(ps, "OUT_BUCKET", 1 << 14)
    from melonix_tpu.engine.phase_vocoder import BLK as blk

    q = ps.READ_BLOCKS * blk
    # n_out_pad = 8192-bucketed n_out; park it within one quantum below
    # the (shrunk) OUT_BUCKET so the pre-fix cap would hit zero.
    n_out_target = (1 << 14) - q // 2
    x = _sine(330.0, (n_out_target - 4096) / SR)
    knots = _knots(len(x), [])
    ref = render_track_pv(x, knots)

    st = ps.PvStream(x, knots)
    assert st._n_out_pad_b >= st.plan.n_out_pad + q  # slack present
    # Seek to an ODD block near the end, then drain.
    j_seek = (st.n_out // blk - 1) * blk + 7
    if (j_seek // blk) % 2 == 0:
        j_seek -= blk
    st2 = ps.PvStream(x, knots, start_sec=j_seek / SR)
    got = _read_all(st2, 1024)
    want = ref[j_seek:]
    m = min(len(got), len(want))
    assert m > 0
    err = np.sqrt(np.mean((got[:m] - want[:m]) ** 2))
    assert err < 5e-3 * max(np.abs(want).max(), 1e-6), err


def test_formant_stream_matches_offline(bent_track):
    """preserve_formants through the pull API == the offline formant
    render (rms convention) — the streaming advance threads the flag into
    the same _stretch_chunk the offline chunk loop uses."""
    x, knots = bent_track
    ref = render_track_pv(x, knots, preserve_formants=True)
    st = PvStream(x, knots, preserve_formants=True)
    got = _read_all(st, 4096)
    m = min(len(got), len(ref))
    err = np.sqrt(np.mean((got[:m] - ref[:m]) ** 2))
    assert err < 5e-3 * np.abs(ref).max(), err


def test_locked_stream_matches_offline(bent_track):
    """phase_locking through the pull API == the offline locked render
    (rms convention) — the streaming advance threads the flag into the
    same _stretch_chunk the offline chunk loop uses."""
    x, knots = bent_track
    ref = render_track_pv(x, knots, phase_locking=True)
    st = PvStream(x, knots, phase_locking=True)
    got = _read_all(st, 4096)
    m = min(len(got), len(ref))
    err = np.sqrt(np.mean((got[:m] - ref[:m]) ** 2))
    assert err < 5e-3 * np.abs(ref).max(), err


def test_tiny_chunk_tail_fully_normalized():
    """chunk_frames so small that ch*hop < size - hop: the final chunk's
    fused tail=True read can normalize only ONE extra span, which cannot
    cover the whole (size - hop) OLA overhang.  Regression: _post_chunk
    then marked the rest finalized without normalizing it, so track-end
    reads served raw (window-sum-scaled) samples.

    Geometry matters twice.  (1) n_frames rounds up to 64 (build_pv_plan)
    and the emit gate only stretches frames the output needs, so the final
    planned chunk is reached only when the REAL frame count lands on the
    rounding boundary: an identity track of exactly (64-2)*hop samples
    gives ceil(p_total*sr/hop)+2 == 64 == n_frames, and with
    chunk_frames=2 the last needed chunk starts at frame 62.  (2) The +2
    frame padding makes the last TWO frames always silent (source clamps
    past the track end), so with the default size/hop == 4 only silent
    frames touch the samples one extra span can't cover — the defect
    needs size/hop > 4 for real content to land there (size=4096:
    frames 59-61 write past (n_frames+2)*hop)."""
    n = 62 * 512  # exactly (n_frames - 2) * hop at the 64-frame boundary
    t = np.arange(n) / SR
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    knots = _knots(n, [])
    s = PvStream(x, knots, chunk_frames=2, size=4096, hop=512)
    plan = s.plan
    assert s._ch * plan.hop < plan.size - plan.hop  # the risky geometry
    _ = _read_all(s, 4096)
    assert s._frames_done >= plan.n_frames, s._frames_done
    assert s._fin == plan.stretch_len
    # The finalized invariant: y_norm == y / wsum over everything marked
    # finalized (bit-deterministic — same program wrote both buffers).
    y = np.asarray(s._y[: plan.stretch_len])
    yn = np.asarray(s._y_norm[: plan.stretch_len])
    ws = np.asarray(s._wsum_pad[: plan.stretch_len])
    np.testing.assert_allclose(yn, y / ws, rtol=1e-5, atol=1e-6)
