"""Phase-vocoder renderer: pitch accuracy, warp length, energy sanity."""

import numpy as np
import pytest

from melonix_tpu.engine.maps import MapKnots
from melonix_tpu.engine.phase_vocoder import render_track_pv, rate_integral_total
from melonix_tpu.markers import Marker

SR = 8000


def _sine(freq, seconds, sr=SR):
    t = np.arange(int(sr * seconds)) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _peak_freq(x, sr=SR):
    w = np.hanning(len(x))
    spec = np.abs(np.fft.rfft(x * w))
    return np.argmax(spec) * sr / len(x)


def test_identity_no_markers():
    x = _sine(440.0, 2.0)
    knots = MapKnots.from_markers([], SR, len(x))
    y = render_track_pv(x, knots)
    assert abs(len(y) - len(x)) <= SR // 1000 + 1
    mid = y[len(y) // 4 : 3 * len(y) // 4]
    assert abs(_peak_freq(mid) - 440.0) < 5.0
    # energy within 2 dB
    rms_in = np.sqrt(np.mean(x**2))
    rms_out = np.sqrt(np.mean(mid**2))
    assert abs(20 * np.log10(rms_out / rms_in)) < 2.0


def test_constant_octave_shift():
    x = _sine(440.0, 2.0)
    n = len(x)
    markers = [
        Marker(sample=n // 4, note=57.0, d_time=0.0, pitch_bend=12.0),
        Marker(sample=3 * n // 4, note=57.0, d_time=0.0, pitch_bend=12.0),
    ]
    knots = MapKnots.from_markers(markers, SR, n)
    y = render_track_pv(x, knots)
    # between the markers the bend is exactly +12 → frequency doubles
    seg = y[int(0.35 * n) : int(0.6 * n)]
    assert abs(_peak_freq(seg) - 880.0) < 10.0
    # duration unchanged (no d_time)
    assert abs(len(y) - n) <= SR // 1000 + 1


def test_time_stretch_only():
    x = _sine(330.0, 2.0)
    n = len(x)
    markers = [Marker(sample=n // 2, note=52.0, d_time=0.5, pitch_bend=0.0)]
    knots = MapKnots.from_markers(markers, SR, n)
    y = render_track_pv(x, knots)
    want = knots.duration() * SR
    assert abs(len(y) - want) <= 2
    # pitch unchanged in both halves despite the stretch
    a = y[int(0.1 * len(y)) : int(0.3 * len(y))]
    b = y[int(0.7 * len(y)) : int(0.9 * len(y))]
    assert abs(_peak_freq(a) - 330.0) < 5.0
    assert abs(_peak_freq(b) - 330.0) < 5.0


def test_rate_integral_matches_numeric():
    x_len = 2 * SR
    markers = [
        Marker(sample=SR // 2, note=57.0, d_time=0.1, pitch_bend=4.0),
        Marker(sample=SR, note=57.0, d_time=-0.05, pitch_bend=-3.0),
    ]
    knots = MapKnots.from_markers(markers, SR, x_len)
    t_end = knots.duration()
    tt = np.linspace(1e-6, t_end, 200001)
    rho = 2.0 ** (knots.time_to_pitch_bend(tt) / 12.0)
    numeric = np.trapezoid(rho, tt)
    analytic = rate_integral_total(knots, t_end)
    assert abs(analytic - numeric) / numeric < 1e-3


def test_short_input_and_empty():
    knots = MapKnots.from_markers([], SR, 100)
    y = render_track_pv(np.zeros(100, np.float32), knots)
    assert (y == 0).all()


def test_device_out_matches_host_download(monkeypatch):
    """device_out=True returns the identical render as a device array (the
    hour-scale path keeps the 635 MB result resident instead of paying the
    device->host download); forcing chunking exercises the packed-plan
    upload both ways."""
    import jax

    import melonix_tpu.engine.phase_vocoder as pv

    x = _sine(330.0, 3.0)
    n = len(x)
    markers = [Marker(sample=n // 2, note=52.0, d_time=0.05, pitch_bend=4.0)]
    knots = MapKnots.from_markers(markers, SR, n)
    monkeypatch.setattr(pv, "PV_CHUNK_FRAMES", 64)
    host = render_track_pv(x, knots)
    dev = render_track_pv(x, knots, device_out=True)
    assert isinstance(dev, jax.Array)
    np.testing.assert_array_equal(host, np.asarray(dev))


def test_chunked_stretch_matches_single_shot(monkeypatch):
    """Hour-scale chunking (exact phase carry + linear OLA) must agree with
    the one-shot stretch."""
    import melonix_tpu.engine.phase_vocoder as pv

    x = _sine(330.0, 6.0)
    n = len(x)
    markers = [
        Marker(sample=n // 3, note=52.0, d_time=0.1, pitch_bend=5.0),
        Marker(sample=2 * n // 3, note=52.0, d_time=-0.05, pitch_bend=-3.0),
    ]
    knots = MapKnots.from_markers(markers, SR, n)
    single = render_track_pv(x, knots)
    monkeypatch.setattr(pv, "PV_CHUNK_FRAMES", 64)  # force many chunks
    chunked = render_track_pv(x, knots)
    assert len(single) == len(chunked)
    err = np.sqrt(np.mean((single - chunked) ** 2)) / (
        np.sqrt(np.mean(single**2)) + 1e-12
    )
    assert err < 2e-3, err


def test_chunked_stretch_formant(monkeypatch):
    import melonix_tpu.engine.phase_vocoder as pv

    x = _sine(220.0, 4.0)
    n = len(x)
    markers = [Marker(sample=n // 2, note=48.0, d_time=0.0, pitch_bend=7.0)]
    knots = MapKnots.from_markers(markers, SR, n)
    single = render_track_pv(x, knots, preserve_formants=True)
    monkeypatch.setattr(pv, "PV_CHUNK_FRAMES", 48)
    chunked = render_track_pv(x, knots, preserve_formants=True)
    err = np.sqrt(np.mean((single - chunked) ** 2)) / (
        np.sqrt(np.mean(single**2)) + 1e-12
    )
    assert err < 2e-3, err


def test_ola_wsum_tiled_matches_scatter():
    """The tiled+edge-corrected wsum vs a brute-force scatter build."""
    import jax.numpy as jnp

    from melonix_tpu.engine.phase_vocoder import _ola_wsum
    from melonix_tpu.engine.spectral import hann_window

    for size, hop, n_frames in [(2048, 512, 37), (2048, 512, 4), (1024, 256, 9),
                                (2048, 1024, 5), (2048, 512, 2)]:
        out_len = (n_frames - 1) * hop + size
        win = hann_window(size)
        w2 = (win * win).astype(np.float64)
        want = np.full(out_len, 1e-8)
        acc = np.zeros(out_len)
        for g in range(n_frames):
            acc[g * hop : g * hop + size] += w2
        want = np.maximum(acc, 1e-8)
        got = np.asarray(_ola_wsum(jnp.asarray(win), size, hop, n_frames, out_len))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


# ---- Identity phase locking (Laroche & Dolson 1999; BASELINE north star) ----


def test_identity_lock_region_semantics():
    """Each bin locks to its nearest peak: psi[k] = psi[p] + (phi[k]-phi[p]);
    regions split at the midpoint between adjacent peaks."""
    import jax.numpy as jnp

    from melonix_tpu.engine.phase_vocoder import identity_lock

    mag = np.zeros((1, 16), np.float32)
    mag[0] = [0, .1, .5, 1., .5, .1, 0, 0, .2, .6, 1.2, .6, .2, 0, 0, 0]
    phi = np.linspace(0.0, 3.0, 16, dtype=np.float32)[None]
    psi = (phi[0] + np.linspace(5.0, 9.0, 16, dtype=np.float32))[None]
    out = np.asarray(
        identity_lock(jnp.asarray(psi), jnp.asarray(phi), jnp.asarray(mag))
    )
    theta = psi - phi
    k = np.arange(16)
    want = phi + np.where((k - 3) <= (10 - k), theta[0, 3], theta[0, 10])
    assert np.abs(out - want).max() < 1e-6
    # Peak channels themselves are untouched (identity at the peaks).
    assert np.abs(out[0, [3, 10]] - psi[0, [3, 10]]).max() < 1e-6


def test_identity_lock_silent_frame_keeps_classic():
    import jax.numpy as jnp

    from melonix_tpu.engine.phase_vocoder import identity_lock

    phi = np.linspace(0.0, 3.0, 16, dtype=np.float32)[None]
    psi = (phi[0] + np.linspace(5.0, 9.0, 16, dtype=np.float32))[None]
    out = np.asarray(identity_lock(
        jnp.asarray(psi), jnp.asarray(phi), jnp.zeros((1, 16), jnp.float32)
    ))
    assert np.abs(out - psi).max() < 1e-6


def _mod_index(y, sr):
    """Amplitude-modulation index of the strongest partials over a steady
    segment — the objective phasiness proxy (vertical incoherence shows as
    beating of the mainlobe bins, i.e. peak-bin magnitude wobble)."""
    size, hop = 2048, 512
    seg = y[int(1.2 * sr): int(2.8 * sr)]
    n_f = (len(seg) - size) // hop
    fr = np.stack([seg[i * hop: i * hop + size] for i in range(n_f)])
    mags = np.abs(np.fft.rfft(fr * np.hanning(size)))
    mean = mags.mean(0)
    ks: list[int] = []
    for kk in np.argsort(mean)[::-1]:
        if all(abs(int(kk) - j) > 4 for j in ks):
            ks.append(int(kk))
        if len(ks) == 4:
            break
    return float(np.mean([mags[:, kk].std() / mags[:, kk].mean() for kk in ks]))


def test_phase_locking_reduces_phasiness():
    """Two inharmonic tones through a +3 st plateau: locking must cut the
    partials' amplitude modulation by at least 2x and preserve energy."""
    sr = 22050
    n = 4 * sr
    t = np.arange(n) / sr
    x = (0.4 * np.sin(2 * np.pi * 311.1 * t)
         + 0.4 * np.sin(2 * np.pi * 554.4 * t)).astype(np.float32)
    markers = [Marker(n // 4, 57.0, 0.0, 3.0), Marker(3 * n // 4, 57.0, 0.0, 3.0)]
    knots = MapKnots.from_markers(markers, sr, n)
    classic = render_track_pv(x, knots)
    locked = render_track_pv(x, knots, phase_locking=True)
    r_c = np.sqrt(np.mean(classic**2))
    r_l = np.sqrt(np.mean(locked**2))
    assert abs(r_l - r_c) / r_c < 0.15
    m_c = _mod_index(classic, sr)
    m_l = _mod_index(locked, sr)
    assert m_l < 0.5 * m_c, (m_c, m_l)


def test_chunked_stretch_locked_matches_single(monkeypatch):
    """Locking is a per-frame transform with no carried state: chunked and
    one-shot locked renders must still agree."""
    import melonix_tpu.engine.phase_vocoder as pv

    x = _sine(330.0, 6.0)
    n = len(x)
    markers = [
        Marker(sample=n // 3, note=52.0, d_time=0.1, pitch_bend=5.0),
        Marker(sample=2 * n // 3, note=52.0, d_time=-0.05, pitch_bend=-3.0),
    ]
    knots = MapKnots.from_markers(markers, SR, n)
    single = render_track_pv(x, knots, phase_locking=True)
    monkeypatch.setattr(pv, "PV_CHUNK_FRAMES", 64)
    chunked = render_track_pv(x, knots, phase_locking=True)
    assert len(single) == len(chunked)
    err = np.sqrt(np.mean((single - chunked) ** 2)) / (
        np.sqrt(np.mean(single**2)) + 1e-12
    )
    assert err < 2e-3, err


def test_locked_pitch_accuracy():
    """Locking must not move the rendered pitch (single tone, +2 st)."""
    x = _sine(440.0, 2.0)
    n = len(x)
    markers = [
        Marker(sample=n // 4, note=57.0, d_time=0.0, pitch_bend=2.0),
        Marker(sample=3 * n // 4, note=57.0, d_time=0.0, pitch_bend=2.0),
    ]
    knots = MapKnots.from_markers(markers, SR, n)
    y = render_track_pv(x, knots, phase_locking=True)
    seg = y[int(0.35 * n): int(0.6 * n)]
    want = 440.0 * 2.0 ** (2.0 / 12.0)
    assert abs(_peak_freq(seg) - want) < 10.0


def test_resample_relative_positions_exact_at_hour_scale(rng):
    """Block-relative positions keep sub-sample precision where absolute
    f32 positions quantize to 16-sample steps (ADVICE r1 high finding):
    source offsets ~1.5e8 (an hour at 44.1 kHz), through the lerp
    resampler the PV render uses."""
    import jax.numpy as jnp

    from melonix_tpu.engine.phase_vocoder import BLK, _lerp_resample_rel_xla

    n_src = 4096
    big = 150_000_000  # pretend the block sits this deep into the stretch
    y = rng.standard_normal(n_src).astype(np.float32)
    rates = (1.1 + 0.4 * np.sin(np.linspace(0, 7, BLK))).astype(np.float64)
    pos64 = big + 200.0 + np.cumsum(rates) - rates
    # Absolute f32 demonstrably broken at this magnitude:
    assert np.unique(pos64.astype(np.float32)).size < BLK // 4
    base_local = np.full(1, 200 - 128, np.int32)  # block base within y
    rel = (pos64 - big - base_local[0].astype(np.float64)).astype(np.float32)
    got = np.asarray(_lerp_resample_rel_xla(
        jnp.asarray(y), jnp.asarray(rel), jnp.asarray(base_local), n_src, BLK))
    local64 = pos64 - big  # float64 ground truth within the block
    # Position error is f32-ulp-of-the-RESIDUAL (~2e-4 samples), not the
    # 16-sample ulp of absolute f32 at 1.5e8.
    pos_err = np.abs(rel.astype(np.float64) + base_local[0] - local64)
    assert pos_err.max() < 1e-3, pos_err.max()
    i0 = np.floor(local64).astype(np.int64)
    frac = local64 - i0
    want = (1 - frac) * y[i0] + frac * y[i0 + 1]
    # Amplitude tolerance = position ulp x O(1) signal slope.
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_pv_positions_rel_device_matches_float64():
    """Device block-relative position math vs float64 ground truth on a
    synthetic multi-segment bend curve (expm1 formulation, int32 dt)."""
    import jax.numpy as jnp

    from melonix_tpu.engine.phase_vocoder import (
        BLK,
        _anchor_table,
        _positions_rel_device,
        _segment_table,
        _src_eval64,
    )

    def _bits(x):  # f32 bit patterns, as PVPlan.anc_args ships them
        return np.asarray(x, np.float32).view(np.int32).copy()

    sr = 8000
    n = 6 * sr
    markers = [
        Marker(sample=n // 4, note=57.0, d_time=0.1, pitch_bend=5.0),
        Marker(sample=n // 2, note=57.0, d_time=0.0, pitch_bend=-2.0),
        Marker(sample=3 * n // 4, note=57.0, d_time=-0.03, pitch_bend=0.002),
    ]
    knots = MapKnots.from_markers(markers, sr, n)
    n_out = int(knots.duration() * sr)
    n_out_pad = 8192 * -(-n_out // 8192)
    table = _segment_table(knots, n_out / sr)
    stretch_len = n_out_pad * 2
    anc_j, src_rel64, rho_a, s_a, base = _anchor_table(
        table, sr, n_out_pad, stretch_len
    )
    got_rel = np.asarray(
        _positions_rel_device(
            jnp.asarray(anc_j), jnp.asarray(_bits(src_rel64)),
            jnp.asarray(_bits(rho_a)), jnp.asarray(_bits(s_a)),
            n_out_pad, sr,
        )
    )
    got_abs = got_rel.astype(np.float64) + np.repeat(
        base.astype(np.float64), BLK
    )
    j = np.arange(n_out_pad, dtype=np.float64)
    want_abs, _, _ = _src_eval64(table, (j + 1.0) / sr, sr)
    # base includes SLACK so got_abs == want only where want > 0 (the clamp
    # at 0 applies to the relative value for block 0 only).  Tolerance is
    # sub-millisample: the expm1_precise series keeps f32 evaluation at
    # ~1-ulp (XLA's own f32 expm1 carries 1.2e-4 relative error, which
    # amplified to ~0.1-sample position errors before the fix).
    mask = want_abs > 1.0
    np.testing.assert_allclose(got_abs[mask], want_abs[mask], atol=2e-3)
