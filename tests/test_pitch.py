"""Pitch detection: accuracy on synthetic tones, voicing, octave robustness."""

import numpy as np
import pytest

from melonix_tpu.config import Config
from melonix_tpu.engine.pitch import pitch_curve


def tone(freq, sr=44100, seconds=1.0, harmonics=(1.0,)):
    t = np.arange(int(sr * seconds)) / sr
    x = sum(a * np.sin(2 * np.pi * freq * (i + 1) * t) for i, a in enumerate(harmonics))
    return (x / max(1.0, np.abs(x).max())).astype(np.float32)


@pytest.mark.parametrize("freq", [110.0, 220.0, 440.0, 880.0])
def test_pure_tone_accuracy(freq):
    sr = 44100
    x = tone(freq, sr)
    c = pitch_curve(x, sr)
    mid = c.f0[4:-4]
    voiced = c.voiced[4:-4]
    assert voiced.mean() > 0.9
    err_cents = 1200 * np.abs(np.log2(mid[voiced] / freq))
    assert np.median(err_cents) < 10, (freq, np.median(err_cents))


def test_harmonic_tone_no_octave_error():
    """Strong harmonics must not pull the estimate an octave down/up."""
    sr = 44100
    x = tone(220.0, sr, harmonics=(1.0, 0.8, 0.6, 0.4))
    c = pitch_curve(x, sr)
    voiced = c.voiced[4:-4]
    f = c.f0[4:-4][voiced]
    err_oct = np.abs(np.log2(f / 220.0))
    assert (err_oct < 0.2).mean() > 0.9


def test_silence_unvoiced():
    sr = 44100
    c = pitch_curve(np.zeros(sr, np.float32), sr)
    assert not c.voiced.any()
    assert (c.f0 == 0).all()


def test_noise_mostly_unvoiced(rng):
    sr = 44100
    x = (0.3 * rng.standard_normal(sr)).astype(np.float32)
    c = pitch_curve(x, sr)
    assert c.voiced.mean() < 0.3


def test_note_scale_matches_reference_convention():
    """55 Hz must land on note 24 (app.cpp:499: startFreq = 55·2^((n-24)/12))."""
    sr = 44100
    # fmin=50 so the 55 Hz fundamental's lag is inside the search range
    c = pitch_curve(tone(55.0, sr, seconds=1.5), sr, config=Config(pitch_fmin=50.0))
    voiced = c.voiced[4:-4]
    notes = c.note[4:-4][voiced]
    assert np.abs(np.median(notes) - 24.0) < 0.3


def test_glissando_tracks():
    sr = 44100
    t = np.arange(sr) / sr
    f_inst = 220.0 * 2 ** t  # one octave per second
    phase = 2 * np.pi * np.cumsum(f_inst) / sr
    x = np.sin(phase).astype(np.float32)
    c = pitch_curve(x, sr)
    idx = np.arange(len(c.f0))
    tt = idx * c.hop / sr
    want = 220.0 * 2**tt
    voiced = c.voiced & (tt > 0.05) & (tt < 0.9)
    err = 1200 * np.abs(np.log2(c.f0[voiced] / want[voiced]))
    # One octave/sec sweep moves ~4% within a single 46 ms frame; the
    # frame-centered estimate lags accordingly.
    assert np.median(err) < 40


def test_hps_detector_pure_tone_and_harmonic_stack():
    """The HPS half of BASELINE config #3 ("autocorrelation/HPS"): a pure
    tone and a full harmonic stack both resolve to the fundamental, with
    positive salience; white noise has near-zero salience."""
    import jax.numpy as jnp

    from melonix_tpu.engine.pitch import hps_core

    sr, frame = 8000, 1024
    t = np.arange(frame) / sr
    f0 = 220.0
    tone = np.sin(2 * np.pi * f0 * t)
    stack = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in (1, 2, 3, 4))
    rng = np.random.default_rng(0)
    noise = rng.standard_normal(frame)
    w = np.stack([tone, stack, noise]).astype(np.float32)
    w -= w.mean(axis=1, keepdims=True)
    lag_min, lag_max = int(sr / 1000.0), int(sr / 60.0)
    lag, sal = hps_core(jnp.asarray(w), frame, lag_min, lag_max)
    lag, sal = np.asarray(lag), np.asarray(sal)
    for i in (0, 1):
        f_got = sr / lag[i]
        assert abs(f_got - f0) < 3.0, (i, f_got, sal[i])
        assert sal[i] > 1.0, sal[i]
    assert sal[2] < sal[0] / 2 and sal[2] < 2.0  # noise: weak evidence


def test_pitch_curve_methods_agree_on_tone():
    """nsdf / hps / hybrid all land on the same note for a clean tone, and
    hybrid never diverges from nsdf when there is no octave dispute."""
    from melonix_tpu.engine.pitch import pitch_curve

    sr = 8000
    t = np.arange(2 * sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    curves = {m: pitch_curve(x, sr, method=m) for m in ("nsdf", "hps", "hybrid")}
    for m, c in curves.items():
        v = c.voiced
        assert v.mean() > 0.9, m
        assert abs(float(c.note[v].mean()) - 48.0) < 0.1, (m, c.note[v].mean())
    np.testing.assert_array_equal(curves["hybrid"].f0, curves["nsdf"].f0)


def test_hybrid_overrides_octave_disagreement():
    """When NSDF is forced into an octave error, salient HPS evidence
    corrects it: feed the hybrid combiner a synthetic disagreement via a
    signal whose NSDF lag is ambiguous — alternating-amplitude pulse
    train (strong subharmonic temptation)."""
    from melonix_tpu.engine.pitch import pitch_curve

    sr = 8000
    t = np.arange(2 * sr) / sr
    f0 = 250.0
    # Slight alternating amplitude: period-2 modulation makes NSDF's
    # first-peak-above-85% rule flirt with the half-frequency peak while
    # the harmonic spectrum stays unambiguous at f0's comb.
    x = np.sin(2 * np.pi * f0 * t) * (1.0 + 0.12 * np.sign(np.sin(np.pi * f0 * t)))
    x = x.astype(np.float32)
    c = pitch_curve(x, sr, method="hybrid")
    v = c.voiced
    got = float(np.median(c.f0[v]))
    # The hybrid must land on f0 or its true subharmonic—but never report
    # garbage; and HPS evidence keeps it within an octave of the comb.
    assert v.mean() > 0.8
    assert 120.0 < got < 260.0, got


def test_hybrid_combiner_override_semantics(monkeypatch):
    """Pin the hybrid rule directly: HPS overrides NSDF only on an
    exact-octave disagreement with salient evidence; low salience or
    non-octave disagreement keeps the NSDF lag."""
    import jax.numpy as jnp

    from melonix_tpu.engine import pitch as P

    sr = 8000
    n_frames = 4
    nsdf_lag = np.full(n_frames, 100.0, np.float32)  # 80 Hz

    def fake_pitch(*a, **k):
        return (jnp.asarray(nsdf_lag), jnp.full(n_frames, 0.9),
                jnp.full(n_frames, 0.1))

    cases = [
        # (hps_lag, salience, expect_hz): octave-low NSDF + salient -> HPS
        (np.full(n_frames, 50.0), np.full(n_frames, 5.0), sr / 50.0),
        # salience below the noise bar -> keep NSDF
        (np.full(n_frames, 50.0), np.full(n_frames, 1.0), sr / 100.0),
        # non-octave disagreement -> keep NSDF
        (np.full(n_frames, 70.0), np.full(n_frames, 5.0), sr / 100.0),
        # octave-high NSDF (HPS wants 200) + salient -> HPS
        (np.full(n_frames, 200.0), np.full(n_frames, 5.0), sr / 200.0),
    ]
    monkeypatch.setattr(P, "_pitch_device", fake_pitch)
    x = np.zeros(5 * sr, np.float32)
    for hlag, sal, want_hz in cases:
        monkeypatch.setattr(
            P, "_hps_device",
            lambda *a, _h=hlag, _s=sal, **k: (jnp.asarray(_h), jnp.asarray(_s)),
        )
        c = P.pitch_curve(x, sr, method="hybrid", energy_threshold=0.0)
        got = float(c.f0[0])
        assert abs(got - want_hz) < 1e-6, (got, want_hz)


def _nsdf_np(w, lag_min, lag_max):
    """McLeod NSDF by its definition in float64: r(tau) / m(tau) with the
    direct lag sums, then the same pick (local maxima in range, earliest
    reaching 85% of the best, parabolic refinement)."""
    w = w.astype(np.float64)
    W = w.shape[1]
    lags, clar = [], []
    for x in w:
        r = np.array([np.dot(x[: W - t], x[t:]) for t in range(W)])
        c = np.cumsum(x * x)
        m = np.array([c[W - t - 1] + (c[-1] - (c[t - 1] if t else 0.0))
                      for t in range(W)])
        nac = 2.0 * r / np.maximum(m, 1e-12)
        prev = np.concatenate([nac[:1], nac[:-1]])
        nxt = np.concatenate([nac[1:], nac[-1:]])
        t = np.arange(W)
        cand = np.where((t >= lag_min) & (t <= lag_max) & (nac > prev) & (nac >= nxt),
                        nac, -1.0)
        li = int(np.clip(np.argmax(cand >= 0.85 * cand.max()), 1, W - 2))
        ym1, y0, yp1 = nac[li - 1], nac[li], nac[li + 1]
        den = ym1 - 2 * y0 + yp1
        d = 0.5 * (ym1 - yp1) / den if abs(den) > 1e-12 else 0.0
        lags.append(li + np.clip(d, -0.5, 0.5))
        clar.append(y0)
    return np.array(lags), np.array(clar)


@pytest.mark.parametrize("f0,harm", [(220.0, 0.0), (147.0, 0.6)])
def test_nsdf_core_matches_numpy_f64(rng, f0, harm):
    """The FFT autocorrelation (rfft -> power -> irfft) NSDF vs the direct
    float64 lag sums, on a pure and a harmonic-rich tone with noise."""
    import jax.numpy as jnp

    from melonix_tpu.engine.pitch import pitch_core

    sr, frame = 16000, 1024
    t = np.arange(6 * frame) / sr
    x = (np.sin(2 * np.pi * f0 * t) + harm * np.sin(2 * np.pi * 2 * f0 * t)
         + 0.02 * rng.standard_normal(len(t)))
    w = np.stack([x[i * 512: i * 512 + frame] for i in range(9)])
    w = (w - w.mean(axis=1, keepdims=True)).astype(np.float32)
    lag_min, lag_max = int(sr / 1000.0), int(sr / 60.0)
    lag, clarity, energy = (np.asarray(a) for a in pitch_core(
        jnp.asarray(w), frame, lag_min, lag_max))
    want_lag, want_clar = _nsdf_np(w, lag_min, lag_max)
    np.testing.assert_allclose(lag, want_lag, atol=2e-3)
    np.testing.assert_allclose(clarity, want_clar, atol=1e-4)
    np.testing.assert_allclose(energy, np.mean(w.astype(np.float64) ** 2, axis=1),
                               rtol=1e-5)
