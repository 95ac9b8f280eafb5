"""Batched pitch-curve extraction (added capability; BASELINE.json config #3).

The reference has no automatic pitch detection — markers are user-placed
(app.cpp:932-945).  This engine supplies the missing analysis: a whole-track
pitch curve computed in ONE device program — per-frame normalized
autocorrelation (via rFFT, Wiener-Khinchin) with parabolic lag refinement,
octave-error suppression (first lag within 85% of the global peak wins), and
a voicing decision from the autocorrelation clarity + frame energy.

Notes use the reference's A-based scale: note n ↔ 55 · 2^((n-24)/12) Hz
(app.cpp:499), so a detected curve can be dropped straight onto the
spectrogram's semitone rows.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, Config


@dataclasses.dataclass
class PitchCurve:
    f0: np.ndarray  # (F,) Hz, 0 where unvoiced
    voiced: np.ndarray  # (F,) bool
    clarity: np.ndarray  # (F,) autocorrelation peak ratio
    note: np.ndarray  # (F,) reference note scale (55 Hz = note 24)
    hop: int
    sample_rate: int

    def note_at_time(self, t: float) -> float:
        idx = int(t * self.sample_rate / self.hop)
        idx = max(0, min(idx, len(self.note) - 1))
        return float(self.note[idx])


def _parabolic(y: jnp.ndarray, i: jnp.ndarray, eps: float):
    """Parabolic peak refinement of per-frame index ``i`` into curve ``y``
    (F, n): returns the clamped fractional offset in [-0.5, 0.5]."""
    ym1 = jnp.take_along_axis(y, (i - 1)[:, None], axis=1)[:, 0]
    y0 = jnp.take_along_axis(y, i[:, None], axis=1)[:, 0]
    yp1 = jnp.take_along_axis(y, (i + 1)[:, None], axis=1)[:, 0]
    denom = ym1 - 2 * y0 + yp1
    d = jnp.where(jnp.abs(denom) > eps, 0.5 * (ym1 - yp1) / denom, 0.0)
    return jnp.clip(d, -0.5, 0.5), y0


def pitch_core(w: jnp.ndarray, frame: int, lag_min: int, lag_max: int):
    """NSDF pitch analysis of mean-subtracted frames ``w`` (F, frame).

    Returns (lag, clarity, energy) per frame.  Pure function of the frame
    matrix so both the single-device path and the seq-sharded multi-device
    path (parallel/sharded.sharded_pitch) share one implementation.
    """
    n_frames = w.shape[0]
    # McLeod's NSDF: linear autocorrelation via zero-padded rFFT
    # (Wiener-Khinchin), normalized by the running energy term
    # m(τ) = Σ x²[j] + x²[j+τ] so a tapering window isn't needed and
    # the peak lag is unbiased.
    spec = jnp.fft.rfft(w, n=2 * frame)
    power = spec.real**2 + spec.imag**2
    ac = jnp.fft.irfft(power, n=2 * frame)[:, :frame]  # (F, frame) r(τ)
    csum = jnp.cumsum(w * w, axis=1)
    total = csum[:, -1:]
    # Σ_{j<W-τ} x²[j] = E[W-τ-1] = csum reversed; Σ_{j>=τ} x²[j] =
    # total - E[τ-1] = total - csum shifted.  Flip/shift, not a
    # (frames x lags) take_along_axis gather.
    head = jnp.flip(csum, axis=1)
    tail_prev = jnp.concatenate(
        [jnp.zeros((n_frames, 1), csum.dtype), csum[:, :-1]], axis=1
    )
    m = head + (total - tail_prev)
    nac = 2.0 * ac / jnp.maximum(m, 1e-12)

    lags = jnp.arange(frame)
    in_range = (lags >= lag_min) & (lags <= lag_max)
    # Candidates must be local maxima of the NAC (otherwise the smooth
    # near-zero-lag shoulder of any band-limited signal wins, MPM-style).
    prev = jnp.concatenate([nac[:, :1], nac[:, :-1]], axis=1)
    nxt = jnp.concatenate([nac[:, 1:], nac[:, -1:]], axis=1)
    is_peak = (nac > prev) & (nac >= nxt)
    cand = jnp.where(in_range[None, :] & is_peak, nac, -1.0)
    peak_val = jnp.max(cand, axis=1, keepdims=True)
    # Octave-error suppression: earliest peak lag reaching 85% of the best.
    good = cand >= 0.85 * peak_val
    first_lag = jnp.argmax(good, axis=1)  # first True (lags ordered ascending)

    # Parabolic interpolation around the chosen lag.
    li = jnp.clip(first_lag, 1, frame - 2)
    delta, y0 = _parabolic(nac, li, 1e-12)
    lag = li.astype(jnp.float32) + delta

    clarity = y0
    energy = jnp.mean(w * w, axis=1)
    return lag, clarity, energy


def hps_core(w: jnp.ndarray, frame: int, lag_min: int, lag_max: int,
             n_harm: int = 4):
    """Harmonic-product-spectrum detector over mean-subtracted frames
    (BASELINE config #3 names "autocorrelation/HPS": this is the HPS
    half; pitch_core is the autocorrelation/NSDF half).

    Works in the log domain (a product of powers underflows f32) on the
    zero-padded power spectrum; each decimated view ``P[:, ::h]`` indexes
    bin h·k at position k, so the harmonic sum is pure slicing — no
    gathers.  Returns (lag, salience): lag in samples at the NSDF lag
    convention (sr/f0 = lag → 2·frame/k bins), salience = mean log-power
    margin of the winning k over the in-range median (≈0 for noise).
    """
    spec = jnp.fft.rfft(w, n=2 * frame)
    lp = jnp.log(spec.real**2 + spec.imag**2 + 1e-20)  # (F, frame+1)
    n_bins = lp.shape[1]
    nb = (n_bins - 1) // n_harm + 1
    hsum = sum(lp[:, ::h][:, :nb] for h in range(1, n_harm + 1))
    # f0 bin k ↔ lag = 2*frame/k: the NSDF lag range maps to a bin range.
    k = jnp.arange(nb)
    k_min = max(1, int(np.ceil(2 * frame / lag_max)))
    k_max = min(nb - 2, int(np.floor(2 * frame / lag_min)))
    in_range = (k >= k_min) & (k <= k_max)
    # Subharmonic guard: a pure tone's leakage skirt lets k0/h outscore k0
    # (one harmonic term lands ON the peak, the rest ride the higher
    # low-frequency skirt), so the winning candidate's own fundamental
    # bin must be within ~26 dB of the frame's strongest bin.  When no
    # candidate qualifies (missing fundamental) fall back to the raw comb.
    strong = lp[:, :nb] >= (jnp.max(lp, axis=1, keepdims=True) - 6.0)
    masked_strong = jnp.where(in_range[None, :] & strong, hsum, -jnp.inf)
    masked_all = jnp.where(in_range[None, :], hsum, -jnp.inf)
    any_strong = jnp.any(in_range[None, :] & strong, axis=1)
    k_best = jnp.where(
        any_strong,
        jnp.argmax(masked_strong, axis=1),
        jnp.argmax(masked_all, axis=1),
    )
    # Parabolic refinement in the log-harmonic-sum domain.
    ki = jnp.clip(k_best, 1, nb - 2)
    dk, y0 = _parabolic(hsum, ki, 1e-9)
    kf = ki.astype(jnp.float32) + dk
    lag = 2.0 * frame / jnp.maximum(kf, 1e-6)
    med = jnp.nanmedian(jnp.where(in_range[None, :], hsum, jnp.nan), axis=1)
    salience = (y0 - med) / n_harm
    return lag, salience


@partial(jax.jit, static_argnames=("frame", "hop", "n_frames", "lag_min", "lag_max"))
def _pitch_device(
    wav: jnp.ndarray,
    frame: int,
    hop: int,
    n_frames: int,
    lag_min: int,
    lag_max: int,
):
    return pitch_core(_centered_frames(wav, frame, hop, n_frames),
                      frame, lag_min, lag_max)


def _centered_frames(wav, frame: int, hop: int, n_frames: int):
    from .spectral import extract_hop_frames

    frames = extract_hop_frames(wav.astype(jnp.float32), frame, hop, n_frames)
    return frames - jnp.mean(frames, axis=1, keepdims=True)


@partial(jax.jit, static_argnames=("frame", "hop", "n_frames", "lag_min", "lag_max"))
def _hps_device(wav, frame: int, hop: int, n_frames: int,
                lag_min: int, lag_max: int):
    return hps_core(_centered_frames(wav, frame, hop, n_frames),
                    frame, lag_min, lag_max)


def pitch_curve(
    wav,
    sample_rate: int,
    *,
    config: Config = DEFAULT_CONFIG,
    clarity_threshold: float = 0.5,
    energy_threshold: float = 1e-6,
    method: str = "nsdf",
) -> PitchCurve:
    """``method``: "nsdf" (autocorrelation, default), "hps" (harmonic
    product spectrum), or "hybrid" — NSDF lags with HPS overriding only
    where the two disagree by exactly an octave AND the harmonic
    evidence is salient (HPS fails on missing-fundamental signals where
    NSDF wins, so NSDF stays the baseline)."""
    if method not in ("nsdf", "hps", "hybrid"):
        raise ValueError(f"unknown pitch method: {method}")
    wav = np.asarray(wav, np.float32)
    frame, hop = config.pitch_frame, config.pitch_hop
    n_frames = max(1, 1 + (len(wav) - frame) // hop) if len(wav) >= frame else 1
    lag_min = max(2, int(sample_rate / config.pitch_fmax))
    lag_max = min(frame - 2, int(sample_rate / config.pitch_fmin))
    lag, clarity, energy = _pitch_device(
        jnp.asarray(wav), frame, hop, n_frames, lag_min, lag_max
    )
    lag = np.asarray(lag, np.float64)
    if method in ("hps", "hybrid"):
        hlag, sal = _hps_device(
            jnp.asarray(wav), frame, hop, n_frames, lag_min, lag_max
        )
        hlag = np.asarray(hlag, np.float64)
        sal = np.asarray(sal, np.float64)
        if method == "hps":
            lag = hlag
        else:
            octave_low = np.abs(lag - 2.0 * hlag) < 0.04 * 2.0 * hlag
            octave_high = np.abs(2.0 * lag - hlag) < 0.04 * hlag
            # sal > 2.0: white noise measures ~1.3; tonal frames 4-8.
            lag = np.where((octave_low | octave_high) & (sal > 2.0), hlag, lag)
    clarity = np.asarray(clarity, np.float64)
    energy = np.asarray(energy, np.float64)
    f0 = np.where(lag > 0, sample_rate / np.maximum(lag, 1e-9), 0.0)
    voiced = (clarity > clarity_threshold) & (energy > energy_threshold)
    f0 = np.where(voiced, f0, 0.0)
    with np.errstate(divide="ignore"):
        note = np.where(f0 > 0, 24.0 + 12.0 * np.log2(np.maximum(f0, 1e-9) / 55.0), 0.0)
    return PitchCurve(
        f0=f0.astype(np.float32),
        voiced=voiced,
        clarity=clarity.astype(np.float32),
        note=note.astype(np.float32),
        hop=hop,
        sample_rate=int(sample_rate),
    )
