"""The phase vocoder's device core vs float64 NumPy: analysis, phase
propagation with its chunk carry, identity locking, the cepstral formant
warp, and synthesis overlap-add."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from melonix_tpu.engine import phase_vocoder as pv
from melonix_tpu.engine.spectral import hann_window

SIZE, HOP = 512, 128
N_CEPS = 40


def _formant_gain_np(mag, rho, size, n_ceps=N_CEPS):
    """Float64 cepstral warp gain: the envelope's cosine series evaluated
    at rho-scaled bins over the unscaled ones (clipped to +-60 dB)."""
    n_bins = size // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)
    wk = np.full(n_bins, 2.0 / size)
    wk[0] = wk[-1] = 1.0 / size
    q = np.arange(1, n_ceps, dtype=np.float64)
    cep = np.log(mag.astype(np.float64) + 1e-8) @ (
        wk[:, None] * np.cos(2.0 * np.pi * k[:, None] * q[None, :] / size))
    theta = 2.0 * np.pi * k / size
    warped = np.cos(q[None, None, :] * theta[None, :, None]
                    * rho[:, None, None].astype(np.float64))
    plain = np.cos(q[None, None, :] * theta[None, :, None])
    gain_log = 2.0 * np.sum(cep[:, None, :] * (warped - plain), axis=-1)
    return np.exp(np.clip(gain_log, -6.9, 6.9))


def _lock_np(psi, phi, mag):
    """Identity locking by its definition: each bin takes the phase offset
    of its nearest spectral peak (ties to the lower peak)."""
    out = psi.copy()
    n_bins = mag.shape[1]
    for f in range(mag.shape[0]):
        m = np.concatenate([[-1.0, -1.0], mag[f], [-1.0, -1.0]])
        c = m[2:-2]
        is_peak = ((c > 0) & (c > m[1:-3]) & (c >= m[3:-1])
                   & (c > m[:-4]) & (c >= m[4:]))
        peaks = np.flatnonzero(is_peak)
        if peaks.size == 0:
            continue
        for k in range(n_bins):
            d = np.abs(peaks - k)
            p = peaks[np.argmin(d)]  # argmin takes the first: lower peak
            out[f, k] = phi[f, k] + (psi[f, p] - phi[f, p])
    return out


def _pv_np(wav, starts, da, rho, size, hop, formant=False, lock=False):
    """Float64 classic phase vocoder: per-frame analysis, phase advance
    psi_m = psi_{m-1} + hop*omega + hop*princarg(dphi - omega*da)/da,
    resynthesis and unnormalized windowed overlap-add at ``hop``."""
    n = len(wav)
    win = hann_window(size).astype(np.float64)
    frames = np.zeros((len(starts), size))
    for f, s in enumerate(starts):
        seg = wav[s: min(s + size, n)].astype(np.float64)
        frames[f, : len(seg)] = seg
    spec = np.fft.rfft(frames * win)
    mag, phi = np.abs(spec), np.angle(spec)
    if formant:
        mag = mag * _formant_gain_np(mag, rho, size)
    omega = 2.0 * np.pi * np.arange(size // 2 + 1) / size
    psi = np.empty_like(phi)
    psi[0] = phi[0]
    for m in range(1, len(starts)):
        d = max(float(da[m]), 1e-3)
        dphi = phi[m] - phi[m - 1] - omega * d
        dphi = np.mod(dphi + np.pi, 2.0 * np.pi) - np.pi
        psi[m] = psi[m - 1] + hop * omega + hop * dphi / d
    if lock:
        psi = _lock_np(psi, phi, mag)
    t = np.fft.irfft(mag * np.exp(1j * psi), n=size) * win
    y = np.zeros((len(starts) - 1) * hop + size)
    for m in range(len(starts)):
        y[m * hop: m * hop + size] += t[m]
    return y


def _frame_plan(n_frames, n_wav, rng):
    """Analysis starts advancing by a wandering rate (stretch + bend)."""
    da = (HOP * (0.8 + 0.5 * rng.random(n_frames))).astype(np.float32)
    starts = np.concatenate([[0.0], np.cumsum(da[1:])]).astype(np.int32)
    starts = np.minimum(starts, n_wav - 1)
    rho = (0.75 + 0.6 * rng.random(n_frames)).astype(np.float32)
    return starts, da, rho


def _device_pv(wav, starts, da, rho, ch, formant, lock):
    """The device core over chunks of ``ch`` frames with its carried phase
    state (resid, previous phase, global anchor), OLA-summed."""
    F = len(starts)
    n_bins = SIZE // 2 + 1
    win = jnp.asarray(hann_window(SIZE))
    resid = phi_prev = phi0 = jnp.zeros(n_bins, jnp.float32)
    y = np.zeros((F - 1) * HOP + SIZE + ch * HOP)
    for m0 in range(0, F, ch):
        f_real = min(ch, F - m0)
        sl = np.clip(np.arange(m0, m0 + ch), 0, F - 1)  # edge-padded chunk
        y_c, resid, phi_prev, phi0 = pv._stretch_chunk(
            jnp.asarray(wav), jnp.asarray(starts[sl]), jnp.asarray(da[sl]),
            jnp.asarray(rho[sl]), win, jnp.int32(m0), jnp.int32(f_real),
            phi0, resid, phi_prev, SIZE, HOP, ch, formant=formant, lock=lock,
        )
        y[m0 * HOP: m0 * HOP + len(y_c)] += np.asarray(y_c)
    return y[: (F - 1) * HOP + SIZE]


@pytest.mark.parametrize(
    "ch,formant,lock",
    [(48, False, False), (16, False, False), (48, False, True),
     (16, True, False)],
    ids=["one_chunk", "chunked_carry", "locked", "formant_chunked"],
)
def test_pv_core_matches_numpy_f64(rng, ch, formant, lock):
    sr = 8000
    t = np.arange(sr) / sr
    wav = (0.5 * np.sin(2 * np.pi * 330.0 * t)
           + 0.25 * np.sin(2 * np.pi * 1234.5 * t)
           + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    starts, da, rho = _frame_plan(48, len(wav), rng)
    got = _device_pv(wav, starts, da, rho, ch, formant, lock)
    want = _pv_np(wav, starts, da, rho, SIZE, HOP, formant, lock)
    err = np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2))
    # float32 device pipeline vs float64: rfft/irfft rounding and the
    # float32 residual prefix sum over 48 frames.
    assert err < 2e-4, err


def test_formant_gain_matches_numpy_f64(rng):
    """The Chebyshev-recurrence warp gain vs a direct float64 cosine-series
    evaluation, over rates the edit model produces."""
    n_bins = SIZE // 2 + 1
    k = np.arange(n_bins)
    env = np.exp(-((k - 60.0) / 40.0) ** 2) + 0.3 * np.exp(-((k - 150.0) / 25.0) ** 2)
    mag = (env[None, :] * (1.0 + 0.2 * rng.random((12, n_bins))) + 1e-3)
    rho = np.linspace(0.6, 1.8, 12)
    got = np.asarray(pv._formant_gain(
        jnp.asarray(mag, jnp.float32), jnp.asarray(rho, jnp.float32),
        SIZE, n_bins, N_CEPS))
    want = _formant_gain_np(mag, rho, SIZE)
    np.testing.assert_allclose(np.log(got), np.log(want), atol=2e-3)


def test_formant_projection_pinned_to_highest():
    """The cepstral projection is the one float32 matmul of the PV path;
    it must ask for full float32 precision (a GPU would otherwise be free
    to run it in TF32)."""
    n_bins = SIZE // 2 + 1
    jaxpr = jax.make_jaxpr(
        lambda m, r: pv._formant_gain(m, r, SIZE, n_bins, N_CEPS)
    )(jnp.ones((4, n_bins), jnp.float32), jnp.ones(4, jnp.float32))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 1
    precision = dots[0].params["precision"]
    assert precision is not None and all(
        p == jax.lax.Precision.HIGHEST for p in precision
    ), precision
