"""Spectral engine: reference-parity columns, |STFT|, STFT/iSTFT."""

import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from melonix_tpu.config import Config
from melonix_tpu.engine import spectral as S
from melonix_tpu.engine.maps import MapKnots

# Small DFT size keeps the oracle fast; engine semantics are size-generic.
CFG = Config(spectr_size=2048)


def snr_db(got, want):
    err = np.linalg.norm(got - want)
    ref = np.linalg.norm(want) + 1e-30
    return 20 * np.log10(err / ref + 1e-30)


@pytest.mark.parametrize(
    "start,end",
    [
        (0, 2048),  # exact window
        (1000, 3000),  # decay region inside
        (-500, 1000),  # window extends before track start
        (11000, 12500),  # window extends past track end
        (2000, 2100),  # narrow column (start close to end)
    ],
)
def test_column_parity(chirp, start, end):
    x, _sr = chirp
    want = oracle.spec_column(x, start, end, CFG.spectr_size)
    got = S.spectrogram_columns(x, [start], [end], CFG)[0]
    assert got.shape == want.shape
    # float32 engine vs float64 oracle: −60 dB is the north star; we land far below.
    assert snr_db(got, want) < -80, snr_db(got, want)


def test_columns_batched(chirp):
    x, _sr = chirp
    starts = np.array([0, 1000, 5000, 9000])
    ends = starts + 1800
    got = S.spectrogram_columns(x, starts, ends, CFG)
    for i in range(len(starts)):
        want = oracle.spec_column(x, int(starts[i]), int(ends[i]), CFG.spectr_size)
        assert snr_db(got[i], want) < -80


@pytest.mark.parametrize("start_frac,span", [(0.3, 882), (0.7, 20), (1.02, 4000)])
def test_columns_reference_size(rng, start_frac, span):
    """The 32768-point columns the UI tiles use, vs the float64 oracle —
    including a window that runs past the track end."""
    size = 32768
    x = (0.5 * np.sin(np.arange(60000) * 0.037)
         + 0.05 * rng.standard_normal(60000)).astype(np.float32)
    end = int(start_frac * len(x))
    want = oracle.spec_column(x, end - span, end, size)
    got = S.spectrogram_columns(x, [end - span], [end],
                                Config(spectr_size=size))[0]
    assert got.shape == (size // 2,)
    assert snr_db(got, want) < -80, snr_db(got, want)


def _stft_mags_f64(x, size, hop, nf):
    win = S.hann_window(size).astype(np.float64)
    frames = np.zeros((nf, size))
    for i in range(nf):
        seg = x[i * hop: i * hop + size].astype(np.float64)
        frames[i, : len(seg)] = seg
    return np.abs(np.fft.rfft(frames * win))[:, : size // 2]


@pytest.mark.parametrize("size,hop", [(2048, 512), (1024, 256), (2048, 1024),
                                      (2048, 256)])
def test_stft_mags_device_matches_numpy_f64(rng, size, hop):
    """|STFT| (the headline analysis stage) vs float64 NumPy at each frame
    geometry the production config and its variants use; the length is
    not hop-aligned, so the last frame runs into the zero tail."""
    n = 5 * size + 137
    x = rng.standard_normal(n).astype(np.float32)
    nf = S.num_frames(n, size, hop) + 1  # one frame past the end: zero-fill
    got = np.asarray(S.stft_mags_device(
        jnp.asarray(x), jnp.asarray(S.hann_window(size)), size, hop, nf))
    want = _stft_mags_f64(x, size, hop, nf)
    assert got.shape == (nf, size // 2) and got.dtype == np.float32
    assert snr_db(got, want) < -110, snr_db(got, want)


def test_stft_mags_device_scale(rng):
    x = rng.standard_normal(4096).astype(np.float32)
    win = jnp.asarray(S.hann_window(1024))
    a = np.asarray(S.stft_mags_device(jnp.asarray(x), win, 1024, 256, 13))
    b = np.asarray(S.stft_mags_device(jnp.asarray(x), win, 1024, 256, 13,
                                      scale=0.25))
    np.testing.assert_allclose(b, 0.25 * a, rtol=1e-6)


@pytest.mark.parametrize("size,hop,normalize", [(2048, 512, False),
                                                (512, 128, True),
                                                (512, 96, True)])
def test_istft_device_matches_numpy(rng, size, hop, normalize):
    """iSTFT (the PV synthesis stage) vs a float64 NumPy irfft + windowed
    overlap-add, whole-hop and gather-path geometries."""
    F = 23
    nb = size // 2 + 1
    spec = (rng.standard_normal((F, nb))
            + 1j * rng.standard_normal((F, nb))).astype(np.complex64)
    win = S.hann_window(size)
    out_len = (F - 1) * hop + size
    got = np.asarray(S.istft_device(jnp.asarray(spec), jnp.asarray(win), size,
                                    hop, out_len, normalize=normalize))
    t = np.fft.irfft(spec.astype(np.complex128), n=size) * win.astype(np.float64)
    want = np.zeros(out_len)
    wsum = np.zeros(out_len)
    for f in range(F):
        want[f * hop: f * hop + size] += t[f]
        wsum[f * hop: f * hop + size] += win.astype(np.float64) ** 2
    if normalize:
        want = want / np.maximum(wsum, 1e-8)
        inner = slice(size, out_len - size)  # full-overlap interior
        got, want = got[inner], want[inner]
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())


def test_view_column_ranges(chirp):
    x, sr = chirp
    knots = MapKnots.from_markers([], sr, len(x))
    starts, ends = S.view_column_ranges(knots, width=100, start_time=0.0, range_time=1.0)
    assert starts.shape == ends.shape == (100,)
    # Identity map: column x covers [x, x+1) * sr / width samples
    np.testing.assert_array_equal(starts, (np.arange(100) * sr / 100).astype(np.int64))
    assert np.all(ends >= starts)


def test_stft_roundtrip(chirp):
    x, _sr = chirp
    cfg = Config(stft_size=512, stft_hop=128)
    frames, hop = S.stft(x, cfg)
    assert frames.shape[1] == 257
    win = jnp.asarray(S.hann_window(512))
    out = np.asarray(S.istft_device(jnp.asarray(frames), win, 512, hop, len(x)))
    # Interior reconstruction error tiny (edges lack full overlap)
    lo, hi = 512, len(x) - 512
    np.testing.assert_allclose(out[lo:hi], x[lo:hi], atol=1e-4)


def test_stft_matches_scipy(chirp):
    x, _sr = chirp
    try:
        from scipy.signal import stft as sp_stft
    except ImportError:
        pytest.skip("scipy missing")
    cfg = Config(stft_size=512, stft_hop=128)
    frames, hop = S.stft(x, cfg)
    _f, _t, Z = sp_stft(
        x, nperseg=512, noverlap=384, window="hann", boundary=None, padded=False
    )
    # scipy scales by 1/win.sum(); ours is unscaled
    scale = S.hann_window(512).sum()
    np.testing.assert_allclose(
        frames[: Z.shape[1]].T, Z * scale, atol=1e-3 * np.abs(Z).max() * scale
    )
