"""Spectral analysis engine.

The reference computes one 32768-point complex DFT per *visible screen
column*, on demand, on a CPU worker thread (spec.cpp:44-66): the window is
anchored at the column's end sample, samples before the column's start are
attenuated by an exponential decay ``exp(-2.5e-4 * (start - i))`` (NOT a Hann
window), out-of-bounds samples are zero, and the output is the magnitude of
the first 16384 bins normalized by 32768.

The device design inverts this: *batch all requested columns into one
jitted program* — a fused gather (frame extraction) + decay mask + batched
FFT + magnitude.  A whole 4K-wide viewport is one device call instead of
4000 incremental FFTW jobs, and whole-track pyramids are one big batch.
The FFT is XLA's (cuFFT on a GPU).

A modern Hann STFT mode (2048-pt, 75% overlap; BASELINE.json configs) is also
provided for the phase-vocoder and pitch engines.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, Config


def _extract_frames(wav: jnp.ndarray, start: jnp.ndarray, end: jnp.ndarray, size: int):
    """Gather end-anchored frames with the reference's decay pre-window.

    ``start``/``end`` are int32 (B,) sample ranges; frame b covers absolute
    sample indices [end[b] - size, end[b]) (spec.cpp:47).  Returns (B, size)
    float32 frames with decay and zero-fill applied.
    """
    n = wav.shape[0]
    pos = jnp.arange(size, dtype=jnp.int32)[None, :]  # (1, size)
    idx = end[:, None] - size + pos  # (B, size) absolute sample index
    in_bounds = (idx >= 0) & (idx < n)
    vals = wav[jnp.clip(idx, 0, n - 1)]
    # Decay applies where i < start (spec.cpp:56-58); expf in float32.
    dist = (start[:, None] - idx).astype(jnp.float32)
    decay = jnp.where(dist > 0, jnp.exp(jnp.float32(-2.5e-4) * dist), 1.0)
    return jnp.where(in_bounds, vals * decay, 0.0)


@partial(jax.jit, static_argnames=("size",))
def spectrogram_columns_device(
    wav: jnp.ndarray,
    start: jnp.ndarray,
    end: jnp.ndarray,
    size: int = DEFAULT_CONFIG.spectr_size,
) -> jnp.ndarray:
    """Batched reference-parity spectrogram columns.

    Returns (B, size // 2) float32 magnitudes normalized by ``size``
    (spec.cpp:62-64).
    """
    frames = _extract_frames(wav, start, end, size)
    spec = jnp.fft.fft(frames)
    mags = jnp.abs(spec[:, : size // 2]) / size
    return mags.astype(jnp.float32)


def spectrogram_columns(
    wav,
    starts,
    ends,
    config: Config = DEFAULT_CONFIG,
) -> np.ndarray:
    """Host convenience wrapper: NumPy in, NumPy out."""
    wav_dev = jnp.asarray(wav, jnp.float32)
    out = spectrogram_columns_device(
        wav_dev,
        jnp.asarray(starts, jnp.int32),
        jnp.asarray(ends, jnp.int32),
        size=config.spectr_size,
    )
    return np.asarray(out)


def view_column_ranges(knots, width: int, start_time: float, range_time: float):
    """Sample ranges for each screen column of a viewport.

    Column x covers warped time [t, t + pixel) with t = start_time +
    x * range_time / width; its spectrum range is [time2Sample(t),
    time2Sample(t + pixel)) (spec-cache.cpp:63-65).
    """
    x = np.arange(width + 1, dtype=np.float64)
    ts = start_time + x * range_time / width
    samples = knots.time_to_sample(ts)
    return samples[:-1].astype(np.int32), samples[1:].astype(np.int32)


# ----------------------------------------------------------------------
# Hann STFT (modern mode) — frames at a fixed hop, centered convention off
# (frames start at hop * i, no centering), 75% overlap default.
# ----------------------------------------------------------------------


def hann_window(size: int, periodic: bool = True) -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    denom = size if periodic else size - 1
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)).astype(np.float32)


def extract_hop_frames(local, size: int, hop: int, n_frames: int):
    """Uniform-hop frame matrix from a contiguous signal, gather-free.

    With whole-hop overlap the frames are ``k = size // hop`` shifted views
    of the (rows, hop) reshape (pure bandwidth); otherwise an index-gather
    fallback.  Shared by the pitch engine and the sharded analysis paths.
    """
    if size % hop == 0:
        k = size // hop
        n_rows = n_frames + k
        need = n_rows * hop
        n_local = local.shape[-1]
        padded = (
            local[:need] if n_local >= need else jnp.pad(local, (0, need - n_local))
        )
        rows = padded.reshape(n_rows, hop)
        return jnp.concatenate([rows[d : d + n_frames] for d in range(k)], axis=1)
    pos = jnp.arange(size, dtype=jnp.int32)[None, :]
    idx = (jnp.arange(n_frames, dtype=jnp.int32) * hop)[:, None] + pos
    n = local.shape[-1]
    return jnp.where(idx < n, local[jnp.clip(idx, 0, n - 1)], 0.0)


def num_frames(n_samples: int, size: int, hop: int) -> int:
    if n_samples < size:
        return 1
    return 1 + (n_samples - size) // hop


@partial(jax.jit, static_argnames=("size", "hop", "n_frames"))
def stft_device(
    wav: jnp.ndarray,
    window: jnp.ndarray,
    size: int,
    hop: int,
    n_frames: int,
) -> jnp.ndarray:
    """Batched one-shot STFT: (n_frames, size // 2 + 1) complex64."""
    n = wav.shape[0]
    pos = jnp.arange(size, dtype=jnp.int32)[None, :]
    idx = (jnp.arange(n_frames, dtype=jnp.int32) * hop)[:, None] + pos
    vals = jnp.where(idx < n, wav[jnp.clip(idx, 0, n - 1)], 0.0)
    frames = vals * window[None, :]
    return jnp.fft.rfft(frames)


def stft_mags_device(
    wav: jnp.ndarray,
    window: jnp.ndarray,
    size: int,
    hop: int,
    n_frames: int,
    scale: float = 1.0,
) -> jnp.ndarray:
    """``|STFT|`` of the first size//2 bins — (n_frames, size//2) f32.

    XLA rfft + |.|: the frame gather fuses into the FFT's input producer
    and the magnitude into its consumer.
    """
    spec = stft_device(wav, window, size, hop, n_frames)
    return (jnp.abs(spec[:, : size // 2]) * scale).astype(jnp.float32)


def stft(wav, config: Config = DEFAULT_CONFIG, *, size=None, hop=None):
    """Host wrapper; returns (frames, hop) with frames complex64 NumPy."""
    size = size or config.stft_size
    hop = hop or config.stft_hop
    wav = np.asarray(wav, np.float32)
    nf = num_frames(len(wav), size, hop)
    win = jnp.asarray(hann_window(size))
    out = stft_device(jnp.asarray(wav), win, size, hop, nf)
    return np.asarray(out), hop


@partial(jax.jit, static_argnames=("size", "hop", "out_len", "normalize"))
def istft_device(
    frames: jnp.ndarray,
    window: jnp.ndarray,
    size: int,
    hop: int,
    out_len: int,
    normalize: bool = True,
) -> jnp.ndarray:
    """Overlap-add inverse STFT with window-square normalization.

    For whole-hop overlap (``size % hop == 0``, the framework default) the
    overlap-add is *scatter-free*: frames ``g::k`` for each of the
    ``k = size // hop`` phase groups are non-overlapping, so each group
    reshapes directly into a contiguous signal and the k shifted groups
    add elementwise — pure bandwidth, where a 32M-element ``.at[].add``
    scatter would serialize on colliding indices.
    """
    t = jnp.fft.irfft(frames, n=size)
    return ola_device(t, window, size, hop, out_len, normalize)


def ola_device(
    t: jnp.ndarray,  # (F, size) time-domain synthesis frames
    window: jnp.ndarray,
    size: int,
    hop: int,
    out_len: int,
    normalize: bool = True,
    pre_windowed: bool = False,
) -> jnp.ndarray:
    """The overlap-add half of istft_device, for callers that produce the
    time-domain frames themselves (``pre_windowed``: the synthesis window
    is already applied)."""
    n_frames = t.shape[0]
    if not pre_windowed:
        t = t * window[None, :]
    if size % hop == 0:
        k = size // hop
        # Pad to a multiple of k frames; group g holds frames g, g+k, ...
        pad_f = (-n_frames) % k
        tp = jnp.pad(t, ((0, pad_f), (0, 0)))
        total = (n_frames + pad_f) * hop + (k - 1) * hop + size
        out = jnp.zeros(total, jnp.float32)
        for g in range(k):
            seg = tp[g::k].reshape(-1)  # frames g::k tile contiguously
            out = out.at[g * hop : g * hop + seg.shape[0]].add(seg)
        if normalize:
            # Window-square normalization: per-sample position within the
            # hop cycle; sum of w^2 over the k overlapping taps (periodic
            # interior, exact ramps at the edges).
            w2 = window * window
            wsum = jnp.zeros(total, jnp.float32)
            for g in range(k):
                segw = jnp.tile(w2, (n_frames + pad_f) // k)
                # zero the padded frames' contribution (group g holds global
                # frames g + k*j, j = position // size)
                segw = jnp.where(
                    jnp.arange(segw.shape[0]) // size * k + g < n_frames, segw, 0.0
                )
                wsum = wsum.at[g * hop : g * hop + segw.shape[0]].add(segw)
            out = out / jnp.maximum(wsum, 1e-8)
        return out[:out_len] if total >= out_len else jnp.pad(out, (0, out_len - total))
    offs = jnp.arange(n_frames, dtype=jnp.int32) * hop
    idx = offs[:, None] + jnp.arange(size, dtype=jnp.int32)[None, :]
    out = jnp.zeros(out_len, jnp.float32).at[idx.reshape(-1)].add(
        t.reshape(-1), mode="drop"
    )
    if not normalize:
        return out
    wsum = jnp.zeros(out_len, jnp.float32).at[idx.reshape(-1)].add(
        jnp.tile(window * window, (n_frames,)), mode="drop"
    )
    return out / jnp.maximum(wsum, 1e-8)
