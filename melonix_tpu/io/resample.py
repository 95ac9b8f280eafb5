"""Band-limited sample-rate conversion (added capability; BASELINE config #5).

The reference never resamples: libswresample converts to mono float at the
file's own rate (app.cpp:669-684) and playback/export stay there.  Session
workflows need real SRC (48 kHz sessions to 44.1 kHz masters, etc.).

**Polyphase-as-matmul.**  For a rational ratio up/down, output
``n = q*up + p`` reads source ``q*down + o_p + t`` with a per-phase
windowed-sinc row ``h_p``.  Folding the phase axis into a matrix turns the
whole resampler into

    out[q, p] = sum_r ( X2[q + r] @ H_r )[p],

where ``X2`` is the padded source viewed as (rows, down) — a *reshape*, not
a gather — and ``H_r`` are small host-built (down, up) filter banks (r
ranges over the few source rows a tap window spans).  That is a handful
of dense matmuls: ~5 GFLOP for a 3-minute 44.1->48 kHz conversion, where
the naive per-output formulation needs ~540M gathers.  ~80 dB stopband at
the default 64 taps / Kaiser beta 8.6; the kernel stretches by the
decimation ratio when downsampling.

Deliberately NOT an FFT resampler: track lengths are arbitrary, and an FFT
of a non-smooth length is slow or falls back to a dense O(n^2) DFT.
"""

from __future__ import annotations

from functools import lru_cache, partial
from math import gcd

import jax
import jax.numpy as jnp
import numpy as np

TAPS = 64  # zero-crossing span of the prototype at the output Nyquist
BETA = 8.6  # Kaiser beta: ~80 dB stopband


@lru_cache(maxsize=16)
def _filter_banks(up: int, down: int, taps: int):
    """Host: per-shift filter banks H_r (down, up) + front pad in rows.

    Phase p (output n = q*up + p) reads source samples
    ``q*down + floor(p*down/up) + j`` for j in [-half, half); tap weights
    are the Kaiser-windowed sinc at (j - frac_p), anti-alias-scaled when
    decimating.  Weights are normalized per phase (exact DC).
    """
    ratio = down / up
    fc = 0.5 * min(1.0, 1.0 / ratio) * 0.97
    eff_taps = int(2 * -(-int(taps * max(1.0, ratio)) // 2))
    half = eff_taps // 2
    # Front pad (in source rows) so every tap index is non-negative.
    front_rows = -(-half // down)
    F = front_rows * down

    p = np.arange(up)
    o_p = (p * down) // up
    frac_p = (p * down) / up - o_p
    j = np.arange(eff_taps) - half + 1  # [-half+1, half]
    t_arg = j[None, :] - frac_p[:, None]  # (up, taps)
    window = np.where(
        np.abs(t_arg) <= half,
        np.i0(BETA * np.sqrt(np.clip(1.0 - (t_arg / half) ** 2, 0.0, 1.0))) / np.i0(BETA),
        0.0,
    )
    w = 2.0 * fc * np.sinc(2.0 * fc * t_arg) * window
    w = w / w.sum(axis=1, keepdims=True)  # exact DC per phase

    c_global = o_p[:, None] + j[None, :] + F  # (up, taps) >= 0
    r_idx = c_global // down
    c_idx = c_global % down
    n_shifts = int(r_idx.max()) + 1
    banks = np.zeros((n_shifts, down, up), np.float64)
    for pp in range(up):
        for tt in range(eff_taps):
            banks[r_idx[pp, tt], c_idx[pp, tt], pp] += w[pp, tt]
    return banks.astype(np.float32), front_rows, n_shifts


@partial(jax.jit, static_argnames=("m_out", "down", "front_rows"))
def _polyphase_device(x2, banks, m_out: int, down: int, front_rows: int):
    """x2: (C, rows, down) padded source view; banks (R, down, up)."""
    del down, front_rows  # encoded in the shapes / bank construction
    r_shifts = banks.shape[0]
    # precision=HIGHEST: a default-precision f32 matmul may run in bf16 or
    # TF32 on an accelerator, which would cap the resampler far above its
    # 80 dB Kaiser design.
    acc = jnp.einsum(
        "crd,du->cru", x2[:, 0:m_out], banks[0],
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    )
    for r in range(1, r_shifts):
        acc = acc + jnp.einsum(
            "crd,du->cru", x2[:, r : r + m_out], banks[r],
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    return acc  # (C, m_out, up)


def resample(x, sr_in: int, sr_out: int, *, taps: int = TAPS) -> np.ndarray:
    """Resample float32 audio (n,) or (n, channels) from sr_in to sr_out."""
    x = np.asarray(x, np.float32)
    if sr_in == sr_out:
        return x
    g = gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    n_in = len(x)
    n_out = int(n_in * up / down)
    if n_in == 0 or n_out == 0:
        return np.zeros((0,) + x.shape[1:], np.float32)

    banks, front_rows, n_shifts = _filter_banks(up, down, taps)
    m_out = -(-n_out // up)
    rows_needed = front_rows + m_out + n_shifts
    moved = x.T if x.ndim == 2 else x[None]  # (C, n)
    pad_total = rows_needed * down
    xp = np.zeros((moved.shape[0], pad_total), np.float32)
    xp[:, front_rows * down : front_rows * down + n_in] = moved
    x2 = xp.reshape(moved.shape[0], rows_needed, down)

    out = np.asarray(
        _polyphase_device(
            jnp.asarray(x2), jnp.asarray(banks), m_out, down, front_rows
        )
    ).reshape(moved.shape[0], m_out * up)[:, :n_out]
    return out.T if x.ndim == 2 else out[0]
