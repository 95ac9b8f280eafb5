"""Waveform min/max pyramid.

Reference: ``picks[lvl][i]`` = (min, max) over the block of ``2**(lvl+1)``
samples starting at ``i * 2**(lvl+1)`` — level 0 built from pairs of raw
samples, each next level from pairs of the previous (app.cpp:347-378);
queried per screen pixel through a recursive combiner (app.cpp:380-426) and
memoized per-pixel (app.cpp:451-465).

Device build: the build is a chain of pairwise reduces — one jitted device
program produces every level in a single pass over HBM; the host keeps the
downloaded pyramid (~N floats total) for interactive per-pixel queries, which
are answered *exactly* with a vectorized bottom-up segment decomposition
(every pixel of a 4K viewport in one NumPy pass — replacing the reference's
per-pixel recursion + cache).

The reference recursion is approximate (its aligned block can overhang the
query's left edge, app.cpp:401-408); ``min_max_reference`` reproduces it for
parity, ``query_min_max`` is the exact version the UI uses.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class Pyramid:
    """mins[l], maxs[l]: per-block min/max at block size 2**(l+1)."""

    mins: list[np.ndarray]
    maxs: list[np.ndarray]

    @property
    def n_levels(self) -> int:
        return len(self.mins)


@jax.jit
def _build_levels_device(wav: jnp.ndarray):
    """All pyramid levels in one device program (sizes halve per level)."""
    outs = []
    cur_min = wav
    cur_max = wav
    n = wav.shape[0]
    while n // 2 >= 1:
        m = (n // 2) * 2
        cur_min = jnp.min(cur_min[:m].reshape(-1, 2), axis=1)
        cur_max = jnp.max(cur_max[:m].reshape(-1, 2), axis=1)
        outs.append((cur_min, cur_max))
        n //= 2
        if n <= 1:
            break
    return outs


def build_pyramid(wav, *, device: bool = False) -> Pyramid:
    """Build the pyramid; mirrors the reference's level count: level l exists
    while ``len(wav) > 2**(l+1)`` (app.cpp:352, 366).

    The host build is a ~10 ms O(N) pass and the result lives host-side
    anyway (interactive queries); the device build only pays off when the
    track already lives in HBM and the pyramid feeds device-side consumers
    (the per-level device→host transfers dominate otherwise).
    """
    wav_np = np.asarray(wav, np.float32)
    n = len(wav_np)
    mins: list[np.ndarray] = []
    maxs: list[np.ndarray] = []
    if n <= 2:
        return Pyramid(mins, maxs)
    if device:
        levels = _build_levels_device(jnp.asarray(wav_np))
        levels = [(np.asarray(a), np.asarray(b)) for a, b in levels]
    else:
        levels = []
        cur_min = cur_max = wav_np
        while len(cur_min) // 2 >= 1:
            m = (len(cur_min) // 2) * 2
            cur_min = np.min(cur_min[:m].reshape(-1, 2), axis=1)
            cur_max = np.max(cur_max[:m].reshape(-1, 2), axis=1)
            levels.append((cur_min, cur_max))
    lvl = 0
    while n > (1 << (lvl + 1)) and lvl < len(levels):
        # Reference level l holds exactly n // 2**(l+1) blocks (app.cpp:356).
        cnt = n // (1 << (lvl + 1))
        mins.append(levels[lvl][0][:cnt])
        maxs.append(levels[lvl][1][:cnt])
        lvl += 1
    return Pyramid(mins, maxs)


def query_min_max(pyr: Pyramid, wav: np.ndarray, starts, ends) -> tuple[np.ndarray, np.ndarray]:
    """Exact vectorized min/max over [start, end) for many ranges at once.

    Out-of-range behavior mirrors the reference contract (app.cpp:382-396):
    empty/degenerate → single sample or (0, 0); any bound outside the track →
    (0, 0).
    """
    wav = np.asarray(wav, np.float32)
    n = len(wav)
    s = np.asarray(starts, np.int64).copy()
    e = np.asarray(ends, np.int64).copy()
    q = s.shape[0]
    out_min = np.zeros(q, np.float32)
    out_max = np.zeros(q, np.float32)

    # Order mirrors app.cpp:382-396: degenerate ranges short-circuit before
    # the bounds checks (start >= end returns wav[start] even when end < 0).
    single = s >= e
    valid_single = single & (s >= 0) & (s < n)
    out_min[valid_single] = wav[s[valid_single]]
    out_max[valid_single] = wav[s[valid_single]]

    active = ~single & (s >= 0) & (e >= 0) & (s < n) & (e < n)
    lo = np.where(active, s, 0)
    hi = np.where(active, e, 0)
    mn = np.full(q, np.inf, np.float32)
    mx = np.full(q, -np.inf, np.float32)

    # Level -1 = raw samples, then pyramid levels with block 2**(l+1).
    level = -1
    while np.any(lo < hi):
        if level == -1:
            vals_min = vals_max = wav
        elif level < pyr.n_levels:
            vals_min, vals_max = pyr.mins[level], pyr.maxs[level]
        else:
            # Blocks larger than any stored level: fall back to raw remainder.
            rem = lo < hi
            scale = 1 << (level + 1)
            for i in np.nonzero(rem)[0]:
                seg = wav[lo[i] * scale : hi[i] * scale]
                if len(seg):
                    mn[i] = min(mn[i], seg.min())
                    mx[i] = max(mx[i], seg.max())
            lo = hi.copy()
            break
        take_left = (lo < hi) & (lo % 2 == 1)
        il = np.where(take_left, np.minimum(lo, len(vals_min) - 1), 0)
        mn = np.where(take_left & (lo < len(vals_min)), np.minimum(mn, vals_min[il]), mn)
        mx = np.where(take_left & (lo < len(vals_max)), np.maximum(mx, vals_max[il]), mx)
        lo = lo + take_left

        take_right = (lo < hi) & (hi % 2 == 1)
        ir = np.where(take_right, np.minimum(hi - 1, len(vals_min) - 1), 0)
        mn = np.where(take_right & (hi - 1 < len(vals_min)), np.minimum(mn, vals_min[ir]), mn)
        mx = np.where(take_right & (hi - 1 < len(vals_max)), np.maximum(mx, vals_max[ir]), mx)
        hi = hi - take_right

        lo //= 2
        hi //= 2
        level += 1

    done = active & np.isfinite(mn)
    out_min[done] = mn[done]
    out_max[done] = mx[done]
    # Ranges that collapsed without contributions (shouldn't happen) → 0.
    return out_min, out_max


def min_max_reference(pyr: Pyramid, wav: np.ndarray, start: int, end: int) -> tuple[float, float]:
    """Parity twin of App::getMinMaxFromRange's recursion (app.cpp:380-426),
    including its left-overhang approximation."""
    wav = np.asarray(wav, np.float32)
    n = len(wav)
    if start >= end:
        if 0 <= start < n:
            return (float(wav[start]), float(wav[start]))
        return (0.0, 0.0)
    if start < 0 or end < 0 or start >= n or end >= n:
        return (0.0, 0.0)
    if end - start == 1:
        return (float(wav[start]), float(wav[start]))
    lvl = int(math.log2(end - start))
    lvl_start = start // (1 << lvl)
    if lvl - 1 >= pyr.n_levels or lvl_start >= len(pyr.mins[lvl - 1]):
        mn, mx = 0.0, 0.0
    else:
        mn, mx = float(pyr.mins[lvl - 1][lvl_start]), float(pyr.maxs[lvl - 1][lvl_start])
    left_end = lvl_start * (1 << lvl)
    if left_end >= start:
        lmn, lmx = min_max_reference(pyr, wav, start, left_end)
        mn, mx = min(mn, lmn), max(mx, lmx)
    right_start = (lvl_start + 1) * (1 << lvl)
    if right_start < end:
        rmn, rmx = min_max_reference(pyr, wav, right_start, end)
        mn, mx = min(mn, rmn), max(mx, rmx)
    return (mn, mx)


def waveform_strip(pyr: Pyramid, wav: np.ndarray, knots, width: int, start_time: float, range_time: float):
    """Per-pixel (min, max) for the waveform lane (app.cpp:451-465): pixel x
    covers warped time [x, x+1) / width * range_time + start_time, mapped to
    source samples through time2Sample."""
    x = np.arange(width + 1, dtype=np.float64)
    ts = start_time + x * range_time / width
    samples = knots.time_to_sample(ts)
    return query_min_max(pyr, wav, samples[:-1], samples[1:])
