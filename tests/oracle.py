"""Literal NumPy transcription of the reference semantics (/root/reference).

These are *oracles* for the test suite: straight-line loops that mirror the
C++ control flow statement-for-statement (including float32 arithmetic where
the reference uses float), so the vectorized device engine can be validated
against them.  They are intentionally slow and unidiomatic.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32


# ----------------------------------------------------------------------
# Maps (app.cpp:1020-1122) — pure (un-memoized) versions.
# ----------------------------------------------------------------------


def sample2time(markers, sample_rate, val):
    """app.cpp:1020-1050; markers = list of (sample, note, dTime, pitchBend)."""
    if val <= 0:
        return 1.0 * val / sample_rate
    prev_sample = 0
    prev_time = 0.0
    for sample, _note, d_time, _bend in markers:
        right_time = prev_time + 1.0 * (sample - prev_sample) / sample_rate + d_time
        if val > prev_sample and val <= sample:
            return prev_time + (val - prev_sample) * (right_time - prev_time) / (
                sample - prev_sample
            )
        prev_sample = sample
        prev_time = right_time
    return prev_time + 1.0 * (val - prev_sample) / sample_rate


def time2sample(markers, sample_rate, val):
    """app.cpp:1052-1082 (returns int, C truncation)."""
    if val <= 0:
        return int(val * sample_rate)
    prev_sample = 0
    prev_time = 0.0
    for sample, _note, d_time, _bend in markers:
        right_time = prev_time + 1.0 * (sample - prev_sample) / sample_rate + d_time
        if val > prev_time and val <= right_time:
            return int(
                prev_sample + (val - prev_time) * (sample - prev_sample) / (right_time - prev_time)
            )
        prev_sample = sample
        prev_time = right_time
    return int(prev_sample + (val - prev_time) * sample_rate)


def duration(markers, sample_rate, n_samples):
    """app.cpp:1084-1087."""
    return sample2time(markers, sample_rate, n_samples - 1)


def time2pitchbend(markers, sample_rate, n_samples, val):
    """app.cpp:1089-1122 (returns float32)."""
    if val <= 0:
        return F32(0)
    prev_sample = 0
    prev_time = 0.0
    prev_bend = 0.0
    for sample, _note, d_time, bend in markers:
        right_time = prev_time + 1.0 * (sample - prev_sample) / sample_rate + d_time
        if val > prev_time and val <= right_time:
            return F32(prev_bend + (val - prev_time) * (bend - prev_bend) / (right_time - prev_time))
        prev_sample = sample
        prev_time = right_time
        prev_bend = bend
    dur = duration(markers, sample_rate, n_samples)
    if val > dur:
        return F32(0)
    return F32(prev_bend + (val - prev_time) * (0 - prev_bend) / (dur - prev_time))


# ----------------------------------------------------------------------
# Grain table (app.cpp:153-235)
# ----------------------------------------------------------------------


def build_grains(wav, preferred_grain_size=1500):
    """Returns list of (start, length); mirrors App::preproc's grain loop."""
    wav = np.asarray(wav, np.float32)
    n = len(wav)
    grains = []
    start = 0
    if n < preferred_grain_size + 2:  # unsigned-wrap guard; intended: no grains
        return grains

    def is_zc(idx, look):
        if idx < look:
            return False
        if idx >= n - look - 1:
            return False
        for j in range(look):
            if wav[idx - j] >= 0:
                return False
            if wav[idx + 1 + j] < 0:
                return False
        return True

    while start < n - preferred_grain_size - 1:
        found = False
        for i in range(preferred_grain_size):
            idx = start + preferred_grain_size + (i // 2 if i % 2 == 0 else -(i // 2))
            if is_zc(idx, 7):
                grains.append((start, idx - start))
                start = idx
                found = True
                break
        if not found:
            for i in range(start + preferred_grain_size + preferred_grain_size // 2, n - 1):
                if is_zc(i, 3):
                    grains.append((start, i - start))
                    start = i
                    found = True
                    break
            if not found:
                break
    return grains


# ----------------------------------------------------------------------
# Spectrogram column (spec.cpp:44-66)
# ----------------------------------------------------------------------


def spec_column(wav, start, end, spectr_size=32768):
    """End-anchored DFT with exponential pre-window; returns float32 bins."""
    wav = np.asarray(wav, np.float32)
    n = len(wav)
    buf = np.zeros(spectr_size, np.float64)
    p = 0
    for i in range(end - spectr_size, end):
        if i >= n or i < 0:
            buf[p] = 0.0
        elif i >= start:
            buf[p] = wav[i]
        else:
            buf[p] = F32(math.exp(-2.5e-4 * (start - i))) * wav[i]  # expf — f32
        p += 1
    out = np.fft.fft(buf)  # double precision, like fftw_plan_dft_1d
    mags = np.abs(out[: spectr_size // 2]) / spectr_size
    return mags.astype(np.float32)


# ----------------------------------------------------------------------
# Granular renderer (app.cpp:294-345) and offline export (app.cpp:1194-1215)
# ----------------------------------------------------------------------


def process(wav, grains, markers, sample_rate, cursor, out):
    """App::process — renders one grain into ``out`` (a Python list).

    Returns dt (seconds produced).  ``grains`` = list of (start, length)
    sorted by start (std::map iteration order).
    """
    wav = np.asarray(wav, np.float32)
    n_samples = len(wav)
    bend = time2pitchbend(markers, sample_rate, n_samples, cursor)
    rate = F32(2.0) ** F32(F32(bend) / F32(12))  # powf(2, pitchBend / 12)

    sample = time2sample(markers, sample_rate, cursor)
    # grains.lower_bound(sample): first start >= sample
    gi = None
    for k, (s, _l) in enumerate(grains):
        if s >= sample:
            gi = k
            break
    if gi is None:
        for _ in range(1500):
            out.append(F32(0))
        return 0.0

    gstart, glen = grains[gi]
    grain = wav[gstart : gstart + glen]

    # nextGrainFirstSample (app.cpp:312-329)
    sz = 0
    i = 0
    while True:
        x = F32(F32(i) * rate)  # i * rate + bias, bias == 0, float arithmetic
        idx = int(np.floor(x))
        if idx >= glen:
            break
        sz += 1
        i += 1
    sample2 = time2sample(markers, sample_rate, cursor + 1.0 * sz / sample_rate)
    next_first = F32(0)
    for s, _l in grains:
        if s >= sample2:
            next_first = wav[s]
            break

    # resample loop (app.cpp:332-343)
    sz = 0
    i = 0
    while True:
        x = F32(F32(i) * rate)
        idxf = np.floor(x)
        cur_bias = F32(x - idxf)
        idx = int(idxf)
        if idx >= glen:
            break
        hi = grain[idx + 1] if idx + 1 < glen else next_first
        out.append(F32(F32(F32(1.0) - cur_bias) * grain[idx] + cur_bias * hi))
        sz += 1
        i += 1
    return 1.0 * sz / sample_rate


def export(wav, grains, markers, sample_rate):
    """App::exportWav's render loop (app.cpp:1200-1207); returns float32 array
    (pre-int16-quantization)."""
    out: list = []
    cursor = 0.0
    while True:
        dt = process(wav, grains, markers, sample_rate, cursor, out)
        if dt <= 0.0:
            break
        cursor += dt
    return np.array(out, np.float32)


# ----------------------------------------------------------------------
# Min/max pyramid (app.cpp:347-426)
# ----------------------------------------------------------------------


def calc_picks(wav):
    """App::calcPicks — picks[lvl][i] = (min, max) over blocks of 2**(lvl+1)."""
    wav = np.asarray(wav, np.float32)
    picks = []
    lvl = 0
    if len(wav) <= (1 << (lvl + 1)):
        return picks
    cur = [
        (min(wav[i * 2], wav[i * 2 + 1]), max(wav[i * 2], wav[i * 2 + 1]))
        for i in range(len(wav) // 2)
    ]
    picks.append(cur)
    while True:
        lvl += 1
        if len(wav) <= (1 << (lvl + 1)):
            break
        prev = picks[lvl - 1]
        cur = [
            (min(prev[i * 2][0], prev[i * 2 + 1][0]), max(prev[i * 2][1], prev[i * 2 + 1][1]))
            for i in range(len(wav) // (1 << (lvl + 1)))
        ]
        picks.append(cur)
    return picks


def min_max_from_range(wav, picks, start, end):
    """App::getMinMaxFromRange (app.cpp:380-426), recursive."""
    wav = np.asarray(wav, np.float32)
    n = len(wav)
    if start >= end:
        if 0 <= start < n:
            return (wav[start], wav[start])
        return (0.0, 0.0)
    if start < 0 or end < 0:
        return (0.0, 0.0)
    if start >= n or end >= n:
        return (0.0, 0.0)
    if end - start == 1:
        return (wav[start], wav[start])
    lvl = int(math.log2(end - start))
    lvl_start = start // (1 << lvl)
    if lvl - 1 >= len(picks) or lvl_start >= len(picks[lvl - 1]):
        mn, mx = 0.0, 0.0
    else:
        mn, mx = picks[lvl - 1][lvl_start]
    left_end = lvl_start * (1 << lvl)
    if left_end >= start:
        lmn, lmx = min_max_from_range(wav, picks, start, left_end)
        mn, mx = min(mn, lmn), max(mx, lmx)
    right_start = (lvl_start + 1) * (1 << lvl)
    if right_start < end:
        rmn, rmx = min_max_from_range(wav, picks, right_start, end)
        mn, mx = min(mn, rmn), max(mx, rmx)
    return (mn, mx)


def render_plan_f32(wav, plan):
    """Float32 evaluation of a granular render plan, one step at a time:
    the reference's f32(i) * rate stepping, the lerp, and the next-grain
    seam of app.cpp:312-329 — independent of the device's segmented
    broadcasts.  Returns the grain output (no tail)."""
    wav = np.asarray(wav, F32)
    n = len(wav)
    out = np.zeros(int(plan.out_offset[-1]) if len(plan.out_offset) else 0, F32)
    for s in range(plan.n_steps):
        sz = int(plan.sz[s])
        o0 = int(plan.out_offset[s])
        x = np.arange(sz, dtype=F32) * plan.rate[s]
        idx = np.floor(x)
        frac = (x - idx).astype(F32)
        src = int(plan.grain_start[s]) + idx.astype(np.int64)
        glen = int(plan.grain_len[s])
        lo = wav[np.clip(src, 0, n - 1)]
        seam = int(plan.seam_src[s])
        hi_seam = wav[seam] if 0 <= seam < n else F32(0.0)
        in_grain = idx.astype(np.int64) + 1 < glen
        hi = np.where(in_grain, wav[np.clip(src + 1, 0, n - 1)], hi_seam)
        out[o0:o0 + sz] = (F32(1.0) - frac) * lo + frac * hi
    return out


# ----------------------------------------------------------------------
# Colormap (spec-cache.cpp:79-96)
# ----------------------------------------------------------------------


def colormap(mags, k):
    """Returns uint8 (n, 3) RGB; mirrors SpecCache::populateTex's mapping."""
    out = np.zeros((len(mags), 3), np.uint8)
    for i, m in enumerate(mags):
        tmp = float(np.clip(F32(m) * F32(k), 0.0, 255.0))
        if tmp < 255 // 3:
            out[i] = (int(tmp) & 0xFF, 0, 0)
        elif tmp < 2 * 255 // 3:
            a = (tmp - 255 // 3) / (255 // 3) * 3.141592 / 2
            out[i] = (int(tmp * math.cos(a)) & 0xFF, int(tmp * math.sin(a)) & 0xFF, 0)
        else:
            w = int((tmp - 2 * 255 // 3) * 3) & 0xFF
            out[i] = (w, int(tmp) & 0xFF, w)
    return out
