"""Granular pitch/time renderer — the core DSP.

Reference semantics (app.cpp:294-345): ``process(cursor)`` renders one grain;
the playback rate is ``2^(pitchBend(cursor)/12)``; the grain is chosen by
``grains.lower_bound(time2Sample(cursor))`` — the time-warp map thereby
repeats/skips grains to time-stretch; the grain is linearly resampled by
stepping ``i * rate`` with the final in-grain sample interpolating toward the
*next* grain's first sample (the seam), where "next" is found by projecting
the output duration back through the warp map (app.cpp:312-329).  The offline
export (app.cpp:1194-1215) chains ``process`` from t=0 until the grain table
is exhausted, then emits ``preferred_grain_size`` zeros.

Host/device decomposition:

* **Plan (host, NumPy)** — the cursor chain is sequential but tiny
  (~N/1500 steps, O(log markers) each): it touches only the grain table and
  the marker maps, never the audio.  ``build_render_plan`` emits fixed-shape
  per-step arrays (source start, length, f32 rate, output span, seam index).
* **Execute (device, one fused gather)** — every output sample is an
  independent ``(1-frac)*wav[src] + frac*wav[src2]`` with indices derived
  from its step's scalars; ``render_from_plan`` evaluates the whole track in
  one jitted program (gather + lerp, HBM-bandwidth-bound).  Rate arithmetic
  is done in float32 to match the reference's ``i * rate`` float stepping.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, Config
from .grains import GrainTable
from .maps import MapKnots

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    """Per-step arrays describing a granular render; see module docstring."""

    grain_start: np.ndarray  # int32 (S,) source start of the chosen grain
    grain_len: np.ndarray  # int32 (S,)
    rate: np.ndarray  # float32 (S,) resampling rate 2^(bend/12)
    sz: np.ndarray  # int64 (S,) output samples produced by the step
    out_offset: np.ndarray  # int64 (S+1,) cumulative output offsets
    seam_src: np.ndarray  # int32 (S,) source index of the seam sample; -1 → 0.0
    tail_zeros: int  # zeros appended after the last grain (app.cpp:306-307)
    sample_rate: int

    @property
    def n_steps(self) -> int:
        return len(self.grain_start)

    @property
    def total_out(self) -> int:
        base = int(self.out_offset[-1]) if len(self.out_offset) else 0
        return base + self.tail_zeros

    @property
    def cursor_end(self) -> float:
        """Warped-time cursor after the last planned step."""
        return float(self.out_offset[-1]) / self.sample_rate


def _step_output_count(length: int, rate: F32) -> int:
    """Number of output samples for one grain: count of i >= 0 with
    floor(float32(i * rate)) < length (app.cpp:332-339, float arithmetic).

    O(1): the crossing index is within a couple of ulps of length/rate; probe
    the float32 product around it rather than materializing the ramp.
    """
    r = float(rate)
    n0 = int(length / r)  # first candidate near the crossing
    lo = max(0, n0 - 2)
    for i in range(lo, n0 + 8):
        if np.floor(F32(i) * rate) >= length:
            return i
    # Pathological rounding (not observed): fall back to a vector scan.
    i = np.arange(max(16, 2 * n0 + 16), dtype=np.float32)
    over = np.floor(i * F32(rate)) >= length
    return int(np.argmax(over)) if over.any() else len(i)


def build_render_plan(
    grains: GrainTable,
    knots: MapKnots,
    *,
    start_cursor: float = 0.0,
    min_out: int | None = None,
    config: Config = DEFAULT_CONFIG,
    backend: str = "auto",
) -> RenderPlan:
    """Walk the cursor chain (host control plane) and emit a RenderPlan.

    With ``min_out=None`` this mirrors ``App::exportWav``'s full-track loop
    (terminates when the grain table is exhausted, appending the trailing
    zeros the final ``process`` call pushes).  With ``min_out`` set it stops
    once at least that many output samples are planned (streaming/playback
    use, mirroring the backlog loop app.cpp:274-276) and appends no tail.

    ``backend="auto"`` uses the native C++ walker when built (identical
    double/float arithmetic; ~100x faster than the Python loop), else NumPy.
    """
    if backend in ("auto", "native"):
        from ..runtime import native

        lib = native.try_load()
        if lib is not None:
            gs, gl, rate, sz, seam, tail = native.build_plan(
                lib, grains, knots, start_cursor, min_out, config.preferred_grain_size
            )
            offs = np.zeros(len(sz) + 1, np.int64)
            np.cumsum(sz, out=offs[1:])
            return RenderPlan(
                grain_start=gs,
                grain_len=gl,
                rate=rate,
                sz=sz,
                out_offset=offs,
                seam_src=seam,
                tail_zeros=tail,
                sample_rate=knots.sample_rate,
            )
        if backend == "native":
            raise RuntimeError("native runtime not built; run `make -C native`")
    starts = grains.starts
    sr = knots.sample_rate
    pgs = config.preferred_grain_size

    g_start: list[int] = []
    g_len: list[int] = []
    g_rate: list[F32] = []
    g_sz: list[int] = []
    g_seam: list[int] = []

    cursor = float(start_cursor)
    total = 0
    tail = 0
    n_grains = len(starts)
    while True:
        if min_out is not None and total >= min_out:
            break
        bend = knots.time_to_pitch_bend(cursor)  # float32 (app.cpp:296)
        rate = F32(2.0) ** F32(F32(bend) / F32(12.0))  # powf(2, bend/12)
        sample = knots.time_to_sample(cursor)
        gi = int(np.searchsorted(starts, sample, side="left"))
        if gi >= n_grains:
            tail = pgs  # app.cpp:303-309: 1500 zeros, then playback stops
            break
        length = int(grains.lengths[gi])
        sz = _step_output_count(length, rate)
        # Seam: project the output span through the warp map (app.cpp:312-329).
        s2 = knots.time_to_sample(cursor + 1.0 * sz / sr)
        g2 = int(np.searchsorted(starts, s2, side="left"))
        seam = int(starts[g2]) if g2 < n_grains else -1
        g_start.append(int(starts[gi]))
        g_len.append(length)
        g_rate.append(rate)
        g_sz.append(sz)
        g_seam.append(seam)
        total += sz
        cursor += 1.0 * sz / sr  # dt returned by process (app.cpp:344)

    offs = np.zeros(len(g_sz) + 1, np.int64)
    np.cumsum(np.asarray(g_sz, np.int64), out=offs[1:])
    return RenderPlan(
        grain_start=np.asarray(g_start, np.int32),
        grain_len=np.asarray(g_len, np.int32),
        rate=np.asarray(g_rate, np.float32),
        sz=np.asarray(g_sz, np.int64),
        out_offset=offs,
        seam_src=np.asarray(g_seam, np.int32),
        tail_zeros=tail,
        sample_rate=sr,
    )


# ----------------------------------------------------------------------
# Device execution
# ----------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return m * -(-n // m)


@partial(jax.jit, static_argnames=("out_len",))
def render_device(
    wav: jnp.ndarray,
    offsets: jnp.ndarray,  # int32 (S,) output start of each step (out_offset[:-1])
    gstart: jnp.ndarray,  # int32 (S,)
    rate_bits: jnp.ndarray,  # int32 (S,) float32 bit patterns of the rates
    n_valid_out,
    out_len: int,
    fix_idx: jnp.ndarray,  # int32 (K,) seam-fix output positions (out_len = drop)
    fix_val: jnp.ndarray,  # float32 (K,)
) -> jnp.ndarray:
    """Two-gather granular render.

    Per-step values are not gathered per sample.  Each per-step constant
    becomes a *segmented broadcast*: scatter its successive differences at
    the segment-start output positions, then prefix-sum (an int32 cumsum,
    exact in any summation order).  Rates stay bit-exact through the sum by
    broadcasting their int32 BIT PATTERNS (wrapping integer arithmetic) and
    bitcasting back to float32.  Only the two waveform reads (lo/hi) remain
    as real gathers.  The next-grain seam (app.cpp:312-329) is wav[src+1]
    everywhere except across time-warp jumps, which arrive as a precomputed
    host scatter (``fix_*``; see seam_fixes).
    """
    n = wav.shape[0]
    j = jnp.arange(out_len, dtype=jnp.int32)

    def seg_i32(vals):
        d = jnp.zeros(out_len, jnp.int32).at[offsets[1:]].add(
            jnp.diff(vals), mode="drop"
        )
        return vals[0] + jnp.cumsum(d)

    off = seg_i32(offsets)
    gs = seg_i32(gstart)
    r = jax.lax.bitcast_convert_type(seg_i32(rate_bits), jnp.float32)
    i = (j - off).astype(jnp.float32)
    x = i * r  # float32, matches the reference's f32(i) * rate
    idx = jnp.floor(x)
    frac = x - idx
    src = gs + idx.astype(jnp.int32)
    lo = wav[jnp.clip(src, 0, n - 1)]
    hi = wav[jnp.clip(src + 1, 0, n - 1)]
    out = (1.0 - frac) * lo + frac * hi
    out = jnp.where(j < n_valid_out, out, 0.0)
    return out.at[fix_idx].set(fix_val, mode="drop")


def render_device_args(plan: RenderPlan, wav: np.ndarray, out_len: int):
    """Device operands for render_device (per-plan, tiny uploads)."""
    fix_idx, fix_val = seam_fixes(plan, wav, out_len)
    return (
        np.asarray(plan.out_offset[:-1], np.int32),
        np.asarray(plan.grain_start, np.int32),
        plan.rate.astype(np.float32).view(np.int32).copy(),
        np.int32(plan.out_offset[-1]) if len(plan.out_offset) else np.int32(0),
        out_len,
        fix_idx,
        fix_val,
    )


def seam_fixes(plan: RenderPlan, wav: np.ndarray, out_len: int):
    """Output positions + exact values where hi != wav[src+1] (warp jumps,
    track-end grains, seam_src == -1), padded to a static bucket."""
    wav = np.asarray(wav, np.float32)
    n = len(wav)
    gend = plan.grain_start.astype(np.int64) + plan.grain_len
    differs = (plan.seam_src != gend) | (gend >= n) | (plan.seam_src < 0)
    idx_list: list[np.ndarray] = []
    val_list: list[np.ndarray] = []
    for s in np.where(differs)[0]:
        length = int(plan.grain_len[s])
        rate = plan.rate[s]
        sz = int(plan.sz[s])
        i = np.arange(sz, dtype=np.float32)
        x = i * rate
        ii = np.floor(x)
        last = ii == length - 1  # samples whose hi is the seam
        if not last.any():
            continue
        frac = (x - ii)[last].astype(np.float32)
        lo = wav[int(plan.grain_start[s]) + length - 1]
        seam = plan.seam_src[s]
        hi = wav[seam] if 0 <= seam < n else np.float32(0.0)
        vals = (np.float32(1.0) - frac) * lo + frac * hi
        pos = int(plan.out_offset[s]) + np.where(last)[0]
        idx_list.append(pos.astype(np.int64))
        val_list.append(vals.astype(np.float32))
    if idx_list:
        idx = np.concatenate(idx_list)
        val = np.concatenate(val_list)
        keep = idx < out_len
        idx, val = idx[keep], val[keep]
    else:
        idx = np.zeros(0, np.int64)
        val = np.zeros(0, np.float32)
    k = max(256, 256 * -(-len(idx) // 256))
    out_idx = np.full(k, out_len, np.int64)  # out-of-range → dropped
    out_val = np.zeros(k, np.float32)
    out_idx[: len(idx)] = idx
    out_val[: len(val)] = val
    return out_idx.astype(np.int32), out_val


def render(
    wav,
    plan: RenderPlan,
    *,
    pad_to: int = 8192,
    include_tail: bool = True,
) -> np.ndarray:
    """Execute a RenderPlan on device; returns float32 host array.

    Output length buckets to multiples of ``pad_to`` so repeated renders of
    similar lengths reuse the compiled program.
    """
    n_grain_out = int(plan.out_offset[-1]) if len(plan.out_offset) else 0
    total = plan.total_out if include_tail else n_grain_out
    if total == 0:
        return np.zeros(0, np.float32)
    if plan.n_steps == 0:
        return np.zeros(total, np.float32)
    out_len = _round_up(total, pad_to)
    wav_np = np.asarray(wav, np.float32)
    offs, gs, rb, n_valid, _, fix_idx, fix_val = render_device_args(plan, wav_np, out_len)
    out = render_device(
        jnp.asarray(wav_np),
        jnp.asarray(offs),
        jnp.asarray(gs),
        jnp.asarray(rb),
        n_valid,
        out_len,
        jnp.asarray(fix_idx),
        jnp.asarray(fix_val),
    )
    return np.asarray(out[:total])


def render_track(
    wav,
    grains: GrainTable,
    knots: MapKnots,
    *,
    config: Config = DEFAULT_CONFIG,
) -> np.ndarray:
    """Full offline render: plan + device execution (export parity path)."""
    plan = build_render_plan(grains, knots, config=config)
    return render(wav, plan)
