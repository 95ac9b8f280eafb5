"""Real-time playback — the SDL audio callback equivalent.

Reference (app.cpp:254-292): the callback keeps a backlog ``restWav`` and
calls ``process`` until it holds ``buffer + preferred_grain_size`` samples,
copies out one buffer, and advances ``cursorSec`` by emitted/sampleRate; it
auto-stops at the track end or t<0 and fades on stop (the reference's fade
loop is a no-op over zeros with an off-by-one OOB write, app.cpp:259-271 —
we implement the *intended* declick: a 100-sample ramp from the last
delivered sample into silence).

The pull model is host-side and backend-agnostic: any audio shell (SDL,
sounddevice, a test harness) calls ``callback(n)`` for the next n float32
samples.  Grain steps are planned with the same ``build_render_plan`` walk
as the offline export and rendered with float32 NumPy arithmetic that is
bit-identical to the device gather kernel — playback and export share one
engine (SURVEY.md §3.4: the export path is the ground truth).

Live edits: the editor's ``invalidate()`` drops the planned-ahead backlog so
the next buffer reflects the new marker state (the reference achieves the
same by locking the audio thread around map edits, app.cpp:110-112 et al.).
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, Config
from .grains import GrainTable
from .maps import MapKnots
from .render import build_render_plan

F32 = np.float32
FADE = 100  # declick ramp length (app.cpp:264)
RING_CAPACITY = 1 << 20  # 4 MB of float32 backlog headroom
# Live PV read-ahead high watermark (samples).  The reference refills to
# buffer + pgs (app.cpp:274-276: 1024 + 1500 ≈ 57 ms) against a local
# in-process renderer; the PV stream's refill is a blocking device
# dispatch + download, so topping up that little EVERY pull pays one
# dispatch per 23 ms buffer and one slow refill underruns the deadline.
# Watermark hysteresis instead: refill only when the backlog drops below
# the reference's buffer + pgs contract (low watermark), then fill to
# 32768 (~743 ms) in one burst — ONE dispatch per ~26 pulls, with the
# accumulated lead absorbing a slow refill.
# Adds little to edit latency: edits drop the backlog, and the FIRST
# read of a fresh stream covers only the deadline plus a small lead bank
# (PV_FIRST_READ = 8192, a 32 KB download — same single chunk advance on
# device as a minimal read).  The first read's size is set by the SECOND
# refill's budget: the full burst lands ~6 deadline-free pulls later,
# behind the banked lead.  Both values are kept from an earlier
# deployment; re-deriving them from the refill cost measured on this
# device is open work (ROADMAP).
PV_LIVE_AHEAD = 32768
PV_FIRST_READ = 8192


class _NpBacklog:
    """Pure-NumPy FIFO fallback when the native runtime is not built."""

    def __init__(self):
        self._buf = np.zeros(0, np.float32)

    def avail(self) -> int:
        return len(self._buf)

    __len__ = avail

    def write(self, chunk: np.ndarray) -> None:
        self._buf = np.concatenate([self._buf, chunk])

    def read(self, n: int) -> np.ndarray:
        out = self._buf[:n]
        self._buf = self._buf[n:]
        return out

    def clear(self) -> None:
        self._buf = np.zeros(0, np.float32)


class _RingBacklog:
    """Lock-free SPSC ring from the native runtime (mlx_ring_*): the render
    producer and the audio-callback consumer never contend — the same
    isolation the reference gets from SDL_LockAudioDevice bracketing
    (app.cpp:110-112), without a lock on the audio thread."""

    def __init__(self, lib, capacity: int = RING_CAPACITY):
        import ctypes

        self._lib = lib
        self._ctypes = ctypes
        self._h = lib.mlx_ring_new(capacity)

    def avail(self) -> int:
        return int(self._lib.mlx_ring_avail(self._h))

    __len__ = avail

    def write(self, chunk: np.ndarray) -> None:
        c = self._ctypes
        chunk = np.ascontiguousarray(chunk, np.float32)
        wrote = int(
            self._lib.mlx_ring_write(
                self._h, chunk.ctypes.data_as(c.POINTER(c.c_float)), len(chunk)
            )
        )
        if wrote != len(chunk):  # ring full: losing audio must be loud
            raise RuntimeError(
                f"playback ring overflow: wrote {wrote}/{len(chunk)} samples"
            )

    def read(self, n: int) -> np.ndarray:
        c = self._ctypes
        out = np.zeros(n, np.float32)
        got = int(
            self._lib.mlx_ring_read(
                self._h, out.ctypes.data_as(c.POINTER(c.c_float)), n
            )
        )
        return out[:got]

    def clear(self) -> None:
        self._lib.mlx_ring_clear(self._h)

    def __del__(self):  # pragma: no cover - interpreter teardown order
        try:
            self._lib.mlx_ring_free(self._h)
        except Exception:
            pass


def _make_backlog():
    from ..runtime import native

    lib = native.try_load()
    if lib is not None and hasattr(lib, "mlx_ring_new"):
        return _RingBacklog(lib)
    return _NpBacklog()


def _render_step_np(wav, start: int, length: int, rate: F32, seam_src: int) -> np.ndarray:
    """One grain step, float32-exact with the device kernel."""
    n0 = int(length / float(rate))
    # First i with floor(f32(i*rate)) >= length (same probe as the planner)
    sz = None
    for i in range(max(0, n0 - 2), n0 + 8):
        if np.floor(F32(i) * rate) >= length:
            sz = i
            break
    if sz is None:
        sz = n0 + 8
    i = np.arange(sz, dtype=np.float32)
    x = i * rate
    idx = np.floor(x)
    frac = (x - idx).astype(np.float32)
    idx = idx.astype(np.int64)
    lo = wav[start + idx]
    hi = np.empty_like(lo)
    in_grain = idx + 1 < length
    hi[in_grain] = wav[start + idx[in_grain] + 1]
    seam_val = wav[seam_src] if seam_src >= 0 else F32(0)
    hi[~in_grain] = seam_val
    return ((F32(1.0) - frac) * lo + frac * hi).astype(np.float32)


class Player:
    def __init__(
        self,
        wav: np.ndarray,
        grains: GrainTable,
        knots: MapKnots,
        *,
        config: Config = DEFAULT_CONFIG,
        engine: str = "granular",
    ):
        self.wav = np.asarray(wav, np.float32)
        self.grains = grains
        self.knots = knots
        self.config = config
        self.sample_rate = knots.sample_rate
        self.cursor_sec = 0.0
        self.is_playing = False
        self.engine = engine  # "granular" | "pv"
        self.formant = False  # PV formant preservation (added capability)
        self.phase_locking = False  # PV identity phase locking (north star)
        self._pv_stream = None  # lazy; dropped on any edit/seek/switch
        self._wav_dev = None  # device-resident samples, uploaded once
        self._backlog = _make_backlog()
        self._last_sample = F32(0)
        self._fading = False
        self._exhausted = False  # grain table done; deliver the tail, then stop

    # -- edit integration ------------------------------------------------

    def set_knots(self, knots: MapKnots) -> None:
        """Marker edit: re-plan from the current cursor (drop lookahead)."""
        self.knots = knots
        self._backlog.clear()
        self._exhausted = False
        self._pv_stream = None  # restart the PV stream at the cursor

    def set_engine(self, engine: str) -> None:
        """Live engine switch; the next buffer comes from the new engine."""
        if engine not in ("granular", "pv"):
            raise ValueError(f"unknown engine: {engine}")
        if engine != self.engine:
            self.engine = engine
            self._backlog.clear()
            self._exhausted = False
            self._pv_stream = None

    def set_formant(self, on: bool) -> None:
        """PV formant preservation, applied live (the PV stream restarts
        at the cursor like an edit).  Granular audio is unaffected, so
        only the value is stored there — no backlog flush (a switch to
        the PV engine replans anyway, set_engine)."""
        on = bool(on)
        if on != self.formant:
            self.formant = on
            if self.engine == "pv":
                self._backlog.clear()
                self._exhausted = False
                self._pv_stream = None

    def set_phase_locking(self, on: bool) -> None:
        """Identity phase locking (Laroche–Dolson), applied live — same
        restart contract as set_formant."""
        on = bool(on)
        if on != self.phase_locking:
            self.phase_locking = on
            if self.engine == "pv":
                self._backlog.clear()
                self._exhausted = False
                self._pv_stream = None

    def toggle(self) -> None:
        if not self.is_playing:
            self._fading = False
            self._exhausted = False
        self.is_playing = not self.is_playing

    def seek(self, t: float) -> None:
        self.cursor_sec = float(np.clip(t, 0.0, self.knots.duration()))
        self._backlog.clear()
        self._exhausted = False
        self._pv_stream = None

    # -- the audio callback ----------------------------------------------

    def callback(self, n: int) -> np.ndarray:
        """Next n mono float32 samples (app.cpp:254-292 semantics)."""
        out = np.zeros(n, np.float32)
        if self.cursor_sec < 0 or self.cursor_sec >= self.knots.duration():
            self.is_playing = False

        if not self.is_playing:
            # Intended declick: ramp the last delivered sample into silence.
            if self._fading:
                k = min(FADE, n)
                ramp = np.linspace(1.0, 0.0, k, endpoint=False, dtype=np.float32)
                out[:k] = self._last_sample * ramp
                self._fading = False
            self._backlog.clear()
            self._last_sample = F32(0)
            return out

        pgs = self.config.preferred_grain_size
        if self.engine == "pv":
            # Quality engine live: the backlog is fed by the forward-only
            # PV stream (chunked stretch + exact phase carry + block
            # resample — engine/pv_stream.py).  Edits/seeks drop the stream
            # so the next buffer reflects the new marker state, same
            # freshness contract as the granular re-plan below.
            if self._pv_stream is None:
                from .pv_stream import PvStream

                if self._wav_dev is None:
                    # One upload per track: every edit/seek restart reuses
                    # the device-resident samples.
                    import jax.numpy as jnp

                    self._wav_dev = jnp.asarray(self.wav)
                self._pv_stream = PvStream(
                    self._wav_dev, self.knots, config=self.config,
                    preserve_formants=self.formant,
                    phase_locking=self.phase_locking,
                    start_sec=self.cursor_sec
                    + self._backlog.avail() / self.sample_rate,
                )
                self._pv_hi = PV_FIRST_READ  # ladder: deadline-only first
            while (not self._exhausted
                   and self._backlog.avail() < n + pgs):  # low watermark
                # One read for the whole deficit up to the current HIGH
                # watermark: the stream satisfies it in a single resample
                # dispatch (one blocking download each).  The first read
                # after a (re)start covers the deadline + a small lead bank
                # (lowest edit->audio latency); every later refill bursts
                # to the full high watermark, landing behind the lead the
                # first read banked (see PV_LIVE_AHEAD / PV_FIRST_READ).
                hi = getattr(self, "_pv_hi", PV_LIVE_AHEAD)
                target = max(n + pgs, hi)
                self._pv_hi = PV_LIVE_AHEAD
                deficit = target - self._backlog.avail()
                self._backlog.write(self._pv_stream.read(max(deficit, 2048)))
                if self._pv_stream.exhausted:
                    self._exhausted = True
            got = self._backlog.read(n)
            sz = len(got)
            out[:sz] = got
            self.cursor_sec += sz / self.sample_rate
            if sz:
                self._last_sample = out[sz - 1]
                self._fading = True
            if self._exhausted and self._backlog.avail() == 0:
                self.is_playing = False
                self._exhausted = False
                self._pv_stream = None
            return out

        tmp_cursor = self.cursor_sec + self._backlog.avail() / self.sample_rate
        while not self._exhausted and self._backlog.avail() < n + pgs:
            step = build_render_plan(
                self.grains, self.knots, start_cursor=tmp_cursor, min_out=1, config=self.config
            )
            if step.n_steps == 0:
                # Past the grain table: append the reference's zero tail
                # (app.cpp:303-309) but keep playing until the backlog —
                # the remaining REAL audio plus those zeros — has been
                # delivered; stopping at fill time (as the reference's
                # togglePlay-inside-process does) silently truncates up to
                # a backlog's worth of the track end.
                self._backlog.write(np.zeros(pgs, np.float32))
                self._exhausted = True
                break
            buf = _render_step_np(
                self.wav,
                int(step.grain_start[0]),
                int(step.grain_len[0]),
                step.rate[0],
                int(step.seam_src[0]),
            )
            self._backlog.write(buf)
            tmp_cursor += len(buf) / self.sample_rate

        got = self._backlog.read(n)
        sz = len(got)
        out[:sz] = got
        self.cursor_sec += sz / self.sample_rate
        if sz:
            self._last_sample = out[sz - 1]
            self._fading = True
        if self._exhausted and self._backlog.avail() == 0:
            self.is_playing = False  # tail delivered: auto-stop
            self._exhausted = False
            self._fading = False  # the tail already ends in silence
        return out
