"""Official benchmark: audio-sec/sec/chip for STFT + phase-vocoder render,
plus on-chip spectral SNR vs the reference semantics (BASELINE.json metric).

Workload (BASELINE.json configs): a 180 s mono 44.1 kHz song; one pipeline
pass = full-track 2048-pt Hann STFT at 75% overlap (magnitudes, batched
FFT) + full-track PHASE-VOCODER pitch/time render with a 12-marker edit
(host float64 control plane, chunked stretch + block-relative lerp
resample on the device).  The north star is >= 100x realtime per chip (BASELINE.md);
``vs_baseline`` is the ratio against that.

Parity artifact, measured on the SAME run from the device's own output:
``snr_db`` = spectral error of the reference-semantics 32768-pt end-anchored
decay-window columns (spec.cpp:44-66 semantics) vs a float64 NumPy oracle —
north star < -60 dB — and the granular render is spot-checked sample-exact
against the reference process() transcription (tests/oracle.py).

Timing methodology: the metric is **measured device time from a
jax.profiler trace** (sum of on-device program durations per iteration).
Wall-clock dispatch timing is reported as a diagnostic only.

Hang-proofing: the measured body runs in a CHILD process under a parent
watchdog that stays off JAX (one process per device at a time).  The parent owns stdout,
enforces ``MELONIX_BENCH_BUDGET_S`` (default 2400 s) end to end, and ALWAYS
prints a JSON result line inside that budget — the headline line as soon as
the child measures it, and a final line enriched with the optional
artifacts (latency, sharded compose, batch fleet, hour-scale) when they
complete.  A stalled probe emits ``{"value": null, "stalled": true}``
immediately instead of proceeding into hangable dispatches; a mid-flight
kill preserves the last completed snapshot (``"partial": true``).  Parse
the LAST JSON line on stdout.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def _probe_service(deadline_s: float, attempt_timeout_s: float = 120.0) -> bool:
    """Gate the device measurements behind a trivial-jit probe.

    A device that cannot compile or run a trivial program would hang the
    first pipeline dispatch and the run would record nothing.  Probe with
    a tiny matmul in a SUBPROCESS (a blocked JAX call in-process is not
    interruptible), which exits before the measuring child starts, and
    retry until it answers or ``deadline_s`` passes.  Returns True when
    the device answered."""
    code = (
        # MELONIX_PROBE_PLATFORM lets the CPU test suite probe its own
        # backend whatever platform list the environment names.
        "import os, jax, jax.numpy as jnp;"
        "p = os.environ.get('MELONIX_PROBE_PLATFORM');"
        "p and jax.config.update('jax_platforms', p);"
        "x = jax.jit(lambda a: a @ a)(jnp.ones((128, 128)));"
        "assert float(x[0, 0]) == 128.0"
    )
    t0 = time.monotonic()
    while True:
        attempt_t0 = time.monotonic()
        try:
            r = subprocess.run(
                [sys.executable, "-c", code],
                timeout=attempt_timeout_s, capture_output=True,
            )
            if r.returncode == 0:
                return True
        except subprocess.TimeoutExpired:
            pass
        if time.monotonic() - t0 >= deadline_s:
            return False
        # Pace retries: a fast failure (import error) should not spin.
        time.sleep(max(0.0, 30.0 - (time.monotonic() - attempt_t0)))


def make_song(sr: int, seconds: float, seed: int = 0) -> np.ndarray:
    t = np.arange(int(sr * seconds)) / sr
    f = 220.0 * 2.0 ** (np.sin(2 * np.pi * 0.25 * t) * 0.5)
    x = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr)
    x += 0.2 * np.sin(2 * np.pi * 2.0 * np.cumsum(f) / sr)
    x += 0.01 * np.random.default_rng(seed).standard_normal(len(t))
    return x.astype(np.float32)


def song_markers(n: int, count: int = 12):
    """The bench's alternating-bend, alternating-stretch marker edit over
    a track of ``n`` samples (12 markers = BASELINE config #1)."""
    from melonix_tpu.markers import Marker

    return [
        Marker(sample=int((i + 1) * n / (count + 2)), note=57.0,
               d_time=0.01 * (1 if i % 2 == 0 else -1),
               pitch_bend=float((-1) ** i) * (1 + i % 4))
        for i in range(count)
    ]


def _device_ms_per_iter(trace_dir: str, iters: int) -> float | None:
    """Sum per-iteration device time of jit_* programs from a profiler trace."""
    per = _device_ms_by_program(trace_dir, iters)
    total = sum(per.values())
    # <= 0 (no events, or all zero-duration) -> None: main() then falls
    # back to wall clock instead of dividing by zero.
    return total if total > 0.0 else None


def _device_ms_by_program(trace_dir: str, iters: int) -> dict:
    """Per-program device ms/iter from a profiler trace (MELONIX_BENCH_BREAKDOWN
    prints this — the first place to look when the headline moves)."""
    files = glob.glob(f"{trace_dir}/**/*.trace.json.gz", recursive=True)
    if not files:
        return {}
    events = json.load(gzip.open(sorted(files)[-1]))["traceEvents"]
    per: dict = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and "dur" in e and name.startswith("jit_"):
            per[name] = per.get(name, 0.0) + e["dur"] / iters / 1000.0
    return per


def _oracle_column_f64(x: np.ndarray, start: int, end: int, size: int) -> np.ndarray:
    """Float64 reference-semantics column (spec.cpp:44-66): end-anchored
    window, exp(-2.5e-4 * (start - i)) decay before start, OOB zero,
    |DFT| of the first size//2 bins normalized by size."""
    idx = np.arange(end - size, end, dtype=np.int64)
    frame = np.zeros(size, np.float64)
    ib = (idx >= 0) & (idx < len(x))
    vals = x[np.clip(idx, 0, len(x) - 1)].astype(np.float64)
    dist = (start - idx).astype(np.float64)
    decay = np.where(dist > 0, np.exp(-2.5e-4 * dist), 1.0)
    frame = np.where(ib, vals * decay, 0.0)
    spec = np.fft.fft(frame)
    return np.abs(spec[: size // 2]) / size


def _column_snr_db(x: np.ndarray, sr: int) -> float:
    """Spectral SNR of on-device reference columns (the program that
    serves the UI tiles) vs the float64 oracle."""
    from melonix_tpu.config import DEFAULT_CONFIG
    from melonix_tpu.engine.spectral import spectrogram_columns

    size = DEFAULT_CONFIG.spectr_size  # 32768, the real reference size
    n_cols = 12
    ends = np.linspace(size, len(x) - 1, n_cols).astype(np.int64)
    starts = ends - int(0.02 * sr)  # 20 ms columns like a zoomed-in view
    got = spectrogram_columns(x, starts.astype(np.int32), ends.astype(np.int32))
    want = np.stack(
        [_oracle_column_f64(x, int(s), int(e), size) for s, e in zip(starts, ends)]
    )
    err = got.astype(np.float64) - want
    return float(10.0 * np.log10(np.sum(err**2) / np.sum(want**2)))


def _pv_pitch_err_cents() -> float:
    """End-to-end PV pitch accuracy from THIS chip's output.

    Renders a 440 Hz tone through a +2-semitone bend marker and measures
    the output's dominant frequency at the marker (where the bend is
    exactly +2) with a 32768-pt column + parabolic bin refinement.
    Returns the error in cents vs 440 * 2^(2/12) — an artifact of the
    whole PV pipeline (analysis/phase/synthesis/resample), not just its
    parts."""
    import jax.numpy as jnp

    from melonix_tpu.engine.maps import MapKnots
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.engine.spectral import spectrogram_columns
    from melonix_tpu.markers import Marker

    sr = 44100
    n = 5 * sr
    t = np.arange(n) / sr
    tone = (0.5 * np.sin(2.0 * np.pi * 440.0 * t)).astype(np.float32)
    # Two equal markers: the bend is EXACTLY +2 on the whole plateau
    # between them (a single marker only ramps through +2).
    knots = MapKnots.from_markers(
        [Marker(n // 3, 57.0, 0.0, 2.0), Marker(2 * n // 3, 57.0, 0.0, 2.0)],
        sr, n,
    )
    out = render_track_pv(tone, knots)
    size = 32768
    end = np.asarray([n // 2], np.int64)  # window well inside the plateau
    col = spectrogram_columns(out, end - int(0.05 * sr), end)[0]
    # Skip the DC bin: argmax there (silent/degenerate render) would wrap
    # col[k-1] to the last bin and fabricate a cents figure.
    k = 1 + int(np.argmax(col[1 : size // 2 - 1]))
    ym1, y0, yp1 = col[k - 1], col[k], col[k + 1]
    denom = ym1 - 2 * y0 + yp1
    dk = 0.5 * (ym1 - yp1) / denom if abs(denom) > 1e-12 else 0.0
    f_got = (k + float(np.clip(dk, -0.5, 0.5))) * sr / size
    f_want = 440.0 * 2.0 ** (2.0 / 12.0)
    return float(1200.0 * np.log2(f_got / f_want))


def _pv_phasiness() -> tuple[float, float]:
    """Objective phasiness (VERDICT r3 weak #6): amplitude-modulation
    index of the strongest partials of a two-inharmonic-tone fixture
    through a +3 st plateau — vertical phase incoherence shows as beating
    of the window-mainlobe bins, i.e. peak-bin magnitude wobble.  Returns
    (classic, locked); identity locking (Laroche–Dolson) should cut it by
    >= 2x."""
    from melonix_tpu.engine.maps import MapKnots
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.markers import Marker

    sr = 44100
    n = 4 * sr
    t = np.arange(n) / sr
    x = (0.4 * np.sin(2 * np.pi * 311.1 * t)
         + 0.4 * np.sin(2 * np.pi * 554.4 * t)).astype(np.float32)
    knots = MapKnots.from_markers(
        [Marker(n // 4, 57.0, 0.0, 3.0), Marker(3 * n // 4, 57.0, 0.0, 3.0)],
        sr, n,
    )

    def mod_index(y: np.ndarray) -> float:
        size, hop = 2048, 512
        seg = y[int(1.2 * sr): int(2.8 * sr)]  # steady plateau
        n_f = (len(seg) - size) // hop
        fr = np.stack([seg[i * hop: i * hop + size] for i in range(n_f)])
        mags = np.abs(np.fft.rfft(fr * np.hanning(size)))
        mean = mags.mean(0)
        ks: list[int] = []
        for kk in np.argsort(mean)[::-1]:
            if all(abs(int(kk) - j) > 4 for j in ks):
                ks.append(int(kk))
            if len(ks) == 4:
                break
        return float(np.mean(
            [mags[:, kk].std() / mags[:, kk].mean() for kk in ks]
        ))

    classic = mod_index(np.asarray(render_track_pv(x, knots)))
    locked = mod_index(np.asarray(render_track_pv(x, knots,
                                                  phase_locking=True)))
    return classic, locked


def _granular_parity_max_err() -> float:
    """On-chip granular render vs the literal reference transcription."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import oracle

    from melonix_tpu.engine.grains import build_grain_table
    from melonix_tpu.engine.maps import MapKnots
    from melonix_tpu.engine.render import render_track
    from melonix_tpu.markers import Marker

    sr = 8000
    t = np.arange(int(sr * 1.5)) / sr
    x = (0.6 * np.sin(2 * np.pi * (180.0 + 120.0 * t) * t)).astype(np.float32)
    markers = [Marker(sample=sr // 2, note=57.0, d_time=0.05, pitch_bend=2.0)]
    table = build_grain_table(x)
    knots = MapKnots.from_markers(markers, sr, len(x))
    got = np.asarray(render_track(x, table, knots))
    tup = [(m.sample, m.note, m.d_time, m.pitch_bend) for m in markers]
    grains = list(zip(table.starts.tolist(), table.lengths.tolist()))
    want = oracle.export(x, grains, tup, sr)
    n = min(len(got), len(want))
    return float(np.max(np.abs(got[:n] - want[:n])))


def _interactive_latency_ms(x: np.ndarray, sr: int) -> dict:
    """Interactive-latency artifacts, measured on this chip (VERDICT round
    2, next #3).  Targets: the reference's 20 ms-class worker poll for
    tiles (spec.cpp:83) and its one-audio-buffer edit->audio latency
    (~23 ms at 44.1k, app.cpp:243).

    * tile_burst_*: 100 zoomed-view columns requested -> RGB texels on the
      host (the UI's frame-fill path).  Cold includes the first device
      dispatch of the session (compile served from the persistent cache);
      warm is a second burst at different positions.
    * edit_to_audio: marker edit -> first fresh PV audio buffer from the
      live player (the quality engine's hear-the-edit loop).
    """
    from melonix_tpu.config import DEFAULT_CONFIG
    from melonix_tpu.runtime.tiles import TileServer

    out: dict = {}
    cfg = DEFAULT_CONFIG
    srv = TileServer(x, k=cfg.brightness_to_k(), config=cfg)
    try:
        span = int(0.02 * sr)

        def burst(key0: int) -> float:
            # One get_tiles per poll cycle — the UI frame path's actual
            # request shape (ui/view.py assemble: prefetch + get_tiles under
            # ONE lock acquisition).  Enqueuing key-by-key let the 2 ms
            # worker wake mid-burst and split the batch into two sequential
            # device drains (~2x the warm latency).
            keys = [(key0 + i, (i + 1) * len(x) // 128 - span, (i + 1) * len(x) // 128)
                    for i in range(100)]
            t0 = time.perf_counter()
            pending = dict.fromkeys(k for k, _, _ in keys)
            deadline = t0 + 600.0
            while pending and time.perf_counter() < deadline:
                got = srv.get_tiles(keys)
                pending = {k for (k, _, _), g in zip(keys, got) if g is None}
                if pending:
                    time.sleep(0.001)
            if pending:
                raise TimeoutError(f"{len(pending)} tiles never arrived")
            return (time.perf_counter() - t0) * 1000.0

        out["tile_burst_cold_ms"] = round(burst(0), 1)
        out["tile_burst_warm_ms"] = round(burst(1000), 1)
    finally:
        srv.close()

    from melonix_tpu.engine.grains import build_grain_table
    from melonix_tpu.engine.maps import MapKnots
    from melonix_tpu.engine.player import Player
    from melonix_tpu.markers import Marker

    short = x[: 20 * sr]
    # The product warms this track length's shape buckets at file open
    # (ui/state.py -> warmup_session_async), so the interactive number a
    # user sees is the warm one; measure the same way.
    from melonix_tpu.runtime.compile_cache import warmup_session

    warmup_session(len(short), sr)
    table = build_grain_table(short)
    knots = MapKnots.from_markers([], sr, len(short))
    bent = MapKnots.from_markers(
        [Marker(sr, 57.0, 0.0, 4.0), Marker(10 * sr, 57.0, 0.0, 4.0)], sr, len(short)
    )
    for engine in ("granular", "pv"):
        player = Player(short, table, knots, engine=engine)
        player.toggle()
        player.callback(1024)  # warm: backlog planned / stream stretched
        t0 = time.perf_counter()
        player.set_knots(bent)  # the edit
        buf = player.callback(1024)  # first fresh buffer on the new curve
        out[f"edit_to_audio_{engine}_ms"] = round(
            (time.perf_counter() - t0) * 1000.0, 1
        )
        assert np.isfinite(buf).all()
    return out


def _ui_fps(x: np.ndarray, sr: int) -> dict:
    """Interactive frame-rate artifact (VERDICT r3 #4): frames/s of the
    browser shell's /frame.png loop at 1280x720 over local HTTP, warm view.
    Reference is a vsync-locked ~60 fps GL loop (main.cpp:57, app.cpp:84);
    target >= 30.  ``ui_fps_steady`` holds the view fixed (memoized base +
    scrubber + JPEG encode per frame); ``ui_fps_pan`` drags the view one
    middle-button pan step per frame (app.cpp:804-817), forcing a full base
    recompose every frame — the pan/zoom-included number."""
    import http.client
    import tempfile as _tf

    from melonix_tpu.io.wav import write_wav
    from melonix_tpu.ui.web import EditorServer

    wav_path = os.path.join(_tf.mkdtemp(prefix="melonix_uifps_"), "song.wav")
    write_wav(wav_path, x[: 30 * sr], sr, dtype="float32")
    srv = EditorServer(autosave_interval=0.0)
    srv.state.open_file(wav_path)
    port = srv.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)

        def get(path: str) -> bytes:
            conn.request("GET", path)
            r = conn.getresponse()
            return r.read()

        def post(path: str, obj: dict) -> None:
            conn.request("POST", path, json.dumps(obj),
                         {"Content-Type": "application/json"})
            conn.getresponse().read()

        # Warm view: the frame request is what ENQUEUES the tile burst, so
        # fetch one first, then bounded-wait for pending AND inflight to
        # drain (pending alone clears the moment the worker picks the batch
        # up, before any tile lands) so the measurement is compose+encode,
        # not device round trips.
        get("/frame.png?fmt=jpg&w=1280&h=720")
        deadline = time.monotonic() + 180.0
        while time.monotonic() < deadline:
            tl = json.loads(get("/state"))["tiles"]
            if tl["pending"] == 0 and tl.get("inflight", 0) == 0:
                break
            time.sleep(1.0)
        for _ in range(5):
            get("/frame.png?fmt=jpg&w=1280&h=720")

        def burst(seconds: float, pan: bool) -> float:
            t0 = time.monotonic()
            n = 0
            while time.monotonic() - t0 < seconds:
                if pan:
                    post("/event", {"kind": "motion", "x": 600, "y": 300,
                                    "dx": 6, "dy": 0, "buttons": 2})
                get("/frame.png?fmt=jpg&w=1280&h=720")
                n += 1
            return n / (time.monotonic() - t0)

        steady = burst(2.0, pan=False)
        pan = burst(2.0, pan=True)
        conn.close()  # keep-alive: free the handler thread before stop()
        return {"ui_fps_steady": round(steady, 1), "ui_fps_pan": round(pan, 1)}
    finally:
        srv.stop()


def _hour_scale_x_realtime() -> float:
    """A 60-minute track through the chunked PV path on the chip — the
    int32-anchor + f32-residual position machinery at the scale its
    precision claims are about (VERDICT round 2, next #8; promoted out of
    opt-in in round 4; warm protocol + device_out in round 5).

    Protocol: render once with one edit to warm the executables (tracing
    and compiles are per-process, not per-render), then time a render
    with a DIFFERENT edit — fresh knots mean a fresh plan and fresh
    uploads.  ``device_out=True`` keeps the 635 MB result on device: the
    download is transport, not render (the number is
    edit-to-audio-resident, what a co-located consumer — batch export,
    the player — would see).  Scalar anchors force execution;
    correctness asserts on a downloaded 1-second slice."""
    import jax
    import jax.numpy as jnp

    from melonix_tpu.engine.maps import MapKnots
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.markers import Marker

    sr = 44100
    seconds = 3600.0
    n = int(sr * seconds)

    def mk_knots(bend: float) -> MapKnots:
        # Equal n/7 spacing: the first bend segment and the final
        # relax-to-zero segment then have the same length, which makes the
        # rate integral EXACTLY invariant under flipping every bend's sign
        # (segment integrals are endpoint-reversal symmetric, and equal
        # spacing matches the boundary segments' lengths) — the warmup
        # below exploits that.
        markers = [
            Marker(sample=int((i + 1) * n / 7), note=57.0, d_time=0.0,
                   pitch_bend=float((-1) ** i) * bend)
            for i in range(6)
        ]
        return MapKnots.from_markers(markers, sr, n)

    # Synthesize the 635 MB fixture ON the device (225 Hz = exactly 196
    # samples at 44.1k, so int32 mod keeps the phase exact at 2^27
    # samples) — no 635 MB host upload before the timed region.
    @jax.jit
    def make_tone():
        i = jnp.arange(n, dtype=jnp.int32)
        ph = (i % 196).astype(jnp.float32) * (2.0 * np.pi / 196.0)
        return 0.4 * jnp.sin(ph)

    x_dev = make_tone()
    _ = float(x_dev[12345])  # anchor: tone materialized before timing
    # Warm with the SIGN-FLIPPED edit: flipping every bend preserves the
    # rate integral exactly (each boundary segment's integral is endpoint-
    # symmetric, interior ramps mirror pairwise), so n_frames/stretch_len/
    # n_out — every shape-keyed static — match the timed edit and no
    # compile can land inside the timed region, while every plan
    # VALUE differs, keeping the timed run's uploads and execution fresh.
    warm = render_track_pv(x_dev, mk_knots(-1.5), device_out=True)
    _ = float(warm[n // 2])  # anchor: warmup executed before timing
    del warm
    t0 = time.perf_counter()
    out = render_track_pv(x_dev, mk_knots(1.5), device_out=True)
    anchor = float(out[n // 2]) + float(out[-sr])
    dt = time.perf_counter() - t0
    assert np.isfinite(anchor), "hour-scale render produced non-finite audio"
    slice_1s = np.asarray(out[sr : 2 * sr])
    assert np.abs(slice_1s).max() > 0.01, "hour-scale render silent"
    return seconds / dt


def _live_pv_sustained(seconds: float = 15.0) -> dict:
    """Sustained live-playback artifact (VERDICT r4 #3): continuous
    1024-sample pulls through the Player on the PV engine against the
    reference's hard audio-callback deadline (app.cpp:243-249, 274-276:
    1024 samples every 23.2 ms).  A pull UNDERRUNS when it completes
    after its buffer was due on the audio clock (cumulative wall >
    cumulative audio delivered) — the planned-ahead backlog
    (player.PV_LIVE_AHEAD) must absorb the latency jitter of each stream
    refill.  One warmup pull precedes the clock (a real audio
    stack prebuffers before unmuting; the first pull pays stream
    construction + the first device dispatch)."""
    from melonix_tpu.engine.grains import build_grain_table
    from melonix_tpu.engine.maps import MapKnots
    from melonix_tpu.engine.player import Player
    from melonix_tpu.markers import Marker

    sr = 44100
    n = int(sr * (seconds + 6.0))
    t = np.arange(n) / sr
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t)
         + 0.2 * np.sin(2 * np.pi * 331.0 * t)).astype(np.float32)
    markers = [
        Marker(n // 3, 57.0, 0.0, 3.0),
        Marker(2 * n // 3, 57.0, 0.0, -2.0),
    ]
    knots = MapKnots.from_markers(markers, sr, n)
    p = Player(x, build_grain_table(x), knots, engine="pv")
    p.is_playing = True
    buf = 1024
    first = p.callback(buf)  # prebuffer: stream construction + first dispatch
    assert np.abs(first).max() > 1e-4, "live PV stream started silent"
    pulls = int(seconds * sr / buf)
    t0 = time.perf_counter()
    audio = 0.0
    under = 0
    worst = 0.0
    for _ in range(pulls):
        p.callback(buf)
        audio += buf / sr
        behind = (time.perf_counter() - t0) - audio
        worst = max(worst, behind)
        if behind > 0.0:
            under += 1
    wall = time.perf_counter() - t0
    return {
        "live_pv_underruns": under,
        "live_pv_x_realtime": round(audio / wall, 2),
        "live_pv_worst_lag_ms": round(worst * 1e3, 1),
    }


def _batch_x_realtime() -> float:
    """Batch-serving on-chip artifact (VERDICT round 3, next #6): a 4-file
    PV fleet through ONE mesh program (data_parallel_pv on a 1x1 mesh —
    four batch rows on the single chip), BASELINE config #5's scale story.
    Returns total audio-sec / device-sec from a profiler trace."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from melonix_tpu.engine.batch import render_batch
    from melonix_tpu.markers import Marker

    sr = 44100
    seconds = 30.0
    n = int(sr * seconds)
    rng = np.random.default_rng(7)
    tracks = []
    markers_list = []
    for b in range(4):
        t = np.arange(n) / sr
        f0 = 180.0 + 40.0 * b
        x = (0.5 * np.sin(2 * np.pi * f0 * t)
             + 0.1 * rng.standard_normal(n)).astype(np.float32)
        tracks.append(x)
        markers_list.append([
            Marker(n // 3, 57.0, 0.0, float(b - 1.5)),
            Marker(2 * n // 3, 57.0, 0.0, float(1.5 - b)),
        ])
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "seq"))
    outs = render_batch(tracks, markers_list, sr, engine="pv", mesh=mesh)
    assert all(np.isfinite(o).all() and np.abs(o).max() > 0.01 for o in outs)

    iters = 2
    trace_dir = tempfile.mkdtemp(prefix="melonix_batch_")
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        for _ in range(iters):
            outs = render_batch(tracks, markers_list, sr, engine="pv",
                                mesh=mesh)
    wall = (time.perf_counter() - t0) / iters
    dev_ms = _device_ms_per_iter(trace_dir, iters)
    dt = dev_ms / 1000.0 if dev_ms else wall
    return 4 * seconds / dt


def _stage_budget_left(t0: float) -> float:
    deadline = float(os.environ.get("MELONIX_BENCH_CHILD_S", "1e9"))
    return deadline - (time.monotonic() - t0)


def _write_snapshot(path: str, result: dict) -> None:
    """Append one complete JSON line; the parent reads the last full line,
    so a mid-write kill can never corrupt an earlier snapshot."""
    with open(path, "a") as f:
        f.write(json.dumps(result) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _read_last_snapshot(path: str) -> dict | None:
    try:
        lines = [ln for ln in open(path).read().split("\n") if ln.strip()]
    except OSError:
        return None
    for ln in reversed(lines):
        try:
            return json.loads(ln)
        except json.JSONDecodeError:
            continue
    return None


def _stalled_result() -> dict:
    return {
        "metric": _METRIC,
        "value": None,
        "unit": "x realtime",
        "vs_baseline": None,
        "stalled": True,
    }


_METRIC = (
    "stft+phase-vocoder render audio-sec/sec/chip (180s song, 2048/75% "
    "Hann + 12-marker PV edit); snr_db = 32768-pt reference-column "
    "spectral error vs float64 oracle"
)


def parent_main() -> None:
    """Watchdog: probe the service, run the measured body in a child with a
    hard budget, and ALWAYS print a JSON result line before the driver's
    timeout can hit.  Parse the LAST JSON line."""
    budget = float(os.environ.get("MELONIX_BENCH_BUDGET_S", "2400"))
    t0 = time.monotonic()
    probe_deadline = min(
        float(os.environ.get("MELONIX_BENCH_PROBE_S", "300")), budget * 0.5
    )
    if probe_deadline > 0 and not _probe_service(probe_deadline):
        print(
            f"# trivial-jit probe never answered within {probe_deadline:.0f}s"
            " — device unavailable; emitting null headline.",
            file=sys.stderr,
        )
        print(json.dumps(_stalled_result()), flush=True)
        return

    state = tempfile.mktemp(prefix="melonix_bench_state_")
    child_budget = budget - (time.monotonic() - t0) - 20.0
    env = dict(os.environ, MELONIX_BENCH_CHILD_S=str(child_budget))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", state],
        stdout=sys.stderr, env=env,
    )
    deadline = t0 + budget - 10.0
    early: dict | None = None
    while proc.poll() is None and time.monotonic() < deadline:
        time.sleep(1.0)
        if early is None:
            snap = _read_last_snapshot(state)
            if snap is not None:
                # Headline out the door the moment it exists: a late kill
                # (driver timeout) can no longer erase the round's number.
                early = snap
                print(json.dumps(snap), flush=True)
    killed = proc.poll() is None
    if killed:
        proc.kill()
        proc.wait()
        print("# child exceeded the bench budget — killed; snapshot kept.",
              file=sys.stderr)
    final = _read_last_snapshot(state)
    if final is None:
        final = _stalled_result()
    elif killed:
        final = dict(final, partial=True)
    if final != early:
        print(json.dumps(final), flush=True)


def child_main() -> None:
    state = sys.argv[sys.argv.index("--child") + 1]
    t0 = time.monotonic()

    import jax
    import jax.numpy as jnp

    from melonix_tpu.config import DEFAULT_CONFIG
    from melonix_tpu.engine.maps import MapKnots
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.engine.spectral import hann_window, num_frames, stft_mags_device
    from melonix_tpu.markers import Marker

    sr = 44100
    seconds = 180.0
    cfg = DEFAULT_CONFIG
    x = make_song(sr, seconds)

    markers = [
        Marker(sample=int((i + 1) * len(x) / 14), note=57.0,
               d_time=0.01 * (1 if i % 2 == 0 else -1), pitch_bend=float((-1) ** i) * (1 + i % 4))
        for i in range(12)
    ]
    knots = MapKnots.from_markers(markers, sr, len(x))

    wav_dev = jnp.asarray(x)
    win = jnp.asarray(hann_window(cfg.stft_size))
    nf = num_frames(len(x), cfg.stft_size, cfg.stft_hop)

    def pipeline():
        mags = stft_mags_device(wav_dev, win, cfg.stft_size, cfg.stft_hop, nf)
        out = render_track_pv(wav_dev, knots)  # host plan + device stretch/resample
        return mags, out

    # Warm-up / compile, then correctness anchor (forces real execution).
    mags, out = pipeline()
    anchor = float(jnp.sum(mags[::97, ::61])) + float(out[12345])
    assert np.isfinite(anchor), "non-finite pipeline output"

    # --- Metric: device time from a profiler trace ---
    iters = int(os.environ.get("MELONIX_BENCH_ITERS", "3"))
    trace_dir = tempfile.mkdtemp(prefix="melonix_bench_")
    t_wall0 = time.perf_counter()
    try:
        with jax.profiler.trace(trace_dir):
            for _ in range(iters):
                mags, out = pipeline()
            _ = float(out[123]) + float(mags[1, 1])  # drain the pipe
        dev_ms = _device_ms_per_iter(trace_dir, iters)
        if os.environ.get("MELONIX_BENCH_BREAKDOWN"):
            for name, ms in sorted(
                _device_ms_by_program(trace_dir, iters).items(),
                key=lambda kv: -kv[1],
            ):
                # stderr: stdout is the one-JSON-line contract.
                print(f"# {ms:8.2f} ms  {name}", file=sys.stderr)
    except Exception:
        dev_ms = None
    t_wall = (time.perf_counter() - t_wall0) / iters

    if dev_ms is None:  # no usable trace (e.g. bare CPU CI): wall clock
        dev_ms = t_wall * 1000.0
        source = "wall"
    else:
        source = "trace"

    # --- Headline snapshot: the round's number is now safe on disk ---
    value = seconds / (dev_ms / 1000.0)
    result = {
        "metric": _METRIC,
        "value": round(value, 1),
        "unit": "x realtime",
        "vs_baseline": round(value / 100.0, 3),
    }
    _write_snapshot(state, result)

    # --- Parity artifacts from the same chip (outside the timed trace) ---
    try:
        snr_db = _column_snr_db(x, sr)
    except Exception as exc:  # parity must never mask the perf number
        snr_db = None
        print(f"# snr check failed: {exc!r}", file=sys.stderr)
    result["snr_db"] = None if snr_db is None else round(snr_db, 1)
    try:
        gran_err = _granular_parity_max_err()
    except Exception as exc:
        gran_err = None
        print(f"# granular parity check failed: {exc!r}", file=sys.stderr)
    try:
        pv_cents = _pv_pitch_err_cents()
    except Exception as exc:
        pv_cents = None
        print(f"# pv pitch check failed: {exc!r}", file=sys.stderr)
    try:
        ph_c, ph_l = _pv_phasiness()
        result["pv_phasiness_classic"] = round(ph_c, 4)
        result["pv_phasiness_locked"] = round(ph_l, 4)
    except Exception as exc:
        print(f"# pv phasiness check failed: {exc!r}", file=sys.stderr)
    _write_snapshot(state, result)

    # --- Optional stages, each gated on the remaining child budget so the
    # watchdog never has to kill a half-done stage in a healthy run ---
    latency: dict = {}
    if _stage_budget_left(t0) > 240.0:
        # Interactive latency artifacts (VERDICT r2 #3).
        try:
            latency = _interactive_latency_ms(x, sr)
        except Exception as exc:
            print(f"# interactive latency check failed: {exc!r}",
                  file=sys.stderr)
        # Targets: 20 ms-class worker poll (spec.cpp:83); ~23 ms audio
        # buffer (app.cpp:243).
        result.update(latency)
        _write_snapshot(state, result)

    if _stage_budget_left(t0) > 120.0:
        # UI frame-rate artifact (VERDICT r3 #4): >= 30 fps warm view.
        try:
            result.update(_ui_fps(x, sr))
            _write_snapshot(state, result)
        except Exception as exc:
            print(f"# ui fps check failed: {exc!r}", file=sys.stderr)

    batch_x = None
    if _stage_budget_left(t0) > 240.0:
        # Batch-serving fleet artifact (VERDICT r3 #6).
        try:
            batch_x = round(_batch_x_realtime(), 1)
            result["batch_x_realtime"] = batch_x
            _write_snapshot(state, result)
        except Exception as exc:
            print(f"# batch fleet bench failed: {exc!r}", file=sys.stderr)

    live = None
    if _stage_budget_left(t0) > 180.0:
        # Sustained live-playback artifact (VERDICT r4 #3).
        try:
            live = _live_pv_sustained()
            result.update(live)
            _write_snapshot(state, result)
        except Exception as exc:
            print(f"# live PV sustained bench failed: {exc!r}", file=sys.stderr)

    hour_x = None
    if (os.environ.get("MELONIX_BENCH_HOUR", "1") == "1"
            and _stage_budget_left(t0) > 300.0):
        # Hour-scale artifact, default-on since round 4 (VERDICT r3 #7);
        # MELONIX_BENCH_HOUR=0 opts out.
        try:
            hour_x = round(_hour_scale_x_realtime(), 1)
            result["hour_x_realtime"] = hour_x
            _write_snapshot(state, result)
        except Exception as exc:
            print(f"# hour-scale render failed: {exc!r}", file=sys.stderr)

    # Diagnostic breakdown (ignored by the driver):
    print(
        f"# breakdown: device={dev_ms:.1f}ms/iter ({source}) wall={t_wall:.3f}s/iter "
        f"granular_parity_max_err={gran_err} "
        f"pv_pitch_err_cents={None if pv_cents is None else round(pv_cents, 2)} "
        f"latency={latency} "
        f"batch_x_realtime={batch_x} hour_x_realtime={hour_x} live={live} "
        f"platform={jax.devices()[0].platform}",
        file=sys.stderr,
    )


def main() -> None:
    if "--child" in sys.argv:
        child_main()
        # Skip interpreter teardown: daemon threads left from the UI-fps
        # server (handler/tile threads) would race the runtime's atexit
        # hooks.  All snapshots are already flushed to the state file.
        sys.stderr.flush()
        os._exit(0)
    else:
        parent_main()


if __name__ == "__main__":
    main()
