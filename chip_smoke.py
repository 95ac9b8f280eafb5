"""End-to-end smoke of melonix on one GPU, through the product's entry points.

Drives the main path once at the size users edit — a 180 s, 44.1 kHz song
with 12 markers (BASELINE config #1) — and checks every device stage
against the repo's own references:

  native     build the C++ host runtime from source, load it
  decode     WAV + FLAC written by the package, read back by ``load_audio``
  tiles      a synchronous ``TileServer`` drain of 256 columns at the
             reference 32768 points vs the float64 oracle
  headline   full-track |STFT| vs NumPy float64; the 12-marker PV render,
             plain and formant-preserving, vs the same code on the CPU
  granular   ``render_track`` vs the literal reference transcription
  analysis   ``pitch_curve`` + ``autotune`` on a 220 Hz tone and the song
  session    stereo 48 kHz PV session, 120 markers, formants (config #5)
  hour       a 60-minute track through the chunked PV and granular paths
  cli_server the CLI in process; an ``EditorServer`` driven over HTTP

Every phase prints PASS with its figures against their bars and its wall
time; a failing phase ends the run with a non-zero exit.  The last line of
standard output is one JSON object naming the device.  Without a GPU the
script exits non-zero before any phase runs.

``--four-cards`` runs only the multi-device phase instead (four-card mesh:
batch fleet, stereo session, seq-sharded PV and granular vs one card).

    python chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of one smoke run.  ``FULL`` is what the card runs; the CPU
    tests call every phase with a tiny instance."""

    sr: int = 44100
    song_s: float = 180.0
    n_markers: int = 12
    flac_s: float = 30.0  # stereo FLAC excerpt (the encoder is host Python)
    cols: int = 256
    col_size: int = 32768
    stft_check_frames: int = 64
    oracle_s: float = 30.0  # granular oracle excerpt (literal Python loops)
    tone_s: float = 5.0
    session_sr: int = 48000
    session_markers: int = 120
    hour_s: float = 3600.0
    cli_s: float = 20.0


FULL = Sizes()


@dataclasses.dataclass
class Context:
    sizes: Sizes
    seed: int
    workdir: str
    song: np.ndarray | None = None


class PhaseFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailure(what)


def rel_rms(got: np.ndarray, want: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want**2)) + 1e-30))


def snr_db(got, want) -> float:
    err = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float(10.0 * np.log10((np.sum(err**2) + 1e-300)
                                 / (np.sum(np.asarray(want, np.float64) ** 2)
                                    + 1e-300)))


def _oracle():
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import oracle

    return oracle


def _song(ctx: Context) -> np.ndarray:
    if ctx.song is None:
        from bench import make_song

        ctx.song = make_song(ctx.sizes.sr, ctx.sizes.song_s, seed=ctx.seed)
    return ctx.song


def _knots(n: int, sr: int, count: int):
    from bench import song_markers
    from melonix_tpu.engine.maps import MapKnots

    markers = song_markers(n, count)
    return markers, MapKnots.from_markers(markers, sr, n)


def _on_cpu():
    import jax

    return jax.default_device(jax.devices("cpu")[0])


# ----------------------------------------------------------------------
# Phases.  Each returns a dict of figures; each raises on failure.
# ----------------------------------------------------------------------


def phase_native(ctx: Context) -> dict:
    """Build the host runtime from the tracked sources and load it."""
    subprocess.run(["make", "-s", "-C", os.path.join(REPO, "native")],
                   check=True, stdout=subprocess.DEVNULL)
    from melonix_tpu.runtime import native

    native.try_load.cache_clear()
    lib = native.try_load()
    check(lib is not None, "libmelonix_native.so did not load")
    check(hasattr(lib, "mlx_build_plan"), "plan walker symbol missing")
    return {"lib": os.path.basename(lib._name)}


def phase_decode(ctx: Context) -> dict:
    """WAV (float32) and FLAC (16-bit stereo) through ``load_audio``."""
    import melonix_tpu as mlx

    s = ctx.sizes
    x = _song(ctx)
    wav_path = os.path.join(ctx.workdir, "song.wav")
    mlx.write_wav(wav_path, x, s.sr, dtype="float32")
    y, rate = mlx.load_audio(wav_path)
    check(rate == s.sr and y.shape == x.shape, f"wav shape {y.shape} @ {rate}")
    wav_err = float(np.max(np.abs(y - x)))
    check(wav_err == 0.0, f"float32 WAV round trip err {wav_err}")

    n = int(s.flac_s * s.sr)
    st = np.stack([x[:n], 0.8 * x[:n]], axis=1)
    flac_path = os.path.join(ctx.workdir, "song.flac")
    mlx.write_flac(flac_path, st, s.sr)
    z, rate2 = mlx.load_audio(flac_path, mono=False)
    q = np.clip(np.rint(st.astype(np.float64) * 32768.0), -32768, 32767) / 32768.0
    flac_err = float(np.max(np.abs(z - q)))
    check(rate2 == s.sr and z.shape == st.shape, f"flac shape {z.shape}")
    check(flac_err == 0.0, f"16-bit FLAC round trip err {flac_err}")
    return {"wav_max_err": wav_err, "flac_max_err_vs_16bit": flac_err,
            "bar": "0.0 (sample-exact)"}


def phase_tiles(ctx: Context) -> dict:
    """One synchronous drain of ``cols`` columns at ``col_size`` points."""
    import jax.numpy as jnp

    from melonix_tpu.config import DEFAULT_CONFIG
    from melonix_tpu.engine.spectral import spectrogram_columns_device
    from melonix_tpu.runtime.tiles import TileServer, log_resample_np
    from melonix_tpu.ui.colormap import colormap_lut

    s = ctx.sizes
    cfg = dataclasses.replace(DEFAULT_CONFIG, spectr_size=s.col_size)
    x = _song(ctx)
    rng = np.random.default_rng(ctx.seed)
    ends = np.sort(rng.integers(s.col_size // 2, len(x) + s.col_size // 4,
                                s.cols)).astype(np.int64)
    starts = ends - rng.integers(50, int(0.05 * s.sr), s.cols)
    k = cfg.brightness_to_k()

    srv = TileServer(x, k=k, config=cfg, synchronous=True)
    try:
        t0 = time.perf_counter()
        tiles = srv.get_tiles([(i, int(a), int(b))
                               for i, (a, b) in enumerate(zip(starts, ends))])
        drain_s = time.perf_counter() - t0
    finally:
        srv.close()
    check(all(t is not None for t in tiles), "tiles missing after drain")
    shapes = {t.shape for t in tiles}
    check(shapes == {(cfg.tile_texels, 3)}, f"tile shapes {shapes}")
    check(all(t.dtype == np.uint8 for t in tiles), "tile dtype")

    mags = np.asarray(spectrogram_columns_device(
        jnp.asarray(x), jnp.asarray(starts, jnp.int32),
        jnp.asarray(ends, jnp.int32), size=s.col_size))
    oracle = _oracle()
    want = np.stack([oracle.spec_column(x, int(a), int(b), s.col_size)
                     for a, b in zip(starts, ends)])
    col_snr = snr_db(mags, want)
    check(col_snr <= -60.0, f"column SNR {col_snr:.1f} dB > -60 dB")

    lut = colormap_lut()
    v = np.round(np.clip(log_resample_np(want, cfg.tile_texels,
                                         cfg.tile_frac_min) * np.float32(k),
                         0.0, 255.0)).astype(np.uint8)
    same = float(np.mean(np.all(np.stack(tiles) == lut[v], axis=-1)))
    check(same >= 0.99, f"tile texels equal to the oracle's: {same:.4f}")
    return {"column_snr_db": round(col_snr, 1), "bar_db": -60.0,
            "tile_texels_equal": round(same, 5), "tile_bar": 0.99,
            "drain_s": round(drain_s, 3), "tile_shape": list(tiles[0].shape)}


def phase_headline(ctx: Context) -> dict:
    """Full-track |STFT| and the 12-marker PV render, plain + formant."""
    import jax.numpy as jnp

    from bench import _pv_pitch_err_cents
    from melonix_tpu.config import DEFAULT_CONFIG as cfg
    from melonix_tpu.engine import phase_vocoder as pv
    from melonix_tpu.engine.spectral import (hann_window, num_frames,
                                             stft_mags_device)

    s = ctx.sizes
    x = _song(ctx)
    size, hop = cfg.stft_size, cfg.stft_hop
    nf = num_frames(len(x), size, hop)
    win = hann_window(size)
    mags = np.asarray(stft_mags_device(jnp.asarray(x), jnp.asarray(win),
                                       size, hop, nf))
    check(mags.shape == (nf, size // 2), f"|STFT| shape {mags.shape}")
    pick = np.linspace(0, nf - 1, min(s.stft_check_frames, nf)).astype(int)
    frames = np.stack([np.pad(x[i * hop: i * hop + size].astype(np.float64),
                              (0, max(0, i * hop + size - len(x))))
                       for i in pick])
    want = np.abs(np.fft.rfft(frames * win.astype(np.float64)))[:, : size // 2]
    stft_snr = snr_db(mags[pick], want)
    check(stft_snr <= -60.0, f"|STFT| SNR {stft_snr:.1f} dB")

    _markers, knots = _knots(len(x), s.sr, s.n_markers)
    figs = {"stft_frames": nf, "stft_snr_db": round(stft_snr, 1),
            "stft_bar_db": -60.0}
    for formant in (False, True):
        out = pv.render_track_pv(x, knots, preserve_formants=formant)
        with _on_cpu():
            ref = pv.render_track_pv(x, knots, preserve_formants=formant)
        check(out.shape == ref.shape and np.isfinite(out).all(),
              f"PV output {out.shape} vs CPU {ref.shape}")
        r = rel_rms(out, ref)
        tag = "pv_formant" if formant else "pv"
        # PV phase propagation is chaotic at the ulp level (cuFFT vs the
        # CPU FFT, GPU cumsum order), so the bar is rms, not bitwise.
        check(r < 2e-2, f"{tag} rel rms vs CPU {r:.2e} >= 2e-2")
        figs[f"{tag}_rel_rms_vs_cpu"] = float(f"{r:.3e}")
    figs["pv_rms_bar"] = 2e-2

    cents = _pv_pitch_err_cents()
    check(abs(cents) < 1.0, f"PV pitch error {cents:.3f} cents")
    figs["pv_pitch_err_cents"] = round(cents, 4)
    figs["cents_bar"] = 1.0

    plan = pv.build_pv_plan(knots, len(x))
    ch = min(pv.PV_CHUNK_FRAMES, plan.n_frames)
    n_bins = plan.size // 2 + 1
    z = jnp.zeros(n_bins, jnp.float32)
    compiled = pv._stretch_chunk_packed.lower(
        jnp.asarray(x), jnp.asarray(pv._pack_frame_plan(plan, ch, True)),
        jnp.asarray(win), jnp.int32(0), jnp.int32(ch), z, z, z,
        plan.size, plan.hop, ch, formant=True,
    ).compile()
    ma = compiled.memory_analysis()
    if ma is not None:
        figs["pv_chunk_memory"] = {
            k: int(getattr(ma, k)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, k)}
    figs["pv_chunk_frames"] = ch
    return figs


def phase_granular(ctx: Context) -> dict:
    """``render_track`` vs the literal transcription of App::exportWav."""
    import melonix_tpu as mlx
    from melonix_tpu.engine.render import build_render_plan

    s = ctx.sizes
    x = _song(ctx)
    oracle = _oracle()
    n = int(s.oracle_s * s.sr)
    xs = x[:n]
    markers, knots = _knots(n, s.sr, s.n_markers)
    table = mlx.build_grain_table(xs)
    got = mlx.render_track(xs, table, knots)
    grains = list(zip(table.starts.tolist(), table.lengths.tolist()))
    want = oracle.export(xs, grains, [(m.sample, m.note, m.d_time, m.pitch_bend)
                                      for m in markers], s.sr)
    check(len(got) == len(want), f"length {len(got)} vs oracle {len(want)}")
    err_oracle = float(np.max(np.abs(got - want)))

    _m, knots_full = _knots(len(x), s.sr, s.n_markers)
    table_full = mlx.build_grain_table(x)
    full = mlx.render_track(x, table_full, knots_full)
    plan = build_render_plan(table_full, knots_full)
    want_full = oracle.render_plan_f32(x, plan)
    want_full = np.pad(want_full, (0, plan.total_out - len(want_full)))
    check(len(full) == len(want_full), "full-track length")
    err_full = float(np.max(np.abs(full - want_full)))
    exact = float(np.mean(full == want_full))
    # 0.0 is the sample-exact bar; a multiply-add contracted into an FMA
    # by the device compiler moves the lerp by at most ~1 ulp of |x| <= 1.
    bound = 1e-6
    check(err_oracle <= bound, f"oracle max err {err_oracle:.3e}")
    check(err_full <= bound, f"full-track max err {err_full:.3e}")
    return {"oracle_excerpt_s": s.oracle_s, "max_err_vs_oracle": err_oracle,
            "full_track_max_err_vs_f32_plan": err_full,
            "full_track_exact_share": round(exact, 6), "bar": bound,
            "out_samples": len(full)}


def _tone(sr: int, seconds: float, f0: float = 220.0) -> np.ndarray:
    t = np.arange(int(sr * seconds)) / sr
    return (0.5 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


def phase_analysis(ctx: Context) -> dict:
    """Pitch curve + autotune on a 220 Hz tone and on the song."""
    import melonix_tpu as mlx

    s = ctx.sizes
    tone = _tone(s.sr, s.tone_s)
    curve = mlx.pitch_curve(tone, s.sr)
    voiced = float(np.mean(curve.voiced))
    note = float(np.median(curve.note[curve.voiced]))
    check(voiced > 0.95, f"tone voiced share {voiced:.3f}")
    check(round(note) == 48, f"tone note {note:.3f} != 48")
    tuned, sugg = mlx.autotune(tone, s.sr, scale="chromatic", key="a")
    check(len(tuned) > 0 and np.isfinite(tuned).all(), "tone autotune output")

    x = _song(ctx)
    c_dev = mlx.pitch_curve(x, s.sr)
    out_dev, m_dev = mlx.autotune(x, s.sr, scale="major", key="a")
    with _on_cpu():
        c_cpu = mlx.pitch_curve(x, s.sr)
        m_cpu = mlx.suggest_markers(x, s.sr, scale="major", key="a")
        # Same markers on both sides: the render comparison then sees only
        # the device, not a detector decision flipping on the last ulp.
        out_cpu = mlx.render_session(x, m_dev, s.sr, engine="pv",
                                     preserve_formants=True)
    voiced_agree = float(np.mean(c_dev.voiced == c_cpu.voiced))
    both = c_dev.voiced & c_cpu.voiced
    f0_dev = float(np.median(np.abs(c_dev.f0[both] / c_cpu.f0[both] - 1.0))
                   if both.any() else 0.0)
    check(voiced_agree > 0.99, f"song voicing agreement {voiced_agree:.4f}")
    check(f0_dev < 1e-3, f"song f0 median rel diff {f0_dev:.2e}")
    r = rel_rms(out_dev, out_cpu)
    check(out_dev.shape == out_cpu.shape and r < 2e-2,
          f"autotune render rel rms vs CPU {r:.2e}")
    return {"tone_voiced": round(voiced, 4), "tone_note": round(note, 3),
            "note_bar": 48, "tone_autotune_markers": len(sugg),
            "song_voiced_agreement_vs_cpu": round(voiced_agree, 5),
            "song_f0_median_rel_diff_vs_cpu": float(f"{f0_dev:.3e}"),
            "autotune_markers": len(m_dev),
            "autotune_markers_cpu": len(m_cpu),
            "autotune_rel_rms_vs_cpu": float(f"{r:.3e}")}


def phase_session(ctx: Context) -> dict:
    """Stereo 48 kHz PV session with formants and 100+ markers."""
    import melonix_tpu as mlx
    from bench import make_song, song_markers

    s = ctx.sizes
    mono = make_song(s.session_sr, s.song_s, seed=ctx.seed + 1)
    st = np.stack([mono, 0.7 * mono[::-1]], axis=1)
    markers = song_markers(len(mono), s.session_markers)
    out = mlx.render_session(st, markers, s.session_sr, engine="pv",
                             preserve_formants=True)
    knots = mlx.MapKnots.from_markers(markers, s.session_sr, len(mono))
    n_out = int(knots.duration() * s.session_sr)
    check(out.shape == (n_out, 2), f"session shape {out.shape} != ({n_out}, 2)")
    check(bool(np.isfinite(out).all()), "session output not finite")
    peak = float(np.max(np.abs(out)))
    check(peak > 0.05, f"session output near-silent (peak {peak:.3g})")
    return {"markers": len(markers), "shape": list(out.shape),
            "peak": round(peak, 4)}


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_hour(ctx: Context) -> dict:
    """A 60-minute mono track through the chunked PV path (output kept
    on the device) and the one-shot granular path."""
    import jax
    import jax.numpy as jnp

    import melonix_tpu as mlx
    from bench import song_markers
    from melonix_tpu.engine import phase_vocoder as pv

    s = ctx.sizes
    n = int(s.hour_s * s.sr)
    # 225 Hz at 44.1 kHz is exactly 196 samples: the int32 mod keeps the
    # phase exact at any length, and the fixture never crosses the bus.
    period = max(2, int(round(s.sr / 225.0)))

    @jax.jit
    def make_tone():
        i = jnp.arange(n, dtype=jnp.int32)
        ph = (i % period).astype(jnp.float32) * (2.0 * np.pi / period)
        return 0.4 * jnp.sin(ph)

    x_dev = make_tone()
    knots = mlx.MapKnots.from_markers(song_markers(n, 6), s.sr, n)
    plan = pv.build_pv_plan(knots, n)
    t0 = time.perf_counter()
    out = pv.render_track_pv(x_dev, knots, device_out=True)
    ok = bool(jnp.isfinite(out).all())
    pv_s = time.perf_counter() - t0
    check(out.shape == (plan.n_out,), f"hour PV shape {out.shape}")
    check(ok, "hour PV output not finite")
    mid = np.asarray(out[n // 2: n // 2 + s.sr])
    check(np.abs(mid).max() > 0.05, "hour PV output silent")
    peak_pv = _peak_bytes()
    del out

    x = np.asarray(x_dev)
    table = mlx.build_grain_table(x)
    t0 = time.perf_counter()
    g = mlx.render_track(x, table, knots)
    gran_s = time.perf_counter() - t0
    check(bool(np.isfinite(g).all()) and np.abs(g).max() > 0.05,
          "hour granular output not finite / silent")
    peak_all = _peak_bytes()
    return {"samples": n, "pv_chunks": -(-plan.n_frames // pv.PV_CHUNK_FRAMES),
            "pv_wall_s_incl_compile": round(pv_s, 2),
            "granular_wall_s_incl_compile": round(gran_s, 2),
            "peak_bytes_after_pv": peak_pv,
            "peak_bytes_after_granular": peak_all}


def phase_cli_server(ctx: Context) -> dict:
    """The CLI in process, then an ``EditorServer`` over HTTP."""
    import http.client

    import melonix_tpu as mlx
    from bench import make_song, song_markers
    from melonix_tpu import cli
    from melonix_tpu.markers import markers_to_json
    from melonix_tpu.ui.web import EditorServer

    s = ctx.sizes
    x = make_song(s.sr, s.cli_s, seed=ctx.seed + 2)
    d = ctx.workdir
    wav = os.path.join(d, "cli.wav")
    mlx.write_wav(wav, x, s.sr, dtype="float32")
    mpath = os.path.join(d, "m.json")
    with open(mpath, "w") as f:
        f.write(markers_to_json(song_markers(len(x), 4)))
    out_wav = os.path.join(d, "cli_pv.wav")
    rcs = [
        cli.main(["render", wav, "--markers", mpath, "-o", out_wav,
                  "--engine", "pv"]),
        cli.main(["spectrogram", wav, "-o", os.path.join(d, "scene.png"),
                  "--width", "640", "--height", "360"]),
        cli.main(["pitch", wav, "-o", os.path.join(d, "curve.json")]),
    ]
    check(rcs == [0, 0, 0], f"cli return codes {rcs}")
    y, _ = mlx.load_audio(out_wav)
    check(abs(len(y) - len(x)) < s.sr and np.abs(y).max() > 0.05,
          f"cli render length {len(y)} / peak")
    with open(os.path.join(d, "scene.png"), "rb") as f:
        check(f.read(8) == b"\x89PNG\r\n\x1a\n", "cli scene is not a PNG")
    with open(os.path.join(d, "curve.json")) as f:
        curve = json.load(f)
    check(len(curve) > 0, "cli pitch curve empty")

    srv = EditorServer(autosave_interval=0.0)
    port = srv.start()
    figs: dict = {"cli_rcs": rcs}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)

        def get(path):
            conn.request("GET", path)
            r = conn.getresponse()
            return r.status, r.read()

        def post(path, body):
            conn.request("POST", path, json.dumps(body))
            r = conn.getresponse()
            return r.status, json.loads(r.read() or b"{}")

        code, st = post("/control", {"action": "open", "value": wav})
        check(code == 200 and st["loaded"], f"open: {code}")
        t0 = time.perf_counter()
        code, png = get("/frame.png?w=640&h=360")
        check(code == 200 and png[:8] == b"\x89PNG\r\n\x1a\n", "frame.png")
        deadline = time.monotonic() + 300.0
        while True:
            _, body = get("/state")
            tiles = json.loads(body)["tiles"]
            if tiles["pending"] == 0 and tiles.get("inflight", 0) == 0:
                break
            check(time.monotonic() < deadline, f"tiles never settled: {tiles}")
            time.sleep(0.05)
        figs["tiles_settle_s"] = round(time.perf_counter() - t0, 3)
        code, _ = post("/event", {"kind": "button", "x": 300, "y": 200,
                                  "pressed": True, "button": 1})
        _, body = get("/state")
        check(code == 200 and json.loads(body)["markers"] == 1, "marker add")
        code, st = post("/control", {"action": "engine", "value": "pv"})
        check(code == 200 and srv.state.engine == "pv", "engine -> pv")
        code, body = get("/audio.wav")
        pcm = np.frombuffer(body[44:], "<i2")
        n_out = int(srv.state.knots.duration() * s.sr)
        check(code == 200 and body[:4] == b"RIFF", "audio.wav header")
        check(abs(len(pcm) - n_out) <= 1, f"audio.wav {len(pcm)} vs {n_out}")
        check(np.abs(pcm).max() > 1000, "audio.wav silent")
        figs["audio_wav_samples"] = int(len(pcm))

        stream = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            stream.request("GET", "/audio/stream?from=0&pace=0")
            resp = stream.getresponse()
            check(resp.status == 200 and resp.read(44)[:4] == b"RIFF",
                  "stream header")
            buf = np.frombuffer(resp.read(2 * 4 * 1024), "<i2")
            check(len(buf) == 4 * 1024 and np.abs(buf).max() > 1000,
                  "stream buffers silent or short")
            figs["stream_samples_read"] = int(len(buf))
            post("/key", {"key": "space"})
            resp.read()
        finally:
            stream.close()
        conn.close()
    finally:
        srv.stop()
    return figs


PHASES = [
    ("native", phase_native),
    ("decode", phase_decode),
    ("tiles", phase_tiles),
    ("headline", phase_headline),
    ("granular", phase_granular),
    ("analysis", phase_analysis),
    ("session", phase_session),
    ("hour", phase_hour),
    ("cli_server", phase_cli_server),
]


# ----------------------------------------------------------------------
# Four cards
# ----------------------------------------------------------------------


def phase_four_cards(ctx: Context) -> dict:
    """Mesh paths over four devices vs the one-device result on device 0."""
    import jax
    import jax.numpy as jnp

    import melonix_tpu as mlx
    from bench import make_song, song_markers
    from melonix_tpu.engine.phase_vocoder import build_pv_plan
    from melonix_tpu.engine.render import build_render_plan
    from melonix_tpu.engine.spectral import hann_window
    from melonix_tpu.parallel import (make_audio_mesh, seq_parallel_pv,
                                      seq_pv_args, seq_render)

    s = ctx.sizes
    n_dev = len(jax.devices())
    check(n_dev >= 4, f"{n_dev} devices visible, need 4")
    figs: dict = {"devices": n_dev}
    mesh = make_audio_mesh(4)
    songs = [make_song(s.sr, s.song_s * (1.0 - 0.1 * i), seed=ctx.seed + i)
             for i in range(4)]
    mks = [song_markers(len(t), s.n_markers) for t in songs]
    for engine in ("pv", "granular"):
        t0 = time.perf_counter()
        got = mlx.render_batch(songs, mks, s.sr, engine=engine, mesh=mesh)
        wall = time.perf_counter() - t0
        worst = 0.0
        for t, ms, g in zip(songs, mks, got):
            want = mlx.render_session(t, ms, s.sr, engine=engine, mesh=None)
            check(g.shape == want.shape, f"batch {engine} shape")
            worst = max(worst, rel_rms(g, want) if engine == "pv"
                        else float(np.max(np.abs(g - want))))
        bar = 2e-2 if engine == "pv" else 2e-6
        check(worst <= bar, f"batch {engine} vs one card {worst:.3e}")
        figs[f"batch_{engine}_worst"] = float(f"{worst:.3e}")
        figs[f"batch_{engine}_wall_s_incl_compile"] = round(wall, 2)

    x = songs[0]
    st = np.stack([x, 0.7 * x[::-1]], axis=1)
    ms = mks[0]
    got = mlx.render_session(st, ms, s.sr, engine="pv", mesh="auto")
    want = mlx.render_session(st, ms, s.sr, engine="pv", mesh=None)
    r = rel_rms(got, want)
    check(got.shape == want.shape and r < 2e-2, f"stereo session rms {r:.2e}")
    figs["session_stereo_rel_rms"] = float(f"{r:.3e}")

    seq_mesh = make_audio_mesh(4, data=1)
    knots = mlx.MapKnots.from_markers(ms, s.sr, len(x))
    plan = build_pv_plan(knots, len(x))
    kw, ops = seq_pv_args(plan, 4)
    f = seq_parallel_pv(seq_mesh, **kw)
    out = np.asarray(f(jnp.asarray(x), *[jnp.asarray(o) for o in ops[:4]],
                       jnp.asarray(hann_window(kw["size"])),
                       *[jnp.asarray(o) for o in ops[4:]]))[: plan.n_out]
    want = mlx.render_track_pv(x, knots)
    r = rel_rms(out, want)
    check(r < 2e-2, f"seq PV rms {r:.2e}")
    figs["seq_pv_rel_rms"] = float(f"{r:.3e}")

    table = mlx.build_grain_table(x)
    gplan = build_render_plan(table, knots)
    g_out, n_valid = seq_render(seq_mesh, gplan, x)
    want = mlx.render_track(x, table, knots)
    err = float(np.max(np.abs(g_out[:n_valid] - want[:n_valid])))
    check(err <= 2e-6, f"seq granular max err {err:.3e}")
    figs["seq_granular_max_err"] = err
    figs["bars"] = {"pv_rel_rms": 2e-2, "granular_max_err": 2e-6}
    return figs


# ----------------------------------------------------------------------
# Driver
# ----------------------------------------------------------------------


def _gpu_name_and_limit() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc!r}"


def run_phase(name: str, fn, ctx: Context) -> dict:
    t0 = time.perf_counter()
    figs = fn(ctx)
    wall = time.perf_counter() - t0
    print(f"PASS {name} wall_s={wall:.2f} {json.dumps(figs)}", flush=True)
    return figs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-device mesh phase")
    args = ap.parse_args(argv)

    # The CPU-side references (``_on_cpu``) need the CPU backend next to
    # the GPU one when the environment pins the platform list.
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (platform {devs[0].platform!r}); "
              "this script measures nothing elsewhere", file=sys.stderr)
        return 2

    from melonix_tpu.runtime import compile_cache

    print(_gpu_name_and_limit(), flush=True)
    print(f"device_kind={devs[0].device_kind} count={len(devs)} "
          f"jax={jax.__version__} "
          f"compile_cache={compile_cache.enable()}", flush=True)
    with tempfile.TemporaryDirectory(prefix="melonix_smoke_") as work:
        os.environ.setdefault("MELONIX_AUTOSAVE_DIR",
                              os.path.join(work, "autosave"))
        ctx = Context(sizes=FULL, seed=args.seed, workdir=work)
        phases = ([("four_cards", phase_four_cards)] if args.four_cards
                  else PHASES)
        for name, fn in phases:
            run_phase(name, fn, ctx)
    print(_gpu_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
