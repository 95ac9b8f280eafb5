"""Per-engine device-time benchmark suite (diagnostic; bench.py is official).

Runs every compute engine on a 180 s mono 44.1 kHz song and reports
measured on-device time per pass (summed jit_* program durations from a
jax.profiler trace, as bench.py measures).  Prints one JSON object.

Usage: python bench_engines.py
"""

from __future__ import annotations

import json
import tempfile

import numpy as np


def _trace_ms(fn, anchor, iters: int = 3) -> float:
    """Device ms/iter from a profiler trace; wall clock when no trace
    (bare CPU CI) — same fallback contract as bench.py."""
    import time

    import jax

    from bench import _device_ms_per_iter

    fn()  # warm / compile
    anchor()
    d = tempfile.mkdtemp(prefix="mlx_engbench_")
    t0 = time.perf_counter()
    try:
        with jax.profiler.trace(d):
            for _ in range(iters):
                fn()
            anchor()
        dev = _device_ms_per_iter(d, iters)
    except Exception:
        dev = None
    wall_ms = (time.perf_counter() - t0) / iters * 1000.0
    return dev if dev else wall_ms


def main() -> None:
    import jax
    import jax.numpy as jnp

    import bench as B
    import melonix_tpu as mlx
    from melonix_tpu.config import DEFAULT_CONFIG as cfg
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.engine.pitch import pitch_curve
    from melonix_tpu.engine.render import build_render_plan, render
    from melonix_tpu.engine.spectral import (
        hann_window,
        num_frames,
        spectrogram_columns_device,
        stft_mags_device,
    )
    from melonix_tpu.io.resample import resample

    sr = 44100
    seconds = 180.0
    x = B.make_song(sr, seconds)
    table = mlx.build_grain_table(x)
    markers = [
        mlx.Marker(sample=int((i + 1) * len(x) / 14), note=57.0,
                   d_time=0.01 * (-1) ** i, pitch_bend=float((-1) ** i) * (1 + i % 4))
        for i in range(12)
    ]
    knots = mlx.MapKnots.from_markers(markers, sr, len(x))
    plan = build_render_plan(table, knots)
    wav_dev = jnp.asarray(x)
    win = jnp.asarray(hann_window(cfg.stft_size))
    nf = num_frames(len(x), cfg.stft_size, cfg.stft_hop)

    results = {}

    m = [None]
    results["stft_mags_2048_75pct_ms"] = round(_trace_ms(
        lambda: m.__setitem__(0, stft_mags_device(wav_dev, win, cfg.stft_size, cfg.stft_hop, nf)),
        lambda: float(m[0][5, 5]),
    ), 3)

    o = [None]
    results["granular_render_ms"] = round(_trace_ms(
        lambda: o.__setitem__(0, render(x, plan)),
        lambda: float(np.sum(o[0][:16])),
    ), 2)

    results["phase_vocoder_ms"] = round(_trace_ms(
        lambda: o.__setitem__(0, render_track_pv(x, knots)),
        lambda: float(np.sum(o[0][:16])),
    ), 2)

    results["phase_vocoder_formant_ms"] = round(_trace_ms(
        lambda: o.__setitem__(0, render_track_pv(x, knots, preserve_formants=True)),
        lambda: float(np.sum(o[0][:16])),
    ), 2)

    results["pitch_curve_ms"] = round(_trace_ms(
        lambda: o.__setitem__(0, pitch_curve(x, sr)),
        lambda: float(np.sum(o[0].f0[:16])),
    ), 2)

    results["resample_44k1_to_48k_ms"] = round(_trace_ms(
        lambda: o.__setitem__(0, resample(x, 44100, 48000)),
        lambda: float(np.sum(o[0][:16])),
    ), 2)

    stereo = np.stack([x, 0.8 * x], axis=1)
    results["stereo_pv_session_ms"] = round(_trace_ms(
        lambda: o.__setitem__(0, mlx.render_session(stereo, markers, sr, engine="pv")),
        lambda: float(np.sum(o[0][:16, 0])),
    ), 2)

    rng = np.random.default_rng(1)
    ends = jnp.asarray(rng.integers(cfg.spectr_size, len(x), 256).astype(np.int32))
    starts = ends - 4410
    results["reference_columns_256x32768_ms"] = round(_trace_ms(
        lambda: o.__setitem__(0, spectrogram_columns_device(
            wav_dev, starts, ends, size=cfg.spectr_size)),
        lambda: float(np.asarray(o[0][0, :4]).sum()),
    ), 3)

    for k, v in list(results.items()):
        if k.endswith("_ms") and "columns" not in k and "stft" not in k:
            results[k.replace("_ms", "_x_realtime")] = round(seconds / (v / 1000.0))

    results["platform"] = jax.devices()[0].platform
    results["track_seconds"] = seconds
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
