"""Per-stage device times of the XLA pipeline at the real shapes (one GPU).

Times each device stage of the headline path on a 180 s, 44.1 kHz song
with 12 markers — |STFT|, PV analysis / phase / synthesis, PV resample,
granular render, 256 x 32768 tile columns, pitch — as the median of warm
calls bracketed by ``jax.block_until_ready``, next to the bytes the stage
must move at least (its inputs plus outputs) and that bound's share of the
card's memory bandwidth.  A large device copy is timed in the same process
as the achievable-bandwidth reference.

    python stage_times.py [--reps N]

Prints one JSON object per stage (``pv_host_plan_180s`` is host time,
not device time), then the card's name and power limit.
Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_S = {"H100": 3.35e12}  # HBM bytes/s, NVIDIA data sheet (SXM)


def _median_ms(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"stage_times: no GPU (platform {dev.platform!r})", file=sys.stderr)
        return 2
    peak = next((v for k, v in PEAK_BYTES_S.items() if k in dev.device_kind),
                None)
    if peak is None:
        print(f"stage_times: no peak bandwidth for {dev.device_kind!r}",
              file=sys.stderr)
        return 2

    from bench import make_song, song_markers
    from melonix_tpu.config import DEFAULT_CONFIG as cfg
    from melonix_tpu.engine import phase_vocoder as pv
    from melonix_tpu.engine.grains import build_grain_table
    from melonix_tpu.engine.maps import MapKnots
    from melonix_tpu.engine.pitch import _pitch_device
    from melonix_tpu.engine.render import (build_render_plan, render_device,
                                           render_device_args)
    from melonix_tpu.engine.spectral import (hann_window, istft_device,
                                             num_frames, stft_mags_device)
    from melonix_tpu.runtime.tiles import _get_tiles_program, _resample_tables

    sr = 44100
    x = make_song(sr, 180.0)
    n = len(x)
    knots = MapKnots.from_markers(song_markers(n), sr, n)
    wav = jnp.asarray(x)
    size, hop = cfg.stft_size, cfg.stft_hop
    win = jnp.asarray(hann_window(size))
    f32 = 4
    rows = []

    def stage(name, fn, min_bytes, **extra):
        ms = _median_ms(fn, args.reps)
        bound_ms = min_bytes / peak * 1e3
        rows.append(dict(stage=name, ms=round(ms, 4), min_bytes=int(min_bytes),
                         roofline_share=round(bound_ms / ms, 4), **extra))
        print(json.dumps(rows[-1]), flush=True)

    big = jnp.zeros((1 << 28,), jnp.float32)  # 1 GiB
    copy = jax.jit(lambda a: a + 1.0)
    stage("copy_1GiB_reference", lambda: copy(big), 2 * big.size * f32)
    del big

    nf = num_frames(n, size, hop)
    stage("stft_mags_180s", lambda: stft_mags_device(wav, win, size, hop, nf),
          n * f32 + nf * (size // 2) * f32, frames=nf)

    plan = pv.build_pv_plan(knots, n)
    F, nb = plan.n_frames, size // 2 + 1
    starts = jnp.asarray(plan.starts_m)
    da = jnp.asarray(plan.da_m)

    @jax.jit
    def analysis(w, st):
        idx = st[:, None] + jnp.arange(size, dtype=jnp.int32)[None, :]
        fr = jnp.where(idx < n, w[jnp.clip(idx, 0, n - 1)], 0.0)
        spec = jnp.fft.rfft(fr * win[None, :])
        return jnp.abs(spec), jnp.angle(spec)

    mag, phi = analysis(wav, starts)

    @jax.jit
    def phase(phi, da):
        omega = (2.0 * jnp.pi / size) * jnp.arange(nb, dtype=jnp.float32)
        d = jnp.maximum(da, 1e-3)[:, None]
        prev = jnp.concatenate([jnp.zeros_like(phi[:1]), phi[:-1]], axis=0)
        incr = hop * pv._princarg(phi - prev - omega[None, :] * d) / d
        incr = incr.at[0].set(0.0)
        hm = jnp.mod(jnp.arange(F, dtype=jnp.int32) * hop, size)
        ramp = (2.0 * jnp.pi / size) * jnp.mod(
            hm[:, None] * jnp.arange(nb, dtype=jnp.int32)[None, :], size
        ).astype(jnp.float32)
        return phi[0][None, :] + ramp + jnp.cumsum(incr, axis=0)

    psis = phase(phi, da)

    @jax.jit
    def synthesis(mag, psis):
        return istft_device(mag * jnp.exp(1j * psis), win, size, hop,
                            plan.stretch_len, normalize=False)

    spec_bytes = F * nb * f32
    stage("pv_analysis", lambda: analysis(wav, starts),
          n * f32 + 2 * spec_bytes, frames=F)
    stage("pv_phase", lambda: phase(phi, da), 2 * spec_bytes, frames=F)
    stage("pv_synthesis", lambda: synthesis(mag, psis),
          2 * spec_bytes + plan.stretch_len * f32, frames=F)

    ch = min(pv.PV_CHUNK_FRAMES, F)
    packed = jnp.asarray(pv._pack_frame_plan(plan, ch, False))
    z = jnp.zeros(nb, jnp.float32)
    stage("pv_stretch_chunk_program",
          lambda: pv._stretch_chunk_packed(wav, packed, win, jnp.int32(0),
                                           jnp.int32(F), z, z, z, size, hop, ch),
          n * f32 + plan.stretch_len * f32, frames=F)

    y = jnp.asarray(np.random.default_rng(0).standard_normal(
        plan.stretch_len).astype(np.float32))
    anc = plan.anc_args
    base = jnp.asarray(plan.base)

    def resample():
        src = pv._positions_rel_device(*anc, plan.n_out_pad, sr)
        return pv._lerp_resample_rel_xla(y, src, base, plan.stretch_len, pv.BLK)

    stage("pv_resample", resample,
          plan.stretch_len * f32 + plan.n_out_pad * f32, out=plan.n_out_pad)
    stage("pv_render_track_180s",
          lambda: pv.render_track_pv(wav, knots, device_out=True),
          n * f32 + plan.n_out * f32)
    # The same render from a prebuilt plan: the difference to the line
    # above is the host control plane (float64 maps, anchors, frame plan).
    stage("pv_render_prebuilt_plan_180s",
          lambda: pv._render_with_plan(wav, plan, False, device_out=True),
          n * f32 + plan.n_out * f32)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        pv.build_pv_plan(knots, n)
    host_ms = (time.perf_counter() - t0) / args.reps * 1e3
    rows.append(dict(stage="pv_host_plan_180s", ms=round(host_ms, 4),
                     where="host"))
    print(json.dumps(rows[-1]), flush=True)
    stage("headline_stft_plus_pv_180s",
          lambda: (stft_mags_device(wav, win, size, hop, nf),
                   pv.render_track_pv(wav, knots, device_out=True)),
          2 * n * f32 + nf * (size // 2) * f32 + plan.n_out * f32)

    table = build_grain_table(x)
    gplan = build_render_plan(table, knots)
    out_len = 8192 * -(-gplan.total_out // 8192)
    offs, gs, rb, nv, _, fi, fv = render_device_args(gplan, x, out_len)
    gargs = [jnp.asarray(a) for a in (offs, gs, rb)]
    fargs = (jnp.asarray(fi), jnp.asarray(fv))
    stage("granular_render_device",
          lambda: render_device(wav, *gargs, nv, out_len, *fargs),
          n * f32 + out_len * f32, out=out_len, steps=gplan.n_steps)

    cols, csize = 256, cfg.spectr_size
    rng = np.random.default_rng(1)
    ends = jnp.asarray(rng.integers(csize, n, cols).astype(np.int32))
    starts_c = ends - 4410
    ids, nearest = _resample_tables(csize // 2, cfg.tile_texels,
                                    cfg.tile_frac_min)
    ids, nearest = jnp.asarray(ids), jnp.asarray(nearest)
    prog = _get_tiles_program()
    stage("tile_columns_256x32768",
          lambda: prog(wav, starts_c, ends, jnp.float32(16384.0), ids,
                       nearest, size=csize, texels=cfg.tile_texels),
          cols * csize * f32 + cols * cfg.tile_texels, columns=cols)

    pf, ph = cfg.pitch_frame, cfg.pitch_hop
    pnf = 1 + (n - pf) // ph
    lag_min = max(2, int(sr / cfg.pitch_fmax))
    lag_max = min(pf - 2, int(sr / cfg.pitch_fmin))
    stage("pitch_nsdf", lambda: _pitch_device(wav, pf, ph, pnf, lag_min, lag_max),
          n * f32 + 3 * pnf * f32, frames=pnf)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device_kind": dev.device_kind, "nvidia_smi": smi,
                      "peak_bytes_s": peak, "reps": args.reps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
