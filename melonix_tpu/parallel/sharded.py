"""Multi-chip sharding of the analysis/render pipeline.

The reference's only concurrency is three host threads (SURVEY.md §1); this
module is the device-native replacement: SPMD over a ``jax.sharding.Mesh``
with two axes —

* ``data``  — batch of tracks / sessions (batched session render,
  BASELINE.json config #5): pure data parallelism, no communication.
* ``seq``   — the sample/frame axis *within* a track (the "long-track"
  dimension, SURVEY.md §5 long-context analogue): frames are sharded
  contiguously and the STFT window overlap crossing shard boundaries is
  satisfied by a one-hop ``ppermute`` halo exchange — the same
  neighbor-block-passing primitive as ring attention, applied to
  overlap-save spectral analysis.  The mesh follows the algorithm: every
  device pair is assumed equally close, so axis order carries no
  topology.

Everything is expressed with ``jax.shard_map`` so XLA sees static local
shapes and inserts exactly the collectives we ask for.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, Mesh, PartitionSpec as P


def make_audio_mesh(n_devices: int | None = None, data: int | None = None) -> Mesh:
    """Mesh over (data, seq).  ``data`` defaults to the largest power-of-two
    divisor ≤ sqrt(n); the rest goes to ``seq`` (frame/sample sharding)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if data is None:
        data = 1
        while n % (data * 2) == 0 and data * 2 * data * 2 <= n:
            data *= 2
    assert n % data == 0, (n, data)
    # Auto axis types: we annotate shardings at shard_map boundaries rather
    # than carrying explicit sharding-in-types through every intermediate.
    return jax.make_mesh(
        (data, n // data),
        ("data", "seq"),
        axis_types=(AxisType.Auto, AxisType.Auto),
        devices=devs[:n],
    )


# ----------------------------------------------------------------------
# Halo-exchange STFT: sample axis sharded over `seq`.
# ----------------------------------------------------------------------


from ..engine.spectral import extract_hop_frames as _extract_hop_frames


def _stft_local(chunk, halo_from_right, window, size, hop):
    """Frames whose start lies in this shard; right-halo provides overlap."""
    local = jnp.concatenate([chunk, halo_from_right], axis=-1)
    n_frames = chunk.shape[-1] // hop
    frames = _extract_hop_frames(local, size, hop, n_frames) * window[None, :]
    spec = jnp.fft.rfft(frames)
    return jnp.sqrt(spec.real * spec.real + spec.imag * spec.imag)


def sharded_stft_mags(
    wav: jnp.ndarray,
    window: jnp.ndarray,
    mesh: Mesh,
    *,
    size: int,
    hop: int,
) -> jnp.ndarray:
    """STFT magnitudes of one track, sample axis sharded over ``seq``.

    ``len(wav)`` must divide evenly into seq-shards of a multiple of ``hop``,
    with ``size - hop <= chunk`` (one-hop halo).  Returns (n_frames, bins)
    sharded over ``seq`` on the frame axis.
    """
    n_seq = mesh.shape["seq"]
    n = wav.shape[-1]
    chunk = n // n_seq
    halo = size - hop
    assert chunk % hop == 0 and halo <= chunk, (chunk, hop, size)

    def body(w_local):
        # Send my leading `halo` samples to my LEFT neighbor (their right halo).
        idx = jax.lax.axis_index("seq")
        n_shards = jax.lax.axis_size("seq")
        head = w_local[0, :halo]
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        recv = jax.lax.ppermute(head, "seq", perm)
        # Last shard's "right halo" wraps from shard 0 — mask it to zero
        # (windows past the track end read zeros, spec semantics).
        recv = jnp.where(idx == n_shards - 1, jnp.zeros_like(recv), recv)
        mags = _stft_local(w_local[0], recv, window, size, hop)
        return mags[None]

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, "seq"),),
        out_specs=P(None, "seq", None),
    )
    return f(wav[None])[0]


# ----------------------------------------------------------------------
# Pitch curve, frame axis sharded over `seq` (same halo pattern as the
# STFT: a frame starting near a shard's right edge reads into the next
# shard, satisfied by a one-hop ppermute).
# ----------------------------------------------------------------------


def sharded_pitch(
    wav: jnp.ndarray,
    mesh: Mesh,
    *,
    frame: int,
    hop: int,
    lag_min: int,
    lag_max: int,
):
    """(lag, clarity, energy) per frame, frame axis sharded over ``seq``.

    Same shard-quantization contract as sharded_stft_mags: the per-shard
    chunk must be a multiple of ``hop`` with ``frame - hop <= chunk``.
    """
    from ..engine.pitch import pitch_core

    n_seq = mesh.shape["seq"]
    n = wav.shape[-1]
    chunk = n // n_seq
    halo = frame - hop
    assert chunk % hop == 0 and halo <= chunk, (chunk, hop, frame)

    def body(w_local):
        idx = jax.lax.axis_index("seq")
        n_shards = jax.lax.axis_size("seq")
        head = w_local[0, :halo]
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        recv = jax.lax.ppermute(head, "seq", perm)
        recv = jnp.where(idx == n_shards - 1, jnp.zeros_like(recv), recv)
        local = jnp.concatenate([w_local[0], recv], axis=-1)
        n_frames = chunk // hop
        frames = _extract_hop_frames(local, frame, hop, n_frames)
        w = frames - jnp.mean(frames, axis=1, keepdims=True)
        lag, clarity, energy = pitch_core(w, frame, lag_min, lag_max)
        return lag[None], clarity[None], energy[None]

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, "seq"),),
        out_specs=(P(None, "seq"),) * 3,
    )
    lag, clarity, energy = f(wav[None])
    return lag[0], clarity[0], energy[0]


# ----------------------------------------------------------------------
# Reference-semantics spectrogram columns, column axis sharded over `seq`.
# Columns are independent (each gathers its own end-anchored window from a
# replicated track), so this is embarrassingly parallel over chips; it is
# the scale-out path for "compute the whole multi-resolution pyramid at
# file-open" (SURVEY.md §7 design stance).
# ----------------------------------------------------------------------


def sharded_spectrogram_columns(
    wav: jnp.ndarray,
    starts: jnp.ndarray,
    ends: jnp.ndarray,
    mesh: Mesh,
    *,
    size: int,
) -> jnp.ndarray:
    from ..engine.spectral import _extract_frames

    def body(w, s, e):
        frames = _extract_frames(w, s[0], e[0], size)
        spec = jnp.fft.fft(frames)
        return (jnp.abs(spec[:, : size // 2]) / size).astype(jnp.float32)[None]

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(None, "seq"), P(None, "seq")),
        out_specs=P(None, "seq", None),
    )
    return f(wav, starts[None], ends[None])[0]


# ----------------------------------------------------------------------
# Data-parallel batched session render: batch axis over `data`.
# ----------------------------------------------------------------------


def _render_one(wav, grain_start, grain_len, rate, out_offset, seam_src, n_valid, out_len):
    """One track's granular render, same segmented-broadcast formulation as
    engine/render.render_device (two wav gathers; per-step constants reach
    samples via scatter-diff + int32 cumsum).  The batched plans are padded,
    so the in-grain/seam masking stays in-kernel here instead of the host
    seam-fix scatter the single-track path uses."""
    n = wav.shape[0]
    j = jnp.arange(out_len, dtype=jnp.int32)
    offsets = out_offset[:-1].astype(jnp.int32)

    def seg_i32(vals):
        d = jnp.zeros(out_len, jnp.int32).at[offsets[1:]].add(
            jnp.diff(vals), mode="drop"
        )
        return vals[0] + jnp.cumsum(d)

    off = seg_i32(offsets)
    gs = seg_i32(grain_start.astype(jnp.int32))
    gl = seg_i32(grain_len.astype(jnp.int32))
    seam = seg_i32(seam_src.astype(jnp.int32))
    r = jax.lax.bitcast_convert_type(
        seg_i32(jax.lax.bitcast_convert_type(rate, jnp.int32)), jnp.float32
    )
    i = (j - off).astype(jnp.float32)
    x = i * r
    idx_f = jnp.floor(x)
    frac = x - idx_f
    idx = idx_f.astype(jnp.int32)
    src = gs + idx
    in_grain = idx + 1 < gl
    lo = wav[jnp.clip(src, 0, n - 1)]
    hi = jnp.where(
        in_grain,
        wav[jnp.clip(src + 1, 0, n - 1)],
        jnp.where(seam >= 0, wav[jnp.clip(seam, 0, n - 1)], 0.0),
    )
    out = (1.0 - frac) * lo + frac * hi
    return jnp.where(j < n_valid, out, 0.0)


def data_parallel_render(
    wav_b: jnp.ndarray,  # (B, n) track batch
    grain_start_b: jnp.ndarray,  # (B, S) padded plan arrays
    grain_len_b: jnp.ndarray,
    rate_b: jnp.ndarray,
    out_offset_b: jnp.ndarray,  # (B, S+1)
    seam_src_b: jnp.ndarray,
    n_valid_b: jnp.ndarray,  # (B,)
    mesh: Mesh,
    out_len: int,
) -> jnp.ndarray:
    """Batched granular render, tracks sharded over ``data`` (BASELINE
    config #5: 100+ marker stereo sessions in one shot)."""

    def body(w, gs, gl, r, oo, ss, nv):
        return jax.vmap(
            lambda *a: _render_one(*a, out_len)
        )(w, gs, gl, r, oo, ss, nv)

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("data"),) * 7,
        out_specs=P("data"),
    )
    return f(wav_b, grain_start_b, grain_len_b, rate_b, out_offset_b, seam_src_b, n_valid_b)


# ----------------------------------------------------------------------
# Sequence-parallel granular render: ONE track's output axis over `seq`.
# ----------------------------------------------------------------------


def seq_parallel_render(
    mesh: Mesh,
    wav: jnp.ndarray,  # (n,) replicated source samples
    offsets: jnp.ndarray,  # int32 (S,) global step output starts (out_offset[:-1])
    gstart: jnp.ndarray,  # int32 (S,)
    rate_bits: jnp.ndarray,  # int32 (S,) f32 bit patterns
    base_off: jnp.ndarray,  # int32 (n_seq,) active-step values at shard starts
    base_gs: jnp.ndarray,
    base_rb: jnp.ndarray,
    n_valid_out,
    out_len: int,  # padded to a multiple of mesh.shape["seq"]
    fix_idx: jnp.ndarray,  # int32 (K,) global seam-fix positions (out_len = drop)
    fix_val: jnp.ndarray,  # float32 (K,)
) -> jnp.ndarray:
    """Seq-sharded single-track granular render.

    The per-step plan state (offsets/grain starts/rate bits) is int32
    segmented broadcasts — bit-exact under sharding; the float lerp can
    differ from the single-device program by ~1 ulp (XLA fuses the
    interpolation differently per compilation), so parity tests compare
    with the granular tolerance (2e-6), not bit equality.

    The render is two gathers from the replicated track plus segmented
    broadcasts of per-step constants; the broadcast is a prefix sum over
    the OUTPUT axis, so sharding that axis only needs each shard's
    starting value.  Those come precomputed from the host control plane
    (``seq_render_args`` — the plan lives there anyway, SURVEY §7), so
    unlike the PV phase carry there is NO collective here: each shard
    scatters the step diffs that land strictly inside it on top of its
    host-supplied base and cumsums locally.  Seam fixes arrive as global
    positions and drop to the owning shard."""
    n_seq = mesh.shape["seq"]
    assert out_len % n_seq == 0, (out_len, n_seq)
    L = out_len // n_seq

    def body(w, offs, gs_s, rb_s, b_off, b_gs, b_rb, nv, fidx, fval):
        idx = jax.lax.axis_index("seq")
        shard0 = (idx * L).astype(jnp.int32)
        j_local = jnp.arange(L, dtype=jnp.int32)
        j = shard0 + j_local
        n = w.shape[0]

        # Steps starting at or before shard0 are folded into the base
        # value; only strictly-interior step starts scatter here (a start
        # exactly AT shard0 is the base itself — push it out of range).
        p = offs[1:] - shard0
        pos = jnp.where(p >= 1, p, L)

        def seg(vals, base):
            d = jnp.zeros(L, jnp.int32).at[pos].add(jnp.diff(vals), mode="drop")
            return base + jnp.cumsum(d)

        off = seg(offs, b_off[0])
        gs = seg(gs_s, b_gs[0])
        r = jax.lax.bitcast_convert_type(seg(rb_s, b_rb[0]), jnp.float32)
        i = (j - off).astype(jnp.float32)
        x = i * r  # float32, matches the reference's f32(i) * rate
        idx_f = jnp.floor(x)
        frac = x - idx_f
        src = gs + idx_f.astype(jnp.int32)
        lo = w[jnp.clip(src, 0, n - 1)]
        hi = w[jnp.clip(src + 1, 0, n - 1)]
        out = (1.0 - frac) * lo + frac * hi
        out = jnp.where(j < nv, out, 0.0)
        fpos = fidx - shard0
        fpos = jnp.where((fpos >= 0) & (fpos < L), fpos, L)
        return out.at[fpos].set(fval, mode="drop")

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("seq"), P("seq"), P("seq"), P(), P(), P()),
        out_specs=P("seq"),
    )
    return f(wav, offsets, gstart, rate_bits, base_off, base_gs, base_rb,
             jnp.int32(n_valid_out), fix_idx, fix_val)


def seq_render(mesh: Mesh, plan, wav) -> tuple[np.ndarray, int]:
    """Pad, build operands, and dispatch ONE track's seq-sharded granular
    render.  Returns (padded output as a host array, n_grain_out) —
    callers slice/extend as they need.  The single place that knows the
    (blk quantum, operand order) contract."""
    n_grain_out = int(plan.out_offset[-1]) if len(plan.out_offset) else 0
    if n_grain_out == 0 or plan.n_steps == 0:
        return np.zeros(0, np.float32), 0
    n_seq = mesh.shape["seq"]
    blk = n_seq * 1024
    out_len = blk * -(-n_grain_out // blk)
    wav_np = np.asarray(wav, np.float32)
    args = seq_render_args(plan, wav_np, out_len, n_seq)
    out = seq_parallel_render(
        mesh, jnp.asarray(wav_np),
        *[jnp.asarray(a) for a in args[:6]],
        args[6], out_len,
        jnp.asarray(args[7]), jnp.asarray(args[8]),
    )
    return np.asarray(out), n_grain_out


def seq_render_args(plan, wav, out_len: int, n_seq: int):
    """Host operands for seq_parallel_render: the single-track device args
    (engine/render.render_device_args) plus each shard's active-step base
    values, read straight off the host plan."""
    from ..engine.render import render_device_args

    offsets, gstart, rate_bits, n_valid, _out_len, fix_idx, fix_val = (
        render_device_args(plan, wav, out_len)
    )
    assert out_len % n_seq == 0, (out_len, n_seq)
    shard0 = np.arange(n_seq, dtype=np.int64) * (out_len // n_seq)
    sa = np.clip(
        np.searchsorted(offsets.astype(np.int64), shard0, side="right") - 1,
        0, len(offsets) - 1,
    ).astype(np.int64)
    return (
        offsets, gstart, rate_bits,
        offsets[sa].copy(), gstart[sa].copy(), rate_bits[sa].copy(),
        n_valid, fix_idx, fix_val,
    )


# ----------------------------------------------------------------------
# Data-parallel phase-vocoder render: tracks/channels over `data`.
# ----------------------------------------------------------------------


def _wsum_masked(window, fr, size: int, hop: int, n_frames: int,
                 stretch_len: int):
    """Window-square OLA normalizer masked by a TRACED live frame count.

    Same stride-stacked construction as phase_vocoder._ola_wsum, but only
    frames < ``fr`` contribute — bit-identical normalization to the
    track's own single-device render despite a shared padded n_frames
    (and, in the seq-sharded path, despite the shard-multiple padding:
    the padded frames' magnitudes are masked to zero, so an unmasked
    wsum would attenuate the real tail by up to size-hop samples —
    ADVICE r3 #1)."""
    k = size // hop
    pad_f = (-n_frames) % k
    total = (n_frames + pad_f) * hop + (k - 1) * hop + size
    w2 = window * window
    wsum = jnp.zeros(total, jnp.float32)
    for g in range(k):
        segw = jnp.tile(w2, (n_frames + pad_f) // k)
        segw = jnp.where(
            jnp.arange(segw.shape[0]) // size * k + g < fr, segw, 0.0
        )
        wsum = wsum.at[g * hop : g * hop + segw.shape[0]].add(segw)
    out = (
        wsum[:stretch_len]
        if total >= stretch_len
        else jnp.pad(wsum, (0, stretch_len - total))
    )
    return jnp.maximum(out, 1e-8)


def data_parallel_pv(
    mesh: Mesh,
    *,
    size: int,
    hop: int,
    n_frames: int,
    stretch_len: int,
    n_out_pad: int,
    sr: int,
    formant: bool = False,
    n_ceps: int = 40,
    lock: bool = False,
):
    """Jitted full PV render (stretch → normalize → resample) of a batch of
    tracks sharded over ``data`` — the quality engine's multi-device path
    (VERDICT weak #6).

    Single-chunk formulation: every track's frame plan fits one stretch
    chunk (session-scale; hour-scale single tracks use the chunked
    ``render_track_pv``).  Per-track host plans (engine/phase_vocoder.
    build_pv_plan) bucket to shared static (n_frames, n_out_pad) shapes
    with edge padding; ``f_real_b`` masks each track's live frames.

    Returns f(wav_b, starts_b, da_b, rho_b, f_real_b, window,
    anc_j_b, src_b, r_b, s_b, base_b) -> (B, n_out_pad) rendered audio.
    """
    from ..engine.phase_vocoder import (
        BLK,
        _lerp_resample_rel_xla,
        _positions_rel_device,
        _stretch_chunk_core,
    )

    n_bins = size // 2 + 1

    def step(wav_b, starts_b, da_b, rho_b, f_real_b, window,
             anc_j_b, src_b, r_b, s_b, base_b):
        def body(w, st, da, rho, fr, win, aj, sb, rb, ssb, bb):
            def one(w1, st1, da1, rho1, fr1, aj1, sb1, rb1, ss1, bb1):
                z = jnp.zeros(n_bins, jnp.float32)
                y, _, _, _ = _stretch_chunk_core(
                    w1, st1, da1, rho1, win, jnp.int32(0), fr1, z, z, z,
                    size=size, hop=hop, n_frames_c=n_frames,
                    formant=formant, n_ceps=n_ceps, lock=lock,
                )
                y = y[:stretch_len] / _wsum_masked(
                    win, fr1, size, hop, n_frames, stretch_len
                )
                src_rel = _positions_rel_device(aj1, sb1, rb1, ss1, n_out_pad, sr)
                return _lerp_resample_rel_xla(y, src_rel, bb1, stretch_len, BLK)

            return jax.vmap(one)(w, st, da, rho, fr, aj, sb, rb, ssb, bb)

        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("data"),) * 5 + (P(),) + (P("data"),) * 5,
            out_specs=P("data"),
        )(wav_b, starts_b, da_b, rho_b, f_real_b, window,
          anc_j_b, src_b, r_b, s_b, base_b)

    return jax.jit(step)


def granular_batch_args(plans):
    """Bucket per-track RenderPlans to the shared static shapes
    data_parallel_render needs.  Padding steps carry strictly-increasing
    out_offsets past each track's n_valid (the segmented broadcast needs
    ordered scatter positions) with rate 1 / length 1 / seam −1, all
    masked out by ``n_valid``.  Returns (gs, gl, rt, oo, ss, nv,
    out_max)."""
    s_max = max(p.n_steps for p in plans)
    out_max = max(int(p.out_offset[-1]) for p in plans)
    B = len(plans)
    gs = np.zeros((B, s_max), np.int32)
    gl = np.ones((B, s_max), np.int32)
    rt = np.ones((B, s_max), np.float32)
    oo = np.full((B, s_max + 1), 2**30, np.int32)
    ss = np.full((B, s_max), -1, np.int32)
    nv = np.zeros((B,), np.int32)
    for b, p in enumerate(plans):
        s = p.n_steps
        gs[b, :s] = p.grain_start
        gl[b, :s] = p.grain_len
        rt[b, :s] = p.rate
        oo[b, : s + 1] = p.out_offset
        oo[b, s + 1 :] = p.out_offset[-1] + 1 + np.arange(s_max - s)
        ss[b, :s] = p.seam_src
        nv[b] = p.out_offset[-1]
    return gs, gl, rt, oo, ss, nv, out_max


def pv_batch_args(plans, mesh=None):
    """Bucket per-track PVPlans to the shared static shapes data_parallel_pv
    needs; returns (kwargs-for-builder, operand arrays).  ``plans`` must
    share (size, hop, sr); tracks pad with edge frames masked by f_real."""
    size, hop, sr = plans[0].size, plans[0].hop, plans[0].sr
    assert all((p.size, p.hop, p.sr) == (size, hop, sr) for p in plans)
    n_frames = max(p.n_frames for p in plans)
    stretch_len = (n_frames - 1) * hop + size
    n_out_pad = max(p.n_out_pad for p in plans)
    n_anc = max(p.anc_args[0].shape[0] for p in plans)
    n_base = max(len(p.base) for p in plans)
    B = len(plans)

    def pad1(a, n, mode="edge", const=None):
        a = np.asarray(a)
        if const is not None:
            return np.pad(a, (0, n - len(a)), constant_values=const)
        return np.pad(a, (0, n - len(a)), mode=mode)

    starts_b = np.stack([pad1(p.starts_m, n_frames) for p in plans])
    da_b = np.stack([pad1(p.da_m, n_frames, const=float(hop)) for p in plans])
    rho_b = np.stack(
        [pad1(p.rho_m.astype(np.float32), n_frames) for p in plans]
    )
    f_real_b = np.asarray([p.n_frames for p in plans], np.int32)
    anc_j_b = np.stack(
        [pad1(np.asarray(p.anc_args[0]), n_anc, const=n_out_pad) for p in plans]
    )
    src_b = np.stack([pad1(np.asarray(p.anc_args[1]), n_anc) for p in plans])
    r_b = np.stack([pad1(np.asarray(p.anc_args[2]), n_anc) for p in plans])
    s_b = np.stack([pad1(np.asarray(p.anc_args[3]), n_anc) for p in plans])
    base_b = np.stack([pad1(p.base, n_base) for p in plans])
    builder_kw = dict(
        size=size, hop=hop, n_frames=n_frames,
        stretch_len=stretch_len, n_out_pad=n_out_pad, sr=sr,
    )
    ops = (starts_b, da_b, rho_b, f_real_b, anc_j_b, src_b, r_b, s_b, base_b)
    return builder_kw, ops


# ----------------------------------------------------------------------
# Sequence-parallel phase-vocoder render: ONE track's stretch frames
# sharded over `seq` (SURVEY §5's frame-axis sharding mandate; VERDICT
# round 2, next #4).  The chunked path proved the decomposition is exact —
# phase propagation is a prefix sum, OLA is linear — so distributing it is
# the same carry math, moved by collectives:
#
#   * analysis phases:  each shard's first frame needs its LEFT
#     neighbor's last analysis phase — one-hop ``ppermute``;
#   * phase prefix sum: shard-local cumsum + exclusive cross-shard carry
#     (``all_gather`` of the per-shard totals, masked sum — the
#     distributed scan);
#   * OLA seams:        each shard's synthesis spills (size - hop)
#     samples past its stretched span — one-hop ``ppermute`` to the
#     RIGHT neighbor, added to its head;
#   * resample:         output blocks stay data-local per shard; the
#     normalized stretched track is the one replicated operand (the time
#     warp can map an output shard anywhere on the stretched timeline, so
#     XLA inserts a single all_gather at the shard_map boundary).
# ----------------------------------------------------------------------


def seq_parallel_pv(
    mesh: Mesh,
    *,
    size: int,
    hop: int,
    n_frames: int,  # padded to a multiple of mesh.shape["seq"]
    n_out_pad: int,  # padded to a multiple of seq * BLK
    sr: int,
    formant: bool = False,
    n_ceps: int = 40,
    lock: bool = False,
):
    """Jitted seq-sharded PV render of ONE track.

    Returns f(wav, starts, da, rho, f_real, window, anc_j, src_b, r_b,
    s_b, base) -> (n_out_pad,) audio.  ``starts/da/rho`` are the PVPlan
    frame arrays padded to ``n_frames``; ``f_real`` masks the live count.
    Use ``seq_pv_args`` to build the operands from a PVPlan.  ``lock``
    applies identity phase locking (a per-frame transform, shard-local).
    """
    from ..engine.phase_vocoder import (
        BLK,
        _formant_gain,
        _lerp_resample_rel_xla,
        _positions_rel_device,
        _princarg,
        identity_lock,
    )
    from ..engine.spectral import istft_device

    n_seq = mesh.shape["seq"]
    assert n_frames % n_seq == 0, (n_frames, n_seq)
    f_loc = n_frames // n_seq
    assert f_loc * hop >= size - hop, "shard span shorter than the OLA spill"
    n_bins = size // 2 + 1
    L = n_frames * hop  # fully-covered stretched span (tail pad excluded)

    def stretch_body(wav, starts_l, da_l, rho_l, f_real, window, wsum_l):
        idx = jax.lax.axis_index("seq")
        nsh = jax.lax.axis_size("seq")
        starts_l, da_l, rho_l = starts_l[0], da_l[0], rho_l[0]
        n = wav.shape[0]

        # Analysis (frame fetch from the replicated track + rFFT).
        gidx = starts_l[:, None] + jnp.arange(size, dtype=jnp.int32)[None, :]
        frames = jnp.where(gidx < n, wav[jnp.clip(gidx, 0, n - 1)], 0.0)
        spec = jnp.fft.rfft(frames * window[None, :])
        mag = jnp.abs(spec)
        phi = jnp.angle(spec)
        omega = (2.0 * jnp.pi / size) * jnp.arange(n_bins, dtype=jnp.float32)
        k_idx = jnp.arange(n_bins, dtype=jnp.int32)
        if formant:
            mag = mag * _formant_gain(mag, rho_l, size, n_bins, n_ceps)

        # Left neighbor's last analysis phase seeds my first frame's diff.
        perm_r = [(i, (i + 1) % nsh) for i in range(nsh)]
        phi_in = jax.lax.ppermute(phi[-1], "seq", perm_r)
        phi_prev = jnp.concatenate([phi_in[None, :], phi[:-1]], axis=0)

        da = jnp.maximum(da_l, 1e-3)[:, None]
        dphi = _princarg(phi - phi_prev - omega[None, :] * da)
        incr = hop * dphi / da
        m_global = idx * f_loc + jnp.arange(f_loc, dtype=jnp.int32)
        # Global frame 0 has no predecessor: psi_0 = phi_0 exactly.
        incr = jnp.where((m_global == 0)[:, None], 0.0, incr)

        # Distributed prefix sum: local cumsum + exclusive carry of the
        # preceding shards' totals.
        local_cum = jnp.cumsum(incr, axis=0)
        tots = jax.lax.all_gather(local_cum[-1], "seq")  # (nsh, bins)
        carry = jnp.sum(
            jnp.where((jnp.arange(nsh) < idx)[:, None], tots, 0.0), axis=0
        )
        resid = carry[None, :] + local_cum

        # psi = phi(global frame 0) + exact int-mod linear ramp + residual
        # (float32 ramp sums overflow ulp at minute scale — see
        # _stretch_chunk_core).
        phi0 = jax.lax.psum(
            jnp.where(idx == 0, phi[0], jnp.zeros_like(phi[0])), "seq"
        )
        hm = jnp.mod(m_global * hop, size)
        ramp = (2.0 * jnp.pi / size) * jnp.mod(
            hm[:, None] * k_idx[None, :], size
        ).astype(jnp.float32)
        psis = (phi0[None, :] + ramp + resid).astype(jnp.float32)

        if lock:
            # Per-frame transform: shard-local by construction.
            psis = identity_lock(psis, phi, mag)

        live = (m_global < f_real)[:, None]
        mag_live = jnp.where(live, mag, 0.0)
        out_local = f_loc * hop + (size - hop)
        synth = mag_live * jnp.exp(1j * psis)
        buf = istft_device(synth, window, size, hop, out_local,
                           normalize=False)

        # OLA seam: my tail overlaps the RIGHT neighbor's head.
        spill = buf[f_loc * hop :]
        recv = jax.lax.ppermute(spill, "seq", perm_r)
        recv = jnp.where(idx == 0, jnp.zeros_like(recv), recv)
        keep = buf[: f_loc * hop].at[: size - hop].add(recv)
        return (keep / wsum_l[0])[None, :]

    def resample_body(y, src_rel_l, base_l):
        return _lerp_resample_rel_xla(y, src_rel_l[0], base_l[0], L, BLK)[None, :]

    stretch = jax.shard_map(
        stretch_body,
        mesh=mesh,
        in_specs=(P(), P(None, "seq"), P(None, "seq"), P(None, "seq"),
                  P(), P(), P(None, "seq")),
        out_specs=P(None, "seq"),
    )
    resample = jax.shard_map(
        resample_body,
        mesh=mesh,
        # y replicated: the warp can send an output shard anywhere on the
        # stretched timeline; XLA all_gathers once at this boundary.
        in_specs=(P(), P(None, "seq"), P(None, "seq")),
        out_specs=P(None, "seq"),
    )

    def step(wav, starts, da, rho, f_real, window, anc_j, src_b, r_b, s_b, base):
        # f_real-masked normalizer: padded frames contribute no signal, so
        # they must contribute no window energy either (ADVICE r3 #1 —
        # the unmasked wsum attenuated the real OLA tail).
        wsum = _wsum_masked(window, f_real, size, hop, n_frames, L)
        y = stretch(
            wav, starts[None], da[None], rho[None], f_real, window, wsum[None]
        )[0]
        src_rel = _positions_rel_device(anc_j, src_b, r_b, s_b, n_out_pad, sr)
        return resample(y, src_rel[None], base[None])[0]

    return jax.jit(step)


def seq_pv_args(plan, n_seq: int):
    """Pad a PVPlan's operands to seq-shardable shapes.

    Returns (builder_kw, ops): frame arrays padded to a multiple of
    ``n_seq`` (edge frames, masked live by f_real) and the resample side
    padded to a multiple of ``n_seq * BLK`` output samples.
    """
    from ..engine.phase_vocoder import BLK

    # Pad past the shard multiple by a window's worth of frames so the
    # fully-covered span L = n_frames*hop reaches the real stretched tail
    # (plan.n_frames-1)*hop + size — without it the last size-hop samples
    # of the stretch were truncated whenever plan.n_frames already hit
    # the shard multiple (ADVICE r3 #1).  Padded frames are masked live.
    extra = -(-plan.size // plan.hop) - 1
    n_frames = n_seq * -(-(plan.n_frames + extra) // n_seq)
    pad_f = n_frames - plan.n_frames
    starts = np.pad(plan.starts_m, (0, pad_f), mode="edge")
    da = np.pad(plan.da_m, (0, pad_f), constant_values=float(plan.hop))
    rho = np.pad(plan.rho_m.astype(np.float32), (0, pad_f), mode="edge")

    quantum = n_seq * BLK
    n_out_pad = quantum * -(-plan.n_out_pad // quantum)
    nb = n_out_pad // BLK
    base = np.pad(np.asarray(plan.base), (0, nb - len(plan.base)), mode="edge")
    builder_kw = dict(
        size=plan.size, hop=plan.hop, n_frames=n_frames,
        n_out_pad=n_out_pad, sr=plan.sr,
    )
    anc_j, src_b, r_b, s_b = (np.asarray(a) for a in plan.anc_args)
    ops = (
        starts, da, rho, np.int32(plan.n_frames),
        anc_j, src_b, r_b, s_b, base,
    )
    return builder_kw, ops


# ----------------------------------------------------------------------
# Full session step: the "training step" equivalent for this framework —
# one device program that analyses (sharded STFT) and renders (data-parallel
# gather) a batch of sessions.
# ----------------------------------------------------------------------


def _halo_stft_mags(mesh, wav_b, window, size, hop):
    """(B, F, bins) magnitudes: tracks over ``data``, frames over ``seq``,
    window overlap via one-hop ppermute halo."""
    n_seq = mesh.shape["seq"]
    chunk = wav_b.shape[-1] // n_seq
    halo = size - hop

    def analysis(w_local):
        idx = jax.lax.axis_index("seq")
        n_shards = jax.lax.axis_size("seq")
        head = w_local[:, :halo]
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        recv = jax.lax.ppermute(head, "seq", perm)
        recv = jnp.where(idx == n_shards - 1, jnp.zeros_like(recv), recv)
        local = jnp.concatenate([w_local, recv], axis=-1)
        n_frames = chunk // hop
        frames = jax.vmap(
            lambda l: _extract_hop_frames(l, size, hop, n_frames)
        )(local) * window[None, None, :]
        spec = jnp.fft.rfft(frames)
        return jnp.sqrt(spec.real**2 + spec.imag**2)

    return jax.shard_map(
        analysis,
        mesh=mesh,
        in_specs=(P("data", "seq"),),
        out_specs=P("data", "seq", None),
    )(wav_b)


def session_step(
    mesh: Mesh,
    *,
    stft_size: int,
    stft_hop: int,
):
    """Build a jitted full-pipeline step over ``mesh``.

    Returns f(wav_b, window, plan...) -> (stft_mags, rendered) with
    shardings: tracks over ``data``, frames over ``seq``.
    """

    def step(wav_b, window, gs, gl, rate, oo, ss, nv, out_len):
        mags = _halo_stft_mags(mesh, wav_b, window, stft_size, stft_hop)
        rendered = data_parallel_render(wav_b, gs, gl, rate, oo, ss, nv, mesh, out_len)
        return mags, rendered

    return partial(jax.jit, static_argnames=("out_len",))(step)


def session_step_full(
    mesh: Mesh,
    *,
    stft_size: int,
    stft_hop: int,
    pv_size: int,
    pv_hop: int,
    pv_frames: int,
    pv_stretch_len: int,
    pv_out_pad: int,
    sr: int,
):
    """Both engines in one step: sharded-STFT analysis + data-parallel
    granular render + data-parallel phase-vocoder render (VERDICT #6's
    "session_step covering both engines").  Returns
    f(wav_b, window, granular plan..., out_len, pv_window, pv ops...) ->
    (stft_mags, granular, pv)."""
    pv = data_parallel_pv(
        mesh, size=pv_size, hop=pv_hop, n_frames=pv_frames,
        stretch_len=pv_stretch_len, n_out_pad=pv_out_pad, sr=sr,
    )

    def step(wav_b, window, gs, gl, rate, oo, ss, nv, out_len,
             pv_window, starts_b, da_b, rho_b, f_real_b,
             anc_j_b, src_b, r_b, s_b, base_b):
        mags = _halo_stft_mags(mesh, wav_b, window, stft_size, stft_hop)
        rendered = data_parallel_render(
            wav_b, gs, gl, rate, oo, ss, nv, mesh, out_len
        )
        pv_out = pv(
            wav_b, starts_b, da_b, rho_b, f_real_b, pv_window,
            anc_j_b, src_b, r_b, s_b, base_b,
        )
        return mags, rendered, pv_out

    return partial(jax.jit, static_argnames=("out_len",))(step)
