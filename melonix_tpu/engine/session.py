"""Multichannel session rendering (BASELINE config #5).

The reference is strictly mono: libswresample downmixes on import
(app.cpp:669-684) and every engine stage assumes one channel.  Sessions here
keep their channels: the *edit model* (grain boundaries, time-warp map) is
derived from the mono downmix so every channel splices at the same sample
positions — a coherent stereo image — while the *samples* rendered come from
each channel.

Routing: one plan always; with more than one device the channels render as
ONE batched device program sharded over the mesh's ``data`` axis
(``parallel.sharded.data_parallel_render`` for the granular engine,
``render_channels_pv`` for the phase vocoder) — the batched-session path of
BASELINE config #5.  On a single device the granular engine loops the
channels through the one shared plan and the phase vocoder batches them
in one vmapped program.

A MONO track with an EXPLICIT mesh routes through the sequence-parallel
renderers instead (``seq_parallel_render`` / ``seq_parallel_pv`` — the
long-track scaling story, SURVEY §5): opt-in rather than "auto" because
the distributed PV phase carry reorders float sums (rms-level PV
convention, not bit equality) and single-chip defaults must stay stable.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, Config
from ..io.audio import downmix_mono
from .grains import build_grain_table
from .maps import MapKnots
from .phase_vocoder import render_channels_pv, render_track_pv
from .render import build_render_plan, render


def _session_mesh(mesh):
    """Resolve the ``mesh`` argument: "auto" → a (data, seq) mesh over all
    devices when more than one is visible, else None (single-chip path)."""
    if mesh != "auto":
        return mesh
    import jax

    if len(jax.devices()) <= 1:
        return None
    from ..parallel import make_audio_mesh

    return make_audio_mesh()


def _render_channels_granular(wav_ch: np.ndarray, plan, mesh) -> np.ndarray:
    """(C, n) channels through one shared granular plan, tracks batched over
    the mesh ``data`` axis (zero-pad channels to the shard count)."""
    import jax.numpy as jnp

    from ..parallel import data_parallel_render

    C, _n = wav_ch.shape
    d = mesh.shape["data"]
    B = d * -(-C // d)
    wav_b = wav_ch if B == C else np.pad(wav_ch, ((0, B - C), (0, 0)))
    total = plan.total_out
    out_len = 1024 * -(-total // 1024)
    gs = np.tile(plan.grain_start, (B, 1))
    gl = np.tile(plan.grain_len, (B, 1))
    rt = np.tile(plan.rate, (B, 1))
    oo = np.tile(plan.out_offset.astype(np.int32), (B, 1))
    ss = np.tile(plan.seam_src, (B, 1))
    nv = np.full((B,), int(plan.out_offset[-1]), np.int32)
    out = data_parallel_render(
        jnp.asarray(wav_b),
        jnp.asarray(gs), jnp.asarray(gl), jnp.asarray(rt),
        jnp.asarray(oo), jnp.asarray(ss), jnp.asarray(nv),
        mesh, out_len,
    )
    return np.asarray(out)[:C, :total]


def _mono_seq_mesh(mesh):
    """An EXPLICIT mesh with a seq axis > 1 enables the sequence-parallel
    mono paths; "auto"/None keep the stable single-chip renderers."""
    if mesh is None or (isinstance(mesh, str) and mesh == "auto"):
        return None
    try:
        return mesh if mesh.shape.get("seq", 1) > 1 else None
    except AttributeError:
        return None


def _render_mono_granular_seq(mono, plan, mesh) -> np.ndarray:
    """ONE track's granular render, output axis sharded over ``seq``
    (parallel.sharded.seq_render; host plan supplies the per-shard
    bases)."""
    from ..parallel.sharded import seq_render

    out, n_grain_out = seq_render(mesh, plan, mono)
    res = np.zeros(plan.total_out, np.float32)
    res[:n_grain_out] = out[:n_grain_out]
    return res  # 1500-zero reference tail included via total_out


def _render_mono_pv_seq(mono, knots, mesh, config, preserve_formants,
                        phase_locking=False):
    """ONE track's PV render with stretch frames sharded over ``seq``.
    Returns None when the track is too short for the shard count (each
    shard must cover the OLA spill) so the caller falls back.
    """
    import jax.numpy as jnp

    from ..parallel.sharded import seq_parallel_pv, seq_pv_args
    from .phase_vocoder import build_pv_plan
    from .spectral import hann_window

    plan = build_pv_plan(knots, len(mono), config=config)
    if plan is None:
        return None  # empty/degenerate: the single-device path handles it
    n_seq = mesh.shape["seq"]
    kw, ops = seq_pv_args(plan, n_seq)
    if (kw["n_frames"] // n_seq) * plan.hop < plan.size - plan.hop:
        return None  # shard span shorter than the OLA spill: fall back
    f = seq_parallel_pv(mesh, **kw, formant=bool(preserve_formants),
                        lock=bool(phase_locking))
    win = jnp.asarray(hann_window(kw["size"]))
    out = f(
        jnp.asarray(mono), *[jnp.asarray(o) for o in ops[:4]],
        win, *[jnp.asarray(o) for o in ops[4:]],
    )
    return np.asarray(out)[: plan.n_out]


def render_session(
    wav,
    markers,
    sample_rate: int,
    *,
    engine: str = "granular",
    preserve_formants: bool = False,
    phase_locking: bool = False,
    config: Config = DEFAULT_CONFIG,
    mesh="auto",
) -> np.ndarray:
    """Render a (possibly multichannel) session through the marker edit.

    ``wav``: float32 (n,) mono or (n, C) multichannel.
    ``mesh``: "auto" (batch channels over all devices when >1), an explicit
    ``jax.sharding.Mesh``, or None (force the single-chip per-channel path).
    Returns the rendered audio with the same channel layout.
    """
    wav = np.asarray(wav, np.float32)
    multi = wav.ndim == 2
    mono = downmix_mono(wav) if multi else wav
    knots = MapKnots.from_markers(markers, sample_rate, len(mono))
    use_mesh = _session_mesh(mesh) if multi else None
    seq_mesh = _mono_seq_mesh(mesh) if not multi else None

    if engine == "pv":
        if not multi:
            if seq_mesh is not None:
                out = _render_mono_pv_seq(
                    mono, knots, seq_mesh, config, preserve_formants,
                    phase_locking=phase_locking,
                )
                if out is not None:
                    return out
            return render_track_pv(
                mono, knots, config=config,
                preserve_formants=preserve_formants,
                phase_locking=phase_locking,
            )
        out = render_channels_pv(
            wav.T, knots, config=config,
            preserve_formants=preserve_formants,
            phase_locking=phase_locking, mesh=use_mesh,
        )
        return np.ascontiguousarray(out.T)

    table = build_grain_table(mono, config)
    plan = build_render_plan(table, knots, config=config)
    if not multi:
        if seq_mesh is not None:
            return _render_mono_granular_seq(mono, plan, seq_mesh)
        return render(mono, plan)
    if use_mesh is not None:
        return np.ascontiguousarray(
            _render_channels_granular(np.ascontiguousarray(wav.T), plan, use_mesh).T
        )
    chans = [render(wav[:, c], plan) for c in range(wav.shape[1])]
    return np.stack(chans, axis=1)
