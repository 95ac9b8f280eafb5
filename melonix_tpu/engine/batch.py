"""Batch rendering of many tracks — the production "serving" path.

The reference processes one file per app session (main.cpp:109-110); a
serving deployment renders fleets of files.  ``render_batch`` takes a list
of (track, markers) jobs at one sample rate and renders them through the
edit model:

* with more than one visible device (or an explicit mesh), whole tracks
  batch over the mesh's ``data`` axis as ONE device program per engine —
  ``parallel.sharded.data_parallel_render`` / ``data_parallel_pv`` with
  per-track edits bucketed to shared static shapes (the BASELINE config #5
  machinery applied across files instead of channels);
* on a single device it loops the per-track path (``render_session``).

Jobs pad to the longest track in the batch; callers with wildly mixed
lengths should bucket first (the CLI ``batch`` command groups by sample
rate and renders each group in mesh-width slices).
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, Config
from .grains import build_grain_table
from .maps import MapKnots
from .render import build_render_plan
from .session import render_session


def _batch_mesh(mesh):
    from .session import _session_mesh  # one auto-mesh policy for the product

    return _session_mesh(mesh)


def render_batch(
    tracks: list[np.ndarray],
    markers_list: list[list],
    sample_rate: int,
    *,
    engine: str = "granular",
    preserve_formants: bool = False,
    phase_locking: bool = False,
    config: Config = DEFAULT_CONFIG,
    mesh="auto",
) -> list[np.ndarray]:
    """Render ``tracks[i]`` through ``markers_list[i]``; returns one mono
    float32 array per job, identical to ``render_session`` job-by-job."""
    assert len(tracks) == len(markers_list)
    if not tracks:
        return []
    use_mesh = _batch_mesh(mesh)
    if use_mesh is None or len(tracks) == 1:
        return [
            render_session(
                t, ms, sample_rate, engine=engine,
                preserve_formants=preserve_formants,
                phase_locking=phase_locking, config=config, mesh=None,
            )
            for t, ms in zip(tracks, markers_list)
        ]

    import jax.numpy as jnp

    d = use_mesh.shape["data"]
    tracks = [np.asarray(t, np.float32) for t in tracks]
    n_shared = max(len(t) for t in tracks)
    jobs = list(zip(tracks, markers_list))
    pad_jobs = (-len(jobs)) % d
    jobs += [jobs[-1]] * pad_jobs  # repeat the last job to fill the mesh

    wav_b = np.zeros((len(jobs), n_shared), np.float32)
    knots_l = []
    for b, (t, ms) in enumerate(jobs):
        wav_b[b, : len(t)] = t
        knots_l.append(MapKnots.from_markers(ms, sample_rate, len(t)))

    if engine == "pv":
        from ..parallel.sharded import data_parallel_pv, pv_batch_args
        from .phase_vocoder import PV_CHUNK_FRAMES, build_pv_plan
        from .spectral import hann_window

        plans = [
            build_pv_plan(k, len(t), config=config)
            for (t, _), k in zip(jobs, knots_l)
        ]
        per_dev = len(jobs) // d
        if (
            any(p is None for p in plans)
            or max(p.n_frames for p in plans) > PV_CHUNK_FRAMES
            # Per-device output budget: pipeline intermediates scale with
            # rows-per-device x padded output length.
            or per_dev * max(p.n_out_pad for p in plans) > (1 << 26)
        ):
            # Degenerate or hour-scale jobs: the single-chunk batched
            # formulation doesn't apply — loop the chunked fast path.
            return [
                render_session(
                    t, ms, sample_rate, engine="pv",
                    preserve_formants=preserve_formants,
                    phase_locking=phase_locking, config=config,
                    mesh=None,
                )
                for t, ms in zip(tracks, markers_list)
            ]
        kw, ops = pv_batch_args(plans)
        f = data_parallel_pv(use_mesh, **kw, formant=bool(preserve_formants),
                             lock=bool(phase_locking))
        win = jnp.asarray(hann_window(kw["size"]))
        out_b = f(jnp.asarray(wav_b), *[jnp.asarray(o) for o in ops[:4]], win,
                  *[jnp.asarray(o) for o in ops[4:]])
        # Download each track sliced to its live length: pad rows and zero
        # tails never cross the device->host link.
        return [np.asarray(out_b[b, : plans[b].n_out])
                for b in range(len(tracks))]

    from ..parallel.sharded import data_parallel_render, granular_batch_args

    plans = []
    for (t, _), k in zip(jobs, knots_l):
        table = build_grain_table(t, config)
        plans.append(build_render_plan(table, k, config=config))
    gs, gl, rt, oo, ss, nv, out_max = granular_batch_args(plans)
    # Per-device output budget: rows-per-device x padded output length
    # (the segmented-broadcast render materializes several out_len-sized
    # intermediates per row).
    if (len(jobs) // d) * out_max > 1 << 26:
        return [
            render_session(
                t, ms, sample_rate, engine="granular", config=config,
                mesh=None,
            )
            for t, ms in zip(tracks, markers_list)
        ]
    out_len = 1024 * -(-out_max // 1024)
    out_b = data_parallel_render(
        jnp.asarray(wav_b),
        jnp.asarray(gs), jnp.asarray(gl), jnp.asarray(rt),
        jnp.asarray(oo), jnp.asarray(ss), jnp.asarray(nv),
        use_mesh, out_len,
    )
    outs = []
    for b in range(len(tracks)):
        total = plans[b].total_out  # includes the 1500-zero reference tail
        res = np.zeros(total, np.float32)
        n_valid = int(plans[b].out_offset[-1])
        # Sliced download: pad rows/zero tails stay on device.
        res[:n_valid] = np.asarray(out_b[b, :n_valid])
        outs.append(res)
    return outs
