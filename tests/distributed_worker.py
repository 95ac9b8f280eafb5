"""Multi-process DCN worker (SURVEY §5 multi-host story; VERDICT r3 next
#8, rank-count parameterization r5 #8).

Launched by ``test_distributed.py`` as N OS processes that form one JAX
distributed job over gloo CPU collectives (the CPU stand-in for a DCN
slice-of-slices: every cross-process ``ppermute``/``all_gather``/``psum``
in the seq-sharded PV rides the inter-process fabric instead of in-process
device links).

Each process owns ``8 // N`` virtual devices; the global mesh has 8.  Two
programs run:

* ``seq_parallel_pv`` on a ``(data=1, seq=8)`` mesh — the seq axis SPANS
  every process boundary, so the distributed phase prefix sum and the OLA
  seam spill genuinely cross processes;
* ``data_parallel_pv`` (the batch serving step, engine/batch.py) on a
  ``(data=N, seq=8/N)`` mesh with an N-track batch — one batch row per
  process, so the batch bucketing itself is sharded across ranks.

Both are asserted equal to the single-device render under the PV
comparison convention (rms-relative; phase propagation is chaotic at the
ulp level — CLAUDE.md).  Prints ``DIST_OK`` on success; the parent test
requires it from every rank.
"""

import os
import sys


def main() -> None:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    nprocs = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    ndev = 8 // nprocs
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={ndev}"
    ).strip()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax

    # Pin the CPU platform through jax.config, whatever the environment
    # names (conftest.py does the same).
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    import jax.numpy as jnp
    import numpy as np

    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nprocs,
        process_id=pid,
    )
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == ndev, len(jax.local_devices())

    from melonix_tpu.engine import spectral as S
    from melonix_tpu.engine.maps import MapKnots
    from melonix_tpu.engine.phase_vocoder import build_pv_plan, render_track_pv
    from melonix_tpu.markers import Marker
    from melonix_tpu.parallel import (
        data_parallel_pv,
        make_audio_mesh,
        pv_batch_args,
        seq_parallel_pv,
        seq_pv_args,
    )

    # Deterministic fixtures — identical on all ranks (a DCN job's inputs
    # come from shared storage; here every rank synthesizes the same
    # bytes).  One track per rank so the batch step puts a row on every
    # process.
    sr = 8000
    t = np.arange(int(sr * 1.5)) / sr
    freq = 180.0 + 120.0 * t
    base = (0.6 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    tracks, knots_l, plans = [], [], []
    for b in range(nprocs):
        x = base[::-1].copy() if b % 2 else base.copy()
        x = (x * (1.0 - 0.1 * b)).astype(np.float32)
        ms = [Marker(len(x) // (2 + b), 57.0, 0.05 if b % 2 == 0 else 0.0,
                     float((-1) ** b) * (2.0 + b))]
        k = MapKnots.from_markers(ms, sr, len(x))
        tracks.append(x)
        knots_l.append(k)
        plans.append(build_pv_plan(k, len(x)))

    # Single-process references run on this rank's local device 0.
    wants = [render_track_pv(x, k) for x, k in zip(tracks, knots_l)]
    n_outs = [p.n_out for p in plans]

    def shard_rms_check(out, ref_rows, n_outs, tag):
        """Each rank verifies ONLY its addressable shards (the other
        ranks' rows are not downloadable across processes)."""
        checked = 0
        for sh in out.addressable_shards:
            seg = np.asarray(sh.data)
            idx = sh.index if isinstance(sh.index, tuple) else (sh.index,)
            if seg.ndim == 1:
                seg = seg[None, :]
                idx = (slice(0, 1),) + tuple(idx)
            r0 = idx[0].start or 0
            c0 = idx[1].start or 0 if len(idx) > 1 else 0
            for r in range(seg.shape[0]):
                row = r0 + r
                ref = ref_rows[row % len(ref_rows)]
                n_out = n_outs[row % len(n_outs)]
                lo, hi = c0, min(c0 + seg.shape[1], n_out)
                if hi <= lo:
                    continue
                err = np.sqrt(np.mean((seg[r, : hi - lo] - ref[lo:hi]) ** 2))
                rel = err / (np.sqrt(np.mean(ref[:n_out] ** 2)) + 1e-12)
                assert rel < 2e-3, (tag, row, lo, rel)
                checked += 1
        assert checked > 0, (tag, "rank verified nothing")
        print(pid, tag, "checked", checked, "shard spans", flush=True)

    # --- 1. seq-sharded PV: the seq axis crosses every process boundary ---
    p1, k1, x1 = plans[0], knots_l[0], tracks[0]
    mesh_seq = make_audio_mesh(8, data=1)
    kw, ops = seq_pv_args(p1, mesh_seq.shape["seq"])
    fn = seq_parallel_pv(mesh_seq, **kw)
    win = jnp.asarray(S.hann_window(kw["size"]))
    out = fn(
        jnp.asarray(x1), jnp.asarray(ops[0]), jnp.asarray(ops[1]),
        jnp.asarray(ops[2]), jnp.asarray(ops[3]), win,
        *[jnp.asarray(o) for o in ops[4:]],
    )
    shard_rms_check(out, [wants[0]], [n_outs[0]], "seq_pv")

    # --- 2. batch step: one batch row per rank (data axis = rank count) ---
    mesh_b = make_audio_mesh(8, data=nprocs)
    kwb, opsb = pv_batch_args(plans)
    pv = data_parallel_pv(mesh_b, **kwb)
    winb = jnp.asarray(S.hann_window(kwb["size"]))
    wav_b = jnp.asarray(np.stack(tracks))
    out_b = pv(wav_b, *[jnp.asarray(o) for o in opsb[:4]], winb,
               *[jnp.asarray(o) for o in opsb[4:]])
    shard_rms_check(out_b, wants, n_outs, "batch_pv")

    print(pid, "DIST_OK", flush=True)


if __name__ == "__main__":
    main()
