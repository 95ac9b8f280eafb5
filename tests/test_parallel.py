"""Multi-chip sharding on the 8-virtual-device CPU mesh (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from melonix_tpu.engine import spectral as S
from melonix_tpu.engine.grains import build_grain_table
from melonix_tpu.engine.maps import MapKnots
from melonix_tpu.engine.render import build_render_plan, render
from melonix_tpu.markers import Marker
from melonix_tpu.parallel import (
    data_parallel_render,
    make_audio_mesh,
    sharded_spectrogram_columns,
    sharded_stft_mags,
    session_step,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_audio_mesh(8)


def test_mesh_shape(mesh):
    assert mesh.shape["data"] * mesh.shape["seq"] == 8


def test_sharded_stft_matches_single_device(chirp, mesh):
    x, _sr = chirp
    size, hop = 256, 64
    n_seq = mesh.shape["seq"]
    n = len(x) // (n_seq * hop) * (n_seq * hop)
    x = x[:n]
    win = jnp.asarray(S.hann_window(size))

    got = np.asarray(sharded_stft_mags(jnp.asarray(x), win, mesh, size=size, hop=hop))
    # Single-device reference: same frame convention, zero-padded tail
    nf = n // hop
    ref_spec = S.stft_device(jnp.asarray(x), win, size, hop, nf)
    want = np.abs(np.asarray(ref_spec))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_sharded_spectrogram_columns(chirp, mesh):
    x, _sr = chirp
    size = 1024
    n_seq = mesh.shape["seq"]
    starts = np.arange(0, 8 * n_seq, dtype=np.int32) * 100
    ends = starts + 900
    got = np.asarray(
        sharded_spectrogram_columns(
            jnp.asarray(x), jnp.asarray(starts), jnp.asarray(ends), mesh, size=size
        )
    )
    want = S.spectrogram_columns(x, starts, ends, S.DEFAULT_CONFIG.__class__(spectr_size=size))
    np.testing.assert_allclose(got, want, atol=1e-5)


def _padded_plans(x, sr, marker_sets):
    plans = []
    table = build_grain_table(x, backend="numpy")
    for ms in marker_sets:
        knots = MapKnots.from_markers(ms, sr, len(x))
        plans.append(build_render_plan(table, knots))
    S_max = max(p.n_steps for p in plans)
    out_max = max(int(p.out_offset[-1]) for p in plans)
    B = len(plans)
    gs = np.zeros((B, S_max), np.int32)
    gl = np.ones((B, S_max), np.int32)
    rt = np.ones((B, S_max), np.float32)
    oo = np.full((B, S_max + 1), 2**30, np.int32)
    ss = np.full((B, S_max), -1, np.int32)
    nv = np.zeros((B,), np.int32)
    for b, p in enumerate(plans):
        s = p.n_steps
        gs[b, :s] = p.grain_start
        gl[b, :s] = p.grain_len
        rt[b, :s] = p.rate
        oo[b, : s + 1] = p.out_offset
        oo[b, s + 1 :] = p.out_offset[-1] + 1 + np.arange(S_max - s)
        ss[b, :s] = p.seam_src
        nv[b] = p.out_offset[-1]
    return plans, gs, gl, rt, oo, ss, nv, out_max


def test_data_parallel_render_matches_serial(chirp, mesh):
    x, sr = chirp
    d = mesh.shape["data"]
    marker_sets = [
        [],
        [Marker(4000, 60.0, 0.0, 2.0)],
        [Marker(2000, 60.0, 0.1, -1.0)],
        [Marker(6000, 60.0, -0.05, 5.0)],
    ][: max(d, 2)]
    while len(marker_sets) % d:
        marker_sets.append([])
    plans, gs, gl, rt, oo, ss, nv, out_max = _padded_plans(x, sr, marker_sets)
    out_len = 1024 * -(-out_max // 1024)
    B = len(plans)
    wav_b = jnp.asarray(np.tile(x, (B, 1)))
    got = np.asarray(
        data_parallel_render(
            wav_b,
            jnp.asarray(gs), jnp.asarray(gl), jnp.asarray(rt),
            jnp.asarray(oo), jnp.asarray(ss), jnp.asarray(nv),
            mesh, out_len,
        )
    )
    for b, p in enumerate(plans):
        want = render(x, p, include_tail=False)
        n = int(p.out_offset[-1])
        np.testing.assert_allclose(got[b, :n], want, atol=2e-6, err_msg=f"track {b}")
        assert np.all(got[b, n:] == 0)


def test_session_step_end_to_end(chirp, mesh):
    """The full multi-chip pipeline step compiles and runs (dryrun shape)."""
    x, sr = chirp
    size, hop = 256, 64
    d = mesh.shape["data"]
    n_seq = mesh.shape["seq"]
    n = len(x) // (n_seq * hop) * (n_seq * hop)
    x = x[:n]
    marker_sets = [[] for _ in range(d)]
    plans, gs, gl, rt, oo, ss, nv, out_max = _padded_plans(x, sr, marker_sets)
    out_len = 1024 * -(-out_max // 1024)
    B = len(plans)
    wav_b = jnp.asarray(np.tile(x, (B, 1)))
    win = jnp.asarray(S.hann_window(size))
    step = session_step(mesh, stft_size=size, stft_hop=hop)
    mags, rendered = step(
        wav_b, win,
        jnp.asarray(gs), jnp.asarray(gl), jnp.asarray(rt),
        jnp.asarray(oo), jnp.asarray(ss), jnp.asarray(nv),
        out_len,
    )
    assert mags.shape == (B, n // hop, size // 2 + 1)
    assert rendered.shape == (B, out_len)
    assert np.isfinite(np.asarray(mags)).all()


def _pv_setup(chirp):
    from melonix_tpu.engine.phase_vocoder import build_pv_plan

    x, sr = chirp
    w1 = x
    w2 = x[::-1].copy()
    ms1 = [Marker(len(x) // 2, 57.0, 0.05, 2.0)]
    ms2 = [Marker(len(x) // 3, 57.0, 0.0, -3.0), Marker(2 * len(x) // 3, 57.0, 0.02, 1.0)]
    k1 = MapKnots.from_markers(ms1, sr, len(w1))
    k2 = MapKnots.from_markers(ms2, sr, len(w2))
    p1 = build_pv_plan(k1, len(w1))
    p2 = build_pv_plan(k2, len(w2))
    return (w1, k1, p1), (w2, k2, p2)


def test_data_parallel_pv_matches_single(chirp, mesh):
    """PV render of a track batch (per-track edits) sharded over ``data``.

    The cross-track shard_map path re-fuses the whole pipeline into one
    program; XLA's different fusion gives ~1-ulp FFT rounding diffs that the
    OLA edge normalization amplifies, so the bar here is the framework's
    spectral-parity bar (SURVEY §7 hard part #5: −60 dB), not bit equality —
    the product channels path (render_channels_pv) IS bit-exact and is
    asserted so in test_session.py."""
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.parallel import data_parallel_pv, pv_batch_args

    (w1, k1, p1), (w2, k2, p2) = _pv_setup(chirp)
    d = mesh.shape["data"]
    tracks = [(w1, k1, p1), (w2, k2, p2)]
    while len(tracks) % d:
        tracks.append(tracks[0])
    kw, ops = pv_batch_args([p for _, _, p in tracks])
    pv = data_parallel_pv(mesh, **kw)
    win = jnp.asarray(S.hann_window(kw["size"]))
    wav_b = jnp.asarray(np.stack([w for w, _, _ in tracks]))
    out = np.asarray(
        pv(wav_b, *[jnp.asarray(o) for o in ops[:4]], win,
           *[jnp.asarray(o) for o in ops[4:]])
    )
    for i, (w, k, p) in enumerate(tracks):
        want = render_track_pv(w, k)
        got = out[i, : p.n_out]
        err = got - want
        assert np.abs(err).max() < 2e-4, (i, np.abs(err).max())
        snr_db = 10 * np.log10(
            (np.mean(err**2) + 1e-30) / (np.mean(want**2) + 1e-30)
        )
        assert snr_db < -60.0, (i, snr_db)


def test_seq_parallel_pv_matches_single(chirp, mesh):
    """ONE track's PV render with stretch frames sharded over ``seq``
    (SURVEY §5 frame-axis mandate; VERDICT round 2, next #4).

    The distributed phase prefix sum (local cumsum + cross-shard carry)
    reorders float32 additions, and PV phase propagation is chaotic at the
    ulp level — so the bar is the PV comparison convention (rms-relative +
    spectral envelope), not bit equality."""
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.parallel import seq_parallel_pv, seq_pv_args

    for (w, k, p) in _pv_setup(chirp):
        want = render_track_pv(w, k)
        kw, ops = seq_pv_args(p, mesh.shape["seq"])
        f = seq_parallel_pv(mesh, **kw)
        win = jnp.asarray(S.hann_window(kw["size"]))
        out = f(
            jnp.asarray(w), jnp.asarray(ops[0]), jnp.asarray(ops[1]),
            jnp.asarray(ops[2]), jnp.asarray(ops[3]), win,
            *[jnp.asarray(o) for o in ops[4:]],
        )
        got = np.asarray(out)[: p.n_out]
        assert len(got) == len(want)
        err = np.sqrt(np.mean((got - want) ** 2)) / (
            np.sqrt(np.mean(want**2)) + 1e-12
        )
        assert err < 2e-3, err
        # Spectral envelope agreement per quarter-second window.
        sr = p.sr
        win_n = sr // 4
        for w0 in range(0, len(want) - win_n, win_n):
            a = np.abs(np.fft.rfft(want[w0 : w0 + win_n] * np.hanning(win_n)))
            b = np.abs(np.fft.rfft(got[w0 : w0 + win_n] * np.hanning(win_n)))
            denom = np.sqrt(np.sum(a**2)) + 1e-12
            assert np.sqrt(np.sum((a - b) ** 2)) / denom < 0.02, w0


def test_seq_parallel_pv_formant(chirp, mesh):
    """Formant preservation composes with the seq sharding (the cepstral
    warp is frame-local — no extra collectives)."""
    from melonix_tpu.engine.phase_vocoder import build_pv_plan, render_track_pv
    from melonix_tpu.parallel import seq_parallel_pv, seq_pv_args

    x, sr = chirp
    knots = MapKnots.from_markers(
        [Marker(len(x) // 2, 57.0, 0.0, 5.0)], sr, len(x)
    )
    plan = build_pv_plan(knots, len(x))
    want = render_track_pv(x, knots, preserve_formants=True)
    kw, ops = seq_pv_args(plan, mesh.shape["seq"])
    f = seq_parallel_pv(mesh, formant=True, **kw)
    win = jnp.asarray(S.hann_window(kw["size"]))
    got = np.asarray(
        f(jnp.asarray(x), *[jnp.asarray(o) for o in ops[:4]], win,
          *[jnp.asarray(o) for o in ops[4:]])
    )[: plan.n_out]
    err = np.sqrt(np.mean((got - want) ** 2)) / (
        np.sqrt(np.mean(want**2)) + 1e-12
    )
    assert err < 2e-3, err


def test_session_step_full_both_engines(chirp, mesh):
    """One jitted step covering analysis + granular + PV (VERDICT #6)."""
    from melonix_tpu.engine.phase_vocoder import build_pv_plan, render_track_pv
    from melonix_tpu.parallel import pv_batch_args, session_step_full

    x, sr = chirp
    size, hop = 256, 64
    n_seq = mesh.shape["seq"]
    d = mesh.shape["data"]
    n = len(x) // (n_seq * hop) * (n_seq * hop)
    x = x[:n]
    marker_sets = [[Marker(n // 2, 60.0, 0.0, float(1 + b))] for b in range(d)]
    plans, gs, gl, rt, oo, ss, nv, out_max = _padded_plans(x, sr, marker_sets)
    out_len = 1024 * -(-out_max // 1024)
    B = len(plans)
    wav_b = jnp.asarray(np.tile(x, (B, 1)))
    win = jnp.asarray(S.hann_window(size))

    pv_plans = [
        build_pv_plan(MapKnots.from_markers(ms, sr, n), n)
        for ms in marker_sets
    ]
    pv_kw, pv_ops = pv_batch_args(pv_plans)
    pv_win = jnp.asarray(S.hann_window(pv_kw["size"]))
    step = session_step_full(
        mesh, stft_size=size, stft_hop=hop,
        pv_size=pv_kw["size"], pv_hop=pv_kw["hop"],
        pv_frames=pv_kw["n_frames"], pv_stretch_len=pv_kw["stretch_len"],
        pv_out_pad=pv_kw["n_out_pad"], sr=pv_kw["sr"],
    )
    mags, rendered, pv_out = step(
        wav_b, win,
        jnp.asarray(gs), jnp.asarray(gl), jnp.asarray(rt),
        jnp.asarray(oo), jnp.asarray(ss), jnp.asarray(nv),
        out_len,
        pv_win, *[jnp.asarray(o) for o in pv_ops],
    )
    assert mags.shape == (B, n // hop, size // 2 + 1)
    assert rendered.shape == (B, out_len)
    assert pv_out.shape == (B, pv_kw["n_out_pad"])
    pv_np = np.asarray(pv_out)
    for b, (ms, p) in enumerate(zip(marker_sets, pv_plans)):
        want = render_track_pv(x, MapKnots.from_markers(ms, sr, n))
        err = pv_np[b, : p.n_out] - want
        snr_db = 10 * np.log10(
            (np.mean(err**2) + 1e-30) / (np.mean(want**2) + 1e-30)
        )
        assert snr_db < -60.0, (b, snr_db)


def test_sharded_pitch_matches_single_device(chirp, mesh):
    from melonix_tpu.engine.pitch import _pitch_device
    from melonix_tpu.parallel import sharded_pitch

    x, sr = chirp
    frame, hop = 1024, 256
    n_seq = mesh.shape["seq"]
    quant = n_seq * hop
    n = quant * (len(x) // quant)
    x = x[:n]
    lag_min = max(2, int(sr / 1760.0))
    lag_max = min(frame - 2, int(sr / 55.0))

    lag_s, cl_s, en_s = sharded_pitch(
        jnp.asarray(x), mesh, frame=frame, hop=hop, lag_min=lag_min, lag_max=lag_max
    )
    nf = 1 + (n - frame) // hop
    lag_1, cl_1, en_1 = _pitch_device(jnp.asarray(x), frame, hop, nf, lag_min, lag_max)
    k = min(len(np.asarray(lag_s)), nf)
    np.testing.assert_allclose(np.asarray(lag_s)[:k], np.asarray(lag_1)[:k], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(cl_s)[:k], np.asarray(cl_1)[:k], rtol=1e-4)
    np.testing.assert_allclose(np.asarray(en_s)[:k], np.asarray(en_1)[:k], rtol=1e-5)


def test_seq_parallel_render_matches_single(chirp, mesh):
    """ONE track's granular render with the OUTPUT axis sharded over
    ``seq``.  The per-step segmented broadcasts are int32 prefix sums
    (bit-exact under sharding); the float lerp may differ by ~1 ulp from
    the single-device program (per-compilation XLA fusion), so the bar is
    the granular render tolerance."""
    from melonix_tpu.engine.render import render_device, render_device_args
    from melonix_tpu.parallel import seq_parallel_render, seq_render_args

    x, sr = chirp
    table = build_grain_table(x)
    n_seq = mesh.shape["seq"]
    for markers in (
        [],
        [Marker(4000, 60.0, 0.05, 2.0)],
        [Marker(2000, 60.0, 0.1, -1.0), Marker(6000, 60.0, -0.02, 5.0)],
    ):
        knots = MapKnots.from_markers(markers, sr, len(x))
        plan = build_render_plan(table, knots)
        blk = n_seq * 1024
        out_len = blk * -(-int(plan.out_offset[-1]) // blk)
        offsets, gstart, rbits, n_valid, _, fix_idx, fix_val = (
            render_device_args(plan, x, out_len)
        )
        want = np.asarray(
            render_device(
                jnp.asarray(x), jnp.asarray(offsets), jnp.asarray(gstart),
                jnp.asarray(rbits), n_valid, out_len,
                jnp.asarray(fix_idx), jnp.asarray(fix_val),
            )
        )
        sargs = seq_render_args(plan, x, out_len, n_seq)
        got = np.asarray(
            seq_parallel_render(
                mesh, jnp.asarray(x),
                *[jnp.asarray(a) for a in sargs[:6]],
                sargs[6], out_len,
                jnp.asarray(sargs[7]), jnp.asarray(sargs[8]),
            )
        )
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=str(markers))
        # The integer plan state must shard exactly: zero tails identical.
        assert np.array_equal(got == 0.0, want == 0.0)


def test_alternate_mesh_shape_4x2(chirp):
    """The sharded paths hold on other mesh layouts, not just the default
    (2,4): halo STFT and the seq-PV render on a (data=4, seq=2) mesh."""
    from melonix_tpu.engine.phase_vocoder import build_pv_plan, render_track_pv
    from melonix_tpu.parallel import make_audio_mesh, seq_parallel_pv, seq_pv_args, sharded_stft_mags

    mesh = make_audio_mesh(8, data=4)
    assert mesh.shape["data"] == 4 and mesh.shape["seq"] == 2
    x, sr = chirp
    size, hop = 256, 64
    n = len(x) // (2 * hop) * (2 * hop)
    xs = x[:n]
    win = jnp.asarray(S.hann_window(size))
    got = np.asarray(sharded_stft_mags(jnp.asarray(xs), win, mesh, size=size, hop=hop))
    want = np.abs(np.asarray(S.stft_device(jnp.asarray(xs), win, size, hop, n // hop)))
    np.testing.assert_allclose(got, want, atol=1e-4)

    knots = MapKnots.from_markers([Marker(len(x) // 2, 57.0, 0.02, 2.0)], sr, len(x))
    plan = build_pv_plan(knots, len(x))
    want_pv = render_track_pv(x, knots)
    kw, ops = seq_pv_args(plan, 2)
    f = seq_parallel_pv(mesh, **kw)
    win_pv = jnp.asarray(S.hann_window(kw["size"]))
    got_pv = np.asarray(
        f(jnp.asarray(x), *[jnp.asarray(o) for o in ops[:4]], win_pv,
          *[jnp.asarray(o) for o in ops[4:]])
    )[: plan.n_out]
    err = np.sqrt(np.mean((got_pv - want_pv) ** 2)) / (
        np.sqrt(np.mean(want_pv**2)) + 1e-12
    )
    assert err < 2e-3, err


def test_render_batch_matches_per_track(chirp):
    """The serving path: a fleet of different-length tracks with per-track
    edits renders as ONE mesh program per engine and matches the
    single-chip per-track renders (granular at render tolerance with the
    padded region never leaking in; PV at the spectral-parity bar)."""
    from melonix_tpu.engine.batch import render_batch
    from melonix_tpu.engine.session import render_session

    x, sr = chirp
    tracks = [x, x[: len(x) * 2 // 3].copy(), x[::-1].copy()]
    markers_l = [
        [Marker(4000, 60.0, 0.02, 2.0)],
        [],
        [Marker(2000, 60.0, 0.0, -3.0), Marker(6000, 60.0, 0.05, 1.0)],
    ]
    for engine in ("granular", "pv"):
        got = render_batch(tracks, markers_l, sr, engine=engine)  # mesh auto
        assert len(got) == 3
        for i, (t, ms) in enumerate(zip(tracks, markers_l)):
            want = render_session(t, ms, sr, engine=engine, mesh=None)
            assert got[i].shape == want.shape, (engine, i)
            if engine == "granular":
                np.testing.assert_allclose(got[i], want, atol=2e-6,
                                           err_msg=f"track {i}")
                assert np.array_equal(got[i] == 0.0, want == 0.0)
            else:
                err = got[i] - want
                snr_db = 10 * np.log10(
                    (np.mean(err**2) + 1e-30) / (np.mean(want**2) + 1e-30)
                )
                assert snr_db < -60.0, (i, snr_db)


def test_render_batch_formant_batched(chirp):
    """Formant-preserving PV jobs batch too (data_parallel_pv grew the
    cepstral-warp path): matches the per-track formant render at the
    spectral-parity bar."""
    from melonix_tpu.engine.batch import render_batch
    from melonix_tpu.engine.session import render_session

    x, sr = chirp
    tracks = [x, x[::-1].copy()]
    markers_l = [
        [Marker(len(x) // 2, 57.0, 0.0, 5.0)],
        [Marker(len(x) // 3, 57.0, 0.0, -4.0)],
    ]
    got = render_batch(tracks, markers_l, sr, engine="pv",
                       preserve_formants=True)
    for i, (t, ms) in enumerate(zip(tracks, markers_l)):
        want = render_session(t, ms, sr, engine="pv",
                              preserve_formants=True, mesh=None)
        assert got[i].shape == want.shape
        err = got[i] - want
        snr_db = 10 * np.log10(
            (np.mean(err**2) + 1e-30) / (np.mean(want**2) + 1e-30)
        )
        assert snr_db < -60.0, (i, snr_db)


def _rel_rms(got, want):
    return np.sqrt(np.mean((got - want) ** 2)) / (
        np.sqrt(np.mean(want**2)) + 1e-12
    )


def test_seq_parallel_pv_formant_matches_single(chirp, mesh):
    """Formant-preserving PV with stretch frames sharded over ``seq``: the
    cepstral warp is per frame, so it runs shard-local — vs the
    single-device formant render of both test tracks."""
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.parallel import seq_parallel_pv, seq_pv_args

    for (w, k, p) in _pv_setup(chirp):
        want = render_track_pv(w, k, preserve_formants=True)
        kw, ops = seq_pv_args(p, mesh.shape["seq"])
        f = seq_parallel_pv(mesh, **kw, formant=True)
        win = jnp.asarray(S.hann_window(kw["size"]))
        out = f(
            jnp.asarray(w), *[jnp.asarray(o) for o in ops[:4]],
            win, *[jnp.asarray(o) for o in ops[4:]],
        )
        got = np.asarray(out)[: p.n_out]
        assert _rel_rms(got, want) < 2e-3, _rel_rms(got, want)


def test_seq_parallel_pv_locked_matches_single(chirp, mesh):
    """Identity phase locking composes with the seq sharding (locking is a
    per-frame transform — shard-local, no extra collectives)."""
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.parallel import seq_parallel_pv, seq_pv_args

    (w, k, p), _ = _pv_setup(chirp)
    want = render_track_pv(w, k, phase_locking=True)
    kw, ops = seq_pv_args(p, mesh.shape["seq"])
    f = seq_parallel_pv(mesh, **kw, lock=True)
    win = jnp.asarray(S.hann_window(kw["size"]))
    out = f(
        jnp.asarray(w), *[jnp.asarray(o) for o in ops[:4]],
        win, *[jnp.asarray(o) for o in ops[4:]],
    )
    got = np.asarray(out)[: p.n_out]
    err = np.sqrt(np.mean((got - want) ** 2)) / (
        np.sqrt(np.mean(want**2)) + 1e-12
    )
    assert err < 2e-3, err


def test_seq_parallel_pv_tail_not_attenuated(chirp, mesh):
    """ADVICE r3 #1: the padded-frame wsum attenuated/truncated the OLA
    tail (up to size-hop stretched samples).  Assert the LAST 35 ms
    windows match the single-chip render tightly."""
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.parallel import seq_parallel_pv, seq_pv_args

    for (w, k, p) in _pv_setup(chirp):
        want = render_track_pv(w, k)
        kw, ops = seq_pv_args(p, mesh.shape["seq"])
        f = seq_parallel_pv(mesh, **kw)
        win = jnp.asarray(S.hann_window(kw["size"]))
        out = f(
            jnp.asarray(w), *[jnp.asarray(o) for o in ops[:4]],
            win, *[jnp.asarray(o) for o in ops[4:]],
        )
        got = np.asarray(out)[: p.n_out]
        tail = p.size - p.hop  # the span the old truncation corrupted
        a, b = want[-tail:], got[-tail:]
        err = np.sqrt(np.mean((a - b) ** 2)) / (
            np.sqrt(np.mean(want**2)) + 1e-12
        )
        assert err < 2e-3, err


def test_data_parallel_pv_formant_matches_single(chirp, mesh):
    """Formant-preserving PV of a two-edit batch sharded over ``data`` vs
    the single-device formant render of each track."""
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.parallel import data_parallel_pv, pv_batch_args

    (w1, k1, p1), (w2, k2, p2) = _pv_setup(chirp)
    d = mesh.shape["data"]
    tracks = [(w1, k1, p1), (w2, k2, p2)]
    while len(tracks) % d:
        tracks.append(tracks[0])
    kw, ops = pv_batch_args([p for _, _, p in tracks])
    pv = data_parallel_pv(mesh, **kw, formant=True)
    win = jnp.asarray(S.hann_window(kw["size"]))
    n_max = max(len(w) for w, _, _ in tracks)
    wav_b = np.zeros((len(tracks), n_max), np.float32)
    for i, (w, _, _) in enumerate(tracks):
        wav_b[i, : len(w)] = w
    out = pv(jnp.asarray(wav_b), *[jnp.asarray(o) for o in ops[:4]], win,
             *[jnp.asarray(o) for o in ops[4:]])
    for i, (w, k, p) in enumerate(tracks[:2]):
        want = render_track_pv(w, k, preserve_formants=True)
        got = np.asarray(out[i, : p.n_out])
        assert _rel_rms(got, want) < 2e-3, (i, _rel_rms(got, want))


def test_data_parallel_pv_locked(chirp, mesh):
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.parallel import data_parallel_pv, pv_batch_args

    (w1, k1, p1), _ = _pv_setup(chirp)
    d = mesh.shape["data"]
    tracks = [(w1, k1, p1)] * d
    kw, ops = pv_batch_args([p for _, _, p in tracks])
    pv = data_parallel_pv(mesh, **kw, lock=True)
    win = jnp.asarray(S.hann_window(kw["size"]))
    wav_b = np.stack([w for w, _, _ in tracks])
    out = pv(jnp.asarray(wav_b), *[jnp.asarray(o) for o in ops[:4]], win,
             *[jnp.asarray(o) for o in ops[4:]])
    want = render_track_pv(w1, k1, phase_locking=True)
    got = np.asarray(out[0, : p1.n_out])
    err = np.sqrt(np.mean((got - want) ** 2)) / (
        np.sqrt(np.mean(want**2)) + 1e-12
    )
    assert err < 2e-3, err


def test_data_parallel_pv_locked_two_edits(chirp, mesh):
    """Identity locking under the data-sharded batch with a DIFFERENT edit
    per row (peak picking and region spread run per row) vs the
    single-device locked render of each track."""
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.parallel import data_parallel_pv, pv_batch_args

    (w1, k1, p1), (w2, k2, p2) = _pv_setup(chirp)
    d = mesh.shape["data"]
    tracks = [(w1, k1, p1), (w2, k2, p2)]
    while len(tracks) % d:
        tracks.append(tracks[1])
    kw, ops = pv_batch_args([p for _, _, p in tracks])
    pv = data_parallel_pv(mesh, **kw, lock=True)
    win = jnp.asarray(S.hann_window(kw["size"]))
    n_max = max(len(w) for w, _, _ in tracks)
    wav_b = np.zeros((len(tracks), n_max), np.float32)
    for i, (w, _, _) in enumerate(tracks):
        wav_b[i, : len(w)] = w
    out = pv(jnp.asarray(wav_b), *[jnp.asarray(o) for o in ops[:4]], win,
             *[jnp.asarray(o) for o in ops[4:]])
    for i, (w, k, p) in enumerate(tracks[:2]):
        want = render_track_pv(w, k, phase_locking=True)
        got = np.asarray(out[i, : p.n_out])
        assert _rel_rms(got, want) < 2e-3, (i, _rel_rms(got, want))


def test_seq_parallel_pv_locked_second_edit(chirp, mesh):
    """Seq-sharded locked PV of the two-marker edit (bends of both signs,
    a stretch) vs the single-device locked render."""
    from melonix_tpu.engine.phase_vocoder import render_track_pv
    from melonix_tpu.parallel import seq_parallel_pv, seq_pv_args

    _, (w, k, p) = _pv_setup(chirp)
    want = render_track_pv(w, k, phase_locking=True)
    kw, ops = seq_pv_args(p, mesh.shape["seq"])
    f = seq_parallel_pv(mesh, **kw, lock=True)
    win = jnp.asarray(S.hann_window(kw["size"]))
    out = f(
        jnp.asarray(w), *[jnp.asarray(o) for o in ops[:4]],
        win, *[jnp.asarray(o) for o in ops[4:]],
    )
    got = np.asarray(out)[: p.n_out]
    assert _rel_rms(got, want) < 2e-3, _rel_rms(got, want)
