"""Phase-vocoder pitch/time renderer — the quality engine.

The granular renderer (engine/render.py) reproduces the reference's
zero-crossing-spliced resampler exactly (app.cpp:294-345).  This module is
the *added-capability* renderer (BASELINE.md configs): an STFT
phase-vocoder that honors the same edit model — the piecewise-linear
time-warp and pitch-bend maps (engine/maps.py) — with transform-domain
quality (no grain-seam amplitude modulation).

Formulation for time-VARYING pitch rate ``rho(t) = 2^(bend(t)/12)``:

1.  **Rate integral, closed form.**  ``p(t) = integral_0^t rho`` maps output
    time onto a "stretched" timeline.  The bend is piecewise linear, so p is
    piecewise *exponential* with an analytic expression per knot segment.

2.  **PV time-stretch.**  Synthesis frames sit at ``m * hop`` on the
    stretched timeline; frame m analyses the *source* at
    ``A_m = time2Sample(p^-1(m * hop / sr))`` — the host inverts p per
    segment in float64 (15k scalars).  The classic phase propagation

        dphi   = princarg(phi_m - phi_{m-1} - omega_k * dA_m)
        psi_m  = psi_{m-1} + hop * (omega_k + dphi_m / dA_m)

    is a prefix sum over frames (one cumsum), followed by the scatter-free
    stride-stacked overlap-add (engine/spectral.istft_device).  Hour-scale
    tracks are stretched in chunks with exact phase carry (the prefix sum
    and OLA are both linear), bit-consistent with a one-shot stretch.

3.  **Variable-rate resample** back to the output timeline — the only
    per-sample gathers in the pipeline.  Positions are produced as
    **int32 block bases + small float32 residuals**: absolute float32
    sample positions lose sub-sample precision past 2^23 samples (~3 min
    at 44.1 kHz; at hour scale the ulp is 16 samples and a resampler
    degrades to sample-and-hold).  The host evaluates the position curve
    in float64 at every 2048-sample output block start and at every rate
    segment start; the device reconstructs per-sample positions *relative
    to those anchors* from exactly-representable int32 sample offsets —
    full precision at any track length.

Formant preservation (BASELINE config #5): the final resample scales the
spectral envelope along with the harmonics; pre-warping each frame's
magnitudes by ``E(k * rho) / E(k)`` (cepstral envelope, evaluated with a
Chebyshev recurrence — no gathers) cancels that, keeping vocal timbre in
place.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, Config
from .maps import MapKnots
from .spectral import hann_window, istft_device

LN2_12 = np.log(2.0) / 12.0
BLK = 2048  # output samples per resample block (one int32 base per block)
SLACK = 128  # guard below the host base for device f32 rounding


def block_bases(pos_block_starts: np.ndarray, n_src: int) -> np.ndarray:
    """Host: int32 base per resample block from float64 start positions,
    lowered by SLACK so device f32 rounding never reads below it."""
    base = np.floor(pos_block_starts).astype(np.int64) - SLACK
    return np.clip(base, 0, max(n_src - 1, 0)).astype(np.int32)


def expm1_precise(x):
    """f32 expm1 with ~1-ulp relative error for |x| <= 0.7.

    XLA's f32 ``expm1`` carries ~1.2e-4 relative error (measured; numpy's
    is correctly rounded).  The PV position formulas multiply that error by
    the span length in samples, turning it into ~0.1-sample position error
    — audible aliasing at hour scale.  A 9-term Horner Taylor series is
    ~1-ulp accurate over the |x| <= 0.7 range the per-block anchors
    guarantee for ordinary bends; the rare larger sweep falls back to
    exp(x) - 1 (bounded cancellation there since |expm1| > 0.5)."""
    p = 1.0 + x / 9.0
    for k in (8.0, 7.0, 6.0, 5.0, 4.0, 3.0, 2.0):
        p = 1.0 + x * p / k
    return jnp.where(jnp.abs(x) <= 0.7, x * p, jnp.exp(x) - 1.0)


def _segment_table(knots: MapKnots, t_end: float):
    """Per-segment (t0, b0, slope, P0) float64 rows covering [0, t_end].

    Segments: the knot intervals, the relaxation to 0 at duration()
    (app.cpp:1115-1119), and a constant-1-rate tail.  P0 is the exact
    cumulative rate integral at t0.
    """
    dur = knots.duration()
    ts = [float(t) for t in knots.times] + [max(dur, float(knots.times[-1])), t_end]
    bs = [float(b) for b in knots.bends] + [0.0, 0.0]
    # Deduplicate/enforce monotone (degenerate zero-length segments drop out)
    t0s, b0s, slopes, p0s = [], [], [], []
    P = 0.0
    for i in range(len(ts) - 1):
        t0, t1 = ts[i], ts[i + 1]
        if t1 <= t0:
            continue
        b0, b1 = bs[i], bs[i + 1]
        s = (b1 - b0) / (t1 - t0)
        t0s.append(t0)
        b0s.append(b0)
        slopes.append(s)
        p0s.append(P)
        r0, r1 = 2.0 ** (b0 / 12.0), 2.0 ** (b1 / 12.0)
        if abs(b1 - b0) < 1e-12:
            P += r0 * (t1 - t0)
        else:
            P += (t1 - t0) * (r1 - r0) / ((b1 - b0) * LN2_12)
    if not t0s:
        t0s, b0s, slopes, p0s = [0.0], [0.0], [0.0], [0.0]
    return (
        np.asarray(t0s), np.asarray(b0s), np.asarray(slopes), np.asarray(p0s), P
    )


def rate_integral_total(knots: MapKnots, t_end: float) -> float:
    """Exact ``integral_0^t_end 2^(bend(t)/12) dt`` (host sizing)."""
    return float(_segment_table(knots, t_end)[4])


def _invert_p(table, y: np.ndarray) -> np.ndarray:
    """t with p(t) = y, per-segment closed form (float64, vectorized)."""
    t0s, b0s, slopes, p0s, _ = table
    seg = np.clip(np.searchsorted(p0s, y, side="right") - 1, 0, len(t0s) - 1)
    t0, b0, s, P0 = t0s[seg], b0s[seg], slopes[seg], p0s[seg]
    r0 = 2.0 ** (b0 / 12.0)
    dy = y - P0
    flat = np.abs(s) < 1e-12
    with np.errstate(invalid="ignore", divide="ignore"):
        r_t = r0 + dy * s * LN2_12
        t_exp = t0 + (12.0 * np.log2(np.maximum(r_t, 1e-30)) - b0) / np.where(flat, 1.0, s)
    return np.where(flat, t0 + dy / r0, t_exp)


def _princarg(x):
    return jnp.mod(x + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def _shift_bins(x, d: int, fill):
    """x[..., k - d] along the bin axis, edges filled (no wraparound)."""
    pad = jnp.full(x[..., :abs(d)].shape, fill, x.dtype)
    if d > 0:
        return jnp.concatenate([pad, x[..., :-d]], axis=-1)
    return jnp.concatenate([x[..., -d:], pad], axis=-1)


def identity_lock(psi, phi, mag):
    """Laroche–Dolson identity phase locking (BASELINE.json north star:
    "phase unwrap + identity phase locking").

    Classic per-bin propagation keeps every channel's phase independent;
    around one sinusoid the 4-5 window-mainlobe bins then drift apart and
    the resynthesis loses vertical coherence — the "phasiness" artifact
    on polyphonic material.  Identity locking (Laroche & Dolson 1999)
    picks spectral peaks per frame and rigidly locks each bin's synthesis
    phase to its region's peak:  psi[k] = psi[p] + (phi[k] - phi[p]).

    Data-parallel formulation: peak channels carry the classic per-bin
    recursion (the parallel prefix sum of engine/phase_vocoder.py stays —
    the paper's sequential peak-to-peak recursion coincides with it
    whenever a partial's peak bin persists frame to frame, the steady
    case locking is about), and the region spread is GATHER-FREE: the
    per-region constant ``theta = psi - phi`` propagates from the peaks
    with forward/backward segmented-fill scans along the bin axis
    (log-depth ``associative_scan`` of (value, position) pairs, all
    elementwise passes over the (F, K) spectrum).
    Regions split at the midpoint between adjacent peaks; frames with no
    peak (silence) keep their classic phases.

    All inputs are (F, n_bins) in NATURAL bin order; returns locked psi.
    """
    k_idx = jnp.arange(mag.shape[-1], dtype=jnp.int32)
    neg = jnp.float32(-1.0)  # mag >= 0: edges always lose the comparison
    peak = (
        (mag > 0.0)  # an all-zero (silent) frame has no peaks
        & (mag > _shift_bins(mag, 1, neg))
        & (mag >= _shift_bins(mag, -1, neg))
        & (mag > _shift_bins(mag, 2, neg))
        & (mag >= _shift_bins(mag, -2, neg))
    )
    theta = psi - phi
    none = jnp.int32(-(1 << 30))
    val0 = jnp.where(peak, theta, 0.0)
    pos0 = jnp.where(peak, k_idx, none)

    def fill(val, pos):
        def comb(a, b):
            av, ap = a
            bv, bp = b
            take_b = bp > none
            return jnp.where(take_b, bv, av), jnp.where(take_b, bp, ap)

        # associative_scan requires a non-negative axis index.
        return jax.lax.associative_scan(comb, (val, pos), axis=val.ndim - 1)

    th_f, pos_f = fill(val0, pos0)
    # Backward fill = forward fill on the flipped axis; the stored pair
    # values are the ORIGINAL k indices, so no index remap is needed.
    th_b, pos_b = jax.tree.map(
        lambda a: jnp.flip(a, axis=-1),
        fill(jnp.flip(val0, axis=-1), jnp.flip(pos0, axis=-1)),
    )
    d_f = jnp.where(pos_f > none, k_idx - pos_f, 1 << 30)
    d_b = jnp.where(pos_b > none, pos_b - k_idx, 1 << 30)
    th_near = jnp.where(d_f <= d_b, th_f, th_b)
    has_peak = jnp.minimum(d_f, d_b) < (1 << 30)
    return phi + jnp.where(has_peak, th_near, theta)


def _src_eval64(table, t_a: np.ndarray, sr: float) -> tuple[np.ndarray, ...]:
    """Float64 (src, rho, slope) of the stretched position curve at times t_a.

    src(t) = p(t)*sr - rho(t): the "exclusive" convention matching the
    per-sample cumulative-rate positions (sample j sits at p(t_j)*sr with
    t_j = (j+1)/sr, minus its own rate — so src(t_0) = 0 for unit rate).
    """
    t0s, b0s, slopes, p0s, _ = table
    seg = np.clip(np.searchsorted(t0s, t_a, side="right") - 1, 0, len(t0s) - 1)
    dt = t_a - t0s[seg]
    s = slopes[seg]
    r0 = 2.0 ** (b0s[seg] / 12.0)
    rho = 2.0 ** ((b0s[seg] + s * dt) / 12.0)
    flat = np.abs(s) < 1e-12
    with np.errstate(invalid="ignore", divide="ignore"):
        p = p0s[seg] + np.where(
            flat, r0 * dt, (rho - r0) / (np.where(flat, 1.0, s) * LN2_12)
        )
    return np.maximum(p * sr - rho, 0.0), rho, s


def _anchor_table(table, sr: float, n_out_pad: int, n_src: int):
    """Host control plane for the block-relative resample positions.

    Anchors = every resample block start UNION every rate-segment start, so
    no anchor-to-anchor span crosses a segment boundary and every span is
    <= BLK samples (exact int32 offsets, full f32 precision on device).

    Returns (anc_j int32, src_rel f64, rho f64, slope f64, base int32) with
    ``src_rel = src64(anchor) - base[block(anchor)]`` — small by
    construction (block span + SLACK), so its f32 image keeps ~1e-3-sample
    precision regardless of track length.
    """
    t0s = table[0]
    nb = n_out_pad // BLK
    jb = np.arange(nb, dtype=np.int64) * BLK
    seg_j0 = np.clip(
        np.ceil(t0s * sr - 1.0 - 1e-9), 0, n_out_pad - 1
    ).astype(np.int64)
    anc_j = np.union1d(jb, seg_j0)
    t_a = (anc_j + 1.0) / sr
    src_a, rho_a, s_a = _src_eval64(table, t_a, sr)
    # Block bases from the float64 block-start positions.
    base = block_bases(src_a[np.searchsorted(anc_j, jb)], n_src)
    src_rel = src_a - base[np.minimum(anc_j // BLK, nb - 1)].astype(np.float64)
    return anc_j.astype(np.int32), src_rel, rho_a, s_a, base


@partial(jax.jit, static_argnames=("n_out", "sr"))
def _positions_rel_device(anc_j0, anc_src_b, anc_r_b, anc_s_b, n_out, sr):
    """Block-relative per-sample stretched positions, float32-exact.

    Anchor constants arrive as segmented broadcasts (scatter diffs at
    anchor starts + int32 cumsum — bit-exact through the sum, in any
    summation order).  Within a span, dt = (j - j0)/sr with the int
    subtraction done in int32 (exact), and

        rho(t)  = r_a * exp(s * dt * ln2/12)
        p - p_a = r_a * expm1(s * dt * ln2/12) / (s * ln2/12)
        src_rel = src_rel_a + r_a * ((p - p_a)/r_a * sr - expm1(...))

    expm1 keeps full relative precision for the small per-span exponent
    (a plain exp2(x) - 1 would cancel catastrophically for tiny slopes).
    """
    j = jnp.arange(n_out, dtype=jnp.int32)

    def seg_i32(vals):
        d = jnp.zeros(n_out, jnp.int32).at[anc_j0[1:]].add(
            jnp.diff(vals), mode="drop"
        )
        return vals[0] + jnp.cumsum(d)

    def seg_f32(bits):
        return jax.lax.bitcast_convert_type(seg_i32(bits), jnp.float32)

    j0 = seg_i32(anc_j0)
    src0 = seg_f32(anc_src_b)
    r_a = seg_f32(anc_r_b)
    s = seg_f32(anc_s_b)
    dt = (j - j0).astype(jnp.float32) / np.float32(sr)
    x = s * dt * np.float32(LN2_12)
    # XLA's f32 expm1 has ~1.2e-4 relative error — amplified by the span
    # length into ~0.1-sample position error (see expm1_precise).
    em1 = expm1_precise(x)
    flat = jnp.abs(s) < 1e-9
    delta_p = jnp.where(
        flat, dt, em1 / (jnp.where(flat, 1.0, s) * np.float32(LN2_12))
    )
    src_rel = src0 + r_a * (delta_p * np.float32(sr) - em1)
    return jnp.maximum(src_rel, 0.0)


PV_CHUNK_FRAMES = 49152  # frames per stretch chunk (~2.5 GB of intermediates)


def _stretch_chunk_core(
    wav,
    starts_c,  # i32 (n_frames_c,) exact frame starts (host float64 floor)
    da_c,  # f32 (n_frames_c,) A_m - A_{m-1}, host float64 diffs
    rho_c,  # f32 (n_frames_c,)
    window,
    m0,  # i32 scalar: global index of the chunk's first frame
    f_real,  # i32 scalar: real (unpadded) frames in this chunk
    phi0,  # f32 (n_bins,) global anchor phase (ignored when m0 == 0)
    resid_in,  # f32 (n_bins,) carried phase residual sum
    phi_prev,  # f32 (n_bins,) previous chunk's last analysis phase
    *,
    size, hop, n_frames_c,
    formant=False, n_ceps=40, lock=False,
):
    """Unnormalized OLA contribution of frames [m0, m0+f_real) plus carried
    phase state.  Hour-scale tracks are stretched in chunks to bound the
    (frames, bins) intermediates; the phase prefix-sum carries exactly
    across chunks (resid_in) and OLA overlaps add linearly, so chunking is
    bit-consistent with one shot — no phase resets, no crossfades.  Frame
    starts are int32 (exact at any track length; float32 absolute
    positions quantize past 2^23 samples).

    Vmappable over (wav, phi0, resid_in, phi_prev): the frame plan is
    channel-independent, so a multichannel session stretches all channels
    in one batched call.
    """
    n = wav.shape[0]
    n_bins = size // 2 + 1
    # The frame gather fuses into the FFT's input producer.
    idx = starts_c[:, None] + jnp.arange(size, dtype=jnp.int32)[None, :]
    frames = jnp.where(idx < n, wav[jnp.clip(idx, 0, n - 1)], 0.0)
    spec = jnp.fft.rfft(frames * window[None, :])
    mag = jnp.abs(spec)
    phi = jnp.angle(spec)
    omega = (2.0 * jnp.pi / size) * jnp.arange(n_bins, dtype=jnp.float32)
    k_idx = jnp.arange(n_bins, dtype=jnp.int32)
    if formant:
        mag = mag * _formant_gain(mag, rho_c, size, n_bins, n_ceps)

    da = jnp.maximum(da_c, 1e-3)[:, None]
    phi_full_prev = jnp.concatenate([phi_prev[None, :], phi[:-1]], axis=0)
    dphi = _princarg(phi - phi_full_prev - omega[None, :] * da)
    # Residual only — the exact int-mod ramp carries the hop*omega part.
    incr = hop * dphi / da
    # Global frame 0 has no predecessor: psi_0 = phi_0 exactly.
    incr = incr.at[0].set(jnp.where(m0 == 0, jnp.zeros_like(incr[0]), incr[0]))
    cum = jnp.cumsum(incr, axis=0)
    resid = resid_in[None, :] + cum

    # psi_m = phi0 + m*hop*omega + resid.  The linear ramp is evaluated
    # mod 2pi with int32 arithmetic — a float32 running sum would hit
    # 2.5e7 rad on a 3-minute track, where one ulp is ~2 rad.
    m_global = m0 + jnp.arange(n_frames_c, dtype=jnp.int32)
    hm = jnp.mod(m_global * hop, size)
    ramp = (2.0 * jnp.pi / size) * jnp.mod(
        hm[:, None] * k_idx[None, :], size
    ).astype(jnp.float32)
    phi0_eff = jnp.where(m0 == 0, phi[0], phi0)
    psis = phi0_eff[None, :] + ramp + resid

    if lock:
        # Identity phase locking: a per-frame transform of (psi, phi, mag)
        # — no extra carried state, so chunking stays bit-consistent with
        # a one-shot stretch.  Peaks are picked on the synthesized mag
        # (post formant warp — the warp gain is smooth, so the peak set
        # is the analysis one in practice).
        psis = identity_lock(psis, phi, mag)

    # Padded frames must contribute silence (their OLA tails would reach
    # back into the real span).
    live = (jnp.arange(n_frames_c) < f_real)[:, None]
    mag_live = jnp.where(live, mag, 0.0)
    psis = psis.astype(jnp.float32)
    out_len_c = (n_frames_c - 1) * hop + size
    synth = mag_live * jnp.exp(1j * psis)
    y_c = istft_device(synth, window, size, hop, out_len_c, normalize=False)
    last = jnp.clip(f_real - 1, 0, n_frames_c - 1)
    return y_c, resid[last], phi[last], phi0_eff


@partial(jax.jit, static_argnames=("size", "hop", "n_frames_c", "formant",
                                   "n_ceps", "lock"))
def _stretch_chunk(
    wav, starts_c, da_c, rho_c, window, m0, f_real, phi0, resid_in, phi_prev,
    size, hop, n_frames_c, formant=False, n_ceps=40, lock=False,
):
    """Single-track chunk stretch (jitted ``_stretch_chunk_core``)."""
    return _stretch_chunk_core(
        wav, starts_c, da_c, rho_c, window, m0, f_real, phi0, resid_in,
        phi_prev, size=size, hop=hop, n_frames_c=n_frames_c,
        formant=formant, n_ceps=n_ceps, lock=lock,
    )


def _pack_frame_plan(plan: PVPlan, ch: int, formant: bool) -> np.ndarray:
    """One int32 host buffer holding every chunk's frame arrays, edge-padded
    to whole chunks — one host->device transfer per render instead of 3
    arrays x n_chunks.  Rows: frame starts, da bit patterns, and (formant
    only — it is unused otherwise) rho bit patterns.  Values identical to
    ``_chunk_arrays``."""
    n_chunks = -(-plan.n_frames // ch)
    npad = n_chunks * ch
    pad = npad - plan.n_frames
    starts_p = np.pad(plan.starts_m, (0, pad), mode="edge")
    da_p = np.ascontiguousarray(
        np.pad(plan.da_m, (0, pad), constant_values=float(plan.hop))
    ).view(np.int32)
    rows = [starts_p, da_p]
    if formant:
        rho32 = np.ascontiguousarray(
            np.pad(plan.rho_m.astype(np.float32), (0, pad), mode="edge")
        ).view(np.int32)
        rows.append(rho32)
    return np.stack(rows)


@partial(jax.jit, static_argnames=("size", "hop", "n_frames_c", "formant",
                                   "n_ceps", "lock"))
def _stretch_chunk_packed(
    wav, packed, window, m0, f_real, phi0, resid_in, phi_prev,
    size, hop, n_frames_c, formant=False, n_ceps=40, lock=False,
):
    """``_stretch_chunk`` reading its frame arrays from the packed device
    plan (``_pack_frame_plan``): the chunk slice happens ON DEVICE at the
    traced offset m0, so the host loop re-dispatches one cached executable
    per chunk with zero per-chunk transfers."""
    sl = jax.lax.dynamic_slice(
        packed, (0, m0), (packed.shape[0], n_frames_c)
    )
    starts_c = sl[0]
    da_c = jax.lax.bitcast_convert_type(sl[1], jnp.float32)
    rho_c = (
        jax.lax.bitcast_convert_type(sl[2], jnp.float32)
        if formant else jnp.zeros(n_frames_c, jnp.float32)
    )
    return _stretch_chunk_core(
        wav, starts_c, da_c, rho_c, window, m0, f_real, phi0, resid_in,
        phi_prev, size=size, hop=hop, n_frames_c=n_frames_c,
        formant=formant, n_ceps=n_ceps, lock=lock,
    )


@partial(jax.jit, static_argnames=("size", "hop", "n_frames_c", "formant",
                                   "n_ceps", "lock"))
def _stretch_chunk_batched(
    wav_b, starts_c, da_c, rho_c, window, m0, f_real, phi0_b, resid_b, phi_prev_b,
    size, hop, n_frames_c, formant=False, n_ceps=40, lock=False,
):
    """Channel-batched chunk stretch: one frame plan, C spectra.

    The batch axis is pure data parallelism (no cross-channel terms), so
    under a multi-device sharding it partitions without collectives."""
    return jax.vmap(
        lambda w, p0, rs, pp: _stretch_chunk_core(
            w, starts_c, da_c, rho_c, window, m0, f_real, p0, rs, pp,
            size=size, hop=hop, n_frames_c=n_frames_c,
            formant=formant, n_ceps=n_ceps, lock=lock,
        )
    )(wav_b, phi0_b, resid_b, phi_prev_b)


def _formant_gain(mag, rho_m, size, n_bins, n_ceps):
    """Cepstral-envelope warp gain over the natural half spectrum.

    The envelope is n_ceps cosine coefficients, so E at the rho-scaled
    bins is evaluated *directly* with a Chebyshev recurrence — pure
    elementwise math instead of two (frames x bins) lerp gathers.

    The cepstral projection is an f32 matmul pinned to
    ``Precision.HIGHEST``: left at the default a GPU may run it in TF32
    (~3 decimal digits), which would move the envelope by far more than
    the float32 pipeline around it.
    """
    log_mag = jnp.log(mag + 1e-8)
    qq = np.arange(1, n_ceps, dtype=np.float64)
    kk = np.arange(n_bins, dtype=np.float64)
    wk = np.full(n_bins, 2.0 / size)
    wk[0] = 1.0 / size
    wk[-1] = 1.0 / size
    a_mat = jnp.asarray(
        (wk[:, None] * np.cos(2.0 * np.pi * kk[:, None] * qq[None, :] / size))
        .astype(np.float32)
    )  # (bins, n_ceps-1): c_q = L @ a_mat; c_0 = mean via wk row-sum
    cep = jnp.dot(log_mag, a_mat, precision=jax.lax.Precision.HIGHEST,
                  preferred_element_type=jnp.float32)
    # gain_log[k] = sum_q 2 c_q (cos(q*theta*rho) - cos(q*theta)); the
    # q=0 term cancels.  Chebyshev: T_q(cos t) = cos(q t).
    theta = (2.0 * jnp.pi / size) * jnp.asarray(kk, jnp.float32)
    c1w = jnp.cos(theta[None, :] * rho_m[:, None])
    c1p = jnp.broadcast_to(jnp.cos(theta)[None, :], c1w.shape)
    tw_prev, tw_cur = jnp.ones_like(c1w), c1w
    tp_prev, tp_cur = jnp.ones_like(c1p), c1p
    gain_log = 2.0 * cep[:, 0:1] * (c1w - c1p)
    for qi in range(2, n_ceps):
        tw_prev, tw_cur = tw_cur, 2.0 * c1w * tw_cur - tw_prev
        tp_prev, tp_cur = tp_cur, 2.0 * c1p * tp_cur - tp_prev
        gain_log = gain_log + 2.0 * cep[:, qi - 1 : qi] * (tw_cur - tp_cur)
    return jnp.exp(jnp.clip(gain_log, -6.9, 6.9))  # +-60 dB


@partial(jax.jit, static_argnames=("size", "hop", "n_frames", "out_len"))
def _ola_wsum(window, size: int, hop: int, n_frames: int, out_len: int):
    """Global window-square OLA normalizer.

    The interior is hop-periodic (every sample sees the same k = size/hop
    window taps), so the whole array is ONE tiled write of the (hop,)
    pattern plus two size-long edge corrections (head: frames g < 0
    missing; tail: frames g >= n_frames missing) — one pass over the
    output instead of k ``.at[].add`` strips.
    """
    k = size // hop
    w2 = window * window
    if size % hop != 0 or n_frames < k:
        # Non-whole overlap or a track shorter than one window span of
        # frames (head/tail regions overlap): plain scatter build.
        offs = jnp.arange(n_frames, dtype=jnp.int32) * hop
        idx = offs[:, None] + jnp.arange(size, dtype=jnp.int32)[None, :]
        wsum = jnp.zeros(out_len, jnp.float32).at[idx.reshape(-1)].add(
            jnp.tile(w2, (n_frames,)), mode="drop"
        )
        return jnp.maximum(wsum, 1e-8)
    rows = w2.reshape(k, hop)
    pat = jnp.sum(rows, axis=0)  # (hop,)
    nt = -(-out_len // hop)
    ws = jnp.tile(pat, nt)[:out_len]
    # Edge regions are OVERWRITTEN with exact partial sums (subtracting
    # the missing taps from the pattern cancels catastrophically where
    # the Hann edge makes wsum ~1e-7).  Head, j = c*hop + r, c < k: only
    # taps c' <= c present (prefix-sum).  Tail, j = n_frames*hop + v:
    # only taps c' > c(v) present (exclusive suffix-sum).
    head = jnp.cumsum(rows, axis=0).reshape(size)
    n_head = min(size, out_len)
    ws = ws.at[:n_head].set(head[:n_head])
    j0 = n_frames * hop
    if j0 < out_len:
        tail = (jnp.cumsum(rows[::-1], axis=0)[::-1] - rows).reshape(size)
        n_tail = min(size, out_len - j0)
        ws = ws.at[j0 : j0 + n_tail].set(tail[:n_tail])
    return jnp.maximum(ws, 1e-8)


@jax.jit
def _accum_at(y, y_c, off):
    """y[off : off+len(y_c)] += y_c with a traced offset (one compile)."""
    cur = jax.lax.dynamic_slice(y, (off,), (y_c.shape[0],))
    return jax.lax.dynamic_update_slice(y, cur + y_c, (off,))


@partial(jax.jit, static_argnames=("stretch_len", "blk"))
def _lerp_resample_rel_xla(y, src_rel, base, stretch_len: int, blk: int):
    """Lerp at base[block] + relative position (exact i32): one scan-free
    broadcast of the block bases and two gathers from ``y``."""
    nb = src_rel.shape[0] // blk
    b = jnp.broadcast_to(base[:nb, None], (nb, blk)).reshape(-1)
    rel_f = jnp.floor(src_rel)
    frac = src_rel - rel_f
    i0 = b + rel_f.astype(jnp.int32)
    lo = y[jnp.clip(i0, 0, stretch_len - 1)]
    hi = y[jnp.clip(i0 + 1, 0, stretch_len - 1)]
    return (1.0 - frac) * lo + frac * hi


@dataclasses.dataclass(frozen=True)
class PVPlan:
    """Host control plane of one PV render (channel-independent).

    The plan depends only on the edit model (knots) and track length, never
    on the samples — a multichannel session builds it once and stretches
    every channel against it (data-parallel over channels/tracks).
    """

    size: int
    hop: int
    sr: int
    n_wav: int
    n_out: int
    n_out_pad: int
    n_frames: int
    stretch_len: int
    starts_m: np.ndarray  # int32 (n_frames,) exact frame starts
    da_m: np.ndarray  # float32 (n_frames,) frame advances
    rho_m: np.ndarray  # float64 (n_frames,) per-frame pitch rate
    anc_np: tuple  # host (anc_j, src_f32, rho_f32, s_f32), padded
    base: np.ndarray  # int32 resample block bases

    @cached_property
    def anc_args(self) -> tuple:
        """Device anchor arrays for ``_positions_rel_device``, uploaded on
        first use.  Float values travel as int32 bit patterns (bit-exact
        through device math)."""
        anc_j_p, src_f, r_f, s_f = self.anc_np
        return (
            jnp.asarray(anc_j_p),
            jnp.asarray(src_f.view(np.int32)),
            jnp.asarray(r_f.view(np.int32)),
            jnp.asarray(s_f.view(np.int32)),
        )


def build_pv_plan(
    knots: MapKnots,
    n_wav: int,
    *,
    config: Config = DEFAULT_CONFIG,
    size: int | None = None,
    hop: int | None = None,
) -> PVPlan | None:
    """Float64 host control plane; None when the render is empty."""
    size = size or config.stft_size
    hop = hop or config.stft_hop
    sr = knots.sample_rate
    n_out = int(knots.duration() * sr)
    if n_out <= 0 or n_wav < size:
        return None

    table = _segment_table(knots, n_out / sr)
    p_total = table[4]
    n_frames = int(np.ceil(p_total * sr / hop)) + 2
    n_frames = 64 * -(-n_frames // 64)
    n_out_pad = 8192 * -(-n_out // 8192)
    stretch_len = (n_frames - 1) * hop + size

    # Frame positions by analytic inversion, exact int32 frame starts,
    # float64-differenced frame advances.
    y_m = np.arange(n_frames, dtype=np.float64) * hop / sr
    t_m = _invert_p(table, np.minimum(y_m, p_total))
    a_m = knots.time_to_sample_float(t_m)
    rho_m = 2.0 ** (knots.time_to_pitch_bend(t_m).astype(np.float64) / 12.0)
    starts_m = np.floor(np.clip(a_m, 0.0, n_wav - 1.0)).astype(np.int32)
    da_m = np.maximum(
        np.diff(a_m, prepend=a_m[0] - hop), 1e-3
    ).astype(np.float32)

    # Resample anchors: block-relative positions (see _anchor_table).
    anc_j, src_rel64, rho_a, s_a, base = _anchor_table(
        table, sr, n_out_pad, stretch_len
    )
    n_anc = 512 * -(-len(anc_j) // 512)  # bucket compile shapes
    pad_a = n_anc - len(anc_j)
    anc_j_p = np.pad(anc_j, (0, pad_a), constant_values=n_out_pad)
    anc_np = (
        anc_j_p,
        np.pad(np.asarray(src_rel64, np.float32), (0, pad_a), mode="edge"),
        np.pad(np.asarray(rho_a, np.float32), (0, pad_a), mode="edge"),
        np.pad(np.asarray(s_a, np.float32), (0, pad_a), mode="edge"),
    )
    return PVPlan(
        size=size, hop=hop, sr=sr, n_wav=n_wav, n_out=n_out,
        n_out_pad=n_out_pad, n_frames=n_frames, stretch_len=stretch_len,
        starts_m=starts_m, da_m=da_m, rho_m=rho_m,
        anc_np=anc_np, base=base,
    )


def _chunk_arrays(plan: PVPlan, m0: int, ch: int):
    """Padded (starts, da, rho_f32, f_real) arrays for frames [m0, m0+ch)."""
    f_real = min(ch, plan.n_frames - m0)
    sl = slice(m0, m0 + f_real)
    pad_c = ch - f_real
    starts_c = np.pad(plan.starts_m[sl], (0, pad_c), mode="edge")
    da_c = np.pad(plan.da_m[sl], (0, pad_c), constant_values=float(plan.hop))
    rho_c = np.pad(plan.rho_m[sl].astype(np.float32), (0, pad_c), mode="edge")
    return starts_c, da_c, rho_c, f_real


def render_track_pv(
    wav,
    knots: MapKnots,
    *,
    config: Config = DEFAULT_CONFIG,
    size: int | None = None,
    hop: int | None = None,
    preserve_formants: bool = False,
    phase_locking: bool = False,
    device_out: bool = False,
) -> np.ndarray:
    """Full-track phase-vocoder render honoring the marker edit model.

    Output spans the warped duration (``knots.duration()``); unlike the
    granular engine there is no 1500-zero reference tail.  With
    ``preserve_formants`` the spectral envelope (vocal timbre) stays put
    while the pitch moves (cepstral envelope warp, BASELINE config #5).
    ``phase_locking`` enables Laroche–Dolson identity phase locking
    (:func:`identity_lock`) — vertical phase coherence around spectral
    peaks, the fix for polyphonic "phasiness".

    ``device_out`` returns the render as a device array without the
    device->host download (an hour of float32 is 635 MB): callers that
    feed the output to further device work (batch serving, export encode
    on device, benchmarks) keep it resident.
    """
    if isinstance(wav, jax.Array):  # already resident: skip the re-upload
        wav_dev = wav.astype(jnp.float32)
        n_wav = int(wav.shape[0])
    else:
        wav_np = np.asarray(wav, np.float32)
        wav_dev = jnp.asarray(wav_np)
        n_wav = len(wav_np)
    plan = build_pv_plan(knots, n_wav, config=config, size=size, hop=hop)
    if plan is None:
        zeros = np.zeros(max(int(knots.duration() * knots.sample_rate), 0), np.float32)
        return jnp.asarray(zeros) if device_out else zeros
    return _render_with_plan(wav_dev, plan, preserve_formants,
                             phase_locking=phase_locking,
                             device_out=device_out)


def _render_with_plan(
    wav_dev, plan: PVPlan, preserve_formants: bool, phase_locking: bool = False,
    device_out: bool = False,
):
    """One channel through a PVPlan: chunked stretch (one cached executable
    per chunk), one global OLA normalization, block-relative resample."""
    size, hop, sr = plan.size, plan.hop, plan.sr
    n_frames, stretch_len = plan.n_frames, plan.stretch_len

    win_dev = jnp.asarray(hann_window(size))

    # Stretch in chunks with exact phase carry; OLA contributions add
    # linearly; normalize once globally.  Short tracks take one chunk.
    ch = min(PV_CHUNK_FRAMES, n_frames)
    n_bins = size // 2 + 1
    one_chunk = n_frames <= ch
    # Multi-chunk renders accumulate into a padded buffer; a single chunk
    # IS the whole stretch ((ch-1)*hop + size == stretch_len), so skip the
    # zeros + read-modify-write accumulate pass entirely.
    y = None if one_chunk else jnp.zeros(
        stretch_len + ch * hop + size, jnp.float32
    )
    resid = jnp.zeros(n_bins, jnp.float32)
    phi_prev = jnp.zeros(n_bins, jnp.float32)
    phi0 = jnp.zeros(n_bins, jnp.float32)
    packed_dev = jnp.asarray(_pack_frame_plan(plan, ch, preserve_formants))
    for m0 in range(0, n_frames, ch):
        f_real = min(ch, n_frames - m0)
        y_c, resid, phi_prev, phi0 = _stretch_chunk_packed(
            wav_dev, packed_dev, win_dev,
            jnp.int32(m0), jnp.int32(f_real),
            phi0, resid, phi_prev,
            size, hop, ch, formant=preserve_formants, lock=phase_locking,
        )
        y = y_c if one_chunk else _accum_at(y, y_c, jnp.int32(m0 * hop))

    wsum = _ola_wsum(win_dev, size, hop, n_frames, stretch_len)
    y = y[:stretch_len] / wsum
    src_rel = _positions_rel_device(*plan.anc_args, plan.n_out_pad, sr)
    out = _lerp_resample_rel_xla(
        y, src_rel, jnp.asarray(plan.base), stretch_len, BLK
    )
    return out[:plan.n_out] if device_out else np.asarray(out[:plan.n_out])


@jax.jit
def _accum_at_b(y_b, y_c_b, off):
    return jax.vmap(lambda y, yc: _accum_at(y, yc, off))(y_b, y_c_b)


@partial(jax.jit, static_argnames=("stretch_len", "blk"))
def _lerp_resample_rel_xla_b(y_b, src_rel, base, stretch_len: int, blk: int):
    return jax.vmap(
        lambda y: _lerp_resample_rel_xla(y, src_rel, base, stretch_len, blk)
    )(y_b)


def render_channels_pv(
    wav_ch,
    knots: MapKnots,
    *,
    config: Config = DEFAULT_CONFIG,
    size: int | None = None,
    hop: int | None = None,
    preserve_formants: bool = False,
    phase_locking: bool = False,
    mesh=None,
) -> np.ndarray:
    """(C, n) channels through ONE shared PV plan, batched on device.

    The edit model is channel-independent, so the host control plane is
    built once and the stretch/normalize/resample pipeline runs vmapped
    over the channel axis — pure data parallelism.  With ``mesh`` the
    channel axis is placed on the mesh's ``data`` axis (padding with zero
    channels to the shard count), so a multichannel session render scales
    across devices without collectives.  This is the batched-session path
    of BASELINE config #5, reachable from ``render_session``.
    """
    wav_ch = np.asarray(wav_ch, np.float32)
    C, n_wav = wav_ch.shape
    plan = build_pv_plan(knots, n_wav, config=config, size=size, hop=hop)
    if plan is None:
        n_out = max(int(knots.duration() * knots.sample_rate), 0)
        return np.zeros((C, n_out), np.float32)
    size, hop, sr = plan.size, plan.hop, plan.sr

    sharding = None
    B = C
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        d = mesh.shape["data"]
        B = d * -(-C // d)
        sharding = NamedSharding(mesh, PartitionSpec("data", None))

    def _put(arr):
        return jnp.asarray(arr) if sharding is None else jax.device_put(arr, sharding)

    wav_b = wav_ch if B == C else np.pad(wav_ch, ((0, B - C), (0, 0)))
    wav_dev = _put(wav_b)
    win_dev = jnp.asarray(hann_window(size))

    ch = min(PV_CHUNK_FRAMES, plan.n_frames)
    n_bins = size // 2 + 1
    y = _put(np.zeros((B, plan.stretch_len + ch * hop + size), np.float32))
    resid = _put(np.zeros((B, n_bins), np.float32))
    phi_prev = _put(np.zeros((B, n_bins), np.float32))
    phi0 = _put(np.zeros((B, n_bins), np.float32))
    for m0 in range(0, plan.n_frames, ch):
        starts_c, da_c, rho_c, f_real = _chunk_arrays(plan, m0, ch)
        y_c, resid, phi_prev, phi0 = _stretch_chunk_batched(
            wav_dev, jnp.asarray(starts_c), jnp.asarray(da_c),
            jnp.asarray(rho_c), win_dev,
            jnp.int32(m0), jnp.int32(f_real),
            phi0, resid, phi_prev,
            size, hop, ch, formant=preserve_formants, lock=phase_locking,
        )
        y = _accum_at_b(y, y_c, jnp.int32(m0 * hop))
    wsum = _ola_wsum(win_dev, size, hop, plan.n_frames, plan.stretch_len)
    y = y[:, : plan.stretch_len] / wsum[None, :]
    src_rel = _positions_rel_device(*plan.anc_args, plan.n_out_pad, sr)
    out = _lerp_resample_rel_xla_b(
        y, src_rel, jnp.asarray(plan.base), plan.stretch_len, BLK,
    )
    return np.asarray(out[:C, : plan.n_out])
