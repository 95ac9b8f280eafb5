"""Streaming phase-vocoder renderer — the quality engine, live.

The reference's defining loop is *hear the edit*: its audio callback pulls
from a backlog that ``process`` refills just ahead of the play cursor
(app.cpp:254-292), so a marker drag is audible within one buffer.  The
offline PV render (engine/phase_vocoder.py) already decomposes into
chunked stretches with exact phase carry plus a per-block resample — both
forward-only — which is precisely a stream.  This module turns that
decomposition into a pull API the Player can sit on:

* the **stretch** advances chunk-by-chunk (small frame buckets, one
  compiled shape) into a device-resident stretched buffer, finalized
  (OLA-normalized) up to the last fully-covered sample;
* the **resample** reads fixed output quanta through the same
  block-relative position machinery, downloading only the samples that
  are actually delivered to the audio consumer;
* an **edit or seek restarts** the stream at the current cursor: frames
  strictly before the splice's coverage window are skipped (every frame
  touching the first emitted sample IS rendered, so amplitude at the
  splice is exact) and phase re-anchors at the first rendered frame —
  the standard real-time PV edit response; the Player's declick ramp
  covers the phase seam.

Everything device-side reuses the jitted offline functions
(`_stretch_chunk`, `_ola_wsum`, `_positions_rel_device`,
`_lerp_resample_rel_xla`), so a stream from t=0 is the chunked offline
render (test_pv_stream: rms-equal per the PV comparison convention) and
the persistent compile cache warms both paths at once.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, Config
from .maps import MapKnots
from .spectral import hann_window
from . import phase_vocoder as pv

STREAM_CHUNK_FRAMES = 2048  # ~24 s of stretched audio per device call
READ_BLOCKS = 2  # resample quantum = READ_BLOCKS * BLK output samples
OUT_BUCKET = 1 << 20  # resample-shape bucket (~24 s of output samples)


def _bucket(n: int, b: int) -> int:
    return b * -(-int(n) // b)


@partial(jax.jit, static_argnames=("size", "hop", "out_len"))
def _wsum_stream(window, n_frames, stretch_len, size: int, hop: int,
                 out_len: int):
    """Window-square OLA normalizer at a BUCKETED static length.

    Shape-stable twin of phase_vocoder._ola_wsum: the frame count and the
    real stretched length arrive as traced scalars, so every edit of a
    session reuses ONE executable (the eager builder re-dispatches
    shape-keyed ops whenever an edit moves ``n_frames`` — each a fresh
    compile on the interactive path).  Requires size % hop == 0
    (the standard 2048/512 stream config; callers fall back otherwise).
    Beyond ``stretch_len`` the value is 1.0 (the buffer is zero there, so
    normalized pad reads stay zero).
    """
    k = size // hop
    w2 = window * window
    rows = w2.reshape(k, hop)
    pat = jnp.sum(rows, axis=0)  # (hop,)
    ws = jnp.tile(pat, out_len // hop + 1)[:out_len]
    # Head: only window taps c' <= c are present (prefix sums).
    head = jnp.cumsum(rows, axis=0).reshape(size)
    ws = jax.lax.dynamic_update_slice(ws, head, (0,))
    # Tail at j0 = n_frames*hop (traced): taps c' > c only (suffix sums).
    tail = (jnp.cumsum(rows[::-1], axis=0)[::-1] - rows).reshape(size)
    ws = jax.lax.dynamic_update_slice(ws, tail, (n_frames * hop,))
    j = jnp.arange(out_len, dtype=jnp.int32)
    ws = jnp.where(j >= stretch_len, 1.0, ws)
    return jnp.maximum(ws, 1e-8)


@partial(jax.jit, static_argnames=("span",))
def _normalize_span(y, y_norm, wsum_pad, off, span: int):
    """y_norm[off:off+span] = y[off:off+span] / wsum_pad[...] (one compile)."""
    seg = jax.lax.dynamic_slice(y, (off,), (span,))
    ws = jax.lax.dynamic_slice(wsum_pad, (off,), (span,))
    return jax.lax.dynamic_update_slice(y_norm, seg / ws, (off,))


@partial(jax.jit, static_argnames=("size", "hop", "ch", "formant", "lock",
                                   "span"))
def _advance_chunk(wav, starts_c, da_c, rho_c, win, m0_local, f_real,
                   phi0, resid, phi_prev, y, y_norm, wsum_pad, acc_off,
                   norm_off, size, hop, ch, formant, lock, span):
    """One chunk advance as ONE device program: stretch + accumulate +
    finalize the newly-covered span.  The interactive restart path is
    dispatch-latency bound, so one program instead of three cuts the
    edit -> first-fresh-audio latency."""
    y_c, resid, phi_prev, phi0 = pv._stretch_chunk(
        wav, starts_c, da_c, rho_c, win, m0_local, f_real,
        phi0, resid, phi_prev, size, hop, ch, formant=formant, lock=lock,
    )
    y = pv._accum_at(y, y_c, acc_off)
    seg = jax.lax.dynamic_slice(y, (norm_off,), (span,))
    ws = jax.lax.dynamic_slice(wsum_pad, (norm_off,), (span,))
    y_norm = jax.lax.dynamic_update_slice(y_norm, seg / ws, (norm_off,))
    return y, y_norm, resid, phi_prev, phi0


@partial(jax.jit, static_argnames=("q", "blk", "stretch_len", "out_n"))
def _read_quantum(y_norm, src_rel, base, b0, lo, q: int, blk: int,
                  stretch_len: int, out_n: int):
    """Resample output samples [b0*blk, b0*blk + q) from the stretched
    buffer and return only ``[lo, lo + out_n)`` of them — only the
    consumer's actual window leaves the device, not the whole quantum."""
    sr_seg = jax.lax.dynamic_slice(src_rel, (b0 * blk,), (q,))
    b_seg = jax.lax.dynamic_slice(base, (b0,), (q // blk,))
    res = pv._lerp_resample_rel_xla(y_norm, sr_seg, b_seg, stretch_len, blk)
    return jax.lax.dynamic_slice(res, (lo,), (out_n,))


@partial(jax.jit, static_argnames=("size", "hop", "ch", "formant", "lock",
                                   "span", "q", "blk", "out_n", "tail"))
def _advance_read(wav, starts_c, da_c, rho_c, win, m0_local, f_real,
                  phi0, resid, phi_prev, y, y_norm, wsum_pad, acc_off,
                  norm_off, src_rel, base, b0, lo, size, hop, ch,
                  formant, lock, span, q, blk, out_n, tail):
    """The interactive restart as ONE device program: the last pending
    chunk's stretch + accumulate + finalize, then the resample read of the
    requested window.  An edit restart would otherwise be two blocking
    dispatches (advance, then read+download); fusing them leaves one
    dispatch whose only download is the consumer's actual audio window
    (reference budget: one ~23 ms audio buffer, app.cpp:243-249).

    ``tail=True`` compiles the final-chunk variant: it also normalizes the
    one extra span that covers the OLA overhang (size - hop stretched
    samples past the last frame — at most one span, see _post_chunk), so
    track-end restarts fuse too."""
    y, y_norm, resid, phi_prev, phi0 = _advance_chunk(
        wav, starts_c, da_c, rho_c, win, m0_local, f_real, phi0, resid,
        phi_prev, y, y_norm, wsum_pad, acc_off, norm_off, size, hop, ch,
        formant, lock, span,
    )
    if tail:
        y_norm = _normalize_span(y, y_norm, wsum_pad, norm_off + span, span)
    buf_len = y_norm.shape[0]
    out = _read_quantum(y_norm, src_rel, base, b0, lo, q, blk, buf_len, out_n)
    return y, y_norm, resid, phi_prev, phi0, out


class PvStream:
    """Forward-only PV sample stream from ``start_sec``.

    ``read(n)`` returns the next n float32 samples (zeros past the warped
    end; ``exhausted`` flips once the real samples are all delivered).
    Immutable edit model: on a marker edit the owner drops the stream and
    builds a fresh one at the current cursor.
    """

    def __init__(
        self,
        wav,
        knots: MapKnots,
        *,
        config: Config = DEFAULT_CONFIG,
        size: int | None = None,
        hop: int | None = None,
        preserve_formants: bool = False,
        phase_locking: bool = False,
        start_sec: float = 0.0,
        chunk_frames: int = STREAM_CHUNK_FRAMES,
    ):
        self._blk = pv.BLK
        self._q = READ_BLOCKS * self._blk
        if isinstance(wav, jax.Array):  # resident: skip the re-upload
            wav_dev, n_wav = wav.astype(jnp.float32), int(wav.shape[0])
        else:
            wav = np.asarray(wav, np.float32)
            wav_dev, n_wav = None, len(wav)  # upload only if plan exists
        self.sample_rate = int(knots.sample_rate)
        self.plan = pv.build_pv_plan(knots, n_wav, config=config, size=size, hop=hop)
        self.preserve_formants = preserve_formants
        self.phase_locking = bool(phase_locking)
        self._buf = np.zeros(0, np.float32)
        if self.plan is None:
            self.n_out = 0
            self._j = 0
            return
        plan = self.plan
        self.n_out = plan.n_out
        sr = plan.sr

        # Host float64 position curve for the emit gate (which frames must
        # be stretched before an output sample is final).
        self._table = pv._segment_table(knots, plan.n_out / sr)

        j_start = int(np.clip(round(start_sec * sr), 0, max(plan.n_out - 1, 0)))
        self._j = j_start
        self._bq = (j_start // self._blk)  # next resample quantum (block idx)

        # Restart frame: every frame covering the first emitted stretched
        # position is included, so the splice has full OLA coverage
        # ((m_start-1)*hop + size <= src(j_start) by construction).
        src0 = float(pv._src_eval64(self._table, np.asarray([(j_start + 1.0) / sr]), sr)[0][0])
        size_, hop_ = plan.size, plan.hop
        self._m_start = max(0, int((src0 - size_) // hop_) + 1) if j_start else 0
        self._frames_done = self._m_start  # global frames stretched so far

        # Shape stability across edits (the interactive frontier): every
        # jitted shape below is either fixed or bucketed coarsely, so a
        # marker drag reuses the executables the previous stream compiled
        # (an unbucketed restart recompiles on every edit).  ch is ALWAYS
        # chunk_frames (padded frames are masked by f_real); the stretch
        # buffer rounds up to whole chunks;
        # the resample shapes round up to OUT_BUCKET samples.
        self._ch = int(chunk_frames)
        n_state = size_ // 2 + 1
        self._win = jnp.asarray(hann_window(size_))
        # Headroom: size from the TRACK (2x stretch covers bends to +12
        # semitones), not the edit's exact stretch — so the identity
        # warm-up stream and every ordinary edit share one buffer bucket
        # (an exact-stretch bucket made the FIRST pitch edit recompile).
        # Extreme edits fall into a larger bucket once.
        slack = self._ch * hop_ + size_
        buf_len = _bucket(
            max(plan.stretch_len + slack, 2 * plan.n_wav + slack),
            self._ch * hop_,
        )
        self._buf_len = buf_len
        self._y = jnp.zeros(buf_len, jnp.float32)
        self._y_norm = jnp.zeros(buf_len, jnp.float32)
        if size_ % hop_ == 0 and plan.n_frames >= size_ // hop_:
            self._wsum_pad = _wsum_stream(
                self._win, jnp.int32(plan.n_frames),
                jnp.int32(plan.stretch_len), size_, hop_, buf_len,
            )
        else:  # non-standard geometry: eager builder + pad
            wsum = pv._ola_wsum(self._win, size_, hop_, plan.n_frames,
                                plan.stretch_len)
            self._wsum_pad = jnp.concatenate(
                [wsum, jnp.ones(buf_len - plan.stretch_len, jnp.float32)]
            )
        self._fin = self._m_start * hop_  # stretched samples finalized
        self._resid = jnp.zeros(n_state, jnp.float32)
        self._phi_prev = jnp.zeros(n_state, jnp.float32)
        self._phi0 = jnp.zeros(n_state, jnp.float32)
        self._wav_dev = jnp.asarray(wav) if wav_dev is None else wav_dev
        # One quantum of slack before bucketing: read() caps its batched
        # fetch at this length, and without slack a seek landing in the
        # final odd block would overrun (dynamic_slice clamps silently,
        # returning a shifted window).
        n_out_pad_b = _bucket(plan.n_out_pad + self._q, OUT_BUCKET)
        self._n_out_pad_b = n_out_pad_b
        self._src_rel = pv._positions_rel_device(*plan.anc_args, n_out_pad_b, sr)
        nb_b = n_out_pad_b // self._blk
        self._base_dev = jnp.asarray(
            np.pad(plan.base, (0, nb_b - len(plan.base)), mode="edge")
        )

    # -- stretch advance ---------------------------------------------------

    def _pending_chunks(self, s_hi: float) -> list[int]:
        """Global start frames of the chunks that must be stretched before
        stretched samples < s_hi are finalized (the _advance_to schedule)."""
        plan, hop = self.plan, self.plan.hop
        out, fd = [], self._frames_done
        while fd < plan.n_frames and fd * hop <= s_hi:
            out.append(fd)
            fd = min(fd + self._ch, plan.n_frames)
        return out

    def _chunk_dispatch_args(self, m0_g: int) -> tuple:
        """Argument tuple shared by _advance_chunk and _advance_read."""
        plan, hop = self.plan, self.plan.hop
        starts_c, da_c, rho_c, f_real = pv._chunk_arrays(plan, m0_g, self._ch)
        return (
            self._wav_dev, jnp.asarray(starts_c), jnp.asarray(da_c),
            jnp.asarray(rho_c), self._win,
            jnp.int32(m0_g - self._m_start), jnp.int32(f_real),
            self._phi0, self._resid, self._phi_prev,
            self._y, self._y_norm, self._wsum_pad,
            jnp.int32(m0_g * hop), jnp.int32(self._fin),
        )

    def _post_chunk(self, m0_g: int, tail_done: bool = False) -> None:
        """State bookkeeping after a chunk's dispatch, incl. the tail:
        finalize the remaining (size - hop) overhang (all frames have
        landed) with at most one extra span.  ``tail_done`` means the
        dispatch already normalized that extra span in-program
        (_advance_read's tail=True variant)."""
        plan, hop = self.plan, self.plan.hop
        span = self._ch * hop
        self._frames_done = min(m0_g + self._ch, plan.n_frames)
        self._fin += span
        if self._frames_done >= plan.n_frames:
            while not tail_done and self._fin < plan.stretch_len:
                self._y_norm = _normalize_span(
                    self._y, self._y_norm, self._wsum_pad,
                    jnp.int32(self._fin), span,
                )
                self._fin += span
            self._fin = plan.stretch_len

    def _advance_one(self, m0_g: int) -> None:
        """One chunk advance: stretch + accumulate + finalize the span
        [fin, fin + ch*hop) that this chunk fully covers, as ONE dispatch."""
        plan, hop = self.plan, self.plan.hop
        (self._y, self._y_norm, self._resid, self._phi_prev,
         self._phi0) = _advance_chunk(
            *self._chunk_dispatch_args(m0_g),
            plan.size, hop, self._ch,
            self.preserve_formants, self.phase_locking,
            self._ch * hop,
        )
        self._post_chunk(m0_g)

    def _advance_to(self, s_hi: float) -> None:
        """Stretch frames until stretched samples < s_hi are finalized."""
        for m0_g in self._pending_chunks(s_hi):
            self._advance_one(m0_g)

    # -- the pull API ------------------------------------------------------

    @property
    def exhausted(self) -> bool:
        return self.plan is None or (self._j >= self.n_out and len(self._buf) == 0)

    def read(self, n: int) -> np.ndarray:
        """Next n samples (float32); zeros past the warped duration."""
        out = np.zeros(n, np.float32)
        if self.plan is None:
            return out
        plan, sr = self.plan, self.plan.sr
        while len(self._buf) < n and self._j + len(self._buf) < self.n_out:
            # Cover the whole request in ONE resample dispatch: each
            # _read_quantum is a blocking dispatch + download, and an edit
            # restart lands mid-quantum, which used to force two.  Quantum
            # count buckets to powers of two
            # (a small executable set), capped at the padded curve end.
            q_start = self._bq * self._blk
            covered = max(self._j + len(self._buf) - q_start, 0)
            k = -(-(covered + n - len(self._buf)) // self._q)
            k = 1 << max(k - 1, 0).bit_length()
            cap = max((self._n_out_pad_b - q_start) // self._q, 1)
            if k > cap:  # stay a power of two: one executable per bucket
                k = 1 << (cap.bit_length() - 1)
            q_eff = k * self._q
            j_hi = min(q_start + q_eff, plan.n_out_pad) - 1
            # Gate: the lerp touches floor(src)+1; +2 covers the safety clip.
            s_hi = float(
                pv._src_eval64(self._table, np.asarray([(j_hi + 1.0) / sr]), sr)[0][0]
            ) + 2.0
            lo = max(self._j + len(self._buf) - q_start, 0)
            hi = min(q_eff, self.n_out - q_start)
            # Download bucket: smallest power of two covering the window
            # (floor 2048 keeps the executable set tiny); the slice start
            # backs off so the window never runs past the quantum.
            out_n = min(max(2048, 1 << (hi - lo - 1).bit_length()), q_eff)
            lo_c = min(lo, q_eff - out_n)
            pending = self._pending_chunks(s_hi)
            # Fuse the LAST pending chunk with the read: the edit-restart
            # hot path (one chunk covers any first read) then costs ONE
            # blocking round trip instead of two.  The track's final chunk
            # fuses through the tail=True variant, which folds its one
            # extra overhang-normalization span into the same program.
            if pending:
                for m0_g in pending[:-1]:
                    self._advance_one(m0_g)
                m0_g = pending[-1]
                # Fused tail only when ONE extra span covers the whole OLA
                # overhang (size - hop past the last frame); tiny chunks
                # (ch*hop < size - hop) fall back to _post_chunk's
                # multi-span loop — the fused variant would mark samples
                # finalized without normalizing them (ADVICE r4).
                tail = (m0_g + self._ch >= plan.n_frames
                        and self._ch * plan.hop >= plan.size - plan.hop)
                (self._y, self._y_norm, self._resid, self._phi_prev,
                 self._phi0, got) = _advance_read(
                    *self._chunk_dispatch_args(m0_g),
                    self._src_rel, self._base_dev,
                    jnp.int32(self._bq), jnp.int32(lo_c),
                    plan.size, plan.hop, self._ch,
                    self.preserve_formants, self.phase_locking,
                    self._ch * plan.hop, q_eff, self._blk, out_n, tail,
                )
                got = np.asarray(got)
                self._post_chunk(m0_g, tail_done=tail)
            else:
                got = np.asarray(
                    _read_quantum(
                        self._y_norm, self._src_rel, self._base_dev,
                        jnp.int32(self._bq), jnp.int32(lo_c), q_eff, self._blk,
                        self._buf_len, out_n,
                    )
                )
            self._buf = np.concatenate([self._buf, got[lo - lo_c : lo - lo_c + (hi - lo)]])
            self._bq += k * READ_BLOCKS
        take = min(n, len(self._buf))
        out[:take] = self._buf[:take]
        self._buf = self._buf[take:]
        self._j += take
        return out
