"""Spectrogram tile server — the SpecCache/Spec replacement.

Reference architecture (spec.cpp:18-42, spec-cache.cpp:10-50): per-column
LRU caches keyed by pixel-column index; a miss enqueues a job for a worker
thread and returns a placeholder (black, stays dirty, repolled every frame)
until the spectrum arrives.  That *black-until-ready contract is
load-bearing for UI responsiveness* (SURVEY.md §5) and is preserved here.

Device inversion: instead of one FFTW call per column on a CPU thread, the
worker drains the whole request queue each cycle and computes every pending
column in ONE batched device program (gather + decay + batched FFT +
magnitude, engine/spectral.spectrogram_columns_device).  The host keeps an
LRU of downloaded RGB tiles (capacity ``max_ranges`` = 4000, range.hpp:4).

**Log-frequency texel grid.** The reference uploads one 16384-texel
linear-frequency texture per column and lets GL_NEAREST pick one bin per
pixel row (spec-cache.cpp:99-107).  Downloading 16384 texels per tile is
pure host<->device waste: the display is log-frequency (semitone rows), so
linear bins are ~100x oversampled at the top of the range.  Tiles here are
``tile_texels`` (default 2048) *log-spaced* texels covering the fraction
range [tile_frac_min, 1] of Nyquist — >= 14 texels per semitone everywhere,
display-lossless, and ~10x fewer bytes per tile.  Each texel takes the MAX
of the DFT bins in its band (anti-aliased where the reference's NEAREST
sampling aliases) and falls back to its nearest bin where bins are sparser
than texels (low frequencies).  The resample + colormap run on device; the
host receives final uint8 RGB texels.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from functools import lru_cache
from typing import Callable

import numpy as np

from ..config import DEFAULT_CONFIG, Config
from ..ui.colormap import colormap_lut


# ----------------------------------------------------------------------
# Log-frequency texel grid
# ----------------------------------------------------------------------


def texel_of_frac(frac, texels: int, frac_min: float):
    """Texel index for a frequency expressed as a fraction of Nyquist."""
    f = np.maximum(np.asarray(frac, np.float64), frac_min)
    j = (np.log(f) - np.log(frac_min)) / (-np.log(frac_min)) * (texels - 1)
    return np.clip(np.rint(j).astype(np.int64), 0, texels - 1)


@lru_cache(maxsize=8)
def _resample_tables(n_bins: int, texels: int, frac_min: float):
    """(bin -> texel segment ids, texel -> nearest bin) for the log grid.

    Bins below frac_min (DC and the first few) get segment id ``texels``
    and are dropped; texels whose band holds no bin (low frequencies,
    where bins are sparser than texels) fall back to their nearest bin.
    """
    k = np.arange(n_bins, dtype=np.float64)
    frac = k / n_bins  # bin k center as a fraction of Nyquist
    ids = texel_of_frac(frac, texels, frac_min)
    ids[frac < frac_min] = texels
    j = np.arange(texels, dtype=np.float64)
    frac_j = np.exp(np.log(frac_min) * (1.0 - j / (texels - 1)))
    nearest = np.clip(np.rint(frac_j * n_bins).astype(np.int64), 0, n_bins - 1)
    return ids.astype(np.int32), nearest.astype(np.int32)


def log_resample_np(mags: np.ndarray, texels: int, frac_min: float) -> np.ndarray:
    """NumPy twin of the device resample: (B, n_bins) -> (B, texels)."""
    mags = np.asarray(mags, np.float32)
    ids, nearest = _resample_tables(mags.shape[-1], texels, frac_min)
    pooled = np.zeros((mags.shape[0], texels), np.float32)
    np.maximum.at(pooled, (slice(None), ids[ids < texels]), mags[:, ids < texels])
    return np.maximum(pooled, mags[:, nearest])


class LruCache:
    """Recency cache with the reference's capacity/eviction behavior
    (insert-then-evict-oldest above capacity, spec.cpp:33-40)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()

    def get(self, key):
        if key not in self._d:
            return None
        self._d.move_to_end(key, last=False)  # front = most recent
        return self._d[key]

    def put(self, key, value) -> bool:
        """Insert; returns True when the insert evicted an older entry
        (content for the evicted key reverts to the black placeholder —
        damage the tile server must report to incremental renderers)."""
        self._d[key] = value
        self._d.move_to_end(key, last=False)
        evicted = False
        while len(self._d) > self.capacity:
            self._d.popitem(last=True)
            evicted = True
        return evicted

    def __contains__(self, key):
        return key in self._d

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()


def _tiles_program(wav_dev, starts, ends, kgain, ids, nearest, *,
                   size: int, texels: int):
    """The device tile program, MODULE-LEVEL so jax's jit cache is shared
    across TileServer instances: as a per-instance closure, every file
    open re-traced it and could not reuse the session's loaded
    executable."""
    import jax
    import jax.numpy as jnp

    from ..engine.spectral import spectrogram_columns_device

    mags = spectrogram_columns_device(wav_dev, starts, ends, size=size)
    # Log-texel resample (max-pool + nearest fill) + colormap on
    # device; only final uint8 texels cross to the host.
    # NOTE: ids are NOT sorted (dropped bins get id == texels at the
    # front), so no indices_are_sorted hint — it would be UB.
    pooled = jax.vmap(
        lambda m: jax.ops.segment_max(m, ids, num_segments=texels + 1)[:texels]
    )(mags)
    tex = jnp.maximum(pooled, mags[:, nearest])
    # VALUE plane, not RGB: v quantizes to uint8 on device and the
    # host colormaps through a 256-entry LUT — 3x fewer bytes over
    # the device->host link (the burst path is transfer-bound).
    return jnp.round(jnp.clip(tex * kgain, 0.0, 255.0)).astype(jnp.uint8)


_CHUNK = 256  # static device batch width (pad + loop; one executable ever)


def _len_bucket(n: int) -> int:
    """Geometric track-length buckets ({2^k, 3·2^(k-1)}, ×~1.33 steps).

    The tile program's only per-track shape is the wav operand; padding the
    device copy to a bucket makes ONE compiled executable serve every track
    in that bucket.  Without it a never-seen track length recompiles the
    column program in front of the user's first view (and the open-time PV
    warm-up chain queues behind the same compile lock).  Zero-padding is
    semantically free: the column program reads OOB samples as zeros
    already (spec.cpp:50-54 semantics; the padded tail is in-bounds zeros
    × decay = the same zeros)."""
    n = max(int(n), 1024)
    b = 1 << (n - 1).bit_length()  # next power of two
    three_q = 3 * (b // 4)
    return three_q if three_q >= n else b


_pad_to_bucket_jit = None


def _pad_to_bucket(wav_dev, nb: int):
    """Zero-pad on DEVICE (tiny DUS program): uploading host-padded bytes
    would add up to a third of the track to the host->device transfer for
    content that is identically zero."""
    global _pad_to_bucket_jit
    if _pad_to_bucket_jit is None:
        import jax
        import jax.numpy as jnp

        def _pad(w, nb):
            out = jnp.zeros((nb,), jnp.float32)
            return jax.lax.dynamic_update_slice(out, w.astype(jnp.float32), (0,))

        _pad_to_bucket_jit = jax.jit(_pad, static_argnames=("nb",))
    return _pad_to_bucket_jit(wav_dev, nb=nb)


_tiles_program_jit = None


def _get_tiles_program():
    global _tiles_program_jit
    if _tiles_program_jit is None:
        import jax

        _tiles_program_jit = jax.jit(
            _tiles_program,
            static_argnames=("size", "texels"),
        )
    return _tiles_program_jit


class TileServer:
    """Async batched spectrogram tiles with the black-until-ready contract.

    ``get_tile(key, start_sample, end_sample)`` returns a
    (config.tile_texels, 3) uint8 RGB log-frequency tile, or None while
    pending (caller draws black and re-requests next frame,
    spec-cache.cpp:67-71).  All requests accumulated between worker cycles
    are computed in one batched device call.
    """

    PLACEHOLDER_BINS = 16  # black placeholder texel count (spec-cache.cpp:70)

    def __init__(
        self,
        wav: np.ndarray,
        *,
        k: float,
        config: Config = DEFAULT_CONFIG,
        compute: Callable | None = None,
        poll_interval: float = 0.002,
        synchronous: bool = False,
    ):
        import jax
        import jax.numpy as jnp

        self._cfg = config
        self._k = float(k)
        wav_np = np.asarray(wav, np.float32)
        self._wav_dev = _pad_to_bucket(
            jnp.asarray(wav_np), _len_bucket(len(wav_np))
        )
        n_bins = config.spectr_size // 2
        texels, frac_min = config.tile_texels, config.tile_frac_min
        ids_np, nearest_np = _resample_tables(n_bins, texels, frac_min)
        # Device-resident resample tables: re-uploading them with every
        # drain was a per-drain transfer for constant data.
        ids_dev = jnp.asarray(ids_np)
        nearest_dev = jnp.asarray(nearest_np)
        statics = dict(size=config.spectr_size, texels=texels)
        lut = colormap_lut()

        def _rgb_device(starts, ends, kgain, n_keep):
            v = _get_tiles_program()(
                self._wav_dev,
                jnp.asarray(starts, jnp.int32),
                jnp.asarray(ends, jnp.int32),
                jnp.float32(kgain),
                ids_dev, nearest_dev, **statics,
            )
            # Download only the rows actually requested, bucketed to 32 so
            # the slice shapes stay from a tiny fixed set (the batch pads
            # to CHUNK for ONE compute executable; downloading the padding
            # was 2.5x the bytes for a typical 100-column burst).
            n_dl = min(32 * -(-int(n_keep) // 32), v.shape[0])
            return lut[np.asarray(v[:n_dl])]

        if compute is not None:
            self._rgb = lambda s, e, kg, n_keep=None: lut[
                np.uint8(
                    np.round(
                        np.clip(
                            log_resample_np(compute(s, e), texels, frac_min)
                            * np.float32(kg),
                            0.0,
                            255.0,
                        )
                    )
                )
            ]
        else:
            self._rgb = _rgb_device
        self._cache = LruCache(config.max_ranges)
        self._pending: dict = {}
        # Keys whose batch is currently computing on device.  Re-polls of a
        # black tile land here instead of _pending: without this, every
        # poll during a ~50 ms drain re-enqueued the whole burst and the
        # worker paid a SECOND full device round trip recomputing tiles the
        # first drain had already delivered.
        self._inflight: set = set()
        # Monotonic content version: bumped whenever cached tile CONTENT can
        # change (a drain landed, brightness rebuilt, cache cleared).  Lets
        # the scene renderer memoize its assembled tile block between drains.
        self.epoch = 0
        # Staleness generation: bumped by clear()/set_brightness_k().  A
        # drain captures it at batch time and skips cache.put on mismatch —
        # without this, a clear() during an in-flight drain (the marker-edit
        # invalidate path, where the same key maps to NEW sample ranges) let
        # the stale batch land and stay forever as cache hits.
        self._gen = 0
        # Damage log: (epoch-after, keys-landed) per drain, so the scene
        # renderer can refresh ONLY the columns a drain touched instead of
        # recomposing the lane on every epoch bump (during a pan the margin
        # prefetch lands a drain almost every frame, which was invalidating
        # the whole incremental-pan memo — ui_fps_pan 21 < the 30 target).
        # Cleared by clear()/set_brightness_k(): content changed wholesale,
        # keys_landed_since then reports "unknown" and callers recompose.
        self._landed_log: deque = deque(maxlen=256)
        self._busy_since: float | None = None  # device batch in flight
        self._lock = threading.Lock()
        self._poll = poll_interval
        self._synchronous = synchronous
        self._running = not synchronous
        self._thread = None
        self._warm_thread = None
        if not synchronous:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        if (compute is None and not synchronous
                and jax.default_backend() != "cpu"):
            # Accelerator only: a CPU session (tests) compiles cheaply at
            # first use, and blocking every open on a local 256-column
            # compute only starves the suite.
            #
            # Plan-at-open (the reference BLOCKS at file open to build its
            # FFTW plan, spec.cpp:15 FFTW_MEASURE): trace + dispatch one
            # dummy CHUNK-shaped batch through the real tile program NOW
            # and wait (bounded) for it — the compile (or compile-cache
            # load) and first execution happen once at open instead of in
            # front of the user's first visible burst.  The wait is capped
            # (MELONIX_TILE_WARM_S, default 5 s) so a slow compile degrades
            # to the async behavior — black tiles until the program is
            # ready — instead of hanging open_file.
            try:
                import os

                n = int(self._wav_dev.shape[0])
                ends = np.full(_CHUNK, min(1024, max(n, 1)), np.int64)
                warm = _get_tiles_program()(
                    self._wav_dev,
                    jnp.zeros(_CHUNK, jnp.int32),
                    jnp.asarray(ends, jnp.int32),
                    jnp.float32(self._k), ids_dev, nearest_dev, **statics,
                )
                timeout = float(os.environ.get("MELONIX_TILE_WARM_S", "5"))
                if timeout > 0:
                    done = threading.Event()

                    def _await_warm():
                        try:
                            np.asarray(warm[:1, :1])  # tiny anchor download
                        except Exception:
                            pass
                        done.set()

                    self._warm_thread = threading.Thread(
                        target=_await_warm, daemon=True, name="tile-warm")
                    self._warm_thread.start()
                    done.wait(timeout)
            except Exception:  # pragma: no cover - warm-up is best-effort
                pass

    # -- public API ----------------------------------------------------

    def get_tile(self, key: int, start_sample: int, end_sample: int):
        """LRU lookup; miss → enqueue + None (black until ready)."""
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
            if key not in self._inflight:
                self._pending[key] = (int(start_sample), int(end_sample))
        if self._synchronous:
            self._drain_once()
            with self._lock:
                return self._cache.get(key)
        return None

    def get_tiles(self, requests) -> list:
        """Batched ``get_tile`` over (key, start, end) triples under ONE lock
        acquisition (a 1280-column frame would otherwise take 1280)."""
        out = []
        miss = False
        with self._lock:
            for key, s, e in requests:
                hit = self._cache.get(key)
                if hit is None:
                    if key not in self._inflight:
                        self._pending[key] = (int(s), int(e))
                    miss = True
                out.append(hit)
        if self._synchronous and miss:
            self._drain_once()
            with self._lock:
                out = [self._cache.get(r[0]) for r in requests]
        return out

    def prefetch(self, requests) -> None:
        """Enqueue many (key, start, end) at once so the worker computes the
        whole viewport in ONE batched device call (one frame = one dispatch,
        not one per column)."""
        with self._lock:
            missing = [
                r for r in requests
                if r[0] not in self._cache and r[0] not in self._inflight
            ]
            for key, s, e in missing:
                self._pending[key] = (int(s), int(e))
        if self._synchronous and missing:
            self._drain_once()

    def set_brightness_k(self, k: float) -> None:
        """Brightness changes rebuild tiles (app.cpp:76-80 drops SpecCache);
        magnitudes aren't cached host-side, so recolor = recompute."""
        with self._lock:
            self._k = float(k)
            self._cache.clear()
            self._landed_log.clear()  # wholesale change: damage unknown
            self._gen += 1
            self.epoch += 1

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._pending.clear()
            # Drop in-flight suppression too: keys being computed under the
            # OLD ranges must be re-requestable with their new ranges now,
            # not after the stale drain lands (and its puts are gen-skipped).
            self._inflight = set()
            self._landed_log.clear()  # wholesale change: damage unknown
            self._gen += 1
            self.epoch += 1

    def keys_landed_since(self, epoch0: int) -> frozenset | None:
        """Union of tile keys whose cached content changed after ``epoch0``
        (damage tracking for the scene renderer's incremental-pan memo).
        Returns None when the damage is unknown — epoch0 predates the log,
        or a clear()/brightness change invalidated everything — in which
        case the caller must recompose in full."""
        with self._lock:
            if epoch0 == self.epoch:
                return frozenset()
            log = list(self._landed_log)
        if not log or log[0][0] > epoch0 + 1:
            return None  # log truncated/cleared below epoch0: unknown
        out: set = set()
        for ep, keys, evicted in log:
            if ep > epoch0:
                if evicted:
                    # An LRU eviction reverted unknown keys to the black
                    # placeholder — the damage set can't be named.
                    return None
                out |= keys
        return frozenset(out)

    def stats(self) -> dict:
        with self._lock:
            busy = self._busy_since
            return {
                "cached": len(self._cache),
                "pending": len(self._pending),
                # Keys handed to the device batch currently in flight:
                # "pending == 0" alone does NOT mean the view is settled —
                # a drain moves keys from pending to inflight before the
                # batch lands (a settle poll must wait for both to be 0).
                "inflight": len(self._inflight),
                # How long the current device batch has been in flight —
                # the UI's only signal while a slow batch (e.g. a first
                # compile) keeps tiles black.
                "busy_s": 0.0 if busy is None else round(time.monotonic() - busy, 1),
            }

    def close(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._warm_thread is not None:
            self._warm_thread.join()  # ends when the warm batch lands

    # -- worker --------------------------------------------------------

    def _drain_once(self) -> bool:
        with self._lock:
            if not self._pending:
                return False
            batch = list(self._pending.items())
            self._pending.clear()
            self._inflight = {b[0] for b in batch}
            k = self._k
            gen = self._gen
            self._busy_since = time.monotonic()
        try:
            return self._drain_batch(batch, k, gen)
        finally:
            with self._lock:
                self._busy_since = None
                # Only this batch's keys: a clear() mid-flight already reset
                # _inflight, and newly re-requested keys must stay pending.
                self._inflight -= {b[0] for b in batch}

    def _drain_batch(self, batch, k, gen) -> bool:
        keys = [b[0] for b in batch]
        starts = np.asarray([b[1][0] for b in batch], np.int64)
        ends = np.asarray([b[1][1] for b in batch], np.int64)
        # One STATIC batch shape: pad to a multiple of _CHUNK and loop — the
        # device program compiles once ever, whatever the viewport does.
        n_req = len(keys)
        from ..utils import RateMeter, Timer, registry

        with registry("tiles.drain", Timer):
            outs = []
            for off in range(0, n_req, _CHUNK):
                s = starts[off : off + _CHUNK]
                e = ends[off : off + _CHUNK]
                n_this = len(s)
                if n_this < _CHUNK:
                    pad = _CHUNK - n_this
                    s = np.concatenate([s, np.repeat(s[-1:], pad)])
                    e = np.concatenate([e, np.repeat(e[-1:], pad)])
                outs.append(self._rgb(s, e, k, n_this)[:n_this])
            rgb = np.concatenate(outs)[:n_req]
        registry("tiles.computed").inc(n_req)
        registry("tiles.rate", RateMeter).tick(n_req)
        with self._lock:
            # A mid-flight clear()/brightness change bumped _gen: this
            # batch's content is stale (possibly computed from pre-edit
            # sample ranges) — drop it instead of caching it forever.
            landed = frozenset()
            evicted = False
            if self._gen == gen:
                for i, key in enumerate(keys):
                    evicted |= self._cache.put(key, rgb[i])
                landed = frozenset(keys)
            self.epoch += 1
            # Evictions revert arbitrary keys to black-until-ready; the log
            # can't name them (popitem order is recency, not key), so the
            # entry is marked and keys_landed_since reports "unknown".
            self._landed_log.append((self.epoch, landed, evicted))
        return True

    def _run(self) -> None:
        while self._running:
            try:
                busy = self._drain_once()
            except Exception:  # fail-soft: a bad batch must not kill the worker
                import sys
                import traceback

                from ..utils import registry

                traceback.print_exc(file=sys.stderr)
                registry("tiles.worker_errors").inc(1)
                busy = False
            if not busy:
                time.sleep(self._poll)
