"""Persistent XLA compilation cache + standard-bucket warm-up.

The reference pays its plan cost once at startup — FFTW_MEASURE builds the
32768-pt plan when the file opens (/root/reference/spec.cpp:15) — and every
later column reuses it.  The device analogue of that plan is the XLA
executable, and without a persistent cache every *process* re-pays the
compile of every program shape.  Two pieces fix that:

* ``enable()`` points JAX's compilation cache at a durable directory before
  the first compile, so executables persist across processes and repeat
  invocations deserialize instead of recompiling.  The directory is
  ``JAX_COMPILATION_CACHE_DIR`` when that is set (the package then names no
  other), else the fixed ``.jax_cache/`` at the root of the checkout.
* ``warmup_session(n, rate)`` compiles the standard shape buckets a session
  of ``n`` samples will need (spectrogram column batches, granular render,
  PV chunks) — run it in the background at file-open and the first
  play/zoom hits warm executables, exactly like the reference's
  plan-at-open contract.

``enable()`` is called from ``melonix_tpu/__init__`` at import time; set
``MELONIX_XLA_CACHE=0`` to opt out (e.g. hermetic tests).
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_enabled_dir: str | None = None
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def default_cache_dir() -> str:
    """The fixed in-checkout cache directory (listed in .gitignore).  A
    path that never moves is part of every cache key that can hit."""
    return os.path.join(_REPO_ROOT, ".jax_cache")


def _cpu_only() -> bool:
    """Is this session pinned to the CPU platform alone?"""
    try:
        import jax

        platforms = jax.config.jax_platforms or os.environ.get(
            "JAX_PLATFORMS", ""
        )
    except Exception:
        platforms = os.environ.get("JAX_PLATFORMS", "")
    return (platforms or "").strip().lower() == "cpu"


def enable(cache_dir: str | None = None) -> str | None:
    """Point JAX's persistent compilation cache at a durable directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins over everything, ``cache_dir`` next,
    then ``default_cache_dir()``.  Returns the cache directory, or None when
    disabled via ``MELONIX_XLA_CACHE=0``, on an implicit CPU-only session,
    or when the directory cannot be created.  Idempotent; must run before
    the first compile to benefit that compile.
    """
    global _enabled_dir
    with _lock:
        if _enabled_dir is not None:
            return _enabled_dir
        if os.environ.get("MELONIX_XLA_CACHE", "1") == "0":
            return None
        env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
        # CPU-only sessions (the test suite, the virtual-mesh dryrun) skip
        # the persistent cache unless a directory is named explicitly:
        # CPU compiles are cheap, and XLA:CPU AOT results carry host
        # machine features — an executable cached on one machine can
        # SIGILL on another.
        if cache_dir is None and not env_dir and _cpu_only():
            return None
        d = env_dir or cache_dir or default_cache_dir()
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            return None
        import jax

        # Location metadata must not leak the CALLER into the cache key:
        # lowered modules embed the full stack trace of the tracing call,
        # so the same program traced from the UI open path, the bench and
        # a script would hash to different persistent-cache keys and each
        # entry point would compile it again.  Innermost-frame-only
        # locations (the jitted function's own file) are identical from
        # every caller, so one compile serves them all.
        jax.config.update("jax_include_full_tracebacks_in_locations", False)
        jax.config.update("jax_compilation_cache_dir", d)
        # Cache everything: a fresh process (every CLI call, every bench
        # run) starts with no compiled code, and the default 1 s / 4 KiB
        # floors would skip most of the session's small programs.
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        # With the floors at 0 every shape bucket lands on disk, so the
        # package's own directory would grow without bound across sessions
        # (ADVICE r3 #2): prune it LRU by atime/mtime to a size cap.  A
        # directory named by JAX_COMPILATION_CACHE_DIR belongs to whoever
        # named it and is left alone.
        if not env_dir:
            _prune_cache_dir(d)
        _enabled_dir = d
        return d


def _prune_cache_dir(d: str, max_bytes: int | None = None) -> int:
    """Best-effort LRU prune of the persistent cache directory.

    Deletes the least-recently-used entries (max(atime, mtime) — atime
    tracks cache HITS where the filesystem records it) until the directory
    is under ``max_bytes`` (``MELONIX_XLA_CACHE_MAX_MB``, default 2048).
    Returns the number of files removed.  Never raises.
    """
    if max_bytes is None:
        try:
            max_bytes = int(
                float(os.environ.get("MELONIX_XLA_CACHE_MAX_MB", "2048"))
                * 1e6
            )
        except ValueError:
            max_bytes = 2_048_000_000
    removed = 0
    try:
        entries = []
        total = 0
        for root, _dirs, files in os.walk(d):
            for f in files:
                p = os.path.join(root, f)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((max(st.st_atime, st.st_mtime), st.st_size, p))
                total += st.st_size
        if total <= max_bytes:
            return 0
        entries.sort()  # oldest first
        for _t, size, p in entries:
            if total <= max_bytes:
                break
            try:
                os.remove(p)
                total -= size
                removed += 1
            except OSError:
                continue
    except Exception:  # pragma: no cover - pruning must never break enable
        pass
    return removed


def warmup_session(
    n_samples: int,
    rate: int,
    *,
    engines: tuple[str, ...] = ("granular", "pv"),
    columns: bool = True,
    pitch: bool = False,
) -> None:
    """Compile the shape buckets a session over ``n_samples`` will use.

    Renders a silent track of the session's length through the requested
    paths.  Every path buckets its jitted shapes (render.py:306,
    phase_vocoder.py:676,753), so a same-length silent track compiles the
    exact executables later edits reuse; with ``enable()`` the work also
    lands in the persistent cache for future processes.

    Pure compute warm-up — no files, no UI state.  Raises nothing: warm-up
    is best-effort by contract (a failure just means the first real render
    pays the compile, as before).
    """
    import numpy as np

    try:
        zeros = np.zeros(max(int(n_samples), 2048), np.float32)
        from ..engine.maps import MapKnots
        from ..markers import Marker

        # One marker mid-track: compiles the same bucketed shapes as the
        # no-marker case (knots pad to 128, maps.py:201) while also touching
        # the bend/warp paths an edit session always uses.
        markers = [Marker(len(zeros) // 2, 57.0, 0.0, 1.0)]
        knots = MapKnots.from_markers(markers, rate, len(zeros))

        if "granular" in engines:
            from ..engine.grains import build_grain_table
            from ..engine.render import render_track

            render_track(zeros, build_grain_table(zeros), knots)
        if "pv" in engines:
            from ..engine.phase_vocoder import render_track_pv

            render_track_pv(zeros, knots)
            # The LIVE stream path jits its own entry points
            # (pv_stream._advance_read/_advance_chunk/_read_quantum/
            # _wsum_stream).  Shapes are bucketed, but an EDIT restart
            # differs from the t=0 stream in two STATIC dimensions: the
            # download bucket out_n and _advance_read's tail flag (True
            # once the restart chunk is the track's last).  Warm every
            # read size the Player actually issues — an unwarmed bucket
            # turns the first marker drag into a compile (PV_LIVE_AHEAD is
            # imported below so the warm set tracks the refill policy).
            from ..engine.player import PV_FIRST_READ, PV_LIVE_AHEAD
            from ..engine.pv_stream import PvStream

            stream = PvStream(zeros, knots)
            stream.read(2048)
            dur = len(zeros) / rate
            # Every read size of the player's refill policy (first read,
            # burst, minimum), so no live refill meets a cold executable.
            sizes = (2048, 4096, PV_FIRST_READ, PV_LIVE_AHEAD)
            for t0 in (0.25 * dur, max(0.0, dur - 0.2)):
                for n_read in sizes:
                    s = PvStream(zeros, knots, start_sec=t0)
                    s.read(n_read)
        if columns:
            from ..engine.spectral import spectrogram_columns

            end = np.asarray([len(zeros)], np.int64)
            np.asarray(spectrogram_columns(zeros, end - 1024, end))
        if pitch:
            from ..engine.pitch import pitch_curve

            pitch_curve(zeros, rate)
    except Exception:  # pragma: no cover - warm-up must never take the app down
        pass


def warmup_session_async(n_samples: int, rate: int, **kw) -> threading.Thread:
    """``warmup_session`` on a daemon thread (the file-open hook)."""
    t = threading.Thread(
        target=warmup_session, args=(n_samples, rate), kwargs=kw, daemon=True,
        name="melonix-warmup",
    )
    t.start()
    return t
