"""Persistent compilation cache + warm-up (VERDICT round 2, next #1).

The reference builds its FFTW plan once at startup (spec.cpp:15); the device
analogue is a durable XLA executable cache so fresh processes deserialize
instead of compiling again, plus a file-open warm-up of the standard shape
buckets.
"""

import numpy as np

from melonix_tpu.runtime import compile_cache as cc


def test_enable_sets_jax_config_and_is_idempotent(tmp_path, monkeypatch):
    import jax

    monkeypatch.setattr(cc, "_enabled_dir", None)
    d = cc.enable(str(tmp_path / "xla"))
    assert d == str(tmp_path / "xla")
    assert jax.config.jax_compilation_cache_dir == d
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    assert jax.config.jax_persistent_cache_min_entry_size_bytes == 0
    # Caller-independent cache keys: lowered modules embed the tracing
    # call's FULL stack, so with full tracebacks in locations the same
    # program traced from the UI, the bench, and a script would hash to
    # three different persistent-cache entries (each compiled again).
    # enable() must strip to innermost-frame locations.
    assert jax.config.jax_include_full_tracebacks_in_locations is False
    # Second call is a no-op returning the active directory.
    assert cc.enable(str(tmp_path / "other")) == d


def test_enable_env_dir_and_opt_out(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins over an explicit directory and the
    fixed default, even on a CPU session, and is never pruned."""
    import jax

    monkeypatch.setattr(cc, "_enabled_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "envdir"))
    pruned = []
    monkeypatch.setattr(cc, "_prune_cache_dir", lambda d: pruned.append(d))
    assert cc.enable(str(tmp_path / "explicit")) == str(tmp_path / "envdir")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "envdir")
    assert not (tmp_path / "explicit").exists() and pruned == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")

    monkeypatch.setattr(cc, "_enabled_dir", None)
    monkeypatch.setenv("MELONIX_XLA_CACHE", "0")
    assert cc.enable(str(tmp_path / "off")) is None


def test_cpu_platform_skips_implicit_cache(monkeypatch):
    """With no explicit directory, a CPU-platform session must NOT enable
    the persistent cache (XLA:CPU AOT results carry host machine features;
    a cache shared across machines can SIGILL).  The test suite runs on
    the forced-CPU conftest, so the package import hook itself exercises
    this path; an explicit dir still wins (tests above)."""
    monkeypatch.setattr(cc, "_enabled_dir", None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cc.enable() is None


def test_default_dir_is_fixed_inside_checkout(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR an accelerator session caches in
    one fixed, git-ignored directory at the root of the checkout — never a
    temporary or per-process name (the path is part of every cache key)."""
    import os

    import jax

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert cc.default_cache_dir() == want
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

    monkeypatch.setattr(cc, "_enabled_dir", None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cc, "_cpu_only", lambda: False)  # an accelerator
    set_dirs = []
    real_update = jax.config.update

    def spy(name, value):
        if name == "jax_compilation_cache_dir":
            set_dirs.append(value)
        else:
            real_update(name, value)

    monkeypatch.setattr(jax.config, "update", spy)
    monkeypatch.setattr(cc, "_prune_cache_dir", lambda d: 0)
    monkeypatch.setattr(cc.os, "makedirs", lambda d, exist_ok: None)
    assert cc.enable() == want
    assert set_dirs == [want]


def test_warmup_session_compiles_real_buckets(tmp_path):
    """Warm-up must run the actual engine paths (same bucketed shapes a
    later render of the same length reuses) and never raise."""
    cc.warmup_session(4096, 8000, engines=("granular",), columns=True)

    # The compiled executables are now live: an immediate real render of the
    # same length traces into cache without error.
    from melonix_tpu.engine.grains import build_grain_table
    from melonix_tpu.engine.maps import MapKnots
    from melonix_tpu.engine.render import render_track

    x = (0.3 * np.sin(2 * np.pi * 220.0 * np.arange(4096) / 8000)).astype(np.float32)
    out = render_track(x, build_grain_table(x), MapKnots.from_markers([], 8000, 4096))
    assert np.all(np.isfinite(np.asarray(out)))


def test_warmup_async_joins():
    t = cc.warmup_session_async(2048, 8000, engines=(), columns=True)
    t.join(timeout=120)
    assert not t.is_alive()


def test_prune_cache_dir_lru(tmp_path):
    """ADVICE r3 #2: the persistent cache dir is pruned LRU to a size cap
    on enable() — oldest entries go first, newer survive."""
    import os
    import time

    from melonix_tpu.runtime.compile_cache import _prune_cache_dir

    files = []
    for i in range(6):
        p = tmp_path / f"entry{i}.bin"
        p.write_bytes(b"x" * 1000)
        t = time.time() - (100 - i) * 10  # entry0 oldest
        os.utime(p, (t, t))
        files.append(p)
    removed = _prune_cache_dir(str(tmp_path), max_bytes=3500)
    assert removed == 3
    assert not files[0].exists() and not files[1].exists() and not files[2].exists()
    assert files[3].exists() and files[4].exists() and files[5].exists()
    # Under the cap: no-op.
    assert _prune_cache_dir(str(tmp_path), max_bytes=10_000) == 0
