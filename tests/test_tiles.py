"""Colormap parity + tile-server contract (LRU, black-until-ready, batching)."""

import time

import numpy as np
import pytest

import oracle
from melonix_tpu.config import Config
from melonix_tpu.runtime.tiles import LruCache, TileServer
from melonix_tpu.ui.colormap import colormap_jax, colormap_np


def test_colormap_parity(rng):
    mags = (rng.random(2000) * 0.03).astype(np.float32)
    k = Config().brightness_to_k()  # default 2^14
    got = colormap_np(mags, k)
    want = oracle.colormap(mags, k)
    # C-cast truncation can differ by 1 at float boundaries; allow |d| <= 1.
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def test_colormap_jax_matches_np(rng):
    import jax.numpy as jnp

    mags = (rng.random(512) * 0.05).astype(np.float32)
    a = colormap_np(mags, 12345.0)
    b = np.asarray(colormap_jax(jnp.asarray(mags), 12345.0))
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1


def test_colormap_ranges():
    k = 1.0
    rgb = colormap_np(np.array([0.0, 50.0, 100.0, 200.0, 255.0, 1e9]), k)
    assert tuple(rgb[0]) == (0, 0, 0)
    assert tuple(rgb[1]) == (50, 0, 0)  # dim red
    assert rgb[2][1] > 0 and rgb[2][2] == 0  # arc: green present
    assert rgb[3][0] == (200 - 170) * 3 and rgb[3][1] == 200  # whitening
    assert tuple(rgb[4]) == (255, 255, 255)
    assert tuple(rgb[5]) == (255, 255, 255)  # clamped


def test_lru_capacity_and_recency():
    lru = LruCache(3)
    for i in range(3):
        lru.put(i, i * 10)
    assert len(lru) == 3
    assert lru.get(0) == 0  # touch 0 → most recent
    lru.put(3, 30)  # evicts oldest (1)
    assert 1 not in lru and 0 in lru and 2 in lru and 3 in lru


def _mk_server(chirp, synchronous):
    x, _sr = chirp
    cfg = Config(spectr_size=512, max_ranges=8)
    return TileServer(x, k=cfg.brightness_to_k(), config=cfg, synchronous=synchronous), cfg


def test_black_until_ready_contract(chirp):
    server, _cfg = _mk_server(chirp, synchronous=False)
    try:
        t = server.get_tile(0, 0, 500)
        assert t is None  # first poll: pending (black)
        deadline = time.time() + 30
        while t is None and time.time() < deadline:
            time.sleep(0.01)
            t = server.get_tile(0, 0, 500)
        assert t is not None, "worker never produced the tile"
        assert t.shape == (_cfg.tile_texels, 3) and t.dtype == np.uint8
    finally:
        server.close()


def test_batched_compute_and_lru_eviction(chirp):
    calls = []
    x, _sr = chirp
    cfg = Config(spectr_size=512, max_ranges=4)

    def compute(starts, ends):
        calls.append(len(starts))
        return np.ones((len(starts), 256), np.float32) * 0.01

    server = TileServer(x, k=1000.0, config=cfg, compute=compute, synchronous=True)
    # 6 distinct tiles through a capacity-4 cache
    for key in range(6):
        tile = server.get_tile(key, key * 100, key * 100 + 400)
        assert tile is not None  # synchronous mode computes inline
    assert server.stats()["cached"] == 4  # two evicted
    # Re-request an evicted tile → recompute; a cached one → no compute
    n_calls = len(calls)
    assert server.get_tile(5, 500, 900) is not None  # cached, no new call
    assert len(calls) == n_calls
    server.get_tile(0, 0, 400)  # evicted → pending → compute
    assert len(calls) == n_calls + 1


def test_brightness_change_clears(chirp):
    server, _ = _mk_server(chirp, synchronous=True)
    assert server.get_tile(0, 0, 400) is not None
    assert server.stats()["cached"] == 1
    server.set_brightness_k(999.0)
    assert server.stats()["cached"] == 0


def test_log_resample_texel_grid(rng):
    """Peak preservation + impulse placement on the log-texel grid."""
    from melonix_tpu.runtime.tiles import log_resample_np, texel_of_frac

    n_bins, T, fmin = 256, 64, 1.0 / 128
    mags = rng.random((3, n_bins)).astype(np.float32)
    out = log_resample_np(mags, T, fmin)
    assert out.shape == (3, T)
    # every texel value is an actual bin value; the global max survives
    hi = mags[:, 2:]  # bins at/above fmin (bin k: frac = k/256)
    assert np.allclose(out.max(axis=1), hi.max(axis=1))
    # an isolated impulse lands exactly at its texel
    m = np.zeros((1, n_bins), np.float32)
    m[0, 100] = 5.0
    j = int(texel_of_frac(100 / 256, T, fmin))
    o = log_resample_np(m, T, fmin)
    assert o[0, j] == 5.0


def test_log_resample_device_matches_np(chirp):
    """The TileServer device path and the NumPy twin agree texel-for-texel."""
    import oracle

    x, _sr = chirp
    cfg = Config(spectr_size=512, max_ranges=16)
    k = cfg.brightness_to_k()
    dev = TileServer(x, k=k, config=cfg, synchronous=True)
    tile_dev = dev.get_tile(0, 100, 500)
    dev.close()
    mags = oracle.spec_column(x, 100, 500, spectr_size=512)[None, :]
    from melonix_tpu.runtime.tiles import log_resample_np

    from melonix_tpu.ui.colormap import colormap_lut

    # The tile contract: uint8 VALUE plane on device, LUT colormap on host
    # (1 byte/texel over the link).  Same quantization here.
    v = np.uint8(np.round(np.clip(
        log_resample_np(mags, cfg.tile_texels, cfg.tile_frac_min) * np.float32(k),
        0.0, 255.0,
    )))[0]
    want = colormap_lut()[v]
    # Device float mags can land v one level off; adjacent LUT rows differ
    # by <= 3 per component (the w = (v-170)*3 arm).
    diff = np.abs(tile_dev.astype(int) - want.astype(int))
    assert diff.max() <= 3


def test_worker_survives_bad_batch():
    """A failing compute batch must not kill the worker thread (fail-soft):
    the error is counted in tiles.worker_errors and later requests are
    still served."""
    import time as _time

    from melonix_tpu.config import DEFAULT_CONFIG
    from melonix_tpu.runtime.tiles import TileServer
    from melonix_tpu.utils import registry

    calls = {"n": 0}

    def compute(starts, ends):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected batch failure")
        return np.ones((len(starts), DEFAULT_CONFIG.spectr_size // 2), np.float32)

    srv = TileServer(np.zeros(4096, np.float32), k=512.0,
                     config=DEFAULT_CONFIG, compute=compute,
                     poll_interval=0.005)
    try:
        before = registry("tiles.worker_errors").value
        assert srv.get_tile(1, 0, 2048) is None  # queued; worker will fail
        deadline = _time.time() + 5.0
        while registry("tiles.worker_errors").value == before:
            assert _time.time() < deadline, "worker error never recorded"
            _time.sleep(0.01)
        # Second request computes on the recovered worker.
        deadline = _time.time() + 5.0
        tile = None
        while tile is None and _time.time() < deadline:
            tile = srv.get_tile(2, 0, 2048)
            _time.sleep(0.01)
        assert tile is not None and tile.shape[1] == 3
    finally:
        srv.close()


def test_busy_signal_during_stalled_batch():
    """stats()['busy_s'] exposes an in-flight device batch — the UI's only
    feedback while a slow batch (a first compile) keeps tiles black — and
    returns to 0 when the batch lands (or fails)."""
    import threading
    import time as _time

    import numpy as np

    from melonix_tpu.config import Config
    from melonix_tpu.runtime.tiles import TileServer

    release = threading.Event()
    texels = Config().tile_texels

    def slow_compute(starts, ends):
        release.wait(10.0)
        return np.zeros((len(starts), 64), np.float32)

    x = np.zeros(4096, np.float32)
    srv = TileServer(x, k=1.0, config=Config(max_ranges=8), compute=slow_compute,
                     poll_interval=0.01)
    try:
        assert srv.stats()["busy_s"] == 0.0
        srv.get_tile(0, 0, 256)
        t0 = _time.monotonic()
        while srv.stats()["busy_s"] == 0.0:  # worker picked the batch up
            assert _time.monotonic() - t0 < 5.0, "worker never went busy"
            _time.sleep(0.005)
        _time.sleep(0.05)
        assert srv.stats()["busy_s"] > 0.0
        release.set()
        t0 = _time.monotonic()
        while srv.get_tile(0, 0, 256) is None:
            assert _time.monotonic() - t0 < 5.0, "tile never arrived"
            _time.sleep(0.005)
        assert srv.stats()["busy_s"] == 0.0
    finally:
        release.set()
        srv.close()


def test_inflight_counts_toward_settle():
    """stats()['inflight'] names the keys handed to the device batch in
    flight: a settle poll that waits only for pending == 0 returns while
    the batch is still on the wire (the black placeholder is still being
    served) — pending + inflight == 0 is the real settled condition."""
    import threading
    import time as _time

    import numpy as np

    from melonix_tpu.config import Config
    from melonix_tpu.runtime.tiles import TileServer

    release = threading.Event()

    def slow_compute(starts, ends):
        release.wait(10.0)
        return np.zeros((len(starts), 64), np.float32)

    x = np.zeros(4096, np.float32)
    srv = TileServer(x, k=1.0, config=Config(max_ranges=8), compute=slow_compute,
                     poll_interval=0.01)
    try:
        srv.get_tile(0, 0, 256)
        t0 = _time.monotonic()
        while srv.stats()["inflight"] == 0:  # worker picked the batch up
            assert _time.monotonic() - t0 < 5.0, "batch never went in-flight"
            _time.sleep(0.005)
        st = srv.stats()
        assert st["pending"] == 0  # the naive settle poll would return here
        assert st["inflight"] == 1  # ...but the tile has not landed
        assert srv.get_tile(0, 0, 256) is None
        release.set()
        t0 = _time.monotonic()
        while srv.stats()["inflight"] or srv.stats()["pending"]:
            assert _time.monotonic() - t0 < 5.0, "batch never landed"
            _time.sleep(0.005)
        t0 = _time.monotonic()
        while srv.get_tile(0, 0, 256) is None:
            assert _time.monotonic() - t0 < 5.0, "tile never arrived"
            _time.sleep(0.005)
    finally:
        release.set()
        srv.close()


def test_repoll_during_drain_does_not_recompute():
    """Polling a black tile while its batch is on device must NOT re-enqueue
    it: without in-flight tracking every poll during a ~50 ms drain queued
    the whole burst again and the worker paid a second full device round
    trip recomputing tiles the first drain had already delivered."""
    import threading
    import time as _time

    import numpy as np

    from melonix_tpu.config import Config
    from melonix_tpu.runtime.tiles import TileServer

    release = threading.Event()
    computed: list = []

    def slow_compute(starts, ends):
        computed.append(len(starts))
        release.wait(10.0)
        return np.zeros((len(starts), 64), np.float32)

    x = np.zeros(4096, np.float32)
    srv = TileServer(x, k=1.0, config=Config(max_ranges=64),
                     compute=slow_compute, poll_interval=0.002)
    try:
        reqs = [(i, i * 16, i * 16 + 256) for i in range(8)]
        assert all(t is None for t in srv.get_tiles(reqs))
        t0 = _time.monotonic()
        while not computed:  # worker picked the batch up
            assert _time.monotonic() - t0 < 5.0, "worker never started"
            _time.sleep(0.002)
        # Re-poll hard while the batch is in flight (the UI frame loop).
        for _ in range(50):
            srv.get_tiles(reqs)
            srv.prefetch(reqs)
            srv.get_tile(*reqs[0])
        release.set()
        t0 = _time.monotonic()
        while any(t is None for t in srv.get_tiles(reqs)):
            assert _time.monotonic() - t0 < 5.0, "tiles never arrived"
            _time.sleep(0.002)
        _time.sleep(0.05)  # give a (wrong) second drain time to start
        assert len(computed) == 1, f"expected ONE drain, got {computed}"
    finally:
        release.set()
        srv.close()


def test_brightness_change_mid_drain_discards_stale_tiles():
    """A set_brightness_k while a batch is on device must not land stale-k
    tiles in the cache (they would pin the old brightness forever — polls
    hit the cache and never recompute)."""
    import threading
    import time as _time

    import numpy as np

    from melonix_tpu.config import Config
    from melonix_tpu.runtime.tiles import TileServer

    release = threading.Event()
    started = threading.Event()

    def slow_compute(starts, ends):
        started.set()
        release.wait(10.0)
        return np.full((len(starts), 64), 100.0, np.float32)

    x = np.zeros(4096, np.float32)
    srv = TileServer(x, k=1.0, config=Config(max_ranges=8),
                     compute=slow_compute, poll_interval=0.002)
    try:
        assert srv.get_tile(0, 0, 256) is None
        assert started.wait(5.0), "worker never started"
        srv.set_brightness_k(2.0)  # mid-flight brightness change
        release.set()
        # The stale-k result must be discarded; the re-enqueued compute at
        # k=2.0 serves the tile with the NEW brightness.
        t0 = _time.monotonic()
        tile = None
        while tile is None:
            assert _time.monotonic() - t0 < 5.0, "tile never arrived"
            tile = srv.get_tile(0, 0, 256)
            _time.sleep(0.002)
        from melonix_tpu.ui.colormap import colormap_lut
        assert (tile == colormap_lut()[200]).all()  # 100 * k=2.0 -> 200
    finally:
        release.set()
        srv.close()


def test_clear_mid_drain_discards_stale_tiles():
    """A clear() while a batch is on device (the marker-edit invalidate
    path: the SAME key maps to NEW sample ranges after the edit) must not
    land the stale batch in the cache.  Regression: in-flight suppression
    blocked re-polls during the flight, then the stale put made them cache
    hits forever — the tile kept pre-edit content."""
    import threading
    import time as _time

    import numpy as np

    from melonix_tpu.config import Config
    from melonix_tpu.runtime.tiles import TileServer

    release = threading.Event()
    started = threading.Event()

    def slow_compute(starts, ends):
        # Encode the requested range into the magnitude so stale content is
        # detectable: pre-edit range starts at 0, post-edit at 1024.
        val = 100.0 if int(starts[0]) == 0 else 50.0
        if not started.is_set():
            started.set()
            release.wait(10.0)
        return np.full((len(starts), 64), val, np.float32)

    x = np.zeros(8192, np.float32)
    srv = TileServer(x, k=1.0, config=Config(max_ranges=8),
                     compute=slow_compute, poll_interval=0.002)
    try:
        assert srv.get_tile(0, 0, 256) is None          # pre-edit range
        assert started.wait(5.0), "worker never started"
        srv.clear()                                     # the edit invalidate
        # Re-request the SAME key with its post-edit range while the stale
        # batch is still in flight; must not be suppressed by _inflight.
        assert srv.get_tile(0, 1024, 1280) is None
        release.set()
        t0 = _time.monotonic()
        tile = None
        while tile is None:
            assert _time.monotonic() - t0 < 5.0, "tile never arrived"
            tile = srv.get_tile(0, 1024, 1280)
            _time.sleep(0.002)
        from melonix_tpu.ui.colormap import colormap_lut
        assert (tile == colormap_lut()[50]).all(), "stale pre-edit tile served"
    finally:
        release.set()
        srv.close()


def test_damage_log_names_landed_keys():
    """keys_landed_since reports exactly the keys drains landed after the
    given epoch (the scene renderer's incremental-pan refresh set)."""
    x = np.zeros(8192, np.float32)

    def compute(starts, ends):
        return np.full((len(starts), 64), 10.0, np.float32)

    srv = TileServer(x, k=1.0, config=Config(max_ranges=64),
                     compute=compute, synchronous=True)
    assert srv.keys_landed_since(srv.epoch) == frozenset()
    e0 = srv.epoch
    srv.get_tile(3, 0, 256)
    srv.get_tile(7, 256, 512)
    assert srv.keys_landed_since(e0) == frozenset({3, 7})
    e1 = srv.epoch
    srv.get_tile(9, 512, 768)
    assert srv.keys_landed_since(e1) == frozenset({9})
    assert srv.keys_landed_since(e0) == frozenset({3, 7, 9})
    # clear() makes the damage unknown for any pre-clear epoch...
    srv.clear()
    assert srv.keys_landed_since(e0) is None
    # ...but a fresh epoch after the clear tracks normally again.
    e2 = srv.epoch
    srv.get_tile(1, 0, 256)
    assert srv.keys_landed_since(e2) == frozenset({1})
    # brightness change: unknown too
    e3 = srv.epoch
    srv.set_brightness_k(2.0)
    assert srv.keys_landed_since(e3) is None


def test_eviction_invalidates_damage_log():
    """An LRU eviction reverts an unnameable key to black-until-ready, so
    any window containing an evicting drain must report damage unknown
    (None) — otherwise the incremental lane memo would keep showing content
    the full recomposition path has lost (inc != full)."""
    x = np.zeros(8192, np.float32)

    def compute(starts, ends):
        return np.full((len(starts), 64), 10.0, np.float32)

    srv = TileServer(x, k=1.0, config=Config(max_ranges=2),
                     compute=compute, synchronous=True)
    e0 = srv.epoch
    srv.get_tile(0, 0, 256)
    srv.get_tile(1, 256, 512)
    assert srv.keys_landed_since(e0) == frozenset({0, 1})  # at capacity
    e1 = srv.epoch
    srv.get_tile(2, 512, 768)  # evicts key 0
    assert srv.keys_landed_since(e1) is None
    assert srv.keys_landed_since(e0) is None  # window contains the eviction


def test_len_bucket_properties():
    """Track-length buckets are geometric ({2^k, 3·2^(k-1)}), monotone,
    never below the input, and within 3/2 of it — the tile executable set
    stays tiny across arbitrary track lengths."""
    from melonix_tpu.runtime.tiles import _len_bucket

    prev = 0
    for n in [1, 1000, 1024, 1025, 44100, 441000, 441001, 2**20,
              3 * 2**19, 3 * 2**19 + 1, 158_760_000]:
        b = _len_bucket(n)
        assert b >= max(n, 1024)
        assert b <= max(n, 1024) * 3 // 2 + 4
        assert b >= prev  # monotone in n
        prev = b
        # bucket is 2^k or 3*2^(k-1)
        while b % 2 == 0:
            b //= 2
        assert b in (1, 3)


def test_tile_content_invariant_under_length_padding(chirp):
    """Two tracks in the same bucket that differ only by trailing zeros
    produce IDENTICAL tiles for identical key ranges — the padding the
    bucketed device copy adds is exactly the OOB-zero semantics
    (spec.cpp:50-54), so bucketing cannot change any texel."""
    x, _sr = chirp
    cfg = Config(spectr_size=512, max_ranges=64)
    k = cfg.brightness_to_k()
    xp = np.concatenate([x, np.zeros(1000, np.float32)])
    a = TileServer(x, k=k, config=cfg, synchronous=True)
    b = TileServer(xp, k=k, config=cfg, synchronous=True)
    try:
        for key, lo, hi in [(0, 100, 500), (1, 0, 512),
                            (2, len(x) - 600, len(x) - 1),
                            (3, len(x) - 200, len(x) + 300)]:
            ta = a.get_tile(key, lo, hi)
            tb = b.get_tile(key, lo, hi)
            assert np.array_equal(ta, tb), (key, lo, hi)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("span", [441, 30000])
def test_reference_size_tiles_match_oracle(rng, span):
    """Tiles at the reference's 32768-point columns: the device value
    planes through the LUT vs the float64 oracle column, log-resampled and
    colored by the literal colormap transcription."""
    from melonix_tpu.runtime.tiles import log_resample_np

    x = (0.5 * np.sin(np.arange(90000) * 0.05)
         + 0.05 * rng.standard_normal(90000)).astype(np.float32)
    cfg = Config(spectr_size=32768, max_ranges=16)
    k = cfg.brightness_to_k()
    ends = [40000, 70000, 95000]  # the last window runs past the track
    srv = TileServer(x, k=k, config=cfg, synchronous=True)
    tiles = srv.get_tiles([(i, e - span, e) for i, e in enumerate(ends)])
    srv.close()
    for tile, e in zip(tiles, ends):
        mags = oracle.spec_column(x, e - span, e, cfg.spectr_size)[None, :]
        texels = log_resample_np(mags, cfg.tile_texels, cfg.tile_frac_min)[0]
        want = oracle.colormap(texels, k)
        assert tile.shape == (cfg.tile_texels, 3) and tile.dtype == np.uint8
        # Value planes quantize to uint8 before the LUT; adjacent LUT rows
        # differ by <= 3 per component (the whitening arm).
        diff = np.abs(tile.astype(int) - want.astype(int))
        assert diff.max() <= 3, diff.max()
