"""ctypes bindings to the native C++ runtime (native/libmelonix_native.so).

The reference's runtime-side code is C++ (grain scan app.cpp:153-235, pyramid
app.cpp:347-426, LRU caches spec.cpp:18-42); this build keeps those
host/control-plane pieces native too.  Everything here degrades gracefully to
the NumPy implementations when the shared library has not been built.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np

_LIB_NAMES = ("libmelonix_native.so",)


def _candidate_paths():
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    for name in _LIB_NAMES:
        yield os.path.join(root, "native", name)
        yield os.path.join(here, name)


@lru_cache(maxsize=1)
def try_load() -> ctypes.CDLL | None:
    """Load the native runtime library, or None if it is not built."""
    for path in _candidate_paths():
        if os.path.exists(path):
            lib = ctypes.CDLL(path)
            _declare(lib)
            return lib
    return None


def _declare(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    lib.mlx_build_grains.restype = ctypes.c_int64
    lib.mlx_build_grains.argtypes = [
        f32p,  # wav
        ctypes.c_int64,  # n
        ctypes.c_int32,  # preferred grain size
        i32p,  # out starts (capacity n/2+1)
        i32p,  # out lengths
        ctypes.c_int64,  # capacity
    ]

    lib.mlx_calc_picks.restype = ctypes.c_int32
    lib.mlx_calc_picks.argtypes = [f32p, ctypes.c_int64, f32p, f32p, ctypes.c_int64]

    lib.mlx_minmax_range.restype = None
    lib.mlx_minmax_range.argtypes = [
        f32p, ctypes.c_int64,  # wav
        f32p, f32p, ctypes.c_int32,  # mins, maxs (flattened pyramid), n_levels
        i64p, ctypes.c_int64,  # queries (start,end pairs), n_queries
        f32p, f32p,  # out min, out max
    ]

    f64p = ctypes.POINTER(ctypes.c_double)
    lib.mlx_build_plan.restype = ctypes.c_int64
    lib.mlx_build_plan.argtypes = [
        i32p, i32p, ctypes.c_int64,  # grain starts/lens, count
        f64p, f64p, f64p, ctypes.c_int64,  # knot ks/ts/bends, count
        ctypes.c_double, ctypes.c_double,  # sample_rate, duration
        ctypes.c_double, ctypes.c_int64, ctypes.c_int32,  # cursor, min_out, pgs
        i32p, i32p, f32p, i64p, i32p,  # out arrays
        ctypes.c_int64,  # cap
        i32p,  # tail_zeros
    ]

    lib.mlx_lru_new.restype = ctypes.c_void_p
    lib.mlx_lru_new.argtypes = [ctypes.c_int64]
    lib.mlx_lru_free.restype = None
    lib.mlx_lru_free.argtypes = [ctypes.c_void_p]
    lib.mlx_lru_get.restype = ctypes.c_int64
    lib.mlx_lru_get.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.mlx_lru_put.restype = ctypes.c_int64
    lib.mlx_lru_put.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.mlx_lru_size.restype = ctypes.c_int64
    lib.mlx_lru_size.argtypes = [ctypes.c_void_p]

    lib.mlx_ring_new.restype = ctypes.c_void_p
    lib.mlx_ring_new.argtypes = [ctypes.c_int64]
    lib.mlx_ring_free.restype = None
    lib.mlx_ring_free.argtypes = [ctypes.c_void_p]
    lib.mlx_ring_write.restype = ctypes.c_int64
    lib.mlx_ring_write.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    lib.mlx_ring_read.restype = ctypes.c_int64
    lib.mlx_ring_read.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    lib.mlx_ring_avail.restype = ctypes.c_int64
    lib.mlx_ring_avail.argtypes = [ctypes.c_void_p]
    lib.mlx_ring_clear.restype = None
    lib.mlx_ring_clear.argtypes = [ctypes.c_void_p]


def build_plan(lib: ctypes.CDLL, grains, knots, start_cursor: float, min_out, pgs: int):
    """Native render-plan builder; returns the same arrays as the NumPy walk."""
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    g_starts = np.ascontiguousarray(grains.starts, np.int32)
    g_lens = np.ascontiguousarray(grains.lengths, np.int32)
    ks = np.ascontiguousarray(knots.samples, np.float64)
    ts = np.ascontiguousarray(knots.times, np.float64)
    bends = np.ascontiguousarray(knots.bends, np.float64)
    # Warp repetition can revisit grains, so the step count isn't bounded by
    # the grain count; grow the buffers until the chain completes.
    cap = max(16, 4 * len(g_starts) + 64)
    while True:
        out_start = np.zeros(cap, np.int32)
        out_len = np.zeros(cap, np.int32)
        out_rate = np.zeros(cap, np.float32)
        out_sz = np.zeros(cap, np.int64)
        out_seam = np.zeros(cap, np.int32)
        tail = np.zeros(1, np.int32)
        count = lib.mlx_build_plan(
            g_starts.ctypes.data_as(i32p), g_lens.ctypes.data_as(i32p), len(g_starts),
            ks.ctypes.data_as(f64p), ts.ctypes.data_as(f64p), bends.ctypes.data_as(f64p), len(ks),
            float(knots.sample_rate), float(knots.duration()),
            float(start_cursor), -1 if min_out is None else int(min_out), int(pgs),
            out_start.ctypes.data_as(i32p), out_len.ctypes.data_as(i32p),
            out_rate.ctypes.data_as(f32p), out_sz.ctypes.data_as(i64p),
            out_seam.ctypes.data_as(i32p), cap, tail.ctypes.data_as(i32p),
        )
        if count < cap:
            break
        cap *= 4
    return (
        out_start[:count].copy(),
        out_len[:count].copy(),
        out_rate[:count].copy(),
        out_sz[:count].copy(),
        out_seam[:count].copy(),
        int(tail[0]),
    )


def build_grains(lib: ctypes.CDLL, wav: np.ndarray, pgs: int):
    from ..engine.grains import GrainTable

    n = len(wav)
    cap = max(n // 2 + 2, 16)
    starts = np.zeros(cap, np.int32)
    lengths = np.zeros(cap, np.int32)
    count = lib.mlx_build_grains(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        pgs,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
    )
    return GrainTable(starts[:count].copy(), lengths[:count].copy())


def _decode_two_call(lib: ctypes.CDLL, prefix: str, label: str, path: str,
                     *, mono: bool, has_bits: bool = True):
    """Drive a native decoder's two-call info/read protocol.

    Every codec (WAV/FLAC/MP3/Vorbis) exports ``mlx_<prefix>_info`` (fills
    frame count / channels / rate so the caller can size the buffer) and
    ``mlx_<prefix>_read`` (fills the buffer, interleaved or downmixed).
    Returns (float32 (n,) or (n, ch), rate); raises ValueError on bad or
    unsupported input (fail-soft contract: callers keep prior state,
    app.cpp:628-694).  WAV's info has no bits out-param (has_bits=False).
    """
    info = getattr(lib, f"mlx_{prefix}_info")
    read = getattr(lib, f"mlx_{prefix}_read")
    i32p = ctypes.POINTER(ctypes.c_int32)
    info.restype = ctypes.c_int32
    info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                     i32p, i32p] + ([i32p] if has_bits else [])
    read.restype = ctypes.c_int32
    read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                     ctypes.c_int64, ctypes.c_int32]
    n = ctypes.c_int64()
    ch = ctypes.c_int32()
    rate = ctypes.c_int32()
    bits = ctypes.c_int32()
    args = [path.encode(), ctypes.byref(n), ctypes.byref(ch), ctypes.byref(rate)]
    if has_bits:
        args.append(ctypes.byref(bits))
    rc = info(*args)
    if rc != 0:
        raise ValueError(f"{path}: not a decodable {label} (native rc {rc})")
    frames = int(n.value)
    channels = int(ch.value)
    shape = (frames,) if (mono or channels == 1) else (frames, channels)
    out = np.zeros(shape, np.float32)
    rc = read(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames,
        1 if mono else 0,
    )
    if rc != 0:
        raise ValueError(f"{path}: native {label} read failed (rc {rc})")
    return out, int(rate.value)


def decode_wav(lib: ctypes.CDLL, path: str, *, mono: bool = True):
    """Native WAV decode (native/melonix_native.cpp)."""
    return _decode_two_call(lib, "wav", "WAV", path, mono=mono, has_bits=False)


def decode_flac(lib: ctypes.CDLL, path: str, *, mono: bool = True):
    """Native FLAC decode (native/flac_decode.cpp)."""
    return _decode_two_call(lib, "flac", "FLAC", path, mono=mono)


def decode_mp3(lib: ctypes.CDLL, path: str, *, mono: bool = True):
    """Native MPEG-1/2/2.5 Layer III decode (native/mp3_decode.cpp)."""
    return _decode_two_call(lib, "mp3", "MPEG-1 L3 stream", path, mono=mono)


def decode_vorbis(lib: ctypes.CDLL, path: str, *, mono: bool = True):
    """Native Ogg Vorbis decode (native/vorbis_decode.cpp)."""
    return _decode_two_call(lib, "vorbis", "Ogg Vorbis stream", path, mono=mono)
