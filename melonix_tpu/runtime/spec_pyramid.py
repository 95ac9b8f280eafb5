"""HBM-resident multi-resolution spectrogram pyramid (BASELINE config #2).

The reference computes every visible column on demand with a fresh 32768-pt
DFT (spec.cpp:44-66) — pan/zoom costs FFTs.  The pyramid inverts that: at
file open, ONE batched |STFT| pass (engine/spectral) materializes it at
the base hop; coarser levels (hop_l = base_hop * 2^l) are *pairwise maxima
over the frame axis* — the same blockwise reduce as the waveform min/max
pyramid (app.cpp:347-378), built device-side in microseconds with no
further FFTs.  Max-pooling (rather than frame subsampling) keeps transients
visible at any zoom, where the reference's one-bin-per-pixel NEAREST
sampling aliases.  After the build, any viewport at any zoom is a pure
*gather*: pick the level whose hop matches the samples-per-pixel, index
frames — no FFT ever runs again for display.

Memory: a 3-minute 44.1 kHz track is ~64 MB at level 0 and ~128 MB across
all levels — trivially device-resident.  A 3-hour track is ~2.5 GB, and
levels shard naturally over the frame axis where one device's memory is
not enough (parallel/sharded.sharded_stft_mags).

``compute_columns`` speaks the TileServer ``compute`` protocol, so the
pyramid plugs into the existing LRU + black-until-ready streaming contract:
``TileServer(wav, compute=pyramid.compute_columns, ...)``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, Config
from ..engine.spectral import hann_window, num_frames, stft_mags_device


@partial(jax.jit, static_argnames=())
def _gather_frames(mags: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    return mags[jnp.clip(idx, 0, mags.shape[0] - 1)]


def _max_pool_frames(mags: jnp.ndarray) -> jnp.ndarray:
    """Pairwise max over the frame axis (pad odd tails with the last frame)."""
    n = mags.shape[0]
    if n % 2:
        mags = jnp.concatenate([mags, mags[-1:]], axis=0)
    return jnp.maximum(mags[0::2], mags[1::2])


@partial(jax.jit, static_argnames=("min_frames",))
def _build_levels(base: jnp.ndarray, min_frames: int):
    """All coarser levels in one compiled program (one device dispatch)."""
    levels = []
    cur = base
    while cur.shape[0] > min_frames:
        cur = _max_pool_frames(cur)
        levels.append(cur)
    return tuple(levels)


class SpecPyramid:
    """Device-resident |STFT| levels + zoom-aware column lookup."""

    def __init__(
        self,
        wav,
        *,
        config: Config = DEFAULT_CONFIG,
        size: int | None = None,
        base_hop: int | None = None,
        min_frames: int = 64,
    ):
        self.config = config
        self.size = size or config.stft_size
        self.base_hop = base_hop or config.stft_hop
        wav = np.asarray(wav, np.float32)
        self.n_samples = len(wav)
        wav_dev = jnp.asarray(wav)
        win = jnp.asarray(hann_window(self.size))
        self.hops: list[int] = [self.base_hop]
        nf = num_frames(self.n_samples, self.size, self.base_hop)
        base = stft_mags_device(wav_dev, win, self.size, self.base_hop, nf)
        levels = [base]
        levels.extend(_build_levels(base, min_frames))
        self.hops.extend(self.base_hop * 2 ** (i + 1) for i in range(len(levels) - 1))
        # One flat (sum_frames, n_bins) array so every zoom level shares a
        # single compiled gather (per-level shapes would each recompile);
        # the per-level arrays are NOT retained — that would double HBM.
        self._flat = jnp.concatenate(levels, axis=0)
        self._level_shapes = [l.shape for l in levels]
        self._offsets = np.concatenate(
            [[0], np.cumsum([s[0] for s in self._level_shapes])]
        ).astype(np.int64)
        del levels

    @property
    def levels(self) -> list[jnp.ndarray]:
        """Per-level views (sliced on demand; storage is the flat array)."""
        return [
            self._flat[self._offsets[i] : self._offsets[i + 1]]
            for i in range(len(self._level_shapes))
        ]

    @property
    def n_bins(self) -> int:
        return self.size // 2

    def nbytes(self) -> int:
        return sum(int(np.prod(s)) * 4 for s in self._level_shapes)

    def level_for(self, samples_per_px: float) -> int:
        """Finest level whose hop does not oversample the request."""
        lvl = 0
        while lvl + 1 < len(self.hops) and self.hops[lvl + 1] <= samples_per_px:
            lvl += 1
        return lvl

    def compute_columns(self, starts, ends) -> np.ndarray:
        """TileServer ``compute`` protocol: (B,) ranges → (B, n_bins) mags.

        Each column [start, end) picks the level matching its width and the
        frame whose window end is nearest the column end (end-anchored like
        spec.cpp:47, modulo the Hann frame convention).
        """
        starts = np.asarray(starts, np.int64)
        ends = np.asarray(ends, np.int64)
        spp = np.maximum(ends - starts, 1)
        lvls = np.array([self.level_for(float(s)) for s in spp])
        hops = np.asarray(self.hops, np.int64)[lvls]
        frame_idx = np.maximum((ends - self.size) // hops, 0)
        n_level = self._offsets[lvls + 1] - self._offsets[lvls]
        flat_idx = self._offsets[lvls] + np.minimum(frame_idx, n_level - 1)
        got = np.asarray(_gather_frames(self._flat, jnp.asarray(flat_idx, np.int32)))
        # Match the reference columns' working range (|X|/N with an
        # untapered window → A/2 for a unit sine): the Hann window's
        # coherent gain is 1/2, so scale by 2/N.
        return got * np.float32(2.0 / self.size)
