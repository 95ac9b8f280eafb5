"""Grain segmentation: splice-safe grain table from zero crossings.

The reference splits the track into grains at negative→positive zero
crossings (app.cpp:153-235): the primary search probes alternating ±offsets
around ``start + preferred_grain_size`` for a crossing where ``look_around``
samples before are < 0 and after are >= 0 (app.cpp:163-193, look_around=7);
if none is found within ±(preferred/2 - 1), a fallback scans linearly from
``start + 1.5 * preferred`` with look_around=3 (app.cpp:194-231).

Host/device decomposition: the O(N·look) crossing *masks* are pure elementwise
reductions and run on device in one shot (``zero_crossing_mask_jax``); the
inherently sequential chain "next start depends on previous grain end" is a
tiny control-plane loop over ~N/1500 steps that runs on host NumPy (or the
native C++ runtime, see native/melonix_native.cpp) against the downloaded
masks.  The candidate *priority* (smallest |offset|, positive before
negative — the C++ probe order i → ±i/2) is an argmin over a static-width
window, so each host step is vectorized.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, Config


@dataclasses.dataclass(frozen=True)
class GrainTable:
    """Fixed-shape grain arrays: grain g covers source samples
    [starts[g], starts[g] + lengths[g]); grains tile the track contiguously
    (starts[g+1] == starts[g] + lengths[g])."""

    starts: np.ndarray  # int32 (G,)
    lengths: np.ndarray  # int32 (G,)

    def __len__(self) -> int:
        return len(self.starts)

    @property
    def ends(self) -> np.ndarray:
        return self.starts + self.lengths


def zero_crossing_mask_np(wav: np.ndarray, look_around: int) -> np.ndarray:
    """Boolean mask: m[idx] ⇔ idx is a valid neg→pos crossing.

    Matches the reference lambda (app.cpp:167-181): requires
    wav[idx-j] < 0 and wav[idx+1+j] >= 0 for j in [0, look_around), with
    bounds idx >= look_around and idx < n - look_around - 1.
    """
    wav = np.asarray(wav)
    n = len(wav)
    la = look_around
    m = np.zeros(n, bool)
    if n < 2 * la + 2:
        return m
    neg = (wav < 0).astype(np.int32)
    pos = (wav >= 0).astype(np.int32)
    cneg = np.concatenate([[0], np.cumsum(neg)])  # cneg[i] = sum(neg[:i])
    cpos = np.concatenate([[0], np.cumsum(pos)])
    idx = np.arange(la, n - la - 1)
    all_neg = (cneg[idx + 1] - cneg[idx + 1 - la]) == la  # wav[idx-la+1 .. idx]
    all_pos = (cpos[idx + 1 + la] - cpos[idx + 1]) == la  # wav[idx+1 .. idx+la]
    m[idx] = all_neg & all_pos
    return m


def zero_crossing_mask_jax(wav: jnp.ndarray, look_around: int) -> jnp.ndarray:
    """Device twin of ``zero_crossing_mask_np`` — one fused elementwise pass."""
    n = wav.shape[0]
    la = look_around
    neg = (wav < 0).astype(jnp.int32)
    pos = (wav >= 0).astype(jnp.int32)
    cneg = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(neg)])
    cpos = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(pos)])
    idx = jnp.arange(n)
    lo = jnp.clip(idx + 1 - la, 0, n)
    hi = jnp.clip(idx + 1 + la, 0, n)
    all_neg = (cneg[idx + 1] - cneg[lo]) == la
    all_pos = (cpos[hi] - cpos[jnp.minimum(idx + 1, n)]) == la
    valid = (idx >= la) & (idx < n - la - 1)
    return all_neg & all_pos & valid


def _chain_from_masks(
    zc_primary: np.ndarray,
    zc_fallback: np.ndarray,
    n: int,
    pgs: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Sequential chain selection given precomputed crossing masks."""
    starts: list[int] = []
    lengths: list[int] = []
    if n < pgs + 2:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    half = (pgs - 1) // 2  # probe offsets span [-(pgs-1)//2, (pgs-2)//2]... see below
    # Probe order i=0..pgs-1 maps to offsets: even i → +i/2, odd i → -(i/2),
    # i.e. offsets -half..+half with priority key 2*|off| + (off < 0).
    max_pos = (pgs - 2) // 2 if pgs >= 2 else 0  # largest even i = pgs-2 → +749
    max_neg = (pgs - 1) // 2  # largest odd i = pgs-1 → -749
    # Fallback-scan nonzero indices for fast "first crossing ≥ i0" queries.
    fb_idx = np.nonzero(zc_fallback)[0]

    start = 0
    while start < n - pgs - 1:
        target = start + pgs
        lo = max(0, target - max_neg)
        hi = min(n, target + max_pos + 1)
        window = zc_primary[lo:hi]
        cand = np.nonzero(window)[0]
        if cand.size:
            off = cand + lo - target
            key = 2 * np.abs(off) + (off < 0)
            best = int(cand[np.argmin(key)] + lo)
            starts.append(start)
            lengths.append(best - start)
            start = best
            continue
        # Fallback: first crossing at or after start + 1.5*pgs (app.cpp:198).
        i0 = start + pgs + pgs // 2
        j = np.searchsorted(fb_idx, i0, side="left")
        if j >= len(fb_idx):
            break
        best = int(fb_idx[j])
        starts.append(start)
        lengths.append(best - start)
        start = best
    return np.asarray(starts, np.int32), np.asarray(lengths, np.int32)


def build_grain_table(
    wav,
    config: Config = DEFAULT_CONFIG,
    *,
    backend: str = "auto",
) -> GrainTable:
    """Build the grain table for a track.

    ``backend``: "auto" prefers the native C++ runtime when built, else
    NumPy; "numpy" / "native" force a choice; "jax" computes the crossing
    masks on device (useful when ``wav`` already lives in HBM) with the chain
    on host.
    """
    pgs = config.preferred_grain_size
    if backend in ("auto", "native"):
        from ..runtime import native

        lib = native.try_load()
        if lib is not None:
            w = np.ascontiguousarray(np.asarray(wav, np.float32))
            return native.build_grains(lib, w, pgs)
        if backend == "native":
            raise RuntimeError("native runtime not built; run `make -C native`")
    if backend == "jax":
        w_dev = jnp.asarray(wav, jnp.float32)
        zc7 = np.asarray(zero_crossing_mask_jax(w_dev, config.zc_look_around))
        zc3 = np.asarray(zero_crossing_mask_jax(w_dev, config.zc_look_around_fallback))
        n = int(w_dev.shape[0])
    else:
        w = np.asarray(wav, np.float32)
        zc7 = zero_crossing_mask_np(w, config.zc_look_around)
        zc3 = zero_crossing_mask_np(w, config.zc_look_around_fallback)
        n = len(w)
    starts, lengths = _chain_from_masks(zc7, zc3, n, pgs)
    return GrainTable(starts, lengths)
