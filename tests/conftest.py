"""Test environment: force CPU with 8 virtual devices.

The suite runs on the CPU (SURVEY.md §4).  Sharding tests use the standard
JAX trick of 8 fake host devices; the accelerator itself is exercised end to
end by ``python chip_smoke.py`` at the repo root, not by the test suite.

The platform is switched through jax.config before any backend initializes,
so it holds whatever platform list the environment names.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

# Keep autosave snapshots out of the user's real cache dir.
import tempfile as _tempfile

os.environ.setdefault(
    "MELONIX_AUTOSAVE_DIR", _tempfile.mkdtemp(prefix="mlx_test_autosave_")
)

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import subprocess

import numpy as np
import pytest

# Build the native runtime once if the toolchain is present (best effort —
# tests that need it skip when absent).  Gate on EVERY target: a checkout
# with a stale libmelonix_native.so would otherwise never build the libav
# shim, silently skipping the whole long-tail import path (the Makefile
# itself skips libmelonix_av.so cleanly where libav headers are absent).
_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe_av_headers() -> bool:
    """Arch-independent libav header probe (ADVICE r3 #4): pkg-config when
    present, else a compile test — a fixed x86_64 multiarch path would
    silently skip the long-tail import path on other architectures."""
    try:
        if subprocess.run(
            ["pkg-config", "--exists", "libavformat"],
            capture_output=True, timeout=10,
        ).returncode == 0:
            return True
    except Exception:
        pass
    try:
        return subprocess.run(
            ["g++", "-x", "c++", "-fsyntax-only", "-"],
            input=b"#include <libavformat/avformat.h>\n",
            capture_output=True, timeout=30,
        ).returncode == 0
    except Exception:
        return False


_have_av_headers = _probe_av_headers()
_targets = [os.path.join(_repo, "native", "libmelonix_native.so")] + (
    [os.path.join(_repo, "native", "libmelonix_av.so")] if _have_av_headers else []
)
if not all(os.path.exists(t) for t in _targets):
    try:
        subprocess.run(
            ["make", "-C", os.path.join(_repo, "native")],
            capture_output=True,
            timeout=120,
            check=False,
        )
    except Exception:
        pass


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def chirp():
    """A 1.5 s, 8 kHz chirp with some noise — oscillates through zero often
    enough to exercise the grain chain's primary and fallback paths."""
    sr = 8000
    t = np.arange(int(sr * 1.5)) / sr
    f = 180.0 + 120.0 * t
    x = 0.6 * np.sin(2 * np.pi * f * t) + 0.05 * np.sin(2 * np.pi * 37.0 * t)
    g = np.random.default_rng(7)
    x += 0.01 * g.standard_normal(len(t))
    return x.astype(np.float32), sr
