"""melonix_tpu — an accelerator-native audio pitch-editing framework.

A ground-up JAX/XLA rebuild of the capabilities of mika314/melonix
(see SURVEY.md): spectrogram analysis, marker-based time-warp/pitch-bend
editing, granular and phase-vocoder rendering, batched pitch detection,
project persistence, and a thin host UI — with the compute path designed
for an accelerator (batched device programs, batched FFTs, mesh sharding)
rather than the reference's per-column CPU worker threads.
"""

from .runtime.compile_cache import enable as _enable_compile_cache

# Persist XLA executables across processes before anything can compile —
# the device analogue of the reference building its FFTW plan once at startup
# (spec.cpp:15) instead of re-deriving it per run.
_enable_compile_cache()

from .config import DEFAULT_CONFIG, Config
from .markers import Marker, markers_from_json, markers_to_json, sort_markers
from .engine.maps import MapKnots
from .engine.grains import GrainTable, build_grain_table
from .engine.render import RenderPlan, build_render_plan, render, render_track
from .engine.phase_vocoder import render_channels_pv, render_track_pv
from .engine.batch import render_batch
from .engine.session import render_session
from .engine.pitch import PitchCurve, pitch_curve
from .engine.autotune import autotune, suggest_markers
from .io import (
    load_audio, write_audio, read_wav, write_wav, write_flac,
    Project, load_project, save_project,
)
from .io.audio import DecodeError
from .runtime.compile_cache import warmup_session, warmup_session_async

__version__ = "0.1.0"

__all__ = [
    "Config",
    "DEFAULT_CONFIG",
    "Marker",
    "markers_from_json",
    "markers_to_json",
    "sort_markers",
    "MapKnots",
    "GrainTable",
    "build_grain_table",
    "RenderPlan",
    "build_render_plan",
    "render",
    "render_track",
    "render_track_pv",
    "render_channels_pv",
    "render_batch",
    "render_session",
    "PitchCurve",
    "pitch_curve",
    "autotune",
    "suggest_markers",
    "DecodeError",
    "load_audio",
    "write_audio",
    "read_wav",
    "write_wav",
    "write_flac",
    "Project",
    "load_project",
    "save_project",
    "warmup_session",
    "warmup_session_async",
    "__version__",
]
