"""chip_smoke.py at a tiny size on the CPU: every phase's control flow and
checks, and the refusal to report anything without a GPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(
    sr=8000, song_s=3.0, n_markers=12, flac_s=1.0, cols=8, col_size=4096,
    stft_check_frames=16, oracle_s=1.5, tone_s=2.0, session_sr=8000,
    session_markers=24, hour_s=20.0, cli_s=3.0,
)


@pytest.mark.parametrize("name,fn", chip_smoke.PHASES,
                         ids=[n for n, _ in chip_smoke.PHASES])
def test_phase_tiny(name, fn, tmp_path, monkeypatch):
    monkeypatch.setenv("MELONIX_AUTOSAVE_DIR", str(tmp_path / "autosave"))
    ctx = chip_smoke.Context(sizes=TINY, seed=3, workdir=str(tmp_path))
    figs = chip_smoke.run_phase(name, fn, ctx)
    assert isinstance(figs, dict) and figs


def test_four_cards_phase_on_virtual_mesh(tmp_path):
    """The four-device phase on 4 of the suite's 8 virtual CPU devices."""
    small = chip_smoke.Sizes(sr=8000, song_s=2.0, n_markers=4)
    ctx = chip_smoke.Context(sizes=small, seed=1, workdir=str(tmp_path))
    figs = chip_smoke.phase_four_cards(ctx)
    assert figs["devices"] >= 4


def test_main_refuses_cpu(capsys):
    """No GPU: non-zero exit, and no result line on stdout."""
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_check_raises():
    with pytest.raises(chip_smoke.PhaseFailure):
        chip_smoke.check(False, "boom")
