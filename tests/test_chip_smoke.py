"""chip_smoke.py: option parsing and phase selection on the CPU; its GPU
phases as ``gpu``-marked tests (they skip here and run on the card).

The phases run in the script's own process on the card, so the ``gpu``
tests below call the same phase functions ``python chip_smoke.py`` runs.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_parse_args_defaults():
    args = chip_smoke.parse_args([])
    assert args.seed == 0 and args.four_cards is False
    args = chip_smoke.parse_args(["--seed", "3", "--four-cards"])
    assert args.seed == 3 and args.four_cards is True


@pytest.fixture
def fake_card(monkeypatch):
    """Stand-in devices and card so main() can be driven on the CPU."""

    class Device:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    calls = []
    monkeypatch.setattr(chip_smoke, "require_gpu",
                        lambda count: [Device()] * count)
    monkeypatch.setattr(chip_smoke, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    for name in ("phase_parity", "phase_tile_kernel", "phase_golden",
                 "phase_main", "phase_four_cards"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name: calls.append(_n))
    return calls


@pytest.mark.parametrize("argv,phases,count", [
    ([], ["phase_parity", "phase_tile_kernel", "phase_golden",
          "phase_main"], 1),
    (["--four-cards"], ["phase_four_cards"], 4),
])
def test_phase_selection(fake_card, tmp_path, monkeypatch, capsys, argv,
                         phases, count):
    """Without options every one-card phase runs; ``--four-cards`` runs
    the four-card phase and no other.  The last stdout line is the result
    object, and the card's name and power limit come on a line before."""
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    assert chip_smoke.main(argv) == 0
    assert fake_card == phases
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count,
    }}
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in "\n".join(lines[:-1])
    assert not (tmp_path / ".smoke").exists()  # scratch removed


def test_failing_phase_exits_nonzero(fake_card, tmp_path, monkeypatch,
                                     capsys):
    """A failed check stops the run: non-zero exit, no result line."""
    def fail(*_a):
        chip_smoke.check("a check", False, "max|diff|=1")

    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "phase_golden", fail)
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert "[FAIL] a check" in out.out
    assert '"ok"' not in out.out


def test_cpu_exits_nonzero_without_result(tmp_path):
    """No accelerator: the script exits non-zero and prints no result, in
    the checkout and alone in an empty directory."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for cwd in (ROOT, str(alone)):
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_march_parity_on_gpu():
    chip_smoke.phase_parity()


@pytest.mark.gpu
def test_tile_kernel_on_gpu():
    chip_smoke.phase_tile_kernel()


@pytest.mark.gpu
def test_golden_on_gpu(tmp_path):
    chip_smoke.phase_golden(str(tmp_path))
