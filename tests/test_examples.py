"""Smoke tests for the example scripts (python/examples parity)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from amrvolumerenderer_tpu.plotfile import write_plotfile
from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples")

def load_example(script):
    """Import an example script as a module (examples/ is not a package)
    so its main(argv) runs in-process, sharing this process's XLA compile
    cache — the multi-frame examples then cost one compile total instead
    of a fresh subprocess compile each."""
    import importlib.util

    path = os.path.join(EXAMPLES, script)
    spec = importlib.util.spec_from_file_location(
        "example_" + script.replace(".py", ""), path
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def plotfile(tmp_path):
    n = 8
    rng = np.random.default_rng(0)
    boxes = [LevelBox(rng.random((n, n, n)) + 0.1, np.zeros(3, dtype=int))]
    geom = LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))
    path = str(tmp_path / "plt00000")
    write_plotfile(path, [boxes], [geom], var_names=["density"])
    return path


def run_example(script, args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (
        os.path.dirname(EXAMPLES) + os.pathsep + env.get("PYTHONPATH", "")
    )
    # generous cap: a fresh subprocess pays a full XLA compile, which can
    # exceed 10 minutes on a loaded machine (observed in CI-style runs)
    return subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script), *args],
        capture_output=True, text=True, cwd=cwd, timeout=1800, env=env,
    )


def test_render_volume_example(plotfile, tmp_path):
    out = str(tmp_path / "ex.ppm")
    r = run_example(
        "render_volume.py",
        [plotfile, "--width", "24", "--height", "24", "--output", out],
        str(tmp_path),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)


def test_render_volume_rotate_example(plotfile, tmp_path):
    mod = load_example("render_volume_rotate.py")
    mod.main(
        [plotfile, "--frames", "2", "--width", "16", "--height", "16",
         "--output-dir", str(tmp_path / "orbit")]
    )
    frames = os.listdir(tmp_path / "orbit")
    assert len(frames) == 2


def test_render_volume_time_example(plotfile, tmp_path):
    mod = load_example("render_volume_time.py")
    mod.main(
        [os.path.join(os.path.dirname(plotfile), "plt*"),
         "--width", "16", "--height", "16",
         "--output-dir", str(tmp_path / "time")]
    )
    assert len(os.listdir(tmp_path / "time")) == 1


def test_compute_histogram_example(plotfile, capsys):
    mod = load_example("compute_histogram.py")
    mod.main([plotfile, "--bins", "16"])
    out = capsys.readouterr().out
    assert "samples: 512" in out
    assert "percentiles" in out


def test_render_from_arrays_example(tmp_path):
    mod = load_example("render_from_arrays.py")
    out = str(tmp_path / "multifab-render.png")
    mod.main(["--width", "48", "--height", "48", "--output", out])
    assert os.path.exists(out)


def test_fit_transfer_function_example(capsys):
    mod = load_example("fit_transfer_function.py")
    rc = mod.main(["--steps", "25", "--volume-size", "6", "--image-size", "16"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "reduction" in out


def test_fit_volume_example(capsys):
    mod = load_example("fit_volume.py")
    rc = mod.main(["--steps", "80", "--volume-size", "6",
                   "--image-size", "14", "--views", "4"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "correlation" in out


def test_render_animation_example(tmp_path):
    mod = load_example("render_animation.py")
    assert mod.main([str(tmp_path / "anim"), "--frames", "3", "--size", "32"]) == 0
    names = os.listdir(tmp_path / "anim")
    # 3 per-frame update_data renders + 3 batched orbit frames
    assert sorted(n for n in names if n.startswith("frame")) == [
        "frame0000.png", "frame0001.png", "frame0002.png"
    ]
    assert sorted(n for n in names if n.startswith("orbit")) == [
        "orbit0000.png", "orbit0001.png", "orbit0002.png"
    ]


def test_render_multichip_animation_example(tmp_path):
    mod = load_example("render_multichip_animation.py")
    rc = mod.main(["--size", "32", "--frames", "2",
                   "--output-dir", str(tmp_path / "mesh")])
    assert rc == 0
    assert sorted(os.listdir(tmp_path / "mesh")) == [
        "multichip_00.ppm", "multichip_01.ppm"
    ]
