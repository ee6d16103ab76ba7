"""Guard the benchmark harness (bench.py) against refactor breakage.

The driver runs ``python bench.py`` unattended at round end; a broken
import, scene builder, or measurement entry point would only surface
there.  These tests exercise the harness pieces on the CPU mesh without
paying the full benchmark's wall clock (tiny frames; ``main`` itself
refuses to run without a GPU).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def bench():
    import bench as b

    return b


def test_scene_builders(bench):
    """Both benchmark scenes build through the product ingestion path."""
    g3 = bench.build_three_level_scene()
    assert len(g3.bricks) > 1  # convexified multi-level hierarchy
    gs = bench.build_shell_scene()
    assert len(gs.bricks) == 64  # 128^3 in 32^3 bricks


def test_measurement_entry_points_exist(bench):
    """The driver-facing API surface bench.main relies on."""
    assert callable(bench.measure_device_frame)
    assert callable(bench.measure_device_frame_single_launch)
    assert callable(bench.exchange_payload_bytes)
    assert callable(bench.measure_host_prep_512)


def test_exchange_payload_model(bench):
    """The static link payload model produces sane numbers on the bench
    scene (positive payloads, ubyte strictly smaller, fraction in
    (0, 1])."""
    from amrvolumerenderer_tpu.camera import auto_orbit_camera
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.types import RenderParameters

    fsr = FastSceneRenderer(
        bench.build_three_level_scene(),
        RenderParameters(width=64, height=64),
    )
    cam = auto_orbit_camera(fsr.bounds)
    f32, ub, frac = bench.exchange_payload_bytes(fsr, cam, 8)
    assert f32 > 0 and 0 < ub < f32
    assert 0.0 < frac <= 1.0 + 1e-9


def test_radial_field_structure(bench):
    """The bench field has structure at every level (nothing culls to
    empty, which would silently benchmark a trivial scene)."""
    f = bench.radial_field(32, 0.0, 1.0)
    assert f.shape == (32, 32, 32)
    assert f.max() > 0.5 and f.min() >= 0.0
    # the two shells exist: a meaningful fraction of cells is non-tiny
    assert 0.01 < (f > 0.05).mean() < 0.9


def test_main_refuses_without_gpu(bench, capsys):
    """No CPU fallback: on the CPU the benchmark exits non-zero and prints
    no result line."""
    assert bench.main() != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_device_frame_timers(bench):
    """Both device-time entries run the tile loop and return a positive
    per-frame time (a CPU-scale stand-in for the 1024^2 run)."""
    from amrvolumerenderer_tpu.camera import auto_orbit_camera
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.types import RenderParameters

    fsr = FastSceneRenderer(
        bench.build_three_level_scene(),
        RenderParameters(width=64, height=64),
    )
    cam = auto_orbit_camera(fsr.bounds)
    assert bench.measure_device_frame(fsr, cam, reps=1) > 0.0
    assert bench.measure_device_frame_single_launch(
        fsr, cam, frames=2, reps=1
    ) > 0.0


def test_orbit_stays_in_one_octant(bench):
    """The batch orbit keeps the eye distance and height, and spans at
    most a quarter turn (one march-axis octant for the batch)."""
    from amrvolumerenderer_tpu.types import CameraParameters

    cam = CameraParameters(eye=(3.0, 1.0, 0.5), look_at=(0.5, 0.5, 0.5),
                           up=(0, 1, 0))
    center = np.array([0.5, 0.5, 0.5])
    cams = bench.orbit(cam, center, 8)
    assert len(cams) == 8 and cams[0].eye == pytest.approx(cam.eye)
    radii = [np.linalg.norm(np.asarray(c.eye) - center) for c in cams]
    assert np.allclose(radii, radii[0])
    assert all(c.eye[1] == pytest.approx(1.0) for c in cams)
    first = np.asarray(cams[0].eye) - center
    last = np.asarray(cams[-1].eye) - center
    cos = first @ last / (np.linalg.norm(first) * np.linalg.norm(last))
    assert cos > 0.0  # less than a quarter turn apart


def test_config5_entry(bench):
    """The BASELINE config-5 measurement entry (2048^2 AA=4) exists and
    its supersampled-buffer math holds on a CPU-scale stand-in: AA=4
    doubles each render-buffer dimension (VolumeRenderer.cpp:1116-1119)."""
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.types import RenderParameters

    assert callable(bench.measure_config5)
    fsr = FastSceneRenderer(
        bench.build_three_level_scene(),
        RenderParameters(width=32, height=32, antialiasing=4),
    )
    assert fsr.render_width == 64 and fsr.render_height == 64
    assert fsr.sqrt_aa == 2
