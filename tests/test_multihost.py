"""Multi-host execution: the product runs across REAL separate processes.

The reference is deployed by launching one binary per node under ``mpirun``
(VolumeRenderer/main.cpp:19-36).  The JAX equivalent is one Python
process per host joined by ``jax.distributed.initialize``
(driver.maybe_initialize_distributed), after which ``jax.devices()`` spans
all hosts and the compositing mesh is shaped host-major
(renderer_fast.py n_hosts / parallel.directsend.make_mesh dcn_size).

This test actually EXECUTES that path: two OS processes, each owning 4
virtual CPU devices, joined through a localhost coordinator with gloo
cross-process collectives, rendering the same plotfile through the real
CLI entry (``python -m amrvolumerenderer_tpu.driver``).  Rank 0's saved
image must be byte-identical to a single-process 8-device render — the
same program, re-partitioned across process boundaries, may not change a
single pixel byte.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from amrvolumerenderer_tpu.plotfile import write_plotfile
from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry


@pytest.fixture
def plotfile(tmp_path):
    """16^3 r2 field split into 8 bricks so every mesh device owns work."""
    n = 16
    coords = np.arange(n) / (n - 1)
    field = (
        coords[:, None, None] ** 2
        + coords[None, :, None] ** 2
        + coords[None, None, :] ** 2
    )
    boxes = []
    for i0 in range(0, n, 8):
        for j0 in range(0, n, 8):
            for k0 in range(0, n, 8):
                boxes.append(
                    LevelBox(
                        field[i0 : i0 + 8, j0 : j0 + 8, k0 : k0 + 8],
                        np.array([i0, j0, k0]),
                    )
                )
    geom = LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))
    path = str(tmp_path / "plt00000")
    write_plotfile(path, [boxes], [geom], var_names=["density"])
    return path


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_rank(rank, port, plotfile, cwd, devices_per_proc=4):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices_per_proc}"
    )
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["JAX_NUM_PROCESSES"] = "2"
    env["JAX_PROCESS_ID"] = str(rank)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    return subprocess.Popen(
        [
            sys.executable,
            "-m",
            "amrvolumerenderer_tpu.driver",
            plotfile,
            "--devices",
            "8",
            "--width",
            "32",
            "--height",
            "32",
            "--render-method",
            "slicemarch",
            "--output",
            "mh.ppm",
        ],
        cwd=cwd,
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )


def test_two_process_render_matches_single_process(plotfile, tmp_path):
    port = _free_port()
    procs = [_spawn_rank(r, port, plotfile, str(tmp_path)) for r in (0, 1)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    assert procs[0].returncode == 0, logs[0]
    assert procs[1].returncode == 0, logs[1]
    # the distributed runtime actually came up: 2 processes, 8 devices
    assert "distributed runtime up — 2 host(s), 8 device(s)" in logs[0]
    # only rank 0 saves (renderer.py process_index guard)
    assert "Saved volume composited image" in logs[0]
    assert "Saved volume composited image" not in logs[1]

    mh = (tmp_path / "mh.ppm").read_bytes()

    # single-process reference: same CLI, 8 in-process virtual devices
    from amrvolumerenderer_tpu.driver import main

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main(
            [
                plotfile,
                "--devices",
                "8",
                "--width",
                "32",
                "--height",
                "32",
                "--render-method",
                "slicemarch",
                "--output",
                "sp.ppm",
            ]
        )
    finally:
        os.chdir(cwd)
    assert rc == 0
    sp = (tmp_path / "sp.ppm").read_bytes()
    assert mh == sp  # byte-identical across the process repartition
