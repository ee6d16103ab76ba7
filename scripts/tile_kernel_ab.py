#!/usr/bin/env python3
"""Time the fused tile kernel (Pallas, Triton route) against the plain tile
loop on one GPU, and the layered path against the tile loop by piece count.

1. check — the kernel against the plain tile loop on a small scene, for
   nearest/post, trilinear/post and trilinear/pre (ghost ring);
2. tile loop — ``FastSceneRenderer`` at 1024^2 on the bench 3-level scene
   and on the smoke scene (three 256^3 levels in 32^3 boxes): an 8-frame
   ``render_batch`` (rgb bytes) and one ``render``, end to end, in the
   order plain / kernel / kernel / plain, plus the device time of one
   frame's tile loop;
3. crossover — the one-shot CLI path (``render_composited_slicemarch``) on
   single-level scenes of 64 to 343 32^3 boxes, layered fold against the
   tile loop (the kernel), three alternating rounds per scene.

Usage: python scripts/tile_kernel_ab.py [--skip-crossover]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
from amrvolumerenderer_tpu import api  # noqa: E402
from amrvolumerenderer_tpu import renderer_fast as rf  # noqa: E402
from amrvolumerenderer_tpu.camera import (  # noqa: E402
    auto_orbit_camera, orbit_camera_sequence,
)
from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer  # noqa: E402
from amrvolumerenderer_tpu.ops import tilemarch as tm  # noqa: E402
from amrvolumerenderer_tpu.renderer import (  # noqa: E402
    compute_global_bounds, compute_reference_sample_distance,
)
from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry  # noqa: E402
from amrvolumerenderer_tpu.types import RenderParameters  # noqa: E402

def phase_check() -> None:
    from amrvolumerenderer_tpu.camera import (
        camera_basis, compute_box_depth_hints,
    )
    from amrvolumerenderer_tpu.colormap import build_color_table
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.types import CameraParameters

    n, box, width = 32, 16, 64
    field = cs.smooth_field((n, n, n), seed=7)
    camera = CameraParameters(eye=(2.3, 1.7, 2.9), look_at=(0.5, 0.5, 0.5),
                              up=(0, 1, 0))
    forward, right, up = camera_basis(camera)
    axis = sm.choose_march_axis(forward)
    lut = build_color_table(1.0, 1.0, (0.0, 1.0), None)
    packed = jnp.asarray(sm.build_log_lut(lut))
    cam = jnp.asarray(sm.pack_camera(
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        1.0, 0.0, 1.0, 0.5 / n))
    for sampling, classification, ghost in (
        ("nearest", "post", 0), ("trilinear", "post", 1),
        ("trilinear", "pre", 1),
    ):
        pieces = []
        for i in range(0, n, box):
            for j in range(0, n, box):
                for k in range(0, n, box):
                    lo = np.array([i, j, k])
                    pieces += sm.split_brick_for_slices(
                        field[i:i + box, j:j + box, k:k + box], lo / n,
                        (lo + box) / n, axis, ghost=ghost)
        vol, meta, dims = cs._pack_pieces(pieces, axis, ghost)
        bmin = np.stack([p[1] for p in pieces])
        bmax = np.stack([p[2] for p in pieces])
        hints = compute_box_depth_hints(bmin, bmax, camera)
        offsets, tb, tw = tm.build_tile_worklist(
            bmin, bmax, hints, np.arange(len(pieces), dtype=np.int32),
            np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
            width, width)
        args = (jnp.asarray(vol), jnp.asarray(meta), jnp.asarray(dims),
                packed, cam, jnp.asarray(offsets), jnp.asarray(tb),
                jnp.asarray(tw))
        kw = dict(width=width, height=width, max_slices=vol.shape[1],
                  sampling=sampling, ghost=ghost,
                  classification=classification)
        with cs.plain_tile_loop():
            pc, pd = tm.tilemarch_render(*args, **kw)
        kc, kd = tm.tilemarch_render(*args, **kw)
        diff = float(np.abs(np.asarray(kc) - np.asarray(pc)).max())
        same = np.array_equal(np.isfinite(np.asarray(pd)),
                              np.isfinite(np.asarray(kd)))
        ok = diff <= cs.KERNEL_ATOL and same
        print(f"[{'PASS' if ok else 'FAIL'}] kernel vs plain "
              f"{sampling}/{classification} ghost={ghost} items={len(tb)} "
              f"max|diff|={diff:.3e}", flush=True)
        if not ok:
            raise SystemExit(1)


def smoke_geometry():
    levels, geoms = cs.amr_levels(0)
    data = api.AmrData(level_data=levels, level_geometry=geoms,
                       refinement_ratios=[(2, 2, 2), (2, 2, 2)])
    return api.load_amr_geometry(data, 0, -1, 0, True, True, verbose=False)


def device_frame_ms(fsr, camera, reps=10):
    """(median device ms of one frame's tile loop, work items)."""
    inputs = fsr.frame_inputs(camera)
    args = (fsr._packed_vol, inputs["meta"], inputs["dims"], fsr._lut_device,
            inputs["cam"], inputs["offsets"], inputs["bricks"],
            inputs["owners"], inputs["item_bounds"], inputs["tile_ids"])
    kw = dict(width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
              logical_width=fsr.render_width,
              logical_height=fsr.render_height,
              sampling=fsr.parameters.sampling, ghost=fsr.ghost,
              classification=fsr.parameters.classification)
    jax.block_until_ready(tm.tilemarch_render(*args, **kw))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(tm.tilemarch_render(*args, **kw))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3, int(inputs["bricks"].shape[0])


def time_variant(fsr, base, cams):
    """(first batch s, batch walls, last batch stats, render() walls,
    device ms, items, frames) for the route in force."""
    t0 = time.perf_counter()
    frames = fsr.render_batch(cams, overlay=False, bytes_out="rgb")
    first = time.perf_counter() - t0
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        frames = fsr.render_batch(cams, overlay=False, bytes_out="rgb")
        walls.append(time.perf_counter() - t0)
    stats = fsr.last_batch_stats
    fsr.render(base, overlay=False)
    singles = []
    for _ in range(5):
        t0 = time.perf_counter()
        fsr.render(base, overlay=False)
        singles.append(time.perf_counter() - t0)
    dev_ms, items = device_frame_ms(fsr, base)
    return first, walls, stats, singles, dev_ms, items, frames


def phase_tile_loop(name, geometry, size=1024) -> None:
    params = RenderParameters(width=size, height=size)
    fsr = FastSceneRenderer(geometry, params)
    base = auto_orbit_camera(fsr.bounds)
    cams = orbit_camera_sequence(base, 8)
    ref = None
    for variant in ("plain", "kernel", "kernel", "plain"):
        route = (cs.plain_tile_loop() if variant == "plain"
                 else contextlib.nullcontext())
        with route:
            first, walls, stats, singles, dev_ms, items, frames = (
                time_variant(fsr, base, cams))
        if ref is None:
            ref = frames.astype(int)
        diff = int(np.abs(frames.astype(int) - ref).max())
        print(f"{name} {size}^2 {variant}: batch8 first={first:.2f} s "
              f"median={np.median(walls) * 1e3:.2f} ms "
              f"({np.median(walls) / 8 * 1e3:.2f} ms/frame, host_prep "
              f"{stats['host_prep_ms']:.1f} ms, readback "
              f"{stats['readback_ms']:.1f} ms) render() median="
              f"{np.median(singles) * 1e3:.2f} ms device tile loop "
              f"{dev_ms:.3f} ms items={items} max|byte diff vs first "
              f"plain|={diff}", flush=True)


def box_scene(shape):
    """A single-level scene of ``shape`` cells in 32^3 boxes."""
    field = bench.radial_field(max(shape), 0.0, 1.0)
    field = field[:shape[0], :shape[1], :shape[2]]
    boxes = [LevelBox(field[i:i + 32, j:j + 32, k:k + 32],
                      np.array([i, j, k]))
             for i in range(0, shape[0], 32) for j in range(0, shape[1], 32)
             for k in range(0, shape[2], 32)]
    data = api.AmrData(level_data=[boxes],
                       level_geometry=[LevelGeometry(np.zeros(3),
                                                     np.full(3, 1.0 / max(shape)))])
    return api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False), \
        len(boxes)


# 64 to 343 pieces, dense around the crossover
CROSSOVER_SHAPES = ((128, 128, 128), (160, 160, 160), (160, 160, 192),
                    (160, 192, 192), (192, 192, 192), (224, 224, 224))


def phase_crossover(size=1024, rounds=3) -> None:
    """Median of ``rounds`` medians per path, the two paths alternating
    which runs first from round to round."""
    threshold = rf.TILEMARCH_PIECE_THRESHOLD
    params = RenderParameters(width=size, height=size)
    for shape in CROSSOVER_SHAPES:
        geometry, pieces = box_scene(shape)
        bounds = compute_global_bounds(geometry)
        rsd = compute_reference_sample_distance(geometry, bounds)
        cam = auto_orbit_camera(bounds)
        call = functools.partial(
            rf.render_composited_slicemarch, geometry, params, cam,
            (0.0, 1.0), rsd, size, size, None)
        medians = {"layered": [], "tile": []}
        frames = {}
        for r in range(rounds):
            order = ("layered", "tile") if r % 2 == 0 else ("tile", "layered")
            for path in order:
                rf.TILEMARCH_PIECE_THRESHOLD = (
                    10 ** 9 if path == "layered" else -1)
                frames[path] = call()
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    call()
                    times.append(time.perf_counter() - t0)
                medians[path].append(float(np.median(times)) * 1e3)
        diff = float(np.abs(frames["layered"][:, :4]
                            - frames["tile"][:, :4]).max())
        runs = {p: " / ".join(f"{m:.2f}" for m in medians[p])
                for p in medians}
        print(f"crossover {pieces} pieces {shape} {size}^2: layered "
              f"{np.median(medians['layered']):.2f} ms ({runs['layered']}), "
              f"tile loop {np.median(medians['tile']):.2f} ms "
              f"({runs['tile']}) (max|diff| {diff:.2e})", flush=True)
    rf.TILEMARCH_PIECE_THRESHOLD = threshold


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--skip-crossover", action="store_true")
    args = parser.parse_args()
    cs.require_gpu(1)
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    phase_check()
    phase_tile_loop("bench 3-level", bench.build_three_level_scene())
    phase_tile_loop("smoke 3-level", smoke_geometry())
    if not args.skip_crossover:
        phase_crossover()
    return 0


if __name__ == "__main__":
    sys.exit(main())
