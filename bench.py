"""Headline benchmark: multi-level AMR frame on one GPU, one JSON line.

Builds a genuine 3-level AMR hierarchy (64^3 base + two 2x refinements,
flattened by ``convexify`` exactly like the product path,
VolumeRenderer.cpp:670) and renders it at 1024^2 through the persistent
scene renderer (fast_scene.FastSceneRenderer -> ops/tilemarch.py).

Reported numbers (all in the one JSON line; "extra" keys):
  value / frame_ms ......... device time of one composited frame: F frames
                             in one launch, median wall time with
                             ``block_until_ready`` divided by F
  frame_ms_single_launch ... the same with one frame per launch
  mrays_per_s .............. primary rays retired per second
  host_prep_ms ............. per-frame host work from the persistent-scene
                             path: work list, slice bounds, depth sort,
                             camera packing (FastSceneRenderer.frame_inputs)
  frame_ms_e2e ............. one full render() call: host prep + dispatch +
                             device + [W*H,5] f32 readback
                             (VolumeRenderer.cpp:1121-1136 times stages the
                             same way: paint + visibility + compositing)
  frame_ms_e2e_batch8* ..... render_batch of an 8-frame orbit, per frame
  exchange_mb_f32/ubyte .... per-frame exchange payload of the 8-device
                             depth-contiguous pipeline on THIS scene with
                             the coverage-rect compaction
                             (parallel/directsend.py:479-511)

Needs a GPU: without one it exits non-zero and prints no result.  Prints
ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"} where
vs_baseline = 50 ms / frame_ms.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

TARGET_MS = 50.0
EXCHANGE_DEVICES = 8  # payload model for the multi-chip estimate


def radial_field(n: int, lo: float, hi: float) -> np.ndarray:
    """Smooth two-shell density over [lo,hi]^3 cell centers (values ~[0,1]):
    structure at every refinement level, nothing degenerate to cull."""
    c = lo + (np.arange(n) + 0.5) / n * (hi - lo)
    r = np.sqrt(
        (c[:, None, None] - 0.5) ** 2
        + (c[None, :, None] - 0.5) ** 2
        + (c[None, None, :] - 0.5) ** 2
    )
    f = np.exp(-((r - 0.18) / 0.06) ** 2) + 0.7 * np.exp(-((r - 0.38) / 0.05) ** 2)
    return f.astype(np.float64)


def build_three_level_scene():
    """64^3 base over [0,1]^3; 2x refinement over the central half; another
    2x over the central quarter — flattened through the product ingestion
    path (api.load_amr_geometry -> convexify -> build_scene_geometry)."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    n = 64
    level0 = [LevelBox(radial_field(n, 0.0, 1.0), np.zeros(3, dtype=int))]
    # level 1: [0.25, 0.75]^3 = 64^3 cells at 1/128, lo index 32
    level1 = [LevelBox(radial_field(n, 0.25, 0.75), np.full(3, 32, dtype=int))]
    # level 2: [0.375, 0.625]^3 = 64^3 cells at 1/256, lo index 96
    level2 = [LevelBox(radial_field(n, 0.375, 0.625), np.full(3, 96, dtype=int))]
    geoms = [
        LevelGeometry(np.zeros(3), np.full(3, 1.0 / n)),
        LevelGeometry(np.zeros(3), np.full(3, 1.0 / (2 * n))),
        LevelGeometry(np.zeros(3), np.full(3, 1.0 / (4 * n))),
    ]
    data = api.AmrData(
        level_data=[level0, level1, level2],
        level_geometry=geoms,
        refinement_ratios=[(2, 2, 2), (2, 2, 2)],
    )
    return api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)


def build_shell_scene():
    """Single-level 128^3 domain (64 bricks of 32^3) holding a thin
    spherical shell: most cubes cull on transparency and the occupied-slice
    bounds trim the rest, so rays retire few samples — the scene class
    where the >=1 Gray/s north star is about ray-setup rate, not sample
    math throughput."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    n = 128
    c = (np.arange(n) + 0.5) / n
    r = np.sqrt(
        (c[:, None, None] - 0.5) ** 2
        + (c[None, :, None] - 0.5) ** 2
        + (c[None, None, :] - 0.5) ** 2
    )
    f = np.exp(-((r - 0.40) / 0.015) ** 2).astype(np.float64)
    boxes = [
        LevelBox(f[i:i + 32, j:j + 32, k:k + 32],
                 np.array([i, j, k], dtype=int))
        for i in range(0, n, 32)
        for j in range(0, n, 32)
        for k in range(0, n, 32)
    ]
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]
    data = api.AmrData(level_data=[boxes], level_geometry=geoms)
    return api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)


def _tile_loop_args(fsr, inputs, frames: int = 0):
    """Device arguments of ``tilemarch_render`` (``frames == 0``) or of
    ``tilemarch_render_batch`` with one frame's tables repeated."""
    import jax.numpy as jnp

    tables = (inputs["cam"], inputs["offsets"], inputs["bricks"],
              inputs["owners"], inputs["item_bounds"], inputs["tile_ids"])
    if frames:
        tables = tuple(
            jnp.asarray(np.repeat(np.asarray(t)[None], frames, axis=0))
            for t in tables
        )
    else:
        tables = tuple(jnp.asarray(t) for t in tables)
    return (fsr._packed_vol, jnp.asarray(inputs["meta"]),
            jnp.asarray(inputs["dims"]), fsr._lut_device) + tables


def _tile_loop_kw(fsr):
    return dict(
        width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
        logical_width=fsr.render_width, logical_height=fsr.render_height,
        sampling=fsr.parameters.sampling, ghost=fsr.ghost,
        classification=fsr.parameters.classification,
    )


def _median_ms(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def measure_device_frame(fsr, camera, reps: int = 10) -> float:
    """Device time of one frame's tile loop (march + fold), one launch
    per frame: the median of ``reps`` timed calls, each waited on with
    ``block_until_ready``."""
    from amrvolumerenderer_tpu.ops import tilemarch as tm

    args = _tile_loop_args(fsr, fsr.frame_inputs(camera, as_numpy=True))
    kw = _tile_loop_kw(fsr)
    return _median_ms(lambda: tm.tilemarch_render(*args, **kw), reps)


def measure_device_frame_single_launch(fsr, camera, frames: int = 8,
                                       reps: int = 5) -> float:
    """Per-frame device time with ``frames`` frames in ONE launch
    (``tilemarch_render_batch``, the ``render_batch`` program): the
    median launch time divided by ``frames``."""
    from amrvolumerenderer_tpu.ops import tilemarch as tm

    args = _tile_loop_args(
        fsr, fsr.frame_inputs(camera, as_numpy=True), frames
    )
    kw = _tile_loop_kw(fsr)
    return _median_ms(
        lambda: tm.tilemarch_render_batch(*args, **kw), reps
    ) / frames


def exchange_payload_bytes(fsr, camera, num_devices: int):
    """Static per-frame link payload of the depth-contiguous multi-device
    pipeline on this scene: (D-1) rect-compacted frames cross the links per
    all_to_all round (render_depth_contiguous_slicemarch).  Returns
    (bytes_f32, bytes_ubyte, rect_fraction)."""
    from amrvolumerenderer_tpu.camera import camera_basis
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.parallel.directsend import coverage_rect

    forward, right, up = camera_basis(camera)
    _wb, _wt, coverage = sm.compute_worklist(
        fsr.box_min, fsr.box_max, np.asarray(camera.eye), forward, right, up,
        camera.fov_y_degrees, fsr.pad_w, fsr.pad_h,
        logical_width=fsr.render_width, logical_height=fsr.render_height,
    )
    rect = coverage_rect(
        coverage, fsr.pad_w, fsr.pad_h, sm.TILE_W, sm.TILE_H, num_devices
    )
    rect_px = rect[2] * rect[3] if rect else fsr.pad_w * fsr.pad_h
    frac = rect_px / float(fsr.render_width * fsr.render_height)
    shards = num_devices - 1  # the self-chunk never crosses a link
    bytes_f32 = shards * rect_px * 5 * 4  # rgba + depth, f32
    bytes_ubyte = shards * rect_px * (4 * 1 + 4)  # rgba bytes + f32 depth
    return bytes_f32, bytes_ubyte, frac


def measure_config5(geometry, budget_left):
    """BASELINE config 5 (VERDICT r4 #4): 2048^2 AA=4 — a 4096^2
    supersampled render buffer (VolumeRenderer.cpp:1116-1119), 16x the
    headline pixel count, 335 MB of frame buffers.  Returns
    (frame_ms, batch_split | None)."""
    import dataclasses as dc

    from amrvolumerenderer_tpu.camera import auto_orbit_camera
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.types import RenderParameters

    fsr = FastSceneRenderer(
        geometry, RenderParameters(width=2048, height=2048, antialiasing=4)
    )
    camera = auto_orbit_camera(fsr.bounds)
    frame_ms = measure_device_frame(fsr, camera, reps=5)

    batch_split = None
    if budget_left():
        B = 4
        center = 0.5 * (fsr.bounds.min_corner + fsr.bounds.max_corner)
        base = np.asarray(camera.eye) - center
        orbit = []
        for k in range(B):
            ang = 2 * np.pi * k / (4 * B)
            c, s = np.cos(ang), np.sin(ang)
            eye = center + np.array([
                c * base[0] + s * base[2], base[1],
                -s * base[0] + c * base[2],
            ])
            orbit.append(dc.replace(camera, eye=(eye[0], eye[1], eye[2])))
        fsr.render_batch(orbit, overlay=False, bytes_out=True)  # warm
        t0 = time.perf_counter()
        fsr.render_batch(orbit, overlay=False, bytes_out=True)
        total_ms = (time.perf_counter() - t0) * 1e3
        batch_split = dict(fsr.last_batch_stats)
        batch_split["wall_ms_per_frame"] = round(total_ms / B, 2)
    return frame_ms, batch_split


def measure_host_prep_512():
    """Cold/warm prepare_slicemarch_scene wall clock on a 512-brick scene
    (256^3 domain in 32^3 bricks) — host-only, no device involvement."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.camera import auto_orbit_camera
    from amrvolumerenderer_tpu.renderer import (
        compute_global_bounds,
        compute_reference_sample_distance,
    )
    from amrvolumerenderer_tpu.renderer_fast import prepare_slicemarch_scene
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry
    from amrvolumerenderer_tpu.types import RenderParameters

    n, bs = 256, 32
    field = radial_field(n, 0.0, 1.0).astype(np.float32)
    boxes = [
        LevelBox(field[i:i + bs, j:j + bs, k:k + bs],
                 np.array([i, j, k], dtype=int))
        for i in range(0, n, bs)
        for j in range(0, n, bs)
        for k in range(0, n, bs)
    ]
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]
    data = api.AmrData(level_data=[boxes], level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True,
                                     verbose=False)
    params = RenderParameters(width=1024, height=1024)
    bounds = compute_global_bounds(geometry)
    rsd = compute_reference_sample_distance(geometry, bounds)
    camera = auto_orbit_camera(bounds)

    t0 = time.perf_counter()
    prepare_slicemarch_scene(
        geometry, params, camera, (0.0, 1.0), rsd, 1024, 1024, None
    )
    cold = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        prepare_slicemarch_scene(
            geometry, params, camera, (0.0, 1.0), rsd, 1024, 1024, None
        )
    warm = (time.perf_counter() - t0) * 1e3 / reps
    return round(cold, 1), round(warm, 2)


def orbit(camera, center, count: int):
    """``count`` cameras on a quarter orbit about the vertical axis (one
    march-axis octant)."""
    base = np.asarray(camera.eye) - center
    cams = []
    for k in range(count):
        ang = 2 * np.pi * k / (4 * count)
        c, s = np.cos(ang), np.sin(ang)
        eye = center + np.array(
            [c * base[0] + s * base[2], base[1], -s * base[0] + c * base[2]]
        )
        cams.append(dataclasses.replace(camera, eye=tuple(eye)))
    return cams


def batch_ms_per_frame(fsr, cameras, bytes_out, reps: int = 3):
    """(median render_batch wall time per frame, stats of the last run)."""
    fsr.render_batch(cameras, overlay=False, bytes_out=bytes_out)  # warm
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fsr.render_batch(cameras, overlay=False, bytes_out=bytes_out)
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)) * 1e3 / len(cameras), dict(
        fsr.last_batch_stats
    )


def main() -> int:
    import jax

    from amrvolumerenderer_tpu.camera import auto_orbit_camera
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.types import (
        RenderParameters,
        color_map_from_tuples,
    )
    from amrvolumerenderer_tpu.utils.compile_cache import (
        enable_persistent_compile_cache,
    )

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {devices}", file=sys.stderr)
        return 2
    enable_persistent_compile_cache()
    width = height = 1024

    geometry = build_three_level_scene()
    fsr = FastSceneRenderer(geometry, RenderParameters(width=width,
                                                       height=height))
    camera = auto_orbit_camera(fsr.bounds)

    # ---- per-frame host work (persistent-scene path) --------------------
    fsr.frame_inputs(camera)  # first call also packs the march axis
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        fsr.frame_inputs(camera)
    host_prep_ms = (time.perf_counter() - t0) * 1e3 / reps

    # ---- device-only composited frame ----------------------------------
    frame_ms_single = measure_device_frame(fsr, camera)
    frame_ms = measure_device_frame_single_launch(fsr, camera)
    mrays_per_s = fsr.render_width * fsr.render_height / frame_ms / 1e3

    # ---- end-to-end render() wall clock (host + dispatch + readback) ----
    fsr.render(camera, overlay=False)  # warm
    e2e = []
    for _ in range(5):
        t0 = time.perf_counter()
        fsr.render(camera, overlay=False)
        e2e.append(time.perf_counter() - t0)
    frame_ms_e2e = float(np.median(e2e)) * 1e3

    # ---- batched animation path: 8 frames, byte-coded readback ----------
    center = 0.5 * (fsr.bounds.min_corner + fsr.bounds.max_corner)
    cams = orbit(camera, center, 8)
    frame_ms_e2e_batch, batch_stats = batch_ms_per_frame(fsr, cams, True)
    frame_ms_e2e_batch_rgb, _ = batch_ms_per_frame(fsr, cams, "rgb")

    # ---- kernel sample throughput ---------------------------------------
    # (tile pixels x occupied slices) summed over the work list, per
    # second: the scene-independent rate the march loop retires
    occ = fsr.frame_inputs(camera, as_numpy=True)["item_bounds"].astype(
        np.int64
    )
    occupied_slices = np.maximum((occ & 0xFFFF) - (occ >> 16), 0)
    samples_per_frame = float(occupied_slices.sum()) * 1024
    gsamples_per_s = samples_per_frame / frame_ms / 1e6

    # ---- sparse-shell scene, default and transparent-range TF -----------
    shell_fsr = FastSceneRenderer(
        build_shell_scene(), RenderParameters(width=width, height=height)
    )
    shell_cam = auto_orbit_camera(shell_fsr.bounds)
    shell_ms = measure_device_frame_single_launch(shell_fsr, shell_cam)
    shell_fsr.set_transfer_function(color_map=color_map_from_tuples([
        (0.0, 0, 0, 0, 0.0), (0.3, 0, 0, 0, 0.0),
        (0.5, 1.0, 0.5, 0.2, 0.4), (1.0, 1.0, 1.0, 1.0, 0.8),
    ]))
    shell_tf_ms = measure_device_frame_single_launch(shell_fsr, shell_cam)

    # ---- BASELINE config 5: 2048^2 AA=4 (4096^2 render buffer) ----------
    cfg5_ms, cfg5_split = measure_config5(geometry, lambda: True)

    # ---- multi-device exchange payload model -----------------------------
    bytes_f32, bytes_ubyte, rect_frac = exchange_payload_bytes(
        fsr, camera, EXCHANGE_DEVICES
    )

    # ---- host prep at 512 bricks (one-shot product path) -----------------
    prep512_cold_ms, prep512_warm_ms = measure_host_prep_512()

    def split(stats):
        return {k: round(v, 3) if isinstance(v, float) else v
                for k, v in stats.items()}

    extra = {
        "scene": (
            f"3-level AMR (convexify), {fsr.canonical.shape[0]} "
            f"pieces, {width}x{height}"
        ),
        "device": f"{devices[0].device_kind} x{len(devices)}",
        "mrays_per_s": round(mrays_per_s, 1),
        "gsamples_per_s": round(gsamples_per_s, 2),
        "frame_ms_single_launch": round(frame_ms_single, 3),
        "sparse_shell_frame_ms": round(shell_ms, 3),
        "sparse_shell_tf_frame_ms": round(shell_tf_ms, 3),
        "host_prep_ms": round(host_prep_ms, 2),
        "host_prep_512_cold_ms": prep512_cold_ms,
        "host_prep_512_warm_ms": prep512_warm_ms,
        "frame_ms_e2e": round(frame_ms_e2e, 2),
        "frame_ms_e2e_batch8": round(frame_ms_e2e_batch, 2),
        "frame_ms_e2e_batch8_rgb": round(frame_ms_e2e_batch_rgb, 2),
        "e2e_batch8_split": split(batch_stats),
        "frame_ms_2048_aa4": round(cfg5_ms, 2),
        "e2e_2048_aa4_batch4_split": split(cfg5_split or {}),
        "exchange_mb_f32": round(bytes_f32 / 1e6, 2),
        "exchange_mb_ubyte": round(bytes_ubyte / 1e6, 2),
        "exchange_rect_fraction": round(rect_frac, 3),
        "exchange_devices": EXCHANGE_DEVICES,
    }
    print(json.dumps({
        "metric": "amr_frame_1024_composited",
        "value": round(frame_ms, 3),
        "unit": "ms",
        "vs_baseline": round(TARGET_MS / frame_ms, 3),
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
