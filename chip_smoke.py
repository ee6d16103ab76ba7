#!/usr/bin/env python3
"""Smoke run of the renderer's main path on one NVIDIA GPU.

Phases, all in this one process on the card:

1. device — the JAX device and ``nvidia-smi``'s name and power limit;
2. parity — the slice march on the card against the float64 NumPy
   reference (``slicemarch_reference``) on 32^3 and 64^3 AMReX boxes, every
   sampling x classification mode, both march signs, ghost rings 0/1 and
   bf16 storage; the fused tile kernel against the plain tile loop, and
   that against the layered fold; both tile loops with the pieces stored
   past the 2^31st cell of a 4.3 GB table;
3. golden — the single-device paths of ``tests/golden/manifest.json``
   re-rendered and compared with ``tests/golden/manifest_pixels.npz``;
4. main path — a seeded 3-level AMReX plotfile (three 256^3 levels in
   32^3 boxes, ~1,536 boxes, ~200 MB of float32 cells) through the CLI at
   1024^2, ``FastSceneRenderer.render_batch`` over an 8-frame orbit, and
   ``prepare_device_amr`` on the same fields as device arrays; frames are
   checked against the plain tile loop at 256^2.

``--four-cards`` runs only phase 5 on four cards: ``--devices 4`` through
the CLI and ``MultiChipSceneRenderer.render_batch`` (float32 and ubyte
transport, pre-blend on and off), each against the single-card render,
plus the HBM-copy / all_to_all bandwidth ratio behind
``MultiChipSceneRenderer.preblend_link_ratio``.

Each check prints PASS or FAIL with its numbers; the first failure exits
non-zero.  Without a GPU the script exits non-zero before any phase.  The
last line on success is the JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances.  The march, the tile fold and the oracle contain no matrix
# product, only elementwise float32 and integer-indexed gathers, so no
# TF32 (reduced-precision matmul) path can enter any compared number.
KERNEL_ATOL = 5e-5  # RGBA vs the float64 NumPy reference
# The golden pixels were recorded by XLA:CPU (checked there at 2e-6).  On
# the GPU, exp/log come from libdevice and XLA fuses and contracts
# (multiply-add) in another order, so the bound is 1e-5.
GOLDEN_ATOL = 1e-5
FLOAT_ATOL = 1e-5  # float32 frames of two product paths on one scene
# ubyte transport quantizes every exchanged layer to the byte codec's
# 1/255 quantum, and the fold of quantized layers can compound a second
# quantum: 2/255, the bound tests/test_persistent_multichip.py holds it to
BYTE_ATOL = 2.0 / 255.0
# device ingest (float32 statistics) vs host ingest (float64)
DEVICE_INGEST_MEAN = 1e-3
DEVICE_INGEST_Q99 = 0.02

BOX = 32  # AMReX's 3-D default max_grid_size
LEVEL_CELLS = 256  # cells per axis of every level
MAIN_SIZE = 1024  # frame edge of the main-path renders
CHECK_SIZE = 256  # frame edge of the cross-path re-renders
FOUR_CARD_SIZE = 512  # frame edge of the four-card renders
COPY_FLOATS = 1 << 28  # 1 GiB of float32 for the HBM copy rate
A2A_FLOATS = 1 << 26  # 256 MiB per device for all_to_all, 64 MiB per peer
FAR_CELL = 1 << 31  # first table cell a flat int32 offset cannot reach


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the generated scene (default 0)")
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card phase")
    return parser.parse_args(argv)


class SmokeFailure(Exception):
    pass


def check(name: str, ok: bool, detail: str = "") -> None:
    print(f"[{'PASS' if ok else 'FAIL'}] {name} {detail}".rstrip(), flush=True)
    if not ok:
        raise SmokeFailure(name)


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def require_gpu(count: int):
    """The JAX GPU devices, or exit: this script has no CPU fallback."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        print(f"chip_smoke: needs {count} GPU(s), JAX found {devices}",
              file=sys.stderr)
        raise SystemExit(2)
    return devices


def timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------


def smooth_field(shape, seed: int, modes: int = 8) -> np.ndarray:
    """Seeded smooth random field in [0, 1] on cell centers of [0, 1]^3."""
    rng = np.random.default_rng(seed)
    axes = [(np.arange(n) + 0.5) / n for n in shape]
    g = np.zeros(shape, np.float64)
    for _ in range(modes):
        k = rng.uniform(2.0, 9.0, 3) * rng.choice([-1, 1], 3)
        phase = rng.uniform(0, 2 * np.pi)
        ex, ey, ez = (np.exp(1j * k[a] * axes[a]) for a in range(3))
        g += np.real(np.exp(1j * phase) * ex[:, None, None]
                     * ey[None, :, None] * ez[None, None, :])
    g -= g.min()
    return (g / g.max()).astype(np.float32)


def amr_levels(seed: int):
    """Three 256^3 levels: level l+1 refines the central eighth of level
    l's extent by 2 (``LevelBox`` lists in BOX^3 boxes, ``LevelGeometry``).

    The field is a log-normal density: exp of a seeded smooth Gaussian-like
    field scaled to span several decades, evaluated at each level's cell
    centers in physical coordinates, so levels agree where they overlap."""
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    rng = np.random.default_rng(seed)
    modes = [(rng.uniform(3.0, 14.0, 3) * rng.choice([-1, 1], 3),
              rng.uniform(0, 2 * np.pi), rng.uniform(0.5, 1.0))
             for _ in range(12)]
    levels, geoms = [], []
    lo_phys, cell = 0.0, 1.0 / LEVEL_CELLS
    for level in range(3):
        x = lo_phys + (np.arange(LEVEL_CELLS) + 0.5) * cell
        g = np.zeros((LEVEL_CELLS,) * 3, np.float32)
        for k, phase, amp in modes:
            ex, ey, ez = (np.exp(1j * k[a] * x).astype(np.complex64)
                          for a in range(3))
            g += amp * np.real(np.exp(1j * phase)
                               * ex[:, None, None] * ey[None, :, None]
                               * ez[None, None, :])
        density = np.exp(2.0 * g).astype(np.float32)  # several decades
        origin = int(round(lo_phys / cell))
        boxes = [
            LevelBox(density[i:i + BOX, j:j + BOX, k:k + BOX],
                     np.array([origin + i, origin + j, origin + k]))
            for i in range(0, LEVEL_CELLS, BOX)
            for j in range(0, LEVEL_CELLS, BOX)
            for k in range(0, LEVEL_CELLS, BOX)
        ]
        levels.append(boxes)
        geoms.append(LevelGeometry(np.zeros(3), np.full(3, cell)))
        # next level: central eighth of this level's extent, refined x2
        lo_phys += 0.25 * LEVEL_CELLS * cell
        cell /= 2.0
    return levels, geoms


def r2_scene(n_cells: int = 16, box_size: int = 8):
    """The golden manifest's scene (tests/conftest.make_r2_scene_data)."""
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    c = np.arange(n_cells) / (n_cells - 1)
    field = (c[:, None, None] ** 2 + c[None, :, None] ** 2
             + c[None, None, :] ** 2).astype(np.float64)
    boxes = [
        LevelBox(field[i:i + box_size, j:j + box_size, k:k + box_size],
                 np.array([i, j, k]))
        for i in range(0, n_cells, box_size)
        for j in range(0, n_cells, box_size)
        for k in range(0, n_cells, box_size)
    ]
    return [boxes], [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n_cells))]


# ---------------------------------------------------------------------------
# phase 2: march parity against the NumPy reference
# ---------------------------------------------------------------------------


def _pack_pieces(pieces, axis, ghost):
    from amrvolumerenderer_tpu.ops import slicemarch as sm

    axes = [axis] + [a for a in range(3) if a != axis]
    packs = [sm.pack_slice_volume(d, axis, ghost=ghost) for d, _, _ in pieces]
    s_max = max(v.shape[0] for v, _ in packs)
    vol = np.zeros((len(pieces), s_max, sm.SUBLANES, sm.LANES), np.float32)
    meta = np.zeros((len(pieces), 12), np.float32)
    dims = np.zeros((len(pieces), 8), np.int32)
    for i, ((v, (ns, nu, nv)), (_, mn, mx)) in enumerate(zip(packs, pieces)):
        vol[i, : v.shape[0]] = v
        pmin, pmax = np.asarray(mn)[axes], np.asarray(mx)[axes]
        meta[i, 0:3], meta[i, 3:6] = pmin, pmax
        meta[i, 6:9] = (pmax - pmin) / np.array([ns, nu, nv])
        dims[i, :3] = (ns, nu, nv)
        dims[i, 3:6] = axes
        dims[i, 6] = nv + 2 * ghost
    return vol, meta, dims


def march_case(n, eye, sampling, classification, ghost, dtype, width):
    """Max |diff| of the march on the card vs the reference for one box.

    Nearest sampling never reads a ghost ring, so every piece of the split
    box is compared with the reference on that piece alone.  Trilinear
    with a ghost ring is seam-free: the split pieces, folded by per-pixel
    depth, are compared with the reference on the unsplit box.  Trilinear
    without a ring is only the product's layout for boxes that need no
    split (a 32^2 slice), and is compared there."""
    import jax.numpy as jnp

    from amrvolumerenderer_tpu.camera import camera_basis
    from amrvolumerenderer_tpu.colormap import build_color_table
    from amrvolumerenderer_tpu.compositor import composite_layers_host
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.types import CameraParameters

    data = smooth_field((n, n, n), seed=n)
    data = np.asarray(jnp.asarray(data).astype(dtype).astype(jnp.float32))
    camera = CameraParameters(eye=eye, look_at=(0.5, 0.5, 0.5),
                              up=(0.0, 1.0, 0.0))
    forward, right, up = camera_basis(camera)
    axis = sm.choose_march_axis(forward)
    lut = build_color_table(1.0, 1.0, (0.0, 1.0), None)
    packed_lut = sm.build_log_lut(lut)
    ref_distance = 0.5 / n
    bmin, bmax = np.zeros(3), np.ones(3)
    cam = sm.pack_camera(np.asarray(camera.eye), forward, right, up,
                         camera.fov_y_degrees, 1.0, 0.0, 1.0, ref_distance)
    pieces = sm.split_brick_for_slices(data, bmin, bmax, axis, ghost=ghost)

    def render(vol, meta, dims):
        luts = np.broadcast_to(packed_lut[None], (len(vol),) + packed_lut.shape)
        colors, depths = sm.slicemarch_render(
            jnp.asarray(vol).astype(dtype), jnp.asarray(meta),
            jnp.asarray(dims), jnp.asarray(luts), jnp.asarray(cam),
            width=width, height=width, max_slices=vol.shape[1],
            sampling=sampling, ghost=ghost, classification=classification,
        )
        return np.asarray(colors), np.asarray(depths)

    def reference(d, mn, mx):
        return sm.slicemarch_reference(
            d, mn, mx, axis, lut, ref_distance, np.asarray(camera.eye),
            forward, right, up, camera.fov_y_degrees, width, width,
            sampling=sampling, classification=classification,
        )[0]

    if sampling == "nearest":
        worst = 0.0
        for piece in pieces:
            core = piece[0]
            if ghost:
                core = core[ghost:-ghost, ghost:-ghost, ghost:-ghost]
            got, _ = render(*_pack_pieces([piece], axis, ghost))
            exp = reference(core, piece[1], piece[2])
            worst = max(worst, float(np.abs(got[0] - exp).max()))
        return worst, len(pieces)
    if ghost == 0 and len(pieces) > 1:
        return None, len(pieces)
    colors, depths = render(*_pack_pieces(pieces, axis, ghost))
    layers = np.concatenate([colors, depths[..., None]], axis=-1)
    k = len(pieces)
    got = composite_layers_host(layers, np.zeros(k), np.arange(k),
                                np.zeros(k, np.int32))
    exp = reference(data, bmin, bmax)
    return float(np.abs(got[:, :4] - exp).max()), k


def phase_parity() -> None:
    print("== phase 2: march parity vs float64 NumPy reference "
          f"(atol {KERNEL_ATOL:g})", flush=True)
    eyes = {"forward": (0.8, 0.62, 2.7), "backward": (0.3, 0.41, -1.7)}
    modes = [("nearest", "post"), ("trilinear", "post"), ("trilinear", "pre")]
    for n, width in ((32, 32), (64, 32)):
        for sampling, classification in modes:
            for sign, eye in eyes.items():
                for ghost in (0, 1):
                    for dtype in ("float32", "bfloat16"):
                        name = (f"{n}^3 {sampling}/{classification} {sign} "
                                f"ghost={ghost} {dtype}")
                        diff, pieces = march_case(
                            n, eye, sampling, classification, ghost, dtype,
                            width,
                        )
                        if diff is None:
                            print(f"[----] {name}: {pieces} pieces without "
                                  "a ring clamp at split seams; the product "
                                  "rings every trilinear split", flush=True)
                            continue
                        check(name, diff <= KERNEL_ATOL,
                              f"pieces={pieces} max|diff|={diff:.3e}")


class plain_tile_loop:
    """Within this context the tile loop runs its plain JAX version, not
    the fused kernel (jit caches are cleared on entry and exit, since the
    choice is made at trace time)."""

    def __enter__(self):
        import jax

        from amrvolumerenderer_tpu.ops import tilemarch as tm

        self._route = tm.use_kernel
        tm.use_kernel = lambda bricks: False
        jax.clear_caches()

    def __exit__(self, *exc):
        import jax

        from amrvolumerenderer_tpu.ops import tilemarch as tm

        tm.use_kernel = self._route
        jax.clear_caches()


TILE_CASE_SIZE = 128  # frame edge of the tile-kernel checks


def tile_scene(ghost, eye):
    """A 64^3 field in 32^3 AMReX boxes split to <= 1024-cell slices:
    (packed vol, meta, dims, LUT, camera, CSR offsets, bricks, owners,
    depth hints)."""
    from amrvolumerenderer_tpu.camera import (
        camera_basis, compute_box_depth_hints,
    )
    from amrvolumerenderer_tpu.colormap import build_color_table
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.ops import tilemarch as tm
    from amrvolumerenderer_tpu.types import CameraParameters

    n, box, width = 64, 32, TILE_CASE_SIZE
    field = smooth_field((n, n, n), seed=7)
    camera = CameraParameters(eye=eye, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0))
    forward, right, up = camera_basis(camera)
    axis = sm.choose_march_axis(forward)
    pieces = []
    for i in range(0, n, box):
        for j in range(0, n, box):
            for k in range(0, n, box):
                mn = np.array([i, j, k]) / n
                mx = np.array([i + box, j + box, k + box]) / n
                pieces += sm.split_brick_for_slices(
                    field[i:i + box, j:j + box, k:k + box], mn, mx, axis,
                    ghost=ghost)
    vol, meta, dims = _pack_pieces(pieces, axis, ghost)
    bmin = np.stack([p[1] for p in pieces])
    bmax = np.stack([p[2] for p in pieces])
    num = len(pieces)
    hints = compute_box_depth_hints(bmin, bmax, camera)
    owners = np.arange(num, dtype=np.int32)
    lut = build_color_table(1.0, 1.0, (0.0, 1.0), None)
    packed = sm.build_log_lut(lut)
    cam = sm.pack_camera(np.asarray(camera.eye), forward, right, up,
                         camera.fov_y_degrees, 1.0, 0.0, 1.0, 0.5 / n)
    offsets, tbricks, towners = tm.build_tile_worklist(
        bmin, bmax, hints, owners, np.asarray(camera.eye), forward, right,
        up, camera.fov_y_degrees, width, width,
    )
    return vol, meta, dims, packed, cam, offsets, tbricks, towners, hints


def tile_case(sampling, classification, ghost, dtype, eye):
    """(kernel vs plain tile loop, plain tile loop vs layered fold) max
    |diff| and the item count on ``tile_scene`` at 128^2."""
    import jax.numpy as jnp

    from amrvolumerenderer_tpu.compositor import composite_layers_host
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.ops import tilemarch as tm

    vol, meta, dims, packed, cam, offsets, tbricks, towners, hints = (
        tile_scene(ghost, eye))
    width, num = TILE_CASE_SIZE, len(vol)
    owners = np.arange(num, dtype=np.int32)
    args = (jnp.asarray(vol).astype(dtype), jnp.asarray(meta),
            jnp.asarray(dims), jnp.asarray(packed), jnp.asarray(cam),
            jnp.asarray(offsets), jnp.asarray(tbricks), jnp.asarray(towners))
    kw = dict(width=width, height=width, max_slices=vol.shape[1],
              sampling=sampling, ghost=ghost, classification=classification)
    kernel_c, kernel_d = tm.tilemarch_render(*args, **kw)
    with plain_tile_loop():
        plain_c, plain_d = tm.tilemarch_render(*args, **kw)
    kernel_c, plain_c = np.asarray(kernel_c), np.asarray(plain_c)
    d_kernel = float(np.abs(kernel_c - plain_c).max())
    if not np.array_equal(np.isfinite(np.asarray(kernel_d)),
                          np.isfinite(np.asarray(plain_d))):
        d_kernel = float("inf")

    tiles = width // tm.TILE_W
    tile_c = (plain_c.reshape(tiles, tiles, 4, tm.TILE_H, tm.TILE_W)
              .transpose(0, 3, 1, 4, 2).reshape(width * width, 4))
    luts = np.broadcast_to(packed[None], (num,) + packed.shape)
    colors, depths = sm.slicemarch_render(
        args[0], args[1], args[2], jnp.asarray(luts), args[4], **kw)
    layers = np.concatenate(
        [np.asarray(colors), np.asarray(depths)[..., None]], axis=-1)
    expected = composite_layers_host(layers, hints, owners,
                                     np.zeros(num, np.int32))
    d_fold = float(np.abs(tile_c - expected[:, :4]).max())
    return d_kernel, d_fold, len(tbricks)


def far_table_case():
    """(kernel, plain tile loop) max |diff| with ``tile_scene``'s pieces
    stored past the 2^31st cell of a bfloat16 table (4.3 GB), against the
    kernel on the same pieces in a table of their own.  A flat int32 cell
    offset wraps there; the row-indexed gathers must not."""
    import jax
    import jax.numpy as jnp

    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.ops import tilemarch as tm

    vol, meta, dims, packed, cam, offsets, tbricks, towners, _ = tile_scene(
        0, (2.3, 1.7, 2.9))
    num, s_max = vol.shape[:2]
    kw = dict(width=TILE_CASE_SIZE, height=TILE_CASE_SIZE, max_slices=s_max)
    small = tm.tilemarch_render(
        jnp.asarray(vol, jnp.bfloat16), jnp.asarray(meta), jnp.asarray(dims),
        jnp.asarray(packed), jnp.asarray(cam), jnp.asarray(offsets),
        jnp.asarray(tbricks), jnp.asarray(towners), **kw)[0]
    pad = -(-FAR_CELL // (s_max * sm.SLICE_CELLS))
    far = jnp.zeros((pad + num,) + vol.shape[1:], jnp.bfloat16)
    far = far.at[pad:].set(jnp.asarray(vol, jnp.bfloat16))
    far_meta = np.zeros((pad + num, 12), np.float32)
    far_meta[pad:] = meta
    far_dims = np.zeros((pad + num, 8), np.int32)
    far_dims[pad:] = dims
    args = (far, jnp.asarray(far_meta), jnp.asarray(far_dims),
            jnp.asarray(packed), jnp.asarray(cam), jnp.asarray(offsets),
            jnp.asarray(tbricks + pad), jnp.asarray(towners))
    kernel = tm.tilemarch_render(*args, **kw)[0]
    with plain_tile_loop():
        plain = tm.tilemarch_render(*args, **kw)[0]
    small = np.asarray(small)
    out = (float(np.abs(np.asarray(kernel) - small).max()),
           float(np.abs(np.asarray(plain) - small).max()), far.size)
    del far, args
    jax.clear_caches()
    return out


def phase_tile_kernel() -> None:
    """The fused tile kernel against the plain tile loop, and the plain
    tile loop (march per CSR item + run-grouped fold) against the layered
    path (dense march per brick + host fold)."""
    print("== phase 2b: tile kernel vs plain tile loop vs layered fold "
          f"(atol {KERNEL_ATOL:g})", flush=True)
    eyes = {"forward": (2.3, 1.7, 2.9), "backward": (-1.3, 0.7, -1.9)}
    modes = [("nearest", "post", 0, "float32"),
             ("nearest", "post", 0, "bfloat16"),
             ("trilinear", "post", 1, "float32"),
             ("trilinear", "pre", 1, "float32"),
             ("trilinear", "pre", 1, "bfloat16")]
    for sign, eye in eyes.items():
        for sampling, classification, ghost, dtype in modes:
            d_kernel, d_fold, items = tile_case(
                sampling, classification, ghost, dtype, eye)
            name = (f"{sampling}/{classification} {sign} ghost={ghost} "
                    f"{dtype}")
            check(f"tile kernel vs plain {name}", d_kernel <= KERNEL_ATOL,
                  f"items={items} max|diff|={d_kernel:.3e}")
            check(f"plain tile loop vs layered fold {name}",
                  d_fold <= KERNEL_ATOL,
                  f"items={items} max|diff|={d_fold:.3e}")
    d_kernel, d_plain, cells = far_table_case()
    check("tile kernel past the 2^31st table cell", d_kernel <= KERNEL_ATOL,
          f"cells={cells} max|diff|={d_kernel:.3e}")
    check("plain tile loop past the 2^31st table cell",
          d_plain <= KERNEL_ATOL, f"cells={cells} max|diff|={d_plain:.3e}")


# ---------------------------------------------------------------------------
# phase 3: golden pixels
# ---------------------------------------------------------------------------


def phase_golden(tmp: str) -> None:
    from amrvolumerenderer_tpu import api

    golden = os.path.join(ROOT, "tests", "golden")
    with open(os.path.join(golden, "manifest.json")) as f:
        manifest = json.load(f)
    stored = dict(np.load(os.path.join(golden, "manifest_pixels.npz")))
    print(f"== phase 3: golden pixels (atol {GOLDEN_ATOL:g}; the CPU suite "
          f"checks {manifest['atol']:g})", flush=True)
    levels, geoms = r2_scene()
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    for name, method in (("raymarch-1dev", "raymarch"),
                         ("slicemarch-1dev", "slicemarch"),
                         ("tilemarch-1dev", "tilemarch")):
        options = api.RenderOptions(
            width=manifest["width"], height=manifest["height"],
            output_filename=os.path.join(tmp, f"{name}.ppm"),
            render_method=method,
        )
        image, _ = api.render(data, options, verbose=False)
        got = np.asarray(image.pixels, np.float32)
        ref = stored[name]
        finite = np.isfinite(ref)
        same_pattern = bool(np.array_equal(np.isfinite(got), finite))
        diff = float(np.abs(got[finite] - ref[finite]).max())
        check(f"golden {name}", same_pattern and diff <= GOLDEN_ATOL,
              f"max|diff|={diff:.3e} background pattern "
              f"{'same' if same_pattern else 'CHANGED'}")


# ---------------------------------------------------------------------------
# phase 4: the main path at real size
# ---------------------------------------------------------------------------


def write_scene(seed: int, tmp: str):
    from amrvolumerenderer_tpu.plotfile import write_plotfile

    (levels, geoms), t_gen = timed(amr_levels, seed)
    boxes = sum(len(level) for level in levels)
    cells = sum(b.data.size for level in levels for b in level)
    path = os.path.join(tmp, f"plt_seed{seed}")
    _, t_write = timed(write_plotfile, path, levels, geoms,
                       ref_ratios=[2, 2])
    print(f"scene: 3 levels, {boxes} boxes of {BOX}^3, {cells} cells "
          f"({cells * 4 / 1e6:.0f} MB float32); generated in {t_gen:.1f} s, "
          f"plotfile written in {t_write:.1f} s", flush=True)
    return levels, geoms, path


def load_like_cli(path: str):
    from amrvolumerenderer_tpu.api import apply_scalar_override_and_colormap
    from amrvolumerenderer_tpu.driver import load_plotfile_geometry

    geometry = load_plotfile_geometry(path, "", 0, -1, True, verbose=False)
    cmap = apply_scalar_override_and_colormap(geometry, None, None, True)
    return geometry, cmap


def phase_main(seed: int, tmp: str, card: str) -> None:
    import jax.numpy as jnp

    from amrvolumerenderer_tpu import driver
    from amrvolumerenderer_tpu.camera import (
        auto_orbit_camera, orbit_camera_sequence,
    )
    from amrvolumerenderer_tpu.device_scene import prepare_device_amr
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.io import load_png
    from amrvolumerenderer_tpu.renderer import (
        compute_global_bounds, render_scene,
    )
    from amrvolumerenderer_tpu.types import RenderParameters

    size = MAIN_SIZE
    print(f"== phase 4: main path at {size}^2 (times informational, on "
          f"{card})", flush=True)
    levels, geoms, path = write_scene(seed, tmp)
    png = os.path.join(tmp, "cli.png")
    rc, t_cli = timed(driver.main, [
        "--width", str(size), "--height", str(size), "--log-scale",
        "--output", png, path,
    ])
    check(f"CLI {size}^2 render", rc == 0, f"rc={rc} wall={t_cli:.2f} s")
    img, w, h = load_png(png)
    check("CLI PNG", (w, h) == (size, size) and img.max() > 0.1
          and (img.max(axis=-1) > 0).mean() > 0.05,
          f"{w}x{h} lit={(img.max(axis=-1) > 0).mean():.3f}")

    geometry, cmap = load_like_cli(path)
    bounds = compute_global_bounds(geometry)
    base = auto_orbit_camera(bounds)
    cameras = orbit_camera_sequence(base, 8)

    params = RenderParameters(width=size, height=size)
    fsr, t_prep = timed(FastSceneRenderer, geometry, params, color_map=cmap)
    frames, t_first = timed(fsr.render_batch, cameras, overlay=False,
                            bytes_out="rgb")
    frames, t_warm = timed(fsr.render_batch, cameras, overlay=False,
                           bytes_out="rgb")
    lit = float((frames.max(axis=-1) > 0).mean())
    check("render_batch 8-frame orbit, rgb bytes",
          frames.shape == (8, size * size, 3) and lit > 0.05,
          f"shape={frames.shape} lit={lit:.3f} prepare={t_prep:.2f} s "
          f"first={t_first:.2f} s warm={t_warm:.3f} s "
          f"({t_warm / 8 * 1e3:.1f} ms/frame)")

    # the CLI's PNG against the persistent renderer's frame 0, both with
    # the wireframe overlay and the same 8-bit encoding
    fsr_png = os.path.join(tmp, "fsr.png")
    fsr.render(base, output_filename=fsr_png)
    img_fsr, _, _ = load_png(fsr_png)
    diff = int(np.abs(img.astype(int) - img_fsr.astype(int)).max())
    check("CLI PNG vs FastSceneRenderer PNG", diff <= 1,
          f"max|diff|={diff} byte(s)")

    # device ingest: the same fields as device arrays
    dev_levels = [[(jnp.asarray(b.data), b.lo) for b in level]
                  for level in levels]
    small = RenderParameters(width=CHECK_SIZE, height=CHECK_SIZE)
    dev, t_dev = timed(prepare_device_amr, dev_levels, geoms,
                       refinement_ratios=[(2, 2, 2), (2, 2, 2)],
                       parameters=small, log_scale_input=True)
    print(f"prepare_device_amr: {dev.canonical.shape[0]} pieces in "
          f"{t_dev:.2f} s", flush=True)

    # re-render of every path on one camera at CHECK_SIZE
    cam_dev = auto_orbit_camera(dev.bounds)
    # the CLI's fused path ("auto" resolves to it on an accelerator)
    image, _ = render_scene(os.path.join(tmp, "cli_check.ppm"), small,
                            geometry, camera=base, color_map=cmap,
                            verbose=False, method="slicemarch")
    cli_px = np.asarray(image.pixels)
    fsr_small = FastSceneRenderer(geometry, small, color_map=cmap)
    fsr_px = fsr_small.render(base)
    batch = fsr_small.render_batch(cameras, overlay=False, bytes_out="rgb")
    dev_px = dev.render(cam_dev)
    # the plain path: the same renderer with the plain JAX tile loop
    with plain_tile_loop():
        plain_px = fsr_small.render(base)
        plain_batch = fsr_small.render_batch(cameras, overlay=False,
                                             bytes_out="rgb")
    d0 = float(np.abs(fsr_px[:, :4] - plain_px[:, :4]).max())
    check("FastSceneRenderer vs plain tile loop", d0 <= KERNEL_ATOL,
          f"max|diff|={d0:.3e}")
    d0b = int(np.abs(batch.astype(int) - plain_batch.astype(int)).max())
    check("render_batch rgb bytes vs plain tile loop", d0b <= 1,
          f"max|diff|={d0b} byte(s)")
    d1 = float(np.abs(cli_px[:, :4] - plain_px[:, :4]).max())
    check("CLI path vs plain tile loop", d1 <= KERNEL_ATOL,
          f"max|diff|={d1:.3e}")
    # the device ingest computes its statistics and pre-transform in
    # float32 (the host path in float64), so a value on a LUT-bin edge may
    # shift one bin: the bound of tests/test_multilevel.py, on the mean and
    # the 99th percentile of the per-pixel difference
    d2 = np.abs(dev_px[:, :4] - fsr_px[:, :4])
    check("prepare_device_amr vs FastSceneRenderer",
          d2.mean() < DEVICE_INGEST_MEAN and np.quantile(d2, 0.99)
          < DEVICE_INGEST_Q99,
          f"mean|diff|={d2.mean():.3e} q99={np.quantile(d2, 0.99):.3e} "
          f"max|diff|={d2.max():.3e}")


# ---------------------------------------------------------------------------
# phase 5: four cards
# ---------------------------------------------------------------------------


def link_ratio() -> float:
    """HBM copy GB/s over all_to_all GB/s per peer, on this mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from amrvolumerenderer_tpu.parallel.directsend import make_mesh

    x = jnp.ones((COPY_FLOATS,), jnp.float32)
    copy = jax.jit(lambda a: a * 1.0001)
    copy(x).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(10):
        y = copy(x)
    y.block_until_ready()
    hbm = 2 * x.nbytes * 10 / (time.perf_counter() - t0) / 1e9
    del x, y

    mesh = make_mesh(4)
    axis = mesh.axis_names
    m = A2A_FLOATS
    shard = NamedSharding(mesh, P(axis))
    xs = jax.device_put(jnp.ones((4 * 4, m // 4), jnp.float32), shard)
    a2a = jax.jit(jax.shard_map(
        lambda b: jax.lax.all_to_all(b, axis, 0, 0, tiled=True),
        mesh=mesh, in_specs=P(axis), out_specs=P(axis)))
    a2a(xs).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(10):
        ys = a2a(xs)
    ys.block_until_ready()
    per_peer = (m // 4) * 4 * 10 / (time.perf_counter() - t0) / 1e9
    ratio = hbm / per_peer
    print(f"bandwidth: HBM copy {hbm:.1f} GB/s, all_to_all {per_peer:.1f} "
          f"GB/s per peer, ratio {ratio:.2f}", flush=True)
    return ratio


def phase_four_cards(seed: int, tmp: str, card: str) -> None:
    from amrvolumerenderer_tpu import driver
    from amrvolumerenderer_tpu.camera import (
        auto_orbit_camera, orbit_camera_sequence,
    )
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.io import load_png
    from amrvolumerenderer_tpu.parallel.persistent import (
        MultiChipSceneRenderer,
    )
    from amrvolumerenderer_tpu.renderer import compute_global_bounds
    from amrvolumerenderer_tpu.types import RenderParameters

    print(f"== phase 5: four cards ({card})", flush=True)
    _levels, _geoms, path = write_scene(seed, tmp)
    size = FOUR_CARD_SIZE
    outs = {}
    for devices in ("1", "4"):
        png = os.path.join(tmp, f"cli{devices}.png")
        rc, t = timed(driver.main, [
            "--width", str(size), "--height", str(size), "--log-scale",
            "--render-method", "slicemarch", "--devices", devices,
            "--output", png, path,
        ])
        check(f"CLI --devices {devices}", rc == 0, f"rc={rc} wall={t:.2f} s")
        outs[devices] = load_png(png)[0].astype(int)
    diff = int(np.abs(outs["1"] - outs["4"]).max())
    check("CLI --devices 4 vs 1 (PNG)", diff <= 1, f"max|diff|={diff} byte(s)")

    geometry, cmap = load_like_cli(path)
    params = RenderParameters(width=size, height=size)
    cams = orbit_camera_sequence(
        auto_orbit_camera(compute_global_bounds(geometry)), 4)
    single = FastSceneRenderer(geometry, params, color_map=cmap)
    ref = single.render_batch(cams, overlay=False)
    for transport, atol in (("float32", FLOAT_ATOL), ("ubyte", BYTE_ATOL)):
        mc = MultiChipSceneRenderer(geometry, params, num_devices=4,
                                    color_map=cmap, transport=transport)
        for preblend in (True, False):
            mc._use_preblend = lambda rmax, _p=preblend: _p
            got, t = timed(mc.render_batch, cams, overlay=False)
            diff = float(np.abs(got[..., :4] - ref[..., :4]).max())
            check(f"MultiChipSceneRenderer {transport} preblend={preblend}",
                  diff <= atol + 1e-6,
                  f"max|diff|={diff:.3e} (atol {atol:.2e}) wall={t:.2f} s")
    link_ratio()


def main(argv=None) -> int:
    args = parse_args(argv)
    count = 4 if args.four_cards else 1
    devices = require_gpu(count)
    card = card_line()
    print("== phase 1: device", flush=True)
    print(f"jax devices: {devices}", flush=True)
    print(f"device_kind: {devices[0].device_kind}", flush=True)
    print(f"nvidia-smi: {card}", flush=True)
    tmp = os.path.join(ROOT, ".smoke")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        if args.four_cards:
            phase_four_cards(args.seed, tmp, card)
        else:
            phase_parity()
            phase_tile_kernel()
            phase_golden(tmp)
            phase_main(args.seed, tmp, card)
    except SmokeFailure as failure:
        print(f"chip_smoke: FAILED at {failure}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
