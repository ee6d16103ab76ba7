"""Device-resident in-situ ingestion: render JAX arrays without host copies.

The reference's in-situ API consumes GPU-resident MultiFabs directly
(VolumeRendererApi.cpp:44-148: stats via GPU ParReduce, data stays on
device).  This module is the JAX counterpart: simulation output living in
device memory as ``jax.numpy`` arrays flows through scalar statistics, the scene
transform, pre-transformation, cube splitting and canonical packing as
jitted device ops — only O(bricks) metadata ever touches the host.

Entry point: ``prepare_device_scene`` -> a ``FastSceneRenderer`` whose
canonical brick table was assembled on device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .colormap import SOFT_CLIP_TOLERANCE
from .scene import _make_scalar_range
from .transforms import soft_tail
from .types import (
    Brick,
    ColorMap,
    RenderParameters,
    SceneGeometry,
    VolumeBounds,
)


def _stats_reduce(flat: jnp.ndarray):
    """(min, max, min-positive, finite-count) of one flat sample array."""
    v = flat.astype(jnp.float32)
    finite = jnp.isfinite(v)
    safe = jnp.where(finite, v, 0.0)
    return (
        jnp.where(finite, safe, jnp.inf).min(),
        jnp.where(finite, safe, -jnp.inf).max(),
        jnp.where(finite & (v > 0.0), safe, jnp.inf).min(),
        finite.sum(),
    )


@jax.jit
def _stats_accumulate(acc, data):
    """Fold one array's stats into the running (min, max, min-positive,
    count): one small program per array shape, whatever the brick count."""
    part = _stats_reduce(data)
    return (
        jnp.minimum(acc[0], part[0]),
        jnp.maximum(acc[1], part[1]),
        jnp.minimum(acc[2], part[2]),
        acc[3] + part[3],
    )


def device_scalar_stats(arrays: Sequence[jnp.ndarray]):
    """min / max / min-positive / finite-count via device reductions
    (the jnp counterpart of SceneBuilder.cpp:53-101).  The running
    reduction stays on the device; one 4-scalar readback at the end."""
    f32 = jnp.float32
    acc = (f32(np.inf), f32(-np.inf), f32(np.inf), jnp.int32(0))
    for a in arrays:
        acc = _stats_accumulate(acc, a)
    min_v, max_v, min_pos, count = jax.device_get(acc)
    return float(min_v), float(max_v), float(min_pos), int(count)


@functools.partial(jax.jit, static_argnames=("log_scale", "normalize", "clip"))
def _pretransform_jit(data, scalars, *, log_scale, normalize, clip):
    """``scalars`` = (floor, norm_min, inv_span, clip_start, clip_span) as
    traced float32, so one program serves every data range."""
    floor, norm_min, inv_span, clip_start, clip_span = scalars
    v = data.astype(jnp.float32)
    v = jnp.where(jnp.isfinite(v), v, 0.0)
    if log_scale:
        v = jnp.log(jnp.where(v > 0.0, jnp.maximum(v, floor), floor))
    if normalize:
        v = jnp.clip((v - norm_min) * inv_span, 0.0, 1.0)
    if clip:
        v = soft_tail(v, clip_start, 1.0, clip_span)
    return v


def _pretransform_device(
    data: jnp.ndarray, transform, clip_start: float, apply_clip: bool
) -> jnp.ndarray:
    """Device version of renderer_fast._pretransform (VolumeTypes.hpp:53-67
    + VolumePainter.cpp:75-105): one jitted program per brick shape, the
    range scalars passed as data.  Callers set ``apply_clip`` only where
    ``clip_start`` lies a tolerance below 1, so the tail rolls off to 1."""
    scalars = np.array([
        transform.positive_floor, transform.normalization_min,
        transform.inverse_normalization_span, clip_start, 1.0 - clip_start,
    ], np.float64).astype(np.float32)
    return _pretransform_jit(
        data, tuple(scalars), log_scale=bool(transform.log_scale_input),
        normalize=bool(transform.normalize_to_unit_range),
        clip=bool(apply_clip),
    )


@functools.partial(
    jax.jit, donate_argnums=(0, 1), static_argnames=("shape",)
)
def _place_piece(canonical, ranges, source, start, index, *, shape):
    """Copy the ``shape`` block of ``source`` at ``start`` into row
    ``index`` of the zero-padded canonical table and record its value
    range, in place (both tables are donated)."""
    block = jax.lax.dynamic_slice(source, start, shape)
    canonical = jax.lax.dynamic_update_slice(
        canonical, block[None].astype(canonical.dtype), (index, 0, 0, 0)
    )
    ranges = ranges.at[index].set(jnp.stack([block.min(), block.max()]))
    return canonical, ranges


def pack_device_pieces(datas, bricks, core: int, ghost: int, cube: int,
                       dtype=jnp.float32):
    """Split device bricks into <= ``core``^3 pieces (plus ``ghost`` rings)
    and pack them into a zero-padded [L, cube, cube, cube] table on the
    device.  Returns (canonical, piece_ranges [(min, max)], piece_meta
    [(min, max, core dims, parent)]); the ranges come back in one readback
    at the end."""
    from .fast_scene import _cube_bounds, _ghost_fill_bricks

    padded_list = _ghost_fill_bricks(datas, bricks, ghost)
    jobs, piece_meta = [], []
    for parent, b in enumerate(bricks):
        data = datas[parent]
        source = padded_list[parent]
        if source is None:
            source = jnp.pad(data, ghost, mode="edge") if ghost else data
        for lo, hi, mn, mx in _cube_bounds(
            data.shape, b.min_corner, b.max_corner, core
        ):
            shape = tuple(int(v) for v in hi - lo + 2 * ghost)
            jobs.append((source, tuple(int(v) for v in lo), shape))
            piece_meta.append((mn, mx, hi - lo, parent))
    canonical = jnp.zeros((len(jobs), cube, cube, cube), dtype)
    ranges = jnp.zeros((len(jobs), 2), jnp.float32)
    for index, (source, start, shape) in enumerate(jobs):
        canonical, ranges = _place_piece(
            canonical, ranges, source, start, index, shape=shape
        )
    piece_ranges = [(float(a), float(b)) for a, b in np.asarray(ranges)]
    return canonical, piece_ranges, piece_meta


def build_device_scene_geometry(
    bricks: Sequence[Tuple[jnp.ndarray, Sequence[float], Sequence[float]]],
    log_scale_input: bool = False,
    normalize_to_data_range: bool = True,
) -> SceneGeometry:
    """SceneGeometry from device arrays: same semantics as
    ``scene.build_scene_geometry`` (global rescale, padded bounds, scalar
    transform) with statistics computed on device.

    ``bricks`` is a list of (data [nx,ny,nz] jnp array, min_corner,
    max_corner) in world coordinates.
    """
    scene = SceneGeometry()
    arrays = []
    for data, mn, mx in bricks:
        scene.bricks.append(
            Brick(data=data, min_corner=np.asarray(mn, float),
                  max_corner=np.asarray(mx, float))
        )
        arrays.append(data)
    if not scene.bricks:
        raise RuntimeError("Failed to locate any volumetric data.")

    # global rescale: smallest axis extent -> 1 (SceneBuilder.cpp:229-254)
    g_min = np.min([b.min_corner for b in scene.bricks], axis=0)
    g_max = np.max([b.max_corner for b in scene.bricks], axis=0)
    extent = np.abs(g_max - g_min)
    positive = extent[(extent > 0.0) & np.isfinite(extent)]
    scale = 1.0 / positive.min() if positive.size else 1.0
    if not math.isfinite(scale) or not (scale > 0.0):
        scale = 1.0
    if scale != 1.0:
        for b in scene.bricks:
            b.min_corner = b.min_corner * scale
            b.max_corner = b.max_corner * scale

    g_min = np.min([b.min_corner for b in scene.bricks], axis=0)
    g_max = np.max([b.max_corner for b in scene.bricks], axis=0)
    max_extent = float((g_max - g_min).max())
    padding = max_extent * 0.05 if max_extent > 0.0 else 1.0
    scene.explicit_bounds = VolumeBounds(g_min - padding, g_max + padding)

    min_v, max_v, min_pos, finite_count = device_scalar_stats(arrays)
    if finite_count > 0 and math.isfinite(min_v) and math.isfinite(max_v):
        scene.original_scalar_range = _make_scalar_range(min_v, max_v)
        scene.has_original_scalar_range = True

    processed_min, processed_max = min_v, max_v
    t = scene.scalar_transform
    t.log_scale_input = log_scale_input
    if log_scale_input:
        if not (min_pos > 0.0) or not math.isfinite(min_pos):
            raise RuntimeError(
                "Log scaling requested but no positive scalar values were found."
            )
        t.positive_floor = min_pos
        processed_min = math.log(min_pos)
        processed_max = math.log(max(max_v, min_pos))
    if not math.isfinite(processed_min) or not math.isfinite(processed_max):
        raise RuntimeError("Failed to compute a valid scalar range.")
    if processed_min == processed_max:
        processed_max = processed_min + 1.0

    scene.processed_scalar_range = _make_scalar_range(processed_min, processed_max)
    scene.has_processed_scalar_range = True
    t.processed_min = processed_min
    t.processed_max = processed_max
    t.inverse_processed_span = 1.0 / (processed_max - processed_min)
    t.normalization_min = processed_min
    t.normalization_max = processed_max
    t.inverse_normalization_span = t.inverse_processed_span
    scene.scalar_range = scene.processed_scalar_range
    scene.has_scalar_range = True
    if normalize_to_data_range:
        from .scene import set_scene_normalization_range

        set_scene_normalization_range(scene, processed_min, processed_max)
    return scene


def prepare_device_scene(
    bricks: Sequence[Tuple[jnp.ndarray, Sequence[float], Sequence[float]]],
    parameters: RenderParameters,
    color_map: Optional[ColorMap] = None,
    log_scale_input: bool = False,
    precision: str = "float32",
):
    """Device arrays -> a ready ``FastSceneRenderer``.

    The canonical <=32^3 piece table is assembled with jitted pads/stacks;
    brick data never crosses to the host.
    """
    from .fast_scene import MAX_CUBE, FastSceneRenderer

    scene = build_device_scene_geometry(bricks, log_scale_input)

    clip_start = float(np.clip(scene.scalar_range[1], 0.0, 1.0))
    apply_clip = 1.0 > clip_start + SOFT_CLIP_TOLERANCE
    t = scene.scalar_transform

    # trilinear: ghost rings for seam-free cube splits (fast_scene.__init__)
    ghost = 1 if parameters.sampling == "trilinear" else 0
    core = MAX_CUBE - 2 * ghost

    datas = [
        _pretransform_device(b.data, t, clip_start, apply_clip)
        for b in scene.bricks
    ]
    canonical, piece_ranges, piece_meta = pack_device_pieces(
        datas, scene.bricks, core, ghost, MAX_CUBE
    )

    renderer = FastSceneRenderer.__new__(FastSceneRenderer)
    renderer._init_from_canonical(
        scene, parameters, color_map, canonical, piece_meta,
        piece_ranges=piece_ranges, precision=precision,
        ghost=ghost,
    )
    return renderer


def prepare_device_amr(
    level_data: Sequence[Sequence],  # per level: list of LevelBox or
    #                                  (jnp data, lo index) tuples
    level_geometry: Sequence,  # per level: scene.LevelGeometry
    refinement_ratios: Sequence[Sequence[int]] = (),
    parameters: Optional[RenderParameters] = None,
    color_map: Optional[ColorMap] = None,
    min_level: int = 0,
    max_level: int = -1,
    component: int = 0,
    log_scale_input: bool = False,
    precision: str = "float32",
):
    """Multi-level in-situ ingestion entirely from device arrays.

    The device counterpart of ``api.load_amr_geometry`` +
    ``FastSceneRenderer`` (VolumeRendererApi.cpp:44-148): convexify runs on
    box *metadata* (host integers) while every chopped piece stays a lazy
    jnp slice of the level array — brick values never visit the host.
    Returns a ready ``FastSceneRenderer``.
    """
    from .amr import convexify
    from .scene import LevelBox

    if not level_data:
        raise ValueError("levelData must not be empty")
    if len(level_geometry) < len(level_data):
        raise ValueError("levelGeometry must cover every level")
    finest = len(level_data) - 1
    lo_level = max(0, min(min_level, finest))
    hi_level = max_level
    if hi_level < 0 or hi_level > finest:
        hi_level = finest
    if lo_level > hi_level:
        raise RuntimeError("minLevel must not exceed maxLevel")
    if hi_level > 0 and len(refinement_ratios) < hi_level:
        raise ValueError(
            "refinementRatios must provide ratios for each level transition"
        )

    levels = []
    for boxes in level_data[: hi_level + 1]:
        row = []
        for b in boxes:
            data, lo = (b.data, b.lo) if isinstance(b, LevelBox) else b
            if data.ndim == 4:
                data = data[..., component]
            row.append(LevelBox(data, np.asarray(lo)))
        levels.append(row)
    ratios = [tuple(int(v) for v in r) for r in refinement_ratios[:hi_level]]
    flattened = convexify(levels, ratios, materialize=lambda d: d)

    bricks = []
    for level in range(lo_level, hi_level + 1):
        geom = level_geometry[level]
        for b in flattened[level]:
            mn = np.asarray(geom.prob_lo) + b.lo * np.asarray(geom.cell_size)
            mx = mn + np.asarray(b.data.shape) * np.asarray(geom.cell_size)
            bricks.append((jnp.asarray(b.data), mn, mx))
    return prepare_device_scene(
        bricks, parameters or RenderParameters(), color_map,
        log_scale_input=log_scale_input,
        precision=precision,
    )


# ---------------------------------------------------------------------------
# Device-side histogram
# ---------------------------------------------------------------------------


def _histogram_block(raw, bin_count, log_scale, normalize, params, xp=jnp):
    """One binning implementation for both backends: ``xp=jnp`` runs
    jitted on device (in-situ arrays already in HBM); ``xp=np`` runs the
    SAME math on host for plotfile bricks — a per-brick device dispatch
    would pay a dispatch and a compile per brick shape for
    data that lives in host memory anyway."""
    positive_floor, norm_min, inv_span, range_min, range_width = params
    v = raw.astype(xp.float32).ravel()
    v = xp.where(xp.isfinite(v), v, xp.float32(0.0))
    if log_scale:
        v = xp.log(xp.where(v > 0.0, xp.maximum(v, positive_floor),
                            positive_floor))
    if normalize:
        v = xp.clip((v - norm_min) * inv_span, 0.0, 1.0)
    v = xp.clip(v, range_min, range_min + range_width)
    normalized = xp.clip((v - range_min) / range_width, 0.0, 1.0)
    idx = xp.clip((normalized * bin_count).astype(xp.int32), 0, bin_count - 1)
    if xp is np:
        return np.bincount(idx, minlength=bin_count)
    return jnp.bincount(idx, length=bin_count)


_histogram_block_jit = jax.jit(
    _histogram_block, static_argnames=("bin_count", "log_scale", "normalize")
)


def device_histogram(
    arrays: Sequence[jnp.ndarray],
    transform,
    bin_count: int,
    normalized_range: Tuple[float, float],
):
    """Histogram of transformed scalars computed entirely on device.

    The jnp counterpart of ``scene.compute_scene_histogram``
    (SceneBuilder.cpp:445-577) for in-situ fields already living in HBM:
    per-array transform + bincount run jitted on device; only the
    ``bin_count`` totals cross to the host.  Returns ``(counts, total)``.
    """
    if bin_count <= 0:
        raise ValueError("binCount must be positive")
    range_min, range_max = float(normalized_range[0]), float(normalized_range[1])
    range_width = range_max - range_min
    counts = np.zeros(bin_count, dtype=np.uint64)
    total = 0
    if not (range_width > 0.0) or not math.isfinite(range_width):
        return counts, total
    host_params = tuple(
        np.float32(p) for p in (
            transform.positive_floor, transform.normalization_min,
            transform.inverse_normalization_span, range_min, range_width,
        )
    )
    params = tuple(jnp.float32(p) for p in host_params)
    kw = dict(
        bin_count=bin_count,
        log_scale=bool(transform.log_scale_input),
        normalize=bool(transform.normalize_to_unit_range),
    )
    for a in arrays:
        if isinstance(a, np.ndarray):
            # host bricks (plotfile path): same math, zero device dispatches
            block = _histogram_block(a, params=host_params, xp=np, **kw)
        else:
            block = _histogram_block_jit(a, params=params, **kw)
        counts += np.asarray(block, dtype=np.uint64)
        total += int(a.size)
    return counts, total
