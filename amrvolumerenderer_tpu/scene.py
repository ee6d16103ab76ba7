"""Scene construction: AMR level data -> brick table + scalar transform.

Re-implements the reference SceneBuilder pipeline
(``VolumeRenderer/SceneBuilder.cpp:113-443``) in the single-controller JAX
model: because the host sees the whole scene, the reference's MPI_Allreduce
choreography collapses into plain global reductions; the distribution over
"ranks" becomes an owner assignment over mesh devices done at partition time.

Also provides the bucketed *brick table* used by the render kernel: bricks
grouped by padded shape so each bucket renders as one vmapped XLA program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .types import (
    Brick,
    ScalarHistogram,
    ScalarTransform,
    SceneGeometry,
    VolumeBounds,
    vec3,
)


@dataclasses.dataclass
class LevelGeometry:
    """Per-level grid geometry (SceneBuilder.hpp LevelGridGeometry)."""

    prob_lo: np.ndarray  # (3,) domain lower corner
    cell_size: np.ndarray  # (3,) cell size at this level

    def __post_init__(self):
        self.prob_lo = vec3(self.prob_lo)
        self.cell_size = vec3(self.cell_size)


@dataclasses.dataclass
class LevelBox:
    """One box of cell-centered data within a level's index space."""

    data: np.ndarray  # (nx, ny, nz) scalar values
    lo: np.ndarray  # (3,) integer lower cell index in the level index space

    def __post_init__(self):
        self.lo = np.asarray(self.lo, dtype=np.int64)
        # 3D scalar data, or 4D with a trailing component axis (MultiFab ncomp)
        assert self.data.ndim in (3, 4)


@dataclasses.dataclass
class SceneBuildOptions:
    min_level: int = 0
    max_level: int = 0
    log_scale_input: bool = False
    normalize_to_data_range: bool = True
    no_data_error: str = "Failed to locate any volumetric data."
    invalid_scalar_error: str = "Failed to compute a valid scalar range."


def _scalar_stats_numpy(arrays: Sequence[np.ndarray]):
    """min / max / min-positive / finite-count over all samples
    (SceneBuilder.cpp:53-101) — host float64 oracle path."""
    min_v, max_v, min_pos, count = math.inf, -math.inf, math.inf, 0
    for a in arrays:
        a = np.asarray(a, dtype=np.float64)
        finite = np.isfinite(a)
        n = int(finite.sum())
        if n == 0:
            continue
        vals = a[finite]
        min_v = min(min_v, float(vals.min()))
        max_v = max(max_v, float(vals.max()))
        pos = vals[vals > 0.0]
        if pos.size:
            min_pos = min(min_pos, float(pos.min()))
        count += n
    return min_v, max_v, min_pos, count


def _scalar_stats_device(arrays: Sequence[np.ndarray]):
    """Device twin of ``_scalar_stats_numpy`` (the GPU ParReduce of
    SceneBuilder.cpp:53-94, without per-brick host passes).

    Device-resident inputs reduce in place with one fused jitted call;
    host inputs make ONE batched transfer of the concatenated samples +
    one jitted reduction + a 4-scalar readback."""
    import jax

    from .device_scene import _stats_reduce, device_scalar_stats

    arrays = [a for a in arrays if np.prod(np.shape(a))]
    if not arrays:
        return math.inf, -math.inf, math.inf, 0
    if any(_is_device_array(a) for a in arrays):
        return device_scalar_stats(arrays)
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])
    min_v, max_v, min_pos, count = jax.device_get(_stats_reduce(flat))
    return float(min_v), float(max_v), float(min_pos), int(count)


# samples below this stay off the device: a transfer + dispatch round trip
# costs more than the host pass it replaces
_DEVICE_STATS_MIN_SAMPLES = 1 << 22


def _is_device_array(a) -> bool:
    return hasattr(a, "devices") and not isinstance(a, np.ndarray)


def _scalar_stats(arrays: Sequence[np.ndarray]):
    """Scalar statistics with automatic routing (SceneBuilder.cpp:53-94
    runs these on the GPU; the rebuild picks the fastest resident path).

    * device-resident (jnp) inputs reduce on the accelerator — no host
      round trip (``device_scene.device_scalar_stats``);
    * host (NumPy) inputs use the threaded native single pass
      (``native.scalar_stats``), falling back to the NumPy float64 oracle;
    * ``AVR_SCALAR_STATS=numpy|native|device`` forces a path (parity
      tests exercise all three — they agree to float32 rounding).
    """
    import os

    policy = os.environ.get("AVR_SCALAR_STATS", "auto")
    arrays = list(arrays)
    if policy == "device" or (
        policy == "auto"
        and arrays
        and any(_is_device_array(a) for a in arrays)
        and sum(int(np.prod(np.shape(a))) for a in arrays)
        >= _DEVICE_STATS_MIN_SAMPLES
    ):
        try:
            return _scalar_stats_device(arrays)
        except Exception:
            if policy == "device":
                raise
    if policy in ("auto", "native"):
        from . import native

        stats = native.scalar_stats(arrays)
        if stats is not None:
            return stats
        if policy == "native":
            raise RuntimeError("native scalar stats unavailable")
    return _scalar_stats_numpy(arrays)


def _make_scalar_range(min_v: float, max_v: float) -> Tuple[float, float]:
    if min_v == max_v:
        max_v = min_v + 1.0
    return float(np.float32(min_v)), float(np.float32(max_v))


def set_scene_normalization_range(
    scene: SceneGeometry, normalization_min: float, normalization_max: float
) -> None:
    """Switch the transform to normalize-to-[0,1] mode
    (SceneBuilder.cpp:427-443)."""
    span = normalization_max - normalization_min
    if not (span > 0.0) or not math.isfinite(span):
        raise RuntimeError(
            "Failed to establish a finite scalar range for color mapping."
        )
    t = scene.scalar_transform
    t.normalize_to_unit_range = True
    t.normalization_min = normalization_min
    t.normalization_max = normalization_max
    t.inverse_normalization_span = 1.0 / span
    scene.scalar_range = (0.0, 1.0)
    scene.has_scalar_range = True


def build_scene_geometry(
    levels: Sequence[Sequence[LevelBox]],
    level_geometry: Sequence[LevelGeometry],
    options: SceneBuildOptions,
) -> SceneGeometry:
    """Build a SceneGeometry from per-level box lists.

    Semantics follow SceneBuilder.cpp:113-425: world corners from
    probLo + index * cellSize; a global rescale so the smallest domain axis
    extent becomes 1; explicit bounds padded by 5% of the largest extent;
    scalar stats feeding the log/normalize transform.
    """
    if len(levels) != len(level_geometry):
        raise ValueError("levels and level_geometry must have matching sizes")

    scene = SceneGeometry()
    data_arrays: List[np.ndarray] = []

    for level in range(options.min_level, options.max_level + 1):
        if level < 0 or level >= len(levels):
            continue
        geom = level_geometry[level]
        for box in levels[level]:
            nx, ny, nz = box.data.shape
            if nx <= 0 or ny <= 0 or nz <= 0:
                continue
            lo = box.lo
            hi = lo + np.array([nx, ny, nz], dtype=np.int64)
            min_corner = geom.prob_lo + lo.astype(np.float64) * geom.cell_size
            max_corner = geom.prob_lo + hi.astype(np.float64) * geom.cell_size
            scene.bricks.append(
                Brick(
                    data=np.ascontiguousarray(box.data, dtype=np.float32),
                    min_corner=min_corner,
                    max_corner=max_corner,
                    level=level,
                )
            )
            data_arrays.append(box.data)

    # global original bounds -> rescale so the smallest axis extent is 1
    # (SceneBuilder.cpp:229-254)
    if scene.bricks:
        g_min = np.min([b.min_corner for b in scene.bricks], axis=0)
        g_max = np.max([b.max_corner for b in scene.bricks], axis=0)
        extent = np.abs(g_max - g_min)
        positive = extent[(extent > 0.0) & np.isfinite(extent)]
        scale = 1.0
        if positive.size:
            min_extent = float(positive.min())
            if min_extent > 0.0 and math.isfinite(min_extent):
                scale = 1.0 / min_extent
        if not math.isfinite(scale) or not (scale > 0.0):
            scale = 1.0
        if scale != 1.0:
            for b in scene.bricks:
                b.min_corner = b.min_corner * scale
                b.max_corner = b.max_corner * scale

    # explicit bounds: tight global + 5% padding (SceneBuilder.cpp:296-313)
    if not scene.bricks:
        raise RuntimeError(options.no_data_error)
    g_min = np.min([b.min_corner for b in scene.bricks], axis=0)
    g_max = np.max([b.max_corner for b in scene.bricks], axis=0)
    extent = g_max - g_min
    max_extent = float(extent.max())
    padding = max_extent * 0.05 if max_extent > 0.0 else 1.0
    scene.explicit_bounds = VolumeBounds(g_min - padding, g_max + padding)

    # scalar stats -> original range (SceneBuilder.cpp:316-352)
    min_v, max_v, min_pos, finite_count = _scalar_stats(data_arrays)
    if finite_count > 0 and math.isfinite(min_v) and math.isfinite(max_v):
        scene.original_scalar_range = _make_scalar_range(min_v, max_v)
        scene.has_original_scalar_range = True

    processed_min, processed_max = min_v, max_v
    t = scene.scalar_transform
    t.log_scale_input = options.log_scale_input
    t.normalize_to_unit_range = False
    t.positive_floor = 0.0

    if options.log_scale_input:
        if not (min_pos > 0.0) or not math.isfinite(min_pos):
            raise RuntimeError(
                "Log scaling requested but no positive scalar values were found."
            )
        t.positive_floor = min_pos
        processed_min = math.log(min_pos)
        processed_max = math.log(max(max_v, min_pos))

    if not math.isfinite(processed_min) or not math.isfinite(processed_max):
        raise RuntimeError(options.invalid_scalar_error)
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
    if options.normalize_to_data_range:
        set_scene_normalization_range(scene, processed_min, processed_max)
    return scene


def assign_owners(scene: SceneGeometry, num_ranks: int) -> None:
    """Distribute bricks round-robin over logical ranks/devices.

    The array replacement for AMReX's DistributionMapping: brick i is
    owned by rank ``i % num_ranks``.
    """
    for i, b in enumerate(scene.bricks):
        b.owner = i % num_ranks


def compute_scene_histogram(scene: SceneGeometry, bin_count: int) -> ScalarHistogram:
    """Histogram of transformed scalar values (SceneBuilder.cpp:445-577)."""
    if bin_count <= 0:
        raise ValueError("binCount must be positive")
    hist = ScalarHistogram(bin_counts=np.zeros(bin_count, dtype=np.uint64))
    if scene.has_scalar_range:
        hist.normalized_range = scene.scalar_range
    if scene.has_processed_scalar_range:
        hist.processed_range = scene.processed_scalar_range
        hist.has_processed_range = True
    if scene.has_original_scalar_range:
        hist.original_range = scene.original_scalar_range
        hist.has_original_range = True

    range_min, range_max = hist.normalized_range
    range_width = range_max - range_min
    if not (range_width > 0.0) or not math.isfinite(range_width):
        return hist

    # one binning path for plotfile/API scenes and in-situ device scenes:
    # the jitted transform + bincount of device_scene.device_histogram
    # (the reference likewise bins on the GPU for both,
    # SceneBuilder.cpp:445-577 / VolumeRenderer.cpp:880-897)
    from .device_scene import device_histogram

    counts, total = device_histogram(
        [brick.data for brick in scene.bricks],
        scene.scalar_transform,
        bin_count,
        hist.normalized_range,
    )
    hist.bin_counts = counts
    hist.sample_count = total
    if not hist.has_processed_range or total == 0:
        hist.bin_counts = np.zeros_like(counts)
    return hist


# ---------------------------------------------------------------------------
# Brick table bucketing for the render kernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BrickBucket:
    """Bricks of one padded shape, batched for a single vmapped render call."""

    data: np.ndarray  # [B, nx, ny, nz] float32, zero-padded
    min_corner: np.ndarray  # [B, 3] float32
    max_corner: np.ndarray  # [B, 3] float32
    cell_dims: np.ndarray  # [B, 3] int32 (actual, pre-padding)
    owners: np.ndarray  # [B] int32
    brick_indices: np.ndarray  # [B] int32 index into scene.bricks


def _pad_shape(shape: Tuple[int, int, int], granularity: int = 1):
    def up(n):
        return ((n + granularity - 1) // granularity) * granularity

    return tuple(up(n) for n in shape)


def build_brick_buckets(
    bricks: Sequence[Brick], granularity: int = 1
) -> List[BrickBucket]:
    """Group bricks by padded shape into dense batches.

    ``granularity`` rounds each dimension up so bricks of slightly different
    sizes share one bucket (fewer XLA programs at the cost of padding).
    """
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    for i, b in enumerate(bricks):
        key = _pad_shape(b.cell_dimensions, granularity)
        groups.setdefault(key, []).append(i)

    buckets = []
    for shape, indices in sorted(groups.items()):
        n = len(indices)
        data = np.zeros((n,) + shape, dtype=np.float32)
        min_c = np.zeros((n, 3), dtype=np.float32)
        max_c = np.zeros((n, 3), dtype=np.float32)
        dims = np.zeros((n, 3), dtype=np.int32)
        owners = np.zeros(n, dtype=np.int32)
        for slot, idx in enumerate(indices):
            b = bricks[idx]
            nx, ny, nz = b.cell_dimensions
            data[slot, :nx, :ny, :nz] = b.data
            min_c[slot] = b.min_corner
            max_c[slot] = b.max_corner
            dims[slot] = (nx, ny, nz)
            owners[slot] = b.owner
        buckets.append(
            BrickBucket(
                data=data,
                min_corner=min_c,
                max_corner=max_c,
                cell_dims=dims,
                owners=owners,
                brick_indices=np.asarray(indices, dtype=np.int32),
            )
        )
    return buckets
