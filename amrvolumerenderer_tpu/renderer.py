"""Render pipeline orchestration: the ``VolumeRenderer`` equivalent.

Mirrors ``VolumeRenderer/VolumeRenderer.cpp``'s renderScene /
renderSingleTrial flow (cpp:947-1339) on the JAX stack: bucketed
brick-table rendering via the jitted ray-march kernel, host visibility
ordering, depth-sorted layered compositing, supersample downsampling,
bounding-box wireframe overlay, and PPM/PNG output.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import io as image_io
from .camera import (
    auto_orbit_camera,
    camera_basis,
    safe_normalize,
)
from .colormap import SOFT_CLIP_TOLERANCE, build_color_table
from .compositor import composite_layers_device
from .image import ImageBuffer, ImageKind
from .ops.raymarch import max_steps_for_bucket, render_brick_bucket
from .scene import build_brick_buckets
from .types import (
    CameraParameters,
    ColorMap,
    RenderParameters,
    SceneGeometry,
    VolumeBounds,
)
from .visibility import build_visibility_order

K_PI = 3.14159265358979323846


def validate_render_parameters(parameters: RenderParameters) -> None:
    """Parameter validation (VolumeRenderer.cpp:562-579)."""
    if parameters.width <= 0 or parameters.height <= 0:
        raise ValueError("image dimensions must be positive")
    if not (0.0 <= parameters.box_transparency <= 1.0):
        raise ValueError("box transparency must be between 0 and 1")
    if parameters.antialiasing <= 0:
        raise ValueError("antialiasing must be positive")
    sqrt_aa = int(round(math.sqrt(parameters.antialiasing)))
    if sqrt_aa * sqrt_aa != parameters.antialiasing:
        raise ValueError("antialiasing must be a perfect square (1, 4, 9, ...)")
    if parameters.sampling not in ("nearest", "trilinear"):
        raise ValueError("sampling must be \"nearest\" or \"trilinear\"")
    if parameters.render_method not in (
        "auto", "raymarch", "slicemarch", "tilemarch"
    ):
        raise ValueError(
            "render method must be one of auto, raymarch, slicemarch, "
            "tilemarch"
        )
    if parameters.multichip_pipeline not in ("auto", "depth", "layered"):
        raise ValueError(
            "multichip pipeline must be one of auto, depth, layered"
        )
    if parameters.multichip_transport not in ("float32", "ubyte"):
        raise ValueError("multichip transport must be float32 or ubyte")
    if parameters.devices is not None and parameters.devices < 1:
        raise ValueError("devices must be a positive device count")
    if parameters.classification not in ("post", "pre"):
        raise ValueError("classification must be \"post\" or \"pre\"")
    if parameters.lut_size <= 0 or parameters.lut_size % 128 != 0:
        raise ValueError(
            "lut_size must be a positive multiple of 128 (e.g. 128, 256)"
        )
    if (
        parameters.classification == "pre"
        and parameters.sampling == "nearest"
    ):
        raise ValueError(
            "classification=\"pre\" requires sampling=\"trilinear\" "
            "(nearest sampling has no interpolation to reorder)"
        )


def compute_global_bounds(geometry: SceneGeometry) -> VolumeBounds:
    """Global bounds with 5% padding, or the prebuilt explicit bounds
    (VolumeRenderer.cpp:716-789)."""
    if geometry.has_explicit_bounds:
        return geometry.explicit_bounds
    if not geometry.bricks:
        return VolumeBounds((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    g_min = np.min([b.min_corner for b in geometry.bricks], axis=0)
    g_max = np.max([b.max_corner for b in geometry.bricks], axis=0)
    extent = g_max - g_min
    max_extent = float(extent.max())
    padding = max_extent * 0.05 if max_extent > 0.0 else 0.5
    return VolumeBounds(g_min - padding, g_max + padding)


def compute_tight_bounds(
    geometry: SceneGeometry, fallback: VolumeBounds
) -> VolumeBounds:
    """Unpadded global bounds (VolumeRenderer.cpp:791-849)."""
    if not geometry.bricks:
        return fallback
    g_min = np.min([b.min_corner for b in geometry.bricks], axis=0)
    g_max = np.max([b.max_corner for b in geometry.bricks], axis=0)
    return VolumeBounds(g_min, g_max)


def _transformed_range_numpy(geometry: SceneGeometry) -> Tuple[float, float]:
    t = geometry.scalar_transform
    lo, hi = math.inf, -math.inf
    for brick in geometry.bricks:
        v = np.asarray(brick.data).astype(np.float64)
        v = np.where(np.isfinite(v), v, 0.0)
        if t.log_scale_input:
            v = np.where(v > 0.0, np.maximum(v, t.positive_floor), t.positive_floor)
            v = np.log(v)
        if t.normalize_to_unit_range:
            v = np.clip((v - t.normalization_min) * t.inverse_normalization_span, 0, 1)
        lo = min(lo, float(v.min()))
        hi = max(hi, float(v.max()))
    return lo, hi


def _apply_transform_scalar(v: float, t) -> float:
    """The scalar transform (VolumeTypes.hpp:53-67) on one float64 value."""
    if t.log_scale_input:
        v = max(v, t.positive_floor) if v > 0.0 else t.positive_floor
        v = math.log(v)
    if t.normalize_to_unit_range:
        v = min(max((v - t.normalization_min) * t.inverse_normalization_span,
                    0.0), 1.0)
    return v


def compute_global_scalar_range(geometry: SceneGeometry) -> Tuple[float, float]:
    """Transformed scalar min/max over all bricks (VolumeRenderer.cpp:851-878).

    The scalar transform is monotone non-decreasing (floor/log/normalize/
    clip all preserve order), so the transformed range is the transform of
    the RAW range — one stats pass (routed native/device/NumPy by
    ``scene._scalar_stats``) instead of per-brick transformed full passes.
    Non-finite samples sanitize to 0.0 before the transform
    (``_transformed_range_numpy`` is the oracle the parity tests hold this
    to)."""
    from .scene import _scalar_stats

    if not geometry.bricks:
        return 0.0, 1.0
    min_v, max_v, _min_pos, count = _scalar_stats(
        [b.data for b in geometry.bricks]
    )
    total = sum(int(np.prod(np.shape(b.data))) for b in geometry.bricks)
    if count == 0:
        min_v = max_v = 0.0
    elif count < total:
        # non-finite samples become 0.0 in the transformed pass
        min_v = min(min_v, 0.0)
        max_v = max(max_v, 0.0)
    t = geometry.scalar_transform
    lo = _apply_transform_scalar(float(min_v), t)
    hi = _apply_transform_scalar(float(max_v), t)
    if not (math.isfinite(lo) and math.isfinite(hi)):
        lo = hi = 0.0
    if lo == hi:
        hi = lo + 1.0
    return lo, hi


def compute_reference_sample_distance(
    geometry: SceneGeometry, bounds: VolumeBounds
) -> float:
    """Half of the coarsest brick's minimum spacing, with degenerate
    fallbacks (VolumeRenderer.cpp:1138-1190)."""
    coarsest = 0.0
    for brick in geometry.bricks:
        ms = brick.min_spacing()
        if ms > 0.0 and math.isfinite(ms):
            coarsest = max(coarsest, ms)
    if not (coarsest > 0.0 and math.isfinite(coarsest)):
        span = bounds.max_corner - bounds.min_corner
        positive = span[(span > 0.0) & np.isfinite(span)]
        fallback = float(positive.min()) if positive.size else 1.0
        coarsest = max(1e-4, fallback * 0.01)
    return max(coarsest * 0.5, 1e-5)


def render_bounding_box_overlay(
    bounds: VolumeBounds,
    camera: CameraParameters,
    sqrt_antialiasing: int,
    layer: ImageBuffer,
) -> None:
    """Antialiased white wireframe of the bounds, blended *over* the image
    (VolumeRenderer.cpp:139-335).  Mutates ``layer`` in place."""
    width, height = layer.width, layer.height
    if width <= 0 or height <= 0:
        return
    aspect = width / max(height, 1)
    forward = safe_normalize(camera.look_at - camera.eye)
    right = np.cross(forward, camera.up)
    right_len = float(np.linalg.norm(right))
    right = right / right_len if right_len > 0 and math.isfinite(right_len) else np.array([1.0, 0.0, 0.0])
    up_ortho = np.cross(right, forward)
    tan_half_fov = math.tan(camera.fov_y_degrees * 0.5 * K_PI / 180.0)

    width_scale = float(width - 1) if width > 1 else 0.0
    height_scale = float(height - 1) if height > 1 else 0.0

    corners = []
    for idx in range(8):
        corner = np.array(
            [
                bounds.max_corner[0] if idx & 1 else bounds.min_corner[0],
                bounds.max_corner[1] if idx & 2 else bounds.min_corner[1],
                bounds.max_corner[2] if idx & 4 else bounds.min_corner[2],
            ]
        )
        rel = corner - camera.eye
        depth = float(np.dot(rel, forward))
        entry = dict(world=corner, x=0.0, y=0.0, depth=math.inf, valid=False)
        if depth > 0.0 and math.isfinite(depth):
            x_cam = float(np.dot(rel, right))
            y_cam = float(np.dot(rel, up_ortho))
            ndc_x = x_cam / (depth * tan_half_fov * aspect)
            ndc_y = y_cam / (depth * tan_half_fov)
            if math.isfinite(ndc_x) and math.isfinite(ndc_y):
                entry.update(
                    x=(ndc_x * 0.5 + 0.5) * width_scale,
                    y=(ndc_y * 0.5 + 0.5) * height_scale,
                    depth=depth,
                    valid=True,
                )
        corners.append(entry)

    edges = [
        (0, 1), (1, 3), (3, 2), (2, 0),
        (4, 5), (5, 7), (7, 6), (6, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]

    pixel_radius = 0.5 * max(sqrt_antialiasing, 1)
    influence_radius = pixel_radius + 0.5
    coverage_scale = 0.6
    overlay_depth = np.finfo(np.float32).min

    pixels = layer.pixels  # [H*W, 5] view

    for e0, e1 in edges:
        start, end = corners[e0], corners[e1]
        if not (start["valid"] and end["valid"]):
            continue
        min_x = min(start["x"], end["x"]) - influence_radius
        max_x = max(start["x"], end["x"]) + influence_radius
        min_y = min(start["y"], end["y"]) - influence_radius
        max_y = max(start["y"], end["y"]) + influence_radius
        x_begin = max(0, int(math.floor(min_x)))
        x_end = min(width - 1, int(math.ceil(max_x)))
        y_begin = max(0, int(math.floor(min_y)))
        y_end = min(height - 1, int(math.ceil(max_y)))
        if x_end < x_begin or y_end < y_begin:
            continue

        edge_dx = end["x"] - start["x"]
        edge_dy = end["y"] - start["y"]
        edge_len_sq = edge_dx * edge_dx + edge_dy * edge_dy

        xs = np.arange(x_begin, x_end + 1)
        ys = np.arange(y_begin, y_end + 1)
        sample_x = xs[None, :] + 0.5
        sample_y = ys[:, None] + 0.5
        if edge_len_sq > 0.0:
            apx = sample_x - start["x"]
            apy = sample_y - start["y"]
            t = np.clip((apx * edge_dx + apy * edge_dy) / edge_len_sq, 0.0, 1.0)
            closest_x = start["x"] + edge_dx * t
            closest_y = start["y"] + edge_dy * t
            dist = np.sqrt((sample_x - closest_x) ** 2 + (sample_y - closest_y) ** 2)
            coverage = np.clip(
                (pixel_radius + 0.5 - dist) * coverage_scale, 0.0, 1.0
            )
        else:
            # degenerate edge: single pixel full coverage at the start corner
            px = int(round(start["x"]))
            py = int(round(start["y"]))
            if 0 <= px < width and 0 <= py < height:
                idx = py * width + px
                src_a = 1.0
                pixels[idx, :3] = 1.0 * src_a + pixels[idx, :3] * (1.0 - src_a)
                pixels[idx, 3] = src_a + pixels[idx, 3] * (1.0 - src_a)
                pixels[idx, 4] = overlay_depth
            continue

        mask = coverage > 0.0
        if not np.any(mask):
            continue
        yy, xx = np.nonzero(mask)
        flat = (ys[yy] * width + xs[xx]).astype(np.int64)
        cov = coverage[yy, xx].astype(np.float32)
        src_a = cov
        one_minus = 1.0 - src_a
        pixels[flat, 0] = src_a + pixels[flat, 0] * one_minus
        pixels[flat, 1] = src_a + pixels[flat, 1] * one_minus
        pixels[flat, 2] = src_a + pixels[flat, 2] * one_minus
        pixels[flat, 3] = src_a + pixels[flat, 3] * one_minus
        pixels[flat, 4] = overlay_depth


def downsample_image(
    source: ImageBuffer, target_width: int, target_height: int, sqrt_aa: int
) -> ImageBuffer:
    """Supersample box-average downsample (VolumeRenderer.cpp:479-528)."""
    block = max(sqrt_aa, 1)
    if block <= 1:
        raise ValueError("downsample expects sqrtAA > 1")
    out = ImageBuffer.create(ImageKind.RGBA_F32_DEPTH_SORT, target_width, target_height)

    from . import native

    avg = native.downsample_box(
        np.asarray(source.pixels, dtype=np.float32),
        target_width,
        target_height,
        block,
    )
    if avg is None:
        src = source.pixels[:, :4].reshape(source.height, source.width, 4)
        src = src.reshape(target_height, block, target_width, block, 4)
        avg = src.mean(axis=(1, 3)).astype(np.float32).reshape(-1, 4)
    out.pixels[:, :4] = avg
    out.pixels[:, 4] = np.inf
    return out


@dataclasses.dataclass
class RenderTiming:
    render_seconds: float = 0.0
    visibility_seconds: float = 0.0
    composite_seconds: float = 0.0


def _build_camera_arrays(camera: CameraParameters):
    forward, right, up = camera_basis(camera)
    return (
        jnp.asarray(camera.eye, dtype=jnp.float32),
        jnp.asarray(forward, dtype=jnp.float32),
        jnp.asarray(right, dtype=jnp.float32),
        jnp.asarray(up, dtype=jnp.float32),
    )


def resolve_render_method(method: str, sampling: str = "nearest") -> str:
    """Resolve the render method: 'raymarch' (exact reference-semantics
    oracle), 'slicemarch' (the fused device path), or 'auto' (the fused
    device path on an accelerator, the oracle on the CPU, whose pixels the
    CPU tests pin).  Trilinear sampling exists only in the slice march, so
    it steers 'auto' there on any backend."""
    if method == "auto":
        if sampling == "trilinear":
            return "slicemarch"
        return "raymarch" if jax.default_backend() == "cpu" else "slicemarch"
    if method not in ("raymarch", "slicemarch", "tilemarch"):
        raise ValueError(f"unknown render method '{method}'")
    if method == "raymarch" and sampling == "trilinear":
        raise ValueError("sampling=\"trilinear\" requires the slicemarch "
                         "or tilemarch method")
    return method


def render_layers(
    geometry: SceneGeometry,
    parameters: RenderParameters,
    camera: CameraParameters,
    bounds: VolumeBounds,
    scalar_range: Tuple[float, float],
    reference_sample_distance: float,
    render_width: int,
    render_height: int,
    color_map: Optional[ColorMap],
    method: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Render every brick into a full-frame RGBA+depth layer.

    Returns (layers [L, P, 5] float32 in brick order, depth_hints [L],
    owners [L], local_indices [L]).  Equivalent of the per-box paint loop
    (VolumeRenderer.cpp:1200-1223) but batched per bucket through one
    jitted XLA program each.
    """
    if resolve_render_method(method, parameters.sampling) == "slicemarch":
        from .renderer_fast import render_layers_slicemarch

        return render_layers_slicemarch(
            geometry, parameters, camera, bounds, scalar_range,
            reference_sample_distance, render_width, render_height, color_map,
        )

    bricks = geometry.bricks
    num_bricks = len(bricks)
    num_pixels = render_width * render_height
    layers = np.zeros((num_bricks, num_pixels, 5), dtype=np.float32)
    layers[:, :, 4] = np.inf

    alpha_scale = float(np.clip(1.0 - parameters.box_transparency, 0.0, 1.0))
    clip_start = float(np.clip(scalar_range[1], 0.0, 1.0))
    apply_clip = 1.0 > clip_start + SOFT_CLIP_TOLERANCE

    t = geometry.scalar_transform
    eye, fwd, right, up = _build_camera_arrays(camera)

    # fallback spacing when a brick has no positive spacing
    # (VolumePainter.cpp:593-597)
    span = bounds.max_corner - bounds.min_corner
    fallback_spacing = max(1e-4, float(min(span)) * 0.01)

    buckets = build_brick_buckets(bricks)
    lut_cache: Dict[float, np.ndarray] = {}

    for bucket in buckets:
        n = len(bucket.brick_indices)
        sample_distances = np.zeros(n, dtype=np.float32)
        luts = np.zeros((n, parameters.lut_size, 4), dtype=np.float32)
        for slot, idx in enumerate(bucket.brick_indices):
            brick = bricks[int(idx)]
            ms = brick.min_spacing()
            if not (ms > 0.0 and math.isfinite(ms)):
                ms = fallback_spacing
            sample_distance = max(ms * 0.5, 1e-5)
            sample_distances[slot] = sample_distance
            ref = reference_sample_distance
            if not (ref > 0.0 and math.isfinite(ref)):
                ref = sample_distance
            normalization_factor = sample_distance / ref
            if not math.isfinite(normalization_factor):
                normalization_factor = 1.0
            normalization_factor = max(normalization_factor, 0.0)
            key = round(normalization_factor, 12)
            if key not in lut_cache:
                lut_cache[key] = build_color_table(
                    alpha_scale, normalization_factor, scalar_range, color_map,
                    size=parameters.lut_size,
                )
            luts[slot] = lut_cache[key]

        num_steps = max_steps_for_bucket(
            bucket.min_corner, bucket.max_corner, sample_distances
        )
        range_min = np.float32(scalar_range[0])
        range_span = scalar_range[1] - scalar_range[0]
        inverse_range = np.float32(1.0 / range_span if range_span != 0.0 else 1.0)

        colors, depths = render_brick_bucket(
            jnp.asarray(bucket.data),
            jnp.asarray(bucket.min_corner),
            jnp.asarray(bucket.max_corner),
            jnp.asarray(bucket.cell_dims),
            jnp.asarray(luts),
            jnp.asarray(sample_distances),
            eye,
            fwd,
            right,
            up,
            jnp.float32(camera.fov_y_degrees),
            range_min,
            inverse_range,
            jnp.float32(t.positive_floor),
            jnp.float32(t.normalization_min),
            jnp.float32(t.inverse_normalization_span),
            width=render_width,
            height=render_height,
            num_steps=num_steps,
            log_scale=bool(t.log_scale_input),
            normalize=bool(t.normalize_to_unit_range),
            clip_start=clip_start,
            apply_clip=bool(apply_clip),
        )
        colors = np.asarray(colors)
        depths = np.asarray(depths)
        for slot, idx in enumerate(bucket.brick_indices):
            layers[int(idx), :, :4] = colors[slot]
            layers[int(idx), :, 4] = depths[slot]

    # layer ordering keys: brick-level visibility-graph positions when
    # available (exact view-consistent order over the convexified boxes),
    # nearest-corner depth hints as the fallback / on --no-visibility-graph
    # (visibility.order_keys_or_hints — the shared policy of every
    # compositing path)
    from .visibility import order_keys_or_hints

    depth_hints = order_keys_or_hints(
        camera, render_width / max(render_height, 1),
        np.array([b.min_corner for b in bricks]),
        np.array([b.max_corner for b in bricks]),
        use_graph=parameters.use_visibility_graph,
    )
    owners = np.array([b.owner for b in bricks], dtype=np.int32)
    # local index = position within the owner's local brick list
    local_indices = np.zeros(num_bricks, dtype=np.int32)
    counters: Dict[int, int] = {}
    for i, b in enumerate(bricks):
        local_indices[i] = counters.get(b.owner, 0)
        counters[b.owner] = local_indices[i] + 1
    return layers, depth_hints, owners, local_indices


def render_single_trial(
    output_filename: str,
    parameters: RenderParameters,
    geometry: SceneGeometry,
    bounds: VolumeBounds,
    scalar_range: Tuple[float, float],
    camera: CameraParameters,
    color_map: Optional[ColorMap],
    num_ranks: int = 1,
    verbose: bool = True,
    method: str = "auto",
) -> Tuple[ImageBuffer, RenderTiming]:
    """One full render: paint layers, order, composite, downsample, overlay,
    save (VolumeRenderer.cpp:1103-1339)."""
    timing = RenderTiming()
    aspect = parameters.width / parameters.height
    sqrt_aa = int(round(math.sqrt(parameters.antialiasing)))
    render_width = parameters.width * max(sqrt_aa, 1)
    render_height = parameters.height * max(sqrt_aa, 1)

    reference_sample_distance = compute_reference_sample_distance(geometry, bounds)
    tight_bounds = compute_tight_bounds(geometry, bounds)

    # visibility ordering first: its permutation feeds depth-hint
    # tie-breaking in every composite below (the reference computes it
    # between paint and composite, VolumeRenderer.cpp:1234-1245, but only
    # the composite consumes it; stage times are still reported per stage)
    t0 = time.perf_counter()
    if geometry.bricks:
        box_min = np.stack([b.min_corner for b in geometry.bricks])
        box_max = np.stack([b.max_corner for b in geometry.bricks])
    else:
        box_min = np.zeros((0, 3))
        box_max = np.zeros((0, 3))
    brick_owners = np.array([b.owner for b in geometry.bricks], dtype=np.int32)
    rank_order = build_visibility_order(
        camera,
        aspect,
        box_min,
        box_max,
        brick_owners,
        num_ranks,
        parameters.use_visibility_graph,
        parameters.write_visibility_graph,
        log=verbose,
    )
    timing.visibility_seconds = time.perf_counter() - t0

    num_devices = parameters.devices or 1
    if num_devices < 1:
        raise ValueError("devices must be a positive device count")
    if num_devices > len(jax.devices()):
        raise ValueError(
            f"requested {num_devices} devices but only "
            f"{len(jax.devices())} are available"
        )

    resolved = resolve_render_method(method, parameters.sampling)
    fused = resolved in ("slicemarch", "tilemarch")
    if num_devices > 1 and method not in ("auto", "slicemarch"):
        # the sharded pipeline is slice-march based; silently overriding an
        # explicitly requested oracle/tilemarch kernel would hand the user
        # different pixels (the oracle's half-step quantization) unasked
        raise ValueError(
            f"render method '{method}' is single-device; multi-device "
            "rendering uses the slicemarch pipeline (use 'auto' or "
            "'slicemarch' with devices > 1)"
        )
    t0 = time.perf_counter()
    if num_devices > 1:
        # multi-chip product path: shard the brick table over the mesh and
        # composite with device collectives (the mpirun distribution of
        # VolumeRenderer/main.cpp:19-36 + VolumeRenderer.cpp:1201-1249)
        from .renderer_fast import render_composited_sharded

        composited_np = render_composited_sharded(
            geometry, parameters, camera, scalar_range,
            reference_sample_distance, render_width, render_height,
            color_map, num_devices,
            downsample_block=max(sqrt_aa, 1),
            pipeline=parameters.multichip_pipeline,
            transport=parameters.multichip_transport,
            rank_order=rank_order,
        )
        fused = True
        layers = depth_hints = owners = local_indices = None
    elif fused:
        # fused fast path: render + depth-sorted composite stay on device;
        # only the final frame crosses to the host
        from .renderer_fast import (
            render_composited_slicemarch,
            render_composited_tilemarch,
        )

        render_fn = (
            render_composited_tilemarch
            if resolved == "tilemarch"
            else render_composited_slicemarch
        )
        composited_np = render_fn(
            geometry, parameters, camera, scalar_range,
            reference_sample_distance, render_width, render_height,
            color_map, downsample_block=max(sqrt_aa, 1),
            rank_order=rank_order,
        )
        layers = depth_hints = owners = local_indices = None
    else:
        layers, depth_hints, owners, local_indices = render_layers(
            geometry,
            parameters,
            camera,
            bounds,
            scalar_range,
            reference_sample_distance,
            render_width,
            render_height,
            color_map,
            method=resolved,
        )
    timing.render_seconds = time.perf_counter() - t0
    if verbose:
        print(f"Render: per-box rendering took {timing.render_seconds:.4f} s")
        print(
            "Render: visibility graph computation took "
            f"{timing.visibility_seconds:.4f} s"
        )

    t0 = time.perf_counter()
    if fused:
        composited = composited_np  # composited inside the render dispatch
    else:
        from .renderer_fast import visibility_owner_keys

        composited = composite_layers_device(
            jnp.asarray(layers), depth_hints,
            visibility_owner_keys(owners, rank_order), local_indices,
        )
        composited = np.asarray(jax.device_get(composited))
    timing.composite_seconds = time.perf_counter() - t0
    if verbose:
        print(f"Render: compositing took {timing.composite_seconds:.4f} s")

    if fused:
        # the fused path downsamples on device, so the frame is already at
        # output resolution
        full = ImageBuffer(
            ImageKind.RGBA_F32_DEPTH_SORT,
            parameters.width,
            parameters.height,
            composited.copy(),
        )
        if verbose:
            print(
                f"Render: composed {render_width * render_height} pixels "
                "on rank 0"
            )
        output_image = full
    else:
        full = ImageBuffer(
            ImageKind.RGBA_F32_DEPTH_SORT,
            render_width,
            render_height,
            composited.copy(),
        )
        if verbose:
            print(f"Render: composed {full.num_pixels} pixels on rank 0")

        if sqrt_aa > 1:
            output_image = downsample_image(
                full, parameters.width, parameters.height, sqrt_aa
            )
        else:
            output_image = full

    render_bounding_box_overlay(tight_bounds, camera, 1, output_image)

    # multi-host pods: every process holds the assembled frame, but only
    # process 0 writes/logs (rank-0 output of VolumeRenderer.cpp:1296-1335)
    if output_filename and jax.process_index() == 0:
        lower = output_filename.lower()
        ext = lower[lower.rfind(".") :] if "." in lower else ""
        if ext and ext not in (".ppm", ".png") and verbose:
            print(
                f"Render: unrecognized image extension '{ext}', "
                "defaulting to PPM output."
            )
        saved = image_io.save_image(output_image, output_filename)
        if verbose:
            if saved:
                print(f"Saved volume composited image to '{output_filename}'")
            else:
                print(f"Failed to save composited image to '{output_filename}'")
    return output_image, timing


def render_scene(
    output_filename: str,
    parameters: RenderParameters,
    geometry: SceneGeometry,
    camera: Optional[CameraParameters] = None,
    color_map: Optional[ColorMap] = None,
    num_ranks: int = 1,
    verbose: bool = True,
    method: str = "auto",
) -> Tuple[ImageBuffer, RenderTiming]:
    """Render with an explicit camera, or the seeded auto-orbit camera
    (VolumeRenderer.cpp:947-1101)."""
    if method == "auto":
        method = parameters.render_method
    validate_render_parameters(parameters)
    if verbose:
        # init banner (VolumeRenderer.cpp:582-585)
        print(
            "volume_renderer: Using JAX volume mapper on "
            f"{len(jax.devices())} {jax.default_backend()} device(s)"
        )

    bounds = compute_global_bounds(geometry)
    scalar_range = (
        geometry.scalar_range
        if geometry.has_scalar_range
        else compute_global_scalar_range(geometry)
    )

    if camera is None:
        camera = auto_orbit_camera(
            bounds, parameters.camera_seed, parameters.camera_up
        )
        label = "automatic"
    else:
        label = "explicit"

    if parameters.print_camera and verbose:
        print(
            f"Camera parameters ({label}):\n"
            f"  eye      = ({camera.eye[0]:g}, {camera.eye[1]:g}, {camera.eye[2]:g})\n"
            f"  look_at  = ({camera.look_at[0]:g}, {camera.look_at[1]:g}, "
            f"{camera.look_at[2]:g})\n"
            f"  up       = ({camera.up[0]:g}, {camera.up[1]:g}, {camera.up[2]:g})\n"
            f"  fov_y    = {camera.fov_y_degrees:g} degrees\n"
            f"  near     = {camera.near_plane:g}\n"
            f"  far      = {camera.far_plane:g}"
        )

    return render_single_trial(
        output_filename,
        parameters,
        geometry,
        bounds,
        scalar_range,
        camera,
        color_map,
        num_ranks=num_ranks,
        verbose=verbose,
        method=method,
    )


def render_orbit(
    output_pattern: str,
    parameters: RenderParameters,
    geometry: SceneGeometry,
    frames: int,
    camera: Optional[CameraParameters] = None,
    color_map: Optional[ColorMap] = None,
    total_degrees: float = 360.0,
    verbose: bool = True,
) -> None:
    """Render a ``frames``-frame orbit animation through the persistent
    batched renderer (prepare the scene once, one device dispatch per
    frame chunk).

    Beyond reference as a product surface: the reference renders one frame
    per process launch and its rotation miniapp re-runs the whole pipeline
    per frame (python/examples/render_volume_rotate.py); here the scene
    stays device-resident (fast_scene.FastSceneRenderer) and consecutive
    frames batch into single ``lax.scan`` dispatches
    (``render_batch``), across ``parameters.devices`` mesh devices when
    set.  The base camera (explicit, or the seeded auto-orbit of
    VolumeRenderer.cpp:974-1023) is frame 0 exactly; subsequent frames
    rotate it about the up axis (camera.orbit_camera_sequence).

    ``output_pattern`` must contain a ``{}``-style format field for the
    frame index (e.g. ``"frame_{:04d}.png"``).
    """
    from .camera import orbit_camera_sequence

    validate_render_parameters(parameters)
    if frames <= 0:
        raise ValueError("orbit frames must be positive")
    if parameters.render_method not in ("auto", "slicemarch", "tilemarch"):
        raise ValueError(
            "orbit rendering runs on the fast kernel family; "
            "render_method must be auto, slicemarch, or tilemarch "
            f"(got {parameters.render_method!r})"
        )
    try:
        output_pattern.format(0)
    except (IndexError, KeyError, ValueError) as error:
        raise ValueError(
            f"orbit output pattern {output_pattern!r} must format a frame "
            "index (e.g. 'frame_{:04d}.png')"
        ) from error

    if verbose:
        print(
            "volume_renderer: Using JAX volume mapper on "
            f"{len(jax.devices())} {jax.default_backend()} device(s)"
        )
    bounds = compute_global_bounds(geometry)
    if camera is None:
        camera = auto_orbit_camera(
            bounds, parameters.camera_seed, parameters.camera_up
        )
    cameras = orbit_camera_sequence(camera, frames, total_degrees)

    devices = parameters.devices or 1
    if devices > 1:
        from .parallel.persistent import MultiChipSceneRenderer

        renderer = MultiChipSceneRenderer(
            geometry,
            parameters,
            num_devices=devices,
            color_map=color_map,
            transport=parameters.multichip_transport,
        )
    else:
        from .fast_scene import FastSceneRenderer

        renderer = FastSceneRenderer(geometry, parameters, color_map)
    start = time.perf_counter()
    renderer.render_batch(cameras, output_pattern=output_pattern)
    if verbose:
        elapsed = time.perf_counter() - start
        print(
            f"Render: {frames} orbit frame(s) took {elapsed:.4f} s "
            f"({elapsed / frames * 1e3:.2f} ms/frame incl. host prep)"
        )
        print(f"Saved orbit frames to '{output_pattern}'")
