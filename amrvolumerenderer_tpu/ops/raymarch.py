"""Reference-semantics volume ray march (XLA/lax formulation).

Re-implements the per-pixel ray-cast of the reference renderer
(``Common/VolumePainter.cpp:735-922``) as a statically-shaped, jittable JAX
program: per-pixel ray generation from the camera basis, AABB slab
entry/exit, fixed-step front-to-back over-compositing with nearest-cell
sampling through a 256-entry transfer-function LUT, and a box-entry depth
hint output.

Design notes:
  * The reference's data-dependent ``while`` loops (entry skip + early-out on
    opacity saturation, VolumePainter.cpp:830-900) become a bounded
    ``lax.fori_loop`` with per-step *activity masks*.  Both reference loops
    advance on the same arithmetic distance grid ``d0 + k * step``, so a
    single masked loop reproduces their semantics exactly.
  * All bricks in a bucket share a padded shape, so the whole bucket renders
    as one ``vmap`` over the brick axis — one XLA program.
  * Nearest-cell sampling is a flat 1D gather (``jnp.take``) from the brick
    array; the fast paths are the slice march (``ops/slicemarch.py``)
    and the tile loop (``ops/tilemarch.py``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..transforms import apply_scalar_transform, saturate_soft_tail

COLOR_TABLE_SIZE = 256


def _ray_directions(width: int, height: int, fov_y_degrees, aspect, basis):
    """Per-pixel normalized ray directions (VolumePainter.cpp:741-766).

    Pixel (0, 0) is the *bottom-left* of the image (PPM/PNG writers emit rows
    bottom-to-top, SavePPM.cpp:25).  Returns [H*W, 3] float32.
    """
    forward, right, up = basis
    tan_half_fov = jnp.tan(fov_y_degrees * 0.5 * jnp.pi / 180.0)
    px = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    py = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0 - 1.0
    plane_x = (px * tan_half_fov * aspect)[None, :, None]  # [1, W, 1]
    plane_y = (py * tan_half_fov)[:, None, None]  # [H, 1, 1]
    d = forward[None, None, :] + plane_x * right[None, None, :] + plane_y * up[None, None, :]
    d = d.reshape(-1, 3)
    len_sq = jnp.sum(d * d, axis=-1, keepdims=True)
    inv_len = jnp.where(len_sq > 0.0, jax.lax.rsqrt(len_sq), 0.0)
    return d * inv_len


def _slab_intersect(origin, directions, min_corner, max_corner):
    """Slab AABB test with the reference's parallel-ray guard
    (VolumePainter.cpp:775-809).  Returns (tmin, tmax) arrays [N]."""
    o = origin[None, :]
    d = directions
    parallel = jnp.abs(d) < 1e-8
    safe_d = jnp.where(parallel, 1.0, d)
    inv = 1.0 / safe_d
    t1 = (min_corner[None, :] - o) * inv
    t2 = (max_corner[None, :] - o) * inv
    lo = jnp.minimum(t1, t2)
    hi = jnp.maximum(t1, t2)
    inside_axis = (o >= min_corner[None, :]) & (o <= max_corner[None, :])
    inf = jnp.asarray(jnp.inf, d.dtype)
    lo = jnp.where(parallel, jnp.where(inside_axis, -inf, inf), lo)
    hi = jnp.where(parallel, jnp.where(inside_axis, inf, -inf), hi)
    tmin = jnp.max(lo, axis=-1)
    tmax = jnp.min(hi, axis=-1)
    return tmin, tmax


def render_bucket_impl(
    data: jnp.ndarray,  # [B, nx, ny, nz] float32 padded raw values
    min_corner: jnp.ndarray,  # [B, 3] float32 world lower corners
    max_corner: jnp.ndarray,  # [B, 3] float32 world upper corners
    cell_dims: jnp.ndarray,  # [B, 3] int32 actual cell counts
    color_table: jnp.ndarray,  # [B, size, 4] float32 per-brick LUT
    sample_distance: jnp.ndarray,  # [B] float32 per-brick step
    eye: jnp.ndarray,  # [3] float32
    basis_forward: jnp.ndarray,  # [3] float32
    basis_right: jnp.ndarray,  # [3] float32
    basis_up: jnp.ndarray,  # [3] float32
    fov_y_degrees: jnp.ndarray,  # scalar float32
    range_min: jnp.ndarray,  # scalar float32
    inverse_range: jnp.ndarray,  # scalar float32
    positive_floor: jnp.ndarray,  # scalar float32
    normalization_min: jnp.ndarray,  # scalar float32
    inverse_normalization_span: jnp.ndarray,  # scalar float32
    *,
    width: int,
    height: int,
    num_steps: int,
    log_scale: bool,
    normalize: bool,
    clip_start: float,
    apply_clip: bool,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Render every brick of a bucket into full-frame RGBA+depth layers.

    Returns ``(colors [B, H*W, 4], depths [B, H*W])``; depth is the view-space
    distance of the box entry point (infinity where nothing accumulated),
    matching VolumePainter.cpp:912-921.
    """
    aspect = jnp.float32(width) / jnp.float32(max(height, 1))
    directions = _ray_directions(
        width, height, fov_y_degrees, aspect, (basis_forward, basis_right, basis_up)
    )  # [N, 3]

    def render_one(brick, bmin, bmax, dims, lut, step):
        n = width * height
        tmin, tmax = _slab_intersect(eye, directions, bmin, bmax)
        hit = tmax >= tmin

        extent = bmax - bmin
        extent_mag = jnp.sqrt(jnp.sum(extent * extent))
        mesh_eps = extent_mag * 1e-4

        d0 = tmin + mesh_eps
        d0 = jnp.where(d0 < 0.0, mesh_eps, d0)

        dims_f = dims.astype(jnp.float32)
        cell_size = jnp.where(dims > 0, extent / jnp.maximum(dims_f, 1.0), 1.0)

        nx, ny, nz = dims[0], dims[1], dims[2]
        pad_ny, pad_nz = brick.shape[1], brick.shape[2]
        flat = brick.reshape(-1)

        def body(k, accum):
            dist = d0 + step * jnp.float32(k)
            pos = eye[None, :] + directions * dist[:, None]
            inside = jnp.all((pos >= bmin[None, :]) & (pos <= bmax[None, :]), axis=-1)
            active = hit & (dist < tmax) & inside & (accum[:, 3] < 1.0)

            f = (pos - bmin[None, :]) / cell_size[None, :]
            idx = jnp.floor(f).astype(jnp.int32)
            idx = jnp.clip(idx, 0, jnp.maximum(dims - 1, 0)[None, :])
            flat_idx = (idx[:, 0] * pad_ny + idx[:, 1]) * pad_nz + idx[:, 2]
            raw = jnp.take(flat, flat_idx)

            scalar = apply_scalar_transform(
                raw,
                log_scale=log_scale,
                normalize=normalize,
                positive_floor=positive_floor,
                normalization_min=normalization_min,
                inverse_normalization_span=inverse_normalization_span,
            )
            if apply_clip:
                scalar = saturate_soft_tail(scalar, clip_start, 1.0)
            # table size follows the LUT argument's static shape (256 =
            # reference resolution; 128 = the opt-in fast mode)
            table_max = lut.shape[0] - 1
            normalized = jnp.clip((scalar - range_min) * inverse_range, 0.0, 1.0)
            lut_idx = jnp.clip(
                (normalized * table_max).astype(jnp.int32),
                0,
                table_max,
            )
            sample = jnp.take(lut, lut_idx, axis=0)  # [N, 4]

            alpha = sample[:, 3] * (1.0 - accum[:, 3])
            alpha = jnp.where(active, alpha, 0.0)
            contrib = jnp.concatenate(
                [sample[:, :3] * alpha[:, None], alpha[:, None]], axis=-1
            )
            return accum + contrib

        # derive the carry from the inputs so its varying-axis type matches
        # under shard_map (zeros built from a device-varying input stay
        # varying; a literal jnp.zeros would not)
        init_accum = jnp.zeros((n, 4), dtype=jnp.float32) * tmin[:, None] * 0.0
        init_accum = jnp.where(jnp.isfinite(init_accum), init_accum, 0.0)
        accum = jax.lax.fori_loop(0, num_steps, body, init_accum)
        accum = jnp.clip(accum, 0.0, 1.0)

        entry = eye[None, :] + directions * tmin[:, None]
        depth = jnp.sum((entry - eye[None, :]) * basis_forward[None, :], axis=-1)
        depth = jnp.where(
            hit & (accum[:, 3] > 0.0) & jnp.isfinite(depth), depth, jnp.inf
        )
        colors = jnp.where(hit[:, None], accum, 0.0)
        return colors, depth

    return jax.vmap(render_one)(
        data, min_corner, max_corner, cell_dims, color_table, sample_distance
    )


render_brick_bucket = functools.partial(
    jax.jit,
    static_argnames=(
        "width",
        "height",
        "num_steps",
        "log_scale",
        "normalize",
        "clip_start",
        "apply_clip",
    ),
)(render_bucket_impl)


def max_steps_for_bucket(
    min_corners: np.ndarray, max_corners: np.ndarray, sample_distances: np.ndarray
) -> int:
    """Static trip-count bound: longest box diagonal over the smallest step.

    Any ray's sampled path through a box is at most the box diagonal, so
    ``ceil(diag / step) + 2`` steps cover the reference's while loop
    (VolumePainter.cpp:837-900) for every pixel.
    """
    diag = np.linalg.norm(
        np.asarray(max_corners, dtype=np.float64)
        - np.asarray(min_corners, dtype=np.float64),
        axis=-1,
    )
    steps = np.where(
        sample_distances > 0, np.ceil(diag / np.maximum(sample_distances, 1e-30)), 0
    )
    if steps.size == 0:
        return 1
    return int(steps.max()) + 2
