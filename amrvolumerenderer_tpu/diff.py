"""Differentiable volume rendering (beyond-reference capability).

The reference renderer is forward-only: ``Common/VolumePainter.cpp:735-922``
marches rays with nearest-cell sampling and a floor()'d 256-entry LUT
lookup, both of which have zero derivative with respect to the volume
values and a staircase derivative with respect to the transfer function.
Because this rebuild's compute path is pure JAX, a *smooth* formulation of
the same integral is automatically differentiable — this module provides
it, enabling gradient-based transfer-function design, volume fitting
(tomography-style inverse problems), and sensitivity analysis, none of
which the reference supports.

Differences from the forward oracle (``ops/raymarch.render_bucket_impl``),
chosen so gradients flow while the forward stays visually faithful:

  * **Trilinear** cell-center sampling (clamp-to-edge), the same stencil
    convention as the production kernels' ``sampling="trilinear"`` mode
    (``ops/slicemarch.py``) — piecewise-linear in the volume values, so
    ``d(image)/d(data)`` is well defined and nonzero.
  * **Linear interpolation between LUT entries** instead of floor()
    indexing — piecewise-linear in both the scalar and the table, so
    ``d(image)/d(color_table)`` is dense and the scalar chain rule is
    continuous across bin boundaries.
  * The opacity early-out (``accum.a < 1``) is kept as a gate: saturated
    pixels stop depending on deeper samples, exactly as in the forward
    path; the gradient is correct almost everywhere.

  Gradient surfaces: **volume data and transfer function** are the
  first-class, finite-difference-validated surfaces (the quadrature grid
  does not move with them).  Camera-pose gradients exist and are finite,
  but are subgradients of the fixed-step quadrature's staircase (the
  per-pixel step count jumps as the eye moves); treat them as descent
  directions, not exact sensitivities.

Everything is jit-compatible with static shapes; wrap any function here in
``jax.grad``/``jax.vjp``/``jax.jvp`` freely.  The module is self-contained
on purpose (no Pallas): hardware speed paths stay forward-only, and this
path is for optimization loops where XLA's AD is the product.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .camera import camera_basis
from .colormap import build_color_table
from .ops.raymarch import _ray_directions, _slab_intersect, max_steps_for_bucket
from .transforms import apply_scalar_transform, saturate_soft_tail


def trilinear_sample(
    brick: jnp.ndarray,  # [nx, ny, nz] padded values
    dims: jnp.ndarray,  # [3] int32 valid cell counts
    bmin: jnp.ndarray,  # [3] world lower corner
    cell_size: jnp.ndarray,  # [3] world cell span
    pos: jnp.ndarray,  # [N, 3] world sample positions
) -> jnp.ndarray:
    """Clamp-to-edge trilinear interpolation of cell-centered values.

    Sample points are expressed in cell-center coordinates
    ``f = (pos - bmin) / cell - 0.5`` (the production kernels' convention,
    ops/slicemarch.py trilinear branch) and clamped into the valid
    cell-center range, so positions outside the last half-cell take the
    face value.  Returns [N] float32; differentiable in ``brick`` and
    ``pos``.
    """
    f = (pos - bmin[None, :]) / cell_size[None, :] - 0.5
    hi = jnp.maximum(dims - 1, 0).astype(jnp.float32)
    f = jnp.clip(f, 0.0, hi[None, :])
    i0 = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, jnp.maximum(dims - 2, 0))
    w = jnp.clip(f - i0.astype(jnp.float32), 0.0, 1.0)
    i1 = jnp.minimum(i0 + 1, jnp.maximum(dims - 1, 0))

    pad_ny, pad_nz = brick.shape[1], brick.shape[2]
    flat = brick.reshape(-1)

    def at(ix, iy, iz):
        return jnp.take(flat, (ix * pad_ny + iy) * pad_nz + iz)

    x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
    x1, y1, z1 = i1[:, 0], i1[:, 1], i1[:, 2]
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    c00 = at(x0, y0, z0) * (1 - wx) + at(x1, y0, z0) * wx
    c10 = at(x0, y1, z0) * (1 - wx) + at(x1, y1, z0) * wx
    c01 = at(x0, y0, z1) * (1 - wx) + at(x1, y0, z1) * wx
    c11 = at(x0, y1, z1) * (1 - wx) + at(x1, y1, z1) * wx
    c0 = c00 * (1 - wy) + c10 * wy
    c1 = c01 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def lut_lookup_linear(lut: jnp.ndarray, normalized: jnp.ndarray) -> jnp.ndarray:
    """Continuous transfer-function lookup: lerp between adjacent entries.

    ``lut`` is [size, 4]; ``normalized`` in [0, 1].  The forward oracle
    floors the index (VolumePainter.cpp:858-866); this lerped variant is
    within half a bin of it and differentiable in both arguments.
    """
    table_max = lut.shape[0] - 1
    u = jnp.clip(normalized, 0.0, 1.0) * table_max
    j0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, max(table_max - 1, 0))
    w = jnp.clip(u - j0.astype(jnp.float32), 0.0, 1.0)[:, None]
    lo = jnp.take(lut, j0, axis=0)
    hi = jnp.take(lut, jnp.minimum(j0 + 1, table_max), axis=0)
    return lo * (1.0 - w) + hi * w


def render_layers_diff(
    data: jnp.ndarray,  # [B, nx, ny, nz] float32 padded raw values
    min_corner: jnp.ndarray,  # [B, 3] float32 world lower corners
    max_corner: jnp.ndarray,  # [B, 3] float32 world upper corners
    cell_dims: jnp.ndarray,  # [B, 3] int32 actual cell counts
    color_table: jnp.ndarray,  # [B, size, 4] float32 per-brick LUT
    sample_distance: jnp.ndarray,  # [B] float32 per-brick step
    eye: jnp.ndarray,  # [3] float32
    basis_forward: jnp.ndarray,  # [3]
    basis_right: jnp.ndarray,  # [3]
    basis_up: jnp.ndarray,  # [3]
    fov_y_degrees,  # scalar
    range_min,  # scalar
    inverse_range,  # scalar
    positive_floor=jnp.float32(0.0),
    normalization_min=jnp.float32(0.0),
    inverse_normalization_span=jnp.float32(1.0),
    *,
    width: int,
    height: int,
    num_steps: int,
    log_scale: bool = False,
    normalize: bool = False,
    clip_start: float = 1.0,
    apply_clip: bool = False,
    remat: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Differentiable twin of ``ops.raymarch.render_bucket_impl``.

    Same argument layout and front-to-back over-compositing semantics
    (VolumePainter.cpp:837-900), with trilinear sampling and lerped LUT
    lookup per the module docstring.  Returns ``(colors [B, H*W, 4],
    depths [B, H*W])``; depths carry NO gradient (they are the discrete
    box-entry hints used for ordering, not radiometric quantities).

    ``remat=True`` (default) checkpoints each march step: the backward
    pass recomputes step activations instead of storing all
    ``num_steps`` of them, so gradient memory is O(pixels), independent
    of march depth — the ``jax.checkpoint`` trade XLA is built for.
    Forward-only calls are unaffected.
    """
    aspect = jnp.float32(width) / jnp.float32(max(height, 1))
    directions = _ray_directions(
        width, height, fov_y_degrees, aspect,
        (basis_forward, basis_right, basis_up),
    )

    def render_one(brick, bmin, bmax, dims, lut, step):
        n = width * height
        tmin, tmax = _slab_intersect(eye, directions, bmin, bmax)
        hit = tmax >= tmin

        extent = bmax - bmin
        extent_mag = jnp.sqrt(jnp.sum(extent * extent))
        mesh_eps = extent_mag * 1e-4
        # sanitize miss rays: the slab guard leaves tmin = +inf on rays
        # with a zero direction component outside the box, and inf * 0
        # in the position math makes NaNs that AD propagates into the
        # cotangents even though the forward image is mask-clean — so
        # pin misses to a finite dummy distance before any arithmetic
        tmin_safe = jnp.where(hit, tmin, 0.0)
        d0 = tmin_safe + mesh_eps
        d0 = jnp.where(d0 < 0.0, mesh_eps, d0)

        dims_f = dims.astype(jnp.float32)
        cell_size = jnp.where(dims > 0, extent / jnp.maximum(dims_f, 1.0), 1.0)

        def body(carry, k):
            accum = carry
            dist = d0 + step * k.astype(jnp.float32)
            pos = eye[None, :] + directions * dist[:, None]
            inside = jnp.all(
                (pos >= bmin[None, :]) & (pos <= bmax[None, :]), axis=-1
            )
            active = hit & (dist < tmax) & inside & (accum[:, 3] < 1.0)

            raw = trilinear_sample(brick, dims, bmin, cell_size, pos)
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
            normalized = jnp.clip((scalar - range_min) * inverse_range, 0.0, 1.0)
            sample = lut_lookup_linear(lut, normalized)

            alpha = sample[:, 3] * (1.0 - accum[:, 3])
            alpha = jnp.where(active, alpha, 0.0)
            contrib = jnp.concatenate(
                [sample[:, :3] * alpha[:, None], alpha[:, None]], axis=-1
            )
            return accum + contrib, None

        init = jnp.zeros((n, 4), dtype=jnp.float32)
        step_fn = jax.checkpoint(body) if remat else body
        accum, _ = jax.lax.scan(step_fn, init, jnp.arange(num_steps))
        accum = jnp.clip(accum, 0.0, 1.0)

        entry = eye[None, :] + directions * tmin_safe[:, None]
        depth = jnp.sum((entry - eye[None, :]) * basis_forward[None, :], axis=-1)
        depth = jax.lax.stop_gradient(
            jnp.where(hit & (accum[:, 3] > 0.0) & jnp.isfinite(depth), depth, jnp.inf)
        )
        return jnp.where(hit[:, None], accum, 0.0), depth

    return jax.vmap(render_one)(
        data, min_corner, max_corner, cell_dims, color_table, sample_distance
    )


def composite_layers_diff(
    colors: jnp.ndarray,  # [B, N, 4] premultiplied RGBA layers
    order: Sequence[int] | jnp.ndarray,  # [B] front-to-back layer indices
) -> jnp.ndarray:
    """Ordered front-to-back over-composite of layers (differentiable).

    ``order`` is the visibility permutation (front first), host-computed
    exactly as for the forward pipeline (visibility.piece_order_keys);
    compositing itself is plain arithmetic, so gradients flow through
    every layer.  Mirrors DirectSendBase.cpp:400-446's accumulation.
    """
    ordered = jnp.take(colors, jnp.asarray(order, dtype=jnp.int32), axis=0)

    def body(accum, layer):
        trans = 1.0 - accum[:, 3:4]
        return accum + layer * trans, None

    init = jnp.zeros_like(ordered[0])
    out, _ = jax.lax.scan(body, init, ordered)
    return jnp.clip(out, 0.0, 1.0)


def render_image_diff(
    data,
    min_corner,
    max_corner,
    *args,
    order=None,
    **kwargs,
) -> jnp.ndarray:
    """Render all bricks and composite them: the one-call differentiable
    pipeline.  ``order`` defaults to the forward pipeline's depth-hint
    fallback — the minimum view depth over each box's 8 corners
    (camera.compute_box_depth_hints, VolumeRenderer.cpp:541-553) — so
    the default composite matches the product renderer's hint ordering;
    pass an explicit visibility permutation for graph-exact order.
    Returns [H*W, 4]."""
    colors, _ = render_layers_diff(data, min_corner, max_corner, *args, **kwargs)
    if order is None:
        eye, basis_forward = args[3], args[4]
        sel = jnp.asarray(
            [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], bool
        )  # [8, 3]
        corners = jnp.where(
            sel[None], max_corner[:, None, :], min_corner[:, None, :]
        )  # [B, 8, 3]
        # HIGHEST: a GPU may otherwise run this float32 contraction in
        # TF32, and the depth keys decide the compositing order
        key = jnp.min(
            jnp.einsum("bcx,x->bc", corners - eye[None, None, :],
                       basis_forward,
                       precision=jax.lax.Precision.HIGHEST),
            axis=1,
        )
        order = jnp.argsort(jax.lax.stop_gradient(key))
    return composite_layers_diff(colors, order)


render_image_diff_jit = functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "num_steps", "log_scale", "normalize",
        "clip_start", "apply_clip", "remat",
    ),
)(render_image_diff)


def prepare_scene(
    bricks,
    camera,
    *,
    width: int,
    height: int,
    color_map=None,
    scalar_range: Tuple[float, float] = (0.0, 1.0),
    box_transparency: float = 0.0,
    lut_size: int = 256,
    transform=None,
):
    """Assemble ``render_*_diff`` arguments from user-level scene inputs.

    ``bricks`` is a sequence of ``(data [nx, ny, nz], min_corner,
    max_corner)`` triples (raw scalar values, world corners); ``camera``
    a ``types.CameraParameters``.  Bricks are padded to a shared shape,
    and per-brick transfer-function LUTs are built with the forward
    pipeline's step-ratio opacity normalization (``1-(1-a)^(step/ref)``,
    VolumePainter.cpp:107-125) so opacity is march-step invariant —
    exactly the product renderer's LUT build (renderer.py render_layers).

    ``transform`` (a ``types.ScalarTransform``, default identity) threads
    the scene's log/normalize scalar pipeline and soft tail clip exactly
    as the product renderer does (renderer.py render_layers).

    Returns ``(args, static)`` such that
    ``render_image_diff(*args, **static)`` renders the scene; replace
    ``args[0]`` (data) or ``args[4]`` (LUT stack) with optimization
    variables to differentiate through them.
    """
    from .colormap import SOFT_CLIP_TOLERANCE
    from .types import ScalarTransform

    t = transform if transform is not None else ScalarTransform()
    n = len(bricks)
    if n == 0:
        raise ValueError("prepare_scene needs at least one brick")
    datas = [np.asarray(b[0], dtype=np.float32) for b in bricks]
    mins = np.asarray([b[1] for b in bricks], dtype=np.float32)
    maxs = np.asarray([b[2] for b in bricks], dtype=np.float32)
    dims = np.asarray([d.shape for d in datas], dtype=np.int32)
    pad = dims.max(axis=0)
    packed = np.zeros((n, *pad), dtype=np.float32)
    for i, d in enumerate(datas):
        packed[i, : d.shape[0], : d.shape[1], : d.shape[2]] = d

    spacing = (maxs - mins) / np.maximum(dims, 1)
    sample_distances = np.maximum(spacing.min(axis=1) * 0.5, 1e-5).astype(
        np.float32
    )
    # reference distance = the COARSEST brick's sample distance, matching
    # renderer.compute_reference_sample_distance (half the coarsest
    # min-spacing, VolumeRenderer.cpp:1138-1190) so per-brick opacity
    # normalization is identical to the product pipeline's LUT build
    ref = float(sample_distances.max())
    alpha_scale = float(np.clip(1.0 - box_transparency, 0.0, 1.0))
    luts = np.stack(
        [
            build_color_table(
                alpha_scale, float(s) / ref, scalar_range, color_map,
                size=lut_size,
            )
            for s in sample_distances
        ]
    ).astype(np.float32)

    num_steps = max_steps_for_bucket(mins, maxs, sample_distances)
    forward, right, up = camera_basis(camera)
    span = scalar_range[1] - scalar_range[0]
    args = (
        jnp.asarray(packed),
        jnp.asarray(mins),
        jnp.asarray(maxs),
        jnp.asarray(dims),
        jnp.asarray(luts),
        jnp.asarray(sample_distances),
        jnp.asarray(camera.eye, jnp.float32),
        jnp.asarray(forward, jnp.float32),
        jnp.asarray(right, jnp.float32),
        jnp.asarray(up, jnp.float32),
        jnp.float32(camera.fov_y_degrees),
        jnp.float32(scalar_range[0]),
        jnp.float32(1.0 / span if span != 0.0 else 1.0),
        jnp.float32(t.positive_floor),
        jnp.float32(t.normalization_min),
        jnp.float32(t.inverse_normalization_span),
    )
    clip_start = float(np.clip(scalar_range[1], 0.0, 1.0))
    static = dict(
        width=width,
        height=height,
        num_steps=num_steps,
        log_scale=bool(t.log_scale_input),
        normalize=bool(t.normalize_to_unit_range),
        clip_start=clip_start,
        apply_clip=bool(1.0 > clip_start + SOFT_CLIP_TOLERANCE),
    )
    return args, static


def prepare_geometry(
    geometry,
    camera,
    *,
    width: int,
    height: int,
    color_map=None,
    box_transparency: float = 0.0,
    lut_size: int = 256,
):
    """``prepare_scene`` from a built ``SceneGeometry`` — the bridge from
    the product ingestion paths (plotfile load, in-situ arrays) to the
    differentiable renderer.  Threads the geometry's scalar transform and
    its global transformed range — an explicit stored range when the scene
    carries one, else the computed global range, exactly as the forward
    pipeline selects it (renderer.py render_scene)."""
    # local import: renderer pulls in the full orchestration stack, which
    # the diff module otherwise does not need
    from .renderer import compute_global_scalar_range

    scalar_range = (
        geometry.scalar_range
        if geometry.has_scalar_range
        else compute_global_scalar_range(geometry)
    )
    return prepare_scene(
        [(b.data, b.min_corner, b.max_corner) for b in geometry.bricks],
        camera,
        width=width,
        height=height,
        color_map=color_map,
        scalar_range=scalar_range,
        box_transparency=box_transparency,
        lut_size=lut_size,
        transform=geometry.scalar_transform,
    )
