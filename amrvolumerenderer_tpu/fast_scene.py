"""Persistent scene renderer: prepare once, render any camera fast.

The per-frame host preparation of the fast path (scalar pre-transform,
dominant-axis slice packing, padding) costs far more than the render itself
for animation workloads (camera orbits, time series at fixed scalar range —
BASELINE.md config 5).  ``FastSceneRenderer`` does all data-dependent work
once:

  * bricks are pre-transformed and split into <=32-cell cubes, then kept
    on device as a *canonical* [L, c, c, c] table (c <= 32);
  * per frame, a jitted device transform transposes the canonical table to
    the camera's dominant march axis and flattens slices into the packed
    1024-cell slice layout (flat row stride = c, consumed by the march's
    stride metadata) — no brick data ever revisits the host;
  * only the tiny per-frame host work remains: screen-bbox work list,
    depth-hint sort, camera packing.

Frames render through the tile loop (ops/tilemarch.py), whose memory
footprint follows the per-tile work list, never bricks x pixels.
"""

from __future__ import annotations

import functools
import math
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .camera import camera_basis
from .colormap import SOFT_CLIP_TOLERANCE, build_color_table
from .image import color_to_byte_device
from .ops import slicemarch as sm
from .renderer import (
    compute_global_bounds,
    compute_global_scalar_range,
    compute_reference_sample_distance,
    compute_tight_bounds,
    render_bounding_box_overlay,
    validate_render_parameters,
)
from .ops import tilemarch as tm
from .renderer_fast import _device_downsample, _pretransform
from .types import CameraParameters, ColorMap, RenderParameters, SceneGeometry

MAX_CUBE = 32  # largest canonical piece edge (32*32 = one packed slice)


def _ghost_fill_bricks(datas, bricks, ghost):
    """Cross-BRICK ghost rings: per-brick padded arrays whose rings at true
    brick faces carry neighbor-brick values (ghost.ghost_fill), so abutting
    bricks interpolate seam-free.  Returns [None]*n when not applicable."""
    if not ghost or len(bricks) < 2:
        return [None] * len(bricks)
    from .ghost import ghost_fill

    return ghost_fill(
        datas, [(b.min_corner, b.max_corner) for b in bricks], ghost
    )


def _cube_bounds(shape, min_corner, max_corner, cube):
    """Core pieces of a brick split into <= cube^3 blocks:
    [(lo, hi, mn, mx)] cell index bounds and world bounds."""
    spans = [
        (max_corner[d] - min_corner[d]) / shape[d] if shape[d] else 1.0
        for d in range(3)
    ]
    out = []
    for i0 in range(0, shape[0], cube):
        for j0 in range(0, shape[1], cube):
            for k0 in range(0, shape[2], cube):
                lo = np.array([i0, j0, k0])
                hi = np.minimum(lo + cube, shape)
                mn = np.asarray(min_corner) + lo * spans
                mx = np.asarray(min_corner) + hi * spans
                out.append((lo, hi, mn, mx))
    return out


def _split_to_cubes(data, min_corner, max_corner, cube, ghost=0, padded=None):
    """Split a brick into <= cube^3 CORE pieces.

    Returns [(block, mn, mx, core_dims), ...].  ``cube`` is the core edge;
    with ``ghost > 0`` each block carries a ``ghost``-cell ring on every
    axis (neighbor data of the same brick at split boundaries,
    edge-replicated at true brick faces) while ``mn``/``mx`` bound the core
    — the layout ops/slicemarch.march_items expects for seam-free
    trilinear.  Works for both host (np) and device (jnp) arrays; with
    ``ghost == 0`` blocks are metadata-only views.

    ``padded`` optionally supplies the ``ghost``-padded array so rings at
    true brick faces carry neighbor-brick data (ghost.ghost_fill) instead
    of edge replication."""
    xp = np if isinstance(data, np.ndarray) else jnp
    if padded is None:
        padded = xp.pad(data, ghost, mode="edge") if ghost else data
    else:
        assert ghost and tuple(padded.shape) == tuple(
            s + 2 * ghost for s in data.shape
        )
    pieces = []
    g2 = 2 * ghost
    for lo, hi, mn, mx in _cube_bounds(data.shape, min_corner, max_corner,
                                       cube):
        # core cell i sits at padded index i + ghost: the block
        # [lo, hi + 2*ghost) is the core plus its ring
        block = padded[lo[0]: hi[0] + g2, lo[1]: hi[1] + g2, lo[2]: hi[2] + g2]
        pieces.append((block, mn, mx, hi - lo))
    return pieces


@functools.partial(jax.jit, static_argnames=("axis", "cube"))
def _repack_for_axis(canonical: jnp.ndarray, *, axis: int, cube: int):
    """[L, c, c, c] canonical table -> [L, c, 8, 128] packed slices for the
    given march axis (flat row stride = c, zero padded to 1024 cells)."""
    axes = [axis] + [a for a in range(3) if a != axis]
    vol = jnp.transpose(canonical, (0, 1 + axes[0], 1 + axes[1], 1 + axes[2]))
    num = vol.shape[0]
    flat = vol.reshape(num, cube, cube * cube)
    pad = sm.SLICE_CELLS - cube * cube
    if pad:
        flat = jnp.pad(flat, ((0, 0), (0, 0), (0, pad)))
    return flat.reshape(num, cube, sm.SUBLANES, sm.LANES)


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "max_slices", "logical_width", "logical_height",
        "sampling", "ghost", "sqrt_aa", "bytes_out", "classification",
    ),
)
def _render_batch_frames(
    vol, lut, meta, dims, cams, offsets, bricks, owners, ibounds, tile_ids,
    *, width, height, max_slices, logical_width, logical_height,
    sampling, ghost, sqrt_aa, bytes_out=False, classification="post",
):
    """Run a [F]-frame camera batch through ONE jitted program.

    ``vol``/``meta``/``dims`` are axis-fixed (identical for every frame in
    the batch); only the camera pack and the CSR work list vary per frame
    (tm.tilemarch_render_batch).  Returns [F, out_pixels, 5] frames;
    ``bytes_out=True`` -> [F, out_pixels, 4] u8, ``bytes_out="rgb"`` ->
    [F, out_pixels, 3] u8 (the alpha byte dropped on device — PPM/PNG
    consumers never read it, and the readback shrinks with it)."""
    tiles_x = width // sm.TILE_W
    tiles_y = height // sm.TILE_H
    out_c, out_d = tm.tilemarch_render_batch(
        vol, meta, dims, lut, cams, offsets, bricks, owners, ibounds,
        tile_ids, width=width, height=height, max_slices=max_slices,
        logical_width=logical_width, logical_height=logical_height,
        sampling=sampling, ghost=ghost, classification=classification,
    )

    def assemble(out_c, out_d, tids):
        if bytes_out and sqrt_aa == 1:
            # byte-first assembly: encode the COMPACT output (Mesa codec,
            # image.color_to_byte_device), then scatter/untile in u8 and
            # drop the depth plane — 4-5x less HBM traffic than assembling
            # the float frame first (frame assembly is bandwidth-bound)
            enc = color_to_byte_device(out_c)
            if bytes_out == "rgb":
                enc = enc[:, :3]  # drop alpha before untiling: less HBM too
            nch = enc.shape[1]
            full = jnp.zeros(
                (tiles_x * tiles_y,) + enc.shape[1:], jnp.uint8
            ).at[tids].set(enc)
            c = full.reshape(tiles_y, tiles_x, nch, sm.TILE_H, sm.TILE_W)
            c = c.transpose(0, 3, 1, 4, 2).reshape(height, width, nch)
            return c[:logical_height, :logical_width].reshape(-1, nch)
        out_c, out_d = tm.scatter_tiles(
            out_c, out_d, tids, tiles_x * tiles_y
        )
        c = out_c.reshape(tiles_y, tiles_x, 4, sm.TILE_H, sm.TILE_W)
        c = c.transpose(0, 3, 1, 4, 2).reshape(height, width, 4)
        d = out_d.reshape(tiles_y, tiles_x, sm.TILE_H, sm.TILE_W)
        d = d.transpose(0, 2, 1, 3).reshape(height, width)
        frame = jnp.concatenate([c, d[..., None]], axis=-1)
        frame = frame[:logical_height, :logical_width].reshape(-1, 5)
        if sqrt_aa > 1:
            frame = _device_downsample(
                frame, logical_width, logical_height, sqrt_aa
            )
        if bytes_out:
            # Mesa byte codec on device: the readback shrinks 5x (4 u8 vs
            # 4+1 f32 per pixel); "rgb" drops the alpha byte too
            frame = color_to_byte_device(frame[:, :4])
            if bytes_out == "rgb":
                frame = frame[:, :3]
        return frame

    return jax.vmap(assemble)(out_c, out_d, tile_ids)


class FastSceneRenderer:
    """Device-resident scene prepared once; per-camera frames on demand.

    Parameters mirror ``renderer.render_scene``.  The scalar range and
    brick layout are fixed at construction; ``set_transfer_function``
    swaps the colormap / box transparency per frame and ``update_data``
    ingests new timestep values in place (the reference re-prepares the
    whole pipeline per run, miniapps/renderVolume*.cpp)."""

    def __init__(
        self,
        geometry: SceneGeometry,
        parameters: RenderParameters,
        color_map: Optional[ColorMap] = None,
        precision: str = "float32",
    ):
        # host-side canonical piece table; the device-ingest path
        # (device_scene.prepare_device_scene) builds it with jnp ops instead
        scalar_range = (
            geometry.scalar_range
            if geometry.has_scalar_range
            else compute_global_scalar_range(geometry)
        )
        clip_start = float(np.clip(scalar_range[1], 0.0, 1.0))
        apply_clip = 1.0 > clip_start + SOFT_CLIP_TOLERANCE
        t = geometry.scalar_transform
        # trilinear: 1-cell ghost rings make cube splits seam-free (core
        # shrinks to MAX_CUBE - 2 so the stored slice still fits 1024 cells)
        ghost = 1 if parameters.sampling == "trilinear" else 0
        core = MAX_CUBE - 2 * ghost
        datas = [
            _pretransform(brick.data, t, clip_start, apply_clip)
            for brick in geometry.bricks
        ]
        padded_list = _ghost_fill_bricks(datas, geometry.bricks, ghost)
        pieces = []
        piece_meta = []
        piece_ranges = []
        for parent, brick in enumerate(geometry.bricks):
            data = datas[parent]
            for d, mn, mx, dims in _split_to_cubes(
                data, brick.min_corner, brick.max_corner, core, ghost=ghost,
                padded=padded_list[parent],
            ):
                pieces.append(d)
                piece_meta.append((mn, mx, dims, parent))
                piece_ranges.append((float(np.min(d)), float(np.max(d))))
        num = len(pieces)
        if num == 0:
            raise ValueError("scene contains no bricks")
        canonical = np.zeros((num, MAX_CUBE, MAX_CUBE, MAX_CUBE), np.float32)
        for i, d in enumerate(pieces):
            canonical[i, : d.shape[0], : d.shape[1], : d.shape[2]] = d
        self._init_from_canonical(
            geometry, parameters, color_map, jnp.asarray(canonical),
            piece_meta, piece_ranges=piece_ranges,
            precision=precision, ghost=ghost,
        )

    def _init_from_canonical(
        self,
        geometry: SceneGeometry,
        parameters: RenderParameters,
        color_map: Optional[ColorMap],
        canonical: jnp.ndarray,  # [L, MAX_CUBE^3] device piece table
        piece_meta,  # list of (min_corner, max_corner, dims, parent)
        piece_ranges=None,  # optional [(vmin, vmax)] for transparency culling
        precision: str = "float32",
        ghost: int = 0,  # ghost-ring width baked into ``canonical``
    ):
        validate_render_parameters(parameters)
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported precision {precision!r}")
        self.precision = precision
        self.parameters = parameters

        self.bounds = compute_global_bounds(geometry)
        self.tight_bounds = compute_tight_bounds(geometry, self.bounds)
        self.scalar_range = (
            geometry.scalar_range
            if geometry.has_scalar_range
            else compute_global_scalar_range(geometry)
        )
        self.reference_sample_distance = compute_reference_sample_distance(
            geometry, self.bounds
        )

        sqrt_aa = int(round(math.sqrt(parameters.antialiasing)))
        self.sqrt_aa = max(sqrt_aa, 1)
        self.render_width = parameters.width * self.sqrt_aa
        self.render_height = parameters.height * self.sqrt_aa
        self.pad_w = -(-self.render_width // sm.TILE_W) * sm.TILE_W
        self.pad_h = -(-self.render_height // sm.TILE_H) * sm.TILE_H

        alpha_scale = float(np.clip(1.0 - parameters.box_transparency, 0, 1))
        lut = build_color_table(
            alpha_scale, 1.0, self.scalar_range, color_map,
            size=parameters.lut_size,
        )
        self._lut = sm.build_log_lut(lut)
        self._lut_alpha = lut[:, 3].copy()

        # space skipping: mask pieces whose value range maps entirely to
        # zero opacity under the transfer function (the coarse-grained
        # analogue of empty-space skipping in GPU AMR renderers); kept as a
        # mask so set_transfer_function can re-derive it
        self.piece_ranges = piece_ranges
        if piece_ranges is not None:
            self.visible = np.array(
                [self._range_visible(vmin, vmax, self._lut_alpha)
                 for vmin, vmax in piece_ranges],
                dtype=bool,
            )
        else:
            self.visible = np.ones(canonical.shape[0], dtype=bool)

        num = canonical.shape[0]
        self.cube = MAX_CUBE  # stored edge (= row stride / max_slices)
        self.ghost = ghost
        self.core = MAX_CUBE - 2 * ghost  # largest piece core edge
        self.box_min = np.zeros((num, 3))
        self.box_max = np.zeros((num, 3))
        self.dims_world = np.zeros((num, 3), np.int32)
        self.parents = np.zeros(num, np.int32)
        for i, (mn, mx, dims, parent) in enumerate(piece_meta):
            self.box_min[i] = mn
            self.box_max[i] = mx
            self.dims_world[i] = dims
            self.parents[i] = parent
        if precision == "bfloat16":
            # half the device memory and traffic per brick; the march
            # upcasts each sample to f32.  LUT-index quantization
            # from the 8-bit mantissa stays well inside the 0.02 pixel-parity
            # tolerance (BASELINE.md).
            canonical = canonical.astype(jnp.bfloat16)
        self._set_canonical(canonical)
        self.owners = np.array(
            [geometry.bricks[p].owner for p in self.parents], np.int32
        )
        self.geometry = geometry
        self._lut_device = jnp.asarray(self._lut)
        # per-octant ordering-key memo: boxes never move (update_data swaps
        # field values only), so an animation orbit pays the graph build at
        # most once per view octant (visibility.OrderKeyCache)
        self._parent_min = np.array([b.min_corner for b in geometry.bricks])
        self._parent_max = np.array([b.max_corner for b in geometry.bricks])
        from .visibility import OrderKeyCache

        self._order_cache = OrderKeyCache(
            self.box_min, self.box_max, self._parent_min, self._parent_max
        )

    def _set_canonical(self, canonical: jnp.ndarray) -> None:
        """(Re)place the device piece table and refresh value-derived state."""
        self.canonical = canonical
        # per-axis per-slice value extrema (device reduction, [L, core] to
        # host) for fine-grained empty-space skipping: the march
        # only visit slices whose values can map to nonzero alpha.  Core
        # slice k is stored at k + ghost; its in-plane ghost ring joins the
        # extrema (bilinear can sample into it — conservative, never skips
        # a contributing slice)
        g = self.ghost
        self._slice_minmax = {}
        self._slice_quad_minmax = {}
        self._occ_bits_cache = {}  # axis -> [L, S] u64 (per LUT, see
        #                            tm.block_occupancy_bits)
        # (u, v) blocks per axis for per-(tile, brick) slice bounds: 8x8
        # (4x4-cell blocks on the 32-cube) — measured on the bench thin
        # shell: ~14% fewer marched slices than 4x4 at negligible extra
        # host cost (the masks are uint64 either way)
        nq = 8 if self.cube % 8 == 0 else 4
        self._quad_blocks = nq
        self._quad_split = self.cube // nq  # stored-coordinate block edge
        for a in range(3):
            v = jnp.moveaxis(canonical, 1 + a, 1)
            if g:
                v = v[:, g: v.shape[1] - g]
            self._slice_minmax[a] = (
                np.asarray(v.min(axis=(2, 3)).astype(jnp.float32)),
                np.asarray(v.max(axis=(2, 3)).astype(jnp.float32)),
            )
            # per-slice extrema over nq x nq stored (u, v) blocks for
            # per-(tile, brick) slice bounds
            # (ops.tilemarch.compute_item_slice_bounds); one stacked device
            # reduction + one transfer per axis
            num, s_cap, c, _ = v.shape
            blocks = v.reshape(num, s_cap, nq, c // nq, nq, c // nq)
            quads = jnp.stack([
                blocks.min(axis=(3, 5)), blocks.max(axis=(3, 5)),
            ]).astype(jnp.float32)  # [2(min/max), L, S, nq, nq]
            host = np.asarray(quads)
            self._slice_quad_minmax[a] = (host[0], host[1])
        self._packed_axis: Optional[int] = None
        self._packed_vol: Optional[jnp.ndarray] = None
        # per-axis (meta, dims) tables, host + device twins: camera-
        # independent for a fixed LUT, so per-frame prep can skip both the
        # rebuild and the device upload (the dims[:, 7] occupied ranges
        # depend on the transfer function — set_transfer_function clears)
        self._axis_meta_cache: dict = {}
        # per-axis repack cache: an orbit crossing march axes would
        # otherwise re-transpose (one device dispatch) on every switch;
        # at most 3 copies of the canonical table live on device
        self._packed_cache: dict = {}

    def update_data(self, brick_arrays) -> None:
        """Per-timestep in-situ update: new scalar values, same brick layout.

        The time-series workload (the reference's renderVolumeTime miniapp,
        miniapps/renderVolumeTime.cpp) re-renders a fixed grid hierarchy as
        values evolve under a fixed scalar range and transfer function.
        This swaps the device piece table in place: for device (jnp)
        inputs, pre-transform + cube split + slice-extrema reduction run on
        device (the values never visit the host); for host (NumPy) inputs —
        the plotfile-driven time series — the whole piece table is
        assembled on host and ships as ONE upload instead of one device
        op per brick.  Camera metadata, owners, hints and the LUT are untouched.
        ``brick_arrays`` must match ``geometry.bricks`` in order and shape.
        """
        from .device_scene import _pretransform_device, pack_device_pieces

        bricks = self.geometry.bricks
        if len(brick_arrays) != len(bricks):
            raise ValueError(
                f"expected {len(bricks)} brick arrays, got {len(brick_arrays)}"
            )
        t = self.geometry.scalar_transform
        clip_start = float(np.clip(self.scalar_range[1], 0.0, 1.0))
        apply_clip = 1.0 > clip_start + SOFT_CLIP_TOLERANCE

        for brick, arr in zip(bricks, brick_arrays):
            if tuple(arr.shape) != tuple(brick.data.shape):
                raise ValueError(
                    f"brick shape changed: {arr.shape} vs {brick.data.shape}"
                )
        if not all(isinstance(a, np.ndarray) for a in brick_arrays):
            datas = [
                _pretransform_device(jnp.asarray(a), t, clip_start, apply_clip)
                for a in brick_arrays
            ]
            canonical, piece_ranges, _meta = pack_device_pieces(
                datas, bricks, self.core, self.ghost, self.cube,
                self.canonical.dtype,
            )
        else:
            datas = [_pretransform(a, t, clip_start, apply_clip)
                     for a in brick_arrays]
            padded_list = _ghost_fill_bricks(datas, bricks, self.ghost)
            piece_arrays = []
            piece_ranges = []
            for parent, brick in enumerate(bricks):
                for block, _mn, _mx, _dims in _split_to_cubes(
                    datas[parent], brick.min_corner, brick.max_corner,
                    self.core, ghost=self.ghost, padded=padded_list[parent],
                ):
                    piece_ranges.append(
                        (float(block.min()), float(block.max()))
                    )
                    buf = np.zeros((self.cube,) * 3, np.float32)
                    buf[: block.shape[0], : block.shape[1],
                        : block.shape[2]] = block
                    piece_arrays.append(buf)
            # one stacked f32 upload; bf16 storage casts on device
            canonical = jnp.asarray(np.stack(piece_arrays)).astype(
                self.canonical.dtype
            )
        if canonical.shape != self.canonical.shape:
            raise ValueError(
                "piece table shape changed; construct a new renderer for a "
                "regridded hierarchy"
            )
        self._set_canonical(canonical)
        self.piece_ranges = piece_ranges
        self.visible = np.array(
            [self._range_visible(vmin, vmax, self._lut_alpha)
             for vmin, vmax in piece_ranges],
            dtype=bool,
        )

    def set_transfer_function(
        self,
        color_map: Optional[ColorMap] = None,
        box_transparency: Optional[float] = None,
    ) -> None:
        """Swap the colormap / per-box transparency without repacking bricks.

        Only the 2 KB LUT and the piece-visibility mask change (the scalar
        range and soft clip are baked into the brick data at prepare time,
        exactly as the reference fixes them per run)."""
        if box_transparency is not None:
            self.parameters.box_transparency = box_transparency
        alpha_scale = float(
            np.clip(1.0 - self.parameters.box_transparency, 0.0, 1.0)
        )
        lut = build_color_table(
            alpha_scale, 1.0, self.scalar_range, color_map,
            size=self.parameters.lut_size,
        )
        self._lut = sm.build_log_lut(lut)
        self._lut_alpha = lut[:, 3].copy()
        self._lut_device = jnp.asarray(self._lut)
        self._occ_bits_cache = {}  # block occupancy depends on the LUT
        self._axis_meta_cache = {}  # dims[:, 7] depends on the LUT
        if self.piece_ranges is not None:
            self.visible = np.array(
                [self._range_visible(vmin, vmax, self._lut_alpha)
                 for vmin, vmax in self.piece_ranges],
                dtype=bool,
            )

    def _range_visible(
        self, vmin: float, vmax: float, lut_alpha: np.ndarray
    ) -> bool:
        """Does any LUT entry within the piece's value range have alpha > 0?"""
        lo, hi = self.scalar_range
        span = hi - lo if hi != lo else 1.0
        table_max = len(lut_alpha) - 1  # table size follows the LUT
        i0 = int(np.clip((vmin - lo) / span * table_max, 0, table_max))
        i1 = int(np.clip((vmax - lo) / span * table_max, 0, table_max))
        return bool(lut_alpha[i0 : i1 + 1].max() > 0.0)

    def _axis_metadata(self, axis: int):
        """Host-side per-axis brick tables: (meta [L, 12] f32, dims [L, 8]
        i32) in the march's permuted (march-axis-first) layout, with the
        LUT-dependent occupied-slice range in dims[:, 7] (recomputed per
        call — it changes with the transfer function)."""
        axes = [axis] + [a for a in range(3) if a != axis]
        num = self.canonical.shape[0]
        meta = np.zeros((num, 12), np.float32)
        dims = np.zeros((num, 8), np.int32)
        meta[:, 0:3] = self.box_min[:, axes]
        meta[:, 3:6] = self.box_max[:, axes]
        dw = self.dims_world[:, axes].astype(np.float64)
        meta[:, 6:9] = (self.box_max[:, axes] - self.box_min[:, axes]) / dw
        dims[:, 0:3] = self.dims_world[:, axes]
        dims[:, 3:6] = axes
        dims[:, 6] = self.cube  # canonical row stride
        range_min = self.scalar_range[0]
        span = self.scalar_range[1] - range_min
        smin, smax = self._slice_minmax[axis]
        dims[:, 7] = sm.compute_slice_bounds_batch(
            smin, smax, self._lut_alpha, range_min,
            1.0 / span if span != 0.0 else 1.0, dims[:, 0],
        )
        return meta, dims

    def _pack_cam(self, camera: CameraParameters, forward, right, up):
        """The 20-float camera pack (slicemarch.pack_camera layout)."""
        range_span = self.scalar_range[1] - self.scalar_range[0]
        return sm.pack_camera(
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees,
            self.render_width / max(self.render_height, 1),
            self.scalar_range[0],
            1.0 / range_span if range_span != 0.0 else 1.0,
            self.reference_sample_distance,
        )

    def _finish_frame(
        self,
        pixels: np.ndarray,
        camera: CameraParameters,
        output_filename: Optional[str],
        overlay: bool,
    ) -> np.ndarray:
        """Shared render() tail: wireframe overlay + save (the reference
        always overlays, VolumeRenderer.cpp:1311-1314)."""
        if overlay or output_filename:
            from .image import ImageBuffer, ImageKind

            image = ImageBuffer(
                ImageKind.RGBA_F32_DEPTH_SORT,
                self.parameters.width,
                self.parameters.height,
                pixels.copy(),
            )
            if overlay:
                render_bounding_box_overlay(
                    self.tight_bounds, camera, 1, image
                )
            if output_filename:
                from . import io as image_io

                image_io.save_image(image, output_filename)
            return image.pixels
        return pixels

    def frame_inputs(self, camera: CameraParameters, as_numpy: bool = False):
        """Per-frame preparation for one camera: march-axis repack (device,
        cached per axis), piece metadata / occupied-slice bounds, camera
        packing, and the CSR tile work list with transparency culling.

        This is ALL the work ``render`` does besides the device render call
        itself — exposed so benchmarks can time per-frame host prep and the
        device frame separately (the reference's per-stage timers,
        VolumeRenderer.cpp:1121-1136).  Returns a dict of tilemarch
        arguments, or None when every work item was culled."""
        forward, right, up = camera_basis(camera)
        axis = sm.choose_march_axis(forward)
        axes = [axis] + [a for a in range(3) if a != axis]

        if self._packed_axis != axis:
            vol = self._packed_cache.get(axis)
            if vol is None:
                vol = _repack_for_axis(
                    self.canonical, axis=axis, cube=self.cube
                )
                self._packed_cache[axis] = vol
            self._packed_vol = vol
            self._packed_axis = axis

        cached = self._axis_meta_cache.get(axis)
        if cached is None:
            meta, dims = self._axis_metadata(axis)
            cached = (meta, dims, jnp.asarray(meta), jnp.asarray(dims))
            self._axis_meta_cache[axis] = cached
        meta, dims, meta_dev, dims_dev = cached
        cam = self._pack_cam(camera, forward, right, up)
        # piece-level visibility-graph order keys when available (EXACT
        # view-consistent ordering over the piece partition — scalar depth
        # hints misorder interleaved pieces); hints are the fallback, and
        # --no-visibility-graph opts out (visibility.order_keys_or_hints)
        from .visibility import order_keys_or_hints

        hints = order_keys_or_hints(
            camera, self.render_width / max(self.render_height, 1),
            self.box_min, self.box_max,
            use_graph=self.parameters.use_visibility_graph,
            parents=self.parents,
            parent_min=self._parent_min,
            parent_max=self._parent_max,
            cache=self._order_cache,
        )
        offsets, tbricks, towners = tm.build_tile_worklist(
            self.box_min, self.box_max, hints, self.owners,
            np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
            self.pad_w, self.pad_h,
            logical_width=self.render_width,
            logical_height=self.render_height,
        )
        if not self.visible.all():
            keep = self.visible[tbricks]
            tiles_of_items = np.repeat(
                np.arange(len(offsets) - 1), np.diff(offsets)
            )[keep]
            tbricks = tbricks[keep]
            towners = towners[keep]
            counts = np.bincount(tiles_of_items, minlength=len(offsets) - 1)
            offsets = np.zeros(len(counts) + 1, dtype=np.int32)
            np.cumsum(counts, out=offsets[1:])
        if len(tbricks) == 0:
            return None
        # per-(tile, brick) slice bounds: tighten each work item's march
        # range to its tile's footprint on the brick (sparse scenes march
        # only the slices the tile's rays can actually hit)
        occ_bits = self._occ_bits_cache.get(axis)
        if occ_bits is None:
            range_min = self.scalar_range[0]
            span = self.scalar_range[1] - range_min
            qmin, qmax = self._slice_quad_minmax[axis]
            occ_bits = tm.block_occupancy_bits(
                qmin, qmax, self._lut_alpha, range_min,
                1.0 / span if span != 0.0 else 1.0,
            )
            self._occ_bits_cache[axis] = occ_bits
        wt_final = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
        band1, band2, march_forward = tm.compute_item_bands(
            meta, dims[:, 7], wt_final, tbricks,
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees, axes, self.pad_w, self.pad_h,
            self.render_width, self.render_height,
            occ_bits, self._quad_blocks, self._quad_split,
            ghost=self.ghost,
            # 2-slice footprint segments + the tight per-sampling-mode hull
            # pad: measured -16% marched slice-iterations on the bench thin
            # shell, -9% on the dense 3-level scene vs the legacy
            # (seg4, ghost+2) config (scripts/bounds_variant_sweep.py)
            seg_len=2,
            margin=tm.footprint_margin(
                self.ghost, self.parameters.sampling
            ),
        )
        # two-sided chords (shells, bubble walls): split the occupied
        # range into separate entry/exit bands so the empty middle is
        # never marched (tm.expand_bands)
        wt_final, tbricks, towners, item_bounds = tm.expand_bands(
            wt_final, tbricks, towners, band1, band2, march_forward,
        )
        counts = np.bincount(wt_final, minlength=len(offsets) - 1)
        offsets = np.zeros(len(counts) + 1, dtype=np.int32)
        np.cumsum(counts, out=offsets[1:])
        # drop fully-empty work items: a (tile, brick) whose tightened range
        # is empty contributes nothing but still costs its march setup and
        # a slot in the tile fold — on sparse transfer functions
        # that is ~half the items
        nonempty = (item_bounds >> 16) < (item_bounds & 0xFFFF)
        if not nonempty.all():
            wt_final = wt_final[nonempty]
            counts = np.bincount(wt_final, minlength=len(offsets) - 1)
            tbricks = tbricks[nonempty]
            towners = towners[nonempty]
            item_bounds = item_bounds[nonempty]
            offsets = np.zeros(len(counts) + 1, dtype=np.int32)
            np.cumsum(counts, out=offsets[1:])
            if len(tbricks) == 0:
                return None
        # compacted list: one step per COVERED tile (empty tiles cost
        # nothing).  Step counts bucket so an orbit compiles a handful of
        # shapes; padding steps carry the out-of-bounds sentinel tile (zero
        # items, dropped by the scatter).
        counts = np.diff(offsets)
        covered = np.flatnonzero(counts > 0).astype(np.int32)
        num_tiles = len(counts)
        active = len(covered)
        gran = max(128, num_tiles // 8)
        padded_steps = min(num_tiles, -(-active // gran) * gran)
        tile_ids = np.full(padded_steps, num_tiles, np.int32)  # sentinel
        tile_ids[:active] = covered
        c_offsets = np.zeros(padded_steps + 1, np.int32)
        c_offsets[1 : active + 1] = np.cumsum(counts[covered])
        c_offsets[active + 1 :] = c_offsets[active]
        offsets = c_offsets
        if as_numpy:
            # batch path: keep host arrays so a whole chunk ships as ONE
            # stacked transfer per table
            return dict(
                meta=meta, dims=dims, cam=cam, offsets=offsets,
                bricks=tbricks, owners=towners, item_bounds=item_bounds,
                tile_ids=tile_ids,
            )
        return dict(
            meta=meta_dev, dims=dims_dev,
            cam=jnp.asarray(cam), offsets=jnp.asarray(offsets),
            bricks=jnp.asarray(tbricks), owners=jnp.asarray(towners),
            item_bounds=jnp.asarray(item_bounds),
            tile_ids=jnp.asarray(tile_ids),
        )

    def render(
        self,
        camera: CameraParameters,
        output_filename: Optional[str] = None,
        overlay: bool = True,
    ) -> np.ndarray:
        """Render one frame; returns the output-resolution [W*H, 5] image.

        ``overlay`` draws the tight-bounds wireframe (the reference always
        does, VolumeRenderer.cpp:1311-1314); ``output_filename`` saves a
        PPM/PNG like renderSingleTrial."""
        inputs = self.frame_inputs(camera)
        if inputs is None:
            # everything culled (e.g. fully transparent transfer function)
            frame = jnp.zeros(
                (self.render_height * self.render_width, 5), jnp.float32
            ).at[:, 4].set(jnp.inf)
        else:
            out_c, out_d = tm.tilemarch_render(
                self._packed_vol, inputs["meta"], inputs["dims"],
                self._lut_device, inputs["cam"], inputs["offsets"],
                inputs["bricks"], inputs["owners"], inputs["item_bounds"],
                inputs["tile_ids"],
                width=self.pad_w, height=self.pad_h, max_slices=self.cube,
                logical_width=self.render_width,
                logical_height=self.render_height,
                sampling=self.parameters.sampling,
                ghost=self.ghost,
                classification=self.parameters.classification,
            )
            tiles_x = self.pad_w // sm.TILE_W
            tiles_y = self.pad_h // sm.TILE_H
            out_c, out_d = tm.scatter_tiles(
                out_c, out_d, inputs["tile_ids"], tiles_x * tiles_y
            )
            c = out_c.reshape(tiles_y, tiles_x, 4, sm.TILE_H, sm.TILE_W)
            c = c.transpose(0, 3, 1, 4, 2).reshape(self.pad_h, self.pad_w, 4)
            d = out_d.reshape(tiles_y, tiles_x, sm.TILE_H, sm.TILE_W)
            d = d.transpose(0, 2, 1, 3).reshape(self.pad_h, self.pad_w)
            frame = jnp.concatenate([c, d[..., None]], axis=-1)
            frame = frame[: self.render_height, : self.render_width].reshape(
                -1, 5
            )
        if self.sqrt_aa > 1:
            frame = _device_downsample(
                frame, self.render_width, self.render_height, self.sqrt_aa
            )
        pixels = np.asarray(frame)
        return self._finish_frame(pixels, camera, output_filename, overlay)

    def render_batch(
        self,
        cameras,
        overlay: bool = True,
        output_pattern: Optional[str] = None,
        max_chunk_bytes: int = 64 << 20,
        bytes_out: bool = False,
    ) -> np.ndarray:
        """Render a camera sequence with ONE device dispatch per chunk.

        The animation workloads (orbits, time series — the reference's
        render_volume_rotate.py / render_volume_time.py drive one blocking
        render() per frame) pay a host->device round trip per frame; on a
        dispatch-latency-bound link that dominates the frame time.  This
        batches consecutive same-march-axis frames into a single jitted
        program over the tile loop: per chunk, one dispatch and
        one [B, pixels, 5] readback (chunked under ``max_chunk_bytes``).

        Only the 20-float camera pack and the CSR work list vary per frame
        (brick metadata is axis-fixed), so work lists are padded to a
        power-of-two bucket and chunks to a fixed size — a long orbit
        compiles a handful of programs total.  Frames whose work list culls
        away entirely come back as cleared frames, matching ``render``.

        Returns [len(cameras), width*height, 5] float32 frames in input
        order; ``output_pattern`` (e.g. "frame_{:04d}.ppm") saves each.
        With ``bytes_out=True`` frames come back as [B, width*height, 4]
        RGBA uint8 (the Mesa byte codec applied on device): the readback
        shrinks 5x — the right mode when the frames are headed for
        PPM/PNG anyway.  ``bytes_out="rgb"`` additionally drops the alpha
        byte on device ([B, width*height, 3]): PPM/PNG never read it, and
        on a readback-bound link that is a further 25% off the frame
        time.  ``overlay`` requires float frames.
        Beyond reference — the reference has no batched render entry.
        """
        cameras = list(cameras)
        if bytes_out and overlay:
            raise ValueError("bytes_out requires overlay=False (the "
                             "wireframe overlay blends float pixels)")
        num_out = self.parameters.width * self.parameters.height
        chans = (3 if bytes_out == "rgb" else 4) if bytes_out else 5
        frame_bytes = num_out * (chans if bytes_out else 5 * 4)

        def prep(i, camera):
            inputs = self.frame_inputs(camera, as_numpy=True)
            if inputs is None:
                if bytes_out:
                    empty = np.zeros((num_out, chans), np.uint8)
                else:
                    empty = np.zeros((num_out, chans), np.float32)
                    empty[:, 4] = np.inf
                return None, empty
            return self._packed_axis, (i, inputs, self._packed_vol)

        def begin_group(axis, group):
            meta = jnp.asarray(group[0][1]["meta"])
            dims = jnp.asarray(group[0][1]["dims"])
            w_max = max(int(len(g[1]["bricks"])) for g in group)
            w_pad = 1 << max(w_max - 1, 0).bit_length()  # pow2 bucket
            return group[0][2], meta, dims, w_pad

        def chunk_cap(group, ctx):
            # frames per dispatch: bounded by the readback bytes alone
            return min(16, max_chunk_bytes // frame_bytes)

        def pack(part, ctx):
            """All stacking/padding happens in host NumPy (charged to
            host_prep_ms); each chunk then ships as a handful of device
            transfers regardless of frame count."""
            _vol, _meta, _dims, w_pad = ctx
            cams = np.stack([p[1]["cam"] for p in part])
            # compacted grids vary per frame: pad each frame's step
            # list to the chunk max with the sentinel tile (zero items,
            # dropped by the scatter)
            num_tiles = (self.pad_w // sm.TILE_W) * (
                self.pad_h // sm.TILE_H
            )
            s_steps = max(len(p[1]["tile_ids"]) for p in part)
            offs = np.zeros((len(part), s_steps + 1), np.int32)
            tids = np.full((len(part), s_steps), num_tiles, np.int32)
            brs = np.zeros((len(part), w_pad), np.int32)
            ows = np.zeros((len(part), w_pad), np.int32)
            ibs = np.zeros((len(part), w_pad), np.int32)
            for row, (_idx, inp, _vol) in enumerate(part):
                w = len(inp["bricks"])
                brs[row, :w] = inp["bricks"]
                ows[row, :w] = inp["owners"]
                ibs[row, :w] = inp["item_bounds"]
                o = inp["offsets"]
                offs[row, : len(o)] = o
                offs[row, len(o):] = o[-1]
                tids[row, : len(inp["tile_ids"])] = inp["tile_ids"]
            return cams, offs, brs, ows, ibs, tids

        def dispatch(packed, ctx):
            vol, meta, dims, _w_pad = ctx
            cams, offs, brs, ows, ibs, tids = packed
            return _render_batch_frames(
                vol, self._lut_device, meta, dims,
                jnp.asarray(cams), jnp.asarray(offs),
                jnp.asarray(brs), jnp.asarray(ows), jnp.asarray(ibs),
                jnp.asarray(tids),
                width=self.pad_w, height=self.pad_h,
                max_slices=self.cube,
                logical_width=self.render_width,
                logical_height=self.render_height,
                sampling=self.parameters.sampling,
                ghost=self.ghost, sqrt_aa=self.sqrt_aa,
                bytes_out=bytes_out,
                classification=self.parameters.classification,
            )

        def readback(part, frames, results, stats):
            host = np.asarray(frames)
            stats["readback_mb"] += host.nbytes / 1e6
            for (idx, _inp, _vol), px in zip(part, host):
                results[idx] = px

        return self._run_chunked_batch(
            cameras, num_out=num_out, chans=chans, bytes_out=bytes_out,
            overlay=overlay, output_pattern=output_pattern,
            prep=prep, begin_group=begin_group, chunk_cap=chunk_cap,
            pack=pack, dispatch=dispatch, readback=readback,
        )

    def _run_chunked_batch(
        self, cameras, *, num_out, chans, bytes_out, overlay,
        output_pattern, prep, begin_group, chunk_cap, pack, dispatch,
        readback, window: int = 16,
    ) -> np.ndarray:
        """Shared chunked-batch driver for ``render_batch`` (single-chip
        and mesh): group consecutive frames with equal group keys, dispatch
        power-of-two sub-chunks through a one-deep dispatch/readback
        pipeline, and return the stacked frames in input order.  Owns the
        ``last_batch_stats`` bookkeeping and the overlay/save output tail,
        so the two renderers cannot drift.

        Callbacks: ``prep(i, camera) -> (group_key, item)``, or
        ``(None, pixels)`` for a frame resolved entirely on host (fully
        culled); ``begin_group(group_key, group) -> ctx`` (per-group device
        tables); ``chunk_cap(group, ctx) -> int`` max frames per dispatch;
        ``pack(part, ctx) -> packed`` host-side chunk packing (stacking/
        padding NumPy work, charged to ``host_prep_ms``, NOT to
        ``dispatch_ms``); ``dispatch(packed, ctx) -> device frames`` the
        device call only; ``readback(part, frames, results, stats)`` fills
        ``results`` and ``readback_mb``.  Chunk sizes are true powers of
        two (the cap is floored to one), so a long batch compiles a
        handful of shapes.
        """
        stats = {
            "frames": len(cameras), "dispatch_count": 0,
            "host_prep_ms": 0.0, "dispatch_ms": 0.0,
            "readback_ms": 0.0, "readback_mb": 0.0,
        }
        batch_t0 = time.perf_counter()
        results: List[Optional[np.ndarray]] = [None] * len(cameras)
        pending = []  # one-deep pipeline: [(part, device frames)]

        def drain():
            # JAX dispatch is async: reading back the PREVIOUS chunk here
            # overlaps with whatever the device is rendering now
            while pending:
                part, frames = pending.pop()
                t0 = time.perf_counter()
                readback(part, frames, results, stats)
                stats["readback_ms"] += (time.perf_counter() - t0) * 1e3

        def flush(group, key):
            if not group:
                return
            ctx = begin_group(key, group)
            cap = max(1, int(chunk_cap(group, ctx)))
            cap = 1 << (cap.bit_length() - 1)  # pow2: few shapes compile
            c0 = 0
            while c0 < len(group):
                # largest power-of-two sub-chunk that fits: no wasted
                # frames, few distinct batch shapes to compile
                n = len(group) - c0
                size = min(cap, 1 << (n.bit_length() - 1))
                part = group[c0 : c0 + size]
                c0 += size
                t0 = time.perf_counter()
                packed = pack(part, ctx)
                stats["host_prep_ms"] += (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                frames = dispatch(packed, ctx)
                stats["dispatch_ms"] += (time.perf_counter() - t0) * 1e3
                stats["dispatch_count"] += 1
                # pipeline: read back the PREVIOUS chunk while the device
                # renders this one, then queue this one
                drain()
                pending.append((part, frames))

        group: List = []
        group_key = None
        for i, camera in enumerate(cameras):
            t0 = time.perf_counter()
            key, item = prep(i, camera)
            stats["host_prep_ms"] += (time.perf_counter() - t0) * 1e3
            if key is None:  # resolved on host (e.g. fully culled)
                results[i] = item
                continue
            if group and key != group_key:
                flush(group, group_key)
                group = []
            group_key = key
            group.append(item)
            # flush full windows eagerly: dispatch is async, so the host
            # preps the NEXT window's work lists while the device renders
            # this one (prep and render can be the same order of
            # magnitude; serializing them would nearly
            # double the batch wall clock there)
            if len(group) >= window:
                flush(group, group_key)
                group = []
        flush(group, group_key)
        drain()

        stats["total_ms"] = (time.perf_counter() - batch_t0) * 1e3
        # ordering-key memo effectiveness over the whole renderer life
        # (visibility.OrderKeyCache; a hit skips the per-frame graph build)
        stats["order_cache_hits"] = self._order_cache.hits
        stats["order_cache_misses"] = self._order_cache.misses
        self.last_batch_stats = stats
        out = self._stack_batch(results, num_out, chans, bytes_out)
        return self._batch_outputs(
            out, cameras, overlay, output_pattern, bytes_out
        )

    @staticmethod
    def _stack_batch(results, num_out, chans, bytes_out) -> np.ndarray:
        """Stack per-frame results; an empty camera list yields a
        well-formed [0, pixels, C] array instead of np.stack raising."""
        if results:
            return np.stack(results)
        dtype = np.uint8 if bytes_out else np.float32
        return np.zeros((0, num_out, chans), dtype)

    def _batch_outputs(
        self, out, cameras, overlay, output_pattern, bytes_out
    ) -> np.ndarray:
        """Shared render_batch tail: wireframe overlays + per-frame saves
        (also used by the mesh renderer's batched path)."""
        if overlay or output_pattern:
            from .image import ImageBuffer, ImageKind

            kind = (
                ImageKind.RGBA_U8 if bytes_out
                else ImageKind.RGBA_F32_DEPTH_SORT
            )
            for i, camera in enumerate(cameras):
                px = out[i]
                if bytes_out == "rgb":
                    # the save path's u8 kind carries alpha; re-attach an
                    # opaque byte host-side (the readback stays 3-channel)
                    px = np.concatenate(
                        [px, np.full((px.shape[0], 1), 255, np.uint8)],
                        axis=1,
                    )
                image = ImageBuffer(
                    kind,
                    self.parameters.width, self.parameters.height,
                    px,
                )
                if overlay:
                    render_bounding_box_overlay(
                        self.tight_bounds, camera, 1, image
                    )
                if output_pattern:
                    from . import io as image_io

                    image_io.save_image(image, output_pattern.format(i))
        return out
