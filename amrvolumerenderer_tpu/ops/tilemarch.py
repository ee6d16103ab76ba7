"""Tile-loop renderer: march + composite per tile, any brick count.

The work-list renderer (ops/slicemarch.py) materializes a full-frame layer
per brick — O(bricks x pixels) memory, which cannot scale to deep-AMR
scenes with thousands of bricks.  The tile loop inverts the structure:

  * the host builds a CSR work list per pixel tile: the bricks whose screen
    bounding box covers the tile, sorted front-to-back by depth hint
    (ties: owner, local index — the composeLayered order,
    DirectSendBase.cpp:378-388);
  * every (tile, brick) item is marched as one ``TILE_P``-ray item and
    each tile's items are folded in CSR order with the same run-grouped
    depth-sort blend as the standalone compositor; only the composited
    tiles are returned.

Two implementations of that loop:

  * on the GPU, ``tilemarch_kernel``: one Pallas program (Triton route)
    per (frame, tile) marches the tile's items and folds them into
    accumulators that stay in registers, stopping an item's march once
    every ray of the tile is opaque within that item;
  * elsewhere, and as the kernel's reference, the plain tile loop:
    ``slicemarch.march_items`` over the whole item list (memory
    O(items x TILE_P)), then ``fold_items``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .slicemarch import (
    LANES,
    SLICE_CELLS,
    SUBLANES,
    TILE_H,
    TILE_P,
    TILE_W,
    compute_worklist,
    finish_item,
    item_params,
    march_items,
    match_vma,
    over_step,
    sample_slice,
    tile_rays,
)

# packed (s_lo << 16) | s_hi bounds of an empty range: a zero-trip march
EMPTY_BOUNDS = (1 << 16) | 1


def _blend(top_c, top_d, bot_c, bot_d):
    """Depth-sorted over blend of channel-plane layers ([.., 4, P] colors,
    [.., P] depths; ImageRGBAFloatColorDepthSort.hpp:13-27)."""
    top_front = (top_d <= bot_d)[..., None, :]
    front = jnp.where(top_front, top_c, bot_c)
    back = jnp.where(top_front, bot_c, top_c)
    out_c = front + back * (1.0 - front[..., 3:4, :])
    return out_c, jnp.minimum(top_d, bot_d)


def fold_items(
    colors: jnp.ndarray,  # [W, 4, P] item layers in CSR order
    depths: jnp.ndarray,  # [W, P]
    offsets: jnp.ndarray,  # [G + 1] i32 CSR offsets per output tile
    owners: jnp.ndarray,  # [W] i32 run key per item
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fold each tile's items front-to-back with the run-grouped blend.

    Consecutive same-owner items form a run that is pre-blended; finished
    runs fold into the tile total in order — composeLayered's structure
    (DirectSendBase.cpp:378-446), which matters because the depth-sort
    blend is not associative in depth ties.  Returns ([G, 4, P], [G, P]);
    a tile with no items is cleared (transparent, +inf depth)."""
    begin = offsets[:-1]
    end = offsets[1:]
    steps = begin.shape[0]
    num_items = colors.shape[0]
    owners = owners.astype(jnp.int32)
    empty_c = jnp.zeros((steps,) + colors.shape[1:], colors.dtype)
    empty_d = jnp.full((steps,) + depths.shape[1:], jnp.inf, depths.dtype)

    def body(i, carry):
        run_c, run_d, tot_c, tot_d, have_tot = carry
        idx = begin + i
        live = idx < end
        safe = jnp.clip(idx, 0, max(num_items - 1, 0))
        c = colors[safe]
        d = depths[safe]
        same_owner = (i > 0) & (owners[safe] == owners[jnp.maximum(safe - 1, 0)])

        closed_c, closed_d = _blend(tot_c, tot_d, run_c, run_d)
        have = have_tot[:, None]
        closed_c = jnp.where(have[..., None], closed_c, run_c)
        closed_d = jnp.where(have, closed_d, run_d)
        ext_c, ext_d = _blend(run_c, run_d, c, d)

        keep = (same_owner | ~live)[:, None]
        new_tot_c = jnp.where(keep[..., None], tot_c, closed_c)
        new_tot_d = jnp.where(keep, tot_d, closed_d)
        new_have = jnp.where(same_owner | ~live, have_tot, have_tot | (i > 0))
        ext = same_owner[:, None]
        new_run_c = jnp.where(ext[..., None], ext_c, c)
        new_run_d = jnp.where(ext, ext_d, d)
        live_c = live[:, None, None]
        return (
            jnp.where(live_c, new_run_c, run_c),
            jnp.where(live[:, None], new_run_d, run_d),
            new_tot_c, new_tot_d, new_have,
        )

    init = (empty_c, empty_d, empty_c, empty_d, jnp.zeros(steps, bool))
    if num_items == 0:
        return empty_c, empty_d
    init = match_vma(init, body(0, init)[0])
    depth_max = jnp.max(end - begin, initial=0)
    run_c, run_d, tot_c, tot_d, have_tot = jax.lax.fori_loop(
        0, depth_max, body, init
    )
    fin_c, fin_d = _blend(tot_c, tot_d, run_c, run_d)
    have = have_tot[:, None]
    return (
        jnp.where(have[..., None], fin_c, run_c),
        jnp.where(have, fin_d, run_d),
    )


def use_kernel(tile_bricks) -> bool:
    """Whether the tile loop runs as the fused Triton kernel: on the GPU,
    for a non-empty item list.  Elsewhere the plain tile loop (its
    reference) runs."""
    return jax.default_backend() == "gpu" and tile_bricks.shape[-1] > 0


def _tilemarch_frame(
    vol, meta, dims, lut, cam, tile_offsets, tile_bricks, tile_owners,
    item_bounds, tile_ids, *, width, height, max_slices, logical_width=None,
    logical_height=None, sampling="nearest", ghost=0, classification="post",
):
    """One frame of the plain tile loop: march every CSR item, then fold."""
    num_items = tile_bricks.shape[0]
    steps = tile_offsets.shape[0] - 1
    if item_bounds is None:
        item_bounds = dims[tile_bricks, 7]
    if tile_ids is None:
        tile_ids = jnp.arange(steps, dtype=jnp.int32)
    item = jnp.arange(num_items, dtype=jnp.int32)
    # step of each item; items past the last offset are padding and march
    # an empty range
    step = jnp.searchsorted(tile_offsets, item, side="right") - 1
    in_list = item < tile_offsets[-1]
    item_tiles = tile_ids[jnp.clip(step, 0, max(steps - 1, 0))]
    bounds = jnp.where(in_list, item_bounds, EMPTY_BOUNDS)
    colors, depths = march_items(
        vol, meta, dims, lut, cam, tile_bricks, item_tiles, bounds,
        width=width, logical_width=logical_width or width,
        logical_height=logical_height or height, max_slices=max_slices,
        sampling=sampling, ghost=ghost, classification=classification,
    )
    out_c, out_d = fold_items(colors, depths, tile_offsets, tile_owners)
    return (
        out_c.reshape(steps, 4, SUBLANES, LANES),
        out_d.reshape(steps, SUBLANES, LANES),
    )


_STATIC = (
    "width", "height", "logical_width", "logical_height", "max_slices",
    "sampling", "ghost", "classification",
)


@functools.partial(jax.jit, static_argnames=_STATIC)
def tilemarch_render(
    vol: jnp.ndarray,  # [B, S_max, 8, 128] packed slice bricks
    meta: jnp.ndarray,  # [B, 12]
    dims: jnp.ndarray,  # [B, 8]
    lut: jnp.ndarray,  # [4, size // 128, LANES] shared transfer function
    cam: jnp.ndarray,  # [20]
    tile_offsets: jnp.ndarray,  # [G + 1] i32 CSR offsets
    tile_bricks: jnp.ndarray,  # [W] i32 brick per work item (depth sorted)
    tile_owners: jnp.ndarray,  # [W] i32 owner per work item
    item_bounds: Optional[jnp.ndarray] = None,  # [W] i32 per-item slice
    #   bounds ((lo<<16)|hi); None -> each item inherits its brick's
    #   dims[:, 7] (identical behavior to the per-brick bounds)
    tile_ids: Optional[jnp.ndarray] = None,  # [G] i32 frame tile per step
    #   — the COMPACTED list: only covered tiles get steps.  None = dense
    #   over all T tiles (outputs then index by frame tile id).
    *,
    width: int,
    height: int,
    max_slices: int,
    logical_width: Optional[int] = None,
    logical_height: Optional[int] = None,
    sampling: str = "nearest",
    ghost: int = 0,
    classification: str = "post",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Render + composite the whole frame in tile space.

    Returns ([G, 4, SUBLANES, LANES], [G, SUBLANES, LANES]) tile-space
    buffers, where G = len(tile_ids) if compacted else the full tile
    count (use ``slicemarch.untile``-style reshape for row-major, or
    ``scatter_tiles`` for a compacted list).
    """
    assert width % TILE_W == 0 and height % TILE_H == 0
    steps = tile_offsets.shape[0] - 1
    if tile_ids is None:
        assert steps == width * height // TILE_P
    else:
        assert steps == tile_ids.shape[0]
    kw = dict(width=width, height=height, max_slices=max_slices,
              logical_width=logical_width, logical_height=logical_height,
              sampling=sampling, ghost=ghost, classification=classification)
    if use_kernel(tile_bricks):
        if item_bounds is None:
            item_bounds = dims[tile_bricks, 7]
        if tile_ids is None:
            tile_ids = jnp.arange(steps, dtype=jnp.int32)
        out_c, out_d = tilemarch_kernel(
            vol, meta, dims, lut, cam[None], tile_offsets[None],
            tile_bricks[None], tile_owners[None], item_bounds[None],
            tile_ids[None], **kw,
        )
        return (out_c[0].reshape(steps, 4, SUBLANES, LANES),
                out_d[0].reshape(steps, SUBLANES, LANES))
    return _tilemarch_frame(
        vol, meta, dims, lut, cam, tile_offsets, tile_bricks, tile_owners,
        item_bounds, tile_ids, **kw,
    )


def tilemarch_render_batch(
    vol: jnp.ndarray,  # [B, S_max, 8, 128] packed slice bricks
    meta: jnp.ndarray,  # [B, 12]
    dims: jnp.ndarray,  # [B, 8]
    lut: jnp.ndarray,  # [4, size // 128, LANES]
    cams: jnp.ndarray,  # [F, 20] per-frame camera packs
    tile_offsets: jnp.ndarray,  # [F, S + 1]
    tile_bricks: jnp.ndarray,  # [F, W]
    tile_owners: jnp.ndarray,  # [F, W]
    item_bounds: jnp.ndarray,  # [F, W]
    tile_ids: jnp.ndarray,  # [F, S]
    **kw,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """F frames in one traced program: one launch of the fused kernel over
    every (frame, tile) on the GPU, the plain tile loop one frame at a time
    elsewhere (memory stays one frame's item list).  Returns
    ([F, S, 4, SUBLANES, LANES], [F, S, SUBLANES, LANES])."""
    if use_kernel(tile_bricks):
        out_c, out_d = tilemarch_kernel(
            vol, meta, dims, lut, cams, tile_offsets, tile_bricks,
            tile_owners, item_bounds, tile_ids, **kw,
        )
        frames, steps = tile_ids.shape
        return (out_c.reshape(frames, steps, 4, SUBLANES, LANES),
                out_d.reshape(frames, steps, SUBLANES, LANES))

    def frame(args):
        return _tilemarch_frame(vol, meta, dims, lut, *args, **kw)

    return jax.lax.map(
        frame,
        (cams, tile_offsets, tile_bricks, tile_owners, item_bounds, tile_ids),
    )


# ---------------------------------------------------------------------------
# The fused tile kernel (Pallas, Triton route)
# ---------------------------------------------------------------------------


def _tile_kernel(
    cam_ref,  # [F * 20] f32 camera packs
    meta_ref,  # [B * 12] f32
    dims_ref,  # [B * 8] i32
    tid_ref,  # [F * S] i32 frame tile per program
    off_ref,  # [F * (S + 1)] i32 CSR offsets (per frame, frame-relative)
    brk_ref,  # [F * W] i32 brick per item
    own_ref,  # [F * W] i32 run key per item
    ib_ref,  # [F * W] i32 packed slice bounds per item
    vol_ref,  # [B * S_max, 1024] f32/bf16 packed slices, one row each
    lut_ref,  # [4 * size] f32 (r, g, b, log(1 - alpha))
    out_c_ref,  # [4, TILE_P] this program's composited tile
    out_d_ref,  # [TILE_P]
    *, steps, items, s_stored, lut_size, width, logical_width,
    logical_height, max_slices, sampling, ghost, classification,
):
    """One program = one (frame, tile): march every CSR item of the tile
    and fold it into run/total accumulators that never leave registers.
    Item tables are read by the program itself (no prefetch), voxels and
    LUT entries by integer-array loads (pointer gathers).

    An item's march stops once every ray of the tile is opaque within the
    item, as the reference stops each ray's march through a box.  The tile
    does not stop at an opaque total: the depth-sort blend puts a later
    item in front of the total wherever its entry depth is nearer (depth
    hints order bricks, not rays), so skipping it would change pixels."""
    f32 = jnp.float32
    g = pl.program_id(0)
    f = g // steps
    s = g - f * steps
    cam = [cam_ref[f * 20 + i] for i in range(17)]
    tile = tid_ref[g]
    begin = off_ref[f * (steps + 1) + s] + f * items
    end = off_ref[f * (steps + 1) + s + 1] + f * items
    p = jnp.arange(TILE_P, dtype=jnp.int32)
    zero = jnp.zeros((TILE_P,), f32)
    far = jnp.full((TILE_P,), np.inf, f32)

    def march(w):
        b = brk_ref[w]
        item = item_params(
            lambda i: meta_ref[b * 12 + i], lambda i: dims_ref[b * 8 + i],
            ib_ref[w], max_slices,
        )
        rays = tile_rays(cam, item, tile, p, width=width,
                         logical_width=logical_width,
                         logical_height=logical_height)
        base = b * s_stored

        def fetch(kk, flat):
            # (slice row, cell) indexing: the lowering widens the row
            # offset to 64 bits for tables past 4 GiB, where a flat int32
            # cell offset would wrap
            return vol_ref[base + kk + ghost, flat].astype(f32)

        def lookup(ch, idx):
            return lut_ref[ch * lut_size + idx]

        trips = jnp.maximum(item["hi"] - item["s_lo"], 0)

        def cond(carry):
            j, acc = carry
            return (j < trips) & (jnp.min(acc[3]) < 1.0)

        def body(carry):
            j, acc = carry
            return j + 1, over_step(acc, sample_slice(
                item["s_lo"] + j, cam, item, rays, fetch, lookup,
                table_max=lut_size - 1, max_slices=max_slices,
                sampling=sampling, ghost=ghost,
                classification=classification,
            ))

        _, acc = jax.lax.while_loop(
            cond, body, (jnp.int32(0), (zero, zero, zero, zero))
        )
        return finish_item(acc, rays, cam)

    def blend(top_c, top_d, bot_c, bot_d):
        front = top_d <= bot_d
        one_minus = 1.0 - jnp.where(front, top_c[3], bot_c[3])
        out = tuple(
            jnp.where(front, top_c[ch], bot_c[ch])
            + jnp.where(front, bot_c[ch], top_c[ch]) * one_minus
            for ch in range(4)
        )
        return out, jnp.minimum(top_d, bot_d)

    def pick(pred, a, b):
        return tuple(jnp.where(pred, x, y) for x, y in zip(a, b))

    def outer(w, carry):
        run_c, run_d, tot_c, tot_d, have_tot = carry
        c, d = march(w)
        same = (w > begin) & (own_ref[w] == own_ref[jnp.maximum(w - 1, 0)])
        closed_c, closed_d = blend(tot_c, tot_d, run_c, run_d)
        closed_c = pick(have_tot, closed_c, run_c)
        closed_d = jnp.where(have_tot, closed_d, run_d)
        tot_c = pick(same, tot_c, closed_c)
        tot_d = jnp.where(same, tot_d, closed_d)
        have_tot = jnp.where(same, have_tot, have_tot | (w > begin))
        ext_c, ext_d = blend(run_c, run_d, c, d)
        return (pick(same, ext_c, c), jnp.where(same, ext_d, d),
                tot_c, tot_d, have_tot)

    empty = (zero, zero, zero, zero)
    run_c, run_d, tot_c, tot_d, have_tot = jax.lax.fori_loop(
        begin, end, outer, (empty, far, empty, far, begin < begin)
    )
    fin_c, fin_d = blend(tot_c, tot_d, run_c, run_d)
    fin_c = pick(have_tot, fin_c, run_c)
    for ch in range(4):
        out_c_ref[ch, :] = fin_c[ch]
    out_d_ref[:] = jnp.where(have_tot, fin_d, run_d)


def tilemarch_kernel(
    vol, meta, dims, lut, cams, tile_offsets, tile_bricks, tile_owners,
    item_bounds, tile_ids, *, width, height, max_slices, logical_width=None,
    logical_height=None, sampling="nearest", ghost=0, classification="post",
    interpret=False,
):
    """The fused tile kernel over F frames of per-frame CSR tables
    (``cams`` [F, 20], ``tile_offsets`` [F, S + 1], item tables [F, W],
    ``tile_ids`` [F, S]).  Returns ([F, S, 4, TILE_P], [F, S, TILE_P]).

    Pallas on the Triton route: one program per (frame, tile) with a
    block of ``TILE_P`` rays run by 8 warps (4 and 8 measured within 5% of
    each other on an H100, PERF.md).  Every load is a data-dependent
    gather, so there is no block pipeline for ``num_stages`` to deepen.
    ``interpret=True`` runs it on the CPU, for tests."""
    frames, steps = tile_ids.shape
    items = tile_bricks.shape[1]
    size = lut.shape[-2] * lut.shape[-1]
    kernel = functools.partial(
        _tile_kernel, steps=steps, items=items, s_stored=vol.shape[1],
        lut_size=size, width=width, logical_width=logical_width or width,
        logical_height=logical_height or height, max_slices=max_slices,
        sampling=sampling, ghost=ghost, classification=classification,
    )
    flat = lambda a, dtype: jnp.asarray(a, dtype).reshape(-1)
    out_c, out_d = pl.pallas_call(
        kernel,
        grid=(frames * steps,),
        out_specs=[
            pl.BlockSpec((None, 4, TILE_P), lambda g: (g, 0, 0)),
            pl.BlockSpec((None, TILE_P), lambda g: (g, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((frames * steps, 4, TILE_P), jnp.float32),
            jax.ShapeDtypeStruct((frames * steps, TILE_P), jnp.float32),
        ],
        compiler_params=plt.CompilerParams(num_warps=8, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="tilemarch_fused",
    )(
        flat(cams, jnp.float32), flat(meta, jnp.float32),
        flat(dims, jnp.int32), flat(tile_ids, jnp.int32),
        flat(tile_offsets, jnp.int32), flat(tile_bricks, jnp.int32),
        flat(tile_owners, jnp.int32), flat(item_bounds, jnp.int32),
        vol.reshape(-1, SLICE_CELLS), flat(lut, jnp.float32),
    )
    return (out_c.reshape(frames, steps, 4, TILE_P),
            out_d.reshape(frames, steps, TILE_P))


def scatter_tiles(
    out_c: jnp.ndarray,  # [G, 4, SUBLANES, LANES] compacted output
    out_d: jnp.ndarray,  # [G, SUBLANES, LANES]
    tile_ids: jnp.ndarray,  # [G] frame tile per step (tail may pad)
    num_tiles: int,
    valid_steps: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compacted output -> full tile-space frame (uncovered tiles =
    background: transparent color, +inf depth).

    Padding contract (what the callers actually rely on): pad steps carry
    the OUT-OF-RANGE sentinel ``tile_ids == num_tiles`` with an empty work
    list, so JAX's scatter drops them — padding with a real tile id (e.g.
    0) would overwrite that tile's rendered output with background.
    ``valid_steps`` additionally slices off a known pad tail before the
    scatter (optional; the sentinel alone is sufficient)."""
    if valid_steps is not None and valid_steps < out_c.shape[0]:
        out_c = out_c[:valid_steps]
        out_d = out_d[:valid_steps]
        tile_ids = tile_ids[:valid_steps]
    full_c = jnp.zeros((num_tiles,) + out_c.shape[1:], out_c.dtype)
    full_d = jnp.full((num_tiles,) + out_d.shape[1:], jnp.inf, out_d.dtype)
    return full_c.at[tile_ids].set(out_c), full_d.at[tile_ids].set(out_d)


def block_occupancy_bits(
    quad_min: np.ndarray,  # [L, S, Q, Q] per-slice block minima
    quad_max: np.ndarray,  # [L, S, Q, Q] per-slice block maxima
    lut_alpha: np.ndarray,  # [size]
    range_min: float,
    inverse_range: float,
) -> np.ndarray:
    """[L, S] uint64 bitmask: bit (qu * Q + qv) set when block (qu, qv) of
    the slice can map to nonzero alpha under the current transfer function.
    Depends only on (piece table, LUT) — cache per (axis, LUT), NOT per
    frame (compute_item_slice_bounds consumes it every frame)."""
    if quad_min.shape[2] > 8 or quad_min.shape[3] > 8:
        # the packed masks are uint64: nq > 8 would silently drop high
        # bits and non-conservatively skip occupied slices
        raise ValueError("block occupancy masks support at most 8x8 blocks")
    from .. import native as _native

    native_out = _native.block_occupancy_bits(
        quad_min, quad_max, lut_alpha, range_min, inverse_range
    )
    if native_out is not None:
        return native_out
    nz = np.asarray(lut_alpha) > 0.0
    table_max = len(nz) - 1  # table size follows the LUT argument
    prefix = np.concatenate([[0], np.cumsum(nz)])
    n0 = np.clip((quad_min - range_min) * inverse_range, 0.0, 1.0)
    n1 = np.clip((quad_max - range_min) * inverse_range, 0.0, 1.0)
    i0 = np.clip((n0 * table_max).astype(np.int64), 0, table_max)
    i1 = np.clip((n1 * table_max).astype(np.int64), 0, table_max)
    occ = (prefix[i1 + 1] - prefix[i0]) > 0  # [L, S, Q, Q]
    num, cap, nq, _ = occ.shape
    bit = (np.arange(nq)[:, None] * nq + np.arange(nq)[None, :]).astype(
        np.uint64
    )
    return (
        occ.astype(np.uint64) << bit[None, None]
    ).reshape(num, cap, nq * nq).sum(axis=2, dtype=np.uint64)


def compute_item_slice_bounds(
    meta: np.ndarray,  # [L, 12] f32 permuted pmin/pmax/cell (march axis 1st)
    brick_bounds: np.ndarray,  # [L] i32 per-brick packed (lo<<16)|hi
    wt: np.ndarray,  # [W] tile index per work item
    wb: np.ndarray,  # [W] brick index per work item
    eye: np.ndarray,
    forward: np.ndarray,
    right: np.ndarray,
    up: np.ndarray,
    fov_y_degrees: float,
    axes: Sequence[int],  # march-axis permutation (dims[:, 3:6])
    width: int,
    height: int,
    logical_width: int,
    logical_height: int,
    occ_bits: np.ndarray,  # [L, S] uint64 from block_occupancy_bits
    nq: int,  # blocks per axis (Q)
    split,  # stored-coordinate block edge stride (stored_u_extent / Q);
    #         scalar (uniform pieces, the canonical-cube path) or [L]
    split_v=None,  # v-axis stride when it differs from ``split`` ([L] or
    #                scalar; defaults to ``split``)
    ghost: int = 0,
    return_mask: bool = False,
    seg_len: int = 4,
    margin: Optional[float] = None,
) -> np.ndarray:
    """Per-(tile, brick) occupied-slice bounds: tighten each work item's
    march range to the slices whose values can be non-transparent WITHIN
    the tile's footprint on the brick.

    The per-brick range (slicemarch.compute_slice_bounds) is global over
    the whole slice, so a thin curved feature (a shell, a front) occupies
    some (u, v) of nearly every slice and defeats range skipping; per-tile
    footprints restore the sparsity.  Conservative by construction:

      * a ray's in-plane position at slice z is ``eye_u + (z-eye_a) *
        d_u/d_a`` — LINEAR in z, and a Mobius function of the pixel
        coordinates (monotone in each while ``d_a`` keeps one sign across
        the tile), so the 4 corner rays evaluated at slice-SEGMENT
        boundary planes bound each segment's footprint exactly; sign
        changes / behind-eye planes fall back to the brick bounds;
      * slices are grouped into segments of ``seg_len`` so oblique rays'
        transverse drift (up to one cell per slice at 45 degrees) widens
        only the segment's footprint, not the whole brick's (hull over
        the two endpoint planes bounds every interior slice exactly —
        u(z) is linear along each ray — so finer segments only tighten);
      * the footprint hull is padded by ``margin`` cells.  The default
        ``ghost + 2`` is safe for every sampling mode; the exact
        requirement is the sampling stencil's reach from the continuous
        cell coordinate ``cu``: nearest touches floor(cu) in (cu-1, cu],
        trilinear/pre touch floor(cu-0.5)+{0,1} in (cu-1.5, cu+0.5] —
        ``footprint_margin`` returns the tight value per mode;
      * occupancy is tested per stored-(u, v) BLOCK of each slice
        (Q x Q equal blocks of edge ``split``; extrema include slice
        padding zeros, widening ranges only).

    Returns [W] i32 packed ``(s_lo << 16) | s_hi``; items whose footprint
    maths cannot be trusted keep their brick's bounds.  (Beyond reference:
    the reference marches every step of every box, VolumePainter.cpp:
    837-900.)"""
    if nq > 8:
        raise ValueError("block occupancy masks support at most 8x8 blocks")
    if seg_len < 1:
        raise ValueError("seg_len must be >= 1")
    wb = np.asarray(wb, np.int64)
    wt = np.asarray(wt, np.int64)
    bb = np.asarray(brick_bounds, np.int64)[wb]
    blo = bb >> 16
    bhi = bb & 0xFFFF

    tiles_x = width // TILE_W
    tx = wt % tiles_x
    ty = wt // tiles_x
    # extreme pixel centers of the tile (rays sample px + 0.5)
    px = np.stack([tx * TILE_W + 0.5, tx * TILE_W + TILE_W - 0.5], -1)
    py = np.stack([ty * TILE_H + 0.5, ty * TILE_H + TILE_H - 0.5], -1)
    tan_half = math.tan(math.radians(fov_y_degrees) * 0.5)
    aspect = logical_width / max(logical_height, 1)
    plane_x = (px * (2.0 / logical_width) - 1.0) * tan_half * aspect
    plane_y = (py * (2.0 / logical_height) - 1.0) * tan_half
    # 4 corner rays, world dirs (unnormalized — ratios cancel below)
    cx = plane_x[:, [0, 0, 1, 1]]
    cy = plane_y[:, [0, 1, 0, 1]]
    dirs = (
        np.asarray(forward, np.float64)[None, None, :]
        + cx[:, :, None] * np.asarray(right, np.float64)
        + cy[:, :, None] * np.asarray(up, np.float64)
    )  # [W, 4, 3]
    axes = list(axes)
    dp = dirs[:, :, axes]
    eye_p = np.asarray(eye, np.float64)[axes]
    pmin = np.asarray(meta, np.float64)[wb][:, 0:3]
    cell = np.asarray(meta, np.float64)[wb][:, 6:9]

    d_a = dp[:, :, 0]
    sign_ok = (np.abs(d_a) > 1e-8).all(1) & (
        (d_a > 0).all(1) | (d_a < 0).all(1)
    )
    cap = occ_bits.shape[1]
    n_seg = (cap + seg_len - 1) // seg_len
    # segment boundary slice centers: 0, L, 2L, ..., then cap-1
    ks = np.minimum(np.arange(n_seg + 1) * seg_len, cap - 1)  # [G+1]
    z = pmin[:, 0:1] + (ks[None, :] + 0.5) * cell[:, 0:1]  # [W, G+1]
    with np.errstate(divide="ignore", invalid="ignore"):
        # reciprocal form, matching the native C++ pass bit-for-bit
        # (avr_native.cpp item_bands_range hoists these loop-invariant
        # divisions out of its per-segment loop)
        inv_da = 1.0 / d_a  # [W, 4]
        t = (z[:, None, :] - eye_p[0]) * inv_da[:, :, None]  # [W, 4, G+1]
        ok = sign_ok & (t > 0).all(axis=(1, 2))
        u_pts = eye_p[1] + t * dp[:, :, 1:2]  # [W, 4, G+1]
        v_pts = eye_p[2] + t * dp[:, :, 2:3]
        cu = (u_pts - pmin[:, 1:2, None]) * (1.0 / cell[:, 1:2, None]) + ghost
        cv = (v_pts - pmin[:, 2:3, None]) * (1.0 / cell[:, 2:3, None]) + ghost
    if margin is None:
        margin = ghost + 2.0
    # segment g's footprint = hull of the 4 corners at boundaries g, g+1
    # (reduce over corners first, then over the two endpoints)
    cu_min = cu.min(axis=1)  # [W, G+1]
    cu_max = cu.max(axis=1)
    cv_min = cv.min(axis=1)
    cv_max = cv.max(axis=1)
    cu_lo = np.minimum(cu_min[:, :-1], cu_min[:, 1:]) - margin  # [W, G]
    cu_hi = np.maximum(cu_max[:, :-1], cu_max[:, 1:]) + margin
    cv_lo = np.minimum(cv_min[:, :-1], cv_min[:, 1:]) - margin
    cv_hi = np.maximum(cv_max[:, :-1], cv_max[:, 1:]) + margin
    # block q covers stored [q*split, (q+1)*split); splits may vary per
    # piece (work-list path) — broadcast [W, 1, Q] against [W, G, 1]
    if split_v is None:
        split_v = split
    su = (np.asarray(split)[wb] if np.ndim(split) else
          np.float64(split))
    sv = (np.asarray(split_v)[wb] if np.ndim(split_v) else
          np.float64(split_v))
    qrange = np.arange(nq)
    eu_lo = (np.multiply.outer(su, qrange))[:, None, :] \
        if np.ndim(su) else (su * qrange)[None, None, :]
    ev_lo = (np.multiply.outer(sv, qrange))[:, None, :] \
        if np.ndim(sv) else (sv * qrange)[None, None, :]
    eu_hi = eu_lo + (su[:, None, None] if np.ndim(su) else su)
    ev_hi = ev_lo + (sv[:, None, None] if np.ndim(sv) else sv)
    qu = (cu_lo[..., None] < eu_hi) & (cu_hi[..., None] > eu_lo)
    qv = (cv_lo[..., None] < ev_hi) & (cv_hi[..., None] > ev_lo)
    # footprint bitmask per segment: bit (a*Q+b) = u-block a AND v-block b
    shift_u = (np.arange(nq, dtype=np.uint64) * np.uint64(nq))
    fu = (qu.astype(np.uint64) << shift_u).sum(axis=2, dtype=np.uint64)
    fv = (qv.astype(np.uint64) << np.arange(nq, dtype=np.uint64)).sum(
        axis=2, dtype=np.uint64
    )
    # (Σ_a qu_a 2^(aQ)) * (Σ_b qv_b 2^b) = Σ_{a,b} qu_a qv_b 2^(aQ+b):
    # the products never carry because each partial bit is distinct
    fmask = fu * fv  # [W, G] uint64
    # expand to per-slice and AND against the cached block occupancy
    seg_of_slice = np.minimum(np.arange(cap) // seg_len, n_seg - 1)
    sel = (fmask[:, seg_of_slice] & occ_bits[wb]) != 0  # [W, S]
    cap = sel.shape[1]
    s_idx = np.arange(cap)[None, :]
    sel &= (s_idx >= blo[:, None]) & (s_idx < bhi[:, None])
    any_occ = sel.any(1)
    lo = np.argmax(sel, 1)
    hi = cap - np.argmax(sel[:, ::-1], 1)
    packed = np.where(any_occ, (lo << 16) | hi, (bhi << 16) | bhi)
    out = np.where(ok & (bhi > blo), packed, bb)
    if return_mask:
        # diagnostics/band splitting: the per-slice occupancy before range
        # collapse, the trust flag, and the tile's march direction
        # (d_a > 0 for all corners; only meaningful where ok)
        forward = (d_a > 0).all(1)
        return out.astype(np.int32), sel, ok, forward
    return out.astype(np.int32)


def footprint_margin(ghost: int, sampling: str) -> float:
    """Tight conservative footprint pad (cells) for a sampling mode.

    The per-item bounds hull the tile's corner rays in continuous cell
    coordinates ``cu``; the pad must cover every CELL INDEX the march's
    stencil can touch from a position inside the hull:

      * nearest: index = floor(cu) in (cu - 1, cu]  -> pad 1
      * trilinear / pre-classified: stored indices floor(cu - 0.5) + {0, 1}
        in (cu - 1.5, cu + 0.5]  -> pad 1.5

    plus 0.01 cells of slack for the f32-device vs f64-host position
    rounding (the device's positions differ from the host hull by at most
    a few ULPs of the cell coordinate, orders of magnitude below 0.01;
    grazing rays with large amplification have correspondingly huge hulls
    that swallow the slack).  Measured on the bench thin shell this pad
    (vs the legacy ghost + 2) cuts marched slice-iterations ~12%
    (scripts/bounds_variant_sweep.py)."""
    return ghost + (1.01 if sampling == "nearest" else 1.51)


def find_second_bands(
    sel: np.ndarray,  # [W, S] per-slice occupancy (compute_item_slice_bounds)
    item_bounds: np.ndarray,  # [W] packed (lo<<16)|hi (tightened)
    ok: np.ndarray,  # [W] footprint maths trusted (incl. uniform d_a sign)
    min_gap: int = 6,
) -> Tuple[np.ndarray, np.ndarray]:
    """Locate each item's largest internal empty gap (vectorized).

    Returns (band1, band2), both [W] i32 packed ``(lo<<16)|hi``: where a
    gap of >= ``min_gap`` empty slices splits the occupied range, band1 /
    band2 are the two covering sub-ranges in slice order; elsewhere band1
    is the input bounds and band2 is 0 (unsplit)."""
    ib = np.asarray(item_bounds).astype(np.int64)
    lo = ib >> 16
    hi = ib & 0xFFFF
    W, S = np.asarray(sel).shape
    s_idx = np.arange(S, dtype=np.int64)[None, :]
    occ = np.asarray(sel) & (s_idx >= lo[:, None]) & (s_idx < hi[:, None])
    # prev_occ[j] = index of the last occupied slice STRICTLY before j
    prev = np.maximum.accumulate(np.where(occ, s_idx, -1), axis=1)
    prev_sh = np.concatenate(
        [np.full((W, 1), -1, np.int64), prev[:, :-1]], axis=1
    )
    # gap ending at occupied slice j = run of empties since the previous
    # occupied slice; -1 where not an (internal) gap end
    gap = np.where(occ & (prev_sh >= 0), s_idx - prev_sh - 1, -1)
    rows = np.arange(W)
    g_end = gap.argmax(axis=1)  # first maximal gap's closing occupied slice
    g_len = gap[rows, g_end]
    g_prev = prev_sh[rows, g_end]  # occupied slice opening the gap
    split = np.asarray(ok, bool) & (g_len >= min_gap) & (hi > lo)
    band1 = np.where(split, (lo << 16) | (g_prev + 1), ib)
    band2 = np.where(split, (g_end << 16) | hi, 0)
    return band1.astype(np.int32), band2.astype(np.int32)


def expand_bands(
    wt: np.ndarray,  # [W] tile per item (tile-sorted CSR order)
    wb: np.ndarray,  # [W] brick per item
    owners: np.ndarray,  # [W] run key per item
    band1: np.ndarray,  # [W] packed first band (== bounds when unsplit)
    band2: np.ndarray,  # [W] packed second band, 0 = unsplit
    forward: np.ndarray,  # [W] tile march direction (d_a > 0)
):
    """Expand split items into TWO adjacent work items.

    A chord through a hollow feature (a shell, a bubble wall) enters and
    exits the occupied region with an empty middle; the contiguous
    [lo, hi) range marches the gap for nothing.  Split items emit their
    two bands ordered in the tile's MARCH direction so the fold's run
    blend (depth tie -> earlier item stays in front) composites them
    front-to-back for every ray in the tile — valid exactly where the
    footprint maths is trusted (compute_item_bands only emits band2 where
    ``ok``, which requires a uniform d_a sign across the tile's corner
    rays).  Conservative: the two bands cover every occupied slice.

    Returns (wt, wb, owners, item_bounds) with split items expanded in
    place (CSR tile order preserved).  Beyond reference: the reference
    marches every step of every box (VolumePainter.cpp:837-900)."""
    wt = np.asarray(wt)
    band1 = np.asarray(band1, np.int32)
    band2 = np.asarray(band2, np.int32)
    has2 = band2 != 0
    if not has2.any():
        return wt, np.asarray(wb), np.asarray(owners), band1
    fwd = np.asarray(forward, bool)
    first = np.where(has2 & ~fwd, band2, band1)
    second = np.where(fwd, band2, band1)
    reps = np.where(has2, 2, 1).astype(np.int64)
    wt2 = np.repeat(wt, reps)
    wb2 = np.repeat(np.asarray(wb), reps)
    ow2 = np.repeat(np.asarray(owners), reps)
    ib2 = np.repeat(first, reps)
    starts = np.cumsum(reps) - 1  # row of each item's LAST emitted slot
    ib2[starts[has2]] = second[has2]
    return wt2, wb2, ow2, ib2


def compute_item_bands(
    meta, brick_bounds, wt, wb, eye, forward, right, up, fov_y_degrees,
    axes, width, height, logical_width, logical_height,
    occ_bits, nq, split, split_v=None, ghost: int = 0, min_gap: int = 6,
    seg_len: int = 4, margin: Optional[float] = None,
):
    """Per-item occupied-slice bounds + second-band split, native-first.

    Same geometry contract as ``compute_item_slice_bounds`` (the NumPy
    oracle); returns (band1, band2, march_forward) for ``expand_bands``.
    The native path (native.item_bands, avr_native.cpp) fuses the
    footprint maths, occupancy AND, and gap scan into one C++ pass —
    this is per-frame host work on the product path, so it follows the
    reference's native-host-layer design (SceneBuilder.cpp:113-189).

    ``seg_len``/``margin`` tune the footprint granularity/pad (see
    ``compute_item_slice_bounds``; ``footprint_margin`` gives the tight
    pad per sampling mode)."""
    from .. import native as _native

    res = _native.item_bands(
        meta, brick_bounds, wt, wb, eye, forward, right, up,
        fov_y_degrees, axes, width, logical_width, logical_height,
        occ_bits, nq, split, split_v, ghost, min_gap,
        seg_len=seg_len, margin=margin,
    )
    if res is not None:
        return res
    bounds, sel, ok, fwd = compute_item_slice_bounds(
        meta, brick_bounds, wt, wb, eye, forward, right, up,
        fov_y_degrees, axes, width, height, logical_width, logical_height,
        occ_bits, nq, split, split_v, ghost=ghost, return_mask=True,
        seg_len=seg_len, margin=margin,
    )
    band1, band2 = find_second_bands(sel, bounds, ok, min_gap=min_gap)
    return band1, band2, fwd


def build_tile_worklist(
    box_min: np.ndarray,
    box_max: np.ndarray,
    depth_hints: np.ndarray,
    owners: np.ndarray,
    eye: np.ndarray,
    forward: np.ndarray,
    right: np.ndarray,
    up: np.ndarray,
    fov_y_degrees: float,
    width: int,
    height: int,
    logical_width: Optional[int] = None,
    logical_height: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR per-tile brick lists, front-to-back by (hint, owner, index).

    Returns (offsets [T+1], bricks [W], work_owners [W])."""
    owners = np.asarray(owners)
    wb, wt, _ = compute_worklist(
        box_min, box_max, eye, forward, right, up, fov_y_degrees,
        width, height, logical_width=logical_width,
        logical_height=logical_height, pad_to=1, with_coverage=False,
    )
    num_tiles = (width // TILE_W) * (height // TILE_H)
    # order per tile by (hint, owner, brick index)
    order = np.lexsort((wb, owners[wb], depth_hints[wb], wt))
    wt_sorted = wt[order]
    wb_sorted = wb[order]
    counts = np.bincount(wt_sorted, minlength=num_tiles)
    offsets = np.zeros(num_tiles + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    return (
        offsets,
        wb_sorted.astype(np.int32),
        owners[wb_sorted].astype(np.int32),
    )
