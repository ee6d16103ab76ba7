"""Slice-marching renderer: the fast path's integrator, in plain JAX.

The reference ray-marcher takes fixed world-space steps along each ray with
nearest-cell sampling (Common/VolumePainter.cpp:837-900).  This integrator
re-derives it around one march axis per frame:

  * **March along the dominant view axis, slice by slice.**  For slice k
    (cell-centered plane z_k), every ray samples the slice where it crosses
    the plane: t_k = (z_k - eye_a) / d_a.  One loop iteration touches ONE
    brick slice.
  * **A slice is one flat table of at most 1024 cells.**  Bricks are
    pre-split so a slice has at most ``SLICE_CELLS`` cells, packed row-major
    over (u, v) into a ``[SUBLANES, LANES]`` = [8, 128] block; a sample is
    one native gather from the packed ``[B, S, 8, 128]`` brick table.
  * **Per-ray opacity correction.**  Between slices a ray advances
    dt = cell_a / |d_a| (constant per ray).  The LUT stores
    L = log(1 - alpha_ref) and the march applies the step-normalized
    opacity  alpha = 1 - exp(L * dt / reference_distance)  — the same
    normalization law as the reference (VolumePainter.cpp:107-125) with a
    per-ray instead of per-brick step ratio.
  * Rays whose march-axis direction component is negative visit slices in
    reverse, so mixed-sign tiles stay correct.

The unit of work is an *item*: one brick against one 32x32 pixel tile
(``TILE_P`` rays).  ``march_items`` integrates a whole item list at once —
every (item, pixel) pair is independent, only the slice loop is sequential
— and the public renderers below are item lists over it.

Results agree with the reference integrator to the pixel-parity tolerance
on smooth fields (integration abscissae differ; both converge to the same
volume-rendering integral as the step shrinks).  Every operation is
elementwise float32 or an integer-indexed gather: no matrix product, so no
reduced-precision (TF32) path can enter.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

LANES = 128
SUBLANES = 8
TILE_P = LANES * SUBLANES  # rays per item (one 32x32 pixel tile)
SLICE_CELLS = LANES * SUBLANES  # max cells per brick slice

COLOR_TABLE_SIZE = 256  # default (reference) transfer-function resolution
LUT_ROWS = COLOR_TABLE_SIZE // LANES  # packed rows of the default LUT

TILE_W = 32
TILE_H = 32


def match_vma(init, like):
    """Give loop-carry inits the varying mesh axes of ``like``.

    Under ``shard_map`` a loop carry must keep one type across iterations;
    zeros built inside the body are replicated while the body's outputs
    vary over the mesh, so the inits are cast to the outputs' axes (a
    no-op outside ``shard_map``)."""
    vma = tuple(sorted(getattr(jax.typeof(like), "vma", ()) or ()))
    if not vma:
        return init
    return jax.tree.map(lambda x: jax.lax.pcast(x, vma, to="varying"), init)


def _pick(vals, p):
    """vals[p] for a per-item axis id ``p`` (the march-axis permutation)."""
    out = vals[2]
    out = jnp.where(p == 0, vals[0], out)
    return jnp.where(p == 1, vals[1], out)


def item_params(meta_at, dims_at, bounds, max_slices: int) -> dict:
    """Per-item march parameters from accessors of its brick's ``meta``
    (12 floats) and ``dims`` (8 ints) and its packed slice ``bounds``.

    Values may be scalars (one item per program) or [W, 1] columns (a
    vectorized item list); the integrator broadcasts either way."""
    n_slices, nu, nv = dims_at(0), dims_at(1), dims_at(2)
    # slice row stride: canonical-cube packs use a padded stride (slot 6);
    # tightly packed volumes leave it 0 (= nv)
    stride = dims_at(6)
    # occupied slice bounds: only slices whose values can map to nonzero
    # LUT alpha are marched (0 = unset = full range)
    s_lo = jnp.where(bounds > 0, bounds >> 16, 0)
    s_hi = jnp.where(bounds > 0, bounds & 0xFFFF, n_slices)
    return dict(
        pmin=[meta_at(i) for i in range(3)],
        pmax=[meta_at(3 + i) for i in range(3)],
        cell=[meta_at(6 + i) for i in range(3)],
        n_slices=n_slices, nu=nu, nv=nv,
        perm=[dims_at(3 + i) for i in range(3)],
        nv_stride=jnp.where(stride > 0, stride, nv),
        s_lo=s_lo, s_hi=s_hi, hi=jnp.minimum(s_hi, max_slices),
    )


def tile_rays(cam, item, tile, p, *, width, logical_width, logical_height):
    """Rays of pixels ``p`` (index within the 32x32 tile) of frame tile
    ``tile``, in world space and permuted into the item's brick axes
    (march axis first), with the slab-test hit interval.

    Returns (d_w, eye, d, tmin, tmax, hit, marchable)."""
    f32 = jnp.float32
    inf, neg_inf = f32(np.inf), f32(-np.inf)
    eye_w, fwd, right, up = cam[0:3], cam[3:6], cam[6:9], cam[9:12]
    tan_half_fov, aspect = cam[12], cam[13]
    tiles_x = width // TILE_W
    px = (tile % tiles_x * TILE_W + p % TILE_W).astype(f32)
    py = (tile // tiles_x * TILE_H + p // TILE_W).astype(f32)
    ndc_x = (px + 0.5) * (2.0 / logical_width) - 1.0
    ndc_y = (py + 0.5) * (2.0 / logical_height) - 1.0
    plane_x = ndc_x * tan_half_fov * aspect
    plane_y = ndc_y * tan_half_fov
    d_w = [fwd[i] + plane_x * right[i] + plane_y * up[i] for i in range(3)]
    len_sq = d_w[0] ** 2 + d_w[1] ** 2 + d_w[2] ** 2
    inv_len = jnp.where(len_sq > 0.0, jax.lax.rsqrt(len_sq), 0.0)
    d_w = [di * inv_len for di in d_w]
    perm, pmin, pmax = item["perm"], item["pmin"], item["pmax"]
    eye = [_pick(eye_w, perm[i]) for i in range(3)]
    d = [_pick(d_w, perm[i]) for i in range(3)]

    # slab test in permuted space for hit mask + entry depth
    tmin = jnp.full(px.shape, -np.inf, f32)
    tmax = jnp.full(px.shape, np.inf, f32)
    for axis in range(3):
        parallel = jnp.abs(d[axis]) < 1e-8
        inv = 1.0 / jnp.where(parallel, 1.0, d[axis])
        t1 = (pmin[axis] - eye[axis]) * inv
        t2 = (pmax[axis] - eye[axis]) * inv
        inside = (eye[axis] >= pmin[axis]) & (eye[axis] <= pmax[axis])
        lo = jnp.where(parallel, jnp.where(inside, neg_inf, inf),
                       jnp.minimum(t1, t2))
        hi_t = jnp.where(parallel, jnp.where(inside, inf, neg_inf),
                         jnp.maximum(t1, t2))
        tmin = jnp.maximum(tmin, lo)
        tmax = jnp.minimum(tmax, hi_t)
    hit = (tmax >= tmin) & (tmax > 0.0)
    # the marchable guard excludes rays perpendicular to the march axis,
    # which a perspective camera below fov 180 cannot produce; wide-FOV
    # parity vs the raymarch oracle: tests/test_widefov.py
    marchable = jnp.abs(d[0]) > 1e-8
    return d_w, eye, d, tmin, tmax, hit, marchable


def sample_slice(k, cam, item, rays, fetch, lookup, *, table_max: int,
                 max_slices: int, sampling: str, ghost: int,
                 classification: str):
    """Slice ``k`` (loop index in [s_lo, hi)) of an item's rays:
    (r, g, b, alpha) before the front-to-back blend.

    ``fetch(kk, flat)`` returns the f32 sample of stored slice ``kk``
    (core index) at in-slice cell ``flat``; ``lookup(ch, idx)`` returns
    LUT channel ``ch`` (r, g, b, log(1 - alpha_ref)) at entry ``idx``."""
    f32 = jnp.float32
    range_min, inverse_range, ref_distance = cam[14], cam[15], cam[16]
    _d_w, eye, d, tmin, tmax, hit, marchable = rays
    pmin, cell = item["pmin"], item["cell"]
    nu, nv, nv_stride = item["nu"], item["nv"], item["nv_stride"]
    s_lo, s_hi = item["s_lo"], item["s_hi"]
    inv_da = 1.0 / jnp.where(marchable, d[0], 1.0)
    backward = d[0] < 0.0
    dt = cell[0] * jnp.abs(inv_da)  # distance along ray between slices
    t_lo = jnp.maximum(tmin, 0.0)
    t_hi = tmax

    def classify(scalar):
        normalized = jnp.clip((scalar - range_min) * inverse_range, 0.0, 1.0)
        idx = jnp.clip((normalized * table_max).astype(jnp.int32), 0,
                       table_max)
        return tuple(lookup(ch, idx) for ch in range(4))

    # backward rays mirror within the occupied range
    k_eff = jnp.where(backward, s_lo + s_hi - 1 - k, k)
    z_k = pmin[0] + (k_eff.astype(f32) + 0.5) * cell[0]
    t_k = (z_k - eye[0]) * inv_da
    pos_u = eye[1] + d[1] * t_k
    pos_v = eye[2] + d[2] * t_k
    # exact quadrature: weight = overlap of this slice's half-cell window
    # [t_k - dt/2, t_k + dt/2] with the ray's clipped intersection
    # interval.  Windows of consecutive slices tile the ray exactly, so
    # grazing corner slivers are integrated instead of dropped (unlike
    # naive plane-crossing sampling).
    w = jnp.maximum(
        jnp.minimum(t_k + 0.5 * dt, t_hi) - jnp.maximum(t_k - 0.5 * dt, t_lo),
        0.0,
    )
    valid = (hit & marchable & (k < item["hi"])
             & (k < jnp.minimum(s_hi, item["n_slices"])) & (w > 0.0))
    k_load = jnp.minimum(k, jnp.maximum(s_hi - 1, 0))
    k_rev_load = jnp.clip(s_lo + s_hi - 1 - k_load, 0, max_slices - 1 - ghost)
    kk = jnp.where(backward, k_rev_load, k_load)

    def at(iu_, iv_):
        return fetch(kk, (iu_ + ghost) * nv_stride + (iv_ + ghost))

    if sampling == "nearest":
        fu = jnp.floor((pos_u - pmin[1]) / cell[1])
        fv = jnp.floor((pos_v - pmin[2]) / cell[2])
        iu = jnp.clip(fu.astype(jnp.int32), 0, nu - 1)
        iv = jnp.clip(fv.astype(jnp.int32), 0, nv - 1)
        s_r, s_g, s_b, s_l = classify(at(iu, iv))
    else:
        # trilinear: sample points sit exactly on the march axis'
        # cell-center planes, so trilinear reduces to BILINEAR within the
        # slice.  Clamp-to-edge: the coordinate is clipped into the
        # available cell-center range FIRST (core plus the ghost ring,
        # matching slicemarch_reference), so true brick faces take the
        # constant edge value while split-piece boundaries interpolate one
        # cell into the neighbor's data via the ring.
        g, neg_g = f32(ghost), f32(-ghost)
        pu = (pos_u - pmin[1]) / cell[1] - 0.5
        pv = (pos_v - pmin[2]) / cell[2] - 0.5
        pu = jnp.clip(pu, neg_g, (nu - 1).astype(f32) + g)
        pv = jnp.clip(pv, neg_g, (nv - 1).astype(f32) + g)
        fu0 = jnp.floor(pu)
        fv0 = jnp.floor(pv)
        wu = jnp.clip(pu - fu0, 0.0, 1.0)
        wv = jnp.clip(pv - fv0, 0.0, 1.0)
        iu0 = fu0.astype(jnp.int32)
        iu1 = jnp.minimum(iu0 + 1, nu - 1 + ghost)
        iv0 = fv0.astype(jnp.int32)
        iv1 = jnp.minimum(iv0 + 1, nv - 1 + ghost)
        c00, c10, c01, c11 = at(iu0, iv0), at(iu1, iv0), at(iu0, iv1), at(iu1, iv1)
        if classification == "pre":
            # VTK-style PRE-classification: classify each bilinear corner,
            # then interpolate the CLASSIFIED channels.  Opacity
            # interpolates in log-transmittance space (the geometric mean
            # of corner transparencies) — exact at corners, and the step
            # normalization applies unchanged.
            wts = ((1.0 - wu) * (1.0 - wv), wu * (1.0 - wv),
                   (1.0 - wu) * wv, wu * wv)
            chans = None
            for v_c, wgt in zip((c00, c10, c01, c11), wts):
                r_c, g_c, b_c, l_c = classify(v_c)
                # opaque entries store L = -inf; clamp before weighting so
                # a zero-weight opaque corner contributes 0, not NaN
                l_c = jnp.maximum(l_c, f32(-1e4))
                term = (r_c * wgt, g_c * wgt, b_c * wgt, l_c * wgt)
                chans = term if chans is None else tuple(
                    a + t for a, t in zip(chans, term)
                )
            s_r, s_g, s_b, s_l = chans
        else:
            v0 = c00 * (1.0 - wu) + c10 * wu
            v1 = c01 * (1.0 - wu) + c11 * wu
            s_r, s_g, s_b, s_l = classify(v0 * (1.0 - wv) + v1 * wv)

    # step-normalized opacity with the per-sample segment length:
    # 1 - (1 - a)^(w/ref) = 1 - exp((w/ref) * L).  Guarded so that w == 0
    # with an opaque LUT entry (L = -inf) stays 0, not NaN.
    sample_a = jnp.where(valid, 1.0 - jnp.exp(w / ref_distance * s_l), 0.0)
    return s_r, s_g, s_b, sample_a


def over_step(acc, sample):
    """Front-to-back blend of one slice sample into the accumulator."""
    acc_r, acc_g, acc_b, acc_a = acc
    s_r, s_g, s_b, sample_a = sample
    alpha = sample_a * (1.0 - acc_a)
    return (acc_r + s_r * alpha, acc_g + s_g * alpha,
            acc_b + s_b * alpha, acc_a + alpha)


def finish_item(acc, rays, cam):
    """Clipped (r, g, b, a) and entry depth (+inf where nothing was hit)."""
    d_w, _eye, _d, tmin, _tmax, hit, _m = rays
    fwd = cam[3:6]
    acc = tuple(jnp.clip(a, 0.0, 1.0) for a in acc)
    entry_depth = tmin * (d_w[0] * fwd[0] + d_w[1] * fwd[1] + d_w[2] * fwd[2])
    depth = jnp.where(
        hit & (acc[3] > 0.0) & jnp.isfinite(entry_depth), entry_depth,
        jnp.float32(np.inf),
    )
    return acc, depth


def march_items(
    vol: jnp.ndarray,  # [B, S_max, 8, 128] f32/bf16 packed slice bricks
    meta: jnp.ndarray,  # [B, 12] f32 permuted pmin/pmax/cell
    dims: jnp.ndarray,  # [B, 8] i32 n_slices nu nv perm(3) stride bounds
    lut: jnp.ndarray,  # [4, size // 128, 128] shared or [B, 4, ...] per brick
    cam: jnp.ndarray,  # [20] f32 (pack_camera layout)
    item_bricks: jnp.ndarray,  # [W] i32 brick per item
    item_tiles: jnp.ndarray,  # [W] i32 frame tile per item
    item_bounds: jnp.ndarray,  # [W] i32 packed (s_lo << 16) | s_hi, 0 = all
    *,
    width: int,
    logical_width: int,
    logical_height: int,
    max_slices: int,
    sampling: str = "nearest",
    ghost: int = 0,
    classification: str = "post",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """March every item's tile of rays through its brick.

    Returns (colors [W, 4, TILE_P], depths [W, TILE_P]) in channel-plane
    layout; pixel ``p`` of an item is (row p // TILE_W, column p % TILE_W)
    of its tile.

    ``ghost`` (static) marks packs whose data carries a ``ghost``-cell ring
    around the core on every axis: loads are offset by ``ghost`` on all
    three axes while the world bounds in ``meta`` (and so entry/exit, slice
    positions, and integration windows) stay the core's.  Trilinear
    sampling then interpolates into neighbor data at split-piece boundaries
    instead of clamping.  ``width`` is the tile-padded buffer width; ray
    math uses ``logical_width``/``logical_height`` so padded frames render
    the same view as unpadded ones."""
    s_stored = vol.shape[1]
    # one row per stored slice: rows and in-slice cells index separately,
    # so no int32 offset wraps on tables of 2^31 cells or more
    vol_rows = vol.reshape(-1, SLICE_CELLS)
    size = lut.shape[-2] * lut.shape[-1]
    lut_flat = lut.reshape(-1)
    cam = [cam[i] for i in range(17)]

    b = item_bricks.astype(jnp.int32)[:, None]  # [W, 1]
    t = item_tiles.astype(jnp.int32)[:, None]
    m = meta[item_bricks]  # [W, 12]
    dm = dims[item_bricks]  # [W, 8]
    item = item_params(
        lambda i: m[:, i:i + 1], lambda i: dm[:, i:i + 1],
        item_bounds.astype(jnp.int32)[:, None], max_slices,
    )
    p = jnp.arange(TILE_P, dtype=jnp.int32)[None, :]
    slice_base = b * s_stored  # first stored slice of the item's brick
    lut_base = (b if lut.ndim == 4 else jnp.zeros_like(b)) * (4 * size)

    def fetch(kk, flat):
        row = slice_base + kk + ghost
        return vol_rows.at[row, flat].get(mode="clip").astype(jnp.float32)

    def lookup(ch, idx):
        return jnp.take(lut_flat, lut_base + ch * size + idx, mode="clip")

    def rays():
        # recomputed inside the slice loop from the [W, 1] item tables:
        # the arithmetic is cheaper than carrying a dozen [W, TILE_P]
        # invariants through device memory on every iteration
        return tile_rays(cam, item, t, p, width=width,
                         logical_width=logical_width,
                         logical_height=logical_height)

    def body(j, acc):
        return over_step(acc, sample_slice(
            item["s_lo"] + j, cam, item, rays(), fetch, lookup,
            table_max=size - 1, max_slices=max_slices, sampling=sampling,
            ghost=ghost, classification=classification,
        ))

    zero = jnp.zeros((t.shape[0], TILE_P), jnp.float32)
    init = (zero, zero, zero, zero)
    init = match_vma(init, body(0, init)[3])
    # the loop runs the longest occupied range of the list; shorter items
    # are masked by ``k < hi`` (zero alpha leaves the accumulator exact)
    trips = jnp.max(jnp.maximum(item["hi"] - item["s_lo"], 0), initial=0)
    acc = jax.lax.fori_loop(0, trips, body, init)
    acc, depth = finish_item(acc, rays(), cam)
    return jnp.stack(acc, axis=1), depth


def untile(colors: jnp.ndarray, depths: jnp.ndarray, width: int, height: int,
           tile_w: int, tile_h: int):
    """[B, T, 4, S, L] channel-plane tile buffers -> row-major [B, H*W, ...]."""
    num_bricks = colors.shape[0]
    tiles_x = width // tile_w
    tiles_y = height // tile_h
    c = colors.reshape(num_bricks, tiles_y, tiles_x, 4, tile_h, tile_w)
    c = c.transpose(0, 1, 4, 2, 5, 3).reshape(num_bricks, height * width, 4)
    d = depths.reshape(num_bricks, tiles_y, tiles_x, tile_h, tile_w)
    d = d.transpose(0, 1, 3, 2, 4).reshape(num_bricks, height * width)
    return c, d


_STATIC = (
    "width", "height", "logical_width", "logical_height", "max_slices",
    "sampling", "ghost", "classification",
)


def _march_kw(width, height, logical_width, logical_height, max_slices,
              sampling, ghost, classification):
    assert width % TILE_W == 0 and height % TILE_H == 0
    return dict(
        width=width, logical_width=logical_width or width,
        logical_height=logical_height or height, max_slices=max_slices,
        sampling=sampling, ghost=ghost, classification=classification,
    )


@functools.partial(jax.jit, static_argnames=_STATIC)
def slicemarch_render(
    vol: jnp.ndarray,  # [B, S_max, 8, 128] f32 permuted slice-flattened bricks
    meta: jnp.ndarray,  # [B, 12] f32
    dims: jnp.ndarray,  # [B, 8] i32
    lut: jnp.ndarray,  # [B, 4, size // 128, 128] f32
    cam: jnp.ndarray,  # [20] f32
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
    """Dense render: every brick against every pixel tile.  Returns
    row-major ([B, H*W, 4], [B, H*W]).

    ``sampling="trilinear"`` interpolates within each slice (sample points
    lie on the march axis' cell-center planes, so trilinear == in-slice
    bilinear); the reference is nearest-cell (VolumePainter.cpp:869-880).
    Boundary handling is clamp-to-edge over core + ghost ring: with
    ``ghost > 0`` (packs from split_brick_for_slices/_split_to_cubes with
    ghost rings) split-piece boundaries interpolate into neighbor data —
    seam-free decompositions — while true brick faces take the constant
    edge value.  Cross-BRICK boundaries still clamp (each brick's ring is
    edge-replicated; tests/test_ghost.py locks both behaviors)."""
    num_bricks = vol.shape[0]
    num_tiles = width * height // TILE_P
    wb = jnp.repeat(jnp.arange(num_bricks, dtype=jnp.int32), num_tiles)
    wt = jnp.tile(jnp.arange(num_tiles, dtype=jnp.int32), num_bricks)
    colors, depths = march_items(
        vol, meta, dims, lut, cam, wb, wt, dims[wb, 7],
        **_march_kw(width, height, logical_width, logical_height, max_slices,
                    sampling, ghost, classification),
    )
    colors = colors.reshape(num_bricks, num_tiles, 4, SUBLANES, LANES)
    depths = depths.reshape(num_bricks, num_tiles, SUBLANES, LANES)
    return untile(colors, depths, width, height, TILE_W, TILE_H)


@functools.partial(jax.jit, static_argnames=_STATIC)
def slicemarch_render_worklist_raw(
    vol: jnp.ndarray,  # [B, S_max, 8, 128]
    meta: jnp.ndarray,  # [B, 12]
    dims: jnp.ndarray,  # [B, 8]
    lut: jnp.ndarray,  # [B, 4, size // 128, 128]
    cam: jnp.ndarray,  # [20]
    work_bricks: jnp.ndarray,  # [W] i32 — brick per work item
    work_tiles: jnp.ndarray,  # [W] i32 — 2D tile index per work item
    work_bounds: Optional[jnp.ndarray] = None,  # [W] i32 per-item slice
    #   bounds; None -> each item inherits its brick's dims[:, 7]
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
    """Work-list render returning TILE-ordered buffers ([B, T, 4, SUBLANES,
    LANES], [B, T, SUBLANES, LANES]).  Only scheduled (brick, tile) pairs
    are marched; unscheduled blocks hold the cleared layer (transparent,
    +inf depth)."""
    num_bricks = vol.shape[0]
    num_tiles = width * height // TILE_P
    if work_bounds is None:
        work_bounds = dims[work_bricks, 7]
    colors, depths = march_items(
        vol, meta, dims, lut, cam, work_bricks, work_tiles, work_bounds,
        **_march_kw(width, height, logical_width, logical_height, max_slices,
                    sampling, ghost, classification),
    )
    # the list may repeat its last item as padding: the rewrite is benign
    slot = work_bricks * num_tiles + work_tiles
    out_c = jnp.zeros((num_bricks * num_tiles, 4, TILE_P), jnp.float32)
    out_d = jnp.full((num_bricks * num_tiles, TILE_P), jnp.inf, jnp.float32)
    out_c = out_c.at[slot].set(colors)
    out_d = out_d.at[slot].set(depths)
    return (
        out_c.reshape(num_bricks, num_tiles, 4, SUBLANES, LANES),
        out_d.reshape(num_bricks, num_tiles, SUBLANES, LANES),
    )


@functools.partial(jax.jit, static_argnames=_STATIC)
def slicemarch_render_worklist(
    vol: jnp.ndarray,  # [B, S_max, 8, 128]
    meta: jnp.ndarray,  # [B, 12]
    dims: jnp.ndarray,  # [B, 8]
    lut: jnp.ndarray,  # [B, 4, size // 128, 128]
    cam: jnp.ndarray,  # [20]
    work_bricks: jnp.ndarray,  # [W] i32 — brick per work item
    work_tiles: jnp.ndarray,  # [W] i32 — 2D tile index per work item
    coverage: jnp.ndarray,  # [B, T] bool — which (brick, tile) were scheduled
    work_bounds: Optional[jnp.ndarray] = None,  # [W] i32 per-item slice
    #   bounds; None -> each item inherits its brick's dims[:, 7]
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
    """Work-list render: only scheduled (brick, tile) pairs execute.

    The host computes each brick's screen bounding box and emits one work
    item per covered tile (``compute_worklist``), so culled tiles cost
    nothing; blocks outside ``coverage`` come back cleared.  Returns
    row-major ([B, H*W, 4], [B, H*W])."""
    colors, depths = slicemarch_render_worklist_raw(
        vol, meta, dims, lut, cam, work_bricks, work_tiles, work_bounds,
        width=width, height=height, max_slices=max_slices,
        logical_width=logical_width, logical_height=logical_height,
        sampling=sampling, ghost=ghost, classification=classification,
    )
    colors = jnp.where(coverage[:, :, None, None, None], colors, 0.0)
    depths = jnp.where(coverage[:, :, None, None], depths, jnp.inf)
    return untile(colors, depths, width, height, TILE_W, TILE_H)


def project_screen_bboxes(
    box_min: np.ndarray,
    box_max: np.ndarray,
    eye: np.ndarray,
    forward: np.ndarray,
    right: np.ndarray,
    up: np.ndarray,
    fov_y_degrees: float,
    logical_width: int,
    logical_height: int,
):
    """Vectorized conservative screen bounding boxes of brick AABBs.

    Returns (lo_x, hi_x, lo_y, hi_y, behind) arrays [B]; ``behind`` marks
    bricks with a corner at/behind the eye plane (treated as full frame).
    """
    box_min = np.asarray(box_min, float)
    box_max = np.asarray(box_max, float)
    num = len(box_min)
    thf = math.tan(fov_y_degrees * 0.5 * math.pi / 180.0)
    aspect = logical_width / max(logical_height, 1)

    # [B, 8, 3] corners
    sel = np.array(
        [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], bool
    )
    corners = np.where(sel[None], box_max[:, None, :], box_min[:, None, :])
    rel = corners - np.asarray(eye)[None, None, :]
    depth = rel @ np.asarray(forward)
    behind = (depth <= 1e-9).any(axis=1)
    safe_depth = np.where(depth > 1e-9, depth, 1.0)
    ndc_x = (rel @ np.asarray(right)) / (safe_depth * thf * aspect)
    ndc_y = (rel @ np.asarray(up)) / (safe_depth * thf)
    sx = (ndc_x * 0.5 + 0.5) * logical_width
    sy = (ndc_y * 0.5 + 0.5) * logical_height
    return (
        sx.min(axis=1), sx.max(axis=1), sy.min(axis=1), sy.max(axis=1), behind
    )


def compute_worklist(
    box_min: np.ndarray,  # [B, 3] world corners (unpermuted)
    box_max: np.ndarray,  # [B, 3]
    eye: np.ndarray,
    forward: np.ndarray,
    right: np.ndarray,
    up: np.ndarray,
    fov_y_degrees: float,
    width: int,
    height: int,
    logical_width: Optional[int] = None,
    logical_height: Optional[int] = None,
    pad_to: int = 256,
    with_coverage: bool = True,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Screen-bbox tile work list: one (brick, tile) item per 2D tile whose
    pixel block intersects the brick's projected bounding box.

    Conservative: bricks with any corner at or behind the eye plane cover
    the whole frame.  Returns (work_bricks, work_tiles, coverage[B, T]);
    the work list is padded to a multiple of ``pad_to`` by repeating the
    last item (harmless re-render of a covered tile).  The list is built
    directly from each brick's tile rectangle — O(items), never the
    O(bricks x tiles) boolean matrix; ``with_coverage=False`` callers
    (the persistent path, which only needs the CSR list) skip
    materializing ``coverage`` entirely (returned as None).
    """
    tiles_x = width // TILE_W
    tiles_y = height // TILE_H
    num_tiles = tiles_x * tiles_y
    lw = logical_width or width
    lh = logical_height or height
    num_bricks = len(box_min)

    if num_bricks:
        lo_x, hi_x, lo_y, hi_y, behind = project_screen_bboxes(
            box_min, box_max, eye, forward, right, up, fov_y_degrees, lw, lh
        )
        tx0 = np.clip(((lo_x - 1).astype(np.int64)) // TILE_W, 0, tiles_x - 1)
        tx1 = np.clip(((hi_x + 1).astype(np.int64)) // TILE_W, 0, tiles_x - 1)
        ty0 = np.clip(((lo_y - 1).astype(np.int64)) // TILE_H, 0, tiles_y - 1)
        ty1 = np.clip(((hi_y + 1).astype(np.int64)) // TILE_H, 0, tiles_y - 1)
        tx0 = np.where(behind, 0, tx0)
        tx1 = np.where(behind, tiles_x - 1, tx1)
        ty0 = np.where(behind, 0, ty0)
        ty1 = np.where(behind, tiles_y - 1, ty1)
        offscreen = (~behind) & ((hi_x < 0) | (lo_x > lw) | (hi_y < 0) | (lo_y > lh))

        # expand each brick's [tx0, tx1] x [ty0, ty1] tile rect into
        # (brick, tile) items in brick-major, ascending-tile order (the
        # order np.nonzero on the coverage matrix would produce)
        nx = tx1 - tx0 + 1
        cnt = np.where(offscreen, 0, nx * (ty1 - ty0 + 1))
        total = int(cnt.sum())
        wb = np.repeat(np.arange(num_bricks, dtype=np.int64), cnt)
        starts = np.cumsum(cnt) - cnt
        j = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
        nxr = np.repeat(nx, cnt)
        ty = np.repeat(ty0, cnt) + j // nxr
        tx = np.repeat(tx0, cnt) + j % nxr
        wt = ty * tiles_x + tx
    else:
        wb = np.zeros(0, np.int64)
        wt = np.zeros(0, np.int64)

    wb = wb.astype(np.int32)
    wt = wt.astype(np.int32)
    coverage = None
    if with_coverage:
        coverage = np.zeros((num_bricks, num_tiles), dtype=bool)
        coverage[wb, wt] = True
    if len(wb) == 0:
        wb = np.array([0], np.int32)
        wt = np.array([0], np.int32)
        if with_coverage:
            coverage[0 if num_bricks else slice(0, 0), 0] = True

    # pad by repeating the final item so compiled shapes bucket coarsely
    target = ((len(wb) + pad_to - 1) // pad_to) * pad_to
    if target > len(wb):
        pad = target - len(wb)
        wb = np.concatenate([wb, np.full(pad, wb[-1], np.int32)])
        wt = np.concatenate([wt, np.full(pad, wt[-1], np.int32)])
    return wb, wt, coverage


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------


def choose_march_axis(view_dir: np.ndarray) -> int:
    """Dominant world axis of the view direction (global per frame)."""
    return int(np.argmax(np.abs(view_dir)))


def split_brick_for_slices(
    data: np.ndarray, min_corner: np.ndarray, max_corner: np.ndarray,
    axis: int, ghost: int = 0, padded: Optional[np.ndarray] = None,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Split a brick along the non-march axes until a slice fits one
    ``SLICE_CELLS`` block.

    Returns [(data, min_corner, max_corner), ...].  With ``ghost == 0``
    (nearest sampling) pieces are metadata-only views into the original
    array.  With ``ghost > 0`` each returned array carries a ``ghost``-cell
    ring on every axis — neighbor data of the same brick at split-piece
    boundaries, edge-replicated at true brick faces — while the world
    corners still bound the *core* region; trilinear sampling interpolates
    into the ring instead of clamping, making piece splits seam-free
    (the reference never splits, VolumePainter.cpp:775-809, so the clamped
    variant has no parity anchor; this matches the unsplit render).

    ``padded`` optionally supplies the ``ghost``-padded array (shape
    ``data.shape + 2*ghost`` per axis) so the ring at true brick faces can
    carry neighbor-BRICK data instead of edge replication
    (ghost.ghost_fill); when omitted the ring is edge-replicated here.
    """
    axes = [axis] + [a for a in range(3) if a != axis]
    nu_axis, nv_axis = axes[1], axes[2]
    shape = np.asarray(data.shape, int)
    mn0 = np.asarray(min_corner, float)
    mx0 = np.asarray(max_corner, float)
    spans = np.where(shape > 0, (mx0 - mn0) / np.maximum(shape, 1), 1.0)
    boxes = [(np.zeros(3, int), shape.copy())]  # core cell-index ranges
    # split the larger transverse axis in half until the (ghosted) slice fits
    while True:
        next_boxes = []
        done = True
        for lo, hi in boxes:
            nu = hi[nu_axis] - lo[nu_axis]
            nv = hi[nv_axis] - lo[nv_axis]
            if (nu + 2 * ghost) * (nv + 2 * ghost) <= SLICE_CELLS:
                next_boxes.append((lo, hi))
                continue
            done = False
            split_axis = nu_axis if nu >= nv else nv_axis
            mid = lo[split_axis] + (hi[split_axis] - lo[split_axis]) // 2
            hi_lo, lo_hi = hi.copy(), lo.copy()
            hi_lo[split_axis] = mid
            lo_hi[split_axis] = mid
            next_boxes.append((lo, hi_lo))
            next_boxes.append((lo_hi, hi))
        boxes = next_boxes
        if done:
            break
    if padded is None:
        padded = np.pad(data, ghost, mode="edge") if ghost else data
    else:
        assert ghost and padded.shape == tuple(shape + 2 * ghost)
    pieces = []
    for lo, hi in boxes:
        mn = mn0 + lo * spans
        mx = mn0 + hi * spans
        # core cell i sits at padded index i + ghost, so the ghosted block
        # [lo, hi + 2*ghost) carries the ring around the core
        block = padded[
            lo[0]: hi[0] + 2 * ghost,
            lo[1]: hi[1] + 2 * ghost,
            lo[2]: hi[2] + 2 * ghost,
        ]
        pieces.append((block, mn, mx))
    return pieces


def pack_slice_volume(
    data: np.ndarray, axis: int, ghost: int = 0
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Permute so the march axis is first and flatten slices into
    ``SLICE_CELLS``-cell [8, 128] blocks (row-major over (u, v), zero
    padded).

    ``data`` may carry a ``ghost``-cell ring (split_brick_for_slices); the
    returned dims are the CORE counts while the packed array keeps the full
    stored extent (row stride = nv + 2*ghost, the kernels' ``dims[6]``)."""
    axes = [axis] + [a for a in range(3) if a != axis]
    vol = np.transpose(np.asarray(data, np.float32), axes)
    ns_st, nu_st, nv_st = vol.shape
    assert nu_st * nv_st <= SLICE_CELLS, (nu_st, nv_st)
    flat = np.zeros((ns_st, SLICE_CELLS), dtype=np.float32)
    flat[:, : nu_st * nv_st] = vol.reshape(ns_st, nu_st * nv_st)
    core = (ns_st - 2 * ghost, nu_st - 2 * ghost, nv_st - 2 * ghost)
    return flat.reshape(ns_st, SUBLANES, LANES), core


def compute_slice_bounds(
    vol: np.ndarray,  # [ns, 8, 128] packed slices (padding zeros ok)
    lut_alpha: np.ndarray,  # [size] transfer-function alpha
    range_min: float = 0.0,
    inverse_range: float = 1.0,
) -> int:
    """Empty-space skipping: the occupied slice range of a packed brick.

    A slice is *occupied* when any LUT index its value range can map to has
    nonzero alpha (conservative: padding zeros widen the range, never shrink
    it).  Returns ``(s_lo << 16) | s_hi`` for ``dims[7]``; an all-transparent
    brick returns ``(ns << 16) | ns`` (a zero-trip march loop).  The skipped
    slices contribute exactly zero opacity — this tightens loop bounds, it
    does not approximate.  (The reference has no empty-space skipping;
    its ray marcher samples every step, Common/VolumePainter.cpp:837-900.)
    """
    ns = vol.shape[0]
    nz = np.asarray(lut_alpha) > 0.0
    table_max = len(nz) - 1  # table size follows the LUT argument
    prefix = np.concatenate([[0], np.cumsum(nz)])
    flat = vol.reshape(ns, -1)
    n0 = np.clip((flat.min(axis=1) - range_min) * inverse_range, 0.0, 1.0)
    n1 = np.clip((flat.max(axis=1) - range_min) * inverse_range, 0.0, 1.0)
    i0 = np.clip((n0 * table_max).astype(np.int64), 0, table_max)
    i1 = np.clip((n1 * table_max).astype(np.int64), 0, table_max)
    occupied = (prefix[i1 + 1] - prefix[i0]) > 0
    if not occupied.any():
        return int((ns << 16) | ns)
    s_lo = int(np.argmax(occupied))
    s_hi = ns - int(np.argmax(occupied[::-1]))
    return int((s_lo << 16) | s_hi)


def compute_slice_bounds_batch(
    slice_min: np.ndarray,  # [L, S] per-slice minima along the march axis
    slice_max: np.ndarray,  # [L, S] per-slice maxima
    lut_alpha: np.ndarray,  # [size]
    range_min: float,
    inverse_range: float,
    n_slices: np.ndarray,  # [L] actual slice counts (<= S; rest is padding)
) -> np.ndarray:
    """Vectorized ``compute_slice_bounds`` over a piece table.

    Returns packed ``(s_lo << 16) | s_hi`` int32 [L] for ``dims[:, 7]``.
    Slices at or past ``n_slices`` are padding and never count as occupied.
    """
    num, cap = slice_min.shape
    nz = np.asarray(lut_alpha) > 0.0
    table_max = len(nz) - 1  # table size follows the LUT argument
    prefix = np.concatenate([[0], np.cumsum(nz)])
    n0 = np.clip((slice_min - range_min) * inverse_range, 0.0, 1.0)
    n1 = np.clip((slice_max - range_min) * inverse_range, 0.0, 1.0)
    i0 = np.clip((n0 * table_max).astype(np.int64), 0, table_max)
    i1 = np.clip((n1 * table_max).astype(np.int64), 0, table_max)
    occupied = (prefix[i1 + 1] - prefix[i0]) > 0
    occupied &= np.arange(cap)[None, :] < np.asarray(n_slices)[:, None]
    any_occ = occupied.any(axis=1)
    s_lo = np.argmax(occupied, axis=1)
    s_hi = cap - np.argmax(occupied[:, ::-1], axis=1)
    ns = np.asarray(n_slices, np.int64)
    packed = np.where(any_occ, (s_lo << 16) | s_hi, (ns << 16) | ns)
    return packed.astype(np.int32)


def build_log_lut(color_table: np.ndarray) -> np.ndarray:
    """Convert an (S, 4) rgba LUT (alpha at the reference step, i.e.
    normalization factor 1) into the kernel's [4, S // 128, 128] layout with
    channel 3 = log(1 - alpha).  S must be a positive multiple of 128
    (256 = the reference table; 128 = the half-resolution table)."""
    size = color_table.shape[0]
    if size <= 0 or size % LANES != 0:
        raise ValueError(
            f"LUT size must be a positive multiple of {LANES}, got {size}"
        )
    rgb = color_table[:, :3]
    alpha = np.clip(color_table[:, 3], 0.0, 1.0)
    with np.errstate(divide="ignore"):
        log_term = np.log1p(-alpha)  # -inf at alpha == 1 (=> opaque)
    packed = np.stack(
        [rgb[:, 0], rgb[:, 1], rgb[:, 2], log_term], axis=0
    ).astype(np.float32)
    return packed.reshape(4, size // LANES, LANES)


def pack_camera(
    eye, forward, right, up, fov_y_degrees, aspect, range_min, inverse_range,
    ref_distance,
) -> np.ndarray:
    cam = np.zeros(20, dtype=np.float32)
    cam[0:3] = eye
    cam[3:6] = forward
    cam[6:9] = right
    cam[9:12] = up
    cam[12] = math.tan(fov_y_degrees * 0.5 * math.pi / 180.0)
    cam[13] = aspect
    cam[14] = range_min
    cam[15] = inverse_range
    cam[16] = ref_distance
    return cam


# ---------------------------------------------------------------------------
# NumPy reference of the slice-march integrator (test oracle)
# ---------------------------------------------------------------------------


def slicemarch_reference(
    data: np.ndarray,  # [nx, ny, nz] pre-transformed scalars
    min_corner: np.ndarray,
    max_corner: np.ndarray,
    axis: int,
    color_table: np.ndarray,  # [256, 4] alpha at reference step
    ref_distance: float,
    eye: np.ndarray,
    forward: np.ndarray,
    right: np.ndarray,
    up: np.ndarray,
    fov_y_degrees: float,
    width: int,
    height: int,
    range_min: float = 0.0,
    inverse_range: float = 1.0,
    sampling: str = "nearest",
    classification: str = "post",
):
    """Scalar NumPy implementation of the exact kernel semantics."""
    axes = [axis] + [a for a in range(3) if a != axis]
    vol = np.transpose(np.asarray(data, np.float64), axes)
    pmin = np.asarray(min_corner, float)[axes]
    pmax = np.asarray(max_corner, float)[axes]
    ns, nu, nv = vol.shape
    cell = (pmax - pmin) / np.array([ns, nu, nv])
    aspect = width / max(height, 1)
    thf = math.tan(fov_y_degrees * 0.5 * math.pi / 180.0)

    colors = np.zeros((height * width, 4), np.float32)
    depths = np.full(height * width, np.inf, np.float32)
    alpha_tab = np.clip(color_table[:, 3], 0.0, 1.0)

    for p in range(height * width):
        x = p % width
        y = p // width
        ndc_x = (x + 0.5) / width * 2 - 1
        ndc_y = (y + 0.5) / height * 2 - 1
        d_world = forward + ndc_x * thf * aspect * right + ndc_y * thf * up
        d_world = d_world / np.linalg.norm(d_world)
        d = d_world[axes]
        e = np.asarray(eye, float)[axes]

        # slab in permuted space
        tmin, tmax = -np.inf, np.inf
        ok = True
        for a3 in range(3):
            if abs(d[a3]) < 1e-8:
                if e[a3] < pmin[a3] or e[a3] > pmax[a3]:
                    ok = False
                continue
            t1 = (pmin[a3] - e[a3]) / d[a3]
            t2 = (pmax[a3] - e[a3]) / d[a3]
            if t1 > t2:
                t1, t2 = t2, t1
            tmin = max(tmin, t1)
            tmax = min(tmax, t2)
        hit = ok and tmax >= tmin and tmax > 0
        if not hit or abs(d[0]) < 1e-8:
            continue

        dt = cell[0] / abs(d[0])
        t_lo = max(tmin, 0.0)
        t_hi = tmax
        ks = range(ns) if d[0] > 0 else range(ns - 1, -1, -1)
        acc = np.zeros(4)
        for k in ks:
            if acc[3] >= 1.0:
                break
            z_k = pmin[0] + (k + 0.5) * cell[0]
            t_k = (z_k - e[0]) / d[0]
            w = min(t_k + 0.5 * dt, t_hi) - max(t_k - 0.5 * dt, t_lo)
            if w <= 0:
                continue
            pu = e[1] + d[1] * t_k
            pv = e[2] + d[2] * t_k
            if sampling == "nearest":
                fu = math.floor((pu - pmin[1]) / cell[1])
                fv = math.floor((pv - pmin[2]) / cell[2])
                fu = min(max(fu, 0), nu - 1)
                fv = min(max(fv, 0), nv - 1)
                scalar = vol[k, int(fu), int(fv)]
            else:
                # clamp-to-edge (GL CLAMP_TO_EDGE / constant extension):
                # clip the sample coordinate into the cell-center range
                # FIRST so points in the outer half-cell take the edge
                # value instead of a shifted interior stencil
                cu = (pu - pmin[1]) / cell[1] - 0.5
                cv = (pv - pmin[2]) / cell[2] - 0.5
                cu = min(max(cu, 0.0), nu - 1.0)
                cv = min(max(cv, 0.0), nv - 1.0)
                fu0, fv0 = math.floor(cu), math.floor(cv)
                wu = min(max(cu - fu0, 0.0), 1.0)
                wv = min(max(cv - fv0, 0.0), 1.0)
                iu0 = min(max(int(fu0), 0), nu - 1)
                iu1 = min(iu0 + 1, nu - 1)
                iv0 = min(max(int(fv0), 0), nv - 1)
                iv1 = min(iv0 + 1, nv - 1)
                corners = (
                    (vol[k, iu0, iv0], (1 - wu) * (1 - wv)),
                    (vol[k, iu1, iv0], wu * (1 - wv)),
                    (vol[k, iu0, iv1], (1 - wu) * wv),
                    (vol[k, iu1, iv1], wu * wv),
                )
                # nested lerp, matching the kernel's FP association exactly
                v0 = vol[k, iu0, iv0] * (1 - wu) + vol[k, iu1, iv0] * wu
                v1 = vol[k, iu0, iv1] * (1 - wu) + vol[k, iu1, iv1] * wu
                scalar = v0 * (1 - wv) + v1 * wv
            qq = w / ref_distance

            def classify_idx(value):
                table_max = len(color_table) - 1
                n_ = min(max((value - range_min) * inverse_range, 0.0), 1.0)
                return min(max(int(n_ * table_max), 0), table_max)

            if sampling != "nearest" and classification == "pre":
                # PRE-classification: classify each corner, interpolate the
                # classified channels; opacity interpolates as
                # log-transmittance (the kernels' exact formula)
                rgb = np.zeros(3)
                log_t = 0.0
                for v_, w_ in corners:
                    ci = classify_idx(v_)
                    rgb += color_table[ci, :3] * w_
                    a_c = alpha_tab[ci]
                    l_c = math.log1p(-a_c) if a_c < 1.0 else -1e4
                    log_t += max(l_c, -1e4) * w_
                a = 1.0 - math.exp(qq * log_t)
            else:
                idx = classify_idx(scalar)
                rgb = color_table[idx, :3]
                a_ref = alpha_tab[idx]
                a = 1.0 - (1.0 - a_ref) ** qq if a_ref < 1.0 else 1.0
            contrib = a * (1.0 - acc[3])
            acc[:3] += rgb * contrib
            acc[3] += contrib
        acc = np.clip(acc, 0, 1)
        colors[p] = acc
        if acc[3] > 0:
            depths[p] = tmin * float(np.dot(d_world, forward))
    return colors, depths
