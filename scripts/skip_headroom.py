#!/usr/bin/env python3
"""Quantify the empty-space-skipping headroom left on the thin-shell scene.

The production kernel marches, per (tile, brick) work item, the slice range
that survives ``tilemarch.compute_item_slice_bounds`` (8x8 (u, v) block
occupancy x 4-slice segment footprints) plus the two-band chord split.
This script recomputes the same work list at FINER granularities — purely
host-side, fully deterministic, no GPU needed — and reports marched
slice-iterations for:

  * shipped:    8x8 blocks, seg_len=4, two-band split (what the kernel runs)
  * seg1:       8x8 blocks, seg_len=1 (exact per-slice corner footprints)
  * cell-exact: per-CELL occupancy intersected with exact per-slice
                footprint rectangles — the unreachable ideal for any
                footprint-rectangle x occupancy scheme
  * ray-exact:  per-RAY sample-level occupancy (casts the actual 8x128
                rays per tile, tests alpha(sample) > 0 with a 1-slice
                entry/exit pad) — the absolute lower bound: what a perfect
                per-ray skipper would march

The gap between "shipped" and "cell-exact" is what finer blocks/segments
could buy; the gap between cell-exact and ray-exact is the cost of the
rectangle-footprint abstraction itself.  Wall-clock impact is bounded by
the march fraction of the frame (see README's fixed-cost decomposition).
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, __import__("os").path.dirname(
        __import__("os").path.dirname(__import__("os").path.abspath(__file__))
    ))
    from bench import build_shell_scene, build_three_level_scene
    from amrvolumerenderer_tpu.camera import auto_orbit_camera, camera_basis
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.ops import tilemarch as tm
    from amrvolumerenderer_tpu.types import (
        RenderParameters,
        color_map_from_tuples,
    )

    scenes = {}
    shell_tf = color_map_from_tuples([
        (0.0, 0, 0, 0, 0.0), (0.3, 0, 0, 0, 0.0),
        (0.5, 1.0, 0.5, 0.2, 0.4), (1.0, 1.0, 1.0, 1.0, 0.8),
    ])
    scenes["shell_tf"] = (build_shell_scene, shell_tf)
    scenes["dense_3level"] = (build_three_level_scene, None)

    width = height = 1024
    for name, (builder, cmap) in scenes.items():
        geom = builder()
        fsr = FastSceneRenderer(geom, RenderParameters(width=width,
                                                       height=height))
        if cmap is not None:
            fsr.set_transfer_function(color_map=cmap)
        camera = auto_orbit_camera(fsr.bounds)
        t0 = time.perf_counter()
        inputs = fsr.frame_inputs(camera, as_numpy=True)
        prep_ms = (time.perf_counter() - t0) * 1e3
        if inputs is None:
            print(f"[{name}] fully culled")
            continue
        ib = inputs["item_bounds"].astype(np.int64)
        spans = np.maximum((ib & 0xFFFF) - (ib >> 16), 0)
        shipped_items = int((spans > 0).sum())
        shipped_iters = int(spans.sum())

        # ---- rebuild the un-split work list to vary the granularity ----
        forward, right, up = camera_basis(camera)
        axis = sm.choose_march_axis(forward)
        axes = [axis] + [a for a in range(3) if a != axis]
        num = fsr.canonical.shape[0]
        meta = np.zeros((num, 12), np.float32)
        meta[:, 0:3] = fsr.box_min[:, axes]
        meta[:, 3:6] = fsr.box_max[:, axes]
        dw = fsr.dims_world[:, axes].astype(np.float64)
        meta[:, 6:9] = (fsr.box_max[:, axes] - fsr.box_min[:, axes]) / dw
        range_min = fsr.scalar_range[0]
        span_v = fsr.scalar_range[1] - range_min
        inv_range = 1.0 / span_v if span_v != 0.0 else 1.0
        smin, smax = fsr._slice_minmax[axis]
        n_slices = fsr.dims_world[:, axes][:, 0].astype(np.int32)
        brick_bounds = sm.compute_slice_bounds_batch(
            smin, smax, fsr._lut_alpha, range_min, inv_range, n_slices
        )
        from amrvolumerenderer_tpu.camera import compute_box_depth_hints
        hints = compute_box_depth_hints(fsr.box_min, fsr.box_max, camera)
        offsets, tbricks, _towners = tm.build_tile_worklist(
            fsr.box_min, fsr.box_max, hints, fsr.owners,
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees, fsr.pad_w, fsr.pad_h,
            logical_width=width, logical_height=height,
        )
        keep = fsr.visible[tbricks]
        wt = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))[keep]
        wb = tbricks[keep]
        qmin, qmax = fsr._slice_quad_minmax[axis]
        occ_bits = tm.block_occupancy_bits(
            qmin, qmax, fsr._lut_alpha, range_min, inv_range
        )

        def iters_with(seg_len):
            # inline re-run of compute_item_slice_bounds with a different
            # segment length (the function hardcodes 4) — per-slice mask out
            saved = tm.compute_item_slice_bounds.__defaults__
            bounds, sel, ok, fwd = _bounds_with_seg(
                tm, meta, brick_bounds, wt, wb, camera, forward, right, up,
                axes, fsr, width, height, occ_bits, seg_len
            )
            b1, b2 = tm.find_second_bands(sel, bounds, ok, min_gap=6)
            _wt2, _wb2, _ow2, ib2 = tm.expand_bands(
                wt, wb, wb * 0, b1, b2, fwd
            )
            ib2 = ib2.astype(np.int64)
            sp = np.maximum((ib2 & 0xFFFF) - (ib2 >> 16), 0)
            return int(sp.sum()), int((sp > 0).sum()), sel, ok

        it4, n4, sel4, ok4 = iters_with(4)
        it1, n1, sel1, ok1 = iters_with(1)

        # ---- exact-cell ideal: per-cell occupancy x exact footprints ----
        v = np.moveaxis(np.asarray(fsr.canonical, np.float32), 1 + axis, 1)
        g = fsr.ghost
        if g:
            v = v[:, g: v.shape[1] - g]
        # value -> alpha > 0 per cell (post-classification nearest: the
        # kernel's LUT index mapping)
        idx = np.clip((np.clip((v - range_min) * inv_range, 0.0, 1.0)
                       * 255).astype(np.int32), 0, 255)
        occ_cell = fsr._lut_alpha[idx] > 0.0  # [L, S, U, V]
        L, S, U, V = occ_cell.shape
        sat = np.zeros((L, S, U + 1, V + 1), np.int32)
        sat[:, :, 1:, 1:] = occ_cell.cumsum(2).cumsum(3)

        cu_lo, cu_hi, cv_lo, cv_hi, okc = _footprints(
            tm, meta, wt, wb, camera, forward, right, up, axes,
            fsr, width, height, seg_len=1
        )
        # clip footprint rectangles to the stored grid and box-query the SAT
        bb = brick_bounds.astype(np.int64)[wb]
        blo, bhi = bb >> 16, bb & 0xFFFF
        Wn = len(wb)
        iters_cell = 0
        items_cell = 0
        u0 = np.clip(np.floor(cu_lo).astype(np.int64), 0, U)
        u1 = np.clip(np.ceil(cu_hi).astype(np.int64) + 1, 0, U)
        v0 = np.clip(np.floor(cv_lo).astype(np.int64), 0, V)
        v1 = np.clip(np.ceil(cv_hi).astype(np.int64) + 1, 0, V)
        s_idx = np.arange(S)[None, :]
        rows = np.arange(Wn)[:, None]
        bsel = sat[wb[:, None], s_idx, u1, v1] - sat[wb[:, None], s_idx, u0, v1] \
            - sat[wb[:, None], s_idx, u1, v0] + sat[wb[:, None], s_idx, u0, v0]
        cell_sel = (bsel > 0) & (s_idx >= blo[:, None]) & (s_idx < bhi[:, None])
        cell_sel &= (u1 > u0) & (v1 > v0)
        # trusted items use the exact mask; untrusted keep brick bounds
        fallback = np.zeros_like(cell_sel)
        fb_span = (s_idx >= blo[:, None]) & (s_idx < bhi[:, None])
        use = np.where(okc[:, None], cell_sel, fb_span)
        iters_cell = int(use.sum())
        items_cell = int(use.any(1).sum())

        # ---- per-ray exact ideal -------------------------------------
        ray_iters = _ray_exact(fsr, camera, occ_cell, meta, axes, wt, wb,
                               blo, bhi, width, height)

        px_tile = tm.TILE_P
        ghz = 10.7e9  # measured retire rate, README
        print(f"[{name}] prep {prep_ms:.1f} ms; items {shipped_items}")
        for label, iters, items in (
            ("shipped (8x8, seg4, bands)", shipped_iters, shipped_items),
            ("seg1    (8x8, seg1, bands)", it1, n1),
            ("cell-exact rect ideal     ", iters_cell, items_cell),
            ("ray-exact ideal           ", ray_iters, None),
        ):
            ms = iters * px_tile / ghz * 1e3
            extra = f" items {items}" if items is not None else ""
            print(f"  {label}: {iters:7d} slice-iters ~ {ms:5.2f} ms march"
                  f"{extra}")
    return 0


def _footprints(tm, meta, wt, wb, camera, forward, right, up, axes, fsr,
                width, height, seg_len):
    """Per-(item, slice) footprint rectangles (seg_len granularity), the
    same maths as compute_item_slice_bounds but returning the rectangles."""
    import math

    wbl = np.asarray(wb, np.int64)
    wtl = np.asarray(wt, np.int64)
    tiles_x = fsr.pad_w // tm.TILE_W
    tx = wtl % tiles_x
    ty = wtl // tiles_x
    px = np.stack([tx * tm.TILE_W + 0.5, tx * tm.TILE_W + tm.TILE_W - 0.5], -1)
    py = np.stack([ty * tm.TILE_H + 0.5, ty * tm.TILE_H + tm.TILE_H - 0.5], -1)
    tan_half = math.tan(math.radians(camera.fov_y_degrees) * 0.5)
    aspect = width / max(height, 1)
    plane_x = (px * (2.0 / width) - 1.0) * tan_half * aspect
    plane_y = (py * (2.0 / height) - 1.0) * tan_half
    cx = plane_x[:, [0, 0, 1, 1]]
    cy = plane_y[:, [0, 1, 0, 1]]
    dirs = (np.asarray(forward, np.float64)[None, None, :]
            + cx[:, :, None] * np.asarray(right, np.float64)
            + cy[:, :, None] * np.asarray(up, np.float64))
    dp = dirs[:, :, list(axes)]
    eye_p = np.asarray(camera.eye, np.float64)[list(axes)]
    pmin = np.asarray(meta, np.float64)[wbl][:, 0:3]
    cell = np.asarray(meta, np.float64)[wbl][:, 6:9]
    d_a = dp[:, :, 0]
    sign_ok = (np.abs(d_a) > 1e-8).all(1) & ((d_a > 0).all(1) | (d_a < 0).all(1))
    cap = int(fsr.cube) - 2 * fsr.ghost
    n_seg = (cap + seg_len - 1) // seg_len
    ks = np.minimum(np.arange(n_seg + 1) * seg_len, cap - 1)
    z = pmin[:, 0:1] + (ks[None, :] + 0.5) * cell[:, 0:1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (z[:, None, :] - eye_p[0]) / d_a[:, :, None]
        ok = sign_ok & (t > 0).all(axis=(1, 2))
        u_pts = eye_p[1] + t * dp[:, :, 1:2]
        v_pts = eye_p[2] + t * dp[:, :, 2:3]
        cu = (u_pts - pmin[:, 1:2, None]) / cell[:, 1:2, None] + fsr.ghost
        cv = (v_pts - pmin[:, 2:3, None]) / cell[:, 2:3, None] + fsr.ghost
    margin = fsr.ghost + 2.0
    cu_min = cu.min(axis=1)
    cu_max = cu.max(axis=1)
    cv_min = cv.min(axis=1)
    cv_max = cv.max(axis=1)
    cu_lo = np.minimum(cu_min[:, :-1], cu_min[:, 1:]) - margin
    cu_hi = np.maximum(cu_max[:, :-1], cu_max[:, 1:]) + margin
    cv_lo = np.minimum(cv_min[:, :-1], cv_min[:, 1:]) - margin
    cv_hi = np.maximum(cv_max[:, :-1], cv_max[:, 1:]) + margin
    # expand segment rectangles to per-slice rectangles
    seg_of = np.minimum(np.arange(cap) // seg_len, n_seg - 1)
    return (cu_lo[:, seg_of], cu_hi[:, seg_of], cv_lo[:, seg_of],
            cv_hi[:, seg_of], ok)


def _bounds_with_seg(tm, meta, brick_bounds, wt, wb, camera, forward, right,
                     up, axes, fsr, width, height, occ_bits, seg_len):
    """compute_item_slice_bounds with a custom segment length (the shipped
    function hardcodes 4): footprint rectangles -> block bitmask -> AND."""
    cu_lo, cu_hi, cv_lo, cv_hi, ok = _footprints(
        tm, meta, wt, wb, camera, forward, right, up, axes, fsr, width,
        height, seg_len
    )
    wbl = np.asarray(wb, np.int64)
    nq = fsr._quad_blocks
    su = float(fsr._quad_split)
    qrange = np.arange(nq)
    eu_lo = (su * qrange)[None, None, :]
    eu_hi = eu_lo + su
    qu = (cu_lo[..., None] < eu_hi) & (cu_hi[..., None] > eu_lo)
    qv = (cv_lo[..., None] < eu_hi) & (cv_hi[..., None] > eu_lo)
    shift_u = (np.arange(nq, dtype=np.uint64) * np.uint64(nq))
    fu = (qu.astype(np.uint64) << shift_u).sum(axis=2, dtype=np.uint64)
    fv = (qv.astype(np.uint64) << np.arange(nq, dtype=np.uint64)).sum(
        axis=2, dtype=np.uint64)
    fmask = fu * fv
    sel = (fmask & occ_bits[wbl]) != 0
    bb = np.asarray(brick_bounds, np.int64)[wbl]
    blo, bhi = bb >> 16, bb & 0xFFFF
    cap = sel.shape[1]
    s_idx = np.arange(cap)[None, :]
    sel &= (s_idx >= blo[:, None]) & (s_idx < bhi[:, None])
    any_occ = sel.any(1)
    lo = np.argmax(sel, 1)
    hi = cap - np.argmax(sel[:, ::-1], 1)
    packed = np.where(any_occ, (lo << 16) | hi, (bhi << 16) | bhi)
    out = np.where(ok & (bhi > blo), packed, bb).astype(np.int32)
    fwd = (np.asarray(camera.eye) is not None)  # placeholder; recompute below
    # march direction per item (needed by expand_bands): reuse footprint dirs
    # — approximate with the brick-level sign of the axis direction
    import math as _m
    fvec = np.asarray(forward, np.float64)[list(axes)]
    fwd = np.full(len(wbl), fvec[0] > 0, bool)
    return out, sel, ok, fwd


def _ray_exact(fsr, camera, occ_cell, meta, axes, wt, wb, blo, bhi,
               width, height):
    """Absolute ideal: per-ray sample-level occupancy.  For each work item,
    cast the tile's 8x128 rays, test the NEAREST-sample cell's alpha at
    every slice in the brick range, and count slices where ANY ray in the
    tile hits an occupied cell (the kernel marches whole tiles, so the
    per-tile OR is the right unit), padded by 1 slice each side."""
    import math

    from amrvolumerenderer_tpu.camera import camera_basis
    from amrvolumerenderer_tpu.ops import tilemarch as tm

    forward, right, up = camera_basis(camera)
    L, S, U, V = occ_cell.shape
    tiles_x = fsr.pad_w // tm.TILE_W
    tan_half = math.tan(math.radians(camera.fov_y_degrees) * 0.5)
    aspect = width / max(height, 1)
    eye_p = np.asarray(camera.eye, np.float64)[list(axes)]
    fvec = np.asarray(forward, np.float64)[list(axes)]
    rvec = np.asarray(right, np.float64)[list(axes)]
    uvec = np.asarray(up, np.float64)[list(axes)]
    total = 0
    mn = np.asarray(meta, np.float64)
    for i in range(len(wb)):
        b = int(wb[i])
        t_id = int(wt[i])
        tx, ty = t_id % tiles_x, t_id // tiles_x
        pxs = tx * tm.TILE_W + np.arange(tm.TILE_W) + 0.5
        pys = ty * tm.TILE_H + np.arange(tm.TILE_H) + 0.5
        plane_x = (pxs * (2.0 / width) - 1.0) * tan_half * aspect
        plane_y = (pys * (2.0 / height) - 1.0) * tan_half
        d = (fvec[None, None]
             + plane_x[None, :, None] * rvec
             + plane_y[:, None, None] * uvec)  # [H, W, 3]
        d_a = d[..., 0]
        if np.any(np.abs(d_a) < 1e-12):
            total += int(bhi[i] - blo[i])
            continue
        pmin = mn[b, 0:3]
        cell = mn[b, 6:9]
        ks = np.arange(int(blo[i]), int(bhi[i]))
        if not len(ks):
            continue
        z = pmin[0] + (ks + 0.5) * cell[0]
        t = (z[:, None, None] - eye_p[0]) / d_a[None]  # [S', H, W]
        pu = eye_p[1] + t * d[None, ..., 1]
        pv = eye_p[2] + t * d[None, ..., 2]
        iu = np.floor((pu - pmin[1]) / cell[1]).astype(np.int64)
        iv = np.floor((pv - pmin[2]) / cell[2]).astype(np.int64)
        inside = (t > 0) & (iu >= 0) & (iu < U) & (iv >= 0) & (iv < V)
        iu = np.clip(iu, 0, U - 1)
        iv = np.clip(iv, 0, V - 1)
        hit = inside & occ_cell[b][ks[:, None, None], iu, iv]
        occ_s = hit.any(axis=(1, 2))
        # 1-slice pad each side (window quadrature touches neighbors)
        occ_pad = occ_s.copy()
        occ_pad[:-1] |= occ_s[1:]
        occ_pad[1:] |= occ_s[:-1]
        total += int(occ_pad.sum())
    return total


if __name__ == "__main__":
    sys.exit(main())
