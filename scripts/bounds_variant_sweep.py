#!/usr/bin/env python3
"""Sweep the per-item bounds variants host-side (deterministic, no GPU).

For (seg_len, margin) combos, report marched slice-iterations under:
  * range+2-band collapse (what the kernel marches today), and
  * per-slice MASK marching (kernel marches exactly the set bits — exact:
    a zero-alpha slice's sample contributes 0 to the integral).

margin notes: the shipped footprint pad is ghost+2 cells.  For nearest
sampling the kernel's cell index is floor((pos - pmin)/cell) clamped, so
a +1 pad on the continuous footprint hull already covers the floor; for
trilinear the stencil reaches one more cell (ghost).  The sweep includes
the aggressive value to show the ceiling, whether or not we ship it.
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(name):
    """The bench scene ``name`` ("shell_tf" or the 3-level scene) at
    1024^2."""
    from bench import build_shell_scene, build_three_level_scene
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.types import (
        RenderParameters,
        color_map_from_tuples,
    )

    params = RenderParameters(width=1024, height=1024)
    if name != "shell_tf":
        return FastSceneRenderer(build_three_level_scene(), params)
    fsr = FastSceneRenderer(build_shell_scene(), params)
    fsr.set_transfer_function(color_map=color_map_from_tuples([
        (0.0, 0, 0, 0, 0.0), (0.3, 0, 0, 0, 0.0),
        (0.5, 1.0, 0.5, 0.2, 0.4), (1.0, 1.0, 1.0, 1.0, 0.8),
    ]))
    return fsr


def run(scene):
    from amrvolumerenderer_tpu.camera import auto_orbit_camera, camera_basis
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.ops import tilemarch as tm

    fsr = build(scene)
    camera = auto_orbit_camera(fsr.bounds)
    width = height = 1024
    forward, right, up = camera_basis(camera)
    axis = sm.choose_march_axis(forward)
    axes = [axis] + [a for a in range(3) if a != axis]
    num = fsr.canonical.shape[0]
    meta = np.zeros((num, 12), np.float64)
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
    offsets, tbricks, _ = tm.build_tile_worklist(
        fsr.box_min, fsr.box_max, hints, fsr.owners,
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        fsr.pad_w, fsr.pad_h, logical_width=width, logical_height=height,
    )
    keep = fsr.visible[tbricks]
    wt = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))[keep]
    wb = tbricks[keep].astype(np.int64)
    qmin, qmax = fsr._slice_quad_minmax[axis]
    occ_bits = tm.block_occupancy_bits(
        qmin, qmax, fsr._lut_alpha, range_min, inv_range
    )

    tiles_x = fsr.pad_w // tm.TILE_W
    tx = wt % tiles_x
    ty = wt // tiles_x
    px = np.stack([tx * tm.TILE_W + 0.5, tx * tm.TILE_W + tm.TILE_W - 0.5], -1)
    py = np.stack([ty * tm.TILE_H + 0.5, ty * tm.TILE_H + tm.TILE_H - 0.5], -1)
    tan_half = math.tan(math.radians(camera.fov_y_degrees) * 0.5)
    aspect = width / height
    plane_x = (px * (2.0 / width) - 1.0) * tan_half * aspect
    plane_y = (py * (2.0 / height) - 1.0) * tan_half
    cx = plane_x[:, [0, 0, 1, 1]]
    cy = plane_y[:, [0, 1, 0, 1]]
    dirs = (np.asarray(forward, np.float64)[None, None]
            + cx[:, :, None] * np.asarray(right, np.float64)
            + cy[:, :, None] * np.asarray(up, np.float64))
    dp = dirs[:, :, list(axes)]
    eye_p = np.asarray(camera.eye, np.float64)[list(axes)]
    pminw = meta[wb, 0:3]
    cellw = meta[wb, 6:9]
    d_a = dp[:, :, 0]
    sign_ok = (np.abs(d_a) > 1e-8).all(1) & ((d_a > 0).all(1) | (d_a < 0).all(1))
    cap = occ_bits.shape[1]
    nq = fsr._quad_blocks
    su = float(fsr._quad_split)
    bb = brick_bounds.astype(np.int64)[wb]
    blo, bhi = bb >> 16, bb & 0xFFFF
    s_idx = np.arange(cap)[None]

    def variant(seg_len, margin):
        n_seg = (cap + seg_len - 1) // seg_len
        ks = np.minimum(np.arange(n_seg + 1) * seg_len, cap - 1)
        z = pminw[:, 0:1] + (ks[None] + 0.5) * cellw[:, 0:1]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (z[:, None, :] - eye_p[0]) / d_a[:, :, None]
            ok = sign_ok & (t > 0).all(axis=(1, 2))
            u_pts = eye_p[1] + t * dp[:, :, 1:2]
            v_pts = eye_p[2] + t * dp[:, :, 2:3]
            cu = (u_pts - pminw[:, 1:2, None]) / cellw[:, 1:2, None] + fsr.ghost
            cv = (v_pts - pminw[:, 2:3, None]) / cellw[:, 2:3, None] + fsr.ghost
        cu_lo = np.minimum(cu.min(1)[:, :-1], cu.min(1)[:, 1:]) - margin
        cu_hi = np.maximum(cu.max(1)[:, :-1], cu.max(1)[:, 1:]) + margin
        cv_lo = np.minimum(cv.min(1)[:, :-1], cv.min(1)[:, 1:]) - margin
        cv_hi = np.maximum(cv.max(1)[:, :-1], cv.max(1)[:, 1:]) + margin
        qrange = np.arange(nq)
        eu_lo = (su * qrange)[None, None]
        eu_hi = eu_lo + su
        qu = (cu_lo[..., None] < eu_hi) & (cu_hi[..., None] > eu_lo)
        qv = (cv_lo[..., None] < eu_hi) & (cv_hi[..., None] > eu_lo)
        shift_u = np.arange(nq, dtype=np.uint64) * np.uint64(nq)
        fu = (qu.astype(np.uint64) << shift_u).sum(2, dtype=np.uint64)
        fv = (qv.astype(np.uint64) << np.arange(nq, dtype=np.uint64)).sum(
            2, dtype=np.uint64)
        seg_of = np.minimum(np.arange(cap) // seg_len, n_seg - 1)
        sel = ((fu * fv)[:, seg_of] & occ_bits[wb]) != 0
        sel &= (s_idx >= blo[:, None]) & (s_idx < bhi[:, None])
        # untrusted items fall back to brick range
        fb = (s_idx >= blo[:, None]) & (s_idx < bhi[:, None])
        eff = np.where((ok & (bhi > blo))[:, None], sel, fb)
        mask_iters = int(eff.sum())
        # range + 2 bands (shipped collapse)
        any_occ = eff.any(1)
        lo = np.argmax(eff, 1)
        hi = cap - np.argmax(eff[:, ::-1], 1)
        packed = np.where(any_occ, (lo << 16) | hi, 0)
        b1, b2 = tm.find_second_bands(eff, packed.astype(np.int32),
                                      ok, min_gap=6)
        _w, _b, _o, ib2 = tm.expand_bands(
            wt, wb, wb * 0, b1, b2, (d_a > 0).all(1))
        ib2 = ib2.astype(np.int64)
        band_iters = int(np.maximum((ib2 & 0xFFFF) - (ib2 >> 16), 0).sum())
        return band_iters, mask_iters

    print(f"[{scene}] items {len(wb)}")
    for seg in (4, 2, 1):
        for margin in (2.0, 1.01):
            t0 = time.perf_counter()
            band_iters, mask_iters = variant(seg, fsr.ghost + margin)
            ms = (time.perf_counter() - t0) * 1e3
            print(f"  seg{seg} margin ghost+{margin:4.2f}: "
                  f"bands {band_iters:6d}  mask {mask_iters:6d}"
                  f"  (host {ms:5.1f} ms)")


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    for scene in ("shell_tf", "dense_3level"):
        run(scene)
    return 0


if __name__ == "__main__":
    sys.exit(main())
