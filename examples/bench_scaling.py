#!/usr/bin/env python3
"""Scaling benchmark: many-brick deep-AMR scene through the mega-kernel.

Renders a turbulence-like scene split into hundreds of bricks at 1024^2
through the tile-loop mega-kernel (ops/tilemarch.py), the path whose HBM
use is independent of brick count (BASELINE.md config 5 territory).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--domain", type=int, default=128,
                        help="cells per axis (bricks = (domain/32)^3)")
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--frames", type=int, default=5)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from amrvolumerenderer_tpu.camera import (
        auto_orbit_camera,
        camera_basis,
        compute_box_depth_hint,
    )
    from amrvolumerenderer_tpu.colormap import build_color_table
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.ops import tilemarch as tm
    from amrvolumerenderer_tpu.types import VolumeBounds

    n, box = args.domain, 32
    width, height = args.width, args.height

    # synthetic multi-scale "turbulence": sum of sinusoids
    coords = np.arange(n) / n
    x = coords[:, None, None]
    y = coords[None, :, None]
    z = coords[None, None, :]
    field = (
        0.5
        + 0.25 * np.sin(2 * np.pi * 3 * x) * np.cos(2 * np.pi * 5 * y)
        + 0.15 * np.sin(2 * np.pi * 9 * z + 1.0)
        + 0.10 * np.sin(2 * np.pi * 17 * (x + y + z))
    ).astype(np.float32)
    field = np.clip(field, 0.0, 1.0)

    camera = auto_orbit_camera(VolumeBounds((-0.05,) * 3, (1.05,) * 3))
    forward, right, up = camera_basis(camera)
    axis = sm.choose_march_axis(forward)
    axes = [axis] + [a for a in range(3) if a != axis]

    vols, metas, dims_l, hints, bmins, bmaxs = [], [], [], [], [], []
    for i0 in range(0, n, box):
        for j0 in range(0, n, box):
            for k0 in range(0, n, box):
                d = field[i0:i0 + box, j0:j0 + box, k0:k0 + box]
                mn = np.array([i0, j0, k0]) / n
                mx = np.array([i0 + box, j0 + box, k0 + box]) / n
                vol, (ns, nu, nv) = sm.pack_slice_volume(d, axis)
                pmin, pmax = mn[axes], mx[axes]
                m = np.zeros(12, np.float32)
                m[0:3], m[3:6] = pmin, pmax
                m[6:9] = (pmax - pmin) / np.array([ns, nu, nv])
                dd = np.zeros(8, np.int32)
                dd[:3] = (ns, nu, nv)
                dd[3:6] = axes
                vols.append(vol)
                metas.append(m)
                dims_l.append(dd)
                hints.append(compute_box_depth_hint(mn, mx, camera))
                bmins.append(mn)
                bmaxs.append(mx)

    vol = np.stack(vols)
    meta = np.stack(metas)
    dims = np.stack(dims_l)
    num_bricks = vol.shape[0]
    hints = np.asarray(hints, np.float32)
    owners = np.arange(num_bricks, dtype=np.int32)

    lut = sm.build_log_lut(build_color_table(1.0, 1.0, (0.0, 1.0), None))
    cam = sm.pack_camera(
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        width / height, 0.0, 1.0, 0.5 / n,
    )
    offsets, tbricks, towners = tm.build_tile_worklist(
        np.stack(bmins), np.stack(bmaxs), hints, owners,
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        width, height,
    )
    print(
        f"{num_bricks} bricks, {len(tbricks)} tile-work items "
        f"(avg {len(tbricks) / (width * height / 1024):.1f} bricks/tile)"
    )

    a = (
        jnp.asarray(vol), jnp.asarray(meta), jnp.asarray(dims),
        jnp.asarray(lut), jnp.asarray(cam), jnp.asarray(offsets),
        jnp.asarray(tbricks), jnp.asarray(towners),
    )

    # two-K slope with an anti-hoist perturbation: XLA hoists a
    # loop-invariant fori_loop body (it would time ONE frame + dispatch);
    # varying the unused camera slot 19 per iteration defeats that without
    # changing any pixel, and differencing two loop lengths cancels the
    # dispatch intercept.  CANONICAL implementation:
    # bench.measure_device_frame / scripts/measure_scaling.py — keep this
    # standalone copy in sync with any methodology fix there.
    def loop_time(k):
        @jax.jit
        def frames(vol_, meta_, dims_, lut_, cam_, offs_, brs_, ows_):
            def body(i, acc):
                cam_i = cam_.at[19].set(i.astype(jnp.float32))
                c, _d = tm.tilemarch_render(
                    vol_, meta_, dims_, lut_, cam_i, offs_, brs_, ows_,
                    width=width, height=height, max_slices=32,
                )
                return acc + jnp.sum(c[::8])

            return jax.lax.fori_loop(0, k, body, jnp.float32(0.0))

        checksum = float(frames(*a))
        assert np.isfinite(checksum) and checksum > 0.0
        print(f"checksum (K={k}):", checksum)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(frames(*a))
            times.append(time.perf_counter() - t0)
        return min(times) * 1e3

    k1, k2 = max(1, args.frames // 5), args.frames
    if k2 <= k1:
        k2 = k1 + 1
    ms = (loop_time(k2) - loop_time(k1)) / (k2 - k1)
    print(f"{ms:.2f} ms/frame at {width}x{height} with {num_bricks} bricks")


if __name__ == "__main__":
    main()
