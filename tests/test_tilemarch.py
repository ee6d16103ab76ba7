"""The tile loop vs the layered slice-march + composite path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amrvolumerenderer_tpu import api
from amrvolumerenderer_tpu.camera import (
    auto_orbit_camera,
    camera_basis,
    compute_box_depth_hint,
)
from amrvolumerenderer_tpu.colormap import build_color_table
from amrvolumerenderer_tpu.compositor import composite_layers_host
from amrvolumerenderer_tpu.ops import slicemarch as sm
from amrvolumerenderer_tpu.ops import tilemarch as tm
from amrvolumerenderer_tpu.renderer import (
    compute_global_bounds,
    compute_reference_sample_distance,
)
from amrvolumerenderer_tpu.renderer_fast import _pretransform


def build_scene_arrays(r2_scene, width, height):
    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    g = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    bounds = compute_global_bounds(g)
    camera = auto_orbit_camera(bounds)
    forward, right, up = camera_basis(camera)
    axis = sm.choose_march_axis(forward)
    axes = [axis] + [a for a in range(3) if a != axis]
    ref = compute_reference_sample_distance(g, bounds)
    t = g.scalar_transform

    lut = build_color_table(1.0, 1.0, g.scalar_range, None)
    packed = sm.build_log_lut(lut)
    num = len(g.bricks)
    vol = np.zeros((num, 16, sm.SUBLANES, sm.LANES), np.float32)
    meta = np.zeros((num, 12), np.float32)
    dims = np.zeros((num, 8), np.int32)
    hints = np.zeros(num, np.float32)
    bmins, bmaxs = [], []
    for i, b in enumerate(g.bricks):
        pt = _pretransform(b.data, t, 1.0, False)
        v, (ns, nu, nv) = sm.pack_slice_volume(pt, axis)
        vol[i, :ns] = v
        pmin = np.asarray(b.min_corner)[axes]
        pmax = np.asarray(b.max_corner)[axes]
        meta[i, 0:3], meta[i, 3:6] = pmin, pmax
        meta[i, 6:9] = (pmax - pmin) / np.array([ns, nu, nv])
        dims[i, :3] = (ns, nu, nv)
        dims[i, 3:6] = axes
        hints[i] = compute_box_depth_hint(b.min_corner, b.max_corner, camera)
        bmins.append(b.min_corner)
        bmaxs.append(b.max_corner)
    cam = sm.pack_camera(
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        width / height, 0.0, 1.0, ref,
    )
    owners = np.arange(num, dtype=np.int32)
    return dict(
        vol=vol, meta=meta, dims=dims, lut=packed, cam=cam, hints=hints,
        owners=owners, box_min=np.stack(bmins), box_max=np.stack(bmaxs),
        camera=camera, forward=forward, right=right, up=up,
    )


def test_tilemarch_matches_layered_path(r2_scene):
    width = height = 64
    s = build_scene_arrays(r2_scene, width, height)
    num = len(s["owners"])

    offsets, tbricks, towners = tm.build_tile_worklist(
        s["box_min"], s["box_max"], s["hints"], s["owners"],
        np.asarray(s["camera"].eye), s["forward"], s["right"], s["up"],
        s["camera"].fov_y_degrees, width, height,
    )
    out_c, out_d = tm.tilemarch_render(
        jnp.asarray(s["vol"]), jnp.asarray(s["meta"]), jnp.asarray(s["dims"]),
        jnp.asarray(s["lut"]), jnp.asarray(s["cam"]),
        jnp.asarray(offsets), jnp.asarray(tbricks), jnp.asarray(towners),
        width=width, height=height, max_slices=16,
    )
    # untile to row-major
    tiles_x = width // tm.TILE_W
    tiles_y = height // tm.TILE_H
    got_c = (
        np.asarray(out_c)
        .reshape(tiles_y, tiles_x, 4, tm.TILE_H, tm.TILE_W)
        .transpose(0, 3, 1, 4, 2)
        .reshape(width * height, 4)
    )
    got_d = (
        np.asarray(out_d)
        .reshape(tiles_y, tiles_x, tm.TILE_H, tm.TILE_W)
        .transpose(0, 2, 1, 3)
        .reshape(width * height)
    )

    # oracle: layered render + host composite
    luts = np.ascontiguousarray(
        np.broadcast_to(s["lut"][None], (num,) + s["lut"].shape)
    )
    colors, depths = sm.slicemarch_render(
        jnp.asarray(s["vol"]), jnp.asarray(s["meta"]), jnp.asarray(s["dims"]),
        jnp.asarray(luts), jnp.asarray(s["cam"]),
        width=width, height=height, max_slices=16,
    )
    layers = np.concatenate(
        [np.asarray(colors), np.asarray(depths)[..., None]], axis=-1
    )
    expected = composite_layers_host(
        layers, s["hints"], s["owners"], np.zeros(num, np.int32)
    )

    np.testing.assert_allclose(got_c, expected[:, :4], atol=2e-5)
    finite = np.isfinite(expected[:, 4])
    np.testing.assert_array_equal(np.isfinite(got_d), finite)
    np.testing.assert_allclose(got_d[finite], expected[finite, 4], atol=1e-4)


def test_build_tile_worklist_csr():
    box_min = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    box_max = np.array([[0.5, 0.5, 0.5], [1.0, 1.0, 1.0]])
    hints = np.array([2.0, 1.0], np.float32)
    owners = np.array([0, 1], np.int32)
    eye = np.array([0.5, 0.5, 4.0])
    forward = np.array([0.0, 0.0, -1.0])
    right = np.array([1.0, 0.0, 0.0])
    up = np.array([0.0, 1.0, 0.0])
    offsets, bricks, wowners = tm.build_tile_worklist(
        box_min, box_max, hints, owners, eye, forward, right, up, 45.0,
        128, 128,
    )
    assert offsets.shape == (17,)
    assert offsets[-1] == len(bricks)
    # within any tile containing both bricks, brick 1 (smaller hint) first
    for t in range(16):
        lo, hi = offsets[t], offsets[t + 1]
        tile_bricks = list(bricks[lo:hi])
        if len(tile_bricks) == 2:
            assert tile_bricks == [1, 0]
    assert np.all(wowners == owners[bricks])


def test_full_pipeline_tilemarch_matches_slicemarch(r2_scene):
    """render_scene(method='tilemarch') must match method='slicemarch'."""
    from amrvolumerenderer_tpu.renderer import render_scene
    from amrvolumerenderer_tpu.types import RenderParameters

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    params = RenderParameters(width=48, height=48)
    img_slice, _ = render_scene("", params, geometry, verbose=False,
                                method="slicemarch")
    img_tile, _ = render_scene("", params, geometry, verbose=False,
                               method="tilemarch")
    np.testing.assert_allclose(
        img_tile.pixels[:, :4], img_slice.pixels[:, :4], atol=2e-5
    )


def test_many_piece_scene_routes_to_tilemarch(tile_threshold_96):
    """A scene above the piece threshold renders through the tile-loop
    route and matches the explicit tilemarch method."""
    from amrvolumerenderer_tpu.renderer import render_scene
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry
    from amrvolumerenderer_tpu.types import RenderParameters

    rng = np.random.default_rng(2)
    n, box = 40, 8  # 125 bricks
    field = rng.random((n, n, n))
    boxes = []
    for i0 in range(0, n, box):
        for j0 in range(0, n, box):
            for k0 in range(0, n, box):
                boxes.append(
                    LevelBox(field[i0:i0+box, j0:j0+box, k0:k0+box],
                             np.array([i0, j0, k0]))
                )
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]
    data = api.AmrData(level_data=[boxes], level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    assert len(geometry.bricks) == 125

    params = RenderParameters(width=32, height=32)
    img_auto, _ = render_scene("", params, geometry, verbose=False,
                               method="slicemarch")
    img_tile, _ = render_scene("", params, geometry, verbose=False,
                               method="tilemarch")
    np.testing.assert_allclose(
        img_auto.pixels[:, :4], img_tile.pixels[:, :4], atol=2e-5
    )


class TestItemSliceBounds:
    """Per-(tile, brick) occupied-slice bounds
    (tm.compute_item_slice_bounds): must be exact (pixel parity with
    per-brick bounds) and actually tighter on sparse scenes."""

    def _shell_renderer(self):
        from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
        from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry
        from amrvolumerenderer_tpu.types import RenderParameters

        n = 64
        c = (np.arange(n) + 0.5) / n
        r = np.sqrt(
            (c[:, None, None] - 0.5) ** 2
            + (c[None, :, None] - 0.5) ** 2
            + (c[None, None, :] - 0.5) ** 2
        )
        f = np.exp(-((r - 0.40) / 0.015) ** 2)
        boxes = [
            LevelBox(f[i:i + 32, j:j + 32, k:k + 32],
                     np.array([i, j, k], dtype=int))
            for i in range(0, n, 32)
            for j in range(0, n, 32)
            for k in range(0, n, 32)
        ]
        geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]
        data = api.AmrData(level_data=boxes and [boxes], level_geometry=geoms)
        g = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
        return FastSceneRenderer(
            g, RenderParameters(width=64, height=64)
        )

    def _cams(self, fsr):
        from amrvolumerenderer_tpu.types import CameraParameters

        eyes = [
            (0.5, 0.6, 3.2),       # axis 2, frontal
            (3.1, 0.5, 0.4),       # axis 0
            (-1.9, 2.3, -1.2),     # oblique, negative components
            (0.52, 3.0, 0.55),     # axis 1, nearly top-down
            (0.4, 0.45, 0.5),      # eye INSIDE the domain
        ]
        return [
            CameraParameters(eye=e, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0))
            for e in eyes
        ]

    def test_pixel_parity_with_brick_bounds(self):
        """Tightened per-item bounds never change pixels (beyond the FP
        combination-order jitter of re-grouped unrolled slices)."""
        fsr = self._shell_renderer()
        for cam in self._cams(fsr):
            inputs = fsr.frame_inputs(cam)
            if inputs is None:
                continue
            kw = dict(
                width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
                logical_width=fsr.render_width,
                logical_height=fsr.render_height,
            )
            tight_c, tight_d = tm.tilemarch_render(
                fsr._packed_vol, inputs["meta"], inputs["dims"],
                fsr._lut_device, inputs["cam"], inputs["offsets"],
                inputs["bricks"], inputs["owners"], inputs["item_bounds"],
                **kw,
            )
            full_c, full_d = tm.tilemarch_render(
                fsr._packed_vol, inputs["meta"], inputs["dims"],
                fsr._lut_device, inputs["cam"], inputs["offsets"],
                inputs["bricks"], inputs["owners"], None,
                **kw,
            )
            np.testing.assert_allclose(
                np.asarray(tight_c), np.asarray(full_c), atol=2e-6
            )
            np.testing.assert_allclose(
                np.asarray(tight_d), np.asarray(full_d), atol=2e-6
            )

    def test_bounds_are_tighter_on_shell(self):
        """At a production frame size (tiles small relative to bricks) the
        per-item ranges march meaningfully fewer slices than the per-brick
        ranges.  With the DEFAULT colormap every LUT entry has alpha > 0,
        so only the geometric cut fires (slices where the tile's rays miss
        the brick cross-section); a transfer function with a transparent
        range adds the value cut and tightens much further."""
        from amrvolumerenderer_tpu.types import (
            RenderParameters,
            color_map_from_tuples,
        )

        fsr = self._shell_renderer()
        big = type(fsr)(
            fsr.geometry, RenderParameters(width=1024, height=1024),
        )

        def ratio():
            inputs = big.frame_inputs(self._cams(big)[0], as_numpy=True)
            ib = inputs["item_bounds"].astype(np.int64)
            bb = inputs["dims"][inputs["bricks"], 7].astype(np.int64)
            tight = np.maximum((ib & 0xFFFF) - (ib >> 16), 0).sum()
            full = np.maximum((bb & 0xFFFF) - (bb >> 16), 0).sum()
            return tight / full

        geometric = ratio()  # default colormap: geometric cut only
        assert geometric < 0.95, geometric
        big.set_transfer_function(color_map=color_map_from_tuples([
            (0.0, 0, 0, 0, 0.0), (0.3, 0, 0, 0, 0.0),
            (0.5, 1, 0.5, 0.2, 0.4), (1.0, 1, 1, 1, 0.8),
        ]))
        value_cut = ratio()  # transparent range: value cut fires too
        assert value_cut < 0.6, value_cut
        assert value_cut < geometric

    def test_bounds_within_brick_bounds(self):
        """Item ranges are always sub-ranges of the brick's range."""
        fsr = self._shell_renderer()
        for cam in self._cams(fsr):
            inputs = fsr.frame_inputs(cam, as_numpy=True)
            if inputs is None:
                continue
            ib = inputs["item_bounds"].astype(np.int64)
            bb = inputs["dims"][inputs["bricks"], 7].astype(np.int64)
            assert np.all((ib >> 16) >= (bb >> 16))
            assert np.all((ib & 0xFFFF) <= (bb & 0xFFFF))
            assert np.all((ib >> 16) <= (ib & 0xFFFF))

    def test_random_field_fuzz_parity(self):
        """Random fields + random cameras: tightened bounds keep parity
        (locks the conservativeness of footprints and quadrant tests)."""
        from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
        from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry
        from amrvolumerenderer_tpu.types import (
            CameraParameters,
            RenderParameters,
        )

        rng = np.random.default_rng(23)
        n = 32
        f = (rng.random((n, n, n)) ** 3).astype(np.float64)  # mostly small
        boxes = [
            LevelBox(f[i:i + 16, j:j + 16, k:k + 16],
                     np.array([i, j, k], dtype=int))
            for i in range(0, n, 16)
            for j in range(0, n, 16)
            for k in range(0, n, 16)
        ]
        geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]
        data = api.AmrData(level_data=[boxes], level_geometry=geoms)
        g = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
        fsr = FastSceneRenderer(
            g, RenderParameters(width=32, height=32)
        )
        for _ in range(4):
            eye = tuple(rng.uniform(-2.5, 3.5, 3))
            cam = CameraParameters(
                eye=eye, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)
            )
            inputs = fsr.frame_inputs(cam)
            if inputs is None:
                continue
            kw = dict(
                width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
                logical_width=fsr.render_width,
                logical_height=fsr.render_height,
            )
            args = (
                fsr._packed_vol, inputs["meta"], inputs["dims"],
                fsr._lut_device, inputs["cam"], inputs["offsets"],
                inputs["bricks"], inputs["owners"],
            )
            tight_c, _ = tm.tilemarch_render(
                *args, inputs["item_bounds"], **kw
            )
            full_c, _ = tm.tilemarch_render(*args, None, **kw)
            np.testing.assert_allclose(
                np.asarray(tight_c), np.asarray(full_c), atol=2e-6
            )

    def test_pixel_parity_with_transparent_range_tf(self):
        """The value cut (transfer function with zero-alpha range) must
        also keep pixel parity — skipped slices contribute zero alpha."""
        from amrvolumerenderer_tpu.types import color_map_from_tuples

        fsr = self._shell_renderer()
        fsr.set_transfer_function(color_map=color_map_from_tuples([
            (0.0, 0, 0, 0, 0.0), (0.3, 0, 0, 0, 0.0),
            (0.5, 1, 0.5, 0.2, 0.4), (1.0, 1, 1, 1, 0.8),
        ]))
        for cam in self._cams(fsr)[:3]:
            inputs = fsr.frame_inputs(cam)
            if inputs is None:
                continue
            kw = dict(
                width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
                logical_width=fsr.render_width,
                logical_height=fsr.render_height,
            )
            args = (
                fsr._packed_vol, inputs["meta"], inputs["dims"],
                fsr._lut_device, inputs["cam"], inputs["offsets"],
                inputs["bricks"], inputs["owners"],
            )
            tight_c, _ = tm.tilemarch_render(*args, inputs["item_bounds"], **kw)
            full_c, _ = tm.tilemarch_render(*args, None, **kw)
            np.testing.assert_allclose(
                np.asarray(tight_c), np.asarray(full_c), atol=2e-6
            )

    def test_worklist_path_value_cut_parity(self):
        """The one-shot work-list path (prepare_slicemarch_scene) also
        carries per-item bounds + empty-item culling; with a transparent-
        range transfer function the composited frame must equal the
        untightened render."""
        from amrvolumerenderer_tpu.camera import auto_orbit_camera
        from amrvolumerenderer_tpu.renderer import compute_global_bounds
        from amrvolumerenderer_tpu.renderer_fast import (
            prepare_slicemarch_scene,
        )
        from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry
        from amrvolumerenderer_tpu.types import (
            RenderParameters,
            color_map_from_tuples,
        )

        n = 64
        c = (np.arange(n) + 0.5) / n
        r = np.sqrt(
            (c[:, None, None] - 0.5) ** 2
            + (c[None, :, None] - 0.5) ** 2
            + (c[None, None, :] - 0.5) ** 2
        )
        f = np.exp(-((r - 0.40) / 0.015) ** 2)
        boxes = [
            LevelBox(f[i:i + 32, j:j + 32, k:k + 32],
                     np.array([i, j, k], dtype=int))
            for i in range(0, n, 32)
            for j in range(0, n, 32)
            for k in range(0, n, 32)
        ]
        geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]
        data = api.AmrData(level_data=[boxes], level_geometry=geoms)
        g = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
        cmap = color_map_from_tuples([
            (0.0, 0, 0, 0, 0.0), (0.3, 0, 0, 0, 0.0),
            (0.5, 1, 0.5, 0.2, 0.4), (1.0, 1, 1, 1, 0.8),
        ])
        params = RenderParameters(width=64, height=64)
        cam = auto_orbit_camera(compute_global_bounds(g))
        prep = prepare_slicemarch_scene(
            g, params, cam, g.scalar_range, 0.5 / n, 64, 64, cmap,
        )
        # the value cut fires: some items tightened or culled
        bb = prep["dims"][prep["wb"], 7].astype(np.int64)
        ib = prep["wbounds"].astype(np.int64)
        assert (ib != bb).any()
        kw = dict(
            width=prep["pad_w"], height=prep["pad_h"],
            max_slices=prep["s_max"], logical_width=64, logical_height=64,
        )
        args = (
            jnp.asarray(prep["vol"]), jnp.asarray(prep["meta"]),
            jnp.asarray(prep["dims"]), jnp.asarray(prep["luts"]),
            jnp.asarray(prep["cam"]), jnp.asarray(prep["wb"]),
            jnp.asarray(prep["wt"]), jnp.asarray(prep["coverage"]),
        )
        tight_c, tight_d = sm.slicemarch_render_worklist(
            *args, jnp.asarray(prep["wbounds"]), **kw
        )
        full_c, full_d = sm.slicemarch_render_worklist(*args, None, **kw)
        np.testing.assert_allclose(
            np.asarray(tight_c), np.asarray(full_c), atol=2e-6
        )

    def test_pixel_parity_trilinear_and_pre(self):
        """Trilinear and pre-classified sampling use the wider footprint
        pad (footprint_margin = ghost + 1.51: the bilinear stencil touches
        floor(cu - 0.5) + {0, 1}); parity vs the untightened kernel locks
        its conservativeness for both classification modes."""
        from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
        from amrvolumerenderer_tpu.types import RenderParameters

        geometry = self._shell_renderer().geometry
        for classification in ("post", "pre"):
            fsr = FastSceneRenderer(
                geometry,
                RenderParameters(width=64, height=64, sampling="trilinear",
                                 classification=classification),
            )
            for cam in self._cams(fsr)[:3]:
                inputs = fsr.frame_inputs(cam)
                if inputs is None:
                    continue
                kw = dict(
                    width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
                    logical_width=fsr.render_width,
                    logical_height=fsr.render_height,
                    sampling="trilinear", ghost=fsr.ghost,
                    classification=classification,
                )
                args = (
                    fsr._packed_vol, inputs["meta"], inputs["dims"],
                    fsr._lut_device, inputs["cam"], inputs["offsets"],
                    inputs["bricks"], inputs["owners"],
                )
                tight_c, _ = tm.tilemarch_render(
                    *args, inputs["item_bounds"], **kw
                )
                full_c, _ = tm.tilemarch_render(*args, None, **kw)
                np.testing.assert_allclose(
                    np.asarray(tight_c), np.asarray(full_c), atol=2e-6
                )

    def test_tight_config_subsets_legacy(self):
        """Finer segments + the tight margin can only SHRINK the per-slice
        occupancy (every seg-2 segment hull is inside the covering seg-4
        hull because u(z) is linear along each corner ray, and a smaller
        pad shrinks the rectangle): the tightened masks must be subsets of
        the legacy (seg4, ghost+2) masks, never supersets."""
        from amrvolumerenderer_tpu.camera import (
            camera_basis,
            compute_box_depth_hints,
        )

        fsr = self._shell_renderer()
        cam = self._cams(fsr)[2]  # oblique
        forward, right, up = camera_basis(cam)
        axis = sm.choose_march_axis(forward)
        axes = [axis] + [a for a in range(3) if a != axis]
        num = fsr.canonical.shape[0]
        meta = np.zeros((num, 12), np.float32)
        meta[:, 0:3] = fsr.box_min[:, axes]
        meta[:, 3:6] = fsr.box_max[:, axes]
        dw = fsr.dims_world[:, axes].astype(np.float64)
        meta[:, 6:9] = (fsr.box_max[:, axes] - fsr.box_min[:, axes]) / dw
        smin, smax = fsr._slice_minmax[axis]
        brick_bounds = sm.compute_slice_bounds_batch(
            smin, smax, fsr._lut_alpha, 0.0, 1.0,
            fsr.dims_world[:, axes][:, 0].astype(np.int32),
        )
        hints = compute_box_depth_hints(fsr.box_min, fsr.box_max, cam)
        offsets, wb, _ = tm.build_tile_worklist(
            fsr.box_min, fsr.box_max, hints, fsr.owners,
            np.asarray(cam.eye), forward, right, up, cam.fov_y_degrees,
            fsr.pad_w, fsr.pad_h,
            logical_width=fsr.render_width,
            logical_height=fsr.render_height,
        )
        wt = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
        qmin, qmax = fsr._slice_quad_minmax[axis]
        occ_bits = tm.block_occupancy_bits(qmin, qmax, fsr._lut_alpha,
                                           0.0, 1.0)
        common = (meta, brick_bounds, wt, wb, np.asarray(cam.eye),
                  forward, right, up, cam.fov_y_degrees, axes,
                  fsr.pad_w, fsr.pad_h, fsr.render_width, fsr.render_height,
                  occ_bits, fsr._quad_blocks, fsr._quad_split)
        _, sel_legacy, ok_l, _ = tm.compute_item_slice_bounds(
            *common, ghost=fsr.ghost, return_mask=True,
            seg_len=4, margin=None,
        )
        _, sel_tight, ok_t, _ = tm.compute_item_slice_bounds(
            *common, ghost=fsr.ghost, return_mask=True,
            seg_len=2, margin=tm.footprint_margin(fsr.ghost, "nearest"),
        )
        np.testing.assert_array_equal(ok_l, ok_t)
        assert not np.any(sel_tight & ~sel_legacy)
        assert sel_tight.sum() < sel_legacy.sum()  # and it actually tightens

def test_compacted_grid_matches_dense(r2_scene):
    """Active-tile compacted grid (tile_ids + scatter) must reproduce the
    dense grid pixel-for-pixel, with padding sentinel steps dropped."""
    width = height = 64
    s = build_scene_arrays(r2_scene, width, height)

    offsets, tbricks, towners = tm.build_tile_worklist(
        s["box_min"], s["box_max"], s["hints"], s["owners"],
        np.asarray(s["camera"].eye), s["forward"], s["right"], s["up"],
        s["camera"].fov_y_degrees, width, height,
    )
    args = (
        jnp.asarray(s["vol"]), jnp.asarray(s["meta"]), jnp.asarray(s["dims"]),
        jnp.asarray(s["lut"]), jnp.asarray(s["cam"]),
    )
    dense_c, dense_d = tm.tilemarch_render(
        *args, jnp.asarray(offsets), jnp.asarray(tbricks),
        jnp.asarray(towners),
        width=width, height=height, max_slices=16,
    )

    # compact: covered tiles only + 2 sentinel padding steps
    counts = np.diff(offsets)
    covered = np.flatnonzero(counts > 0).astype(np.int32)
    num_tiles = len(counts)
    assert 0 < len(covered)  # premise: compaction engages
    c_off = np.zeros(len(covered) + 3, np.int32)
    c_off[1 : len(covered) + 1] = np.cumsum(counts[covered])
    c_off[len(covered) + 1 :] = c_off[len(covered)]
    tids = np.concatenate(
        [covered, np.full(2, num_tiles, np.int32)]  # OOB sentinels
    )
    comp_c, comp_d = tm.tilemarch_render(
        *args, jnp.asarray(c_off), jnp.asarray(tbricks),
        jnp.asarray(towners), None, jnp.asarray(tids),
        width=width, height=height, max_slices=16,
    )
    full_c, full_d = tm.scatter_tiles(comp_c, comp_d, jnp.asarray(tids),
                                      num_tiles)
    # uncovered tiles: dense grid computed them as background
    np.testing.assert_allclose(
        np.asarray(full_c), np.asarray(dense_c), atol=1e-6
    )
    dd, fd = np.asarray(dense_d), np.asarray(full_d)
    np.testing.assert_array_equal(np.isfinite(fd), np.isfinite(dd))
    np.testing.assert_allclose(
        fd[np.isfinite(fd)], dd[np.isfinite(dd)], atol=1e-6
    )


def test_band_split_shell_pixel_parity(monkeypatch):
    """Two-band chord splitting (entry/exit of a hollow shell) must engage
    and keep pixels identical to the unsplit march."""
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.camera import auto_orbit_camera
    from amrvolumerenderer_tpu.types import (
        Brick,
        RenderParameters,
        ScalarTransform,
        SceneGeometry,
        color_map_from_tuples,
    )

    # two full-plane slabs with an empty middle: every covering tile's
    # chord has an entry band, a >= min_gap hole, and an exit band — the
    # split must engage regardless of the block-occupancy granularity
    # (a thin curved shell stops triggering at 8x8 blocks: the tighter
    # footprints legitimately cull the would-be-split items instead)
    n = 32
    slabs = np.zeros((n, n, n), np.float32)
    slabs[4:9] = 1.0
    slabs[23:28] = 1.0
    geometry = SceneGeometry(
        bricks=[Brick(slabs, (0, 0, 0), (1, 1, 1), owner=0)],
        scalar_range=(0.0, 1.0), has_scalar_range=True,
        scalar_transform=ScalarTransform(),
    )
    cmap = color_map_from_tuples([
        (0.0, 0, 0, 0, 0.0), (0.3, 0, 0, 0, 0.0),
        (0.5, 1.0, 0.5, 0.2, 0.4), (1.0, 1.0, 1.0, 1.0, 0.8),
    ])
    params = RenderParameters(width=256, height=256)

    frames = {}
    counts = {}
    for mode in ("split", "unsplit"):
        if mode == "unsplit":
            def merge_bands(wt, wb, ow, b1, b2, fwd):
                # re-fuse the two bands into the original [lo, hi) range
                b1 = np.asarray(b1, np.int64)
                b2 = np.asarray(b2, np.int64)
                full = np.where(
                    b2 != 0, (b1 & ~0xFFFF) | (b2 & 0xFFFF), b1
                ).astype(np.int32)
                return np.asarray(wt), np.asarray(wb), np.asarray(ow), full

            monkeypatch.setattr(tm, "expand_bands", merge_bands)
        fsr = FastSceneRenderer(geometry, params, color_map=cmap)
        # camera along the slab normal (+x) so the march axis slices
        # PARALLEL to the slabs and every chord sees the empty middle
        from amrvolumerenderer_tpu.types import CameraParameters

        cam = CameraParameters(
            eye=(3.5, 0.62, 0.55), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
            fov_y_degrees=45.0, near_plane=0.1, far_plane=20.0,
        )
        inputs = fsr.frame_inputs(cam, as_numpy=True)
        counts[mode] = len(inputs["bricks"])
        frames[mode] = fsr.render(cam, overlay=False)
        monkeypatch.undo()

    assert counts["split"] > counts["unsplit"]  # bands actually emitted
    np.testing.assert_allclose(
        frames["split"], frames["unsplit"], atol=1e-6
    )


def test_native_item_bands_matches_numpy(monkeypatch):
    """The native C++ fast path (native.item_bands / avr_item_bands) must
    reproduce the NumPy oracle (compute_item_slice_bounds +
    find_second_bands) BIT-EXACTLY on real frames: the bounds are a
    conservativeness contract (CLAUDE.md), so any divergence is a bug in
    whichever side diverges."""
    import amrvolumerenderer_tpu.native as native
    from amrvolumerenderer_tpu.camera import auto_orbit_camera
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry
    from amrvolumerenderer_tpu.types import (
        CameraParameters,
        RenderParameters,
        color_map_from_tuples,
    )

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "avr_item_bands"):
        pytest.skip("native library unavailable")

    n = 64
    c = (np.arange(n) + 0.5) / n
    r = np.sqrt(
        (c[:, None, None] - 0.5) ** 2
        + (c[None, :, None] - 0.5) ** 2
        + (c[None, None, :] - 0.5) ** 2
    )
    f = np.exp(-((r - 0.40) / 0.02) ** 2)
    boxes = [
        LevelBox(f[i:i + 32, j:j + 32, k:k + 32], np.array([i, j, k], int))
        for i in range(0, n, 32)
        for j in range(0, n, 32)
        for k in range(0, n, 32)
    ]
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]
    data = api.AmrData(level_data=[boxes], level_geometry=geoms)
    g = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    cmap = color_map_from_tuples([
        (0.0, 0, 0, 0, 0.0), (0.3, 0, 0, 0, 0.0),
        (0.5, 1.0, 0.5, 0.2, 0.4), (1.0, 1.0, 1.0, 1.0, 0.8),
    ])

    recorded = []
    orig = tm.compute_item_bands

    def record(*a, **k):
        recorded.append((a, dict(k)))
        return orig(*a, **k)

    monkeypatch.setattr(tm, "compute_item_bands", record)
    cams = [
        CameraParameters(eye=e, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0))
        for e in [
            (0.5, 0.6, 3.2), (3.1, 0.5, 0.4), (-1.9, 2.3, -1.2),
            (0.4, 0.45, 0.5),  # eye inside the domain
        ]
    ]
    # nearest (ghost=0) and trilinear (ghost=1) scenes, value cut active
    for sampling in ("nearest", "trilinear"):
        fsr = FastSceneRenderer(
            g, RenderParameters(width=128, height=128, sampling=sampling),
            color_map=cmap,
        )
        for cam in cams + [auto_orbit_camera(fsr.bounds)]:
            fsr.frame_inputs(cam)
    monkeypatch.setattr(tm, "compute_item_bands", orig)
    assert len(recorded) >= 8

    saved = native.item_bands
    for a, k in recorded:
        got = orig(*a, **k)  # native path (lib is available)
        native.item_bands = lambda *x, **y: None
        try:
            want = orig(*a, **k)  # forced NumPy oracle
        finally:
            native.item_bands = saved
        for name, g_arr, w_arr in zip(
            ("band1", "band2", "forward"), got, want
        ):
            np.testing.assert_array_equal(
                np.asarray(g_arr), np.asarray(w_arr), err_msg=name
            )

    # mixed scalar/array split strides: a scalar ``split`` with a
    # per-brick ``split_v`` array must broadcast, not silently apply
    # sv[0] to every brick (non-conservative bounds)
    names = [
        "meta", "brick_bounds", "wt", "wb", "eye", "forward", "right",
        "up", "fov_y_degrees", "axes", "width", "height",
        "logical_width", "logical_height", "occ_bits", "nq", "split",
        "split_v", "ghost", "min_gap",
    ]
    a, k = recorded[0]
    call = dict(zip(names, a))
    call.update(k)
    call.pop("height", None)  # native.item_bands derives rays without it
    nb = len(np.asarray(call["meta"]))
    sv = np.full(nb, 8.0)
    sv[::2] = 16.0  # varies per brick: sv[0] alone would be wrong
    call["split_v"] = sv
    call["split"] = np.full(nb, 8.0)
    all_array = native.item_bands(**call)
    call["split"] = 8.0
    mixed = native.item_bands(**call)
    assert all_array is not None and mixed is not None
    for name, g_arr, w_arr in zip(
        ("band1", "band2", "forward"), mixed, all_array
    ):
        np.testing.assert_array_equal(
            np.asarray(g_arr), np.asarray(w_arr), err_msg=name
        )
