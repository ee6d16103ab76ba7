"""Coverage-compacted device exchange + ubyte transport on the product path.

The reference cuts compositing traffic with RLE sparse images on the wire
(ImageSparseColorOnly.hpp:98-199, 482-559).  XLA collectives need static
shapes, so the JAX re-design exchanges only the tile-aligned union screen
rectangle of the brick bboxes (parallel/directsend.coverage_rect) — pixels
outside it are background on every device and never cross the links — with
bit-identical pixels for float32 transport and byte-tolerance pixels for
the reference's color-ubyte axis (transport="ubyte").
"""

import numpy as np
import pytest

from amrvolumerenderer_tpu import api
from amrvolumerenderer_tpu.parallel.directsend import (
    coverage_rect,
    paste_rect,
)
from amrvolumerenderer_tpu.renderer import render_scene
from amrvolumerenderer_tpu.types import (
    Brick,
    CameraParameters,
    RenderParameters,
    ScalarTransform,
    SceneGeometry,
)


class TestCoverageRect:
    def test_sub_rect(self):
        # 4x4 tile grid (128x128 at 32px tiles), bricks covering tiles
        # (1,1) and (2,1) -> rect (32, 32, 64, 32)... x0=32, y0=32, rw=64?
        cov = np.zeros((2, 16), bool)
        cov[0, 1 * 4 + 1] = True  # tile (y=1, x=1)
        cov[1, 1 * 4 + 2] = True  # tile (y=1, x=2)
        rect = coverage_rect(cov, 128, 128, 32, 32, num_devices=8)
        assert rect == (32, 32, 64, 32)

    def test_full_coverage_returns_none(self):
        cov = np.ones((1, 16), bool)
        assert coverage_rect(cov, 128, 128, 32, 32, 8) is None

    def test_empty_coverage_degenerate_tile(self):
        cov = np.zeros((1, 16), bool)
        assert coverage_rect(cov, 128, 128, 32, 32, 8) == (0, 0, 32, 32)

    def test_indivisible_rect_falls_back(self):
        # one 32x32 tile = 1024 px, not divisible by 7 devices -> None
        cov = np.zeros((1, 16), bool)
        cov[0, 0] = True
        assert coverage_rect(cov, 128, 128, 32, 32, 7) is None

    def test_paste_rect_roundtrip(self):
        rect = (32, 0, 32, 64)
        sub = np.random.default_rng(0).random((32 * 64, 5)).astype(np.float32)
        full = paste_rect(sub, rect, 128, 96)
        img = full.reshape(96, 128, 5)
        np.testing.assert_array_equal(img[0:64, 32:64], sub.reshape(64, 32, 5))
        assert (img[:, 0:32, :4] == 0).all()
        assert np.isinf(img[:, 64:, 4]).all()


def _sparse_scene():
    """One small brick near the frame corner: the union screen rect is a
    small fraction of the frame, so the compacted exchange actually
    engages (and its payload is measurably smaller)."""
    shape = (8, 8, 8)
    field = np.full(shape, 0.7, np.float32)
    bricks = [Brick(field, (1.2, 1.2, 0.0), (1.7, 1.7, 0.5), owner=0)]
    geometry = SceneGeometry(
        bricks=bricks,
        scalar_range=(0.0, 1.0),
        has_scalar_range=True,
        scalar_transform=ScalarTransform(),
    )
    camera = CameraParameters(
        eye=(0.0, 0.0, 4.0), look_at=(0.0, 0.0, 0.0), up=(0, 1, 0),
        fov_y_degrees=45.0, near_plane=0.1, far_plane=20.0,
    )
    return geometry, camera


def test_sparse_scene_uses_sub_rect_with_identical_pixels(tmp_path):
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.renderer_fast import (
        prepare_slicemarch_scene,
    )

    geometry, camera = _sparse_scene()
    params = RenderParameters(width=128, height=128)

    prep = prepare_slicemarch_scene(
        geometry, params, camera, (0.0, 1.0), 0.03125, 128, 128, None
    )
    rect = coverage_rect(
        prep["coverage"], prep["pad_w"], prep["pad_h"],
        sm.TILE_W, sm.TILE_H, 8,
    )
    assert rect is not None
    x0, y0, rw, rh = rect
    full = prep["pad_w"] * prep["pad_h"]
    assert rw * rh < full / 2, f"rect {rect} should be a small fraction"

    frames = {}
    for devices in (None, 8):
        p = RenderParameters(
            width=128, height=128, devices=devices,
            render_method="slicemarch",
        )
        image, _ = render_scene(
            str(tmp_path / f"r{devices}.ppm"), p, geometry, camera=camera,
            verbose=False,
        )
        frames[devices] = np.array(image.pixels)
    assert frames[8][:, 3].max() > 0.1
    np.testing.assert_allclose(frames[None], frames[8], atol=1e-5)


@pytest.mark.parametrize("pipeline", ["depth", "layered"])
def test_ubyte_transport_within_byte_tolerance(tmp_path, r2_scene, pipeline):
    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    frames = {}
    for transport in ("float32", "ubyte"):
        p = RenderParameters(
            width=32, height=32, devices=8,
            multichip_pipeline=pipeline, multichip_transport=transport,
        )
        image, _ = render_scene(
            str(tmp_path / f"{pipeline}-{transport}.ppm"), p, geometry,
            verbose=False,
        )
        frames[transport] = np.array(image.pixels)
    diff = np.abs(frames["float32"][:, :4] - frames["ubyte"][:, :4])
    # byte codec quantizes each exchanged color to 1/255; a handful of
    # quantizations accumulate across the D-partial fold
    assert diff.max() < 8.0 / 255.0
    assert diff.mean() < 1.0 / 255.0


def test_empty_coverage_respects_device_divisibility():
    """The empty-coverage fallback applies the same num_devices guard as
    the normal branch (a 1-tile rect whose pixel count does not divide the
    mesh would crash the sharded pipeline's shape assert)."""
    cov = np.zeros((2, 16), dtype=bool)
    # 32x32 tile = 1024 px: divisible by 8, not by 12
    assert coverage_rect(cov, 128, 128, 32, 32, 8) == (0, 0, 32, 32)
    assert coverage_rect(cov, 128, 128, 32, 32, 12) is None


class TestCoverageTiles:
    def test_bimodal_coverage_beats_rect(self):
        from amrvolumerenderer_tpu.parallel.directsend import (
            coverage_tiles,
            select_compaction,
        )

        # clusters at opposite frame corners: the union rect is the whole
        # frame (the documented coverage_rect failure mode), the tile list
        # is 2/16 of it
        cov = np.zeros((2, 16), bool)
        cov[0, 0] = True  # tile (0, 0)
        cov[1, 15] = True  # tile (3, 3)
        assert coverage_rect(cov, 128, 128, 32, 32, 8) is None
        pix_idx, valid, fraction = coverage_tiles(cov, 128, 128, 32, 32, 8)
        assert fraction == 2 / 16
        assert valid == 2 * 32 * 32
        rect, tiles = select_compaction(cov, 128, 128, 32, 32, 8)
        assert rect is None and tiles is not None

    def test_contiguous_coverage_prefers_rect(self):
        from amrvolumerenderer_tpu.parallel.directsend import (
            select_compaction,
        )

        cov = np.zeros((1, 16), bool)
        cov[0, [5, 6]] = True  # two adjacent tiles: rect == tiles payload
        rect, tiles = select_compaction(cov, 128, 128, 32, 32, 8)
        assert rect is not None and tiles is None

    def test_paste_tiles_roundtrip(self):
        from amrvolumerenderer_tpu.parallel.directsend import (
            coverage_tiles,
            paste_tiles,
        )

        cov = np.zeros((1, 16), bool)
        cov[0, [0, 15]] = True
        tiles = coverage_tiles(cov, 128, 128, 32, 32, 8)
        pix_idx, valid, _ = tiles
        rng = np.random.default_rng(1)
        compact = rng.random((len(pix_idx), 5)).astype(np.float32)
        full = paste_tiles(compact, tiles, 128, 128)
        img = full.reshape(128, 128, 5)
        np.testing.assert_array_equal(
            img[:32, :32].reshape(-1, 5), compact[: 32 * 32]
        )
        np.testing.assert_array_equal(
            img[96:, 96:].reshape(-1, 5), compact[32 * 32 : valid]
        )
        assert (img[:32, 32:, :4] == 0).all()
        assert np.isinf(img[32:96, :, 4]).all()

    def test_padding_divides_devices(self):
        from amrvolumerenderer_tpu.parallel.directsend import coverage_tiles

        cov = np.zeros((1, 16), bool)
        cov[0, 3] = True  # 1024 px, not divisible by 7
        pix_idx, valid, _ = coverage_tiles(cov, 128, 128, 32, 32, 7)
        assert valid == 1024
        assert len(pix_idx) % 7 == 0
        assert (pix_idx[valid:] == 0).all()


def _two_cluster_scene():
    """Bricks at two opposite corners of the view: the rect degrades to the
    full frame, the tile exchange stays sparse."""
    shape = (8, 8, 8)
    field = np.full(shape, 0.7, np.float32)
    bricks = [
        Brick(field, (1.2, 1.2, 0.0), (1.7, 1.7, 0.5), owner=0),
        Brick(field, (-1.7, -1.7, 0.0), (-1.2, -1.2, 0.5), owner=1),
    ]
    geometry = SceneGeometry(
        bricks=bricks,
        scalar_range=(0.0, 1.0),
        has_scalar_range=True,
        scalar_transform=ScalarTransform(),
    )
    camera = CameraParameters(
        eye=(0.0, 0.0, 4.0), look_at=(0.0, 0.0, 0.0), up=(0, 1, 0),
        fov_y_degrees=45.0, near_plane=0.1, far_plane=20.0,
    )
    return geometry, camera


@pytest.mark.parametrize("pipeline", ["depth", "layered"])
def test_two_cluster_scene_tile_exchange_pixel_identity(tmp_path, pipeline):
    """VERDICT r2 #6 done-criterion: a two-corner-cluster scene exchanges
    < 50% of the frame with pixel identity to the single-device fold."""
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.parallel.directsend import select_compaction
    from amrvolumerenderer_tpu.renderer_fast import prepare_slicemarch_scene

    geometry, camera = _two_cluster_scene()
    params = RenderParameters(width=128, height=128)
    prep = prepare_slicemarch_scene(
        geometry, params, camera, (0.0, 1.0), 0.03125, 128, 128, None
    )
    rect, tiles = select_compaction(
        prep["coverage"], prep["pad_w"], prep["pad_h"],
        sm.TILE_W, sm.TILE_H, 8,
    )
    assert rect is None and tiles is not None
    payload_fraction = len(tiles[0]) / (prep["pad_w"] * prep["pad_h"])
    assert payload_fraction < 0.5, payload_fraction

    frames = {}
    for devices in (None, 8):
        p = RenderParameters(
            width=128, height=128, devices=devices,
            render_method="slicemarch", multichip_pipeline=pipeline,
        )
        image, _ = render_scene(
            str(tmp_path / f"c{devices}.ppm"), p, geometry, camera=camera,
            verbose=False,
        )
        frames[devices] = np.array(image.pixels)
    assert frames[8][:, 3].max() > 0.1
    np.testing.assert_allclose(frames[None], frames[8], atol=1e-5)
