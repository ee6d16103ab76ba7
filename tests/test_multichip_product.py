"""Multi-chip as the product: the public render()/CLI/api surfaces route a
user render across the device mesh and produce the same pixels as the
single-device path.

The reference reaches its distributed path by launching the *same* binary
under ``mpirun`` (VolumeRenderer/main.cpp:19-36; per-rank paint loop +
compose at VolumeRenderer/VolumeRenderer.cpp:1201-1249).  Here the
equivalent is the ``devices`` option, validated on the virtual 8-device CPU
mesh from conftest.py.
"""

import numpy as np
import pytest

import amrvolumerenderer_tpu as avr
from amrvolumerenderer_tpu import api
from amrvolumerenderer_tpu.driver import main, parse_options
from amrvolumerenderer_tpu.plotfile import write_plotfile
from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry


def _read_ppm_pixels(path):
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P6"
        dims = f.readline().split()
        assert f.readline().strip() == b"255"
        w, h = int(dims[0]), int(dims[1])
        return np.frombuffer(f.read(w * h * 3), dtype=np.uint8).reshape(h, w, 3)


def _assert_pixel_identity(a, b):
    """Identical modulo float-fold association: the multi-chip fold splits
    the same global left-fold at device boundaries, so frames agree to f32
    rounding; after byte quantization virtually every pixel is identical."""
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.fixture
def plotfile(tmp_path):
    n = 16
    coords = np.arange(n) / (n - 1)
    field = (
        coords[:, None, None] ** 2
        + coords[None, :, None] ** 2
        + coords[None, None, :] ** 2
    )
    boxes = [LevelBox(field, np.zeros(3, dtype=int))]
    geom = LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))
    path = str(tmp_path / "plt00000")
    write_plotfile(path, [boxes], [geom], var_names=["density"])
    return path


def test_api_render_devices_pixel_identity(tmp_path, r2_scene):
    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)

    frames = {}
    for devices in (None, 8):
        options = api.RenderOptions(
            width=64,
            height=64,
            devices=devices,
            # pin the integrator so single- and multi-device use the same
            # kernel (on CPU the "auto" single-device path is the oracle)
            render_method="slicemarch",
            output_filename=str(tmp_path / f"d{devices}.ppm"),
        )
        image, _ = api.render(data, options, verbose=False)
        frames[devices] = np.array(image.pixels)

    assert frames[8][:, 3].max() > 0.1  # something rendered
    _assert_pixel_identity(frames[None], frames[8])


def test_api_render_devices_with_antialiasing(tmp_path, r2_scene):
    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    frames = {}
    for devices in (None, 4):
        options = api.RenderOptions(
            width=32,
            height=32,
            antialiasing=4,
            devices=devices,
            render_method="slicemarch",
            output_filename=str(tmp_path / f"aa{devices}.ppm"),
        )
        image, _ = api.render(data, options, verbose=False)
        frames[devices] = np.array(image.pixels)
    _assert_pixel_identity(frames[None], frames[4])


def test_layered_pipeline_matches_depth_pipeline(tmp_path, r2_scene):
    from amrvolumerenderer_tpu.renderer import render_scene
    from amrvolumerenderer_tpu.types import RenderParameters

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(
        data, 0, -1, 0, False, True, verbose=False
    )
    frames = {}
    for pipeline in ("depth", "layered"):
        parameters = RenderParameters(
            width=32, height=32, devices=8, multichip_pipeline=pipeline
        )
        image, _ = render_scene(
            str(tmp_path / f"{pipeline}.ppm"), parameters, geometry,
            verbose=False,
        )
        frames[pipeline] = np.array(image.pixels)
    _assert_pixel_identity(frames["depth"], frames["layered"])


def test_cli_devices_flag_parses():
    opts = parse_options(["--devices", "4", "plt000"])
    assert opts.parameters.devices == 4
    with pytest.raises(RuntimeError, match="device count must be positive"):
        parse_options(["--devices", "0", "plt000"])


def test_cli_devices_render_matches_single(tmp_path, plotfile):
    out1 = str(tmp_path / "single.ppm")
    out8 = str(tmp_path / "multi.ppm")
    assert main(["--width", "48", "--height", "48", "--output", out1,
                 "--render-method", "slicemarch", plotfile]) == 0
    assert main(["--width", "48", "--height", "48", "--output", out8,
                 "--devices", "8", plotfile]) == 0
    a = _read_ppm_pixels(out1).astype(np.int16)
    b = _read_ppm_pixels(out8).astype(np.int16)
    diff = np.abs(a - b)
    # byte-level identity up to quantization flips at exact bin edges
    assert (diff > 1).sum() == 0
    assert (diff == 1).mean() < 0.001


def test_render_kwarg_devices_validation(plotfile):
    with pytest.raises(ValueError, match="devices must be a positive"):
        avr.render(plotfile, devices=0)
    with pytest.raises(ValueError, match="are available"):
        avr.render(plotfile, devices=4096)


def test_devices_with_trilinear_sampling(tmp_path, r2_scene):
    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    frames = {}
    for devices in (None, 8):
        options = api.RenderOptions(
            width=32, height=32, sampling="trilinear", devices=devices,
            output_filename=str(tmp_path / f"tri{devices}.ppm"),
        )
        image, _ = api.render(data, options, verbose=False)
        frames[devices] = np.array(image.pixels)
    _assert_pixel_identity(frames[None], frames[8])


def test_devices_rejects_single_device_methods(r2_scene):
    """An explicitly requested raymarch/tilemarch kernel cannot be
    silently overridden by the sharded slicemarch pipeline."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.renderer import render_scene
    from amrvolumerenderer_tpu.types import RenderParameters

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    params = RenderParameters(width=16, height=16, devices=2)
    for method in ("raymarch", "tilemarch"):
        with pytest.raises(ValueError, match="single-device"):
            render_scene("", params, geometry, verbose=False, method=method)


def test_devices_zero_rejected_by_validation():
    from amrvolumerenderer_tpu.renderer import validate_render_parameters
    from amrvolumerenderer_tpu.types import RenderParameters

    with pytest.raises(ValueError, match="devices"):
        validate_render_parameters(
            RenderParameters(width=8, height=8, devices=0)
        )


def test_devices_with_pre_classification(tmp_path, r2_scene):
    """classification="pre" flows through BOTH multichip pipelines (the
    depth-contiguous default silently dropped it before); the mesh render
    must match single-device pre, and differ from the post render."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.renderer import render_scene
    from amrvolumerenderer_tpu.types import (
        RenderParameters,
        color_map_from_tuples,
    )

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    cmap = color_map_from_tuples([
        (0.0, 0.0, 0.0, 1.0, 0.05), (0.499, 0.0, 0.0, 1.0, 0.05),
        (0.501, 1.0, 0.0, 0.0, 0.9), (1.0, 1.0, 0.0, 0.0, 0.9),
    ])
    frames = {}
    for pipeline in ("depth", "layered"):
        params = RenderParameters(
            width=32, height=32, sampling="trilinear", classification="pre",
            devices=4, multichip_pipeline=pipeline,
        )
        img, _ = render_scene("", params, geometry, color_map=cmap,
                              verbose=False)
        frames[pipeline] = np.asarray(img.pixels)
    single = RenderParameters(
        width=32, height=32, sampling="trilinear", classification="pre",
    )
    img1, _ = render_scene("", single, geometry, color_map=cmap,
                           verbose=False, method="slicemarch")
    for pipeline, px in frames.items():
        np.testing.assert_allclose(
            px[:, :4], np.asarray(img1.pixels)[:, :4], atol=1e-5,
            err_msg=pipeline,
        )
    post = RenderParameters(width=32, height=32, sampling="trilinear")
    img_post, _ = render_scene("", post, geometry, color_map=cmap,
                               verbose=False, method="slicemarch")
    assert np.abs(
        np.asarray(img1.pixels)[:, :4] - np.asarray(img_post.pixels)[:, :4]
    ).max() > 0.01


def test_deep_scene_routes_to_tilemarch_on_mesh(tmp_path, tile_threshold_96):
    """VERDICT r2 #2: above the tilemarch threshold, devices>1 must not pay
    O(pieces x pixels) HBM per device — the depth pipeline renders each
    device's run through the mega-kernel and must match the single-device
    tilemarch pixels."""
    from tests.conftest import make_r2_scene_data

    from amrvolumerenderer_tpu.renderer import render_scene
    from amrvolumerenderer_tpu.renderer_fast import TILEMARCH_PIECE_THRESHOLD
    from amrvolumerenderer_tpu.types import RenderParameters

    levels, geoms = make_r2_scene_data(n_cells=40, box_size=8)  # 125 bricks
    assert len(levels[0]) > TILEMARCH_PIECE_THRESHOLD
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)

    frames = {}
    for devices in (None, 8):
        params = RenderParameters(
            width=64, height=64, devices=devices,
            render_method="slicemarch" if devices else "tilemarch",
            multichip_pipeline="depth",
        )
        img, _ = render_scene(
            str(tmp_path / f"deep{devices}.ppm"), params, geometry,
            verbose=False,
        )
        frames[devices] = np.asarray(img.pixels)
    assert frames[8][:, 3].max() > 0.1
    np.testing.assert_allclose(
        frames[None][:, :4], frames[8][:, :4], atol=1e-5
    )


def test_deep_scene_mesh_tilemarch_variants(tmp_path, tile_threshold_96):
    """The fused multichip mega-kernel path must respect sampling,
    classification and transport options (not silently drop them)."""
    from tests.conftest import make_r2_scene_data

    from amrvolumerenderer_tpu.renderer import render_scene
    from amrvolumerenderer_tpu.types import RenderParameters

    levels, geoms = make_r2_scene_data(n_cells=40, box_size=8)  # 125 bricks
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)

    frames = {}
    for devices in (None, 8):
        params = RenderParameters(
            width=48, height=48, devices=devices,
            render_method="slicemarch" if devices else "tilemarch",
            multichip_pipeline="depth", sampling="trilinear",
            classification="pre",
        )
        img, _ = render_scene(
            str(tmp_path / f"v{devices}.ppm"), params, geometry,
            verbose=False,
        )
        frames[devices] = np.asarray(img.pixels)
    assert frames[8][:, 3].max() > 0.1
    np.testing.assert_allclose(
        frames[None][:, :4], frames[8][:, :4], atol=1e-5
    )

    # ubyte transport through the tilemarch partials stays in byte tolerance
    params = RenderParameters(
        width=48, height=48, devices=8, multichip_pipeline="depth",
        sampling="trilinear", classification="pre",
        multichip_transport="ubyte",
    )
    img, _ = render_scene(
        str(tmp_path / "vu.ppm"), params, geometry, verbose=False
    )
    diff = np.abs(np.asarray(img.pixels)[:, :4] - frames[8][:, :4])
    assert diff.max() < 8.0 / 255.0
