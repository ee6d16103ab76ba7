"""FastSceneRenderer: persistent device scene vs the per-frame fast path."""

import numpy as np
import pytest

from amrvolumerenderer_tpu import api
from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
from amrvolumerenderer_tpu.renderer import render_scene
from amrvolumerenderer_tpu.types import CameraParameters, RenderParameters


@pytest.fixture
def geometry(r2_scene):
    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    return api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)


def test_fast_scene_matches_slicemarch(geometry):
    params = RenderParameters(width=64, height=64)
    fast = FastSceneRenderer(geometry, params)

    cam = CameraParameters(
        eye=(2.5, 1.8, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
        fov_y_degrees=45.0, near_plane=0.1, far_plane=20.0,
    )
    frame = fast.render(cam)

    img, _ = render_scene("", params, geometry, camera=cam, verbose=False,
                          method="slicemarch")
    # the persistent renderer splits bricks to cubes with per-piece hints;
    # for this scene pieces == bricks, so results must match exactly
    np.testing.assert_allclose(frame[:, :4], img.pixels[:, :4], atol=1e-5)


def test_fast_scene_axis_switch(geometry):
    """Cameras with different dominant axes trigger a device repack and
    still agree with the per-frame path."""
    params = RenderParameters(width=32, height=32)
    fast = FastSceneRenderer(geometry, params)
    cameras = [
        CameraParameters(eye=(0.5, 0.5, 4.0), look_at=(0.5, 0.5, 0.5),
                         up=(0, 1, 0)),
        CameraParameters(eye=(4.0, 0.6, 0.5), look_at=(0.5, 0.5, 0.5),
                         up=(0, 1, 0)),
        CameraParameters(eye=(0.4, -3.5, 0.6), look_at=(0.5, 0.5, 0.5),
                         up=(0, 0, 1)),
    ]
    for cam in cameras:
        frame = fast.render(cam)
        img, _ = render_scene("", params, geometry, camera=cam, verbose=False,
                              method="slicemarch")
        np.testing.assert_allclose(frame[:, :4], img.pixels[:, :4], atol=1e-5)


def test_fast_scene_antialiasing(geometry):
    params = RenderParameters(width=24, height=24, antialiasing=4)
    fast = FastSceneRenderer(geometry, params)
    cam = CameraParameters(
        eye=(2.5, 1.8, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
    )
    frame = fast.render(cam)
    assert frame.shape == (24 * 24, 5)
    img, _ = render_scene("", params, geometry, camera=cam, verbose=False,
                          method="slicemarch")
    np.testing.assert_allclose(frame[:, :4], img.pixels[:, :4], atol=1e-5)


def test_fast_scene_splits_large_bricks():
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    rng = np.random.default_rng(4)
    boxes = [LevelBox(rng.random((64, 64, 64)), np.zeros(3, dtype=int))]
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / 64))]
    data = api.AmrData(level_data=[boxes], level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    params = RenderParameters(width=32, height=32)
    fast = FastSceneRenderer(geometry, params)
    assert fast.canonical.shape[0] == 8  # 64^3 -> 8 pieces of 32^3
    cam = CameraParameters(eye=(2.0, 1.5, 2.5), look_at=(0.5, 0.5, 0.5),
                           up=(0, 1, 0))
    frame = fast.render(cam)
    assert frame[:, 3].max() > 0.05


def test_device_scene_ingestion(r2_scene):
    """prepare_device_scene (jnp arrays in, stats/pack on device) matches
    the host-ingested FastSceneRenderer."""
    import jax.numpy as jnp

    from amrvolumerenderer_tpu.device_scene import prepare_device_scene

    levels, geoms = r2_scene
    bricks = []
    for box in levels[0]:
        lo = box.lo / 32.0
        hi = (box.lo + np.asarray(box.data.shape)) / 32.0
        bricks.append((jnp.asarray(box.data, dtype=jnp.float32), lo, hi))

    params = RenderParameters(width=48, height=48)
    device_fast = prepare_device_scene(bricks, params)

    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    host_fast = FastSceneRenderer(geometry, params)

    cam = CameraParameters(
        eye=(2.5, 1.8, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
    )
    frame_dev = device_fast.render(cam)
    frame_host = host_fast.render(cam)
    np.testing.assert_allclose(frame_dev, frame_host, atol=1e-5)


def test_device_scene_log_scale(r2_scene):
    import jax.numpy as jnp

    from amrvolumerenderer_tpu.device_scene import prepare_device_scene

    levels, _ = r2_scene
    bricks = []
    for box in levels[0]:
        lo = box.lo / 32.0
        hi = (box.lo + np.asarray(box.data.shape)) / 32.0
        bricks.append(
            (jnp.asarray(box.data + 0.05, dtype=jnp.float32), lo, hi)
        )
    params = RenderParameters(width=32, height=32)
    fast = prepare_device_scene(bricks, params, log_scale_input=True)
    cam = CameraParameters(eye=(2.5, 1.8, 3.0), look_at=(0.5, 0.5, 0.5),
                           up=(0, 1, 0))
    frame = fast.render(cam)
    assert frame[:, 3].max() > 0.05


def test_transparent_piece_culling(r2_scene):
    """Pieces whose value range maps to zero opacity are culled at prepare
    time (coarse empty-space skipping), without changing the image."""
    from amrvolumerenderer_tpu.types import color_map_from_tuples

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    # zero opacity below 0.5: low-value corner pieces become invisible
    cmap = color_map_from_tuples(
        [(0.0, 0, 0, 1, 0.0), (0.5, 0, 1, 0, 0.0), (1.0, 1, 0, 0, 0.8)]
    )
    params = RenderParameters(width=32, height=32)
    fast = FastSceneRenderer(geometry, params, color_map=cmap)
    assert fast.visible.sum() < 8  # some of the 8 pieces culled

    cam = CameraParameters(eye=(2.5, 1.8, 3.0), look_at=(0.5, 0.5, 0.5),
                           up=(0, 1, 0))
    frame = fast.render(cam, overlay=False)

    from amrvolumerenderer_tpu.renderer import render_scene

    img, _ = render_scene("", params, geometry, camera=cam, verbose=False,
                          color_map=cmap, method="slicemarch")
    # the slicemarch pipeline draws the overlay; compare without it
    img_no_overlay, _ = render_scene(
        "", params, geometry, camera=cam, verbose=False, color_map=cmap,
        method="slicemarch",
    )
    diff = np.abs(frame[:, :4] - img_no_overlay.pixels[:, :4])
    # overlay pixels differ; everything else matches
    interior = diff.max(axis=-1) > 1e-5
    assert interior.mean() < 0.2


def test_set_transfer_function_swap(geometry):
    """Colormap/transparency swaps take effect without re-preparing and
    update the piece-visibility mask."""
    from amrvolumerenderer_tpu.types import color_map_from_tuples

    params = RenderParameters(width=32, height=32)
    fast = FastSceneRenderer(geometry, params)
    cam = CameraParameters(eye=(2.5, 1.8, 3.0), look_at=(0.5, 0.5, 0.5),
                           up=(0, 1, 0))
    frame_default = fast.render(cam, overlay=False)

    cmap = color_map_from_tuples(
        [(0.0, 0, 0, 1, 0.0), (0.5, 0, 1, 0, 0.0), (1.0, 1, 0, 0, 0.8)]
    )
    fast.set_transfer_function(color_map=cmap)
    assert fast.visible.sum() < len(fast.visible)
    frame_cmap = fast.render(cam, overlay=False)
    assert not np.allclose(frame_cmap[:, :4], frame_default[:, :4])

    # must equal a renderer constructed with the colormap from scratch
    fresh = FastSceneRenderer(geometry, params, color_map=cmap)
    frame_fresh = fresh.render(cam, overlay=False)
    np.testing.assert_allclose(frame_cmap, frame_fresh, atol=1e-6)

    # full transparency: nothing but background
    fast.set_transfer_function(color_map=cmap, box_transparency=1.0)
    frame_clear = fast.render(cam, overlay=False)
    assert frame_clear[:, 3].max() == 0.0


def test_device_histogram_matches_host(geometry):
    """device_histogram (jitted bincount) agrees with the host histogram
    on the same transformed scene."""
    import jax.numpy as jnp

    from amrvolumerenderer_tpu.device_scene import device_histogram
    from amrvolumerenderer_tpu.scene import compute_scene_histogram

    bins = 64
    host = compute_scene_histogram(geometry, bins)
    arrays = [jnp.asarray(b.data) for b in geometry.bricks]
    counts, total = device_histogram(
        arrays, geometry.scalar_transform, bins, host.normalized_range
    )
    assert total == host.sample_count
    # the host path bins in float64, the device in float32: values landing
    # exactly on a bin edge may shift by one bin
    moved = np.abs(counts.astype(np.int64) - host.bin_counts.astype(np.int64))
    assert moved.sum() <= max(2, total // 100)
    assert counts.sum() == host.bin_counts.sum()


def test_device_histogram_exact_on_bin_centers():
    import jax.numpy as jnp

    from amrvolumerenderer_tpu.device_scene import device_histogram
    from amrvolumerenderer_tpu.types import ScalarTransform

    bins = 16
    reps = np.arange(bins) + 1
    values = np.repeat((np.arange(bins) + 0.5) / bins, reps).astype(np.float32)
    t = ScalarTransform()
    counts, total = device_histogram([jnp.asarray(values)], t, bins, (0.0, 1.0))
    assert total == values.size
    np.testing.assert_array_equal(counts, reps.astype(np.uint64))

    # degenerate range -> empty histogram
    counts, total = device_histogram([jnp.asarray(values)], t, bins, (1.0, 1.0))
    assert total == 0 and counts.sum() == 0


def test_update_data_time_series(geometry):
    """update_data re-renders evolving values on the fixed hierarchy and
    matches a freshly constructed renderer on the same values (the
    renderVolumeTime workload, without re-preparing the scene)."""
    import jax.numpy as jnp

    params = RenderParameters(width=32, height=32)
    cam = CameraParameters(
        eye=(2.5, 1.8, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
    )
    fast = FastSceneRenderer(geometry, params)
    frame0 = fast.render(cam, overlay=False)

    # evolve: invert the field (stays inside the fixed scalar range)
    new_arrays = [
        jnp.asarray(
            np.float32(geometry.scalar_range[1]) - np.asarray(b.data)
            + np.float32(geometry.scalar_range[0])
        )
        for b in geometry.bricks
    ]
    fast.update_data(new_arrays)
    frame1 = fast.render(cam, overlay=False)
    assert np.abs(frame1[:, :4] - frame0[:, :4]).max() > 0.05  # really changed

    # oracle: a fresh renderer built on the updated values
    import copy

    geom2 = copy.deepcopy(geometry)
    for b, arr in zip(geom2.bricks, new_arrays):
        b.data = np.asarray(arr)
    fresh = FastSceneRenderer(geom2, params)
    frame_fresh = fresh.render(cam, overlay=False)
    # device (f32) vs host (f64) pre-transform: LUT indices may differ by
    # one at bin boundaries on isolated pixels
    diff = np.abs(frame1[:, :4] - frame_fresh[:, :4])
    assert np.mean(diff) < 1e-3
    assert np.quantile(diff, 0.999) < 0.02


def test_update_data_validates_layout(geometry):
    import jax.numpy as jnp

    params = RenderParameters(width=32, height=32)
    fast = FastSceneRenderer(geometry, params)
    with pytest.raises(ValueError, match="brick arrays"):
        fast.update_data([jnp.zeros((4, 4, 4))])
    with pytest.raises(ValueError, match="shape changed"):
        fast.update_data(
            [jnp.zeros((4, 4, 4))] * len(geometry.bricks)
        )


def test_bfloat16_storage_matches_f32_within_tolerance(geometry):
    """precision="bfloat16" halves brick storage; frames stay within the
    pixel-parity tolerance of the f32 path."""
    params = RenderParameters(width=32, height=32)
    cam = CameraParameters(
        eye=(2.5, 1.8, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
    )
    f32 = FastSceneRenderer(geometry, params)
    bf16 = FastSceneRenderer(geometry, params, precision="bfloat16")
    import jax.numpy as jnp

    assert bf16.canonical.dtype == jnp.bfloat16
    a = f32.render(cam, overlay=False)
    b = bf16.render(cam, overlay=False)
    diff = np.abs(a[:, :4] - b[:, :4])
    assert diff.max() < 0.02, diff.max()

    with pytest.raises(ValueError, match="precision"):
        FastSceneRenderer(geometry, params, precision="fp8")


def test_fast_scene_trilinear_smoke(geometry):
    params = RenderParameters(width=32, height=32, sampling="trilinear")
    fast = FastSceneRenderer(geometry, params)
    cam = CameraParameters(
        eye=(2.5, 1.8, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
    )
    tri = fast.render(cam, overlay=False)
    assert np.isfinite(tri[:, :4]).all()
    assert tri[:, 3].max() > 0.1
    near = FastSceneRenderer(
        geometry, RenderParameters(width=32, height=32)
    ).render(cam, overlay=False)
    # smooth field: same frame to first order, not identical
    assert np.abs(tri[:, :4] - near[:, :4]).max() > 1e-4
    assert np.abs(tri[:, :4] - near[:, :4]).mean() < 0.05


class TestRenderBatch:
    """Batched multi-camera rendering (one dispatch per axis/chunk group)."""

    def _orbit(self, n, dist=3.0):
        cams = []
        for k in range(n):
            ang = 2 * np.pi * k / n
            eye = (0.5 + dist * np.sin(ang), 1.2, 0.5 + dist * np.cos(ang))
            cams.append(CameraParameters(
                eye=eye, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
                fov_y_degrees=45.0, near_plane=0.1, far_plane=20.0,
            ))
        return cams

    def test_batch_matches_per_frame_render(self, geometry):
        """A 6-frame orbit crossing march-axis changes: the batched path is
        pixel-identical to per-frame render() (same kernel, same crop and
        downsample ops, only scanned)."""
        params = RenderParameters(width=32, height=32)
        fast = FastSceneRenderer(geometry, params)
        cams = self._orbit(6)
        batch = fast.render_batch(cams, overlay=False)
        assert batch.shape == (6, 32 * 32, 5)
        for i, cam in enumerate(cams):
            single = fast.render(cam, overlay=False)
            # scanned-vs-standalone jit may reassociate fused float ops
            np.testing.assert_allclose(batch[i], single, rtol=1e-6, atol=1e-6)

    def test_batch_with_overlay_and_save(self, geometry, tmp_path):
        params = RenderParameters(width=24, height=24)
        fast = FastSceneRenderer(geometry, params)
        cams = self._orbit(2)
        pattern = str(tmp_path / "frame_{:03d}.ppm")
        batch = fast.render_batch(cams, overlay=True, output_pattern=pattern)
        for i, cam in enumerate(cams):
            assert (tmp_path / f"frame_{i:03d}.ppm").exists()
            single = fast.render(cam, overlay=True)
            np.testing.assert_allclose(batch[i], single, rtol=1e-6, atol=1e-6)

    def test_batch_chunking_small_budget(self, geometry):
        """A tiny readback budget forces multiple chunks (with padding of
        the last partial chunk); results stay identical and ordered."""
        params = RenderParameters(width=32, height=32)
        fast = FastSceneRenderer(geometry, params)
        cams = self._orbit(3, dist=4.0)
        big = fast.render_batch(cams, overlay=False)
        small = fast.render_batch(cams, overlay=False, max_chunk_bytes=1)
        np.testing.assert_array_equal(big, small)

    def test_batch_eager_window_flush(self, geometry, monkeypatch):
        """Batches longer than the 16-frame window flush eagerly — the
        first window's DISPATCH must happen before the last frame's host
        prep (that interleaving is what lets prep overlap the device);
        frames stay identical to per-frame renders and in input order."""
        import amrvolumerenderer_tpu.fast_scene as fs

        params = RenderParameters(width=16, height=16)
        fast = FastSceneRenderer(geometry, params)
        cams = self._orbit(17, dist=4.0)

        events = []
        real_dispatch = fs._render_batch_frames
        real_prep = FastSceneRenderer.frame_inputs

        def spy_dispatch(*a, **k):
            events.append("dispatch")
            return real_dispatch(*a, **k)

        def spy_prep(self, *a, **k):
            events.append("prep")
            return real_prep(self, *a, **k)

        monkeypatch.setattr(fs, "_render_batch_frames", spy_dispatch)
        monkeypatch.setattr(FastSceneRenderer, "frame_inputs", spy_prep)
        batch = fast.render_batch(cams, overlay=False)
        monkeypatch.undo()

        assert fast.last_batch_stats["dispatch_count"] >= 2
        assert batch.shape[0] == 17
        # eager flush: a dispatch is interleaved into the prep sequence,
        # not appended after all 17 preps (which a whole-group flush with
        # internal chunking would also produce)
        first_dispatch = events.index("dispatch")
        assert events[:first_dispatch].count("prep") < 17
        for i in (0, 15, 16):
            np.testing.assert_allclose(
                batch[i], fast.render(cams[i], overlay=False),
                rtol=1e-6, atol=1e-6,
            )

    def test_batch_smem_cap_forces_chunking(self, geometry):
        """Chunks are capped by readback bytes: a cap below one frame's bytes
        must split the batch into per-frame dispatches with identical
        pixels, not raise."""
        params = RenderParameters(width=32, height=32)
        fast = FastSceneRenderer(geometry, params)
        cams = self._orbit(3, dist=4.0)
        big = fast.render_batch(cams, overlay=False)
        n_big = fast.last_batch_stats["dispatch_count"]
        capped = fast.render_batch(cams, overlay=False, max_chunk_bytes=1)
        assert fast.last_batch_stats["dispatch_count"] > n_big
        assert fast.last_batch_stats["dispatch_count"] == len(cams)
        np.testing.assert_array_equal(big, capped)

    def test_batch_culled_frame(self, geometry):
        """A fully transparent transfer function culls every work item;
        batched frames come back cleared, like render()."""
        from amrvolumerenderer_tpu.types import color_map_from_tuples

        params = RenderParameters(width=16, height=16)
        fast = FastSceneRenderer(geometry, params)
        clear = color_map_from_tuples(
            [(0.0, 0.0, 0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0, 0.0)]
        )
        fast.set_transfer_function(color_map=clear)
        batch = fast.render_batch(self._orbit(2), overlay=False)
        assert np.all(batch[:, :, :4] == 0.0)
        assert np.all(np.isinf(batch[:, :, 4]))

    def test_batch_aa_supersampling(self, geometry):
        params = RenderParameters(width=16, height=16, antialiasing=4)
        fast = FastSceneRenderer(geometry, params)
        cams = self._orbit(2)
        batch = fast.render_batch(cams, overlay=False)
        assert batch.shape == (2, 16 * 16, 5)
        for i, cam in enumerate(cams):
            np.testing.assert_allclose(
                batch[i], fast.render(cam, overlay=False),
                rtol=1e-6, atol=1e-6,
            )

    def test_batch_bytes_out(self, geometry, tmp_path):
        """bytes_out returns device-converted RGBA u8 frames (Mesa codec)
        matching the host byte conversion of the float frames, and saves
        valid PPMs; overlay is rejected."""
        from amrvolumerenderer_tpu.image import color_to_byte

        params = RenderParameters(width=24, height=24)
        fast = FastSceneRenderer(geometry, params)
        cams = self._orbit(2)
        with pytest.raises(ValueError):
            fast.render_batch(cams, overlay=True, bytes_out=True)
        pattern = str(tmp_path / "b{:02d}.ppm")
        got = fast.render_batch(
            cams, overlay=False, output_pattern=pattern, bytes_out=True
        )
        assert got.dtype == np.uint8 and got.shape == (2, 24 * 24, 4)
        for i, cam in enumerate(cams):
            single = fast.render(cam, overlay=False)
            np.testing.assert_array_equal(got[i], color_to_byte(single[:, :4]))
            assert (tmp_path / f"b{i:02d}.ppm").exists()

    def test_batch_bytes_out_rgb(self, geometry, tmp_path):
        """bytes_out="rgb" drops the alpha byte on device: pixels match the
        RGBA mode's first three channels and the saved PPMs are identical
        (PPM never reads alpha)."""
        params = RenderParameters(width=24, height=24)
        fast = FastSceneRenderer(geometry, params)
        cams = self._orbit(2)
        rgba = fast.render_batch(cams, overlay=False, bytes_out=True)
        pattern = str(tmp_path / "r{:02d}.ppm")
        got = fast.render_batch(
            cams, overlay=False, output_pattern=pattern, bytes_out="rgb"
        )
        assert got.dtype == np.uint8 and got.shape == (2, 24 * 24, 3)
        np.testing.assert_array_equal(got, rgba[:, :, :3])
        pattern4 = str(tmp_path / "a{:02d}.ppm")
        fast.render_batch(
            cams, overlay=False, output_pattern=pattern4, bytes_out=True
        )
        for i in range(2):
            rgb_bytes = (tmp_path / f"r{i:02d}.ppm").read_bytes()
            assert rgb_bytes == (tmp_path / f"a{i:02d}.ppm").read_bytes()


def test_update_data_host_arrays_single_upload(geometry):
    """NumPy timesteps (the plotfile time-series workload) assemble the
    piece table on host and match the device-array update path."""
    import jax.numpy as jnp

    params = RenderParameters(width=32, height=32)
    cam = CameraParameters(
        eye=(2.5, 1.8, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
    )
    new_np = [
        (np.float32(geometry.scalar_range[1]) - np.asarray(b.data)
         + np.float32(geometry.scalar_range[0]))
        for b in geometry.bricks
    ]
    host = FastSceneRenderer(geometry, params)
    host.update_data(new_np)  # host path: one stacked upload
    dev = FastSceneRenderer(geometry, params)
    dev.update_data([jnp.asarray(a) for a in new_np])  # device path
    f_host = host.render(cam, overlay=False)
    f_dev = dev.render(cam, overlay=False)
    # host f64 vs device f32 pre-transform: isolated LUT-bin straddles
    diff = np.abs(f_host[:, :4] - f_dev[:, :4])
    assert np.mean(diff) < 1e-3
    assert np.quantile(diff, 0.999) < 0.02
