"""Slice-march tests: the plain-JAX march vs the NumPy reference, and
convergence toward the reference ray-march integrator."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amrvolumerenderer_tpu.camera import camera_basis
from amrvolumerenderer_tpu.ops import slicemarch as sm
from amrvolumerenderer_tpu.types import CameraParameters


@pytest.fixture
def camera():
    return CameraParameters(
        eye=(0.5, 0.5, 3.0), look_at=(0.5, 0.5, 0.5), up=(0.0, 1.0, 0.0),
        fov_y_degrees=45.0, near_plane=0.1, far_plane=10.0,
    )


def make_lut():
    lut = np.zeros((256, 4), dtype=np.float32)
    lut[:, 0] = np.linspace(0, 1, 256)
    lut[:, 1] = 0.5
    lut[:, 2] = np.linspace(1, 0, 256)
    lut[:, 3] = np.linspace(0.05, 0.6, 256)
    return lut


def run_kernel(data, bmin, bmax, axis, lut, ref_distance, camera, width, height):
    forward, right, up = camera_basis(camera)
    vol, (ns, nu, nv) = sm.pack_slice_volume(data, axis)
    axes = [axis] + [a for a in range(3) if a != axis]
    pmin = np.asarray(bmin, float)[axes]
    pmax = np.asarray(bmax, float)[axes]
    cell = (pmax - pmin) / np.array([ns, nu, nv])
    meta = np.zeros((1, 12), np.float32)
    meta[0, 0:3] = pmin
    meta[0, 3:6] = pmax
    meta[0, 6:9] = cell
    dims = np.zeros((1, 8), np.int32)
    dims[0, :3] = (ns, nu, nv)
    dims[0, 3:6] = axes
    cam = sm.pack_camera(
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        width / height, 0.0, 1.0, ref_distance,
    )
    packed_lut = sm.build_log_lut(lut)[None]
    colors, depths = sm.slicemarch_render(
        jnp.asarray(vol[None]),
        jnp.asarray(meta),
        jnp.asarray(dims),
        jnp.asarray(packed_lut),
        jnp.asarray(cam),
        width=width,
        height=height,
        max_slices=ns,
    )
    return np.asarray(colors[0]), np.asarray(depths[0])


@pytest.mark.parametrize("axis_eye", [
    (2, (0.5, 0.5, 3.0)),   # march along z
    (0, (3.5, 0.6, 0.4)),   # march along x
    (1, (0.4, -2.5, 0.6)),  # march along -y (backward rays)
])
def test_kernel_matches_numpy_reference(axis_eye):
    axis, eye = axis_eye
    camera = CameraParameters(
        eye=eye, look_at=(0.5, 0.5, 0.5), up=(0.0, 1.0, 0.0),
        fov_y_degrees=45.0, near_plane=0.1, far_plane=10.0,
    )
    rng = np.random.default_rng(3)
    data = rng.uniform(0, 1, (8, 8, 8)).astype(np.float32)
    bmin, bmax = np.zeros(3), np.ones(3)
    lut = make_lut()
    ref_distance = 0.0625
    width = height = 32
    forward, right, up = camera_basis(camera)

    got_c, got_d = run_kernel(
        data, bmin, bmax, axis, lut, ref_distance, camera, width, height
    )
    exp_c, exp_d = sm.slicemarch_reference(
        data, bmin, bmax, axis, lut, ref_distance,
        np.asarray(camera.eye), forward, right, up, 45.0, width, height,
    )
    np.testing.assert_allclose(got_c, exp_c, atol=5e-5)
    finite = np.isfinite(exp_d)
    np.testing.assert_array_equal(np.isfinite(got_d), finite)
    np.testing.assert_allclose(got_d[finite], exp_d[finite], atol=1e-4)


def test_slicemarch_close_to_raymarch_on_smooth_field(camera):
    """Both paths approximate the same volume-rendering integral.  The
    slice-march path computes the EXACT per-cell transmittance (window-
    weighted piecewise-constant quadrature); the ray-march path reproduces
    the reference's fixed-step sampling, which quantizes each ray's opacity
    by up to half a step.  Their difference is therefore bounded by the
    reference scheme's own discretization error — small mean error with a
    modest fraction of near-threshold pixels at silhouettes."""
    from amrvolumerenderer_tpu.ops.raymarch import (
        max_steps_for_bucket,
        render_brick_bucket,
    )

    n = 16
    coords = (np.arange(n) + 0.5) / n
    field = (
        coords[:, None, None] * 0.3
        + coords[None, :, None] * 0.4
        + coords[None, None, :] * 0.3
    ).astype(np.float32)
    bmin, bmax = np.zeros(3), np.ones(3)
    lut = make_lut()
    width = height = 32
    step = 0.5 / n
    forward, right, up = camera_basis(camera)

    dims = np.array([[n, n, n]], np.int32)
    oracle_c, _ = render_brick_bucket(
        jnp.asarray(field[None]),
        jnp.asarray(bmin[None].astype(np.float32)),
        jnp.asarray(bmax[None].astype(np.float32)),
        jnp.asarray(dims),
        jnp.asarray(lut[None]),
        jnp.asarray(np.array([step], np.float32)),
        jnp.asarray(camera.eye, dtype=jnp.float32),
        jnp.asarray(forward, dtype=jnp.float32),
        jnp.asarray(right, dtype=jnp.float32),
        jnp.asarray(up, dtype=jnp.float32),
        jnp.float32(45.0), jnp.float32(0.0), jnp.float32(1.0),
        jnp.float32(0.0), jnp.float32(0.0), jnp.float32(1.0),
        width=width, height=height,
        num_steps=max_steps_for_bucket(
            bmin[None], bmax[None], np.array([step])
        ),
        log_scale=False, normalize=False, clip_start=1.0, apply_clip=False,
    )
    oracle_c = np.asarray(oracle_c[0])

    slice_c, _ = run_kernel(
        field, bmin, bmax, 2, lut, step, camera, width, height
    )

    diff = np.abs(slice_c - oracle_c)
    bad = (diff > 0.02).any(axis=-1)
    assert bad.mean() <= 0.12, f"bad pixel fraction {bad.mean():.3f}"
    assert diff.mean() < 0.015, f"mean abs diff {diff.mean():.4f}"
    assert diff.max() < 0.3, f"max abs diff {diff.max():.3f}"


def test_split_brick_for_slices():
    data = np.arange(64 * 64 * 64, dtype=np.float32).reshape(64, 64, 64)
    pieces = sm.split_brick_for_slices(data, np.zeros(3), np.ones(3), axis=2)
    assert len(pieces) == 4  # 64x64 slice -> 4 pieces of 32x32
    total = sum(p[0].size for p in pieces)
    assert total == data.size
    for d, mn, mx in pieces:
        nu, nv = d.shape[0], d.shape[1]
        assert nu * nv <= sm.SLICE_CELLS
        np.testing.assert_allclose(
            (mx - mn), np.asarray(d.shape) / 64.0, atol=1e-12
        )


def test_pack_slice_volume_roundtrip():
    rng = np.random.default_rng(1)
    data = rng.random((4, 8, 16)).astype(np.float32)
    vol, (ns, nu, nv) = sm.pack_slice_volume(data, axis=0)
    assert (ns, nu, nv) == (4, 8, 16)
    flat = vol.reshape(ns, -1)[:, : nu * nv].reshape(ns, nu, nv)
    np.testing.assert_array_equal(flat, data)

    vol2, (ns2, nu2, nv2) = sm.pack_slice_volume(data, axis=2)
    assert (ns2, nu2, nv2) == (16, 4, 8)
    flat2 = vol2.reshape(ns2, -1)[:, : nu2 * nv2].reshape(ns2, nu2, nv2)
    np.testing.assert_array_equal(flat2, np.transpose(data, (2, 0, 1)))


def test_build_log_lut():
    lut = make_lut()
    packed = sm.build_log_lut(lut)
    assert packed.shape == (4, 2, 128)
    flat_l = packed[3].reshape(-1)
    np.testing.assert_allclose(
        1.0 - np.exp(flat_l), lut[:, 3], atol=1e-6
    )
    # opaque entries map to -inf => alpha 1 under any positive exponent
    lut2 = lut.copy()
    lut2[-1, 3] = 1.0
    packed2 = sm.build_log_lut(lut2)
    assert np.isneginf(packed2[3].reshape(-1)[-1])


def test_worklist_matches_dense(camera):
    """The work-list render with screen-bbox culling must match the dense
    render exactly on covered pixels and produce empty pixels elsewhere."""
    rng = np.random.default_rng(9)
    width = height = 128
    bricks = [
        (rng.uniform(0, 1, (8, 8, 8)).astype(np.float32),
         np.array([0.0, 0.0, 0.0]), np.array([0.5, 0.5, 0.5])),
        (rng.uniform(0, 1, (8, 8, 8)).astype(np.float32),
         np.array([0.5, 0.5, 0.5]), np.array([1.0, 1.0, 1.0])),
    ]
    forward, right, up = camera_basis(camera)
    axis = sm.choose_march_axis(forward)
    axes = [axis] + [a for a in range(3) if a != axis]
    vols, metas, dims_list = [], [], []
    for data, mn, mx in bricks:
        vol, (ns, nu, nv) = sm.pack_slice_volume(data, axis)
        pmin, pmax = mn[axes], mx[axes]
        cell = (pmax - pmin) / np.array([ns, nu, nv])
        m = np.zeros(12, np.float32)
        m[0:3], m[3:6], m[6:9] = pmin, pmax, cell
        dd = np.zeros(8, np.int32)
        dd[:3] = (ns, nu, nv)
        dd[3:6] = axes
        vols.append(vol)
        metas.append(m)
        dims_list.append(dd)
    vol = np.stack(vols)
    meta = np.stack(metas)
    dims = np.stack(dims_list)
    lut = make_lut()
    packed = np.tile(sm.build_log_lut(lut)[None], (2, 1, 1, 1))
    cam = sm.pack_camera(
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        1.0, 0.0, 1.0, 0.0625,
    )
    interp = jax.default_backend() == "cpu"

    dense_c, dense_d = sm.slicemarch_render(
        jnp.asarray(vol), jnp.asarray(meta), jnp.asarray(dims),
        jnp.asarray(packed), jnp.asarray(cam),
        width=width, height=height, max_slices=8,
    )

    box_min = np.stack([b[1] for b in bricks])
    box_max = np.stack([b[2] for b in bricks])
    wb, wt, coverage = sm.compute_worklist(
        box_min, box_max, np.asarray(camera.eye), forward, right, up,
        camera.fov_y_degrees, width, height, pad_to=8,
    )
    # culling must actually cull something in this scene
    assert coverage.sum() < coverage.size

    wl_c, wl_d = sm.slicemarch_render_worklist(
        jnp.asarray(vol), jnp.asarray(meta), jnp.asarray(dims),
        jnp.asarray(packed), jnp.asarray(cam),
        jnp.asarray(wb), jnp.asarray(wt), jnp.asarray(coverage),
        width=width, height=height, max_slices=8,
    )
    np.testing.assert_allclose(np.asarray(wl_c), np.asarray(dense_c), atol=1e-6)
    got_d, exp_d = np.asarray(wl_d), np.asarray(dense_d)
    np.testing.assert_array_equal(np.isfinite(got_d), np.isfinite(exp_d))
    f = np.isfinite(exp_d)
    np.testing.assert_allclose(got_d[f], exp_d[f], atol=1e-6)


def test_full_pipeline_slicemarch_vs_raymarch(r2_scene, tmp_path):
    """End-to-end render through the slice-march path must match the exact
    ray-march path within the reference pixel-parity tolerance."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.renderer import render_scene
    from amrvolumerenderer_tpu.types import RenderParameters

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    params = RenderParameters(width=64, height=64)

    img_ray, _ = render_scene(
        "", params, geometry, verbose=False, method="raymarch"
    )
    img_slice, _ = render_scene(
        "", params, geometry, verbose=False, method="slicemarch"
    )
    diff = np.abs(img_ray.pixels[:, :4] - img_slice.pixels[:, :4])
    bad = (diff > 0.02).any(axis=-1)
    assert bad.mean() <= 0.12, f"bad pixel fraction {bad.mean():.4f}"
    assert diff.mean() < 0.015, f"mean abs diff {diff.mean():.4f}"


def test_full_pipeline_slicemarch_padded_frame(r2_scene):
    """Non-tile-multiple frame sizes render through the padded path and
    still match the exact renderer."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.renderer import render_scene
    from amrvolumerenderer_tpu.types import RenderParameters

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    params = RenderParameters(width=48, height=40)

    img_ray, _ = render_scene(
        "", params, geometry, verbose=False, method="raymarch"
    )
    img_slice, _ = render_scene(
        "", params, geometry, verbose=False, method="slicemarch"
    )
    diff = np.abs(img_ray.pixels[:, :4] - img_slice.pixels[:, :4])
    bad = (diff > 0.02).any(axis=-1)
    assert bad.mean() <= 0.12, f"bad pixel fraction {bad.mean():.4f}"


def test_fused_aa_matches_raymarch_aa(r2_scene):
    """AA=4 through the fused device downsample matches the raymarch path's
    host downsample within the cross-integrator tolerance."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.renderer import render_scene
    from amrvolumerenderer_tpu.types import RenderParameters

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    params = RenderParameters(width=32, height=32, antialiasing=4)
    img_ray, _ = render_scene("", params, geometry, verbose=False,
                              method="raymarch")
    img_slice, _ = render_scene("", params, geometry, verbose=False,
                                method="slicemarch")
    assert img_slice.width == 32 and img_slice.height == 32
    diff = np.abs(img_ray.pixels[:, :4] - img_slice.pixels[:, :4])
    bad = (diff > 0.02).any(axis=-1)
    assert bad.mean() <= 0.12, f"bad pixel fraction {bad.mean():.4f}"
    assert diff.mean() < 0.015


def test_raymarch_converges_to_slicemarch(camera):
    """As the ray-march step shrinks (with opacity normalized to the same
    reference distance), the reference integrator converges to the
    slice-march result — evidence that the window-weighted quadrature is
    the exact limit of the reference scheme."""
    from amrvolumerenderer_tpu.colormap import build_color_table, compute_scaled_alpha
    from amrvolumerenderer_tpu.ops.raymarch import (
        max_steps_for_bucket,
        render_brick_bucket,
    )

    n = 8
    coords = (np.arange(n) + 0.5) / n
    field = (
        coords[:, None, None] * 0.4
        + coords[None, :, None] * 0.3
        + coords[None, None, :] * 0.3
    ).astype(np.float32)
    bmin, bmax = np.zeros(3), np.ones(3)
    base_lut = make_lut()
    width = height = 32
    ref_distance = 0.5 / n
    forward, right, up = camera_basis(camera)

    slice_c, _ = run_kernel(
        field, bmin, bmax, 2, base_lut, ref_distance, camera, width, height
    )

    def raymarch_at_step(step):
        # renormalize the LUT alphas for this step against ref_distance
        lut = base_lut.copy()
        factor = step / ref_distance
        lut[:, 3] = [
            compute_scaled_alpha(a, 1.0, factor) for a in base_lut[:, 3]
        ]
        dims = np.array([[n, n, n]], np.int32)
        c, _ = render_brick_bucket(
            jnp.asarray(field[None]),
            jnp.asarray(bmin[None].astype(np.float32)),
            jnp.asarray(bmax[None].astype(np.float32)),
            jnp.asarray(dims),
            jnp.asarray(lut[None]),
            jnp.asarray(np.array([step], np.float32)),
            jnp.asarray(camera.eye, dtype=jnp.float32),
            jnp.asarray(forward, dtype=jnp.float32),
            jnp.asarray(right, dtype=jnp.float32),
            jnp.asarray(up, dtype=jnp.float32),
            jnp.float32(45.0), jnp.float32(0.0), jnp.float32(1.0),
            jnp.float32(0.0), jnp.float32(0.0), jnp.float32(1.0),
            width=width, height=height,
            num_steps=max_steps_for_bucket(
                bmin[None], bmax[None], np.array([step])
            ),
            log_scale=False, normalize=False, clip_start=1.0, apply_clip=False,
        )
        return np.asarray(c[0])

    err_coarse = np.abs(raymarch_at_step(ref_distance) - slice_c).mean()
    err_fine = np.abs(raymarch_at_step(ref_distance / 4) - slice_c).mean()
    err_finest = np.abs(raymarch_at_step(ref_distance / 16) - slice_c).mean()
    assert err_fine < err_coarse
    assert err_finest < err_fine
    assert err_finest < 0.004, f"not converging: {err_finest:.4f}"


class TestSliceBounds:
    """Empty-space skipping: occupied-slice loop bounds (dims[7])."""

    def test_compute_slice_bounds_basic(self):
        from amrvolumerenderer_tpu.ops.slicemarch import compute_slice_bounds

        ns = 10
        vol = np.zeros((ns, 8, 128), np.float32)
        vol[3:7] = 0.9  # only slices 3..6 carry visible values
        lut_alpha = np.zeros(256, np.float32)
        lut_alpha[128:] = 0.5  # alpha only for normalized values >= ~0.5
        packed = compute_slice_bounds(vol, lut_alpha)
        assert packed >> 16 == 3
        assert packed & 0xFFFF == 7

        # fully transparent LUT -> zero-trip loop encoding
        packed = compute_slice_bounds(vol, np.zeros(256, np.float32))
        assert packed >> 16 == ns and (packed & 0xFFFF) == ns

        # alpha everywhere -> full range
        packed = compute_slice_bounds(vol, np.ones(256, np.float32))
        assert packed >> 16 == 0 and (packed & 0xFFFF) == ns

    @pytest.mark.parametrize(
        "eye", [(0.5, 0.4, 3.0), (0.5, 0.4, -2.0), (0.5, 0.5, 0.5)]
    )
    def test_bounds_render_identical(self, eye):
        """Rendering with tightened slice bounds equals the full-range march
        up to the FP combination order of the unrolled loop (fwd, bwd, and
        inside-the-brick mixed cases)."""
        from amrvolumerenderer_tpu.camera import camera_basis
        from amrvolumerenderer_tpu.ops import slicemarch as sm
        from amrvolumerenderer_tpu.types import CameraParameters

        n = 16
        coords = np.arange(n) / (n - 1)
        field = np.zeros((n, n, n), np.float32)
        field[:, :, 5:11] = (
            coords[:, None, None] * 0.3 + 0.6
        )  # visible band only in z slices 5..10
        camera = CameraParameters(eye=eye, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0))
        forward, right, up = camera_basis(camera)
        axis = 2  # force march along z so the band maps to slice bounds
        axes = [axis] + [a for a in range(3) if a != axis]

        # custom transfer function with a transparent low region (the
        # default map has alpha everywhere, which never skips)
        lut = np.zeros((256, 4), np.float32)
        lut[128:, :3] = 0.7
        lut[128:, 3] = 0.5
        packed_lut = sm.build_log_lut(lut)
        range_min, inv_range = 0.0, 1.0

        vol, (ns, nu, nv) = sm.pack_slice_volume(field, axis)
        meta = np.zeros((1, 12), np.float32)
        mn, mx = np.zeros(3), np.ones(3)
        meta[0, 0:3] = mn[axes]
        meta[0, 3:6] = mx[axes]
        meta[0, 6:9] = 1.0 / np.array([ns, nu, nv])
        dims = np.zeros((1, 8), np.int32)
        dims[0, :3] = (ns, nu, nv)
        dims[0, 3:6] = axes
        cam = sm.pack_camera(
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees, 1.0, range_min, inv_range, 0.5 / n,
        )
        luts = packed_lut[None]

        kw = dict(width=32, height=32, max_slices=ns)
        base_c, base_d = sm.slicemarch_render(
            jnp.asarray(vol[None]), jnp.asarray(meta), jnp.asarray(dims),
            jnp.asarray(luts), jnp.asarray(cam), **kw,
        )

        bounds = sm.compute_slice_bounds(vol, lut[:, 3], range_min, inv_range)
        s_lo, s_hi = bounds >> 16, bounds & 0xFFFF
        assert 0 < s_lo and s_hi < ns  # the test scene really skips slices
        dims_b = dims.copy()
        dims_b[0, 7] = bounds
        got_c, got_d = sm.slicemarch_render(
            jnp.asarray(vol[None]), jnp.asarray(meta), jnp.asarray(dims_b),
            jnp.asarray(luts), jnp.asarray(cam), **kw,
        )
        np.testing.assert_allclose(
            np.asarray(got_c), np.asarray(base_c), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(got_d), np.asarray(base_d), atol=1e-6
        )

    def test_bounds_zero_trip_empty_brick(self):
        from amrvolumerenderer_tpu.ops import slicemarch as sm
        from amrvolumerenderer_tpu.camera import camera_basis
        from amrvolumerenderer_tpu.types import CameraParameters

        n = 8
        field = np.zeros((n, n, n), np.float32)  # all below the alpha ramp
        camera = CameraParameters(
            eye=(0.5, 0.5, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)
        )
        forward, right, up = camera_basis(camera)
        axis = 2
        axes = [axis] + [a for a in range(3) if a != axis]
        lut = np.zeros((256, 4), np.float32)
        lut[128:, :3] = 0.7
        lut[128:, 3] = 0.5
        vol, (ns, nu, nv) = sm.pack_slice_volume(field, axis)
        bounds = sm.compute_slice_bounds(vol, lut[:, 3], 0.5, 2.0)
        assert bounds >> 16 == ns and bounds & 0xFFFF == ns

        meta = np.zeros((1, 12), np.float32)
        meta[0, 3:6] = 1.0
        meta[0, 6:9] = 1.0 / n
        dims = np.zeros((1, 8), np.int32)
        dims[0, :3] = (ns, nu, nv)
        dims[0, 3:6] = axes
        dims[0, 7] = bounds
        cam = sm.pack_camera(
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees, 1.0, 0.5, 2.0, 0.5 / n,
        )
        colors, depths = sm.slicemarch_render(
            jnp.asarray(vol[None]), jnp.asarray(meta), jnp.asarray(dims),
            jnp.asarray(sm.build_log_lut(lut)[None]), jnp.asarray(cam),
            width=32, height=32, max_slices=ns,
        )
        assert float(jnp.abs(colors).max()) == 0.0
        assert bool(jnp.all(jnp.isinf(depths)))

    def test_compute_slice_bounds_batch(self):
        from amrvolumerenderer_tpu.ops.slicemarch import (
            compute_slice_bounds,
            compute_slice_bounds_batch,
        )

        rng = np.random.default_rng(5)
        num, cap = 6, 12
        lut_alpha = np.zeros(256, np.float32)
        lut_alpha[100:200] = 0.4
        ns = rng.integers(4, cap + 1, num)
        vols = []
        for i in range(num):
            v = np.zeros((cap, 8, 128), np.float32)
            v[: ns[i]] = rng.random((ns[i], 8, 128)) * rng.random()
            vols.append(v)
        smin = np.stack([v.reshape(cap, -1).min(1) for v in vols])
        smax = np.stack([v.reshape(cap, -1).max(1) for v in vols])
        got = compute_slice_bounds_batch(smin, smax, lut_alpha, 0.0, 1.0, ns)
        for i in range(num):
            expected = compute_slice_bounds(vols[i][: ns[i]], lut_alpha)
            assert got[i] == expected, (i, got[i] >> 16, got[i] & 0xFFFF)


class TestTrilinear:
    """sampling="trilinear": in-slice bilinear at march-plane crossings."""

    def _scene(self):
        n = 16
        rng = np.random.default_rng(9)
        field = rng.random((n, n, n)).astype(np.float32)
        from amrvolumerenderer_tpu.camera import camera_basis
        from amrvolumerenderer_tpu.colormap import build_color_table
        from amrvolumerenderer_tpu.ops import slicemarch as sm
        from amrvolumerenderer_tpu.types import CameraParameters

        camera = CameraParameters(
            eye=(2.1, 1.4, 2.6), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)
        )
        forward, right, up = camera_basis(camera)
        axis = sm.choose_march_axis(forward)
        axes = [axis] + [a for a in range(3) if a != axis]
        lut = build_color_table(1.0, 1.0, (0.0, 1.0), None)
        vol, (ns, nu, nv) = sm.pack_slice_volume(field, axis)
        meta = np.zeros((1, 12), np.float32)
        meta[0, 3:6] = 1.0
        meta[0, 6:9] = 1.0 / np.array([ns, nu, nv])
        dims = np.zeros((1, 8), np.int32)
        dims[0, :3] = (ns, nu, nv)
        dims[0, 3:6] = axes
        cam = sm.pack_camera(
            np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
            1.0, 0.0, 1.0, 0.5 / n,
        )
        return field, camera, forward, right, up, axis, lut, vol, meta, dims, cam, ns

    def test_kernel_matches_numpy_oracle(self):
        from amrvolumerenderer_tpu.ops import slicemarch as sm

        (field, camera, forward, right, up, axis, lut, vol, meta, dims, cam,
         ns) = self._scene()
        w = h = 64
        exp_c, exp_d = sm.slicemarch_reference(
            field, np.zeros(3), np.ones(3), axis, lut, 0.5 / 16,
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees, w, h, sampling="trilinear",
        )
        got_c, got_d = sm.slicemarch_render(
            jnp.asarray(vol[None]), jnp.asarray(meta), jnp.asarray(dims),
            jnp.asarray(sm.build_log_lut(lut)[None]), jnp.asarray(cam),
            width=w, height=h, max_slices=ns,
            sampling="trilinear",
        )
        # f32 (kernel) vs f64 (oracle) interpolation can straddle a LUT bin
        # edge on isolated pixels; everything else matches to float noise
        diff = np.abs(np.asarray(got_c[0]) - exp_c)
        assert np.quantile(diff, 0.999) < 5e-5
        assert diff.max() < 5e-3
        diff_nearest = np.abs(
            np.asarray(
                sm.slicemarch_render(
                    jnp.asarray(vol[None]), jnp.asarray(meta),
                    jnp.asarray(dims),
                    jnp.asarray(sm.build_log_lut(lut)[None]),
                    jnp.asarray(cam), width=w, height=h, max_slices=ns,
                )[0][0]
            )
            - exp_c
        ).max()
        assert diff_nearest > 1e-3  # trilinear really differs from nearest

    def test_tilemarch_trilinear_matches_slicemarch(self):
        from amrvolumerenderer_tpu.camera import compute_box_depth_hints
        from amrvolumerenderer_tpu.ops import slicemarch as sm
        from amrvolumerenderer_tpu.ops import tilemarch as tm

        (field, camera, forward, right, up, axis, lut, vol, meta, dims, cam,
         ns) = self._scene()
        w = h = 32
        hints = compute_box_depth_hints(
            np.zeros((1, 3)), np.ones((1, 3)), camera
        )
        offsets, tb, to = tm.build_tile_worklist(
            np.zeros((1, 3)), np.ones((1, 3)), hints, np.zeros(1, np.int32),
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees, w, h,
        )
        out_c, _ = tm.tilemarch_render(
            jnp.asarray(vol[None]), jnp.asarray(meta), jnp.asarray(dims),
            jnp.asarray(sm.build_log_lut(lut)), jnp.asarray(cam),
            jnp.asarray(offsets), jnp.asarray(tb), jnp.asarray(to),
            width=w, height=h, max_slices=ns,
            sampling="trilinear",
        )
        tiles = w // tm.TILE_W
        mega = (
            np.asarray(out_c)
            .reshape(tiles, tiles, 4, tm.TILE_H, tm.TILE_W)
            .transpose(0, 3, 1, 4, 2)
            .reshape(w * h, 4)
        )
        ref_c, _ = sm.slicemarch_render(
            jnp.asarray(vol[None]), jnp.asarray(meta), jnp.asarray(dims),
            jnp.asarray(sm.build_log_lut(lut)[None]), jnp.asarray(cam),
            width=w, height=h, max_slices=ns,
            sampling="trilinear",
        )
        np.testing.assert_allclose(mega, np.asarray(ref_c[0]), atol=5e-5)

    def test_parameter_validation(self):
        from amrvolumerenderer_tpu.renderer import validate_render_parameters
        from amrvolumerenderer_tpu.types import RenderParameters

        validate_render_parameters(RenderParameters(sampling="trilinear"))
        with pytest.raises(ValueError, match="sampling"):
            validate_render_parameters(RenderParameters(sampling="cubic"))


class TestPreClassification:
    """classification="pre": classify corner samples, then interpolate the
    classified channels (VTK-style pre-classification; beyond reference)."""

    def _scene(self):
        return TestTrilinear._scene(TestTrilinear())

    def _sharp_lut(self):
        from amrvolumerenderer_tpu.colormap import build_color_table
        from amrvolumerenderer_tpu.types import color_map_from_tuples

        # a hard color/opacity step at 0.5: pre and post classification
        # visibly disagree wherever interpolation crosses the step
        cmap = color_map_from_tuples([
            (0.0, 0.0, 0.0, 1.0, 0.05), (0.499, 0.0, 0.0, 1.0, 0.05),
            (0.501, 1.0, 0.0, 0.0, 0.9), (1.0, 1.0, 0.0, 0.0, 0.9),
        ])
        return build_color_table(1.0, 1.0, (0.0, 1.0), cmap)

    def test_kernel_matches_numpy_oracle_pre(self):
        from amrvolumerenderer_tpu.ops import slicemarch as sm

        (field, camera, forward, right, up, axis, _lut, vol, meta, dims,
         cam, ns) = self._scene()
        lut = self._sharp_lut()
        w = h = 64
        exp_c, _ = sm.slicemarch_reference(
            field, np.zeros(3), np.ones(3), axis, lut, 0.5 / 16,
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees, w, h, sampling="trilinear",
            classification="pre",
        )
        got_c, _ = sm.slicemarch_render(
            jnp.asarray(vol[None]), jnp.asarray(meta), jnp.asarray(dims),
            jnp.asarray(sm.build_log_lut(lut)[None]), jnp.asarray(cam),
            width=w, height=h, max_slices=ns,
            sampling="trilinear", classification="pre",
        )
        diff = np.abs(np.asarray(got_c[0]) - exp_c)
        assert np.quantile(diff, 0.999) < 5e-4
        assert diff.max() < 5e-2

    def test_pre_differs_from_post_on_sharp_lut(self):
        from amrvolumerenderer_tpu.ops import slicemarch as sm

        (field, camera, forward, right, up, axis, _lut, vol, meta, dims,
         cam, ns) = self._scene()
        lut = self._sharp_lut()
        w = h = 64
        kw = dict(width=w, height=h, max_slices=ns,
                  sampling="trilinear")
        args = (
            jnp.asarray(vol[None]), jnp.asarray(meta), jnp.asarray(dims),
            jnp.asarray(sm.build_log_lut(lut)[None]), jnp.asarray(cam),
        )
        pre_c, _ = sm.slicemarch_render(*args, classification="pre", **kw)
        post_c, _ = sm.slicemarch_render(*args, classification="post", **kw)
        assert np.abs(np.asarray(pre_c) - np.asarray(post_c)).max() > 0.05

    def test_smooth_field_pre_close_to_post(self):
        """On a SMOOTH field the corner scalars are nearly equal, so the
        two classification orders nearly coincide (they differ materially
        only where interpolation spans a transfer-function transition —
        exactly the random-field / sharp-LUT cases above)."""
        from amrvolumerenderer_tpu.camera import camera_basis
        from amrvolumerenderer_tpu.colormap import build_color_table
        from amrvolumerenderer_tpu.ops import slicemarch as sm
        from amrvolumerenderer_tpu.types import CameraParameters

        n = 16
        c = (np.arange(n) + 0.5) / n
        field = (
            0.5 + 0.5 * np.sin(2 * np.pi * c)[:, None, None]
            * np.cos(np.pi * c)[None, :, None]
            * np.ones(n)[None, None, :]
        ).astype(np.float32) * 0.5
        camera = CameraParameters(
            eye=(2.1, 1.4, 2.6), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)
        )
        forward, right, up = camera_basis(camera)
        axis = sm.choose_march_axis(forward)
        axes = [axis] + [a for a in range(3) if a != axis]
        vol, (ns, nu, nv) = sm.pack_slice_volume(field, axis)
        meta = np.zeros((1, 12), np.float32)
        meta[0, 3:6] = 1.0
        meta[0, 6:9] = 1.0 / np.array([ns, nu, nv])
        dims = np.zeros((1, 8), np.int32)
        dims[0, :3] = (ns, nu, nv)
        dims[0, 3:6] = axes
        cam = sm.pack_camera(
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees, 1.0, 0.0, 1.0, 0.5 / n,
        )
        lut = build_color_table(1.0, 1.0, (0.0, 1.0), None)
        w = h = 64
        kw = dict(width=w, height=h, max_slices=ns,
                  sampling="trilinear")
        args = (
            jnp.asarray(vol[None]), jnp.asarray(meta), jnp.asarray(dims),
            jnp.asarray(sm.build_log_lut(lut)[None]), jnp.asarray(cam),
        )
        pre_c, _ = sm.slicemarch_render(*args, classification="pre", **kw)
        post_c, _ = sm.slicemarch_render(*args, classification="post", **kw)
        assert np.abs(np.asarray(pre_c) - np.asarray(post_c)).max() < 0.05

    def test_validation_and_cli(self):
        from amrvolumerenderer_tpu.driver import parse_options
        from amrvolumerenderer_tpu.renderer import validate_render_parameters
        from amrvolumerenderer_tpu.types import RenderParameters

        with pytest.raises(ValueError, match="classification"):
            validate_render_parameters(
                RenderParameters(classification="bogus")
            )
        with pytest.raises(ValueError, match="trilinear"):
            validate_render_parameters(
                RenderParameters(classification="pre", sampling="nearest")
            )
        opts = parse_options([
            "--sampling", "trilinear", "--classification", "pre", "plt0",
        ])
        assert opts.parameters.classification == "pre"
        with pytest.raises(RuntimeError):
            parse_options(["--classification", "maybe", "plt0"])

    def test_fast_scene_pre_classification(self):
        """The persistent-scene mega-kernel path honors the mode and
        matches the one-shot slicemarch render."""
        from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
        from amrvolumerenderer_tpu.renderer_fast import (
            render_composited_slicemarch,
        )
        from amrvolumerenderer_tpu.types import (
            Brick,
            CameraParameters,
            RenderParameters,
            SceneGeometry,
            color_map_from_tuples,
        )

        rng = np.random.default_rng(31)
        g = SceneGeometry()
        g.bricks.append(Brick(
            data=rng.random((16, 16, 16)).astype(np.float32),
            min_corner=np.zeros(3), max_corner=np.ones(3),
        ))
        g.scalar_range = (0.0, 1.0)
        g.has_scalar_range = True
        cmap = color_map_from_tuples([
            (0.0, 0.0, 0.0, 1.0, 0.05), (0.499, 0.0, 0.0, 1.0, 0.05),
            (0.501, 1.0, 0.0, 0.0, 0.9), (1.0, 1.0, 0.0, 0.0, 0.9),
        ])
        params = RenderParameters(
            width=32, height=32, sampling="trilinear", classification="pre"
        )
        camera = CameraParameters(
            eye=(1.8, 1.2, 2.4), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)
        )
        fast = FastSceneRenderer(g, params, color_map=cmap)
        frame = fast.render(camera, overlay=False)
        oneshot = render_composited_slicemarch(
            g, params, camera, (0.0, 1.0), 0.5 / 16, 32, 32, cmap,
        )
        np.testing.assert_allclose(
            frame[:, :4], oneshot[:, :4], atol=1e-5
        )
        # and it differs from the post render on this sharp LUT
        params_post = RenderParameters(
            width=32, height=32, sampling="trilinear"
        )
        fast_post = FastSceneRenderer(
            g, params_post, color_map=cmap
        )
        diff = np.abs(
            frame[:, :4] - fast_post.render(camera, overlay=False)[:, :4]
        ).max()
        assert diff > 0.01



def _march_vs_reference(data, eye, sampling, classification, ghost, dtype):
    """Pack ``data`` as the product does (``split_brick_for_slices`` with a
    ``ghost``-cell edge-replicated ring, one piece), march it, and return
    (march colors, float64 NumPy reference colors).  An edge-replicated
    ring clamps exactly like the reference, so the two must agree."""
    from amrvolumerenderer_tpu.colormap import build_color_table

    camera = CameraParameters(eye=eye, look_at=(0.5, 0.5, 0.2),
                              up=(0.0, 1.0, 0.0))
    forward, right, up = camera_basis(camera)
    axis = sm.choose_march_axis(forward)
    axes = [axis] + [a for a in range(3) if a != axis]
    lut = build_color_table(1.0, 1.0, (0.0, 1.0), None)
    bmin = np.zeros(3)
    bmax = np.asarray(data.shape, float) / data.shape[0]  # cubic cells
    (piece, mn, mx), = sm.split_brick_for_slices(
        data, bmin, bmax, axis, ghost=ghost
    )
    vol, (ns, nu, nv) = sm.pack_slice_volume(piece, axis, ghost=ghost)
    pmin, pmax = np.asarray(mn)[axes], np.asarray(mx)[axes]
    meta = np.zeros((1, 12), np.float32)
    meta[0, 0:3], meta[0, 3:6] = pmin, pmax
    meta[0, 6:9] = (pmax - pmin) / np.array([ns, nu, nv])
    dims = np.zeros((1, 8), np.int32)
    dims[0, :3] = (ns, nu, nv)
    dims[0, 3:6] = axes
    dims[0, 6] = nv + 2 * ghost
    ref_distance = 0.5 / data.shape[0]
    cam = sm.pack_camera(np.asarray(camera.eye), forward, right, up,
                         camera.fov_y_degrees, 1.0, 0.0, 1.0, ref_distance)
    colors, _ = sm.slicemarch_render(
        jnp.asarray(vol[None]).astype(dtype), jnp.asarray(meta),
        jnp.asarray(dims), jnp.asarray(sm.build_log_lut(lut)[None]),
        jnp.asarray(cam), width=32, height=32, max_slices=vol.shape[0],
        sampling=sampling, ghost=ghost, classification=classification,
    )
    exp_c, _ = sm.slicemarch_reference(
        data, bmin, bmax, axis, lut, ref_distance, np.asarray(camera.eye),
        forward, right, up, camera.fov_y_degrees, 32, 32,
        sampling=sampling, classification=classification,
    )
    return np.asarray(colors[0]), exp_c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ghost", [0, 1])
@pytest.mark.parametrize("eye", [(0.8, 0.6, 2.7), (0.3, 0.4, -1.9)],
                         ids=["forward", "backward"])
@pytest.mark.parametrize("mode", [("nearest", "post"), ("trilinear", "post"),
                                  ("trilinear", "pre")],
                         ids=["nearest", "trilinear", "pre"])
def test_plain_march_matches_reference(mode, eye, ghost, dtype):
    """The plain-JAX march equals the float64 NumPy reference for every
    sampling x classification mode, both march signs, ghost rings 0/1
    (a 30x30 core with its ring fills one 1024-cell slice exactly) and
    bf16 storage (the reference sees the bf16-rounded field)."""
    sampling, classification = mode
    n_t, n_s = 30, 12
    x = (np.arange(n_t) + 0.5) / n_t
    z = (np.arange(n_s) + 0.5) / n_s
    field = (0.5 + 0.25 * np.sin(5.0 * x)[:, None, None]
             * np.cos(3.0 * x)[None, :, None]
             + 0.2 * z[None, None, :]).astype(np.float32)
    field = np.asarray(jnp.asarray(field).astype(dtype).astype(jnp.float32))
    got, exp = _march_vs_reference(
        field, eye, sampling, classification, ghost, dtype
    )
    assert exp[:, 3].max() > 0.05
    np.testing.assert_allclose(got, exp, atol=5e-5)
