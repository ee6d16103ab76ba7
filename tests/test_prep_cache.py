"""Host-prep caching/vectorization regression tests (VERDICT r2 #3).

prepare_slicemarch_scene now splits into a geometry pack (camera- and
LUT-independent, cached on the geometry), a LUT pack (cached per transfer
function), and a cheap per-frame stage.  Warm calls must return results
identical to cold calls, and the vectorized block extrema / cumcount must
match their loop-based definitions.
"""

import numpy as np
import pytest

from amrvolumerenderer_tpu import api
from amrvolumerenderer_tpu.renderer import (
    compute_global_bounds,
    compute_reference_sample_distance,
)
from amrvolumerenderer_tpu.renderer_fast import (
    _grouped_cumcount,
    _quad_extrema,
    prepare_slicemarch_scene,
)
from amrvolumerenderer_tpu.types import CameraParameters, RenderParameters


@pytest.fixture
def geometry(r2_scene):
    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    return api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)


def _prep(geometry, camera, sampling="nearest", color_map=None):
    params = RenderParameters(width=64, height=64, sampling=sampling)
    bounds = compute_global_bounds(geometry)
    rsd = compute_reference_sample_distance(geometry, bounds)
    return prepare_slicemarch_scene(
        geometry, params, camera, (0.0, 1.0), rsd, 64, 64, color_map
    )


def _assert_prep_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or hasattr(a[k], "shape"):
            np.testing.assert_array_equal(
                np.asarray(a[k]), np.asarray(b[k]), err_msg=k
            )
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("sampling", ["nearest", "trilinear"])
def test_warm_prep_identical_to_cold(geometry, sampling):
    cam = CameraParameters(
        eye=(0.5, 0.5, -2.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)
    )
    cold = _prep(geometry, cam, sampling)
    assert "_slicemarch_packs" in geometry.__dict__  # cache installed
    warm = _prep(geometry, cam, sampling)
    _assert_prep_equal(cold, warm)
    # a fresh geometry-equivalent cold run (cache cleared) also matches
    geometry.__dict__.pop("_slicemarch_packs")
    fresh = _prep(geometry, cam, sampling)
    _assert_prep_equal(cold, fresh)


def test_camera_change_reuses_pack_but_updates_frame_tables(geometry):
    cam1 = CameraParameters(
        eye=(0.5, 0.5, -2.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)
    )
    # opposite side of the scene, same dominant march axis: the pack is
    # reused but the per-frame ordering keys must flip (piece-level
    # visibility order — stable under small camera moves, reversed when
    # the view direction reverses)
    cam2 = CameraParameters(
        eye=(0.3, 0.8, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)
    )
    p1 = _prep(geometry, cam1)
    packs = geometry.__dict__["_slicemarch_packs"]
    assert len(packs) == 1
    p2 = _prep(geometry, cam2)
    assert len(packs) == 1  # same march axis -> same pack reused
    assert p1["vol"] is p2["vol"]  # zero-copy reuse of the brick table
    assert not np.array_equal(p1["cam"], p2["cam"])
    assert not np.array_equal(p1["depth_hints"], p2["depth_hints"])


def test_lut_change_rebuilds_bounds_only(geometry):
    from amrvolumerenderer_tpu.types import color_map_from_tuples

    cam = CameraParameters(
        eye=(0.5, 0.5, -2.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)
    )
    p1 = _prep(geometry, cam)
    cmap = color_map_from_tuples([
        (0.0, 0.0, 0.0, 1.0, 0.0), (0.6, 0.0, 0.0, 1.0, 0.0),
        (0.8, 1.0, 0.0, 0.0, 0.9), (1.0, 1.0, 0.0, 0.0, 0.9),
    ])
    p2 = _prep(geometry, cam, color_map=cmap)
    assert p1["vol"] is p2["vol"]  # geometry pack shared
    # transparent range below 0.6 -> tighter occupied-slice bounds somewhere
    assert not np.array_equal(p1["dims"][:, 7], p2["dims"][:, 7])
    np.testing.assert_array_equal(p1["dims"][:, :7], p2["dims"][:, :7])


def test_quad_extrema_matches_block_loops(rng):
    for su, sv in [(16, 16), (18, 13), (3, 34), (7, 2)]:
        stored = rng.normal(size=(5, su, sv)).astype(np.float32)
        qmin, qmax, bu, bv = _quad_extrema(stored, 4)
        ref_min = np.full((5, 4, 4), np.inf, np.float32)
        ref_max = np.full((5, 4, 4), -np.inf, np.float32)
        rbu, rbv = -(-su // 4), -(-sv // 4)
        assert (bu, bv) == (rbu, rbv)
        for a in range(4):
            for b in range(4):
                blk = stored[:, a * rbu: (a + 1) * rbu, b * rbv: (b + 1) * rbv]
                if blk.size:
                    ref_min[:, a, b] = blk.min(axis=(1, 2))
                    ref_max[:, a, b] = blk.max(axis=(1, 2))
        np.testing.assert_array_equal(qmin, ref_min)
        np.testing.assert_array_equal(qmax, ref_max)


def test_grouped_cumcount():
    owners = np.array([2, 0, 2, 2, 1, 0, 1, 2], np.int32)
    expect = []
    seen = {}
    for o in owners:
        expect.append(seen.get(int(o), 0))
        seen[int(o)] = expect[-1] + 1
    np.testing.assert_array_equal(_grouped_cumcount(owners), expect)
    np.testing.assert_array_equal(
        _grouped_cumcount(np.zeros(0, np.int32)), np.zeros(0, np.int32)
    )


class TestBatchedGeometryPack:
    """Uniform brick tables pack through the stacked fast path
    (_geometry_pack_batched, VERDICT r3 Weak #6): outputs must be
    byte-identical to the per-piece loop."""

    def _uniform_bricks(self, n=64, bs=16, dtype=np.float64):
        from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

        c = np.arange(n) / (n - 1)
        f = (
            c[:, None, None] ** 2 + c[None, :, None] ** 2
            + c[None, None, :] ** 2
        ).astype(dtype)
        f[3, 4, 5] = np.nan  # non-finite cells route through the same wash
        boxes = [
            LevelBox(f[i:i + bs, j:j + bs, k:k + bs],
                     np.array([i, j, k], dtype=int))
            for i in range(0, n, bs)
            for j in range(0, n, bs)
            for k in range(0, n, bs)
        ]
        geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]
        data = api.AmrData(level_data=[boxes], level_geometry=geoms)
        return api.load_amr_geometry(
            data, 0, -1, 0, False, True, verbose=False
        )

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("axis", [0, 2])
    def test_batched_matches_loop_bytewise(self, dtype, axis):
        from amrvolumerenderer_tpu import renderer_fast as rf

        geometry = self._uniform_bricks(dtype=dtype)
        axes = [axis] + [a for a in range(3) if a != axis]
        t = geometry.scalar_transform
        batched = rf._geometry_pack_batched(
            geometry.bricks, t, 0.0, False, axis, axes, 0, 8
        )
        assert batched is not None
        # loop oracle: run _geometry_pack with the batched path disabled
        import unittest.mock as mock

        with mock.patch.object(
            rf, "_geometry_pack_batched", lambda *a, **k: None
        ):
            gp_loop = rf._geometry_pack(geometry, axis, 0, 0.0, False)
        names = (
            "vol", "meta", "dims", "box_min", "box_max", "parents",
            "quad_min", "quad_max", "split_u", "split_v",
        )
        for name, got in zip(names, batched[:-1] if False else batched[:10]):
            np.testing.assert_array_equal(
                np.asarray(got), np.asarray(gp_loop[name]), err_msg=name
            )
        assert batched[10] == gp_loop["s_max"]

    def test_nonuniform_falls_back(self):
        """Mixed brick shapes must route to the loop (batched returns
        None), and the product entry still works."""
        from amrvolumerenderer_tpu import renderer_fast as rf
        from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

        f = np.random.default_rng(0).random((24, 16, 16))
        boxes = [
            LevelBox(f[:8], np.array([0, 0, 0])),
            LevelBox(f[8:], np.array([8, 0, 0])),  # different nx
        ]
        geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / 24))]
        data = api.AmrData(level_data=[boxes], level_geometry=geoms)
        geometry = api.load_amr_geometry(
            data, 0, -1, 0, False, True, verbose=False
        )
        axes = [0, 1, 2]
        out = rf._geometry_pack_batched(
            geometry.bricks, geometry.scalar_transform, 0.0, False, 0,
            axes, 0, 8,
        )
        assert out is None
        assert rf._geometry_pack(geometry, 0, 0, 0.0, False) is not None

    def test_ghost_falls_back(self):
        from amrvolumerenderer_tpu import renderer_fast as rf

        geometry = self._uniform_bricks(n=32, bs=16)
        out = rf._geometry_pack_batched(
            geometry.bricks, geometry.scalar_transform, 0.0, False, 0,
            [0, 1, 2], 1, 8,
        )
        assert out is None


def test_pretransform_f32_shortcut_is_exact():
    """The f32 identity-transform fast path must equal the f64 round-trip
    bitwise (f32 -> f64 -> f32 is exact; the shortcut only skips it),
    including non-finite washing and the soft-tail clip."""
    from amrvolumerenderer_tpu.renderer_fast import _pretransform
    from amrvolumerenderer_tpu.types import ScalarTransform

    rng = np.random.default_rng(3)
    data = rng.standard_normal((17, 9, 5)).astype(np.float32)
    data[0, 0, 0] = np.nan
    data[1, 2, 3] = np.inf
    data[2, 2, 2] = -np.inf
    ident = ScalarTransform(
        log_scale_input=False, positive_floor=1e-30,
        normalize_to_unit_range=False, normalization_min=0.0,
        inverse_normalization_span=1.0,
    )
    for clip, apply_clip in ((0.0, False), (0.6, True)):
        via_f64 = _pretransform(
            data.astype(np.float64).astype(np.float32), ident, clip,
            apply_clip,
        )
        # the f64 oracle, forced by handing it a f64 array
        oracle = _pretransform(
            data.astype(np.float64), ident, clip, apply_clip
        )
        got = _pretransform(data, ident, clip, apply_clip)
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_array_equal(got, via_f64)


def test_device_pretransform_one_program_per_shape():
    """In-situ ingestion sees a new data range every timestep: the device
    pretransform takes the range scalars as data, so new ranges reuse one
    compiled program per brick shape, and each agrees with the host
    pretransform."""
    import jax.numpy as jnp

    from amrvolumerenderer_tpu.device_scene import (
        _pretransform_device, _pretransform_jit,
    )
    from amrvolumerenderer_tpu.renderer_fast import _pretransform
    from amrvolumerenderer_tpu.types import ScalarTransform

    rng = np.random.default_rng(5)
    base = np.exp(rng.standard_normal((11, 7, 5)) * 3.0).astype(np.float32)
    base[0, 0, 0] = np.nan
    base[1, 1, 1] = 0.0
    compiled = None
    for step, scale in enumerate((1.0, 40.0, 0.002)):
        data = (base * np.float32(scale)).astype(np.float32)
        finite = data[np.isfinite(data) & (data > 0)]
        floor = float(finite.min())
        lo, hi = float(np.log(floor)), float(np.log(finite.max()))
        t = ScalarTransform(
            log_scale_input=True, positive_floor=floor,
            normalize_to_unit_range=True, normalization_min=lo,
            normalization_max=hi, inverse_normalization_span=1.0 / (hi - lo),
        )
        got = np.asarray(_pretransform_device(jnp.asarray(data), t, 0.6, True))
        np.testing.assert_allclose(got, _pretransform(data, t, 0.6, True),
                                   atol=1e-5)
        if compiled is None:
            compiled = _pretransform_jit._cache_size()
        assert _pretransform_jit._cache_size() == compiled, step


class TestNativePackSliceVolumes:
    """The native single-pass pack (avr_pack_slice_volumes, VERDICT r4 #2)
    must be byte-identical to the NumPy batched pipeline it replaces —
    including strided (non-contiguous view) inputs, both dtypes, non-finite
    cells, and nu*nv < SLICE_CELLS zero padding — and must decline the
    transforms it cannot reproduce bit-stably (log scale)."""

    def _numpy_batched(self, rf, bricks, t, axis, axes, nq):
        """Force the pure-NumPy batched pipeline as the oracle."""
        import unittest.mock as mock

        from amrvolumerenderer_tpu import native

        with mock.patch.object(
            native, "pack_slice_volumes", lambda *a, **k: None
        ):
            return rf._geometry_pack_batched(
                bricks, t, 0.0, False, axis, axes, 0, nq
            )

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("axis", [0, 1, 2])
    @pytest.mark.parametrize("normalize", [False, True])
    def test_native_matches_numpy_bytewise(self, dtype, axis, normalize):
        from amrvolumerenderer_tpu import native
        from amrvolumerenderer_tpu import renderer_fast as rf
        from amrvolumerenderer_tpu.types import Brick, ScalarTransform

        if native.get_lib() is None or not hasattr(
            native.get_lib(), "avr_pack_slice_volumes"
        ):
            pytest.skip("native library unavailable")
        rng = np.random.default_rng(11)
        # 24x20x12 bricks: nu*nv < 1024 on every axis -> padding exercised;
        # sliced views of one parent field -> strided, non-contiguous input
        field = (rng.standard_normal((48, 20, 12)) * 3).astype(dtype)
        field[0, 0, 0] = np.nan
        field[1, 2, 3] = np.inf
        field[30, 7, 7] = -np.inf
        bricks = [
            Brick(field[0:24], np.zeros(3), np.array([1.0, 0.8, 0.5])),
            Brick(field[24:48], np.array([1.0, 0.0, 0.0]),
                  np.array([2.0, 0.8, 0.5])),
        ]
        t = ScalarTransform(
            log_scale_input=False, positive_floor=1e-30,
            normalize_to_unit_range=normalize,
            normalization_min=-2.75,
            inverse_normalization_span=1.0 / 7.3,
        )
        axes = [axis] + [a for a in range(3) if a != axis]
        got = rf._geometry_pack_batched(bricks, t, 0.0, False, axis, axes, 0, 8)
        oracle = self._numpy_batched(rf, bricks, t, axis, axes, 8)
        assert got is not None and oracle is not None
        names = (
            "vol", "meta", "dims", "box_min", "box_max", "parents",
            "quad_min", "quad_max", "split_u", "split_v",
        )
        for name, g, o in zip(names, got, oracle):
            np.testing.assert_array_equal(
                np.asarray(g), np.asarray(o), err_msg=name
            )
        assert got[10] == oracle[10]
        # the native pass also folds the packed-slice extrema; the NumPy
        # batched path defers them (None) to _geometry_pack — compare
        # against that recompute
        n, s_max = got[0].shape[0], got[10]
        slice_min, slice_max = got[11], got[12]
        assert slice_min is not None
        core = np.asarray(got[0])
        np.testing.assert_array_equal(
            slice_min, core.reshape(n, s_max, -1).min(axis=2)
        )
        np.testing.assert_array_equal(
            slice_max, core.reshape(n, s_max, -1).max(axis=2)
        )

    def test_log_transform_declines_native(self):
        """np.log's SIMD kernel is not bit-stable against std::log; the
        native wrapper must return None so the NumPy path runs."""
        from amrvolumerenderer_tpu import native
        from amrvolumerenderer_tpu.types import ScalarTransform

        if native.get_lib() is None:
            pytest.skip("native library unavailable")
        t = ScalarTransform(
            log_scale_input=True, positive_floor=1e-30,
            normalize_to_unit_range=True, normalization_min=0.0,
            inverse_normalization_span=1.0,
        )
        arr = np.ones((4, 4, 4), np.float32)
        assert native.pack_slice_volumes([arr], [0, 1, 2], t, 8, 1024) is None

    def test_mixed_strides_decline_native(self):
        """Bricks with differing strides must fall back (the C entry takes
        one stride triple for the whole table)."""
        from amrvolumerenderer_tpu import native
        from amrvolumerenderer_tpu.types import ScalarTransform

        if native.get_lib() is None or not hasattr(
            native.get_lib(), "avr_pack_slice_volumes"
        ):
            pytest.skip("native library unavailable")
        t = ScalarTransform(
            log_scale_input=False, positive_floor=1e-30,
            normalize_to_unit_range=False, normalization_min=0.0,
            inverse_normalization_span=1.0,
        )
        a = np.zeros((8, 8, 8), np.float32)
        b = np.zeros((8, 8, 16), np.float32)[:, :, ::2]  # same shape, strided
        assert native.pack_slice_volumes([a, b], [0, 1, 2], t, 8, 1024) is None
