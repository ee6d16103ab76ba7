"""Ghost-cell rings: seam-free trilinear sampling across split-piece
boundaries.

The reference never splits bricks (one VolumePainter launch per AmrBox,
Common/VolumePainter.cpp:548), so its nearest-sampling has no seams to
worry about.  This framework splits bricks to fit the [8, 128] vreg slice
layout; trilinear sampling used to clamp interpolation at piece edges
(C0 seams).  A 1-cell ghost ring — neighbor data of the same brick at
split boundaries, neighbor-BRICK data at brick faces (ghost.ghost_fill),
edge-replicated at the domain exterior — makes any piece decomposition
render identically to the unsplit brick, and abutting bricks render
identically to their unsplit union.
"""

import numpy as np
import pytest

from amrvolumerenderer_tpu.camera import camera_basis
from amrvolumerenderer_tpu.colormap import build_color_table
from amrvolumerenderer_tpu.ops import slicemarch as sm
from amrvolumerenderer_tpu.types import (
    Brick,
    CameraParameters,
    RenderParameters,
    SceneGeometry,
)


def _identity_geometry(field_bricks):
    """SceneGeometry with the identity scalar transform ([0,1] data)."""
    geometry = SceneGeometry()
    for data, mn, mx in field_bricks:
        geometry.bricks.append(
            Brick(data=np.asarray(data, np.float32), min_corner=mn,
                  max_corner=mx)
        )
    geometry.scalar_range = (0.0, 1.0)
    geometry.has_scalar_range = True
    return geometry


class TestGhostExtraction:
    def test_split_to_cubes_ghost_ring(self):
        """Interior ghost cells carry neighbor data; faces edge-replicate."""
        from amrvolumerenderer_tpu.fast_scene import _split_to_cubes

        rng = np.random.default_rng(3)
        data = rng.random((8, 5, 5)).astype(np.float32)
        pieces = _split_to_cubes(data, np.zeros(3), np.ones(3), 4, ghost=1)
        assert len(pieces) == 2 * 2 * 2
        # first piece: core [0:4, 0:4, 0:4], stored with ring -> shape 6
        block, mn, mx, dims = pieces[0]
        assert block.shape == (6, 6, 6)
        assert tuple(dims) == (4, 4, 4)
        # core matches
        np.testing.assert_array_equal(block[1:5, 1:5, 1:5], data[0:4, 0:4, 0:4])
        # high-side ghost plane = neighbor data from the second half
        np.testing.assert_array_equal(block[5, 1:5, 1:5], data[4, 0:4, 0:4])
        # low-side ghost plane at the true brick face = edge replication
        np.testing.assert_array_equal(block[0, 1:5, 1:5], data[0, 0:4, 0:4])
        # a ragged piece: core [4:8, 4:5, 4:5] -> stored (6, 3, 3)
        block, _mn, _mx, dims = pieces[-1]
        assert block.shape == (6, 3, 3)
        assert tuple(dims) == (4, 1, 1)
        np.testing.assert_array_equal(block[1:5, 1, 1], data[4:8, 4, 4])
        # low ghost plane reaches back into the first half
        np.testing.assert_array_equal(block[0, 1, 1], data[3, 4, 4])

    def test_split_to_cubes_ghost_zero_is_view(self):
        from amrvolumerenderer_tpu.fast_scene import _split_to_cubes

        data = np.arange(4 * 4 * 4, dtype=np.float32).reshape(4, 4, 4)
        pieces = _split_to_cubes(data, np.zeros(3), np.ones(3), 4, ghost=0)
        assert len(pieces) == 1
        block, mn, mx, dims = pieces[0]
        assert np.shares_memory(block, data)
        assert tuple(dims) == (4, 4, 4)

    def test_split_brick_for_slices_ghost_ring(self):
        rng = np.random.default_rng(5)
        data = rng.random((8, 40, 40)).astype(np.float32)
        # (40+2)*(40+2) > 1024 forces one transverse split (axis=0 march)
        pieces = sm.split_brick_for_slices(
            data, np.zeros(3), np.ones(3), axis=0, ghost=1
        )
        assert len(pieces) == 2
        d0, mn0, mx0 = pieces[0]
        d1, mn1, mx1 = pieces[1]
        assert d0.shape == (10, 22, 42)
        assert mx0[1] == pytest.approx(0.5)
        assert mn1[1] == pytest.approx(0.5)
        # piece 0 core = data[:, 0:20, :]; its high-u ghost row is data row 20
        np.testing.assert_array_equal(d0[1:9, 1:21, 1:41], data[:, 0:20, :])
        np.testing.assert_array_equal(d0[1:9, 21, 1:41], data[:, 20, :])
        # piece 1 low-u ghost row reaches back into piece 0's core
        np.testing.assert_array_equal(d1[1:9, 0, 1:41], data[:, 19, :])
        # true brick faces edge-replicate (clamping semantics preserved)
        np.testing.assert_array_equal(d0[0], d0[1])
        np.testing.assert_array_equal(d0[1:9, 1:21, 0], d0[1:9, 1:21, 1])

    def test_pack_slice_volume_ghost_dims(self):
        rng = np.random.default_rng(6)
        ghosted = rng.random((10, 22, 42)).astype(np.float32)
        vol, (ns, nu, nv) = sm.pack_slice_volume(ghosted, axis=0, ghost=1)
        assert (ns, nu, nv) == (8, 20, 40)
        assert vol.shape == (10, sm.SUBLANES, sm.LANES)
        # stored core cell (k, u, v) at flat (u+1) * 42 + (v+1), slice k+1
        flat = vol.reshape(10, -1)
        assert flat[3, 5 * 42 + 7] == ghosted[3, 5, 7]


class TestSeamFreeTrilinear:
    """Any piece decomposition of a brick renders like the unsplit brick."""

    W = H = 64
    N = 40

    def _setup(self):
        rng = np.random.default_rng(7)
        field = rng.random((self.N, self.N, self.N)).astype(np.float32)
        camera = CameraParameters(
            eye=(0.9, 0.7, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
        )
        forward, right, up = camera_basis(camera)
        axis = sm.choose_march_axis(forward)
        assert axis == 2  # the split below assumes a -z march
        lut = build_color_table(1.0, 1.0, (0.0, 1.0), None)
        rd = 0.5 / self.N
        oracle_c, _ = sm.slicemarch_reference(
            field, np.zeros(3), np.ones(3), axis, lut, rd,
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees, self.W, self.H, sampling="trilinear",
        )
        return field, camera, rd, oracle_c

    def _render(self, geometry, camera, rd):
        from amrvolumerenderer_tpu.renderer_fast import (
            render_composited_slicemarch,
        )

        params = RenderParameters(
            width=self.W, height=self.H, sampling="trilinear"
        )
        frame = render_composited_slicemarch(
            geometry, params, camera, (0.0, 1.0), rd, self.W, self.H, None,
        )
        return frame[:, :4]

    def test_split_pieces_match_unsplit_oracle(self):
        """The work-list path transverse-splits 40^2 slices; with ghost
        rings the composited trilinear frame equals the unsplit-brick
        oracle (f64) to the same tolerance as the single-piece kernel."""
        field, camera, rd, oracle_c = self._setup()
        got = self._render(
            _identity_geometry([(field, np.zeros(3), np.ones(3))]), camera, rd
        )
        diff = np.abs(got - oracle_c)
        # f32-vs-f64 LUT-bin straddle on isolated pixels, like
        # test_slicemarch.TestTrilinear.test_kernel_matches_numpy_oracle
        assert np.quantile(diff, 0.999) < 1e-4
        assert diff.max() < 1e-2

    def test_cross_brick_boundary_seam_free(self):
        """The same field pre-split into two BRICKS renders like the
        unsplit oracle: ghost.ghost_fill gives each brick's ring the
        neighbor brick's lattice-aligned values, so the interpolated field
        is bit-identical to the unsplit brick's (before this wiring the
        shared face edge-replicated and the seam error exceeded 0.02)."""
        field, camera, rd, oracle_c = self._setup()
        half = self.N // 2
        two_bricks = _identity_geometry([
            (field[:half], np.zeros(3), np.array([0.5, 1.0, 1.0])),
            (field[half:], np.array([0.5, 0.0, 0.0]), np.ones(3)),
        ])
        got = self._render(two_bricks, camera, rd)
        diff = np.abs(got - oracle_c)
        assert np.quantile(diff, 0.999) < 1e-4
        assert diff.max() < 1e-2

    def test_cross_brick_fast_scene_seam_free(self):
        """FastSceneRenderer's cube decomposition of two abutting bricks
        also matches the unsplit oracle (the fill happens before the cube
        split, so piece rings inherit neighbor-brick data)."""
        from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer

        field, camera, rd, oracle_c = self._setup()
        half = self.N // 2
        two_bricks = _identity_geometry([
            (field[:half], np.zeros(3), np.array([0.5, 1.0, 1.0])),
            (field[half:], np.array([0.5, 0.0, 0.0]), np.ones(3)),
        ])
        params = RenderParameters(
            width=self.W, height=self.H, sampling="trilinear"
        )
        fast = FastSceneRenderer(two_bricks, params)
        frame = fast.render(camera, overlay=False)
        diff = np.abs(frame[:, :4] - oracle_c)
        assert np.quantile(diff, 0.99) < 1e-4
        assert diff.max() < 5e-3

    def test_fast_scene_cube_split_matches_worklist_split(self):
        """FastSceneRenderer's 30^3-core cube decomposition and the
        work-list path's transverse decomposition are DIFFERENT split
        layouts; with ghost rings both render the same image."""
        from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer

        field, camera, rd, oracle_c = self._setup()
        geometry = _identity_geometry([(field, np.zeros(3), np.ones(3))])
        params = RenderParameters(
            width=self.W, height=self.H, sampling="trilinear"
        )
        fast = FastSceneRenderer(geometry, params)
        assert fast.ghost == 1 and fast.core == 30
        assert fast.canonical.shape[0] == 8  # ceil(40/30)^3
        frame = fast.render(camera, overlay=False)
        diff = np.abs(frame[:, :4] - oracle_c)
        # a handful of isolated pixels straddle a LUT bin (the cube pieces
        # compute (pos - pmin) / cell with different fp association than
        # the unsplit oracle); a real seam reads > 0.02 along a full line
        # (see test_cross_brick_boundary_still_clamps)
        assert np.quantile(diff, 0.99) < 1e-4
        assert diff.max() < 5e-3

    def test_nearest_packing_unchanged(self):
        """ghost stays 0 for nearest sampling (no perf or layout change)."""
        from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
        from amrvolumerenderer_tpu.renderer_fast import (
            prepare_slicemarch_scene,
        )

        field, camera, rd, _ = self._setup()
        geometry = _identity_geometry([(field, np.zeros(3), np.ones(3))])
        params = RenderParameters(width=self.W, height=self.H)
        prep = prepare_slicemarch_scene(
            geometry, params, camera, (0.0, 1.0), rd, self.W, self.H, None
        )
        assert prep["ghost"] == 0
        fast = FastSceneRenderer(geometry, params)
        assert fast.ghost == 0 and fast.core == 32


class TestGhostFill:
    """Unit semantics of ghost.ghost_fill (cross-brick ring filling)."""

    def test_same_level_abutting_bricks_exact(self):
        """Rings at the shared face carry the neighbor's exact cell values
        (same-level bricks are lattice-aligned after convexify); rings at
        the domain exterior stay edge-replicated."""
        from amrvolumerenderer_tpu.ghost import ghost_fill

        rng = np.random.default_rng(11)
        a = rng.random((4, 4, 4)).astype(np.float32)
        b = rng.random((4, 4, 4)).astype(np.float32)
        boxes = [
            (np.zeros(3), np.array([1.0, 1.0, 1.0])),
            (np.array([1.0, 0.0, 0.0]), np.array([2.0, 1.0, 1.0])),
        ]
        pa, pb = ghost_fill([a, b], boxes, ghost=1)
        assert pa.shape == (6, 6, 6)
        # cores untouched
        np.testing.assert_array_equal(pa[1:5, 1:5, 1:5], a)
        np.testing.assert_array_equal(pb[1:5, 1:5, 1:5], b)
        # a's high-x ring plane = b's first x-plane (core region)
        np.testing.assert_array_equal(pa[5, 1:5, 1:5], b[0])
        # b's low-x ring plane = a's last x-plane
        np.testing.assert_array_equal(pb[0, 1:5, 1:5], a[3])
        # domain-exterior faces stay edge-replicated
        np.testing.assert_array_equal(pa[0, 1:5, 1:5], a[0])
        np.testing.assert_array_equal(pa[1:5, 0, 1:5], a[:, 0])
        np.testing.assert_array_equal(pb[5, 1:5, 1:5], b[3])
        # ring corners outside both bricks also edge-replicate
        assert pa[0, 0, 0] == a[0, 0, 0]

    def test_coarse_fine_boundary_nearest_samples_neighbor(self):
        """A coarse brick's ring cell inside a finer neighbor takes the
        fine brick's nearest cell (the center-containing fine cell)."""
        from amrvolumerenderer_tpu.ghost import ghost_fill

        rng = np.random.default_rng(13)
        coarse = rng.random((4, 4, 4)).astype(np.float32)  # span 0.25
        fine = rng.random((8, 8, 8)).astype(np.float32)    # span 0.125
        boxes = [
            (np.zeros(3), np.ones(3)),
            (np.array([1.0, 0.0, 0.0]), np.array([2.0, 1.0, 1.0])),
        ]
        pc, pf = ghost_fill([coarse, fine], boxes, ghost=1)
        # coarse ring cell (x=1.125, y=(j+0.5)*0.25, z=(k+0.5)*0.25) lands in
        # fine cell (1, floor(y/0.125), floor(z/0.125)) = (1, 2j+1, 2k+1)
        for j in range(4):
            for k in range(4):
                assert pc[5, 1 + j, 1 + k] == fine[1, 2 * j + 1, 2 * k + 1]
        # fine ring cell (x=1-0.0625, (j+0.5)*0.125, ...) lands in coarse
        # cell (3, floor(y/0.25), floor(z/0.25)) = (3, j//2, k//2)
        for j in range(8):
            for k in range(8):
                assert pf[0, 1 + j, 1 + k] == coarse[3, j // 2, k // 2]

    def test_jnp_bricks_match_numpy_fill(self):
        """Device (jnp) brick arrays fill identically to the host path."""
        import jax.numpy as jnp

        from amrvolumerenderer_tpu.ghost import ghost_fill

        rng = np.random.default_rng(17)
        a = rng.random((4, 4, 4)).astype(np.float32)
        b = rng.random((4, 4, 4)).astype(np.float32)
        boxes = [
            (np.zeros(3), np.ones(3)),
            (np.array([0.0, 1.0, 0.0]), np.array([1.0, 2.0, 1.0])),
        ]
        host = ghost_fill([a, b], boxes, ghost=1)
        dev = ghost_fill([jnp.asarray(a), jnp.asarray(b)], boxes, ghost=1)
        for h, d in zip(host, dev):
            assert isinstance(d, jnp.ndarray)
            np.testing.assert_array_equal(h, np.asarray(d))

    def test_diagonal_only_neighbor_fills_corner(self):
        """Bricks sharing only an edge/corner still fill the overlapping
        ring cells (the slab decomposition covers corners once)."""
        from amrvolumerenderer_tpu.ghost import ghost_fill

        rng = np.random.default_rng(19)
        a = rng.random((4, 4, 4)).astype(np.float32)
        b = rng.random((4, 4, 4)).astype(np.float32)
        boxes = [
            (np.zeros(3), np.ones(3)),
            (np.array([1.0, 1.0, 0.0]), np.array([2.0, 2.0, 1.0])),
        ]
        pa, _pb = ghost_fill([a, b], boxes, ghost=1)
        # the (x-high, y-high) ring edge cells lie inside b
        np.testing.assert_array_equal(pa[5, 5, 1:5], b[0, 0])
        # but the x-high face interior is NOT inside b -> edge-replicated
        np.testing.assert_array_equal(pa[5, 1:5, 1:5], a[3])


class TestPreClassificationSeams:
    """Ghost rings keep PRE-classification seam-free too: corner samples
    reach into neighbor data, so classified-channel interpolation matches
    the unsplit brick across piece and brick boundaries."""

    def test_cross_brick_pre_classification_seam_free(self):
        from amrvolumerenderer_tpu.renderer_fast import (
            render_composited_slicemarch,
        )
        from amrvolumerenderer_tpu.camera import camera_basis

        N = 40
        W = H = 64
        rng = np.random.default_rng(41)
        field = rng.random((N, N, N)).astype(np.float32)
        camera = CameraParameters(
            eye=(0.9, 0.7, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
        )
        forward, right, up = camera_basis(camera)
        axis = sm.choose_march_axis(forward)
        lut = build_color_table(1.0, 1.0, (0.0, 1.0), None)
        rd = 0.5 / N
        oracle_c, _ = sm.slicemarch_reference(
            field, np.zeros(3), np.ones(3), axis, lut, rd,
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees, W, H, sampling="trilinear",
            classification="pre",
        )
        half = N // 2
        two_bricks = _identity_geometry([
            (field[:half], np.zeros(3), np.array([0.5, 1.0, 1.0])),
            (field[half:], np.array([0.5, 0.0, 0.0]), np.ones(3)),
        ])
        params = RenderParameters(
            width=W, height=H, sampling="trilinear", classification="pre",
        )
        frame = render_composited_slicemarch(
            two_bricks, params, camera, (0.0, 1.0), rd, W, H, None,
        )
        diff = np.abs(frame[:, :4] - oracle_c)
        assert np.quantile(diff, 0.995) < 1e-3
        assert diff.max() < 5e-2
