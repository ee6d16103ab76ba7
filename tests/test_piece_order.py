"""Piece-level visibility ordering (visibility.piece_order_keys).

Scalar depth hints are only a PROXY for per-ray traversal order; the
sequential entry-depth fold is exact only when the layer sort order
matches every ray's traversal order.  On the 3-level convexified AMR
bench scene the hint order misplaced an interleaved piece and the
composited frame was off by up to 0.48 (64^2) / 0.82 (128^2) max RGB at
a handful of pixels — found by folding every piece's per-pixel (depth,
rgba) contribution in exact per-pixel depth order and comparing.

The fix applies the reference's own visibility-graph machinery
(VisibilityOrdering.cpp:261-317, which the reference computes but uses
only at RANK granularity) at PIECE granularity: convexified pieces tile
the domain, so the face-adjacency graph yields an exact view-consistent
total order.  These tests pin that exactness and the graph's polarity.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from amrvolumerenderer_tpu.camera import auto_orbit_camera, camera_basis
from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
from amrvolumerenderer_tpu.ops import slicemarch as sm
from amrvolumerenderer_tpu.types import CameraParameters, RenderParameters
from amrvolumerenderer_tpu.visibility import piece_order_keys


def three_level_geometry():
    """The bench scene: 64^3 base + two 2x refinements, convexified (the
    configuration that exposed the hint misordering)."""
    import os
    import sys

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    from bench import build_three_level_scene

    return build_three_level_scene()


def exact_depth_fold(fsr, cam):
    """Ground truth for layered compositing of the renderer's own pieces:
    every piece's per-pixel (depth, rgba) layer, folded front-to-back in
    EXACT per-pixel depth order (a full per-pixel sort — unambiguous, and
    far too slow for production)."""
    forward, right, up = camera_basis(cam)
    axis = sm.choose_march_axis(forward)
    fsr.frame_inputs(cam)  # packs the march axis
    meta, dims = fsr._axis_metadata(axis)
    campk = fsr._pack_cam(cam, forward, right, up)
    luts = jnp.broadcast_to(
        fsr._lut_device[None], (meta.shape[0],) + fsr._lut_device.shape
    )
    colors, depths = sm.slicemarch_render(
        fsr._packed_vol, jnp.asarray(meta), jnp.asarray(dims), luts,
        jnp.asarray(campk), width=fsr.pad_w, height=fsr.pad_h,
        max_slices=fsr.cube, logical_width=fsr.render_width,
        logical_height=fsr.render_height,
        sampling=fsr.parameters.sampling, ghost=fsr.ghost,
        classification=fsr.parameters.classification,
    )
    c = np.asarray(colors)
    d = np.asarray(depths)
    num_layers, num_pixels = d.shape
    order = np.argsort(np.where(np.isfinite(d), d, np.inf), axis=0,
                       kind="stable")
    cs = np.take_along_axis(c, order[..., None], axis=0)
    valid = np.take_along_axis(np.isfinite(d), order, axis=0)
    out = np.zeros((num_pixels, 4), np.float32)
    acc = np.zeros(num_pixels, np.float32)
    for l in range(num_layers):
        w = (1 - acc) * valid[l]
        out[:, :3] += w[:, None] * cs[l, :, :3]
        out[:, 3] += w * cs[l, :, 3]
        acc = out[:, 3]
    res = fsr.parameters.width
    return out.reshape(fsr.pad_h, fsr.pad_w, 4)[:res, :res].reshape(-1, 4)


def test_graph_order_polarity():
    """build_visibility_order returns BACK-to-front; piece_order_keys must
    flip it so smaller key = nearer the eye = folded in front."""
    bmin = np.array([[0, 0, 0], [0, 0, 1]], float)
    bmax = np.array([[1, 1, 1], [1, 1, 2]], float)
    cam = CameraParameters(
        eye=(0.5, 0.5, 3.0), look_at=(0.5, 0.5, 0.0), up=(0, 1, 0)
    )
    keys = piece_order_keys(cam, 1.0, bmin, bmax)
    assert keys is not None
    assert keys[1] < keys[0]  # box 1 is nearer the eye


def test_fast_scene_matches_exact_depth_fold():
    """The product tilemarch fold over visibility-ordered pieces must
    reproduce the exact per-pixel depth fold (hint ordering was off by
    0.48 max RGB on this very scene/camera)."""
    g = three_level_geometry()
    fsr = FastSceneRenderer(g, RenderParameters(width=64, height=64))
    cam = auto_orbit_camera(fsr.bounds)
    frame = fsr.render(cam, overlay=False)
    truth = exact_depth_fold(fsr, cam)
    np.testing.assert_allclose(frame[:, :4], truth, atol=2e-5)


def test_hint_fallback_still_renders(monkeypatch):
    """With the graph unavailable the hint fallback must keep rendering
    (values differ only at misordered pixels)."""
    import amrvolumerenderer_tpu.visibility as vis

    g = three_level_geometry()
    fsr = FastSceneRenderer(g, RenderParameters(width=32, height=32))
    cam = auto_orbit_camera(fsr.bounds)
    with_graph = fsr.render(cam, overlay=False)
    monkeypatch.setattr(vis, "piece_order_keys", lambda *a, **k: None)
    import amrvolumerenderer_tpu.fast_scene  # noqa: F401 (site imports late)

    without = fsr.render(cam, overlay=False)
    assert np.isfinite(without[:, :4]).all()
    # both are valid composites; they agree except where hints misorder
    d = np.abs(with_graph[:, :3] - without[:, :3])
    assert (d.max(axis=1) > 0.02).mean() < 0.02


def test_hierarchical_keys_match_exact_fold(monkeypatch):
    """Deep-scene tier: when the flat piece graph is over
    PIECE_GRAPH_LIMIT, the brick-level graph x within-brick slab-shell
    keys (visibility.hierarchical_order_keys) must still reproduce the
    exact per-pixel depth fold — forced here by shrinking the limit
    between the parent and piece counts."""
    import amrvolumerenderer_tpu.visibility as vis

    g = three_level_geometry()
    fsr = FastSceneRenderer(g, RenderParameters(width=64, height=64))
    n_pieces = len(fsr.parents)
    n_parents = len(g.bricks)
    assert n_parents < n_pieces  # scene must exercise both levels

    used = []
    orig = vis.hierarchical_order_keys

    def spy(*a, **k):
        r = orig(*a, **k)
        used.append(r is not None)
        return r

    monkeypatch.setattr(vis, "PIECE_GRAPH_LIMIT", n_parents)
    monkeypatch.setattr(vis, "hierarchical_order_keys", spy)
    for cam in (
        auto_orbit_camera(fsr.bounds),
        CameraParameters(
            eye=(-1.1, 1.7, -0.9), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)
        ),  # oblique, negative components
    ):
        frame = fsr.render(cam, overlay=False)
        assert used and all(used)  # the hierarchical tier actually ran
        truth = exact_depth_fold(fsr, cam)
        np.testing.assert_allclose(frame[:, :4], truth, atol=2e-5)


def test_no_visibility_graph_flag_disables_piece_keys(monkeypatch):
    """--no-visibility-graph (RenderParameters.use_visibility_graph=False)
    must skip the graph build entirely — the user opted out of its cost
    and its ordering."""
    import amrvolumerenderer_tpu.visibility as vis

    calls = []
    orig = vis.piece_order_keys

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(vis, "piece_order_keys", spy)
    g = three_level_geometry()
    fsr = FastSceneRenderer(
        g, RenderParameters(width=32, height=32, use_visibility_graph=False)
    )
    fsr.frame_inputs(auto_orbit_camera(fsr.bounds))
    assert not calls
    fsr_on = FastSceneRenderer(g, RenderParameters(width=32, height=32))
    fsr_on.frame_inputs(auto_orbit_camera(fsr_on.bounds))
    assert calls


def test_one_shot_paths_agree_with_fast_scene():
    """With piece-level ordering both product families (one-shot layered
    slicemarch and the persistent tilemarch path) fold the same order:
    they agreed only to 0.48 before the fix."""
    from amrvolumerenderer_tpu.renderer_fast import (
        render_composited_slicemarch,
    )

    g = three_level_geometry()
    params = RenderParameters(width=64, height=64)
    fsr = FastSceneRenderer(g, params)
    cam = auto_orbit_camera(fsr.bounds)
    ft = fsr.render(cam, overlay=False)
    one = render_composited_slicemarch(
        g, params, cam, fsr.scalar_range, fsr.reference_sample_distance,
        64, 64, None,
    )
    np.testing.assert_allclose(ft[:, :3], one[:, :3], atol=2e-5)


class TestPerRayConsistency:
    """Round-4 upgrade: eye-side-of-plane edge orientation makes the
    piece order EXACT for perspective cameras — for every sampled ray,
    the pieces it crosses must appear in the global order by increasing
    entry distance.  The reference's sign(view_dir) predicate fails this
    for cameras level with the scene (view_dir zero on an axis emits no
    edges there; observed 0.18 RGB divergence between fold structures)."""

    @staticmethod
    def _ray_entries(eye, dirs, lo, hi):
        """Entry/exit t of each ray (row) against each box (col), slab
        method; t_in > t_out (or t_out < 0) means miss."""
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dirs  # [R, 3]
            t0 = (lo[None, :, :] - eye) * inv[:, None, :]
            t1 = (hi[None, :, :] - eye) * inv[:, None, :]
        t_in = np.minimum(t0, t1).max(axis=2)
        t_out = np.maximum(t0, t1).min(axis=2)
        return t_in, t_out

    @pytest.mark.parametrize("eye", [
        (3.1, 0.5, 0.4),      # view_dir.y == 0: the old failure class
        (2.5, 2.5, 2.5),      # generic diagonal
        (0.52, 0.48, 3.0),    # nearly axis-aligned
        (0.31, 0.52, 0.47),   # eye INSIDE the domain
        (-1.0, 0.5, 0.5),     # exactly level on two axes
    ])
    def test_keys_monotone_along_rays(self, eye):
        g = 6
        ax = np.arange(g) / g
        lo = np.stack(
            np.meshgrid(ax, ax, ax, indexing="ij"), -1
        ).reshape(-1, 3)
        hi = lo + 1.0 / g
        cam = CameraParameters(
            eye=eye, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
            fov_y_degrees=45.0, near_plane=0.01, far_plane=50.0,
        )
        keys = piece_order_keys(cam, 1.0, lo, hi)
        assert keys is not None
        forward, right, up = camera_basis(cam)
        rng = np.random.default_rng(11)
        px = rng.uniform(-1, 1, (1024, 2))
        tan_half = np.tan(np.radians(cam.fov_y_degrees) * 0.5)
        dirs = (
            np.asarray(forward)[None]
            + (px[:, :1] * tan_half) * np.asarray(right)[None]
            + (px[:, 1:] * tan_half) * np.asarray(up)[None]
        )
        t_in, t_out = self._ray_entries(
            np.asarray(eye, float), dirs, lo, hi
        )
        checked = 0
        eps = 1e-9
        for r in range(len(dirs)):
            # interior crossings only: skip grazes (shared-edge contact)
            hit = (t_out[r] - t_in[r] > 1e-7) & (t_out[r] > eps)
            if hit.sum() < 2:
                continue
            entry = np.maximum(t_in[r][hit], 0.0)
            k = keys[hit]
            order = np.argsort(entry, kind="stable")
            assert (np.diff(k[order]) > 0).all(), (
                f"ray {r}: key order disagrees with entry order\n"
                f"entries {entry[order]}\nkeys {k[order]}"
            )
            checked += 1
        # distant eyes aim most rays past the unit domain; what matters
        # is that every multi-piece ray checked out, over a solid sample
        assert checked > 100
