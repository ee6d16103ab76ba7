"""Visibility-permutation wiring: the rank order produced by
build_visibility_order feeds depth-hint tie-breaking in the layered fold.

The reference breaks depth-hint ties by communicator rank
(DirectSendBase.cpp:378-388) — ignoring the visibility ordering it just
computed.  This framework uses each owner's *position in the visibility
order* as the tie key (renderer_fast.visibility_owner_keys), which makes
the permutation consequential exactly where the hint is ambiguous.
"""

import numpy as np

from amrvolumerenderer_tpu.renderer_fast import (
    render_composited_slicemarch,
    visibility_owner_keys,
)
from amrvolumerenderer_tpu.types import (
    CameraParameters,
    RenderParameters,
    ScalarTransform,
    SceneGeometry,
    Brick,
)


def test_visibility_owner_keys_mapping():
    owners = np.array([0, 1, 2, 1], dtype=np.int32)
    # visibility order: rank 2 on top (front), then 0, then 1
    keys = visibility_owner_keys(owners, np.array([2, 0, 1]))
    np.testing.assert_array_equal(keys, [1, 2, 0, 2])


def test_visibility_owner_keys_identity_cases():
    owners = np.array([0, 1], dtype=np.int32)
    np.testing.assert_array_equal(visibility_owner_keys(owners, None), owners)
    np.testing.assert_array_equal(
        visibility_owner_keys(owners, np.array([0])), owners
    )
    # out-of-range owners pass through unchanged
    keys = visibility_owner_keys(np.array([0, 7]), np.array([1, 0]))
    np.testing.assert_array_equal(keys, [1, 7])


def _tied_scene():
    """Two *coincident* bricks with different fields owned by ranks 0 and 1:
    identical boxes mean tied depth hints AND tied per-pixel depths, so the
    blend order — and therefore the image — is decided purely by the
    owner tie-break key."""
    shape = (8, 8, 8)
    lo = np.full(shape, 0.15, np.float32)
    hi = np.full(shape, 0.85, np.float32)
    bricks = [
        Brick(lo, (0, 0, 0), (1, 1, 1), owner=0),
        Brick(hi, (0, 0, 0), (1, 1, 1), owner=1),
    ]
    geometry = SceneGeometry(
        bricks=bricks,
        scalar_range=(0.0, 1.0),
        has_scalar_range=True,
        scalar_transform=ScalarTransform(),
    )
    camera = CameraParameters(
        eye=(0.5, 0.5, 4.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
        fov_y_degrees=45.0, near_plane=0.1, far_plane=20.0,
    )
    return geometry, camera


def _render(geometry, camera, rank_order):
    return render_composited_slicemarch(
        geometry,
        RenderParameters(width=32, height=32),
        camera,
        (0.0, 1.0),
        0.0625,  # half the 1/8 spacing
        32,
        32,
        None,
        rank_order=rank_order,
    )


def test_tied_hints_graph_order_changes_image(monkeypatch):
    # the rank-order tie-break only matters on the scalar-HINT fallback:
    # piece-level visibility keys (visibility.piece_order_keys) are unique
    # positions with no ties, so force the fallback path here to keep the
    # tie-break wiring itself validated
    import amrvolumerenderer_tpu.visibility as vis

    monkeypatch.setattr(vis, "piece_order_keys", lambda *a, **k: None)
    geometry, camera = _tied_scene()

    default = _render(geometry, camera, None)
    identity = _render(geometry, camera, np.array([0, 1]))
    flipped = _render(geometry, camera, np.array([1, 0]))

    # identity permutation reproduces the unwired fold
    np.testing.assert_array_equal(default, identity)
    # graph order changes the image on tied hints
    assert np.abs(default[:, :3] - flipped[:, :3]).max() > 0.01

    # flipped graph order == physically swapping the owners
    for b, owner in zip(geometry.bricks, (1, 0)):
        b.owner = owner
    swapped = _render(geometry, camera, None)
    np.testing.assert_allclose(flipped, swapped, atol=1e-6)
