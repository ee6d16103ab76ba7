"""Multi-device compositing tests on the virtual 8-device CPU mesh.

The JAX equivalent of the reference's multi-rank compositing matrix
(CMake/amrVolumeRendererMacros.cmake:150-178 intent): validate that the
sharded all_to_all direct-send pipeline reproduces the single-device fold
bit-for-bit across rank counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amrvolumerenderer_tpu.compositor import composite_layers_host
from amrvolumerenderer_tpu.parallel.directsend import (
    composite_layers_sharded,
    composite_layers_sharded_preblend,
    make_mesh,
    preblend_plan,
)


def make_device_layers(rng, num_devices, lmax, num_pixels):
    """Per-device layers with some invalid (padding) slots."""
    total = num_devices * lmax
    layers = np.zeros((total, num_pixels, 5), dtype=np.float32)
    alpha = (rng.random((total, num_pixels)) * 0.9).astype(np.float32)
    rgb = rng.random((total, num_pixels, 3)).astype(np.float32)
    layers[..., :3] = rgb * alpha[..., None]
    layers[..., 3] = alpha
    layers[..., 4] = (rng.random((total, num_pixels)) * 8).astype(np.float32)
    hints = (rng.random(total) * 5).astype(np.float32)
    # mark some slots invalid: cleared content + inf hint
    valid = rng.random(total) > 0.25
    cleared = np.zeros((num_pixels, 5), dtype=np.float32)
    cleared[:, 4] = np.inf
    layers[~valid] = cleared
    hints[~valid] = np.inf
    return layers, hints, valid


@pytest.mark.parametrize("num_devices", [2, 4, 8])
def test_sharded_composite_matches_host(num_devices):
    if len(jax.devices()) < num_devices:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(42 + num_devices)
    lmax, num_pixels = 3, 64  # 64 divisible by 8
    layers, hints, valid = make_device_layers(rng, num_devices, lmax, num_pixels)

    mesh = make_mesh(num_devices)
    got = np.asarray(
        composite_layers_sharded(mesh, jnp.asarray(layers), jnp.asarray(hints))
    )

    owners = np.repeat(np.arange(num_devices, dtype=np.int32), lmax)
    local = np.tile(np.arange(lmax, dtype=np.int32), num_devices)
    expected = composite_layers_host(layers, hints, owners, local)
    np.testing.assert_allclose(got, expected, atol=1e-5)


@pytest.mark.parametrize("num_devices", [2, 8])
@pytest.mark.parametrize("ties", [False, True])
def test_preblend_composite_bitwise_equal(num_devices, ties):
    """The run pre-blend before the exchange (the reference's
    composeLayered pre-blend, DirectSendBase.cpp:418-425) leaves the fold
    TREE unchanged, so its output must be bitwise equal to the
    non-pre-blended exchange — including on exact depth-hint ties, where
    the (owner, local) tie-break defines the runs."""
    if len(jax.devices()) < num_devices:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(7 + num_devices + ties)
    lmax, num_pixels = 5, 64
    layers, hints, valid = make_device_layers(
        rng, num_devices, lmax, num_pixels
    )
    if ties:
        hints[valid] = np.round(hints[valid] * 2) / 2  # force exact ties
    mesh = make_mesh(num_devices)
    base = np.asarray(
        composite_layers_sharded(mesh, jnp.asarray(layers), jnp.asarray(hints))
    )
    pre = np.asarray(
        composite_layers_sharded_preblend(mesh, jnp.asarray(layers), hints)
    )
    np.testing.assert_array_equal(pre, base)


def test_preblend_plan_structure():
    """The plan must cut the global (hint, owner, local) order into
    maximal same-device runs: run count = number of owner changes + 1,
    fold order per device = its global-order restriction."""
    hints = np.array([
        [0.0, 2.0, 4.0],   # device 0
        [1.0, 3.0, np.inf],  # device 1 (one invalid slot)
    ], dtype=np.float32)
    local_order, run_slot, perm, rmax = preblend_plan(hints, rmax_bucket=1)
    # global order: (0,0) (1,0) (0,1) (1,1) (0,2) (1,2-invalid)
    # device 0 runs: [l0], [l1], [l2] -> slots 0,1,2; device 1: [l0],
    # [l1], with its invalid slot folding into run 1 as an identity
    np.testing.assert_array_equal(local_order, [[0, 1, 2], [0, 1, 2]])
    np.testing.assert_array_equal(run_slot, [[0, 1, 2], [0, 1, 1]])
    assert rmax == 3
    # valid run sequence: d0s0 d1s0 d0s1 d1s1 d0s2; padding slot trails
    np.testing.assert_array_equal(perm, [0, 3, 1, 4, 2, 5])
    # contiguous same-device layers merge into ONE run
    hints2 = np.array([
        [0.0, 1.0, 5.0],
        [2.0, 3.0, 4.0],
    ], dtype=np.float32)
    lo2, rs2, perm2, rmax2 = preblend_plan(hints2, rmax_bucket=1)
    np.testing.assert_array_equal(rs2, [[0, 0, 1], [0, 0, 0]])
    assert rmax2 == 2
    np.testing.assert_array_equal(perm2, [0, 2, 1, 3])


def test_preblend_padding_slots_join_last_run():
    """Invalid (+inf) slots are identity layers: they must fold into
    their device's last valid run instead of inflating the run depth
    (review finding: per-device padding added an artificial trailing run
    each, spuriously defeating the pre-blend on padded scenes)."""
    hints = np.array([
        [0.0, 2.0, 4.0, np.inf],
        [1.0, 3.0, np.inf, np.inf],
    ], dtype=np.float32)
    local_order, run_slot, perm, rmax = preblend_plan(hints, rmax_bucket=1)
    # valid runs: d0 has 3 ([0],[2],[4]), d1 has 2 ([1],[3])
    assert rmax == 3
    np.testing.assert_array_equal(run_slot[0], [0, 1, 2, 2])
    np.testing.assert_array_equal(run_slot[1], [0, 1, 1, 1])
    # a device with NO valid layers folds everything into slot 0
    hints2 = np.array(
        [[0.0, 1.0], [np.inf, np.inf]], dtype=np.float32
    )
    _, rs2, _, rmax2 = preblend_plan(hints2, rmax_bucket=1)
    assert rmax2 == 1
    np.testing.assert_array_equal(rs2[1], [0, 0])


def test_preblend_empty_layer_stack():
    """Lmax == 0 must return identity run buffers, not crash (review
    finding: the guard sat below an indexing of layers[0])."""
    import jax.numpy as jnp

    from amrvolumerenderer_tpu.parallel.directsend import _preblend_runs

    out = np.asarray(_preblend_runs(
        jnp.zeros((0, 16, 5), jnp.float32),
        jnp.zeros((0,), jnp.int32), jnp.zeros((0,), jnp.int32), 4,
    ))
    assert out.shape == (4, 16, 5)
    assert (out[:, :, :4] == 0).all() and np.isinf(out[:, :, 4]).all()


def test_preblend_forced_rmax():
    hints = np.array([[0.0, 2.0], [1.0, 3.0]], dtype=np.float32)
    _, _, perm, rmax = preblend_plan(hints, rmax_bucket=1, rmax=4)
    assert rmax == 4 and len(perm) == 8
    with pytest.raises(ValueError):
        preblend_plan(hints, rmax_bucket=1, rmax=1)


@pytest.mark.parametrize("num_devices", [4])
def test_preblend_ubyte_quantizes_per_run(num_devices):
    """ubyte transport with pre-blend quantizes each pre-blended RUN on
    the wire (the reference's quantization point — pre-blend first, byte
    send after, DirectSendBase.cpp:418-446) instead of every raw layer;
    the result matches the per-layer-quantized path within codec
    tolerance and the f32 path at least as closely."""
    if len(jax.devices()) < num_devices:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(5)
    layers, hints, _ = make_device_layers(rng, num_devices, 4, 64)
    mesh = make_mesh(num_devices)
    exact = np.asarray(
        composite_layers_sharded(mesh, jnp.asarray(layers), jnp.asarray(hints))
    )
    pre_u8 = np.asarray(composite_layers_sharded_preblend(
        mesh, jnp.asarray(layers), hints, transport="ubyte"
    ))
    base_u8 = np.asarray(composite_layers_sharded(
        mesh, jnp.asarray(layers), jnp.asarray(hints), transport="ubyte"
    ))
    # depth channel is f32 on the wire in both modes
    np.testing.assert_array_equal(pre_u8[:, 4], exact[:, 4])
    # color: both byte modes sit within stacked-codec tolerance of exact,
    # and pre-blend (fewer quantization events) is no farther from exact
    tol = 16 / 255.0
    assert np.abs(base_u8[:, :4] - exact[:, :4]).max() < tol
    assert np.abs(pre_u8[:, :4] - exact[:, :4]).max() < tol
    assert (
        np.abs(pre_u8[:, :4] - exact[:, :4]).mean()
        <= np.abs(base_u8[:, :4] - exact[:, :4]).mean() + 1e-6
    )


def test_sharded_composite_uses_all_devices():
    """Each device's output shard must cover a distinct pixel range."""
    num_devices = 4
    if len(jax.devices()) < num_devices:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(1)
    layers, hints, _ = make_device_layers(rng, num_devices, 2, 32)
    mesh = make_mesh(num_devices)
    out = composite_layers_sharded(mesh, jnp.asarray(layers), jnp.asarray(hints))
    assert out.shape == (32, 5)
    # result is sharded over the pixel axis
    assert len(out.sharding.device_set) == num_devices


def test_full_sharded_pipeline_matches_single_device(r2_scene):
    """Render + exchange + fold over an 8-device mesh equals the
    single-device render of the same scene."""
    import math

    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.camera import (
        auto_orbit_camera,
        compute_box_depth_hint,
    )
    from amrvolumerenderer_tpu.colormap import build_color_table
    from amrvolumerenderer_tpu.ops.raymarch import max_steps_for_bucket
    from amrvolumerenderer_tpu.parallel.directsend import (
        render_and_composite_sharded,
    )
    from amrvolumerenderer_tpu.renderer import (
        compute_global_bounds,
        compute_reference_sample_distance,
        render_layers,
        _build_camera_arrays,
    )
    from amrvolumerenderer_tpu.scene import assign_owners
    from amrvolumerenderer_tpu.types import RenderParameters

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    num_devices = 8
    if len(jax.devices()) < num_devices:
        pytest.skip("not enough devices")
    assign_owners(geometry, num_devices)

    width = height = 32
    parameters = RenderParameters(width=width, height=height)
    bounds = compute_global_bounds(geometry)
    camera = auto_orbit_camera(bounds)
    scalar_range = geometry.scalar_range
    ref_dist = compute_reference_sample_distance(geometry, bounds)

    # single-device oracle
    layers, hints, owners, local = render_layers(
        geometry, parameters, camera, bounds, scalar_range, ref_dist,
        width, height, None,
    )
    expected = composite_layers_host(layers, hints, owners, local)

    # sharded path: build the padded per-device brick table
    bricks = geometry.bricks
    bmax = max(
        sum(1 for b in bricks if b.owner == d) for d in range(num_devices)
    )
    shape = bricks[0].cell_dimensions
    total = num_devices * bmax
    t_data = np.zeros((total,) + shape, dtype=np.float32)
    t_min = np.zeros((total, 3), dtype=np.float32)
    t_max = np.ones((total, 3), dtype=np.float32)
    t_dims = np.ones((total, 3), dtype=np.int32)
    t_lut = np.zeros((total, 256, 4), dtype=np.float32)
    t_step = np.full(total, 1.0, dtype=np.float32)
    t_valid = np.zeros(total, dtype=bool)
    t_hints = np.full(total, np.inf, dtype=np.float32)

    slot_count = [0] * num_devices
    for b in bricks:
        d = b.owner
        slot = d * bmax + slot_count[d]
        slot_count[d] += 1
        t_data[slot] = b.data
        t_min[slot] = b.min_corner
        t_max[slot] = b.max_corner
        t_dims[slot] = b.cell_dimensions
        ms = b.min_spacing()
        sample_distance = max(ms * 0.5, 1e-5)
        t_step[slot] = sample_distance
        norm_factor = sample_distance / ref_dist
        t_lut[slot] = build_color_table(1.0, norm_factor, scalar_range, None)
        t_valid[slot] = True
        t_hints[slot] = compute_box_depth_hint(b.min_corner, b.max_corner, camera)

    num_steps = max_steps_for_bucket(t_min, t_max, t_step)
    t = geometry.scalar_transform
    mesh = make_mesh(num_devices)
    out = render_and_composite_sharded(
        mesh,
        jnp.asarray(t_data),
        jnp.asarray(t_min),
        jnp.asarray(t_max),
        jnp.asarray(t_dims),
        jnp.asarray(t_lut),
        jnp.asarray(t_step),
        jnp.asarray(t_valid),
        jnp.asarray(t_hints),
        _build_camera_arrays(camera),
        camera.fov_y_degrees,
        scalar_range[0],
        1.0 / (scalar_range[1] - scalar_range[0]),
        (t.positive_floor, t.normalization_min, t.inverse_normalization_span),
        width=width,
        height=height,
        num_steps=num_steps,
        log_scale=t.log_scale_input,
        normalize=t.normalize_to_unit_range,
        clip_start=1.0,
        apply_clip=False,
    )
    got = np.asarray(out)
    np.testing.assert_allclose(got, expected, atol=2e-5)


def test_sharded_slicemarch_pipeline(r2_scene):
    """The multi-chip slice-march pipeline must match the single-device
    slice-march render + host composite."""
    import math

    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.camera import (
        auto_orbit_camera,
        camera_basis,
        compute_box_depth_hint,
    )
    from amrvolumerenderer_tpu.colormap import build_color_table
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.parallel.directsend import (
        render_and_composite_sharded_slicemarch,
    )
    from amrvolumerenderer_tpu.renderer import (
        compute_global_bounds,
        compute_reference_sample_distance,
    )
    from amrvolumerenderer_tpu.renderer_fast import _pretransform
    from amrvolumerenderer_tpu.scene import assign_owners

    num_devices = 4
    if len(jax.devices()) < num_devices:
        pytest.skip("not enough devices")

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    assign_owners(geometry, num_devices)

    width = height = 32
    bounds = compute_global_bounds(geometry)
    camera = auto_orbit_camera(bounds)
    forward, right, up = camera_basis(camera)
    axis = sm.choose_march_axis(forward)
    axes = [axis] + [a for a in range(3) if a != axis]
    ref_dist = compute_reference_sample_distance(geometry, bounds)
    t = geometry.scalar_transform

    lut = build_color_table(1.0, 1.0, geometry.scalar_range, None)
    packed = sm.build_log_lut(lut)
    cam = sm.pack_camera(
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        1.0, 0.0, 1.0, ref_dist,
    )

    bricks = geometry.bricks
    bmax_count = max(
        sum(1 for b in bricks if b.owner == d) for d in range(num_devices)
    )
    total = num_devices * bmax_count
    s_max = 16
    vol = np.zeros((total, s_max, sm.SUBLANES, sm.LANES), np.float32)
    meta = np.zeros((total, 12), np.float32)
    dims = np.zeros((total, 8), np.int32)
    luts = np.zeros((total, 4, sm.LUT_ROWS, sm.LANES), np.float32)
    valid = np.zeros(total, bool)
    hints = np.full(total, np.inf, np.float32)

    slot_count = [0] * num_devices
    host_layers, host_hints, host_owners, host_local = [], [], [], []
    for b in bricks:
        d = b.owner
        slot = d * bmax_count + slot_count[d]
        slot_count[d] += 1
        pt = _pretransform(b.data, t, 1.0, False)
        v, (ns, nu, nv) = sm.pack_slice_volume(pt, axis)
        vol[slot, :ns] = v
        pmin = np.asarray(b.min_corner)[axes]
        pmax = np.asarray(b.max_corner)[axes]
        meta[slot, 0:3] = pmin
        meta[slot, 3:6] = pmax
        meta[slot, 6:9] = (pmax - pmin) / np.array([ns, nu, nv])
        dims[slot, :3] = (ns, nu, nv)
        dims[slot, 3:6] = axes
        luts[slot] = packed
        valid[slot] = True
        hints[slot] = compute_box_depth_hint(b.min_corner, b.max_corner, camera)

    from amrvolumerenderer_tpu.parallel.directsend import make_mesh

    mesh = make_mesh(num_devices)
    out = render_and_composite_sharded_slicemarch(
        mesh,
        jnp.asarray(vol), jnp.asarray(meta), jnp.asarray(dims),
        jnp.asarray(luts), jnp.asarray(cam), jnp.asarray(valid),
        jnp.asarray(hints),
        width=width, height=height, max_slices=s_max,
    )
    got = np.asarray(out)

    # single-device oracle: dense slicemarch per slot + host fold
    from amrvolumerenderer_tpu.compositor import composite_layers_host
    from amrvolumerenderer_tpu.ops.slicemarch import slicemarch_render

    colors, depths = slicemarch_render(
        jnp.asarray(vol), jnp.asarray(meta), jnp.asarray(dims),
        jnp.asarray(luts), jnp.asarray(cam),
        width=width, height=height, max_slices=s_max,
    )
    layers = np.concatenate(
        [np.asarray(colors), np.asarray(depths)[..., None]], axis=-1
    )
    owners_arr = np.repeat(np.arange(num_devices, dtype=np.int32), bmax_count)
    local_arr = np.tile(np.arange(bmax_count, dtype=np.int32), num_devices)
    cleared = np.zeros_like(layers[0])
    cleared[:, 4] = np.inf
    layers[~valid] = cleared
    expected = composite_layers_host(layers, hints, owners_arr, local_arr)
    np.testing.assert_allclose(got, expected, atol=2e-5)


@pytest.mark.parametrize("num_devices", [2, 4, 8])
def test_flat_compose_sharded_matches_host(num_devices):
    """Device flat compose == host compose_flat_host for RGBA_F32 images."""
    if len(jax.devices()) < num_devices:
        pytest.skip("not enough devices")
    from amrvolumerenderer_tpu.compositor import assemble_pieces, compose_flat_host
    from amrvolumerenderer_tpu.image import ImageBuffer, ImageKind
    from amrvolumerenderer_tpu.parallel.directsend import compose_flat_sharded

    rng = np.random.default_rng(7 + num_devices)
    w = h = 8
    images = []
    buffers = []
    for _ in range(num_devices):
        img = ImageBuffer.create(ImageKind.RGBA_F32, w, h)
        px = (rng.random((w * h, 4)) * 0.6).astype(np.float32)
        img.pixels[:] = px
        images.append(img)
        buffers.append(px)
    group_order = np.asarray(rng.permutation(num_devices), dtype=np.int32)

    mesh = make_mesh(num_devices)
    got = np.asarray(
        compose_flat_sharded(mesh, jnp.asarray(np.stack(buffers)), group_order)
    )
    expected = assemble_pieces(compose_flat_host(images, group_order))
    np.testing.assert_allclose(got, expected.pixels, atol=1e-6)


def test_depth_contiguous_partial_compositing(rng):
    """Pre-compositing depth-contiguous per-device runs, then folding the
    D partial frames, equals the full global layered fold."""
    from amrvolumerenderer_tpu.compositor import sort_layers
    from amrvolumerenderer_tpu.image import blend_depth_sort
    from amrvolumerenderer_tpu.parallel.directsend import (
        composite_partials_sharded,
        depth_contiguous_assignment,
    )

    num_devices = 4
    if len(jax.devices()) < num_devices:
        pytest.skip("not enough devices")

    num_bricks, num_pixels = 11, 64
    # disjoint-in-depth layers: per-pixel depths ordered consistently with
    # the hints (the property real AMR bricks have), which makes the
    # depth-sorted fold grouping-invariant
    hints = np.sort((rng.random(num_bricks) * 5).astype(np.float32))
    layers = np.zeros((num_bricks, num_pixels, 5), np.float32)
    for i in range(num_bricks):
        alpha = (rng.random(num_pixels) * 0.8).astype(np.float32)
        rgb = rng.random((num_pixels, 3)).astype(np.float32)
        layers[i, :, :3] = rgb * alpha[:, None]
        layers[i, :, 3] = alpha
        layers[i, :, 4] = hints[i] + rng.random(num_pixels) * 0.05
        empty = rng.random(num_pixels) < 0.2
        layers[i, empty, :4] = 0.0
        layers[i, empty, 4] = np.inf
    tie = np.arange(num_bricks, dtype=np.int32)

    device_of = depth_contiguous_assignment(hints, tie, num_devices)

    # per-device partial composite (front-to-back within the device's run)
    partials = np.zeros((num_devices, num_pixels, 5), np.float32)
    partials[..., 4] = np.inf
    order = sort_layers(hints, tie, np.zeros(num_bricks, np.int32))
    for d in range(num_devices):
        acc = None
        for idx in order:
            if device_of[idx] != d:
                continue
            acc = layers[idx] if acc is None else blend_depth_sort(acc, layers[idx])
        if acc is not None:
            partials[d] = acc

    mesh = make_mesh(num_devices)
    got = np.asarray(
        composite_partials_sharded(mesh, jnp.asarray(partials))
    )

    expected = composite_layers_host(
        layers, hints, tie, np.zeros(num_bricks, np.int32)
    )
    np.testing.assert_allclose(got, expected, atol=1e-5)


@pytest.mark.parametrize("num_devices", [2, 8])
def test_sharded_composite_ubyte_transport(num_devices):
    """The compressed (byte-color) exchange equals the host fold applied to
    byte-codec-quantized layers — the reference's color-ubyte compositing
    axis carried over the collectives."""
    if len(jax.devices()) < num_devices:
        pytest.skip("not enough devices")
    from amrvolumerenderer_tpu.image import byte_to_color, color_to_byte

    rng = np.random.default_rng(19 + num_devices)
    lmax, num_pixels = 3, 64
    layers, hints, _ = make_device_layers(rng, num_devices, lmax, num_pixels)

    mesh = make_mesh(num_devices)
    got = np.asarray(
        composite_layers_sharded(
            mesh, jnp.asarray(layers), jnp.asarray(hints), transport="ubyte"
        )
    )

    quantized = layers.copy()
    quantized[..., :4] = byte_to_color(color_to_byte(layers[..., :4]))
    owners = np.repeat(np.arange(num_devices, dtype=np.int32), lmax)
    local = np.tile(np.arange(lmax, dtype=np.int32), num_devices)
    expected = composite_layers_host(quantized, hints, owners, local)
    np.testing.assert_allclose(got, expected, atol=1e-5)
    # quantization itself stays inside the byte-codec tolerance
    exact = composite_layers_host(layers, hints, owners, local)
    assert np.abs(got[:, :4] - exact[:, :4]).max() < 0.02


def test_depth_contiguous_end_to_end(r2_scene):
    """Full depth-contiguous pipeline (per-frame repack + local
    pre-composite + D-frame exchange) matches the layered slice-march
    pipeline on a real scene."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.camera import (
        auto_orbit_camera,
        camera_basis,
        compute_box_depth_hints,
    )
    from amrvolumerenderer_tpu.colormap import build_color_table
    from amrvolumerenderer_tpu.compositor import composite_layers_host
    from amrvolumerenderer_tpu.ops import slicemarch as sm
    from amrvolumerenderer_tpu.parallel.directsend import (
        pack_depth_contiguous,
        render_depth_contiguous_slicemarch,
    )
    from amrvolumerenderer_tpu.renderer import (
        compute_global_bounds,
        compute_reference_sample_distance,
    )
    from amrvolumerenderer_tpu.renderer_fast import _pretransform

    num_devices = 4
    if len(jax.devices()) < num_devices:
        pytest.skip("not enough devices")

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)

    width = height = 32
    bounds = compute_global_bounds(geometry)
    camera = auto_orbit_camera(bounds)
    forward, right, up = camera_basis(camera)
    axis = sm.choose_march_axis(forward)
    axes = [axis] + [a for a in range(3) if a != axis]
    ref_dist = compute_reference_sample_distance(geometry, bounds)
    t = geometry.scalar_transform

    lut = build_color_table(1.0, 1.0, geometry.scalar_range, None)
    packed_lut = sm.build_log_lut(lut)
    cam = sm.pack_camera(
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        1.0, 0.0, 1.0, ref_dist,
    )

    bricks = geometry.bricks
    n = len(bricks)
    s_max = 16
    vol = np.zeros((n, s_max, sm.SUBLANES, sm.LANES), np.float32)
    meta = np.zeros((n, 12), np.float32)
    dims = np.zeros((n, 8), np.int32)
    luts = np.broadcast_to(packed_lut[None], (n,) + packed_lut.shape).copy()
    for i, b in enumerate(bricks):
        pt = _pretransform(b.data, t, 1.0, False)
        v, (ns, nu, nv) = sm.pack_slice_volume(pt, axis)
        vol[i, :ns] = v
        pmin = np.asarray(b.min_corner)[axes]
        pmax = np.asarray(b.max_corner)[axes]
        meta[i, 0:3] = pmin
        meta[i, 3:6] = pmax
        meta[i, 6:9] = (pmax - pmin) / np.array([ns, nu, nv])
        dims[i, :3] = (ns, nu, nv)
        dims[i, 3:6] = axes
    hints = compute_box_depth_hints(
        np.stack([b.min_corner for b in bricks]),
        np.stack([b.max_corner for b in bricks]),
        camera,
    ).astype(np.float32)

    (p_vol, p_meta, p_dims, p_luts), valid, p_hints = pack_depth_contiguous(
        hints, np.arange(n, dtype=np.int32), num_devices,
        vol, meta, dims, luts,
    )

    mesh = make_mesh(num_devices)
    got = np.asarray(
        render_depth_contiguous_slicemarch(
            mesh,
            jnp.asarray(p_vol), jnp.asarray(p_meta), jnp.asarray(p_dims),
            jnp.asarray(p_luts), jnp.asarray(cam), jnp.asarray(valid),
            jnp.asarray(p_hints),
            width=width, height=height, max_slices=s_max,
        )
    )

    # oracle: dense single-device render + global layered host fold
    colors, depths = sm.slicemarch_render(
        jnp.asarray(vol), jnp.asarray(meta), jnp.asarray(dims),
        jnp.asarray(luts), jnp.asarray(cam),
        width=width, height=height, max_slices=s_max,
    )
    layers = np.concatenate(
        [np.asarray(colors), np.asarray(depths)[..., None]], axis=-1
    )
    expected = composite_layers_host(
        layers, hints, np.arange(n, dtype=np.int32), np.zeros(n, np.int32)
    )
    np.testing.assert_allclose(got, expected, atol=2e-5)


def test_multihost_mesh_composite_matches_host():
    """The same compositing program runs on a 2D (dcn, ranks) multi-host
    mesh shape: collectives over the flattened axis tuple reproduce the
    host fold exactly."""
    from amrvolumerenderer_tpu.parallel.directsend import (
        composite_layers_sharded,
        compose_flat_sharded,
        make_mesh,
        mesh_axes,
    )

    num_devices = 8
    if len(jax.devices()) < num_devices:
        pytest.skip("not enough devices")
    mesh = make_mesh(num_devices, dcn_size=2)
    assert mesh.devices.shape == (2, 4)
    assert mesh_axes(mesh) == ("dcn", "ranks")

    rng = np.random.default_rng(11)
    lmax, num_pixels = 2, 64
    layers, hints, _ = make_device_layers(rng, num_devices, lmax, num_pixels)
    got = np.asarray(
        composite_layers_sharded(mesh, jnp.asarray(layers), jnp.asarray(hints))
    )
    owners = np.repeat(np.arange(num_devices, dtype=np.int32), lmax)
    local = np.tile(np.arange(lmax, dtype=np.int32), num_devices)
    expected = composite_layers_host(layers, hints, owners, local)
    np.testing.assert_allclose(got, expected, atol=1e-5)

    # ubyte transport on the 2D mesh
    from amrvolumerenderer_tpu.image import byte_to_color, color_to_byte

    got_u = np.asarray(
        composite_layers_sharded(
            mesh, jnp.asarray(layers), jnp.asarray(hints), transport="ubyte"
        )
    )
    quantized = layers.copy()
    quantized[..., :4] = byte_to_color(color_to_byte(layers[..., :4]))
    expected_u = composite_layers_host(quantized, hints, owners, local)
    np.testing.assert_allclose(got_u, expected_u, atol=1e-5)

    # flat compose on the 2D mesh
    from amrvolumerenderer_tpu.compositor import assemble_pieces, compose_flat_host
    from amrvolumerenderer_tpu.image import ImageBuffer, ImageKind

    images, buffers = [], []
    for _ in range(num_devices):
        img = ImageBuffer.create(ImageKind.RGBA_F32, 8, 8)
        px = (rng.random((64, 4)) * 0.6).astype(np.float32)
        img.pixels[:] = px
        images.append(img)
        buffers.append(px)
    group_order = np.asarray(rng.permutation(num_devices), dtype=np.int32)
    got_f = np.asarray(
        compose_flat_sharded(mesh, jnp.asarray(np.stack(buffers)), group_order)
    )
    expected_f = assemble_pieces(compose_flat_host(images, group_order))
    np.testing.assert_allclose(got_f, expected_f.pixels, atol=1e-6)


class _FakeDev:
    """Stand-in with the one attribute _subset_devices reads."""

    def __init__(self, host):
        self.process_index = host

    def __repr__(self):
        return f"dev(h{self.process_index})"


def test_subset_devices_single_host_prefix():
    from amrvolumerenderer_tpu.parallel.directsend import _subset_devices

    devs = [_FakeDev(0) for _ in range(8)]
    assert _subset_devices(devs, 4, 1) == devs[:4]
    assert _subset_devices(devs, None, 1) == devs
    assert _subset_devices(devs, 16, 1) == devs  # clamp to available


def test_subset_devices_multi_host_equal_prefix():
    # process-major global list: a plain prefix would starve host 1; the
    # subset must take an equal per-host prefix so every process keeps an
    # addressable shard and dcn rows stay host-aligned
    from amrvolumerenderer_tpu.parallel.directsend import _subset_devices

    devs = [_FakeDev(i // 4) for i in range(8)]
    picked = _subset_devices(devs, 4, 2)
    assert [d.process_index for d in picked] == [0, 0, 1, 1]
    assert picked == devs[0:2] + devs[4:6]


def test_subset_devices_multi_host_validation():
    import pytest

    from amrvolumerenderer_tpu.parallel.directsend import _subset_devices

    devs = [_FakeDev(i // 4) for i in range(8)]
    with pytest.raises(ValueError, match="multiple of the"):
        _subset_devices(devs, 3, 2)
    # lopsided hosts: host 1 cannot satisfy the per-host quota
    lop = [_FakeDev(0)] * 6 + [_FakeDev(1)] * 2
    with pytest.raises(ValueError, match="has only"):
        _subset_devices(lop, 6, 2)


def test_preblend_negative_inf_hints_stay_valid():
    """-inf is a legitimate front-most hint that lexsorts to the HEAD of
    the global order; the valid/invalid partition must not misfile it
    into the +inf tail (review finding r4: isfinite() did, misaligning
    the run decomposition)."""
    hints = np.array([
        [-np.inf, 5.0],
        [1.0, 2.0],
    ], dtype=np.float32)
    local_order, run_slot, perm, rmax = preblend_plan(hints, rmax_bucket=1)
    # order: (d0,-inf) (d1,1) (d1,2) (d0,5) -> d0 runs [l0],[l1]; d1 [l0,l1]
    np.testing.assert_array_equal(local_order, [[0, 1], [0, 1]])
    np.testing.assert_array_equal(run_slot, [[0, 1], [0, 0]])
    assert rmax == 2
    np.testing.assert_array_equal(perm, [0, 2, 1, 3])
