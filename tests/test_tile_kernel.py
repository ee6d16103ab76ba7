"""The fused tile kernel (Pallas, Triton route) against the plain tile loop.

On the CPU the kernel runs in interpret mode, requested explicitly here;
the product routes to it only on the GPU (``tilemarch.use_kernel``), where
``chip_smoke.py`` compares it with the plain tile loop on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amrvolumerenderer_tpu.camera import camera_basis, compute_box_depth_hints
from amrvolumerenderer_tpu.colormap import build_color_table
from amrvolumerenderer_tpu.ops import slicemarch as sm
from amrvolumerenderer_tpu.ops import tilemarch as tm
from amrvolumerenderer_tpu.types import CameraParameters

EYES = {"forward": (2.3, 1.7, 2.9), "backward": (-1.3, 0.7, -1.9)}


def smooth_field(n, seed):
    rng = np.random.default_rng(seed)
    c = (np.arange(n) + 0.5) / n
    g = np.zeros((n, n, n))
    for _ in range(4):
        k = rng.uniform(2.0, 7.0, 3)
        g += np.sin(k[0] * c)[:, None, None] * np.cos(k[1] * c)[None, :, None] \
            * np.sin(k[2] * c + rng.uniform(0, 3))[None, None, :]
    g -= g.min()
    return (g / g.max()).astype(np.float32)


def scene(eye, ghost, width=64, n=32, box=16, transparent_low=False):
    """A split 32^3 field in 16^3 boxes: packed tables and a CSR list."""
    field = smooth_field(n, 7)
    camera = CameraParameters(eye=eye, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0))
    forward, right, up = camera_basis(camera)
    axis = sm.choose_march_axis(forward)
    axes = [axis] + [a for a in range(3) if a != axis]
    pieces = []
    for i in range(0, n, box):
        for j in range(0, n, box):
            for k in range(0, n, box):
                lo = np.array([i, j, k])
                pieces += sm.split_brick_for_slices(
                    field[i:i + box, j:j + box, k:k + box], lo / n,
                    (lo + box) / n, axis, ghost=ghost,
                )
    packs = [sm.pack_slice_volume(d, axis, ghost=ghost) for d, _, _ in pieces]
    s_max = max(v.shape[0] for v, _ in packs)
    num = len(pieces)
    vol = np.zeros((num, s_max, sm.SUBLANES, sm.LANES), np.float32)
    meta = np.zeros((num, 12), np.float32)
    dims = np.zeros((num, 8), np.int32)
    for i, ((v, (ns, nu, nv)), (_, mn, mx)) in enumerate(zip(packs, pieces)):
        vol[i, : v.shape[0]] = v
        pmin, pmax = np.asarray(mn)[axes], np.asarray(mx)[axes]
        meta[i, 0:3], meta[i, 3:6] = pmin, pmax
        meta[i, 6:9] = (pmax - pmin) / np.array([ns, nu, nv])
        dims[i, :3] = (ns, nu, nv)
        dims[i, 3:6] = axes
        dims[i, 6] = nv + 2 * ghost
    bmin = np.stack([p[1] for p in pieces])
    bmax = np.stack([p[2] for p in pieces])
    hints = compute_box_depth_hints(bmin, bmax, camera)
    # two pieces per owner: exercises the run-grouped blend
    owners = (np.arange(num) // 2).astype(np.int32)
    cmap = None
    if transparent_low:
        from amrvolumerenderer_tpu.types import color_map_from_tuples

        cmap = color_map_from_tuples([
            (0.0, 0, 0, 0, 0.0), (0.4, 0, 0, 0, 0.0),
            (0.6, 1.0, 0.5, 0.2, 0.9), (1.0, 1.0, 1.0, 1.0, 1.0),
        ])
    lut = sm.build_log_lut(build_color_table(1.0, 1.0, (0.0, 1.0), cmap))
    cam = sm.pack_camera(np.asarray(camera.eye), forward, right, up,
                         camera.fov_y_degrees, 1.0, 0.0, 1.0, 0.5 / n)
    offsets, tb, tw = tm.build_tile_worklist(
        bmin, bmax, hints, owners, np.asarray(camera.eye), forward, right,
        up, camera.fov_y_degrees, width, width,
    )
    return dict(vol=vol, meta=meta, dims=dims, lut=lut, cam=cam,
                offsets=offsets, bricks=tb, owners=tw, width=width)


def kernel(*args, **kw):
    return tm.tilemarch_kernel(*args, interpret=True, **kw)


def plain(s, dtype="float32", **kw):
    return tm.tilemarch_render(
        jnp.asarray(s["vol"]).astype(dtype), jnp.asarray(s["meta"]),
        jnp.asarray(s["dims"]), jnp.asarray(s["lut"]), jnp.asarray(s["cam"]),
        jnp.asarray(s["offsets"]), jnp.asarray(s["bricks"]),
        jnp.asarray(s["owners"]), width=s["width"], height=s["width"],
        max_slices=s["vol"].shape[1], **kw,
    )


def assert_same(got_c, got_d, exp_c, exp_d, atol=2e-6):
    got_c, exp_c = np.asarray(got_c), np.asarray(exp_c)
    got_d, exp_d = np.asarray(got_d), np.asarray(exp_d)
    np.testing.assert_allclose(got_c.reshape(exp_c.shape), exp_c, atol=atol)
    finite = np.isfinite(exp_d)
    np.testing.assert_array_equal(np.isfinite(got_d).reshape(exp_d.shape),
                                  finite)
    np.testing.assert_allclose(got_d.reshape(exp_d.shape)[finite],
                               exp_d[finite], atol=1e-5)


@pytest.mark.parametrize("sign", sorted(EYES))
@pytest.mark.parametrize(
    "sampling,classification,ghost,dtype",
    [
        ("nearest", "post", 0, "float32"),
        ("nearest", "post", 0, "bfloat16"),
        ("trilinear", "post", 1, "float32"),
        ("trilinear", "pre", 1, "float32"),
        ("trilinear", "pre", 1, "bfloat16"),
    ],
)
def test_kernel_matches_plain_tile_loop(sign, sampling, classification,
                                        ghost, dtype):
    """Every sampling x classification mode, both march signs, ghost 0/1
    and bf16 storage: the kernel equals the plain tile loop."""
    s = scene(EYES[sign], ghost)
    kw = dict(sampling=sampling, ghost=ghost, classification=classification)
    exp_c, exp_d = plain(s, dtype, **kw)
    steps = len(s["offsets"]) - 1
    got_c, got_d = kernel(
        jnp.asarray(s["vol"]).astype(dtype), jnp.asarray(s["meta"]),
        jnp.asarray(s["dims"]), jnp.asarray(s["lut"]),
        jnp.asarray(s["cam"])[None], jnp.asarray(s["offsets"])[None],
        jnp.asarray(s["bricks"])[None], jnp.asarray(s["owners"])[None],
        jnp.asarray(s["dims"][s["bricks"], 7])[None],
        jnp.arange(steps, dtype=jnp.int32)[None],
        width=s["width"], height=s["width"], max_slices=s["vol"].shape[1],
        **kw,
    )
    assert got_c.shape == (1, steps, 4, tm.TILE_P)
    assert got_d.shape == (1, steps, tm.TILE_P)
    assert_same(got_c[0], got_d[0], exp_c, exp_d)


def test_kernel_early_exit_on_opaque_tiles():
    """A near-opaque transfer function saturates rays early: the kernel's
    per-item stop at full opacity leaves the pixels of the full march."""
    s = scene(EYES["forward"], 0, transparent_low=True)
    exp_c, exp_d = plain(s)
    steps = len(s["offsets"]) - 1
    got_c, got_d = kernel(
        jnp.asarray(s["vol"]), jnp.asarray(s["meta"]), jnp.asarray(s["dims"]),
        jnp.asarray(s["lut"]), jnp.asarray(s["cam"])[None],
        jnp.asarray(s["offsets"])[None], jnp.asarray(s["bricks"])[None],
        jnp.asarray(s["owners"])[None],
        jnp.asarray(s["dims"][s["bricks"], 7])[None],
        jnp.arange(steps, dtype=jnp.int32)[None],
        width=s["width"], height=s["width"], max_slices=s["vol"].shape[1],
    )
    assert float(np.asarray(exp_c)[:, 3].max()) > 0.99  # some rays saturate
    assert_same(got_c[0], got_d[0], exp_c, exp_d)


def test_kernel_batch_compacted_and_padded():
    """Two frames in one launch, each a compacted tile list padded with the
    sentinel tile and with item tables padded past the CSR end: the kernel
    equals ``tilemarch_render_batch``'s plain per-frame loop."""
    frames = [scene(EYES["forward"], 0), scene((2.0, -1.2, 2.6), 0)]
    num_tiles = (64 // tm.TILE_W) ** 2
    steps = num_tiles + 1  # one sentinel pad step
    w_pad = max(len(f["bricks"]) for f in frames) + 3
    offs = np.zeros((2, steps + 1), np.int32)
    tids = np.full((2, steps), num_tiles, np.int32)
    brs = np.zeros((2, w_pad), np.int32)
    ows = np.zeros((2, w_pad), np.int32)
    ibs = np.zeros((2, w_pad), np.int32)
    for row, f in enumerate(frames):
        counts = np.diff(f["offsets"])
        covered = np.flatnonzero(counts > 0)
        tids[row, : len(covered)] = covered
        offs[row, 1: len(covered) + 1] = np.cumsum(counts[covered])
        offs[row, len(covered) + 1:] = offs[row, len(covered)]
        w = len(f["bricks"])
        brs[row, :w] = f["bricks"]
        ows[row, :w] = f["owners"]
        ibs[row, :w] = f["dims"][f["bricks"], 7]
    s = frames[0]
    common = (jnp.asarray(s["vol"]), jnp.asarray(s["meta"]),
              jnp.asarray(s["dims"]), jnp.asarray(s["lut"]))
    tables = (jnp.asarray(np.stack([f["cam"] for f in frames])),
              jnp.asarray(offs), jnp.asarray(brs), jnp.asarray(ows),
              jnp.asarray(ibs), jnp.asarray(tids))
    kw = dict(width=64, height=64, max_slices=s["vol"].shape[1])
    exp_c, exp_d = tm.tilemarch_render_batch(*common, *tables, **kw)
    got_c, got_d = kernel(*common, *tables, **kw)
    assert exp_c.shape == (2, steps, 4, tm.SUBLANES, tm.LANES)
    assert_same(got_c, got_d, exp_c, exp_d)


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_voxel_table_indexed_by_row(path):
    """A bf16 table of more than 2^31 cells fits one card; a flat int32
    cell offset would wrap on it.  Both tile loops gather from a [rows,
    SLICE_CELLS] view (one row per stored slice), so the row and the cell
    index separately.  Traced on abstract shapes: nothing is allocated."""
    s = scene(EYES["forward"], 0)
    rows = -(-(1 << 31) // sm.SLICE_CELLS) + 64 * s["vol"].shape[1]
    bricks = rows // s["vol"].shape[1]
    vol = jax.ShapeDtypeStruct(
        (bricks,) + s["vol"].shape[1:], jnp.bfloat16)
    meta = jax.ShapeDtypeStruct((bricks, 12), jnp.float32)
    dims = jax.ShapeDtypeStruct((bricks, 8), jnp.int32)
    kw = dict(width=s["width"], height=s["width"],
              max_slices=s["vol"].shape[1])
    tables = (jnp.asarray(s["lut"]), jnp.asarray(s["cam"])[None],
              jnp.asarray(s["offsets"])[None],
              jnp.asarray(s["bricks"])[None], jnp.asarray(s["owners"])[None],
              jnp.asarray(s["dims"][s["bricks"], 7])[None],
              jnp.arange(len(s["offsets"]) - 1, dtype=jnp.int32)[None])
    if path == "kernel":
        fn = functools.partial(tm.tilemarch_kernel, **kw)
    else:
        fn = functools.partial(tm.tilemarch_render_batch, **kw)
    text = str(jax.make_jaxpr(fn)(vol, meta, dims, *tables))
    cells = bricks * s["vol"].shape[1] * sm.SLICE_CELLS
    assert cells >= 1 << 31
    assert f"bf16[{cells // sm.SLICE_CELLS},{sm.SLICE_CELLS}]" in text
    assert f"bf16[{cells}]" not in text


def test_use_kernel_routing():
    """The product takes the kernel only on the GPU and only for a
    non-empty item list; the CPU runs the plain tile loop."""
    assert jax.default_backend() == "cpu"
    assert not tm.use_kernel(jnp.zeros((5,), jnp.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "gpu")
        assert tm.use_kernel(jnp.zeros((5,), jnp.int32))
        assert tm.use_kernel(jnp.zeros((2, 5), jnp.int32))
        assert not tm.use_kernel(jnp.zeros((0,), jnp.int32))
        assert not tm.use_kernel(jnp.zeros((2, 0), jnp.int32))


@pytest.fixture
def kernel_route(monkeypatch):
    """Route the product wrappers through the kernel (interpret mode)."""
    monkeypatch.setattr(tm, "use_kernel", lambda bricks: bricks.shape[-1] > 0)
    monkeypatch.setattr(
        tm, "tilemarch_kernel",
        functools.partial(tm.tilemarch_kernel, interpret=True),
    )
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_wrapper_shapes_through_kernel(kernel_route):
    """``tilemarch_render`` keeps its output shapes and pixels when it
    routes to the kernel: dense (no tile ids, item bounds from dims) and
    compacted (explicit tile ids)."""
    s = scene(EYES["backward"], 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, "use_kernel", lambda bricks: False)
        jax.clear_caches()
        exp_c, exp_d = plain(s)
    jax.clear_caches()
    got_c, got_d = plain(s)
    steps = len(s["offsets"]) - 1
    assert got_c.shape == exp_c.shape == (steps, 4, tm.SUBLANES, tm.LANES)
    assert got_d.shape == (steps, tm.SUBLANES, tm.LANES)
    assert_same(got_c, got_d, exp_c, exp_d)


def test_fast_scene_render_batch_through_kernel(kernel_route, r2_scene):
    """``FastSceneRenderer.render_batch`` (one launch for the chunk) and
    ``render`` through the kernel match the plain tile loop."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.camera import (
        auto_orbit_camera, orbit_camera_sequence,
    )
    from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer
    from amrvolumerenderer_tpu.types import RenderParameters

    levels, geoms = r2_scene
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True,
                                     verbose=False)
    fsr = FastSceneRenderer(geometry, RenderParameters(width=48, height=48))
    cams = orbit_camera_sequence(auto_orbit_camera(fsr.bounds), 2)
    got = fsr.render_batch(cams, overlay=False)
    single = fsr.render(cams[0], overlay=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, "use_kernel", lambda bricks: False)
        jax.clear_caches()
        exp = fsr.render_batch(cams, overlay=False)
    np.testing.assert_allclose(got[..., :4], exp[..., :4], atol=2e-6)
    np.testing.assert_allclose(single[:, :4], exp[0, :, :4], atol=2e-6)


def test_sharded_tile_loop_through_kernel(kernel_route, tile_threshold_96,
                                         tmp_path):
    """Above the piece threshold a mesh render runs the tile loop per
    device inside ``shard_map``; through the kernel it matches the
    single-device plain tile loop."""
    from amrvolumerenderer_tpu import api
    from amrvolumerenderer_tpu.renderer import render_scene
    from amrvolumerenderer_tpu.types import RenderParameters
    from tests.conftest import make_r2_scene_data

    levels, geoms = make_r2_scene_data(n_cells=40, box_size=8)  # 125 bricks
    data = api.AmrData(level_data=levels, level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True,
                                     verbose=False)
    frames = {}
    for devices in (None, 4):
        params = RenderParameters(
            width=64, height=64, devices=devices,
            render_method="slicemarch" if devices else "tilemarch",
            multichip_pipeline="depth",
        )
        if devices is None:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tm, "use_kernel", lambda bricks: False)
                jax.clear_caches()
                img, _ = render_scene("", params, geometry, verbose=False)
            jax.clear_caches()
        else:
            img, _ = render_scene("", params, geometry, verbose=False)
        frames[devices] = np.asarray(img.pixels)
    assert frames[4][:, 3].max() > 0.1
    np.testing.assert_allclose(frames[None][:, :4], frames[4][:, :4],
                               atol=1e-5)
