"""Multi-device sort-last compositing over a JAX device mesh.

The JAX equivalent of the reference's MPI direct-send exchange
(``DirectSend/Base/DirectSendBase.cpp``), mapped onto device collectives per
SURVEY.md §5/§7:

  * each mesh device owns a shard of the brick table and renders its local
    bricks into full-frame layers (domain parallelism ==
    AMReX DistributionMapping);
  * layer depth hints are ``all_gather``-ed (the MPI_Allgatherv at
    DirectSendBase.cpp:345-361);
  * the framebuffer's pixel axis is sharded D ways and every device's layer
    pixel-chunks are exchanged with one ``all_to_all`` (the Isend/Irecv
    piece exchange at cpp:76-177, as a single bulk-synchronous collective);
  * each device folds *all* layers for its pixel shard in the global
    (depth, owner, local-index) order with the same run-grouped blend
    structure as composeLayered (cpp:378-446).

Everything is a single jitted ``shard_map`` program: render + exchange +
ordered fold, with XLA scheduling the collectives on the device links (NVLink on one host).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..compositor import _composite_sorted_runs
from ..ops.raymarch import render_bucket_impl

AXIS = "ranks"


def make_mesh(
    num_devices: int | None = None, dcn_size=None
) -> Mesh:
    """A device mesh over the compositing axis.

    ``dcn_size`` splits the devices into a 2D (dcn, ranks) mesh for
    multi-host topologies: place the slow inter-host links on the outer
    axis so XLA routes the bulk pixel exchange within hosts where possible.
    ``dcn_size="auto"`` applies the product policy: one dcn row per host
    when multiple processes are present (the single place that policy
    lives — driver.maybe_initialize_distributed launches land here).
    All compositing collectives run over the flattened axis tuple, so the
    pipelines below work unchanged on either shape.
    """
    devices = _subset_devices(jax.devices(), num_devices, jax.process_count())
    if dcn_size == "auto":
        n_hosts = jax.process_count()
        dcn_size = (
            n_hosts if n_hosts > 1 and len(devices) % n_hosts == 0 else None
        )
    if dcn_size is not None:
        if len(devices) % dcn_size:
            raise ValueError("device count not divisible by dcn_size")
        grid = np.asarray(devices).reshape(dcn_size, -1)
        return Mesh(grid, ("dcn", AXIS))
    return Mesh(np.asarray(devices), (AXIS,))


def _subset_devices(devices, num_devices, n_hosts):
    """Pick ``num_devices`` mesh devices from the global device list.

    ``jax.devices()`` is process-major: on multi-host launches a plain
    prefix would take only the first host's chips, leaving the other
    processes with no addressable shard and misaligning any dcn row with
    its host — take an equal per-host prefix instead (pure so the policy
    is unit-testable without a real multi-process runtime)."""
    if num_devices is None or num_devices >= len(devices):
        return list(devices)
    if n_hosts <= 1:
        return list(devices[:num_devices])
    if num_devices % n_hosts:
        raise ValueError(
            f"num_devices={num_devices} must be a multiple of the "
            f"host count {n_hosts} on multi-host launches"
        )
    per_host = num_devices // n_hosts
    by_host: dict = {}
    for d in devices:
        by_host.setdefault(d.process_index, []).append(d)
    picked = []
    for p in sorted(by_host):
        if len(by_host[p]) < per_host:
            raise ValueError(
                f"host {p} has only {len(by_host[p])} devices; "
                f"{per_host} per host requested"
            )
        picked.extend(by_host[p][:per_host])
    return picked


def mesh_axes(mesh: Mesh):
    """The compositing axis spec: all mesh axes, flattened in order."""
    return tuple(mesh.axis_names)


def _encode_ubyte(colors: jnp.ndarray) -> jnp.ndarray:
    """Mesa-compatible float->byte codec ``clamp(int(c * 256))`` on device
    (image.color_to_byte_device, Common/Color.hpp:66-91)."""
    from ..image import color_to_byte_device

    return color_to_byte_device(colors)


def _decode_ubyte(b: jnp.ndarray) -> jnp.ndarray:
    from ..image import byte_to_color_device

    return byte_to_color_device(b)


def _compose_shard(
    layers: jnp.ndarray,  # [Lmax, P, 5] this device's layers (cleared if invalid)
    hints: jnp.ndarray,  # [Lmax] this device's depth hints (+inf if invalid)
    transport: str = "float32",
    axis=AXIS,
) -> jnp.ndarray:
    """Per-device body: exchange pixel chunks, fold in global order.

    ``transport="ubyte"`` sends colors through the exchange as bytes (the
    reference's color-ubyte compositing axis, Image/ImageRGBAUByteColor*):
    2.5x less link traffic per layer for the byte codec's 1/255 quantization.

    Returns this device's composited pixel shard [P / D, 5].
    """
    num_devices = jax.lax.psum(1, axis)
    lmax, num_pixels, channels = layers.shape
    shard = num_pixels // num_devices

    # pixel-piece exchange: the all_to_all counterpart of PostSends/
    # PostReceives (DirectSendBase.cpp:76-177)
    if transport == "ubyte":
        color_u8 = _encode_ubyte(layers[..., :4])
        depth = layers[..., 4]
        c_chunks = color_u8.reshape(lmax, num_devices, shard, 4).transpose(
            1, 0, 2, 3
        )
        d_chunks = depth.reshape(lmax, num_devices, shard).transpose(1, 0, 2)
        rc = jax.lax.all_to_all(c_chunks, axis, split_axis=0, concat_axis=0)
        rd = jax.lax.all_to_all(d_chunks, axis, split_axis=0, concat_axis=0)
        received = jnp.concatenate([_decode_ubyte(rc), rd[..., None]], axis=-1)
    else:
        chunks = layers.reshape(lmax, num_devices, shard, channels).transpose(
            1, 0, 2, 3
        )
        received = jax.lax.all_to_all(chunks, axis, split_axis=0, concat_axis=0)
    # received[s] = device s's layers restricted to *my* pixel shard
    all_layers = received.reshape(num_devices * lmax, shard, channels)

    # global depth-hint gather + sort (cpp:329-388).  The flattened
    # [device, local] layout is already (owner, local index) ordered, so a
    # stable argsort by depth yields the exact lexicographic order.
    all_hints = jax.lax.all_gather(hints, axis)  # [D, Lmax]
    all_hints = all_hints.reshape(-1, lmax)  # tuple axes gather per-axis dims
    owners = jax.lax.broadcasted_iota(jnp.int32, (num_devices, lmax), 0)
    order = jnp.argsort(all_hints.reshape(-1), stable=True)
    sorted_layers = jnp.take(all_layers, order, axis=0)
    sorted_owners = jnp.take(owners.reshape(-1), order)

    return _composite_sorted_runs(sorted_layers, sorted_owners)


@functools.lru_cache(maxsize=16)  # bounded: each entry pins a Mesh +
# compiled executable for the process lifetime; eviction just recompiles
def _layers_prog(mesh: Mesh, transport: str):
    """Cached jitted program for composite_layers_sharded: the compose
    utilities are called per frame by layer-compositing users, so the
    program must be built once per (mesh, transport), not per call (a
    fresh lambda identity defeats the jit cache and recompiles)."""
    axes = mesh_axes(mesh)
    return jax.jit(
        jax.shard_map(
            lambda l, h: _compose_shard(l, h, transport, axes),
            mesh=mesh,
            in_specs=(P(axes), P(axes)),
            out_specs=P(axes),
        )
    )


def composite_layers_sharded(
    mesh: Mesh,
    layers: jnp.ndarray,  # [D * Lmax, P, 5] global, shardable on axis 0
    hints: jnp.ndarray,  # [D * Lmax]
    transport: str = "float32",
) -> jnp.ndarray:
    """Composite pre-rendered layers across the mesh.  ``P`` must be a
    multiple of the mesh size.  ``transport`` selects the exchange payload
    precision ("float32" exact, "ubyte" = the reference's byte-color
    compositing).  Returns the full [P, 5] frame (sharded on the pixel axis
    across devices)."""
    num_devices = mesh.devices.size
    assert layers.shape[1] % num_devices == 0
    return _layers_prog(mesh, transport)(layers, hints)


# ---------------------------------------------------------------------------
# Local run pre-blend before the layered exchange.
#
# The reference's composeLayered pre-blends each same-owner run locally and
# exchanges ONE flat frame per run — traffic O(runs x pixels), not
# O(layers x pixels) (DirectSendBase.cpp:400-446, pre-blend at 418-425).
# The rebuild's twin: host-side, the global (hint, owner, local) sort is
# cut into maximal same-device runs; each device folds its runs locally
# with the SAME left-associative blend the post-exchange fold would have
# used, ships [Rmax] pre-blended run layers instead of [Lmax] raw layers,
# and the receiving fold blends runs in the global run order.  The fold
# TREE is unchanged (identical blend calls on identical operands), so the
# result is bitwise equal to ``_compose_shard`` — not merely close
# (tests/test_parallel.py pre-blend parity).
# ---------------------------------------------------------------------------


def preblend_plan(
    slot_hints: np.ndarray, rmax_bucket: int = 4, rmax: int | None = None
):
    """Host-side run decomposition of the global layer order.

    ``slot_hints`` is the [D, Lmax] per-device depth-hint table (+inf on
    invalid slots).  Returns ``(local_order, run_slot, perm, rmax)``:

      * ``local_order[d, j]``: which local layer device d folds at step j
        (its layers in global-order restriction);
      * ``run_slot[d, j]``: the device-local run buffer that step writes;
      * ``perm[g]``: flattened ``(device * rmax + slot)`` of the g-th run
        in the global depth order (padding slots follow, blending as
        identity);
      * ``rmax``: run-buffer depth, bucketed to a multiple of
        ``rmax_bucket`` so orbits reuse a handful of compiled shapes.

    Passing ``rmax`` forces that buffer depth (batched chunks share one
    compiled shape across frames); it must cover the frame's run count.
    """
    slot_hints = np.asarray(slot_hints)
    num_devices, lmax = slot_hints.shape
    owner = np.repeat(np.arange(num_devices), lmax)
    local = np.tile(np.arange(lmax), num_devices)
    flat = slot_hints.reshape(-1)
    order = np.lexsort((local, owner, flat))
    seq_owner = order // lmax
    # invalid (+inf) slots sort to the global tail and blend as exact
    # identities: they join their device's LAST valid run instead of
    # forming an artificial trailing run each (which would inflate rmax
    # and could spuriously defeat the pre-blend on padded scenes).
    # "valid" = sorts before the +inf tail: -inf is a legitimate
    # front-most hint at the HEAD of the order (isfinite would misfile
    # it into the tail partition and misalign the runs); NaN lexsorts
    # last and compares false, matching the tail either way
    num_valid = int((flat[order] < np.inf).sum())
    vo = seq_owner[:num_valid]
    run_break = np.ones(num_valid, bool)
    run_break[1:] = vo[1:] != vo[:-1]
    run_gid = np.cumsum(run_break) - 1  # valid-run id per sorted position
    run_owner = vo[run_break]  # [R] owner of each valid run, global order
    num_runs = len(run_owner)
    # device-local slot of each run = occurrence index within its owner
    by_owner = np.argsort(run_owner, kind="stable")
    sorted_owner = run_owner[by_owner]
    occ = np.arange(num_runs) - np.searchsorted(sorted_owner, sorted_owner)
    slot_of_run = np.empty(num_runs, np.int64)
    slot_of_run[by_owner] = occ
    counts = np.bincount(run_owner, minlength=num_devices)
    need = max(int(counts.max()) if num_runs else 1, 1)
    if rmax is None:
        rmax = -(-need // rmax_bucket) * rmax_bucket
    elif rmax < need:
        raise ValueError(f"forced rmax={rmax} < required run depth {need}")
    # per-device step tables: each device owns exactly lmax sorted
    # positions (its valid ones first), so a stable owner-sort groups
    # them in sequence order
    slot_flat = np.full(len(order), -1, np.int64)
    slot_flat[:num_valid] = slot_of_run[run_gid]
    grouped = np.argsort(seq_owner, kind="stable").reshape(num_devices, lmax)
    local_order = local[order][grouped].astype(np.int32)
    slot_mat = slot_flat[grouped]
    n_valid_d = (slot_mat >= 0).sum(axis=1)
    last_valid = np.where(
        n_valid_d > 0,
        slot_mat[np.arange(num_devices), np.maximum(n_valid_d - 1, 0)],
        0,
    )
    run_slot = np.where(
        slot_mat >= 0, slot_mat, last_valid[:, None]
    ).astype(np.int32)
    # global run order -> flattened (device, slot); padding slots trail
    perm = np.empty(num_devices * rmax, np.int64)
    perm[:num_runs] = run_owner * rmax + slot_of_run
    used = np.zeros(num_devices * rmax, bool)
    used[perm[:num_runs]] = True
    perm[num_runs:] = np.flatnonzero(~used)
    return local_order, run_slot, perm.astype(np.int32), int(rmax)


def _preblend_runs_scan(
    render_one,  # j -> [P, 5] layer for local piece j (cleared if invalid)
    lmax: int,
    local_order: jnp.ndarray,  # [Lmax] fold order (preblend_plan)
    run_slot: jnp.ndarray,  # [Lmax] run buffer per fold step
    rmax: int,
    num_pixels: int,
    channels: int = 5,
) -> jnp.ndarray:
    """Fold local layers into [rmax, P, 5] pre-blended run buffers,
    obtaining each layer through ``render_one`` inside the fold body.

    The intra-run fold is ``blend_depth_sort(run_acc, layer)`` in
    global-order restriction — the exact sub-tree
    ``_composite_sorted_runs`` would have computed for the same run.
    Unused run buffers hold the identity layer (zeros, depth +inf).
    Deep-AMR shards (many pieces per device) use this directly so the
    O(pieces x pixels) layer stack never materializes — peak memory is
    O(runs x pixels) + one in-flight layer; ``_preblend_runs`` wraps it
    for pre-rendered stacks (ONE copy of the load-bearing fold tree)."""
    from ..image import blend_depth_sort

    # derive the carry from a varying input so its axis types match the
    # body outputs under shard_map; the empty-sum form also covers
    # lmax == 0 (indexing run_slot[0] would raise there)
    vary0 = (run_slot.sum() * 0).astype(jnp.float32)
    identity = (
        jnp.zeros((num_pixels, channels), jnp.float32) + vary0
    ).at[:, 4].set(jnp.inf)
    out0 = jnp.zeros((rmax, 1, 1), jnp.float32) + identity[None]
    if lmax == 0:
        return out0

    def body(i, carry):
        out, run_acc, prev_slot = carry
        layer = render_one(local_order[i])
        slot = run_slot[i]
        same = jnp.logical_and(i > 0, slot == prev_slot)
        # close the previous run buffer when the slot changes (the write
        # is unconditional but value-predicated: O(P) per step)
        closed = jnp.where(same, out[prev_slot], run_acc)
        out = out.at[prev_slot].set(closed)
        run_acc = jnp.where(same, blend_depth_sort(run_acc, layer), layer)
        return out, run_acc, slot

    out, run_acc, prev_slot = jax.lax.fori_loop(
        0, lmax, body, (out0, identity, run_slot[0] * 0)
    )
    return out.at[prev_slot].set(run_acc)


def _preblend_runs(
    layers: jnp.ndarray,  # [Lmax, P, 5] this device's layers (cleared if invalid)
    local_order: jnp.ndarray,  # [Lmax] fold order (preblend_plan)
    run_slot: jnp.ndarray,  # [Lmax] run buffer per fold step
    rmax: int,
) -> jnp.ndarray:
    """``_preblend_runs_scan`` over a pre-rendered layer stack."""
    lmax, num_pixels, channels = layers.shape
    return _preblend_runs_scan(
        lambda j: layers[j], lmax, local_order, run_slot, rmax,
        num_pixels, channels,
    )


def _exchange_and_fold_runs(
    runs: jnp.ndarray,  # [rmax, P, 5] this device's pre-blended run layers
    perm: jnp.ndarray,  # [D * rmax] replicated global run order
    transport: str = "float32",
    axis=AXIS,
) -> jnp.ndarray:
    """Exchange pre-blended run layers and fold them in global order —
    the shared tail of the pre-blend compose paths."""
    num_devices = jax.lax.psum(1, axis)
    rmax, num_pixels, channels = runs.shape
    shard = num_pixels // num_devices

    if transport == "ubyte":
        color_u8 = _encode_ubyte(runs[..., :4])
        depth = runs[..., 4]
        c_chunks = color_u8.reshape(rmax, num_devices, shard, 4).transpose(
            1, 0, 2, 3
        )
        d_chunks = depth.reshape(rmax, num_devices, shard).transpose(1, 0, 2)
        rc = jax.lax.all_to_all(c_chunks, axis, split_axis=0, concat_axis=0)
        rd = jax.lax.all_to_all(d_chunks, axis, split_axis=0, concat_axis=0)
        received = jnp.concatenate(
            [_decode_ubyte(rc), rd[..., None]], axis=-1
        )
    else:
        chunks = runs.reshape(rmax, num_devices, shard, channels).transpose(
            1, 0, 2, 3
        )
        received = jax.lax.all_to_all(
            chunks, axis, split_axis=0, concat_axis=0
        )
    all_runs = received.reshape(num_devices * rmax, shard, channels)
    sorted_runs = jnp.take(all_runs, perm, axis=0)
    # every pre-blended run is its own closed group: distinct owner ids
    # make _composite_sorted_runs fold them left-associatively in order —
    # the exact cross-run fold of the non-pre-blended path
    run_ids = jax.lax.iota(jnp.int32, num_devices * rmax)
    return _composite_sorted_runs(sorted_runs, run_ids)


def _compose_shard_preblend(
    layers: jnp.ndarray,  # [Lmax, P, 5] this device's layers (cleared if invalid)
    local_order: jnp.ndarray,  # [Lmax]
    run_slot: jnp.ndarray,  # [Lmax]
    perm: jnp.ndarray,  # [D * rmax] replicated global run order
    rmax: int,
    transport: str = "float32",
    axis=AXIS,
) -> jnp.ndarray:
    """``_compose_shard`` with the run pre-blend: exchange O(runs) pre-
    blended layers instead of O(layers), then fold runs in global order.
    Bitwise-identical output (see the section comment)."""
    runs = _preblend_runs(layers, local_order, run_slot, rmax)
    return _exchange_and_fold_runs(runs, perm, transport, axis)


@functools.lru_cache(maxsize=16)
def _layers_preblend_prog(mesh: Mesh, transport: str, rmax: int):
    axes = mesh_axes(mesh)

    def body(layers, local_order, run_slot, perm):
        return _compose_shard_preblend(
            layers, local_order[0], run_slot[0], perm, rmax, transport, axes
        )

    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axes), P(axes), P(axes), P()),
            out_specs=P(axes),
        )
    )


def composite_layers_sharded_preblend(
    mesh: Mesh,
    layers: jnp.ndarray,  # [D * Lmax, P, 5] global, shardable on axis 0
    hints: np.ndarray,  # [D * Lmax] HOST depth hints (+inf on invalid)
    transport: str = "float32",
) -> jnp.ndarray:
    """``composite_layers_sharded`` with the reference's local run
    pre-blend (DirectSendBase.cpp:418-425): exchange traffic
    O(runs x pixels).  ``transport="float32"`` is bitwise-identical to
    the non-pre-blended exchange (same fold tree); ``"ubyte"`` quantizes
    each pre-blended RUN on the wire — the reference's quantization
    point (pre-blend first, byte send after) — where the non-pre-blended
    path quantizes every raw layer, so the two byte modes agree only
    within codec tolerance.  ``hints`` must be host-resident (the run
    decomposition is per-frame host prep, like the reference's order
    computation on rank 0)."""
    num_devices = mesh.devices.size
    assert layers.shape[1] % num_devices == 0
    slot_hints = np.asarray(hints).reshape(num_devices, -1)
    local_order, run_slot, perm, rmax = preblend_plan(slot_hints)
    return _layers_preblend_prog(mesh, transport, rmax)(
        layers, jnp.asarray(local_order), jnp.asarray(run_slot),
        jnp.asarray(perm),
    )


def render_and_composite_sharded(
    mesh: Mesh,
    data: jnp.ndarray,  # [D * Bmax, nx, ny, nz] padded brick values
    min_corner: jnp.ndarray,  # [D * Bmax, 3]
    max_corner: jnp.ndarray,  # [D * Bmax, 3]
    cell_dims: jnp.ndarray,  # [D * Bmax, 3] int32
    color_table: jnp.ndarray,  # [D * Bmax, size, 4] (size = lut_size)
    sample_distance: jnp.ndarray,  # [D * Bmax]
    valid: jnp.ndarray,  # [D * Bmax] bool — padding slots are False
    depth_hints: jnp.ndarray,  # [D * Bmax] float32 (+inf for padding)
    camera_arrays: Tuple[jnp.ndarray, ...],  # eye, forward, right, up
    fov_y_degrees: float,
    range_min: float,
    inverse_range: float,
    transform_scalars: Tuple[float, float, float],
    *,
    width: int,
    height: int,
    num_steps: int,
    log_scale: bool,
    normalize: bool,
    clip_start: float,
    apply_clip: bool,
):
    """The full multi-chip frame: sharded render + exchange + ordered fold.

    Brick-table arrays are sharded over the mesh on their leading axis
    (``Bmax`` bricks per device, padded); the result is the composited
    [width * height, 5] frame, pixel-sharded across devices.
    """
    eye, fwd, right, up = camera_arrays
    positive_floor, normalization_min, inverse_normalization_span = transform_scalars
    num_devices = mesh.devices.size
    num_pixels = width * height
    assert num_pixels % num_devices == 0, (
        "width * height must be divisible by the mesh size"
    )

    def step(b_data, b_min, b_max, b_dims, b_lut, b_step, b_valid, b_hints):
        colors, depths = render_bucket_impl(
            b_data,
            b_min,
            b_max,
            b_dims,
            b_lut,
            b_step,
            eye,
            fwd,
            right,
            up,
            jnp.float32(fov_y_degrees),
            jnp.float32(range_min),
            jnp.float32(inverse_range),
            jnp.float32(positive_floor),
            jnp.float32(normalization_min),
            jnp.float32(inverse_normalization_span),
            width=width,
            height=height,
            num_steps=num_steps,
            log_scale=log_scale,
            normalize=normalize,
            clip_start=clip_start,
            apply_clip=apply_clip,
        )
        layers = jnp.concatenate([colors, depths[..., None]], axis=-1)
        # clear padding slots so they blend as identity
        mask = b_valid[:, None, None]
        cleared = jnp.zeros_like(layers).at[..., 4].set(jnp.inf)
        layers = jnp.where(mask, layers, cleared)
        hints = jnp.where(b_valid, b_hints, jnp.inf)
        return _compose_shard(layers, hints, "float32", axes)

    axes = mesh_axes(mesh)
    sharded = jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(axes),) * 8,
            out_specs=P(axes),
        )
    )
    return sharded(
        data,
        min_corner,
        max_corner,
        cell_dims,
        color_table,
        sample_distance,
        valid,
        depth_hints,
    )


def shard_leading(mesh: Mesh, *arrays):
    """Place arrays with their leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(mesh_axes(mesh)))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def render_and_composite_sharded_slicemarch(
    mesh: Mesh,
    vol: jnp.ndarray,  # [D * Bmax, S_max, 8, 128] packed slice bricks
    meta: jnp.ndarray,  # [D * Bmax, 12]
    dims: jnp.ndarray,  # [D * Bmax, 8]
    lut: jnp.ndarray,  # [D * Bmax, 4, size // 128, 128]
    cam: jnp.ndarray,  # [20]
    valid: jnp.ndarray,  # [D * Bmax] bool
    depth_hints: jnp.ndarray,  # [D * Bmax] float32 (+inf for padding)
    *,
    width: int,
    height: int,
    max_slices: int,
    logical_width: int | None = None,
    logical_height: int | None = None,
    transport: str = "float32",
    sampling: str = "nearest",
    classification: str = "post",
    ghost: int = 0,
    rect=None,
    tiles=None,
):
    """Multi-device frame on the slice march.

    Same collective structure as ``render_and_composite_sharded`` but the
    per-device render runs the dense slice march
    (``slicemarch.slicemarch_render``).  ``cam`` is replicated; the brick table is
    sharded on its leading axis; the result is the composited
    [width * height, 5] frame, pixel-sharded across the mesh.
    """
    from ..ops.slicemarch import slicemarch_render

    num_devices = mesh.devices.size
    num_pixels = _compact_pixels(rect, tiles, width, height)
    assert num_pixels % num_devices == 0

    def step(b_vol, b_meta, b_dims, b_lut, b_valid, b_hints):
        colors, depths = slicemarch_render(
            b_vol, b_meta, b_dims, b_lut, cam,
            width=width, height=height, max_slices=max_slices,
            logical_width=logical_width, logical_height=logical_height,
            sampling=sampling, ghost=ghost,
            classification=classification,
        )
        layers = jnp.concatenate([colors, depths[..., None]], axis=-1)
        mask = b_valid[:, None, None]
        cleared = jnp.zeros_like(layers).at[..., 4].set(jnp.inf)
        layers = jnp.where(mask, layers, cleared)
        # coverage-compacted exchange: only the union screen rect (or the
        # active-tile list, for bimodal coverage) crosses the links
        layers = _slice_tiles(_slice_rect(layers, rect, width, height),
                              tiles[0] if tiles else None)
        hints = jnp.where(b_valid, b_hints, jnp.inf)
        return _compose_shard(layers, hints, transport, axes)

    axes = mesh_axes(mesh)
    sharded = jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(axes),) * 6,
            out_specs=P(axes),
        )
    )
    return sharded(vol, meta, dims, lut, valid, depth_hints)


def compose_flat_sharded(
    mesh: Mesh,
    images: jnp.ndarray,  # [D, P, C] one full image per device (premult RGBA)
    group_order: np.ndarray,  # [D] visibility permutation; first = on top
):
    """Flat direct-send compose of non-layered images on the mesh.

    The device equivalent of the reference's static compose
    (DirectSendBase.cpp:257-314) for order-dependent over blending: every
    device's image is split into per-device pixel pieces with one
    ``all_to_all``, and each device folds the D pieces for its shard in
    *group order* (earlier group member on top, Compositor.hpp:26-29).
    Returns the [P, C] composited frame, pixel-sharded across the mesh.
    """
    num_devices = mesh.devices.size
    assert images.shape[0] == num_devices
    assert images.shape[1] % num_devices == 0
    order = jnp.asarray(np.asarray(group_order, dtype=np.int32))
    return _flat_prog(mesh)(images, order)


@functools.lru_cache(maxsize=16)  # bounded: each entry pins a Mesh +
# compiled executable for the process lifetime; eviction just recompiles
def _flat_prog(mesh: Mesh):
    """Cached jitted program for compose_flat_sharded (the group order is
    a traced argument, so one program serves every frame/permutation)."""
    axes = mesh_axes(mesh)
    num_devices = mesh.devices.size

    def shard_body(img, order):
        # img: [1, P, C] this device's image; order: [D] replicated
        _, num_pixels, channels = img.shape
        shard = num_pixels // num_devices
        chunks = img.reshape(num_devices, shard, channels)
        received = jax.lax.all_to_all(
            chunks, axes, split_axis=0, concat_axis=0
        )  # [D, shard, C]: sender s's piece for my shard

        def body(i, acc):
            piece = received[order[i]]
            # acc is on top of the next piece (group order = blend order)
            return acc + piece * (1.0 - acc[:, 3:4])

        first = received[order[0]]
        return jax.lax.fori_loop(1, num_devices, body, first)

    return jax.jit(
        jax.shard_map(
            shard_body, mesh=mesh, in_specs=(P(axes), P()), out_specs=P(axes),
        )
    )


def _contiguous_chunk_counts(n: int, num_devices: int):
    """Nearly-equal contiguous chunk sizes (remainder spread over the
    first chunks) — the ONE place the depth-contiguous split policy
    lives, shared by depth_contiguous_assignment / pack_depth_contiguous
    / pack_contiguous so the pipelines can never disagree on placement."""
    base, extra = n // num_devices, n % num_devices
    return [base + (1 if d < extra else 0) for d in range(num_devices)]


def _exchange_fold_partials(partial, num_devices, shard, transport, axes):
    """Exchange D depth-contiguous partial frames (one per device) and
    fold them in device order — device order IS depth order (see
    composite_partials_sharded for the exactness argument).

    ``transport="ubyte"`` ships the partials' colors as bytes (the
    reference's color-ubyte compositing axis, ImageRGBAUByteColor*) for
    2.5x less link traffic per partial."""
    if transport == "ubyte":
        cb = _encode_ubyte(partial[:, :4]).reshape(num_devices, shard, 4)
        db = partial[:, 4].reshape(num_devices, shard)
        rc = jax.lax.all_to_all(cb, axes, split_axis=0, concat_axis=0)
        rd = jax.lax.all_to_all(db, axes, split_axis=0, concat_axis=0)
        received = jnp.concatenate([_decode_ubyte(rc), rd[..., None]], axis=-1)
    else:
        chunks = partial.reshape(num_devices, shard, partial.shape[-1])
        received = jax.lax.all_to_all(chunks, axes, split_axis=0, concat_axis=0)
    run_keys = jax.lax.broadcasted_iota(jnp.int32, (num_devices, 1), 0)[:, 0]
    return _composite_sorted_runs(received, run_keys)


def depth_contiguous_assignment(
    depth_hints: np.ndarray,
    owners_hint_ties: np.ndarray,
    num_devices: int,
) -> np.ndarray:
    """Assign bricks to devices in depth-contiguous blocks for this frame.

    When each device owns a *contiguous run* of the global depth order, it
    can fully pre-composite its bricks locally and the cross-device step
    reduces to folding D single frames in device order — the communication
    drops from (layers x pixels) to (devices x pixels).  This trades
    per-frame brick resharding for minimal link traffic; the reference's
    static DistributionMapping instead pays the full layered exchange
    (DirectSendBase.cpp:316-458).

    Returns device_of_brick [N]: bricks sorted by (hint, tie) are split into
    ``num_devices`` nearly equal contiguous chunks.
    """
    from ..compositor import sort_layers

    n = len(depth_hints)
    order = sort_layers(
        np.asarray(depth_hints), np.asarray(owners_hint_ties),
        np.arange(n, dtype=np.int32),
    )
    device_of_brick = np.zeros(n, dtype=np.int32)
    pos = 0
    for d, count in enumerate(_contiguous_chunk_counts(n, num_devices)):
        device_of_brick[order[pos : pos + count]] = d
        pos += count
    return device_of_brick


def composite_partials_sharded(
    mesh: Mesh,
    partials: jnp.ndarray,  # [D, P, 5] per-device pre-composited frames,
    #                          device d's partial covers depth run d
    transport: str = "float32",
) -> jnp.ndarray:
    """Fold depth-contiguous per-device partial frames front-to-back.

    Device order IS the depth order (see depth_contiguous_assignment), so
    the fold is the blend of D layers — one all_to_all pixel-shard exchange
    of D frames instead of the full layered exchange.

    Exactness note: pre-compositing runs is equivalent to the global fold
    when each pixel's per-layer depths sort consistently with the run
    grouping.  With piece-level visibility-graph keys as the ordering
    (visibility.piece_order_keys, the default since round 3) the
    placement order is view-consistent for EVERY ray over the convexified
    partition, so the run grouping is exact by construction; on the
    scalar-hint fallback it holds for spatially disjoint AMR bricks
    (a ray crosses bricks in depth-hint order).  Empty pixels (depth
    +inf) blend as identity and do not disturb this.  The per-pixel
    blend() itself picks the nearer layer as "front" from the depth
    channel, so key TIES and in-cloud/boundary cameras stay exact as
    long as bricks are disjoint — stress-tested against the layered
    exchange and the single-device fold in tests/test_depth_envelope.py
    (camera inside the cloud, exact hint ties split across devices, eye
    on a shared brick corner).
    """
    num_devices = mesh.devices.size
    assert partials.shape[0] == num_devices
    assert partials.shape[1] % num_devices == 0
    return _partials_prog(mesh, transport)(partials)


@functools.lru_cache(maxsize=16)  # bounded: each entry pins a Mesh +
# compiled executable for the process lifetime; eviction just recompiles
def _partials_prog(mesh: Mesh, transport: str):
    """Cached jitted program for composite_partials_sharded."""
    axes = mesh_axes(mesh)
    num_devices = mesh.devices.size

    def body(img):
        # img [1, P, 5]; exchange pixel shards, fold D partials in order
        _, num_pixels, _ = img.shape
        shard = num_pixels // num_devices
        return _exchange_fold_partials(
            img[0], num_devices, shard, transport, axes
        )

    return jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=P(axes), out_specs=P(axes))
    )


def pack_depth_contiguous(
    depth_hints: np.ndarray,
    owners_hint_ties: np.ndarray,
    num_devices: int,
    *arrays: np.ndarray,
):
    """Host-side per-frame repack for the depth-contiguous pipeline.

    Scatters global brick arrays (leading axis = brick) into depth-ordered
    per-device slots ``[D * Bmax, ...]``: device ``d`` receives the ``d``-th
    contiguous chunk of the global depth order, with padding slots cleared.
    Returns ``(packed_arrays, valid, packed_hints)``; slot order within a
    device is the global depth order, so a stable in-device sort by the
    packed hints reproduces it.
    """
    from ..compositor import sort_layers

    n = len(depth_hints)
    order = sort_layers(
        np.asarray(depth_hints), np.asarray(owners_hint_ties),
        np.arange(n, dtype=np.int32),
    )
    return _pack_slots(order, np.asarray(depth_hints), num_devices, arrays)


def _pack_slots(order, depth_hints, num_devices, arrays):
    """Scatter bricks (taken in ``order``) into contiguous per-device slot
    chunks padded to a common Bmax — the shared body of pack_contiguous
    and pack_depth_contiguous."""
    n = len(order)
    counts = _contiguous_chunk_counts(n, num_devices)
    bmax = max(max(counts), 1)
    total = num_devices * bmax

    valid = np.zeros(total, dtype=bool)
    packed_hints = np.full(total, np.inf, dtype=np.float32)
    packed = [
        np.zeros((total,) + a.shape[1:], dtype=a.dtype) for a in arrays
    ]
    pos = 0
    for d in range(num_devices):
        for slot in range(counts[d]):
            src = int(order[pos])
            dst = d * bmax + slot
            valid[dst] = True
            packed_hints[dst] = depth_hints[src]
            for p, a in zip(packed, arrays):
                p[dst] = a[src]
            pos += 1
    return tuple(packed), valid, packed_hints


def coverage_rect(
    coverage: np.ndarray,  # [B, T] bool tile coverage (from compute_worklist)
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    num_devices: int,
):
    """Union screen rectangle of all bricks' projected bboxes, tile-aligned.

    The array descendant of the reference's sparse-image transport
    intent (ImageSparseColorOnly.hpp:98-199: RLE-compress the wire payload
    to foreground pixels): XLA collectives need static shapes, so instead
    of runs we exchange only the tile-aligned bounding rectangle that any
    brick can touch — pixels outside it are background on every device and
    never cross the links.  Returns ``(x0, y0, rw, rh)`` in pixels, or None
    when the full frame is covered (or the rect's pixel count does not
    divide the mesh; tile alignment makes that impossible for power-of-two
    meshes up to tile_w * tile_h devices).
    """
    tiles_x = width // tile_w
    tiles_y = height // tile_h
    tiles = np.asarray(coverage).any(axis=0).reshape(tiles_y, tiles_x)
    ys, xs = np.nonzero(tiles)
    if len(xs) == 0:
        # degenerate: one background tile — but only when its pixel count
        # still divides the mesh (the same guard as the normal branch;
        # otherwise the full-frame fallback keeps shapes shardable)
        if (tile_w * tile_h) % num_devices:
            return None
        return (0, 0, tile_w, tile_h)
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    rw = (x1 - x0) * tile_w
    rh = (y1 - y0) * tile_h
    if rw * rh >= width * height or (rw * rh) % num_devices:
        return None
    return (x0 * tile_w, y0 * tile_h, rw, rh)


def _compact_pixels(rect, tiles, width: int, height: int) -> int:
    """Exchanged pixel count under the selected compaction."""
    if rect:
        return rect[2] * rect[3]
    if tiles:
        return len(tiles[0])
    return width * height


def coverage_tiles(
    coverage: np.ndarray,  # [B, T] bool tile coverage (from compute_worklist)
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    num_devices: int,
):
    """Active-tile compaction of the exchange payload.

    Where ``coverage_rect`` degrades to the full frame for bimodal scenes
    (one cluster at each frame corner defeats a union rectangle), the tile
    list carries exactly the tiles any brick projects to — the static-shape
    equivalent of the reference's per-run RLE compression
    (ImageSparse.hpp:17-150: ship foreground runs, skip background).

    Always returns ``(pix_idx, valid_pixels, fraction)`` (for empty
    coverage a single placeholder tile keeps the shapes well-formed —
    the caller, ``select_compaction``, is what decides whether the
    fraction is worth compacting and substitutes None when not):
    ``pix_idx`` [P_pad] int32 gathers the active tiles' pixels from a
    row-major frame (tail entries repeat pixel 0 so P_pad divides the
    mesh — read-only duplicates, dropped on paste), ``valid_pixels`` is
    the un-padded count, ``fraction`` the active-tile fraction.
    """
    tiles_x = width // tile_w
    tiles_y = height // tile_h
    active = np.flatnonzero(np.asarray(coverage).any(axis=0))
    n_tiles = tiles_x * tiles_y
    if len(active) == 0:
        active = np.array([0], np.int64)
    fraction = len(active) / n_tiles
    # tile-local pixel offsets in row-major frame coordinates
    ty, tx = np.divmod(active, tiles_x)
    base = (ty * tile_h)[:, None] * width + (tx * tile_w)[:, None]  # [A, 1]
    dy = np.arange(tile_h)[:, None] * width
    dx = np.arange(tile_w)[None, :]
    local = (dy + dx).reshape(-1)[None, :]  # [1, tile_pixels]
    pix_idx = (base + local).reshape(-1)
    valid = len(pix_idx)
    pad = (-valid) % num_devices
    if pad:
        pix_idx = np.concatenate([pix_idx, np.zeros(pad, pix_idx.dtype)])
    return pix_idx.astype(np.int32), valid, fraction


def select_compaction(
    coverage: np.ndarray,
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    num_devices: int,
):
    """Pick the exchange compaction for this frame: ``(rect, tiles)``.

    The union rect wins when coverage is contiguous (a contiguous slice
    beats a gather at similar payload); the tile list wins when the rect
    over-covers (bimodal/corner-cluster scenes).  At most one of the two
    return values is not None; (None, None) means exchange the full frame.
    """
    rect = coverage_rect(
        coverage, width, height, tile_w, tile_h, num_devices
    )
    # decide on the COUNT alone (padded exactly as coverage_tiles pads);
    # the per-pixel gather-index table is built only if tiles win — on a
    # mostly-covered HD frame it is megabytes of immediately-dropped int32
    n_active = max(
        int(np.asarray(coverage).any(axis=0).sum()), 1
    )
    tile_payload = n_active * tile_w * tile_h
    tile_payload += (-tile_payload) % num_devices
    frame_pixels = width * height
    rect_payload = rect[2] * rect[3] if rect else frame_pixels
    # prefer the contiguous rect unless tiles cut the payload by >= 30%
    if tile_payload < 0.7 * rect_payload and tile_payload < 0.9 * frame_pixels:
        return None, coverage_tiles(
            coverage, width, height, tile_w, tile_h, num_devices
        )
    return rect, None


def _slice_tiles(frames: jnp.ndarray, pix_idx):
    """Restrict [..., H*W, C] frames to the active-tile pixels."""
    if pix_idx is None:
        return frames
    return jnp.take(frames, jnp.asarray(pix_idx), axis=-2)


def paste_tiles(
    compact: np.ndarray, tiles, width: int, height: int
) -> np.ndarray:
    """Host-side inverse of ``_slice_tiles``: scatter the composited active
    pixels back into a background full frame (rgba 0, depth +inf)."""
    if tiles is None:
        return compact
    pix_idx, valid, _fraction = tiles
    out = np.zeros((width * height, compact.shape[-1]), compact.dtype)
    out[:, 4] = np.inf
    out[pix_idx[:valid]] = compact[:valid]
    return out


def _slice_rect(frames: jnp.ndarray, rect, width: int, height: int):
    """Restrict [..., H*W, C] frames to the coverage rect -> [..., rh*rw, C]."""
    if rect is None:
        return frames
    x0, y0, rw, rh = rect
    lead = frames.shape[:-2]
    c = frames.shape[-1]
    img = frames.reshape(lead + (height, width, c))
    img = img[..., y0 : y0 + rh, x0 : x0 + rw, :]
    return img.reshape(lead + (rh * rw, c))


def paste_rect(
    rect_frame: np.ndarray, rect, width: int, height: int
) -> np.ndarray:
    """Host-side inverse of ``_slice_rect``: paste the composited rect back
    into a background full frame (rgba 0, depth +inf)."""
    if rect is None:
        return rect_frame
    x0, y0, rw, rh = rect
    out = np.zeros((height, width, rect_frame.shape[-1]), rect_frame.dtype)
    out[..., 4] = np.inf
    out[y0 : y0 + rh, x0 : x0 + rw] = rect_frame.reshape(rh, rw, -1)
    return out.reshape(width * height, -1)


def pack_contiguous(
    num_devices: int,
    depth_hints: np.ndarray,
    *arrays: np.ndarray,
):
    """Host-side packer for the *layered* multi-chip pipeline.

    Splits brick arrays (leading axis = brick, already in (owner, local
    index) order) into ``num_devices`` contiguous chunks padded to a common
    ``Bmax``, preserving brick order.  The flattened [device, slot] layout of
    the packed table is then exactly the global (owner, local) order, so the
    stable depth-hint argsort inside ``_compose_shard`` reproduces the
    reference's (depth, owner, local) lexicographic layer order
    (DirectSendBase.cpp:378-388).

    Returns ``(packed_arrays, valid, packed_hints)``.
    """
    n = len(depth_hints)
    return _pack_slots(
        np.arange(n, dtype=np.int32), np.asarray(depth_hints),
        num_devices, arrays,
    )


def render_depth_contiguous_tilemarch(
    mesh: Mesh,
    vol: jnp.ndarray,  # [D * Bmax, S_max, 8, 128] depth-contiguous packing
    meta: jnp.ndarray,  # [D * Bmax, 12]
    dims: jnp.ndarray,  # [D * Bmax, 8]
    lut: jnp.ndarray,  # [4, size // 128, LANES] shared transfer function
    cam: jnp.ndarray,  # [20]
    tile_offsets: jnp.ndarray,  # [D, T + 1] per-device CSR offsets
    tile_bricks: jnp.ndarray,  # [D, Wmax] per-device LOCAL slot ids
    tile_owners: jnp.ndarray,  # [D, Wmax] per-device run keys (slot order)
    item_bounds: jnp.ndarray,  # [D, Wmax] per-item occupied-slice bounds
    *,
    width: int,
    height: int,
    max_slices: int,
    logical_width: int | None = None,
    logical_height: int | None = None,
    sampling: str = "nearest",
    classification: str = "post",
    ghost: int = 0,
    transport: str = "float32",
    rect=None,
    tiles=None,
):
    """Depth-contiguous multi-device frame through the tile loop.

    The slicemarch depth pipeline materializes a full-frame layer per local
    piece before its pre-composite — O(pieces x pixels) HBM per device,
    the exact cost ops/tilemarch.py exists to remove.  Here each device
    renders AND pre-composites its contiguous depth run in one kernel pass
    (per-tile CSR work lists over its LOCAL slots, every item its own run
    so consecutive pieces blend by per-pixel depth exactly like the
    slicemarch path's ``_composite_sorted_runs`` over slot order), then the
    cross-device exchange folds D partial frames as before.  Per-device
    HBM becomes O(pixels), independent of piece count — deep-AMR scenes
    route here above the same threshold as single-device rendering.
    Matches the reference's DirectSend/Base/DirectSendBase.cpp:316-458
    (the exchange) with the reference's per-box layer buffers fused away.
    """
    from ..ops.slicemarch import TILE_H, TILE_W
    from ..ops.tilemarch import tilemarch_render

    num_devices = mesh.devices.size
    num_pixels = _compact_pixels(rect, tiles, width, height)
    assert num_pixels % num_devices == 0

    def step(b_vol, b_meta, b_dims, offsets, bricks, owners, ibounds):
        out_c, out_d = tilemarch_render(
            b_vol, b_meta, b_dims, lut, cam,
            offsets[0], bricks[0], owners[0], ibounds[0],
            width=width, height=height, max_slices=max_slices,
            logical_width=logical_width, logical_height=logical_height,
            sampling=sampling, ghost=ghost,
            classification=classification,
        )
        # tile space -> row-major [P, 5] partial frame
        tiles_x = width // TILE_W
        tiles_y = height // TILE_H
        c = out_c.reshape(tiles_y, tiles_x, 4, TILE_H, TILE_W)
        c = c.transpose(0, 3, 1, 4, 2).reshape(width * height, 4)
        d = out_d.reshape(tiles_y, tiles_x, TILE_H, TILE_W)
        d = d.transpose(0, 2, 1, 3).reshape(width * height, 1)
        partial = jnp.concatenate([c, d], axis=-1)
        partial = _slice_tiles(
            _slice_rect(partial, rect, width, height),
            tiles[0] if tiles else None,
        )

        # device order IS depth order: exchange + fold the D partials
        return _exchange_fold_partials(
            partial, num_devices, num_pixels // num_devices, transport, axes
        )

    axes = mesh_axes(mesh)
    sharded = jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(axes),) * 7,
            out_specs=P(axes),
            # on the GPU the tile loop is a pallas_call, whose out_shape
            # carries no varying-axes information
            check_vma=False,
        )
    )
    return sharded(
        vol, meta, dims, tile_offsets, tile_bricks, tile_owners, item_bounds
    )


def render_depth_contiguous_slicemarch(
    mesh: Mesh,
    vol: jnp.ndarray,  # [D * Bmax, S_max, 8, 128] depth-contiguous packing
    meta: jnp.ndarray,  # [D * Bmax, 12]
    dims: jnp.ndarray,  # [D * Bmax, 8]
    lut: jnp.ndarray,  # [D * Bmax, 4, size // 128, 128]
    cam: jnp.ndarray,  # [20]
    valid: jnp.ndarray,  # [D * Bmax] bool
    depth_hints: jnp.ndarray,  # [D * Bmax] float32 (+inf for padding)
    *,
    width: int,
    height: int,
    max_slices: int,
    logical_width: int | None = None,
    logical_height: int | None = None,
    sampling: str = "nearest",
    classification: str = "post",
    ghost: int = 0,
    transport: str = "float32",
    rect=None,
    tiles=None,
):
    """Depth-contiguous multi-chip frame: minimal-link-traffic pipeline.

    Inputs come from ``pack_depth_contiguous``: each device owns a
    *contiguous run* of the frame's global depth order, renders its bricks
    with the slice-march kernel, pre-composites them locally, and the
    cross-device exchange is one all_to_all of D single frames — traffic
    O(devices x pixels) instead of O(layers x pixels).  The reference's
    static DistributionMapping always pays the layered exchange
    (DirectSendBase.cpp:316-458); per-frame brick re-placement is what the
    device's fast host->device path buys us.  Exact for depth-consistent
    scenes (spatially disjoint AMR bricks; see composite_partials_sharded).
    """
    from ..ops.slicemarch import slicemarch_render

    num_devices = mesh.devices.size
    num_pixels = _compact_pixels(rect, tiles, width, height)
    assert num_pixels % num_devices == 0

    def step(b_vol, b_meta, b_dims, b_lut, b_valid, b_hints):
        colors, depths = slicemarch_render(
            b_vol, b_meta, b_dims, b_lut, cam,
            width=width, height=height, max_slices=max_slices,
            logical_width=logical_width, logical_height=logical_height,
            sampling=sampling, ghost=ghost,
            classification=classification,
        )
        layers = jnp.concatenate([colors, depths[..., None]], axis=-1)
        mask = b_valid[:, None, None]
        cleared = jnp.zeros_like(layers).at[..., 4].set(jnp.inf)
        layers = jnp.where(mask, layers, cleared)
        # coverage-compacted exchange (see coverage_rect/coverage_tiles):
        # pre-composite and exchange only the covered pixels
        layers = _slice_tiles(_slice_rect(layers, rect, width, height),
                              tiles[0] if tiles else None)
        hints = jnp.where(b_valid, b_hints, jnp.inf)

        # local pre-composite of this device's depth run (front-to-back)
        lmax = layers.shape[0]
        order = jnp.argsort(hints, stable=True)
        sorted_layers = jnp.take(layers, order, axis=0)
        partial = _composite_sorted_runs(
            sorted_layers, jnp.arange(lmax, dtype=jnp.int32)
        )

        # device order IS depth order: exchange + fold the D partials
        return _exchange_fold_partials(
            partial, num_devices, num_pixels // num_devices, transport, axes
        )

    axes = mesh_axes(mesh)
    sharded = jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(axes),) * 6,
            out_specs=P(axes),
        )
    )
    return sharded(vol, meta, dims, lut, valid, depth_hints)
