"""Camera-dependent visibility ordering of AMR boxes (host precompute).

Re-implements ``Common/VisibilityOrdering.cpp:63-632`` as a pure function of
(camera, box AABBs, owners): build clip-space depth ranges for every box,
derive a face-adjacency visibility DAG, topologically sort it back-to-front
with a depth-priority tie-break, detect cycles by DFS and break them by
splitting the widest box along the dominant view axis, and finally emit the
*rank permutation* (first-visit order of box owners).

In this design the permutation is a plain index array threaded into the
compositor's blend schedule — no MPI_Group machinery.  Box counts are small,
so this runs in NumPy on the host each frame.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from .camera import make_perspective_matrix, make_view_matrix, safe_normalize
from .types import CameraParameters

K_DIRECTION_TOLERANCE = 1e-6


@dataclasses.dataclass
class _BoxInfo:
    min_corner: np.ndarray
    max_corner: np.ndarray
    owner: int
    min_depth: float = math.inf
    max_depth: float = math.inf


def _compute_depth_range(modelview, projection, min_corner, max_corner):
    """Clip-space depth range over the 8 corners (VisibilityOrdering.cpp:164-207)."""
    min_depth, max_depth = math.inf, -math.inf
    for idx in range(8):
        corner = np.array(
            [
                max_corner[0] if idx & 1 else min_corner[0],
                max_corner[1] if idx & 2 else min_corner[1],
                max_corner[2] if idx & 4 else min_corner[2],
                1.0,
            ],
            dtype=np.float32,
        )
        view_space = modelview @ corner
        clip_space = projection @ view_space
        if clip_space[3] != 0.0:
            nd = float(clip_space[2] / clip_space[3])
            min_depth = min(min_depth, nd)
            max_depth = max(max_depth, nd)
    if not (math.isfinite(min_depth) and math.isfinite(max_depth)):
        return math.inf, math.inf
    return min_depth, max_depth


def _nearly_equal(a: float, b: float) -> bool:
    scale = max(1.0, abs(a), abs(b))
    return abs(a - b) <= 1e-5 * scale


def _overlaps(a_min, a_max, b_min, b_max) -> bool:
    overlap_min = max(a_min, b_min)
    overlap_max = min(a_max, b_max)
    scale = max(
        1.0,
        abs(a_min),
        abs(a_max),
        abs(b_min),
        abs(b_max),
        abs(overlap_min),
        abs(overlap_max),
    )
    return (overlap_max - overlap_min) > 1e-5 * scale


def _rebuild_adjacency(
    boxes: List[_BoxInfo], view_dir: np.ndarray,
    eye: Optional[np.ndarray] = None,
):
    """Face-adjacency visibility edges (VisibilityOrdering.cpp:261-317).

    Edge u -> v means u must be blended before v (u occludes from the
    camera's perspective along the shared face).

    Orientation: with an ``eye`` position, the box on the eye's side of
    the shared face plane composites in FRONT — exact for every
    perspective ray, since any ray from the eye crosses the plane from
    the eye's side to the far side regardless of its direction signs
    (round-4 upgrade: the reference's sign(view_dir) predicate emits NO
    edges on a view-perpendicular axis, so e.g. a camera level with the
    scene left every y-adjacent pair tie-break-ordered — observed 0.18
    RGB divergence between fold structures on a 216-piece scene).
    Without an eye the reference's orthographically-exact sign predicate
    applies.  An eye ON a face plane (within tolerance) emits no edge
    for that plane: rays genuinely cross it both ways."""
    n = len(boxes)
    adjacency: List[List[int]] = [[] for _ in range(n)]
    indegree = [0] * n

    def add_edge(frm, to):
        if frm == to:
            return
        if to not in adjacency[frm]:
            adjacency[frm].append(to)
            indegree[to] += 1

    def lower_in_front(axis, plane, dir_component):
        """True/False = orientation; None = no edge (degenerate)."""
        if eye is not None:
            if _nearly_equal(eye[axis], plane):
                return None
            return bool(eye[axis] < plane)
        if dir_component > K_DIRECTION_TOLERANCE:
            return True
        if dir_component < -K_DIRECTION_TOLERANCE:
            return False
        return None

    for i in range(n):
        a = boxes[i]
        for j in range(i + 1, n):
            b = boxes[j]
            for axis in range(3):
                a1 = (axis + 1) % 3
                a2 = (axis + 2) % 3
                if not _overlaps(
                    a.min_corner[a1], a.max_corner[a1], b.min_corner[a1], b.max_corner[a1]
                ):
                    continue
                if not _overlaps(
                    a.min_corner[a2], a.max_corner[a2], b.min_corner[a2], b.max_corner[a2]
                ):
                    continue
                dir_component = view_dir[axis]
                if _nearly_equal(a.max_corner[axis], b.min_corner[axis]):
                    front = lower_in_front(
                        axis, a.max_corner[axis], dir_component
                    )
                    if front is True:  # a (lower) in front; b painted first
                        add_edge(j, i)
                    elif front is False:
                        add_edge(i, j)
                elif _nearly_equal(b.max_corner[axis], a.min_corner[axis]):
                    front = lower_in_front(
                        axis, b.max_corner[axis], dir_component
                    )
                    if front is True:  # b (lower) in front; a painted first
                        add_edge(i, j)
                    elif front is False:
                        add_edge(j, i)
    return adjacency, indegree


def _compare_key(boxes: List[_BoxInfo]):
    """Sort key for the ready queue (VisibilityOrdering.cpp:238-257): finite
    depths first, then min depth, max depth, owner, index."""

    def key(idx: int):
        b = boxes[idx]
        finite = math.isfinite(b.min_depth)
        return (0 if finite else 1, b.min_depth, b.max_depth, b.owner, idx)

    return key


def _topo_sort(adjacency, indegree, boxes):
    """Kahn's algorithm with depth-priority pops (VisibilityOrdering.cpp:360-401)."""
    n = len(boxes)
    indeg = list(indegree)
    ready = [i for i in range(n) if indeg[i] == 0]
    key = _compare_key(boxes)
    order = []
    ready.sort(key=key)
    while ready:
        current = ready.pop(0)
        order.append(current)
        for nxt in adjacency[current]:
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                ready.append(nxt)
        ready.sort(key=key)
    return order, indeg


def _find_cycle(adjacency, residual_indegree):
    """DFS cycle extraction among unresolved nodes (VisibilityOrdering.cpp:403-443)."""
    n = len(adjacency)
    state = [0] * n
    parent = [-1] * n
    cycle: List[int] = []

    def dfs(node: int) -> bool:
        stack = [(node, iter(adjacency[node]))]
        state[node] = 1
        while stack:
            cur, it = stack[-1]
            advanced = False
            for nxt in it:
                if state[nxt] == 0:
                    parent[nxt] = cur
                    state[nxt] = 1
                    stack.append((nxt, iter(adjacency[nxt])))
                    advanced = True
                    break
                if state[nxt] == 1:
                    cycle.clear()
                    cycle.append(nxt)
                    walk = cur
                    while walk != nxt and walk != -1:
                        cycle.append(walk)
                        walk = parent[walk]
                    cycle.reverse()
                    return True
            if not advanced:
                state[cur] = 2
                stack.pop()
        return False

    for node in range(n):
        if residual_indegree[node] > 0 and state[node] == 0:
            if dfs(node):
                break
    return cycle


def _break_cycle(cycle_nodes, boxes: List[_BoxInfo], view_dir, update_depth,
                 log, eye: Optional[np.ndarray] = None):
    """Split the widest cycle box along the dominant view axis
    (VisibilityOrdering.cpp:445-563).  Returns True on success.

    With ``eye`` (eye-side orientation), an EYE-PLANE split runs first:
    a cycle whose boxes wrap around the eye's axis (the pinwheel class —
    a genuine visibility cycle the eye predicate correctly detects) is
    broken by splitting a box AT the eye's coordinate plane, producing
    pieces no ray from the eye can see through each other; the
    face-coordinate split below cannot separate that class.  Mirrored in
    avr_native.cpp (split parity is the native/python contract)."""
    if len(cycle_nodes) < 2:
        return False

    if eye is not None:
        e_target, e_axis, e_len = -1, 0, -1.0
        for idx in cycle_nodes:
            b = boxes[idx]
            for axis in range(3):
                lo = b.min_corner[axis]
                hi = b.max_corner[axis]
                eps = max(1e-5 * (hi - lo), 1e-6)
                if lo + eps < eye[axis] < hi - eps and hi - lo > e_len:
                    e_len = hi - lo
                    e_target, e_axis = idx, axis
        if e_target >= 0:
            tb = boxes[e_target]
            low = _BoxInfo(
                tb.min_corner.copy(), tb.max_corner.copy(), tb.owner
            )
            high = _BoxInfo(
                tb.min_corner.copy(), tb.max_corner.copy(), tb.owner
            )
            low.max_corner[e_axis] = eye[e_axis]
            high.min_corner[e_axis] = eye[e_axis]
            update_depth(low)
            update_depth(high)
            boxes[e_target] = low
            boxes.append(high)
            if log:
                print(
                    f"Cycle split: box {e_target} at eye plane "
                    f"axis {e_axis}"
                )
            return True

    chosen_axis = int(np.argmax(np.abs(view_dir)))
    best_alignment = abs(view_dir[chosen_axis])

    if best_alignment <= K_DIRECTION_TOLERANCE:
        widest = -1.0
        for axis in range(3):
            for idx in cycle_nodes:
                b = boxes[idx]
                length = b.max_corner[axis] - b.min_corner[axis]
                if length > widest:
                    widest = length
                    chosen_axis = axis

    dir_component = view_dir[chosen_axis]
    if abs(dir_component) <= K_DIRECTION_TOLERANCE:
        return False

    min_length_tol = 1e-6
    target, target_length = cycle_nodes[0], -1.0
    for idx in cycle_nodes:
        b = boxes[idx]
        length = b.max_corner[chosen_axis] - b.min_corner[chosen_axis]
        if length > target_length and length > min_length_tol:
            target_length = length
            target = idx
    if target_length <= min_length_tol:
        return False

    tb = boxes[target]
    min_val = tb.min_corner[chosen_axis]
    max_val = tb.max_corner[chosen_axis]
    epsilon = max(1e-5 * (max_val - min_val), 1e-6)

    candidates = []
    for idx in cycle_nodes:
        if idx == target:
            continue
        other = boxes[idx]
        for v in (other.min_corner[chosen_axis], other.max_corner[chosen_axis]):
            if min_val + epsilon < v < max_val - epsilon:
                candidates.append(v)

    split = 0.5 * (min_val + max_val)
    if candidates:
        split = max(candidates) if dir_component > 0.0 else min(candidates)
    split = min(max(split, min_val + epsilon), max_val - epsilon)
    if not (min_val < split < max_val):
        return False

    near = _BoxInfo(tb.min_corner.copy(), tb.max_corner.copy(), tb.owner)
    far = _BoxInfo(tb.min_corner.copy(), tb.max_corner.copy(), tb.owner)
    if dir_component > 0.0:
        near.max_corner[chosen_axis] = split
        far.min_corner[chosen_axis] = split
    else:
        near.min_corner[chosen_axis] = split
        far.max_corner[chosen_axis] = split
    update_depth(near)
    update_depth(far)
    boxes[target] = near
    boxes.append(far)
    if log:
        print(
            f"Split box owned by rank {tb.owner} along axis {chosen_axis} "
            f"at {split} to break visibility cycle."
        )
    return True


def _export_dot(boxes: List[_BoxInfo], adjacency, path: str) -> None:
    """DOT export of the visibility graph (VisibilityOrdering.cpp:319-352)."""
    lines = ["digraph VisibilityGraph {", "  rankdir=LR;"]
    for idx, b in enumerate(boxes):
        lines.append(
            f'  box{idx} [label="box {idx}\\nrank {b.owner}'
            f'\\nminDepth {b.min_depth:.6f}\\nmaxDepth {b.max_depth:.6f}"];'
        )
    for frm, edges in enumerate(adjacency):
        for to in edges:
            lines.append(f"  box{frm} -> box{to};")
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


_graph_file_counter = 0


def build_visibility_order(
    camera: CameraParameters,
    aspect: float,
    box_min: np.ndarray,  # [N, 3] all boxes' lower corners (global)
    box_max: np.ndarray,  # [N, 3]
    owners: np.ndarray,  # [N] owning logical rank of each box
    num_ranks: int,
    use_visibility_graph: bool = True,
    write_visibility_graph: bool = False,
    log: bool = False,
    default_on_failure: bool = True,
    python_fallback: bool = True,
    return_clean: bool = False,
):
    """Compute the back-to-front rank permutation for compositing.

    Returns an int array of length ``num_ranks``: a permutation where earlier
    ranks blend *on top* (Compositor.hpp:26-29).  Falls back to identity on
    visibility-graph failure (VisibilityOrdering.cpp:610-627) — or returns
    None instead when ``default_on_failure`` is False, so callers that have
    a better fallback (e.g. depth hints) can tell failure from a genuine
    identity order.  ``python_fallback=False`` restricts the build to the
    native graph (the pure-Python builder is O(N^2) Python loops — per-frame
    callers on large scenes must not fall into it when the native library
    is missing or its graph fails).

    ``return_clean=True`` returns ``(order, clean)`` instead: ``clean`` is
    True when the graph was acyclic (no cycle-breaking box split), so the
    order depends on the camera only through sign(view_dir) per axis plus
    depth tie-breaks — the property OrderKeyCache needs to memoize orders
    per view octant; None when unknown (pre-v2 native library, disabled
    graph, or failure).
    """
    global _graph_file_counter

    def ret(order, clean):
        return (order, clean) if return_clean else order

    default_order = np.arange(num_ranks, dtype=np.int32)
    if not use_visibility_graph or len(box_min) == 0:
        return ret(default_order if default_on_failure else None, None)

    modelview = make_view_matrix(camera.eye, camera.look_at, camera.up)
    projection = make_perspective_matrix(
        camera.fov_y_degrees, aspect, camera.near_plane, camera.far_plane
    )

    # Native graph builder (same algorithm in C++; skipped when a DOT dump
    # is requested since export happens in the Python path).
    if not write_visibility_graph:
        from . import native

        native_result = native.visibility_order_flags(
            np.asarray(box_min, dtype=np.float64),
            np.asarray(box_max, dtype=np.float64),
            np.asarray(owners, dtype=np.int32),
            num_ranks,
            modelview,
            projection,
            safe_normalize(camera.look_at - camera.eye),
            eye=np.asarray(camera.eye, np.float64),
        )
        if native_result is not None:
            return ret(native_result[0], native_result[1])
    if not python_fallback:
        return ret(default_order if default_on_failure else None, None)

    def update_depth(info: _BoxInfo):
        info.min_depth, info.max_depth = _compute_depth_range(
            modelview, projection, info.min_corner, info.max_corner
        )

    boxes: List[_BoxInfo] = []
    for i in range(len(box_min)):
        info = _BoxInfo(
            np.asarray(box_min[i], dtype=np.float64).copy(),
            np.asarray(box_max[i], dtype=np.float64).copy(),
            int(owners[i]),
        )
        update_depth(info)
        boxes.append(info)

    view_dir = safe_normalize(camera.look_at - camera.eye)
    eye = np.asarray(camera.eye, np.float64)
    # the eye-plane cycle split (_break_cycle) can fire before the
    # reference face-coordinate split and each box lineage supports at
    # most 7 eye splits (one per straddled axis per child, extinguished
    # because children only touch the eye plane at their boundary) — the
    # doubled budget guarantees those splits can never starve the
    # reference's 8N+32 face-split allowance (review finding r4)
    max_iterations = max(len(boxes), 1) * 16 + 32

    for iteration in range(max_iterations):
        adjacency, indegree = _rebuild_adjacency(boxes, view_dir, eye=eye)
        if write_visibility_graph:
            _export_dot(
                boxes, adjacency, f"visibility_graph_{_graph_file_counter}.dot"
            )
            _graph_file_counter += 1

        order, residual = _topo_sort(adjacency, indegree, boxes)
        if len(order) == len(boxes):
            visited = np.zeros(num_ranks, dtype=bool)
            rank_order = []
            for box_idx in order:
                owner = boxes[box_idx].owner
                if 0 <= owner < num_ranks and not visited[owner]:
                    visited[owner] = True
                    rank_order.append(owner)
            for owner in range(num_ranks):
                if not visited[owner]:
                    rank_order.append(owner)
            return ret(np.asarray(rank_order, dtype=np.int32), iteration == 0)

        cycle = _find_cycle(adjacency, residual)
        if not cycle:
            break
        if not _break_cycle(
            cycle, boxes, view_dir, update_depth, log, eye=eye
        ):
            break

    if log:
        print(
            "Visibility graph ordering failed; falling back to default rank order."
        )
    return ret(default_order if default_on_failure else None, None)


# beyond this piece count the per-frame graph build outweighs the
# ordering benefit; the two-level brick-graph x slab-shell keys take over
# (hierarchical_order_keys), then scalar hints.  The native adjacency
# build is a per-axis plane sweep with an in-plane interval band (NOT the
# reference's O(P^2) pair loop, VisibilityOrdering.cpp:261-317): measured
# 7 ms at 4096 boxes, 29 ms at 13824, 93 ms at 32768 — near-linear for
# tiling partitions — so the limit sits at 16384 (~35 ms host/frame,
# comparable to the render at that depth) instead of the 2048 the old
# quadratic build forced
PIECE_GRAPH_LIMIT = 16384


def piece_order_keys(
    camera: CameraParameters,
    aspect: float,
    box_min: np.ndarray,  # [P, 3] piece lower corners
    box_max: np.ndarray,  # [P, 3]
    return_clean: bool = False,
):
    """Per-piece FRONT-TO-BACK compositing sort keys from the piece-level
    visibility graph; None when the graph is unavailable or fails (callers
    fall back to scalar depth hints).

    The scalar depth hint (nearest-corner view depth) is only a PROXY for
    per-ray traversal order, and the sequential entry-depth fold is exact
    only when the sort order matches every ray's traversal order — a
    hint-misordered piece pair with an interleaving third layer composites
    measurably wrong (observed: 0.48 max RGB error on the 3-level bench
    scene).  Convexified AMR pieces tile the domain, so the reference's own
    face-adjacency visibility graph (VisibilityOrdering.cpp:261-317, which
    the reference computes but applies only at RANK granularity) yields an
    EXACT view-consistent total order here: every occlusion between pieces
    passes through the chain of shared faces of the partition.  Applying it
    per piece makes the ordering the renderer already pays for
    consequential.

    Keys are float32 positions: smaller = nearer the eye = folded in front
    (the (key, owner, local) layer-sort contract).

    ``return_clean=True`` returns ``(keys, clean)`` — see
    ``build_visibility_order``; OrderKeyCache memoizes clean builds per
    view octant."""
    num = len(box_min)
    if num == 0:
        return (None, None) if return_clean else None
    if num > PIECE_GRAPH_LIMIT:
        # even the sweep-based native build has a per-frame host cost
        # (~35 ms at the limit): on still-deeper scenes the hierarchical
        # keys / hints are the better per-frame trade
        return (None, None) if return_clean else None
    # the raised limit (2048 -> 16384) assumes the sweep-based adjacency
    # build, which shipped together with the v2 symbol: a stale pre-sweep
    # .so (loadable when `make` fails but an old library exists) is still
    # O(P^2) pair tests — ~3 s/frame at 16384 — so deep scenes require v2
    if num > 2048:
        from . import native

        lib = native.get_lib()
        if lib is None or not hasattr(lib, "avr_visibility_order_v2"):
            return (None, None) if return_clean else None
    # above 128 pieces use the native graph ONLY: the pure-Python builder
    # is O(P^2) Python loops (seconds per frame), so a missing library or
    # a native graph failure falls back to hints, not to the Python path
    order, clean = build_visibility_order(
        camera, aspect, box_min, box_max,
        np.arange(num, dtype=np.int32), num,
        default_on_failure=False,
        python_fallback=num <= 128,
        return_clean=True,
    )
    if order is None or len(order) != num:
        return (None, None) if return_clean else None
    # build_visibility_order returns BACK-to-front (earliest = farthest,
    # see the two-box polarity canary in tests/test_piece_order.py);
    # compositing sorts front-first
    keys = np.empty(num, np.float32)
    keys[np.asarray(order, np.int64)] = np.arange(
        num - 1, -1, -1, dtype=np.float32
    )
    return (keys, clean) if return_clean else keys


def hierarchical_order_keys(
    camera: CameraParameters,
    aspect: float,
    box_min: np.ndarray,  # [P, 3] piece boxes
    box_max: np.ndarray,
    parents: np.ndarray,  # [P] parent brick of each piece
    parent_min: np.ndarray,  # [B, 3] parent brick boxes
    parent_max: np.ndarray,
    parent_pos: Optional[np.ndarray] = None,  # precomputed parent keys
) -> Optional[np.ndarray]:
    """Two-level FRONT-TO-BACK keys for scenes too deep for the flat
    piece graph: the visibility graph orders the PARENT bricks,
    and within each brick pieces order by the eye's per-axis
    slab-distance sum.

    Validity: cross-brick occlusion between pieces implies occlusion
    between their parents (pieces tile their parent), which the brick
    graph captures; within a brick, piece A occluding piece B means A's
    slab lies between the eye and B's slab on every axis, so A's
    distance-to-slab sum is strictly smaller (the grid-shell painter
    argument with continuous distances).  Keys are dense ranks, so f32
    carries them exactly.

    ``parent_pos`` short-circuits the parent graph build with precomputed
    positions (OrderKeyCache memoizes them per view octant; the
    within-brick slab distances stay per-frame — they depend on the eye
    point, not just the octant)."""
    num_parents = len(parent_min)
    if num_parents > PIECE_GRAPH_LIMIT:
        return None
    if parent_pos is None:
        parent_pos = piece_order_keys(camera, aspect, parent_min, parent_max)
    if parent_pos is None:
        return None
    eye = np.asarray(camera.eye, np.float64)
    lo = np.asarray(box_min, np.float64)
    hi = np.asarray(box_max, np.float64)
    # per-axis distance from the eye coordinate to the piece's slab
    # interval (0 when the eye coordinate is inside it)
    slab_dist = np.maximum(np.maximum(lo - eye, eye - hi), 0.0)
    within = slab_dist.sum(axis=1)
    order = np.lexsort((within, parent_pos[np.asarray(parents)]))
    keys = np.empty(len(order), np.float32)
    keys[order] = np.arange(len(order), dtype=np.float32)
    return keys


def _is_cuboid_tiling(box_min: np.ndarray, box_max: np.ndarray) -> bool:
    """True when the (disjoint-by-construction) boxes exactly tile their
    bounding cuboid: total box volume equals the bbox volume within f64
    rounding.  The gate OrderKeyCache needs: in a tiled cuboid, every
    occlusion the face-adjacency model resolves travels a gap-free chain
    of shared faces, i.e. a directed path in the DAG — so depth
    tie-breaks (the only camera dependence of a clean build beyond the
    octant) are never load-bearing.  L-shaped / holed unions fail the
    check and keep per-frame ordering."""
    lo = np.asarray(box_min, np.float64)
    hi = np.asarray(box_max, np.float64)
    if len(lo) == 0:
        return False
    bbox = float(np.prod(np.maximum(hi.max(axis=0) - lo.min(axis=0), 0.0)))
    if not bbox > 0.0:
        return False
    vol = float(np.prod(np.maximum(hi - lo, 0.0), axis=1).sum())
    return abs(vol - bbox) <= 1e-9 * bbox


_DIR_TOL = 1e-6  # the builders' kDirTol (avr_native.cpp / _rebuild_adjacency)


def _face_planes(box_min: np.ndarray, box_max: np.ndarray):
    """Per-axis face-plane CLUSTER INTERVALS ``(lo[], hi[])``, sorted.

    Values within the builders' ``nearly_equal`` window chain into one
    cluster; each cluster is kept as its [min, max] extent (NOT just a
    leader) so ``OrderKeyCache.gate`` can refuse any eye within the
    window of ANY member plane — a leader-only list left a hole where an
    eye near a merged-away plane (which ``_rebuild_adjacency`` treats as
    degenerate, emitting no edges) still got a cacheable cell key."""
    lo = np.asarray(box_min, np.float64)
    hi = np.asarray(box_max, np.float64)
    if len(lo) == 0:
        return [(np.zeros(0), np.zeros(0))] * 3, 1.0
    scale = max(1.0, float(np.abs(lo).max()), float(np.abs(hi).max()))
    window = 1e-5 * scale
    planes = []
    for k in range(3):
        vals = np.unique(np.concatenate([lo[:, k], hi[:, k]]))
        c_lo, c_hi = [], []
        for v in vals:
            if c_hi and v - c_hi[-1] <= window:
                c_hi[-1] = v
            else:
                c_lo.append(v)
                c_hi.append(v)
        planes.append((np.asarray(c_lo), np.asarray(c_hi)))
    return planes, window


class OrderKeyCache:
    """Eye-cell-keyed memo for ordering keys on static geometry.

    Under the eye-side-of-plane edge orientation (round 4,
    ``_rebuild_adjacency``), the adjacency DAG depends on the camera
    only through which CELL of the face-plane arrangement the eye sits
    in — per axis, which interval between the scene's face coordinates
    contains ``eye[k]``.  Within one cell the DAG is identical, and for
    a cuboid-tiling partition (``_is_cuboid_tiling``, checked once)
    every ray's piece-crossing chain is a directed DAG path oriented
    consistently for EVERY eye in the cell — so any cached clean topo
    order is a valid compositing order for every camera in the cell,
    independent of frustum or view direction (per-pixel output is
    identical under any valid order: pieces a ray misses blend as exact
    identities).

    An eye within the builders' tolerance of a face plane gates to None
    (that plane's edges are degenerate — rays cross it both ways), as do
    non-tiling unions, cycle-broken builds, and flag-less (pre-v2
    native) builds.  Persistent renderers (fast_scene,
    parallel/persistent) hold one cache per scene: an animation orbit
    pays the graph build at most once per crossed eye cell instead of
    per frame — at the PIECE_GRAPH_LIMIT depth that is ~35 ms/frame of
    host time removed.  Field-value updates (update_data) don't move
    boxes, so the cache survives them.
    """

    def __init__(
        self,
        box_min: np.ndarray,
        box_max: np.ndarray,
        parent_min: Optional[np.ndarray] = None,
        parent_max: Optional[np.ndarray] = None,
    ):
        self.flat_sound = _is_cuboid_tiling(box_min, box_max)
        self.parent_sound = parent_min is not None and _is_cuboid_tiling(
            parent_min, parent_max
        )
        # the plane arrangement of the FINEST partition keys both memos:
        # parent faces are a subset of piece faces in an AMR hierarchy,
        # so piece cells refine parent cells (a coarser parent-only key
        # could only add hits, never correctness, but sharing one key
        # keeps the two memos aligned)
        self._planes, self._window = _face_planes(box_min, box_max)
        self._flat: dict = {}
        self._parent: dict = {}
        self.hits = 0
        self.misses = 0

    def gate(self, camera: CameraParameters, aspect: float):
        """The memo key for this camera — the eye's per-axis cell in the
        face-plane arrangement — or None when the eye lies within the
        builders' tolerance of a face plane (degenerate edge
        orientation; the per-frame build is used, exactly as without a
        cache).  ``aspect`` is unused (kept for call-site stability):
        the cell key is frustum-independent."""
        del aspect
        eye = np.asarray(camera.eye, np.float64)
        key = []
        for k in range(3):
            c_lo, c_hi = self._planes[k]
            j = int(np.searchsorted(c_lo, eye[k]))
            # within the tolerance window of any member plane of the
            # neighboring clusters -> degenerate orientation, never cache
            if j > 0 and eye[k] - c_hi[j - 1] <= self._window:
                return None
            if j < len(c_lo) and c_lo[j] - eye[k] <= self._window:
                return None
            key.append(j)
        return tuple(key)


def order_keys_or_hints(
    camera: CameraParameters,
    aspect: float,
    box_min: np.ndarray,
    box_max: np.ndarray,
    use_graph: bool = True,
    parents: Optional[np.ndarray] = None,
    parent_min: Optional[np.ndarray] = None,
    parent_max: Optional[np.ndarray] = None,
    cache: Optional[OrderKeyCache] = None,
    parent_hint_fallback: bool = False,
) -> np.ndarray:
    """The layer-ordering policy, shared by every compositing path:
    piece-level visibility-graph keys when enabled and available
    (``piece_order_keys``), then — for scenes beyond PIECE_GRAPH_LIMIT
    with parent mapping supplied — the two-level brick-graph x
    slab-shell keys (``hierarchical_order_keys``), else the
    nearest-corner depth hints.  ``use_graph=False`` honors the
    product's ``--no-visibility-graph`` flag
    (RenderParameters.use_visibility_graph).  ``cache`` (persistent
    renderers) memoizes sound clean builds per view octant — see
    OrderKeyCache."""
    from .camera import compute_box_depth_hints

    if use_graph:
        # memo key: per-frame frustum-sign gate (None = caching unsound
        # for this camera — read and write are both skipped)
        okey = cache.gate(camera, aspect) if cache is not None else None
        if cache is not None and cache.flat_sound and okey is not None \
                and okey in cache._flat:
            cache.hits += 1
            return cache._flat[okey]
        res = piece_order_keys(
            camera, aspect, box_min, box_max, return_clean=True
        )
        # tolerate a bare-None return (tests stub piece_order_keys with
        # ``lambda *a, **k: None`` to force the hint fallback)
        keys, clean = res if isinstance(res, tuple) else (res, None)
        if keys is not None:
            if (
                cache is not None and cache.flat_sound
                and okey is not None and clean
            ):
                cache.misses += 1
                cache._flat[okey] = keys
            return keys
        if parents is not None and parent_min is not None:
            parent_pos = None
            if (
                cache is not None and cache.parent_sound
                and okey is not None
            ):
                parent_pos = cache._parent.get(okey)
            if parent_pos is not None:
                cache.hits += 1
            elif len(parent_min) <= PIECE_GRAPH_LIMIT:
                pres = piece_order_keys(
                    camera, aspect, parent_min, parent_max, return_clean=True
                )
                parent_pos, pclean = (
                    pres if isinstance(pres, tuple) else (pres, None)
                )
                if (
                    parent_pos is not None
                    and cache is not None
                    and cache.parent_sound
                    and okey is not None
                    and pclean
                ):
                    cache.misses += 1
                    cache._parent[okey] = parent_pos
            # the parent build was just attempted (or is beyond the
            # limit): only assemble the two-level keys when it SUCCEEDED
            # — passing parent_pos=None would re-run the identical
            # failing build inside hierarchical_order_keys
            if parent_pos is not None:
                keys = hierarchical_order_keys(
                    camera, aspect, box_min, box_max,
                    parents, parent_min, parent_max, parent_pos=parent_pos,
                )
                if keys is not None:
                    return keys
    if parent_hint_fallback and parents is not None and parent_min is not None:
        # one-shot layered-path fallback: parent-box corner hints shared
        # by all the parent's split pieces (renderer_fast historical
        # behavior; the persistent path falls back to piece-level hints)
        return compute_box_depth_hints(parent_min, parent_max, camera)[
            parents
        ].astype(np.float32)
    return compute_box_depth_hints(box_min, box_max, camera).astype(
        np.float32
    )
