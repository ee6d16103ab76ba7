"""ctypes bindings for the native host-runtime library (native/avr_native.cpp).

The reference's host layer is C++; this module binds the rebuild's native
equivalents (FAB decode, PPM encode, box downsample, visibility ordering).
The library is built on demand with ``make -C native`` and every entry point
has a pure-Python fallback, so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libavr_native.so")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _try_build() -> bool:
    makefile = os.path.join(_NATIVE_DIR, "Makefile")
    if not os.path.exists(makefile):
        return False
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-s"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except (subprocess.SubprocessError, OSError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None if unavailable."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    # ALWAYS run make, even when the .so exists: the build is mtime-based
    # (a fresh library is a no-op), and loading a stale library after a C
    # ABI/contract change (e.g. the uint16 -> uint64 occupancy-mask
    # widening) would silently disable native paths — old avr_item_bands
    # rejects nq=8, so every frame would fall back to the NumPy oracle
    # with no warning.
    if not _try_build() and not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_u8_p = ctypes.POINTER(ctypes.c_uint8)

    lib.avr_decode_fab_f64.argtypes = [
        c_double_p, c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.avr_decode_fab_f32.argtypes = [
        c_float_p, c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.avr_encode_ppm.argtypes = [
        c_float_p, c_u8_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.avr_downsample_box.argtypes = [
        c_float_p, c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.avr_visibility_order.argtypes = [
        c_double_p, c_double_p, c_int_p, ctypes.c_int, ctypes.c_int,
        c_float_p, c_float_p, c_double_p, c_int_p,
    ]
    lib.avr_visibility_order.restype = ctypes.c_int
    if hasattr(lib, "avr_visibility_order_v2"):
        lib.avr_visibility_order_v2.argtypes = [
            c_double_p, c_double_p, c_int_p, ctypes.c_int, ctypes.c_int,
            c_float_p, c_float_p, c_double_p, c_int_p, c_int_p,
        ]
        lib.avr_visibility_order_v2.restype = ctypes.c_int
    if hasattr(lib, "avr_visibility_order_v3"):
        lib.avr_visibility_order_v3.argtypes = [
            c_double_p, c_double_p, c_int_p, ctypes.c_int, ctypes.c_int,
            c_float_p, c_float_p, c_double_p, c_double_p, c_int_p, c_int_p,
        ]
        lib.avr_visibility_order_v3.restype = ctypes.c_int
    for name in ("avr_scalar_stats_f64", "avr_scalar_stats_f32"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [
                c_double_p if name.endswith("f64") else c_float_p,
                ctypes.c_int64, c_double_p,
            ]
    for name in ("avr_scalar_stats_f64_list", "avr_scalar_stats_f32_list"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [
                ctypes.POINTER(c_double_p if "f64" in name else c_float_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int, c_double_p,
            ]
    # v2 adds (seg_len, margin) to the footprint maths; an older library
    # without the symbol cleanly falls back to the NumPy oracle instead of
    # silently mis-parsing the extra arguments
    if hasattr(lib, "avr_item_bands_v2"):
        lib.avr_item_bands_v2.argtypes = [
            c_float_p,                      # meta [L,12]
            ctypes.POINTER(ctypes.c_int32),  # brick_bounds [L]
            ctypes.POINTER(ctypes.c_int64),  # wt [W]
            ctypes.POINTER(ctypes.c_int64),  # wb [W]
            ctypes.c_int64,                  # num_items
            c_double_p, c_double_p, c_double_p, c_double_p,  # eye/f/r/u (permuted)
            ctypes.c_double, ctypes.c_double,  # tan_half, aspect
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # tiles_x, tile_w, tile_h
            ctypes.c_int, ctypes.c_int,      # logical w/h
            ctypes.POINTER(ctypes.c_uint64),  # occ_bits [L,S]
            ctypes.c_int, ctypes.c_int,      # cap, nq
            c_double_p, c_double_p, ctypes.c_int,  # su, sv, per_brick
            ctypes.c_int, ctypes.c_int64,    # ghost, min_gap
            ctypes.c_int, ctypes.c_double,   # seg_len, margin
            ctypes.POINTER(ctypes.c_int32),  # out band1
            ctypes.POINTER(ctypes.c_int32),  # out band2
            c_u8_p,                          # out forward
        ]
        lib.avr_item_bands_v2.restype = ctypes.c_int
    if hasattr(lib, "avr_pack_slice_volumes"):
        lib.avr_pack_slice_volumes.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),  # brick data pointers [n]
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # elem strides
            ctypes.c_int, ctypes.c_int,      # is_f64, normalize
            ctypes.c_double, ctypes.c_double,  # norm_min, inv_span
            ctypes.c_int, ctypes.c_int64,    # nq, slice_cells
            c_float_p, c_float_p, c_float_p, c_float_p, c_float_p,
        ]
        lib.avr_pack_slice_volumes.restype = ctypes.c_int
    if hasattr(lib, "avr_block_occupancy_bits"):
        lib.avr_block_occupancy_bits.argtypes = [
            c_float_p, c_float_p,            # quad_min/max [N, Q, Q]
            ctypes.POINTER(ctypes.c_int64),  # nz prefix [size + 1]
            ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # N, Q, table_max
            ctypes.c_double, ctypes.c_double,  # range_min, inverse_range
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.avr_block_occupancy_bits.restype = ctypes.c_int
    _lib = lib
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def decode_fab(raw: bytes, shape, dtype_bytes: int, little_endian: bool) -> Optional[np.ndarray]:
    """Fortran-order FAB payload -> C-order float32 array, or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    nx, ny, nz = shape
    out = np.empty((nx, ny, nz), dtype=np.float32)
    import sys

    host_little = sys.byteorder == "little"
    swap = 0 if little_endian == host_little else 1
    src = np.frombuffer(raw, dtype=np.float64 if dtype_bytes == 8 else np.float32)
    src = np.ascontiguousarray(src)
    if dtype_bytes == 8:
        lib.avr_decode_fab_f64(
            _ptr(src, ctypes.c_double), _ptr(out, ctypes.c_float),
            nx, ny, nz, swap,
        )
    else:
        lib.avr_decode_fab_f32(
            _ptr(src.view(np.float32), ctypes.c_float), _ptr(out, ctypes.c_float),
            nx, ny, nz, swap,
        )
    return out


def encode_ppm_pixels(pixels: np.ndarray, width: int, height: int) -> Optional[bytes]:
    """float pixel rows [H*W, stride>=3] -> raw P6 RGB bytes (bottom-up)."""
    lib = get_lib()
    if lib is None:
        return None
    pixels = np.ascontiguousarray(pixels, dtype=np.float32)
    stride = pixels.shape[1]
    out = np.empty(width * height * 3, dtype=np.uint8)
    lib.avr_encode_ppm(
        _ptr(pixels, ctypes.c_float), _ptr(out, ctypes.c_uint8),
        width, height, stride,
    )
    return out.tobytes()


def downsample_box(src: np.ndarray, target_width: int, target_height: int,
                   block: int) -> Optional[np.ndarray]:
    """Box-average downsample of [H*W, stride] float pixels -> 4-channel."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.float32)
    out = np.zeros((target_width * target_height, 4), dtype=np.float32)
    lib.avr_downsample_box(
        _ptr(src, ctypes.c_float), _ptr(out, ctypes.c_float),
        target_width, target_height, block, src.shape[1], 4,
    )
    return out


def scalar_stats(arrays) -> Optional[tuple]:
    """(min, max, min-positive, finite-count) over all samples via the
    threaded native pass (SceneBuilder.cpp:53-94 host twin); None if the
    library is unavailable (caller falls back to NumPy/device).

    Same-dtype brick lists reduce in ONE call that threads across bricks;
    mixed dtypes fold per array."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "avr_scalar_stats_f64"):
        return None
    mn, mx, mp, count = np.inf, -np.inf, np.inf, 0
    out4 = np.empty(4, np.float64)

    def fold():
        nonlocal mn, mx, mp, count
        mn = min(mn, out4[0])
        mx = max(mx, out4[1])
        mp = min(mp, out4[2])
        count += int(out4[3])

    held = [np.ascontiguousarray(
        a, dtype=np.float32 if np.asarray(a).dtype == np.float32
        else np.float64
    ) for a in arrays if np.asarray(a).size]
    for dtype, cfn, ctype in (
        (np.float32, "avr_scalar_stats_f32_list", ctypes.c_float),
        (np.float64, "avr_scalar_stats_f64_list", ctypes.c_double),
    ):
        group = [a for a in held if a.dtype == dtype]
        if not group:
            continue
        if hasattr(lib, cfn):
            n = len(group)
            ptrs = (ctypes.POINTER(ctype) * n)(*[_ptr(a, ctype) for a in group])
            sizes = (ctypes.c_int64 * n)(*[a.size for a in group])
            getattr(lib, cfn)(ptrs, sizes, n, _ptr(out4, ctypes.c_double))
            fold()
        else:
            single = getattr(
                lib, "avr_scalar_stats_f32" if dtype == np.float32
                else "avr_scalar_stats_f64",
            )
            for a in group:
                single(_ptr(a, ctype), a.size, _ptr(out4, ctypes.c_double))
                fold()
    return float(mn), float(mx), float(mp), count


def item_bands(
    meta: np.ndarray,  # [L, 12] f32 permuted pmin/pmax/cell
    brick_bounds: np.ndarray,  # [L] i32 packed (lo<<16)|hi
    wt: np.ndarray,  # [W] tile per item
    wb: np.ndarray,  # [W] brick per item
    eye: np.ndarray,
    forward: np.ndarray,
    right: np.ndarray,
    up: np.ndarray,
    fov_y_degrees: float,
    axes,
    width: int,
    logical_width: int,
    logical_height: int,
    occ_bits: np.ndarray,  # [L, S] u64
    nq: int,
    split,
    split_v=None,
    ghost: int = 0,
    min_gap: int = 6,
    seg_len: int = 4,
    margin: Optional[float] = None,
) -> Optional[tuple]:
    """Native per-(tile, brick) slice bounds + chord-gap band splitting
    (ops/tilemarch.compute_item_bands contract); None if the library is
    unavailable (caller falls back to the NumPy oracle)."""
    import math

    lib = get_lib()
    if lib is None or not hasattr(lib, "avr_item_bands_v2"):
        return None
    if seg_len < 1:
        return None
    from .ops.slicemarch import TILE_H, TILE_W

    axes = list(axes)
    meta = np.ascontiguousarray(meta, dtype=np.float32)
    bb = np.ascontiguousarray(brick_bounds, dtype=np.int32)
    wt64 = np.ascontiguousarray(wt, dtype=np.int64)
    wb64 = np.ascontiguousarray(wb, dtype=np.int64)
    occ_bits = np.ascontiguousarray(occ_bits, dtype=np.uint64)
    eye_p = np.ascontiguousarray(np.asarray(eye, np.float64)[axes])
    fwd_p = np.ascontiguousarray(np.asarray(forward, np.float64)[axes])
    right_p = np.ascontiguousarray(np.asarray(right, np.float64)[axes])
    up_p = np.ascontiguousarray(np.asarray(up, np.float64)[axes])
    if split_v is None:
        split_v = split
    # per-brick mode if EITHER stride is an array (the oracle treats the
    # two axes independently); broadcast a scalar partner so a mixed
    # scalar/array call can never silently apply brick 0's stride to
    # every brick (the bounds must stay conservative — CLAUDE.md)
    per_brick = 1 if (np.ndim(split) or np.ndim(split_v)) else 0
    su = np.atleast_1d(np.asarray(split, np.float64))
    sv = np.atleast_1d(np.asarray(split_v, np.float64))
    if per_brick:
        if len(su) == 1:
            su = np.full(len(meta), su[0])
        if len(sv) == 1:
            sv = np.full(len(meta), sv[0])
        if len(su) != len(meta) or len(sv) != len(meta):
            return None
    su = np.ascontiguousarray(su)
    sv = np.ascontiguousarray(sv)
    n = len(wt64)
    band1 = np.empty(n, dtype=np.int32)
    band2 = np.empty(n, dtype=np.int32)
    fwd_flag = np.empty(n, dtype=np.uint8)
    tan_half = math.tan(math.radians(fov_y_degrees) * 0.5)
    aspect = logical_width / max(logical_height, 1)
    ok = lib.avr_item_bands_v2(
        _ptr(meta, ctypes.c_float), _ptr(bb, ctypes.c_int32),
        _ptr(wt64, ctypes.c_int64), _ptr(wb64, ctypes.c_int64),
        n,
        _ptr(eye_p, ctypes.c_double), _ptr(fwd_p, ctypes.c_double),
        _ptr(right_p, ctypes.c_double), _ptr(up_p, ctypes.c_double),
        tan_half, aspect,
        width // TILE_W, TILE_W, TILE_H,
        logical_width, logical_height,
        _ptr(occ_bits, ctypes.c_uint64),
        occ_bits.shape[1], int(nq),
        _ptr(su, ctypes.c_double), _ptr(sv, ctypes.c_double), per_brick,
        int(ghost), int(min_gap),
        int(seg_len),
        float(ghost + 2.0 if margin is None else margin),
        _ptr(band1, ctypes.c_int32), _ptr(band2, ctypes.c_int32),
        _ptr(fwd_flag, ctypes.c_uint8),
    )
    if not ok:
        return None
    return band1, band2, fwd_flag.astype(bool)


def pack_slice_volumes(
    arrays,            # list of [d0, d1, d2] ndarrays, uniform shape/dtype
    axes,              # [march, u, v] axis permutation
    transform,         # types.ScalarTransform
    nq: int,
    slice_cells: int,
) -> Optional[tuple]:
    """Single-pass batched slice-volume pack + block extrema
    (renderer_fast._geometry_pack_batched's NumPy pipeline fused into one
    native pass, byte-identical; reference cold-prep twin:
    SceneBuilder.cpp:148-189).  Returns (vol [n, ns, slice_cells], quad_min,
    quad_max [n, ns, nq, nq], slice_min, slice_max [n, ns]) or None when the
    library is unavailable or the transform needs libm (log scale — NumPy's
    SIMD log is not bit-stable against std::log, so those route to NumPy)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "avr_pack_slice_volumes"):
        return None
    if transform.log_scale_input:
        return None
    n = len(arrays)
    if n == 0:
        return None
    first = arrays[0]
    dtype = first.dtype
    if dtype not in (np.float32, np.float64):
        return None
    item = dtype.itemsize
    strides = first.strides
    if any(s % item for s in strides):
        return None
    for a in arrays:
        if a.strides != strides or a.dtype != dtype or a.shape != first.shape:
            return None
    st = [s // item for s in strides]
    ns, nu, nv = (first.shape[a] for a in axes)
    if nu * nv > slice_cells:
        return None
    vol = np.empty((n, ns, slice_cells), np.float32)
    quad_min = np.empty((n, ns, nq, nq), np.float32)
    quad_max = np.empty((n, ns, nq, nq), np.float32)
    slice_min = np.empty((n, ns), np.float32)
    slice_max = np.empty((n, ns), np.float32)
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    ok = lib.avr_pack_slice_volumes(
        ptrs, n, ns, nu, nv,
        st[axes[0]], st[axes[1]], st[axes[2]],
        1 if dtype == np.float64 else 0,
        1 if transform.normalize_to_unit_range else 0,
        float(transform.normalization_min),
        float(transform.inverse_normalization_span),
        int(nq), int(slice_cells),
        _ptr(vol, ctypes.c_float),
        _ptr(quad_min, ctypes.c_float), _ptr(quad_max, ctypes.c_float),
        _ptr(slice_min, ctypes.c_float), _ptr(slice_max, ctypes.c_float),
    )
    if not ok:
        return None
    return vol, quad_min, quad_max, slice_min, slice_max


def block_occupancy_bits(
    quad_min: np.ndarray,  # [L, S, Q, Q] f32
    quad_max: np.ndarray,
    lut_alpha: np.ndarray,  # [size]
    range_min: float,
    inverse_range: float,
) -> Optional[np.ndarray]:
    """Native [L, S] uint64 block-occupancy masks
    (ops/tilemarch.block_occupancy_bits twin, bit-identical); None if the
    library is unavailable (caller falls back to NumPy)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "avr_block_occupancy_bits"):
        return None
    L, S, Q, Q2 = quad_min.shape
    if Q != Q2 or Q > 8:
        return None
    qmin = np.ascontiguousarray(quad_min, dtype=np.float32)
    qmax = np.ascontiguousarray(quad_max, dtype=np.float32)
    nz = (np.asarray(lut_alpha) > 0.0)
    prefix = np.concatenate([[0], np.cumsum(nz)]).astype(np.int64)
    out = np.empty(L * S, dtype=np.uint64)
    ok = lib.avr_block_occupancy_bits(
        _ptr(qmin, ctypes.c_float), _ptr(qmax, ctypes.c_float),
        _ptr(prefix, ctypes.c_int64),
        L * S, int(Q), int(len(nz) - 1),
        float(range_min), float(inverse_range),
        _ptr(out, ctypes.c_uint64),
    )
    if not ok:
        return None
    return out.reshape(L, S)


def visibility_order(
    box_min: np.ndarray,
    box_max: np.ndarray,
    owners: np.ndarray,
    num_ranks: int,
    modelview: np.ndarray,
    projection: np.ndarray,
    view_dir: np.ndarray,
    eye: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Native visibility ordering; None if unavailable or on graph failure
    (caller falls back to the Python implementation / identity order).
    ``eye`` selects the exact perspective orientation (see
    ``visibility_order_flags``)."""
    result = visibility_order_flags(
        box_min, box_max, owners, num_ranks, modelview, projection,
        view_dir, eye=eye,
    )
    return None if result is None else result[0]


def visibility_order_flags(
    box_min: np.ndarray,
    box_max: np.ndarray,
    owners: np.ndarray,
    num_ranks: int,
    modelview: np.ndarray,
    projection: np.ndarray,
    view_dir: np.ndarray,
    eye: Optional[np.ndarray] = None,
) -> Optional[tuple]:
    """Like ``visibility_order`` but returns ``(order, clean)`` where
    ``clean`` is True when no cycle-breaking split happened (the order
    then depends on the camera only through the adjacency DAG plus
    tie-breaks — cacheable, visibility.OrderKeyCache) and None when the
    loaded library predates the v2 symbol (cycles unknown, never cache).

    ``eye`` selects the exact perspective (eye-side-of-plane) edge
    orientation via the v3 symbol; a pre-v3 library falls back to the
    reference's directional predicate (orthographically exact only)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(box_min)
    box_min = np.ascontiguousarray(box_min, dtype=np.float64)
    box_max = np.ascontiguousarray(box_max, dtype=np.float64)
    owners = np.ascontiguousarray(owners, dtype=np.int32)
    modelview = np.ascontiguousarray(modelview, dtype=np.float32)
    projection = np.ascontiguousarray(projection, dtype=np.float32)
    view_dir = np.ascontiguousarray(view_dir, dtype=np.float64)
    out = np.zeros(num_ranks, dtype=np.int32)
    if eye is not None and hasattr(lib, "avr_visibility_order_v3"):
        eye64 = np.ascontiguousarray(eye, dtype=np.float64)
        cycles = ctypes.c_int(0)
        ok = lib.avr_visibility_order_v3(
            _ptr(box_min, ctypes.c_double), _ptr(box_max, ctypes.c_double),
            _ptr(owners, ctypes.c_int), n, num_ranks,
            _ptr(modelview, ctypes.c_float), _ptr(projection, ctypes.c_float),
            _ptr(view_dir, ctypes.c_double), _ptr(eye64, ctypes.c_double),
            _ptr(out, ctypes.c_int), ctypes.byref(cycles),
        )
        return (out, cycles.value == 0) if ok else None
    if hasattr(lib, "avr_visibility_order_v2"):
        cycles = ctypes.c_int(0)
        ok = lib.avr_visibility_order_v2(
            _ptr(box_min, ctypes.c_double), _ptr(box_max, ctypes.c_double),
            _ptr(owners, ctypes.c_int), n, num_ranks,
            _ptr(modelview, ctypes.c_float), _ptr(projection, ctypes.c_float),
            _ptr(view_dir, ctypes.c_double), _ptr(out, ctypes.c_int),
            ctypes.byref(cycles),
        )
        if not ok:
            return None
        # an eye was requested but only the directional (v2) predicate
        # ran: its DAG depends on sign(view_dir), which the eye-cell
        # OrderKeyCache key does NOT capture — report clean=None so the
        # order is never cached (two opposite-looking cameras sharing an
        # eye cell would otherwise serve each other reversed orders)
        return (out, None if eye is not None else cycles.value == 0)
    ok = lib.avr_visibility_order(
        _ptr(box_min, ctypes.c_double), _ptr(box_max, ctypes.c_double),
        _ptr(owners, ctypes.c_int), n, num_ranks,
        _ptr(modelview, ctypes.c_float), _ptr(projection, ctypes.c_float),
        _ptr(view_dir, ctypes.c_double), _ptr(out, ctypes.c_int),
    )
    return (out, None) if ok else None
