#!/usr/bin/env python3
"""Reproduce the visibility-graph ordering scaling numbers.

The native adjacency build is a per-axis plane sweep with an in-plane
interval band (native/avr_native.cpp rebuild_adjacency), replacing the
reference's O(n^2) pair loop (Common/VisibilityOrdering.cpp:261-317);
the Kahn ready list pops a heap.  This script times end-to-end
``piece_order_keys`` (depth ranges + adjacency + topological sort +
key assignment, native path) on g^3 grid partitions — the numbers that
justify PIECE_GRAPH_LIMIT = 16384 (visibility.py).

Usage: PYTHONPATH=. python scripts/visibility_scaling.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from amrvolumerenderer_tpu.types import CameraParameters  # noqa: E402
import amrvolumerenderer_tpu.visibility as vis  # noqa: E402


def grid_boxes(g: int):
    ax = np.arange(g) / g
    lo = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    return lo, lo + 1.0 / g


def main() -> int:
    from amrvolumerenderer_tpu.native import get_lib

    if get_lib() is None:
        print("native library unavailable; the sweep path is native-only")
        return 1
    cam = CameraParameters(
        eye=(2.1, 1.7, 3.3), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
        fov_y_degrees=45.0, near_plane=0.1, far_plane=20.0,
    )
    vis.PIECE_GRAPH_LIMIT = 10 ** 9  # measurement only
    print(f"{'boxes':>8}  {'order ms':>9}")
    for g in (8, 16, 24, 32, 40):
        lo, hi = grid_boxes(g)
        t0 = time.perf_counter()
        keys = vis.piece_order_keys(cam, 1.0, lo, hi)
        dt = (time.perf_counter() - t0) * 1e3
        assert keys is not None and len(keys) == g ** 3
        print(f"{g ** 3:>8}  {dt:>9.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
