"""amrvolumerenderer_tpu: JAX distributed AMR volume renderer for GPUs.

A from-scratch JAX/XLA/Pallas re-design of BenWibking/amrVolumeRenderer:
sort-last compositing of ray-marched block-structured AMR data, built on
device meshes and collectives instead of MPI.

Public surface mirrors the reference Python module
(python/amrVolumeRenderer/__init__.py and module.cpp): ``render``,
``compute_histogram``, ``initialize_runtime``, ``finalize_runtime``; plus the
in-situ API under ``amrvolumerenderer_tpu.api``.
"""

from __future__ import annotations

from typing import Optional

_manual_ref_count = 0


def initialize_runtime() -> None:
    """Pin runtime initialization across multiple render() calls.

    The reference manages MPI+AMReX lifetime by refcount (module.cpp:22-119);
    in JAX the runtime is process-global and initialized lazily, so this just
    tracks the refcount (and warms up the backend) for API parity.
    """
    global _manual_ref_count
    import jax

    from .utils.compile_cache import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    jax.devices()  # force backend initialization
    _manual_ref_count += 1


def finalize_runtime() -> None:
    global _manual_ref_count
    if _manual_ref_count == 0:
        raise RuntimeError(
            "amrvolumerenderer_tpu.finalize_runtime requires a matching "
            "initialize_runtime call"
        )
    _manual_ref_count -= 1


def render(
    plotfile: str,
    width: int = 512,
    height: int = 512,
    box_transparency: float = 0.0,
    antialiasing: int = 1,
    visibility_graph: bool = True,
    write_visibility_graph: bool = False,
    variable: Optional[str] = None,
    min_level: int = 0,
    max_level: int = -1,
    log_scale: bool = False,
    up_vector=None,
    output: Optional[str] = None,
    scalar_range=None,
    camera_eye=None,
    camera_look_at=None,
    camera_up=None,
    camera_fov_y: Optional[float] = None,
    camera_near: Optional[float] = None,
    camera_far: Optional[float] = None,
    color_map=None,
    devices: Optional[int] = None,
    sampling: str = "nearest",
    classification: str = "post",
    lut_size: int = 256,
    orbit_frames: int = 0,
    orbit_degrees: float = 360.0,
) -> int:
    """Render a plotfile; the exact kwarg surface of the reference binding
    (python/amrVolumeRenderer/module.cpp:276-303).  ``devices``,
    ``sampling``, ``classification``, ``lut_size`` and
    ``orbit_frames``/``orbit_degrees`` are beyond-reference: distribute the
    render across that many mesh devices (the reference distributes by
    launching under ``mpirun -n``), select trilinear sampling, choose the
    transfer-function classification order, set the LUT resolution (see
    RenderParameters), and render an N-frame orbit animation through the
    persistent batched renderer (frame index appended to ``output``)."""
    from .driver import RunOptions, run_options

    options = RunOptions(
        plotfile_path=plotfile,
        variable_name=variable or "",
        min_level=min_level,
        max_level=max_level,
        log_scale_input=log_scale,
    )
    options.parameters.width = width
    options.parameters.height = height
    options.parameters.box_transparency = box_transparency
    options.parameters.antialiasing = antialiasing
    options.parameters.use_visibility_graph = visibility_graph
    options.parameters.write_visibility_graph = write_visibility_graph
    options.parameters.sampling = sampling
    options.parameters.classification = classification
    options.parameters.lut_size = int(lut_size)
    if orbit_frames:
        if int(orbit_frames) <= 0:
            raise ValueError("orbit_frames must be positive")
        options.orbit_frames = int(orbit_frames)
        options.orbit_degrees = float(orbit_degrees)
    if devices is not None:
        if int(devices) <= 0:
            raise ValueError("devices must be a positive device count")
        options.parameters.devices = int(devices)
    if output is not None:
        if not output:
            raise ValueError("output filename must not be empty")
        options.output_filename = output

    if up_vector is not None:
        import numpy as np

        up = np.asarray(up_vector, dtype=np.float64)
        length = float(np.linalg.norm(up))
        if not (length > 0.0) or not np.isfinite(length):
            raise ValueError("up_vector must contain finite, non-zero components")
        options.parameters.camera_up = up / length

    if scalar_range is not None:
        import math

        lo, hi = float(scalar_range[0]), float(scalar_range[1])
        if not (math.isfinite(lo) and math.isfinite(hi) and lo < hi):
            raise ValueError(
                "scalar_range must contain two finite values with min < max"
            )
        options.scalar_range = (lo, hi)

    any_camera = any(
        v is not None
        for v in (camera_eye, camera_look_at, camera_up, camera_fov_y,
                  camera_near, camera_far)
    )
    if any_camera:
        if camera_eye is None or camera_look_at is None:
            raise ValueError(
                "camera_eye and camera_look_at must be provided when "
                "specifying a camera"
            )
        import math

        import numpy as np

        from .types import CameraParameters

        up = np.asarray(
            camera_up if camera_up is not None else (0.0, 1.0, 0.0),
            dtype=np.float64,
        )
        up_len = float(np.linalg.norm(up))
        if not (up_len > 0.0) or not math.isfinite(up_len):
            raise ValueError("camera_up must contain finite, non-zero components")
        options.camera = CameraParameters(
            eye=camera_eye,
            look_at=camera_look_at,
            up=up / up_len,
            fov_y_degrees=camera_fov_y if camera_fov_y is not None else 45.0,
            near_plane=camera_near if camera_near is not None else 0.1,
            far_plane=camera_far if camera_far is not None else 1000.0,
        )

    if color_map is not None:
        from .types import color_map_from_tuples

        options.color_map = color_map_from_tuples(color_map)

    return run_options(options)


def compute_histogram(
    plotfile: str,
    variable: Optional[str] = None,
    min_level: int = 0,
    max_level: int = -1,
    log_scale: bool = False,
    bins: int = 256,
) -> dict:
    """Histogram of normalized scalar values used during rendering; matches
    the reference binding's return dict (module.cpp:304-356)."""
    from .driver import compute_scalar_histogram

    hist = compute_scalar_histogram(
        plotfile, variable or "", min_level, max_level, log_scale, bins
    )
    return {
        "counts": hist.bin_counts.tolist(),
        "normalized_range": list(hist.normalized_range),
        "processed_range": (
            list(hist.processed_range) if hist.has_processed_range else None
        ),
        "original_range": (
            list(hist.original_range) if hist.has_original_range else None
        ),
        "samples": int(hist.sample_count),
    }


def __getattr__(name):
    # lazy re-exports of the extended (beyond-reference) API surface
    if name == "FastSceneRenderer":
        from .fast_scene import FastSceneRenderer

        return FastSceneRenderer
    if name == "prepare_device_scene":
        from .device_scene import prepare_device_scene

        return prepare_device_scene
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "render",
    "compute_histogram",
    "initialize_runtime",
    "finalize_runtime",
    "FastSceneRenderer",
    "prepare_device_scene",
]
