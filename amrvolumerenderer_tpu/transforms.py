"""Scalar sample transforms as jittable JAX functions.

Reproduces the device-callable scalar pipeline of the reference
(``Common/VolumeTypes.hpp:33-67``): non-finite samples map to zero, optional
natural-log scaling with a positive floor, optional normalization to [0, 1];
plus the soft tail clip (``Common/VolumePainter.cpp:75-105``).
"""

from __future__ import annotations

import jax.numpy as jnp

from .colormap import SOFT_CLIP_TOLERANCE
from .types import ScalarTransform


def transform_arrays(transform: ScalarTransform):
    """Flatten a ScalarTransform into jit-friendly scalars.

    Returns (log_scale: bool static, normalize: bool static, params dict of
    float32 scalars) for use inside jitted kernels.
    """
    return dict(
        log_scale=bool(transform.log_scale_input),
        normalize=bool(transform.normalize_to_unit_range),
        positive_floor=float(transform.positive_floor),
        normalization_min=float(transform.normalization_min),
        inverse_normalization_span=float(transform.inverse_normalization_span),
    )


def apply_scalar_transform(
    raw: jnp.ndarray,
    *,
    log_scale: bool,
    normalize: bool,
    positive_floor: float,
    normalization_min: float,
    inverse_normalization_span: float,
) -> jnp.ndarray:
    """``applyScalarTransform`` (VolumeTypes.hpp:53-67) on arrays.

    ``log_scale``/``normalize`` are Python bools (static under jit) so the
    compiled kernel contains no dead branches.
    """
    value = jnp.where(jnp.isfinite(raw), raw, 0.0)
    if log_scale:
        floor = jnp.asarray(positive_floor, value.dtype)
        value = jnp.where(value > 0.0, jnp.maximum(value, floor), floor)
        value = jnp.log(value)
    if normalize:
        value = (value - normalization_min) * inverse_normalization_span
        value = jnp.clip(value, 0.0, 1.0)
    return value


def saturate_soft_tail(value: jnp.ndarray, clip_start: float, rolloff_end: float):
    """Soft clip of the scalar tail (VolumePainter.cpp:75-105), JAX version.

    ``clip_start``/``rolloff_end`` are static floats (LUT metadata), so the
    degenerate hard-clamp branch resolves at trace time.
    """
    clamped_end = max(clip_start, rolloff_end)
    if not (clamped_end > clip_start + SOFT_CLIP_TOLERANCE):
        return jnp.clip(value, 0.0, clamped_end)
    return soft_tail(value, clip_start, clamped_end, clamped_end - clip_start)


def soft_tail(value, clip_start, clamped_end, span):
    """The smooth roll-off of ``saturate_soft_tail`` between ``clip_start``
    and ``clamped_end`` (``span`` = their difference, taken in double
    precision by the caller).  The scalars may be traced."""
    clamped = jnp.clip(value, 0.0, clamped_end)
    normalized = (clamped - clip_start) / span
    smooth = normalized + normalized * normalized - normalized**3
    soft = clip_start + span * smooth
    inside = (clamped > clip_start) & (clamped < clamped_end)
    return jnp.where(inside, soft, clamped)
