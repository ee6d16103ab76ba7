"""Color/opacity transfer-function table construction (host precompute).

Reproduces the 256-entry LUT build of the reference ray-cast kernel
(``Common/VolumePainter.cpp:39-516``): piecewise-linear color interpolation
(CIELAB space for user colormaps, RGB for the built-in jet default), the
VTK-style opacity nodes with midpoint/sharpness hermite shaping, alpha
scaling by ``1 - box_transparency`` and per-brick opacity normalization
``1 - (1 - a)^(step / reference_step)``.

The LUT is a tiny (256, 4) float32 array computed once per brick bucket on
the host; the device march only does a table lookup.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from .types import ColorMap

COLOR_TABLE_SIZE = 256
SOFT_CLIP_TOLERANCE = 1e-5

# Built-in jet-like default color nodes (VolumePainter.cpp:471-479).
_JET_NODES = [
    (0.0, 0.0, 0.0, 0.5625),
    (0.111111, 0.0, 0.0, 1.0),
    (0.3650795, 0.0, 1.0, 1.0),
    (0.4920635, 0.5, 1.0, 0.5),
    (0.6190475, 1.0, 1.0, 0.0),
    (0.873016, 1.0, 0.0, 0.0),
    (1.0, 0.5, 0.0, 0.0),
]
# Default opacity ramp (VolumePainter.cpp:484-487).
_DEFAULT_OPACITY_POSITIONS = [0.0, 0.15, 0.35, 0.6, 0.85, 1.0]
_DEFAULT_OPACITY_ALPHAS = [0.05, 0.15, 0.22, 0.3, 0.38, 0.5]


def compute_scaled_alpha(
    base_alpha: float, alpha_scale: float, normalization_factor: float
) -> float:
    """Opacity normalization by step ratio (VolumePainter.cpp:107-125)."""
    scaled_base = min(max(base_alpha * alpha_scale, 0.0), 1.0)
    if normalization_factor <= 0.0 or scaled_base <= 0.0:
        return 0.0
    if scaled_base >= 1.0:
        return 1.0
    transmittance = (1.0 - float(scaled_base)) ** float(normalization_factor)
    scaled_alpha = 1.0 - transmittance
    if not math.isfinite(scaled_alpha):
        scaled_alpha = scaled_base
    return min(max(scaled_alpha, 0.0), 1.0)


def _srgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """sRGB -> CIELAB used for colormap interpolation (VolumePainter.cpp:202-256)."""
    c = rgb.astype(np.float64)
    lin = np.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    x = r * 0.4124 + g * 0.3576 + b * 0.1805
    y = r * 0.2126 + g * 0.7152 + b * 0.0722
    z = r * 0.0193 + g * 0.1192 + b * 0.9505
    ref = np.array([0.9505, 1.0, 1.089])
    var = np.stack([x, y, z], axis=-1) / ref
    var = np.where(var > 0.008856, np.cbrt(var), 7.787 * var + 16.0 / 116.0)
    vx, vy, vz = var[..., 0], var[..., 1], var[..., 2]
    return np.stack([116.0 * vy - 16.0, 500.0 * (vx - vy), 200.0 * (vy - vz)], axis=-1)


def _lab_to_srgb(lab: np.ndarray) -> np.ndarray:
    """CIELAB -> sRGB, with the reference's max-channel renormalization
    (VolumePainter.cpp:258-320)."""
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    y = (L + 16.0) / 116.0
    x = a / 500.0 + y
    z = y - b / 200.0
    xyz = np.stack([x, y, z], axis=-1)
    cubed = xyz**3
    xyz = np.where(cubed > 0.008856, cubed, (xyz - 16.0 / 116.0) / 7.787)
    xyz = xyz * np.array([0.9505, 1.0, 1.089])
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = x * 3.2406 + y * -1.5372 + z * -0.4986
    g = x * -0.9689 + y * 1.8758 + z * 0.0415
    bb = x * 0.0557 + y * -0.2040 + z * 1.0570
    rgb = np.stack([r, g, bb], axis=-1)
    rgb = np.where(
        rgb > 0.0031308, 1.055 * np.abs(rgb) ** (1.0 / 2.4) - 0.055, 12.92 * rgb
    )
    max_val = rgb.max(axis=-1, keepdims=True)
    # guard the unselected branch: np.where still evaluates rgb / max_val
    # where max_val <= 0 (all-black rows), which would warn on 0/0
    rgb = np.where(max_val > 1.0, rgb / np.maximum(max_val, 1.0), rgb)
    return np.maximum(rgb, 0.0)


def _map_opacity(
    values: np.ndarray,
    node_values: np.ndarray,
    node_alphas: np.ndarray,
    node_midpoints: np.ndarray,
    node_sharpness: np.ndarray,
) -> np.ndarray:
    """Piecewise opacity with VTK midpoint/sharpness (VolumePainter.cpp:381-440)."""
    if node_values.size == 0:
        return np.ones_like(values)
    out = np.empty_like(values, dtype=np.float64)
    first_v, last_v = node_values[0], node_values[-1]
    out[:] = np.nan
    below = values <= first_v
    above = values >= last_v
    out[below] = node_alphas[0]
    out[~below & above] = node_alphas[-1]
    mid = ~(below | above)
    if np.any(mid):
        v = values[mid]
        # segment index: first node with node_value >= v
        right_idx = np.searchsorted(node_values, v, side="left")
        right_idx = np.clip(right_idx, 1, len(node_values) - 1)
        left_idx = right_idx - 1
        lv, rv = node_values[left_idx], node_values[right_idx]
        la, ra = node_alphas[left_idx], node_alphas[right_idx]
        midpoint = node_midpoints[left_idx]
        sharp = node_sharpness[left_idx]
        span = rv - lv
        w = np.where(span > 0.0, (v - lv) / np.where(span > 0, span, 1.0), 0.0)
        # midpoint remap
        w = np.where(
            w < midpoint,
            0.5 * w / np.where(midpoint > 0, midpoint, 1.0),
            0.5 + 0.5 * (w - midpoint) / np.where(midpoint < 1, 1.0 - midpoint, 1.0),
        )
        lin = la + (ra - la) * w
        stepped = np.where(w < 0.5, la, ra)
        # sharpened hermite path
        ws = np.where(
            w < 0.5,
            0.5 * np.power(np.maximum(w * 2.0, 0.0), 1.0 + 10.0 * sharp),
            np.where(
                w > 0.5,
                1.0 - 0.5 * np.power(np.maximum((1.0 - w) * 2.0, 0.0), 1.0 + 10.0 * sharp),
                w,
            ),
        )
        ww = ws * ws
        www = ww * ws
        h1 = 2.0 * www - 3.0 * ww + 1.0
        h2 = -2.0 * www + 3.0 * ww
        h3 = www - 2.0 * ww + ws
        h4 = www - ww
        t = (1.0 - sharp) * (ra - la)
        hermite = h1 * la + h2 * ra + h3 * t + h4 * t
        hermite = np.clip(hermite, np.minimum(la, ra), np.maximum(la, ra))
        res = np.where(sharp == 1.0, stepped, np.where(sharp == 0.0, lin, hermite))
        out[mid] = res
    return out


def _map_colors(
    values: np.ndarray,
    node_values: np.ndarray,
    node_rgb: np.ndarray,
    use_lab: bool,
) -> np.ndarray:
    """Piecewise-linear color lookup with clamping (VolumePainter.cpp:331-379)."""
    n = len(node_values)
    out = np.empty((values.shape[0], 3), dtype=np.float64)
    if n == 0:
        out[:] = 0.0
        return out
    below = values < node_values[0]
    above = values > node_values[-1]
    out[below] = node_rgb[0]
    out[above] = node_rgb[-1]
    mid = ~(below | above)
    if np.any(mid):
        v = values[mid]
        right_idx = np.clip(np.searchsorted(node_values, v, side="left"), 1, n - 1)
        left_idx = right_idx - 1
        lv, rv = node_values[left_idx], node_values[right_idx]
        span = rv - lv
        t = np.where(span > 0.0, (v - lv) / np.where(span > 0, span, 1.0), 0.0)
        t = t[:, None]
        if use_lab:
            left_lab = _srgb_to_lab(node_rgb[left_idx])
            right_lab = _srgb_to_lab(node_rgb[right_idx])
            lab = left_lab + (right_lab - left_lab) * t
            out[mid] = _lab_to_srgb(lab)
        else:
            out[mid] = node_rgb[left_idx] + (node_rgb[right_idx] - node_rgb[left_idx]) * t
        # exact node hits use the node color directly (mapColorValue 354-359)
        exact_first = values == node_values[0]
        exact_last = values == node_values[-1]
        out[exact_first] = node_rgb[0]
        out[exact_last] = node_rgb[-1]
    return out


def build_color_table(
    alpha_scale: float,
    normalization_factor: float,
    scalar_range: Tuple[float, float],
    color_map: Optional[ColorMap] = None,
    size: int = COLOR_TABLE_SIZE,
) -> np.ndarray:
    """Build the (size, 4) float32 transfer-function LUT.

    Reproduces ``buildColorTable`` (VolumePainter.cpp:442-516): user colormaps
    interpolate in Lab space; otherwise a jet default with a fixed opacity
    ramp rescaled onto the scalar range is used.  Entry i maps scalar value
    ``range_min + span * i / (size - 1)``.  ``size`` defaults to the
    reference's 256; 128 is the opt-in half-resolution mode that halves the
    render kernels' LUT-gather cost (RenderParameters.lut_size).
    """
    range_min, range_max = float(scalar_range[0]), float(scalar_range[1])
    span = range_max - range_min

    if color_map:
        pts = sorted(color_map, key=lambda p: p.value)
        node_values = np.array([p.value for p in pts], dtype=np.float64)
        node_rgb = np.clip(
            np.array([[p.red, p.green, p.blue] for p in pts], dtype=np.float64),
            0.0,
            1.0,
        )
        node_alphas = np.array(
            [
                compute_scaled_alpha(p.alpha, alpha_scale, normalization_factor)
                for p in pts
            ],
            dtype=np.float64,
        )
        use_lab = True
    else:
        node_values = np.array([n[0] for n in _JET_NODES], dtype=np.float64)
        node_rgb = np.array([n[1:] for n in _JET_NODES], dtype=np.float64)
        op_values = np.array(_DEFAULT_OPACITY_POSITIONS, dtype=np.float64)
        op_alphas = np.array(
            [
                compute_scaled_alpha(a, alpha_scale, normalization_factor)
                for a in _DEFAULT_OPACITY_ALPHAS
            ],
            dtype=np.float64,
        )
        # Opacity node values are placed on the scalar range, color nodes on
        # [0, 1]; the whole table is then rescaled so the union of node values
        # spans the scalar range (VolumePainter.cpp:484-499).
        op_values = op_values * span + range_min
        all_vals = np.concatenate([node_values, op_values])
        old_min, old_max = all_vals.min(), all_vals.max()
        old_span = old_max - old_min
        new_span = span
        if old_span > 0.0 and new_span > 0.0:
            node_values = range_min + new_span * (node_values - old_min) / old_span
            op_values = range_min + new_span * (op_values - old_min) / old_span
        use_lab = False

    if size < 2:
        raise ValueError(f"color table size must be >= 2, got {size}")
    sample_t = np.arange(size, dtype=np.float64) / (size - 1)
    sample_values = range_min + span * sample_t

    rgb = _map_colors(sample_values, node_values, node_rgb, use_lab)
    if color_map:
        alpha = _map_opacity(
            sample_values,
            node_values,
            node_alphas,
            np.full(len(node_values), 0.5),
            np.zeros(len(node_values)),
        )
    else:
        alpha = _map_opacity(
            sample_values,
            op_values,
            op_alphas,
            np.full(len(op_values), 0.5),
            np.zeros(len(op_values)),
        )

    table = np.concatenate([rgb, alpha[:, None]], axis=1).astype(np.float32)
    return table


def saturate_soft_tail_np(value: np.ndarray, clip_start: float, rolloff_end: float):
    """Soft clip of the scalar tail (VolumePainter.cpp:75-105), NumPy version."""
    clamped_end = max(clip_start, rolloff_end)
    v = np.clip(value, 0.0, clamped_end)
    if not (clamped_end > clip_start + SOFT_CLIP_TOLERANCE):
        return v
    inside = (v > clip_start) & (v < clamped_end)
    normalized = (v - clip_start) / (clamped_end - clip_start)
    smooth = normalized + normalized**2 - normalized**3
    return np.where(inside, clip_start + (clamped_end - clip_start) * smooth, v)
