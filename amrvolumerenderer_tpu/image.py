"""Image algebra: dense array images with region windows and blend rules.

The reference implements an OO image hierarchy with MPI transport baked in
(``Common/Image.hpp``, ``Common/ImageColorOnly.hpp``,
``Common/ImageColorDepth.hpp`` and friends).  The JAX design replaces
it with *plain arrays plus pure blend functions*:

  * a pixel buffer is an ``np.ndarray``/``jnp.ndarray`` of shape
    ``[num_pixels, C]``;
  * the flat-pixel *region window* ``[region_begin, region_end)`` of the
    reference (Image.hpp:90-110) is kept as lightweight metadata on a thin
    ``ImageBuffer`` wrapper, because the direct-send compositor's piece
    arithmetic and the reference unit-test contracts
    (``Common/Testing/ImageFullTest.cpp``) are defined in terms of it;
  * blending is a vectorized function per image *kind*; transport is a JAX
    collective (see ``parallel/``), not a method.

Image kinds (mirroring Common/Image* subclasses):
  * ``RGBA_F32_DEPTH_SORT``  — 5ch float: premultiplied RGBA + depth hint;
    blend picks the nearer pixel as "front", then over-composites
    (ImageRGBAFloatColorDepthSort.hpp:13-27).  The volume pipeline type.
  * ``RGBA_F32``             — 4ch float, ordered over blend
    (ImageRGBAFloatColorOnly.hpp:20-27).
  * ``RGBA_U8``              — byte RGBA, ordered over blend in byte space
    (ImageRGBAUByteColorOnly.hpp:20-35).
  * ``RGBA_U8_DEPTH_F32``    — byte RGBA + float z, z-compare blend
    (ImageRGBAUByteColorFloatDepth.hpp, ImageColorDepth.hpp:142-245).
  * ``RGB_F32_DEPTH_F32``    — float RGB + float z, z-compare blend
    (ImageRGBFloatColorDepth.hpp).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax.numpy as jnp
import numpy as np


def _xp(a):
    """Dispatch to numpy for host arrays, jax.numpy otherwise."""
    return np if isinstance(a, np.ndarray) else jnp


class ImageKind(enum.Enum):
    RGBA_F32_DEPTH_SORT = "rgba_f32_depth_sort"
    RGBA_F32 = "rgba_f32"
    RGBA_U8 = "rgba_u8"
    RGBA_U8_DEPTH_F32 = "rgba_u8_depth_f32"
    RGB_F32_DEPTH_F32 = "rgb_f32_depth_f32"


_CHANNELS = {
    ImageKind.RGBA_F32_DEPTH_SORT: 5,
    ImageKind.RGBA_F32: 4,
    ImageKind.RGBA_U8: 4,
    ImageKind.RGBA_U8_DEPTH_F32: 5,
    ImageKind.RGB_F32_DEPTH_F32: 4,
}

_ORDER_DEPENDENT = {
    ImageKind.RGBA_F32_DEPTH_SORT: True,
    ImageKind.RGBA_F32: True,
    ImageKind.RGBA_U8: True,
    ImageKind.RGBA_U8_DEPTH_F32: False,
    ImageKind.RGB_F32_DEPTH_F32: False,
}


def color_to_byte(c):
    """Mesa-compatible float->byte conversion: ``clamp(int(c * 256))``
    (Common/Color.hpp:66-91)."""
    tv = np.asarray(np.asarray(c, dtype=np.float32) * np.float32(256.0)).astype(
        np.int32
    )
    return np.clip(tv, 0, 255).astype(np.uint8)


def byte_to_color(b):
    """Byte->float conversion ``b / 255`` (Common/Color.hpp:36-64)."""
    return np.clip(np.asarray(b, dtype=np.float32) / np.float32(255.0), 0.0, 1.0)


def color_to_byte_device(colors):
    """Device twin of ``color_to_byte`` (jnp): the ONE definition of the
    Mesa codec on device — the ubyte exchange transport and the batched
    byte readback must stay bit-identical to the host conversion."""
    import jax.numpy as jnp

    tv = (colors * jnp.float32(256.0)).astype(jnp.int32)
    return jnp.clip(tv, 0, 255).astype(jnp.uint8)


def byte_to_color_device(b):
    """Device twin of ``byte_to_color`` (jnp)."""
    import jax.numpy as jnp

    return b.astype(jnp.float32) / jnp.float32(255.0)


# ---------------------------------------------------------------------------
# Pixel-wise blend rules.  ``top`` is blended on top of ``bottom``.
# ---------------------------------------------------------------------------


def blend_depth_sort(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    """Depth-hint sorted over blend (ImageRGBAFloatColorDepthSort.hpp:13-27).

    Channel layout: [r, g, b, a, depth] with premultiplied color.  The pixel
    with the smaller depth is treated as front; output depth is the min.
    Works on numpy or jax arrays of shape [..., 5].
    """
    xp = _xp(top)
    top_d = top[..., 4:5]
    bottom_d = bottom[..., 4:5]
    top_is_front = top_d <= bottom_d
    front = xp.where(top_is_front, top, bottom)
    back = xp.where(top_is_front, bottom, top)
    out_rgba = front[..., :4] + back[..., :4] * (1.0 - front[..., 3:4])
    out_d = xp.minimum(top_d, bottom_d)
    return xp.concatenate([out_rgba, out_d], axis=-1)


def blend_over(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    """Ordered over blend of premultiplied RGBA (ImageRGBAFloatColorOnly.hpp:20-27)."""
    return top + bottom * (1.0 - top[..., 3:4])


def blend_over_bytes(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    """Byte-space over blend (ImageRGBAUByteColorOnly.hpp:20-35):
    ``out = top + bottom * (255 - top_a) / 255`` with integer truncation."""
    t = top.astype(np.int32)
    b = bottom.astype(np.int32)
    factor = 255 - t[..., 3:4]
    out = t + (b * factor) // 255
    return np.clip(out, 0, 255).astype(np.uint8)


def blend_z_compare(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    """Order-independent closest-depth select (ImageColorDepth.hpp:142-245).

    Channel layout: [..., colors..., depth] with depth last; the pixel with
    the strictly closer (smaller) depth wins, ties keep ``top``.
    """
    xp = _xp(top)
    closer = top[..., -1:] <= bottom[..., -1:]
    return xp.where(closer, top, bottom)


def blend_pixels(kind: ImageKind, top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    if kind == ImageKind.RGBA_F32_DEPTH_SORT:
        return blend_depth_sort(top, bottom)
    if kind == ImageKind.RGBA_F32:
        return blend_over(top, bottom)
    if kind == ImageKind.RGBA_U8:
        return blend_over_bytes(top, bottom)
    if kind in (ImageKind.RGBA_U8_DEPTH_F32, ImageKind.RGB_F32_DEPTH_F32):
        return blend_z_compare(top, bottom)
    raise ValueError(f"unknown image kind {kind}")


@dataclasses.dataclass
class Viewport:
    """Integer pixel rectangle (Common/Viewport.hpp)."""

    min_x: int
    min_y: int
    max_x: int
    max_y: int

    def valid(self) -> bool:
        return self.min_x <= self.max_x and self.min_y <= self.max_y

    def intersect(self, other: "Viewport") -> "Viewport":
        return Viewport(
            max(self.min_x, other.min_x),
            max(self.min_y, other.min_y),
            min(self.max_x, other.max_x),
            min(self.max_y, other.max_y),
        )

    def union(self, other: "Viewport") -> "Viewport":
        return Viewport(
            min(self.min_x, other.min_x),
            min(self.min_y, other.min_y),
            max(self.max_x, other.max_x),
            max(self.max_y, other.max_y),
        )


@dataclasses.dataclass
class ImageBuffer:
    """A dense pixel-region image: the array replacement for the ``Image`` tree.

    ``pixels`` holds the flat pixel rows for ``[region_begin, region_end)``
    of a conceptual ``width x height`` frame, matching the region-window
    semantics of Image.hpp:90-110.  ``window`` produces zero-copy views (the
    counterpart of the shallow ``Image::window``), ``blend`` implements the
    union-region semantics of ImageColorOnly.hpp:119-199.
    """

    kind: ImageKind
    width: int
    height: int
    pixels: np.ndarray  # [region_end - region_begin, C]
    region_begin: int = 0
    region_end: Optional[int] = None
    valid_viewport: Optional[Viewport] = None

    def __post_init__(self):
        if self.region_end is None:
            self.region_end = self.width * self.height
        if self.valid_viewport is None:
            self.valid_viewport = Viewport(0, 0, self.width - 1, self.height - 1)
        assert self.pixels.shape == (
            self.region_end - self.region_begin,
            _CHANNELS[self.kind],
        ), (self.pixels.shape, self.region_begin, self.region_end)

    # -- constructors -----------------------------------------------------

    @classmethod
    def create(
        cls,
        kind: ImageKind,
        width: int,
        height: int,
        region_begin: int = 0,
        region_end: Optional[int] = None,
    ) -> "ImageBuffer":
        if region_end is None:
            region_end = width * height
        dtype = np.uint8 if kind == ImageKind.RGBA_U8 else np.float32
        n = region_end - region_begin
        c = _CHANNELS[kind]
        if kind == ImageKind.RGBA_U8_DEPTH_F32:
            pixels = np.zeros((n, c), dtype=np.float32)
        else:
            pixels = np.zeros((n, c), dtype=dtype)
        return cls(kind, width, height, pixels, region_begin, region_end)

    # -- basic properties -------------------------------------------------

    @property
    def num_pixels(self) -> int:
        return self.region_end - self.region_begin

    def blend_is_order_dependent(self) -> bool:
        return _ORDER_DEPENDENT[self.kind]

    def pixel_index(self, x: int, y: int) -> int:
        return y * self.width + x - self.region_begin

    # -- pixel access (test/debug convenience) ----------------------------

    def get_color(self, x: int, y: int) -> np.ndarray:
        px = np.asarray(self.pixels[self.pixel_index(x, y)])
        if self.kind == ImageKind.RGBA_U8:
            return byte_to_color(px)
        if self.kind == ImageKind.RGBA_U8_DEPTH_F32:
            return byte_to_color(px[:4])
        if self.kind == ImageKind.RGB_F32_DEPTH_F32:
            return np.concatenate([px[:3].astype(np.float32), [np.float32(1.0)]])
        return px[:4].astype(np.float32)

    def set_color(self, x: int, y: int, rgba) -> None:
        idx = self.pixel_index(x, y)
        rgba = np.asarray(rgba, dtype=np.float32)
        if self.kind == ImageKind.RGBA_U8:
            self.pixels[idx] = color_to_byte(rgba)
        elif self.kind == ImageKind.RGBA_U8_DEPTH_F32:
            self.pixels[idx, :4] = color_to_byte(rgba).astype(np.float32)
        elif self.kind == ImageKind.RGB_F32_DEPTH_F32:
            self.pixels[idx, :3] = rgba[:3]
        elif self.kind == ImageKind.RGBA_F32_DEPTH_SORT:
            self.pixels[idx, :4] = rgba
            self.pixels[idx, 4] = np.inf
        else:
            self.pixels[idx] = rgba

    def get_depth(self, x: int, y: int) -> float:
        if self.kind in (ImageKind.RGBA_U8_DEPTH_F32, ImageKind.RGB_F32_DEPTH_F32):
            return float(self.pixels[self.pixel_index(x, y), -1])
        if self.kind == ImageKind.RGBA_F32_DEPTH_SORT:
            return float(self.pixels[self.pixel_index(x, y), 4])
        return 1.0

    def set_depth(self, x: int, y: int, depth: float) -> None:
        if self.kind in (
            ImageKind.RGBA_U8_DEPTH_F32,
            ImageKind.RGB_F32_DEPTH_F32,
            ImageKind.RGBA_F32_DEPTH_SORT,
        ):
            self.pixels[self.pixel_index(x, y), -1] = depth

    # -- region operations (Image.hpp contracts) --------------------------

    def clear(self, rgba=(0.0, 0.0, 0.0, 0.0), depth: float = 1.0) -> None:
        rgba = np.asarray(rgba, dtype=np.float32)
        if self.kind == ImageKind.RGBA_U8:
            self.pixels[:] = color_to_byte(rgba)[None, :]
        elif self.kind == ImageKind.RGBA_U8_DEPTH_F32:
            self.pixels[:, :4] = color_to_byte(rgba).astype(np.float32)[None, :]
            self.pixels[:, 4] = depth
        elif self.kind == ImageKind.RGB_F32_DEPTH_F32:
            self.pixels[:, :3] = rgba[:3][None, :]
            self.pixels[:, 3] = depth
        elif self.kind == ImageKind.RGBA_F32_DEPTH_SORT:
            self.pixels[:, :4] = rgba[None, :]
            self.pixels[:, 4] = np.inf
        else:
            self.pixels[:] = rgba[None, :]

    def window(self, sub_begin: int, sub_end: int) -> "ImageBuffer":
        """Zero-copy shallow view of a subrange (Image.hpp window contract);
        offsets are relative to this image's region."""
        assert 0 <= sub_begin <= sub_end <= self.num_pixels
        return ImageBuffer(
            self.kind,
            self.width,
            self.height,
            self.pixels[sub_begin:sub_end],
            self.region_begin + sub_begin,
            self.region_begin + sub_end,
            self.valid_viewport,
        )

    def copy_subrange(self, sub_begin: int, sub_end: int) -> "ImageBuffer":
        w = self.window(sub_begin, sub_end)
        return ImageBuffer(
            w.kind,
            w.width,
            w.height,
            np.array(w.pixels),
            w.region_begin,
            w.region_end,
            w.valid_viewport,
        )

    def deep_copy(self) -> "ImageBuffer":
        return self.copy_subrange(0, self.num_pixels)

    def blend(self, bottom: "ImageBuffer") -> "ImageBuffer":
        """Blend self on top of ``bottom`` with union-region semantics
        (ImageColorOnly.hpp:119-199): non-overlapping head/tail regions are
        copied through, the overlap is blended."""
        assert self.kind == bottom.kind
        assert self.region_begin <= bottom.region_end
        assert bottom.region_begin <= self.region_end

        begin = min(self.region_begin, bottom.region_begin)
        end = max(self.region_end, bottom.region_end)
        out = np.zeros((end - begin, self.pixels.shape[1]), dtype=self.pixels.dtype)

        ov_begin = max(self.region_begin, bottom.region_begin)
        ov_end = min(self.region_end, bottom.region_end)

        for img in (self, bottom):
            # copy-through of non-overlapping parts
            if img.region_begin < ov_begin:
                out[img.region_begin - begin : ov_begin - begin] = img.pixels[
                    : ov_begin - img.region_begin
                ]
            if img.region_end > ov_end:
                out[ov_end - begin : img.region_end - begin] = img.pixels[
                    ov_end - img.region_begin :
                ]
        if ov_end > ov_begin:
            top_ov = self.pixels[
                ov_begin - self.region_begin : ov_end - self.region_begin
            ]
            bot_ov = bottom.pixels[
                ov_begin - bottom.region_begin : ov_end - bottom.region_begin
            ]
            out[ov_begin - begin : ov_end - begin] = blend_pixels(
                self.kind, top_ov, bot_ov
            )
        return ImageBuffer(
            self.kind,
            self.width,
            self.height,
            out,
            begin,
            end,
            self.valid_viewport.intersect(bottom.valid_viewport),
        )

    # -- compaction (array replacement for RLE sparse images) ---------------

    def compress(self) -> "CompactImage":
        return CompactImage.from_buffer(self)


@dataclasses.dataclass
class CompactImage:
    """Bounding-rectangle compaction: the array-friendly stand-in for the
    reference's run-length-encoded sparse images (``Common/ImageSparse*``).

    RLE is inherently host-sequential; the behavioral goal (shrink transport
    volume by skipping background) is met with a dense sub-rectangle of rows
    covering all foreground pixels plus the valid-viewport clip, which keeps
    every buffer statically shaped and collective-friendly.
    """

    kind: ImageKind
    width: int
    height: int
    region_begin: int
    region_end: int
    active_begin: int  # flat pixel index of first kept pixel
    pixels: np.ndarray  # [active_count, C]
    valid_viewport: Viewport

    @staticmethod
    def _background_mask(buf: ImageBuffer) -> np.ndarray:
        if buf.kind in (ImageKind.RGBA_F32, ImageKind.RGBA_F32_DEPTH_SORT):
            return buf.pixels[:, 3] <= 0.0
        if buf.kind == ImageKind.RGBA_U8:
            return buf.pixels[:, 3] == 0
        # color-depth images: background = not closer than the far plane
        return buf.pixels[:, -1] >= 1.0

    @classmethod
    def from_buffer(cls, buf: ImageBuffer) -> "CompactImage":
        mask = ~cls._background_mask(buf)
        # clip to valid viewport (ImageSparseColorOnly.hpp:98-199 semantics)
        idx = np.arange(buf.region_begin, buf.region_end)
        xs = idx % buf.width
        ys = idx // buf.width
        vp = buf.valid_viewport
        in_vp = (xs >= vp.min_x) & (xs <= vp.max_x) & (ys >= vp.min_y) & (ys <= vp.max_y)
        mask = mask & in_vp
        if not np.any(mask):
            return cls(
                buf.kind,
                buf.width,
                buf.height,
                buf.region_begin,
                buf.region_end,
                buf.region_begin,
                buf.pixels[:0],
                vp,
            )
        first = int(np.argmax(mask))
        last = int(len(mask) - np.argmax(mask[::-1]))
        return cls(
            buf.kind,
            buf.width,
            buf.height,
            buf.region_begin,
            buf.region_end,
            buf.region_begin + first,
            np.array(buf.pixels[first:last]),
            vp,
        )

    def uncompress(self) -> ImageBuffer:
        out = ImageBuffer.create(
            self.kind, self.width, self.height, self.region_begin, self.region_end
        )
        out.clear()
        begin = self.active_begin - self.region_begin
        out.pixels[begin : begin + len(self.pixels)] = self.pixels
        out.valid_viewport = self.valid_viewport
        return out

    # -- compact-domain image algebra --------------------------------------
    # The reference blends/windows its sparse images WITHOUT uncompressing
    # (ImageSparseColorOnly.hpp:214-382 run-merging blend, 386-442
    # window/copySubrange); these are the bounding-range equivalents — every
    # operation costs O(active pixels), never O(region).

    @property
    def active_end(self) -> int:
        return self.active_begin + len(self.pixels)

    @property
    def num_pixels(self) -> int:
        return self.region_end - self.region_begin

    def _background_row(self) -> np.ndarray:
        """One cleared pixel in this kind's layout (matches
        ImageBuffer.clear: transparent color, far depth, +inf depth hint)."""
        buf = ImageBuffer.create(self.kind, 1, 1)
        buf.clear()
        return buf.pixels[0]

    def _dense_active(self, begin: int, end: int) -> np.ndarray:
        """Materialize [begin, end) of the active domain: stored pixels where
        covered, background elsewhere (still O(end-begin), not O(region))."""
        out = np.tile(self._background_row(), (end - begin, 1))
        lo = max(self.active_begin, begin)
        hi = min(self.active_end, end)
        if hi > lo:
            out[lo - begin : hi - begin] = self.pixels[
                lo - self.active_begin : hi - self.active_begin
            ]
        return out

    def window(self, sub_begin: int, sub_end: int) -> "CompactImage":
        """Zero-copy compact view of a subrange; offsets are relative to this
        image's region (the Image.hpp window contract the sparse types keep,
        ImageSparseColorOnly.hpp:386-442)."""
        assert 0 <= sub_begin <= sub_end <= self.num_pixels
        begin = self.region_begin + sub_begin
        end = self.region_begin + sub_end
        a0 = min(max(self.active_begin, begin), end)
        a1 = max(min(self.active_end, end), a0)
        if a1 == a0:  # empty: canonical form anchors at the region start
            return CompactImage(
                self.kind, self.width, self.height, begin, end, begin,
                self.pixels[:0], self.valid_viewport,
            )
        return CompactImage(
            self.kind,
            self.width,
            self.height,
            begin,
            end,
            a0,
            self.pixels[a0 - self.active_begin : a1 - self.active_begin],
            self.valid_viewport,
        )

    def copy_subrange(self, sub_begin: int, sub_end: int) -> "CompactImage":
        w = self.window(sub_begin, sub_end)
        return dataclasses.replace(w, pixels=np.array(w.pixels))

    def deep_copy(self) -> "CompactImage":
        return self.copy_subrange(0, self.num_pixels)

    def blend(self, bottom: "CompactImage") -> "CompactImage":
        """Blend self over ``bottom`` entirely in the compact domain.

        Union-region semantics match ImageBuffer.blend; the work and the
        result size are bounded by the CONTIGUOUS SPAN of the two active
        ranges (``_dense_active`` materializes [min(begin), max(end)) — two
        small runs at opposite ends of a large region cost O(span), unlike
        the reference's per-run walk, ImageSparseColorOnly.hpp:214-382;
        the common overlapping-layers case is O(active)).  Pixels covered
        by neither stay background, so the result compacts to exactly the
        union span."""
        assert self.kind == bottom.kind
        assert self.width == bottom.width and self.height == bottom.height
        region_begin = min(self.region_begin, bottom.region_begin)
        region_end = max(self.region_end, bottom.region_end)
        vp = self.valid_viewport.intersect(bottom.valid_viewport)
        nonempty = [im for im in (self, bottom) if len(im.pixels)]
        if not nonempty:
            return CompactImage(
                self.kind, self.width, self.height, region_begin, region_end,
                region_begin, self.pixels[:0], vp,
            )
        a0 = min(im.active_begin for im in nonempty)
        a1 = max(im.active_end for im in nonempty)
        out = blend_pixels(
            self.kind, self._dense_active(a0, a1), bottom._dense_active(a0, a1)
        )
        return CompactImage(
            self.kind, self.width, self.height, region_begin, region_end,
            a0, out, vp,
        )
