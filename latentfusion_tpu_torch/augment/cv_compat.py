"""The few OpenCV image operations the augmentations use, in numpy and scipy.

The GPU machine has no OpenCV, so each is rebuilt from OpenCV's definition:
the 8-bit RGB <-> HSV conversions (H in 0..179) with OpenCV's integer
division tables and float arithmetic, the same bytes as ``cv2.cvtColor``;
``getStructuringElement(MORPH_ELLIPSE)`` and binary erosion and dilation
with OpenCV's border rule, exactly; ``getRotationMatrix2D``;
``warpAffine`` (nearest and bilinear from float32 source coordinates,
zero border); ``filter2D`` with a reflect-101 border;
and filled ellipses as ``cv2.ellipse`` outlines them (a polygon through
its sine table's points), filled by pixel centres.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

HSV_SHIFT = 12
_SECTORS = np.asarray([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, COLOR_RGB2HSV)`` of a uint8 (..., 3) image."""
    rgb = np.asarray(rgb).astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * _SDIV[v] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _fma32(a, b, c):
    """float32 a * b + c rounded once (a fused multiply-add)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2RGB)`` of a uint8 (..., 3) image with H
    in 0..179: float32 in [0, 1] with fused multiply-adds, scaled by 255 and
    truncated, as OpenCV computes it."""
    f32 = np.float32
    hsv = np.asarray(hsv)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180)
    s = hsv[..., 1].astype(f32) * f32(1 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1 / 255.0)
    sector = np.floor(h).astype(np.int64)
    frac = h - sector.astype(f32)
    out_of_range = (sector < 0) | (sector >= 6)
    sector = np.where(out_of_range, 0, sector)
    frac = np.where(out_of_range, f32(0), frac)
    tab = np.stack([v, v * (f32(1) - s), v * _fma32(-s, frac, 1.0),
                    v * _fma32(-s, f32(1) - frac, 1.0)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    return np.trunc(bgr[..., ::-1] * f32(255)).astype(np.uint8)


def ellipse_kernel(size: int) -> np.ndarray:
    """``cv2.getStructuringElement(MORPH_ELLIPSE, (size, size))`` as bool."""
    r = c = size // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    kernel = np.zeros((size, size), dtype=bool)
    for i in range(size):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            kernel[i, max(c - dx, 0):min(c + dx + 1, size)] = True
    return kernel


def erode(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """OpenCV's erosion of a binary mask: pixels outside the image count as
    set, so the border does not erode."""
    return ndimage.binary_erosion(mask, structure=kernel, border_value=1)


def dilate(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """OpenCV's dilation of a binary mask (pixels outside count as unset;
    the kernel is symmetric)."""
    return ndimage.binary_dilation(mask, structure=kernel, border_value=0)


MORPH_OPS = {
    "erode": erode,
    "dilate": dilate,
    "open": lambda m, k: dilate(erode(m, k), k),
    "close": lambda m, k: erode(dilate(m, k), k),
}


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64, angle in degrees, the
    centre rounded to float32 as OpenCV's ``Point2f``."""
    a = angle * (np.pi / 180)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = (float(np.float32(v)) for v in center)
    return np.asarray([[alpha, beta, (1 - alpha) * cx - beta * cy],
                       [-beta, alpha, beta * cx + (1 - alpha) * cy]], dtype=np.float64)


def _inverse_affine(M) -> np.ndarray:
    M = np.asarray(M, dtype=np.float64).reshape(6).copy()
    D = M[0] * M[4] - M[1] * M[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = M[4] * D, M[0] * D
    M[0], M[1], M[3], M[4] = a11, M[1] * -D, M[3] * -D, a22
    b1 = -M[0] * M[2] - M[1] * M[5]
    b2 = -M[3] * M[2] - M[4] * M[5]
    M[2], M[5] = b1, b2
    return M


def _source_coords(M, dsize):
    """warpAffine's float32 source coordinates (x, y) of every destination
    pixel: the inverse of ``M`` applied to the pixel's indices."""
    w, h = dsize
    Mi = _inverse_affine(M).astype(np.float32)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return Mi[0] * x + Mi[1] * y + Mi[2], Mi[3] * x + Mi[4] * y + Mi[5]


def _taps(src, X, Y):
    h, w = src.shape[:2]
    inside = (X >= 0) & (X < w) & (Y >= 0) & (Y < h)
    out = src[np.clip(Y, 0, h - 1), np.clip(X, 0, w - 1)]
    return np.where(inside.reshape(inside.shape + (1,) * (src.ndim - 2)), out, 0)


def warp_affine_nearest(src: np.ndarray, M, dsize) -> np.ndarray:
    """``cv2.warpAffine(src, M, dsize, flags=INTER_NEAREST)``, zero border:
    each source coordinate rounded to the nearest pixel."""
    sx, sy = _source_coords(M, dsize)
    return _taps(src, np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)).astype(src.dtype)


def warp_affine_linear(src: np.ndarray, M, dsize) -> np.ndarray:
    """``cv2.warpAffine(src, M, dsize)`` (bilinear, zero border) of a float32
    (H, W) image."""
    sx, sy = _source_coords(M, dsize)
    X, Y = np.floor(sx), np.floor(sy)
    fx, fy = sx - X, sy - Y
    X, Y = X.astype(np.int64), Y.astype(np.int64)
    one = np.float32(1)
    out = (_taps(src, X, Y).astype(np.float32) * (one - fx) * (one - fy)
           + _taps(src, X + 1, Y).astype(np.float32) * fx * (one - fy)
           + _taps(src, X, Y + 1).astype(np.float32) * (one - fx) * fy
           + _taps(src, X + 1, Y + 1).astype(np.float32) * fx * fy)
    return out.astype(np.float32)


def filter2d(src: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(src, -1, kernel)`` of a float32 (H, W[, C]) image:
    correlation about the kernel's centre, reflect-101 border, each output
    the float32 sum over the kernel's nonzero taps in row-major order."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    pad = [(ay, kh - 1 - ay), (ax, kw - 1 - ax)] + [(0, 0)] * (src.ndim - 2)
    padded = np.pad(src.astype(np.float32), pad, mode="reflect")
    h, w = src.shape[:2]
    out = np.zeros(src.shape, np.float32)
    for i, j in zip(*np.nonzero(kernel)):
        out = out + np.float32(kernel[i, j]) * padded[i:i + h, j:j + w]
    return out


_SIN_TABLE = np.sin(np.deg2rad(np.arange(451))).astype(np.float32)
XY_SHIFT = 16


def _ellipse_polygon(center, axes, angle: int, delta: int) -> np.ndarray:
    """``cv2.ellipse2Poly``'s points of a whole ellipse (fixed point, 2^16)."""
    angle %= 360
    alpha, beta = float(_SIN_TABLE[450 - angle]), float(_SIN_TABLE[angle])
    points = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x = axes[0] * float(_SIN_TABLE[450 - a])
        y = axes[1] * float(_SIN_TABLE[a])
        points.append((center[0] + x * alpha - y * beta, center[1] + x * beta + y * alpha))
    return np.asarray(points)


def fill_ellipse(img: np.ndarray, center, axes, angle: float, value) -> np.ndarray:
    """``cv2.ellipse(img, center, axes, angle, 0, 360, value, -1)`` in place:
    OpenCV's polygon (vertices on its 2^-16 grid), filled by scanlines as
    ``fillConvexPoly`` fills it: rows from the rounded top to the rounded
    bottom, each from its rounded left to its rounded right crossing. Edge
    pixels may differ from OpenCV's fixed-point edge walk."""
    one = 1 << XY_SHIFT
    ax, ay = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
    reach = (max(ax, ay) + (one >> 1)) >> XY_SHIFT
    delta = 90 if reach < 3 else 30 if reach < 10 else 18 if reach < 15 else 5
    c = (int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT)
    poly = np.rint(_ellipse_polygon(c, (ax, ay), int(np.rint(angle)), delta)) / one
    h, w = img.shape[:2]
    py, qy = poly[:-1, 1], poly[1:, 1]
    px, qx = poly[:-1, 0], poly[1:, 0]
    top, bottom = poly[:, 1].min(), poly[:, 1].max()
    for y in range(max(int(np.floor(top + 0.5)), 0), min(int(np.floor(bottom + 0.5)), h - 1) + 1):
        yc = min(max(float(y), top), bottom)
        lo, hi = np.minimum(py, qy), np.maximum(py, qy)
        hit = (lo <= yc) & (yc <= hi)
        span = np.where(qy != py, (yc - py) / np.where(qy != py, qy - py, 1.0), 0.0)
        xs = np.concatenate([(px + span * (qx - px))[hit], px[py == yc], qx[qy == yc]])
        x0 = max(int(np.floor(xs.min() + 0.5)), 0)
        x1 = min(int(np.floor(xs.max() + 0.5)), w - 1)
        if x0 <= x1:
            img[y, x0:x1 + 1] = value
    return img


def _drop_single_channel(src: np.ndarray) -> np.ndarray:
    return src[..., 0] if src.ndim == 3 and src.shape[2] == 1 else src


def _resize_scale(src_size: int, dst_size: int) -> float:
    return 1.0 / (dst_size / src_size)


def resize_nearest(src: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(src, dsize, interpolation=INTER_NEAREST)``, ``dsize`` =
    (width, height): destination pixel x reads source pixel
    ``min(floor(x * src_w / dst_w), src_w - 1)``, likewise y. One channel
    comes back (H, W), as from OpenCV."""
    src = _drop_single_channel(src)
    w, h = dsize
    sh, sw = src.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * _resize_scale(sw, w)).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * _resize_scale(sh, h)).astype(np.int64), sh - 1)
    return src[ys[:, None], xs[None, :]]


def _linear_taps(src_size: int, dst_size: int):
    """INTER_LINEAR's source indices and float32 weights of the two taps of
    each destination index: centre-aligned, the fraction in float64,
    clamped at both borders."""
    f = (np.arange(dst_size) + 0.5) * _resize_scale(src_size, dst_size) - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    low, high = s < 0, s >= src_size - 1
    f[low | high] = 0
    s[low] = 0
    s[high] = src_size - 1
    return s, np.minimum(s + 1, src_size - 1), (1 - f).astype(np.float32), f.astype(np.float32)


def resize_linear(src: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(src, dsize)`` (INTER_LINEAR) of a float32 (H, W) or
    (H, W, C) image, ``dsize`` = (width, height): rows, then columns,
    each a float32 blend of two taps. One channel comes back (H, W), as
    from OpenCV."""
    w, h = dsize
    src = _drop_single_channel(np.asarray(src, np.float32))
    sh, sw = src.shape[:2]
    x0, x1, ax, bx = _linear_taps(sw, w)
    y0, y1, ay, by = _linear_taps(sh, h)
    extra = (1,) * (src.ndim - 2)
    rows = src[:, x0] * ax.reshape((1, w) + extra) + src[:, x1] * bx.reshape((1, w) + extra)
    return (rows[y0] * ay.reshape((h, 1) + extra)
            + rows[y1] * by.reshape((h, 1) + extra)).astype(np.float32)
