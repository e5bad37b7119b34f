"""Host mesh rasterizer (counterpart of ``latentfusion_tpu/data/rasterizer.py``).

``native/rasterizer.cpp`` (z-buffer, perspective-correct barycentrics,
UV-mapped albedo, Blinn-Phong with point lights) is compiled with g++ at
first use into ``_build/librasterizer-<hash>.so``, the hash covering the
source and the flags, and bound with ctypes. It runs in the loader's worker
processes on the host, as in the JAX package; it is not a device kernel.

A failed build or load raises: there is no silent fallback. The numpy
rasterizer ``rasterize_plain`` is its plain twin, for tests and checks.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "rasterizer.cpp"
BUILD_DIR = _PKG / "_build"
# native/Makefile's flags.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")

_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_ARGTYPES = [
    _FLOAT_P, ctypes.c_int,                          # vertices
    ctypes.POINTER(ctypes.c_int32), ctypes.c_int,    # faces
    _FLOAT_P,                                        # vertex_colors
    _FLOAT_P,                                        # vertex_normals
    _FLOAT_P,                                        # uvs
    _FLOAT_P,                                        # texture
    ctypes.c_int, ctypes.c_int,                      # tex_w, tex_h
    ctypes.c_float,                                  # uv_scale
    _FLOAT_P,                                        # extrinsic
    _FLOAT_P,                                        # intrinsic
    ctypes.c_int, ctypes.c_int,                      # width, height
    _FLOAT_P,                                        # light_pos
    _FLOAT_P,                                        # light_color
    _FLOAT_P,                                        # light_intensity
    ctypes.c_int,                                    # n_lights
    ctypes.c_float,                                  # ambient
    ctypes.c_float,                                  # specular
    ctypes.c_float,                                  # shininess
    ctypes.c_int,                                    # shade
    _FLOAT_P,                                        # out_color
    _FLOAT_P,                                        # out_depth
]

_LIB: Optional[ctypes.CDLL] = None


def _compiler(source: Path) -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (set CXX or put g++ on PATH) to build "
                           f"{source}")
    return cxx


def build_host_library(source: Path, stem: str, flags, build_dir: Path) -> Path:
    """Compile ``source`` into ``build_dir/<stem>-<hash>.so`` if it is missing,
    the hash covering the source and ``flags``; raises on failure. Concurrent
    builds each write a temporary file and move it in place."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    out = build_dir / f"{stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(source), *flags, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {source.name} failed:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def build() -> Path:
    """Compile the rasterizer if its library is missing; raises on failure."""
    return build_host_library(SOURCE, "librasterizer", CXX_FLAGS, BUILD_DIR)


def load_library() -> ctypes.CDLL:
    """The ctypes handle of the rasterizer, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.rasterize.restype = None
        lib.rasterize.argtypes = _ARGTYPES
        _LIB = lib
    return _LIB


def _fptr(arr: Optional[np.ndarray]):
    if arr is None:
        return ctypes.cast(None, _FLOAT_P)
    return arr.ctypes.data_as(_FLOAT_P)


def _f32(arr) -> Optional[np.ndarray]:
    return None if arr is None else np.ascontiguousarray(arr, dtype=np.float32)


def _check_shapes(vertices, faces, vertex_colors, vertex_normals, uvs, texture,
                  light_pos, light_color, light_intensity) -> None:
    """Raise before the compiled rasterizer reads past a buffer."""
    n = len(vertices)
    if vertices.shape != (n, 3) or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"vertices {vertices.shape} must be (V, 3), faces {faces.shape} (F, 3)")
    if len(faces) and (faces.min() < 0 or faces.max() >= n):
        raise ValueError(f"face indices must lie in [0, {n})")
    for name, arr, width in (("vertex_colors", vertex_colors, 3),
                             ("vertex_normals", vertex_normals, 3), ("uvs", uvs, 2)):
        if arr is not None and arr.shape != (n, width):
            raise ValueError(f"{name} {arr.shape} must be ({n}, {width})")
    if texture is not None and (texture.ndim != 3 or texture.shape[2] != 3):
        raise ValueError(f"texture {texture.shape} must be (H, W, 3)")
    if light_pos is not None:
        k = len(light_pos)
        if (light_pos.shape != (k, 3) or light_color.shape != (k, 3)
                or light_intensity.shape != (k,)):
            raise ValueError("light_pos and light_color must be (L, 3), light_intensity (L,)")


def rasterize(vertices: np.ndarray, faces: np.ndarray,
              extrinsic: np.ndarray, intrinsic: np.ndarray,
              width: int, height: int,
              vertex_colors: Optional[np.ndarray] = None,
              vertex_normals: Optional[np.ndarray] = None,
              uvs: Optional[np.ndarray] = None,
              texture: Optional[np.ndarray] = None,
              uv_scale: float = 1.0,
              light_pos: Optional[np.ndarray] = None,
              light_color: Optional[np.ndarray] = None,
              light_intensity: Optional[np.ndarray] = None,
              ambient: float = 0.1,
              specular: float = 0.0,
              shininess: float = 32.0,
              shade: bool = True,
              plain: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render a mesh. Returns (color (H, W, 3) float in [0, 1], depth (H, W),
    mask (H, W) = depth > 0).

    ``uvs`` (V, 2) + ``texture`` (Th, Tw, 3 float in [0, 1]) give UV-mapped
    albedo with wrap addressing and ``uv_scale`` tiling; ``specular`` and
    ``shininess`` add a Blinn-Phong lobe. ``plain`` renders with the numpy
    twin instead of the compiled rasterizer."""
    vertices = _f32(vertices)
    faces = np.ascontiguousarray(faces, dtype=np.int32)
    extrinsic = np.ascontiguousarray(extrinsic, dtype=np.float32).reshape(4, 4)
    intrinsic = np.ascontiguousarray(np.asarray(intrinsic, dtype=np.float32)[:3, :3])
    vertex_colors, vertex_normals, uvs = map(_f32, (vertex_colors, vertex_normals, uvs))
    tex_w = tex_h = 0
    if texture is not None:
        texture = _f32(texture)
        tex_h, tex_w = texture.shape[:2]
    n_lights = 0 if light_pos is None else len(light_pos)
    if n_lights:
        light_pos, light_color, light_intensity = map(
            _f32, (light_pos, light_color, light_intensity))
    else:
        light_pos = light_color = light_intensity = None
    _check_shapes(vertices, faces, vertex_colors, vertex_normals, uvs, texture,
                  light_pos, light_color, light_intensity)

    color = np.zeros((height, width, 3), dtype=np.float32)
    depth = np.zeros((height, width), dtype=np.float32)
    if plain:
        rasterize_plain(vertices, faces, extrinsic, intrinsic, width, height,
                        vertex_colors, vertex_normals, uvs, texture, uv_scale,
                        light_pos, light_color, light_intensity, ambient, specular,
                        shininess, shade, color, depth)
    else:
        load_library().rasterize(
            _fptr(vertices), len(vertices),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
            _fptr(vertex_colors), _fptr(vertex_normals),
            _fptr(uvs), _fptr(texture), tex_w, tex_h, float(uv_scale),
            _fptr(extrinsic), _fptr(intrinsic), width, height,
            _fptr(light_pos), _fptr(light_color), _fptr(light_intensity),
            n_lights, float(ambient), float(specular), float(shininess),
            int(shade), _fptr(color), _fptr(depth))
    mask = (depth > 0).astype(np.float32)
    return color, depth, mask


def agreement(color, depth, plain_color, plain_depth) -> dict:
    """How a render agrees with its plain twin's: the share of pixels both
    cover or both leave empty (``coverage``), the largest depth difference
    where both cover (``depth_err``) and the share of color values within
    1e-3 there (``color``). Boundary pixels may differ by tie-breaks and
    texel-boundary pixels by bilinear taps."""
    both = (depth > 0) & (plain_depth > 0)
    return {"coverage": float(((depth > 0) == (plain_depth > 0)).mean()),
            "depth_err": float(np.abs(depth[both] - plain_depth[both]).max(initial=0.0)),
            "color": float(np.isclose(color[both], plain_color[both], atol=1e-3).mean())
            if both.any() else 1.0}


# A render agrees with its plain twin when (tests/test_data.py's bounds):
AGREEMENT = {"coverage": 0.99, "depth_err": 1e-3, "color": 0.97}


def agrees(stats: dict) -> bool:
    return (stats["coverage"] > AGREEMENT["coverage"]
            and stats["depth_err"] <= AGREEMENT["depth_err"]
            and stats["color"] > AGREEMENT["color"])


def rasterize_plain(vertices, faces, extrinsic, intrinsic, width, height,
                    vertex_colors, vertex_normals, uvs, texture, uv_scale,
                    light_pos, light_color, light_intensity, ambient,
                    specular, shininess, shade, color, depth):
    """The numpy rasterizer, triangle by triangle, into ``color`` and
    ``depth`` (slow; the compiled rasterizer's plain twin)."""
    cam_center = -extrinsic[:3, :3].T @ extrinsic[:3, 3]
    cam = vertices @ extrinsic[:3, :3].T + extrinsic[:3, 3]
    z = np.maximum(cam[:, 2], 1e-6)
    px = np.stack([intrinsic[0, 0] * cam[:, 0] / z + intrinsic[0, 2],
                   intrinsic[1, 1] * cam[:, 1] / z + intrinsic[1, 2]], axis=1)
    depth[:] = 0
    zbuf = np.full((height, width), np.inf, dtype=np.float32)
    if vertex_normals is None:
        from ..meshutils import compute_vertex_normals

        vertex_normals = compute_vertex_normals(vertices, faces)
    for tri in faces:
        zs = cam[tri, 2]
        if (zs <= 1e-4).any():
            continue
        pts = px[tri]
        xmin = max(0, int(np.floor(pts[:, 0].min())))
        xmax = min(width - 1, int(np.ceil(pts[:, 0].max())))
        ymin = max(0, int(np.floor(pts[:, 1].min())))
        ymax = min(height - 1, int(np.ceil(pts[:, 1].max())))
        if xmin > xmax or ymin > ymax:
            continue
        (x0, y0), (x1, y1), (x2, y2) = pts
        denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(denom) < 1e-12:
            continue
        ys, xs = np.mgrid[ymin:ymax + 1, xmin:xmax + 1]
        w0 = ((y1 - y2) * (xs - x2) + (x2 - x1) * (ys - y2)) / denom
        w1 = ((y2 - y0) * (xs - x2) + (x0 - x2) * (ys - y2)) / denom
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        izs = 1.0 / zs
        izp = w0 * izs[0] + w1 * izs[1] + w2 * izs[2]
        zp = 1.0 / np.maximum(izp, 1e-12)
        closer = inside & (zp < zbuf[ymin:ymax + 1, xmin:xmax + 1])
        if not closer.any():
            continue
        b = np.stack([w0 * izs[0], w1 * izs[1], w2 * izs[2]]) * zp[None]
        if uvs is not None and texture is not None:
            th, tw = texture.shape[:2]
            uvp = np.einsum("kij,kc->ijc", b, uvs[tri]) * uv_scale
            uvp -= np.floor(uvp)
            tu = uvp[..., 0] * tw - 0.5
            tv = (1.0 - uvp[..., 1]) * th - 0.5
            u0 = np.floor(tu).astype(int)
            v0 = np.floor(tv).astype(int)
            wu = (tu - u0)[..., None]
            wv = (tv - v0)[..., None]
            u1, v1 = (u0 + 1) % tw, (v0 + 1) % th
            u0, v0 = u0 % tw, v0 % th
            alb = ((1 - wv) * ((1 - wu) * texture[v0, u0] + wu * texture[v0, u1])
                   + wv * ((1 - wu) * texture[v1, u0] + wu * texture[v1, u1])
                   ).astype(np.float32)
            if vertex_colors is not None:
                alb = alb * np.einsum("kij,kc->ijc", b, vertex_colors[tri])
        elif vertex_colors is not None:
            alb = np.einsum("kij,kc->ijc", b, vertex_colors[tri])
        else:
            alb = np.full((*zp.shape, 3), 0.8, dtype=np.float32)
        if shade:
            p = np.einsum("kij,kc->ijc", b, vertices[tri])
            n = np.einsum("kij,kc->ijc", b, vertex_normals[tri])
            n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
            sh = np.full(zp.shape + (3,), ambient, dtype=np.float32)
            spec = np.zeros(zp.shape + (3,), dtype=np.float32)
            if light_pos is not None:
                vdir = cam_center[None, None] - p
                vdir = vdir / (np.linalg.norm(vdir, axis=-1, keepdims=True) + 1e-12)
                for lp, lc, li in zip(light_pos, light_color, light_intensity):
                    ldir = lp[None, None] - p
                    d2 = (ldir ** 2).sum(-1, keepdims=True) + 1e-9
                    ldir = ldir / np.sqrt(d2)
                    lam = np.abs((n * ldir).sum(-1, keepdims=True))
                    sh += lam * (li / d2) * lc[None, None]
                    if specular > 0:
                        hv = ldir + vdir
                        hv = hv / (np.linalg.norm(hv, axis=-1, keepdims=True) + 1e-12)
                        nh = np.abs((n * hv).sum(-1, keepdims=True))
                        spec += specular * nh ** shininess * (li / d2) * lc[None, None]
            alb = np.minimum(1.0, alb * sh + spec)
        region = (slice(ymin, ymax + 1), slice(xmin, xmax + 1))
        zbuf[region] = np.where(closer, zp, zbuf[region])
        depth[region] = np.where(closer, zp, depth[region])
        color[region] = np.where(closer[..., None], alb, color[region])
