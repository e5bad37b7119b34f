"""Mesh utilities (counterpart of ``latentfusion_tpu/meshutils.py``).

Numpy only: minimal OBJ, PLY and OFF loaders (no trimesh) behind the same
``Object3D`` surface: recenter, rescale, resize, bounds, diameters and
vertex normals.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional

import numpy as np

EPS = 10e-10


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    normals = np.ones_like(vertices)
    triangles = vertices[faces]
    tri_normals = np.cross(triangles[:, 1] - triangles[:, 0],
                           triangles[:, 2] - triangles[:, 0])
    tri_normals /= (np.linalg.norm(tri_normals, axis=1)[:, None] + EPS)
    np.add.at(normals, faces[:, 0], tri_normals)
    np.add.at(normals, faces[:, 1], tri_normals)
    np.add.at(normals, faces[:, 2], tri_normals)
    normals /= (np.linalg.norm(normals, axis=1)[:, None] + EPS)
    return normals


# ------------------------------------------------------------------ loaders

def load_obj(path) -> dict:
    """Minimal Wavefront OBJ loader (v / vt / f; polygon faces are
    fan-triangulated). When the file has texture coordinates, vertices are
    split per distinct (v, vt) corner pair so UVs are per-vertex (the
    layout the rasterizer consumes); the vertex buffer is therefore
    reindexed in corner-first order and unreferenced vertices are dropped.
    Lines are processed in file order, so negative (relative) face indices
    resolve against the element counts at the face's position, per the OBJ
    spec."""
    vertices, uvs, faces = [], [], []
    corner_map = {}
    out_vertices, out_uvs = [], []

    def corner(tok):
        parts = tok.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(vertices) + vi
        ti = None
        if len(parts) > 1 and parts[1]:
            ti = int(parts[1])
            ti = ti - 1 if ti > 0 else len(uvs) + ti
        key = (vi, ti)
        if key not in corner_map:
            corner_map[key] = len(out_vertices)
            out_vertices.append(vertices[vi])
            out_uvs.append(uvs[ti] if ti is not None else (0.0, 0.0))
        return corner_map[key]

    has_uvs = False
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(x) for x in parts[1:4]])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append((float(parts[1]),
                            float(parts[2]) if len(parts) > 2 else 0.0))
                has_uvs = True
            elif line.startswith("f "):
                idx = [corner(tok) for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])

    out = {
        "vertices": np.asarray(out_vertices, dtype=np.float32).reshape(-1, 3),
        "faces": np.asarray(faces, dtype=np.int32).reshape(-1, 3),
    }
    if has_uvs:
        out["uvs"] = np.asarray(out_uvs, dtype=np.float32).reshape(-1, 2)
    return out


def load_off(path) -> dict:
    with open(path, "r") as f:
        header = f.readline().strip()
        if header != "OFF":
            # OFF123 456 789 single-line variant
            counts = header[3:].split()
        else:
            counts = f.readline().split()
        nv, nf = int(counts[0]), int(counts[1])
        vertices = np.asarray(
            [[float(x) for x in f.readline().split()[:3]] for _ in range(nv)],
            dtype=np.float32)
        faces = []
        for _ in range(nf):
            parts = f.readline().split()
            n = int(parts[0])
            idx = [int(x) for x in parts[1:1 + n]]
            for k in range(1, n - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
    return {"vertices": vertices,
            "faces": np.asarray(faces, dtype=np.int32).reshape(-1, 3)}


def load_ply(path) -> dict:
    """Minimal PLY loader (ascii + binary_little_endian; xyz [+rgb] vertices,
    triangle/polygon faces)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements = []  # (name, count, [(type, name)])
        while True:
            line = f.readline().strip().decode()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append([name, int(count), []])
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append((parts[1], parts[2]))
            elif line == "end_header":
                break

        type_map = {"float": ("f", 4), "float32": ("f", 4),
                    "double": ("d", 8), "float64": ("d", 8),
                    "uchar": ("B", 1), "uint8": ("B", 1),
                    "char": ("b", 1), "int8": ("b", 1),
                    "short": ("h", 2), "ushort": ("H", 2),
                    "int": ("i", 4), "int32": ("i", 4),
                    "uint": ("I", 4), "uint32": ("I", 4)}

        data = {}
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    keys = [p[1] for p in props]
                    arr = np.asarray(rows, dtype=np.float32)
                    data["vertex"] = {k: arr[:, i] for i, k in enumerate(keys)}
                elif name == "face":
                    faces = []
                    for row in rows:
                        n = int(row[0])
                        idx = [int(x) for x in row[1:1 + n]]
                        for k in range(1, n - 1):
                            faces.append([idx[0], idx[k], idx[k + 1]])
                    data["face"] = np.asarray(faces, dtype=np.int32)
            else:  # binary_little_endian
                if name == "vertex":
                    fmt_str = "<" + "".join(type_map[p[0]][0] for p in props)
                    size = struct.calcsize(fmt_str)
                    raw = f.read(size * count)
                    arr = np.asarray(
                        [struct.unpack_from(fmt_str, raw, i * size)
                         for i in range(count)], dtype=np.float32)
                    keys = [p[1] for p in props]
                    data["vertex"] = {k: arr[:, i] for i, k in enumerate(keys)}
                elif name == "face":
                    faces = []
                    for _ in range(count):
                        (n,) = struct.unpack(
                            "<" + type_map[props[0][1]][0],
                            f.read(type_map[props[0][1]][1]))
                        idx_fmt = "<" + type_map[props[0][2]][0] * n
                        idx = struct.unpack(
                            idx_fmt, f.read(type_map[props[0][2]][1] * n))
                        for k in range(1, n - 1):
                            faces.append([idx[0], idx[k], idx[k + 1]])
                    data["face"] = np.asarray(faces, dtype=np.int32)

    vert = data["vertex"]
    vertices = np.stack([vert["x"], vert["y"], vert["z"]], axis=1)
    out = {"vertices": vertices.astype(np.float32),
           "faces": data.get("face", np.zeros((0, 3), np.int32))}
    if "red" in vert:
        out["vertex_colors"] = np.stack(
            [vert["red"], vert["green"], vert["blue"]], axis=1) / 255.0
    return out


def load_mesh(path) -> dict:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".obj":
        return load_obj(path)
    elif suffix == ".ply":
        return load_ply(path)
    elif suffix == ".off":
        return load_off(path)
    raise ValueError(f"Unsupported mesh format {suffix!r}")


class Mesh:
    """A single mesh part (stand-in for trimesh.Trimesh)."""

    def __init__(self, vertices, faces, vertex_colors=None,
                 vertex_normals=None, uvs=None):
        self.vertices = np.asarray(vertices, dtype=np.float32)
        self.faces = np.asarray(faces, dtype=np.int32)
        self.vertex_colors = vertex_colors
        self._vertex_normals = vertex_normals
        # Per-vertex texture coordinates (V, 2) or None; consumed by the
        # rasterizer's UV-mapped albedo path.
        self.uvs = uvs
        # Material attached by the synthesis pipeline: (texture (Th,Tw,3)
        # float [0,1], uv_scale) or None.
        self.texture = None
        self.uv_scale = 1.0

    @property
    def vertex_normals(self):
        if self._vertex_normals is None:
            self._vertex_normals = compute_vertex_normals(self.vertices,
                                                          self.faces)
        return self._vertex_normals

    def apply_scale(self, scale):
        self.vertices = self.vertices * scale

    def apply_translation(self, translation):
        self.vertices = self.vertices + np.asarray(translation,
                                                   dtype=np.float32)


class Object3D:
    """An object of one or more meshes."""

    def __init__(self, path=None, load_materials: bool = False,
                 meshes: Optional[List[Mesh]] = None):
        if meshes is not None:
            self.meshes = meshes
        else:
            d = load_mesh(path)
            self.meshes = [Mesh(d["vertices"], d["faces"],
                                vertex_colors=d.get("vertex_colors"),
                                uvs=d.get("uvs"))]
        self.path = path
        self.scale = 1.0

    def are_normals_corrupt(self) -> bool:
        for mesh in self.meshes:
            if (np.linalg.norm(mesh.vertex_normals, axis=1) == 0.0).sum() > 0:
                return True
        return False

    def recompute_normals(self):
        for mesh in self.meshes:
            mesh._vertex_normals = compute_vertex_normals(mesh.vertices,
                                                          mesh.faces)
        return self

    def rescale(self, scale=1.0):
        self.scale = scale
        for mesh in self.meshes:
            mesh.apply_scale(scale)
        return self

    def resize(self, size, ref="diameter"):
        ref_scale = (self.bounding_diameter if ref == "diameter"
                     else self.bounding_size)
        self.scale = size / ref_scale
        for mesh in self.meshes:
            mesh.apply_scale(self.scale)
        return self

    @property
    def vertices(self):
        return np.concatenate([mesh.vertices for mesh in self.meshes])

    @property
    def centroid(self):
        return self.bounds.mean(axis=0)

    @property
    def bounding_size(self):
        return max(self.extents)

    @property
    def bounding_diameter(self):
        centroid = self.bounds.mean(axis=0)
        max_radius = np.linalg.norm(self.vertices - centroid, axis=1).max()
        return max_radius * 2

    @property
    def bounding_radius(self):
        return self.bounding_diameter / 2.0

    @property
    def extents(self):
        return self.bounds[1] - self.bounds[0]

    @property
    def bounds(self):
        v = self.vertices
        return np.stack((v.min(axis=0), v.max(axis=0)), axis=0)

    def recenter(self, method="bounds"):
        if method == "mean":
            translation = -np.mean(self.vertices, 0)
        elif method == "bounds":
            translation = -self.bounds.mean(axis=0)
        else:
            raise ValueError(f"Unknown method {method!r}")
        for mesh in self.meshes:
            mesh.apply_translation(translation)
        return self
