"""The port's meshes, rasterizer and renderer (``latentfusion_tpu_torch/
meshutils.py``, ``data/rasterizer.py``, ``data/rendering.py``) and
``testing.lobe_shape_meshes`` held against the JAX package on the CPU.

The port compiles ``native/rasterizer.cpp`` with the JAX package's flags and
the two libraries give the same bits on one machine: renders are compared
bit for bit (blob and lobe meshes, UV textures, point lights, specular).
Against the numpy rasterizer, its plain twin, a render agrees where
``rasterizer.agrees`` says (tests/test_data.py's bounds: coverage on more
than 99 % of the pixels, depth within 1e-3 where both cover, color within
1e-3 on more than 97 % of those). Mesh loaders, ``Object3D`` and the lobe
meshes' OBJ text are held exactly.
"""
import filecmp
import random
import struct

import numpy as np
import pytest
import torch

from latentfusion_tpu import meshutils as jmesh
from latentfusion_tpu import testing as jtesting
from latentfusion_tpu.data import rasterizer as jras
from latentfusion_tpu.data import rendering as jrender
from latentfusion_tpu.data import synthetic as jsynth

from latentfusion_tpu_torch import meshutils as tmesh
from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch.data import rasterizer as tras
from latentfusion_tpu_torch.data import rendering as trender

K = np.asarray([[150.0, 0, 80.0], [0, 150.0, 60.0], [0, 0, 1.0]], np.float32)
WIDTH, HEIGHT = 160, 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Two procedural blobs and two lobe objects of the held-out pool
    (coarse UV spheres), as OBJ files."""
    root = tmp_path_factory.mktemp("meshes")
    blobs = jsynth.make_procedural_blobs(root / "blobs", n_objs=2, n_verts=300)
    pool, _ = ttesting.sample_lobe_shapes(7919, 2, device="cpu")
    lobes = ttesting.lobe_shape_meshes(pool, root / "lobes", lat=12, lon=24)
    return {"blob": blobs, "lobe": lobes}


def cube_files(tmp_path):
    s = 0.25
    verts = [(-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s),
             (-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]
    quads = [(1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8)]
    obj = tmp_path / "cube.obj"
    with open(obj, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        f.write("vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n")
        for q in quads:
            # negative (relative) indices on the last face
            f.write("f " + " ".join(f"{i}/{k + 1}" for k, i in enumerate(q)) + "\n")
        f.write("f -8/-4 -7/-3 -6/-2\n")
    off = tmp_path / "cube.off"
    with open(off, "w") as f:
        f.write(f"OFF\n{len(verts)} {len(quads)} 0\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for q in quads:
            f.write("4 " + " ".join(str(i - 1) for i in q) + "\n")
    ascii_ply = tmp_path / "cube_ascii.ply"
    with open(ascii_ply, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 8\nproperty float x\n"
                "property float y\nproperty float z\nproperty uchar red\n"
                "property uchar green\nproperty uchar blue\nelement face 6\n"
                "property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            f.write(f"{v[0]} {v[1]} {v[2]} {i * 30} 20 {255 - i}\n")
        for q in quads:
            f.write("4 " + " ".join(str(i - 1) for i in q) + "\n")
    binary_ply = tmp_path / "cube_binary.ply"
    with open(binary_ply, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 8\n"
                b"property float x\nproperty float y\nproperty float z\n"
                b"element face 6\nproperty list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(struct.pack("<fff", *v))
        for q in quads:
            f.write(struct.pack("<B4i", 4, *(i - 1 for i in q)))
    return obj, off, ascii_ply, binary_ply


def assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# ------------------------------------------------------------------ meshes
def test_mesh_loaders_match_jax(tmp_path):
    for path in cube_files(tmp_path):
        assert_same(tmesh.load_mesh(path), jmesh.load_mesh(path))
    with pytest.raises(ValueError):
        tmesh.load_mesh(tmp_path / "cube.stl")


def test_object3d_matches_jax(tmp_path, meshes):
    for path in [cube_files(tmp_path)[0], *meshes["blob"], *meshes["lobe"]]:
        jo, to = jmesh.Object3D(path), tmesh.Object3D(path)
        for name in ("bounds", "extents", "centroid", "bounding_size", "bounding_diameter"):
            np.testing.assert_array_equal(getattr(to, name), getattr(jo, name), err_msg=name)
        np.testing.assert_array_equal(to.meshes[0].vertex_normals, jo.meshes[0].vertex_normals)
        assert to.are_normals_corrupt() == jo.are_normals_corrupt()
        jo.recenter("mean").resize(0.7).rescale(1.5)
        to.recenter("mean").resize(0.7).rescale(1.5)
        np.testing.assert_array_equal(to.vertices, jo.vertices)


def test_lobe_shape_meshes_match_jax_byte_for_byte(tmp_path):
    jpool, _ = jtesting.sample_lobe_shapes(7919, 3)
    tpool, _ = ttesting.sample_lobe_shapes(7919, 3, device="cpu")
    for lat, lon in ((8, 16), (12, 24)):
        a = jtesting.lobe_shape_meshes(jpool, tmp_path / f"j{lat}", lat=lat, lon=lon)
        b = ttesting.lobe_shape_meshes(tpool, tmp_path / f"t{lat}", lat=lat, lon=lon)
        assert [p.name for p in a] == [p.name for p in b]
        assert all(filecmp.cmp(x, y, shallow=False) for x, y in zip(a, b))
    for x, y in zip(jtesting._uv_sphere(6, 12), ttesting._uv_sphere(6, 12)):
        np.testing.assert_array_equal(x, y)


# -------------------------------------------------------------- rasterizer
def scene_pair(path, seed, textured, specular):
    """The same scene in both packages: the mesh at a random pose, random
    lights (shared ``random`` / ``np.random`` draws) and material."""
    rng = np.random.RandomState(seed)
    jo, _ = jrender.load_object(path)
    to, _ = trender.load_object(path)
    contexts = (jrender.SceneContext(jo, K), trender.SceneContext(to, K))
    tex = rng.rand(16, 24, 3).astype(np.float32)
    albedo = rng.rand(1, 3).astype(np.float32)
    q = rng.randn(4).astype(np.float32)
    t = np.asarray([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), 2.5], np.float32)
    for obj, ctx in zip((jo, to), contexts):
        random.seed(seed)
        np.random.seed(seed)
        ctx.randomize_lights(2, 5)
        ctx.specular, ctx.roughness = specular, 0.3
        ctx.set_pose(t, q)
        for m in obj.meshes:
            if textured:
                m.texture, m.uv_scale = tex, 2.5
            else:
                m.vertex_colors = np.tile(albedo, (len(m.vertices), 1))
    return contexts


@pytest.mark.parametrize("kind", ["blob", "lobe"])
def test_rasterizer_matches_jax_bit_for_bit(meshes, kind):
    for i, path in enumerate(meshes[kind]):
        for textured, specular in ((kind == "lobe", 0.0), (kind == "lobe", 0.4)):
            jctx, tctx = scene_pair(path, i, textured, specular)
            a = jrender.Renderer(WIDTH, HEIGHT).render(jctx)
            b = trender.Renderer(WIDTH, HEIGHT).render(tctx)
            assert b[2].sum() > 500
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            assert tctx.shininess == jctx.shininess
            for x, y in zip(jctx.lights, tctx.lights):
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("kind", ["blob", "lobe"])
def test_rasterizer_agrees_with_its_numpy_twin(meshes, kind):
    path = meshes[kind][0]
    _, tctx = scene_pair(path, 3, kind == "lobe", 0.4)
    color, depth, mask = trender.Renderer(WIDTH, HEIGHT).render(tctx)
    pc, pd, pm = trender.Renderer(WIDTH, HEIGHT, plain=True).render(tctx)
    stats = tras.agreement(color, depth, pc, pd)
    assert tras.agrees(stats), stats
    # The port's twin is the JAX package's numpy rasterizer.
    jc = np.zeros_like(pc)
    jd = np.zeros_like(pd)
    geom = tctx.merged_geometry()
    lights = tctx.lights
    jras._rasterize_numpy(geom[0], geom[1], tctx.extrinsic, tctx.intrinsic, WIDTH, HEIGHT,
                          geom[2], geom[3], geom[4], geom[5], geom[6],
                          np.stack([l[0] for l in lights]), np.stack([l[1] for l in lights]),
                          np.asarray([l[2] for l in lights], np.float32),
                          tctx.ambient, tctx.specular, tctx.shininess, True, jc, jd)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pd, jd)


def test_unlit_untextured_render_matches_jax(meshes):
    """No lights and no material (the evaluation's clean render): ambient
    0.1 times the default albedo 0.8 on every covered pixel."""
    path = meshes["lobe"][1]
    jo, _ = jrender.load_object(path, recenter=False, resize=False)
    to, _ = trender.load_object(path, recenter=False, resize=False)
    jctx, tctx = jrender.SceneContext(jo, K), trender.SceneContext(to, K)
    for ctx in (jctx, tctx):
        ctx.set_pose([0.0, 0.0, 2.0], [0.7, 0.1, -0.2, 0.3])
    a = jrender.Renderer(WIDTH, HEIGHT).render(jctx)
    b = trender.Renderer(WIDTH, HEIGHT).render(tctx)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(b[0][b[2] > 0], 0.08, atol=1e-6)


# ------------------------------------------------------------------- scene
def test_scene_context_matches_jax(meshes):
    path = meshes["blob"][1]
    jo, js = jrender.load_object(path, size=0.8, bound_type="extents", scale=1.2)
    to, ts = trender.load_object(path, size=0.8, bound_type="extents", scale=1.2)
    assert ts == js
    np.testing.assert_array_equal(to.vertices, jo.vertices)
    with pytest.raises(ValueError):
        trender.load_object(path, bound_type="volume")
    assert trender.get_zbound(2.0, 1.0) == jrender.get_zbound(2.0, 1.0)
    jctx, tctx = jrender.SceneContext(jo, K), trender.SceneContext(to, K)
    q = np.asarray([0.3, -0.5, 0.2, 0.7], np.float32)
    for frame in ("default", "realsense"):
        jctx.set_pose([0.1, 0.2, 2.0], q, frame=frame)
        tctx.set_pose([0.1, 0.2, 2.0], q, frame=frame)
        np.testing.assert_array_equal(tctx.extrinsic, jctx.extrinsic)
        jctx.set_pose_from_extrinsic(jctx.extrinsic, frame=frame)
        tctx.set_pose_from_extrinsic(tctx.extrinsic, frame=frame)
        np.testing.assert_array_equal(tctx.extrinsic, jctx.extrinsic)
    np.testing.assert_allclose(tctx.object_quaternion.numpy(),
                               np.asarray(jctx.object_quaternion), atol=1e-6)
    np.testing.assert_array_equal(tctx.object_translation.numpy(),
                                  np.asarray(jctx.object_translation))
    for r in (0.01, 0.3, 1.0):
        jctx.roughness = tctx.roughness = r
        assert tctx.shininess == jctx.shininess
    tctx.set_intrinsic(np.eye(3) * 2)
    assert tctx.intrinsic.dtype == np.float32 and tctx.intrinsic[0, 0] == 2
    assert trender._canon_quat_realsense().dtype == np.float32
    np.testing.assert_allclose(trender._canon_quat_realsense(),
                               jrender._canon_quat_realsense(), atol=1e-7)


def test_rasterizer_refuses_malformed_buffers():
    v = np.zeros((3, 3), np.float32)
    f = np.asarray([[0, 1, 2]], np.int32)
    args = (np.eye(4), K, 8, 6)
    for bad in (dict(faces=np.asarray([[0, 1, 3]], np.int32)), dict(vertices=np.zeros((3, 2))),
                dict(uvs=np.zeros((2, 2))), dict(vertex_colors=np.zeros((3, 4))),
                dict(texture=np.zeros((4, 4))),
                dict(light_pos=np.zeros((2, 3)), light_color=np.zeros((1, 3)),
                     light_intensity=np.zeros(2))):
        kwargs = {"vertices": v, "faces": f, **bad}
        with pytest.raises(ValueError):
            tras.rasterize(kwargs.pop("vertices"), kwargs.pop("faces"), *args, **kwargs)
