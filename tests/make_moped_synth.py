"""Write the synthetic MOPED capture ``tests/data/moped_synth/``: a
reference and an evaluation capture of the encoder-distill ellipsoid (axes
0.21, 0.36, 0.5 in object units, 10 object units a metre) in
``RealsenseDataset``'s layout, rendered by the JAX package's ellipsoid
oracle at 1600x1200 (f 3075) and written with imageio. The dataset scales
the frames by 0.2 (``image_scale``'s default, which the tracking tool
keeps), giving 320x240 frames at f 615: the focal the encoder-distill
checkpoint was trained at (the zoom keeps a camera's focal, so a
checkpoint only sees an object at the size it learned at its own focal).

    python tests/make_moped_synth.py [OUT_DIR]

Each capture has ``intrinsics.json`` (Open3D's, column-major),
``color/*.jpg`` (shaded), ``depth/*.png`` (uint16 millimetres),
``mask/*.png``, ``scene/trajectory.log`` (Open3D's camera-to-world
poses), ``scene/integrated_cropped.ply`` and
``registration/registration.json`` (the object frame from the capture's
world frame; each capture has its own). The integrated cloud is the
ellipsoid's surface cropped at |z| = h so that its bounds' diagonal is 1.2
object units (the dataset's automatic scale then gives 10 units a metre),
centred at OBJECT_CENTER in metres, and m = OUTLIERS points planted far
from it, 10m + 1 in all, which the dataset's outlier filter removes
(contamination 0.1 of 10m + 1 points: the m most isolated). The reference capture's 16 views
look from random directions; the evaluation capture's 8 frames follow a
smooth arc. All draws come from ``numpy.random.default_rng(SEED)``.
"""
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "tests" / "data" / "moped_synth"
SEED = 20261018
AXES = (0.21, 0.36, 0.5)
UNITS_PER_METRE = 10.0
OBJECT_CENTER = (0.01, -0.02, 0.005)  # metres, in the object frame
CROP_Z = float(np.sqrt((1.2 ** 2 - (2 * AXES[0]) ** 2 - (2 * AXES[1]) ** 2) / 4))
WIDTH, HEIGHT, FOCAL = 1600, 1200, 3075.0
CAMERA_DIST = 5.78  # object units (zoo.DEMO_CAMERA_DIST)
REFERENCE_VIEWS, EVAL_FRAMES = 16, 8
SURFACE_POINTS, RING_POINTS, OUTLIERS = 1701, 96, 200  # 10 * 200 + 1 in all


def _quat_to_mat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _axis_angle(axis, angle):
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def _rigid(rot, trans):
    out = np.eye(4)
    out[:3, :3], out[:3, 3] = rot, trans
    return out


def object_points(rng) -> np.ndarray:
    """The cropped surface (object units, centred), its bounds' extremes,
    and the planted outliers: (10 * OUTLIERS + 1, 3)."""
    i = np.arange(SURFACE_POINTS * 2) + 0.5
    phi, theta = np.arccos(1 - 2 * i / len(i)), np.pi * (1 + 5 ** 0.5) * i
    sphere = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], 1)
    surface = sphere * AXES
    surface = surface[np.abs(surface[:, 2]) < CROP_Z]
    surface = surface[np.linspace(0, len(surface) - 1, SURFACE_POINTS).round().astype(int)]
    ring_scale = np.sqrt(1 - (CROP_Z / AXES[2]) ** 2)
    a = np.linspace(0, 2 * np.pi, RING_POINTS // 2, endpoint=False)
    ring = np.stack([AXES[0] * ring_scale * np.cos(a), AXES[1] * ring_scale * np.sin(a),
                     np.full_like(a, CROP_Z)], 1)
    extremes = np.array([[AXES[0], 0, 0], [-AXES[0], 0, 0], [0, AXES[1], 0], [0, -AXES[1], 0]])
    kept = np.concatenate([surface, ring, ring * (1, 1, -1), extremes])
    assert len(kept) == 9 * OUTLIERS + 1
    direction = rng.normal(size=(OUTLIERS, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    outliers = direction * rng.uniform(2.0, 3.0, (OUTLIERS, 1))
    return np.concatenate([kept, outliers])


def reference_cameras(rng, n):
    """Normalised (object units, centred) extrinsics from random directions."""
    out = []
    for _ in range(n):
        rot = _quat_to_mat(rng.normal(size=4))
        t = np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.1, 0.1),
                      CAMERA_DIST + rng.uniform(-0.3, 0.3)])
        out.append(_rigid(rot, t))
    return out


def arc_cameras(rng, n):
    """A smooth arc, as consecutive frames of a hand-held video: 2 degrees
    a frame about a random axis, the translation drifting by up to 0.005
    units (0.5 mm) a frame."""
    rot = _quat_to_mat(rng.normal(size=4))
    axis = rng.normal(size=3)
    t = np.array([0.05, -0.03, CAMERA_DIST])
    out = []
    for _ in range(n):
        out.append(_rigid(rot, t))
        rot = _axis_angle(axis, np.deg2rad(2.0)) @ rot
        t = t + rng.uniform(-0.005, 0.005, 3)
    return out


def physical_extrinsic(e_norm):
    """A normalised extrinsic as the capture's object frame (metres, the
    object centred at OBJECT_CENTER) sees it."""
    rot = e_norm[:3, :3]
    position = -rot.T @ e_norm[:3, 3] / UNITS_PER_METRE + np.asarray(OBJECT_CENTER)
    return _rigid(rot, -rot @ position)


def write_capture(path: Path, e_norms, points_obj, registration, rng) -> None:
    import imageio.v2 as imageio
    import jax

    from latentfusion_tpu import testing
    from latentfusion_tpu.camera import Camera

    for d in ("color", "depth", "mask", "scene", "registration"):
        (path / d).mkdir(parents=True, exist_ok=True)
    k = np.array([[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]])
    (path / "intrinsics.json").write_text(json.dumps(
        {"width": WIDTH, "height": HEIGHT, "intrinsic_matrix": k.T.reshape(-1).tolist()}))
    (path / "registration" / "registration.json").write_text(
        json.dumps({"transform": registration.tolist()}))
    world_points = (np.linalg.inv(registration)[:3, :3] @ points_obj.T).T + np.linalg.inv(
        registration)[:3, 3]
    header = ["ply", "format ascii 1.0", f"element vertex {len(world_points)}",
              "property float x", "property float y", "property float z", "end_header"]
    (path / "scene" / "integrated_cropped.ply").write_text("\n".join(
        header + [f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}" for p in world_points]) + "\n")

    oracle = testing.EllipsoidOracleModel(input_size=128, camera_dist=5.78, axes=AXES)
    render = jax.jit(lambda c: oracle.make_observation(c, shaded=True))
    log = []
    for i, e_norm in enumerate(e_norms):
        cam = Camera(k[None].astype(np.float32), e_norm[None].astype(np.float32),
                     width=WIDTH, height=HEIGHT)
        obs = render(cam)
        color = np.asarray(obs.color[0]).transpose(1, 2, 0)
        mask = np.asarray(obs.mask[0, 0]) > 0.5
        depth_mm = np.asarray(obs.depth[0, 0]) / UNITS_PER_METRE * 1000.0 * mask
        imageio.imwrite(path / "color" / f"{i:06d}.jpg",
                        np.round(np.clip(color, 0, 1) * 255).astype(np.uint8))
        imageio.imwrite(path / "depth" / f"{i:06d}.png", np.round(depth_mm).astype(np.uint16))
        imageio.imwrite(path / "mask" / f"{i:06d}.png", mask.astype(np.uint8) * 255)
        cam_to_world = np.linalg.inv(physical_extrinsic(e_norm) @ registration)
        log.append(f"{i} {i} {i + 1}")
        log.extend(" ".join(f"{v:.9f}" for v in row) for row in cam_to_world)
    (path / "scene" / "trajectory.log").write_text("\n".join(log) + "\n")


def write_all(out: Path = OUT) -> dict:
    """Write both captures under ``out``; returns their normalised
    extrinsics by capture."""
    rng = np.random.default_rng(SEED)
    points = object_points(rng) / UNITS_PER_METRE + np.asarray(OBJECT_CENTER)
    cameras = {"reference": reference_cameras(rng, REFERENCE_VIEWS),
               "evaluation": arc_cameras(rng, EVAL_FRAMES)}
    for i, (name, e_norms) in enumerate(cameras.items()):
        registration = _rigid(_axis_angle(np.array([0.2, -0.3, 1.0]), 0.5 + i),
                              np.array([0.1, 0.05 * (1 - 2 * i), -0.02]))
        write_capture(out / name, e_norms, points, registration, rng)
    return cameras


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_all(Path(sys.argv[1]) if len(sys.argv) > 1 else OUT)
