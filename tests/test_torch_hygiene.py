"""The port stands alone: no file of ``latentfusion_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax or the JAX package, nor an image
library the GPU machine lacks (imageio, PIL, cv2), and no entry point runs
on the CPU unless asked to."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from latentfusion_tpu_torch import resolve_device, zoo
from latentfusion_tpu_torch.camera import Camera
from latentfusion_tpu_torch.observation import Observation
from latentfusion_tpu_torch.ops import fused_sample, lrelu_pnorm
from latentfusion_tpu_torch.recon.inference import LatentFusionModel

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "latentfusion_tpu", "imageio", "PIL", "cv2"}


def _port_files():
    pkg = ROOT / "latentfusion_tpu_torch"
    files = sorted(f for f in pkg.rglob("*.py")
                   if "_build" not in f.relative_to(pkg).parts)
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 20
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"latentfusion_tpu_torch/losses.py",
            "latentfusion_tpu_torch/train/step.py",
            "latentfusion_tpu_torch/unseen_eval.py",
            "latentfusion_tpu_torch/functional.py",
            "latentfusion_tpu_torch/modules/vgg.py",
            "latentfusion_tpu_torch/ibr.py",
            "latentfusion_tpu_torch/png.py",
            "latentfusion_tpu_torch/three/stats.py",
            "latentfusion_tpu_torch/three/utils.py",
            "latentfusion_tpu_torch/three/host.py",
            "latentfusion_tpu_torch/recon/fusion.py",
            "latentfusion_tpu_torch/modules/lstm.py",
            "latentfusion_tpu_torch/pggan/__init__.py",
            "latentfusion_tpu_torch/pggan/discriminator.py"} <= names
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _camera_args():
    K = np.array([[64.0, 0, 32], [0, 64.0, 24], [0, 0, 1]], np.float32)
    ext = np.eye(4, dtype=np.float32)
    ext[2, 3] = 1.5
    return K, ext


def test_entry_points_raise_without_gpu(no_gpu, tmp_path):
    K, ext = _camera_args()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        Camera(K, ext, width=64, height=48)
    with pytest.raises(RuntimeError):
        Observation.from_dict({"color": np.zeros((1, 3, 48, 64), np.float32),
                               "depth": np.zeros((1, 48, 64), np.float32),
                               "mask": np.zeros((1, 48, 64), np.float32),
                               "intrinsic": K, "extrinsic": ext})
    for name in ("tiny_sculptor", "tiny_fuser", "tiny_photographer",
                 "demo_sculptor", "flagship_fuser"):
        with pytest.raises(RuntimeError):
            getattr(zoo, name)()
    parts = [zoo.tiny_sculptor(device="cpu"), None, zoo.tiny_fuser(device="cpu"),
             None, zoo.tiny_photographer(device="cpu"), None]
    with pytest.raises(RuntimeError):
        LatentFusionModel(*parts, camera_dist=1.5)
    with pytest.raises(RuntimeError):
        LatentFusionModel.from_checkpoint(tmp_path / "unread.pth")
    from latentfusion_tpu_torch import serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--demo-tiny", "--stdio"])


def test_pose_entry_points_raise_without_gpu(no_gpu):
    from latentfusion_tpu_torch import testing

    for make in (testing.EllipsoidOracleModel, testing.make_camera,
                 lambda: zoo.canonical_camera(2),
                 lambda: zoo.random_view_cameras(2, torch.Generator())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    oracle = testing.EllipsoidOracleModel(device="cpu")
    assert oracle.device.type == "cpu"
    assert testing.make_camera(device="cpu").device.type == "cpu"
    assert len(zoo.random_view_cameras(3, torch.Generator(), device="cpu")) == 3


def test_entry_points_run_on_cpu_when_asked(no_gpu):
    K, ext = _camera_args()
    cam = Camera(K, ext, width=64, height=48, device="cpu")
    assert cam.device.type == "cpu"
    model = LatentFusionModel(zoo.tiny_sculptor(device="cpu"), None,
                              zoo.tiny_fuser(device="cpu"), None,
                              zoo.tiny_photographer(device="cpu"), None,
                              camera_dist=1.5, device="cpu")
    assert next(model.sculptor.parameters()).device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    vol = torch.zeros(1, 4, 2, 2, 2, device="meta")
    grid = torch.zeros(1, 2, 2, 2, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_sample.grid_sample_3d_fused(vol, grid)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_sample.grid_sample_3d_bwd_vol(grid, torch.zeros(1, 4, 2, 2, 2, device="meta"),
                                            vol.shape)
    with pytest.raises(ValueError, match="unsupported device"):
        lrelu_pnorm.lrelu_pixel_norm_fwd(torch.zeros(2, 4, 3, device="meta"), 0.2, 1e-8)


def test_unseen_object_entry_points_raise_without_gpu(no_gpu):
    from latentfusion_tpu_torch import testing, unseen_eval
    from latentfusion_tpu_torch.modules import vgg
    from latentfusion_tpu_torch.pose import utils as pose_utils

    pool, _ = testing.sample_lobe_shapes(0, 1, device="cpu")
    shape = testing.index_lobe_shape(pool, 0)
    for make in (lambda: testing.sample_lobe_shapes(0, 1),
                 lambda: testing.MultiLobeOracleModel(shape),
                 unseen_eval.load_cameras, zoo.mid_sculptor, zoo.mid_fuser,
                 zoo.mid_photographer, vgg.VGG16Features,
                 lambda: pose_utils.get_perceptual_loss(torch_state_dict={})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert testing.MultiLobeOracleModel(shape, device="cpu").device.type == "cpu"
    assert unseen_eval.load_cameras(2, 1, device="cpu")[0].device.type == "cpu"


def test_reconstruction_entry_points_raise_without_gpu(no_gpu, tmp_path):
    K, ext = _camera_args()
    cam = Camera(K, ext, width=64, height=48, device="cpu")
    obs = Observation(np.zeros((1, 3, 48, 64), np.float32), np.zeros((1, 1, 48, 64), np.float32),
                      np.zeros((1, 1, 48, 64), np.float32), cam)
    obs.save(tmp_path / "obs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Observation.load(tmp_path / "obs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Camera.from_kwargs(cam.to_kwargs())
    assert Observation.load(tmp_path / "obs", device="cpu").color.device.type == "cpu"


def test_model_option_entry_points_raise_without_gpu(no_gpu, tmp_path):
    """The fusers, a checkpoint with a non-GRU fuser, the discriminator and
    the GAN step's state go to the GPU unless asked for the CPU."""
    from latentfusion_tpu_torch.pggan import MultiScaleDiscriminator
    from latentfusion_tpu_torch.recon import checkpoint, fusion
    from latentfusion_tpu_torch.train import step

    for fuser_type in ("pool:max", "concat", "blend", "gru", "lstm"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fusion.get_fuser(fuser_type, 4, 1.0, block_config=((4, "D", 4), (4, "U", 4)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiScaleDiscriminator(5)
    sc, fu, ph = (zoo.tiny_sculptor(device="cpu"), zoo.tiny_fuser(device="cpu"),
                  zoo.tiny_photographer(device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        step.init_gan_train_state({"sculptor": sc, "fuser": fu, "photographer": ph},
                                  step.make_optimizer("adam"))
    payload = {"args": {"camera_dist": 1.5, "no_discriminator": False},
               "modules": {"sculptor": {"args": {"in_size": 16,
                                                 "image_config": [[4, "D", 8], [8]],
                                                 "camera_config": [4, 4],
                                                 "object_config": [4, 4],
                                                 "projection_type": "factor",
                                                 "input_depth": False, "input_mask": True},
                                        "state_dict": sc.state_dict()},
                           "fuser": {"type": "PoolFuser", "args": {"pool_type": "max"}},
                           "photographer": {"args": {"in_size": 8,
                                                     "image_config": [[4, "D", 8],
                                                                      [8, "U", 8, "U", 4]],
                                                     "camera_config": [4, 4],
                                                     "object_config": None,
                                                     "projection_type": "factor",
                                                     "predict_color": False,
                                                     "predict_depth": True,
                                                     "predict_mask": True},
                                            "state_dict": ph.state_dict()},
                           "discriminator": {"args": {"in_channels": 2, "block_config": [4, 8],
                                                      "num_scales": 2},
                                             "state_dict": MultiScaleDiscriminator(
                                                 2, (4, 8), 2, device="cpu").state_dict()}}}
    torch.save(payload, tmp_path / "pool.pth")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LatentFusionModel.from_checkpoint(tmp_path / "pool.pth")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.discriminator_from_checkpoint(payload)
    model = LatentFusionModel.from_checkpoint(tmp_path / "pool.pth", device="cpu")
    assert isinstance(model.fuser, fusion.PoolFuser)
    disc = checkpoint.discriminator_from_checkpoint(payload, device="cpu")
    assert disc.num_scales == 2 and next(disc.parameters()).device.type == "cpu"
    payload["args"]["no_discriminator"] = True
    assert checkpoint.discriminator_from_checkpoint(payload, device="cpu") is None
