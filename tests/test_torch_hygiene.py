"""The port stands alone: no file of ``latentfusion_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax or the JAX package, nor a
library the GPU machine lacks (imageio, PIL, cv2, sklearn, trimesh,
matplotlib, tensorboard; the trainer's meters import TensorBoard only when it is
there), no entry point runs on the CPU unless asked to, the host
rasterizer and the JPEG decoder raise when they cannot be built, and the
committed JPEG bank is what phase 13 of chip_smoke.py reads."""
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
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "latentfusion_tpu", "imageio", "PIL", "cv2",
             "sklearn", "trimesh", "matplotlib", "tensorboard"}


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
            "latentfusion_tpu_torch/pggan/discriminator.py",
            "latentfusion_tpu_torch/meshutils.py",
            "latentfusion_tpu_torch/pointcloud.py",
            "latentfusion_tpu_torch/unseen_real.py",
            "latentfusion_tpu_torch/augment/__init__.py",
            "latentfusion_tpu_torch/augment/cv_compat.py",
            "latentfusion_tpu_torch/augment/masks.py",
            "latentfusion_tpu_torch/augment/tensors.py",
            "latentfusion_tpu_torch/data/__init__.py",
            "latentfusion_tpu_torch/data/rasterizer.py",
            "latentfusion_tpu_torch/data/rendering.py",
            "latentfusion_tpu_torch/data/synthetic.py",
            "latentfusion_tpu_torch/data/loader.py",
            "latentfusion_tpu_torch/data/bop.py",
            "latentfusion_tpu_torch/data/kinectfusion.py",
            "latentfusion_tpu_torch/data/triplet.py",
            "latentfusion_tpu_torch/dtypes.py",
            "latentfusion_tpu_torch/jpeg.py",
            "latentfusion_tpu_torch/train/logging.py",
            "latentfusion_tpu_torch/train/args.py",
            "latentfusion_tpu_torch/train/trainer.py",
            "latentfusion_tpu_torch/train/ibr_step.py",
            "latentfusion_tpu_torch/train_reconstruct.py",
            "latentfusion_tpu_torch/train_ibr.py",
            "latentfusion_tpu_torch/train_unseen_real.py",
            "latentfusion_tpu_torch/train_encoder_distill.py",
            "latentfusion_tpu_torch/train_unseen_objects.py",
            "latentfusion_tpu_torch/pose/format.py",
            "latentfusion_tpu_torch/pose/bop.py",
            "latentfusion_tpu_torch/pose/plotting.py",
            "latentfusion_tpu_torch/evaluate_bop.py",
            "latentfusion_tpu_torch/visualization.py",
            "latentfusion_tpu_torch/examples/__init__.py",
            "latentfusion_tpu_torch/examples/pose_estimation.py",
            "latentfusion_tpu_torch/examples/reconstruction.py",
            "latentfusion_tpu_torch/data/realsense.py",
            "latentfusion_tpu_torch/data/colmap.py",
            "latentfusion_tpu_torch/poserbpf_comparison.py",
            "latentfusion_tpu_torch/metropolis_eval.py",
            "latentfusion_tpu_torch/serving_accuracy.py",
            "latentfusion_tpu_torch/parallel/__init__.py",
            "latentfusion_tpu_torch/pggan/generator.py",
            "latentfusion_tpu_torch/videos.py",
            "latentfusion_tpu_torch/utils/__init__.py",
            "latentfusion_tpu_torch/utils/profiling.py",
            "latentfusion_tpu_torch/profile_refinement.py",
            "latentfusion_tpu_torch/profile_cem.py",
            "latentfusion_tpu_torch/profile_decode.py",
            "latentfusion_tpu_torch/bench_sampler.py",
            "latentfusion_tpu_torch/bench_fuser.py",
            "latentfusion_tpu_torch/bench_loader.py",
            "latentfusion_tpu_torch/train_oracle_distill.py",
            "latentfusion_tpu_torch/train_cube_demo.py",
            "latentfusion_tpu_torch/trained_pose_experiment.py"} <= names
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
    # The measurement tools: the card unless --cpu (the benches) or
    # --device cpu (the profilers); bench_loader is host-only, as in JAX.
    from latentfusion_tpu_torch import (bench_fuser, bench_sampler, profile_cem, profile_decode,
                                        profile_refinement)
    from latentfusion_tpu_torch.utils import profiling

    for tool in (profile_refinement, profile_cem, profile_decode, bench_sampler, bench_fuser):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main(["--trace-dir", str(tmp_path)] if tool in (profile_refinement,
                                                                 profile_cem) else [])
    for tool in (profile_refinement, profile_cem, profile_decode):
        assert tool.parse_args(["--device", "cpu"]).device == "cpu"
    for tool in (bench_sampler, bench_fuser):
        assert tool.parse_args(["--cpu"]).cpu
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.profile(tmp_path, device="cuda"):
            pass


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


def test_data_entry_points_raise_without_gpu(no_gpu, tmp_path):
    """The loader's device transfer and the real-data rig go to the GPU
    unless asked for the CPU."""
    from latentfusion_tpu_torch import unseen_real
    from latentfusion_tpu_torch.data import loader

    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.IterableLoader([], batch_size=1)
    assert loader.IterableLoader([], batch_size=1, device="cpu").device.type == "cpu"
    assert loader.IterableLoader([], batch_size=1, device=None).device is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        unseen_real.main(["--out", str(tmp_path)])


def test_failed_rasterizer_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler error or a missing compiler raises."""
    from latentfusion_tpu_torch.data import rasterizer

    broken = tmp_path / "rasterizer.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(rasterizer, "SOURCE", broken)
    monkeypatch.setattr(rasterizer, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(rasterizer, "_LIB", None)
    with pytest.raises(RuntimeError, match="building rasterizer.cpp failed"):
        rasterizer.load_library()
    with pytest.raises(RuntimeError, match="building"):
        rasterizer.rasterize(np.zeros((3, 3), np.float32), np.zeros((1, 3), np.int32),
                             np.eye(4), np.eye(3), 4, 4)
    assert not list((tmp_path / "build").glob("*.tmp"))
    monkeypatch.setattr(rasterizer.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        rasterizer.load_library()


def test_tensorboard_is_optional(monkeypatch, tmp_path, caplog):
    """The trainer's meters run without TensorBoard, with the JAX package's
    warning."""
    import builtins

    from latentfusion_tpu_torch.train.logging import MetricLogger

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if "tensorboard" in name:
            raise ImportError("no tensorboard here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    logger = MetricLogger(tmp_path / "tb")
    assert logger.writer is None and "tensorboard unavailable" in caplog.text
    logger.put_scalar("loss", 1.0)
    logger.put_image("image", np.zeros((3, 4, 4)))
    assert logger.epoch_summary() == {"loss": 1.0}


def test_training_entry_points_raise_without_gpu(no_gpu, tmp_path):
    """The training tools train on the GPU unless given --device cpu."""
    from latentfusion_tpu_torch import (train_encoder_distill, train_ibr, train_reconstruct,
                                        train_unseen_objects, train_unseen_real)

    for main, argv in ((train_reconstruct.main, ["--save-dir", str(tmp_path),
                                                 "--base-name", "b"]),
                       (train_ibr.main, ["--save-dir", str(tmp_path), "--base-name", "b",
                                         "--recon-checkpoint", str(tmp_path / "m.pth")]),
                       (train_encoder_distill.main, ["--out", str(tmp_path)]),
                       (train_unseen_objects.main, ["--out", str(tmp_path)]),
                       (train_unseen_real.main, ["--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


def test_experiment_tools_raise_without_gpu_and_take_the_cpu(no_gpu, tmp_path):
    """The experiment tools run on the GPU unless given --device cpu, and
    raise before they write anything."""
    from latentfusion_tpu_torch import train_cube_demo, train_oracle_distill, trained_pose_experiment

    for main, argv in ((train_oracle_distill.main, ["--out", str(tmp_path / "o")]),
                       (train_cube_demo.main, ["--out", str(tmp_path / "c")]),
                       (trained_pose_experiment.main, [])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert list(tmp_path.iterdir()) == []
    for tool in (train_oracle_distill, train_cube_demo):
        assert tool.get_args(["--out", "x", "--device", "cpu"]).device == "cpu"
        assert tool.get_args(["--out", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trained_pose_experiment.run("cuda", 0)
    model = train_oracle_distill.decoder_model(zoo.demo_photographer(device="cpu"), "cpu")
    assert model.input_size == train_oracle_distill.INPUT_SIZE and model.device.type == "cpu"


def test_skip_train_writes_only_under_out(tmp_path, monkeypatch):
    """``train_oracle_distill --skip-train`` reads and writes under its
    ``--out`` alone: the committed record is untouched and nothing lands in
    the working directory."""
    import hashlib
    import shutil

    from latentfusion_tpu_torch import train_oracle_distill

    record = ROOT / "artifacts" / "oracle_distill"

    def digest():
        return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(record.iterdir())}

    before = digest()
    out, cwd = tmp_path / "out", tmp_path / "cwd"
    out.mkdir()
    cwd.mkdir()
    for name in ("distilled.npz", "distilled_keys.json"):
        shutil.copy(record / name, out / name)
    monkeypatch.chdir(cwd)
    monkeypatch.setitem(train_oracle_distill.FINE, "num_iters", 2)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_oracle_distill.main(["--skip-train", "--out", str(out), "--eval-targets", "1",
                                   "--coarse-samples", "8", "--coarse-iters", "2",
                                   "--device", "cpu"])
    finally:
        torch.set_num_threads(prev)
    assert sorted(p.name for p in out.iterdir()) == [
        "distilled.npz", "distilled_keys.json", "pose_eval.json"]
    assert list(cwd.iterdir()) == []
    assert digest() == before


def test_encoder_distill_pth_export_raises_on_a_failed_write(tmp_path, monkeypatch):
    """A failed ``checkpoint.pth`` export ends the run (the JAX tool prints
    and carries on)."""
    from latentfusion_tpu_torch import train_encoder_distill

    def refuse(obj, path, *args, **kwargs):
        raise OSError(f"cannot write {path}")

    monkeypatch.setattr(torch, "save", refuse)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(OSError, match="checkpoint.pth"):
            train_encoder_distill.main(["--steps", "1", "--views-in", "1", "--views-out", "1",
                                        "--out", str(tmp_path), "--device", "cpu"])
    finally:
        torch.set_num_threads(prev)
    assert (tmp_path / "encoder_distill.npz").exists()
    assert not (tmp_path / "pose_eval.json").exists()


def test_training_tools_need_out(capsys):
    """The rigs' training tools have no default --out, so a run from the
    repo root cannot overwrite the committed artifacts/ checkpoints."""
    from latentfusion_tpu_torch import (train_cube_demo, train_encoder_distill,
                                        train_oracle_distill, train_unseen_objects,
                                        train_unseen_real)

    for tool in (train_encoder_distill, train_unseen_objects, train_unseen_real,
                 train_oracle_distill, train_cube_demo):
        with pytest.raises(SystemExit):
            tool.get_args([])
        assert "--out" in capsys.readouterr().err
        assert tool.get_args(["--out", "somewhere"]).out == Path("somewhere")


def test_parallel_entry_points_raise_without_gpu(no_gpu, monkeypatch):
    """The process group, the meshes the sharded estimators and steps take,
    and the generator run on the card unless asked for the CPU."""
    from latentfusion_tpu_torch import parallel
    from latentfusion_tpu_torch.pggan import Decoder, Encoder, EncoderDecoder

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.init_distributed()
    for make in (lambda: parallel.make_mesh(1, parallel.HYPOTHESIS_AXIS),
                 lambda: parallel.make_mesh(1, parallel.MODEL_AXIS),
                 lambda: parallel.make_mesh_2d(1, 1),
                 lambda: EncoderDecoder(3, 2, (4, 8)), lambda: Encoder(3, (4, 8)),
                 lambda: Decoder(2, (4, 8))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert sum(p.numel() for p in EncoderDecoder(3, 2, (4, 8), device="cpu").parameters())


def test_failed_jpeg_build_raises(monkeypatch, tmp_path):
    """No fallback: the JPEG decoder's compile error raises."""
    from latentfusion_tpu_torch import jpeg
    from latentfusion_tpu_torch.data import rasterizer

    broken = tmp_path / "jpeg.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(jpeg, "SOURCE", broken)
    monkeypatch.setattr(rasterizer, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(jpeg, "_LIB", None)
    with pytest.raises(RuntimeError, match="building jpeg.cpp failed"):
        jpeg.decode_jpeg(b"\xff\xd8\xff\xd9")
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_committed_jpeg_bank():
    """tests/data/jpeg_bank: 8 textures of 256^2 and 8 backgrounds of
    640x480, baseline JPEGs (the JAX package's procedural writers), small."""
    from latentfusion_tpu_torch import jpeg

    bank = ROOT / "tests" / "data" / "jpeg_bank"
    files = sorted(bank.rglob("*"))
    assert [f.name for f in files if f.is_file()] == (
        [f"bg_{i:03d}.jpg" for i in range(8)] + [f"tex_{i:03d}.jpg" for i in range(8)])
    assert sum(f.stat().st_size for f in files if f.is_file()) < 1_000_000
    for f in bank.glob("textures/*.jpg"):
        assert jpeg.read_jpeg(f).shape == (256, 256, 3)
    for f in bank.glob("backgrounds/*.jpg"):
        assert jpeg.read_jpeg(f).shape == (480, 640, 3)


def test_evaluation_entry_points_raise_without_gpu(no_gpu, tmp_path):
    """The evaluation tools and the examples run on the GPU unless given
    --device cpu."""
    from latentfusion_tpu_torch import (evaluate_bop, metropolis_eval, poserbpf_comparison,
                                        serving_accuracy)
    from latentfusion_tpu_torch.examples import pose_estimation, reconstruction

    for main, argv in ((evaluate_bop.main, ["--checkpoint", "m.pth", "--dataset-path", "lm",
                                            "--scene-path", "s", "--object-id", "1"]),
                       (poserbpf_comparison.main, ["--checkpoint", "m.pth",
                                                   "--reference-scene", "r",
                                                   "--eval-scene", "e"]),
                       (metropolis_eval.main, ["--tiny", "--out", str(tmp_path)]),
                       (serving_accuracy.main, ["--out", str(tmp_path)]),
                       (pose_estimation.main, []),
                       (reconstruction.main, ["--out", str(tmp_path / "g.png")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        metropolis_eval.load_eval_cameras()
