"""The training tools' argument groups and dataset factory (counterpart of
``latentfusion_tpu/train/args.py``): the same flags, defaults and
destinations, so the published recipe (``tools/train.sh``) parses alike in
both packages."""
from __future__ import annotations

import argparse
import math
from pathlib import Path

from ..utils import block_config_arg, list_arg


def add_common_args(parser: argparse.ArgumentParser):
    g = parser.add_argument_group("common")
    g.add_argument("--batch-size", type=int, default=8)
    g.add_argument("--batch-groups", type=int, default=1,
                   help="gradient accumulation groups")
    g.add_argument("--batches-per-epoch", type=int, default=4000)
    g.add_argument("--num-epochs", type=int, default=10000)
    g.add_argument("--num-workers", type=int, default=4)
    g.add_argument("--transport", choices=["quantized"], default=None,
                   help="worker->device transport codec: 'quantized' moves "
                        "uint8 color/mask + f16 depth (4x fewer bytes "
                        "through the loader queue and the host->device "
                        "copy; <=1/510 color quantization)")
    g.add_argument("--save-interval", type=int, default=10)
    g.add_argument("--plot-interval", type=int, default=100)
    g.add_argument("--show-interval", type=int, default=1000)
    g.add_argument("--histogram-interval", type=int, default=-1)
    g.add_argument("--grad-histogram-interval", type=int, default=-1)
    g.add_argument("--optimizer", default="adam",
                   choices=["adam", "sgd", "rmsprop"])
    g.add_argument("--gpu-id", type=int, default=0,
                   help="unused: the card is chosen by --device")
    g.add_argument("--data-parallel", action="store_true",
                   help="under torchrun, shard each global batch over the ranks "
                        "and average the gradients (one process: no effect)")
    g.add_argument("--fsdp", type=int, default=0, metavar="N",
                   help="under torchrun, shard params + optimizer state N-ways "
                        "(ZeRO-3 style, FSDP2) over the fsdp axis of a 2-D "
                        "data x fsdp mesh of the ranks; 0 disables; N must "
                        "divide the number of ranks")
    g.add_argument("--use-amp", action="store_true",
                   help="bf16 conv compute (dtypes.py; no loss scaling)")
    g.add_argument("--remat", action="store_true",
                   help="rematerialize encode/decode activations in the "
                        "backward pass (torch.utils.checkpoint) to fit larger "
                        "batches")
    g.add_argument("--seed", type=int, default=0)
    return parser


def add_dataset_args(parser: argparse.ArgumentParser):
    g = parser.add_argument_group("dataset")
    g.add_argument("--dataset-type", default="shapenet",
                   choices=["shapenet", "modelnet", "ycb", "bop", "paths"])
    g.add_argument("--dataset-path", type=Path)
    g.add_argument("--dataset-gpu-id", type=int, default=0)
    g.add_argument("--input-size", type=int, default=256)
    g.add_argument("--num-input-views", type=int, default=16)
    g.add_argument("--num-output-views", type=int, default=8)
    g.add_argument("--textures-path", type=Path)
    g.add_argument("--color-background-path", type=Path)
    g.add_argument("--depth-background-path", type=Path)
    g.add_argument("--color-noise-level", type=float, default=0.0)
    g.add_argument("--depth-noise-level", type=float, default=0.0)
    g.add_argument("--mask-noise-p", type=float, default=0.0)
    g.add_argument("--camera-translation-noise", type=float, default=0.0)
    g.add_argument("--camera-rotation-noise", type=float, default=0.0)
    g.add_argument("--color-random-background", action="store_true")
    g.add_argument("--depth-random-background", action="store_true")
    g.add_argument("--crop-random-background", action="store_true")
    g.add_argument("--use-constrained-cameras", action="store_true")
    g.add_argument("--disk-sample-cameras", action="store_true")
    g.add_argument("--use-model-materials", action="store_true")
    g.add_argument("--random-materials", action="store_true", default=True)
    g.add_argument("--render-width", type=int, default=640)
    g.add_argument("--render-height", type=int, default=480)
    return parser


def add_architecture_args(parser: argparse.ArgumentParser):
    g = parser.add_argument_group("architecture")
    g.add_argument("--camera-dist", default=None, type=float)
    g.add_argument("--cube-size", default=1.0, type=float)
    g.add_argument("--cube-activation-type", default="none",
                   choices=["tanh", "lrelu", "relu", "none"])
    g.add_argument("--fuser-type", default="pool:max",
                   choices=["pool:max", "pool:abs_max", "pool:mean",
                            "pool:median", "concat", "blend", "gru", "lstm"])
    g.add_argument(
        "--sculptor-image-config",
        default="64,D,64,D,128,D,256,D,512,D,512,D,512:512,U,512,U,512,U,256",
        type=block_config_arg())
    g.add_argument("--sculptor-camera-config", default="32,64,128",
                   type=block_config_arg())
    g.add_argument("--sculptor-object-config", default="128,256",
                   type=block_config_arg())
    g.add_argument("--photographer-object-config", default="256,256",
                   type=block_config_arg())
    g.add_argument("--photographer-occlusion-config", type=block_config_arg())
    g.add_argument("--photographer-camera-config", default="256,256,256",
                   type=block_config_arg())
    g.add_argument(
        "--photographer-image-config",
        default="256,D,512,D,512,D,512:512,U,512,U,512,U,256,U,128,U,64,U,32",
        type=block_config_arg())
    g.add_argument("--fuser-config", default="4,D,4,D,8,D,16:16,U,8,U,4,U,4",
                   type=block_config_arg())
    g.add_argument("--photographer-projection-type", default="factor",
                   choices=["sum", "factor"])
    g.add_argument("--sculptor-projection-type", default="factor",
                   choices=["tile", "factor"])
    g.add_argument("--discriminator-config", default="64,128,256,512",
                   type=list_arg(int))
    g.add_argument("--discriminator-scales", default=3, type=int)
    g.add_argument("--no-discriminator", action="store_true")
    g.add_argument("--random-orientation", action="store_true")
    g.add_argument("--scale-mode", default="bilinear",
                   choices=["nearest", "bilinear"])
    return parser


def add_loss_args(parser: argparse.ArgumentParser):
    g = parser.add_argument_group("losses")
    g.add_argument("--generator-lr", default=0.001, type=float)
    g.add_argument("--generator-lr-milestones", type=list_arg(int),
                   default=[100])
    g.add_argument("--generator-lr-gamma", default=0.5, type=float)
    g.add_argument("--discriminator-lr", default=0.001, type=float)
    g.add_argument("--g-gan-loss-weight", default=1.0, type=float)
    g.add_argument("--g-color-recon-loss-weight", default=50.0, type=float)
    g.add_argument("--g-color-recon-loss-type", default="l1",
                   choices=["l1", "smooth_l1", "hard_l1", "hard_smooth_l1"])
    g.add_argument("--g-color-recon-loss-k", type=int, default=2000)
    g.add_argument("--g-depth-recon-loss-weight", default=50.0, type=float)
    g.add_argument("--g-depth-recon-loss-type", default="l1",
                   choices=["l1", "smooth_l1", "hard_l1", "hard_smooth_l1"])
    g.add_argument("--g-depth-recon-loss-k", type=int, default=2000)
    g.add_argument("--g-depth-recon-loss-k-milestones", type=list_arg(int))
    g.add_argument("--g-mask-recon-loss-weight", default=50.0, type=float)
    g.add_argument("--g-mask-recon-loss-type", default="binary_cross_entropy",
                   choices=["l1", "smooth_l1", "hard_l1", "hard_smooth_l1",
                            "binary_cross_entropy"])
    g.add_argument("--g-mask-recon-loss-k", type=int, default=2000)
    g.add_argument("--g-mask-beta-loss-weight", default=1.0, type=float)
    g.add_argument("--g-mask-beta-loss-param", default=0.01, type=float)
    g.add_argument("--reconstruct-input", action="store_true")
    g.add_argument("--input-noise-mean", default=0.0, type=float)
    g.add_argument("--input-noise-std", default=0.2, type=float)
    g.add_argument("--input-noise-epochs", default=1000, type=float)
    g.add_argument("--depth-noise-mean", default=0.0, type=float)
    g.add_argument("--depth-noise-std", default=0.25, type=float)
    g.add_argument("--no-generator-input-color", action="store_true")
    g.add_argument("--generator-input-mask", action="store_true")
    g.add_argument("--generator-input-depth", action="store_true")
    g.add_argument("--discriminator-input-color", action="store_true")
    g.add_argument("--discriminator-input-depth", action="store_true")
    g.add_argument("--discriminator-input-mask", action="store_true")
    g.add_argument("--predict-color", action="store_true")
    g.add_argument("--predict-mask", action="store_true")
    g.add_argument("--predict-depth", action="store_true")
    g.add_argument("--use-occlusion-depth", action="store_true")
    g.add_argument("--crop-predicted-mask", action="store_true")
    return parser


def get_dataset(args):
    """The synthetic training stream the dataset flags describe."""
    from ..data import synthetic

    kwargs = dict(
        num_input_views=args.num_input_views,
        num_output_views=args.num_output_views,
        width=args.render_width,
        height=args.render_height,
        color_noise_level=args.color_noise_level,
        depth_noise_level=args.depth_noise_level,
        mask_noise_p=args.mask_noise_p,
        camera_translation_noise=args.camera_translation_noise,
        camera_rotation_noise=args.camera_rotation_noise,
        textures_dir=args.textures_path,
        use_textures=args.textures_path is not None,
        random_materials=args.random_materials,
        color_background_dir=args.color_background_path,
        color_random_background=args.color_random_background,
        depth_background_dir=args.depth_background_path,
        depth_random_background=args.depth_random_background,
        use_constrained_cameras=args.use_constrained_cameras,
        disk_sample_cameras=args.disk_sample_cameras,
        use_model_materials=args.use_model_materials,
        seed=args.seed,
    )
    if args.dataset_type == "shapenet":
        return synthetic.ShapeNetDataset(args.dataset_path, **kwargs)
    elif args.dataset_type == "modelnet":
        return synthetic.ModelNetDataset(args.dataset_path, **kwargs)
    elif args.dataset_type == "ycb":
        return synthetic.YCBDataset(args.dataset_path, **kwargs)
    elif args.dataset_type == "bop":
        return synthetic.BOPTrainDataset(args.dataset_path, **kwargs)
    elif args.dataset_type == "paths":
        paths = (synthetic.index_paths(args.dataset_path, ".obj")
                 + synthetic.index_paths(args.dataset_path, ".ply")
                 + synthetic.index_paths(args.dataset_path, ".off"))
        return synthetic.SyntheticDataset(paths, **kwargs)
    raise ValueError(f"Unknown dataset type {args.dataset_type!r}")


# The canonical Realsense focal length of a 640x480 frame.
FOCAL_640 = 615.1436


def auto_camera_dist(args) -> float:
    """``--camera-dist``, or the distance at which the object cube's bounding
    sphere fills the render's shorter side with 10 % slack."""
    from ..recon.utils import optimal_camera_dist

    if args.camera_dist is not None:
        return args.camera_dist
    focal = FOCAL_640 * args.render_width / 640.0
    radius = args.cube_size * math.sqrt(3) / 2.0
    return optimal_camera_dist(focal, min(args.render_width, args.render_height),
                               radius, slack=0.1)
