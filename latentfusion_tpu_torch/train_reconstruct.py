"""Train the reconstruction model on the card (counterpart of
``tools/train_reconstruct.py``): the same flags, so the published recipe
(``tools/train.sh``) runs as

    python -m latentfusion_tpu_torch.train_reconstruct \\
        --dataset-type shapenet --dataset-path $SHAPENET \\
        --textures-path $COCO --color-background-path $COCO \\
        --save-dir runs --base-name shapenet,256 ... --use-amp

``--use-amp`` computes the equalized convolutions in bfloat16
(``dtypes.py``). The generator's learning rate falls by
``--generator-lr-gamma`` at each of ``--generator-lr-milestones`` times
``--batches-per-epoch`` steps. ``--resume`` reads this package's
checkpoints and the JAX trainer's ``ckpt-*.npz.pkl`` alike (the parameters
only, as the JAX tool does); ``--branch`` forks the run under a new name.
``--device cpu`` trains on the CPU; the default is the card.

Over several cards of one host, under torchrun:

    torchrun --nproc-per-node N -m latentfusion_tpu_torch.train_reconstruct \
        ... --batch-size B --data-parallel        # B / N objects a rank
    torchrun --nproc-per-node N -m latentfusion_tpu_torch.train_reconstruct \
        ... --batch-size B --fsdp F               # params sharded F-ways

``--data-parallel`` takes the process group from torchrun's environment
(NCCL on the cards, gloo with ``--device cpu``); each rank renders its
slice of every global batch and the step averages the gradients, so a step
is the global batch's. ``--fsdp F`` shards the parameters and Adam's state
with FSDP2 on a ``(N / F) x F`` ``data x fsdp`` mesh (the discriminator,
when there is one, stays whole on every rank) and takes the same step.
Every rank builds the same weights from ``--seed`` (or loads the same
``--resume``), and rank 0 alone writes the checkpoints, the ``.pth`` and
the logs. Run as one process, ``--data-parallel`` changes nothing.
"""
from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

from . import dtypes

logger = logging.getLogger("train_reconstruct")


def get_args(argv=None):
    from .train import args as A

    parser = argparse.ArgumentParser()
    A.add_common_args(parser)
    A.add_dataset_args(parser)
    A.add_architecture_args(parser)
    A.add_loss_args(parser)
    parser.add_argument("--save-dir", type=Path, required=True)
    parser.add_argument("--base-name", type=str, required=True)
    parser.add_argument("--resume", type=Path)
    parser.add_argument("--override", type=str, default="",
                        help="comma-separated arg names to keep from the "
                             "CLI instead of the checkpoint on resume")
    parser.add_argument("--branch", action="store_true",
                        help="fork the resumed run under a new name")
    parser.add_argument("--branch-name", type=str, default="branch")
    parser.add_argument("--device", default="cuda",
                        help="the training device (default the card)")
    return parser.parse_args(argv)


def load_checkpoint_args(ckpt_args: dict, args, override: str):
    """Restore persisted run args, keeping CLI values for --override'd flags,
    the control flags, and a data path whose checkpointed one is gone."""
    keep = {k.strip().replace("-", "_") for k in override.split(",") if k}
    keep |= {"resume", "branch", "branch_name", "override", "save_dir",
             "num_epochs", "device"}
    # The JAX tool's path names: only dataset_path and depth_background_path
    # are flags (ROADMAP Queue 3).
    for path_key in ("dataset_path", "background_path",
                     "depth_background_path", "texture_path"):
        old = ckpt_args.get(path_key)
        if old is not None and not Path(old).exists() and \
                getattr(args, path_key, None) is not None:
            keep.add(path_key)
    for k, v in ckpt_args.items():
        if k in keep or not hasattr(args, k) or v is None:
            continue
        setattr(args, k, v)
    return args


def generate_name(base_name, args) -> str:
    return (
        f"{base_name}"
        f"{',mask' if args.predict_mask else ''}"
        f"{',color' if args.predict_color else ''}"
        f"{',depth' if args.predict_depth else ''}"
        f"{',disc' if not args.no_discriminator else ''}"
        f",mask_noise_p={args.mask_noise_p}"
        f",sm={args.scale_mode}"
        f",fuser={args.fuser_type}"
    ).replace(":", "_")


def _block_config(cfg):
    return tuple(_block_config(c) for c in cfg) if isinstance(cfg, (list, tuple)) else cfg


def model_args(args) -> dict:
    """The modules' constructor arguments, as the JAX modules'
    ``checkpoint_args()`` record them, but the Photographer's ``in_size``
    (the Sculptor's ``out_size``)."""
    sculptor = {
        "in_size": args.input_size, "image_config": _block_config(args.sculptor_image_config),
        "camera_config": _block_config(args.sculptor_camera_config),
        "object_config": _block_config(args.sculptor_object_config),
        "relu_slope": 0.2, "cube_size": args.cube_size,
        "cube_activation_type": args.cube_activation_type,
        "projection_type": args.sculptor_projection_type,
        "input_color": not args.no_generator_input_color,
        "input_depth": args.generator_input_depth,
        "input_mask": args.generator_input_mask, "scale_mode": args.scale_mode,
    }
    photographer = {
        "image_config": _block_config(args.photographer_image_config),
        "camera_config": _block_config(args.photographer_camera_config),
        "occlusion_config": _block_config(args.photographer_occlusion_config) or False,
        "object_config": _block_config(args.photographer_object_config) or None,
        "projection_type": args.photographer_projection_type, "relu_slope": 0.2,
        "in_views": 1, "skip_connections": False,
        "cube_size": args.cube_size, "predict_color": args.predict_color,
        "predict_depth": args.predict_depth, "predict_mask": args.predict_mask,
        "scale_mode": args.scale_mode,
    }
    out = {"sculptor": sculptor, "photographer": photographer}
    if not args.no_discriminator:
        d_channels = (3 * args.discriminator_input_color + args.discriminator_input_depth
                      + args.discriminator_input_mask)
        out["discriminator"] = {"in_channels": d_channels or 1,
                                "block_config": tuple(args.discriminator_config),
                                "num_scales": args.discriminator_scales}
    return out


def build_models(args, device="cuda", generator=None):
    """(sculptor, fuser, photographer, discriminator or None, their
    checkpoint args), with weights N(0, 1) from ``generator``."""
    from . import zoo
    from .pggan import MultiScaleDiscriminator
    from .recon import fusion
    from .recon.models import Photographer, Sculptor

    margs = model_args(args)
    sculptor = zoo.init_weights_(Sculptor(**margs["sculptor"]), generator).to(device)
    margs["photographer"]["in_size"] = sculptor.out_size
    photographer = zoo.init_weights_(Photographer(**margs["photographer"]),
                                     generator).to(device)
    fuser = fusion.get_fuser(args.fuser_type, sculptor.out_channels, args.cube_size,
                             block_config=args.fuser_config, device=device,
                             generator=generator)
    discriminator = None
    if "discriminator" in margs:
        discriminator = MultiScaleDiscriminator(**margs["discriminator"], device=device,
                                                generator=generator)
    return sculptor, fuser, photographer, discriminator, margs


def process_group(args, device):
    """The ranks a run trains on: (rank, world, device, mesh). Under
    torchrun ``--data-parallel`` and ``--fsdp`` join its group. One process
    trains unsharded, as before: ``--data-parallel`` and ``--fsdp 1``
    change nothing there, and a larger ``--fsdp`` asks for torchrun."""
    import torch

    from . import parallel

    under_torchrun = "RANK" in os.environ or torch.distributed.is_initialized()
    if not under_torchrun:
        if args.fsdp and args.fsdp > 1:
            raise SystemExit(f"--fsdp {args.fsdp} does not divide 1 devices (one process; "
                             "launch with torchrun)")
        if args.data_parallel or args.fsdp:
            logger.info("one process: nothing to shard")
        return 0, 1, device, None
    if not (args.fsdp or args.data_parallel):
        return 0, 1, device, None
    rank, world, device = parallel.init_distributed(device)
    if args.fsdp and world % args.fsdp:
        raise SystemExit(f"--fsdp {args.fsdp} does not divide {world} devices (one a rank)")
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} does not split over {world} ranks")
    mesh = (parallel.make_mesh_2d(world // args.fsdp, args.fsdp, device) if args.fsdp
            else parallel.make_mesh(world, device=device))
    logger.info("rank %d of %d: %s, %d of the global batch of %d", rank, world,
                f"FSDP over {args.fsdp}" if args.fsdp else "data parallel",
                args.batch_size // world, args.batch_size)
    return rank, world, device, mesh


@dtypes.compute_dtype()
def main(argv=None):
    """Train as the arguments say; returns the ``ReconTrainer``."""
    args = get_args(argv)

    import torch

    from .device import resolve_device
    from .train.trainer import load_checkpoint
    from .utils import seed_all

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    device = resolve_device(args.device)
    seed_all(args.seed)

    resume_payload = None
    if args.resume:
        resume_payload = load_checkpoint(args.resume)
        args = load_checkpoint_args(resume_payload.get("args", {}), args, args.override)
        if args.branch:
            args.base_name = f"{args.base_name}-{args.branch_name}"
            logger.info("branching run as %s", args.base_name)

    if args.use_amp:
        dtypes.set_compute_dtype("bfloat16")

    rank, world, device, mesh = process_group(args, device)
    return _train(args, device, rank, world, mesh, resume_payload)


def _train(args, device, rank, world, mesh, resume_payload):
    import torch

    from .data.loader import IterableLoader
    from .train import args as A
    from .train.step import init_gan_train_state, make_optimizer, make_recon_train_step
    from .train.trainer import ReconTrainer, load_module_params
    from .utils import ExponentialScheduler, piecewise_constant_schedule

    camera_dist = A.auto_camera_dist(args)
    logger.info("camera_dist=%.4f", camera_dist)

    init = torch.Generator(device).manual_seed(args.seed)
    sculptor, fuser, photographer, discriminator, margs = build_models(args, device, init)

    lr_schedule = None
    if args.optimizer == "adam":
        lr_schedule = piecewise_constant_schedule(
            args.generator_lr, {m * args.batches_per_epoch: args.generator_lr_gamma
                                for m in (args.generator_lr_milestones or [])})
    g_optimizer = make_optimizer(args.optimizer, args.generator_lr)
    d_optimizer = (make_optimizer("adam", args.discriminator_lr)
                   if discriminator is not None else None)
    modules = {"sculptor": sculptor, "fuser": fuser, "photographer": photographer}
    if resume_payload is not None:
        for name, module in modules.items():
            load_module_params(module, resume_payload["modules"][name]["params"])
        logger.info("resumed from %s (epoch %s)", args.resume, resume_payload.get("epoch"))
    if args.fsdp:
        from . import parallel

        # The discriminator stays whole on every rank, its gradient averaged
        # by the step: the generator's loss freezes its parameters
        # (requires_grad off), which FSDP2's unsharded copies do not follow.
        parallel.shard_fsdp(modules, mesh)
    state = init_gan_train_state(modules, g_optimizer, discriminator, d_optimizer, device)

    config = {k: v for k, v in vars(args).items()
              if isinstance(v, (int, float, str, bool, type(None)))}
    config["camera_dist"] = camera_dist
    dataset = A.get_dataset(args)
    step_fn = make_recon_train_step(sculptor, fuser, photographer, discriminator, config,
                                    mesh=mesh)
    loader = IterableLoader(dataset, batch_size=args.batch_size // world,
                            num_workers=args.num_workers, device=device,
                            transport=args.transport, rank=rank)
    input_noise_sched = (ExponentialScheduler(1.0, 1e-4, args.input_noise_epochs)
                         if discriminator is not None else None)

    explicit = {"batches_per_epoch", "batch_groups", "num_epochs",
                "save_interval", "camera_dist", "seed", "device"}
    trainer = ReconTrainer(
        name=generate_name(args.base_name, args),
        save_dir=args.save_dir, loader=loader,
        batches_per_epoch=args.batches_per_epoch, batch_groups=args.batch_groups,
        num_epochs=args.num_epochs, save_interval=args.save_interval,
        sculptor=sculptor, fuser=fuser, photographer=photographer,
        discriminator=discriminator, state=state, step_fn=step_fn,
        module_args=margs, lr_schedule=lr_schedule,
        input_noise_sched=input_noise_sched, camera_dist=camera_dist,
        seed=args.seed, device=device, rank=rank,
        logger_intervals={"scalar_interval": args.plot_interval,
                          "image_interval": args.show_interval,
                          "histogram_interval": args.histogram_interval},
        **{k: v for k, v in config.items() if k not in explicit})
    try:
        trainer.start(train=True)
    finally:
        loader.shutdown()
        trainer.plotter.close()
    return trainer


if __name__ == "__main__":
    main()
