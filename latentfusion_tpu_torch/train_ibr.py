"""Train the IBR color generator on top of a reconstruction checkpoint
(counterpart of ``tools/train_ibr.py``): the same flags.

    python -m latentfusion_tpu_torch.train_ibr --recon-checkpoint model.pth \\
        --dataset-type paths --dataset-path meshes --save-dir runs --base-name ibr

``--recon-checkpoint`` is a reference ``.pth`` (``ReconTrainer.
export_torch_checkpoint`` writes one). The generator is a ``UNet2d`` of
``--generator-config`` with 1 + 6V inputs (``train.ibr_step``); the
discriminator, unless ``--no-discriminator``, reads the output colors.
``--device cpu`` trains on the CPU; the default is the card.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path

from . import dtypes

logger = logging.getLogger("train_ibr")


def get_args(argv=None):
    from .train import args as A
    from .utils import block_config_arg

    parser = argparse.ArgumentParser()
    A.add_common_args(parser)
    A.add_dataset_args(parser)
    A.add_loss_args(parser)
    parser.add_argument("--save-dir", type=Path, required=True)
    parser.add_argument("--base-name", type=str, required=True)
    parser.add_argument("--recon-checkpoint", type=Path, required=True)
    parser.add_argument("--generator-config",
                        default="64,D,128,D,256,D,512:512,U,256,U,128,U,64",
                        type=block_config_arg())
    parser.add_argument("--ibr-type", default="blend_flow",
                        choices=["regress", "blend", "blend_flow"])
    parser.add_argument("--no-discriminator", action="store_true")
    parser.add_argument("--discriminator-config", default=[64, 128, 256, 512],
                        type=lambda s: [int(x) for x in s.split(",")])
    parser.add_argument("--discriminator-scales", default=3, type=int)
    parser.add_argument("--flow-size", type=int, default=5)
    parser.add_argument("--train-recon", action="store_true")
    parser.add_argument("--recon-lr", type=float, default=1e-5)
    parser.add_argument("--no-apply-mask", action="store_true")
    parser.add_argument("--g-color-recon-loss-k-milestones",
                        type=lambda s: [int(x) for x in s.split(",")], default=None)
    parser.add_argument("--device", default="cuda",
                        help="the training device (default the card)")
    return parser.parse_args(argv)


@dtypes.compute_dtype()
def main(argv=None):
    """Train as the arguments say; returns the ``IBRTrainer``."""
    args = get_args(argv)

    import torch

    from . import zoo
    from .data.loader import IterableLoader
    from .device import resolve_device
    from .modules.unet import UNet2d
    from .pggan import MultiScaleDiscriminator
    from .recon import checkpoint as ckpt
    from .train import args as A
    from .train.ibr_step import (generator_in_channels, generator_out_channels,
                                 make_ibr_train_step)
    from .train.step import init_gan_train_state, make_optimizer
    from .train.trainer import IBRTrainer
    from .utils import ExponentialScheduler, seed_all

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    seed_all(args.seed)
    if args.use_amp:
        dtypes.set_compute_dtype("bfloat16")

    checkpoint = torch.load(args.recon_checkpoint, map_location="cpu", weights_only=False)
    checkpoint = ckpt.patch_legacy_args(checkpoint)
    recon_args = checkpoint["args"]
    sculptor, fuser, photographer = (m.to(device) for m in
                                     ckpt.modules_from_checkpoint(checkpoint))
    camera_dist = recon_args["camera_dist"]

    init = torch.Generator(device).manual_seed(args.seed)
    generator = zoo.init_weights_(UNet2d(
        generator_in_channels(args.num_input_views),
        generator_out_channels(args.ibr_type, args.num_input_views),
        args.generator_config), init).to(device)

    discriminator = d_optimizer = None
    if not args.no_discriminator:
        discriminator = MultiScaleDiscriminator(3, tuple(args.discriminator_config),
                                                args.discriminator_scales, device=device,
                                                generator=init)
        d_optimizer = make_optimizer(args.optimizer, args.discriminator_lr)
    g_optimizer = make_optimizer(args.optimizer, args.generator_lr)

    recon = {"sculptor": sculptor, "fuser": fuser, "photographer": photographer}
    trained = {"generator": generator, **(recon if args.train_recon else {})}
    if not args.train_recon:
        for module in recon.values():
            module.requires_grad_(False)
    state = init_gan_train_state(trained, g_optimizer, discriminator, d_optimizer, device)

    config = {k: v for k, v in vars(args).items()
              if isinstance(v, (int, float, str, bool, type(None)))}
    config.update(camera_dist=camera_dist,
                  cube_size=recon_args.get("cube_size", 1.0),
                  generator_input_depth=recon_args.get("generator_input_depth", False))
    step_fn = make_ibr_train_step(sculptor, fuser, photographer, generator,
                                  discriminator, config)

    dataset = A.get_dataset(args)
    loader = IterableLoader(dataset, batch_size=args.batch_size,
                            num_workers=args.num_workers, device=device,
                            transport=args.transport)
    input_noise_sched = (ExponentialScheduler(1.0, 1e-4, args.input_noise_epochs)
                         if discriminator is not None else None)

    module_args = {name: checkpoint["modules"][name]["args"]
                   for name in ("sculptor", "photographer")}
    if discriminator is not None:
        module_args["discriminator"] = {"in_channels": 3,
                                        "block_config": tuple(args.discriminator_config),
                                        "num_scales": args.discriminator_scales}
    explicit = {"batches_per_epoch", "batch_groups", "num_epochs",
                "save_interval", "camera_dist", "seed", "device"}
    trainer = IBRTrainer(
        name=f"ibr-{args.base_name},type={args.ibr_type}",
        save_dir=args.save_dir, loader=loader,
        batches_per_epoch=args.batches_per_epoch,
        batch_groups=args.batch_groups, num_epochs=args.num_epochs,
        save_interval=args.save_interval,
        sculptor=sculptor, fuser=fuser, photographer=photographer,
        discriminator=discriminator, generator=generator, state=state,
        step_fn=step_fn, module_args=module_args,
        input_noise_sched=input_noise_sched, camera_dist=camera_dist,
        seed=args.seed, device=device,
        **{k: v for k, v in config.items() if k not in explicit})
    try:
        trainer.start(train=True)
    finally:
        loader.shutdown()
        trainer.plotter.close()
    return trainer


if __name__ == "__main__":
    main()
