"""Latent reconstruction and novel-view rendering example (counterpart of
``examples/reconstruction.py``): build a latent object from synthetic
reference views (host rasterizer), render a novel view with the decoder
(``render_full``) and with image-based rendering (``render_ibr_basic``),
and write a comparison grid as a PNG.

    python -m latentfusion_tpu_torch.examples.reconstruction \\
        [--checkpoint model.pth] [--out reconstruction.png] [--device cpu]

The grid's rows: the target view, its depth, the predicted depth, the
predicted mask and the IBR color. Runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", type=Path)
    parser.add_argument("--mesh", type=Path)
    parser.add_argument("--num-views", type=int, default=6)
    parser.add_argument("--out", type=Path, default=Path("reconstruction.png"))
    parser.add_argument("--input-size", type=int, default=16)
    parser.add_argument("--camera-dist", type=float, default=1.5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> np.ndarray:
    """Writes ``--out`` and returns the grid (3, H, W) in [0, 1]."""
    from .. import png
    from .. import visualization as viz
    from .pose_estimation import build_model, synthetic_observations

    args = parse_args(argv)
    model = build_model(args)
    ref, target, _ = synthetic_observations(args)

    print(f"building latent object from {len(ref)} views...")
    z_obj = model.build_latent_object(ref)

    print("rendering novel view (decoder)...")
    out = model.render_full(z_obj, target.camera)

    print("rendering novel view (IBR)...")
    try:
        y_ibr, _ = model.render_ibr_basic(
            z_obj, ref, target.camera.zoom(None, model.input_size, model.camera_dist))
        ibr_color = y_ibr["color"].cpu().numpy()
    except Exception as e:  # noqa: BLE001 -- the JAX example's behaviour
        print(f"  (IBR skipped: {e})")
        ibr_color = None

    groups = [
        target.color.cpu().numpy(),                        # GT view
        viz.colorize_depth(target.depth.cpu().numpy()),    # GT depth
        viz.colorize_depth(out["depth"].cpu().numpy()),    # predicted depth
        viz.colorize_tensor(out["mask"].cpu().numpy()),    # predicted mask
    ]
    if ibr_color is not None:
        groups.append(np.clip(ibr_color, 0, 1))
    grid = viz.make_grid(groups, row_size=4, output_size=160)
    png.write_png(args.out, (grid.transpose(1, 2, 0) * 255).astype(np.uint8))
    print(f"wrote {args.out}")
    return grid


if __name__ == "__main__":
    main()
