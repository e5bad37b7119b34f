"""One rank of the port's parallel checks (``tests/test_torch_parallel.py``).

    python tests/torch_parallel_ranks.py DIR RANK WORLD

joins a gloo group by a ``file://`` rendezvous in DIR, reads the inputs the
test wrote (``DIR/inputs.pt``), runs every multi-rank path of the port on
them on the CPU and writes what it computed to ``DIR/rank<RANK>.pt``. It
imports the port and torch only (never JAX), so it can start apart from
the test's process.
"""
from __future__ import annotations

import collections
import contextlib
import sys
import traceback
from pathlib import Path
from unittest import mock

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from latentfusion_tpu_torch import parallel, testing, zoo  # noqa: E402
from latentfusion_tpu_torch.pggan import MultiScaleDiscriminator  # noqa: E402
from latentfusion_tpu_torch.pose import estimation  # noqa: E402
from latentfusion_tpu_torch.recon import models  # noqa: E402
from latentfusion_tpu_torch.train import step as tstep  # noqa: E402


class Replay:
    """Another implementation's random draws, replayed in the order a
    recording run asked for them (``tests/test_torch_parallel.py``'s
    ``Recorder``), whatever the arguments."""

    def __init__(self, record):
        self.queues = collections.defaultdict(collections.deque)
        for name, value in record:
            self.queues[name].append(value)

    def __getattr__(self, name):
        if name.startswith("__") or name == "queues":
            raise AttributeError(name)
        return lambda *args, **kwargs: self.queues[name].popleft()


def target_quadratic(target, z_depth, z_mask_logits, cam, **_):
    """A smooth loss of each hypothesis' pose against its target frame's
    camera (``tests/test_torch_pose_batch.py``'s): arrays of either
    package."""
    return {"depth": ((cam.log_quaternion - target.camera.log_quaternion) ** 2).sum(-1)
            + ((cam.translation - target.camera.translation) ** 2).sum(-1),
            "ov_depth": 1e-7 * (cam.viewport ** 2).sum(-1)}


def camera_fields(cam):
    return {"translation": cam.translation, "log_quaternion": cam.log_quaternion,
            "viewport": cam.viewport}


def estimators(inputs, out):
    """Each estimator with the hypothesis mesh, from the test's cameras and
    (for the stochastic ones) the recorded draws."""
    oracle = testing.EllipsoidOracleModel(device="cpu")
    mesh = parallel.make_mesh(dist.get_world_size(), parallel.HYPOTHESIS_AXIS, "cpu")
    single, batch = inputs["target"], inputs["targets"]
    z2 = torch.zeros(2, 1, 1, 1, 1, 1)

    # Refinement with the smooth loss (held to JAX) and the default loss
    # (held to the port's unsharded loop).
    for loss in ("smooth", "default"):
        g = inputs["gradient"]
        est = estimation.GradientPoseEstimator(model=oracle, mesh=mesh, **g["kwargs"])
        if loss == "smooth":
            est.loss_func = target_quadratic
        cam, stats = est.estimate(None, single, camera=g["cameras"])
        out[f"gradient {loss}"] = {**camera_fields(cam), "loss_history": stats["loss_history"]}

        g = inputs["gradient_batch"]
        est = estimation.GradientPoseEstimator(model=oracle, mesh=mesh, **g["kwargs"])
        if loss == "smooth":
            est.loss_func = target_quadratic
        cams, stats = est.estimate_batch(z2, batch, cameras=g["cameras"])
        out[f"gradient_batch {loss}"] = {"cameras": [camera_fields(c) for c in cams],
                                         "loss_history": stats["loss_history"]}

    g = inputs["cem"]
    est = estimation.CrossEntropyPoseEstimator(model=oracle, mesh=mesh, **g["kwargs"])
    out["cem"] = camera_fields(est.estimate(None, single, cameras=g["cameras"],
                                            draws=Replay(g["draws"])))

    g = inputs["cem_batch"]
    est = estimation.CrossEntropyPoseEstimator(model=oracle, mesh=mesh, **g["kwargs"])
    out["cem_batch"] = [camera_fields(c) for c in
                        est.estimate_batch(z2, batch, draws=Replay(g["draws"]))]

    g = inputs["metropolis_batch"]
    est = estimation.MetropolisPoseEstimator(model=oracle, mesh=mesh, **g["kwargs"])
    out["metropolis_batch"] = [camera_fields(c) for c in
                               est.estimate_batch(z2, batch, draws=Replay(g["draws"]))]

    # Hypotheses the ranks do not divide: every rank scores them all.
    g = inputs["gradient"]
    est = estimation.GradientPoseEstimator(model=oracle, mesh=mesh,
                                           **dict(g["kwargs"], num_iters=1))
    cam, _ = est.estimate(None, single, camera=g["cameras"][:7])
    out["gradient_uneven"] = camera_fields(cam)


def tp_decode(inputs, out):
    """The tiny Photographer's decode with its weights cut on their
    out-channels over a model mesh."""
    g = inputs["tp"]
    mesh = parallel.make_mesh(dist.get_world_size(), parallel.MODEL_AXIS, "cpu")
    x = torch.full((3,), float(dist.get_rank()))
    parallel.replicate({"x": x}, mesh)
    out["replicated"] = x
    photographer = zoo.tiny_photographer(device="cpu")
    photographer.load_state_dict(g["state"])
    with torch.no_grad():
        y, _, _ = models.decode(photographer, g["z_obj"], g["camera"])
    out["tp_whole"] = {"depth": y["depth"], "mask": y["mask"]}
    out["tp_cut"] = parallel.shard_tp(photographer, mesh, min_leaf_size=2)
    with torch.no_grad():
        y, _, _ = models.decode(photographer, g["z_obj"], g["camera"])
    out["tp"] = {"depth": y["depth"], "mask": y["mask"]}


def _modules(state):
    mods = {"sculptor": zoo.tiny_sculptor(device="cpu"), "fuser": zoo.tiny_fuser(device="cpu"),
            "photographer": zoo.tiny_photographer(device="cpu")}
    for name, module in mods.items():
        module.load_state_dict(state[name])
    return mods


def train_steps(inputs, out):
    """The plain step data-parallel and with FSDP, each rank on its slice
    of the global batch: loss, terms, gradients and parameters after the
    step (sharded leaves gathered whole)."""
    g = inputs["train"]
    world = dist.get_world_size()
    for label, mesh in (("dp", parallel.make_mesh(world, device="cpu")),
                        ("fsdp", parallel.make_mesh_2d(1, world, "cpu"))):
        mods = _modules(g["state"])
        sharded, dims_ok = 0, True
        if label == "fsdp":
            parallel.shard_fsdp(mods, mesh, min_leaf_size=2)
            sharded = sum(p.to_local().shape != p.shape for m in mods.values()
                          for p in m.parameters())
            # Each parameter sits on the fsdp axis at fsdp_shardings' dim.
            dims_ok = all(
                p.placements[-1].dim == parallel.fsdp_shardings(m, mesh, 2)[k]
                for m in mods.values() for k, p in m.named_parameters())
        state = tstep.init_train_state(mods, tstep.make_optimizer("adam", 1e-3))
        step = tstep.make_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                     g["config"], num_microbatches=g["microbatches"],
                                     mesh=mesh)
        local = parallel.shard_batch(g["batch"], mesh, g["microbatches"])
        _, loss, aux = step(state, local)
        full = {name: parallel.full_state_dict(m) for name, m in mods.items()}

        def whole(t):
            return t.full_tensor() if hasattr(t, "full_tensor") else t

        grads = {f"{name}.{k}": whole(p.grad).clone() for name, m in mods.items()
                 for k, p in m.named_parameters()}
        out[label] = {"loss": loss, "aux": aux, "grads": grads, "sharded": sharded,
                      "dims_ok": dims_ok,
                      "params": {f"{name}.{k}": v for name, sd in full.items()
                                 for k, v in sd.items()}}


def recon_step(inputs, out):
    """``make_recon_train_step`` data-parallel on a raw batch, with the
    discriminator and its instance noise (the global draws, each rank's
    slice): ``recon`` from the step's generator in 2 microbatches, against
    the same step in one process; ``recon_jax`` with the draws and
    orientations the test recorded from JAX's keys, against JAX's step on
    its mesh (the test runs those)."""
    mesh = parallel.make_mesh(dist.get_world_size(), device="cpu")
    for label in ("recon", "recon_jax"):
        g = inputs[label]
        mods = _modules(g["state"])
        disc = MultiScaleDiscriminator(2, g["d_config"], g["d_scales"], device="cpu")
        disc.load_state_dict(g["disc_state"])
        state = tstep.init_gan_train_state(mods, tstep.make_optimizer("adam", 1e-3), disc,
                                           tstep.make_optimizer("adam", 1e-3), device="cpu")
        m = g["microbatches"]
        step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                           disc, g["config"], num_microbatches=m, mesh=mesh)
        draws = iter(g.get("draws", ()))

        def normal(shape, generator, device):
            x = next(draws)
            assert tuple(x.shape) == tuple(shape), (x.shape, shape)
            return x

        with (mock.patch.object(tstep, "_normal", normal) if "draws" in g
              else contextlib.nullcontext()):
            _, scalars = step(state, parallel.shard_batch(g["batch"], mesh, m),
                              torch.Generator().manual_seed(g["seed"]), g.get("rotations"),
                              input_noise_weight=1.0)
        out[label] = {"scalars": scalars, "params": {
            f"{name}.{k}": v.detach().clone() for name, mod in {**mods, "disc": disc}.items()
            for k, v in mod.state_dict().items()}}


def train_tool(inputs, out):
    """``train_reconstruct.main`` with ``--data-parallel``, one step; counts
    each rank's checkpoint writes."""
    from latentfusion_tpu_torch import train_reconstruct
    from latentfusion_tpu_torch.train import trainer

    writes = []
    real = trainer.save_checkpoint
    with mock.patch.object(trainer, "save_checkpoint",
                           lambda path, payload: (writes.append(str(path)),
                                                  real(path, payload))):
        done = train_reconstruct.main(inputs["tool_argv"])
    out["tool"] = {"writes": writes, "params": {
        k: v.detach().clone() for k, v in done.photographer.state_dict().items()},
        "step": done.state.step}


def main():
    folder, rank, world = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{folder / 'rendezvous'}",
                            rank=rank, world_size=world)
    inputs = torch.load(folder / "inputs.pt", weights_only=False)
    out = {}
    try:
        for task in (estimators, tp_decode, train_steps, recon_step, train_tool):
            task(inputs, out)
    except Exception:
        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, folder / f"rank{rank}.pt")
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
