"""Pose estimators: Metropolis-Hastings, cross-entropy coarse search and
gradient refinement (counterpart of ``latentfusion_tpu/pose/estimation.py``).

Hypotheses are a batch axis of the decoder. Each estimator's loop serves
B objects at once (``estimate_batch``): object b owns the contiguous block
of hypotheses [b n, (b + 1) n) and its own latent, every iteration renders
all blocks in one decoder batch, and rankings, GMMs and convergence are
kept per object. ``estimate`` is the case B = 1. The cross-entropy method
fits its diagonal GMMs on the device (``pose/gmm.py``) and turns the
annealed elite count into per-sample weights. Gradient refinement keeps
the optimizer state, the per-hypothesis learning rates and plateau
counters, and the top-K rankings as batched tensors; its loop runs on the
host and reads one number from the device per step (the largest per-object
improvement of the best loss, for the convergence test). Random draws come
from a ``torch.Generator``. A ``latent`` loss weight scores the cosine
distance between the rendered 2D latent and the target's, autoencoded at
the hypothesis cameras (``compute_latent_code``).

``mesh=`` (a 1-D ``parallel.make_mesh(n, parallel.HYPOTHESIS_AXIS)``)
shards the hypotheses over the ranks, as the JAX package's ``mesh=``
does: every rank draws the full set from the same generator, scores its
part of each object's block (``parallel.HypothesisShard``), and the losses
and, in refinement, the camera gradients are gathered, so the GMM fits,
the elites, the Metropolis accept step, the rankings and the optimizer
steps are the same on every rank and every rank returns the unsharded
estimate. Where the ranks do not divide an object's hypotheses, every
rank scores them all, as the JAX package then leaves them unsharded.
"""
from __future__ import annotations

import contextlib
import logging
import math
from collections import defaultdict
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch

from .. import distances
from ..camera import Camera
from ..observation import Observation
from ..utils import ExponentialScheduler, LinearScheduler
from . import gmm as gmm_lib
from . import initialization
from . import utils as pu

DEFAULT_TRANSLATION_STD = 0.01
DEFAULT_QUATERION_STD = 10.0 / 180.0 * math.pi
OPTIMIZERS = ("adam", "adamw", "sgd", "adagrad")

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------- config
def load_from_config(config, model, **kwargs):
    """An estimator from a TOML file (``configs/*.toml``) or its parsed
    dict; ``kwargs`` override its ``[args]``."""
    if isinstance(config, (str, Path)):
        import tomllib

        with open(config, "rb") as f:
            config = tomllib.load(f)
    params = dict(config["args"])
    params.update(kwargs)
    kind = config["type"]
    if kind == "cross_entropy":
        return CrossEntropyPoseEstimator(model=model, **params,
                                         loss_weights=config["loss_weights"])
    if kind == "gradient":
        schedules = {k: load_schedules_from_config(v)
                     for k, v in config.get("loss_schedules", {}).items()}
        return GradientPoseEstimator(model=model, **params,
                                     loss_weights=config["loss_weights"],
                                     loss_schedules=schedules)
    if kind == "metropolis":
        return MetropolisPoseEstimator(model=model, **params,
                                       loss_weights=config["loss_weights"])
    raise ValueError(f"Unknown estimator type {kind}")


def load_schedules_from_config(config):
    config = dict(config)
    kind = config.pop("type")
    if kind == "exponential":
        return ExponentialScheduler(**config)
    if kind == "linear":
        return LinearScheduler(**config)
    raise ValueError(f"Unknown schedule type {kind}")


# ----------------------------------------------------------------------- loss
def _bce_with_logits(logits, targets):
    """Binary cross entropy with logits, in its stable form."""
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def default_pose_loss(target: Observation, z_pred_depth, z_pred_mask_logits,
                      z_pred_camera: Camera, z_pred_latent=None,
                      z_target_latent=None) -> Dict[str, torch.Tensor]:
    """Per-hypothesis fitness losses of zoomed renders against the full-frame
    target: ``depth`` (mean L1 of the mask-weighted depth), ``ov_depth``
    (the same over the overlap of the masks), ``iou``, ``mask`` (BCE) and,
    given both 2D latents, ``latent`` (their cosine distance)."""
    pred_depth, _ = z_pred_camera.uncrop(z_pred_depth, scale_mode="nearest")
    pred_mask_logits, _ = z_pred_camera.uncrop(z_pred_mask_logits,
                                               scale_mode="bilinear")
    pred_mask = torch.sigmoid(pred_mask_logits)
    pred_depth = pred_depth * pred_mask
    invalid_mask = (target.depth == 0) & (target.mask > 0.1)
    target = target.prepare()

    loss_dict = {}
    depth_loss = pu.zero_invalid_pixels((pred_depth - target.depth).abs(),
                                        invalid_mask)
    loss_dict["ov_depth"] = pu.reduce_loss_mask(depth_loss, pred_mask * target.mask)
    loss_dict["depth"] = depth_loss.mean(dim=(1, 2, 3))
    loss_dict["iou"] = pu.iou_loss(
        pred_mask, pu.zero_invalid_pixels(target.mask, invalid_mask))
    loss_dict["mask"] = _bce_with_logits(
        pred_mask_logits, target.mask.expand_as(pred_mask)).mean(dim=(1, 2, 3))
    if z_pred_latent is not None and z_target_latent is not None:
        zp = z_pred_latent.reshape(z_pred_latent.shape[0], -1)
        zt = z_target_latent.reshape(z_target_latent.shape[0], -1)
        loss_dict["latent"] = distances.cosine_distance(zp, zt.expand_as(zp))
    return loss_dict


def weigh_losses(loss_dict, weight_dict):
    """Weighted losses; a loss whose weight is 0 is left out."""
    out = {}
    for k, v in loss_dict.items():
        w = weight_dict.get(k, 0.0)
        if w == 0.0:
            continue
        out[k] = w * v
    return out


# -------------------------------------------------------------------- ranking
class Ranking(NamedTuple):
    """Top-K poses found so far, best first."""

    losses: torch.Tensor          # (K,)
    log_quaternion: torch.Tensor  # (K, 3)
    translation: torch.Tensor     # (K, 3)
    viewport: torch.Tensor        # (K, 4)
    steps: torch.Tensor           # (K,)


def plateau_lr_update(loss, lr, best, num_bad, *, threshold: float,
                      patience: int, factor: float):
    """One step of a per-hypothesis ``ReduceLROnPlateau`` (mode 'min',
    relative threshold, no cooldown). Returns the new (lr, best, num_bad)."""
    improved = loss < best * (1.0 - threshold)
    best = torch.where(improved, loss, best)
    num_bad = torch.where(improved, 0, num_bad + 1)
    reduce_now = num_bad > patience
    lr = torch.where(reduce_now, lr * factor, lr)
    num_bad = torch.where(reduce_now, 0, num_bad)
    return lr, best, num_bad


def init_ranking_batch(num_objects: int, k: int, device=None) -> Ranking:
    """An empty top-K ranking per object: every field has a leading object
    axis."""
    return Ranking(
        losses=torch.full((num_objects, k), math.inf, device=device),
        log_quaternion=torch.zeros(num_objects, k, 3, device=device),
        translation=torch.zeros(num_objects, k, 3, device=device),
        viewport=torch.zeros(num_objects, k, 4, device=device),
        steps=torch.full((num_objects, k), -1, dtype=torch.int32, device=device))


def update_ranking_batch(ranking: Ranking, losses, log_quaternion, translation,
                         viewport, step) -> tuple:
    """Merge candidates (B, N, ...) into the per-object rankings. Returns
    (ranking, delta), ``delta`` (B,) the improvement of each object's best
    loss (0 while it is not yet finite)."""
    k = ranking.losses.shape[1]
    all_losses = torch.cat((ranking.losses, losses), dim=1)
    idx = torch.argsort(all_losses, dim=1, stable=True)[:, :k]

    def take(old, new):
        cat = torch.cat((old, new), dim=1)
        ix = idx.reshape(*idx.shape, *(1,) * (cat.dim() - 2)).expand(-1, -1, *cat.shape[2:])
        return torch.gather(cat, 1, ix)

    steps = torch.full(losses.shape, int(step), dtype=torch.int32,
                       device=losses.device)
    new = Ranking(torch.gather(all_losses, 1, idx),
                  take(ranking.log_quaternion, log_quaternion),
                  take(ranking.translation, translation),
                  take(ranking.viewport, viewport),
                  take(ranking.steps, steps))
    prev_best = ranking.losses[:, 0]
    delta = (prev_best - new.losses[:, 0]).clamp_min(0.0)
    delta = torch.where(torch.isfinite(prev_best), delta, torch.zeros_like(delta))
    return new, delta


def init_ranking(k: int, device=None) -> Ranking:
    return Ranking(*(leaf[0] for leaf in init_ranking_batch(1, k, device)))


def update_ranking(ranking: Ranking, losses, camera: Camera, step) -> tuple:
    """Merge the cameras' poses and losses (N,) into the ranking. Returns
    (ranking, delta)."""
    new, delta = update_ranking_batch(
        Ranking(*(leaf[None] for leaf in ranking)), losses[None],
        camera.log_quaternion[None], camera.translation[None],
        camera.viewport[None], step)
    return Ranking(*(leaf[0] for leaf in new)), delta[0]


def ranking_to_camera(ranking: Ranking, template: Camera) -> Camera:
    k = ranking.losses.shape[0]
    return Camera(template.intrinsic[:1].expand(k, *template.intrinsic.shape[1:]),
                  None, template.z_span, ranking.viewport,
                  log_quaternion=ranking.log_quaternion,
                  translation=ranking.translation, width=template.width,
                  height=template.height, device=template.device)


def finish_batch(ranking: Ranking, templates: Camera, stride: int) -> list:
    """Per-object rankings (every field with a leading object axis) as a
    list of cameras, best first; object b's intrinsic, frame and z span
    from ``templates[b * stride]``."""
    return [ranking_to_camera(Ranking(*(leaf[b] for leaf in ranking)),
                              templates[b * stride])
            for b in range(ranking.losses.shape[0])]


def _flat_views(z_lat):
    """A decode's (B, V, ...) latent as (B V, ...); None where the model
    gives none."""
    return None if z_lat is None else z_lat.reshape(-1, *z_lat.shape[2:])


def repeat_frames(target: Observation, n: int) -> Observation:
    """Each frame of ``target`` ``n`` times in a row, so that hypothesis
    b n + i meets object b's frame. A single frame is left as it is: the
    losses broadcast it."""
    if len(target) == 1:
        return target
    return Observation(target.color.repeat_interleave(n, dim=0),
                       target.depth.repeat_interleave(n, dim=0),
                       target.mask.repeat_interleave(n, dim=0),
                       target.camera.repeat_interleave(n), **target.meta)


# ----------------------------------------------------------------------- base
class PoseEstimator:
    """Renders hypothesis cameras with ``model.decode_latent`` and scores
    them against a target observation."""

    def __init__(self, *, model, ranking_size, loss_weights, loss_func=None, mesh=None):
        self.model = model
        self.ranking_size = ranking_size
        self.loss_func = loss_func or default_pose_loss
        self.loss_weights = defaultdict(float)
        self.loss_weights.update(loss_weights)
        self.mesh = mesh

    def _shard(self, num_objects: int, n: int):
        """This rank's part of ``num_objects`` blocks of ``n`` hypotheses,
        or None without a mesh or where its ranks do not divide ``n``."""
        if self.mesh is None:
            return None
        from ..parallel import HypothesisShard

        if n % self.mesh.size():
            logger.info("%d hypotheses do not split over %d ranks: each scores all",
                        n, self.mesh.size())
            return None
        return HypothesisShard(self.mesh, num_objects, n)

    def _score_all(self, shard, z_obj, target_obs, camera, z_target_latent=None,
                   latent_at_camera=False):
        """The weighted loss (N,) of every hypothesis. With a ``shard`` this
        rank scores its part and the parts are gathered. ``latent_at_camera``
        autoencodes the target's latent at each (scored) camera."""
        if shard is not None:
            target_obs, camera, z_target_latent = (
                shard.take(x) for x in (target_obs, camera, z_target_latent))
        if latent_at_camera:
            z_target_latent = self._maybe_latent_code(target_obs, camera)
        loss, _ = self._score_hypotheses(z_obj, target_obs, camera, z_target_latent)
        return loss if shard is None else shard.gather(loss)

    @property
    def device(self):
        return self.model.device

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        """The caller's generator, or one seeded with 0 on the model's device."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return generator

    @classmethod
    def initial_pose(cls, target_obs: Observation) -> Camera:
        """The translation from the target's depth and mask, no rotation."""
        return initialization.estimate_initial_pose(
            target_obs.depth, target_obs.mask, target_obs.camera.intrinsic,
            target_obs.camera.width, target_obs.camera.height)

    def estimate(self, z_obj, target_obs: Observation, **kwargs):
        if len(target_obs) > 1:
            raise ValueError(
                "The pose can only be estimated for one observation at a time.")
        return self._estimate(z_obj, target_obs, **kwargs)

    def _estimate(self, z_obj, target_obs, **kwargs):
        raise NotImplementedError

    @staticmethod
    def _batch_inputs(z_objs, observations):
        """Stacked latents (B, 1, C, D, H, W) and the B targets collated."""
        if isinstance(z_objs, (list, tuple)):
            z_objs = torch.cat(list(z_objs))
        target = (Observation.collate(list(observations))
                  if isinstance(observations, (list, tuple)) else observations)
        if len(target) != z_objs.shape[0]:
            raise ValueError(f"got {z_objs.shape[0]} latents but {len(target)} "
                             f"observations")
        return z_objs, target

    def _batch_init_cameras(self, target: Observation, n: int, generator,
                            draws=None, upright=False, hemisphere=False):
        """For each frame b of ``target``: its initial pose and ``n``
        sunflower hypotheses around it. Returns (the B n hypotheses,
        object-major; the B initial poses). ``draws``, for tests that hold a
        loop to another implementation's random stream, gives each object's
        rotations by ``hypotheses(n, upright, hemisphere)``."""
        cams, inits = [], []
        for b in range(len(target)):
            init = self.initial_pose(target[b])
            inits.append(init)
            if draws is None:
                cams.append(pu.sample_cameras_with_estimate(
                    n, init, generator, upright=upright, hemisphere=hemisphere))
            else:
                quats = draws.hypotheses(n, upright, hemisphere).to(init.device)
                cams.append(pu.cameras_with_estimate(init, quats,
                                                     init.translation.expand(n, 3)))
        return Camera.cat(cams), Camera.cat(inits)

    def _maybe_latent_code(self, target_obs, camera):
        if self.loss_weights.get("latent", 0.0) > 0.0:
            return self.model.compute_latent_code(target_obs, camera)
        return None

    def _render_hypotheses(self, z_obj, camera: Camera):
        """Zoom the hypothesis cameras, decode with the hard mask gate, and
        return the metric depth times the soft mask, the mask logits, the
        Photographer's 2D latent and the zoomed cameras."""
        z_camera = camera.zoom(None, self.model.input_size, self.model.camera_dist)
        y, z_lat = self.model.decode_latent(z_obj, z_camera, return_latent=True,
                                            apply_mask=True)
        z_mask = y["mask"].reshape(-1, *y["mask"].shape[2:])
        z_mask_logits = y["mask_logits"].reshape(-1, *y["mask_logits"].shape[2:])
        z_depth = z_camera.denormalize_depth(
            y["depth"].reshape(-1, *y["depth"].shape[2:])) * z_mask
        return z_depth, z_mask_logits, _flat_views(z_lat), z_camera

    def _score_hypotheses(self, z_obj, target_obs, camera, z_target_latent=None):
        """Per-hypothesis weighted loss (N,) and the loss dict."""
        z_depth, z_mask_logits, z_lat, z_camera = self._render_hypotheses(z_obj, camera)
        loss_dict = self.loss_func(target_obs, z_depth, z_mask_logits, z_camera,
                                   z_pred_latent=z_lat, z_target_latent=z_target_latent)
        return sum(weigh_losses(loss_dict, self.loss_weights).values()), loss_dict


# ----------------------------------------------------------------- metropolis
def metropolis_temperature(step: int, mean_z: torch.Tensor, num_iters: int):
    """The annealing temperature at ``step``: from 0.1 / mean_z down to
    0.005 / mean_z at the last step, exponentially (the reference's
    ``ExponentialScheduler``), in fp32."""
    mean_lifetime = -(num_iters - 1) / math.log(0.005 / 0.1)
    return (0.1 / mean_z) * torch.exp(mean_z.new_tensor(-float(step)) / mean_lifetime)


def metropolis_accept(prev_error, loss, temperature, uniforms):
    """The Metropolis-Hastings rule: accept where exp((prev_error - loss) / T)
    is strictly above a U(0, 1) draw."""
    return torch.exp((prev_error - loss) / temperature) > uniforms


class MetropolisPoseEstimator(PoseEstimator):
    """Metropolis-Hastings chains with simulated annealing: one chain per
    hypothesis, each proposing a Gaussian perturbation of its pose every
    iteration; the top-K ranking keeps the chains' accepted states."""

    def __init__(self, *, num_samples, num_iters,
                 translation_std=DEFAULT_TRANSLATION_STD,
                 quaternion_std=DEFAULT_QUATERION_STD, **kwargs):
        super().__init__(**kwargs)
        self.num_samples = num_samples
        self.num_iters = num_iters
        self.translation_std = translation_std
        self.quaternion_std = quaternion_std

    def _estimate(self, z_obj, target_obs, generator=None, draws=None):
        """The top ``ranking_size`` cameras, best first, of ``num_samples``
        chains started from sunflower cameras around the initial
        translation. ``draws``, for tests that hold the loop to another
        implementation's random stream, replaces the generator's draws: its
        ``hypotheses(n, upright, hemisphere)`` the chains' initial rotations
        and its ``step(n)`` each iteration's translation and log-quaternion
        normals (n, 3) each and uniforms (n,)."""
        return self._run(z_obj, target_obs, generator, draws)[0]

    def estimate_batch(self, z_objs, observations, generator=None, draws=None):
        """``num_samples`` chains for each of B objects in one loop: object
        b's latent ``z_objs[b]`` against its target ``observations[b]``.
        One temperature from the mean of the objects' initial depths. Returns
        a list of B cameras (each object's ranking, best first)."""
        z_objs, target = self._batch_inputs(z_objs, observations)
        return self._run(z_objs, target, generator, draws)

    @torch.no_grad()
    def _run(self, z_obj, target, generator, draws):
        generator = self._generator(generator)
        num_objects, n = len(target), self.num_samples
        camera, inits = self._batch_init_cameras(target, n, generator, draws)
        mean_z = inits.translation[:, -1].mean()
        target_rep = repeat_frames(target, n)
        device = camera.device
        error = torch.full((num_objects * n,), 100.0, device=device)
        ranking = init_ranking_batch(num_objects, self.ranking_size, device)
        shard = self._shard(num_objects, n)
        for step in range(self.num_iters):
            temperature = metropolis_temperature(step, mean_z, self.num_iters)
            if draws is None:
                proposal = pu.perturb_camera(camera, self.translation_std,
                                             self.quaternion_std, generator)
                uniforms = torch.rand(error.shape, generator=generator,
                                      device=generator.device).to(device)
            else:
                noise_t, noise_q, uniforms = (x.to(device) for x in draws.step(len(error)))
                proposal = camera.replace(
                    translation=camera.translation + noise_t * self.translation_std,
                    log_quaternion=camera.log_quaternion + noise_q * self.quaternion_std)
            loss = self._score_all(shard, z_obj, target_rep, proposal,
                                   latent_at_camera=True)
            accept = metropolis_accept(error, loss, temperature, uniforms)
            camera = camera.replace(
                log_quaternion=torch.where(accept[:, None], proposal.log_quaternion,
                                           camera.log_quaternion),
                translation=torch.where(accept[:, None], proposal.translation,
                                        camera.translation))
            error = torch.where(accept, loss, error)
            ranking, _ = update_ranking_batch(
                ranking, error.reshape(num_objects, n),
                camera.log_quaternion.reshape(num_objects, n, 3),
                camera.translation.reshape(num_objects, n, 3),
                camera.viewport.reshape(num_objects, n, 4), step)
        return finish_batch(ranking, camera, n)


# ----------------------------------------------------------------------- CEM
class CrossEntropyPoseEstimator(PoseEstimator):
    """Cross-entropy method: draw poses from a GMM over (translation,
    log-quaternion), each also flipped about the three object axes when
    ``sample_flipped``, score them, and refit the GMM to the elites."""

    def __init__(self, *, num_samples, num_elites, num_iters,
                 num_gmm_components, learning_rate, sample_flipped=False,
                 init_hemisphere=False, init_upright=False,
                 translation_std=DEFAULT_TRANSLATION_STD,
                 quaternion_std=DEFAULT_QUATERION_STD, gmm_em_iters=25,
                 **kwargs):
        super().__init__(**kwargs)
        self.num_samples = num_samples
        self.num_elites = num_elites
        self.num_iters = num_iters
        self.num_gmm_components = num_gmm_components
        self.sample_flipped = sample_flipped
        self.init_upright = init_upright
        self.init_hemisphere = init_hemisphere
        self.learning_rate = learning_rate
        self.translation_std = translation_std
        self.quaternion_std = quaternion_std
        self.gmm_em_iters = gmm_em_iters
        self.elite_sched = ExponentialScheduler(num_samples, num_elites, num_iters)

    def _elite_table(self):
        """The annealed elite count of each iteration, truncated to an int."""
        return [int(self.elite_sched.get(s)) for s in range(self.num_iters)]

    @staticmethod
    def _camera_to_params(camera: Camera) -> torch.Tensor:
        return torch.cat((camera.translation, camera.log_quaternion), dim=-1)

    @staticmethod
    def _params_to_camera(params, templates: Camera) -> Camera:
        """Cameras of params (B, n, 6), object-major, each with its object's
        intrinsic, frame and z span from ``templates`` (B), full viewports."""
        n = params.shape[1]
        return Camera(templates.intrinsic.repeat_interleave(n, dim=0), None,
                      templates.z_span, translation=params[..., :3].reshape(-1, 3),
                      log_quaternion=params[..., 3:].reshape(-1, 3),
                      width=templates.width, height=templates.height,
                      device=templates.device)

    @staticmethod
    def _with_flips(cameras: Camera, num_objects: int) -> Camera:
        """The cameras and their flips about the z, y and x object axes,
        reordered so that each object's hypotheses stay one block: object
        b's draws, then their three flips."""
        variants = Camera.cat([cameras] + [
            pu.flip_camera(cameras, axis)
            for axis in ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0))])
        order = torch.arange(len(variants), device=cameras.device)
        return variants[order.reshape(4, num_objects, -1).transpose(0, 1).reshape(-1)]

    def _sample_poses(self, sample_gmm, num_draw, generator, draws):
        """``num_draw`` poses (B, num_draw, 6) of each object's GMM, plus
        the pose noise."""
        if draws is None:
            params = gmm_lib.sample(sample_gmm, num_draw, generator)
            noise = torch.randn(params.shape, generator=generator,
                                device=generator.device).to(params.device)
        else:
            device = sample_gmm.means.device
            comp, eps, noise = (x.to(device) for x in draws.sample(sample_gmm.weights,
                                                                   num_draw))
            params = gmm_lib.sample_from(sample_gmm, comp, eps)
        std = torch.tensor([self.translation_std] * 3 + [self.quaternion_std] * 3,
                           device=params.device)
        return params + noise * std

    @staticmethod
    def _fit(data, fit, draws, sample_weights=None):
        init_means = None
        if draws is not None:
            w = (torch.ones(data.shape[:2], device=data.device) if sample_weights is None
                 else sample_weights)
            idx = draws.init_index(w / w.sum(dim=1, keepdim=True)).to(data.device)
            init_means = torch.gather(data, 1, idx[..., None].expand(-1, -1, data.shape[-1]))
        return gmm_lib.fit(data, sample_weights=sample_weights,
                           init_means=init_means, **fit)

    def _estimate(self, z_obj, target_obs, generator=None, cameras=None,
                  draws=None):
        """Returns the top ``ranking_size`` cameras, best first. The initial
        GMM is fitted to ``cameras`` or, by default, to
        ``num_gmm_components * num_samples`` sunflower cameras around the
        initial translation.

        ``draws``, for tests that hold the loop to another implementation's
        random stream, replaces the generator's draws inside the loop: its
        ``init_index(weights)`` gives, for weights (B, N), the data indices
        (B, K) at which each fit starts its means, its ``sample(weights,
        n)`` each iteration's component indices (B, n), unit normals
        (B, n, 6) and pose noise (B, n, 6), and, without ``cameras``, its
        ``hypotheses(n, upright, hemisphere)`` the initial rotations."""
        generator = self._generator(generator)
        if cameras is None:
            cameras, templates = self._init_cameras(target_obs, generator, draws)
        else:
            templates = cameras[0]
        return self._run(z_obj, target_obs, cameras, templates, generator, draws)[0]

    def estimate_batch(self, z_objs, observations, generator=None, draws=None):
        """Coarse search for B objects in one loop: object b's latent
        ``z_objs[b]`` against its target ``observations[b]``, each with its
        own GMM, elites and ranking, every iteration's renders in one
        decoder batch. Returns a list of B cameras (each object's ranking,
        best first)."""
        z_objs, target = self._batch_inputs(z_objs, observations)
        generator = self._generator(generator)
        cameras, templates = self._init_cameras(target, generator, draws)
        return self._run(z_objs, target, cameras, templates, generator, draws)

    def _init_cameras(self, target, generator, draws):
        return self._batch_init_cameras(
            target, self.num_gmm_components * self.num_samples, generator, draws,
            upright=self.init_upright, hemisphere=self.init_hemisphere)

    @torch.no_grad()
    def _run(self, z_obj, target, init_cameras, templates, generator, draws):
        """The loop for the B = ``len(templates)`` objects of ``target``,
        from their initial cameras (object-major). Returns the B rankings as
        cameras."""
        num_objects, n = len(templates), self.num_samples
        num_draw = n // 4 if self.sample_flipped else n
        elites = self._elite_table()
        fit = dict(n_components=self.num_gmm_components, generator=generator,
                   n_iter=self.gmm_em_iters)
        data = self._camera_to_params(init_cameras).reshape(num_objects, -1, 6)
        prev_gmm = cur_gmm = self._fit(data, fit, draws)
        target_rep = repeat_frames(target, n)
        ranking = init_ranking_batch(num_objects, self.ranking_size, templates.device)
        shard = self._shard(num_objects, n)
        for step in range(self.num_iters):
            sample_gmm = gmm_lib.blend(prev_gmm, cur_gmm, self.learning_rate)
            params = self._sample_poses(sample_gmm, num_draw, generator, draws)
            cameras = self._params_to_camera(params, templates)
            if self.sample_flipped:
                cameras = self._with_flips(cameras, num_objects)
            # One target latent per object, at the first camera of its block.
            z_target_latent = self._maybe_latent_code(target, cameras[::n])
            if z_target_latent is not None:
                z_target_latent = z_target_latent.repeat_interleave(n, dim=0)
            loss = self._score_all(shard, z_obj, target_rep, cameras, z_target_latent)
            loss = loss.reshape(num_objects, n)
            order = torch.argsort(loss, dim=1, stable=True)
            rank_of = torch.empty_like(order).scatter_(
                1, order, torch.arange(n, device=order.device).expand_as(order))
            elite_w = (rank_of < elites[step]).float()
            new_gmm = self._fit(self._camera_to_params(cameras).reshape(num_objects, n, 6),
                                fit, draws, sample_weights=elite_w)
            ranking, _ = update_ranking_batch(
                ranking, loss, cameras.log_quaternion.reshape(num_objects, n, 3),
                cameras.translation.reshape(num_objects, n, 3),
                cameras.viewport.reshape(num_objects, n, 4), step)
            prev_gmm, cur_gmm = cur_gmm, new_gmm
        return finish_batch(ranking, templates, 1)


# ------------------------------------------------------------------- gradient
@contextlib.contextmanager
def deterministic_cudnn():
    """Select cuDNN's deterministic convolution algorithms, then restore the
    caller's choice. The backward-data algorithm that cuDNN picks by default
    for one of the flagship decoder's convolutions does not repeat its bits,
    so without this two refinements from the same cameras part. Only this flag
    changes: ``torch.backends.cudnn.flags`` would also reset ``enabled``
    and ``allow_tf32`` to its own defaults."""
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = previous


class GradientPoseEstimator(PoseEstimator):
    """Gradient refinement of the hypotheses' log-quaternion, translation
    and zoom viewport, with a per-hypothesis optimizer (Adam, AdamW, SGD or
    Adagrad), per-hypothesis ``ReduceLROnPlateau``, a top-K ranking and a
    convergence patience on the best loss."""

    def __init__(self, *, learning_rate, num_samples, num_iters,
                 converge_threshold, converge_patience,
                 lr_reduce_patience=25, lr_reduce_threshold=1e-5,
                 lr_reduce_factor=0.5, track_stats=False, loss_schedules=None,
                 optimizer="adamw", **kwargs):
        super().__init__(**kwargs)
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"Unknown optimizer {optimizer!r}")
        self.learning_rate = learning_rate
        self.num_samples = num_samples
        self.num_iters = num_iters
        self.optimizer = optimizer
        self.lr_reduce_patience = lr_reduce_patience
        self.lr_reduce_threshold = lr_reduce_threshold
        self.lr_reduce_factor = lr_reduce_factor
        self.converge_threshold = converge_threshold
        self.converge_patience = converge_patience
        self.loss_schedules = dict(loss_schedules or {})
        self.track_stats = track_stats

    def _weights_at(self, step):
        weights = dict(self.loss_weights)
        for k, sched in self.loss_schedules.items():
            weights[k] = sched.get(step)
        return weights

    def _estimate(self, z_obj, target_obs, camera=None, generator=None):
        """Refine ``camera`` (full-frame hypotheses; by default
        ``num_samples`` sunflower cameras around the initial translation).
        Returns the top ``ranking_size`` cameras, best first, and with
        ``track_stats`` also {"loss_history" (num_iters,), "num_steps"}."""
        results, stats = self._refine(z_obj, target_obs, camera, generator)
        if self.track_stats:
            return results[0], {**stats, "loss_history": stats["loss_history"][:, 0]}
        return results[0]

    def estimate_batch(self, z_objs, observations, generator=None, cameras=None):
        """Refine B objects in one loop: object b's latent ``z_objs[b]``
        against its target ``observations[b]``, from its block of
        ``cameras`` (B blocks of equal length, object-major; by default
        ``num_samples`` sunflower cameras around each object's initial
        translation). Each object's loss is normalised by its own hypothesis
        count, so its gradient is that of a single-object step; rankings,
        learning rates and the loss history (num_iters, B) are per object,
        and the loop stops once every object's best loss has stalled.
        Returns a list of B cameras, and with ``track_stats`` the stats."""
        z_objs, target = self._batch_inputs(z_objs, observations)
        results, stats = self._refine(z_objs, target, cameras, generator)
        return (results, stats) if self.track_stats else results

    def _refine(self, z_obj, target, camera, generator):
        if camera is None:
            camera, _ = self._batch_init_cameras(target, self.num_samples,
                                                 self._generator(generator))
        num_objects = len(target)
        camera = camera.zoom(None, self.model.input_size, self.model.camera_dist)
        ranking, stats = self._optimize_camera(z_obj, target, camera, num_objects)
        logger.info("best camera step=%s loss=%s", ranking.steps[:, 0],
                    ranking.losses[:, 0])
        return finish_batch(ranking, camera.uncrop(), len(camera) // num_objects), stats

    def loss_and_grads(self, z_obj, target_obs, camera: Camera, step: int = 0,
                       num_objects: int = 1, views: Optional[int] = None):
        """The per-hypothesis ranking loss (N,) of the zoomed ``camera`` and
        the gradient of the optimized loss (summed over hypotheses, divided
        by each object's hypothesis count, ``views``, by default N /
        ``num_objects``; a rank's part of the hypotheses passes the whole
        count) with respect
        to its log_quaternion, translation and viewport. With a ``latent``
        weight the target's latent is autoencoded at ``camera`` inside the
        differentiated loss. The forward and the backward run on cuDNN's
        deterministic algorithms, so a step repeats its bits
        (``deterministic_cudnn``)."""
        leaves = {k: v.detach().requires_grad_()
                  for k, v in pu.camera_params(camera, optimize_viewport=True).items()}
        with torch.enable_grad(), deterministic_cudnn():
            cam = camera.replace(**leaves)
            z_target_latent = self._maybe_latent_code(target_obs, cam)
            z_depth, z_mask_logits, z_lat = self._render_zoomed(z_obj, cam)
            loss_dict = self.loss_func(target_obs, z_depth, z_mask_logits, cam,
                                       z_pred_latent=z_lat,
                                       z_target_latent=z_target_latent)
            optim_loss = sum(weigh_losses(loss_dict, self._weights_at(step)).values())
            rank_loss = sum(weigh_losses(loss_dict, self.loss_weights).values())
            grads = torch.autograd.grad(optim_loss.sum() / (views or len(cam) // num_objects),
                                        list(leaves.values()))
        return rank_loss.detach(), dict(zip(leaves, grads))

    def _sharded_loss_and_grads(self, shard, z_obj, target_obs, camera, step,
                                num_objects, views):
        """``loss_and_grads`` of every hypothesis; with a ``shard`` this rank
        differentiates its part and the losses and gradients are gathered
        (one collective: packed side by side)."""
        if shard is None:
            return self.loss_and_grads(z_obj, target_obs, camera, step, num_objects)
        loss, grads = self.loss_and_grads(z_obj, shard.take(target_obs), shard.take(camera),
                                          step, num_objects, views)
        packed = shard.gather(torch.cat([loss[:, None], *grads.values()], dim=1))
        widths = [1] + [g.shape[1] for g in grads.values()]
        loss, *parts = torch.split(packed, widths, dim=1)
        return loss[:, 0], dict(zip(grads, parts))

    def _update(self, grads, params, opt_state, count):
        """The optimizer's step direction per leaf (before the learning rate)."""
        updates = {}
        for k, g in grads.items():
            if self.optimizer in ("adam", "adamw"):
                m, v = opt_state[k]
                m = (1 - 0.9) * g + 0.9 * m
                v = (1 - 0.999) * g * g + 0.999 * v
                opt_state[k] = (m, v)
                m_hat = m / (1 - 0.9 ** count)
                v_hat = v / (1 - 0.999 ** count)
                u = m_hat / (torch.sqrt(v_hat) + 1e-8)
                if self.optimizer == "adamw":
                    u = u + 0.01 * params[k]
            elif self.optimizer == "sgd":
                u = g
            else:
                s = opt_state[k][0] + g * g
                opt_state[k] = (s,)
                u = torch.where(s > 0, torch.rsqrt(s + 1e-10), 0.0) * g
            updates[k] = u
        return updates

    def _optimize_camera(self, z_obj, target_obs, camera: Camera, num_objects: int):
        total = len(camera)
        views = total // num_objects
        target_obs = repeat_frames(target_obs, views)
        device = camera.device
        params = {k: v.detach().clone()
                  for k, v in pu.camera_params(camera, optimize_viewport=True).items()}
        opt_state = {k: (torch.zeros_like(p), torch.zeros_like(p))
                     for k, p in params.items()}
        full_viewport = camera.uncrop().viewport
        lr = torch.full((total,), float(self.learning_rate), device=device)
        plateau_best = torch.full((total,), math.inf, device=device)
        num_bad = torch.zeros(total, dtype=torch.int64, device=device)
        ranking = init_ranking_batch(num_objects, self.ranking_size, device)
        history = torch.full((self.num_iters, num_objects), math.nan, device=device)
        step = converge_count = 0
        shard = self._shard(num_objects, views)
        while step < self.num_iters and converge_count < self.converge_patience:
            rank_loss, grads = self._sharded_loss_and_grads(
                shard, z_obj, target_obs, camera.replace(**params), step, num_objects, views)
            # The ranking keeps the pose that was rendered, before the update.
            rank_lq, rank_t = params["log_quaternion"], params["translation"]
            updates = self._update(grads, params, opt_state, step + 1)
            params = {k: p - lr[:, None] * updates[k] for k, p in params.items()}
            lr, plateau_best, num_bad = plateau_lr_update(
                rank_loss, lr, plateau_best, num_bad,
                threshold=self.lr_reduce_threshold,
                patience=self.lr_reduce_patience, factor=self.lr_reduce_factor)
            rank_loss = rank_loss.reshape(num_objects, views)
            ranking, delta = update_ranking_batch(
                ranking, rank_loss, rank_lq.reshape(num_objects, views, 3),
                rank_t.reshape(num_objects, views, 3),
                full_viewport.reshape(num_objects, views, 4), step)
            history[step] = rank_loss.min(dim=1).values
            # The loop stops once every object's best loss has stalled.
            delta = float(delta.max())
            if delta < self.converge_threshold:
                converge_count += 1
            elif delta > self.converge_threshold:
                converge_count = 0
            step += 1
        return ranking, {"loss_history": history, "num_steps": step}

    def _render_zoomed(self, z_obj, camera: Camera):
        """Decode at the (already zoomed) cameras with the hard mask gate;
        the metric depth is not multiplied by the soft mask here, unlike in
        ``_render_hypotheses``. Returns (depth, mask logits, 2D latent)."""
        y, z_lat = self.model.decode_latent(z_obj, camera, return_latent=True,
                                            apply_mask=True)
        z_mask_logits = y["mask_logits"].reshape(-1, *y["mask_logits"].shape[2:])
        z_depth = camera.denormalize_depth(y["depth"].reshape(-1, *y["depth"].shape[2:]))
        return z_depth, z_mask_logits, _flat_views(z_lat)
