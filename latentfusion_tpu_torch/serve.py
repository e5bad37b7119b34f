"""Pose-estimation service (counterpart of ``tools/serve_pose.py``): load a
model once, register objects, then answer line-delimited JSON requests on
stdin/stdout (``--stdio``) or a local TCP socket (``--port``).

    python -m latentfusion_tpu_torch.serve --stdio --demo-tiny --device cpu
    python -m latentfusion_tpu_torch.serve --stdio \\
        --demo-npz artifacts/encoder_distill/encoder_distill.npz

The service runs on the GPU unless ``--device cpu`` asks for the CPU; it
does not fall back to the CPU.

Protocol (one JSON object per line; an ``id`` is echoed):

  {"cmd": "register", "object": "mug", "npz": "refs.npz"}
      Build and keep the latent object of the reference views.
  {"cmd": "estimate", "object": "mug", "npz": "frame.npz", "top_k": 8,
   "seed": 0}
      Coarse then fine pose of one target frame. With "npz": [f1, f2, ...]
      the frames are estimated together against the object's latent
      (``estimate_batch``); with "object": [a, b, ...] and a list of frames
      of the same length, frame i against object i's latent. Those answer
      with "poses", one per frame.
  {"cmd": "ping"} / {"cmd": "shutdown"}

npz layout: color (V, 3, H, W) in [0, 1], depth (V, 1, H, W) or (V, H, W)
in meters, mask like depth, intrinsic (3, 3) or (V, 3, 3), extrinsic
(V, 4, 4) (the reference views' poses; ignored for a target frame).

Responses: {"ok": true, "id": ..., "extrinsic": [[...]], "translation":
[...], "log_quaternion": [...], "seconds": ...} or {"ok": false, "id": ...,
"error": "..."}. A failed request is answered so and the service keeps
running. A request's ``seed`` seeds a ``torch.Generator`` on the model's
device for the coarse search's draws.
"""
from __future__ import annotations

import argparse
import json
import logging
import socket
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .camera import Camera
from .device import resolve_device
from .observation import Observation
from .pose import estimation
from .recon.inference import LatentFusionModel

logger = logging.getLogger(__name__)
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", type=Path, default=None,
                   help="reference-schema model checkpoint (.pth)")
    p.add_argument("--demo-tiny", action="store_true",
                   help="serve the tiny family with weights drawn from seed 0 "
                        "(protocol and latency checks without weights)")
    p.add_argument("--demo-npz", type=Path, default=None,
                   help="learned demo-family parameters (npz of enumerated "
                        "leaves, with <stem>_keys.json beside it), e.g. "
                        "artifacts/encoder_distill/encoder_distill.npz")
    p.add_argument("--coarse-config", type=Path,
                   default=CONFIGS / "cross_entropy_quick.toml")
    p.add_argument("--fine-config", type=Path, default=CONFIGS / "adam_quick.toml")
    p.add_argument("--coarse-json", type=str, default=None,
                   help="inline JSON estimator config overriding --coarse-config")
    p.add_argument("--fine-json", type=str, default=None)
    p.add_argument("--top-k", type=int, default=8)
    p.add_argument("--stdio", action="store_true",
                   help="serve on stdin/stdout (the default without --port)")
    p.add_argument("--port", type=int, default=None,
                   help="serve on 127.0.0.1:PORT, one connection at a time")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; there is no fallback")
    return p.parse_args(argv)


def load_model(args) -> LatentFusionModel:
    """The model that ``--demo-tiny``, ``--demo-npz`` or ``--checkpoint``
    names, on ``--device``."""
    from . import zoo

    device = resolve_device(args.device)
    if args.demo_tiny:
        gen = torch.Generator().manual_seed(0)
        return LatentFusionModel(
            zoo.tiny_sculptor(device=device, generator=gen), None,
            zoo.tiny_fuser(device=device, generator=gen), None,
            zoo.tiny_photographer(device=device, generator=gen), None,
            camera_dist=1.5, device=device)
    if args.demo_npz is not None:
        from .recon.checkpoint import from_jax_params, load_params_npz, split_state_dict

        keys = args.demo_npz.with_name(args.demo_npz.stem + "_keys.json")
        state = split_state_dict(from_jax_params(load_params_npz(args.demo_npz, keys)))
        return LatentFusionModel(
            zoo.demo_sculptor(device=device), state["sculptor"],
            zoo.demo_fuser(device=device), state["fuser"],
            zoo.demo_photographer(device=device), state["photographer"],
            camera_dist=zoo.DEMO_CAMERA_DIST, device=device)
    if args.checkpoint is not None:
        return LatentFusionModel.from_checkpoint(args.checkpoint, device=device)
    raise SystemExit("need --checkpoint, --demo-npz or --demo-tiny")


def observation_from_npz(path, device) -> Observation:
    """The frames of an npz in the protocol's layout, on ``device``."""
    with np.load(path) as z:
        color, depth, mask, intrinsic, extrinsic = (
            np.asarray(z[k], np.float32)
            for k in ("color", "depth", "mask", "intrinsic", "extrinsic"))
    v, _, h, w = color.shape
    if depth.ndim == 3:
        depth = depth[:, None]
    if mask.ndim == 3:
        mask = mask[:, None]
    if intrinsic.ndim == 2:
        intrinsic = np.tile(intrinsic[None], (v, 1, 1))
    camera = Camera(intrinsic, extrinsic, width=w, height=h, device=device)
    return Observation(color, depth, mask, camera)


class PoseService:
    """A model, its coarse and fine estimators, and the registered objects'
    latents."""

    def __init__(self, model, coarse_config, fine_config, top_k: int = 8):
        self.model = model
        self.coarse = estimation.load_from_config(coarse_config, model)
        self.fine = estimation.load_from_config(fine_config, model)
        self.top_k = top_k
        self.latents = {}

    @classmethod
    def from_args(cls, args) -> "PoseService":
        coarse = json.loads(args.coarse_json) if args.coarse_json else args.coarse_config
        fine = json.loads(args.fine_json) if args.fine_json else args.fine_config
        return cls(load_model(args), coarse, fine, args.top_k)

    def handle(self, req: dict) -> dict:
        """One request's response; a failure is answered, not raised."""
        rid = req.get("id")
        t0 = time.perf_counter()
        try:
            cmd = req.get("cmd")
            if cmd == "ping":
                return {"ok": True, "id": rid, "objects": sorted(self.latents)}
            if cmd == "register":
                obs = observation_from_npz(req["npz"], self.model.device)
                self.latents[req["object"]] = self.model.build_latent_object(obs)
                return {"ok": True, "id": rid, "object": req["object"],
                        "views": len(obs), "seconds": time.perf_counter() - t0}
            if cmd == "estimate":
                return {"ok": True, "id": rid, **self._estimate(req),
                        "seconds": time.perf_counter() - t0}
            if cmd == "shutdown":
                return {"ok": True, "id": rid, "shutdown": True}
            return {"ok": False, "id": rid, "error": f"unknown cmd {cmd!r}"}
        except Exception as e:  # noqa: BLE001 -- answer the failure, keep serving
            logger.exception("request failed")
            return {"ok": False, "id": rid, "error": f"{type(e).__name__}: {e}"}

    def _estimate(self, req) -> dict:
        generator = torch.Generator(device=self.model.device).manual_seed(
            int(req.get("seed", 0)))
        top_k = int(req.get("top_k", self.top_k))
        npz, obj = req["npz"], req["object"]
        if isinstance(obj, (list, tuple)):
            if not (isinstance(npz, (list, tuple)) and len(npz) == len(obj)):
                raise ValueError("object list needs a matching npz list")
            z_objs = [self.latents[o] for o in obj]
        elif isinstance(npz, (list, tuple)):
            z_objs = [self.latents[obj]] * len(npz)
        else:
            obs = observation_from_npz(npz, self.model.device)
            return self._pose_payload(self.estimate_one(self.latents[obj], obs, top_k,
                                                        generator))
        frames = [observation_from_npz(p, self.model.device) for p in npz]
        cams = self.estimate_batch(torch.cat(z_objs), frames, top_k, generator)
        return {"poses": [self._pose_payload(c) for c in cams]}

    def estimate_one(self, z_obj, obs, top_k, generator) -> Camera:
        """Coarse search, then refinement of its best ``top_k``."""
        coarse = self.coarse.estimate(z_obj, obs, generator=generator)
        return self.fine.estimate(z_obj, obs, camera=coarse[:top_k])

    def estimate_batch(self, z_objs, observations, top_k, generator) -> list:
        """Frame i against latent ``z_objs[i]``, all in the estimators'
        multi-object loops."""
        coarse = self.coarse.estimate_batch(z_objs, observations, generator=generator)
        return self.fine.estimate_batch(
            z_objs, observations, cameras=Camera.cat([c[:top_k] for c in coarse]))

    @staticmethod
    def _pose_payload(cams: Camera) -> dict:
        """The best (rank 0) pose of an estimate."""
        return {"extrinsic": cams.extrinsic[0].tolist(),
                "translation": cams.translation[0].tolist(),
                "log_quaternion": cams.log_quaternion[0].tolist()}


def serve_lines(service: PoseService, rfile, wfile) -> bool:
    """Answer each line of ``rfile`` on ``wfile``. Returns True after a
    ``shutdown``, False when the input ends."""
    for line in rfile:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            resp = {"ok": False, "error": f"bad json: {e}"}
        else:
            resp = (service.handle(req) if isinstance(req, dict)
                    else {"ok": False, "error": "a request is a JSON object"})
        wfile.write(json.dumps(resp) + "\n")
        wfile.flush()
        if resp.get("shutdown"):
            return True
    return False


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="%(message)s")
    args = parse_args(argv)
    service = PoseService.from_args(args)
    device = service.model.device
    logger.info("model ready on %s", torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")
    if args.port is None or args.stdio:
        serve_lines(service, sys.stdin, sys.stdout)
        return
    with socket.create_server(("127.0.0.1", args.port)) as srv:
        logger.info("listening on 127.0.0.1:%d", args.port)
        while True:
            conn, addr = srv.accept()
            logger.info("connection from %s", addr)
            with conn, conn.makefile("r", encoding="utf-8") as rfile, \
                    conn.makefile("w", encoding="utf-8") as wfile:
                try:
                    if serve_lines(service, rfile, wfile):
                        return
                except OSError as e:
                    # A dropped client leaves the model and its latents up.
                    logger.warning("client connection lost: %s", e)


if __name__ == "__main__":
    main()
