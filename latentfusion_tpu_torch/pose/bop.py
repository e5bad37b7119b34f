"""BOP camera JSON (counterpart of ``latentfusion_tpu/pose/bop.py``)."""
from __future__ import annotations

import json

import numpy as np
import torch

from .. import three


def load_intrinsics(path):
    """Per-frame (3, 4) intrinsics and depth scales of a BOP
    ``scene_camera.json``, in frame order."""
    with open(path) as f:
        data = json.load(f)
    intrinsics, depth_scales = [], []
    for key in sorted(int(k) for k in data):
        value = data[str(key)]
        k33 = torch.from_numpy(np.asarray(value["cam_K"], dtype=np.float32).reshape(3, 3))
        intrinsics.append(three.intrinsic_to_3x4(k33))
        depth_scales.append(value["depth_scale"])
    return intrinsics, depth_scales
