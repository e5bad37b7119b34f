"""Pose estimation (counterpart of ``latentfusion_tpu/pose``): coarse search
by the cross-entropy method, gradient refinement through the renderer, and
the accuracy metrics."""
from . import estimation, gmm, initialization, metrics, utils  # noqa: F401
