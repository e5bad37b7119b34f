"""The example scripts (counterparts of ``examples/``), run as modules:
``python -m latentfusion_tpu_torch.examples.pose_estimation`` and
``python -m latentfusion_tpu_torch.examples.reconstruction``."""
