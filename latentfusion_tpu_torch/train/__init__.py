"""Training (counterpart of ``latentfusion_tpu/train``): the reconstruction step."""
