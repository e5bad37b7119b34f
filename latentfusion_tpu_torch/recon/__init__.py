"""Reconstruction models and the inference API (counterpart of
``latentfusion_tpu/recon``)."""
