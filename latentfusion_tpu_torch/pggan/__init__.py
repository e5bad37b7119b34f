"""The PGGAN-style discriminators of the GAN training step (counterpart of
``latentfusion_tpu/pggan``; its encoder-decoder generator, which no tool
uses, is not ported)."""
from .discriminator import (Discriminator, DiscriminatorBlock,  # noqa: F401
                            MultiScaleDiscriminator, instance_norm_2d,
                            minibatch_mean_variance)
