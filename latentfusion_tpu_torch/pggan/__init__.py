"""The PGGAN-style networks (counterpart of ``latentfusion_tpu/pggan``):
the discriminators of the GAN training step and the encoder-decoder
generator."""
from .discriminator import (Discriminator, DiscriminatorBlock,  # noqa: F401
                            MultiScaleDiscriminator, global_batch, instance_norm_2d,
                            minibatch_mean_variance)
from .generator import Decoder, Encoder, EncoderDecoder  # noqa: F401
