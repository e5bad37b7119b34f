"""The port's PGGAN encoder-decoder (``latentfusion_tpu_torch/pggan/generator.py``)
against the JAX package's on the CPU, at narrow widths, with JAX's weights
carried across by ``recon.checkpoint.from_jax_params``: outputs within
5e-4 of the largest value (the networks' tolerance), the input gradient of
the port's K2 path against its plain PyTorch version, and the parameter
names both ways. Budget: about 25 s on one worker.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu.pggan import generator as jgen

from latentfusion_tpu_torch import modules as tmodules
from latentfusion_tpu_torch.pggan import generator as tgen
from latentfusion_tpu_torch.recon.checkpoint import from_jax_params, to_jax_params

NET_TOL = 5e-4
CONFIG = (4, 8, 8)  # two halvings: 16^2 -> 4^2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def close_rel(a, b, tol=NET_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= tol * max(float(np.abs(b).max()), 1.0), err


def carried(params):
    """JAX's parameter tree as the port's state_dict."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return from_jax_params({jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})


CASES = {
    "default": dict(),
    "no skips, tanh": dict(skip_connections=False, output_activation="tanh"),
    "no style, clamp, nearest": dict(style_size=0, output_activation="clamp",
                                     scale_mode="nearest"),
    "intermediate inputs": dict(intermediate_inputs=True, style_size=3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_encoder_decoder_matches_jax(rng, case):
    kw = dict(in_channels=3, out_channels=2, block_config=CONFIG, **CASES[case])
    style = kw.get("style_size", 8)
    x = rng.randn(2, 3, 16, 16).astype(np.float32)
    z_style = rng.randn(2, style).astype(np.float32) if style else None
    jnet = jgen.EncoderDecoder(**kw)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       None if z_style is None else jnp.asarray(z_style))
    jy, jz = jnet.apply(params, jnp.asarray(x), None if z_style is None else jnp.asarray(z_style))

    net = tgen.EncoderDecoder(**kw, device="cpu")
    state = carried(params)
    # flax makes no parameters for the blocks a call does not reach: the
    # intermediate input and output heads the default levels do not read.
    unused = {k for k in net.state_dict() if k.startswith(
        ("encoder.input_blocks.1.", "encoder.input_blocks.2.", "decoder.output_blocks.0."))}
    assert set(state) == set(net.state_dict()) - (unused if kw.get("intermediate_inputs")
                                                  else set())
    net.load_state_dict(state, strict=False)
    y, z = net(torch.from_numpy(x), None if z_style is None else torch.from_numpy(z_style))
    close_rel(y.detach(), jy)
    close_rel(z.detach(), jz)
    back = to_jax_params({f"generator.{k}": v for k, v in net.state_dict().items()})
    assert from_jax_params(back).keys() == {f"generator.{k}" for k in net.state_dict()}


def test_encoder_intermediates_and_decoder_output_heads_match_jax(rng):
    """The encoder's intermediates, and a decoder with an output head per
    block (read at level 0). The JAX package's encoder at an input level
    above 0 and decoder at an output level above 0 fail on their own
    channel counts, so they are not compared."""
    x = rng.randn(1, 3, 16, 16).astype(np.float32)
    jenc = jgen.Encoder(3, CONFIG)
    p = jenc.init(jax.random.PRNGKey(1), jnp.asarray(x))
    jz, jmid = jenc.apply(p, jnp.asarray(x))
    enc = tgen.Encoder(3, CONFIG, device="cpu")
    enc.load_state_dict(carried(p))
    z, mid = enc(torch.from_numpy(x))
    close_rel(z.detach(), jz)
    for a, b in zip(mid, jmid):
        close_rel(a.detach(), b)

    jdec = jgen.Decoder(2, CONFIG, intermediate_outputs=True, style_size=0,
                        skip_connections=False)
    p = jdec.init(jax.random.PRNGKey(2), jz)
    dec = tgen.Decoder(2, CONFIG, intermediate_outputs=True, style_size=0,
                       skip_connections=False, device="cpu")
    state = carried(p)
    assert set(dec.state_dict()) - set(state) == {"output_blocks.0.conv.module.weight",
                                                 "output_blocks.0.conv.bias"}
    dec.load_state_dict(state, strict=False)
    close_rel(dec(z.detach()).detach(), jdec.apply(p, jz))


def test_generator_k2_path_gradient_matches_plain(rng):
    """Forward and input gradient through the K2 wrapper (its plain version
    on CPU tensors) against K2's plain PyTorch forward under autograd."""
    net = tgen.EncoderDecoder(3, 2, CONFIG, device="cpu", generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.randn(2, 3, 16, 16).astype(np.float32))
    style = torch.from_numpy(rng.randn(2, 8).astype(np.float32))

    def run(backend):
        xi = x.clone().requires_grad_()
        with tmodules.lrelu_pnorm_backend(backend):
            y, _ = net(xi, style)
        y.square().sum().backward()
        return y.detach(), xi.grad

    (y1, g1), (y2, g2) = run("hopper"), run("torch")
    close_rel(y1, y2, 1e-5)
    close_rel(g1, g2, NET_TOL)


def test_generator_refusals():
    net = tgen.Decoder(2, CONFIG, style_size=4, device="cpu")
    with pytest.raises(ValueError, match="z_style"):
        net(torch.zeros(1, 8, 4, 4), [torch.zeros(1, 8, 8, 8)] * 2)
    with pytest.raises(ValueError, match="activation"):
        tgen.Decoder(2, CONFIG, output_activation="relu", device="cpu")
