"""The port's CUDA kernels (K1 forward, d/dgrid and d/dvolume, K2 forward
and backward) against their plain PyTorch versions on the card, and the
resize's backward run to run.
Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false and
run on an NVIDIA GPU with ``python -m pytest tests/test_torch_cuda.py``.

Tolerances: fp32 outputs 1e-5 (same arithmetic, other summation order; for
K1-bwd-vol an order that its atomics change from run to run); bf16 outputs
one bf16 rounding step, 2^-7 relative to the largest value. The kernels
without atomics (K1-fwd, K1-bwd-grid, K2-fwd, K2-bwd) must also give the
same bits when run again.
"""
import numpy as np
import pytest
import torch

from latentfusion_tpu_torch import transforms, modules, zoo
from latentfusion_tpu_torch.camera import Camera
from latentfusion_tpu_torch.observation import Observation
from latentfusion_tpu_torch.ops import fused_sample, lrelu_pnorm
from latentfusion_tpu_torch.ops.interpolate import interpolate
from latentfusion_tpu_torch.recon.inference import LatentFusionModel

FP32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b):
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv,n,c,dhw,k", [
    (1, 8, 40, (16, 16, 16), (16, 16, 16)), (3, 6, 40, (16, 16, 16), (5, 7, 9)),
    (4, 4, 40, (16, 16, 16), (8, 8, 8)),
    (1, 8, 256, (16, 16, 16), (16, 16, 16)),    # flagship refinement decode
    (1, 128, 256, (16, 16, 16), (16, 16, 16)),  # flagship CEM render
    (2, 6, 20, (5, 7, 9), (6, 5, 4)),           # a non-cubic volume
    (4, 4, 64, (32, 32, 32), (32, 32, 32)),     # K3's shape
    (1, 2, 3, (40, 40, 40), (8, 8, 8)),         # a channel over 227 KB: gather
], ids=["shared", "groups", "unshared", "refine", "render", "noncubic", "k3", "gather"])
def test_k1_kernel_matches_plain(cuda, padding_mode, dtype, nv, n, c, dhw, k):
    g = torch.Generator(device=cuda).manual_seed(0)
    vol = torch.randn(nv, c, *dhw, generator=g, device=cuda).to(dtype)
    grid = torch.rand(n, *k, 3, generator=g, device=cuda) * 2.4 - 1.2
    counter = {"staged": "LAUNCHES", "gather": "GATHER_LAUNCHES"}[
        fused_sample.fwd_kernel(vol.shape)]
    assert (counter == "GATHER_LAUNCHES") == (dhw == (40, 40, 40))
    before = getattr(fused_sample, counter)
    out = fused_sample.grid_sample_3d_fused(vol, grid, padding_mode, dtype)
    torch.cuda.synchronize()
    assert getattr(fused_sample, counter) == before + 1
    ref = fused_sample.grid_sample_3d_plain(vol, grid, padding_mode, dtype)
    assert out.shape == ref.shape == (n, c, *k) and out.dtype == dtype
    assert _err(out, ref) <= (FP32_TOL if dtype == torch.float32 else BF16_TOL)
    assert torch.equal(fused_sample.grid_sample_3d_fused(vol, grid, padding_mode, dtype), out)


# The 8 shapes of a flagship refinement step's 19 calls (8 hypotheses).
REFINE_K2_SHAPES = [(8, 256, 16, 16, 16), (8, 256, 16, 16), (8, 512, 16, 16),
                    (8, 512, 8, 8), (8, 512, 4, 4), (8, 196, 32, 32),
                    (8, 128, 64, 64), (8, 64, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 196, 8, 8), (2, 256, 4, 4, 4), (3, 64, 33),
                                   (2, 5000, 3), *REFINE_K2_SHAPES])
def test_k2_kernel_matches_plain(cuda, dtype, shape):
    """Against the plain version, and the same bits when run again; C=5000
    overflows the channels a thread keeps in registers."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    before = lrelu_pnorm.LAUNCHES
    y, inv = lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8)
    torch.cuda.synchronize()
    assert lrelu_pnorm.LAUNCHES == before + 1
    y_ref, inv_ref = lrelu_pnorm.lrelu_pixel_norm_plain(x, 0.2, 1e-8)
    assert y.dtype == dtype and inv.shape == inv_ref.shape
    assert _err(y, y_ref) <= (FP32_TOL if dtype == torch.float32 else BF16_TOL)
    assert _err(inv, inv_ref) <= FP32_TOL
    y2, inv2 = lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8)
    assert torch.equal(y2, y) and torch.equal(inv2, inv)


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv,n,c,dhw,k", [
    (1, 8, 40, (16, 16, 16), (16, 16, 16)), (3, 6, 40, (16, 16, 16), (5, 7, 9)),
    (2, 6, 20, (5, 7, 9), (6, 5, 4)),          # a non-cubic volume, C not a multiple of 8
    (1, 8, 256, (16, 16, 16), (16, 16, 16)),   # flagship refinement, 8 hypotheses
    (4, 4, 64, (32, 32, 32), (32, 32, 32)),    # K3's shape: one channel staged at a time
    (1, 2, 8, (48, 48, 48), (16, 16, 16)),     # a channel over 227 KB: per sample
], ids=["shared", "groups", "noncubic", "refine", "k3", "per_sample"])
def test_k1_bwd_grid_kernel_matches_plain(cuda, padding_mode, dtype, nv, n, c, dhw, k):
    """Against the plain version through the kernel its volume routes to,
    and the same bits when run again."""
    g = torch.Generator(device=cuda).manual_seed(0)
    vol = torch.randn(nv, c, *dhw, generator=g, device=cuda).to(dtype)
    grid = torch.rand(n, *k, 3, generator=g, device=cuda) * 2.4 - 1.2
    gout = torch.randn(n, c, *k, generator=g, device=cuda).to(dtype)
    counter = {"staged": "BWD_GRID_LAUNCHES", "per_sample": "BWD_GRID_PER_SAMPLE_LAUNCHES"}[
        fused_sample.bwd_grid_kernel(vol.shape)]
    assert (counter == "BWD_GRID_PER_SAMPLE_LAUNCHES") == (dhw == (48, 48, 48))
    before = getattr(fused_sample, counter)
    out = fused_sample.grid_sample_3d_bwd_grid(vol, grid, gout, padding_mode)
    torch.cuda.synchronize()
    assert getattr(fused_sample, counter) == before + 1
    ref = fused_sample.grid_sample_3d_bwd_grid_plain(vol, grid, gout, padding_mode)
    assert out.shape == grid.shape and out.dtype == torch.float32
    assert _err(out, ref) <= FP32_TOL
    assert torch.equal(fused_sample.grid_sample_3d_bwd_grid(vol, grid, gout, padding_mode), out)


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv,n,c,k", [
    (1, 8, 16, (16, 16, 16)), (3, 6, 24, (5, 7, 9)), (2, 2, 20, (4, 4, 4)),
    (4, 96, 256, (16, 16, 16)),   # training decode: a latent per object, 24 views
    (32, 32, 256, (16, 16, 16)),  # training encode: one camera volume per view
], ids=["small_shared", "small_groups", "small_unshared", "train_decode", "train_encode"])
def test_k1_bwd_vol_kernel_matches_plain(cuda, padding_mode, dtype, nv, n, c, k):
    g = torch.Generator(device=cuda).manual_seed(4)
    grid = torch.rand(n, *k, 3, generator=g, device=cuda) * 2.4 - 1.2
    gout = torch.randn(n, c, *k, generator=g, device=cuda).to(dtype)
    shape = (nv, c, 16, 16, 16)
    before = fused_sample.BWD_VOL_LAUNCHES
    dvol = fused_sample.grid_sample_3d_bwd_vol(grid, gout, shape, padding_mode)
    torch.cuda.synchronize()
    assert fused_sample.BWD_VOL_LAUNCHES == before + 1
    assert dvol.dtype == torch.float32 and dvol.shape == shape
    ref = fused_sample.grid_sample_3d_bwd_vol_plain(grid, gout, shape, padding_mode)
    assert _err(dvol, ref) <= FP32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 196, 8, 8), (2, 256, 4, 4, 4), (3, 64, 33),
                                   (2, 7, 5), *REFINE_K2_SHAPES])
def test_k2_bwd_kernel_matches_plain(cuda, dtype, shape):
    """Against the plain version, and the same bits when run again."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    gy = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    _, inv = lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8)
    before = lrelu_pnorm.BWD_LAUNCHES
    dx = lrelu_pnorm.lrelu_pixel_norm_bwd(x, inv, gy, 0.2)
    torch.cuda.synchronize()
    assert lrelu_pnorm.BWD_LAUNCHES == before + 1
    ref = lrelu_pnorm.lrelu_pixel_norm_bwd_plain(x, inv, gy, 0.2)
    assert dx.dtype == dtype
    assert _err(dx, ref) <= (FP32_TOL if dtype == torch.float32 else BF16_TOL)
    assert torch.equal(lrelu_pnorm.lrelu_pixel_norm_bwd(x, inv, gy, 0.2), dx)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mode", [((8, 512, 4, 4), "bilinear"),
                                        ((8, 196, 32, 32), "bilinear"),
                                        ((2, 8, 4, 6, 8), "trilinear")])
def test_resize_backward_repeats_bits(cuda, shape, mode):
    """The resize's backward (matrix products, no atomics) gives the same
    bits run to run and agrees with F.interpolate's."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(*shape, generator=g, device=cuda)
    gy = torch.randn(*shape[:2], *(2 * d for d in shape[2:]), generator=g, device=cuda)

    def grad(fn):
        xx = x.clone().requires_grad_()
        return torch.autograd.grad(fn(xx), xx, gy)[0]

    dx = grad(lambda a: interpolate(a, scale_factor=2.0, mode=mode))
    assert torch.equal(dx, grad(lambda a: interpolate(a, scale_factor=2.0, mode=mode)))
    ref = grad(lambda a: torch.nn.functional.interpolate(
        a, scale_factor=2.0, mode=mode, align_corners=False))
    assert _err(dx, ref) <= FP32_TOL


@pytest.mark.cuda
def test_autograd_through_kernels_matches_plain(cuda):
    """Gradients through the two autograd Functions (forward and backward
    kernels, d/dvolume included) agree with autograd through the plain
    forward versions, and a direct call of a forward kernel on a tensor that
    requires a gradient is refused rather than cut out of the graph."""
    g = torch.Generator(device=cuda).manual_seed(0)
    vol = torch.randn(1, 24, 8, 8, 8, generator=g, device=cuda)
    grid = (torch.rand(4, 6, 6, 6, 3, generator=g, device=cuda) * 2.2 - 1.1).requires_grad_()
    x = torch.randn(4, 196, 6, 6, generator=g, device=cuda).requires_grad_()
    gs = torch.randn(4, 24, 6, 6, 6, generator=g, device=cuda)
    gx = torch.randn(4, 196, 6, 6, generator=g, device=cuda)
    for padding in ("zeros", "border"):
        k1 = fused_sample.BWD_GRID_LAUNCHES
        d, = torch.autograd.grad(fused_sample.grid_sample_3d(vol, grid, padding), grid, gs)
        assert fused_sample.BWD_GRID_LAUNCHES == k1 + 1
        ref, = torch.autograd.grad(fused_sample.grid_sample_3d_plain(vol, grid, padding),
                                   grid, gs)
        assert _err(d, ref) <= FP32_TOL
    k2 = lrelu_pnorm.BWD_LAUNCHES
    d, = torch.autograd.grad(lrelu_pnorm.lrelu_pixel_norm(x, 0.2, 1e-8), x, gx)
    assert lrelu_pnorm.BWD_LAUNCHES == k2 + 1
    ref, = torch.autograd.grad(lrelu_pnorm.lrelu_pixel_norm_plain(x, 0.2, 1e-8)[0], x, gx)
    assert _err(d, ref) <= FP32_TOL
    vol_t = vol.clone().requires_grad_()
    k1 = fused_sample.BWD_VOL_LAUNCHES
    dv, dg = torch.autograd.grad(fused_sample.grid_sample_3d(vol_t, grid), (vol_t, grid), gs)
    assert fused_sample.BWD_VOL_LAUNCHES == k1 + 1
    ref_v, ref_g = torch.autograd.grad(fused_sample.grid_sample_3d_plain(vol_t, grid),
                                       (vol_t, grid), gs)
    assert _err(dv, ref_v) <= FP32_TOL and _err(dg, ref_g) <= FP32_TOL
    with pytest.raises(RuntimeError, match="not differentiable"):
        fused_sample.grid_sample_3d_fused(vol, grid)
    with pytest.raises(RuntimeError, match="not differentiable"):
        lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8)


@pytest.mark.cuda
def test_tiny_slice_kernels_match_torch_backends(cuda):
    """The tiny build + render goes through both kernels and agrees with
    the same path on the plain versions (5e-4, networks)."""
    gen = torch.Generator().manual_seed(0)
    model = LatentFusionModel(zoo.tiny_sculptor(device=cuda, generator=gen), None,
                              zoo.tiny_fuser(device=cuda, generator=gen), None,
                              zoo.tiny_photographer(device=cuda, generator=gen),
                              None, camera_dist=1.5, device=cuda)
    rng = np.random.RandomState(0)
    K = np.tile(np.array([[64, 0, 32], [0, 64, 24], [0, 0, 1]], np.float32), (3, 1, 1))
    ext = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    ext[:, :3, 3] = [0.02, -0.01, 1.5]
    obs = Observation(rng.rand(3, 3, 48, 64), 1.5 + 0.1 * rng.rand(3, 1, 48, 64),
                      np.ones((3, 1, 48, 64)), Camera(K, ext, width=64, height=48,
                                                      device=cuda))
    cams = Camera(K, ext, width=64, height=48, device=cuda).zoom(None, 16, 1.5)
    k1, k2 = fused_sample.LAUNCHES, lrelu_pnorm.LAUNCHES
    z = model.build_latent_object(obs)
    y, _ = model.render_latent_object(z, cams)
    assert fused_sample.LAUNCHES > k1 and lrelu_pnorm.LAUNCHES > k2
    with transforms.volume_sample_backend("torch"), modules.lrelu_pnorm_backend("torch"):
        z_ref = model.build_latent_object(obs)
        y_ref, _ = model.render_latent_object(z_ref, cams)
    assert _err(z, z_ref) <= 5e-4
    for key in ("depth", "mask"):
        assert _err(y[key], y_ref[key]) <= 5e-4
