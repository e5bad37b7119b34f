"""K1: trilinear 3D volume sampler, forward, d/dgrid and d/dvolume
(counterpart of ``latentfusion_tpu/ops/pallas_fused_sample.py:grid_sample_3d_fused``).

``grid_sample_3d_fused`` computes ``F.grid_sample(volume, grid,
mode="bilinear", align_corners=False)`` with zeros or border padding, for a
volume batch NV that divides the grid batch N: sample batch n reads volume
``n // (N // NV)``, so a latent shared by many hypothesis cameras is read in
place and never copied N times.

``grid_sample_3d_bwd_grid`` is its gradient with respect to the grid given
dL/dout (kernel K1-bwd-grid), ``grid_sample_3d_bwd_vol`` its gradient with
respect to the volume, summed over each volume's group of N / NV samples
(kernel K1-bwd-vol, which training needs), and ``grid_sample_3d`` the
differentiable function: an ``autograd.Function`` whose forward is K1-fwd
and whose backward is K1-bwd-grid and K1-bwd-vol.

On a CUDA tensor each wrapper launches its kernel of ``csrc/fused_sample.cu``
(see the note there) or raises; on a CPU tensor it runs its plain PyTorch
version, the same function written out as an explicit 8-corner gather (or
scatter). The forward has two kernels, chosen by the volume's size alone
(``fwd_kernel``): the staged kernel, which copies chunks of channels into
shared memory, wherever one channel fits there (every zoo family's latent),
and the gather kernel, which reads the corners from L2, for larger volumes.
``LAUNCHES`` (staged), ``GATHER_LAUNCHES``, ``BWD_GRID_LAUNCHES`` and
``BWD_VOL_LAUNCHES`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .grid_sample import _unnormalize

LAUNCHES = 0
GATHER_LAUNCHES = 0
BWD_GRID_LAUNCHES = 0
BWD_VOL_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PADDING = ("zeros", "border")
# The staged kernel keeps at least 4 bytes of every voxel, the voxels
# rounded up to 32, in the 227 KB of shared memory a block may use.
_STAGED_MAX_VOXELS = 232448 // 4


def fwd_kernel(volume_shape) -> str:
    """The forward kernel that serves a volume of ``volume_shape`` (NV, C,
    D, H, W): "staged" or "gather"."""
    voxels = -(-int(volume_shape[2] * volume_shape[3] * volume_shape[4]) // 32) * 32
    return "staged" if voxels <= _STAGED_MAX_VOXELS else "gather"


def _check_shapes(volume_shape, grid, padding_mode):
    if len(volume_shape) != 5 or grid.dim() != 5 or grid.shape[-1] != 3:
        raise ValueError(f"expected volume (NV, C, D, H, W) and grid "
                         f"(N, Do, Ho, Wo, 3), got {tuple(volume_shape)} and "
                         f"{tuple(grid.shape)}")
    if grid.shape[0] % volume_shape[0] != 0:
        raise ValueError(f"volume batch {volume_shape[0]} must divide grid "
                         f"batch {grid.shape[0]}")
    if padding_mode not in _PADDING:
        raise ValueError(f"padding_mode must be one of {_PADDING}")
    if grid.dtype != torch.float32:
        raise TypeError("grid must be float32")


def _check_g(g, volume_shape, grid):
    out_shape = (grid.shape[0], volume_shape[1], *grid.shape[1:4])
    if tuple(g.shape) != out_shape:
        raise ValueError(f"g {tuple(g.shape)} does not match the output "
                         f"{out_shape}")
    if g.dtype not in _DTYPE_CODES:
        raise TypeError("g must be float32 or bfloat16")
    if g.device != grid.device:
        raise ValueError("grid and g must be on one device")


def _check_args(volume, grid, padding_mode, out_dtype):
    _check_shapes(volume.shape, grid, padding_mode)
    if volume.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError("volume and output must be float32 or bfloat16")
    if volume.device != grid.device:
        raise ValueError("volume and grid must be on one device")


def grid_sample_3d_plain(volume: torch.Tensor, grid: torch.Tensor,
                         padding_mode: str = "zeros",
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: an explicit 8-corner gather,
    fp32 weights and accumulation, rounded once to ``out_dtype``."""
    _check_args(volume, grid, padding_mode, out_dtype)
    nv, c = volume.shape[:2]
    n = grid.shape[0]
    vol_cj = volume.float().transpose(0, 1).reshape(c, -1)
    acc = torch.zeros(c, n * grid[0, ..., 0].numel(), dtype=torch.float32,
                      device=volume.device)
    for idx, weight in _corners(volume.shape, grid, padding_mode):
        acc.addcmul_(vol_cj[:, idx], weight[None])
    out = acc.reshape(c, n, -1).transpose(0, 1).to(out_dtype)
    return out.reshape(n, c, *grid.shape[1:4])


def _corners(volume_shape, grid, padding_mode):
    """The 8 trilinear corners of every sample: (index into the (C, NV*J)
    view of the volume, weight), each flat over the N*K samples. Sample
    batch n reads volume n // (N / NV), so no per-hypothesis copy of a
    shared volume is made. Corners outside the volume get weight 0 and a
    clamped index."""
    nv, _, d, h, w = volume_shape
    n = grid.shape[0]
    gr = grid.reshape(n, -1, 3)

    def taps(coord, size):
        x = _unnormalize(coord, size)
        if padding_mode == "border":
            x = x.clamp(0.0, size - 1)
        x0 = torch.floor(x)
        w1 = x - x0
        out = []
        for offset, weight in ((0, 1.0 - w1), (1, w1)):
            i = x0 + offset
            valid = (i >= 0) & (i <= size - 1)
            out.append((i.clamp(0, size - 1).long(), weight * valid))
        return out

    tx, ty, tz = taps(gr[..., 0], w), taps(gr[..., 1], h), taps(gr[..., 2], d)
    base = (torch.arange(n, device=grid.device) // (n // nv) * (d * h * w))[:, None]
    for iz, wz in tz:
        for iy, wy in ty:
            for ix, wx in tx:
                yield ((base + (iz * h + iy) * w + ix).reshape(-1),
                       (wz * wy * wx).reshape(-1))


def grid_sample_3d_fused(volume: torch.Tensor, grid: torch.Tensor,
                         padding_mode: str = "zeros",
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sample ``volume`` (NV, C, D, H, W) at ``grid`` (N, Do, Ho, Wo, 3),
    NV | N. Returns (N, C, Do, Ho, Wo) in ``out_dtype``."""
    global LAUNCHES, GATHER_LAUNCHES
    if volume.device.type == "cpu":
        return grid_sample_3d_plain(volume, grid, padding_mode, out_dtype)
    if volume.device.type != "cuda":
        raise ValueError(f"unsupported device {volume.device}")
    _check_args(volume, grid, padding_mode, out_dtype)
    if not (volume.is_contiguous() and grid.is_contiguous()):
        raise ValueError("volume and grid must be contiguous")
    if torch.is_grad_enabled() and (volume.requires_grad or grid.requires_grad):
        raise RuntimeError("grid_sample_3d_fused is not differentiable; use "
                           "grid_sample_3d, whose backward is K1-bwd-grid")
    nv, c, d, h, w = volume.shape
    n = grid.shape[0]
    k = grid[0, ..., 0].numel()
    out = torch.empty((n, c, *grid.shape[1:4]), dtype=out_dtype,
                      device=volume.device)
    kernel = fwd_kernel(volume.shape)
    lib = _build.load("fused_sample")
    fn = getattr(lib, f"lf_fused_sample_fwd_{kernel}")
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 7
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(volume.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(volume.data_ptr(), grid.data_ptr(), out.data_ptr(),
                    nv, n, c, d, h, w, k, int(padding_mode == "border"),
                    _DTYPE_CODES[volume.dtype], _DTYPE_CODES[out_dtype],
                    stream)
    _build.check(lib, status, f"fused_sample_fwd_{kernel}")
    if kernel == "staged":
        LAUNCHES += 1
    else:
        GATHER_LAUNCHES += 1
    return out


def grid_sample_3d_bwd_grid_plain(volume: torch.Tensor, grid: torch.Tensor,
                                  g: torch.Tensor,
                                  padding_mode: str = "zeros") -> torch.Tensor:
    """The K1-bwd-grid kernel's function in plain PyTorch: dL/dgrid (N, Do,
    Ho, Wo, 3) fp32 of ``grid_sample_3d_plain(volume, grid)`` given dL/dout
    ``g`` (N, C, Do, Ho, Wo).

    Per axis the tap factors' derivative is -1 at the floor tap and +1 at
    the ceil tap, zero at a tap outside the volume (whose value is zero)
    and, with border padding, zero unless the unclipped coordinate lies in
    [0, size - 1]; times size / 2, the derivative of the [-1, 1] -> pixel
    map."""
    _check_args(volume, grid, padding_mode, torch.float32)
    nv, c, d, h, w = volume.shape
    n = grid.shape[0]
    j = d * h * w
    gr = grid.reshape(n, -1, 3)
    k = gr.shape[1]
    border = padding_mode == "border"

    def taps(coord, size):
        x = _unnormalize(coord, size)
        scale = size / 2.0
        if border:
            scale = scale * ((x >= 0) & (x <= size - 1))
            x = x.clamp(0.0, size - 1)
        x0 = torch.floor(x)
        w1 = x - x0
        out = []
        for offset, weight, sign in ((0, 1.0 - w1, -1.0), (1, w1, 1.0)):
            i = x0 + offset
            valid = (i >= 0) & (i <= size - 1)
            out.append((i.clamp(0, size - 1).long(), weight * valid,
                        sign * scale * valid))
        return out

    tx, ty, tz = taps(gr[..., 0], w), taps(gr[..., 1], h), taps(gr[..., 2], d)
    base = (torch.arange(n, device=grid.device) // (n // nv) * j)[:, None]
    vol_cj = volume.float().transpose(0, 1).reshape(c, nv * j)
    g_ck = g.float().reshape(n, c, k).transpose(0, 1).reshape(c, n * k)
    dgrid = torch.zeros(3, n * k, dtype=torch.float32, device=volume.device)
    for iz, wz, dz in tz:
        for iy, wy, dy in ty:
            for ix, wx, dx in tx:
                idx = base + (iz * h + iy) * w + ix
                s = (g_ck * vol_cj[:, idx.reshape(-1)]).sum(0)
                dgrid[0] += (dx * wy * wz).reshape(-1) * s
                dgrid[1] += (wx * dy * wz).reshape(-1) * s
                dgrid[2] += (wx * wy * dz).reshape(-1) * s
    return dgrid.T.reshape(grid.shape)


def grid_sample_3d_bwd_grid(volume: torch.Tensor, grid: torch.Tensor,
                            g: torch.Tensor,
                            padding_mode: str = "zeros") -> torch.Tensor:
    """dL/dgrid of ``grid_sample_3d_fused(volume, grid)`` given dL/dout
    ``g`` (N, C, Do, Ho, Wo); returns fp32 shaped like ``grid``."""
    global BWD_GRID_LAUNCHES
    if volume.device.type == "cpu":
        return grid_sample_3d_bwd_grid_plain(volume, grid, g, padding_mode)
    if volume.device.type != "cuda":
        raise ValueError(f"unsupported device {volume.device}")
    _check_args(volume, grid, padding_mode, torch.float32)
    _check_g(g, volume.shape, grid)
    nv, c, d, h, w = volume.shape
    n = grid.shape[0]
    if not (volume.is_contiguous() and grid.is_contiguous() and g.is_contiguous()):
        raise ValueError("volume, grid and g must be contiguous")
    k = grid[0, ..., 0].numel()
    dgrid = torch.empty(grid.shape, dtype=torch.float32, device=volume.device)
    lib = _build.load("fused_sample")
    fn = lib.lf_fused_sample_bwd_grid
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 7
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(volume.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(volume.data_ptr(), grid.data_ptr(), g.data_ptr(),
                    dgrid.data_ptr(), nv, n, c, d, h, w, k,
                    int(padding_mode == "border"), _DTYPE_CODES[volume.dtype],
                    _DTYPE_CODES[g.dtype], stream)
    _build.check(lib, status, "fused_sample_bwd_grid")
    BWD_GRID_LAUNCHES += 1
    return dgrid


def grid_sample_3d_bwd_vol_plain(grid: torch.Tensor, g: torch.Tensor,
                                 volume_shape,
                                 padding_mode: str = "zeros") -> torch.Tensor:
    """The K1-bwd-vol kernel's function in plain PyTorch: dL/dvolume
    (NV, C, D, H, W) fp32 of ``grid_sample_3d_plain(volume, grid)`` given
    dL/dout ``g`` (N, C, Do, Ho, Wo), for a volume of ``volume_shape``: each
    sample's g, times its 8 corner weights, added into its volume's voxels
    (``index_add_`` in a fixed order), summed over the N / NV samples of
    each volume's group."""
    _check_shapes(volume_shape, grid, padding_mode)
    _check_g(g, volume_shape, grid)
    nv, c, d, h, w = volume_shape
    n = grid.shape[0]
    g_ck = g.float().reshape(n, c, -1).transpose(0, 1).reshape(c, -1)
    dvol = torch.zeros(c, nv * d * h * w, dtype=torch.float32, device=grid.device)
    for idx, weight in _corners(volume_shape, grid, padding_mode):
        dvol.index_add_(1, idx, g_ck * weight[None])
    return dvol.reshape(c, nv, d, h, w).transpose(0, 1).contiguous()


def grid_sample_3d_bwd_vol(grid: torch.Tensor, g: torch.Tensor, volume_shape,
                           padding_mode: str = "zeros") -> torch.Tensor:
    """dL/dvolume of ``grid_sample_3d_fused(volume, grid)`` given dL/dout
    ``g`` (N, C, Do, Ho, Wo), for a volume of ``volume_shape`` (NV, C, D,
    H, W); returns fp32 of that shape."""
    global BWD_VOL_LAUNCHES
    volume_shape = tuple(int(s) for s in volume_shape)
    if grid.device.type == "cpu":
        return grid_sample_3d_bwd_vol_plain(grid, g, volume_shape, padding_mode)
    if grid.device.type != "cuda":
        raise ValueError(f"unsupported device {grid.device}")
    _check_shapes(volume_shape, grid, padding_mode)
    _check_g(g, volume_shape, grid)
    if not (grid.is_contiguous() and g.is_contiguous()):
        raise ValueError("grid and g must be contiguous")
    nv, c, d, h, w = volume_shape
    n = grid.shape[0]
    k = grid[0, ..., 0].numel()
    dvol = torch.empty(volume_shape, dtype=torch.float32, device=grid.device)
    lib = _build.load("fused_sample")
    fn = lib.lf_fused_sample_bwd_vol
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 7
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(grid.data_ptr(), g.data_ptr(), dvol.data_ptr(), nv, n, c,
                    d, h, w, k, int(padding_mode == "border"),
                    _DTYPE_CODES[g.dtype], stream)
    _build.check(lib, status, "fused_sample_bwd_vol")
    BWD_VOL_LAUNCHES += 1
    return dvol


class FusedSample3d(torch.autograd.Function):
    """Forward K1-fwd; backward K1-bwd-vol and K1-bwd-grid, each only when
    its input needs a gradient. Saves the volume and grid."""

    @staticmethod
    def forward(ctx, volume, grid, padding_mode):
        ctx.save_for_backward(volume, grid)
        ctx.padding_mode = padding_mode
        return grid_sample_3d_fused(volume, grid, padding_mode)

    @staticmethod
    def backward(ctx, g):
        volume, grid = ctx.saved_tensors
        g = g.contiguous()
        dvol = dgrid = None
        if ctx.needs_input_grad[0]:
            dvol = grid_sample_3d_bwd_vol(grid, g, volume.shape,
                                          ctx.padding_mode).to(volume.dtype)
        if ctx.needs_input_grad[1]:
            dgrid = grid_sample_3d_bwd_grid(volume, grid, g, ctx.padding_mode)
        return dvol, dgrid, None


def grid_sample_3d(volume: torch.Tensor, grid: torch.Tensor,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Differentiable (in ``volume`` and ``grid``) ``grid_sample_3d_fused``
    with fp32 output; see the module docstring."""
    return FusedSample3d.apply(volume.contiguous(), grid.contiguous(),
                               padding_mode)
