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
scatter). Each of the three has two kernels, chosen by the volume's size
alone (``fwd_kernel``, ``bwd_grid_kernel``, ``bwd_vol_kernel``): for every
volume whose channel fits in shared memory (every zoo family's latent), a
kernel that keeps channels there (the forward's and d/dgrid's staged
kernels copy the volume in; d/dvol's tiled kernel sums into a tile of it),
and for larger volumes a kernel that reads or adds the corners in L2 (the
forward's gather kernel, d/dgrid's per-sample kernel, d/dvol's atomic
kernel, the one kernel whose bits change from run to run). d/dgrid's
staged kernel splits the channels into groups and adds the groups' partial
sums in a fixed order, by the plan of ``bwd_grid_plan``; d/dvol's tiled
kernel splits each volume's samples into slices and adds the slices'
partial sums in a fixed order, by the plan of ``bwd_vol_plan``.
``LAUNCHES`` (forward, staged), ``GATHER_LAUNCHES``, ``BWD_GRID_LAUNCHES``
(d/dgrid, staged), ``BWD_GRID_PER_SAMPLE_LAUNCHES``, ``BWD_VOL_LAUNCHES``
(d/dvol, tiled) and ``BWD_VOL_ATOMIC_LAUNCHES`` count kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from ..dtypes import get_compute_dtype
from .grid_sample import _unnormalize

LAUNCHES = 0
GATHER_LAUNCHES = 0
BWD_GRID_LAUNCHES = 0
BWD_GRID_PER_SAMPLE_LAUNCHES = 0
BWD_VOL_LAUNCHES = 0
BWD_VOL_ATOMIC_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PADDING = ("zeros", "border")
# The staged kernels keep at least 4 bytes of every voxel, the voxels
# rounded up to 32, in the 227 KB of shared memory a block may use; 32
# bytes (8 fp32 channels) where those fit (the forward: and the volume has
# more than one channel).
_SMEM_BYTES = 232448
# d/dgrid's staged kernel: a block of 512 threads walks up to 8 samples a
# thread, and takes an H100 SM to itself (its registers fill the register
# file), so the plan fills one wave of the 132 SMs.
_BWD_GRID_MAX_TILE = 4096
_SMS = 132
# d/dvol's tiled kernel: blocks of 256 threads walk their samples in stages
# of 256; an SM holds 228 KB of shared memory for its blocks, 1 KB of it
# reserved a block; a slice of samples is at least 16 stages long.
_VOL_STAGE = 256
_SM_SHARED_BYTES = 233472
_VOL_MIN_SLICE = 4096


def _padded_voxels(volume_shape) -> int:
    return -(-int(volume_shape[2] * volume_shape[3] * volume_shape[4]) // 32) * 32


def fwd_kernel(volume_shape) -> str:
    """The forward kernel that serves a volume of ``volume_shape`` (NV, C,
    D, H, W): "staged" or "gather"."""
    return "staged" if _padded_voxels(volume_shape) * 4 <= _SMEM_BYTES else "gather"


def bwd_grid_kernel(volume_shape) -> str:
    """The d/dgrid kernel that serves a volume of ``volume_shape``:
    "staged" or "per_sample"."""
    return "staged" if fwd_kernel(volume_shape) == "staged" else "per_sample"


class BwdGridPlan(NamedTuple):
    """How d/dgrid's staged kernel splits a call: blocks of ``tile``
    consecutive samples of one volume's group by groups of
    ``group_channels`` channels (whole chunks of ``chunk``, the channels
    staged at once), ``groups`` of them, whose partial sums are added in
    group order."""
    tile: int
    chunk: int
    group_channels: int
    groups: int
    blocks: int

    def channel_ranges(self, c: int):
        """Each group's channels [start, stop), in the order they are
        added."""
        return [(i * self.group_channels, min((i + 1) * self.group_channels, c))
                for i in range(self.groups)]


def bwd_grid_plan(volume_shape, n: int, k: int) -> BwdGridPlan:
    """The staged d/dgrid kernel's plan for a volume of ``volume_shape``
    and a grid of ``n`` batches of ``k`` samples: tiles as long as a block
    holds (so a block stages the volume's channels as few times as it can),
    and the channels split into as many groups as fit the tiles in one wave
    of blocks, one an SM. A group of more channels stages more chunks in
    turn; more groups write more partial sums."""
    nv, c = int(volume_shape[0]), int(volume_shape[1])
    if bwd_grid_kernel(volume_shape) != "staged":
        raise ValueError(f"volume {tuple(volume_shape)}: one channel does not "
                         f"fit in shared memory")
    chunk = 8 if _padded_voxels(volume_shape) * 32 <= _SMEM_BYTES else 1
    chunks = max(1, -(-c // chunk))
    per_volume = n // nv * k
    tile = min(_BWD_GRID_MAX_TILE, per_volume)
    tiles = nv * -(-per_volume // tile)
    groups = min(chunks, max(1, _SMS // tiles))
    group_channels = chunk * -(-chunks // groups)
    groups = max(1, -(-c // group_channels))
    return BwdGridPlan(tile, chunk, group_channels, groups, tiles * groups)


def _class_pitches(volume_shape):
    """d/dvol's tiled kernel stores a channel's voxels by parity class, each
    class a (D/2, H/2, W/2) sub-volume (rounded up): its row pitch and plane
    pitch in words, odd, with the plane pitch not a multiple of 32 words
    away from the row pitch (so that rows, planes and their diagonals fall
    on different banks), and the words a class takes."""
    d, h, w = (int(s) for s in volume_shape[2:])
    pitch_y = (w + 1) // 2 | 1
    pitch_z = (h + 1) // 2 * pitch_y | 1
    if (pitch_z - pitch_y) % 32 == 0:
        pitch_z += 2
    return pitch_y, pitch_z, (d + 1) // 2 * pitch_z


def _bwd_vol_smem(channels: int, class_words: int, shared_taps: bool) -> int:
    """Bytes of shared memory a tiled d/dvol block takes: the tile of
    ``channels`` channels (8 classes each), two stages of g, and two stages
    of the 8 classes' (slot, weight) pairs with the owner table (a byte a
    word of a channel's tile, by which a batch of lanes checks whether two
    share a word), or two stages of the coordinates."""
    taps = (2 * 2 * 8 * _VOL_STAGE + (8 * class_words + 3) // 4 if shared_taps
            else 2 * 3 * _VOL_STAGE)
    return 4 * (channels * 8 * class_words + 2 * channels * _VOL_STAGE + taps)


def bwd_vol_kernel(volume_shape) -> str:
    """The d/dvol kernel that serves a volume of ``volume_shape``: "tiled"
    (deterministic) where one channel's tile fits in shared memory (every
    cube up to 38^3), else "atomic"."""
    class_words = _class_pitches(volume_shape)[2]
    return "tiled" if _bwd_vol_smem(1, class_words, False) <= _SMEM_BYTES else "atomic"


class BwdVolPlan(NamedTuple):
    """How d/dvol's tiled kernel splits a call: blocks of ``channels``
    channels by ``slices`` slices of ``slice_len`` consecutive samples of
    one volume's group, whose partial sums are added in slice order. The
    8 classes' taps are computed once a sample and kept in shared memory
    with the owner table (``shared_taps``) where they fit beside the tile,
    else each warp computes its own class's. The class tile's pitches, its
    shared memory in bytes, and the blocks of the call."""
    channels: int
    slices: int
    slice_len: int
    shared_taps: bool
    pitch_y: int
    pitch_z: int
    class_words: int
    smem: int
    blocks: int

    def sample_ranges(self, per_volume: int):
        """Each slice's samples [start, stop) of a volume's group, in the
        order the slices are added."""
        return [(i * self.slice_len, min((i + 1) * self.slice_len, per_volume))
                for i in range(self.slices)]


def bwd_vol_plan(volume_shape, n: int, k: int) -> BwdVolPlan:
    """The tiled d/dvol kernel's plan for a volume of ``volume_shape`` and a
    grid of ``n`` batches of ``k`` samples: as many channels a block as fit
    in shared memory (1, 2, 4 or 8, at most the next power of two of C),
    so that the taps are computed as few times as they can be, and the
    samples split into as many slices as fill one wave of blocks on the 132
    SMs, each slice at least 4096 samples and a whole number of stages.
    More slices write more partial sums."""
    nv, c = int(volume_shape[0]), int(volume_shape[1])
    if bwd_vol_kernel(volume_shape) != "tiled":
        raise ValueError(f"volume {tuple(volume_shape)}: one channel does not "
                         f"fit in shared memory")
    pitch_y, pitch_z, class_words = _class_pitches(volume_shape)
    fits = [cb for cb in (8, 4, 2, 1)
            if cb < 2 * c and _bwd_vol_smem(cb, class_words, True) <= _SMEM_BYTES]
    channels, shared_taps = (fits[0], True) if fits else (1, False)
    smem = _bwd_vol_smem(channels, class_words, shared_taps)
    per_sm = max(1, min(8, _SM_SHARED_BYTES // (smem + 1024)))
    groups = -(-c // channels)
    per_volume = n // nv * k
    slices = 1
    if nv * groups < _SMS * per_sm:
        slices = max(1, min(-(-_SMS * per_sm // (nv * groups)),
                            per_volume // _VOL_MIN_SLICE))
    slice_len = max(1, -(-per_volume // slices))
    slice_len = -(-slice_len // _VOL_STAGE) * _VOL_STAGE
    slices = max(1, -(-per_volume // slice_len))
    return BwdVolPlan(channels, slices, slice_len, shared_taps, pitch_y, pitch_z,
                      class_words, smem, nv * slices * groups)


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
    global BWD_GRID_LAUNCHES, BWD_GRID_PER_SAMPLE_LAUNCHES
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
    kernel = bwd_grid_kernel(volume.shape)
    lib = _build.load("fused_sample")
    fn = getattr(lib, f"lf_fused_sample_bwd_grid_{kernel}")
    args = [volume.data_ptr(), grid.data_ptr(), g.data_ptr()]
    if kernel == "staged":
        plan = bwd_grid_plan(volume.shape, n, k)
        partials = dgrid if plan.groups == 1 else torch.empty(
            (plan.groups, *grid.shape), dtype=torch.float32, device=volume.device)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 10
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        args += [partials.data_ptr(), dgrid.data_ptr(), nv, n, c, d, h, w, k,
                 plan.tile, plan.group_channels, plan.groups]
    else:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 7
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        args += [dgrid.data_ptr(), nv, n, c, d, h, w, k]
    fn.restype = ctypes.c_int
    with torch.cuda.device(volume.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(*args, int(padding_mode == "border"), _DTYPE_CODES[volume.dtype],
                    _DTYPE_CODES[g.dtype], stream)
    _build.check(lib, status, f"fused_sample_bwd_grid_{kernel}")
    if kernel == "staged":
        BWD_GRID_LAUNCHES += 1
    else:
        BWD_GRID_PER_SAMPLE_LAUNCHES += 1
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
    global BWD_VOL_LAUNCHES, BWD_VOL_ATOMIC_LAUNCHES
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
    kernel = bwd_vol_kernel(volume_shape)
    lib = _build.load("fused_sample")
    fn = getattr(lib, f"lf_fused_sample_bwd_vol_{kernel}")
    if kernel == "tiled":
        plan = bwd_vol_plan(volume_shape, n, k)
        partials = dvol if plan.slices == 1 else torch.empty(
            (plan.slices, *volume_shape), dtype=torch.float32, device=grid.device)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 13
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        args = [grid.data_ptr(), g.data_ptr(), partials.data_ptr(), dvol.data_ptr(),
                nv, n, c, d, h, w, k, plan.channels, plan.slices, plan.slice_len,
                plan.pitch_y, plan.pitch_z, plan.class_words, int(plan.shared_taps)]
    else:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 7
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        args = [grid.data_ptr(), g.data_ptr(), dvol.data_ptr(), nv, n, c, d, h, w, k]
    fn.restype = ctypes.c_int
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(*args, int(padding_mode == "border"), _DTYPE_CODES[g.dtype], stream)
    _build.check(lib, status, f"fused_sample_bwd_vol_{kernel}")
    if kernel == "tiled":
        BWD_VOL_LAUNCHES += 1
    else:
        BWD_VOL_ATOMIC_LAUNCHES += 1
    return dvol


class FusedSample3d(torch.autograd.Function):
    """Forward K1-fwd; backward K1-bwd-vol and K1-bwd-grid, each only when
    its input needs a gradient. Saves the volume and grid."""

    @staticmethod
    def forward(ctx, volume, grid, padding_mode):
        ctx.volume_dtype = volume.dtype
        volume = volume.to(get_compute_dtype())
        ctx.save_for_backward(volume, grid)
        ctx.padding_mode = padding_mode
        return grid_sample_3d_fused(volume, grid, padding_mode, volume.dtype)

    @staticmethod
    def backward(ctx, g):
        volume, grid = ctx.saved_tensors
        g = g.contiguous()
        dvol = dgrid = None
        if ctx.needs_input_grad[0]:
            dvol = grid_sample_3d_bwd_vol(grid, g, volume.shape,
                                          ctx.padding_mode).to(ctx.volume_dtype)
        if ctx.needs_input_grad[1]:
            dgrid = grid_sample_3d_bwd_grid(volume, grid, g, ctx.padding_mode)
        return dvol, dgrid, None


def grid_sample_3d(volume: torch.Tensor, grid: torch.Tensor,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Differentiable (in ``volume`` and ``grid``) ``grid_sample_3d_fused``
    on the volume in the compute dtype (``dtypes.py``; fp32 unless bf16 is
    asked for), with its output in that dtype; see the module docstring."""
    return FusedSample3d.apply(volume.contiguous(), grid.contiguous(),
                               padding_mode)
