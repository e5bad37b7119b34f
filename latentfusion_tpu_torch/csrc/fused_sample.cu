// K1: trilinear volume sampler for Hopper (sm_90a), forward, d/dgrid and
// d/dvol.
//
// Forward replaces: latentfusion_tpu/ops/pallas_fused_sample.py:_kernel_fwd,
// the pallas_call of _fused_core.
//
// Computes F.grid_sample(vol, grid, mode="bilinear", align_corners=False)
// with zeros or border padding, for a volume batch NV that divides the grid
// batch N: sample batch n reads volume n / (N / NV) in place, so a latent
// shared by 128 hypothesis cameras is never copied 128 times.
//
//   vol  (NV, C, D, H, W)  fp32 or bf16, contiguous
//   grid (N, K, 3)         fp32 (x, y, z) in [-1, 1], K = Do * Ho * Wo
//   out  (N, C, K)         fp32 or bf16, accumulated in fp32, rounded once
//
// What bounds it on an H100: the bytes it writes. At the flagship decode
// shape (NV=1, N=128, C=256, 16^3 samples) the fp32 output is 537 MB while
// the volume is 4 MB, so the least time is the output over 3.35 TB/s, about
// 0.16 ms.
//
// Design. The TPU kernel built (K, J) tap tiles for the MXU; here the natural
// form is the 8-corner gather. One thread owns one sample: it unnormalizes
// its coordinate, clips it for border padding (before the floor), and keeps
// the 8 corner offsets and weights in registers. It then walks a chunk of
// channels. The threads of a warp own consecutive samples, so each store into
// the NC(D)HW output is one coalesced 128-byte line, and neighbouring samples
// read neighbouring voxels of a volume that stays resident in L2. Corners
// outside the volume get weight 0 and a clamped, in-bounds offset. Offsets
// into the output use 64-bit arithmetic.
//
// d/dgrid (K1-bwd-grid) replaces: latentfusion_tpu/ops/pallas_fused_sample.py
// :_kernel_bwd_grid with _axis_dfactor_vmem, the first pallas_call of
// _fused_bwd. Gradient refinement takes it; the volume (the latent) is
// constant there, so d/dvol (K1-bwd-vol) is not computed.
//
//   vol   (NV, C, D, H, W) fp32 or bf16; grid (N, K, 3) fp32 in [-1, 1]
//   g     (N, C, K) fp32 or bf16, dL/dout in the forward's layout
//   dgrid (N, K, 3) fp32
//
// For the x axis, dgrid_x = size_x / 2 * sum_c g_c * sum_{y,z} w_y w_z
// (v[x1] - v[x0]), and likewise for y and z: the tap factors' derivative
// is -1 at the floor tap and +1 at the ceil tap, 0 at a tap outside the
// volume (zeros padding: the JAX kernel's selection over j in [0, size)),
// and with border padding 0 unless the unclipped coordinate lies in
// [0, size - 1] (clip before floor). size / 2 is the derivative of the
// [-1, 1] -> pixel map.
//
// What bounds it on an H100: the bytes of g. At the flagship refinement
// shape (N=8, C=256, 16^3 samples, shared latent) g is 33.5 MB, about
// 0.01 ms at 3.35 TB/s; the volume (4 MB) stays in L2.
//
// Design: as the forward, one thread per sample rebuilds its 8 corner
// offsets, the trilinear weights and the three axes' derivative weights
// once, then walks all C channels: g is read coalesced across the warp,
// the 8 corner values come from the L2-resident volume, and three fp32 sums
// collect the gradient. Each thread writes its 3 floats once; no atomics,
// so the result is deterministic.
//
// d/dvol (K1-bwd-vol) replaces: latentfusion_tpu/ops/pallas_fused_sample.py
// :_kernel_bwd_vol, the second pallas_call of _fused_bwd. Training takes it:
// camera_to_object for the Sculptor's camera volumes (NV = N) and
// object_to_camera for the fused latent (one volume per object, read by its
// contiguous block of N / NV views).
//
//   grid (N, K, 3) fp32; g (N, C, K) fp32 or bf16, dL/dout
//   dvol (NV, C, D, H, W) fp32,
//   dvol[v, c, j] = sum over n in group(v), k of tap(n, k, j) * g[n, c, k]
//
// tap is the forward's trilinear weight (same unnormalization, border clip
// before the floor, zero outside the volume), so this is the forward's
// transpose.
//
// What bounds it on an H100: the bytes of g. At the flagship training
// decode shape (NV=4, N=96, C=256, 16^3 samples) g is 403 MB, about
// 0.12 ms at 3.35 TB/s; dvol (17 MB) stays in L2.
//
// Design: the forward's thread layout, reversed. One thread per sample
// rebuilds its 8 corner offsets and weights, then walks a chunk of
// channels: it reads g coalesced across the warp and adds weight * g to the
// 8 corners with fp32 atomicAdd (compiled to fire-and-forget reductions in
// L2). The C entry point zeroes dvol first. Atomics make the order of each
// voxel's sum change from run to run, so the result is not bit-reproducible:
// it agrees with an ordered sum to fp32 rounding of about a hundred terms,
// within 1e-5 of the largest value (the tolerance its tests state).
// Corners of weight 0 (outside the volume) are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // samples per block
constexpr int kChannelsPerBlock = 16;  // channels each thread walks

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One axis: pixel coordinate -> two taps (index, weight, derivative of
// the weight with respect to the [-1, 1] coordinate). Taps outside
// [0, size) get weight 0, derivative 0 and index 0.
__device__ __forceinline__ void axis_taps(float coord, int size, bool border,
                                          int* i0, int* i1, float* f0,
                                          float* f1, float* d0 = nullptr,
                                          float* d1 = nullptr) {
  float x = ((coord + 1.f) * size - 1.f) * 0.5f;
  float scale = 0.5f * (float)size;
  if (border) {
    if (!(x >= 0.f && x <= (float)(size - 1))) scale = 0.f;
    x = fminf(fmaxf(x, 0.f), (float)(size - 1));
  }
  const float xf = floorf(x);
  const float w1 = x - xf;
  const bool ok0 = xf >= 0.f && xf <= (float)(size - 1);
  const bool ok1 = xf >= -1.f && xf <= (float)(size - 2);
  // Clamp before the cast so that far-away coordinates stay defined.
  const int xi = (int)fminf(fmaxf(xf, -1.f), (float)size);
  *i0 = ok0 ? xi : 0;
  *i1 = ok1 ? xi + 1 : 0;
  *f0 = ok0 ? 1.f - w1 : 0.f;
  *f1 = ok1 ? w1 : 0.f;
  if (d0 != nullptr) {
    *d0 = ok0 ? -scale : 0.f;
    *d1 = ok1 ? scale : 0.f;
  }
}

template <typename VolT, typename OutT>
__global__ void __launch_bounds__(kThreads)
fused_sample_fwd_kernel(const VolT* __restrict__ vol,
                        const float* __restrict__ grid,
                        OutT* __restrict__ out, int64_t group, int64_t c,
                        int d, int h, int w, int64_t k, bool border) {
  const int64_t kk = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (kk >= k) return;
  const int64_t n = blockIdx.y;
  const int64_t c0 = (int64_t)blockIdx.z * kChannelsPerBlock;

  const float* g = grid + (n * k + kk) * 3;
  int x0, x1, y0, y1, z0, z1;
  float fx0, fx1, fy0, fy1, fz0, fz1;
  axis_taps(g[0], w, border, &x0, &x1, &fx0, &fx1);
  axis_taps(g[1], h, border, &y0, &y1, &fy0, &fy1);
  axis_taps(g[2], d, border, &z0, &z1, &fz0, &fz1);

  // Corner order (z, y, x) = 000, 001, 010, 011, 100, ... as in torch.
  const int o[8] = {(z0 * h + y0) * w + x0, (z0 * h + y0) * w + x1,
                    (z0 * h + y1) * w + x0, (z0 * h + y1) * w + x1,
                    (z1 * h + y0) * w + x0, (z1 * h + y0) * w + x1,
                    (z1 * h + y1) * w + x0, (z1 * h + y1) * w + x1};
  const float wt[8] = {fz0 * fy0 * fx0, fz0 * fy0 * fx1, fz0 * fy1 * fx0,
                       fz0 * fy1 * fx1, fz1 * fy0 * fx0, fz1 * fy0 * fx1,
                       fz1 * fy1 * fx0, fz1 * fy1 * fx1};

  const int64_t j = (int64_t)d * h * w;
  const VolT* v = vol + ((n / group) * c + c0) * j;
  OutT* dst = out + (n * c + c0) * k + kk;
  const int cn = (int)min((int64_t)kChannelsPerBlock, c - c0);
  for (int ci = 0; ci < cn; ++ci) {
    const VolT* vc = v + ci * j;
    float acc = wt[0] * load_f(vc + o[0]);
#pragma unroll
    for (int t = 1; t < 8; ++t) acc = fmaf(wt[t], load_f(vc + o[t]), acc);
    store_f(dst + ci * k, acc);
  }
}

template <typename VolT, typename OutT>
void launch(const void* vol, const void* grid, void* out, int64_t nv,
            int64_t n, int64_t c, int d, int h, int w, int64_t k, bool border,
            cudaStream_t stream) {
  const dim3 blocks((unsigned)((k + kThreads - 1) / kThreads), (unsigned)n,
                    (unsigned)((c + kChannelsPerBlock - 1) / kChannelsPerBlock));
  fused_sample_fwd_kernel<VolT, OutT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const VolT*>(vol), static_cast<const float*>(grid),
      static_cast<OutT*>(out), n / nv, c, d, h, w, k, border);
}

template <typename VolT, typename GT>
__global__ void __launch_bounds__(kThreads)
fused_sample_bwd_grid_kernel(const VolT* __restrict__ vol,
                             const float* __restrict__ grid,
                             const GT* __restrict__ g,
                             float* __restrict__ dgrid, int64_t group,
                             int64_t c, int d, int h, int w, int64_t k,
                             bool border) {
  const int64_t kk = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (kk >= k) return;
  const int64_t n = blockIdx.y;

  const float* gr = grid + (n * k + kk) * 3;
  int x0, x1, y0, y1, z0, z1;
  float fx[2], fy[2], fz[2], dx[2], dy[2], dz[2];
  axis_taps(gr[0], w, border, &x0, &x1, &fx[0], &fx[1], &dx[0], &dx[1]);
  axis_taps(gr[1], h, border, &y0, &y1, &fy[0], &fy[1], &dy[0], &dy[1]);
  axis_taps(gr[2], d, border, &z0, &z1, &fz[0], &fz[1], &dz[0], &dz[1]);

  // Corner t has bits (z, y, x) = (t >> 2, (t >> 1) & 1, t & 1).
  const int o[8] = {(z0 * h + y0) * w + x0, (z0 * h + y0) * w + x1,
                    (z0 * h + y1) * w + x0, (z0 * h + y1) * w + x1,
                    (z1 * h + y0) * w + x0, (z1 * h + y0) * w + x1,
                    (z1 * h + y1) * w + x0, (z1 * h + y1) * w + x1};
  float wgx[8], wgy[8], wgz[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int bz = t >> 2, by = (t >> 1) & 1, bx = t & 1;
    wgx[t] = fz[bz] * fy[by] * dx[bx];
    wgy[t] = fz[bz] * dy[by] * fx[bx];
    wgz[t] = dz[bz] * fy[by] * fx[bx];
  }

  const int64_t j = (int64_t)d * h * w;
  const VolT* v = vol + (n / group) * c * j;
  const GT* gp = g + n * c * k + kk;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int64_t ci = 0; ci < c; ++ci) {
    const VolT* vc = v + ci * j;
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float val = load_f(vc + o[t]);
      sx = fmaf(wgx[t], val, sx);
      sy = fmaf(wgy[t], val, sy);
      sz = fmaf(wgz[t], val, sz);
    }
    const float gv = load_f(gp + ci * k);
    ax = fmaf(gv, sx, ax);
    ay = fmaf(gv, sy, ay);
    az = fmaf(gv, sz, az);
  }
  float* out = dgrid + (n * k + kk) * 3;
  out[0] = ax;
  out[1] = ay;
  out[2] = az;
}

template <typename VolT, typename GT>
void launch_bwd_grid(const void* vol, const void* grid, const void* g,
                     void* dgrid, int64_t nv, int64_t n, int64_t c, int d,
                     int h, int w, int64_t k, bool border,
                     cudaStream_t stream) {
  const dim3 blocks((unsigned)((k + kThreads - 1) / kThreads), (unsigned)n);
  fused_sample_bwd_grid_kernel<VolT, GT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const VolT*>(vol), static_cast<const float*>(grid),
      static_cast<const GT*>(g), static_cast<float*>(dgrid), n / nv, c, d, h,
      w, k, border);
}

template <typename GT>
__global__ void __launch_bounds__(kThreads)
fused_sample_bwd_vol_kernel(const float* __restrict__ grid,
                            const GT* __restrict__ g,
                            float* __restrict__ dvol, int64_t group,
                            int64_t c, int d, int h, int w, int64_t k,
                            bool border) {
  const int64_t kk = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (kk >= k) return;
  const int64_t n = blockIdx.y;
  const int64_t c0 = (int64_t)blockIdx.z * kChannelsPerBlock;

  const float* gr = grid + (n * k + kk) * 3;
  int x0, x1, y0, y1, z0, z1;
  float fx0, fx1, fy0, fy1, fz0, fz1;
  axis_taps(gr[0], w, border, &x0, &x1, &fx0, &fx1);
  axis_taps(gr[1], h, border, &y0, &y1, &fy0, &fy1);
  axis_taps(gr[2], d, border, &z0, &z1, &fz0, &fz1);

  const int o[8] = {(z0 * h + y0) * w + x0, (z0 * h + y0) * w + x1,
                    (z0 * h + y1) * w + x0, (z0 * h + y1) * w + x1,
                    (z1 * h + y0) * w + x0, (z1 * h + y0) * w + x1,
                    (z1 * h + y1) * w + x0, (z1 * h + y1) * w + x1};
  const float wt[8] = {fz0 * fy0 * fx0, fz0 * fy0 * fx1, fz0 * fy1 * fx0,
                       fz0 * fy1 * fx1, fz1 * fy0 * fx0, fz1 * fy0 * fx1,
                       fz1 * fy1 * fx0, fz1 * fy1 * fx1};

  const int64_t j = (int64_t)d * h * w;
  float* dst = dvol + ((n / group) * c + c0) * j;
  const GT* gp = g + (n * c + c0) * k + kk;
  const int cn = (int)min((int64_t)kChannelsPerBlock, c - c0);
  for (int ci = 0; ci < cn; ++ci) {
    const float gv = load_f(gp + ci * k);
    float* vc = dst + ci * j;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (wt[t] != 0.f) atomicAdd(vc + o[t], wt[t] * gv);
    }
  }
}

template <typename GT>
void launch_bwd_vol(const void* grid, const void* g, void* dvol, int64_t nv,
                    int64_t n, int64_t c, int d, int h, int w, int64_t k,
                    bool border, cudaStream_t stream) {
  const dim3 blocks((unsigned)((k + kThreads - 1) / kThreads), (unsigned)n,
                    (unsigned)((c + kChannelsPerBlock - 1) / kChannelsPerBlock));
  fused_sample_bwd_vol_kernel<GT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(grid), static_cast<const GT*>(g),
      static_cast<float*>(dvol), n / nv, c, d, h, w, k, border);
}

}  // namespace

extern "C" {

// dtype codes: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after launch.
int lf_fused_sample_fwd(const void* vol, const void* grid, void* out,
                        int64_t nv, int64_t n, int64_t c, int64_t d, int64_t h,
                        int64_t w, int64_t k, int border, int vol_dtype,
                        int out_dtype, void* stream) {
  if (n == 0 || c == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b = border != 0;
  if (vol_dtype == 0 && out_dtype == 0)
    launch<float, float>(vol, grid, out, nv, n, c, d, h, w, k, b, s);
  else if (vol_dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(vol, grid, out, nv, n, c, d, h, w, k, b, s);
  else if (vol_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(vol, grid, out, nv, n, c, d, h, w, k, b, s);
  else if (vol_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(vol, grid, out, nv, n, c, d, h, w, k,
                                         b, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype codes: 0 = fp32, 1 = bf16, for the volume and for g. Returns
// cudaGetLastError() after launch.
int lf_fused_sample_bwd_grid(const void* vol, const void* grid, const void* g,
                             void* dgrid, int64_t nv, int64_t n, int64_t c,
                             int64_t d, int64_t h, int64_t w, int64_t k,
                             int border, int vol_dtype, int g_dtype,
                             void* stream) {
  if (n == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b = border != 0;
  if (vol_dtype == 0 && g_dtype == 0)
    launch_bwd_grid<float, float>(vol, grid, g, dgrid, nv, n, c, d, h, w, k, b,
                                  s);
  else if (vol_dtype == 0 && g_dtype == 1)
    launch_bwd_grid<float, __nv_bfloat16>(vol, grid, g, dgrid, nv, n, c, d, h,
                                          w, k, b, s);
  else if (vol_dtype == 1 && g_dtype == 0)
    launch_bwd_grid<__nv_bfloat16, float>(vol, grid, g, dgrid, nv, n, c, d, h,
                                          w, k, b, s);
  else if (vol_dtype == 1 && g_dtype == 1)
    launch_bwd_grid<__nv_bfloat16, __nv_bfloat16>(vol, grid, g, dgrid, nv, n,
                                                  c, d, h, w, k, b, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype code of g: 0 = fp32, 1 = bf16. Zeroes dvol (NV * C * D * H * W
// floats) on the stream, then scatters into it. Returns cudaGetLastError()
// after launch.
int lf_fused_sample_bwd_vol(const void* grid, const void* g, void* dvol,
                            int64_t nv, int64_t n, int64_t c, int64_t d,
                            int64_t h, int64_t w, int64_t k, int border,
                            int g_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)(nv * c * d * h * w) * sizeof(float);
  cudaError_t err = cudaMemsetAsync(dvol, 0, bytes, s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || c == 0 || k == 0) return 0;
  const bool b = border != 0;
  if (g_dtype == 0)
    launch_bwd_vol<float>(grid, g, dvol, nv, n, c, d, h, w, k, b, s);
  else if (g_dtype == 1)
    launch_bwd_vol<__nv_bfloat16>(grid, g, dvol, nv, n, c, d, h, w, k, b, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* lf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
