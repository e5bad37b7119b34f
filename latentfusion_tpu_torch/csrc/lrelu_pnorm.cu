// K2: fused leaky-ReLU + PixelNorm for Hopper (sm_90a), forward and
// backward.
//
// Forward replaces: latentfusion_tpu/ops/pallas_lrelu_pnorm.py:_fwd_kernel,
// the pallas_call of _fwd_call.
//
//   u = leaky_relu(x, slope); inv = 1 / sqrt(mean(u^2 over C) + eps);
//   y = u * inv, computed in fp32 and rounded once to the dtype of x.
//
//   x   (B, C, S) fp32 or bf16, contiguous: NC(D)HW with S = D * H * W
//   y   like x
//   inv (B, S) fp32, kept for the backward pass
//
// What bounds it on an H100: bytes. It reads x and writes y (and inv); it
// does a few operations per element. The least time is those bytes over
// 3.35 TB/s. A refinement step (8 hypotheses) makes 19 calls at 8 shapes,
// from (8, 64, 128^2) down to (8, 512, 4^2); a CEM render of 128 the same 19
// at batch 128.
//
// Design: the backward's (below). One thread per (b, s) site walking all C
// channels twice gave the small calls a block or two (8 x 512 x 4^2 is 128
// sites) and a 512-step dependent loop. Here a block of 256 threads owns a
// tile of TS sites of one b and all C channels, the channels split over its
// lanes; each thread keeps up to kCache of its x values in registers and
// sums u^2 over its channels in fp32; a shuffle over the lanes of one site,
// then a fixed-order sum over the 8 warps in shared memory, gives mean(u^2).
// The same threads then write y from the registers and the first row of
// lanes writes inv, so x is read from memory once (a C over kCache * 256 /
// TS re-reads the rest). No atomics: two runs give the same bits.
//
// Backward replaces: latentfusion_tpu/ops/pallas_lrelu_pnorm.py:_bwd_kernel,
// the pallas_call of _bwd_call.
//
//   t = mean(g * u over C); du = g * inv - u * inv^3 * t;
//   dx = lrelu'(x) * du, in fp32, rounded once to the dtype of x.
//
//   x, g (B, C, S) fp32 or bf16, contiguous; inv (B, S) fp32 from the
//   forward; dx like x.
//
// What bounds it: bytes, two reads (x, g) and one write (dx). A refinement
// step (8 hypotheses) makes 19 calls at 8 shapes, from (8, 64, 128^2) down to
// (8, 512, 4^2): 50 M elements, 0.18 ms at 3.35 TB/s.
//
// Design. A block of 256 threads owns a tile of TS sites of one b and all C
// channels. Lane l of warp w takes site l % TS and channels w * (32 / TS) +
// l / TS, stepping by 256 / TS, so the lanes of a warp read 32 / TS channel
// rows of TS consecutive sites: for TS = S (S below 32) that is one
// contiguous run of (c, s) elements. Each thread keeps up to kCache of its x
// and g values in registers and sums g * u over its channels in fp32; a
// shuffle over the lanes of one site, then a fixed-order sum over the 8
// warps in shared memory, gives t. The same threads then write dx from the
// registers, so x and g are read from memory once. TS (a power of two, at
// most 32) is the largest that keeps a thread's channels within kCache and
// the call at 264 blocks or more (two per SM), down to 8 sites (a 32-byte
// sector of fp32); the forward uses the same rule (tile_sites). No atomics,
// and each sum is taken in a fixed order: two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCache = 16;     // channels a thread keeps in registers
constexpr int kMinBlocks = 264;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float lrelu(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrelu_pnorm_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       float* __restrict__ inv, int64_t c, int64_t s, int ts,
                       int64_t tiles, float slope, float eps) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (ts - 1);
  const int rows = 32 / ts;  // channel rows per warp
  const int64_t b = blockIdx.x / tiles;
  const int64_t site = (blockIdx.x - b * tiles) * ts + sub;
  const bool valid = site < s;
  const int64_t step = (int64_t)kWarps * rows;
  const int64_t first = (int64_t)warp * rows + lane / ts;
  const int64_t base = b * c * s + site;

  float xs[kCache];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kCache; ++i) {
    const int64_t ci = first + i * step;
    if (valid && ci < c) {
      xs[i] = load_f(x + base + ci * s);
      const float u = lrelu(xs[i], slope);
      ss = fmaf(u, u, ss);
    }
  }
  for (int64_t ci = first + kCache * step; valid && ci < c; ci += step) {
    const float u = lrelu(load_f(x + base + ci * s), slope);
    ss = fmaf(u, u, ss);
  }
  for (int off = ts; off < 32; off <<= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane < ts) part[warp][sub] = ss;
  __syncthreads();
  if (!valid) return;
  float total = 0.f;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) total += part[wi][sub];
  const float r = 1.f / sqrtf(total / (float)c + eps);
  if (first == 0) inv[b * s + site] = r;

#pragma unroll
  for (int i = 0; i < kCache; ++i) {
    const int64_t ci = first + i * step;
    if (ci < c) store_f(y + base + ci * s, lrelu(xs[i], slope) * r);
  }
  for (int64_t ci = first + kCache * step; ci < c; ci += step)
    store_f(y + base + ci * s, lrelu(load_f(x + base + ci * s), slope) * r);
}

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
lrelu_pnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ inv,
                       const G* __restrict__ g, T* __restrict__ dx, int64_t c,
                       int64_t s, int ts, int64_t tiles, float slope) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (ts - 1);
  const int rows = 32 / ts;  // channel rows per warp
  const int64_t b = blockIdx.x / tiles;
  const int64_t site = (blockIdx.x - b * tiles) * ts + sub;
  const bool valid = site < s;
  const int64_t step = (int64_t)kWarps * rows;
  const int64_t first = (int64_t)warp * rows + lane / ts;
  const int64_t base = b * c * s + site;

  float xs[kCache], gs[kCache];
  float gu = 0.f;
#pragma unroll
  for (int i = 0; i < kCache; ++i) {
    const int64_t ci = first + i * step;
    if (valid && ci < c) {
      xs[i] = load_f(x + base + ci * s);
      gs[i] = load_f(g + base + ci * s);
      const float u = xs[i] >= 0.f ? xs[i] : slope * xs[i];
      gu = fmaf(gs[i], u, gu);
    }
  }
  for (int64_t ci = first + kCache * step; valid && ci < c; ci += step) {
    const float xv = load_f(x + base + ci * s);
    gu = fmaf(load_f(g + base + ci * s), xv >= 0.f ? xv : slope * xv, gu);
  }
  for (int off = ts; off < 32; off <<= 1)
    gu += __shfl_xor_sync(0xffffffffu, gu, off);
  if (lane < ts) part[warp][sub] = gu;
  __syncthreads();
  if (!valid) return;
  float t = 0.f;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) t += part[wi][sub];
  const float r = inv[b * s + site];
  const float r3t = r * r * r * (t / (float)c);

#pragma unroll
  for (int i = 0; i < kCache; ++i) {
    const int64_t ci = first + i * step;
    if (ci < c) {
      const float u = xs[i] >= 0.f ? xs[i] : slope * xs[i];
      const float du = gs[i] * r - u * r3t;
      store_f(dx + base + ci * s, xs[i] >= 0.f ? du : slope * du);
    }
  }
  for (int64_t ci = first + kCache * step; ci < c; ci += step) {
    const float xv = load_f(x + base + ci * s);
    const float u = xv >= 0.f ? xv : slope * xv;
    const float du = load_f(g + base + ci * s) * r - u * r3t;
    store_f(dx + base + ci * s, xv >= 0.f ? du : slope * du);
  }
}

// Sites per tile, forward and backward; see the note at the top.
int tile_sites(int64_t b, int64_t c, int64_t s) {
  int ts = 1;
  while (ts < 32 && ts < s) ts <<= 1;
  auto blocks = [&](int t) { return b * ((s + t - 1) / t); };
  while (ts > 8 && (c * ts > (int64_t)kCache * kThreads ||
                    blocks(ts) < kMinBlocks))
    ts >>= 1;
  return ts;
}

template <typename T>
void launch_fwd(const void* x, void* y, void* inv, int64_t b, int64_t c,
                int64_t s, float slope, float eps, cudaStream_t st) {
  const int ts = tile_sites(b, c, s);
  const int64_t tiles = (s + ts - 1) / ts;
  lrelu_pnorm_fwd_kernel<T><<<(unsigned)(b * tiles), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<float*>(inv),
      c, s, ts, tiles, slope, eps);
}

template <typename T, typename G>
void launch_bwd(const void* x, const void* inv, const void* g, void* dx,
                int64_t b, int64_t c, int64_t s, float slope,
                cudaStream_t st) {
  const int ts = tile_sites(b, c, s);
  const int64_t tiles = (s + ts - 1) / ts;
  lrelu_pnorm_bwd_kernel<T, G><<<(unsigned)(b * tiles), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(inv),
      static_cast<const G*>(g), static_cast<T*>(dx), c, s, ts, tiles, slope);
}

}  // namespace

extern "C" {

// dtype code: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after launch.
int lf_lrelu_pnorm_fwd(const void* x, void* y, void* inv, int64_t b,
                       int64_t c, int64_t s, float slope, float eps, int dtype,
                       void* stream) {
  if (b * s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_fwd<float>(x, y, inv, b, c, s, slope, eps, st);
  else if (dtype == 1)
    launch_fwd<__nv_bfloat16>(x, y, inv, b, c, s, slope, eps, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype codes: 0 = fp32, 1 = bf16, for x (and dx) and for g. Returns
// cudaGetLastError() after launch.
int lf_lrelu_pnorm_bwd(const void* x, const void* inv, const void* g, void* dx,
                       int64_t b, int64_t c, int64_t s, float slope,
                       int x_dtype, int g_dtype, void* stream) {
  const int64_t sites = b * s;
  if (sites == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && g_dtype == 0)
    launch_bwd<float, float>(x, inv, g, dx, b, c, s, slope, st);
  else if (x_dtype == 0 && g_dtype == 1)
    launch_bwd<float, __nv_bfloat16>(x, inv, g, dx, b, c, s, slope, st);
  else if (x_dtype == 1 && g_dtype == 0)
    launch_bwd<__nv_bfloat16, float>(x, inv, g, dx, b, c, s, slope, st);
  else if (x_dtype == 1 && g_dtype == 1)
    launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, inv, g, dx, b, c, s, slope,
                                             st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* lf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
