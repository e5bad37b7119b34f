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
// 3.35 TB/s.
//
// Design. The reduction runs over dim 1, whose stride is S. One thread owns
// one (b, s) site and loops over C with stride S; the threads of a warp own
// consecutive sites, so each load and store is coalesced. The first pass sums
// u^2 in fp32, the second re-reads x and writes y. The second read of a
// block's C x 256 tile mostly comes from L2, so device memory sees x about
// once. Channel counts need not be powers of two (196 occurs), and offsets
// use 64-bit arithmetic: the largest call on the path has over 10^8 elements.
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
// What bounds it: bytes, two reads (x, g) and one write (dx). The design is
// the forward's: one thread per (b, s) site walks C twice, first to sum
// g * u in fp32, then to write dx; the second pass re-reads x and g, mostly
// from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrelu_pnorm_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       float* __restrict__ inv, int64_t c, int64_t s,
                       int64_t sites, float slope, float eps) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= sites) return;
  const int64_t b = i / s;
  const int64_t base = b * c * s + (i - b * s);
  float ss = 0.f;
  for (int64_t ci = 0; ci < c; ++ci) {
    float u = load_f(x + base + ci * s);
    u = u >= 0.f ? u : slope * u;
    ss = fmaf(u, u, ss);
  }
  const float r = 1.f / sqrtf(ss / (float)c + eps);
  inv[i] = r;
  for (int64_t ci = 0; ci < c; ++ci) {
    float u = load_f(x + base + ci * s);
    u = u >= 0.f ? u : slope * u;
    store_f(y + base + ci * s, u * r);
  }
}

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
lrelu_pnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ inv,
                       const G* __restrict__ g, T* __restrict__ dx, int64_t c,
                       int64_t s, int64_t sites, float slope) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= sites) return;
  const int64_t b = i / s;
  const int64_t base = b * c * s + (i - b * s);
  float gu = 0.f;
  for (int64_t ci = 0; ci < c; ++ci) {
    float u = load_f(x + base + ci * s);
    u = u >= 0.f ? u : slope * u;
    gu = fmaf(load_f(g + base + ci * s), u, gu);
  }
  const float r = inv[i];
  const float r3t = r * r * r * (gu / (float)c);
  for (int64_t ci = 0; ci < c; ++ci) {
    const float xv = load_f(x + base + ci * s);
    const float u = xv >= 0.f ? xv : slope * xv;
    const float du = load_f(g + base + ci * s) * r - u * r3t;
    store_f(dx + base + ci * s, xv >= 0.f ? du : slope * du);
  }
}

template <typename T, typename G>
void launch_bwd(const void* x, const void* inv, const void* g, void* dx,
                int64_t c, int64_t s, int64_t sites, float slope,
                cudaStream_t st) {
  const unsigned blocks = (unsigned)((sites + kThreads - 1) / kThreads);
  lrelu_pnorm_bwd_kernel<T, G><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(inv),
      static_cast<const G*>(g), static_cast<T*>(dx), c, s, sites, slope);
}

}  // namespace

extern "C" {

// dtype code: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after launch.
int lf_lrelu_pnorm_fwd(const void* x, void* y, void* inv, int64_t b,
                       int64_t c, int64_t s, float slope, float eps, int dtype,
                       void* stream) {
  const int64_t sites = b * s;
  if (sites == 0) return 0;
  const unsigned blocks = (unsigned)((sites + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    lrelu_pnorm_fwd_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y),
        static_cast<float*>(inv), c, s, sites, slope, eps);
  else if (dtype == 1)
    lrelu_pnorm_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(inv), c, s, sites, slope, eps);
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
    launch_bwd<float, float>(x, inv, g, dx, c, s, sites, slope, st);
  else if (x_dtype == 0 && g_dtype == 1)
    launch_bwd<float, __nv_bfloat16>(x, inv, g, dx, c, s, sites, slope, st);
  else if (x_dtype == 1 && g_dtype == 0)
    launch_bwd<__nv_bfloat16, float>(x, inv, g, dx, c, s, sites, slope, st);
  else if (x_dtype == 1 && g_dtype == 1)
    launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, inv, g, dx, c, s, sites, slope,
                                             st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* lf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
