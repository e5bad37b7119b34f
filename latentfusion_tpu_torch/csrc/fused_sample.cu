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
// form is the 8-corner gather, and the question is where the corners come
// from. Gathered from L2 (one scalar load per corner and channel, the lanes
// of a warp on scattered sectors of a rotated grid) they cost 1.07 G loads
// at the decode shape and 7x the bound. So two kernels:
//
// Staged (fused_sample_fwd_staged_kernel), for every volume whose channel
// fits in shared memory (D * H * W * 4 bytes at most 227 KB, so up to 38^3;
// every zoo family's latent is 16^3 or 8^3). A block copies a chunk of
// channels of one volume into shared memory, channels interleaved: voxel j
// holds the chunk's values at j as one vector, 32 bytes (8 fp32 or 16 bf16
// channels, in two 16-byte planes) where that fits (up to 19^3), else 4
// bytes (1 fp32 or 2 bf16 channels). Then it walks a tile of samples of the
// volume's group, up to n_tile grid batches by k_tile samples: a thread
// computes one sample's taps once (the unnormalization, border clip before
// the floor, 8 offsets and weights; the next sample's coordinates are
// loaded meanwhile), reads each corner of nonzero weight with one shared
// load per plane and writes the chunk's channels, each a coalesced row
// along K. Shared-memory bandwidth and bank conflicts set its pace: where W
// is a multiple of a 128-byte group of slots (every zoo latent), the slot
// of voxel (z, y, x) is its flat index with the low bits XORed by (y ^ 3z),
// a permutation within each group, so the lanes of a warp that walk across
// rows of the volume spread over the banks; and corners of weight 0 (at
// least 4 of a sample that border padding clips, as it does the many
// render samples outside the object's cube) are not read. Tiles are chosen
// so a block writes at least as many bytes as it stages (16384 samples or
// 2 x the volume) and the call has 512 blocks or more where the samples
// allow.
//
// Gather (fused_sample_fwd_gather_kernel), for larger volumes. One thread
// owns one sample: it keeps the 8 corner offsets and weights in registers
// and walks a chunk of channels, with the corners read from L2 and each
// store into the NC(D)HW output one coalesced 128-byte line per warp.
//
// Both: corners outside the volume get weight 0 and a clamped, in-bounds
// offset; offsets into the output use 64-bit arithmetic.
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

#include <algorithm>

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
fused_sample_fwd_gather_kernel(const VolT* __restrict__ vol,
                               const float* __restrict__ grid,
                               OutT* __restrict__ out, int64_t group,
                               int64_t c, int d, int h, int w, int64_t k,
                               bool border) {
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
int launch_gather(const void* vol, const void* grid, void* out, int64_t nv,
                  int64_t n, int64_t c, int d, int h, int w, int64_t k,
                  bool border, cudaStream_t stream) {
  const dim3 blocks((unsigned)((k + kThreads - 1) / kThreads), (unsigned)n,
                    (unsigned)((c + kChannelsPerBlock - 1) / kChannelsPerBlock));
  fused_sample_fwd_gather_kernel<VolT, OutT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const VolT*>(vol), static_cast<const float*>(grid),
      static_cast<OutT*>(out), n / nv, c, d, h, w, k, border);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- staged
constexpr int kStagedThreads = 512;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int64_t kMinStagedBlocks = 512;
constexpr int64_t kSamplesPerBlock = 16384;

// Raw storage of a volume element and its value in fp32.
template <typename VolT> struct Raw;
template <> struct Raw<float> {
  using T = unsigned int;
  static __device__ __forceinline__ float f(T r) { return __uint_as_float(r); }
};
template <> struct Raw<__nv_bfloat16> {
  using T = unsigned short;
  static __device__ __forceinline__ float f(T r) {
    return __uint_as_float((unsigned int)r << 16);
  }
};

// One plane's vector of a voxel: VT (uint4 or unsigned int) seen as
// the raw elements of consecutive channels.
template <typename VolT, typename VT>
union Pack {
  VT v;
  typename Raw<VolT>::T e[sizeof(VT) / sizeof(typename Raw<VolT>::T)];
};

__device__ __forceinline__ float3 load_coords(const float* p) {
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

// Shared-memory slot of voxel (z, y, x) at flat index o: o with its low
// bits XORed by (y ^ 3z) & mask. mask is 128 / sizeof(VT) - 1 where W is a
// multiple of 128 / sizeof(VT), so that each aligned group of 128 bytes of
// slots lies in one row and is permuted within itself, else 0.
__device__ __forceinline__ int slot(int o, int y, int z, int mask) {
  return o ^ ((y ^ (3 * z)) & mask);
}

template <typename VolT, typename OutT, typename VT, int PLANES>
__global__ void __launch_bounds__(kStagedThreads)
fused_sample_fwd_staged_kernel(const VolT* __restrict__ vol,
                               const float* __restrict__ grid,
                               OutT* __restrict__ out, int64_t group,
                               int64_t c, int d, int h, int w, int jp,
                               int mask, int64_t k, int64_t k_tile,
                               int64_t n_tile, int64_t n_tiles, bool border) {
  using R = Raw<VolT>;
  using P = Pack<VolT, VT>;
  constexpr int kPerPlane = sizeof(VT) / sizeof(typename R::T);
  constexpr int kChunk = kPerPlane * PLANES;
  extern __shared__ __align__(16) unsigned char smem[];
  VT* tile = reinterpret_cast<VT*>(smem);  // PLANES planes of jp slots

  const int j = d * h * w;
  const int64_t vi = blockIdx.y / n_tiles;
  const int64_t n0 = vi * group + (blockIdx.y - vi * n_tiles) * n_tile;
  const int64_t n1 = min(n0 + n_tile, (vi + 1) * group);
  const int64_t k0 = (int64_t)blockIdx.x * k_tile;
  const int64_t k1 = min(k0 + k_tile, k);
  const int64_t c0 = (int64_t)blockIdx.z * kChunk;
  const int cn = (int)min((int64_t)kChunk, c - c0);

  // Stage channels c0 .. c0 + cn - 1 of volume vi, zero beyond C.
  const typename R::T* src =
      reinterpret_cast<const typename R::T*>(vol) + (vi * c + c0) * j;
  for (int o = threadIdx.x; o < j; o += kStagedThreads) {
    const int zy = o / w;
    const int so = slot(o, zy % h, zy / h, mask);
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      P pk;
#pragma unroll
      for (int e = 0; e < kPerPlane; ++e) {
        const int ci = p * kPerPlane + e;
        pk.e[e] = ci < cn ? __ldg(src + (int64_t)ci * j + o)
                          : (typename R::T)0;
      }
      tile[p * jp + so] = pk.v;
    }
  }
  __syncthreads();

  // Walk the tile's samples (n, kk), kStagedThreads apart, with the next
  // sample's coordinates loaded before this one is computed.
  const int64_t kc = k1 - k0;
  int64_t n = n0, kk = k0 + threadIdx.x;
  while (kk >= k1 && n < n1) kk -= kc, ++n;
  float3 cur = make_float3(0.f, 0.f, 0.f);
  if (n < n1) cur = load_coords(grid + (n * k + kk) * 3);
  while (n < n1) {
    int64_t nn = n, nk = kk + kStagedThreads;
    while (nk >= k1 && nn < n1) nk -= kc, ++nn;
    float3 next = cur;
    if (nn < n1) next = load_coords(grid + (nn * k + nk) * 3);

    int x0, x1, y0, y1, z0, z1;
    float fx0, fx1, fy0, fy1, fz0, fz1;
    axis_taps(cur.x, w, border, &x0, &x1, &fx0, &fx1);
    axis_taps(cur.y, h, border, &y0, &y1, &fy0, &fy1);
    axis_taps(cur.z, d, border, &z0, &z1, &fz0, &fz1);
    const int r00 = (z0 * h + y0) * w, r01 = (z0 * h + y1) * w;
    const int r10 = (z1 * h + y0) * w, r11 = (z1 * h + y1) * w;
    const int m00 = (y0 ^ (3 * z0)) & mask, m01 = (y1 ^ (3 * z0)) & mask;
    const int m10 = (y0 ^ (3 * z1)) & mask, m11 = (y1 ^ (3 * z1)) & mask;
    // Corner order (z, y, x) = 000, 001, 010, 011, 100, ... as in torch.
    const int o[8] = {(r00 + x0) ^ m00, (r00 + x1) ^ m00, (r01 + x0) ^ m01,
                      (r01 + x1) ^ m01, (r10 + x0) ^ m10, (r10 + x1) ^ m10,
                      (r11 + x0) ^ m11, (r11 + x1) ^ m11};
    const float fzy[4] = {fz0 * fy0, fz0 * fy1, fz1 * fy0, fz1 * fy1};
    float acc[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e) acc[e] = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float wt = fzy[t >> 1] * ((t & 1) ? fx1 : fx0);
      // A corner of weight 0 (outside the volume, or clipped by border
      // padding) is not read: fewer lanes contend for the banks.
      if (wt == 0.f) continue;
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        P pk;
        pk.v = tile[p * jp + o[t]];
#pragma unroll
        for (int e = 0; e < kPerPlane; ++e)
          acc[p * kPerPlane + e] =
              fmaf(wt, R::f(pk.e[e]), acc[p * kPerPlane + e]);
      }
    }
    OutT* dst = out + (n * c + c0) * k + kk;
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (e < cn) store_f(dst + e * k, acc[e]);
    n = nn;
    kk = nk;
    cur = next;
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename VolT, typename OutT, typename VT, int PLANES>
int launch_staged(const void* vol, const void* grid, void* out, int64_t nv,
                  int64_t n, int64_t c, int d, int h, int w, int jp, int64_t k,
                  bool border, cudaStream_t stream) {
  constexpr int kChunk = PLANES * sizeof(VT) / sizeof(typename Raw<VolT>::T);
  const int64_t j = (int64_t)d * h * w;
  const size_t smem = (size_t)jp * PLANES * sizeof(VT);
  auto kernel = fused_sample_fwd_staged_kernel<VolT, OutT, VT, PLANES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kRowSlots = 128 / (int)sizeof(VT);
  const int mask = w % kRowSlots == 0 ? kRowSlots - 1 : 0;
  const int64_t group = n / nv;
  const int64_t chunks = ceil_div(c, kChunk);
  const int64_t target = std::max(kSamplesPerBlock, 2 * j);
  int64_t k_tile = std::min(k, target);
  int64_t n_tile = std::max<int64_t>(1, std::min(group, target / k_tile));
  auto blocks = [&]() {
    return ceil_div(k, k_tile) * nv * ceil_div(group, n_tile) * chunks;
  };
  while (n_tile > 1 && blocks() < kMinStagedBlocks) n_tile = (n_tile + 1) / 2;
  while (k_tile > std::max<int64_t>(1024, j) && blocks() < kMinStagedBlocks)
    k_tile = (k_tile + 1) / 2;
  const int64_t n_tiles = ceil_div(group, n_tile);
  if (nv * n_tiles > 65535 || chunks > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 blocks_dim((unsigned)ceil_div(k, k_tile), (unsigned)(nv * n_tiles),
                        (unsigned)chunks);
  kernel<<<blocks_dim, kStagedThreads, smem, stream>>>(
      static_cast<const VolT*>(vol), static_cast<const float*>(grid),
      static_cast<OutT*>(out), group, c, d, h, w, jp, mask, k, k_tile, n_tile,
      n_tiles, border);
  return (int)cudaGetLastError();
}

// 32 bytes a voxel where that tile fits in shared memory, else 4.
template <typename VolT, typename OutT>
int launch_staged_by_size(const void* vol, const void* grid, void* out,
                          int64_t nv, int64_t n, int64_t c, int d, int h,
                          int w, int64_t k, bool border, cudaStream_t stream) {
  const int64_t jp = ceil_div((int64_t)d * h * w, 32) * 32;
  const int ji = (int)jp;
  if (jp * 32 <= kSmemMax)
    return launch_staged<VolT, OutT, uint4, 2>(vol, grid, out, nv, n, c, d, h,
                                               w, ji, k, border, stream);
  if (jp * 4 <= kSmemMax)
    return launch_staged<VolT, OutT, unsigned int, 1>(
        vol, grid, out, nv, n, c, d, h, w, ji, k, border, stream);
  return (int)cudaErrorInvalidValue;
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

struct Staged {
  template <typename VolT, typename OutT>
  static int run(const void* vol, const void* grid, void* out, int64_t nv,
                 int64_t n, int64_t c, int d, int h, int w, int64_t k,
                 bool border, cudaStream_t stream) {
    return launch_staged_by_size<VolT, OutT>(vol, grid, out, nv, n, c, d, h,
                                             w, k, border, stream);
  }
};

struct Gather {
  template <typename VolT, typename OutT>
  static int run(const void* vol, const void* grid, void* out, int64_t nv,
                 int64_t n, int64_t c, int d, int h, int w, int64_t k,
                 bool border, cudaStream_t stream) {
    return launch_gather<VolT, OutT>(vol, grid, out, nv, n, c, d, h, w, k,
                                     border, stream);
  }
};

template <typename L>
int fwd_dispatch(const void* vol, const void* grid, void* out, int64_t nv,
                 int64_t n, int64_t c, int64_t d, int64_t h, int64_t w,
                 int64_t k, int border, int vol_dtype, int out_dtype,
                 void* stream) {
  if (n == 0 || c == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b = border != 0;
  if (vol_dtype == 0 && out_dtype == 0)
    return L::template run<float, float>(vol, grid, out, nv, n, c, d, h, w, k,
                                         b, s);
  if (vol_dtype == 0 && out_dtype == 1)
    return L::template run<float, __nv_bfloat16>(vol, grid, out, nv, n, c, d,
                                                 h, w, k, b, s);
  if (vol_dtype == 1 && out_dtype == 0)
    return L::template run<__nv_bfloat16, float>(vol, grid, out, nv, n, c, d,
                                                 h, w, k, b, s);
  if (vol_dtype == 1 && out_dtype == 1)
    return L::template run<__nv_bfloat16, __nv_bfloat16>(vol, grid, out, nv,
                                                         n, c, d, h, w, k, b,
                                                         s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Forward entry points, one per kernel; the caller picks by volume size
// (lf_fused_sample_fwd_staged refuses a channel over 227 KB). dtype codes:
// 0 = fp32, 1 = bf16. Each returns the launch's CUDA error code.
int lf_fused_sample_fwd_staged(const void* vol, const void* grid, void* out,
                               int64_t nv, int64_t n, int64_t c, int64_t d,
                               int64_t h, int64_t w, int64_t k, int border,
                               int vol_dtype, int out_dtype, void* stream) {
  return fwd_dispatch<Staged>(vol, grid, out, nv, n, c, d, h, w, k, border,
                              vol_dtype, out_dtype, stream);
}

int lf_fused_sample_fwd_gather(const void* vol, const void* grid, void* out,
                               int64_t nv, int64_t n, int64_t c, int64_t d,
                               int64_t h, int64_t w, int64_t k, int border,
                               int vol_dtype, int out_dtype, void* stream) {
  return fwd_dispatch<Gather>(vol, grid, out, nv, n, c, d, h, w, k, border,
                              vol_dtype, out_dtype, stream);
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
