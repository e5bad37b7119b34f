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
// Design: two kernels, chosen by the volume's size as the forward's are.
//
// Staged (fused_sample_bwd_grid_staged_kernel), for every volume whose
// channel fits in shared memory. One thread per sample walking all C
// channels made 8 scattered scalar loads from L2 per channel, a chain of
// 2048 at the refinement shape on 2 blocks per SM, 19x the bound. Here a
// block stages a chunk of channels of one volume as the forward does (the
// same interleaved slots and (y ^ 3z) swizzle: 8 channels a voxel where
// they fit, 32 bytes in fp32, else 1 channel), then walks a tile of up to
// 4096 consecutive samples of that volume's group, 8 a thread: a thread
// computes a sample's taps once per chunk (8 slots, trilinear weights and
// the three axes' derivative weights), reads the chunk's g values (each a
// coalesced row along K), and for each corner whose three derivative
// weights are not all 0 reads one shared vector per plane, takes its dot
// product with g and adds it, times each axis's weight, to the sample's
// three sums in registers. A block of 512 threads at up to 128 registers
// fills an SM's register file, so only 16 warps hide the latency of g:
// the next sample's coordinates and g values are loaded while a sample is
// computed, and with one channel a chunk every sample's are loaded first.
// The channels are split over a grid dimension of groups, each block
// looping over its group's chunks, so that the tiles of a call with few
// samples (the refinement shape: one volume, 32768 samples) still fill the
// 132 SMs; one wave of blocks measured faster than two or four (PERF.md).
// Each group writes its (N, K, 3) sums to a buffer of partials, and
// sum_partials_kernel adds the groups in a fixed order: no
// atomics, two runs give the same bits. The plan (tile, channels a group,
// groups) is computed in Python (ops/fused_sample.py:bwd_grid_plan), which
// allocates the partials; one group writes dgrid directly.
//
// Per sample (fused_sample_bwd_grid_per_sample_kernel), for larger volumes:
// one thread per sample rebuilds its 8 corner offsets, the trilinear
// weights and the three axes' derivative weights once, then walks all C
// channels: g is read coalesced across the warp, the 8 corner values come
// from L2, and three fp32 sums collect the gradient. Each thread writes its
// 3 floats once; no atomics.
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
// The TPU kernel builds dense (K, D*H) tap tiles and takes tap^T @ g on the
// MXU, summing over K tiles in grid order; on the H100 that would be about
// 825 GFLOP of fp32 work at the decode shape for 8 nonzero taps a row. Here
// the natural form is the 8-corner scatter; the question is how to sum each
// voxel in a fixed order without atomics. Two kernels:
//
// Tiled (fused_sample_bwd_vol_tiled_kernel), for every volume whose channel
// fits in shared memory (up to 38^3; every zoo latent and K3's 32^3). A
// block of 8 warps owns one volume, a group of up to 8 channels and a slice
// of the volume's samples in (n, k) order, and keeps the group's channels
// of dvol in shared memory as fp32, zeroed at the start. Warp p owns the
// voxels of parity class p = (z & 1, y & 1, x & 1): a sample's 8 corners
// lie in the 8 classes, one each, so every warp takes exactly one corner of
// every sample and no two warps ever write the same word. Each class is
// stored as its own (D/2, H/2, W/2) sub-volume with odd row and plane
// pitches, so the distinct words a warp writes spread over the banks.
//
// The samples go by in stages of 256, one a thread: a thread loads its
// sample's coordinates and g in the block's channels a stage ahead into
// registers, then stores the g values and its sample's 8 (slot, weight)
// pairs, one per class, into double-buffered shared memory (for volumes
// over 34^3 there is no room for them beside the tile, and each warp
// computes its own class's tap from staged coordinates instead). One
// __syncthreads a stage. Warp p then takes the stage in 8 batches of 32
// samples, batch q the samples 8 l + q, so that neighbouring samples, which
// often share a corner, fall in different batches. The lanes of a batch
// whose corner in class p has a nonzero weight and lands on one word form a
// group; each group's values w * g are summed by a fixed shuffle tree over
// the members' ranks (none where every word differs, up to five levels
// where border clipping piles 32 samples on one voxel), and the group's
// lowest lane adds the sum to its word with a plain shared read-modify-
// write, for all the block's channels at once; __syncwarp orders one batch
// after the previous. Finding groups with __match_any_sync costs about as
// much as the rest of a batch where the 32 words differ (K3's random grid),
// so a batch first checks through a byte-a-word owner table whether any two
// of its lanes share a word. The warp's latencies, not shared-memory
// bandwidth, set the pace (8 warps an SM at these tiles), so a warp does
// each pass over all 8 batches before the next: slots and groups, then
// values and trees, then the read-modify-writes. So each word's sum has a
// fixed order (stage, batch, tree), and two calls on the same inputs give
// the same bits. The plan (channels a block, sample slices, the class
// pitches) is computed in Python (ops/fused_sample.py:bwd_vol_plan) so that
// a call fills at least one wave of the 132 SMs; with one slice a block
// writes its tile straight into dvol, else into a buffer of partials that
// sum_partials_kernel adds in slice order.
//
// Atomic (fused_sample_bwd_vol_atomic_kernel), for larger volumes: one
// thread per sample rebuilds its 8 corner offsets and weights, then walks a
// chunk of channels, reading g coalesced across the warp and adding weight
// * g to the 8 corners with fp32 atomicAdd; the C entry point zeroes dvol
// first. Atomics make the order of each voxel's sum change from run to run,
// so this kernel's result is NOT bit-reproducible: it agrees with an ordered
// sum to fp32 rounding, within 1e-5 of the largest value. Corners of weight
// 0 are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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
// [0, size) get weight 0, derivative 0 and index 0. *base, if given, is the
// floor tap's unclamped index (clipped to [-1, size]).
__device__ __forceinline__ void axis_taps(float coord, int size, bool border,
                                          int* i0, int* i1, float* f0,
                                          float* f1, float* d0 = nullptr,
                                          float* d1 = nullptr,
                                          int* base = nullptr) {
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
  if (base != nullptr) *base = xi;
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

// Copies cn channels of one volume, src pointing at the first, into PLANES
// planes of jp slots: slot(o) of plane p holds channels p * kPerPlane ..
// of voxel o, zero beyond cn. Every thread of the block takes part: thread
// t stages voxels t + i * kStagedThreads, a batch of them with their loads
// issued together (a volume of 16^3 or more is 8 or more voxels a thread),
// each voxel's (y, z) carried from the previous one's by addition.
template <typename VolT, typename VT, int PLANES>
__device__ __forceinline__ void stage_channels(
    VT* tile, const typename Raw<VolT>::T* __restrict__ src, int j, int h,
    int w, int jp, int mask, int cn) {
  using T = typename Raw<VolT>::T;
  using P = Pack<VolT, VT>;
  constexpr int kPerPlane = sizeof(VT) / sizeof(T);
  constexpr int kChunk = kPerPlane * PLANES;
  constexpr int kBatch = kChunk >= 8 ? 4 : 16;
  const int zy0 = threadIdx.x / w;
  int x = threadIdx.x - zy0 * w, y = zy0 % h, z = zy0 / h;
  const int step_zy = kStagedThreads / w, step_x = kStagedThreads % w;
  const int step_y = step_zy % h, step_z = step_zy / h;
  for (int o0 = threadIdx.x; o0 < j; o0 += kBatch * kStagedThreads) {
    T v[kBatch][kChunk];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int o = o0 + b * kStagedThreads;
#pragma unroll
      for (int ci = 0; ci < kChunk; ++ci)
        v[b][ci] = o < j && ci < cn ? __ldg(src + (int64_t)ci * j + o) : (T)0;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int o = o0 + b * kStagedThreads;
      if (o < j) {
        const int so = slot(o, y, z, mask);
#pragma unroll
        for (int p = 0; p < PLANES; ++p) {
          P pk;
#pragma unroll
          for (int e = 0; e < kPerPlane; ++e) pk.e[e] = v[b][p * kPerPlane + e];
          tile[p * jp + so] = pk.v;
        }
      }
      x += step_x;
      y += step_y;
      z += step_z;
      if (x >= w) x -= w, ++y;
      if (y >= h) y -= h, ++z;
    }
  }
}

// The shared-memory slots of a sample's 8 corners, in the order (z, y, x) =
// 000, 001, 010, 011, 100, ... as in torch.
__device__ __forceinline__ void corner_slots(int x0, int x1, int y0, int y1,
                                             int z0, int z1, int h, int w,
                                             int mask, int o[8]) {
  const int r00 = (z0 * h + y0) * w, r01 = (z0 * h + y1) * w;
  const int r10 = (z1 * h + y0) * w, r11 = (z1 * h + y1) * w;
  const int m00 = (y0 ^ (3 * z0)) & mask, m01 = (y1 ^ (3 * z0)) & mask;
  const int m10 = (y0 ^ (3 * z1)) & mask, m11 = (y1 ^ (3 * z1)) & mask;
  o[0] = (r00 + x0) ^ m00;
  o[1] = (r00 + x1) ^ m00;
  o[2] = (r01 + x0) ^ m01;
  o[3] = (r01 + x1) ^ m01;
  o[4] = (r10 + x0) ^ m10;
  o[5] = (r10 + x1) ^ m10;
  o[6] = (r11 + x0) ^ m11;
  o[7] = (r11 + x1) ^ m11;
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
  stage_channels<VolT, VT, PLANES>(
      tile, reinterpret_cast<const typename R::T*>(vol) + (vi * c + c0) * j, j,
      h, w, jp, mask, cn);
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
    int o[8];
    corner_slots(x0, x1, y0, y1, z0, z1, h, w, mask, o);
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

// ------------------------------------------------------- d/dgrid, staged
constexpr int kGridSamplesPerThread = 8;
constexpr int kGridMaxTile = kStagedThreads * kGridSamplesPerThread;
constexpr int kReduceThreads = 256;

// g at offset off and the next cn - 1 channel rows (k apart) in fp32, 0
// beyond cn or where the sample does not exist.
template <typename GT, int N>
__device__ __forceinline__ void load_g_row(float (&gv)[N], const GT* g,
                                           bool valid, int64_t off, int64_t k,
                                           int cn) {
#pragma unroll
  for (int e = 0; e < N; ++e)
    gv[e] = valid && e < cn ? load_f(g + off + (int64_t)e * k) : 0.f;
}

template <typename VolT, typename GT, typename VT, int PLANES>
__global__ void __launch_bounds__(kStagedThreads)
fused_sample_bwd_grid_staged_kernel(
    const VolT* __restrict__ vol, const float* __restrict__ grid,
    const GT* __restrict__ g, float* __restrict__ partials, int64_t group,
    int64_t n, int64_t c, int d, int h, int w, int jp, int mask, int64_t k,
    int tile, int64_t tiles_per_volume, int group_channels, bool border) {
  using R = Raw<VolT>;
  using P = Pack<VolT, VT>;
  constexpr int kPerPlane = sizeof(VT) / sizeof(typename R::T);
  constexpr int kChunk = kPerPlane * PLANES;
  extern __shared__ __align__(16) unsigned char smem[];
  VT* tile_slots = reinterpret_cast<VT*>(smem);  // PLANES planes of jp slots

  const int j = d * h * w;
  const int64_t per_volume = group * k;
  const int64_t vi = blockIdx.x / tiles_per_volume;
  const int64_t s0 =
      vi * per_volume + (blockIdx.x - vi * tiles_per_volume) * tile;
  const int64_t s1 = min(s0 + tile, (vi + 1) * per_volume);
  const int64_t c_begin = (int64_t)blockIdx.y * group_channels;
  const int64_t c_end = min(c_begin + group_channels, c);
  const typename R::T* src =
      reinterpret_cast<const typename R::T*>(vol) + vi * c * j;

  float acc[kGridSamplesPerThread][3];
#pragma unroll
  for (int i = 0; i < kGridSamplesPerThread; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = 0.f;

  for (int64_t c0 = c_begin; c0 < c_end; c0 += kChunk) {
    const int cn = (int)min((int64_t)kChunk, c_end - c0);
    __syncthreads();  // the previous chunk is no longer read
    stage_channels<VolT, VT, PLANES>(tile_slots, src + c0 * j, j, h, w, jp,
                                     mask, cn);
    __syncthreads();

    // Sample p's contribution at this chunk, given its g values: for each
    // corner whose three derivative weights are not all 0 (a corner outside
    // the volume, or clipped by border padding on every axis it moves
    // along, adds nothing and is not read), the dot product of g with the
    // staged channels, times each axis's weight.
    auto add_sample = [&](float3 p, const float* gv, float* a) {
      int x0, x1, y0, y1, z0, z1;
      float fx[2], fy[2], fz[2], dx[2], dy[2], dz[2];
      axis_taps(p.x, w, border, &x0, &x1, &fx[0], &fx[1], &dx[0], &dx[1]);
      axis_taps(p.y, h, border, &y0, &y1, &fy[0], &fy[1], &dy[0], &dy[1]);
      axis_taps(p.z, d, border, &z0, &z1, &fz[0], &fz[1], &dz[0], &dz[1]);
      int o[8];
      corner_slots(x0, x1, y0, y1, z0, z1, h, w, mask, o);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int bz = t >> 2, by = (t >> 1) & 1, bx = t & 1;
        const float wx = fz[bz] * fy[by] * dx[bx];
        const float wy = fz[bz] * dy[by] * fx[bx];
        const float wz = dz[bz] * fy[by] * fx[bx];
        if (wx == 0.f && wy == 0.f && wz == 0.f) continue;
        float sv = 0.f;
#pragma unroll
        for (int pl = 0; pl < PLANES; ++pl) {
          P pk;
          pk.v = tile_slots[pl * jp + o[t]];
#pragma unroll
          for (int e = 0; e < kPerPlane; ++e)
            sv = fmaf(gv[pl * kPerPlane + e], R::f(pk.e[e]), sv);
        }
        a[0] = fmaf(wx, sv, a[0]);
        a[1] = fmaf(wy, sv, a[1]);
        a[2] = fmaf(wz, sv, a[2]);
      }
    };

    // The thread's samples s0 + threadIdx.x + i * kStagedThreads, each
    // (n, kk). Registers bound the block to 16 warps an SM, so the loads of
    // g (from device memory) are issued ahead: with one channel a chunk,
    // every sample's coordinates and g value before any is computed; with
    // eight, the next sample's while this one is computed.
    int64_t s = s0 + threadIdx.x;
    int64_t ni = s / k, kk = s - ni * k;
    auto advance = [&]() {
      s += kStagedThreads;
      kk += kStagedThreads;
      if (kk >= k) {
        const int64_t q = kk / k;
        ni += q;
        kk -= q * k;
      }
    };
    if constexpr (kChunk == 1) {
      float3 pts[kGridSamplesPerThread];
      float gs[kGridSamplesPerThread][1];
#pragma unroll
      for (int i = 0; i < kGridSamplesPerThread; ++i) {
        pts[i] = make_float3(0.f, 0.f, 0.f);
        if (s < s1) pts[i] = load_coords(grid + s * 3);
        load_g_row(gs[i], g, s < s1, (ni * c + c0) * k + kk, k, cn);
        advance();
      }
#pragma unroll
      for (int i = 0; i < kGridSamplesPerThread; ++i)
        if (s0 + threadIdx.x + (int64_t)i * kStagedThreads < s1)
          add_sample(pts[i], gs[i], acc[i]);
    } else {
      float3 cur = make_float3(0.f, 0.f, 0.f);
      float gv[kChunk];
      load_g_row(gv, g, s < s1, (ni * c + c0) * k + kk, k, cn);
      if (s < s1) cur = load_coords(grid + s * 3);
#pragma unroll
      for (int i = 0; i < kGridSamplesPerThread; ++i) {
        const bool valid = s < s1;
        advance();
        const bool has_next = i + 1 < kGridSamplesPerThread && s < s1;
        float3 next = cur;
        if (has_next) next = load_coords(grid + s * 3);
        float gn[kChunk];
        load_g_row(gn, g, has_next, (ni * c + c0) * k + kk, k, cn);
        if (valid) add_sample(cur, gv, acc[i]);
        cur = next;
#pragma unroll
        for (int e = 0; e < kChunk; ++e) gv[e] = gn[e];
      }
    }
  }

  float* out = partials + (int64_t)blockIdx.y * n * k * 3;
#pragma unroll
  for (int i = 0; i < kGridSamplesPerThread; ++i) {
    const int64_t si = s0 + threadIdx.x + (int64_t)i * kStagedThreads;
    if (si < s1) {
      out[si * 3] = acc[i][0];
      out[si * 3 + 1] = acc[i][1];
      out[si * 3 + 2] = acc[i][2];
    }
  }
}

// out = the sum of the groups' partials (groups x m floats), taken in
// group order: d/dgrid's channel groups, d/dvol's sample slices.
__global__ void __launch_bounds__(kReduceThreads)
sum_partials_kernel(const float* __restrict__ partials,
                    float* __restrict__ out, int64_t m, int groups) {
  const int64_t i = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= m) return;
  float acc = partials[i];
#pragma unroll 4
  for (int gi = 1; gi < groups; ++gi) acc += partials[gi * m + i];
  out[i] = acc;
}

template <typename VolT, typename GT, typename VT, int PLANES>
int launch_bwd_grid_staged(const void* vol, const void* grid, const void* g,
                           void* partials, void* dgrid, int64_t nv, int64_t n,
                           int64_t c, int d, int h, int w, int jp, int64_t k,
                           int tile, int group_channels, int groups,
                           bool border, cudaStream_t stream) {
  constexpr int kChunk = PLANES * sizeof(VT) / sizeof(typename Raw<VolT>::T);
  // The plan must split the channels into whole chunks, and the groups
  // must cover them exactly once.
  if (tile < 1 || tile > kGridMaxTile || group_channels < 1 ||
      (group_channels % kChunk != 0 && group_channels < c) ||
      groups != ceil_div(c, group_channels) || groups > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)jp * PLANES * sizeof(VT);
  auto kernel = fused_sample_bwd_grid_staged_kernel<VolT, GT, VT, PLANES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kRowSlots = 128 / (int)sizeof(VT);
  const int mask = w % kRowSlots == 0 ? kRowSlots - 1 : 0;
  const int64_t group = n / nv;
  const int64_t tiles_per_volume = ceil_div(group * k, tile);
  const dim3 blocks((unsigned)(nv * tiles_per_volume), (unsigned)groups);
  kernel<<<blocks, kStagedThreads, smem, stream>>>(
      static_cast<const VolT*>(vol), static_cast<const float*>(grid),
      static_cast<const GT*>(g), static_cast<float*>(partials), group, n, c,
      d, h, w, jp, mask, k, tile, tiles_per_volume, group_channels, border);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return (int)err;
  const int64_t m = n * k * 3;
  sum_partials_kernel<<<(unsigned)ceil_div(m, kReduceThreads), kReduceThreads,
                        0, stream>>>(static_cast<const float*>(partials),
                                     static_cast<float*>(dgrid), m, groups);
  return (int)cudaGetLastError();
}

// 8 channels a voxel where 8 fp32 channels fit in shared memory (32 bytes;
// bf16 takes 16), else 1 (4 or 2 bytes); the same rule as the plan's in
// Python, whatever the dtype, so that the plan's groups are whole chunks.
template <typename VolT, typename GT>
int launch_bwd_grid_staged_by_size(const void* vol, const void* grid,
                                   const void* g, void* partials, void* dgrid,
                                   int64_t nv, int64_t n, int64_t c, int d,
                                   int h, int w, int64_t k, int tile,
                                   int group_channels, int groups, bool border,
                                   cudaStream_t stream) {
  constexpr bool kF32 = sizeof(VolT) == 4;
  using Narrow = typename std::conditional<kF32, unsigned int,
                                           unsigned short>::type;
  const int64_t jp = ceil_div((int64_t)d * h * w, 32) * 32;
  const int ji = (int)jp;
  if (jp * 32 <= kSmemMax)
    return launch_bwd_grid_staged<VolT, GT, uint4, kF32 ? 2 : 1>(
        vol, grid, g, partials, dgrid, nv, n, c, d, h, w, ji, k, tile,
        group_channels, groups, border, stream);
  if (jp * 4 <= kSmemMax)
    return launch_bwd_grid_staged<VolT, GT, Narrow, 1>(
        vol, grid, g, partials, dgrid, nv, n, c, d, h, w, ji, k, tile,
        group_channels, groups, border, stream);
  return (int)cudaErrorInvalidValue;
}

// --------------------------------------------------- d/dgrid, per sample
template <typename VolT, typename GT>
__global__ void __launch_bounds__(kThreads)
fused_sample_bwd_grid_per_sample_kernel(const VolT* __restrict__ vol,
                                        const float* __restrict__ grid,
                                        const GT* __restrict__ g,
                                        float* __restrict__ dgrid,
                                        int64_t group, int64_t c, int d,
                                        int h, int w, int64_t k, bool border) {
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
int launch_bwd_grid_per_sample(const void* vol, const void* grid,
                               const void* g, void* dgrid, int64_t nv,
                               int64_t n, int64_t c, int d, int h, int w,
                               int64_t k, bool border, cudaStream_t stream) {
  const dim3 blocks((unsigned)((k + kThreads - 1) / kThreads), (unsigned)n);
  fused_sample_bwd_grid_per_sample_kernel<VolT, GT>
      <<<blocks, kThreads, 0, stream>>>(
          static_cast<const VolT*>(vol), static_cast<const float*>(grid),
          static_cast<const GT*>(g), static_cast<float*>(dgrid), n / nv, c,
          d, h, w, k, border);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- d/dvol, atomic
template <typename GT>
__global__ void __launch_bounds__(kThreads)
fused_sample_bwd_vol_atomic_kernel(const float* __restrict__ grid,
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
void launch_bwd_vol_atomic(const void* grid, const void* g, void* dvol,
                           int64_t nv, int64_t n, int64_t c, int d, int h,
                           int w, int64_t k, bool border,
                           cudaStream_t stream) {
  const dim3 blocks((unsigned)((k + kThreads - 1) / kThreads), (unsigned)n,
                    (unsigned)((c + kChannelsPerBlock - 1) / kChannelsPerBlock));
  fused_sample_bwd_vol_atomic_kernel<GT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(grid), static_cast<const GT*>(g),
      static_cast<float*>(dvol), n / nv, c, d, h, w, k, border);
}

// -------------------------------------------------------- d/dvol, tiled
constexpr int kVolThreads = 256;       // 8 warps, warp p owns parity class p
constexpr int kVolStage = kVolThreads;  // samples a stage holds, one a thread
constexpr unsigned kFull = 0xffffffffu;

// One axis's two taps sorted by the parity of their index: i[b], f[b] is
// the tap whose index has parity b (index 0 and weight 0 outside the
// volume), with the forward's arithmetic.
__device__ __forceinline__ void axis_taps_by_parity(float coord, int size,
                                                    bool border, int i[2],
                                                    float f[2]) {
  int a0, a1, xi;
  float w0, w1;
  axis_taps(coord, size, border, &a0, &a1, &w0, &w1, nullptr, nullptr, &xi);
  const bool odd = xi & 1;  // the floor tap's parity; -1 counts as odd
  i[0] = odd ? a1 : a0;
  f[0] = odd ? w1 : w0;
  i[1] = odd ? a0 : a1;
  f[1] = odd ? w0 : w1;
}

// Word of voxel (z, y, x) of parity class p in a channel's tile: class p's
// (D/2, H/2, W/2) sub-volume starts at p * cls, with row pitch py and plane
// pitch pz.
__device__ __forceinline__ int class_slot(int p, int x, int y, int z, int py,
                                          int pz, int cls) {
  return p * cls + (z >> 1) * pz + (y >> 1) * py + (x >> 1);
}

// Shared-memory words of a block: the tile of cb channels, two stages of g,
// and two stages of the 8 classes' (slot, weight) pairs with the owner
// table, a byte a word of a channel's tile (shared_taps), or two stages of
// the coordinates.
constexpr int64_t bwd_vol_smem_words(int64_t cb, int64_t cls,
                                     bool shared_taps) {
  return cb * 8 * cls + 2 * cb * kVolStage +
         (shared_taps ? 2 * 2 * 8 * kVolStage + (8 * cls + 3) / 4
                      : 2 * 3 * kVolStage);
}

template <typename GT, int CB, bool kSharedTaps>
__global__ void __launch_bounds__(kVolThreads)
fused_sample_bwd_vol_tiled_kernel(const float* __restrict__ grid,
                                  const GT* __restrict__ g,
                                  float* __restrict__ out, int64_t nv,
                                  int64_t group, int64_t c, int d, int h,
                                  int w, int64_t k, int slices,
                                  int64_t slice_len, int py, int pz, int cls,
                                  bool border) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chs = 8 * cls;  // words of one channel's tile
  float* tile = reinterpret_cast<float*>(smem);    // [CB][chs]
  float* gbuf = tile + CB * chs;                   // [2][CB][kVolStage]
  float* extra = gbuf + 2 * CB * kVolStage;
  // kSharedTaps: slots [2][8][kVolStage] then weights [2][8][kVolStage];
  // else coordinates [2][3][kVolStage].
  int* tslot = reinterpret_cast<int*>(extra);
  float* tweight = extra + 2 * 8 * kVolStage;
  // kSharedTaps: then the owner table, one byte a word of a channel's tile.
  unsigned char* owner =
      reinterpret_cast<unsigned char*>(extra + 2 * 2 * 8 * kVolStage);

  const int tid = threadIdx.x, lane = tid & 31, p = tid >> 5;
  const int64_t vi = blockIdx.x / slices;
  const int64_t sl = blockIdx.x - vi * slices;
  const int64_t per_volume = group * k;
  const int64_t s_begin = vi * per_volume + sl * slice_len;
  const int64_t s_end = min(s_begin + slice_len, (vi + 1) * per_volume);
  const int64_t c0 = (int64_t)blockIdx.y * CB;
  const int cn = (int)min((int64_t)CB, c - c0);
  const int64_t stages = (s_end - s_begin + kVolStage - 1) / kVolStage;

  for (int i = tid; i < CB * chs; i += kVolThreads) tile[i] = 0.f;

  // This thread's sample of a coming stage, s = (ni, kk): its coordinates
  // and g in the block's channels, loaded into one of two sets of registers
  // (the other set's stores into shared memory may still be queued).
  int64_t s = s_begin + tid;
  int64_t ni = s / k, kk = s - ni * k;
  struct Ahead {
    float3 pc;
    float pg[CB];
    bool valid;
  };
  auto load = [&](Ahead& a) {
    a.valid = s < s_end;
    a.pc = a.valid ? load_coords(grid + s * 3) : make_float3(0.f, 0.f, 0.f);
    const GT* gp = g + (ni * c + c0) * k + kk;
#pragma unroll
    for (int e = 0; e < CB; ++e)
      a.pg[e] = a.valid && e < cn ? load_f(gp + (int64_t)e * k) : 0.f;
    s += kVolStage;
    kk += kVolStage;
    if (kk >= k) {
      const int64_t q = kk / k;
      ni += q;
      kk -= q * k;
    }
  };
  // Batch q of a stage takes its samples 8 l + q, l = 0 .. 31, so that
  // neighbouring samples, which often share corners, fall in different
  // batches; sample t of the stage is kept at position staged(t), which
  // puts batch q's samples on 32 banks, as are a warp's 32 stores.
  auto staged = [](int t) {
    const int q = t & 7, l = t >> 3;
    return q * 32 + ((l + 4 * q) & 31);
  };
  const int me = staged(tid);
  auto put = [&](int buf, const Ahead& a) {
    float* gb = gbuf + buf * CB * kVolStage;
#pragma unroll
    for (int e = 0; e < CB; ++e) gb[e * kVolStage + me] = a.pg[e];
    if constexpr (kSharedTaps) {
      int ix[2], iy[2], iz[2];
      float fx[2], fy[2], fz[2];
      axis_taps_by_parity(a.pc.x, w, border, ix, fx);
      axis_taps_by_parity(a.pc.y, h, border, iy, fy);
      axis_taps_by_parity(a.pc.z, d, border, iz, fz);
      int* ts = tslot + buf * 8 * kVolStage;
      float* tw = tweight + buf * 8 * kVolStage;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int bz = q >> 2, by = (q >> 1) & 1, bx = q & 1;
        ts[q * kVolStage + me] =
            class_slot(q, ix[bx], iy[by], iz[bz], py, pz, cls);
        tw[q * kVolStage + me] = a.valid ? fz[bz] * fy[by] * fx[bx] : 0.f;
      }
    } else {
      float* co = extra + buf * 3 * kVolStage;
      co[me] = a.pc.x;
      co[kVolStage + me] = a.pc.y;
      co[2 * kVolStage + me] = a.pc.z;
    }
  };

  // Warp p adds the stage's corners of class p, in 8 batches of 32 samples,
  // in three passes so that the batches' latencies overlap: every batch's
  // slots, weights and groups; every batch's values, summed within each
  // group by a shuffle tree; then the groups' read-modify-writes, batch
  // after batch.
  auto consume = [&](int buf, int64_t stage_begin) {
    constexpr int kBatches = kVolStage / 32;
    const float* gb = gbuf + buf * CB * kVolStage;
    const unsigned below = (1u << lane) - 1u;
    int slot[kBatches];
    float wt[kBatches];
#pragma unroll
    for (int q = 0; q < kBatches; ++q) {
      const int idx = q * 32 + ((lane + 4 * q) & 31);
      if constexpr (kSharedTaps) {
        slot[q] = tslot[(buf * 8 + p) * kVolStage + idx];
        wt[q] = tweight[(buf * 8 + p) * kVolStage + idx];
      } else {
        const float* co = extra + buf * 3 * kVolStage;
        int ix[2], iy[2], iz[2];
        float fx[2], fy[2], fz[2];
        axis_taps_by_parity(co[idx], w, border, ix, fx);
        axis_taps_by_parity(co[kVolStage + idx], h, border, iy, fy);
        axis_taps_by_parity(co[2 * kVolStage + idx], d, border, iz, fz);
        const bool bz = p >> 2, by = (p >> 1) & 1, bx = p & 1;
        slot[q] = class_slot(p, bx ? ix[1] : ix[0], by ? iy[1] : iy[0],
                             bz ? iz[1] : iz[0], py, pz, cls);
        wt[q] = stage_begin + 8 * lane + q < s_end
                    ? (bz ? fz[1] : fz[0]) * (by ? fy[1] : fy[0]) *
                          (bx ? fx[1] : fx[0])
                    : 0.f;
      }
    }
    // Lanes on one word form a group (an inactive lane is alone), found
    // with __match_any_sync on the slot, which costs about as much as the
    // rest of a batch where the 32 slots differ. So with kSharedTaps a batch
    // first checks whether it has duplicates at all: its active lanes write
    // their lane into their word's byte of the owner table and read it
    // back, a lane that reads another lane shares its word, and one warp
    // reduction tells whether the batch has an active lane and whether two
    // share a word. (Volumes whose tiles leave no room for the table match
    // every batch.) rank is a lane's place among its group's members in
    // lane order, rem the members above it, levels the tree levels the
    // batch's largest group needs. live (warp-uniform) marks the batches
    // with an active lane, lead the batches in which this lane writes its
    // group's sum.
    unsigned live = 0u, lead = 0u;
    int rank[kBatches], size[kBatches], levels[kBatches];
    unsigned rem[kBatches];
#pragma unroll
    for (int q = 0; q < kBatches; ++q) {
      const bool active = wt[q] != 0.f;
      bool shared_word = true;
      if constexpr (kSharedTaps) {
        if (active) owner[slot[q]] = (unsigned char)lane;
        __syncwarp();
        // A lane reads before it joins the reduction, and the next batch
        // writes after it.
        const unsigned flags = __reduce_or_sync(
            kFull, (active ? 1u : 0u) |
                       (active && owner[slot[q]] != (unsigned char)lane ? 2u : 0u));
        if (flags & 1u) live |= 1u << q;
        shared_word = (flags & 2u) != 0u;
      } else if (__ballot_sync(kFull, active) != 0u) {
        live |= 1u << q;
      }
      unsigned m = 1u << lane;
      levels[q] = 0;
      if (shared_word) {
        m = __match_any_sync(kFull,
                             active ? (unsigned)slot[q] : 0x80000000u | lane);
        levels[q] =
            32 - __clz((int)__reduce_max_sync(kFull, (unsigned)__popc(m)) - 1);
      }
      size[q] = __popc(m);
      rank[q] = __popc(m & below);
      rem[q] = m & ~below & ~(1u << lane);
      if (active && rank[q] == 0) lead |= 1u << q;
    }
    if (live == 0u) return;
    // Each group's sum by a tree: at level t the member of rank + 2^t
    // passes its partial sum to the member of rank, where rank is a
    // multiple of 2^(t+1).
    float v[kBatches][CB];
#pragma unroll
    for (int q = 0; q < kBatches; ++q)
#pragma unroll
      for (int e = 0; e < CB; ++e)
        v[q][e] = wt[q] * gb[e * kVolStage + q * 32 + ((lane + 4 * q) & 31)];
    int deepest = 0;
#pragma unroll
    for (int q = 0; q < kBatches; ++q) deepest = max(deepest, levels[q]);
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      if (t < deepest) {
#pragma unroll
        for (int q = 0; q < kBatches; ++q) {
#pragma unroll
          for (int i = 0; i < (t > 0 ? 1 << (t - 1) : 0); ++i)
            rem[q] &= rem[q] - 1u;
          const int src = rem[q] != 0u ? __ffs((int)rem[q]) - 1 : lane;
          const bool recv =
              (rank[q] & ((2 << t) - 1)) == 0 && rank[q] + (1 << t) < size[q];
#pragma unroll
          for (int e = 0; e < CB; ++e) {
            const float o = __shfl_sync(kFull, v[q][e], src);
            if (recv) v[q][e] += o;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kBatches; ++q) {
      if ((live >> q) & 1u) {
        if ((lead >> q) & 1u) {
          // The channels' words are distinct: all reads, then all writes.
          float* tp = tile + slot[q];
          float old[CB];
#pragma unroll
          for (int e = 0; e < CB; ++e) old[e] = tp[e * chs];
#pragma unroll
          for (int e = 0; e < CB; ++e) tp[e * chs] = old[e] + v[q][e];
        }
        // The next batch's reads see this batch's writes.
        __syncwarp();
      }
    }
  };

  // Stage st is in buffer st & 1 and, a stage earlier, in registers a
  // (even st) or b (odd). At the top of each stage every warp is done with
  // the previous one, whose buffer then takes the next stage.
  Ahead a, b;
  load(a);
  put(0, a);
  load(b);
  for (int64_t st = 0; st < stages; st += 2) {
    __syncthreads();
    put(1, b);
    load(a);
    consume(0, s_begin + st * kVolStage);
    if (st + 1 == stages) break;
    __syncthreads();
    put(0, a);
    load(b);
    consume(1, s_begin + (st + 1) * kVolStage);
  }
  __syncthreads();

  // The tile, voxel by voxel in dvol's order, to dvol (one slice) or to
  // this slice's partials (slices, NV, C, D * H * W).
  const int j = d * h * w;
  float* dst = out + ((sl * nv + vi) * c + c0) * j;
  const int zy0 = tid / w;
  int x = tid - zy0 * w, y = zy0 % h, z = zy0 / h;
  const int step_zy = kVolThreads / w, step_x = kVolThreads % w;
  const int step_y = step_zy % h, step_z = step_zy / h;
  for (int o = tid; o < j; o += kVolThreads) {
    const int slot = class_slot(((z & 1) << 2) | ((y & 1) << 1) | (x & 1), x,
                                y, z, py, pz, cls);
    for (int e = 0; e < cn; ++e) dst[(int64_t)e * j + o] = tile[e * chs + slot];
    x += step_x;
    y += step_y;
    z += step_z;
    if (x >= w) x -= w, ++y;
    if (y >= h) y -= h, ++z;
  }
}

template <typename GT, int CB, bool kSharedTaps>
int launch_bwd_vol_tiled(const void* grid, const void* g, void* partials,
                         void* dvol, int64_t nv, int64_t n, int64_t c, int d,
                         int h, int w, int64_t k, int slices,
                         int64_t slice_len, int py, int pz, int cls,
                         bool border, cudaStream_t stream) {
  const size_t smem = (size_t)bwd_vol_smem_words(CB, cls, kSharedTaps) * 4;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = fused_sample_bwd_vol_tiled_kernel<GT, CB, kSharedTaps>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t groups = ceil_div(c, CB);
  if (nv * slices > 0x7fffffff || groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 blocks((unsigned)(nv * slices), (unsigned)groups);
  kernel<<<blocks, kVolThreads, smem, stream>>>(
      static_cast<const float*>(grid), static_cast<const GT*>(g),
      static_cast<float*>(slices == 1 ? dvol : partials), nv, n / nv, c, d, h,
      w, k, slices, slice_len, py, pz, cls, border);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const int64_t m = nv * c * d * h * w;
  sum_partials_kernel<<<(unsigned)ceil_div(m, kReduceThreads), kReduceThreads,
                        0, stream>>>(static_cast<const float*>(partials),
                                     static_cast<float*>(dvol), m, slices);
  return (int)cudaGetLastError();
}

template <typename GT>
int bwd_vol_tiled_by_channels(int channels, bool shared_taps,
                              const void* grid, const void* g, void* partials,
                              void* dvol, int64_t nv, int64_t n, int64_t c,
                              int d, int h, int w, int64_t k, int slices,
                              int64_t slice_len, int py, int pz, int cls,
                              bool border, cudaStream_t stream) {
#define LF_BWD_VOL_TILED(CB, TAPS)                                          \
  return launch_bwd_vol_tiled<GT, CB, TAPS>(grid, g, partials, dvol, nv, n, \
                                            c, d, h, w, k, slices,          \
                                            slice_len, py, pz, cls, border, \
                                            stream)
  if (!shared_taps) {
    if (channels == 1) LF_BWD_VOL_TILED(1, false);
    return (int)cudaErrorInvalidValue;
  }
  switch (channels) {
    case 1: LF_BWD_VOL_TILED(1, true);
    case 2: LF_BWD_VOL_TILED(2, true);
    case 4: LF_BWD_VOL_TILED(4, true);
    case 8: LF_BWD_VOL_TILED(8, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LF_BWD_VOL_TILED
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

struct StagedGrid {
  template <typename VolT, typename GT>
  static int run(const void* vol, const void* grid, const void* g,
                 void* partials, void* dgrid, int64_t nv, int64_t n, int64_t c,
                 int d, int h, int w, int64_t k, int tile, int group_channels,
                 int groups, bool border, cudaStream_t stream) {
    return launch_bwd_grid_staged_by_size<VolT, GT>(
        vol, grid, g, partials, dgrid, nv, n, c, d, h, w, k, tile,
        group_channels, groups, border, stream);
  }
};

struct PerSampleGrid {
  template <typename VolT, typename GT>
  static int run(const void* vol, const void* grid, const void* g, void*,
                 void* dgrid, int64_t nv, int64_t n, int64_t c, int d, int h,
                 int w, int64_t k, int, int, int, bool border,
                 cudaStream_t stream) {
    return launch_bwd_grid_per_sample<VolT, GT>(vol, grid, g, dgrid, nv, n, c,
                                                d, h, w, k, border, stream);
  }
};

template <typename L>
int bwd_grid_dispatch(const void* vol, const void* grid, const void* g,
                      void* partials, void* dgrid, int64_t nv, int64_t n,
                      int64_t c, int64_t d, int64_t h, int64_t w, int64_t k,
                      int tile, int group_channels, int groups, int border,
                      int vol_dtype, int g_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b = border != 0;
  if (vol_dtype == 0 && g_dtype == 0)
    return L::template run<float, float>(vol, grid, g, partials, dgrid, nv, n,
                                         c, d, h, w, k, tile, group_channels,
                                         groups, b, s);
  if (vol_dtype == 0 && g_dtype == 1)
    return L::template run<float, __nv_bfloat16>(
        vol, grid, g, partials, dgrid, nv, n, c, d, h, w, k, tile,
        group_channels, groups, b, s);
  if (vol_dtype == 1 && g_dtype == 0)
    return L::template run<__nv_bfloat16, float>(
        vol, grid, g, partials, dgrid, nv, n, c, d, h, w, k, tile,
        group_channels, groups, b, s);
  if (vol_dtype == 1 && g_dtype == 1)
    return L::template run<__nv_bfloat16, __nv_bfloat16>(
        vol, grid, g, partials, dgrid, nv, n, c, d, h, w, k, tile,
        group_channels, groups, b, s);
  return (int)cudaErrorInvalidValue;
}

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

// d/dgrid entry points, one per kernel; the caller picks by volume size and
// gives the staged kernel its plan (ops/fused_sample.py:bwd_grid_plan):
// samples a block walks, channels a group and the number of groups, with a
// partials buffer of groups * N * K * 3 floats (dgrid itself where there is
// one group). dtype codes: 0 = fp32, 1 = bf16, for the volume and for g.
// Each returns the launches' CUDA error code.
int lf_fused_sample_bwd_grid_staged(const void* vol, const void* grid,
                                    const void* g, void* partials,
                                    void* dgrid, int64_t nv, int64_t n,
                                    int64_t c, int64_t d, int64_t h, int64_t w,
                                    int64_t k, int64_t tile,
                                    int64_t group_channels, int64_t groups,
                                    int border, int vol_dtype, int g_dtype,
                                    void* stream) {
  if (n == 0 || k == 0) return 0;
  if (c == 0) return (int)cudaMemsetAsync(dgrid, 0, (size_t)(n * k * 3) * 4,
                                          static_cast<cudaStream_t>(stream));
  return bwd_grid_dispatch<StagedGrid>(
      vol, grid, g, partials, dgrid, nv, n, c, d, h, w, k, (int)tile,
      (int)group_channels, (int)groups, border, vol_dtype, g_dtype, stream);
}

int lf_fused_sample_bwd_grid_per_sample(const void* vol, const void* grid,
                                        const void* g, void* dgrid, int64_t nv,
                                        int64_t n, int64_t c, int64_t d,
                                        int64_t h, int64_t w, int64_t k,
                                        int border, int vol_dtype, int g_dtype,
                                        void* stream) {
  if (n == 0 || k == 0) return 0;
  return bwd_grid_dispatch<PerSampleGrid>(
      vol, grid, g, nullptr, dgrid, nv, n, c, d, h, w, k, 0, 0, 0, border,
      vol_dtype, g_dtype, stream);
}

// d/dvol entry points, one per kernel; the caller picks by volume size and
// gives the tiled kernel its plan (ops/fused_sample.py:bwd_vol_plan):
// channels a block (1, 2, 4 or 8), sample slices a volume and samples a
// slice, the class tile's row and plane pitches and words a class, and
// whether the taps are kept in shared memory (else 1 channel a block), with
// a partials buffer of slices * NV * C * D * H * W floats (dvol itself where
// there is one slice). dtype code of g: 0 = fp32, 1 = bf16. Each returns
// the launches' CUDA error code.
int lf_fused_sample_bwd_vol_tiled(const void* grid, const void* g,
                                  void* partials, void* dvol, int64_t nv,
                                  int64_t n, int64_t c, int64_t d, int64_t h,
                                  int64_t w, int64_t k, int64_t channels,
                                  int64_t slices, int64_t slice_len,
                                  int64_t pitch_y, int64_t pitch_z,
                                  int64_t class_words, int shared_taps,
                                  int border, int g_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 0) return 0;
  if (n == 0 || k == 0)
    return (int)cudaMemsetAsync(dvol, 0, (size_t)(nv * c * d * h * w) * 4, s);
  // The slices must cover each volume's samples, none of them empty, and
  // the pitches must hold each class's (D/2, H/2, W/2) sub-volume.
  const int64_t per_volume = n / nv * k;
  if (slices < 1 || slice_len < 1 || slices * slice_len < per_volume ||
      (slices - 1) * slice_len >= per_volume || pitch_y < (w + 1) / 2 ||
      pitch_z < (h + 1) / 2 * pitch_y || class_words < (d + 1) / 2 * pitch_z)
    return (int)cudaErrorInvalidValue;
  const bool b = border != 0, taps = shared_taps != 0;
  if (g_dtype == 0)
    return bwd_vol_tiled_by_channels<float>(
        (int)channels, taps, grid, g, partials, dvol, nv, n, c, (int)d,
        (int)h, (int)w, k, (int)slices, slice_len, (int)pitch_y,
        (int)pitch_z, (int)class_words, b, s);
  if (g_dtype == 1)
    return bwd_vol_tiled_by_channels<__nv_bfloat16>(
        (int)channels, taps, grid, g, partials, dvol, nv, n, c, (int)d,
        (int)h, (int)w, k, (int)slices, slice_len, (int)pitch_y,
        (int)pitch_z, (int)class_words, b, s);
  return (int)cudaErrorInvalidValue;
}

// Zeroes dvol (NV * C * D * H * W floats) on the stream, then scatters into
// it with atomics (not bit-reproducible; for volumes whose channel does not
// fit in shared memory).
int lf_fused_sample_bwd_vol_atomic(const void* grid, const void* g,
                                   void* dvol, int64_t nv, int64_t n,
                                   int64_t c, int64_t d, int64_t h, int64_t w,
                                   int64_t k, int border, int g_dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)(nv * c * d * h * w) * sizeof(float);
  cudaError_t err = cudaMemsetAsync(dvol, 0, bytes, s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || c == 0 || k == 0) return 0;
  const bool b = border != 0;
  if (g_dtype == 0)
    launch_bwd_vol_atomic<float>(grid, g, dvol, nv, n, c, d, h, w, k, b, s);
  else if (g_dtype == 1)
    launch_bwd_vol_atomic<__nv_bfloat16>(grid, g, dvol, nv, n, c, d, h, w, k,
                                         b, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* lf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
