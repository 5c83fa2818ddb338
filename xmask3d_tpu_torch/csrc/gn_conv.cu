// Kernel K4: GroupNorm -> SiLU -> 3x3 SAME conv + bias, computed from the raw
// activation, with the group statistics in two kernels of their own; layout
// NHWC, contiguous.
//
// Replaces: xmask3d_tpu/ops/gn_conv.py `_fused_forward` (:141; kernel body
// `_kernel` :83), dispatched by `gn_silu_conv`, and the statistics it leaves
// to XLA (`_affine_from_stats` :68).
//
// Contract:
//   out[b, y, x, o] = bias[o] + sum_{dy, dx in -1..1} sum_c n[b, y+dy, x+dx, c] * w[dy+1, dx+1, c, o]
//   n[b, i, j, c]   = silu(x[b, i, j, c] * a[b, c] + s[b, c]) rounded to x's type,
//                     0 outside the image
// The SAME padding pads the normalised tensor with zeros, not x, so silu(s)
// never reaches the border. a and s are the per-(batch, channel) fp32 affine
// of the group statistics. Sums are fp32, the bias is added in fp32 and the
// result is cast once.
//
// What bounds it on an H100: at the VAE's shapes (C, C_out in 128..512 over
// 512^2..64^2 maps) a call does 18 * H * W * C * C_out operations against
// about 2 * H * W * (C + C_out) bytes, e.g. 77 GFLOP against 134 MB at the
// 512^2 level, so the conv is bound by the bf16 tensor cores; the statistics
// are one read of x, bound by bytes.
//
// Statistics (`gn_stats_kernel`, `gn_affine_kernel`): x is read once in its
// own type, 16 bytes a load where C and x's alignment allow. Block k of a
// batch takes a contiguous range of pixels; each thread keeps Welford's
// running mean and M2 of its channels in fp32, and the block merges them per
// group by Chan's formula in closed form (the count-weighted mean of the
// parts, then M2 = sum of M2_k + n_k (mean_k - mean)^2) in fp64, so nothing subtracts two large sums even where a
// group's mean is large against its spread, and nothing drifts in a long
// chain of fp32 merges (the fp32 tiny model's later layers amplify a 1e-7
// drift of the statistics past its check). The second kernel (one block a
// group) merges the blocks' (mean, M2) the same way in a fixed order, then
// var = M2 / n, a = scale / sqrt(var + eps), s = bias - mean * a, each
// rounded once to fp32. No fp32 copy of x is made. Any C: a thread takes
// the channel slots of a pixel row past the block's 256 threads in turn.
//
// Conv (bf16, `gn_conv_wgmma_kernel<BN>`): an implicit GEMM, M = output
// pixels in tiles of 4 rows x 64 columns (256 pixels), N = BN output channels
// (128, or 64 where the grid would not fill the card: the 64^2 maps), K = 9
// taps x C in chunks of 64 channels. Both operands of wgmma m64nBNk16 come
// from shared memory in the no-swizzle core-matrix layout: the halo is stored
// as [8-channel group][halo pixel][8 channels], so a tap's one-pixel shift is
// 16 bytes more in the A descriptor's start address, and a 64-pixel image row
// of the tile is 64 consecutive halo pixels. Weights arrive already in that
// layout (`kernel_params`: [chunk][tap][8-channel group][C_out padded to
// 128][8]), so a (tap, chunk) slice is one bulk copy per channel group.
// The block is warp-specialised, 512 threads:
//   - two consumer warpgroups (200 registers a thread by setmaxnreg), each
//     owning two image rows (two m64 tiles) x BN channels in fp32
//     accumulators: per (chunk, tap) step they wait on mbarriers for the
//     step's weights and, at a chunk's first tap, its normalised halo, issue
//     8 wgmma (4 k16 slices x 2 m64 tiles), wait for them and release the
//     stages;
//   - producer warp 0: one thread streams the weight slices into a ring of
//     six stages by TMA bulk copies (cp.async.bulk, completion counted on the
//     stage's mbarrier), so no thread spends instructions on them and no
//     proxy fence is needed;
//   - producer warps 1-7: each chunk's raw halo by 16-byte cp.async into one
//     of two halo stages (three for BN = 64), then the affine + SiLU pass in
//     place (zero outside the image and past C), a fence.proxy.async and an
//     arrival on the stage's mbarrier.
// The products of chunk c run while the producers stage and normalise chunk
// c + 1, so the normalised activation never reaches device memory and its
// pass overlaps the tensor cores. A tile reads each weight once per 256
// pixels and each halo once per BN output channels. What holds it, on an
// NVIDIA H100 80GB HBM3 at 700 W: the products alone take 2.7 ms of the
// VAE's 34 calls and the producers' normalisation alone 2.4 ms, and run
// together they add up rather than overlap (PERF.md).
// Widths off 8 channels stage the halo by plain loads; any B, H, W, C and
// C_out: ragged tiles, chunks and output tiles are masked or zero-padded.
//
// Row bands (the VAE under activation sharding): `xm_gn_moments` gives a
// band's per-(batch, group) count, mean and M2 in fp64 (`gn_stats_kernel`,
// then `gn_moments_kernel`, the merge of `gn_affine_kernel`); the wrapper
// merges the ranks' moments in rank order by the same formula and runs the
// conv on the band with one raw row of each neighbour, whose outputs it
// drops. The conv's zero padding is then only at the map's true edges.
//
// fp32 inputs (the checks and the fp32 tiny model) take the CUDA-core FMA
// kernel `gn_conv_f32_kernel` (8 x 16 pixels x 64 channels a block) with the
// weights as (tap, C_out, C).
//
// The models' plain GroupNorm calls (`group_norm` in ops/gn_conv.py: every
// call autograd does not record, SiLU fused where the model applies it next)
// reuse the statistics: `xm_gn_moments`, then `gn_apply_kernel`, which reads
// x a second time in its own type and writes (x - mean) * (scale / sqrt(M2 /
// n + eps)) + bias, SiLU'd or not, once in x's type. Three launches a call,
// about 6 bytes a bf16 value; bound by bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace xm;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// VEC consecutive values of x as floats: one 16-byte load where VEC > 1
template <int VEC>
__device__ __forceinline__ void load_vals(const bf16* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __bfloat162float(p[j]);
  }
}
template <int VEC>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = p[j];
  }
}

// ---------------------------------------------------------------------------
// group statistics
// ---------------------------------------------------------------------------

constexpr int ST = 256;  // threads of the statistics kernels

// Sums over a warp and over a block in a fixed order (a shuffle tree, then
// the warps in order), so a run gives the same bits every time
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
// the sum over each aligned run of `width` lanes (a power of two up to 32),
// the same tree on every run; all 32 lanes of the warp take part
__device__ __forceinline__ double lanes_sum(double v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ double block_sum(double v, double* red) {  // red: ST / 32 doubles
  v = warp_sum(v);
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < ST / 32; ++w) t += red[w];
  return t;
}

// One pixel's VEC values into a thread's running moments of its channels:
// Welford's update, n counting the pixels (1 / n correctly rounded)
template <int VEC>
__device__ __forceinline__ void welford(const float (&v)[VEC], float& n, float (&mean)[VEC],
                                        float (&m2)[VEC]) {
  n += 1.f;
  const float inv = __frcp_rn(n);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float delta = v[i] - mean[i];
    mean[i] = fmaf(delta, inv, mean[i]);
    m2[i] = fmaf(delta, v[i] - mean[i], m2[i]);
  }
}

// Block (k, b) takes pixels [k * ppb, (k + 1) * ppb) of batch b. A thread
// owns VEC channels (one 16-byte slot of a pixel's row) of every rows-th
// pixel of the range, where rows = max(1, ST / slots) and slots = C / VEC;
// where C has more slots than the block has threads, a thread takes slots
// j, j + ST, ... one after another. It keeps Welford's running mean and M2
// per channel in fp32 (four pixels' loads in flight ahead of their updates),
// then puts them in shared memory (dynamic: mean and M2 of rows x C values,
// then rows counts). The block then merges the threads' moments of each
// group in fp64, ST / G threads a group at once, by Chan's formula in closed
// form (the count-weighted mean of the parts, then M2 = sum of the parts' M2
// + n (mean - part mean)^2): part[b, k, g] = (mean, M2).
template <typename T, int VEC>
__global__ void __launch_bounds__(ST) gn_stats_kernel(const T* __restrict__ x,
                                                     double* __restrict__ part, int hw, int C,
                                                     int G, int ppb) {
  extern __shared__ float sm[];
  const int b = blockIdx.y, k = blockIdx.x, P = gridDim.x;
  const int slots = C / VEC, rows = max(1, ST / slots);
  float* mean_s = sm;
  float* m2_s = sm + (size_t)rows * C;
  float* cnt = sm + 2 * (size_t)rows * C;
  const int tid = threadIdx.x, r = tid / slots;
  const int cg = C / G;
  const T* x_b = x + (size_t)b * hw * C;
  const int p0 = k * ppb, p1 = min(hw, p0 + ppb);
  if (r < rows) {
    for (int j = tid % slots; j < slots; j += ST) {
      float mean[VEC], m2[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.f;
      float n = 0.f;
      const T* x_j = x_b + (size_t)j * VEC;
      int p = p0 + r;
      for (; p + 3 * rows < p1; p += 4 * rows) {  // four loads in flight, then their updates
        float v[4][VEC];
#pragma unroll
        for (int u = 0; u < 4; ++u) load_vals<VEC>(x_j + (size_t)(p + u * rows) * C, v[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) welford<VEC>(v[u], n, mean, m2);
      }
      for (; p < p1; p += rows) {
        float v[VEC];
        load_vals<VEC>(x_j + (size_t)p * C, v);
        welford<VEC>(v, n, mean, m2);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        mean_s[r * C + j * VEC + i] = mean[i];
        m2_s[r * C + j * VEC + i] = m2[i];
      }
      if (j == 0) cnt[r] = n;
    }
  }
  __syncthreads();
  // tpg threads a group (a power of two up to a warp: all 256 threads at
  // once where G allows), each group's parts split among them and summed by
  // a shuffle tree within their aligned lanes; every thread runs every pass
  const int parts = rows * cg;  // (row, channel) parts of a group
  const double n_g = (double)(p1 - p0) * cg;
  const int tpg = G >= ST ? 1 : min(32, 1 << (31 - __clz(ST / G)));
  const int sub = tid % tpg;
  for (int g0 = 0; g0 < G; g0 += ST / tpg) {
    const int g = g0 + tid / tpg;
    double s1 = 0.0;
    if (g < G) {
      for (int q = sub; q < parts; q += tpg) {
        const int rr = q / cg, c = g * cg + q % cg;
        s1 += (double)cnt[rr] * mean_s[rr * C + c];
      }
    }
    const double mean = lanes_sum(s1, tpg) / n_g;
    double s2 = 0.0;
    if (g < G) {
      for (int q = sub; q < parts; q += tpg) {
        const int rr = q / cg, c = g * cg + q % cg;
        const double d = mean_s[rr * C + c] - mean;
        s2 += m2_s[rr * C + c] + (double)cnt[rr] * d * d;
      }
    }
    s2 = lanes_sum(s2, tpg);
    if (g < G && sub == 0) {
      double* dst = part + (((size_t)b * P + k) * G + g) * 2;
      dst[0] = mean;
      dst[1] = s2;
    }
  }
}

// The P partials of group g of batch b (part_g: partial k at + k * G * 2)
// merged the same way in fp64 (thread t takes k = t, t + 256, ...;
// fixed-order block sums): the group's mean and M2 over its hw * cg values.
__device__ void merge_partials(const double* __restrict__ part_g, int hw, int cg, int G, int P,
                               int ppb, double* red, double& mean, double& m2) {
  const double n = (double)hw * cg;
  double s1 = 0.0;
  for (int k = threadIdx.x; k < P; k += ST)
    s1 += (double)(min(hw, (k + 1) * ppb) - k * ppb) * cg * part_g[(size_t)k * G * 2];
  mean = block_sum(s1, red) / n;
  double s2 = 0.0;
  for (int k = threadIdx.x; k < P; k += ST) {
    const double d = part_g[(size_t)k * G * 2] - mean;
    s2 += part_g[(size_t)k * G * 2 + 1] + (double)(min(hw, (k + 1) * ppb) - k * ppb) * cg * d * d;
  }
  m2 = block_sum(s2, red);
}

// Block (g, b): the group's partials merged, then a and s of its channels,
// var = M2 / n, each rounded once to fp32.
template <typename PT>
__global__ void __launch_bounds__(ST) gn_affine_kernel(
    const double* __restrict__ part, const PT* __restrict__ scale, const PT* __restrict__ bias,
    float* __restrict__ a, float* __restrict__ s, int hw, int C, int G, int P, int ppb,
    float eps) {
  __shared__ double red[ST / 32];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int cg = C / G;
  const double n = (double)hw * cg;
  double mean, m2;
  merge_partials(part + ((size_t)b * P * G + g) * 2, hw, cg, G, P, ppb, red, mean, m2);
  const double inv = 1.0 / sqrt(fmax(m2 / n, 0.0) + (double)eps);
  for (int c = g * cg + tid; c < (g + 1) * cg; c += ST) {
    const double av = inv * (double)to_f(scale[c]);
    a[(size_t)b * C + c] = (float)av;
    s[(size_t)b * C + c] = (float)((double)to_f(bias[c]) - mean * av);
  }
}

// Block (g, b): the group's partials merged into mom[b, g] = (count, mean,
// M2) in fp64, for a row band whose moments merge with other ranks' before
// the affine (the wrapper's `affine_from_moments`, the same formula).
__global__ void __launch_bounds__(ST) gn_moments_kernel(const double* __restrict__ part,
                                                       double* __restrict__ mom, int hw, int C,
                                                       int G, int P, int ppb) {
  __shared__ double red[ST / 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  double mean, m2;
  merge_partials(part + ((size_t)b * P * G + g) * 2, hw, cg, G, P, ppb, red, mean, m2);
  if (threadIdx.x == 0) {
    double* dst = mom + ((size_t)b * G + g) * 3;
    dst[0] = (double)hw * cg;
    dst[1] = mean;
    dst[2] = m2;
  }
}

template <typename T, int VEC>
int launch_stats(const void* x, void* part, int B, int hw, int C, int G, int P, int ppb,
                 cudaStream_t stream) {
  const int slots = C / VEC, rows = slots < ST ? ST / slots : 1;
  const size_t smem = (2 * (size_t)rows * C + rows) * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)  // C of 6144 or more: past the default, up to the SM's 227 KB
    err = cudaFuncSetAttribute(gn_stats_kernel<T, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gn_stats_kernel<T, VEC><<<dim3(P, B), ST, smem, stream>>>((const T*)x, (double*)part, hw, C,
                                                            G, ppb);
  return (int)cudaGetLastError();
}

template <typename T, typename PT, int VEC>
int launch_affine(const void* x, void* part, const void* scale, const void* bias, void* a,
                  void* s, int B, int hw, int C, int G, int P, int ppb, float eps,
                  cudaStream_t stream) {
  const int err = launch_stats<T, VEC>(x, part, B, hw, C, G, P, ppb, stream);
  if (err != 0) return err;
  gn_affine_kernel<PT><<<dim3(G, B), ST, 0, stream>>>(
      (const double*)part, (const PT*)scale, (const PT*)bias, (float*)a, (float*)s, hw, C, G, P,
      ppb, eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_moments(const void* x, void* part, void* mom, int B, int hw, int C, int G, int P,
                   int ppb, cudaStream_t stream) {
  const int err = launch_stats<T, VEC>(x, part, B, hw, C, G, P, ppb, stream);
  if (err != 0) return err;
  gn_moments_kernel<<<dim3(G, B), ST, 0, stream>>>((const double*)part, (double*)mom, hw, C, G,
                                                   P, ppb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GroupNorm applied (the model's plain GroupNorm calls on the card)
// ---------------------------------------------------------------------------

// VEC floats written as VEC consecutive values of y's type, rounded to
// nearest even: one 16-byte store where VEC > 1
template <int VEC>
__device__ __forceinline__ void store_vals(bf16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) h2[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = __float2bfloat16_rn(v[j]);
  }
}
template <int VEC>
__device__ __forceinline__ void store_vals(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = v[j];
  }
}

// SiLU with the fast exponential and division (a few ulps of fp32, far below
// a bf16 ulp), as the bf16 conv's producers and the apply pass take it: a
// pass bound by bytes stays so only while its arithmetic is small against
// them. Where exp(-z) overflows, z / inf = -0.
__device__ __forceinline__ float silu_fast(float z) { return __fdividef(z, 1.f + __expf(-z)); }

// y = (x - mean_g) * (scale_c / sqrt(M2_g / n + eps)) + bias_c in fp32, SiLU
// after it where SILU, written once in x's type. The centred form: the fold
// x * a + (bias - mean * a) cancels where |mean| / sqrt(var + eps) is large
// (a group of equal values). mom (B, G, 3) is `gn_moments_kernel`'s (count,
// mean, M2); the block first puts each group's mean and 1 / sqrt(M2 / n +
// eps) (fp64, rounded once, as `gn_affine_kernel` takes it) in shared memory,
// one group a thread. Block (k, b) and its threads cover pixels as
// `gn_stats_kernel` does (thread: VEC channels of every rows-th pixel of the
// block's range, slots past 256 in turn), so a thread's channel constants
// stay in registers; four loads of 16 bytes are in flight before the stores.
template <typename T, typename PT, int VEC, bool SILU>
__global__ void __launch_bounds__(ST) gn_apply_kernel(const T* __restrict__ x,
                                                     const double* __restrict__ mom,
                                                     const PT* __restrict__ scale,
                                                     const PT* __restrict__ bias,
                                                     T* __restrict__ y, int hw, int C, int G,
                                                     int ppb, float eps) {
  constexpr int U = 4;
  extern __shared__ float group_sm[];  // G means, then G inverse deviations
  const int b = blockIdx.y, k = blockIdx.x, tid = threadIdx.x;
  for (int g = tid; g < G; g += ST) {
    const double* m = mom + ((size_t)b * G + g) * 3;
    group_sm[g] = (float)m[1];
    group_sm[G + g] = (float)(1.0 / sqrt(fmax(m[2] / m[0], 0.0) + (double)eps));
  }
  __syncthreads();
  const int slots = C / VEC, rows = max(1, ST / slots);
  const int r = tid / slots;
  if (r >= rows) return;
  const int cg = C / G;
  const size_t base = (size_t)b * hw * C;
  const int p0 = k * ppb, p1 = min(hw, p0 + ppb);
  for (int j = tid % slots; j < slots; j += ST) {
    float mean[VEC], mul[VEC], add[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = j * VEC + i, g = c / cg;
      mean[i] = group_sm[g];
      mul[i] = group_sm[G + g] * to_f(scale[c]);
      add[i] = to_f(bias[c]);
    }
    const size_t col = base + (size_t)j * VEC;
    int p = p0 + r;
    for (; p + (U - 1) * rows < p1; p += U * rows) {
      float v[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) load_vals<VEC>(x + col + (size_t)(p + u * rows) * C, v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float z = fmaf(v[u][i] - mean[i], mul[i], add[i]);
          v[u][i] = SILU ? silu_fast(z) : z;
        }
        store_vals<VEC>(y + col + (size_t)(p + u * rows) * C, v[u]);
      }
    }
    for (; p < p1; p += rows) {
      float v[VEC];
      load_vals<VEC>(x + col + (size_t)p * C, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float z = fmaf(v[i] - mean[i], mul[i], add[i]);
        v[i] = SILU ? silu_fast(z) : z;
      }
      store_vals<VEC>(y + col + (size_t)p * C, v);
    }
  }
}

template <typename T, typename PT, int VEC, bool SILU>
int launch_apply_as(const void* x, const void* mom, const void* scale, const void* bias,
                    void* y, int B, int hw, int C, int G, int P, int ppb, float eps,
                    cudaStream_t stream) {
  const size_t smem = 2 * (size_t)G * sizeof(float);
  if (smem > 48 * 1024) {  // more than 6144 groups: past the default, up to 227 KB
    const cudaError_t err = cudaFuncSetAttribute(
        gn_apply_kernel<T, PT, VEC, SILU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gn_apply_kernel<T, PT, VEC, SILU><<<dim3(P, B), ST, smem, stream>>>(
      (const T*)x, (const double*)mom, (const PT*)scale, (const PT*)bias, (T*)y, hw, C, G, ppb,
      eps);
  return (int)cudaGetLastError();
}

template <typename T, typename PT, int VEC>
int launch_apply(const void* x, const void* mom, const void* scale, const void* bias, void* y,
                 int B, int hw, int C, int G, int P, int ppb, int silu, float eps,
                 cudaStream_t stream) {
  return silu ? launch_apply_as<T, PT, VEC, true>(x, mom, scale, bias, y, B, hw, C, G, P, ppb,
                                                  eps, stream)
              : launch_apply_as<T, PT, VEC, false>(x, mom, scale, bias, y, B, hw, C, G, P, ppb,
                                                   eps, stream);
}

// ---------------------------------------------------------------------------
// bf16 conv: wgmma
// ---------------------------------------------------------------------------

constexpr int TH = 4;                   // tile rows
constexpr int TW = 64;                  // tile columns (one m64 tile a row)
constexpr int HWD = TW + 2;             // halo columns
constexpr int HPIX = (TH + 2) * HWD;    // halo pixels (396)
constexpr int HPIX_P = 401;             // the channel-group stride in pixels, odd in 16-byte
                                        // units mod 8, so 8 threads' copies hit 8 bank groups
constexpr int KC = 64;                  // channels a chunk
constexpr int KG = KC / 8;              // 8-channel groups a chunk
constexpr int TAPS = 9;
constexpr int CONSUMERS = 256;          // two warpgroups multiply
constexpr int NT = CONSUMERS + 256;     // and two produce
constexpr int HALO_THREADS = 224;       // the producers' warps 1-7: halo and normalisation
constexpr int HALO_BYTES = KG * HPIX_P * 16;

template <int BN>
struct ConvCfg {
  static constexpr int NH = BN == 128 ? 2 : 3;  // halo stages
  static constexpr int NSW = 6;                 // weight ring stages
  static constexpr int W_BYTES = KG * BN * 16;
  static constexpr int BAR_OFF = NH * HALO_BYTES + NSW * W_BYTES;
  // + mbarriers (full and empty per weight and halo stage), then the chunk's a and s
  static constexpr int AS_OFF = BAR_OFF + 8 * 2 * (NSW + NH);
  static constexpr int SMEM = AS_OFF + 2 * KC * 4;
};

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    wgmma_m64n128k16(d, da, db);
  else
    wgmma_m64n64k16(d, da, db);
}

template <int BN>
__global__ void __launch_bounds__(NT, 1) gn_conv_wgmma_kernel(
    const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ s,
    const bf16* __restrict__ wk,  // (chunks, 9, KG, cout_p, 8)
    const float* __restrict__ bias, bf16* __restrict__ out, int H, int W, int C, int Cout,
    int cout_p, int n_chunks, int tiles_w, int vec) {
  using Cfg = ConvCfg<BN>;
  constexpr int NH = Cfg::NH, NSW = Cfg::NSW, W_BYTES = Cfg::W_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* halo_s = smem;                       // NH stages of [KG][HPIX_P][8] bf16
  unsigned char* w_s = smem + NH * HALO_BYTES;        // NSW stages of [KG][BN][8] bf16
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem + Cfg::BAR_OFF);
  uint64_t* w_empty = w_full + NSW;
  uint64_t* h_full = w_empty + NSW;
  uint64_t* h_empty = h_full + NH;
  float* as_s = reinterpret_cast<float*>(smem + Cfg::AS_OFF);  // a, then s, of a chunk

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n_steps = n_chunks * TAPS;

  if (tid == 0) {
    for (int i = 0; i < NSW; ++i) {
      mbar_init(&w_full[i], 1);           // the producer's arrive.expect_tx
      mbar_init(&w_empty[i], CONSUMERS / 32);  // one arrival per consumer warp
    }
    for (int i = 0; i < NH; ++i) {
      mbar_init(&h_full[i], HALO_THREADS);
      mbar_init(&h_empty[i], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroups ----
    warpgroup_regs_dec<56>();  // 256 x 200 + 256 x 56 = 65536 registers
    const int ptid = tid - CONSUMERS;
    if (ptid < 32) {
      // warp 0: the weight ring, one bulk copy per 8-channel group
      if (ptid == 0) {
        for (int st = 0; st < n_steps; ++st) {
          const int stage = st % NSW, use = st / NSW;
          if (use > 0) mbar_wait(&w_empty[stage], (use - 1) & 1);
          const int c = st / TAPS, tap = st - c * TAPS;
          const bf16* src = wk + (((size_t)c * TAPS + tap) * KG * cout_p + n0) * 8;
          unsigned char* dst = w_s + stage * W_BYTES;
          mbar_arrive_expect_tx(&w_full[stage], W_BYTES);
#pragma unroll
          for (int kg = 0; kg < KG; ++kg)
            bulk_copy_g2s(dst + kg * BN * 16, src + (size_t)kg * cout_p * 8, BN * 16,
                          &w_full[stage]);
        }
      }
    } else {
      // warps 1-7: each chunk's halo, raw by cp.async (neighbouring threads
      // copy one pixel's 128 bytes), then normalised in place, a thread a
      // halo pixel at a time: affine, SiLU, zero outside the image; channels
      // past C have a = s = 0 and load as 0, so they normalise to 0
      const int htid = ptid - 32;
      const bf16* x_b = x + (size_t)b * H * W * C;
      for (int c = 0; c < n_chunks; ++c) {
        const int stage = c % NH, use = c / NH;
        if (use > 0) mbar_wait(&h_empty[stage], (use - 1) & 1);
        unsigned char* base = halo_s + stage * HALO_BYTES;
        for (int e = htid; e < HPIX * KG; e += HALO_THREADS) {
          const int p = e / KG, kg = e % KG;
          const int y = ty0 + p / HWD - 1, xx = tx0 + p % HWD - 1;
          const int ch = c * KC + kg * 8;
          const bool in = y >= 0 && y < H && xx >= 0 && xx < W && ch < C;
          unsigned char* dst = base + (kg * HPIX_P + p) * 16;
          const bf16* src = x_b + ((size_t)(in ? y : 0) * W + (in ? xx : 0)) * C + (in ? ch : 0);
          if (vec) {
            cp_async_16(dst, src, in ? 16 : 0);
          } else {
            // widths off 8 channels or x off 16 bytes: plain loads
            __align__(16) bf16 v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = (in && ch + j < C) ? src[j] : __float2bfloat16(0.f);
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
          }
        }
        cp_async_commit();
        if (htid < KC) {
          const int ch = c * KC + htid;
          as_s[htid] = ch < C ? a[(size_t)b * C + ch] : 0.f;
          as_s[KC + htid] = ch < C ? s[(size_t)b * C + ch] : 0.f;
        }
        cp_async_wait<0>();
        named_barrier(1, HALO_THREADS);  // the raw chunk and its a, s are in
        for (int p = htid; p < HPIX; p += HALO_THREADS) {
          const int y = ty0 + p / HWD - 1, xx = tx0 + p % HWD - 1;
          const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll 4
          for (int kg = 0; kg < KG; ++kg) {
            uint4* cell = reinterpret_cast<uint4*>(base + (kg * HPIX_P + p) * 16);
            uint4 packed = make_uint4(0u, 0u, 0u, 0u);
            if (inside) {
              const uint4 raw = *cell;
              const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
              const float4* av = reinterpret_cast<const float4*>(as_s + kg * 8);
              const float4* sv = reinterpret_cast<const float4*>(as_s + KC + kg * 8);
              const float4 a0 = av[0], a1 = av[1], s0 = sv[0], s1 = sv[1];
              const float af[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
              const float sf[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
              __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(h2[j]);
                o2[j] = __floats2bfloat162_rn(silu_fast(fmaf(f.x, af[2 * j], sf[2 * j])),
                                              silu_fast(fmaf(f.y, af[2 * j + 1], sf[2 * j + 1])));
              }
            }
            *cell = packed;
          }
        }
        fence_proxy_async();  // the normalised halo is read by wgmma (async proxy)
        mbar_arrive(&h_full[stage]);
        named_barrier(1, HALO_THREADS);  // everyone is done with as_s
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns tile rows 2 wg, 2 wg + 1 ----
  warpgroup_regs_inc<200>();
  const int wg = tid >> 7;
  const int wq = (tid >> 5) & 3;  // warp in the warpgroup: columns 16 wq .. 16 wq + 15
  float acc[2][BN / 2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0.f;

  for (int st = 0; st < n_steps; ++st) {
    const int c = st / TAPS, tap = st - c * TAPS;
    const int hstage = c % NH, wstage = st % NSW;
    if (tap == 0) mbar_wait(&h_full[hstage], (c / NH) & 1);
    mbar_wait(&w_full[wstage], (st / NSW) & 1);
    const unsigned char* hs = halo_s + hstage * HALO_BYTES;
    const unsigned char* ws = w_s + wstage * W_BYTES;
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      // k16 slice ks: channel groups 2 ks (start) and 2 ks + 1 (start + lbo)
      const uint64_t db = wgmma_desc(ws + 2 * ks * BN * 16, BN * 16, 128);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int p0 = (2 * wg + mi + dy) * HWD + dx;  // halo pixel of the row's column 0
        const uint64_t da = wgmma_desc(hs + (2 * ks * HPIX_P + p0) * 16, HPIX_P * 16, 128);
        wgmma_tile<BN>(acc[mi], da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    // this warp's products of the step are done: release its stages
    if (lane == 0) {
      mbar_arrive(&w_empty[wstage]);
      if (tap == TAPS - 1) mbar_arrive(&h_empty[hstage]);
    }
  }

  // epilogue: accumulator 4 j + 2 h + e of m64 tile mi is (row 16 wq + g +
  // 8 h, column 8 j + 2 t + e): pixel (ty0 + 2 wg + mi, tx0 + 16 wq + g + 8 h)
  const int g = lane >> 2, t = lane & 3;
  const bool pair = (Cout & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int y = ty0 + 2 * wg + mi;
    if (y >= H) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int o = n0 + 8 * j + 2 * t;
      if (o >= Cout) continue;
      const float b0 = bias[o];
      const float b1 = o + 1 < Cout ? bias[o + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xx = tx0 + 16 * wq + g + 8 * h;
        if (xx >= W) continue;
        bf16* dst = out + (((size_t)b * H + y) * W + xx) * Cout + o;
        const float v0 = acc[mi][4 * j + 2 * h] + b0;
        const float v1 = acc[mi][4 * j + 2 * h + 1] + b1;
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (o + 1 < Cout) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <int BN>
int launch_wgmma(const void* x, const void* a, const void* s, const void* wk, const void* bias,
                 void* out, int B, int H, int W, int C, int Cout, int vec, cudaStream_t stream) {
  auto kern = gn_conv_wgmma_kernel<BN>;
  constexpr int bytes = ConvCfg<BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW;
  const int n_chunks = (C + KC - 1) / KC;
  const int cout_p = (Cout + 127) / 128 * 128;
  dim3 grid(tiles_w * ((H + TH - 1) / TH), (Cout + BN - 1) / BN, B);
  kern<<<grid, NT, bytes, stream>>>((const bf16*)x, (const float*)a, (const float*)s,
                                    (const bf16*)wk, (const float*)bias, (bf16*)out, H, W, C,
                                    Cout, cout_p, n_chunks, tiles_w, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 conv: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int FTH = 8;             // tile rows
constexpr int FTW = 16;            // tile columns
constexpr int FHW = FTW + 2;       // halo columns
constexpr int FHALO = (FTH + 2) * FHW;
constexpr int FBN = 64;            // output channels a block
constexpr int FBK = 16;            // input channels a chunk
constexpr int FWS = FBN + 4;       // padded weight row (a multiple of 4 for float4 reads)
constexpr size_t SMEM_F32 = sizeof(float) * ((size_t)FHALO * FBK + (size_t)9 * FBK * FWS);

constexpr int FNT = 256;           // threads a block

__global__ void __launch_bounds__(FNT) gn_conv_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ s,
    const float* __restrict__ w,  // (9, C_out, C)
    const float* __restrict__ bias, float* __restrict__ out, int H, int W, int C, int Cout,
    int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* halo = reinterpret_cast<float*>(smem_raw);  // FHALO x FBK
  float* w_s = halo + FHALO * FBK;                   // (9 * FBK) x FWS

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * FBN;
  const int ty0 = (blockIdx.x / tiles_w) * FTH;
  const int tx0 = (blockIdx.x % tiles_w) * FTW;
  const int tid = threadIdx.x;
  const int tn = tid & 15;         // output channels 4 * tn .. 4 * tn + 3
  const int tm = tid >> 4;         // tile row tm / 2, columns 8 * (tm % 2) .. + 7
  const int r = tm >> 1, xh = (tm & 1) * 8;
  const float* a_b = a + (size_t)b * C;
  const float* s_b = s + (size_t)b * C;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += FBK) {
    __syncthreads();
    for (int e = tid; e < FHALO * FBK; e += FNT) {
      const int p = e / FBK, k = e % FBK;
      const int y = ty0 + p / FHW - 1, xx = tx0 + p % FHW - 1;
      const int ch = c0 + k;
      float val = 0.f;
      if (y >= 0 && y < H && xx >= 0 && xx < W && ch < C)
        val = silu(x[(((size_t)b * H + y) * W + xx) * C + ch] * a_b[ch] + s_b[ch]);
      halo[e] = val;
    }
    for (int e = tid; e < 9 * FBN * FBK; e += FNT) {
      const int k = e % FBK, n = (e / FBK) % FBN, tap = e / (FBK * FBN);
      const int o = n0 + n, ch = c0 + k;
      w_s[(tap * FBK + k) * FWS + n] =
          (o < Cout && ch < C) ? w[((size_t)tap * Cout + o) * C + ch] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* hrow = halo + ((r + dy) * FHW + xh + dx) * FBK;
#pragma unroll 4
      for (int k = 0; k < FBK; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(w_s + (tap * FBK + k) * FWS + 4 * tn);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float hv = hrow[i * FBK + k];
          acc[i][0] = fmaf(hv, wv.x, acc[i][0]);
          acc[i][1] = fmaf(hv, wv.y, acc[i][1]);
          acc[i][2] = fmaf(hv, wv.z, acc[i][2]);
          acc[i][3] = fmaf(hv, wv.w, acc[i][3]);
        }
      }
    }
  }

  const int y = ty0 + r;
  if (y >= H) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int xx = tx0 + xh + i;
    if (xx >= W) continue;
    float* dst = out + (((size_t)b * H + y) * W + xx) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + 4 * tn + j;
      if (o < Cout) dst[o] = acc[i][j] + bias[o];
    }
  }
}

}  // namespace

// The group affine (a, s), each (B, C) fp32, of x (B, H*W, C) in its own type
// (x_bf16) with scale and bias in theirs (p_bf16): `gn_stats_kernel` on a
// (P, B) grid of ppb pixels a block into part (B, P, G, 2) fp64, then
// `gn_affine_kernel`. vec: values a 16-byte load (8 bf16 or 4 fp32) or 1; C up
// to 29,055 channels (a pixel row's fp32 moments in 227 KB of shared memory).
// The wrapper chooses P, ppb and vec (`stats_plan`).
extern "C" int xm_gn_affine(const void* x, void* part, const void* scale, const void* bias,
                            void* a, void* s, int B, int hw, int C, int G, int P, int ppb,
                            int vec, int x_bf16, int p_bf16, float eps, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (hw <= 0 || G <= 0 || C % G || P <= 0 || C % vec) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define XM_AFFINE(T, VEC)                                                                         \
  return p_bf16 ? launch_affine<T, bf16, VEC>(x, part, scale, bias, a, s, B, hw, C, G, P, ppb,   \
                                              eps, st)                                           \
                : launch_affine<T, float, VEC>(x, part, scale, bias, a, s, B, hw, C, G, P, ppb,  \
                                               eps, st)
  if (x_bf16) {
    if (vec == 8) XM_AFFINE(bf16, 8);
    if (vec == 1) XM_AFFINE(bf16, 1);
  } else {
    if (vec == 4) XM_AFFINE(float, 4);
    if (vec == 1) XM_AFFINE(float, 1);
  }
#undef XM_AFFINE
  return (int)cudaErrorInvalidValue;
}

// The per-(batch, group) moments mom (B, G, 3) fp64 = (count, mean, M2) of
// x (B, H*W, C) in its own type: `gn_stats_kernel` as above, then
// `gn_moments_kernel`. The same P, ppb and vec as `xm_gn_affine`.
extern "C" int xm_gn_moments(const void* x, void* part, void* mom, int B, int hw, int C, int G,
                             int P, int ppb, int vec, int x_bf16, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (hw <= 0 || G <= 0 || C % G || P <= 0 || C % vec) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16) {
    if (vec == 8) return launch_moments<bf16, 8>(x, part, mom, B, hw, C, G, P, ppb, st);
    if (vec == 1) return launch_moments<bf16, 1>(x, part, mom, B, hw, C, G, P, ppb, st);
  } else {
    if (vec == 4) return launch_moments<float, 4>(x, part, mom, B, hw, C, G, P, ppb, st);
    if (vec == 1) return launch_moments<float, 1>(x, part, mom, B, hw, C, G, P, ppb, st);
  }
  return (int)cudaErrorInvalidValue;
}

// GroupNorm of x (B, H*W, C) in its own type (x_bf16) into y (same shape and
// type; 16-byte aligned where vec > 1), given x's moments mom (B, G, 3) from
// `xm_gn_moments` with the same P, ppb and vec, and scale and bias (C,) in
// their type (p_bf16): `gn_apply_kernel` on the statistics' (P, B) grid,
// SiLU fused where silu. A plain GroupNorm call is `xm_gn_moments` and this:
// three launches, one read of x for the statistics, one for the apply.
extern "C" int xm_gn_apply(const void* x, const void* mom, const void* scale, const void* bias,
                           void* y, int B, int hw, int C, int G, int P, int ppb, int vec,
                           int x_bf16, int p_bf16, int silu, float eps, void* stream) {
  if (B <= 0 || C <= 0 || hw <= 0) return 0;
  if (G <= 0 || C % G || P <= 0 || C % vec) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define XM_APPLY(T, VEC)                                                                          \
  return p_bf16 ? launch_apply<T, bf16, VEC>(x, mom, scale, bias, y, B, hw, C, G, P, ppb, silu,  \
                                             eps, st)                                            \
                : launch_apply<T, float, VEC>(x, mom, scale, bias, y, B, hw, C, G, P, ppb, silu, \
                                              eps, st)
  if (x_bf16) {
    if (vec == 8) XM_APPLY(bf16, 8);
    if (vec == 1) XM_APPLY(bf16, 1);
  } else {
    if (vec == 4) XM_APPLY(float, 4);
    if (vec == 1) XM_APPLY(float, 1);
  }
#undef XM_APPLY
  return (int)cudaErrorInvalidValue;
}

// bn: output channels a block (128 or 64); wk in `kernel_params`' bf16 layout;
// vec: 16-byte halo copies (C a multiple of 8 and x aligned to 16 bytes).
extern "C" int xm_gn_silu_conv_bf16(const void* x, const void* a, const void* s, const void* wk,
                                    const void* bias, void* out, int B, int H, int W, int C,
                                    int Cout, int bn, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  if (C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bn == 128) return launch_wgmma<128>(x, a, s, wk, bias, out, B, H, W, C, Cout, vec, st);
  if (bn == 64) return launch_wgmma<64>(x, a, s, wk, bias, out, B, H, W, C, Cout, vec, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int xm_gn_silu_conv_f32(const void* x, const void* a, const void* s, const void* w,
                                   const void* bias, void* out, int B, int H, int W, int C,
                                   int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  if (C <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gn_conv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_F32);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + FTW - 1) / FTW;
  dim3 grid(tiles_w * ((H + FTH - 1) / FTH), (Cout + FBN - 1) / FBN, B);
  gn_conv_f32_kernel<<<grid, FNT, SMEM_F32, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (const float*)s, (const float*)w, (const float*)bias,
      (float*)out, H, W, C, Cout, tiles_w);
  return (int)cudaGetLastError();
}
