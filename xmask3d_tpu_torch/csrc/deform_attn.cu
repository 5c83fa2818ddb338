// Kernel K3: multi-scale deformable attention sampling (forward).
//
// Replaces: xmask3d_tpu/ops/deform_attn.py `_deform_attn_fused_pallas`
// (kernel body `_deform_kernel`), reached through `ms_deform_attn_pallas`
// and dispatched by `ms_deform_attn_auto`.
//
//   out[b, q, h, :] = sum_level sum_point aw[b,q,h,l,p] *
//                     bilinear(value_level[b, :, h, :], loc * size - 0.5)
//
// with grid_sample(align_corners=False, padding_mode="zeros") semantics:
// each of the four taps outside the map is zero, and a sample whose corner
// (floor(x), floor(y)) lies outside [-1, size) contributes nothing.
//
// What bounds it on an H100: per sample it does ~4 taps x 2 FLOPs per
// channel against a 64-byte (bf16, d = 32) row read per tap, i.e. well under
// one FLOP per byte: it is bound by memory. The unique bytes (value, loc, aw
// and out once each) are the bound; the taps are scattered gathers of whole
// 64-byte rows out of a value map that stays in L2 (5376 x 8 x 32 bf16 =
// 2.75 MB a layer), so what the kernel really waits for is the L2's sector
// rate and, above all, the latency of gathers whose addresses depend on
// loaded locations.
//
// Design (bf16, `deform_attn_vec_kernel<LR, NL, NP>`): one warp per (b,
// query, head), a block of eight warps. The lanes are (sample slot, channel
// slice): LR = d / 8 lanes read one value row, 16 bytes (8 channels) each,
// so for d = 32 one warp instruction gathers one tap of 8 samples. The
// (query, head)'s locations and weights (L * P * 2 + L * P contiguous
// floats) are read once, one float a lane, and handed to the slots by
// shuffles. Each lane then computes the bilinear taps of its samples (two
// each, 12 samples over 8 slots for the pixel decoder's 3 levels x 4 points)
// and issues all of their 16-byte gathers before it uses any, so a warp has
// 8 gathers in flight instead of one round trip after another. The slots'
// fp32 sums meet by xor shuffles, in a fixed order, and the LR lanes of slot
// 0 store the 16-byte pieces of the output row. The levels x points are
// template arguments for the pixel decoder's (3, 4), so everything unrolls;
// other counts run the same kernel with them at run time (NL = NP = 0).
//
// fp32 inputs, head dims that are not 8 times a power of two up to 256 and
// value pointers off 16 bytes take `deform_attn_kernel`: one warp per (b,
// query, head), the 32 lanes as channels, levels x points in sequence.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

constexpr int MAX_LEVELS = 8;
struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

// ---------------------------------------------------------------------------
// bf16: lanes over (sample, 8-channel slice), 16-byte gathers
// ---------------------------------------------------------------------------

constexpr int VT = 256;  // threads a block: eight (query, head) pairs

// LR: lanes a value row (d / 8, a power of two up to 32); NL, NP: levels and
// points, or 0 for run-time counts
template <int LR, int NL, int NP>
__global__ void __launch_bounds__(VT) deform_attn_vec_kernel(
    const bf16* __restrict__ value,  // (B, S, H, D)
    const float* __restrict__ loc,   // (B, Q, H, L, P, 2) in [0, 1]
    const float* __restrict__ aw,    // (B, Q, H, L, P)
    bf16* __restrict__ out,          // (B, Q, H * D)
    Levels lv, int pairs, int n_q, int heads, int d, int n_levels, int n_points,
    int s_total) {
  constexpr int SL = 32 / LR;                    // sample slots a warp
  constexpr int BATCH = 2 * SL < 16 ? 2 * SL : 16;  // samples whose locations one pass reads
  constexpr int PER = (BATCH + SL - 1) / SL;     // samples a slot takes per pass (1 or 2)
  __shared__ int lv_s[3][MAX_LEVELS];
  if (threadIdx.x < 3 * MAX_LEVELS) {
    const int i = threadIdx.x % MAX_LEVELS, f = threadIdx.x / MAX_LEVELS;
    lv_s[f][i] = f == 0 ? lv.h[i] : (f == 1 ? lv.w[i] : lv.start[i]);
  }
  __syncthreads();
  const int pair = (blockIdx.x * VT + threadIdx.x) >> 5;
  if (pair >= pairs) return;
  const int lane = threadIdx.x & 31;
  const int slot = lane / LR, cs = lane % LR;
  const int h = pair % heads;
  const int b = pair / (heads * n_q);
  const int npts = NP ? NP : n_points;
  const int lp = NL ? NL * NP : n_levels * n_points;
  const float* loc_w = loc + (size_t)pair * lp * 2;
  const float* aw_w = aw + (size_t)pair * lp;
  // row r of the value map at (b, r, h, cs * 8)
  const bf16* v_b = value + (size_t)b * s_total * heads * d + (size_t)h * d + cs * 8;

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

#pragma unroll
  for (int k0 = 0; k0 < lp; k0 += BATCH) {
    const int nb = min(BATCH, lp - k0);
    // this pass's locations (x, y interleaved) and weights, one float a lane
    const float loc_l = lane < 2 * nb ? loc_w[2 * k0 + lane] : 0.f;
    const float aw_l = lane < nb ? aw_w[k0 + lane] : 0.f;
    uint4 raw[PER][4];
    float wt[PER][4];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = slot + SL * i;  // sample of this pass
      const int kk = k < nb ? k : 0;  // idle slots read sample 0's, harmlessly
      const float lx = __shfl_sync(0xffffffffu, loc_l, 2 * kk);
      const float ly = __shfl_sync(0xffffffffu, loc_l, 2 * kk + 1);
      const float a = __shfl_sync(0xffffffffu, aw_l, kk);
      const int l = (k0 + kk) / npts;
      const int hh = lv_s[0][l], ww = lv_s[1][l];
      const float x = lx * ww - 0.5f, y = ly * hh - 0.5f;
      const float fx = floorf(x), fy = floorf(y);
      const bool live = k < nb && fx >= -1.f && fx < (float)ww && fy >= -1.f && fy < (float)hh;
      const int x0 = (int)fx, y0 = (int)fy;
      const float dx = x - fx, dy = y - fy;
      const float tw[4] = {(1.f - dx) * (1.f - dy), dx * (1.f - dy), (1.f - dx) * dy, dx * dy};
      const bf16* v_l = v_b + (size_t)lv_s[2][l] * heads * d;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int xi = x0 + (t & 1), yi = y0 + (t >> 1);
        const bool ok = live && xi >= 0 && xi < ww && yi >= 0 && yi < hh;
        wt[i][t] = ok ? a * tw[t] : 0.f;
        raw[i][t] = ok ? __ldg(reinterpret_cast<const uint4*>(v_l + ((size_t)yi * ww + xi) * heads * d))
                       : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // every gather of the pass is in flight; now use them
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[i][t]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h2[j]);
          acc[2 * j] = fmaf(wt[i][t], f.x, acc[2 * j]);
          acc[2 * j + 1] = fmaf(wt[i][t], f.y, acc[2 * j + 1]);
        }
      }
  }
  // the slots' sums, in a fixed order: lanes of one channel slice differ in
  // the bits above log2(LR)
#pragma unroll
  for (int off = LR; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  if (slot == 0) {
    uint4 packed;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j) o2[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
    *reinterpret_cast<uint4*>(out + (size_t)pair * d + cs * 8) = packed;
  }
}

// ---------------------------------------------------------------------------
// scalar: lanes over channels (fp32 and the widths the vector kernel skips)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void deform_attn_kernel(
    const T* __restrict__ value,     // (B, S, H, D)
    const float* __restrict__ loc,   // (B, Q, H, L, P, 2) in [0, 1]
    const float* __restrict__ aw,    // (B, Q, H, L, P)
    T* __restrict__ out,             // (B, Q, H * D)
    Levels lv, int batch, int n_q, int heads, int d, int n_levels,
    int n_points, int s_total) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= batch * n_q * heads) return;
  const int h = warp % heads;
  const int b = warp / (heads * n_q);

  const size_t lp = (size_t)n_levels * n_points;
  const float* loc_w = loc + (size_t)warp * lp * 2;
  const float* aw_w = aw + (size_t)warp * lp;
  const T* value_b = value + (size_t)b * s_total * heads * d;
  T* out_w = out + (size_t)warp * d;  // (b, q, h) row of width d

  for (int c = lane; c < ((d + 31) & ~31); c += 32) {
    const bool live = c < d;
    float acc = 0.f;
    for (int l = 0; l < n_levels; ++l) {
      const int hh = lv.h[l], ww = lv.w[l];
      const T* v_l = value_b + (size_t)lv.start[l] * heads * d + (size_t)h * d;
      for (int p = 0; p < n_points; ++p) {
        const size_t i = (size_t)l * n_points + p;
        const float x = loc_w[2 * i] * ww - 0.5f;
        const float y = loc_w[2 * i + 1] * hh - 0.5f;
        const float fx = floorf(x), fy = floorf(y);
        if (!(fx >= -1.f && fx < (float)ww && fy >= -1.f && fy < (float)hh)) continue;
        const int x0 = (int)fx, y0 = (int)fy;
        const float dx = x - fx, dy = y - fy;
        const float a = aw_w[i];
        const float wts[4] = {(1.f - dx) * (1.f - dy), dx * (1.f - dy),
                              (1.f - dx) * dy, dx * dy};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int xi = x0 + (t & 1), yi = y0 + (t >> 1);
          if (live && xi >= 0 && xi < ww && yi >= 0 && yi < hh) {
            const float val = to_f(v_l[((size_t)yi * ww + xi) * heads * d + c]);
            acc = fmaf(a * wts[t], val, acc);
          }
        }
      }
    }
    if (live) out_w[c] = from_f<T>(acc);
  }
}

int make_levels(const int* shapes, int n_levels, int s_total, Levels* lv) {
  if (n_levels > MAX_LEVELS || n_levels <= 0) return (int)cudaErrorInvalidValue;
  int start = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv->h[l] = l < n_levels ? shapes[2 * l] : 0;
    lv->w[l] = l < n_levels ? shapes[2 * l + 1] : 0;
    lv->start[l] = start;
    if (l < n_levels) start += lv->h[l] * lv->w[l];
  }
  return start == s_total ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_scalar(const void* value, const void* loc, const void* aw, void* out,
                  const int* shapes, int batch, int n_q, int heads, int d, int n_levels,
                  int n_points, int s_total, void* stream) {
  Levels lv;
  const int err = make_levels(shapes, n_levels, s_total, &lv);
  if (err) return err;
  const long long warps = (long long)batch * n_q * heads;
  if (warps == 0) return 0;
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  deform_attn_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)value, (const float*)loc, (const float*)aw, (T*)out, lv, batch,
      n_q, heads, d, n_levels, n_points, s_total);
  return (int)cudaGetLastError();
}

template <int LR, int NL, int NP>
int launch_vec(const void* value, const void* loc, const void* aw, void* out, const Levels& lv,
               int pairs, int n_q, int heads, int d, int n_levels, int n_points, int s_total,
               cudaStream_t stream) {
  const long long blocks = ((long long)pairs * 32 + VT - 1) / VT;
  deform_attn_vec_kernel<LR, NL, NP><<<(unsigned)blocks, VT, 0, stream>>>(
      (const bf16*)value, (const float*)loc, (const float*)aw, (bf16*)out, lv, pairs, n_q,
      heads, d, n_levels, n_points, s_total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xm_deform_attn_f32(const void* value, const void* loc, const void* aw,
                                  void* out, const int* shapes, int batch, int n_q,
                                  int heads, int d, int n_levels, int n_points,
                                  int s_total, void* stream) {
  return launch_scalar<float>(value, loc, aw, out, shapes, batch, n_q, heads, d,
                              n_levels, n_points, s_total, stream);
}

// lr: lanes a value row for the vector kernel (d / 8: 1, 2, 4, 8, 16 or 32),
// or 0 for the scalar kernel; unrolled: d = 32, 3 levels x 4 points as
// template arguments. The wrapper chooses both (`kernel_plan` in
// ops/deform_attn.py).
extern "C" int xm_deform_attn_bf16(const void* value, const void* loc, const void* aw,
                                   void* out, const int* shapes, int batch, int n_q,
                                   int heads, int d, int n_levels, int n_points,
                                   int s_total, int lr, int unrolled, void* stream) {
  if (lr == 0)
    return launch_scalar<bf16>(value, loc, aw, out, shapes, batch, n_q, heads, d, n_levels,
                               n_points, s_total, stream);
  Levels lv;
  const int err = make_levels(shapes, n_levels, s_total, &lv);
  if (err) return err;
  if (lr * 8 != d) return (int)cudaErrorInvalidValue;
  const int pairs = batch * n_q * heads;
  if (pairs == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (unrolled) {
    if (lr != 4 || n_levels != 3 || n_points != 4) return (int)cudaErrorInvalidValue;
    return launch_vec<4, 3, 4>(value, loc, aw, out, lv, pairs, n_q, heads, d, n_levels,
                               n_points, s_total, st);
  }
#define XM_K3(LR)                                                                        \
  case LR:                                                                               \
    return launch_vec<LR, 0, 0>(value, loc, aw, out, lv, pairs, n_q, heads, d, n_levels, \
                                n_points, s_total, st)
  switch (lr) {
    XM_K3(1);
    XM_K3(2);
    XM_K3(4);
    XM_K3(8);
    XM_K3(16);
    XM_K3(32);
  }
#undef XM_K3
  return (int)cudaErrorInvalidValue;
}
