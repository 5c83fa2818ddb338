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
// one FLOP per byte: it is bound by memory, and since the taps are scattered
// gathers the limit is the L2/HBM sector rate of those reads. The value map
// of one layer (5376 x 8 x 32 bf16 = 2.75 MB) stays resident in L2.
//
// Design: one warp per (b, query, head); the 32 lanes are the 32 channels of
// the head, so every tap is one coalesced 64-byte (bf16) or 128-byte (fp32)
// row of `value` read in its native (B, sum HW, heads, d) layout. Each lane
// loops over levels x points, recomputes the (cheap) bilinear weights, and
// accumulates in fp32. Head dims above 32 loop over channel chunks. The
// TPU kernel's one-hot-matmul gather and its f32 index round-trip do not
// carry over: the gather is a plain load here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int MAX_LEVELS = 8;
struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

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

template <typename T>
int launch(const void* value, const void* loc, const void* aw, void* out,
           const int* shapes, int batch, int n_q, int heads, int d, int n_levels,
           int n_points, int s_total, void* stream) {
  if (n_levels > MAX_LEVELS || n_levels <= 0) return (int)cudaErrorInvalidValue;
  Levels lv;
  int start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != s_total) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)batch * n_q * heads;
  if (warps == 0) return 0;
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  deform_attn_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)value, (const float*)loc, (const float*)aw, (T*)out, lv, batch,
      n_q, heads, d, n_levels, n_points, s_total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xm_deform_attn_f32(const void* value, const void* loc, const void* aw,
                                  void* out, const int* shapes, int batch, int n_q,
                                  int heads, int d, int n_levels, int n_points,
                                  int s_total, void* stream) {
  return launch<float>(value, loc, aw, out, shapes, batch, n_q, heads, d,
                       n_levels, n_points, s_total, stream);
}

extern "C" int xm_deform_attn_bf16(const void* value, const void* loc, const void* aw,
                                   void* out, const int* shapes, int batch, int n_q,
                                   int heads, int d, int n_levels, int n_points,
                                   int s_total, void* stream) {
  return launch<__nv_bfloat16>(value, loc, aw, out, shapes, batch, n_q, heads, d,
                               n_levels, n_points, s_total, stream);
}
