// Kernel K4: GroupNorm -> SiLU -> 3x3 SAME conv + bias, computed from the raw
// activation; layout NHWC, contiguous.
//
// Replaces: xmask3d_tpu/ops/gn_conv.py `_fused_forward` (:141; kernel body
// `_kernel` :83), dispatched by `gn_silu_conv`.
//
// Contract:
//   out[b, y, x, o] = bias[o] + sum_{dy, dx in -1..1} sum_c n[b, y+dy, x+dx, c] * w[dy+1, dx+1, c, o]
//   n[b, i, j, c]   = silu(x[b, i, j, c] * a[b, c] + s[b, c]) rounded to x's type,
//                     0 outside the image
// The SAME padding pads the normalised tensor with zeros, not x, so silu(s)
// never reaches the border. a and s are the per-(batch, channel) fp32 affine
// of the group statistics (`affine_from_stats`, outside the kernel). Sums are
// fp32, the bias is added in fp32 and the result is cast once.
//
// What bounds it on an H100: at the VAE's shapes (C, C_out in 128..512 over
// 512^2..64^2 maps) a call does 18 * H * W * C * C_out operations against
// about 2 * H * W * (C + C_out) bytes, e.g. 77 GFLOP against 134 MB at the
// 512^2 level, so it is bound by operations: the bf16 tensor cores.
//
// Design (bf16): an implicit GEMM with M = output pixels in tiles of 8 rows x
// 16 columns, N = C_out in tiles of 128 and K = 9 taps x C in chunks of 32
// channels. For each chunk a block stages in shared memory the normalised
// 10 x 18 halo of its tile (raw x read once, the affine and SiLU applied in
// fp32, rounded to bf16, zeros written outside the image or past C) and the
// chunk's weights for all nine taps. Each of the 8 warps owns two image rows
// of the tile (32 pixels) x 64 output channels and accumulates the nine
// shifted products in fp32 registers with mma.sync m16n8k16, fed by ldmatrix:
// a tap's shift is only another row address into the halo, so the normalised
// activation never reaches device memory and is made once per chunk, not
// once per tap. Rows are padded to 40 halves so ldmatrix reads no bank twice.
// fp32 inputs (the checks and the fp32 tiny model) take a CUDA-core FMA
// kernel with the same tiling. Any B, H, W, C and C_out: ragged tiles, channel
// chunks and output tiles are masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;              // tile rows
constexpr int TW = 16;             // tile columns
constexpr int HH = TH + 2;         // halo rows
constexpr int HW = TW + 2;         // halo columns
constexpr int HALO = HH * HW;      // halo pixels
constexpr int NT = 256;            // threads a block

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BN = 128;            // output channels a block
constexpr int BK = 32;             // input channels a chunk
constexpr int KP = BK + 8;         // padded shared-memory row, in halves
constexpr size_t SMEM_BF16 = sizeof(__nv_bfloat16) * ((size_t)HALO * KP + (size_t)9 * BN * KP);

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NT) gn_conv_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ s, const __nv_bfloat16* __restrict__ w,  // (9, C_out, C)
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H, int W, int C,
    int Cout, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // HALO x KP
  __nv_bfloat16* w_s = halo + HALO * KP;                             // (9 * BN) x KP

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // tile rows 2 * wm, 2 * wm + 1
  const int wn = warp >> 2;  // output channels n0 + 64 * wn ...
  const bool vec = (C % 8) == 0;
  const float* a_b = a + (size_t)b * C;
  const float* s_b = s + (size_t)b * C;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BK) {
    __syncthreads();  // the previous chunk's halo and weights are consumed
    // the normalised halo: 4 groups of 8 channels a pixel
    for (int e = tid; e < HALO * 4; e += NT) {
      const int p = e >> 2, v = e & 3;
      const int y = ty0 + p / HW - 1, xx = tx0 + p % HW - 1;
      const int ch = c0 + v * 8;
      float val[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) val[j] = 0.f;
      if (y >= 0 && y < H && xx >= 0 && xx < W && ch < C) {
        const __nv_bfloat16* src = x + (((size_t)b * H + y) * W + xx) * C + ch;
        if (vec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(src);
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h2[j]);
            val[2 * j] = silu(f.x * a_b[ch + 2 * j] + s_b[ch + 2 * j]);
            val[2 * j + 1] = silu(f.y * a_b[ch + 2 * j + 1] + s_b[ch + 2 * j + 1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (ch + j < C) val[j] = silu(__bfloat162float(src[j]) * a_b[ch + j] + s_b[ch + j]);
        }
      }
      uint4 packed;
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) o2[j] = __floats2bfloat162_rn(val[2 * j], val[2 * j + 1]);
      *reinterpret_cast<uint4*>(halo + p * KP + v * 8) = packed;
    }
    // the chunk's weights, rows (tap, n) of 32 channels
    for (int e = tid; e < 9 * BN * 4; e += NT) {
      const int row = e >> 2, v = e & 3;
      const int tap = row / BN, o = n0 + row % BN;
      const int ch = c0 + v * 8;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (o < Cout && ch < C) {
        const __nv_bfloat16* src = w + ((size_t)tap * Cout + o) * C + ch;
        if (vec) {
          packed = *reinterpret_cast<const uint4*>(src);
        } else {
          __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
          for (int j = 0; j < 8; ++j) h[j] = ch + j < C ? src[j] : __float2bfloat16(0.f);
        }
      }
      *reinterpret_cast<uint4*>(w_s + row * KP + v * 8) = packed;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // lanes 0-15 address pixels 0-15 at k 0-7, lanes 16-31 the same at k 8-15
          const int r = 2 * wm + mi;
          const int p = (r + dy) * HW + (lane & 15) + dx;
          ldmatrix_x4(af[mi], halo + p * KP + ks + (lane >> 4) * 8);
        }
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
          const int q = lane >> 3;
          const int n = wn * 64 + pr * 16 + (q >> 1) * 8 + (lane & 7);
          uint32_t bf[4];
          ldmatrix_x4(bf, w_s + (tap * BN + n) * KP + ks + (q & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_16816(acc[mi][2 * pr], af[mi], bf[0], bf[1]);
            mma_16816(acc[mi][2 * pr + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }

  // epilogue: d0, d1 at (pixel g, channels 2t, 2t+1), d2, d3 at pixel g + 8
  const int g = lane >> 2, t = lane & 3;
  const bool pair = (Cout % 2) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int y = ty0 + 2 * wm + mi;
    if (y >= H) continue;
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const int o = n0 + wn * 64 + nj * 8 + 2 * t;
      if (o >= Cout) continue;
      const float b0 = bias[o];
      const float b1 = o + 1 < Cout ? bias[o + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int xx = tx0 + g + 8 * half;
        if (xx >= W) continue;
        __nv_bfloat16* dst = out + (((size_t)b * H + y) * W + xx) * Cout + o;
        const float v0 = acc[mi][nj][2 * half] + b0;
        const float v1 = acc[mi][nj][2 * half + 1] + b1;
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

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int FBN = 64;            // output channels a block
constexpr int FBK = 16;            // input channels a chunk
constexpr int FWS = FBN + 4;       // padded weight row (a multiple of 4 for float4 reads)
constexpr size_t SMEM_F32 = sizeof(float) * ((size_t)HALO * FBK + (size_t)9 * FBK * FWS);

__global__ void __launch_bounds__(NT) gn_conv_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ s,
    const float* __restrict__ w,  // (9, C_out, C)
    const float* __restrict__ bias, float* __restrict__ out, int H, int W, int C, int Cout,
    int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* halo = reinterpret_cast<float*>(smem_raw);  // HALO x FBK
  float* w_s = halo + HALO * FBK;                    // (9 * FBK) x FWS

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * FBN;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
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
    for (int e = tid; e < HALO * FBK; e += NT) {
      const int p = e / FBK, k = e % FBK;
      const int y = ty0 + p / HW - 1, xx = tx0 + p % HW - 1;
      const int ch = c0 + k;
      float val = 0.f;
      if (y >= 0 && y < H && xx >= 0 && xx < W && ch < C)
        val = silu(x[(((size_t)b * H + y) * W + xx) * C + ch] * a_b[ch] + s_b[ch]);
      halo[e] = val;
    }
    for (int e = tid; e < 9 * FBN * FBK; e += NT) {
      const int k = e % FBK, n = (e / FBK) % FBN, tap = e / (FBK * FBN);
      const int o = n0 + n, ch = c0 + k;
      w_s[(tap * FBK + k) * FWS + n] =
          (o < Cout && ch < C) ? w[((size_t)tap * Cout + o) * C + ch] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* hrow = halo + ((r + dy) * HW + xh + dx) * FBK;
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

extern "C" int xm_gn_silu_conv_bf16(const void* x, const void* a, const void* s, const void* w,
                                    const void* bias, void* out, int B, int H, int W, int C,
                                    int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  if (C <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gn_conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BF16);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW;
  dim3 grid(tiles_w * ((H + TH - 1) / TH), (Cout + BN - 1) / BN, B);
  gn_conv_bf16_kernel<<<grid, NT, SMEM_BF16, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)a, (const float*)s, (const __nv_bfloat16*)w,
      (const float*)bias, (__nv_bfloat16*)out, H, W, C, Cout, tiles_w);
  return (int)cudaGetLastError();
}

extern "C" int xm_gn_silu_conv_f32(const void* x, const void* a, const void* s, const void* w,
                                   const void* bias, void* out, int B, int H, int W, int C,
                                   int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  if (C <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gn_conv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_F32);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW;
  dim3 grid(tiles_w * ((H + TH - 1) / TH), (Cout + FBN - 1) / FBN, B);
  gn_conv_f32_kernel<<<grid, NT, SMEM_F32, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (const float*)s, (const float*)w, (const float*)bias,
      (float*)out, H, W, C, Cout, tiles_w);
  return (int)cudaGetLastError();
}
