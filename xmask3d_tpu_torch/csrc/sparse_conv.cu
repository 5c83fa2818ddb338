// Kernel K1: Minkowski sparse convolution, output-stationary gather-GEMM.
//
// Replaces: xmask3d_tpu/ops/sparse_conv_pallas.py `sparse_conv_pallas_v2`
// (kernel body `_spconv2_kernel`), and its per-tap sibling
// `sparse_conv_pallas`, which has the same contract.
//
//   out[b, v, :] = sum_k feats[b, kmap[b, k, v], :] @ W[k]   (+ bias)
//   rows with kmap == -1 contribute nothing; rows with out_valid == 0 are 0.
//
// What bounds it on an H100: bytes. Scene voxels lie on surfaces, so a
// live output row finds only ~9 of its 27 neighbours, and the int32 map
// (K*V*4 bytes) plus the feature rows outweigh the 2*hits*C_in*C_out FLOPs
// at the tensor-core rate: summed over one view's 87 calls the least time
// is ~0.13 ms, set by bytes. This first version is far from that: it
// multiplies with CUDA-core FMAs and re-gathers every input row once per
// tap (K*V*C_in*2 bytes, served mostly from L2), so FMA throughput and the
// gather limit it.
//
// Design: one block per (64 output voxels) x (64 output channels) tile of
// one sample. For each tap the block stages the tile's 64 int32 map entries,
// gathers the 64 input rows (zero rows for -1) chunk by chunk of 32 input
// channels into shared memory, stages the matching 32x64 slice of W[k], and
// accumulates a 4x4 register tile per thread in fp32. A tap whose 64 map
// entries are all -1 is skipped, and a tile whose rows are all invalid only
// writes zeros: at deep levels the capacities exceed live voxels 2-4x.
// Indices stay int32 end to end (the TPU kernel's f32 index round-trip and
// its 2^24 limit do not apply).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TV = 64;   // output voxels per block
constexpr int TC = 64;   // output channels per block
constexpr int TK = 32;   // input channels per staged chunk
constexpr int NT = 256;  // threads per block (16 x 16, each 4 x 4 outputs)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT) sparse_conv_kernel(
    const T* __restrict__ feats,      // (B, V_in, C_in)
    const T* __restrict__ w,          // (K, C_in, C_out)
    const int* __restrict__ kmap,     // (B, K, V_out)
    const float* __restrict__ bias,   // (C_out) or null
    const uint8_t* __restrict__ valid,  // (B, V_out) or null
    T* __restrict__ out,              // (B, V_out, C_out)
    int v_in, int c_in, int c_out, int n_taps, int v_out) {
  __shared__ float a_s[TV][TK + 1];
  __shared__ float w_s[TK][TC];
  __shared__ int idx_s[TV];

  const int b = blockIdx.z;
  const int v0 = blockIdx.x * TV;
  const int n0 = blockIdx.y * TC;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group

  const uint8_t* valid_b = valid ? valid + (size_t)b * v_out : nullptr;
  int my_live = 0;
  if (tid < TV) {
    const int v = v0 + tid;
    my_live = (v < v_out) && (valid_b == nullptr || valid_b[v]);
  }
  const int tile_live = __syncthreads_or(my_live);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (tile_live) {
    const T* feats_b = feats + (size_t)b * v_in * c_in;
    const int* kmap_b = kmap + (size_t)b * n_taps * v_out;
    for (int k = 0; k < n_taps; ++k) {
      int hit = 0;
      if (tid < TV) {
        const int v = v0 + tid;
        const int id = (v < v_out) ? kmap_b[(size_t)k * v_out + v] : -1;
        idx_s[tid] = id;
        hit = id >= 0;
      }
      if (!__syncthreads_or(hit)) continue;
      const T* w_k = w + (size_t)k * c_in * c_out;
      for (int c0 = 0; c0 < c_in; c0 += TK) {
        // gather TV x TK input rows (zero for a missing neighbour)
        for (int e = tid; e < TV * TK; e += NT) {
          const int r = e / TK, c = e % TK;
          const int id = idx_s[r];
          float val = 0.f;
          if (id >= 0 && c0 + c < c_in) val = to_f(feats_b[(size_t)id * c_in + c0 + c]);
          a_s[r][c] = val;
        }
        // stage W[k][c0:c0+TK, n0:n0+TC]
        for (int e = tid; e < TK * TC; e += NT) {
          const int c = e / TC, n = e % TC;
          float val = 0.f;
          if (c0 + c < c_in && n0 + n < c_out) val = to_f(w_k[(size_t)(c0 + c) * c_out + n0 + n]);
          w_s[c][n] = val;
        }
        __syncthreads();
        const int kk_end = min(TK, c_in - c0);
        for (int kk = 0; kk < kk_end; ++kk) {
          float a[4], bw[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = a_s[ty + 16 * i][kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) bw[j] = w_s[kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  // epilogue: bias, zero invalid rows, store in the feature dtype
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ty + 16 * i;
    if (v >= v_out) continue;
    const bool live = tile_live && (valid_b == nullptr || valid_b[v]);
    T* out_row = out + ((size_t)b * v_out + v) * c_out;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= c_out) continue;
      float r = 0.f;
      if (live) r = acc[i][j] + (bias ? bias[n] : 0.f);
      out_row[n] = from_f<T>(r);
    }
  }
}

template <typename T>
int launch(const void* feats, const void* w, const void* kmap, const void* bias,
           const void* valid, void* out, int batch, int v_in, int c_in,
           int c_out, int n_taps, int v_out, void* stream) {
  if (v_out > 0 && c_out > 0 && batch > 0) {
    dim3 grid((v_out + TV - 1) / TV, (c_out + TC - 1) / TC, batch);
    sparse_conv_kernel<T><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const T*)feats, (const T*)w, (const int*)kmap, (const float*)bias,
        (const uint8_t*)valid, (T*)out, v_in, c_in, c_out, n_taps, v_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xm_sparse_conv_f32(const void* feats, const void* w, const void* kmap,
                                  const void* bias, const void* valid, void* out,
                                  int batch, int v_in, int c_in, int c_out,
                                  int n_taps, int v_out, void* stream) {
  return launch<float>(feats, w, kmap, bias, valid, out, batch, v_in, c_in,
                       c_out, n_taps, v_out, stream);
}

extern "C" int xm_sparse_conv_bf16(const void* feats, const void* w, const void* kmap,
                                   const void* bias, const void* valid, void* out,
                                   int batch, int v_in, int c_in, int c_out,
                                   int n_taps, int v_out, void* stream) {
  return launch<__nv_bfloat16>(feats, w, kmap, bias, valid, out, batch, v_in,
                               c_in, c_out, n_taps, v_out, stream);
}
