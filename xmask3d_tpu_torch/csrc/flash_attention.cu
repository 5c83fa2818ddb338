// Kernel K2: non-causal, unmasked attention softmax(Q K^T / sqrt(d)) V with
// an online softmax; layout (B, H, T, D), contiguous.
//
// Replaces: xmask3d_tpu/ops/flash_attention.py `flash_attention` (kernel body
// `_flash_fwd_kernel`), dispatched by `attention`.
//
// What bounds it on an H100: at the main path's shapes (SD UNet self-attention
// 4096 x d40 / 1024 x d80 / 256 x d160, cross-attention over 77 keys, VAE
// 4096 x d512) the work is 4*Tq*Tk*D FLOPs per head against (3*T + T)*D*2
// bytes, so it is bound by operations; this first version does its products
// with CUDA-core FMAs from shared memory (not tensor cores), so FMA
// throughput is its limit. No (Tq, Tk) score matrix reaches device memory.
//
// Design: one block per (batch*head, tile of BQ queries); the block loops
// over key tiles of BK. Q (pre-scaled), K and V tiles are staged in shared
// memory as fp32; a group of G = NT/BQ adjacent lanes owns one query row:
// each lane computes BK/G scores of the row, the row max and sum are
// reduced with warp shuffles inside the group, P goes through shared memory,
// and each lane accumulates D/G output columns of the row in registers.
// Running max and sum stay in fp32. The ragged key edge (Tk = 77, T = 64) is
// masked in the kernel, so every shape on the path runs here. Head dims are
// padded to a compile-time width (64, 96, 160); d = 512 (the VAE) gets its
// own tiling with BQ = BK = 32 so that its K/V tiles fit in shared memory.

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

template <int BQ, int BK, int DP, int NT>
struct Smem {
  static constexpr int QS = DP + 1;  // padded row stride (bank spread)
  static constexpr int PS = BK + 1;
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)BQ * QS + (size_t)BK * QS + (size_t)BK * DP + (size_t)BQ * PS);
};

template <typename T, int BQ, int BK, int DP, int NT>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int tq, int tk, int d, float scale) {
  constexpr int G = NT / BQ;       // lanes per query row
  constexpr int SPL = BK / G;      // scores per lane
  constexpr int OPL = DP / G;      // output columns per lane
  using S = Smem<BQ, BK, DP, NT>;
  static_assert(32 % G == 0, "a row group must sit inside one warp");

  extern __shared__ float smem[];
  float* q_s = smem;                       // BQ x QS
  float* k_s = q_s + BQ * S::QS;           // BK x QS
  float* v_s = k_s + BK * S::QS;           // BK x DP
  float* p_s = v_s + BK * DP;              // BQ x PS

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid / G;
  const int g = tid % G;
  const size_t base_q = (size_t)bh * tq * d;
  const size_t base_k = (size_t)bh * tk * d;

  for (int e = tid; e < BQ * d; e += NT) {
    const int r = e / d, c = e % d;
    const int qi = q0 + r;
    q_s[r * S::QS + c] = qi < tq ? to_f(q[base_q + (size_t)qi * d + c]) * scale : 0.f;
  }

  float acc[OPL];
#pragma unroll
  for (int j = 0; j < OPL; ++j) acc[j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // previous tile's k_s / v_s / p_s fully consumed
    for (int e = tid; e < BK * d; e += NT) {
      const int r = e / d, c = e % d;
      const int ki = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (ki < tk) {
        kv = to_f(k[base_k + (size_t)ki * d + c]);
        vv = to_f(v[base_k + (size_t)ki * d + c]);
      }
      k_s[r * S::QS + c] = kv;
      v_s[r * DP + c] = vv;
    }
    __syncthreads();

    float s[SPL];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int c = g + G * j;
      float dot = 0.f;
      const float* qr = q_s + row * S::QS;
      const float* kr = k_s + c * S::QS;
      for (int x = 0; x < d; ++x) dot = fmaf(qr[x], kr[x], dot);
      s[j] = (k0 + c < tk) ? dot : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
    const float m_new = fmaxf(m_run, m_tile);
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const float p = (k0 + g + G * j < tk) ? expf(s[j] - m_new) : 0.f;
      p_s[row * S::PS + g + G * j] = p;
      l_tile += p;
    }
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
      l_tile += __shfl_xor_sync(0xffffffffu, l_tile, off);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + l_tile;
    m_run = m_new;
    __syncwarp();  // p_s row written by this row group (all inside one warp)

    const int kmax = min(BK, tk - k0);
#pragma unroll
    for (int j = 0; j < OPL; ++j) acc[j] *= alpha;
    for (int c = 0; c < kmax; ++c) {
      const float p = p_s[row * S::PS + c];
      const float* vr = v_s + c * DP;
#pragma unroll
      for (int j = 0; j < OPL; ++j) {
        const int col = g + G * j;
        if (col < d) acc[j] = fmaf(p, vr[col], acc[j]);
      }
    }
  }

  const int qi = q0 + row;
  if (qi < tq) {
    const float inv = 1.f / l_run;
    T* orow = o + base_q + (size_t)qi * d;
#pragma unroll
    for (int j = 0; j < OPL; ++j) {
      const int col = g + G * j;
      if (col < d) orow[col] = from_f<T>(acc[j] * inv);
    }
  }
}

template <typename T, int BQ, int BK, int DP, int NT>
int run(const void* q, const void* k, const void* v, void* o, int bh, int tq,
        int tk, int d, float scale, cudaStream_t stream) {
  using S = Smem<BQ, BK, DP, NT>;
  auto kern = flash_fwd_kernel<T, BQ, BK, DP, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + BQ - 1) / BQ, bh);
  kern<<<grid, NT, S::bytes, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                       (T*)o, tq, tk, d, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int tq, int tk, int d, void* stream) {
  if (bh <= 0 || tq <= 0) return 0;
  if (tk <= 0) return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)d);
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64) return run<T, 64, 64, 64, 256>(q, k, v, o, bh, tq, tk, d, scale, s);
  if (d <= 96) return run<T, 64, 64, 96, 256>(q, k, v, o, bh, tq, tk, d, scale, s);
  if (d <= 160) return run<T, 64, 64, 160, 256>(q, k, v, o, bh, tq, tk, d, scale, s);
  if (d <= 512) return run<T, 32, 32, 512, 256>(q, k, v, o, bh, tq, tk, d, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int xm_flash_attention_f32(const void* q, const void* k, const void* v,
                                      void* o, int bh, int tq, int tk, int d,
                                      void* stream) {
  return dispatch<float>(q, k, v, o, bh, tq, tk, d, stream);
}

extern "C" int xm_flash_attention_bf16(const void* q, const void* k, const void* v,
                                       void* o, int bh, int tq, int tk, int d,
                                       void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, bh, tq, tk, d, stream);
}
